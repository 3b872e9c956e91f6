"""Pluggable fabric registry: per-topology classes owning collective
placement, fault derating, survivor accounting, and TCO inventory.

`Cluster` (core/topology.py) is a thin facade: every topology-dependent
decision — the `comm_spec` placement menus (kinds 'ar' / 'a2a' /
'pp_sendrecv'), the `FaultSet` derating formulas, survivor accounting,
the switch/link inventory the TCO model prices, and the availability
model's component classes / blast-radius mapping — delegates to the
`Fabric` registered under `Cluster.topology`. Adding a topology is a
subclass plus one `register_fabric` call, no core edits (recipe in
docs/architecture.md; the fabric-by-fabric model in docs/fabrics.md).

The four static fabrics' formulas moved here VERBATIM from the former
string-matched branches of topology.py / collectives.py /
availability.py — identical float association order — so every committed
figure JSON regenerates byte-identical through the registry (the CI
gate), and the registry-parameterized conformance battery
(tests/test_fabric_conformance.py) holds each fabric to scalar==batched
1e-9 parity.

The fifth fabric, `OCSFabric`, is the ROADMAP's runtime-reconfigurable
optical circuit-switched topology (MixNet/MFABRIC, arXiv 2501.03905):
every XPU terminates OCS_PORTS fiber ports on MEMS circuit switches, and
the circuit graph is re-matched per SERVING PHASE — not per collective:
a ~25 us MEMS re-match inside each of a decode iteration's dozens of
A2As would dwarf the collectives themselves, so within a phase the
circuits are held static and only algorithms that keep the SAME partner
graph every round are on the menu (ring all-reduce yes, recursive
doubling no — its partners change per round, each change a re-match).

  decode pools    OCS_TP_BW_FRAC of the port budget holds dedicated
                  single-hop circuits around the TP neighborhood (the
                  'low-alpha neighborhood': intra-node-class alphas at
                  that fraction of provision); the remainder forms a
                  static expander over which the expert A2A runs in
                  `_circuit_hops` store-and-forward rounds.
  prefill pools   a disaggregated prefill pool is its own sub-cluster,
                  so its whole-prompt pass sees the full port budget re-
                  matched into fat circuits (full `link_bw` to its own
                  comm_spec).
  disagg handoff  the prefill->decode KV transfer rides a dedicated
                  circuit set up at the phase switch: `kv_handoff_alpha`
                  charges OCS_RECONF_S on top of the base alpha0 (static
                  fabrics return alpha0 unchanged — byte-identity).

TCO: the OCS trades the electrical switch tiers for bandwidth-
INDEPENDENT per-port MEMS cost (the OCS thesis) plus per-GB/s optical
transceivers — `link_inventory().ocs_trx_gbps_total` and
`ocs_port_count` are new inventory hooks priced in core/tco.py; static
fabrics report 0 from both, and x + 0.0 == x keeps their TCO
byte-identical.

Layer: between `core.collectives` (pure cost primitives, below) and
`core.topology` (the Cluster facade, above); tco / availability / sweep
reach fabrics only through `Cluster`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

from repro_torch.core import collectives as coll
from repro_torch.core.alphabeta import AlphaBeta, CLUSTER, INTRA_NODE

if TYPE_CHECKING:
    from repro_torch.core.hardware import XPUSpec
    from repro_torch.core.topology import Cluster

DIMS_BY_SIZE = {8: (2, 2, 2), 64: (4, 4, 4), 256: (8, 8, 4), 512: (8, 8, 8)}

# XPUs per NVLink-class island inside a scale-out cluster (DGX-style node);
# a TP domain that fits the island rides its scale-up switch, not the NIC
NODE_XPUS = 8

SWITCH_RADIX = 64
SCALE_UP_PORTS = 16          # per XPU
SCALE_OUT_PORTS = 1
XPUS_PER_RACK = 64

# OCS fabric model constants (cost constants live with the other cost
# constants in core/tco.py; these shape timing and inventory COUNTS)
OCS_PORTS = 8                # fiber ports per XPU on the circuit switches
OCS_RADIX = 128              # duplex ports per MEMS circuit switch
OCS_RECONF_S = 25e-6         # MEMS re-match latency, charged per phase switch
OCS_TP_BW_FRAC = 0.5         # port fraction held as dedicated TP circuits

# bandwidth floor of a fully-failed fabric: keeps collective times finite
# (astronomical, so any feasibility check rejects them) instead of inf/NaN
_DEAD_FABRIC_FRAC = 1e-9


def _tp_subdims(dims: Tuple[int, ...],
                tp: int) -> Optional[Tuple[int, ...]]:
    """Greedy contiguous sub-mesh of `tp` devices inside `dims`: fill the
    first dimension first (matching how DIMS_BY_SIZE orders the long axes).
    Returns per-dim extents of the TP neighborhood, or None when `tp` has
    no contiguous factorization (then placement falls back to the
    whole-cluster menus)."""
    sub = []
    rem = tp
    for d in dims:
        t = math.gcd(rem, d)
        sub.append(t)
        rem //= t
    if rem != 1:
        return None
    return tuple(sub)


def _strip_ones(dims: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(d for d in dims if d > 1) or (1,)


def most_cubic_dims(n: int) -> Tuple[int, ...]:
    """Most-cubic 3D factorization of a pool size (sub-pools of mesh
    clusters need explicit dims; DIMS_BY_SIZE only covers the paper's
    whole-cluster sizes)."""
    best = (n, 1, 1)
    for a in range(1, n + 1):
        if n % a:
            continue
        for b in range(a, n // a + 1):
            if (n // a) % b:
                continue
            c = n // (a * b)
            if c < b:
                break
            if max((c, b, a)) < max(best):
                best = (c, b, a)
    return best


def _circuit_hops(n: int, ports: int) -> int:
    """Store-and-forward hops to span `n` endpoints over a static
    degree-`ports` expander circuit graph: the smallest h whose h-hop
    neighborhood reaches the group. Integer arithmetic — a float
    ceil(log(n)/log(ports)) is platform-shaped exactly at the power-of-
    ports boundaries the paper's cluster sizes sit on."""
    h = 1
    reach = ports + 1
    while reach < n:
        reach *= ports
        h += 1
    return h


@dataclass(frozen=True)
class LinkInventory:
    copper_gbps_total: float = 0.0     # aggregate copper bandwidth (GB/s)
    aoc_gbps_total: float = 0.0        # aggregate AOC bandwidth (GB/s)
    ocs_trx_gbps_total: float = 0.0    # transceiver-terminated OCS fiber


@dataclass(frozen=True)
class FaultSet:
    """Failed components of one cluster — counts per class, not identities
    (the model is symmetric across same-class components, and collectives
    synchronize on the slowest rank, so the worst-case placement prices
    every placement).

    mesh_links     failed torus / full-mesh links per dimension (entries
                   beyond the cluster's dims, or on switched fabrics, are
                   ignored); a broken torus ring forces detour rounds, a
                   lost full-mesh direct link forces a 2-hop relay over the
                   (d-1) surviving links of its line
    switch_planes  failed scale-up switch-plane rails (of the
                   SCALE_UP_PORTS parallel planes each XPU stripes
                   across); on the OCS fabric the same counter carries
                   failed fiber/MEMS port planes (of OCS_PORTS)
    nics           failed scale-out NICs — each takes its whole NODE_XPUS
                   island node out of the serving pool
    xpus           failed XPUs (any topology)

    The zero FaultSet derates nothing; `Cluster(faults=None)` skips the
    derating code path entirely (byte-identity of the healthy model).
    """
    mesh_links: Tuple[int, ...] = ()
    switch_planes: int = 0
    nics: int = 0
    xpus: int = 0

    def __post_init__(self):
        if (any(f < 0 for f in self.mesh_links) or self.switch_planes < 0
                or self.nics < 0 or self.xpus < 0):
            raise ValueError(f"fault counts must be >= 0: {self}")
        object.__setattr__(self, "mesh_links", tuple(self.mesh_links))

    @property
    def any(self) -> bool:
        return bool(sum(self.mesh_links) or self.switch_planes
                    or self.nics or self.xpus)

    def link_at(self, i: int) -> int:
        """Failed links in mesh dim `i` (0 beyond the recorded dims)."""
        return self.mesh_links[i] if i < len(self.mesh_links) else 0


def _spread_mesh_links(cluster: "Cluster", k: int) -> Tuple[int, ...]:
    """Distribute k failed links over the mesh's active dims, longest dims
    first, round-robin — the adversarial placement (breaking a NEW
    dimension costs a fresh detour/relay penalty, and longer dims pay more
    detour rounds), so the stationary model prices the worst case."""
    dims = cluster.dims or ()
    counts = [0] * len(dims)
    order = sorted((i for i, d in enumerate(dims) if d > 1),
                   key=lambda i: -dims[i])
    if not order:
        return tuple(counts)
    caps = cluster.mesh_link_counts()
    for j in range(k):
        i = order[j % len(order)]
        if counts[i] < caps[i]:
            counts[i] += 1
    return tuple(counts)


# shared collective menus (paper Table 2): both switched electrical
# fabrics run the same NCCL-class algorithm set over the non-blocking tree
def _switched_a2a_menu(n: int) -> Dict[str, coll.CollCost]:
    return {"p2p": coll.a2a_p2p(n), "bruck": coll.a2a_bruck(n)}


def _switched_ar_menu(n: int) -> Dict[str, coll.CollCost]:
    return {"ring": coll.ar_ring(n),
            "recdouble": coll.ar_recursive_doubling(n),
            "rabenseifner": coll.ar_rabenseifner(n)}


# ---------------------------------------------------------------------------
# the Fabric interface
# ---------------------------------------------------------------------------

class Fabric:
    """One network topology's pluggable behavior bundle. Subclass,
    override the hooks whose defaults don't fit, and `register_fabric` an
    instance — `Cluster` picks it up by name and the conformance battery
    (tests/test_fabric_conformance.py) covers it automatically.

    Defaults are the no-op / zero behaviors: no dims requirement, no
    switches, no fault derating beyond lost XPUs, empty link inventory
    hooks must be provided. Hooks take the `Cluster` explicitly — fabric
    instances are stateless singletons shared by every cluster of their
    topology."""

    name: str = "?"
    # True: dims required (defaulted from DIMS_BY_SIZE), pools re-factorize
    needs_dims: bool = False
    # True: link_bw defaults to the NIC provision, not the scale-up one
    nic_provisioned: bool = False
    # True: circuit-switched — the link graph re-matches per serving phase
    # (excluded from the static TOPOLOGIES tuple the paper figures sweep)
    reconfigurable: bool = False

    # ---- provisioning / shape ----
    def default_link_bw(self, xpu: "XPUSpec") -> float:
        """Per-XPU aggregate bandwidth when `make_cluster` gets no
        link_bw (paper section 3.2: 'fix the total per-XPU network
        bandwidth')."""
        return xpu.scale_out_bw if self.nic_provisioned else xpu.scale_up_bw

    def pool_dims(self, n: int) -> Optional[Tuple[int, ...]]:
        """dims for an n-device pool carved out of a cluster of this
        fabric (disagg pools, fault survivors); None when the fabric is
        dims-free."""
        return most_cubic_dims(n) if self.needs_dims else None

    # ---- collective placement (the comm_spec seam) ----
    def a2a_menu(self, n: int,
                 dims: Optional[Tuple[int, ...]]) -> Dict[str, coll.CollCost]:
        raise NotImplementedError

    def ar_menu(self, n: int,
                dims: Optional[Tuple[int, ...]]) -> Dict[str, coll.CollCost]:
        raise NotImplementedError

    def comm_spec_healthy(self, cl: "Cluster", kind: str, group: int,
                          tp: int, pp: int):
        """(menu, bandwidth, AlphaBeta) of one collective placed under the
        healthy (tp, pp, ep) mapping — `Cluster.comm_spec` wraps it with
        the fabric-agnostic FaultSet derating."""
        raise NotImplementedError

    def kv_handoff_alpha(self, cl: "Cluster") -> float:
        """Latency term of the disagg prefill->decode KV handoff
        (`sweep._sweep_disagg`): the pool's base alpha0, plus whatever a
        fabric charges to stand the transfer path up — the OCS re-match
        is the one phase-switch cost in the static-circuit model."""
        return cl._ab().alpha0

    # ---- degraded fabric ----
    def survivor_xpus(self, cl: "Cluster") -> int:
        if cl.faults is None:
            return cl.n_xpus
        return max(cl.n_xpus - cl.faults.xpus, 0)

    def mesh_link_counts(self, cl: "Cluster") -> Tuple[int, ...]:
        """Physical link count per dimension (empty off the meshes)."""
        return ()

    def fault_derate(self, cl: "Cluster") -> Tuple[float, float, float]:
        """(bandwidth factor, extra rounds, extra dests) the attached
        FaultSet imposes on every collective placed through `comm_spec`
        (docs/failure_model.md derives the per-fabric formulas). Factor
        monotonically non-increasing — and rounds/dests non-decreasing —
        in every fault count: the invariant the conformance battery and
        the degradation-monotonicity property tests pin."""
        return 1.0, 0.0, 0.0

    # ---- inventory (priced by core/tco.py) ----
    def switch_capacity_total(self, cl: "Cluster") -> float:
        """Total packet-switch capacity in B/s (radix x port bandwidth x
        count); 0.0 for switchless and circuit-switched fabrics."""
        return 0.0

    def link_inventory(self, cl: "Cluster") -> LinkInventory:
        raise NotImplementedError

    def ocs_port_count(self, cl: "Cluster") -> int:
        """Circuit-switch (MEMS) ports the cluster terminates — priced
        per port, independent of bandwidth (the OCS thesis); 0 off the
        OCS fabric."""
        return 0

    # ---- availability (component classes + blast radius) ----
    def switch_count(self, cl: "Cluster") -> int:
        """Switch ASIC count behind `switch_capacity_total`'s sizing (0
        for the switchless meshes)."""
        return 0

    def net_component_classes(self, cl: "Cluster",
                              make: Callable[[str, int], "ComponentClass"]
                              ) -> List["ComponentClass"]:
        """Failable NETWORK component classes (the XPU row is fabric-
        agnostic and added by `availability.component_inventory`)."""
        raise NotImplementedError

    def faultset_for_counts(self, cl: "Cluster",
                            counts: Dict[str, int]) -> FaultSet:
        """Per-class failure counts -> the `FaultSet` the serving model
        consumes, encoding this fabric's blast radius."""
        raise NotImplementedError


FABRICS: Dict[str, Fabric] = {}


def register_fabric(fabric: Fabric) -> Fabric:
    """Register `fabric` under its name (insertion order is the order
    TOPOLOGIES and the figures enumerate)."""
    FABRICS[fabric.name] = fabric
    return fabric


def get_fabric(name: str) -> Fabric:
    try:
        return FABRICS[name]
    except KeyError:
        raise ValueError(
            f"unknown topology {name!r}; registered fabrics: "
            + ", ".join(repr(n) for n in FABRICS)) from None


# ---------------------------------------------------------------------------
# switched electrical fabrics (non-blocking fat-tree)
# ---------------------------------------------------------------------------

class _SwitchedFabric(Fabric):
    """Shared machinery of the two fat-tree fabrics: NCCL-class menus,
    clos switch sizing, copper/AOC cable inventory."""

    ports_per_xpu: int = 1

    def a2a_menu(self, n, dims):
        return _switched_a2a_menu(n)

    def ar_menu(self, n, dims):
        return _switched_ar_menu(n)

    def _intra_switch_bw(self, cl: "Cluster") -> float:
        """Intra-node scale-up switching the fabric carries on top of the
        cluster fabric (0.0 unless the nodes ship their own islands)."""
        return 0.0

    def switch_capacity_total(self, cl):
        intra = self._intra_switch_bw(cl)
        ports_per_xpu = self.ports_per_xpu
        port_bw = cl.link_bw / ports_per_xpu
        endpoints = cl.n_xpus * ports_per_xpu
        if endpoints <= SWITCH_RADIX * ports_per_xpu \
                and cl.n_xpus <= SWITCH_RADIX:
            # one-level: each XPU port rail goes to its own switch plane
            n_switches = ports_per_xpu
            return intra + n_switches * SWITCH_RADIX * port_bw
        # two-level folded clos: leaf (half down/half up) + spine
        down = SWITCH_RADIX // 2
        n_leaf = math.ceil(endpoints / down)
        n_spine = math.ceil(n_leaf * down / SWITCH_RADIX)
        return intra + (n_leaf + n_spine) * SWITCH_RADIX * port_bw

    def link_inventory(self, cl):
        # XPU->leaf links: intra-rack copper. Leaf->spine (two-level): AOC.
        gb = 1e9
        xpu_links_bw = cl.n_xpus * cl.link_bw
        intra = self._intra_switch_bw(cl)
        if cl.n_xpus <= SWITCH_RADIX:
            return LinkInventory(
                copper_gbps_total=(xpu_links_bw + intra) / gb)
        up_bw = xpu_links_bw                     # non-blocking
        return LinkInventory(
            copper_gbps_total=(xpu_links_bw + intra) / gb,
            aoc_gbps_total=up_bw / gb)

    def switch_count(self, cl):
        ports = self.ports_per_xpu
        endpoints = cl.n_xpus * ports
        if endpoints <= SWITCH_RADIX * ports and cl.n_xpus <= SWITCH_RADIX:
            return ports
        down = SWITCH_RADIX // 2
        n_leaf = math.ceil(endpoints / down)
        n_spine = math.ceil(n_leaf * down / SWITCH_RADIX)
        return n_leaf + n_spine

    def net_component_classes(self, cl, make):
        out = [make("link_copper", cl.n_xpus * self.ports_per_xpu)]
        if cl.n_xpus > SWITCH_RADIX:
            # two-level clos: leaf->spine AOC runs, one per endpoint port
            out.append(make("link_aoc", cl.n_xpus * self.ports_per_xpu))
        out.append(make("switch", self.switch_count(cl)))
        return out


class ScaleUpFabric(_SwitchedFabric):
    """NVLink-class scale-up domain: every XPU stripes SCALE_UP_PORTS
    rails across parallel switch planes at full provision."""

    name = "scale-up"
    ports_per_xpu = SCALE_UP_PORTS

    def comm_spec_healthy(self, cl, kind, group, tp, pp):
        n_grp = group or cl.n_xpus
        ab = cl._ab()
        if kind == "pp_sendrecv":
            # a switch hop at full provision
            return {"sendrecv": coll.pp_sendrecv()}, cl.link_bw, ab
        if kind == "a2a":
            if tp * max(pp, 1) <= 1 or n_grp >= cl.n_xpus:
                return self.a2a_menu(cl.n_xpus, cl.dims), cl.link_bw, ab
            # any ep subset of the switched fabric at full provision
            return self.a2a_menu(n_grp, None), cl.link_bw, ab
        menu = self.ar_menu(n_grp, cl.dims)
        return menu, cl.link_bw, ab

    def fault_derate(self, cl):
        # a failed switch plane removes one of the SCALE_UP_PORTS parallel
        # rails every XPU stripes across: bandwidth scales by surviving
        # planes / planes, no extra latency (the rails are independent)
        f = cl.faults
        if f is None or not f.any:
            return 1.0, 0.0, 0.0
        frac = max(SCALE_UP_PORTS - f.switch_planes, 0) / SCALE_UP_PORTS
        return max(frac, _DEAD_FABRIC_FRAC), 0.0, 0.0

    def faultset_for_counts(self, cl, counts):
        # a severed XPU-to-leaf cable idles one of that XPU's rails, and
        # collectives synchronize on the slowest rank, so it derates like
        # a plane; switch/AOC failures likewise
        k_link = counts.get("link_copper", 0) + counts.get("link_aoc", 0)
        planes = min(counts.get("switch", 0) + k_link, SCALE_UP_PORTS)
        return FaultSet(switch_planes=planes,
                        xpus=min(counts.get("xpu", 0), cl.n_xpus))


class ScaleOutFabric(_SwitchedFabric):
    """NIC-provisioned fat-tree over DGX-style nodes, each node carrying
    its own NODE_XPUS-wide NVLink island (the intra-node scale-up domain
    the TCO must not omit — paper section 3.4)."""

    name = "scale-out"
    ports_per_xpu = SCALE_OUT_PORTS
    nic_provisioned = True

    def _intra_switch_bw(self, cl):
        return cl.n_xpus * cl.xpu.scale_up_bw

    def comm_spec_healthy(self, cl, kind, group, tp, pp):
        n_grp = group or cl.n_xpus
        ab = cl._ab()
        if kind == "pp_sendrecv":
            hop = {"sendrecv": coll.pp_sendrecv()}
            if cl.n_xpus <= NODE_XPUS:
                # whole cluster inside one NVLink island: every
                # boundary rides the scale-up switch
                return hop, cl.xpu.scale_up_bw, INTRA_NODE
            # multi-island cluster: island-crossing stage boundaries
            # exist at every pp (stages >= island: all of them; stages
            # < island: the island-edge ones), and one menu prices all
            # pp-1 hops — charge the NIC, the conservative bound
            return hop, cl.link_bw, CLUSTER
        if kind == "a2a":
            if tp * max(pp, 1) <= 1 or n_grp >= cl.n_xpus:
                return self.a2a_menu(cl.n_xpus, cl.dims), cl.link_bw, ab
            # any ep subset of the switched fabric at full provision
            return self.a2a_menu(n_grp, None), cl.link_bw, ab
        if tp > 1 and n_grp == tp and n_grp < cl.n_xpus \
                and tp <= NODE_XPUS:
            # TP inside the NVLink-class island: scale-up switching at
            # the XPU's scale-up provision, intra-node latencies
            return _switched_ar_menu(n_grp), cl.xpu.scale_up_bw, INTRA_NODE
        menu = self.ar_menu(n_grp, cl.dims)
        return menu, cl.link_bw, ab

    def survivor_xpus(self, cl):
        # each failed NIC additionally takes its whole NODE_XPUS island
        # node out (the node's only path into the fabric)
        if cl.faults is None:
            return cl.n_xpus
        lost = cl.faults.xpus + cl.faults.nics * NODE_XPUS
        return max(cl.n_xpus - lost, 0)

    def fault_derate(self, cl):
        # NIC failures are node-count events (survivor_xpus), not fabric
        # derates — the surviving nodes' non-blocking tree is unaffected
        return 1.0, 0.0, 0.0

    def net_component_classes(self, cl, make):
        return super().net_component_classes(cl, make) \
            + [make("nic", cl.n_xpus)]

    def faultset_for_counts(self, cl, counts):
        # a severed XPU cable is NIC-equivalent (the node's only path); a
        # fabric-switch failure disconnects its whole down-port span of
        # XPUs (`switch_blast_xpus`); leaf-spine AOC loss is absorbed by
        # the non-blocking tree (a known under-estimate, noted in
        # docs/failure_model.md)
        xpus = counts.get("xpu", 0)
        nics = counts.get("nic", 0) + counts.get("link_copper", 0)
        xpus += counts.get("switch", 0) * switch_blast_xpus(cl)
        return FaultSet(nics=nics, xpus=min(xpus, cl.n_xpus))


def switch_blast_xpus(cluster: "Cluster") -> int:
    """XPUs a single scale-out switch failure disconnects: at one level the
    lone fabric switch serves every endpoint (the whole cluster goes dark
    — the blast-radius concentration the mesh topologies do not have);
    at two levels a leaf takes its SWITCH_RADIX/2 down-ports' XPUs."""
    if cluster.n_xpus <= SWITCH_RADIX:
        return cluster.n_xpus
    return min(SWITCH_RADIX // 2, cluster.n_xpus)


# ---------------------------------------------------------------------------
# switchless mesh fabrics (3D torus / 3D full-mesh)
# ---------------------------------------------------------------------------

class _MeshFabric(Fabric):
    """Shared machinery of the switchless meshes: dims handling, link
    census, copper/AOC split, fault spreading; each concrete mesh supplies
    its per-dimension link count, derate, and quotient-bandwidth rules."""

    needs_dims = True

    def _links_per_dim(self, cl: "Cluster", d: int) -> int:
        raise NotImplementedError

    def mesh_link_counts(self, cl):
        if not cl.dims:
            return ()
        out = []
        for d in cl.dims:
            if d <= 1:
                out.append(0)
            else:
                out.append(self._links_per_dim(cl, d))
        return tuple(out)

    def _dim_derate(self, cl: "Cluster", i: int, li: int,
                    fi: int) -> Tuple[float, float, float]:
        """(bandwidth fraction, extra rounds, extra dests) of ONE active
        dimension with fi of its li links down."""
        raise NotImplementedError

    def fault_derate(self, cl):
        f = cl.faults
        if f is None or not f.any:
            return 1.0, 0.0, 0.0
        links = self.mesh_link_counts(cl)
        active = [i for i, d in enumerate(cl.dims) if d > 1]
        if not active:
            return 1.0, 0.0, 0.0
        fracs = []
        extra_r = extra_d = 0.0
        for i in active:
            li = links[i]
            fi = min(f.link_at(i), li)
            if fi == 0:
                fracs.append(1.0)
                continue
            fr, dr, dd = self._dim_derate(cl, i, li, fi)
            fracs.append(fr)
            extra_r += dr
            extra_d += dd
        frac = sum(fracs) / len(fracs)
        return max(frac, _DEAD_FABRIC_FRAC), extra_r, extra_d

    def _pp_n_links(self, active: List[int]) -> int:
        """Links the per-XPU aggregate provision is spread across (the
        pp hop rides exactly one of them)."""
        raise NotImplementedError

    def _a2a_quotient_frac(self, cl: "Cluster", sub: Tuple[int, ...],
                           qdims: Tuple[int, ...],
                           active: List[int]) -> float:
        """Bandwidth fraction the stride-tp quotient group keeps."""
        raise NotImplementedError

    def _ar_sub_frac(self, cl: "Cluster", sub: Tuple[int, ...],
                     active: List[int]) -> float:
        """Bandwidth fraction pointing into the TP sub-mesh."""
        raise NotImplementedError

    def comm_spec_healthy(self, cl, kind, group, tp, pp):
        n_grp = group or cl.n_xpus
        ab = cl._ab()
        if kind == "pp_sendrecv":
            hop = {"sendrecv": coll.pp_sendrecv()}
            # mesh: the hop crosses the single link that leaves the stage
            # block, one of the 2*ndim (torus) / sum(d-1) (full-mesh)
            # links the per-XPU aggregate provision is spread across
            active = [d for d in (cl.dims or (cl.n_xpus,)) if d > 1]
            n_links = self._pp_n_links(active)
            return hop, cl.link_bw / max(n_links, 1), ab
        if kind == "a2a":
            if tp * max(pp, 1) <= 1 or n_grp >= cl.n_xpus:
                return self.a2a_menu(cl.n_xpus, cl.dims), cl.link_bw, ab
            stage = (_tp_subdims(cl.dims, cl.n_xpus // pp)
                     if pp > 1 else cl.dims)
            sub = _tp_subdims(stage, tp) if stage is not None else None
            if sub is None:
                return self.a2a_menu(cl.n_xpus, cl.dims), cl.link_bw, ab
            qdims = tuple(d // t for d, t in zip(stage, sub))
            menu = self.a2a_menu(n_grp, _strip_ones(qdims))
            active = [i for i, d in enumerate(cl.dims) if d > 1]
            frac = self._a2a_quotient_frac(cl, sub, qdims, active)
            return menu, cl.link_bw * max(frac, 1e-9), ab
        # all-reduce
        if tp > 1 and n_grp == tp and n_grp < cl.n_xpus:
            sub = _tp_subdims(cl.dims, tp)
            if sub is not None:
                sdims = _strip_ones(sub)
                menu = self.ar_menu(n_grp, sdims)
                active = [i for i, d in enumerate(cl.dims) if d > 1]
                frac = self._ar_sub_frac(cl, sub, active)
                return menu, cl.link_bw * max(frac, 1e-9), ab
        menu = self.ar_menu(n_grp, cl.dims)
        return menu, cl.link_bw, ab

    def _cross_frac(self, cl: "Cluster") -> float:
        """Fraction of links that leave the rack (rough: last dim
        crosses)."""
        raise NotImplementedError

    def link_inventory(self, cl):
        # switchless: every XPU's aggregate BW spread across its links;
        # links within a rack are copper, cross-rack AOC.
        gb = 1e9
        n_racks = math.ceil(cl.n_xpus / XPUS_PER_RACK)
        total_bw = cl.n_xpus * cl.link_bw      # counts each link twice/2
        if n_racks == 1:
            return LinkInventory(copper_gbps_total=total_bw / gb)
        cross_frac = self._cross_frac(cl)
        return LinkInventory(
            copper_gbps_total=total_bw * (1 - cross_frac) / gb,
            aoc_gbps_total=total_bw * cross_frac / gb)

    def net_component_classes(self, cl, make):
        # mesh links split copper/AOC by the `link_inventory` bandwidth
        # fractions over the exact physical link count
        inv = cl.link_inventory()
        total_links = sum(cl.mesh_link_counts())
        total_bw = inv.copper_gbps_total + inv.aoc_gbps_total
        aoc_frac = inv.aoc_gbps_total / total_bw if total_bw else 0.0
        n_aoc = int(round(total_links * aoc_frac))
        return [make("link_copper", total_links - n_aoc),
                make("link_aoc", n_aoc)]

    def faultset_for_counts(self, cl, counts):
        # link failures spread over dims (`_spread_mesh_links`)
        k_link = counts.get("link_copper", 0) + counts.get("link_aoc", 0)
        mesh = _spread_mesh_links(cl, k_link)
        return FaultSet(mesh_links=mesh,
                        xpus=min(counts.get("xpu", 0), cl.n_xpus))


class TorusFabric(_MeshFabric):
    """3D torus: ring dims, HalfRing / DOR-P2P A2A, Swing all-reduce."""

    name = "torus"

    def a2a_menu(self, n, dims):
        return {"halfring": coll.a2a_torus_halfring(dims),
                "p2p": coll.a2a_torus_p2p(dims)}

    def ar_menu(self, n, dims):
        return {"ring": coll.ar_ring(n), "swing": coll.ar_swing_torus(dims)}

    def _links_per_dim(self, cl, d):
        # dim of extent d: n/d rings x d links (degenerate d=2 'ring':
        # one link per pair)
        return cl.n_xpus if d > 2 else cl.n_xpus // 2

    def _dim_derate(self, cl, i, li, fi):
        # the first failed link of a dimension breaks a ring into a line:
        # wrapped traffic detours the long way, folding over the
        # surviving links (x1/2 efficiency), and ring phases pay ~d/2
        # detour rounds; further failures remove capacity linearly
        return (0.5 * (li - fi) / li,
                math.ceil(cl.dims[i] / 2),
                math.ceil(cl.dims[i] / 2))

    def _pp_n_links(self, active):
        return 2 * len(active)

    def _a2a_quotient_frac(self, cl, sub, qdims, active):
        # torus: a stride-t ring hop crosses t physical links
        return (sum(1.0 / sub[i] for i in active if qdims[i] > 1)
                / len(active))

    def _ar_sub_frac(self, cl, sub, active):
        return len([s for s in sub if s > 1]) / len(active)

    def _cross_frac(self, cl):
        return 1.0 / 3.0


class FullMeshFabric(_MeshFabric):
    """3D full-mesh: fully-connected lines per dim, DoR / one-shot A2A."""

    name = "fullmesh"

    def a2a_menu(self, n, dims):
        return {"dor": coll.a2a_fullmesh_dor(dims),
                "oneshot": coll.a2a_fullmesh_oneshot(dims)}

    def ar_menu(self, n, dims):
        # rings embed across mesh links; near-optimal aggregate bandwidth
        return {"ring": coll.ar_ring(n), "p2p": coll.ar_rabenseifner(n)}

    def _links_per_dim(self, cl, d):
        # dim of extent d: n/d lines x d(d-1)/2 direct links
        return (cl.n_xpus // d) * d * (d - 1) // 2

    def _dim_derate(self, cl, i, li, fi):
        # a lost direct link forces its pair onto a 2-hop relay across
        # the (d-1) surviving links of the line — the rerouted traffic
        # consumes 2x capacity (factor (L - 2f)/L per dim) and adds one
        # store-and-forward relay round per affected dimension
        return max(li - 2 * fi, 0) / li, 1.0, 2.0

    def _pp_n_links(self, active):
        return sum(d - 1 for d in active)

    def _a2a_quotient_frac(self, cl, sub, qdims, active):
        # stride-t peers in a full-mesh line are directly linked:
        # (q-1) of the (d-1) links per dim stay usable
        return (sum(qdims[i] - 1 for i in active)
                / sum(cl.dims[i] - 1 for i in active))

    def _ar_sub_frac(self, cl, sub, active):
        return (sum(s - 1 for s in sub)
                / sum(cl.dims[i] - 1 for i in active))

    def _cross_frac(self, cl):
        d = cl.dims
        links = sum(x - 1 for x in d)
        return (d[-1] - 1) / links


# ---------------------------------------------------------------------------
# optical circuit-switched fabric (the fifth topology)
# ---------------------------------------------------------------------------

class OCSFabric(Fabric):
    """Runtime-reconfigurable optical circuit switching: OCS_PORTS fiber
    ports per XPU into MEMS switches, circuits re-matched per serving
    phase and held static within one (see the module docstring and
    docs/fabrics.md). Within a phase only fixed-partner-graph algorithms
    exist: the expert A2A store-and-forwards over a static expander, the
    TP all-reduce rings over dedicated single-hop circuits."""

    name = "ocs"
    reconfigurable = True

    def a2a_menu(self, n, dims):
        # DOR-style store-and-forward over the held expander circuits:
        # every payload byte crosses `h` fibers, so the beta term dilates
        # by the hop count; alpha pays per-hop rounds and P2P-style
        # per-destination serialization
        h = _circuit_hops(n, OCS_PORTS)
        return {"expander": coll.CollCost(rounds=h, dests=n - 1,
                                          m_coeff=h * (n - 1) / n,
                                          name="ocs-expander")}

    def ar_menu(self, n, dims):
        # ring keeps the same left/right partners every round — the one
        # classic all-reduce that never asks for a circuit re-match
        # (recursive doubling / rabenseifner re-pair each round: each
        # re-pairing would be a MEMS re-match mid-collective)
        return {"ring": coll.ar_ring(n)}

    def comm_spec_healthy(self, cl, kind, group, tp, pp):
        n_grp = group or cl.n_xpus
        ab = cl._ab()
        if kind == "pp_sendrecv":
            # adjacent stages hold a dedicated circuit pair (one fiber
            # each way) for the hidden-state hop
            hop = {"sendrecv": coll.pp_sendrecv()}
            return hop, cl.link_bw * (2.0 / OCS_PORTS), ab
        if kind == "a2a":
            if tp * max(pp, 1) <= 1 or n_grp >= cl.n_xpus:
                # whole-cluster phase: every port joins the expander
                return self.a2a_menu(cl.n_xpus, cl.dims), cl.link_bw, ab
            # expert A2A on the ports the TP circuits don't hold
            bw = cl.link_bw * (1.0 - OCS_TP_BW_FRAC) if tp > 1 \
                else cl.link_bw
            return self.a2a_menu(n_grp, None), bw, ab
        # all-reduce
        if tp > 1 and n_grp == tp and n_grp < cl.n_xpus:
            # the low-alpha neighborhood: dedicated single-hop ring
            # circuits around the TP group — intra-node-class latency at
            # the TP fraction of the port budget
            return (self.ar_menu(n_grp, None),
                    cl.link_bw * OCS_TP_BW_FRAC, INTRA_NODE)
        return self.ar_menu(n_grp, cl.dims), cl.link_bw, ab

    def kv_handoff_alpha(self, cl):
        # the dedicated prefill->decode circuit is set up AT the phase
        # switch: one MEMS re-match on top of the base handoff latency
        return cl._ab().alpha0 + OCS_RECONF_S

    def fault_derate(self, cl):
        # a failed fiber / MEMS port idles one of the OCS_PORTS port
        # planes of its XPU, and collectives synchronize on the slowest
        # rank — the scale-up plane model over the OCS port count. A re-
        # match can route AROUND the dead port (no detour rounds), unlike
        # a torus ring break.
        f = cl.faults
        if f is None or not f.any:
            return 1.0, 0.0, 0.0
        frac = max(OCS_PORTS - f.switch_planes, 0) / OCS_PORTS
        return max(frac, _DEAD_FABRIC_FRAC), 0.0, 0.0

    def link_inventory(self, cl):
        # every port's bandwidth is transceiver-terminated fiber — priced
        # per GB/s in core/tco.py (between copper and AOC); the MEMS
        # ports themselves are the bandwidth-independent ocs_port_count
        gb = 1e9
        return LinkInventory(ocs_trx_gbps_total=cl.n_xpus * cl.link_bw / gb)

    def ocs_port_count(self, cl):
        return cl.n_xpus * OCS_PORTS

    def switch_count(self, cl):
        # MEMS switch count: every XPU port terminates on a duplex
        # OCS_RADIX-port circuit switch
        return math.ceil(cl.n_xpus * OCS_PORTS / OCS_RADIX)

    def net_component_classes(self, cl, make):
        # fibers are transceiver-terminated optics -> the AOC failure
        # class; MEMS switches reuse the switch class
        return [make("link_aoc", cl.n_xpus * OCS_PORTS),
                make("switch", self.switch_count(cl))]

    def faultset_for_counts(self, cl, counts):
        # any fiber or MEMS failure idles port planes (`fault_derate`);
        # there is no high-blast-radius packet switch to lose
        k_link = counts.get("link_copper", 0) + counts.get("link_aoc", 0)
        planes = min(counts.get("switch", 0) + k_link, OCS_PORTS)
        return FaultSet(switch_planes=planes,
                        xpus=min(counts.get("xpu", 0), cl.n_xpus))


# registration order IS the canonical enumeration order (TOPOLOGIES, the
# figure sweeps): the four static fabrics first, reconfigurable last
register_fabric(ScaleUpFabric())
register_fabric(ScaleOutFabric())
register_fabric(TorusFabric())
register_fabric(FullMeshFabric())
register_fabric(OCSFabric())
