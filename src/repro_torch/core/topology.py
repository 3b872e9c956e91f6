"""Cluster facade over the pluggable fabric registry (`core/fabric.py`):
bandwidth provisioning, switch/link inventory (for TCO), and
best-algorithm collective times (paper sections 2.2, 3.2.2, 3.4).

Five registered fabrics: the paper's four static families (Fig. 2) —
scale-up / scale-out (non-blocking fat-tree), 3D torus, 3D full-mesh
(torus/full-mesh dims: 4x4x4 at 64 and 8x8x4 at 256) — plus the
reconfigurable optical circuit-switched fabric (docs/fabrics.md).
`TOPOLOGIES` enumerates the static four (what the paper's figures
sweep); `repro.core.fabric.FABRICS` is the full registry and the single
source of truth for names, menus, derates, and inventories. `Cluster`
owns only the fabric-AGNOSTIC machinery: the alpha-beta regime choice
(`_ab`), the FaultSet derate wrapper around `comm_spec`, the
best-of-menu timers, and `describe`.

Degraded fabrics: a `FaultSet` attached to a `Cluster` derates every
collective placed through `comm_spec` — the topologies fail very
differently (a mesh degrades gracefully via detours; a switched fabric
concentrates failures into few high-blast-radius planes), and the
derating formulas live in each fabric's `fault_derate` (documented in
docs/failure_model.md). A cluster with `faults=None` is byte-identical
to the pre-fault model on every path.

Expert-load skew never enters this layer: a skewed A2A is priced by
scaling the per-op PAYLOAD handed to the alpha-beta menus (`m_bytes` x
hot-rank load factor, `sweep.op_load_factors`) — the beta term grows with
the hottest rank's ingress while the alpha terms (rounds, destinations)
are topology properties and stay fixed, matching a symmetric collective
that synchronizes on its slowest member. `comm_spec` and the menus
are skew-agnostic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core.alphabeta import AlphaBeta, CLUSTER, INTRA_NODE
from repro_torch.core import collectives as coll
from repro_torch.core.fabric import (DIMS_BY_SIZE, FABRICS, FaultSet, Fabric,
                               LinkInventory, NODE_XPUS, SCALE_OUT_PORTS,
                               SCALE_UP_PORTS, SWITCH_RADIX, XPUS_PER_RACK,
                               _DEAD_FABRIC_FRAC, _strip_ones, _tp_subdims,
                               get_fabric)
from repro_torch.core.hardware import XPUSpec

__all__ = [
    "TOPOLOGIES", "DIMS_BY_SIZE", "NODE_XPUS", "SWITCH_RADIX",
    "SCALE_UP_PORTS", "SCALE_OUT_PORTS", "XPUS_PER_RACK",
    "Cluster", "Fabric", "FaultSet", "LinkInventory", "get_fabric",
    "make_cluster",
]

# the paper's four STATIC fabrics, in registry order — what fig10/14/17
# sweep; the reconfigurable OCS fabric is registered beside them and
# enumerated via `fabric.FABRICS` where a figure wants all five
TOPOLOGIES = tuple(name for name, f in FABRICS.items()
                   if not f.reconfigurable)


@dataclass(frozen=True)
class Cluster:
    topology: str
    n_xpus: int
    xpu: XPUSpec
    link_bw: float                      # per-XPU aggregate network BW (B/s)
    dims: Optional[Tuple[int, ...]] = None
    faults: Optional[FaultSet] = None   # None = healthy (byte-identical)

    def __post_init__(self):
        # registry lookup IS the validation: a typo ("full-mesh") raises
        # here naming the registered fabrics instead of silently pricing
        # as a phantom fabric through the generic menus
        fab = get_fabric(self.topology)
        if fab.needs_dims and self.dims is None:
            if self.n_xpus not in DIMS_BY_SIZE:
                raise ValueError(
                    f"no predefined {self.topology} dims for "
                    f"n_xpus={self.n_xpus}; supported sizes: "
                    f"{sorted(DIMS_BY_SIZE)} — pass dims=(a, b, c) "
                    "explicitly for other sizes")
            object.__setattr__(self, "dims", DIMS_BY_SIZE[self.n_xpus])

    @property
    def fabric(self) -> Fabric:
        """The registered `Fabric` every topology-dependent hook
        delegates to."""
        return get_fabric(self.topology)

    # ------------- degraded fabric -------------
    def with_faults(self, faults: Optional[FaultSet]) -> "Cluster":
        """This cluster with `faults` attached (None clears them)."""
        return Cluster(topology=self.topology, n_xpus=self.n_xpus,
                       xpu=self.xpu, link_bw=self.link_bw, dims=self.dims,
                       faults=faults)

    def survivor_xpus(self) -> int:
        """Devices still serving under `self.faults` (fabric-specific:
        e.g. on scale-out each failed NIC takes its whole island node
        out)."""
        return self.fabric.survivor_xpus(self)

    def mesh_link_counts(self) -> Tuple[int, ...]:
        """Physical link count per dimension of a torus / full-mesh
        (empty for non-mesh fabrics)."""
        return self.fabric.mesh_link_counts(self)

    def _fault_derate(self) -> Tuple[float, float, float]:
        """(bandwidth factor, extra rounds, extra dests) the attached
        FaultSet imposes — the fabric's formula
        (docs/failure_model.md)."""
        return self.fabric.fault_derate(self)

    # ------------- collectives -------------
    def _ab(self) -> AlphaBeta:
        return CLUSTER if self.n_xpus > 8 else INTRA_NODE

    def comm_spec(self, kind: str, group: int = 0, tp: int = 1,
                  pp: int = 1):
        """(algorithm menu, bandwidth, AlphaBeta) of one collective PLACED
        under the hybrid (tp, pp, ep) mapping, derated by the attached
        `FaultSet` (identity when `faults` is None — the healthy placement
        is untouched). Both the scalar timers and the batched
        engine's (A, B) lowering consume this one spec, so degraded
        batched and scalar times agree exactly as healthy ones do."""
        menu, bw, ab = self._comm_spec_healthy(kind, group, tp, pp)
        if self.faults is None or not self.faults.any:
            return menu, bw, ab
        factor, extra_r, extra_d = self._fault_derate()
        if factor == 1.0 and extra_r == 0.0 and extra_d == 0.0:
            return menu, bw, ab
        menu = {name: coll.CollCost(rounds=c.rounds + extra_r,
                                    dests=c.dests + extra_d,
                                    m_coeff=c.m_coeff, name=c.name)
                for name, c in menu.items()}
        return menu, bw * factor, ab

    def _comm_spec_healthy(self, kind: str, group: int = 0, tp: int = 1,
                           pp: int = 1):
        """The healthy-fabric collective placement — the topology-aware
        half of the parallelism search, owned by the fabric
        (`Fabric.comm_spec_healthy`).

        kind 'ar' with group == tp is the TP all-reduce: it runs over the
        scale-up / mesh NEIGHBORHOOD (a tp-sized sub-mesh of torus /
        full-mesh dims, the intra-node island of a scale-out cluster, a
        dedicated circuit ring on the OCS fabric), so it sees only the
        link bandwidth that points into that neighborhood — the placement
        is the same contiguous block on every pipeline stage, so it is
        pp-independent.
        kind 'a2a' with group == ep < n is the expert dispatch/gather over
        the REMAINDER of the STAGE: the quotient of the stage's n/pp-device
        block by the TP neighborhood (stride-tp peers on meshes, with torus
        hops dilated by the stride).
        kind 'pp_sendrecv' is the per-token hidden-state hop between
        corresponding devices of adjacent stages: a neighbor hop riding
        ONE mesh link on torus / full-mesh, a NIC hop on multi-island
        scale-out (scale-up switching only when the whole cluster fits
        one island), a switch hop at full provision on scale-up.

        tp <= 1, pp <= 1, group in (0, n): the seed whole-cluster
        placement, byte-identical to the pre-hybrid model.
        """
        return self.fabric.comm_spec_healthy(self, kind, group, tp, pp)

    def _best_time(self, kind: str, m_bytes: float, group: int, tp: int,
                   pp: int) -> float:
        """min over the placed menu's algorithms — the one timing formula
        behind a2a_time / ar_time / pp_hop_time."""
        menu, bw, ab = self.comm_spec(kind, group, tp, pp)
        return min(ab.time(rounds=c.rounds, dests=c.dests, m_coeff=c.m_coeff,
                           m_bytes=m_bytes, bandwidth=bw)
                   for c in menu.values())

    def a2a_time(self, m_bytes: float, group: Optional[int] = None,
                 tp: int = 1, pp: int = 1) -> float:
        """Best all-to-all algorithm for this topology; m = per-XPU payload.
        `group`/`tp`/`pp` place the collective under the hybrid mapping
        (see `comm_spec`); the defaults are the seed whole-cluster
        semantics."""
        return self._best_time("a2a", m_bytes, group or 0, tp, pp)

    def ar_time(self, m_bytes: float, group: Optional[int] = None,
                tp: int = 1, pp: int = 1) -> float:
        return self._best_time("ar", m_bytes, group or 0, tp, pp)

    def pp_hop_time(self, m_bytes: float, pp: int = 2, tp: int = 1) -> float:
        """One inter-stage hidden-state hop (see `comm_spec` kind
        'pp_sendrecv'); m = per-XPU payload of the microbatch slice."""
        return self._best_time("pp_sendrecv", m_bytes, pp, tp, pp)

    # ------------- inventory (for TCO) -------------
    def switch_capacity_total(self) -> float:
        """Total packet-switch capacity in B/s (radix x port bandwidth x
        count), non-blocking fat-tree sized for per-XPU `link_bw`;
        switchless and circuit-switched fabrics carry none.

        Scale-out additionally carries its INTRA-NODE scale-up domain
        (8-XPU NVLink-class switching at the XPU's scale-up provision) —
        that is what a DGX-style server actually ships with, and omitting
        it would make scale-out spuriously cheap (paper section 3.4)."""
        return self.fabric.switch_capacity_total(self)

    def link_inventory(self) -> LinkInventory:
        """Aggregate link bandwidth by cable type. Intra-rack copper,
        inter-rack AOC (64 XPUs/rack, paper section 3.4); OCS fiber is
        tracked separately (transceiver-terminated)."""
        return self.fabric.link_inventory(self)

    def ocs_port_count(self) -> int:
        """Circuit-switch ports the cluster terminates (0 off the OCS
        fabric); priced per port by `core.tco`."""
        return self.fabric.ocs_port_count(self)

    def describe(self) -> Dict:
        out = {"topology": self.topology, "n": self.n_xpus,
               "link_bw_GBs": self.link_bw / 1e9, "dims": self.dims}
        if self.faults is not None and self.faults.any:
            out["faults"] = {"mesh_links": list(self.faults.mesh_links),
                             "switch_planes": self.faults.switch_planes,
                             "nics": self.faults.nics,
                             "xpus": self.faults.xpus}
        return out


def make_cluster(topology: str, n_xpus: int, xpu: XPUSpec,
                 link_bw: Optional[float] = None, *,
                 link_bw_mult: Optional[float] = None) -> Cluster:
    """link_bw defaults to the fabric's provision
    (`Fabric.default_link_bw`): the NIC bandwidth on NIC-provisioned
    fabrics, the scale-up provision elsewhere (paper section 3.2: 'fix
    the total per-XPU network bandwidth'). `link_bw_mult` scales whatever
    the previous rules produced — the bandwidth-derating sweeps
    (fig12/fig17-style) say 'x of provision' without restating the
    provision."""
    if link_bw is None:
        link_bw = get_fabric(topology).default_link_bw(xpu)
    if link_bw_mult is not None:
        link_bw = link_bw * link_bw_mult
    return Cluster(topology=topology, n_xpus=n_xpus, xpu=xpu, link_bw=link_bw)
