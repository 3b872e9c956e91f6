"""Availability-adjusted serving throughput under component failures.

The paper's cost-effectiveness ranking (fig14/fig17) is evaluated on a
healthy cluster, but the four fabrics fail very differently: a mesh has
thousands of individually-failable cables and degrades gracefully via
detours, while a switched fabric concentrates failures into a few
high-blast-radius switch planes. This module prices that difference:

  1. `component_inventory` derives per-cluster component counts from the
     same inventory the TCO model charges (links by cable class via
     `Cluster.link_inventory` / `mesh_link_counts`, switch ASICs via the
     `switch_capacity_total` sizing, NICs, XPUs) and attaches per-class
     MTBF/MTTR defaults (documented in docs/failure_model.md).
  2. `build_availability` maps every fault state up to `max_total_faults`
     onto a `FaultSet`, prices it through the failure-aware re-search with
     the remap-vs-degrade policy (`optimizer.degrade_policy`), and caches
     the per-state throughputs.
  3. `AvailabilityModel.report(mtbf_scale)` computes the stationary
     probability of each state — closed-form binomial for the single-fault
     states, the same pmf vectorized (NumPy outer products over the state
     grid, the `core/sweep.py` idiom) for the multi-fault enumeration —
     and returns the expected steady-state throughput. Unenumerated
     deeper states are lumped into the tail at zero throughput (a
     conservative under-estimate), and per-event transition losses (the
     in-flight-collective retry/timeout penalty plus any re-shard
     downtime) are charged against the failure arrival rates.

Separating (2) from (3) makes MTBF sweeps cheap: the expensive degraded
searches run once per cluster, then `report` re-weights them per failure
rate — how `benchmarks/fig_failures.py` finds the crossover MTBF.

Layer: probability weighting above the degraded sweep
(`sweep.degraded_max_throughput`); the underlying searches keep the
sweep layer's scalar/batched parity, and the stationary weighting is
plain float arithmetic on top.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.topology import Cluster, FaultSet

HOURS_TO_S = 3600.0

# ---------------------------------------------------------------------------
# in-flight collective retry/timeout model
# ---------------------------------------------------------------------------

# NCCL-style watchdog: a collective whose peer died hangs until the
# timeout fires before the runtime tears the group down and retries.
COLLECTIVE_TIMEOUT_S = 0.5


def straddle_penalty(t_iter_degraded: float, *,
                     timeout_s: float = COLLECTIVE_TIMEOUT_S,
                     retries: int = 1) -> float:
    """Seconds lost by an iteration whose in-flight collective straddles a
    failure: the op hangs to the watchdog timeout, then the iteration
    replays on the (already derated) surviving fabric `retries` times at
    worst. The pre-failure partial iteration is discarded, so the replay
    is charged in full."""
    if timeout_s < 0 or retries < 0:
        raise ValueError("timeout_s and retries must be >= 0")
    return timeout_s + retries * t_iter_degraded


# ---------------------------------------------------------------------------
# component inventory
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ComponentClass:
    """One failable component class: `count` identical units, each with
    the given MTBF/MTTR (hours). Stationary per-unit unavailability is the
    classic MTTR / (MTBF + MTTR) of an alternating renewal process."""
    name: str                  # "xpu" | "link_copper" | "link_aoc"
    count: int                 # | "switch" | "nic"
    mtbf_h: float
    mttr_h: float

    def unavailability(self, mtbf_scale: float = 1.0) -> float:
        return self.mttr_h / (self.mtbf_h * mtbf_scale + self.mttr_h)

    def event_rate_per_s(self, mtbf_scale: float = 1.0) -> float:
        """Fleet-wide failure arrivals of this class, events/second."""
        return self.count / (self.mtbf_h * mtbf_scale * HOURS_TO_S)


# Per-class MTBF/MTTR defaults (hours). Sources in docs/failure_model.md:
# XPU ~5e4 h matches the 15-20 %/yr accelerator annual failure rates of
# published large-fleet training post-mortems; optical transceivers/AOCs
# fail an order of magnitude more often than passive copper DACs; switch
# ASICs sit between; repair times are cable-swap vs. board-swap scale.
MTBF_MTTR_H: Dict[str, Tuple[float, float]] = {
    "xpu": (5.0e4, 24.0),
    "link_copper": (5.0e6, 2.0),
    "link_aoc": (7.5e5, 2.0),
    "switch": (2.0e5, 8.0),
    "nic": (1.0e6, 4.0),
}


def component_inventory(cluster: Cluster,
                        mtbf_mttr: Optional[Dict[str, Tuple[float, float]]]
                        = None) -> List[ComponentClass]:
    """Failable components of one cluster, counts derived from the same
    inventory the TCO model prices. The XPU row is fabric-agnostic; the
    network rows come from the fabric's `net_component_classes` hook
    (core/fabric.py): mesh links split copper/AOC by the `link_inventory`
    bandwidth fractions over the exact physical link count; switched
    fabrics carry XPU-to-leaf cables (copper), leaf-spine cables (AOC,
    two-level only), and switch ASICs; scale-out carries one NIC per XPU
    whose loss orphans the whole NODE_XPUS node; the OCS fabric carries
    transceiver-terminated fibers and MEMS switches."""
    mm = dict(MTBF_MTTR_H)
    if mtbf_mttr:
        mm.update(mtbf_mttr)

    def cls(name: str, count: int) -> ComponentClass:
        mtbf, mttr = mm[name]
        return ComponentClass(name=name, count=count, mtbf_h=mtbf,
                              mttr_h=mttr)

    out = [cls("xpu", cluster.n_xpus)]
    out.extend(cluster.fabric.net_component_classes(cluster, cls))
    return [c for c in out if c.count > 0]


# ---------------------------------------------------------------------------
# fault-state -> FaultSet mapping
# ---------------------------------------------------------------------------

def faultset_for_counts(cluster: Cluster,
                        counts: Dict[str, int]) -> FaultSet:
    """Map per-class failure counts onto the `FaultSet` the serving model
    consumes, encoding each topology's blast radius — the fabric's
    `faultset_for_counts` hook (core/fabric.py):

    meshes      link failures spread over dims (`_spread_mesh_links`,
                longest dims first — the adversarial placement);
    scale-up    a severed XPU-to-leaf cable idles one of that XPU's rails,
                and collectives synchronize on the slowest rank, so it
                derates like a plane; switch/AOC failures likewise;
    scale-out   a severed XPU cable is NIC-equivalent (the node's only
                path); a fabric-switch failure disconnects its whole
                down-port span of XPUs (`switch_blast_xpus`); leaf-spine
                AOC loss is absorbed by the non-blocking tree (a known
                under-estimate, noted in docs/failure_model.md);
    ocs         fiber / MEMS failures idle port planes, the scale-up rail
                model over OCS_PORTS.
    """
    return cluster.fabric.faultset_for_counts(cluster, counts)


# ---------------------------------------------------------------------------
# stationary expectation
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultStateEval:
    counts: Tuple[int, ...]        # per component class, classes order
    faults: FaultSet
    throughput: float              # effective tokens/s under the policy
    action: str                    # degrade_policy action for this state


@dataclass(frozen=True)
class AvailabilityReport:
    expected_throughput: float     # tokens/s, stationary expectation
    healthy_throughput: float
    availability: float            # expected / healthy (0 when down)
    tail_mass: float               # P(unenumerated deeper states) -> thr 0
    transition_loss: float         # tokens/s charged to failure events
    mtbf_scale: float
    state_probs: Tuple[float, ...]


@dataclass(frozen=True)
class AvailabilityModel:
    """Per-(cluster, model, scenario) cache of fault states and their
    degraded throughputs; `report` re-weights them per failure rate."""
    cluster: Cluster
    classes: Tuple[ComponentClass, ...]
    states: Tuple[FaultStateEval, ...]
    healthy_throughput: float
    healthy_tpot: float            # seconds (straddle replay cost scale)
    remap_downtime_s: float

    def _probs(self, mtbf_scale: float) -> np.ndarray:
        """Stationary P(state) for every enumerated state, vectorized:
        per-class truncated-binomial tables combine by outer product over
        the state grid. Single-fault states reduce to the closed form
        C(N,1) u (1-u)^(N-1) exactly."""
        grid = np.array([s.counts for s in self.states], np.int64)
        probs = np.ones(len(self.states))
        for ci, c in enumerate(self.classes):
            u = c.unavailability(mtbf_scale)
            kmax = int(grid[:, ci].max()) if len(grid) else 0
            table = np.array([math.comb(c.count, k) * u ** k
                              * (1 - u) ** (c.count - k)
                              for k in range(kmax + 1)])
            probs *= table[grid[:, ci]]
        return probs

    def report(self, mtbf_scale: float = 1.0) -> AvailabilityReport:
        probs = self._probs(mtbf_scale)
        expected = float(probs @ np.array([s.throughput
                                           for s in self.states]))
        tail = max(1.0 - float(probs.sum()), 0.0)
        # per-event transient: the straddling collective hangs to the
        # timeout and the iteration replays; a remap decision additionally
        # pays the re-shard downtime. Charged at the healthy rate —
        # that is what the event interrupts.
        loss = 0.0
        single = {s.counts: s for s in self.states if sum(s.counts) == 1}
        for ci, c in enumerate(self.classes):
            key = tuple(1 if i == ci else 0
                        for i in range(len(self.classes)))
            st = single.get(key)
            if st is None:
                continue
            penalty = straddle_penalty(self.healthy_tpot)
            if st.action == "remap":
                penalty += self.remap_downtime_s
            loss += (c.event_rate_per_s(mtbf_scale) * penalty
                     * self.healthy_throughput)
        expected = max(expected - loss, 0.0)
        avail = (expected / self.healthy_throughput
                 if self.healthy_throughput else 0.0)
        return AvailabilityReport(
            expected_throughput=expected,
            healthy_throughput=self.healthy_throughput,
            availability=avail, tail_mass=tail, transition_loss=loss,
            mtbf_scale=mtbf_scale,
            state_probs=tuple(float(p) for p in probs))


def _enumerate_counts(classes: Sequence[ComponentClass],
                      max_total: int) -> List[Tuple[int, ...]]:
    """All per-class fault-count vectors with sum <= max_total (and k_c
    <= count_c), the zero state first."""
    caps = [min(c.count, max_total) for c in classes]
    grids = np.meshgrid(*[np.arange(cap + 1) for cap in caps],
                        indexing="ij")
    grid = np.stack([g.ravel() for g in grids], axis=-1)
    grid = grid[grid.sum(axis=1) <= max_total]
    return sorted(map(tuple, grid.tolist()), key=lambda t: (sum(t), t))


def build_availability(cluster: Cluster, cfg: ModelConfig, scenario, *,
                       max_total_faults: int = 2,
                       tp="auto", pp=1, dtype: str = "fp8",
                       dbo: bool = False, sd=None,
                       remap_downtime_s: Optional[float] = None,
                       horizon_s: Optional[float] = None,
                       mtbf_mttr: Optional[Dict[str, Tuple[float, float]]]
                       = None) -> AvailabilityModel:
    """Enumerate and price every fault state of `cluster` up to
    `max_total_faults` simultaneous failures.

    Each state maps to a `FaultSet` (`faultset_for_counts`), runs the
    failure-aware re-search under the remap-vs-degrade policy
    (`optimizer.degrade_policy`, baseline = the healthy operating point),
    and records the policy's effective throughput. States sharing a
    FaultSet share one search. The healthy (zero-fault) state prices
    through the ordinary search, byte-identical to the paper's model."""
    from repro_torch.core import optimizer, sweep

    rd = optimizer.REMAP_DOWNTIME_S if remap_downtime_s is None \
        else remap_downtime_s
    hz = optimizer.DEGRADED_HORIZON_S if horizon_s is None else horizon_s
    classes = tuple(component_inventory(cluster, mtbf_mttr))
    baseline = sweep.sweep_max_throughput([cluster], cfg, [scenario], tp=tp,
                                          pp=pp, dtype=dtype, dbo=dbo,
                                          sd=sd)[0][0]
    healthy_thr = baseline.throughput if baseline else 0.0
    healthy_tpot = baseline.tpot if baseline else 0.0

    states: List[FaultStateEval] = []
    by_faultset: Dict[FaultSet, Tuple[float, str]] = {}
    for counts_vec in _enumerate_counts(classes, max_total_faults):
        counts = {c.name: k for c, k in zip(classes, counts_vec)}
        if sum(counts_vec) == 0:
            states.append(FaultStateEval(counts_vec, FaultSet(),
                                         healthy_thr, "healthy"))
            continue
        fs = faultset_for_counts(cluster, counts)
        if fs not in by_faultset:
            plan = optimizer.degrade_policy(
                cluster, cfg, scenario, fs, baseline=baseline,
                remap_downtime_s=rd, horizon_s=hz, tp=tp, pp=pp,
                dtype=dtype, dbo=dbo, sd=sd)
            by_faultset[fs] = (plan.effective_throughput, plan.action)
        thr, action = by_faultset[fs]
        states.append(FaultStateEval(counts_vec, fs, thr, action))
    return AvailabilityModel(cluster=cluster, classes=classes,
                             states=tuple(states),
                             healthy_throughput=healthy_thr,
                             healthy_tpot=healthy_tpot,
                             remap_downtime_s=rd)
