"""Cluster-scale continuous-batching traffic simulator.

The operating-point search answers "best steady-state point per scenario";
production serves bursty, diurnal, mixed-length traffic from millions of
users. This module replays seeded arrival traces against a cluster running
SOLVED operating points (obtained exclusively through `repro_torch.core.api`) and
reports goodput under SLO attainment — the production-facing counterpart of
the capacity figures.

Model (docs/traffic_sim.md has the full derivation):

  * Traces: Poisson or Gamma-burst interarrivals (`TraceSpec.cv2` is the
    interarrival CV^2), optional diurnal rate modulation via a time-warp of
    the unit-rate arrival stream (so scaling `rate_rps` compresses the SAME
    request sequence — offered-load sweeps are monotone by construction),
    and a (weight, prompt_len, gen_len) mixture per request. All seeded.
  * Serving: iteration-clocked continuous batching. Requests join at
    iteration boundaries up to the operating point's batch; each iteration
    takes `api.tpot_curve`'s TPOT at the CURRENT batch (the same GridEval
    arithmetic the search used). A request with an m-chunk prompt occupies
    its slot for m prefill iterations before its first token; iterations
    carrying chunks stretch by ceil(k/domains) * mean-chunk-time
    (Sarathi-style piggybacking, priced by the scalar chunk components).
  * Autoscaling: a threshold policy switches between pool sizes of an
    operating-point catalog as observed load shifts. An elective switch
    does NOT stall serving — the old pool keeps serving while the new
    one re-shards, so the new operating point takes effect one
    remap downtime (`DegradedPlan`) LATER and both pools bill during the overlap (that
    lag-plus-double-billing IS the switch cost). Parked pool capacity is
    released back to the shared fleet, so the XPU capex + energy share
    of the monthly cost bills by active fraction while the fabric stays
    a fixed cost of the topology.
  * Faults: `repro_torch.faults.FailureInjector` fires at seeded iteration
    indices; each event prices its `FaultSet` through the remap-vs-degrade
    policy (`api.solve` with `spec.faults`) and becomes a QUEUEING event —
    keep-arm derating, or drain + remap downtime + degraded serving until
    repair + re-shard back — instead of `availability`'s amortized
    factor. TTFT spikes fall out of the queue, not an approximation.

Vectorization follows `core/sweep.py`'s idiom: the per-iteration Python
loop does O(1) bookkeeping (dict-of-counts for completions), admissions
land as array slices, and every per-request metric (TTFT, TPOT, SLO
attainment, Little's-law occupancy) is derived post-hoc from the recorded
iteration end-times with NumPy — so a million-request trace costs an
array program plus one short loop over iterations, not per-request Python.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import api, optimizer, placement, sweep, workload
from repro_torch.core.optimizer import OperatingPoint, Scenario
from repro_torch.core.specdec import SpecDecConfig
from repro_torch.core.tco import cluster_tco
from repro_torch.core.topology import Cluster, FaultSet
from repro_torch.core.workload import ServingPoint
from repro_torch.faults import FailureInjector, sample_faultset


# ---------------------------------------------------------------------------
# arrival traces
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TraceSpec:
    """Seeded arrival-trace recipe.

    `arrival` 'poisson' draws Exp(1) unit interarrivals; 'gamma' draws
    Gamma(1/cv2, cv2) (mean 1, CV^2 = `cv2` > 1 = bursty). The unit-rate
    stream is scaled by `rate_rps` and, when `diurnal_amplitude` > 0,
    time-warped through the inverse cumulative rate of
    rate(t) = rate_rps * (1 + A sin(2 pi t / P)) — the classic inversion
    construction, so the SAME seed yields the SAME request sequence at
    every rate (load sweeps are monotone by construction).

    `length_mix` is a tuple of (weight, prompt_len, gen_len) classes; each
    request draws its class from the normalized weights.
    """
    horizon_s: float
    rate_rps: float
    arrival: str = "poisson"
    cv2: float = 1.0
    diurnal_amplitude: float = 0.0
    diurnal_period_s: float = 3600.0
    length_mix: Tuple[Tuple[float, int, int], ...] = ((1.0, 0, 1024),)
    seed: int = 0
    name: str = ""

    def __post_init__(self):
        if self.horizon_s <= 0:
            raise ValueError(f"horizon_s must be > 0, got {self.horizon_s}")
        if self.rate_rps < 0:
            raise ValueError(f"rate_rps must be >= 0, got {self.rate_rps}")
        if self.arrival not in ("poisson", "gamma"):
            raise ValueError(f"unknown arrival {self.arrival!r}")
        if self.cv2 <= 0:
            raise ValueError(f"cv2 must be > 0, got {self.cv2}")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1), got "
                             f"{self.diurnal_amplitude}")
        if not self.length_mix or any(
                w <= 0 or p < 0 or g < 1 for w, p, g in self.length_mix):
            raise ValueError("length_mix needs (weight > 0, prompt >= 0, "
                             f"gen >= 1) classes, got {self.length_mix}")

    @property
    def mean_gen(self) -> float:
        w = sum(w for w, _, _ in self.length_mix)
        return sum(wi * g for wi, _, g in self.length_mix) / w

    def scaled(self, load: float) -> "TraceSpec":
        """The same trace recipe at `load` x the offered rate."""
        return replace(self, rate_rps=self.rate_rps * load)


@dataclass
class Trace:
    """Materialized arrival trace: sorted times + per-request lengths."""
    spec: TraceSpec
    t: np.ndarray        # arrival seconds, sorted, within [0, horizon_s)
    prompt: np.ndarray   # prompt tokens per request (int64)
    gen: np.ndarray      # decode tokens per request (int64, >= 1)

    @property
    def n(self) -> int:
        return int(self.t.size)


def _unit_arrivals(spec: TraceSpec, budget: float,
                   rng: np.random.Generator) -> np.ndarray:
    """Cumulative unit-rate arrival stream covering [0, budget]."""
    draws: List[np.ndarray] = []
    total = 0.0
    block = max(int(budget) + 16, 64)
    while total <= budget:
        if spec.arrival == "poisson":
            ia = rng.exponential(1.0, size=block)
        else:
            ia = rng.gamma(1.0 / spec.cv2, spec.cv2, size=block)
        draws.append(ia)
        total += float(ia.sum())
    s = np.cumsum(np.concatenate(draws))
    return s[s <= budget]


def generate_trace(spec: TraceSpec) -> Trace:
    """Materialize a `TraceSpec` deterministically (one RNG per spec)."""
    rng = np.random.default_rng(spec.seed)
    r, h = spec.rate_rps, spec.horizon_s
    if r == 0.0:
        empty = np.zeros(0)
        zero = np.zeros(0, np.int64)
        return Trace(spec, empty, zero, zero)
    a, period = spec.diurnal_amplitude, spec.diurnal_period_s
    if a == 0.0:
        s = _unit_arrivals(spec, r * h, rng)
        t = s / r
    else:
        # cumulative rate Lambda(t) = r*(t + A*P/(2pi)*(1 - cos(2pi t/P)));
        # invert on a fine grid (monotone, A < 1 keeps rate(t) > 0)
        grid = np.linspace(0.0, h, max(int(64 * h / period), 4096))
        lam = r * (grid + a * period / (2 * np.pi)
                   * (1.0 - np.cos(2 * np.pi * grid / period)))
        s = _unit_arrivals(spec, float(lam[-1]), rng)
        t = np.interp(s, lam, grid)
    w = np.array([wi for wi, _, _ in spec.length_mix], float)
    cls = rng.choice(len(spec.length_mix), size=t.size, p=w / w.sum())
    prompts = np.array([p for _, p, _ in spec.length_mix], np.int64)[cls]
    gens = np.array([g for _, _, g in spec.length_mix], np.int64)[cls]
    return Trace(spec, t, prompts, gens)


# ---------------------------------------------------------------------------
# operating-point catalog (pool sizes x solved points)
# ---------------------------------------------------------------------------

@dataclass
class PoolPoint:
    """One catalog entry: a pool of the base cluster with its solved
    operating point and the curves the simulator clocks against."""
    cluster: Cluster
    point: OperatingPoint
    tpot: np.ndarray           # TPOT seconds at batch b = index + 1
    chunk_time: float          # mixture-mean prefill-chunk time (0 = none)
    domains: int               # DP-attention domains (chunks per iteration)

    @property
    def n_xpus(self) -> int:
        return self.cluster.n_xpus

    @property
    def cap(self) -> int:
        return self.point.batch


class Catalog:
    """Operating points per pool size for one (cfg, cluster, scenario,
    spec) — the autoscaler's menu. Entries ascend in pool size; the last
    (full-pool) entry is the static-provisioning arm. Every point comes
    from `api.solve`; every curve from `api.tpot_curve`."""

    def __init__(self, cfg: ModelConfig, cluster: Cluster,
                 scenario: Scenario, spec: api.SearchSpec,
                 entries: List[PoolPoint], chunk: int):
        self.cfg = cfg
        self.cluster = cluster
        self.scenario = scenario
        self.spec = spec
        self.entries = entries
        self.chunk = chunk
        self._degraded: Dict[Tuple[int, FaultSet], Tuple] = {}

    @property
    def full(self) -> PoolPoint:
        return self.entries[-1]

    def capacity_rps(self, entry: PoolPoint, mean_gen: float) -> float:
        return entry.point.throughput / max(mean_gen, 1.0)

    def est_iterations(self, trace: Trace) -> int:
        """Generous iteration-count bound for sizing a FailureInjector."""
        t_it = float(self.full.tpot[-1])
        return int(2 * trace.spec.horizon_s / t_it) + 4096

    def degraded_state(self, entry_idx: int, faults: FaultSet):
        """(plan, keep_curve, remap_curve) for a fault on one pool, cached.

        Curves are `api.tpot_curve` on the survivor sub-cluster for the
        plan's keep/remap points (None where that arm is infeasible). The
        policy search runs with tp='auto' (re-sharding is the point of the
        remap arm), same software variant as the pool's solved point.
        """
        key = (entry_idx, faults)
        if key in self._degraded:
            return self._degraded[key]
        entry = self.entries[entry_idx]
        pt = entry.point
        spec_f = api.SearchSpec(
            tp="auto", dbo=pt.used_dbo,
            sd=SpecDecConfig() if pt.used_sd else None,
            dtype=self.spec.dtype, faults=faults)
        sol = api.solve(self.cfg, entry.cluster, self.scenario, spec_f)
        plan = sol.plan
        cl_d = sweep.degraded_subcluster(entry.cluster, faults)

        def curve(p):
            if p is None or cl_d is None:
                return None
            return api.tpot_curve(self.cfg, cl_d, self.scenario,
                                  np.arange(1, p.batch + 1), point=p,
                                  dtype=self.spec.dtype)
        state = (plan, curve(plan.keep_point), curve(plan.remap_point))
        self._degraded[key] = state
        return state


def _chunk_pricing(cfg: ModelConfig, cluster: Cluster, scenario: Scenario,
                   point: OperatingPoint, mix, chunk: int,
                   dtype: str) -> Tuple[float, Dict[int, int]]:
    """(mixture-mean chunk time, prompt_len -> n_chunks) for one pool.

    Chunks run one per DP domain per carrying iteration
    (`optimizer.chunked_prefill_components`); the simulator charges each
    carrying iteration the MEAN chunk time of the arrival mix, weighted by
    how many chunks each prompt class contributes."""
    n = cluster.n_xpus
    domains = max(n // point.tp, 1)
    n_chunks: Dict[int, int] = {}
    t_sum = w_sum = 0.0
    for w, p_len, _ in mix:
        if p_len < 1:
            continue
        sizes, offsets = workload.chunk_schedule(p_len, chunk)
        n_chunks[p_len] = len(sizes)
        p_ch = ServingPoint(
            batch_global=domains, context=0, tp=point.tp,
            ep=max(point.ep, 1), n_devices=n, dtype=dtype, pp=point.pp,
            moe_load=placement.point_factors(cfg, scenario,
                                             max(point.ep, 1),
                                             point.extra_experts),
            moe_extra=point.extra_experts)
        times = [optimizer.prefill_chunk_components(
            cfg, replace(p_ch, context=off), cluster, s,
            dbo=point.used_dbo)[0] for s, off in zip(sizes, offsets)]
        t_sum += w * sum(times)
        w_sum += w * len(times)
    return (t_sum / w_sum if w_sum else 0.0), n_chunks


def build_catalog(cfg: ModelConfig, cluster: Cluster, scenario: Scenario,
                  spec: api.SearchSpec = api.SearchSpec(), *,
                  pool_fracs: Sequence[float] = (1.0,),
                  mix: Sequence[Tuple[float, int, int]] = ((1.0, 0, 1024),),
                  chunk: int = 512) -> Catalog:
    """Solve one operating point per pool size (carved by the
    disagg-pool conventions, `sweep._subcluster`) through `api.solve`,
    with TPOT curves from `api.tpot_curve` and chunk pricing for the
    arrival mix. Infeasible pools are dropped; the full pool must solve."""
    if spec.faults is not None or spec.mode != "decode":
        raise ValueError("catalogs are healthy decode-path searches; "
                         "faults enter per-event via FaultPlan")
    n = cluster.n_xpus
    sizes = sorted({max(int(round(n * f)), 1) for f in pool_fracs})
    if sizes[-1] != n:
        raise ValueError(f"pool_fracs must include 1.0 (full pool), got "
                         f"{pool_fracs}")
    entries: List[PoolPoint] = []
    for n_sub in sizes:
        pool = (cluster if n_sub == n
                else sweep._subcluster(cluster, n_sub))
        sol = api.solve(cfg, pool, scenario, spec)
        if sol.point is None:
            continue
        pt = sol.point
        curve = api.tpot_curve(cfg, pool, scenario,
                               np.arange(1, pt.batch + 1), point=pt,
                               dtype=spec.dtype, backend=spec.backend)
        chunk_time, _ = _chunk_pricing(cfg, pool, scenario, pt, mix, chunk,
                                       spec.dtype)
        entries.append(PoolPoint(cluster=pool, point=pt,
                                 tpot=np.asarray(curve),
                                 chunk_time=chunk_time,
                                 domains=max(n_sub // pt.tp, 1)))
    if not entries or entries[-1].n_xpus != n:
        raise ValueError("the full pool has no feasible operating point "
                         "for this scenario")
    return Catalog(cfg, cluster, scenario, spec, entries, chunk)


# ---------------------------------------------------------------------------
# policies and fault plans
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AutoscalePolicy:
    """Threshold autoscaler over the catalog's pool sizes.

    Every `check_interval_s` of sim time it estimates demand from the
    arrivals of the last interval PLUS the un-admitted backlog (cleared
    within one interval) and picks the smallest pool whose request
    capacity covers demand / `target_util`. A decided switch takes
    effect `switch_downtime_s` later (the degrade policy's remap downtime — the new
    pool re-shards while the old one keeps serving) and bills BOTH pool
    sizes during the overlap. Hysteresis is asymmetric, as in
    production autoscalers: scale-UP is decided at any check,
    scale-DOWN only after `min_dwell_s` since the last switch —
    reacting slowly to troughs costs energy, reacting slowly to ramps
    costs SLOs."""
    check_interval_s: float = 60.0
    target_util: float = 0.75
    min_dwell_s: float = 300.0
    switch_downtime_s: float = optimizer.REMAP_DOWNTIME_S


@dataclass
class FaultPlan:
    """Seeded fault events for one simulation: the injector fires at
    iteration indices; firing k consumes `faultsets[k]` (cycling), prices
    it through the remap-vs-degrade policy, and serves degraded until
    `repair_s` later. `downtime_s` is charged per re-shard (enter AND
    exit of a remap plan)."""
    injector: FailureInjector
    faultsets: Tuple[FaultSet, ...]
    repair_s: float = 1800.0
    downtime_s: float = optimizer.REMAP_DOWNTIME_S


def seeded_fault_plan(cluster: Cluster, *, n_iters: int,
                      rate_per_iter: float, seed: int = 0,
                      exposure_h: float = 24.0,
                      repair_s: float = 1800.0,
                      downtime_s: float = optimizer.REMAP_DOWNTIME_S
                      ) -> FaultPlan:
    """Deterministic fault plan: Bernoulli(rate)-per-iteration firing
    times (`FailureInjector.seeded`) with one non-empty seeded `FaultSet`
    per firing (`repro_torch.faults.sample_faultset`)."""
    inj = FailureInjector.seeded(n_iters, rate_per_iter, seed)
    fss: List[FaultSet] = []
    k = 0
    for _ in inj.fail_at:
        fs = FaultSet(xpus=1)   # fallback if sampling never fires
        for _ in range(1024):
            cand = sample_faultset(cluster, exposure_h=exposure_h,
                                   seed=seed * 7919 + k)
            k += 1
            # sample_faultset pads mesh_links with zeros, so compare
            # component counts, not dataclass equality with FaultSet()
            if (any(cand.mesh_links) or cand.switch_planes
                    or cand.nics or cand.xpus):
                fs = cand
                break
        fss.append(fs)
    return FaultPlan(injector=inj, faultsets=tuple(fss),
                     repair_s=repair_s, downtime_s=downtime_s)


# ---------------------------------------------------------------------------
# simulation result
# ---------------------------------------------------------------------------

@dataclass
class TrafficResult:
    """Per-trace serving outcome. Times in seconds, rates cluster-wide."""
    n_requests: int
    n_iters: int
    elapsed_s: float
    attainment: float          # fraction of requests meeting BOTH SLOs
    goodput_tok_s: float       # decode tokens of SLO-meeting requests / s
    throughput_tok_s: float    # all served decode tokens / s
    ttft_p50: float
    ttft_p99: float
    tpot_p50: float
    tpot_p99: float
    n_ttft_miss: int
    n_tpot_miss: int
    active_frac: float         # time-weighted active-XPU fraction
    cost_month: float          # $ / month, XPU share billed by active_frac
    goodput_per_cost: float    # goodput_tok_s / cost_month
    n_switches: int
    n_fault_events: int
    mean_batch: float
    mean_in_system: float      # time-average requests in system (L)
    mean_sojourn_s: float      # mean arrival -> completion (W)
    arrival_rps: float         # completed-request rate (lambda)

    def as_dict(self) -> Dict[str, float]:
        out = {}
        for k, v in self.__dict__.items():
            out[k] = float(f"{v:.9g}") if isinstance(v, float) else v
        return out


def fleet_cost(cluster: Cluster, active_frac: float = 1.0,
               c: float = 1.0) -> float:
    """Monthly fleet cost with the XPU capex + energy share billed by the
    time-weighted active fraction — XPUs the autoscaler parks go back to
    the shared fleet and bill elsewhere, but the fabric is a fixed cost
    of the topology (you cannot scale away a fat-tree you already
    bought). `c` is the paper's network-cost adjustment factor."""
    bd = cluster_tco(cluster)
    return ((bd.monthly_xpu + bd.monthly_energy_xpu) * active_frac
            + c * (bd.monthly_switch + bd.monthly_link
                   + bd.monthly_energy_net * active_frac))


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

def _percentiles(x: np.ndarray) -> Tuple[float, float]:
    if x.size == 0:
        return 0.0, 0.0
    return (float(np.percentile(x, 50)), float(np.percentile(x, 99)))


def simulate_trace(catalog: Catalog, trace: Trace, *,
                   autoscale: Optional[AutoscalePolicy] = None,
                   faults: Optional[FaultPlan] = None,
                   start_entry: Optional[int] = None,
                   cost_c: float = 1.0,
                   max_iters: int = 4_000_000) -> TrafficResult:
    """Replay `trace` against `catalog`'s operating points.

    Static provisioning (autoscale=None) serves the whole trace on one
    entry (default: the full pool). With a policy, the simulator switches
    pools on observed demand; with a `FaultPlan`, injector firings become
    queueing events (see the module docstring). Deterministic: same
    inputs -> bit-identical result.
    """
    n = trace.n
    arr_t, gen = trace.t, trace.gen
    # chunk count per request (prompt prefill iterations)
    m_arr = np.zeros(n, np.int64)
    if n and trace.prompt.max() > 0:
        for p_len in np.unique(trace.prompt):
            if p_len > 0:
                m = len(workload.chunk_schedule(int(p_len),
                                                catalog.chunk)[0])
                m_arr[trace.prompt == p_len] = m

    entries = catalog.entries
    e_idx = len(entries) - 1 if start_entry is None else start_entry
    entry = entries[e_idx]
    cur_curve, cur_cap = entry.tpot, entry.cap
    cur_domains, cur_chunk_t = entry.domains, entry.chunk_time
    n_active = entry.n_xpus
    n_base = catalog.cluster.n_xpus
    mean_gen = trace.spec.mean_gen

    # per-request records (join iteration; -1 = never admitted)
    join_iter = np.full(n, -1, np.int64)
    t_end: List[float] = []            # end time of each iteration
    # future-iteration count arrays (batch completions / prefill-slot
    # releases land as np.add.at slices at admission time)
    cap_events = catalog.est_iterations(trace) + int(gen.max(initial=1)) \
        + int(m_arr.max(initial=0)) + 16
    finishing = np.zeros(cap_events, np.int64)
    pre_end = np.zeros(cap_events, np.int64)

    t = 0.0
    it = 0
    b = 0            # requests in the batch
    n_pre = 0        # of which still prefilling
    ptr = 0          # next arrival to admit
    done = 0         # completed requests

    # integrals for active-fraction / Little's law / mean batch
    active_int = 0.0
    system_int = 0.0
    batch_int = 0.0

    def advance(dt: float) -> None:
        nonlocal t, active_int, system_int, batch_int
        arrived = int(np.searchsorted(arr_t, t, side="right"))
        system_int += (arrived - done) * dt
        active_int += n_active * dt
        batch_int += b * dt
        t += dt

    # ---- autoscale / fault state ----
    policy = autoscale
    next_check = policy.check_interval_s if policy else math.inf
    last_switch = -math.inf
    n_switches = 0
    # (apply_at_t, target_entry): decided switch re-sharding in the
    # background while the current pool keeps serving
    pending_switch: Optional[Tuple[float, int]] = None

    fault_state: Optional[Tuple] = None     # (plan, keep_c, remap_c, kind)
    fault_restore = math.inf
    fault_drain = False
    degraded_serving = False
    n_fault_events = 0
    # run-local firing bookkeeping: `FailureInjector.check` mutates its
    # `fired` list, which would make a shared FaultPlan one-shot across
    # simulations — membership here keeps simulate_trace side-effect-free
    fail_set = (frozenset(faults.injector.fail_at) if faults is not None
                else frozenset())
    fired_local: set = set()

    healthy = (cur_curve, cur_cap, cur_domains, cur_chunk_t)

    def set_clock(curve, cap, domains, chunk_t):
        nonlocal cur_curve, cur_cap, cur_domains, cur_chunk_t
        cur_curve, cur_cap = curve, cap
        cur_domains, cur_chunk_t = domains, chunk_t

    def enter_degraded(plan, keep_c, remap_c):
        """Post-drain (or no-drain) switch onto the fault plan's serving
        arm; returns True if any serving curve exists."""
        nonlocal degraded_serving
        pt = plan.point
        curve = keep_c if plan.action == "keep" else remap_c
        if pt is None or curve is None:
            return False
        surv = sweep.degraded_subcluster(entries[e_idx].cluster,
                                         plan_faults[0])
        set_clock(curve, pt.batch, max(surv.n_xpus // pt.tp, 1),
                  entries[e_idx].chunk_time)
        degraded_serving = True
        return True

    plan_faults: List[FaultSet] = [FaultSet()]

    while ptr < n or b > 0:
        if it >= max_iters:
            raise RuntimeError(f"simulation exceeded {max_iters} "
                               "iterations; check offered load")
        # ---- fault injection (iteration boundary) ----
        if faults is not None and fault_state is None:
            if it in fail_set and it not in fired_local:
                fired_local.add(it)
                n_fault_events += 1
                fs = faults.faultsets[(n_fault_events - 1)
                                      % len(faults.faultsets)]
                plan_faults[0] = fs
                plan, keep_c, remap_c = catalog.degraded_state(e_idx, fs)
                fault_restore = t + faults.repair_s
                if plan.action == "down" or plan.point is None:
                    # nothing survives: stall until repair
                    advance(faults.repair_s)
                    fault_restore = math.inf
                elif plan.action == "keep":
                    fault_state = (plan, keep_c, remap_c, "keep")
                    enter_degraded(plan, keep_c, remap_c)
                else:  # remap: drain on the keep arm, then re-shard
                    fault_state = (plan, keep_c, remap_c, "remap")
                    if keep_c is not None and plan.keep_point is not None:
                        surv = sweep.degraded_subcluster(
                            entries[e_idx].cluster, fs)
                        set_clock(keep_c, plan.keep_point.batch,
                                  max(surv.n_xpus
                                      // plan.keep_point.tp, 1),
                                  entries[e_idx].chunk_time)
                        fault_drain = True
                    else:
                        # keep arm infeasible: requests stall through the
                        # re-shard downtime, then serve the remap arm
                        advance(faults.downtime_s)
                        if not enter_degraded(plan, keep_c, remap_c):
                            advance(max(fault_restore - t, 0.0))
                            fault_state, fault_restore = None, math.inf
        # ---- fault repair ----
        if fault_state is not None and t >= fault_restore and not fault_drain:
            plan = fault_state[0]
            if fault_state[3] == "remap" and degraded_serving:
                advance(faults.downtime_s)   # re-shard back
            set_clock(*healthy)
            fault_state, fault_restore = None, math.inf
            degraded_serving = False

        # ---- elective switch warmed up -> swap serving curves ----
        if pending_switch is not None:
            if fault_state is not None:
                # the fleet is busy surviving a fault: abandon the
                # elective re-shard (deterministically) and re-decide
                # after repair
                pending_switch = None
                n_active = entries[e_idx].n_xpus
            elif t >= pending_switch[0]:
                e_idx = pending_switch[1]
                entry = entries[e_idx]
                set_clock(entry.tpot, entry.cap, entry.domains,
                          entry.chunk_time)
                healthy = (cur_curve, cur_cap, cur_domains, cur_chunk_t)
                n_active = entry.n_xpus
                pending_switch = None
                last_switch = t
                n_switches += 1

        draining = fault_drain

        # ---- drain completion -> execute pending switch ----
        if b == 0 and fault_drain:
            fault_drain = False
            plan, keep_c, remap_c, _ = fault_state
            if t >= fault_restore:    # repaired before the drain finished
                set_clock(*healthy)
                fault_state, fault_restore = None, math.inf
            else:
                advance(faults.downtime_s)
                if not enter_degraded(plan, keep_c, remap_c):
                    advance(max(fault_restore - t, 0.0))
                    set_clock(*healthy)
                    fault_state, fault_restore = None, math.inf
            continue

        # ---- idle fast-forward ----
        if b == 0 and not draining:
            if ptr >= n:
                break
            if arr_t[ptr] > t:
                nxt = arr_t[ptr]
                if policy:
                    nxt = min(nxt, next_check)
                    if pending_switch is not None:
                        nxt = min(nxt, pending_switch[0])
                advance(max(nxt - t, 0.0))
                if pending_switch is not None and t >= pending_switch[0]:
                    continue    # apply the warmed-up switch first
        # ---- admissions ----
        if not draining and ptr < n and b < cur_cap:
            limit = int(np.searchsorted(arr_t, t, side="right"))
            k = min(limit - ptr, cur_cap - b)
            if k > 0:
                sl = slice(ptr, ptr + k)
                join_iter[sl] = it
                fin = it + m_arr[sl] + gen[sl] - 1
                if int(fin.max()) >= finishing.size:
                    grow = int(fin.max()) + cap_events
                    finishing = np.concatenate(
                        [finishing, np.zeros(grow - finishing.size,
                                             np.int64)])
                    pre_end = np.concatenate(
                        [pre_end, np.zeros(grow - pre_end.size, np.int64)])
                np.add.at(finishing, fin, 1)
                pre = m_arr[sl]
                if pre.max(initial=0) > 0:
                    np.add.at(pre_end, it + pre[pre > 0], 1)
                    n_pre += int((pre > 0).sum())
                b += k
                ptr += k

        # ---- one decode iteration ----
        if b > 0:
            n_pre -= int(pre_end[it])
            if b <= cur_cap:
                dt = float(cur_curve[b - 1])
            else:
                # over-capacity (degraded cap below in-flight batch):
                # serve in cap-sized waves
                dt = float(cur_curve[cur_cap - 1]) * (b / cur_cap)
            if n_pre > 0:
                dt += math.ceil(n_pre / cur_domains) * cur_chunk_t
            advance(dt)
            t_end.append(t)
            fin = int(finishing[it])
            b -= fin
            done += fin
            it += 1

        # ---- autoscale control loop ----
        if policy and t >= next_check and fault_state is None:
            w0 = t - policy.check_interval_s
            arrived = int(np.searchsorted(arr_t, t, side="right"))
            seen = arrived - int(np.searchsorted(arr_t, w0, side="right"))
            backlog = arrived - ptr       # waiting, not yet admitted
            demand = (seen + backlog) / policy.check_interval_s
            want = len(entries) - 1
            for i, e in enumerate(entries):
                if demand <= (policy.target_util
                              * catalog.capacity_rps(e, mean_gen)):
                    want = i
                    break
            if pending_switch is None and (
                    want > e_idx or (want < e_idx and t - last_switch
                                     >= policy.min_dwell_s)):
                pending_switch = (t + policy.switch_downtime_s, want)
                # both pools powered while the target re-shards
                n_active = max(entries[e_idx].n_xpus,
                               entries[want].n_xpus)
            next_check = t + policy.check_interval_s

    elapsed = max(t, trace.spec.horizon_s)
    # the pool stays provisioned through the idle tail after the last
    # completion (static = full price for the whole horizon)
    active_int += n_active * max(elapsed - t, 0.0)
    t_end_a = np.asarray(t_end)
    n_iters = len(t_end)

    served = join_iter >= 0
    if n == 0 or not served.any():
        ttft = tpot_req = np.zeros(0)
        meets = np.zeros(0, bool)
        goodput = thr = 0.0
        sojourn = 0.0
    else:
        ji = join_iter[served]
        first = t_end_a[ji + m_arr[served]]
        last = t_end_a[ji + m_arr[served] + gen[served] - 1]
        ttft = first - arr_t[served]
        g = gen[served]
        tpot_req = np.where(g > 1, (last - first) / np.maximum(g - 1, 1),
                            0.0)
        sc = catalog.scenario
        ttft_slo = sc.ttft_ms * 1e-3 if sc.ttft_ms > 0 else math.inf
        tpot_slo = sc.tpot_ms * 1e-3
        ok_ttft = ttft <= ttft_slo * (1 + 1e-9)
        ok_tpot = tpot_req <= tpot_slo * (1 + 1e-9)
        meets = ok_ttft & ok_tpot
        goodput = float(g[meets].sum()) / elapsed
        thr = float(g.sum()) / elapsed
        sojourn = float(np.mean(last - arr_t[served]))

    active_frac = active_int / (n_base * elapsed) if elapsed else 1.0
    cost = fleet_cost(catalog.cluster, active_frac, cost_c)
    p50_t, p99_t = _percentiles(ttft)
    p50_p, p99_p = _percentiles(tpot_req)
    n_served = int(served.sum())
    return TrafficResult(
        n_requests=n,
        n_iters=n_iters,
        elapsed_s=elapsed,
        attainment=float(meets.mean()) if n_served else 1.0,
        goodput_tok_s=goodput,
        throughput_tok_s=thr,
        ttft_p50=p50_t, ttft_p99=p99_t,
        tpot_p50=p50_p, tpot_p99=p99_p,
        n_ttft_miss=int((~ok_ttft).sum()) if n_served else 0,
        n_tpot_miss=int((~ok_tpot).sum()) if n_served else 0,
        active_frac=active_frac,
        cost_month=cost,
        goodput_per_cost=goodput / cost if cost else 0.0,
        n_switches=n_switches,
        n_fault_events=n_fault_events,
        mean_batch=batch_int / elapsed if elapsed else 0.0,
        mean_in_system=system_int / elapsed if elapsed else 0.0,
        mean_sojourn_s=sojourn,
        arrival_rps=n_served / elapsed if elapsed else 0.0,
    )


def best_provisioning(catalog: Catalog, trace: Trace, *,
                      policies: Sequence[Optional[AutoscalePolicy]],
                      faults: Optional[FaultPlan] = None,
                      cost_c: float = 1.0
                      ) -> Tuple[str, TrafficResult]:
    """Run `trace` under each provisioning arm (None = static full pool)
    and keep the best goodput-per-cost. Because the static arm is always
    in the menu, the winner never loses to static provisioning — the
    same never-loses construction as the placement search."""
    best_name, best = None, None
    for pol in policies:
        res = simulate_trace(catalog, trace, autoscale=pol, faults=faults,
                             cost_c=cost_c)
        name = "static" if pol is None else (
            f"autoscale@{pol.target_util:g}")
        if best is None or res.goodput_per_cost > best.goodput_per_cost:
            best_name, best = name, res
    return best_name, best
