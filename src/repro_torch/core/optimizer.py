"""Max-throughput-under-SLO sweep (paper sections 3.2.1, 4.1).

For a (cluster, model, scenario) triple, sweep batch size (and the software
optimizations DBO / SD) under the memory-capacity constraint, model TPOT as
compute + communication (with DBO's two-lane overlap when enabled), and
return the configuration with the highest throughput whose TPOT meets the
SLO. "Cluster builders provision for peak load": max capacity per cost is
the paper's cost-effectiveness metric.

The supported search entry point is `repro_torch.core.api.solve` (the
batched engine lives in `repro_torch.core.sweep`: the whole batch grid
evaluates as array programs, the argmax winner re-derived through the
scalar path below). `Scenario` lives in `repro_torch.core.scenario` and is
re-exported here. This module keeps:

  max_throughput / best_of_opts / max_throughput_prefill   DEPRECATED
      shims onto `api.solve` (they emit `ReproDeprecationWarning`).
  max_throughput_scalar / best_of_opts_scalar   the seed one-point-at-a-time
      reference, kept as ground truth for tests and boundary fallbacks.
  degrade_policy   the remap-vs-degrade decision `api.solve` routes to
      when a `FaultSet` is on the spec.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Union

from repro_torch.configs.base import ModelConfig
from repro_torch.core import compute_model as cm
from repro_torch.core import overlap, workload
from repro_torch.core.compute_model import Op
from repro_torch.core.scenario import Scenario
from repro_torch.core.specdec import SpecDecConfig
from repro_torch.core.topology import Cluster
from repro_torch.core.workload import ServingPoint


# the paper's evaluation grid
SCENARIOS = [Scenario(t, c) for c in (512, 4096) for t in (15.0, 40.0, 100.0)]


@dataclass(frozen=True)
class OperatingPoint:
    batch: int
    tpot: float                    # seconds
    throughput: float              # tokens / s (cluster-wide)
    used_dbo: bool
    used_sd: bool
    exposed_comm: float            # seconds (under the schedule actually used)
    t_compute: float
    t_comm: float
    tp: int = 1                    # the (tp, pp, ep) mapping of the point
    ep: int = 0                    # resolved EP degree (1 for dense models)
    pp: int = 1                    # pipeline-parallel degree (layer stages)
    extra_experts: int = 0         # replica expert slots per rank (placement)

    @property
    def throughput_per_xpu(self):  # filled by caller via cluster.n_xpus
        raise AttributeError("use result.throughput / cluster.n_xpus")


@dataclass(frozen=True)
class PrefillOperatingPoint:
    """Operating point of a prefill-aware serving mode.

    mode 'decode' is the seed's prefill-free search (ttft = 0.0 means "not
    modeled"); 'chunked' interleaves prefill chunks into decode iterations;
    'disagg' splits the cluster into prefill/decode pools. `throughput` is
    decode tokens/s cluster-wide, capped by the prefill/decode pipeline
    balance, so modes are directly comparable."""
    mode: str                  # "decode" | "chunked" | "disagg"
    batch: int                 # decode requests in flight
    tpot: float                # seconds (chunked: mixed-iteration average)
    ttft: float                # seconds (0.0 in decode mode)
    throughput: float          # decode tokens/s, cluster-wide
    chunk: int = 0             # chunked: chunk size; disagg: prompt tokens/pass
    n_prefill_xpus: int = 0    # disagg: prefill-pool device count
    n_decode_xpus: int = 0     # disagg: decode-pool device count
    tp: int = 1                # the (tp, pp, ep) mapping (disagg: the
    ep: int = 0                # DECODE pool's; each pool resolves its own)
    pp: int = 1
    tp_prefill: int = 0        # disagg: the prefill pool's own mapping
    pp_prefill: int = 0        # (0 outside disagg mode)
    ep_prefill: int = 0
    used_dbo: bool = False     # searched with the (max,+) DBO schedule
    exposed_comm: float = 0.0  # TPOT-side comm not hidden under compute (s)
    t_compute: float = 0.0     # TPOT-side busy times under the schedule
    t_comm: float = 0.0        # actually used (chunked: load-weighted)


# ---------------------------------------------------------------------------
# single-iteration time
# ---------------------------------------------------------------------------

def _timers(cluster: Cluster, p: ServingPoint):
    fp8 = p.dtype == "fp8"
    rows = p.batch_per_device * p.q_len

    def t_comp(op: Op) -> float:
        return cm.compute_time(op, cluster.xpu, rows=rows, fp8=fp8)

    def t_comm(op: Op) -> float:
        if op.kind == "a2a":
            return cluster.a2a_time(op.m_bytes, group=op.group or None,
                                    tp=p.tp, pp=p.pp)
        if op.kind == "pp_sendrecv":
            return cluster.pp_hop_time(op.m_bytes, pp=p.pp, tp=p.tp)
        return cluster.ar_time(op.m_bytes, group=op.group or None, tp=p.tp,
                               pp=p.pp)

    return t_comp, t_comm


def _scaled_timers(cfg: ModelConfig, cluster: Cluster, p: ServingPoint):
    """`_timers` with the pipeline bottleneck factor applied: per-layer
    ops (`workload.is_per_layer_op`) repeat `workload.stage_imbalance`
    times per steady-state round on the largest stage; the lm head and pp
    hops ride the round once. Identity at pp=1 — the timers are returned
    unwrapped, keeping the seed path byte-identical."""
    t_comp, t_comm = _timers(cluster, p)
    if p.pp <= 1:
        return t_comp, t_comm
    imb = workload.stage_imbalance(cfg.num_layers, p.pp)

    def scaled(f):
        def g(op: Op) -> float:
            return f(op) * (imb if workload.is_per_layer_op(op.name)
                            else 1.0)
        return g

    return scaled(t_comp), scaled(t_comm)


def iteration_time(cfg: ModelConfig, p: ServingPoint, cluster: Cluster,
                   *, dbo: bool) -> tuple[float, float, float, float]:
    """One decode iteration -> (t_iter, exposed_comm, t_compute, t_comm).

    dbo=True: the batch splits into two microbatches of B/2; TPOT is the
    three-lane fixed-order (max,+) schedule's makespan (paper section 3.3;
    pp hops ride the dedicated send/recv lane — see `repro_torch.core.overlap`).
    """
    if not dbo:
        ops = workload.decode_iteration(cfg, p)
        t_comp, t_comm = _scaled_timers(cfg, cluster, p)
        tc = sum(t_comp(o) for o in ops if o.kind == "compute")
        tm = sum(t_comm(o) for o in ops if o.kind != "compute")
        return tc + tm, tm, tc, tm

    half = replace(p, batch_global=max(p.batch_global // 2, 1))
    ops_half = workload.decode_iteration(cfg, half)
    t_comp, t_comm = _scaled_timers(cfg, cluster, half)
    makespan, exposed = overlap.dbo_tpot(ops_half, t_comp, t_comm)
    tc = 2 * sum(t_comp(o) for o in ops_half if o.kind == "compute")
    tm = 2 * sum(t_comm(o) for o in ops_half if o.kind != "compute")
    return makespan, exposed, tc, tm


def _best_decode_iter(cfg: ModelConfig, p: ServingPoint, cluster: Cluster,
                      dbo: bool) -> tuple[float, float, float, float]:
    """best-of(no-overlap, DBO) decode iteration — "DBO on" means the
    schedule is USED only where it helps (paper Fig. 11a); DBO needs two
    microbatches, so batch 1 stays no-overlap."""
    res = iteration_time(cfg, p, cluster, dbo=False)
    if dbo and p.batch_global >= 2:
        res_dbo = iteration_time(cfg, p, cluster, dbo=True)
        if res_dbo[0] < res[0]:
            return res_dbo
    return res


def prefill_iteration_time(cfg: ModelConfig, p: ServingPoint,
                           cluster: Cluster,
                           chunk: int) -> tuple[float, float, float]:
    """One prefill iteration (`chunk` tokens after `p.context` cached) ->
    (t_iter, t_compute, t_comm), no-overlap. The thin-GEMM efficiency
    cutoff sees rows = batch_per_device * chunk, mirroring the decode
    timers at q_len = chunk."""
    ops = workload.prefill_iteration(cfg, p, chunk)
    t_comp, t_comm = _scaled_timers(cfg, cluster, replace(p, q_len=chunk))
    tc = sum(t_comp(o) for o in ops if o.kind == "compute")
    tm = sum(t_comm(o) for o in ops if o.kind != "compute")
    return tc + tm, tc, tm


def prefill_iteration_dbo(cfg: ModelConfig, p: ServingPoint,
                          cluster: Cluster,
                          chunk: int) -> overlap.ScheduleResult:
    """DBO'd prefill chunk: the chunk splits CAUSALLY into a leading
    ceil(chunk/2)-token and a trailing floor(chunk/2)-token microbatch
    (the trailing one starts `h1` tokens deeper into the KV cache), and
    the two run the three-lane (max,+) schedule — the leading half's
    A2A/AR hides under the trailing half's big GEMMs, pp hops under both.

    The causal split is EXACT: the two halves' attention-core flops sum to
    the full chunk's (h1*(h1+1)/2 + h2*(h2+1)/2 + h1*h2 = s*(s+1)/2), so
    DBO re-schedules the same work rather than dropping any.
    """
    if chunk < 2:
        raise ValueError(f"DBO needs two microbatches; chunk={chunk} < 2")
    h2 = chunk // 2
    h1 = chunk - h2
    ops_a = workload.prefill_iteration(cfg, p, h1)
    ops_b = workload.prefill_iteration(
        cfg, replace(p, context=p.context + h1), h2)
    ca, ma = _scaled_timers(cfg, cluster, replace(p, q_len=h1))
    cb, mb = _scaled_timers(cfg, cluster, replace(p, q_len=h2))
    return overlap.dbo_best(overlap.to_timed(ops_a, ca, ma, 0),
                            overlap.to_timed(ops_b, cb, mb, 1))


def prefill_chunk_components(cfg: ModelConfig, p: ServingPoint,
                             cluster: Cluster, chunk: int, *,
                             dbo: bool = False
                             ) -> tuple[float, float, float, float]:
    """(t_iter, exposed_comm, t_compute, t_comm) of one prefill chunk under
    the schedule actually used: best-of(no-overlap, three-lane DBO) when
    `dbo`, mirroring `_best_decode_iter`. Single-token chunks cannot split
    into two microbatches and stay no-overlap."""
    t, tc, tm = prefill_iteration_time(cfg, p, cluster, chunk)
    if dbo and chunk >= 2:
        res = prefill_iteration_dbo(cfg, p, cluster, chunk)
        if res.makespan < t:
            return (res.makespan, res.exposed_comm, res.compute_busy,
                    res.comm_busy + res.sendrecv_busy)
    return t, tm, tc, tm


def chunked_prefill_components(cfg: ModelConfig, p: ServingPoint,
                               cluster: Cluster, scenario: Scenario,
                               chunk: int, *, dbo: bool = False
                               ) -> tuple[float, float, float, float, float]:
    """(TPOT, TTFT, exposed_comm, t_compute, t_comm) of the chunked-prefill
    model at decode batch B = `p.batch_global` (Sarathi-style: chunks
    piggyback on decode iterations, one chunk per DP-attention domain per
    carrying iteration).

    Each decode slot turns over every `gen_len` iterations and its
    replacement prompt needs `n_chunks` chunk-iterations on one of the
    `domains` DP lanes, so the fraction of iterations that carry a chunk is

        phi = B_eff * n_chunks / (gen_len * domains)        (phi <= 1;
        B_eff = min(B, domains * gen_len / n_chunks) is the
        pipeline-balanced decode batch — beyond it prefill cannot refill
        the batch and slots idle)

    TPOT is the load-weighted average iteration, t_dec + phi * mean_j
    t_chunk_j; TTFT is the sum over the prompt's chunk schedule of the
    iterations it rides, sum_j (t_dec + t_chunk_j) — those iterations DO
    carry its chunks back to back. `dbo` times BOTH parts with the
    three-lane (max,+) schedule where it helps: the decode iteration
    splits into two B/2 microbatches, each chunk into two causal
    half-chunks (`prefill_iteration_dbo` — the chunk's A2A/AR hides under
    the other half's big GEMMs). exposed/compute/comm components carry the
    same load weighting as TPOT.
    """
    t_dec, e_dec, tc_dec, tm_dec = _best_decode_iter(cfg, p, cluster, dbo)
    sizes, offsets = workload.chunk_schedule(scenario.prompt_len, chunk)
    p_ch = replace(p, batch_global=max(p.n // p.tp, 1))  # one chunk / domain
    parts = [prefill_chunk_components(cfg, replace(p_ch, context=off),
                                      cluster, s, dbo=dbo)
             for s, off in zip(sizes, offsets)]
    m = len(parts)
    domains = max(p.n // p.tp, 1)
    g = scenario.gen_len
    b_eff = min(float(p.batch_global), domains * g / m)
    phi = b_eff * m / (g * domains)
    s_pre = sum(t for t, _, _, _ in parts)
    tpot = t_dec + phi * (s_pre / m)
    ttft = m * t_dec + s_pre
    exposed = e_dec + phi * (sum(e for _, e, _, _ in parts) / m)
    tc = tc_dec + phi * (sum(c for _, _, c, _ in parts) / m)
    tm = tm_dec + phi * (sum(t for _, _, _, t in parts) / m)
    return tpot, ttft, exposed, tc, tm


def chunked_prefill_tpot(cfg: ModelConfig, p: ServingPoint, cluster: Cluster,
                         scenario: Scenario, chunk: int, *,
                         dbo: bool = False) -> tuple[float, float]:
    """(TPOT, TTFT) of the chunked-prefill model — see
    `chunked_prefill_components` for the derivation; this is the scalar
    reference the batched `sweep.batched_chunked_tpot_ttft` is locked
    against at 1e-9 relative (with and without DBO)."""
    return chunked_prefill_components(cfg, p, cluster, scenario, chunk,
                                      dbo=dbo)[:2]


def tpot_at(cfg: ModelConfig, p: ServingPoint, cluster: Cluster, *,
            dbo: bool, sd: Optional[SpecDecConfig]) -> tuple[float, float, float, float]:
    """(TPOT, exposed_comm, t_compute, t_comm) for one operating point.

    DBO on means "best of DBO and no-overlap" (paper Fig. 11a). SD wraps
    draft + verify iterations.
    """
    def best_iter(q_len: int):
        return _best_decode_iter(cfg, replace(p, q_len=q_len), cluster, dbo)

    if sd is None:
        return best_iter(1)

    t_draft, e1, c1, m1 = best_iter(1)
    t_verify, e2, c2, m2 = best_iter(sd.spec_m)
    denom = sd.tokens_per_iteration
    return ((t_draft + t_verify) / denom, (e1 + e2) / denom,
            (c1 + c2) / denom, (m1 + m2) / denom)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def _batch_grid(b_max: int, ep: int) -> List[int]:
    """Geometric grid from ep to b_max (finer near the top end)."""
    if b_max < 1:
        return []
    grid = set()
    b = max(ep, 1)
    while b <= b_max:
        grid.add(b)
        b *= 2
    # refine: 3/4 points between octaves near the top two octaves
    for base in sorted(grid)[-3:]:
        for frac in (1.25, 1.5, 1.75):
            v = int(base * frac)
            if v <= b_max:
                grid.add(v)
    grid.add(b_max)
    return sorted(grid)


def max_throughput(cluster: Cluster, cfg: ModelConfig, scenario: Scenario,
                   *, dbo: bool = False, sd: Optional[SpecDecConfig] = None,
                   tp: Union[int, str] = 1, pp: Union[int, str] = 1,
                   ep: Optional[int] = None,
                   dtype: str = "fp8",
                   backend: Optional[str] = None,
                   placement: Optional[str] = None
                   ) -> Optional[OperatingPoint]:
    """DEPRECATED shim for `repro_torch.core.api.solve` (emits
    `ReproDeprecationWarning`; byte-identical result).

    Best operating point under the TPOT SLO, or None if the SLO is
    unreachable at every feasible batch size. tp="auto" / pp="auto" search
    the joint (tp, pp, ep = n/(tp*pp)) mapping axes; placement="auto"
    additionally searches expert replication for skewed scenarios. See
    `api.SearchSpec` for the field semantics and `api.solve_grid` for the
    amortized clusters x scenarios form.
    """
    from repro_torch.core import api
    api.warn_deprecated("optimizer.max_throughput", "repro_torch.core.api.solve")
    return api.solve(cfg, cluster, scenario,
                     api.SearchSpec(tp=tp, pp=pp, ep=ep, dbo=dbo, sd=sd,
                                    dtype=dtype, backend=backend,
                                    placement=placement)).point


def max_throughput_scalar(cluster: Cluster, cfg: ModelConfig,
                          scenario: Scenario, *, dbo: bool = False,
                          sd: Optional[SpecDecConfig] = None, tp: int = 1,
                          pp: int = 1, ep: Optional[int] = None,
                          dtype: str = "fp8",
                          extra_slots: int = 0) -> Optional[OperatingPoint]:
    """Reference scalar sweep (the seed implementation, one `tpot_at` call
    per grid point). Kept as the ground truth the batched engine is tested
    against, and as the fallback when a batched TPOT lands exactly on the
    SLO boundary.

    Skewed scenarios thread their per-layer hot-rank load factors
    (`placement.point_factors`) into every ServingPoint; `extra_slots`
    fixes the replica count of one placement-search arm (the batched
    search's knife-edge fallback passes the arm it is finalizing)."""
    from repro_torch.core import placement
    n = cluster.n_xpus
    if cfg.moe is not None:
        ep = ep or max(n // (tp * pp), 1)
    else:
        ep = 1
        extra_slots = 0
    tpot_budget = scenario.tpot_ms * 1e-3

    p0 = ServingPoint(batch_global=1, context=scenario.context, tp=tp, ep=ep,
                      n_devices=n, dtype=dtype, pp=pp,
                      moe_load=placement.point_factors(cfg, scenario, ep,
                                                       extra_slots),
                      moe_extra=extra_slots)
    # reject scenarios where ONE request's prompt + decode context cannot
    # be held at all (degenerate empty grids otherwise); batch sizing
    # keeps the seed convention of KV at the average context
    p_mem = replace(p0, context=getattr(scenario, "mem_context",
                                        scenario.context))
    if not workload.single_request_fits(cfg, p_mem, cluster.xpu.hbm_cap):
        return None
    b_max = workload.max_batch_by_memory(cfg, p0, cluster.xpu.hbm_cap)
    best: Optional[OperatingPoint] = None
    for b in _batch_grid(b_max, max(n // tp, 1)):
        p = replace(p0, batch_global=b)
        tpot, ect, tc, tm = tpot_at(cfg, p, cluster, dbo=dbo, sd=sd)
        if tpot > tpot_budget:
            continue
        thr = b / tpot
        if best is None or thr > best.throughput:
            best = OperatingPoint(batch=b, tpot=tpot, throughput=thr,
                                  used_dbo=dbo, used_sd=sd is not None,
                                  exposed_comm=ect, t_compute=tc, t_comm=tm,
                                  tp=tp, ep=ep, pp=pp,
                                  extra_experts=extra_slots)
    return best


def best_of_opts(cluster: Cluster, cfg: ModelConfig, scenario: Scenario,
                 opts: str = "dbo+sd", **kw) -> Optional[OperatingPoint]:
    """DEPRECATED shim for `repro_torch.core.api.solve` with `opts` set (emits
    `ReproDeprecationWarning`; byte-identical result).

    opts: 'noopt' | 'dbo' | 'dbo+sd'. DBO/SD results fall back to the
    unoptimized point when that is faster (paper's 'best of' curves)."""
    from repro_torch.core import api
    api.warn_deprecated("optimizer.best_of_opts", "repro_torch.core.api.solve")
    return api.solve(cfg, cluster, scenario,
                     api.SearchSpec(opts=opts, **kw)).point


def max_throughput_prefill(cluster: Cluster, cfg: ModelConfig,
                           scenario: Scenario, mode: str = "chunked",
                           **kw) -> Optional[PrefillOperatingPoint]:
    """DEPRECATED shim for `repro_torch.core.api.solve` with `mode` set (emits
    `ReproDeprecationWarning`; byte-identical result).

    Prefill-aware best operating point under BOTH the TPOT and TTFT SLOs.
    mode: 'decode' (seed behavior, prefill unmodeled) | 'chunked' (prefill
    chunks interleaved into decode iterations) | 'disagg' (cluster split
    into prefill/decode pools, split ratio swept)."""
    from repro_torch.core import api
    api.warn_deprecated("optimizer.max_throughput_prefill",
                        "repro_torch.core.api.solve")
    for seq in ("chunk_grid", "split_fracs"):
        if seq in kw:
            kw[seq] = tuple(kw[seq])
    return api.solve(cfg, cluster, scenario,
                     api.SearchSpec(mode=mode, **kw)).prefill_point


# ---------------------------------------------------------------------------
# degraded-fabric serving policy (remap vs. degrade)
# ---------------------------------------------------------------------------

# Default re-shard downtime: re-sharding to a new (tp, pp, ep) mapping
# reloads every device's weight shard and drains in-flight requests.
# Pulling ~10-20 GB/device over a shared frontend at tens of GB/s plus
# drain/warmup lands in the tens-of-seconds-to-minutes band reported for
# production reconfigurations; 120 s is the conservative default, and the
# policy exposes it as a knob (docs/failure_model.md).
REMAP_DOWNTIME_S = 120.0
# Horizon the remap downtime amortizes over: the expected time the cluster
# serves in the new degraded state before the failed component repairs
# (~ MTTR of the cheap components; availability.py carries per-class MTTRs).
DEGRADED_HORIZON_S = 4 * 3600.0


@dataclass(frozen=True)
class DegradedPlan:
    """Outcome of the remap-vs-degrade decision for one fault state.

    action 'keep'  — serve the pre-fault (tp, pp, ep) mapping on the
                     survivor cluster at a smaller batch (no downtime);
           'remap' — pay `remap_downtime_s` of zero service to re-shard
                     into the best degraded mapping;
           'down'  — no feasible operating point survives the faults.
    `effective_throughput` is tokens/s averaged over `horizon_s`
    (downtime amortized in), the quantity the policy maximizes."""
    action: str
    point: Optional[OperatingPoint]
    keep_point: Optional[OperatingPoint]
    remap_point: Optional[OperatingPoint]
    remap_downtime_s: float
    horizon_s: float
    effective_throughput: float


def degrade_policy(cluster: Cluster, cfg: ModelConfig, scenario: Scenario,
                   faults, *, baseline: Optional[OperatingPoint] = None,
                   remap_downtime_s: float = REMAP_DOWNTIME_S,
                   horizon_s: float = DEGRADED_HORIZON_S,
                   tp: Union[int, str] = "auto", pp: Union[int, str] = 1,
                   dtype: str = "fp8", dbo: bool = False,
                   sd: Optional[SpecDecConfig] = None) -> DegradedPlan:
    """Graceful-degradation decision on a fault: keep the current mapping
    and serve a smaller batch under the same SLO, or pay a re-shard
    downtime for the better degraded operating point.

    `baseline` is the pre-fault operating point whose mapping the 'keep'
    arm preserves (computed fresh via the healthy search when omitted).
    The 'remap' arm re-runs the full (tp, pp, ep) search on the survivor
    cluster (`sweep.degraded_max_throughput`) and is charged
    `remap_downtime_s` of lost service amortized over `horizon_s` —
    the repair-time-scale the degraded state persists for."""
    from repro_torch.core import sweep

    if baseline is None:
        baseline = sweep.sweep_max_throughput([cluster], cfg, [scenario],
                                              dbo=dbo, sd=sd, tp=tp, pp=pp,
                                              dtype=dtype)[0][0]
    keep_pt = None
    if baseline is not None:
        keep_pt = sweep.degraded_max_throughput(
            cluster, cfg, scenario, faults=faults, dtype=dtype, dbo=dbo,
            sd=sd, mapping=(baseline.tp, baseline.pp, baseline.ep))
    remap_pt = sweep.degraded_max_throughput(
        cluster, cfg, scenario, faults=faults, tp=tp, pp=pp, dtype=dtype,
        dbo=dbo, sd=sd)
    keep_thr = keep_pt.throughput if keep_pt is not None else 0.0
    remap_eff = 0.0
    if remap_pt is not None:
        remap_eff = remap_pt.throughput * max(
            1.0 - remap_downtime_s / max(horizon_s, 1e-9), 0.0)
    if keep_pt is None and remap_pt is None:
        return DegradedPlan("down", None, None, None, remap_downtime_s,
                            horizon_s, 0.0)
    # ties keep the no-downtime arm — remapping is never free
    if keep_thr >= remap_eff:
        return DegradedPlan("keep", keep_pt, keep_pt, remap_pt,
                            remap_downtime_s, horizon_s, keep_thr)
    return DegradedPlan("remap", remap_pt, keep_pt, remap_pt,
                        remap_downtime_s, horizon_s, remap_eff)


def best_of_opts_scalar(cluster: Cluster, cfg: ModelConfig,
                        scenario: Scenario, opts: str = "dbo+sd",
                        **kw) -> Optional[OperatingPoint]:
    """Reference scalar counterpart of `best_of_opts` (seed semantics)."""
    candidates = [max_throughput_scalar(cluster, cfg, scenario, dbo=False,
                                        sd=None, **kw)]
    if opts in ("dbo", "dbo+sd"):
        candidates.append(
            max_throughput_scalar(cluster, cfg, scenario, dbo=True, sd=None,
                                  **kw))
    if opts == "dbo+sd":
        sd = SpecDecConfig()
        candidates.append(
            max_throughput_scalar(cluster, cfg, scenario, dbo=True, sd=sd,
                                  **kw))
        candidates.append(
            max_throughput_scalar(cluster, cfg, scenario, dbo=False, sd=sd,
                                  **kw))
    candidates = [c for c in candidates if c is not None]
    if not candidates:
        return None
    return max(candidates, key=lambda c: c.throughput)
