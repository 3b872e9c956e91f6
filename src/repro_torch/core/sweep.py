"""Batched sweep engine: the operating-point search as array programs.

The optimizer's search space is a batch-grid x {dbo, sd} x scenario x
topology cross-product; the seed implementation walked it one scalar Python
evaluation at a time, rebuilding the decode op list at every point. This
module evaluates the whole grid with NumPy broadcasts over a precomputed
`optable.OpTable`:

  compute times   roofline closed forms over (batch, q_len, context), with
                  the thin-GEMM efficiency switch applied elementwise
  alpha-beta comm each cluster's collective-algorithm menu lowered to
                  (A, B) pairs so t = min_alg(A + B * m) broadcasts over the
                  payload grid
  DBO             the three-lane fixed-order schedule (compute / comm /
                  pp send-recv) is a (max,+) recurrence in the op order
                  (see overlap.simulate_lanes), so it vectorizes exactly
                  over the grid: same max/add operations, batched over
                  trailing axes — for decode iterations, prefill chunks,
                  and the disaggregated whole-prompt pass alike

`batched_tpot` matches the scalar `optimizer.tpot_at` to float rounding
(~1e-15 relative; asserted at 1e-9 in tests/test_sweep.py). Selection
(feasibility + argmax) runs on the batched values; the single winning point
is then re-evaluated through the exact scalar path so the returned
`OperatingPoint` is byte-identical to the seed implementation.

Backends: every entry point takes `backend="numpy" | "torch"` (default
"torch", changed only through `set_default_backend`; no environment
variable is read, so a stale shell setting cannot move the card's work
onto NumPy). "numpy" is THE reference — 1e-9-vs-scalar, the yardstick the
torch backend is held to. "torch" delegates the two heavy primitives
(no-overlap duration sums and the DBO makespan) and the uniform prefill
chunk times to `core/sweep_torch.py`'s `TorchGridEngine`, in float64 on
the device that `set_default_device` names: the card ("cuda", the
default) unless the caller asks for "cpu". That device resolves through
`repro_torch.resolve_device`, so asking for the card on a machine without
one raises; the torch backend never falls back to NumPy or to the CPU.
Selection and the scalar re-derivation of each argmax winner are shared
NumPy code, so both backends return bit-identical `OperatingPoint`s
whenever their argmax agrees. The two places that stay NumPy under
"torch", as in the reference: the skewed prefill schedules
(`_prefill_chunk_times` with a `load`) and the disaggregated whole-prompt
pass.

Hybrid parallelism (tp="auto" / pp="auto"): the search grows a joint
(tp, pp, ep = n/(tp*pp)) mapping axis. `parallelism_candidates` enumerates
the valid mappings (head/expert divisibility, device- and layer-count
constraints on (tp, pp), weight-shard feasibility with the per-stage shard
divided by tp*pp), each candidate runs the same batched engine against its
own op table with the collectives PLACED by the topology
(`Cluster.comm_spec`: AR(tp) over the scale-up / mesh neighborhood, expert
A2A over the stage's quotient, pp hops on the stage-boundary link), and
each (cluster, scenario) cell keeps the highest-throughput mapping — ties
to the smallest (tp, pp) lexicographically, so fixed-mapping (tp=1, pp=1)
results are byte-identical to the seed.

Expert-load skew (`Scenario(routing="zipf", ...)`, see `core.placement`):
tables stay UNIFORM — skew enters as per-op constant multipliers
(`op_load_factors`: lf scales the row-linear flops/bytes/payload of the
expert GEMM and A2As per scenario, cf scales the expert weight stream
under replication) applied inside `GridEval._durations`, so no new table
cache keys and no new probe points. `load=None` (every scenario uniform,
no replicas) skips the factor path entirely — structural byte-identity,
not a numerical coincidence. placement="auto" wraps the fixed-mapping
search in a replica-count loop (`_placement_candidates`) merged R=0-first
through the same strict-> `_merge_best`, so the placement search can
never lose to no-placement and uniform scenarios keep the R=0 arm.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import optable, placement, sweep_torch, workload
from repro_torch.core.compute_model import (EFF_MEMORY, GEMM_SMALL_TOKENS,
                                      T_LAUNCH)
from repro_torch.core.optable import OpTable
from repro_torch.core.overlap import LANES, MAX_STAGGER
from repro_torch.core.specdec import SpecDecConfig
from repro_torch.core.topology import Cluster
from repro_torch.core.workload import ServingPoint


# ---------------------------------------------------------------------------
# backend seam
# ---------------------------------------------------------------------------

BACKENDS = ("numpy", "torch")
_DEFAULT_BACKEND = "torch"
_DEFAULT_DEVICE = "cuda"


def set_default_backend(backend: str) -> str:
    """Set the process-wide default backend ("numpy" | "torch"); returns the
    previous default. Explicit `backend=` arguments always win over this."""
    global _DEFAULT_BACKEND
    if backend not in BACKENDS:
        raise ValueError(f"unknown sweep backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    prev, _DEFAULT_BACKEND = _DEFAULT_BACKEND, backend
    return prev


def set_default_device(device) -> str:
    """Set the device the torch backend evaluates its grids on ("cuda" or
    "cpu"); returns the previous one. It is checked when a grid is built,
    through `repro_torch.resolve_device`."""
    global _DEFAULT_DEVICE
    prev, _DEFAULT_DEVICE = _DEFAULT_DEVICE, str(device)
    return prev


def _resolve_backend(backend: Optional[str]) -> str:
    b = backend if backend is not None else _DEFAULT_BACKEND
    if b not in BACKENDS:
        raise ValueError(f"unknown sweep backend {b!r}; "
                         f"expected one of {BACKENDS}")
    if b == "torch":
        resolve_device(_DEFAULT_DEVICE)
    return b


# ---------------------------------------------------------------------------
# per-cluster alpha-beta lowering
# ---------------------------------------------------------------------------

_KIND_NAMES = {optable.KIND_A2A: "a2a", optable.KIND_AR: "ar",
               optable.KIND_PP: "pp_sendrecv"}


def _comm_menu_coeffs(cluster: Cluster, kind: int, group: int,
                      tp: int = 1, pp: int = 1) -> List[Tuple[float, float]]:
    """Lower one collective menu to (A, B) pairs: t(m) = min_alg(A + B*m).

    A carries the alpha terms exactly as `AlphaBeta.time` associates them;
    B*m keeps the scalar's (m_coeff * m) * beta association elementwise, so
    the batched time equals the scalar time to the rounding of the shared
    subexpressions. The menu, bandwidth, and alpha set come from the
    cluster's `comm_spec` placement under the (tp, pp, ep) mapping —
    identical to the seed whole-cluster lowering at tp=1, pp=1.
    """
    menu, bw, ab = cluster.comm_spec(_KIND_NAMES[kind], group, tp, pp)
    beta = 1.0 / (ab.link_utilization * bw)
    return [(ab.alpha0 + c.rounds * ab.alpha_r + c.dests * ab.alpha_d,
             c.m_coeff, beta) for c in menu.values()]


def _comm_times(table: OpTable, cluster: Cluster,
                m: np.ndarray) -> np.ndarray:
    """Comm time per op, shape of `m` (n_ops, ...); 0 for compute ops."""
    out = np.zeros_like(m)
    for kind in (optable.KIND_A2A, optable.KIND_AR, optable.KIND_PP):
        for group in np.unique(table.group[table.kind == kind]):
            sel = (table.kind == kind) & (table.group == group)
            if not sel.any():
                continue
            algs = _comm_menu_coeffs(cluster, kind, int(group), table.tp,
                                     table.pp)
            best = None
            for a, m_coeff, beta in algs:
                t = a + (m_coeff * m[sel]) * beta
                best = t if best is None else np.minimum(best, t)
            out[sel] = best
    return out


# ---------------------------------------------------------------------------
# vectorized (max,+) lane schedule
# ---------------------------------------------------------------------------

def _lane_makespan(lanes: np.ndarray, dur_a: np.ndarray,
                   dur_b: np.ndarray) -> np.ndarray:
    """Best-stagger makespan of the fixed-order three-lane schedule, exact
    vectorization of `overlap.dbo_best` with arbitrary trailing grid axes.

    `lanes` is the (n_ops,) int lane column (overlap.LANES indices);
    `dur_a` / `dur_b` are the two microbatches' per-op duration tensors,
    (n_ops, ...). They may differ — DBO'd prefill chunks split causally
    into unequal half-chunks — but must share the op structure (same lane
    per index), which every caller guarantees by construction.
    """
    n = dur_a.shape[0]
    tail = dur_a.shape[1:]
    dur = (dur_a, dur_b)
    best = None
    for s in range(0, min(MAX_STAGGER, max(n - 1, 0)) + 1):
        order = sorted(((k, mb) for mb in (0, 1) for k in range(n)),
                       key=lambda km: (km[0] + (s if km[1] else 0),
                                       km[1]))
        ready = [np.zeros(tail), np.zeros(tail)]
        free = [np.zeros(tail) for _ in LANES]
        for k, mb in order:
            lane = int(lanes[k])
            end = np.maximum(ready[mb], free[lane]) + dur[mb][k]
            ready[mb] = end
            free[lane] = end
        mk = np.maximum(ready[0], ready[1])
        best = mk if best is None else np.minimum(best, mk)
    return best if best is not None else np.zeros(tail)


# ---------------------------------------------------------------------------
# expert-skew load factors
# ---------------------------------------------------------------------------

def op_load_factors(table, cfg: ModelConfig, scenarios: Sequence,
                    extra_slots: int = 0
                    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Per-op skew multipliers for one grid, or None on the uniform path.

    Returns (lf, cf): lf (n_ops, n_scenarios) multiplies the row-linear
    flops / bytes / payload coefficients of the skew-scaled MoE ops
    (`workload.SKEW_SCALED_OPS`, located via the table's `moe_layer`
    column) with the scenario's per-MoE-layer hot-rank load factor
    (`placement.layer_load_factors`); cf (n_ops,) multiplies bytes_const
    — the expert weight stream — with the replica hosting factor
    (`placement.hosting_factor`). Both are exactly 1 everywhere else.
    None (every scenario uniform, no replicas, or no sharded experts)
    selects `GridEval`'s untouched seed arithmetic — byte-identity is
    structural, not numerical. Works on decode and prefill tables alike.
    """
    skewed = [bool(getattr(sc, "is_skewed", False)) for sc in scenarios]
    if cfg.moe is None or (not any(skewed) and not extra_slots):
        return None
    ml = np.asarray(table.moe_layer)
    sel = ml >= 0
    lf = np.ones((table.n_ops, len(scenarios)))
    if sel.any():
        for si, sc in enumerate(scenarios):
            if not skewed[si]:
                continue
            fac = np.asarray(placement.layer_load_factors(
                cfg, sc, table.ep, extra_slots))
            lf[sel, si] = fac[ml[sel]]
    cf = np.ones(table.n_ops)
    if extra_slots:
        host = np.array([nm.rsplit(".", 1)[-1] == "expert_ffn"
                         for nm in table.names])
        cf[host] = placement.hosting_factor(cfg, table.ep, extra_slots)
    if not extra_slots and np.all(lf == 1.0):
        return None            # e.g. ep=1: skew cannot create imbalance
    return lf, cf


# ---------------------------------------------------------------------------
# grid evaluation context
# ---------------------------------------------------------------------------

class GridEval:
    """Shared evaluation state for one (table, clusters, scenarios, batches)
    grid. Duration tensors and DBO makespans are cached per (q_len, half)
    so the dbo / dbo+sd / sd variants of one sweep reuse each other's work.

    backend="torch" swaps the two heavy primitives (`seq_components`,
    `dbo_makespan`) for `sweep_torch.TorchGridEngine`, on the device of
    `set_default_device`; everything downstream of those arrays
    (best_iteration, tpot, selection) is shared NumPy code. backend=None
    takes the module default (see `set_default_backend`).

    `load` carries the expert-skew multipliers from `op_load_factors`
    (None on the uniform path, which then runs the seed arithmetic
    unchanged — byte-identity is structural).

    All result arrays have shape (n_clusters, n_scenarios, n_batches).
    """

    def __init__(self, table: OpTable, clusters: Sequence[Cluster],
                 scenarios: Sequence, batches: np.ndarray,
                 backend: Optional[str] = None,
                 load: Optional[Tuple[np.ndarray, np.ndarray]] = None):
        self.table = table
        self.clusters = list(clusters)
        self.scenarios = list(scenarios)
        self.batches = np.asarray(batches, np.int64)
        self.half = np.maximum(self.batches // 2, 1)
        self.backend = _resolve_backend(backend)
        self.load = load
        self._engine = None
        self._dur: Dict = {}
        self._mk: Dict = {}
        self._seq: Dict = {}

    def _torch_engine(self):
        if self._engine is None:
            self._engine = sweep_torch.TorchGridEngine(
                self.table, self.clusters, self.scenarios, self.batches,
                self.half, load=self.load, device=_DEFAULT_DEVICE)
        return self._engine

    # ------------- durations -------------
    def _durations(self, q: int, half: bool):
        """(comp, comm) duration tensors, (n_ops, n_cl, n_sc, n_b); entries
        are zero off their own lane, exactly like the scalar timers."""
        key = (q, half)
        if key in self._dur:
            return self._dur[key]
        t = self.table
        b_arr = self.half if half else self.batches
        rows = t.rows(b_arr, q)                        # (n_b,)
        ctx = np.array([sc.context for sc in self.scenarios],
                       float)[:, None]                 # (n_sc, 1)
        is_comp = t.is_compute[:, None, None, None]

        # compute roofline (cluster axis only matters if XPUs differ)
        flops_base = t.flop_row[:, None] * rows
        flops_ctx = t.flop_row_ctx[:, None] * rows
        byts_ctx = t.bytes_ctx[:, None] * t.batch_per_device(b_arr)
        if self.load is None:
            byts_base = t.bytes_const[:, None] + t.bytes_row[:, None] * rows
            flops_sc = flops_base[:, None, :] + flops_ctx[:, None, :] * ctx
            byts_sc = byts_base[:, None, :] + byts_ctx[:, None, :] * ctx
        else:
            # expert-skew path: lf (n_ops, n_sc) scales the row-linear
            # terms per scenario (exact — affected ops have zero ctx
            # coefficients), cf (n_ops,) scales the expert weight stream
            lf3 = self.load[0][:, :, None]
            flops_sc = (flops_base[:, None, :] * lf3
                        + flops_ctx[:, None, :] * ctx)
            byts_sc = ((t.bytes_const * self.load[1])[:, None, None]
                       + (t.bytes_row[:, None] * rows)[:, None, :] * lf3
                       + byts_ctx[:, None, :] * ctx)

        fp8 = t.dtype == "fp8"
        eff = np.where(rows < GEMM_SMALL_TOKENS,
                       t.eff_small[:, None], t.eff[:, None])[:, None, :]
        comp_by_xpu: Dict[int, np.ndarray] = {}
        comp = np.zeros((t.n_ops, len(self.clusters)) + flops_sc.shape[1:])
        for ci, cl in enumerate(self.clusters):
            xk = id(cl.xpu)
            if xk not in comp_by_xpu:
                peak = cl.xpu.flops_fp8 if fp8 else cl.xpu.flops_bf16
                t_c = flops_sc / (peak * eff)
                t_m = byts_sc / (cl.xpu.hbm_bw * EFF_MEMORY)
                comp_by_xpu[xk] = np.maximum(t_c, t_m) + T_LAUNCH
            comp[:, ci] = comp_by_xpu[xk]
        comp = np.where(is_comp, comp, 0.0)

        m = t.m_bytes(b_arr, q)                        # (n_ops, n_b)
        comm = np.zeros_like(comp)
        if self.load is None:
            for ci, cl in enumerate(self.clusters):
                comm[:, ci] = _comm_times(t, cl, m)[:, None, :]
        else:
            # hot-rank A2A payload: the collective finishes when its
            # hottest rank does, so the beta term scales by lf per
            # scenario (alpha unchanged — _comm_times broadcasts over
            # the trailing (n_sc, n_b) axes)
            m_sc = m[:, None, :] * self.load[0][:, :, None]
            for ci, cl in enumerate(self.clusters):
                comm[:, ci] = _comm_times(t, cl, m_sc)
        comm = np.where(is_comp, 0.0, comm)

        # pipeline bottleneck: the largest stage's layer ops repeat
        # stage_imbalance times per round (all-ones at pp=1 and pp | L, so
        # the multiply is an exact identity on the seed path)
        scale = t.stage_scale[:, None, None, None]
        self._dur[key] = (comp * scale, comm * scale)
        return self._dur[key]

    # ------------- no-overlap iteration -------------
    def seq_components(self, q: int, half: bool = False):
        """(t_iter, t_compute, t_comm), each (n_cl, n_sc, n_b) — the
        dbo=False path of optimizer.iteration_time."""
        key = (q, half)
        if key not in self._seq:
            if self.backend == "torch":
                tc, tm = self._torch_engine().seq_components(q, half)
            else:
                comp, comm = self._durations(q, half)
                tc = comp.sum(axis=0)
                tm = comm.sum(axis=0)
            self._seq[key] = (tc + tm, tc, tm)
        return self._seq[key]

    # ------------- DBO three-lane schedule -------------
    def dbo_makespan(self, q: int) -> np.ndarray:
        """Best-stagger three-lane makespan at HALF batch, (n_cl,n_sc,n_b).

        Exact vectorization of overlap.dbo_tpot: with a fixed per-lane
        order, every start time is max(end of the microbatch's previous op,
        end of the lane's previous op) — a (max,+) recurrence evaluated here
        in merged order with the batch grid as trailing axes. The lane
        column (`OpTable.lane`) routes collectives to the comm lane and
        `pp_sendrecv` hops to the dedicated send/recv lane, so pipeline
        hops overlap BOTH compute and collectives; at pp = 1 the third
        lane is empty and the schedule is the original two-lane one.
        """
        if q in self._mk:
            return self._mk[q]
        if self.backend == "torch":
            self._mk[q] = self._torch_engine().dbo_makespan(q)
            return self._mk[q]
        comp, comm = self._durations(q, half=True)
        dur = comp + comm                      # disjoint supports
        self._mk[q] = _lane_makespan(self.table.lane, dur, dur)
        return self._mk[q]

    # ------------- TPOT -------------
    def best_iteration(self, q: int, dbo: bool) -> np.ndarray:
        """min(no-overlap, DBO) per grid point — optimizer's best_iter."""
        t_seq, _, _ = self.seq_components(q)
        if not dbo:
            return t_seq
        mk = self.dbo_makespan(q)
        return np.where(self.batches >= 2, np.minimum(t_seq, mk), t_seq)

    def tpot(self, *, dbo: bool = False,
             sd: Optional[SpecDecConfig] = None) -> np.ndarray:
        """TPOT seconds over the grid — batched optimizer.tpot_at."""
        t1 = self.best_iteration(1, dbo)
        if sd is None:
            return t1
        tv = self.best_iteration(sd.spec_m, dbo)
        return (t1 + tv) / sd.tokens_per_iteration


def batched_tpot(op_table: OpTable, clusters: Sequence[Cluster],
                 batches: np.ndarray, scenarios: Sequence, *,
                 dbo: bool = False,
                 sd: Optional[SpecDecConfig] = None,
                 backend: Optional[str] = None) -> np.ndarray:
    """TPOT for every (cluster, scenario, batch) grid point in one shot.

    Returns shape (n_clusters, n_scenarios, n_batches); matches the scalar
    `optimizer.tpot_at` within float-rounding (tested at 1e-9 relative on
    the numpy backend, 1e-6 on torch).
    All clusters must share the op table's device count.
    """
    return GridEval(op_table, clusters, scenarios, batches,
                    backend=backend).tpot(dbo=dbo, sd=sd)


def batched_iteration_components(op_table: OpTable,
                                 clusters: Sequence[Cluster],
                                 batches: np.ndarray, context: int,
                                 q_len: int = 1):
    """No-overlap (t_iter, t_compute, t_comm), each (n_cl, n_b) — the
    batched optimizer.iteration_time(dbo=False) for one context."""
    from repro_torch.core.optimizer import Scenario

    ev = GridEval(op_table, clusters, [Scenario(0.0, context)], batches)
    t, tc, tm = ev.seq_components(q_len)
    return t[:, 0, :], tc[:, 0, :], tm[:, 0, :]


# ---------------------------------------------------------------------------
# grid search: max throughput under SLO, batched over clusters x scenarios
# ---------------------------------------------------------------------------

def parallelism_candidates(cfg: ModelConfig, cluster: Cluster, *,
                           dtype: str = "fp8",
                           pp: Union[int, str] = 1,
                           strict_experts: bool = True
                           ) -> List[Tuple[int, int, int]]:
    """All valid (tp, pp, ep) hybrid mappings of `cfg` on `cluster`,
    (tp, pp) lexicographically ascending (so exact throughput ties resolve
    to the fixed mapping, then to the shallower pipeline).

    A tp is valid when it divides the device count AND the attention heads
    shard evenly (num_kv_heads for GQA, num_heads for MLA; head-free
    mixers only need the device-count divisibility). pp (all valid stage
    counts when pp="auto", the requested degree otherwise) is capped by
    the layer count — every stage owns at least one layer — and tp*pp must
    divide the device count. ep = n/(tp*pp) must divide the expert count
    (MoE) and the resulting per-stage weight shard (dense / (tp*pp),
    experts / (ep*tp*pp), largest stage of the balanced partition — see
    `workload.model_shard_bytes`) must leave room on the device
    (per-scenario KV feasibility is checked by the batch grids, exactly as
    for the fixed mapping). strict_experts=False drops the expert-count
    divisibility requirement (experts pad to the EP group, `workload` uses
    max(E//ep, 1)) — the convention the disaggregated prefill pools
    inherited from the fixed-mapping search."""
    n = cluster.n_xpus
    if cfg.attn_kind == "mla":
        heads = cfg.num_heads
    elif cfg.has_attention:
        heads = cfg.num_kv_heads
    else:
        heads = 0
    pp_opts = (range(1, min(n, cfg.num_layers) + 1) if pp == "auto"
               else (int(pp),))
    out: List[Tuple[int, int, int]] = []
    for tp in range(1, n + 1):
        if n % tp:
            continue
        if heads and (tp > heads or heads % tp):
            continue
        for q in pp_opts:
            if q < 1 or q > cfg.num_layers or n % (tp * q):
                continue
            if cfg.moe is not None:
                ep = n // (tp * q)
                if strict_experts and cfg.moe.num_experts % ep:
                    continue
            else:
                ep = 1
            shard = workload.model_shard_bytes(cfg, tp, ep, dtype, q)
            if shard >= cluster.xpu.hbm_cap * (1 - workload.KV_RESERVE_FRAC):
                continue
            out.append((tp, q, ep))
    return out


def _resolve_parallelism(cfg: ModelConfig, n: int, tp: int, pp: int,
                         ep: Optional[int]) -> int:
    """Resolved EP degree of one FIXED mapping: ep defaults to n/(tp*pp)
    for MoE models (the hybrid family; n at the paper's tp=1, pp=1), 1 for
    dense."""
    if cfg.moe is not None:
        return ep or max(n // (tp * pp), 1)
    return 1


def _merge_best(grids: Sequence[List[List]]) -> List[List]:
    """Elementwise argmax-throughput across per-mapping [cluster][scenario]
    grids; exact ties keep the EARLIEST grid (candidates are ordered tp
    ascending, so the fixed mapping wins draws)."""
    out = []
    for ci in range(len(grids[0])):
        row = []
        for si in range(len(grids[0][ci])):
            best = None
            for g in grids:
                cand = g[ci][si]
                if cand is None:
                    continue
                if best is None or cand.throughput > best.throughput:
                    best = cand
            row.append(best)
        out.append(row)
    return out


def _auto_candidates(clusters: Sequence[Cluster], cfg: ModelConfig,
                     dtype: str, tp: Union[int, str] = "auto",
                     pp: Union[int, str] = 1
                     ) -> List[Tuple[int, int, int]]:
    """Union of each cluster's valid mappings (clusters share a device
    count but may differ in XPU, so a mapping one cluster's HBM prunes can
    still be another's best — the per-cluster batch grids reject it where
    the shard genuinely does not fit). A fixed value on either axis
    restricts the enumeration to it."""
    cands = sorted({c for cl in clusters
                    for c in parallelism_candidates(cfg, cl, dtype=dtype,
                                                    pp=pp)})
    if tp != "auto":
        cands = [c for c in cands if c[0] == tp]
    if not cands:
        raise ValueError(
            f"no feasible (tp, pp, ep) mapping for {cfg.name!r} on "
            f"{clusters[0].n_xpus} XPUs under (tp={tp!r}, pp={pp!r}) — "
            "model shard exceeds HBM at every searched degree")
    return cands


def _prepare_grid(clusters, cfg, scenarios, tp, pp, ep_r, dtype,
                  extra_slots=0):
    """Per-(cluster, scenario) seed batch grids + their sorted union.
    extra_slots > 0 charges the replica weights against HBM (shrinking
    the grids) via `ServingPoint.moe_extra`."""
    from repro_torch.core.optimizer import _batch_grid
    n = clusters[0].n_xpus
    grids = {}
    union = set()
    for ci, cl in enumerate(clusters):
        for si, sc in enumerate(scenarios):
            # reject scenarios where ONE request's prompt + decode context
            # cannot be held at all (empty grid, not a degenerate batch-0
            # point); batch sizing keeps the seed convention of KV at the
            # average context
            mem_ctx = getattr(sc, "mem_context", sc.context)
            p0 = ServingPoint(batch_global=1, context=sc.context, tp=tp,
                              ep=ep_r, n_devices=n, dtype=dtype, pp=pp,
                              moe_extra=extra_slots)
            p_mem = ServingPoint(batch_global=1, context=mem_ctx, tp=tp,
                                 ep=ep_r, n_devices=n, dtype=dtype, pp=pp,
                                 moe_extra=extra_slots)
            if not workload.single_request_fits(cfg, p_mem, cl.xpu.hbm_cap):
                grids[ci, si] = []
                continue
            b_max = workload.max_batch_by_memory(cfg, p0, cl.xpu.hbm_cap)
            grids[ci, si] = _batch_grid(b_max, max(n // tp, 1))
            union.update(grids[ci, si])
    batches = np.array(sorted(union), np.int64)
    return grids, batches


def _select_and_finalize(ev: GridEval, grids, cfg, *, dbo, sd, tp, pp,
                         ep_r, dtype, extra_slots=0):
    """Feasibility + argmax on the batched TPOTs, then re-evaluate the
    winner through the exact scalar path (byte-identical OperatingPoint).
    extra_slots tags the replica-count arm of the placement search so the
    scalar re-derivation (and knife-edge fallback) prices the same skew."""
    from repro_torch.core import optimizer

    tpot = ev.tpot(dbo=dbo, sd=sd)
    index = {int(b): i for i, b in enumerate(ev.batches)}
    n = ev.clusters[0].n_xpus
    out: List[List[Optional[optimizer.OperatingPoint]]] = []
    for ci, cl in enumerate(ev.clusters):
        row = []
        for si, sc in enumerate(ev.scenarios):
            budget = sc.tpot_ms * 1e-3
            best_b, best_thr = None, 0.0
            knife_edge = False
            for b in grids[ci, si]:
                t = float(tpot[ci, si, index[b]])
                if t > budget:
                    # batched and scalar TPOT agree within 1e-9 relative
                    # (the bound tests/test_sweep.py asserts); a rejection
                    # inside that band could flip under scalar rounding, so
                    # the whole cell defers to the exact search
                    knife_edge = knife_edge or t <= budget * (1 + 1e-9)
                    continue
                thr = b / t
                if best_b is None or thr > best_thr:
                    best_b, best_thr = b, thr
            if knife_edge:
                row.append(optimizer.max_throughput_scalar(
                    cl, cfg, ev.scenarios[si], dbo=dbo, sd=sd, tp=tp, pp=pp,
                    ep=ep_r, dtype=dtype, extra_slots=extra_slots))
                continue
            if best_b is None:
                row.append(None)
                continue
            p = ServingPoint(batch_global=best_b, context=sc.context, tp=tp,
                             ep=ep_r, n_devices=n, dtype=dtype, pp=pp,
                             moe_load=placement.point_factors(
                                 cfg, sc, ep_r, extra_slots),
                             moe_extra=extra_slots)
            tpot_s, ect, tc, tm = optimizer.tpot_at(cfg, p, cl, dbo=dbo,
                                                    sd=sd)
            if tpot_s > budget:
                # the batched value sat exactly on the SLO boundary and the
                # scalar rounding disagrees — defer to the exact search
                row.append(optimizer.max_throughput_scalar(
                    cl, cfg, sc, dbo=dbo, sd=sd, tp=tp, pp=pp, ep=ep_r,
                    dtype=dtype, extra_slots=extra_slots))
                continue
            row.append(optimizer.OperatingPoint(
                batch=best_b, tpot=tpot_s, throughput=best_b / tpot_s,
                used_dbo=dbo, used_sd=sd is not None, exposed_comm=ect,
                t_compute=tc, t_comm=tm, tp=tp, ep=ep_r, pp=pp,
                extra_experts=extra_slots))
        out.append(row)
    return out


def _sweep_fixed(clusters, cfg, scenarios, *, dbo, sd, tp, pp, ep_r,
                 dtype, backend=None, extra_slots=0):
    """One FIXED-mapping batched search (the pre-hybrid sweep body).
    Skewed scenarios are priced automatically (`op_load_factors` is
    always consulted), so every caller — degraded re-search included —
    honors the routing axis without its own plumbing."""
    n = clusters[0].n_xpus
    grids, batches = _prepare_grid(clusters, cfg, scenarios, tp, pp, ep_r,
                                   dtype, extra_slots=extra_slots)
    if batches.size == 0:
        return [[None] * len(scenarios) for _ in clusters]
    table = optable.op_table(cfg, tp, ep_r, n, dtype, pp=pp)
    load = op_load_factors(table, cfg, scenarios, extra_slots)
    ev = GridEval(table, clusters, scenarios, batches, backend=backend,
                  load=load)
    return _select_and_finalize(ev, grids, cfg, dbo=dbo, sd=sd, tp=tp, pp=pp,
                                ep_r=ep_r, dtype=dtype,
                                extra_slots=extra_slots)


def _check_placement(placement_mode) -> None:
    if placement_mode not in (None, "auto"):
        raise ValueError(f"unknown placement {placement_mode!r}; "
                         "expected None or 'auto'")


def _placement_candidates(clusters, cfg, scenarios, tp, pp, ep_r,
                          dtype) -> List[int]:
    """Replica-slot candidates R of the placement search: 0 plus powers of
    two, pruned to counts whose weight shard + replicas still fit at least
    one cluster's HBM (the per-arm batch grids do the exact per-cluster
    rejection) and capped at E - E/ep (every expert everywhere). [0] when
    there is nothing to search: dense model, unsharded experts, or no
    skewed scenario."""
    if (cfg.moe is None or ep_r <= 1
            or not any(getattr(sc, "is_skewed", False) for sc in scenarios)):
        return [0]
    cap = cfg.moe.num_experts - max(cfg.moe.num_experts // ep_r, 1)
    out = [0]
    r = 1
    while r <= cap:
        if any(workload.model_shard_bytes(cfg, tp, ep_r, dtype, pp, r)
               < cl.xpu.hbm_cap * (1 - workload.KV_RESERVE_FRAC)
               for cl in clusters):
            out.append(r)
        r *= 2
    return out


def _sweep_mapping(clusters, cfg, scenarios, *, dbo, sd, tp, pp, ep_r,
                   dtype, backend=None, placement_mode=None, extra_slots=0):
    """`_sweep_fixed`, optionally wrapped in the replication/placement
    search: placement_mode="auto" runs one fixed-mapping search per
    replica count and merges the arms R=0-FIRST through `_merge_best`'s
    strict argmax — so auto placement can never lose to no-placement, and
    uniform scenarios (whose extra replicas only add weight traffic) keep
    the byte-identical R=0 result."""
    _check_placement(placement_mode)
    if placement_mode == "auto":
        if extra_slots:
            raise ValueError("pass either placement='auto' or a fixed "
                             "extra_slots, not both")
        rs = _placement_candidates(clusters, cfg, scenarios, tp, pp, ep_r,
                                   dtype)
    else:
        rs = [extra_slots]
    if len(rs) == 1:
        return _sweep_fixed(clusters, cfg, scenarios, dbo=dbo, sd=sd, tp=tp,
                            pp=pp, ep_r=ep_r, dtype=dtype, backend=backend,
                            extra_slots=rs[0])
    return _merge_best([
        _sweep_fixed(clusters, cfg, scenarios, dbo=dbo, sd=sd, tp=tp, pp=pp,
                     ep_r=ep_r, dtype=dtype, backend=backend, extra_slots=r)
        for r in rs])


def sweep_max_throughput(clusters: Sequence[Cluster], cfg: ModelConfig,
                         scenarios: Sequence, *, dbo: bool = False,
                         sd: Optional[SpecDecConfig] = None,
                         tp: Union[int, str] = 1,
                         pp: Union[int, str] = 1,
                         ep: Optional[int] = None, dtype: str = "fp8",
                         backend: Optional[str] = None,
                         placement: Optional[str] = None
                         ) -> List[List[Optional["OperatingPoint"]]]:
    """Batched optimizer.max_throughput over clusters x scenarios.

    Clusters must share a device count (they may differ in topology, link
    bandwidth, and alpha sets). Returns [cluster][scenario] OperatingPoints
    (None where the SLO is unreachable), byte-identical to the scalar path.

    tp="auto" / pp="auto" sweep the joint (tp, pp, ep = n/(tp*pp)) axes
    (either one alone holds the other fixed): every mapping from
    `parallelism_candidates` runs the same batched search (its own op
    table, batch grids, and topology-placed collectives) and each
    (cluster, scenario) cell keeps the highest-throughput mapping, ties to
    the smallest (tp, pp). The chosen mapping is recorded on the point's
    `tp` / `pp` / `ep` fields.

    placement="auto" additionally searches expert replica counts for
    skewed scenarios (`_placement_candidates`; chosen count on the
    point's `extra_experts`) — a no-op, byte-identical to placement=None,
    when every scenario routes uniformly.
    """
    n = clusters[0].n_xpus
    if any(cl.n_xpus != n for cl in clusters):
        raise ValueError("sweep_max_throughput requires a uniform device "
                         "count; group clusters by n_xpus")
    _check_placement(placement)
    if tp == "auto" or pp == "auto":
        if ep is not None:
            raise ValueError("auto mapping search resolves ep = n/(tp*pp) "
                             "per candidate; pass ep=None")
        return _merge_best([
            _sweep_mapping(clusters, cfg, scenarios, dbo=dbo, sd=sd, tp=t,
                           pp=q, ep_r=e, dtype=dtype, backend=backend,
                           placement_mode=placement)
            for t, q, e in _auto_candidates(clusters, cfg, dtype, tp, pp)])
    ep_r = _resolve_parallelism(cfg, n, tp, pp, ep)
    return _sweep_mapping(clusters, cfg, scenarios, dbo=dbo, sd=sd, tp=tp,
                          pp=pp, ep_r=ep_r, dtype=dtype, backend=backend,
                          placement_mode=placement)


def _variants_for(opts: str) -> List[Tuple[bool, Optional[SpecDecConfig]]]:
    """The (dbo, sd) candidates of one opts level, in seed's tie-break
    order (best_of_opts keeps the FIRST candidate on equal throughput)."""
    variants: List[Tuple[bool, Optional[SpecDecConfig]]] = [(False, None)]
    if opts in ("dbo", "dbo+sd"):
        variants.append((True, None))
    if opts == "dbo+sd":
        sd = SpecDecConfig()
        variants += [(True, sd), (False, sd)]
    return variants


def best_of_opts_multi(clusters: Sequence[Cluster], cfg: ModelConfig,
                       scenarios: Sequence,
                       opts_levels: Sequence[str] = ("noopt", "dbo",
                                                     "dbo+sd"), *,
                       tp: Union[int, str] = 1, pp: Union[int, str] = 1,
                       ep: Optional[int] = None,
                       dtype: str = "fp8",
                       backend: Optional[str] = None,
                       placement: Optional[str] = None,
                       extra_slots: int = 0
                       ) -> Dict[str, List[List[Optional["OperatingPoint"]]]]:
    """Batched optimizer.best_of_opts for SEVERAL opts levels at once.

    One GridEval and one result per (dbo, sd) variant are shared across the
    levels ('dbo+sd' already evaluates everything 'noopt' and 'dbo' need),
    so e.g. fig11's three curves cost one engine pass, not three.
    tp="auto" / pp="auto" additionally sweep the (tp, pp, ep = n/(tp*pp))
    mapping axes per level (one engine pass per candidate mapping), and
    placement="auto" the expert replica counts (one engine pass per
    count, merged R=0-first so it never loses to placement=None).
    """
    n = clusters[0].n_xpus
    if any(cl.n_xpus != n for cl in clusters):
        raise ValueError("best_of_opts_multi requires a uniform device "
                         "count")
    _check_placement(placement)
    if tp == "auto" or pp == "auto":
        if ep is not None:
            raise ValueError("auto mapping search resolves ep = n/(tp*pp) "
                             "per candidate; pass ep=None")
        per_cand = [best_of_opts_multi(clusters, cfg, scenarios, opts_levels,
                                       tp=t, pp=q, ep=e, dtype=dtype,
                                       backend=backend, placement=placement,
                                       extra_slots=extra_slots)
                    for t, q, e in _auto_candidates(clusters, cfg, dtype,
                                                    tp, pp)]
        return {opts: _merge_best([pc[opts] for pc in per_cand])
                for opts in opts_levels}
    ep_r = _resolve_parallelism(cfg, n, tp, pp, ep)
    if placement == "auto":
        if extra_slots:
            raise ValueError("pass either placement='auto' or a fixed "
                             "extra_slots, not both")
        rs = _placement_candidates(clusters, cfg, scenarios, tp, pp, ep_r,
                                   dtype)
        if len(rs) > 1:
            per_r = [best_of_opts_multi(clusters, cfg, scenarios,
                                        opts_levels, tp=tp, pp=pp, ep=ep,
                                        dtype=dtype, backend=backend,
                                        extra_slots=r)
                     for r in rs]
            return {opts: _merge_best([pr[opts] for pr in per_r])
                    for opts in opts_levels}
    grids, batches = _prepare_grid(clusters, cfg, scenarios, tp, pp, ep_r,
                                   dtype, extra_slots=extra_slots)
    if batches.size == 0:
        empty = [[None] * len(scenarios) for _ in clusters]
        return {opts: [list(row) for row in empty] for opts in opts_levels}
    table = optable.op_table(cfg, tp, ep_r, n, dtype, pp=pp)
    load = op_load_factors(table, cfg, scenarios, extra_slots)
    ev = GridEval(table, clusters, scenarios, batches, backend=backend,
                  load=load)

    by_variant: Dict[Tuple, List[List[Optional["OperatingPoint"]]]] = {}
    out = {}
    for opts in opts_levels:
        per_variant = []
        for d, s in _variants_for(opts):
            key = (d, s)
            if key not in by_variant:
                by_variant[key] = _select_and_finalize(
                    ev, grids, cfg, dbo=d, sd=s, tp=tp, pp=pp, ep_r=ep_r,
                    dtype=dtype, extra_slots=extra_slots)
            per_variant.append(by_variant[key])
        level = []
        for ci in range(len(clusters)):
            row = []
            for si in range(len(scenarios)):
                best = None
                for cand in (v[ci][si] for v in per_variant):
                    if cand is None:
                        continue
                    if best is None or cand.throughput > best.throughput:
                        best = cand
                row.append(best)
            level.append(row)
        out[opts] = level
    return out


def best_of_opts_grid(clusters: Sequence[Cluster], cfg: ModelConfig,
                      scenarios: Sequence, opts: str = "dbo+sd", *,
                      tp: Union[int, str] = 1, pp: Union[int, str] = 1,
                      ep: Optional[int] = None,
                      dtype: str = "fp8",
                      backend: Optional[str] = None,
                      placement: Optional[str] = None
                      ) -> List[List[Optional["OperatingPoint"]]]:
    """Batched optimizer.best_of_opts over clusters x scenarios."""
    return best_of_opts_multi(clusters, cfg, scenarios, [opts], tp=tp,
                              pp=pp, ep=ep, dtype=dtype,
                              backend=backend, placement=placement)[opts]


# ---------------------------------------------------------------------------
# prefill-aware operating-point search
# ---------------------------------------------------------------------------

# chunk sizes tried by the chunked-prefill search (clipped to the prompt)
CHUNK_GRID = (128, 256, 512, 1024, 2048)
# prefill-pool fractions tried by the disaggregated-prefill search
SPLIT_FRACS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75)


def _prefill_load(ptable: "optable.PrefillOpTable", cfg: ModelConfig,
                  scenario) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Single-scenario (lf, cf) column vectors for a prefill table, or
    None for the uniform fast path — `op_load_factors` specialised to the
    per-schedule prefill evaluators (no scenario axis, no replication:
    prefill chunks run on the unreplicated shard)."""
    out = op_load_factors(ptable, cfg, [scenario], 0)
    if out is None:
        return None
    lf, cf = out
    return lf[:, 0], cf


def _skew_sig(scenario) -> Optional[Tuple[float, int]]:
    """Cache-key component distinguishing skewed scenarios that share a
    prompt length (None for uniform, keeping seed keys unchanged)."""
    if not getattr(scenario, "is_skewed", False):
        return None
    return (float(scenario.zipf_s), int(scenario.routing_seed))


def _prefill_chunk_durations(ptable: "optable.PrefillOpTable",
                             cluster: Cluster, batch_global: int,
                             sizes: np.ndarray, offsets: np.ndarray,
                             load: Optional[Tuple[np.ndarray,
                                                  np.ndarray]] = None
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """(comp, comm) per-op per-chunk duration rows of one chunk schedule,
    each (n_ops, n_chunks) with zeros off their own lane — the prefill
    counterpart of `GridEval._durations` (stage scale applied), built from
    the table's chunk-polynomial closed forms. `load` (from
    `_prefill_load`) prices expert skew; None is the untouched seed
    arithmetic."""
    s = np.asarray(sizes, float)
    o = np.asarray(offsets, float)
    rows = ptable.rows(batch_global, s)                    # (n_chunks,)
    if load is None:
        flops = ptable.flops(batch_global, s, o)           # (n_ops, n_chunks)
        byts = ptable.op_bytes(batch_global, s, o)
        m = ptable.m_bytes(batch_global, s)
    else:
        lfv, cfv = load
        # exact for the skew-scaled ops: their ctx / chunk coefficients
        # are zero (expert flops and A2A payload are row-linear), so
        # scaling the closed-form total equals scaling the row term
        flops = ptable.flops(batch_global, s, o) * lfv[:, None]
        byts = (ptable.bytes_const[:, None] * cfv[:, None]
                + (ptable.bytes_row[:, None] * rows) * lfv[:, None]
                + ptable.bytes_ctx[:, None]
                * (ptable.batch_per_device(batch_global) * o))
        m = ptable.m_bytes(batch_global, s) * lfv[:, None]

    fp8 = ptable.dtype == "fp8"
    peak = cluster.xpu.flops_fp8 if fp8 else cluster.xpu.flops_bf16
    eff = np.where(rows < GEMM_SMALL_TOKENS,
                   ptable.eff_small[:, None], ptable.eff[:, None])
    t_c = flops / (peak * eff)
    t_m = byts / (cluster.xpu.hbm_bw * EFF_MEMORY)
    comp = np.maximum(t_c, t_m) + T_LAUNCH
    is_comp = ptable.is_compute[:, None]
    scale = ptable.stage_scale[:, None]
    comp = np.where(is_comp, comp, 0.0) * scale
    comm = np.where(is_comp, 0.0, _comm_times(ptable, cluster, m)) * scale
    return comp, comm


def _prefill_chunk_times(ptable: "optable.PrefillOpTable", cluster: Cluster,
                         batch_global: int, sizes: Sequence[int],
                         offsets: Sequence[int], *,
                         dbo: bool = False,
                         backend: Optional[str] = None,
                         load: Optional[Tuple[np.ndarray,
                                              np.ndarray]] = None
                         ) -> np.ndarray:
    """Prefill-iteration time per chunk of one schedule, shape (n_chunks,)
    — the batched `optimizer.prefill_chunk_components` time. dbo=False is
    the no-overlap sum (`optimizer.prefill_iteration_time`); dbo=True takes
    best-of(no-overlap, three-lane DBO) per chunk, where each chunk splits
    CAUSALLY into a leading ceil- and trailing floor-half microbatch
    (`optimizer.prefill_iteration_dbo`); 1-token chunks stay no-overlap.
    Skewed schedules (`load` from `_prefill_load`) always run on the
    NumPy reference path, as in the reference — per-schedule prefill rows
    are too small to amortise a second device variant — and uniform
    scenarios (load=None, the byte-identity path) go to
    `sweep_torch.prefill_chunk_times` under backend="torch"."""
    if load is None and _resolve_backend(backend) == "torch":
        return sweep_torch.prefill_chunk_times(ptable, cluster, batch_global,
                                               sizes, offsets, dbo=dbo,
                                               device=_DEFAULT_DEVICE)
    comp, comm = _prefill_chunk_durations(ptable, cluster, batch_global,
                                          sizes, offsets, load)
    seq = comp.sum(axis=0) + comm.sum(axis=0)
    if not dbo:
        return seq
    s_arr = np.asarray(sizes, np.int64)
    o_arr = np.asarray(offsets, np.int64)
    h2 = s_arr // 2
    h1 = s_arr - h2
    comp_a, comm_a = _prefill_chunk_durations(ptable, cluster, batch_global,
                                              h1, o_arr, load)
    comp_b, comm_b = _prefill_chunk_durations(ptable, cluster, batch_global,
                                              h2, o_arr + h1, load)
    mk = _lane_makespan(ptable.lane, comp_a + comm_a, comp_b + comm_b)
    return np.where(s_arr >= 2, np.minimum(seq, mk), seq)


def _chunked_formulas(t_dec, s_pre, m: int, batches, gen_len: int,
                      domains: int):
    """(tpot, ttft, b_eff) of the load-weighted chunked-prefill model —
    the ONE place the batched search evaluates it (see
    `optimizer.chunked_prefill_tpot` for the derivation and the scalar
    reference the 1e-9 equivalence test locks this against). Broadcasts
    over any (t_dec, batches) shapes."""
    b_eff = np.minimum(np.asarray(batches, float), domains * gen_len / m)
    phi = b_eff * m / (gen_len * domains)
    tpot = t_dec + phi * (s_pre / m)
    ttft = m * t_dec + s_pre
    return tpot, ttft, b_eff


def batched_chunked_tpot_ttft(op_table: OpTable,
                              ptable: "optable.PrefillOpTable",
                              clusters: Sequence[Cluster],
                              batches: np.ndarray, scenario,
                              chunk: int, *, dbo: bool = False,
                              backend: Optional[str] = None,
                              cfg: Optional[ModelConfig] = None
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """(TPOT, TTFT) of the chunked-prefill model over a (cluster, batch)
    grid, each (n_clusters, n_batches) — the batched
    `optimizer.chunked_prefill_tpot` (matches it to 1e-9 relative, with
    and without the three-lane DBO schedule). Pass `cfg` to price a
    skewed scenario (without it the routing axis is ignored, the seed
    behavior)."""
    load = (op_load_factors(op_table, cfg, [scenario])
            if cfg is not None else None)
    ev = GridEval(op_table, clusters, [scenario], batches, backend=backend,
                  load=load)
    t_dec = ev.best_iteration(1, dbo)[:, 0, :]             # (n_cl, n_b)
    sizes, offsets = workload.chunk_schedule(scenario.prompt_len, chunk)
    # chunk-carrying DP lanes across all pipeline stages: n/(tp*pp) per
    # stage times pp microbatches in flight = n/tp, pp-invariant
    domains = max(op_table.n // op_table.tp, 1)
    p_load = (_prefill_load(ptable, cfg, scenario) if cfg is not None
              else None)
    s_pre = np.stack([_prefill_chunk_times(ptable, cl, domains, sizes,
                                           offsets, dbo=dbo,
                                           backend=backend,
                                           load=p_load).sum()
                      for cl in clusters])                 # (n_cl,)
    tpot, ttft, _ = _chunked_formulas(t_dec, s_pre[:, None], len(sizes),
                                      batches[None, :], scenario.gen_len,
                                      domains)
    return tpot, ttft


def _as_decode_point(op) -> Optional["optimizer.PrefillOperatingPoint"]:
    from repro_torch.core import optimizer
    if op is None:
        return None
    return optimizer.PrefillOperatingPoint(
        mode="decode", batch=op.batch, tpot=op.tpot, ttft=0.0,
        throughput=op.throughput, tp=op.tp, ep=op.ep, pp=op.pp,
        used_dbo=op.used_dbo, exposed_comm=op.exposed_comm,
        t_compute=op.t_compute, t_comm=op.t_comm)


def _chunk_candidates(prompt_len: int, chunk_grid: Sequence[int]) -> List[int]:
    return sorted({min(int(c), prompt_len) for c in chunk_grid if c >= 1})


def _sweep_chunked(clusters, cfg, scenarios, tp, pp, ep_r, dtype,
                   chunk_grid, dbo=False, backend=None):
    """Joint (batch, chunk) search of the chunked-prefill mode.

    For each (cluster, scenario): TPOT/TTFT over the batch grid x chunk
    candidates via the closed-form tables (see
    `optimizer.chunked_prefill_components` for the load-weighted iteration
    model). Throughput is B_eff / TPOT with B_eff = min(B, domains *
    gen_len / n_chunks) — past that batch the prefill lanes cannot refill
    the decode batch and slots idle. dbo=True times decode iterations and
    prefill chunks with the three-lane (max,+) schedule wherever it beats
    no-overlap (chunk A2A/AR hides under the half-chunks' big GEMMs).
    The winner is re-derived through the scalar path; knife-edge cells
    (batched feasibility within float rounding of the SLO) may return a
    point within 1e-9 of the budget.
    """
    from repro_torch.core import optimizer

    n = clusters[0].n_xpus
    table = optable.op_table(cfg, tp, ep_r, n, dtype, pp=pp)
    ptable = optable.prefill_op_table(cfg, tp, ep_r, n, dtype, pp=pp)
    grids, batches = _prepare_grid(clusters, cfg, scenarios, tp, pp, ep_r,
                                   dtype)
    if batches.size == 0:
        return [[None] * len(scenarios) for _ in clusters]
    load = op_load_factors(table, cfg, scenarios)
    ev = GridEval(table, clusters, scenarios, batches, backend=backend,
                  load=load)
    t_dec_all = ev.best_iteration(1, dbo)                  # (n_cl, n_sc, n_b)
    index = {int(b): i for i, b in enumerate(batches)}
    domains = max(n // tp, 1)
    pre_cache: Dict[Tuple, float] = {}

    def s_pre_of(ci, sc, c):
        """Summed per-chunk prefill time, cached per (cluster, prompt,
        chunk, skew signature) — scenarios sharing a prompt length (e.g.
        a TTFT sweep) reuse one DBO makespan evaluation."""
        key = (ci, sc.prompt_len, c, _skew_sig(sc))
        if key not in pre_cache:
            sizes, offsets = workload.chunk_schedule(sc.prompt_len, c)
            pre_cache[key] = float(_prefill_chunk_times(
                ptable, clusters[ci], domains, sizes, offsets,
                dbo=dbo, backend=backend,
                load=_prefill_load(ptable, cfg, sc)).sum())
        return pre_cache[key]

    out: List[List[Optional[optimizer.PrefillOperatingPoint]]] = []
    for ci, cl in enumerate(clusters):
        row = []
        for si, sc in enumerate(scenarios):
            budget = sc.tpot_ms * 1e-3
            ttft_budget = sc.ttft_ms * 1e-3 if sc.ttft_ms else float("inf")
            best = None                     # (thr, b, chunk, b_eff)
            for c in _chunk_candidates(sc.prompt_len, chunk_grid):
                m = len(workload.chunk_schedule(sc.prompt_len, c)[0])
                s_pre = s_pre_of(ci, sc, c)
                for b in grids[ci, si]:
                    t_dec = float(t_dec_all[ci, si, index[b]])
                    tpot, ttft, b_eff = (
                        float(v) for v in _chunked_formulas(
                            t_dec, s_pre, m, float(b), sc.gen_len, domains))
                    if tpot > budget or ttft > ttft_budget:
                        continue
                    thr = b_eff / tpot
                    if best is None or thr > best[0]:
                        best = (thr, b, c, b_eff)
            if best is None:
                row.append(None)
                continue
            _, b, c, b_eff = best
            p = ServingPoint(batch_global=b, context=sc.context, tp=tp,
                             ep=ep_r, n_devices=n, dtype=dtype, pp=pp,
                             moe_load=placement.point_factors(cfg, sc, ep_r))
            tpot_s, ttft_s, ect, tc, tm = optimizer.chunked_prefill_components(
                cfg, p, cl, sc, c, dbo=dbo)
            row.append(optimizer.PrefillOperatingPoint(
                mode="chunked", batch=b, tpot=tpot_s, ttft=ttft_s,
                throughput=b_eff / tpot_s, chunk=c, tp=tp, ep=ep_r, pp=pp,
                used_dbo=dbo, exposed_comm=ect, t_compute=tc, t_comm=tm))
        out.append(row)
    return out


def _subcluster(cl: Cluster, n_sub: int) -> Cluster:
    """A pool carved out of `cl`: same XPU, per-XPU link bandwidth and
    topology family, `n_sub` devices. Mesh fabrics re-factorize to the
    most-cubic dims via the fabric's `pool_dims` hook (dims-free fabrics
    return None)."""
    return Cluster(topology=cl.topology, n_xpus=n_sub, xpu=cl.xpu,
                   link_bw=cl.link_bw, dims=cl.fabric.pool_dims(n_sub))


def _split_candidates(n: int, tp: int, fracs: Sequence[float]) -> List[int]:
    """Prefill-pool sizes to try: tp-aligned, both pools >= tp devices."""
    cands = set()
    for f in fracs:
        n_p = max(int(round(n * f / tp)), 1) * tp
        if tp <= n_p <= n - tp:
            cands.add(n_p)
    return sorted(cands)


def _disagg_pool_candidates(clusters, cfg, n_pool, tp, pp, dtype):
    """(tp, pp, ep) mappings for an n_pool-device pool: enumerated (and
    HBM-pruned) over the pool's sub-clusters when an axis is "auto"; the
    single requested mapping otherwise — unpruned, matching the seed,
    whose per-scenario prompt-KV guard does the rejecting."""
    if tp == "auto" or pp == "auto":
        pools = [_subcluster(cl, n_pool) for cl in clusters]
        cands = sorted({c for cl in pools
                        for c in parallelism_candidates(
                            cfg, cl, dtype=dtype, pp=pp,
                            strict_experts=False)})
        return [c for c in cands if tp == "auto" or c[0] == tp]
    if n_pool % (tp * pp):
        return []
    ep = max(n_pool // (tp * pp), 1) if cfg.moe is not None else 1
    return [(tp, pp, ep)]


def _sweep_disagg(clusters, cfg, scenarios, tp, pp, dtype, split_fracs,
                  dbo=False, backend=None):
    """Disaggregated-prefill search: sweep the prefill/decode split ratio,
    each pool resolving its OWN (tp, pp, ep) mapping.

    The decode pool runs the ordinary decode-only search on its sub-cluster
    (EP spans the pool; tp="auto"/pp="auto" search the mapping axes within
    the pool); the prefill pool independently enumerates ITS candidate
    mappings — the pools need not share one (the prefill pass is
    latency-bound and wants large tp, decode is throughput-bound and wants
    small tp). The prefill pool runs whole-prompt prefill, one prompt per
    DP domain per pipeline slot. TTFT = prefill pass + KV-cache handoff to
    the decode pool (alpha-beta at the PREFILL POOL's latency regime —
    `cl_p._ab()`, so an intra-node-sized pool pays intra-node alphas —
    over one XPU's link at the cluster's bandwidth); throughput is the
    balanced pipeline rate min(decode tokens/s, prefill request rate *
    gen_len). dbo=True applies the three-lane (max,+) schedule to BOTH
    pools: the decode search overlaps its iterations, the whole-prompt
    pass splits into two causal half-prompt microbatches.
    """
    from repro_torch.core import optimizer

    n = clusters[0].n_xpus
    out: List[List[Optional[optimizer.PrefillOperatingPoint]]] = \
        [[None] * len(scenarios) for _ in clusters]
    # whole-prompt pass times, keyed (pool mapping, cluster, prompt):
    # scenarios sharing a prompt length (a TTFT sweep) reuse one pass —
    # and, under dbo, one (max,+) half-prompt makespan evaluation
    pass_cache: Dict[Tuple, float] = {}
    auto = tp == "auto" or pp == "auto"
    align = 1 if auto else tp * pp
    for n_p in _split_candidates(n, align, split_fracs):
        n_d = n - n_p
        pre_cands = _disagg_pool_candidates(clusters, cfg, n_p, tp, pp,
                                            dtype)
        if not pre_cands:
            continue            # dead split: skip the decode sweep too
        # clusters share n_xpus, so their decode pools share n_d: one
        # vectorized decode search covers ALL clusters x scenarios per split.
        # Pool mappings use the seed's padded-expert convention (ep need
        # not divide the expert count — pool sizes like 48 have no such
        # divisor), so the decode pool enumerates its own candidates
        # rather than going through the strict whole-cluster auto search.
        dec_pools = [_subcluster(cl, n_d) for cl in clusters]
        if auto:
            dec_cands = _disagg_pool_candidates(clusters, cfg, n_d, tp, pp,
                                                dtype)
            if not dec_cands:
                continue
            dec_grid = _merge_best([
                _sweep_fixed(dec_pools, cfg, scenarios, dbo=dbo, sd=None,
                             tp=t, pp=q, ep_r=e, dtype=dtype,
                             backend=backend)
                for t, q, e in dec_cands])
        else:
            dec_grid = sweep_max_throughput(dec_pools, cfg, scenarios,
                                            tp=tp, pp=pp, dtype=dtype,
                                            dbo=dbo, backend=backend)
        for tp_p, pp_p, ep_p in pre_cands:
            domains_p = max(n_p // tp_p, 1)   # prompts in flight (all stages)
            ptable = optable.prefill_op_table(cfg, tp_p, ep_p, n_p, dtype,
                                              pp=pp_p)
            for ci, cl in enumerate(clusters):
                cl_p = _subcluster(cl, n_p)
                ab = cl_p._ab()
                for si, sc in enumerate(scenarios):
                    dec = dec_grid[ci][si]
                    if dec is None:
                        continue
                    L = sc.prompt_len
                    p_pre = ServingPoint(batch_global=domains_p, context=L,
                                         tp=tp_p, ep=ep_p, n_devices=n_p,
                                         dtype=dtype, pp=pp_p)
                    # every domain must hold its in-flight prompts' KV
                    # beside the shard (one prompt per domain per stage;
                    # at pp=1 this is exactly the seed single-request fit)
                    if workload.max_batch_by_memory(
                            cfg, p_pre, cl.xpu.hbm_cap) < domains_p:
                        continue
                    ck = (n_p, tp_p, pp_p, ep_p, ci, L, _skew_sig(sc))
                    if ck not in pass_cache:
                        # the whole-prompt pass is a single-chunk scalar
                        # evaluation — no grid to amortize a device over —
                        # so it always runs on the reference path; disagg
                        # winners stay byte-identical under backend="torch"
                        # (the decode-pool grid above is the heavy part)
                        pass_cache[ck] = float(_prefill_chunk_times(
                            ptable, cl_p, domains_p, [L], [0], dbo=dbo,
                            backend="numpy",
                            load=_prefill_load(ptable, cfg, sc))[0])
                    t_p = pass_cache[ck]
                    # latency term via the fabric hook: base alpha0
                    # everywhere, plus the circuit re-match on the OCS
                    # fabric (the KV handoff is its one phase switch)
                    t_xfer = (cl_p.fabric.kv_handoff_alpha(cl_p)
                              + workload.kv_cache_bytes_per_request(cfg, L)
                              / (ab.link_utilization * cl.link_bw))
                    ttft = t_p + t_xfer
                    if sc.ttft_ms and ttft > sc.ttft_ms * 1e-3:
                        continue
                    lam_p = domains_p / t_p              # prompts / s
                    thr = min(dec.throughput, lam_p * sc.gen_len)
                    prev = out[ci][si]
                    if prev is None or thr > prev.throughput:
                        out[ci][si] = optimizer.PrefillOperatingPoint(
                            mode="disagg", batch=dec.batch, tpot=dec.tpot,
                            ttft=ttft, throughput=thr, chunk=L,
                            n_prefill_xpus=n_p, n_decode_xpus=n_d,
                            tp=dec.tp, ep=dec.ep, pp=dec.pp,
                            tp_prefill=tp_p, pp_prefill=pp_p,
                            ep_prefill=ep_p, used_dbo=dec.used_dbo,
                            exposed_comm=dec.exposed_comm,
                            t_compute=dec.t_compute, t_comm=dec.t_comm)
    return out


# ---------------------------------------------------------------------------
# failure-aware re-search (degraded-fabric serving)
# ---------------------------------------------------------------------------

def degraded_subcluster(cl: Cluster, faults) -> Optional[Cluster]:
    """`cl` shrunk to the fault set's survivor pool with the link/plane
    derates attached, or None when no XPU survives.

    XPU-count faults carve a survivor sub-cluster exactly like the
    disaggregated-prefill pools (`_subcluster` conventions: same XPU,
    per-XPU link bandwidth and topology family; meshes re-factorize to
    the most-cubic dims via the fabric's `pool_dims` hook). Link /
    switch-plane faults stay attached to the survivor fabric — the broken
    cables are still broken after the pool shrinks."""
    cl_f = cl.with_faults(faults)
    n_surv = cl_f.survivor_xpus()
    if n_surv < 1:
        return None
    if n_surv == cl.n_xpus:
        return cl_f
    return Cluster(topology=cl.topology, n_xpus=n_surv, xpu=cl.xpu,
                   link_bw=cl.link_bw, dims=cl.fabric.pool_dims(n_surv),
                   faults=faults)


def degraded_candidates(cfg: ModelConfig, cluster: Cluster, *,
                        dtype: str = "fp8",
                        tp: Union[int, str] = "auto",
                        pp: Union[int, str] = 1
                        ) -> List[Tuple[int, int, int]]:
    """(tp, pp, ep) mappings valid on a (possibly odd-sized) survivor
    cluster. Survivor counts like 63 or 56 rarely divide the expert count,
    so the enumeration uses the padded-expert convention the disaggregated
    pools established (strict_experts=False: experts pad to the EP
    group)."""
    cands = parallelism_candidates(cfg, cluster, dtype=dtype, pp=pp,
                                   strict_experts=False)
    if tp != "auto":
        cands = [c for c in cands if c[0] == tp]
    return cands


def degraded_max_throughput(cluster: Cluster, cfg: ModelConfig, scenario, *,
                            faults=None,
                            tp: Union[int, str] = "auto",
                            pp: Union[int, str] = 1,
                            dtype: str = "fp8", dbo: bool = False,
                            sd: Optional[SpecDecConfig] = None,
                            mapping: Optional[Tuple[int, int, int]] = None,
                            backend: Optional[str] = None):
    """Best operating point of `cluster` under `faults` (which may already
    be attached to the cluster): the failure-aware re-search.

    The cluster shrinks to the survivor sub-cluster (failed XPUs, and on
    scale-out whole NIC-less nodes, leave the pool; link and switch-plane
    faults derate the surviving fabric via `Cluster.comm_spec`) and the
    (tp, pp, ep) mapping search re-runs there with padded experts.

    mapping=(tp, pp, ep) restricts the search to ONE mapping — the
    "keep the pre-fault sharding, serve a smaller batch" arm of the
    remap-vs-degrade policy (`optimizer.degrade_policy`); ep is
    re-derived as survivors/(tp*pp), since EP is device-count-defined.
    Returns None when the SLO is unreachable (or the mapping infeasible)
    on the survivor cluster."""
    cl_d = degraded_subcluster(cluster, faults if faults is not None
                               else cluster.faults)
    if cl_d is None:
        return None
    n = cl_d.n_xpus
    if mapping is not None:
        t, q, _ = mapping
        if t * q > n or n % (t * q) or q > cfg.num_layers:
            return None
        cands = [(t, q, max(n // (t * q), 1) if cfg.moe is not None else 1)]
    else:
        cands = degraded_candidates(cfg, cl_d, dtype=dtype, tp=tp, pp=pp)
    grids = [_sweep_fixed([cl_d], cfg, [scenario], dbo=dbo, sd=sd, tp=t,
                          pp=q, ep_r=e, dtype=dtype, backend=backend)
             for t, q, e in cands]
    if not grids:
        return None
    return _merge_best(grids)[0][0]


def sweep_prefill(clusters: Sequence[Cluster], cfg: ModelConfig,
                  scenarios: Sequence, mode: str = "chunked", *,
                  tp: Union[int, str] = 1, pp: Union[int, str] = 1,
                  ep: Optional[int] = None,
                  dtype: str = "fp8",
                  dbo: bool = False,
                  chunk_grid: Sequence[int] = CHUNK_GRID,
                  split_fracs: Sequence[float] = SPLIT_FRACS,
                  backend: Optional[str] = None
                  ) -> List[List[Optional["PrefillOperatingPoint"]]]:
    """Prefill-aware operating-point search over clusters x scenarios.

    mode:
      'decode'   the seed's decode-only search (prefill free) wrapped as
                 PrefillOperatingPoints — the comparison baseline;
      'chunked'  prefill chunks interleaved into decode iterations (joint
                 batch x chunk-size search under TPOT and TTFT SLOs);
      'disagg'   cluster split into prefill/decode pools (split ratio
                 swept; throughput capped by the balanced pipeline rate).

    dbo=True times every mode with the three-lane (max,+) DBO schedule
    wherever it beats no-overlap: decode iterations split into two B/2
    microbatches, prefill chunks and the disagg whole-prompt pass into two
    causal half-chunks — A2A/AR hide under the other microbatch's GEMMs,
    pp hops under both lanes. dbo=False (the default) is the no-overlap
    timing, byte-identical to the pre-DBO search.

    All three modes accept tp="auto" / pp="auto": the (tp, pp, ep =
    n/(tp*pp)) mapping axes are searched per (cluster, scenario) cell
    alongside the mode's own grid (batch x chunk for chunked, split ratio
    for disagg), ties to the smallest (tp, pp). Disagg searches the
    mapping PER POOL — the prefill and decode pools need not agree.
    Prefill modes require `scenario.prompt_len >= 1`. Clusters must share
    a device count, as in `sweep_max_throughput`.
    """
    n = clusters[0].n_xpus
    if any(cl.n_xpus != n for cl in clusters):
        raise ValueError("sweep_prefill requires a uniform device count; "
                         "group clusters by n_xpus")
    if mode == "decode":
        grid = sweep_max_throughput(clusters, cfg, scenarios, tp=tp, pp=pp,
                                    ep=ep, dtype=dtype, dbo=dbo,
                                    backend=backend)
        return [[_as_decode_point(op) for op in row] for row in grid]
    if mode not in ("chunked", "disagg"):
        raise ValueError(f"unknown prefill mode {mode!r}; expected "
                         "'decode' | 'chunked' | 'disagg'")
    for sc in scenarios:
        if getattr(sc, "prompt_len", 0) < 1:
            raise ValueError(
                f"scenario {getattr(sc, 'name', sc)!r} has no prompt_len; "
                "prefill modes need Scenario(..., prompt_len=..., ttft_ms=...)")
        if sc.prompt_len >= sc.context:
            raise ValueError(
                f"scenario {sc.name!r}: context ({sc.context}) must exceed "
                f"prompt_len ({sc.prompt_len}) — context is the AVERAGE "
                "decode KV length, prompt_len + gen_len / 2")
    if mode == "disagg":
        if ep is not None:
            raise ValueError("disagg mode resolves EP per pool; pass "
                             "ep=None")
        return _sweep_disagg(clusters, cfg, scenarios, tp, pp, dtype,
                             split_fracs, dbo=dbo, backend=backend)
    if tp == "auto" or pp == "auto":
        if ep is not None:
            raise ValueError("auto mapping search resolves ep = n/(tp*pp) "
                             "per candidate; pass ep=None")
        return _merge_best([
            _sweep_chunked(clusters, cfg, scenarios, t, q, e, dtype,
                           chunk_grid, dbo=dbo, backend=backend)
            for t, q, e in _auto_candidates(clusters, cfg, dtype, tp, pp)])
    ep_r = _resolve_parallelism(cfg, n, tp, pp, ep)
    return _sweep_chunked(clusters, cfg, scenarios, tp, pp, ep_r, dtype,
                          chunk_grid, dbo=dbo, backend=backend)
