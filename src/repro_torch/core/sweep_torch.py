"""The product-grid engine of the cost model in PyTorch: the port of
``repro.core.sweep_jax``, in float64 on the card or on the CPU.

``sweep.GridEval(backend="jax")`` hands its two heavy primitives (the
no-overlap duration sums and the DBO makespan) to ``JaxGridEngine``;
``TorchGridEngine`` has its interface and adds ``tpot``, the arithmetic of
``GridEval.best_iteration`` and ``GridEval.tpot``, so that a user of the
port gets a TPOT grid without the NumPy search. One op table and a list of
clusters are lowered to stacked arrays (``lower_grid``: the table's
``coeff_pytree`` columns, each cluster's collective menus as (alpha,
m_coeff, beta) triples, the XPU roofline peaks), and the grid is evaluated
as a loop over the op axis:

  compute + comm  each op adds its roofline time to an (n_xpu, n_sc, n_b)
                  block and its best-algorithm collective time to an
                  (n_cl, n_b) block; the (n_ops, grid) tensor never exists
                  (``_seq_kernel``). The op's kind is known on the host, so
                  an op adds only to its own block: the JAX scan adds a
                  0.0 to the other, which changes no value
  DBO             the three-lane (max,+) recurrence of
                  ``sweep._lane_makespan`` over the merged (op, microbatch)
                  order, every stagger candidate at once on a leading axis
                  (``_makespan_kernel``)
  prefill         the chunk-polynomial durations and the causal half-chunk
                  DBO makespan of ``sweep._prefill_chunk_times``
  skew            the expert-load factors (``op_load_factors``) as two more
                  per-op columns, read by the ``_skew`` variants, whose
                  comm block carries the scenario axis

None of these is a Pallas kernel in the reference (they are ``lax.scan``
programs), so plain torch is their port. Every sum keeps the association
of the NumPy path, as the JAX kernels do: the engine is held to the NumPy
``GridEval`` at 1e-6 relative (tests/test_torch_sweep.py; the JAX engine
reached about 1e-12). Every public function takes and returns NumPy
arrays; the device stays inside this module.

The engine reads only what its caller passes in: the table's
``coeff_pytree()``, ``kind``, ``group``, ``tp``, ``pp``, ``n``, ``n_ops``,
``lane`` and ``dtype``, each cluster's ``comm_spec`` and XPU peaks, and
each scenario's ``context``. So it evaluates the port's own tables
(``repro_torch.core.optable``) and clusters (``repro_torch.core.topology``)
and any object with the same attributes alike.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

# integer codes of an op's kind (``optable.KIND_*``)
KIND_COMPUTE, KIND_A2A, KIND_AR, KIND_PP = 0, 1, 2, 3
_KIND_NAMES = {KIND_A2A: "a2a", KIND_AR: "ar", KIND_PP: "pp_sendrecv"}
# the roofline's constants (``compute_model``)
EFF_MEMORY = 0.58          # achievable fraction of HBM bandwidth
T_LAUNCH = 2.0e-6          # CUDA-graph/fused-step per-kernel overhead
GEMM_SMALL_TOKENS = 128    # below this many rows a GEMM is 'thin'
# the DBO schedule's lanes and stagger candidates (``overlap``)
LANES = ("compute", "comm", "sendrecv")
MAX_STAGGER = 9        # ~ops per MoE layer; staggers 0..MAX_STAGGER tried

F64 = torch.float64


# ---------------------------------------------------------------------------
# lowering: table + clusters -> stacked arrays
# ---------------------------------------------------------------------------

def _comm_menu_coeffs(cluster, kind: int, group: int,
                      tp: int = 1, pp: int = 1):
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


def lower_comm_menus(table, clusters) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """Per-op collective menus as stacked arrays (n_ops, n_cl, n_alg):
    t_comm(op, cl) = min_alg(A + (Mc * m_bytes) * Bt) — exactly the
    association `sweep._comm_times` evaluates, so the engine's times match
    the NumPy ones to float rounding. Missing algorithm slots (menus have
    different sizes) and compute ops pad with A=+inf, which can never win
    the min and is masked off by the op-kind switch downstream."""
    kind = np.asarray(table.kind)
    group = np.asarray(table.group)
    pairs = sorted({(int(k), int(g)) for k, g in zip(kind, group)
                    if int(k) != KIND_COMPUTE})
    menus = {(ci, kg): _comm_menu_coeffs(cl, kg[0], kg[1], table.tp,
                                         table.pp)
             for ci, cl in enumerate(clusters) for kg in pairs}
    n_alg = max((len(m) for m in menus.values()), default=1)
    n_cl = len(clusters)
    A = np.full((table.n_ops, n_cl, n_alg), np.inf)
    Mc = np.zeros((table.n_ops, n_cl, n_alg))
    Bt = np.zeros((table.n_ops, n_cl, n_alg))
    for kg in pairs:
        sel = (kind == kg[0]) & (group == kg[1])
        for ci in range(n_cl):
            for j, (a, mc, bt) in enumerate(menus[ci, kg]):
                A[sel, ci, j] = a
                Mc[sel, ci, j] = mc
                Bt[sel, ci, j] = bt
    return A, Mc, Bt


def lower_grid(table, clusters) -> Dict[str, np.ndarray]:
    """One (op table, cluster list) lowered to the flat dict of arrays the
    kernels read: the table's `coeff_pytree` columns, the stacked comm
    menus, and the roofline constants per unique XPU with a cluster -> XPU
    gather index (a link-bw x topology product grid shares a handful of XPU
    specs across hundreds of clusters, and the roofline depends only on the
    spec). All leaves are NumPy float64/int arrays."""
    lw = table.coeff_pytree()
    lw["A"], lw["Mc"], lw["Bt"] = lower_comm_menus(table, clusters)
    fp8 = table.dtype == "fp8"
    xpu_of: Dict[int, int] = {}
    peak, hbm, idx = [], [], []
    for cl in clusters:
        key = id(cl.xpu)
        if key not in xpu_of:
            xpu_of[key] = len(peak)
            peak.append(cl.xpu.flops_fp8 if fp8 else cl.xpu.flops_bf16)
            hbm.append(cl.xpu.hbm_bw)
        idx.append(xpu_of[key])
    lw["peak"] = np.array(peak, np.float64)
    lw["hbm"] = np.array(hbm, np.float64)
    lw["xpu_idx"] = np.array(idx, np.int32)
    return lw


@lru_cache(maxsize=None)
def _stagger_orders(n_ops: int) -> Tuple[np.ndarray, np.ndarray]:
    """The merged (op, microbatch) execution orders of every static
    stagger candidate, as gather-index arrays (n_staggers, 2 * n_ops) —
    the same orders `sweep._lane_makespan` walks in Python."""
    s_max = min(MAX_STAGGER, max(n_ops - 1, 0))
    ks = np.empty((s_max + 1, 2 * n_ops), np.int32)
    mbs = np.empty_like(ks)
    for s in range(s_max + 1):
        order = sorted(((k, mb) for mb in (0, 1) for k in range(n_ops)),
                       key=lambda km: (km[0] + (s if km[1] else 0), km[1]))
        ks[s] = [k for k, _ in order]
        mbs[s] = [mb for _, mb in order]
    return ks, mbs


# ---------------------------------------------------------------------------
# the grid on the device
# ---------------------------------------------------------------------------

# the per-op coefficients read as Python floats (the skew's hosting factor
# cf among them when the grid has one)
_SCALARS = ("stage_scale", "flop_row", "flop_row_ctx", "flop_row_chunk",
            "bytes_const", "bytes_row", "bytes_ctx", "m_row", "cf")


class _Lowered:
    """A lowered grid on one device: the per-op coefficients stay on the
    host as Python floats (torch multiplies a float64 tensor by one in
    float64, exactly as NumPy does), the efficiencies, menus and peaks go
    to the device."""

    def __init__(self, lw: Dict[str, np.ndarray], device: torch.device):
        self.n_ops = len(lw["kind"])
        self.is_comp = np.asarray(lw["kind"]) == KIND_COMPUTE
        self.device = device
        keys = [k for k in _SCALARS if k in lw]
        self.ops = [{k: float(lw[k][i]) for k in keys} for i in range(self.n_ops)]
        dev = self.tensor
        self.eff, self.eff_small = dev(lw["eff"]), dev(lw["eff_small"])
        self.A, self.Mc, self.Bt = dev(lw["A"]), dev(lw["Mc"]), dev(lw["Bt"])
        self.peak, self.hbm = dev(lw["peak"]), dev(lw["hbm"])
        self.xpu_idx = torch.as_tensor(lw["xpu_idx"], dtype=torch.long,
                                       device=device)
        self.lf = dev(lw["lf"]) if "lf" in lw else None

    def tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device)


def _eff(lo: _Lowered, i: int, knee):
    """Op i's GEMM efficiency per batch: the thin-GEMM knee below
    GEMM_SMALL_TOKENS rows."""
    return torch.where(knee, lo.eff_small[i], lo.eff[i])


def _op_comp(op, lo: _Lowered, i: int, rows, bpd, ctx, knee):
    """Roofline time of one compute op, (n_xpu, n_sc, n_b): the torch twin
    of `GridEval._durations`' per-op row, with the thin-GEMM efficiency
    knee and the pipeline `stage_scale`."""
    f = (op["flop_row"] * rows)[None, :] \
        + (op["flop_row_ctx"] * rows)[None, :] * ctx[:, None]
    by = (op["bytes_const"] + op["bytes_row"] * rows)[None, :] \
        + (op["bytes_ctx"] * bpd)[None, :] * ctx[:, None]
    eff = _eff(lo, i, knee)                                       # (n_b,)
    t_c = f[None] / (lo.peak[:, None, None] * eff[None, None, :])
    t_m = by[None] / (lo.hbm[:, None, None] * EFF_MEMORY)
    return (torch.maximum(t_c, t_m) + T_LAUNCH) * op["stage_scale"]


def _op_comm(op, lo: _Lowered, i: int, rows):
    """Best-algorithm alpha-beta time of one collective op, (n_cl, n_b):
    scenario-free, which is what keeps the sequential path factored."""
    m = op["m_row"] * rows                                     # (n_b,)
    alg = lo.A[i][:, :, None] \
        + (lo.Mc[i][:, :, None] * m[None, None, :]) * lo.Bt[i][:, :, None]
    return alg.amin(dim=1) * op["stage_scale"]


def _op_comp_skew(op, lo: _Lowered, i: int, rows, bpd, ctx, knee):
    """`_op_comp` under expert skew: the scenario's load factor lf on the
    row-linear flops and bytes, the hosting factor cf on the weight stream
    (the associations of `GridEval._durations`' skew branch)."""
    lf = lo.lf[i]                                              # (n_sc,)
    f = (op["flop_row"] * rows)[None, :] * lf[:, None] \
        + (op["flop_row_ctx"] * rows)[None, :] * ctx[:, None]
    by = op["bytes_const"] * op["cf"] \
        + (op["bytes_row"] * rows)[None, :] * lf[:, None] \
        + (op["bytes_ctx"] * bpd)[None, :] * ctx[:, None]
    eff = _eff(lo, i, knee)
    t_c = f[None] / (lo.peak[:, None, None] * eff[None, None, :])
    t_m = by[None] / (lo.hbm[:, None, None] * EFF_MEMORY)
    return (torch.maximum(t_c, t_m) + T_LAUNCH) * op["stage_scale"]


def _op_comm_skew(op, lo: _Lowered, i: int, rows):
    """`_op_comm` under skew: the hot rank's payload scales by lf per
    scenario, (n_cl, n_sc, n_b)."""
    m = (op["m_row"] * rows)[None, :] * lo.lf[i][:, None]      # (n_sc, n_b)
    alg = lo.A[i][:, :, None, None] \
        + (lo.Mc[i][:, :, None, None] * m[None, None]) * lo.Bt[i][:, :, None, None]
    return alg.amin(dim=1) * op["stage_scale"]


def _seq_kernel(lo: _Lowered, rows, bpd, ctx, skew: bool):
    """(t_compute, t_comm) summed over the op axis, each (n_cl, n_sc, n_b).
    The compute block is per XPU and the comm block per cluster (and per
    scenario only under skew); they are expanded once, at the end."""
    knee = rows < GEMM_SMALL_TOKENS
    n_xpu, n_cl = lo.peak.shape[0], lo.A.shape[1]
    tc = torch.zeros((n_xpu, ctx.shape[0], rows.shape[0]), dtype=F64,
                     device=lo.device)
    tm = torch.zeros((n_cl,) + ((ctx.shape[0],) if skew else ()) + (rows.shape[0],),
                     dtype=F64, device=lo.device)
    for i in range(lo.n_ops):
        op = lo.ops[i]
        if lo.is_comp[i]:
            tc = tc + (_op_comp_skew(op, lo, i, rows, bpd, ctx, knee) if skew
                       else _op_comp(op, lo, i, rows, bpd, ctx, knee))
        else:
            tm = tm + (_op_comm_skew(op, lo, i, rows) if skew
                       else _op_comm(op, lo, i, rows))
    tc_full = tc[lo.xpu_idx]                                   # (n_cl, n_sc, n_b)
    if not skew:
        tm = tm[:, None, :].expand_as(tc_full)
    return tc_full, tm


def _dur_kernel(lo: _Lowered, rows, bpd, ctx, skew: bool):
    """Per-op durations (n_ops, n_cl, n_sc, n_b): the DBO makespan needs
    each op's own row, so this one does hold the whole grid per op."""
    knee = rows < GEMM_SMALL_TOKENS
    n_cl = lo.A.shape[1]
    shape = (n_cl, ctx.shape[0], rows.shape[0])
    dur = torch.empty((lo.n_ops,) + shape, dtype=F64, device=lo.device)
    for i in range(lo.n_ops):
        op = lo.ops[i]
        if lo.is_comp[i]:
            comp = (_op_comp_skew(op, lo, i, rows, bpd, ctx, knee) if skew
                    else _op_comp(op, lo, i, rows, bpd, ctx, knee))
            dur[i] = comp[lo.xpu_idx]
        elif skew:
            dur[i] = _op_comm_skew(op, lo, i, rows)
        else:
            dur[i] = _op_comm(op, lo, i, rows)[:, None, :].expand(shape)
    return dur


def _makespan_kernel(lane: np.ndarray, dur_a, dur_b, ks: np.ndarray,
                     mbs: np.ndarray):
    """Best-stagger makespan of the fixed-order three-lane schedule —
    `sweep._lane_makespan` as a (max,+) recurrence over the merged order,
    every stagger candidate at once on a leading axis (ks/mbs: (n_staggers,
    2*n_ops) from `_stagger_orders`). dur_a/dur_b are the two microbatches'
    (n_ops, *tail) durations (equal for decode DBO, the causal halves for
    prefill chunks). `ready` (one row per microbatch) and `free` (one row
    per lane) are replaced through `torch.where` over their row index at
    each step, never written in place."""
    dev = dur_a.device
    n_ops, tail = dur_a.shape[0], tuple(dur_a.shape[1:])
    n_stag = ks.shape[0]
    lane = np.asarray(lane, np.int64)
    flat = torch.stack([dur_a, dur_b]).reshape((2 * n_ops,) + tail)
    # per merged-order step: the flat row of (mb, k), its microbatch and
    # its lane, for every stagger candidate
    src = torch.as_tensor((mbs.astype(np.int64) * n_ops + ks).T, device=dev)
    mb_of = torch.as_tensor(mbs.T.astype(np.int64), device=dev)
    lane_of = torch.as_tensor(lane[ks].T, device=dev)
    pad = (1,) * len(tail)
    mb_rows = torch.arange(2, device=dev).view((2, 1) + pad)
    lane_rows = torch.arange(len(LANES), device=dev).view((len(LANES), 1) + pad)
    ready = torch.zeros((2, n_stag) + tail, dtype=dur_a.dtype, device=dev)
    free = torch.zeros((len(LANES), n_stag) + tail, dtype=dur_a.dtype, device=dev)
    for t in range(2 * n_ops):
        mb = mb_of[t].view((1, n_stag) + pad)
        ln = lane_of[t].view((1, n_stag) + pad)
        r = torch.where(mb[0] == 0, ready[0], ready[1])
        f = free.gather(0, ln.expand((1, n_stag) + tail))[0]
        end = torch.maximum(r, f) + flat[src[t]]
        ready = torch.where(mb_rows == mb, end[None], ready)
        free = torch.where(lane_rows == ln, end[None], free)
    return torch.maximum(ready[0], ready[1]).amin(dim=0)


def _prefill_dur_kernel(lo: _Lowered, rows, bpd, chunk, ctx):
    """Per-op per-chunk durations (n_ops, n_chunks) of one chunk schedule
    on one cluster — the twin of `sweep._prefill_chunk_durations` (comp and
    comm in one tensor; their supports are disjoint). `chunk`/`ctx` are
    ALIGNED vectors (one entry per chunk), and the flop polynomial carries
    the quadratic-in-chunk `flop_row_chunk` attention term."""
    peak, hbm = lo.peak[0], lo.hbm[0]
    knee = rows < GEMM_SMALL_TOKENS
    dur = torch.empty((lo.n_ops, rows.shape[0]), dtype=F64, device=lo.device)
    for i in range(lo.n_ops):
        op = lo.ops[i]
        if lo.is_comp[i]:
            f = op["flop_row"] * rows + op["flop_row_ctx"] * (rows * ctx) \
                + op["flop_row_chunk"] * (rows * chunk)
            by = op["bytes_const"] + op["bytes_row"] * rows \
                + op["bytes_ctx"] * (bpd * ctx)
            d = torch.maximum(f / (peak * _eff(lo, i, knee)),
                              by / (hbm * EFF_MEMORY)) + T_LAUNCH
        else:
            m = op["m_row"] * rows
            alg = lo.A[i][0][:, None] \
                + (lo.Mc[i][0][:, None] * m[None, :]) * lo.Bt[i][0][:, None]
            d = alg.amin(dim=0)
        dur[i] = d * op["stage_scale"]
    return dur


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def prefill_chunk_times(ptable, cluster, batch_global: int,
                        sizes: Sequence[int], offsets: Sequence[int], *,
                        dbo: bool = False, device=None) -> np.ndarray:
    """`sweep._prefill_chunk_times` on the device: per-chunk prefill
    iteration times, (n_chunks,). dbo=True takes best-of(no-overlap,
    three-lane DBO over the causal ceil/floor half-chunk split) per chunk.
    Runs on the card unless `device` says "cpu"."""
    lo = _Lowered(lower_grid(ptable, [cluster]),
                  resolve_device("cuda" if device is None else device))
    s_arr = np.asarray(sizes, np.float64)
    o_arr = np.asarray(offsets, np.float64)
    bpd = float(batch_global) * ptable.tp / ptable.n

    def dur(sz, off):
        return _prefill_dur_kernel(lo, bpd * lo.tensor(sz), bpd, lo.tensor(sz),
                                   lo.tensor(off))

    seq = _numpy(dur(s_arr, o_arr).sum(dim=0))
    if not dbo:
        return seq
    h2 = np.floor(s_arr / 2)
    h1 = s_arr - h2
    mk = _numpy(_makespan_kernel(ptable.lane, dur(h1, o_arr), dur(h2, o_arr + h1),
                                 *_stagger_orders(ptable.n_ops)))
    return np.where(s_arr >= 2, np.minimum(seq, mk), seq)


# ---------------------------------------------------------------------------
# the decode-grid engine
# ---------------------------------------------------------------------------

class TorchGridEngine:
    """Evaluator of one (table, clusters, scenarios, batches) grid in
    float64 on `device` (the card unless the caller says "cpu").

    `seq_components` and `dbo_makespan` are the two primitives that
    `sweep.GridEval` delegates to its engine; `tpot` combines them as
    `GridEval.tpot` does. `load` is the pair of `op_load_factors` (None on
    a uniform grid). Methods return NumPy arrays of shape (n_clusters,
    n_scenarios, n_batches)."""

    def __init__(self, table, clusters, scenarios, batches: np.ndarray,
                 half: np.ndarray, load=None, *, device=None):
        self.table = table
        lw = lower_grid(table, clusters)
        self.skew = load is not None
        if self.skew:
            lw["lf"] = np.asarray(load[0], np.float64)
            lw["cf"] = np.asarray(load[1], np.float64)
        self.lo = _Lowered(lw, resolve_device("cuda" if device is None else device))
        self.ctx = self.lo.tensor([sc.context for sc in scenarios])
        self.batches = np.asarray(batches, np.float64)
        self.half = np.asarray(half, np.float64)

    @property
    def device(self) -> torch.device:
        return self.lo.device

    def _rows(self, q: int, half: bool):
        b = self.half if half else self.batches
        bpd = b * self.table.tp / self.table.n
        return self.lo.tensor(bpd * q), self.lo.tensor(bpd)

    def seq_components(self, q: int, half: bool = False):
        """(t_compute, t_comm) of the no-overlap iteration of `q` tokens a
        row (at half batch when `half`)."""
        rows, bpd = self._rows(q, half)
        tc, tm = _seq_kernel(self.lo, rows, bpd, self.ctx, self.skew)
        return _numpy(tc), _numpy(tm)

    def dbo_makespan(self, q: int) -> np.ndarray:
        """Best-stagger three-lane makespan at half batch."""
        rows, bpd = self._rows(q, half=True)
        dur = _dur_kernel(self.lo, rows, bpd, self.ctx, self.skew)
        return _numpy(_makespan_kernel(self.table.lane, dur, dur,
                                       *_stagger_orders(self.table.n_ops)))

    def best_iteration(self, q: int, dbo: bool) -> np.ndarray:
        """min(no-overlap, DBO) per grid point, DBO only where the batch
        splits into two microbatches (`GridEval.best_iteration`)."""
        tc, tm = self.seq_components(q)
        t_seq = tc + tm
        if not dbo:
            return t_seq
        mk = self.dbo_makespan(q)
        return np.where(self.batches >= 2, np.minimum(t_seq, mk), t_seq)

    def tpot(self, *, dbo: bool = False, sd=None) -> np.ndarray:
        """TPOT seconds over the grid (`GridEval.tpot`): one token's
        iteration, or with speculative decoding `sd` (a
        `specdec.SpecDecConfig`) a draft and a verify of `sd.spec_m`
        tokens per `sd.tokens_per_iteration` accepted tokens."""
        t1 = self.best_iteration(1, dbo)
        if sd is None:
            return t1
        tv = self.best_iteration(sd.spec_m, dbo)
        return (t1 + tv) / sd.tokens_per_iteration


# ---------------------------------------------------------------------------
# expert-skew load factors
# ---------------------------------------------------------------------------

def op_load_factors(table, cfg, scenarios: Sequence,
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
    from repro_torch.core import placement

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
