"""Structured op tables: the workload op lists lowered to coefficient
arrays — the IR between `workload` (shape formulas) and the sweep engines.

Layer: `workload.decode_iteration` / `workload.prefill_iteration` produce
per-op dataclasses; this module lowers each list ONCE per mapping into an
`OpTable` / `PrefillOpTable` of closed-form coefficients; `sweep` (NumPy
reference) and `sweep_jax` (jitted) evaluate those tables over whole
batch x {dbo, sd} x scenario x topology grids. Rebuilding the op list
(hundreds of dataclass instances) per grid point was the hot path of every
figure benchmark — with the tables the grid is a handful of broadcasts.

Tables are LRU-cached per (model, tp, ep, n_devices, dtype, kv_dtype, pp)
— the full hybrid-parallelism key, so the (tp, pp, ep) mapping search
reuses one lowering per candidate mapping. The tp > 1 op lists gain the
`moe_ar` all-reduce and the TP-sharded expert terms (see
`workload.moe_ops`); both stay inside the linear basis below, so the
probes need no new points. Each table also carries a `lane` column (int
codes into `overlap.LANES`) routing every op to its scheduler lane —
compute, collective fabric, or the dedicated pp send/recv channel — for
the vectorized three-lane (max,+) DBO schedule (`sweep._lane_makespan`) —
and a `moe_layer` column (the per-op MoE-layer ordinal from
`workload.moe_layer_ordinals`, -1 for ops expert-load skew does not
touch). Tables are always built at UNIFORM routing; skewed scenarios are
applied by the sweep as per-op constant multipliers indexed through
`moe_layer` (`sweep.op_load_factors`), so skew changes neither the cache
key nor the probe points.

Parity contract: the closed forms must match the probed workload to 1e-9
relative (`_validate` raises otherwise), which is what lets the batched
engines claim 1e-9 agreement with the scalar `optimizer` path.

Every op emitted by `workload.decode_iteration` is exactly linear in the
basis {1, rows, rows*ctx, b*ctx} where b = batch_per_device and
rows = b * q_len:

  flops   = flop_row * rows + flop_row_ctx * rows * ctx     (attn core)
  bytes   = bytes_const + bytes_row * rows + bytes_ctx * b * ctx  (KV stream)
  m_bytes = m_row * rows                                    (comm payloads)

Rather than duplicating the formulas in `workload.py` (and silently
diverging from them), the coefficients are recovered by probing
`decode_iteration` at points chosen so the linear solve is trivial
(b in {0, tp}, ctx in {0, 1}), then validated against an independent probe
at a generic (b, q, ctx) point — if a future workload change breaks the
linearity assumption, `build_op_table` raises instead of mis-sweeping.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import workload
from repro_torch.core.compute_model import EFF_COMPUTE
from repro_torch.core.workload import ServingPoint

# integer codes for Op.kind
KIND_COMPUTE, KIND_A2A, KIND_AR, KIND_PP = 0, 1, 2, 3
KIND_CODES = {"compute": KIND_COMPUTE, "a2a": KIND_A2A, "ar": KIND_AR,
              "pp_sendrecv": KIND_PP}

def _lane_codes(ops) -> np.ndarray:
    """int8 lane column: index into `overlap.LANES` ("compute", "comm",
    "sendrecv" — collectives share the comm lane, pp hops get the
    dedicated send/recv lane of the three-lane (max,+) DBO schedule),
    derived from `workload.op_lane` (the scalar scheduler's tagging), so
    the vectorized schedule cannot diverge."""
    from repro_torch.core.overlap import LANES
    return np.array([LANES.index(workload.op_lane(o.kind))
                     for o in ops], np.int8)


@dataclass(frozen=True)
class OpTable:
    """Decode-iteration op list as coefficient arrays (one row per op).

    Fixed per (model config, tp, ep, n_devices, dtype, kv_dtype); evaluated
    at any (batch, q_len, context) via the closed forms in the docstrings
    below. All arrays have shape (n_ops,).
    """
    cfg_name: str
    tp: int
    ep: int
    n: int
    dtype: str
    kv_dtype: str
    pp: int

    names: Tuple[str, ...]
    kind: np.ndarray           # int8, KIND_* codes
    lane: np.ndarray           # int8, LANE_* codes (three-lane DBO schedule)
    group: np.ndarray          # AR group / pp-hop stage count (0 otherwise)
    stage_scale: np.ndarray    # per-op pipeline bottleneck factor (1.0 at pp|L)
    eff: np.ndarray            # compute efficiency at rows >= GEMM_SMALL_TOKENS
    eff_small: np.ndarray      # compute efficiency below the thin-GEMM cutoff

    flop_row: np.ndarray       # FLOPs per row
    flop_row_ctx: np.ndarray   # FLOPs per row per context token (attn core)
    bytes_const: np.ndarray    # weight bytes streamed regardless of batch
    bytes_row: np.ndarray      # activation bytes per row
    bytes_ctx: np.ndarray      # KV bytes per request per context token
    m_row: np.ndarray          # comm payload bytes per row
    moe_layer: np.ndarray      # int32 MoE-layer ordinal of skew-scaled ops
                               # (workload.moe_layer_ordinals; -1 otherwise)

    @property
    def n_ops(self) -> int:
        return len(self.names)

    @property
    def is_compute(self) -> np.ndarray:
        return self.kind == KIND_COMPUTE

    def coeff_pytree(self) -> Dict[str, np.ndarray]:
        """The coefficient columns as a flat pytree of stacked arrays —
        the interchange format of the jitted sweep backend
        (`repro.core.sweep_jax`): every leaf is an (n_ops,) array, so the
        whole table flows through `jax.jit`/`vmap` as one structure with
        no per-op Python objects left. Float columns are emitted as
        float64 (the x64 contract of the jax backend)."""
        return {
            "kind": np.asarray(self.kind, np.int32),
            "lane": np.asarray(self.lane, np.int32),
            "group": np.asarray(self.group, np.int64),
            "stage_scale": np.asarray(self.stage_scale, np.float64),
            "eff": np.asarray(self.eff, np.float64),
            "eff_small": np.asarray(self.eff_small, np.float64),
            "flop_row": np.asarray(self.flop_row, np.float64),
            "flop_row_ctx": np.asarray(self.flop_row_ctx, np.float64),
            "flop_row_chunk": np.zeros(self.n_ops, np.float64),
            "bytes_const": np.asarray(self.bytes_const, np.float64),
            "bytes_row": np.asarray(self.bytes_row, np.float64),
            "bytes_ctx": np.asarray(self.bytes_ctx, np.float64),
            "m_row": np.asarray(self.m_row, np.float64),
            "moe_layer": np.asarray(self.moe_layer, np.int32),
        }

    # ------------- closed-form evaluation -------------
    def batch_per_device(self, batches: np.ndarray) -> np.ndarray:
        return np.asarray(batches, float) * self.tp / self.n

    def rows(self, batches: np.ndarray, q_len: int) -> np.ndarray:
        return self.batch_per_device(batches) * q_len

    def flops(self, batches: np.ndarray, q_len: int, ctx: int) -> np.ndarray:
        """(n_ops, *batches.shape) FLOPs per op."""
        rows = self.rows(batches, q_len)
        return (self.flop_row[:, None] * rows
                + self.flop_row_ctx[:, None] * (rows * ctx))

    def op_bytes(self, batches: np.ndarray, q_len: int, ctx: int) -> np.ndarray:
        rows = self.rows(batches, q_len)
        b = self.batch_per_device(batches)
        return (self.bytes_const[:, None] + self.bytes_row[:, None] * rows
                + self.bytes_ctx[:, None] * (b * ctx))

    def m_bytes(self, batches: np.ndarray, q_len: int) -> np.ndarray:
        return self.m_row[:, None] * self.rows(batches, q_len)


def _stage_scale(names, n_layers: int, pp: int) -> np.ndarray:
    """Per-op pipeline bottleneck multiplier: per-layer ops
    (`workload.is_per_layer_op`) repeat on the largest stage
    `stage_imbalance` times per round; the lm head and the pp hops ride
    the round once. All ones at pp=1 and whenever pp divides the layer
    count."""
    imb = workload.stage_imbalance(n_layers, pp)
    return np.array([imb if workload.is_per_layer_op(nm) else 1.0
                     for nm in names])


def _probe(cfg: ModelConfig, *, batch_global: int, context: int, q_len: int,
           tp: int, ep: int, n: int, dtype: str, kv_dtype: str, pp: int = 1):
    p = ServingPoint(batch_global=batch_global, context=context, tp=tp,
                     ep=ep, n_devices=n, dtype=dtype, kv_dtype=kv_dtype,
                     q_len=q_len, pp=pp)
    ops = workload.decode_iteration(cfg, p)
    return (tuple(o.name for o in ops),
            np.array([o.flops for o in ops]),
            np.array([o.bytes for o in ops]),
            np.array([o.m_bytes for o in ops]),
            ops)


def build_op_table(cfg: ModelConfig, *, tp: int = 1, ep: int = 1,
                   n_devices: int = 0, dtype: str = "fp8",
                   kv_dtype: str = "bf16", pp: int = 1) -> OpTable:
    """Lower one decode iteration to an OpTable via linear probes.

    Probe points: b=0 isolates constant (weight) bytes; b=tp (i.e.
    batch_global=n, which makes batch_per_device exactly tp) isolates the
    per-row terms; ctx 0 vs 1 isolates the context terms. pp > 1 adds the
    pp-1 `pp_sendrecv` hop rows (payload linear in rows, so the same
    probes recover them) and the `stage_scale` bottleneck column.
    """
    n = n_devices or (ep * tp * pp)
    kw = dict(tp=tp, ep=ep, n=n, dtype=dtype, kv_dtype=kv_dtype, pp=pp)
    names0, f0, by0, m0, ops = _probe(cfg, batch_global=0, context=0,
                                      q_len=1, **kw)
    names1, f1, by1, m1, _ = _probe(cfg, batch_global=n, context=0,
                                    q_len=1, **kw)
    names2, f2, by2, m2, _ = _probe(cfg, batch_global=n, context=1,
                                    q_len=1, **kw)
    if not (names0 == names1 == names2):
        raise ValueError("op-list structure varies with batch/context; "
                         "cannot lower to a table")

    b1 = float(tp)                       # batch_per_device at the b-probes
    flop_row = f1 / b1
    flop_row_ctx = (f2 - f1) / b1
    bytes_const = by0
    bytes_row = (by1 - by0) / b1
    bytes_ctx = (by2 - by1) / b1
    m_row = m1 / b1

    eff = np.array([EFF_COMPUTE.get(o.op_class, EFF_COMPUTE["other"])
                    for o in ops])
    eff_small = np.array([
        EFF_COMPUTE["gemm_small"] if o.op_class == "gemm"
        else EFF_COMPUTE.get(o.op_class, EFF_COMPUTE["other"])
        for o in ops])

    table = OpTable(
        cfg_name=cfg.name, tp=tp, ep=ep, n=n, dtype=dtype, kv_dtype=kv_dtype,
        pp=pp, names=names0,
        kind=np.array([KIND_CODES[o.kind] for o in ops], np.int8),
        lane=_lane_codes(ops),
        group=np.array([o.group for o in ops], np.int64),
        stage_scale=_stage_scale(names0, cfg.num_layers, pp),
        eff=eff, eff_small=eff_small,
        flop_row=flop_row, flop_row_ctx=flop_row_ctx,
        bytes_const=bytes_const, bytes_row=bytes_row, bytes_ctx=bytes_ctx,
        m_row=m_row,
        moe_layer=np.array(workload.moe_layer_ordinals(names0), np.int32))
    _validate(cfg, table, **kw)
    return table


def _validate(cfg: ModelConfig, table: OpTable, *, tp, ep, n, dtype,
              kv_dtype, pp=1, rtol: float = 1e-9):
    """Cross-check the closed forms against a generic probe point. Guards
    against future nonlinearity creeping into `workload.decode_iteration`."""
    bg, ctx, q = 3 * n, 37, 2
    _, f, by, m, _ = _probe(cfg, batch_global=bg, context=ctx, q_len=q,
                            tp=tp, ep=ep, n=n, dtype=dtype,
                            kv_dtype=kv_dtype, pp=pp)
    batches = np.array([bg], float)
    got_f = table.flops(batches, q, ctx)[:, 0]
    got_by = table.op_bytes(batches, q, ctx)[:, 0]
    got_m = table.m_bytes(batches, q)[:, 0]
    for got, want, what in ((got_f, f, "flops"), (got_by, by, "bytes"),
                            (got_m, m, "m_bytes")):
        err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
        if err.max() > rtol:
            i = int(err.argmax())
            raise ValueError(
                f"op table diverges from decode_iteration on {what} for op "
                f"{table.names[i]!r}: {got[i]!r} vs {want[i]!r} — workload "
                "formulas are no longer linear in the sweep basis")


# Cache bound of the two table caches. 64 was enough for one figure's
# (tp, pp, ep) candidate set, but mapping x model x fault product grids
# (degraded re-search enumerates mappings per survivor count) cycle through
# hundreds of distinct keys and thrashed it — every eviction re-runs the
# probe + validate lowering. Tables are a few KB each, so a generous bound
# is effectively free; `cache_stats()` surfaces the hit/miss counters (the
# harness records them in BENCH_sweep_timing.json).
TABLE_CACHE_MAXSIZE = 1024


@lru_cache(maxsize=TABLE_CACHE_MAXSIZE)
def op_table(cfg: ModelConfig, tp: int, ep: int, n_devices: int,
             dtype: str = "fp8", kv_dtype: str = "bf16",
             pp: int = 1) -> OpTable:
    """LRU-cached table builder — the sweep engine's entry point, keyed on
    the full (model, tp, pp, ep, n, dtype) mapping. ModelConfig is a frozen
    dataclass, so it hashes by value and config edits miss the cache as
    they should."""
    return build_op_table(cfg, tp=tp, ep=ep, n_devices=n_devices,
                          dtype=dtype, kv_dtype=kv_dtype, pp=pp)


# ---------------------------------------------------------------------------
# prefill tables
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PrefillOpTable:
    """`workload.prefill_iteration` lowered to polynomial coefficients.

    With b = batch_per_device, rows = b * chunk, and ctx = tokens already
    cached when the chunk starts, every prefill op is exactly a polynomial
    over the basis

      flops   = flop_row * rows + flop_row_ctx * rows*ctx
                + flop_row_chunk * rows*chunk          (causal intra-chunk)
      bytes   = bytes_const + bytes_row * rows + bytes_ctx * b*ctx
      m_bytes = m_row * rows

    (the rows*chunk flop term is the quadratic-in-chunk attention core; the
    chunk's own KV streaming lands in bytes_row since it is linear in rows).
    As with the decode table, coefficients are recovered by probing
    `prefill_iteration` rather than re-deriving formulas, and validated at
    an independent (batch, chunk, context) point so nonlinearity creeping
    into the workload raises instead of mis-sweeping.
    """
    cfg_name: str
    tp: int
    ep: int
    n: int
    dtype: str
    kv_dtype: str
    pp: int

    names: Tuple[str, ...]
    kind: np.ndarray
    lane: np.ndarray
    group: np.ndarray
    stage_scale: np.ndarray
    eff: np.ndarray
    eff_small: np.ndarray

    flop_row: np.ndarray
    flop_row_ctx: np.ndarray
    flop_row_chunk: np.ndarray
    bytes_const: np.ndarray
    bytes_row: np.ndarray
    bytes_ctx: np.ndarray
    m_row: np.ndarray
    moe_layer: np.ndarray      # int32 MoE-layer ordinal of skew-scaled ops

    @property
    def n_ops(self) -> int:
        return len(self.names)

    @property
    def is_compute(self) -> np.ndarray:
        return self.kind == KIND_COMPUTE

    def coeff_pytree(self) -> Dict[str, np.ndarray]:
        """Coefficient columns as a pytree of stacked (n_ops,) arrays —
        same leaves as `OpTable.coeff_pytree` (shared jitted kernels), the
        prefill table just carries a nonzero `flop_row_chunk` column (the
        quadratic-in-chunk causal attention core)."""
        return {
            "kind": np.asarray(self.kind, np.int32),
            "lane": np.asarray(self.lane, np.int32),
            "group": np.asarray(self.group, np.int64),
            "stage_scale": np.asarray(self.stage_scale, np.float64),
            "eff": np.asarray(self.eff, np.float64),
            "eff_small": np.asarray(self.eff_small, np.float64),
            "flop_row": np.asarray(self.flop_row, np.float64),
            "flop_row_ctx": np.asarray(self.flop_row_ctx, np.float64),
            "flop_row_chunk": np.asarray(self.flop_row_chunk, np.float64),
            "bytes_const": np.asarray(self.bytes_const, np.float64),
            "bytes_row": np.asarray(self.bytes_row, np.float64),
            "bytes_ctx": np.asarray(self.bytes_ctx, np.float64),
            "m_row": np.asarray(self.m_row, np.float64),
            "moe_layer": np.asarray(self.moe_layer, np.int32),
        }

    # ------------- closed-form evaluation -------------
    # `chunk` and `ctx` broadcast together (e.g. the per-chunk sizes and
    # offsets of one chunked-prefill schedule); `batch_global` is scalar.
    def batch_per_device(self, batch_global: float) -> float:
        return batch_global * self.tp / self.n

    def rows(self, batch_global: float, chunk: np.ndarray) -> np.ndarray:
        return self.batch_per_device(batch_global) * np.asarray(chunk, float)

    def flops(self, batch_global: float, chunk: np.ndarray,
              ctx: np.ndarray) -> np.ndarray:
        """(n_ops, *chunk.shape) FLOPs per op."""
        rows = self.rows(batch_global, chunk)
        ctx = np.asarray(ctx, float)
        return (self.flop_row[:, None] * rows
                + self.flop_row_ctx[:, None] * (rows * ctx)
                + self.flop_row_chunk[:, None] * (rows * np.asarray(chunk,
                                                                    float)))

    def op_bytes(self, batch_global: float, chunk: np.ndarray,
                 ctx: np.ndarray) -> np.ndarray:
        rows = self.rows(batch_global, chunk)
        b = self.batch_per_device(batch_global)
        ctx = np.asarray(ctx, float)
        return (self.bytes_const[:, None] + self.bytes_row[:, None] * rows
                + self.bytes_ctx[:, None] * (b * ctx))

    def m_bytes(self, batch_global: float, chunk: np.ndarray) -> np.ndarray:
        return self.m_row[:, None] * self.rows(batch_global, chunk)


def _probe_prefill(cfg: ModelConfig, *, batch_global: int, context: int,
                   chunk: int, tp: int, ep: int, n: int, dtype: str,
                   kv_dtype: str, pp: int = 1):
    p = ServingPoint(batch_global=batch_global, context=context, tp=tp,
                     ep=ep, n_devices=n, dtype=dtype, kv_dtype=kv_dtype,
                     pp=pp)
    ops = workload.prefill_iteration(cfg, p, chunk)
    return (tuple(o.name for o in ops),
            np.array([o.flops for o in ops]),
            np.array([o.bytes for o in ops]),
            np.array([o.m_bytes for o in ops]),
            ops)


def build_prefill_op_table(cfg: ModelConfig, *, tp: int = 1, ep: int = 1,
                           n_devices: int = 0, dtype: str = "fp8",
                           kv_dtype: str = "bf16",
                           pp: int = 1) -> PrefillOpTable:
    """Lower one prefill iteration to a PrefillOpTable via polynomial probes.

    Probe points: b=0 isolates constant (weight) bytes; at b=tp, chunk 1 vs
    2 (ctx=0) separates the rows and rows*chunk flop terms; ctx 0 vs 1 at
    chunk=1 isolates the context terms.
    """
    n = n_devices or (ep * tp * pp)
    kw = dict(tp=tp, ep=ep, n=n, dtype=dtype, kv_dtype=kv_dtype, pp=pp)
    names0, f0, by0, m0, ops = _probe_prefill(cfg, batch_global=0, context=0,
                                              chunk=1, **kw)
    names1, f1, by1, m1, _ = _probe_prefill(cfg, batch_global=n, context=0,
                                            chunk=1, **kw)
    names2, f2, by2, m2, _ = _probe_prefill(cfg, batch_global=n, context=0,
                                            chunk=2, **kw)
    names3, f3, by3, m3, _ = _probe_prefill(cfg, batch_global=n, context=1,
                                            chunk=1, **kw)
    if not (names0 == names1 == names2 == names3):
        raise ValueError("prefill op-list structure varies with "
                         "batch/chunk/context; cannot lower to a table")

    b1 = float(tp)                       # batch_per_device at the b-probes
    # flops: f1 = b1*(fr + fc); f2 = b1*(2*fr + 4*fc); f3 adds b1*fctx
    flop_row_chunk = (f2 - 2 * f1) / (2 * b1)
    flop_row = f1 / b1 - flop_row_chunk
    flop_row_ctx = (f3 - f1) / b1
    bytes_const = by0
    bytes_row = (by1 - by0) / b1
    bytes_ctx = (by3 - by1) / b1
    m_row = m1 / b1

    eff = np.array([EFF_COMPUTE.get(o.op_class, EFF_COMPUTE["other"])
                    for o in ops])
    eff_small = np.array([
        EFF_COMPUTE["gemm_small"] if o.op_class == "gemm"
        else EFF_COMPUTE.get(o.op_class, EFF_COMPUTE["other"])
        for o in ops])

    table = PrefillOpTable(
        cfg_name=cfg.name, tp=tp, ep=ep, n=n, dtype=dtype, kv_dtype=kv_dtype,
        pp=pp, names=names0,
        kind=np.array([KIND_CODES[o.kind] for o in ops], np.int8),
        lane=_lane_codes(ops),
        group=np.array([o.group for o in ops], np.int64),
        stage_scale=_stage_scale(names0, cfg.num_layers, pp),
        eff=eff, eff_small=eff_small,
        flop_row=flop_row, flop_row_ctx=flop_row_ctx,
        flop_row_chunk=flop_row_chunk,
        bytes_const=bytes_const, bytes_row=bytes_row, bytes_ctx=bytes_ctx,
        m_row=m_row,
        moe_layer=np.array(workload.moe_layer_ordinals(names0), np.int32))
    _validate_prefill(cfg, table, **kw)
    return table


def _validate_prefill(cfg: ModelConfig, table: PrefillOpTable, *, tp, ep, n,
                      dtype, kv_dtype, pp=1, rtol: float = 1e-9):
    """Cross-check the closed forms against a generic probe point (the
    chunk=7 probe would expose e.g. a cubic-in-chunk term the chunk={1,2}
    fit could not see)."""
    bg, chunk, ctx = 3 * n, 7, 37
    _, f, by, m, _ = _probe_prefill(cfg, batch_global=bg, context=ctx,
                                    chunk=chunk, tp=tp, ep=ep, n=n,
                                    dtype=dtype, kv_dtype=kv_dtype, pp=pp)
    c_arr = np.array([chunk], float)
    o_arr = np.array([ctx], float)
    got_f = table.flops(bg, c_arr, o_arr)[:, 0]
    got_by = table.op_bytes(bg, c_arr, o_arr)[:, 0]
    got_m = table.m_bytes(bg, c_arr)[:, 0]
    for got, want, what in ((got_f, f, "flops"), (got_by, by, "bytes"),
                            (got_m, m, "m_bytes")):
        err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
        if err.max() > rtol:
            i = int(err.argmax())
            raise ValueError(
                f"prefill op table diverges from prefill_iteration on "
                f"{what} for op {table.names[i]!r}: {got[i]!r} vs "
                f"{want[i]!r} — workload formulas are no longer polynomial "
                "in the prefill sweep basis")


@lru_cache(maxsize=TABLE_CACHE_MAXSIZE)
def prefill_op_table(cfg: ModelConfig, tp: int, ep: int, n_devices: int,
                     dtype: str = "fp8", kv_dtype: str = "bf16",
                     pp: int = 1) -> PrefillOpTable:
    """LRU-cached prefill table builder — the prefill sweep's entry point."""
    return build_prefill_op_table(cfg, tp=tp, ep=ep, n_devices=n_devices,
                                  dtype=dtype, kv_dtype=kv_dtype, pp=pp)


def cache_stats() -> Dict[str, Dict[str, int]]:
    """Hit/miss counters of the two table caches (cumulative since import,
    or since the last `clear_caches()`). The benchmark harness writes these
    into BENCH_sweep_timing.json so a cache-thrashing regression (misses ~
    evaluations instead of ~ distinct mappings) is visible in the committed
    record."""
    out = {}
    for name, fn in (("op_table", op_table),
                     ("prefill_op_table", prefill_op_table)):
        info = fn.cache_info()
        out[name] = {"hits": info.hits, "misses": info.misses,
                     "maxsize": info.maxsize, "currsize": info.currsize}
    return out


def clear_caches() -> None:
    """Reset both table caches (and their counters) — for benchmarks that
    want a cold-start measurement."""
    op_table.cache_clear()
    prefill_op_table.cache_clear()
