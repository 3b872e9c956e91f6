"""MoE decode iteration -> ordered list of compute + communication ops
(paper sections 2.1, 3.2.3).

One decode iteration of an MoE transformer under TP x EP is a repeating
per-layer pattern:

  [attn: qkv-proj, attn-core, o-proj, AR(tp)]
  [moe : router, A2A dispatch, expert FFN, A2A gather, (+shared expert)]

The per-device tensor shapes follow the Vidur observation the paper leans
on: every device in a parallelism domain executes the same-shaped shard, so
we derive shapes analytically from (batch, context, config, TP, EP) and feed
them to the roofline-with-efficiency compute model.

Expert-load skew (`core.placement`): uniform routing is the default and the
byte-identical fast path. A skewed scenario threads per-MoE-layer hot-rank
load factors through `ServingPoint.moe_load` (and replica slots through
`ServingPoint.moe_extra`); `moe_ops` then charges the MAX per-rank expert
load — grouped-GEMM row terms and A2A payload scale by the factor, the
expert weight stream by the hosted-expert count. Ops affected are exactly
`SKEW_SCALED_OPS`; `moe_layer_ordinals` maps op names to the per-layer
factor index and is the single source of truth shared with
`optable.OpTable.moe_layer`.

All sizes below are PER DEVICE unless suffixed `_global`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compute_model import Op

BYTES = {"bf16": 2, "fp8": 1, "fp16": 2, "f32": 4}

# scheduler lane of each communication kind (see `repro.core.overlap`):
# collectives (expert A2A, TP all-reduce) contend for the fabric on the
# "comm" lane; `pp_sendrecv` hops ride the dedicated point-to-point
# "sendrecv" lane, so pipeline hops overlap BOTH compute and collectives
# under the (max,+) DBO schedule (1F1B-style decode pipelining)
COMM_LANES = {"a2a": "comm", "ar": "comm", "pp_sendrecv": "sendrecv"}


def op_lane(kind: str) -> str:
    """Scheduler lane of an `Op.kind` — the single source of truth shared
    by the scalar scheduler (`overlap.to_timed`) and the vectorized lane
    column (`optable.OpTable.lane`)."""
    return "compute" if kind == "compute" else COMM_LANES[kind]


@dataclass(frozen=True)
class ServingPoint:
    """One operating point of the serving cluster.

    Parallelism is the hybrid (tp, pp, ep) mapping: the cluster splits
    into `pp` pipeline stages of n/pp devices, each stage an
    (n/(tp*pp)) x tp grid over its share of the layer stack. Attention
    runs data-parallel over the stage's n/(tp*pp) TP domains, TP-sharded
    inside each. MoE experts are EP over the `ep` expert groups of the
    stage (one group per TP domain when ep = n/(tp*pp)) and TP-sharded
    over the tp devices inside a group. With pp > 1 the batch circulates
    as pp microbatches (one per stage), so the per-device row count
    stays batch_global * tp / n and TPOT is the latency sum over all
    stages plus the pp-1 inter-stage hidden-state hops (see
    `decode_iteration`). The paper's fixed mapping is (tp=1, pp=1,
    ep=n) — and all (tp=1, pp=1) op lists are byte-identical to it.
    `n_devices` defaults to ep*tp*pp.
    """
    batch_global: int            # requests in flight per iteration (decode)
    context: int                 # average context length (KV length)
    tp: int = 1                  # tensor parallel degree
    ep: int = 1                  # expert parallel degree
    n_devices: int = 0           # 0 -> ep * tp * pp
    dtype: str = "fp8"           # weights/activations wire format
    kv_dtype: str = "bf16"
    q_len: int = 1               # >1 during SD verification
    pp: int = 1                  # pipeline-parallel degree (layer stages)
    # expert-load skew (core.placement): per-MoE-layer hot-rank load
    # factors (execution order; () = uniform, the byte-identical default)
    # and replica expert slots hosted per rank beyond the E/ep shard
    moe_load: Tuple[float, ...] = ()
    moe_extra: int = 0

    @property
    def n(self) -> int:
        return self.n_devices or (self.ep * self.tp * self.pp)

    @property
    def batch_per_device(self) -> float:
        # requests each device is responsible for (DP-attention domains);
        # pp-invariant: the stage's microbatch B/pp spreads over the
        # stage's n/(tp*pp) domains, so rows per device stay B*tp/n
        return self.batch_global * self.tp / self.n


def _wb(p: ServingPoint) -> int:
    return BYTES[p.dtype]


# ---------------------------------------------------------------------------
# per-layer op builders
# ---------------------------------------------------------------------------

def attention_ops(cfg: ModelConfig, p: ServingPoint) -> List[Op]:
    """Self-attention sublayer of ONE layer (decode, MLA or GQA)."""
    d = cfg.d_model
    b = p.batch_per_device            # rows through the projections
    q = p.q_len
    rows = b * q
    wb = _wb(p)
    kvb = BYTES[p.kv_dtype]
    ops: List[Op] = []

    if cfg.attn_kind == "mla":
        r, qr, rp = cfg.mla_kv_lora_rank, cfg.mla_q_lora_rank, cfg.mla_rope_head_dim
        nh, hd = cfg.num_heads, cfg.head_dim
        # down projections + up projections (weights sharded over tp where applicable)
        w_down = d * (r + rp) + d * qr
        w_up = (qr * nh * (hd + rp) + r * nh * 2 * hd + nh * hd * d) / p.tp
        for name, w in (("mla_down", w_down), ("mla_up", w_up)):
            ops.append(Op(name=name, kind="compute",
                          flops=2 * rows * w, bytes=w * wb + rows * d * wb,
                          op_class="gemm"))
        # attention core against compressed KV cache [b, ctx, r+rp]
        kv_bytes = b * p.context * (r + rp) * kvb
        core_flops = 2 * b * q * (nh / p.tp) * p.context * (r + rp) * 2
        ops.append(Op(name="mla_core", kind="compute", flops=core_flops,
                      bytes=kv_bytes, op_class="attn"))
    else:
        nh, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        w_qkv = d * (nh + 2 * kh) * hd / p.tp
        w_o = nh * hd * d / p.tp
        ops.append(Op(name="qkv_proj", kind="compute",
                      flops=2 * rows * w_qkv,
                      bytes=w_qkv * wb + rows * d * wb, op_class="gemm"))
        kv_bytes = b * p.context * 2 * (kh / min(p.tp, kh)) * hd * kvb
        core_flops = 2 * b * q * (nh / p.tp) * p.context * hd * 2
        ops.append(Op(name="attn_core", kind="compute", flops=core_flops,
                      bytes=kv_bytes, op_class="attn"))
        ops.append(Op(name="o_proj", kind="compute", flops=2 * rows * w_o,
                      bytes=w_o * wb + rows * d * wb, op_class="gemm"))

    if p.tp > 1:
        # TP all-reduce of the attention output [rows, d]
        ops.append(Op(name="attn_ar", kind="ar",
                      m_bytes=rows * d * wb, group=p.tp))
    return ops


def moe_ops(cfg: ModelConfig, p: ServingPoint, load: float = 1.0,
            extra: int = 0) -> List[Op]:
    """MoE FFN sublayer of ONE layer: router + A2A dispatch + experts + A2A.

    With tp > 1 the experts are TP-sharded inside each expert group: the
    dispatch/gather A2As carry each token's 1/tp feature shard, the expert
    GEMMs run column/row-parallel over d_expert (weights and flops / tp),
    and the sublayer ends with one `moe_ar` all-reduce of the combined
    [rows, d] output over the tp shards (the row-parallel partial sums,
    shared-expert included). At tp=1 every term reduces to the paper's
    fixed mapping exactly.

    `load` is the layer's hot-rank load factor (`core.placement`, >= 1):
    under skewed routing a symmetric A2A/grouped-GEMM finishes when its
    hottest rank does, so the token-proportional terms of `a2a_dispatch`,
    `expert_ffn` and `a2a_gather` scale by `load` instead of the mean.
    `extra` replica expert slots per rank widen the expert weight stream
    (and the HBM shard — see `model_shard_bytes`). The defaults
    (load=1.0, extra=0) are bit-exact no-ops: multiplying by 1.0 and
    adding 0 leave every float unchanged, preserving the uniform path's
    byte-identity.
    """
    assert cfg.moe is not None
    m = cfg.moe
    d = cfg.d_model
    b = p.batch_per_device
    rows = b * p.q_len
    wb = _wb(p)
    ops: List[Op] = []

    # router (tiny; replicated per domain device)
    ops.append(Op(name="router", kind="compute",
                  flops=2 * rows * d * m.num_experts,
                  bytes=d * m.num_experts * wb + rows * d * wb,
                  op_class="other"))

    # dispatch A2A: each token is sent to top-k expert owners.
    # m = per-device payload = rows * topk * d / tp (paper's A2A message
    # convention; the domain's tp devices split the token features); the
    # hottest rank ingests `load` x the mean and the collective waits on it
    a2a_bytes = rows * m.experts_per_token * d * wb / p.tp * load
    if p.ep > 1:
        ops.append(Op(name="a2a_dispatch", kind="a2a", m_bytes=a2a_bytes,
                      group=p.ep))

    # expert FFN: each expert group hosts E/ep experts (+ `extra` replica
    # slots) and its hottest rank receives rows * topk * load tokens; each
    # of the group's tp devices holds a 1/tp shard of the expert weights
    # and activations.
    tokens_in = rows * m.experts_per_token
    experts_local = max(m.num_experts // p.ep, 1)
    w_expert = 3 * d * m.d_expert            # SwiGLU gate/up/down
    ops.append(Op(name="expert_ffn", kind="compute",
                  flops=2 * tokens_in * load * w_expert / p.tp,
                  bytes=((experts_local + extra) * w_expert * wb
                         + 2 * tokens_in * load * d * wb) / p.tp,
                  op_class="gemm"))

    if m.num_shared_experts:
        w_sh = m.num_shared_experts * 3 * d * m.d_shared_expert / p.tp
        ops.append(Op(name="shared_expert", kind="compute",
                      flops=2 * rows * w_sh, bytes=w_sh * wb + rows * d * wb,
                      op_class="gemm"))

    if p.ep > 1:
        ops.append(Op(name="a2a_gather", kind="a2a", m_bytes=a2a_bytes,
                      group=p.ep))

    if p.tp > 1:
        # TP all-reduce of the combined MoE output [rows, d]: the
        # row-parallel down-proj partial sums (routed + shared experts)
        ops.append(Op(name="moe_ar", kind="ar", m_bytes=rows * d * wb,
                      group=p.tp))
    return ops


def dense_ffn_ops(cfg: ModelConfig, p: ServingPoint) -> List[Op]:
    d = cfg.d_model
    rows = p.batch_per_device * p.q_len
    wb = _wb(p)
    w = 3 * d * cfg.d_ff / p.tp
    ops = [Op(name="dense_ffn", kind="compute", flops=2 * rows * w,
              bytes=w * wb + 2 * rows * d * wb, op_class="gemm")]
    if p.tp > 1:
        ops.append(Op(name="ffn_ar", kind="ar", m_bytes=rows * d * wb,
                      group=p.tp))
    return ops


# ---------------------------------------------------------------------------
# pipeline-parallel stage partition
# ---------------------------------------------------------------------------

def stage_layer_counts(n_layers: int, pp: int) -> List[int]:
    """Balanced contiguous stage partition of the layer stack: stage sizes
    differ by at most one layer (the leading n_layers % pp stages take the
    extra). Raises when pp exceeds the layer count — a stage must own at
    least one layer."""
    if pp < 1:
        raise ValueError(f"pp must be >= 1, got {pp}")
    if pp > n_layers:
        raise ValueError(f"pp ({pp}) exceeds the layer count ({n_layers}); "
                         "every stage needs at least one layer")
    base, rem = divmod(n_layers, pp)
    return [base + (1 if s < rem else 0) for s in range(pp)]


def is_per_layer_op(name: str) -> bool:
    """True for ops that live on a pipeline stage's layer block — the
    'L{li}.'-prefixed names `decode_iteration` emits (the only dotted
    ones). The lm head and `pp_hop*` sends ride the round once and are
    NOT per-layer. Single source of truth for the stage-bottleneck
    scaling in `optable._stage_scale` and `optimizer._scaled_timers`."""
    return "." in name


# ops whose token-proportional terms scale with the hot-rank expert load
# factor under skewed routing (see `moe_ops` and `core.placement`); the
# router, shared expert and TP all-reduces see every token regardless of
# which expert it routes to, so they stay at the mean
SKEW_SCALED_OPS = ("a2a_dispatch", "expert_ffn", "a2a_gather")


def moe_layer_ordinals(names) -> List[int]:
    """Per-op MoE-layer ordinal for skew scaling: -1 for ops unaffected by
    expert-load skew, else the op's 0-based index among MoE layers in
    execution order — the same counter `decode_iteration` advances, so
    `ServingPoint.moe_load[ordinal]` is the factor the scalar path applied.
    Single source of truth for `optable.OpTable.moe_layer`."""
    out: List[int] = []
    seen: dict = {}
    for nm in names:
        if "." in nm and nm.rsplit(".", 1)[-1] in SKEW_SCALED_OPS:
            layer = nm.split(".", 1)[0]
            if layer not in seen:
                seen[layer] = len(seen)
            out.append(seen[layer])
        else:
            out.append(-1)
    return out


def stage_imbalance(n_layers: int, pp: int) -> float:
    """Pipeline bottleneck factor of the balanced partition: the steady-
    state round period is pp * t_largest_stage, so per-layer op times
    scale by ceil(L/pp) * pp / L (exactly 1.0 when pp divides the layer
    count — there the latency-sum op list is the exact pipeline model)."""
    if pp <= 1:
        return 1.0
    return math.ceil(n_layers / pp) * pp / n_layers


# ---------------------------------------------------------------------------
# whole-iteration builders
# ---------------------------------------------------------------------------

def decode_iteration(cfg: ModelConfig, p: ServingPoint) -> List[Op]:
    """Op list for ONE decode iteration (all layers + lm head).

    Layers are emitted in execution order so the DBO scheduler can respect
    dependencies; `Op.name` carries a layer index prefix.

    With pp > 1 the stack splits into `p.pp` contiguous stages
    (`stage_layer_counts`); a `pp_sendrecv` hop op is emitted at each of
    the pp-1 stage boundaries, carrying the microbatch's hidden state
    [rows, d] split over the tp shards (each device forwards its 1/tp
    feature slice to its counterpart on the next stage). Per-layer shapes
    are pp-invariant — a stage device executes the same per-layer shard a
    pp=1 device would — so the summed op list is the token's pipeline
    latency; the bottleneck factor of an uneven partition is applied by
    the timers via `stage_imbalance`, not baked into the shapes.
    """
    boundaries = set()
    if p.pp > 1:
        acc = 0
        for c in stage_layer_counts(cfg.num_layers, p.pp)[:-1]:
            acc += c
            boundaries.add(acc)
    hop_bytes = p.batch_per_device * p.q_len * cfg.d_model * _wb(p) / p.tp
    stage = 0
    moe_i = 0
    ops: List[Op] = []
    for li, spec in enumerate(cfg.layer_specs):
        if li in boundaries:
            ops.append(Op(name=f"pp_hop{stage}", kind="pp_sendrecv",
                          m_bytes=hop_bytes, group=p.pp))
            stage += 1
        prefix = f"L{li}."
        layer_ops: List[Op] = []
        if spec.mixer in ("attn", "attn_local"):
            layer_ops += attention_ops(cfg, p)
        elif spec.mixer in ("mamba", "rwkv"):
            # linear-time mixer: projections dominate; model as one gemm
            d = cfg.d_model
            rows = p.batch_per_device * p.q_len
            wb = _wb(p)
            w = 6 * d * d / p.tp
            layer_ops.append(Op(name="ssm_mixer", kind="compute",
                               flops=2 * rows * w,
                               bytes=w * wb + rows * d * wb, op_class="gemm"))
            if p.tp > 1:
                layer_ops.append(Op(name="mixer_ar", kind="ar",
                                   m_bytes=rows * d * wb, group=p.tp))
        if spec.ffn == "moe":
            lf = p.moe_load[moe_i] if p.moe_load else 1.0
            layer_ops += moe_ops(cfg, p, load=lf, extra=p.moe_extra)
            moe_i += 1
        elif spec.ffn == "dense":
            layer_ops += dense_ffn_ops(cfg, p)
        ops += [Op(name=prefix + o.name, kind=o.kind, flops=o.flops,
                   bytes=o.bytes, op_class=o.op_class, m_bytes=o.m_bytes,
                   group=o.group) for o in layer_ops]
    if p.moe_load and len(p.moe_load) != moe_i:
        raise ValueError(f"moe_load has {len(p.moe_load)} factors but the "
                         f"model has {moe_i} MoE layers")

    # LM head (vocab projection, TP-sharded)
    d, v = cfg.d_model, cfg.vocab_size
    rows = p.batch_per_device * p.q_len
    wb = _wb(p)
    w = d * v / p.tp
    ops.append(Op(name="lm_head", kind="compute", flops=2 * rows * w,
                  bytes=w * wb + rows * d * wb, op_class="gemm"))
    return ops


def prefill_iteration(cfg: ModelConfig, p: ServingPoint,
                      chunk: int) -> List[Op]:
    """Op list for ONE prefill iteration: `chunk` new prompt tokens per
    request, appended after `p.context` tokens already in the KV cache
    (the chunk's offset into the prompt; 0 for the first chunk).

    Derived from `decode_iteration` at q_len=chunk — GEMM, router, expert
    and communication shapes are IDENTICAL (rows = batch_per_device * chunk
    tokens flow through every projection and A2A) — with two
    prefill-specific corrections:

      * the attention core gains the causal intra-chunk term: query i of
        the chunk attends to `context + i + 1` keys, so on top of the
        decode core's `chunk * context` (query, key) pairs it scores
        chunk*(chunk+1)/2 in-chunk pairs (quadratic in `chunk`), and
        streams the chunk's own KV once more (`chunk` extra key positions);
      * the LM head is dropped: logits are only needed once per request
        when its last chunk completes, and that single-row projection is
        charged to the request's first decode iteration.

    The corrections are derived by differencing `decode_iteration` at
    context and context+1 (its per-context-token slopes), not by
    duplicating the attention formulas — the same no-silent-divergence
    policy `optable.build_op_table` uses.
    """
    if chunk < 1:
        raise ValueError(f"prefill chunk must be >= 1 token, got {chunk}")
    pq = replace(p, q_len=chunk)
    ops0 = decode_iteration(cfg, pq)
    ops1 = decode_iteration(cfg, replace(pq, context=p.context + 1))
    out: List[Op] = []
    for o, o1 in zip(ops0, ops1):
        if o.name.rsplit(".", 1)[-1] == "lm_head":
            continue
        d_flops = o1.flops - o.flops       # per extra context token
        d_bytes = o1.bytes - o.bytes
        if d_flops or d_bytes:
            o = replace(o,
                        flops=o.flops + d_flops * (chunk + 1) / 2.0,
                        bytes=o.bytes + d_bytes * chunk)
        out.append(o)
    return out


def chunk_schedule(prompt_len: int, chunk: int) -> Tuple[List[int], List[int]]:
    """(sizes, offsets) of the chunked-prefill schedule covering a prompt:
    full `chunk`-token chunks plus a final partial one; `offsets[j]` is the
    KV length already cached when chunk j starts."""
    if prompt_len < 1:
        raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    sizes, offsets = [], []
    off = 0
    while off < prompt_len:
        s = min(chunk, prompt_len - off)
        sizes.append(s)
        offsets.append(off)
        off += s
    return sizes, offsets


def kv_cache_bytes_per_request(cfg: ModelConfig, context: int,
                               kv_dtype: str = "bf16", tp: int = 1) -> float:
    """KV-cache footprint of one request at `context` tokens (all layers),
    PER DEVICE of a tp-way TP domain: GQA KV shards over the kv heads
    (mirroring the `attention_ops` streaming model), MLA's compressed
    latent is replicated across the domain. tp=1 (the default) is the
    whole-request footprint — what the disagg KV handoff moves."""
    kvb = BYTES[kv_dtype]
    total = 0.0
    for spec in cfg.layer_specs:
        if spec.mixer in ("attn", "attn_local"):
            if cfg.attn_kind == "mla":
                total += context * (cfg.mla_kv_lora_rank
                                    + cfg.mla_rope_head_dim) * kvb
            else:
                w = cfg.sliding_window if (spec.mixer == "attn_local"
                                           and cfg.sliding_window) else context
                kh = cfg.num_kv_heads / min(tp, cfg.num_kv_heads)
                total += min(w, context) * 2 * kh * cfg.head_dim * kvb
        elif spec.mixer == "mamba":
            mc = cfg.mamba
            di = mc.expand * cfg.d_model
            total += di * (mc.d_state * 4 + mc.d_conv * kvb)
        elif spec.mixer == "rwkv":
            hd = cfg.rwkv.head_dim
            total += (cfg.d_model // hd) * hd * hd * 4
    return total


def model_shard_bytes(cfg: ModelConfig, tp: int, ep: int,
                      dtype: str = "fp8", pp: int = 1,
                      extra_experts: int = 0) -> float:
    """Per-device weight bytes: per-layer dense params / (tp*pp), expert
    params / (ep*tp*pp) (experts are TP-sharded inside each expert group,
    see `moe_ops` — at the paper mapping (tp=1, pp=1, ep=n) this is expert
    params / n exactly, and with ep = n/(tp*pp) it STAYS expert params / n
    at every pp: pipeline stages shrink only the dense shard).

    The pp split is checked against the WORST stage of the balanced
    partition: per-layer params carry the ceil(L/pp)*pp/L bottleneck
    factor (`stage_imbalance`), and the embedding / LM-head matrices —
    which pipeline stages do NOT split — are charged in full (one
    vocab x d matrix, TP-sharded) to the boundary stage, so an uneven
    split or a fat vocabulary cannot sneak a stage past the HBM capacity
    the uniform average would claim. pp=1 is the seed formula exactly.

    `extra_experts` replica slots per rank (the placement search,
    `core.placement`) each host one full TP-sharded expert on EVERY rank
    — they do not divide by ep — and under pp they belong to the stage's
    own MoE layers, so they carry the same imb/pp bottleneck factor as
    the base expert shard. extra_experts=0 adds nothing (bit-exact)."""
    wb = BYTES[dtype]
    total_params = cfg.param_count()
    imb = stage_imbalance(cfg.num_layers, pp)
    io_params = cfg.vocab_size * cfg.d_model  # per boundary stage (pp > 1)
    if cfg.moe is None:
        if pp == 1:
            return total_params * wb / tp
        layer_params = total_params - io_params * (1 if cfg.tie_embeddings
                                                  else 2)
        return (io_params + layer_params * imb / pp) * wb / tp
    m = cfg.moe
    n_moe = sum(1 for s in cfg.layer_specs if s.ffn == "moe")
    expert_params = n_moe * m.num_experts * 3 * cfg.d_model * m.d_expert
    dense_params = total_params - expert_params
    if pp == 1:
        total = (dense_params / tp + expert_params / (ep * tp)) * wb
    else:
        layer_dense = dense_params - io_params * (1 if cfg.tie_embeddings
                                                  else 2)
        total = ((io_params + layer_dense * imb / pp) / tp
                 + expert_params * imb / (ep * tp * pp)) * wb
    if extra_experts:
        w_expert = 3 * cfg.d_model * m.d_expert
        scale = imb / pp if pp > 1 else 1.0
        total += n_moe * extra_experts * w_expert * scale * wb / tp
    return total


# HBM fraction reserved for activations/fragmentation — the single memory
# headroom constant shared by the batch sizer and the (tp, ep) candidate
# enumerator (sweep.parallelism_candidates)
KV_RESERVE_FRAC = 0.10


def single_request_fits(cfg: ModelConfig, p: ServingPoint, hbm_cap: float,
                        reserve_frac: float = KV_RESERVE_FRAC) -> bool:
    """True iff ONE request's KV cache at `p.context` fits beside the model
    shard — exactly `max_batch_by_memory(...) >= 1`, named so the
    operating-point searches can REJECT scenarios whose per-request KV
    cannot be held at all instead of quietly sweeping an empty grid."""
    return max_batch_by_memory(cfg, p, hbm_cap, reserve_frac) >= 1


def max_batch_by_memory(cfg: ModelConfig, p: ServingPoint, hbm_cap: float,
                        reserve_frac: float = KV_RESERVE_FRAC) -> int:
    """Largest global batch whose KV cache fits beside the model shard
    (paper Table 4 last row). Batch is spread over the n/(tp*pp)
    DP-attention domains per stage; the per-device KV footprint follows
    the TP sharding of `kv_cache_bytes_per_request` (GQA shards over kv
    heads, MLA latent is replicated) and, under pp, each stage stores
    only its own layers' KV (1/pp of a request) for the pp microbatches
    it serves — per-device KV totals B*tp/n * kv_request either way, but
    the request count each device can admit divides by tp*pp."""
    shard = model_shard_bytes(cfg, p.tp, p.ep, p.dtype, p.pp, p.moe_extra)
    free = hbm_cap * (1 - reserve_frac) - shard
    if free <= 0:
        return 0
    per_req = kv_cache_bytes_per_request(cfg, p.context, p.kv_dtype, p.tp)
    if p.pp > 1:
        # largest stage holds ceil(L/pp)/L of a request's KV — the same
        # bottleneck factor the shard check applies, so uneven splits
        # cannot overcommit the fat stage's KV either
        per_req *= stage_imbalance(cfg.num_layers, p.pp) / p.pp
    per_dev = max(int(free / max(per_req, 1.0)), 0)
    return per_dev * p.n // (p.tp * p.pp)
