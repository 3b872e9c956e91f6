"""Shared layer primitives: norms, RoPE, dense SwiGLU FFN, vocab-parallel
embedding, LM head and cross entropy, greedy sampling.

Port of ``repro.models.layers.common``. Every function takes the pair
(plan, dist) where the JAX one does and runs on one rank's shards: the
embedding table and LM head are vocab-sharded, the dense FFN's hidden dim
is sharded over the tensor-parallel axis (or over data x model with
``ffn_2d``), and prefill tokens are sequence-sharded (Megatron-SP:
all-gather before, reduce-scatter after). ``fp8_all_gather`` sends e4m3
bytes with per-row f32 scales; as in JAX, its gradient reaches x through
the scales only (the bytes are integers). ``fsdp_spec`` and
``fsdp_gather`` shard a training plan's leaves over ``plan.fsdp_axis``
and gather them back for a layer's use; the gather's backward is the
reduce-scatter of the gradient. Weight layout: matmul weights are stored
[in, out].
Init functions draw from an explicit ``torch.Generator`` onto an explicit
device.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.dist import Dist
from repro_torch.sharding.plans import ShardingPlan, pad_to, VOCAB_PAD
from repro_torch.sharding.specs import P

INT32_MAX = 2 ** 31 - 1


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(shape, dtype, gen: torch.Generator, scale: float):
    """N(0, scale^2) draws in `dtype` on the generator's device."""
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
    return x.mul_(scale)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def init_rms_norm(d: int, dtype, device) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# RoPE (split halves, not interleaved pairs)
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable int)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                      # [hd/2]
    ang = positions[..., None].float() * freqs                    # [..., S, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense FFN (SwiGLU)
# ---------------------------------------------------------------------------

def init_dense_ffn(cfg, plan: ShardingPlan, gen, d_ff: Optional[int] = None):
    d, dff = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    return {
        "w_gate": normal((d, dff), dt, gen, d ** -0.5),
        "w_up": normal((d, dff), dt, gen, d ** -0.5),
        "w_out": normal((dff, d), dt, gen, dff ** -0.5),
    }


def swiglu(x, w_gate, w_up, w_out):
    gate = F.silu((x @ w_gate).float()).to(x.dtype)
    return (gate * (x @ w_up)) @ w_out


E4M3_MAX = 448.0      # largest normal of float8_e4m3fn


def fp8_quantize(x):
    """e4m3 bytes (uint8, the wire format) and f32 scales [..., 1] of x,
    one scale per row of the last dim (amax / 448; 1 for an all-zero
    row)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / E4M3_MAX, 1.0)
    return (xf / scale).to(torch.float8_e4m3fn).view(torch.uint8), scale


def fp8_dequantize(qb, scale, dtype):
    return (qb.view(torch.float8_e4m3fn).float() * scale).to(dtype)


def fp8_all_gather(x, axis, dist: Dist, dim: int):
    """All-gather with an fp8 (e4m3) wire format and per-row f32 scales:
    half the bytes of bf16. The result comes back in x's dtype. Its
    gradient is JAX's: the uint8 bytes carry none, so x gets only what
    flows back through each row's scale (amax / 448) to the row's largest
    magnitude."""
    qb, scale = fp8_quantize(x)
    qg = dist.all_gather(qb, axis, dim=dim)
    sg = dist.all_gather(scale, axis, dim=dim)
    return fp8_dequantize(qg, sg, x.dtype)


def dense_ffn(params, x, plan: ShardingPlan, dist: Dist):
    """x: [B, S_loc, D] (sequence-sharded: all-gathered before, the partial
    sums reduce-scattered after) or [B, T, D] (replicated over tp: the
    partial sums psummed). Decode ``ffn_2d``: the hidden dim is sharded
    over data x model, the batch all-gathered over data and the output
    reduce-scattered back to it before the psum over model."""
    seq_sharded = dist.size(plan.seq_axis) > 1
    if seq_sharded:
        if plan.ag_fp8:
            x = fp8_all_gather(x, plan.seq_axis, dist, dim=1)
        else:
            x = dist.all_gather(x, plan.seq_axis, dim=1)
    ffn_2d = plan.ffn_2d and dist.size("data") > 1
    if ffn_2d:
        x = dist.all_gather(x, "data", dim=0)
    y = swiglu(x, params["w_gate"], params["w_up"], params["w_out"])
    if seq_sharded:
        return dist.reduce_scatter(y, plan.seq_axis, dim=1)
    if ffn_2d:
        y = dist.reduce_scatter(y, "data", dim=0)
    return dist.psum(y, plan.tp_axis)


# ---------------------------------------------------------------------------
# vocab-parallel embedding + LM head
# ---------------------------------------------------------------------------

def padded_vocab(cfg) -> int:
    return pad_to(cfg.vocab_size, VOCAB_PAD)


def init_embedding(cfg, plan: ShardingPlan, gen):
    v = padded_vocab(cfg)
    dt = dtype_of(cfg)
    params = {"table": normal((v, cfg.d_model), dt, gen, 0.02)}
    if not cfg.tie_embeddings:
        params["head"] = normal((cfg.d_model, v), dt, gen, 0.02)
    return params


def embed(params, tokens, cfg, plan: ShardingPlan, dist: Dist, *,
          seq_axis=None):
    """tokens: [B, S] int -> [B, S, D]. Each vocab shard embeds the ids it
    owns; the psum over the vocab axis assembles them. With `seq_axis`, the
    tokens are this rank's positions, sequence-sharded: every rank of the
    vocab axis must look up the same ids, so the ids are all-gathered over
    the sequence first, and the partial embeddings are summed over the
    vocab axis and cut back to this rank's positions (one reduce-scatter
    when the two axes are one, as in every plan). The JAX function psums
    the lookups of different positions there (ROADMAP queue 3)."""
    n_seq = dist.size(seq_axis)
    s_loc = tokens.shape[1]
    if n_seq > 1:
        tokens = dist.all_gather(tokens, seq_axis, dim=1)
    table = params["table"]
    v_loc = table.shape[0]
    r = dist.index(plan.vocab_axis)
    local = tokens.long() - r * v_loc
    in_range = (local >= 0) & (local < v_loc)
    out = table[local.clamp(0, v_loc - 1)]
    out = torch.where(in_range[..., None], out, torch.zeros_like(out))
    if n_seq > 1 and seq_axis == plan.vocab_axis:
        return dist.reduce_scatter(out, seq_axis, dim=1)
    out = dist.psum(out, plan.vocab_axis)
    if n_seq > 1:
        out = out.narrow(1, dist.index(seq_axis) * s_loc, s_loc)
    return out


def lm_logits(params, x, cfg, plan: ShardingPlan, dist: Dist):
    """x: [B, T, D] -> f32 logits [B, T, V_loc], padded ids at -inf."""
    w = params["table"].T if cfg.tie_embeddings else params["head"]
    logits = (x @ w).float()
    v_loc = w.shape[-1]
    r = dist.index(plan.vocab_axis)
    ids = r * v_loc + torch.arange(v_loc, device=x.device)
    return torch.where(ids < cfg.vocab_size, logits, -torch.inf)


def xent_per_token(logits, labels, plan: ShardingPlan, dist: Dist):
    """Cross entropy of each position without the full-vocab logits on any
    rank: logits [B, T, V_loc] f32 (vocab-sharded, padded ids at -inf, so
    they get no gradient), labels [B, T] global ids -> [B, T]. Every rank
    of the vocab axis must hold the same B x T positions: the max and the
    sums over that axis are per position. The max is detached (JAX's
    ``stop_gradient``): subtracting it is numerics only."""
    v_loc = logits.shape[-1]
    r = dist.index(plan.vocab_axis)
    m = dist.pmax(logits.detach().amax(dim=-1), plan.vocab_axis)           # [B, T]
    sumexp = dist.psum(torch.exp(logits - m[..., None]).sum(dim=-1),
                       plan.vocab_axis)                                     # [B, T]
    local = labels.long() - r * v_loc
    in_range = (local >= 0) & (local < v_loc)
    picked = torch.gather(logits, -1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
    label_logit = dist.psum(torch.where(in_range, picked, 0.0), plan.vocab_axis)
    return torch.log(sumexp) + m - label_logit


def vocab_parallel_xent(logits, labels, cfg, plan: ShardingPlan, dist: Dist):
    """Mean cross entropy over every position (scalar, replicated)."""
    return xent_per_token(logits, labels, plan, dist).mean()


def greedy_sample(logits, cfg, plan: ShardingPlan, dist: Dist):
    """Global argmax over the sharded vocab: [B, T, V_loc] -> [B, T] int32;
    ties go to the lowest index (``torch.argmax`` takes the first maximum)."""
    v_loc = logits.shape[-1]
    r = dist.index(plan.vocab_axis)
    local_val = torch.amax(logits, dim=-1)
    local_idx = torch.argmax(logits, dim=-1)
    vmax = dist.pmax(local_val, plan.vocab_axis)
    global_idx = r * v_loc + local_idx
    cand = torch.where(local_val >= vmax, global_idx, INT32_MAX)
    return (-dist.pmax(-cand, plan.vocab_axis)).to(torch.int32)


# ---------------------------------------------------------------------------
# FSDP
# ---------------------------------------------------------------------------

def fsdp_spec(shape, base_spec: P, plan: ShardingPlan) -> P:
    """`base_spec` with ``plan.fsdp_axis`` on the first dim that no axis
    shards yet and that the axis divides (JAX's rule)."""
    if plan.fsdp_axis is None:
        return base_spec
    n = plan.axis_size(plan.fsdp_axis)
    entries = list(base_spec) + [None] * (len(shape) - len(base_spec))
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % n == 0 and dim >= n:
            entries[i] = plan.fsdp_axis
            return P(*entries)
    return base_spec


def fsdp_gather(params, specs, plan: ShardingPlan, dist: Dist):
    """The leaves of `params` (a dict tree) that `specs` shards over
    ``plan.fsdp_axis``, all-gathered back along that dim; the rest as they
    are. Under autograd the gather's backward reduce-scatters the
    gradient to the shards."""
    fsdp = plan.fsdp_axis
    if fsdp is None or dist.size(fsdp) == 1:
        return params
    if isinstance(specs, P):
        for dim, e in enumerate(specs):
            if e == fsdp:
                return dist.all_gather(params, fsdp, dim=dim)
        return params
    return {k: fsdp_gather(v, specs[k], plan, dist) for k, v in params.items()}
