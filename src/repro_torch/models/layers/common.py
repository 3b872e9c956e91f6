"""Shared layer primitives: norms, RoPE, dense SwiGLU FFN, vocab-parallel
embedding, LM head and cross entropy, greedy sampling.

Port of ``repro.models.layers.common``. Every function takes the pair
(plan, dist) where the JAX one does, so a later multi-device slice can
shard them unchanged. ``fsdp_gather`` has no counterpart yet: on one
device it is the identity, and the sharded form waits for the multi-device
``Dist``. Weight layout: matmul weights are stored [in, out].
Init functions draw from an explicit ``torch.Generator`` onto an explicit
device.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.dist import Dist
from repro_torch.sharding.plans import ShardingPlan, pad_to, VOCAB_PAD

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


def dense_ffn(params, x, plan: ShardingPlan, dist: Dist):
    """x: [B, T, D] (single device: full sequence, full d_ff)."""
    y = swiglu(x, params["w_gate"], params["w_up"], params["w_out"])
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


def embed(params, tokens, cfg, plan: ShardingPlan, dist: Dist):
    """tokens: [B, S] int -> [B, S, D]. Each vocab shard embeds the ids it
    owns; the psum over the vocab axis assembles them."""
    table = params["table"]
    v_loc = table.shape[0]
    r = dist.index(plan.vocab_axis)
    local = tokens.long() - r * v_loc
    in_range = (local >= 0) & (local < v_loc)
    out = table[local.clamp(0, v_loc - 1)]
    out = torch.where(in_range[..., None], out, torch.zeros_like(out))
    return dist.psum(out, plan.vocab_axis)


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
    they get no gradient), labels [B, T] global ids -> [B, T]. The max is
    detached (JAX's ``stop_gradient``): subtracting it is numerics only."""
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
