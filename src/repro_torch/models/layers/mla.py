"""Multi-head Latent Attention (DeepSeek-V2/V3), the paper's workload.

Port of ``repro.models.layers.mla``. The cache holds only the compressed
latent per token (``c_kv`` [B, S, r] and the shared roped key ``k_rope``
[B, S, rp]); every decode step decompresses K and V from it (the
non-absorbed form, as the JAX layer). The decode attention is plain torch
over the decompressed cache, as the JAX decode is plain jnp: no kernel of
the port runs in this layer.

``pos`` at decode is a scalar (one position for the batch, the JAX
semantics) or a [B] tensor, one position per slot, as the engine passes
it. RoPE, the cache write and the mask then go per row. A position past
the cache writes the NEW latent at row S - 1, the JAX
``dynamic_update_slice`` clamp; this differs from the GQA decode, which
writes the old row back there.

Weights are replicated under every plan (``head_tp_ok`` is False for
MLA). Sequence-sharded (train, prefill), a rank projects its own
positions ``r * S_loc + arange(S_loc)``, all-gathers the latent and the
roped key over the sequence before decompressing K and V, and attends
with its queries offset by ``r * S_loc``; its prefill cache is its own
positions, which ``kvcache.pad_to_capacity`` gathers into the decode
cache, replicated over ``model`` with the batch over the data axes.
"""
from __future__ import annotations

import math

import torch

from repro_torch import tracing
from repro_torch.models.layers.attention import NEG_INF, _positions, flash_attn
from repro_torch.models.layers.common import apply_rope, dtype_of, normal
from repro_torch.sharding.dist import Dist
from repro_torch.sharding.plans import ShardingPlan


def init_mla(cfg, plan: ShardingPlan, gen):
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    r, qr, rp = cfg.mla_kv_lora_rank, cfg.mla_q_lora_rank, cfg.mla_rope_head_dim
    dt = dtype_of(cfg)
    sc = d ** -0.5
    return {
        "w_dq": normal((d, qr), dt, gen, sc),
        "w_uq": normal((qr, H * (hd + rp)), dt, gen, qr ** -0.5),
        "w_dkv": normal((d, r), dt, gen, sc),
        "w_kr": normal((d, rp), dt, gen, sc),
        "w_uk": normal((r, H * hd), dt, gen, r ** -0.5),
        "w_uv": normal((r, H * hd), dt, gen, r ** -0.5),
        "w_o": normal((H * hd, d), dt, gen, (H * hd) ** -0.5),
        "q_norm": torch.zeros((qr,), dtype=dt, device=gen.device),
        "kv_norm": torch.zeros((r,), dtype=dt, device=gen.device),
    }


def _rms(x, scale, eps: float = 1e-6):
    """The layer's own RMS norm: eps 1e-6 whatever ``cfg.norm_eps`` is."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def _qkv(params, x, cfg, positions):
    """x: [B, S, D]; positions: [S] or [B, S] -> q_n [B,S,H,hd],
    q_r [B,S,H,rp], c_kv [B,S,r], k_r [B,S,rp] (q_r and k_r roped)."""
    H, hd, rp = cfg.num_heads, cfg.head_dim, cfg.mla_rope_head_dim
    B, S, _ = x.shape
    cq = _rms(x @ params["w_dq"], params["q_norm"])
    q = (cq @ params["w_uq"]).reshape(B, S, H, hd + rp)
    q_n, q_r = q[..., :hd], q[..., hd:]
    q_r = apply_rope(q_r, positions, cfg.rope_theta)
    c_kv = _rms(x @ params["w_dkv"], params["kv_norm"])
    k_r = apply_rope((x @ params["w_kr"])[:, :, None, :], positions,
                     cfg.rope_theta)[:, :, 0]
    return q_n, q_r, c_kv, k_r


def _decompress(params, c_kv, cfg):
    H, hd = cfg.num_heads, cfg.head_dim
    B, S, _ = c_kv.shape
    k = (c_kv @ params["w_uk"]).reshape(B, S, H, hd)
    v = (c_kv @ params["w_uv"]).reshape(B, S, H, hd)
    return k, v


def mla_fwd(params, x, cfg, plan: ShardingPlan, dist: Dist, *,
            make_cache: bool = False):
    """Causal latent attention over x: [B, S_loc, D], sequence-sharded over
    ``plan.seq_axis``. The shared rope key is folded into each head by
    augmenting q and k with the rope dims; v is zero-padded to the same
    width and the output sliced back to hd. Returns (y [B, S_loc, D],
    {"c_kv", "k_rope"} of the rank's own positions | None)."""
    seq_ax = plan.seq_axis
    B, s_loc, _ = x.shape
    start = dist.index(seq_ax) * s_loc
    with tracing.span("mla.project"):
        q_n, q_r, c_kv, k_r = _qkv(params, x, cfg,
                                   start + torch.arange(s_loc, device=x.device))
    with tracing.span("mla.decompress"):
        k, v = _decompress(params, dist.all_gather(c_kv, seq_ax, dim=1), cfg)
    with tracing.span("mla.attend"):
        k_rg = dist.all_gather(k_r, seq_ax, dim=1)
        q_aug = torch.cat([q_n, q_r], dim=-1)
        k_aug = torch.cat([k, k_rg[:, :, None].expand(*k.shape[:3], k_rg.shape[-1])],
                          dim=-1)
        v_pad = torch.nn.functional.pad(v, (0, q_r.shape[-1]))
        o = flash_attn(q_aug, k_aug, v_pad, causal=True,
                       q_offset=start)[..., :cfg.head_dim]
    with tracing.span("mla.out"):
        y = o.reshape(B, s_loc, -1) @ params["w_o"]
    cache = {"c_kv": c_kv, "k_rope": k_r} if make_cache else None
    return y, cache


def mla_decode(params, x, cache, pos, cfg, plan: ShardingPlan, dist: Dist):
    """x: [B, 1, D]; cache: c_kv [B, S, r], k_rope [B, S, rp] (all positions:
    replicated over model under a sharded plan); pos: scalar or [B]. The
    new latent goes to row min(pos, S - 1) of each slot, then every head
    attends over rows <= pos of the decompressed cache, scores and softmax
    in f32, scale 1/sqrt(hd + rp). Returns (y [B, 1, D],
    cache) with the cache written in place."""
    hd, rp = cfg.head_dim, cfg.mla_rope_head_dim
    B = x.shape[0]
    p = _positions(pos, B, x.device)                               # [B]
    with tracing.span("mla.project"):
        q_n, q_r, c_new, kr_new = _qkv(params, x, cfg, p[:, None])
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
        S = c_kv.shape[1]
        rows = torch.arange(B, device=x.device)
        at = torch.clamp(p, max=S - 1)
        c_kv[rows, at] = c_new[:, 0]
        k_rope[rows, at] = kr_new[:, 0]

    with tracing.span("mla.decompress"):
        k, v = _decompress(params, c_kv, cfg)                      # [B, S, H, hd]
    with tracing.span("mla.attend"):
        scale = 1.0 / math.sqrt(hd + rp)
        s = (torch.einsum("bhd,bshd->bhs", q_n[:, 0].float(), k.float())
             + torch.einsum("bhr,bsr->bhs", q_r[:, 0].float(), k_rope.float())) * scale
        valid = torch.arange(S, device=x.device)[None, :] <= p[:, None]   # [B, S]
        s = torch.where(valid[:, None], s, NEG_INF)
        o = torch.einsum("bhs,bshd->bhd", torch.softmax(s, dim=-1), v.float())
        o = o.reshape(B, -1).to(x.dtype)
    with tracing.span("mla.out"):
        y = o @ params["w_o"]
    return y[:, None], cache
