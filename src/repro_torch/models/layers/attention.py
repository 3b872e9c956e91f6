"""Attention layers: prefill self-attention and KV-cache decode.

Port of the single-device paths of ``repro.models.layers.attention``:
  prefill  ``attention_fwd`` (replicated weights): q/k/v, RoPE, chunked
           online-softmax ``flash_attn`` (causal, and windowed for
           sliding-window layers), output projection; with ``make_cache``
           it also returns the decode-layout cache: k, v [B, KV, S, hd] for
           full attention, a ring buffer [B, KV, window, hd] holding the
           last `window` positions at row ``pos % window`` for a window.
  decode   ``attention_decode``: the new token's k/v are written into the
           cache at ``pos`` (ring row ``pos % W`` for a window), then the
           attention core is ``ops.flash_decode`` (the CUDA kernel on the
           card) over lengths ``pos + 1`` (``min(pos + 1, W)`` on a ring:
           before it wraps, rows 0..pos are exactly the written ones, and
           softmax does not depend on row order). ``pos`` is a scalar (one
           position for the batch, the JAX semantics) or a [B] tensor (one
           position per slot). The cache is updated in place and returned.
  cross    ``make_enc_cache`` projects the encoder output to the decoder's
           read-only k, v [B, KV, Se, hd] (no RoPE); ``cross_attention_fwd``
           attends over all of it (not causal); ``cross_attention_decode``
           is ``ops.flash_decode`` with length ``enc_len`` for every row,
           the mask of the JAX decode's ``attn_chunk_lse`` at
           ``max_pos = enc_len - 1``.
``attn_chunk_lse`` and ``lse_combine`` are the JAX decode core in plain
torch; the port's decode path does not call them, the tests hold
``ops.flash_decode`` against them. Ring attention and the head-TP and
sequence-sharded branches are not ported yet.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers.common import apply_rope, dtype_of, normal
from repro_torch.sharding.dist import Dist
from repro_torch.sharding.plans import ShardingPlan

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# chunked flash attention core (plain torch)
# ---------------------------------------------------------------------------

def flash_attn(q, k, v, *, causal: bool, window: int = 0, q_offset=0,
               kv_offset=0, kv_len=None, chunk: int = 1024):
    """Online-softmax attention, chunked over KV.

    q: [B, Sq, H, hd]; k, v: [B, Sk, KH, hd] (H % KH == 0); offsets are the
    absolute positions of element 0; kv_len: valid kv positions (default
    Sk). Scores and values accumulate in f32 from the inputs' values, with
    p rounded to v's dtype, as the JAX core's f32-accumulating matmuls.
    Returns [B, Sq, H, hd]."""
    B, Sq, H, hd = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    g = H // KH
    scale = 1.0 / math.sqrt(hd)
    kv_len = Sk if kv_len is None else kv_len
    dev = q.device

    qr = q.reshape(B, Sq, KH, g, hd).permute(0, 2, 3, 1, 4).float()  # [B,KH,g,Sq,hd]
    pos_q = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, KH, g, Sq), NEG_INF, dtype=torch.float32, device=dev)
    lsum = torch.zeros((B, KH, g, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KH, g, Sq, hd), dtype=torch.float32, device=dev)
    ck = min(chunk, Sk)
    for c0 in range(0, Sk, ck):
        kc = k[:, c0:c0 + ck].permute(0, 2, 1, 3)                    # [B,KH,ck,hd]
        vc = v[:, c0:c0 + ck].permute(0, 2, 1, 3)
        pos_k = kv_offset + c0 + torch.arange(kc.shape[2], device=dev)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qr, kc.float()) * scale
        mask = pos_k[None, :] < kv_len
        if causal:
            mask = mask & (pos_k[None, :] <= pos_q[:, None])
        if window:
            mask = mask & (pos_q[:, None] - pos_k[None, :] < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        lsum = lsum * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def attn_chunk_lse(q, k, v, *, pos_k, max_pos):
    """Decode attention over one KV chunk, unnormalised, for a log-sum-exp
    combine. q: [B, H, hd]; k, v: [B, KH, S, hd]; pos_k: [S] absolute
    positions; max_pos: highest attendable position. Returns o [B, H, hd]
    f32, m [B, H], lsum [B, H]. q and p are rounded to the cache's dtype."""
    B, H, hd = q.shape
    KH = k.shape[1]
    g = H // KH
    scale = 1.0 / math.sqrt(hd)
    qr = q.reshape(B, KH, g, hd).to(k.dtype).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qr, k.float()) * scale
    mask = pos_k[None, None, None, :] <= max_pos
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    o = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, H, hd), m.reshape(B, H), p.sum(-1).reshape(B, H)


def lse_combine(o, m, lsum, axis, dist: Dist):
    """Merge partial attention (o, m, lsum) over a sharded KV axis."""
    if dist.size(axis) == 1:
        return o / torch.clamp(lsum, min=1e-30)[..., None]
    m_g = dist.pmax(m, axis)
    corr = torch.exp(m - m_g)
    l_g = dist.psum(lsum * corr, axis)
    o_g = dist.psum(o * corr[..., None], axis)
    return o_g / torch.clamp(l_g, min=1e-30)[..., None]


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def init_attention(cfg, plan: ShardingPlan, gen):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = dtype_of(cfg)
    sc = d ** -0.5
    return {
        "w_q": normal((d, H * hd), dt, gen, sc),
        "w_k": normal((d, KV, hd), dt, gen, sc),
        "w_v": normal((d, KV, hd), dt, gen, sc),
        "w_o": normal((H * hd, d), dt, gen, (H * hd) ** -0.5),
    }


def _replicated_only(plan: ShardingPlan, dist: Dist):
    if plan.attn_mode == "head_tp" and dist.size(plan.tp_axis) > 1:
        raise NotImplementedError("head_tp attention is not ported yet")


# ---------------------------------------------------------------------------
# prefill self-attention
# ---------------------------------------------------------------------------

def attention_fwd(params, x, cfg, plan: ShardingPlan, dist: Dist, *,
                  window: int = 0, make_cache: bool = False):
    """Causal self-attention, over the last `window` positions when
    `window` > 0. x: [B, S, D]. Returns (y [B, S, D], cache | None)."""
    _replicated_only(plan, dist)
    if dist.size(plan.seq_axis) > 1:
        raise NotImplementedError("sequence-sharded attention is not "
                                  "ported yet")
    H, hd = cfg.num_heads, cfg.head_dim
    B, s, _ = x.shape
    pos = torch.arange(s, device=x.device)

    cache = None
    if make_cache:
        k_c = torch.einsum("bsd,dkh->bksh", x, params["w_k"])
        v_c = torch.einsum("bsd,dkh->bksh", x, params["w_v"])
        k_c = apply_rope(k_c.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)
        if window:
            cache = _window_cache_from_prefill(k_c, v_c, window)
        else:
            cache = {"k": k_c.contiguous(), "v": v_c.contiguous()}

    q = (x @ params["w_q"]).reshape(B, s, H, hd)
    k = torch.einsum("bsd,dkh->bskh", x, params["w_k"])
    v = torch.einsum("bsd,dkh->bskh", x, params["w_v"])
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    o = flash_attn(q, k, v, causal=True, window=window)
    y = o.reshape(B, s, -1) @ params["w_o"]
    return y, cache


def _window_cache_from_prefill(k_c, v_c, window: int):
    """The ring-buffer cache of a sliding-window layer from the prefill's
    k, v [B, KV, S, hd]: `window` rows, position p at row p % window, only
    the last `window` positions kept, unwritten rows zero."""
    B, KV, S, hd = k_c.shape
    keep = torch.arange(max(S - window, 0), S, device=k_c.device)
    rows = keep % window
    ring = {}
    for name, c in (("k", k_c), ("v", v_c)):
        r = torch.zeros((B, KV, window, hd), dtype=c.dtype, device=c.device)
        r[:, :, rows] = c[:, :, keep]
        ring[name] = r
    return ring


# ---------------------------------------------------------------------------
# decode self-attention (KV cache)
# ---------------------------------------------------------------------------

def _positions(pos, B: int, device):
    """[B] int64 positions from a scalar (int / 0-d) or a [B] tensor."""
    p = torch.as_tensor(pos, device=device).long()
    return p.expand(B) if p.dim() == 0 else p


def attention_decode(params, x, cache, pos, cfg, plan: ShardingPlan,
                     dist: Dist, *, window: int = 0):
    """x: [B, 1, D]; cache k/v: [B, KV, S, hd] (a ring [B, KV, W, hd] when
    `window` > 0); pos: scalar or [B] positions of the incoming tokens.
    Returns (y [B, 1, D], cache) with the cache written in place."""
    _replicated_only(plan, dist)
    if dist.size(plan.kv_axis) > 1:
        raise NotImplementedError("sequence-sharded decode is not ported yet")
    H, hd = cfg.num_heads, cfg.head_dim
    B = x.shape[0]
    xt = x[:, 0]
    p = _positions(pos, B, x.device)                               # [B]

    q = (xt @ params["w_q"]).reshape(B, H, hd)
    q = apply_rope(q[:, None], p[:, None], cfg.rope_theta)[:, 0]
    k_new = torch.einsum("bd,dkh->bkh", xt, params["w_k"])
    v_new = torch.einsum("bd,dkh->bkh", xt, params["w_v"])
    k_new = apply_rope(k_new[:, None], p[:, None], cfg.rope_theta)[:, 0]

    k_c, v_c = cache["k"], cache["v"]
    S = k_c.shape[2]
    rows = torch.arange(B, device=x.device)
    if window:
        # ring: row pos % W is always in range, no clamp
        r = p % S
        k_c[rows, :, r] = k_new
        v_c[rows, :, r] = v_new
        length = torch.clamp(p + 1, max=S)
    else:
        # write at pos; a position past the cache writes its old row back
        # at the clamped slot (the JAX non-owner rule), so it changes nothing
        lc = torch.clamp(p, max=S - 1)
        in_range = (p < S)[:, None, None]
        k_c[rows, :, lc] = torch.where(in_range, k_new, k_c[rows, :, lc])
        v_c[rows, :, lc] = torch.where(in_range, v_new, v_c[rows, :, lc])
        length = p + 1

    o = kops.flash_decode(q.contiguous(), k_c, v_c, length.to(torch.int32))
    y = _decode_out_proj(o, params, plan, dist, B)
    return y, cache


def _decode_out_proj(o, params, plan: ShardingPlan, dist: Dist, B):
    """o: [B, H, hd] full heads; replicated W_o."""
    w_o = params["w_o"]
    y = o.reshape(B, -1).to(w_o.dtype) @ w_o
    return y[:, None, :]


# ---------------------------------------------------------------------------
# cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------

def _single_device(plan: ShardingPlan, dist: Dist):
    _replicated_only(plan, dist)
    if dist.size(plan.seq_axis) > 1 or dist.size(plan.kv_axis) > 1:
        raise NotImplementedError("sequence-sharded cross-attention is not "
                                  "ported yet")


def make_enc_cache(params, enc_out, cfg, plan: ShardingPlan, dist: Dist):
    """The decoder's read-only encoder k, v [B, KV, Se, hd] from enc_out
    [B, Se, D]."""
    k = torch.einsum("bsd,dkh->bksh", enc_out, params["w_k"])
    v = torch.einsum("bsd,dkh->bksh", enc_out, params["w_v"])
    return {"k": k.contiguous(), "v": v.contiguous()}


def cross_attention_fwd(params, x, enc_kv, cfg, plan: ShardingPlan,
                        dist: Dist):
    """Prefill cross-attention: x [B, S, D] decoder tokens against every
    position of enc_kv k, v [B, KV, Se, hd]. Returns y [B, S, D]."""
    _single_device(plan, dist)
    B, s, _ = x.shape
    q = (x @ params["w_q"]).reshape(B, s, -1, cfg.head_dim)
    o = flash_attn(q, enc_kv["k"].transpose(1, 2), enc_kv["v"].transpose(1, 2),
                   causal=False)
    return o.reshape(B, s, -1) @ params["w_o"]


def cross_attention_decode(params, x, enc_kv, enc_len: int, cfg,
                           plan: ShardingPlan, dist: Dist):
    """Decode cross-attention: x [B, 1, D] against the first `enc_len`
    positions of enc_kv k, v [B, KV, Se, hd], every row alike. Returns
    y [B, 1, D]."""
    _single_device(plan, dist)
    if enc_len < 1:
        raise ValueError(f"cross-attention decode over enc_len {enc_len}")
    B = x.shape[0]
    q = (x[:, 0] @ params["w_q"]).reshape(B, -1, cfg.head_dim)
    o = kops.flash_decode(q.contiguous(), enc_kv["k"], enc_kv["v"], enc_len)
    return _decode_out_proj(o, params, plan, dist, B)
