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
Sharded (one rank's shards, as inside JAX's ``shard_map``):
  prefill  tokens sequence-sharded over ``plan.seq_axis``. ``head_tp``:
           all-gather x over the sequence, q on this rank's heads, k/v on
           the KV heads they map to (``_local_kv_slice``), attention over
           the whole sequence, the row-sharded W_o, then a reduce-scatter
           that sums the head partials and scatters the sequence
           (Megatron-SP). ``replicated``: q stays local, k/v are
           all-gathered. The cache holds every KV head for the local
           positions; a window layer's ring is assembled across ranks
           (``_window_cache_from_prefill``).
  decode   the token replicated over tp; q gathered to every head under
           ``head_tp``. A full-attention cache is sequence-sharded over
           ``plan.kv_axis``: only the rank owning ``pos`` writes the new
           row (the others write their old row back), each rank attends
           over its shard through ``ops.flash_decode_lse`` (the (o, m, l)
           kernel on the card), and ``lse_combine`` merges the ranks. W_o
           is row-sharded under ``head_tp``: each rank projects its heads
           and a psum adds them (``_decode_out_proj``).
  ring     ``plan.ring_attn`` under ``head_tp`` (train and prefill, full
           attention layers): q, k, v from the rank's own positions, the
           K/V chunks rotating around the sequence ring (``ring_attention``)
           in place of the all-gather of x. The head-sharded W_q and W_o are
           all-gathered over the tp axis first, so that each rank attends
           with every query head against every KV head of the chunk in
           hand, and no reduction mixes positions. The JAX path keeps W_q
           head-sharded while the sequence is sharded over the same axis:
           the chunk arriving from rank r' is used with this rank's KV
           slice as if it were r''s, and its final psum over tp adds the
           head partials of different position chunks (ROADMAP queue 3).
  cross    ``cross_attention_fwd`` over the sequence-sharded encoder cache
           (k, v all-gathered; under ``head_tp`` x too, the rank's heads,
           the row-sharded W_o reduce-scattered), ``cross_attention_decode``
           over a cache sequence-sharded over ``plan.kv_axis`` through
           ``ops.flash_decode_lse`` and ``lse_combine``, as the self
           decode.
``attn_chunk_lse`` (``kernels.ref``) is the JAX decode core, and the plain
version of ``ops.flash_decode_lse``.
"""
from __future__ import annotations

import math

import torch

from repro_torch import tracing
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import attn_chunk_lse  # noqa: F401  (the JAX decode core)
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


def ring_attention(q, k, v, *, seq_ax, dist: Dist, causal: bool = True):
    """Attention of this rank's queries over the whole sequence, the KV
    chunks rotating around the `seq_ax` ring. q: [B, Sq_loc, H, hd], the
    rank's positions, every head; k, v: [B, Sk_loc, KH, hd], the rank's
    positions, every KV head. At step s the chunk in hand came from rank
    (r - s) mod n; an online softmax over the steps accumulates in f32 as
    ``flash_attn`` does, fully future chunks masked. Returns
    [B, Sq_loc, H * hd]."""
    B, sq, H, hd = q.shape
    sk, KH = k.shape[1], k.shape[2]
    n = dist.size(seq_ax)
    if n == 1:
        return flash_attn(q, k, v, causal=causal).reshape(B, sq, H * hd)
    r = dist.index(seq_ax)
    g = H // KH
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    pos_q = r * sq + torch.arange(sq, device=dev)
    qr = q.reshape(B, sq, KH, g, hd).permute(0, 2, 3, 1, 4).float()  # [B,KH,g,Sq,hd]
    m = torch.full((B, KH, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    lsum = torch.zeros((B, KH, g, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KH, g, sq, hd), dtype=torch.float32, device=dev)
    kc, vc = k, v
    for step in range(n):
        pos_k = ((r - step) % n) * sk + torch.arange(sk, device=dev)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qr,
                         kc.permute(0, 2, 1, 3).float()) * scale
        mask = pos_k[None, :] <= pos_q[:, None] if causal else \
            torch.ones((sq, sk), dtype=torch.bool, device=dev)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        lsum = lsum * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(v.dtype).float(),
            vc.permute(0, 2, 1, 3).float())
        m = m_new
        if step < n - 1:
            kc = dist.roll(kc, seq_ax, shift=1)
            vc = dist.roll(vc, seq_ax, shift=1)
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, sq, H * hd).to(q.dtype)


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


def _local_kv_slice(cfg, plan: ShardingPlan, dist: Dist):
    """(first KV head, KV head count) that this rank's q heads map to under
    head_tp."""
    tp = dist.size(plan.tp_axis)
    H, KV = cfg.num_heads, cfg.num_kv_heads
    h_loc = H // tp
    kv_loc = max(1, (KV * h_loc) // H)
    start = (dist.index(plan.tp_axis) * h_loc * KV) // H
    return start, kv_loc


# ---------------------------------------------------------------------------
# prefill self-attention
# ---------------------------------------------------------------------------

def attention_fwd(params, x, cfg, plan: ShardingPlan, dist: Dist, *,
                  window: int = 0, make_cache: bool = False):
    """Causal self-attention, over the last `window` positions when
    `window` > 0. x: [B, S_loc, D], this rank's positions (all of them on
    one device). Returns (y [B, S_loc, D], cache | None)."""
    with tracing.span("attn"):
        H, hd = cfg.num_heads, cfg.head_dim
        seq_ax = plan.seq_axis
        B, s_loc, _ = x.shape
        q_offset = dist.index(seq_ax) * s_loc
        pos_local = q_offset + torch.arange(s_loc, device=x.device)

        cache = None
        if make_cache:
            # every KV head, this rank's positions: the decode layout
            k_c = torch.einsum("bsd,dkh->bksh", x, params["w_k"])
            v_c = torch.einsum("bsd,dkh->bksh", x, params["w_v"])
            k_c = apply_rope(k_c.transpose(1, 2), pos_local,
                             cfg.rope_theta).transpose(1, 2)
            if window:
                cache = _window_cache_from_prefill(k_c, v_c, window, plan, dist)
            else:
                cache = {"k": k_c.contiguous(), "v": v_c.contiguous()}

        if plan.attn_mode == "head_tp":
            if plan.ring_attn and window == 0 and dist.size(seq_ax) > 1:
                return _ring_fwd(params, x, cfg, plan, dist, pos_local), cache
            xg = dist.all_gather(x, seq_ax, dim=1)                     # [B, S, D]
            S = xg.shape[1]
            q = (xg @ params["w_q"]).reshape(B, S, -1, hd)             # local heads
            start, kv_loc = _local_kv_slice(cfg, plan, dist)
            k = torch.einsum("bsd,dkh->bskh", xg, params["w_k"][:, start:start + kv_loc])
            v = torch.einsum("bsd,dkh->bskh", xg, params["w_v"][:, start:start + kv_loc])
            pos = torch.arange(S, device=x.device)
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
            o = flash_attn(q, k, v, causal=True, window=window)
            # W_o is row-sharded over heads: the reduce-scatter sums the head
            # partials and scatters the sequence in one collective
            y = o.reshape(B, S, -1) @ params["w_o"]
            return dist.reduce_scatter(y, seq_ax, dim=1), cache

        q = (x @ params["w_q"]).reshape(B, s_loc, H, hd)
        k = torch.einsum("bsd,dkh->bskh", x, params["w_k"])
        v = torch.einsum("bsd,dkh->bskh", x, params["w_v"])
        q = apply_rope(q, pos_local, cfg.rope_theta)
        k = apply_rope(k, pos_local, cfg.rope_theta)
        k = dist.all_gather(k, seq_ax, dim=1)                          # [B, S, KV, hd]
        v = dist.all_gather(v, seq_ax, dim=1)
        o = flash_attn(q, k, v, causal=True, window=window, q_offset=q_offset)
        y = o.reshape(B, s_loc, -1) @ params["w_o"]
        return y, cache


def _ring_fwd(params, x, cfg, plan: ShardingPlan, dist: Dist, pos_local):
    """The ring path of ``attention_fwd``: W_q (columns) and W_o (rows)
    gathered over the tp axis to every head, q, k, v of the rank's
    positions, ``ring_attention``, and the whole output projection: y of
    the rank's positions, no reduction."""
    B, s_loc, _ = x.shape
    w_q = dist.all_gather(params["w_q"], plan.tp_axis, dim=1)
    w_o = dist.all_gather(params["w_o"], plan.tp_axis, dim=0)
    q = (x @ w_q).reshape(B, s_loc, cfg.num_heads, cfg.head_dim)
    k = torch.einsum("bsd,dkh->bskh", x, params["w_k"])
    v = torch.einsum("bsd,dkh->bskh", x, params["w_v"])
    q = apply_rope(q, pos_local, cfg.rope_theta)
    k = apply_rope(k, pos_local, cfg.rope_theta)
    o = ring_attention(q, k, v, seq_ax=plan.seq_axis, dist=dist)
    return o @ w_o


def _window_cache_from_prefill(k_c, v_c, window: int, plan: ShardingPlan,
                               dist: Dist):
    """The ring-buffer cache of a sliding-window layer from the prefill's
    k, v [B, KV, S_loc, hd] of this rank's positions: `window` rows,
    position p at row p % window, only the last `window` global positions
    kept, unwritten rows zero. Each rank adds its positions' rows and a
    psum over the sequence axis assembles the ring on every rank."""
    B, KV, s_loc, hd = k_c.shape
    seq_ax = plan.seq_axis
    S = s_loc * dist.size(seq_ax)
    pos = dist.index(seq_ax) * s_loc + torch.arange(s_loc, device=k_c.device)
    keep = pos >= S - window
    ring = {}
    for name, c in (("k", k_c), ("v", v_c)):
        r = torch.zeros((B, KV, window, hd), dtype=c.dtype, device=c.device)
        r[:, :, pos[keep] % window] = c[:, :, keep]
        ring[name] = dist.psum(r, seq_ax)
    return ring


# ---------------------------------------------------------------------------
# decode self-attention (KV cache)
# ---------------------------------------------------------------------------

def _positions(pos, B: int, device):
    """[B] int64 positions from a scalar (int / 0-d) or a [B] tensor."""
    p = torch.as_tensor(pos, device=device).long()
    return p.expand(B) if p.dim() == 0 else p


def _head_tp(plan: ShardingPlan, dist: Dist) -> bool:
    return plan.attn_mode == "head_tp" and dist.size(plan.tp_axis) > 1


def attention_decode(params, x, cache, pos, cfg, plan: ShardingPlan,
                     dist: Dist, *, window: int = 0):
    """x: [B, 1, D] (replicated over tp); cache k/v: [B, KV, S_loc, hd]
    (sequence-sharded over ``plan.kv_axis``; a ring [B, KV, W, hd] when
    `window` > 0); pos: scalar or [B] positions of the incoming tokens.
    Returns (y [B, 1, D], cache) with the cache written in place."""
    with tracing.span("attn"):
        hd = cfg.head_dim
        B = x.shape[0]
        xt = x[:, 0]
        p = _positions(pos, B, x.device)                               # [B]

        q = (xt @ params["w_q"]).reshape(B, -1, hd)
        if _head_tp(plan, dist):
            q = dist.all_gather(q, plan.tp_axis, dim=1)               # [B, H, hd]
        q = apply_rope(q[:, None], p[:, None], cfg.rope_theta)[:, 0].contiguous()
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
            o = kops.flash_decode(q, k_c, v_c, torch.clamp(p + 1, max=S).to(torch.int32))
            return _decode_out_proj(o, params, plan, dist, B), cache

        # write at pos on the rank whose shard holds it; every other rank (and a
        # position past the cache) writes its old row back at the clamped slot
        local = p - dist.index(plan.kv_axis) * S
        lc = torch.clamp(local, 0, S - 1)
        in_range = ((local >= 0) & (local < S))[:, None, None]
        k_c[rows, :, lc] = torch.where(in_range, k_new, k_c[rows, :, lc])
        v_c[rows, :, lc] = torch.where(in_range, v_new, v_c[rows, :, lc])
        length = torch.clamp(local + 1, 0, S).to(torch.int32)
        if dist.size(plan.kv_axis) > 1:
            o, m, lsum = kops.flash_decode_lse(q, k_c, v_c, length)
            o = lse_combine(o, m, lsum, plan.kv_axis, dist)
        else:
            o = kops.flash_decode(q, k_c, v_c, length)
        return _decode_out_proj(o, params, plan, dist, B), cache


def _decode_out_proj(o, params, plan: ShardingPlan, dist: Dist, B):
    """o: [B, H, hd], every head on every rank; under head_tp W_o holds
    this rank's heads' rows, so the rank projects its heads and a psum over
    tp adds the partials."""
    w_o = params["w_o"]
    o = o.reshape(B, -1)
    if _head_tp(plan, dist):
        hh_loc = w_o.shape[0]
        r = dist.index(plan.tp_axis)
        y = dist.psum(o[:, r * hh_loc:(r + 1) * hh_loc].to(w_o.dtype) @ w_o,
                      plan.tp_axis)
    else:
        y = o.to(w_o.dtype) @ w_o
    return y[:, None, :]


# ---------------------------------------------------------------------------
# cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------

def make_enc_cache(params, enc_out, cfg, plan: ShardingPlan, dist: Dist):
    """The decoder's read-only encoder k, v [B, KV, Se_loc, hd] from enc_out
    [B, Se_loc, D] (sequence-sharded: this rank's positions), every KV
    head (W_k, W_v are replicated)."""
    k = torch.einsum("bsd,dkh->bksh", enc_out, params["w_k"])
    v = torch.einsum("bsd,dkh->bksh", enc_out, params["w_v"])
    return {"k": k.contiguous(), "v": v.contiguous()}


def cross_attention_fwd(params, x, enc_kv, cfg, plan: ShardingPlan,
                        dist: Dist):
    """Prefill cross-attention: x [B, S_loc, D] decoder tokens against every
    encoder position, enc_kv k, v [B, KV, Se_loc, hd] sequence-sharded over
    ``plan.seq_axis`` (all of it on one device); not causal. Returns
    y [B, S_loc, D]. Under ``head_tp`` (Megatron-SP): x all-gathered over
    the sequence, q on this rank's heads, k and v all-gathered over the
    sequence with every KV head and then cut to the heads this rank's q
    heads map to (``_local_kv_slice``), the row-sharded W_o, and a
    reduce-scatter that sums the head partials and scatters the sequence.
    The JAX function cuts the KV heads before the gather over the same
    axis, so that each position chunk arrives with its sender's heads
    (ROADMAP queue 3). Replicated: q of the local positions, k and v
    all-gathered."""
    hd = cfg.head_dim
    B, s_loc, _ = x.shape
    seq_ax = plan.seq_axis
    k = dist.all_gather(enc_kv["k"].transpose(1, 2), seq_ax, dim=1)   # [B, Se, KV, hd]
    v = dist.all_gather(enc_kv["v"].transpose(1, 2), seq_ax, dim=1)
    if _head_tp(plan, dist):
        xg = dist.all_gather(x, seq_ax, dim=1)                         # [B, S, D]
        q = (xg @ params["w_q"]).reshape(B, xg.shape[1], -1, hd)      # local heads
        start, kv_loc = _local_kv_slice(cfg, plan, dist)
        o = flash_attn(q, k[:, :, start:start + kv_loc], v[:, :, start:start + kv_loc],
                       causal=False)
        y = o.reshape(B, xg.shape[1], -1) @ params["w_o"]              # head partials
        return dist.reduce_scatter(y, seq_ax, dim=1)
    q = (x @ params["w_q"]).reshape(B, s_loc, -1, hd)
    o = flash_attn(q, k, v, causal=False)
    return o.reshape(B, s_loc, -1) @ params["w_o"]


def cross_attention_decode(params, x, enc_kv, enc_len: int, cfg,
                           plan: ShardingPlan, dist: Dist):
    """Decode cross-attention: x [B, 1, D] (replicated over tp) against the
    first `enc_len` encoder positions, every row alike; enc_kv k, v
    [B, KV, Se_loc, hd] sequence-sharded over ``plan.kv_axis``. Under
    ``head_tp`` q is gathered to every head. On a sharded cache each rank
    attends over its shard through ``ops.flash_decode_lse`` (the (o, m, l)
    kernel on the card), with the rank's share of `enc_len` as every
    row's length, and ``lse_combine`` merges the ranks; one device runs
    ``ops.flash_decode``. Returns y [B, 1, D] (``_decode_out_proj``)."""
    if enc_len < 1:
        raise ValueError(f"cross-attention decode over enc_len {enc_len}")
    B = x.shape[0]
    q = (x[:, 0] @ params["w_q"]).reshape(B, -1, cfg.head_dim)
    if _head_tp(plan, dist):
        q = dist.all_gather(q, plan.tp_axis, dim=1)                   # [B, H, hd]
    q = q.contiguous()
    if dist.size(plan.kv_axis) > 1:
        s_loc = enc_kv["k"].shape[2]
        length = min(max(enc_len - dist.index(plan.kv_axis) * s_loc, 0), s_loc)
        o, m, lsum = kops.flash_decode_lse(q, enc_kv["k"], enc_kv["v"], length)
        o = lse_combine(o, m, lsum, plan.kv_axis, dist)
    else:
        o = kops.flash_decode(q, enc_kv["k"], enc_kv["v"], enc_len)
    return _decode_out_proj(o, params, plan, dist, B)
