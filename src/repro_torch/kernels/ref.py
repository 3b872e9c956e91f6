"""Plain PyTorch versions of every kernel: what each computes, the
allclose reference on the card, and what the wrappers run on CPU tensors.
They keep the JAX oracles' arithmetic (``repro.kernels.ref``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def moe_gmm_ref(x, w_gate, w_up, w_down):
    """Grouped expert SwiGLU FFN.
    x: [E, T, D]; w_gate/w_up: [E, D, F]; w_down: [E, F, D] -> [E, T, D].
    silu in f32, rounded to x.dtype, then multiplied by u (the oracle's
    rounding, not the kernel's)."""
    g = torch.einsum("etd,edf->etf", x, w_gate)
    u = torch.einsum("etd,edf->etf", x, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.einsum("etf,efd->etd", h, w_down)


def moe_gmm_active_tiles_ref(x, tile: int):
    """The tensor-core kernel's skip: x [E, T, D] in token tiles of `tile`
    rows -> live [E, ceil(T / tile)] bool, True where the tile holds a
    nonzero element (-0 is zero). A dead tile's rows of ``moe_gmm_ref`` are
    exact zeros (silu(0) * 0 = 0). The kernel skips ``(~live).sum()`` tiles
    and ``(~live.any(1)).sum()`` experts."""
    e, t, d = x.shape
    ntt = -(-t // tile)
    rows = torch.zeros((e, ntt * tile, d), dtype=torch.bool, device=x.device)
    rows[:, :t] = x != 0
    return rows.reshape(e, ntt, tile * d).any(-1)


def flash_decode_ref(q, k, v, length):
    """Single-token decode attention, math in f32.
    q: [B, H, hd]; k/v: [B, KH, S, hd]; length: int, 0-d tensor or [B] int
    tensor — number of valid positions (per slot). Returns [B, H, hd] in
    q's dtype."""
    B, H, hd = q.shape
    KH, S = k.shape[1], k.shape[2]
    g = H // KH
    qr = q.reshape(B, KH, g, hd).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qr, k.float()) / math.sqrt(hd)
    length = torch.as_tensor(length, device=q.device).reshape(-1, 1)
    mask = torch.arange(S, device=q.device)[None, :] < length     # [B|1, S]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


def attn_chunk_lse(q, k, v, *, pos_k, max_pos):
    """Decode attention over one KV chunk, unnormalised, for a log-sum-exp
    combine (the JAX decode core, ``attention.attn_chunk_lse``).
    q: [B, H, hd]; k, v: [B, KH, S, hd]; pos_k: [S] absolute positions;
    max_pos: highest attendable position, an int or a [B] tensor (one per
    slot). Returns o [B, H, hd] f32, m [B, H] (NEG_INF where nothing is
    attendable), lsum [B, H]. q and p are rounded to the cache's dtype."""
    B, H, hd = q.shape
    KH = k.shape[1]
    g = H // KH
    scale = 1.0 / math.sqrt(hd)
    qr = q.reshape(B, KH, g, hd).to(k.dtype).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qr, k.float()) * scale
    max_pos = torch.as_tensor(max_pos, device=q.device).reshape(-1, 1, 1, 1)
    mask = pos_k[None, None, None, :] <= max_pos
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    o = torch.einsum("bhgs,bhsd->bhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, H, hd), m.reshape(B, H), p.sum(-1).reshape(B, H)


def flash_decode_lse_ref(q, k, v, length):
    """The (o, m, l) form of ``flash_decode_ref``: ``attn_chunk_lse`` over
    the first `length` positions of each slot (an int, 0-d or [B] tensor).
    Returns o f32 [B, H, hd], m and l f32 [B, H]."""
    pos_k = torch.arange(k.shape[2], device=q.device)
    length = torch.as_tensor(length, device=q.device)
    return attn_chunk_lse(q, k, v, pos_k=pos_k, max_pos=length - 1)


def moe_gmm_bwd_ref(x, w_gate, w_up, w_down, dy):
    """The gradient of ``moe_gmm_ref`` as written: dy [E, T, D] ->
    (dx, dw_gate, dw_up, dw_down), each in its input's shape and dtype.
    g and u are recomputed from x, not saved by the forward; the cast
    chain of the forward (silu in f32, rounded to x.dtype, times u) is
    transposed step by step, as autodiff of the oracle does."""
    g = torch.einsum("etd,edf->etf", x, w_gate)
    u = torch.einsum("etd,edf->etf", x, w_up)
    gf = g.float()
    sig = torch.sigmoid(gf)
    a = F.silu(gf).to(x.dtype)                          # the forward's h / u
    dw_down = torch.einsum("etf,etd->efd", a * u, dy)
    dh = torch.einsum("etd,efd->etf", dy, w_down)
    du = dh * a
    dg = ((dh * u).float() * (sig * (1 + gf * (1 - sig)))).to(x.dtype)
    dx = torch.einsum("etf,edf->etd", dg, w_gate) \
        + torch.einsum("etf,edf->etd", du, w_up)
    dw_gate = torch.einsum("etd,etf->edf", x, dg)
    dw_up = torch.einsum("etd,etf->edf", x, du)
    return dx, dw_gate, dw_up, dw_down
