"""RWKV6 ("Finch") block, rwkv6-1.6b's sequence mixer and channel mix.

Port of the single-device path of ``repro.models.layers.rwkv``. Per head,
the WKV recurrence over a matrix state s [hd, hd] is

  out_t = r_t . (s_{t-1} + (u * k_t) v_t^T)
  s_t   = diag(w_t) s_{t-1} + k_t v_t^T

with a data-dependent decay w_t = exp(-exp(decay_t)) in (0, 1). As in the
JAX layer, the token-shift mix is one learned interpolation per stream and
the output gate is SiLU. The decode cache is the time mix's ``wkv`` state
[B, nh, hd, hd] in float32 and ``shift`` [B, D] (the previous token's
input), and the channel mix's own ``shift`` [B, D]; all three are
recurrent, so speculative decoding rolls them back from copies
(``serving/kvcache.py``).

Sharded (one rank's shards, as inside JAX's ``shard_map``), the WKV heads
are independent, so the time mix is head-parallel over ``plan.tp_axis``
(Megatron-SP): x is all-gathered over the sequence, the column-sharded
``w_r``, ``w_k``, ``w_v``, ``w_g`` and ``decay_lora_b`` give this rank's
heads (``decay_lora_a`` is replicated and contracts the whole model width,
so the LoRA has no partial sum), the whole-sequence scan runs on them, and
the row-sharded ``w_o`` product is reduce-scattered over the sequence;
the channel mix is a tensor-parallel FFN over d_ff the same way. In
decode the token is replicated over tp and the row-sharded products are
psummed. No sum feeds a rank's own shard, so no ``psum_for_shards``. The
wkv cache is this rank's heads [B, nh_loc, hd, hd]; both shifts are
replicated over tp.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers.common import dtype_of, normal
from repro_torch.models.layers.mamba import _scan_chunk
from repro_torch.sharding.dist import Dist
from repro_torch.sharding.plans import ShardingPlan


def _dims(cfg):
    """(WKV heads, head dim)."""
    hd = cfg.rwkv.head_dim
    return cfg.d_model // hd, hd


def _local_heads(params, hd: int) -> int:
    """This rank's WKV heads: its columns of ``w_r`` over the head dim."""
    return params["w_r"].shape[-1] // hd


def init_rwkv_tm(cfg, plan: ShardingPlan, gen):
    """Time-mix params; ``decay_base`` and ``bonus`` float32 in any model
    dtype, as in the JAX layer."""
    d = cfg.d_model
    dt = dtype_of(cfg)
    dev = gen.device
    sc = d ** -0.5
    lora = max(32, d // 64)
    return {
        "mix": torch.full((4, d), 0.5, dtype=dt, device=dev),   # r, k, v, w
        "w_r": normal((d, d), dt, gen, sc),
        "w_k": normal((d, d), dt, gen, sc),
        "w_v": normal((d, d), dt, gen, sc),
        "w_g": normal((d, d), dt, gen, sc),
        "decay_lora_a": normal((d, lora), dt, gen, sc),
        "decay_lora_b": normal((lora, d), dt, gen, lora ** -0.5),
        "decay_base": torch.full((d,), -4.0, dtype=torch.float32, device=dev),
        "bonus": torch.zeros((d,), dtype=torch.float32, device=dev),
        "w_o": normal((d, d), dt, gen, sc),
    }


def init_rwkv_cm(cfg, plan: ShardingPlan, gen):
    """Channel-mix params (a relu^2 FFN)."""
    d, dff = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg)
    return {
        "mix": torch.full((d,), 0.5, dtype=dt, device=gen.device),
        "w_in": normal((d, dff), dt, gen, d ** -0.5),
        "w_out": normal((dff, d), dt, gen, dff ** -0.5),
    }


def _wkv_scan(r, k, v, w, u, s0, chunk: int = 64):
    """WKV recurrence. r, k, v, w: [B, S, nh, hd] float32 (w the decay in
    (0, 1)); u: [nh, hd]; s0: [B, nh, hd, hd]. Returns (out [B, S, nh, hd],
    s_final). Chunks of `chunk` steps, the tail chunk padded as in JAX
    (w = 1, zeros elsewhere: the state passes through unchanged). Within a
    chunk, ``mamba._scan_chunk`` composes s -> diag(w_t) s + k_t v_t^T by
    doubling (w broadcast over the value dim), so no op runs per token;
    across chunks a loop carries the state. The inclusive states of one
    chunk, [B, chunk, nh, hd, hd] in float32, are ~34 MB at rwkv6-1.6b's
    32 heads of 64 and B = 1."""
    B, S, nh, hd = r.shape
    ck = min(chunk, S)
    pad = (-S) % ck
    if pad:
        z = (0, 0, 0, 0, 0, pad)
        r, k, v = F.pad(r, z), F.pad(k, z), F.pad(v, z)
        w = F.pad(w, z, value=1.0)
    s, outs = s0, []
    for c0 in range(0, S + pad, ck):
        r_c, k_c, v_c = r[:, c0:c0 + ck], k[:, c0:c0 + ck], v[:, c0:c0 + ck]
        kv = k_c[..., :, None] * v_c[..., None, :]                 # [B,ck,nh,hd,hd]
        a_cum, b_cum = _scan_chunk(w[:, c0:c0 + ck, ..., None], kv)
        s_incl = a_cum * s[:, None] + b_cum                        # s_t, t in chunk
        # out_t reads the state before step t: the carried state first
        s_prev = torch.cat([s[:, None], s_incl[:, :-1]], dim=1)
        outs.append(torch.einsum("bthk,bthkd->bthd", r_c,
                                 s_prev + u[..., None] * kv))
        s = s_incl[:, -1]
    return torch.cat(outs, dim=1)[:, :S], s


def _tm_inputs(params, xg, x_prev, nh, hd):
    """The r, k, v, g, w streams from the token-shifted input, as the JAX
    ``_tm_inputs``: g from the same mixed stream as v; r, k, v, w float32
    heads [B, S, nh, hd], g [B, S, D] in x's dtype."""
    mix = params["mix"].float()
    xf, pf = xg.float(), x_prev.float()

    def mixed(i):
        return (xf * mix[i] + pf * (1 - mix[i])).to(xg.dtype)

    r = mixed(0) @ params["w_r"]
    k = mixed(1) @ params["w_k"]
    v = mixed(2) @ params["w_v"]
    g = mixed(2) @ params["w_g"]
    decay = (mixed(3) @ params["decay_lora_a"]) @ params["decay_lora_b"]
    w = torch.exp(-torch.exp(decay.float() + params["decay_base"]))
    B, S = xg.shape[0], xg.shape[1]

    def heads(x):
        return x.reshape(B, S, nh, hd).float()

    return heads(r), heads(k), heads(v), g, heads(w)


def _gated_out(params, out, g, dtype):
    """SiLU(g)-gated WKV output through ``w_o``."""
    B, S = g.shape[0], g.shape[1]
    out = (out.reshape(B, S, -1) * F.silu(g.float())).to(dtype)
    return out @ params["w_o"]


def rwkv_tm_fwd(params, x, cfg, plan: ShardingPlan, dist: Dist, *,
                make_cache: bool = False):
    """Time mix. x: [B, S_loc, D], this rank's positions (all of them on
    one device). Returns (y [B, S_loc, D], {"wkv", "shift"} | None)."""
    _, hd = _dims(cfg)
    nh = _local_heads(params, hd)
    seq_ax = plan.seq_axis
    B = x.shape[0]
    xg = dist.all_gather(x, seq_ax, dim=1)                         # [B, S, D]
    x_prev = F.pad(xg, (0, 0, 1, 0))[:, :-1]
    r, k, v, g, w = _tm_inputs(params, xg, x_prev, nh, hd)
    u = params["bonus"].float().reshape(nh, hd)
    s0 = torch.zeros((B, nh, hd, hd), dtype=torch.float32, device=x.device)
    out, s_fin = _wkv_scan(r, k, v, w, u, s0)
    y = dist.reduce_scatter(_gated_out(params, out, g, x.dtype), seq_ax, dim=1)
    cache = {"wkv": s_fin, "shift": xg[:, -1].clone()} if make_cache else None
    return y, cache


def rwkv_tm_decode(params, x, cache, cfg, plan: ShardingPlan, dist: Dist):
    """x: [B, 1, D] (replicated over tp); cache: wkv [B, nh_loc, hd, hd]
    f32, shift [B, D]. One step of the recurrence on this rank's heads, the
    row-sharded output psummed over tp. Returns (y [B, 1, D], cache) with
    the cache written in place."""
    _, hd = _dims(cfg)
    nh = _local_heads(params, hd)
    xt = x[:, 0]
    r, k, v, g, w = _tm_inputs(params, x, cache["shift"][:, None], nh, hd)
    r, k, v, w = r[:, 0], k[:, 0], v[:, 0], w[:, 0]                # [B, nh, hd]
    u = params["bonus"].float().reshape(nh, hd)
    s = cache["wkv"]
    kv = k[..., :, None] * v[..., None, :]
    out = torch.einsum("bhk,bhkd->bhd", r, s + u[..., None] * kv)
    s_new = w[..., None] * s + kv
    y = dist.psum(_gated_out(params, out[:, None], g, x.dtype), plan.tp_axis)
    cache["wkv"].copy_(s_new)
    cache["shift"].copy_(xt)
    return y, cache


def _channel_mix(params, x, x_prev):
    mix = params["mix"].float()
    mixed = (x.float() * mix + x_prev.float() * (1 - mix)).to(x.dtype)
    h = torch.square(F.relu((mixed @ params["w_in"]).float()))
    return h.to(x.dtype) @ params["w_out"]


def rwkv_cm_fwd(params, x, plan: ShardingPlan, dist: Dist, *,
                make_cache: bool = False):
    """Channel mix. x: [B, S_loc, D], sequence-sharded (all-gathered
    before, the d_ff partials reduce-scattered after), or [B, T, D]
    replicated over tp (the partials psummed), as the JAX function. Returns
    (y, {"shift"} | None)."""
    seq_ax = plan.seq_axis
    seq_sharded = dist.size(seq_ax) > 1
    xg = dist.all_gather(x, seq_ax, dim=1) if seq_sharded else x
    y = _channel_mix(params, xg, F.pad(xg, (0, 0, 1, 0))[:, :-1])
    y = dist.reduce_scatter(y, seq_ax, dim=1) if seq_sharded \
        else dist.psum(y, plan.tp_axis)
    return y, ({"shift": xg[:, -1].clone()} if make_cache else None)


def rwkv_cm_decode(params, x, cache, plan: ShardingPlan, dist: Dist):
    """x: [B, 1, D] (replicated over tp); cache: shift [B, D], written in
    place. The d_ff partials are psummed over tp."""
    y = dist.psum(_channel_mix(params, x, cache["shift"][:, None]), plan.tp_axis)
    cache["shift"].copy_(x[:, 0])
    return y, cache
