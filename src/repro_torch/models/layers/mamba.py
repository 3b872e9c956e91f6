"""Mamba-1 block, jamba's sequence mixer.

Port of ``repro.models.layers.mamba``: in projection, depthwise causal
conv over the sequence, chunked selective scan in f32, gated out
projection. The decode cache is the conv tail ``conv`` [B, d_conv - 1,
d_inner] in the model's dtype and the SSM state ``ssm`` [B, d_inner,
d_state] in float32; both are recurrent (order dependent), so
speculative decoding rolls them back from copies (``serving/kvcache.py``).
A prefill must see the prompt unpadded: a pad token changes the state.

Under a sharded plan, Megatron-SP as in JAX: d_inner is tensor-parallel
over ``plan.tp_axis`` (the scan's channels are independent), so the
forward all-gathers x over the sequence, runs the column-sharded in
projections, the conv and the whole sequence's scan on the rank's
d_inner, and reduce-scatters the row-sharded out projection over the
sequence; decode psums its output over tp. The caches keep each rank's
d_inner (conv [B, d_conv - 1, di_loc], ssm [B, di_loc, d_state]), so a
prefill's cache is already in its decode layout. Where the port departs
from JAX: B, C and the step sizes' low-rank input are products over
d_inner (``uc @ w_bc``, ``uc @ w_dt_in``, rows sharded over tp), and the
port sums them over tp (``Dist.psum_for_shards``, whose backward sums
the cotangents too); JAX uses each rank's partial sum, so its sharded
Mamba is not its single device's (ROADMAP queue 3).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.models.layers.common import dtype_of, normal
from repro_torch.sharding.dist import Dist
from repro_torch.sharding.plans import ShardingPlan


def _dims(cfg):
    """(d_inner, dt_rank, d_state, d_conv); dt_rank 0 means ceil(d/16)."""
    mc = cfg.mamba
    di = mc.expand * cfg.d_model
    dtr = mc.dt_rank or -(-cfg.d_model // 16)
    return di, dtr, mc.d_state, mc.d_conv


def init_mamba(cfg, plan: ShardingPlan, gen):
    d = cfg.d_model
    di, dtr, ds, dc = _dims(cfg)
    dt = dtype_of(cfg)
    dev = gen.device
    sc = d ** -0.5
    return {
        "w_x": normal((d, di), dt, gen, sc),
        "w_z": normal((d, di), dt, gen, sc),
        "conv_w": normal((dc, di), dt, gen, 0.2),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "w_bc": normal((di, 2 * ds), dt, gen, di ** -0.5),
        "w_dt_in": normal((di, dtr), dt, gen, di ** -0.5),
        "w_dt": normal((dtr, di), dt, gen, dtr ** -0.5),
        "dt_bias": torch.full((di,), -4.6, dtype=dt, device=dev),  # softplus^-1(0.01)
        # float32 whatever the model's dtype, as in the JAX layer
        "log_a": torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                        device=dev)).repeat(di, 1),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "w_out": normal((di, d), dt, gen, di ** -0.5),
    }


def _scan_chunk(a, b):
    """Inclusive scan of h -> a_t * h + b_t along dim 1, by doubling:
    log2(ck) steps of whole-tensor ops. a, b: [B, ck, di, ds]. Returns
    (a_cum, b_cum) with h_t = a_cum[t] * h_in + b_cum[t]."""
    ck = a.shape[1]
    d = 1
    while d < ck:
        # element t combines with element t - d: (a', b') . (a, b)
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], b_prev * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a_prev * a[:, d:]], dim=1)
        d *= 2
    return a, b


def _ssm_scan(u, dt_, b, c, log_a, d_skip, h0, chunk: int = 128):
    """Selective scan. u/dt_: [B, S, di]; b/c: [B, S, ds]; h0: [B, di, ds],
    all float32. Chunks of `chunk` steps (the tail chunk padded with the
    identity step); within a chunk a doubling scan, across chunks a loop
    carrying the state. Returns (y [B, S, di], h_final)."""
    B, S, di = u.shape
    ds = b.shape[-1]
    a = -torch.exp(log_a)                                          # [di, ds]
    da = torch.exp(dt_[..., None] * a)                             # [B,S,di,ds]
    dbu = (dt_ * u)[..., None] * b[:, :, None, :]                  # [B,S,di,ds]

    ck = min(chunk, S)
    pad = (-S) % ck
    if pad:
        da = F.pad(da, (0, 0, 0, 0, 0, pad), value=1.0)
        dbu = F.pad(dbu, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    h, ys = h0, []
    for c0 in range(0, S + pad, ck):
        a_cum, b_cum = _scan_chunk(da[:, c0:c0 + ck], dbu[:, c0:c0 + ck])
        h_seq = a_cum * h[:, None] + b_cum                         # [B, ck, di, ds]
        ys.append(torch.einsum("bsdn,bsn->bsd", h_seq, c[:, c0:c0 + ck]))
        h = h_seq[:, -1]
    y = torch.cat(ys, dim=1)[:, :S]
    return y + u * d_skip, h


def _gates(params, uc, plan: ShardingPlan, dist: Dist):
    """B, C [.., ds] and the step sizes dt [.., di_loc], float32, from the
    conv output `uc` [.., di_loc]. B, C and dt's low-rank input are sums
    over all of d_inner: on a tp-sharded rank, its partials summed in f32
    over tp."""
    tp = plan.tp_axis
    bc = dist.psum_for_shards((uc @ params["w_bc"]).float(), tp)
    b, c = torch.chunk(bc, 2, dim=-1)
    dt_in = dist.psum_for_shards((uc @ params["w_dt_in"]).float(), tp).to(uc.dtype)
    dt_ = F.softplus((dt_in @ params["w_dt"]).float() + params["dt_bias"].float())
    return b, c, dt_


def mamba_fwd(params, x, cfg, plan: ShardingPlan, dist: Dist, *,
              make_cache: bool = False):
    """x: [B, S_loc, D], sequence-sharded over ``plan.seq_axis``. Returns
    (y [B, S_loc, D], {"conv", "ssm"} | None): the conv tail is the last
    d_conv - 1 rows of the in projection of the whole sequence before the
    conv, zero rows first when S < d_conv - 1."""
    seq_ax, tp = plan.seq_axis, plan.tp_axis
    if dist.size(tp) > 1 and seq_ax != tp:
        raise ValueError("sharded Mamba is Megatron-SP: the sequence axis must "
                         f"be the tp axis ({seq_ax!r} != {tp!r})")
    di, dtr, ds, dc = _dims(cfg)
    with tracing.span("mamba.project"):
        xg = dist.all_gather(x, seq_ax, dim=1)                     # [B, S, D]
        B, S, _ = xg.shape
        u = xg @ params["w_x"]                                     # [B, S, di_loc]
        z = xg @ params["w_z"]
        conv_w = params["conv_w"]                                  # [dc, di_loc]
        u_pad = F.pad(u, (0, 0, dc - 1, 0))
        conv = sum(u_pad[:, i:i + S] * conv_w[i] for i in range(dc)) + params["conv_b"]
        uc = F.silu(conv.float()).to(u.dtype)
        b, c, dt_ = _gates(params, uc, plan, dist)

    with tracing.span("mamba.scan"):
        h0 = torch.zeros((B, u.shape[-1], ds), dtype=torch.float32, device=x.device)
        y, h_fin = _ssm_scan(uc.float(), dt_, b, c, params["log_a"],
                             params["d_skip"], h0)
    with tracing.span("mamba.out"):
        y = (y * F.silu(z.float())).to(x.dtype)
        out = dist.reduce_scatter(y @ params["w_out"], seq_ax, dim=1)

    cache = None
    if make_cache:
        cache = {"conv": u_pad[:, S:].contiguous(), "ssm": h_fin}
    return out, cache


def mamba_decode(params, x, cache, cfg, plan: ShardingPlan, dist: Dist):
    """x: [B, 1, D], replicated over tp; cache: conv [B, d_conv - 1,
    di_loc], ssm [B, di_loc, ds] f32. One step of the conv and the scan.
    Returns (y [B, 1, D], cache) with the cache written in place (each leaf
    keeps its dtype)."""
    xt = x[:, 0]
    with tracing.span("mamba.project"):
        u = xt @ params["w_x"]                                     # [B, di_loc]
        z = xt @ params["w_z"]
        conv_in = torch.cat([cache["conv"], u[:, None]], dim=1)    # [B, dc, di_loc]
        conv = torch.einsum("bcd,cd->bd", conv_in, params["conv_w"]) + params["conv_b"]
        uc = F.silu(conv.float()).to(u.dtype)
        b, c, dt_ = _gates(params, uc, plan, dist)

    with tracing.span("mamba.scan"):
        a = -torch.exp(params["log_a"])
        da = torch.exp(dt_[..., None] * a)                         # [B, di_loc, ds]
        h = cache["ssm"] * da + (dt_ * uc.float())[..., None] * b[:, None, :]
        y = torch.einsum("bdn,bn->bd", h, c) + uc.float() * params["d_skip"]
        cache["conv"].copy_(conv_in[:, 1:])
        cache["ssm"].copy_(h)
    with tracing.span("mamba.out"):
        y = (y * F.silu(z.float())).to(x.dtype)
        out = dist.psum(y @ params["w_out"], plan.tp_axis)
    return out[:, None], cache
