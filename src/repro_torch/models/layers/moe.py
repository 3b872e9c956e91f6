"""Mixture-of-Experts layer (static capacity, scatter-based).

Port of ``repro.models.layers.moe``: router -> top-k -> token-major
capacity slots -> scatter-add into the [E, C, D] expert buffer -> grouped
expert FFN (``ops.moe_gmm``: the CUDA kernel on the card) -> gather and
gate-weighted combine, plus shared experts.

Capacity groups. The JAX engine vmaps its decode step over slots, so each
slot's tokens form their own capacity group: at decode every slot gets
``capacity(1, k, E, cf)`` slots per expert and never competes with another
slot. The port's batched decode keeps that with ``capacity_groups=B``: the
buffer is [E, G*cap, D] with group g's slots at [g*cap, (g+1)*cap), and
one ``moe_gmm`` launch serves every group. ``capacity_groups=1`` is the
JAX single-call semantics (one group over all B*T tokens).
``capacity_groups=(gb, gt)`` makes a grid of groups, gb blocks of rows by
gt blocks of positions: the groups of a mesh whose ranks each hold one
such block, so that one device reproduces a sharded run's drops. The
load-balance loss is then the mean of the groups' losses, as a sharded
``train_loss`` averages its ranks'.

Expert parallelism (``plan.ep_axis`` larger than 1): each rank routes its
own tokens with the capacity of its own token count, builds the
[E, C, D] buffer, and the dispatch all-to-all (split the expert dim,
concatenate the capacity dim) hands every rank the rows of its E / ep
experts from all ranks, [E_loc, ep*C, D], for ``moe_gmm``; the combine
all-to-all (split capacity, concatenate experts) sends them back. With
``plan.a2a_fp8`` the dispatch travels as e4m3 bytes with a scale per slot
(``fp8_dispatch_a2a``) and the combine in the model dtype. Shared experts
are tensor-parallel over ``plan.tp_axis``, on sequence-sharded tokens
all-gathered before and reduce-scattered after.

Stages. ``moe_ffn`` is ``moe_dispatch`` (route, slot assignment, scatter,
then the dispatch all-to-all started), ``moe_experts`` (its wait,
``moe_gmm``, the combine started) and ``moe_combine`` (its wait, the
gather, the gates, the shared experts), run in a row. The DBO step
(``serving.dbo``) runs them apart, so that one microbatch's all-to-all
is in flight under the other's compute. Where the buffer wants a
gradient (training) each all-to-all is the differentiable one, done at
once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from dataclasses import dataclass
from typing import Any

from repro_torch import tracing
from repro_torch.kernels import ops as kops
from repro_torch.models.layers.common import (dtype_of, fp8_dequantize,
                                              fp8_quantize, normal, swiglu)
from repro_torch.sharding.dist import Dist, PendingAllToAll
from repro_torch.sharding.plans import ShardingPlan


def fp8_dispatch_a2a(x_e, ep_ax, dist: Dist):
    """The dispatch all-to-all with an fp8 (e4m3) wire format: uint8 bytes
    and a f32 scale per slot travel; the result is dequantized to x_e's
    dtype."""
    return fp8_dispatch_start(x_e, ep_ax, dist).wait()


def fp8_dispatch_start(x_e, ep_ax, dist: Dist) -> PendingAllToAll:
    """``fp8_dispatch_a2a`` begun: both all-to-alls (the bytes, then the
    scales) started; ``wait()`` waits for both and dequantizes."""
    qb, scale = fp8_quantize(x_e)
    qg = _a2a_start(dist, qb, ep_ax, 0, 1)
    sg = _a2a_start(dist, scale, ep_ax, 0, 1)
    return PendingAllToAll(lambda: fp8_dequantize(qg.wait(), sg.wait(), x_e.dtype))


def _a2a_start(dist: Dist, x, ax, split_dim: int, concat_dim: int) -> PendingAllToAll:
    """The all-to-all of `x` begun: started for serving, or, where `x` wants
    a gradient, the differentiable ``all_to_all`` done at once."""
    if torch.is_grad_enabled() and x.requires_grad:
        return PendingAllToAll.done(dist.all_to_all(x, ax, split_dim=split_dim,
                                                    concat_dim=concat_dim))
    return dist.all_to_all_start(x, ax, split_dim, concat_dim)


def capacity(t_loc: int, topk: int, n_exp: int, cf: float) -> int:
    c = int(-(-t_loc * topk * cf // n_exp))
    return max(c, 1)


def init_moe(cfg, plan: ShardingPlan, gen):
    m = cfg.moe
    e_pad = m.padded_num_experts(max(plan.ep, 1))
    d, de = cfg.d_model, m.d_expert
    dt = dtype_of(cfg)
    params = {
        "router": normal((d, e_pad), torch.float32, gen, d ** -0.5),
        "w_gate": normal((e_pad, d, de), dt, gen, d ** -0.5),
        "w_up": normal((e_pad, d, de), dt, gen, d ** -0.5),
        "w_down": normal((e_pad, de, d), dt, gen, de ** -0.5),
    }
    if m.num_shared_experts:
        dsh = m.d_shared_expert * m.num_shared_experts
        params["w_shared_gate"] = normal((d, dsh), dt, gen, d ** -0.5)
        params["w_shared_up"] = normal((d, dsh), dt, gen, d ** -0.5)
        params["w_shared_down"] = normal((dsh, d), dt, gen, dsh ** -0.5)
    return params


def route(logits, topk: int, n_real: int):
    """logits [T, E] f32 (E includes padding). Returns (gates [T, k],
    idx [T, k], probs [T, E]) with padded experts masked out."""
    e = logits.shape[-1]
    mask = torch.arange(e, device=logits.device) < n_real
    logits = torch.where(mask, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, topk, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def slot_assignment(idx, e_pad: int, cap: int):
    """Queue position of each (token, k) routing decision in its expert's
    capacity buffer, token-major priority, counted within each group.
    idx: [..., T, k] (leading dims are independent groups) ->
    (slot [..., T, k] int32, keep [..., T, k] bool)."""
    *lead, t, k = idx.shape
    flat = idx.reshape(*lead, t * k)
    onehot = F.one_hot(flat, e_pad).to(torch.int32)            # [..., T*k, E]
    pos = torch.cumsum(onehot, dim=-2) - onehot
    slot = torch.gather(pos, -1, flat[..., None])[..., 0].reshape(*lead, t, k)
    return slot.to(torch.int32), slot < cap


def aux_load_balance_loss(probs, idx, n_real: int):
    """Switch-transformer load-balance loss over the real experts:
    probs [..., T, E], idx [..., T, k] -> scalar f32, the mean over the
    leading (group) dims of each group's loss."""
    onehot = F.one_hot(idx, probs.shape[-1]).float().sum(dim=-2)        # [..., T, E]
    return n_real * torch.sum(onehot.mean(dim=-2) * probs.mean(dim=-2), dim=-1).mean()


@dataclass
class MoeState:
    """One MoE call between its stages: the routing, and the all-to-all in
    flight (``pending``: the dispatch after ``moe_dispatch``, the combine
    after ``moe_experts``)."""
    x: Any                    # the layer's input [B, T, D], for the shared experts
    flat_idx: Any             # [T*k] the rows of the [E*G*cap, D] buffer
    gates: Any
    keep: Any
    idx: Any
    probs: Any
    groups: int
    pending: PendingAllToAll


def moe_ffn(params, x, cfg, plan: ShardingPlan, dist: Dist, *,
            capacity_groups=1, collect_aux: bool = False):
    """x: [B, T, D], this rank's tokens. Tokens split into `capacity_groups`
    equal groups along the flattened B*T axis (or a (rows, positions) grid
    of groups), each with its own capacity. Returns y [B, T, D], or (y, aux)
    with `collect_aux`: the load-balance loss, over all B*T tokens for one
    group as the JAX layer returns it, the mean of the groups' for more."""
    if isinstance(capacity_groups, tuple):
        gb, gt = capacity_groups
        B, t, d = x.shape
        xg = x.reshape(gb, B // gb, gt, t // gt, d).transpose(1, 2)
        out = moe_ffn(params, xg.reshape(gt * B, t // gt, d), cfg, plan, dist,
                      capacity_groups=gb * gt, collect_aux=collect_aux)
        y = out[0] if collect_aux else out
        y = y.reshape(gb, gt, B // gb, t // gt, d).transpose(1, 2).reshape(B, t, d)
        return (y, out[1]) if collect_aux else y
    st = moe_dispatch(params, x, cfg, plan, dist, capacity_groups=capacity_groups)
    moe_experts(params, st, plan, dist)
    return moe_combine(params, st, cfg, plan, dist, collect_aux=collect_aux)


def moe_dispatch(params, x, cfg, plan: ShardingPlan, dist: Dist, *,
                 capacity_groups: int = 1) -> MoeState:
    """The first stage: route x [B, T, D] (`capacity_groups` groups along
    the flattened B*T axis), scatter it into the [E, G*cap, D] buffer and
    start the dispatch all-to-all (both of the fp8 wire format's)."""
    m = cfg.moe
    B, t, d = x.shape
    n_tok = B * t
    G = capacity_groups
    if n_tok % G:
        raise ValueError(f"{n_tok} tokens do not split into {G} groups")
    ep_ax = plan.ep_axis
    ep = dist.size(ep_ax)
    if ep > 1 and G != 1:
        raise ValueError("capacity groups are a single-device rule; under "
                         "expert parallelism each rank is one group")
    xt = x.reshape(n_tok, d)
    e_pad = params["router"].shape[-1]
    cap = capacity(n_tok // G, m.experts_per_token, e_pad, m.capacity_factor)

    with tracing.span("moe.route"):
        logits = xt.float() @ params["router"]
        gates, idx, probs = route(logits, m.experts_per_token, m.num_experts)
        k = idx.shape[-1]
        slot, keep = slot_assignment(idx.reshape(G, n_tok // G, k), e_pad, cap)
        slot, keep = slot.reshape(n_tok, k), keep.reshape(n_tok, k)

    with tracing.span("moe.dispatch"):
        # scatter tokens into [E * G*cap, D]; a dropped decision adds zeros at
        # its group's clamped slot cap-1, as the JAX layer does
        group = (torch.arange(n_tok, device=x.device) // (n_tok // G))[:, None]
        flat_idx = (idx * (G * cap) + group * cap
                    + torch.clamp(slot, 0, cap - 1)).reshape(-1)   # [T*k]
        contrib = xt[:, None, :] * keep[..., None].to(xt.dtype)
        x_e = torch.zeros((e_pad * G * cap, d), dtype=xt.dtype, device=x.device)
        x_e.index_add_(0, flat_idx, contrib.reshape(-1, d))
        x_e = x_e.reshape(e_pad, G * cap, d)
        # -> [E_loc, ep*C, D]: the rows of this rank's experts from every rank
        if ep > 1 and plan.a2a_fp8:
            pending = fp8_dispatch_start(x_e, ep_ax, dist)
        else:
            pending = _a2a_start(dist, x_e, ep_ax, 0, 1)
    return MoeState(x, flat_idx, gates, keep, idx, probs, G, pending)


def moe_experts(params, st: MoeState, plan: ShardingPlan, dist: Dist) -> MoeState:
    """The second stage: wait for the dispatch, run the experts
    (``ops.moe_gmm``) and start the combine all-to-all."""
    with tracing.span("moe.experts"):
        x_e = st.pending.wait()
        h = kops.moe_gmm(x_e.contiguous(), params["w_gate"], params["w_up"],
                         params["w_down"])
        st.pending = _a2a_start(dist, h, plan.ep_axis, 1, 0)        # [E, C, D]
    return st


def moe_combine(params, st: MoeState, cfg, plan: ShardingPlan, dist: Dist, *,
                collect_aux: bool = False):
    """The last stage: wait for the combine, gather each token's expert
    rows, weight them by the gates, add the shared experts. Returns y
    [B, T, D], or (y, aux) with `collect_aux` (see ``moe_ffn``)."""
    m = cfg.moe
    x = st.x
    B, t, d = x.shape
    n_tok, G, k = B * t, st.groups, st.idx.shape[-1]
    with tracing.span("moe.combine"):
        h = st.pending.wait()
        # gather back and combine with gates
        picked = h.reshape(-1, d)[st.flat_idx].reshape(n_tok, k, d)
        w = (st.gates * st.keep.to(st.gates.dtype)).to(h.dtype)
        y = torch.einsum("tk,tkd->td", w, picked).reshape(B, t, d)

    if m.num_shared_experts:
        with tracing.span("moe.shared"):
            seq_sharded = dist.size(plan.seq_axis) > 1
            xs = dist.all_gather(x, plan.seq_axis, dim=1) if seq_sharded else x
            sh = swiglu(xs, params["w_shared_gate"], params["w_shared_up"],
                        params["w_shared_down"])
            if seq_sharded:
                sh = dist.reduce_scatter(sh, plan.seq_axis, dim=1)
            else:
                sh = dist.psum(sh, plan.tp_axis)
            y = y + sh
    if collect_aux:
        return y, aux_load_balance_loss(st.probs.reshape(G, n_tok // G, -1),
                                        st.idx.reshape(G, n_tok // G, k), m.num_experts)
    return y
