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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers.common import dtype_of, normal, swiglu
from repro_torch.sharding.dist import Dist
from repro_torch.sharding.plans import ShardingPlan


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
    probs [T, E], idx [T, k] -> scalar f32."""
    onehot = F.one_hot(idx, probs.shape[-1]).float().sum(dim=1)          # [T, E]
    return n_real * torch.sum(onehot.mean(dim=0) * probs.mean(dim=0))


def moe_ffn(params, x, cfg, plan: ShardingPlan, dist: Dist, *,
            capacity_groups: int = 1, collect_aux: bool = False):
    """x: [B, T, D]. Tokens split into `capacity_groups` equal groups along
    the flattened B*T axis, each with its own capacity. Returns y [B, T, D],
    or (y, aux) with `collect_aux`: the load-balance loss over all B*T
    tokens, as the JAX layer returns it (training runs one group)."""
    m = cfg.moe
    B, t, d = x.shape
    n_tok = B * t
    G = capacity_groups
    if n_tok % G:
        raise ValueError(f"{n_tok} tokens do not split into {G} groups")
    if dist.size(plan.ep_axis) > 1:
        raise NotImplementedError("expert parallelism needs torch.distributed")
    xt = x.reshape(n_tok, d)
    e_pad = params["router"].shape[-1]
    cap = capacity(n_tok // G, m.experts_per_token, e_pad, m.capacity_factor)

    logits = xt.float() @ params["router"]
    gates, idx, probs = route(logits, m.experts_per_token, m.num_experts)
    k = idx.shape[-1]
    slot, keep = slot_assignment(idx.reshape(G, n_tok // G, k), e_pad, cap)
    slot, keep = slot.reshape(n_tok, k), keep.reshape(n_tok, k)

    # scatter tokens into [E * G*cap, D]; a dropped decision adds zeros at
    # its group's clamped slot cap-1, as the JAX layer does
    group = (torch.arange(n_tok, device=x.device) // (n_tok // G))[:, None]
    flat_idx = (idx * (G * cap) + group * cap
                + torch.clamp(slot, 0, cap - 1)).reshape(-1)       # [T*k]
    contrib = xt[:, None, :] * keep[..., None].to(xt.dtype)
    x_e = torch.zeros((e_pad * G * cap, d), dtype=xt.dtype, device=x.device)
    x_e.index_add_(0, flat_idx, contrib.reshape(-1, d))
    x_e = x_e.reshape(e_pad, G * cap, d)

    h = kops.moe_gmm(x_e, params["w_gate"], params["w_up"], params["w_down"])

    # gather back and combine with gates
    picked = h.reshape(e_pad * G * cap, d)[flat_idx].reshape(n_tok, k, d)
    w = (gates * keep.to(gates.dtype)).to(h.dtype)
    y = torch.einsum("tk,tkd->td", w, picked).reshape(B, t, d)

    if m.num_shared_experts:
        sh = swiglu(x, params["w_shared_gate"], params["w_shared_up"],
                    params["w_shared_down"])
        y = y + dist.psum(sh, plan.tp_axis)
    if collect_aux:
        return y, aux_load_balance_loss(probs, idx, m.num_experts)
    return y
