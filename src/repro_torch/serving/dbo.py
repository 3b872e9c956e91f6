"""Dual-batch overlap serve step (paper section 2.3, Fig 4).

Port of ``repro.serving.dbo``. The batch splits into two microbatches; the
stack applies layer i to microbatch A, then layer i to microbatch B,
alternating. A's MoE dispatch is data-independent of B's attention and
FFN, so a multi-device step can overlap the collective of one microbatch
with the compute of the other. JAX leaves that overlap to XLA's
latency-hiding scheduler; eager PyTorch has none, so the step issues it
itself. A MoE layer runs in stages (``moe.moe_dispatch``,
``moe_experts``, ``moe_combine``) in this order:

    A: mixer, norm2 -> dispatch started
    B: mixer, norm2 -> dispatch started
    A: wait, experts, combine started
    B: wait, experts, combine started
    A: wait, gather, gates, shared experts -> residual
    B: the same

so that A's dispatch is in flight under B's mixer (its collectives on the
other axes included), B's under A's experts, and A's combine under B's
experts. Every rank issues the collectives in this one order. A layer
without a MoE FFN (a dense FFN, RWKV's channel mix) has no all-to-all to
hide and runs whole, A then B. Each microbatch does the arithmetic of a plain decode
step of its own, in the same order, so the step is bitwise two plain
steps; on one device with no collective it launches their kernels. Each
microbatch keeps a scalar ``pos`` and its own MoE capacity group, as the
JAX step has. Caches are written in place (the port's decode), so a
caller that compares with two plain steps gives each side its own copy.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import common
from repro_torch.models.layers import moe as moe_mod
from repro_torch.sharding.dist import Dist
from repro_torch.sharding.plans import ShardingPlan


def _interleaved_stack(params, xa, xb, cfg: ModelConfig, plan, dist, *,
                       caches_a: List[dict], caches_b: List[dict], pos):
    """Apply the decoder stack to two microbatches, layer-interleaved, a MoE
    layer in the staged order of the module docstring."""
    new_a, new_b = [], []
    for i, spec in enumerate(cfg.layer_specs):
        p_i = params["stack"][i]
        if not tf.has_expert_a2a(spec):
            xa, ca = tf.apply_layer(spec, p_i, xa, cfg, plan, dist, mode="decode",
                                    cache=caches_a[i], pos=pos)
            xb, cb = tf.apply_layer(spec, p_i, xb, cfg, plan, dist, mode="decode",
                                    cache=caches_b[i], pos=pos)
        else:
            states, outs = [], []
            for x, c in ((xa, caches_a[i]), (xb, caches_b[i])):
                x, h, nc = tf.layer_pre_ffn(spec, p_i, x, cfg, plan, dist,
                                            mode="decode", cache=c, pos=pos)
                groups = x.shape[0] if tf.per_slot(pos) else 1
                states.append(moe_mod.moe_dispatch(p_i["ffn"], h, cfg, plan, dist,
                                                   capacity_groups=groups))
                outs.append((x, nc or None))
            for st in states:
                moe_mod.moe_experts(p_i["ffn"], st, plan, dist)
            (xa, ca), (xb, cb) = [
                (x + moe_mod.moe_combine(p_i["ffn"], st, cfg, plan, dist), nc)
                for (x, nc), st in zip(outs, states)]
        new_a.append(ca)
        new_b.append(cb)
    return xa, xb, new_a, new_b


def dbo_decode_step(params, caches_a, caches_b, tok_a, tok_b, pos,
                    cfg: ModelConfig, plan: ShardingPlan, dist: Dist, *,
                    logits: bool = False):
    """One DBO decode step over two microbatches.

    tok_a/tok_b: [B/2, 1]; caches_*: per-microbatch caches; pos: a scalar
    position for both. Returns (next_a, next_b, caches_a, caches_b), with
    each microbatch's f32 logits [B/2, 1, V_loc] after them when
    `logits`."""
    xa = common.embed(params["embed"], tok_a, cfg, plan, dist)
    xb = common.embed(params["embed"], tok_b, cfg, plan, dist)
    xa, xb, ca, cb = _interleaved_stack(params, xa, xb, cfg, plan, dist,
                                        caches_a=caches_a, caches_b=caches_b,
                                        pos=pos)
    toks, lgs = [], []
    for x in (xa, xb):
        x = common.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        lg = common.lm_logits(params["embed"], x, cfg, plan, dist)
        toks.append(common.greedy_sample(lg, cfg, plan, dist))
        lgs.append(lg)
    if logits:
        return toks[0], toks[1], ca, cb, lgs[0], lgs[1]
    return toks[0], toks[1], ca, cb
