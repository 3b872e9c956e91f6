"""Dual-batch overlap serve step (paper section 2.3, Fig 4).

Port of ``repro.serving.dbo``. The batch splits into two microbatches; the
stack applies layer i to microbatch A, then layer i to microbatch B,
alternating. A's MoE dispatch is data-independent of B's attention and
FFN, so a multi-device step can overlap the collective of one microbatch
with the compute of the other. Like the JAX step, this one issues the
interleaved order on one stream and leaves the overlap to what runs under
it; on one device with no collective it does the work of two plain decode
steps. Each microbatch keeps a scalar ``pos`` and its own MoE capacity
group, as the JAX step has. Caches are written in place (the port's
decode), so a caller that compares with two plain steps gives each side
its own copy.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import common
from repro_torch.sharding.dist import Dist
from repro_torch.sharding.plans import ShardingPlan


def _interleaved_stack(params, xa, xb, cfg: ModelConfig, plan, dist, *,
                       caches_a: List[dict], caches_b: List[dict], pos):
    """Apply the decoder stack to two microbatches, layer-interleaved."""
    new_a, new_b = [], []
    for i, spec in enumerate(cfg.layer_specs):
        p_i = params["stack"][i]
        xa, ca = tf.apply_layer(spec, p_i, xa, cfg, plan, dist, mode="decode",
                                cache=caches_a[i], pos=pos)
        xb, cb = tf.apply_layer(spec, p_i, xb, cfg, plan, dist, mode="decode",
                                cache=caches_b[i], pos=pos)
        new_a.append(ca)
        new_b.append(cb)
    return xa, xb, new_a, new_b


def dbo_decode_step(params, caches_a, caches_b, tok_a, tok_b, pos,
                    cfg: ModelConfig, plan: ShardingPlan, dist: Dist):
    """One DBO decode step over two microbatches.

    tok_a/tok_b: [B/2, 1]; caches_*: per-microbatch caches; pos: a scalar
    position for both. Returns (next_a, next_b, caches_a, caches_b)."""
    xa = common.embed(params["embed"], tok_a, cfg, plan, dist)
    xb = common.embed(params["embed"], tok_b, cfg, plan, dist)
    xa, xb, ca, cb = _interleaved_stack(params, xa, xb, cfg, plan, dist,
                                        caches_a=caches_a, caches_b=caches_b,
                                        pos=pos)
    out = []
    for x in (xa, xb):
        x = common.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        logits = common.lm_logits(params["embed"], x, cfg, plan, dist)
        out.append(common.greedy_sample(logits, cfg, plan, dist))
    return out[0], out[1], ca, cb
