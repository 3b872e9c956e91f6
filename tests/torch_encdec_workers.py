"""Rank functions for the sharded RWKV and cross-attention tests (gloo on
the CPU), run on every rank by ``repro_torch.launch.serve.spawn``. They
import torch, numpy and the port only (no JAX) and return numpy arrays,
gathered to their global shapes.
"""
import numpy as np
import torch

from repro_torch.configs.base import ShapeCell
from repro_torch.convert import shard_leaf, shard_tree, tree_leaves, unshard_leaf
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.models.layers import attention as TA
from repro_torch.models.layers import rwkv as TR
from repro_torch.serving import kvcache
from repro_torch.sharding.plans import make_plan
from repro_torch.sharding.specs import (P, attention_specs, cache_specs, param_specs,
                                        rwkv_cm_specs, rwkv_tm_specs, spec_leaves)


def _np(t):
    t = t.detach().cpu()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _gathered(t, spec, dist):
    """The global leaf, copied: the decode writes its caches in place."""
    return _np(unshard_leaf(t, spec, dist)).copy()


def _plans(cfg, mesh, B, S, cap):
    pre = make_plan(cfg, ShapeCell("p", S, B, "prefill"), mesh.axes, mesh.shape, fsdp=False)
    dec = make_plan(cfg, ShapeCell("d", cap, B, "decode"), mesh.axes, mesh.shape, fsdp=False)
    return pre, dec


def _reduced_grads(grads, wspecs, params, plan, dist):
    """Each weight's gradient summed over the axes its spec leaves
    unsharded, gathered."""
    leaf_specs = spec_leaves(wspecs, params)
    red = steps.reduce_grads(list(grads), leaf_specs, plan, dist)
    return [_gathered(g, s, dist) for g, s in zip(red, leaf_specs)]


def rwkv_layer(mesh, dist, dev, job):
    """RWKV's time mix ("tm") or channel mix ("cm") of layer 0 on the
    ranks, as ``job["part"]`` says: the sequence-sharded forward of x
    [B, S, D] (batch over data, sequence and heads or d_ff over model)
    with its prefill cache, the cache re-laid out by
    ``kvcache.pad_to_capacity`` for `job["cap"]` positions (recurrent: as
    it is), one decode step per row of `job["feed"]` [n, B, 1, D], and the
    gradients of sum(y * w) with respect to x and every weight. Returns
    everything gathered, and the local shapes of the decode cache."""
    cfg, x, w, feed, part = job["cfg"], job["x"], job["w"], job["feed"], job["part"]
    B, S, _ = x.shape
    pre, dec = _plans(cfg, mesh, B, S, job["cap"])
    if part == "tm":
        wspecs, group = rwkv_tm_specs(pre), "mixer"
        fwd = lambda p, x_: TR.rwkv_tm_fwd(p, x_, cfg, pre, dist, make_cache=True)  # noqa: E731
        step = lambda p, x_, c: TR.rwkv_tm_decode(p, x_, c, cfg, dec, dist)         # noqa: E731
    else:
        wspecs, group = rwkv_cm_specs(pre), "ffn"
        fwd = lambda p, x_: TR.rwkv_cm_fwd(p, x_, pre, dist, make_cache=True)       # noqa: E731
        step = lambda p, x_, c: TR.rwkv_cm_decode(p, x_, c, dec, dist)              # noqa: E731
    params = {k: v.clone() for k, v in shard_tree(job["params"], wspecs, mesh).items()}
    xspec = P(pre.batch_axes, pre.seq_axis, None)
    x_loc = torch.from_numpy(shard_leaf(x, xspec, mesh))
    w_loc = torch.from_numpy(shard_leaf(w, xspec, mesh))
    leaves = tree_leaves(params)
    for t in [x_loc] + leaves:
        t.requires_grad_(True)
    y, cache = fwd(params, x_loc)
    grads = torch.autograd.grad((y * w_loc).sum(), [x_loc] + leaves)
    out = {"y": _gathered(y, xspec, dist), "dx": _gathered(grads[0], xspec, dist),
           "dw": _reduced_grads(grads[1:], wspecs, params, pre, dist)}
    cache = {k: v.detach() for k, v in cache.items()}
    cspec = cache_specs(cfg, pre)[0][group]
    out["cache"] = {k: _gathered(v, cspec[k], dist) for k, v in cache.items()}
    cache = kvcache.pad_to_capacity(cfg, [{group: cache}], S, job["cap"], dec, dist)[0][group]
    cspec = cache_specs(cfg, dec)[0][group]
    params = {k: v.detach() for k, v in params.items()}
    tspec = P(dec.batch_axes, None, None)
    ys = []
    with torch.no_grad():
        for i in range(feed.shape[0]):
            yt, cache = step(params, torch.from_numpy(shard_leaf(feed[i], tspec, mesh)), cache)
            ys.append(_gathered(yt, tspec, dist))
    out["decode"] = np.stack(ys)
    out["last_cache"] = {k: _gathered(v, cspec[k], dist) for k, v in cache.items()}
    out["local_cache_shapes"] = {k: tuple(v.shape) for k, v in cache.items()}
    return out


def cross_layer(mesh, dist, dev, job):
    """Cross-attention of layer 0 on the ranks. Prefill: decoder tokens x
    and encoder output `job["enc"]`, both [B, S, D] and sequence-sharded,
    through ``make_enc_cache`` and ``cross_attention_fwd``, and the
    gradients of sum(y * w) with respect to x, the encoder output and the
    cross weights. Decode: `job["kv"]` (the global cross cache k, v
    [B, KV, cap, hd]) sharded over the decode plan's kv axis, and each
    (x_t [B, 1, D], enc_len) of `job["feed"]` through
    ``cross_attention_decode``. Returns everything gathered, the plans'
    attention modes and the local shape of the decode cache."""
    cfg, x, enc, w = job["cfg"], job["x"], job["enc"], job["w"]
    B, S, _ = x.shape
    pre, dec = _plans(cfg, mesh, B, S, job["kv"]["k"].shape[2])
    wspecs = attention_specs(pre)
    params = {k: v.clone() for k, v in shard_tree(job["params"], wspecs, mesh).items()}
    xspec = P(pre.batch_axes, pre.seq_axis, None)
    x_loc = torch.from_numpy(shard_leaf(x, xspec, mesh))
    e_loc = torch.from_numpy(shard_leaf(enc, xspec, mesh))
    w_loc = torch.from_numpy(shard_leaf(w, xspec, mesh))
    leaves = tree_leaves(params)
    for t in [x_loc, e_loc] + leaves:
        t.requires_grad_(True)
    kv = TA.make_enc_cache(params, e_loc, cfg, pre, dist)
    y = TA.cross_attention_fwd(params, x_loc, kv, cfg, pre, dist)
    grads = torch.autograd.grad((y * w_loc).sum(), [x_loc, e_loc] + leaves)
    out = {"y": _gathered(y, xspec, dist), "dx": _gathered(grads[0], xspec, dist),
           "denc": _gathered(grads[1], xspec, dist),
           "dw": _reduced_grads(grads[2:], wspecs, params, pre, dist),
           "modes": (pre.attn_mode, dec.attn_mode)}
    kspec = cache_specs(cfg, pre)[0]["cross"]["k"]
    out["enc_kv"] = {n: _gathered(t.detach(), kspec, dist) for n, t in kv.items()}
    cspec = cache_specs(cfg, dec)[0]["cross"]["k"]
    cache = {n: torch.from_numpy(shard_leaf(a, cspec, mesh)).contiguous()
             for n, a in job["kv"].items()}
    params = shard_tree(job["params"], attention_specs(dec), mesh)
    tspec = P(dec.batch_axes, None, None)
    ys = []
    with torch.no_grad():
        for xt, enc_len in job["feed"]:
            yt = TA.cross_attention_decode(params, torch.from_numpy(shard_leaf(xt, tspec, mesh)),
                                           cache, enc_len, cfg, dec, dist)
            ys.append(_gathered(yt, tspec, dist))
    out["decode"] = np.stack(ys)
    out["local_cache_shape"] = tuple(cache["k"].shape)
    return out


def encoder(mesh, dist, dev, job):
    """The encoder stack and ``enc_norm`` (``model._encode``) on frames
    [B, S, D] sequence-sharded under the prefill plan, the weights cut by
    ``param_specs``: the output gathered."""
    cfg, frames = job["cfg"], job["frames"]
    B, S, _ = frames.shape
    pre, _ = _plans(cfg, mesh, B, S, S)
    specs = param_specs(cfg, pre)
    params = {k: shard_tree(job["params"][k], specs[k], mesh) for k in ("encoder", "enc_norm")}
    xspec = P(pre.batch_axes, pre.seq_axis, None)
    with torch.no_grad():
        y = M._encode(params, torch.from_numpy(shard_leaf(frames, xspec, mesh)), cfg, pre,
                      dist)
    return {"y": _gathered(y, xspec, dist)}


def train_loss_step0(mesh, dist, dev, job):
    """``launch.train.train_job`` (the launcher's job), with the rank's
    first loss and the run's losses."""
    from repro_torch.launch.train import train_job
    res = train_job(mesh, dist, dev, job)
    return {"losses": res["losses"], "plan": res["plan"]}


def in_order(mesh, dist, dev, calls):
    """Run each (function, args) on this rank, one after another on one set
    of rank processes; a function is named by "module.function" (a module
    of tests/ or of the port) or by its name in this module. Returns their
    results."""
    import importlib
    out = []
    for name, args in calls:
        mod, _, fn = name.rpartition(".")
        f = getattr(importlib.import_module(mod), fn) if mod else globals()[name]
        out.append(f(mesh, dist, dev, *args))
    return out


def sharded_calls(mesh, dist, dev, job):
    """The sharded layer functions once each on a (1, 2) ("data", "model")
    mesh, for the tests that used to pin their refusal: RWKV's time and
    channel mix ("rwkv": x [B, S, D] sequence-sharded), or cross-attention
    ("cross": x and the encoder output [B, S, D] sequence-sharded, then one
    decode step of x_t [B, 1, D] over the encoder cache `job["kv"]`,
    sequence-sharded over model, at `job["enc_len"]`). Returns the
    outputs, gathered."""
    cfg, x = job["cfg"], job["x"]
    B, S, _ = x.shape
    pre, dec = _plans(cfg, mesh, B, S, S)
    xspec = P(pre.batch_axes, pre.seq_axis, None)
    x_loc = torch.from_numpy(shard_leaf(x, xspec, mesh))
    out = {}
    with torch.no_grad():
        if job["kind"] == "rwkv":
            tm = shard_tree(job["params"]["mixer"], rwkv_tm_specs(pre), mesh)
            cm = shard_tree(job["params"]["ffn"], rwkv_cm_specs(pre), mesh)
            out["tm"] = _gathered(TR.rwkv_tm_fwd(tm, x_loc, cfg, pre, dist)[0], xspec, dist)
            out["cm"] = _gathered(TR.rwkv_cm_fwd(cm, x_loc, pre, dist)[0], xspec, dist)
            return out
        p = shard_tree(job["params"], attention_specs(pre), mesh)
        kv = TA.make_enc_cache(p, torch.from_numpy(shard_leaf(job["enc"], xspec, mesh)), cfg,
                               pre, dist)
        out["fwd"] = _gathered(TA.cross_attention_fwd(p, x_loc, kv, cfg, pre, dist), xspec,
                               dist)
        cspec = cache_specs(cfg, dec)[0]["cross"]["k"]
        cache = {n: torch.from_numpy(shard_leaf(a, cspec, mesh)).contiguous()
                 for n, a in job["kv"].items()}
        tspec = P(dec.batch_axes, None, None)
        y = TA.cross_attention_decode(p, torch.from_numpy(shard_leaf(job["xt"], tspec, mesh)),
                                      cache, job["enc_len"], cfg, dec, dist)
        out["decode"] = _gathered(y, tspec, dist)
    return out
