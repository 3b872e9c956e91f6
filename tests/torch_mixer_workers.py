"""Rank functions for the sharded Mamba and MLA tests (gloo on the CPU),
run on every rank by ``repro_torch.launch.serve.spawn``. They import
torch, numpy and the port only (no JAX) and return numpy arrays.
"""
import numpy as np
import torch

from repro_torch.configs.base import ShapeCell
from repro_torch.convert import shard_leaf, shard_tree, tree_leaves, unshard_leaf
from repro_torch.launch import steps
from repro_torch.models.layers import mamba as TMB
from repro_torch.models.layers import mla as TMLA
from repro_torch.serving import kvcache
from repro_torch.sharding.plans import make_plan
from repro_torch.sharding.specs import P, cache_specs, layer_specs, spec_leaves


def _np(t):
    t = t.detach().cpu()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _gathered(t, spec, dist):
    """The global leaf, copied: the decode writes its caches in place."""
    return _np(unshard_leaf(t, spec, dist)).copy()


def mixer_layer(mesh, dist, dev, job):
    """One mixer layer (layer 0 of `job["cfg"]`: Mamba or MLA) on the ranks:
    the sequence-sharded forward of x [B, S, D] (batch over data, sequence
    over model) with its prefill cache, the cache re-laid out for
    `job["cap"]` positions, then one decode step per row of
    `job["feed"]` [n, B, 1, D] at positions S, S + 1, ...; and the
    gradients of sum(y * w) with respect to x and the layer's weights,
    each reduced over the axes its spec leaves unsharded. Returns (all
    gathered to global shapes) y, the prefill cache, the decode outputs
    [n, B, 1, D], the last cache, dx and the weights' gradients in
    ``tree_leaves`` order."""
    cfg, x, w, feed = job["cfg"], job["x"], job["w"], job["feed"]
    B, S, _ = x.shape
    spec = cfg.layer_specs[0]
    pre = make_plan(cfg, ShapeCell("p", S, B, "prefill"), mesh.axes, mesh.shape, fsdp=False)
    dec = make_plan(cfg, ShapeCell("d", job["cap"], B, "decode"), mesh.axes, mesh.shape,
                    fsdp=False)
    wspecs = layer_specs(spec, cfg, pre)["mixer"]
    if spec.mixer == "mamba":
        fwd = lambda p, x_: TMB.mamba_fwd(p, x_, cfg, pre, dist, make_cache=True)  # noqa: E731
        step = lambda p, x_, c, pos: TMB.mamba_decode(p, x_, c, cfg, dec, dist)     # noqa: E731
    else:
        fwd = lambda p, x_: TMLA.mla_fwd(p, x_, cfg, pre, dist, make_cache=True)    # noqa: E731
        step = lambda p, x_, c, pos: TMLA.mla_decode(p, x_, c, pos, cfg, dec, dist)  # noqa: E731
    # copies: a replicated leaf's shard is the job's own tensor
    params = {k: v.clone() for k, v in shard_tree(job["params"], wspecs, mesh).items()}
    xspec = P(pre.batch_axes, pre.seq_axis, None)
    x_loc = torch.from_numpy(shard_leaf(x, xspec, mesh))
    w_loc = torch.from_numpy(shard_leaf(w, xspec, mesh))
    leaves = tree_leaves(params)
    for t in [x_loc] + leaves:
        t.requires_grad_(True)
    y, cache = fwd(params, x_loc)
    grads = torch.autograd.grad((y * w_loc).sum(), [x_loc] + leaves)
    out = {"y": _gathered(y, xspec, dist), "dx": _gathered(grads[0], xspec, dist)}
    # a weight's gradient: summed over the axes its spec does not shard
    red = steps.reduce_grads(list(grads[1:]), spec_leaves(wspecs, params), pre, dist)
    out["dw"] = [_gathered(g, s, dist) for g, s in zip(red, spec_leaves(wspecs, params))]

    cache = {k: v.detach() for k, v in cache.items()}
    cspec = cache_specs(cfg, pre)[0]["mixer"]
    out["cache"] = {k: _gathered(v, cspec[k], dist) for k, v in cache.items()}
    caches = kvcache.pad_to_capacity(cfg, [{"mixer": cache}], S, job["cap"], dec, dist)
    cache = caches[0]["mixer"]
    cspec = cache_specs(cfg, dec)[0]["mixer"]
    out["relaid"] = {k: _gathered(v, cspec[k], dist) for k, v in cache.items()}
    params = {k: v.detach() for k, v in params.items()}
    tspec = P(dec.batch_axes, None, None)
    ys = []
    with torch.no_grad():
        for i in range(feed.shape[0]):
            xt = torch.from_numpy(shard_leaf(feed[i], tspec, mesh))
            yt, cache = step(params, xt, cache, S + i)
            ys.append(_gathered(yt, tspec, dist))
    out["decode"] = np.stack(ys)
    out["last_cache"] = {k: _gathered(v, cspec[k], dist) for k, v in cache.items()}
    out["local_cache_shapes"] = {k: tuple(v.shape) for k, v in cache.items()}
    return out


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
