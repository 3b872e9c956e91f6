"""Rank functions for the port's multi-process tests (gloo on the CPU).

``repro_torch.launch.serve.spawn`` runs each of them on every rank of a
mesh; they import torch, numpy and the port only (no JAX), and return
numpy arrays. ``rank_input`` is the input every rank makes from its rank
number, so that the test can build the same arrays and apply the numpy
definitions of the ``lax`` collectives to them.
"""
import numpy as np
import torch

from repro_torch.configs.base import ShapeCell
from repro_torch.convert import shard_leaf, shard_tree, tree_map
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.serving import kvcache
from repro_torch.sharding.dist import argmax_across
from repro_torch.sharding.plans import make_plan

SHAPE = (4, 6, 8)


def rank_input(rank: int, dtype: str = "float32") -> np.ndarray:
    """Rank r's input: [4, 6, 8] values from numpy seed r, multiples of
    1/64 (integers for uint8), so that sums are exact in any order."""
    rng = np.random.default_rng(rank)
    if dtype == "uint8":
        return rng.integers(0, 50, SHAPE).astype(np.uint8)
    return (np.round(rng.standard_normal(SHAPE) * 64) / 64).astype(np.float32)


def _np(t):
    t = t.cpu()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def collectives(mesh, dist, dev, cases):
    """Run each case (name, op, axis, dtype, kwargs) on this rank's input,
    on the rank's device; returns {name: numpy result} and the rank's
    indices."""
    out = {}
    for name, op, axis, dtype, kw in cases:
        x = torch.from_numpy(rank_input(mesh.rank, dtype)).to(dev)
        if dtype == "bfloat16":
            x = x.to(torch.bfloat16)
        if op == "argmax_across":
            vals = x.float().amax(dim=-1)
            idx = x.float().argmax(dim=-1) + 8 * dist.index(axis)
            y = argmax_across(dist, vals, idx, axis)
        else:
            y = getattr(dist, op)(x, axis, **kw)
        out[name] = _np(y)
    out["index"] = {repr(a): dist.index(a) for a in ("data", "model", ("data", "model"))}
    return out


def _cache_np(caches):
    return tree_map(lambda t: _np(t.detach()), caches)


def run_jobs(mesh, dist, dev, jobs):
    """Decode and prefill jobs on converted weights. A job: kind ("decode"
    or "prefill"), cfg, params (the global tree, CPU tensors), plan_kw,
    batch, seq (cache capacity, or prompt length), tokens [B, 1] or [B, S]
    (numpy), pos (decode), to_seq (prefill: the decode capacity to re-lay
    the caches out for). A "serve" job prefills `tokens` [B, seq], re-lays
    the caches out for `to_seq` and decodes `feed` [B, n] (numpy) at
    positions seq, seq + 1, ... (an encoder-decoder encodes `frames`
    [B, seq, D], numpy, split as the tokens, and its decode reads
    ``enc_len = to_seq``), returning each step's logits [n, B, V]
    and the local positions of the rank's cache shard that hold a row.
    Returns this rank's results per job."""
    results = []
    axes = mesh.axes
    for job in jobs:
        cfg, B, S = job["cfg"], job["batch"], job["seq"]
        cell = ShapeCell(job["kind"][0], S, B, job["kind"])
        plan = make_plan(cfg, cell, axes, mesh.shape, fsdp=False, **job.get("plan_kw", {}))
        res = {"plan": plan}
        if job["kind"] == "decode":
            step = steps.build_decode_step(cfg, cell, plan, mesh, dist=dist, logits=True)
            params = shard_tree(job["params"], step.param_specs, mesh)
            caches = M.init_cache(cfg, plan, B, S, device="cpu", mesh=mesh)
            tok = torch.from_numpy(shard_leaf(job["tokens"], step.in_specs["tokens"], mesh))
            tok, caches, lg = step(params, caches, tok, job.get("pos", 0))
            lg = dist.all_gather(lg, plan.vocab_axis, dim=-1)
            res["logits"] = _np(dist.all_gather(lg, plan.batch_axes, dim=0))
            res["token"] = _np(dist.all_gather(tok, plan.batch_axes, dim=0))
            full = [c for c, spec in zip(caches, cfg.layer_specs) if spec.mixer == "attn"]
            res["local_cache_shape"] = tuple(full[0]["mixer"]["k"].shape)
        elif job["kind"] == "serve":
            res["logits"], res["filled"] = _serve(cfg, job, mesh, dist)
        else:
            step = steps.build_prefill(cfg, cell, plan, mesh, dist=dist)
            params = shard_tree(job["params"], step.param_specs, mesh)
            tok = torch.from_numpy(shard_leaf(job["tokens"], step.in_specs["tokens"], mesh))
            tok, caches = step(params, {"tokens": tok})
            res["token"] = _np(dist.all_gather(tok, plan.batch_axes, dim=0))
            res["caches"] = _cache_np(caches)
            dec = make_plan(cfg, ShapeCell("d", job["to_seq"], B, "decode"), axes,
                            mesh.shape, fsdp=False)
            padded = kvcache.pad_to_capacity(cfg, caches, S, job["to_seq"], dec, dist)
            res["padded"] = _cache_np(padded)
        results.append(res)
    return results


def _serve(cfg, job, mesh, dist):
    B, P, S = job["batch"], job["seq"], job["to_seq"]
    axes = mesh.axes
    pre_plan = make_plan(cfg, ShapeCell("p", P, B, "prefill"), axes, mesh.shape, fsdp=False)
    dec_plan = make_plan(cfg, ShapeCell("d", S, B, "decode"), axes, mesh.shape, fsdp=False)
    pre = steps.build_prefill(cfg, ShapeCell("p", P, B, "prefill"), pre_plan, mesh,
                              dist=dist)
    dec = steps.build_decode_step(cfg, ShapeCell("d", S, B, "decode"), dec_plan, mesh,
                                  dist=dist, logits=True)
    batch = {"tokens": torch.from_numpy(shard_leaf(job["tokens"], pre.in_specs["tokens"],
                                                   mesh))}
    if "frames" in job:
        batch["frames"] = torch.from_numpy(shard_leaf(job["frames"], pre.in_specs["frames"],
                                                      mesh))
    _, caches = pre(shard_tree(job["params"], pre.param_specs, mesh), batch)
    caches = kvcache.pad_to_capacity(cfg, caches, P, S, dec_plan, dist)
    params = shard_tree(job["params"], dec.param_specs, mesh)
    logits = []
    for i in range(job["feed"].shape[1]):
        tok = torch.from_numpy(shard_leaf(job["feed"][:, i:i + 1], dec.in_specs["tokens"],
                                          mesh))
        _, caches, lg = dec(params, caches, tok, P + i)
        lg = dist.all_gather(lg, dec_plan.vocab_axis, dim=-1)
        logits.append(_np(dist.all_gather(lg, dec_plan.batch_axes, dim=0))[:, 0])
    # the positions of this rank's cache shard that hold K (first layer,
    # when it is a GQA layer)
    k = caches[0]["mixer"].get("k")
    filled = None if k is None else \
        (k.float().abs().sum(dim=(0, 1, 3)) > 0).nonzero()[:, 0].tolist()
    return np.stack(logits), filled


def reshard_experts(mesh, dist, dev, cfg, params):
    """The launcher's expert move, prefill plan -> decode plan, on a global
    tree: this rank's shards before and after."""
    pre = make_plan(cfg, ShapeCell("p", 16, 8, "prefill"), mesh.axes, mesh.shape)
    dec = make_plan(cfg, ShapeCell("d", 64, 8, "decode"), mesh.axes, mesh.shape)
    specs_pre, specs_dec = steps.param_specs(cfg, pre), steps.param_specs(cfg, dec)
    mine = shard_tree(params, specs_pre, mesh)
    moved = steps.reshard(mine, specs_pre, specs_dec, dist)
    return tree_map(_np, moved)


def serve_reduced(mesh, dist, dev, job):
    """``serve.serve_job`` as the launcher runs it."""
    from repro_torch.launch.serve import serve_job
    return serve_job(mesh, dist, dev, job)
