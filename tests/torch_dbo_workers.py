"""Rank functions for ``test_torch_dbo_sharded.py`` (gloo on the CPU).

``repro_torch.launch.serve.spawn`` runs ``run_cases`` on every rank of a
2x2 ("data", "model") mesh. It imports torch, numpy and the port only (no
JAX) and returns numpy arrays and flags.
"""
import torch

from repro_torch.configs.base import ShapeCell
from repro_torch.convert import shard_leaf, shard_tree, tree_leaves
from repro_torch.launch import steps
from repro_torch.launch.serve import serve_job
from repro_torch.sharding.counting import CountingDist
from repro_torch.sharding.plans import make_plan
from torch_sharded_workers import _np, rank_input

# (axis, split_dim, concat_dim) of the split all-to-all cases
A2A_CASES = (("data", 0, 1), ("data", 1, 0), ("model", 0, 2), ("model", 2, 1),
             (("data", "model"), 0, 1))


def split_a2a(mesh, dist, dev):
    """``all_to_all_start`` / ``wait`` against ``all_to_all`` on this rank's
    input: bit for bit, observed once with the synchronous call's
    arguments, counted alike by ``CountingDist``, two handles in flight on
    one group under a collective on another and waited out of order, the
    refusals. On `dev` (CUDA tensors: over nccl, or through gloo's pinned
    host staging). Returns {check: bool}."""
    out = {}
    seen = []
    dist.observer = lambda op, x, axis, **info: seen.append(
        (op, tuple(x.shape), x.dtype, axis, info))
    for dt in ("float32", "bfloat16", "uint8"):
        x = torch.from_numpy(rank_input(mesh.rank, dt)).to(dev)
        if dt == "bfloat16":
            x = x.to(torch.bfloat16)
        for axis, s, c in A2A_CASES:
            seen.clear()
            want = dist.all_to_all(x, axis, s, c)
            sync_seen = list(seen)
            h = dist.all_to_all_start(x, axis, s, c)
            got = h.wait()
            out[f"equal {dt} {axis} {s}->{c}"] = (
                got.dtype == want.dtype and torch.equal(got, want))
            # once as the synchronous call is (an axis of 1 runs no collective)
            out[f"observed once {dt} {axis} {s}->{c}"] = (
                len(sync_seen) == (dist.size(axis) > 1) and seen == sync_seen * 2)
    x = torch.from_numpy(rank_input(mesh.rank)).to(dev)
    # two in flight on "data", a psum over "model" between, waited out of order
    want1, want2 = dist.all_to_all(x, "data", 0, 1), dist.all_to_all(2 * x, "data", 1, 0)
    want_p = dist.psum(x, "model")
    h1 = dist.all_to_all_start(x, "data", 0, 1)
    h2 = dist.all_to_all_start(2 * x, "data", 1, 0)
    out["pending two"] = dist.pending == 2
    got_p = dist.psum(x, "model")
    got2, got1 = h2.wait(), h1.wait()
    out["two in flight"] = all(torch.equal(g, w) for g, w in
                               ((got1, want1), (got2, want2), (got_p, want_p)))
    out["pending none"] = dist.pending == 0
    try:
        h1.wait()
        out["second wait refused"] = False
    except RuntimeError:
        out["second wait refused"] = True
    try:
        dist.all_to_all_start(x.clone().requires_grad_(True), "data", 0, 1)
        out["gradient refused"] = False
    except ValueError:
        out["gradient refused"] = dist.pending == 0
    cd = CountingDist(dist)
    counts = []
    for run in (lambda: cd.all_to_all(x, "data", 0, 1),
                lambda: cd.all_to_all_start(x, "data", 0, 1).wait()):
        cd.reset()
        run()
        counts.append(cd.snapshot())
    out["counted alike"] = counts[0] == counts[1] == {
        "dispatch": {"calls": 1, "bytes": x.numel() * 4 // 2}}
    dist.observer = None
    return out


def dbo_vs_plain(mesh, dist, job):
    """The sharded DBO step against two plain sharded decode steps of B/2 on
    the same caches, `steps` steps from `pos` (each side feeds its own
    greedy tokens): per step, the tokens and logits bit for bit and the
    collective bytes and calls of the DBO step equal to the pair's; after
    every step no all-to-all handle waiting; at the end, every cache leaf
    bit for bit. Rank 0 also returns the gathered tokens and f32 logits of
    each step, per microbatch."""
    cfg, B, S = job["cfg"], job["batch"], job["seq"]
    cell = ShapeCell("d", S, B, "decode")
    plan = make_plan(cfg, cell, mesh.axes, mesh.shape, fsdp=False, **job.get("plan_kw", {}))
    cd = CountingDist(dist)
    dbo = steps.build_dbo_decode_step(cfg, cell, plan, mesh, dist=cd, logits=True)
    half = steps.build_decode_step(cfg, ShapeCell("d", S, B // 2, "decode"), plan, mesh,
                                   dist=cd, logits=True)
    params = shard_tree(job["params"], dbo.param_specs, mesh)
    tok = [torch.from_numpy(shard_leaf(t, dbo.in_specs["tokens"], mesh))
           for t in job["tokens"]]
    mine = [shard_tree(c, dbo.cache_specs, mesh) for c in job["caches"]]
    plain = [shard_tree(c, dbo.cache_specs, mesh) for c in job["caches"]]
    ta, tb, pa, pb = tok[0], tok[1], tok[0], tok[1]
    res = {"tokens_equal": True, "logits_equal": True, "counts_equal": True,
           "pending_zero": True, "counts": [], "tokens": [], "logits": []}
    for i in range(job["steps"]):
        pos = job["pos"] + i
        cd.reset()
        pa, plain[0], lpa = half(params, plain[0], pa, pos)
        pb, plain[1], lpb = half(params, plain[1], pb, pos)
        pair = cd.snapshot()
        cd.reset()
        ta, tb, mine[0], mine[1], la, lb = dbo(params, mine[0], mine[1], ta, tb, pos)
        got = cd.snapshot()
        res["counts"].append(got)
        res["counts_equal"] &= got == pair
        res["pending_zero"] &= dist.pending == 0
        res["tokens_equal"] &= torch.equal(ta, pa) and torch.equal(tb, pb)
        res["logits_equal"] &= torch.equal(la, lpa) and torch.equal(lb, lpb)
        toks, lgs = [], []
        for t, lg in ((ta, la), (tb, lb)):
            lg = dist.all_gather(lg, plan.vocab_axis, dim=-1)
            toks.append(_np(dist.all_gather(t, plan.batch_axes, dim=0)))
            lgs.append(_np(dist.all_gather(lg, plan.batch_axes, dim=0))[:, 0])
        res["tokens"].append(toks)
        res["logits"].append(lgs)
    res["caches_equal"] = all(torch.equal(g, w) for g, w in
                              zip(tree_leaves(mine), tree_leaves(plain)))
    res["a2a_calls_per_step"] = {k: v["calls"] for k, v in res["counts"][0].items()
                                 if k in ("dispatch", "combine")}
    dist.observer = None
    if mesh.rank:
        del res["tokens"], res["logits"]
    return res


def split_a2a_rank(mesh, dist, dev):
    """``split_a2a`` alone (the card's test)."""
    return split_a2a(mesh, dist, dev)


def run_cases(mesh, dist, dev, jobs):
    """Every case on this rank: "split_a2a", a "dbo" job (``dbo_vs_plain``)
    or a "serve" job (``serve.serve_job`` as the launcher runs it)."""
    out = []
    for job in jobs:
        if job["kind"] == "split_a2a":
            out.append(split_a2a(mesh, dist, dev))
        elif job["kind"] == "dbo":
            out.append(dbo_vs_plain(mesh, dist, job))
        else:
            res = serve_job(mesh, dist, dev, job["job"])
            out.append({k: res[k] for k in ("tokens", "logits") if k in res})
    return out

