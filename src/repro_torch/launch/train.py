"""Training launcher across ranks: mesh, sharded step, data, checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --reduced --mesh 2x2 --steps 5 [--batch 8 --seq 64 --lr 3e-4] \\
        [--ckpt-dir DIR [--resume]] [--layers N] [--transport nccl|gloo] \\
        [--device cpu]

Port of ``repro.launch.train``: the batch over (pod,)data, FSDP over data,
TP, EP and the sequence over model (``make_plan``'s training plan). One
process per rank, started by ``launch.serve.spawn`` with a rendezvous on
localhost; it runs on the card unless ``--device cpu`` is given, and the
transport follows ``serve.default_transport`` unless ``--transport`` names
one. Each rank draws its shards of the global weights from ``--seed``
(``steps.init_params``), takes its block of each ``SyntheticLM`` batch
(and, for an encoder-decoder, of the step's audio frames
``serve.frames``, split as the tokens), and runs
``steps.build_train_step``'s step (no remat, as the JAX launcher); rank
0 prints the loss of every step and the tokens/s. With ``--ckpt-dir`` the
run saves the global state at its end in ``mesh[-1]`` files a leaf, and
``--resume`` restores the latest step into this mesh's layout first.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ShapeCell
from repro_torch.convert import shard_leaf, tree_leaves
from repro_torch.kernels import moe_gmm as kmoe
from repro_torch.launch import serve, steps
from repro_torch.models.layers.common import dtype_of
from repro_torch.sharding.plans import make_plan
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optim
from repro_torch.training.data import DataConfig, SyntheticLM


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_job(mesh, dist, dev: torch.device, job: dict,
              on_grads: Optional[Callable] = None) -> Dict[str, Any]:
    """Train on this rank. Job keys: arch, batch, seq, steps; optional
    reduced, layers, config (ModelConfig overrides), seed, lr, fsdp
    (default on), remat, ring_attn, ag_fp8, a2a_fp8, ckpt_dir, resume,
    log (rank 0 prints each step), count_step (the step, from 0, whose
    parts are timed apart, and whose collectives the Dist counts part by
    part when it keeps counts).
    ``on_grads(i, params, grads)``, when given, sees each step's reduced
    gradients before the update. Returns this rank's losses, step times,
    per-step ``moe_gmm`` launches, peak memory, and the count step's part
    times and counted collectives."""
    cfg = serve.job_config(job)
    B, S, n_steps = job["batch"], job["seq"], job["steps"]
    seed = job.get("seed", 0)
    cell = ShapeCell("train", S, B, "train")
    plan = make_plan(cfg, cell, serve.mesh_axes(mesh.shape), mesh.shape,
                     fsdp=job.get("fsdp", True), ring_attn=bool(job.get("ring_attn")),
                     ag_fp8=bool(job.get("ag_fp8")), a2a_fp8=bool(job.get("a2a_fp8")))
    step = steps.build_train_step(cfg, cell, plan, mesh, dist=dist,
                                  remat=bool(job.get("remat")), lr=job.get("lr", 3e-4))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = steps.init_params(cfg, plan, mesh, seed=seed, device=dev)
    opt = optim.init_state(params)
    _sync(dev)
    res: Dict[str, Any] = {"rank": mesh.rank, "coords": mesh.coords(), "plan": repr(plan),
                           "init_s": time.perf_counter() - t0}
    specs = {"params": step.param_specs, "opt": step.opt_specs}
    start, ckpt_dir = 0, job.get("ckpt_dir")
    if job.get("resume") and ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        state, start = ckpt.restore({"params": params, "opt": opt}, ckpt_dir,
                                    specs=specs, mesh=mesh)
        params, opt = state["params"], state["opt"]
        if mesh.rank == 0 and job.get("log"):
            print(f"resumed from step {start}", flush=True)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B, seed=seed))
    losses, step_s, launches, counts, parts = [], [], [], {}, {}
    count_step = job.get("count_step")
    counting = hasattr(dist, "snapshot")

    def mark(name, t0, timing):
        """End part `name` of a step begun at t0; on the count step, keep
        its time and its collectives."""
        if timing:
            _sync(dev)
            parts[name] = time.perf_counter() - t0
            if counting:
                counts[name] = dist.snapshot()
                dist.reset()
        return time.perf_counter()

    def batch(i):
        out = {"tokens": torch.from_numpy(shard_leaf(data.batch(i), step.in_specs["tokens"],
                                                     mesh)).to(dev)}
        if cfg.frontend == "audio_frames":
            out["frames"] = torch.from_numpy(shard_leaf(
                serve.frames(cfg.d_model, B, S, seed, step=i), step.in_specs["frames"],
                mesh)).to(dev, dtype_of(cfg))
        return out

    for i in range(start, start + n_steps):
        inputs = batch(i)
        timing = i - start == count_step
        n0 = kmoe.launches
        _sync(dev)
        t = t1 = time.perf_counter()
        if timing and counting:
            dist.reset()
        loss, grads = step.loss_and_grads(params, inputs)
        t1 = mark("loss_and_backward", t1, timing)
        grads = step.reduce(params, grads)
        t1 = mark("gradient_reduction", t1, timing)
        if on_grads is not None:
            on_grads(i, params, grads)
            t1 = time.perf_counter()
        step.update(params, grads, opt)
        mark("update", t1, timing)
        del grads
        loss = float(loss)
        _sync(dev)
        step_s.append(time.perf_counter() - t)
        launches.append(kmoe.launches - n0)
        losses.append(loss)
        if mesh.rank == 0 and job.get("log"):
            print(f"step {i}: loss {loss:.4f} ({step_s[-1]:.2f} s)", flush=True)
    res.update(losses=losses, step_s=step_s, moe_gmm_launches=launches,
               collectives=counts, part_s=parts, first_step=start,
               param_bytes=sum(x.numel() * x.element_size() for x in tree_leaves(params)))
    if dev.type == "cuda":
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    if ckpt_dir:
        res["ckpt"] = ckpt.save({"params": params, "opt": opt}, ckpt_dir, start + n_steps,
                                n_shards=mesh.shape[-1], specs=specs, dist=dist)
    del params, opt
    if dev.type == "cuda":            # ranks may share the card
        torch.cuda.empty_cache()
    return res


def _train_jobs(mesh, dist, dev, jobs):
    return [train_job(mesh, dist, dev, job) for job in jobs]


def train(jobs, *, mesh_shape=(2, 2), transport: Optional[str] = None,
          device: str = "cuda", wrap_dist: Optional[Callable] = None,
          timeout: float = 900):
    """Run `jobs` one after another on one set of rank processes; returns
    [rank][job] results."""
    return serve.spawn(_train_jobs, (jobs,), mesh_shape=mesh_shape, transport=transport,
                       device=device, wrap_dist=wrap_dist, timeout=timeout)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--reduced", action="store_true",
                    help="family-preserving reduced config (CPU-friendly)")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to N layers")
    ap.add_argument("--mesh", default="2x2",
                    help="AxB -> (data, model) or AxBxC -> (pod, data, model)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--transport", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    shape = serve.parse_mesh(args.mesh)
    transport = args.transport or serve.default_transport(int(np.prod(shape)), args.device)
    job = dict(arch=args.arch, reduced=args.reduced, layers=args.layers,
               batch=args.batch, seq=args.seq, steps=args.steps, lr=args.lr,
               seed=args.seed, ckpt_dir=args.ckpt_dir, resume=args.resume, log=True)
    print(f"mesh {dict(zip(serve.mesh_axes(shape), shape))}; arch {args.arch}"
          f"{' (reduced)' if args.reduced else ''}; transport {transport}; "
          f"device {args.device}", flush=True)
    r0 = train([job], mesh_shape=shape, transport=transport, device=args.device)[0][0]
    n = len(r0["step_s"])
    dt = sum(r0["step_s"])
    print(f"{r0['param_bytes'] / 2 ** 20:.1f} MiB of parameters on rank 0; "
          f"{n} steps in {dt:.1f} s ({n * args.batch * args.seq / max(dt, 1e-9):.0f} "
          f"tok/s on {args.device}, {transport})")
    if "ckpt" in r0:
        print(f"checkpoint -> {r0['ckpt']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
