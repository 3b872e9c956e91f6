"""Sharded serving launcher: prefill and a decode loop on a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
        --mesh 2x2 --batch 8 --prompt-len 64 --max-seq 512 --new-tokens 32 \\
        [--a2a-fp8] [--ffn-2d] [--transport nccl|gloo] [--device cpu] \\
        [--reduced] [--layers N]

Port of ``repro.launch.serve``: batch over (pod,)data, TP and EP over
model in prefill, the KV cache sequence-sharded over model, EP over data
in decode. One process per rank, started here with a rendezvous on
localhost. It runs on the card unless ``--device cpu`` is given.
Transport: "nccl" puts one rank on each card and needs as many cards as
ranks; "gloo" runs ranks on the CPU or several ranks on one card (NCCL
refuses two ranks on one card), their collectives through host memory.
The default is nccl when there are enough cards, else gloo.

A job (``serve_job``) draws the global weights from ``--seed`` leaf by
leaf, each rank keeping its shards (``steps.init_params``), prefills
``batch`` prompts of ``prompt_len`` tokens drawn with
``numpy.random.default_rng(seed)`` (an encoder-decoder also encodes
``prompt_len`` audio frames a prompt, drawn from the same seed:
``frames``), re-lays the caches out for a capacity
of ``max_seq`` (``kvcache.pad_to_capacity``), moves the experts from the
prefill plan's layout (over model) to the decode plan's (over data) once
(``steps.reshard``), and decodes ``new_tokens - 1`` more tokens greedily.
With the job key ``dbo`` the decode is the DBO step
(``steps.build_dbo_decode_step``): each rank's rows are cut in two halves
after the one prefill, microbatch A the first, B the second, each with
its own caches (``kvcache.split_rows``), and the tokens and logits come
back in the plain job's row order.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs import get_arch, reduced_config
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import shard_leaf, tree_leaves
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.layers.common import dtype_of
from repro_torch.serving import kvcache
from repro_torch.sharding.dist import Dist
from repro_torch.sharding.plans import make_plan


def mesh_axes(shape: Sequence[int]) -> tuple:
    return ("pod", "data", "model")[-len(shape):]


def parse_mesh(text: str) -> tuple:
    return tuple(int(x) for x in text.split("x"))


def default_transport(n_ranks: int, device: str) -> str:
    """nccl when every rank can have a card of its own, else gloo."""
    if device != "cpu" and torch.cuda.is_available() \
            and torch.cuda.device_count() >= n_ranks:
        return "nccl"
    return "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_device(rank: int, transport: str, device: str) -> torch.device:
    if device == "cpu":
        if transport == "nccl":
            raise ValueError("nccl needs the card: use gloo with --device cpu")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    return torch.device("cuda", rank if transport == "nccl" else 0)


def _rank_main(rank, world, port, shape, transport, device, fn, args,
               wrap_dist, results):
    import torch.distributed as td
    try:
        dev = _rank_device(rank, transport, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
        td.init_process_group(transport, init_method=f"tcp://localhost:{port}",
                              world_size=world, rank=rank,
                              device_id=dev if transport == "nccl" else None)
        mesh = make_mesh(shape, mesh_axes(shape))
        dist = Dist.for_mesh(mesh, transport)
        if wrap_dist is not None:
            dist = wrap_dist(dist)
        td.barrier()
        out = fn(mesh, dist, dev, *args)
        td.barrier()
        td.destroy_process_group()
        results.put((rank, "ok", out))
    except BaseException:                                 # reported to the parent
        results.put((rank, "error", traceback.format_exc()))
        raise


def spawn(fn: Callable, args: tuple = (), *, mesh_shape=(2, 2),
          transport: Optional[str] = None, device: str = "cuda",
          wrap_dist: Optional[Callable] = None, timeout: float = 600) -> List[Any]:
    """Run ``fn(mesh, dist, device, *args)`` on every rank of a mesh of
    `mesh_shape`, one process per rank, and return each rank's result (in
    rank order). `fn`, `args`, `wrap_dist` and the results must pickle.
    `wrap_dist(dist)`, when given, wraps each rank's Dist (a counter, for
    instance). Raises when a rank fails or `timeout` seconds pass; every
    process is stopped before it returns."""
    import multiprocessing as mp
    world = int(np.prod(mesh_shape))
    transport = transport or default_transport(world, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, tuple(mesh_shape), transport,
                               device, fn, args, wrap_dist, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))} "
                                       f"did not finish in {timeout} s")
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(f"a rank exited with code {dead[0]}")
                continue
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return [out[r] for r in range(world)]


# ---------------------------------------------------------------------------
# one serving job on one rank
# ---------------------------------------------------------------------------

def prompts(vocab: int, batch: int, length: int, seed: int) -> np.ndarray:
    """The job's prompts: [batch, length] ids in [1, vocab)."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, vocab, (batch, length), dtype=np.int64)


def frames(d_model: int, batch: int, length: int, seed: int, step: int = 0) -> np.ndarray:
    """An encoder-decoder job's audio frames, already embedded (the audio
    frontend is a stub): [batch, length, d_model] float32 standard normal
    from ``numpy.random.default_rng([seed, 1, step])`` (a training job
    draws each step's anew)."""
    rng = np.random.default_rng([seed, 1, step])
    return rng.standard_normal((batch, length, d_model), dtype=np.float32)


# the reduction's single WKV head of 64 (d_model 64) cannot split over a
# model axis: a reduced job cuts the heads to 16 wide (4 heads)
REDUCED_RWKV_HEAD_DIM = 16


def job_config(job: dict):
    cfg = get_arch(job["arch"])
    if job.get("reduced"):
        cfg = reduced_config(cfg)
        if cfg.rwkv is not None:
            cfg = cfg.replace(rwkv=dataclasses.replace(cfg.rwkv,
                                                       head_dim=REDUCED_RWKV_HEAD_DIM))
    over = dict(job.get("config", {}))
    if job.get("layers"):
        over["num_layers"] = job["layers"]
    return cfg.replace(**over) if over else cfg


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _counts():
    c = tracing.counters()
    return {"moe_gmm": c["moe_gmm.launches"], "flash_decode": c["flash_decode.launches"],
            "flash_decode_lse": c["flash_decode_lse.launches"]}


def _hook(dist, name):
    """Call `dist.<name>()` when the Dist (a counting wrapper) has it."""
    fn = getattr(dist, name, None)
    return fn() if fn else None


def serve_job(mesh, dist: Dist, dev: torch.device, job: dict,
              after: Optional[Callable] = None) -> dict:
    """Run one job on this rank (see the module docstring). Job keys: arch,
    batch, prompt_len, max_seq, new_tokens; optional reduced, layers,
    config (ModelConfig overrides), seed, a2a_fp8, ffn_2d, dbo (decode
    through the DBO step), logits (gather the full f32 logits of every
    step, outside the timed step). `after`, when given, is called once the
    decode has ended, before the outputs are gathered, as ``after(ctx)``
    with ctx a dict of mesh, dist, dev, job, cfg, plan (the decode plan),
    decode (the plain decode step of the batch), params, caches (the plain
    step's layout), tok (the last token, not yet decoded) and pos (its
    position); its result is kept under "after". A ``dbo`` job has no
    `after`. Returns
    this rank's timings, peak memory, launch counts per phase and the
    Dist's snapshots (when it keeps any); rank 0 also the prompts, the
    tokens [B, new_tokens] and the logits [new_tokens, B, V_pad]. An
    encoder-decoder's prefill encodes ``frames(d_model, batch, prompt_len,
    seed)``, split as the tokens, in the model's dtype."""
    cfg = job_config(job)
    B, P, S, n_new = job["batch"], job["prompt_len"], job["max_seq"], job["new_tokens"]
    seed = job.get("seed", 0)
    shape = mesh.shape
    axes = mesh_axes(shape)
    fp8 = bool(job.get("a2a_fp8"))
    pre_plan = make_plan(cfg, ShapeCell("p", P, B, "prefill"), axes, shape, a2a_fp8=fp8)
    dec_plan = make_plan(cfg, ShapeCell("d", S, B, "decode"), axes, shape,
                         ffn_2d=bool(job.get("ffn_2d")), a2a_fp8=fp8)
    want_logits = bool(job.get("logits"))
    prefill = steps.build_prefill(cfg, ShapeCell("p", P, B, "prefill"), pre_plan,
                                  mesh, dist=dist, logits=want_logits)
    decode = steps.build_decode_step(cfg, ShapeCell("d", S, B, "decode"), dec_plan,
                                     mesh, dist=dist, logits=want_logits)
    use_dbo = bool(job.get("dbo"))
    if use_dbo:
        if after is not None:
            raise ValueError("a dbo job takes no `after`")
        dbo_step = steps.build_dbo_decode_step(cfg, ShapeCell("d", S, B, "decode"),
                                               dec_plan, mesh, dist=dist,
                                               logits=want_logits)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res: Dict[str, Any] = {"rank": mesh.rank, "coords": mesh.coords(),
                           "plans": {"prefill": repr(pre_plan), "decode": repr(dec_plan)},
                           "snapshots": {}}

    t0 = time.perf_counter()
    params = steps.init_params(cfg, pre_plan, mesh, seed=seed, device=dev)
    _sync(dev)
    res["init_s"] = time.perf_counter() - t0
    batch = {"tokens": torch.from_numpy(shard_leaf(prompts(cfg.vocab_size, B, P, seed),
                                                   prefill.in_specs["tokens"], mesh)).to(dev)}
    if cfg.frontend == "audio_frames":
        batch["frames"] = torch.from_numpy(shard_leaf(
            frames(cfg.d_model, B, P, seed), prefill.in_specs["frames"],
            mesh)).to(dev, dtype_of(cfg))

    def phase(name, fn):
        tracing.reset()
        _hook(dist, "reset")
        _sync(dev)
        t = time.perf_counter()
        out = fn()
        _sync(dev)
        res[f"{name}_s"] = time.perf_counter() - t
        res.setdefault("launches", {})[name] = _counts()
        res["snapshots"][name] = _hook(dist, "snapshot")
        return out

    out = phase("prefill", lambda: prefill(params, batch))
    tok, caches = out[0], out[1]
    toks, logits, step_s = [tok], [out[2]] if want_logits else [], []
    caches = phase("relayout", lambda: kvcache.pad_to_capacity(cfg, caches, P, S,
                                                              dec_plan, dist))
    phase("reshard", lambda: steps.reshard(params, prefill.param_specs,
                                           decode.param_specs, dist))

    def decode_all():
        nonlocal tok
        for i in range(n_new - 1):
            t = time.perf_counter()
            o = decode(params, caches, tok, P + i)
            _sync(dev)
            step_s.append(time.perf_counter() - t)
            tok = o[0]
            toks.append(tok)
            if want_logits:
                logits.append(o[2])

    def decode_dbo(ca, cb):
        ta, tb = tok.chunk(2, dim=0)
        for i in range(n_new - 1):
            t = time.perf_counter()
            o = dbo_step(params, ca, cb, ta, tb, P + i)
            _sync(dev)
            step_s.append(time.perf_counter() - t)
            ta, tb, ca, cb = o[:4]
            toks.append(torch.cat([ta, tb], dim=0))
            if want_logits:
                logits.append(torch.cat(o[4:], dim=0))
        return ca + cb
    if use_dbo:
        # microbatch A: each rank's first half of its rows, B the second
        halves = kvcache.split_rows(caches)
        del caches
        caches = phase("decode", lambda: decode_dbo(*halves))
        del halves
    else:
        phase("decode", decode_all)
        if after is not None:
            res["after"] = after(dict(mesh=mesh, dist=dist, dev=dev, job=job, cfg=cfg,
                                      plan=dec_plan, decode=decode, params=params,
                                      caches=caches, tok=tok, pos=P + n_new - 1))
    # the outputs are gathered after the counted phases
    bax = dec_plan.batch_axes
    toks = dist.all_gather(torch.cat(toks, dim=1), bax, dim=0)
    if want_logits:
        lg = dist.all_gather(torch.stack(logits)[:, :, 0], dec_plan.vocab_axis, dim=-1)
        logits = dist.all_gather(lg, bax, dim=1)
    res["decode_step_s"] = step_s
    if dev.type == "cuda":
        res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    res["param_bytes"] = sum(x.numel() * x.element_size()
                             for x in tree_leaves(params))
    res["cache_bytes"] = kvcache.memory_bytes(caches)
    del params, caches
    if dev.type == "cuda":            # ranks may share the card
        torch.cuda.empty_cache()
    if mesh.rank == 0:
        res["tokens"] = toks.cpu().numpy()
        if want_logits:
            res["logits"] = logits.cpu().numpy()
        res["prompts"] = prompts(cfg.vocab_size, B, P, seed)
    return res


def _serve_jobs(mesh, dist, dev, jobs):
    return [serve_job(mesh, dist, dev, job) for job in jobs]


def serve(jobs: List[dict], *, mesh_shape=(2, 2), transport: Optional[str] = None,
          device: str = "cuda", wrap_dist: Optional[Callable] = None,
          timeout: float = 900) -> List[List[dict]]:
    """Run `jobs` one after another on one set of rank processes; returns
    [rank][job] results."""
    return spawn(_serve_jobs, (jobs,), mesh_shape=mesh_shape, transport=transport,
                 device=device, wrap_dist=wrap_dist, timeout=timeout)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to N layers")
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ffn-2d", action="store_true")
    ap.add_argument("--a2a-fp8", action="store_true")
    ap.add_argument("--transport", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    shape = parse_mesh(args.mesh)
    transport = args.transport or default_transport(int(np.prod(shape)), args.device)
    job = dict(arch=args.arch, reduced=args.reduced, layers=args.layers,
               batch=args.batch, prompt_len=args.prompt_len, max_seq=args.max_seq,
               new_tokens=args.new_tokens, seed=args.seed, ffn_2d=args.ffn_2d,
               a2a_fp8=args.a2a_fp8)
    print(f"mesh {dict(zip(mesh_axes(shape), shape))}; arch {args.arch}"
          f"{' (reduced)' if args.reduced else ''}; transport {transport}; "
          f"device {args.device}", flush=True)
    ranks = serve([job], mesh_shape=shape, transport=transport, device=args.device)
    r0 = ranks[0][0]
    steps_s = r0["decode_step_s"]
    print(f"prefill {args.batch}x{args.prompt_len} in {r0['prefill_s']:.3f} s; "
          f"decode {len(steps_s)} steps in {sum(steps_s):.3f} s "
          f"({args.batch * len(steps_s) / max(sum(steps_s), 1e-9):.1f} tok/s on "
          f"{args.device}, {transport})")
    for b in range(min(args.batch, 3)):
        print(f"  seq {b}: {r0['tokens'][b].tolist()}")
    print(f"plans: {r0['plans']['decode']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
