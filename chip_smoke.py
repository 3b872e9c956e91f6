#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --sharded-only    # phases 14 and 15 (across ranks) alone
    python3 chip_smoke.py --sharded-only deepseek-v3 jamba-v0.1-52b   # the named ones
    python3 chip_smoke.py --sharded-only rwkv6-1.6b seamless-m4t-medium train_sharded

Phases, each printing its own lines before the last:
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build: every CUDA kernel of ``src/repro_torch/csrc`` compiled with nvcc,
     one process per source, all at once; each kernel's registers and local
     (spilled) bytes per thread;
  3. kernels against their plain PyTorch versions on the card, at the main
     paths' shapes (olmoe-1b-7b, starcoder2-3b, granite-moe-3b-a800m,
     gemma3-1b's ring and full caches, deepseek-v3, jamba-v0.1-52b,
     deepseek-67b's g = 8, seamless-m4t-medium's g = 1 self-attention and
     its cross-attention over the whole cache) and at edge shapes, with
     device times
     (``time_ms``: the host's enqueue cost kept out), bounds and library
     yardsticks;
  4. float32 parity: olmoe-1b-7b at full width and 2 layers, the card's
     path (kernels) against the port's plain CPU path on the same weights;
  5. main path: full olmoe-1b-7b (16 layers, bf16, random weights from seed
     0) served by ``Engine(max_batch=8, max_seq=512)``: 16 requests of 16-128
     prompt tokens and 32 new tokens; the kernels' launch counters must show
     16 calls of each per decode wave, and every ``moe_gmm`` call (16 per
     wave and per prefill) in its tensor-core variant;
  6. where a decode wave's device time goes (torch.profiler), with each
     kernel's span per call there. Each kernel's ``time_ms`` must agree
     within 15 % with the profiler's span of its calls, queued the same
     way behind the same spin (``profiled_ms``);
  7. ``dbo``: full olmoe-1b-7b, two microbatches of 4; the DBO step must be
     bitwise equal to two plain decode steps (tokens and caches), and its
     device time is logged beside theirs;
  8. ``specdec``: speculative decoding on full olmoe-1b-7b (4 rows) and full
     gemma3-1b (1 row, past position 1024, so the rolled-back rings wrap),
     with untrained heads and with an oracle draft, each equal to greedy;
  9. ``main_path.<arch>``: starcoder2-3b, granite-moe-3b-a800m and gemma3-1b
     at full width and depth, bf16, through the same engine (gemma3 with one
     request from position 1000 to past 1024), each with its profile;
 10. float32 parity of gemma3-1b at full width and 6 layers (one period:
     five ring layers and a global one), a prompt past the window;
 11. deepseek-v3 (MLA, 256 experts top-8) at full width cut to 2 of 61
     layers and jamba-v0.1-52b (Mamba + attention, 16 experts top-2) cut to
     one period, 8 of 32 layers, each served by the engine with its
     profile; the device share of deepseek-v3's plain-torch MLA decode;
     ``dbo.deepseek-v3`` on the same weights; ``specdec.jamba-v0.1-52b`` at
     one row (rejected drafts roll the SSM state back); float32 parity of
     deepseek-v3 at 2 layers with 32 of its experts and of jamba at its
     first 5 layers with 4 of its experts, prompts of 2, 40 and 130 tokens;
 12. the dense and attention-free configurations and the encoder-decoder:
     ``main_path.minitron-8b`` (all 32 layers), ``main_path.deepseek-67b``
     (40 of 95 layers, g = 8), ``main_path.rwkv6-1.6b`` (all 24 layers, no
     kernel) with ``specdec.rwkv6-1.6b`` at one row (rejected drafts roll
     the WKV state and both token shifts back) and
     ``main_path.seamless-m4t-medium`` (12 encoder + 12 decoder layers,
     cross-attention through ``flash_decode`` over the whole padded
     encoder cache), each with its profile; ``prefill_patches.internvl2-76b``
     (16 of 80 layers): B = 2, 256 patch embeddings and 64 text tokens
     through ``prefill``, then 16 decode steps; float32 parity of rwkv6 at
     2 layers (prompts of 2, 40 and 130 tokens, past two scan chunks) and
     of seamless at 2 + 2 layers on random frames;
 13. training: ``kernel.moe_gmm.grad`` (after the kernel checks): forward
     and backward through ``MoeGmm`` against autograd of the plain version
     at olmoe's training shape (E=64, T=768, bf16) and an odd T in f32;
     ``parity_f32.train`` (after ``parity_f32``): the loss and every
     gradient of olmoe-1b-7b at 2 layers, card against CPU; then
     ``train.olmoe-1b-7b``: the port's ``Trainer`` at published widths,
     8 of 16 layers, 10 steps of 8 x 512 tokens (the loss must fall, every
     expert must get a gradient, ``moe_gmm`` once per layer and step),
     ``profile.train`` (one more step), and at 1 layer, where checkpoints
     fit the machine's disk, ``train.resume`` (a fresh Trainer restored at
     step 4 reaches step 10 bit for bit, under deterministic algorithms)
     and ``train.recovery`` (failures before steps 3 and 7, 2 restarts).
 14. sharded serving (after ``specdec.olmoe-1b-7b``): ``kernel.flash_decode_lse``
     (after the other kernels) holds the (o, m, l) form of ``flash_decode``
     against its plain version at one rank's shard (B 4, S_loc 256 of 512,
     H = KH = 16, hd 128), with an empty shard; ``sharded.olmoe-1b-7b``
     serves full olmoe-1b-7b through ``launch.serve`` on a 2x2 mesh (nccl
     with a card per rank, else four ranks on card 0 over gloo): bf16, the
     fp8 dispatch, and f32 at 8 layers, each held against the single-device
     port fed the same tokens (bf16 and fp8 replaying the run's expert
     choices, f32 on its own), with per-rank step times, peak memory,
     launches and collective bytes per step by kind (``CountingDist``);
     then the same for the sharded Mamba and MLA mixers,
     ``sharded.deepseek-v3`` (1 of 61 layers; f32 with 32 of 256 experts;
     with four cards also 4 layers, timed only) and
     ``sharded.jamba-v0.1-52b`` (8 of 32 layers; f32 at 5), whose
     references replay the run's expert choices; then RWKV and
     cross-attention, ``sharded.rwkv6-1.6b`` (24 layers) and
     ``sharded.seamless-m4t-medium`` (12 + 12, the frames drawn from the
     seed, ``flash_decode_lse`` on self- and cross-attention), bf16 and
     f32, their all-reduce and all-gather bytes held to the shapes'
     prediction; ``kernel.flash_decode_lse`` also at seamless's two shard
     shapes (hd 64) and at a DBO microbatch's olmoe shard (B 2). DBO
     across ranks: after the decode of ``sharded.olmoe-1b-7b``'s bf16 job
     (and, with four cards, of ``sharded.deepseek-v3``'s 4-layer job), on
     the job's weights and caches, every rank cuts its rows in two and
     runs 4 steps of the DBO step (``steps.build_dbo_decode_step``: each
     microbatch's expert all-to-alls started and waited around the other's
     compute), two plain steps of B/2 and one plain step of B; the DBO
     tokens, logits and caches must be bitwise the plain pair's, its
     collective bytes and calls a step and its launches the pair's
     exactly, no all-to-all handle left waiting; then rank 0 profiles 2
     DBO steps and 2 plain pairs: device ms of the NCCL all-to-all kernels,
     of compute, the share of all-to-all time under compute on another
     stream, and the idle share (``device_split``).
 15. training across ranks (after ``sharded.olmoe-1b-7b``):
     ``train_sharded.olmoe-1b-7b`` trains olmoe-1b-7b at published widths,
     4 of 16 layers, through ``launch.train`` on the same 2x2 mesh (FSDP
     over data; EP, TP and the sequence over model): 6 steps of 8 x 512
     tokens in bf16 with the bf16 and with the fp8 dispatch, and the f32
     gates at 2 layers (FSDP, and FSDP with ring attention), jamba's at
     1 layer (its Mamba layer's backward), rwkv6's at 2 and seamless's at
     2 + 2 against the single-device port;
     ``kernel.moe_gmm.grad`` times the kernel at one rank's training shape
     (E_loc 32, T 384).
 16. the cost model (after ``kernel.moe_gmm.grad``): ``sweep.torch_grid``
     evaluates the product grid of ``benchmarks/fig_product_grid.py``
     (deepseek-v3, 192 clusters x 64 scenarios x 84 batches: 1,032,192 TPOT
     cells) with ``TorchGridEngine`` in float64 on the card, and holds the
     card to the engine's CPU path on one block of 8 clusters, with and
     without DBO and on a Zipf-skewed scenario; then ``cost.solve`` asks
     the paper's question through the port's search (``api.solve_levels``
     with the torch backend on the card): fig14's grid (deepseek-v3 at 61
     layers, 64 H100s, the four topologies, the six ``SCENARIOS``, levels
     noopt and dbo+sd) and the Pareto sweep of ``pareto.sweep_networks``,
     each held field by field to the same call with ``backend="numpy"``,
     throughput per cost from ``tco.cluster_tco`` and the switchless gain
     over scale-up logged; then ``examples/quickstart_torch.py`` runs on
     the card in a subprocess;
 17. the dry run (after the sharded serving phases): ``dryrun`` traces the
     cell ``sharded.olmoe-1b-7b`` served, one rank of its 2x2 mesh on a
     fake process group with fake tensors (``launch.dryrun``, in a process
     of its own), and holds its collective bytes and calls per kind and
     its argument bytes to what that phase counted on the card; then the
     roofline of olmoe-1b-7b and jamba-v0.1-52b at decode_32k on the 16x16
     production mesh. ``--sharded-only`` runs it after
     ``sharded.olmoe-1b-7b``.
Every path sets the launch counters to 0 just before it and reads them
just after; ``flash_decode`` must run once per GQA layer and step (never
on MLA, Mamba or RWKV layers), once more per decoder layer with
cross-attention, and ``moe_gmm`` once per MoE layer and step. Then one JSON line of per-kernel numbers, and as the last
line ``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero; without a CUDA device it exits non-zero before
printing a result. Results also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, per data sheet
SEED = 0
TRAIN_LAYERS = 8       # of olmoe-1b-7b's 16: peak memory under 72 GiB
CKPT_LAYERS = 1        # for the phases that write checkpoints


def log(phase: str, **kv):
    print(f"[{phase}] " + json.dumps(kv, sort_keys=True), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


_cycles_per_ms = None
_floor_ms = None


def _spin_cycles_per_ms(torch) -> float:
    """The device's spin rate for torch.cuda._sleep, from CUDA events."""
    global _cycles_per_ms
    if _cycles_per_ms is None:
        torch.cuda._sleep(1_000_000)                  # warm the clock up
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(10_000_000)
        e.record()
        torch.cuda.synchronize()
        _cycles_per_ms = 10_000_000 / s.elapsed_time(e)
    return _cycles_per_ms


def _queue_timed_calls(torch, fn, iters: int, cycles: int, flush):
    """Queue `iters` calls of `fn`, each behind an L2 flush and a device
    spin of `cycles`, between its own pair of CUDA events; wait for them.
    Returns the pairs and whether any call was late: its start event had
    already passed when the host finished queueing it."""
    pairs, late = [], 0
    for _ in range(iters):
        flush.sum()
        torch.cuda._sleep(cycles)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        late += s.query()                             # device got there first
        pairs.append((s, e))
    torch.cuda.synchronize()
    return pairs, bool(late)


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _event_ms(torch, fn, iters: int, warmup: int):
    """(median ms between the CUDA events around one call, the spin in
    cycles that kept every call's enqueue ahead of the device); see
    ``time_ms``."""
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0                 # enqueue only, no sync
    torch.cuda.synchronize()
    cycles = int((3 * 1e3 * host_s + 0.05) * _spin_cycles_per_ms(torch))
    for _ in range(4):
        pairs, late = _queue_timed_calls(torch, fn, iters, cycles, flush)
        if not late:
            return _median([s.elapsed_time(e) for s, e in pairs]), cycles
        cycles *= 2
    raise AssertionError("time_ms: the host could not enqueue the call "
                         "within the device spin")


def event_floor_ms(torch) -> float:
    """The time ``_event_ms`` gives an empty call: the event pair's own cost."""
    global _floor_ms
    if _floor_ms is None:
        _floor_ms = _event_ms(torch, lambda: None, iters=51, warmup=3)[0]
    return _floor_ms


def time_ms(torch, fn, iters: int = 21, warmup: int = 3, spin: list | None = None) -> float:
    """Median device time of one call.

    Before each call the stream gets a 64 MB read, which evicts the 50 MB
    L2 and leaves it clean, as the decode step's weight stream does between
    two layers' calls, and then a device spin (torch.cuda._sleep) longer
    than the host takes to enqueue the call. So the start event, the call's
    kernels and the end event are all queued before the device reaches
    them, and the host's enqueue cost stays out of the time. After each call
    the start event must still be pending; if any was not, the spin was too
    short, and all the calls are taken again with a spin twice as long.
    The median time between the events, less that of an empty call
    (``event_floor_ms``), is the call's device time. The spin used is
    appended to `spin` when given."""
    ms, cycles = _event_ms(torch, fn, iters, warmup)
    if spin is not None:
        spin.append(cycles)
    return ms - event_floor_ms(torch)


# substrings of each wrapper's kernel names, and its kernels per call
KERNEL_NAMES = {"moe_gmm": (("moe_gmm_active", "moe_gmm_wgmma"), 3),
                "flash_decode": (("flash_decode",), 2)}


def call_times(prof, pats, per_call):
    """(span, busy, n) of a wrapper's calls in a profile: span and busy in
    ms, each the median over the n calls. The span runs from the call's
    first kernel's start to its last kernel's end; busy is the time in
    which at least one of its kernels runs, without the gaps between them.
    (None, None, 0) when the profile holds no such call."""
    from torch.autograd import DeviceType
    mine = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and any(p in e.name for p in pats)), key=lambda e: e.time_range.start)
    calls = [mine[i:i + per_call] for i in range(0, len(mine) - per_call + 1, per_call)]
    if not calls:
        return None, None, 0
    spans, busy = [], []
    for call in calls:
        total, end = 0.0, -math.inf
        for e in call:                                # union of the intervals
            total += max(0.0, e.time_range.end - max(e.time_range.start, end))
            end = max(end, e.time_range.end)
        busy.append(total)
        spans.append(call[-1].time_range.end - call[0].time_range.start)
    return _median(spans) / 1e3, _median(busy) / 1e3, len(calls)


def profiled_ms(torch, fn, name: str, cycles: int, iters: int = 21) -> float:
    """The profiler's median device span of one call of `fn`: the calls
    queued as ``time_ms`` queued them, behind the same flush and the spin
    (`cycles`) that ``time_ms`` settled on, and nothing else in the
    profile. A pass with a late call (its span may hold the host's gap
    before a later kernel) is dropped and taken again with twice the spin:
    the cross-check of ``time_ms``."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, late = _queue_timed_calls(torch, fn, iters, cycles, flush)
        if not late:
            span, _, n = call_times(prof, *KERNEL_NAMES[name])
            if n != iters:
                raise AssertionError(f"profiled_ms: {n} calls of {name} in the "
                                     f"profile, want {iters}")
            return span
        cycles *= 2
    raise AssertionError("profiled_ms: the host could not enqueue the call "
                         "within the device spin")


def bound(bytes_moved: float, ops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    """Largest absolute difference; inf when either side is not finite."""
    d = float((a.float() - b.float()).abs().max())
    return d if math.isfinite(d) else math.inf


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_moe_gmm(torch, ref, kmoe, gen):
    def inputs(e, t, d, f, dt):
        """x at 0.3, weights at their fan-in^-0.5 (``init_moe``'s scale),
        drawn in `dt` on the card."""
        return [torch.randn(s, generator=gen, device="cuda", dtype=dt).mul_(c)
                for s, c in (((e, t, d), 0.3), ((e, d, f), d ** -0.5),
                             ((e, d, f), d ** -0.5), ((e, f, d), f ** -0.5))]

    def by_experts(fn, args, n=32):
        """`fn` over slices of at most `n` experts: the f32 truth at
        deepseek-v3's 256 experts would need 45 GB at once."""
        return torch.cat([fn(*(a[i:i + n] for a in args))
                          for i in range(0, args[0].shape[0], n)])

    results = {}
    prefill_t = math.ceil(128 * 8 * 1.5 / 64)
    # (name, E, T, D, F, dtype, timed): olmoe-1b-7b's decode (8 slots x
    # capacity 1) and 128-token prefill, edge shapes, granite-moe-3b-a800m's
    # decode and 128-token prefill (ceil(128 * 8 * 1.5 / 40) = 39),
    # deepseek-v3's (E=256 top-8: decode 8 x 1, prefill of 128 tokens
    # ceil(128 * 8 * 1.5 / 256) = 6) and jamba-v0.1-52b's (E=16 top-2:
    # decode 8 x 1, prefill ceil(128 * 2 * 1.5 / 16) = 24)
    cases = [("decode", 64, 8, 2048, 1024, "bfloat16", True),
             ("prefill", 64, prefill_t, 2048, 1024, "bfloat16", True),
             ("decode_f32", 64, 8, 2048, 1024, "float32", True),
             ("tc_one_token", 4, 1, 2048, 1024, "bfloat16", False),
             ("tc_t100", 4, 100, 2048, 1024, "bfloat16", False),
             ("tc_t257", 2, 257, 2048, 1024, "bfloat16", False),
             ("unaligned_f32", 8, 100, 2048, 1000, "float32", False),
             ("unaligned_bf16", 8, 13, 2048, 1000, "bfloat16", False),
             ("odd_f_bf16", 4, 24, 2048, 1004, "bfloat16", False),
             ("granite_decode", 40, 8, 1536, 512, "bfloat16", True),
             ("granite_decode_f32", 40, 8, 1536, 512, "float32", False),
             ("granite_prefill", 40, math.ceil(128 * 8 * 1.5 / 40), 1536, 512,
              "bfloat16", False),
             ("deepseek_decode", 256, 8, 7168, 2048, "bfloat16", True),
             ("deepseek_prefill", 256, math.ceil(128 * 8 * 1.5 / 256), 7168, 2048,
              "bfloat16", True),
             # one rank of the sharded olmoe-1b-7b (2x2 mesh): its 32 of 64
             # experts after the dispatch, T = ep * C: decode 2 x 1, prefill
             # 2 x ceil(4 * 32 * 8 * 1.5 / 64)
             ("sharded_decode", 32, 2, 2048, 1024, "bfloat16", True),
             ("sharded_prefill", 32, 2 * math.ceil(4 * 32 * 8 * 1.5 / 64), 2048, 1024,
              "bfloat16", True),
             ("jamba_decode", 16, 8, 4096, 14336, "bfloat16", True),
             ("jamba_prefill", 16, math.ceil(128 * 2 * 1.5 / 16), 4096, 14336,
              "bfloat16", True),
             # one rank of the sharded deepseek-v3 and jamba-v0.1-52b (2x2
             # mesh): half the experts after the dispatch, T = ep * C, decode
             # 2 x 1; prefill 2 x ceil(4 * 32 * k * 1.5 / E)
             ("deepseek_sharded_decode", 128, 2, 7168, 2048, "bfloat16", True),
             ("deepseek_sharded_prefill", 128, 2 * math.ceil(4 * 32 * 8 * 1.5 / 256), 7168,
              2048, "bfloat16", True),
             ("jamba_sharded_decode", 8, 2, 4096, 14336, "bfloat16", True),
             ("jamba_sharded_prefill", 8, 2 * math.ceil(4 * 32 * 2 * 1.5 / 16), 4096, 14336,
              "bfloat16", True)]
    for name, e, t, d, f, dt, timed in cases:
        args = inputs(e, t, d, f, getattr(torch, dt))
        which = kmoe.variant(args[0].dtype, d, f)
        v0 = kmoe.variant_launches[which]
        got = kmoe.moe_gmm_cuda(*args)
        torch.cuda.synchronize()
        if kmoe.variant_launches[which] != v0 + 1:
            raise AssertionError(f"moe_gmm {name}: variant {which} not counted")
        plain = by_experts(ref.moe_gmm_ref, args)
        truth = by_experts(lambda *a: ref.moe_gmm_ref(*(x.float() for x in a)), args)
        err, err_truth = max_err(got, plain), max_err(got, truth)
        if dt == "float32":
            ok = torch.allclose(got, plain, atol=1e-4, rtol=1e-4)
            rule = "f32 atol=rtol=1e-4, TF32 off"
        else:
            err_plain = max_err(plain, truth)
            ok = err_truth <= 1.5 * err_plain + 1e-3
            rule = f"bf16 err vs f32 truth <= 1.5 x plain's ({err_plain:.3g}) + 1e-3"
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"moe_gmm {name}: err {err_truth} fails {rule}")
        row = {"shape": [e, t, d, f], "dtype": dt, "variant": which,
               "max_abs_err": err, "err_vs_f32_truth": err_truth, "rule": rule}
        if which == "tensor_core":
            row["tile_plan"] = kmoe.tile_plan(t)
        if timed:
            el = 2 if dt == "bfloat16" else 4
            spin = []
            row["ms"] = time_ms(torch, lambda: kmoe.moe_gmm_cuda(*args), spin=spin)
            if name == "decode":
                row["profiled_ms"] = profiled_ms(
                    torch, lambda: kmoe.moe_gmm_cuda(*args), "moe_gmm", spin[0])
            row["plain_ms"] = time_ms(torch, lambda: ref.moe_gmm_ref(*args))
            row["bound_ms"], row["bound_by"] = bound(
                el * (2 * e * t * d + 3 * e * d * f), 6 * e * t * d * f, dt)
            row["library_ms"] = None
            row["hbm_tb_per_s"] = el * (2 * e * t * d + 3 * e * d * f) / row["ms"] / 1e9
        results[name] = row
        log("kernel.moe_gmm", case=name, **row)
        del args, got, plain, truth
        torch.cuda.empty_cache()
    results.update(check_moe_gmm_routed(torch, ref, kmoe, results, by_experts))
    return results


# the times of the earlier mma.sync kernel, which streamed every expert,
# at the shapes of the routed cases (PERF.md §6, on an H100 80GB HBM3 at
# 700 W), logged beside them; not measured by this script
EARLIER_MS = {"routed_olmoe_decode": 0.2891, "routed_olmoe_train": 3.680,
              "routed_granite_decode": 0.0818, "routed_deepseek_decode": 7.440,
              "routed_deepseek_sharded_decode": 3.710, "routed_jamba_decode": 1.940,
              "routed_jamba_sharded_decode": 0.980}
# (case, arch, rows, positions, capacity groups, expert-parallel ranks, the
# dense case of the same shape): decode is the engine's 8 slots, each its
# own capacity group; a sharded rank's buffer is both data ranks' 4 tokens
# (two groups) for its E / 2 experts; training one group of 8 x 512
ROUTED_CASES = (
    ("routed_olmoe_decode", "olmoe-1b-7b", 8, 1, 8, 1, "decode"),
    ("routed_olmoe_train", "olmoe-1b-7b", 8, 512, 1, 1, None),
    ("routed_granite_decode", "granite-moe-3b-a800m", 8, 1, 8, 1, "granite_decode"),
    ("routed_deepseek_decode", "deepseek-v3", 8, 1, 8, 1, "deepseek_decode"),
    ("routed_deepseek_sharded_decode", "deepseek-v3", 2, 4, 2, 2,
     "deepseek_sharded_decode"),
    ("routed_jamba_decode", "jamba-v0.1-52b", 8, 1, 8, 1, "jamba_decode"),
    ("routed_jamba_sharded_decode", "jamba-v0.1-52b", 2, 4, 2, 2, "jamba_sharded_decode"))


def check_moe_gmm_routed(torch, ref, kmoe, dense, by_experts):
    """``moe_gmm`` on buffers built by the real dispatch: ``moe_ffn`` (route,
    ``slot_assignment``, ``index_add_``) at published widths, with
    ``init_moe``'s router and weights at SEED and tokens at SEED + 1, its
    buffer taken where it calls ``ops.moe_gmm``. Each is held to the bf16
    rule, the skip counter to ``moe_gmm_active_tiles_ref``, the skipped
    tiles' rows of out to bitwise zero; the first call runs under
    ``set_sync_debug_mode("error")``. Each row logs the experts reached, the
    tiles and experts skipped, its time beside the dense case's and the
    earlier kernel's, and the bound of the work its data needs: the reached
    experts' weights and the buffer in and out, 6 D F flops per filled row."""
    from repro_torch.configs import get_arch
    from repro_torch.models.layers import moe as moe_mod
    from repro_torch.sharding.dist import NullDist
    from repro_torch.sharding.plans import null_plan
    results, params = {}, {}
    for i, (name, arch, rows, pos, groups, ep, dense_case) in enumerate(ROUTED_CASES):
        cfg = get_arch(arch)
        if arch not in params:
            params.clear()
            torch.cuda.empty_cache()
            g0 = torch.Generator(device="cuda")
            g0.manual_seed(SEED)
            params[arch] = moe_mod.init_moe(cfg, null_plan("decode"), g0)
        p = params[arch]
        gx = torch.Generator(device="cuda")
        gx.manual_seed(SEED + 1)
        x = torch.randn((rows, pos, cfg.d_model), generator=gx, device="cuda",
                        dtype=getattr(torch, cfg.dtype))
        seen, gmm = [], moe_mod.kops.moe_gmm
        moe_mod.kops.moe_gmm = lambda x_e, *w: seen.append(x_e) or torch.zeros_like(x_e)
        try:
            moe_mod.moe_ffn(p, x, cfg, null_plan("decode"), NullDist(),
                            capacity_groups=groups)
        finally:
            moe_mod.kops.moe_gmm = gmm
        e_loc = seen[0].shape[0] // ep                # rank 0's experts after the a2a
        args = [seen[0][:e_loc].contiguous()] + [p[k][:e_loc] for k in
                                                 ("w_gate", "w_up", "w_down")]
        del seen, x
        e, t, d = args[0].shape
        f = args[1].shape[-1]
        lp = kmoe.tile_plan(t)
        live = ref.moe_gmm_active_tiles_ref(args[0], lp[2])
        want_skip = [int((~live).sum()), int((~live.any(1)).sum())]
        counter = kmoe.skipped_counter("cuda")
        before = counter.clone()
        if i == 0:
            torch.cuda.set_sync_debug_mode("error")   # the call must not wait
        try:
            got = kmoe.moe_gmm_cuda(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        skipped = (counter - before).tolist()
        if skipped != want_skip:
            raise AssertionError(f"moe_gmm {name}: skipped {skipped}, want {want_skip}")
        dead = torch.repeat_interleave(~live, lp[2], dim=1)[:, :t]
        if (got[dead].view(torch.int16) != 0).any():
            raise AssertionError(f"moe_gmm {name}: a skipped row is not bitwise zero")
        plain = by_experts(ref.moe_gmm_ref, args)
        truth = by_experts(lambda *a: ref.moe_gmm_ref(*(x.float() for x in a)), args)
        err, err_truth, err_plain = max_err(got, plain), max_err(got, truth), \
            max_err(plain, truth)
        rule = f"bf16 err vs f32 truth <= 1.5 x plain's ({err_plain:.3g}) + 1e-3"
        if err_truth > 1.5 * err_plain + 1e-3 or not torch.isfinite(got).all():
            raise AssertionError(f"moe_gmm {name}: err {err_truth} fails {rule}")
        reached = int(live.any(1).sum())
        filled = int((args[0] != 0).any(-1).sum())
        row = {"arch": arch, "shape": [e, t, d, f], "dtype": cfg.dtype,
               "variant": kmoe.variant(args[0].dtype, d, f), "tile_plan": lp,
               "experts_reached": reached, "of_experts": e, "rows_filled": filled,
               "tiles_skipped": skipped[0], "experts_skipped": skipped[1],
               "max_abs_err": err, "err_vs_f32_truth": err_truth, "rule": rule}
        row["ms"] = time_ms(torch, lambda: kmoe.moe_gmm_cuda(*args))
        row["plain_ms"] = time_ms(torch, lambda: ref.moe_gmm_ref(*args))
        row["bound_ms"], row["bound_by"] = bound(
            2 * (2 * e * t * d + 3 * reached * d * f), 6 * filled * d * f, "bfloat16")
        row["bound_all_experts_ms"] = bound(2 * (2 * e * t * d + 3 * e * d * f),
                                            6 * e * t * d * f, "bfloat16")[0]
        row["library_ms"] = None
        row["dense_ms"] = dense[dense_case]["ms"] if dense_case else None
        row["earlier_ms"] = EARLIER_MS[name]
        results[name] = row
        log("kernel.moe_gmm", case=name, **row)
        del args, got, plain, truth
        torch.cuda.empty_cache()
    return results


def check_flash_decode(torch, F, ref, kfd, gen):
    B = 8
    results = {}
    edges = [0, 1, 63, 64, 65, 128, 200, 500]        # chunk boundaries, 0, S
    decode = [17, 49, 64, 65, 100, 128, 150, 160]
    ring = [1, 64, 500, 1000, 1024, 1024, 1024, 1024]    # min(pos + 1, W)
    # (name, H, KH, hd, S, lengths, dtype, timed): olmoe-1b-7b's decode and
    # edge cases; starcoder2-3b (g = 12), granite-moe-3b-a800m (g = 3,
    # hd 64) and gemma3-1b (g = 4, hd 256, KH 1) over its window-1024 ring
    # and over a full cache; jamba-v0.1-52b's attention layer (g = 4, KH 8),
    # which minitron-8b's layers share
    cases = [("decode", 16, 16, 128, 512, decode, "bfloat16", True),
             ("ragged_S", 16, 16, 128, 500, [1, 37, 63, 64, 65, 200, 333, 500],
              "bfloat16", False),
             ("ragged_S_f32", 16, 16, 128, 500, [1, 37, 63, 64, 65, 200, 333, 500],
              "float32", False),
             ("gqa4_edges", 16, 4, 128, 500, edges, "bfloat16", False),
             ("gqa4_edges_f32", 16, 4, 128, 500, edges, "float32", False),
             ("starcoder2_g12", 24, 2, 128, 512, decode, "bfloat16", True),
             ("starcoder2_g12_f32", 24, 2, 128, 500, edges, "float32", False),
             ("granite_g3_hd64", 24, 8, 64, 512, decode, "bfloat16", True),
             ("granite_g3_hd64_f32", 24, 8, 64, 500, edges, "float32", False),
             ("gemma3_ring", 4, 1, 256, 1024, ring, "bfloat16", True),
             ("gemma3_ring_f32", 4, 1, 256, 1024, ring, "float32", False),
             ("gemma3_global", 4, 1, 256, 1152, [17, 49, 64, 65, 100, 128, 1040, 1152],
              "bfloat16", False),
             ("jamba_g4", 32, 8, 128, 512, decode, "bfloat16", True),
             ("jamba_g4_f32", 32, 8, 128, 500, edges, "float32", False),
             # deepseek-67b and internvl2-76b (g = 8, H 64), seamless-m4t-medium
             # (g = 1, hd 64) and its cross-attention, every row over all
             # max_seq positions of the padded encoder cache
             ("deepseek67b_g8", 64, 8, 128, 512, decode, "bfloat16", True),
             ("deepseek67b_g8_f32", 64, 8, 128, 500, edges, "float32", False),
             ("seamless_g1_hd64", 16, 16, 64, 512, decode, "bfloat16", True),
             ("seamless_g1_hd64_f32", 16, 16, 64, 500, edges, "float32", False),
             ("seamless_cross", 16, 16, 64, 512, [512] * 8, "bfloat16", True),
             ("seamless_cross_f32", 16, 16, 64, 512, [512] * 8, "float32", False)]
    for name, H, KH, hd, S, lens, dt, timed in cases:
        tdt = getattr(torch, dt)
        q = torch.randn((B, H, hd), generator=gen, device="cuda").to(tdt)
        k = torch.randn((B, KH, S, hd), generator=gen, device="cuda").to(tdt)
        v = torch.randn((B, KH, S, hd), generator=gen, device="cuda").to(tdt)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        live = lengths > 0                            # length 0 gives zeros
        row = {"B": B, "H": H, "KH": KH, "S": S, "hd": hd, "lengths": lens,
               "dtype": dt}
        got = kfd.flash_decode_cuda(q, k, v, lengths)
        torch.cuda.synchronize()
        want = ref.flash_decode_ref(q, k, v, lengths)
        truth = ref.flash_decode_ref(q.float(), k.float(), v.float(), lengths)
        err = max_err(got[live], want[live])
        if dt == "float32":
            ok = torch.allclose(got[live], want[live], atol=1e-4, rtol=1e-4)
            rule = "f32 atol=rtol=1e-4"
        else:
            err_plain = max_err(want[live], truth[live])
            ok = max_err(got[live], truth[live]) <= 1.5 * err_plain + 1e-3
            rule = f"bf16 err vs f32 truth <= 1.5 x plain's ({err_plain:.3g}) + 1e-3"
        ok = ok and bool((got[~live] == 0).all())
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"flash_decode {name}: err {err} fails {rule} "
                                 f"(or a length-0 slot is not 0)")
        row["max_abs_err"], row["rule"] = err, rule
        if timed:
            mask = (torch.arange(S, device="cuda")[None, :] < lengths[:, None])
            mask = mask[:, None, None, :]

            def library():
                return F.scaled_dot_product_attention(
                    q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)[:, :, 0]
            lib_err = max_err(library(), truth)
            if lib_err > 2e-2:
                raise AssertionError(f"library yardstick disagrees: {lib_err}")
            spin = []
            row["ms"] = time_ms(
                torch, lambda: kfd.flash_decode_cuda(q, k, v, lengths), spin=spin)
            if name == "decode":
                row["profiled_ms"] = profiled_ms(
                    torch, lambda: kfd.flash_decode_cuda(q, k, v, lengths),
                    "flash_decode", spin[0])
            row["plain_ms"] = time_ms(torch, lambda: ref.flash_decode_ref(q, k, v, lengths))
            row["library_ms"] = time_ms(torch, library)
            n = sum(lens)
            row["bound_ms"], row["bound_by"] = bound(
                2 * (2 * B * H * hd + 2 * n * KH * hd) + 4 * B, 4 * n * H * hd, dt)
        results[name] = row
        log("kernel.flash_decode", case=name, **row)
    return results


def lse_library(torch, q, k, v, lengths, to, tm, tl):
    """The library call that computes the (o, m, l) form's function: the
    memory-efficient attention with its log-sum-exp, under an additive
    mask of each row's length. It returns (o / l, log l + m), which merges
    across shards as (o, m, l) does with m = lse and l = 1. Checked once
    against the f32 truth (to, tm, tl); returns the call to time."""
    B, H, hd = q.shape
    KH, S = k.shape[1], k.shape[2]
    g = H // KH
    keep = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    bias = torch.zeros((B, S), dtype=q.dtype, device=q.device).masked_fill(
        ~keep, -torch.inf)[:, None, None, :].expand(B, KH, g, S).contiguous()

    def call():
        # a KV head's g query heads as g query rows (the call has no GQA)
        out, lse = torch.ops.aten._scaled_dot_product_efficient_attention(
            q.reshape(B, KH, g, hd), k, v, bias, True)[:2]
        return out.reshape(B, H, hd), lse[..., :g].reshape(B, H)
    o_lib, lse_lib = call()
    err_o = max_err(o_lib, to / tl[..., None])
    err_lse = max_err(lse_lib, tm + torch.log(tl))
    if err_o > 2e-2 or err_lse > 1e-2:
        raise AssertionError(f"library yardstick disagrees: o {err_o}, lse {err_lse}")
    return call


def check_flash_decode_lse(torch, ref, kfd, gen):
    """The (o, m, l) form against ``ref.flash_decode_lse_ref`` (the port's
    ``attn_chunk_lse``) at the sharded decode's shape: one rank's batch
    (B_loc 4) and KV shard (S_loc 256 of 512) of olmoe-1b-7b (H = KH = 16,
    hd 128). Model rank 0's shard holds every position the decode reaches
    (lengths 65-95); model rank 1's holds none (lengths 0: o = 0, l = 0,
    m = -1e30, the reference's values). Also the split edges at B 8, f32,
    jamba-v0.1-52b's shard (H 32 over KH 8), and seamless-m4t-medium's
    self- and cross-attention shards (hd 64; the cross cache every row
    valid), and a DBO microbatch's shard of olmoe (B_loc 2). f32: o, m, l
    within 1e-4;
    bf16: the normalised output against the f32 truth, 1.5x the plain
    version's error + 1e-3, and m within 1e-4."""
    results = {}
    # (name, B, H, KH, lengths, dtype, timed); jamba-v0.1-52b's attention
    # layer on its shard: B_loc 4, all 32 query heads (gathered over tp)
    # over its 8 KV heads, 16 new tokens after a prompt of 64
    # seamless-m4t-medium's two shapes on its shard (B_loc 4, H = KH = 16,
    # hd 64, S_loc 256): self-attention over the decode's positions on
    # model rank 0 (16 new tokens after a prompt of 64), cross-attention
    # over every row of the zero-padded encoder cache (enc_len = max_seq)
    cases = [("sharded_decode", 4, 16, 16, 128, [65, 72, 88, 95], "bfloat16", True),
             ("sharded_empty", 4, 16, 16, 128, [0, 0, 0, 0], "bfloat16", True),
             ("sharded_decode_f32", 4, 16, 16, 128, [65, 72, 88, 95], "float32", False),
             ("edges", 8, 16, 16, 128, [0, 1, 63, 64, 65, 128, 255, 256], "bfloat16", False),
             ("edges_f32", 8, 16, 16, 128, [0, 1, 63, 64, 65, 128, 255, 256], "float32",
              False),
             ("jamba_sharded_g4", 4, 32, 8, 128, [65, 70, 75, 79], "bfloat16", True),
             ("jamba_sharded_g4_f32", 4, 32, 8, 128, [65, 70, 75, 79], "float32", False),
             ("seamless_self", 4, 16, 16, 64, [65, 70, 75, 79], "bfloat16", True),
             ("seamless_self_f32", 4, 16, 16, 64, [65, 70, 75, 79], "float32", False),
             ("seamless_cross", 4, 16, 16, 64, [256] * 4, "bfloat16", True),
             ("seamless_cross_f32", 4, 16, 16, 64, [256] * 4, "float32", False),
             # a DBO microbatch of the sharded olmoe: B_loc / 2 rows, at the
             # positions of the sub-run after the bf16 job's 31 decode steps
             ("sharded_dbo_microbatch", 2, 16, 16, 128, [96, 101], "bfloat16", True),
             ("sharded_dbo_microbatch_f32", 2, 16, 16, 128, [96, 101], "float32", False)]
    S = 256
    for name, B, H, KH, hd, lens, dt, timed in cases:
        tdt = getattr(torch, dt)
        q = torch.randn((B, H, hd), generator=gen, device="cuda").to(tdt)
        k = torch.randn((B, KH, S, hd), generator=gen, device="cuda").to(tdt)
        v = torch.randn((B, KH, S, hd), generator=gen, device="cuda").to(tdt)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        live = lengths > 0
        n0 = kfd.lse_launches
        o, m, l = kfd.flash_decode_lse_cuda(q, k, v, lengths)
        torch.cuda.synchronize()
        if kfd.lse_launches != n0 + 1:
            raise AssertionError(f"flash_decode_lse {name}: launch not counted")
        po, pm, pl = ref.flash_decode_lse_ref(q, k, v, lengths)
        to, tm, tl = ref.flash_decode_lse_ref(q.float(), k.float(), v.float(), lengths)
        empty_ok = bool((o[~live] == 0).all() and (l[~live] == 0).all()
                        and (m[~live] == -1e30).all())
        err = max(max_err(o, po), max_err(m, pm), max_err(l, pl))
        m_ok = torch.allclose(m, pm, atol=1e-4, rtol=1e-4)
        if dt == "float32":
            ok = m_ok and all(torch.allclose(a, b, atol=1e-4, rtol=1e-4)
                              for a, b in ((o, po), (l, pl)))
            rule = "f32 o, m, l atol=rtol=1e-4"
        elif live.any():
            def norm(o_, l_):
                return o_[live] / l_[live][..., None]
            truth = norm(to, tl)
            err_plain = max_err(norm(po, pl), truth)
            ok = m_ok and max_err(norm(o, l), truth) <= 1.5 * err_plain + 1e-3
            rule = (f"bf16 o/l vs f32 truth <= 1.5 x plain's ({err_plain:.3g}) + 1e-3, "
                    "m atol=rtol=1e-4")
        else:
            ok, rule = m_ok, "empty shard: o = 0, l = 0, m = -1e30"
        if not (ok and empty_ok) or not all(torch.isfinite(t).all() for t in (o, m, l)):
            raise AssertionError(f"flash_decode_lse {name}: err {err} fails {rule} "
                                 f"(empty rows exact: {empty_ok})")
        row = {"B": B, "H": H, "KH": KH, "S": S, "hd": hd, "lengths": lens, "dtype": dt,
               "max_abs_err": err, "rule": rule}
        if timed:
            row["ms"] = time_ms(torch, lambda: kfd.flash_decode_lse_cuda(q, k, v, lengths))
            row["plain_ms"] = time_ms(torch, lambda: ref.flash_decode_lse_ref(q, k, v, lengths))
            if live.all():
                row["library_ms"] = time_ms(torch, lse_library(torch, q, k, v, lengths, to,
                                                               tm, tl))
            else:
                # the library call gives NaN for a row with nothing to attend to
                row["library_ms"] = None
            n = sum(lens)
            row["bound_ms"], row["bound_by"] = bound(
                2 * (B * H * hd + 2 * n * KH * hd) + 4 * B + 4 * (B * H * hd + 2 * B * H),
                4 * n * H * hd, dt)
        results[name] = row
        log("kernel.flash_decode_lse", case=name, **row)
    return results


# ---------------------------------------------------------------------------
# phase 4: float32 parity, card vs CPU, full width, 2 layers
# ---------------------------------------------------------------------------

def parity_f32(torch, get_arch, M, kvcache, convert, arch="olmoe-1b-7b",
               layers=2, lens=(16, 40, 27), seq=64, steps=4, experts=None):
    """The card's path against the port's CPU path on the same float32
    weights: `arch` at its published widths cut to `layers` layers (an
    encoder-decoder to `layers` encoder layers too, each prompt encoding
    random frames, one per token, and decode reading the whole padded
    encoder cache, as the engine does) and to `experts` routed experts,
    top-k kept, where given; prompts of `lens` tokens in a cache of `seq`
    positions, `steps` decode steps."""
    import dataclasses

    import numpy as np
    tol = 1e-3
    full = get_arch(arch)
    cfg = full.replace(num_layers=layers, dtype="float32")
    if cfg.is_encoder_decoder:
        cfg = cfg.replace(encoder_layers=layers)
    enc_len = seq if cfg.is_encoder_decoder else 0
    if experts:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=experts))
    t0 = time.perf_counter()
    p_cpu = M.init_model(cfg, device="cpu", seed=SEED)
    p_gpu = convert.tree_map(lambda t: t.to("cuda"), p_cpu)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    frames = [torch.from_numpy(rng.standard_normal((1, n, cfg.d_model), np.float32))
              for n in lens]

    def run(params, device, feed=None):
        caches = M.init_cache(cfg, batch=len(prompts), seq=seq, enc_seq=enc_len,
                              device=device)
        logits = []
        for slot, p in enumerate(prompts):
            batch = {"tokens": torch.tensor([p], device=device)}
            if cfg.is_encoder_decoder:
                batch["frames"] = frames[slot].to(device)
            lg, sub = M.prefill_logits(params, batch, cfg)
            kvcache.insert_slot(caches, kvcache.pad_to_capacity(cfg, sub, len(p), seq), slot)
            logits.append(lg[:, 0, :cfg.vocab_size])
        pos = torch.tensor([len(p) for p in prompts], device=device)
        tok = torch.cat(logits).argmax(-1, keepdim=True) if feed is None else feed[0].to(device)
        toks, step_logits = [tok.cpu()], [torch.cat(logits).cpu()]
        for i in range(steps):
            lg, caches = M.decode_logits(params, caches, tok.to(torch.int32), pos, cfg,
                                         enc_len=enc_len)
            step_logits.append(lg[:, 0, :cfg.vocab_size].cpu())
            tok = lg[:, 0, :cfg.vocab_size].argmax(-1, keepdim=True) if feed is None else feed[i + 1].to(device)
            toks.append(tok.cpu())
            pos = pos + 1
        return step_logits, toks

    t0 = time.perf_counter()
    cpu_logits, cpu_toks = run(p_cpu, "cpu")
    gpu_logits, _ = run(p_gpu, "cuda", feed=cpu_toks)
    worst, n_checked = 0.0, 0
    for lc, lg in zip(cpu_logits, gpu_logits):
        worst = max(worst, max_err(lc, lg))
        top2 = lc.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
        n_checked += int(sure.sum())
        if not torch.equal(lc.argmax(-1)[sure], lg.argmax(-1)[sure]):
            raise AssertionError("f32 parity: greedy tokens differ where the "
                                 "top-2 margin exceeds the tolerance")
    if worst > tol:
        raise AssertionError(f"f32 parity: logits differ by {worst} > {tol}")
    log("parity_f32" if arch == "olmoe-1b-7b" else f"parity_f32.{arch}",
        arch=arch, **cut_of(cfg, full), width=cfg.d_model,
        prompt_lens=list(lens), seq=seq, decode_steps=steps, max_abs_logit_err=worst,
        tol=tol, tokens_checked=n_checked, init_s=init_s,
        seconds=time.perf_counter() - t0)
    del p_cpu, p_gpu
    torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def kernel_layers(cfg):
    """Launches per decode step the config's layers make: ``flash_decode``
    once per GQA attention layer (MLA, Mamba and RWKV layers run none) and
    once more per decoder layer with cross-attention, ``moe_gmm`` once per
    MoE layer."""
    gqa = sum(s.mixer in ("attn", "attn_local") and cfg.attn_kind == "gqa"
              for s in cfg.layer_specs)
    cross = cfg.num_layers if cfg.is_encoder_decoder else 0
    return {"moe_gmm": sum(s.ffn == "moe" for s in cfg.layer_specs),
            "flash_decode": gqa + cross}


def cut_of(cfg, full):
    """The depth and expert cuts of `cfg` against the published `full`."""
    cut = {"layers": cfg.num_layers, "of_layers": full.num_layers,
           "experts": cfg.moe.num_experts if cfg.moe else None,
           "of_experts": full.moe.num_experts if full.moe else None}
    if full.is_encoder_decoder:
        cut.update(encoder_layers=cfg.encoder_layers, of_encoder_layers=full.encoder_layers)
    return cut


def n_params(params) -> int:
    """Every weight of `params` (a tree of dicts and lists of tensors)."""
    if isinstance(params, dict):
        return sum(n_params(v) for v in params.values())
    if isinstance(params, list):
        return sum(n_params(v) for v in params)
    return params.numel()



def all_finite(torch, caches) -> bool:
    return all(bool(torch.isfinite(t).all()) for layer in caches
               for leaves in layer.values() for t in leaves.values())


def reset_counts(kmoe, kfd):
    kmoe.reset_counts()
    kfd.launches = 0


def read_counts(kmoe, kfd):
    return {"moe_gmm": kmoe.launches, "flash_decode": kfd.launches}


def main_path(torch, get_arch, M, Engine, kmoe, kfd, arch="olmoe-1b-7b",
              lens=None, new_tokens=32, max_seq=512, n_requests=16, layers=None):
    """`arch` at its published widths, bf16, random weights from SEED, its
    depth cut to `layers` where given, served by ``Engine(max_batch=8,
    max_seq)``: `n_requests` requests of 16-128 prompt tokens (or `lens`)
    and `new_tokens` new tokens each. The launch counters are set to 0 just
    before the run and read just after: `flash_decode` once per GQA layer
    and wave; `moe_gmm` once per MoE layer and wave and per prefill, in its
    tensor-core variant only."""
    import numpy as np

    class TimedEngine(Engine):
        """The port's Engine with the host clock around admission (prefill)
        and around each decode wave, synchronised with the card."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.admit_s, self.wave_s, self.prefills = [], [], 0

        def _prefill_one(self, prompt):
            self.prefills += 1
            return super()._prefill_one(prompt)

        def step(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._admit()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            n = super().step()            # queue already admitted
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            self.admit_s.append(t1 - t0)
            if n:
                self.wave_s.append(t2 - t1)
            return n

    full = get_arch(arch)
    cfg = full.replace(num_layers=layers) if layers else full
    t0 = time.perf_counter()
    params = M.init_model(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    if lens is None:
        lens = rng.integers(16, 129, n_requests).tolist()
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]

    eng = TimedEngine(cfg, params, max_batch=8, max_seq=max_seq, eos_id=-1)
    for p in prompts:
        eng.submit(p, max_new_tokens=new_tokens)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kmoe, kfd)
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counts(kmoe, kfd)
    variants = dict(kmoe.variant_launches)
    skipped = kmoe.skipped_counter("cuda").tolist()   # set to 0 with the counts

    waves = len(eng.wave_s)
    per_step = kernel_layers(cfg)
    L_moe, L_fd = per_step["moe_gmm"], per_step["flash_decode"]
    if sorted(out) != list(range(len(prompts))):
        raise AssertionError(f"{arch}: requests not completed: {sorted(out)}")
    for rid, toks in out.items():
        want = min(new_tokens, max_seq - 1 - lens[rid]) + 1
        if len(toks) != want or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{arch} request {rid}: bad output {toks}")
    if launches["flash_decode"] != L_fd * waves:
        raise AssertionError(f"{arch}: flash_decode launched "
                             f"{launches['flash_decode']} times, want {L_fd} per "
                             f"wave x {waves} waves")
    if launches["moe_gmm"] != L_moe * (waves + eng.prefills) or \
            variants != {"tensor_core": launches["moe_gmm"], "cuda_core": 0}:
        raise AssertionError(f"{arch}: moe_gmm launched {variants}, want the "
                             f"tensor-core variant {L_moe} times per wave and "
                             f"per prefill, only")
    if not all_finite(torch, eng.caches):
        raise AssertionError(f"{arch}: non-finite cache")
    batch = {"tokens": torch.tensor([prompts[0]], device="cuda")}
    if cfg.is_encoder_decoder:                        # zero frames, as the engine
        batch["frames"] = torch.zeros((1, lens[0], cfg.d_model), device="cuda",
                                      dtype=getattr(torch, cfg.dtype))
    lg, _ = M.prefill_logits(params, batch, cfg)
    if not torch.isfinite(lg[..., :cfg.vocab_size]).all():
        raise AssertionError(f"{arch}: non-finite logits")
    n_gen = sum(len(t) for t in out.values())
    res = {
        "arch": arch, **cut_of(cfg, full), "params": n_params(params), "init_s": init_s,
        "requests": len(prompts), "prompt_lens": lens, "new_tokens": new_tokens,
        # the highest position a decode step wrote into the caches
        "max_seq": max_seq, "max_decode_pos": max(n + len(out[i]) - 2
                                                  for i, n in enumerate(lens)),
        "waves": waves, "prefills": eng.prefills, "launches": launches,
        "moe_gmm_variant_launches": variants,
        "moe_gmm_skipped": {"tiles": skipped[0], "experts": skipped[1],
                            "experts_per_call": skipped[1] / max(launches["moe_gmm"], 1)},
        "launches_per_wave": {"moe_gmm": (launches["moe_gmm"] - L_moe * eng.prefills) / waves,
                              "flash_decode": launches["flash_decode"] / waves},
        "prefill_ms_per_request": 1e3 * sum(eng.admit_s) / eng.prefills,
        "decode_ms_per_wave": 1e3 * sum(eng.wave_s) / waves,
        "decode_ms_per_wave_median": 1e3 * sorted(eng.wave_s)[len(eng.wave_s) // 2],
        "run_s": run_s, "tokens_per_s": n_gen / run_s,
        "decode_tokens_per_s": (n_gen - len(prompts)) / sum(eng.wave_s),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    log("main_path" if arch == "olmoe-1b-7b" else f"main_path.{arch}", **res)
    return res, eng, prompts


def profile_waves(torch, eng, prompts, wave_ms: float, n_waves: int = 4,
                  tag: str = "profile"):
    """Device time by kernel over a few full decode waves, the share of an
    unprofiled wave (`wave_ms`) in which the device is idle, and each
    wrapper's ``call_times`` there. On this host-bound path a call's span
    also holds the time the device waits for the host to launch the call's
    second kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for p in prompts[:eng.max_batch]:
        eng.submit(p, max_new_tokens=n_waves + 2)
    eng.step()                                        # admits all, one wave
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_waves):
            eng.step()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:        # kernels only, no aten op
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        rows.append((dev_us / n_waves / 1e3, evt.count // n_waves, evt.key[:90]))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    per_call = {name: dict(zip(("span_ms", "kernels_busy_ms", "calls"),
                               call_times(prof, *spec)))
                for name, spec in KERNEL_NAMES.items()}
    res = {"wave_ms_unprofiled": wave_ms, "device_busy_ms_per_wave": busy,
           "idle_share": 1 - busy / wave_ms if busy else None,
           "kernels_per_wave": sum(r[1] for r in rows), "per_call": per_call,
           "top": [{"ms": r[0], "calls": r[1], "kernel": r[2]} for r in rows[:16]]}
    log(tag, **res)
    eng.run()
    return res


# ---------------------------------------------------------------------------
# DBO and speculative decoding
# ---------------------------------------------------------------------------

def device_busy_ms(torch, fn, n: int) -> float:
    """Device time (ms) of the kernels `fn` launches, per call: the sum of
    the profiler's CUDA kernel times over `n` calls, divided by `n`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            dev_us = getattr(evt, "self_device_time_total", None)
            us += evt.self_cuda_time_total if dev_us is None else dev_us
    return us / n / 1e3


def clone(convert, caches):
    return convert.tree_map(lambda t: t.clone(), caches)


def dbo_phase(torch, M, kvcache, convert, dbo, kmoe, kfd, cfg, params,
              prompt_len=64, steps=8, seq=128, tag="dbo"):
    """`cfg` on `params`: two microbatches of 4 at one prompt length. The DBO
    step, on its own copy of the caches, must give bitwise the tokens and
    caches of two plain decode steps, for `steps` steps; then the device
    time of a DBO step beside that of two plain steps."""
    import numpy as np
    from repro_torch.sharding.dist import NullDist
    from repro_torch.sharding.plans import null_plan
    plan, dist = null_plan("decode"), NullDist()
    rng = np.random.default_rng(SEED + 1)
    toks, caches = [], []
    for _ in range(2):
        prompts = torch.tensor(rng.integers(1, cfg.vocab_size, (4, prompt_len)),
                               dtype=torch.int32, device="cuda")
        tok, c = M.prefill(params, {"tokens": prompts}, cfg)
        toks.append(tok)
        caches.append(kvcache.pad_to_capacity(cfg, c, prompt_len, seq))
    plain = [clone(convert, c) for c in caches]
    mine = [clone(convert, c) for c in caches]
    ta, tb, da, db = toks[0], toks[1], toks[0], toks[1]
    plain_s, dbo_s = [], []
    reset_counts(kmoe, kfd)
    for i in range(steps):
        pos = prompt_len + i
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ta, plain[0] = M.decode_step(params, plain[0], ta, pos, cfg)
        tb, plain[1] = M.decode_step(params, plain[1], tb, pos, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if i == 0:
            launches_plain = read_counts(kmoe, kfd)
            reset_counts(kmoe, kfd)
        da, db, mine[0], mine[1] = dbo.dbo_decode_step(
            params, mine[0], mine[1], da, db, pos, cfg, plan, dist)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i == 0:
            launches = read_counts(kmoe, kfd)
        plain_s.append(t1 - t0)
        dbo_s.append(t2 - t1)
        if not (torch.equal(da, ta) and torch.equal(db, tb)):
            raise AssertionError(f"{tag}: tokens differ from two plain steps at step {i}")
    for got, want in zip(mine, plain):
        for lg, lw in zip(got, want):
            for n, t in lg["mixer"].items():
                if not torch.equal(t, lw["mixer"][n]):
                    raise AssertionError(f"{tag}: caches differ from two plain steps")
    want = {k: 2 * n for k, n in kernel_layers(cfg).items()}
    if launches != launches_plain or launches != want:
        raise AssertionError(f"{tag}: launches {launches}, plain {launches_plain}, "
                             f"want {want} per step")
    pos = prompt_len + steps
    busy_dbo = device_busy_ms(torch, lambda: dbo.dbo_decode_step(
        params, mine[0], mine[1], da, db, pos, cfg, plan, dist), 4)
    busy_plain = device_busy_ms(torch, lambda: (
        M.decode_step(params, plain[0], ta, pos, cfg),
        M.decode_step(params, plain[1], tb, pos, cfg)), 4)
    res = {"arch": cfg.name, "layers": cfg.num_layers, "microbatches": [4, 4],
           "prompt_len": prompt_len, "seq": seq,
           "steps": steps, "bitwise_equal": True, "launches_first_step": launches,
           "dbo_step_device_ms": busy_dbo, "two_plain_steps_device_ms": busy_plain,
           "dbo_step_wall_ms_median": 1e3 * sorted(dbo_s)[steps // 2],
           "two_plain_steps_wall_ms_median": 1e3 * sorted(plain_s)[steps // 2]}
    log(tag, **res)
    return res


def specdec_phase(torch, M, kvcache, convert, specdec, kmoe, kfd, cfg, params,
                  batch, prompt_len, seq, n_tokens=17, spec_m=4):
    """SD on the card at `batch` rows of `prompt_len` tokens: untrained heads
    and an oracle draft (the greedy continuation), each equal to greedy
    token for token, beside greedy's time per token. Each run starts from
    its own copy of the prefilled caches."""
    import numpy as np
    rng = np.random.default_rng(SEED + 2)
    prompts = torch.tensor(rng.integers(1, cfg.vocab_size, (batch, prompt_len)),
                           dtype=torch.int32, device="cuda")
    tok0, c = M.prefill(params, {"tokens": prompts}, cfg)
    c = kvcache.pad_to_capacity(cfg, c, prompt_len, seq)

    caches, tok, ref = clone(convert, c), tok0, [tok0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_tokens - 1 + spec_m):
        if i == n_tokens - 1:
            torch.cuda.synchronize()
            greedy_s = time.perf_counter() - t0
        tok, caches = M.decode_step(params, caches, tok, prompt_len + i, cfg)
        ref.append(tok)
    ref = torch.cat(ref, dim=1)                          # [B, n_tokens + spec_m]
    del caches

    def oracle(params_, caches_, cur_tok, pos):
        i = pos - prompt_len                             # cur_tok is ref[:, i]
        return ref[:, i + 1:i + spec_m].contiguous()

    res = {"arch": cfg.name, "layers": cfg.num_layers, "batch": batch,
           "prompt_len": prompt_len, "seq": seq, "spec_m": spec_m, "n_tokens": n_tokens,
           "greedy_ms_per_token": 1e3 * greedy_s / (n_tokens - 1)}
    for name, draft_fn in (("heads", None), ("oracle", oracle)):
        dec = specdec.SDDecoder(cfg, params, spec_m=spec_m, draft_fn=draft_fn,
                                seed=SEED)
        caches = clone(convert, c)
        reset_counts(kmoe, kfd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, _, stats = dec.generate(caches, tok0, prompt_len, n_tokens - 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(kmoe, kfd)
        got = torch.cat([tok0, toks], dim=1)
        if not torch.equal(got, ref[:, :n_tokens]):
            raise AssertionError(f"specdec {cfg.name} {name}: differs from greedy")
        steps = stats["iterations"] * spec_m
        want = {k: n * steps for k, n in kernel_layers(cfg).items()}
        if launches != want:
            raise AssertionError(f"specdec {cfg.name} {name}: launches {launches}, "
                                 f"want {want}")
        if name == "oracle" and stats["mean_accepted"] != spec_m:
            raise AssertionError(f"specdec {cfg.name}: the oracle accepted "
                                 f"{stats['mean_accepted']}, want {spec_m}")
        res[name] = {"equals_greedy": True, "launches": launches, **stats,
                     "ms_per_emitted_token": 1e3 * wall / (n_tokens - 1),
                     "ms_per_iteration": 1e3 * wall / stats["iterations"]}
        del caches, dec
    log(f"specdec.{cfg.name}", **res)
    return res


def prefill_patches(torch, get_arch, M, kvcache, kmoe, kfd, arch="internvl2-76b",
                    layers=16, batch=2, text=64, steps=16):
    """The ViT-patch frontend at published widths, `layers` layers: `batch`
    rows of ``n_frontend_tokens`` patch embeddings (random, at the token
    embeddings' scale) and `text` text tokens through ``prefill``, then
    `steps` decode steps on its caches. The prefill launches no kernel;
    each decode step launches ``flash_decode`` once per layer. The patches
    must change the prefill's logits, which must be finite."""
    import numpy as np
    full = get_arch(arch)
    cfg = full.replace(num_layers=layers)
    t0 = time.perf_counter()
    params = M.init_model(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    pf = cfg.n_frontend_tokens
    S = pf + text
    tokens = torch.tensor(np.random.default_rng(SEED).integers(1, cfg.vocab_size, (batch, S)),
                          dtype=torch.int32, device="cuda")
    patches = torch.randn((batch, pf, cfg.d_model), generator=gen, device="cuda",
                          dtype=torch.bfloat16).mul_(0.02)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kmoe, kfd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = M.prefill_logits(params, {"tokens": tokens, "patches": patches}, cfg)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = read_counts(kmoe, kfd)
    lg = logits[..., :cfg.vocab_size]
    tokens_only, _ = M.prefill_logits(params, {"tokens": tokens}, cfg)
    moved = max_err(lg, tokens_only[..., :cfg.vocab_size])
    if not torch.isfinite(lg).all() or not moved > 0:
        raise AssertionError(f"{arch}: prefill logits not finite or not moved by "
                             f"the patches ({moved})")
    tok = lg.argmax(-1).to(torch.int32)
    caches = kvcache.pad_to_capacity(cfg, caches, S, S + steps + 1)
    reset_counts(kmoe, kfd)
    step_s, out = [], [tok]
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, caches = M.decode_step(params, caches, tok, S + i, cfg)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        out.append(tok)
    launches = read_counts(kmoe, kfd)
    want = {k: n * steps for k, n in kernel_layers(cfg).items()}
    toks = torch.cat(out, dim=1)
    if prefill_launches != {"moe_gmm": 0, "flash_decode": 0} or launches != want:
        raise AssertionError(f"{arch}: prefill launched {prefill_launches}, decode "
                             f"{launches}, want none and {want}")
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all() or not all_finite(torch, caches):
        raise AssertionError(f"{arch}: bad tokens or non-finite caches")
    pos = S + steps
    step_dev = device_busy_ms(torch, lambda: M.decode_step(params, caches, tok, pos, cfg), 4)
    res = {"arch": arch, **cut_of(cfg, full), "params": n_params(params), "init_s": init_s,
           "batch": batch, "patches": pf, "text_tokens": text, "prefill_len": S,
           "decode_steps": steps, "prefill_ms": 1e3 * prefill_s,
           "decode_ms_per_step_median": 1e3 * _median(step_s),
           "decode_device_ms_per_step": step_dev,
           "max_abs_logit_change_from_patches": moved,
           "prefill_launches": prefill_launches, "launches": launches,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"prefill_patches.{arch}", **res)
    return res


def mla_share(torch, eng, prof, kmoe, kfd):
    """deepseek-v3's decode attention (``mla_decode``: projections, the
    decompression of the latent cache and plain-torch attention over it,
    no kernel of the port) per wave: the profiler's device time of one
    layer's call at the engine's slots and positions, times the MLA layers,
    against the wave's device time in `prof`."""
    from repro_torch.models.layers import mla
    from repro_torch.sharding.dist import NullDist
    from repro_torch.sharding.plans import null_plan
    cfg = eng.cfg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    x = torch.randn((eng.max_batch, 1, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    cache = {n: t.clone() for n, t in eng.caches[0]["mixer"].items()}
    reset_counts(kmoe, kfd)
    ms = device_busy_ms(torch, lambda: mla.mla_decode(
        eng.params["stack"][0]["mixer"], x, cache, eng.pos, cfg,
        null_plan("decode"), NullDist()), 4)
    if read_counts(kmoe, kfd) != {"moe_gmm": 0, "flash_decode": 0}:
        raise AssertionError("mla_decode launched a kernel of the port")
    n = cfg.num_layers
    res = {"arch": cfg.name, "layers": n, "slots": eng.max_batch,
           "seq": eng.max_seq, "positions": eng.pos.tolist(),
           "mla_decode_device_ms_per_layer": ms,
           "mla_decode_device_ms_per_wave": ms * n,
           "wave_device_ms": prof["device_busy_ms_per_wave"],
           "share_of_wave_device_time": ms * n / prof["device_busy_ms_per_wave"]}
    log(f"mla_share.{cfg.name}", **res)
    return res


# ---------------------------------------------------------------------------
# training: the differentiable moe_gmm, f32 parity of the loss and its
# gradients, the Trainer at published widths, exact resume and recovery
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# sharded serving: olmoe-1b-7b on a 2x2 mesh through launch/serve
# ---------------------------------------------------------------------------

SHARDED_MESH = (2, 2)


def near_tie_flips(torch, ref_logits, tokens, vocab, margin=0.05):
    """[(step, row, margin)] where `tokens` differ from the argmax of
    `ref_logits` [T, B, V] and the reference's top-2 margin is not under
    `margin`: the flips the near-tie rule does not allow. Padded vocab ids
    are dropped."""
    lg = ref_logits[..., :vocab].float()
    top2 = lg.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    bad = (lg.argmax(-1) != tokens) & (gap >= margin)
    return [(int(t), int(b), float(gap[t, b])) for t, b in bad.nonzero().tolist()]


def logit_gate(torch, truth, sharded, single, vocab):
    """Position by position against the f32 truth (the same weights in
    f32): e = max_v |sharded - truth| and the single device's own e1 =
    max_v |single - truth| at each (step, row). Sorted from the largest,
    e_(i) <= 1.5 e1_(i) + 1e-3 at every rank i: the rule that holds a bf16
    kernel against the f32 truth (1.5x the plain version's error + 1e-3),
    over the whole distribution of positions. Returns (ranks that fail as
    [(i, e, bound)], readings, e1 [T, B])."""
    tr = truth[..., :vocab].float()
    e = (sharded[..., :vocab].float() - tr).abs().amax(-1)
    e1 = (single[..., :vocab].float() - tr).abs().amax(-1)
    es = e.flatten().sort(descending=True).values
    e1s = e1.flatten().sort(descending=True).values
    allowed = 1.5 * e1s + 1e-3
    q = torch.tensor([0.5, 0.9, 0.99], device=e.device)
    fail = (es > allowed).nonzero()[:, 0].tolist()
    read = {"max": float(es[0]), "q50_q90_q99": torch.quantile(e.flatten(), q).tolist(),
            "single_max": float(e1s[0]),
            "single_q50_q90_q99": torch.quantile(e1.flatten(), q).tolist(),
            "largest_ratio_by_rank": float((es / e1s.clamp(min=1e-30)).max()),
            "ranks_over": len(fail)}
    return [(i, float(es[i]), float(allowed[i])) for i in fail[:8]], read, e1


def flip_gate(torch, truth, tokens, vocab, e1, near=0.05):
    """The sharded run's greedy tokens [T, B] against the f32 truth's
    argmax a, position by position: a token t != a at (step, row) is
    allowed where the truth's top-2 margin there is under `near` (the JAX
    test's rule), or where the gap truth[a] - truth[t] is under 2 x 1.5 x
    e1 (the single device's largest logit error at that position, e1
    from ``logit_gate``: both logits of the pair can move by it). Returns
    (flips not allowed as [(step, row, gap)], readings)."""
    tr = truth[..., :vocab].float()
    a = tr.argmax(-1)
    top2 = tr.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    gap = (tr.gather(-1, a[..., None]) - tr.gather(-1, tokens[..., None].long()))[..., 0]
    flip = tokens != a
    allowed = (margin < near) | (gap < 3 * e1)
    bad = flip & ~allowed
    read = {"flips": int(flip.sum()), "flips_near_tie": int((flip & (margin < near)).sum()),
            "positions_refusing_a_top2_flip": int(((margin >= near)
                                                   & (margin >= 3 * e1)).sum()),
            "positions": int(flip.numel())}
    return [(int(t), int(b), float(gap[t, b])) for t, b in bad.nonzero().tolist()], read


def recording_route(route, chosen: list):
    """``moe.route`` that also appends each call's expert choices (the
    top-k indices [T, k]) to `chosen`."""
    def fn(logits, topk, n_real):
        out = route(logits, topk, n_real)
        chosen.append(out[1].detach())
        return out
    return fn


def replaying_route(torch, route, chosen, counts: list, replay=True):
    """``moe.route`` that takes call i's experts from chosen[i] (one [T, k]
    index tensor per call, in call order), the gates renormalised from the
    caller's own router probabilities; it appends to `counts` the tokens of
    each call whose own top-k differs. With `replay` False it only counts."""
    def fn(logits, topk, n_real):
        gates, own, probs = route(logits, topk, n_real)
        idx = chosen[len(counts)].to(own.device)
        counts.append(int((own.sort(-1).values != idx.sort(-1).values).any(-1).sum()))
        if not replay:
            return gates, own, probs
        picked = probs.gather(-1, idx)
        return picked / torch.clamp(picked.sum(-1, keepdim=True), min=1e-9), idx, probs
    return fn


def to_f32_in_place(tree):
    """Every floating leaf of a tree of dicts and lists made float32, leaf
    by leaf in place: the tree never holds both copies of more than one
    leaf (one deepseek-v3 layer is 23 GB in bf16, 46 GB in f32)."""
    for k in list(tree.keys()) if isinstance(tree, dict) else range(len(tree)):
        if isinstance(tree[k], (dict, list)):
            to_f32_in_place(tree[k])
        elif tree[k].is_floating_point():
            tree[k] = tree[k].float()


def sharded_reference(torch, M, kvcache, cfg, job, tokens, groups, device="cuda",
                      fp8=False, truth=False, routing=None, routed_otherwise=None,
                      replay=True):
    """The single-device port on the same weights (the global draw from
    SEED), fed the sharded run's tokens (teacher forcing), with the MoE
    capacity groups of the sharded run: (batch shards, sequence shards) in
    prefill, the batch shards in decode, as each rank routes its own
    tokens. With `fp8`, each expert input row goes through the e4m3 round
    trip of the fp8 dispatch (a scale per row, as each slot travels), so
    that the reference computes what the sharded run with ``a2a_fp8``
    computes. With `truth`, the same weights (drawn in the job's dtype)
    run in f32: the arithmetic without rounding to the job's dtype. With
    `routing` (the sharded run's expert choices, one [T, k] tensor per MoE
    call in the single device's token order), every MoE layer takes those
    experts (``replaying_route``; with `replay` False it keeps its own),
    and `routed_otherwise` receives the number of tokens per call whose own
    choice differs. An encoder-decoder
    encodes the run's frames (``serve.frames`` from the job's seed, in the
    job's dtype) and decodes over ``enc_len = max_seq``, as the run does.
    Returns the f32 logits [new_tokens, B, V_pad]: the prefill's last
    position, then each decode step's."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import moe as moe_mod
    from repro_torch.models.layers.common import fp8_dequantize, fp8_quantize
    gmm, route = ops.moe_gmm, moe_mod.route
    params = M.init_model(cfg, None, seed=job["seed"], device=device)
    if truth:
        to_f32_in_place(params)
        cfg = cfg.replace(dtype="float32")
    P, S = job["prompt_len"], job["max_seq"]
    prompts = torch.as_tensor(tokens["prompts"], device=device)
    out = torch.as_tensor(tokens["tokens"], device=device)
    batch, enc_len = {"tokens": prompts}, 0
    if cfg.is_encoder_decoder:
        # the run's frames, rounded to its dtype as it encoded them
        from repro_torch.launch.serve import frames, job_config
        batch["frames"] = torch.from_numpy(frames(cfg.d_model, prompts.shape[0], P,
                                                  job["seed"])).to(
            device, getattr(torch, job_config(job).dtype))
        enc_len = S
    try:
        if fp8:
            ops.moe_gmm = lambda x, *w: gmm(fp8_dequantize(*fp8_quantize(x), x.dtype), *w)
        if routing is not None:
            moe_mod.route = replaying_route(torch, route, routing,
                                            [] if routed_otherwise is None
                                            else routed_otherwise, replay)
        with torch.no_grad():
            lg, caches = M.prefill_logits(params, batch, cfg, capacity_groups=groups)
            caches = kvcache.pad_to_capacity(cfg, caches, P, S)
            logits = [lg[:, 0]]
            for i in range(job["new_tokens"] - 1):
                lg, caches = M.decode_logits(params, caches, out[:, i:i + 1], P + i,
                                             cfg, capacity_groups=groups[0],
                                             enc_len=enc_len)
                logits.append(lg[:, 0])
    finally:
        ops.moe_gmm, moe_mod.route = gmm, route
    del params, caches
    return torch.stack(logits)


# each sharded serving phase's depth, new tokens and f32 cut: four f32
# ranks of all 16 olmoe layers take 59 GB of the card; a full-width f32
# deepseek-v3 layer is 46 GB, so its f32 job keeps 32 of 256 experts (the
# parity_f32 phase's cut); jamba's f32 job keeps 5 layers, its attention
# layer among them. deepseek-v3's timed job (nccl, four cards) is 4 layers:
# ~49 GB a rank, where 5 would be ~61 GB before any transient. `replay`:
# the references take the sharded run's expert choices. Top-k is
# discontinuous: where bf16 rounding sends a token of jamba's first MoE
# layer to another expert, the seven layers after it and every later step
# move by O(1), in the single device as in the sharded run, at other
# positions (on an H100 80GB HBM3 at 700 W without the replay: the bf16
# single device up to 5.4 from the f32 truth, and 38 of 128 greedy tokens
# apart from the sharded run). olmoe-1b-7b too: its single device would
# route 717 tokens of 512 calls otherwise (bf16), and without the replay
# its logits sit 0.43 from the truth where 0.05 is the arithmetic's own
# (same card). rwkv6-1.6b and seamless-m4t-medium run whole (24 layers;
# 12 + 12) in both jobs: dense, so no fp8 dispatch job. olmoe's f32 job
# keeps its own routing: the check that the sharded run routes as the
# single device does, where no rounding to bf16 moves a top-k choice.
SHARDED_ARCHS = {
    "olmoe-1b-7b": dict(layers=None, new_tokens=32, f32=dict(layers=8),
                        replay=("bf16", "fp8"), dbo="bf16"),
    "deepseek-v3": dict(layers=1, new_tokens=16, f32=dict(layers=1, experts=32),
                        timed_layers=4, replay=("bf16", "fp8", "f32"),
                        dbo="bf16_4_layers"),
    "jamba-v0.1-52b": dict(layers=8, new_tokens=16, f32=dict(layers=5),
                           replay=("bf16", "fp8", "f32")),
    "rwkv6-1.6b": dict(layers=None, new_tokens=16, f32=dict(layers=None)),
    "seamless-m4t-medium": dict(layers=None, new_tokens=16, f32=dict(layers=None)),
}


def sharded_jobs(arch, timed=False, **cut):
    """The jobs of ``sharded_phase`` for `arch`: bf16, the fp8 dispatch (a
    MoE config only) and f32 (16 new tokens), each held to the single
    device; with `timed`, for an arch with ``timed_layers``, one more bf16
    job that deep, timed and not held to a single device (it would not fit
    one card). The job the arch names under ``dbo`` also runs the DBO
    sub-run (``sharded_dbo_subrun``)."""
    import dataclasses

    from repro_torch.launch.serve import job_config
    spec = SHARDED_ARCHS[arch]
    base = dict(arch=arch, batch=8, prompt_len=64, max_seq=512,
                new_tokens=spec["new_tokens"], seed=SEED, logits=True)
    if spec["layers"]:
        base["layers"] = spec["layers"]
    base.update(cut)
    f32 = dict(base, new_tokens=16, layers=cut.get("layers", spec["f32"]["layers"]),
               config=dict(base.get("config", {}), dtype="float32"))
    experts = spec["f32"].get("experts")
    cfg = job_config(f32)
    if experts and cfg.moe.num_experts > experts:
        f32["config"]["moe"] = dataclasses.replace(cfg.moe, num_experts=experts)
    jobs = {"bf16": base, "fp8": dict(base, a2a_fp8=True), "f32": f32}
    if cfg.moe is None:
        del jobs["fp8"]
    if timed and "timed_layers" in spec:
        jobs[f"bf16_{spec['timed_layers']}_layers"] = dict(
            base, layers=spec["timed_layers"], reference=False)
    if spec.get("dbo") in jobs:
        jobs[spec["dbo"]] = dict(jobs[spec["dbo"]], dbo_subrun=True)
    return jobs


def predicted_a2a_bytes(cfg, job, mesh=SHARDED_MESH):
    """The MoE all-to-all bytes a rank sends per decode step: E * C * D *
    (bytes per element) * (ep - 1) / ep per MoE layer, E the experts padded
    to the EP group, C the capacity of one rank's B / dp tokens; the fp8
    dispatch sends 1-byte values and a f32 scale per slot. A config
    without experts sends none."""
    from repro_torch.models.layers.moe import capacity
    if cfg.moe is None:
        return {"dispatch": 0, "combine": 0}
    dp = ep = mesh[0]
    n_moe = sum(s.ffn == "moe" for s in cfg.layer_specs)
    m, d = cfg.moe, cfg.d_model
    e = m.padded_num_experts(ep)
    c = capacity(job["batch"] // dp, m.experts_per_token, e, m.capacity_factor)
    el = 4 if cfg.dtype == "float32" else 2
    share = (ep - 1) / ep
    combine = n_moe * e * c * d * el * share
    dispatch = n_moe * (e * c * d + 4 * e * c) * share if job.get("a2a_fp8") else combine
    return {"dispatch": dispatch, "combine": combine}


def predicted_dense_decode_bytes(cfg, job, mesh=SHARDED_MESH):
    """The all-reduce and all-gather bytes (and calls) a rank sends per
    decode step for a config without experts (RWKV, or GQA attention with
    dense FFNs, with cross-attention for an encoder-decoder), reckoned from
    the shapes as ``CountingDist`` counts them: an all-reduce of b bytes
    over n ranks sends 2 b (n - 1) / n, an all-gather (n - 1) b. A rank
    holds B / data rows. The embedding psums its [B_loc, D] rows over
    model; the greedy sample takes a pmax of the f32 row maxima and one of
    the int64 candidate ids. Each RWKV layer psums its time mix's and its
    channel mix's [B_loc, D] outputs. Each GQA attention (and cross-)
    attention gathers q [B_loc, H / tp, hd] over model under head-TP,
    merges its KV shard's f32 (o [B_loc, H, hd], m, l [B_loc, H]) with a
    pmax and two psums over the kv axis, and psums its row-sharded output
    [B_loc, D] under head-TP; a dense FFN psums [B_loc, D]. ``ffn_2d`` is
    off."""
    from repro_torch.launch.serve import job_config
    from repro_torch.sharding.plans import head_tp_ok
    dp, tp = mesh
    b, d = job["batch"] // dp, cfg.d_model
    el = 4 if job_config(job).dtype == "float32" else 2
    ar_share, ag_share = 2 * (tp - 1) / tp, tp - 1
    ar = [b * d * el, b * 4, b * 8]                      # embed, greedy sample
    ag = []
    head_tp = head_tp_ok(cfg, tp)
    h, hd = cfg.num_heads, cfg.head_dim
    n_attn = 1 + cfg.is_encoder_decoder                  # self (+ cross) a layer
    for spec in cfg.layer_specs:
        if spec.mixer == "rwkv":
            ar += [b * d * el] * 2
            continue
        for _ in range(n_attn):
            ar += [b * h * 4, b * h * 4, b * h * hd * 4]
            if head_tp:
                ag.append(b * (h // tp) * hd * el)
                ar.append(b * d * el)
        ar.append(b * d * el)                            # the dense FFN
    return {"all_reduce": sum(ar) * ar_share, "all_gather": sum(ag) * ag_share,
            "calls": {"all_reduce": len(ar), "all_gather": len(ag)}}


DBO_SUBRUN_STEPS = 4      # compared and timed steps; then 2 + 2 profiled


def _intervals_len(iv) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(iv):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _covered(a, b, iv) -> float:
    """Length of (a, b) covered by the union of intervals `iv`."""
    return _intervals_len([(max(a, x), min(b, y)) for x, y in iv if y > a and x < b])


def device_split(trace: dict, n_steps: int) -> dict:
    """Per step, from a chrome trace of the profiler: device ms of the NCCL
    all-to-all kernels (send/recv), of the other NCCL kernels, of compute
    (every other kernel); the share of all-to-all kernel time that lies
    under a compute kernel on another stream (the overlap); and the idle
    share between the first and the last device item (kernels, copies,
    sets)."""
    items = [e for e in trace.get("traceEvents", [])
             if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    kern = [(e["ts"], e["ts"] + e["dur"], e["name"], e.get("args", {}).get("stream"))
            for e in items if e["cat"] == "kernel"]
    nccl = [k for k in kern if k[2].startswith("nccl")]
    a2a = [k for k in nccl if "SendRecv" in k[2] or "AllToAll" in k[2]]
    compute = [k for k in kern if not k[2].startswith("nccl")]
    other = [k for k in nccl if k not in a2a]

    def ms(ks):
        return sum(b - a for a, b, *_ in ks) / n_steps / 1e3
    a2a_us = sum(b - a for a, b, *_ in a2a)
    under = sum(_covered(a, b, [(x, y) for x, y, _, st in compute if st != s])
                for a, b, _, s in a2a)
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in items]
    window = (max(b for _, b in spans) - min(a for a, _ in spans)) if spans else 0.0
    return {"a2a_device_ms": ms(a2a), "other_nccl_device_ms": ms(other),
            "compute_device_ms": ms(compute),
            "a2a_kernels": len(a2a), "nccl_kernels": len(nccl), "kernels": len(kern),
            "overlap_share": under / a2a_us if a2a_us else None,
            "idle_share": 1 - _intervals_len(spans) / window if window else None}


def sharded_dbo_subrun(ctx, steps_n=DBO_SUBRUN_STEPS):
    """The DBO sub-run of a sharded job, on every rank, on the job's own
    weights and caches once its decode has ended (``serve_job``'s
    `after`): each rank's rows cut in two halves (``kvcache.split_rows``),
    then per step the two plain decode steps of B/2, the DBO step
    (``steps.build_dbo_decode_step``) and the plain step of B, each
    between device synchronisations. Checked per step: the DBO tokens and
    f32 logits bitwise the plain pair's, its collective bytes and calls
    the pair's exactly (``CountingDist``), its kernel launches the pair's,
    and no all-to-all handle left waiting; at the end every cache leaf
    bitwise. Then 2 DBO steps and 2 plain pairs again, rank 0 under the
    profiler (``device_split``)."""
    import torch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.convert import tree_leaves
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import moe_gmm as kmoe
    from repro_torch.launch import steps
    from repro_torch.serving import kvcache
    mesh, dist, dev, cfg, plan = (ctx[k] for k in ("mesh", "dist", "dev", "cfg", "plan"))
    B, S = ctx["job"]["batch"], ctx["job"]["max_seq"]
    params, full, decode = ctx["params"], ctx["caches"], ctx["decode"]
    half = steps.build_decode_step(cfg, ShapeCell("d", S, B // 2, "decode"), plan, mesh,
                                   dist=dist, logits=True)
    dbo = steps.build_dbo_decode_step(cfg, ShapeCell("d", S, B, "decode"), plan, mesh,
                                      dist=dist, logits=True)
    plain, mine = list(kvcache.split_rows(full)), list(kvcache.split_rows(full))
    tf = ctx["tok"]
    pa, pb = tf.chunk(2, dim=0)
    ta, tb = pa, pb

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def counted(fn):
        reset_counts(kmoe, kfd)
        kfd.lse_launches = 0
        dist.reset()
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        launches = dict(read_counts(kmoe, kfd), flash_decode_lse=kfd.lse_launches)
        return out, time.perf_counter() - t, launches, dist.snapshot()

    res = {"steps": steps_n, "microbatch_rows_local": int(pa.shape[0]), "failures": []}
    walls = {"dbo": [], "plain_pair": [], "plain_batch": []}
    for i in range(steps_n):
        pos = ctx["pos"] + i
        (pa, plain[0], lpa, pb, plain[1], lpb), w, l_pair, c_pair = counted(
            lambda: (*half(params, plain[0], pa, pos), *half(params, plain[1], pb, pos)))
        walls["plain_pair"].append(w)
        (ta, tb, mine[0], mine[1], la, lb), w, l_dbo, c_dbo = counted(
            lambda: dbo(params, mine[0], mine[1], ta, tb, pos))
        walls["dbo"].append(w)
        if dist.pending:
            res["failures"].append(f"step {i}: {dist.pending} all-to-all handles waiting")
        if not (torch.equal(ta, pa) and torch.equal(tb, pb)):
            res["failures"].append(f"step {i}: tokens differ from two plain steps")
        if not (torch.equal(la, lpa) and torch.equal(lb, lpb)):
            res["failures"].append(f"step {i}: logits differ from two plain steps")
        if c_dbo != c_pair:
            res["failures"].append(f"step {i}: collectives {c_dbo}, plain pair {c_pair}")
        if l_dbo != l_pair:
            res["failures"].append(f"step {i}: launches {l_dbo}, plain pair {l_pair}")
        if i == 0:
            res.update(collectives_per_step=c_dbo, launches_per_step=l_dbo)
        out, w, _, _ = counted(lambda: decode(params, full, tf, pos))
        tf = out[0]
        walls["plain_batch"].append(w)
    if not all(torch.equal(g, w) for g, w in zip(tree_leaves(mine), tree_leaves(plain))):
        res["failures"].append("caches differ from two plain steps")
    res.update({f"{k}_wall_ms_median": 1e3 * _median(v) for k, v in walls.items()})
    res["wall_ms"] = {k: [1e3 * t for t in v] for k, v in walls.items()}

    # the profile: two DBO steps, then two plain pairs, rank 0 traced
    from contextlib import nullcontext

    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else [ProfilerActivity.CPU]
    pos = ctx["pos"] + steps_n
    runs = {"dbo": lambda p: dbo(params, mine[0], mine[1], ta, tb, p),
            "plain_pair": lambda p: (half(params, plain[0], pa, p),
                                     half(params, plain[1], pb, p))}
    for name, fn in runs.items():
        sync()
        with (profile(activities=acts) if mesh.rank == 0 else nullcontext()) as prof:
            for j in range(2):
                fn(pos + j)
            sync()
        if mesh.rank == 0:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    res[f"profile_{name}"] = device_split(json.load(f), 2)
    del plain, mine
    return res


def dbo_subrun_gate(cfg, job, subs, n_gqa, device, failures) -> dict:
    """Every rank's DBO sub-run (``sharded_dbo_subrun``) held to its checks,
    its dispatch and combine bytes a step to two plain steps of B/2 as
    ``predicted_a2a_bytes`` reckons them, and, on the card, its launches a
    step to two of each kernel a layer. Returns rank 0's readings with
    every rank's medians."""
    n_moe = sum(s.ffn == "moe" for s in cfg.layer_specs)
    pred = {k: 2 * v for k, v in
            predicted_a2a_bytes(cfg, dict(job, batch=job["batch"] // 2)).items()}
    want = {"moe_gmm": 2 * n_moe, "flash_decode_lse": 2 * n_gqa, "flash_decode": 0}
    for r, sub in enumerate(subs):
        failures += [f"dbo rank {r}: {f}" for f in sub["failures"]]
        sent = {k: v["bytes"] for k, v in sub["collectives_per_step"].items()}
        if any(not math.isclose(sent.get(k, 0), v, rel_tol=1e-9) for k, v in pred.items()):
            failures.append(f"dbo rank {r}: all-to-all bytes a step "
                            f"{ {k: sent.get(k) for k in pred} }, two plain steps of "
                            f"B/2 {pred}")
        if device == "cuda" and sub["launches_per_step"] != want:
            failures.append(f"dbo rank {r}: launches a step {sub['launches_per_step']}, "
                            f"want {want}")
    out = {k: v for k, v in subs[0].items() if k != "failures"}
    out["predicted_a2a_bytes_per_step"] = pred
    out["ranks_wall_ms_median"] = [{k: sub[f"{k}_wall_ms_median"] for k in
                                    ("dbo", "plain_pair", "plain_batch")} for sub in subs]
    return out


def sharded_serve_rank(mesh, dist, dev, jobs):
    """Every rank of ``sharded_phase``: ``launch.serve``'s job for each of
    `jobs`, each MoE layer's expert choices recorded (``recording_route``)
    and gathered to rank 0 (``res["routing"]``) in the single device's
    token order: in prefill each rank's tokens are one capacity group, in
    the ranks' row-major order (capacity groups (dp, sp)); in decode a
    data rank's rows."""
    from repro_torch.launch.serve import job_config, serve_job
    from repro_torch.models.layers import moe as moe_mod
    route, out = moe_mod.route, []
    for job in jobs:
        chosen = []
        moe_mod.route = recording_route(route, chosen)
        try:
            res = serve_job(mesh, dist, dev, job,
                            after=sharded_dbo_subrun if job.get("dbo_subrun") else None)
        finally:
            moe_mod.route = route
        n_moe = sum(s.ffn == "moe" for s in job_config(job).layer_specs)
        # the sub-run's expert choices come after the job's
        n_job = n_moe * job["new_tokens"]
        chosen = chosen[:n_job]
        routing = [dist.all_gather(c, tuple(mesh.axes), dim=0) for c in chosen[:n_moe]] \
            + [dist.all_gather(c, "data", dim=0) for c in chosen[n_moe:]]
        if mesh.rank == 0:
            res["routing"] = [c.cpu().numpy() for c in routing]
        out.append(res)
    return out


def sharded_phase(torch, M, kvcache, smi, device="cuda", arch="olmoe-1b-7b",
                  timed=False, **cut):
    """`arch` at published widths (random weights from SEED drawn in the
    global layout, the ranks one after another, each keeping its shards)
    through ``launch.serve`` on a 2x2 (data x model) mesh: 8 prompts of 64
    tokens, max_seq 512, in bf16 with the bf16 and with the fp8 dispatch,
    and in f32 (TF32 off), each cut as ``SHARDED_ARCHS`` says; with
    `timed`, one more bf16 job deeper (``sharded_jobs``). nccl with a card
    per rank, else four ranks on card 0 over gloo (NCCL refuses two ranks
    on one card).

    Each held job is held against the single-device port on the same
    weights, fed the run's own tokens, with the sharded run's MoE capacity
    groups (the fp8 run: with the e4m3 round trip of its dispatch) and,
    for a job its arch lists under ``replay``, its expert choices, after
    the ranks have freed the card. f32: the logits within 1e-3 of the
    single device, flips only where its top-2 margin is under 0.05. bf16
    and fp8: held, with the single device, to the f32 truth (the same
    weights in f32), position by position (``logit_gate``, ``flip_gate``):
    the bf16 single device alone is up to ~0.4 from the truth at full width
    and flips greedy tokens at margins well past 0.05, as an expert choice
    or a capacity drop turns on one rounding. The fp8 run's distance from
    the bf16 reference is printed. Every job: each greedy token is the
    argmax of the run's own gathered logits, the logits are finite, the
    MoE all-to-all bytes a rank sends per step equal the prediction
    (``predicted_a2a_bytes``), and every rank launches ``moe_gmm`` on every
    MoE layer and the (o, m, l) ``flash_decode`` on every GQA layer (and
    every cross-attention) of every decode step (MLA, Mamba and RWKV
    layers have no kernel). A config without experts (rwkv6, seamless) has
    no fp8 job; its all-reduce and all-gather bytes a step, and nothing
    else, equal ``predicted_dense_decode_bytes``. An encoder-decoder's
    prefill encodes ``serve.frames`` from SEED. `device` and `cut` (job
    keys) are for a rehearsal of this phase on the CPU at a reduced
    size."""
    from repro_torch.launch import serve
    from repro_torch.launch.serve import job_config
    from repro_torch.sharding import counting
    tag = "sharded" if arch == "olmoe-1b-7b" else f"sharded.{arch}"
    n_cards = torch.cuda.device_count()
    n_ranks = math.prod(SHARDED_MESH)
    transport = "nccl" if device == "cuda" and n_cards >= n_ranks else "gloo"
    log(f"{tag}.transport", transport=transport, cards=n_cards, ranks=n_ranks,
        why=("one rank per card" if transport == "nccl" else
             "four ranks share card 0: NCCL refuses two ranks on one card, so "
             "collectives go through host memory over gloo; their times say "
             "nothing about NVLink"), nvidia_smi=smi)
    if device == "cuda":
        log(f"{tag}.card_memory",
            parent_allocated_gib=torch.cuda.memory_allocated() / 2 ** 30,
            parent_reserved_gib=torch.cuda.memory_reserved() / 2 ** 30,
            used_mib=subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                                     "--format=csv,noheader,nounits"], capture_output=True,
                                    text=True).stdout.strip())
    jobs = sharded_jobs(arch, timed=timed, **cut)
    t0 = time.perf_counter()
    ranks = serve.spawn(sharded_serve_rank, (list(jobs.values()),),
                        mesh_shape=SHARDED_MESH, transport=transport, device=device,
                        wrap_dist=counting.count_collectives, timeout=900)
    replays = SHARDED_ARCHS[arch].get("replay", ())
    out = {"arch": arch, "transport": transport, "nvidia_smi": smi,
           "serve_wall_s": time.perf_counter() - t0, "jobs": {},
           "predicted_by_job": {}}
    failures = []
    for j, (name, job) in enumerate(jobs.items()):
        cfg = job_config(job)
        steps_n = job["new_tokens"] - 1
        n_moe = sum(s.ffn == "moe" for s in cfg.layer_specs)
        n_gqa = sum(s.mixer in ("attn", "attn_local") for s in cfg.layer_specs) \
            if cfg.attn_kind == "gqa" else 0
        n_gqa += cfg.num_layers if cfg.is_encoder_decoder else 0   # cross-attention
        pred = predicted_a2a_bytes(cfg, job)
        out["predicted_by_job"][name] = pred
        dense = predicted_dense_decode_bytes(cfg, job) if cfg.moe is None else None
        if dense:
            out.setdefault("predicted_dense_by_job", {})[name] = dense
        per_rank = []
        for r in range(n_ranks):
            res = ranks[r][j]
            dec, pre = res["launches"]["decode"], res["launches"]["prefill"]
            want = {"moe_gmm": n_moe * steps_n, "flash_decode_lse": n_gqa * steps_n,
                    "flash_decode": 0}
            if device == "cuda" and (dec != want or pre["moe_gmm"] != n_moe
                                     or pre["flash_decode_lse"]):
                failures.append(f"{name} rank {r}: launches {dec} in decode, {pre} "
                                f"in prefill; want {want} and {n_moe} moe_gmm in prefill")
            snap = res["snapshots"]["decode"] or {}
            row = {"rank": r, "coords": res["coords"], "transport": transport,
                   "prefill_ms": 1e3 * res["prefill_s"],
                   "decode_ms_per_step_median": 1e3 * _median(res["decode_step_s"]),
                   "decode_ms_per_step": [1e3 * t for t in res["decode_step_s"]],
                   "relayout_ms": 1e3 * res["relayout_s"],
                   "reshard_s": res["reshard_s"], "init_s": res["init_s"],
                   "peak_gib": res.get("peak_bytes", 0) / 2 ** 30,
                   "param_gib": res["param_bytes"] / 2 ** 30,
                   "cache_mib": res["cache_bytes"] / 2 ** 20,
                   "launches": res["launches"],
                   "collective_bytes_per_step": {k: v["bytes"] / steps_n
                                                 for k, v in snap.items()},
                   "collective_calls_per_step": {k: v["calls"] / steps_n
                                                 for k, v in snap.items()},
                   "collective_prefill": res["snapshots"]["prefill"] or {},
                   "param_bytes": res["param_bytes"], "cache_bytes": res["cache_bytes"],
                   "reshard_bytes": (res["snapshots"]["reshard"] or {}).get(
                       "p2p", {}).get("bytes", 0),
                   "relayout_bytes": sum(v["bytes"] for v in
                                         (res["snapshots"]["relayout"] or {}).values())}
            sent = row["collective_bytes_per_step"]
            if any(not math.isclose(sent.get(k, 0), v, rel_tol=1e-9) for k, v in pred.items()):
                failures.append(f"{name} rank {r}: all-to-all bytes a step "
                                f"{ {k: sent.get(k) for k in pred} }, predicted {pred}")
            if dense:
                want_b = {k: dense[k] for k in ("all_reduce", "all_gather")}
                if set(sent) - set(want_b) or any(
                        not math.isclose(sent.get(k, 0), v, rel_tol=1e-9)
                        for k, v in want_b.items()):
                    failures.append(f"{name} rank {r}: collective bytes a step {sent}, "
                                    f"predicted {want_b}")
            per_rank.append(row)
            log(f"{tag}.{name}.rank", **{k: v for k, v in row.items()
                                         if k != "decode_ms_per_step"}, nvidia_smi=smi)
        if job.get("dbo_subrun"):
            sub = dbo_subrun_gate(cfg, job, [ranks[r][j]["after"] for r in range(n_ranks)],
                                  n_gqa, device, failures)
            out.setdefault("dbo", {})[name] = sub
            log(f"{tag}.{name}.dbo", **{k: v for k, v in sub.items() if k != "wall_ms"},
                transport=transport, nvidia_smi=smi)
        r0 = ranks[0][j]
        v = cfg.vocab_size
        fp8 = bool(job.get("a2a_fp8"))
        sharded = torch.as_tensor(r0["logits"], device=device)
        tokens = torch.as_tensor(r0["tokens"], device=device).T        # [T, B]
        res = {"ranks": per_rank, **cut_of(cfg, job_config(dict(arch=arch))),
               "dtype": cfg.dtype, "a2a_fp8": fp8, "tokens_row0": r0["tokens"][0].tolist(),
               "predicted_a2a_bytes_per_step": pred}
        if not bool(torch.isfinite(sharded[..., :v]).all()):
            failures.append(f"{name}: logits not finite")
        # every token is the argmax of the run's own gathered logits (the
        # vocab-sharded greedy sampling, lowest index on a tie)
        if not bool((sharded[..., :v].argmax(-1) == tokens).all()):
            failures.append(f"{name}: a greedy token is not the argmax of the run's "
                            "own logits")
        if job.get("reference") is False:
            res["reference"] = "none: timed only (the single device would not fit one card)"
            out["jobs"][name] = res
            log(f"{tag}.{name}", **{k: v for k, v in res.items() if k != "ranks"},
                transport=transport, nvidia_smi=smi)
            continue
        # a MoE job's references replay the run's expert choices where the
        # arch lists the job, and otherwise route for themselves; both count
        # the tokens the single device routes otherwise
        replay = name in replays
        routing = [torch.as_tensor(c, device=device) for c in r0["routing"]] \
            if cfg.moe is not None else None
        otherwise = []
        ref_logits = sharded_reference(torch, M, kvcache, cfg, job, r0, (2, 2), device,
                                       fp8=fp8, routing=routing, routed_otherwise=otherwise,
                                       replay=replay)
        if routing is not None:
            res["references_replay_expert_choices"] = replay
            res["tokens_the_single_device_routes_otherwise"] = {
                "total": sum(otherwise), "calls": len(otherwise), "max_per_call": max(otherwise)}
        diff = (sharded[..., :v] - ref_logits[..., :v]).abs().max().item()
        res.update(max_abs_logit_diff_vs_single_device=diff,
                   flips_vs_single_device=int((ref_logits[..., :v].argmax(-1)
                                               != tokens).sum()))
        if name == "f32":
            res["rule"] = "logits within 1e-3; flips only where the top-2 margin < 0.05"
            res["flips_not_allowed"] = near_tie_flips(torch, ref_logits, tokens, v)
            if not diff <= 1e-3:
                failures.append(f"f32 logits differ from the single device by {diff} > 1e-3")
        else:
            truth = sharded_reference(torch, M, kvcache, cfg, job, r0, (2, 2), device,
                                      fp8=fp8, truth=True, routing=routing, replay=replay)
            over, res["logits_vs_truth"], e1 = logit_gate(torch, truth, sharded,
                                                          ref_logits, v)
            res["flips_not_allowed"], res["tokens_vs_truth"] = flip_gate(
                torch, truth, tokens, v, e1)
            res["reference"] = ("single device; truth: the same weights in f32"
                                + (", both with the e4m3 round trip of each expert "
                                   "input row" if fp8 else ""))
            res["rule"] = ("per-position max |logit - truth|, sorted, <= 1.5 x the single "
                           "device's + 1e-3 at every rank; a token off the truth's argmax "
                           "only at a top-2 margin < 0.05 or a gap < 3 x the single "
                           "device's error at that position")
            if over:
                failures.append(f"{name}: per-position logit errors over the bound "
                                f"(rank, error, bound): {over}")
            del truth, e1
        if fp8:
            res["max_abs_logit_diff_vs_bf16_reference"] = (
                sharded[..., :v] - sharded_reference(torch, M, kvcache, cfg, job, r0, (2, 2),
                                                     device, routing=routing,
                                                     replay=replay)[..., :v]
            ).abs().max().item()
        if res["flips_not_allowed"]:
            failures.append(f"{name}: tokens flip where no rule allows it "
                            f"(step, row, gap): {res['flips_not_allowed']}")
        out["jobs"][name] = res
        log(f"{tag}.{name}", **{k: v for k, v in res.items() if k != "ranks"},
            transport=transport, nvidia_smi=smi)
        del ref_logits, sharded
        if device == "cuda":
            torch.cuda.empty_cache()
    # the base jobs' predictions under their earlier names
    pb, pf = out["predicted_by_job"]["bf16"], out["predicted_by_job"].get("fp8", {})
    out["predicted_bytes_per_step"] = {"dispatch_bf16": pb["dispatch"],
                                       "combine": pb["combine"],
                                       "dispatch_fp8": pf.get("dispatch", 0)}
    log(f"{tag}.predicted", **out["predicted_by_job"],
        dense=out.get("predicted_dense_by_job"))
    if failures:
        raise AssertionError(f"sharded.{arch}: " + "; ".join(failures))
    return out


TRAIN_SHARDED_LAYERS = 4   # of olmoe-1b-7b's 16: ~1.9 B params over four ranks
EXPERT_LEAVES = ("ffn/w_gate", "ffn/w_up", "ffn/w_down")


def silent_experts(params, grads):
    """The local experts of this rank whose reduced gradient is zero in
    some expert weight: ["stack/i/ffn/w_gate expert e", ...]."""
    from repro_torch.training.checkpoint import flatten
    out = []
    for key, g in zip(flatten(params), grads):
        if key.endswith(EXPERT_LEAVES):
            dead = (g.flatten(1).abs().amax(1) == 0).nonzero().flatten().tolist()
            out += [f"{key} expert {e}" for e in dead]
    return out


def f32_train_gate(mesh, dist, dev, gate):
    """One f32 training step's loss and gradients across the ranks (FSDP
    on, `gate`'s plan knobs) against the single-device port on the same
    card, weights (the global draw from the seed) and tokens, with the
    sharded run's MoE capacity groups (batch shards x sequence shards).
    Top-k routing is discontinuous: hidden states that differ in the last
    bits (another summation order) send a token whose k-th and (k+1)-th
    router probabilities nearly tie to another expert, and that token's
    gradients then differ at O(1). So the gated reference replays the
    sharded run's expert choices (each rank's top-k indices, recorded and
    gathered; the gates recomputed from the reference's own router
    probabilities), and a second reference with its own routing is
    reported beside it, with the number of tokens it routes otherwise.
    An encoder-decoder's batch carries ``serve.frames`` from the seed, in
    f32, split as the tokens.
    Every gradient leaf is gathered to its global shape; rank 0 computes
    the references while the others wait. Returns (on rank 0) the losses,
    their relative errors, and the worst gradient errors over their
    leaf's largest reference magnitude."""
    import torch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.convert import shard_leaf, unshard_leaf
    from repro_torch.launch import steps
    from repro_torch.launch.serve import frames, job_config, mesh_axes
    from repro_torch.models import model as M
    from repro_torch.models.layers import moe as moe_mod
    from repro_torch.sharding.plans import make_plan
    from repro_torch.sharding.specs import spec_leaves
    from repro_torch.training.checkpoint import flatten
    from repro_torch.training.data import DataConfig, SyntheticLM
    t0 = time.perf_counter()
    cfg = job_config(gate)
    B, S = gate["batch"], gate["seq"]
    cell = ShapeCell("t", S, B, "train")
    plan = make_plan(cfg, cell, mesh_axes(mesh.shape), mesh.shape, fsdp=True,
                     ring_attn=bool(gate.get("ring_attn")))
    step = steps.build_train_step(cfg, cell, plan, mesh, dist=dist, remat=False)
    params = steps.init_params(cfg, plan, mesh, seed=gate["seed"], device=dev)
    tokens = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                    seed=gate["seed"])).batch(0)
    inputs = {"tokens": tokens}
    if cfg.is_encoder_decoder:
        inputs["frames"] = frames(cfg.d_model, B, S, gate["seed"])
    local = {k: torch.from_numpy(shard_leaf(v, step.in_specs[k], mesh)).to(dev)
             for k, v in inputs.items()}
    route, chosen = moe_mod.route, []
    moe_mod.route = recording_route(route, chosen)
    try:
        loss, grads = step.loss_and_grads(params, local)
    finally:
        moe_mod.route = route
    grads = step.reduce(params, grads)
    keys, specs = list(flatten(params)), spec_leaves(step.param_specs, params)
    del params
    # each rank's tokens are one capacity group, in the ranks' row-major
    # order: the single device's token order under capacity_groups (dp, sp)
    chosen = [dist.all_gather(c, tuple(mesh.axes), dim=0) for c in chosen]
    full = []
    for g, spec in zip(grads, specs):
        f = unshard_leaf(g, spec, dist)
        full.append(f if mesh.rank == 0 else None)
    del grads
    out = {"rank": mesh.rank, "plan": repr(plan), "loss": float(loss),
           "seconds": time.perf_counter() - t0}
    if mesh.rank != 0:
        return out
    groups = (plan.dp, dist.size(plan.seq_axis))

    def reference(replay):
        flips = []
        single = M.init_model(cfg, None, seed=gate["seed"], device=dev)
        leaves = [p.requires_grad_() for p in flatten(single).values()]
        moe_mod.route = replaying_route(torch, route, chosen, flips, replay)
        try:
            batch = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
            l_ref = M.train_loss(single, batch, cfg, remat=False, capacity_groups=groups)
            ref = torch.autograd.grad(l_ref, leaves, materialize_grads=True)
            l_ref = l_ref.detach()
        finally:
            moe_mod.route = route
        errs = {k: float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)
                for k, a, b in zip(keys, full, ref)}
        worst = max(errs, key=errs.get)
        del single, leaves, ref
        return {"loss_single_device": float(l_ref),
                "loss_rel_err": abs(float(loss) - float(l_ref)) / abs(float(l_ref)),
                "worst_grad_err_over_max": errs[worst], "worst_leaf": worst,
                "largest_errors": dict(sorted(errs.items(), key=lambda kv: -kv[1])[:6]),
                "tokens_routed_otherwise_by_layer": flips}

    out.update(reference(replay=True), leaves=len(keys), capacity_groups=list(groups),
               tokens=B * S)
    out["own_routing"] = reference(replay=False)
    del full
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def train_sharded_rank(mesh, dist, dev, jobs, gates):
    """Every rank of ``train_sharded_phase``: the training jobs through
    ``launch.train.train_job`` (each local expert's gradient checked after
    step 0), then the f32 gates (``f32_train_gate``)."""
    import torch
    from repro_torch.launch.train import train_job
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, job in jobs.items():
        silent = []

        def on_grads(i, params, grads):
            if i == 0:
                silent.extend(silent_experts(params, grads))
        out[name] = train_job(mesh, dist, dev, job, on_grads=on_grads)
        out[name]["silent_experts"] = silent
    for name, gate in gates.items():
        out[name] = f32_train_gate(mesh, dist, dev, gate)
    return out


def train_sharded_phase(torch, smi, device="cuda", **cut):
    """olmoe-1b-7b at published widths cut to TRAIN_SHARDED_LAYERS layers,
    trained through ``launch.train`` on a 2x2 (data x model) mesh: FSDP
    over data, EP, TP and the sequence over model; 8 x 512 tokens a step
    from ``SyntheticLM``, lr 1e-3, 6 steps, bf16, once with the bf16 and
    once with the fp8 dispatch. nccl with a card per rank, else four ranks
    on card 0 over gloo. Per rank: step ms (median of steps 3-6),
    tokens/s, peak GiB, ``moe_gmm`` launches a step, and the collectives
    of step 3 by kind and axis (``CountingDist``: forward, backward and
    the gradient reduction apart). Gates: the loss falls (the mean of the
    last 3 steps under the first 3's); every local expert of every rank
    has a nonzero gradient after step 1; on the card every rank launches
    ``moe_gmm`` once per MoE layer and step; the fp8 run's last loss
    within 5e-2 relative of bf16's (the reference's
    ``test_a2a_fp8_close_to_baseline`` bound); f32 at 2 layers, TF32 off,
    FSDP on, and again with ``ring_attn``: the loss within 1e-4 relative
    of the single-device port's, every gathered gradient within 1e-3 of
    its leaf's largest magnitude; the same for jamba-v0.1-52b at 1 layer (a
    Mamba layer, d_inner and the sequence over model, and a dense FFN), 8
    x 128 tokens, whose Mamba gradients need ``Dist.psum_for_shards``, for
    rwkv6-1.6b at 2 layers and for seamless-m4t-medium at 2 + 2 (its
    frames from ``serve.frames``), both 8 x 128.
    `device` and `cut` (job keys) are for a rehearsal on the CPU at a
    reduced size."""
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.serve import job_config
    from repro_torch.sharding import counting
    n_cards = torch.cuda.device_count() if device == "cuda" else 0
    n_ranks = math.prod(SHARDED_MESH)
    transport = "nccl" if n_cards >= n_ranks else "gloo"
    base = dict(arch="olmoe-1b-7b", batch=8, seq=512, steps=6, lr=1e-3, seed=SEED,
                layers=TRAIN_SHARDED_LAYERS, count_step=2)
    base.update(cut)
    gate = dict(base, layers=2, config=dict(base.get("config", {}), dtype="float32"))
    if "layers" in cut:
        gate["layers"] = cut["layers"]
    # jamba at 1 layer (a Mamba layer and a dense FFN, full width) holds the
    # sharded Mamba's backward: 8 x 128 tokens, one scan chunk (the
    # single-device reference keeps its doubling scan's activations)
    jamba = dict(arch="jamba-v0.1-52b", batch=8, seq=128, seed=SEED, layers=1,
                 config=dict(cut.get("config", {}), dtype="float32"))
    jamba.update({k: cut[k] for k in ("reduced", "batch", "seq") if k in cut})
    # rwkv6 at 2 layers (the WKV heads and d_ff over model) and seamless at
    # 2 + 2 (the encoder on the sequence-sharded frames, head-TP self- and
    # cross-attention), full width, 8 x 128 tokens
    rwkv = dict(jamba, arch="rwkv6-1.6b", layers=2)
    seamless = dict(jamba, arch="seamless-m4t-medium", layers=2,
                    config=dict(jamba["config"], encoder_layers=2))
    jobs = {"bf16": base, "fp8": dict(base, a2a_fp8=True)}
    gates = {"f32_fsdp": gate, "f32_fsdp_ring": dict(gate, ring_attn=True),
             "f32_fsdp_jamba": jamba, "f32_fsdp_rwkv": rwkv,
             "f32_fsdp_seamless": seamless}
    log("train_sharded.transport", transport=transport, cards=n_cards, ranks=n_ranks,
        nvidia_smi=smi)
    t0 = time.perf_counter()
    ranks = launch_train.serve.spawn(train_sharded_rank, (jobs, gates),
                                     mesh_shape=SHARDED_MESH, transport=transport,
                                     device=device, wrap_dist=counting.count_collectives_by_axis,
                                     timeout=900)
    out = {"transport": transport, "nvidia_smi": smi, "wall_s": time.perf_counter() - t0,
           "jobs": {}, "gates": {}}
    failures = []
    for name, job in jobs.items():
        cfg = job_config(job)
        n_moe = sum(s.ffn == "moe" for s in cfg.layer_specs)
        per_rank = []
        for r in range(n_ranks):
            res = ranks[r][name]
            step_ms = [1e3 * t for t in res["step_s"]]
            med = _median(step_ms[2:])
            row = {"rank": r, "coords": res["coords"], "transport": transport,
                   "losses": res["losses"], "step_ms": step_ms,
                   "step_ms_median_3_to_6": med,
                   "tokens_per_s": job["batch"] * job["seq"] / med * 1e3,
                   "peak_gib": res.get("peak_bytes", 0) / 2 ** 30,
                   "param_gib": res["param_bytes"] / 2 ** 30, "init_s": res["init_s"],
                   "moe_gmm_launches_per_step": res["moe_gmm_launches"],
                   "step3_part_ms": {k: 1e3 * v for k, v in res["part_s"].items()},
                   "collectives_step3": res["collectives"],
                   "silent_experts": res["silent_experts"][:8]}
            per_rank.append(row)
            log(f"train_sharded.{name}.rank", **row, nvidia_smi=smi)
            if device == "cuda" and res["moe_gmm_launches"] != [n_moe] * job["steps"]:
                failures.append(f"{name} rank {r}: moe_gmm launches "
                                f"{res['moe_gmm_launches']}, want {n_moe} a step")
            if res["silent_experts"]:
                failures.append(f"{name} rank {r}: no gradient reached "
                                f"{res['silent_experts'][:4]}")
        losses = per_rank[0]["losses"]
        if not all(math.isfinite(x) for x in losses) or \
                not sum(losses[-3:]) < sum(losses[:3]):
            failures.append(f"{name}: losses {losses} not finite or not falling")
        out["jobs"][name] = {"ranks": per_rank, "layers": cfg.num_layers,
                             "of_layers": 16, "dtype": cfg.dtype, "losses": losses,
                             "a2a_fp8": bool(job.get("a2a_fp8"))}
    lb, lq = out["jobs"]["bf16"]["losses"][-1], out["jobs"]["fp8"]["losses"][-1]
    out["fp8_last_loss_rel_to_bf16"] = abs(lq - lb) / abs(lb)
    if not out["fp8_last_loss_rel_to_bf16"] <= 5e-2:
        failures.append(f"fp8 dispatch: last loss {lq} against bf16's {lb} "
                        "(gate 5e-2 relative)")
    for name in gates:
        res = ranks[0][name]
        out["gates"][name] = res
        log(f"train_sharded.{name}", **res, gates={"loss_rel": 1e-4, "grad_over_max": 1e-3},
            nvidia_smi=smi)
        if not (res["loss_rel_err"] <= 1e-4 and res["worst_grad_err_over_max"] <= 1e-3):
            failures.append(f"{name}: loss rel {res['loss_rel_err']}, worst gradient "
                            f"{res['worst_grad_err_over_max']} at {res['worst_leaf']}")
    log("train_sharded.summary", fp8_last_loss_rel_to_bf16=out["fp8_last_loss_rel_to_bf16"],
        wall_s=out["wall_s"], transport=transport, nvidia_smi=smi)
    if failures:
        raise AssertionError("train_sharded.olmoe-1b-7b: " + "; ".join(failures))
    return out


def check_moe_gmm_grad(torch, ref, kmoe, gen):
    """Forward and backward through ``MoeGmm`` (``ops.moe_gmm`` on card
    tensors that want gradients) against autograd of ``moe_gmm_ref``: out,
    dx, dWg, dWu and dWd. olmoe's training shape (E=64, T=768: one capacity
    group of 8 x 512 tokens, ceil(4096 * 8 * 1.5 / 64)) in bf16, gated
    against the f32 truth as the forward kernel is; an odd T in f32 (the
    CUDA-core variant), within 1e-4. In both, the forward kernel, the
    plain forward and the plain backward are timed."""
    from repro_torch.kernels import ops
    results = {}
    from repro_torch.models.layers.moe import capacity
    # one rank of train_sharded: 4 x 256 tokens, 32 of the 64 experts, the
    # capacity buffers of both model ranks after the dispatch (T = ep * C)
    t_rank = 2 * capacity(4 * 256, 8, 64, 1.5)
    cases = [("train", 64, math.ceil(8 * 512 * 8 * 1.5 / 64), 2048, 1024, "bfloat16", True),
             ("train_sharded_rank", 32, t_rank, 2048, 1024, "bfloat16", True),
             ("odd_t_f32", 4, 37, 2048, 1024, "float32", True)]
    for name, e, t, d, f, dt, timed in cases:
        tdt = getattr(torch, dt)
        args = [torch.randn(s, generator=gen, device="cuda", dtype=tdt).mul_(c)
                for s, c in (((e, t, d), 0.3), ((e, d, f), d ** -0.5),
                             ((e, d, f), d ** -0.5), ((e, f, d), f ** -0.5))]
        dy = torch.randn((e, t, d), generator=gen, device="cuda", dtype=tdt)

        def fwd_bwd(fn, xs, dy_):
            leaves = [x.detach().clone().requires_grad_() for x in xs]
            y = fn(*leaves)
            return [y.detach()] + [g.detach() for g in torch.autograd.grad(y, leaves, dy_)]

        which = kmoe.variant(tdt, d, f)
        n0 = kmoe.launches
        got = fwd_bwd(ops.moe_gmm, args, dy)
        torch.cuda.synchronize()
        if kmoe.launches != n0 + 1:
            raise AssertionError(f"moe_gmm.grad {name}: {kmoe.launches - n0} "
                                 "kernel launches for one forward and backward")
        plain = fwd_bwd(ref.moe_gmm_ref, args, dy)
        truth = fwd_bwd(ref.moe_gmm_ref, [a.float() for a in args], dy.float())
        row = {"shape": [e, t, d, f], "dtype": dt, "variant": which, "outputs": {}}
        for out, g, p, tr in zip(("out", "dx", "dw_gate", "dw_up", "dw_down"),
                                 got, plain, truth):
            err, err_truth = max_err(g, p), max_err(g, tr)
            if dt == "float32":
                ok = torch.allclose(g, p, atol=1e-4, rtol=1e-4)
                rule = "f32 atol=rtol=1e-4, TF32 off"
            else:
                err_plain = max_err(p, tr)
                ok = err_truth <= 1.5 * err_plain + 1e-3
                rule = f"bf16 err vs f32 truth <= 1.5 x plain's ({err_plain:.3g}) + 1e-3"
            if not ok or not torch.isfinite(g).all():
                raise AssertionError(f"moe_gmm.grad {name} {out}: err {err_truth} "
                                     f"fails {rule}")
            row["outputs"][out] = {"max_abs_err": err, "err_vs_f32_truth": err_truth,
                                   "max_abs": float(tr.abs().max()), "rule": rule}
        row["max_abs_err"] = max(o["max_abs_err"] for o in row["outputs"].values())
        if timed:
            el = 2 if dt == "bfloat16" else 4
            flops = 6 * e * t * d * f
            if which == "tensor_core":
                row["tile_plan"] = kmoe.tile_plan(t)
            row["ms"] = time_ms(torch, lambda: kmoe.moe_gmm_cuda(*args))
            row["plain_ms"] = time_ms(torch, lambda: ref.moe_gmm_ref(*args))
            row["bound_ms"], row["bound_by"] = bound(
                el * (2 * e * t * d + 3 * e * d * f), flops, dt)
            row["library_ms"] = None
            row["tflops"] = flops / row["ms"] / 1e9
            # the plain backward (what MoeGmm's backward runs): its own work
            # is 12 E T D F (four products of 2 E T D F each for dx, three
            # for the weights; the recompute of g and u is not counted)
            row["bwd_plain_ms"] = time_ms(torch, lambda: ref.moe_gmm_bwd_ref(*args, dy), iters=11)
            row["bwd_bound_ms"], row["bwd_bound_by"] = bound(
                el * (3 * e * t * d + 6 * e * d * f), 12 * e * t * d * f, dt)
        results[name] = row
        log("kernel.moe_gmm.grad", case=name, **row)
        del args, dy, got, plain, truth
        torch.cuda.empty_cache()
    return results


def grads_of(torch, M, convert, params, batch, cfg):
    leaves = [p.requires_grad_() for p in convert.tree_leaves(params)]
    loss = M.train_loss(params, batch, cfg, remat=False)
    return loss.detach(), torch.autograd.grad(loss, leaves, materialize_grads=True)


def parity_f32_train(torch, get_arch, M, convert, arch="olmoe-1b-7b", layers=2,
                     batch=2, seq=64):
    """``train_loss`` and its gradients on the card against the port's CPU
    path on the same float32 weights: `arch` at its published widths cut
    to `layers` layers, `batch` x `seq` tokens from numpy. The loss within
    1e-4 relative; every gradient leaf within 1e-3 of that leaf's largest
    CPU magnitude."""
    import numpy as np
    full = get_arch(arch)
    cfg = full.replace(num_layers=layers, dtype="float32")
    t0 = time.perf_counter()
    p_cpu = M.init_model(cfg, device="cpu", seed=SEED)
    p_gpu = convert.tree_map(lambda t: t.to("cuda"), p_cpu)
    tokens = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (batch, seq))
    tokens = torch.from_numpy(tokens.astype(np.int32))
    l_cpu, g_cpu = grads_of(torch, M, convert, p_cpu, {"tokens": tokens}, cfg)
    l_gpu, g_gpu = grads_of(torch, M, convert, p_gpu, {"tokens": tokens.cuda()}, cfg)
    rel = abs(l_gpu.item() - l_cpu.item()) / abs(l_cpu.item())
    from repro_torch.training.checkpoint import flatten
    worst, worst_key = 0.0, None
    keys = list(flatten(p_cpu))
    for key, a, b in zip(keys, g_gpu, g_cpu):
        scale = float(b.abs().max())
        r = max_err(a.cpu(), b) / scale if scale else max_err(a.cpu(), b)
        if r > worst:
            worst, worst_key = r, key
    if not rel <= 1e-4 or not worst <= 1e-3:
        raise AssertionError(f"f32 train parity: loss rel {rel}, worst gradient "
                             f"{worst} at {worst_key} (gates 1e-4, 1e-3)")
    res = {"arch": arch, **cut_of(cfg, full), "batch": batch, "seq": seq,
           "loss_cpu": l_cpu.item(), "loss_card": l_gpu.item(), "loss_rel_err": rel,
           "worst_grad_err_over_max": worst, "worst_leaf": worst_key,
           "leaves": len(keys), "gates": {"loss_rel": 1e-4, "grad_over_max": 1e-3},
           "seconds": time.perf_counter() - t0}
    log("parity_f32.train", **res)
    del p_cpu, p_gpu, g_cpu, g_gpu
    torch.cuda.empty_cache()
    return res


def train_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step (PaLM's MFU convention): 6 N per
    token, N the parameters a token's matmuls touch (attention, router, its
    top-k experts, the LM head; not the embedding lookup), plus
    12 L H hd S per token for attention's scores and values."""
    n = cfg.active_param_count() - cfg.vocab_size * cfg.d_model
    return tokens * (6 * n + 12 * cfg.num_layers * cfg.num_heads * cfg.head_dim * seq)


def train_phase(torch, get_arch, convert, kmoe, kfd, layers, ckpt_dir="", batch=8,
                seq=512, steps=10, ckpt_every=0, arch="olmoe-1b-7b",
                tag="train.olmoe-1b-7b"):
    """The port's ``Trainer`` at `arch`'s published widths, `layers` layers,
    bf16: ``SyntheticLM`` batches of `batch` x `seq`, `steps` steps, with
    checkpoints every `ckpt_every` into `ckpt_dir` where given. Checks: finite losses,
    the last 3 steps' mean below the first 3's; after step 1 every expert
    of every MoE layer has a nonzero first moment (m = 0.1 g: the kernel's
    output carries its gradient); ``moe_gmm`` launched once per MoE layer
    and step in its tensor-core variant. Logs the median step time over
    steps 3-10 without the checkpoint saves, tokens/s, peak memory and
    ``train_mfu`` (model FLOPs per step over the step time at 989 TFLOP/s
    bf16 dense)."""
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.train_loop import TrainConfig, Trainer

    class TimedTrainer(Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.save_s = []

        def save(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().save()
            self.save_s.append(time.perf_counter() - t0)

    full = get_arch(arch)
    cfg = full.replace(num_layers=layers)
    tc = TrainConfig(lr=1e-3, log_every=0, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir,
                     seed=SEED)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=SEED))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = TimedTrainer(cfg, tc, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reset_counts(kmoe, kfd)
    step_s, saves_before = [], 0
    for i in range(steps):
        tokens = data.batch(tr.step_idx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(tokens)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0 - sum(tr.save_s[saves_before:]))
        saves_before = len(tr.save_s)
        if i == 0:
            silent = [f"stack/{li}/{name}/expert {e}"
                      for li, layer in enumerate(tr.opt_state.m["stack"])
                      if "w_gate" in layer["ffn"]
                      for name in ("w_gate", "w_up", "w_down")
                      for e in (layer["ffn"][name].flatten(1).abs().amax(1) == 0)
                      .nonzero().flatten().tolist()]
            if silent:
                raise AssertionError(f"train: no gradient reached {silent[:8]} "
                                     f"({len(silent)} expert weights)")
    launches = read_counts(kmoe, kfd)
    variants = dict(kmoe.variant_launches)
    n_moe = kernel_layers(cfg)["moe_gmm"]
    losses = tr.losses
    # with remat each MoE layer's forward, and so its kernel, runs twice
    want = n_moe * steps * (2 if tc.remat else 1)
    if launches != {"moe_gmm": want, "flash_decode": 0} or \
            variants["tensor_core"] != want:
        raise AssertionError(f"train: launches {launches} ({variants}), want "
                             f"moe_gmm {want} in the tensor-core variant")
    if not all(math.isfinite(x) for x in losses) or \
            not sum(losses[-3:]) < sum(losses[:3]):
        raise AssertionError(f"train: losses {losses} not finite or not falling")
    step_ms = 1e3 * _median(step_s[2:])
    flops = train_flops(cfg, batch * seq, seq)
    res = {"arch": arch, **cut_of(cfg, full), "params": n_params(tr.params),
           "dtype": cfg.dtype, "batch": batch, "seq": seq, "steps": steps,
           "lr": tc.lr, "init_s": init_s, "losses": losses,
           "step_ms": [1e3 * s for s in step_s], "step_ms_median_3_to_10": step_ms,
           "tokens_per_s": batch * seq / step_ms * 1e3,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "model_tflop_per_step": flops / 1e12,
           "train_mfu": flops / (step_ms / 1e3) / PEAK_OPS["bfloat16"],
           "ckpt_save_s": tr.save_s,
           "ckpt_steps": list(range(ckpt_every, steps + 1, ckpt_every)) if ckpt_every else [],
           "launches": launches, "moe_gmm_variant_launches": variants,
           "expert_weights_with_gradient_step1": 3 * n_moe * cfg.moe.num_experts,
           "deterministic_algorithms": torch.are_deterministic_algorithms_enabled()}
    log(tag, **res)
    return res, tr


def resume_phase(torch, convert, tr, data_cfg, at=4):
    """A fresh ``Trainer`` of `tr`'s config restores step `at` from `tr`'s
    checkpoints and trains, saving none, to `tr`'s last step; its params,
    moments and losses must equal `tr`'s bit for bit. Both runs need
    deterministic algorithms: without them the embedding's backward and the
    backward of the combine's gather accumulate repeated indices with
    atomics (and the dispatch's ``index_add_`` adds with them), in an order
    that changes from run to run."""
    import dataclasses
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.train_loop import Trainer
    want = [t.detach().cpu() for t in convert.tree_leaves(
        {"params": tr.params, "m": tr.opt_state.m, "v": tr.opt_state.v})]
    losses, n, cfg, tc = list(tr.losses), tr.step_idx, tr.cfg, tr.tc
    tr.params = tr.opt_state = None
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tr2 = Trainer(cfg, dataclasses.replace(tc, ckpt_every=0), device="cuda")
    got_at = tr2.restore(at)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    tr2.run(SyntheticLM(data_cfg), n, log=lambda s: None)
    got = [t.detach().cpu() for t in convert.tree_leaves(
        {"params": tr2.params, "m": tr2.opt_state.m, "v": tr2.opt_state.v})]
    differ = sum(not torch.equal(a, b) for a, b in zip(got, want))
    if got_at != at or differ or tr2.losses != losses[at:]:
        raise AssertionError(f"train.resume: restored {got_at}; {differ} of "
                             f"{len(want)} leaves differ; losses {tr2.losses} "
                             f"against {losses[at:]}")
    res = {"arch": cfg.name, "layers": cfg.num_layers, "restored_step": got_at,
           "to_step": n, "leaves": len(want),
           "bitwise_equal": True, "losses": tr2.losses, "restore_s": restore_s,
           "deterministic_algorithms": torch.are_deterministic_algorithms_enabled()}
    log("train.resume", **res)
    return res, tr2


def profile_train_step(torch, tr, data_cfg, tag="profile.train"):
    """Device time by kernel over one more training step of `tr`, against
    the step's unprofiled wall time (the next step's): the device's idle
    share of a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.training.data import SyntheticLM
    data = SyntheticLM(data_cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train_step(data.batch(tr.step_idx))
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.train_step(data.batch(tr.step_idx))
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        rows.append((dev_us / 1e3, evt.count, evt.key[:90]))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    span, kbusy, n = call_times(prof, *KERNEL_NAMES["moe_gmm"])
    # every kernel by kind, first match wins: the port's kernel, cuBLAS's
    # products, the slot assignment's cumulative sum, the backward of
    # gathers (embedding, combine), and all other elementwise and copy work
    kinds = {"moe_gmm": ("moe_gmm",), "cublas": ("nvjet", "gemm", "cutlass", "sm90_"),
             "cumsum": ("scan",), "index_backward": ("indexing_backward", "index_put"),
             "elementwise_and_copies": ("",)}
    by_kind = dict.fromkeys(kinds, 0.0)
    for ms, _, key in rows:
        by_kind[next(k for k, pats in kinds.items() if any(q in key for q in pats))] += ms
    res = {"step_ms_unprofiled": wall_ms, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall_ms, "kernels": sum(r[1] for r in rows),
           "device_ms_by_kind": by_kind,
           "moe_gmm": {"span_ms": span, "kernels_busy_ms": kbusy, "calls": n},
           "top": [{"ms": r[0], "calls": r[1], "kernel": r[2]} for r in rows[:16]]}
    log(tag, **res)
    return res


def recovery_phase(torch, get_arch, ckpt_dir, layers, batch=8, seq=512, steps=10,
                   arch="olmoe-1b-7b"):
    """``run_with_recovery`` with failures injected before steps 3 and 7 and
    checkpoints every 4 steps: 2 restarts (to steps 0 and 4), 10 steps
    completed, at `arch`'s published widths cut to `layers` layers."""
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.fault_tolerance import FailureInjector, run_with_recovery
    from repro_torch.training.train_loop import TrainConfig, Trainer
    full = get_arch(arch)
    cfg = full.replace(num_layers=layers)
    tr = Trainer(cfg, TrainConfig(lr=1e-3, log_every=0, ckpt_every=4,
                                  ckpt_dir=ckpt_dir, seed=SEED), device="cuda")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=SEED))
    inj = FailureInjector(fail_at=[3, 7])
    t0 = time.perf_counter()
    rep = run_with_recovery(tr, data, steps, injector=inj)
    torch.cuda.synchronize()
    if rep.restarts != 2 or rep.completed_steps != steps or inj.fired != [3, 7] \
            or not all(math.isfinite(x) for x in rep.losses):
        raise AssertionError(f"train.recovery: {rep}")
    res = {"arch": arch, **cut_of(cfg, full), "batch": batch, "seq": seq,
           "restarts": rep.restarts, "completed_steps": rep.completed_steps,
           "steps_run": len(rep.losses), "recovery_log": rep.recovery_log,
           "seconds": time.perf_counter() - t0}
    log("train.recovery", **res)
    return res


# ---------------------------------------------------------------------------
# the cost model's grid engine and the dry run
# ---------------------------------------------------------------------------

# the product grid of benchmarks/fig_product_grid.py: deepseek-v3 at TP 2,
# 2 sizes x 3 XPU generations x 4 topologies x 8 link-bandwidth multiples,
# 8 TPOT SLOs x 8 contexts, 84 batch sizes: 1,032,192 TPOT cells
GRID_SIZES = (64, 256)
GRID_BW_MULTS = tuple(float(2.0 ** e) for e in range(-2, 6))
GRID_TPOTS_MS = (5.0, 10.0, 15.0, 25.0, 40.0, 60.0, 100.0, 150.0)
GRID_CONTEXTS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)
GRID_TP = 2
GRID_BLOCK = 8         # clusters in the block the card is held to the CPU on
GRID_RTOL = 1e-6       # the JAX engine's bar against the NumPy one


def sweep_grid_phase(torch, smi, device="cuda", layers=None):
    """``sweep.torch_grid``: the product grid of
    ``benchmarks/fig_product_grid.py`` (>= 10^6 TPOT cells), built from the
    port's copies of the cost model, evaluated by ``TorchGridEngine`` in
    float64 on the card: the engines' lowering, the first call and the
    steady state (median of three), and the cells per second. TPOT must not
    rise with link bandwidth along any fiber (the benchmark's sanity
    claim). Gates: on one block of ``GRID_BLOCK`` clusters (size 64, H100)
    the card's grid equals the engine's CPU path within ``GRID_RTOL``
    relative, without and with DBO, and on a Zipf-skewed scenario beside a
    uniform one (``op_load_factors``), also with DBO; the CPU path's seconds
    are logged beside the card's. `device` and `layers` are for the
    rehearsal on the CPU (``tests/test_torch_chip_sweep.py``)."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.core import optable, sweep_torch
    from repro_torch.core.hardware import BLACKWELL, H100, RUBIN
    from repro_torch.core.scenario import Scenario
    from repro_torch.core.topology import TOPOLOGIES, make_cluster

    cfg = get_arch("deepseek-v3")
    if layers:
        cfg = cfg.replace(num_layers=layers)
    scs = [Scenario(t, c) for t in GRID_TPOTS_MS for c in GRID_CONTEXTS]
    batches = np.unique(np.round(np.geomspace(1, 32768, 96)).astype(np.int64))
    half = np.maximum(batches // 2, 1)
    t0 = time.perf_counter()
    grids = {n: (optable.op_table(cfg, GRID_TP, max(n // GRID_TP, 1), n, "fp8", pp=1),
                 [make_cluster(topo, n, xpu, link_bw_mult=m) for xpu in (H100, BLACKWELL, RUBIN)
                  for topo in TOPOLOGIES for m in GRID_BW_MULTS])
             for n in GRID_SIZES}
    tables_s = time.perf_counter() - t0
    n_cells = sum(len(cl) for _, cl in grids.values()) * len(scs) * len(batches)
    if n_cells < 10 ** 6:
        raise AssertionError(f"sweep: the grid has {n_cells} cells, under 10^6")

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    engines = {n: sweep_torch.TorchGridEngine(tab, cls, scs, batches, half, device=device)
               for n, (tab, cls) in grids.items()}
    sync()
    lower_s = time.perf_counter() - t0

    def evaluate():
        t = time.perf_counter()
        out = {n: e.tpot() for n, e in engines.items()}
        return out, time.perf_counter() - t

    tpot, first_s = evaluate()
    steady = [evaluate()[1] for _ in range(3)]
    steady_s = _median(steady)
    monotone = all(
        bool(np.all(np.diff(tpot[n].reshape(3, len(TOPOLOGIES), len(GRID_BW_MULTS), len(scs),
                                            len(batches)), axis=2) <= 1e-12))
        for n in GRID_SIZES)
    res = {"arch": cfg.name, "layers": cfg.num_layers, "tp": GRID_TP, "cells": n_cells,
           "clusters": {n: len(cl) for n, (_, cl) in grids.items()},
           "scenarios": len(scs), "batches": len(batches), "device": device,
           "tables_s": tables_s, "lower_s": lower_s, "first_call_s": first_s,
           "steady_s": steady_s, "steady_runs_s": steady,
           "cells_per_s": n_cells / steady_s, "tpot_monotone_in_link_bw": monotone,
           "nvidia_smi": smi}
    log("sweep.grid", **res)

    # the card against the engine's CPU path on one block
    tab, cls = grids[GRID_SIZES[0]]
    block = cls[:GRID_BLOCK]
    zipf = [Scenario(40.0, 4096, routing="zipf", zipf_s=1.0), Scenario(40.0, 4096)]
    load = sweep_torch.op_load_factors(tab, cfg, zipf)
    if load is None:
        raise AssertionError("sweep: the Zipf scenario gave no load factors")
    gates, failures = {}, []
    for name, grid_scs, grid_load in (("uniform", scs, None), ("zipf", zipf, load)):
        for dbo in (False, True):
            runs = []
            for dev in (device, "cpu"):
                t = time.perf_counter()
                eng = sweep_torch.TorchGridEngine(tab, block, grid_scs, batches, half,
                                                  load=grid_load, device=dev)
                runs.append((eng.tpot(dbo=dbo), time.perf_counter() - t))
            (card, card_s), (cpu, cpu_s) = runs
            rel = float(np.max(np.abs(card - cpu) / np.abs(cpu)))
            key = f"{name}{'_dbo' if dbo else ''}"
            gates[key] = {"max_rel": rel, "card_s": card_s, "cpu_s": cpu_s,
                          "cells": int(cpu.size)}
            log(f"sweep.block.{key}", **gates[key], rtol=GRID_RTOL, nvidia_smi=smi)
            if not rel <= GRID_RTOL:
                failures.append(f"{key}: card and CPU differ by {rel} relative")
    res["block_gates"] = gates
    if not monotone:
        failures.append("TPOT rises with link bandwidth along some fiber")
    if failures:
        raise AssertionError("sweep.torch_grid: " + "; ".join(failures))
    return res


COST_TOPOLOGIES = ("scale-up", "scale-out", "torus", "fullmesh")
COST_LEVELS = ("noopt", "dbo+sd")
COST_XPUS = 64
COST_RTOL = 1e-9       # floats of two operating points; the rest exactly
PAPER_GAIN_PCT = (20.6, 56.2)   # switchless over scale-up (paper Fig 14/15)


def fields_equal(got, want, path, failures, rtol=COST_RTOL):
    """Append to `failures` every field where two results differ: dataclasses
    through ``asdict``, integers, flags and strings exactly, floats within
    `rtol` relative."""
    import dataclasses

    if dataclasses.is_dataclass(want):
        if not dataclasses.is_dataclass(got):
            failures.append(f"{path}: {got!r} against {want!r}")
            return
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            failures.append(f"{path}: keys differ")
            return
        for k in want:
            fields_equal(got[k], want[k], f"{path}.{k}", failures, rtol)
    elif isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            failures.append(f"{path}: lengths differ")
            return
        for i, (g, w) in enumerate(zip(got, want)):
            fields_equal(g, w, f"{path}[{i}]", failures, rtol)
    elif isinstance(want, float) and not isinstance(got, bool):
        same = (got == want or (math.isfinite(want) and want != 0.0
                                and abs(got - want) <= rtol * abs(want)))
        if not same:
            failures.append(f"{path}: {got!r} against {want!r}")
    elif type(got) is not type(want) or got != want:
        failures.append(f"{path}: {got!r} against {want!r}")


def cost_solve_phase(torch, smi, device="cuda", layers=None, sizes=(64, 256),
                     quickstart=True):
    """``cost.solve``: the paper's topology comparison through the port's
    search (``benchmarks/fig14_topology.py``'s grid: deepseek-v3, 64 H100s,
    ``COST_TOPOLOGIES`` x the six ``SCENARIOS`` x ``COST_LEVELS``), with the
    torch backend on the card: ``api.solve_levels`` timed on its first and
    steady calls, then the same call with ``backend="numpy"``, and every
    operating point held field by field to NumPy's (``fields_equal``).
    Logs tokens/s per XPU and per cost unit (``tco.cluster_tco``) per
    topology and scenario, and the gain of torus and full-mesh over
    scale-up in throughput per cost beside the paper's band (logged, not
    gated). Then ``pareto.sweep_networks`` at Scenario(40, 512) on `sizes`
    and its frontier, held to NumPy the same way, and
    ``examples/quickstart_torch.py`` on `device` in a subprocess (exit 0
    and ``quickstart OK``). `device`, `layers`, `sizes` and `quickstart`
    are for the rehearsal on the CPU (``tests/test_torch_chip_cost.py``)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import api, pareto, sweep
    from repro_torch.core.hardware import H100
    from repro_torch.core.optimizer import SCENARIOS
    from repro_torch.core.scenario import Scenario
    from repro_torch.core.tco import cluster_tco
    from repro_torch.core.topology import make_cluster

    cfg = get_arch("deepseek-v3")
    if layers:
        cfg = cfg.replace(num_layers=layers)
    n = COST_XPUS
    clusters = [make_cluster(t, n, H100) for t in COST_TOPOLOGIES]
    prev_device = sweep.set_default_device(device)
    failures = []
    try:
        def levels(backend):
            t = time.perf_counter()
            out = api.solve_levels(cfg, clusters, SCENARIOS, COST_LEVELS,
                                   api.SearchSpec(backend=backend))
            return out, time.perf_counter() - t   # the grids come back as NumPy

        card, first_s = levels("torch")
        steady = [levels("torch")[1] for _ in range(2)]
        ref, numpy_s = levels("numpy")
        fields_equal([[[s.point for s in row] for row in card[lv]] for lv in COST_LEVELS],
                     [[[s.point for s in row] for row in ref[lv]] for lv in COST_LEVELS],
                     "solve_levels", failures)

        cost = {t: cluster_tco(cl).per_xpu(n) for t, cl in zip(COST_TOPOLOGIES, clusters)}
        table, gains = {}, {"torus": [], "fullmesh": [], "best_switchless": []}
        for si, sc in enumerate(SCENARIOS):
            row = {}
            for ti, topo in enumerate(COST_TOPOLOGIES):
                row[topo] = {"cost_per_xpu": cost[topo]}
                for lv in COST_LEVELS:
                    op = card[lv][ti][si].point
                    thpt = op.throughput / n if op else 0.0
                    row[topo][lv] = {"tok_s_per_xpu": thpt,
                                     "tok_s_per_cost": thpt / cost[topo],
                                     "batch": op.batch if op else 0,
                                     "tpot_ms": op.tpot * 1e3 if op else None}
                log("cost.solve.point", scenario=sc.name, topology=topo,
                    **{f"{lv}_{k}": v for lv in COST_LEVELS for k, v in row[topo][lv].items()},
                    cost_per_xpu=cost[topo])
            su = row["scale-up"]["dbo+sd"]["tok_s_per_cost"]
            for topo in ("torus", "fullmesh"):
                gains[topo].append((row[topo]["dbo+sd"]["tok_s_per_cost"] / su - 1) * 100)
            gains["best_switchless"].append(max(gains["torus"][-1], gains["fullmesh"][-1]))
            table[sc.name] = row
        band = {k: [min(v), max(v)] for k, v in gains.items()}
        log("cost.solve.switchless_gain", level="dbo+sd", per_scenario_pct=gains,
            band_pct=band, paper_band_pct=list(PAPER_GAIN_PCT),
            within_paper_band=PAPER_GAIN_PCT[0] <= band["best_switchless"][0]
            and band["best_switchless"][1] <= PAPER_GAIN_PCT[1])

        def networks(backend):
            prev = sweep.set_default_backend(backend)
            try:
                t = time.perf_counter()
                pts = pareto.sweep_networks(cfg, Scenario(40.0, 512), H100, sizes=sizes)
                return pts, time.perf_counter() - t
            finally:
                sweep.set_default_backend(prev)

        pts, pareto_card_s = networks("torch")
        pts_np, pareto_numpy_s = networks("numpy")
        fields_equal(pts, pts_np, "sweep_networks", failures)
        front = pareto.pareto_frontier(pts)
        fields_equal(front, pareto.pareto_frontier(pts_np), "pareto_frontier", failures)
        pareto_res = {
            "sizes": list(sizes), "points": len(pts), "frontier": [
                {"topology": p.topology, "n_xpus": p.n_xpus, "link_bw": p.link_bw,
                 "cost_per_xpu": p.cost_per_xpu, "tok_s_per_xpu": p.throughput_per_xpu}
                for p in front],
            "fullmesh_on_frontier": any(p.topology == "fullmesh" for p in front),
            "card_s": pareto_card_s, "numpy_s": pareto_numpy_s}
        log("cost.solve.pareto", **pareto_res, nvidia_smi=smi)
    finally:
        sweep.set_default_device(prev_device)

    res = {"arch": cfg.name, "layers": cfg.num_layers, "of_layers": get_arch(cfg.name).num_layers,
           "xpus": n, "topologies": list(COST_TOPOLOGIES), "levels": list(COST_LEVELS),
           "scenarios": [sc.name for sc in SCENARIOS], "device": device,
           "points": len(COST_LEVELS) * len(clusters) * len(SCENARIOS),
           "first_s": first_s, "steady_s": _median(steady), "steady_runs_s": steady,
           "numpy_s": numpy_s, "equal_to_numpy": not failures, "rtol": COST_RTOL,
           "table": table, "switchless_gain_band_pct": band, "pareto": pareto_res,
           "nvidia_smi": smi}
    log("cost.solve", **{k: v for k, v in res.items() if k not in ("table", "pareto")})
    if quickstart:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t = time.perf_counter()
        r = subprocess.run([sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
                            "--device", device], env=env, capture_output=True, text=True,
                           timeout=300)
        ok = r.returncode == 0 and r.stdout.rstrip().endswith("quickstart OK")
        res["quickstart"] = {"rc": r.returncode, "ok": ok, "wall_s": time.perf_counter() - t,
                             "stdout_tail": r.stdout[-1500:]}
        log("cost.solve.quickstart", **{k: v for k, v in res["quickstart"].items()
                                        if k != "stdout_tail"})
        if not ok:
            failures.append(f"quickstart_torch.py: exit {r.returncode}, "
                            f"stderr {r.stderr[-1500:]!r}")
    if failures:
        raise AssertionError(f"cost.solve: {len(failures)} differences: "
                             + "; ".join(failures[:10]))
    return res


DRYRUN_ARCHS = ("olmoe-1b-7b", "jamba-v0.1-52b")


def _dryrun_worker(queue, cut):
    """The dry runs of ``dryrun_phase``, in a process of their own (the
    fake process group must not meet this one): the prefill and the decode
    step of ``sharded.olmoe-1b-7b``'s bf16 job on its 2x2 mesh, then
    ``run_cell`` of ``DRYRUN_ARCHS`` at decode_32k on the 16x16 mesh."""
    import traceback
    try:
        from repro_torch.configs.base import ShapeCell
        from repro_torch.launch.dryrun import dry_run, run_cell
        from repro_torch.launch.serve import job_config, mesh_axes
        job = sharded_jobs("olmoe-1b-7b", **cut)["bf16"]
        cfg = job_config(job)
        b, p, s = job["batch"], job["prompt_len"], job["max_seq"]
        axes = mesh_axes(SHARDED_MESH)
        out = {"prefill": dry_run(cfg, ShapeCell("p", p, b, "prefill"), SHARDED_MESH, axes),
               "decode": dry_run(cfg, ShapeCell("d", s, b, "decode"), SHARDED_MESH, axes),
               "production": {a: run_cell(a, "decode_32k") for a in DRYRUN_ARCHS}}
        queue.put(("ok", out))
    except BaseException:
        queue.put(("error", traceback.format_exc()))
        raise


def _kinds(rec: dict) -> dict:
    """{kind: {"bytes", "calls"}} of a dry-run record's collectives."""
    c = rec["collectives"]
    return {k[:-len("_bytes")]: {"bytes": v, "calls": c[k[:-len("_bytes")] + "_count"]}
            for k, v in c.items() if k.endswith("_bytes") and k != "total_bytes"}


def dryrun_phase(torch, smi, row, **cut):
    """``dryrun``: ``launch.dryrun`` in a spawned process of its own. The
    cell ``sharded.olmoe-1b-7b`` served (its bf16 job: 2x2 mesh, 8 prompts
    of 64, max_seq 512, all 16 layers), traced as one rank on a fake process
    group with fake tensors on the card, its prefill and its decode step.
    Gates: per kind, the collective bytes and calls of each equal what the
    serving phase's ``CountingDist`` counted on rank 0 in this run (`row`:
    the prefill, and a decode step); the decode's parameter and cache
    argument bytes equal that rank's. Then ``run_cell`` for olmoe-1b-7b and
    jamba-v0.1-52b at decode_32k on the 16x16 production mesh, each
    roofline row on the H100 (three terms, the bottleneck, the useful-FLOPs
    ratio) with its trace seconds. `cut` (job keys) is for a rehearsal on
    the CPU."""
    import multiprocessing as mp

    from repro_torch.analysis import roofline
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=_dryrun_worker, args=(queue, cut), daemon=True)
    t0 = time.perf_counter()
    proc.start()
    try:
        status, value = queue.get(timeout=900)
    finally:
        proc.join(60)
        if proc.is_alive():
            proc.terminate()
            proc.join(5)
    if status != "ok":
        raise RuntimeError(f"dryrun: the dry-run process failed:\n{value}")
    wall_s = time.perf_counter() - t0
    counted = {"prefill": row["collective_prefill"],
               "decode": {k: {"bytes": row["collective_bytes_per_step"][k],
                              "calls": row["collective_calls_per_step"][k]}
                          for k in row["collective_bytes_per_step"]}}
    failures, res = [], {"wall_s": wall_s, "nvidia_smi": smi, "cells": {}}
    for kind in ("prefill", "decode"):
        rec, want = value[kind], counted[kind]
        got = _kinds(rec)
        if got != want:
            failures.append(f"{kind}: the trace counts {got}, the card counted {want}")
        res["cells"][kind] = {k: rec[k] for k in (
            "mesh", "n_devices", "plan", "trace_s", "flops", "flops_by_op", "bytes_accessed",
            "bytes_by_op", "mem_argument_size_in_bytes", "mem_argument_parts",
            "mem_output_size_in_bytes", "mem_temp_size_in_bytes", "collectives")}
        log(f"dryrun.{kind}", traced=got, counted_on_card=want, trace_s=rec["trace_s"],
            flops=rec["flops"], bytes_accessed=rec["bytes_accessed"],
            mem_argument_parts=rec["mem_argument_parts"],
            mem_temp_size_in_bytes=rec["mem_temp_size_in_bytes"])
    parts = value["decode"]["mem_argument_parts"]
    mem = {"params": [parts["params"], row["param_bytes"]],
           "caches": [parts["caches"], row["cache_bytes"]]}
    log("dryrun.decode_arguments", traced_vs_card=mem)
    if any(a != b for a, b in mem.values()):
        failures.append(f"decode argument bytes (traced, card): {mem}")
    res["production"] = {}
    for arch, rec in value["production"].items():
        if rec.get("status") != "ok":
            failures.append(f"{arch} decode_32k: {rec.get('status')} {rec.get('error')}")
            continue
        r = roofline.from_dryrun(rec)
        row_out = {"compute_s": r.compute_s, "memory_s": r.memory_s,
                   "collective_s": r.collective_s, "bottleneck": r.bottleneck,
                   "step_time_s": r.step_time_s, "useful_flops_ratio": r.useful_flops_ratio,
                   "roofline_fraction": r.roofline_fraction, "trace_s": rec["trace_s"],
                   "flops": rec["flops"], "bytes_accessed": rec["bytes_accessed"],
                   "bytes_by_op": rec["bytes_by_op"],
                   "collective_bytes": rec["collectives"]["total_bytes"],
                   "mem_argument_size_in_bytes": rec["mem_argument_size_in_bytes"],
                   "mesh": rec["mesh"], "what_would_help": roofline.what_would_help(r)}
        res["production"][arch] = row_out
        log(f"dryrun.roofline.{arch}.decode_32k", **row_out,
            constants={"peak_flops": roofline.PEAK_FLOPS, "hbm_bw": roofline.HBM_BW,
                       "link_bw": roofline.LINK_BW}, nvidia_smi=smi)
    if failures:
        raise AssertionError("dryrun: " + "; ".join(failures))
    return res


def main() -> int:
    # cuBLAS is deterministic on one stream only with a fixed workspace; the
    # training phases run under torch.use_deterministic_algorithms, which
    # requires this before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import moe_gmm as kmoe
    from repro_torch.models import model as M
    from repro_torch.serving import dbo, kvcache, specdec
    from repro_torch.serving.engine import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi, flush=True)
    log("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi)

    walls = {}

    def phase(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        walls[name] = time.perf_counter() - t0
        log("phase.wall", name=name, wall_s=walls[name])
        return out

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    secs = build.build_all()
    log("build", seconds_each=secs, wall_s=time.perf_counter() - t0,
        already_built=[n for n in build.KERNELS if n not in secs])
    attrs = {n: build.kernel_attributes(n) for n in build.KERNELS}
    for n, kernels in attrs.items():
        log("build.registers", library=n, kernels=kernels)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if sys.argv[1:2] == ["--sharded-only"]:
        # the phases across ranks and their kernel alone, or the sharded
        # serving archs and "train_sharded" named after the flag: with four
        # or more cards the ranks take nccl, one rank a card
        only = sys.argv[2:] or [*SHARDED_ARCHS, "train_sharded"]
        unknown = set(only) - set(SHARDED_ARCHS) - {"train_sharded"}
        if unknown:
            print(f"chip_smoke: unknown phases {sorted(unknown)}", file=sys.stderr)
            return 2
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        phase("kernel.flash_decode_lse", check_flash_decode_lse, torch, ref, kfd, gen)
        sharded = {a: phase(f"sharded.{a}", sharded_phase, torch, M, kvcache, smi, arch=a,
                            timed=a == "deepseek-v3" and torch.cuda.device_count() >= 4)
                   for a in SHARDED_ARCHS if a in only}
        dry = (phase("dryrun", dryrun_phase, torch, smi,
                     sharded["olmoe-1b-7b"]["jobs"]["bf16"]["ranks"][0])
               if "olmoe-1b-7b" in sharded else None)
        tsh = (phase("train_sharded.olmoe-1b-7b", train_sharded_phase, torch, smi)
               if "train_sharded" in only else None)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_sharded.json").write_text(json.dumps(
            {"nvidia_smi": smi, "sharded": sharded, "train_sharded": tsh, "dryrun": dry,
             "phase_wall_s": walls}, indent=1, default=str))
        print(json.dumps({"sharded": {a: {j: {k: v for k, v in r.items() if k != "ranks"}
                                          for j, r in res["jobs"].items()}
                                      for a, res in sharded.items()},
                          "dbo": {a: {j: {k: v for k, v in sub.items() if k != "wall_ms"}
                                      for j, sub in res.get("dbo", {}).items()}
                                  for a, res in sharded.items()},
                          "train_sharded": tsh and {"gates": tsh["gates"],
                                                    "fp8_last_loss_rel_to_bf16":
                                                    tsh["fp8_last_loss_rel_to_bf16"]}},
                         default=str))
        print(json.dumps({"ok": True, "device": device}))
        return 0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    moe = phase("kernel.moe_gmm", check_moe_gmm, torch, ref, kmoe, gen)
    fd = phase("kernel.flash_decode", check_flash_decode, torch, F, ref, kfd, gen)
    fd_lse = phase("kernel.flash_decode_lse", check_flash_decode_lse, torch, ref, kfd, gen)
    grad = phase("kernel.moe_gmm.grad", check_moe_gmm_grad, torch, ref, kmoe, gen)
    # the cost model's product grid on the card, held to the engine's CPU path
    grid = phase("sweep.torch_grid", sweep_grid_phase, torch, smi)
    # the paper's topology comparison through the port's search, held to NumPy
    cost = phase("cost.solve", cost_solve_phase, torch, smi)
    free()
    parity = {"olmoe-1b-7b": phase("parity_f32", parity_f32, torch, get_arch, M,
                                   kvcache, convert)}
    free()
    parity_train = phase("parity_f32.train", parity_f32_train, torch, get_arch, M,
                         convert)
    free()
    torch.backends.cuda.matmul.allow_tf32 = False

    # olmoe-1b-7b: the main path, its profile, DBO and SD on its weights
    main_res, eng, prompts = phase("main_path", main_path, torch, get_arch, M,
                                   Engine, kmoe, kfd)
    prof = phase("profile", profile_waves, torch, eng, prompts,
                 main_res["decode_ms_per_wave_median"])
    params, cfg = eng.params, eng.cfg
    del eng
    free()
    dbo_res = phase("dbo", dbo_phase, torch, M, kvcache, convert, dbo, kmoe, kfd,
                    cfg, params)
    sd = {"olmoe-1b-7b": phase("specdec.olmoe-1b-7b", specdec_phase, torch, M,
                               kvcache, convert, specdec, kmoe, kfd, cfg, params,
                               batch=4, prompt_len=32, seq=96)}
    del params
    free()

    # sharded serving on a 2x2 mesh through launch/serve: full olmoe-1b-7b;
    # the paper's deepseek-v3 at 1 of 61 layers (experts over data in
    # decode); jamba-v0.1-52b at one period, 8 of 32 layers (d_inner over
    # model)
    sharded = {a: phase(f"sharded.{a}", sharded_phase, torch, M, kvcache, smi, arch=a)
               for a in SHARDED_ARCHS}
    free()
    # the dry run of the cell sharded.olmoe-1b-7b served, held to its counts
    dry = phase("dryrun", dryrun_phase, torch, smi,
                sharded["olmoe-1b-7b"]["jobs"]["bf16"]["ranks"][0])
    # training across ranks: olmoe-1b-7b at 4 of 16 layers through
    # launch/train, and the f32 gates (jamba's among them)
    train_sharded = phase("train_sharded.olmoe-1b-7b", train_sharded_phase, torch, smi)
    free()

    # the other configurations through the engine, each with its own profile
    others, profiles = {}, {"olmoe-1b-7b": prof}
    paths = {"starcoder2-3b": dict(n_requests=12, new_tokens=16),
             "granite-moe-3b-a800m": dict(n_requests=12, new_tokens=16),
             # one request from position 1000 to past 1024: the rings wrap
             "gemma3-1b": dict(lens=[1000] + list(range(24, 129, 8))[:11],
                               new_tokens=40, max_seq=1152)}
    for arch, kw in paths.items():
        res, eng, prompts = phase(f"main_path.{arch}", main_path, torch, get_arch,
                                  M, Engine, kmoe, kfd, arch=arch, **kw)
        profiles[arch] = phase(f"profile.{arch}", profile_waves, torch, eng,
                               prompts, res["decode_ms_per_wave_median"],
                               tag=f"profile.{arch}")
        others[arch] = res
        if arch == "gemma3-1b":
            if res["max_decode_pos"] < 1024:
                raise AssertionError("gemma3-1b: no request wrapped the ring")
            sd["gemma3-1b"] = phase(
                "specdec.gemma3-1b", specdec_phase, torch, M, kvcache, convert,
                specdec, kmoe, kfd, eng.cfg, eng.params, batch=1,
                prompt_len=1012, seq=1100)
        del eng
        free()
    # one full period of gemma3-1b (5 ring layers and a global one), f32,
    # a prompt past the window
    parity["gemma3-1b"] = phase("parity_f32.gemma3-1b", parity_f32, torch,
                                get_arch, M, kvcache, convert, arch="gemma3-1b",
                                layers=6, lens=(16, 1030, 300), seq=1100, steps=4)
    free()

    # the paper's workload: deepseek-v3 at full width, 2 of 61 layers (24.9 B
    # params, ~46 GiB in bf16), its profile, the share of its plain-torch
    # MLA decode, and DBO on the same weights
    ds, jb = "deepseek-v3", "jamba-v0.1-52b"
    traffic = dict(n_requests=12, new_tokens=16)
    res, eng, prompts = phase(f"main_path.{ds}", main_path, torch, get_arch, M,
                              Engine, kmoe, kfd, arch=ds, layers=2, **traffic)
    others[ds] = res
    profiles[ds] = phase(f"profile.{ds}", profile_waves, torch, eng, prompts,
                         res["decode_ms_per_wave_median"], tag=f"profile.{ds}")
    mla = phase(f"mla_share.{ds}", mla_share, torch, eng, profiles[ds], kmoe, kfd)
    dbo_ds = phase(f"dbo.{ds}", dbo_phase, torch, M, kvcache, convert, dbo, kmoe,
                   kfd, eng.cfg, eng.params, tag=f"dbo.{ds}")
    del eng
    free()

    # jamba-v0.1-52b: one period of 8 (7 Mamba layers, 1 attention; 4 MoE),
    # 13.3 B params; SD at one row rolls the SSM state back
    res, eng, prompts = phase(f"main_path.{jb}", main_path, torch, get_arch, M,
                              Engine, kmoe, kfd, arch=jb, layers=8, **traffic)
    others[jb] = res
    profiles[jb] = phase(f"profile.{jb}", profile_waves, torch, eng, prompts,
                         res["decode_ms_per_wave_median"], tag=f"profile.{jb}")
    sd[jb] = phase(f"specdec.{jb}", specdec_phase, torch, M, kvcache, convert,
                   specdec, kmoe, kfd, eng.cfg, eng.params, batch=1,
                   prompt_len=64, seq=96)
    del eng
    free()

    # f32 parity: deepseek-v3 at 2 layers with 32 of its 256 experts (top-8
    # kept, ~20 GB per side); jamba at its first 5 layers (four Mamba, two
    # MoE with 4 of 16 experts, the attention layer), prompts shorter than
    # the conv tail and past a scan chunk
    parity[ds] = phase(f"parity_f32.{ds}", parity_f32, torch, get_arch, M,
                       kvcache, convert, arch=ds, layers=2, experts=32)
    free()
    parity[jb] = phase(f"parity_f32.{jb}", parity_f32, torch, get_arch, M,
                       kvcache, convert, arch=jb, layers=5, experts=4,
                       lens=(2, 40, 130), seq=160)
    free()
    # the dense configurations at published widths: minitron-8b whole (9.9 B
    # params, LM head 4096 x 256000) and deepseek-67b cut to 40 of its 95
    # layers (~29 B params, ~55 GiB; all 95 would be ~134 GB)
    for arch, layers in (("minitron-8b", None), ("deepseek-67b", 40)):
        res, eng, prompts = phase(f"main_path.{arch}", main_path, torch, get_arch, M,
                                  Engine, kmoe, kfd, arch=arch, layers=layers, **traffic)
        others[arch] = res
        profiles[arch] = phase(f"profile.{arch}", profile_waves, torch, eng, prompts,
                               res["decode_ms_per_wave_median"], tag=f"profile.{arch}")
        del eng
        free()
    # rwkv6-1.6b whole, attention-free (no kernel of the port on its path);
    # SD at one row rolls the WKV state and both token shifts back
    rw, sm = "rwkv6-1.6b", "seamless-m4t-medium"
    res, eng, prompts = phase(f"main_path.{rw}", main_path, torch, get_arch, M,
                              Engine, kmoe, kfd, arch=rw, **traffic)
    others[rw] = res
    profiles[rw] = phase(f"profile.{rw}", profile_waves, torch, eng, prompts,
                         res["decode_ms_per_wave_median"], tag=f"profile.{rw}")
    sd[rw] = phase(f"specdec.{rw}", specdec_phase, torch, M, kvcache, convert,
                   specdec, kmoe, kfd, eng.cfg, eng.params, batch=1,
                   prompt_len=64, seq=96)
    del eng
    free()
    # seamless-m4t-medium whole (12 encoder + 12 decoder layers): a second
    # flash_decode per decoder layer, cross-attention over max_seq positions
    res, eng, prompts = phase(f"main_path.{sm}", main_path, torch, get_arch, M,
                              Engine, kmoe, kfd, arch=sm, **traffic)
    others[sm] = res
    profiles[sm] = phase(f"profile.{sm}", profile_waves, torch, eng, prompts,
                         res["decode_ms_per_wave_median"], tag=f"profile.{sm}")
    del eng
    free()
    # internvl2-76b's patch frontend, 16 of 80 layers (~16 B params); its
    # engine path is deepseek-67b's dense g = 8 path
    vl = "internvl2-76b"
    patches = phase(f"prefill_patches.{vl}", prefill_patches, torch, get_arch, M,
                    kvcache, kmoe, kfd)
    free()
    # f32 parity: rwkv6 at 2 layers, prompts past two scan chunks; seamless
    # at 2 encoder + 2 decoder layers on random frames
    parity[rw] = phase(f"parity_f32.{rw}", parity_f32, torch, get_arch, M, kvcache,
                       convert, arch=rw, layers=2, lens=(2, 40, 130), seq=160)
    free()
    parity[sm] = phase(f"parity_f32.{sm}", parity_f32, torch, get_arch, M, kvcache,
                       convert, arch=sm, layers=2)
    free()

    # training at published widths: olmoe-1b-7b cut to 8 of 16 layers
    # (3.56 B params; bf16 params and grads, f32 accumulator, m and v:
    # ~57 GB), 10 steps of 8 x 512 tokens, and one more step profiled
    from repro_torch.training.data import DataConfig
    train, tr = phase("train.olmoe-1b-7b", train_phase, torch, get_arch, convert,
                      kmoe, kfd, layers=TRAIN_LAYERS)
    data_cfg = DataConfig(vocab_size=tr.cfg.vocab_size, seq_len=512, global_batch=8,
                          seed=SEED)
    prof_train = phase("profile.train", profile_train_step, torch, tr, data_cfg)
    del tr
    free()
    # exact resume and recovery at published widths, 1 layer: a checkpoint
    # (bf16 params, f32 m and v) of 8 layers is 34 GB, and a call may write
    # 45 GiB to its disk in all; these phases write five of 6.3 GB. The
    # uninterrupted run and the resumed one run under deterministic
    # algorithms, so that they can be compared bit for bit
    torch.use_deterministic_algorithms(True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt") as tmp:
        resume_run, tr = phase("train.resume_run", train_phase, torch, get_arch, convert,
                               kmoe, kfd, layers=CKPT_LAYERS, ckpt_dir=tmp, ckpt_every=4,
                               tag="train.resume_run")
        resume, tr2 = phase("train.resume", resume_phase, torch, convert, tr, data_cfg)
        del tr, tr2
        free()
    torch.use_deterministic_algorithms(False)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt") as tmp:
        recovery = phase("train.recovery", recovery_phase, torch, get_arch, tmp,
                         layers=CKPT_LAYERS)
    free()

    floor_ms = event_floor_ms(torch)
    log("timing_floor", empty_call_ms=floor_ms)

    launches_by_path = {"main_path.olmoe-1b-7b": main_res["launches"],
                        **{f"main_path.{a}": r["launches"] for a, r in others.items()},
                        "dbo (first step)": dbo_res["launches_first_step"],
                        f"dbo.{ds} (first step)": dbo_ds["launches_first_step"],
                        f"prefill_patches.{vl} (decode)": patches["launches"],
                        "train.olmoe-1b-7b": train["launches"],
                        **{f"sharded.{a}.{j} (rank {r['rank']} decode)":
                           r["launches"]["decode"]
                           for a, res in sharded.items()
                           for j, job in res["jobs"].items() for r in job["ranks"]},
                        **{f"sharded.{a}.{j}.dbo (rank 0, a DBO step)": sub["launches_per_step"]
                           for a, res in sharded.items()
                           for j, sub in res.get("dbo", {}).items()},
                        **{f"train_sharded.olmoe-1b-7b.{j} (rank {r['rank']}, 6 steps)":
                           {"moe_gmm": sum(r["moe_gmm_launches_per_step"]),
                            "flash_decode": 0, "flash_decode_lse": 0}
                           for j, job in train_sharded["jobs"].items() for r in job["ranks"]},
                        **{f"specdec.{a}.{d}": r[d]["launches"]
                           for a, r in sd.items() for d in ("heads", "oracle")}}
    log("launches_by_path", **launches_by_path)
    kernels = []
    for name, variant, src, tpu, rows in (
            ("moe_gmm", "tensor_core", "src/repro_torch/csrc/moe_gmm.cu",
             "src/repro/kernels/moe_gmm.py:50", moe),
            ("flash_decode", "split_s", "src/repro_torch/csrc/flash_decode.cu",
             "src/repro/kernels/flash_decode.py:61", fd)):
        row = rows["decode"]
        profiled = row["profiled_ms"]
        ratio = row["ms"] / profiled
        log("timing_crosscheck", kernel=name, time_ms=row["ms"], profiled_ms=profiled,
            ratio=ratio, within_15pct=abs(ratio - 1) <= 0.15,
            main_path=prof["per_call"][name])
        if abs(ratio - 1) > 0.15:
            raise AssertionError(f"time_ms of {name} ({row['ms']} ms) and the "
                                 f"profiler's span ({profiled} ms) differ by more "
                                 f"than 15 %")
        cases = {case: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                          "max_abs_err")}
                 for case, r in rows.items() if "ms" in r and case != "decode"}
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": tpu, "variant": variant,
                        "launches": main_res["launches"][name],
                        "launches_by_path": {p: n[name] for p, n in launches_by_path.items()},
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "profiled_ms": profiled,
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        "other_timed_shapes": cases})
    lse = fd_lse["sharded_decode"]
    kernels.append({"name": "flash_decode_lse", "route": "cuda",
                    "source": "src/repro_torch/csrc/flash_decode.cu",
                    "replaces": "src/repro/kernels/flash_decode.py:61",
                    "variant": "split_s, (o, m, l) combine",
                    "launches": sharded["olmoe-1b-7b"]["jobs"]["bf16"]["ranks"][0][
                        "launches"]["decode"]["flash_decode_lse"],
                    "launches_by_path": {p: n.get("flash_decode_lse", 0)
                                         for p, n in launches_by_path.items()},
                    "max_abs_err": lse["max_abs_err"], "ms": lse["ms"],
                    "plain_ms": lse["plain_ms"], "bound_ms": lse["bound_ms"],
                    "bound_by": lse["bound_by"], "library_ms": lse["library_ms"],
                    "other_timed_shapes": {c: {k: r[k] for k in (
                        "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")}
                        for c, r in fd_lse.items() if "ms" in r and c != "sharded_decode"}})
    for key, case in (("training", "train"), ("training_sharded_rank", "train_sharded_rank")):
        kernels[0][key] = {k: grad[case][k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "bwd_plain_ms",
            "bwd_bound_ms", "max_abs_err")}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "kernel_attributes": attrs, "moe_gmm": moe, "flash_decode": fd,
         "flash_decode_lse": fd_lse, "sharded": sharded, "train_sharded": train_sharded,
         "parity_f32_max_abs_logit_err": parity, "main_path": main_res,
         "main_paths": others, "dbo": dbo_res, f"dbo.{ds}": dbo_ds, "specdec": sd,
         "mla_share": mla, f"prefill_patches.{vl}": patches,
         "moe_gmm_grad": grad, "parity_f32_train": parity_train, "train": train,
         "train_resume_run": resume_run, "train_resume": resume,
         "profile_train": prof_train, "train_recovery": recovery,
         "timing_floor_ms": floor_ms, "phase_wall_s": walls,
         "sweep_torch_grid": grid, "cost_solve": cost, "dryrun": dry,
         "profile": profiles, "kernels": kernels}, indent=1, default=str))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
