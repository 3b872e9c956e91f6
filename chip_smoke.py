#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing its own lines before the last:
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build: every CUDA kernel of ``src/repro_torch/csrc`` compiled with nvcc,
     one process per source, all at once;
  3. kernels against their plain PyTorch versions on the card, at the main
     path's shapes (olmoe-1b-7b), with times, bounds and library yardsticks;
  4. float32 parity: full width, 2 layers, the card's path (kernels) against
     the port's plain CPU path on the same weights;
  5. main path: full olmoe-1b-7b (16 layers, bf16, random weights from seed
     0) served by ``Engine(max_batch=8, max_seq=512)``: 16 requests of 16-128
     prompt tokens and 32 new tokens; the kernels' launch counters must show
     16 launches of each per decode wave;
  6. where a decode wave's device time goes (torch.profiler).
Then one JSON line of per-kernel numbers, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero; without a CUDA device it exits non-zero before printing a
result. Results also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, per data sheet
SEED = 0


def log(phase: str, **kv):
    print(f"[{phase}] " + json.dumps(kv, sort_keys=True), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around each call; a
    64 MB write between calls evicts the 50 MB L2, as the decode step's
    weight stream does between two layers' calls."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


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
    def inputs(e, t, d, f):
        x = torch.randn((e, t, d), generator=gen, device="cuda") * 0.3
        ws = [torch.randn(s, generator=gen, device="cuda") * s[1] ** -0.5
              for s in ((e, d, f), (e, d, f), (e, f, d))]
        return [x] + ws

    results = {}
    cases = [("decode", 64, 8, 2048, 1024, "bfloat16"),
             ("prefill", 64, math.ceil(128 * 8 * 1.5 / 64), 2048, 1024, "bfloat16"),
             ("decode_f32", 64, 8, 2048, 1024, "float32"),
             ("unaligned_f32", 8, 100, 2048, 1000, "float32"),
             ("unaligned_bf16", 8, 13, 2048, 1000, "bfloat16")]
    for name, e, t, d, f, dt in cases:
        full = inputs(e, t, d, f)
        args = [a.to(getattr(torch, dt)) for a in full]
        got = kmoe.moe_gmm_cuda(*args)
        torch.cuda.synchronize()
        plain = ref.moe_gmm_ref(*args)
        truth = ref.moe_gmm_ref(*(a.float() for a in args))
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
        row = {"shape": [e, t, d, f], "dtype": dt, "max_abs_err": err,
               "err_vs_f32_truth": err_truth, "rule": rule}
        if name in ("decode", "prefill", "decode_f32"):
            el = 2 if dt == "bfloat16" else 4
            row["ms"] = time_ms(torch, lambda: kmoe.moe_gmm_cuda(*args))
            row["plain_ms"] = time_ms(torch, lambda: ref.moe_gmm_ref(*args))
            row["bound_ms"], row["bound_by"] = bound(
                el * (2 * e * t * d + 3 * e * d * f), 6 * e * t * d * f, dt)
            row["library_ms"] = None
        results[name] = row
        log("kernel.moe_gmm", case=name, **row)
        del full, args, got, plain, truth
    return results


def check_flash_decode(torch, F, ref, kfd, gen):
    B, H, KH, hd = 8, 16, 16, 128
    results = {}
    cases = [("decode", 512, [17, 49, 64, 65, 100, 128, 150, 160], "bfloat16"),
             ("ragged_S", 500, [1, 37, 63, 64, 65, 200, 333, 500], "bfloat16"),
             ("ragged_S_f32", 500, [1, 37, 63, 64, 65, 200, 333, 500], "float32")]
    for name, S, lens, dt in cases:
        tdt = getattr(torch, dt)
        q = torch.randn((B, H, hd), generator=gen, device="cuda").to(tdt)
        k = torch.randn((B, KH, S, hd), generator=gen, device="cuda").to(tdt)
        v = torch.randn((B, KH, S, hd), generator=gen, device="cuda").to(tdt)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = kfd.flash_decode_cuda(q, k, v, lengths)
        torch.cuda.synchronize()
        want = ref.flash_decode_ref(q, k, v, lengths)
        truth = ref.flash_decode_ref(q.float(), k.float(), v.float(), lengths)
        err = max_err(got, want)
        if dt == "float32":
            ok = torch.allclose(got, want, atol=1e-4, rtol=1e-4)
            rule = "f32 atol=rtol=1e-4"
        else:
            err_plain = max_err(want, truth)
            ok = max_err(got, truth) <= 1.5 * err_plain + 1e-3
            rule = f"bf16 err vs f32 truth <= 1.5 x plain's ({err_plain:.3g}) + 1e-3"
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"flash_decode {name}: err {err} fails {rule}")
        row = {"B": B, "H": H, "KH": KH, "S": S, "hd": hd, "lengths": lens,
               "dtype": dt, "max_abs_err": err, "rule": rule}
        if name == "decode":
            mask = (torch.arange(S, device="cuda")[None, :] < lengths[:, None])
            mask = mask[:, None, None, :]

            def library():
                return F.scaled_dot_product_attention(
                    q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)[:, :, 0]
            lib_err = max_err(library(), truth)
            if lib_err > 2e-2:
                raise AssertionError(f"library yardstick disagrees: {lib_err}")
            row["ms"] = time_ms(torch, lambda: kfd.flash_decode_cuda(q, k, v, lengths))
            row["plain_ms"] = time_ms(torch, lambda: ref.flash_decode_ref(q, k, v, lengths))
            row["library_ms"] = time_ms(torch, library)
            n = sum(lens)
            row["bound_ms"], row["bound_by"] = bound(
                2 * (2 * B * H * hd + 2 * n * KH * hd) + 4 * B, 4 * n * H * hd, dt)
        results[name] = row
        log("kernel.flash_decode", case=name, **row)
    return results


# ---------------------------------------------------------------------------
# phase 4: float32 parity, card vs CPU, full width, 2 layers
# ---------------------------------------------------------------------------

def parity_f32(torch, get_arch, M, kvcache, convert):
    import numpy as np
    tol = 1e-3
    cfg = get_arch("olmoe-1b-7b").replace(num_layers=2, dtype="float32")
    p_cpu = M.init_model(cfg, device="cpu", seed=SEED)
    p_gpu = convert.tree_map(lambda t: t.to("cuda"), p_cpu)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (16, 40, 27)]
    seq, steps = 64, 4

    def run(params, device, feed=None):
        caches = M.init_cache(cfg, batch=len(prompts), seq=seq, device=device)
        logits = []
        for slot, p in enumerate(prompts):
            lg, sub = M.prefill_logits(params, {"tokens": torch.tensor([p], device=device)}, cfg)
            kvcache.insert_slot(caches, kvcache.pad_to_capacity(cfg, sub, len(p), seq), slot)
            logits.append(lg[:, 0, :cfg.vocab_size])
        pos = torch.tensor([len(p) for p in prompts], device=device)
        tok = torch.cat(logits).argmax(-1, keepdim=True) if feed is None else feed[0].to(device)
        toks, step_logits = [tok.cpu()], [torch.cat(logits).cpu()]
        for i in range(steps):
            lg, caches = M.decode_logits(params, caches, tok.to(torch.int32), pos, cfg)
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
    log("parity_f32", layers=2, width=cfg.d_model, max_abs_logit_err=worst,
        tol=tol, tokens_checked=n_checked, seconds=time.perf_counter() - t0)
    del p_cpu, p_gpu
    torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def main_path(torch, get_arch, M, Engine, kmoe, kfd):
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

    cfg = get_arch("olmoe-1b-7b")
    t0 = time.perf_counter()
    params = M.init_model(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for layer in params["stack"] for g in layer.values()
                   for t in g.values()) + sum(t.numel() for t in params["embed"].values())
    rng = np.random.default_rng(SEED)
    lens = rng.integers(16, 129, 16).tolist()
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    new_tokens = 32

    eng = TimedEngine(cfg, params, max_batch=8, max_seq=512, eos_id=-1)
    for p in prompts:
        eng.submit(p, max_new_tokens=new_tokens)
    torch.cuda.reset_peak_memory_stats()
    kmoe.launches = 0
    kfd.launches = 0
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"moe_gmm": kmoe.launches, "flash_decode": kfd.launches}

    waves, L = len(eng.wave_s), cfg.num_layers
    if sorted(out) != list(range(16)):
        raise AssertionError(f"requests not completed: {sorted(out)}")
    for rid, toks in out.items():
        if len(toks) != new_tokens + 1 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {rid}: bad output {toks}")
    if launches["flash_decode"] != L * waves:
        raise AssertionError(f"flash_decode launched {launches['flash_decode']} "
                             f"times, want {L} per wave x {waves} waves")
    if launches["moe_gmm"] != L * (waves + eng.prefills):
        raise AssertionError(f"moe_gmm launched {launches['moe_gmm']} times, want "
                             f"{L} per wave and per prefill")
    for layer in eng.caches:
        if not torch.isfinite(layer["mixer"]["k"]).all():
            raise AssertionError("non-finite KV cache")
    lg, _ = M.prefill_logits(params, {"tokens": torch.tensor([prompts[0]], device="cuda")}, cfg)
    if not torch.isfinite(lg[..., :cfg.vocab_size]).all():
        raise AssertionError("non-finite logits")
    n_gen = sum(len(t) for t in out.values())
    res = {
        "params": n_params, "init_s": init_s, "requests": 16,
        "prompt_lens": lens, "new_tokens": new_tokens, "waves": waves,
        "prefills": eng.prefills, "launches": launches,
        "launches_per_wave": {"moe_gmm": (launches["moe_gmm"] - L * eng.prefills) / waves,
                              "flash_decode": launches["flash_decode"] / waves},
        "prefill_ms_per_request": 1e3 * sum(eng.admit_s) / eng.prefills,
        "decode_ms_per_wave": 1e3 * sum(eng.wave_s) / waves,
        "decode_ms_per_wave_median": 1e3 * sorted(eng.wave_s)[len(eng.wave_s) // 2],
        "run_s": run_s, "tokens_per_s": n_gen / run_s,
        "decode_tokens_per_s": (n_gen - 16) / sum(eng.wave_s),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    log("main_path", **res)
    return res, eng, prompts


def profile_waves(torch, eng, prompts, wave_ms: float, n_waves: int = 4):
    """Device time by kernel over a few full decode waves, and the share of
    an unprofiled wave (`wave_ms`) in which the device is idle."""
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
    res = {"wave_ms_unprofiled": wave_ms, "device_busy_ms_per_wave": busy,
           "idle_share": 1 - busy / wave_ms if busy else None,
           "kernels_per_wave": sum(r[1] for r in rows),
           "top": [{"ms": r[0], "calls": r[1], "kernel": r[2]} for r in rows[:12]]}
    log("profile", **res)
    eng.run()
    return res


def main() -> int:
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
    from repro_torch.serving import kvcache
    from repro_torch.serving.engine import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi, flush=True)
    log("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi)

    t0 = time.perf_counter()
    secs = build.build_all()
    log("build", seconds_each=secs, wall_s=time.perf_counter() - t0,
        already_built=[n for n in build.KERNELS if n not in secs])

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    moe = check_moe_gmm(torch, ref, kmoe, gen)
    fd = check_flash_decode(torch, F, ref, kfd, gen)
    parity = parity_f32(torch, get_arch, M, kvcache, convert)
    torch.backends.cuda.matmul.allow_tf32 = False
    main_res, eng, prompts = main_path(torch, get_arch, M, Engine, kmoe, kfd)
    prof = profile_waves(torch, eng, prompts, main_res["decode_ms_per_wave_median"])

    kernels = []
    for name, src, tpu, row in (
            ("moe_gmm", "src/repro_torch/csrc/moe_gmm.cu",
             "src/repro/kernels/moe_gmm.py:50", moe["decode"]),
            ("flash_decode", "src/repro_torch/csrc/flash_decode.cu",
             "src/repro/kernels/flash_decode.py:61", fd["decode"])):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": tpu, "launches": main_res["launches"][name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"nvidia_smi": smi, "moe_gmm": moe, "flash_decode": fd,
         "parity_f32_max_abs_logit_err": parity, "main_path": main_res,
         "profile": prof, "kernels": kernels}, indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
