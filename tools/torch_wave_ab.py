"""Two checkouts of the PyTorch port against each other on one card: a
config's decode wave (olmoe-1b-7b unless ``--arch`` names another), and the
host cost of a kernel call.

    python tools/torch_wave_ab.py --trees build/parent build/tree --pairs 3 \\
        [--arch granite-moe-3b-a800m] [--out build/wave_ab.jsonl]

Each tree is the root of a checkout (its ``chip_smoke.py`` and ``src/``,
e.g. unpacked from ``git archive``). The sides run one at a time, each in
a process of its own, alternated: A B B A A B ... for ``--pairs`` pairs.
A side prints one JSON line:

- ``chip_smoke.main_path``'s wave (median and mean ms), prefill ms a
  request, and the kernels' launches a wave; ``chip_smoke.profile_waves``'s
  device ms, kernels and idle share a wave;
- ``wrapper_us``: the host µs a call of ``ops.moe_gmm`` and
  ``ops.flash_decode`` at shapes whose device time is below it (enqueue
  time, median of rounds of 200 calls);
- ``dispatch_us``, in a tree whose launches are ``torch.library`` ops
  (``repro_torch::moe_gmm``, ``repro_torch::flash_decode``): the same
  launch called as the op and as the Python function the op dispatches to,
  interleaved round by round, µs a call each, and their difference (what
  the op's dispatch adds to a call).

The card's name and power limit are printed first. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROUNDS = 15
CALLS = 200
# each config's requests as chip_smoke.py's main phase serves them
PATHS = {"olmoe-1b-7b": {}, "granite-moe-3b-a800m": dict(n_requests=12, new_tokens=16)}


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _host_us(torch, fns: dict) -> dict:
    """µs a call of each function's enqueue, rounds interleaved across the
    functions; the median round of each."""
    for fn in fns.values():
        for _ in range(50):
            fn()
    torch.cuda.synchronize()
    rounds = {name: [] for name in fns}
    for _ in range(ROUNDS):
        for name, fn in fns.items():
            t = time.perf_counter()
            for _ in range(CALLS):
                fn()
            rounds[name].append(1e6 * (time.perf_counter() - t) / CALLS)
            torch.cuda.synchronize()
    return {name: _median(r) for name, r in rounds.items()}


def side(tree: str, arch: str) -> dict:
    """One side: `arch` run from `tree`'s own sources."""
    tree = os.path.abspath(tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch

    import chip_smoke
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import moe_gmm as kmoe
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine

    assert chip_smoke.__file__.startswith(tree), chip_smoke.__file__
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    bf = dict(dtype=torch.bfloat16, device="cuda")
    q = torch.randn(2, 4, 64, generator=g, **bf)
    k = torch.randn(2, 4, 64, 64, generator=g, **bf)
    x = torch.randn(2, 8, 64, generator=g, **bf)
    w = torch.randn(2, 64, 64, generator=g, **bf)
    torch.cuda.synchronize()
    first = {}
    for name, fn in (("moe_gmm", lambda: ops.moe_gmm(x, w, w, w)),
                     ("flash_decode", lambda: ops.flash_decode(q, k, k, 40))):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        first[name] = 1e3 * (time.perf_counter() - t)

    res, eng, prompts = chip_smoke.main_path(torch, get_arch, M, Engine, kmoe, kfd,
                                             arch=arch, **PATHS[arch])
    prof = chip_smoke.profile_waves(torch, eng, prompts, res["decode_ms_per_wave_median"])
    del eng
    torch.cuda.empty_cache()

    wrapper = _host_us(torch, {"moe_gmm": lambda: ops.moe_gmm(x, w, w, w),
                               "flash_decode": lambda: ops.flash_decode(q, k, k, 40)})
    dispatch = None
    if hasattr(torch.ops.repro_torch, "moe_gmm"):
        lengths = kfd.lengths_tensor(40, q.shape[0], q.device)
        us = _host_us(torch, {
            "moe_gmm_op": lambda: torch.ops.repro_torch.moe_gmm(x, w, w, w),
            "moe_gmm_direct": lambda: kmoe._moe_gmm_launch(x, w, w, w),
            "flash_decode_op": lambda: torch.ops.repro_torch.flash_decode(q, k, k, lengths),
            "flash_decode_direct": lambda: kfd._flash_decode_launch(q, k, k, lengths)})
        dispatch = dict(us, **{f"{n}_added": us[f"{n}_op"] - us[f"{n}_direct"]
                               for n in ("moe_gmm", "flash_decode")})
    return {"tree": tree, "arch": arch, "wave_ms_median": res["decode_ms_per_wave_median"],
            "wave_ms_mean": res["decode_ms_per_wave"],
            "prefill_ms_per_request": res["prefill_ms_per_request"],
            "launches_per_wave": res["launches_per_wave"],
            "kernels_per_wave": prof["kernels_per_wave"],
            "device_busy_ms_per_wave": prof["device_busy_ms_per_wave"],
            "idle_share": prof["idle_share"], "wrapper_us": wrapper,
            "dispatch_us": dispatch, "first_call_ms": first}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--arch", default="olmoe-1b-7b", choices=sorted(PATHS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--side", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.side:
        print(json.dumps(side(args.side, args.arch)), flush=True)
        return 0
    if not args.trees:
        ap.error("--trees A B")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    a, b = args.trees
    order = [(a, b) if i % 2 == 0 else (b, a) for i in range(args.pairs)]
    rc = 0
    for tree in [t for pair in order for t in pair]:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--side", tree,
                            "--arch", args.arch], capture_output=True, text=True,
                           timeout=600)
        line = r.stdout.strip().splitlines()[-1] if r.returncode == 0 else json.dumps(
            {"tree": tree, "rc": r.returncode, "stderr": r.stderr[-2000:]})
        print(f"side={tree} rc={r.returncode} s={time.perf_counter() - t0:.1f}", flush=True)
        print(line, flush=True)
        rc = rc or r.returncode
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
