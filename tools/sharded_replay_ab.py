"""The bf16 job of ``chip_smoke.py``'s sharded olmoe-1b-7b serving phase in
two checkouts, its single-device references routing for themselves and
replaying the sharded run's expert choices:

    python tools/sharded_replay_ab.py --trees build/parent . [--seeds 0 1] \\
        [--out build/replay_ab.jsonl]

Each tree is the root of a checkout (its ``chip_smoke.py`` and ``src/``).
For every seed, tree and mode a process of its own runs
``chip_smoke.sharded_phase`` for olmoe-1b-7b with only its bf16 job, the
seed in place of ``chip_smoke.SEED`` (weights, prompts), and prints one
JSON line:

- ``mode`` "own": the references (the bf16 single device and the f32
  truth) take their own top-k; "replay": they take the run's;
- ``routed_otherwise``: the tokens whose top-k the bf16 single device
  chooses otherwise than the sharded run, over every MoE call (counted in
  both modes);
- ``logits_vs_truth``, ``tokens_vs_truth``, ``flips_not_allowed``: the
  phase's bf16 gates (``logit_gate``, ``flip_gate``), and ``failed``, the
  phase's error where a gate failed.

The sides run one at a time. The card's name and power limit are printed
first. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ARCH = "olmoe-1b-7b"


def side(tree: str, seed: int, mode: str) -> dict:
    """One side: `tree`'s own sources, one seed, one mode."""
    tree = os.path.abspath(tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.serving import kvcache

    assert chip_smoke.__file__.startswith(tree), chip_smoke.__file__
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.SEED = seed
    jobs = chip_smoke.sharded_jobs
    chip_smoke.sharded_jobs = lambda arch, timed=False, **cut: {
        "bf16": jobs(arch, timed, **cut)["bf16"]}
    # the references get the run's choices in both modes, so that both
    # count the tokens routed otherwise; "own" keeps the references' top-k
    chip_smoke.SHARDED_ARCHS[ARCH]["replay"] = ("bf16",)
    if mode == "own":
        route = chip_smoke.replaying_route
        chip_smoke.replaying_route = lambda torch, r, chosen, counts, replay=True: route(
            torch, r, chosen, counts, False)
    records, log = {}, chip_smoke.log

    def keep(tag, **kv):
        records[tag] = kv
        log(tag, **kv)

    chip_smoke.log = keep
    failed = None
    try:
        chip_smoke.sharded_phase(torch, M, kvcache, chip_smoke.nvidia_smi_line(), arch=ARCH)
    except AssertionError as e:
        failed = str(e)
    job = records.get("sharded.bf16", {})
    return {"tree": tree, "seed": seed, "mode": mode, "failed": failed,
            "routed_otherwise": job.get("tokens_the_single_device_routes_otherwise"),
            "logits_vs_truth": job.get("logits_vs_truth"),
            "tokens_vs_truth": job.get("tokens_vs_truth"),
            "flips_not_allowed": job.get("flips_not_allowed"),
            "flips_vs_single_device": job.get("flips_vs_single_device")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"))
    ap.add_argument("--seeds", nargs="+", type=int, default=[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--side", nargs=3, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.side:
        tree, seed, mode = args.side
        print(json.dumps(side(tree, int(seed), mode)), flush=True)
        return 0
    if not args.trees:
        ap.error("--trees A B")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    rc = 0
    for seed in args.seeds:
        for tree in args.trees:
            for mode in ("own", "replay"):
                t0 = time.perf_counter()
                r = subprocess.run([sys.executable, os.path.abspath(__file__), "--side",
                                    tree, str(seed), mode],
                                   capture_output=True, text=True, timeout=900)
                line = r.stdout.strip().splitlines()[-1] if r.returncode == 0 else \
                    json.dumps({"tree": tree, "seed": seed, "mode": mode,
                                "rc": r.returncode, "stderr": r.stderr[-2000:]})
                print(f"side={tree} seed={seed} mode={mode} rc={r.returncode} "
                      f"s={time.perf_counter() - t0:.1f}", flush=True)
                print(line, flush=True)
                rc = rc or r.returncode
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
