"""Readings for the limits of ``correct``: the program's logit gaps and
the control's, on several seeds in one process.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 --seconds 10

Each seed is one whole run of the cell's driver (set-up, a short window
at the cell's own load, the sample of finished requests) whose judge
also runs the control: the plain reference with float8 weights put in
the program's place, read at the same prompts and tokens. Prints one
JSON line a seed: {"seed", "served", "control"}, each the
``judge.summary`` of its gaps. The benchmark's own runs never run the
control."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.run import ALLOC_CONF
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = ALLOC_CONF
    import torch

    from perfbench.harness import spec
    from perfbench.harness.result import Context
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = spec.Bench(ROOT)
    cell = bench.cell(args.workload)
    cfg = bench.config_file(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Context(cell=cell, config=cfg, run=spec.run_values(cfg), traffic=traffic,
                      seed=seed, seconds=args.seconds, trace=False,
                      t_start=time.perf_counter(), fp8_control=True)
        out = spec.driver(traffic["driver"]).run(ctx)
        print(json.dumps({"seed": seed, "served": out.extra["gaps"],
                          "control": out.extra["control_gaps"]}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
