"""The benchmark of repro_torch on NVIDIA cards: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is looked up by name in
BENCHMARK.json, its configuration in its ``file``, its traffic in
``perfbench/traffic/<traffic>.json`` and that traffic's driver in
``perfbench/drivers/<driver>.py``; with ``--trace 1`` each per-layer
metric's reader in ``perfbench/metrics/<metric>.py``. The last line of
standard output is one JSON object; the numbers compared for ``correct``
are the last lines of standard error and the last key of that object.
Exits non-zero, printing no result, without enough CUDA cards, when the
program cannot be imported, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
ALLOC_CONF = "expandable_segments:True"


def forbidden_modules(names=None) -> list:
    """Top-level names among `names` (default: ``sys.modules``) that
    belong to JAX or the JAX package, compared whole (``repro_torch`` is
    not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(names or sys.modules)} & FORBIDDEN)


def card_line() -> str:
    """nvidia-smi's name and power limit of the cards, or why not."""
    import subprocess
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip().replace("\n", "; ") or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def collect(bench, workload: str, mix: str, out, trace: bool) -> dict:
    """The cell's end-to-end metrics (every one measured), or with
    `trace` its per-layer metrics, each read by its own reader; a reader
    that finds nothing to read leaves its metric out."""
    from perfbench.harness import spec
    metrics = {}
    if trace:
        for m in bench.metrics_of(workload, "per_layer"):
            v = spec.reader(m["name"], mix).read(out.readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        return metrics
    for m in bench.metrics_of(workload, "end_to_end"):
        v = out.end_to_end.get(spec.quantity(m["name"], mix))
        if v is None:
            raise LookupError(f"end-to-end metric {m['name']} was not measured")
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return metrics


def result_line(out, metrics: dict, trace: bool) -> dict:
    """The result's line: the keys the driver reads, then the run's own
    notes, and the numbers compared for ``correct`` last."""
    line = {"correct": bool(out.correct), "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": out.device}
    if trace and out.breakdown:
        line["breakdown"] = out.breakdown
    line["run"] = dict(out.extra, card=card_line())
    line["checks"] = out.checks
    return line


def fail(msg: str, code: int = 2):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the run at a fixed path inside the checkout
    cache = ROOT / ".perfbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    # long prefills free and take multi-GiB transients: segments that grow
    # in place keep them from splitting the card's memory into pieces
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = ALLOC_CONF
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from perfbench.harness import spec
    from perfbench.harness.result import Context
    bench = spec.Bench(ROOT)
    cell = bench.cell(args.workload)
    cfg_file = bench.config_file(cell["config"])
    traffic = spec.traffic(cell["traffic"])

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        fail(f"{args.workload} needs {cell['chips']} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program (repro_torch) cannot be imported: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(4, os.cpu_count() or 1))

    ctx = Context(cell=cell, config=cfg_file, run=spec.run_values(cfg_file),
                  traffic=traffic, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), t_start=T_START)
    out = spec.driver(traffic["driver"]).run(ctx)

    try:
        metrics = collect(bench, args.workload, cell["traffic"], out, bool(args.trace))
    except LookupError as e:
        fail(str(e), 3)

    bad = forbidden_modules()
    if bad:
        fail(f"modules of JAX or the JAX package were loaded: {', '.join(bad)}", 4)

    line = result_line(out, metrics, bool(args.trace))
    for name, c in out.checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
