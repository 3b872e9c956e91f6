"""On the card: the control (the reference with float8 weights in the
program's place) fails a cell's limit of ``correct`` while the program,
on the same seed, prompts and tokens, passes it. One seed a cell at the
cell's own size and load, a short window; the limits' readings come
from ``perfbench/control.py`` over more seeds (PERF.md)."""
import json
import subprocess
import sys

import pytest

from perfbench.harness import spec

CELLS = ["dsv3.chat.c1", "jamba.docqa.c1"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit_the_program_meets(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell runs at its own size")
    r = subprocess.run([sys.executable, "perfbench/control.py", "--workload", cell,
                        "--seeds", "977", "--seconds", "20"],
                       cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    limit = spec.limits(cell)["mean_logit_gap"]
    assert got["served"]["mean"] <= limit < got["control"]["mean"], got
