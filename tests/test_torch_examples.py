"""The port's examples (``examples/*_torch.py``) run end to end on the CPU
when asked (``--device cpu``), reduced, each in a subprocess."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent


def run_example(name, *args):
    # two intra-op threads: the suite's other workers share the cores, and
    # torch's default of one thread a core oversubscribes them
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
                        *args], env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_serve_moe_example_on_cpu():
    out = run_example("serve_moe_torch.py", "--requests", "4", "--max-batch", "2",
                      "--new-tokens", "6", "--sd")
    assert "completed 4 requests" in out and "identical: True" in out


def test_train_lm_example_on_cpu(tmp_path):
    out = run_example("train_lm_torch.py", "--steps", "30", "--layers", "2",
                      "--inject-failure", "--ckpt-dir", str(tmp_path))
    assert "recovered from 1 failure(s)" in out and "loss:" in out
