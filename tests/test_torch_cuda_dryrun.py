"""The dry run of a train cell, where torch is built with CUDA (``cuda``
marker; skipped without a card). The autograd engine keeps a stream per
card, which a build of torch without CUDA refuses for fake tensors on the
card, so the backward of a fake trace runs only there. Like
``tests/test_torch_cuda.py`` this file imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda_dryrun.py

The trace (a subprocess, as in ``tests/test_torch_dryrun.py``) must count
the collective bytes and calls per kind of the same train and decode steps
run for real on four gloo ranks on the CPU; and the decode step traced
with the Tensor bindings run as aten ops (what a build without CUDA needs,
``dryrun._FakeCardBindings``) must count what torch's own bindings give.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"
sys.path.insert(0, str(TESTS))
import torch_dryrun_workers as W  # noqa: E402

pytestmark = pytest.mark.cuda

CELLS = {
    "train": {"arch": "olmoe-1b-7b", "reduced": True, "shape": ["t", 16, 8, "train"],
              "mesh": [2, 2]},
    "decode": {"arch": "olmoe-1b-7b", "reduced": True, "shape": ["d", 64, 8, "decode"],
               "mesh": [2, 2]},
}


# the decode cell traced with the bindings rewritten, as without CUDA
REWRITTEN = dict(CELLS["decode"], bindings_as_aten=True)


@pytest.fixture(scope="module")
def both():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a build of torch with CUDA)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(TESTS)]))
    r = subprocess.run([sys.executable, str(TESTS / "torch_dryrun_workers.py"),
                        json.dumps(list(CELLS.values()) + [REWRITTEN])], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    dry = dict(zip(list(CELLS) + ["rewritten"], json.loads(r.stdout.strip().splitlines()[-1])))
    real = serve.spawn(W.real_step_counts, (list(CELLS.values()),), mesh_shape=(2, 2),
                       transport="gloo", device="cpu", timeout=600)
    return dry, {name: real[0][i] for i, name in enumerate(CELLS)}


@pytest.mark.parametrize("kind", list(CELLS))
def test_fake_mesh_collectives_equal_a_gloo_run_on_a_cuda_build(both, kind):
    dry, real = both
    assert real[kind], "the real step ran no collective"
    want = {}
    for k, c in real[kind].items():
        want[f"{k}_bytes"] = c["bytes"]
        want[f"{k}_count"] = c["calls"]
    want["total_bytes"] = sum(c["bytes"] for c in real[kind].values())
    assert dry[kind]["collectives"] == want
    assert dry[kind]["flops_by_op"]["repro_torch.moe_gmm"] > 0


def test_rewritten_bindings_count_what_torch_indexing_counts(both):
    """On a build with CUDA the trace runs torch's own indexing; the
    rewrite a build without CUDA runs (``_index_parts``) counts the same
    bytes, memory and FLOPs."""
    dry, _ = both
    for key in ("flops", "flops_by_op", "bytes_accessed", "mem_argument_size_in_bytes",
                "mem_output_size_in_bytes", "mem_temp_size_in_bytes", "collectives"):
        assert dry["rewritten"][key] == dry["decode"][key], key
