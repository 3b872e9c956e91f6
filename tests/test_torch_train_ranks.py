"""The port's ``Trainer``, checkpoints and launcher across ranks: gloo
ranks on the CPU, reduced configs (port only: the JAX side of these is
its single device, held in ``test_torch_train_sharded.py``).

- ``test_training.py::test_compressed_training_still_learns`` on two data
  ranks: the int8 reduction with error feedback across ranks still
  learns.
- The ``Trainer`` on a 2x2 mesh (FSDP, two microbatches) against the
  single-device ``Trainer`` over 3 steps.
- ``test_distributed.py::test_elastic_checkpoint_across_meshes`` mirrored:
  params drawn sharded on (2, 2) and saved in 2 files a leaf, restored
  into (4, 1)'s layout and onto one device: the trees bit for bit and
  the loss within 1e-3 (the reference's (4, 2) needs 8 ranks).
- ``python -m repro_torch.launch.train --device cpu`` runs, saves and
  resumes on another mesh; ``chip_smoke.py``'s ``train_sharded`` phase
  rehearses on the CPU at a reduced size.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.sharding.plans import make_plan  # noqa: E402
from repro_torch.sharding.specs import param_specs  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.training.train_loop import TrainConfig, Trainer  # noqa: E402
from torch_train_workers import in_order, trainer_learns  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
AXES = ("data", "model")
B, S = 4, 16


def small_cfg(dtype="bfloat16"):
    return reduced_config(get_arch("olmoe-1b-7b"), dtype=dtype)


def f32_cfg():
    return reduced_config(get_arch("starcoder2-3b")).replace(
        num_heads=4, num_kv_heads=2, dtype="float32")


def test_compressed_training_across_data_ranks_still_learns():
    """Two data ranks, ``grad_compress``: the reduction over data is the
    int8 ``compressed_psum``; the loss falls as the one-device test's."""
    cfg = small_cfg()
    out = serve.spawn(trainer_learns, (cfg, dict(lr=1e-2, grad_compress=True, log_every=0),
                                       25, B, S),
                      mesh_shape=(2, 1), transport="gloo", device="cpu", timeout=300)
    losses = out[0]
    assert out[1] == losses
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


@pytest.fixture(scope="module")
def on_2x2(tmp_path_factory):
    """One spawn of a 2x2 mesh: 3 ``Trainer`` steps (FSDP, 2 microbatches)
    from converted global weights, then the sharded save of seed-0
    params."""
    d = str(tmp_path_factory.mktemp("elastic"))
    cfg = f32_cfg()
    params = M.init_model(cfg, None, seed=3, device="cpu")
    tc = dict(lr=1e-3, microbatches=2, log_every=0)
    calls = [("trainer_steps", (cfg, params, tc, 3, B, S, {"fsdp": True})),
             ("save_sharded", (small_cfg("float32"), d, B, S))]
    out = serve.spawn(in_order, (calls,), mesh_shape=(2, 2), transport="gloo",
                      device="cpu", timeout=300)
    return {"cfg": cfg, "params": params, "tc": tc, "dir": d,
            "trainer": [o[0] for o in out], "saved": [o[1] for o in out]}


def test_trainer_across_ranks_matches_single_device(on_2x2):
    cfg, tc = on_2x2["cfg"], on_2x2["tc"]
    single = Trainer(cfg, TrainConfig(**tc), params=convert.tree_map(
        lambda t: t.clone(), on_2x2["params"]), device="cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                  seed=0))
    want = single.run(data, 3, log=lambda s: None)
    for r in range(4):
        np.testing.assert_allclose(on_2x2["trainer"][r]["losses"], want, rtol=1e-5)
    # the weights after 3 AdamW steps: a gradient of rounding noise (below
    # AdamW's eps) moves a weight by a noise-dependent part of lr, so the
    # weights are held where the optimizer's second moment shows a real
    # gradient, and everywhere within 3 steps of 2 lr
    v = convert.tree_leaves(single.opt_state.v)
    for got, w, vv in zip(on_2x2["trainer"][0]["params"], convert.tree_leaves(single.params), v):
        w = w.detach().numpy()
        live = np.sqrt(vv.numpy() / (1 - 0.95 ** 3)) >= 1e-5
        np.testing.assert_allclose(got[live], w[live], rtol=1e-4, atol=1e-5)
        assert np.abs(got - w).max() <= 3 * 2 * 1e-3 + 1e-5


def test_elastic_checkpoint_across_meshes(on_2x2):
    """Saved from (2, 2) (FSDP layout, 2 files a leaf); restored into
    (4, 1)'s layout, each rank's shards equal to that layout's cut of the
    global draw bit for bit, and the loss on the restored shards within
    1e-3 of the single device's on the original; restored onto one
    device, the tree bit for bit and the same loss."""
    cfg, d = small_cfg("float32"), on_2x2["dir"]
    want = M.init_model(cfg, None, seed=0, device="cpu")
    mesh22 = Mesh((2, 2), AXES)
    specs22 = param_specs(cfg, make_plan(cfg, ShapeCell("t", S, B, "train"), AXES, (2, 2)))
    saved = convert.gather_tree(on_2x2["saved"], specs22, mesh22)
    for a, b in zip(convert.tree_leaves(saved), convert.tree_leaves(want)):
        np.testing.assert_array_equal(a, b.numpy())
    assert ckpt.latest_step(d) == 1
    with open(os.path.join(d, "step_000001", "manifest.json")) as f:
        shards = {k: m["shards"] for k, m in json.load(f)["keys"].items()}
    assert set(shards) == set(ckpt.flatten(want)) and shards["embed/table"] == 2
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    loss_ref = float(M.train_loss(want, {"tokens": torch.from_numpy(tok)}, cfg, remat=False))

    out = serve.spawn(in_order, ([("restore_sharded", (cfg, d, tok))],), mesh_shape=(4, 1),
                      transport="gloo", device="cpu", timeout=300)
    specs41 = param_specs(cfg, make_plan(cfg, ShapeCell("t", S, B, "train"), AXES, (4, 1)))
    for r in range(4):
        res = out[r][0]
        mine = convert.shard_tree(want, specs41, Mesh((4, 1), AXES, r))
        for a, b in zip(convert.tree_leaves(res["params"]), convert.tree_leaves(mine)):
            np.testing.assert_array_equal(a, b.numpy())
        assert res["step"] == 1
        assert res["loss"] == pytest.approx(loss_ref, rel=1e-3)

    like = convert.tree_map(torch.zeros_like, want)
    one, at = ckpt.restore(like, d)
    assert at == 1
    for a, b in zip(convert.tree_leaves(one), convert.tree_leaves(want)):
        assert torch.equal(a, b)
    loss1 = float(M.train_loss(one, {"tokens": torch.from_numpy(tok)}, cfg, remat=False))
    assert loss1 == pytest.approx(loss_ref, rel=1e-3)


def test_train_launcher_runs_saves_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
            "--transport", "gloo", "--reduced", "--steps", "2",
            "--ckpt-dir", str(tmp_path)]
    proc = subprocess.run(base + ["--mesh", "2x2"], env=env, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "step 1: loss" in proc.stdout and "2 steps in" in proc.stdout
    assert "transport gloo" in proc.stdout and ckpt.latest_step(str(tmp_path)) == 2
    proc = subprocess.run(base + ["--mesh", "4x1", "--resume"], env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "resumed from step 2" in proc.stdout and "step 3: loss" in proc.stdout
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_chip_smoke_train_sharded_phase_rehearses_on_cpu(monkeypatch):
    """``chip_smoke.py``'s ``train_sharded`` phase at a reduced size on the
    CPU: the launcher's jobs with the counting Dist, the expert-gradient
    check, the fp8 gate and the f32 gates against the single device (FSDP,
    and with ring attention). The counts show the FSDP gathers over data
    and their reduce-scatters in the backward."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    out = chip_smoke.train_sharded_phase(torch, "cpu", device="cpu", reduced=True, layers=2,
                                         batch=8, seq=32,
                                         config={"num_heads": 4, "num_kv_heads": 2})
    for name, gate in out["gates"].items():
        assert gate["loss_rel_err"] < 1e-5 and gate["worst_grad_err_over_max"] < 1e-5, name
    assert out["gates"]["f32_fsdp_ring"]["plan"].count("ring_attn=True")
    counts = out["jobs"]["bf16"]["ranks"][0]["collectives_step3"]
    fwd = counts["loss_and_backward"]
    assert fwd["all_gather@data"]["calls"] == fwd["reduce_scatter@data.backward"]["calls"]
    assert fwd["all_gather@data"]["bytes"] == fwd["reduce_scatter@data.backward"]["bytes"]
    assert "all_reduce@model" in counts["gradient_reduction"]
    assert out["fp8_last_loss_rel_to_bf16"] < 5e-2
