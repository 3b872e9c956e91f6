"""The port's training runtime, mirroring ``tests/test_training.py`` test for
test at the same sizes and tolerances (loop convergence, checkpoint
round-trip and elastic shards, exact resume, recovery from injected
failures, gradient compression, the data pipeline), plus the port held
against the JAX package: the same tokens from one seed, the JAX
``Trainer`` and the port's from the same converted weights over 5 steps,
one step's gradients, and a bfloat16 checkpoint without ``ml_dtypes``."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sharding.dist import NullDist as JaxNullDist  # noqa: E402
from repro.training import compression as jcompression  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training.train_loop import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.training.train_loop import Trainer as JaxTrainer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.sharding.dist import NullDist  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import compression  # noqa: E402
from repro_torch.training.data import DataConfig, DeadlineIterator, SyntheticLM  # noqa: E402
from repro_torch.training.fault_tolerance import (  # noqa: E402
    FailureInjector, WorkerFailure, run_with_recovery)
from repro_torch.training.train_loop import TrainConfig, Trainer  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)          # as test_torch_train_loss.py


def small_cfg(dtype="bfloat16"):
    return reduced_config(get_arch("olmoe-1b-7b"), dtype=dtype)


def small_data(cfg, batch=4, seq=16, seed=0):
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed))


def trainer(cfg, tc, **kw):
    return Trainer(cfg, tc, device="cpu", **kw)


def leaves32(tree):
    return [t.detach().float() for t in convert.tree_leaves(tree)]


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_data_deterministic_and_seekable():
    cfg = small_cfg()
    d = small_data(cfg)
    b7a, b7b = d.batch(7), d.batch(7)
    assert (b7a == b7b).all()
    assert not (d.batch(7) == d.batch(8)).all()


def test_data_rank_sharding():
    cfg = small_cfg()
    d = small_data(cfg, batch=8)
    full_like = [d.batch(3, rank=r, world=4) for r in range(4)]
    assert all(b.shape == (2, 16) for b in full_like)
    assert not (full_like[0] == full_like[1]).all()


def test_deadline_iterator_skips_stragglers():
    cfg = small_cfg()
    d = small_data(cfg)

    def produce(step):
        return d.batch(step), (10.0 if step == 2 else 0.0)

    it = DeadlineIterator(d, deadline_s=1.0, produce=produce)
    got = [it.batch(s) for s in range(4)]
    assert got[2] is None and it.skipped == [2]
    assert all(g is not None for i, g in enumerate(got) if i != 2)


def test_data_matches_jax():
    """One seed gives the JAX pipeline's tokens, on every rank, and the
    seeded failure plan is the JAX package's."""
    cfg = small_cfg()
    mine = small_data(cfg, batch=8, seed=5)
    theirs = jdata.SyntheticLM(jdata.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                                global_batch=8, seed=5))
    for step in (0, 3, 11):
        np.testing.assert_array_equal(mine.batch(step), theirs.batch(step))
        np.testing.assert_array_equal(mine.batch(step, rank=1, world=2),
                                      theirs.batch(step, rank=1, world=2))
    assert FailureInjector.seeded(200, 0.05, seed=3).fail_at == \
        jfaults.FailureInjector.seeded(200, 0.05, seed=3).fail_at


# ---------------------------------------------------------------------------
# training loop
# ---------------------------------------------------------------------------

def test_loss_decreases():
    cfg = small_cfg()
    tr = trainer(cfg, TrainConfig(lr=1e-2, log_every=0))
    data = small_data(cfg)
    losses = tr.run(data, 30, log=lambda s: None)
    early = np.mean(losses[:5])
    late = np.mean(losses[-5:])
    assert late < early - 0.5, (early, late)


def test_grad_accumulation_matches_big_batch():
    """mb=2 over batch 4 == mb=1 over the same batch (same update)."""
    cfg = small_cfg()
    data = small_data(cfg)
    tok = data.batch(0)
    tr1 = trainer(cfg, TrainConfig(lr=1e-3, microbatches=1, seed=7))
    tr2 = trainer(cfg, TrainConfig(lr=1e-3, microbatches=2, seed=7))
    l1 = tr1.train_step(tok)
    l2 = tr2.train_step(tok)
    assert l1 == pytest.approx(l2, rel=1e-2)
    for a, b in zip(leaves32(tr1.params), leaves32(tr2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2, atol=2e-3)


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "nest": {"b": torch.ones((5,), dtype=torch.bfloat16)},
            "t": (torch.zeros((2, 2)), torch.full((1,), 3, dtype=torch.int32))}
    ckpt.save(tree, str(tmp_path), 5)
    out, step = ckpt.restore(tree, str(tmp_path))
    assert step == 5
    for x, y in zip(convert.tree_leaves(tree), convert.tree_leaves(out)):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


def test_checkpoint_sharded_files_elastic(tmp_path):
    """Save split into 4 shard files; restore reassembles identically."""
    tree = {"w": torch.arange(64.0).reshape(8, 8)}
    d = ckpt.save(tree, str(tmp_path), 1, n_shards=4)
    files = [f for f in os.listdir(d) if f.startswith("w.shard")]
    assert len(files) == 4
    out, _ = ckpt.restore(tree, str(tmp_path))
    assert torch.equal(out["w"], tree["w"])


def test_checkpoint_atomic_and_prune(tmp_path):
    tree = {"x": torch.ones(3)}
    for s in (1, 2, 3, 4):
        ckpt.save(tree, str(tmp_path), s)
    ckpt.prune_old(str(tmp_path), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [3, 4]
    os.makedirs(os.path.join(tmp_path, "step_000099.tmp"))
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_checkpoint_bf16_and_fp8_without_ml_dtypes(tmp_path):
    """bfloat16 and float8 leaves, a named tuple and per-layer lists go
    through numpy's integer views, bit for bit, in a process where
    ``ml_dtypes`` cannot be imported; the manifest keys are the leaves'
    paths, with the named tuple's field names."""
    code = f"""
import json, sys
sys.modules["ml_dtypes"] = None
import torch
from repro_torch.training import checkpoint as ckpt, optim
g = torch.Generator().manual_seed(0)
params = {{"stack": [{{"w": torch.randn((6, 4), generator=g).to(torch.bfloat16)}}]}}
st = optim.init_state(params)
st.m["stack"][0]["w"].normal_(generator=g)
tree = {{"params": params, "opt": st,
         "f8": torch.randn((8,), generator=g).to(torch.float8_e4m3fn)}}
d = ckpt.save(tree, {str(tmp_path)!r}, 7, n_shards=2)
like = {{"params": {{"stack": [{{"w": torch.zeros((6, 4), dtype=torch.bfloat16)}}]}},
        "opt": optim.init_state(params), "f8": torch.zeros((8,), dtype=torch.float8_e4m3fn)}}
out, step = ckpt.restore(like, {str(tmp_path)!r})
assert step == 7
assert torch.equal(out["params"]["stack"][0]["w"].view(torch.int16),
                   params["stack"][0]["w"].view(torch.int16))
assert torch.equal(out["f8"].view(torch.uint8), tree["f8"].view(torch.uint8))
assert torch.equal(out["opt"].m["stack"][0]["w"], st.m["stack"][0]["w"])
assert out["opt"].step.dtype == torch.int32
keys = json.load(open(d + "/manifest.json"))["keys"]
assert keys["params/stack/0/w"]["dtype"] == "bfloat16"
assert keys["params/stack/0/w"]["shards"] == 2
assert {{"opt/step", "opt/m/stack/0/w", "opt/v/stack/0/w", "f8"}} <= set(keys)
assert "ml_dtypes" not in [m for m in sys.modules if sys.modules[m] is not None]
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr


def test_checkpoint_restore_rejects_other_trees(tmp_path):
    ckpt.save({"x": torch.ones(3)}, str(tmp_path), 1)
    with pytest.raises(KeyError):
        ckpt.restore({"y": torch.ones(3)}, str(tmp_path))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore({"x": torch.ones(4)}, str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ckpt.restore({"x": torch.ones(3)}, str(tmp_path / "none"))


def test_trainer_resume_exact(tmp_path):
    """Train 6 steps with ckpt@2; a fresh trainer restored at step 4 and
    run to 6 must produce bit-identical params to the uninterrupted run."""
    cfg = small_cfg()
    data = small_data(cfg)
    tc = TrainConfig(lr=1e-3, ckpt_every=2, ckpt_dir=str(tmp_path),
                     log_every=0, seed=3)
    tr = trainer(cfg, tc)
    tr.run(data, 6, log=lambda s: None)

    tr2 = trainer(cfg, tc)
    at = tr2.restore(4)
    assert at == 4
    tr2.run(data, 6, log=lambda s: None)
    for a, b in zip(convert.tree_leaves(tr.params), convert.tree_leaves(tr2.params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_recovery_from_injected_failures(tmp_path):
    cfg = small_cfg()
    data = small_data(cfg)
    tc = TrainConfig(lr=1e-3, ckpt_every=2, ckpt_dir=str(tmp_path),
                     log_every=0)
    tr = trainer(cfg, tc)
    inj = FailureInjector(fail_at=[3, 7])
    rep = run_with_recovery(tr, data, 10, injector=inj)
    assert rep.restarts == 2
    assert rep.completed_steps == 10
    assert len(rep.recovery_log) == 2
    assert inj.fired == [3, 7]


def test_recovery_bounded(tmp_path):
    cfg = small_cfg()
    data = small_data(cfg)
    tc = TrainConfig(lr=1e-3, ckpt_every=100, ckpt_dir=str(tmp_path),
                     log_every=0)
    tr = trainer(cfg, tc)

    class AlwaysFail(FailureInjector):
        def check(self, step):
            raise WorkerFailure("permafail")

    with pytest.raises(RuntimeError, match="restarts"):
        run_with_recovery(tr, data, 5, injector=AlwaysFail(),
                          max_restarts=3)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_quantize_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (128, 64)).astype(np.float32))
    q, s = compression.quantize_int8(x)
    back = compression.dequantize_int8(q, s)
    assert q.dtype == torch.int8
    assert float((back - x).abs().max()) <= float(s) / 2 + 1e-6


def test_error_feedback_accumulates():
    """With error feedback, the MEAN of repeated compressed reductions of a
    constant gradient converges to the true value (bias -> residual)."""
    dist = NullDist()
    g = torch.tensor([[1.37e-3, -4.2e-4], [9.9e-5, 2.2e-3]])
    err = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(64):
        out, err = compression.compressed_psum(g, None, dist, err)
        total = total + out
    np.testing.assert_allclose((total / 64).numpy(), g.numpy(), rtol=0.02, atol=1e-6)


def test_compressed_psum_matches_jax():
    rng = np.random.default_rng(1)
    g = rng.normal(0, 1e-2, (16, 8)).astype(np.float32)
    err = rng.normal(0, 1e-4, (16, 8)).astype(np.float32)
    tt, te = compression.compressed_psum(torch.from_numpy(g), None, NullDist(),
                                         torch.from_numpy(err))
    jt, je = jcompression.compressed_psum(jnp.asarray(g), None, JaxNullDist(),
                                          jnp.asarray(err))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6, atol=1e-9)


def test_compressed_training_still_learns():
    cfg = small_cfg()
    tr = trainer(cfg, TrainConfig(lr=1e-2, grad_compress=True, log_every=0))
    data = small_data(cfg)
    losses = tr.run(data, 25, log=lambda s: None)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


# ---------------------------------------------------------------------------
# the port's Trainer against the JAX Trainer
# ---------------------------------------------------------------------------

def trainer_pair(dtype, seed=7, lr=1e-3):
    """The JAX Trainer and the port's from its converted weights."""
    jcfg = jax_reduced(jax_arch("olmoe-1b-7b"), dtype=dtype)
    tcfg = small_cfg(dtype)
    jt = JaxTrainer(jcfg, JaxTrainConfig(lr=lr, log_every=0, seed=seed))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jt.params), tcfg,
                                     device="cpu")
    tt = trainer(tcfg, TrainConfig(lr=lr, log_every=0, seed=seed), params=params)
    jdat = jdata.SyntheticLM(jdata.DataConfig(vocab_size=512, seq_len=16,
                                              global_batch=4, seed=0))
    return jcfg, tcfg, jt, tt, jdat, small_data(tcfg)


def jax_params_f32(jt, tcfg):
    return leaves32(convert.params_from_jax(
        jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jt.params), tcfg,
        device="cpu"))


def test_trainer_matches_jax_f32():
    """5 steps from the same converted weights, f32: each step's loss
    within 1e-4 relative, the params within the JAX package's own
    accumulation tolerance (rtol 2e-2, atol 2e-3): Adam divides by sqrt(v),
    so a last-digit difference in a near-zero gradient can move that
    parameter by up to 2 lr a step."""
    _, tcfg, jt, tt, jdat, tdat = trainer_pair("float32")
    lj = jt.run(jdat, 5, log=lambda s: None)
    lt = tt.run(tdat, 5, log=lambda s: None)
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    assert int(tt.opt_state.step) == 5
    for a, b in zip(leaves32(tt.params), jax_params_f32(jt, tcfg)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2, atol=2e-3)


def test_trainer_matches_jax_bf16():
    """The same in bfloat16: each step's loss within 1e-2 relative (the two
    frameworks round bf16 products at other places)."""
    _, _, jt, tt, jdat, tdat = trainer_pair("bfloat16")
    lj = jt.run(jdat, 5, log=lambda s: None)
    lt = tt.run(tdat, 5, log=lambda s: None)
    np.testing.assert_allclose(lt, lj, rtol=1e-2)


def test_one_step_grads_match_jax():
    """One step at a time from the same state: the gradients the step uses
    (``Trainer.grads``) match ``jax.grad`` of the JAX loss within the
    train_loss tolerances, and after the step so do the loss and the first
    moments (0.1 x those gradients). Later states are compared by
    ``test_trainer_matches_jax_f32``: Adam's first steps move a parameter
    with a near-zero gradient by about lr either way, so the gradients of
    later steps differ by more than these tolerances."""
    jcfg, tcfg, jt, tt, jdat, tdat = trainer_pair("float32")
    tok = tdat.batch(0)
    loss, grads = tt.grads(tok)

    def loss_fn(p):
        return JM.train_loss(p, {"tokens": jnp.asarray(tok)}, jcfg,
                             jt.plan, jt.dist, remat=False)
    lj, gj = jax.value_and_grad(loss_fn)(jt.params)
    np.testing.assert_allclose(loss.item(), float(lj), rtol=1e-4)
    want = convert.tree_leaves(convert.params_from_jax(
        jax.tree.map(np.asarray, gj), tcfg, device="cpu"))
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)
    lj = jt.train_step(jdat.batch(0))
    assert tt.train_step(tok) == pytest.approx(lj, rel=1e-4)
    m_want = convert.tree_leaves(convert.params_from_jax(
        jax.tree.map(np.asarray, jt.opt_state.m), tcfg, device="cpu"))
    for a, b in zip(convert.tree_leaves(tt.opt_state.m), m_want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def test_trainer_state_and_defaults(monkeypatch):
    """f32 moments for bf16 params, grads f32 in leaf order, and the card
    by default: without one, a Trainer raises instead of using the CPU."""
    cfg = small_cfg()
    tr = trainer(cfg, TrainConfig(seed=1))
    assert all(m.dtype == torch.float32 for m in convert.tree_leaves(tr.opt_state.m))
    loss, grads = tr.grads(small_data(cfg).batch(0))
    assert loss.dtype == torch.float32 and np.isfinite(loss.item())
    assert [g.shape for g in grads] == [p.shape for p in convert.tree_leaves(tr.params)]
    assert all(g.dtype == torch.float32 for g in grads)
    with pytest.raises(ValueError, match="microbatches"):
        trainer(cfg, TrainConfig(microbatches=3)).grads(small_data(cfg).batch(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, TrainConfig())
