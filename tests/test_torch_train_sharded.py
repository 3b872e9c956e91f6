"""Training across ranks in the port against the JAX package's single
device: four gloo ranks on the CPU as a 2x2 ("data", "model") mesh (one
spawn for the module), reduced configs in f32.

- The sequence-sharded loss (starcoder2, no FSDP): ``train_loss`` on the
  ranks equals the single device within 1e-5 relative. Before the port
  gathered the hidden states over the sequence, its vocab-parallel cross
  entropy reduced the logits of different position chunks, and this
  case missed by 7e-4.
- Mirrors of ``test_distributed.py::test_train_step_matches_single_device``
  for olmoe and starcoder2, with FSDP off and on and with ring attention:
  the train step's loss within 1e-5 of JAX's single-device ``train_loss``
  (the reference test allows 2e-2) and its reduced gradients, gathered,
  within the tolerance of ``test_torch_train_loss.py`` of ``jax.grad``.
  Its jamba case runs the sharded Mamba mixer (and the reduced
  deepseek-v3 the sequence-sharded MLA), FSDP off and on, held the same
  way: the reference test's own jamba case passes at ``rel=2e-2`` while
  its sharded Mamba misses its single device (ROADMAP queue 3). The
  reduced rwkv6 (4 WKV heads of 16) and seamless (the encoder on
  sequence-sharded frames, cross-attention) too, FSDP off and on.
- ``test_perf_knobs.py::test_ring_attention_matches_megatron`` mirrored on
  deepseek-67b (8 heads, 2 KV heads): ring against the port's Megatron-SP
  and JAX's single device, 1e-5.
- ``test_ag_fp8_close_to_baseline`` and ``test_a2a_fp8_close_to_baseline``
  (5e-2, bf16 as the reference), and the fp8 wire formats' gradients
  against ``jax.grad`` of the JAX functions on one process.
- One ``build_train_step`` update against one single-device ``Trainer``
  step (1e-5 where AdamW's step is a function of the gradient), and the
  FSDP spec trees against ``abstract_model``'s.
- The reference's own sharded training, run once in a subprocess on four
  forced host devices and pinned (ROADMAP queue 3): on a data-only mesh
  its step's gradients are exactly twice its single device's (a psum
  transposes to a psum under ``check_vma=False``); on (2, 2) its loss
  misses its single device's (the cross entropy over the sequence axis)
  and its gradients are not a multiple of them; its ring attention
  misses its own Megatron-SP path (K/V heads paired with another rank's
  query heads).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.configs.base import LayerSpec as JLayerSpec  # noqa: E402
from repro.configs.base import ShapeCell as JShapeCell  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import common as JC  # noqa: E402
from repro.models.layers import moe as JMOE  # noqa: E402
from repro.sharding.dist import NullDist as JaxNullDist  # noqa: E402
from repro.sharding.plans import make_plan as jax_make_plan  # noqa: E402
from repro.sharding.plans import null_plan as jax_null_plan  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import common as TC  # noqa: E402
from repro_torch.models.layers import moe as TMOE  # noqa: E402
from repro_torch.sharding import specs as SP  # noqa: E402
from repro_torch.sharding.dist import NullDist  # noqa: E402
from repro_torch.sharding.plans import make_plan  # noqa: E402
from repro_torch.training import optim  # noqa: E402
from repro_torch.training.checkpoint import flatten  # noqa: E402
from repro_torch.training.train_loop import TrainConfig, Trainer  # noqa: E402
from torch_train_workers import train_jobs  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
AXES, SHAPE = ("data", "model"), (2, 2)
B, S = 4, 32
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)          # as test_torch_train_loss.py
HEADS = {"olmoe-1b-7b": dict(num_heads=4, num_kv_heads=2),
         "starcoder2-3b": dict(num_heads=4, num_kv_heads=2),
         "deepseek-67b": dict(num_heads=8, num_kv_heads=2),
         "jamba-v0.1-52b": {}, "deepseek-v3": {}, "rwkv6-1.6b": {},
         "seamless-m4t-medium": {}}
VARIANTS = {"base": dict(fsdp=False), "fsdp": dict(fsdp=True),
            "ring": dict(fsdp=False, ring_attn=True)}


def configs(arch, dtype="float32"):
    """(JAX config, port config), reduced. jamba routes top-2 of 8 experts:
    its capacity factor is raised to 4 so that no token is dropped, and its
    load-balance loss is off. That loss is a mean over each rank's tokens
    (its capacity group), not over the whole batch as on one device, and
    the two differ where routing is not uniform (the reduced olmoe and
    deepseek-v3 route every token to all 8 experts)."""
    kw = dict(HEADS[arch], dtype=dtype)
    j, t = jax_reduced(jax_arch(arch)).replace(**kw), reduced_config(get_arch(arch)).replace(**kw)
    if arch == "rwkv6-1.6b":          # 4 WKV heads of 16, as a reduced launcher job
        hd = serve.REDUCED_RWKV_HEAD_DIM
        j = j.replace(rwkv=dataclasses.replace(j.rwkv, head_dim=hd))
        t = t.replace(rwkv=dataclasses.replace(t.rwkv, head_dim=hd))
    if arch == "jamba-v0.1-52b":
        j = j.replace(moe=dataclasses.replace(j.moe, capacity_factor=4.0,
                                              router_aux_loss_coef=0.0))
        t = t.replace(moe=dataclasses.replace(t.moe, capacity_factor=4.0,
                                              router_aux_loss_coef=0.0))
    return j, t


def tokens_for(cfg):
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def frames_for(cfg):
    """An encoder-decoder's audio frames [B, S, D] (None for other configs)."""
    if cfg.frontend != "audio_frames":
        return None
    return np.random.default_rng(2).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def jax_weights(jcfg):
    jp, _ = JM.init_model(jcfg, jax_null_plan("train"), jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jp)


def jax_loss_and_grads(jp, jcfg, tcfg, tok, frames=None):
    """JAX single device: (loss, gradients in the port's leaf order)."""
    batch = {"tokens": jnp.asarray(tok)}
    if frames is not None:
        batch["frames"] = jnp.asarray(frames)

    def f(p):
        return JM.train_loss(p, batch, jcfg, jax_null_plan("train"), JaxNullDist(),
                             remat=False)
    loss, g = jax.value_and_grad(f)(jax.tree.map(jnp.asarray, jp))
    g = convert.params_from_jax(jax.tree.map(np.asarray, g), tcfg, device="cpu")
    return float(loss), [t.numpy() for t in convert.tree_leaves(g)]


def _cases():
    """(jobs, references) for the one spawn of the module."""
    jobs, refs = {}, {}
    for arch in ("olmoe-1b-7b", "starcoder2-3b", "deepseek-67b", "jamba-v0.1-52b",
                 "deepseek-v3", "rwkv6-1.6b", "seamless-m4t-medium"):
        jcfg, tcfg = configs(arch)
        jp = jax_weights(jcfg)
        tp = convert.params_from_jax(jp, tcfg, device="cpu")
        tok, frames = tokens_for(tcfg), frames_for(tcfg)
        refs[arch] = dict(jp=jp, tp=tp, jcfg=jcfg, tcfg=tcfg, tok=tok,
                          jax=jax_loss_and_grads(jp, jcfg, tcfg, tok, frames))
        variants = {"deepseek-67b": ("base", "ring")}.get(
            arch, VARIANTS if arch in ("olmoe-1b-7b", "starcoder2-3b") else ("base", "fsdp"))
        for v in variants:
            jobs[f"grads/{arch}/{v}"] = dict(kind="grads", cfg=tcfg, params=tp, tokens=tok,
                                             plan_kw=VARIANTS[v])
            if frames is not None:
                jobs[f"grads/{arch}/{v}"]["frames"] = frames
    # jamba cut to its first layer: a MoE config whose stack has no MoE layer
    # (JAX inits no stack shorter than its period: held to the port's single
    # device, which the cases above hold to JAX's)
    tcfg = configs("jamba-v0.1-52b")[1].replace(num_layers=1)
    tp = M.init_model(tcfg, None, seed=0, device="cpu")
    tok = tokens_for(tcfg)
    leaves = [t.requires_grad_() for t in convert.tree_leaves(tp)]
    loss = M.train_loss(tp, {"tokens": torch.from_numpy(tok)}, tcfg, remat=False)
    grads = torch.autograd.grad(loss, leaves)
    tp = convert.tree_map(lambda t: t.detach(), tp)
    refs["jamba-1-layer"] = dict(tp=tp, jax=(float(loss.detach()), [g.numpy() for g in grads]))
    jobs["grads/jamba-1-layer/fsdp"] = dict(kind="grads", cfg=tcfg, params=tp, tokens=tok,
                                            plan_kw=VARIANTS["fsdp"])
    r = refs["starcoder2-3b"]
    jobs["loss/starcoder2-3b"] = dict(kind="loss", cfg=r["tcfg"], params=r["tp"],
                                      tokens=r["tok"], plan_kw=dict(fsdp=False))
    r = refs["starcoder2-3b"]
    jobs["update/starcoder2-3b"] = dict(kind="update", cfg=r["tcfg"], params=r["tp"],
                                      tokens=r["tok"], plan_kw=dict(fsdp=True), lr=1e-2)
    # the fp8 knobs in bf16, as the reference tests run them
    for arch, knob in (("starcoder2-3b", "ag_fp8"), ("olmoe-1b-7b", "a2a_fp8")):
        jcfg, tcfg = configs(arch, "bfloat16")
        tp = convert.params_from_jax(jax_weights(jcfg), tcfg, device="cpu")
        for name, kw in (("base", {}), ("fp8", {knob: True})):
            jobs[f"{knob}/{name}"] = dict(kind="grads", cfg=tcfg, params=tp,
                                          tokens=tokens_for(tcfg),
                                          plan_kw=dict(fsdp=False, **kw))
    return jobs, refs


@pytest.fixture(scope="module")
def runs():
    jobs, refs = _cases()
    names = list(jobs)
    out = serve.spawn(train_jobs, ([jobs[n] for n in names],), mesh_shape=SHAPE,
                      transport="gloo", device="cpu", timeout=300)
    return {n: [out[r][i] for r in range(4)] for i, n in enumerate(names)}, refs


def test_sequence_sharded_loss_matches_single_device(runs):
    """starcoder2 (dense: no capacity in play), f32, tokens [4, 32] on the
    2x2 mesh without FSDP: ``train_loss`` called as the model function on
    every rank equals the port's and JAX's single device."""
    out, refs = runs
    ref = refs["starcoder2-3b"]
    single = float(M.train_loss(ref["tp"], {"tokens": torch.from_numpy(ref["tok"])},
                                ref["tcfg"], remat=False))
    for r in range(4):
        got = out["loss/starcoder2-3b"][r]["loss"]
        assert got == pytest.approx(single, rel=1e-5), (r, got, single)
        assert got == pytest.approx(ref["jax"][0], rel=1e-5)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "starcoder2-3b"])
def test_train_step_matches_single_device(runs, arch, variant):
    out, refs = runs
    res = out[f"grads/{arch}/{variant}"]
    plan = res[0]["plan"]
    assert (plan.fsdp_axis == "data") == (variant == "fsdp")
    assert plan.ring_attn == (variant == "ring") and plan.attn_mode == "head_tp"
    loss, grads = refs[arch]["jax"]
    for r in range(4):
        assert res[r]["loss"] == pytest.approx(loss, rel=1e-5), (r, res[r]["loss"], loss)
    keys = list(flatten(refs[arch]["tp"]))
    assert len(res[0]["grads"]) == len(grads) == len(keys)
    for key, got, want in zip(keys, res[0]["grads"], grads):
        np.testing.assert_allclose(got, want, err_msg=key, **GRAD_TOL)


def test_ring_attention_matches_megatron(runs):
    """deepseek-67b with 8 heads over 2 KV heads: ring attention's loss and
    gradients against the port's Megatron-SP path and JAX's single device."""
    out, refs = runs
    loss, grads = refs["deepseek-67b"]["jax"]
    ring, meg = out["grads/deepseek-67b/ring"][0], out["grads/deepseek-67b/base"][0]
    assert ring["plan"].ring_attn and ring["plan"].attn_mode == "head_tp"
    assert ring["loss"] == pytest.approx(meg["loss"], rel=1e-5)
    assert ring["loss"] == pytest.approx(loss, rel=1e-5)
    keys = list(flatten(refs["deepseek-67b"]["tp"]))
    for key, a, b, want in zip(keys, ring["grads"], meg["grads"], grads):
        np.testing.assert_allclose(a, b, err_msg=key, **GRAD_TOL)
        np.testing.assert_allclose(a, want, err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("knob", ["ag_fp8", "a2a_fp8"])
def test_fp8_knobs_close_to_baseline(runs, knob):
    """Mirrors of ``test_ag_fp8_close_to_baseline`` (starcoder2, the fp8
    sequence all-gather of the dense FFN) and
    ``test_a2a_fp8_close_to_baseline`` (olmoe, the fp8 dispatch): the loss
    within 5e-2 relative of the bf16 wire's; the knob does change it."""
    out, _ = runs
    base, fp8 = out[f"{knob}/base"][0], out[f"{knob}/fp8"][0]
    assert getattr(fp8["plan"], knob) and not getattr(base["plan"], knob)
    assert fp8["loss"] == pytest.approx(base["loss"], rel=5e-2)
    assert any(not np.array_equal(a, b) for a, b in zip(fp8["grads"], base["grads"]))


def _probe(seed):
    x = np.random.default_rng(seed).standard_normal((3, 5, 16)).astype(np.float32) * 2
    x[0, 0] = [1, 2, -3] + [0] * 13
    x[1, 1] = 0                                    # an all-zero row: scale 1
    x[2, 2, :2] = [4, -4]                          # a tie for the row's max
    w = np.random.default_rng(seed + 1).standard_normal(x.shape).astype(np.float32)
    return x, w


@pytest.mark.parametrize("which", ["all_gather", "dispatch"])
def test_fp8_wire_gradient_matches_jax(which):
    """JAX's gradient of the fp8 wire formats reaches x only through each
    row's scale (the e4m3 bytes travel as uint8); the port's equals
    ``jax.grad`` of the JAX function on one process, and is zero away from
    each row's largest magnitude."""
    x, w = _probe(7)
    if which == "all_gather":
        jf = lambda a: JC.fp8_all_gather(a, "model", JaxNullDist(), 1)      # noqa: E731
        tf = lambda a: TC.fp8_all_gather(a, "model", NullDist(), 1)         # noqa: E731
    else:
        jf = lambda a: JMOE.fp8_dispatch_a2a(a, "data", JaxNullDist())     # noqa: E731
        tf = lambda a: TMOE.fp8_dispatch_a2a(a, "data", NullDist())        # noqa: E731
    want = np.asarray(jax.grad(lambda a: jnp.sum(jf(a) * w))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    (tf(tx) * torch.from_numpy(w)).sum().backward()
    got = tx.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got[np.abs(x) < np.abs(x).max(-1, keepdims=True)] == 0).all()
    assert np.abs(got).max() > 0


def test_one_update_matches_single_device_trainer(runs):
    """One ``build_train_step`` update on the 2x2 mesh (FSDP on, lr 1e-2)
    against one step of the single-device ``Trainer`` from the same weights
    and tokens, gathered: the first moments (0.1 g) within the gradients'
    tolerance, and the parameters within 1e-5 wherever the step is a
    function of the gradient, |g| >= 1e-5. AdamW's first step moves a
    weight by lr (g / (|g| + eps) + decay), eps = 1e-8: where g is
    rounding noise near eps, the summation order moves the step by up to
    2 lr (one head weight of 32768 moved 1.6e-4), which is the bound
    there. The reduced olmoe routes every token to all 8 of its 8 experts,
    so its load-balance loss is constant and its whole router gradient is
    such noise; the update is held on starcoder2, olmoe's gradients
    above."""
    out, refs = runs
    ref = refs["starcoder2-3b"]
    res = out["update/starcoder2-3b"][0]
    tp = convert.tree_map(lambda t: t.clone(), ref["tp"])
    tr = Trainer(ref["tcfg"], TrainConfig(lr=1e-2, log_every=0), params=tp, device="cpu")
    loss = tr.train_step(ref["tok"])
    assert res["loss"] == pytest.approx(loss, rel=1e-5)
    assert res["step"] == int(tr.opt_state.step) == 1
    keys = list(flatten(tp))
    for key, got, want in zip(keys, res["m"], convert.tree_leaves(tr.opt_state.m)):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-6, err_msg=key)
    for key, got, want, m in zip(keys, res["params"], convert.tree_leaves(tr.params),
                                 convert.tree_leaves(tr.opt_state.m)):
        want, live = want.detach().numpy(), 10 * np.abs(m.numpy()) >= 1e-5
        np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
        assert np.abs(got - want).max() <= 2 * 1e-2 + 1e-5, key


def _unstack_specs(tree, jcfg):
    per = [jax.tree.map(lambda s: JP(*tuple(s)[1:]), p,
                        is_leaf=lambda s: isinstance(s, JP)) for p in tree["periods"]]
    n_per = jcfg.num_layers // len(jcfg.period)
    return [per[i % len(per)] for i in range(n_per * len(per))] + list(tree["rem"])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "starcoder2-3b", "gemma3-1b",
                                  "jamba-v0.1-52b", "deepseek-v3", "rwkv6-1.6b",
                                  "seamless-m4t-medium"])
def test_fsdp_spec_trees_match_jax(arch):
    """A training plan with FSDP: the port's spec tree equals
    ``abstract_model``'s (FSDP applied leaf by leaf before stacking), and
    the optimizer state's is ``optim.state_specs``'."""
    jcfg, tcfg = jax_reduced(jax_arch(arch)), reduced_config(get_arch(arch))
    cell = dict(seq_len=S, global_batch=B, kind="train")
    jplan = jax_make_plan(jcfg, JShapeCell("t", **cell), AXES, SHAPE)
    tplan = make_plan(tcfg, ShapeCell("t", **cell), AXES, SHAPE)
    assert repr(jplan) == repr(tplan) and tplan.fsdp_axis == "data"
    jspecs = JS.abstract_model(jcfg, jplan)[1]
    jspecs = dict(jspecs, stack=_unstack_specs(jspecs["stack"], jcfg))
    if "encoder" in jspecs:
        enc = jcfg.replace(num_layers=jcfg.encoder_layers,
                           period=(JLayerSpec(mixer="attn", ffn="dense"),))
        jspecs["encoder"] = _unstack_specs(jspecs["encoder"], enc)
    tspecs = SP.param_specs(tcfg, tplan)
    flat = dict(zip(flatten(tspecs_as_tree(tspecs)), SP.spec_leaves(tspecs)))
    jflat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): s
             for path, s in jax.tree_util.tree_flatten_with_path(
                 jspecs, is_leaf=lambda s: isinstance(s, JP))[0]}
    assert set(flat) == set(jflat)
    for k in flat:
        assert tuple(flat[k]) == tuple(jflat[k]), (k, flat[k], jflat[k])
    ostate = optim.state_specs(tspecs)
    assert tuple(ostate.step) == () and ostate.m is tspecs and ostate.v is tspecs


def tspecs_as_tree(specs):
    """The spec tree with each ``P`` leaf replaced by a placeholder, so that
    ``flatten`` gives its leaves' paths."""
    if isinstance(specs, SP.P):
        return 0
    if isinstance(specs, dict):
        return {k: tspecs_as_tree(v) for k, v in specs.items()}
    return [tspecs_as_tree(v) for v in specs]


def test_jamba_waits_for_the_sharded_mamba_mixer(runs):
    """The reference test's third case, jamba, now runs: the train step of
    the reduced jamba (seven Mamba layers and an attention layer, d_inner
    and the sequence over model) on the 2x2 mesh, FSDP off and on, against
    JAX's single-device loss (1e-5) and ``jax.grad`` (the tolerance of
    ``test_torch_train_loss.py``). Its Mamba gradients need the psum whose
    backward is a psum (``Dist.psum_for_shards``)."""
    for variant in ("base", "fsdp"):
        _check_train_step(runs, "jamba-v0.1-52b", variant)


@pytest.mark.parametrize("variant", ["base", "fsdp"])
def test_deepseek_v3_train_step_matches_single_device(runs, variant):
    """The reduced deepseek-v3 (sequence-sharded MLA, replicated weights;
    MoE with a shared expert): the train step on the 2x2 mesh, FSDP off
    and on, against JAX's single device."""
    res = _check_train_step(runs, "deepseek-v3", variant)
    assert res[0]["plan"].attn_mode == "replicated"


@pytest.mark.parametrize("variant", ["base", "fsdp"])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "seamless-m4t-medium"])
def test_rwkv_and_encdec_train_steps_match_single_device(runs, arch, variant):
    """The reduced rwkv6 (the WKV heads and d_ff over model, 4 heads of 16)
    and seamless (the encoder on the sequence-sharded frames, head-TP
    self- and cross-attention over the sequence-sharded encoder output):
    the train step on the 2x2 mesh, FSDP off and on (the encoder's layers
    and ``enc_norm`` gathered where they run), against JAX's single-device
    loss (1e-5) and ``jax.grad``."""
    res = _check_train_step(runs, arch, variant)
    assert res[0]["plan"].attn_mode == ("head_tp" if arch == "seamless-m4t-medium"
                                        else "replicated")


def test_moe_config_without_a_moe_layer_trains_across_ranks(runs):
    """jamba cut to its first layer (Mamba and a dense FFN: a MoE config with
    no MoE layer, as ``chip_smoke.py``'s jamba gate runs it): the train step
    on the 2x2 mesh with FSDP against the port's single device. The loss
    used to psum its load-balance term, a Python 0.0 with no MoE layer, and
    raise."""
    _check_train_step(runs, "jamba-1-layer", "fsdp")


def _check_train_step(runs, arch, variant):
    out, refs = runs
    res = out[f"grads/{arch}/{variant}"]
    assert (res[0]["plan"].fsdp_axis == "data") == (variant == "fsdp")
    loss, grads = refs[arch]["jax"]
    for r in range(4):
        assert res[r]["loss"] == pytest.approx(loss, rel=1e-5), (r, res[r]["loss"], loss)
    keys = list(flatten(refs[arch]["tp"]))
    assert len(res[0]["grads"]) == len(grads) == len(keys)
    for key, got, want in zip(keys, res[0]["grads"], grads):
        np.testing.assert_allclose(got, want, err_msg=key, **GRAD_TOL)
    return res


# ---------------------------------------------------------------------------
# the reference's own sharded training (queue 3), one subprocess
# ---------------------------------------------------------------------------

JAX_SHARDED = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch, reduced_config
from repro.configs.base import ShapeCell
from repro.launch import steps as S
from repro.launch.mesh import make_mesh
from repro.models import model as M
from repro.sharding.dist import Dist, NullDist
from repro.sharding.plans import make_plan, null_plan
B, Sq = 4, 32
HEADS = {heads!r}
out_path = {out!r}
def cfg_of(arch):
    return reduced_config(get_arch(arch)).replace(dtype="float32", **HEADS[arch])
def put(tree, specs, mesh):
    return jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs,
                        is_leaf=lambda s: isinstance(s, P))
def run(arch, shape, grads=False, **kw):
    cfg = cfg_of(arch)
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, Sq)).astype(np.int32)
    params, _ = M.init_model(cfg, null_plan("train"), jax.random.PRNGKey(0))
    mesh = make_mesh(shape, ("data", "model"))
    plan = make_plan(cfg, ShapeCell("t", Sq, B, "train"), ("data", "model"), shape,
                     fsdp=False, **kw)
    pspecs = S.abstract_model(cfg, plan)[1]
    dist = Dist(dict(zip(("data", "model"), shape)))
    def step(p, batch):
        f = lambda q: M.train_loss(q, batch, cfg, plan, dist, remat=False)
        if not grads:
            return f(p)
        loss, g = jax.value_and_grad(f)(p)
        return loss, S.reduce_grads(g, pspecs, plan, dist)
    bspec = {{"tokens": P(plan.batch_axes, plan.seq_axis)}}
    outs = P() if not grads else (P(), pspecs)
    fn = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(pspecs, bspec), out_specs=outs,
                               check_vma=False))
    with mesh:
        res = fn(put(params, pspecs, mesh),
                 {{"tokens": jax.device_put(tok, NamedSharding(mesh, bspec["tokens"]))}})
    return res
out, arrays = {{}}, {{}}
for shape in ((2, 1), (2, 2)):
    loss, g = run("olmoe-1b-7b", shape, grads=True)
    out[f"olmoe/{{shape[0]}}x{{shape[1]}}"] = float(loss)
    for i, leaf in enumerate(jax.tree.leaves(g)):
        arrays[f"{{shape[0]}}x{{shape[1]}}/{{i}}"] = np.asarray(leaf)
out["starcoder2/2x2"] = float(run("starcoder2-3b", (2, 2)))
out["deepseek67b/2x2/megatron"] = float(run("deepseek-67b", (2, 2)))
out["deepseek67b/2x2/ring"] = float(run("deepseek-67b", (2, 2), ring_attn=True))
np.savez(out_path, **arrays)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_sharded") / "grads.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=4").strip())
    code = JAX_SHARDED.format(heads=HEADS, out=str(out))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    import json
    losses = json.loads(proc.stdout.strip().splitlines()[-1])
    with np.load(out) as z:
        arrays = dict(z)
    return losses, arrays


def _jax_grad_leaves(arrays, mesh, like):
    """The JAX step's gradients on `mesh` ("2x1" ...) in the port's leaf
    order (their tree is JAX's params tree: `like`)."""
    flat = [arrays[f"{mesh}/{i}"] for i in range(len(jax.tree.leaves(like)))]
    tree = jax.tree.unflatten(jax.tree.structure(like), flat)
    cfg = configs("olmoe-1b-7b")[1]
    return [t.numpy() for t in convert.tree_leaves(
        convert.params_from_jax(tree, cfg, device="cpu"))]


def test_reference_data_parallel_gradient_is_twice_single_device(runs, jax_sharded):
    """The reference's gradient factor: on a data-only (2, 1) mesh JAX's
    step (value_and_grad in ``shard_map``, then ``reduce_grads``) gives
    exactly dp = 2 times its single-device gradient, leaf for leaf, while
    its loss is right; the port's equals the single device."""
    losses, arrays = jax_sharded
    _, refs = runs
    ref = refs["olmoe-1b-7b"]
    loss, single = ref["jax"]
    assert losses["olmoe/2x1"] == pytest.approx(loss, rel=1e-5)
    for got, want in zip(_jax_grad_leaves(arrays, "2x1", ref["jp"]), single):
        np.testing.assert_allclose(got, 2 * want, **GRAD_TOL)


def test_reference_sharded_training_misses_its_single_device(runs, jax_sharded):
    """On (2, 2): the reference's loss misses its single device's by far
    more than f32 noise (its cross entropy reduces different positions
    over the vocab axis, its embedding psums them), and its gradients are
    not one multiple of the single device's; its ring attention misses
    its own Megatron-SP path. The port's cases above hold all three to
    1e-5."""
    losses, arrays = jax_sharded
    out, refs = runs
    for arch, key in (("olmoe-1b-7b", "olmoe/2x2"), ("starcoder2-3b", "starcoder2/2x2")):
        single = refs[arch]["jax"][0]
        assert abs(losses[key] - single) / single > 1e-4, (arch, losses[key], single)
    ratios = []
    for got, want in zip(_jax_grad_leaves(arrays, "2x2", refs["olmoe-1b-7b"]["jp"]),
                         refs["olmoe-1b-7b"]["jax"][1]):
        if np.abs(want).sum() > 0:
            ratios.append(np.abs(got).sum() / np.abs(want).sum())
    assert max(ratios) / min(ratios) > 1.5, ratios
    meg, ring = losses["deepseek67b/2x2/megatron"], losses["deepseek67b/2x2/ring"]
    assert abs(ring - meg) / meg > 1e-4, (ring, meg)
    assert out["grads/deepseek-67b/ring"][0]["loss"] == pytest.approx(
        refs["deepseek-67b"]["jax"][0], rel=1e-5)
