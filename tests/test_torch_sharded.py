"""Sharded serving of the port against the JAX package, on reduced configs:
four gloo ranks on the CPU as a 2x2 ("data", "model") mesh stand in for
the reference's ``--xla_force_host_platform_device_count``.

- The port's spec trees equal ``abstract_model`` / ``abstract_cache``'s
  (olmoe, gemma3, deepseek-v3, jamba, rwkv6 and seamless with its encoder,
  prefill and decode at (2, 2); deepseek-67b's ffn_2d); reduced rwkv6 and
  seamless serve on the mesh as on one device.
- Mirrors of ``test_decode_step_matches_single_device`` (olmoe, gemma3)
  and ``test_ffn_2d_decode_matches_baseline`` (deepseek-67b): the port's
  4-rank decode against the JAX single-device logits on converted
  weights, under the JAX test's rules (max |diff| < 0.05 in bf16, argmax
  flips only where the reference's top-2 margin is under 0.05); in f32
  within 1e-4 of the port's own single-device logits.
- Decode past the first KV shard (olmoe): prefill 16 tokens, re-lay the
  caches out for 32, decode positions 16-20 on model rank 1's shard,
  against JAX single-device each step.
- The fp8 dispatch: the port's 4-rank decode with ``a2a_fp8`` against
  JAX's sharded decode at the same plan (a subprocess on 4 forced host
  devices), max |diff| < 0.05.
- Sharded prefill: its next token and its gathered caches against JAX's
  single-device prefill (f32 1e-4; bf16 0.05, or 1.5x the distance of the
  port's own single-device caches from JAX where bf16 rounding alone
  exceeds that), and the re-layout of ``pad_to_capacity`` against JAX's
  global pad.
- The expert move between the prefill and decode layouts, and the
  launcher ``python -m repro_torch.launch.serve --device cpu``.
"""
import dataclasses
import json
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
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import common as JC  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro.sharding.dist import NullDist as JaxNullDist  # noqa: E402
from repro.sharding.plans import make_plan as jax_make_plan  # noqa: E402
from repro.sharding.plans import null_plan as jax_null_plan  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.sharding import specs as SP  # noqa: E402
from repro_torch.sharding.plans import make_plan, null_plan  # noqa: E402
from torch_sharded_workers import reshard_experts, run_jobs  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
AXES, SHAPE = ("data", "model"), (2, 2)
MESH = Mesh(SHAPE, AXES)
B, CAP, PROMPT = 8, 32, 16
NEAR_TIE = 0.05
SERVE_STEPS = 5
ARCH_KW = {"olmoe-1b-7b": dict(num_heads=4, num_kv_heads=2),
           "gemma3-1b": dict(num_heads=4, num_kv_heads=2),
           "deepseek-67b": dict(num_heads=4, num_kv_heads=2, d_ff=128),
           "deepseek-v3": {}, "jamba-v0.1-52b": {}, "rwkv6-1.6b": {},
           "seamless-m4t-medium": {}}


def configs(arch, dtype=None):
    """(JAX config, port config), reduced; rwkv6's WKV heads 16 wide, as a
    reduced launcher job's (one head of 64 does not split over model)."""
    kw = dict(ARCH_KW[arch], **({"dtype": dtype} if dtype else {}))
    j, t = jax_reduced(jax_arch(arch)).replace(**kw), reduced_config(get_arch(arch)).replace(**kw)
    if arch == "rwkv6-1.6b":
        hd = serve.REDUCED_RWKV_HEAD_DIM
        j = j.replace(rwkv=dataclasses.replace(j.rwkv, head_dim=hd))
        t = t.replace(rwkv=dataclasses.replace(t.rwkv, head_dim=hd))
    return j, t


def weights(jcfg, tcfg):
    jp, _ = JM.init_model(jcfg, jax_null_plan("decode"), jax.random.PRNGKey(0))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def decode_tokens(cfg):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(2), (B, 1), 0,
                                         cfg.vocab_size))


def prompt_tokens(cfg):
    return np.random.default_rng(3).integers(1, cfg.vocab_size, (B, PROMPT)).astype(np.int32)


def jax_decode_logits(jp, jcfg, tok):
    plan = jax_null_plan("decode")
    caches, _ = JM.init_cache(jcfg, plan, B, CAP)
    d = JaxNullDist()
    x = JC.embed(jp["embed"], jnp.asarray(tok), jcfg, plan, d)
    x, _, _ = JT.apply_stack(jp["stack"], x, jcfg, plan, d, mode="decode",
                             caches=caches, pos=jnp.int32(0))
    x = JC.rms_norm(x, jp["final_norm"]["scale"], jcfg.norm_eps)
    return np.asarray(JC.lm_logits(jp["embed"], x, jcfg, plan, d)[:, 0], np.float32)


def jax_serve_logits(jp, jcfg, prompt, feed):
    """JAX single-device prefill of `prompt` [B, P], the caches padded to
    CAP, then decode of `feed` [B, n] at positions P, P + 1, ...: each
    step's logits [n, B, V]."""
    plan, d = jax_null_plan("decode"), JaxNullDist()
    _, caches = JM.prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg,
                           jax_null_plan("prefill"), d)
    caches = jkv.pad_to_capacity(jcfg, caches, prompt.shape[1], CAP)
    out = []
    for i in range(feed.shape[1]):
        x = JC.embed(jp["embed"], jnp.asarray(feed[:, i:i + 1]), jcfg, plan, d)
        x, caches, _ = JT.apply_stack(jp["stack"], x, jcfg, plan, d, mode="decode",
                                      caches=caches, pos=jnp.int32(prompt.shape[1] + i))
        x = JC.rms_norm(x, jp["final_norm"]["scale"], jcfg.norm_eps)
        out.append(np.asarray(JC.lm_logits(jp["embed"], x, jcfg, plan, d)[:, 0], np.float32))
    return np.stack(out)


def f32(a):
    return np.asarray(a, np.float32)


def assert_close_with_near_ties(ref, got, tol=0.05):
    """The JAX test's rule: max |diff| < tol, and a greedy flip only where
    the reference's top-2 margin is itself under NEAR_TIE."""
    ref, got = f32(ref), f32(got)
    assert np.abs(ref - got).max() < tol, np.abs(ref - got).max()
    for b in range(ref.shape[0]):
        if ref[b].argmax() != got[b].argmax():
            top2 = np.sort(ref[b])[-2:]
            assert top2[1] - top2[0] < NEAR_TIE, (b, top2)


# ---------------------------------------------------------------------------
# the jobs, run once on 4 ranks
# ---------------------------------------------------------------------------

def _jobs():
    jobs, refs = {}, {}
    for arch in ("olmoe-1b-7b", "gemma3-1b"):
        for dt in ("bfloat16", "float32"):
            jcfg, tcfg = configs(arch, dt)
            jp, tp = weights(jcfg, tcfg)
            tok = decode_tokens(jcfg)
            name = f"decode/{arch}/{dt}"
            jobs[name] = dict(kind="decode", cfg=tcfg, params=tp, batch=B, seq=CAP,
                              tokens=tok, pos=0)
            refs[name] = dict(jax=jax_decode_logits(jp, jcfg, tok), jp=jp, tp=tp,
                              jcfg=jcfg, tcfg=tcfg, tok=tok)
            ptok = prompt_tokens(jcfg)
            name = f"prefill/{arch}/{dt}"
            jobs[name] = dict(kind="prefill", cfg=tcfg, params=tp, batch=B, seq=PROMPT,
                              tokens=ptok, to_seq=CAP)
            refs[name] = dict(jp=jp, tp=tp, jcfg=jcfg, tcfg=tcfg, tok=ptok)
            if arch == "olmoe-1b-7b":
                # decode past S / tp: positions 16-20 land on model rank 1
                feed = np.random.default_rng(4).integers(
                    1, jcfg.vocab_size, (B, SERVE_STEPS)).astype(np.int32)
                name = f"serve/{arch}/{dt}"
                jobs[name] = dict(kind="serve", cfg=tcfg, params=tp, batch=B,
                                  seq=PROMPT, to_seq=CAP, tokens=ptok, feed=feed)
                refs[name] = dict(jax=jax_serve_logits(jp, jcfg, ptok, feed), tp=tp,
                                  tcfg=tcfg, tok=ptok, feed=feed)
    jcfg, tcfg = configs("olmoe-1b-7b")
    jobs["decode/olmoe-1b-7b/fp8"] = dict(jobs["decode/olmoe-1b-7b/bfloat16"],
                                          plan_kw={"a2a_fp8": True})
    jcfg, tcfg = configs("deepseek-67b")
    jp, tp = weights(jcfg, tcfg)
    tok = decode_tokens(jcfg)
    for name, kw in (("base", {}), ("ffn2d", {"ffn_2d": True})):
        jobs[f"decode/deepseek-67b/{name}"] = dict(kind="decode", cfg=tcfg, params=tp,
                                                   batch=B, seq=CAP, tokens=tok, pos=0,
                                                   plan_kw=kw)
    refs["decode/deepseek-67b"] = dict(jax=jax_decode_logits(jp, jcfg, tok))
    # the mixers of item 5c-ii, served from the port's own weights
    for arch in ("rwkv6-1.6b", "seamless-m4t-medium"):
        _, tcfg = configs(arch, "float32")
        tp = M.init_model(tcfg, None, seed=0, device="cpu")
        ptok = prompt_tokens(tcfg)
        feed = np.random.default_rng(4).integers(1, tcfg.vocab_size,
                                                 (B, SERVE_STEPS)).astype(np.int32)
        name = f"serve/{arch}/float32"
        jobs[name] = dict(kind="serve", cfg=tcfg, params=tp, batch=B, seq=PROMPT,
                          to_seq=CAP, tokens=ptok, feed=feed)
        refs[name] = dict(tp=tp, tcfg=tcfg, tok=ptok, feed=feed)
        if tcfg.is_encoder_decoder:
            jobs[name]["frames"] = refs[name]["frames"] = serve.frames(
                tcfg.d_model, B, PROMPT, 0)
    return jobs, refs


@pytest.fixture(scope="module")
def runs():
    jobs, refs = _jobs()
    names = list(jobs)
    out = serve.spawn(run_jobs, ([jobs[n] for n in names],), mesh_shape=SHAPE,
                      transport="gloo", device="cpu", timeout=300)
    return {n: [out[r][i] for r in range(4)] for i, n in enumerate(names)}, refs


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------

def _unstack_specs(tree, jcfg):
    """JAX's period-stacked spec tree -> the port's per-layer list, the
    leading period dim dropped."""
    per = [jax.tree.map(lambda s: JP(*tuple(s)[1:]), p,
                        is_leaf=lambda s: isinstance(s, JP)) for p in tree["periods"]]
    n_per = jcfg.num_layers // len(jcfg.period)
    return [per[i % len(per)] for i in range(n_per * len(per))] + list(tree["rem"])


def _jax_param_specs(jcfg, jplan):
    """``abstract_model``'s spec tree with the decoder and encoder stacks
    unstacked."""
    jspecs = JS.abstract_model(jcfg, jplan)[1]
    out = dict(jspecs, stack=_unstack_specs(jspecs["stack"], jcfg))
    if "encoder" in jspecs:
        enc = jcfg.replace(num_layers=jcfg.encoder_layers,
                           period=(JLayerSpec(mixer="attn", ffn="dense"),))
        out["encoder"] = _unstack_specs(jspecs["encoder"], enc)
    return out


def _same_tree(port, jx):
    if isinstance(port, SP.P):
        assert tuple(port) == tuple(jx), (port, jx)
        return
    if isinstance(port, dict):
        assert set(port) == set(jx), (set(port), set(jx))
        for k in port:
            _same_tree(port[k], jx[k])
        return
    assert len(port) == len(jx)
    for a, b in zip(port, jx):
        _same_tree(a, b)


@pytest.mark.parametrize("arch,kind,kw", [
    ("olmoe-1b-7b", "prefill", {}), ("olmoe-1b-7b", "decode", {}),
    ("gemma3-1b", "prefill", {}), ("gemma3-1b", "decode", {}),
    ("deepseek-67b", "decode", {"ffn_2d": True}),
    ("deepseek-v3", "prefill", {}), ("deepseek-v3", "decode", {}),
    ("jamba-v0.1-52b", "prefill", {}), ("jamba-v0.1-52b", "decode", {}),
    ("rwkv6-1.6b", "prefill", {}), ("rwkv6-1.6b", "decode", {}),
    ("seamless-m4t-medium", "prefill", {}), ("seamless-m4t-medium", "decode", {})])
def test_spec_trees_match_jax(arch, kind, kw):
    """The port's param and cache spec trees against ``abstract_model`` and
    ``abstract_cache``, leaf for leaf. One departure: a prefill plan's MLA
    cache leaves are the prefill's own, each rank of the kv axis holding
    its positions (JAX gives them its decode layout, replicated over
    model, so that its sharded prefill keeps one rank's positions:
    ``test_torch_sharded_mixers.py``)."""
    jcfg, tcfg = configs(arch)
    seq = PROMPT if kind == "prefill" else CAP
    jplan = jax_make_plan(jcfg, JShapeCell("c", seq, B, kind), AXES, SHAPE, fsdp=False, **kw)
    tplan = make_plan(tcfg, ShapeCell("c", seq, B, kind), AXES, SHAPE, fsdp=False, **kw)
    assert repr(jplan) == repr(tplan)
    if kw.get("ffn_2d"):
        assert tplan.ffn_2d
    _same_tree(SP.param_specs(tcfg, tplan), _jax_param_specs(jcfg, jplan))
    jc = _unstack_specs(JS.abstract_cache(jcfg, jplan, B, seq)[1], jcfg)
    if tcfg.attn_kind == "mla" and kind == "prefill":
        assert all(tuple(la["mixer"]["c_kv"])[1:] == (None, None) for la in jc)
        jc = [{"mixer": {k: JP(s[0], "model", None) for k, s in la["mixer"].items()}}
              for la in jc]
    _same_tree(SP.cache_specs(tcfg, tplan, B, seq), jc)


def test_specs_refuse_what_this_slice_does_not_shard(runs):
    """Nothing the port runs is refused under a sharded plan any more (the
    RWKV and cross-attention refusals of item 5c went with its second
    part): rwkv6 and seamless get JAX's spec trees in decode and in
    training with FSDP (the encoder's layers and ``enc_norm`` among them),
    ``build_cell`` gives their train step, as it gives olmoe's,
    deepseek-v3's and jamba's; and the sharded call runs: prefill of
    PROMPT tokens (seamless: and frames), the caches re-laid out for CAP,
    and SERVE_STEPS decode steps on the 2x2 mesh give the port's
    single-device logits within 1e-4 (f32)."""
    for arch in ("rwkv6-1.6b", "seamless-m4t-medium"):
        jcfg, cfg = configs(arch)
        for kind, seq in (("decode", CAP), ("train", 32)):
            jplan = jax_make_plan(jcfg, JShapeCell("c", seq, B, kind), AXES, SHAPE)
            plan = make_plan(cfg, ShapeCell("c", seq, B, kind), AXES, SHAPE)
            assert repr(jplan) == repr(plan)
            _same_tree(SP.param_specs(cfg, plan), _jax_param_specs(jcfg, jplan))
        out, refs = runs
        ref = refs[f"serve/{arch}/float32"]
        batch = {"tokens": torch.from_numpy(ref["tok"])}
        if "frames" in ref:
            batch["frames"] = torch.from_numpy(ref["frames"])
        enc_len = CAP if ref["tcfg"].is_encoder_decoder else 0
        with torch.no_grad():
            _, caches = M.prefill(ref["tp"], batch, ref["tcfg"])
            caches = kvcache.pad_to_capacity(ref["tcfg"], caches, PROMPT, CAP)
            want = []
            for i in range(SERVE_STEPS):
                lg, caches = M.decode_logits(ref["tp"], caches,
                                             torch.from_numpy(ref["feed"][:, i:i + 1]),
                                             PROMPT + i, ref["tcfg"], enc_len=enc_len)
                want.append(lg[:, 0].numpy())
        got = out[f"serve/{arch}/float32"][0]["logits"]
        np.testing.assert_allclose(got, np.stack(want), atol=1e-4, rtol=1e-4)
    for arch in ("olmoe-1b-7b", "deepseek-v3", "jamba-v0.1-52b", "rwkv6-1.6b",
                 "seamless-m4t-medium"):
        cfg = configs(arch)[1]
        step, plan = steps.build_cell(cfg, ShapeCell("t", 32, B, "train"), MESH,
                                      transport="gloo")
        assert plan.fsdp_axis == "data" and isinstance(step, steps.TrainStep)


def test_build_cell_binds_local_shapes():
    """A decode cell on rank 3 of the 2x2 mesh: its plan, and the local
    shapes of its inputs and caches (batch over data, positions over
    model). The transport is the caller's: a builder given neither a Dist
    nor a transport refuses."""
    cfg = configs("olmoe-1b-7b")[1]
    step, plan = steps.build_cell(cfg, ShapeCell("d", CAP, B, "decode"),
                                  Mesh(SHAPE, AXES, 3), transport="gloo")
    assert plan.kind == "decode" and plan.ep_axis == "data"
    assert step.local_shapes == {"tokens": (B // 2, 1), "cache": (B // 2, 2, CAP // 2, 16)}
    assert step.dist.index("model") == 1 and step.dist.transport == "gloo"
    pstep, pplan = steps.build_cell(cfg, ShapeCell("p", PROMPT, B, "prefill"), MESH,
                                    transport="gloo")
    assert pstep.local_shapes["tokens"] == (B // 2, PROMPT // 2) and pplan.ep_axis == "model"
    with pytest.raises(TypeError, match="transport"):
        steps.build_cell(cfg, ShapeCell("d", CAP, B, "decode"), MESH)
    with pytest.raises(ValueError, match="transport None"):
        steps.build_decode_step(cfg, ShapeCell("d", CAP, B, "decode"), plan, MESH)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma3-1b"])
def test_decode_step_matches_single_device(runs, arch):
    """bf16: the port's 4-rank logits against JAX single-device, the JAX
    test's rule; every rank gathers the same logits."""
    out, refs = runs
    res = out[f"decode/{arch}/bfloat16"]
    for r in range(1, 4):
        np.testing.assert_array_equal(res[r]["logits"], res[0]["logits"])
    # a full-attention layer's k: batch over data, positions over model
    assert res[0]["local_cache_shape"] == (B // 2, 2, CAP // 2, 16)
    assert_close_with_near_ties(refs[f"decode/{arch}/bfloat16"]["jax"],
                                res[0]["logits"][:, 0])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma3-1b"])
def test_decode_f32_matches_port_single_device(runs, arch):
    out, refs = runs
    ref = refs[f"decode/{arch}/float32"]
    caches = M.init_cache(ref["tcfg"], null_plan("decode"), B, CAP, device="cpu")
    lg, _ = M.decode_logits(ref["tp"], caches, torch.tensor(ref["tok"]), 0,
                            ref["tcfg"])
    got = out[f"decode/{arch}/float32"][0]["logits"]
    np.testing.assert_allclose(got, lg.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got[:, 0], ref["jax"], atol=1e-4, rtol=1e-4)


def test_ffn_2d_decode_matches_baseline(runs):
    """deepseek-67b: the ffn_2d plan's greedy tokens against the baseline
    plan's (at most one near-tie flip, the JAX test's rule), and both
    against JAX single-device."""
    out, refs = runs
    base = out["decode/deepseek-67b/base"][0]
    two = out["decode/deepseek-67b/ffn2d"][0]
    assert out["decode/deepseek-67b/ffn2d"][0]["plan"].ffn_2d
    match = int((base["token"] == two["token"]).sum())
    assert match >= B - 1, (base["token"], two["token"])
    for res in (base, two):
        assert_close_with_near_ties(refs["decode/deepseek-67b"]["jax"], res["logits"][:, 0])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_past_the_first_kv_shard_matches_single_device(runs, dtype):
    """olmoe: prefill 16 tokens, re-lay the caches out for 32 positions
    (16 a model rank), then decode positions 16-20, which model rank 1
    owns: its owner write (local row p - 16) and the log-sum-exp merge of
    two non-empty shards over the real Dist. Each step's logits against
    JAX single-device (prefill, global pad, decode) under the JAX test's
    rules; in f32 also within 1e-4 of the port's own single device."""
    out, refs = runs
    ref = refs[f"serve/olmoe-1b-7b/{dtype}"]
    res = out[f"serve/olmoe-1b-7b/{dtype}"]
    for r in range(4):
        np.testing.assert_array_equal(res[r]["logits"], res[0]["logits"])
        want = list(range(SERVE_STEPS)) if r % 2 else list(range(PROMPT))
        assert res[r]["filled"] == want, (r, res[r]["filled"])
    got = res[0]["logits"]
    assert got.shape[0] == SERVE_STEPS
    if dtype == "bfloat16":
        for step in range(SERVE_STEPS):
            assert_close_with_near_ties(ref["jax"][step], got[step])
        return
    tcfg = ref["tcfg"]
    with torch.no_grad():
        _, caches = M.prefill(ref["tp"], {"tokens": torch.from_numpy(ref["tok"])}, tcfg)
        caches = kvcache.pad_to_capacity(tcfg, caches, PROMPT, CAP)
        single = []
        for i in range(SERVE_STEPS):
            lg, caches = M.decode_logits(ref["tp"], caches,
                                         torch.from_numpy(ref["feed"][:, i:i + 1]),
                                         PROMPT + i, tcfg)
            single.append(lg[:, 0].numpy())
    np.testing.assert_allclose(got, np.stack(single), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, ref["jax"], atol=1e-4, rtol=1e-4)


JAX_FP8 = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch, reduced_config
from repro.configs.base import ShapeCell
from repro.launch import steps as S
from repro.launch.mesh import make_mesh
from repro.models import model as M
from repro.models import transformer as tf
from repro.models.layers import common
from repro.sharding.dist import Dist
from repro.sharding.plans import make_plan, null_plan
cfg = reduced_config(get_arch("olmoe-1b-7b")).replace(num_heads=4, num_kv_heads=2)
B, cap = 8, 32
mesh = make_mesh((2, 2), ("data", "model"))
params0, _ = M.init_model(cfg, null_plan("decode"), jax.random.PRNGKey(0))
caches0, _ = M.init_cache(cfg, null_plan("decode"), B, cap)
tok = jax.random.randint(jax.random.PRNGKey(2), (B, 1), 0, cfg.vocab_size)
plan = make_plan(cfg, ShapeCell("d", cap, B, "decode"), ("data", "model"), (2, 2),
                 fsdp=False, a2a_fp8=True)
pspecs = S.abstract_model(cfg, plan)[1]
cspecs = S.abstract_cache(cfg, plan, B, cap)[1]
dist = Dist(dict(data=2, model=2))
def step(p, c, t, pos):
    x = common.embed(p["embed"], t, cfg, plan, dist)
    x, _, _ = tf.apply_stack(p["stack"], x, cfg, plan, dist, mode="decode",
                             caches=c, pos=pos)
    x = common.rms_norm(x, p["final_norm"]["scale"], cfg.norm_eps)
    lg = common.lm_logits(p["embed"], x, cfg, plan, dist)
    return dist.all_gather(lg, plan.vocab_axis, dim=-1)
put = lambda tree, sp: jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                                    tree, sp, is_leaf=lambda s: isinstance(s, P))
tok_spec = P(plan.batch_axes, None)
f = jax.jit(jax.shard_map(step, mesh=mesh, in_specs=(pspecs, cspecs, tok_spec, P()),
                          out_specs=P(plan.batch_axes, None, None), check_vma=False))
with mesh:
    lg = f(put(params0, pspecs), put(caches0, cspecs),
           jax.device_put(tok, NamedSharding(mesh, tok_spec)), jnp.int32(0))
print(json.dumps(np.asarray(lg[:, 0], np.float32).tolist()))
"""


def test_fp8_dispatch_matches_jax_sharded(runs):
    """The fp8 (e4m3) dispatch all-to-all: the port's 4-rank logits against
    JAX's sharded decode at the same (2, 2) plan and weights."""
    out, _ = runs
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=4").strip())
    proc = subprocess.run([sys.executable, "-c", JAX_FP8], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = np.asarray(json.loads(proc.stdout.strip().splitlines()[-1]))
    got = out["decode/olmoe-1b-7b/fp8"][0]["logits"][:, 0]
    assert np.abs(got - ref).max() < 0.05, np.abs(got - ref).max()
    assert out["decode/olmoe-1b-7b/fp8"][0]["plan"].a2a_fp8
    # the quantized dispatch does change the logits
    assert not np.array_equal(got, out["decode/olmoe-1b-7b/bfloat16"][0]["logits"][:, 0])


# ---------------------------------------------------------------------------
# prefill, and the caches it leaves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma3-1b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sharded_prefill_matches_jax(runs, arch, dtype):
    """Next token, the caches gathered from the ranks (k, v sequence-sharded
    over model and batch-sharded over data; gemma3's rings assembled across
    the sequence ranks) and their re-layout for a capacity of 32, against
    JAX's single-device prefill and its global pad."""
    out, refs = runs
    ref = refs[f"prefill/{arch}/{dtype}"]
    jcfg, tcfg = ref["jcfg"], ref["tcfg"]
    jtok, jcaches = JM.prefill(ref["jp"], {"tokens": jnp.asarray(ref["tok"])}, jcfg,
                               jax_null_plan("prefill"), JaxNullDist())
    res = out[f"prefill/{arch}/{dtype}"]
    # the port's own single-device prefill on the same weights: its bf16
    # distance from JAX is the framework's rounding noise (bf16 k, v reach
    # |4| in gemma3's deeper layers, where one spacing is 0.03)
    _, single = M.prefill(ref["tp"], {"tokens": torch.from_numpy(ref["tok"])}, tcfg)
    single = {"caches": single, "padded": kvcache.pad_to_capacity(tcfg, single, PROMPT, CAP)}
    pre_plan = res[0]["plan"]
    dec_plan = make_plan(tcfg, ShapeCell("d", CAP, B, "decode"), AXES, SHAPE, fsdp=False)
    for key, plan, jc in (("caches", pre_plan, jcaches),
                          ("padded", dec_plan, jkv.pad_to_capacity(jcfg, jcaches, PROMPT, CAP))):
        got = convert.gather_tree([res[r][key] for r in range(4)],
                                  SP.cache_specs(tcfg, plan), MESH)
        want = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
        for g_layer, w_layer, s_layer in zip(got, want, single[key]):
            for n in ("k", "v"):
                g, w = g_layer["mixer"][n], w_layer["mixer"][n].float().numpy()
                assert g.shape == w.shape, (key, n)
                if dtype == "float32":
                    np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
                    continue
                noise = np.abs(s_layer["mixer"][n].float().numpy() - w).max()
                assert np.abs(g - w).max() <= max(0.05, 1.5 * noise), (key, n, noise)
    jt = np.asarray(jtok)
    if dtype == "float32":
        np.testing.assert_array_equal(res[0]["token"], jt)
    else:
        assert int((res[0]["token"] == jt).sum()) >= B - 1


def test_pad_to_capacity_relayout_positions(runs):
    """After the re-layout, rank (d, m) holds positions [16m, 16m + 16) of
    its batch rows: the prompt's 16 positions all on model rank 0."""
    out, _ = runs
    res = out["prefill/olmoe-1b-7b/float32"]
    for r in range(4):
        k = res[r]["padded"][0]["mixer"]["k"]
        assert k.shape == (B // 2, 2, CAP // 2, 16)
        assert (np.abs(k).sum(axis=(0, 1, 3)) > 0).sum() == (PROMPT if r % 2 == 0 else 0)


def test_reshard_moves_experts_between_layouts():
    """The prefill plan's experts (over model) moved to the decode plan's
    (over data): every rank ends with exactly its decode shard."""
    tcfg = reduced_config(get_arch("olmoe-1b-7b")).replace(dtype="float32")
    params = M.init_model(tcfg, None, seed=1, device="cpu")
    dec = make_plan(tcfg, ShapeCell("d", 64, 8, "decode"), AXES, SHAPE)
    out = serve.spawn(reshard_experts, (tcfg, params), mesh_shape=SHAPE,
                      transport="gloo", device="cpu", timeout=120)
    specs = SP.param_specs(tcfg, dec)
    for r in range(4):
        want = convert.shard_tree(params, specs, Mesh(SHAPE, AXES, r))
        for a, b in zip(convert.tree_leaves(out[r]), convert.tree_leaves(want)):
            np.testing.assert_array_equal(a, b.numpy())


def test_serve_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--mesh", "2x2", "--reduced", "--batch", "8", "--prompt-len", "16",
         "--max-seq", "64", "--new-tokens", "6"],
        env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "decode 5 steps" in proc.stdout and "transport gloo" in proc.stdout


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_form_plain_version_matches_jax(dtype):
    """``ops.flash_decode_lse`` on CPU tensors (its plain version, the
    port's ``attn_chunk_lse`` with per-row lengths) against JAX's
    ``attn_chunk_lse``, row by row; a row with nothing to attend to gives
    o = 0, l = 0, m = -1e30 on both sides."""
    from repro.models.layers.attention import attn_chunk_lse as jax_lse
    from repro_torch.kernels import ops
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((4, 16, 32), (4, 4, 24, 32), (4, 4, 24, 32)))
    lens = [0, 1, 13, 24]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    o, m, l = ops.flash_decode_lse(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                   torch.tensor(lens))
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    for b, n in enumerate(lens):
        jo, jm, jl = jax_lse(*(jnp.asarray(a[b:b + 1], jdt) for a in (q, k, v)),
                             pos_k=jnp.arange(24), max_pos=n - 1)
        for got, want in ((o, jo), (m, jm), (l, jl)):
            np.testing.assert_allclose(got[b:b + 1].float().numpy(), f32(want), **tol)
    assert (o[0] == 0).all() and (l[0] == 0).all() and (m[0] == -1e30).all()


def test_chip_smoke_sharded_phase_rehearses_on_cpu(monkeypatch):
    """``chip_smoke.py``'s sharded phase at a reduced size on the CPU: the
    launcher's jobs, the counting Dist, the teacher-forced single-device
    reference and its gates. The counted all-to-all bytes equal the
    phase's own prediction, E * C * D * bytes * (ep - 1) / ep a layer."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    from repro_torch.serving import kvcache
    out = chip_smoke.sharded_phase(torch, M, kvcache, "cpu", device="cpu", reduced=True,
                                   layers=2, config={"num_heads": 4, "num_kv_heads": 2})
    jobs, pred = out["jobs"], out["predicted_bytes_per_step"]
    assert jobs["f32"]["max_abs_logit_diff_vs_single_device"] < 1e-4
    for r in jobs["bf16"]["ranks"]:
        assert r["collective_bytes_per_step"]["dispatch"] == pred["dispatch_bf16"]
        assert r["collective_bytes_per_step"]["combine"] == pred["combine"]
    for r in jobs["fp8"]["ranks"]:
        assert r["collective_bytes_per_step"]["dispatch"] == pred["dispatch_fp8"]
    # bf16 and fp8 replay the run's expert choices; f32 routes for itself,
    # and every token goes where the sharded run sent it
    assert jobs["bf16"]["references_replay_expert_choices"] is True
    assert jobs["fp8"]["references_replay_expert_choices"] is True
    assert jobs["f32"]["references_replay_expert_choices"] is False
    assert jobs["f32"]["tokens_the_single_device_routes_otherwise"]["total"] == 0
    # the DBO sub-run of the bf16 job: bitwise two plain steps of B/2 (the
    # phase raises otherwise), their bytes, and a profile of each
    sub = out["dbo"]["bf16"]
    assert sub["steps"] == chip_smoke.DBO_SUBRUN_STEPS
    assert sub["collectives_per_step"]["dispatch"]["bytes"] == pred["dispatch_bf16"]
    assert sub["collectives_per_step"]["combine"]["calls"] == 2 * 2
    assert set(sub["profile_dbo"]) == set(sub["profile_plain_pair"])
    assert len(sub["ranks_wall_ms_median"]) == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_wire_format_matches_jax(dtype):
    """The e4m3 wire format of ``fp8_all_gather`` and ``fp8_dispatch_a2a``
    (per-row scales amax / 448, an all-zero row kept): on one device the
    collective is the identity, so both sides' quantize-dequantize round
    trips must agree bit for bit."""
    from repro.models.layers import moe as JMOE
    from repro_torch.models.layers import common as TC
    from repro_torch.models.layers import moe as TMOE
    from repro_torch.sharding.dist import NullDist
    x = np.random.default_rng(6).standard_normal((4, 6, 64)).astype(np.float32) * 3
    x[1, 2] = 0
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    pairs = ((TC.fp8_all_gather(tx, "model", NullDist(), 1),
              JC.fp8_all_gather(jx, "model", JaxNullDist(), 1)),
             (TMOE.fp8_dispatch_a2a(tx, "data", NullDist()),
              JMOE.fp8_dispatch_a2a(jx, "data", JaxNullDist())))
    for got, want in pairs:
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(got.float().numpy(), f32(want))
    assert not torch.equal(pairs[0][0], tx)          # it does quantize
