"""The port's DBO decode step under a sharded plan, four gloo ranks on the
CPU as a 2x2 ("data", "model") mesh, on reduced olmoe-1b-7b and reduced
deepseek-v3 (MLA, shared experts):

- the split all-to-all (``Dist.all_to_all_start`` / ``wait``) equals
  ``all_to_all`` bit for bit, is observed once with the same arguments
  and counted alike by ``CountingDist``, keeps two handles in flight on
  one group under a collective on another, and refuses a gradient and a
  second ``wait()``;
- the sharded DBO step (``steps.build_dbo_decode_step``) gives bitwise the
  tokens, f32 logits and caches of two plain sharded decode steps of B/2,
  over 4 steps from prefilled caches, with the same collective bytes and
  calls a step, in f32, bf16 and bf16 with the fp8 dispatch; no
  all-to-all handle is left waiting;
- its f32 logits are within 1e-5 of JAX's single-device
  ``repro.serving.dbo.dbo_decode_step`` on the same weights (carried
  across by ``repro_torch.convert``), and its tokens are JAX's;
- ``launch.serve``'s job key ``dbo`` serves the plain job's tokens, its
  logits within 1e-5, in the plain job's row order;
- on one device, ``moe_dispatch`` -> ``moe_experts`` -> ``moe_combine`` is
  bitwise ``moe_ffn``, which matches JAX's ``moe_ffn`` within 1e-5.

All sharded cases run in one ``serve.spawn`` (module fixture) with a
timeout.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import common as JC  # noqa: E402
from repro.models.layers import moe as JMoE  # noqa: E402
from repro.serving import dbo as jdbo  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro.sharding.dist import NullDist as JaxNullDist  # noqa: E402
from repro.sharding.plans import null_plan as jax_null_plan  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import moe as TMoE  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.sharding.dist import NullDist  # noqa: E402
from repro_torch.sharding.plans import make_plan, null_plan  # noqa: E402
from torch_dbo_workers import A2A_CASES, run_cases  # noqa: E402

SHAPE, AXES = (2, 2), ("data", "model")
B, PROMPT, CAP, STEPS = 8, 14, 32, 4       # decode positions 14-17 cross the KV shards
ARCHS = {"olmoe-1b-7b": dict(num_heads=4, num_kv_heads=2), "deepseek-v3": {}}
JOBS = [(arch, dt, fp8) for arch in ARCHS for dt, fp8 in
        (("float32", False), ("bfloat16", False), ("bfloat16", True))]
JDIST = JaxNullDist()
TOL = dict(atol=1e-5, rtol=1e-5)


def configs(arch, dtype):
    kw = dict(ARCHS[arch], dtype=dtype)
    return (jax_reduced(jax_arch(arch)).replace(**kw),
            reduced_config(get_arch(arch)).replace(**kw))


def jax_rows(jc, lo, hi):
    """Rows [lo, hi) of a JAX cache tree (period-stacked leaves: batch at
    dim 1)."""
    return {"periods": jax.tree.map(lambda a: a[:, lo:hi], jc["periods"]),
            "rem": jax.tree.map(lambda a: a[lo:hi], jc["rem"])}


def _prefilled(arch, dtype):
    """JAX weights and a JAX prefill of B prompts padded to CAP; the port's
    weights and both microbatches' caches (rows 0-3 and 4-7) converted."""
    jcfg, tcfg = configs(arch, dtype)
    jp, _ = JM.init_model(jcfg, jax_null_plan("decode"), jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    prompts = np.random.default_rng(3).integers(1, jcfg.vocab_size, (B, PROMPT))
    tok, jc = JM.prefill(jp, {"tokens": jnp.asarray(prompts, jnp.int32)}, jcfg,
                         jax_null_plan("prefill"), JDIST)
    jc = jkv.pad_to_capacity(jcfg, jc, PROMPT, CAP)
    tc = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    h = B // 2
    halves = [convert.tree_map(lambda t, lo=lo: t[lo:lo + h].clone(), tc) for lo in (0, h)]
    tok = np.asarray(tok, np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jc=[jax_rows(jc, 0, h), jax_rows(jc, h, B)],
                tc=halves, tok=[tok[:h], tok[h:]])


def _serve_job(**kw):
    return dict(arch="olmoe-1b-7b", reduced=True, config=dict(ARCHS["olmoe-1b-7b"],
                                                              dtype="float32"),
                batch=B, prompt_len=16, max_seq=64, new_tokens=5, seed=0, logits=True, **kw)


@pytest.fixture(scope="module")
def runs():
    models = {(a, dt): _prefilled(a, dt) for a in ARCHS for dt in ("float32", "bfloat16")}
    jobs = [dict(kind="split_a2a")]
    for arch, dt, fp8 in JOBS:
        m = models[(arch, dt)]
        jobs.append(dict(kind="dbo", cfg=m["tcfg"], params=m["tp"], batch=B, seq=CAP,
                         caches=m["tc"], tokens=m["tok"], pos=PROMPT, steps=STEPS,
                         plan_kw={"a2a_fp8": fp8}))
    jobs += [dict(kind="serve", job=_serve_job()), dict(kind="serve", job=_serve_job(dbo=True))]
    out = serve.spawn(run_cases, (jobs,), mesh_shape=SHAPE, transport="gloo", device="cpu",
                      timeout=300)
    by = {"split_a2a": [out[r][0] for r in range(4)]}
    for i, key in enumerate(JOBS):
        by[key] = [out[r][1 + i] for r in range(4)]
    by["serve"], by["serve_dbo"] = out[0][-2], out[0][-1]
    return by, models


# ---------------------------------------------------------------------------
# the split all-to-all
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
@pytest.mark.parametrize("case", A2A_CASES, ids=lambda c: f"{c[0]}-{c[1]}to{c[2]}")
def test_split_all_to_all_equals_all_to_all(runs, dtype, case):
    """start/wait returns what ``all_to_all`` returns, bit for bit, on every
    rank, and the observer sees it once, with the synchronous call's
    arguments."""
    axis, s, c = case
    for r, res in enumerate(runs[0]["split_a2a"]):
        assert res[f"equal {dtype} {axis} {s}->{c}"], r
        assert res[f"observed once {dtype} {axis} {s}->{c}"], r


@pytest.mark.parametrize("check", ["pending two", "two in flight", "pending none",
                                   "second wait refused", "gradient refused",
                                   "counted alike"])
def test_split_all_to_all_handles(runs, check):
    """Two handles in flight on "data" with a psum over "model" between
    them, waited out of order; ``pending`` counts them; a second ``wait()``
    and a tensor that wants a gradient are refused; ``CountingDist`` counts
    a started all-to-all as a plain one (kind, bytes, one call)."""
    for r, res in enumerate(runs[0]["split_a2a"]):
        assert res[check], (r, check)


# ---------------------------------------------------------------------------
# the sharded DBO step against two plain sharded steps of B/2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("job", JOBS, ids=lambda j: f"{j[0]}-{j[1]}{'-fp8' if j[2] else ''}")
def test_sharded_dbo_equals_two_plain_steps(runs, job):
    """Tokens, logits and caches bitwise those of two plain sharded steps
    of B/2 on every rank, the collective bytes and calls of a step equal
    to the pair's, two dispatch and two combine all-to-alls a MoE layer
    (fp8: four dispatch, bytes and scales), no handle left waiting."""
    cfg = configs(job[0], job[1])[1]
    n_moe = sum(s.ffn == "moe" for s in cfg.layer_specs)
    for r, res in enumerate(runs[0][job]):
        for key in ("tokens_equal", "logits_equal", "caches_equal", "counts_equal",
                    "pending_zero"):
            assert res[key], (r, key)
        want = {"dispatch": (4 if job[2] else 2) * n_moe, "combine": 2 * n_moe}
        assert res["a2a_calls_per_step"] == want, (r, res["a2a_calls_per_step"])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_dbo_matches_jax_dbo_step(runs, arch):
    """The sharded f32 DBO step's gathered logits within 1e-5 of JAX's
    single-device ``dbo_decode_step`` arithmetic on the same weights and
    caches, each step fed the sharded run's tokens; its tokens JAX's."""
    by, models = runs
    m = models[(arch, "float32")]
    res = by[(arch, "float32", False)][0]
    jcfg, jp = m["jcfg"], m["jp"]
    plan = jax_null_plan("decode")
    jca, jcb = m["jc"]
    toks = [jnp.asarray(t) for t in m["tok"]]
    wa, wb, _, _ = jdbo.dbo_decode_step(jp, jca, jcb, toks[0], toks[1], jnp.int32(PROMPT),
                                        jcfg, plan, JDIST)
    np.testing.assert_array_equal(res["tokens"][0][0], np.asarray(wa))
    np.testing.assert_array_equal(res["tokens"][0][1], np.asarray(wb))
    for i in range(STEPS):
        xa, xb = (JC.embed(jp["embed"], t, jcfg, plan, JDIST) for t in toks)
        xa, xb, jca, jcb = jdbo._interleaved_stack(jp, xa, xb, jcfg, plan, JDIST,
                                                   caches_a=jca, caches_b=jcb,
                                                   pos=jnp.int32(PROMPT + i))
        for mb, x in enumerate((xa, xb)):
            x = JC.rms_norm(x, jp["final_norm"]["scale"], jcfg.norm_eps)
            want = np.asarray(JC.lm_logits(jp["embed"], x, jcfg, plan, JDIST)[:, 0],
                              np.float32)
            got = res["logits"][i][mb]
            np.testing.assert_allclose(got[:, :want.shape[-1]], want, **TOL)
            np.testing.assert_array_equal(got.argmax(-1), res["tokens"][i][mb][:, 0])
        toks = [jnp.asarray(t) for t in res["tokens"][i]]


def test_serve_job_dbo_key(runs):
    """``serve_job`` with ``dbo``: the plain job's tokens, in its row order,
    and its f32 logits within 1e-5 (reduced olmoe routes top-8 of 8: no
    capacity drop in either, so the microbatches' smaller capacity groups
    change nothing)."""
    plain, dbo = runs[0]["serve"], runs[0]["serve_dbo"]
    np.testing.assert_array_equal(dbo["tokens"], plain["tokens"])
    np.testing.assert_allclose(dbo["logits"], plain["logits"], **TOL)


# ---------------------------------------------------------------------------
# one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_stages_compose_to_moe_ffn(arch, dtype):
    """``moe_dispatch`` -> ``moe_experts`` -> ``moe_combine`` is bitwise
    ``moe_ffn`` (y and the load-balance loss); in f32 ``moe_ffn`` is within
    1e-5 of JAX's on the same weights."""
    jcfg, tcfg = configs(arch, dtype)
    jp, _ = JM.init_model(jcfg, jax_null_plan("decode"), jax.random.PRNGKey(1))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    ffn = tp["stack"][0]["ffn"]
    x = np.random.default_rng(7).standard_normal((4, 3, tcfg.d_model)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    plan, dist = null_plan("decode"), NullDist()
    st = TMoE.moe_dispatch(ffn, tx, tcfg, plan, dist, capacity_groups=2)
    TMoE.moe_experts(ffn, st, plan, dist)
    y, aux = TMoE.moe_combine(ffn, st, tcfg, plan, dist, collect_aux=True)
    y_ffn, aux_ffn = TMoE.moe_ffn(ffn, tx, tcfg, plan, dist, capacity_groups=2,
                                  collect_aux=True)
    assert torch.equal(y, y_ffn) and torch.equal(aux, aux_ffn)
    assert dist.pending == 0
    if dtype == "float32":
        jffn = jax.tree.map(lambda a: a[0], jp["stack"]["periods"][0]["ffn"])
        yj, _ = JMoE.moe_ffn(jffn, jnp.asarray(x), jcfg, jax_null_plan("decode"), JDIST)
        np.testing.assert_allclose(y_ffn.numpy(), np.asarray(yj), **TOL)


def test_build_dbo_decode_step_refuses_unsplit_microbatches():
    """A microbatch of B/2 rows must split over the batch axes; an
    encoder-decoder is refused by name."""
    cfg = reduced_config(get_arch("olmoe-1b-7b")).replace(**ARCHS["olmoe-1b-7b"])
    mesh = Mesh(SHAPE, AXES)
    for bad in (6, 5):
        cell = ShapeCell("d", CAP, bad, "decode")
        plan = make_plan(cfg, ShapeCell("d", CAP, 8, "decode"), AXES, SHAPE)
        with pytest.raises(ValueError, match="does not split over the batch axes"):
            steps.build_dbo_decode_step(cfg, cell, plan, mesh, transport="gloo")
    sm = reduced_config(get_arch("seamless-m4t-medium"))
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        steps.build_dbo_decode_step(sm, ShapeCell("d", CAP, 8, "decode"), null_plan("decode"))


def test_split_rows_halves_every_leaf():
    """``kvcache.split_rows``: each leaf's batch rows in two copies, A the
    first half."""
    cfg = reduced_config(get_arch("deepseek-v3"))
    caches = M.init_cache(cfg, None, 4, 8, device="cpu")
    for leaf in convert.tree_leaves(caches):
        leaf.copy_(torch.arange(leaf.numel(), dtype=torch.float32).reshape(leaf.shape))
    a, b = kvcache.split_rows(caches)
    for whole, ha, hb in zip(*(convert.tree_leaves(t) for t in (caches, a, b))):
        assert torch.equal(torch.cat([ha, hb]), whole)
        assert ha.data_ptr() != whole.data_ptr()
