"""The port's dense GQA configurations beyond the first ones against the
JAX package: deepseek-67b (g = 8), minitron-8b (g = 4) and internvl2-76b (g = 8,
with the ``vit_patches`` frontend), reduced on both sides by
``reduced_config``, float32. The registry entries and their reductions
agree field for field; prefill and decode logits match; internvl2's prefill
with precomputed patch embeddings matches the JAX ``_embed_inputs`` path;
the port's ``Engine`` matches the JAX ``Engine`` token for token (tokens
only, as the JAX engine serves internvl2) and plain greedy decoding."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import common as JC  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.sharding.dist import NullDist as JaxNullDist  # noqa: E402
from repro.sharding.plans import null_plan as jax_null_plan  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import common as TC  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.sharding.dist import NullDist  # noqa: E402
from repro_torch.sharding.plans import null_plan  # noqa: E402

DENSE = ["deepseek-67b", "minitron-8b", "internvl2-76b"]
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
JDIST, DIST = JaxNullDist(), NullDist()
JPLAN, PLAN = jax_null_plan("decode"), null_plan("decode")


def models(arch, seed=0, **overrides):
    jcfg = jax_reduced(jax_arch(arch), dtype="float32", **overrides)
    tcfg = reduced_config(get_arch(arch), dtype="float32", **overrides)
    jp, _ = JM.init_model(jcfg, JPLAN, jax.random.PRNGKey(seed))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch,g,hd", [("deepseek-67b", 8, 128), ("minitron-8b", 4, 128),
                                       ("internvl2-76b", 8, 128)])
def test_published_shapes(arch, g, hd):
    """The query heads per KV head and the head dim the card's
    ``flash_decode`` runs at; internvl2's 256 patch positions."""
    cfg = get_arch(arch)
    assert (cfg.num_heads // cfg.num_kv_heads, cfg.head_dim) == (g, hd)
    assert {(s.mixer, s.ffn) for s in cfg.layer_specs} == {("attn", "dense")}
    assert cfg.n_frontend_tokens == (256 if arch == "internvl2-76b" else 0)


def jax_logits(params, cfg, mode, batch, caches=None, pos=None):
    """The JAX prefill (through ``_embed_inputs``) or decode step up to the
    logits of the last position."""
    plan = jax_null_plan(mode)
    if mode == "prefill":
        x = JM._embed_inputs(params, batch, cfg, plan, JDIST)
    else:
        x = JC.embed(params["embed"], batch["tokens"], cfg, plan, JDIST)
    x, caches, _ = JT.apply_stack(params["stack"], x, cfg, plan, JDIST,
                                  mode=mode, caches=caches, pos=pos)
    x = JC.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return JC.lm_logits(params["embed"], x[:, -1:], cfg, plan, JDIST), caches


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch):
    """Prefill of 11 tokens, then 8 greedy decode steps: logits within
    1e-4, tokens equal, caches within 1e-5 after the last step."""
    jcfg, tcfg, jp, tp = models(arch)
    prompt = np.array([[3, 5, 7, 11, 2, 4, 9, 8, 1, 6, 5]], np.int32)
    L, S = prompt.shape[1], 24
    lj, jc = jax_logits(jp, jcfg, "prefill", {"tokens": jnp.asarray(prompt)})
    lt, tc = M.prefill_logits(tp, {"tokens": torch.from_numpy(prompt)}, tcfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    jc = jkv.pad_to_capacity(jcfg, jc, L, S)
    tc = kvcache.pad_to_capacity(tcfg, tc, L, S)
    for pos in range(L, L + 8):
        tok = np.asarray(JC.greedy_sample(lj, jcfg, JPLAN, JDIST))
        np.testing.assert_array_equal(TC.greedy_sample(lt, tcfg, PLAN, DIST).numpy(), tok)
        lj, jc = jax_logits(jp, jcfg, "decode", {"tokens": jnp.asarray(tok)}, jc,
                            jnp.int32(pos))
        lt, tc = M.decode_logits(tp, tc, torch.tensor(tok), pos, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    want = convert.unstack_layers(jax.tree.map(np.asarray, jc), tcfg)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(tc)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S", [5, 8, 13])
def test_internvl2_prefill_with_patches_matches_jax(S):
    """B = 2, 8 patch embeddings (the reduction's n_frontend_tokens) and S
    tokens: patch p replaces token position p for p < min(8, S), as the
    JAX ``_embed_inputs``. The embedded inputs, the logits and the caches
    match, and the patches change the logits."""
    jcfg, tcfg, jp, tp = models("internvl2-76b")
    rng = np.random.default_rng(S)
    tokens = rng.integers(1, 500, (2, S)).astype(np.int32)
    patches = rng.standard_normal((2, 8, 64)).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches)}
    tbatch = {"tokens": torch.from_numpy(tokens), "patches": torch.from_numpy(patches)}
    xj = JM._embed_inputs(jp, jbatch, jcfg, jax_null_plan("prefill"), JDIST)
    xt = M._embed_inputs(tp, tbatch, tcfg, null_plan("prefill"), DIST)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    n = min(8, S)
    np.testing.assert_array_equal(xt[:, :n].numpy(), patches[:, :n])
    lj, jc = jax_logits(jp, jcfg, "prefill", jbatch)
    lt, tc = M.prefill_logits(tp, tbatch, tcfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    want = convert.unstack_layers(jax.tree.map(np.asarray, jc), tcfg)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(tc)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)
    plain, _ = M.prefill_logits(tp, {"tokens": tbatch["tokens"]}, tcfg)
    assert (plain - lt).abs().max() > 1e-3
    tok, _ = M.prefill(tp, tbatch, tcfg)
    assert torch.equal(tok, TC.greedy_sample(lt, tcfg, PLAN, DIST))


@pytest.mark.parametrize("arch", DENSE)
def test_engine_matches_jax_engine(arch):
    """5 requests over 2 slots, prompts of 3, 6 and 11 tokens, slots
    reused; internvl2 from its tokens alone, as the JAX engine serves it."""
    jcfg, tcfg, jp, tp = models(arch)
    rng = np.random.default_rng(3)
    reqs = [rng.integers(1, 500, n).tolist() for n in (3, 6, 11, 3, 6)]
    jeng = JaxEngine(jcfg, jp, max_batch=2, max_seq=32, eos_id=-1)
    teng = Engine(tcfg, tp, max_batch=2, max_seq=32, eos_id=-1, device="cpu")
    for i, p in enumerate(reqs):
        jeng.submit(p, max_new_tokens=6 + i)
        teng.submit(p, max_new_tokens=6 + i)
    want, got = jeng.run(), teng.run()
    assert got == want
    assert all(len(got[i]) == 7 + i for i in range(5))


@pytest.mark.parametrize("arch", ["deepseek-67b", "minitron-8b"])
def test_engine_matches_sequential(arch):
    """Engine output for a single request == plain greedy decode."""
    _, tcfg, _, tp = models(arch)
    prompt = [3, 5, 7, 11, 2, 4]
    tok, caches = M.prefill(tp, {"tokens": torch.tensor([prompt])}, tcfg)
    caches = kvcache.pad_to_capacity(tcfg, caches, len(prompt), 64)
    ref = [int(tok)]
    for pos in range(len(prompt), len(prompt) + 11):
        tok, caches = M.decode_step(tp, caches, tok, pos, tcfg)
        ref.append(int(tok))
    eng = Engine(tcfg, tp, max_batch=2, max_seq=64, eos_id=-1, device="cpu")
    rid = eng.submit(prompt, max_new_tokens=12)
    assert eng.run()[rid][:12] == ref
