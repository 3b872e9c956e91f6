"""The port's configurations beyond olmoe-1b-7b against the JAX package:
starcoder2-3b (dense GQA), granite-moe-3b-a800m (MoE, tied embeddings, a
vocabulary that pads) and gemma3-1b (5 sliding-window layers per global
one), reduced on both sides by ``reduced_config``, float32. The registry
and reduction agree field for field; prefill and decode logits match; the
port's ``Engine`` matches the JAX ``Engine`` token for token, on gemma3
with requests that wrap the ring; and the JAX engine tests run on
starcoder2-3b."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as jax_archs  # noqa: E402
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
from repro_torch.configs import ARCHS, get_arch, reduced_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import common as TC  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.sharding.dist import NullDist  # noqa: E402
from repro_torch.sharding.plans import null_plan  # noqa: E402

NEW_ARCHS = ["starcoder2-3b", "granite-moe-3b-a800m", "gemma3-1b"]
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
JDIST = JaxNullDist()


def models(arch, seed=0, **overrides):
    jcfg = jax_reduced(jax_arch(arch), dtype="float32", **overrides)
    tcfg = reduced_config(get_arch(arch), dtype="float32", **overrides)
    jp, _ = JM.init_model(jcfg, jax_null_plan("decode"), jax.random.PRNGKey(seed))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def prompts(n, seed=0, lengths=(3, 6, 11)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 500, lengths[i % len(lengths)]).tolist()
            for i in range(n)]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

LATER_ARCHS = ["deepseek-67b", "minitron-8b", "rwkv6-1.6b", "internvl2-76b",
                "seamless-m4t-medium"]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b"] + NEW_ARCHS + LATER_ARCHS)
def test_config_and_reduction_match_jax(arch):
    """The registry entry and its reduction are the JAX package's, field for
    field, with the derived sizes the port depends on."""
    assert repr(get_arch(arch)) == repr(jax_arch(arch))
    t, j = reduced_config(get_arch(arch)), jax_reduced(jax_arch(arch))
    assert repr(t) == repr(j)
    full = get_arch(arch)
    assert (full.n_periods, full.n_remainder) == \
        (jax_arch(arch).n_periods, jax_arch(arch).n_remainder)
    v = TC.padded_vocab(full)
    assert v % 256 == 0 and 0 <= v - full.vocab_size < 256


def test_registry_and_derived_sizes():
    """The port registers the JAX package's eleven architectures."""
    assert set(ARCHS) == set(jax_archs) and len(ARCHS) == 11
    assert set(ARCHS) == {"olmoe-1b-7b", "deepseek-v3", "jamba-v0.1-52b"} | \
        set(NEW_ARCHS) | set(LATER_ARCHS)
    g = get_arch("gemma3-1b")
    assert (g.n_periods, g.n_remainder) == (4, 2)
    assert [s.mixer for s in g.layer_specs].count("attn") == 4
    assert reduced_config(g).sliding_window == 8
    assert TC.padded_vocab(get_arch("granite-moe-3b-a800m")) == 49408
    assert TC.padded_vocab(get_arch("seamless-m4t-medium")) == 256256
    red = reduced_config(get_arch("seamless-m4t-medium"))
    assert (red.encoder_layers, red.n_frontend_tokens) == (2, 8)
    assert reduced_config(get_arch("internvl2-76b")).n_frontend_tokens == 8
    with pytest.raises(KeyError):
        get_arch("rwkv7-3b")


# ---------------------------------------------------------------------------
# prefill / decode logits
# ---------------------------------------------------------------------------

def jax_logits(params, cfg, mode, tokens, caches=None, pos=None):
    """The JAX prefill / decode_step up to the logits of the last position."""
    plan = jax_null_plan(mode)
    x = JC.embed(params["embed"], tokens, cfg, plan, JDIST)
    x, caches, _ = JT.apply_stack(params["stack"], x, cfg, plan, JDIST,
                                  mode=mode, caches=caches, pos=pos)
    x = JC.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return JC.lm_logits(params["embed"], x[:, -1:], cfg, plan, JDIST), caches


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill of 11 tokens, then 8 greedy decode steps: logits within
    1e-4, tokens equal, caches within 1e-5 after the last step. On gemma3
    the prompt already fills the window-8 ring and decode wraps it again."""
    jcfg, tcfg, jp, tp = models(arch)
    prompt = np.array([[3, 5, 7, 11, 2, 4, 9, 8, 1, 6, 5]], np.int32)
    L, S = prompt.shape[1], 24
    lj, jc = jax_logits(jp, jcfg, "prefill", jnp.asarray(prompt))
    lt, tc = M.prefill_logits(tp, {"tokens": torch.from_numpy(prompt)}, tcfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    jc = jkv.pad_to_capacity(jcfg, jc, L, S)
    tc = kvcache.pad_to_capacity(tcfg, tc, L, S)
    for pos in range(L, L + 8):
        tok = np.asarray(JC.greedy_sample(lj, jcfg, jax_null_plan("decode"), JDIST))
        ttok = TC.greedy_sample(lt, tcfg, null_plan("decode"), NullDist())
        np.testing.assert_array_equal(ttok.numpy(), tok)
        lj, jc = jax_logits(jp, jcfg, "decode", jnp.asarray(tok), jc, jnp.int32(pos))
        lt, tc = M.decode_logits(tp, tc, torch.tensor(tok), pos, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    want = convert.unstack_layers(jax.tree.map(np.asarray, jc), tcfg)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(tc)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# engine: token for token against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_engine_matches_jax_engine(arch):
    """5 requests over 2 slots; on gemma3 (window 8) prompts of 11 tokens
    and up to 10 new ones run past position 8 and wrap the ring."""
    jcfg, tcfg, jp, tp = models(arch)
    reqs = prompts(5, seed=3)
    jeng = JaxEngine(jcfg, jp, max_batch=2, max_seq=32, eos_id=-1)
    teng = Engine(tcfg, tp, max_batch=2, max_seq=32, eos_id=-1, device="cpu")
    for i, p in enumerate(reqs):
        jeng.submit(p, max_new_tokens=6 + i)
        teng.submit(p, max_new_tokens=6 + i)
    want, got = jeng.run(), teng.run()
    assert got == want
    assert all(len(got[i]) == 7 + i for i in range(5))
    if arch == "gemma3-1b":
        assert max(len(p) + 7 + i for i, p in enumerate(reqs)) > 2 * tcfg.sliding_window


def test_engine_gemma3_prompt_as_long_as_the_window():
    """A prompt of exactly W tokens: its ring must go into the slot as a
    ring (the pad trap), and the engine must still match the JAX one."""
    jcfg, tcfg, jp, tp = models("gemma3-1b")
    W = tcfg.sliding_window
    reqs = [list(range(1, W + 1)), list(range(5, 5 + W))]
    jeng = JaxEngine(jcfg, jp, max_batch=2, max_seq=24, eos_id=-1)
    teng = Engine(tcfg, tp, max_batch=2, max_seq=24, eos_id=-1, device="cpu")
    for p in reqs:
        jeng.submit(p, max_new_tokens=10)
        teng.submit(p, max_new_tokens=10)
    assert teng.run() == jeng.run()


def greedy_reference(cfg, params, prompt, n_tokens, max_seq):
    """Plain sequential greedy decode with the port's model functions."""
    tok, caches = M.prefill(params, {"tokens": torch.tensor([prompt])}, cfg)
    caches = kvcache.pad_to_capacity(cfg, caches, len(prompt), max_seq)
    toks = [int(tok[0, 0])]
    for pos in range(len(prompt), len(prompt) + n_tokens - 1):
        tok, caches = M.decode_step(params, caches, tok, pos, cfg)
        toks.append(int(tok[0, 0]))
    return toks


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_engine_matches_sequential(arch):
    """Engine output for a single request == plain greedy decode."""
    _, tcfg, _, tp = models(arch)
    prompt = [3, 5, 7, 11, 2, 4]
    ref = greedy_reference(tcfg, tp, prompt, 12, 64)
    eng = Engine(tcfg, tp, max_batch=2, max_seq=64, eos_id=-1, device="cpu")
    rid = eng.submit(prompt, max_new_tokens=12)
    assert eng.run()[rid][:12] == ref


def test_engine_continuous_batching():
    """More requests than slots: all complete, slots are reused."""
    _, tcfg, _, tp = models("starcoder2-3b")
    eng = Engine(tcfg, tp, max_batch=2, max_seq=48, eos_id=-1, device="cpu")
    rids = [eng.submit([1 + i, 2 + i, 3 + i], max_new_tokens=4) for i in range(5)]
    out = eng.run()
    assert set(out) == set(rids)
    assert all(len(out[r]) == 5 for r in rids)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma3-1b"])
def test_engine_isolation(arch):
    """A request decoded next to another gives what it gives alone."""
    _, tcfg, _, tp = models(arch)
    p1, p2 = [3, 1, 4, 1, 5, 9, 2, 6, 5], [9, 2, 6, 5, 3]
    eng1 = Engine(tcfg, tp, max_batch=2, max_seq=48, eos_id=-1, device="cpu")
    r1 = eng1.submit(p1, max_new_tokens=10)
    alone = eng1.run()[r1]
    eng2 = Engine(tcfg, tp, max_batch=2, max_seq=48, eos_id=-1, device="cpu")
    ra = eng2.submit(p1, max_new_tokens=10)
    eng2.submit(p2, max_new_tokens=10)
    assert eng2.run()[ra] == alone
