"""Serving path of the PyTorch port against the JAX package, on reduced
olmoe-1b-7b: weight and cache conversion, prefill and decode logits, and
the continuous-batching engine token for token against the JAX ``Engine``
(float32), including top-2 of 8 experts over 4 slots, where a capacity
shared by the batch would drop tokens that the JAX engine's per-slot
capacity keeps."""
import dataclasses

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
from repro_torch.models.layers.moe import capacity  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.sharding.dist import NullDist  # noqa: E402
from repro_torch.sharding.plans import null_plan  # noqa: E402

JDIST = JaxNullDist()
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
# bf16 end to end: weights, activations and caches round to 8 bits of
# mantissa at different places in the two frameworks (|logit| < 0.5 here,
# bf16's spacing there is 2e-3); 1e-2 leaves room for a few such steps.
BF16_LOGIT_TOL = dict(atol=1e-2, rtol=0)


def models(dtype="float32", topk=None, seed=0):
    cfgs = []
    for arch, reduce in ((jax_arch, jax_reduced), (get_arch, reduced_config)):
        cfg = reduce(arch("olmoe-1b-7b"), dtype=dtype)
        if topk is not None:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                      experts_per_token=topk))
        cfgs.append(cfg)
    jcfg, tcfg = cfgs
    jp, _ = JM.init_model(jcfg, jax_null_plan("decode"), jax.random.PRNGKey(seed))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def jax_logits(params, cfg, mode, tokens, caches=None, pos=None):
    """The JAX prefill / decode_step up to the logits."""
    plan = jax_null_plan(mode)
    x = JC.embed(params["embed"], tokens, cfg, plan, JDIST)
    x, caches, _ = JT.apply_stack(params["stack"], x, cfg, plan, JDIST,
                                  mode=mode, caches=caches, pos=pos)
    x = JC.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return JC.lm_logits(params["embed"], x[:, -1:], cfg, plan, JDIST), caches


def prompts(n, seed=0, lengths=(3, 6, 9)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 500, lengths[i % len(lengths)]).tolist()
            for i in range(n)]


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def torch_bits(t):
    return t.view(torch.int16).numpy().view(np.uint16) \
        if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------

def test_convert_round_trips_params_and_caches_bf16():
    jcfg, tcfg, jp, tp = models(dtype="bfloat16")
    assert tp["stack"][0]["mixer"]["w_q"].dtype == torch.bfloat16
    assert tp["stack"][0]["norm1"]["scale"].dtype == torch.float32
    layers = convert.unstack_layers(jax.tree.map(np.asarray, jp["stack"]), tcfg)
    assert len(tp["stack"]) == len(layers) == tcfg.num_layers
    for want, got in zip(jax.tree.leaves(layers), jax.tree.leaves(tp["stack"])):
        np.testing.assert_array_equal(torch_bits(got), bits(want))
    for key in ("embed", "final_norm"):
        for want, got in zip(jax.tree.leaves(jp[key]), jax.tree.leaves(tp[key])):
            np.testing.assert_array_equal(torch_bits(got), bits(want))

    tokens = jnp.asarray([[3, 5, 7, 11]], jnp.int32)
    _, jc = JM.prefill(jp, {"tokens": tokens}, jcfg, jax_null_plan("prefill"), JDIST)
    tc = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    jl = convert.unstack_layers(jax.tree.map(np.asarray, jc), tcfg)
    assert tc[0]["mixer"]["k"].shape == (1, tcfg.num_kv_heads, 4, tcfg.head_dim)
    for want, got in zip(jax.tree.leaves(jl), jax.tree.leaves(tc)):
        np.testing.assert_array_equal(torch_bits(got), bits(want))


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def test_prefill_and_decode_match_jax_f32():
    jcfg, tcfg, jp, tp = models()
    prompt = np.array([[3, 5, 7, 11, 2, 4], [9, 8, 1, 6, 5, 2]], np.int32)
    lj, jc = jax_logits(jp, jcfg, "prefill", jnp.asarray(prompt))
    lt, tc = M.prefill_logits(tp, {"tokens": torch.from_numpy(prompt)}, tcfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    tok_t, _ = M.prefill(tp, {"tokens": torch.from_numpy(prompt)}, tcfg)
    tok_j, _ = JM.prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg,
                          jax_null_plan("prefill"), JDIST)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))

    jc = jkv.pad_to_capacity(jcfg, jc, 6, 16)
    tc = kvcache.pad_to_capacity(tcfg, tc, 6, 16)
    tok = np.asarray(tok_j)
    for pos in range(6, 9):
        lj, jc = jax_logits(jp, jcfg, "decode", jnp.asarray(tok), jc, jnp.int32(pos))
        lt, tc = M.decode_logits(tp, tc, torch.tensor(tok), pos, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
        tok = np.asarray(JC.greedy_sample(lj, jcfg, jax_null_plan("decode"), JDIST))
        tok_t = TC.greedy_sample(lt, tcfg, null_plan("decode"), NullDist())
        np.testing.assert_array_equal(tok_t.numpy(), tok)
    for want, got in zip(jax.tree.leaves(convert.unstack_layers(
            jax.tree.map(np.asarray, jc), tcfg)), jax.tree.leaves(tc)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_prefill_logits_bf16_within_tolerance():
    jcfg, tcfg, jp, tp = models(dtype="bfloat16")
    prompt = np.array([[3, 5, 7, 11, 2, 4, 1, 9]], np.int32)
    lj, _ = jax_logits(jp, jcfg, "prefill", jnp.asarray(prompt))
    lt, _ = M.prefill_logits(tp, {"tokens": torch.from_numpy(prompt)}, tcfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **BF16_LOGIT_TOL)


# ---------------------------------------------------------------------------
# engine: token for token against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topk,slots", [(None, 2), (2, 4)])
def test_engine_matches_jax_engine(topk, slots):
    jcfg, tcfg, jp, tp = models(topk=topk)
    if topk == 2:
        # the trap: one capacity group over 4 slots would hold 2 tokens per
        # expert, one group per slot holds 1
        assert capacity(1, 2, 8, 1.5) == 1 and capacity(4, 2, 8, 1.5) == 2
    reqs = prompts(5, seed=slots)
    jeng = JaxEngine(jcfg, jp, max_batch=slots, max_seq=32, eos_id=-1)
    teng = Engine(tcfg, tp, max_batch=slots, max_seq=32, eos_id=-1, device="cpu")
    for i, p in enumerate(reqs):
        jeng.submit(p, max_new_tokens=4 + i)
        teng.submit(p, max_new_tokens=4 + i)
    want, got = jeng.run(), teng.run()
    assert got == want
    assert all(len(got[i]) == 5 + i for i in range(5))


def greedy_reference(cfg, params, prompt, n_tokens, max_seq):
    """Plain sequential greedy decode with the port's model functions."""
    tok, caches = M.prefill(params, {"tokens": torch.tensor([prompt])}, cfg)
    caches = kvcache.pad_to_capacity(cfg, caches, len(prompt), max_seq)
    toks = [int(tok[0, 0])]
    for pos in range(len(prompt), len(prompt) + n_tokens - 1):
        tok, caches = M.decode_step(params, caches, tok, pos, cfg)
        toks.append(int(tok[0, 0]))
    return toks


def test_engine_matches_sequential():
    _, tcfg, _, tp = models()
    prompt = [3, 5, 7, 11, 2, 4]
    ref = greedy_reference(tcfg, tp, prompt, 6, 64)
    eng = Engine(tcfg, tp, max_batch=2, max_seq=64, eos_id=-1, device="cpu")
    rid = eng.submit(prompt, max_new_tokens=6)
    assert eng.run()[rid][:6] == ref


def test_engine_continuous_batching():
    """More requests than slots: all complete, slots are reused."""
    _, tcfg, _, tp = models()
    eng = Engine(tcfg, tp, max_batch=2, max_seq=48, eos_id=-1, device="cpu")
    rids = [eng.submit([1 + i, 2 + i, 3 + i], max_new_tokens=4) for i in range(5)]
    out = eng.run()
    assert set(out) == set(rids)
    assert all(len(out[r]) == 5 for r in rids)


def test_engine_isolation():
    """A request decoded next to another gives what it gives alone."""
    _, tcfg, _, tp = models(topk=2)
    p1, p2 = [3, 1, 4, 1, 5], [9, 2, 6, 5, 3]
    eng1 = Engine(tcfg, tp, max_batch=2, max_seq=48, eos_id=-1, device="cpu")
    r1 = eng1.submit(p1, max_new_tokens=5)
    alone = eng1.run()[r1]
    eng2 = Engine(tcfg, tp, max_batch=2, max_seq=48, eos_id=-1, device="cpu")
    ra = eng2.submit(p1, max_new_tokens=5)
    eng2.submit(p2, max_new_tokens=5)
    assert eng2.run()[ra] == alone


def test_engine_retires_on_eos_and_capacity():
    """The JAX retire rule: EOS is dropped from the output, and a slot stops
    at position max_seq - 1."""
    _, tcfg, _, tp = models()
    prompt = [3, 5, 7]
    first = greedy_reference(tcfg, tp, prompt, 3, 16)
    eng = Engine(tcfg, tp, max_batch=1, max_seq=16, eos_id=first[1], device="cpu")
    rid = eng.submit(prompt, max_new_tokens=10)
    assert eng.run()[rid] == ([] if first[0] == first[1] else first[:1])
    eng = Engine(tcfg, tp, max_batch=1, max_seq=8, eos_id=-1, device="cpu")
    rid = eng.submit(prompt, max_new_tokens=100)
    assert len(eng.run()[rid]) == 8 - 1 - len(prompt) + 1
