"""The port's DBO decode step and speculative decoder against plain greedy
decoding and against the JAX package (``repro.serving.dbo`` /
``repro.serving.specdec``), on reduced configs, float32. Mirrors
``tests/test_serving.py``: DBO equals two plain steps; SD equals greedy
for any draft (a constant draft, untrained Medusa heads converted from the
JAX decoder, an oracle that accepts every draft), on starcoder2-3b and
olmoe-1b-7b (positional caches only) and on gemma3-1b, whose ring buffers
are rolled back from the per-step history. At B > 1 with ring buffers and
mixed acceptance the JAX decoder leaves greedy; the port is pinned to it."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro.serving.dbo import dbo_decode_step as jax_dbo_step  # noqa: E402
from repro.serving.specdec import SDDecoder as JaxSDDecoder  # noqa: E402
from repro.sharding.dist import NullDist as JaxNullDist  # noqa: E402
from repro.sharding.plans import null_plan as jax_null_plan  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.serving.dbo import dbo_decode_step  # noqa: E402
from repro_torch.serving.specdec import SDDecoder, draft_from_hidden  # noqa: E402
from repro_torch.sharding.dist import NullDist  # noqa: E402
from repro_torch.sharding.plans import null_plan  # noqa: E402

SD_ARCHS = ["starcoder2-3b", "olmoe-1b-7b", "gemma3-1b"]
PLAN, DIST = null_plan("decode"), NullDist()
JDIST = JaxNullDist()
PROMPT = [3, 5, 7, 11, 2, 4]
MAX_SEQ = 64
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)


def models(arch, seed=0):
    jcfg = jax_reduced(jax_arch(arch), dtype="float32")
    tcfg = reduced_config(get_arch(arch), dtype="float32")
    jp, _ = JM.init_model(jcfg, jax_null_plan("decode"), jax.random.PRNGKey(seed))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def clone(caches):
    return convert.tree_map(lambda t: t.clone(), caches)


def prefill(cfg, params, prompts, max_seq=MAX_SEQ):
    tokens = torch.tensor(prompts, dtype=torch.int32)
    tok, caches = M.prefill(params, {"tokens": tokens}, cfg)
    return tok, kvcache.pad_to_capacity(cfg, caches, tokens.shape[1], max_seq)


def greedy(cfg, params, prompts, n_tokens, max_seq=MAX_SEQ):
    """Plain sequential greedy decode: [B, n_tokens] with the prefill's
    token first."""
    tok, caches = prefill(cfg, params, prompts, max_seq)
    toks, pos = [tok], len(prompts[0])
    for _ in range(n_tokens - 1):
        tok, caches = M.decode_step(params, caches, tok, pos, cfg)
        toks.append(tok)
        pos += 1
    return torch.cat(toks, dim=1)


def assert_caches_close(got, want):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **CACHE_TOL)


# ---------------------------------------------------------------------------
# DBO step
# ---------------------------------------------------------------------------

def microbatches(cfg, params):
    """Two prefilled microbatches of 2 rows each at one prompt length."""
    a = prefill(cfg, params, [PROMPT, [9, 8, 1, 6, 5, 2]], 32)
    b = prefill(cfg, params, [[2, 7, 1, 8, 2, 8], [1, 4, 1, 4, 2, 1]], 32)
    return a, b


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma3-1b"])
def test_dbo_step_equivalent_to_plain(arch):
    """The interleaved DBO step gives the tokens and caches of two
    independent plain decode steps (it only re-orders independent work).
    The decode writes caches in place, so each side gets its own copy."""
    _, cfg, _, params = models(arch)
    (ta, ca), (tb, cb) = microbatches(cfg, params)
    pos = len(PROMPT)
    na, pa = M.decode_step(params, clone(ca), ta, pos, cfg)
    nb, pb = M.decode_step(params, clone(cb), tb, pos, cfg)
    da, db, dca, dcb = dbo_decode_step(params, clone(ca), clone(cb), ta, tb,
                                       pos, cfg, PLAN, DIST)
    assert torch.equal(da, na) and torch.equal(db, nb)
    assert_caches_close(dca, pa)
    assert_caches_close(dcb, pb)


def test_dbo_step_matches_jax():
    """The port's DBO step against the JAX ``dbo_decode_step`` from the same
    caches (converted from the JAX prefill), olmoe-1b-7b."""
    jcfg, tcfg, jp, tp = models("olmoe-1b-7b")
    jplan = jax_null_plan("prefill")
    outs = []
    for prompts in ([PROMPT, [9, 8, 1, 6, 5, 2]], [[2, 7, 1, 8, 2, 8], [1, 4, 1, 4, 2, 1]]):
        tok, jc = JM.prefill(jp, {"tokens": jnp.asarray(prompts, jnp.int32)}, jcfg,
                             jplan, JDIST)
        jc = jkv.pad_to_capacity(jcfg, jc, len(PROMPT), 32)
        tc = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
        outs.append((tok, jc, tc))
    (ja, jca, tca), (jb, jcb, tcb) = outs
    pos = len(PROMPT)
    wa, wb, wca, wcb = jax_dbo_step(jp, jca, jcb, ja, jb, jnp.int32(pos), jcfg,
                                    jax_null_plan("decode"), JDIST)
    ga, gb, gca, gcb = dbo_decode_step(tp, tca, tcb, torch.tensor(np.asarray(ja)),
                                       torch.tensor(np.asarray(jb)), pos, tcfg,
                                       PLAN, DIST)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    for got, want in ((gca, wca), (gcb, wcb)):
        assert_caches_close(got, convert.unstack_layers(
            jax.tree.map(np.asarray, want), tcfg))


# ---------------------------------------------------------------------------
# speculative decoding: SD == greedy, any draft, and == the JAX decoder
# ---------------------------------------------------------------------------

def bad_draft(params, caches, cur_tok, pos):
    """Adversarial draft: constant garbage -> acceptance must just be 1."""
    return torch.full((cur_tok.shape[0], 3), 12345 % 500, dtype=torch.int32)


def jax_bad_draft(params, caches, cur_tok, pos):
    return jnp.full((cur_tok.shape[0], 3), 12345 % 500, jnp.int32)


def sd_both(arch, draft_fn, jax_draft_fn, n_tokens=8, prompts=(PROMPT,)):
    """(port SD tokens, port stats, JAX SD tokens, JAX stats, greedy), each
    [B, n_tokens] with the prefill's token first. The port's decoder takes
    the JAX decoder's draft heads, converted."""
    jcfg, tcfg, jp, tp = models(arch)
    jdec = JaxSDDecoder(jcfg, jp, spec_m=4, draft_fn=jax_draft_fn)
    heads = convert.draft_heads_from_jax([np.asarray(h) for h in jdec.heads],
                                         device="cpu")
    dec = SDDecoder(tcfg, tp, spec_m=4, draft_fn=draft_fn, heads=heads,
                    device="cpu")
    L = len(prompts[0])
    tok, caches = prefill(tcfg, tp, list(prompts))
    toks, _, stats = dec.generate(caches, tok, L, n_tokens - 1)
    got = torch.cat([tok, toks], dim=1)

    jtok, jc = JM.prefill(jp, {"tokens": jnp.asarray(prompts, jnp.int32)}, jcfg,
                          jax_null_plan("prefill"), JDIST)
    jc = jkv.pad_to_capacity(jcfg, jc, L, MAX_SEQ)
    jtoks, _, jstats = jdec.generate(jc, jtok, L, n_tokens - 1)
    want = np.concatenate([np.asarray(jtok), np.asarray(jtoks)], axis=1)
    return got, stats, want, jstats, greedy(tcfg, tp, list(prompts), n_tokens)


@pytest.mark.parametrize("arch", SD_ARCHS)
def test_sd_equals_greedy_bad_draft(arch):
    got, stats, want, jstats, ref = sd_both(arch, bad_draft, jax_bad_draft)
    assert torch.equal(got, ref), f"{arch}: SD diverged from greedy"
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats == jstats and stats["mean_accepted"] >= 1.0


@pytest.mark.parametrize("arch", SD_ARCHS)
def test_sd_equals_greedy_medusa_heads(arch):
    """Untrained Medusa heads (the JAX decoder's, converted): output must
    still equal greedy, through partial-acceptance rollbacks."""
    got, stats, want, jstats, ref = sd_both(arch, None, None)
    assert torch.equal(got, ref), f"{arch}: SD diverged from greedy"
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats == jstats


def test_draft_heads_match_jax():
    jcfg, tcfg, jp, tp = models("gemma3-1b")
    jdec = JaxSDDecoder(jcfg, jp, spec_m=4)
    heads = convert.draft_heads_from_jax([np.asarray(h) for h in jdec.heads],
                                         device="cpu")
    tok = np.array([[3], [17], [400]], np.int32)
    want = jdec.draft(None, jnp.asarray(tok), 0)
    from repro_torch.models.layers import common as TC
    h = TC.embed(tp["embed"], torch.tensor(tok), tcfg, PLAN, DIST)
    np.testing.assert_array_equal(draft_from_hidden(heads, h).numpy(),
                                  np.asarray(want))
    assert [tuple(w.shape) for w in heads] == [(tcfg.d_model, tcfg.vocab_size)] * 3


@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma3-1b"])
def test_sd_perfect_draft_accepts_all(arch):
    """Oracle draft (the model's own continuation) -> every iteration
    accepts spec_m tokens; on gemma3 the verify steps wrap the ring."""
    _, cfg, _, params = models(arch)
    n_tokens = 13
    ref = greedy(cfg, params, [PROMPT], n_tokens + 4)
    L = len(PROMPT)

    def oracle(params_, caches_, cur_tok, pos):
        i = pos - L                     # cur_tok is ref[:, i]
        return ref[:, i + 1:i + 4].to(torch.int32)

    dec = SDDecoder(cfg, params, spec_m=4, draft_fn=oracle, device="cpu")
    tok, caches = prefill(cfg, params, [PROMPT])
    toks, _, stats = dec.generate(caches, tok, L, n_tokens - 1)
    assert torch.equal(torch.cat([tok, toks], dim=1), ref[:, :n_tokens])
    assert stats["mean_accepted"] == 4.0 and stats["iterations"] == 3


def test_sd_batch_mixed_acceptance_mirrors_jax_gemma3():
    """The reference issue, pinned: at B=2 on gemma3 (ring buffers), row 0
    with an oracle draft (accepts 4) and row 1 with a constant draft
    (accepts 1). ``generate`` commits the minimum, 1, while the rollback
    restores row 0's rings at its own acceptance, 4 steps on: row 0 leaves
    greedy once the ring has wrapped, row 1 stays greedy. The port gives
    the JAX decoder's tokens exactly."""
    prompts = [PROMPT, [9, 8, 1, 6, 5, 2]]
    n_tokens = 12
    _, cfg, _, params = models("gemma3-1b")
    ref = greedy(cfg, params, prompts, n_tokens + 4)
    L = len(PROMPT)

    def draft(pos):
        i = pos - L
        return np.stack([ref[0, i + 1:i + 4].numpy(),
                         np.full(3, 12345 % 500)]).astype(np.int32)

    got, stats, want, jstats, _ = sd_both(
        "gemma3-1b", lambda p, c, t, pos: torch.from_numpy(draft(pos)),
        lambda p, c, t, pos: jnp.asarray(draft(pos)), n_tokens, prompts)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats == jstats and stats["mean_accepted"] == 1.0
    assert torch.equal(got[1], ref[1, :n_tokens])
    assert not torch.equal(got[0], ref[0, :n_tokens])


def test_sd_decoder_defaults_to_the_card(monkeypatch):
    _, cfg, _, params = models("starcoder2-3b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SDDecoder(cfg, params)
    assert SDDecoder(cfg, params, device="cpu").heads[0].device.type == "cpu"
