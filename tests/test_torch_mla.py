"""The port's Multi-head Latent Attention (``repro_torch.models.layers.mla``)
and deepseek-v3 against the JAX package, on reduced deepseek-v3 (latent
rank 32, rope dims 8), float32: the prefill and its latent cache, decode
at a scalar position, at one position per row (against the JAX decode of
each row alone) and past the cache (the JAX clamped write of the new
latent), the caches' shapes and leaf classes, prefill and decode logits,
the engine token for token against the JAX engine, and the DBO step."""
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
from repro.models.layers import mla as JMLA  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro.serving.dbo import dbo_decode_step as jax_dbo_step  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.sharding.dist import NullDist as JaxNullDist  # noqa: E402
from repro.sharding.plans import null_plan as jax_null_plan  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import common as TC  # noqa: E402
from repro_torch.models.layers import mla as TMLA  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.serving.dbo import dbo_decode_step  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.sharding.dist import Dist, NullDist  # noqa: E402
from repro_torch.sharding.plans import null_plan  # noqa: E402

ARCH = "deepseek-v3"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
JDIST, DIST = JaxNullDist(), NullDist()
JPLAN, PLAN = jax_null_plan("decode"), null_plan("decode")


def models(seed=0):
    jcfg = jax_reduced(jax_arch(ARCH), dtype="float32")
    tcfg = reduced_config(get_arch(ARCH), dtype="float32")
    jp, _ = JM.init_model(jcfg, JPLAN, jax.random.PRNGKey(seed))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def layer0(jp, tp):
    """Layer 0's MLA params on both sides."""
    jl = jax.tree.map(lambda a: a[0], jp["stack"]["periods"][0])
    return jl["mixer"], tp["stack"][0]["mixer"]


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(t, j, tol=CACHE_TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def latent_cache(cfg, seed, b, s):
    return (rand(seed, b, s, cfg.mla_kv_lora_rank),
            rand(seed + 1, b, s, cfg.mla_rope_head_dim))


def jax_decode(jm, jcfg, x, c_kv, k_rope, pos):
    return JMLA.mla_decode(jm, jnp.asarray(x), {"c_kv": jnp.asarray(c_kv),
                                                "k_rope": jnp.asarray(k_rope)},
                           jnp.int32(pos), jcfg, JPLAN, JDIST)


def port_decode(tm, tcfg, x, c_kv, k_rope, pos):
    cache = {"c_kv": torch.from_numpy(c_kv.copy()),
             "k_rope": torch.from_numpy(k_rope.copy())}
    return TMLA.mla_decode(tm, torch.from_numpy(x), cache, pos, tcfg, PLAN, DIST)


def test_config_and_reduction_match_jax():
    """The registry entry and its reduction are the JAX package's, field for
    field; the 3 leading dense layers are MoE as in JAX."""
    assert repr(get_arch(ARCH)) == repr(jax_arch(ARCH))
    assert repr(reduced_config(get_arch(ARCH))) == repr(jax_reduced(jax_arch(ARCH)))
    full = get_arch(ARCH)
    assert (full.mla_kv_lora_rank, full.mla_rope_head_dim, full.num_layers) == (512, 64, 61)
    # the three leading dense layers stay MoE, as in the JAX config
    assert all(s.ffn == "moe" for s in full.layer_specs)
    red = reduced_config(full)
    assert (red.mla_kv_lora_rank, red.mla_q_lora_rank, red.mla_rope_head_dim) == (32, 32, 8)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def test_init_mla_shapes_and_dtypes_match_jax():
    jcfg = jax_reduced(jax_arch(ARCH))
    tcfg = reduced_config(get_arch(ARCH))
    jm, _ = JMLA.init_mla(jcfg, jax_null_plan("decode"), jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    tm = TMLA.init_mla(tcfg, PLAN, gen)
    assert set(tm) == set(jm)
    for k, v in jm.items():
        assert tuple(tm[k].shape) == v.shape, k
        assert str(tm[k].dtype).split(".")[-1] == str(v.dtype), k


@pytest.mark.parametrize("s", [1, 7, 13])
def test_mla_fwd_and_cache_match_jax(s):
    jcfg, tcfg, jp, tp = models()
    jm, tm = layer0(jp, tp)
    x = rand(s, 2, s, tcfg.d_model)
    yj, cj = JMLA.mla_fwd(jm, jnp.asarray(x), jcfg, jax_null_plan("prefill"), JDIST,
                          make_cache=True)
    yt, ct = TMLA.mla_fwd(tm, torch.from_numpy(x), tcfg, null_plan("prefill"), DIST,
                          make_cache=True)
    close(yt, yj, LOGIT_TOL)
    assert set(ct) == {"c_kv", "k_rope"}
    for n in ct:
        assert ct[n].shape == cj[n].shape
        close(ct[n], cj[n])


def test_mla_rms_uses_its_own_eps():
    """``_rms`` keeps eps 1e-6 and 1 + scale, not ``cfg.norm_eps``."""
    x = rand(3, 2, 5, 16) * 1e-3
    sc = rand(4, 16)
    got = TMLA._rms(torch.from_numpy(x), torch.from_numpy(sc))
    close(got, JMLA._rms(jnp.asarray(x), jnp.asarray(sc)))


@pytest.mark.parametrize("pos", [0, 5, 15])
def test_mla_decode_scalar_pos_matches_jax(pos):
    jcfg, tcfg, jp, tp = models()
    jm, tm = layer0(jp, tp)
    x = rand(pos, 3, 1, tcfg.d_model)
    c_kv, k_rope = latent_cache(tcfg, 7, 3, 16)
    yj, cj = jax_decode(jm, jcfg, x, c_kv, k_rope, pos)
    yt, ct = port_decode(tm, tcfg, x, c_kv, k_rope, pos)
    close(yt, yj, LOGIT_TOL)
    close(ct["c_kv"], cj["c_kv"])
    close(ct["k_rope"], cj["k_rope"])


def test_mla_decode_per_row_pos_matches_jax_rows():
    """A [B] position vector (the engine's decode): each row equals the JAX
    decode of that row alone at its own scalar position (the JAX engine
    vmaps that decode over slots)."""
    jcfg, tcfg, jp, tp = models()
    jm, tm = layer0(jp, tp)
    pos = [0, 3, 9, 15]
    x = rand(1, 4, 1, tcfg.d_model)
    c_kv, k_rope = latent_cache(tcfg, 11, 4, 16)
    yt, ct = port_decode(tm, tcfg, x, c_kv, k_rope, torch.tensor(pos))
    for b, p in enumerate(pos):
        yj, cj = jax_decode(jm, jcfg, x[b:b + 1], c_kv[b:b + 1], k_rope[b:b + 1], p)
        close(yt[b:b + 1], yj, LOGIT_TOL)
        close(ct["c_kv"][b:b + 1], cj["c_kv"])
        close(ct["k_rope"][b:b + 1], cj["k_rope"])


@pytest.mark.parametrize("pos", [16, 19, [16, 3, 40, 15]])
def test_mla_decode_past_capacity_matches_jax_clamped_write(pos):
    """A position at or past the cache's S rows (a dead slot in the
    engine) writes the NEW latent at row S - 1, as JAX's
    ``dynamic_update_slice`` clamps it, and attends over every row. This
    is not the GQA decode's rule, which writes the old row back."""
    jcfg, tcfg, jp, tp = models()
    jm, tm = layer0(jp, tp)
    S, B = 16, (4 if isinstance(pos, list) else 2)
    x = rand(2, B, 1, tcfg.d_model)
    c_kv, k_rope = latent_cache(tcfg, 13, B, S)
    pos_t = torch.tensor(pos) if isinstance(pos, list) else pos
    yt, ct = port_decode(tm, tcfg, x, c_kv, k_rope, pos_t)
    rows = pos if isinstance(pos, list) else [pos] * B
    for b, p in enumerate(rows):
        yj, cj = jax_decode(jm, jcfg, x[b:b + 1], c_kv[b:b + 1], k_rope[b:b + 1], p)
        close(yt[b:b + 1], yj, LOGIT_TOL)
        close(ct["c_kv"][b:b + 1], cj["c_kv"])
        close(ct["k_rope"][b:b + 1], cj["k_rope"])
        if p >= S:
            # the new latent, not the old row, sits at S - 1
            assert not np.allclose(ct["c_kv"][b, S - 1].numpy(), c_kv[b, S - 1])
            np.testing.assert_array_equal(ct["c_kv"][b, :S - 1].numpy(),
                                          c_kv[b, :S - 1])


def test_mla_fwd_refuses_a_sharded_sequence():
    """A sharded sequence now runs: on two gloo ranks (mesh (1, 2), the
    sequence over model, the weights replicated) MLA's forward equals the
    port's single device at 1e-5, its prefill cache gathered from the
    ranks' positions too, and two decode steps over the cache that
    ``pad_to_capacity`` gathers and replicates equal the single device's.
    (Held against JAX's single device on the 2x2 mesh, with the gradients,
    in ``test_torch_sharded_mixers.py``.)"""
    from repro_torch.launch import serve
    from torch_mixer_workers import mixer_layer
    _, tcfg, _, tp = models()
    tm = tp["stack"][0]["mixer"]
    x, feed = rand(1, 2, 8, tcfg.d_model), rand(2, 2, 2, 1, tcfg.d_model)
    job = dict(cfg=tcfg, params=tm, x=x, w=np.ones_like(x), feed=feed, cap=16)
    got = serve.spawn(mixer_layer, (job,), mesh_shape=(1, 2), transport="gloo",
                      device="cpu", timeout=120)[0]
    y, cache = TMLA.mla_fwd(tm, torch.from_numpy(x), tcfg, null_plan("prefill"), DIST,
                            make_cache=True)
    close(torch.from_numpy(got["y"]), y)
    cache = kvcache.pad_to_capacity(tcfg, [{"mixer": cache}], 8, 16)[0]["mixer"]
    for n in ("c_kv", "k_rope"):
        close(torch.from_numpy(got["relaid"][n]), cache[n])
    for i in range(2):
        yt, cache = TMLA.mla_decode(tm, torch.from_numpy(feed[i]), cache, 8 + i, tcfg,
                                    PLAN, DIST)
        close(torch.from_numpy(got["decode"][i]), yt)
    assert got["local_cache_shapes"]["c_kv"] == (2, 16, tcfg.mla_kv_lora_rank)


# ---------------------------------------------------------------------------
# caches: shapes, dtypes, leaf classes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_jax(dtype):
    jcfg = jax_reduced(jax_arch(ARCH), dtype=dtype)
    tcfg = reduced_config(get_arch(ARCH), dtype=dtype)
    jc, _ = JM.init_cache(jcfg, JPLAN, 3, 24)
    want = convert.unstack_layers(jax.tree.map(np.asarray, jc), tcfg)
    got = M.init_cache(tcfg, PLAN, 3, 24, device="cpu")
    assert [sorted(layer["mixer"]) for layer in got] == [["c_kv", "k_rope"]] * 2
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == w.dtype.name


def test_leaf_classes_and_pad_to_capacity_match_jax():
    """The latent leaves are positional with their sequence on dim 1:
    classify, pad_to_capacity and select_history treat them so."""
    jcfg, tcfg, jp, _ = models()
    prompt = jnp.asarray([[3, 5, 7, 11, 2]], jnp.int32)
    _, jc = JM.prefill(jp, {"tokens": prompt}, jcfg, jax_null_plan("prefill"), JDIST)
    tc = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    per = jkv.classify(jcfg, jc)["periods"]          # one position, 2 periods
    want_cls = [per[i % len(per)] for i in range(tcfg.num_layers)]
    assert kvcache.classify(tcfg, tc) == want_cls
    assert all(c == "positional" for layer in want_cls
               for c in layer["mixer"].values())
    jpad = jkv.pad_to_capacity(jcfg, jc, 5, 12)
    tpad = kvcache.pad_to_capacity(tcfg, tc, 5, 12)
    want = convert.unstack_layers(jax.tree.map(np.asarray, jpad), tcfg)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(tpad)):
        assert tuple(g.shape) == w.shape and g.shape[1] == 12
        np.testing.assert_array_equal(g.numpy(), w)
    hist = [kvcache.snapshot_recurrent(tcfg, tpad)]
    assert all(v is None for layer in hist[0] for v in layer["mixer"].values())
    sel = kvcache.select_history(tcfg, tpad, hist, 0)
    assert all(s["mixer"][n] is t["mixer"][n] for s, t in zip(sel, tpad)
               for n in ("c_kv", "k_rope"))


# ---------------------------------------------------------------------------
# the model: logits, engine, DBO
# ---------------------------------------------------------------------------

def jax_logits(params, cfg, mode, tokens, caches=None, pos=None):
    plan = jax_null_plan(mode)
    x = JC.embed(params["embed"], tokens, cfg, plan, JDIST)
    x, caches, _ = JT.apply_stack(params["stack"], x, cfg, plan, JDIST,
                                  mode=mode, caches=caches, pos=pos)
    x = JC.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return JC.lm_logits(params["embed"], x[:, -1:], cfg, plan, JDIST), caches


def test_prefill_and_decode_logits_match_jax():
    """Prefill of 11 tokens, then 8 greedy decode steps: logits within 1e-4,
    tokens equal, the latent caches within 1e-5 after the last step."""
    jcfg, tcfg, jp, tp = models()
    prompt = np.array([[3, 5, 7, 11, 2, 4, 9, 8, 1, 6, 5]], np.int32)
    L, S = prompt.shape[1], 24
    lj, jc = jax_logits(jp, jcfg, "prefill", jnp.asarray(prompt))
    lt, tc = M.prefill_logits(tp, {"tokens": torch.from_numpy(prompt)}, tcfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    jc = jkv.pad_to_capacity(jcfg, jc, L, S)
    tc = kvcache.pad_to_capacity(tcfg, tc, L, S)
    for pos in range(L, L + 8):
        tok = np.asarray(JC.greedy_sample(lj, jcfg, JPLAN, JDIST))
        np.testing.assert_array_equal(
            TC.greedy_sample(lt, tcfg, PLAN, DIST).numpy(), tok)
        lj, jc = jax_logits(jp, jcfg, "decode", jnp.asarray(tok), jc, jnp.int32(pos))
        lt, tc = M.decode_logits(tp, tc, torch.tensor(tok), pos, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    want = convert.unstack_layers(jax.tree.map(np.asarray, jc), tcfg)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(tc)):
        np.testing.assert_allclose(g.numpy(), w, **CACHE_TOL)


def prompts(n, seed, lengths=(3, 6, 11)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 500, lengths[i % len(lengths)]).tolist()
            for i in range(n)]


def test_engine_matches_jax_engine():
    """Requests over 2 slots, slot 1 reused, the caches compared after the
    run. Slot 0's request stops at the cache's end; slot 1's runs on for
    nine more waves, so the dead slot decodes past the cache (the clamped
    write of the new latent at row S - 1) as in the JAX engine."""
    jcfg, tcfg, jp, tp = models()
    reqs = prompts(3, seed=3, lengths=(11, 3, 6))
    new = [30, 4, 30]
    jeng = JaxEngine(jcfg, jp, max_batch=2, max_seq=24, eos_id=-1)
    teng = Engine(tcfg, tp, max_batch=2, max_seq=24, eos_id=-1, device="cpu")
    for p, n in zip(reqs, new):
        jeng.submit(p, max_new_tokens=n)
        teng.submit(p, max_new_tokens=n)
    want, got = jeng.run(), teng.run()
    assert got == want
    np.testing.assert_array_equal(teng.pos.numpy(), np.asarray(jeng.pos))
    assert int(teng.pos.max()) > teng.max_seq + 5
    jcache = convert.unstack_layers(jax.tree.map(np.asarray, jeng.caches), tcfg)
    for w, g in zip(jax.tree.leaves(jcache), jax.tree.leaves(teng.caches)):
        np.testing.assert_allclose(g.numpy(), w, **CACHE_TOL)


def test_dbo_step_matches_jax():
    """The port's DBO step against the JAX ``dbo_decode_step`` from the same
    prefilled latent caches: tokens equal, caches within 1e-5; and equal to
    two plain decode steps of the port."""
    jcfg, tcfg, jp, tp = models()
    outs = []
    for ps in ([[3, 5, 7, 11, 2, 4], [9, 8, 1, 6, 5, 2]],
               [[2, 7, 1, 8, 2, 8], [1, 4, 1, 4, 2, 1]]):
        tok, jc = JM.prefill(jp, {"tokens": jnp.asarray(ps, jnp.int32)}, jcfg,
                             jax_null_plan("prefill"), JDIST)
        jc = jkv.pad_to_capacity(jcfg, jc, 6, 16)
        outs.append((tok, jc, convert.cache_from_jax(jax.tree.map(np.asarray, jc),
                                                     tcfg, device="cpu")))
    (ja, jca, tca), (jb, jcb, tcb) = outs
    wa, wb, wca, wcb = jax_dbo_step(jp, jca, jcb, ja, jb, jnp.int32(6), jcfg,
                                    JPLAN, JDIST)
    ta, tb = torch.tensor(np.asarray(ja)), torch.tensor(np.asarray(jb))
    clone = lambda c: convert.tree_map(torch.clone, c)  # noqa: E731
    na, pa = M.decode_step(tp, clone(tca), ta, 6, tcfg)
    nb, pb = M.decode_step(tp, clone(tcb), tb, 6, tcfg)
    ga, gb, gca, gcb = dbo_decode_step(tp, tca, tcb, ta, tb, 6, tcfg, PLAN, DIST)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    assert torch.equal(ga, na) and torch.equal(gb, nb)
    for got, want, plain in ((gca, wca, pa), (gcb, wcb, pb)):
        want = convert.unstack_layers(jax.tree.map(np.asarray, want), tcfg)
        for w, g, p in zip(jax.tree.leaves(want), jax.tree.leaves(got),
                           jax.tree.leaves(plain)):
            np.testing.assert_allclose(g.numpy(), w, **CACHE_TOL)
            assert torch.equal(g, p)
