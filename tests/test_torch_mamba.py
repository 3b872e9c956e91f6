"""The port's Mamba mixer (``repro_torch.models.layers.mamba``) and
jamba-v0.1-52b against the JAX package, on reduced jamba (d_model 64,
d_inner 128, d_state 16, d_conv 4; one period of seven Mamba layers and
one attention layer), float32: the chunked selective scan, the prefill
and its conv/ssm cache, decode, prefill + decode against one forward over
the whole sequence, the caches' shapes, dtypes and leaf classes, logits,
the engine token for token against the JAX engine, and speculative
decoding rolling the SSM state back (the JAX ``ARCHS_STATEFUL`` tests)."""
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
from repro.models.layers import mamba as JMB  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.specdec import SDDecoder as JaxSDDecoder  # noqa: E402
from repro.sharding.dist import NullDist as JaxNullDist  # noqa: E402
from repro.sharding.plans import null_plan as jax_null_plan  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import common as TC  # noqa: E402
from repro_torch.models.layers import mamba as TMB  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.specdec import SDDecoder  # noqa: E402
from repro_torch.sharding.dist import Dist, NullDist  # noqa: E402
from repro_torch.sharding.plans import null_plan  # noqa: E402

ARCH = "jamba-v0.1-52b"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
JDIST, DIST = JaxNullDist(), NullDist()
JPLAN, PLAN = jax_null_plan("decode"), null_plan("decode")
PROMPT = [3, 5, 7, 11, 2, 4]
MAX_SEQ = 64


def models(seed=0):
    jcfg = jax_reduced(jax_arch(ARCH), dtype="float32")
    tcfg = reduced_config(get_arch(ARCH), dtype="float32")
    jp, _ = JM.init_model(jcfg, JPLAN, jax.random.PRNGKey(seed))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def layer0(jp, tp):
    """Layer 0's Mamba params on both sides (period position 0)."""
    jl = jax.tree.map(lambda a: a[0], jp["stack"]["periods"][0])
    return jl["mixer"], tp["stack"][0]["mixer"]


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(t, j, tol=CACHE_TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def test_config_and_reduction_match_jax():
    """The registry entry and its reduction are the JAX package's, field for
    field; attention at position 4 of the period of 8."""
    assert repr(get_arch(ARCH)) == repr(jax_arch(ARCH))
    assert repr(reduced_config(get_arch(ARCH))) == repr(jax_reduced(jax_arch(ARCH)))
    full = get_arch(ARCH)
    assert [s.mixer for s in full.period].index("attn") == 4
    assert [s.ffn for s in full.period] == ["dense", "moe"] * 4
    assert (full.n_periods, full.num_kv_heads, full.moe.num_experts) == (4, 8, 16)


# ---------------------------------------------------------------------------
# the selective scan
# ---------------------------------------------------------------------------

def scan_inputs(s, seed=0, b=2, di=12, ds=5):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, s, di)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((b, s, di))) * 0.1).astype(np.float32)
    bb = rng.standard_normal((b, s, ds)).astype(np.float32)
    c = rng.standard_normal((b, s, ds)).astype(np.float32)
    log_a = np.log(np.tile(np.arange(1, ds + 1, dtype=np.float32), (di, 1)))
    d_skip = rng.standard_normal(di).astype(np.float32)
    h0 = rng.standard_normal((b, di, ds)).astype(np.float32)
    return u, dt, bb, c, log_a, d_skip, h0


@pytest.mark.parametrize("chunk", [4, 128])
@pytest.mark.parametrize("s", [5, 128, 300])
def test_ssm_scan_matches_jax(s, chunk):
    """Whole chunks, a padded tail chunk (5 % 4, 300 % 128) and a sequence
    shorter than the chunk; the state carried from a nonzero h0."""
    ins = scan_inputs(s, seed=s + chunk)
    yj, hj = JMB._ssm_scan(*(jnp.asarray(a) for a in ins), chunk=chunk)
    yt, ht = TMB._ssm_scan(*(torch.from_numpy(a) for a in ins), chunk=chunk)
    close(yt, yj)
    close(ht, hj)


def test_scan_chunk_equals_the_step_by_step_recurrence():
    """The doubling scan gives h_t = a_t h_{t-1} + b_t for every t, with
    decays close to 0 and to 1 (no cumulative-log overflow)."""
    rng = np.random.default_rng(1)
    a = np.exp(-rng.uniform(0, 30, (2, 128, 3, 4))).astype(np.float32)
    b = rng.standard_normal((2, 128, 3, 4)).astype(np.float32)
    a_cum, b_cum = TMB._scan_chunk(torch.from_numpy(a), torch.from_numpy(b))
    h0 = rng.standard_normal((2, 3, 4)).astype(np.float32)
    h = h0.copy()
    for t in range(128):
        h = a[:, t] * h + b[:, t]
        got = a_cum[:, t].numpy() * h0 + b_cum[:, t].numpy()
        np.testing.assert_allclose(got, h, atol=1e-5, rtol=1e-5)
    assert torch.isfinite(a_cum).all() and torch.isfinite(b_cum).all()


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba_shapes_and_dtypes_match_jax(dtype):
    """log_a and d_skip stay float32 in a bf16 model; dt_rank 0 means
    ceil(d_model / 16)."""
    jcfg = jax_reduced(jax_arch(ARCH), dtype=dtype)
    tcfg = reduced_config(get_arch(ARCH), dtype=dtype)
    jm, _ = JMB.init_mamba(jcfg, jax_null_plan("decode"), jax.random.PRNGKey(0))
    tm = TMB.init_mamba(tcfg, PLAN, torch.Generator().manual_seed(0))
    assert set(tm) == set(jm)
    for k, v in jm.items():
        assert tuple(tm[k].shape) == v.shape, k
        assert str(tm[k].dtype).split(".")[-1] == str(v.dtype), k
    assert tm["log_a"].dtype == tm["d_skip"].dtype == torch.float32
    assert TMB._dims(tcfg) == JMB._dims(jcfg) == (128, 4, 16, 4)
    # log(1..d_state) per channel, to the last bit but one (torch's and
    # XLA's log round differently)
    np.testing.assert_allclose(tm["log_a"].numpy(), np.asarray(jm["log_a"]), rtol=1e-6)


@pytest.mark.parametrize("s", [1, 2, 3, 9, 130])
def test_mamba_fwd_and_cache_match_jax(s):
    """Prompts shorter than d_conv - 1 (the conv tail left-padded with
    zeros), as long as it, longer, and past a scan chunk."""
    jcfg, tcfg, jp, tp = models()
    jm, tm = layer0(jp, tp)
    x = rand(s, 2, s, tcfg.d_model)
    yj, cj = JMB.mamba_fwd(jm, jnp.asarray(x), jcfg, jax_null_plan("prefill"), JDIST,
                           make_cache=True)
    yt, ct = TMB.mamba_fwd(tm, torch.from_numpy(x), tcfg, null_plan("prefill"), DIST,
                           make_cache=True)
    close(yt, yj, LOGIT_TOL)
    assert set(ct) == {"conv", "ssm"} and ct["ssm"].dtype == torch.float32
    for n in ct:
        assert ct[n].shape == cj[n].shape
        close(ct[n], cj[n])


def test_mamba_decode_matches_jax():
    jcfg, tcfg, jp, tp = models()
    jm, tm = layer0(jp, tp)
    x = rand(0, 3, 1, tcfg.d_model)
    conv, ssm = rand(1, 3, 3, 128), rand(2, 3, 128, 16)
    yj, cj = JMB.mamba_decode(jm, jnp.asarray(x), {"conv": jnp.asarray(conv),
                                                   "ssm": jnp.asarray(ssm)},
                              jcfg, JPLAN, JDIST)
    cache = {"conv": torch.from_numpy(conv.copy()), "ssm": torch.from_numpy(ssm.copy())}
    yt, ct = TMB.mamba_decode(tm, torch.from_numpy(x), cache, tcfg, PLAN, DIST)
    close(yt, yj, LOGIT_TOL)
    assert ct["conv"] is cache["conv"] and ct["ssm"] is cache["ssm"]   # in place
    close(ct["conv"], cj["conv"])
    close(ct["ssm"], cj["ssm"])


@pytest.mark.parametrize("split", [1, 2, 5, 12])
def test_prefill_then_decode_equals_one_forward(split):
    """Prefill of the first `split` tokens, then one decode step per token:
    the outputs and the final state equal one forward over all 16."""
    _, tcfg, jp, tp = models()
    tm = tp["stack"][0]["mixer"]
    x = torch.from_numpy(rand(5, 2, 16, tcfg.d_model))
    plan = null_plan("prefill")
    y_all, c_all = TMB.mamba_fwd(tm, x, tcfg, plan, DIST, make_cache=True)
    y0, cache = TMB.mamba_fwd(tm, x[:, :split], tcfg, plan, DIST, make_cache=True)
    ys = [y0]
    for t in range(split, 16):
        y, cache = TMB.mamba_decode(tm, x[:, t:t + 1], cache, tcfg, PLAN, DIST)
        ys.append(y)
    torch.testing.assert_close(torch.cat(ys, dim=1), y_all, atol=1e-4, rtol=1e-4)
    for n in ("conv", "ssm"):
        torch.testing.assert_close(cache[n], c_all[n], atol=1e-5, rtol=1e-5)


def test_mamba_refuses_sharding():
    """Megatron-SP Mamba runs on two gloo ranks (mesh (1, 2): the sequence
    and d_inner over model): its forward, prefill cache and two decode
    steps equal the port's single device at 1e-5. What it still refuses is
    a plan whose sequence axis is not its tp axis. (Held against JAX's
    single device on the 2x2 mesh, with the gradients, in
    ``test_torch_sharded_mixers.py``.)"""
    from repro_torch.launch import serve
    from torch_mixer_workers import mixer_layer
    _, tcfg, _, tp = models()
    tm = tp["stack"][0]["mixer"]
    x, feed = rand(1, 2, 8, tcfg.d_model), rand(2, 2, 2, 1, tcfg.d_model)
    job = dict(cfg=tcfg, params=tm, x=x, w=np.ones_like(x), feed=feed, cap=16)
    got = serve.spawn(mixer_layer, (job,), mesh_shape=(1, 2), transport="gloo",
                      device="cpu", timeout=120)[0]
    y, cache = TMB.mamba_fwd(tm, torch.from_numpy(x), tcfg, null_plan("prefill"), DIST,
                             make_cache=True)
    close(torch.from_numpy(got["y"]), y)
    for n in ("conv", "ssm"):
        close(torch.from_numpy(got["cache"][n]), cache[n])
    for i in range(2):
        yt, cache = TMB.mamba_decode(tm, torch.from_numpy(feed[i]), cache, tcfg, PLAN, DIST)
        close(torch.from_numpy(got["decode"][i]), yt)
    plan = dataclasses.replace(null_plan("prefill"), tp_axis="model")
    with pytest.raises(ValueError, match="Megatron-SP"):
        TMB.mamba_fwd(tm, torch.from_numpy(x), tcfg, plan, Dist({"model": 2}))


# ---------------------------------------------------------------------------
# caches: shapes, dtypes, leaf classes, rollback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_jax(dtype):
    """conv in the model's dtype, ssm float32; the attention layer's k, v."""
    jcfg = jax_reduced(jax_arch(ARCH), dtype=dtype)
    tcfg = reduced_config(get_arch(ARCH), dtype=dtype)
    jc, _ = JM.init_cache(jcfg, JPLAN, 3, 24)
    want = convert.unstack_layers(jax.tree.map(np.asarray, jc), tcfg)
    got = M.init_cache(tcfg, PLAN, 3, 24, device="cpu")
    assert [sorted(c["mixer"]) for c in got] == \
        [["k", "v"] if s.mixer == "attn" else ["conv", "ssm"] for s in tcfg.layer_specs]
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == w.dtype.name
    assert all(c["mixer"]["ssm"].dtype == torch.float32 for c in got if "ssm" in c["mixer"])


def prefilled(tcfg, tp, jcfg, jp, prompt, seq):
    _, jc = JM.prefill(jp, {"tokens": jnp.asarray([prompt], jnp.int32)}, jcfg,
                       jax_null_plan("prefill"), JDIST)
    _, tc = M.prefill(tp, {"tokens": torch.tensor([prompt])}, tcfg)
    return (jkv.pad_to_capacity(jcfg, jc, len(prompt), seq),
            kvcache.pad_to_capacity(tcfg, tc, len(prompt), seq))


def test_leaf_classes_and_pad_to_capacity_match_jax():
    """conv and ssm are recurrent and keep their shape (a prompt of
    d_conv - 1 = 3 tokens does not get its conv tail padded); the attention
    layer's k, v are padded. The padded caches equal the JAX ones."""
    jcfg, tcfg, jp, tp = models()
    jc, tc = prefilled(tcfg, tp, jcfg, jp, [3, 5, 7], 12)
    per = jkv.classify(jcfg, jc)["periods"]
    assert kvcache.classify(tcfg, tc) == [per[i] for i in range(8)]
    assert [c["mixer"].get("ssm") for c in per].count("recurrent") == 7
    want = convert.unstack_layers(jax.tree.map(np.asarray, jc), tcfg)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(tc)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **CACHE_TOL)
    assert tc[0]["mixer"]["conv"].shape == (1, 3, 128)
    assert tc[4]["mixer"]["k"].shape[2] == 12


def test_insert_snapshot_select_keep_the_f32_state():
    """In a bf16 model: insert_slot copies a request's state into a slot,
    snapshot_recurrent copies conv and ssm (and only them), select_history
    restores each row at its own step; ssm stays float32 throughout."""
    cfg = reduced_config(get_arch(ARCH))
    params = M.init_model(cfg, device="cpu", seed=0)
    _, sub = M.prefill(params, {"tokens": torch.tensor([PROMPT])}, cfg)
    sub = kvcache.pad_to_capacity(cfg, sub, len(PROMPT), 16)
    caches = M.init_cache(cfg, PLAN, 2, 16, device="cpu")
    kvcache.insert_slot(caches, sub, 1)
    assert caches[0]["mixer"]["ssm"].dtype == torch.float32
    assert caches[0]["mixer"]["conv"].dtype == torch.bfloat16
    assert torch.equal(caches[0]["mixer"]["ssm"][1], sub[0]["mixer"]["ssm"][0])
    assert not caches[0]["mixer"]["ssm"][0].any()
    hist = []
    tok = torch.tensor([[1], [2]])
    for i in range(3):
        _, caches = M.decode_step(params, caches, tok, len(PROMPT) + i, cfg)
        hist.append(kvcache.snapshot_recurrent(cfg, caches))
    assert hist[0][4]["mixer"] == {"k": None, "v": None}
    assert hist[0][0]["mixer"]["ssm"] is not caches[0]["mixer"]["ssm"]
    sel = kvcache.select_history(cfg, caches, hist, torch.tensor([2, 0]))
    for n in ("conv", "ssm"):
        assert sel[0]["mixer"][n].dtype == caches[0]["mixer"][n].dtype
        assert torch.equal(sel[0]["mixer"][n][0], hist[2][0]["mixer"][n][0])
        assert torch.equal(sel[0]["mixer"][n][1], hist[0][0]["mixer"][n][1])
    assert sel[4]["mixer"]["k"] is caches[4]["mixer"]["k"]


# ---------------------------------------------------------------------------
# the model: logits, engine, speculative decoding
# ---------------------------------------------------------------------------

def jax_logits(params, cfg, mode, tokens, caches=None, pos=None):
    plan = jax_null_plan(mode)
    x = JC.embed(params["embed"], tokens, cfg, plan, JDIST)
    x, caches, _ = JT.apply_stack(params["stack"], x, cfg, plan, JDIST,
                                  mode=mode, caches=caches, pos=pos)
    x = JC.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return JC.lm_logits(params["embed"], x[:, -1:], cfg, plan, JDIST), caches


@pytest.mark.parametrize("L", [2, 11])
def test_prefill_and_decode_logits_match_jax(L):
    """Prefill of L tokens (2 is shorter than the conv tail), then 8 greedy
    decode steps: logits within 1e-4, tokens equal, caches within 1e-5."""
    jcfg, tcfg, jp, tp = models()
    prompt = np.array([[3, 5, 7, 11, 2, 4, 9, 8, 1, 6, 5][:L]], np.int32)
    S = 24
    lj, jc = jax_logits(jp, jcfg, "prefill", jnp.asarray(prompt))
    lt, tc = M.prefill_logits(tp, {"tokens": torch.from_numpy(prompt)}, tcfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    jc = jkv.pad_to_capacity(jcfg, jc, L, S)
    tc = kvcache.pad_to_capacity(tcfg, tc, L, S)
    for pos in range(L, L + 8):
        tok = np.asarray(JC.greedy_sample(lj, jcfg, JPLAN, JDIST))
        np.testing.assert_array_equal(TC.greedy_sample(lt, tcfg, PLAN, DIST).numpy(), tok)
        lj, jc = jax_logits(jp, jcfg, "decode", jnp.asarray(tok), jc, jnp.int32(pos))
        lt, tc = M.decode_logits(tp, tc, torch.tensor(tok), pos, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    want = convert.unstack_layers(jax.tree.map(np.asarray, jc), tcfg)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(tc)):
        np.testing.assert_allclose(g.numpy(), w, **CACHE_TOL)


def test_engine_matches_jax_engine():
    """5 requests over 2 slots (prompts of 2, 6 and 11 tokens), slots
    reused: each slot's SSM state comes from its own prefill."""
    jcfg, tcfg, jp, tp = models()
    rng = np.random.default_rng(3)
    reqs = [rng.integers(1, 500, n).tolist() for n in (2, 6, 11, 2, 6)]
    jeng = JaxEngine(jcfg, jp, max_batch=2, max_seq=32, eos_id=-1)
    teng = Engine(tcfg, tp, max_batch=2, max_seq=32, eos_id=-1, device="cpu")
    for i, p in enumerate(reqs):
        jeng.submit(p, max_new_tokens=6 + i)
        teng.submit(p, max_new_tokens=6 + i)
    want, got = jeng.run(), teng.run()
    assert got == want
    assert all(len(got[i]) == 7 + i for i in range(5))


def greedy(cfg, params, prompt, n_tokens, max_seq=MAX_SEQ):
    tok, caches = M.prefill(params, {"tokens": torch.tensor([prompt])}, cfg)
    caches = kvcache.pad_to_capacity(cfg, caches, len(prompt), max_seq)
    toks = [tok]
    for pos in range(len(prompt), len(prompt) + n_tokens - 1):
        tok, caches = M.decode_step(params, caches, tok, pos, cfg)
        toks.append(tok)
    return torch.cat(toks, dim=1)


def bad_draft(params, caches, cur_tok, pos):
    return torch.full((cur_tok.shape[0], 3), 12345 % 500, dtype=torch.int32)


def jax_bad_draft(params, caches, cur_tok, pos):
    return jnp.full((cur_tok.shape[0], 3), 12345 % 500, jnp.int32)


@pytest.mark.parametrize("draft", ["bad", "heads"])
def test_sd_equals_greedy_and_jax(draft):
    """A constant draft (every verify rejects, the SSM state rolls back
    three steps) and untrained Medusa heads (the JAX decoder's, converted:
    partial acceptance): the port's SD equals greedy and the JAX SD, token
    for token and in its acceptance statistics."""
    jcfg, tcfg, jp, tp = models()
    fn, jfn = (bad_draft, jax_bad_draft) if draft == "bad" else (None, None)
    jdec = JaxSDDecoder(jcfg, jp, spec_m=4, draft_fn=jfn)
    heads = convert.draft_heads_from_jax([np.asarray(h) for h in jdec.heads],
                                         device="cpu")
    dec = SDDecoder(tcfg, tp, spec_m=4, draft_fn=fn, heads=heads, device="cpu")
    L, n = len(PROMPT), 10
    tok, caches = M.prefill(tp, {"tokens": torch.tensor([PROMPT])}, tcfg)
    caches = kvcache.pad_to_capacity(tcfg, caches, L, MAX_SEQ)
    toks, _, stats = dec.generate(caches, tok, L, n - 1)
    got = torch.cat([tok, toks], dim=1)
    jtok, jc = JM.prefill(jp, {"tokens": jnp.asarray([PROMPT], jnp.int32)}, jcfg,
                          jax_null_plan("prefill"), JDIST)
    jc = jkv.pad_to_capacity(jcfg, jc, L, MAX_SEQ)
    jtoks, _, jstats = jdec.generate(jc, jtok, L, n - 1)
    assert torch.equal(got, greedy(tcfg, tp, PROMPT, n))
    np.testing.assert_array_equal(got.numpy(), np.concatenate(
        [np.asarray(jtok), np.asarray(jtoks)], axis=1))
    assert stats == jstats
    if draft == "bad":
        assert stats["mean_accepted"] == 1.0


def test_sd_oracle_accepts_all():
    """The greedy continuation as the draft: every verify accepts spec_m."""
    _, tcfg, _, tp = models()
    n = 13
    ref = greedy(tcfg, tp, PROMPT, n + 4)
    L = len(PROMPT)

    def oracle(params_, caches_, cur_tok, pos):
        i = pos - L
        return ref[:, i + 1:i + 4].to(torch.int32)

    dec = SDDecoder(tcfg, tp, spec_m=4, draft_fn=oracle, device="cpu")
    tok, caches = M.prefill(tp, {"tokens": torch.tensor([PROMPT])}, tcfg)
    caches = kvcache.pad_to_capacity(tcfg, caches, L, MAX_SEQ)
    toks, _, stats = dec.generate(caches, tok, L, n - 1)
    assert torch.equal(torch.cat([tok, toks], dim=1), ref[:, :n])
    assert stats["mean_accepted"] == 4.0 and stats["iterations"] == 3
