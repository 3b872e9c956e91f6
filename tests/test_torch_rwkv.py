"""The port's RWKV6 block (``repro_torch.models.layers.rwkv``) and
rwkv6-1.6b against the JAX package, on reduced rwkv6 (d_model 64, one WKV
head of 64; the layer tests at d_model 128, two heads), float32: the
chunked WKV scan, the time and channel mixes and their caches, decode,
prefill + decode against one forward, the caches' shapes, dtypes and leaf
classes (the first layer with an "ffn" cache group), logits, the engine
token for token against the JAX engine, and speculative decoding rolling
the matrix state and both token shifts back (rwkv6 is one of the JAX
``ARCHS_STATEFUL`` of ``tests/test_serving.py``)."""

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
from repro.models.layers import rwkv as JR  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.serving.specdec import SDDecoder as JaxSDDecoder  # noqa: E402
from repro.sharding.dist import NullDist as JaxNullDist  # noqa: E402
from repro.sharding.plans import null_plan as jax_null_plan  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import common as TC  # noqa: E402
from repro_torch.models.layers import rwkv as TR  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.specdec import SDDecoder  # noqa: E402
from repro_torch.sharding.dist import NullDist  # noqa: E402
from repro_torch.sharding.plans import null_plan  # noqa: E402

ARCH = "rwkv6-1.6b"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
JDIST, DIST = JaxNullDist(), NullDist()
JPLAN, PLAN = jax_null_plan("decode"), null_plan("decode")
PROMPT = [3, 5, 7, 11, 2, 4]
MAX_SEQ = 64


def models(seed=0, dtype="float32", **overrides):
    jcfg = jax_reduced(jax_arch(ARCH), dtype=dtype, **overrides)
    tcfg = reduced_config(get_arch(ARCH), dtype=dtype, **overrides)
    jp, _ = JM.init_model(jcfg, JPLAN, jax.random.PRNGKey(seed))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def layer0(jp, tp):
    """Layer 0's params on both sides (period position 0)."""
    return jax.tree.map(lambda a: a[0], jp["stack"]["periods"][0]), tp["stack"][0]


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def close(t, j, tol=CACHE_TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def test_config_and_reduction():
    """Attention-free, 2048 / 64 = 32 WKV heads; the reduction keeps one
    head of 64."""
    full = get_arch(ARCH)
    assert repr(full) == repr(jax_arch(ARCH))
    assert full.attn_kind == "none" and {s.mixer for s in full.layer_specs} == {"rwkv"}
    assert TR._dims(full) == JR._dims(jax_arch(ARCH)) == (32, 64)
    assert TR._dims(reduced_config(full)) == (1, 64)


# ---------------------------------------------------------------------------
# the WKV scan
# ---------------------------------------------------------------------------

def scan_inputs(s, seed=0, b=2, nh=3, hd=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, nh, hd)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, s, nh, hd)) - 1)).astype(np.float32)
    u = rng.standard_normal((nh, hd)).astype(np.float32)
    s0 = rng.standard_normal((b, nh, hd, hd)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("s", [1, 63, 64, 65, 130])
def test_wkv_scan_matches_jax(s):
    """One step, a chunk less one, a whole chunk, a chunk and one (the tail
    chunk padded with w = 1) and past two chunk boundaries, from a nonzero
    carried state."""
    ins = scan_inputs(s, seed=s)
    oj, sj = JR._wkv_scan(*(jnp.asarray(a) for a in ins))
    ot, st = TR._wkv_scan(*(torch.from_numpy(a) for a in ins))
    assert ot.shape == (2, s, 3, 8) and st.shape == (2, 3, 8, 8)
    close(ot, oj)
    close(st, sj)


def test_wkv_scan_equals_the_step_by_step_recurrence():
    """The whole-tensor scan gives out_t = r_t (s_{t-1} + u k_t v_t^T) and
    s_t = diag(w_t) s_{t-1} + k_t v_t^T for every t, with decays close to 0
    and to 1 (no cumulative-log overflow)."""
    rng = np.random.default_rng(2)
    r, k, v, _, u, s0 = scan_inputs(70, seed=2, b=1, nh=2, hd=4)
    w = np.exp(-rng.uniform(0, 40, r.shape)).astype(np.float32)
    ot, st = TR._wkv_scan(*(torch.from_numpy(a) for a in (r, k, v, w, u, s0)), chunk=16)
    s = s0.astype(np.float64)
    for t in range(70):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        out = np.einsum("bhk,bhkd->bhd", r[:, t], s + u[..., None] * kv)
        np.testing.assert_allclose(ot[:, t].numpy(), out, atol=1e-4, rtol=1e-4)
        s = w[:, t, ..., None] * s + kv
    np.testing.assert_allclose(st.numpy(), s, atol=1e-4, rtol=1e-4)
    assert torch.isfinite(ot).all()


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_rwkv_shapes_dtypes_and_constants_match_jax(dtype):
    """decay_base and bonus stay float32 in a bf16 model; mix, decay_base
    and bonus are the JAX constants."""
    jcfg = jax_reduced(jax_arch(ARCH), dtype=dtype, d_model=128)
    tcfg = reduced_config(get_arch(ARCH), dtype=dtype, d_model=128)
    gen = torch.Generator().manual_seed(0)
    for jfn, tfn in ((JR.init_rwkv_tm, TR.init_rwkv_tm), (JR.init_rwkv_cm, TR.init_rwkv_cm)):
        jm, _ = jfn(jcfg, jax_null_plan("decode"), jax.random.PRNGKey(0))
        tm = tfn(tcfg, PLAN, gen)
        assert set(tm) == set(jm)
        for k, v in jm.items():
            assert tuple(tm[k].shape) == v.shape, k
            assert str(tm[k].dtype).split(".")[-1] == str(v.dtype), k
            if k in ("mix", "decay_base", "bonus"):
                np.testing.assert_array_equal(tm[k].float().numpy(),
                                              np.asarray(v, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tm_inputs_match_jax(dtype):
    """g comes from the same mixed stream as v; r, k, v, w are float32
    heads and g keeps x's dtype, as in the JAX function."""
    _, _, jp, tp = models(dtype=dtype, d_model=128)
    jl, tl = layer0(jp, tp)
    jm, tm = jl["mixer"], tl["mixer"]
    tdt = getattr(torch, dtype)
    x, xp = rand(0, 2, 5, 128), rand(1, 2, 5, 128)
    jout = JR._tm_inputs(jm, jnp.asarray(x, jnp.dtype(dtype)), jnp.asarray(xp, jnp.dtype(dtype)),
                         2, 64)
    tout = TR._tm_inputs(tm, torch.from_numpy(x).to(tdt), torch.from_numpy(xp).to(tdt), 2, 64)
    for name, j, t in zip("rkvgw", jout, tout):
        assert str(t.dtype).split(".")[-1] == str(j.dtype), name
        assert tuple(t.shape) == j.shape, name
        tol = CACHE_TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)
    assert tout[3].dtype == tdt and tout[0].dtype == torch.float32
    # g and v are two projections of one stream: with w_g := w_v they agree
    tm2 = dict(tm, w_g=tm["w_v"])
    r, k, v, g, w = TR._tm_inputs(tm2, torch.from_numpy(x).to(tdt),
                                  torch.from_numpy(xp).to(tdt), 2, 64)
    torch.testing.assert_close(g.float().reshape(v.shape), v)


@pytest.mark.parametrize("s", [1, 9, 130])
def test_time_and_channel_mix_and_caches_match_jax(s):
    """Prefill of one token (the shift from the zero row), of 9, and past
    two scan chunks: outputs within 1e-4, the wkv state and both shifts
    within 1e-5."""
    jcfg, tcfg, jp, tp = models(d_model=128)
    jl, tl = layer0(jp, tp)
    x = rand(s, 2, s, 128)
    jplan = jax_null_plan("prefill")
    yj, cj = JR.rwkv_tm_fwd(jl["mixer"], jnp.asarray(x), jcfg, jplan, JDIST, make_cache=True)
    yt, ct = TR.rwkv_tm_fwd(tl["mixer"], torch.from_numpy(x), tcfg, null_plan("prefill"),
                            DIST, make_cache=True)
    close(yt, yj, LOGIT_TOL)
    assert set(ct) == {"wkv", "shift"} and ct["wkv"].dtype == torch.float32
    for n in ct:
        close(ct[n], cj[n])
    yj, cj = JR.rwkv_cm_fwd(jl["ffn"], jnp.asarray(x), jplan, JDIST, make_cache=True)
    yt, ct = TR.rwkv_cm_fwd(tl["ffn"], torch.from_numpy(x), null_plan("prefill"), DIST,
                            make_cache=True)
    close(yt, yj, LOGIT_TOL)
    close(ct["shift"], cj["shift"])


def test_decode_steps_match_jax():
    jcfg, tcfg, jp, tp = models(d_model=128)
    jl, tl = layer0(jp, tp)
    x = rand(0, 3, 1, 128)
    wkv, sh, sh2 = rand(1, 3, 2, 64, 64, scale=0.3), rand(2, 3, 128), rand(3, 3, 128)
    yj, cj = JR.rwkv_tm_decode(jl["mixer"], jnp.asarray(x),
                               {"wkv": jnp.asarray(wkv), "shift": jnp.asarray(sh)},
                               jcfg, JPLAN, JDIST)
    cache = {"wkv": torch.from_numpy(wkv.copy()), "shift": torch.from_numpy(sh.copy())}
    yt, ct = TR.rwkv_tm_decode(tl["mixer"], torch.from_numpy(x), cache, tcfg, PLAN, DIST)
    close(yt, yj, LOGIT_TOL)
    assert ct["wkv"] is cache["wkv"] and ct["shift"] is cache["shift"]    # in place
    close(ct["wkv"], cj["wkv"])
    close(ct["shift"], cj["shift"])
    yj, cj = JR.rwkv_cm_decode(jl["ffn"], jnp.asarray(x), {"shift": jnp.asarray(sh2)},
                               JPLAN, JDIST)
    cache = {"shift": torch.from_numpy(sh2.copy())}
    yt, ct = TR.rwkv_cm_decode(tl["ffn"], torch.from_numpy(x), cache, PLAN, DIST)
    close(yt, yj, LOGIT_TOL)
    assert ct["shift"] is cache["shift"]
    close(ct["shift"], cj["shift"])


@pytest.mark.parametrize("split", [1, 2, 65])
def test_prefill_then_decode_equals_one_forward(split):
    """Prefill of the first `split` tokens, then one decode step per token:
    outputs and the final states equal one forward over all 70."""
    _, tcfg, _, tp = models(d_model=128)
    tl = tp["stack"][0]
    x = torch.from_numpy(rand(5, 2, 70, 128))
    plan = null_plan("prefill")
    for fwd, dec, p in ((lambda p, x, **kw: TR.rwkv_tm_fwd(p, x, tcfg, plan, DIST, **kw),
                         lambda p, x, c: TR.rwkv_tm_decode(p, x, c, tcfg, PLAN, DIST),
                         tl["mixer"]),
                        (lambda p, x, **kw: TR.rwkv_cm_fwd(p, x, plan, DIST, **kw),
                         lambda p, x, c: TR.rwkv_cm_decode(p, x, c, PLAN, DIST),
                         tl["ffn"])):
        y_all, c_all = fwd(p, x, make_cache=True)
        y0, cache = fwd(p, x[:, :split], make_cache=True)
        ys = [y0]
        for t in range(split, 70):
            y, cache = dec(p, x[:, t:t + 1], cache)
            ys.append(y)
        torch.testing.assert_close(torch.cat(ys, dim=1), y_all, atol=1e-4, rtol=1e-4)
        for n in c_all:
            torch.testing.assert_close(cache[n], c_all[n], atol=1e-5, rtol=1e-5)


def test_rwkv_refuses_sharding():
    """The sharded RWKV layer no longer refuses (item 5c-ii): at d_model 128
    (two WKV heads of 64), the port's time- and channel-mix specs on a
    (1, 2) ("data", "model") prefill plan equal JAX's ``init_rwkv_tm`` /
    ``init_rwkv_cm`` specs, and the sharded call runs: two gloo ranks, one
    head each, the sequence over model, give JAX's single-device time and
    channel mix within 1e-5 (``test_torch_sharded_rwkv_encdec.py`` holds
    the rest: caches, decode, gradients, the 2x2 mesh)."""
    from repro.configs.base import ShapeCell as JShapeCell
    from repro.sharding.plans import make_plan as jax_make_plan
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import serve
    from repro_torch.sharding import specs as SP
    from repro_torch.sharding.plans import make_plan
    jcfg, tcfg, jp, tp = models(d_model=128)
    jl, tl = layer0(jp, tp)
    cell = dict(seq_len=8, global_batch=2, kind="prefill")
    jplan = jax_make_plan(jcfg, JShapeCell("p", **cell), ("data", "model"), (1, 2))
    plan = make_plan(tcfg, ShapeCell("p", **cell), ("data", "model"), (1, 2))
    for init, specs in ((JR.init_rwkv_tm, SP.rwkv_tm_specs(plan)),
                        (JR.init_rwkv_cm, SP.rwkv_cm_specs(plan))):
        want = init(jcfg, jplan, jax.random.PRNGKey(0))[1]
        assert {k: tuple(v) for k, v in specs.items()} == {k: tuple(v) for k, v in want.items()}
    x = rand(0, 2, 8, tcfg.d_model)
    got = serve.spawn(__import__("torch_encdec_workers").sharded_calls,
                      (dict(kind="rwkv", cfg=tcfg, params=tl, x=x),), mesh_shape=(1, 2),
                      transport="gloo", device="cpu", timeout=120)[0]
    plan1 = jax_null_plan("prefill")
    np.testing.assert_allclose(got["tm"], np.asarray(JR.rwkv_tm_fwd(
        jl["mixer"], jnp.asarray(x), jcfg, plan1, JDIST)[0]), **CACHE_TOL)
    np.testing.assert_allclose(got["cm"], np.asarray(JR.rwkv_cm_fwd(
        jl["ffn"], jnp.asarray(x), plan1, JDIST)[0]), **CACHE_TOL)


# ---------------------------------------------------------------------------
# caches: shapes, dtypes, leaf classes, rollback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_jax(dtype):
    """The mixer's wkv (float32) and shift, and the channel mix's own shift
    in an "ffn" group, as in the JAX ``init_cache``."""
    jcfg = jax_reduced(jax_arch(ARCH), dtype=dtype)
    tcfg = reduced_config(get_arch(ARCH), dtype=dtype)
    jc, _ = JM.init_cache(jcfg, JPLAN, 3, 24)
    want = convert.unstack_layers(jax.tree.map(np.asarray, jc), tcfg)
    got = M.init_cache(tcfg, PLAN, 3, 24, device="cpu")
    assert [{g: sorted(c) for g, c in layer.items()} for layer in got] == \
        [{"mixer": ["shift", "wkv"], "ffn": ["shift"]}] * tcfg.num_layers
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == w.dtype.name
    assert all(c["mixer"]["wkv"].dtype == torch.float32 for c in got)


def prefilled(tcfg, tp, jcfg, jp, prompt, seq):
    _, jc = JM.prefill(jp, {"tokens": jnp.asarray([prompt], jnp.int32)}, jcfg,
                       jax_null_plan("prefill"), JDIST)
    _, tc = M.prefill(tp, {"tokens": torch.tensor([prompt])}, tcfg)
    return (jkv.pad_to_capacity(jcfg, jc, len(prompt), seq),
            kvcache.pad_to_capacity(tcfg, tc, len(prompt), seq))


def test_leaf_classes_and_pad_to_capacity_match_jax():
    """Every leaf is recurrent, none is padded; the prefilled caches (the
    "ffn" group carried across by ``cache_from_jax``) equal the JAX ones."""
    jcfg, tcfg, jp, tp = models()
    jc, tc = prefilled(tcfg, tp, jcfg, jp, [3, 5, 7], 12)
    per = jkv.classify(jcfg, jc)["periods"]
    assert kvcache.classify(tcfg, tc) == [per[0]] * tcfg.num_layers
    assert set(jax.tree.leaves(kvcache.classify(tcfg, tc))) == {"recurrent"}
    got = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    assert jax.tree.structure(got) == jax.tree.structure(tc)
    for w, g in zip(jax.tree.leaves(got), jax.tree.leaves(tc)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), **CACHE_TOL)
    assert tc[0]["mixer"]["wkv"].shape == (1, 1, 64, 64)


def test_insert_snapshot_select_restore_all_three_leaves():
    """In a bf16 model: insert_slot copies a request's state into a slot;
    snapshot_recurrent copies wkv and both shifts; select_history restores
    each row at its own step; wkv stays float32 throughout."""
    cfg = reduced_config(get_arch(ARCH))
    params = M.init_model(cfg, device="cpu", seed=0)
    _, sub = M.prefill(params, {"tokens": torch.tensor([PROMPT])}, cfg)
    sub = kvcache.pad_to_capacity(cfg, sub, len(PROMPT), 16)
    caches = M.init_cache(cfg, PLAN, 2, 16, device="cpu")
    kvcache.insert_slot(caches, sub, 1)
    assert torch.equal(caches[1]["ffn"]["shift"][1], sub[1]["ffn"]["shift"][0])
    assert not caches[1]["ffn"]["shift"][0].any()
    hist = []
    for i in range(3):
        tok = torch.tensor([[1 + i], [7 + 2 * i]])
        _, caches = M.decode_step(params, caches, tok, len(PROMPT) + i, cfg)
        hist.append(kvcache.snapshot_recurrent(cfg, caches))
    assert hist[0][0]["ffn"]["shift"] is not caches[0]["ffn"]["shift"]
    sel = kvcache.select_history(cfg, caches, hist, torch.tensor([2, 0]))
    for g, n in (("mixer", "wkv"), ("mixer", "shift"), ("ffn", "shift")):
        assert sel[0][g][n].dtype == caches[0][g][n].dtype
        assert torch.equal(sel[0][g][n][0], hist[2][0][g][n][0])
        assert torch.equal(sel[0][g][n][1], hist[0][0][g][n][1])
        assert not torch.equal(hist[2][0][g][n][1], hist[0][0][g][n][1])
    assert sel[0]["mixer"]["wkv"].dtype == torch.float32


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


@pytest.mark.parametrize("L", [1, 11, 70])
def test_prefill_and_decode_logits_match_jax(L):
    """Prefill of L tokens (70 crosses a scan chunk), then 8 greedy decode
    steps: logits within 1e-4, tokens equal, caches within 1e-5."""
    jcfg, tcfg, jp, tp = models()
    prompt = np.random.default_rng(L).integers(1, 500, (1, L)).astype(np.int32)
    S = L + 9
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
    reused: each slot's state comes from its own prefill."""
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


def test_engine_matches_sequential():
    """Engine output for a single request == plain greedy decode (the JAX
    ``test_engine_matches_sequential[rwkv6-1.6b]``)."""
    _, tcfg, _, tp = models()
    ref = greedy(tcfg, tp, PROMPT, 12)
    eng = Engine(tcfg, tp, max_batch=2, max_seq=MAX_SEQ, eos_id=-1, device="cpu")
    rid = eng.submit(PROMPT, max_new_tokens=12)
    assert eng.run()[rid][:12] == ref[0].tolist()


def bad_draft(params, caches, cur_tok, pos):
    return torch.full((cur_tok.shape[0], 3), 12345 % 500, dtype=torch.int32)


def jax_bad_draft(params, caches, cur_tok, pos):
    return jnp.full((cur_tok.shape[0], 3), 12345 % 500, jnp.int32)


@pytest.mark.parametrize("draft", ["bad", "heads"])
def test_sd_equals_greedy_and_jax(draft):
    """A constant draft (every verify rejects: wkv and both shifts roll back
    three steps) and untrained Medusa heads (the JAX decoder's, converted):
    the port's SD equals greedy and the JAX SD, token for token and in its
    acceptance statistics (the JAX ``test_sd_equals_greedy_bad_draft`` and
    ``_medusa_heads`` for rwkv6)."""
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
