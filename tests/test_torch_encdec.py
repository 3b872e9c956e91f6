"""The port's encoder-decoder (seamless-m4t-medium) against the JAX package,
on reduced seamless (2 encoder + 2 decoder layers, d_model 64, 4 heads,
g = 1), float32: the encoder cache, cross-attention in prefill and in
decode, the encoder (causal, with RoPE, as the JAX ``_encode`` runs it in
mode "train"), the model's params, caches, prefill and decode logits, the
engine's zero-padded cross cache (decode attends over ``max_seq`` encoder
positions, the zero rows past the prompt included, as the JAX engine
does) and the engine token for token against the JAX engine."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import attention as JA  # noqa: E402
from repro.models.layers import common as JC  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro.serving.engine import Engine as JaxEngine  # noqa: E402
from repro.sharding.dist import NullDist as JaxNullDist  # noqa: E402
from repro.sharding.plans import null_plan as jax_null_plan  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.layers import attention as TA  # noqa: E402
from repro_torch.models.layers import common as TC  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.sharding.dist import NullDist  # noqa: E402
from repro_torch.sharding.plans import null_plan  # noqa: E402

ARCH = "seamless-m4t-medium"
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


def cross0(jp, tp):
    """Decoder layer 0's cross-attention params on both sides."""
    return (jax.tree.map(lambda a: a[0], jp["stack"]["periods"][0])["cross"],
            tp["stack"][0]["cross"])


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def close(t, j, tol=CACHE_TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def test_config_reduction_and_params_match_jax():
    """12 + 12 layers, g = 1 (KV = H = 16, hd 64); the reduction keeps 2
    encoder layers. The port's params have the JAX tree's layers and
    shapes: an encoder of ``encoder_layers`` plain layers and ``enc_norm``,
    and a decoder whose layers carry ``norm_x`` and ``cross``."""
    full = get_arch(ARCH)
    assert repr(full) == repr(jax_arch(ARCH))
    assert (full.encoder_layers, full.num_heads, full.num_kv_heads, full.head_dim) == \
        (12, 16, 16, 64)
    jcfg, tcfg, jp, tp = models()
    assert tcfg.encoder_layers == 2 and tcfg.is_encoder_decoder
    mine = M.init_model(tcfg, device="cpu")
    assert sorted(mine) == sorted(tp) == ["embed", "enc_norm", "encoder", "final_norm",
                                          "stack"]
    assert len(mine["encoder"]) == 2 and len(mine["stack"]) == tcfg.num_layers
    assert all("cross" not in layer for layer in mine["encoder"])
    assert jax.tree.structure(mine) == jax.tree.structure(tp)
    for x, y in zip(jax.tree.leaves(mine), jax.tree.leaves(tp)):
        assert x.shape == y.shape and x.dtype == y.dtype
    assert sorted(mine["stack"][0]) == ["cross", "ffn", "mixer", "norm1", "norm2", "norm_x"]


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

def test_make_enc_cache_and_cross_attention_fwd_match_jax():
    """The encoder's k, v [B, KV, Se, hd] (no RoPE) and prefill
    cross-attention over all of them (no causal mask: Se > S)."""
    jcfg, tcfg, jp, tp = models()
    jc, tc = cross0(jp, tp)
    enc, x = rand(0, 2, 11, 64), rand(1, 2, 5, 64)
    jkv_ = JA.make_enc_cache(jc, jnp.asarray(enc), jcfg, JPLAN, JDIST)
    tkv = TA.make_enc_cache(tc, torch.from_numpy(enc), tcfg, PLAN, DIST)
    assert tkv["k"].shape == (2, 4, 11, 16) and tkv["k"].is_contiguous()
    for n in ("k", "v"):
        close(tkv[n], jkv_[n])
    yj = JA.cross_attention_fwd(jc, jnp.asarray(x), jkv_, jcfg, JPLAN, JDIST)
    yt = TA.cross_attention_fwd(tc, torch.from_numpy(x), tkv, tcfg, PLAN, DIST)
    close(yt, yj, LOGIT_TOL)


@pytest.mark.parametrize("enc_len", [1, 7, 11])
def test_cross_attention_decode_matches_jax(enc_len):
    """``flash_decode`` over the first enc_len encoder positions, every row
    alike: the mask of the JAX ``attn_chunk_lse`` at max_pos enc_len - 1."""
    jcfg, tcfg, jp, tp = models()
    jc, tc = cross0(jp, tp)
    kv = {n: rand(i, 3, 4, 11, 16) for i, n in enumerate("kv")}
    x = rand(2, 3, 1, 64)
    yj = JA.cross_attention_decode(jc, jnp.asarray(x), {n: jnp.asarray(a) for n, a in kv.items()},
                                   enc_len, jcfg, JPLAN, JDIST)
    yt = TA.cross_attention_decode(tc, torch.from_numpy(x),
                                   {n: torch.from_numpy(a) for n, a in kv.items()},
                                   enc_len, tcfg, PLAN, DIST)
    close(yt, yj, LOGIT_TOL)


def test_cross_attention_refuses_sharding_and_no_length():
    """Cross-attention under head-TP and over a sharded encoder cache no
    longer refuses (item 5c-ii): the cross specs on a (1, 2) ("data",
    "model") plan equal JAX's ``init_attention(cross=True)`` specs, and the
    sharded call runs: two gloo ranks (head-TP, the encoder positions over
    model) give JAX's single-device ``cross_attention_fwd`` and, over a
    cache whose 16 positions split 8 and 8, ``cross_attention_decode`` at
    enc_len 11 within 1e-5. A decode over no encoder position still
    raises ValueError."""
    from repro.configs.base import ShapeCell as JShapeCell
    from repro.sharding.plans import make_plan as jax_make_plan
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import serve
    from repro_torch.sharding import specs as SP
    from repro_torch.sharding.plans import make_plan
    jcfg, tcfg, jp, tp = models()
    jc, tc = cross0(jp, tp)
    cell = dict(seq_len=8, global_batch=2, kind="prefill")
    jplan = jax_make_plan(jcfg, JShapeCell("p", **cell), ("data", "model"), (1, 2))
    plan = make_plan(tcfg, ShapeCell("p", **cell), ("data", "model"), (1, 2))
    assert plan.attn_mode == "head_tp"
    want = JA.init_attention(jcfg, jplan, jax.random.PRNGKey(0), cross=True)[1]
    assert {k: tuple(v) for k, v in SP.attention_specs(plan).items()} == \
        {k: tuple(v) for k, v in want.items()}
    x, enc, xt = rand(0, 2, 8, 64), rand(1, 2, 8, 64), rand(2, 2, 1, 64)
    kv = {n: np.asarray(a) for n, a in JA.make_enc_cache(
        jc, jnp.asarray(rand(3, 2, 16, 64)), jcfg, JPLAN, JDIST).items()}
    got = serve.spawn(__import__("torch_encdec_workers").sharded_calls,
                      (dict(kind="cross", cfg=tcfg, params=tc, x=x, enc=enc, kv=kv, xt=xt,
                            enc_len=11),), mesh_shape=(1, 2), transport="gloo",
                      device="cpu", timeout=120)[0]
    jplan1 = jax_null_plan("prefill")
    want_fwd = JA.cross_attention_fwd(jc, jnp.asarray(x), JA.make_enc_cache(
        jc, jnp.asarray(enc), jcfg, jplan1, JDIST), jcfg, jplan1, JDIST)
    np.testing.assert_allclose(got["fwd"], np.asarray(want_fwd), **CACHE_TOL)
    want_dec = JA.cross_attention_decode(jc, jnp.asarray(xt), {n: jnp.asarray(a)
                                                               for n, a in kv.items()},
                                         11, jcfg, JPLAN, JDIST)
    np.testing.assert_allclose(got["decode"], np.asarray(want_dec), **CACHE_TOL)
    with pytest.raises(ValueError):
        TA.cross_attention_decode(tc, torch.from_numpy(xt[:1]),
                                  {n: torch.zeros((1, 4, 8, 16)) for n in "kv"}, 0, tcfg,
                                  PLAN, DIST)


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------

def test_encoder_matches_jax_and_is_causal():
    """The JAX ``_encode`` runs the encoder stack in mode "train", whose
    attention is causal: position t does not see frames after t. The port
    mirrors it: both sides agree, and on both a change to the frames from
    position 6 on leaves positions 0-5 as they were and moves the rest."""
    jcfg, tcfg, jp, tp = models()
    frames = rand(0, 2, 12, 64)
    later = frames.copy()
    later[:, 6:] = rand(1, 2, 6, 64)
    jplan = jax_null_plan("prefill")
    outs = []
    for f in (frames, later):
        ej = JM._encode(jp, jnp.asarray(f), jcfg, jplan, JDIST)
        et = M._encode(tp, torch.from_numpy(f), tcfg, null_plan("prefill"), DIST)
        close(et, ej, LOGIT_TOL)
        outs.append((et.numpy(), np.asarray(ej)))
    for side in (0, 1):
        a, b = outs[0][side], outs[1][side]
        np.testing.assert_allclose(a[:, :6], b[:, :6], atol=1e-6, rtol=1e-6)
        assert np.abs(a[:, 6:] - b[:, 6:]).max() > 1e-2


def test_encoder_applies_rope(monkeypatch):
    """The JAX encoder applies RoPE to its q and k (it is the decoder's
    attention, in mode "train"): without RoPE the port's encoder leaves the
    JAX one."""
    jcfg, tcfg, jp, tp = models()
    frames = rand(2, 1, 12, 64)
    ej = np.asarray(JM._encode(jp, jnp.asarray(frames), jcfg, jax_null_plan("prefill"), JDIST))
    monkeypatch.setattr(TA, "apply_rope", lambda x, pos, theta: x)
    et = M._encode(tp, torch.from_numpy(frames), tcfg, null_plan("prefill"), DIST)
    assert np.abs(et.numpy() - ej).max() > 1e-2


def test_encoder_stack_specs():
    cfg = reduced_config(get_arch(ARCH))
    assert TT.stack_specs(cfg, cfg.encoder_layers, TT.ENCODER_PERIOD) == \
        TT.ENCODER_PERIOD * 2
    assert TT.stack_specs(cfg) == cfg.layer_specs


# ---------------------------------------------------------------------------
# the model: caches, logits, the engine
# ---------------------------------------------------------------------------

def test_init_cache_matches_jax():
    """Each decoder layer's mixer k, v [B, KV, seq, hd] and its "cross"
    group's k, v [B, KV, enc_seq, hd]."""
    jcfg, tcfg, _, _ = models()
    jc, _ = JM.init_cache(jcfg, JPLAN, 3, 24, 10)
    want = convert.unstack_layers(jax.tree.map(np.asarray, jc), tcfg)
    got = M.init_cache(tcfg, PLAN, 3, 24, 10, device="cpu")
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(g.shape) == w.shape
    assert got[0]["cross"]["k"].shape == (3, 4, 10, 16)
    assert kvcache.classify(tcfg, got)[0]["cross"] == {"k": "positional", "v": "positional"}


def jax_prefill_logits(params, cfg, batch):
    """The JAX ``prefill`` up to the logits of the last position."""
    plan = jax_null_plan("prefill")
    x = JM._embed_inputs(params, batch, cfg, plan, JDIST)
    enc_out = JM._encode(params, batch["frames"], cfg, plan, JDIST)
    x, caches, _ = JT.apply_stack(params["stack"], x, cfg, plan, JDIST, mode="prefill",
                                  enc_out=enc_out)
    x = JC.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return JC.lm_logits(params["embed"], x[:, -1:], cfg, plan, JDIST), caches


def jax_decode_logits(params, cfg, tok, caches, pos, enc_len):
    x = JC.embed(params["embed"], tok, cfg, JPLAN, JDIST)
    x, caches, _ = JT.apply_stack(params["stack"], x, cfg, JPLAN, JDIST, mode="decode",
                                  caches=caches, pos=pos, enc_len=enc_len)
    x = JC.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return JC.lm_logits(params["embed"], x, cfg, JPLAN, JDIST), caches


def prefill_both(jcfg, tcfg, jp, tp, L, enc, seq, seed=0):
    prompt = np.random.default_rng(seed).integers(1, 500, (1, L)).astype(np.int32)
    frames = rand(seed + 1, 1, enc, 64)
    lj, jc = jax_prefill_logits(jp, jcfg, {"tokens": jnp.asarray(prompt),
                                           "frames": jnp.asarray(frames)})
    lt, tc = M.prefill_logits(tp, {"tokens": torch.from_numpy(prompt),
                                   "frames": torch.from_numpy(frames)}, tcfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    return (lj, jkv.pad_to_capacity(jcfg, jc, L, seq),
            lt, kvcache.pad_to_capacity(tcfg, tc, L, seq))


@pytest.mark.parametrize("L,enc", [(5, 9), (11, 11)])
def test_prefill_and_decode_logits_match_jax(L, enc):
    """Prefill of L tokens against `enc` frames (an encoder shorter and
    longer than the capacity's pad), then 6 greedy decode steps over all
    enc encoder positions: logits within 1e-4, tokens equal, caches (the
    cross group carried across by ``cache_from_jax``) within 1e-5."""
    jcfg, tcfg, jp, tp = models()
    lj, jc, lt, tc = prefill_both(jcfg, tcfg, jp, tp, L, enc, 20)
    got = convert.cache_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    for w, g in zip(jax.tree.leaves(got), jax.tree.leaves(tc)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **CACHE_TOL)
    for pos in range(L, L + 6):
        tok = np.asarray(JC.greedy_sample(lj, jcfg, JPLAN, JDIST))
        np.testing.assert_array_equal(TC.greedy_sample(lt, tcfg, PLAN, DIST).numpy(), tok)
        lj, jc = jax_decode_logits(jp, jcfg, jnp.asarray(tok), jc, jnp.int32(pos), enc)
        lt, tc = M.decode_logits(tp, tc, torch.tensor(tok), pos, tcfg, enc_len=enc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **LOGIT_TOL)
    want = convert.unstack_layers(jax.tree.map(np.asarray, jc), tcfg)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(tc)):
        np.testing.assert_allclose(g.numpy(), w, **CACHE_TOL)


def test_cross_cache_padded_with_zeros_and_attended():
    """The reference's quirk, mirrored: a cross cache as long as the prompt
    (the engine encodes one frame per prompt token) is padded to capacity
    like the self-attention k, v, and decode at enc_len = capacity attends
    over the zero rows too. The port matches the JAX decode over the padded
    cache, and leaves it if the padding is masked out (enc_len = L)."""
    jcfg, tcfg, jp, tp = models()
    L, S = 6, 16
    lj, jc, lt, tc = prefill_both(jcfg, tcfg, jp, tp, L, L, S, seed=4)
    for layer in tc:
        assert layer["cross"]["k"].shape[2] == S
        assert not layer["cross"]["k"][:, :, L:].any() and layer["cross"]["k"][:, :, :L].any()
    tok = np.asarray(JC.greedy_sample(lj, jcfg, JPLAN, JDIST))
    want, _ = jax_decode_logits(jp, jcfg, jnp.asarray(tok), jc, jnp.int32(L), S)
    masked = convert.tree_map(torch.clone, tc)
    got, _ = M.decode_logits(tp, tc, torch.tensor(tok), L, tcfg, enc_len=S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    alt, _ = M.decode_logits(tp, masked, torch.tensor(tok), L, tcfg, enc_len=L)
    assert np.abs(alt.numpy() - np.asarray(want)).max() > 1e-3


def test_engine_prefills_zero_frames_and_decodes_over_max_seq(monkeypatch):
    """The engine encodes zero frames [1, L, D] in the model's dtype for
    each prompt, and every wave passes enc_len = max_seq, as the JAX
    engine does."""
    _, tcfg, _, tp = models()
    seen = {"frames": [], "enc_len": []}
    prefill, decode_step = M.prefill, M.decode_step

    def spy_prefill(params, batch, cfg, *a, **kw):
        seen["frames"].append(batch["frames"])
        return prefill(params, batch, cfg, *a, **kw)

    def spy_decode(*a, enc_len=0, **kw):
        seen["enc_len"].append(enc_len)
        return decode_step(*a, enc_len=enc_len, **kw)

    monkeypatch.setattr(M, "prefill", spy_prefill)
    monkeypatch.setattr(M, "decode_step", spy_decode)
    eng = Engine(tcfg, tp, max_batch=2, max_seq=24, eos_id=-1, device="cpu")
    assert eng.caches[0]["cross"]["k"].shape == (2, 4, 24, 16)
    for p in ([3, 5, 7], [1, 2, 3, 4, 5]):
        eng.submit(p, max_new_tokens=3)
    eng.run()
    assert [tuple(f.shape) for f in seen["frames"]] == [(1, 3, 64), (1, 5, 64)]
    assert all(not f.any() and f.dtype == torch.float32 for f in seen["frames"])
    assert seen["enc_len"] and set(seen["enc_len"]) == {24}


def test_engine_matches_jax_engine():
    """5 requests over 2 slots (prompts of 3, 6 and 11 tokens), slots
    reused."""
    jcfg, tcfg, jp, tp = models()
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


def test_engine_matches_sequential():
    """Engine output for a single request == prefill with zero frames and
    plain greedy decode over the padded cross cache."""
    _, tcfg, _, tp = models()
    prompt, S = [3, 5, 7, 11, 2, 4], 40
    tok, caches = M.prefill(tp, {"tokens": torch.tensor([prompt]),
                                 "frames": torch.zeros((1, len(prompt), 64))}, tcfg)
    caches = kvcache.pad_to_capacity(tcfg, caches, len(prompt), S)
    ref = [int(tok)]
    for pos in range(len(prompt), len(prompt) + 9):
        tok, caches = M.decode_step(tp, caches, tok, pos, tcfg, enc_len=S)
        ref.append(int(tok))
    eng = Engine(tcfg, tp, max_batch=2, max_seq=S, eos_id=-1, device="cpu")
    rid = eng.submit(prompt, max_new_tokens=9)
    assert eng.run()[rid] == ref
