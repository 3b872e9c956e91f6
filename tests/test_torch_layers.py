"""Layer-by-layer parity of the PyTorch port with the JAX package: the same
numpy inputs and JAX-initialised weights (carried across by
``repro_torch.convert``) through each JAX function and its port, float32,
atol 1e-5."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import attention as JA  # noqa: E402
from repro.models.layers import common as JC  # noqa: E402
from repro.models.layers import moe as JMoE  # noqa: E402
from repro.sharding.dist import NullDist as JaxNullDist  # noqa: E402
from repro.sharding.plans import null_plan as jax_null_plan  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.layers import attention as TA  # noqa: E402
from repro_torch.models.layers import common as TC  # noqa: E402
from repro_torch.models.layers import moe as TMoE  # noqa: E402
from repro_torch.sharding.dist import NullDist  # noqa: E402
from repro_torch.sharding.plans import null_plan  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
JPLAN, JDIST = jax_null_plan("decode"), JaxNullDist()
PLAN, DIST = null_plan("decode"), NullDist()


def cfg_pair(topk=None, cf=None, **overrides):
    """The same reduced olmoe config on both sides (float32)."""
    out = []
    for arch, reduce in ((jax_arch, jax_reduced), (get_arch, reduced_config)):
        cfg = reduce(arch("olmoe-1b-7b"), dtype="float32", **overrides)
        moe = {}
        if topk is not None:
            moe["experts_per_token"] = topk
        if cf is not None:
            moe["capacity_factor"] = cf
        if moe:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
        out.append(cfg)
    return out


def models(seed=0, **kw):
    jcfg, tcfg = cfg_pair(**kw)
    jp, _ = JM.init_model(jcfg, JPLAN, jax.random.PRNGKey(seed))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp, jax.tree.map(lambda a: a[0], jp["stack"]["periods"][0])


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy() if torch.is_tensor(t) else t,
                               np.asarray(j), **(tol or TOL))


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------

def test_rms_norm():
    x, scale = rand(0, 2, 5, 64), rand(1, 64, scale=0.1)
    close(TC.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5),
          JC.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope(per_row):
    x = rand(2, 3, 5, 4, 16)
    pos = np.arange(5, dtype=np.int32) + 7
    if per_row:
        pos = (np.arange(3, dtype=np.int32)[:, None] * 11 + pos[None])
    close(TC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0),
          JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))


def test_dense_ffn():
    jcfg, tcfg = cfg_pair()
    jp, _ = JC.init_dense_ffn(jcfg, JPLAN, jax.random.PRNGKey(3))
    tp = convert.tree_map(lambda a: convert.to_torch(a, "cpu"),
                         jax.tree.map(np.asarray, jp))
    x = rand(4, 2, 3, 64)
    close(TC.dense_ffn(tp, torch.from_numpy(x), PLAN, DIST),
          JC.dense_ffn(jp, jnp.asarray(x), JPLAN, JDIST))


def test_embed_and_lm_logits_mask_pad_ids():
    jcfg, tcfg, jp, tp, _ = models(vocab_size=500)      # pads to 512
    tokens = np.array([[0, 499, 17], [3, 250, 1]], np.int32)
    xt = TC.embed(tp["embed"], torch.from_numpy(tokens), tcfg, PLAN, DIST)
    xj = JC.embed(jp["embed"], jnp.asarray(tokens), jcfg, JPLAN, JDIST)
    close(xt, xj)
    lt = TC.lm_logits(tp["embed"], xt, tcfg, PLAN, DIST)
    lj = JC.lm_logits(jp["embed"], xj, jcfg, JPLAN, JDIST)
    assert lt.shape == (2, 3, 512) and torch.isinf(lt[..., 500:]).all()
    close(lt, lj)


def test_greedy_sample_ties_take_lowest_index():
    jcfg, tcfg = cfg_pair()
    logits = rand(5, 2, 3, 512)
    logits[0, 0, [9, 40]] = 50.0
    logits[1, 2, [3, 4, 300]] = 60.0
    t = TC.greedy_sample(torch.from_numpy(logits), tcfg, PLAN, DIST)
    j = JC.greedy_sample(jnp.asarray(logits), jcfg, JPLAN, JDIST)
    assert t.dtype == torch.int32 and t[0, 0] == 9 and t[1, 2] == 3
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def test_route():
    logits = rand(6, 10, 8)
    gt, it, pt = TMoE.route(torch.from_numpy(logits), 2, 6)
    gj, ij, pj = JMoE.route(jnp.asarray(logits), 2, 6)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    close(gt, gj)
    close(pt, pj)


def test_slot_assignment_and_groups():
    idx = np.random.default_rng(7).integers(0, 4, (3, 6, 2)).astype(np.int32)
    for g in range(3):
        st, kt = TMoE.slot_assignment(torch.from_numpy(idx[g]).long(), 4, 2)
        sj, kj = JMoE.slot_assignment(jnp.asarray(idx[g]), 4, 2)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    # grouped call == one call per group
    sg, kg = TMoE.slot_assignment(torch.from_numpy(idx).long(), 4, 2)
    for g in range(3):
        sj, kj = JMoE.slot_assignment(jnp.asarray(idx[g]), 4, 2)
        np.testing.assert_array_equal(sg[g].numpy(), np.asarray(sj))
        np.testing.assert_array_equal(kg[g].numpy(), np.asarray(kj))


def test_moe_ffn_with_drops():
    """Capacity binds (top-2 of 8, cf 0.5): dropped decisions must match."""
    jcfg, tcfg, jp, tp, jlayer = models(topk=2, cf=0.5)
    x = rand(8, 2, 8, 64)
    yj, _ = JMoE.moe_ffn(jlayer["ffn"], jnp.asarray(x), jcfg, JPLAN, JDIST)
    yt = TMoE.moe_ffn(tp["stack"][0]["ffn"], torch.from_numpy(x), tcfg, PLAN, DIST)
    cap = TMoE.capacity(16, 2, 8, 0.5)
    assert cap == 2                            # 16 tokens x 2 over 8 experts
    close(yt, yj)


def test_moe_ffn_capacity_groups_match_per_row_calls():
    """capacity_groups=B == the JAX layer called on each row alone (what the
    JAX engine's vmap over slots does)."""
    jcfg, tcfg, jp, tp, jlayer = models(topk=2)
    x = rand(9, 4, 1, 64)
    yt = TMoE.moe_ffn(tp["stack"][0]["ffn"], torch.from_numpy(x), tcfg, PLAN,
                      DIST, capacity_groups=4)
    for b in range(4):
        yj, _ = JMoE.moe_ffn(jlayer["ffn"], jnp.asarray(x[b:b + 1]), jcfg,
                             JPLAN, JDIST)
        close(yt[b:b + 1], yj)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0), (False, 0, 0),
                                                    (True, 3, 0), (True, 0, 4)])
def test_flash_attn(causal, window, q_offset):
    q, k, v = rand(10, 2, 6, 4, 16), rand(11, 2, 10, 2, 16), rand(12, 2, 10, 2, 16)
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk=4)
    close(TA.flash_attn(*(torch.from_numpy(a) for a in (q, k, v)), **kw),
          JA.flash_attn(*(jnp.asarray(a) for a in (q, k, v)), **kw))


def test_attention_fwd_with_cache():
    jcfg, tcfg, jp, tp, jlayer = models()
    x = rand(13, 2, 6, 64)
    yj, cj = JA.attention_fwd(jlayer["mixer"], jnp.asarray(x), jcfg,
                              jax_null_plan("prefill"), JDIST, make_cache=True)
    yt, ct = TA.attention_fwd(tp["stack"][0]["mixer"], torch.from_numpy(x), tcfg,
                              null_plan("prefill"), DIST, make_cache=True)
    close(yt, yj)
    close(ct["k"], cj["k"])
    close(ct["v"], cj["v"])


def test_attn_chunk_lse_and_flash_decode_agree_with_jax():
    q, k, v = rand(14, 2, 4, 16), rand(15, 2, 2, 12, 16), rand(16, 2, 2, 12, 16)
    pos_k = np.arange(12, dtype=np.int32)
    ot, mt, lt = TA.attn_chunk_lse(*(torch.from_numpy(a) for a in (q, k, v)),
                                   pos_k=torch.from_numpy(pos_k), max_pos=7)
    oj, mj, lj = JA.attn_chunk_lse(*(jnp.asarray(a) for a in (q, k, v)),
                                   pos_k=jnp.asarray(pos_k), max_pos=7)
    for a, b in ((ot, oj), (mt, mj), (lt, lj)):
        close(a, b)
    want = JA.lse_combine(oj, mj, lj, None, JDIST)
    close(TA.lse_combine(ot, mt, lt, None, DIST), want)
    close(ops.flash_decode(*(torch.from_numpy(a) for a in (q, k, v)), 8), want)


def test_attention_decode_scalar_pos():
    jcfg, tcfg, jp, tp, jlayer = models()
    x, kc, vc = rand(17, 2, 1, 64), rand(18, 2, 4, 16, 16), rand(19, 2, 4, 16, 16)
    yj, cj = JA.attention_decode(jlayer["mixer"], jnp.asarray(x),
                                 {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                                 jnp.int32(5), jcfg, JPLAN, JDIST)
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    yt, ct = TA.attention_decode(tp["stack"][0]["mixer"], torch.from_numpy(x),
                                 cache, 5, tcfg, PLAN, DIST)
    close(yt, yj)
    close(ct["k"], cj["k"])
    close(ct["v"], cj["v"])


def test_attention_decode_per_slot_pos():
    """[B] positions == the JAX layer at each slot's scalar position; a
    position past the cache leaves it unchanged."""
    jcfg, tcfg, jp, tp, jlayer = models()
    x, kc, vc = rand(20, 3, 1, 64), rand(21, 3, 4, 16, 16), rand(22, 3, 4, 16, 16)
    pos = [3, 15, 16]
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    yt, ct = TA.attention_decode(tp["stack"][0]["mixer"], torch.from_numpy(x),
                                 cache, torch.tensor(pos), tcfg, PLAN, DIST)
    for b, p in enumerate(pos):
        yj, cj = JA.attention_decode(
            jlayer["mixer"], jnp.asarray(x[b:b + 1]),
            {"k": jnp.asarray(kc[b:b + 1]), "v": jnp.asarray(vc[b:b + 1])},
            jnp.int32(p), jcfg, JPLAN, JDIST)
        close(ct["k"][b:b + 1], cj["k"])
        close(ct["v"][b:b + 1], cj["v"])
        close(yt[b:b + 1], yj)
    np.testing.assert_array_equal(ct["k"][2].numpy(), kc[2])
