"""The sliding-window branch of the port's attention and its ring-buffer
cache, against the JAX package on reduced gemma3-1b (window 8), float32:
the windowed prefill and its ring cache, decode at scalar and per-slot
positions before and after the ring wraps, the cache shapes, and the leaf
classes that ``pad_to_capacity`` and ``select_history`` go by."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import attention as JA  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro.sharding.dist import NullDist as JaxNullDist  # noqa: E402
from repro.sharding.plans import null_plan as jax_null_plan  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import attention as TA  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.sharding.dist import NullDist  # noqa: E402
from repro_torch.sharding.plans import null_plan  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
JDIST, DIST = JaxNullDist(), NullDist()
W = 8


def gemma(seed=0):
    jcfg = jax_reduced(jax_arch("gemma3-1b"), dtype="float32")
    tcfg = reduced_config(get_arch("gemma3-1b"), dtype="float32")
    assert jcfg.sliding_window == tcfg.sliding_window == W
    jp, _ = JM.init_model(jcfg, jax_null_plan("decode"), jax.random.PRNGKey(seed))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    # layer 0 is an attn_local layer
    jlayer = jax.tree.map(lambda a: a[0], jp["stack"]["periods"][0])
    return jcfg, tcfg, jlayer["mixer"], tp["stack"][0]["mixer"], tp


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


# ---------------------------------------------------------------------------
# prefill: windowed causal attention and the ring cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [5, W, 13])
def test_window_prefill_and_ring_cache(s):
    """Shorter than, equal to and longer than the window: the output and
    the ring (last W positions at row pos % W, the rest zero) match."""
    jcfg, tcfg, jm, tm, _ = gemma()
    x = rand(s, 2, s, 64)
    yj, cj = JA.attention_fwd(jm, jnp.asarray(x), jcfg, jax_null_plan("prefill"),
                              JDIST, window=W, make_cache=True)
    yt, ct = TA.attention_fwd(tm, torch.from_numpy(x), tcfg, null_plan("prefill"),
                              DIST, window=W, make_cache=True)
    close(yt, yj)
    assert ct["k"].shape == (2, tcfg.num_kv_heads, W, tcfg.head_dim)
    close(ct["k"], cj["k"])
    close(ct["v"], cj["v"])


def test_window_prefill_differs_from_full_attention():
    """The window is applied: past W positions the output is not that of
    full causal attention."""
    _, tcfg, _, tm, _ = gemma()
    x = torch.from_numpy(rand(1, 1, 13, 64))
    yw, _ = TA.attention_fwd(tm, x, tcfg, null_plan("prefill"), DIST, window=W)
    yf, _ = TA.attention_fwd(tm, x, tcfg, null_plan("prefill"), DIST)
    torch.testing.assert_close(yw[:, :W], yf[:, :W])
    assert not torch.allclose(yw[:, W:], yf[:, W:])


# ---------------------------------------------------------------------------
# decode on the ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", [0, 3, W - 1, W, 21])
def test_window_decode_scalar_pos(pos):
    jcfg, tcfg, jm, tm, _ = gemma()
    x, kc, vc = rand(30, 2, 1, 64), rand(31, 2, 1, W, 16), rand(32, 2, 1, W, 16)
    yj, cj = JA.attention_decode(jm, jnp.asarray(x),
                                 {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                                 jnp.int32(pos), jcfg, jax_null_plan("decode"),
                                 JDIST, window=W)
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    yt, ct = TA.attention_decode(tm, torch.from_numpy(x), cache, pos, tcfg,
                                 null_plan("decode"), DIST, window=W)
    close(yt, yj)
    close(ct["k"], cj["k"])
    close(ct["v"], cj["v"])


def test_window_decode_per_slot_pos():
    """[B] positions on the ring == the JAX layer at each slot's scalar
    position, before and after the wrap."""
    jcfg, tcfg, jm, tm, _ = gemma()
    pos = [2, W - 1, W, 3 * W + 5]
    B = len(pos)
    x, kc, vc = rand(33, B, 1, 64), rand(34, B, 1, W, 16), rand(35, B, 1, W, 16)
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    yt, ct = TA.attention_decode(tm, torch.from_numpy(x), cache,
                                 torch.tensor(pos), tcfg, null_plan("decode"),
                                 DIST, window=W)
    for b, p in enumerate(pos):
        yj, cj = JA.attention_decode(
            jm, jnp.asarray(x[b:b + 1]),
            {"k": jnp.asarray(kc[b:b + 1]), "v": jnp.asarray(vc[b:b + 1])},
            jnp.int32(p), jcfg, jax_null_plan("decode"), JDIST, window=W)
        close(yt[b:b + 1], yj)
        close(ct["k"][b:b + 1], cj["k"])
        close(ct["v"][b:b + 1], cj["v"])


# ---------------------------------------------------------------------------
# cache shapes and leaf classes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [4, 32])
def test_init_cache_ring_shapes_match_jax(seq):
    jcfg, tcfg, _, _, _ = gemma()
    jc, _ = JM.init_cache(jcfg, jax_null_plan("decode"), 2, seq)
    tc = M.init_cache(tcfg, batch=2, seq=seq, device="cpu")
    want = convert.unstack_layers(jax.tree.map(np.asarray, jc), tcfg)
    assert [layer["mixer"]["k"].shape for layer in tc] == \
        [layer["mixer"]["k"].shape for layer in want]
    assert tc[0]["mixer"]["k"].shape[2] == min(W, seq)
    assert tc[5]["mixer"]["k"].shape[2] == seq           # the global layer


def test_classify_and_pad():
    """gemma3: ring leaves are recurrent and keep their shape, the global
    layer's k/v are positional and grow (the JAX test on jamba, here on
    the sliding-window model)."""
    jcfg, tcfg, _, _, _ = gemma()
    caches = M.init_cache(tcfg, batch=2, seq=16, device="cpu")
    classes = kvcache.classify(tcfg, caches)
    jc, _ = JM.init_cache(jcfg, jax_null_plan("decode"), 2, 16)
    per = jkv.classify(jcfg, jc)["periods"]         # one period, no remainder
    assert classes == [per[i % len(per)] for i in range(tcfg.num_layers)]
    assert {c for layer in classes for c in layer["mixer"].values()} == \
        {"positional", "recurrent"}
    padded = kvcache.pad_to_capacity(tcfg, caches, 16, 32)
    for layer, cls in zip(padded, classes):
        rows = 32 if cls["mixer"]["k"] == "positional" else W
        assert layer["mixer"]["k"].shape[2] == rows
    assert kvcache.memory_bytes(padded) > kvcache.memory_bytes(caches)


def test_pad_skips_a_ring_as_long_as_the_prompt():
    """A prompt of exactly W tokens gives a ring of W rows whose sequence
    dim equals the prefill length: it must stay a ring, not be padded to
    the capacity (the JAX rule: recurrent leaves are never padded)."""
    _, tcfg, _, _, tp = gemma()
    _, tc = M.prefill(tp, {"tokens": torch.arange(1, W + 1)[None]}, tcfg)
    padded = kvcache.pad_to_capacity(tcfg, tc, W, 32)
    for spec, layer in zip(tcfg.layer_specs, padded):
        want = W if spec.mixer == "attn_local" else 32
        assert layer["mixer"]["k"].shape[2] == want
        assert layer["mixer"]["v"].shape[2] == want


@pytest.mark.parametrize("per_row", [False, True])
def test_select_history(per_row):
    """Positional leaves keep the final state; recurrent leaves come from the
    history at the accepted step, per row when given one step per row."""
    _, tcfg, _, _, _ = gemma()
    steps = []
    for t in range(3):
        c = M.init_cache(tcfg, batch=2, seq=16, device="cpu")
        for layer in c:
            for x in layer["mixer"].values():
                x.fill_(t)
        steps.append(c)
    history = [kvcache.snapshot_recurrent(tcfg, c) for c in steps]
    assert history[0][5]["mixer"]["k"] is None          # global: positional
    idx = torch.tensor([2, 0]) if per_row else 1
    out = kvcache.select_history(tcfg, steps[-1], history, idx)
    for spec, layer in zip(tcfg.layer_specs, out):
        k = layer["mixer"]["k"]
        if spec.mixer == "attn":
            assert torch.equal(k, steps[-1][5]["mixer"]["k"])
        elif per_row:
            assert (k[0] == 2).all() and (k[1] == 0).all()
        else:
            assert (k == 1).all()
