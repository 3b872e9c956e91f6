"""Kernels of the PyTorch port: the plain versions against the JAX oracles
(``repro.kernels.ref``) and the Pallas kernels in interpret mode, on the
same numpy inputs, and the dispatch by device. The CUDA kernels against
the plain versions are in test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_decode import flash_decode_pallas  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm_pallas  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import moe_gmm as tmg  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.3).astype(np.float32) for s in shapes]


def both(a, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def f32(a):
    return np.asarray(a.float() if torch.is_tensor(a) else a, np.float32)


def gmm_inputs(seed, e, t, d, f):
    return arrays(seed, (e, t, d), (e, d, f), (e, d, f), (e, f, d))


def assert_bf16_rule(got, oracle, truth):
    """bf16: the port at least as close to the f32 truth as the JAX bf16
    oracle, within 1.5x + 1e-3 (the rule of tests/test_kernels.py)."""
    err, err_oracle = np.abs(got - truth).max(), np.abs(oracle - truth).max()
    assert err <= err_oracle * 1.5 + 1e-3, (err, err_oracle)


# ---------------------------------------------------------------------------
# moe_gmm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,t,d,f", [(2, 128, 64, 256), (1, 128, 256, 256),
                                     (3, 64, 64, 512)])
def test_moe_gmm_plain_matches_jax(e, t, d, f, dtype):
    ins = gmm_inputs(e * 1000 + t, e, t, d, f)
    jx, tx = zip(*(both(a, dtype) for a in ins))
    got = f32(ref.moe_gmm_ref(*tx))
    want = f32(jref.moe_gmm_ref(*jx))
    pallas = f32(moe_gmm_pallas(*jx, interpret=True))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
        return
    truth = f32(jref.moe_gmm_ref(*(jnp.asarray(a) for a in ins)))
    assert_bf16_rule(got, want, truth)
    assert_bf16_rule(pallas, want, truth)


@pytest.mark.parametrize("e,t,d,f", [(2, 100, 64, 300), (1, 7, 32, 130),
                                     (3, 130, 64, 256)])
def test_moe_gmm_plain_unaligned(e, t, d, f):
    """Any T and F, no tile padding needed by the plain version."""
    ins = gmm_inputs(t * 10 + f, e, t, d, f)
    jx, tx = zip(*(both(a, "float32") for a in ins))
    got = f32(ops.moe_gmm(*tx))
    assert got.shape == (e, t, d)
    np.testing.assert_allclose(got, f32(jref.moe_gmm_ref(*jx)), atol=3e-5,
                               rtol=3e-5)
    pallas = moe_gmm_pallas(*jx, block_t=64, block_f=128, interpret=True)
    np.testing.assert_allclose(got, f32(pallas), atol=3e-5, rtol=3e-5)


def test_moe_gmm_expert_independence():
    e, t, d, f = 3, 16, 32, 64
    x, wg, wu, wd = (torch.from_numpy(a) for a in gmm_inputs(7, e, t, d, f))
    base = ops.moe_gmm(x, wg, wu, wd)
    x2 = x.clone()
    x2[0] = 0.0
    out = ops.moe_gmm(x2, wg, wu, wd)
    torch.testing.assert_close(out[1:], base[1:], atol=1e-6, rtol=0)
    assert out[0].abs().max() == 0


# ---------------------------------------------------------------------------
# flash_decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,s,hd", [
    (2, 8, 8, 512, 64),      # MHA
    (2, 8, 2, 1024, 64),     # GQA 4:1
    (4, 4, 4, 500, 32),      # S not a multiple of 8
    (1, 16, 1, 77, 16),      # MQA, ragged S
])
def test_flash_decode_plain_matches_jax(b, h, kh, s, hd, dtype):
    ins = arrays(b * 100 + s, (b, h, hd), (b, kh, s, hd), (b, kh, s, hd))
    jx, tx = zip(*(both(a, dtype) for a in ins))
    length = s - 3
    got = f32(ops.flash_decode(*tx, length))
    want = f32(jref.flash_decode_ref(*jx, jnp.int32(length)))
    pallas = f32(flash_decode_pallas(*jx, jnp.int32(length), block_s=s,
                                     interpret=True))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
        return
    truth = f32(jref.flash_decode_ref(*(jnp.asarray(a) for a in ins),
                                      jnp.int32(length)))
    assert_bf16_rule(got, want, truth)
    assert_bf16_rule(pallas, want, truth)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_flash_decode_per_slot_lengths(as_tensor):
    """[B] lengths == a loop of scalar-length calls, on both sides."""
    b, h, kh, s, hd = 4, 4, 2, 40, 16
    q, k, v = (torch.from_numpy(a) for a in
               arrays(5, (b, h, hd), (b, kh, s, hd), (b, kh, s, hd)))
    lens = [1, 17, 40, 9]
    got = ops.flash_decode(q, k, v, torch.tensor(lens, dtype=torch.int32))
    for i, n in enumerate(lens):
        n_arg = torch.tensor(n) if as_tensor else n
        one = ops.flash_decode(q[i:i + 1], k[i:i + 1], v[i:i + 1], n_arg)
        torch.testing.assert_close(got[i:i + 1], one, atol=1e-6, rtol=0)
        jax_one = jref.flash_decode_ref(*(jnp.asarray(t[i:i + 1].numpy())
                                          for t in (q, k, v)), n)
        np.testing.assert_allclose(f32(one), f32(jax_one), atol=2e-5, rtol=2e-5)


def test_flash_decode_convexity():
    """The output is a convex combination of V rows."""
    q, k, v = (torch.from_numpy(a) for a in
               arrays(3, (1, 2, 16), (1, 1, 256, 16), (1, 1, 256, 16)))
    o = ops.flash_decode(q, k, v, 256).reshape(1, 1, -1, 16)
    vmin, vmax = v.amin(dim=2)[:, :, None], v.amax(dim=2)[:, :, None]
    assert (o >= vmin - 1e-4).all() and (o <= vmax + 1e-4).all()


# ---------------------------------------------------------------------------
# dispatch and wrapper checks (no card needed)
# ---------------------------------------------------------------------------

def test_ops_cpu_uses_plain_versions():
    x, wg, wu, wd = (torch.from_numpy(a) for a in gmm_inputs(1, 2, 8, 16, 24))
    n0 = tmg.launches
    assert torch.equal(ops.moe_gmm(x, wg, wu, wd), ref.moe_gmm_ref(x, wg, wu, wd))
    q, k, v = (torch.from_numpy(a) for a in
               arrays(2, (2, 4, 8), (2, 2, 12, 8), (2, 2, 12, 8)))
    m0 = tfd.launches
    assert torch.equal(ops.flash_decode(q, k, v, 5),
                       ref.flash_decode_ref(q, k, v, 5))
    assert (tmg.launches, tfd.launches) == (n0, m0)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches on CUDA tensors or raises; it never computes on
    the CPU."""
    x, wg, wu, wd = (torch.from_numpy(a) for a in gmm_inputs(1, 2, 8, 16, 24))
    with pytest.raises(ValueError, match="CUDA"):
        tmg.moe_gmm_cuda(x, wg, wu, wd)
    q, k, v = (torch.from_numpy(a) for a in
               arrays(2, (2, 4, 8), (2, 2, 12, 8), (2, 2, 12, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        tfd.flash_decode_cuda(q, k, v, 5)
    with pytest.raises(ValueError, match="no kernel"):
        ops.moe_gmm(x.to("meta"), wg, wu, wd)


def test_build_skips_libraries_already_built(tmp_path, monkeypatch):
    """A library is named by its source and flags, and one that exists is
    not compiled again (so no nvcc is needed here)."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    paths = {n: build.lib_path(n) for n in build.KERNELS}
    assert len(set(paths.values())) == len(build.KERNELS)
    assert all(p.parent == tmp_path for p in paths.values())
    for p in paths.values():
        p.touch()
    assert build.build_all() == {}
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-G"])
    assert build.lib_path("moe_gmm") != paths["moe_gmm"]


def test_lengths_tensor_shapes():
    assert tfd.lengths_tensor(7, 3, "cpu").tolist() == [7, 7, 7]
    assert tfd.lengths_tensor(torch.tensor(2), 2, "cpu").dtype == torch.int32
    with pytest.raises(ValueError):
        tfd.lengths_tensor(torch.tensor([1, 2]), 3, "cpu")


# ---------------------------------------------------------------------------
# host-side rules of the CUDA wrappers (pure Python, no card needed)
# ---------------------------------------------------------------------------

def test_moe_gmm_variant_rule():
    """bf16 with D and F multiples of 8 (TMA's 16-byte strides) takes the
    tensor-core kernel, every config of the port among them; f32 and odd
    widths the CUDA-core one."""
    from repro_torch.configs import ARCHS, reduced_config
    for name, cfg in ARCHS.items():
        if cfg.moe is None:
            continue
        for c in (cfg, reduced_config(cfg)):
            d, f = c.d_model, c.moe.d_expert
            assert tmg.variant(torch.bfloat16, d, f) == "tensor_core", name
            assert tmg.variant(torch.float32, d, f) == "cuda_core", name
    assert tmg.variant(torch.bfloat16, 2048, 1024) == "tensor_core"
    assert tmg.variant(torch.bfloat16, 2048, 1000) == "tensor_core"  # F % 64 != 0
    for d, f in ((32, 130), (40, 7), (64, 300), (2048, 1004), (36, 128)):
        assert tmg.variant(torch.bfloat16, d, f) == "cuda_core", (d, f)
    assert tmg.variant(torch.float32, 256, 128) == "cuda_core"


@pytest.mark.parametrize("t,plan", [(1, ("swap", 8, 1, 1)), (2, ("swap", 8, 2, 1)),
                                    (8, ("swap", 8, 8, 1)), (9, ("swap", 16, 9, 1)),
                                    (12, ("swap", 16, 12, 1)), (24, ("swap", 32, 24, 1)),
                                    (39, ("swap", 64, 39, 1)), (100, ("swap", 128, 100, 1)),
                                    (128, ("swap", 128, 128, 1)),
                                    (129, ("swap", 256, 129, 1)),
                                    (256, ("swap", 256, 256, 1)),
                                    (257, ("rows", 128, 128, 3)),
                                    (384, ("rows", 128, 128, 3)),
                                    (768, ("rows", 128, 128, 6)),
                                    (1000, ("rows", 128, 128, 8))])
def test_moe_gmm_tile_plan(t, plan):
    """T <= 256: the swapped product, one token tile of T rows per expert
    and N the power of two that covers T (wgmma's N runs 8..256), so each
    weight streams once; past that, the tokens are the rows, in tiles of
    128."""
    got = tmg.tile_plan(t)
    assert got == plan
    kind, n, tile_rows, n_tiles = got
    assert tile_rows * n_tiles >= t > tile_rows * (n_tiles - 1)
    if kind == "swap":
        assert t <= tmg.SWAP_MAX_T and n_tiles == 1 and t <= n <= 256
        assert n >= 8 and n & (n - 1) == 0
    else:
        assert t > tmg.SWAP_MAX_T and tile_rows == tmg.ROW_TILE


@pytest.mark.parametrize("t,fill", [(1, 1), (8, 3), (24, 24), (100, 63), (200, 129),
                                    (257, 0), (257, 129), (384, 128), (384, 129),
                                    (768, 512)])
def test_moe_gmm_active_tiles_in_plan_tiles(t, fill):
    """The skip in the tiles ``tile_plan(T)`` gives, on a buffer whose
    experts fill their rows as a prefix (``slot_assignment``'s layout):
    expert 0 fills `fill` rows, expert 1 none, expert 2 one element of its
    last row. SWAP holds an expert as one tile, so it skips only expert 1;
    ROWS skips the 128-row tiles past each prefix, and the tile that the
    prefix ends in is live."""
    plan, _, tile, ntt = tmg.tile_plan(t)
    x = torch.zeros((3, t, 16), dtype=torch.bfloat16)
    x[0, :fill] = 1.0
    x[2, t - 1, 15] = -2.0
    live = ref.moe_gmm_active_tiles_ref(x, tile)
    want = torch.zeros((3, ntt), dtype=torch.bool)
    want[0, :-(-fill // tile)] = True
    want[2, -1] = True
    assert torch.equal(live, want)
    assert int((~live).sum()) == 3 * ntt - (-(-fill // tile)) - 1
    assert int((~live.any(1)).sum()) == (2 if fill == 0 else 1)
    if plan == "swap":
        assert ntt == 1 and tile == t
    else:
        assert tile == tmg.ROW_TILE


@pytest.mark.parametrize("s,n", [(1, 1), (63, 1), (64, 1), (65, 2), (500, 8),
                                 (512, 8)])
def test_flash_decode_n_split(s, n):
    assert tfd.CHUNK == 64
    assert tfd.n_split(s) == n


def test_flash_decode_scratch_shapes():
    shapes = tfd.scratch_shapes(8, 16, 1, 512, 128)
    assert shapes == {"o": (8, 16, 8, 1, 128), "m": (8, 16, 8, 1, 1),
                      "l": (8, 16, 8, 1, 1)}
    shapes = tfd.scratch_shapes(3, 2, 4, 203, 64)
    assert shapes["o"] == (3, 2, 4, 4, 64) and shapes["m"] == shapes["l"] == (3, 2, 4, 4, 1)


def test_flash_decode_rejects_misaligned_kv():
    """K and V rows go in 16-byte copies: a contiguous view that does not
    start on a 16-byte boundary is refused before anything launches."""
    q = torch.zeros((2, 4, 8), dtype=torch.bfloat16)
    k = torch.zeros(2 * 2 * 12 * 8 + 1, dtype=torch.bfloat16)[1:].view(2, 2, 12, 8)
    assert k.is_contiguous() and k.data_ptr() % 16
    for kv in ((k, k.clone()), (k.clone(), k)):
        with pytest.raises(ValueError, match="16-byte boundary"):
            tfd.flash_decode_cuda(q, *kv, 5)
    with pytest.raises(ValueError, match="CUDA device"):   # aligned: only the device
        tfd.flash_decode_cuda(q, k.clone(), k.clone(), 5)


# ---------------------------------------------------------------------------
# the launches as custom ops (the dry run's view of the kernels)
# ---------------------------------------------------------------------------

GMM_SHAPE = (3, 5, 16, 24)                  # E, T, D, F
DEC_SHAPE = (2, 8, 2, 40, 16)               # B, H, KH, S, hd


def _kernel_cases(device, dtype):
    e, t, d, f = GMM_SHAPE
    b, h, kh, s, hd = DEC_SHAPE
    gen = torch.Generator().manual_seed(0)

    def mk(*shape):
        if device == "cpu":
            return torch.randn(shape, generator=gen).to(dtype)
        return torch.empty(shape, dtype=dtype, device=device)
    lengths = torch.tensor([7, 33]) if device == "cpu" else \
        torch.empty(b, dtype=torch.int64, device=device)
    return {
        "moe_gmm": (ops.moe_gmm, (mk(e, t, d), mk(e, d, f), mk(e, d, f), mk(e, f, d))),
        "flash_decode": (ops.flash_decode, (mk(b, h, hd), mk(b, kh, s, hd),
                                            mk(b, kh, s, hd), lengths)),
        "flash_decode_lse": (ops.flash_decode_lse, (mk(b, h, hd), mk(b, kh, s, hd),
                                                    mk(b, kh, s, hd), lengths)),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["moe_gmm", "flash_decode", "flash_decode_lse"])
def test_custom_op_fake_matches_plain_shapes(name, dtype):
    """A fake CUDA tensor goes to the custom op, whose fake gives the plain
    version's output shapes and dtypes and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fn, args = _kernel_cases("cpu", dtype)[name]
    want = fn(*args)
    want = want if isinstance(want, tuple) else (want,)
    n0 = (tmg.launches, tfd.launches, tfd.lse_launches)
    with FakeTensorMode():
        fn, args = _kernel_cases("cuda", dtype)[name]
        got = fn(*args)
        got = got if isinstance(got, tuple) else (got,)
        assert [(tuple(g.shape), g.dtype, g.device.type) for g in got] == \
            [(tuple(w.shape), w.dtype, "cuda") for w in want]
    assert (tmg.launches, tfd.launches, tfd.lse_launches) == n0


@pytest.mark.parametrize("name", ["moe_gmm", "flash_decode", "flash_decode_lse"])
def test_custom_op_flop_formula_counts_the_plain_version(name):
    """The op's flop formula (6 E T D F; 4 B H S hd) equals FlopCounterMode's
    count of the plain version on real CPU tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    fn, args = _kernel_cases("cpu", torch.float32)[name]
    with FlopCounterMode(display=False) as plain:
        fn(*args)
    with FakeTensorMode():
        fn, args = _kernel_cases("cuda", torch.float32)[name]
        with FlopCounterMode(display=False) as op:
            fn(*args)
    counts = op.get_flop_counts()["Global"]
    assert list(map(str, counts)) == [f"repro_torch.{name}"]
    e, t, d, f = GMM_SHAPE
    b, h, _, s, hd = DEC_SHAPE
    want = 6 * e * t * d * f if name == "moe_gmm" else 4 * b * h * s * hd
    assert op.get_total_flops() == plain.get_total_flops() == want


@pytest.mark.parametrize("name", ["moe_gmm", "flash_decode", "flash_decode_lse"])
def test_non_cpu_non_cuda_tensors_still_raise(name):
    fn, args = _kernel_cases("cpu", torch.float32)[name]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fn(*(a.to("meta") for a in args))
