"""The port's CUDA kernels against their plain PyTorch versions, on the
card (``cuda`` marker; skipped without one). This file imports no JAX, so
it runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import moe_gmm as tmg  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.3).astype(np.float32) for s in shapes]


def f32(t):
    return t.float().cpu().numpy()


def assert_bf16_rule(got, args, truth, ref_fn):
    """bf16: as close to the f32 truth as the plain bf16 version, 1.5x + 1e-3."""
    err_plain = np.abs(f32(ref_fn(*args)) - truth).max()
    assert np.abs(got - truth).max() <= 1.5 * err_plain + 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,t,d,f", [(4, 8, 256, 128), (2, 100, 64, 300),
                                     (1, 7, 32, 130), (3, 9, 40, 7)])
def test_moe_gmm_cuda_matches_plain(cuda, e, t, d, f, dtype):
    ins = [torch.from_numpy(a).to(cuda) for a in
           arrays(e + t, (e, t, d), (e, d, f), (e, d, f), (e, f, d))]
    args = [a.to(dtype) for a in ins]
    n0 = tmg.launches
    got = f32(tmg.moe_gmm_cuda(*args))
    assert tmg.launches == n0 + 1
    truth = f32(ref.moe_gmm_ref(*(a.float() for a in args)))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, truth, atol=1e-4, rtol=1e-4)
        return
    assert_bf16_rule(got, args, truth, ref.moe_gmm_ref)


@pytest.mark.parametrize("e", [1, 4])
@pytest.mark.parametrize("t", [1, 8, 24, 100, 257])
def test_moe_gmm_tensor_core_matches_plain(cuda, e, t):
    """The tensor-core variant at every tile plan the main path and prefill
    reach, T past one block's 256 tokens included."""
    d, f = 256, 128
    args = [torch.from_numpy(a).to(cuda).to(torch.bfloat16) for a in
            arrays(e * 7 + t, (e, t, d), (e, d, f), (e, d, f), (e, f, d))]
    assert tmg.variant(torch.bfloat16, d, f) == "tensor_core"
    n0, v0 = tmg.launches, dict(tmg.variant_launches)
    got = f32(tmg.moe_gmm_cuda(*args))
    assert tmg.launches == n0 + 1
    assert tmg.variant_launches == {**v0, "tensor_core": v0["tensor_core"] + 1}
    assert got.shape == (e, t, d) and np.isfinite(got).all()
    truth = f32(ref.moe_gmm_ref(*(a.float() for a in args)))
    assert_bf16_rule(got, args, truth, ref.moe_gmm_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 4])
def test_flash_decode_split_boundaries(cuda, dtype, g):
    """Lengths on and beside the chunk boundaries, the full cache, and 0
    (zeros, as the Pallas kernel gives), with S not a multiple of the chunk."""
    kh, s, hd = 2, 300, 128
    lens = [1, 63, 64, 65, 128, s, 0]
    b = len(lens)
    q, k, v = (torch.from_numpy(a).to(cuda).to(dtype) for a in
               arrays(g + tfd.CHUNK, (b, kh * g, hd), (b, kh, s, hd), (b, kh, s, hd)))
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    n0 = tfd.launches
    got = f32(tfd.flash_decode_cuda(q, k, v, lengths))
    assert tfd.launches == n0 + 1
    assert np.isfinite(got).all()
    assert (got[-1] == 0).all()
    truth = f32(ref.flash_decode_ref(q.float(), k.float(), v.float(), lengths))[:-1]
    if dtype == torch.float32:
        np.testing.assert_allclose(got[:-1], truth, atol=1e-4, rtol=1e-4)
        return
    err_plain = np.abs(f32(ref.flash_decode_ref(q, k, v, lengths))[:-1] - truth).max()
    assert np.abs(got[:-1] - truth).max() <= 1.5 * err_plain + 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_cuda_matches_plain(cuda, dtype):
    b, h, kh, s, hd = 3, 8, 2, 203, 128
    q, k, v = (torch.from_numpy(a).to(cuda).to(dtype) for a in
               arrays(9, (b, h, hd), (b, kh, s, hd), (b, kh, s, hd)))
    lens = torch.tensor([1, 64, 203], dtype=torch.int32, device=cuda)
    n0 = tfd.launches
    got = f32(tfd.flash_decode_cuda(q, k, v, lens))
    assert tfd.launches == n0 + 1
    # a scalar length broadcasts to every slot
    got_scalar = f32(tfd.flash_decode_cuda(q, k, v, 64))
    for out, length in ((got, lens), (got_scalar, 64)):
        truth = f32(ref.flash_decode_ref(q.float(), k.float(), v.float(), length))
        if dtype == torch.float32:
            np.testing.assert_allclose(out, truth, atol=1e-4, rtol=1e-4)
            continue
        # bf16: as close to the f32 truth as the plain bf16 version, 1.5x + 1e-3
        err_plain = np.abs(f32(ref.flash_decode_ref(q, k, v, length)) - truth).max()
        assert np.abs(out - truth).max() <= 1.5 * err_plain + 1e-3


def test_kernel_attributes_are_reported(cuda):
    """Every kernel of both libraries reports its registers and spills."""
    from repro_torch.kernels import build
    for name in build.KERNELS:
        attrs = build.kernel_attributes(name)
        assert attrs and all(a["regs"] > 0 for a in attrs.values())


def test_wrappers_reject_bad_inputs(cuda):
    x, wg, wu, wd = (torch.from_numpy(a).to(cuda) for a in
                     arrays(1, (2, 8, 16), (2, 16, 24), (2, 16, 24), (2, 24, 16)))
    with pytest.raises(ValueError, match="dtype"):
        tmg.moe_gmm_cuda(x, wg.double(), wu, wd)
    with pytest.raises(ValueError, match="contiguous"):
        tmg.moe_gmm_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), wg, wu, wd)
    with pytest.raises(ValueError):
        tmg.moe_gmm_cuda(x, wg[:, :, :20], wu, wd)
    q = torch.zeros((2, 4, 64), dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros(2 * 2 * 16 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte boundary"):
        tfd.flash_decode_cuda(q, kv[1:].view(2, 2, 16, 64), kv[:-1].view(2, 2, 16, 64), 5)
