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
    # bf16: as close to the f32 truth as the plain bf16 version, 1.5x + 1e-3
    err_plain = np.abs(f32(ref.moe_gmm_ref(*args)) - truth).max()
    assert np.abs(got - truth).max() <= 1.5 * err_plain + 1e-3


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


def test_wrappers_reject_bad_inputs(cuda):
    x, wg, wu, wd = (torch.from_numpy(a).to(cuda) for a in
                     arrays(1, (2, 8, 16), (2, 16, 24), (2, 16, 24), (2, 24, 16)))
    with pytest.raises(ValueError, match="dtype"):
        tmg.moe_gmm_cuda(x, wg.double(), wu, wd)
    with pytest.raises(ValueError, match="contiguous"):
        tmg.moe_gmm_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), wg, wu, wd)
    with pytest.raises(ValueError):
        tmg.moe_gmm_cuda(x, wg[:, :, :20], wu, wd)
