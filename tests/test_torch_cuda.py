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
@pytest.mark.parametrize("t", [1, 8, 24, 100, 257, 384, 768])
def test_moe_gmm_tensor_core_matches_plain(cuda, e, t):
    """The tensor-core variant at every tile plan the main path, prefill and
    training reach (SWAP up to 256 tokens, ROWS past it), every expert
    reached: nothing skipped."""
    d, f = 256, 128
    args = [torch.from_numpy(a).to(cuda).to(torch.bfloat16) for a in
            arrays(e * 7 + t, (e, t, d), (e, d, f), (e, d, f), (e, f, d))]
    assert tmg.variant(torch.bfloat16, d, f) == "tensor_core"
    n0, v0 = tmg.launches, dict(tmg.variant_launches)
    skip0 = tmg.skipped_counter(cuda).clone()
    got = f32(tmg.moe_gmm_cuda(*args))
    assert tmg.launches == n0 + 1
    assert tmg.variant_launches == {**v0, "tensor_core": v0["tensor_core"] + 1}
    assert (tmg.skipped_counter(cuda) - skip0).tolist() == [0, 0]
    assert got.shape == (e, t, d) and np.isfinite(got).all()
    truth = f32(ref.moe_gmm_ref(*(a.float() for a in args)))
    assert_bf16_rule(got, args, truth, ref.moe_gmm_ref)


def check_skip(cuda, args):
    """One call on a buffer with zero rows: the bf16 rule, the skip counter
    against ``moe_gmm_active_tiles_ref``, the skipped tiles' rows bitwise
    zero and every zero row zero."""
    e, t, _ = args[0].shape
    tile = tmg.tile_plan(t)[2]
    live = ref.moe_gmm_active_tiles_ref(args[0], tile)
    before = tmg.skipped_counter(cuda).clone()
    out = tmg.moe_gmm_cuda(*args)
    skipped = (tmg.skipped_counter(cuda) - before).tolist()
    assert skipped == [int((~live).sum()), int((~live.any(1)).sum())]
    dead = torch.repeat_interleave(~live, tile, dim=1)[:, :t]
    assert (out[dead].view(torch.int16) == 0).all()
    assert (out[~(args[0] != 0).any(-1)] == 0).all()
    truth = f32(ref.moe_gmm_ref(*(a.float() for a in args)))
    assert_bf16_rule(f32(out), args, truth, ref.moe_gmm_ref)
    return skipped


@pytest.mark.parametrize("t", [200, 384])
@pytest.mark.parametrize("fill", [0, 63, 64, 65, 128, 129])
def test_moe_gmm_skips_prefix_fills(cuda, t, fill):
    """Experts filled as a prefix, as ``slot_assignment`` fills them: `fill`
    rows, none, all, one. SWAP (T = 200) skips an expert with no row; ROWS
    (T = 384) each 128-row tile past the fill."""
    d, f = 256, 128
    args = [torch.from_numpy(a).to(cuda).to(torch.bfloat16) for a in
            arrays(fill + t, (4, t, d), (4, d, f), (4, d, f), (4, f, d))]
    for i, n in enumerate((fill, 0, t, 1)):
        args[0][i, n:] = 0
    skipped = check_skip(cuda, args)
    if t > tmg.SWAP_MAX_T:
        ntt = -(-t // 128)
        assert skipped[0] == sum(ntt - -(-n // 128) for n in (fill, 0, t, 1))
    assert skipped[1] == (fill == 0) + 1


@pytest.mark.parametrize("t", [8, 384])
def test_moe_gmm_all_zero_buffer(cuda, t):
    """No expert reached: every tile skipped, out all +0 and no weight read."""
    d, f = 256, 128
    args = [torch.from_numpy(a).to(cuda).to(torch.bfloat16) for a in
            arrays(t, (3, t, d), (3, d, f), (3, d, f), (3, f, d))]
    args[0].zero_()
    assert check_skip(cuda, args) == [3 * -(-t // tmg.tile_plan(t)[2]), 3]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3", "jamba-v0.1-52b"])
@pytest.mark.parametrize("rows,pos,groups", [(8, 1, 8), (4, 512, 1)])
def test_moe_gmm_on_routed_buffers(cuda, arch, rows, pos, groups):
    """The buffer the port's ``moe_ffn`` builds (route, slot_assignment,
    index_add_) at reduced widths with the published expert count and
    top-k: 8 decode slots, or one training group of 2048 tokens."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.models.layers import moe as tmoe
    from repro_torch.sharding.dist import NullDist
    from repro_torch.sharding.plans import null_plan
    full = get_arch(arch)
    cfg = reduced_config(full)
    cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, num_experts=full.moe.num_experts,
        experts_per_token=full.moe.experts_per_token))
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = tmoe.init_moe(cfg, null_plan("decode"), gen)
    x = torch.randn((rows, pos, cfg.d_model), generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    seen, gmm = [], tmoe.kops.moe_gmm
    tmoe.kops.moe_gmm = lambda x_e, *w: seen.append(x_e) or torch.zeros_like(x_e)
    try:
        tmoe.moe_ffn(params, x, cfg, null_plan("decode"), NullDist(), capacity_groups=groups)
    finally:
        tmoe.kops.moe_gmm = gmm
    args = [seen[0]] + [params[k] for k in ("w_gate", "w_up", "w_down")]
    skipped = check_skip(cuda, args)
    if groups > 1:
        assert skipped[1] > 0                     # 8 tokens leave experts unreached


def test_moe_gmm_makes_no_host_sync(cuda):
    """A call queues its work and returns: nothing is read back."""
    args = [torch.from_numpy(a).to(cuda).to(torch.bfloat16) for a in
            arrays(3, (4, 8, 256), (4, 256, 128), (4, 256, 128), (4, 128, 256))]
    args[0][1:3] = 0
    tmg.moe_gmm_cuda(*args)                       # builds, loads, sizes the card
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tmg.moe_gmm_cuda(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (out[1:3] == 0).all()


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
