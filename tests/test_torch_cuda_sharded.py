"""The (o, m, l) form of the port's ``flash_decode`` kernel against its
plain version (``ref.flash_decode_lse_ref``, the port's
``attn_chunk_lse``) on the card (``cuda`` marker; skipped without one):
per-row lengths around the split boundaries, a shard with nothing to
attend to (o = 0, l = 0, m = -1e30, as the reference), seamless's self-
and cross-attention shard shapes on the 2x2 mesh, and the merge of
two shards through ``lse_combine`` over a two-rank KV axis against the
normalised kernel over the whole cache; and every collective of the ``Dist`` on CUDA tensors, over
gloo (four ranks on one card) and, with four cards, over nccl, against the
numpy definitions that ``test_torch_dist.py`` holds the CPU ranks to; and
the split all-to-all (``Dist.all_to_all_start`` / ``wait``) against the
synchronous one on CUDA tensors, over gloo (four ranks on one card) and
over nccl (two cards, one rank each). This file imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda_sharded.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.layers.attention import lse_combine  # noqa: E402
from repro_torch.sharding.dist import NullDist  # noqa: E402

pytestmark = pytest.mark.cuda
NEG_INF = -1e30


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def qkv(seed, b, h, kh, s, hd, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
            for shape in ((b, h, hd), (b, kh, s, hd), (b, kh, s, hd))]


def f32(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kh,hd,s", [(16, 16, 128, 256), (16, 4, 128, 200),
                                       (24, 2, 64, 130), (4, 1, 256, 64)])
def test_lse_form_matches_plain(cuda, dtype, h, kh, hd, s):
    """Lengths 0 (the empty shard), 1, a chunk edge, a ragged end, S and
    past S (clamped, as the sharded decode's lengths never are)."""
    lens = [0, 1, 63, 64, 65, s - 1, s, s + 7]
    q, k, v = (t.to(dtype) for t in qkv(h + s, len(lens), h, kh, s, hd, cuda))
    o, m, l, pm = _check_lse(q, k, v, torch.tensor(lens, dtype=torch.int32, device=cuda))
    # the empty shard: exactly the reference's values
    assert (f32(o[0]) == 0).all() and (f32(l[0]) == 0).all()
    assert (f32(m[0]) == NEG_INF).all() and (f32(pm[0]) == NEG_INF).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lens", [[65, 70, 75, 80], [0, 0, 0, 0], [256] * 4],
                         ids=["self", "self_empty_shard", "cross"])
def test_lse_form_at_seamless_shard_shapes(cuda, dtype, lens):
    """seamless-m4t-medium's two shard shapes on the 2x2 mesh (8 prompts of
    64, 16 new tokens, max_seq 512): a rank's 4 rows, all 16 heads (q
    gathered over model) over 16 KV heads of 64, 256 cache positions.
    Self-attention: model rank 0 holds the decode's positions (lengths
    65-80), rank 1 none; cross-attention: every row of the zero-padded
    encoder cache is attended (``enc_len = max_seq``)."""
    q, k, v = (t.to(dtype) for t in qkv(sum(lens) + 7, 4, 16, 16, 256, 64, cuda))
    _check_lse(q, k, v, torch.tensor(lens, dtype=torch.int32, device=cuda))


def _check_lse(q, k, v, lengths):
    """One ``flash_decode_lse_cuda`` launch (counted) against the plain
    version at the lengths clamped to S: f32 o, m, l within 1e-4; bf16 m
    within 1e-4 and the normalised output as close to the f32 truth as
    the plain bf16 version, 1.5x + 1e-3. Returns (o, m, l) and the plain
    version's m."""
    s = k.shape[2]
    n0 = tfd.lse_launches
    o, m, l = tfd.flash_decode_lse_cuda(q, k, v, lengths)
    torch.cuda.synchronize()
    assert tfd.lse_launches == n0 + 1
    assert o.dtype == m.dtype == l.dtype == torch.float32
    clamped = lengths.clamp(max=s)
    po, pm, pl = ref.flash_decode_lse_ref(q, k, v, clamped)
    # m is the max score: the same to f32 rounding in both types
    np.testing.assert_allclose(f32(m), f32(pm), atol=1e-4, rtol=1e-4)
    if q.dtype == torch.float32:
        for got, want in ((o, po), (l, pl)):
            np.testing.assert_allclose(f32(got), f32(want), atol=1e-4, rtol=1e-4)
        return o, m, l, pm
    to, tm, tl = ref.flash_decode_lse_ref(q.float(), k.float(), v.float(), clamped)
    live = clamped > 0
    if live.any():
        def norm(o_, l_):
            return f32(o_[live] / l_[live][..., None])
        truth = norm(to, tl)
        err_plain = np.abs(norm(po, pl) - truth).max()
        assert np.abs(norm(o, l) - truth).max() <= 1.5 * err_plain + 1e-3
    return o, m, l, pm


class StackedRanks:
    """A Dist for one KV axis of `n` ranks whose tensors are stacked along
    dim 0, rank by rank: psum and pmax reduce over that dim and hand every
    rank the result, as the collectives would."""

    def __init__(self, n):
        self.n = n

    def size(self, axis):
        return self.n

    def psum(self, x, axis):
        return x.sum(0, keepdim=True).expand_as(x)

    def pmax(self, x, axis):
        return x.amax(0, keepdim=True).expand_as(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_shards_merge_to_the_whole_cache(cuda, dtype):
    """The sharded decode at its chip shape (B 4, H 16, hd 128, S_loc 256):
    two shards of a 512-position cache, lengths clamp(pos - r*S_loc + 1, 0,
    S_loc), merged by ``lse_combine`` over a two-rank KV axis, equal the
    normalised kernel over the whole cache; the second shard is empty for
    pos < 256 and holds rows for pos >= 256."""
    q, k, v = (t.to(dtype) for t in qkv(7, 4, 16, 16, 512, 128, cuda))
    pos = torch.tensor([0, 100, 255, 400], device=cuda)
    whole = f32(tfd.flash_decode_cuda(q, k, v, (pos + 1).to(torch.int32)))
    parts = []
    for r in range(2):
        lengths = (pos - r * 256 + 1).clamp(0, 256).to(torch.int32)
        sl = slice(r * 256, (r + 1) * 256)
        parts.append(tfd.flash_decode_lse_cuda(q, k[:, :, sl].contiguous(),
                                                v[:, :, sl].contiguous(), lengths))
    o, m, l = (torch.stack([p[i] for p in parts]) for i in range(3))
    merged = lse_combine(o, m, l, "model", StackedRanks(2))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for r in range(2):
        np.testing.assert_allclose(f32(merged[r]), whole, atol=tol, rtol=tol)
    assert (f32(l[1, :3]) == 0).all() and (f32(l[1, 3]) > 0).all()
    one = lse_combine(*parts[0], None, NullDist())
    np.testing.assert_allclose(f32(one[:3]), whole[:3], atol=tol, rtol=tol)


@pytest.mark.parametrize("transport", ["gloo", "nccl"])
def test_dist_collectives_on_cards(cuda, transport):
    """The collectives of ``test_torch_dist.py`` on CUDA tensors, on a 2x2
    mesh, against the same numpy definitions: over gloo, four ranks on one
    card through pinned host buffers; over nccl, one rank a card."""
    if transport == "nccl" and torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: nccl takes one rank a card")
    from repro_torch.launch import serve
    from test_torch_dist import CASES, N_RANKS, expected
    from torch_sharded_workers import collectives
    out = serve.spawn(collectives, (CASES,), mesh_shape=(2, 2), transport=transport,
                      device="cuda", timeout=300)
    for name, *_ in CASES:
        for r in range(N_RANKS):
            np.testing.assert_array_equal(out[r][name], expected(name, r),
                                          err_msg=f"{name} on rank {r}")


@pytest.mark.parametrize("transport", ["gloo", "nccl"])
def test_split_all_to_all_on_cards(cuda, transport):
    """``all_to_all_start`` / ``wait`` equals ``all_to_all`` bit for bit on
    CUDA tensors, is observed and counted as it, keeps two handles in
    flight on one group under a psum on another, and refuses a gradient
    and a second ``wait()``: over gloo on a 2x2 mesh on one card, over
    nccl on a (2, 1) mesh, one rank a card (the data axis of 2 carries
    the all-to-alls)."""
    if transport == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: nccl takes one rank a card")
    from repro_torch.launch import serve
    from torch_dbo_workers import split_a2a_rank
    shape = (2, 2) if transport == "gloo" else (2, 1)
    out = serve.spawn(split_a2a_rank, mesh_shape=shape, transport=transport,
                      device="cuda", timeout=300)
    for r, checks in enumerate(out):
        assert all(checks.values()), (r, [k for k, ok in checks.items() if not ok])
