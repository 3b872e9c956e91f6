"""The port's kernels at the shapes of starcoder2-3b, granite-moe-3b-a800m,
gemma3-1b, deepseek-v3, jamba-v0.1-52b, deepseek-67b and seamless-m4t-medium,
and the sliding-window, MLA, Mamba, RWKV, encoder-decoder, DBO and
speculative-decoding paths, on the card against the port's plain CPU path
(``cuda`` marker; skipped
without a card). Like ``tests/test_torch_cuda.py`` this file imports no
JAX, so it runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda_serving.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import moe_gmm as tmg  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import attention as TA  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.serving.dbo import dbo_decode_step  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.specdec import SDDecoder  # noqa: E402
from repro_torch.sharding.dist import NullDist  # noqa: E402
from repro_torch.sharding.plans import null_plan  # noqa: E402

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


def on_card(tree, dev):
    return convert.tree_map(lambda t: t.to(dev), tree)


def clone(tree):
    return convert.tree_map(torch.clone, tree)


# ---------------------------------------------------------------------------
# kernels at the new configurations' shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kh,hd,s", [(24, 2, 128, 512),     # starcoder2, g=12
                                       (24, 8, 64, 512),      # granite, g=3
                                       (4, 1, 256, 1024),     # gemma3 ring, g=4
                                       (64, 8, 128, 512),     # deepseek-67b, g=8
                                       (16, 16, 64, 512)])    # seamless, g=1
def test_flash_decode_new_shapes(cuda, dtype, h, kh, hd, s):
    lens = [1, 63, 64, 65, s - 1, s]
    b = len(lens)
    q, k, v = (torch.from_numpy(a).to(cuda).to(dtype) for a in
               arrays(h + hd, (b, h, hd), (b, kh, s, hd), (b, kh, s, hd)))
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    n0 = tfd.launches
    got = f32(tfd.flash_decode_cuda(q, k, v, lengths))
    assert tfd.launches == n0 + 1
    truth = f32(ref.flash_decode_ref(q.float(), k.float(), v.float(), lengths))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, truth, atol=1e-4, rtol=1e-4)
        return
    err_plain = np.abs(f32(ref.flash_decode_ref(q, k, v, lengths)) - truth).max()
    assert np.abs(got - truth).max() <= 1.5 * err_plain + 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gmm_granite_shape(cuda, dtype):
    """Weights at the model's init scale (fan-in^-0.5, as ``init_moe``), so
    the outputs are O(1) as on the main path."""
    e, t, d, f = 40, 8, 1536, 512
    x, wg, wu, wd = arrays(40, (e, t, d), (e, d, f), (e, d, f), (e, f, d))
    scale = (1.0, d ** -0.5 / 0.3, d ** -0.5 / 0.3, f ** -0.5 / 0.3)
    args = [torch.from_numpy(a * c).to(cuda).to(dtype)
            for a, c in zip((x, wg, wu, wd), scale)]
    got = f32(tmg.moe_gmm_cuda(*args))
    truth = f32(ref.moe_gmm_ref(*(a.float() for a in args)))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, truth, atol=1e-4, rtol=1e-4)
        return
    assert tmg.variant(dtype, d, f) == "tensor_core"
    err_plain = np.abs(f32(ref.moe_gmm_ref(*args)) - truth).max()
    assert np.abs(got - truth).max() <= 1.5 * err_plain + 1e-3


# ---------------------------------------------------------------------------
# sliding-window, DBO and SD paths: the card against the CPU
# ---------------------------------------------------------------------------

def reduced(arch):
    cfg = reduced_config(get_arch(arch), dtype="float32")
    return cfg, M.init_model(cfg, device="cpu", seed=0)


def test_window_decode_on_the_card(cuda):
    """Ring decode at per-slot positions before and after the wrap: the
    card (flash_decode) against the CPU (plain version), float32."""
    cfg, params = reduced("gemma3-1b")
    W = cfg.sliding_window
    pos = torch.tensor([2, W - 1, W, 3 * W + 5])
    x, kc, vc = (torch.from_numpy(a) for a in arrays(
        5, (4, 1, cfg.d_model), (4, 1, W, cfg.head_dim), (4, 1, W, cfg.head_dim)))
    mix = params["stack"][0]["mixer"]
    outs = []
    for dev in ("cpu", cuda):
        cache = {"k": kc.clone().to(dev), "v": vc.clone().to(dev)}
        n0 = tfd.launches
        y, c = TA.attention_decode(on_card(mix, dev), x.to(dev), cache, pos.to(dev),
                                   cfg, null_plan("decode"), NullDist(), window=W)
        assert tfd.launches == n0 + (dev is cuda)
        outs.append((y.cpu(), c["k"].cpu(), c["v"].cpu()))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4, rtol=1e-4)


def test_engine_gemma3_on_the_card_matches_cpu(cuda):
    """Reduced gemma3 (window 8) through the engine, requests that wrap the
    ring, the card's tokens equal to the CPU's."""
    cfg, params = reduced("gemma3-1b")
    rng = np.random.default_rng(0)
    reqs = [rng.integers(1, 500, n).tolist() for n in (3, 8, 11)]
    out = []
    for dev, p in (("cpu", params), (cuda, on_card(params, cuda))):
        eng = Engine(cfg, p, max_batch=2, max_seq=32, eos_id=-1, device=dev)
        for r in reqs:
            eng.submit(r, max_new_tokens=12)
        out.append(eng.run())
    assert out[0] == out[1]


def test_dbo_on_the_card_equals_two_plain_steps(cuda):
    cfg, params = reduced("olmoe-1b-7b")
    params = on_card(params, cuda)
    toks, caches = [], []
    for prompts in ([[3, 5, 7, 11], [9, 8, 1, 6]], [[2, 7, 1, 8], [1, 4, 1, 4]]):
        tok, c = M.prefill(params, {"tokens": torch.tensor(prompts, device=cuda)}, cfg)
        toks.append(tok)
        caches.append(kvcache.pad_to_capacity(cfg, c, 4, 16))
    na, pa = M.decode_step(params, clone(caches[0]), toks[0], 4, cfg)
    nb, pb = M.decode_step(params, clone(caches[1]), toks[1], 4, cfg)
    m0, f0 = tmg.launches, tfd.launches
    da, db, ca, cb = dbo_decode_step(params, clone(caches[0]), clone(caches[1]),
                                     toks[0], toks[1], 4, cfg, null_plan("decode"),
                                     NullDist())
    assert tmg.launches - m0 == tfd.launches - f0 == 2 * cfg.num_layers
    assert torch.equal(da, na) and torch.equal(db, nb)
    for got, want in ((ca, pa), (cb, pb)):
        for lg, lw in zip(got, want):
            for n in ("k", "v"):
                assert torch.equal(lg["mixer"][n], lw["mixer"][n])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "gemma3-1b"])
def test_sd_on_the_card_equals_greedy(cuda, arch):
    cfg, params = reduced(arch)
    params = on_card(params, cuda)
    prompt = torch.tensor([[3, 5, 7, 11, 2, 4]], device=cuda)
    tok, c = M.prefill(params, {"tokens": prompt}, cfg)
    c = kvcache.pad_to_capacity(cfg, c, 6, 64)
    ref_toks, caches, t = [tok], clone(c), tok
    for pos in range(6, 6 + 11):
        t, caches = M.decode_step(params, caches, t, pos, cfg)
        ref_toks.append(t)
    want = torch.cat(ref_toks, dim=1)
    dec = SDDecoder(cfg, params, spec_m=4, device=cuda)
    toks, _, _ = dec.generate(c, tok, 6, 11)
    assert torch.equal(torch.cat([tok, toks], dim=1), want)


# ---------------------------------------------------------------------------
# deepseek-v3 (MLA, 256 experts) and jamba-v0.1-52b (Mamba): shapes and paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,t,d,f,dtype", [
    (256, 8, 7168, 2048, torch.bfloat16),      # deepseek-v3 decode
    (16, 24, 4096, 14336, torch.bfloat16),     # jamba prefill of 128 tokens
    (16, 8, 4096, 14336, torch.float32)])      # jamba decode, CUDA-core variant
def test_moe_gmm_at_the_new_models_widths(cuda, e, t, d, f, dtype):
    """Published widths, weights at ``init_moe``'s scale, drawn on the card.
    The f32 truth and the plain bf16 version go 32 experts at a time (at
    256 experts the whole f32 truth would need 45 GB)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(e)
    args = [torch.randn(s, generator=g, device=cuda, dtype=dtype).mul_(c)
            for s, c in (((e, t, d), 0.3), ((e, d, f), d ** -0.5),
                         ((e, d, f), d ** -0.5), ((e, f, d), f ** -0.5))]
    n0 = tmg.launches
    got = tmg.moe_gmm_cuda(*args)
    assert tmg.launches == n0 + 1
    for i in range(0, e, 32):
        sl = [a[i:i + 32] for a in args]
        truth = ref.moe_gmm_ref(*(a.float() for a in sl))
        if dtype == torch.float32:
            torch.testing.assert_close(got[i:i + 32], truth, atol=1e-4, rtol=1e-4)
            continue
        err_plain = (ref.moe_gmm_ref(*sl).float() - truth).abs().max()
        assert (got[i:i + 32].float() - truth).abs().max() <= 1.5 * err_plain + 1e-3


def test_mla_decode_on_the_card_matches_cpu(cuda):
    """Reduced deepseek-v3, float32: per-slot positions, one of them past
    the cache (the clamped write of the new latent), the card's output and
    latent cache against the CPU's. No kernel of the port runs here."""
    from repro_torch.models.layers import mla as TMLA
    cfg, params = reduced("deepseek-v3")
    pos = torch.tensor([0, 5, 15, 21])
    x, c_kv, k_rope = (torch.from_numpy(a) for a in arrays(
        9, (4, 1, cfg.d_model), (4, 16, cfg.mla_kv_lora_rank),
        (4, 16, cfg.mla_rope_head_dim)))
    mix = params["stack"][0]["mixer"]
    outs = []
    for dev in ("cpu", cuda):
        cache = {"c_kv": c_kv.clone().to(dev), "k_rope": k_rope.clone().to(dev)}
        m0, f0 = tmg.launches, tfd.launches
        y, c = TMLA.mla_decode(on_card(mix, dev), x.to(dev), cache, pos.to(dev),
                               cfg, null_plan("decode"), NullDist())
        assert (tmg.launches, tfd.launches) == (m0, f0)
        outs.append((y.cpu(), c["c_kv"].cpu(), c["k_rope"].cpu()))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["deepseek-v3", "jamba-v0.1-52b"])
def test_engine_new_models_on_the_card_match_cpu(cuda, arch):
    """Reduced deepseek-v3 and jamba (prompts of 2, 8 and 11 tokens, one
    shorter than jamba's conv tail) through the engine: the card's tokens
    equal the CPU's, with moe_gmm once per MoE layer and wave and per
    prefill, and flash_decode once per GQA layer and wave (none on MLA)."""
    cfg, params = reduced(arch)
    rng = np.random.default_rng(1)
    reqs = [rng.integers(1, 500, n).tolist() for n in (2, 8, 11)]
    n_moe = sum(s.ffn == "moe" for s in cfg.layer_specs)
    n_gqa = sum(s.mixer == "attn" for s in cfg.layer_specs) if cfg.attn_kind == "gqa" else 0
    out = []
    for dev, p in (("cpu", params), (cuda, on_card(params, cuda))):
        eng = Engine(cfg, p, max_batch=2, max_seq=32, eos_id=-1, device=dev)
        for r in reqs:
            eng.submit(r, max_new_tokens=10)
        m0, f0, waves = tmg.launches, tfd.launches, 0
        while eng.queue or any(eng.live):
            waves += eng.step() > 0
        out.append({rid: r.generated for rid, r in eng.finished.items()})
        if dev is cuda:
            assert tmg.launches - m0 == n_moe * (waves + len(reqs))
            assert tfd.launches - f0 == n_gqa * waves
    assert out[0] == out[1]


def test_dbo_deepseek_on_the_card_equals_two_plain_steps(cuda):
    cfg, params = reduced("deepseek-v3")
    params = on_card(params, cuda)
    toks, caches = [], []
    for prompts in ([[3, 5, 7, 11], [9, 8, 1, 6]], [[2, 7, 1, 8], [1, 4, 1, 4]]):
        tok, c = M.prefill(params, {"tokens": torch.tensor(prompts, device=cuda)}, cfg)
        toks.append(tok)
        caches.append(kvcache.pad_to_capacity(cfg, c, 4, 16))
    na, pa = M.decode_step(params, clone(caches[0]), toks[0], 4, cfg)
    nb, pb = M.decode_step(params, clone(caches[1]), toks[1], 4, cfg)
    da, db, ca, cb = dbo_decode_step(params, clone(caches[0]), clone(caches[1]),
                                     toks[0], toks[1], 4, cfg, null_plan("decode"),
                                     NullDist())
    assert torch.equal(da, na) and torch.equal(db, nb)
    for got, want in ((ca, pa), (cb, pb)):
        for lg, lw in zip(got, want):
            for n in ("c_kv", "k_rope"):
                assert torch.equal(lg["mixer"][n], lw["mixer"][n])


def test_sd_jamba_on_the_card_equals_greedy(cuda):
    """Untrained heads reject most drafts: the SSM and conv states are
    restored from the per-step copies on the card."""
    cfg, params = reduced("jamba-v0.1-52b")
    params = on_card(params, cuda)
    prompt = torch.tensor([[3, 5, 7, 11, 2, 4]], device=cuda)
    tok, c = M.prefill(params, {"tokens": prompt}, cfg)
    c = kvcache.pad_to_capacity(cfg, c, 6, 64)
    ref_toks, caches, t = [tok], clone(c), tok
    for pos in range(6, 6 + 11):
        t, caches = M.decode_step(params, caches, t, pos, cfg)
        ref_toks.append(t)
    want = torch.cat(ref_toks, dim=1)
    dec = SDDecoder(cfg, params, spec_m=4, device=cuda)
    toks, _, _ = dec.generate(c, tok, 6, 11)
    assert torch.equal(torch.cat([tok, toks], dim=1), want)


# ---------------------------------------------------------------------------
# deepseek-67b / internvl2 (g = 8), seamless (g = 1, cross-attention), rwkv6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_cross_shape(cuda, dtype):
    """seamless's cross-attention decode: one int length for every row,
    the whole padded encoder cache."""
    b, h, hd, s = 6, 16, 64, 512
    q, k, v = (torch.from_numpy(a).to(cuda).to(dtype) for a in
               arrays(7, (b, h, hd), (b, h, s, hd), (b, h, s, hd)))
    got = f32(tfd.flash_decode_cuda(q, k, v, s))
    truth = f32(ref.flash_decode_ref(q.float(), k.float(), v.float(), s))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, truth, atol=1e-4, rtol=1e-4)
        return
    err_plain = np.abs(f32(ref.flash_decode_ref(q, k, v, s)) - truth).max()
    assert np.abs(got - truth).max() <= 1.5 * err_plain + 1e-3


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "seamless-m4t-medium"])
def test_engine_rwkv_and_encdec_on_the_card_match_cpu(cuda, arch):
    """Reduced rwkv6 (no kernel: the WKV scan is plain torch) and seamless
    (flash_decode once per decoder layer for self-attention and once for
    cross-attention, each wave) through the engine: the card's tokens
    equal the CPU's."""
    cfg, params = reduced(arch)
    rng = np.random.default_rng(2)
    reqs = [rng.integers(1, 500, n).tolist() for n in (2, 8, 11)]
    per_wave = 2 * cfg.num_layers if cfg.is_encoder_decoder else 0
    out = []
    for dev, p in (("cpu", params), (cuda, on_card(params, cuda))):
        eng = Engine(cfg, p, max_batch=2, max_seq=80, eos_id=-1, device=dev)
        for r in reqs:
            eng.submit(r, max_new_tokens=10)
        m0, f0, waves = tmg.launches, tfd.launches, 0
        while eng.queue or any(eng.live):
            waves += eng.step() > 0
        out.append({rid: r.generated for rid, r in eng.finished.items()})
        if dev is cuda:
            assert tmg.launches == m0 and tfd.launches - f0 == per_wave * waves
    assert out[0] == out[1]


def test_rwkv_prefill_past_a_chunk_on_the_card_matches_cpu(cuda):
    """A 130-token prefill (past two scan chunks) and decode steps of
    reduced rwkv6: logits and the wkv state on the card against the CPU."""
    cfg, params = reduced("rwkv6-1.6b")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(1, 500, (1, 130)))
    outs = []
    for dev, p in (("cpu", params), (cuda, on_card(params, cuda))):
        lg, c = M.prefill_logits(p, {"tokens": prompt.to(dev)}, cfg)
        steps = [lg.cpu()]
        tok = lg[:, 0, :cfg.vocab_size].argmax(-1, keepdim=True)
        for pos in range(130, 134):
            lg, c = M.decode_logits(p, c, tok, pos, cfg)
            steps.append(lg.cpu())
            tok = lg[:, 0, :cfg.vocab_size].argmax(-1, keepdim=True)
        outs.append((torch.cat(steps), c[0]["mixer"]["wkv"].cpu()))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4, rtol=1e-4)
