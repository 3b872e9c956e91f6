"""Per-architecture smoke tests of the port, mirroring
``tests/test_arch_smoke.py`` over all eleven architectures: the reduced
config of each family, bf16, the training loss, prefill and one decode
step on the CPU, asserting shapes, finiteness, token ranges and the cache
structure, and each published config's parameter count."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_arch, reduced_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

B, S = 2, 16


def _batch(cfg, gen):
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen)}
    if cfg.frontend == "vit_patches":
        batch["patches"] = torch.randn((B, cfg.n_frontend_tokens, cfg.d_model),
                                       generator=gen).to(torch.bfloat16)
    if cfg.frontend == "audio_frames":
        batch["frames"] = torch.randn((B, S, cfg.d_model), generator=gen).to(torch.bfloat16)
    return batch


def _structure(caches):
    return [{g: {n: t.dtype for n, t in leaves.items()} for g, leaves in layer.items()}
            for layer in caches]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_loss_finite(arch):
    cfg = reduced_config(get_arch(arch))
    gen = torch.Generator().manual_seed(0)
    params = M.init_model(cfg, device="cpu", seed=0)
    loss = M.train_loss(params, _batch(cfg, gen), cfg, remat=False)
    assert loss.shape == ()
    assert torch.isfinite(loss), f"{arch}: loss={loss}"


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_decode(arch):
    cfg = reduced_config(get_arch(arch))
    gen = torch.Generator().manual_seed(1)
    params = M.init_model(cfg, device="cpu", seed=1)
    tok, caches = M.prefill(params, _batch(cfg, gen), cfg)
    assert tok.shape == (B, 1)
    assert (tok >= 0).all() and (tok < cfg.vocab_size).all()
    # caches from prefill have capacity S; decode one token at pos S - 1 by
    # rewinding (the engine pads capacity; the smoke checks mechanics)
    before = _structure(caches)
    enc_len = S if cfg.is_encoder_decoder else 0
    tok2, caches2 = M.decode_step(params, caches, tok, S - 1, cfg, enc_len=enc_len)
    assert tok2.shape == (B, 1)
    assert (tok2 >= 0).all() and (tok2 < cfg.vocab_size).all()
    assert _structure(caches2) == before
    assert _structure(M.init_cache(cfg, batch=B, seq=S, enc_seq=enc_len,
                                   device="cpu")) == before


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_count_positive(arch):
    cfg = get_arch(arch)
    n = cfg.param_count()
    assert n > 0
    assert cfg.active_param_count() <= n
