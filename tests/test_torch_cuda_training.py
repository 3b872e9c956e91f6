"""Training on the card (``cuda`` marker; skipped without one): the
differentiable ``moe_gmm`` (``MoeGmm``: the CUDA kernel forward, the plain
backward) against autograd of the plain version, and a few ``Trainer``
steps of a reduced config on the card against the same steps on the CPU.
Like ``tests/test_torch_cuda.py`` this file imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda_training.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.kernels import moe_gmm as tmg  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.training.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.training.train_loop import TrainConfig, Trainer  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def gmm_arrays(seed, e, t, d, f):
    rng = np.random.default_rng(seed)
    shapes = (((e, t, d), 0.3), ((e, d, f), d ** -0.5), ((e, d, f), d ** -0.5),
              ((e, f, d), f ** -0.5), ((e, t, d), 1.0))
    return [(rng.standard_normal(s) * c).astype(np.float32) for s, c in shapes]


def f32(t):
    return t.detach().float().cpu().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,t,d,f", [(4, 24, 256, 128), (2, 100, 64, 300),
                                     (3, 9, 40, 7)])
def test_moe_gmm_function_matches_plain_autograd(cuda, e, t, d, f, dtype):
    """Forward and every gradient through ``ops.moe_gmm`` (the kernel in
    ``MoeGmm``) against autograd of ``moe_gmm_ref`` on the same card
    tensors. f32: atol=rtol=1e-4. bf16: each output no further from the
    f32 truth than 1.5x the plain bf16 version's distance plus 1e-3."""
    *ins, dy = gmm_arrays(e + t, e, t, d, f)
    a = [torch.from_numpy(x).to(cuda, dtype).requires_grad_() for x in ins]
    b = [x.detach().clone().requires_grad_() for x in a]
    c = [x.detach().float().requires_grad_() for x in a]
    tdy = torch.from_numpy(dy).to(cuda, dtype)
    n0 = tmg.launches
    ya = ops.moe_gmm(*a)
    assert tmg.launches == n0 + 1 and type(ya.grad_fn).__name__ == "MoeGmmBackward"
    yb, yc = ref.moe_gmm_ref(*b), ref.moe_gmm_ref(*c)
    got = [ya] + list(torch.autograd.grad(ya, a, tdy))
    plain = [yb] + list(torch.autograd.grad(yb, b, tdy))
    truth = [yc] + list(torch.autograd.grad(yc, c, tdy.float()))
    assert tmg.launches == n0 + 1                     # the backward launches no kernel
    for g, p, tr in zip(got, plain, truth):
        assert g.dtype == dtype and torch.isfinite(g).all()
        if dtype == torch.float32:
            np.testing.assert_allclose(f32(g), f32(p), atol=1e-4, rtol=1e-4)
        else:
            err_plain = np.abs(f32(p) - f32(tr)).max()
            assert np.abs(f32(g) - f32(tr)).max() <= 1.5 * err_plain + 1e-3


def test_expert_weights_get_gradients_on_the_card(cuda):
    """The fault the Function repairs: every expert weight of a MoE model
    on the card gets a nonzero gradient, as on the CPU."""
    cfg = reduced_config(get_arch("olmoe-1b-7b"), dtype="float32")
    params = M.init_model(cfg, device="cpu", seed=2)
    gpu = convert.tree_map(lambda t: t.to(cuda).requires_grad_(), params)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)).to(cuda)
    loss = M.train_loss(gpu, {"tokens": tokens}, cfg)
    loss.backward()
    for layer in gpu["stack"]:
        for name in ("w_gate", "w_up", "w_down"):
            assert float(layer["ffn"][name].grad.abs().max()) > 0, name


@pytest.mark.parametrize("remat", [False, True])
def test_trainer_on_the_card_matches_the_cpu(cuda, remat):
    """3 steps of the reduced olmoe in f32 from the same weights: the
    card's losses within 1e-4 relative of the CPU's, params within the
    accumulation tolerance of ``tests/test_training.py`` (rtol 2e-2,
    atol 2e-3); ``moe_gmm`` launched once per MoE layer and step, twice
    with remat (the forward runs again in the backward)."""
    cfg = reduced_config(get_arch("olmoe-1b-7b"), dtype="float32")
    params = M.init_model(cfg, device="cpu", seed=4)
    tc = TrainConfig(lr=1e-3, log_every=0, remat=remat)
    cpu = Trainer(cfg, tc, params=convert.tree_map(torch.clone, params), device="cpu")
    card = Trainer(cfg, tc, params=convert.tree_map(lambda t: t.to(cuda), params),
                   device="cuda")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=4, seed=0))
    lc = cpu.run(data, 3, log=lambda s: None)
    tmg.reset_counts()
    lg = card.run(data, 3, log=lambda s: None)
    n_moe = sum(s.ffn == "moe" for s in cfg.layer_specs)
    assert tmg.launches == 3 * n_moe * (2 if remat else 1)
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for a, b in zip(convert.tree_leaves(card.params), convert.tree_leaves(cpu.params)):
        np.testing.assert_allclose(f32(a), f32(b), rtol=2e-2, atol=2e-3)
