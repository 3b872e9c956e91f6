"""The port's training loss and its gradients against the JAX package: the
same numpy batch and JAX-initialised weights (``convert.params_from_jax``)
through ``repro.models.model.train_loss`` under ``jax.value_and_grad`` and
through the port's ``train_loss`` under ``torch.autograd``, for all eleven
reduced configs in float32; the pieces of the loss (``vocab_parallel_xent``,
``aux_load_balance_loss``), the plain backward of ``moe_gmm`` against
``jax.vjp`` of the JAX oracle, the ``MoeGmm`` Function's wiring, remat, and
one AdamW update.

Tolerance rtol 1e-4, atol 1e-5 for the loss and every gradient element
(float32 on both sides; the sums run in another order)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.layers import common as JC  # noqa: E402
from repro.models.layers import moe as JMoE  # noqa: E402
from repro.sharding.dist import NullDist as JaxNullDist  # noqa: E402
from repro.sharding.plans import null_plan as jax_null_plan  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS, get_arch, reduced_config  # noqa: E402
from repro_torch.kernels import moe_gmm as tmg  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import common as TC  # noqa: E402
from repro_torch.models.layers import moe as TMoE  # noqa: E402
from repro_torch.sharding.dist import NullDist  # noqa: E402
from repro_torch.sharding.plans import null_plan  # noqa: E402
from repro_torch.training import optim  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
JPLAN, JDIST = jax_null_plan("train"), JaxNullDist()
PLAN, DIST = null_plan("train"), NullDist()
B, S = 2, 16


def models(arch, seed=0, **overrides):
    jcfg = jax_reduced(jax_arch(arch), dtype="float32", **overrides)
    tcfg = reduced_config(get_arch(arch), dtype="float32", **overrides)
    jp, _ = JM.init_model(jcfg, JPLAN, jax.random.PRNGKey(seed))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def np_batch(cfg, seed=0, b=B, s=S):
    """Tokens (+ patches or frames) from numpy, float32."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "vit_patches":
        batch["patches"] = rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio_frames":
        batch["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return batch


def torch_loss_and_grads(tp, tcfg, batch, remat=False):
    leaves = [p.requires_grad_() for p in convert.tree_leaves(tp)]
    loss = M.train_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                        tcfg, PLAN, DIST, remat=remat)
    return loss, torch.autograd.grad(loss, leaves, materialize_grads=True)


def jax_loss_and_grads(jp, jcfg, tcfg, batch):
    """JAX's loss and its gradients, unstacked into the port's leaf order."""
    def loss_fn(p):
        return JM.train_loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                             jcfg, JPLAN, JDIST, remat=False)
    loss, g = jax.value_and_grad(loss_fn)(jp)
    g = convert.params_from_jax(jax.tree.map(np.asarray, g), tcfg, device="cpu")
    return float(loss), convert.tree_leaves(g)


# ---------------------------------------------------------------------------
# the whole loss, every config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_loss_and_grads_match_jax(arch):
    """Loss and every gradient leaf within rtol 1e-4, atol 1e-5 of
    ``jax.value_and_grad`` of the JAX loss, with the encoder (seamless),
    patches (internvl2) and the MoE load-balance term (olmoe, granite,
    deepseek-v3, jamba) in it."""
    jcfg, tcfg, jp, tp = models(arch)
    batch = np_batch(tcfg)
    lt, gt = torch_loss_and_grads(tp, tcfg, batch)
    lj, gj = jax_loss_and_grads(jp, jcfg, tcfg, batch)
    np.testing.assert_allclose(lt.item(), lj, **TOL)
    assert len(gt) == len(gj)
    for got, want in zip(gt, gj):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert any(float(g.abs().max()) > 0 for g in gt)


@pytest.mark.parametrize("arch,layers", [("olmoe-1b-7b", 3), ("gemma3-1b", 8),
                                         ("jamba-v0.1-52b", 8)])
def test_remat_matches_no_remat(arch, layers):
    """Checkpointing each period recomputes exactly what the first forward
    computed: the same loss and gradients, bit for bit, on the CPU.
    gemma3 at 8 layers is one period of 6 and 2 remainder layers, which
    keep their activations."""
    _, tcfg, _, tp = models(arch, num_layers=layers)
    batch = np_batch(tcfg, seed=1)
    l0, g0 = torch_loss_and_grads(tp, tcfg, batch, remat=False)
    l1, g1 = torch_loss_and_grads(tp, tcfg, batch, remat=True)
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_remat_refuses_modes_with_caches():
    _, tcfg, _, tp = models("olmoe-1b-7b")
    x = torch.zeros((1, 4, tcfg.d_model))
    from repro_torch.models import transformer as tf
    with pytest.raises(ValueError, match="remat"):
        tf.apply_stack(tp["stack"], x, tcfg, PLAN, DIST, mode="prefill", remat=True)


# ---------------------------------------------------------------------------
# the pieces of the loss
# ---------------------------------------------------------------------------

def test_vocab_parallel_xent_matches_jax():
    """The mean and its gradient to the logits; padded vocab ids (at -inf,
    as ``lm_logits`` leaves them) get exactly zero gradient."""
    rng = np.random.default_rng(2)
    v, v_real = 24, 19
    logits = rng.standard_normal((2, 5, v)).astype(np.float32) * 3
    logits[..., v_real:] = -np.inf
    labels = rng.integers(0, v_real, (2, 5)).astype(np.int32)
    cfg = reduced_config(get_arch("olmoe-1b-7b"))
    tl = torch.from_numpy(logits).requires_grad_()
    loss = TC.vocab_parallel_xent(tl, torch.from_numpy(labels), cfg, PLAN, DIST)
    (gt,) = torch.autograd.grad(loss, tl)
    lj, gj = jax.value_and_grad(lambda x: JC.vocab_parallel_xent(
        x, jnp.asarray(labels), cfg, JPLAN, JDIST))(jnp.asarray(logits))
    np.testing.assert_allclose(loss.item(), float(lj), **TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TOL)
    assert (gt[..., v_real:] == 0).all()


def test_aux_load_balance_loss_matches_jax():
    """The loss and its gradient to the router probabilities, and
    ``moe_ffn(collect_aux=True)`` returning (y, aux) as the JAX layer."""
    rng = np.random.default_rng(3)
    probs = rng.dirichlet(np.ones(8), size=12).astype(np.float32)
    idx = np.argsort(-probs, axis=1)[:, :2].astype(np.int32)
    tp_ = torch.from_numpy(probs).requires_grad_()
    at = TMoE.aux_load_balance_loss(tp_, torch.from_numpy(idx).long(), 6)
    (gt,) = torch.autograd.grad(at, tp_)
    aj, gj = jax.value_and_grad(lambda p: JMoE.aux_load_balance_loss(
        p, jnp.asarray(idx), 6))(jnp.asarray(probs))
    np.testing.assert_allclose(at.item(), float(aj), **TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TOL)

    jcfg, tcfg, jp, tp = models("olmoe-1b-7b")
    x = rng.standard_normal((2, 6, tcfg.d_model)).astype(np.float32)
    jlayer = jax.tree.map(lambda a: a[0], jp["stack"]["periods"][0])
    yj, auxj = JMoE.moe_ffn(jlayer["ffn"], jnp.asarray(x), jcfg, JPLAN, JDIST,
                            collect_aux=True)
    yt, auxt = TMoE.moe_ffn(tp["stack"][0]["ffn"], torch.from_numpy(x), tcfg, PLAN,
                            DIST, collect_aux=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
    np.testing.assert_allclose(auxt.item(), float(auxj), **TOL)


# ---------------------------------------------------------------------------
# the gradient of moe_gmm
# ---------------------------------------------------------------------------

def gmm_arrays(seed, e=3, t=10, d=32, f=24):
    rng = np.random.default_rng(seed)
    shapes = (((e, t, d), 1.0), ((e, d, f), d ** -0.5), ((e, d, f), d ** -0.5),
              ((e, f, d), f ** -0.5), ((e, t, d), 1.0))
    return [(rng.standard_normal(s) * c).astype(np.float32) for s, c in shapes]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_bwd_ref_matches_vjp_and_autograd(dtype):
    """``moe_gmm_bwd_ref`` against ``jax.vjp`` of the JAX oracle and
    ``torch.autograd`` of the port's. float32: TOL. bfloat16: within one
    bfloat16 step (2^-7) of each gradient's largest magnitude: both sides
    round products of bf16 inputs summed in f32, in another order."""
    *ins, dy = gmm_arrays(4)
    tdt = getattr(torch, dtype)
    tx = [torch.from_numpy(a).to(tdt) for a in ins]
    tdy = torch.from_numpy(dy).to(tdt)
    got = ref.moe_gmm_bwd_ref(*tx, tdy)
    leaves = [a.clone().requires_grad_() for a in tx]
    auto = torch.autograd.grad(ref.moe_gmm_ref(*leaves), leaves, tdy)
    _, vjp = jax.vjp(jref.moe_gmm_ref, *(jnp.asarray(a, dtype) for a in ins))
    want = vjp(jnp.asarray(dy, dtype))
    for g, a, w, x in zip(got, auto, want, tx):
        assert g.dtype == x.dtype and g.shape == x.shape
        g, a = g.float().numpy(), a.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(g, w, **TOL)
            np.testing.assert_allclose(g, a, **TOL)
        else:
            step = 2.0 ** -7 * np.abs(w).max()
            assert np.abs(g - w).max() <= step
            assert np.abs(g - a).max() <= step


def test_moe_gmm_function_backward_is_the_plain_gradient(monkeypatch):
    """``MoeGmm`` runs the kernel forward and ``moe_gmm_bwd_ref`` backward.
    With the plain version standing in for the kernel (there is no card
    here), its gradients equal autograd's of ``moe_gmm_ref``."""
    monkeypatch.setattr(tmg, "moe_gmm_cuda", ref.moe_gmm_ref)
    *ins, dy = gmm_arrays(5)
    a = [torch.from_numpy(x).requires_grad_() for x in ins]
    b = [torch.from_numpy(x).requires_grad_() for x in ins]
    ya, yb = tmg.MoeGmm.apply(*a), ref.moe_gmm_ref(*b)
    assert torch.equal(ya, yb)
    ga = torch.autograd.grad(ya, a, torch.from_numpy(dy))
    gb = torch.autograd.grad(yb, b, torch.from_numpy(dy))
    for x, y in zip(ga, gb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)


def test_ops_sends_cuda_tensors_through_the_function(monkeypatch):
    """On a CUDA tensor ``ops.moe_gmm`` goes through ``MoeGmm`` (so the
    output has its backward), with or without a gradient wanted, and never
    takes the plain version. The device test and the kernel are stood in
    for here: the card-side check is in ``test_torch_cuda_training.py``."""
    calls, moe_gmm_ref = [], ref.moe_gmm_ref

    def kernel(*args):
        calls.append(args[0].shape)
        return moe_gmm_ref(*args)

    def plain(*args):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(tmg, "moe_gmm_cuda", kernel)
    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    monkeypatch.setattr(ops.kref, "moe_gmm_ref", plain)
    *ins, _ = gmm_arrays(6)
    x = [torch.from_numpy(a).requires_grad_() for a in ins]
    y = ops.moe_gmm(*x)
    assert type(y.grad_fn).__name__ == "MoeGmmBackward"
    with torch.no_grad():
        ops.moe_gmm(*x)
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optim_update_matches_jax(dtype):
    """One AdamW update at step 3 from the same params, gradients and f32
    moments. float32: TOL. bfloat16 params: the f32 update is rounded to
    bf16 on both sides, so at most one bf16 step apart (2^-7 relative)."""
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 6), "b": (5,), "c": (3, 2, 2)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    g = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    m = {k: rng.standard_normal(s).astype(np.float32) * 0.01 for k, s in shapes.items()}
    v = {k: rng.random(s).astype(np.float32) * 0.01 for k, s in shapes.items()}
    jst = joptim.AdamWState(step=jnp.int32(3), m=jax.tree.map(jnp.asarray, m),
                            v=jax.tree.map(jnp.asarray, v))
    jp = {k: jnp.asarray(a, dtype) for k, a in p.items()}
    jp_new, jst_new = joptim.update(jp, jax.tree.map(jnp.asarray, g), jst, lr=1e-2)

    tdt = getattr(torch, dtype)
    tp = {k: torch.from_numpy(a).to(tdt) for k, a in p.items()}
    tst = optim.AdamWState(step=torch.tensor(3, dtype=torch.int32),
                           m={k: torch.from_numpy(a.copy()) for k, a in m.items()},
                           v={k: torch.from_numpy(a.copy()) for k, a in v.items()})
    grads = [torch.from_numpy(g[k]) for k in p]
    tp_new, tst_new = optim.update(tp, grads, tst, lr=1e-2)
    assert int(tst_new.step) == int(jst_new.step) == 4
    assert tst_new.step.dtype == torch.int32
    for k in p:
        assert tp_new[k].dtype == tdt and tst_new.m[k].dtype == torch.float32
        np.testing.assert_allclose(tst_new.m[k].numpy(), np.asarray(jst_new.m[k]), **TOL)
        np.testing.assert_allclose(tst_new.v[k].numpy(), np.asarray(jst_new.v[k]), **TOL)
        got = tp_new[k].float().numpy()
        want = np.asarray(jp_new[k].astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **TOL)
        else:
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    assert tp_new["a"] is tp["a"]                     # updated in place


def test_init_state_is_f32_zeros_on_the_params_devices():
    cfg = reduced_config(get_arch("olmoe-1b-7b"))
    params = M.init_model(cfg, device="cpu")
    st = optim.init_state(params)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    for p, m, v in zip(convert.tree_leaves(params), convert.tree_leaves(st.m),
                       convert.tree_leaves(st.v)):
        assert m.shape == p.shape and m.dtype == v.dtype == torch.float32
        assert not m.any() and not v.any() and m is not v
