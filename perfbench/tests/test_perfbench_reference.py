"""The plain references against repro_torch's layers and whole model, in
float32 on the CPU at tiny widths: the same function, to rounding."""
import importlib

import pytest
import torch

from perfbench.harness import spec
from perfbench.harness import weights as wts
from perfbench.reference import common as C
from perfbench.reference import deepseek_v3 as R_ds
from perfbench.reference import jamba as R_jb
from perfbench.tests import tiny

TOL = 1e-4


def setup(cell, **over):
    b = tiny.bench()
    cfg_file = b.config_file(b.cell(cell)["config"])
    run = spec.run_values(cfg_file)
    run.update(tiny.TINY[cfg_file["name"]], dtype="float32", **over)
    port = importlib.import_module(f"perfbench.ports.{run['model_type']}")
    cfg = port.model_config(run, name=cfg_file["name"])
    params = wts.draw(cfg, 5, "cpu")
    return run, cfg, params


def plan_dist():
    from repro_torch.sharding.dist import NullDist
    from repro_torch.sharding.plans import null_plan
    return null_plan("prefill"), NullDist()


def close(a, b, tol=TOL):
    err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-6)
    assert err < tol, err


def test_mla_matches_port():
    from repro_torch.models.layers import mla
    run, cfg, params = setup("dsv3.chat.c1")
    p = params["stack"][0]["mixer"]
    x = torch.randn(1, 23, cfg.d_model)
    y, _ = mla.mla_fwd(p, x, cfg, *plan_dist())
    close(R_ds.mla(x[0], p, run, torch.arange(23), C.Weights()), y[0])


@pytest.mark.parametrize("groups", ["prefill", "decode"])
def test_moe_matches_port_with_capacity(groups):
    from repro_torch.models.layers import moe
    run, cfg, params = setup("dsv3.chat.c1")
    p = params["stack"][0]["ffn"]
    if groups == "prefill":
        # 40 tokens, 8 experts, top 2, cf 1.5: 15 slots an expert, so drops
        x = torch.randn(1, 40, cfg.d_model)
        y = moe.moe_ffn(p, x, cfg, *plan_dist(), capacity_groups=1)[0]
        ref = C.moe(x[0], p, 8, 2, 1.5, [(0, 40)], C.Weights())
    else:
        x = torch.randn(6, 1, cfg.d_model)
        y = moe.moe_ffn(p, x, cfg, *plan_dist(), capacity_groups=6)[:, 0]
        ref = C.moe(x[:, 0], p, 8, 2, 1.5, [], C.Weights())
    close(ref, y)


def test_mamba_and_attention_match_port():
    from repro_torch.models.layers import attention, mamba
    run, cfg, params = setup("jamba.docqa.c1")
    x = torch.randn(1, 37, cfg.d_model)
    pm = params["stack"][0]["mixer"]
    y, _ = mamba.mamba_fwd(pm, x, cfg, *plan_dist())
    close(R_jb.mamba(x[0], pm, run, C.Weights()), y[0])
    pa = params["stack"][4]["mixer"]
    y, _ = attention.attention_fwd(pa, x, cfg, *plan_dist())
    close(R_jb.attention(x[0], pa, run, torch.arange(37), C.Weights()), y[0])


def test_scan_closed_form_matches_the_recurrence():
    S, di, ds = 21, 5, 3
    g = torch.Generator().manual_seed(0)
    u, dt = torch.randn(S, di, generator=g), torch.rand(S, di, generator=g)
    b, c = torch.randn(S, ds, generator=g), torch.randn(S, ds, generator=g)
    a = -torch.rand(di, ds, generator=g) * 3
    h, want = torch.zeros(di, ds), []
    for t in range(S):
        h = torch.exp(dt[t, :, None] * a) * h + (dt[t] * u[t])[:, None] * b[t]
        want.append(h @ c[t])
    close(R_jb.ssm_scan(u, dt, b, c, a), torch.stack(want), 1e-5)


@pytest.mark.parametrize("cell,ref", [("dsv3.chat.c1", R_ds), ("jamba.docqa.c1", R_jb)])
def test_prefill_then_decode_through_the_cache_matches_a_full_pass(cell, ref):
    """The port's prefill of a prompt and its decode steps, through the
    capacity-padded cache with per-slot positions as the engine runs
    them, against the reference's one pass over prompt and tokens."""
    from repro_torch.models import model as M
    from repro_torch.serving import kvcache
    run, cfg, params = setup(cell)
    L, n, cap = 11, 6, 32
    toks = torch.randint(1, cfg.vocab_size, (1, L))
    logits, caches = M.prefill_logits(params, {"tokens": toks}, cfg)
    caches = kvcache.pad_to_capacity(cfg, caches, L, cap)
    got, seq = [logits[0, 0, :cfg.vocab_size]], toks[0].tolist()
    for i in range(n):
        nxt = int(got[-1].argmax())
        seq.append(nxt)
        lg, caches = M.decode_logits(params, caches, torch.tensor([[nxt]]),
                                     torch.tensor([L + i]), cfg)
        got.append(lg[0, 0, :cfg.vocab_size])
    want = ref.forward(params, torch.tensor(seq), L, run)
    close(want, torch.stack(got), 1e-3)


def test_fp8_control_is_coarser_than_f32():
    run, cfg, params = setup("dsv3.chat.c1")
    seq = torch.randint(1, cfg.vocab_size, (20,))
    f32 = R_ds.forward(params, seq, 12, run)
    fp8 = R_ds.forward(params, seq, 12, run, fp8=True)
    assert (fp8 - f32).abs().max() > 1e-2
