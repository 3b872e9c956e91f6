"""Quickstart on the PyTorch port: the three layers of this repo, on the card
unless ``--device cpu`` is given. The port's counterpart of
``examples/quickstart.py``.

  1. ANALYSIS  — the paper's methodology: which network topology is the
                 most cost-effective for serving a given MoE model? The
                 search's grids evaluate on the chosen device (the sweep's
                 torch backend).
  2. MODEL     — a reduced MoE transformer (same family as olmoe-1b-7b):
                 one train loss and backward, a prefill, and 5 decode steps.
                 On the card these launch the ``moe_gmm`` and
                 ``flash_decode`` kernels.
  3. KERNEL    — ``ops.moe_gmm`` against its plain version, both beside the
                 float32 truth (on the CPU the wrapper runs the plain
                 version itself).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import math

import torch

from repro_torch import tracing
from repro_torch.configs import get_arch, reduced_config
from repro_torch.convert import tree_leaves
from repro_torch.core import (H100, Scenario, SearchSpec, make_cluster,
                              set_default_device, solve)
from repro_torch.core.tco import cluster_tco
from repro_torch.kernels import flash_decode as kfd
from repro_torch.kernels import moe_gmm as kmoe
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M
from repro_torch.serving import kvcache

TOPOLOGIES = ("scale-up", "scale-out", "torus", "fullmesh")


def analysis(device):
    print("=" * 64)
    print("1) ANALYSIS — topology cost-effectiveness (DeepSeek-V3, 64 XPUs,")
    print(f"   chatbot scenario: TPOT=40ms, context=512, DBO+SD; grids on {device})")
    print("=" * 64)
    set_default_device(device)
    cfg = get_arch("deepseek-v3")
    sc = Scenario(40.0, 512)
    out = {}
    for topo in TOPOLOGIES:
        cl = make_cluster(topo, 64, H100)
        sol = solve(cfg, cl, sc, SearchSpec(opts="dbo+sd"))
        cost = cluster_tco(cl).per_xpu(64)
        thpt = sol.throughput / 64
        out[topo] = thpt / cost
        print(f"  {topo:10s} {thpt:8.0f} tok/s/XPU  cost {cost:7.1f}/mo"
              f"  -> {thpt / cost:6.2f} tok/s per cost unit")
    if not all(math.isfinite(v) and v > 0 for v in out.values()):
        raise SystemExit(f"analysis: a topology found no operating point: {out}")


def model(device):
    print()
    print("=" * 64)
    print("2) MODEL — reduced olmoe (64 experts->8): train / prefill / decode")
    print("=" * 64)
    cfg = reduced_config(get_arch("olmoe-1b-7b"))
    params = M.init_model(cfg, seed=0, device=device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"  params: {n_params / 1e6:.2f}M  layers={cfg.num_layers} "
          f"experts={cfg.moe.num_experts} top-{cfg.moe.experts_per_token}")
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen,
                           device=device, dtype=torch.int32)
    tracing.reset()

    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss = M.train_loss(params, {"tokens": tokens}, cfg, remat=False)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    loss = float(loss.detach())
    gnorm = math.sqrt(sum(float(g.float().pow(2).sum()) for g in grads if g is not None))
    for p in leaves:
        p.requires_grad_(False)
    print(f"  train loss (random init): {loss:.3f} "
          f"(ln V = {math.log(cfg.vocab_size):.3f}), grad norm {gnorm:.3f}")
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        raise SystemExit("model: the loss or its gradient is not finite")

    with torch.no_grad():
        tok, caches = M.prefill(params, {"tokens": tokens}, cfg)
        seq = [int(t) for t in tok[:, 0]]
        pos = tokens.shape[1]
        caches = kvcache.pad_to_capacity(cfg, caches, pos, 32)
        for _ in range(5):
            tok, caches = M.decode_step(params, caches, tok, pos, cfg)
            seq.append(int(tok[0, 0]))
            pos += 1
    print(f"  greedy continuation (request 0): {seq}")
    if device == "cuda":
        print(f"  kernel launches: moe_gmm {kmoe.launches}, "
              f"flash_decode {kfd.launches}")
        if not (kmoe.launches and kfd.launches):
            raise SystemExit("model: the kernels were not launched on the card")


def kernel(device):
    print()
    print("=" * 64)
    print("3) KERNEL — moe_gmm vs its plain version, both against f32 truth")
    print("=" * 64)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    e, t, d, f = 2, 128, 64, 256

    def draw(*shape, scale):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(torch.bfloat16)

    x = draw(e, t, d, scale=0.3)
    wg, wu, wd = draw(e, d, f, scale=0.1), draw(e, d, f, scale=0.1), draw(e, f, d, scale=0.1)
    truth = ref.moe_gmm_ref(x.float(), wg.float(), wu.float(), wd.float())
    got = ops.moe_gmm(x, wg, wu, wd).float()
    plain = ref.moe_gmm_ref(x, wg, wu, wd).float()
    err = float((got - truth).abs().max())
    err_plain = float((plain - truth).abs().max())
    what = "kernel" if device == "cuda" else "plain version (CPU tensors)"
    print(f"  [E={e}, T={t}, D={d}, F={f}] bf16, ran the {what}")
    print(f"  max |moe_gmm - f32 truth| = {err:.2e}   "
          f"max |plain - f32 truth| = {err_plain:.2e}")
    if not err <= 2 * err_plain + 1e-2:
        raise SystemExit(f"kernel: error {err} against the plain version's {err_plain}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    analysis(args.device)
    model(args.device)
    kernel(args.device)
    print("\nquickstart OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
