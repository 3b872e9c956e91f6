"""End-to-end training example on the PyTorch port: train a small MoE LM
on the synthetic motif dataset, with checkpointing and (optionally) an
injected failure and automatic recovery mid-run. The port's counterpart of
``examples/train_lm.py``; it runs on the card unless ``--device cpu`` is
given.

  PYTHONPATH=src python examples/train_lm_torch.py                # ~10M params
  PYTHONPATH=src python examples/train_lm_torch.py --steps 300 --inject-failure
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20
"""
import argparse
import tempfile

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.convert import tree_leaves
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.fault_tolerance import FailureInjector, run_with_recovery
from repro_torch.training.train_loop import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--inject-failure", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    base = get_arch("olmoe-1b-7b")
    cfg = base.replace(
        num_layers=args.layers, d_model=args.d_model,
        num_heads=max(args.d_model // 32, 1),
        num_kv_heads=max(args.d_model // 32, 1),
        d_head=32, d_ff=args.d_model * 2, vocab_size=2048,
        moe=base.moe and base.moe.__class__(
            num_experts=args.experts, experts_per_token=2,
            d_expert=args.d_model // 2))
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")

    tc = TrainConfig(lr=args.lr, microbatches=args.microbatches,
                     grad_compress=args.grad_compress, log_every=10,
                     ckpt_every=25, ckpt_dir=ckpt_dir)
    tr = Trainer(cfg, tc, device=args.device)
    n = sum(p.numel() for p in tree_leaves(tr.params))
    print(f"model: {n / 1e6:.1f}M params ({args.layers}L d={args.d_model} "
          f"{args.experts}e top-2) on {args.device} | ckpts -> {ckpt_dir}")

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                  global_batch=args.batch))
    if args.inject_failure:
        inj = FailureInjector(fail_at=[args.steps // 2])
        rep = run_with_recovery(tr, data, args.steps, injector=inj)
        print(f"\nrecovered from {rep.restarts} failure(s): {rep.recovery_log}")
        losses = rep.losses
    else:
        losses = tr.run(data, args.steps)

    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"\nloss: {first:.3f} -> {last:.3f} over {len(losses)} steps "
          f"({'LEARNING' if last < first - 0.2 else 'check config'})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
