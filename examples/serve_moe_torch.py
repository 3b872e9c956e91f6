"""End-to-end serving example on the PyTorch port (the paper's workload
kind): batched requests through the continuous-batching engine, with and
without speculative decoding, on a reduced MoE model. The port's
counterpart of ``examples/serve_moe.py``; it runs on the card unless
``--device cpu`` is given.

  PYTHONPATH=src python examples/serve_moe_torch.py [--arch olmoe-1b-7b]
      [--requests 12] [--max-batch 4] [--sd] [--device cpu]

Prints per-request completions and tokens/s; with --sd also runs the
speculative decoder and reports acceptance and the greedy-equality check
(SD must never change outputs).
"""
import argparse
import time

import torch

from repro_torch.configs import get_arch, reduced_config
from repro_torch.models import model as M
from repro_torch.serving import kvcache
from repro_torch.serving.engine import Engine
from repro_torch.serving.specdec import SDDecoder


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--sd", action="store_true",
                    help="also run the speculative decoder")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(get_arch(args.arch))
    params = M.init_model(cfg, seed=0, device=args.device)
    print(f"arch={args.arch} (reduced) layers={cfg.num_layers} "
          f"d_model={cfg.d_model} vocab={cfg.vocab_size} device={args.device}")

    eng = Engine(cfg, params, max_batch=args.max_batch, max_seq=args.max_seq,
                 eos_id=-1, device=args.device)
    prompts = [[(7 * i + j) % (cfg.vocab_size - 1) + 1 for j in range(6)]
               for i in range(args.requests)]
    rids = [eng.submit(p, max_new_tokens=args.new_tokens) for p in prompts]
    print(f"submitted {len(rids)} requests into {args.max_batch} slots "
          f"(continuous batching)")

    t0 = time.time()
    out = eng.run()
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in out.values())
    print(f"completed {len(out)} requests, {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens / dt:.1f} tok/s on {args.device})")
    for rid in rids[:4]:
        print(f"  req {rid}: prompt={prompts[rid]} -> {out[rid]}")
    if len(rids) > 4:
        print(f"  ... ({len(rids) - 4} more)")

    if args.sd:
        print("\nspeculative decoding (spec_m=4, untrained Medusa heads):")
        prompt = torch.tensor([prompts[0]], dtype=torch.int32, device=args.device)
        tok, caches = M.prefill(params, {"tokens": prompt}, cfg)
        caches = kvcache.pad_to_capacity(cfg, caches, prompt.shape[1], args.max_seq)
        dec = SDDecoder(cfg, params, spec_m=4, device=args.device)
        toks, _, stats = dec.generate(caches, tok, prompt.shape[1], args.new_tokens)
        got = [int(tok[0, 0])] + [int(t) for t in toks[0]]
        want = out[rids[0]][:len(got)]
        print(f"  SD output:     {got}")
        print(f"  greedy output: {want}")
        print(f"  identical: {got == want}  "
              f"mean accepted/iter: {stats['mean_accepted']:.2f} "
              f"({stats['iterations']} iterations)")
        return 0 if got == want else 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
