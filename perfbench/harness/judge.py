"""How ``correct`` is decided for a served model: a sample of the
requests the run finished, drawn from the seed and holding the longest,
is run once through the plain reference over each prompt and its served
tokens. A served token's gap is how far its logit lies below the
reference's best at its position (served tokens are greedy); the number
compared is the mean gap over the judged tokens (``summary``; the widest
swings with one token, and does not separate the program from the
control). The control puts the reference in the program's place one
precision below (float8 weights): at each position of the same prompts
and tokens, the gap of the token the control puts first."""
from __future__ import annotations

import importlib

import numpy as np
import torch


def sample(done: list, n: int, seed: int) -> list:
    """`n` of the finished (prompt, served) pairs: the longest, then the
    others drawn with ``numpy.random.default_rng([seed, 2])``."""
    if not done:
        return []
    order = sorted(range(len(done)), key=lambda i: -(len(done[i][0]) + len(done[i][1])))
    rest = order[1:]
    rng = np.random.default_rng([seed % (1 << 63), 2])
    picked = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [done[order[0]]] + [done[rest[i]] for i in sorted(picked)]


def reference(model_type: str):
    return importlib.import_module(f"perfbench.reference.{model_type}")


@torch.no_grad()
def gaps(model_type: str, weights, run: dict, reqs: list, device, *,
         fp8_control: bool = False) -> dict:
    """{"served": [gap of each served token]} and, with `fp8_control`,
    {"control": [gap of the control's first token at each position]},
    float32 CPU tensors in the order of the requests and their tokens."""
    ref = reference(model_type)
    served, control = [], []
    for prompt, toks in reqs:
        seq = torch.tensor(prompt + toks[:-1], dtype=torch.long, device=device)
        lg = ref.forward(weights, seq, len(prompt), run)
        best = lg.max(-1).values
        tok = torch.tensor(toks, dtype=torch.long, device=device)
        served.append((best - lg.gather(1, tok[:, None])[:, 0]).cpu())
        if fp8_control:
            first = ref.forward(weights, seq, len(prompt), run, fp8=True).argmax(-1)
            control.append((best - lg.gather(1, first[:, None])[:, 0]).cpu())
        del lg
    out = {"served": torch.cat(served) if served else torch.zeros(0)}
    if fp8_control:
        out["control"] = torch.cat(control) if control else torch.zeros(0)
    return out


def summary(g: torch.Tensor) -> dict:
    """The statistics of a run's gaps that the limits are read from."""
    if g.numel() == 0:
        return {"tokens": 0}
    return {"tokens": g.numel(), "mean": float(g.mean()), "max": float(g.max()),
            "p90": float(torch.quantile(g.double(), 0.9)),
            "share_off": float((g > 0).double().mean())}
