"""Plain PyTorch building blocks of the references, in float32, with no
cache and no batching: each function takes one sequence's activations
[S, ...] and the weights as the benchmark drew them (matmul weights
[in, out]). The control of ``correct`` runs the same functions with every
matmul weight rounded to float8 e4m3, one scale per output column
(``fp8_weight``), the precision below the configuration's bfloat16.
Imports nothing of the program."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8_weight(w: torch.Tensor) -> torch.Tensor:
    """w [..., in, out] f32 through float8 e4m3 and back, with a scale of
    amax / 448 per output column."""
    amax = w.abs().amax(dim=-2, keepdim=True)
    s = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (w / s).to(torch.float8_e4m3fn).float() * s


class Weights:
    """Reads weights as float32, or through the control's fp8 rounding."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return fp8_weight(w) if self.fp8 else w


def rms_norm(x, scale, eps: float):
    """x * rsqrt(mean(x^2) + eps) * (1 + scale): the norm weight is stored
    as 1 + scale."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def rope(x, pos, theta: float):
    """RoPE on split halves of the last dim: x [S, H, d], pos [S]."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    ang = pos.float()[:, None] * inv[None, :]
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    a, b = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def causal_attention(q, k, v, scale: float, block: int = 512):
    """q [S, H, dq], k [S, KH, dq], v [S, KH, dv]; query head h reads KV
    head h // (H / KH). Softmax over keys at or before each query."""
    S, H, _ = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty((S, H, v.shape[-1]), dtype=torch.float32, device=q.device)
    for a in range(0, S, block):
        b = min(S, a + block)
        s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * scale
        later = torch.arange(b, device=q.device)[None, :] > torch.arange(a, b, device=q.device)[:, None]
        p = torch.softmax(s.masked_fill(later, -math.inf), dim=-1)
        out[a:b] = torch.einsum("hqk,khd->qhd", p, v[:b])
    return out


def moe(x, p, n_experts: int, top_k: int, capacity_factor: float, groups, W):
    """Routed experts (softmax over the real experts, top-k, gates
    renormalised) with static capacity, plus the shared experts when
    ``p`` has them. `groups`: (start, end) token ranges that each fill
    ceil(n * k * cf / E) slots an expert, token-major; a decision past
    its expert's slots counts 0. Tokens outside every range are a group
    of one each, which top-k over distinct experts can never overfill.
    The experts run one at a time over the tokens that reached them."""
    e_all = p["router"].shape[-1]
    probs = torch.softmax((x @ W(p["router"]))[:, :n_experts], dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    keep = torch.ones_like(idx, dtype=torch.bool)
    for a, b in groups:
        cap = max(1, math.ceil((b - a) * top_k * capacity_factor / e_all))
        flat = idx[a:b].reshape(-1)
        onehot = F.one_hot(flat, e_all)
        slot = ((torch.cumsum(onehot, 0) - onehot).gather(1, flat[:, None]))[:, 0]
        keep[a:b] = (slot < cap).reshape(b - a, top_k)
    w = gates * keep
    y = torch.zeros_like(x)
    for e in range(n_experts):
        tok, j = torch.nonzero((idx == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = swiglu(x[tok], W(p["w_gate"][e]), W(p["w_up"][e]), W(p["w_down"][e]))
        y.index_add_(0, tok, h * w[tok, j][:, None])
    if "w_shared_gate" in p:
        y = y + swiglu(x, W(p["w_shared_gate"]), W(p["w_shared_up"]),
                       W(p["w_shared_down"]))
    return y


def logits(x, final_scale, head, eps: float, vocab: int, W):
    """f32 logits [S, vocab] of the real ids."""
    return rms_norm(x, final_scale, eps) @ W(head[:, :vocab])
