"""What the work needs, counted from shapes and inputs, never from what
an implementation does: the bytes and operations of one ``moe_gmm`` or
``flash_decode`` call, and the model FLOPs of a token at a context.

A kernel call's needed work is read from its inputs: ``moe_gmm`` needs
the weights of the experts whose rows hold a token, read once, those
rows in and out, and 6 D F operations a row; ``flash_decode`` needs the
K and V rows below each slot's length, read once, q in and o out, and
4 hd operations for each query head and key. The counts are device
tensors, so that recording a call does not wait for the device."""
from __future__ import annotations

import torch


def moe_gmm_work(x, w_gate):
    """(bytes, flops) of one call, 0-d float64 device tensors. x [E, T, D],
    w_gate [E, D, F]."""
    e, t, d = x.shape
    f = w_gate.shape[-1]
    el = x.element_size()
    live = (x != 0).any(-1)                                   # [E, T] rows holding a token
    rows = live.sum().double()
    experts = live.any(-1).sum().double()
    n_bytes = experts * (3 * d * f * w_gate.element_size()) + rows * (2 * d * el)
    return n_bytes, rows * (6.0 * d * f)


def flash_decode_work(q, k, length):
    """(bytes, flops) of one call. q [B, H, hd]; k [B, KH, S, hd]; length
    an int or a [B] tensor of valid rows a slot."""
    b, h, hd = q.shape
    kh = k.shape[1]
    el = q.element_size()
    if torch.is_tensor(length):
        rows = torch.clamp(length.to(torch.float64), max=k.shape[2]).sum()
        if length.dim() == 0:
            rows = rows * b
    else:
        rows = torch.tensor(float(min(length, k.shape[2]) * b), dtype=torch.float64,
                            device=q.device)
    n_bytes = rows * (2 * kh * hd * k.element_size()) + 2 * b * h * hd * el
    return n_bytes, rows * (4.0 * h * hd)


class ModelFlops:
    """Model FLOPs of one token through the stack: 2 x the matmul weights
    it touches (routed experts: only the top-k; the head only where a
    token's logits are made) plus each attention layer's products with
    the `context` keys it reads and each Mamba layer's scan. No capacity
    padding, no recomputation: the work the model defines."""

    def __init__(self, layers, d: int, vocab: int):
        """layers: [(per-token matmul weights, attention FLOPs per key,
        other FLOPs per token)] one per layer."""
        self.body = sum(2.0 * w + o for w, _, o in layers)
        self.per_key = sum(a for _, a, _ in layers)
        self.head = 2.0 * d * vocab

    def prompt(self, length: int) -> float:
        """A prefill of `length` tokens (keys 1..length), without logits."""
        return length * self.body + self.per_key * length * (length + 1) / 2

    def decode(self, context: int) -> float:
        """One token at `context` keys, with its logits."""
        return self.body + self.per_key * context + self.head
