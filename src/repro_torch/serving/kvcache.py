"""KV-cache management for the serving engine.

Port of ``repro.serving.kvcache`` for full-attention caches: a per-layer
list of ``{"mixer": {"k", "v"}}`` leaves [B, KV, S, hd], whose sequence
dim (2) holds absolute positions.
"""
from __future__ import annotations

from typing import List

import torch.nn.functional as F

SEQ_DIM = 2


def pad_to_capacity(cfg, caches: List[dict], from_seq: int, to_seq: int):
    """Grow every k/v leaf's sequence dim from_seq -> to_seq with zeros
    (prefill produced capacity from_seq; the engine runs at to_seq)."""
    if to_seq < from_seq:
        raise ValueError(f"capacity {to_seq} < prefill length {from_seq}")

    def pad(x):
        if x.shape[SEQ_DIM] != from_seq:
            return x
        return F.pad(x, (0, 0, 0, to_seq - from_seq))

    return [{g: {n: pad(x) for n, x in leaves.items()}
             for g, leaves in layer.items()} for layer in caches]


def insert_slot(caches: List[dict], sub: List[dict], slot: int):
    """Copy a single-request cache `sub` (batch dim 1) into batch index
    `slot` of the engine's caches, in place. Returns `caches`."""
    for layer, one in zip(caches, sub):
        for g, leaves in layer.items():
            for n, full in leaves.items():
                full[slot].copy_(one[g][n][0])
    return caches

