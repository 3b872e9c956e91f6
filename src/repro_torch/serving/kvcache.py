"""KV-cache management for the serving engine.

Port of ``repro.serving.kvcache``. The port's caches are a per-layer list
of ``{group: {leaf: tensor}}`` (``group`` is "mixer", "ffn" for an RWKV
layer's channel mix, "cross" for an encoder-decoder), not period-stacked
trees, so a leaf is addressed by (layer index, group, leaf name) and its
batch dim is always 0. This module owns where each leaf's *sequence* dim
lives and which leaves are *recurrent* (order-dependent state that must
be rolled back when speculative tokens are rejected) versus *positional*
(indexed by absolute position: stale speculative writes are masked by the
attention length and later overwritten, so rollback is free).

Leaf classes (leaf key -> class), as in the JAX package:
  k, v (full attention)   positional  (seq dim 2: [B, KV, S, hd])
  k, v (sliding window)   recurrent   (ring buffer: slot aliasing breaks
                                       the masking argument)
  c_kv, k_rope (MLA)      positional  (seq dim 1)
  conv, ssm (mamba)       recurrent
  wkv, shift (rwkv)       recurrent
  cross k, v              positional  (read-only after prefill)
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch
import torch.nn.functional as F

# leaf-name -> seq dim of a non-window positional leaf
_POSITIONAL_SEQ_DIM = {"k": 2, "v": 2, "c_kv": 1, "k_rope": 1}
_RECURRENT_KEYS = {"conv", "ssm", "wkv", "shift"}
# positional leaves that the decode layout replicates over the kv axis
_REPLICATED_IN_DECODE = {"c_kv", "k_rope"}


def _leaf_info(cfg, layer: int, group: str, leaf: str) -> Tuple[str, int]:
    """(class, seq_dim) of one cache leaf. class: 'positional'|'recurrent';
    seq_dim is the dim holding absolute positions (-1: none)."""
    spec = cfg.layer_specs[layer]
    if leaf in _RECURRENT_KEYS:
        return "recurrent", -1
    if group == "cross":
        return "positional", 2             # enc cache: fixed capacity
    if spec.mixer == "attn_local" and cfg.sliding_window and leaf in ("k", "v"):
        return "recurrent", -1             # ring buffer
    return "positional", _POSITIONAL_SEQ_DIM[leaf]


def _map_leaves(fn: Callable, caches: List[dict]):
    """fn(layer, group, leaf, x) over every leaf, keeping the per-layer list
    structure."""
    return [{g: {n: fn(i, g, n, x) for n, x in leaves.items()}
             for g, leaves in layer.items()}
            for i, layer in enumerate(caches)]


def classify(cfg, caches: List[dict]) -> List[dict]:
    """Same structure as `caches`, each leaf 'positional' or 'recurrent'."""
    return _map_leaves(lambda i, g, n, _: _leaf_info(cfg, i, g, n)[0], caches)


def pad_to_capacity(cfg, caches: List[dict], from_seq: int, to_seq: int,
                    plan=None, dist=None):
    """Grow every positional leaf's sequence dim from_seq -> to_seq with
    zeros (prefill produced capacity from_seq; the engine runs at to_seq).
    Recurrent leaves (ring buffers) keep their shape whatever its size. A
    cross cache whose encoder length equals from_seq (the engine encodes
    one frame per prompt token) is padded too, as the JAX function does.

    Sequence-sharded over ``plan.kv_axis`` (n ranks), a rank holds
    positions [r*from_seq/n, (r+1)*from_seq/n) after prefill and must hold
    [r*to_seq/n, (r+1)*to_seq/n) for decode. JAX pads the global array and
    lets the decode sharding cut it again; here that is a re-layout across
    the ranks: an all-gather over the kv axis, the pad, and this rank's
    slice. A cross cache is sharded over the kv axis as the self k, v are,
    and re-laid out the same way: its zero rows are attended, since decode
    reads ``enc_len = max_seq`` positions (the JAX engine's rule). MLA's
    latent leaves (c_kv, k_rope) are replicated over the kv axis in
    decode: gathered and padded, they are kept whole. Mamba's and RWKV's
    leaves are recurrent and already in their decode layout."""
    if to_seq < from_seq:
        raise ValueError(f"capacity {to_seq} < prefill length {from_seq}")
    n = 1 if dist is None else dist.size(plan.kv_axis)
    if from_seq % n or to_seq % n:
        raise ValueError(f"{from_seq} and {to_seq} positions do not split "
                         f"over {n} ranks")

    def pad(i, g, name, x):
        cls, dim = _leaf_info(cfg, i, g, name)
        if cls == "recurrent" or x.shape[dim] != from_seq // n:
            return x
        if n > 1:
            x = dist.all_gather(x, plan.kv_axis, dim=dim)
        widths = [0, 0] * (x.dim() - dim - 1) + [0, to_seq - from_seq]
        x = F.pad(x, widths)
        if n > 1 and name not in _REPLICATED_IN_DECODE:
            r, s_loc = dist.index(plan.kv_axis), to_seq // n
            x = x.narrow(dim, r * s_loc, s_loc).contiguous()
        return x

    return _map_leaves(pad, caches)


def insert_slot(caches: List[dict], sub: List[dict], slot: int):
    """Copy a single-request cache `sub` (batch dim 1) into batch index
    `slot` of the engine's caches, in place. Returns `caches`."""
    for layer, one in zip(caches, sub):
        for g, leaves in layer.items():
            for n, full in leaves.items():
                full[slot].copy_(one[g][n][0])
    return caches


def split_rows(caches: List[dict]) -> Tuple[List[dict], List[dict]]:
    """The batch rows (dim 0 of every leaf) of `caches` cut in two halves,
    each a copy of its own: the caches of a DBO step's two microbatches."""
    def half(lo):
        def cut(i, g, n, x):
            h = x.shape[0] // 2
            return x[lo * h:(lo + 1) * h].clone()
        return _map_leaves(cut, caches)
    return half(0), half(1)


def memory_bytes(caches: List[dict]) -> int:
    return int(sum(x.numel() * x.element_size()
                   for layer in caches for leaves in layer.values()
                   for x in leaves.values()))


def snapshot_recurrent(cfg, caches: List[dict]) -> List[dict]:
    """A copy of every recurrent leaf (None at positional leaves): one step
    of the history that ``select_history`` picks from. The port's decode
    writes caches in place, so the history has to be a copy."""
    return _map_leaves(
        lambda i, g, n, x: x.clone()
        if _leaf_info(cfg, i, g, n)[0] == "recurrent" else None, caches)


def select_history(cfg, final_caches: List[dict], history: List[List[dict]],
                   accept_idx):
    """Combine speculative-decode cache state: positional leaves keep the
    FINAL state (stale writes are masked/overwritten); recurrent leaves are
    restored from `history` (one ``snapshot_recurrent`` per verify step,
    in step order) at step `accept_idx` (the last step whose input token
    was accepted): an int for the whole batch, or a [B] tensor, one step
    per row. Returns the combined caches; `final_caches` is not modified.
    The JAX function takes the history stacked per leaf and one step for
    the batch; the per-row step is what its SD verify step selects."""
    idx = torch.as_tensor(accept_idx).long()

    def pick(i, g, n, final):
        if _leaf_info(cfg, i, g, n)[0] == "positional":
            return final
        if idx.dim() == 0:
            return history[int(idx)][i][g][n]
        hist = torch.stack([h[i][g][n] for h in history])     # [T, B, ...]
        rows = torch.arange(hist.shape[1], device=hist.device)
        return hist[idx.to(hist.device), rows]

    return _map_leaves(pick, final_caches)
