"""Carry JAX-initialised weights and caches across to the port.

The inputs are trees of numpy arrays (``jax.tree.map(np.asarray, tree)``
on the JAX side), never JAX arrays, so this module imports no JAX. A
bfloat16 leaf is a numpy array whose ``dtype.name`` is "bfloat16"; it goes
across bit for bit through a uint16 view. The JAX stack stores each period
position's leaves stacked over periods (``{"periods": (...), "rem": (...)}``)
for ``lax.scan``; the port keeps one entry per layer, in layer order. A
sliding-window layer's ring-buffer cache crosses as it is.
Like every entry point of the port, the converters put the tensors on the
card unless the caller passes ``device="cpu"``. ``shard_tree`` cuts a
global tree into one rank's shards by a spec tree of ``sharding.specs``,
``gather_tree`` puts every rank's shards back together in one process,
and ``unshard_leaf`` does it for one leaf on every rank at once, through
the ranks' ``Dist``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.sharding.specs import P, shard_bounds


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply `fn` to every leaf of a tree of dicts, lists, tuples and named
    tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of `tree` in ``tree_map``'s order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def to_torch(a: np.ndarray, device="cuda") -> torch.Tensor:
    dev = resolve_device(device)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(dev)


def unstack_layers(stack: dict, cfg, n_layers: Optional[int] = None,
                   period_len: Optional[int] = None) -> List[Any]:
    """{"periods": tuple of period-stacked trees, "rem": tuple} -> one tree
    per layer, in the order the JAX stack runs them (period j, position i
    is layer j * len(period) + i; the remainder follows). A stack of
    `n_layers` over a period of `period_len` positions (default: the
    config's decoder stack)."""
    n_pos = period_len or len(cfg.period)
    n_layers = cfg.num_layers if n_layers is None else n_layers
    layers = []
    for j in range(n_layers // n_pos):
        for i in range(n_pos):
            layers.append(tree_map(lambda a: a[j], stack["periods"][i]))
    layers.extend(stack["rem"])
    if len(layers) != n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, config has "
                         f"{n_layers}")
    return layers


def params_from_jax(tree: dict, cfg, device="cuda") -> dict:
    """JAX ``init_model`` params (numpy leaves) -> the port's params; the
    encoder of an encoder-decoder is unstacked over its one-layer period."""
    def layers(stack, **kw):
        return [tree_map(lambda a: to_torch(a, device), layer)
                for layer in unstack_layers(stack, cfg, **kw)]

    out = {k: tree_map(lambda a: to_torch(a, device), v)
           for k, v in tree.items() if k not in ("stack", "encoder")}
    out["stack"] = layers(tree["stack"])
    if "encoder" in tree:
        out["encoder"] = layers(tree["encoder"], n_layers=cfg.encoder_layers,
                                period_len=1)
    return out


def cache_from_jax(tree: dict, cfg, device="cuda") -> List[dict]:
    """JAX caches (``init_cache`` / ``prefill`` layout, numpy leaves) -> the
    port's per-layer cache list, every group of a layer ("mixer", "ffn",
    "cross") carried across."""
    return [tree_map(lambda a: to_torch(a, device).contiguous(), layer)
            for layer in unstack_layers(tree, cfg)]


def draft_heads_from_jax(heads, device="cuda") -> List[torch.Tensor]:
    """JAX ``specdec.init_draft_heads`` (a list of [d_model, vocab] numpy
    arrays) -> the port's draft heads, so both sides draft the same
    tokens."""
    return [to_torch(h, device) for h in heads]


def _zip_specs(fn: Callable, tree: Any, specs: Any) -> Any:
    """fn(leaf, spec) over a tree and its spec tree (``P`` leaves)."""
    if isinstance(specs, P):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, v, specs[k]) for k, v in tree.items()}
    return type(tree)(_zip_specs(fn, a, s) for a, s in zip(tree, specs))


def shard_leaf(x, spec, mesh, rank: Optional[int] = None):
    """`rank`'s block (default: the mesh's own rank) of a global leaf
    (a tensor or a numpy array), copied so that the global can be freed."""
    bounds = shard_bounds(x.shape, spec, mesh, rank)
    if all(lo == 0 and hi == n for (lo, hi), n in zip(bounds, x.shape)):
        return x
    block = x[tuple(slice(lo, hi) for lo, hi in bounds)]
    return block.clone() if isinstance(block, torch.Tensor) else np.array(block)


def shard_tree(global_tree: Any, specs: Any, mesh, rank: Optional[int] = None) -> Any:
    """One rank's shards of a tree of global leaves (numpy from JAX, or the
    port's own global init), by the spec tree of ``sharding.specs``."""
    return _zip_specs(lambda x, s: shard_leaf(x, s, mesh, rank), global_tree, specs)


def unshard_leaf(x, spec, dist):
    """The global leaf on every rank from each rank's shard `x`: an
    all-gather over each dim's axes (row-major over a tuple, as
    ``shard_bounds`` cuts). Every rank must call it."""
    for dim, e in enumerate(spec):
        if e is not None:
            x = dist.all_gather(x, e, dim=dim)
    return x


def gather_tree(rank_trees: List[Any], specs: Any, mesh) -> Any:
    """The inverse of ``shard_tree``: the global tree from every rank's
    shards (``rank_trees[r]`` is rank r's), each block written at its
    place; a replicated dim takes the copy of the lowest rank holding it."""

    def gather(spec, *shards):
        first = shards[0]
        shape = [n * (mesh.size(e) if e is not None else 1)
                 for n, e in zip(first.shape, tuple(spec) + (None,) * first.ndim)]
        if isinstance(first, torch.Tensor):
            out = torch.empty(shape, dtype=first.dtype, device=first.device)
        else:
            out = np.empty(shape, dtype=first.dtype)
        for r in reversed(range(len(shards))):
            bounds = shard_bounds(shape, spec, mesh, r)
            out[tuple(slice(lo, hi) for lo, hi in bounds)] = shards[r]
        return out

    def walk(specs, trees):
        if isinstance(specs, P):
            return gather(specs, *trees)
        if isinstance(specs, dict):
            return {k: walk(v, [t[k] for t in trees]) for k, v in specs.items()}
        return type(specs)(walk(s, [t[i] for t in trees]) for i, s in enumerate(specs))

    return walk(specs, rank_trees)
