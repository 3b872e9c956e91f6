"""Sharded checkpointing with elastic restore.

Port of ``repro.training.checkpoint``, with the same layout (one directory
per step):

  ckpt_dir/step_000042/
    manifest.json                 {step, keys: {file, shape, dtype, shards, axis}}
    <key>.shard00.npy ...         a leaf split into K files along its
                                  longest axis when K divides it

Keys are the leaves' paths, "/"-joined: dict keys, list and tuple indices,
a named tuple's field names. The port's trees hold per-layer lists where
JAX's hold period-stacked leaves, so the keys differ from the JAX
package's; there is no loader across the two formats.

Restore is elastic: the shard files are put back together and each leaf
goes to the device of its counterpart in the target tree. Across ranks,
``save(..., specs=, dist=)`` gathers each leaf from the ranks' shards
(``convert.unshard_leaf``) and rank 0 writes it, so the files hold the
global tree whatever the mesh; ``restore(..., specs=, mesh=)`` cuts each
leaf to the rank's block of any mesh's layout (``convert.shard_leaf``), as
JAX's ``restore(shardings=)``. Without specs a tree is one device's.

Numpy has no bfloat16 or float8, and this module uses no ``ml_dtypes``:
such a leaf is written through a same-width integer view (bfloat16 as
uint16, float8 as uint8, JAX's wire format) and viewed back on restore.

Atomicity: a step is written to ``<dir>.tmp`` and renamed (POSIX-atomic),
so a failure mid-save never corrupts the latest checkpoint; ``latest_step``
reads completed directories only.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import shard_leaf, tree_map, unshard_leaf
from repro_torch.sharding.specs import spec_leaves

# dtypes numpy cannot hold -> (the integer view torch makes, numpy's view)
_EXOTIC = {
    "bfloat16": (torch.int16, np.uint16),
    "float8_e4m3fn": (torch.uint8, np.uint8),
    "float8_e5m2": (torch.uint8, np.uint8),
}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_wire(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    name = _dtype_name(t.dtype)
    if name in _EXOTIC:
        tview, nview = _EXOTIC[name]
        return t.view(tview).numpy().view(nview)
    return t.numpy()


def _from_wire(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _EXOTIC:
        tview, _ = _EXOTIC[dtype_name]
        t = torch.from_numpy(arr.view(_dtype_name(tview)))
        return t.view(getattr(torch, dtype_name))
    return torch.from_numpy(arr)


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf}, in ``tree_map``'s leaf order; the paths are the
    checkpoint's keys."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def save(tree, ckpt_dir: str, step: int, *, n_shards: int = 1, specs=None,
         dist=None) -> str:
    """Write `tree` (params / optimizer state: tensors) for `step`, each
    leaf split into `n_shards` files along its longest dim where that dim
    divides. With `specs` (the tree's spec tree) and `dist`, `tree` holds
    this rank's shards: every rank must call, each leaf is gathered to its
    global shape, and rank 0 writes."""
    final = os.path.join(ckpt_dir, f"step_{step:06d}")
    tmp = final + ".tmp"
    mesh = getattr(dist, "mesh", None)
    writer = mesh is None or mesh.rank == 0
    if writer:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
    leaf_specs = spec_leaves(specs, tree) if specs is not None else None

    manifest = {"step": step, "keys": {}}
    for i, (key, leaf) in enumerate(flatten(tree).items()):
        if leaf_specs is not None:
            leaf = unshard_leaf(leaf.detach(), leaf_specs[i], dist)
        if not writer:
            continue
        arr = _to_wire(leaf)
        fname = key.replace("/", ".")
        axis = int(np.argmax(arr.shape)) if arr.ndim else 0
        k = n_shards if (arr.ndim and arr.shape[axis] % n_shards == 0) else 1
        manifest["keys"][key] = {
            "file": fname, "shape": list(arr.shape),
            "dtype": _dtype_name(leaf.dtype), "shards": k, "axis": axis,
        }
        for j, piece in enumerate(np.split(arr, k, axis=axis) if k > 1 else [arr]):
            np.save(os.path.join(tmp, f"{fname}.shard{j:02d}.npy"), piece)
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    if mesh is not None:
        import torch.distributed as td
        td.barrier()
    return final


def _steps(ckpt_dir: str, complete: bool):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp")
                  and (not complete or os.path.exists(
                      os.path.join(ckpt_dir, d, "manifest.json"))))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir, complete=True)
    return steps[-1] if steps else None


def restore(like_tree, ckpt_dir: str, step: Optional[int] = None, *,
            specs=None, mesh=None) -> Tuple[Any, int]:
    """Restore into the structure of `like_tree` (a tree of tensors); each
    leaf takes the dtype and device of its counterpart there. With `specs`
    and `mesh`, `like_tree` holds one rank's shards of that layout, and
    each global leaf read is cut to the rank's block. Returns (tree,
    step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:06d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    flat_like = flatten(like_tree)
    unknown = [k for k in manifest["keys"] if k not in flat_like]
    missing = [k for k in flat_like if k not in manifest["keys"]]
    if unknown or missing:
        raise KeyError(f"checkpoint and target differ: not in the target "
                       f"{unknown[:5]}, not in the checkpoint {missing[:5]}")
    leaf_specs = (dict(zip(flat_like, spec_leaves(specs, like_tree)))
                  if specs is not None else {})
    loaded = {}
    for key, meta in manifest["keys"].items():
        pieces = [np.load(os.path.join(d, f"{meta['file']}.shard{i:02d}.npy"))
                  for i in range(meta["shards"])]
        arr = pieces[0] if len(pieces) == 1 else np.concatenate(pieces, axis=meta["axis"])
        if key in leaf_specs:
            arr = shard_leaf(arr, leaf_specs[key], mesh)
        want = flat_like[key]
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape}, target "
                             f"{tuple(want.shape)}")
        loaded[key] = _from_wire(arr, meta["dtype"]).to(
            device=want.device, dtype=want.dtype)
    leaves = iter(loaded[k] for k in flat_like)
    return tree_map(lambda _: next(leaves), like_tree), step


def prune_old(ckpt_dir: str, keep: int = 3):
    """Remove all but the newest `keep` checkpoints."""
    for s in _steps(ckpt_dir, complete=False)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:06d}"), ignore_errors=True)
