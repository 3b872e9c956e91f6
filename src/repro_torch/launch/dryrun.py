"""Dry run: what one rank's step costs, for every (arch x shape) cell on the
production mesh, without a card and without a process per rank.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.json]

Port of ``repro.launch.dryrun``. JAX lowers and compiles each cell on the
production mesh and reads XLA's cost and memory analyses and the
collectives of the compiled HLO. Torch has no such program, so this
module traces rank 0 of the mesh (16x16, or 2x16x16 with ``--multi-pod``)
in one process: ``torch.distributed``'s fake process group at the mesh's
world size stands in for the other ranks, every tensor is a fake CUDA
tensor (``FakeTensorMode``: shapes, no data, no card), and the step
``steps.build_step`` builds for the cell's plan runs once on the rank's
parameters, caches and batch. The record (``run_cell``) has JAX's keys:

  flops           ``torch.utils.flop_counter.FlopCounterMode`` (by op in
                  ``flops_by_op``); the hand kernels are custom ops with
                  their own flop formulas, and a fake trace never reaches
                  their plain versions
  bytes_accessed  the input and output bytes of every op that is not a
                  view (by op in ``bytes_by_op``), as ``_Traffic`` sees
                  them: eager PyTorch fuses nothing, so that is what the
                  step moves. An op that returns and writes no tensor
                  (``prim::device``, a size) reads metadata and is charged
                  nothing; ``_unsafe_view`` is a view that autograd does
                  not track. A gather
                  (``index``, ``gather`` ...) is charged the rows it reads,
                  and an in-place cache write (``index_put_``) the slice
                  it writes, not the cache, so ``bytes_accessed_inplace``
                  equals it and ``dus_overcount_bytes`` is 0
  mem_*           the arguments (parameters, caches, batch: their parts in
                  ``mem_argument_parts``), the outputs that are new tensors
                  (the caches are written in place), and the peak of the
                  live tensors the step made beyond its arguments
  collectives     "<kind>_bytes", "<kind>_count" and "total_bytes" of what
                  rank 0 sends, counted through the Dist's observer by
                  ``sharding.counting`` (the rule of ``chip_smoke.py``)

JAX's ``--unroll``, ``--unstack`` and ``collect_hlo`` have no counterpart:
eager PyTorch runs every layer, so every layer is counted, and the port's
caches are one tensor a layer, written in place, so no write is charged
for a whole stacked cache. ``analysis.hlo`` has no counterpart either: the
observer counts the collectives. ``--out`` is never a default: the
``results_dryrun_*.json`` files at the repository's root are the JAX dry
run's, read by ``benchmarks/roofline.py``.

The fake process group lives only inside ``dry_run``: it is destroyed
before the function returns, and a process that already has a process
group cannot dry-run.
"""
from __future__ import annotations

import argparse
import collections
import json
import time
import traceback
import weakref
from typing import Dict, Optional, Sequence

import torch

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, cell_applicable, get_arch
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.convert import tree_leaves, tree_map
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.layers.common import dtype_of
from repro_torch.sharding.counting import CountingDist
from repro_torch.sharding.plans import make_plan
from repro_torch.training import optim

FAKE_DEVICE = "cuda"
# ops that allocate without touching memory
_ALLOCS = ("aten::empty", "aten::empty_strided", "aten::empty_like", "aten::new_empty",
           "aten::new_empty_strided", "aten::scalar_tensor")
# gathers: charged the indices and the rows they read and write, not their source
_GATHERS = ("aten::index", "aten::index_select", "aten::gather", "aten::embedding")
# in-place writes of a slice: charged the indices and how often the values
# move (read, written; an add also reads the target's rows), not the target
_SLICE_WRITES = {"aten::index_put_": 2, "aten::_index_put_impl_": 2, "aten::index_copy_": 2,
                 "aten::index_add_": 3}
# views whose schema does not say so
_ALIASES = ("aten::_unsafe_view",)
# the Tensor bindings run as aten ops (``_FakeCardBindings``): on a build of
# torch without CUDA, whose bindings refuse a fake tensor on the card
_BINDINGS_AS_ATEN = not torch.backends.cuda.is_built()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _Traffic(torch.utils._python_dispatch.TorchDispatchMode):
    """Bytes every op that is not a view reads and writes, and the live
    bytes of the tensors ops make (their peak). Collectives are left to the
    Dist's observer."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.by_op = collections.Counter()
        self.live = 0
        self.peak = 0

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        if func.is_view or name in _ALIASES or func.namespace in ("c10d",
                                                                 "_c10d_functional"):
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if not outs and not func._schema.is_mutable:      # metadata: a device, a size
            return out
        seen = {id(t) for t in ins}
        fresh = [t for t in outs if id(t) not in seen]
        for t in fresh:
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        if name in _ALLOCS:
            return out
        rest = [t for t in ins[1:] if t is not ins[0]]
        if name in _GATHERS:
            moved = sum(map(_nbytes, rest)) + 2 * sum(map(_nbytes, outs))
        elif name in _SLICE_WRITES:
            moved = sum(map(_nbytes, rest[:-1])) + _SLICE_WRITES[name] * _nbytes(rest[-1])
        else:
            moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.bytes += moved
        self.by_op[name] += moved
        return out


def _index_parts(x, index):
    """(x sliced by the basic indices of `index`, the tensor indices for
    ``aten.index`` / ``aten.index_put_`` or None): Python indexing as
    ``torch.Tensor.__getitem__`` resolves it, ints, slices, None, Ellipsis
    and integer tensors."""
    index = index if isinstance(index, tuple) else (index,)
    n_dims = sum(1 for i in index if i is not None and i is not Ellipsis)
    out, dim, adv = x, 0, []
    for i in index:
        if i is Ellipsis:
            skip = x.dim() - n_dims
            adv += [None] * skip
            dim += skip
        elif i is None:
            out = torch.ops.aten.unsqueeze.default(out, dim)
            adv.append(None)
            dim += 1
        elif isinstance(i, slice):
            if i != slice(None):
                out = torch.ops.aten.slice.Tensor(out, dim, i.start, i.stop, i.step or 1)
            adv.append(None)
            dim += 1
        elif isinstance(i, torch.Tensor):
            adv.append(i)
            dim += 1
        else:
            out = torch.ops.aten.select.int(out, dim, int(i))
    if not any(t is not None for t in adv):
        return out, None
    return out, adv[:max(k for k, t in enumerate(adv) if t is not None) + 1]


class _FakeCardBindings(torch.overrides.TorchFunctionMode):
    """On a build of torch without CUDA, the Tensor methods whose Python
    bindings enter the card's device guard before they dispatch (indexing,
    ``copy_``, ``contiguous``, ``to`` ...), which that build refuses even
    for a fake tensor, run as their aten ops, which dispatch straight to
    the fake mode. ``x[index]`` and ``x[index] = v`` become basic-index
    views and ``aten.index`` / ``aten.index_put_`` (``_index_parts``); the
    other methods run as they are first and as their aten op after the
    guard's refusal, which comes before the op runs, so the op runs once.
    On a build with CUDA every binding runs as it is (``_BINDINGS_AS_ATEN``
    is False there; ``tests/test_torch_cuda_dryrun.py`` holds the rewrite
    to torch's own indexing)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _BINDINGS_AS_ATEN:
            return func(*args, **kwargs)
        if func is torch.Tensor.__getitem__:
            base, adv = _index_parts(*args)
            return base if adv is None else torch.ops.aten.index.Tensor(base, adv)
        if func is torch.Tensor.__setitem__:
            x, index, value = args
            base, adv = _index_parts(x, index)
            if not isinstance(value, torch.Tensor):
                value = torch.full((), value, dtype=x.dtype, device=x.device)
            elif value.dtype != x.dtype:
                value = torch.ops.aten._to_copy.default(value, dtype=x.dtype)
            if adv is None:
                torch.ops.aten.copy_.default(base, value)
            else:
                torch.ops.aten.index_put_(base, adv, value)
            return None
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:
            if "not linked with support for cuda" not in str(e):
                raise
        if func is torch.Tensor.to:
            device, dtype, _, _ = torch._C._nn._parse_to(*args[1:], **kwargs)
            x = args[0]
            # "cuda" names the card x is on, as torch's own ``to`` reads it
            same_device = device is None or (device.type == x.device.type and
                                             device.index in (None, x.device.index))
            if same_device and (dtype is None or dtype == x.dtype):
                return x
            return torch.ops.aten._to_copy.default(x, dtype=dtype or x.dtype,
                                                   device=device or x.device)
        return getattr(torch.ops.aten, func.__name__)(*args, **kwargs)


def _on_fake_card(tree):
    """Each fake tensor of `tree` as a fake tensor of the same shape and
    dtype on the card (a fake tensor holds no values to copy)."""
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device=FAKE_DEVICE)
                    if isinstance(x, torch.Tensor) else x, tree)


def _plan_record(plan) -> dict:
    return {"attn_mode": plan.attn_mode, "ep_axis": plan.ep_axis,
            "batch_axes": plan.batch_axes, "seq_axis": plan.seq_axis,
            "kv_axis": plan.kv_axis, "fsdp_axis": plan.fsdp_axis, "ffn_2d": plan.ffn_2d}


def _step_args(step, cfg: ModelConfig, shape: ShapeCell, plan, mesh, seed: int):
    """The rank's arguments of `step`, fake tensors on the card, and their
    bytes by part."""
    params = steps.init_params(cfg, plan, mesh, seed=seed, device="cpu")
    loc = step.local_shapes
    batch = {"tokens": torch.zeros(loc["tokens"], dtype=torch.int64)}
    for key in ("patches", "frames"):
        if key in loc:
            batch[key] = torch.zeros(loc[key], dtype=dtype_of(cfg))
    parts = {"params": params, "inputs": batch}
    if shape.kind == "train":
        parts["opt_state"] = optim.init_state(params)
        args = lambda p: (p["params"], p["opt_state"], p["inputs"])
    elif shape.kind == "prefill":
        args = lambda p: (p["params"], p["inputs"])
    else:
        enc = shape.seq_len if cfg.is_encoder_decoder else 0
        parts["caches"] = M.init_cache(cfg, plan, batch=shape.global_batch,
                                       seq=shape.seq_len, enc_seq=enc, device="cpu",
                                       mesh=mesh)
        args = lambda p: (p["params"], p["caches"], p["inputs"]["tokens"],
                          shape.seq_len - 1)
    parts = _on_fake_card(parts)
    sizes = {k: sum(_nbytes(t) for t in tree_leaves(v) if isinstance(t, torch.Tensor))
             for k, v in parts.items()}
    return args(parts), sizes


def dry_run(cfg: ModelConfig, shape: ShapeCell, mesh_shape: Sequence[int],
            axes: Sequence[str], *, fsdp: bool = True, plan_kw=None,
            plan_overrides=None, seed: int = 0) -> dict:
    """Trace rank 0's step of `cfg` at `shape` on a mesh of `mesh_shape`
    (axis names `axes`) and return its record (the module docstring).
    `plan_kw` goes to ``make_plan``; `plan_overrides` then replaces fields
    of the plan it made (JAX's ``dry_run`` argument)."""
    import dataclasses

    import torch.distributed as td
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils.flop_counter import FlopCounterMode

    if shape.kind == "train" and not torch.backends.cuda.is_built():
        raise RuntimeError("the dry run of a train cell needs a build of torch with "
                           "CUDA: the autograd engine keeps a stream per card, which a "
                           "build without CUDA refuses for fake tensors on the card")
    if td.is_initialized():
        raise RuntimeError("dry_run needs a process without a process group: it "
                           "makes a fake one")
    mesh = Mesh(mesh_shape, axes)
    t0 = time.perf_counter()
    td.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.n_ranks)
    try:
        mesh.build_groups()
        plan = make_plan(cfg, shape, mesh.axes, mesh.shape, fsdp=fsdp, **(plan_kw or {}))
        if plan_overrides:
            plan = dataclasses.replace(plan, **plan_overrides)
        step = steps.build_step(cfg, shape, plan, mesh, transport="fake")
        counter = CountingDist(step.dist)
        with FakeTensorMode():
            args, arg_bytes = _step_args(step, cfg, shape, plan, mesh, seed)
            traffic, flops = _Traffic(), FlopCounterMode(display=False)
            with flops, traffic, _FakeCardBindings():
                out = step(*args)
            arg_ids = {id(t) for t in _tensors(args)}
            out_bytes = sum(_nbytes(t) for t in _tensors(out) if id(t) not in arg_ids)
            del out
        trace_s = time.perf_counter() - t0
    finally:
        td.destroy_process_group()
    coll: Dict[str, float] = {}
    for kind, c in counter.snapshot().items():
        coll[f"{kind}_bytes"] = c["bytes"]
        coll[f"{kind}_count"] = c["calls"]
    coll["total_bytes"] = sum(c["bytes"] for c in counter.snapshot().values())
    return {
        "mesh": list(mesh.shape), "axes": list(mesh.axes), "n_devices": mesh.n_ranks,
        "plan": _plan_record(plan), "trace_s": trace_s,
        "flops": float(flops.get_total_flops()),
        "flops_by_op": {str(op): int(n) for op, n in
                        flops.get_flop_counts().get("Global", {}).items()},
        "bytes_accessed": float(traffic.bytes),
        "bytes_by_op": {op: n for op, n in traffic.by_op.items() if n},
        "bytes_accessed_inplace": float(traffic.bytes), "dus_overcount_bytes": 0.0,
        "mem_argument_size_in_bytes": sum(arg_bytes.values()),
        "mem_argument_parts": arg_bytes,
        "mem_output_size_in_bytes": out_bytes,
        "mem_temp_size_in_bytes": traffic.peak,
        "collectives": coll,
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False, fsdp: bool = True,
             plan_overrides=None, plan_kw=None) -> dict:
    """One cell of the production mesh: JAX's ``run_cell`` record."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped", "reason": why}
    mesh = make_production_mesh(multi_pod=multi_pod)
    res = dry_run(cfg, shape, mesh.shape, mesh.axes, fsdp=fsdp, plan_kw=plan_kw,
                  plan_overrides=plan_overrides)
    return {"arch": arch, "shape": shape_name, "status": "ok", **res}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    results = []
    for arch, shape in cells:
        print(f"=== {arch} x {shape} (multi_pod={args.multi_pod}) ===", flush=True)
        try:
            res = run_cell(arch, shape, multi_pod=args.multi_pod)
        except Exception as e:      # a cell that fails is recorded, never dropped
            res = {"arch": arch, "shape": shape, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        print(json.dumps({k: v for k, v in res.items() if k != "trace"}, default=str),
              flush=True)
        results.append(res)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1, default=str)

    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    n_err = len(results) - n_ok - n_skip
    print(f"DONE ok={n_ok} skipped={n_skip} errors={n_err}")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
