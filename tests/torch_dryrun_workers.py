"""The two sides of the dry-run tests: a real step on gloo ranks on the CPU
(``real_step_counts``, a rank function for ``repro_torch.launch.serve.
spawn``), and the dry run of the same step in a process of its own (run
this file with a JSON list of cells; it prints one JSON list of records).
Imports torch, numpy and the port only (no JAX).

A cell: {"arch", "reduced" (bool), "shape": [name, seq_len, global_batch,
kind], "mesh": [data, model]}, and for the dry run "plan_overrides" (a dict,
optional).
"""
import dataclasses
import json
import sys

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.sharding.plans import make_plan
from repro_torch.sharding.counting import CountingDist
from repro_torch.training import optim

AXES = ("data", "model")


def cell_config(cell):
    cfg = get_arch(cell["arch"])
    return reduced_config(cfg) if cell.get("reduced") else cfg


def cell_shape(cell) -> ShapeCell:
    return ShapeCell(*cell["shape"])


def cell_step(cell, mesh, transport):
    """(step, plan) of a cell on this rank: ``steps.build_cell``'s, or with
    the cell's "plan_overrides" replacing fields of its plan."""
    cfg, shape = cell_config(cell), cell_shape(cell)
    if not cell.get("plan_overrides"):
        return steps.build_cell(cfg, shape, mesh, transport=transport)
    plan = dataclasses.replace(make_plan(cfg, shape, mesh.axes, mesh.shape),
                               **cell["plan_overrides"])
    return steps.build_step(cfg, shape, plan, mesh, transport=transport), plan


def step_args(step, cfg, shape, plan, mesh, device="cpu"):
    """The rank's arguments of a built step, on `device`: weights from seed
    0, tokens from numpy seed 0 (the rank's block of the same global
    array), caches at capacity."""
    params = steps.init_params(cfg, plan, mesh, seed=0, device=device)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, step.local_shapes["tokens"]))
    batch = {"tokens": tokens.to(device)}
    if shape.kind == "train":
        return params, optim.init_state(params), batch
    if shape.kind == "prefill":
        return params, batch
    enc = shape.seq_len if cfg.is_encoder_decoder else 0
    caches = M.init_cache(cfg, plan, batch=shape.global_batch, seq=shape.seq_len,
                          enc_seq=enc, device=device, mesh=mesh)
    return params, caches, batch["tokens"], shape.seq_len - 1


def real_step_counts(mesh, dist, dev, cells):
    """Every rank: each cell's step (``cell_step``) over the rank's
    transport, run once; the collectives counted as the dry run counts
    them. Returns the counts of each cell."""
    out = []
    for cell in cells:
        cfg, shape = cell_config(cell), cell_shape(cell)
        step, plan = cell_step(cell, mesh, dist.transport)
        counter = CountingDist(step.dist)
        args = step_args(step, cfg, shape, plan, mesh, device=dev)
        step(*args)
        out.append(counter.snapshot())
    return out


def _refuse(*args, **kwargs):
    raise AssertionError("a fake trace reached a plain kernel version")


def dry_runs(cells):
    """The dry run of each cell, with every plain kernel version replaced
    by one that raises. A cell with "bindings_as_aten" true is traced with the
    Tensor bindings run as aten ops, as on a build of torch without CUDA."""
    from repro_torch.kernels import ref
    from repro_torch.launch import dryrun
    for name in ("moe_gmm_ref", "flash_decode_ref", "flash_decode_lse_ref"):
        setattr(ref, name, _refuse)
    build_default, recs = dryrun._BINDINGS_AS_ATEN, []
    for c in cells:
        dryrun._BINDINGS_AS_ATEN = c.get("bindings_as_aten", build_default)
        recs.append(dryrun.dry_run(cell_config(c), cell_shape(c), c["mesh"], AXES,
                                   plan_overrides=c.get("plan_overrides")))
    return recs


if __name__ == "__main__":
    print(json.dumps(dry_runs(json.loads(sys.argv[1])), default=str))
