"""Rank functions for the port's multi-rank training tests (gloo on the
CPU), run on every rank by ``repro_torch.launch.serve.spawn``. They import
torch, numpy and the port only (no JAX) and return numpy arrays; rank 0
returns the global (gathered) trees, the other ranks their losses only.
"""
import torch

from repro_torch.configs.base import ShapeCell
from repro_torch.convert import shard_leaf, shard_tree, tree_leaves, tree_map, unshard_leaf
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.sharding.plans import make_plan
from repro_torch.sharding.specs import P, param_specs, spec_leaves
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optim
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.train_loop import TrainConfig, Trainer


def _np(t):
    t = t.detach().cpu()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _gather(tree, specs, dist, mine: bool):
    """The global leaves of a sharded tree (``tree_leaves`` order), kept
    on rank 0 only (`mine`)."""
    out = []
    for leaf, spec in zip(tree_leaves(tree), spec_leaves(specs, tree)):
        full = unshard_leaf(leaf.detach(), spec, dist)
        out.append(_np(full) if mine else None)
    return out if mine else None


def train_jobs(mesh, dist, dev, jobs):
    """Each job: cfg, params (the global tree, CPU tensors), tokens [B, S]
    (numpy), optional frames [B, S, D] (numpy, an encoder-decoder's),
    plan_kw, and kind:
      "loss"    ``train_loss``'s forward on a plan without FSDP, called
                as the model function (no train step);
      "grads"   the train step's loss and reduced gradients, gathered;
      "update"  one whole train step (lr from the job), the updated
                parameters and moments gathered.
    Returns this rank's result per job."""
    results = []
    for job in jobs:
        cfg, tokens = job["cfg"], job["tokens"]
        B, S = tokens.shape
        cell = ShapeCell("t", S, B, "train")
        plan = make_plan(cfg, cell, mesh.axes, mesh.shape, **job.get("plan_kw", {}))
        mine = mesh.rank == 0
        if job["kind"] == "loss":
            specs = param_specs(cfg, plan)
            params = shard_tree(job["params"], specs, mesh)
            tok = torch.from_numpy(shard_leaf(tokens, P(plan.batch_axes, plan.seq_axis), mesh))
            with torch.no_grad():
                loss = M.train_loss(params, {"tokens": tok}, cfg, plan, dist, remat=False)
            results.append({"loss": float(loss), "plan": plan})
            continue
        step = steps.build_train_step(cfg, cell, plan, mesh, dist=dist,
                                      remat=job.get("remat", False), lr=job.get("lr", 3e-4))
        params = shard_tree(job["params"], step.param_specs, mesh)
        batch = {"tokens": torch.from_numpy(shard_leaf(tokens, step.in_specs["tokens"], mesh))}
        if job.get("frames") is not None:
            batch["frames"] = torch.from_numpy(shard_leaf(job["frames"],
                                                          step.in_specs["frames"], mesh))
        res = {"plan": plan}
        if job["kind"] == "grads":
            loss, grads = step.loss_and_grads(params, batch)
            grads = step.reduce(params, grads)
            full = [unshard_leaf(g, s, dist)
                    for g, s in zip(grads, spec_leaves(step.param_specs, params))]
            res["grads"] = [_np(g) for g in full] if mine else None
        else:
            opt = optim.init_state(params)
            params, opt, loss = step(params, opt, batch)
            res["params"] = _gather(params, step.param_specs, dist, mine)
            res["m"] = _gather(opt.m, step.param_specs, dist, mine)
            res["step"] = int(opt.step)
        res["loss"] = float(loss)
        results.append(res)
    return results


def trainer_learns(mesh, dist, dev, cfg, tc_kw, n_steps, batch, seq):
    """The ``Trainer`` on this rank of a data-parallel mesh: its losses
    over `n_steps` ``SyntheticLM`` batches."""
    plan = make_plan(cfg, ShapeCell("t", seq, batch, "train"), mesh.axes, mesh.shape)
    tr = Trainer(cfg, TrainConfig(**tc_kw), plan=plan, dist=dist, device="cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=0))
    return tr.run(data, n_steps, log=lambda s: None)


def trainer_steps(mesh, dist, dev, cfg, params, tc_kw, n_steps, batch, seq, plan_kw):
    """``Trainer`` steps on this rank from the global `params`: the losses,
    and on rank 0 the gathered parameters after the last step."""
    plan = make_plan(cfg, ShapeCell("t", seq, batch, "train"), mesh.axes, mesh.shape,
                     **plan_kw)
    mine = shard_tree(params, param_specs(cfg, plan), mesh)
    tr = Trainer(cfg, TrainConfig(**tc_kw), plan=plan, dist=dist, params=mine, device="cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=0))
    losses = tr.run(data, n_steps, log=lambda s: None)
    return {"losses": losses, "params": _gather(tr.params, tr.specs, dist, mesh.rank == 0)}


def save_sharded(mesh, dist, dev, cfg, ckpt_dir, batch, seq):
    """Draw this rank's shards from seed 0 (FSDP plan of this mesh), save
    the params sharded in `mesh.shape[-1]` files a leaf; returns the
    rank's shards."""
    plan = make_plan(cfg, ShapeCell("t", seq, batch, "train"), mesh.axes, mesh.shape)
    specs = param_specs(cfg, plan)
    params = steps.init_params(cfg, plan, mesh, seed=0, device="cpu")
    ckpt.save(params, ckpt_dir, 1, n_shards=mesh.shape[-1], specs=specs, dist=dist)
    return tree_map(_np, params)


def restore_sharded(mesh, dist, dev, cfg, ckpt_dir, tokens):
    """Restore the checkpoint into this mesh's FSDP layout (the target
    tree: this rank's zero shards) and run ``train_loss`` on `tokens`;
    returns the rank's shards, the step and the loss."""
    B, S = tokens.shape
    plan = make_plan(cfg, ShapeCell("t", S, B, "train"), mesh.axes, mesh.shape)
    specs = param_specs(cfg, plan)
    like = tree_map(torch.zeros_like, steps.init_params(cfg, plan, mesh, seed=1,
                                                          device="cpu"))
    params, at = ckpt.restore(like, ckpt_dir, specs=specs, mesh=mesh)
    tok = torch.from_numpy(shard_leaf(tokens, P(plan.batch_axes, plan.seq_axis), mesh))
    with torch.no_grad():
        loss = M.train_loss(params, {"tokens": tok}, cfg, plan, dist, remat=False,
                            param_specs=specs)
    return {"params": tree_map(_np, params), "step": at, "loss": float(loss)}


def in_order(mesh, dist, dev, calls):
    """Run each (function name of this module, args) on this rank, one
    after another on one set of rank processes; returns their results."""
    return [globals()[name](mesh, dist, dev, *args) for name, args in calls]
