"""Training driver: init -> (accumulate microbatches -> update) -> log /
checkpoint -> resume.

Port of ``repro.training.train_loop``. A step is
(params, optimizer state, batch) -> (params, optimizer state, loss): the
microbatches' gradients are summed in f32 and divided by their number,
reduced across ranks, then one AdamW update. Where JAX's jitted step
returns new trees, the port updates the parameters and the optimizer
state in place (see ``optim``).

Across ranks (a plan over more than one rank, and the rank's ``Dist``
on its mesh): the Trainer draws its shards of the global weights
(``steps.init_params``, FSDP included), takes the global batch and keeps
its block of each microbatch (the microbatch's rows split over the data
axes, its positions over the sequence axis), and reduces each gradient
over every mesh axis its spec does not shard (``steps.reduce_grads``);
with ``grad_compress`` the sum over the slowest data axis (pod, else
data) is ``compressed_psum`` with error feedback. The JAX Trainer sums
over the pod and data axes only: under the port's gradient convention
(``sharding.dist``) a leaf that the model axis does not shard also needs
its sum over model, which ``reduce_grads`` does. Checkpoints hold the
global tree (``checkpoint.save(specs=)``), written by rank 0, and
restore into any mesh's layout.

Fault-tolerance contract (``fault_tolerance`` drives it): checkpoints are
atomic and carry the step counter, which is also the data stream's
position, so a restart resumes the exact stream; a step that raises before
its update leaves no partial state.

The parameters are the port's per-layer lists, so checkpoints are not the
JAX trainer's (see ``checkpoint``). ``Trainer`` draws its own weights, or
takes ``params`` (for example ``convert.params_from_jax`` of the JAX
trainer's) and builds the optimizer state for them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import shard_leaf, tree_leaves, tree_map
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.models.layers.common import dtype_of
from repro_torch.models.transformer import sharded
from repro_torch.sharding.dist import Dist, NullDist
from repro_torch.sharding.plans import ShardingPlan, null_plan
from repro_torch.sharding.specs import P, param_specs, spec_leaves
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import compression, optim
from repro_torch.training.data import SyntheticLM


@dataclass
class TrainConfig:
    lr: float = 3e-4
    microbatches: int = 1          # gradient accumulation factor
    remat: bool = False
    grad_compress: bool = False    # int8 + error feedback on reduction axes
    log_every: int = 10
    ckpt_every: int = 0            # 0 = off
    ckpt_dir: str = ""
    ckpt_keep: int = 3
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig, *,
                 plan: Optional[ShardingPlan] = None,
                 dist: Optional[Dist] = None, params=None, device="cuda"):
        self.cfg = cfg
        self.tc = tc
        self.plan = plan or null_plan("train")
        self.dist = dist or NullDist()
        self.mesh = self.dist.mesh
        self.specs = None
        if sharded(self.plan):
            if self.mesh is None:
                raise ValueError("a plan over several ranks needs the rank's Dist "
                                 "on its mesh (Dist.for_mesh)")
            steps.check_train_plan(self.plan)
            self.specs = param_specs(cfg, self.plan)
        self.device = resolve_device(device)
        if params is None:
            if self.specs is not None:
                params = steps.init_params(cfg, self.plan, self.mesh, seed=tc.seed,
                                           device=self.device)
            else:
                params = M.init_model(cfg, self.plan, seed=tc.seed, device=self.device)
        self.params = params
        for p in tree_leaves(params):
            p.requires_grad_(True)
        self.opt_state = optim.init_state(self.params)
        # the residuals of the compressed reduction (unused on one device)
        self.err_state = (compression.init_error_state(self.params)
                          if tc.grad_compress else None)
        self.step_idx = 0
        self.losses: List[float] = []

    # ------------------------------------------------------------------

    def _shape_batch(self, tokens: np.ndarray) -> List[Dict[str, torch.Tensor]]:
        """tokens [B, S] (global) -> one batch dict per microbatch of B / mb
        rows, this rank's block of it, with zero patches or frames for a
        model with that frontend."""
        mb = self.tc.microbatches
        B, S = tokens.shape
        if B % mb:
            raise ValueError(f"batch {B} does not split into {mb} microbatches")
        dev, dt, cfg = self.device, dtype_of(self.cfg), self.cfg
        out = []
        for rows in np.split(tokens, mb):
            if self.specs is not None:
                rows = shard_leaf(rows, P(self.plan.batch_axes, self.plan.seq_axis),
                                  self.mesh)
            rows = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
            batch = {"tokens": rows}
            b, s = rows.shape
            if cfg.frontend == "vit_patches":
                batch["patches"] = torch.zeros(
                    (b, cfg.n_frontend_tokens, cfg.d_model), dtype=dt, device=dev)
            if cfg.frontend == "audio_frames":
                batch["frames"] = torch.zeros((b, s, cfg.d_model), dtype=dt, device=dev)
            out.append(batch)
        return out

    def grads(self, tokens: np.ndarray):
        """(mean loss, f32 gradients in ``tree_leaves(params)`` order): the
        microbatches' gradients summed in f32 and divided by their number,
        this rank's parts before the reduction across ranks."""
        leaves = tree_leaves(self.params)
        batches = self._shape_batch(tokens)
        acc, lsum = None, 0.0
        for batch in batches:
            loss = M.train_loss(self.params, batch, self.cfg, self.plan, self.dist,
                                remat=self.tc.remat, param_specs=self.specs)
            g = torch.autograd.grad(loss, leaves, materialize_grads=True)
            if acc is None:
                acc = [x.float() for x in g]
            else:
                for a, x in zip(acc, g):
                    a.add_(x)
            lsum = lsum + loss.detach()
            del g, loss
        n = len(batches)
        return lsum / n, [a.div_(n) for a in acc]

    def reduce(self, grads):
        """Sum the gradients across ranks (see the module docstring)."""
        if self.specs is None:
            return grads
        slow = None
        if self.tc.grad_compress:
            slow = next((a for a in self.plan.mesh_axes
                         if a in ("pod", "data") and self.dist.size(a) > 1), None)
        errs = tree_leaves(self.err_state) if slow else None
        grads = steps.reduce_grads(grads, spec_leaves(self.specs, self.params),
                                   self.plan, self.dist, compress_axis=slow, errs=errs)
        if slow:
            it = iter(errs)
            self.err_state = tree_map(lambda _: next(it), self.err_state)
        return grads

    def train_step(self, tokens: np.ndarray) -> float:
        loss, grads = self.grads(tokens)
        grads = self.reduce(grads)
        optim.update(self.params, grads, self.opt_state, lr=self.tc.lr)
        del grads
        self.step_idx += 1
        loss = float(loss)
        self.losses.append(loss)
        if self.tc.ckpt_every and self.step_idx % self.tc.ckpt_every == 0:
            self.save()
        return loss

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------

    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def _state_specs(self):
        if self.specs is None:
            return None
        return {"params": self.specs, "opt": optim.state_specs(self.specs)}

    def save(self):
        if not self.tc.ckpt_dir:
            raise ValueError("ckpt_dir not configured")
        ckpt.save(self._state_tree(), self.tc.ckpt_dir, self.step_idx,
                  specs=self._state_specs(), dist=self.dist)
        if self.mesh is None or self.mesh.rank == 0:
            ckpt.prune_old(self.tc.ckpt_dir, self.tc.ckpt_keep)

    def restore(self, step: Optional[int] = None) -> int:
        state, at = ckpt.restore(self._state_tree(), self.tc.ckpt_dir, step,
                                 specs=self._state_specs(), mesh=self.mesh)
        self.params, self.opt_state = state["params"], state["opt"]
        for p in tree_leaves(self.params):
            p.requires_grad_(True)
        self.step_idx = at
        return at

    def run(self, data: SyntheticLM, n_steps: int, *,
            log: Callable[[str], None] = print) -> List[float]:
        t0 = time.time()
        while self.step_idx < n_steps:
            tokens = data.batch(self.step_idx)
            loss = self.train_step(tokens)
            if self.tc.log_every and self.step_idx % self.tc.log_every == 0:
                dt = time.time() - t0
                log(f"step {self.step_idx:5d} loss {loss:.4f} "
                    f"({dt / max(self.step_idx, 1):.2f}s/step)")
        return self.losses
