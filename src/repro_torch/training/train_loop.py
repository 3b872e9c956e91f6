"""Training driver: init -> (accumulate microbatches -> update) -> log /
checkpoint -> resume.

Port of ``repro.training.train_loop`` on one device. A step is
(params, optimizer state, batch) -> (params, optimizer state, loss): the
microbatches' gradients are summed in f32 and divided by their number, then
one AdamW update. Where JAX's jitted step returns new trees, the port
updates the parameters and the optimizer state in place (see ``optim``).

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
from repro_torch.convert import tree_leaves
from repro_torch.models import model as M
from repro_torch.models.layers.common import dtype_of
from repro_torch.sharding.dist import Dist, NullDist
from repro_torch.sharding.plans import ShardingPlan, null_plan
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
        if any(a in ("pod", "data") for a in self.plan.mesh_axes):
            raise NotImplementedError("gradient reduction across ranks comes with "
                                      "training across ranks (ROADMAP queue 1, "
                                      "item 5b)")
        self.device = resolve_device(device)
        if params is None:
            params = M.init_model(cfg, self.plan, seed=tc.seed, device=self.device)
        self.params = params
        for p in tree_leaves(params):
            p.requires_grad_(True)
        self.opt_state = optim.init_state(self.params)
        # no reduction axis on one device, so nothing feeds the residuals yet
        self.err_state = (compression.init_error_state(self.params)
                          if tc.grad_compress else None)
        self.step_idx = 0
        self.losses: List[float] = []

    # ------------------------------------------------------------------

    def _shape_batch(self, tokens: np.ndarray) -> List[Dict[str, torch.Tensor]]:
        """tokens [B, S] -> one batch dict per microbatch of B / mb rows,
        with zero patches or frames for a model with that frontend."""
        mb = self.tc.microbatches
        B, S = tokens.shape
        if B % mb:
            raise ValueError(f"batch {B} does not split into {mb} microbatches")
        dev, dt, cfg = self.device, dtype_of(self.cfg), self.cfg
        out = []
        for rows in torch.from_numpy(tokens).to(dev).chunk(mb):
            batch = {"tokens": rows}
            if cfg.frontend == "vit_patches":
                batch["patches"] = torch.zeros(
                    (B // mb, cfg.n_frontend_tokens, cfg.d_model), dtype=dt, device=dev)
            if cfg.frontend == "audio_frames":
                batch["frames"] = torch.zeros((B // mb, S, cfg.d_model), dtype=dt,
                                              device=dev)
            out.append(batch)
        return out

    def grads(self, tokens: np.ndarray):
        """(mean loss, f32 gradients in ``tree_leaves(params)`` order): the
        microbatches' gradients summed in f32 and divided by their number."""
        leaves = tree_leaves(self.params)
        batches = self._shape_batch(tokens)
        acc, lsum = None, 0.0
        for batch in batches:
            loss = M.train_loss(self.params, batch, self.cfg, self.plan, self.dist,
                                remat=self.tc.remat)
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

    def train_step(self, tokens: np.ndarray) -> float:
        loss, grads = self.grads(tokens)
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

    def save(self):
        if not self.tc.ckpt_dir:
            raise ValueError("ckpt_dir not configured")
        ckpt.save(self._state_tree(), self.tc.ckpt_dir, self.step_idx)
        ckpt.prune_old(self.tc.ckpt_dir, self.tc.ckpt_keep)

    def restore(self, step: Optional[int] = None) -> int:
        state, at = ckpt.restore(self._state_tree(), self.tc.ckpt_dir, step)
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
