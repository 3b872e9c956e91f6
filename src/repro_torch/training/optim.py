"""AdamW with float32 moments over possibly-bf16 parameters.

Port of ``repro.training.optim``, not ``torch.optim.AdamW``: the update is
computed in f32 and cast back to the parameter's dtype, the moments stay
f32 for bf16 parameters, and the weight decay sits inside ``delta``,
scaled by ``lr``, as in the JAX formula. The step count is int32 as JAX's;
``t`` and the bias corrections are f32. The moments carry their
parameters' specs (``state_specs``), so across ranks the update is local
to each rank's shards; the gradients are reduced before it
(``launch.steps.reduce_grads``).

Unlike the JAX function, ``update`` writes the new parameters and moments
into the tensors it is given (under ``torch.no_grad``), so a step holds no
second copy of the parameters or of the optimizer state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.convert import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    m: dict
    v: dict


def state_specs(param_specs) -> AdamWState:
    """The optimizer state's spec tree: the step replicated, the moments
    sharded as their parameters."""
    from repro_torch.sharding.specs import P
    return AdamWState(step=P(), m=param_specs, v=param_specs)


def init_state(params) -> AdamWState:
    """Zero f32 moments in the parameters' tree, on their devices."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaf = tree_leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=leaf.device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


@torch.no_grad()
def update(params, grads, state: AdamWState, *, lr=3e-4, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.1):
    """One AdamW step. `grads` is a list of f32 (or parameter-dtype)
    tensors in ``tree_leaves(params)`` order. Returns (params, state), the
    same tensors updated in place."""
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=t.device) ** t
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=t.device) ** t
    for p, g, m, v in zip(tree_leaves(params), grads, tree_leaves(state.m),
                          tree_leaves(state.v)):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        pf = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * pf
        p.copy_(pf - lr * delta)
    state.step.copy_(step)
    return params, state
