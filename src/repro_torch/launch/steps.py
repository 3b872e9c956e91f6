"""Step builders: the model's prefill and decode bound to one rank.

Port of ``repro.launch.steps``. JAX wraps the manual-SPMD model functions
in ``shard_map`` and ``jit`` over global shapes and PartitionSpec trees;
here each rank is a process, so a step is the same model function called
on the rank's shards with the rank's ``Dist``, and a builder returns it
with the specs and the local shapes it expects. There is no jit and no AOT
lowering: PyTorch runs eagerly.

The train step (``build_train_step``) is the loss, its backward through
the Dist's differentiable collectives, ``reduce_grads`` (a psum of each
gradient over every mesh axis its spec does not shard: see
``sharding.dist`` for why that completes it) and one AdamW update of the
rank's shards, in place. JAX's step under ``check_vma=False`` transposes
the loss's psums to psums, so its gradients are not its own single
device's (ROADMAP queue 3); the port's are.

``init_params`` draws the global weights piece by piece from one seed,
the ranks one after another, and keeps this rank's shards, so every rank
(and a single device given the same seed) holds the same model, no rank
ever holds all of it, and ranks sharing a card hold one global piece at a
time between them.
``reshard`` moves a rank's shards from one spec tree to another (the
prefill plan puts the experts on ``model``, the decode plan on ``data``)
with point-to-point copies between the ranks that hold and need each
block.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.convert import shard_leaf, tree_leaves
from repro_torch.models import model as M
from repro_torch.models.layers import common
from repro_torch.serving import dbo
from repro_torch.sharding.dist import Dist, NullDist
from repro_torch.sharding.plans import ShardingPlan, make_plan
from repro_torch.sharding.specs import (P, axes_of, batch_specs, cache_specs,
                                        local_shape, param_specs, shard_bounds,
                                        shard_count, spec_leaves)
from repro_torch.training import compression, optim


def dist_for(mesh, transport: Optional[str]) -> Dist:
    """This rank's Dist on `mesh` (NullDist without one). The transport
    ("nccl" or "gloo") is the caller's choice: None raises on a mesh
    (``serve.default_transport`` is the launcher's rule)."""
    if mesh is None:
        return NullDist()
    return Dist.for_mesh(mesh, transport)


@dataclass
class Step:
    """A step bound to one rank: call it like the function it wraps."""
    fn: Callable
    dist: Dist
    plan: ShardingPlan
    param_specs: Any
    in_specs: Dict[str, P]
    cache_specs: Any = None
    local_shapes: Dict[str, tuple] = field(default_factory=dict)

    def __call__(self, *args, **kw):
        return self.fn(*args, **kw)


def batch_struct(cfg: ModelConfig, shape: ShapeCell, plan: ShardingPlan):
    """(global shapes, specs) of one step's inputs: the tokens, and in train
    and prefill the ViT patches or the audio frames [B, S, D] (in the
    model's dtype: one frame per token, as JAX's ``batch_struct``)."""
    B, S = shape.global_batch, shape.seq_len
    shapes = {"tokens": (B, S) if shape.kind in ("train", "prefill") else (B, 1)}
    if cfg.frontend == "vit_patches" and shape.kind != "decode":
        shapes["patches"] = (B, cfg.n_frontend_tokens, cfg.d_model)
    if cfg.frontend == "audio_frames" and shape.kind != "decode":
        shapes["frames"] = (B, S, cfg.d_model)
    return shapes, batch_specs(cfg, shape.kind, plan)


def _local(shapes, specs, mesh):
    if mesh is None:
        return dict(shapes)
    return {k: local_shape(v, specs[k], mesh) for k, v in shapes.items()}


def build_prefill(cfg: ModelConfig, shape: ShapeCell, plan: ShardingPlan,
                  mesh=None, *, dist: Optional[Dist] = None,
                  transport: Optional[str] = None, logits: bool = False) -> Step:
    """step(params, batch) -> (next_token [B_loc, 1], caches), on this
    rank's batch shard (tokens [B_loc, S_loc]), with the vocab-sharded f32
    logits of the last position third when `logits`."""
    dist = dist or dist_for(mesh, transport)
    shapes, specs = batch_struct(cfg, shape, plan)

    def step(params, batch):
        lg, caches = M.prefill_logits(params, batch, cfg, plan, dist)
        tok = common.greedy_sample(lg, cfg, plan, dist)
        return (tok, caches, lg) if logits else (tok, caches)

    return Step(step, dist, plan, param_specs(cfg, plan), specs,
                cache_specs(cfg, plan), _local(shapes, specs, mesh))


def build_decode_step(cfg: ModelConfig, shape: ShapeCell, plan: ShardingPlan,
                      mesh=None, *, dist: Optional[Dist] = None,
                      transport: Optional[str] = None, logits: bool = False) -> Step:
    """step(params, caches, tokens, pos) -> (next_token, caches), with the
    vocab-sharded f32 logits [B_loc, 1, V_loc] third when `logits`. Cache
    capacity = shape.seq_len, each rank holding its S / kv positions; the
    new token lands at the scalar `pos`. An encoder-decoder's
    cross-attention reads ``enc_len = shape.seq_len`` encoder positions:
    the whole zero-padded cross cache, as JAX's step does."""
    dist = dist or dist_for(mesh, transport)
    shapes, specs = batch_struct(cfg, shape, plan)
    cspecs = cache_specs(cfg, plan)
    # a full-attention layer's k or v
    shapes["cache"] = (shape.global_batch, cfg.num_kv_heads, shape.seq_len, cfg.head_dim)
    specs = dict(specs, cache=P(plan.batch_axes, None, plan.kv_axis, None))
    loc = _local(shapes, specs, mesh)
    enc_len = shape.seq_len if cfg.is_encoder_decoder else 0

    def step(params, caches, tokens, pos):
        lg, caches = M.decode_logits(params, caches, tokens, pos, cfg, plan, dist,
                                     enc_len=enc_len)
        tok = common.greedy_sample(lg, cfg, plan, dist)
        return (tok, caches, lg) if logits else (tok, caches)

    del specs["cache"]
    return Step(step, dist, plan, param_specs(cfg, plan), specs, cspecs, loc)


def build_dbo_decode_step(cfg: ModelConfig, shape: ShapeCell, plan: ShardingPlan,
                          mesh=None, *, dist: Optional[Dist] = None,
                          transport: Optional[str] = None, logits: bool = False) -> Step:
    """``serving.dbo.dbo_decode_step`` bound to this rank, as
    ``build_decode_step`` binds ``decode_logits``: step(params, caches_a,
    caches_b, tok_a, tok_b, pos) -> (next_a, next_b, caches_a, caches_b),
    with the two microbatches' vocab-sharded f32 logits [B_loc / 2, 1,
    V_loc] after them when `logits`. Each microbatch holds
    ``shape.global_batch // 2`` rows, sharded over the batch axes as the
    plain step's batch, with its own caches: the Step's specs and local
    shapes are those of the plain decode step at that batch, under `plan`.
    Refuses a batch whose halves do not split over the batch axes, and an
    encoder-decoder (the JAX step reads no encoder positions)."""
    B = shape.global_batch
    dp = 1 if mesh is None else shard_count(plan.batch_axes, mesh)
    if B % 2 or (B // 2) % dp:
        raise ValueError(f"DBO: a microbatch of {B} // 2 rows does not split over "
                         f"the batch axes {plan.batch_axes} ({dp} ranks)")
    if cfg.is_encoder_decoder:
        raise NotImplementedError("DBO: the encoder-decoder's cross-attention "
                                  "is not in the DBO step")
    half = build_decode_step(cfg, dataclasses.replace(shape, global_batch=B // 2),
                             plan, mesh, dist=dist, transport=transport)

    def step(params, caches_a, caches_b, tok_a, tok_b, pos):
        return dbo.dbo_decode_step(params, caches_a, caches_b, tok_a, tok_b, pos,
                                   cfg, plan, half.dist, logits=logits)

    return Step(step, half.dist, plan, half.param_specs, half.in_specs,
                half.cache_specs, half.local_shapes)


def reduce_grads(grads, leaf_specs, plan: ShardingPlan, dist: Dist, *,
                 compress_axis: Optional[str] = None, errs=None):
    """Sum each gradient (a list, as ``torch.autograd.grad`` gives them)
    over every mesh axis its spec (the matching entry of `leaf_specs`:
    ``specs.spec_leaves(param_specs, params)``) does not shard. With
    `compress_axis`, the sum over that axis is ``compressed_psum`` (int8,
    error feedback from `errs`, a list of residuals replaced in place).
    Returns the list of reduced gradients."""
    out = []
    with torch.no_grad():
        for i, (g, spec) in enumerate(zip(grads, leaf_specs)):
            named = axes_of(spec)
            for ax in plan.mesh_axes:
                if ax in named or dist.size(ax) == 1:
                    continue
                if ax == compress_axis:
                    g, errs[i] = compression.compressed_psum(g, ax, dist, errs[i])
                else:
                    g = dist.psum(g, ax)
            out.append(g)
    return out


@dataclass
class TrainStep(Step):
    """step(params, opt_state, batch) -> (params, opt_state, loss): the
    three parts below in a row, the update in place. `batch` holds this
    rank's block of the tokens ([B_loc, S_loc]); `opt_specs` is the
    optimizer state's spec tree."""
    cfg: Optional[ModelConfig] = None
    opt_specs: Any = None
    remat: bool = True
    lr: float = 3e-4

    def loss_and_grads(self, params, batch):
        """(loss, gradients of the rank's shards in ``tree_leaves`` order),
        before their reduction across ranks."""
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = M.train_loss(params, batch, self.cfg, self.plan, self.dist,
                            remat=self.remat, param_specs=self.param_specs)
        return loss.detach(), torch.autograd.grad(loss, leaves, materialize_grads=True)

    def reduce(self, params, grads):
        return reduce_grads(grads, spec_leaves(self.param_specs, params), self.plan,
                            self.dist)

    def update(self, params, grads, opt_state):
        return optim.update(params, grads, opt_state, lr=self.lr)

    def __call__(self, params, opt_state, batch):
        loss, grads = self.loss_and_grads(params, batch)
        grads = self.reduce(params, grads)
        params, opt_state = self.update(params, grads, opt_state)
        return params, opt_state, loss


def check_train_plan(plan: ShardingPlan):
    """A training plan must split the global batch over every data axis:
    ranks holding the same rows would each add the whole gradient."""
    dp = 1
    for ax, n in zip(plan.mesh_axes, plan.mesh_shape):
        if ax in ("pod", "data"):
            dp *= n
    if dp > 1 and plan.dp != dp:
        raise ValueError(f"the global batch must split over the data axes "
                         f"({dp} ranks); plan has batch_axes {plan.batch_axes}")


def build_train_step(cfg: ModelConfig, shape: ShapeCell, plan: ShardingPlan,
                     mesh=None, *, dist: Optional[Dist] = None,
                     transport: Optional[str] = None, remat: bool = True,
                     lr: float = 3e-4) -> TrainStep:
    """One training step on this rank (see ``TrainStep``), with its param
    specs (FSDP included on a plan with ``fsdp_axis``), the optimizer
    state's (``optim.state_specs``) and the local shape of the tokens."""
    check_train_plan(plan)
    dist = dist or dist_for(mesh, transport)
    shapes, specs = batch_struct(cfg, shape, plan)
    pspecs = param_specs(cfg, plan)
    return TrainStep(None, dist, plan, pspecs, specs, None, _local(shapes, specs, mesh),
                     cfg=cfg, opt_specs=optim.state_specs(pspecs), remat=remat, lr=lr)


def build_cell(cfg: ModelConfig, shape: ShapeCell, mesh, *, fsdp: bool = True,
               plan_kw=None, transport: str):
    """One cell on this rank: (step, plan), its collectives over
    `transport` ("nccl", "gloo", or "fake" for the dry run). `plan_kw`
    goes to ``make_plan``."""
    plan = make_plan(cfg, shape, mesh.axes, mesh.shape, fsdp=fsdp,
                     **(plan_kw or {}))
    return build_step(cfg, shape, plan, mesh, transport=transport), plan


def build_step(cfg: ModelConfig, shape: ShapeCell, plan: ShardingPlan, mesh, *,
               transport: str):
    """The step of `shape`'s kind (train, prefill or decode) under `plan`."""
    if shape.kind == "train":
        return build_train_step(cfg, shape, plan, mesh, transport=transport)
    build = build_prefill if shape.kind == "prefill" else build_decode_step
    return build(cfg, shape, plan, mesh, transport=transport)


# ---------------------------------------------------------------------------
# weights on ranks
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, plan: ShardingPlan, mesh, *, seed: int = 0,
                device="cuda"):
    """This rank's shards of ``M.init_model(cfg, plan, seed=seed)``: each
    piece (the embedding, a layer, a norm) is drawn at its global shape and
    cut at once. Under ``torch.distributed`` the ranks draw one after
    another, a barrier between turns, and a rank on a card hands the
    memory of its draw back before the next turn: ranks sharing a card
    never hold a global piece each at once (one deepseek-v3 layer is
    23 GB at its global shape)."""
    import torch.distributed as td
    specs = param_specs(cfg, plan)

    def cut(tree, spec):
        """`tree`'s shards; each global leaf is dropped from `tree` as soon
        as its block is copied out."""
        if isinstance(spec, P):
            return shard_leaf(tree, spec, mesh)
        return {k: cut(tree.pop(k), spec[k]) for k in list(tree)}

    def shard(path, tree):
        sub = specs
        for k in path:
            sub = sub[k]
        return cut(tree, sub)

    def draw():
        out = M.init_model(cfg, plan, seed=seed, device=device, shard=shard)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        return out

    if not (td.is_available() and td.is_initialized()):
        return draw()
    params = None
    for turn in range(mesh.n_ranks):
        if turn == mesh.rank:
            params = draw()
        td.barrier()
    return params


def _contains(outer, inner) -> bool:
    return all(o0 <= i0 and i1 <= o1 for (o0, o1), (i0, i1) in zip(outer, inner))


def _move(x, old: P, new: P, dist: Dist):
    """One leaf from spec `old` to spec `new`. Every rank computes the same
    plan: each rank's new block comes from itself when it holds it, else
    from the holder with the fewest sends so far."""
    if tuple(old) == tuple(new):
        return x
    mesh = dist.mesh
    pad = (None,) * x.dim()
    gshape = [n * shard_count(e, mesh) for n, e in zip(x.shape, tuple(old) + pad)]
    old_b = [shard_bounds(gshape, old, mesh, r) for r in range(mesh.n_ranks)]
    load = [0] * mesh.n_ranks
    src = []
    for r in range(mesh.n_ranks):
        need = shard_bounds(gshape, new, mesh, r)
        holders = [s for s in range(mesh.n_ranks) if _contains(old_b[s], need)]
        if not holders:
            raise NotImplementedError(f"reshard {old} -> {new}: no rank holds a "
                                      "whole new block")
        s = r if r in holders else min(holders, key=lambda h: (load[h], h))
        load[s] += s != r
        src.append((s, need))
    me = mesh.rank

    def mine(need):
        return x[tuple(slice(lo - o0, hi - o0)
                       for (lo, hi), (o0, _) in zip(need, old_b[me]))]

    sends = [(mine(need), r) for r, (s, need) in enumerate(src) if s == me and r != me]
    s, need = src[me]
    if s == me:
        out, recvs = mine(need).clone(), []
    else:
        out = torch.empty([hi - lo for lo, hi in need], dtype=x.dtype, device=x.device)
        recvs = [(out, s)]
    dist.exchange(sends, recvs)
    return out


def reshard(params, from_specs, to_specs, dist: Dist):
    """Move this rank's shards from `from_specs` to `to_specs`, leaf by
    leaf and in place (each old leaf is dropped as its new one arrives, so
    a rank holds one layout plus one leaf). Every rank must call it."""
    if isinstance(params, dict):
        for k in params:
            params[k] = reshard(params[k], from_specs[k], to_specs[k], dist)
        return params
    if isinstance(params, list):
        for i in range(len(params)):
            params[i] = reshard(params[i], from_specs[i], to_specs[i], dist)
        return params
    return _move(params, from_specs, to_specs, dist)
