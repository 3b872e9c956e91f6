"""Partition specs of the port: which mesh axes shard each dim of a leaf.

The JAX package gets these from ``init_*`` (every init returns a
``(params, PartitionSpec tree)`` pair) and ``launch.steps.abstract_model``
/ ``abstract_cache``. The port's inits return params only, so the specs
are built here, leaf for leaf the same entries, in the port's layout: one
dict per layer in a list, not period-stacked. ``P`` holds one entry per
dim: None, an axis name, or a tuple of names (a 1-tuple is stored as its
name, as JAX stores it).

Covered: the GQA attention, dense and MoE FFN, embedding and norm leaves
of serving plans, and the GQA caches. MLA, Mamba, RWKV and cross-attention
under a sharded plan come with the sharded mixers (ROADMAP queue 1, item
5c), FSDP specs with training across ranks (item 5b).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.sharding.plans import ShardingPlan


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        if not e:
            return None
        return e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """A partition spec: one mesh-axis entry per tensor dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def replicated(ndim: int) -> P:
    return P(*([None] * ndim))


def _refuse_sharded_mixer(spec: LayerSpec, cfg: ModelConfig):
    if spec.mixer not in ("attn", "attn_local") or cfg.attn_kind != "gqa":
        kind = "MLA" if cfg.attn_kind == "mla" else spec.mixer
        raise NotImplementedError(
            f"sharded {kind} layers of {cfg.name} come with the sharded "
            "mixers (ROADMAP queue 1, item 5c)")
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            "cross-attention under a sharded plan comes with the sharded "
            "mixers (ROADMAP queue 1, item 5c)")


def norm_specs() -> dict:
    return {"scale": P(None)}


def embedding_specs(cfg: ModelConfig, plan: ShardingPlan) -> dict:
    specs = {"table": P(plan.vocab_axis, None)}
    if not cfg.tie_embeddings:
        specs["head"] = P(None, plan.vocab_axis)
    return specs


def attention_specs(plan: ShardingPlan) -> dict:
    if plan.attn_mode == "head_tp":
        return {"w_q": P(None, plan.tp_axis), "w_k": replicated(3),
                "w_v": replicated(3), "w_o": P(plan.tp_axis, None)}
    return {"w_q": replicated(2), "w_k": replicated(3), "w_v": replicated(3),
            "w_o": replicated(2)}


def dense_ffn_specs(plan: ShardingPlan) -> dict:
    ax = plan.ffn_axes
    return {"w_gate": P(None, ax), "w_up": P(None, ax), "w_out": P(ax, None)}


def moe_specs(cfg: ModelConfig, plan: ShardingPlan) -> dict:
    ep = plan.ep_axis
    specs = {"router": replicated(2), "w_gate": P(ep, None, None),
             "w_up": P(ep, None, None), "w_down": P(ep, None, None)}
    if cfg.moe.num_shared_experts:
        specs.update(w_shared_gate=P(None, plan.tp_axis),
                     w_shared_up=P(None, plan.tp_axis),
                     w_shared_down=P(plan.tp_axis, None))
    return specs


def layer_specs(spec: LayerSpec, cfg: ModelConfig, plan: ShardingPlan) -> dict:
    _refuse_sharded_mixer(spec, cfg)
    ffn = dense_ffn_specs(plan) if spec.ffn == "dense" else moe_specs(cfg, plan)
    return {"norm1": norm_specs(), "mixer": attention_specs(plan),
            "norm2": norm_specs(), "ffn": ffn}


def param_specs(cfg: ModelConfig, plan: ShardingPlan) -> dict:
    """The spec tree of ``models.model.init_model``'s params under `plan`:
    JAX's ``abstract_model(cfg, plan)[1]`` with the stack unstacked."""
    if plan.fsdp_axis is not None:
        raise NotImplementedError("FSDP specs come with training across ranks "
                                  "(ROADMAP queue 1, item 5b)")
    return {"embed": embedding_specs(cfg, plan),
            "stack": [layer_specs(s, cfg, plan) for s in cfg.layer_specs],
            "final_norm": norm_specs()}


def cache_specs(cfg: ModelConfig, plan: ShardingPlan, batch: int = 0,
                seq: int = 0) -> List[dict]:
    """The spec list of ``init_cache``'s caches under `plan`: JAX's
    ``abstract_cache(cfg, plan, batch, seq)[1]`` unstacked. Full-attention
    k, v are [B, KV, S, hd] over (batch axes, -, kv axis, -); a
    sliding-window ring is sharded over the batch only."""
    bax = plan.batch_axes
    out = []
    for spec in cfg.layer_specs:
        _refuse_sharded_mixer(spec, cfg)
        if spec.mixer == "attn_local" and cfg.sliding_window:
            s = P(bax, None, None, None)
        else:
            s = P(bax, None, plan.kv_axis, None)
        out.append({"mixer": {"k": s, "v": s}})
    return out


def batch_specs(cfg: ModelConfig, kind: str, plan: ShardingPlan) -> Dict[str, P]:
    """Specs of one step's inputs: prefill tokens [B, S] over (batch axes,
    sequence axis); decode tokens [B, 1] over the batch axes; ViT patches
    [B, Pf, D] over the batch axes."""
    if kind in ("train", "prefill"):
        specs = {"tokens": P(plan.batch_axes, plan.seq_axis)}
        if cfg.frontend == "vit_patches":
            specs["patches"] = P(plan.batch_axes, None, None)
        return specs
    return {"tokens": P(plan.batch_axes, None)}


def shard_count(entry, mesh) -> int:
    if entry is None:
        return 1
    return mesh.size(entry)


def local_shape(shape, spec: P, mesh) -> tuple:
    """The shape of one rank's shard of a leaf of global `shape`."""
    out = []
    for n, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        k = shard_count(e, mesh)
        if n % k:
            raise ValueError(f"dim of {n} does not split {k} ways over {e!r}")
        out.append(n // k)
    return tuple(out)


def shard_bounds(shape, spec: P, mesh, rank=None):
    """[(start, stop)] per dim of `rank`'s block of a leaf of global
    `shape` (default: the mesh's own rank)."""
    out = []
    for n, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        k = shard_count(e, mesh)
        i = mesh.index(e, rank) if e is not None else 0
        out.append((i * n // k, (i + 1) * n // k))
    return out
