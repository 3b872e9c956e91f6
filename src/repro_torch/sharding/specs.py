"""Partition specs of the port: which mesh axes shard each dim of a leaf.

The JAX package gets these from ``init_*`` (every init returns a
``(params, PartitionSpec tree)`` pair) and ``launch.steps.abstract_model``
/ ``abstract_cache``. The port's inits return params only, so the specs
are built here, leaf for leaf the same entries, in the port's layout: one
dict per layer in a list, not period-stacked. ``P`` holds one entry per
dim: None, an axis name, or a tuple of names (a 1-tuple is stored as its
name, as JAX stores it).

Covered: every layer the port runs (GQA attention, MLA, Mamba, RWKV's
time and channel mix, dense and MoE FFN, cross-attention), the encoder
stack, embedding and norm leaves of serving and training plans, and every
cache (GQA, MLA, Mamba, RWKV, the encoder's cross k, v). A training plan
with ``fsdp_axis`` extends each leaf's spec by ``common.fsdp_spec`` (JAX's
``init_layer`` / ``init_model`` do it leaf by leaf, from the global shapes
that ``param_shapes`` gives here).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.sharding.plans import VOCAB_PAD, ShardingPlan, pad_to


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


# the encoder's layer (JAX ``model.init_model``'s ``enc_period``)
ENCODER_PERIOD = (LayerSpec(mixer="attn", ffn="dense"),)


def is_mla(spec: LayerSpec, cfg: ModelConfig) -> bool:
    """True for an attention layer of an MLA config."""
    return spec.mixer in ("attn", "attn_local") and cfg.attn_kind == "mla"


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


def mla_specs(cfg: ModelConfig) -> dict:
    """MLA's weights are replicated under every plan (JAX's ``init_mla``)."""
    return {k: replicated(len(s)) for k, s in _mla_shapes(cfg).items()}


def mamba_specs(plan: ShardingPlan) -> dict:
    """d_inner over tp: the in projections and the conv by column, the
    out projection and the B, C, dt input projections by row (JAX's
    ``init_mamba``)."""
    tp = plan.tp_axis
    return {"w_x": P(None, tp), "w_z": P(None, tp), "conv_w": P(None, tp),
            "conv_b": P(tp), "w_bc": P(tp, None), "w_dt_in": P(tp, None),
            "w_dt": P(None, tp), "dt_bias": P(tp), "log_a": P(tp, None),
            "d_skip": P(tp), "w_out": P(tp, None)}


def rwkv_tm_specs(plan: ShardingPlan) -> dict:
    """The WKV heads over tp: ``w_r``, ``w_k``, ``w_v``, ``w_g`` and
    ``decay_lora_b`` by column, ``decay_base`` and ``bonus`` by channel,
    ``w_o`` by row; the mixes and ``decay_lora_a`` replicated (JAX's
    ``init_rwkv_tm``)."""
    tp = plan.tp_axis
    return {"mix": replicated(2), "w_r": P(None, tp), "w_k": P(None, tp),
            "w_v": P(None, tp), "w_g": P(None, tp), "decay_lora_a": replicated(2),
            "decay_lora_b": P(None, tp), "decay_base": P(tp), "bonus": P(tp),
            "w_o": P(tp, None)}


def rwkv_cm_specs(plan: ShardingPlan) -> dict:
    """d_ff over tp (JAX's ``init_rwkv_cm``)."""
    return {"mix": P(None), "w_in": P(None, plan.tp_axis),
            "w_out": P(plan.tp_axis, None)}


def mixer_specs(spec: LayerSpec, cfg: ModelConfig, plan: ShardingPlan) -> dict:
    if spec.mixer == "mamba":
        return mamba_specs(plan)
    if spec.mixer == "rwkv":
        return rwkv_tm_specs(plan)
    if is_mla(spec, cfg):
        return mla_specs(cfg)
    return attention_specs(plan)


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


def layer_specs(spec: LayerSpec, cfg: ModelConfig, plan: ShardingPlan, *,
                cross: bool = False) -> dict:
    """One layer's specs; with `cross`, its cross-attention sublayer
    (``norm_x``, and ``cross`` sharded as the self-attention weights)."""
    if spec.mixer == "rwkv":
        ffn = rwkv_cm_specs(plan)
    elif spec.ffn == "dense":
        ffn = dense_ffn_specs(plan)
    else:
        ffn = moe_specs(cfg, plan)
    out = {"norm1": norm_specs(), "mixer": mixer_specs(spec, cfg, plan)}
    if cross:
        out.update(norm_x=norm_specs(), cross=attention_specs(plan))
    out.update(norm2=norm_specs(), ffn=ffn)
    return out


def param_shapes(cfg: ModelConfig, plan: ShardingPlan) -> dict:
    """The global shape of every leaf of ``param_specs``' tree, as
    ``models.model.init_model`` draws it."""
    d, hd, v = cfg.d_model, cfg.head_dim, pad_to(cfg.vocab_size, VOCAB_PAD)
    embed = {"table": (v, d)}
    if not cfg.tie_embeddings:
        embed["head"] = (d, v)
    hh = cfg.num_heads * hd
    attn = {"w_q": (d, hh), "w_k": (d, cfg.num_kv_heads, hd),
            "w_v": (d, cfg.num_kv_heads, hd), "w_o": (hh, d)}
    dense = {"w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff), "w_out": (cfg.d_ff, d)}

    def layer(spec, cross):
        mixer, ffn = attn, dense
        if spec.mixer == "mamba":
            mixer = _mamba_shapes(cfg)
        elif spec.mixer == "rwkv":
            mixer, ffn = _rwkv_shapes(cfg)
        elif is_mla(spec, cfg):
            mixer = _mla_shapes(cfg)
        if spec.ffn == "moe" and spec.mixer != "rwkv":
            m = cfg.moe
            e, de = m.padded_num_experts(max(plan.ep, 1)), m.d_expert
            ffn = {"router": (d, e), "w_gate": (e, d, de), "w_up": (e, d, de),
                   "w_down": (e, de, d)}
            if m.num_shared_experts:
                dsh = m.d_shared_expert * m.num_shared_experts
                ffn.update(w_shared_gate=(d, dsh), w_shared_up=(d, dsh),
                           w_shared_down=(dsh, d))
        out = {"norm1": {"scale": (d,)}, "mixer": dict(mixer)}
        if cross:
            out.update(norm_x={"scale": (d,)}, cross=dict(attn))
        out.update(norm2={"scale": (d,)}, ffn=dict(ffn))
        return out

    cross = cfg.is_encoder_decoder
    out = {"embed": embed, "stack": [layer(s, cross) for s in cfg.layer_specs],
           "final_norm": {"scale": (d,)}}
    if cross:
        out["encoder"] = [layer(s, False) for s in encoder_specs(cfg)]
        out["enc_norm"] = {"scale": (d,)}
    return out


def encoder_specs(cfg: ModelConfig) -> tuple:
    """The layer specs of the encoder stack: ``cfg.encoder_layers`` of
    ``ENCODER_PERIOD``."""
    return ENCODER_PERIOD * cfg.encoder_layers


def _rwkv_shapes(cfg: ModelConfig):
    """(time-mix shapes, channel-mix shapes) of an RWKV layer."""
    d, dff = cfg.d_model, cfg.d_ff
    lora = max(32, d // 64)
    tm = {"mix": (4, d), "w_r": (d, d), "w_k": (d, d), "w_v": (d, d), "w_g": (d, d),
          "decay_lora_a": (d, lora), "decay_lora_b": (lora, d), "decay_base": (d,),
          "bonus": (d,), "w_o": (d, d)}
    return tm, {"mix": (d,), "w_in": (d, dff), "w_out": (dff, d)}


def _mla_shapes(cfg: ModelConfig) -> dict:
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    r, qr, rp = cfg.mla_kv_lora_rank, cfg.mla_q_lora_rank, cfg.mla_rope_head_dim
    return {"w_dq": (d, qr), "w_uq": (qr, H * (hd + rp)), "w_dkv": (d, r),
            "w_kr": (d, rp), "w_uk": (r, H * hd), "w_uv": (r, H * hd),
            "w_o": (H * hd, d), "q_norm": (qr,), "kv_norm": (r,)}


def _mamba_shapes(cfg: ModelConfig) -> dict:
    mc, d = cfg.mamba, cfg.d_model
    di, ds, dc = mc.expand * d, mc.d_state, mc.d_conv
    dtr = mc.dt_rank or -(-d // 16)
    return {"w_x": (d, di), "w_z": (d, di), "conv_w": (dc, di), "conv_b": (di,),
            "w_bc": (di, 2 * ds), "w_dt_in": (di, dtr), "w_dt": (dtr, di),
            "dt_bias": (di,), "log_a": (di, ds), "d_skip": (di,), "w_out": (di, d)}


def param_specs(cfg: ModelConfig, plan: ShardingPlan) -> dict:
    """The spec tree of ``models.model.init_model``'s params under `plan`:
    JAX's ``abstract_model(cfg, plan)[1]`` with the stack unstacked, FSDP
    included."""
    cross = cfg.is_encoder_decoder
    specs = {"embed": embedding_specs(cfg, plan),
             "stack": [layer_specs(s, cfg, plan, cross=cross) for s in cfg.layer_specs],
             "final_norm": norm_specs()}
    if cross:
        specs["encoder"] = [layer_specs(s, cfg, plan) for s in encoder_specs(cfg)]
        specs["enc_norm"] = norm_specs()
    if plan.fsdp_axis is None:
        return specs
    from repro_torch.models.layers.common import fsdp_spec

    def extend(spec, shape):
        if isinstance(spec, P):
            return fsdp_spec(shape, spec, plan)
        if isinstance(spec, dict):
            return {k: extend(v, shape[k]) for k, v in spec.items()}
        return [extend(a, b) for a, b in zip(spec, shape)]
    return extend(specs, param_shapes(cfg, plan))


def cache_specs(cfg: ModelConfig, plan: ShardingPlan, batch: int = 0,
                seq: int = 0) -> List[dict]:
    """The spec list of ``init_cache``'s caches under `plan`: JAX's
    ``abstract_cache(cfg, plan, batch, seq)[1]`` unstacked. Full-attention
    k, v are [B, KV, S, hd] over (batch axes, -, kv axis, -); a
    sliding-window ring is sharded over the batch only; Mamba's conv
    [B, dc - 1, di] and ssm [B, di, ds] over (batch axes, d_inner over
    tp); MLA's c_kv [B, S, r] and k_rope [B, S, rp] over the batch axes,
    replicated over model. Where the port departs from JAX: a prefill
    plan's MLA leaves are the positions of each rank of the kv axis (the
    prefill's own, which ``kvcache.pad_to_capacity`` gathers), over
    (batch axes, kv axis, -). JAX describes them as its decode layout,
    so that its sharded prefill keeps one rank's positions
    (ROADMAP queue 3)."""
    bax, tp = plan.batch_axes, plan.tp_axis
    kv = P(bax, None, plan.kv_axis, None)
    out = []
    for spec in cfg.layer_specs:
        if spec.mixer == "mamba":
            layer = {"mixer": {"conv": P(bax, None, tp), "ssm": P(bax, tp, None)}}
        elif spec.mixer == "rwkv":
            layer = {"mixer": {"wkv": P(bax, tp, None, None), "shift": P(bax, None)},
                     "ffn": {"shift": P(bax, None)}}
        elif is_mla(spec, cfg):
            s = P(bax, plan.kv_axis if plan.kind == "prefill" else None, None)
            layer = {"mixer": {"c_kv": s, "k_rope": s}}
        elif spec.mixer == "attn_local" and cfg.sliding_window:
            s = P(bax, None, None, None)
            layer = {"mixer": {"k": s, "v": s}}
        else:
            layer = {"mixer": {"k": kv, "v": kv}}
        if cfg.is_encoder_decoder:
            layer["cross"] = {"k": kv, "v": kv}
        out.append(layer)
    return out


def batch_specs(cfg: ModelConfig, kind: str, plan: ShardingPlan) -> Dict[str, P]:
    """Specs of one step's inputs: prefill tokens [B, S] over (batch axes,
    sequence axis); decode tokens [B, 1] over the batch axes; ViT patches
    [B, Pf, D] over the batch axes; audio frames [B, S, D] over (batch
    axes, sequence axis), as the tokens (JAX's ``batch_struct``)."""
    if kind in ("train", "prefill"):
        specs = {"tokens": P(plan.batch_axes, plan.seq_axis)}
        if cfg.frontend == "vit_patches":
            specs["patches"] = P(plan.batch_axes, None, None)
        if cfg.frontend == "audio_frames":
            specs["frames"] = P(plan.batch_axes, plan.seq_axis, None)
        return specs
    return {"tokens": P(plan.batch_axes, None)}


def spec_leaves(specs, like=None) -> list:
    """The ``P`` leaves of a spec tree (a ``P`` is a tuple, but a leaf
    here), in the leaf order of `like`: a tree of the same structure whose
    dicts may hold their keys in another order (default: the specs' own
    order). ``convert.tree_leaves(like)`` and this list then match."""
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        keys = specs.keys() if like is None else like.keys()
        return [leaf for k in keys
                for leaf in spec_leaves(specs[k], None if like is None else like[k])]
    return [leaf for i, v in enumerate(specs)
            for leaf in spec_leaves(v, None if like is None else like[i])]


def axes_of(spec: P) -> set:
    """The mesh axes that shard some dim of a leaf."""
    out = set()
    for e in spec:
        if e is not None:
            out.update(e if isinstance(e, tuple) else (e,))
    return out


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
