"""Layer stacks: a Python loop over layers.

Port of ``repro.models.transformer`` for the GQA ``attn`` and
``attn_local`` (sliding-window) mixers, MLA (``attn_kind == "mla"``), the
``mamba`` and ``rwkv`` mixers, with the ``moe`` and ``dense`` FFNs (an rwkv
layer's FFN is its channel mix), and the cross-attention sublayer of an
encoder-decoder's decoder. Where the JAX stack stores each period
position's parameters stacked over periods for ``lax.scan``, the port keeps
one dict per layer, in layer order (``convert`` unstacks JAX trees into
this layout). Layer = pre-norm mixer (+ pre-norm cross-attention) +
pre-norm FFN, residual around each. The encoder is a stack of
``ENCODER_PERIOD`` layers run in mode "train", as in JAX: so its attention
is causal and applies RoPE, like the decoder's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tracing
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers import common
from repro_torch.models.layers import mamba as mamba_mod
from repro_torch.models.layers import mla as mla_mod
from repro_torch.models.layers import moe as moe_mod
from repro_torch.models.layers import rwkv as rwkv_mod
from repro_torch.sharding.dist import Dist
from repro_torch.sharding.plans import ShardingPlan
from repro_torch.sharding.specs import ENCODER_PERIOD, is_mla  # noqa: F401


def sharded(plan: Optional[ShardingPlan]) -> bool:
    """True when `plan` splits the model over more than one rank."""
    return plan is not None and math.prod(plan.mesh_shape) > 1


def check_supported(spec: LayerSpec, cfg: ModelConfig):
    """Refuse, by name, a layer the port does not run: any GQA or MLA
    attention, Mamba or RWKV mixer with a dense or MoE FFN, on one device
    and under a sharded plan, with no frontend, ViT patches, or audio
    frames into an encoder."""
    attn_ok = spec.mixer in ("attn", "attn_local") and cfg.attn_kind in ("gqa", "mla")
    frontend_ok = cfg.frontend in ("", "vit_patches") or (
        cfg.frontend == "audio_frames" and cfg.is_encoder_decoder)
    if not (attn_ok or spec.mixer in ("mamba", "rwkv")) or spec.ffn == "none" \
            or not frontend_ok:
        raise NotImplementedError(
            f"layer {spec} of {cfg.name} is not ported yet (only GQA or MLA "
            "attn, attn_local, mamba and rwkv mixers with dense or moe FFNs; "
            "the vit_patches frontend, or audio frames into an encoder)")


def init_layer(spec: LayerSpec, cfg: ModelConfig, plan: ShardingPlan, gen, *,
               cross: bool = False):
    """One layer's params; with `cross`, a cross-attention sublayer
    (``norm_x``, ``cross``) between the mixer and the FFN."""
    check_supported(spec, cfg)
    dev = gen.device
    params: Dict[str, Any] = {
        "norm1": common.init_rms_norm(cfg.d_model, torch.float32, dev),
        "mixer": _init_mixer(spec, cfg, plan, gen),
    }
    if cross:
        params["norm_x"] = common.init_rms_norm(cfg.d_model, torch.float32, dev)
        params["cross"] = attn.init_attention(cfg, plan, gen)
    params["norm2"] = common.init_rms_norm(cfg.d_model, torch.float32, dev)
    if spec.mixer == "rwkv":
        params["ffn"] = rwkv_mod.init_rwkv_cm(cfg, plan, gen)
    elif spec.ffn == "dense":
        params["ffn"] = common.init_dense_ffn(cfg, plan, gen)
    else:
        params["ffn"] = moe_mod.init_moe(cfg, plan, gen)
    return params


def _init_mixer(spec: LayerSpec, cfg: ModelConfig, plan: ShardingPlan, gen):
    if spec.mixer == "mamba":
        return mamba_mod.init_mamba(cfg, plan, gen)
    if spec.mixer == "rwkv":
        return rwkv_mod.init_rwkv_tm(cfg, plan, gen)
    if is_mla(spec, cfg):
        return mla_mod.init_mla(cfg, plan, gen)
    return attn.init_attention(cfg, plan, gen)


def per_slot(pos) -> bool:
    """True when `pos` holds one position per batch row (engine decode)."""
    return torch.is_tensor(pos) and pos.dim() == 1


def apply_layer(spec: LayerSpec, p, x, cfg, plan: ShardingPlan, dist: Dist, *,
                mode: str, cache=None, pos=None, enc_len: int = 0, enc_out=None,
                collect_aux: bool = False, capacity_groups=None):
    """mode: train | prefill | decode. Returns (x, new_cache | None): the
    cache groups "mixer", "ffn" (rwkv's channel mix) and "cross" (the
    encoder's k, v, made in prefill from `enc_out`, read-only in decode over
    `enc_len` positions). Decode with per-slot positions gives each batch
    row its own MoE capacity group, as the JAX engine's vmap over slots
    does; `capacity_groups` overrides that rule (``moe.moe_ffn``). With
    `collect_aux`, (x, new_cache | None, aux): a MoE layer's load-balance
    loss, 0.0 for any other layer. The layer is ``layer_pre_ffn`` and then
    its FFN with the residual."""
    x, h, new_cache = layer_pre_ffn(spec, p, x, cfg, plan, dist, mode=mode,
                                    cache=cache, pos=pos, enc_len=enc_len,
                                    enc_out=enc_out)
    aux = 0.0
    make_cache = mode == "prefill"
    if spec.mixer == "rwkv":
        if mode == "decode":
            h, c = rwkv_mod.rwkv_cm_decode(p["ffn"], h, cache["ffn"], plan, dist)
        else:
            h, c = rwkv_mod.rwkv_cm_fwd(p["ffn"], h, plan, dist,
                                        make_cache=make_cache)
        if c is not None:
            new_cache["ffn"] = c
    elif spec.ffn == "dense":
        with tracing.span("ffn.dense"):
            h = common.dense_ffn(p["ffn"], h, plan, dist)
    else:
        groups = capacity_groups
        if groups is None:
            groups = x.shape[0] if mode == "decode" and per_slot(pos) else 1
        h = moe_mod.moe_ffn(p["ffn"], h, cfg, plan, dist,
                            capacity_groups=groups, collect_aux=collect_aux)
        if collect_aux:
            h, aux = h
    if collect_aux:
        return x + h, (new_cache or None), aux
    return x + h, (new_cache or None)


def has_expert_a2a(spec: LayerSpec) -> bool:
    """True for a layer whose FFN is the MoE layer (an RWKV layer's FFN is
    its channel mix): the layers whose all-to-alls a DBO step overlaps."""
    return spec.ffn == "moe" and spec.mixer != "rwkv"


def layer_pre_ffn(spec: LayerSpec, p, x, cfg, plan: ShardingPlan, dist: Dist, *,
                  mode: str, cache=None, pos=None, enc_len: int = 0, enc_out=None):
    """The part of ``apply_layer`` before the FFN: the pre-norm mixer and
    cross-attention, each with its residual, then ``norm2``. Returns (x,
    h = norm2(x), the new cache groups so far as a dict)."""
    check_supported(spec, cfg)
    new_cache: Dict[str, Any] = {}
    window = cfg.sliding_window if spec.mixer == "attn_local" else 0
    h = common.rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
    make_cache = mode == "prefill"
    if spec.mixer == "mamba":
        if mode == "decode":
            h, c = mamba_mod.mamba_decode(p["mixer"], h, cache["mixer"], cfg,
                                          plan, dist)
        else:
            h, c = mamba_mod.mamba_fwd(p["mixer"], h, cfg, plan, dist,
                                       make_cache=make_cache)
    elif spec.mixer == "rwkv":
        if mode == "decode":
            h, c = rwkv_mod.rwkv_tm_decode(p["mixer"], h, cache["mixer"], cfg,
                                           plan, dist)
        else:
            h, c = rwkv_mod.rwkv_tm_fwd(p["mixer"], h, cfg, plan, dist,
                                        make_cache=make_cache)
    elif is_mla(spec, cfg):
        if mode == "decode":
            h, c = mla_mod.mla_decode(p["mixer"], h, cache["mixer"], pos, cfg,
                                      plan, dist)
        else:
            h, c = mla_mod.mla_fwd(p["mixer"], h, cfg, plan, dist,
                                   make_cache=make_cache)
    elif mode == "decode":
        h, c = attn.attention_decode(p["mixer"], h, cache["mixer"], pos, cfg,
                                     plan, dist, window=window)
    else:
        h, c = attn.attention_fwd(p["mixer"], h, cfg, plan, dist,
                                  window=window, make_cache=make_cache)
    if c is not None:
        new_cache["mixer"] = c
    x = x + h

    if "cross" in p:
        h = common.rms_norm(x, p["norm_x"]["scale"], cfg.norm_eps)
        if mode == "decode":
            h = attn.cross_attention_decode(p["cross"], h, cache["cross"],
                                            enc_len, cfg, plan, dist)
            new_cache["cross"] = cache["cross"]         # read-only
        else:
            enc_kv = attn.make_enc_cache(p["cross"], enc_out, cfg, plan, dist)
            h = attn.cross_attention_fwd(p["cross"], h, enc_kv, cfg, plan, dist)
            if make_cache:
                new_cache["cross"] = enc_kv
        x = x + h
    return x, common.rms_norm(x, p["norm2"]["scale"], cfg.norm_eps), new_cache


def stack_specs(cfg: ModelConfig, n_layers: Optional[int] = None,
                period: Optional[Tuple[LayerSpec, ...]] = None):
    """The layer specs of a stack of `n_layers` (default: the config's)
    repeating `period` (default: the config's), remainder last."""
    period = period or cfg.period
    n_layers = cfg.num_layers if n_layers is None else n_layers
    reps, rem = divmod(n_layers, len(period))
    return tuple(period) * reps + tuple(period[:rem])


def init_stack(cfg: ModelConfig, plan: ShardingPlan, gen, *, cross: bool = False,
               n_layers: Optional[int] = None,
               period: Optional[Tuple[LayerSpec, ...]] = None,
               each=None) -> List[dict]:
    """One params dict per layer; `each(i, layer)`, when given, maps each
    layer as soon as it is drawn (a rank keeping only its shard)."""
    each = each or (lambda i, layer: layer)
    return [each(i, init_layer(spec, cfg, plan, gen, cross=cross))
            for i, spec in enumerate(stack_specs(cfg, n_layers, period))]


def apply_stack(params: List[dict], x, cfg: ModelConfig, plan: ShardingPlan,
                dist: Dist, *, mode: str, caches=None, pos=None,
                enc_len: int = 0, enc_out=None, collect_aux: bool = False,
                remat: bool = False, n_layers: Optional[int] = None,
                period: Optional[Tuple[LayerSpec, ...]] = None,
                capacity_groups=None, param_specs=None):
    """caches: per-layer list (decode) or None (train/prefill; prefill
    creates them). Returns (x, new_caches | None), or with `collect_aux`
    (x, new_caches | None, aux): the MoE layers' load-balance losses
    summed. `remat` recomputes each whole period's activations in the
    backward (``torch.utils.checkpoint``, as JAX checkpoints the scan body
    over periods); the remainder layers keep theirs, as in JAX. With
    `param_specs` (one spec dict per layer) on a plan with
    ``fsdp_axis``, each layer's FSDP shards are gathered just before it
    runs (``common.fsdp_gather``), inside the checkpointed period under
    `remat`, so that the backward gathers them again instead of keeping
    them (JAX gathers in the scan body)."""
    if remat and mode != "train":
        raise ValueError("remat recomputes training activations; it keeps no cache")
    specs = stack_specs(cfg, n_layers, period)
    n_pos = len(period or cfg.period)
    n_remat = len(specs) // n_pos * n_pos if remat else 0

    def run(lo, hi, x, aux):
        new = []
        for i in range(lo, hi):
            c_in = caches[i] if caches is not None else None
            p_i = params[i]
            if param_specs is not None:
                p_i = common.fsdp_gather(p_i, param_specs[i], plan, dist)
            x, c, a = apply_layer(specs[i], p_i, x, cfg, plan, dist,
                                  mode=mode, cache=c_in, pos=pos, enc_len=enc_len,
                                  enc_out=enc_out, collect_aux=True,
                                  capacity_groups=capacity_groups)
            aux = aux + a
            new.append(c)
        return x, aux, new

    aux, new_caches = 0.0, []
    for lo in range(0, n_remat, n_pos):
        x, aux = checkpoint(lambda x_, a_, lo=lo: run(lo, lo + n_pos, x_, a_)[:2],
                               x, aux, use_reentrant=False)
    x, aux, new_caches = run(n_remat, len(specs), x, aux)
    out = new_caches if mode in ("prefill", "decode") else None
    return (x, out, aux) if collect_aux else (x, out)
