"""Decoder stack: a Python loop over layers.

Port of ``repro.models.transformer`` for the GQA ``attn`` and
``attn_local`` (sliding-window) mixers, MLA (``attn_kind == "mla"``) and
the ``mamba`` mixer, with the ``moe`` and ``dense`` FFNs. Where the JAX
stack stores each period position's parameters stacked over periods for
``lax.scan``, the port keeps one dict per layer, in layer order
(``convert`` unstacks JAX trees into this layout). Layer = pre-norm
mixer + pre-norm FFN, residual around each.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers import common
from repro_torch.models.layers import mamba as mamba_mod
from repro_torch.models.layers import mla as mla_mod
from repro_torch.models.layers import moe as moe_mod
from repro_torch.sharding.dist import Dist
from repro_torch.sharding.plans import ShardingPlan


def check_supported(spec: LayerSpec, cfg: ModelConfig):
    attn_ok = spec.mixer in ("attn", "attn_local") and cfg.attn_kind in ("gqa", "mla")
    if not (attn_ok or spec.mixer == "mamba") or spec.ffn == "none" \
            or cfg.is_encoder_decoder or cfg.frontend:
        raise NotImplementedError(
            f"layer {spec} of {cfg.name} is not ported yet (only GQA or MLA "
            "attn, attn_local and mamba mixers with dense or moe FFNs, "
            "decoder-only, no frontend)")


def _is_mla(spec: LayerSpec, cfg: ModelConfig) -> bool:
    return spec.mixer in ("attn", "attn_local") and cfg.attn_kind == "mla"


def init_layer(spec: LayerSpec, cfg: ModelConfig, plan: ShardingPlan, gen):
    check_supported(spec, cfg)
    dev = gen.device
    params: Dict[str, Any] = {
        "norm1": common.init_rms_norm(cfg.d_model, torch.float32, dev),
        "mixer": _init_mixer(spec, cfg, plan, gen),
        "norm2": common.init_rms_norm(cfg.d_model, torch.float32, dev),
    }
    if spec.ffn == "dense":
        params["ffn"] = common.init_dense_ffn(cfg, plan, gen)
    else:
        params["ffn"] = moe_mod.init_moe(cfg, plan, gen)
    return params


def _init_mixer(spec: LayerSpec, cfg: ModelConfig, plan: ShardingPlan, gen):
    if spec.mixer == "mamba":
        return mamba_mod.init_mamba(cfg, plan, gen)
    if _is_mla(spec, cfg):
        return mla_mod.init_mla(cfg, plan, gen)
    return attn.init_attention(cfg, plan, gen)


def per_slot(pos) -> bool:
    """True when `pos` holds one position per batch row (engine decode)."""
    return torch.is_tensor(pos) and pos.dim() == 1


def apply_layer(spec: LayerSpec, p, x, cfg, plan: ShardingPlan, dist: Dist, *,
                mode: str, cache=None, pos=None):
    """mode: train | prefill | decode. Returns (x, new_cache | None).
    Decode with per-slot positions gives each batch row its own MoE
    capacity group, as the JAX engine's vmap over slots does."""
    check_supported(spec, cfg)
    new_cache = None
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
    elif _is_mla(spec, cfg):
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
        new_cache = {"mixer": c}
    x = x + h

    h = common.rms_norm(x, p["norm2"]["scale"], cfg.norm_eps)
    if spec.ffn == "dense":
        h = common.dense_ffn(p["ffn"], h, plan, dist)
    else:
        groups = x.shape[0] if mode == "decode" and per_slot(pos) else 1
        h = moe_mod.moe_ffn(p["ffn"], h, cfg, plan, dist,
                            capacity_groups=groups)
    return x + h, new_cache


def init_stack(cfg: ModelConfig, plan: ShardingPlan, gen) -> List[dict]:
    return [init_layer(spec, cfg, plan, gen) for spec in cfg.layer_specs]


def apply_stack(params: List[dict], x, cfg: ModelConfig, plan: ShardingPlan,
                dist: Dist, *, mode: str, caches=None, pos=None):
    """caches: per-layer list (decode) or None (train/prefill; prefill
    creates them). Returns (x, new_caches | None)."""
    new_caches = []
    for i, spec in enumerate(cfg.layer_specs):
        c_in = caches[i] if caches is not None else None
        x, c = apply_layer(spec, params[i], x, cfg, plan, dist, mode=mode,
                           cache=c_in, pos=pos)
        new_caches.append(c)
    return x, (new_caches if mode in ("prefill", "decode") else None)
