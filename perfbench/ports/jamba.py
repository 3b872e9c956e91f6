"""repro_torch's ModelConfig for a Jamba configuration file."""
from __future__ import annotations

import math

from repro_torch.configs.base import LayerSpec, MambaConfig, ModelConfig, MoEConfig


def period(run: dict) -> tuple:
    """The layer pattern over one period: attention every
    ``attn_layer_period`` layers at ``attn_layer_offset``, Mamba elsewhere;
    experts every ``expert_layer_period`` at ``expert_layer_offset``, a
    dense FFN elsewhere."""
    n = math.lcm(run["attn_layer_period"], run["expert_layer_period"])
    return tuple(LayerSpec(
        mixer="attn" if i % run["attn_layer_period"] == run["attn_layer_offset"] else "mamba",
        ffn="moe" if i % run["expert_layer_period"] == run["expert_layer_offset"] else "dense")
        for i in range(n))


def model_config(run: dict, name: str = "ai21-jamba2-mini") -> ModelConfig:
    if run["hidden_act"] != "silu" or run["mamba_proj_bias"] or not run["mamba_conv_bias"]:
        raise ValueError(f"{name}: repro_torch's Mamba block has SiLU, a conv bias "
                         "and no projection bias")
    if run["sliding_window"] is not None:
        raise ValueError(f"{name}: repro_torch's jamba attention has no window")
    return ModelConfig(
        name=name, family="hybrid", num_layers=run["num_hidden_layers"],
        d_model=run["hidden_size"], num_heads=run["num_attention_heads"],
        num_kv_heads=run["num_key_value_heads"], d_ff=run["intermediate_size"],
        vocab_size=run["vocab_size"], period=period(run),
        moe=MoEConfig(num_experts=run["num_experts"],
                      experts_per_token=run["num_experts_per_tok"],
                      d_expert=run["intermediate_size"],
                      capacity_factor=run["capacity_factor"]),
        mamba=MambaConfig(d_state=run["mamba_d_state"], d_conv=run["mamba_d_conv"],
                          expand=run["mamba_expand"], dt_rank=run["mamba_dt_rank"]),
        rope_theta=float(run["rope_theta"]), norm_eps=run["rms_norm_eps"],
        tie_embeddings=run["tie_word_embeddings"], dtype=run["dtype"])
