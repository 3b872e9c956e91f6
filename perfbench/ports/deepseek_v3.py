"""repro_torch's ModelConfig for a DeepSeek-V3 configuration file."""
from __future__ import annotations

from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

# the run values the port implements, for the keys it cannot vary
PORT_RUNS = {"first_k_dense_replace": 0, "scoring_func": "softmax",
             "topk_method": "greedy", "n_group": 1, "topk_group": 1,
             "routed_scaling_factor": 1.0, "rope_scaling": None,
             "num_nextn_predict_layers": 0, "hidden_act": "silu",
             "attention_bias": False, "norm_topk_prob": True, "moe_layer_freq": 1}


def model_config(run: dict, name: str = "deepseek-v3") -> ModelConfig:
    for key, want in PORT_RUNS.items():
        if run[key] != want:
            raise ValueError(f"{name}: repro_torch runs {key} = {want!r} only, "
                             f"the file runs {run[key]!r}")
    if run["qk_nope_head_dim"] != run["v_head_dim"]:
        raise ValueError(f"{name}: repro_torch's MLA has one head size for the "
                         "no-rope query/key part and the values")
    return ModelConfig(
        name=name, family="moe", num_layers=run["num_hidden_layers"],
        d_model=run["hidden_size"], num_heads=run["num_attention_heads"],
        num_kv_heads=run["num_key_value_heads"], d_ff=run["intermediate_size"],
        vocab_size=run["vocab_size"], d_head=run["qk_nope_head_dim"],
        attn_kind="mla", mla_kv_lora_rank=run["kv_lora_rank"],
        mla_q_lora_rank=run["q_lora_rank"], mla_rope_head_dim=run["qk_rope_head_dim"],
        period=(LayerSpec(mixer="attn", ffn="moe"),),
        moe=MoEConfig(num_experts=run["n_routed_experts"],
                      experts_per_token=run["num_experts_per_tok"],
                      d_expert=run["moe_intermediate_size"],
                      num_shared_experts=run["n_shared_experts"],
                      d_shared_expert=run["moe_intermediate_size"],
                      capacity_factor=run["capacity_factor"]),
        rope_theta=float(run["rope_theta"]), norm_eps=run["rms_norm_eps"],
        tie_embeddings=run["tie_word_embeddings"], dtype=run["dtype"])
