"""deepseek-v3 — the paper's representative serving workload (671B).

61L d_model=7168, MLA (kv_lora 512, q_lora 1536, rope head 64), 128H hd=128,
MoE: 256 routed experts top-8 + 1 shared, d_expert=2048; first 3 layers dense
d_ff=18432. vocab=129280.  [arXiv:2412.19437]

The port's copy of the JAX package's config, field for field; the port
serves it at full width with the depth cut (one layer is ~11.5 B params).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

# period of 1 MoE layer; the 3 leading dense layers are approximated as MoE
# for stack uniformity, as in the JAX config (the analysis stack models
# them exactly).
CONFIG = ModelConfig(
    name="deepseek-v3",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    d_head=128,
    attn_kind="mla",
    mla_kv_lora_rank=512,
    mla_q_lora_rank=1536,
    mla_rope_head_dim=64,
    period=(LayerSpec(mixer="attn", ffn="moe"),),
    moe=MoEConfig(
        num_experts=256,
        experts_per_token=8,
        d_expert=2048,
        num_shared_experts=1,
        d_shared_expert=2048,
    ),
    rope_theta=10_000.0,
)
