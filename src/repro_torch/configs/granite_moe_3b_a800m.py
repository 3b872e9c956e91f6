"""granite-moe-3b-a800m [moe] — 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base family]

32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8
(d_ff=512 is the per-expert hidden dim). 40 experts pad to 48 under EP=16.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    period=(LayerSpec(mixer="attn", ffn="moe"),),
    moe=MoEConfig(num_experts=40, experts_per_token=8, d_expert=512),
    rope_theta=10_000.0,
    tie_embeddings=True,
)
