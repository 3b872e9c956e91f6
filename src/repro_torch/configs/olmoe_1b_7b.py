"""olmoe-1b-7b [moe] — 64 experts top-8.  [arXiv:2409.02060]

16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304, MoE 64e top-8
(d_ff=1024 is the per-expert hidden dim).
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    period=(LayerSpec(mixer="attn", ffn="moe"),),
    moe=MoEConfig(num_experts=64, experts_per_token=8, d_expert=1024),
    rope_theta=10_000.0,
)
