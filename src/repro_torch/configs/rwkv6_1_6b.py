"""rwkv6-1.6b [ssm] — Finch, data-dependent decay, attention-free.
[arXiv:2404.05892]

24L d_model=2048 (attn-free) d_ff=7168 vocab=65536
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, RwkvConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,            # 2048 / head_dim 64 WKV heads
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    attn_kind="none",
    period=(LayerSpec(mixer="rwkv", ffn="dense"),),
    rwkv=RwkvConfig(head_dim=64),
)
