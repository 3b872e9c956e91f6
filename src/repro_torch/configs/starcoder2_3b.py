"""starcoder2-3b [dense] — GQA, RoPE.  [arXiv:2402.19173; hf]

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    period=(LayerSpec(mixer="attn", ffn="dense"),),
    rope_theta=999_999.4,
)
