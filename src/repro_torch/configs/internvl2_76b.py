"""internvl2-76b [vlm] — InternViT frontend (stub) + InternLM2-like backbone.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256  [arXiv:2404.16821]

The ViT frontend is a STUB per the assignment: ``input_specs()`` supplies
precomputed patch embeddings [B, n_patches, d_model]; the text tokens fill the
remainder of the sequence.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    period=(LayerSpec(mixer="attn", ffn="dense"),),
    frontend="vit_patches",
    n_frontend_tokens=256,
    rope_theta=1_000_000.0,
)
