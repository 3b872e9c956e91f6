"""seamless-m4t-medium [audio] — encoder-decoder, multimodal.
[arXiv:2308.11596]

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206

The audio frontend is a STUB: ``input_specs()`` supplies precomputed frame
embeddings [B, enc_len, d_model]. 12 encoder layers + 12 decoder layers with
cross-attention against the encoder output.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    period=(LayerSpec(mixer="attn", ffn="dense"),),
    encoder_layers=12,
    frontend="audio_frames",
)
