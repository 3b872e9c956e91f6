"""gemma3-1b [dense] — 5:1 local:global attention, 128k context.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144  [hf:google/gemma-3-1b-pt]

Pattern: 5 sliding-window (1024) layers then 1 global layer. 26 layers = 4
full periods + 2 remainder local layers. Sub-quadratic in the 5:1 sense:
long_500k runs with seq-sharded KV on the 4 global layers.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_PERIOD = tuple(
    LayerSpec(mixer="attn_local", ffn="dense") for _ in range(5)
) + (LayerSpec(mixer="attn", ffn="dense"),)

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    d_head=256,
    period=_PERIOD,
    sliding_window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
