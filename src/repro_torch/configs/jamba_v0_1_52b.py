"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536  [arXiv:2403.19887; hf]

Jamba block structure: period of 8 layers with one attention layer (position
4 of the block, per the released model) and MoE replacing the dense MLP on
every other layer (positions 1,3,5,7).
"""
from repro_torch.configs.base import LayerSpec, MambaConfig, ModelConfig, MoEConfig


def _spec(i: int) -> LayerSpec:
    mixer = "attn" if i == 4 else "mamba"
    ffn = "moe" if i % 2 == 1 else "dense"
    return LayerSpec(mixer=mixer, ffn=ffn)


CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    period=tuple(_spec(i) for i in range(8)),
    moe=MoEConfig(num_experts=16, experts_per_token=2, d_expert=14336),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    rope_theta=10_000.0,   # jamba attn layers use no RoPE in release; we keep RoPE for generality
)
