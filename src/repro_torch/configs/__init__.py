"""Architecture registry of the port: ``get_arch(name)`` resolves through
ARCHS, which holds the same eleven architectures as the JAX package's."""
import dataclasses

from repro_torch.configs.base import (
    LayerSpec,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    RwkvConfig,
    SHAPES,
    ShapeCell,
    cell_applicable,
)

from repro_torch.configs import (  # noqa: E402
    deepseek_67b,
    deepseek_v3,
    gemma3_1b,
    granite_moe_3b_a800m,
    internvl2_76b,
    jamba_v0_1_52b,
    minitron_8b,
    olmoe_1b_7b,
    rwkv6_1_6b,
    seamless_m4t_medium,
    starcoder2_3b,
)

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    olmoe_1b_7b, starcoder2_3b, granite_moe_3b_a800m, gemma3_1b, deepseek_v3,
    jamba_v0_1_52b, deepseek_67b, minitron_8b, rwkv6_1_6b, internvl2_76b,
    seamless_m4t_medium)}

# the dry run's architectures, in the JAX package's order (its ARCHS less
# the paper's own deepseek-v3)
ASSIGNED_ARCHS = ["jamba-v0.1-52b", "internvl2-76b", "starcoder2-3b", "minitron-8b",
                  "gemma3-1b", "deepseek-67b", "granite-moe-3b-a800m", "olmoe-1b-7b",
                  "rwkv6-1.6b", "seamless-m4t-medium"]


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Family-preserving smoke-test reduction: few layers, thin width, few
    experts, tiny vocab. Keeps the layer-pattern structure (>= one period).
    Same reduction as the JAX package's, so both sides build one model."""
    period = cfg.period
    n_layers = max(len(period), 2)
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, num_experts=min(moe.num_experts, 8), d_expert=64,
            d_shared_expert=64 if moe.num_shared_experts else 0)
    kw = dict(
        num_layers=n_layers,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        moe=moe,
        encoder_layers=2 if cfg.encoder_layers else 0,
        n_frontend_tokens=8 if cfg.frontend else 0,
        sliding_window=8 if cfg.sliding_window else 0,
    )
    if cfg.attn_kind == "mla":
        kw.update(mla_kv_lora_rank=32, mla_q_lora_rank=32, mla_rope_head_dim=8)
    kw.update(overrides)
    return cfg.replace(**kw)
