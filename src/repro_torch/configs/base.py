"""Config system: architecture + parallelism + shape cells.

The port's own copy of ``repro.configs.base`` (plain Python, no JAX), kept
field for field so that one config means the same model on both sides.
Every architecture is a ``ModelConfig`` built out of a periodic
``LayerSpec`` pattern (mixer kind x ffn kind); the port runs the stack as
a Python loop over ``cfg.layer_specs``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer pattern
# ---------------------------------------------------------------------------

MIXERS = ("attn", "attn_local", "mamba", "rwkv", "none")
FFNS = ("dense", "moe", "none")


@dataclass(frozen=True)
class LayerSpec:
    """One decoder layer = a sequence mixer + a token-wise FFN."""

    mixer: str = "attn"           # attn | attn_local | mamba | rwkv | none
    ffn: str = "dense"            # dense | moe | none

    def __post_init__(self):
        assert self.mixer in MIXERS, self.mixer
        assert self.ffn in FFNS, self.ffn


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int            # top-k
    d_expert: int                     # per-expert hidden dim
    num_shared_experts: int = 0
    d_shared_expert: int = 0
    capacity_factor: float = 1.5      # GShard-style static capacity
    router_aux_loss_coef: float = 0.01
    gated: bool = True                # SwiGLU experts

    def padded_num_experts(self, ep: int) -> int:
        """Experts padded up to a multiple of the EP group size."""
        return int(math.ceil(self.num_experts / ep) * ep)


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2                   # d_inner = expand * d_model
    dt_rank: int = 0                  # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class RwkvConfig:
    head_dim: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    d_head: int = 0                   # 0 -> d_model // num_heads
    # Layer pattern: repeated `period` of LayerSpecs; remainder unrolled.
    period: Tuple[LayerSpec, ...] = (LayerSpec(),)

    attn_kind: str = "gqa"            # gqa | mla | none
    rope_theta: float = 10_000.0
    sliding_window: int = 0           # for attn_local mixers
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RwkvConfig] = None

    # MLA (deepseek-v3 style latent attention)
    mla_kv_lora_rank: int = 0
    mla_q_lora_rank: int = 0
    mla_rope_head_dim: int = 0

    # encoder-decoder (seamless-m4t): encoder reuses the decoder LayerSpec
    # machinery with non-causal attention and no cache.
    encoder_layers: int = 0

    # modality frontend stub: input_specs() supplies precomputed embeddings.
    frontend: str = ""                # "" | "vit_patches" | "audio_frames"
    n_frontend_tokens: int = 0        # patches per image / audio frames

    dtype: str = "bfloat16"

    # ---------------- derived ----------------
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.num_heads, 1))

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        reps = self.num_layers // len(self.period)
        rem = self.num_layers % len(self.period)
        return tuple(self.period) * reps + tuple(self.period[:rem])

    @property
    def n_periods(self) -> int:
        return self.num_layers // len(self.period)

    @property
    def n_remainder(self) -> int:
        return self.num_layers % len(self.period)

    @property
    def has_attention(self) -> bool:
        return any(s.mixer in ("attn", "attn_local") for s in self.layer_specs)

    @property
    def full_attention_only(self) -> bool:
        """True when every mixer is dense full attention (no recurrence /
        window) -> long_500k is architecturally inapplicable."""
        mixers = {s.mixer for s in self.layer_specs if s.mixer != "none"}
        return mixers == {"attn"}

    def param_count(self) -> int:
        """Approximate parameter count (embedding + per-layer)."""
        d, hd = self.d_model, self.head_dim
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for spec in self.layer_specs:
            if spec.mixer == "attn" or spec.mixer == "attn_local":
                if self.attn_kind == "mla":
                    r, qr, rp = self.mla_kv_lora_rank, self.mla_q_lora_rank, self.mla_rope_head_dim
                    n += d * (r + rp) + r * self.num_heads * (hd + hd)
                    n += (d * qr + qr * self.num_heads * (hd + rp)) if qr else d * self.num_heads * (hd + rp)
                    n += self.num_heads * hd * d
                else:
                    n += d * self.num_heads * hd            # q
                    n += 2 * d * self.num_kv_heads * hd     # k, v
                    n += self.num_heads * hd * d            # o
            elif spec.mixer == "mamba":
                mc = self.mamba or MambaConfig()
                di = mc.expand * d
                dtr = mc.dt_rank or -(-d // 16)
                n += d * 2 * di                              # in_proj
                n += di * mc.d_conv                          # conv
                n += di * (dtr + 2 * mc.d_state) + dtr * di  # x_proj, dt_proj
                n += di * mc.d_state + di                    # A, D
                n += di * d                                  # out_proj
            elif spec.mixer == "rwkv":
                n += 4 * d * d + d * d                       # r,k,v,g,o  (+ decay small)
            if spec.ffn == "dense":
                n += 3 * d * self.d_ff                       # SwiGLU
            elif spec.ffn == "moe":
                m = self.moe
                n += d * m.num_experts                       # router
                n += m.num_experts * 3 * d * m.d_expert
                if m.num_shared_experts:
                    n += m.num_shared_experts * 3 * d * m.d_shared_expert
            n += 2 * d                                       # norms
        if self.encoder_layers:
            # encoder layers: self-attn + dense ffn; decoder adds cross-attn
            n += self.encoder_layers * (4 * d * self.num_heads * hd + 3 * d * self.d_ff)
            n += self.num_layers * (2 * d * self.num_kv_heads * hd + 2 * d * self.num_heads * hd)
        return int(n)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        total = self.param_count()
        n_moe_layers = sum(1 for s in self.layer_specs if s.ffn == "moe")
        all_experts = n_moe_layers * m.num_experts * 3 * self.d_model * m.d_expert
        active = n_moe_layers * m.experts_per_token * 3 * self.d_model * m.d_expert
        return int(total - all_experts + active)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention; skip pure full-attention archs
    (documented in DESIGN.md section 6)."""
    if shape.name == "long_500k" and cfg.full_attention_only:
        return False, "pure full-attention arch: 512k KV/step is architecturally inapplicable"
    return True, ""
