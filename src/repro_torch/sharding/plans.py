"""Sharding plans: how each (arch x shape x mesh) cell maps onto the mesh.

The port's own copy of ``repro.sharding.plans`` (plain Python, no JAX).
The single-device port runs under ``null_plan``; the multi-device plans
are kept so that every layer keeps its ``(plan, dist)`` signature.

Mesh axes:
  pod    — cross-pod data parallelism only (gradient all-reduce traffic;
           the paper's principle: keep A2A inside the high-bandwidth domain)
  data   — batch DP; FSDP shard axis in training; the decode A2A (EP) axis
  model  — the "scale-up domain": TP / sequence-parallel activations /
           train+prefill EP axis / decode KV-sequence sharding

Attention modes:
  head_tp    — q heads sharded over `model` (requires heads % tp == 0 and
               16 % kv_heads == 0 so each rank needs exactly one KV head),
               K/V weights replicated (small), Megatron-SP AG/RS schedule.
  replicated — attention weights replicated (only small archs), tokens stay
               sequence-sharded, K/V all-gathered for the core.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

from repro_torch.configs.base import ModelConfig, ShapeCell

AxesEntry = Union[str, Tuple[str, ...], None]

VOCAB_PAD = 256


def pad_to(n: int, mult: int) -> int:
    return (n + mult - 1) // mult * mult


@dataclass(frozen=True)
class ShardingPlan:
    mesh_axes: Tuple[str, ...]                 # ("data","model") | ("pod","data","model")
    mesh_shape: Tuple[int, ...]
    batch_axes: Optional[Tuple[str, ...]]      # batch sharding (None = replicated)
    seq_axis: Optional[str]                    # activation seq sharding (train/prefill)
    tp_axis: Optional[str]                     # tensor parallel axis
    ep_axis: Optional[str]                     # MoE all-to-all axis
    kv_axis: Optional[str]                     # decode KV-cache sequence sharding
    attn_mode: str                             # head_tp | replicated
    fsdp_axis: Optional[str]                   # training-only param sharding
    vocab_axis: Optional[AxesEntry]
    kind: str                                  # train | prefill | decode
    # decode-only: dense-FFN weights sharded over (data x model) with the
    # (cheap) decode tokens all-gathered over data — 16x less weight
    # streaming per device per step (EXPERIMENTS.md §Perf iteration 2)
    ffn_2d: bool = False
    # train/prefill: ring attention instead of Megatron-SP all-gather —
    # KV chunks rotate via collective_permute (EXPERIMENTS.md §Perf it. 3)
    ring_attn: bool = False
    # fp8(e4m3) wire format for the FFN sequence all-gather (§Perf it. 4)
    ag_fp8: bool = False
    # fp8 MoE dispatch A2A (bf16 combine) — DeepSeek-V3's production wire
    # format for the paper's central traffic (§Perf iteration 5)
    a2a_fp8: bool = False

    @property
    def ffn_axes(self):
        """Mesh axes the dense-FFN hidden dim is sharded over."""
        if self.ffn_2d:
            return ("data", "model")
        return self.tp_axis

    def axis_size(self, axis) -> int:
        if axis is None:
            return 1
        if isinstance(axis, tuple):
            n = 1
            for a in axis:
                n *= self.axis_size(a)
            return n
        return self.mesh_shape[self.mesh_axes.index(axis)]

    @property
    def tp(self) -> int:
        return self.axis_size(self.tp_axis)

    @property
    def ep(self) -> int:
        return self.axis_size(self.ep_axis)

    @property
    def dp(self) -> int:
        return self.axis_size(self.batch_axes) if self.batch_axes else 1


def head_tp_ok(cfg: ModelConfig, tp: int) -> bool:
    """Head-TP requires q heads divisible by tp and each rank's q-head group
    to map onto exactly one KV head (see DESIGN.md section 4)."""
    if not cfg.has_attention or cfg.attn_kind == "mla":
        return False
    if cfg.num_heads % tp != 0:
        return False
    h_loc = cfg.num_heads // tp
    g = cfg.num_heads // cfg.num_kv_heads      # q heads per kv head
    return g % h_loc == 0 or h_loc % g == 0 and cfg.num_kv_heads % tp == 0


def make_plan(cfg: ModelConfig, shape: ShapeCell,
              mesh_axes: Tuple[str, ...], mesh_shape: Tuple[int, ...],
              *, fsdp: bool = True, ffn_2d: bool = False,
              ring_attn: bool = False, ag_fp8: bool = False,
              a2a_fp8: bool = False) -> ShardingPlan:
    axes = dict(zip(mesh_axes, mesh_shape))
    tp = axes["model"]
    dp_axes = tuple(a for a in mesh_axes if a in ("pod", "data"))
    dp = 1
    for a in dp_axes:
        dp *= axes[a]

    attn_mode = "head_tp" if head_tp_ok(cfg, tp) else "replicated"

    if shape.kind in ("train", "prefill"):
        batch_axes = dp_axes if shape.global_batch % dp == 0 else None
        return ShardingPlan(
            mesh_axes=mesh_axes, mesh_shape=mesh_shape,
            batch_axes=batch_axes,
            seq_axis="model",
            tp_axis="model",
            ep_axis="model" if cfg.moe else None,
            kv_axis="model",          # prefill writes a seq-sharded cache
            attn_mode=attn_mode,
            fsdp_axis="data" if (fsdp and shape.kind == "train") else None,
            vocab_axis="model",
            kind=shape.kind,
            ring_attn=ring_attn,
            ag_fp8=ag_fp8,
            a2a_fp8=a2a_fp8,
        )

    # decode: batch over DP axes; KV sequence over model; EP A2A over data.
    batch_axes = dp_axes if shape.global_batch % dp == 0 else None
    ep_axis = None
    if cfg.moe:
        # faithful A2A path when tokens are batch-sharded; degenerate
        # replicated-token fallback (B=1 long-context) routes over model.
        ep_axis = "data" if (batch_axes and "data" in batch_axes) else "model"
    # ffn_2d requires tokens batch-sharded over data and d_ff/vocab
    # divisible by the full (data x model) product
    use_2d = (ffn_2d and batch_axes and "data" in batch_axes
              and cfg.d_ff % (axes.get("data", 1) * tp) == 0)
    return ShardingPlan(
        mesh_axes=mesh_axes, mesh_shape=mesh_shape,
        batch_axes=batch_axes,
        seq_axis=None,
        tp_axis="model",
        ep_axis=ep_axis,
        kv_axis="model",
        attn_mode=attn_mode,
        fsdp_axis=None,
        vocab_axis="model",
        kind="decode",
        ffn_2d=bool(use_2d),
        a2a_fp8=a2a_fp8,
    )


def null_plan(kind: str = "train") -> ShardingPlan:
    """Single-device plan (smoke tests, CPU serving example)."""
    return ShardingPlan(
        mesh_axes=(), mesh_shape=(), batch_axes=None, seq_axis=None,
        tp_axis=None, ep_axis=None, kv_axis=None, attn_mode="replicated",
        fsdp_axis=None, vocab_axis=None, kind=kind)
