"""XPU generation specs (paper section 3.2 setup + Table 5 scaling).

The paper bases its model on NVIDIA Hopper and projects Blackwell/Rubin with
the Table 5 multipliers. We add TPU v5e — the execution target of the JAX
half of this repo — parameterizing the same methodology (DESIGN.md section 3).

Layer: leaf data (no dependencies inside core); every engine reads the
same spec objects, so there is nothing parity-sensitive here.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class XPUSpec:
    name: str
    flops_fp8: float            # FLOP/s dense
    flops_bf16: float
    hbm_bw: float               # B/s
    hbm_cap: float              # bytes
    scale_up_bw: float          # B/s unidirectional per XPU (the "1x" provision)
    scale_out_bw: float         # B/s per XPU
    tdp_w: float
    cost_usd: float             # CapEx per XPU (catalog-ish; normalized in reports)


H100 = XPUSpec(
    name="H100",
    flops_fp8=1979e12,
    flops_bf16=989e12,
    hbm_bw=3.35e12,
    hbm_cap=80e9,
    scale_up_bw=450e9,
    scale_out_bw=50e9,
    tdp_w=700.0,
    cost_usd=30_000.0,
)

# Table 5 relative scaling vs Hopper (H100 = 1x)
BLACKWELL = XPUSpec(
    name="Blackwell",
    flops_fp8=1979e12 * 2.56,
    flops_bf16=989e12 * 2.56,
    hbm_bw=3.35e12 * 2.39,
    hbm_cap=80e9 * 2.33,
    scale_up_bw=900e9,          # 2.00x
    scale_out_bw=100e9,
    tdp_w=1000.0,
    cost_usd=40_000.0,
)

RUBIN = XPUSpec(
    name="Rubin",
    flops_fp8=1979e12 * 4.49,
    flops_bf16=989e12 * 4.49,
    hbm_bw=3.35e12 * 6.57,
    hbm_cap=80e9 * 3.60,
    scale_up_bw=1800e9,         # 4.00x
    scale_out_bw=200e9,
    tdp_w=1800.0,
    cost_usd=55_000.0,
)

TPU_V5E = XPUSpec(
    name="TPUv5e",
    flops_fp8=394e12,           # int8
    flops_bf16=197e12,
    hbm_bw=819e9,
    hbm_cap=16e9,
    scale_up_bw=200e9,          # 4 ICI links x ~50 GB/s (native 3D torus)
    scale_out_bw=25e9,
    tdp_w=220.0,
    cost_usd=5_000.0,
)

GENERATIONS = {g.name: g for g in (H100, BLACKWELL, RUBIN, TPU_V5E)}


def with_link_bw(spec: XPUSpec, scale_up_bw: float) -> XPUSpec:
    """Hypothetical link-bandwidth provision (the paper's BW sweeps)."""
    return replace(spec, scale_up_bw=scale_up_bw)
