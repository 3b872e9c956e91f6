"""Per-layer compute-time estimation (paper section 3.2.3).

The paper profiles kernels on a real H100 (Vidur-style). Without GPU access
(DESIGN.md section 7), we use a roofline-with-efficiency model:

  t = max(flops / (peak * eff_c(op)),  bytes / (hbm_bw * eff_m)) + t_launch

with per-op-class compute efficiencies and a small fixed launch cost. The
efficiency constants are calibrated so DeepSeek-V3 decode TPOT/throughput
lands in the envelope of the public SGLang 96xH100 report the paper itself
validates against (benchmarks/validation.py cross-checks this).

Layer: leaf constants + the roofline formula, shared verbatim by the
scalar timers (`core.workload` op lists), the batched NumPy engine
(`sweep.GridEval._durations`), and the jax kernels (`sweep_jax`) — the
1e-9 scalar/batched parity contract holds because all three apply THESE
constants with the same associations.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

from repro_torch.core.hardware import XPUSpec

# calibrated efficiencies (fraction of peak). The paper profiles real H100
# kernels; these constants are calibrated against the public SGLang
# DeepSeek-V3 96xH100 decode trace (benchmarks/validation.py): decode-batch
# GEMMs run well below peak, KV/weight streaming below STREAM bandwidth.
EFF_COMPUTE = {
    "gemm": 0.55,          # large matmuls on tensor cores / MXU
    "gemm_small": 0.27,    # thin matmuls (decode projections at small batch)
    "attn": 0.42,          # attention core math
    "other": 0.25,
}
EFF_MEMORY = 0.58          # achievable fraction of HBM bandwidth
T_LAUNCH = 2.0e-6          # CUDA-graph/fused-step per-kernel overhead
GEMM_SMALL_TOKENS = 128    # below this many rows a GEMM is 'thin'


@dataclass(frozen=True)
class Op:
    """One compute or communication operation of an iteration."""
    name: str
    kind: str               # compute | a2a | ar
    flops: float = 0.0
    bytes: float = 0.0
    op_class: str = "gemm"
    m_bytes: float = 0.0    # payload for comm ops
    group: int = 0          # AR group size


def compute_time(op: Op, xpu: XPUSpec, *, rows: float = 1e9,
                 fp8: bool = False) -> float:
    peak = xpu.flops_fp8 if fp8 else xpu.flops_bf16
    cls = op.op_class
    if cls == "gemm" and rows < GEMM_SMALL_TOKENS:
        cls = "gemm_small"
    eff = EFF_COMPUTE.get(cls, EFF_COMPUTE["other"])
    t_c = op.flops / (peak * eff) if op.flops else 0.0
    t_m = op.bytes / (xpu.hbm_bw * EFF_MEMORY) if op.bytes else 0.0
    return max(t_c, t_m) + T_LAUNCH


def total_compute_time(ops: Iterable[Op], xpu: XPUSpec, *, rows: float,
                       fp8: bool = False) -> float:
    return sum(compute_time(o, xpu, rows=rows, fp8=fp8)
               for o in ops if o.kind == "compute")
