"""Published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet,
dense rates, at the full 700 W power limit), and the roofline bound of a
piece of work against them."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def bound_s(n_bytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least time the chip could take: the larger of bytes over the
    memory bandwidth and operations over the peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])
