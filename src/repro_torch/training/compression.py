"""Gradient compression for bandwidth-scarce mesh axes.

Port of ``repro.training.compression``: int8 quantized all-reduce with
error feedback (each rank keeps what quantization dropped and adds it back
before the next quantize). The wire carries the int8 payload; the sum runs
in int32. On one device the ``Dist``'s ``pmax`` and ``psum`` are the
identity; across ranks they run over the axis's process group
(``steps.reduce_grads`` and the ``Trainer`` call it on the slowest data
axis, outside autograd).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.convert import tree_map
from repro_torch.sharding.dist import Dist


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    xf = x.float()
    amax = xf.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def compressed_psum(g: torch.Tensor, axis, dist: Dist,
                    err: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce of `g` over mesh axis `axis` with error feedback.
    Returns (summed gradient f32, new error-feedback residual in g's dtype).
    The ranks share one scale (the pmax of theirs), requantize with it and
    sum the integers."""
    gf = g.float()
    if err is not None:
        gf = gf + err
    _, scale = quantize_int8(gf)
    s_shared = dist.pmax(scale, axis)
    q_shared = torch.clamp(torch.round(gf / s_shared), -127, 127)
    new_err = gf - q_shared * s_shared
    total = dist.psum(q_shared.to(torch.int32), axis)
    return total.float() * s_shared, new_err.to(g.dtype)


def init_error_state(params) -> Any:
    return tree_map(torch.zeros_like, params)
