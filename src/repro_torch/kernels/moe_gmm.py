"""Wrapper of the CUDA grouped expert SwiGLU kernel (``csrc/moe_gmm.cu``),
the port of the Pallas kernel ``repro.kernels.moe_gmm.moe_gmm_pallas``.

``moe_gmm_cuda`` checks its tensors, allocates the output and the h
scratch, and launches the two-pass kernel on the current stream. Its
plain version is ``ref.moe_gmm_ref``; ``ops.moe_gmm`` picks between them by
device. ``launches`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "moe_gmm"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = 0


def _lib():
    lib = build.library(NAME)
    if lib.moe_gmm_launch.argtypes is None:
        lib.moe_gmm_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        lib.moe_gmm_launch.restype = ctypes.c_int
    return lib


def _check(x, w_gate, w_up, w_down):
    if x.dim() != 3 or w_gate.dim() != 3:
        raise ValueError("moe_gmm: x [E, T, D] and weights [E, D, F] expected")
    e, t, d = x.shape
    f = w_gate.shape[-1]
    want = {"w_gate": (e, d, f), "w_up": (e, d, f), "w_down": (e, f, d)}
    for name, w in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if tuple(w.shape) != want[name]:
            raise ValueError(f"moe_gmm: {name} {tuple(w.shape)} != {want[name]}")
    for a in (x, w_gate, w_up, w_down):
        if a.device.type != "cuda" or a.device != x.device:
            raise ValueError("moe_gmm: every tensor must be on the same CUDA device")
        if a.dtype != x.dtype:
            raise ValueError("moe_gmm: x and the weights must share one dtype")
        if not a.is_contiguous():
            raise ValueError("moe_gmm: tensors must be contiguous")
        if a.data_ptr() % 16:
            raise ValueError("moe_gmm: tensors must start on a 16-byte boundary")
    if x.dtype not in DTYPES:
        raise ValueError(f"moe_gmm: dtype {x.dtype} not supported")
    if min(e, t, d, f) <= 0:
        raise ValueError(f"moe_gmm: empty shape {(e, t, d, f)}")
    return e, t, d, f


def moe_gmm_cuda(x, w_gate, w_up, w_down):
    """x: [E, T, D]; w_gate/w_up: [E, D, F]; w_down: [E, F, D] -> [E, T, D],
    all on one CUDA device, float32 or bfloat16, any T, D and F."""
    global launches
    e, t, d, f = _check(x, w_gate, w_up, w_down)
    lib = _lib()
    with torch.cuda.device(x.device):
        h = torch.empty((e, t, f), dtype=x.dtype, device=x.device)
        out = torch.empty((e, t, d), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.moe_gmm_launch(
            x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
            h.data_ptr(), out.data_ptr(), e, t, d, f, DTYPES[x.dtype], stream)
    build.check(status, NAME)
    launches += 1
    return out
