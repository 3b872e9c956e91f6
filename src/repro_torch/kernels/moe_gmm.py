"""Wrapper of the CUDA grouped expert SwiGLU kernel (``csrc/moe_gmm.cu``),
the port of the Pallas kernel ``repro.kernels.moe_gmm.moe_gmm_pallas``.

``moe_gmm_cuda`` checks its tensors, allocates the output and the h
scratch, and launches one of two variants of the two-pass kernel on the
current stream, chosen by ``variant(dtype, d, f)`` from the dtype and the
shape alone, never on failure:

- ``"tensor_core"``: bfloat16 with D and F multiples of 8 (the 16-byte
  copies' alignment; every config in ``repro_torch.configs`` meets it).
  The weights are the MMA's rows and the tokens its columns, so each
  weight is read once for any T <= 256 (``tile_plan``).
- ``"cuda_core"``: everything else, float32 above all, where the f32 sums
  must not pass through TF32 tensor cores.

Its plain version is ``ref.moe_gmm_ref``; ``ops.moe_gmm`` picks between
them by device and sends every CUDA call through ``MoeGmm``, the
differentiable form. ``variant_launches`` counts each variant's launched
calls and ``launches`` their total, in this process: forward launches only,
so a layer run again by activation checkpointing counts twice. The launch
is the ``torch.library`` op ``repro_torch::moe_gmm``, whose CUDA
implementation launches and counts, with a fake and a flop formula
(``moe_gmm_flops``) for traces (``launch.dryrun``).
"""
from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.ref import moe_gmm_bwd_ref

NAME = "moe_gmm"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("tensor_core", "cuda_core")
TC_MAX_N = 256          # tokens one tensor-core block holds
launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)


def _lib():
    lib = build.library(NAME)
    if lib.moe_gmm_launch.argtypes is None:
        lib.moe_gmm_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        lib.moe_gmm_launch.restype = ctypes.c_int
        lib.moe_gmm_tc_launch.argtypes = [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.moe_gmm_tc_launch.restype = ctypes.c_int
    return lib


def variant(dtype, d: int, f: int) -> str:
    """The kernel variant for x's dtype and the widths D and F: the
    tensor-core kernel for bfloat16 when D and F are multiples of 8, else
    the CUDA-core kernel."""
    if dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0:
        return "tensor_core"
    return "cuda_core"


def tile_plan(t: int):
    """(nf, mt, n_tiles) of the tensor-core kernel for T tokens: a block
    holds N = 8*nf tokens, nf the power of two that covers min(T, 256), and
    mt weight columns (64 at nf = 32, where 128 would not fit the
    registers); n_tiles = ceil(T / N) blocks share each weight tile, so the
    weights stream once for T <= 256."""
    nf = 1
    while 8 * nf < min(t, TC_MAX_N):
        nf *= 2
    return nf, (64 if nf == 32 else 128), -(-t // (8 * nf))


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
        if not is_fake(a) and a.data_ptr() % 16:   # a fake tensor has no address
            raise ValueError("moe_gmm: tensors must start on a 16-byte boundary")
    if x.dtype not in DTYPES:
        raise ValueError(f"moe_gmm: dtype {x.dtype} not supported")
    if min(e, t, d, f) <= 0:
        raise ValueError(f"moe_gmm: empty shape {(e, t, d, f)}")
    return e, t, d, f


def moe_gmm_cuda(x, w_gate, w_up, w_down):
    """x: [E, T, D]; w_gate/w_up: [E, D, F]; w_down: [E, F, D] -> [E, T, D],
    all on one CUDA device, float32 or bfloat16, any T, D and F. The
    variant is ``variant(x.dtype, D, F)``; an error of either raises. The
    launch is the custom op ``repro_torch::moe_gmm``, so that a trace under
    ``FakeTensorMode`` (the dry run) sees it with its output's shape and
    its flop count, and launches nothing."""
    _check(x, w_gate, w_up, w_down)
    return torch.ops.repro_torch.moe_gmm(x, w_gate, w_up, w_down)


def _moe_gmm_launch(x, w_gate, w_up, w_down):
    """The op's CUDA implementation: the launch (tensors checked by
    ``moe_gmm_cuda``)."""
    global launches
    e, t, d = x.shape
    f = w_gate.shape[-1]
    which = variant(x.dtype, d, f)
    lib = _lib()
    with torch.cuda.device(x.device):
        h = torch.empty((e, t, f), dtype=x.dtype, device=x.device)
        out = torch.empty((e, t, d), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = (x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                w_down.data_ptr(), h.data_ptr(), out.data_ptr())
        if which == "tensor_core":
            nf, mt, _ = tile_plan(t)
            status = lib.moe_gmm_tc_launch(*ptrs, e, t, d, f, nf, mt, stream)
        else:
            status = lib.moe_gmm_launch(*ptrs, e, t, d, f, DTYPES[x.dtype], stream)
    build.check(status, NAME)
    launches += 1
    variant_launches[which] += 1
    return out


# the op, registered through the plain ``torch.library.Library`` API: the
# first call of a ``torch.library.custom_op`` imports DTensor, dynamo and
# sympy (seconds of host time), and each call costs more host time
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("moe_gmm(Tensor x, Tensor w_gate, Tensor w_up, Tensor w_down) -> Tensor")
_LIB.impl("moe_gmm", _moe_gmm_launch, "CUDA")
torch.library.register_fake("repro_torch::moe_gmm", lambda x, w_gate, w_up, w_down:
                            torch.empty_like(x), lib=_LIB)


@register_flop_formula(torch.ops.repro_torch.moe_gmm)
def moe_gmm_flops(x_shape, w_gate_shape, *args, **kwargs) -> int:
    """6 E T D F: the gate, up and down products, 2 E T D F each."""
    e, t, d = x_shape
    return 6 * e * t * d * w_gate_shape[-1]


class MoeGmm(torch.autograd.Function):
    """``moe_gmm_cuda`` with a gradient: training runs the expert FFN's
    forward in the CUDA kernel. The kernel writes into tensors from
    ``torch.empty``, which carry no graph, so without this Function the
    expert weights and the tokens routed to them would get no gradient,
    and nothing would say so.

    The backward is ``ref.moe_gmm_bwd_ref``, plain batched products: the
    JAX package has no backward kernel either (no ``custom_vjp`` around
    ``moe_gmm_pallas``; its gradient is autodiff of the oracle's products,
    outside any Pallas kernel), so there is no TPU kernel to port for it
    yet. The forward saves only its inputs (x and the weights, alive
    anyway); the backward recomputes g and u, which saves 2·E·T·F
    elements per layer for two more products."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down):
        ctx.save_for_backward(x, w_gate, w_up, w_down)
        return moe_gmm_cuda(x, w_gate, w_up, w_down)

    @staticmethod
    def backward(ctx, dy):
        return moe_gmm_bwd_ref(*ctx.saved_tensors, dy.contiguous())


def reset_counts() -> None:
    """Set every launch counter of this wrapper to 0."""
    global launches
    launches = 0
    for key in variant_launches:
        variant_launches[key] = 0
