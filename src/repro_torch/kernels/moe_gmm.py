"""Wrapper of the CUDA grouped expert SwiGLU kernel (``csrc/moe_gmm.cu``),
the port of the Pallas kernel ``repro.kernels.moe_gmm.moe_gmm_pallas``.

``moe_gmm_cuda`` checks its tensors, allocates the output, the h scratch
and the work list, and launches one of two variants of the kernel on the
current stream, chosen by ``variant(dtype, d, f)`` from the dtype and the
shape alone, never on failure:

- ``"tensor_core"``: bfloat16 with D and F multiples of 8 (TMA's 16-byte
  strides; every config in ``repro_torch.configs`` meets it). A pass
  marks the (expert, token tile) pairs that hold a nonzero element and
  zeroes the output rows of the others; persistent ``wgmma`` kernels fed
  by TMA rings then stream only the live tiles' expert weights, in the
  tile plan ``tile_plan(T)`` gives. The tiles and experts skipped are
  added to a counter on the card (``skipped_counter``); nothing is read
  back to the host.
- ``"cuda_core"``: everything else, float32 above all, where the f32 sums
  must not pass through TF32 tensor cores.

Its plain version is ``ref.moe_gmm_ref`` (and ``ref.moe_gmm_active_tiles_ref``
for the skip); ``ops.moe_gmm`` picks between them by device and sends
every CUDA call through ``MoeGmm``, the differentiable form.
``variant_launches`` counts each variant's launched calls and
``launches`` their total, in this process: forward launches only, so a
layer run again by activation checkpointing counts twice. The launch is
the ``torch.library`` op ``repro_torch::moe_gmm``, whose CUDA
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
SWAP_MAX_T = 256        # tokens one SWAP item holds: wgmma's largest N
ROW_TILE = 128          # token rows of a ROWS item
launches = 0
variant_launches = dict.fromkeys(VARIANTS, 0)
_skipped = {}           # device index -> int64 [tiles, experts] on that card
_sms = {}               # device index -> multiprocessor count


def _lib():
    lib = build.library(NAME)
    if lib.moe_gmm_launch.argtypes is None:
        lib.moe_gmm_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        lib.moe_gmm_launch.restype = ctypes.c_int
        lib.moe_gmm_wgmma_launch.argtypes = [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.moe_gmm_wgmma_launch.restype = ctypes.c_int
    return lib


def variant(dtype, d: int, f: int) -> str:
    """The kernel variant for x's dtype and the widths D and F: the
    tensor-core kernel for bfloat16 when D and F are multiples of 8, else
    the CUDA-core kernel."""
    if dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0:
        return "tensor_core"
    return "cuda_core"


def tile_plan(t: int):
    """(plan, n, tile_rows, n_tiles) of the tensor-core kernel for T tokens
    per expert, a pure rule of T:

    - ``"swap"`` for T <= 256: the weights are the wgmma's M rows and the
      tokens its N columns, N = the power of two >= max(T, 8); one token
      tile of T rows per expert, so each weight element streams once.
    - ``"rows"`` for T > 256: the tokens are the M rows, in ceil(T / 128)
      tiles of 128 rows (n = 128, the gated pass's weight columns), whose
      items share each weight tile through L2.

    A token tile is also the unit of the skip: one with no nonzero element
    streams no weights."""
    if t <= SWAP_MAX_T:
        n = 8
        while n < t:
            n *= 2
        return "swap", n, t, 1
    return "rows", ROW_TILE, ROW_TILE, -(-t // ROW_TILE)


def skipped_counter(device) -> torch.Tensor:
    """The card's int64 [tiles, experts] counter that every tensor-core call
    on `device` adds its skipped token tiles and experts to (the tiles
    with no nonzero element, and the experts with no live tile); read it
    around a call to see that call's skip."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _skipped:
        _skipped[idx] = torch.zeros(2, dtype=torch.int64, device=f"cuda:{idx}")
    return _skipped[idx]


def sm_count(device) -> int:
    """The multiprocessor count of a CUDA device (the persistent grid)."""
    device = torch.device(device)
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


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
            plan, n, tile_rows, n_tiles = tile_plan(t)
            work = torch.empty(2 + 2 * e * n_tiles, dtype=torch.int32, device=x.device)
            status = lib.moe_gmm_wgmma_launch(
                *ptrs, work.data_ptr(), skipped_counter(x.device).data_ptr(), e, t, d,
                f, int(plan == "rows"), n, tile_rows, n_tiles, sm_count(x.device), stream)
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
    """Set every launch counter of this wrapper to 0, and the skip counters
    on the cards that have one (queued, no wait)."""
    global launches
    launches = 0
    for key in variant_launches:
        variant_launches[key] = 0
    for counter in _skipped.values():
        counter.zero_()
