"""Wrapper of the CUDA decode-attention kernel (``csrc/flash_decode.cu``),
the port of the Pallas kernel ``repro.kernels.flash_decode.flash_decode_pallas``.

``flash_decode_cuda`` checks its tensors, turns ``length`` into an int32
[B] device tensor (one valid length per slot; a scalar broadcasts),
allocates the output and the f32 scratch of the split partials, and
launches the two kernels (partials over ``n_split(S)`` chunks of the cache,
then their combine) on the current stream. The grid is sized from S, the
cache capacity, so nothing reads the lengths on the host. Its plain version
is ``ref.flash_decode_ref``; ``ops.flash_decode`` picks between them by
device. ``launches`` counts the wrapper's calls that launched (each call is
two kernel launches).

``flash_decode_lse_cuda`` is the (o, m, l) form for a sequence-sharded
cache: the same partials, then a combine that returns the shard's
unnormalised f32 output with its max and sum (m = -1e30, l = 0, o = 0 for
a shard with nothing to attend to), for ``attention.lse_combine`` across
ranks. Its plain version is ``ref.flash_decode_lse_ref``, the port's
``attn_chunk_lse``; ``ops.flash_decode_lse`` picks between them.
``lse_launches`` counts its calls.

Each launch is an op of ``torch.library`` (``repro_torch::flash_decode``,
``repro_torch::flash_decode_lse``) whose CUDA implementation launches and
counts, with a fake (shapes and dtypes, for a trace under
``FakeTensorMode``) and a flop formula (``flash_decode_flops``).
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

NAME = "flash_decode"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HD = 256
CHUNK = 64          # cache positions per split, as in the CUDA source
launches = 0
lse_launches = 0


def _lib():
    lib = build.library(NAME)
    if lib.flash_decode_launch.argtypes is None:
        lib.flash_decode_launch.argtypes = [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.flash_decode_launch.restype = ctypes.c_int
        lib.flash_decode_lse_launch.argtypes = [ctypes.c_void_p] * 10 \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.flash_decode_lse_launch.restype = ctypes.c_int
    return lib


def n_split(s: int) -> int:
    """Splits of a cache of capacity `s`: ceil(s / CHUNK), at least one."""
    return max(1, -(-s // CHUNK))


def scratch_shapes(b: int, kh: int, g: int, s: int, hd: int) -> dict:
    """Shapes of the f32 partials that pass 1 writes and pass 2 combines:
    the unnormalised output o, the chunk max m and the chunk sum l."""
    n = n_split(s)
    return {"o": (b, kh, n, g, hd), "m": (b, kh, n, g, 1), "l": (b, kh, n, g, 1)}


def lengths_tensor(length, batch: int, device) -> torch.Tensor:
    """int32 [B] lengths on `device` from an int, a 0-d or a [B] tensor."""
    if not torch.is_tensor(length):
        return torch.full((batch,), int(length), dtype=torch.int32, device=device)
    lengths = length.to(device=device, dtype=torch.int32)
    if lengths.dim() == 0:
        lengths = lengths.expand(batch)
    if tuple(lengths.shape) != (batch,):
        raise ValueError(f"flash_decode: length {tuple(lengths.shape)} is not "
                         f"a scalar or [{batch}]")
    return lengths.contiguous()


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_decode: q [B, H, hd] and k/v [B, KH, S, hd] expected")
    b, h, hd = q.shape
    kh, s = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != hd or h % kh:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")
    if hd > MAX_HD:
        raise ValueError(f"flash_decode: head dim {hd} > {MAX_HD}")
    if not all(a.is_contiguous() for a in (q, k, v)):
        raise ValueError("flash_decode: tensors must be contiguous")
    if any(not is_fake(a) and a.data_ptr() % 16 for a in (k, v)):
        # K/V rows go in 16-byte copies (a fake tensor has no address)
        raise ValueError("flash_decode: k and v must start on a 16-byte boundary")
    for a in (q, k, v):
        if a.device.type != "cuda" or a.device != q.device:
            raise ValueError("flash_decode: q, k, v must be on one CUDA device")
        if a.dtype != q.dtype:
            raise ValueError("flash_decode: q, k, v must share one dtype")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_decode: dtype {q.dtype} not supported")
    return b, h, kh, s, hd


def _scratch(b, kh, g, s, hd, device):
    """One f32 buffer for the partials; the pointers of o, m and l in it."""
    shapes = scratch_shapes(b, kh, g, s, hd)
    sizes = [math.prod(shapes[n]) for n in ("o", "m", "l")]
    part = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    o_ptr = part.data_ptr()
    m_ptr = o_ptr + 4 * sizes[0]
    return part, (o_ptr, m_ptr, m_ptr + 4 * sizes[1])


def flash_decode_cuda(q, k, v, length):
    """q: [B, H, hd]; k/v: [B, KH, S, hd], contiguous, k and v starting on
    a 16-byte boundary; length: int, 0-d or [B] int tensor of valid
    positions per slot. Returns [B, H, hd] in q's dtype. The launch is the
    custom op ``repro_torch::flash_decode`` (see ``moe_gmm.moe_gmm_cuda``)."""
    b = _check(q, k, v)[0]
    return torch.ops.repro_torch.flash_decode(q, k, v, lengths_tensor(length, b, q.device))


def flash_decode_lse_cuda(q, k, v, length):
    """The (o, m, l) form, on the arguments of ``flash_decode_cuda``.
    Returns o f32 [B, H, hd] (sum over the valid positions of e^(s - m) v),
    m and l f32 [B, H] (the max score, -1e30 where no position is valid,
    and the sum of e^(s - m)). The launch is the custom op
    ``repro_torch::flash_decode_lse``."""
    b = _check(q, k, v)[0]
    return torch.ops.repro_torch.flash_decode_lse(q, k, v,
                                                  lengths_tensor(length, b, q.device))


def _flash_decode_launch(q, k, v, lengths):
    """The CUDA implementation of ``repro_torch::flash_decode``: the launch
    (tensors checked by ``flash_decode_cuda``)."""
    global launches
    b, h, hd = q.shape
    kh, s = k.shape[1], k.shape[2]
    lib = _lib()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        part, ptrs = _scratch(b, kh, h // kh, s, hd, q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.flash_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), *ptrs, b, kh, h // kh, s, hd, DTYPES[q.dtype], stream)
    build.check(status, NAME)
    launches += 1
    return out


def _flash_decode_lse_launch(q, k, v, lengths):
    """The CUDA implementation of ``repro_torch::flash_decode_lse``."""
    global lse_launches
    b, h, hd = q.shape
    kh, s = k.shape[1], k.shape[2]
    lib = _lib()
    with torch.cuda.device(q.device):
        o = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
        m = torch.empty((b, h), dtype=torch.float32, device=q.device)
        lsum = torch.empty((b, h), dtype=torch.float32, device=q.device)
        part, ptrs = _scratch(b, kh, h // kh, s, hd, q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = lib.flash_decode_lse_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            o.data_ptr(), m.data_ptr(), lsum.data_ptr(), *ptrs,
            b, kh, h // kh, s, hd, DTYPES[q.dtype], stream)
    build.check(status, NAME)
    lse_launches += 1
    return o, m, lsum


def _flash_decode_lse_fake(q, k, v, lengths):
    b, h, hd = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return q.new_empty((b, h, hd), **f32), q.new_empty((b, h), **f32), \
        q.new_empty((b, h), **f32)


# the ops, registered as ``moe_gmm``'s is (see there)
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_decode(Tensor q, Tensor k, Tensor v, Tensor lengths) -> Tensor")
_LIB.define("flash_decode_lse(Tensor q, Tensor k, Tensor v, Tensor lengths) "
            "-> (Tensor, Tensor, Tensor)")
_LIB.impl("flash_decode", _flash_decode_launch, "CUDA")
_LIB.impl("flash_decode_lse", _flash_decode_lse_launch, "CUDA")
torch.library.register_fake("repro_torch::flash_decode",
                            lambda q, k, v, lengths: torch.empty_like(q), lib=_LIB)
torch.library.register_fake("repro_torch::flash_decode_lse", _flash_decode_lse_fake,
                            lib=_LIB)


@register_flop_formula([torch.ops.repro_torch.flash_decode,
                        torch.ops.repro_torch.flash_decode_lse])
def flash_decode_flops(q_shape, k_shape, *args, **kwargs) -> int:
    """4 B H S hd: the scores and the weighted sum of V over the whole
    cache capacity S, 2 B H S hd each (the masked positions included, as
    the plain version computes them)."""
    b, h, hd = q_shape
    return 4 * b * h * k_shape[2] * hd
