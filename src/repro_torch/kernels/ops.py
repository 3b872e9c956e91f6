"""Dispatching wrappers the model calls: a CUDA tensor goes to the hand
kernel (or the call raises), a CPU tensor to the plain version. Nothing
else selects the path: no override and no fallback on CUDA."""
from __future__ import annotations

from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_decode import flash_decode_cuda, flash_decode_lse_cuda
from repro_torch.kernels.moe_gmm import MoeGmm


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def moe_gmm(x, w_gate, w_up, w_down):
    """x: [E, T, D]; w_gate/w_up: [E, D, F]; w_down: [E, F, D] -> [E, T, D].
    On CUDA tensors the kernel, inside ``MoeGmm`` whether or not a gradient
    is wanted; on CPU tensors the plain version, which autograd
    differentiates as it is."""
    if _on_cpu(x):
        return kref.moe_gmm_ref(x, w_gate, w_up, w_down)
    return MoeGmm.apply(x, w_gate, w_up, w_down)


def flash_decode(q, k, v, length):
    """q: [B, H, hd]; k/v: [B, KH, S, hd]; length: int, 0-d or [B] tensor."""
    if _on_cpu(q):
        return kref.flash_decode_ref(q, k, v, length)
    return flash_decode_cuda(q, k, v, length)


def flash_decode_lse(q, k, v, length):
    """The (o, m, l) form for a sequence-sharded cache: q [B, H, hd];
    k/v [B, KH, S, hd]; length: valid positions per slot -> o f32
    [B, H, hd], m, l f32 [B, H]."""
    if _on_cpu(q):
        return kref.flash_decode_lse_ref(q, k, v, length)
    return flash_decode_lse_cuda(q, k, v, length)
