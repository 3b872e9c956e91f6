"""PyTorch/CUDA port of the JAX package ``repro``.

Mirrors ``repro``'s layout module for module. Plain tensor code is
PyTorch; each Pallas TPU kernel of ``repro`` has a hand-written CUDA
kernel under ``csrc/`` (built with nvcc at first use, bound with ctypes).
Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper uses its plain version.
"""
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device without a card is an
    error: the port never drops to the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
