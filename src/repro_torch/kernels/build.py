"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with nvcc
into its own shared library, loaded with ctypes (no PyTorch headers, so a
build takes seconds). Libraries go to ``src/repro_torch/_build/`` (listed
in .gitignore), named by a hash of their source, and are built at first
use: a checkout holding only the sources builds everything it runs.
``build_all`` compiles every missing library at once, one nvcc per source.
Each library also exports ``kernel_count`` and ``kernel_attributes``, which
``kernel_attributes`` here reads: every kernel's registers and local
(spilled) bytes per thread, as the card's loader reports them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
KERNELS = ("moe_gmm", "flash_decode")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(names: Iterable[str]) -> Dict[str, float]:
    """Compile the libraries of `names` that are missing, one nvcc process
    per source, all started together. Returns the seconds of each build."""
    started = {}
    for name in names:
        if lib_path(name).is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, time.perf_counter())
    seconds = {}
    for name, (proc, tmp, t0) in started.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, lib_path(name))
        seconds[name] = time.perf_counter() - t0
    return seconds


def build_all() -> Dict[str, float]:
    """Compile every kernel that is not built yet; the seconds of each."""
    return _compile(KERNELS)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if it is missing."""
    lib = _libs.get(name)
    if lib is None:
        _compile([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def kernel_attributes(name: str) -> Dict[str, dict]:
    """{kernel: {"regs": registers per thread, "local_bytes": local memory
    per thread (spills and stack)}} for every kernel of one library; needs
    the card."""
    lib = library(name)
    if lib.kernel_attributes.argtypes is None:
        lib.kernel_attributes.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
                                          ctypes.POINTER(ctypes.c_int),
                                          ctypes.POINTER(ctypes.c_int)]
        lib.kernel_attributes.restype = ctypes.c_int
    out = {}
    for i in range(lib.kernel_count()):
        kname, regs, local = ctypes.c_char_p(), ctypes.c_int(), ctypes.c_int()
        check(lib.kernel_attributes(i, ctypes.byref(kname), ctypes.byref(regs),
                                    ctypes.byref(local)), name)
        out[kname.value.decode()] = {"regs": regs.value, "local_bytes": local.value}
    return out


def check(status: int, name: str) -> None:
    """Raise on a CUDA error code returned by a kernel's C entry."""
    if status != 0:
        lib = library(name)
        msg = lib.kernel_error_string(status).decode()
        raise RuntimeError(f"{name} kernel failed: cudaError {status} ({msg})")
