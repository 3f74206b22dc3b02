"""Build and load the hand-written CUDA kernels of ``pydens_tpu_torch/csrc``.

Every ``*.cu`` file there compiles with ``nvcc`` for Hopper (``sm_90a``)
into ONE shared library with a plain C interface, loaded with ``ctypes``.
The build happens at first use, into ``build/kernels/`` beside the package,
keyed by a hash of the sources and flags, so a fresh checkout needs nothing
but ``nvcc``.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from .. import tracing

__all__ = ["load_library", "launch_checked", "check_operand",
           "MAX_SHARED_BYTES"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Dynamic shared memory one block may use on an H100 (227 KB).
MAX_SHARED_BYTES = 232_448

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "pdt_taylor_tile_points": [],
    "pdt_taylor_forward": [_P] * 6 + [_I] * 7 + [_P],
    "pdt_taylor_backward": [_P] * 9 + [_I] * 8 + [_P],
    "pdt_taylor_blocks_per_sm": [_I] * 4,
    "pdt_taylor_jvp": [_P] * 7 + [_I] * 9 + [_P],
    "pdt_taylor_jvp_blocks_per_sm": [_I] * 5,
    "pdt_mlp_blocks_per_sm": [_I] * 5,
    "pdt_mlp_forward": [_P, _P, _P, _P] + [_I] * 10 + [_P],
}

_LIB = None


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    candidate = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "nvcc"
    if not candidate.exists():
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of pydens_tpu_torch are built "
            "from source at first use and need the CUDA toolkit")
    return str(candidate)


def load_library():
    """The kernel library, built on first call (cached per process).

    The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept as ``lib.build_log``; the build or the load
    is the span ``pydens.kernels.build`` (:mod:`pydens_tpu_torch.tracing`),
    its ``built`` attribute True where ``nvcc`` ran."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with tracing.span("pydens.kernels.build") as sp:
        sources = sorted(_CSRC.glob("*.cu"))
        digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
        for src in sources:
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        target = (_BUILD_DIR
                  / f"libpydens_kernels_{digest.hexdigest()[:16]}.so")
        log, built = "", not target.exists()
        if built:
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            proc = subprocess.run(
                [_nvcc(), *_NVCC_FLAGS, "-o", tmp, *map(str, sources)],
                capture_output=True, text=True, check=False)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed (exit {proc.returncode}):\n{log}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.build_log = log
        lib.path = str(target)
        if sp is not None:
            sp.attrs["built"] = built
    _LIB = lib
    return lib


def launch_checked(name, err):
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check_operand(name, t, shape):
    """Validate one kernel operand: a contiguous float32 CUDA tensor of the
    given shape."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def check_packed(packed, x, plan, x_shape=None):
    """Validate a kernel's points ``x`` ``(n, plan.in_dim)`` (or of the
    shape ``x_shape``, the input of ``n`` points) and packed weights
    ``(P,)``, or ``(K, P)`` for an ensemble's K members, on the points'
    device; returns ``n``."""
    n = x.shape[0]
    check_operand("x", x, x_shape or (n, plan.in_dim))
    if packed.dim() not in (1, 2):
        raise ValueError(f"packed weights of shape {tuple(packed.shape)}: "
                         "expected (P,) or, for an ensemble, (K, P)")
    check_operand("packed", packed,
                  tuple(packed.shape[:-1]) + (plan.n_params,))
    if packed.device != x.device:
        raise ValueError(f"packed weights on {packed.device}, points on "
                         f"{x.device}")
    return n
