"""Batched Cholesky (K1) and forward substitution (K2) — the Hopper port of
``g2o_tpu/ops/pallas_chol.py::chol_batched`` and ``::solve_lower_batched``.

The kernels are CUDA C++ in ``g2o_tpu_torch/csrc/batched_chol.cu`` (its
header says what bounds them and how they are laid out).  They are built
with ``nvcc`` at first use into ``g2o_tpu_torch/_build/`` and loaded with
``ctypes``.  Beside each wrapper is its plain PyTorch version:

* on a CPU tensor the wrapper returns the plain version (the CPU tests run
  it);
* on a CUDA tensor it launches the kernel, or raises — it never falls back.

Each wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
SOURCE = os.path.join(_PKG, "csrc", "batched_chol.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lib = None


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> str:
    """Compile the kernel library (once per source content) and return
    its path.  The file name carries a hash of the source and flags, so an
    edited source is rebuilt."""
    with open(SOURCE, "rb") as fh:
        src = fh.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libbatched_chol_{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for name in ("g2o_chol_batched_f32", "g2o_chol_batched_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, ci, ci, vp]
            fn.restype = ci
        for name in ("g2o_solve_lower_batched_f32",
                     "g2o_solve_lower_batched_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, ci, ci, ci, vp]
            fn.restype = ci
        _lib = lib
    return _lib


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if t.dtype not in _SUFFIX or t.dtype != tensors[0].dtype:
            raise TypeError(f"{name}: needs float32 or float64 tensors of one "
                            f"dtype, got {[x.dtype for x in tensors]}")
        if t.dim() != 3:
            raise ValueError(f"{name}: needs (S, n, ·) tensors, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors")
    if tensors[0].shape[0] > 65535:
        raise ValueError(f"{name}: batch {tensors[0].shape[0]} > 65535")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# --------------------------------------------------------------------------- #
# K1: batched Cholesky
# --------------------------------------------------------------------------- #

def chol_batched_plain(D):
    """Lower Cholesky factor of each SPD ``(n, n)`` matrix of ``(S, n, n)``."""
    return torch.linalg.cholesky(D)


def chol_batched(D):
    """Lower Cholesky factor of SPD ``(S, n, n)``: the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if D.device.type == "cpu":
        return chol_batched_plain(D)
    if D.device.type != "cuda":
        raise ValueError(f"chol_batched: unsupported device {D.device}")
    _check("chol_batched", D)
    S, n, n2 = D.shape
    if n != n2:
        raise ValueError(f"chol_batched: matrices must be square, got "
                         f"{tuple(D.shape)}")
    out = torch.empty_like(D)
    if S == 0 or n == 0:
        return out
    fn = getattr(_load(), f"g2o_chol_batched_{_SUFFIX[D.dtype]}")
    with torch.cuda.device(D.device):
        err = fn(out.data_ptr(), D.data_ptr(), S, n, _stream(D.device))
    if err:
        raise RuntimeError(f"chol_batched kernel failed: CUDA error {err}")
    chol_batched.launches += 1
    return out


chol_batched.launches = 0


# --------------------------------------------------------------------------- #
# K2: batched forward substitution
# --------------------------------------------------------------------------- #

def solve_lower_batched_plain(L, B):
    """Solve ``L Y = B`` for lower-triangular ``L (S, n, n)``, ``B (S, n, m)``."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def solve_lower_batched(L, B):
    """Solve ``L Y = B`` batched: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if L.device.type == "cpu" and B.device.type == "cpu":
        return solve_lower_batched_plain(L, B)
    if L.device.type != "cuda":
        raise ValueError(f"solve_lower_batched: unsupported device {L.device}")
    _check("solve_lower_batched", L, B)
    S, n, n2 = L.shape
    if n != n2 or B.shape[0] != S or B.shape[1] != n:
        raise ValueError(f"solve_lower_batched: shapes {tuple(L.shape)} and "
                         f"{tuple(B.shape)} do not match")
    m = B.shape[2]
    Y = torch.empty_like(B)
    if S == 0 or n == 0 or m == 0:
        return Y
    fn = getattr(_load(), f"g2o_solve_lower_batched_{_SUFFIX[L.dtype]}")
    with torch.cuda.device(L.device):
        err = fn(L.data_ptr(), B.data_ptr(), Y.data_ptr(), S, n, m,
                 _stream(L.device))
    if err:
        raise RuntimeError(f"solve_lower_batched kernel failed: CUDA error "
                           f"{err}")
    solve_lower_batched.launches += 1
    return Y


solve_lower_batched.launches = 0
