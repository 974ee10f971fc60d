"""Batched Cholesky (K1), forward substitution (K2) and backward
substitution (K3) — the Hopper port of ``g2o_tpu/ops/pallas_chol.py::
chol_batched``, ``::solve_lower_batched`` and ``::solve_upper_batched``.

The kernels are CUDA C++ in ``g2o_tpu_torch/csrc/batched_chol.cu`` (its
header says what bounds them and how they are laid out).  They are built
with ``nvcc`` at first use into ``g2o_tpu_torch/_build/`` and loaded with
``ctypes``; :func:`build` is the package's one build helper and also builds
the libraries of ``ops/segment_kernels.py`` and ``ops/onehot.py``.  Beside
each wrapper is its plain PyTorch version:

* on a CPU tensor the wrapper returns the plain version (the CPU tests run
  it);
* on a CUDA tensor it launches the kernel, or raises — it never falls back.

Each wrapper counts its kernel launches in ``<wrapper>.launches``, and by
launch shape ``(S, n, m)`` (``m = n`` for K1) in ``<wrapper>.shapes``.  K1 and
K2 take an int32 scratch of tile flags that the wrapper allocates, of the
length the library gives (``g2o_chol_scratch_len``,
``g2o_solve_lower_scratch_len``).
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
# library name -> CUDA source; each builds into lib<name>_<hash>.so
SOURCES = {name: os.path.join(_PKG, "csrc", f"{name}.cu")
           for name in ("batched_chol", "segment_sum", "gather_segment")}
# the headers of csrc/ that the sources include
HEADERS = sorted(os.path.join(_PKG, "csrc", f)
                 for f in os.listdir(os.path.join(_PKG, "csrc"))
                 if f.endswith(".cuh"))
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


def _target(name):
    """Path of library ``name``'s build; the file name carries a hash of
    the source, the headers it may include and the flags, so an edited
    source or header is rebuilt."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (SOURCES[name], *HEADERS):
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(*names) -> list:
    """Compile the named kernel libraries (all of :data:`SOURCES` when none
    is named) that are not built yet, one ``nvcc`` per source, all started
    together; return their paths in order."""
    names = names or tuple(SOURCES)
    outs, procs = [], []
    for name in names:
        out = _target(name)
        outs.append(out)
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        procs.append((out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCES[name]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for out, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}) for "
                          f"{os.path.basename(out)}:\n{err}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build("batched_chol")[0])
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        argtypes = {
            # out, D, scratch, scratch length, S, n, stream
            "g2o_chol_batched": [vp, vp, vp, cl, ci, ci, vp],
            # L, B, Y, scratch, scratch length, S, n, m, stream
            "g2o_solve_lower_batched": [vp, vp, vp, vp, cl, ci, ci, ci, vp],
            # L, B, X, S, n, m, stream
            "g2o_solve_upper_batched": [vp, vp, vp, ci, ci, ci, vp]}
        for name, args in argtypes.items():
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = args
                fn.restype = ci
        # scratch lengths: (S, n) and (S, n, m)
        for name, args in (("g2o_chol_scratch_len", [ci, ci]),
                           ("g2o_solve_lower_scratch_len", [ci, ci, ci])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = cl
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
    """Lower Cholesky factor of each SPD ``(n, n)`` matrix of ``(S, n, n)``.
    A matrix that is not positive definite gets a NaN factor, as from the
    kernel (whose square root of a negative pivot spreads NaN), so an LM
    trial on it fails on a non-finite chi2 instead of raising."""
    L, info = torch.linalg.cholesky_ex(D)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


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
    lib = _load()
    fn = getattr(lib, f"g2o_chol_batched_{_SUFFIX[D.dtype]}")
    # the kernel's entry zeroes the scratch on the stream
    flags = torch.empty(lib.g2o_chol_scratch_len(S, n), dtype=torch.int32,
                        device=D.device)
    with torch.cuda.device(D.device):
        err = fn(out.data_ptr(), D.data_ptr(), flags.data_ptr(), flags.numel(),
                 S, n, _stream(D.device))
    if err:
        raise RuntimeError(f"chol_batched kernel failed: CUDA error {err}")
    chol_batched.launches += 1
    chol_batched.shapes[(S, n, n)] = chol_batched.shapes.get((S, n, n), 0) + 1
    return out


chol_batched.launches = 0
chol_batched.shapes = {}


# --------------------------------------------------------------------------- #
# K2 / K3: batched forward and backward substitution
# --------------------------------------------------------------------------- #

def _launch_solve(wrapper, L, B):
    """Launch ``g2o_<wrapper name>_f32/_f64`` on CUDA tensors ``L (S, n, n)``
    and ``B (S, n, m)``, count it in ``wrapper.launches`` and
    ``wrapper.shapes`` and return the solution."""
    name = wrapper.__name__
    if L.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {L.device}")
    _check(name, L, B)
    S, n, n2 = L.shape
    if n != n2 or B.shape[0] != S or B.shape[1] != n:
        raise ValueError(f"{name}: shapes {tuple(L.shape)} and "
                         f"{tuple(B.shape)} do not match")
    m = B.shape[2]
    out = torch.empty_like(B)
    if S == 0 or n == 0 or m == 0:
        return out
    lib = _load()
    fn = getattr(lib, f"g2o_{name}_{_SUFFIX[L.dtype]}")
    # K2 takes a scratch of tile flags (its entry zeroes it), K3 none
    scratch = ()
    if wrapper is solve_lower_batched:
        flags = torch.empty(lib.g2o_solve_lower_scratch_len(S, n, m),
                            dtype=torch.int32, device=L.device)
        scratch = (flags.data_ptr(), flags.numel())
    with torch.cuda.device(L.device):
        err = fn(L.data_ptr(), B.data_ptr(), out.data_ptr(), *scratch, S, n, m,
                 _stream(L.device))
    if err:
        raise RuntimeError(f"{name} kernel failed: CUDA error {err}")
    wrapper.launches += 1
    wrapper.shapes[(S, n, m)] = wrapper.shapes.get((S, n, m), 0) + 1
    return out


def solve_lower_batched_plain(L, B):
    """Solve ``L Y = B`` for lower-triangular ``L (S, n, n)``, ``B (S, n, m)``."""
    return torch.linalg.solve_triangular(L, B, upper=False)


def solve_lower_batched(L, B):
    """Solve ``L Y = B`` batched: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if L.device.type == "cpu" and B.device.type == "cpu":
        return solve_lower_batched_plain(L, B)
    return _launch_solve(solve_lower_batched, L, B)


solve_lower_batched.launches = 0
solve_lower_batched.shapes = {}


def solve_upper_batched_plain(L, B):
    """Solve ``Lᵀ X = B`` given the LOWER factor ``L (S, n, n)``, ``B (S, n, m)``."""
    return torch.linalg.solve_triangular(L.mT, B, upper=True)


def solve_upper_batched(L, B):
    """Solve ``Lᵀ X = B`` batched (``L`` lower): the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if L.device.type == "cpu" and B.device.type == "cpu":
        return solve_upper_batched_plain(L, B)
    return _launch_solve(solve_upper_batched, L, B)


solve_upper_batched.launches = 0
solve_upper_batched.shapes = {}
