"""Host-side native code — the symbolic block-Cholesky analysis.

``symbolic_analysis`` runs ``symchol.cpp`` (fill-reducing nested-dissection
ordering, elimination tree, exact column structure and etree depths; the
analogue of CSparse's ``cs_etree``/``cs_ereach``), compiled on its own with
``g++`` at first use into ``g2o_tpu_torch/_build/``.  The source in this
directory is a byte-identical copy of the JAX package's
``g2o_tpu/native/symchol.cpp`` (a CPU test holds the two equal): the same
source keeps the ordering, and with it every supernodal schedule, identical
to the JAX package's.

When no compiler is found (or the build fails) ``symbolic_analysis``
returns ``None`` and the caller takes its pure-Python path, as the JAX
package does.  This is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "symchol.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_LIB = None
_TRIED = False


def _build_lib() -> str | None:
    gxx = shutil.which("g++")
    if gxx is None or not os.path.exists(SOURCE):
        return None
    with open(SOURCE, "rb") as fh:
        src = fh.read()
    tag = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libsymchol_{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run([gxx, *GXX_FLAGS, SOURCE, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError) as e:
        print(f"g2o_tpu_torch.native: build failed ({e}); using the "
              f"pure-Python symbolic analysis", file=sys.stderr)
        return None


def get_lib():
    """The symbolic-analysis library, or ``None`` when it cannot be built."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _build_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.g2o_symchol.restype = ctypes.c_void_p
    lib.g2o_symchol.argtypes = [ctypes.c_int32, ctypes.c_int64, i32p,
                                ctypes.c_int32]
    lib.g2o_sym_nnz.restype = ctypes.c_int64
    lib.g2o_sym_nnz.argtypes = [ctypes.c_void_p]
    lib.g2o_sym_nlevels.restype = ctypes.c_int32
    lib.g2o_sym_nlevels.argtypes = [ctypes.c_void_p]
    for fn in ("g2o_sym_perm", "g2o_sym_parent", "g2o_sym_rows",
               "g2o_sym_depth"):
        getattr(lib, fn).restype = None
        getattr(lib, fn).argtypes = [ctypes.c_void_p, i32p]
    lib.g2o_sym_colptr.restype = None
    lib.g2o_sym_colptr.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.g2o_sym_release.restype = None
    lib.g2o_sym_release.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def symbolic_analysis(n: int, pairs, min_size: int = 32):
    """Native symbolic block-Cholesky analysis (ordering + etree + exact L
    structure + level depths).  ``pairs``: (M, 2) int array of unique
    undirected off-diagonal block pairs.  Returns a dict of numpy arrays,
    or ``None`` when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pairs = np.ascontiguousarray(
        np.asarray(pairs, dtype=np.int32).reshape(-1, 2))
    i32p = ctypes.POINTER(ctypes.c_int32)
    h = lib.g2o_symchol(n, pairs.shape[0], pairs.ctypes.data_as(i32p),
                        min_size)
    if not h:
        return None
    try:
        nnz = lib.g2o_sym_nnz(h)
        perm = np.empty(n, dtype=np.int32)
        parent = np.empty(n, dtype=np.int32)
        depth = np.empty(n, dtype=np.int32)
        colptr = np.empty(n + 1, dtype=np.int64)
        rows = np.empty(nnz, dtype=np.int32)
        lib.g2o_sym_perm(h, perm.ctypes.data_as(i32p))
        lib.g2o_sym_parent(h, parent.ctypes.data_as(i32p))
        lib.g2o_sym_depth(h, depth.ctypes.data_as(i32p))
        lib.g2o_sym_colptr(
            h, colptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if nnz:
            lib.g2o_sym_rows(h, rows.ctypes.data_as(i32p))
        return {"perm": perm, "parent": parent, "depth": depth,
                "colptr": colptr, "rows": rows,
                "nlevels": int(lib.g2o_sym_nlevels(h))}
    finally:
        lib.g2o_sym_release(h)
