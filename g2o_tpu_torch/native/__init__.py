"""Host-side native code: the symbolic block-Cholesky analysis, the
host sparse Cholesky and the ``.g2o`` tokenizer.

* ``symbolic_analysis`` runs ``symchol.cpp`` (fill-reducing
  nested-dissection ordering, elimination tree, exact column structure
  and etree depths; the analogue of CSparse's ``cs_etree``/``cs_ereach``).
  When no compiler is found (or the build fails) it returns ``None`` and
  the caller takes its pure-Python path, as the JAX package does.
* :class:`HostCholesky` runs ``hostchol.cpp``, the scalar up-looking
  sparse Cholesky of the hybrid direct solver's numeric phase
  (``core/solvers/host_chol.py``).  It has no fallback: without its
  library it raises.
* ``parse_blocks`` runs ``fastparse.cpp``, the one-pass ``.g2o`` tokenizer
  of the array-direct loader (``io/g2o_fast.py``).  It returns ``None``
  without a compiler, and the loader then reads the file with the object
  loader.

Each source is compiled on its own with ``g++`` at first use into
``g2o_tpu_torch/_build/``.  All three are byte-identical copies of the JAX
package's ``g2o_tpu/native/symchol.cpp``, ``hostchol.cpp`` and
``fastparse.cpp`` (CPU tests hold them equal): the same source keeps the
ordering, and with it every supernodal schedule and host factor, and the
parsed numbers identical to the JAX package's.  This is host code, not a
device kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "symchol.cpp")
HOSTCHOL_SOURCE = os.path.join(_PKG, "native", "hostchol.cpp")
FASTPARSE_SOURCE = os.path.join(_PKG, "native", "fastparse.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def _build_lib(source: str) -> str | None:
    """Compile ``source`` into ``_build/lib<stem>_<hash>.so``; the path, or
    ``None`` when there is no compiler or the build fails."""
    gxx = shutil.which("g++")
    if gxx is None or not os.path.exists(source):
        return None
    with open(source, "rb") as fh:
        src = fh.read()
    tag = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}_{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run([gxx, *GXX_FLAGS, source, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError) as e:
        print(f"g2o_tpu_torch.native: build of {stem} failed ({e})",
              file=sys.stderr)
        return None


@functools.cache
def get_lib():
    """The symbolic-analysis library, or ``None`` when it cannot be built."""
    path = _build_lib(SOURCE)
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


@functools.cache
def get_hostchol_lib():
    """The host sparse-Cholesky library, or ``None`` when it cannot be
    built."""
    path = _build_lib(HOSTCHOL_SOURCE)
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.g2o_hostchol_sym.restype = ctypes.c_void_p
    lib.g2o_hostchol_sym.argtypes = [ctypes.c_int32,
                                     ctypes.POINTER(ctypes.c_int64), i32p]
    lib.g2o_hostchol_lnz.restype = ctypes.c_int64
    lib.g2o_hostchol_lnz.argtypes = [ctypes.c_void_p]
    lib.g2o_hostchol_factor.restype = ctypes.c_int32
    lib.g2o_hostchol_factor.argtypes = [ctypes.c_void_p, f64p]
    lib.g2o_hostchol_solve.restype = None
    lib.g2o_hostchol_solve.argtypes = [ctypes.c_void_p, f64p]
    lib.g2o_hostchol_release.restype = None
    lib.g2o_hostchol_release.argtypes = [ctypes.c_void_p]
    return lib


class HostCholesky:
    """Reusable host sparse-Cholesky handle over a fixed upper-CSC pattern
    (``hostchol.cpp``): the symbolic structure is computed once, then
    ``factor(Ax)`` + ``solve(b)`` per system.  Raises when the library
    cannot be built (no fallback for the numeric phase)."""

    def __init__(self, n: int, Ap, Ai):
        lib = get_hostchol_lib()
        if lib is None:
            raise RuntimeError("native host-Cholesky library unavailable")
        self._lib = lib
        self.n = int(n)
        self._Ap = np.ascontiguousarray(Ap, dtype=np.int64)
        self._Ai = np.ascontiguousarray(Ai, dtype=np.int32)
        self._h = lib.g2o_hostchol_sym(
            self.n, self._Ap.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._Ai.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if not self._h:
            raise RuntimeError("hostchol symbolic phase failed")
        self.lnz = int(lib.g2o_hostchol_lnz(self._h))

    def factor(self, Ax) -> int:
        """0 on success, -(i+1) when not PD at scalar column i."""
        Ax = np.ascontiguousarray(Ax, dtype=np.float64)
        return int(self._lib.g2o_hostchol_factor(
            self._h, Ax.ctypes.data_as(ctypes.POINTER(ctypes.c_double))))

    def solve(self, b):
        """``x`` with ``L Lᵀ x = b`` (a new array)."""
        out = np.array(b, dtype=np.float64, copy=True)
        self._lib.g2o_hostchol_solve(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return out

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.g2o_hostchol_release(h)
            self._h = None


@functools.cache
def get_fastparse_lib():
    """The ``.g2o`` tokenizer library, or ``None`` when it cannot be
    built."""
    path = _build_lib(FASTPARSE_SOURCE)
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.g2o_parse_file.restype = ctypes.c_void_p
    lib.g2o_parse_file.argtypes = [ctypes.c_char_p]
    lib.g2o_parse_buffer.restype = ctypes.c_void_p
    lib.g2o_parse_buffer.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.g2o_num_blocks.restype = ctypes.c_int
    lib.g2o_num_blocks.argtypes = [ctypes.c_void_p]
    lib.g2o_block_tag.restype = ctypes.c_char_p
    lib.g2o_block_tag.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.g2o_block_rows.restype = ctypes.c_long
    lib.g2o_block_rows.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.g2o_block_cols.restype = ctypes.c_int
    lib.g2o_block_cols.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.g2o_block_copy.restype = None
    lib.g2o_block_copy.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_double),
                                   ctypes.POINTER(ctypes.c_int)]
    lib.g2o_free.restype = None
    lib.g2o_free.argtypes = [ctypes.c_void_p]
    return lib


def parse_blocks(path_or_text, *, is_text: bool = False):
    """Parse a ``.g2o``-style file (or, with ``is_text``, a string) into
    ``{tag: (values (R, C) float64 NaN-padded, ncols (R,) int32)}``: one
    block per leading tag, a row per line, ``ncols`` the numbers on it.
    Returns ``None`` when the native library is unavailable."""
    lib = get_fastparse_lib()
    if lib is None:
        return None
    if is_text:
        data = path_or_text.encode()
        h = lib.g2o_parse_buffer(data, len(data))
    else:
        h = lib.g2o_parse_file(os.fsencode(path_or_text))
    if not h:
        raise IOError(f"fastparse: cannot read {path_or_text!r}")
    try:
        out = {}
        for i in range(lib.g2o_num_blocks(h)):
            tag = lib.g2o_block_tag(h, i).decode()
            vals = np.empty((lib.g2o_block_rows(h, i),
                             lib.g2o_block_cols(h, i)), dtype=np.float64)
            ncols = np.empty((vals.shape[0],), dtype=np.int32)
            lib.g2o_block_copy(
                h, i, vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ncols.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
            out[tag] = (vals, ncols)
        return out
    finally:
        lib.g2o_free(h)
