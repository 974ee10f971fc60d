"""Row gather and segment sum by index — the port of
``g2o_tpu/ops/onehot.py`` and of the Pallas kernels K5–K10 of
``scripts/pallas_onehot_experimental.py`` that hand-write it.

The JAX package computes ``table[idx]`` and the segment sum of rows by
``idx`` as one-hot matrix products on the TPU's matrix unit, because a TPU
gather or scatter serializes per row.  What is ported is the function, not
the one-hot algorithm:

* a gather ``table[idx]``, zero rows for an id outside ``[0, S)``;
* a segment sum of rows into ``S`` segments, rows with an id outside
  ``[0, S)`` dropped;

each row-major (``onehot_gather``, ``onehot_scatter_add``) and dims-major,
with the edge axis last (``onehot_gather_t``, ``onehot_scatter_add_t``).
On Hopper they are the CUDA kernels of
``g2o_tpu_torch/csrc/gather_segment.cu`` (its header says what bounds them
and how they are laid out), built by
:func:`g2o_tpu_torch.ops.chol_kernels.build` and loaded with ``ctypes``:

* the row-major gather with a table of at most ~46 KB: the table and each
  tile's ids in shared memory, the output written as 16-byte stores;
  with a wider table: one thread per output element;
* the dims-major gather (K5/K10 on the three dims-major implicit paths):
  a thread per 16-byte group of edges (4 in float32, 2 in float64), their
  ids read once in one load and each output row written as one 16-byte
  store, the table staged in shared memory once per block; one thread per
  edge where N is not a multiple of the group or the ids or the output are
  not 16-byte aligned;
* the row-major segment sum with ``S·D <= ROWSUM_MAX_CELLS`` (K8 at the
  ladybug shape): one cooperative launch that sums in a fixed order (the
  same bits on every run) into per-block partials (a scratch the library
  keeps per stream for eager calls, and allocates per call in a CUDA
  graph), then across the blocks after a grid barrier; no memset, no
  global atomics, and no value kept between calls;
* the dims-major segment sum with ``S·D <= 65536`` and ``S <= 8192``
  (the kernel's ``SEGT_MAX_CELLS`` and ``SEGT_COUNTS``; K6/K9 on the three
  dims-major implicit paths): the same properties, one cooperative launch
  in which each block sums its rows in a fixed order (by column into
  per-warp accumulators where they fit, else sorted by id once and summed
  per (segment, column) cell on one thread), then across the blocks;
* every other segment sum: per-block shared accumulators flushed with
  atomics into the output, which a memset zeroes first.

On the solver's paths a call moves a megabyte or a few dozen, so the
wrappers keep their host work small: the entry points are bound once, the
stream handle is read as an int, and the device is switched only when the
tensors are not on the current one.  Beside each wrapper is its plain
PyTorch version (``*_plain``):

* on a CPU tensor the wrapper returns the plain version (the CPU tests run
  it);
* on a CUDA tensor it launches the kernel, or raises — it never falls back.
  The ids must then be int32.

Each wrapper counts its kernel launches in ``<wrapper>.launches``.
``precision`` is accepted for API parity with the JAX package and has no
effect: the sums are exact float32/float64 adds (no TF32, no bf16 passes).
"""

from __future__ import annotations

import ctypes
import math

import torch

from g2o_tpu_torch.ops.chol_kernels import _SUFFIX, build

_lib = None
_INT_MAX = 2**31 - 1
# (kind, dtype) -> the library's entry point; the current stream's handle
# as an int by device index (no Stream object) and the current device's
# index; all bound once by _load()
_FNS = {}
_raw_stream = _current_device = None
# the row-major segment sum with S*D <= ROWSUM_MAX_CELLS is one cooperative
# launch (the kernel's ROWSUM_MAX_CELLS, set by its shared memory);
# otherwise a memset and the kernel
ROWSUM_MAX_CELLS = 768


def _load():
    global _lib, _raw_stream, _current_device
    if _lib is None:
        lib = ctypes.CDLL(build("gather_segment")[0])
        vp, ci = ctypes.c_void_p, ctypes.c_int
        # table or values, ids, out, N, S, D, dims_major, stream
        for kind in ("gather", "scatter_add"):
            for dtype, suffix in _SUFFIX.items():
                fn = getattr(lib, f"g2o_{kind}_{suffix}")
                fn.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
                fn.restype = ci
                _FNS[kind, dtype] = fn
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) \
            or (lambda index: torch.cuda.current_stream(index).cuda_stream)
        _current_device = getattr(torch._C, "_cuda_getDevice", None) \
            or torch.cuda.current_device
        _lib = lib
    return _lib


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #

def _valid(idx, S):
    return (idx >= 0) & (idx < S)


def onehot_gather_plain(idx, table):
    """``table[idx]`` for ``table (S, D)`` and ``idx (N,)``: ``(N, D)``,
    zero rows where ``idx`` lies outside ``[0, S)``."""
    S = table.shape[0]
    keep = _valid(idx, S)
    rows = table.index_select(0, torch.where(keep, idx, 0).long()) if S else \
        table.new_zeros((idx.shape[0],) + tuple(table.shape[1:]))
    return torch.where(keep[:, None], rows, rows.new_zeros(()))


def onehot_gather_t_plain(idx, table):
    """Dims-major ``table[idx]``: ``table (S, D)`` -> ``(D, N)``."""
    return onehot_gather_plain(idx, table).T.contiguous()


def onehot_scatter_add_plain(idx, rows, n_seg: int):
    """``out[s] = Σ rows[i]`` over the ``i`` with ``idx[i] == s``: ``rows
    (N, D)`` -> ``(n_seg, D)``; rows with an id outside ``[0, n_seg)`` go
    to a spare row that is cut off."""
    S = int(n_seg)
    keep = _valid(idx, S)
    out = rows.new_zeros((S + 1,) + tuple(rows.shape[1:]))
    return out.index_add_(0, torch.where(keep, idx, S).long(), rows)[:S]


def onehot_scatter_add_t_plain(idx, rows_t, n_seg: int):
    """Dims-major segment sum: ``rows_t (D, N)`` -> ``(n_seg, D)``."""
    return onehot_scatter_add_plain(idx, rows_t.T, n_seg)


# --------------------------------------------------------------------------- #
# wrappers
# --------------------------------------------------------------------------- #

def _check(name, kind, src, idx, n_seg, dims_major):
    """Raise on CUDA inputs the kernels do not take."""
    if src.device.type != "cuda" or idx.device != src.device:
        raise ValueError(f"{name}: values on {src.device} and ids on "
                         f"{idx.device}; both must be on one CUDA device")
    if src.dtype not in _SUFFIX:
        raise TypeError(f"{name}: needs float32 or float64 values, got "
                        f"{src.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: needs int32 ids, got {idx.dtype}")
    if src.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"{name}: needs 2-d values and 1-d ids, got "
                         f"{tuple(src.shape)} and {tuple(idx.shape)}")
    if kind == "scatter_add":
        _check_rows(name, src, idx, dims_major)
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: needs contiguous tensors")


def _check_rows(name, src, idx, dims_major):
    n_rows = src.shape[1] if dims_major else src.shape[0]
    if idx.shape[0] != n_rows:
        raise ValueError(f"{name}: {idx.shape[0]} ids for {n_rows} rows")


def _launch(wrapper, kind, src, idx, n_seg, dims_major):
    """Check the CUDA inputs of ``wrapper``, launch ``g2o_<kind>_f32/_f64``
    on the tensors' device and its current stream, and count it; returns
    the output tensor.  ``src`` is the gather's ``(S, D)`` table or the
    segment sum's rows, ``(N, D)`` or, dims-major, ``(D, N)``.  The kernel
    writes every element of the output, so it is allocated empty.  The
    checks run in full, in order, only when the quick screen finds a fault,
    so a fault gets the same message as before."""
    if not (src.is_cuda and idx.dtype is torch.int32
            and src.dtype in _SUFFIX and src.dim() == 2 and idx.dim() == 1
            and src.is_contiguous() and idx.is_contiguous()
            and idx.get_device() == src.get_device()):
        _check(wrapper.__name__, kind, src, idx, n_seg, dims_major)
    n_rows = idx.shape[0]
    if kind == "gather":
        S, D = src.shape
        shape = (D, n_rows) if dims_major else (n_rows, D)
    else:
        D, n = src.shape if dims_major else src.shape[::-1]
        if n != n_rows:
            _check_rows(wrapper.__name__, src, idx, dims_major)
        S = int(n_seg)
        shape = (S, D)
    if n_rows * D > _INT_MAX or S * D > _INT_MAX:
        raise ValueError(f"{wrapper.__name__}: {n_rows} rows x {D} or {S} "
                         f"segments x {D} exceed 2^31 elements")
    out = src.new_empty(shape)
    if n_rows == 0 or D == 0 or S == 0:
        return out.zero_()
    if not _FNS:
        _load()
    index = src.get_device()
    stream = _raw_stream(index)
    fn = _FNS[kind, src.dtype]
    args = (src.data_ptr(), idx.data_ptr(), out.data_ptr(), n_rows, S, D,
            dims_major, stream)
    if index == _current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err:
        raise RuntimeError(f"{wrapper.__name__} kernel failed: CUDA error "
                           f"{err}")
    wrapper.launches += 1
    return out


def _flat(x):
    """``(n, ...) -> (n, prod(...))`` (also for n = 0); a 2-d ``x`` as it
    is."""
    return x if x.dim() == 2 else x.reshape(x.shape[0],
                                            math.prod(x.shape[1:]))


def _on_cpu(a, b):
    return a.is_cpu and b.is_cpu


def onehot_gather(idx, table, precision=None):
    """``table[idx]``: ``(S, ...) -> (N, ...)``, zero rows for ids outside
    ``[0, S)``.  The gather kernel (row-major) on CUDA tensors, the plain
    version on CPU tensors."""
    flat = _flat(table)
    if _on_cpu(idx, flat):
        out = onehot_gather_plain(idx, flat)
    else:
        out = _launch(onehot_gather, "gather", flat, idx, None, False)
    return out if flat is table else out.reshape(
        (idx.shape[0],) + tuple(table.shape[1:]))


def onehot_gather_t(idx, table, precision=None):
    """Dims-major gather: ``table (S, D)`` -> ``(D, N)``, the rows of
    ``table[idx]`` with the edge axis last."""
    flat = _flat(table)
    if _on_cpu(idx, flat):
        return onehot_gather_t_plain(idx, flat)
    return _launch(onehot_gather_t, "gather", flat, idx, None, True)


def onehot_scatter_add(idx, rows, n_seg: int, precision=None):
    """Sum ``rows[i]`` into segment ``idx[i]``: ``(N, ...) -> (n_seg,
    ...)``, rows with ids outside ``[0, n_seg)`` dropped.  The segment-sum
    kernel (row-major) on CUDA tensors, the plain version on CPU tensors."""
    flat = _flat(rows)
    if _on_cpu(idx, flat):
        out = onehot_scatter_add_plain(idx, flat, n_seg)
    else:
        out = _launch(onehot_scatter_add, "scatter_add", flat, idx, n_seg,
                      False)
    return out if flat is rows else out.reshape(
        (int(n_seg),) + tuple(rows.shape[1:]))


def onehot_scatter_add_t(idx, rows_t, n_seg: int, precision=None):
    """Dims-major segment sum: ``rows_t (D, N)`` -> ``(n_seg, D)``."""
    if _on_cpu(idx, rows_t):
        return onehot_scatter_add_t_plain(idx, rows_t, n_seg)
    return _launch(onehot_scatter_add_t, "scatter_add", rows_t, idx, n_seg,
                   True)


onehot_gather.launches = 0
onehot_gather_t.launches = 0
onehot_scatter_add.launches = 0
onehot_scatter_add_t.launches = 0
