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
On Hopper they are two CUDA kernels, ``g2o_tpu_torch/csrc/gather_segment.cu``
(its header says what bounds them and how they are laid out), built by
:func:`g2o_tpu_torch.ops.chol_kernels.build` and loaded with ``ctypes``.
Beside each wrapper is its plain PyTorch version (``*_plain``):

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


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build("gather_segment")[0])
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for name in ("g2o_gather_f32", "g2o_gather_f64",
                     "g2o_scatter_add_f32", "g2o_scatter_add_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
            fn.restype = ci
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

def _launch(wrapper, kind, src, idx, n_seg, dims_major):
    """Check the CUDA inputs of ``wrapper``, launch ``g2o_<kind>_f32/_f64``
    and count it; returns the output tensor.  ``src`` is the gather's
    ``(S, D)`` table or the segment sum's rows, ``(N, D)`` or, dims-major,
    ``(D, N)``."""
    name = wrapper.__name__
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
    if kind == "gather":
        (S, D), n_rows = src.shape, idx.shape[0]
    else:
        S = int(n_seg)
        D, n_rows = src.shape if dims_major else src.shape[::-1]
        if idx.shape[0] != n_rows:
            raise ValueError(f"{name}: {idx.shape[0]} ids for {n_rows} rows")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name}: needs contiguous tensors")
    if n_rows * D > _INT_MAX or S * D > _INT_MAX:
        raise ValueError(f"{name}: {n_rows} rows x {D} or {S} segments x {D} "
                         f"exceed 2^31 elements")
    if kind == "gather":
        shape = (D, n_rows) if dims_major else (n_rows, D)
        out = torch.empty(shape, dtype=src.dtype, device=src.device)
    else:
        out = torch.zeros((S, D), dtype=src.dtype, device=src.device)
    if n_rows == 0 or D == 0 or S == 0:
        return out.zero_()
    fn = getattr(_load(), f"g2o_{kind}_{_SUFFIX[src.dtype]}")
    with torch.cuda.device(src.device):
        err = fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(), n_rows, S, D,
                 int(dims_major),
                 torch.cuda.current_stream(src.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel failed: CUDA error {err}")
    wrapper.launches += 1
    return out


def _flat(x):
    """``(n, ...) -> (n, prod(...))`` (also for n = 0)."""
    return x.reshape(x.shape[0], math.prod(x.shape[1:]))


def _on_cpu(*tensors):
    return all(t.device.type == "cpu" for t in tensors)


def onehot_gather(idx, table, precision=None):
    """``table[idx]``: ``(S, ...) -> (N, ...)``, zero rows for ids outside
    ``[0, S)``.  The gather kernel (row-major) on CUDA tensors, the plain
    version on CPU tensors."""
    flat = _flat(table)
    if _on_cpu(idx, flat):
        out = onehot_gather_plain(idx, flat)
    else:
        out = _launch(onehot_gather, "gather", flat, idx, None, False)
    return out.reshape((idx.shape[0],) + tuple(table.shape[1:]))


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
    return out.reshape((int(n_seg),) + tuple(rows.shape[1:]))


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
