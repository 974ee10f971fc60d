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
  atomics into the output, which a memset zeroes first.  Every dims-major
  camera sum of a BAL problem with more than 8192 cameras (Final-13682's
  13,682) takes it, so its bits vary from run to run.

Beside them, ``schur_rows_t``: the Schur term of the dims-major implicit
Schur product ``S·v``, ``Σ_rows B_row Dinv_k Σ_j B_jᵀ v[cam_j]`` per
camera, one cooperative launch (``g2o_schur_rows_*``) that replaces no
Pallas kernel: it fuses K5's gather, the PyTorch products around it and
K6's segment sum.  It is bound by bytes: ``Bt`` is read once per call and
nothing of the edge axis is written; the kernel's note says how its
blocks keep every intermediate in registers and shared memory and sum in
a fixed order.  Its blocks hold the ``(C, dp)`` camera sums in shared
memory (``schur_rows_fits``: C <= 5915 at dp = 9 in float32); past that,
``schur_rows_tiled_t`` runs its tiled form, one cooperative launch
(``g2o_schur_rows_tiled_*``): each row's ``B s`` is stored and, after a
grid barrier, each camera's rows, gathered in camera order
(``schur_rows_order``, made once per problem), are summed in a fixed
order, so it too gives the same bits on every run.

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

from g2o_tpu_torch.ops.bucketed import slab_broadcast_t, slab_sum_t
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
# the Schur rows kernel's constants (gather_segment.cu: its template
# instances' (camera, landmark) tangent widths, SROWS_MAX_BUCKETS,
# SROWS_THREADS, SROWS_WLD, SROWS_SMEM): a block's shared memory holds its
# (C, dp) sums beside the slot and round buffers of its threads
SCHUR_ROWS_WIDTHS = ((9, 3), (6, 3))
SCHUR_ROWS_MAX_BUCKETS = 16
SCHUR_ROWS_THREADS = 256
SCHUR_ROWS_WLD = SCHUR_ROWS_THREADS + 1
SCHUR_ROWS_SMEM = 224 * 1024


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
        # Bt and its two outer strides, ids, Dinv and its three strides, v,
        # C, out, N, dp, dl, buckets, counts, degrees, stream
        cl, ip = ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)
        for dtype, suffix in _SUFFIX.items():
            fn = getattr(lib, f"g2o_schur_rows_{suffix}")
            fn.argtypes = [vp, cl, cl, vp, vp, cl, cl, cl, vp, ci, vp, ci, ci,
                           ci, ci, ip, ip, vp]
            fn.restype = ci
            _FNS["schur_rows", dtype] = fn
        # the tiled form: the same, then the rows in camera order, the
        # cameras' first places in it, the rows' scratch
        for dtype, suffix in _SUFFIX.items():
            fn = getattr(lib, f"g2o_schur_rows_tiled_{suffix}")
            fn.argtypes = [vp, cl, cl, vp, vp, cl, cl, cl, vp, ci, vp, ci, ci,
                           ci, ci, ip, ip, vp, vp, vp, vp]
            fn.restype = ci
            _FNS["schur_rows_tiled", dtype] = fn
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


def schur_rows_t_plain(counts, degrees, Bt, idx, DinvT, v,
                       gather=onehot_gather_t_plain,
                       scatter_add=onehot_scatter_add_t_plain):
    """The Schur term of the dims-major Schur product per camera: ``Bt
    (dp, dl, N)`` in slab order (the buckets' ``counts`` and ``degrees``),
    camera ids ``idx (N,)``, ``DinvT (dl, dl, S_used)`` in bucket order and
    ``v (C, dp)`` -> ``(C, dp)``, the sum over each camera's rows of
    ``B_row s_k`` with ``s_k = Dinv_k Σ_j B_jᵀ v[idx_j]`` over the rows of
    the row's landmark ``k`` (rows with an id outside ``[0, C)`` dropped):
    the gather, ``Bᵀu`` summed per row, the slab sums, ``Dinv``, the slab
    broadcast, ``B s`` summed per row and the segment sum.  ``gather`` and
    ``scatter_add`` take the dims-major gather's and segment sum's
    arguments (:func:`onehot_gather_t`, :func:`onehot_scatter_add_t` give
    the composition the kernel replaces)."""
    ut = gather(idx, v)
    t = slab_sum_t(counts, degrees, torch.sum(Bt * ut[:, None, :], dim=0))
    s = torch.sum(DinvT * t[None], dim=1)
    rows = torch.sum(Bt * slab_broadcast_t(counts, degrees, s)[None], dim=1)
    return scatter_add(idx, rows, v.shape[0])


def schur_rows_order(idx, n_cam: int):
    """``(order, starts)`` for the tiled form of the Schur rows kernel: the
    rows sorted by camera id, stably (a camera's rows keep their slab
    order), and each camera's first place in that order, ``starts[n_cam]``
    one past the last; int32.  A problem's ids are fixed, so its solver
    computes this once."""
    key, order = torch.sort(idx, stable=True)
    starts = torch.searchsorted(key, torch.arange(
        int(n_cam) + 1, dtype=key.dtype, device=key.device), out_int32=True)
    return order.to(torch.int32), starts


def schur_rows_tiled_fits(n_cam, dp, dl, dtype):
    """Whether the tiled form of the Schur rows kernel takes ``n_cam``
    cameras of width ``dp`` beside landmarks of width ``dl`` in ``dtype``:
    the kernel's widths; its camera sums leave shared memory, so any camera
    count within int32 indexing."""
    return ((dp, dl) in SCHUR_ROWS_WIDTHS and dtype in _SUFFIX
            and 1 <= n_cam and (n_cam + 1) * dp <= _INT_MAX)


def schur_rows_fits(n_cam, dp, dl, dtype):
    """Whether the Schur rows kernel takes ``n_cam`` cameras of width
    ``dp`` beside landmarks of width ``dl`` in ``dtype``: its widths, and
    its blocks' per-camera sums within their shared memory (the kernel's
    own formula)."""
    if (dp, dl) not in SCHUR_ROWS_WIDTHS or dtype not in _SUFFIX or \
            n_cam < 1:
        return False
    size = 4 if dtype == torch.float32 else 8
    return ((n_cam * dp + 2 * dl * SCHUR_ROWS_THREADS + dp * SCHUR_ROWS_WLD)
            * size + SCHUR_ROWS_THREADS * 4 <= SCHUR_ROWS_SMEM)


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


def _check_schur_rows(counts, degrees, Bt, idx, DinvT, v,
                      name="schur_rows_t", fits=schur_rows_fits):
    """Raise on CUDA inputs the Schur rows kernel (``fits``: its camera
    test) does not take."""
    if not (Bt.is_cuda and idx.device == Bt.device
            and DinvT.device == Bt.device and v.device == Bt.device):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    if Bt.dtype not in _SUFFIX or DinvT.dtype != Bt.dtype or \
            v.dtype != Bt.dtype:
        raise TypeError(f"{name}: needs float32 or float64 values of one "
                        f"type, got {Bt.dtype}, {DinvT.dtype}, {v.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: needs int32 ids, got {idx.dtype}")
    if Bt.dim() != 3 or idx.dim() != 1 or DinvT.dim() != 3 or v.dim() != 2:
        raise ValueError(f"{name}: needs Bt (dp, dl, N), ids (N,), DinvT "
                         f"(dl, dl, S) and v (C, dp)")
    dp, dl, n = Bt.shape
    if not fits(v.shape[0], dp, dl, Bt.dtype):
        raise ValueError(f"{name}: no kernel for widths (dp, dl) = "
                         f"{(dp, dl)} and {v.shape[0]} cameras in "
                         f"{Bt.dtype}; it takes {SCHUR_ROWS_WIDTHS} (the "
                         f"shared-memory form: within {SCHUR_ROWS_SMEM} "
                         f"bytes of block sums)")
    if Bt.stride(2) != 1 or not (idx.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: needs contiguous ids and v and Bt "
                         f"contiguous along its edge axis")
    if not 0 < len(counts) <= SCHUR_ROWS_MAX_BUCKETS or \
            len(degrees) != len(counts):
        raise ValueError(f"{name}: needs 1 to {SCHUR_ROWS_MAX_BUCKETS} "
                         f"buckets, got {len(counts)} counts and "
                         f"{len(degrees)} degrees")
    slab_rows = sum(c * d for c, d in zip(counts, degrees))
    if idx.shape[0] != n or n != slab_rows:
        raise ValueError(f"{name}: {idx.shape[0]} ids and {n} rows of Bt "
                         f"for slabs of {slab_rows} rows")
    if tuple(DinvT.shape) != (dl, dl, sum(counts)) or v.shape[1] != dp:
        raise ValueError(f"{name}: DinvT {tuple(DinvT.shape)} and v "
                         f"{tuple(v.shape)} do not fit Bt {tuple(Bt.shape)} "
                         f"and {sum(counts)} landmarks")
    if n * dp * dl > _INT_MAX:
        raise ValueError(f"{name}: {n} rows exceed the kernel's int indexing")


def _launch_schur_rows(wrapper, kind, counts, degrees, Bt, idx, DinvT, v,
                       *extra):
    """Launch ``g2o_<kind>_f32/_f64`` on checked CUDA inputs (``extra``: the
    tiled form's pointers) on their device's current stream, and count it
    in ``wrapper.launches``; returns the ``(C, dp)`` output."""
    dp, dl, n = Bt.shape
    out = v.new_empty(v.shape)
    if n == 0:
        return out.zero_()
    if not _FNS:
        _load()
    index = Bt.get_device()
    fn = _FNS[kind, Bt.dtype]
    args = (Bt.data_ptr(), Bt.stride(0), Bt.stride(1), idx.data_ptr(),
            DinvT.data_ptr(), *DinvT.stride(), v.data_ptr(), v.shape[0],
            out.data_ptr(), n, dp, dl, len(counts),
            (ctypes.c_int * len(counts))(*counts),
            (ctypes.c_int * len(degrees))(*degrees), *extra,
            _raw_stream(index))
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


def schur_rows_t(counts, degrees, Bt, idx, DinvT, v):
    """The Schur term of the dims-major Schur product per camera, ``(C,
    dp)`` (see :func:`schur_rows_t_plain`): one launch of the Schur rows
    kernel on CUDA tensors, the plain version on CPU tensors.  ``counts``
    and ``degrees`` are sequences of ints; ``Bt`` may be a view of the first
    ``N`` rows of a wider batch (its edge axis contiguous), ``DinvT`` any
    strided view."""
    if Bt.is_cpu and idx.is_cpu and DinvT.is_cpu and v.is_cpu:
        return schur_rows_t_plain(counts, degrees, Bt, idx, DinvT, v)
    _check_schur_rows(counts, degrees, Bt, idx, DinvT, v)
    return _launch_schur_rows(schur_rows_t, "schur_rows", counts, degrees,
                              Bt, idx, DinvT, v)


def schur_rows_tiled_t(counts, degrees, Bt, idx, DinvT, v, order):
    """The Schur term of :func:`schur_rows_t` past the shared-memory camera
    cap (:func:`schur_rows_fits` false), ``(C, dp)``: on CUDA tensors one
    cooperative launch of the kernel's tiled form (each row's ``B s``
    stored, then each camera's rows gathered and summed in a fixed order),
    the plain version on CPU tensors.  ``order`` is
    :func:`schur_rows_order` of ``idx``."""
    if Bt.is_cpu and idx.is_cpu and DinvT.is_cpu and v.is_cpu:
        return schur_rows_t_plain(counts, degrees, Bt, idx, DinvT, v)
    name = "schur_rows_tiled_t"
    _check_schur_rows(counts, degrees, Bt, idx, DinvT, v, name,
                      schur_rows_tiled_fits)
    rows_by_cam, starts = order
    dp, dl, n = Bt.shape
    if not (rows_by_cam.dtype == starts.dtype == torch.int32
            and rows_by_cam.device == starts.device == Bt.device
            and rows_by_cam.is_contiguous() and starts.is_contiguous()
            and tuple(rows_by_cam.shape) == (n,)
            and tuple(starts.shape) == (v.shape[0] + 1,)):
        raise ValueError(f"{name}: needs the order of its {n} rows over "
                         f"{v.shape[0]} cameras (schur_rows_order), int32 "
                         f"and contiguous on {Bt.device}")
    # each row's B s, padded to whole 16-byte stores
    vec = 16 // Bt.element_size()
    rows = Bt.new_empty((n, -(-dp // vec) * vec))
    return _launch_schur_rows(schur_rows_tiled_t, "schur_rows_tiled", counts,
                              degrees, Bt, idx, DinvT, v,
                              rows_by_cam.data_ptr(), starts.data_ptr(),
                              rows.data_ptr())


onehot_gather.launches = 0
onehot_gather_t.launches = 0
onehot_scatter_add.launches = 0
onehot_scatter_add_t.launches = 0
schur_rows_t.launches = 0
schur_rows_tiled_t.launches = 0
