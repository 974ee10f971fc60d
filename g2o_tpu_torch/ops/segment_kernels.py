"""Segment sum (K4) — the Hopper port of ``g2o_tpu/ops/pallas_kernels.py::
segment_sum_mxu``, the pair aggregation of the explicit Schur solver.

The kernel is CUDA C++ in ``g2o_tpu_torch/csrc/segment_sum.cu`` (its header
says what bounds it and how it is laid out), built by
:func:`g2o_tpu_torch.ops.chol_kernels.build` and loaded with ``ctypes``.
Beside the wrapper is its plain PyTorch version:

* on a CPU tensor the wrapper returns the plain version (the CPU tests run
  it);
* on a CUDA tensor it launches the kernel, or raises — it never falls back.

The wrapper counts its kernel launches in ``segment_sum.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from g2o_tpu_torch.ops.chol_kernels import _SUFFIX, build

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build("segment_sum")[0])
        vp = ctypes.c_void_p
        for name in ("g2o_segment_sum_f32", "g2o_segment_sum_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, vp]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def segment_sum_plain(values, seg_ids, num_segments: int):
    """``out[s] = Σ values[i]`` over the rows ``i`` with ``seg_ids[i] == s``,
    ``(N, D) -> (num_segments, D)``.  Rows whose id lies outside
    ``[0, num_segments)`` are dropped (sent to a spare row that is cut off);
    empty segments are zero."""
    S = int(num_segments)
    keep = (seg_ids >= 0) & (seg_ids < S)
    idx = torch.where(keep, seg_ids, S)
    out = values.new_zeros((S + 1,) + tuple(values.shape[1:]))
    return out.index_add_(0, idx, values)[:S]


def segment_sum(values, seg_ids, num_segments: int):
    """Segment sum of ``values (N, D)`` by ``seg_ids (N,)`` into
    ``(num_segments, D)``: the CUDA kernel on CUDA tensors (``seg_ids``
    int32), the plain version on CPU tensors."""
    if values.device.type == "cpu" and seg_ids.device.type == "cpu":
        return segment_sum_plain(values, seg_ids, num_segments)
    if values.device.type != "cuda" or seg_ids.device != values.device:
        raise ValueError(f"segment_sum: values on {values.device} and ids on "
                         f"{seg_ids.device}; both must be on one CUDA device")
    if values.dtype not in _SUFFIX:
        raise TypeError(f"segment_sum: needs float32 or float64 values, got "
                        f"{values.dtype}")
    if seg_ids.dtype != torch.int32:
        raise TypeError(f"segment_sum: needs int32 ids, got {seg_ids.dtype}")
    if values.dim() != 2 or seg_ids.dim() != 1 \
            or seg_ids.shape[0] != values.shape[0]:
        raise ValueError(f"segment_sum: needs values (N, D) and ids (N,), got "
                         f"{tuple(values.shape)} and {tuple(seg_ids.shape)}")
    if not (values.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("segment_sum: needs contiguous tensors")
    N, D = values.shape
    S = int(num_segments)
    if S < 0 or S > 2**31 - 1 or D > 2**31 - 1:
        raise ValueError(f"segment_sum: {S} segments of width {D} out of "
                         f"range")
    out = torch.zeros((S, D), dtype=values.dtype, device=values.device)
    if N == 0 or D == 0 or S == 0:
        return out
    fn = getattr(_load(), f"g2o_segment_sum_{_SUFFIX[values.dtype]}")
    with torch.cuda.device(values.device):
        err = fn(values.data_ptr(), seg_ids.data_ptr(), out.data_ptr(), N, D,
                 S, torch.cuda.current_stream(values.device).cuda_stream)
    if err:
        raise RuntimeError(f"segment_sum kernel failed: CUDA error {err}")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
