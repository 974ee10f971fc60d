"""K4's plain version against the Pallas kernel it replaces.

``segment_sum_plain`` (and the wrapper, which runs it on CPU tensors) is
held to ``g2o_tpu.ops.pallas_kernels.segment_sum_mxu`` in interpret mode,
as ``tests/test_pallas.py`` runs it, at that file's shapes plus
out-of-range ids, empty segments, unsorted ids and float64.  Tolerances:
1e-4 absolute in float32 (the bound of ``test_pallas.py``: the two sum in
different orders) and 1e-12 in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2o_tpu.ops.pallas_kernels import segment_sum_mxu
from g2o_tpu_torch.ops import segment_kernels as sk

TOL = {np.float32: 1e-4, np.float64: 1e-12}


def _both(vals, seg, s):
    want = np.asarray(segment_sum_mxu(jnp.asarray(vals), jnp.asarray(seg), s,
                                      interpret=True))
    got = sk.segment_sum(torch.as_tensor(vals), torch.as_tensor(seg), s)
    return got.numpy(), want


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,d,s", [(1000, 81, 37), (5000, 16, 300),
                                   (100, 128, 8), (7, 4, 2), (3000, 81, 400)])
def test_plain_matches_pallas(n, d, s, dtype):
    rng = np.random.default_rng(n)
    vals = rng.normal(size=(n, d)).astype(dtype)
    seg = rng.integers(0, s, size=n).astype(np.int32)
    got, want = _both(vals, seg, s)
    assert got.dtype == dtype and got.shape == (s, d)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_out_of_range_ids_are_dropped(dtype):
    """Negative ids and ids >= S match no segment, in both versions."""
    rng = np.random.default_rng(7)
    n, d, s = 700, 9, 37
    vals = rng.normal(size=(n, d)).astype(dtype)
    seg = rng.integers(-3, s + 5, size=n).astype(np.int32)
    got, want = _both(vals, seg, s)
    keep = (seg >= 0) & (seg < s)
    ref = np.zeros((s, d), dtype)
    np.add.at(ref, seg[keep], vals[keep])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL[dtype])


def test_empty_segments_are_zero():
    vals = np.ones((10, 3), np.float32)
    seg = np.zeros(10, np.int32)
    got, want = _both(vals, seg, 5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], 10.0)
    np.testing.assert_array_equal(got[1:], 0.0)


def test_sorted_and_unsorted_ids_agree():
    """The Schur solver sorts its pairs by segment; the sum does not depend
    on the order (float64, to summation-order rounding)."""
    rng = np.random.default_rng(11)
    n, d, s = 4000, 81, 50
    vals = torch.as_tensor(rng.normal(size=(n, d)))
    seg = torch.as_tensor(rng.integers(0, s, size=n).astype(np.int32))
    order = torch.argsort(seg, stable=True)
    a = sk.segment_sum(vals, seg, s)
    b = sk.segment_sum(vals[order], seg[order], s)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)


def test_int64_ids_and_empty_input_on_cpu():
    vals = torch.arange(12, dtype=torch.float64).reshape(4, 3)
    seg = torch.tensor([2, 0, 2, 9])
    out = sk.segment_sum(vals, seg, 3)
    np.testing.assert_array_equal(out.numpy(), [[3, 4, 5], [0, 0, 0],
                                                [6, 8, 10]])
    assert sk.segment_sum(vals[:0], seg[:0], 3).shape == (3, 3)


def test_cpu_tensors_take_the_plain_version():
    before = sk.segment_sum.launches
    vals = torch.ones((5, 2), dtype=torch.float32)
    sk.segment_sum(vals, torch.zeros(5, dtype=torch.int32), 2)
    assert sk.segment_sum.launches == before


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="CUDA"):
        sk.segment_sum(torch.zeros((4, 2), device="meta"),
                       torch.zeros(4, dtype=torch.int32, device="meta"), 2)
