"""The gather and segment sum of ``g2o_tpu_torch.ops.onehot`` against the
six Pallas kernels they replace (K5–K10 of
``scripts/pallas_onehot_experimental.py``, run in interpret mode as
``tests/test_pallas.py`` runs them) and against the JAX package's one-hot
forms (``g2o_tpu/ops/onehot.py``), on the CPU, where each wrapper runs its
plain version.

Ids cover both out-of-range sides: gathers give zero rows there and
segment sums drop the row.  Tolerances: float32 atol 1e-6 for the gathers
and 1e-4 for the sums (the bounds of ``test_pallas.py``: a one-hot product
and an ``index_add_`` sum in different orders), float64 rtol 1e-12."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2o_tpu.ops import onehot as jonehot
from g2o_tpu_torch.ops import onehot

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
from pallas_onehot_experimental import (gather_mxu_rows,  # noqa: E402
                                        gather_t_mxu, gather_t_mxu2,
                                        segment_sum_rows_mxu,
                                        segment_sum_t_mxu,
                                        segment_sum_t_mxu2)

HI = jax.lax.Precision.HIGHEST
N, S, D = 700, 37, 5                    # the test_pallas.py shape

# kernel id -> (Pallas call on (idx, table, rows) in JAX arrays, port
# wrapper on torch tensors, gather?)
KERNELS = {
    "K5": (lambda i, t, r: gather_t_mxu(i, t, precision=HI, interpret=True),
           lambda i, t, r: onehot.onehot_gather_t(i, t), True),
    "K7": (lambda i, t, r: gather_mxu_rows(i, t, precision=HI,
                                           interpret=True),
           lambda i, t, r: onehot.onehot_gather(i, t), True),
    "K10": (lambda i, t, r: gather_t_mxu2(i, t, precision=HI, block=128,
                                          interpret=True),
            lambda i, t, r: onehot.onehot_gather_t(i, t), True),
    "K6": (lambda i, t, r: segment_sum_t_mxu(i, r.T, S, precision=HI,
                                             interpret=True),
           lambda i, t, r: onehot.onehot_scatter_add_t(i, r.T.contiguous(),
                                                       S), False),
    "K8": (lambda i, t, r: segment_sum_rows_mxu(i, r, S, precision=HI,
                                                interpret=True),
           lambda i, t, r: onehot.onehot_scatter_add(i, r, S), False),
    "K9": (lambda i, t, r: segment_sum_t_mxu2(i, r.T, S, precision=HI,
                                              block=128, interpret=True),
           lambda i, t, r: onehot.onehot_scatter_add_t(i, r.T.contiguous(),
                                                       S), False),
}


def _inputs(dtype, lo, hi, seed=0, n=N, s=S, d=D):
    rng = np.random.default_rng(seed)
    idx = rng.integers(lo, hi, size=n).astype(np.int32)
    table = rng.standard_normal((s, d)).astype(dtype)
    rows = rng.standard_normal((n, d)).astype(dtype)
    return idx, table, rows


def _reference(idx, table, rows):
    """numpy: the gather (zero rows out of range) and the segment sum
    (out-of-range rows dropped)."""
    s = table.shape[0]
    valid = (idx >= 0) & (idx < s)
    gather = np.where(valid[:, None], table[np.clip(idx, 0, s - 1)], 0.0)
    ssum = np.zeros_like(table)
    np.add.at(ssum, idx[valid], rows[valid])
    return gather, ssum


def _assert_close(got, want, dtype, gather):
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 if gather else 1e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("lo,hi", [(0, S + 3), (-3, S + 5)])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_plain_matches_pallas_kernel(kernel, lo, hi, dtype):
    pallas, port, gather = KERNELS[kernel]
    idx, table, rows = _inputs(dtype, lo, hi, seed=hi)
    want = np.asarray(pallas(jnp.asarray(idx), jnp.asarray(table),
                             jnp.asarray(rows)))
    got = port(torch.as_tensor(idx), torch.as_tensor(table),
               torch.as_tensor(rows)).numpy()
    assert got.shape == want.shape and got.dtype == dtype
    _assert_close(got, want, dtype, gather)
    ref_g, ref_s = _reference(idx, table, rows)
    ref = ref_g if gather else ref_s
    if kernel in ("K5", "K10"):
        ref = ref.T
    _assert_close(got, ref, dtype, gather)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kernel", ["K6", "K9"])
def test_dims_major_sum_of_camera_blocks_out_of_range(kernel, dtype):
    """The dims-major segment sum at the camera blocks' width, D = 81, with
    ids on both sides of [0, S): the wrapper against K6/K9 in interpret
    mode and against numpy."""
    s, d = 49, 81
    idx, table, rows = _inputs(dtype, -3, s + 5, seed=81, s=s, d=d)
    # KERNELS' calls take the module's S: call the kernels with this S
    if kernel == "K6":
        want = segment_sum_t_mxu(jnp.asarray(idx), jnp.asarray(rows.T), s,
                                 precision=HI, interpret=True)
    else:
        want = segment_sum_t_mxu2(jnp.asarray(idx), jnp.asarray(rows.T), s,
                                  precision=HI, block=128, interpret=True)
    got = onehot.onehot_scatter_add_t(torch.as_tensor(idx),
                                      torch.as_tensor(rows.T.copy()), s)
    assert tuple(got.shape) == (s, d) and got.dtype == torch.from_numpy(
        rows).dtype
    _assert_close(got.numpy(), np.asarray(want), dtype, False)
    _assert_close(got.numpy(), _reference(idx, table, rows)[1], dtype, False)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [701, 702, 703])
@pytest.mark.parametrize("kernel", ["K5", "K10"])
def test_dims_major_gather_ragged_n_out_of_range(kernel, n, dtype):
    """The dims-major gather at an N that is not a multiple of 4 (nor, at
    701 and 703, of 2: the kernel's scalar branch on the card), at the
    camera width D = 9 and with ids on both sides of [0, S): the wrapper
    against K5/K10 in interpret mode and against numpy."""
    s, d = 49, 9
    idx, table, rows = _inputs(dtype, -3, s + 5, seed=n, n=n, s=s, d=d)
    if kernel == "K5":
        want = gather_t_mxu(jnp.asarray(idx), jnp.asarray(table),
                            precision=HI, interpret=True)
    else:
        want = gather_t_mxu2(jnp.asarray(idx), jnp.asarray(table),
                             precision=HI, block=128, interpret=True)
    got = onehot.onehot_gather_t(torch.as_tensor(idx), torch.as_tensor(table))
    assert tuple(got.shape) == (d, n) and got.dtype == torch.from_numpy(
        table).dtype
    _assert_close(got.numpy(), np.asarray(want), dtype, True)
    _assert_close(got.numpy(), _reference(idx, table, rows)[0].T, dtype,
                  True)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wrappers_match_jax_onehot_forms(dtype):
    """The four wrappers against ``g2o_tpu.ops.onehot`` (the XLA one-hot
    products), multi-dimensional rows included."""
    rng = np.random.default_rng(5)
    n, s = 400, 23
    idx = rng.integers(-2, s + 2, size=n).astype(np.int32)
    table = rng.standard_normal((s, 3, 3)).astype(dtype)
    rows = rng.standard_normal((n, 3, 3)).astype(dtype)
    ji, ti = jnp.asarray(idx), torch.as_tensor(idx)
    pairs = [
        (onehot.onehot_gather(ti, torch.as_tensor(table)),
         jonehot.onehot_gather(ji, jnp.asarray(table)), True),
        (onehot.onehot_scatter_add(ti, torch.as_tensor(rows), s),
         jonehot.onehot_scatter_add(ji, jnp.asarray(rows), s), False),
        (onehot.onehot_gather_t(ti, torch.as_tensor(table[:, 0])),
         jonehot.onehot_gather_t(ji, jnp.asarray(table[:, 0])), True),
        (onehot.onehot_scatter_add_t(
            ti, torch.as_tensor(rows[:, 0].T.copy()), s),
         jonehot.onehot_scatter_add_t(ji, jnp.asarray(rows[:, 0].T), s),
         False),
    ]
    for got, want, gather in pairs:
        assert tuple(got.shape) == want.shape
        _assert_close(got.numpy(), np.asarray(want), dtype, gather)


@pytest.mark.parametrize("d", [1, 9, 81])
def test_int64_ids_and_widths(d):
    """int64 ids (the CPU route takes either) and the solver's widths."""
    idx, table, rows = _inputs(np.float64, -1, 13, seed=d, n=90, s=12, d=d)
    ref_g, ref_s = _reference(idx, table, rows)
    i64 = torch.as_tensor(idx.astype(np.int64))
    np.testing.assert_array_equal(
        onehot.onehot_gather(i64, torch.as_tensor(table)).numpy(), ref_g)
    np.testing.assert_allclose(
        onehot.onehot_scatter_add(i64, torch.as_tensor(rows), 12).numpy(),
        ref_s, rtol=1e-12, atol=1e-12)


def test_empty_inputs():
    ids = torch.zeros(0, dtype=torch.int32)
    table = torch.ones((4, 3))
    assert onehot.onehot_gather(ids, table).shape == (0, 3)
    assert onehot.onehot_gather_t(ids, table).shape == (3, 0)
    assert torch.equal(onehot.onehot_scatter_add(ids, torch.ones((0, 3)), 4),
                       torch.zeros((4, 3)))
    assert torch.equal(
        onehot.onehot_scatter_add_t(ids, torch.ones((3, 0)), 4),
        torch.zeros((4, 3)))
    # no segments: every gathered row is out of range
    out = onehot.onehot_gather(torch.zeros(2, dtype=torch.int32),
                               torch.ones((0, 3)))
    assert torch.equal(out, torch.zeros((2, 3)))


def test_gather_zeroes_non_finite_rows_out_of_range_only():
    table = torch.tensor([[1.0, float("nan")], [2.0, 3.0]])
    out = onehot.onehot_gather(torch.tensor([1, 2, -1], dtype=torch.int32),
                               table)
    assert torch.equal(out, torch.tensor([[2.0, 3.0], [0.0, 0.0],
                                          [0.0, 0.0]]))


def test_cpu_tensors_take_the_plain_version():
    wrappers = (onehot.onehot_gather, onehot.onehot_gather_t,
                onehot.onehot_scatter_add, onehot.onehot_scatter_add_t)
    before = [w.launches for w in wrappers]
    idx, table, rows = (torch.as_tensor(a) for a in _inputs(np.float32, 0,
                                                             S))
    a = onehot.onehot_gather(idx, table, precision="highest")
    b = onehot.onehot_gather_t(idx, table, precision=None)
    c = onehot.onehot_scatter_add(idx, rows, S, precision="default")
    d = onehot.onehot_scatter_add_t(idx, rows.T.contiguous(), S)
    assert [w.launches for w in wrappers] == before
    assert torch.equal(a, onehot.onehot_gather_plain(idx, table))
    assert torch.equal(b, a.T)
    assert torch.equal(d, onehot.onehot_scatter_add_t_plain(
        idx, rows.T.contiguous(), S))
    assert torch.allclose(c, d, atol=1e-5)


@pytest.mark.parametrize("fn,args", [
    (onehot.onehot_gather, lambda i, t: (i, t)),
    (onehot.onehot_gather_t, lambda i, t: (i, t)),
    (onehot.onehot_scatter_add, lambda i, t: (i, t, 4)),
    (onehot.onehot_scatter_add_t, lambda i, t: (i, t.T.contiguous(), 4)),
])
def test_wrappers_reject_other_devices(fn, args):
    ids = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args(ids, torch.zeros((4, 2), device="meta")))
