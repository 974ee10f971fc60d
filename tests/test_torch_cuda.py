"""The port on a CUDA card: the K1/K2/K3/K4 kernels, the gather and
segment-sum kernels (K5–K10) and the Schur rows kernel (the dims-major
S·v's Schur term) against their plain PyTorch versions, and the
PCG (per-solve and, on a manhattan graph, ``every_k``), supernodal, host
Cholesky, explicit and implicit Schur (BAL; and the sba problems of
``chip_smoke.py`` on the general path and the bucketed multi-observer
branch), CGLS, Dogleg and sparse Cholesky paths on the card against the
same paths on the CPU; the edge types of the remaining type libraries and
the 2D/3D simulators' scenes, the linear 2D initialization, the
structure-only refinement, incremental mode, the CLI, the fast loader, the
hierarchical and interactive apps, the FLOP model's share of the card's
peak and every example on the card against the CPU; two Gloo ranks on
``cuda:0`` (chunk2 PCG and ``SchurSolver(mesh=, use_pallas=True)``)
against one process on the card, and the mixed-precision Gauss-Newton run
on the card against the CPU.

Every test is marked ``cuda`` and skips itself when torch sees no card.
This file imports neither JAX nor ``g2o_tpu``, so it also runs on a machine
without them: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py`` (the repository's ``conftest.py`` imports JAX).

Tolerances: max|Δ| ≤ 2e-5·max|ref| in float32 and ≤ 1e-11·max|ref| in
float64 for the kernels (their summation order differs from cuSOLVER's and
cuBLAS's, and K4's atomics add in a run-dependent order); chi2 trajectories
to rtol 1e-6 (float64, the kernels on the coarse level, the supernodal
panels or the Schur pair aggregation on the card, their plain versions on
the CPU)."""

import gzip
import io
import os

import numpy as np
import pytest
import torch

import g2o_tpu_torch
from g2o_tpu_torch.io import bal
from g2o_tpu_torch.ops import chol_kernels, onehot, segment_kernels
from g2o_tpu_torch.sim.generators import create_manhattan, create_sphere

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C20 = os.path.join(ROOT, "data", "bal_cache", "bal-C20-P800-K5-N1-S0.txt.gz")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.float64, 1e-11)])
@pytest.mark.parametrize("S,n,m", [(7, 12, 5), (33, 48, 1), (5, 126, 96),
                                   (1, 960, 960), (1, 672, 672),
                                   # K1/K2's 64-wide tiles: one past a tile,
                                   # ragged n with m < one tile, 24 tiles
                                   (3, 65, 65), (2, 1000, 37),
                                   (1, 1536, 1536)])
def test_kernel_matches_plain_on_card(S, n, m, dtype, tol):
    _need_card()
    rng = np.random.default_rng(3)
    A = rng.standard_normal((S, n, n))
    D = torch.as_tensor(A @ A.transpose(0, 2, 1) + n * np.eye(n),
                        dtype=dtype, device="cuda")
    B = (torch.eye(n, dtype=dtype, device="cuda").expand(S, n, n).contiguous()
         if n == m else torch.as_tensor(rng.standard_normal((S, n, m)),
                                        dtype=dtype, device="cuda"))
    before = (chol_kernels.chol_batched.launches,
              chol_kernels.solve_lower_batched.launches,
              chol_kernels.solve_upper_batched.launches)
    # each launch is also counted by its (S, n, m)
    by_shape = ((chol_kernels.chol_batched, (S, n, n)),
                (chol_kernels.solve_lower_batched, (S, n, m)),
                (chol_kernels.solve_upper_batched, (S, n, m)))
    shapes_before = [w.shapes.get(sh, 0) for w, sh in by_shape]
    L = chol_kernels.chol_batched(D)
    Lp = chol_kernels.chol_batched_plain(D).contiguous()
    Y = chol_kernels.solve_lower_batched(Lp, B)
    Yp = chol_kernels.solve_lower_batched_plain(Lp, B)
    X = chol_kernels.solve_upper_batched(Lp, B)
    Xp = chol_kernels.solve_upper_batched_plain(Lp, B)
    torch.cuda.synchronize()
    assert (chol_kernels.chol_batched.launches,
            chol_kernels.solve_lower_batched.launches,
            chol_kernels.solve_upper_batched.launches) == (
                before[0] + 1, before[1] + 1, before[2] + 1)
    assert [w.shapes.get(sh, 0) for w, sh in by_shape] == [
        c + 1 for c in shapes_before]
    assert (L - Lp).abs().max() <= tol * Lp.abs().max()
    assert (Y - Yp).abs().max() <= tol * Yp.abs().max()
    assert (X - Xp).abs().max() <= tol * Xp.abs().max()
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))


def _ill_conditioned_spd(rng, n, cond=1e9):
    """A manhattan-like SPD matrix: the weighted Laplacian of a chain with
    random loop closures (diagonally dominant, as the chunk2 coarse level
    of a pose graph) plus a shift that sets the condition number near
    ``cond``, under a random diagonal scaling."""
    w = rng.uniform(0.5, 2.0, n - 1)
    Lap = np.zeros((n, n))
    i = np.arange(n - 1)
    Lap[i, i + 1] = Lap[i + 1, i] = -w
    for a, b in rng.integers(0, n, (n // 2, 2)):
        if abs(a - b) > 1:
            c = rng.uniform(0.1, 1.0)
            Lap[a, b] -= c
            Lap[b, a] -= c
    Lap[np.arange(n), np.arange(n)] = -Lap.sum(axis=1)
    lam_max = np.linalg.eigvalsh(Lap)[-1]
    d = np.exp(rng.uniform(-1.0, 1.0, n))
    return d[:, None] * (Lap + lam_max / cond * np.eye(n)) * d[None, :]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_and_inverse_at_manhattan_coarse_shape_on_card(dtype):
    """K1 and K2 (B = I) at the manhattan3500 chunk2 coarse shape (1, 672,
    672), whose last 64-wide tile is ragged (672 = 10.5 tiles), on a
    matrix with a condition number near 1e9: ``max|LLᵀ − D| / max|D|`` and
    ``max|L·Y − I|`` (products in float64) within 10× the plain versions'."""
    _need_card()
    rng = np.random.default_rng(9)
    n = 672
    D64 = torch.as_tensor(_ill_conditioned_spd(rng, n), device="cuda")
    assert float(torch.linalg.cond(D64)) > 1e8
    D = D64.to(dtype)[None].contiguous()
    eye = torch.eye(n, dtype=dtype, device="cuda")[None].contiguous()
    I64 = torch.eye(n, dtype=torch.float64, device="cuda")
    res = {}
    for route, chol, solve in (
            ("kernel", chol_kernels.chol_batched,
             chol_kernels.solve_lower_batched),
            ("plain", chol_kernels.chol_batched_plain,
             chol_kernels.solve_lower_batched_plain)):
        L = chol(D).contiguous()
        Y = solve(L, eye)
        L64, Y64, Dd = L[0].double(), Y[0].double(), D[0].double()
        res[route] = (float((L64 @ L64.T - Dd).abs().max() / Dd.abs().max()),
                      float((L64 @ Y64 - I64).abs().max()))
    for got, ref in zip(res["kernel"], res["plain"]):
        assert np.isfinite(ref) and np.isfinite(got)
        assert got <= 10 * ref


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_not_positive_definite_gives_nan_on_card(dtype):
    """A negative pivot in the third tile column: NaN from there on, as the
    plain version's NaN factor, so an LM trial fails on a non-finite chi2."""
    _need_card()
    D = torch.eye(200, dtype=dtype, device="cuda")[None].repeat(2, 1, 1)
    D[1, 150, 150] = -1.0
    L = chol_kernels.chol_batched(D)
    torch.cuda.synchronize()
    assert torch.equal(L[0], D[0])
    assert bool(torch.isnan(L[1, 150:, 150:].diagonal()).all())
    assert bool(torch.isnan(chol_kernels.chol_batched_plain(D)[1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_lower_spreads_nan_of_factor_on_card(dtype):
    """K2 skips a tile it finds zero only where L is finite.  B = I; matrix
    0 has a NaN on the diagonal of its third tile, matrix 1 one below the
    diagonal in its second tile row.  NaN comes out where the plain version
    gives it, among them tiles whose B block and Y tiles above are zero
    ((2, 3) of matrix 0, (1, 2) of matrix 1); the finite entries match."""
    _need_card()
    rng = np.random.default_rng(4)
    S, n = 2, 200
    A = rng.standard_normal((S, n, n))
    D = torch.as_tensor(A @ A.transpose(0, 2, 1) + n * np.eye(n),
                        dtype=dtype, device="cuda")
    L = torch.linalg.cholesky(D).contiguous()
    L[0, 150, 150] = float("nan")
    L[1, 100, 20] = float("nan")
    B = torch.eye(n, dtype=dtype, device="cuda").expand(S, n, n).contiguous()
    Y = chol_kernels.solve_lower_batched(L, B)
    want = chol_kernels.solve_lower_batched_plain(L, B)
    torch.cuda.synchronize()
    assert bool(torch.isnan(want[0, 150:192, 195]).all())
    assert bool(torch.isnan(want[1, 100:128, 150]).all())
    assert torch.equal(torch.isnan(Y), torch.isnan(want))
    fin = ~torch.isnan(want)
    tol = 2e-5 if dtype == torch.float32 else 1e-11
    err = (Y[fin] - want[fin]).abs().max() / want[fin].abs().max()
    assert float(err) <= tol


# K3 for m < 32 while the column and the diagonal tiles' coefficients fit
# 200 KB of shared memory (one block per column; n <= 1504 in float32, 736
# in float64), and otherwise (a thread per column): the supernodal sweep's
# (S, 144, 1), m > 1 and m >= 32, ragged n, and n past the staging limit
_K3_SHAPES = [(1, 144, 1), (2, 144, 1), (3, 144, 1), (12, 144, 1),
              (55, 144, 1), (4, 100, 7), (3, 65, 1), (2, 250, 31),
              (2, 300, 3), (1, 1000, 1), (5, 126, 96), (2, 70, 40),
              (1, 1600, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.float64, 1e-11)])
@pytest.mark.parametrize("S,n,m", _K3_SHAPES)
def test_solve_upper_matches_plain_on_card(S, n, m, dtype, tol):
    """K3 against its plain version with NaN above the diagonal of L (only
    the lower triangle may be read), and with a NaN below it: NaN comes
    out exactly where the plain solve gives it."""
    _need_card()
    rng = np.random.default_rng(n + m)
    A = rng.standard_normal((S, n, n))
    D = torch.as_tensor(A @ A.transpose(0, 2, 1) + n * np.eye(n),
                        dtype=dtype, device="cuda")
    L = torch.linalg.cholesky(D)
    L = (L + torch.triu(torch.full_like(L, float("nan")), 1)).contiguous()
    B = torch.as_tensor(rng.standard_normal((S, n, m)), dtype=dtype,
                        device="cuda")
    before = chol_kernels.solve_upper_batched.launches
    X = chol_kernels.solve_upper_batched(L, B)
    want = chol_kernels.solve_upper_batched_plain(L, B)
    torch.cuda.synchronize()
    assert chol_kernels.solve_upper_batched.launches == before + 1
    assert bool(torch.isfinite(want).all())
    assert (X - want).abs().max() <= tol * want.abs().max()
    L[S - 1, n // 2, n // 3] = float("nan")
    X = chol_kernels.solve_upper_batched(L, B)
    want = chol_kernels.solve_upper_batched_plain(L, B)
    torch.cuda.synchronize()
    assert bool(torch.isnan(want[S - 1, :n // 3 + 1]).all())
    assert torch.equal(torch.isnan(X), torch.isnan(want))
    fin = ~torch.isnan(want)
    assert (X[fin] - want[fin]).abs().max() <= tol * want[fin].abs().max()


@pytest.mark.cuda
def test_wrappers_reject_non_contiguous_on_card():
    _need_card()
    D = torch.eye(128, device="cuda")[None].expand(2, 128, 128)
    with pytest.raises(ValueError, match="contiguous"):
        chol_kernels.chol_batched(D)
    with pytest.raises(TypeError):
        chol_kernels.chol_batched(torch.eye(128, device="cuda",
                                            dtype=torch.float16)[None])


@pytest.mark.cuda
def test_slice_on_card_matches_cpu():
    _need_card()
    chis = []
    for device in ("cpu", "cuda"):
        g = create_sphere(nodes_per_level=10, laps=10, seed=5)
        g.set_robust_kernel("Huber", 1.0)
        p = g.compile(dtype=torch.float64, device=device)
        before = chol_kernels.chol_batched.launches
        res = g2o_tpu_torch.optimize_fused(p, g2o_tpu_torch.PCGSolver(
            max_iter=400, tol=1e-12, precond="chunk2", chunk_size=4,
            absolute_tolerance=False), 10)
        if device == "cuda":
            assert chol_kernels.chol_batched.launches > before
        chis.append(res["chi2_per_iteration"])
    np.testing.assert_allclose(chis[1], chis[0], rtol=1e-6)


@pytest.mark.cuda
def test_manhattan_every_k_on_card_matches_cpu():
    """chunk2 with ``every_k`` (K = 8) on a 600-pose manhattan, float64:
    the coarse level (38 chunks of 16 → 114 columns, padded to 192) goes
    through K1/K2 on the card; the same trajectory as on the CPU."""
    _need_card()
    chis = []
    for device in ("cpu", "cuda"):
        p = create_manhattan(n_poses=600, seed=0).compile(
            dtype=torch.float64, device=device)
        before = chol_kernels.chol_batched.launches
        res = g2o_tpu_torch.optimize_fused(p, g2o_tpu_torch.PCGSolver(
            max_iter=200, tol=1e-10, precond="chunk2", chunk_size=16,
            precond_mode="every_k", absolute_tolerance=False), 10)
        if device == "cuda":
            assert chol_kernels.chol_batched.launches > before
        chis.append(res["chi2_per_iteration"] + [res["chi2_final"]])
    np.testing.assert_allclose(chis[1], chis[0], rtol=1e-6)


@pytest.mark.cuda
def test_host_chol_on_card_matches_cpu():
    """``HostCholSolver`` with the linearization and blocks on the card:
    one step's dx and a 5-iteration ``optimize_gn_host`` run equal the
    same problem's on the CPU (float64)."""
    _need_card()
    out = []
    for device in ("cpu", "cuda"):
        p = create_manhattan(n_poses=300, seed=0).compile(
            dtype=torch.float64, device=device)
        hs = g2o_tpu_torch.HostCholSolver().setup(p)
        lin = p.linearize_fn(p.data, p.estimates)
        dx = hs.solve(p.data, lin, 1e-3)
        assert dx.device.type == device
        res = g2o_tpu_torch.optimize_gn_host(p, hs, 5)
        out.append((dx.cpu().numpy(),
                    res["chi2_per_iteration"] + [res["chi2_final"]]))
    (dx_c, chi_c), (dx_g, chi_g) = out
    np.testing.assert_allclose(dx_g, dx_c, rtol=1e-9,
                               atol=1e-9 * np.abs(dx_c).max())
    np.testing.assert_allclose(chi_g, chi_c, rtol=1e-9)


@pytest.mark.cuda
def test_supernodal_on_card_matches_cpu():
    _need_card()
    chis, launches = [], []
    for device in ("cpu", "cuda"):
        g = create_sphere(nodes_per_level=10, laps=10, seed=5)
        g.set_robust_kernel("Huber", 1.0)
        p = g.compile(dtype=torch.float64, device=device)
        before = (chol_kernels.chol_batched.launches,
                  chol_kernels.solve_lower_batched.launches,
                  chol_kernels.solve_upper_batched.launches)
        res = g2o_tpu_torch.optimize_fused(
            p, g2o_tpu_torch.SupernodalCholeskySolver(), 10)
        launches.append(tuple(k - b for k, b in zip(
            (chol_kernels.chol_batched.launches,
             chol_kernels.solve_lower_batched.launches,
             chol_kernels.solve_upper_batched.launches), before)))
        chis.append(res["chi2_per_iteration"] + [res["chi2_final"]])
    assert launches[0] == (0, 0, 0)
    assert min(launches[1]) > 0
    np.testing.assert_allclose(chis[1], chis[0], rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.float64, 1e-11)])
@pytest.mark.parametrize("n,d,s,sort,lo,hi", [
    (1000, 81, 37, False, 0, 37), (5000, 16, 300, False, 0, 300),
    (100, 128, 8, False, 0, 8), (7, 4, 2, False, 0, 2),
    (700, 200, 37, False, -3, 42),          # unsorted, out-of-range ids
    (175000, 81, 2401, True, 0, 2401)])     # the ladybug Schur path's shape
def test_segment_sum_matches_plain_on_card(n, d, s, sort, lo, hi, dtype, tol):
    _need_card()
    rng = np.random.default_rng(n)
    seg = rng.integers(lo, hi, size=n).astype(np.int32)
    if sort:
        seg.sort()
    vals = torch.as_tensor(rng.standard_normal((n, d)), dtype=dtype,
                           device="cuda")
    ids = torch.as_tensor(seg, device="cuda")
    before = segment_kernels.segment_sum.launches
    got = segment_kernels.segment_sum(vals, ids, s)
    want = segment_kernels.segment_sum_plain(vals, ids, s)
    torch.cuda.synchronize()
    assert segment_kernels.segment_sum.launches == before + 1
    assert (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.cuda
def test_segment_sum_rejects_bad_input_on_card():
    _need_card()
    vals = torch.ones((4, 3), device="cuda")
    with pytest.raises(TypeError, match="int32"):
        segment_kernels.segment_sum(vals, torch.zeros(4, dtype=torch.int64,
                                                      device="cuda"), 2)
    with pytest.raises(ValueError, match="contiguous"):
        segment_kernels.segment_sum(torch.ones((3, 4), device="cuda").T,
                                    torch.zeros(4, dtype=torch.int32,
                                                device="cuda"), 2)


# the most segments of 9 values the segment sum takes in one launch
_S_AT_LIMIT = onehot.ROWSUM_MAX_CELLS // 9
# (n, s, d, lo, hi, offset): n rows with ids drawn from [lo, hi), s
# segments of width d; offset > 0 takes the rows and the table as views
# that start `offset` rows into a larger tensor (contiguous, but their
# data_ptr is not 16-byte aligned)
_ONEHOT_CASES = [
    (700, 37, 5, 0, 40, 0),                 # the test_pallas.py shape
    (700, 37, 9, -3, 42, 0),                # out-of-range ids both sides
    (5000, 300, 81, -3, 305, 0),            # table past 48 KB: __ldg path
    (200000, 800, 81, 0, 801, 0),           # Venice widths, tiled D
    (300000, 20000, 9, -3, 20005, 0),       # f32 shared, f64 global sum
    (300000, 70000, 9, -3, 70005, 0),       # past a shared column: global
    # the row-major small-table gather and the one-launch segment sum
    (35000, 49, 9, 0, 50, 0),               # ladybug runtime, sentinel S
    (1000, 1, 9, -1, 3, 0),                 # S = 1
    (5000, 49, 9, 49, 60, 0),               # every id out of range
    (1001, 49, 9, -2, 52, 0),               # N*D not a multiple of 4
    (35000, 49, 9, 0, 50, 1),               # rows[1:]: unaligned data_ptr
    (999, 7, 3, -1, 9, 3),                  # unaligned, D = 3
    (_S_AT_LIMIT, _S_AT_LIMIT, 9, 0, _S_AT_LIMIT + 1, 0),  # S*D at the limit
    (_S_AT_LIMIT, _S_AT_LIMIT + 1, 9, 0, _S_AT_LIMIT + 2, 0),  # past it
    # the dims-major implicit paths' shapes (ladybug D = 9 is above)
    (35000, 49, 81, 0, 49, 0), (198088, 120, 9, 0, 120, 0),
    (198088, 120, 81, 0, 120, 0), (900000, 800, 9, 0, 800, 0),
    (900000, 800, 81, 0, 800, 0),
    # the mixed sba path's stereo / mono slabs: K7 (49, 6) -> (E_pad, 6),
    # K8 at S*D = 294 (one launch) and 1764 (memset + kernel)
    (113000, 49, 6, 0, 49, 0), (113000, 49, 36, 0, 49, 0),
    (115075, 49, 36, 0, 49, 0),
]


def _case_id(case):
    name = "-".join(map(str, case[:5]))
    return name + (f"-offset{case[5]}" if case[5] else "")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.float64, 1e-11)])
@pytest.mark.parametrize("n,s,d,lo,hi,offset", [
    pytest.param(*c, id=_case_id(c)) for c in _ONEHOT_CASES])
def test_onehot_kernels_match_plain_on_card(n, s, d, lo, hi, offset, dtype,
                                            tol):
    _need_card()
    rng = np.random.default_rng(n + d)
    ids = torch.as_tensor(rng.integers(lo, hi, size=n).astype(np.int32),
                          device="cuda")
    table = torch.as_tensor(rng.standard_normal((s + offset, d)), dtype=dtype,
                            device="cuda")[offset:]
    rows = torch.as_tensor(rng.standard_normal((n + offset, d)), dtype=dtype,
                           device="cuda")[offset:]
    assert rows.is_contiguous() and table.is_contiguous()
    if offset:
        assert rows.data_ptr() % 16 and table.data_ptr() % 16
    rows_t = rows.T.contiguous()
    wrappers = (onehot.onehot_gather, onehot.onehot_gather_t,
                onehot.onehot_scatter_add, onehot.onehot_scatter_add_t)
    before = [w.launches for w in wrappers]
    got = (onehot.onehot_gather(ids, table), onehot.onehot_gather_t(ids, table),
           onehot.onehot_scatter_add(ids, rows, s),
           onehot.onehot_scatter_add_t(ids, rows_t, s))
    want = (onehot.onehot_gather_plain(ids, table),
            onehot.onehot_gather_t_plain(ids, table),
            onehot.onehot_scatter_add_plain(ids, rows, s),
            onehot.onehot_scatter_add_t_plain(ids, rows_t, s))
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [b + 1 for b in before]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip(got[2:], want[2:]):
        assert a.shape == b.shape == (s, d)
        assert (a - b).abs().max() <= tol * b.abs().max()


def _device_ops(fn, calls=10, tries=5):
    """Operations one call of ``fn`` puts on the card: torch.profiler's
    device events over ``calls`` calls, per call, rounded (the tracer may
    drop events of a window; a window with fewer events than calls is
    traced again, and the fullest window counts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    n = 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = max(n, sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA))
        if n >= calls:
            break
    return round(n / calls)


# the dims-major segment sum's one-launch limits: SEGT_MAX_CELLS (the
# partials' scratch) and SEGT_COUNTS (the sort's counters) of
# csrc/gather_segment.cu
_DIMS_MAJOR_MAX_CELLS = 65536
_DIMS_MAJOR_MAX_SEGMENTS = 8192


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,s,d,ops,ops_t", [
    (35000, 49, 9, 1, 1),       # ladybug runtime: the kernel alone
    (1001, 1, 9, 1, 1),
    (4000, _S_AT_LIMIT, 9, 1, 1),   # S*D at the row-major limit
    (4000, _S_AT_LIMIT + 1, 9, 2, 1),   # past it: memset + kernel
    (198088, 120, 81, 2, 1),    # the stress file's camera blocks
    (9000, 800, 81, 2, 1),      # Venice's S*D, two D-tiles
    (9000, 7282, 9, 2, 2),      # past _DIMS_MAJOR_MAX_CELLS
    (9000, 8193, 1, 2, 2),      # past _DIMS_MAJOR_MAX_SEGMENTS
    (30000, 70000, 9, 2, 2),    # past a shared column: memset + kernel
    (113000, 49, 6, 1, 1),      # the mixed sba path's CG-body sums
    (113000, 49, 36, 2, 1),     # its preconditioner blocks: memset + kernel
    (300000, 13682, 9, 2, 2),   # BAL Final's camera sums, past the sort's
    (300000, 13682, 81, 2, 2),  # counters: memset + atomics
])
def test_onehot_segment_sum_device_operations_on_card(n, s, d, ops, ops_t,
                                                      dtype):
    """The row-major segment sum puts one operation on the card while
    S*D <= ROWSUM_MAX_CELLS (no memset: the kernel stores every cell) and a
    memset and a kernel past it; the dims-major one one operation while
    S*D <= _DIMS_MAJOR_MAX_CELLS and S <= _DIMS_MAJOR_MAX_SEGMENTS, else a
    memset and a kernel; the gathers one.  Repeated calls agree with the plain version."""
    _need_card()
    rng = np.random.default_rng(7)
    ids = torch.as_tensor(rng.integers(-1, s + 1, size=n).astype(np.int32),
                          device="cuda")
    rows = torch.as_tensor(rng.standard_normal((n, d)), dtype=dtype,
                           device="cuda")
    rows_t = rows.T.contiguous()
    table = rows[:s] if s <= n else rows.new_ones((s, d))
    tol = 2e-5 if dtype == torch.float32 else 1e-11
    want = onehot.onehot_scatter_add_plain(ids, rows, s)
    assert (ops_t == 1) == (s * d <= _DIMS_MAJOR_MAX_CELLS
                            and s <= _DIMS_MAJOR_MAX_SEGMENTS)
    for fn, n_ops in ((lambda: onehot.onehot_scatter_add(ids, rows, s), ops),
                      (lambda: onehot.onehot_scatter_add_t(ids, rows_t, s),
                       ops_t)):
        assert _device_ops(fn) == n_ops
        for _ in range(3):
            assert (fn() - want).abs().max() <= tol * want.abs().max()
    for fn in (lambda: onehot.onehot_gather(ids, table),
               lambda: onehot.onehot_gather_t(ids, table)):
        assert _device_ops(fn) == 1


# the dims-major gather's branches (gather_t_kernel of
# csrc/gather_segment.cu): (n, s, d, lo, hi, id_offset), n ids drawn from
# [lo, hi) into a table of s rows of width d; id_offset > 0 takes the ids
# as a view that starts id_offset ints into a larger tensor (its data_ptr
# off 16 bytes).  16-byte groups of edges need N % 4 == 0 in float32 and
# N % 2 == 0 in float64, and aligned ids; else one thread per edge.
_GATHER_T_CASES = [
    (4001, 49, 9, -3, 54, 0),               # N = 4k+1: one thread per edge
    (4002, 49, 9, -3, 54, 0),               # 4k+2: f64 groups, f32 edges
    (4003, 49, 9, -3, 54, 0),               # 4k+3
    (3, 49, 9, -3, 54, 0),                  # N below one block
    (5, 7, 9, -2, 9, 0),
    (4000, 49, 9, -3, 54, 1),               # ids off 16 bytes: 1, 2, 3 ints
    (4000, 49, 9, -3, 54, 2),
    (4000, 49, 9, -3, 54, 3),
    (4000, 49, 1, -3, 54, 0),               # D = 1, 5, 81
    (4000, 49, 5, -3, 54, 0),
    (4000, 49, 81, -3, 54, 0),
    (4000, 800, 81, -3, 805, 0),            # a table past the staged one
    (30000, 20000, 9, -3, 20005, 0),        # wide S, both types past it
    (2000000, 800, 9, -1, 801, 0),          # more groups than one pass
    (0, 49, 9, 0, 49, 0),                   # N = 0
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,s,d,lo,hi,offset", [
    pytest.param(*c, id=_case_id(c)) for c in _GATHER_T_CASES])
def test_onehot_gather_t_branches_match_plain_on_card(n, s, d, lo, hi, offset,
                                                      dtype):
    """The dims-major gather equals its plain version bit for bit in each
    branch: 16-byte groups or one thread per edge (ragged N, ids off 16
    bytes), a staged table or one read through L1, ids out of range on
    both sides, widths 1 to 81; one launch per call, none for N = 0."""
    _need_card()
    rng = np.random.default_rng(n + d + offset)
    ids = torch.as_tensor(rng.integers(lo, hi, size=n + offset)
                          .astype(np.int32), device="cuda")[offset:]
    if offset:
        assert ids.is_contiguous() and ids.data_ptr() % 16
    table = torch.as_tensor(rng.standard_normal((s, d)), dtype=dtype,
                            device="cuda")
    before = onehot.onehot_gather_t.launches
    got = onehot.onehot_gather_t(ids, table)
    want = onehot.onehot_gather_t_plain(ids, table)
    torch.cuda.synchronize()
    assert onehot.onehot_gather_t.launches == before + (n > 0)
    assert got.shape == (d, n) and got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,s", [(35000, 49), (198088, 120), (900000, 800)])
def test_onehot_gather_t_one_operation_at_path_shapes_on_card(n, s, dtype):
    """At the three dims-major implicit paths' shapes (ladybug, stress,
    Venice; D = 9) the gather puts one operation on the card per call (no
    memset, no copy) and equals the plain version bit for bit."""
    _need_card()
    rng = np.random.default_rng(n)
    ids = torch.as_tensor(rng.integers(0, s, size=n).astype(np.int32),
                          device="cuda")
    table = torch.as_tensor(rng.standard_normal((s, 9)), dtype=dtype,
                            device="cuda")
    assert _device_ops(lambda: onehot.onehot_gather_t(ids, table)) == 1
    assert torch.equal(onehot.onehot_gather_t(ids, table),
                       onehot.onehot_gather_t_plain(ids, table))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,n,m", [(1, 144, 1), (55, 144, 1), (2, 300, 3),
                                   (2, 70, 40), (1, 1600, 2)])
def test_solve_upper_device_operations_on_card(S, n, m, dtype):
    """K3 puts one operation on the card per call in each branch (no
    scratch, no memset), so a call can be captured in a CUDA graph."""
    _need_card()
    rng = np.random.default_rng(13)
    A = rng.standard_normal((S, n, n))
    L = torch.linalg.cholesky(torch.as_tensor(
        A @ A.transpose(0, 2, 1) + n * np.eye(n), dtype=dtype,
        device="cuda")).contiguous()
    B = torch.as_tensor(rng.standard_normal((S, n, m)), dtype=dtype,
                        device="cuda")
    assert _device_ops(lambda: chol_kernels.solve_upper_batched(L, B)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,s,d,dims_major", [
    (35000, 49, 9, False), (4000, _S_AT_LIMIT, 9, False), (7, 3, 9, False),
    # the dims-major paths' shapes: ladybug, stress, Venice; D = 9 and 81
    (35000, 49, 9, True), (35000, 49, 81, True), (198088, 120, 9, True),
    (198088, 120, 81, True), (900000, 800, 9, True),
    (900000, 800, 81, True), (7, 3, 9, True)])
def test_onehot_segment_sum_is_bit_identical_on_card(n, s, d, dims_major,
                                                     dtype):
    """The one-launch segment sums add in a fixed order: calls on the same
    inputs give the same bits, in both layouts."""
    _need_card()
    rng = np.random.default_rng(11)
    ids = torch.as_tensor(rng.integers(-1, s + 1, size=n).astype(np.int32),
                          device="cuda")
    rows = torch.as_tensor(rng.standard_normal((n, d)), dtype=dtype,
                           device="cuda")
    if dims_major:
        rows_t = rows.T.contiguous()

        def call():
            return onehot.onehot_scatter_add_t(ids, rows_t, s)
    else:
        def call():
            return onehot.onehot_scatter_add(ids, rows, s)
    first = call()
    want = onehot.onehot_scatter_add_plain(ids, rows, s)
    tol = 2e-5 if dtype == torch.float32 else 1e-11
    assert (first - want).abs().max() <= tol * want.abs().max()
    for _ in range(5):
        assert torch.equal(call(), first)


def _graph_case(rng, n=35000, s=49, d=9):
    ids = torch.as_tensor(rng.integers(0, s + 1, size=n).astype(np.int32),
                          device="cuda")
    return ids, torch.zeros((n, d), device="cuda"), s


@pytest.mark.cuda
def test_onehot_segment_sum_replays_in_a_cuda_graph_on_card():
    """The one-launch segment sum captured by the usual recipe (warm up on
    a side stream, then ``torch.cuda.graph(g)`` on its own capture stream):
    each replay on new values gives their sums."""
    _need_card()
    rng = np.random.default_rng(9)
    ids, rows, s = _graph_case(rng)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        onehot.onehot_scatter_add(ids, rows, s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = onehot.onehot_scatter_add(ids, rows, s)
    for _ in range(3):
        rows.copy_(torch.as_tensor(rng.standard_normal(tuple(rows.shape)),
                                   dtype=torch.float32, device="cuda"))
        graph.replay()
        want = onehot.onehot_scatter_add_plain(ids, rows, s)
        torch.cuda.synchronize()
        assert (out - want).abs().max() <= 2e-5 * want.abs().max()


@pytest.mark.cuda
def test_onehot_segment_sum_graphs_replay_concurrently_on_card():
    """Captured graphs of the one-launch segment sums (two row-major, one
    dims-major at the ladybug camera blocks' width), replayed at once on
    three streams beside eager calls of each on three more, each many
    times: every sum is right (each graph keeps its own partials, each
    stream's eager calls their own)."""
    _need_card()
    rng = np.random.default_rng(10)
    cases = []
    for n, s, d, dims_major in ((35000, 49, 9, False), (20000, 60, 9, False),
                                (35000, 49, 81, True)):
        ids, rows, s = _graph_case(rng, n, s, d)
        rows.copy_(torch.as_tensor(rng.standard_normal(tuple(rows.shape)),
                                   dtype=torch.float32, device="cuda"))
        if dims_major:
            rows_t = rows.T.contiguous()
            call = (lambda ids=ids, rows_t=rows_t, s=s:
                    onehot.onehot_scatter_add_t(ids, rows_t, s))
        else:
            call = (lambda ids=ids, rows=rows, s=s:
                    onehot.onehot_scatter_add(ids, rows, s))
        cases.append((call, onehot.onehot_scatter_add_plain(ids, rows, s)))
    graphs, outs = [], []
    for call, _ in cases:
        call()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            outs.append(call())
        graphs.append(g)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2 * len(cases))]
    eager = []
    for _ in range(50):
        for g, st in zip(graphs, streams):
            with torch.cuda.stream(st):
                g.replay()
        for k, st in enumerate(streams[len(cases):]):
            with torch.cuda.stream(st):
                eager.append((k, cases[k][0]()))
    torch.cuda.synchronize()
    for got, (_, want) in zip(outs, cases):
        assert (got - want).abs().max() <= 2e-5 * want.abs().max()
    for k, got in eager:
        want = cases[k][1]
        assert (got - want).abs().max() <= 2e-5 * want.abs().max()


@pytest.mark.cuda
def test_onehot_row_gather_refuses_an_unaligned_output_on_card():
    """The row-major small-table gather writes 16-byte stores: its C entry
    returns an error for an ``out`` that is not 16-byte aligned (the
    wrapper's output always is) and takes an aligned one."""
    _need_card()
    onehot._load()
    fn = onehot._FNS["gather", torch.float32]
    rng = np.random.default_rng(12)
    n, s, d = 1001, 49, 9
    ids = torch.as_tensor(rng.integers(-1, s + 1, size=n).astype(np.int32),
                          device="cuda")
    table = torch.as_tensor(rng.standard_normal((s, d)), dtype=torch.float32,
                            device="cuda")
    buf = torch.full((n * d + 4,), float("nan"), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for offset, ok in ((0, True), (1, False), (2, False), (4, True)):
        err = fn(table.data_ptr(), ids.data_ptr(), buf[offset:].data_ptr(),
                 n, s, d, 0, stream)
        assert (err == 0) == ok
        if ok:
            got = buf[offset:offset + n * d].view(n, d)
            assert torch.equal(got, onehot.onehot_gather_plain(ids, table))


@pytest.mark.cuda
def test_onehot_rejects_bad_input_on_card():
    _need_card()
    table = torch.ones((4, 3), device="cuda")
    with pytest.raises(TypeError, match="int32"):
        onehot.onehot_gather(torch.zeros(5, dtype=torch.int64,
                                         device="cuda"), table)
    with pytest.raises(ValueError, match="contiguous"):
        onehot.onehot_scatter_add_t(torch.zeros(4, dtype=torch.int32,
                                                device="cuda"),
                                    torch.ones((4, 3), device="cuda").T, 2)
    with pytest.raises(ValueError, match="ids"):
        onehot.onehot_scatter_add(torch.zeros(5, dtype=torch.int32,
                                              device="cuda"), table, 2)


# the Schur rows kernel's inputs at the dims-major implicit paths' sizes
# (its output, the Schur term per camera, is (cameras, camera width)):
# (cameras, points, observations, camera width) of ladybug, the stress
# file, the Venice configuration of the benchmark, and an sba scene (widths
# 6/3); "ladybug_view" takes B as a view of the first rows of a wider batch
_SCHUR_ROWS_SHAPES = {"ladybug": (49, 7776, 31843, 9),
                      "ladybug_view": (49, 7776, 31843, 9),
                      "stress": (120, 40000, 198088, 9),
                      "venice": (1778, 993923, 5001946, 9),
                      "sba": (49, 6412, 218655, 6)}
_SCHUR_ROWS_CACHE = {}


def _schur_rows_inputs(kind, dtype):
    """``(counts, degrees, Bt, ids, DinvT, v)`` on the card: tracks of 2 +
    Poisson(mean - 2) observations bucketed as ``build_problem`` buckets
    them, random B with zero padding rows (W = 0 there), random camera ids,
    ``DinvT`` a dims-major view of row-major blocks as ``inv_small_t``
    gives it."""
    from g2o_tpu_torch.ops.bucketed import bucket_by_segment

    key = (kind, dtype)
    if key not in _SCHUR_ROWS_CACHE:
        C, P, O, dp = _SCHUR_ROWS_SHAPES[kind]
        rng = np.random.default_rng(sum(map(ord, kind)))
        deg = 2 + rng.poisson(max(O / P - 2, 0.1), P)
        plan = bucket_by_segment(np.repeat(np.arange(P), deg), P)
        n = len(plan.perm_src)
        real = torch.as_tensor(plan.perm_src < deg.sum(), device="cuda")
        wide = n + 7 if kind.endswith("_view") else n
        g = torch.Generator(device="cuda").manual_seed(len(kind))
        Bt = torch.randn((dp, 3, wide), generator=g, dtype=dtype,
                         device="cuda")
        Bt[..., :n] *= real
        Bt = Bt[..., :n]
        ids = torch.as_tensor(rng.integers(0, C, n).astype(np.int32),
                              device="cuda")
        S = len(plan.seg_perm)
        DinvT = torch.randn((S, 3, 3), generator=g, dtype=dtype,
                            device="cuda").movedim(0, -1)
        v = torch.randn((C, dp), generator=g, dtype=dtype, device="cuda")
        _SCHUR_ROWS_CACHE.clear()
        _SCHUR_ROWS_CACHE[key] = (plan.counts, plan.degrees, Bt, ids, DinvT,
                                  v)
    return _SCHUR_ROWS_CACHE[key]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.float64, 1e-11)])
@pytest.mark.parametrize("kind", list(_SCHUR_ROWS_SHAPES))
def test_schur_rows_matches_plain_on_card(kind, dtype, tol):
    """The Schur rows kernel (the S·v Schur term per camera) against its
    plain version at the dims-major paths' sizes: one launch per call,
    within the kernels' tolerance of the largest camera sum."""
    _need_card()
    args = _schur_rows_inputs(kind, dtype)
    before = onehot.schur_rows_t.launches
    got = onehot.schur_rows_t(*args)
    want = onehot.schur_rows_t_plain(*args)
    torch.cuda.synchronize()
    assert onehot.schur_rows_t.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    assert (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["ladybug", "stress", "venice"])
def test_schur_rows_is_bit_identical_on_card(kind, dtype):
    """The kernel adds in a fixed order: repeated calls give the same
    bits, and each puts one operation on the card (no memset, no copy, no
    segment sum after it)."""
    _need_card()
    args = _schur_rows_inputs(kind, dtype)
    first = onehot.schur_rows_t(*args)
    for _ in range(5):
        assert torch.equal(onehot.schur_rows_t(*args), first)
    assert _device_ops(lambda: onehot.schur_rows_t(*args)) == 1


@pytest.mark.cuda
def test_schur_rows_rejects_bad_input_on_card():
    _need_card()
    counts, degrees, Bt, ids, DinvT, v = _schur_rows_inputs("ladybug",
                                                            torch.float32)
    with pytest.raises(TypeError, match="int32"):
        onehot.schur_rows_t(counts, degrees, Bt, ids.long(), DinvT, v)
    with pytest.raises(ValueError, match="contiguous"):
        onehot.schur_rows_t(counts, degrees,
                            Bt.permute(2, 0, 1).contiguous().permute(1, 2, 0),
                            ids, DinvT, v)
    with pytest.raises(ValueError, match="widths"):
        onehot.schur_rows_t(counts, degrees, Bt[:7], ids, DinvT, v[:, :7])
    with pytest.raises(ValueError, match="rows"):
        onehot.schur_rows_t(counts, degrees, Bt[..., 1:], ids[1:], DinvT, v)
    # the blocks' (C, 9) float32 sums past their shared memory
    with pytest.raises(ValueError, match="cameras"):
        onehot.schur_rows_t(counts, degrees, Bt, ids, DinvT,
                            v.new_zeros((6000, 9)))


def _schur_rows_tiled_inputs(C, dtype):
    """The Schur rows kernel's inputs with ``C`` cameras over about 2M
    rows (the stress file's tracks at 450,000 points), and their order."""
    from g2o_tpu_torch.ops.bucketed import bucket_by_segment

    key = ("tiled", C, dtype)
    if key not in _SCHUR_ROWS_CACHE:
        rng = np.random.default_rng(C)
        P = 450000
        deg = 2 + rng.poisson(2.5, P)
        plan = bucket_by_segment(np.repeat(np.arange(P), deg), P)
        n = len(plan.perm_src)
        real = torch.as_tensor(plan.perm_src < deg.sum(), device="cuda")
        g = torch.Generator(device="cuda").manual_seed(C)
        Bt = torch.randn((9, 3, n), generator=g, dtype=dtype, device="cuda")
        Bt *= real
        ids = torch.as_tensor(rng.integers(0, C, n).astype(np.int32),
                              device="cuda")
        DinvT = torch.randn((len(plan.seg_perm), 3, 3), generator=g,
                            dtype=dtype, device="cuda").movedim(0, -1)
        v = torch.randn((C, 9), generator=g, dtype=dtype, device="cuda")
        _SCHUR_ROWS_CACHE.clear()
        _SCHUR_ROWS_CACHE[key] = ((plan.counts, plan.degrees, Bt, ids, DinvT,
                                   v), onehot.schur_rows_order(ids, C))
    return _SCHUR_ROWS_CACHE[key]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.float64, 1e-11)])
@pytest.mark.parametrize("C", [5916, 13682])
def test_schur_rows_tiled_matches_plain_on_card(C, dtype, tol):
    """Past the shared-memory camera cap (5,916: one camera past it in
    float32; 13,682: BAL Final) the tiled form against the plain version
    over about 2M rows: one launch a call, counted by its own wrapper,
    within the kernels' tolerance of the largest camera sum."""
    _need_card()
    args, order = _schur_rows_tiled_inputs(C, dtype)
    assert not onehot.schur_rows_fits(C, 9, 3, dtype)
    assert args[2].shape[-1] > 2_000_000
    before = onehot.schur_rows_tiled_t.launches
    shared = onehot.schur_rows_t.launches
    got = onehot.schur_rows_tiled_t(*args, order)
    want = onehot.schur_rows_t_plain(*args)
    torch.cuda.synchronize()
    assert onehot.schur_rows_tiled_t.launches == before + 1
    assert onehot.schur_rows_t.launches == shared
    assert got.shape == want.shape and got.dtype == dtype
    assert (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_schur_rows_tiled_is_bit_identical_on_card(dtype):
    """The tiled form sums in a fixed order: two calls give the same bits,
    and a call puts one operation on the card."""
    _need_card()
    args, order = _schur_rows_tiled_inputs(13682, dtype)
    first = onehot.schur_rows_tiled_t(*args, order)
    assert torch.equal(onehot.schur_rows_tiled_t(*args, order), first)
    assert _device_ops(lambda: onehot.schur_rows_tiled_t(*args, order)) == 1


@pytest.mark.cuda
def test_schur_rows_tiled_rejects_bad_input_on_card():
    _need_card()
    args, (rows, starts) = _schur_rows_tiled_inputs(5916, torch.float32)
    with pytest.raises(ValueError, match="order"):
        onehot.schur_rows_tiled_t(*args, (rows.long(), starts))
    with pytest.raises(ValueError, match="order"):
        onehot.schur_rows_tiled_t(*args, (rows, starts[:-1]))
    counts, degrees, Bt, ids, DinvT, v = args
    with pytest.raises(ValueError, match="widths"):
        onehot.schur_rows_tiled_t(counts, degrees, Bt[:7], ids, DinvT,
                                  v[:, :7], (rows, starts))


@pytest.mark.cuda
def test_venice_sizes_keep_the_shared_memory_route_on_card():
    """At the Venice configuration's camera count the Schur rows kernel's
    shared-memory form runs, one launch a call, and the tiled form never."""
    _need_card()
    args = _schur_rows_inputs("venice", torch.float32)
    assert onehot.schur_rows_fits(args[-1].shape[0], 9, 3, torch.float32)
    tiled, before = onehot.schur_rows_tiled_t.launches, \
        onehot.schur_rows_t.launches
    assert _device_ops(lambda: onehot.schur_rows_t(*args)) == 1
    assert onehot.schur_rows_t.launches > before
    assert onehot.schur_rows_tiled_t.launches == tiled


@pytest.mark.cuda
@pytest.mark.parametrize("bucket_landmarks,layout,precond", [
    (True, "auto", "schur_jacobi"), (False, "bucketed", "jacobi")])
def test_implicit_schur_on_card_matches_cpu(bucket_landmarks, layout,
                                            precond):
    """10 LM iterations on the C20 BAL file with Huber, float64, in the
    dims-major and the runtime-bucketed layout: the gather and segment-sum
    kernels run on the card, never on the CPU, and the dims-major form's
    Schur rows kernel once per CG iteration."""
    _need_card()
    with gzip.open(C20, "rt") as fh:
        text = fh.read()
    wrappers = (onehot.onehot_gather, onehot.onehot_gather_t,
                onehot.onehot_scatter_add, onehot.onehot_scatter_add_t)
    chis, launches, cg = [], [], []
    for device in ("cpu", "cuda"):
        p = bal.load_bal_problem(io.StringIO(text), huber=1.0, device=device,
                                 bucket_landmarks=bucket_landmarks)
        before = [w.launches for w in wrappers + (onehot.schur_rows_t,)]
        res = g2o_tpu_torch.optimize_fused(p, g2o_tpu_torch.ImplicitSchurSolver(
            max_iter=100, tol=1e-2, precond=precond, layout=layout), 10)
        launches.append([w.launches - b for w, b in zip(
            wrappers + (onehot.schur_rows_t,), before)])
        chis.append(res["chi2_per_iteration"] + [res["chi2_final"]])
        cg.append(sum(res["cg_per_iteration"]))
    assert launches[0] == [0, 0, 0, 0, 0]
    used = launches[1][1:4:2] if bucket_landmarks else launches[1][0:4:2]
    assert min(used) > 0
    # the dims-major form's S·v: one Schur rows launch per CG iteration
    assert launches[1][4] == (cg[1] if bucket_landmarks else 0)
    np.testing.assert_allclose(chis[1], chis[0], rtol=1e-6)


@pytest.mark.cuda
def test_ba_schur_on_card_matches_cpu():
    """10 LM iterations on the C20 BAL file, float64: K4 launched once per
    λ-trial on the card, never on the CPU."""
    _need_card()
    with gzip.open(C20, "rt") as fh:
        text = fh.read()
    chis, launches, trials = [], [], []
    for device in ("cpu", "cuda"):
        p = bal.load_bal_problem(io.StringIO(text), huber=1.0,
                                 device=device)
        before = segment_kernels.segment_sum.launches
        res = g2o_tpu_torch.optimize_fused(
            p, g2o_tpu_torch.SchurSolver(use_pallas=True), 10)
        launches.append(segment_kernels.segment_sum.launches - before)
        trials.append(sum(res["trials_per_iteration"]))
        chis.append(res["chi2_per_iteration"] + [res["chi2_final"]])
    assert launches == [0, trials[1]]
    np.testing.assert_allclose(chis[1], chis[0], rtol=1e-6)


def _sba_graphs():
    """chip_smoke.py's three sba problems at 12 cameras and 150 drawn
    points."""
    import sys
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke.sba_graphs(dict(n_cameras=12, n_points=150, seed=0))[0]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["inverse_depth", "partial", "mixed"])
def test_sba_paths_on_card_match_cpu(path):
    """8 LM iterations, float64, of chip_smoke.py's sba problems at a small
    size: the general path (inverse depth: 3-ary edges, free anchors;
    partial marginalization) and the bucketed multi-observer branch (mixed
    mono and stereo: K7/K8 on the card, never on the CPU) give the CPU's
    trajectory."""
    _need_card()
    g, bucket = _sba_graphs()[path]
    wrappers = (onehot.onehot_gather, onehot.onehot_scatter_add)
    chis, launches = [], []
    for device in ("cpu", "cuda"):
        p = g.compile(dtype=torch.float64, device=device,
                      bucket_landmarks=bucket)
        before = [w.launches for w in wrappers]
        s = g2o_tpu_torch.ImplicitSchurSolver(max_iter=150, tol=1e-6)
        res = g2o_tpu_torch.optimize_fused(p, s, 8)
        assert s._layout["form"] == ("multi_observer" if bucket
                                     else "general")
        launches.append([w.launches - b for w, b in zip(wrappers, before)])
        chis.append(res["chi2_per_iteration"] + [res["chi2_final"]])
    assert launches[0] == [0, 0]
    if bucket:
        assert min(launches[1]) > 0
    np.testing.assert_allclose(chis[1], chis[0], rtol=1e-6)
    assert chis[1][-1] < 0.1 * chis[1][0]


@pytest.mark.cuda
def test_cgls_on_card_matches_cpu():
    """10 LM iterations of CGLS on the C20 BAL file loaded with
    ``bucket_landmarks`` (Huber, float64): the dims-major gather and segment
    sum (K5/K6) run on the card at least once per CG iteration, never on
    the CPU; the trajectory is the CPU's."""
    _need_card()
    with gzip.open(C20, "rt") as fh:
        text = fh.read()
    wrappers = (onehot.onehot_gather_t, onehot.onehot_scatter_add_t)
    chis, launches, cg = [], [], []
    for device in ("cpu", "cuda"):
        p = bal.load_bal_problem(io.StringIO(text), huber=1.0, device=device,
                                 bucket_landmarks=True)
        before = [w.launches for w in wrappers]
        s = g2o_tpu_torch.CGLSSolver(max_iter=200, eta=1e-8)
        res = g2o_tpu_torch.optimize_fused(p, s, 10)
        launches.append([w.launches - b for w, b in zip(wrappers, before)])
        cg.append(s.cg_iterations)
        chis.append(res["chi2_per_iteration"] + [res["chi2_final"]])
    assert launches[0] == [0, 0]
    assert min(launches[1]) >= cg[1] > 0
    np.testing.assert_allclose(chis[1], chis[0], rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [100.0, 1e-3])
def test_dogleg_on_card_matches_cpu(delta):
    """12 Dogleg iterations over the supernodal solver (float64, a sphere
    with 144-column panels, so K1/K2/K3 run on the card): the chi2, radius
    and step kinds of the CPU run."""
    _need_card()
    runs, launches = [], []
    for device in ("cpu", "cuda"):
        g = create_sphere(nodes_per_level=10, laps=10, seed=5)
        g.set_robust_kernel("Huber", 1.0)
        p = g.compile(dtype=torch.float64, device=device)
        opt = g2o_tpu_torch.SparseOptimizer(
            p, algorithm=g2o_tpu_torch.Dogleg(initial_delta=delta),
            solver=g2o_tpu_torch.SupernodalCholeskySolver())
        rec = []
        opt.post_iteration_actions.append(lambda o, it: rec.append(
            (o.current_chi2, o.algorithm.delta, o.algorithm._last_step)))
        before = chol_kernels.chol_batched.launches
        opt.optimize(12)
        launches.append(chol_kernels.chol_batched.launches - before)
        runs.append(rec)
    assert launches[0] == 0 and launches[1] > 0
    assert [r[2] for r in runs[1]] == [r[2] for r in runs[0]]
    np.testing.assert_allclose([r[:2] for r in runs[1]],
                               [r[:2] for r in runs[0]], rtol=1e-6)


@pytest.mark.cuda
def test_sparse_cholesky_on_card_matches_cpu():
    """One f64 solve and 10 LM iterations of ``SparseCholeskySolver`` on a
    manhattan graph: the card's step is the CPU's to 1e-9 and the
    trajectory to 1e-6; an indefinite system gives NaN on the card too,
    without an exception; the Takahashi marginals agree to 1e-9."""
    _need_card()
    from g2o_tpu_torch.core.marginals import compute_marginals

    dxs, chis, covs = [], [], []
    for device in ("cpu", "cuda"):
        p = create_manhattan(n_poses=300, seed=0).compile(
            dtype=torch.float64, device=device)
        lin = p.linearize_fn(p.data, p.estimates)
        dxs.append(g2o_tpu_torch.SparseCholeskySolver().setup(p).solve(
            p.data, lin, 1e-3).cpu().numpy())
        covs.append(compute_marginals(p, [1, 150, 299], lam=1e-4,
                                      method="takahashi"))
        res = g2o_tpu_torch.optimize_fused(
            p, g2o_tpu_torch.SparseCholeskySolver(), 10)
        chis.append(res["chi2_per_iteration"] + [res["chi2_final"]])
        if device == "cuda":
            for W in lin.weights.values():
                W.neg_()
            bad = g2o_tpu_torch.SparseCholeskySolver().setup(p).solve(
                p.data, lin, 0.0)
            assert torch.isnan(bad).any()
    assert np.abs(dxs[1] - dxs[0]).max() <= 1e-9 * np.abs(dxs[0]).max()
    np.testing.assert_allclose(chis[1], chis[0], rtol=1e-6)
    for v in covs[0]:
        assert np.abs(covs[1][v] - covs[0][v]).max() <= \
            1e-9 * np.abs(covs[0][v]).max()


# --------------------------------------------------------------------------- #
# the remaining type libraries and the simulators
# --------------------------------------------------------------------------- #

def _slice_edge_types():
    """Every edge type of the slam3d additions, slam3d_addons,
    slam2d_addons, sclam2d, icp and sim3, by name."""
    from g2o_tpu_torch.core.types import EdgeType
    from g2o_tpu_torch.types import (icp, sclam2d, sim3, slam2d_addons,
                                     slam3d, slam3d_addons)

    types = [slam3d.EdgeSE3PointXYZ, slam3d.EdgePointXYZ,
             slam3d.EdgeXYZPrior, slam3d.EdgeSE3Offset,
             slam3d.EdgeSE3PointXYZDepth, slam3d.EdgeSE3PointXYZDisparity,
             slam3d.make_edge_se3_lots_of_xyz(2)]
    for mod in (slam3d_addons, slam2d_addons, sclam2d, icp, sim3):
        types += [v for v in vars(mod).values() if isinstance(v, EdgeType)]
    return {et.name: et for et in types}


SLICE_EDGE_TYPES = _slice_edge_types()


def _edge_on(et, inp, device):
    from g2o_tpu_torch.core.problem import residuals_and_jacobians

    states = tuple(torch.as_tensor(a, dtype=torch.float64, device=device)
                   for a in inp[0])
    meas, param = (torch.as_tensor(a, dtype=torch.float64, device=device)
                   for a in inp[1:3])
    e, Js = residuals_and_jacobians(et, states, meas, param)
    return [e.cpu()] + [J.cpu() for J in Js]


def _rel(got, want):
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
               for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SLICE_EDGE_TYPES))
def test_new_edge_type_on_card_matches_cpu(name):
    """Residuals and ``torch.func`` Jacobians at 10⁴ random valid edges
    (``chip_smoke.py``'s inputs: unit quaternions, Plücker lines, points in
    front of their camera) on the card against the CPU: 1e-10, finite."""
    _need_card()
    from chip_smoke import _check_inputs

    et = SLICE_EDGE_TYPES[name]
    inp = _check_inputs(torch, et, np.random.default_rng(5), 10_000)
    got, want = _edge_on(et, inp, "cuda"), _edge_on(et, inp, "cpu")
    assert all(bool(torch.isfinite(a).all()) for a in got + want)
    assert _rel(got, want) <= 1e-10


@pytest.mark.cuda
def test_sim3_edge_at_the_w_thresholds_on_card_matches_cpu():
    """The Sim3 edge with errors on both sides of ``_sim3_W``'s 1e-7
    thresholds: the card's values are the CPU's within ``chip_smoke``'s
    ``SIM3_W_LIMIT`` (the cancellation just above the σ threshold), and
    the residual is log(exp(ξ)) = ξ to 1e-9."""
    _need_card()
    from chip_smoke import SIM3_W_LIMIT, _sim3_w_inputs

    inp = _sim3_w_inputs(torch, np.random.default_rng(6), 200)
    et = SLICE_EDGE_TYPES["EDGE_SIM3:EXPMAP"]
    got, want = _edge_on(et, inp, "cuda"), _edge_on(et, inp, "cpu")
    assert all(bool(torch.isfinite(a).all()) for a in got)
    assert _rel(got, want) <= SIM3_W_LIMIT
    assert np.abs(got[0].numpy() - inp[3]).max() <= 1e-9


SIM_ALL = {
    3: ("create_simulator3d", dict(
        n_poses=200, n_landmarks=160, world_size=14.0, n_lines=12,
        n_planes=6, seed=3, sensors=(
            "odometry", "pose", "pose_offset", "se3prior", "trackxyz",
            "depth", "disparity", "line3d", "plane"))),
    2: ("create_simulator2d", dict(
        n_poses=200, n_landmarks=60, world_size=20.0, n_segments=20,
        n_lines=12, seed=3, sensors=(
            "odometry", "pose", "pointxy", "bearing", "pointxy_offset",
            "segment", "segment_line", "segment_pointline", "line2d"))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [3, 2])
def test_zero_noise_scene_on_card(dim):
    """Every sensor at once with zero noise: chi2 ≤ 1e-10 on the card."""
    _need_card()
    from g2o_tpu_torch.sim import generators

    make, kw = SIM_ALL[dim]
    g = getattr(generators, make)(**kw, noise_scale=0.0)
    p = g.compile(dtype=torch.float64, device="cuda")
    assert float(p.chi2_fn(p.data, p.estimates)[0]) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [3, 2])
def test_simulated_scene_lm_on_card_matches_cpu(dim):
    """8 LM iterations (float64) on a 200-pose scene with every sensor,
    from the generator's estimates moved by seeded tangent noise:
    ``SupernodalCholeskySolver`` in 3D, chunk2 PCG in 2D, whose K1/K2(/K3)
    run on the card; the chi2 history is the CPU's to 1e-9 until LM stops
    at the rounding floor, the final chi2 to 1e-9."""
    _need_card()
    from g2o_tpu_torch.sim import generators

    make, kw = SIM_ALL[dim]
    g = getattr(generators, make)(**kw)
    runs, launches = [], []
    for device in ("cpu", "cuda"):
        p = g.compile(dtype=torch.float64, device=device)
        dx = torch.as_tensor(0.05 * np.random.default_rng(100).normal(
            size=p.total_dim), dtype=torch.float64, device=device)
        p.set_estimates(p.apply_update_fn(p.data, p.estimates, dx))
        solver = (g2o_tpu_torch.SupernodalCholeskySolver() if dim == 3 else
                  g2o_tpu_torch.PCGSolver(max_iter=400, tol=1e-12,
                                          precond="chunk2", chunk_size=4,
                                          absolute_tolerance=False))
        before = chol_kernels.chol_batched.launches
        res = g2o_tpu_torch.optimize_fused(p, solver, 8)
        launches.append(chol_kernels.chol_batched.launches - before)
        runs.append(res)
    assert launches[0] == 0 and launches[1] > 0
    c0, c1 = (r["chi2_per_iteration"] for r in runs)
    n = min(len(c0), len(c1))
    assert n >= 4 and c0[0] > 10 * runs[0]["chi2_final"]
    np.testing.assert_allclose(c1[:n], c0[:n], rtol=1e-9)
    np.testing.assert_allclose(runs[1]["chi2_final"], runs[0]["chi2_final"],
                               rtol=1e-9)


# --------------------------------------------------------------------------- #
# the g2o command-line tool and its modules
# --------------------------------------------------------------------------- #

def _guess_graph():
    g = create_manhattan(n_poses=200, seed=12)
    for rec in g.vertices().values():
        if not rec.fixed:
            rec.estimate = np.zeros(3)
    return g


@pytest.mark.cuda
def test_slam2d_linear_on_card_matches_cpu():
    _need_card()
    from g2o_tpu_torch.core.slam2d_linear import solve_slam2d_linear

    out = {}
    for dev in ("cuda", "cpu"):
        g = _guess_graph()
        assert solve_slam2d_linear(g, device=dev) == 200
        out[dev] = np.stack([g.vertex(v).estimate
                             for v in sorted(g.vertices())])
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-8,
                               atol=1e-8)


@pytest.mark.cuda
def test_structure_only_on_card_matches_cpu():
    _need_card()
    from g2o_tpu_torch.core.structure_only import structure_only_refine
    from g2o_tpu_torch.sim.generators import create_ba_scene

    res, pts = {}, {}
    for dev in ("cuda", "cpu"):
        g, _ = create_ba_scene(n_cameras=10, n_points=120, pixel_noise=1.0,
                               point_noise=0.2, seed=4)
        p = g.compile(device=dev)
        res[dev] = structure_only_refine(p, n_iters=10)
        pts[dev] = {t: e.cpu().numpy() for t, e in p.estimates.items()}
    for t in res["cpu"]:
        for a, b in zip(res["cuda"][t], res["cpu"][t]):
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)
    (before, after), = res["cuda"].values()
    assert np.all(after <= before + 1e-12)
    for t in pts["cpu"]:
        # the CPU parity tests' point tolerance (flat depth directions)
        np.testing.assert_allclose(pts["cuda"][t], pts["cpu"][t],
                                   rtol=1e-7, atol=1e-12)


def _replay(inc, g, update=10, final=10):
    vrecs, added, n_since = g.vertices(), set(), 0
    chis = []
    for e in sorted(g.edges(), key=lambda e: max(e.vids)):
        for vid in e.vids:
            if vid not in added:
                r = vrecs[vid]
                inc.add_vertex(vid, r.vtype, r.estimate, fixed=r.fixed)
                added.add(vid)
                n_since += 1
        inc.add_edge(e.etype, e.vids, e.measurement, e.information)
        if n_since >= update:
            inc.optimize(1)
            chis.append(inc.chi2())
            n_since = 0
    inc.optimize(final)
    chis.append(inc.chi2())
    return chis


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["supernodal", "chunk2_frozen"])
def test_incremental_on_card_matches_cpu(solver):
    """200 poses replayed as ``g2o -inc`` does: the chi2 after every update
    on the card equals the CPU run's, and supernodal reaches the batch
    optimum (ROADMAP C.5)."""
    _need_card()
    from g2o_tpu_torch.core.incremental import IncrementalOptimizer

    make = {"supernodal": g2o_tpu_torch.SupernodalCholeskySolver,
            "chunk2_frozen": lambda: g2o_tpu_torch.PCGSolver(
                max_iter=150, tol=1e-8, precond="chunk2", chunk_size=16,
                precond_mode="frozen")}[solver]
    chis, recompiles = {}, {}
    for dev in ("cuda", "cpu"):
        inc = IncrementalOptimizer(solver_factory=make, device=dev,
                                   vertex_chunk=64, edge_chunk=64)
        chis[dev] = _replay(inc, create_manhattan(n_poses=200, seed=0))
        recompiles[dev] = inc.recompiles
    assert recompiles["cuda"] == recompiles["cpu"] > 1
    np.testing.assert_allclose(chis["cuda"], chis["cpu"], rtol=1e-6,
                               atol=1e-9)
    p = create_manhattan(n_poses=200, seed=0).compile(device="cuda")
    opt = g2o_tpu_torch.SparseOptimizer(
        p, solver=g2o_tpu_torch.SupernodalCholeskySolver())
    opt.optimize(20)
    if solver == "supernodal":
        assert chis["cuda"][-1] == pytest.approx(opt.chi2(), rel=1e-6)


@pytest.mark.cuda
def test_cli_on_card_matches_cpu(tmp_path):
    """The CLI on the card (its default device) against -device cpu."""
    _need_card()
    import contextlib
    import json

    from g2o_tpu_torch.apps import cli
    from g2o_tpu_torch.io import g2o_format

    inp = str(tmp_path / "m.g2o")
    g2o_format.save(create_manhattan(n_poses=150, seed=3), inp)
    out = {}
    for dev in ("cuda", "cpu"):
        summary = str(tmp_path / f"{dev}.jsonl")
        with contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["-fp64", "-device", dev, "-i", "10", "-solver",
                           "lm_supernodal", "-robustKernel", "Huber",
                           "-summary", summary, "-o",
                           str(tmp_path / f"{dev}.g2o"), inp])
        assert rc == 0
        out[dev] = json.loads(open(summary).read().splitlines()[-1])
    assert out["cuda"]["iterations"] == out["cpu"]["iterations"]
    assert out["cuda"]["final_chi2"] == pytest.approx(
        out["cpu"]["final_chi2"], rel=1e-9)


@pytest.mark.cuda
def test_fast_loader_on_card_matches_cpu(tmp_path):
    """``g2o_fast.load_problem`` builds on the card (its default device)
    the CPU's arrays bit for bit, and 5 LM iterations from them agree to
    rtol 1e-9 (float64)."""
    _need_card()
    from g2o_tpu_torch.io import g2o_fast, g2o_format

    path = str(tmp_path / "m.g2o")
    g2o_format.save(create_manhattan(n_poses=200, seed=13), path)
    pc, _ = g2o_fast.load_problem(path, kernel="Huber", delta=2.0)
    pp, _ = g2o_fast.load_problem(path, kernel="Huber", delta=2.0,
                                  device="cpu")
    assert pc.device.type == "cuda"
    for t in pp.estimates:
        assert torch.equal(pc.estimates[t].cpu(), pp.estimates[t])
        assert torch.equal(pc.data.fixed[t].cpu(), pp.data.fixed[t])
    for name, b in pp.data.edges.items():
        for f in b._fields:
            assert torch.equal(getattr(pc.data.edges[name], f).cpu(),
                               getattr(b, f)), f
    chis = [g2o_tpu_torch.optimize_fused(p, g2o_tpu_torch.PCGSolver(
        max_iter=100, tol=1e-10), 5)["chi2_per_iteration"] for p in (pc, pp)]
    np.testing.assert_allclose(chis[0], chis[1], rtol=1e-9)


@pytest.mark.cuda
def test_hierarchical_on_card_matches_cpu():
    """``optimize_hierarchical`` on a 300-pose manhattan graph, float64:
    the same stars and skeleton, final chi2 to rtol 1e-6."""
    _need_card()
    from g2o_tpu_torch.apps.hierarchical import optimize_hierarchical

    res = {dev: optimize_hierarchical(
        create_manhattan(n_poses=300, seed=17), star_radius=5,
        star_iterations=8, skeleton_iterations=20, refine_iterations=8,
        device=dev) for dev in ("cuda", "cpu")}
    for k in ("n_stars", "levels", "skeleton_vertices", "skeleton_edges"):
        assert res["cuda"][k] == res["cpu"][k]
    assert res["cuda"]["final_chi2"] == pytest.approx(
        res["cpu"]["final_chi2"], rel=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
def test_interactive_on_card_matches_cpu(dim):
    """The interactive protocol on the card (float64): the QUERY_STATE
    estimates the CPU's within 1e-7."""
    _need_card()
    from g2o_tpu_torch.apps.interactive import InteractiveSlam

    script = {2: ["ADD VERTEX_XYT 0;", "ADD VERTEX_XYT 1 1 0 0;",
                  "ADD EDGE_XYT 0 0 1 .1 .2 .3 1 0 0 1 0 1;",
                  "ADD EDGE_XYT 1 1 2 .1 .2 .3 1 0 0 1 0 1;",
                  "ADD EDGE_XYT 2 0 2 .2 .4 .6 2 0 0 2 0 2;"],
              3: ["ADD VERTEX_XYZRPY 0;",
                  "ADD EDGE_XYZRPY 0 0 1 .1 .2 .3 .01 .02 .03 1 0 0 0 0 0 1 "
                  "0 0 0 0 1 0 0 0 1 0 0 1 0 1;",
                  "ADD EDGE_XYZRPY 1 1 2 .1 0 .2 .03 .02 .01 1 0 0 0 0 0 1 "
                  "0 0 0 0 1 0 0 0 1 0 0 1 0 1;"]}[dim]
    script = script + ["SOLVE_STATE;", "QUERY_STATE;"]
    out = {}
    for dev in ("cuda", "cpu"):
        srv = InteractiveSlam(iterations=10, dtype=torch.float64,
                              device=dev)
        resp = [srv.handle_line(ln) for ln in script][-1]
        out[dev] = np.array([[float(x) for x in row.split()[1:]]
                             for row in resp.splitlines()[1:-1]])
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0, atol=1e-7)


@pytest.mark.cuda
def test_mfu_report_on_card():
    """The FLOP model's share of the card's published peak lies in (0, 1)
    for an f32 chunk2 run (an H100; other cards have no peak)."""
    _need_card()
    from g2o_tpu_torch.utils import flops

    if flops.device_peak_flops() is None:
        pytest.skip("no published peak for this card")
    p = create_manhattan(n_poses=300, seed=0).compile(dtype=torch.float32)
    s = g2o_tpu_torch.PCGSolver(max_iter=50, tol=1e-3, precond="chunk2",
                                chunk_size=16)
    rep = flops.mfu_report(p, s, g2o_tpu_torch.optimize_fused(p, s, 5))
    assert rep["peak_dtype"] == "float32"
    assert 0.0 < rep["mfu_vs_peak"] < 1.0


EXAMPLE_ARGS = {"simple_optimize": ["{dir}/m.g2o", "6"],
                "g2o_unfold": ["{dir}/m.g2o", "-i", "3", "-maxCost", "1e9",
                               "-gnudump", "{dir}/dump.dat"],
                "create_sphere": ["{dir}/s.g2o", "8", "4"]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", [
    "ba_anchored_inverse_depth", "ba_demo", "bal_example", "circle_fit",
    "create_sphere", "curve_fit", "data_convert", "g2o_unfold", "gicp_demo",
    "line_slam", "odom_calibration", "plane_slam", "sba_demo",
    "simple_optimize", "target_tracking", "tutorial_slam2d"])
def test_example_on_card_matches_cpu(tmp_path, name):
    """Each example with ``-device cuda`` prints what its ``-device cpu``
    run prints (float64; ``_example_runs.assert_same_output``: rtol 1e-6
    or one unit of the last printed digit; 1e-4 for the examples whose
    LM solves with PCG's default tol of 1e-6, as ``chip_smoke.py``)."""
    _need_card()
    from _example_runs import assert_same_output, run
    from g2o_tpu_torch.io import g2o_format

    out = {}
    for dev in ("cuda", "cpu"):
        d = tmp_path / dev
        d.mkdir()
        g2o_format.save(create_manhattan(n_poses=30, seed=4),
                        str(d / "m.g2o"))
        args = [a.replace("{dir}", str(d)) for a in EXAMPLE_ARGS.get(name,
                                                                   [])]
        ret, text = run("torch", name, args, str(d), device=dev)
        out[dev] = (ret, text.replace(str(d), "{dir}"))
    pcg = {"simple_optimize", "g2o_unfold", "tutorial_slam2d",
           "target_tracking", "line_slam", "plane_slam"}
    assert_same_output(out["cuda"][1], out["cpu"][1],
                       rtol=1e-4 if name in pcg else 1e-6)
    if isinstance(out["cpu"][0], np.ndarray):
        np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=1e-9)
    else:
        assert out["cuda"][0] == out["cpu"][0]


@pytest.fixture(scope="module")
def sharded_on_card(tmp_path_factory):
    """The two-process Gloo worker's small cases with every rank's tensors
    on ``cuda:0`` (``--case tests --device cuda``)."""
    import json
    import socket
    import subprocess
    import sys

    _need_card()
    out = str(tmp_path_factory.mktemp("parallel_card") / "tests.json")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "g2o_tpu_torch.parallel.worker",
         "--init-method", f"tcp://127.0.0.1:{port}", "--nproc", "2",
         "--pid", str(r), "--device", "cuda", "--backend", "gloo",
         "--case", "tests", "--out", out],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        logs = [pr.communicate(timeout=600)[0] for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    for pr, log in zip(procs, logs):
        assert pr.returncode == 0, log[-4000:]
    with open(out) as fh:
        return json.load(fh)["tests"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["chunk2_solve", "schur_step"])
def test_sharded_solve_on_card_matches_one_process(sharded_on_card, case):
    """Two Gloo ranks on ``cuda:0`` against one process on the card, float64:
    chunk2 PCG (K1/K2 on the coarse level) and ``SchurSolver(mesh=,
    use_pallas=True)`` (K4 over each rank's pairs), ``atol=1e-9``."""
    from g2o_tpu_torch.sim.generators import create_ba_scene

    if case == "chunk2_solve":
        p = create_manhattan(n_poses=120, seed=3).compile(
            dtype=torch.float64, device="cuda")
        s = g2o_tpu_torch.PCGSolver(max_iter=25, tol=1e-10,
                                    precond="chunk2", chunk_size=8)
    else:
        p = create_ba_scene(n_cameras=10, n_points=150, pixel_noise=0.5,
                            point_noise=0.3, seed=21)[0].compile(
            dtype=torch.float64, device="cuda")
        s = g2o_tpu_torch.SchurSolver(use_pallas=True)
    dx = s.setup(p).solve(p.data, p.linearize_fn(p.data, p.estimates), 1e-3)
    np.testing.assert_allclose(np.asarray(sharded_on_card[case]["dx"]),
                               dx.cpu().numpy(), atol=1e-9)


@pytest.mark.cuda
def test_mixed_gn_on_card_matches_cpu():
    """``compile(dtype=float32, state_dtype=float64)`` on the card: 8
    Gauss-Newton iterations with the dense solver on
    ``create_manhattan(250, seed=5)`` reach the CPU run's chi2 (rtol
    1e-6) and the float64 fixed point (1e-4, the JAX package's bar)."""
    _need_card()
    g = create_manhattan(n_poses=250, seed=5)
    chi = {}
    for device in ("cuda", "cpu"):
        p = g.compile(dtype=torch.float32, state_dtype=torch.float64,
                      device=device)
        chi[device] = g2o_tpu_torch.optimize_fused_gn(
            p, g2o_tpu_torch.DenseSolver(), 8)["chi2_final"]
    c64 = g2o_tpu_torch.optimize_fused_gn(
        g.compile(dtype=torch.float64, device="cpu"),
        g2o_tpu_torch.DenseSolver(), 8)["chi2_final"]
    assert chi["cuda"] == pytest.approx(chi["cpu"], rel=1e-6)
    assert abs(chi["cuda"] - c64) <= 1e-4 * max(c64, 1.0)
