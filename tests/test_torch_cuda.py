"""The port on a CUDA card: the K1/K2 kernels against their plain PyTorch
versions, and the slice on the card against the same slice on the CPU.

Every test is marked ``cuda`` and skips itself when torch sees no card.
This file imports neither JAX nor ``g2o_tpu``, so it also runs on a machine
without them: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda.py`` (the repository's ``conftest.py`` imports JAX).

Tolerances: max|Δ| ≤ 2e-5·max|ref| in float32 and ≤ 1e-11·max|ref| in
float64 for the kernels (their summation order differs from cuSOLVER's and
cuBLAS's); chi2 trajectories to rtol 1e-6 (float64, the kernels on the
coarse level on the card, their plain versions on the CPU)."""

import numpy as np
import pytest
import torch

import g2o_tpu_torch
from g2o_tpu_torch.ops import chol_kernels
from g2o_tpu_torch.sim.generators import create_sphere


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.float64, 1e-11)])
@pytest.mark.parametrize("S,n,m", [(7, 12, 5), (33, 48, 1), (5, 126, 96),
                                   (1, 960, 960), (1, 672, 672)])
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
              chol_kernels.solve_lower_batched.launches)
    L = chol_kernels.chol_batched(D)
    Lp = chol_kernels.chol_batched_plain(D).contiguous()
    Y = chol_kernels.solve_lower_batched(Lp, B)
    Yp = chol_kernels.solve_lower_batched_plain(Lp, B)
    torch.cuda.synchronize()
    assert (chol_kernels.chol_batched.launches,
            chol_kernels.solve_lower_batched.launches) == (before[0] + 1,
                                                           before[1] + 1)
    assert (L - Lp).abs().max() <= tol * Lp.abs().max()
    assert (Y - Yp).abs().max() <= tol * Yp.abs().max()
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))


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
