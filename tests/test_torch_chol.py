"""Port parity: the batched Cholesky (K1), forward substitution (K2) and
backward substitution (K3).

On the CPU the wrappers run their plain PyTorch versions, held here against
the Pallas kernels in interpret mode at the shapes of
``tests/test_pallas_chol.py`` (tolerances as there, relative to the f32
inputs' scale), and the dispatchers of ``core/solvers/supernodal.py``
against the JAX package's d-blocked path at (1, 192, 192), d = 6, and at
the chunk2 coarse level (1, 960, 960), d = 96 (float64, rtol 1e-12).
The kernel-vs-plain cases on the card are in ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2o_tpu.core.solvers import supernodal as jsn
from g2o_tpu.ops.pallas_chol import (chol_batched, solve_lower_batched,
                                     solve_upper_batched)
from g2o_tpu_torch.core.solvers import supernodal as tsn
from g2o_tpu_torch.ops import chol_kernels


def _spd(rng, S, n, dtype):
    A = rng.standard_normal((S, n, n)).astype(dtype)
    return A @ A.transpose(0, 2, 1) + n * np.eye(n, dtype=dtype)


# the Pallas test shapes, then the supernodal backward sweep's (S, 144, 1)
@pytest.mark.parametrize("S,n,m", [(7, 12, 5), (33, 48, 1), (5, 126, 96),
                                   (1, 144, 1), (2, 144, 1), (12, 144, 1)])
def test_plain_versions_match_pallas_kernels(S, n, m):
    rng = np.random.default_rng(0)
    D = _spd(rng, S, n, np.float32)
    B = rng.standard_normal((S, n, m)).astype(np.float32)
    Lj = np.asarray(chol_batched(jnp.asarray(D), interpret=True), np.float64)
    Yj = np.asarray(solve_lower_batched(jnp.asarray(Lj, jnp.float32),
                                        jnp.asarray(B), interpret=True),
                    np.float64)
    Xj = np.asarray(solve_upper_batched(jnp.asarray(Lj, jnp.float32),
                                        jnp.asarray(B), interpret=True),
                    np.float64)
    Lt = chol_kernels.chol_batched(torch.as_tensor(D))
    Yt = chol_kernels.solve_lower_batched(Lt, torch.as_tensor(B))
    Xt = chol_kernels.solve_upper_batched(
        torch.as_tensor(Lj, dtype=torch.float32), torch.as_tensor(B))
    assert Lt.dtype == torch.float32 and Yt.shape == (S, n, m)
    assert Xt.dtype == torch.float32 and Xt.shape == (S, n, m)
    Lt, Yt, Xt = Lt.double().numpy(), Yt.double().numpy(), Xt.double().numpy()
    # both are f32 factorizations summed in different orders
    assert np.abs(Lt - Lj).max() <= 1e-5 * np.abs(Lj).max()
    assert np.abs(Yt - Yj).max() <= 1e-5 * max(np.abs(Yj).max(), 1.0)
    assert np.abs(Xt - Xj).max() <= 1e-5 * max(np.abs(Xj).max(), 1.0)
    Lref = np.linalg.cholesky(D.astype(np.float64))
    assert np.abs(Lt - Lref).max() <= 5e-6 * np.abs(Lref).max()


@pytest.mark.parametrize("sd,d,scaled", [
    pytest.param(192, 6, False, id="192-6"),
    pytest.param(960, 96, True, id="960-96")])
def test_dispatch_matches_supernodal_blocked_path(sd, d, scaled):
    """sd > 96 with sd % d == 0: the JAX package runs its d-blocked
    emulation, the port its kernel wrappers (plain version on the CPU).
    (960, 96) is the chunk2 coarse level (``pcg.py`` factors and inverts
    it with d = 96): the factor, ``L⁻¹`` and ``Hc⁻¹ = L⁻ᵀL⁻¹`` as the port
    forms them.  Float64; both are LAPACK-grade factorizations summed in
    other orders, so entries agree to 1e-12 relative plus an absolute
    1e-13 — of the largest entry where ``scaled`` (the 960 case's L and
    L⁻¹), for Hc⁻¹ and for X."""
    rng = np.random.default_rng(1)
    D = _spd(rng, 1, sd, np.float64)
    B = np.eye(sd)[None]
    Lj = np.asarray(jax.jit(jsn._chol_batched, static_argnums=1)(
        jnp.asarray(D), d))
    Yj = np.asarray(jax.jit(jsn._solve_lower_batched, static_argnums=2)(
        jnp.asarray(Lj), jnp.asarray(B), d))
    Bv = rng.standard_normal((1, sd, 3))
    Xj = np.asarray(jax.jit(jsn._solve_upper_batched, static_argnums=2)(
        jnp.asarray(Lj), jnp.asarray(Bv), d))
    before = (chol_kernels.chol_batched.launches,
              chol_kernels.solve_lower_batched.launches,
              chol_kernels.solve_upper_batched.launches)
    Lt = tsn._chol_batched(torch.as_tensor(D), d)
    Yt = tsn._solve_lower_batched(Lt, torch.as_tensor(B), d)
    Xt = tsn._solve_upper_batched(Lt, torch.as_tensor(Bv), d)
    for got, want in ((Lt.numpy(), Lj), (Yt.numpy(), Yj)):
        np.testing.assert_allclose(
            got, want, rtol=1e-12,
            atol=1e-13 * (np.abs(want).max() if scaled else 1.0))
    Hinv = Yj[0].T @ Yj[0]
    np.testing.assert_allclose((Yt[0].T @ Yt[0]).numpy(), Hinv, rtol=1e-12,
                               atol=1e-13 * np.abs(Hinv).max())
    np.testing.assert_allclose(Xt.numpy(), Xj, rtol=1e-12,
                               atol=1e-13 * np.abs(Xj).max())
    # CPU tensors never count as kernel launches
    assert (chol_kernels.chol_batched.launches,
            chol_kernels.solve_lower_batched.launches,
            chol_kernels.solve_upper_batched.launches) == before


@pytest.mark.parametrize("sd,d", [(96, 6), (100, 6)])
def test_dispatch_small_or_ragged_uses_torch_linalg(sd, d):
    rng = np.random.default_rng(2)
    D = torch.as_tensor(_spd(rng, 3, sd, np.float64))
    L = tsn._chol_batched(D, d)
    np.testing.assert_allclose(L.numpy(), torch.linalg.cholesky(D).numpy(),
                               rtol=0, atol=0)


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        chol_kernels.chol_batched(torch.zeros((2, 3, 3), device="meta"))
