"""Port parity: the batched Cholesky (K1) and forward substitution (K2).

On the CPU the wrappers run their plain PyTorch versions, held here against
the Pallas kernels in interpret mode at the shapes of
``tests/test_pallas_chol.py`` (tolerances as there, relative to the f32
inputs' scale), and the dispatchers of ``core/solvers/supernodal.py``
against the JAX package's at (1, 192, 192), d = 6 (float64, rtol 1e-12).
The kernel-vs-plain cases on the card are in ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from g2o_tpu.core.solvers import supernodal as jsn
from g2o_tpu.ops.pallas_chol import chol_batched, solve_lower_batched
from g2o_tpu_torch.core.solvers import supernodal as tsn
from g2o_tpu_torch.ops import chol_kernels


def _spd(rng, S, n, dtype):
    A = rng.standard_normal((S, n, n)).astype(dtype)
    return A @ A.transpose(0, 2, 1) + n * np.eye(n, dtype=dtype)


@pytest.mark.parametrize("S,n,m", [(7, 12, 5), (33, 48, 1), (5, 126, 96)])
def test_plain_versions_match_pallas_kernels(S, n, m):
    rng = np.random.default_rng(0)
    D = _spd(rng, S, n, np.float32)
    B = rng.standard_normal((S, n, m)).astype(np.float32)
    Lj = np.asarray(chol_batched(jnp.asarray(D), interpret=True), np.float64)
    Yj = np.asarray(solve_lower_batched(jnp.asarray(Lj, jnp.float32),
                                        jnp.asarray(B), interpret=True),
                    np.float64)
    Lt = chol_kernels.chol_batched(torch.as_tensor(D))
    Yt = chol_kernels.solve_lower_batched(Lt, torch.as_tensor(B))
    assert Lt.dtype == torch.float32 and Yt.shape == (S, n, m)
    Lt, Yt = Lt.double().numpy(), Yt.double().numpy()
    # both are f32 factorizations summed in different orders
    assert np.abs(Lt - Lj).max() <= 1e-5 * np.abs(Lj).max()
    assert np.abs(Yt - Yj).max() <= 1e-5 * max(np.abs(Yj).max(), 1.0)
    Lref = np.linalg.cholesky(D.astype(np.float64))
    assert np.abs(Lt - Lref).max() <= 5e-6 * np.abs(Lref).max()


def test_dispatch_matches_supernodal_blocked_path():
    """sd = 192 > 96 with sd % d == 0: the JAX package runs its d-blocked
    emulation, the port its kernel wrappers (plain version on the CPU)."""
    rng = np.random.default_rng(1)
    D = _spd(rng, 1, 192, np.float64)
    B = np.eye(192)[None]
    Lj = np.asarray(jax.jit(jsn._chol_batched, static_argnums=1)(
        jnp.asarray(D), 6))
    Yj = np.asarray(jax.jit(jsn._solve_lower_batched, static_argnums=2)(
        jnp.asarray(Lj), jnp.asarray(B), 6))
    before = (chol_kernels.chol_batched.launches,
              chol_kernels.solve_lower_batched.launches)
    Lt = tsn._chol_batched(torch.as_tensor(D), 6)
    Yt = tsn._solve_lower_batched(Lt, torch.as_tensor(B), 6)
    np.testing.assert_allclose(Lt.numpy(), Lj, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(Yt.numpy(), Yj, rtol=1e-12, atol=1e-13)
    # CPU tensors never count as kernel launches
    assert (chol_kernels.chol_batched.launches,
            chol_kernels.solve_lower_batched.launches) == before


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
