"""The per-patch SPD multi-RHS solve (batched Cholesky + two triangular
solves) at the SLOD patch widths (n interior dofs, k coarse right-hand
sides)."""

import jax.numpy as jnp
import numpy as np
import pytest

from dealii_slod_tpu.ops.solvers import cholesky_factor, cholesky_solve

# relative error bound per dtype for the well-conditioned test matrices
TOL = {"float32": 2e-4, "float64": 1e-11}


def _spd(rng, P, n, k):
    M = rng.standard_normal((P, n, max(n // 3, 4)))
    A = np.einsum("bik,bjk->bij", M, M) + n * np.eye(n)
    return A, rng.standard_normal((P, n, k))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n,k", [(50, 27), (125, 27), (375, 125)])
def test_lax_patch_solve_matches_dense(n, k, dtype):
    A, B = _spd(np.random.default_rng(n), 3, n, k)
    X = cholesky_solve(cholesky_factor(jnp.asarray(A, dtype)),
                       jnp.asarray(B, dtype))
    X_ref = np.linalg.solve(A, B)
    err = np.abs(np.asarray(X, np.float64) - X_ref).max()
    assert err < TOL[dtype] * np.abs(X_ref).max()


def test_lax_patch_solve_under_vmap_matches_batched():
    """The basis kernel solves one patch at a time under vmap; that must be
    the same solve as the explicitly batched call."""
    import jax

    A, B = _spd(np.random.default_rng(5), 4, 60, 9)
    one = jax.vmap(lambda a, b: cholesky_solve(cholesky_factor(a), b))
    X1 = np.asarray(one(jnp.asarray(A), jnp.asarray(B)))
    X2 = np.asarray(cholesky_solve(cholesky_factor(jnp.asarray(A)),
                                   jnp.asarray(B)))
    np.testing.assert_allclose(X1, X2, rtol=1e-12, atol=1e-14)
