"""ops.solvers.spd_inverse, the explicit inverse of the coarse triple
product T (the reference's gauss_jordan, LOD.cc:553), at the SLOD coarse
widths cD = 50 (2D), 125 (3D diffusion) and 375 (3D elasticity)."""

import jax.numpy as jnp
import numpy as np
import pytest

from dealii_slod_tpu.ops.solvers import spd_inverse


def _spd(rng, B, n, cond):
    Q = np.linalg.qr(rng.standard_normal((B, n, n)))[0]
    lam = np.logspace(0.0, -np.log10(cond), n)
    return np.einsum("bij,j,bkj->bik", Q, lam, Q)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [50, 125, 375])
def test_spd_inverse_matches_numpy(n, dtype):
    A = _spd(np.random.default_rng(n), 4, n, 1e3)
    X = np.asarray(spd_inverse(jnp.asarray(A, dtype)), np.float64)
    ref = np.linalg.inv(A)
    eps = np.finfo(dtype).eps
    err = np.linalg.norm(X - ref) / np.linalg.norm(ref)
    assert err < 10 * np.sqrt(n) * 1e3 * eps, err


@pytest.mark.parametrize("n", [50, 125, 375])
def test_spd_inverse_cond_1e6(n):
    """At cond ~1e6 (the jitter-floored SLOD Grams) the Cholesky-based
    inverse keeps its residual at ~cond * eps — a recursive 2x2 Schur
    inversion formula lost a decade here."""
    A = _spd(np.random.default_rng(7), 3, n, 1e6)
    X = np.asarray(spd_inverse(jnp.asarray(A)))
    res = np.abs(np.einsum("bij,bjk->bik", A, X) - np.eye(n)).max()
    assert res < 1e6 * np.finfo(np.float64).eps * n, res


def test_spd_inverse_leading_batch_axes():
    A = _spd(np.random.default_rng(1), 6, 20, 10.0).reshape(2, 3, 20, 20)
    X = np.asarray(spd_inverse(jnp.asarray(A)))
    np.testing.assert_allclose(np.einsum("abij,abjk->abik", A, X),
                               np.broadcast_to(np.eye(20), A.shape),
                               atol=1e-12)


def test_spd_inverse_symmetric_output():
    A = _spd(np.random.default_rng(2), 2, 125, 1e4)
    X = np.asarray(spd_inverse(jnp.asarray(A)))
    np.testing.assert_allclose(X, np.swapaxes(X, -1, -2), rtol=1e-9,
                               atol=1e-9 * np.abs(X).max())
