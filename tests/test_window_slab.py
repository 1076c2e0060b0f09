"""Slab-chunked `_window_stack` == one-shot slice-stack build.

Above `_WINDOW_SLAB_BYTES` of output the window build runs as a
sequential `lax.map` over slabs of the first lattice axis (the one-shot
stacked intermediate is laid out lattice-minor with padded small axes
at 3D scale configs, up to a 3.9 GB temp at the refine-5 elasticity
config).  The
slab path must be BIT-identical to the one-shot path for both the cell
windows (`_coef_windows`, win = (2l+1)s) and the node windows
(`_rhs_windows`, win = (2l+1)s + 1), including the zero-outside-domain
clipping rows.  Forced here by shrinking the gates."""

import jax.numpy as jnp
import numpy as np
import pytest

from dealii_slod_tpu.config import SLODConfig
from dealii_slod_tpu.models import DiffusionProblem, LODSolver
from dealii_slod_tpu.models import basis as basis_mod


@pytest.mark.parametrize("dim,refine", [(2, 4), (3, 2), (3, 3)])
def test_window_slab_matches_oneshot(monkeypatch, dim, refine):
    cfg = SLODConfig(dim=dim, n_global_refinements=refine,
                     n_subdivisions=2, oversampling=1,
                     constant_coefficients=False, coef_seed=3,
                     rhs="1", bc="0")
    sol = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)
    coef = jnp.asarray(np.asarray(sol.coef_q["alpha"]))
    rng = np.random.default_rng(0)
    rhs = jnp.asarray(rng.standard_normal((sol.grid.n_nodes, sol.C)),
                      sol.dtype)

    plain_cw = np.asarray(sol._coef_windows(coef))
    plain_rw = np.asarray(sol._rhs_windows(rhs))

    # force the slab route for every output size; exercise several slab
    # widths (the target bound picks the largest divisor that fits)
    monkeypatch.setattr(basis_mod, "_WINDOW_SLAB_BYTES", 0)
    for target in [1, 64 * plain_cw.itemsize * plain_cw.shape[1],
                   plain_cw.nbytes // 2]:
        monkeypatch.setattr(basis_mod, "_WINDOW_SLAB_TARGET", target)
        np.testing.assert_array_equal(np.asarray(sol._coef_windows(coef)),
                                      plain_cw)
        np.testing.assert_array_equal(np.asarray(sol._rhs_windows(rhs)),
                                      plain_rw)


def test_identity_pad_idx_skips_gather():
    """When the patch count divides the chunk size the pad index is the
    identity and the traced step must skip the windows[idx] reorder (it
    materialized a full copy per coefficient, lod.py).  End-to-end: a
    chunked run (identity idx -> None) == an unchunked run."""
    cfg = SLODConfig(dim=2, n_global_refinements=4, n_subdivisions=2,
                     oversampling=1, constant_coefficients=False,
                     coef_seed=5, rhs="1", bc="0")
    sol = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)
    cfg2 = SLODConfig(**{**cfg.__dict__, "patch_chunk": 64})
    sol2 = LODSolver(cfg2, DiffusionProblem(cfg2), verbose=False)
    assert sol2.topo.n_patches % 64 == 0
    sol.compute_basis()
    sol2.compute_basis()
    np.testing.assert_allclose(np.asarray(sol.Phi), np.asarray(sol2.Phi),
                               rtol=1e-12, atol=1e-14)
