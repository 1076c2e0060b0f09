"""K-chunked cell-decomposed stencil build == single-shot build.

`_stencil_build_cells(n_chunks > 1)` (models/stencil.py) accumulates the
slot-correlation matmul per K-slot chunk so the (P, K, K2, C, C)
intermediate (3.7 GB at refine-4 3D elasticity) never materializes.  The K
axis is data-parallel through the contraction and the indicator matmul is
a sum over K, so the chunked result must be bitwise-identical algebra
(identical to f.p. reassociation of the accumulation order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dealii_slod_tpu.config import SLODConfig
from dealii_slod_tpu.models import (DiffusionProblem, ElasticityProblem,
                                    LODSolver)


@pytest.mark.parametrize("problem,comp", [("diffusion", 1), ("elasticity", 2)])
def test_stencil_chunked_matches_single(problem, comp):
    cfg = SLODConfig(dim=2, n_global_refinements=3, n_subdivisions=2,
                     oversampling=1, lod_stabilization=True,
                     constant_coefficients=False, coef_seed=4,
                     rhs="; ".join(["1"] * comp), bc="; ".join(["0"] * comp),
                     dtype="float64")
    prob = (DiffusionProblem(cfg) if problem == "diffusion"
            else ElasticityProblem(cfg))
    s = LODSolver(cfg, prob, verbose=False)
    s.compute_basis()
    one = np.asarray(jax.jit(
        lambda p, a: s._stencil_build_cells(p, a, n_chunks=1))(s.Phi, s.APhi))
    chk = np.asarray(jax.jit(
        lambda p, a: s._stencil_build_cells(p, a, n_chunks=4))(s.Phi, s.APhi))
    np.testing.assert_allclose(chk, one, rtol=1e-13, atol=1e-15)
    # and the dispatcher's pick equals both
    via = np.asarray(jax.jit(s._stencil_build)(s.Phi, s.APhi))
    np.testing.assert_allclose(via, one, rtol=1e-13, atol=1e-15)
