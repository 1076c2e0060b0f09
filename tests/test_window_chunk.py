"""In-body per-chunk window extraction == precomputed windows.

`_window_stack_chunk` pulls one chunk's coefficient windows straight off
the small padded lattice inside the chunk loop; the full precomputed
window array (1.00 GB per coefficient + a full-size layout copy into the
chunk consumer's layout at the 3D refine-5 elasticity config) never
materializes.  Must be BIT-identical to
the corresponding rows of `_window_stack`, and the end-to-end step must
be bit-identical with the route forced on vs off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dealii_slod_tpu.config import SLODConfig
from dealii_slod_tpu.models import DiffusionProblem, ElasticityProblem, \
    LODSolver


def _solver(dim, refine, problem=DiffusionProblem, **kw):
    cfg = SLODConfig(dim=dim, n_global_refinements=refine,
                     n_subdivisions=2, oversampling=1,
                     constant_coefficients=False, coef_seed=3,
                     rhs="1", bc="0", **kw)
    prob = (problem(cfg) if problem is not ElasticityProblem
            else problem(cfg))
    return LODSolver(cfg, prob, verbose=False)


@pytest.mark.parametrize("dim,refine,n_chunks", [
    (2, 3, 2), (2, 3, 4), (2, 4, 8), (3, 2, 4), (3, 2, 8), (3, 2, 16),
])
def test_window_chunk_matches_full(dim, refine, n_chunks):
    sol = _solver(dim, refine)
    cfg = sol.cfg
    N = cfg.n_coarse
    B = N ** dim
    R = sol._window_chunk_rows(B, n_chunks)
    assert R is not None and R * N * n_chunks == B
    win = (2 * cfg.oversampling + 1) * cfg.n_subdivisions
    coef = jnp.asarray(np.asarray(sol.coef_q[sol.coef_names[0]]))
    full = np.asarray(sol._coef_windows(coef))
    lat = sol._coef_lattice(coef)
    got = np.concatenate([
        np.asarray(sol._window_stack_chunk(lat, jnp.int32(j), R, win))
        for j in range(n_chunks)
    ], axis=0)
    np.testing.assert_array_equal(got, full)


def test_window_chunk_rows_gates():
    sol = _solver(3, 2)          # N = 4, P = 64
    assert sol._window_chunk_rows(64, 4) == 4       # chunk 16 = 4 x-rows
    assert sol._window_chunk_rows(64, 8) == 2
    assert sol._window_chunk_rows(64, 16) == 1
    assert sol._window_chunk_rows(64, 1) is None    # single chunk
    assert sol._window_chunk_rows(64, 3) is None    # uneven split
    assert sol._window_chunk_rows(48, 4) is None    # not the full lattice
    sol2 = _solver(2, 3)         # N = 8, P = 64
    assert sol2._window_chunk_rows(64, 2) == 4
    assert sol2._window_chunk_rows(64, 32) is None  # chunk < one x-row


@pytest.mark.parametrize("problem", [DiffusionProblem, ElasticityProblem])
def test_step_bitwise_equal_forced_on_vs_off(problem):
    kw = dict(dim=3, refine=2, problem=problem)
    outs = []
    for mode in ("on", "off"):
        sol = _solver(patch_chunk=16, lod_stabilization=True,
                      window_chunk=mode, **kw)
        sol.assemble_fine_rhs()
        u, A_st = sol.build_step()(sol.coef_q, sol.fem_rhs)
        outs.append((np.asarray(u), np.asarray(A_st)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
