"""Inhomogeneous Dirichlet data through the LOD path.

The reference never exercises g != 0 through LOD (its coarse `distribute`,
LOD.cc:1001, is a no-op on DGQ0 and all its tests use bc = 0).  Here
``assemble_fine_rhs`` eliminates against the GLOBAL interpolant lifting of g
(so the eliminated rhs stays a smooth L2 functional — extension-by-zero
concentrates it in the first fine layer and stalls LOD convergence) and
``prolong_lod_solution`` restores it: u_LOD = C u_c + I(g).

Test problem: exact = sin(pi x) sin(pi y) + y^3, bc = y^3 — the y^3 lifting
is discretely harmless (its interpolant solves the discrete problem exactly
on a uniform grid) while the sin part is a genuine correction, so the coarse
solve is truly exercised (purely polynomial data would be degenerate).
"""

import numpy as np

from dealii_slod_tpu.config import ReductionControl, SLODConfig
from dealii_slod_tpu.models import DiffusionProblem, LODSolver


def _solve(r, ell):
    cfg = SLODConfig(
        dim=2, n_global_refinements=r, n_subdivisions=2, oversampling=ell,
        lod_stabilization=True, constant_coefficients=True,
        rhs="2*pi^2*sin(pi*x)*sin(pi*y) - 6*y", bc="y^3",
        exact_solution="sin(pi*x)*sin(pi*y) + y^3",
        solve_fine_problem=True, dtype="float64", write_output=False,
        coarse_solver=ReductionControl(5000, 1e-14, 1e-14))
    sv = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)
    res = sv.run()
    return sv, res


def test_lod_inhomogeneous_dirichlet_converges():
    errs, errs_exact = [], []
    for r, ell in [(2, 1), (3, 2)]:
        sv, res = _solve(r, ell)
        # boundary trace must equal g exactly (lifting restored)
        bnd = np.asarray(sv.grid.boundary_node_mask())
        g = sv.parse(sv.cfg.bc)(sv.grid.node_coords())
        u = np.asarray(sv.lod_solution)
        np.testing.assert_allclose(u[bnd], g[bnd], atol=1e-12)
        errs.append(res["error_LOD_FEMh"].rows[-1][2]["L2"])
        errs_exact.append(res["error_LOD_exact"].rows[-1][2]["L2"])
    # super-localized decay vs the fine FEM reference, O(H^2) vs exact
    assert errs[1] < errs[0] / 4, errs
    assert errs_exact[1] < errs_exact[0] / 2.5, errs_exact
