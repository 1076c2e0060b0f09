"""Fine-solve preconditioner study: CG iteration counts, plain Jacobi vs
the additive two-level LOD-space preconditioner — the data-parallel
stand-in for the reference's AMG (source/LOD.cc:1074-1078) —
at increasing coefficient contrast.

    JAX_PLATFORMS=cpu python scripts/precond_study.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# CPU by default (the study counts iterations, not time); set
# PRECOND_PLATFORM=gpu to run it on the card.
jax.config.update("jax_platforms",
                  os.environ.get("PRECOND_PLATFORM", "cpu"))
jax.config.update("jax_enable_x64", True)

from dealii_slod_tpu.config import ReductionControl, SLODConfig
from dealii_slod_tpu.models import DiffusionProblem, LODSolver


def run(dim, refine, contrast, precond):
    cfg = SLODConfig(
        dim=dim, n_global_refinements=refine, n_subdivisions=2,
        oversampling=2, lod_stabilization=True,
        constant_coefficients=False, coef_seed=0, coef_refinement=5,
        coef_min=1.0, coef_max=contrast,
        rhs="1", bc="0", dtype="float64",
        solve_fine_problem=True, fine_preconditioner=precond,
        fine_solver=ReductionControl(30000, 1e-9, 1e-9),
        coarse_solver=ReductionControl(4000, 1e-9, 1e-9))
    solver = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)
    solver.compute_basis()
    solver.assemble_coarse_operator()
    solver.assemble_fine_rhs()
    solver.solve_fine_fem()
    res = solver.fine_cg
    assert bool(res.converged), "fine CG did not converge"
    return int(res.n_iter)


def main():
    dims = [(2, 6), (3, 4)]          # 64^2 and 16^3 coarse cells
    print(f"{'grid':>8} {'contrast':>10} {'jacobi':>8} {'two_level':>10}")
    for dim, refine in dims:
        n = 2 ** refine
        for contrast in (1e0, 1e2, 1e4):
            its = {p: run(dim, refine, contrast, p)
                   for p in ("jacobi", "two_level")}
            print(f"{n:>4}^{dim:<3} {contrast:>10.0e} {its['jacobi']:>8} "
                  f"{its['two_level']:>10}", flush=True)


if __name__ == "__main__":
    main()
