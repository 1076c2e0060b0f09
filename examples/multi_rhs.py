"""Serving-style workflow: build the SLOD basis ONCE, then answer many
right-hand sides at coarse-solve latency.

The expensive stage is basis construction (patch solves + stabilization).
The coarse operator and the basis canvases are plain arrays afterwards, so
each new load case costs one jitted (C^T f -> CG -> prolong) pass — and
with `utils.checkpoint` the basis survives process restarts, so a serving
process can answer load cases without ever re-running the basis stage.

    JAX_PLATFORMS=cpu python examples/multi_rhs.py
    MR_DIM=3 MR_REFINE=4 python examples/multi_rhs.py      # GPU
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np
import jax.numpy as jnp

from dealii_slod_tpu.config import ReductionControl, SLODConfig
from dealii_slod_tpu.models import DiffusionProblem, LODSolver


def main():
    dim = int(os.environ.get("MR_DIM", 2))
    refine = int(os.environ.get("MR_REFINE", 4))
    n_rhs = int(os.environ.get("MR_RHS", 16))

    cfg = SLODConfig(
        dim=dim, n_global_refinements=refine, n_subdivisions=2,
        oversampling=2, lod_stabilization=True,
        constant_coefficients=False, coef_seed=0, coef_refinement=4,
        rhs="1", bc="0", dtype=os.environ.get("MR_DTYPE", "float32"),
        solve_fine_problem=False,
        coarse_solver=ReductionControl(500, 1e-8, 1e-8))
    solver = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)

    t0 = time.perf_counter()
    solver.compute_basis()
    solver.assemble_coarse_operator()
    jax.block_until_ready(solver.A_stencil)
    t_basis = time.perf_counter() - t0
    P = solver.topo.n_patches

    # jitted serve path: fem load vector -> coarse rhs -> solve.  With
    # MR_COARSE=direct (default when the system fits coarse_dense_cap) the
    # Cholesky factor is computed ONCE here — each served case then costs
    # two triangular solves instead of a CG iteration loop.
    fits_cap = P * solver.C <= cfg.coarse_dense_cap
    mode = os.environ.get("MR_COARSE", "direct" if fits_cap else "cg")
    if mode == "direct" and not fits_cap:
        # the library's own direct path refuses above the cap (an uncapped
        # dense factor is a multi-GB allocation); mirror that here
        print(f"MR_COARSE=direct: {P * solver.C} coarse dofs exceed "
              f"coarse_dense_cap={cfg.coarse_dense_cap}; using cg")
        mode = "cg"
    if mode == "direct":
        direct = solver._coarse_direct_fn(solver.A_stencil)

        @jax.jit
        def serve(fem_rhs):
            f_at = solver._rhs_windows(fem_rhs)
            rhs_c = jnp.einsum("pncd,pnc->pd", solver.Phi, f_at)
            return direct(rhs_c)
    else:
        @jax.jit
        def serve(fem_rhs):
            f_at = solver._rhs_windows(fem_rhs)
            rhs_c = jnp.einsum("pncd,pnc->pd", solver.Phi, f_at)
            from dealii_slod_tpu.ops.solvers import cg
            diag = jnp.einsum("pdd->pd",
                              solver.A_stencil[:, solver.center_offset_idx])
            rc = cfg.coarse_solver
            res = cg(solver._coarse_matvec_fn(solver.A_stencil), rhs_c,
                     max_steps=rc.max_steps, tolerance=rc.tolerance,
                     reduce=rc.reduce, precond=lambda r: r / diag)
            return res.x

    rng = np.random.default_rng(0)
    n_nodes = solver.grid.n_nodes
    loads = [jnp.asarray(rng.standard_normal((n_nodes, 1)), solver.dtype)
             for _ in range(n_rhs + 1)]
    u = serve(loads[0])
    float(jnp.sum(u))                         # compile + fetch
    walls = []
    for f in loads[1:]:
        t0 = time.perf_counter()
        u = serve(f)
        float(jnp.sum(u))
        walls.append(time.perf_counter() - t0)

    print(f"config: dim={dim} refine={refine} patches={P} coarse={mode}")
    print(f"basis + operator (once): {t_basis:.2f} s")
    print(f"serve latency per rhs: median {np.median(walls) * 1e3:.1f} ms "
          f"(min {min(walls) * 1e3:.1f}) over {n_rhs} load cases "
          f"-> {t_basis / np.median(walls):.0f}x cheaper than rebuilding")


if __name__ == "__main__":
    main()
