"""Pin bench.py's hand-maintained FLOP model to XLA's own cost analysis:
the analytic per-stage counts must track what the compiled
pipeline actually executes, so reported TFLOPs/MFU stay honest as kernels
evolve.

Methodology: XLA cost_analysis counts dot as 2mnk and fused elementwise
once per output element, but (a) counts LAPACK/lax linalg custom calls
(Cholesky, TRSM, eigh) as ZERO and (b) counts scan/while bodies ONCE
regardless of trip count.  So the comparison uses a single-chunk config
(patch_chunk >= n_patches) and compares only the XLA-countable stages; the
custom-call stages (cholesky, trsm, spectral, T_inverse) are textbook
closed forms that do not drift with implementation changes."""

import jax
import jax.numpy as jnp
import pytest

from dealii_slod_tpu.config import ReductionControl, SLODConfig
from dealii_slod_tpu.models import DiffusionProblem, ElasticityProblem, \
    LODSolver

import bench

# stages lowered to linalg custom calls / while bodies that XLA counts as
# zero (or once) on CPU
_NOT_XLA_COUNTABLE = {"cholesky", "trsm_multirhs", "slod_spectral",
                      "T_inverse", "coarse_cg"}


def _xla_vs_model(dim, refine, ell, problem):
    cfg = SLODConfig(
        dim=dim, n_global_refinements=refine, n_subdivisions=2,
        oversampling=ell, lod_stabilization=True,
        constant_coefficients=False, coef_seed=0, coef_refinement=5,
        rhs="1" if problem == "diffusion" else "; ".join(["1"] * dim),
        bc="0", dtype="float32",
        patch_chunk=4096,          # single chunk: scan bodies count once
        solve_fine_problem=False,
        coarse_solver=ReductionControl(500, 1e-6, 1e-6))
    prob = (ElasticityProblem(cfg) if problem == "elasticity"
            else DiffusionProblem(cfg))
    solver = LODSolver(cfg, prob, verbose=False)
    solver.assemble_fine_rhs()
    step = jax.jit(solver.build_step())
    ca = step.lower(solver.coef_q, solver.fem_rhs).compile().cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    xla = float(ca.get("flops", 0.0))
    stages = bench.flops_model(dim, ell, 2, solver.C, solver.topo.n_patches,
                               solver.n_stencil, slod=True, banded=True)
    countable = sum(v for k, v in stages.items()
                    if k not in _NOT_XLA_COUNTABLE)
    return xla, countable


@pytest.mark.parametrize("dim,refine,ell,problem", [
    (3, 2, 2, "diffusion"),       # bench per-patch shapes (729/125)
    (2, 3, 2, "diffusion"),
    (2, 3, 2, "elasticity"),
])
def test_flops_model_tracks_xla_cost_analysis(dim, refine, ell, problem):
    xla, countable = _xla_vs_model(dim, refine, ell, problem)
    assert xla > 0
    ratio = xla / countable
    # Asymmetric bounds: ratio < 1 means the model CHARGES MORE than the
    # compiled pipeline executes — that inflates reported TFLOPs/MFU, the
    # failure mode this test exists to catch (the r3 model charged the
    # banded trace stage 27x dense) — so the lower bound is tight.
    # ratio > 1 means unmodeled elementwise/mask work (relatively large at
    # small 2D shapes) — MFU is then conservative, so the bound is loose.
    assert 0.85 <= ratio <= 1.8, (
        f"FLOP model drifted from XLA cost analysis: xla={xla:.3e} "
        f"model-countable={countable:.3e} ratio={ratio:.3f}")
