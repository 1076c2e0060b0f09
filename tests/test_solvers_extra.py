"""Solver extras: two-level preconditioner, channel field, batched multi-RHS
solve vs per-column (mirrors reference tests mv_solve_01/02)."""

import numpy as np
import jax.numpy as jnp

from dealii_slod_tpu.config import ReductionControl, SLODConfig
from dealii_slod_tpu.models import LODSolver, DiffusionProblem
from dealii_slod_tpu.models.coefficients import ChannelField
from dealii_slod_tpu.ops.solvers import cholesky_factor, cholesky_solve, spd_solve


def test_multirhs_equals_percolumn():
    # mirrors mv_solve_02.cc: block multi-RHS solve == column-by-column
    rng = np.random.default_rng(0)
    n, k = 40, 7
    M = rng.standard_normal((n, n))
    A = jnp.asarray(M @ M.T + n * np.eye(n))
    B = jnp.asarray(rng.standard_normal((n, k)))
    X_block = spd_solve(A, B)
    L = cholesky_factor(A)
    X_cols = jnp.stack([cholesky_solve(L, B[:, j:j + 1])[:, 0]
                        for j in range(k)], axis=1)
    np.testing.assert_allclose(np.asarray(X_block), np.asarray(X_cols),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(A @ X_block), np.asarray(B),
                               rtol=1e-9)


def test_two_level_preconditioner_accelerates_and_agrees():
    sols = {}
    for precond in ("jacobi", "two_level"):
        cfg = SLODConfig(dim=2, n_global_refinements=3, n_subdivisions=4,
                         oversampling=2, lod_stabilization=True,
                         constant_coefficients=False, coef_seed=3,
                         coef_max=1e4, rhs="1", bc="0",
                         fine_preconditioner=precond,
                         fine_solver=ReductionControl(4000, 1e-10, 1e-10))
        sol = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)
        sol.compute_basis()
        sol.assemble_coarse_operator()
        sol.assemble_fine_rhs()
        sol.solve_fine_fem()
        sols[precond] = sol
    it_j = int(sols["jacobi"].fine_cg.n_iter)
    it_t = int(sols["two_level"].fine_cg.n_iter)
    assert it_t < it_j / 2, (it_j, it_t)
    np.testing.assert_allclose(np.asarray(sols["jacobi"].fem_solution),
                               np.asarray(sols["two_level"].fem_solution),
                               atol=1e-8)


def test_channel_field():
    f = ChannelField(1.0, 100.0, 4)  # eta = 1/16
    pts = np.array([[0.33, 0.5],    # inside first x-channel
                    [0.5, 0.33],    # inside first y-channel
                    [0.33, 0.33],   # both
                    [0.5, 0.5]])    # neither
    v = f(pts)
    np.testing.assert_allclose(v, [51.0, 51.0, 101.0, 1.0])


def test_channel_field_config_wiring():
    cfg = SLODConfig(dim=2, n_global_refinements=2, n_subdivisions=2,
                     oversampling=1, coef_field="channel",
                     constant_coefficients=False)
    prob = DiffusionProblem(cfg)
    pts = np.array([[0.5, 0.5]])
    assert prob.coefficients(pts)["alpha"][0] == 1.0
    sol = LODSolver(cfg, prob, verbose=False)
    res = sol.run()
    assert np.isfinite(np.asarray(res["lod_solution"])).all()


def test_two_level_stencil_variant_matches_dense():
    """The cap-free Chebyshev coarse correction must accelerate the fine CG
    like the dense-factor variant (same preconditioner role, no 32768-dof
    densification)."""
    import jax.numpy as jnp
    from dealii_slod_tpu.config import SLODConfig
    from dealii_slod_tpu.models import DiffusionProblem, LODSolver

    kw = dict(dim=2, n_global_refinements=3, n_subdivisions=2,
              oversampling=2, lod_stabilization=True,
              constant_coefficients=False, coef_seed=9, rhs="1", bc="0",
              fine_preconditioner="two_level", write_output=False)
    cfg = SLODConfig(**kw)
    s = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)
    s.compute_basis(); s.assemble_coarse_operator(); s.assemble_fine_rhs()
    d = np.ones_like(np.asarray(s.fem_rhs))
    import jax
    diag = jnp.asarray(d)
    p_dense = s._two_level_precond(diag)
    p_sten = s._two_level_precond_stencil(diag)
    r = s.fem_rhs
    a = np.asarray(p_dense(r))
    b = np.asarray(p_sten(r))
    # Chebyshev(16) approximates the exact coarse solve to a few percent —
    # enough for preconditioning equivalence
    assert np.abs(a - b).max() < 0.1 * np.abs(a).max()
    # and the stencil variant actually accelerates the fine solve
    u1 = s.solve_fine_fem()
    it_two = int(s.fine_cg.n_iter)
    cfg2 = SLODConfig(**{**kw, "fine_preconditioner": "jacobi"})
    s2 = LODSolver(cfg2, DiffusionProblem(cfg2), verbose=False)
    s2.compute_basis(); s2.assemble_coarse_operator(); s2.assemble_fine_rhs()
    s2.solve_fine_fem()
    assert it_two < int(s2.fine_cg.n_iter)


def test_cg_exact_iteration_count_and_converged_flag():
    """The chunked-while CG must report the exact per-iteration deal.II
    count and an explicit converged flag: a solve converging inside the
    final chunk or exactly at max_steps must not be flagged as
    non-converged, and iterations never exceed max_steps."""
    from dealii_slod_tpu.ops.solvers import cg

    rng = np.random.default_rng(1)
    n = 60
    M = rng.standard_normal((n, n))
    A = jnp.asarray(M @ M.T + n * np.eye(n))
    b = jnp.asarray(rng.standard_normal(n))
    mv = lambda x: A @ x

    # unchunked reference run (check_every=1 == textbook per-iteration stop)
    ref = cg(mv, b, max_steps=500, tolerance=1e-12, reduce=1e-10,
             check_every=1)
    res = cg(mv, b, max_steps=500, tolerance=1e-12, reduce=1e-10,
             check_every=8)
    assert bool(ref.converged) and bool(res.converged)
    assert int(res.n_iter) == int(ref.n_iter)     # exact, not chunk-rounded
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-10)

    # converging exactly AT the cap is converged, one past it is not
    it = int(ref.n_iter)
    at_cap = cg(mv, b, max_steps=it, tolerance=1e-12, reduce=1e-10,
                check_every=8)
    assert bool(at_cap.converged) and int(at_cap.n_iter) == it
    capped = cg(mv, b, max_steps=it - 2, tolerance=1e-12, reduce=1e-10,
                check_every=8)
    assert not bool(capped.converged)
    assert int(capped.n_iter) == it - 2           # clamped to max_steps

    # initial guess already converged -> zero iterations
    x_exact = jnp.linalg.solve(A, b)
    warm = cg(mv, b, x0=x_exact, max_steps=50, tolerance=1e-8, reduce=1e-6,
              check_every=8)
    assert bool(warm.converged) and int(warm.n_iter) == 0


def test_channel_field_rejects_3d():
    """The reference channel_parameter is an (x, y)-only pattern
    (Elasticity.h:56-89); a silent 2D extrusion in 3D would misrepresent
    the geometry — constructing it with dim=3 must raise."""
    import pytest

    with pytest.raises(ValueError):
        ChannelField(1.0, 100.0, 6, dim=3)


def test_two_level_cap_routes_to_stencil_variant():
    """Above ``two_level_dense_cap`` the fine preconditioner must use the
    cap-free stencil Chebyshev correction instead of materializing a
    (P*C)^2 dense factor (the old 32768 cap allowed an 8.6 GB
    host allocation)."""
    from dealii_slod_tpu.config import ReductionControl, SLODConfig
    from dealii_slod_tpu.models import DiffusionProblem, LODSolver

    kw = dict(dim=2, n_global_refinements=3, n_subdivisions=2,
              oversampling=2, lod_stabilization=True,
              constant_coefficients=False, coef_seed=9, rhs="1", bc="0",
              fine_preconditioner="two_level",
              two_level_dense_cap=16)        # 64 patches > cap
    cfg = SLODConfig(**kw)
    s = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)
    s.compute_basis(); s.assemble_coarse_operator(); s.assemble_fine_rhs()
    called = {}
    orig = s._two_level_precond_stencil

    def spy(diag):
        called["stencil"] = True
        return orig(diag)

    s._two_level_precond_stencil = spy
    s.solve_fine_fem()
    assert called.get("stencil"), "dense path used above the cap"
    assert bool(s.fine_cg.converged)


def test_direct_coarse_solve_matches_cg():
    """cfg.coarse_solve="direct" (dense Cholesky below coarse_dense_cap)
    must reproduce the CG coarse solution — both in the eager
    ``solve_coarse`` stage and inside the jitted ``build_step``; above the
    cap it must fall back to CG."""
    import numpy as np
    from dealii_slod_tpu.config import ReductionControl, SLODConfig
    from dealii_slod_tpu.models import DiffusionProblem, LODSolver

    kw = dict(dim=2, n_global_refinements=3, n_subdivisions=2,
              oversampling=2, lod_stabilization=True,
              constant_coefficients=False, coef_seed=4, rhs="1", bc="0",
              dtype="float64", write_output=False,
              coarse_solver=ReductionControl(800, 1e-12, 1e-12))
    out = {}
    for mode in ("cg", "direct"):
        cfg = SLODConfig(**kw, coarse_solve=mode)
        s = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)
        s.compute_basis(); s.assemble_coarse_operator()
        s.assemble_fine_rhs()
        u = np.asarray(s.solve_coarse())
        step = s.build_step()
        u_step, _ = step(s.coef_q, s.fem_rhs)
        # jit-vs-eager fusion roundoff is CG/conditioning-amplified to
        # ~3e-8 relative at this config
        np.testing.assert_allclose(np.asarray(u_step), u, rtol=1e-6,
                                   atol=1e-12)
        out[mode] = u
    np.testing.assert_allclose(out["direct"], out["cg"], rtol=1e-6,
                               atol=1e-11)
    # above the cap: direct must route back to CG (coarse_cg populated)
    cfg = SLODConfig(**kw, coarse_solve="direct", coarse_dense_cap=4)
    s = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)
    s.compute_basis(); s.assemble_coarse_operator(); s.assemble_fine_rhs()
    u_cap = np.asarray(s.solve_coarse())
    assert s.coarse_cg is not None
    np.testing.assert_allclose(u_cap, out["cg"], rtol=1e-8, atol=1e-11)
