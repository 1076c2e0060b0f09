"""End-to-end pipeline tests — mirrors reference tests
Poisson_LOD_Example.cc (golden quantities), assembly_01/02 + parallel_assembly
(A_LOD = C^T A C identity), and validates LOD convergence mathematically."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp

from dealii_slod_tpu.config import ReductionControl, SLODConfig
from dealii_slod_tpu.models import LODSolver, DiffusionProblem, ElasticityProblem


def make_solver(**kw):
    defaults = dict(dim=2, n_global_refinements=2, n_subdivisions=2,
                    oversampling=1, rhs="1", bc="0",
                    constant_coefficients=True)
    defaults.update(kw)
    cfg = SLODConfig(**defaults)
    prob = (ElasticityProblem(cfg) if defaults.get("n_components", 1) == 2
            else DiffusionProblem(cfg))
    return LODSolver(cfg, prob, verbose=False)


def test_golden_deterministic_quantities():
    # tests/Poisson_LOD_Example.output:1-6 (alpha-independent entries)
    sol = make_solver()
    assert sol.topo.n_patches == 16
    sizes = sol.topo.patch_sizes()
    assert (sizes.min(), sizes.max()) == (4, 9)
    sol.compute_basis()
    sol.assemble_fine_rhs()
    assert sol.grid.n_fine_dofs == 81
    assert sol.grid.n_coarse_dofs == 16
    np.testing.assert_allclose(float(jnp.linalg.norm(sol.fem_rhs)),
                               0.109375, rtol=1e-14)


def _explicit_C_matrices(sol):
    """Build explicit sparse C and AC from the canvases (independent of the
    stencil path) — the reference's basis_matrix_transposed /
    premultiplied_basis_matrix (LOD.cc:913-965)."""
    P, C = sol.topo.n_patches, sol.C
    n_rows = sol.grid.n_nodes * C
    gidx = np.asarray(sol.canvas_gidx)                   # (P, canvas)
    mats = []
    for arr in (np.asarray(sol.Phi), np.asarray(sol.APhi)):
        rows, cols, vals = [], [], []
        for p in range(P):
            for c in range(C):
                for d in range(C):
                    rows.append(gidx[p] * C + c)
                    cols.append(np.full(gidx.shape[1], p * C + d))
                    vals.append(arr[p, :, c, d])
        M = sp.coo_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(n_rows, P * C)).tocsr()
        mats.append(M)
    return mats


@pytest.mark.parametrize("n_components", [1, 2])
def test_stencil_equals_explicit_triple_product(n_components):
    """A_LOD stencil == C^T (A C) computed with explicit scipy sparse
    matrices (mirrors assembly_01/02 and parallel_assembly identities).

    Note: clamped out-of-window canvas entries hold exact zeros, so the
    duplicate-summing COO construction is safe."""
    sol = make_solver(n_components=n_components,
                      constant_coefficients=False, coef_seed=3)
    sol.compute_basis()
    sol.assemble_coarse_operator()
    Cmat, ACmat = _explicit_C_matrices(sol)
    A_ref = (Cmat.T @ ACmat).toarray()                   # (PC, PC)
    P, C = sol.topo.n_patches, sol.C
    A_st = np.asarray(sol.A_stencil)                     # (P, S, C, C)
    nbr = np.asarray(sol.stencil_nbr)
    valid = np.asarray(sol.stencil_valid)
    A_full = np.zeros((P * C, P * C))
    for q in range(P):
        for k in range(sol.n_stencil):
            if valid[q, k]:
                p = nbr[q, k]
                A_full[q * C:(q + 1) * C, p * C:(p + 1) * C] = A_st[q, k]
    np.testing.assert_allclose(A_full, A_ref, rtol=1e-10, atol=1e-12)
    # symmetry of the coarse operator (a(phi_p, phi_q) form)
    np.testing.assert_allclose(A_full, A_full.T, rtol=1e-9, atol=1e-11)


def test_lod_error_decays_exponentially_in_oversampling():
    """The plain-LOD localization error decays exponentially in the
    oversampling radius l (the defining property of the method; the slow
    decay at small l is exactly what SLOD stabilization improves)."""
    errs = []
    for ell in (1, 2, 3):
        sol = make_solver(n_global_refinements=3, oversampling=ell,
                          solve_fine_problem=False,
                          rhs="2*pi^2*sin(pi*x)*sin(pi*y)",
                          exact_solution="sin(pi*x)*sin(pi*y)")
        res = sol.run()
        errs.append(res["error_LOD_exact"].rows[0][2]["L2"])
    assert errs[1] < 0.5 * errs[0], errs
    assert errs[2] < 0.5 * errs[1], errs


def test_ideal_lod_matches_fem_accuracy():
    """With full-domain patches (l >= N) the basis is the ideal LOD basis and
    the Galerkin solution must reach fine-FEM accuracy."""
    sol = make_solver(n_global_refinements=2, oversampling=4,
                      rhs="2*pi^2*sin(pi*x)*sin(pi*y)",
                      exact_solution="sin(pi*x)*sin(pi*y)")
    res = sol.run()
    err = res["error_LOD_exact"].rows[0][2]["L2"]
    fem_err = res["error_FEMh_exact"].rows[0][2]["L2"]
    assert fem_err < 8e-3
    assert err < 1.5 * fem_err + 1e-4, (err, fem_err)


def test_elasticity_pipeline_runs():
    sol = make_solver(n_components=2, rhs="1; 1",
                      n_global_refinements=2, oversampling=1)
    res = sol.run()
    u = np.asarray(res["lod_solution"])
    assert np.isfinite(u).all()
    err = res["error_LOD_FEMh"].rows[0][2]["L2"]
    fem = np.asarray(res["fem_solution"])
    assert err < 0.5 * np.linalg.norm(fem) + 1e-6


def test_random_coefficients_pipeline():
    sol = make_solver(constant_coefficients=False, coef_seed=1,
                      n_global_refinements=3, oversampling=2)
    res = sol.run()
    err = res["error_LOD_FEMh"].rows[0][2]["L2"]
    # LOD should track the fine FEM closely even for rough coefficients
    femn = float(np.sqrt((np.asarray(res["fem_solution"]) ** 2).sum()))
    assert np.isfinite(err) and err < femn


def test_reference_parity_mode_glibc_field():
    from dealii_slod_tpu.models.coefficients import GlibcRand
    g = GlibcRand()
    assert list(g.draw(3)) == [1804289383, 846930886, 1681692777]
    conv = GlibcRand().uniform_reference(1, 100, 2)
    np.testing.assert_array_equal(
        conv, [84.1785888671875, 40.043910980224609])


def test_dedup_matches_full_computation():
    """Constant-coefficient dedup (unique window signatures) must reproduce
    the full per-patch computation exactly."""
    import jax
    from dealii_slod_tpu.config import SLODConfig
    cfg = SLODConfig(dim=2, n_global_refinements=3, n_subdivisions=2,
                     oversampling=2, lod_stabilization=True,
                     constant_coefficients=True)
    a = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)
    a.compute_basis()
    # disable dedup by monkeypatching is_constant
    cfg2 = SLODConfig(dim=2, n_global_refinements=3, n_subdivisions=2,
                      oversampling=2, lod_stabilization=True,
                      constant_coefficients=True)
    prob2 = DiffusionProblem(cfg2)
    prob2.is_constant = lambda: False
    b = LODSolver(cfg2, prob2, verbose=False)
    b.compute_basis()
    np.testing.assert_allclose(np.asarray(a.Phi), np.asarray(b.Phi),
                               atol=1e-13)
    # unique signatures are bounded by (2l+3)^dim independent of N
    gsub, nlo, nhi, sides = a._uniform_inputs()
    rep, inv = a._patch_dedup(nlo, nhi, sides)
    assert len(rep) <= (2 * 2 + 3) ** 2
    assert len(inv) == a.topo.n_patches


def test_3d_elasticity_runs():
    """North-star config family E: 3D elasticity (new vs the reference)."""
    from dealii_slod_tpu.config import SLODConfig
    cfg = SLODConfig(dim=3, n_components=3, n_global_refinements=2,
                     n_subdivisions=2, oversampling=1,
                     lod_stabilization=True, constant_coefficients=False,
                     coef_seed=1, coef_refinement=3, rhs="1; 0; 0", bc="0",
                     solve_fine_problem=True)
    sol = LODSolver(cfg, ElasticityProblem(cfg), verbose=False)
    res = sol.run()
    u = np.asarray(res["lod_solution"])
    assert u.shape == (sol.grid.n_nodes, 3)
    assert np.isfinite(u).all()
    err = res["error_LOD_FEMh"].rows[0][2]["L2"]
    femn = float(np.sqrt((np.asarray(res["fem_solution"]) ** 2).sum()))
    assert err < femn


def test_elasticity_parity_shares_rand_stream():
    """In reference-parity mode Lambda and Mu draw sequentially from one
    glibc rand() stream (reference constructs Lambda then Mu,
    Elasticity.h:104-105)."""
    from dealii_slod_tpu.config import SLODConfig
    from dealii_slod_tpu.models.coefficients import GlibcRand
    cfg = SLODConfig(dim=2, reference_parity=True, coef_refinement=6)
    prob = ElasticityProblem(cfg)
    n = (2 ** 6) ** 2
    ref = GlibcRand().uniform_reference(1, 100, 2 * n)
    np.testing.assert_array_equal(prob.lam.values, ref[:n])
    np.testing.assert_array_equal(prob.mu.values, ref[n:])


def test_glibc_sampler_matches_compiled_c(tmp_path):
    """The 'platform rand()' golden-anchor claim, made
    checkable — compile the reference's 20-line sampling loop
    (Poisson_LOD_Example.cc:1483-1502 / Diffusion.h:28-36) with THIS
    machine's libc and require bit-identity with GlibcRand."""
    import shutil
    import subprocess

    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        import pytest
        pytest.skip("no C compiler")
    import os
    src = os.path.join(os.path.dirname(__file__), "..", "native",
                       "ref_sampler.c")
    exe = str(tmp_path / "ref_sampler")
    subprocess.run([cc, "-O2", "-o", exe, src, "-lm"], check=True)
    out = subprocess.run([exe, "1", "100", "8", "2"], capture_output=True,
                         text=True, check=True).stdout
    c_vals = np.array([float(x) for x in out.split()])
    from dealii_slod_tpu.models.coefficients import GlibcRand
    py_vals = GlibcRand().uniform_reference(1.0, 100.0, len(c_vals))
    assert np.array_equal(c_vals, py_vals)


def test_channel_coefficient_pipeline():
    """End-to-end with the channel coefficient field (the reference declares
    channel_parameter, Elasticity.h:56-89, but never wires it; here it is a
    first-class option via coef_field='channel')."""
    import numpy as np
    from dealii_slod_tpu.config import SLODConfig
    from dealii_slod_tpu.models import DiffusionProblem, LODSolver

    cfg = SLODConfig(dim=2, n_global_refinements=3, n_subdivisions=2,
                     oversampling=2, lod_stabilization=True,
                     constant_coefficients=False, coef_field="channel",
                     rhs="1", bc="0", dtype="float64", write_output=False)
    s = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)
    s.compute_basis()
    s.assemble_coarse_operator()
    s.assemble_fine_rhs()
    u = s.solve_coarse()
    assert np.isfinite(np.asarray(u)).all()
    assert np.abs(np.asarray(u)).max() > 0
    # channel field must actually differ from the random field
    cfg2 = SLODConfig(dim=2, n_global_refinements=3, n_subdivisions=2,
                      oversampling=2, lod_stabilization=True,
                      constant_coefficients=False, rhs="1", bc="0",
                      dtype="float64", write_output=False)
    s2 = LODSolver(cfg2, DiffusionProblem(cfg2), verbose=False)
    a1 = np.asarray(s.coef_q["alpha"])
    a2 = np.asarray(s2.coef_q["alpha"])
    assert np.abs(a1 - a2).max() > 1.0


def test_convergence_rates_multirow_table():
    """Multi-row convergence study (reference accumulates
    ParsedConvergenceTable rows over refinements, LOD.h:111-115): with
    stabilization and l ~ log2(N) the L2 error vs the fine FEM solution
    must decay by >= 4x per refinement step, and the reported H1 norm must
    be the FULL deal.II H1_norm = sqrt(L2^2 + seminorm^2)."""
    from dealii_slod_tpu.utils.errors import ConvergenceTable

    table = ConvergenceTable("errLOD")
    errs = []
    for (r, ell) in ((2, 1), (3, 2), (4, 3)):
        cfg = SLODConfig(dim=2, n_global_refinements=r, n_subdivisions=2,
                         oversampling=ell, lod_stabilization=True,
                         constant_coefficients=True,
                         rhs="2*pi^2*sin(pi*x)*sin(pi*y)", bc="0",
                         exact_solution="sin(pi*x)*sin(pi*y)",
                         error_norms=("L2", "H1", "H1_semi", "Linfty"),
                         fine_solver=ReductionControl(4000, 1e-12, 1e-10),
                         coarse_solver=ReductionControl(4000, 1e-12, 1e-10),
                         solve_fine_problem=True)
        sol = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)
        res = sol.run()
        cells, dofs, norms = res["error_LOD_FEMh"].rows[-1]
        table.add_row(cells, dofs, norms)
        errs.append(norms["L2"])
        np.testing.assert_allclose(
            norms["H1"], np.hypot(norms["L2"], norms["H1_semi"]),
            rtol=1e-12)
    assert len(table.rows) == 3 and "errLOD_" in str(table)
    assert errs[1] < errs[0] / 4 and errs[2] < errs[1] / 4, errs


@pytest.mark.parametrize("n_components,refine", [(1, 2), (2, 2), (1, 3)])
def test_coarse_dense_matrix_matches_stencil(n_components, refine):
    """The placement-embedded dense coarse matrix (models/stencil.py
    coarse_dense_matrix) equals the loop-scattered stencil expansion, and
    its matvec equals the slice-stack stencil matvec.  refine=2 exercises
    the static-scatter fallback (stencil span > lattice row block),
    refine=3 the placement-matmul path."""
    sol = make_solver(n_components=n_components, n_global_refinements=refine,
                      constant_coefficients=False, coef_seed=5)
    sol.compute_basis()
    sol.assemble_coarse_operator()
    P, C = sol.topo.n_patches, sol.C
    A_st = np.asarray(sol.A_stencil)
    nbr = np.asarray(sol.stencil_nbr)
    valid = np.asarray(sol.stencil_valid)
    A_full = np.zeros((P * C, P * C))
    for q in range(P):
        for k in range(sol.n_stencil):
            if valid[q, k]:
                p = nbr[q, k]
                A_full[q * C:(q + 1) * C, p * C:(p + 1) * C] = A_st[q, k]
    Ad = np.asarray(sol.coarse_dense_matrix(sol.A_stencil))
    np.testing.assert_allclose(Ad, A_full, rtol=1e-12, atol=1e-13)
    rng = np.random.default_rng(0)
    u = rng.standard_normal((P, C))
    mv_dense = sol._coarse_matvec_fn(sol.A_stencil)(jnp.asarray(u))
    mv_sten = sol.coarse_matvec(jnp.asarray(u))
    np.testing.assert_allclose(np.asarray(mv_dense), np.asarray(mv_sten),
                               rtol=1e-10, atol=1e-12)


def test_elasticity_convergence_rates():
    """Elasticity is a first-class peer of diffusion in the reference
    (Elasticity.h:92-438); mirror the manufactured-solution rate ladder for
    it.  With lam = mu = 1 and u = (w, w), w = sin(pi x) sin(pi y),
    -div(2 mu eps(u) + lam div(u) I) gives f_i = 4 pi^2 w
    - 2 pi^2 cos(pi x) cos(pi y).  The FEM error must decay ~4x per
    refinement (second order) and the stabilized LOD must track the fine
    FEM solution at a faster-than-FEM rate (l ~ log2 N)."""
    w = "sin(pi*x)*sin(pi*y)"
    f = "4*pi^2*sin(pi*x)*sin(pi*y) - 2*pi^2*cos(pi*x)*cos(pi*y)"
    fem_errs, lod_fem_errs = [], []
    for (r, ell) in ((2, 1), (3, 2), (4, 3)):
        cfg = SLODConfig(dim=2, n_components=2, n_global_refinements=r,
                         n_subdivisions=2, oversampling=ell,
                         lod_stabilization=True, constant_coefficients=True,
                         rhs=f + "; " + f, bc="0",
                         exact_solution=w + "; " + w,
                         error_norms=("L2", "H1", "H1_semi", "Linfty"),
                         fine_solver=ReductionControl(8000, 1e-12, 1e-10),
                         coarse_solver=ReductionControl(8000, 1e-12, 1e-10),
                         solve_fine_problem=True)
        sol = LODSolver(cfg, ElasticityProblem(cfg), verbose=False)
        res = sol.run()
        fem_errs.append(res["error_FEMh_exact"].rows[-1][2]["L2"])
        lod_fem_errs.append(res["error_LOD_FEMh"].rows[-1][2]["L2"])
    # second-order FEM: ~4x per halving (allow slack for the asymptotic
    # constant at the coarsest level)
    assert fem_errs[1] < fem_errs[0] / 3 and fem_errs[2] < fem_errs[1] / 3, \
        fem_errs
    # LOD-vs-FEMh decays faster than the FEM error itself (measured ~20x)
    assert lod_fem_errs[1] < lod_fem_errs[0] / 4
    assert lod_fem_errs[2] < lod_fem_errs[1] / 4, lod_fem_errs


@pytest.mark.parametrize("dim,s,l,r,tol", [
    (2, 3, 1, 2, 2e-2),   # odd subdivisions
    (2, 3, 2, 3, 5e-4),   # odd subdivisions, error decays with l
    (2, 2, 3, 3, 1e-6),   # deep oversampling
    (3, 3, 1, 2, 3e-2),   # odd subdivisions, 3D
])
def test_nonstandard_discretizations(dim, s, l, r, tol):
    """The reference's LODParameters allow any (s, l); the suite otherwise
    only exercises s in {2, 4} and l in {1, 2, 4}.  Guard the odd-s PT
    weights / banded-assembly subcell windows and deep-l canvases with a
    method-error bound (LOD vs fine FEM on the same mesh)."""
    cfg = SLODConfig(dim=dim, n_global_refinements=r, n_subdivisions=s,
                     oversampling=l, lod_stabilization=True,
                     constant_coefficients=False, coef_seed=0,
                     rhs="1", bc="0", dtype="float64",
                     solve_fine_problem=True,
                     fine_solver=ReductionControl(8000, 1e-12, 1e-12),
                     coarse_solver=ReductionControl(4000, 1e-12, 1e-12))
    sol = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)
    sol.compute_basis()
    sol.assemble_coarse_operator()
    sol.assemble_fine_rhs()
    sol.solve_coarse()
    u = np.asarray(sol.prolong_lod_solution())
    sol.solve_fine_fem()
    uf = np.asarray(sol.fem_solution)
    err = np.linalg.norm(u - uf) / np.linalg.norm(uf)
    assert np.isfinite(err) and err < tol, err


def test_poisson_lod_example_rhs_anchor_exact():
    """The last open golden anchor, closed: the reference's
    `rhs l2 norm = 0.0808367` (tests/Poisson_LOD_Example.output:5) was
    generated after 12 unseeded glibc rand() draws were consumed by library
    init BEFORE the Alpha(1, 100, 8) ctor (found by exhaustive offset scan,
    scripts/anchor_probe.py).  With reference_parity sampling at
    coef_rand_offset=12 this pipeline reproduces the anchor to 1.7e-8 —
    killing the r2/r3 'platform-random, unreproducible' theory."""
    import os
    import re
    out = "/root/reference/tests/Poisson_LOD_Example.output"
    if not os.path.exists(out):
        pytest.skip("reference tree not present")
    golden = float(next(re.search(r"rhs l2 norm = ([\d.]+)", ln).group(1)
                        for ln in open(out) if re.match(r"\s*rhs l2 norm",
                                                        ln)))
    cfg = SLODConfig(dim=2, n_global_refinements=2, n_subdivisions=2,
                     oversampling=1, lod_stabilization=False,
                     constant_coefficients=True, coef_refinement=8,
                     rhs="1", bc="0", dtype="float64",
                     solve_fine_problem=False, reference_parity=True,
                     coef_rand_offset=12,
                     coarse_solver=ReductionControl(100, 1e-9, 1e-9))
    # x64 is enabled suite-wide in conftest.py
    s = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)
    s.compute_basis()
    s.assemble_fine_rhs()
    f_at = s._rhs_windows(s.fem_rhs)
    rhs_c = jnp.einsum("pncd,pnc->pd", s.Phi, f_at)
    v = float(jnp.linalg.norm(rhs_c))
    # the golden prints 6 significant digits (quantization ~5e-8)
    assert abs(v - golden) < 5e-7, f"{v} vs golden {golden}"
