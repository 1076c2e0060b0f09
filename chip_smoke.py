#!/usr/bin/env python3
"""Smoke test of the SLOD pipeline on an NVIDIA GPU.

Drives the main path through the entry points a user calls
(``LODSolver.build_step`` and ``python -m dealii_slod_tpu.cli``) at full
width, checks every result against a float64 reference, and prints as its
last line one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Usage (from the repository root):

    python chip_smoke.py               # phases 1-5 on one GPU
    python chip_smoke.py --four-cards  # only the four-GPU sharded paths

Phases: 1 device, 2 golden parity at float64, 3 main path at full width
(float32 at matmul precision "high" and "highest" against float64), 4 plain
reference at small size and the batched linear-algebra pieces at real
widths against NumPy float64, 5 the command-line application.  Any failed
check raises; the script then exits non-zero without a result line.  It
also exits non-zero when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# float32 against float64, relative L2 of the prolonged fine field.  The
# SLOD sigma-truncation loop takes discrete ||d||_inf < 0.5 decisions, and a
# patch near that threshold can stop one direction earlier in float32 than
# in float64 (a "truncation flip"), which moves its basis function by
# O(1e-3); a handful of flips among thousands of patches stays far below
# this bound, while a broken solve or a precision loss of whole digits
# does not.
F32_FIELD_TOL = 1e-2

# the golden numbers of the reference's Poisson_LOD_Example at N=4, s=2,
# l=1, alpha=1, f=1 (the coarse rhs norm of a truly constant alpha)
GOLDEN = dict(fem_rhs_norm=0.109375, fine_dofs=81, coarse_dofs=16,
              patches=16, patch_sizes=(4, 9), coarse_rhs_norm=0.0810737)

MAIN_CONFIGS = {
    # the bench configuration: 3D Poisson SLOD, 16^3 coarse cells
    "diffusion_3d_r4": dict(problem="diffusion", dim=3, refine=4, ell=2,
                            chunk=128),
    # the C > 1 path: 3D linear elasticity, 8^3 coarse cells
    "elasticity_3d_r3": dict(problem="elasticity", dim=3, refine=3, ell=2,
                             chunk=128),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def make_solver(problem="diffusion", dim=3, refine=4, ell=2, chunk=0,
                dtype="float32", **kw):
    """The bench configuration family: SLOD with random coefficients
    (contrast 100), rhs 1, homogeneous Dirichlet data."""
    from dealii_slod_tpu.config import ReductionControl, SLODConfig
    from dealii_slod_tpu.models import (DiffusionProblem, ElasticityProblem,
                                        LODSolver)

    C = dim if problem == "elasticity" else 1
    cfg = SLODConfig(
        dim=dim, n_global_refinements=refine, n_subdivisions=2,
        oversampling=ell, lod_stabilization=True, constant_coefficients=False,
        coef_seed=0, coef_refinement=5, rhs="; ".join(["1"] * C), bc="0",
        dtype=dtype, patch_chunk=chunk, solve_fine_problem=False,
        coarse_solver=ReductionControl(500, 1e-6, 1e-6), **kw)
    prob = (ElasticityProblem if problem == "elasticity"
            else DiffusionProblem)(cfg)
    return LODSolver(cfg, prob, verbose=False)


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(n_cards: int):
    import jax

    from dealii_slod_tpu.utils.runtime import card_name_and_power

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found (JAX platform "
                         f"{devs[0].platform!r}); nothing to test")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, found "
                         f"{len(devs)}")
    log(f"phase 1 device: platform={devs[0].platform} "
        f"kind={devs[0].device_kind} count={len(devs)}")
    log(f"phase 1 nvidia-smi name, power.limit: {card_name_and_power()}")
    from dealii_slod_tpu.utils import native
    log("phase 1 native topology library: "
        + ("built" if native.load() is not None
           else "not built (NumPy fallback on the host)"))
    return devs


def phase_golden():
    """Golden parity with the reference's Poisson_LOD_Example at float64."""
    import jax.numpy as jnp

    from dealii_slod_tpu.config import SLODConfig
    from dealii_slod_tpu.models import DiffusionProblem, LODSolver

    cfg = SLODConfig(dim=2, n_global_refinements=2, n_subdivisions=2,
                     oversampling=1, rhs="1", bc="0",
                     constant_coefficients=True, dtype="float64",
                     solve_fine_problem=False)
    s = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)
    s.compute_basis()
    s.assemble_coarse_operator()
    s.assemble_fine_rhs()
    s.solve_coarse()
    sizes = s.topo.patch_sizes()
    got = dict(fem_rhs_norm=float(jnp.linalg.norm(s.fem_rhs)),
               fine_dofs=s.grid.n_fine_dofs, coarse_dofs=s.grid.n_coarse_dofs,
               patches=s.topo.n_patches,
               patch_sizes=(int(sizes.min()), int(sizes.max())),
               coarse_rhs_norm=float(jnp.linalg.norm(s.coarse_rhs)))
    assert got["fem_rhs_norm"] == GOLDEN["fem_rhs_norm"], got
    for key in ("fine_dofs", "coarse_dofs", "patches", "patch_sizes"):
        assert got[key] == GOLDEN[key], (key, got)
    assert abs(got["coarse_rhs_norm"] - GOLDEN["coarse_rhs_norm"]) < 5e-8, got
    log(f"phase 2 golden parity (float64): {got}")
    return got


def run_main_config(name: str, spec: dict, precisions=("high", "highest"),
                    reps: int = 3, **kw):
    """Compile and time the jitted step at float32 for each matmul
    precision, and compare its prolonged field with a float64 run."""
    import jax

    fields, report = {}, {}
    for dtype, prec in ([("float32", p) for p in precisions]
                        + [("float64", "highest")]):
        s = make_solver(dtype=dtype, matmul_precision=prec, **spec, **kw)
        s.assemble_fine_rhs()
        args = (s.coef_q, s.fem_rhs)
        t0 = time.perf_counter()
        compiled = jax.jit(s.build_step(prolong=True)).lower(*args).compile()
        t_compile = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            u, _, fine = jax.block_until_ready(compiled(*args))
            times.append(time.perf_counter() - t0)
        u, fine = np.asarray(u), np.asarray(fine)
        assert np.isfinite(u).all() and np.abs(u).max() > 0, (name, dtype)
        assert np.isfinite(fine).all() and np.abs(fine).max() > 0
        key = f"{dtype}/{prec}"
        fields[key] = fine
        mem = compiled.memory_analysis()
        stats = jax.devices()[0].memory_stats() or {}
        report[key] = dict(
            patches=s.topo.n_patches, compile_s=t_compile,
            step_median_s=float(np.median(times)), step_s=times,
            temp_bytes=getattr(mem, "temp_size_in_bytes", None),
            argument_bytes=getattr(mem, "argument_size_in_bytes", None),
            output_bytes=getattr(mem, "output_size_in_bytes", None),
            peak_bytes_in_use=stats.get("peak_bytes_in_use"))
        log(f"phase 3 {name} {key}: {json.dumps(report[key])}")
        del compiled, s, args, u
    ref = fields["float64/highest"]
    for key in fields:
        if key.startswith("float32"):
            report[key]["rel_l2_vs_f64"] = rel_l2(fields[key], ref)
            log(f"phase 3 {name} {key}: rel L2 vs float64 = "
                f"{report[key]['rel_l2_vs_f64']!r}")
    return report


def phase_main(precisions=("high", "highest")):
    from dealii_slod_tpu.config import SLODConfig

    default = SLODConfig().matmul_precision
    out = {}
    for name, spec in MAIN_CONFIGS.items():
        rep = run_main_config(name, spec, precisions)
        err = rep[f"float32/{default}"]["rel_l2_vs_f64"]
        assert err < F32_FIELD_TOL, (name, default, err)
        out[name] = rep
    return out


def plain_reference_check(problem: str, dim: int, refine: int):
    """float32 on the default device against float64 on the host CPU, in
    the same process, on a configuration small enough for the host."""
    import jax

    spec = dict(problem=problem, dim=dim, refine=refine, ell=1, chunk=0)
    fields = {}
    for dtype, dev in (("float32", jax.devices()[0]),
                       ("float64", jax.devices("cpu")[0])):
        with jax.default_device(dev):
            s = make_solver(dtype=dtype, **spec)
            s.assemble_fine_rhs()
            _, _, fine = jax.jit(s.build_step(prolong=True))(s.coef_q,
                                                             s.fem_rhs)
            fields[dtype] = np.asarray(fine)
    err = rel_l2(fields["float32"], fields["float64"])
    assert err < F32_FIELD_TOL, (problem, dim, refine, err)
    return err


def spd_batch(rng, B: int, n: int, cond: float) -> np.ndarray:
    """Random SPD matrices with eigenvalues log-spaced over ``cond``."""
    Q = np.linalg.qr(rng.standard_normal((B, n, n)))[0]
    lam = np.logspace(0.0, -np.log10(cond), n)
    return np.einsum("bij,j,bkj->bik", Q, lam, Q)


def inverse_tol(n: int, cond: float) -> float:
    """Normwise forward error of a Cholesky-based float32 inverse:
    kappa * eps * poly(n); sqrt(n) growth with a factor-10 margin."""
    return 10.0 * np.sqrt(n) * cond * np.finfo(np.float32).eps


def check_spd_inverse(rng, B: int, n: int, cond: float = 1e3) -> float:
    import jax.numpy as jnp

    from dealii_slod_tpu.ops.solvers import spd_inverse

    A = spd_batch(rng, B, n, cond)
    X = np.asarray(spd_inverse(jnp.asarray(A, jnp.float32)))
    err = rel_l2(X, np.linalg.inv(A))
    assert err < inverse_tol(n, cond), (n, err)
    return err


def check_patch_solve(rng, B: int, n: int, k: int) -> float:
    """The per-patch SPD multi-RHS solve (Cholesky + two triangular
    solves) at the patch widths: n = 729 / 2187 interior dofs, k = 125 /
    375 coarse right-hand sides."""
    import jax.numpy as jnp

    from dealii_slod_tpu.ops.solvers import cholesky_factor, cholesky_solve

    A = spd_batch(rng, B, n, 1e3)
    R = rng.standard_normal((B, n, k))
    X = cholesky_solve(cholesky_factor(jnp.asarray(A, jnp.float32)),
                       jnp.asarray(R, jnp.float32))
    err = rel_l2(X, np.linalg.solve(A, R))
    assert err < inverse_tol(n, 1e3), (n, err)
    return err


def phase_pieces():
    import jax

    from dealii_slod_tpu.config import SLODConfig

    out = {}
    for problem, dim, refine in (("diffusion", 2, 3), ("diffusion", 3, 2),
                                 ("elasticity", 3, 2)):
        key = f"{problem}_{dim}d_r{refine}"
        out[key] = plain_reference_check(problem, dim, refine)
        log(f"phase 4 plain reference {key}: rel L2 float32 device vs "
            f"float64 cpu = {out[key]!r}")
    rng = np.random.default_rng(0)
    with jax.default_matmul_precision(SLODConfig().matmul_precision):
        for B, n in ((256, 125), (64, 375)):
            out[f"spd_inverse_{n}"] = check_spd_inverse(rng, B, n)
        for B, n, k in ((32, 729, 125), (8, 2187, 375)):
            out[f"patch_solve_{n}x{k}"] = check_patch_solve(rng, B, n, k)
    log(f"phase 4 pieces at real widths vs NumPy float64: {out}")
    return out


def phase_cli(refine: int = 5, ell: int = 3, bound: float = 1e-5):
    """The diffusion application in 2D with the fine FEM solve; the L2
    error of SLOD against the fine solution must fall below ``bound``
    (float64 on the host CPU gives 3.0e-7 here; the stabilized method
    converges at >= 16x per refinement at l ~ log2 N, so 1e-5 keeps
    30x headroom and still fails an unstabilized or wrong basis)."""
    from dealii_slod_tpu import cli

    prm = f"""subsection Problem
  set Compare with fine global solution = true
  set Number of global refinements = {refine}
  set Number of subdivisions = 2
  set Oversampling = {ell}
  set Stabilize phi_LOD candidates = true
  subsection Coefficients
    set Constant problem coefficients = true
  end
  subsection Exact solution
    set Function expression = sin(pi*x)*sin(pi*y)
  end
  subsection Right hand side
    set Function expression = 2*pi^2*sin(pi*x)*sin(pi*y)
  end
  subsection Solver
    subsection Fine solver control
      set Max steps = 8000
      set Tolerance = 1e-12
      set Reduction = 1e-12
    end
    subsection Coarse solver control
      set Max steps = 4000
      set Tolerance = 1e-12
      set Reduction = 1e-12
    end
  end
end
"""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "parameters.prm")
        with open(path, "w") as fh:
            fh.write(prm)
        with contextlib.redirect_stdout(sys.stderr):
            res = cli.solve(["diffusion", path, "--dim", "2", "--no-output"])
    err = res["error_LOD_FEMh"].rows[0][2]["L2"]
    assert err < bound, err
    log(f"phase 5 cli diffusion 2D refine {refine} l={ell}: "
        f"L2 SLOD vs FEM(h) = {err!r} (bound {bound})")
    return err


def phase_four_cards(refine: int = 4):
    """Patch-axis sharding and sample-axis sweep over four GPUs, each
    against single-GPU runs of the same data.  Float64, so that the only
    differences are the order of the reductions: in float32 a different
    batch shape on a shard may flip a few truncation decisions, which
    changes the coarse coefficients' gauge but says nothing of sharding."""
    import jax
    import jax.numpy as jnp

    from dealii_slod_tpu.models.coefficients import RandomField
    from dealii_slod_tpu.parallel.mesh import make_mesh, replicate
    from dealii_slod_tpu.parallel.sweep import stack_fields, sweep_step

    spec = dict(MAIN_CONFIGS["diffusion_3d_r4"], refine=refine)
    s = make_solver(dtype="float64", **spec)
    s.assemble_fine_rhs()
    single = jax.jit(s.build_step(prolong=True))
    t0 = time.perf_counter()
    u1, A1, f1 = jax.block_until_ready(single(s.coef_q, s.fem_rhs))
    log(f"phase 6 single-card step: {time.perf_counter() - t0:.2f} s "
        "(with compile)")

    mesh = make_mesh(4)
    sharded = jax.jit(s.build_step(mesh=mesh, prolong=True))
    coefs = {k: replicate(mesh, v) for k, v in s.coef_q.items()}
    t0 = time.perf_counter()
    u4, A4, f4 = jax.block_until_ready(
        sharded(coefs, replicate(mesh, s.fem_rhs)))
    log(f"phase 6 patch-sharded step: {time.perf_counter() - t0:.2f} s "
        "(with compile)")
    assert len(A4.sharding.device_set) == 4, A4.sharding
    # identical per-patch arithmetic on every shard; only the order of the
    # stencil build's and the CG's reductions differs
    dA, du, df = rel_l2(A4, A1), rel_l2(u4, u1), rel_l2(f4, f1)
    assert dA < 1e-5 and du < 1e-4 and df < 1e-4, (dA, du, df)
    devs = sorted(d.id for d in A4.sharding.device_set)
    log(f"phase 6 patch sharding over devices {devs}: rel L2 stencil "
        f"{dA!r}, coarse solution {du!r}, prolonged field {df!r}")

    smesh = make_mesh(4, axis="samples")
    qp = np.asarray(s.qpts)
    fields = [dict(s.coef_q)] + [
        {"alpha": jnp.asarray(RandomField(1.0, 100.0, 5, 3, seed=seed,
                                          sampler="numpy")(qp), s.dtype)}
        for seed in range(1, 4)]
    sweep = sweep_step(s, mesh=smesh, axis="samples")
    t0 = time.perf_counter()
    us, _ = jax.block_until_ready(sweep(stack_fields(fields), s.fem_rhs))
    log(f"phase 6 sample sweep, 4 fields: {time.perf_counter() - t0:.2f} s "
        "(with compile)")
    assert len(us.sharding.device_set) == 4, us.sharding
    errs = []
    for i, f in enumerate(fields):
        ui = single(f, s.fem_rhs)[0]
        errs.append(rel_l2(us[i], ui))
    # the coarse CG stops at a 1e-6 residual reduction; reduction-order
    # differences move its iterate far less than that
    assert max(errs) < 1e-4, errs
    log(f"phase 6 sample sweep vs single-card runs: rel L2 {errs}")
    return dA, du, errs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-GPU sharded paths")
    args = parser.parse_args(argv)

    import jax

    from dealii_slod_tpu.utils.runtime import enable_compile_cache

    jax.config.update("jax_enable_x64", True)
    enable_compile_cache(ROOT, ".jax_cache")
    n_cards = 4 if args.four_cards else 1
    devs = phase_device(n_cards)
    if args.four_cards:
        phase_four_cards()
    else:
        phase_golden()
        phase_main()
        phase_pieces()
        phase_cli()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
