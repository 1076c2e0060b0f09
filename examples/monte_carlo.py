"""Monte-Carlo over random coefficient fields — a batched workflow the
reference cannot express.

The reference rebuilds every patch mesh, sparse matrix and Amesos
factorization per coefficient sample (source/LOD.cc:296-768 re-runs in
full).  Here the end-to-end SLOD step (basis construction -> coarse stencil
operator -> CG solve) is ONE jitted function of the coefficient arrays
(`LODSolver.build_step`), so a parameter sweep / Monte-Carlo study compiles
once and then streams fields through the XLA executable at full device
throughput.

Prints per-sample wall time and the spread of the energy functional
E[u] = f^T u_h across samples.

    JAX_PLATFORMS=cpu python examples/monte_carlo.py           # CPU smoke
    MC_DIM=3 MC_REFINE=4 MC_SAMPLES=32 python examples/monte_carlo.py  # GPU
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
from dealii_slod_tpu.models.coefficients import RandomField


def main():
    dim = int(os.environ.get("MC_DIM", 2))
    refine = int(os.environ.get("MC_REFINE", 4))
    n_samples = int(os.environ.get("MC_SAMPLES", 8))
    contrast = float(os.environ.get("MC_CONTRAST", 1e2))
    coef_ref = int(os.environ.get("MC_COEF_REFINE", 4))

    cfg = SLODConfig(
        dim=dim, n_global_refinements=refine, n_subdivisions=2,
        oversampling=2, lod_stabilization=True,
        constant_coefficients=False, coef_seed=0, coef_refinement=coef_ref,
        coef_min=1.0, coef_max=contrast, rhs="1", bc="0",
        dtype=os.environ.get("MC_DTYPE", "float32"),
        solve_fine_problem=False,
        coarse_solver=ReductionControl(500, 1e-6, 1e-6))
    solver = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)
    solver.assemble_fine_rhs()
    rhs = solver.fem_rhs

    step = jax.jit(solver.build_step())

    # MC_FIELD=lognormal: correlated Gaussian log-fields, sampled on device
    # (models/coefficients.lognormal_lattice_batch); default: the
    # reference-style i.i.d. piecewise-constant field, sampled on host
    field_kind = os.environ.get("MC_FIELD", "random")
    if field_kind == "lognormal":
        from dealii_slod_tpu.models.coefficients import (
            lognormal_lattice_batch)
        corr = float(os.environ.get("MC_CORR_LEN", 0.1))
        N = 2 ** coef_ref
        eta = 1.0 / N
        qpts = np.asarray(solver.qpts)
        idx = np.clip((qpts / eta).astype(np.int64), 0, N - 1)
        strides = N ** np.arange(dim)
        flat_idx = jnp.asarray((idx * strides).sum(axis=-1))
        lat = lognormal_lattice_batch(
            jax.random.PRNGKey(cfg.coef_seed), n_samples + 1, coef_ref,
            dim, cfg.coef_min, cfg.coef_max, corr_len=corr)

        def field(seed):
            return {"alpha": lat[seed, flat_idx].astype(solver.dtype)}
    else:
        def field(seed):
            f = RandomField(cfg.coef_min, cfg.coef_max, coef_ref, dim,
                            seed=seed, sampler="numpy")
            return {"alpha": jnp.asarray(f(np.asarray(solver.qpts)),
                                         solver.dtype)}

    # MC_SHARD=N: shard the SAMPLE axis over an N-device mesh — each device
    # runs the full pipeline on its own fields, zero communication (a
    # scaling axis the reference's patch-partitioning MPI cannot express)
    n_shard = int(os.environ.get("MC_SHARD", 0))
    if n_shard:
        from dealii_slod_tpu.parallel import (make_mesh, stack_fields,
                                              sweep_step)
        mesh = make_mesh(n_shard, axis="samples")
        sw = sweep_step(solver, mesh=mesh, axis="samples")
        batch = stack_fields([field(s + 1) for s in range(n_samples)])
        t0 = time.perf_counter()
        u, _ = sw(batch, rhs)
        float(jnp.sum(u))
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        u, _ = sw(batch, rhs)
        float(jnp.sum(u))
        wall = time.perf_counter() - t0
        q = np.asarray(jnp.mean(u, axis=(1, 2)))
        print(f"config: dim={dim} refine={refine} "
              f"patches={solver.topo.n_patches} contrast={contrast:g} "
              f"samples={n_samples} sharded over {n_shard} devices")
        print(f"compile (once): {compile_s:.2f} s")
        print(f"batch of {n_samples}: {wall * 1e3:.1f} ms "
              f"({wall / n_samples * 1e3:.2f} ms/sample)")
        print(f"QoI mean(u_H): mean {q.mean():.6e}  std {q.std():.2e}")
        return

    # compile once on sample 0
    t0 = time.perf_counter()
    u0, _ = step(field(0), rhs)
    jax.block_until_ready(u0)
    compile_s = time.perf_counter() - t0

    energies, walls = [], []
    for s in range(n_samples):
        t0 = time.perf_counter()
        u, _ = step(field(s + 1), rhs)
        e = float(jnp.mean(u))                # QoI: mean coarse response
        walls.append(time.perf_counter() - t0)
        energies.append(e)

    energies = np.array(energies)
    print(f"config: dim={dim} refine={refine} patches={solver.topo.n_patches} "
          f"contrast={contrast:g} dtype={cfg.dtype}")
    print(f"compile (once): {compile_s:.2f} s")
    print(f"per-sample: median {np.median(walls) * 1e3:.1f} ms "
          f"(min {min(walls) * 1e3:.1f}, max {max(walls) * 1e3:.1f}) "
          f"over {n_samples} fields")
    print(f"QoI mean(u_H): mean {energies.mean():.6e}  "
          f"std {energies.std():.2e}  "
          f"rel spread {energies.std() / abs(energies.mean()):.3f}")


if __name__ == "__main__":
    main()
