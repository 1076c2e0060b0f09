"""Exhaustive rand()-offset probe on the 0.0808367 golden anchor.

The reference app (tests/Poisson_LOD_Example.cc) constructs
``Alpha(1, 100, 8)`` — 65536 unseeded glibc rand() draws — and runs plain
LOD (central-cell candidate only, no stabilization).  With reference_parity
glibc sampling at offset 0 this pipeline reproduces PARITY.md's 0.0803122
vs golden 0.0808367.  Hypothesis to kill: some static-init / library code
consumed k draws BEFORE the Alpha ctor on the machine that generated the
golden file.  Scans k = 0..KMAX and field refinements r = 2..8 at k = 0;
reports any configuration matching the golden to 6 digits.

    python scripts/anchor_probe.py [KMAX]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from dealii_slod_tpu.config import ReductionControl, SLODConfig
from dealii_slod_tpu.models import DiffusionProblem, LODSolver
from dealii_slod_tpu.models.coefficients import GlibcRand

GOLDEN = 0.0808367
KMAX = int(sys.argv[1]) if len(sys.argv) > 1 else 20000


def main():
    cfg = SLODConfig(dim=2, n_global_refinements=2, n_subdivisions=2,
                     oversampling=1, lod_stabilization=False,
                     constant_coefficients=True, coef_refinement=8,
                     rhs="1", bc="0", dtype="float64",
                     solve_fine_problem=False, reference_parity=True,
                     coarse_solver=ReductionControl(100, 1e-9, 1e-9))
    solver = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)
    solver.assemble_fine_rhs()
    qpts = np.asarray(solver.qpts)

    # one long raw stream; table at offset k = draws[k : k + n*n]
    g = GlibcRand()
    raw = np.array(g.draw(4 ** 8 + KMAX), dtype=np.float64)
    RAND_MAX = 2147483647

    def field_values(off, n):
        r = raw[off:off + n * n]
        return (1.0 + r.astype(np.float32)
                / np.float32(np.float64(RAND_MAX) / np.float64(99.0))
                ).astype(np.float64)

    def rhs_norm(values, n):
        eta = 1.0 / n
        idx = np.clip((qpts / eta).astype(np.int64), 0, n - 1)
        alpha_q = values[idx[..., 0] + n * idx[..., 1]]
        solver.coef_q = {"alpha": jnp.asarray(alpha_q, solver.dtype)}
        solver.compute_basis()
        f_at = solver._rhs_windows(solver.fem_rhs)
        rhs_c = jnp.einsum("pncd,pnc->pd", solver.Phi, f_at)
        return float(jnp.linalg.norm(rhs_c))

    v0 = rhs_norm(field_values(0, 256), 256)
    print(f"offset 0 baseline: {v0:.7f} (PARITY.md: 0.0803122)")
    assert abs(v0 - 0.0803122) < 1e-6, "probe does not match PARITY baseline"

    hits = []
    for r in range(2, 9):
        v = rhs_norm(field_values(0, 2 ** r), 2 ** r)
        print(f"refinement {r}: {v:.7f}")
        if abs(v - GOLDEN) < 5e-7:
            hits.append(("refinement", r, v))

    t0 = time.time()
    best = (1e9, -1, 0.0)
    for k in range(KMAX + 1):
        v = rhs_norm(field_values(k, 256), 256)
        d = abs(v - GOLDEN)
        if d < best[0]:
            best = (d, k, v)
        if d < 5e-7:
            hits.append(("offset", k, v))
            print(f"HIT at offset {k}: {v:.7f}")
        if k and k % 1000 == 0:
            rate = k / (time.time() - t0)
            print(f"k={k} ({rate:.0f}/s) best: offset {best[1]} -> "
                  f"{best[2]:.7f} (|d|={best[0]:.2e})", flush=True)
    print("hits:", hits)
    print(f"closest: offset {best[1]} -> {best[2]:.7f} (|d|={best[0]:.2e})")


if __name__ == "__main__":
    main()
