"""Benchmark: 3D SLOD basis construction + coarse solve throughput on one
GPU.

Default configuration: 4096 patches (16^3 coarse mesh), l=2 oversampling,
random coefficients of contrast 100 — patches/s through Q_iso_Q1 assembly,
the batched per-patch SPD multi-RHS solve, the SLOD boundary-trace spectral
pseudo-inverse, the coarse stencil assembly and the coarse CG solve.

The JSON line also carries an analytic FLOP model (``detail.flops_model``)
and the achieved TFLOP/s.

Prints ONE JSON line.  Override the configuration via env vars BENCH_DIM,
BENCH_REFINE, BENCH_SUB, BENCH_ELL, BENCH_CHUNK, BENCH_PROBLEM, BENCH_REPS,
BENCH_PREC (matmul precision), BENCH_COARSE, BENCH_SIDE_MB, BENCH_COEF_WINDOWS,
BENCH_WINDOW_CHUNK.  Exits non-zero when JAX finds no GPU.
"""

import json
import os
import sys
import time

import jax
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks by JAX device_kind.  Source: NVIDIA H100 SXM data sheet,
# dense rates without sparsity (bf16 and TF32 on the tensor cores, float32
# outside them) and HBM3 bandwidth, all at the full 700 W power limit.  A
# device that is not in the table is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bf16_tflops=989.0, tf32_tflops=495.0,
                                  fp32_tflops=67.0, hbm_tb_s=3.35),
}


def device_peaks(device) -> dict:
    kind = device.device_kind
    if kind not in PEAKS:
        raise KeyError(f"bench: no peak rates for device_kind {kind!r}; "
                       f"add a row to PEAKS (known: {sorted(PEAKS)})")
    return PEAKS[kind]


def flops_model(dim, ell, s, C, P, n_stencil, slod=True, cg_iters=40,
                banded=True):
    """Analytic FLOPs of the end-to-end step (per the pipeline stages in
    models/lod.py one_patch + stencil build + coarse CG).  Counts multiply-
    adds as 2 FLOPs; Cholesky n^3/3, TRSM n^2 k per triangle.

    The spectral stage is charged as a full symmetric eigendecomposition
    with vectors (~9 n^3) per component.

    ``banded`` charges the production assembly_mode="banded" path: the
    trace/premultiply products run through the nodal-stencil
    ``stencil_apply`` (2 * nN * 3^dim * C^2 per column — 27x fewer FLOPs
    than the dense (nI, nD) product the r3 model charged), plus the
    ``bands_to_dense_mm`` placement-matmul embedding of the solve block.
    Cross-checked against XLA cost_analysis (tests/test_flops_model.py)."""
    kappa = 2 * ell + 1
    nNn = (kappa * s + 1) ** dim             # canvas nodes per patch
    nIn = (kappa * s - 1) ** dim             # interior nodes per patch
    nI = nIn * C                             # interior dofs per patch
    nD = nNn * C                             # canvas dofs per patch
    cD = kappa ** dim * C                    # coarse dofs per patch
    n_sub = (kappa * s) ** dim
    nq = 2 ** dim
    m = nq * C
    O = 3 ** dim
    per_patch = {
        "assembly": 2 * n_sub * nq * m * m,
        "cholesky": nI ** 3 // 3,
        "trsm_multirhs": 2 * nI * nI * cD,
        "triple_product": 2 * nI * cD * cD,
        "T_inverse": 3 * cD ** 3 + cD ** 3 // 3,
    }
    if banded:
        # bands_to_dense_mm: einsum("nocd,ow->cdnw") over the interior
        # grid, w = nIn + 1 (ops/assembly.py:220-244)
        per_patch["band_embed"] = 2 * C * C * nIn * O * (nIn + 1)
    if slod:
        trace = ((2 * nNn * O * C * C * cD      # S_AiPT via stencil_apply
                  if banded else 2 * nD * nI * cD)
                 + 2 * nD * cD * cD)            # BD = (.) @ Tinv
        per_patch.update({
            "slod_trace_products": trace,
            # ONE shared F = BD^T BD; per-component Grams are 0/1 diagonal
            # maskings of F (models/basis.py finish)
            "slod_gram": 2 * nD * cD * cD + C * 3 * cD * cD,
            "slod_candidates": C * (2 * cD * cD + 2 * nI * cD),
            # premultiplied basis A @ phi (k = C columns)
            "premultiply": (2 * nNn * O * C * C * C if banded
                            else 2 * nD * nI * C),
            "slod_spectral": C * 9 * cD ** 3,
        })
    K, K2, O = kappa ** dim, (kappa + 1) ** dim, (s + 1) ** dim
    global_flops = {
        "stencil_cell_pairs": 2 * P * K * K2 * O * C * C,
        "stencil_correlation": 2 * P * (kappa ** 2) * ((kappa + 1) ** 2)
        * (2 * min(2 * ell, 10) + 1) * C * C * dim,
        "coarse_cg": 2 * cg_iters * P * n_stencil * C * C,
    }
    stages = {k: v * P for k, v in per_patch.items()}
    stages.update(global_flops)
    return stages


def main():
    from dealii_slod_tpu.config import ReductionControl, SLODConfig
    from dealii_slod_tpu.models import (DiffusionProblem, ElasticityProblem,
                                        LODSolver)
    from dealii_slod_tpu.utils.runtime import (card_name_and_power,
                                               enable_compile_cache)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU found (JAX platform {dev.platform!r})")
    peaks = device_peaks(dev)
    card = card_name_and_power()
    print(f"bench: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())} card={card}", file=sys.stderr)
    enable_compile_cache(HERE, ".jax_cache")

    env = os.environ.get
    problem = env("BENCH_PROBLEM", "diffusion")
    dim = int(env("BENCH_DIM", 3))
    refine = int(env("BENCH_REFINE", 4))
    sub = int(env("BENCH_SUB", 2))
    ell = int(env("BENCH_ELL", 2))
    chunk = int(env("BENCH_CHUNK", 128))
    reps = int(env("BENCH_REPS", 5))

    cfg = SLODConfig(
        dim=dim, n_global_refinements=refine, n_subdivisions=sub,
        oversampling=ell, lod_stabilization=True,
        constant_coefficients=False, coef_seed=0, coef_refinement=5,
        rhs="; ".join(["1"] * (dim if problem == "elasticity" else 1)),
        bc="0", dtype="float32", patch_chunk=chunk,
        solve_fine_problem=False,
        coarse_solver=ReductionControl(500, 1e-6, 1e-6),
        coef_windows=env("BENCH_COEF_WINDOWS", "1") == "1",
        window_chunk=env("BENCH_WINDOW_CHUNK", "auto"),
        matmul_precision=env("BENCH_PREC", SLODConfig.matmul_precision),
        coarse_solve=env("BENCH_COARSE", "cg"),
        stencil_side_budget_mb=int(env("BENCH_SIDE_MB", 2048)),
    )
    prob = (ElasticityProblem if problem == "elasticity"
            else DiffusionProblem)(cfg)
    solver = LODSolver(cfg, prob, verbose=False)
    P = solver.topo.n_patches
    solver.assemble_fine_rhs()
    args = (solver.coef_q, solver.fem_rhs)

    t0 = time.perf_counter()
    step = jax.jit(solver.build_step()).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        u, _ = jax.block_until_ready(step(*args))
        times.append(time.perf_counter() - t0)
    # never time garbage: a non-finite or identically-zero solution means
    # the pipeline silently diverged (NaN basis -> CG no-op)
    u_np = np.asarray(u)
    assert np.isfinite(u_np).all(), "bench pipeline produced non-finite"
    assert np.abs(u_np).max() > 0, "bench pipeline produced zero solution"
    best = min(times)
    median = sorted(times)[len(times) // 2]

    stages = flops_model(dim, ell, sub, solver.C, P, solver.n_stencil,
                         slod=True, cg_iters=40,
                         banded=cfg.assembly_mode == "banded")
    if solver._use_direct_coarse():
        # coarse_solve="direct": dense Cholesky + 2 TRSVs instead of CG
        n = P * solver.C
        stages["coarse_cg"] = n ** 3 // 3 + 2 * 2 * n * n
    total_flops = sum(stages.values())
    tflops = total_flops / best / 1e12
    metric = (f"{dim}d_slod_{problem}_patches_per_sec"
              if problem != "diffusion" else f"{dim}d_slod_patches_per_sec")
    out = {
        "metric": metric,
        "value": P / best,
        "unit": "patches/s",
        "detail": {
            "patches": P, "dim": dim, "oversampling": ell,
            "n_subdivisions": sub, "coarse_cells_per_axis": 2 ** refine,
            "patch_chunk": chunk,
            "matmul_precision": cfg.matmul_precision,
            "wall_s": best, "wall_median_s": median, "wall_all_s": times,
            "reps": reps, "compile_s": compile_s,
            "tflops": tflops,
            "fp32_peak_share": tflops / peaks["fp32_tflops"],
            "flops_model": {k: int(v) for k, v in stages.items()},
            "flops_total": int(total_flops),
            "platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "card": card,
        },
    }
    ms = dev.memory_stats() or {}
    if "peak_bytes_in_use" in ms:
        out["detail"]["peak_bytes_in_use"] = ms["peak_bytes_in_use"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
