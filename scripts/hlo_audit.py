"""HLO audit of the jitted end-to-end step: op histogram, large
transposes/copies, total FLOPs/bytes from XLA cost analysis.

The slice-stack window extraction was found this way (a 131 MB transpose
hiding behind conv_general_dilated_patches).  Run on the GPU to audit the
program the card runs:

    python scripts/hlo_audit.py                 # backend from environment
    AUDIT_PLATFORM=cpu python scripts/hlo_audit.py
    AUDIT_DIM=3 AUDIT_REFINE=4 python scripts/hlo_audit.py
"""
import collections
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

plat = os.environ.get("AUDIT_PLATFORM")
if plat:
    jax.config.update("jax_platforms", plat)

from dealii_slod_tpu.config import ReductionControl, SLODConfig
from dealii_slod_tpu.models import DiffusionProblem, LODSolver


def main():
    cfg = SLODConfig(
        dim=int(os.environ.get("AUDIT_DIM", 3)),
        n_global_refinements=int(os.environ.get("AUDIT_REFINE", 3)),
        n_subdivisions=2, oversampling=int(os.environ.get("AUDIT_ELL", 2)),
        lod_stabilization=True, constant_coefficients=False, coef_seed=0,
        coef_refinement=5, rhs="1", bc="0", dtype="float32",
        patch_chunk=int(os.environ.get("AUDIT_CHUNK", 256)),
        solve_fine_problem=False,
        coarse_solver=ReductionControl(500, 1e-6, 1e-6))
    sol = LODSolver(cfg, DiffusionProblem(cfg), verbose=False)
    sol.assemble_fine_rhs()
    step = jax.jit(sol.build_step())
    comp = step.lower(sol.coef_q, sol.fem_rhs).compile()
    hlo = comp.as_text()

    ops = collections.Counter()
    heavy = []
    for ln in hlo.splitlines():
        m = re.match(r"\s*%?\S+ = \S* ?(\w+)\(", ln)
        if not m:
            continue
        op = m.group(1)
        ops[op] += 1
        if op in ("transpose", "copy", "gather", "scatter"):
            for sz in re.findall(r"[a-z0-9]+\[([\d,]+)\]", ln)[:1]:
                n = 1
                for t in sz.split(","):
                    n *= int(t)
                if n > 2_000_000:
                    heavy.append((n, op, ln.strip()[:150]))

    print("op histogram (top 20):")
    for k, v in ops.most_common(20):
        print(f"  {k:>16} {v}")
    print("\nheavy transposes/copies/gathers (>2M elements):")
    for n, op, ln in sorted(heavy, reverse=True)[:15]:
        print(f"  {op:>9} {n/1e6:7.1f}M  {ln}")
    ca = comp.cost_analysis()
    if ca:
        print(f"\ncost analysis: flops={ca.get('flops'):.3e} "
              f"bytes={ca.get('bytes accessed'):.3e}")


if __name__ == "__main__":
    main()
