"""Command-line applications: ``diffusion``, ``elasticity`` and
``reaction`` (reaction-diffusion, beyond the reference set).

Mirrors the reference apps (app/main_Diffusion.cc:3-49,
app/main_Elasticity.cc:3-49): one executable per problem family, taking an
optional ``.prm`` parameter file; a first run with a missing parameter file
writes the defaults (reference README:3, ParameterAcceptor::initialize).

Usage:
    python -m dealii_slod_tpu.cli diffusion  [parameters.prm] [options]
    python -m dealii_slod_tpu.cli elasticity [parameters.prm] [options]
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dealii_slod_tpu",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("problem",
               choices=["diffusion", "elasticity", "reaction"])
    p.add_argument("prm", nargs="?", default="parameters.prm",
                   help="deal.II-style parameter file (created with defaults "
                        "if missing, like the reference apps)")
    p.add_argument("--dim", type=int, default=2, choices=[2, 3],
                   help="mesh dimension (the reference supports 2 only)")
    p.add_argument("--dtype", default="float64",
                   choices=["float32", "float64"],
                   help="compute dtype (default: float64, the reference "
                        "semantics)")
    p.add_argument("--chunk", type=int, default=None,
                   help="patches per vmapped chunk")
    p.add_argument("--no-output", action="store_true",
                   help="skip VTU fields + used-parameters dump (the "
                        "reference apps always write output; this is an "
                        "opt-out for benchmarking)")
    p.add_argument("--reference-parity", action="store_true",
                   help="bit-mirror the reference coefficient sampling "
                        "(glibc rand) and cache semantics")
    p.add_argument("--no-fine-solve", action="store_true",
                   help="skip the fine reference FEM solve")
    return p


def solve(argv=None) -> dict:
    """Run one application from its command line; returns the results of
    :meth:`LODSolver.run` (solution fields and error tables)."""
    args = build_parser().parse_args(argv)

    import jax

    from dealii_slod_tpu.config import SLODConfig

    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    overrides = dict(dim=args.dim, dtype=args.dtype,
                     write_output=not args.no_output)
    if args.chunk is not None:
        overrides["patch_chunk"] = args.chunk
    if args.reference_parity:
        overrides["reference_parity"] = True
    if args.no_fine_solve:
        overrides["solve_fine_problem"] = False

    if not os.path.exists(args.prm):
        # first run creates the parameter file (reference README:3)
        cfg = SLODConfig(**overrides)
        with open(args.prm, "w") as f:
            f.write(cfg.to_prm())
        print(f"Wrote default parameter file {args.prm}; running with "
              "defaults.")
    else:
        cfg = SLODConfig.from_prm(args.prm, **overrides)

    from dealii_slod_tpu.models import (DiffusionProblem, ElasticityProblem,
                                        LODSolver,
                                        ReactionDiffusionProblem)

    prob = {"diffusion": DiffusionProblem,
            "elasticity": ElasticityProblem,
            "reaction": ReactionDiffusionProblem}[args.problem](cfg)
    return LODSolver(cfg, prob, verbose=True).run()


def main(argv=None) -> int:
    try:
        solve(argv)
    except Exception as exc:  # mirror the reference's exception report
        print("----------------------------------------------------",
              file=sys.stderr)
        print(f"Exception on processing: {exc}\nAborting!", file=sys.stderr)
        print("----------------------------------------------------",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
