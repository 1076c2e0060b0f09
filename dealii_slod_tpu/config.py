"""Configuration for the SLOD pipeline.

Mirrors the parameter surface of the reference ``LODParameters<dim, spacedim>``
(reference include/LOD.h:85-157): output directory/name, oversampling,
number of subdivisions, number of global refinements, fine-solve toggle, SLOD
stabilization toggle, constant-coefficient toggle, the parsed symbolic
functions for right-hand side / exact solution / Dirichlet boundary values,
and the two solver reduction controls.  Extends it with runtime knobs
(dtype, patch chunking, device-mesh sharding) and the generalizations the
rebuild supports natively (3D, configurable coefficient fields — the
reference hard-codes those, README:13-14).

Parameters can also be loaded from a deal.II-style ``.prm`` file with
:func:`SLODConfig.from_prm` so existing reference input files keep working.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Callable, Optional, Sequence, Union

import numpy as np

FunctionLike = Union[str, Sequence[str], Callable, float, int, None]


# ---------------------------------------------------------------------------
# Parsed symbolic functions (replacement for deal.II Functions::ParsedFunction)
# ---------------------------------------------------------------------------

_ALLOWED_NAMES = {
    "x": None,
    "y": None,
    "z": None,
    "pi": math.pi,
    "e": math.e,
    "sin": np.sin,
    "cos": np.cos,
    "tan": np.tan,
    "exp": np.exp,
    "log": np.log,
    "ln": np.log,
    "sqrt": np.sqrt,
    "abs": np.abs,
    "pow": np.power,
    "atan": np.arctan,
    "asin": np.arcsin,
    "acos": np.arccos,
    "sinh": np.sinh,
    "cosh": np.cosh,
    "tanh": np.tanh,
    "floor": np.floor,
    "ceil": np.ceil,
    "min": np.minimum,
    "max": np.maximum,
    "if": lambda c, a, b: np.where(c, a, b),
    "where": np.where,
}


class ParsedFunction:
    """A (vector-valued) function of space given by muparser-style expressions.

    This replaces deal.II ``Functions::ParsedFunction`` (used for
    ``/Problem/Right hand side``, ``Exact solution`` and ``Dirichlet boundary
    conditions`` in the reference, include/LOD.h:104-106, :123-125).

    ``exprs`` is one expression string per component, e.g. ``["1", "0"]``
    or a single semicolon-separated string ``"1; 0"``.  A Python callable
    ``f(points[..., dim]) -> values[..., n_components]`` is accepted directly.
    A scalar constant broadcasts to all components.
    """

    def __init__(self, spec: FunctionLike, n_components: int, dim: int):
        self.n_components = n_components
        self.dim = dim
        if spec is None:
            spec = "0"
        if callable(spec):
            self._fn = spec
            self._exprs = None
            return
        if isinstance(spec, (int, float)):
            spec = [repr(float(spec))] * n_components
        if isinstance(spec, str):
            spec = [s.strip() for s in spec.split(";")]
            if len(spec) == 1 and n_components > 1:
                spec = spec * n_components
        exprs = list(spec)
        if len(exprs) != n_components:
            raise ValueError(
                f"expected {n_components} component expressions, got {len(exprs)}"
            )
        self._exprs = [self._compile(e) for e in exprs]
        self._fn = None

    @staticmethod
    def _compile(expr: str):
        # muparser uses ^ for power
        expr = re.sub(r"\^", "**", expr)
        code = compile(expr, "<parsed-function>", "eval")
        for name in code.co_names:
            if name not in _ALLOWED_NAMES:
                raise ValueError(f"disallowed name {name!r} in expression {expr!r}")
        return code

    def __call__(self, points: np.ndarray) -> np.ndarray:
        """Evaluate at ``points[..., dim]`` -> ``values[..., n_components]``."""
        points = np.asarray(points)
        if self._fn is not None:
            out = np.asarray(self._fn(points))
            if out.shape[-1] != self.n_components:
                out = np.broadcast_to(
                    out[..., None], points.shape[:-1] + (self.n_components,)
                )
            return out
        env = dict(_ALLOWED_NAMES)
        env["x"] = points[..., 0]
        env["y"] = points[..., 1] if self.dim > 1 else 0.0
        env["z"] = points[..., 2] if self.dim > 2 else 0.0
        comps = []
        for code in self._exprs:
            v = eval(code, {"__builtins__": {}}, env)  # noqa: S307 (vetted names)
            comps.append(np.broadcast_to(np.asarray(v, dtype=np.float64),
                                         points.shape[:-1]))
        return np.stack(comps, axis=-1)

@dataclasses.dataclass
class ReductionControl:
    """Iterative-solver stopping rule, mirroring deal.II ``ReductionControl``
    (include/LOD.h:108-109): stop when the residual drops below
    ``max? no — below tolerance OR below reduce * initial_residual``,
    or after ``max_steps`` iterations."""

    max_steps: int = 100
    tolerance: float = 1.0e-10
    reduce: float = 1.0e-2


@dataclasses.dataclass
class SLODConfig:
    """Full problem + runtime configuration (reference include/LOD.h:85-157)."""

    # --- discretization (reference parameter names in comments) -----------
    dim: int = 2                      # mesh dimension (reference fixes 2)
    n_components: int = 1             # 'spacedim' in the reference: 1=diffusion, dim=elasticity
    oversampling: int = 1             # "Oversampling"
    n_subdivisions: int = 2           # "Number of subdivisions"
    n_global_refinements: int = 2     # "Number of global refinements"
    solve_fine_problem: bool = True   # "Compare with fine global solution"
    lod_stabilization: bool = False   # "Stabilize phi_LOD candidates"
    constant_coefficients: bool = True  # "Coefficients/Constant problem coefficients"

    # --- problem data ------------------------------------------------------
    rhs: FunctionLike = "1"
    exact_solution: FunctionLike = "0"
    bc: FunctionLike = "0"
    reaction: FunctionLike = "1"      # reaction coefficient c(x) >= 0 for
                                      # ReactionDiffusionProblem (beyond the
                                      # reference's physics set)

    # --- solver controls ---------------------------------------------------
    fine_solver: ReductionControl = dataclasses.field(
        default_factory=lambda: ReductionControl(max_steps=1000))
    coarse_solver: ReductionControl = dataclasses.field(
        default_factory=lambda: ReductionControl(max_steps=1000))

    # --- coefficient field (hard-coded in reference, Diffusion.h:62,
    #     Elasticity.h:104-105; configurable here per README TODO) ----------
    coef_min: float = 1.0
    coef_max: float = 100.0
    coef_refinement: int = 8          # random field lives on a 2^r per-axis grid
    coef_seed: int = 0
    coef_field: str = "random"        # "random" (problem_parameter),
                                      # "channel" (channel_parameter,
                                      # Elasticity.h:56-89), or "lognormal"
                                      # (correlated Gaussian log-field via
                                      # FFT spectral sampling — beyond the
                                      # reference; for MC/sweep studies)
    coef_corr_len: float = 0.1        # lognormal field correlation length
                                      # (Gaussian kernel, domain units)
    fine_preconditioner: str = "jacobi"  # "jacobi" or "two_level" (additive
                                      # Jacobi + coarse LOD-space correction —
                                      # the data-parallel stand-in for AMG at
                                      # high contrast)
    reference_parity: bool = False    # mirror the reference bit-for-bit:
                                      # glibc-rand coefficient field (always
                                      # random, as in Diffusion.h:62) and the
                                      # full-size-patch stiffness cache
    coef_rand_offset: int = 0         # rand() draws consumed before the
                                      # field ctor (reference_parity only).
                                      # The Poisson_LOD_Example golden was
                                      # generated after 12 such draws —
                                      # offset 12 reproduces its rhs norm
                                      # 0.0808367 to 1.7e-8 (PARITY.md)

    # --- output ------------------------------------------------------------
    output_directory: str = "."       # "Output directory"
    output_name: str = "solution"     # "Output name"
    write_output: bool = False

    # --- runtime -------------------------------------------------------------
    dtype: str = "float64"            # compute dtype ("float64" for the
                                      # reference semantics, "float32" for
                                      # speed)
    matmul_precision: str = "highest"  # matmul precision of the float32
                                      # path (jax.default_matmul_precision).
                                      # On an H100 80GB HBM3 (700 W
                                      # limit), 3D diffusion refine 4 /
                                      # elasticity refine 3: "highest" is
                                      # 1.3% / 2.1% slower than "high"
                                      # (which lets products run in TF32)
                                      # and its prolonged field is 25x /
                                      # 2.5x closer to float64 (1.3e-4 vs
                                      # 3.2e-3, 2.5e-3 vs 6.2e-3)
    kernel_mode: str = "uniform"      # "uniform": one padded shape class,
                                      # masks as data (one compiled kernel,
                                      # uniform batch);
                                      # "classes": one kernel per patch
                                      # shape class (exact-size reference
                                      # form, used for cross-validation)
    patch_chunk: int = 0              # patches per vmapped chunk (0 = all at once)
    mesh_axis: str = "patches"        # device-mesh axis name for patch sharding
    n_devices: int = 0                # 0 = single device / no sharding
    svd_threshold: float = 1.0e-15    # relative truncation in the stabilization
                                      # pseudo-inverse (LOD.cc:667)
    assembly_mode: str = "banded"     # patch stiffness assembly: "banded"
                                      # (scatter-free nodal-stencil windows
                                      # + strided densification) or
                                      # "scatter" (per-subcell element
                                      # matrices scatter-added)
    coef_windows: bool = True         # structured window extraction for the
                                      # per-patch coefficient rows (vs the
                                      # (P, n_sub) gather); auto-disabled
                                      # under constant-coefficient cache
                                      # semantics
    window_chunk: str = "auto"        # in-body per-chunk window extraction
                                      # from the padded lattice: "auto"
                                      # (above the slab-size threshold,
                                      # when chunks tile whole x-rows),
                                      # "on" (whenever legal), "off"
    chunk_scan: bool = True           # run all basis chunks under ONE jitted
                                      # lax.scan (one dispatch for the whole
                                      # basis stage) instead of a per-chunk
                                      # python loop
    two_level_dense_cap: int = 4096   # largest coarse system (n_patches *
                                      # n_components) the two-level fine
                                      # preconditioner densifies + factors
                                      # directly (128 MB f64 at the cap);
                                      # larger systems use the cap-free
                                      # stencil Chebyshev coarse correction
    coarse_solve: str = "cg"          # coarse-system solver: "cg"
                                      # (ReductionControl CG + Jacobi, the
                                      # reference's solve, LOD.cc:976-1002)
                                      # or "direct" (dense Cholesky below
                                      # coarse_dense_cap — one dense factor
                                      # instead of a latency-bound
                                      # iteration; falls back to CG above
                                      # the cap)
    coarse_dense_cap: int = 8192      # largest coarse system (n_patches *
                                      # n_components) whose CG matvec uses
                                      # the dense placement-embedded lattice
                                      # matrix (256 MB f32 at the cap, built
                                      # once per solve) instead of the
                                      # per-iteration stencil neighbor stack
    stencil_side_budget_mb: int = 2048  # device-memory budget for the
                                      # stencil build's full side tables;
                                      # above it the build switches to the
                                      # plane-chunked form (refine-5 3D
                                      # elasticity holds 10.9 GB of full
                                      # tables)
    profile_dir: str = ""             # non-empty: wrap the pipeline in a
                                      # jax.profiler trace written there
                                      # (beyond the reference's TimerOutput
                                      # stage timers)
    error_norms: tuple = ("L2", "H1", "Linfty")  # norms reported in the
                                      # convergence tables ("List of error
                                      # norms to compute", LOD.h:150-156)

    # ----------------------------------------------------------------------
    @property
    def n_coarse(self) -> int:
        """Coarse cells per axis, N = 2^n_global_refinements (LOD.cc:113-114)."""
        return 2 ** self.n_global_refinements

    @property
    def H(self) -> float:
        return 1.0 / self.n_coarse

    @property
    def h(self) -> float:
        return self.H / self.n_subdivisions

    def parsed(self, spec: FunctionLike) -> ParsedFunction:
        return ParsedFunction(spec, self.n_components, self.dim)

    @property
    def rhs_fn(self) -> ParsedFunction:
        return self.parsed(self.rhs)

    @property
    def exact_fn(self) -> ParsedFunction:
        return self.parsed(self.exact_solution)

    @property
    def bc_fn(self) -> ParsedFunction:
        return self.parsed(self.bc)

    # ------------------------------------------------------------------
    @classmethod
    def from_prm(cls, path: str, **overrides) -> "SLODConfig":
        """Load a deal.II-style ``.prm`` parameter file (subset).

        Understands the parameter names written by the reference apps
        (``./Diffusion parameters.prm``, README:3).
        """
        text = open(path).read()
        cfg: dict = {}
        section: list = []

        def seteq(name, value):
            key = "/".join(section + [name])
            cfg[key] = value

        for raw in text.splitlines():
            line = raw.split("#")[0].strip()
            if not line:
                continue
            m = re.match(r"subsection\s+(.*)", line)
            if m:
                section.append(m.group(1).strip())
                continue
            if line == "end":
                if section:
                    section.pop()
                continue
            m = re.match(r"set\s+([^=]+)=\s*(.*)", line)
            if m:
                seteq(m.group(1).strip(), m.group(2).strip())

        def get(key, default=None):
            # Segment-anchored lookup: the key must be the whole path or a
            # suffix starting at a subsection boundary, so e.g. a user
            # subsection named "My Output name" cannot alias "Output name".
            for k, v in cfg.items():
                if k == key or k.endswith("/" + key):
                    return v
            return default

        def as_bool(v, default):
            if v is None:
                return default
            return v.strip().lower() in ("true", "1", "yes", "on")

        kw = dict(
            oversampling=int(get("Oversampling", 1)),
            n_subdivisions=int(get("Number of subdivisions", 2)),
            n_global_refinements=int(get("Number of global refinements", 2)),
            solve_fine_problem=as_bool(get("Compare with fine global solution"), True),
            lod_stabilization=as_bool(get("Stabilize phi_LOD candidates"), False),
            constant_coefficients=as_bool(get("Constant problem coefficients"), True),
            output_directory=get("Output directory", "."),
            output_name=get("Output name", "solution"),
        )
        rhs = get("Right hand side/Function expression")
        if rhs is not None:
            kw["rhs"] = rhs
        exact = get("Exact solution/Function expression")
        if exact is not None:
            kw["exact_solution"] = exact
        bc = get("Dirichlet boundary conditions/Function expression")
        if bc is not None:
            kw["bc"] = bc
        react = get("Reaction coefficient/Function expression")
        if react is not None:
            kw["reaction"] = react

        # nested ReductionControl sections (reference LOD.h:108-109,126-127;
        # deal.II declares Max steps / Tolerance / Reduction).  Exact-path
        # lookups: 'Tolerance' alone would collide between the two solvers.
        def solver_control(section, default):
            base = f"Problem/Solver/{section} solver control/"
            if not any(k.startswith(base) for k in cfg):
                return default
            return ReductionControl(
                max_steps=int(float(cfg.get(base + "Max steps",
                                            default.max_steps))),
                tolerance=float(cfg.get(base + "Tolerance",
                                        default.tolerance)),
                reduce=float(cfg.get(base + "Reduction", default.reduce)))

        kw["fine_solver"] = solver_control("Fine", ReductionControl(1000))
        kw["coarse_solver"] = solver_control("Coarse", ReductionControl(1000))

        # /Problem/Error tables: norms list (LOD.h:150-156).  deal.II spells
        # them L2_norm / H1_norm / Linfty_norm (semicolon-separated per
        # component block, comma-separated within).
        norms_spec = get("Error/List of error norms to compute")
        if norms_spec is not None:
            names = {"l2_norm": "L2", "h1_norm": "H1",
                     "h1_seminorm": "H1_semi", "linfty_norm": "Linfty"}
            seen = []
            for tok in re.split(r"[;,]", norms_spec):
                norm = names.get(tok.strip().lower())
                if norm and norm not in seen:
                    seen.append(norm)
            if seen:
                kw["error_norms"] = tuple(seen)
        _reject_removed(k.rsplit("/", 1)[-1].strip().lower().replace(" ", "_")
                        for k in cfg)
        kw.update(overrides)
        return cls(**kw)

    def to_prm(self) -> str:
        """Emit a deal.II-style ``.prm`` text (mirror of the reference's
        used_parameters dump, LOD.cc:60-62)."""
        rhs = self.rhs if isinstance(self.rhs, str) else "<callable>"
        exact = self.exact_solution if isinstance(self.exact_solution, str) else "<callable>"
        bc = self.bc if isinstance(self.bc, str) else "<callable>"
        react = (self.reaction if isinstance(self.reaction, str)
                 else "<callable>")
        return (
            "subsection Problem\n"
            f"  set Compare with fine global solution = {str(self.solve_fine_problem).lower()}\n"
            f"  set Number of global refinements = {self.n_global_refinements}\n"
            f"  set Number of subdivisions = {self.n_subdivisions}\n"
            f"  set Output directory = {self.output_directory}\n"
            f"  set Output name = {self.output_name}\n"
            f"  set Oversampling = {self.oversampling}\n"
            f"  set Stabilize phi_LOD candidates = {str(self.lod_stabilization).lower()}\n"
            "  subsection Coefficients\n"
            f"    set Constant problem coefficients = {str(self.constant_coefficients).lower()}\n"
            "  end\n"
            "  subsection Dirichlet boundary conditions\n"
            f"    set Function expression = {bc}\n"
            "  end\n"
            "  subsection Exact solution\n"
            f"    set Function expression = {exact}\n"
            "  end\n"
            "  subsection Right hand side\n"
            f"    set Function expression = {rhs}\n"
            "  end\n"
            "  subsection Reaction coefficient\n"
            f"    set Function expression = {react}\n"
            "  end\n"
            "  subsection Solver\n"
            "    subsection Fine solver control\n"
            f"      set Max steps = {self.fine_solver.max_steps}\n"
            f"      set Tolerance = {self.fine_solver.tolerance}\n"
            f"      set Reduction = {self.fine_solver.reduce}\n"
            "    end\n"
            "    subsection Coarse solver control\n"
            f"      set Max steps = {self.coarse_solver.max_steps}\n"
            f"      set Tolerance = {self.coarse_solver.tolerance}\n"
            f"      set Reduction = {self.coarse_solver.reduce}\n"
            "    end\n"
            "  end\n"
            "  subsection Error\n"
            "    set List of error norms to compute = "
            + ", ".join({"L2": "L2_norm", "H1": "H1_norm",
                         "H1_semi": "H1_seminorm",
                         "Linfty": "Linfty_norm"}[n]
                        for n in self.error_norms) + "\n"
            "  end\n"
            "end\n"
        )


# Knobs of kernels that no longer exist.  Naming one is an error, not a
# silent no-op, so a stale script or parameter file fails loudly.
REMOVED_KNOBS = frozenset({
    "patch_solver", "fused_block", "fused_nb", "fused_algo", "solver_gj2",
    "split_bs", "panel_nb", "panel_gj_bs", "trace_impl", "trace_kernel",
    "eig_solver", "smallk_dirs", "smallk_power", "smallk_weig", "smallk_tol",
    "eig_sweeps", "eig_tol"})


def _reject_removed(names) -> None:
    bad = sorted(REMOVED_KNOBS.intersection(names))
    if bad:
        raise ValueError(f"removed configuration option(s): {', '.join(bad)} "
                         "(their kernels no longer exist; drop the setting)")


_dataclass_init = SLODConfig.__init__


@functools.wraps(_dataclass_init)
def _checked_init(self, *args, **kwargs):
    _reject_removed(kwargs)
    _dataclass_init(self, *args, **kwargs)


SLODConfig.__init__ = _checked_init
