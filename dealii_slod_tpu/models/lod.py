"""The SLOD/LOD pipeline: batched basis construction, coarse-operator
assembly, coarse + fine solves, error tables.

Batched re-design of the reference ``LOD<dim, spacedim>`` engine
(reference include/LOD.h:159-262, source/LOD.cc) — same mathematics, batched
dataflow:

- ``compute_basis_function_candidates`` (source/LOD.cc:296-768), the hot
  per-patch loop, becomes one jitted, ``vmap``-ped kernel per patch *shape
  class*: dense Q_iso_Q1 assembly by static scatter-add, multi-RHS Cholesky
  solve of the SPD internal submatrix (replacing Amesos KLU on the
  row-cleared operator — mathematically identical because the cleared rows
  carry zero right-hand sides, LOD.cc:512-544), the coarse triple product
  + inverse, and (optionally) the SLOD boundary-trace least squares with
  SVD truncation (LOD.cc:596-757).
- ``assemble_global_matrix`` (LOD.cc:860-973) becomes a *stencil-form*
  coarse operator: each basis function lives on a fixed-size canvas grid and
  ``A_LOD[(q,dq),(p,dp)] = phi_q . (A phi_p)`` is a batch of static-slice
  dot products over canvas overlaps — no sparse matrices anywhere.
- ``solve`` (CG+SSOR, LOD.cc:976-1002) becomes matrix-free CG with Jacobi
  preconditioning on the stencil operator; ``assemble_and_solve_fem_problem``
  (LOD.cc:1004-1238) becomes a matrix-free fine-grid CG-Jacobi solve plus a
  small dense coarse-FEM comparison solve.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from dealii_slod_tpu.config import SLODConfig
from dealii_slod_tpu.grid import (GridSpec, PatchTopology, ShapeClass,
                                  cartesian_coords, clipped_window_index,
                                  global_connectivity, ravel)
from dealii_slod_tpu.ops.assembly import (FineOperator, assemble_load_vector,
                                          make_subcell_matrices)
from dealii_slod_tpu.ops.element import ElementTensors, quad_points_global
from dealii_slod_tpu.ops.solvers import (cg, cholesky_factor, cholesky_solve,
                                         dense_dirichlet_solve)
from dealii_slod_tpu.utils.errors import ConvergenceTable
from dealii_slod_tpu.utils.timers import StageTimer


from dealii_slod_tpu.models.basis import _WINDOW_SLAB_BYTES, BasisKernels
from dealii_slod_tpu.models.stencil import StencilOps


class LODSolver(BasisKernels, StencilOps):
    """Orchestrates the full pipeline (reference LOD::run, LOD.cc:1423-1467)."""

    def __init__(self, cfg: SLODConfig, problem, verbose: bool = True):
        self.cfg = cfg
        self.problem = problem
        self.verbose = verbose
        self.timer = StageTimer()
        C = problem.n_components
        self.C = C
        self.grid = GridSpec(cfg.dim, cfg.n_coarse, cfg.n_subdivisions, C)
        self.dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32

        with self.timer.section("1: create patches"):
            self.topo = PatchTopology(self.grid, cfg.oversampling)
        self.et = ElementTensors(cfg.dim, self.grid.h, C)

        # global quadrature data (coefficients + rhs at quadrature points,
        # cf. reference value_list calls, Diffusion.h:151-154)
        qpts = quad_points_global(self.grid)           # (n_fine_cells, nq, dim)
        self.qpts = qpts
        self.coef_q = {k: jnp.asarray(v, self.dtype)
                       for k, v in problem.coefficients(qpts).items()}
        self.coef_names = sorted(self.coef_q.keys())
        self.conn = jnp.asarray(global_connectivity(self.grid))

        # canvas geometry: every basis function is stored on a fixed
        # (2l+1)s+1 per-axis node grid anchored at (center - l)*s, so that
        # the canvas shift between patches q and p = q + delta is exactly
        # delta*s — static per stencil offset, clipping-independent.
        ell = cfg.oversampling
        s = cfg.n_subdivisions
        self.canvas_dims = np.full(cfg.dim, (2 * ell + 1) * s + 1,
                                   dtype=np.int64)
        self.canvas_n = int(self.canvas_dims.prod())
        centers = cartesian_coords(self.grid.cell_dims)
        self.anchor_nodes = (centers - ell) * s        # may be negative
        self.canvas_off = (ell - (centers - self.topo.patch_lo)) * s
        # clamped: out-of-window canvas nodes hold phi = 0, so clamped
        # gathers/scatters contribute nothing.
        gidx, _ = clipped_window_index(self.anchor_nodes, self.canvas_dims,
                                       self.grid.node_dims)
        self.canvas_gidx = jnp.asarray(gidx)

        # stencil neighbor table: windows of q and p overlap iff
        # |center_p - center_q|_inf <= 2l
        R = min(2 * ell, cfg.n_coarse - 1)
        self.stencil_R = R
        offsets = cartesian_coords(np.full(cfg.dim, 2 * R + 1)) - R
        self.stencil_offsets = offsets                 # (S, dim)
        self.n_stencil = len(offsets)
        nb, valid = clipped_window_index(centers - R,
                                         np.full(cfg.dim, 2 * R + 1),
                                         self.grid.cell_dims)
        self.stencil_nbr = jnp.asarray(np.where(valid, nb, 0))
        self.stencil_valid = jnp.asarray(valid)
        self.center_offset_idx = int(np.nonzero((offsets == 0).all(axis=1))[0][0])

        # the uniform kernel pads every patch to the full (2l+1)-cell canvas
        # window with data-driven masks — one shape class, one compiled
        # kernel, one uniform batch (SURVEY.md §7 'ragged boundary patches')
        self.canvas_class = ShapeClass((2 * ell + 1,) * cfg.dim, self.grid)
        self.canvas_center_cell = int(ravel(np.full(cfg.dim, ell),
                                            np.full(cfg.dim, 2 * ell + 1)))

        self._class_kernels: Dict[int, callable] = {}
        self._uniform_kernel_cache = None
        self._uniform_scan_cache = None
        self.log = (lambda *a: print(*a)) if verbose else (lambda *a: None)

    def parse(self, spec):
        """Parse a function spec with the *problem's* component count (the
        config default n_components may not match, e.g. elasticity)."""
        from dealii_slod_tpu.config import ParsedFunction
        return ParsedFunction(spec, self.C, self.cfg.dim)

    # ------------------------------------------------------------------
    # Right-hand sides, solves
    # ------------------------------------------------------------------

    def assemble_fine_rhs(self):
        """Eliminated fine FEM right-hand side (reference LOD.cc:1050-1063):
        load vector, minus the lifting of inhomogeneous Dirichlet data, with
        zeros at constrained rows (so its norm matches the reference's
        printed 'fem rhs l2 norm')."""
        cfg = self.cfg
        f_q = jnp.asarray(self.parse(cfg.rhs)(self.qpts), self.dtype)
        load = assemble_load_vector(self.et, self.conn, f_q, self.grid.n_nodes)
        bnd = jnp.asarray(self.grid.boundary_node_mask())
        g = jnp.asarray(self.parse(cfg.bc)(self.grid.node_coords()),
                        self.dtype)
        # lifting = the GLOBAL nodal interpolant of g (g is defined on all of
        # [0,1]^dim), not extension-by-zero: the eliminated rhs then stays a
        # smooth L2 functional (~ f + div(alpha grad g)), which the LOD space
        # approximates at the theoretical rate.  Extension-by-zero (what
        # AffineConstraints elimination amounts to in the reference,
        # LOD.cc:1017-1021) concentrates the rhs in the first fine layer and
        # stalls LOD convergence (tests/test_inhomogeneous_bc.py).
        op_raw = FineOperator(self.grid, self.et, self.conn, self.coef_q)
        rhs = jnp.where(bnd[:, None], 0.0, load - op_raw._apply_raw(g))
        self.fine_bnd = bnd
        self.fine_bc_values = g
        self.fem_rhs = rhs
        return rhs

    def _two_level_precond(self, diag):
        """Additive two-level preconditioner for the fine solve:
        M^-1 r = r / diag + C A_LOD^-1 C^T r — the LOD space itself as the
        coarse correction (the data-parallel stand-in for the reference's AMG,
        LOD.cc:1074-1078, and markedly stronger at high contrast because
        the coarse space is coefficient-adapted)."""
        P, C = self.topo.n_patches, self.C
        # densify the stencil coarse operator once and factorize (one
        # vectorized scatter: every (row, stencil-slot) pair is a distinct
        # (row, col), so plain fancy assignment is collision-free)
        nbr = np.asarray(self.stencil_nbr)
        valid = np.asarray(self.stencil_valid)
        A_st = np.asarray(self.A_stencil)
        n = P * C
        A_dense = np.zeros((n, n), A_st.dtype)
        q, k = np.nonzero(valid)
        pcols = nbr[q, k]
        cc = np.arange(C)
        A_dense[(q[:, None, None] * C + cc[None, :, None]),
                (pcols[:, None, None] * C + cc[None, None, :])] = A_st[q, k]
        L = cholesky_factor(jnp.asarray(A_dense, self.dtype))

        def coarse_solve(rc):
            return cholesky_solve(L, rc.reshape(-1, 1))[:, 0].reshape(P, C)

        return self._two_level_from(coarse_solve, diag)

    def _two_level_precond_stencil(self, diag):
        """Cap-free variant of `_two_level_precond`: the coarse correction
        is a fixed-degree Chebyshev polynomial of the STENCIL operator —
        linear and SPD (a valid PCG preconditioner, unlike truncated inner
        CG), with no densification, so it scales to any patch count."""
        P, C = self.topo.n_patches, self.C
        A_st = self.A_stencil
        # spectral bounds: lambda_max by Gershgorin row sums (cheap, safe
        # upper bound); lambda_min heuristic at lambda_max / 30 — a loose
        # lower bound only softens the polynomial, it stays SPD
        lmax = float(jnp.max(jnp.sum(jnp.abs(A_st), axis=(1, 3))))
        lmin = lmax / 30.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        degree = 16

        def coarse_solve(rc):
            # standard Chebyshev iteration for A y = rc on [lmin, lmax]
            mv = lambda v: self._coarse_matvec_with(A_st, v)
            y = rc / theta
            d = y
            sigma = theta / delta
            rho = 1.0 / sigma
            for _ in range(degree - 1):
                rho_new = 1.0 / (2.0 * sigma - rho)
                d = rho_new * (2.0 / delta * (rc - mv(y)) + rho * d)
                y = y + d
                rho = rho_new
            return y

        return self._two_level_from(coarse_solve, diag)

    def _two_level_from(self, coarse_solve, diag):
        P, C = self.topo.n_patches, self.C

        def precond(r):
            rc = jnp.einsum("pncd,pnc->pd", self.Phi,
                            r[self.canvas_gidx])              # C^T r
            y = coarse_solve(rc)
            vals = jnp.einsum("pncd,pd->pnc", self.Phi, y)    # C y
            coarse = jnp.zeros_like(r).at[self.canvas_gidx].add(vals)
            coarse = jnp.where(self.fine_bnd[:, None], 0.0, coarse)
            return r / diag + coarse

        return precond

    def solve_fine_fem(self):
        """Reference fine-scale FEM solve: CG + Jacobi (replaces CG + AMG,
        LOD.cc:1066-1079; AMG is inherently sequential and this solve is a
        comparison baseline), optionally with the LOD-space two-level
        preconditioner (cfg.fine_preconditioner = 'two_level')."""
        op = FineOperator(self.grid, self.et, self.conn, self.coef_q,
                          dirichlet_mask=self.fine_bnd)
        d = op.diagonal()
        if (self.cfg.fine_preconditioner == "two_level"
                and hasattr(self, "A_stencil")):
            # direct coarse factor while it is small; stencil-form
            # Chebyshev correction beyond (no densification cap).  The
            # dense path materializes a (P*C)^2 matrix on the host — the
            # default cap (4096 -> 128 MB f64) keeps that benign
            if self.topo.n_patches * self.C <= self.cfg.two_level_dense_cap:
                precond = self._two_level_precond(d)
            else:
                precond = self._two_level_precond_stencil(d)
        else:
            precond = lambda r: r / d
        rc = self.cfg.fine_solver
        res = cg(op, self.fem_rhs, max_steps=rc.max_steps,
                 tolerance=rc.tolerance, reduce=rc.reduce,
                 precond=precond)
        # res.x is the eliminated correction (zero at Dirichlet rows); the
        # full solution re-adds the global interpolant lifting
        u = res.x + self.fine_bc_values
        self.fem_solution = u
        self.fine_cg = res
        if not bool(res.converged):
            # surface non-convergence like the reference's
            # SolverControl::NoConvergence (LODtools.h:434-438); the CG
            # carries an explicit flag, so a solve converging exactly at the
            # final iteration is not mis-flagged
            self.log(f"WARNING: fine CG did not converge in {rc.max_steps} "
                     f"iterations (residual {float(res.residual):.3e})")
        return u

    def solve_coarse(self):
        """Coarse LOD solve (reference LOD.cc:976-1002): rhs = C^T f, then
        CG (Jacobi in place of SSOR) on the stencil operator."""
        C = self.C
        f_at_canvas = (self._rhs_windows(self.fem_rhs)
                       if self.cfg.kernel_mode == "uniform"
                       else self.fem_rhs[self.canvas_gidx])   # (P, canvas, C)
        rhs_c = jnp.einsum("pncd,pnc->pd", self.Phi, f_at_canvas)
        self.coarse_rhs = rhs_c
        self.log(f"     rhs l2 norm = {float(jnp.linalg.norm(rhs_c)):.6g}")
        if self._use_direct_coarse():
            x = self._coarse_direct_fn(self.A_stencil)(rhs_c)
            self.coarse_solution = x                          # (P, C)
            self.coarse_cg = None
            self.log(f"   size of u {x.size}")
            return x
        diag = jnp.einsum("pdd->pd",
                          self.A_stencil[:, self.center_offset_idx])
        rc = self.cfg.coarse_solver
        res = cg(self._coarse_matvec_fn(self.A_stencil), rhs_c,
                 max_steps=rc.max_steps, tolerance=rc.tolerance,
                 reduce=rc.reduce, precond=lambda r: r / diag)
        self.coarse_solution = res.x                          # (P, C)
        self.coarse_cg = res
        self.log(f"   size of u {res.x.size}")
        return res.x

    def prolong_lod_solution(self) -> jnp.ndarray:
        """lod_solution = C u + g: scatter the u-weighted basis canvases into
        the global fine grid (reference LOD.cc:1251) and re-add the Dirichlet
        lifting that ``assemble_fine_rhs`` eliminated.

        The reference never adds the lifting back — its coarse
        ``distribute`` (LOD.cc:1001) is a no-op on DGQ0, so for g != 0 its
        LOD solution is wrong at the boundary (recorded in PARITY.md); here
        the lifting is restored so inhomogeneous problems converge."""
        vals = jnp.einsum("pncd,pd->pnc", self.Phi, self.coarse_solution)
        out = jnp.zeros((self.grid.n_nodes, self.C), self.dtype)
        out = out.at[self.canvas_gidx].add(vals)
        if hasattr(self, "fine_bc_values"):
            out = out + self.fine_bc_values
        self.lod_solution = out
        return out

    # ------------------------------------------------------------------
    # Fully-jittable pipeline step (single-chip entry + SPMD sharding)
    # ------------------------------------------------------------------

    def build_step(self, mesh=None, prolong: bool = False):
        """Return a pure, jittable end-to-end step

            step(coefs: dict[str, (n_fine_cells, nq)], fem_rhs: (n_nodes, C))
                -> (coarse solution (P, C), A_stencil (P, S, C, C))

        covering basis construction -> coarse-operator assembly -> CG solve.
        With ``prolong=True`` the step also returns the prolonged fine field
        C u (n_nodes, C), without the Dirichlet lifting that
        `prolong_lod_solution` adds back.
        With ``mesh`` given, the patch batch axis is sharded over the mesh's
        ``cfg.mesh_axis`` dimension (the reference's MPI patch
        data-parallelism, source/LOD.cc:116-118, recast as SPMD sharding —
        XLA inserts the collectives for the stencil neighbor gathers and the
        CG reductions)."""
        from jax.sharding import NamedSharding, PartitionSpec

        P = self.topo.n_patches
        C = self.C
        axis = self.cfg.mesh_axis
        n_dev = int(np.prod(list(mesh.shape.values()))) if mesh is not None else 1

        def constrain(x):
            # shard leading (patch) axis when divisible; replicate otherwise
            if mesh is None:
                return x
            if x.shape[0] % n_dev != 0:
                # replication fallback is correctness-preserving but a perf
                # cliff — make it visible
                self.log(f"WARNING: leading axis {x.shape[0]} not divisible "
                         f"by {n_dev} devices; array left replicated")
                return x
            spec = PartitionSpec(axis, *([None] * (x.ndim - 1)))
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, spec))

        chunk = self.cfg.patch_chunk

        def pad_idx(B):
            if chunk and B > chunk:
                n_chunks = -(-B // chunk)
                return n_chunks, np.minimum(np.arange(n_chunks * chunk), B - 1)
            return 1, np.arange(B)

        # each batch: (pids, gsub-or-None, pad idx, extra per-patch inputs,
        # n_chunks, B, chunk-level kernel fn); gsub None = structured
        # coefficient-window extraction inside the traced step
        nc_names = len(self.coef_names)
        batches = []
        if self.cfg.kernel_mode == "uniform":
            gsub, nlo, nhi, sides = self._uniform_inputs()
            B = self.topo.n_patches
            n_chunks, idx = pad_idx(B)
            g_j = (None if self._use_coef_windows()
                   else jnp.asarray(np.ascontiguousarray(gsub[idx])))
            # idx == arange(B) whenever B divides the chunk size; skip the
            # traced windows[idx] reorder there — XLA materializes the
            # identity gather as a full copy (1.0 GB per coefficient at
            # the 3D refine-5 elasticity config)
            idx_j = (None if np.array_equal(idx, np.arange(B))
                     else jnp.asarray(idx))
            batches.append(
                (jnp.asarray(np.arange(B)), g_j, idx_j,
                 (jnp.asarray(nlo[idx]), jnp.asarray(nhi[idx]),
                  jnp.asarray(sides[idx])),
                 n_chunks, B, self._uniform_chunk_fn()))
        else:
            for ci in range(len(self.topo.classes)):
                pids, gsub, is99, isdom, central, off = self._class_inputs(ci)
                B = len(pids)
                n_chunks, idx = pad_idx(B)
                fn_ci = self._class_patch_fn(ci)
                batches.append(
                    (jnp.asarray(pids),
                     jnp.asarray(np.ascontiguousarray(gsub[idx])),
                     jnp.asarray(idx),
                     (jnp.asarray(is99[idx]), jnp.asarray(isdom[idx]),
                      jnp.asarray(central[idx]), jnp.asarray(off[idx])),
                     n_chunks, B,
                     jax.vmap(fn_ci, in_axes=([0] * nc_names,) + (0,) * 4)))

        def step(coefs, fem_rhs):
            with jax.default_matmul_precision(self.cfg.matmul_precision):
                return _step_inner(coefs, fem_rhs)

        # one batch covering every patch in order (uniform mode): the
        # canvases ARE the chunk-map output — the .at[pids].set identity
        # scatter copied it into fresh zero canvases (2 x 1.55 GB temps
        # at the 3D refine-5 elasticity config)
        full_cover = (len(batches) == 1
                      and np.array_equal(np.asarray(batches[0][0]),
                                         np.arange(P)))

        def _step_inner(coefs, fem_rhs):
            with jax.named_scope("basis"):
                Phi, APhi = _basis(coefs)
            with jax.named_scope("stencil_build"):
                A_st = constrain(self._stencil_build(Phi, APhi))
            with jax.named_scope("coarse_rhs"):
                f_at = (self._rhs_windows(fem_rhs)
                        if self.cfg.kernel_mode == "uniform"
                        else fem_rhs[self.canvas_gidx])       # (P, canvas, C)
                rhs_c = constrain(jnp.einsum("pncd,pnc->pd", Phi, f_at))
            with jax.named_scope("coarse_solve"):
                if self._use_direct_coarse():
                    x = self._coarse_direct_fn(A_st)(rhs_c)
                else:
                    diag = jnp.einsum("pdd->pd",
                                      A_st[:, self.center_offset_idx])
                    rc = self.cfg.coarse_solver
                    x = cg(self._coarse_matvec_fn(A_st), rhs_c,
                           max_steps=rc.max_steps, tolerance=rc.tolerance,
                           reduce=rc.reduce, precond=lambda r: r / diag).x
            if not prolong:
                return x, A_st
            with jax.named_scope("prolong"):
                vals = jnp.einsum("pncd,pd->pnc", Phi, x)
                fine = jnp.zeros((self.grid.n_nodes, C), self.dtype
                                 ).at[self.canvas_gidx].add(vals)
            return x, A_st, fine

        def _basis(coefs):
            if full_cover:
                Phi = APhi = None
            else:
                Phi = constrain(
                    jnp.zeros((P, self.canvas_n, C, C), self.dtype))
                APhi = constrain(
                    jnp.zeros((P, self.canvas_n, C, C), self.dtype))
            for pids, gsub, idx, extras, n_chunks, B, vfn in batches:
                # in-body window extraction: when the chunks tile whole
                # patch x-rows in lex order, each chunk's coefficient
                # windows come straight off the small padded lattice
                # inside the loop body — the full precomputed window
                # array (1.00 GB per coefficient + a full-size layout
                # copy at the 3D refine-5 elasticity config) never
                # materializes.  Gated to the slab-size class
                # (same threshold as _window_stack) unless forced.
                wrows = None
                if gsub is None and idx is None:
                    mode = getattr(self.cfg, "window_chunk", "auto")
                    wrows = (None if mode == "off"
                             else self._window_chunk_rows(B, n_chunks))
                    if wrows is not None and mode == "auto":
                        win = ((2 * self.cfg.oversampling + 1)
                               * self.cfg.n_subdivisions)
                        out_bytes = max(
                            B * win ** self.cfg.dim
                            * coefs[k].shape[-1] * coefs[k].dtype.itemsize
                            for k in self.coef_names)
                        if out_bytes <= _WINDOW_SLAB_BYTES:
                            wrows = None
                if gsub is None and wrows is None:
                    cl = [self._coef_windows(coefs[k])
                          for k in self.coef_names]
                    if idx is not None:
                        cl = [c[idx] for c in cl]
                elif gsub is not None:
                    cl = [coefs[k][gsub] for k in self.coef_names]
                if n_chunks == 1:
                    phi_c, aphi_c = vfn([constrain(c) for c in cl],
                                        *[constrain(e) for e in extras])
                else:
                    def resh(a):
                        return a.reshape((n_chunks, -1) + a.shape[1:])
                    if wrows is not None:
                        win = ((2 * self.cfg.oversampling + 1)
                               * self.cfg.n_subdivisions)
                        lats = [self._coef_lattice(coefs[k])
                                for k in self.coef_names]

                        def body(t, _R=wrows, _win=win, _lats=lats,
                                 _vfn=vfn):
                            cl_j = [self._window_stack_chunk(L, t[0], _R,
                                                             _win)
                                    for L in _lats]
                            return _vfn(cl_j, *t[1:])

                        phi_c, aphi_c = jax.lax.map(
                            body,
                            (jnp.arange(n_chunks, dtype=jnp.int32),)
                            + tuple(resh(e) for e in extras))
                    else:
                        phi_c, aphi_c = jax.lax.map(
                            lambda t: vfn(list(t[0]), *t[1:]),
                            (tuple(resh(c) for c in cl),)
                            + tuple(resh(e) for e in extras))
                    phi_c = phi_c.reshape((-1,) + phi_c.shape[2:])[:B]
                    aphi_c = aphi_c.reshape((-1,) + aphi_c.shape[2:])[:B]
                phi_c = phi_c[:B].reshape(B, -1, C, C)
                aphi_c = aphi_c[:B].reshape(B, -1, C, C)
                if full_cover:
                    Phi, APhi = constrain(phi_c), constrain(aphi_c)
                else:
                    Phi = Phi.at[pids].set(phi_c)
                    APhi = APhi.at[pids].set(aphi_c)
            return Phi, APhi

        return step

    # ------------------------------------------------------------------
    # Coarse FEM comparison (reference LOD.cc:1103-1237)
    # ------------------------------------------------------------------

    def solve_coarse_fem(self):
        """Q1 FEM on the coarse grid (FE_Q_iso_Q1(1)), direct solve,
        interpolated to the fine grid."""
        cfg, C = self.cfg, self.C
        N = cfg.n_coarse
        gH = GridSpec(cfg.dim, N, 1, C)
        etH = ElementTensors(cfg.dim, gH.h, C)
        connH = global_connectivity(gH)
        qptsH = quad_points_global(gH)
        coefsH = {k: jnp.asarray(v, self.dtype)
                  for k, v in self.problem.coefficients(qptsH).items()}
        f_qH = jnp.asarray(self.parse(cfg.rhs)(qptsH), self.dtype)
        rhsH = assemble_load_vector(etH, jnp.asarray(connH), f_qH, gH.n_nodes)
        bndH = jnp.asarray(gH.boundary_node_mask())
        gvals = jnp.asarray(self.parse(cfg.bc)(gH.node_coords()), self.dtype)

        n_dofs = gH.n_fine_dofs
        if n_dofs <= 6000:
            # dense direct solve (reference SolverDirect, LOD.cc:1191-1195)
            m = 2 ** cfg.dim
            conn_dof = (connH[:, :, None] * C
                        + np.arange(C)[None, None, :]).reshape(len(connH), m * C)
            rows = np.repeat(conn_dof[:, :, None], m * C, axis=2)
            cols = np.repeat(conn_dof[:, None, :], m * C, axis=1)
            flat = (rows.astype(np.int64) * n_dofs + cols.astype(np.int64))
            Ksub = make_subcell_matrices(etH, coefsH)
            A = jnp.zeros(n_dofs * n_dofs, self.dtype
                          ).at[jnp.asarray(flat.reshape(-1))].add(
                              Ksub.reshape(-1)).reshape(n_dofs, n_dofs)
            constrained = jnp.repeat(bndH, C).astype(self.dtype)
            uH = dense_dirichlet_solve(A, rhsH.reshape(-1), constrained,
                                       gvals.reshape(-1)).reshape(-1, C)
        else:
            opH = FineOperator(gH, etH, connH, coefsH, dirichlet_mask=bndH)
            g_ext = jnp.where(bndH[:, None], gvals, 0.0)
            rhsE = jnp.where(bndH[:, None], 0.0, rhsH - opH._apply_raw(g_ext))
            dH = opH.diagonal()
            res = cg(opH, rhsE, max_steps=2000, tolerance=1e-12, reduce=1e-14,
                     precond=lambda r: r / dH)
            uH = jnp.where(bndH[:, None], g_ext, res.x)

        # Q1 prolongation coarse nodes -> fine nodes (FETools::interpolate,
        # LOD.cc:1201-1204)
        s = cfg.n_subdivisions
        f_coords = cartesian_coords(self.grid.node_dims)
        cell = np.minimum(f_coords // s, N - 1)
        tloc = (f_coords - cell * s) / s                      # (n_nodes, dim)
        bits = cartesian_coords(np.full(cfg.dim, 2))          # (m, dim)
        idxH = ravel(cell[:, None, :] + bits[None, :, :], gH.node_dims)
        wts = np.prod(np.where(bits[None, :, :] == 1, tloc[:, None, :],
                               1.0 - tloc[:, None, :]), axis=-1)
        uH_fine = jnp.einsum("nm,nmc->nc", jnp.asarray(wts, self.dtype),
                             uH[jnp.asarray(idxH)])
        self.coarse_fem_solution = uH
        self.coarse_fem_on_fine = uH_fine
        return uH, uH_fine

    # ------------------------------------------------------------------
    # Output (reference output_coarse_results LOD.cc:248-293, fine VTU
    # LOD.cc:1262-1377, coefficients VTU Diffusion.h:70-108, parameter dump
    # LOD.cc:60-62)
    # ------------------------------------------------------------------

    def write_outputs(self):
        from dealii_slod_tpu.utils.io import (write_coarse_grid_vtu,
                                              write_fine_grid_vtu,
                                              write_subcell_field_vtu)
        cfg = self.cfg
        out = cfg.output_directory
        name = cfg.output_name
        import os
        os.makedirs(out, exist_ok=True)

        # used parameters dump (print_parameters, LOD.cc:60-62)
        with open(os.path.join(
                out, f"used_parameters_{cfg.dim}.prm"), "w") as f:
            f.write(cfg.to_prm())

        # coefficient fields at fine-subcell resolution
        centers = (cartesian_coords(self.grid.fine_cell_dims) + 0.5) \
            * self.grid.h
        coef_cells = {k: np.asarray(f)
                      for k, f in self.problem.coefficients(centers).items()}
        write_subcell_field_vtu(
            os.path.join(out, f"{name}_coefficients.vtu"),
            self.grid, coef_cells)

        # fine fields
        node_xy = self.grid.node_coords()
        pd = {}
        if hasattr(self, "fem_solution"):
            pd["fem_reference"] = np.asarray(self.fem_solution)
        pd["exact_solution"] = self.parse(cfg.exact_solution)(node_xy)
        pd["exact_rhs"] = self.parse(cfg.rhs)(node_xy)
        if hasattr(self, "lod_solution"):
            pd["lod_solution"] = np.asarray(self.lod_solution)
        if hasattr(self, "coarse_fem_on_fine"):
            pd["fem_coarse_solution"] = np.asarray(self.coarse_fem_on_fine)
        write_fine_grid_vtu(os.path.join(out, f"{name}_fine.vtu"),
                            self.grid, pd)

        # coarse (per-cell DGQ0) fields
        if hasattr(self, "coarse_solution"):
            cell_centers = (cartesian_coords(self.grid.cell_dims) + 0.5) \
                * self.grid.H
            cd = {"LOD_solution": np.asarray(self.coarse_solution),
                  "exact_solution":
                      self.parse(cfg.exact_solution)(cell_centers)}
            write_coarse_grid_vtu(os.path.join(out, f"{name}_coarse.vtu"),
                                  self.grid, cd)

    # ------------------------------------------------------------------
    # Full pipeline
    # ------------------------------------------------------------------

    def run(self) -> Dict:
        if self.cfg.profile_dir:
            import contextlib
            with contextlib.ExitStack() as stack:
                try:
                    stack.enter_context(
                        jax.profiler.trace(self.cfg.profile_dir))
                except Exception as exc:  # profiling may be unsupported
                    self.log(f"profiler unavailable: {exc}")
                return self._run()
        return self._run()

    def _run(self) -> Dict:
        cfg = self.cfg
        self.log(f"Running LOD {self.problem.name} problem in {cfg.dim}D")
        sizes = self.topo.patch_sizes()
        self.log(f"Number of coarse cell = {self.grid.n_cells}, "
                 f"number of patches = {self.topo.n_patches} "
                 f"(locally owned: {self.topo.n_patches}) ")
        self.log(f"Patches size in ({sizes.min()}, {sizes.max()})")

        with self.timer.section("2: compute basis functions"):
            self.compute_basis()
            jax.block_until_ready(self.Phi)
        with self.timer.section("3: assemble global matrix"):
            self.assemble_coarse_operator()
            jax.block_until_ready(self.A_stencil)

        with self.timer.section("4: assemble fine FEM"):
            self.assemble_fine_rhs()
            jax.block_until_ready(self.fem_rhs)
        self.log(f"     fem rhs l2 norm = "
                 f"{float(jnp.linalg.norm(self.fem_rhs)):.6g}")

        results: Dict = {}
        conn_np = np.asarray(self.conn)
        exact = self.parse(cfg.exact_solution)

        from dealii_slod_tpu.utils import errors as _errmod

        def error_norms(*a, **k):  # noqa: F811 — filter to the configured
            d = _errmod.error_norms(*a, **k)  # norms list (LOD.h:150-156)
            return {key: d[key] for key in cfg.error_norms if key in d}

        if cfg.solve_fine_problem:
            with self.timer.section("4: solve fine FEM"):
                self.solve_fine_fem()
                jax.block_until_ready(self.fem_solution)
            self.log(f"   size of fem u {self.fem_solution.size}")
            if cfg.constant_coefficients:
                t = ConvergenceTable("errFEMh", dim=cfg.dim)
                t.add_row(self.grid.n_cells, self.grid.n_fine_dofs,
                          error_norms(self.grid, self.et, conn_np,
                                      np.asarray(self.fem_solution),
                                      exact=exact, qpts=self.qpts))
                results["error_FEMh_exact"] = t

        with self.timer.section("4: solve coarse LOD"):
            self.solve_coarse()
            jax.block_until_ready(self.coarse_solution)
        with self.timer.section("5: prolong + compare"):
            self.prolong_lod_solution()
            jax.block_until_ready(self.lod_solution)

        if cfg.constant_coefficients:
            t = ConvergenceTable("errLOD", dim=cfg.dim)
            t.add_row(self.grid.n_cells, self.grid.n_coarse_dofs,
                      error_norms(self.grid, self.et, conn_np,
                                  np.asarray(self.lod_solution),
                                  exact=exact, qpts=self.qpts))
            results["error_LOD_exact"] = t

        if cfg.solve_fine_problem:
            t = ConvergenceTable("errLOD", dim=cfg.dim)
            t.add_row(self.grid.n_cells, self.grid.n_coarse_dofs,
                      error_norms(self.grid, self.et, conn_np,
                                  np.asarray(self.lod_solution),
                                  other=np.asarray(self.fem_solution)))
            results["error_LOD_FEMh"] = t

        # coarse Q1 FEM comparison — the reference runs this for
        # spacedim == 2 only (LOD.cc:1103 'if constexpr (spacedim == 2)')
        if self.C == 2 or (self.C == cfg.dim and cfg.dim > 1):
            with self.timer.section("4: coarse FEM comparison"):
                self.solve_coarse_fem()
                jax.block_until_ready(self.coarse_fem_on_fine)
            if cfg.solve_fine_problem:
                t = ConvergenceTable("errFEM", dim=cfg.dim)
                t.add_row(self.grid.n_cells, self.grid.n_coarse_dofs,
                          error_norms(self.grid, self.et, conn_np,
                                      np.asarray(self.coarse_fem_on_fine),
                                      other=np.asarray(self.fem_solution)))
                results["error_FEMH_FEMh"] = t
            if cfg.constant_coefficients:
                t = ConvergenceTable("errFEM", dim=cfg.dim)
                t.add_row(self.grid.n_cells, self.grid.n_coarse_dofs,
                          error_norms(self.grid, self.et, conn_np,
                                      np.asarray(self.coarse_fem_on_fine),
                                      exact=exact, qpts=self.qpts))
                results["error_FEMH_exact"] = t

        for key, label in [("error_LOD_exact", "SLOD vs exact solution"),
                           ("error_FEMH_exact", "FEM(H) vs exact solution"),
                           ("error_FEMh_exact", "FEMh vs exact solution"),
                           ("error_FEMH_FEMh", "FEM(H) vs reference FEM(h)"),
                           ("error_LOD_FEMh", "SLOD vs reference FEM(h)")]:
            if key in results:
                self.log(label)
                self.log(str(results[key]))

        if cfg.write_output:
            with self.timer.section("6: fine output"):
                self.write_outputs()

        if self.verbose:
            self.log(self.timer.summary())
        results["coarse_solution"] = self.coarse_solution
        results["lod_solution"] = self.lod_solution
        if cfg.solve_fine_problem:
            results["fem_solution"] = self.fem_solution
        return results
