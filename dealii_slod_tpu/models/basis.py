"""Batched basis-construction kernels (the hot per-patch loop).

Batched re-design of the reference ``compute_basis_function_candidates``
(reference source/LOD.cc:296-768): one jitted, ``vmap``-ped kernel per patch
*shape class* — dense Q_iso_Q1 assembly by static scatter-add, multi-RHS
Cholesky solve of the SPD internal submatrix (replacing Amesos KLU on the
row-cleared operator — mathematically identical because the cleared rows
carry zero right-hand sides, LOD.cc:512-544), the coarse triple product +
inverse, and (optionally) the SLOD boundary-trace least squares with SVD
truncation (LOD.cc:596-757) — plus the *uniform padded kernel* that folds
every shape class into one compiled canvas-shaped batch with data-driven
window masks.

``BasisKernels`` is a mixin consumed by :class:`models.lod.LODSolver`; it
reads the solver state set up in ``LODSolver.__init__`` (grid, topology,
element tensors, canvas geometry) and fills ``self.Phi`` / ``self.APhi``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from dealii_slod_tpu.grid import ShapeClass, cartesian_coords, ravel
from dealii_slod_tpu.grid import rev_dims as _rev
from dealii_slod_tpu.ops.assembly import assemble_dense, make_subcell_matrices
from dealii_slod_tpu.ops.solvers import (cholesky_factor, cholesky_solve,
                                         spd_inverse)

# _window_stack switches to the sequential z-slab build above this output
# size (the one-shot stacked intermediate is laid out lattice-minor with
# padded small axes at 3D scale configs); each slab's output is bounded by
# _WINDOW_SLAB_TARGET.
_WINDOW_SLAB_BYTES = 256 * 2 ** 20
_WINDOW_SLAB_TARGET = 128 * 2 ** 20


class BasisKernels:
    """Basis-construction methods of the LOD solver (mixin)."""

    # ------------------------------------------------------------------
    # Basis construction (reference compute_basis_function_candidates)
    # ------------------------------------------------------------------

    def _slod_active(self, sc: ShapeClass) -> bool:
        """SLOD stabilization gate (reference LOD.cc:563-564): skip when not
        requested, when oversampling == 0, or when the patch covers the whole
        domain (no patch-interior boundary)."""
        full_domain = sc.n_cells_local == self.grid.n_cells
        return (self.cfg.lod_stabilization and self.cfg.oversampling > 0
                and not full_domain)

    def _class_patch_fn(self, ci: int):
        """Single-patch basis function builder for shape class ``ci`` —
        traced under vmap (batched) by `_build_class_kernel` and under the
        fully-jitted pipeline step by `build_step`."""
        sc = self.topo.classes[ci]
        cfg, et, C = self.cfg, self.et, self.C
        dt = self.dtype
        slod = self._slod_active(sc)

        flat_idx = jnp.asarray(sc.assembly_flat_idx)
        int_dofs = jnp.asarray(sc.interior_dof_indices())
        edge_dofs = jnp.asarray(sc.edge_dof_indices())
        edge_nodes = jnp.asarray(sc.edge_nodes)
        PT = jnp.asarray(sc.PT, dt)
        PT_int = jnp.asarray(sc.PT_interior, dt)
        nD = sc.n_fine_dofs_local
        cD = sc.n_coarse_dofs_local
        n_nodes = sc.n_nodes_local
        Hdim = self.grid.H ** cfg.dim
        node_grid = _rev(sc.node_dims_local)
        canvas_grid = _rev(self.canvas_dims)
        thr = cfg.svd_threshold

        def slod_phi_int(A, Ainv_PT, Tinv, is99, central):
            """SLOD stabilized candidates (reference LOD.cc:596-757)."""
            mask99 = jnp.repeat(is99, C).astype(dt)            # (nE*C,)
            S_edge = A[edge_dofs[:, None], int_dofs[None, :]] * mask99[:, None]
            PT_edge = PT[edge_dofs] * mask99[:, None]
            # BD maps coarse candidate coefficients -> basis trace on the
            # patch boundary: BD = (S_b A_int^-1 PT_int - PT_b) T^-1
            # (LOD.cc:612-618; the reference realizes the minus sign by
            # PT_boundary *= -1 plus additive mmult)
            BD = (S_edge @ Ainv_PT - PT_edge) @ Tinv           # (nE*C, cD)
            F = BD.T @ BD        # shared Gram: the 0/1 column masks commute
            cols = []            # with the row contraction
            for d in range(C):
                cen = central * C + d
                onehot = (jnp.arange(cD) == cen).astype(dt)
                colmask = 1.0 - onehot
                G = F * colmask[:, None] * colmask[None, :]    # (cD, cD)
                g0 = (F @ onehot) * colmask
                # pseudo-inverse via SVD with relative truncation
                # (compute_inverse_svd(1e-15), LOD.cc:667)
                U, sig, Vt = jnp.linalg.svd(G)
                inv_sig = jnp.where(sig > thr * sig[0], 1.0 / sig, 0.0)
                uv = U.T @ g0
                terms = (inv_sig * uv)[:, None] * Vt           # (cD, cD)
                d0 = -terms.sum(axis=0)
                # sigma-truncation conditioning loop (LOD.cc:703-725):
                # while ||d||_inf >= 0.5 add back the smallest-sigma
                # contributions; 'done' latches like the reference's break.
                def body(carry, term):
                    dvec, done = carry
                    done = done | (jnp.max(jnp.abs(dvec)) < 0.5)
                    dvec = jnp.where(done, dvec, dvec + term)
                    return (dvec, done), None
                (dvec, _), _ = jax.lax.scan(
                    body, (d0, jnp.asarray(False)), terms[::-1])
                dvec = dvec * colmask
                # candidate combination c = T^-1 (e_cen + sum_k d_k e_k)
                # (LOD.cc:727-743)
                c = Tinv @ (onehot + dvec)
                cols.append(Ainv_PT @ c)
            return jnp.stack(cols, axis=-1)                    # (nI*C, C)

        def one_patch(coef_list, is99, isdom, central, off):
            coefs = dict(zip(self.coef_names, coef_list))
            Ksub = make_subcell_matrices(et, coefs)
            A = assemble_dense(Ksub, flat_idx, nD)
            # SPD internal submatrix solve == the reference's row-cleared
            # operator + zeroed PT boundary rows (LOD.cc:512-546): boundary
            # unknowns are exactly zero, so solve on the interior block.
            A_int = A[int_dofs[:, None], int_dofs[None, :]]
            L = cholesky_factor(A_int)
            Ainv_PT = cholesky_solve(L, PT_int)                # (nI*C, cD)
            # P_tilde = P / H^dim (LOD.cc:548-553)
            T = (PT_int.T @ Ainv_PT) / Hdim
            Tinv = jnp.linalg.inv(T)
            if slod:
                phi_int = slod_phi_int(A, Ainv_PT, Tinv, is99, central)
            else:
                cen_dofs = central * C + jnp.arange(C)
                phi_int = Ainv_PT @ jnp.take(Tinv, cen_dofs, axis=1)
            # L2-normalize each basis function (LOD.cc:591, :752)
            norms = jnp.sqrt((phi_int ** 2).sum(axis=0))
            phi_int = phi_int / norms
            phi = jnp.zeros((nD, C), dt).at[int_dofs].set(phi_int)
            # premultiplied basis A_semi phi (LOD.cc:758-765): the
            # semi-constrained operator keeps patch-boundary rows but clears
            # domain-boundary rows (diag 1); phi vanishes on all boundary
            # nodes, so A_semi phi == (A phi) zeroed at domain-boundary dofs.
            Aphi = A @ phi
            dom_mask = jnp.zeros(n_nodes, bool).at[edge_nodes].set(isdom)
            Aphi = jnp.where(jnp.repeat(dom_mask, C)[:, None], 0.0, Aphi)

            # canvasize: place the patch block into the fixed-size canvas at
            # its per-patch offset
            def to_canvas(v):
                block = v.reshape(node_grid + (C, C))
                canvas = jnp.zeros(canvas_grid + (C, C), dt)
                starts = tuple(off[cfg.dim - 1 - a].astype(jnp.int32)
                               for a in range(cfg.dim)) \
                    + (jnp.int32(0), jnp.int32(0))
                canvas = jax.lax.dynamic_update_slice(canvas, block, starts)
                return canvas.reshape(self.canvas_n, C, C)

            return to_canvas(phi), to_canvas(Aphi)

        return one_patch

    def _build_class_kernel(self, ci: int):
        one_patch = self._class_patch_fn(ci)
        vfn = jax.vmap(one_patch, in_axes=([0] * len(self.coef_names),
                                           0, 0, 0, 0))

        def run(*args):
            with jax.default_matmul_precision(self.cfg.matmul_precision):
                return vfn(*args)

        return jax.jit(run)

    def _class_inputs(self, ci: int):
        """Static per-class batch inputs (NumPy): subcell gather indices
        (with the reference's cache semantics), edge flags, central cell,
        canvas offsets."""
        sc = self.topo.classes[ci]
        pids = self.topo.patches_by_class[ci]
        gsub = self.topo.global_subcell_indices(pids, sc).astype(np.int32)
        # patch-stiffness cache semantics (reference LOD.cc:354-361,
        # :433-451): with constant_coefficients, every full-size patch
        # reuses the stiffness of the *first* full-size patch — i.e. its
        # coefficient gather.  (A genuine no-op for truly constant
        # fields; bit-faithful to the reference's cache for random ones,
        # and a dedup/broadcast perf win either way.)
        if (self._stiffness_cache_ok()
                and sc.n_cells_local
                == (2 * self.cfg.oversampling + 1) ** self.cfg.dim):
            gsub = np.broadcast_to(gsub[:1], gsub.shape)
        is99_np, isdom_np = self.topo.edge_node_flags(pids, sc)
        return (pids, gsub, is99_np, isdom_np,
                self.topo.central_cell_local[pids],
                self.canvas_off[pids].astype(np.int32))

    # ------------------------------------------------------------------
    # Uniform padded kernel: one shape class, data-driven masks
    # ------------------------------------------------------------------

    def _uniform_inputs(self):
        """Per-patch inputs for the uniform kernel (NumPy): canvas-subcell
        gather indices (with the reference's full-size-patch cache
        semantics, LOD.cc:354-361), window node bounds in canvas coords,
        and domain-side flags."""
        g, topo, cfg = self.grid, self.topo, self.cfg
        sc = self.canvas_class
        anchors = self.anchor_nodes                          # (P, dim)
        coords = sc.sub_coords[None, :, :] + anchors[:, None, :]
        coords = np.clip(coords, 0, g.fine_cells_per_axis - 1)
        gsub = ravel(coords, g.fine_cell_dims).astype(np.int32)
        if self._stiffness_cache_ok():
            full = (topo.patch_shape
                    == 2 * cfg.oversampling + 1).all(axis=1)
            if full.any():
                first = int(np.nonzero(full)[0][0])
                gsub[full] = gsub[first]
        nlo = self.canvas_off.astype(np.int32)               # (P, dim)
        nhi = (self.canvas_off
               + topo.patch_shape * cfg.n_subdivisions).astype(np.int32)
        return gsub, nlo, nhi, topo.side_is_domain

    def _uniform_patch_fn(self):
        """Single-patch basis builder on the padded canvas.  Same
        mathematics as `_class_patch_fn` (reference LOD.cc:296-768) but with
        the real window described by per-patch masks instead of per-class
        static shapes: fake subcells get zero coefficients, fake/boundary
        dofs get identity rows, fake coarse cells get identity diagonal in
        the triple product — all exactly equivalent to the per-class
        computation (validated against it in tests/test_uniform.py).

        Two closures around a Cholesky multi-RHS solve:
        ``prep``   coefs+window -> assembled operators and masks,
        ``finish`` solve products -> stabilized basis canvases."""
        sc = self.canvas_class
        cfg, et, C = self.cfg, self.et, self.C
        dt = self.dtype
        # the reference skips stabilization per patch when the patch covers
        # the whole domain (LOD.cc:563-564); here that case needs no gate:
        # a full-domain patch has no 99-boundary dofs, so BD == 0 and the
        # SLOD formula degenerates exactly to the LOD candidate.
        slod = cfg.lod_stabilization and cfg.oversampling > 0

        flat_idx = jnp.asarray(sc.assembly_flat_idx)
        PT = jnp.asarray(sc.PT, dt)
        nD = sc.n_fine_dofs_local
        cD = sc.n_coarse_dofs_local
        n_nodes = sc.n_nodes_local
        Hdim = self.grid.H ** cfg.dim
        thr = cfg.svd_threshold
        node_coords = jnp.asarray(sc.node_coords_local.astype(np.int32))
        sub_coords = jnp.asarray(sc.sub_coords.astype(np.int32))
        cell_lo = jnp.asarray(
            (cartesian_coords(sc.cell_dims_local)
             * cfg.n_subdivisions).astype(np.int32))         # (cells, dim)
        s = cfg.n_subdivisions
        cen_dofs = jnp.asarray(self.canvas_center_cell * C + np.arange(C))
        # static canvas-interior restriction: every patch's window-interior
        # dofs lie in the canvas interior (windows are canvas-aligned boxes),
        # so the SPD solve runs at (Ks-1)^dim instead of (Ks+1)^dim —
        # a ((Ks+1)/(Ks-1))^(3 dim) Cholesky-FLOP saving.  The interior is a
        # rectangular subgrid, so its extraction is a strided SLICE of the
        # grid-reshaped matrix, not a gather (gathers at (nD)^2 size were the
        # dominant memory traffic).
        int_nodes_np = sc.interior_nodes
        int_coords = jnp.asarray(
            sc.node_coords_local[int_nodes_np].astype(np.int32))
        nI = len(int_nodes_np) * C
        PT_I = jnp.asarray(sc.PT[sc.interior_dof_indices()], dt)  # (nI, cD)
        grid_rev = _rev(sc.node_dims_local)
        inner = tuple(slice(1, -1) for _ in range(cfg.dim))

        def interior_cols(M):
            """(rows, nD) -> (rows, nI) by slicing the spatial grid axes."""
            r = M.shape[0]
            Mg = M.reshape((r,) + grid_rev + (C,))
            return Mg[(slice(None),) + inner].reshape(r, nI)

        def interior_rows(M):
            """(nD, ...) -> (nI, ...) by slicing the spatial grid row axes
            (last dims contiguous — much cheaper than the two-sided
            strided interior_rows_cols slice)."""
            tail = M.shape[1:]
            Mg = M.reshape(grid_rev + (C,) + tail)
            return Mg[inner].reshape((nI,) + tail)

        def scatter_interior(v):
            """(nI, k) -> (nD, k) zero-extended (ascending-dof order, same
            as the reference's extend_vector_to_boundary_values)."""
            k = v.shape[-1]
            z = jnp.zeros(grid_rev + (C, k), dt)
            z = z.at[inner].set(v.reshape(
                tuple(g - 2 for g in grid_rev) + (C, k)))
            return z.reshape(nD, k)

        use_banded = cfg.assembly_mode == "banded"
        from dealii_slod_tpu.ops.assembly import (assemble_bands,
                                                  band_placement_matrix,
                                                  bands_to_dense_mm,
                                                  make_band_tensors)
        if use_banded:
            band_tensors = make_band_tensors(et)
            sub_dims_np = sc.sub_dims_local.copy()
        node_dims_np = sc.node_dims_local.copy()
        int_dims_np = (sc.node_dims_local - 2).copy()
        offs_np = cartesian_coords(np.full(cfg.dim, 3)) - 1
        offs_j = jnp.asarray(offs_np.astype(np.int32))       # (3^dim, dim)
        center_o = int(np.nonzero((offs_np == 0).all(axis=1))[0][0])
        n_off = 3 ** cfg.dim
        if use_banded:
            P_int = band_placement_matrix(int_dims_np)       # A_solve embed
            node_strides_np = np.concatenate(
                [[1], np.cumprod(node_dims_np[:-1])]).astype(int)
            offs_flat_np = (offs_np @ node_strides_np).astype(int)
            shiftN = int(node_strides_np.sum())

        def stencil_apply(band, X_int):
            """Y = A[:, interior] @ X without materializing the rectangular
            (nI, nD) interior-rows block: 3^dim static shifted slices of the
            zero-extended X, each weighted by its band column — XLA fuses
            the whole sum into one elementwise pass, so the per-patch
            traffic is ~(band + 2 X) instead of the nI x nD dense block
            (which at the 3D bench config was 3.9 MB/patch to build, write
            and re-read).  Wrap-around flat positions are provably zero
            because off-grid neighbors have zero band values (the coupling
            subcells are clipped).  band (nN, 3^dim * C * C) flat (the
            canonical A_rows_I band form), X (nI, k) -> (nD, k)."""
            k = X_int.shape[-1]
            Xz = scatter_interior(X_int).reshape(n_nodes, C, k)
            Xp = jnp.pad(Xz, ((shiftN, shiftN), (0, 0), (0, 0)))
            if C == 1:
                # elementwise multiply-add chain — XLA fuses the 27 terms
                acc = None
                for oi in range(n_off):
                    s0 = shiftN + int(offs_flat_np[oi])
                    Xs = jax.lax.slice_in_dim(Xp, s0, s0 + n_nodes, axis=0)
                    t = band[:, oi][:, None] * Xs[:, 0]
                    acc = t if acc is None else acc + t
                return acc.reshape(n_nodes, k)
            # C > 1: each offset term is a real (n, C, C) x (n, C, k)
            # dot_general that XLA materializes, so 27 unrolled terms hold
            # 27 chunk-sized temps at once.  A scan carries ONE
            # accumulator instead, and every array is kept 2D with the
            # large axis last (no small trailing (C, C) or (nN, C) axes).
            starts = jnp.asarray(shiftN + offs_flat_np, jnp.int32)
            bandS = band.T.reshape(n_off, C * C, n_nodes)
            Xp_d = tuple(Xp[:, d, :] for d in range(C))    # (nNp, k) each

            def step(acc, xs):
                b_o, s0 = xs                               # (C*C, nN), ()
                sl = [jax.lax.dynamic_slice_in_dim(x, s0, n_nodes, axis=0)
                      for x in Xp_d]
                out = []
                for c in range(C):
                    t = acc[c]
                    for d in range(C):
                        t = t + b_o[c * C + d][:, None] * sl[d]
                    out.append(t)
                return tuple(out), None

            acc0 = tuple(jnp.zeros((n_nodes, k), X_int.dtype)
                         for _ in range(C))
            acc, _ = jax.lax.scan(step, acc0, (bandS, starts))
            return jnp.stack(acc, axis=1).reshape(n_nodes * C, k)

        if use_banded:
            apply_AI = stencil_apply
        else:
            def apply_AI(A_rows_I, X):
                return jnp.einsum("in,ik->nk", A_rows_I, X)

        def prep(coef_list, nlo, nhi):
            """Assembled operators + masks for one patch window.

            Everything the pipeline consumes is derived from the nodal-
            stencil *bands* — the full-canvas (nD, nD) dense matrix is
            never materialized (it was ~50x the band data and its
            two-sided strided interior slice dominated the prep stage):

            - ``A_rows_I`` (nI, nD): interior rows x all canvas columns,
              by the rectangular offset-grid band embedding; by symmetry
              its transpose is the A_cols_I block the trace/premultiply
              stages need.
            - ``A_solve`` (nI, nI): the window-interior SPD block, from
              bands masked at the band level (row node and stencil
              neighbor both inside the open window box) + unit diagonal
              on masked rows — the row-cleared reference operator's
              interior submatrix (LOD.cc:537-546)."""
            in_sub = ((sub_coords >= nlo) & (sub_coords <= nhi - 1)
                      ).all(axis=1)                          # (n_sub,)
            coefs = {k: c * in_sub[:, None]
                     for k, c in zip(self.coef_names, coef_list)}
            node_int = ((int_coords > nlo) & (int_coords < nhi)).all(axis=1)
            m = jnp.repeat(node_int, C).astype(dt)           # (nI,)
            if use_banded:
                band = assemble_bands(coefs, band_tensors, sub_dims_np)
                band_g = band.reshape(grid_rev + (n_off, C, C))
                band_I = band_g[inner].reshape(-1, n_off, C, C)
                nb = int_coords[:, None, :] + offs_j[None, :, :]
                nb_in = ((nb > nlo) & (nb < nhi)).all(axis=2)  # (n_int, O)
                mnode = node_int.astype(dt)
                band_s = band_I * (mnode[:, None]
                                   * nb_in.astype(dt))[:, :, None, None]
                band_s = band_s.at[:, center_o].add(
                    jnp.eye(C, dtype=dt)[None] * (1.0 - mnode)[:, None, None])
                A_solve = bands_to_dense_mm(band_s, *P_int)
                # the operator flows downstream in FLAT band form
                # (nN, 3^dim * C * C) — 27x fewer bytes than the (nI, nD)
                # dense block; the trace/premultiply products apply it via
                # `stencil_apply`
                A_rows_I = band.reshape(n_nodes, n_off * C * C)
            else:
                Ksub = make_subcell_matrices(et, coefs)
                A_raw = assemble_dense(Ksub, flat_idx, nD)
                A_rows_I = interior_rows(A_raw)
                A_II = interior_cols(A_rows_I)
                A_solve = (A_II * m[:, None] * m[None, :]
                           + jnp.diag(1.0 - m))
            cell_valid = ((cell_lo >= nlo)
                          & (cell_lo + s <= nhi)).all(axis=1)
            cvd = jnp.repeat(cell_valid, C).astype(dt)       # (cD,)
            PT_m = PT_I * m[:, None] * cvd[None, :]
            return A_rows_I, A_solve, PT_m, cvd

        def finish(A_rows_I, Ainv_PT, T, cvd, nlo, nhi, sides_dom):
            """Solve products -> stabilized, normalized basis canvases.

            ``A_rows_I`` (nI, nD) is the interior-rows band block; by the
            symmetry of the stiffness its transpose is A_cols_I, so every
            former ``A_cols_I @ X`` product is the contraction
            ``einsum("in,ik->nk", A_rows_I, X)`` (no transpose
            materialized)."""
            # T is SPD: Cholesky-based explicit inverse (gauss_jordan in the
            # reference, LOD.cc:553) — LU is overhead-bound at this size
            Tinv = spd_inverse(T)

            node_in = ((node_coords >= nlo)
                       & (node_coords <= nhi)).all(axis=1)
            on_lo = node_coords == nlo                       # (n_nodes, dim)
            on_hi = node_coords == nhi
            isdom = (((on_lo & sides_dom[0::2])
                      | (on_hi & sides_dom[1::2])).any(axis=1) & node_in)

            if slod:
                is99 = (((on_lo & ~sides_dom[0::2])
                         | (on_hi & ~sides_dom[1::2])).any(axis=1) & node_in)
                is99d = jnp.repeat(is99, C).astype(dt)
                # S_boundary rows (unconstrained stiffness at 99-dofs,
                # LOD.cc:520-528), interior columns
                S_AiPT = apply_AI(A_rows_I, Ainv_PT) * is99d[:, None]
                PT_b = PT * is99d[:, None] * cvd[None, :]
                BD = (S_AiPT - PT_b) @ Tinv                  # (nD, cD)
                F = BD.T @ BD        # shared Gram: the 0/1 column masks
                cols = []            # commute with the row contraction
                for d in range(C):
                    cen = self.canvas_center_cell * C + d
                    onehot = (jnp.arange(cD) == cen).astype(dt)
                    colmask = (1.0 - onehot) * cvd
                    G = F * colmask[:, None] * colmask[None, :]
                    g0 = F[:, cen] * colmask
                    # spectral pseudo-inverse — G is the PSD Gram matrix, so
                    # eigenpairs == singular triplets (descending reorder);
                    # same semantics as compute_inverse_svd (LOD.cc:667)
                    lam, V = jnp.linalg.eigh(G)
                    lam = lam[::-1]
                    V = V[:, ::-1]
                    inv_sig = jnp.where(lam > thr * lam[0], 1.0 / lam, 0.0)
                    uv = V.T @ g0
                    terms = (inv_sig * uv)[:, None] * V.T
                    d0 = -terms.sum(axis=0)

                    def body(carry, term):
                        dvec, done = carry
                        done = done | (jnp.max(jnp.abs(dvec)) < 0.5)
                        dvec = jnp.where(done, dvec, dvec + term)
                        return (dvec, done), None

                    (dvec, _), _ = jax.lax.scan(
                        body, (d0, jnp.asarray(False)), terms[::-1])
                    c = Tinv @ (onehot + dvec * colmask)
                    cols.append(Ainv_PT @ c)
                phi_int = jnp.stack(cols, axis=-1)           # (nI, C)
            else:
                phi_int = Ainv_PT @ jnp.take(Tinv, cen_dofs, axis=1)
            norms = jnp.sqrt((phi_int ** 2).sum(axis=0))
            phi_int = phi_int / norms
            phi = scatter_interior(phi_int)
            # premultiplied basis (LOD.cc:758-765): phi is supported on the
            # window interior, so A_semi phi == A[:, interior] @ phi_int with
            # domain-boundary rows zeroed
            Aphi = apply_AI(A_rows_I, phi_int)
            Aphi = jnp.where(jnp.repeat(isdom, C)[:, None], 0.0, Aphi)
            # outputs are already canvas-aligned
            return (phi.reshape(n_nodes, C, C),
                    Aphi.reshape(n_nodes, C, C))

        def one_patch(coef_list, nlo, nhi, sides_dom):
            with jax.named_scope("prep"):
                A_rows_I, A_solve, PT_m, cvd = prep(coef_list, nlo, nhi)
            with jax.named_scope("patch_solve"):
                L = cholesky_factor(A_solve)
                Ainv_PT = cholesky_solve(L, PT_m)            # (nI, cD)
                T = (PT_m.T @ Ainv_PT) / Hdim + jnp.diag(1.0 - cvd)
            with jax.named_scope("finish"):
                return finish(A_rows_I, Ainv_PT, T, cvd, nlo, nhi,
                              sides_dom)

        return one_patch

    def _uniform_chunk_fn(self):
        """Chunk-level uniform kernel: (coef_list of (B, n_sub, nq), nlo,
        nhi, sides) -> (Phi, APhi) of (B, n_nodes, C, C), the vmap of the
        per-patch builder."""
        nc = len(self.coef_names)
        return jax.vmap(self._uniform_patch_fn(),
                        in_axes=([0] * nc, 0, 0, 0))

    def _coef_windows(self, coef: jnp.ndarray) -> jnp.ndarray:
        """Patch-subcell coefficient windows (n_fine_cells, nq) ->
        (P, n_sub, nq) by structured window extraction (`_window_stack`)
        instead of a (P, n_sub) random gather: the window op streams where
        the gather reads scattered rows.  Out-of-domain subcells
        come back zero (padding), exactly matching the in-window coefficient
        mask the uniform kernel applies anyway."""
        cfg = self.cfg
        win = (2 * cfg.oversampling + 1) * cfg.n_subdivisions
        grid = _rev(self.grid.fine_cell_dims)
        return self._window_stack(coef.reshape(grid + (coef.shape[-1],)),
                                  win)

    def _window_stack(self, X: jnp.ndarray, win: int) -> jnp.ndarray:
        """Per-patch lattice windows by per-axis strided slice-stacks.

        ``X`` (grid_1, ..., grid_dim, tail) on the full fine lattice (cells
        or nodes) -> (P, win^dim, tail): for each patch the size-``win``
        window anchored at ``(center - ell) * s`` per axis, zero outside
        the domain.  The conv_general_dilated_patches form needs a full
        transpose of its (tail, n_win, P) output (131 MB at the 3D bench
        config); the stacks build the target layout
        directly: after processing the grid axes the array is
        (P_z, P_y, P_x, tail, o_z, o_y, o_x) and one moveaxis + reshape
        lands (P, n_win, tail) with the x-fastest window ravel.

        Above ``_WINDOW_SLAB_BYTES`` of output the build runs slab-wise
        over the first lattice axis: XLA lays the full stacked
        (P_z, P_y, P_x, tail, o_z, o_y, o_x) intermediate out
        lattice-minor (the stacks act on lattice axes), with its small
        axes padded wherever the layout is tiled (up to a 3.9 GB HLO temp
        at the 3D refine-5 elasticity config).  Slabbing bounds
        that temp at ~``_WINDOW_SLAB_TARGET`` while keeping the output
        ordering bit-identical (axis 0 is the major patch axis).  The
        slabs land via an unrolled static ``dynamic_update_slice`` chain
        rather than ``lax.map``: the map's while-carry accumulator was
        copied at the loop boundary (2 x 1.00 GB ``copy(while)`` HLO
        temps at the refine-5 elasticity config), while the DUS chain
        updates one buffer in place and sequences the slab temps."""
        cfg = self.cfg
        dim, s, N = cfg.dim, cfg.n_subdivisions, cfg.n_coarse
        pad = cfg.oversampling * s
        tail = X.shape[-1]
        X = jnp.pad(X, [(pad, pad)] * dim + [(0, 0)])

        def stack_axes(Xs, n0):
            for a in range(dim):
                n_a = n0 if a == 0 else N
                parts = [
                    jax.lax.slice_in_dim(Xs, o, o + s * (n_a - 1) + 1,
                                         stride=s, axis=a)
                    for o in range(win)
                ]
                Xs = jnp.stack(parts, axis=-1)
            Xs = jnp.moveaxis(Xs, dim, -1)  # tail behind the offset axes
            return Xs.reshape(n0 * N ** (dim - 1), win ** dim, tail)

        out_bytes = N ** dim * win ** dim * tail * X.dtype.itemsize
        if dim > 1 and out_bytes > _WINDOW_SLAB_BYTES:
            per_z = out_bytes // N
            zb = max(z for z in range(1, N + 1)
                     if N % z == 0
                     and (z == 1 or z * per_z <= _WINDOW_SLAB_TARGET))
            if zb < N:
                L = s * (zb - 1) + win
                rows = zb * N ** (dim - 1)
                out = jnp.zeros((N ** dim, win ** dim, tail), X.dtype)
                for i in range(N // zb):
                    slab = stack_axes(
                        jax.lax.slice_in_dim(X, i * zb * s, i * zb * s + L,
                                             axis=0), zb)
                    out = jax.lax.dynamic_update_slice_in_dim(
                        out, slab, i * rows, axis=0)
                return out
        # The one-shot stack needs a fusion barrier: with the identity
        # patch-index gather skipped (lod.py), XLA fuses the strided
        # slice-stack straight into the chunked consumer and trips a
        # TransformWindow CHECK (a compiler abort at the 3D refine-4
        # chunk=256 config).  The slab path above needs none (the DUS
        # chain already bounds fusion) — and a barrier there costs a
        # full-size layout copy (2 x 1.00 GB at the 3D refine-5
        # elasticity config).
        return jax.lax.optimization_barrier(stack_axes(X, N))

    def _coef_lattice(self, coef: jnp.ndarray) -> jnp.ndarray:
        """Zero-padded fine-cell coefficient lattice
        (grid_1+2p, ..., grid_dim+2p, nq) — the small (~12 MB at 3D
        refine-5) source array for per-chunk window extraction."""
        cfg = self.cfg
        grid = _rev(self.grid.fine_cell_dims)
        pad = cfg.oversampling * cfg.n_subdivisions
        X = coef.reshape(grid + (coef.shape[-1],))
        return jnp.pad(X, [(pad, pad)] * cfg.dim + [(0, 0)])

    def _window_chunk_rows(self, B: int, n_chunks: int):
        """Patch x-rows per chunk when in-body window extraction is legal:
        every chunk must cover whole consecutive x-rows (chunk % N == 0)
        that do not straddle a z-plane in 3D (N % R == 0), over the full
        lex-ordered patch set.  Returns R or None."""
        cfg = self.cfg
        N = cfg.n_coarse
        if cfg.dim < 2 or B != N ** cfg.dim or n_chunks <= 1:
            return None
        chunk, rem = divmod(B, n_chunks)
        if rem or chunk % N:
            return None
        R = chunk // N
        if cfg.dim == 3 and N % R:
            return None
        return R

    def _window_stack_chunk(self, Xpad: jnp.ndarray, chunk_idx, R: int,
                            win: int) -> jnp.ndarray:
        """Windows for one chunk of ``R`` consecutive patch x-rows,
        extracted from the padded lattice INSIDE the chunk loop ->
        (R*N, win^dim, tail).

        Same per-axis strided slice-stacks as `_window_stack`, applied to
        a dynamically-sliced sub-lattice (starts are multiples of s), so
        the output is bit-identical to the corresponding rows of the full
        build.  Exists because the full precomputed window array at the
        3D refine-5 elasticity config is 1.00 GB per coefficient PLUS a
        full-size layout copy into the chunk consumer's layout — per-chunk
        extraction never materializes either."""
        cfg = self.cfg
        dim, s, N = cfg.dim, cfg.n_subdivisions, cfg.n_coarse
        tail = Xpad.shape[-1]
        if dim == 2:
            y0 = chunk_idx * R
            starts = (y0 * s, 0, 0)
            sizes = (s * (R - 1) + win, Xpad.shape[1], tail)
            counts = (R, N)
        else:
            rows = chunk_idx * R
            starts = ((rows // N) * s, (rows % N) * s, 0, 0)
            sizes = (win, s * (R - 1) + win, Xpad.shape[2], tail)
            counts = (1, R, N)
        sub = jax.lax.dynamic_slice(
            Xpad, [jnp.asarray(v, jnp.int32) for v in starts], sizes)
        for a in range(dim):
            parts = [
                jax.lax.slice_in_dim(sub, o, o + s * (counts[a] - 1) + 1,
                                     stride=s, axis=a)
                for o in range(win)
            ]
            sub = jnp.stack(parts, axis=-1)
        sub = jnp.moveaxis(sub, dim, -1)
        return sub.reshape(R * N, win ** dim, tail)

    def _rhs_windows(self, fem_rhs: jnp.ndarray) -> jnp.ndarray:
        """Canvas-node windows of the fine rhs: (n_nodes, C) ->
        (P, canvas_n, C), the slice-stack replacement for the
        ``fem_rhs[canvas_gidx]`` gather.  Out-of-domain canvas nodes come
        back ZERO where the
        gather returns the clamped edge value — every consumer multiplies
        by a basis canvas that is zero there, so results are identical."""
        cfg = self.cfg
        win = (2 * cfg.oversampling + 1) * cfg.n_subdivisions + 1
        grid = _rev(self.grid.node_dims)
        return self._window_stack(fem_rhs.reshape(grid + (self.C,)), win)

    def _use_coef_windows(self) -> bool:
        """Window extraction applies whenever the per-patch coefficient rows
        are the plain geometric windows — i.e. except under the reference's
        constant-coefficient stiffness-cache semantics, which redirect
        full-size patches to the first one's rows (LOD.cc:354-361)."""
        return (self.cfg.coef_windows
                and self.cfg.kernel_mode == "uniform"
                and not self.cfg.constant_coefficients)

    def compute_basis(self):
        """Run the basis kernels; fills ``self.Phi``/``self.APhi`` canvases
        (P, canvas_n, C, C)."""
        if self.cfg.kernel_mode == "uniform":
            return self._compute_basis_uniform()
        return self._compute_basis_classes()

    def _stiffness_cache_ok(self) -> bool:
        """Validity gate for the reference's full-size-patch stiffness
        cache (LOD.cc:354-361), which redirects full patches' coefficient
        GATHERS to the first full patch.  Valid only when the patch
        operator is translation-invariant: truly constant problem fields
        (every named coefficient — a spatially varying reaction c(x)
        invalidates it even with constant alpha), or ``reference_parity``
        (the cache fires per the reference even for its random field)."""
        if not self.cfg.constant_coefficients:
            return False
        if getattr(self.cfg, "reference_parity", False):
            return True
        return (hasattr(self.problem, "is_constant")
                and self.problem.is_constant())

    def _patch_dedup(self, nlo, nhi, sides):
        """For constant coefficient fields the basis depends only on the
        window geometry + domain-side flags: compute unique signatures once
        and broadcast (generalizes the reference's full-size-patch cache,
        LOD.cc:354-361, from 'interior patches' to every repeated geometry —
        P=N^dim patch solves collapse to O((l+2)^dim))."""
        if not (hasattr(self.problem, "is_constant")
                and self.problem.is_constant()):
            return None
        key = np.concatenate([nlo, nhi, sides.astype(np.int32)], axis=1)
        _, rep, inv = np.unique(key, axis=0, return_index=True,
                                return_inverse=True)
        return rep.astype(np.int64), inv.astype(np.int64)

    def _compute_basis_uniform(self):
        P, C = self.topo.n_patches, self.C
        chunk = self.cfg.patch_chunk or P
        if self._uniform_kernel_cache is None:
            cfn = self._uniform_chunk_fn()

            def run(*args):
                with jax.default_matmul_precision(self.cfg.matmul_precision):
                    return cfn(*args)

            self._uniform_kernel_cache = jax.jit(run)
        kernel = self._uniform_kernel_cache
        gsub, nlo, nhi, sides = self._uniform_inputs()

        dedup = self._patch_dedup(nlo, nhi, sides)
        if dedup is not None:
            rep, inv = dedup
            gsub, nlo, nhi, sides = (gsub[rep], nlo[rep], nhi[rep],
                                     sides[rep])
        B = len(nlo)

        use_windows = self._use_coef_windows() and dedup is None
        if use_windows:
            cw = {k: self._coef_windows(self.coef_q[k])
                  for k in self.coef_names}
        else:
            gsub = jnp.asarray(gsub)
        nlo_j, nhi_j = jnp.asarray(nlo), jnp.asarray(nhi)
        sides_j = jnp.asarray(sides)
        step = min(chunk, B)
        n_chunks = -(-B // step)
        if self.cfg.chunk_scan and n_chunks > 1:
            # one jitted lax.scan over all chunks: a single dispatch for
            # the whole basis stage instead of one per chunk
            idx_all = np.minimum(np.arange(n_chunks * step), B - 1)
            jidx = jnp.asarray(idx_all)
            if use_windows:
                cls = tuple(
                    cw[k][jidx].reshape((n_chunks, step) + cw[k].shape[1:])
                    for k in self.coef_names)
            else:
                cls = tuple(
                    self.coef_q[k][gsub[jidx]].reshape(
                        (n_chunks, step) + gsub.shape[1:]
                        + self.coef_q[k].shape[1:])
                    for k in self.coef_names)
            xs = (cls,
                  nlo_j[jidx].reshape((n_chunks, step) + nlo_j.shape[1:]),
                  nhi_j[jidx].reshape((n_chunks, step) + nhi_j.shape[1:]),
                  sides_j[jidx].reshape((n_chunks, step)
                                        + sides_j.shape[1:]))
            if self._uniform_scan_cache is None:
                cfn = self._uniform_chunk_fn()
                prec = self.cfg.matmul_precision

                def run_all(cl_s, nlo_s, nhi_s, sd_s):
                    def body(_, x):
                        cl, lo, hi, sd = x
                        return None, cfn(list(cl), lo, hi, sd)

                    with jax.default_matmul_precision(prec):
                        _, out = jax.lax.scan(body, None,
                                              (cl_s, nlo_s, nhi_s, sd_s))
                    return out

                self._uniform_scan_cache = jax.jit(run_all)
            phi_s, aphi_s = self._uniform_scan_cache(*xs)
            Phi = phi_s.reshape(n_chunks * step, -1, C, C)[:B]
            APhi = aphi_s.reshape(n_chunks * step, -1, C, C)[:B]
            if dedup is not None:
                jinv = jnp.asarray(inv)
                Phi = Phi[jinv]
                APhi = APhi[jinv]
            self.Phi, self.APhi = Phi, APhi
            return Phi, APhi
        Phi = jnp.zeros((B, self.canvas_n, C, C), self.dtype)
        APhi = jnp.zeros((B, self.canvas_n, C, C), self.dtype)
        for lo in range(0, B, step):
            idx = np.minimum(np.arange(lo, lo + step), B - 1)
            jidx = jnp.asarray(idx)
            if use_windows:
                cl = [cw[k][jidx] for k in self.coef_names]
            else:
                cl = [self.coef_q[k][gsub[jidx]] for k in self.coef_names]
            phi_c, aphi_c = kernel(cl, nlo_j[jidx], nhi_j[jidx],
                                   sides_j[jidx])
            keep = min(lo + step, B) - lo
            ids = jnp.asarray(np.arange(lo, lo + keep))
            Phi = Phi.at[ids].set(phi_c[:keep].reshape(keep, -1, C, C))
            APhi = APhi.at[ids].set(aphi_c[:keep].reshape(keep, -1, C, C))
        if dedup is not None:
            jinv = jnp.asarray(inv)
            Phi = Phi[jinv]
            APhi = APhi[jinv]
        self.Phi, self.APhi = Phi, APhi
        return Phi, APhi

    def _compute_basis_classes(self):
        P, C = self.topo.n_patches, self.C
        Phi = jnp.zeros((P, self.canvas_n, C, C), self.dtype)
        APhi = jnp.zeros((P, self.canvas_n, C, C), self.dtype)
        chunk = self.cfg.patch_chunk
        for ci, sc in enumerate(self.topo.classes):
            if ci not in self._class_kernels:
                self._class_kernels[ci] = self._build_class_kernel(ci)
            kernel = self._class_kernels[ci]
            pids, gsub, is99_np, isdom_np, central, off = self._class_inputs(ci)
            gsub = jnp.asarray(gsub)
            inputs = (
                [self.coef_q[k][gsub] for k in self.coef_names],
                jnp.asarray(is99_np), jnp.asarray(isdom_np),
                jnp.asarray(central), jnp.asarray(off),
            )
            B = len(pids)
            step = B if chunk in (0, None) else min(chunk, B)
            for lo in range(0, B, step):
                hi = min(lo + step, B)
                # pad the remainder chunk to the full chunk size (avoids a
                # second compilation per class for the tail shape)
                idx = np.arange(lo, lo + step)
                idx = np.minimum(idx, B - 1)
                jidx = jnp.asarray(idx)
                args = ([c[jidx] for c in inputs[0]],) + tuple(
                    a[jidx] for a in inputs[1:])
                phi_c, aphi_c = kernel(*args)
                keep = hi - lo
                ids = jnp.asarray(pids[lo:hi])
                Phi = Phi.at[ids].set(phi_c[:keep])
                APhi = APhi.at[ids].set(aphi_c[:keep])
        self.Phi, self.APhi = Phi, APhi
        return Phi, APhi
