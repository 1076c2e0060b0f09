"""Stencil-form coarse operator (replaces the reference's sparse Tmmult).

``A_LOD[(q,dq),(p,dp)] = phi_q . (A phi_p)`` (reference
``assemble_global_matrix``, source/LOD.cc:860-973) over basis canvases: each
basis function lives on a fixed-size canvas grid, so the coarse operator is
a batch of static-slice dot products over canvas overlaps — a (P, S, C, C)
stencil, no sparse matrices anywhere.  The stencil matvec drives the coarse
CG and the two-level fine preconditioner.

``StencilOps`` is a mixin consumed by :class:`models.lod.LODSolver`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from dealii_slod_tpu.grid import cartesian_coords, ravel
from dealii_slod_tpu.grid import rev_dims as _rev


class StencilOps:
    """Coarse-operator methods of the LOD solver (mixin)."""

    # ------------------------------------------------------------------
    # Coarse operator in stencil form (reference assemble_global_matrix)
    # ------------------------------------------------------------------

    def assemble_coarse_operator(self):
        """A_LOD[(q,dq),(p,dp)] = phi_q . (A phi_p) as a stencil
        (P, S, C, C) over relative window offsets (replaces the Trilinos
        Tmmult triple product, reference LOD.cc:970-972)."""
        self.A_stencil = jax.jit(self._stencil_build)(self.Phi, self.APhi)
        return self.A_stencil

    def _stencil_build(self, Phi, APhi):
        """Pure function: canvases -> stencil blocks (P, S, C, C).

        The cell-decomposed build with its (E, Kc, K2, C, C) intermediate
        K-chunked to ~1 GB.  (An offset-loop roll build re-gathers ~400 MB
        of canvases per stencil offset at refine-4 3D elasticity; the
        chunked cells build does the same contraction as ~160 GFLOP of
        matmul with no full-size T.)

        When the full (E, K, O C^2) / (E, K2, O C^2) side tables would
        exceed ``cfg.stencil_side_budget_mb`` (refine-5 3D elasticity:
        4.0 + 6.9 GB), the build switches to `_stencil_build_cells_planes`: both
        side tables are built and consumed one z-plane chunk at a time,
        so no full-size table ever materializes."""
        cfg = self.cfg
        K = (2 * cfg.oversampling + 1) ** cfg.dim
        K2 = (2 * cfg.oversampling + 2) ** cfg.dim
        item = 8 if self.dtype == jnp.float64 else 4
        P = self.topo.n_patches
        CC = self.C * self.C
        O = (cfg.n_subdivisions + 1) ** cfg.dim
        side_bytes = P * (K + K2) * O * CC * item
        budget = getattr(cfg, "stencil_side_budget_mb", 2048) * (1 << 20)
        if side_bytes > budget:
            return self._stencil_build_cells_planes(Phi, APhi,
                                                    budget_bytes=budget)
        t_bytes = P * K * K2 * CC * item
        n_chunks = min(K, max(1, -(-t_bytes // (1 << 30))))
        return self._stencil_build_cells(Phi, APhi, n_chunks=int(n_chunks))

    def _cell_tables(self):
        """Static tables for the cell-decomposed stencil build.

        Every global fine node is *owned* by exactly one coarse cell
        (own(g) = clip(g // s, 0, N-1) per axis), so
        ``A_LOD[q,p] = sum_e sum_{g owned by e} phi_q(g) Aphi_p(g)`` —
        a per-cell contraction over window-slot pairs instead of a loop
        over stencil offsets."""
        if hasattr(self, "_cell_tab"):
            return self._cell_tab
        cfg, g = self.cfg, self.grid
        ell, s, N, dim = cfg.oversampling, cfg.n_subdivisions, cfg.n_coarse, cfg.dim
        K = (2 * ell + 1) ** dim
        ks = cartesian_coords(np.full(dim, 2 * ell + 1))        # (K, dim)
        # phi vanishes on (and outside) its window edge, so every node with
        # phi_q != 0 is owned by a cell of q's window: K slots suffice for
        # the phi table.  Aphi is nonzero on the window edge, whose TOP-face
        # nodes are owned by the cell one slot beyond the canvas — the Aphi
        # table therefore uses the extended (2l+2)-slot grid, with the
        # out-of-canvas node layers masked.
        K2 = (2 * ell + 2) ** dim
        ks2 = cartesian_coords(np.full(dim, 2 * ell + 2))       # (K2, dim)
        oo = cartesian_coords(np.full(dim, s + 1))              # (O, dim)
        O = len(oo)
        cells = cartesian_coords(g.cell_dims)                   # (E, dim)

        def patch_table(slots):
            pco = cells[:, None, :] + ell - slots[None, :, :]
            pvalid = ((pco >= 0) & (pco < N)).all(-1)
            p_idx = ravel(np.clip(pco, 0, N - 1), g.cell_dims)
            node_co = slots[:, None, :] * s + oo[None, :, :]    # (Kx, O, dim)
            in_canvas = (node_co <= (2 * ell + 1) * s).all(-1)  # (Kx, O)
            cnode = ravel(np.minimum(node_co, (2 * ell + 1) * s),
                          self.canvas_dims)
            # NOTE: keep NumPy (no jnp.asarray): this cache may be built
            # while tracing, and device constants created inside a trace
            # are tracers that must not leak into later traces
            return (p_idx.astype(np.int32), pvalid,
                    cnode.astype(np.int32), in_canvas)

        p_idx1, pvalid1, cnode1, incv1 = patch_table(ks)
        p_idx2, pvalid2, cnode2, incv2 = patch_table(ks2)
        # cell seen by patch q at slot k1: e = q + ks[k1] - l
        eco = cells[:, None, :] + ks[None, :, :] - ell
        evalid = ((eco >= 0) & (eco < N)).all(-1)
        e_idx = ravel(np.clip(eco, 0, N - 1), g.cell_dims)
        # ownership: offset o belongs to cell e iff o < s per axis, except at
        # the domain top face where the cell also owns its o == s layer
        top = cells == N - 1                                     # (E, dim)
        own = np.logical_or(oo[None, :, :] < s, top[:, None, :]).all(-1)
        own = own[:, None, :]                                    # (E, 1, O)
        # slot (in the extended grid) of the neighbor p = q + delta covering
        # the same cell: e = q + ks[k1] - l = p + ks2[k2] - l => k2 = k1 - d
        k2map = np.full((K, self.n_stencil), -1, dtype=np.int64)
        for k1 in range(K):
            tgt = ks[k1][None, :] - self.stencil_offsets         # (S, dim)
            ok = ((tgt >= 0) & (tgt <= 2 * ell + 1)).all(-1)
            k2map[k1, ok] = ravel(tgt[ok], np.full(dim, 2 * ell + 2))
        self._cell_tab = dict(
            p_idx1=p_idx1, pvalid1=pvalid1, cnode1=cnode1, incv1=incv1,
            p_idx2=p_idx2, pvalid2=pvalid2, cnode2=cnode2, incv2=incv2,
            e_idx=e_idx.astype(np.int32), evalid=evalid,
            own=own, k2map=k2map, K=K, K2=K2, O=O)
        return self._cell_tab

    def _shift_slots(self, X, slot_dims, sign=1, slot_base=None):
        """Slot-indexed lattice shift, realized as ``sum(slot_dims)``
        static pad/slice stacks — no gathers.  ``X``:
        (E, prod(slot_dims), rest...) with x-fastest flat indices.

        sign=+1 (default): out[e, k, :] = X[e + (ell - k), k, :] — aligns
        per-slot canvas picks onto the cell lattice.
        sign=-1: out[q, k, :] = X[q + (k - ell), k, :] — the inverse map,
        i.e. the patch-row read G2[q, k] = T[e(q, k), k] with
        e = q + ks[k] - ell; off-lattice rows come out zero, which equals
        the evalid mask (it replaces a 442 MB row gather at the 3D
        refine-4 shape).
        ``slot_dims``: int (cubic slot grid) or per-spatial-axis extents;
        ``slot_base``: per-axis coordinate of slot (0, ..) when X carries
        a contiguous CHUNK of the slot grid (the plane-chunked build)."""
        cfg = self.cfg
        dim = cfg.dim
        N = cfg.n_coarse
        ell = cfg.oversampling
        if isinstance(slot_dims, (int, np.integer)):
            slot_dims = (int(slot_dims),) * dim
        slot_dims = tuple(int(k) for k in slot_dims)
        rest = X.shape[2:]
        n_slots = X.shape[1]
        if n_slots != int(np.prod(slot_dims)):
            raise ValueError("slot axis does not match the slot grid")
        # flat slot index is x-fastest -> reshape extents slowest-first
        X = X.reshape((N,) * dim + slot_dims[::-1] + rest)
        base = (0,) * dim if slot_base is None else tuple(slot_base)
        for a in range(dim):                 # spatial axis a (x fastest)
            lat_ax = dim - 1 - a
            slot_ax = dim + (dim - 1 - a)
            parts = []
            for kv in range(slot_dims[a]):
                d = sign * (ell - (kv + base[a]))
                Xi = jax.lax.index_in_dim(X, kv, axis=slot_ax, keepdims=True)
                pad = [(0, 0)] * Xi.ndim
                if d >= 0:
                    lo = min(d, N)          # |d| >= N: all off-lattice
                    Xi = jax.lax.slice_in_dim(Xi, lo, N, axis=lat_ax)
                    pad[lat_ax] = (0, lo)
                else:
                    hi = max(N + d, 0)
                    Xi = jax.lax.slice_in_dim(Xi, 0, hi, axis=lat_ax)
                    pad[lat_ax] = (N - hi, 0)
                parts.append(jnp.pad(Xi, pad))
            X = jnp.concatenate(parts, axis=slot_ax)
        return X.reshape((N ** dim, n_slots) + rest)

    def _shift_slots_flat(self, X, slot_dims, sign=1, slot_base=None):
        """`_shift_slots` on the FLAT lattice axis: one major-axis
        slice + pad per slot plus a static validity mask, instead of
        per-axis pad/slice stacks on a (N,..,N, slots.., rest) reshape.

        Algebraically identical: for rows whose shifted coordinate stays
        on the lattice the flat index shifts by ``dot(d, strides)``
        (ravel is linear), and rows that leave the lattice on ANY axis
        are zeroed by the mask — exactly the per-axis clipping.  The
        reshape form makes XLA lay the intermediate out lattice-minor
        (the concats act on lattice axes), which pads the small trailing
        axes where the layout is tiled; this form keeps every tensor (E, slots, rest) with the large fused
        ``rest`` minor."""
        cfg = self.cfg
        dim = cfg.dim
        N = cfg.n_coarse
        ell = cfg.oversampling
        if isinstance(slot_dims, (int, np.integer)):
            slot_dims = (int(slot_dims),) * dim
        slot_dims = tuple(int(k) for k in slot_dims)
        rest = X.shape[2:]
        n_slots = X.shape[1]
        if n_slots != int(np.prod(slot_dims)):
            raise ValueError("slot axis does not match the slot grid")
        E = X.shape[0]
        coords = cartesian_coords(np.asarray(slot_dims))    # (ns, dim)
        base = np.zeros(dim, int) if slot_base is None else \
            np.asarray(slot_base, int)
        cells = cartesian_coords(np.full(dim, N))           # (E, dim)
        strides = N ** np.arange(dim)
        rest_pad = [(0, 0)] * len(rest)
        rest_none = (None,) * len(rest)
        parts = []
        for k in range(n_slots):
            dvec = sign * (ell - (coords[k] + base))
            dflat = int(dvec @ strides)
            Xk = X[:, k]
            if dflat >= 0:
                lo = min(dflat, E)
                Xs = jax.lax.slice_in_dim(Xk, lo, E, axis=0)
                Xs = jnp.pad(Xs, [(0, lo)] + rest_pad)
            else:
                hi = max(E + dflat, 0)
                Xs = jax.lax.slice_in_dim(Xk, 0, hi, axis=0)
                Xs = jnp.pad(Xs, [(E - hi, 0)] + rest_pad)
            valid = ((cells + dvec >= 0) & (cells + dvec < N)).all(-1)
            Xs = Xs * jnp.asarray(valid.astype(np.float32),
                                  X.dtype)[(slice(None),) + rest_none]
            parts.append(Xs)
        return jnp.stack(parts, axis=1)

    def _slot_match_matrix(self):
        """Dense 0/1 matrix M[(k1, k2), j] of the slot-correlation relation
        k2 == k1 - delta_j (flattened over the extended slot grid) — the
        whole correlation then is ONE matmul instead of dim separable
        einsums over tiny (.., 5,5,5, 6,6,6) axes."""
        tab = self._cell_tables()
        K, K2 = tab["K"], tab["K2"]
        M3 = np.zeros((K, K2, self.n_stencil), dtype=np.float32)
        for k1 in range(K):
            for j in range(self.n_stencil):
                m = tab["k2map"][k1, j]
                if m >= 0:
                    M3[k1, m, j] = 1.0
        return M3.reshape(K * K2, self.n_stencil)

    def _stencil_build_cells(self, Phi, APhi, n_chunks: int = 1):
        """Cell-decomposed stencil build, gather-free form:

        1. canvas pick: Y[q, (k, o)] = Phi_q[cnode(k, o)] — one ``take``
           with a shared constant index vector,
        2. lattice alignment: Pc[e, k, o] = Y[e + (ell - k), k, o] — static
           pad/slice stacks per axis (`_shift_slots`, in place of a flat
           gather of ~14M/24M elements),
        3. owned-node contraction T[e, k, m] = sum_{o,c} Pc . Ac,
        4. patch rows G2[q, k1] = T[e(q, k1), k1] (small row gather),
        5. slot correlation as ONE dense indicator matmul with
           `_slot_match_matrix` (in place of dim separable einsums over
           tiny trailing axes).

        With ``n_chunks > 1`` steps 3-5 run per K-slot chunk, accumulating
        A_st directly — neither T nor G2 (each (P, K, K2, C, C): 3.7 GB at
        refine-4 3D elasticity, 3.5 GB at refine-5 diffusion) ever
        materializes, at identical algebra (the K axis is data-parallel
        through steps 3-4 and the indicator matmul is a sum over K)."""
        C = self.C
        P = self.topo.n_patches
        dim = self.cfg.dim
        kappa = 2 * self.cfg.oversampling + 1
        S1 = 2 * self.stencil_R + 1
        tab = self._cell_tables()
        K, K2, O = tab["K"], tab["K2"], tab["O"]

        CC = C * C

        def side_table(X, which, slots_per_axis):
            cn = jnp.asarray(tab[f"cnode{which}"].reshape(-1))
            Y = jnp.take(X, cn, axis=1)                   # (P, Kx*O, C, C)
            incv = jnp.asarray(
                tab[f"incv{which}"].reshape(-1).astype(np.float32),
                X.dtype)
            Y = Y * incv[None, :, None, None]
            Kx = slots_per_axis ** dim
            Y = Y.reshape(P, Kx, O * CC)
            return self._shift_slots(Y, slots_per_axis)   # (E, Kx, O*CC)

        Pc = side_table(Phi.reshape(P, self.canvas_n, C, C), 1, kappa)
        Ac = side_table(APhi.reshape(P, self.canvas_n, C, C), 2, kappa + 1)
        # owned-node mask on one side only (idempotent in the product)
        own = jnp.asarray(tab["own"].astype(np.float32), Phi.dtype)
        Ac = (Ac.reshape(P, K2, O, CC)
              * own[:, :, :, None]).reshape(P, K2, O * CC)
        # contraction over (owned node, dof component): the (o, c) pair is
        # the fused middle axis; d/f are the basis-column blocks
        PcT = Pc.reshape(P, K, O, C, C)
        AcT = Ac.reshape(P, K2, O, C, C)
        # slot correlation as one dense indicator matmul.  Precision HIGH
        # (3 bf16 passes) suffices here: with 0/1 indicator entries the
        # split product (a_hi + a_lo) * b reconstructs a*b to ~2^-18
        # relative (far below the pipeline's f32 method error), while the
        # inherited HIGHEST (6 passes) would double the cost of the
        # largest matmul of the build (~160 GFLOP at the 3D bench config)
        M3 = jnp.asarray(self._slot_match_matrix(), self.dtype)
        e_idx = jnp.asarray(tab["e_idx"])
        evalid = tab["evalid"]
        Kc = -(-K // max(1, n_chunks))
        A_st = jnp.zeros((P, self.n_stencil, CC), self.dtype)
        for k0 in range(0, K, Kc):
            k1 = min(K, k0 + Kc)
            Tk = jnp.einsum("ekocd,emocf->ekmdf",
                            PcT[:, k0:k1], AcT)       # (E, Kc, K2, C, C)
            if n_chunks <= 1:
                # patch-row read as the inverse lattice shift (static
                # pad/slice stacks); off-lattice rows zero == evalid
                G2 = self._shift_slots(
                    Tk.reshape(P, K, K2 * CC), kappa,
                    sign=-1).reshape(P, K, K2, C, C)
            else:
                G2 = Tk[e_idx[:, k0:k1], jnp.arange(k1 - k0)[None, :]]
                G2 = G2 * evalid[:, k0:k1, None, None, None]
            # the flat indicator row index x = (k1, k2) is k-major, so the
            # K chunk is a contiguous row slice of M3
            A_st = A_st + jnp.einsum(
                "pxc,xj->pjc", G2.reshape(P, (k1 - k0) * K2, CC),
                M3[k0 * K2:k1 * K2], precision=jax.lax.Precision.HIGH)
        return A_st.reshape(P, self.n_stencil, C, C)

    def _stencil_build_cells_planes(self, Phi, APhi, budget_bytes: int):
        """Plane-chunked cells build: identical algebra to
        `_stencil_build_cells`, but the (E, K, O C^2) phi-side and
        (E, K2, O C^2) Aphi-side tables are built and consumed one chunk
        of slot z-planes at a time (the slowest slot axis — a contiguous
        row range of the x-fastest flat slot index), accumulating the
        stencil directly.  Peak residency drops from the full side tables
        (4.0 + 6.9 GB at refine-5 3D elasticity) to a few chunk-size
        arrays; the
        extra cost is re-issuing the canvas ``take`` once per
        (m-chunk, k-chunk) pair."""
        cfg = self.cfg
        C = self.C
        CC = C * C
        P = self.topo.n_patches
        dim = cfg.dim
        kappa = 2 * cfg.oversampling + 1
        tab = self._cell_tables()
        K, K2, O = tab["K"], tab["K2"], tab["O"]
        item = 8 if self.dtype == jnp.float64 else 4
        plane1 = kappa ** (dim - 1)
        plane2 = (kappa + 1) ** (dim - 1)

        def planes_within(n_planes, per_plane_bytes):
            cap = max(1, int(budget_bytes // 4 // max(1, per_plane_bytes)))
            return min(n_planes, cap)

        zk = planes_within(kappa, P * plane1 * O * CC * item)
        zm = planes_within(kappa + 1, P * plane2 * O * CC * item)
        # bound the (P, Kc, K2c, C, C) product chunk as well
        while zk * zm > 1 and (P * zk * plane1 * zm * plane2 * CC * item
                               > budget_bytes // 2):
            if zk >= zm and zk > 1:
                zk -= 1
            elif zm > 1:
                zm -= 1
            else:
                break

        # every tensor in this build is rank-3 with a large minor axis
        # (a tiny trailing axis such as 27 or 36 is padded wherever XLA
        # tiles the layout), so the basis-column
        # axes (d, f) are peeled into static Python loops and the
        # component axis c is fused into the gather index itself
        own_oc = np.repeat(tab["own"][:, 0, :], C, axis=1)     # (E, O*C)
        own_oc = jnp.asarray(own_oc.astype(np.float32), Phi.dtype)
        M3 = np.asarray(self._slot_match_matrix()).reshape(
            K, K2, self.n_stencil)
        e_idx = jnp.asarray(tab["e_idx"])
        evalid = tab["evalid"]
        Phi4 = Phi.reshape(P, self.canvas_n, C, C)
        APhi4 = APhi.reshape(P, self.canvas_n, C, C)

        def node_gather(X4, which, spa, z0, z1):
            """One canvas node gather per (side, chunk) — shared by all C
            basis columns (a flat (node, component, column) gather would
            need the canvas reshaped to (P, nodes C^2), and that reshape
            materializes two full-canvas copies, 2 x 1.46 GB at refine-5
            3D elasticity)."""
            pl = spa ** (dim - 1)
            lo, hi = z0 * pl, z1 * pl
            cn = jnp.asarray(tab[f"cnode{which}"][lo:hi].reshape(-1))
            return jnp.take(X4, cn, axis=1), lo, hi   # (P, ns*O, C, C)

        def side_from(Y4, which, spa, z0, z1, col, lo, hi):
            """(P, chunk-slots, O*C) side table for basis column ``col``
            from the shared node gather: the contraction axis (node,
            component) comes out fused — every downstream tensor is
            rank-3 with a large minor axis."""
            Y = Y4[:, :, :, col]                      # (P, ns*O, C)
            incv = jnp.asarray(
                tab[f"incv{which}"][lo:hi].reshape(-1).astype(np.float32),
                Y.dtype)
            Y = Y * incv[None, :, None]
            Y = Y.reshape(P, hi - lo, O * C)
            dims = (spa,) * (dim - 1) + (z1 - z0,)
            base = (0,) * (dim - 1) + (z0,)
            return self._shift_slots_flat(Y, dims, slot_base=base)

        # per-(d, f) accumulators (P, S): stacked/transposed once at the
        # very end (a (P, S, CC) accumulator has a tiny trailing axis)
        A_parts = [jnp.zeros((P, self.n_stencil), self.dtype)
                   for _ in range(CC)]
        for mz0 in range(0, kappa + 1, zm):
            mz1 = min(kappa + 1, mz0 + zm)
            mlo, mhi = mz0 * plane2, mz1 * plane2
            for kz0 in range(0, kappa, zk):
                kz1 = min(kappa, kz0 + zk)
                klo, khi = kz0 * plane1, kz1 * plane1
                kc = khi - klo
                # hard sequencing: without it XLA schedules many chunk
                # pairs' side tables live at once (the pairs only share
                # the accumulation chain)
                seq = jax.lax.optimization_barrier(
                    tuple(A_parts) + (Phi4, APhi4))
                A_parts = list(seq[:CC])
                Phi4, APhi4 = seq[CC], seq[CC + 1]
                M3blk = jnp.asarray(
                    M3[klo:khi, mlo:mhi].reshape(kc * (mhi - mlo),
                                                 self.n_stencil),
                    self.dtype)
                gidx = (e_idx[:, klo:khi],
                        jnp.arange(kc)[None, :])
                ev = evalid[:, klo:khi, None]
                Ac4, alo, ahi = node_gather(APhi4, 2, kappa + 1, mz0, mz1)
                Pc4, plo, phi_ = node_gather(Phi4, 1, kappa, kz0, kz1)
                pc_ds = [side_from(Pc4, 1, kappa, kz0, kz1, d, plo, phi_)
                         for d in range(C)]
                for f in range(C):
                    # sequence the (f, d) sub-chains too: they only share
                    # Ac4/pc_ds, so XLA otherwise schedules several
                    # 0.6 GB Ac_f/G2 temps (refine-5 3D elasticity) live
                    # at once
                    if C > 1:
                        seq = jax.lax.optimization_barrier(
                            tuple(A_parts) + (Ac4,) + tuple(pc_ds))
                        A_parts = list(seq[:CC])
                        Ac4 = seq[CC]
                        pc_ds = list(seq[CC + 1:])
                    Ac_f = side_from(Ac4, 2, kappa + 1, mz0, mz1, f,
                                     alo, ahi)
                    Ac_f = Ac_f * own_oc[:, None, :]
                    for d in range(C):
                        # (P, kc, O C) x (P, mc, O C) -> (P, kc, mc)
                        Tk = jnp.einsum("pko,pmo->pkm", pc_ds[d], Ac_f)
                        # patch-row read G2[q, k] = Tk[e(q, k), k] (row
                        # gather; off-lattice rows masked)
                        G2 = Tk[gidx] * ev
                        A_parts[d * C + f] = A_parts[d * C + f] + jnp.einsum(
                            "px,xj->pj",
                            G2.reshape(P, kc * (mhi - mlo)), M3blk,
                            precision=jax.lax.Precision.HIGH)
        A_st = jnp.stack(A_parts, axis=1)          # (P, CC, S)
        return jnp.swapaxes(A_st, 1, 2).reshape(
            P, self.n_stencil, C, C)

    def _coarse_matvec_with(self, A_st, u: jnp.ndarray) -> jnp.ndarray:
        """Stencil matvec A_LOD u: the neighbor values u[q + delta] are
        built by per-axis pad/slice stacks over the coarse lattice (zero
        off-lattice — the domain-validity mask) and contracted with the
        stencil blocks.  A (2R+1)^dim-tap ``conv_general_dilated_patches``
        has a 3D many-channel lowering that takes minutes of XLA compile
        time, and a (P, S) random gather is gather-bound.  This form is
        3(2R+1) static slices."""
        cfg, C = self.cfg, self.C
        R = self.stencil_R
        dim = cfg.dim
        N = cfg.n_coarse
        S1 = 2 * R + 1
        X = u.reshape(_rev(self.grid.cell_dims) + (C,))       # (z, y, x, C)
        # append neighbor axes slowest-first (j_{dim-1} .. j_0) so the
        # final reshape gives the x-fastest flat stencil index
        for a in range(dim - 1, -1, -1):
            lat_ax = dim - 1 - a
            parts = []
            for jv in range(S1):
                d = jv - R                    # out[e] = in[e + d]
                pad = [(0, 0)] * X.ndim
                if d >= 0:
                    lo = min(d, N)
                    Xi = jax.lax.slice_in_dim(X, lo, N, axis=lat_ax)
                    pad[lat_ax] = (0, lo)
                else:
                    hi = max(N + d, 0)
                    Xi = jax.lax.slice_in_dim(X, 0, hi, axis=lat_ax)
                    pad[lat_ax] = (N - hi, 0)
                parts.append(jnp.pad(Xi, pad)[..., None])
            # new axis inserted after the earlier j axes (slowest-first
            # j order: j_{dim-1}, ..., j_0 -> x-fastest flat index)
            X = jnp.concatenate(parts, axis=-1)
            X = jnp.moveaxis(X, -1, dim + (dim - 1 - a))
        u_nb = X.reshape(self.topo.n_patches, self.n_stencil, C)
        return jnp.einsum("psde,pse->pd", A_st, u_nb)

    def coarse_matvec(self, u: jnp.ndarray) -> jnp.ndarray:
        """u: (P, C) -> A_LOD u (P, C) via stencil gather."""
        return self._coarse_matvec_with(self.A_stencil, u)

    def _dense_placement(self):
        """Constant (S, P + 1) 0/1 placement matrix embedding the coarse
        stencil into the dense lattice matrix (banded-stride trick on the
        coarse lattice, same algebra as ops.assembly.bands_to_dense_mm)."""
        if not hasattr(self, "_dense_P_cache"):
            dims = np.asarray(self.grid.cell_dims, dtype=int)
            strides = np.concatenate([[1], np.cumprod(dims[:-1])]).astype(int)
            s = np.asarray(self.stencil_offsets) @ strides
            shift = int(-s.min())
            nN = self.topo.n_patches
            if 2 * shift + 1 > nN + 1:
                # stencil span exceeds the width-(nN+1) row block (tiny
                # lattices): fall back to a one-time static scatter
                self._dense_P_cache = None
            else:
                Pm = np.zeros((len(s), nN + 1), np.float32)
                Pm[np.arange(len(s)), s + shift] = 1.0
                self._dense_P_cache = (Pm, shift, nN)
        return self._dense_P_cache

    def coarse_dense_matrix(self, A_st) -> jnp.ndarray:
        """Dense (P*C, P*C) coarse operator from the stencil blocks —
        ONE placement matmul + flat slice (in-graph, jit-safe).  Off-lattice
        stencil slots are zeroed by ``stencil_valid`` so banded-stride wraps
        vanish.  Used below the ``coarse_dense_cap``: a dense matvec reads
        ~(P C)^2 floats/iteration with no gather, ~10x cheaper than the
        27-slice neighbor-stack build at the bench config."""
        from dealii_slod_tpu.ops.assembly import bands_to_dense_mm
        P, C = self.topo.n_patches, self.C
        placement = self._dense_placement()
        vals = A_st * self.stencil_valid[:, :, None, None].astype(A_st.dtype)
        if placement is None:
            # static-scatter fallback (collision-free: every valid
            # (row, slot) is a distinct (row, col))
            q, k = np.nonzero(np.asarray(self.stencil_valid))
            p = np.asarray(self.stencil_nbr)[q, k]
            cc = np.arange(C)
            rows = (q[:, None, None] * C + cc[None, :, None]
                    ) * np.ones((1, 1, C), int)
            cols = (p[:, None, None] * C
                    + cc[None, None, :]) * np.ones((1, C, 1), int)
            dense = jnp.zeros((P * C, P * C), A_st.dtype)
            return dense.at[rows.reshape(-1), cols.reshape(-1)].set(
                vals[q, k].reshape(-1))
        return bands_to_dense_mm(vals, *placement)

    def _use_direct_coarse(self) -> bool:
        """cfg.coarse_solve == "direct" applies below ``coarse_dense_cap``
        (the dense factor is one op chain; CG remains the cap-free
        path — and the reference's own solver, source/LOD.cc:976-1002)."""
        n = self.topo.n_patches * self.C
        return (getattr(self.cfg, "coarse_solve", "cg") == "direct"
                and n <= getattr(self.cfg, "coarse_dense_cap", 8192))

    def _coarse_direct_fn(self, A_st):
        """rhs -> A_LOD^-1 rhs by dense Cholesky of the placement-embedded
        coarse matrix.  One factor + two triangular solves replaces the
        coarse CG's ~17 latency-bound iterations at the bench config
        (the 4096^2 f32 factor is ~2e10 flops; the CG's cost is its
        sequential iterations, not flops)."""
        Ad = self.coarse_dense_matrix(A_st)
        L = jnp.linalg.cholesky(Ad)

        def solve(rhs):
            x = jax.scipy.linalg.cho_solve((L, True), rhs.reshape(-1))
            return x.reshape(rhs.shape)

        return solve

    def _coarse_matvec_fn(self, A_st):
        """Matvec closure for the coarse CG: dense-embedded below the cap
        (the dense matrix is built ONCE outside the CG loop), stencil
        slice-stack beyond (scales to any patch count)."""
        n = self.topo.n_patches * self.C
        if n <= getattr(self.cfg, "coarse_dense_cap", 8192):
            Ad = self.coarse_dense_matrix(A_st)
            return lambda u: (Ad @ u.reshape(-1)).reshape(u.shape)
        return lambda u: self._coarse_matvec_with(A_st, u)
