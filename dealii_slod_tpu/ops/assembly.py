"""Batched FE assembly as tensor contractions + static scatters.

Replaces the reference's FEValues subcell-loop assembly
(include/Diffusion.h:111-207, include/Elasticity.h:163-299) and its
Trilinos sparse-matrix storage with:

- per-subcell element matrices by contraction of constant reference tensors
  with per-quadrature-point coefficients (`make_subcell_matrices`),
- dense per-patch stiffness via a single static scatter-add
  (`assemble_dense_batch`),
- a matrix-free global fine-grid operator (`FineOperator`) used for the
  reference fine FEM solve (source/LOD.cc:1004-1094) — no sparse matrix is
  ever formed; the matvec is gather -> contract -> scatter-add (batched
  small matmuls, no dynamic shapes).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from dealii_slod_tpu.grid import cartesian_coords
from dealii_slod_tpu.ops.element import ElementTensors


def make_subcell_matrices(et: ElementTensors, coefs: Dict[str, jnp.ndarray]
                          ) -> jnp.ndarray:
    """Per-subcell element stiffness matrices.

    ``coefs`` maps coefficient names to arrays of shape (..., n_sub, nq):
      - {"alpha"}           -> scalar diffusion  (Diffusion.h:181-186)
      - {"alpha", "creact"} -> reaction-diffusion (adds the creact-weighted
                               mass term; beyond the reference's physics set)
      - {"mu", "lam"}       -> linear elasticity (Elasticity.h:246-258)

    Returns (..., n_sub, mD, mD) with local dof = node * n_components + comp.
    """
    if "alpha" in coefs:
        K = jnp.asarray(et.K_grad, dtype=coefs["alpha"].dtype)
        out = jnp.einsum("...sq,qij->...sij", coefs["alpha"], K)
        if "creact" in coefs:
            M = jnp.asarray(et.M, dtype=out.dtype)
            out = out + jnp.einsum("...sq,qij->...sij", coefs["creact"], M)
        return out
    K_mu = jnp.asarray(et.K_mu, dtype=coefs["mu"].dtype)
    K_lam = jnp.asarray(et.K_lam, dtype=coefs["lam"].dtype)
    return (jnp.einsum("...sq,qIJ->...sIJ", coefs["mu"], K_mu)
            + jnp.einsum("...sq,qIJ->...sIJ", coefs["lam"], K_lam))


def assemble_dense(Ksub: jnp.ndarray, flat_idx: jnp.ndarray, n_dofs: int
                   ) -> jnp.ndarray:
    """Scatter per-subcell matrices (n_sub, mD, mD) into a dense
    (n_dofs, n_dofs) patch stiffness.  ``flat_idx`` are the precomputed
    static flattened (row * n_dofs + col) indices (grid.ShapeClass).

    Equivalent to AffineConstraints::distribute_local_to_global with empty
    constraints (reference LOD.cc:440-444: the patch stiffness is assembled
    *unconstrained*)."""
    A = jnp.zeros(n_dofs * n_dofs, dtype=Ksub.dtype)
    A = A.at[flat_idx].add(Ksub.reshape(-1))
    return A.reshape(n_dofs, n_dofs)


def assemble_dense_batch(Ksub: jnp.ndarray, flat_idx, n_dofs: int) -> jnp.ndarray:
    """Batched version: (B, n_sub, mD, mD) -> (B, n_dofs, n_dofs)."""
    flat_idx = jnp.asarray(flat_idx)
    return jax.vmap(lambda k: assemble_dense(k, flat_idx, n_dofs))(Ksub)


# ---------------------------------------------------------------------------
# Band-form assembly: windowed contraction + strided densification
# ---------------------------------------------------------------------------
#
# The scatter-add assembly above writes n_sub * (2^dim C)^2 addends with ~m
# duplicates per target — a serialized scatter.  On the uniform
# subcell grid the stiffness is a 3^dim-point nodal stencil, so it can be
# built without any scatter:
#
#   band[i, o] = sum_{r, q} alpha[subcell(i, r), q] * T[r, q, o]
#
# with r the 2^dim subcells adjacent to node i (zero-padded off the grid) and
# T a constant tensor read off the reference element matrix.  The dense
# matrix then falls out of the classic banded-stride embedding: entry
# (i, i + delta) sits at flat position i*(nN+1) + delta of an (nN+1, nN+1)
# buffer, so placing band column o at static column delta_o and reslicing
# with stride nN reproduces the dense matrix — pure pads/reshapes, no
# scatter, no duplicates.


def make_band_tensors(et: ElementTensors) -> Dict[str, np.ndarray]:
    """Constant nodal-stencil tensors per coefficient name.

    Returns name -> T of shape (2^dim, nq, 3^dim, C, C):
    T[r, q, o] = K[q, a(r), b(r, o)] where a(r) is the local corner of the
    node in relative subcell r and b = a + delta_o (zero when b leaves the
    subcell)."""
    dim, C = et.dim, et.n_components
    m = 2 ** dim
    nq = m
    rs = cartesian_coords(np.full(dim, 2))            # (m, dim)
    offs = cartesian_coords(np.full(dim, 3)) - 1      # (3^dim, dim)
    pow2 = 2 ** np.arange(dim)

    def band_of(K):
        K5 = K.reshape(nq, m, C, m, C)
        T = np.zeros((m, nq, len(offs), C, C))
        for ri, r in enumerate(rs):
            a_vec = 1 - r
            a = int(a_vec @ pow2)
            for oi, o in enumerate(offs):
                b_vec = a_vec + o
                if ((b_vec >= 0) & (b_vec <= 1)).all():
                    b = int(b_vec @ pow2)
                    T[ri, :, oi] = K5[:, a, :, b, :]
        return T

    out = {}
    if C == 1:
        out["alpha"] = band_of(et.K_grad)
        out["creact"] = band_of(et.M)      # consumed only when the problem
        # supplies a "creact" coefficient (assemble_bands iterates coefs)
    else:
        out["mu"] = band_of(et.K_mu)
        out["lam"] = band_of(et.K_lam)
    return out


def node_subcell_windows(coef: jnp.ndarray, sub_dims) -> jnp.ndarray:
    """Subcell coefficient windows around each node.

    ``coef``: (n_sub, nq) subcell quadrature values on a grid with
    ``sub_dims`` subcells per axis (x-fastest ravel).  Returns
    (n_nodes, 2^dim, nq) — the values of the 2^dim subcells adjacent to
    each node (r ordered x-fastest, zero off the grid)."""
    dim = len(sub_dims)
    grid_rev = tuple(int(d) for d in np.asarray(sub_dims)[::-1])
    nq = coef.shape[-1]
    cg = jnp.moveaxis(coef.reshape(grid_rev + (nq,)), -1, 0)[None]
    pat = jax.lax.conv_general_dilated_patches(
        cg, filter_shape=(2,) * dim, window_strides=(1,) * dim,
        padding=[(1, 1)] * dim)                       # (1, nq*2^dim, nodes..)
    m = 2 ** dim
    pat = pat.reshape(nq, m, -1)                      # (nq, r, n_nodes)
    return jnp.transpose(pat, (2, 1, 0))              # (n_nodes, r, nq)


def assemble_bands(coefs: Dict[str, jnp.ndarray], band_tensors,
                   sub_dims) -> jnp.ndarray:
    """Nodal-stencil stiffness bands (n_nodes, 3^dim, C, C) from subcell
    quadrature coefficients (n_sub, nq) per name."""
    out = None
    for name, coef in coefs.items():
        W = node_subcell_windows(coef, sub_dims)      # (n, r, q)
        T = jnp.asarray(band_tensors[name], W.dtype)
        term = jnp.einsum("nrq,rqocd->nocd", W, T)
        out = term if out is None else out + term
    return out


def bands_to_dense(band: jnp.ndarray, node_dims) -> jnp.ndarray:
    """(n_nodes, 3^dim, C, C) bands -> dense (n_nodes*C, n_nodes*C) via the
    banded-stride embedding, realized entirely with pads + reshapes.

    Row i's stencil entry for flat offset delta sits at dense flat position
    i*nN + (i + delta) = i*(nN+1) + delta, so a row-major (nN, nN+1) buffer
    whose columns hold the offsets (shifted by ``shift`` = sum of strides so
    they are nonnegative) reproduces the dense matrix after one flat slice.
    The offset axis is expanded 3 -> node stride per spatial axis by *right
    padding + merge* (a dilation), never a scatter; wrap positions are
    provably zero because the clipped subcell windows zero them."""
    nN, O, C, _ = band.shape
    dims = np.asarray(node_dims)
    dim = len(dims)
    strides = np.concatenate([[1], np.cumprod(dims[:-1])]).astype(int)
    shift = int(strides.sum())

    # offset axes slowest..fastest (x last), matching the x-fastest column
    # ravel of cartesian_coords
    x = band.reshape((nN,) + (3,) * dim + (C, C))
    flat_len = 3
    for k in range(dim - 1):
        # pad the merged fast block to the next stride, absorb next axis
        cfg_pad = [(0, 0)] * x.ndim
        cfg_pad[dim - k] = (0, int(strides[k + 1]) - flat_len)
        x = jnp.pad(x, cfg_pad)
        flat_len = int(strides[k + 1]) * 3
        new_shape = x.shape[:dim - k - 1] + (flat_len,) + x.shape[dim - k + 1:]
        x = x.reshape(new_shape)
    # x: (nN, F, C, C) with F = 3 * strides[-1]; columns c = delta + shift
    pad_cols = nN + 1 - flat_len
    x = jnp.pad(x, [(0, 0), (0, pad_cols), (0, 0), (0, 0)])
    F = x.reshape((nN * (nN + 1),) + (C, C))
    F = F[shift:shift + nN * nN].reshape(nN, nN, C, C)
    if C == 1:
        return F[:, :, 0, 0]
    return jnp.moveaxis(F, 2, 1).reshape(nN * C, nN * C)


def assemble_dense_banded(coefs: Dict[str, jnp.ndarray], band_tensors,
                          sub_dims, node_dims) -> jnp.ndarray:
    """Scatter-free dense patch stiffness from subcell coefficients."""
    band = assemble_bands(coefs, band_tensors, sub_dims)
    return bands_to_dense(band, node_dims)


def band_placement_matrix(node_dims) -> tuple:
    """Constant (3^dim, nN + 1) 0/1 placement matrix for the banded-stride
    embedding: column block ``shift + s_o`` of a width-(nN+1) row buffer is
    offset o (s_o = delta_o . strides, shift = sum strides).  Returns
    (P, shift, nN)."""
    dims = np.asarray(node_dims, dtype=int)
    strides = np.concatenate([[1], np.cumprod(dims[:-1])]).astype(int)
    offs = cartesian_coords(np.full(len(dims), 3)) - 1
    s = offs @ strides
    shift = int(strides.sum())
    nN = int(dims.prod())
    P = np.zeros((len(offs), nN + 1), np.float32)
    P[np.arange(len(offs)), s + shift] = 1.0
    return P, shift, nN


def bands_to_dense_mm(band: jnp.ndarray, P, shift: int, nN: int
                      ) -> jnp.ndarray:
    """`bands_to_dense` as ONE placement matmul + one flat slice.

    The pad-merge cascade of `bands_to_dense` materializes the growing
    buffer once per spatial axis (strided pads); here row i's
    width-(nN+1) block is band[i] @ P (a matmul on a constant 0/1
    matrix) and the dense matrix is a single contiguous flat slice of the
    (nN, nN+1) result.  ``P, shift, nN`` from `band_placement_matrix`."""
    _, O, C, _ = band.shape
    # HIGHEST: the placement matmul is pure data movement (P is 0/1) and
    # must not round the band values through reduced-precision inputs
    hi = jax.lax.Precision.HIGHEST
    if C == 1:
        Pj = jnp.asarray(P, band.dtype)
        B = jnp.einsum("no,ow->nw", band[:, :, 0, 0], Pj,
                       precision=hi)                  # (nN, nN+1)
        return B.reshape(-1)[shift:shift + nN * nN].reshape(nN, nN)
    # C > 1: the SAME banded-stride trick on the component-interleaved
    # matrix.  Row group i (its C dense rows) is one width-C*(W+1) buffer
    # row: entry ((i, c), (i + delta_o, d)) sits at dense flat position
    # i*C*(W+1) + c*W + delta_o*C + d, so placing (o, c, d) at buffer
    # column c*W + (s_o + shift)*C + d and flat-slicing [shift*C :] IS
    # the dense matrix, with no (nN, C, nN, C) transpose whose tiny
    # minor axis C would be padded wherever XLA tiles the layout.
    # Wrap-around placements carry zero band values
    # (off-grid neighbors), exactly as in the C = 1 path.
    W = nN * C
    Pn = np.asarray(P)
    cols = np.argmax(Pn, axis=1)                      # s_o + shift per o
    P2 = np.zeros((O * C * C, C * (W + 1)), np.float32)
    for o in range(O):
        if Pn[o].max() == 0:                          # unused offset row
            continue
        for c in range(C):
            for d in range(C):
                P2[(o * C + c) * C + d, c * W + int(cols[o]) * C + d] = 1.0
    B = jnp.einsum("nx,xw->nw", band.reshape(-1, O * C * C),
                   jnp.asarray(P2, band.dtype), precision=hi)
    flat = B.reshape(-1)[shift * C:shift * C + nN * C * W]
    return flat.reshape(nN * C, W)


# ---------------------------------------------------------------------------
# Matrix-free global fine operator
# ---------------------------------------------------------------------------

class FineOperator:
    """Matrix-free global Q_iso_Q1 stiffness operator on the fine grid.

    Stores only the coefficient values at quadrature points
    (n_fine_cells, nq) per coefficient and the global subcell->node
    connectivity (n_fine_cells, m).  The matvec is:

        u -> scatter_add(conn, Ksub(coef) @ gather(conn, u))

    with Dirichlet rows/columns handled by projection (zero boundary values
    in, zero boundary rows out) — equivalent to the reference's
    AffineConstraints elimination for homogeneous/inhomogeneous boundary
    data (source/LOD.cc:1017-1021, :1057)."""

    def __init__(self, grid, et: ElementTensors, conn: np.ndarray,
                 coefs: Dict[str, jnp.ndarray],
                 dirichlet_mask: Optional[jnp.ndarray] = None):
        self.grid = grid
        self.et = et
        self.conn = jnp.asarray(conn)                  # (n_fine_cells, m)
        self.coefs = {k: jnp.asarray(v) for k, v in coefs.items()}
        self.n_nodes = grid.n_nodes
        self.C = grid.n_components
        # dirichlet_mask: (n_nodes,) bool, True on constrained (boundary) nodes
        self.dirichlet_mask = dirichlet_mask

        cdtype = next(iter(self.coefs.values())).dtype
        if "alpha" in self.coefs:
            self._K = jnp.asarray(et.K_grad, dtype=cdtype)   # (nq, m, m)
            self._M = (jnp.asarray(et.M, dtype=cdtype)
                       if "creact" in self.coefs else None)
            self._mode = "scalar"
        else:
            self._Kmu = jnp.asarray(et.K_mu, dtype=cdtype)   # (nq, mD, mD)
            self._Klam = jnp.asarray(et.K_lam, dtype=cdtype)
            self._mode = "elastic"

    def _apply_raw(self, u: jnp.ndarray) -> jnp.ndarray:
        """Unconstrained matvec, u: (n_nodes, C) -> (n_nodes, C)."""
        C = self.C
        ue = u[self.conn]                              # (n_sub, m, C)
        if self._mode == "scalar":
            # out_e[s, i] = sum_q alpha[s,q] K[q,i,j] ue[s,j]
            out_s = jnp.einsum("sq,qij,sj->si", self.coefs["alpha"],
                               self._K, ue[..., 0])
            if self._M is not None:
                out_s = out_s + jnp.einsum("sq,qij,sj->si",
                                           self.coefs["creact"], self._M,
                                           ue[..., 0])
            out_e = out_s[..., None]
        else:
            m = ue.shape[1]
            uflat = ue.reshape(ue.shape[0], m * C)
            out_flat = (jnp.einsum("sq,qIJ,sJ->sI", self.coefs["mu"],
                                   self._Kmu, uflat)
                        + jnp.einsum("sq,qIJ,sJ->sI", self.coefs["lam"],
                                     self._Klam, uflat))
            out_e = out_flat.reshape(ue.shape)
        out = jnp.zeros_like(u)
        out = out.at[self.conn].add(out_e)
        return out

    def __call__(self, u: jnp.ndarray) -> jnp.ndarray:
        """Constrained matvec: implicitly solves on interior dofs with
        identity rows on Dirichlet dofs."""
        if self.dirichlet_mask is None:
            return self._apply_raw(u)
        mask = self.dirichlet_mask[:, None]
        ui = jnp.where(mask, 0.0, u)
        out = self._apply_raw(ui)
        return jnp.where(mask, u, out)

    def diagonal(self) -> jnp.ndarray:
        """Assembled matrix diagonal (n_nodes, C) — Jacobi preconditioner."""
        C = self.C
        if self._mode == "scalar":
            dloc = jnp.einsum("sq,qii->si", self.coefs["alpha"], self._K)
            if self._M is not None:
                dloc = dloc + jnp.einsum("sq,qii->si", self.coefs["creact"],
                                         self._M)
            dloc = dloc[..., None]                     # (n_sub, m, 1)
        else:
            dflat = (jnp.einsum("sq,qII->sI", self.coefs["mu"], self._Kmu)
                     + jnp.einsum("sq,qII->sI", self.coefs["lam"], self._Klam))
            dflat = dflat.reshape(dflat.shape[0], -1, C)
        d = jnp.zeros((self.n_nodes, C), dtype=dloc.dtype if self._mode == "scalar"
                      else dflat.dtype)
        d = d.at[self.conn].add(dloc if self._mode == "scalar" else dflat)
        if self.dirichlet_mask is not None:
            d = jnp.where(self.dirichlet_mask[:, None], 1.0, d)
        return d


def assemble_load_vector(et: ElementTensors, conn: jnp.ndarray,
                         f_q: jnp.ndarray, n_nodes: int) -> jnp.ndarray:
    """Global load vector: rhs[i, c] = ∫ φ_i^c f_c.

    ``f_q``: (n_fine_cells, nq, C) right-hand-side values at quadrature
    points.  Matches the reference's cell_rhs accumulation
    (Diffusion.h:188-191 / Elasticity.h:273-282)."""
    R = jnp.asarray(et.R, dtype=f_q.dtype)             # (nq, m)
    rhs_e = jnp.einsum("qi,sqc->sic", R, f_q)          # (n_sub, m, C)
    rhs = jnp.zeros((n_nodes, f_q.shape[-1]), dtype=rhs_e.dtype)
    return rhs.at[jnp.asarray(conn)].add(rhs_e)
