"""Closed-form Q1 reference-element tensors (dim-generic).

The reference assembles the FE_Q_iso_Q1 stiffness with explicit subcell loops
over 2x2 Gauss points and 2^dim x 2^dim nodal couplings (reference
include/Diffusion.h:111-207 scalar, include/Elasticity.h:163-299 vector; the
loop structure is validated in tests/fe_q_iso_q1_01.cc / fe_q_iso_q1_02.cc).
Here the same computation is a contraction of constant per-quadrature-point
reference tensors with per-subcell coefficient values:

    A_sub[p, c] = sum_q  alpha[p, c, q] * K_grad[q]          (diffusion)
    A_sub[p, c] = sum_q  mu[p,c,q] * K_mu[q] + lam[p,c,q] * K_lam[q]  (elasticity)

All tensors below are exact closed forms for the multilinear (Q1) element on a
cubic subcell of side h, evaluated at the tensor-product 2-point Gauss rule
(QIterated<dim>(QGauss<1>(2), s) in the reference, source/LOD.cc:91-92).

Local node / quadrature ordering: lexicographic with axis 0 fastest, i.e.
node i has corner bits (i & 1, (i >> 1) & 1, ...) — matching
grid.ShapeClass.conn.  Local *dof* ordering interleaves components:
dof = node * n_components + component.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dealii_slod_tpu.grid import cartesian_coords


def _gauss2_unit():
    """2-point Gauss rule on [0,1]: points and weights."""
    p = np.array([0.5 - 0.5 / np.sqrt(3.0), 0.5 + 0.5 / np.sqrt(3.0)])
    w = np.array([0.5, 0.5])
    return p, w


def shape_values_1d(t: np.ndarray) -> np.ndarray:
    """[l0(t), l1(t)] = [1-t, t] stacked on the last axis."""
    t = np.asarray(t)
    return np.stack([1.0 - t, t], axis=-1)


@dataclasses.dataclass(frozen=True)
class ElementTensors:
    """Per-quadrature-point reference tensors for one cubic Q1 subcell.

    Shapes (m = 2^dim nodes, nq = 2^dim quadrature points, D = n_components):
      V      (nq, m)           shape values
      G      (nq, m, dim)      physical gradients (already / h)
      w      (nq,)             JxW = (h/2)^dim
      K_grad (nq, m, m)        grad.grad * JxW          (scalar diffusion)
      R      (nq, m)           V * JxW                  (rhs / load)
      M      (nq, m, m)        V V * JxW                (mass)
      K_mu   (nq, m*D, m*D)    2 eps:eps * JxW / mu     (elasticity, D=dim)
      K_lam  (nq, m*D, m*D)    div*div * JxW / lambda
      points (nq, dim)         quadrature points in subcell-local coords / h
    """

    dim: int
    h: float
    n_components: int = 1

    def __post_init__(self):
        dim, h, D = self.dim, self.h, self.n_components
        m = 2 ** dim
        gp, gw = _gauss2_unit()
        qbits = cartesian_coords(np.full(dim, 2))      # (nq, dim), axis0 fastest
        nbits = cartesian_coords(np.full(dim, 2))      # (m, dim)
        nq = len(qbits)

        pts = gp[qbits]                                 # (nq, dim) in [0,1]
        # 1D values/derivs at each qpoint coordinate
        vals = shape_values_1d(pts)                     # (nq, dim, 2)
        dl = np.array([-1.0, 1.0])

        V = np.ones((nq, m))
        G = np.zeros((nq, m, dim))
        for q in range(nq):
            for i in range(m):
                prod = 1.0
                for k in range(dim):
                    prod *= vals[q, k, nbits[i, k]]
                V[q, i] = prod
                for k in range(dim):
                    gk = dl[nbits[i, k]]
                    for k2 in range(dim):
                        if k2 != k:
                            gk *= vals[q, k2, nbits[i, k2]]
                    G[q, i, k] = gk / h                  # physical gradient

        w = np.full(nq, (h / 2.0) ** dim)                # JxW per qpoint

        object.__setattr__(self, "points_unit", pts)
        object.__setattr__(self, "V", V)
        object.__setattr__(self, "G", G)
        object.__setattr__(self, "w", w)
        object.__setattr__(self, "K_grad",
                           np.einsum("qik,qjk,q->qij", G, G, w))
        object.__setattr__(self, "R", V * w[:, None])
        object.__setattr__(self, "M", np.einsum("qi,qj,q->qij", V, V, w))

        if D > 1:
            assert D == dim, "elasticity requires n_components == dim"
            # vector-valued tensors; local dof I = i*D + di
            delta = np.eye(D)
            gg = np.einsum("qik,qjk->qij", G, G)          # grad_i . grad_j
            # 2 mu eps(phi_i e_di) : eps(phi_j e_dj)
            #   = mu * (dN_i/dx_dj * dN_j/dx_di + delta_{di,dj} grad.grad)
            K_mu = (np.einsum("qib,qja->qiajb", G, G)
                    + np.einsum("qij,ab->qiajb", gg, delta))
            # lambda div div = lambda dN_i/dx_di dN_j/dx_dj
            K_lam = np.einsum("qia,qjb->qiajb", G, G)
            K_mu = np.einsum("qiajb,q->qiajb", K_mu, w).reshape(nq, m * D, m * D)
            K_lam = np.einsum("qiajb,q->qiajb", K_lam, w).reshape(nq, m * D, m * D)
            object.__setattr__(self, "K_mu", K_mu)
            object.__setattr__(self, "K_lam", K_lam)
            # vector rhs: Rv[(q, i*D+d), d] nonzero only for matching component
            Rv = np.einsum("qi,de->qide", self.R, delta).reshape(nq, m * D, D)
            object.__setattr__(self, "R_vec", Rv)

    # ------------------------------------------------------------------
    def quad_points_in_subcell(self) -> np.ndarray:
        """Quadrature point offsets within a subcell, physical units (nq, dim)."""
        return self.points_unit * self.h


def quad_points_global(grid) -> np.ndarray:
    """Physical coordinates of all quadrature points of all global fine
    subcells: (n_fine_cells, nq, dim).  Used to sample coefficient fields and
    the right-hand side exactly as the reference's FEValues quadrature loop
    does (include/Diffusion.h:151-154)."""
    et = ElementTensors(grid.dim, grid.h, 1)
    sub = cartesian_coords(grid.fine_cell_dims).astype(np.float64) * grid.h
    return sub[:, None, :] + et.quad_points_in_subcell()[None, :, :]
