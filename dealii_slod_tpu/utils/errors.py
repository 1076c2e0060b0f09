"""Error norms by fine-grid quadrature + convergence tables.

Replaces deal.II ``VectorTools::integrate_difference`` /
``ParsedConvergenceTable`` (reference include/LOD.h:111-115, printed at
source/LOD.cc:1442-1466): L2, H1-seminorm and Linfty of the difference
between a fine nodal field and either an exact (parsed) function or another
nodal field, integrated with the same tensor-product Gauss rule used for
assembly."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from dealii_slod_tpu.config import ParsedFunction
from dealii_slod_tpu.ops.element import ElementTensors


def _fd_gradient(fn: ParsedFunction, points: np.ndarray,
                 eps: float = 1e-6) -> np.ndarray:
    """(..., dim) -> (..., C, dim) central finite-difference gradient of a
    parsed function (Functions::ParsedFunction in deal.II likewise has no
    analytic gradient)."""
    dim = points.shape[-1]
    grads = []
    for k in range(dim):
        dp = np.zeros(dim)
        dp[k] = eps
        grads.append((fn(points + dp) - fn(points - dp)) / (2 * eps))
    return np.stack(grads, axis=-1)


def fe_values_at_quadrature(et: ElementTensors, conn: np.ndarray,
                            u: np.ndarray):
    """Nodal field -> (values, gradients) at all quadrature points.

    u: (n_nodes, C) -> values (n_sub, nq, C), grads (n_sub, nq, C, dim)."""
    ue = np.asarray(u)[conn]                       # (n_sub, m, C)
    vals = np.einsum("qi,sic->sqc", et.V, ue)
    grads = np.einsum("qik,sic->sqck", et.G, ue)
    return vals, grads


def _device_norms(et: ElementTensors, conn: np.ndarray, u, other):
    """Per-cell quadrature sums of the three norms on the accelerator
    (nodal-vs-nodal case).

    The full fine-grid quadrature tensors (n_sub, nq, C, dim) at 3D
    refine>=5 are multi-GB host allocations in the NumPy path; here the
    difference field, the gather and the einsums run jitted on-device and
    only the (n_sub,) per-cell partial sums come back, to be accumulated
    in float64 on the host (device dtype may be float32)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def cell_sums(u, other):
        de = (u - other)[jnp.asarray(conn)]            # (n_sub, m, C)
        ev = jnp.einsum("qi,sic->sqc", jnp.asarray(et.V), de)
        eg = jnp.einsum("qik,sic->sqck", jnp.asarray(et.G), de)
        w = jnp.asarray(et.w)
        return (jnp.einsum("q,sqc->s", w, ev ** 2),
                jnp.einsum("q,sqck->s", w, eg ** 2),
                jnp.max(jnp.abs(ev)))
    l2c, h1c, linf = cell_sums(u, other)
    l2 = float(np.sqrt(np.asarray(l2c, np.float64).sum()))
    h1s = float(np.sqrt(np.asarray(h1c, np.float64).sum()))
    return l2, h1s, float(linf)


def error_norms(grid, et: ElementTensors, conn: np.ndarray, u: np.ndarray,
                exact: Optional[ParsedFunction] = None,
                other: Optional[np.ndarray] = None,
                qpts: Optional[np.ndarray] = None) -> Dict[str, float]:
    """L2 / H1-semi / Linfty norms of (u - exact) or (u - other)."""
    if other is not None:
        import jax

        if (isinstance(u, jax.Array)
                and jax.default_backend() != "cpu"):
            # nodal-vs-nodal on an accelerator: keep the quadrature
            # tensors on device (multi-GB on the host at 3D refine>=5)
            l2, h1s, linf = _device_norms(et, conn, u, jax.numpy.asarray(
                other, u.dtype))
            h1 = float(np.sqrt(l2 * l2 + h1s * h1s))
            return {"L2": l2, "H1": h1, "H1_semi": h1s, "Linfty": linf}
    vals, grads = fe_values_at_quadrature(et, conn, u)
    if other is not None:
        ovals, ograds = fe_values_at_quadrature(et, conn, other)
    else:
        assert exact is not None and qpts is not None
        ovals = exact(qpts)
        ograds = _fd_gradient(exact, qpts)
    ev = vals - ovals
    eg = grads - ograds
    w = et.w                                       # (nq,)
    l2 = float(np.sqrt(np.einsum("q,sqc->", w, ev ** 2)))
    h1s = float(np.sqrt(np.einsum("q,sqck->", w, eg ** 2)))
    linf = float(np.abs(ev).max())
    # deal.II's H1_norm includes the L2 part (VectorTools::H1_norm =
    # sqrt(L2^2 + H1_seminorm^2)); report both so the tables are
    # side-by-side comparable with the reference
    h1 = float(np.sqrt(l2 * l2 + h1s * h1s))
    return {"L2": l2, "H1": h1, "H1_semi": h1s, "Linfty": linf}


class ConvergenceTable:
    """Accumulates (cells, dofs, norms) rows and prints an aligned table,
    in the spirit of the reference's ParsedConvergenceTable output
    (include/LOD.h:111-115).  With two or more rows and a known ``dim``,
    each norm column gains a rate column: the observed convergence order
    ``log(e_prev/e_cur) / log(h_prev/h_cur)`` with ``h ~ cells^(-1/dim)``
    (deal.II ParsedConvergenceTable's evaluate_convergence_rates)."""

    def __init__(self, label: str, dim: int | None = None):
        self.label = label
        self.dim = dim
        self.rows = []

    def add_row(self, cells: int, dofs: int, norms: Dict[str, float]):
        self.rows.append((cells, dofs, dict(norms)))

    def rates(self) -> list:
        """Per-row dict of observed orders (first row: None entries)."""
        import math
        out = [{k: None for k in self.rows[0][2]}] if self.rows else []
        for (c0, _, n0), (c1, _, n1) in zip(self.rows, self.rows[1:]):
            d = self.dim or 1
            ratio = (c1 / c0) ** (1.0 / d)          # h0/h1
            row = {}
            for k in n1:
                e0, e1 = n0.get(k), n1[k]
                row[k] = (math.log(e0 / e1) / math.log(ratio)
                          if e0 and e1 and e0 > 0 and e1 > 0 and ratio != 1
                          else None)
            out.append(row)
        return out

    def __str__(self) -> str:
        if not self.rows:
            return f"[{self.label}] (empty)"
        keys = list(self.rows[0][2].keys())
        with_rates = len(self.rows) > 1 and self.dim is not None
        head = f"{'cells':>8} {'dofs':>10} " + " ".join(
            f"{self.label}_{k:>10}" + (f" {'rate':>6}" if with_rates else "")
            for k in keys)
        lines = [head]
        rates = self.rates() if with_rates else None
        for i, (cells, dofs, norms) in enumerate(self.rows):
            cols = []
            for k in keys:
                cols.append(f"{norms[k]:>{11 + len(self.label)}.6e}")
                if with_rates:
                    r = rates[i][k]
                    cols.append(f"{r:>6.2f}" if r is not None else f"{'-':>6}")
            lines.append(f"{cells:>8} {dofs:>10} " + " ".join(cols))
        return "\n".join(lines)
