"""Linear solvers: preconditioned CG under ``lax.while_loop`` and batched
dense direct solves.

Replaces:
- ``SolverCG`` + ``PreconditionSSOR/AMG`` (reference source/LOD.cc:992-998,
  :1074-1078) -> :func:`cg` with a Jacobi preconditioner (SSOR/AMG are
  inherently sequential / host-side; Jacobi-CG is data-parallel and solves
  the same SPD systems to the same stopping rule).
- Amesos-KLU multi-RHS sparse direct solve (`Gauss_elimination`,
  include/LODtools.h:511-595) -> :func:`cholesky_solve` — batched dense
  Cholesky on the SPD internal patch submatrix (all right-hand sides at once,
  exactly the multi-RHS blocking the reference emulates with
  Epetra_MultiVector views).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


class CGResult(NamedTuple):
    x: jnp.ndarray
    n_iter: jnp.ndarray
    residual: jnp.ndarray
    initial_residual: jnp.ndarray
    # plain Python bool default: a device-array default here would
    # initialize the JAX backend at import time, defeating programmatic
    # ``jax.config.update("jax_platforms", ...)`` in user scripts.
    converged: bool = True


def cg(matvec: Callable, b: jnp.ndarray, x0: Optional[jnp.ndarray] = None,
       max_steps: int = 1000, tolerance: float = 1e-10, reduce: float = 1e-2,
       precond: Optional[Callable] = None, psum_axis: Optional[str] = None,
       check_every: int = 8) -> CGResult:
    """Preconditioned conjugate gradients with deal.II ``ReductionControl``
    stopping semantics (include/LOD.h:108-109): stop when the residual norm
    falls below ``tolerance`` OR below ``reduce * initial_residual`` OR after
    ``max_steps`` iterations.

    Works on arbitrarily-shaped pytrees-as-arrays; inner products reduce over
    all axes (and over a device-mesh axis via ``psum`` when ``psum_axis`` is
    given, for row-sharded vectors).

    The loop structure runs fixed-size ``check_every`` chunks under one
    ``lax.while_loop`` (a while iteration measures ~10x the cost of the
    same body under ``fori_loop``), but the stopping SEMANTICS are
    exactly per-iteration: every iteration carries a convergence latch, and
    once the residual passes the threshold (or ``max_steps`` is reached)
    the remaining iterations of the chunk are masked no-ops — so the
    returned ``x`` matches a per-iteration stop, ``n_iter`` is the exact
    deal.II iteration count, and ``converged`` is explicit (a solve that
    converges at the last allowed iteration is reported converged)."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if precond is None:
        precond = lambda r: r

    def dot(a, c):
        d = jnp.vdot(a, c)
        if psum_axis is not None:
            d = jax.lax.psum(d, psum_axis)
        return d

    def safe_div(num, den):
        return jnp.where(den != 0, num / jnp.where(den == 0, 1.0, den), 0.0)

    r0 = b - matvec(x0)
    z0 = precond(r0)
    rz0 = dot(r0, z0)
    res0 = jnp.sqrt(dot(r0, r0))
    threshold = jnp.maximum(tolerance, reduce * res0)
    thr2 = threshold * threshold

    def iteration(i, state):
        x, r, z, p, rz, n_it, done = state
        active = (~done) & (n_it < max_steps)
        act = active.astype(b.dtype)
        Ap = matvec(p)
        alpha = safe_div(rz, dot(p, Ap)) * act
        x = x + alpha * p
        r_new = r - alpha * Ap
        z_new = precond(r_new)
        rz_new = dot(r_new, z_new)
        beta = safe_div(rz_new, rz)
        p = jnp.where(active, z_new + beta * p, p)
        r, z = r_new, z_new
        rz = jnp.where(active, rz_new, rz)
        n_it = n_it + active.astype(n_it.dtype)
        done = done | (dot(r, r) <= thr2)
        return (x, r, z, p, rz, n_it, done)

    k = max(1, check_every)
    n_chunks = -(-max_steps // k)

    def cond(state):
        inner, chunks = state
        n_it, done = inner[5], inner[6]
        return (~done) & (n_it < max_steps) & (chunks < n_chunks)

    def body(state):
        inner, chunks = state
        inner = jax.lax.fori_loop(0, k, iteration, inner)
        return (inner, chunks + 1)

    done0 = res0 <= threshold
    state = ((x0, r0, z0, z0, rz0, jnp.zeros((), jnp.int32), done0),
             jnp.zeros((), jnp.int32))
    (x, r, _, _, _, n_iter, done), _ = jax.lax.while_loop(cond, body, state)
    return CGResult(x, n_iter, jnp.sqrt(dot(r, r)), res0, done)


def cholesky_factor(A: jnp.ndarray) -> jnp.ndarray:
    """Batched Cholesky factor of SPD matrices (..., n, n)."""
    return jnp.linalg.cholesky(A)


def cholesky_solve(L: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Solve A X = B given the Cholesky factor L (batched, multi-RHS).

    (..., n, n) x (..., n, k) -> (..., n, k)."""
    Y = solve_triangular(L, B, lower=True)
    return solve_triangular(jnp.swapaxes(L, -1, -2), Y, lower=False)


def spd_solve(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Direct SPD solve (batched, multi-RHS)."""
    return cholesky_solve(cholesky_factor(A), B)


def spd_inverse(A: jnp.ndarray) -> jnp.ndarray:
    """Explicit SPD inverse via Cholesky: A^-1 = L^-T L^-1.

    Replaces the reference's ``gauss_jordan()`` on the coarse triple product
    (source/LOD.cc:553): one Cholesky, one triangular inverse and one
    matmul; T is SPD, so no pivoting is needed."""
    n = A.shape[-1]
    L = cholesky_factor(A)
    eye = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), A.shape)
    Linv = solve_triangular(L, eye, lower=True)
    return jnp.swapaxes(Linv, -1, -2) @ Linv


def dense_dirichlet_solve(A: jnp.ndarray, b: jnp.ndarray,
                          constrained: jnp.ndarray,
                          values: jnp.ndarray) -> jnp.ndarray:
    """Solve a dense system with Dirichlet constraints by row/col projection:
    rows/cols of constrained dofs replaced by identity, rhs lifted.  Used for
    the small coarse-FEM comparison solve (reference SolverDirect at
    source/LOD.cc:1191-1195)."""
    mask = constrained.astype(A.dtype)
    n = A.shape[-1]
    eye = jnp.eye(n, dtype=A.dtype)
    P = (1.0 - mask)[:, None] * (1.0 - mask)[None, :]
    A_bc = A * P + eye * mask[:, None]
    # lift inhomogeneous values: b_int -= A[:, c] * g_c
    b_bc = (1.0 - mask) * (b - (A * mask[None, :]) @ values) + mask * values
    # SPD after projection
    x = jnp.linalg.solve(A_bc, b_bc)
    return x
