"""Sample-axis data parallelism: Monte-Carlo / parameter sweeps over
coefficient fields, sharded over the device mesh.

A second scaling axis the reference's MPI design has no counterpart for:
its parallelism partitions *patches of one problem* across ranks
(source/LOD.cc:116-118); re-running for a new coefficient field re-enters
the whole per-patch meshing/assembly/factorization pipeline.  Here the
end-to-end SLOD step is one pure jitted function of the coefficient
arrays (``LODSolver.build_step``), so a batch of S fields is just a new
leading axis: ``vmap`` the step over it and shard THAT axis over the mesh
— each device runs the full pipeline on its own fields, with zero
communication (embarrassingly parallel).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def sweep_step(solver, mesh: Mesh = None, axis: str = "patches"):
    """Return a jitted ``step(coefs_stacked, fem_rhs) -> (u (S, P, C),
    A_stencil (S, P, S_off, C, C))`` where each entry of ``coefs_stacked``
    has a leading sample axis S, sharded over ``mesh``'s ``axis``.

    Pass ``mesh=None`` for a single-device vmapped sweep.  S must divide
    the mesh size for an even shard; otherwise the sample axis is
    replicated (correct but not parallel)."""
    base = solver.build_step()           # pure; patch axis unsharded
    names = list(solver.coef_names)

    def stacked(coefs, fem_rhs):
        u, A_st = jax.vmap(
            lambda c: base(dict(zip(names, c)), fem_rhs)
        )(tuple(coefs[k] for k in names))
        return u, A_st

    if mesh is None:
        return jax.jit(stacked)

    n_dev = int(np.prod(list(mesh.shape.values())))

    def sharded(coefs, fem_rhs):
        def constrain(x):
            if x.shape[0] % n_dev != 0:
                return x
            spec = PartitionSpec(axis, *([None] * (x.ndim - 1)))
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, spec))

        coefs = {k: constrain(v) for k, v in coefs.items()}
        u, A_st = stacked(coefs, fem_rhs)
        return constrain(u), constrain(A_st)

    return jax.jit(sharded)


def stack_fields(field_dicts):
    """[{name: (n_sub, nq)}, ...] -> {name: (S, n_sub, nq)}."""
    names = field_dicts[0].keys()
    return {k: jnp.stack([d[k] for d in field_dicts]) for k in names}
