"""Device-mesh utilities — the replacement for the reference's
MPI patch partitioning.

The reference's only scaling axis is patch data-parallelism: each MPI rank
owns an even slice of patch ids
(``Utilities::MPI::create_evenly_distributed_partitioning``, reference
source/LOD.cc:116-118) and the distributed Trilinos objects exchange data in
``compress()`` and CG dot products.  Here the same axis is a
``jax.sharding.Mesh`` dimension: the patch batch and all (P, ...) arrays are
sharded over it, and XLA's SPMD partitioner inserts the collectives (the
stencil neighbor gather becomes a halo exchange / all-gather, the
CG reductions become ``psum``) — zero custom communication code."""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.experimental import mesh_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def make_mesh(n_devices: Optional[int] = None, axis: str = "patches") -> Mesh:
    """1-D device mesh over the patch axis.  ``n_devices=None`` uses all
    visible devices."""
    devs = jax.devices()
    n = n_devices or len(devs)
    mesh_devices = mesh_utils.create_device_mesh((n,), devices=devs[:n])
    return Mesh(mesh_devices, (axis,))


def shard_patches(mesh: Mesh, x, axis: str = "patches"):
    """Place an array with leading patch axis sharded over the mesh
    (replicates when the leading dim does not divide the mesh)."""
    n_dev = int(np.prod(list(mesh.shape.values())))
    if x.shape[0] % n_dev != 0:
        return replicate(mesh, x)
    spec = PartitionSpec(axis, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def replicate(mesh: Mesh, x):
    return jax.device_put(x, NamedSharding(mesh, PartitionSpec()))
