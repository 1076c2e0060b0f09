"""dealii_slod_tpu — Super-Localized Orthogonal Decomposition (SLOD) in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the deal.II-based
reference solver camillabelponer/dealii-slod (see /root/reference and SURVEY.md):
LOD / SLOD multiscale finite-element solvers for scalar diffusion and linear
elasticity on structured grids, with oversampled-patch basis construction,
coarse operator assembly ``A_LOD = C^T A C``, reference fine/coarse FEM solves,
error tables and field output.

Design (batched and accelerator-first, not a port):

- Structured lexicographic grids; all mesh topology is integer index arithmetic
  (replacing deal.II Triangulation/DoFHandler, cf. reference tests/util.h:377-583).
- Patches are bucketed by shape class; all per-patch work (Q_iso_Q1 assembly,
  multi-RHS solves, boundary-trace SVD) is batched with ``vmap`` over each class.
- Per-patch sparse direct solves (Amesos KLU in the reference,
  include/LODtools.h:511-595) become batched dense Cholesky on the SPD internal
  submatrix.
- The coarse operator is stored in stencil form and solved with a matrix-free
  CG; the fine reference FEM solve is matrix-free CG with Jacobi preconditioner.
- Scaling axis: the patch batch, sharded over a ``jax.sharding.Mesh``.
"""

__version__ = "0.1.0"

from dealii_slod_tpu.config import SLODConfig
from dealii_slod_tpu.grid import GridSpec, PatchTopology

__all__ = [
    "SLODConfig",
    "GridSpec",
    "PatchTopology",
]
