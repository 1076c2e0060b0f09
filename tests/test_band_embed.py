"""Interleaved banded-stride dense embed == brute-force scatter.

`bands_to_dense_mm`'s C > 1 path (ops/assembly.py) places every (o, c, d)
band entry into a width-C*(W+1) row-group buffer and flat-slices the
dense component-interleaved matrix — no transpose to (nN, C, nN, C)
with a tiny minor axis C.  Must equal the
brute-force scatter exactly for interior rows; wrap-around placements
must vanish when off-grid band values are zero (the production
invariant: clipped couplings carry zero weights)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dealii_slod_tpu.grid import cartesian_coords
from dealii_slod_tpu.ops.assembly import (band_placement_matrix,
                                          bands_to_dense_mm)


def _brute(band, node_dims):
    dims = np.asarray(node_dims, int)
    nN = int(dims.prod())
    _, O, C, _ = band.shape
    offs = cartesian_coords(np.full(len(dims), 3)) - 1
    dense = np.zeros((nN * C, nN * C))
    coords = cartesian_coords(dims)
    for i in range(nN):
        for o in range(O):
            j_co = coords[i] + offs[o]
            if ((j_co < 0) | (j_co >= dims)).any():
                continue
            j = int(np.ravel_multi_index(j_co[::-1], dims[::-1]))
            for c in range(C):
                for d in range(C):
                    dense[i * C + c, j * C + d] = band[i, o, c, d]
    return dense


@pytest.mark.parametrize("dims,C", [((4, 5), 2), ((3, 3, 4), 3), ((6, 4), 1)])
def test_bands_to_dense_mm_matches_brute(dims, C):
    rng = np.random.default_rng(sum(dims) + C)
    dims_np = np.asarray(dims, int)
    nN = int(dims_np.prod())
    O = 3 ** len(dims)
    offs = cartesian_coords(np.full(len(dims), 3)) - 1
    coords = cartesian_coords(dims_np)
    band = rng.standard_normal((nN, O, C, C))
    # production invariant: off-grid couplings carry ZERO band values
    for i in range(nN):
        for o in range(O):
            j_co = coords[i] + offs[o]
            if ((j_co < 0) | (j_co >= dims_np)).any():
                band[i, o] = 0.0
    placement = band_placement_matrix(dims_np)
    dense = np.asarray(bands_to_dense_mm(jnp.asarray(band), *placement))
    np.testing.assert_allclose(dense, _brute(band, dims_np),
                               rtol=0, atol=1e-14)
