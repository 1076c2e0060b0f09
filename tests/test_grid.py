"""Grid/index-core tests — mirrors reference tests create_patch_01.cc,
create_mesh_from_cells_01.cc and the structured Patch of tests/util.h."""

import numpy as np
import pytest

from dealii_slod_tpu.grid import (GridSpec, PatchTopology, ShapeClass,
                                  cartesian_coords, ravel, unravel)


def test_ravel_unravel_roundtrip():
    dims = np.array([3, 4, 5])
    idx = np.arange(60)
    assert np.array_equal(ravel(unravel(idx, dims), dims), idx)
    # axis 0 fastest
    assert ravel(np.array([1, 0, 0]), dims) == 1
    assert ravel(np.array([0, 1, 0]), dims) == 3
    assert ravel(np.array([0, 0, 1]), dims) == 12


def test_patch_sizes_match_reference_golden():
    # Poisson_LOD_Example config: ref=2 -> N=4, ell=1, s=2.
    # Golden: 16 patches, sizes in (4, 9)  (tests/Poisson_LOD_Example.output:1-2)
    g = GridSpec(dim=2, n_coarse=4, n_sub=2)
    topo = PatchTopology(g, oversampling=1)
    sizes = topo.patch_sizes()
    assert topo.n_patches == 16
    assert sizes.min() == 4 and sizes.max() == 9
    # corner patch = 2x2, edge = 2x3, interior = 3x3
    counts = np.bincount(sizes)
    assert counts[4] == 4 and counts[6] == 8 and counts[9] == 4


def test_patch_windows_clip_like_reference():
    # reference create_patches keeps offsets whose shifted barycenter stays in
    # (0,1) (LOD.cc:161,:168) == clamping the window to [0, N-1]
    g = GridSpec(dim=2, n_coarse=32, n_sub=2)
    topo = PatchTopology(g, oversampling=4)
    c = cartesian_coords(g.cell_dims)
    lo_expect = np.clip(c - 4, 0, None)
    hi_expect = np.clip(c + 4, None, 31)
    assert np.array_equal(topo.patch_lo, lo_expect)
    assert np.array_equal(topo.patch_shape, hi_expect - lo_expect + 1)
    # create_patch_01 config: sizes range from (l+1)^2=25 to (2l+1)^2=81
    sizes = topo.patch_sizes()
    assert sizes.min() == 25 and sizes.max() == 81


def test_central_cell_is_tracked():
    # the reference puts the central cell FIRST in the patch cell list
    # (LOD.cc:152-154); we keep lexicographic order + explicit central index
    g = GridSpec(dim=2, n_coarse=4, n_sub=2)
    topo = PatchTopology(g, oversampling=1)
    for p in range(topo.n_patches):
        ci = topo.class_of_patch[p]
        sc = topo.classes[ci]
        cen = topo.central_cell_local[p]
        cc = unravel(np.array(cen), sc.cell_dims_local)
        assert np.array_equal(topo.patch_lo[p] + cc,
                              unravel(np.array(p), g.cell_dims))


def test_interior_edge_partition():
    g = GridSpec(dim=2, n_coarse=4, n_sub=2)
    sc = ShapeClass((3, 3), g)
    # 3x3 cells of 2 subdivisions -> 7x7 nodes; interior 5x5, edge 24
    assert sc.n_nodes_local == 49
    assert sc.n_interior == 25
    assert sc.n_edge == 24
    both = np.concatenate([sc.interior_nodes, sc.edge_nodes])
    assert len(np.unique(both)) == 49


def test_edge_flags_on_boundary_patch():
    g = GridSpec(dim=2, n_coarse=4, n_sub=2)
    topo = PatchTopology(g, oversampling=1)
    # patch around cell (0,0): window [0,1]x[0,1], sides x-low and y-low on
    # the domain boundary
    p = 0
    sc = topo.classes[topo.class_of_patch[p]]
    is99, isdom = topo.edge_node_flags(np.array([p]), sc)
    is99, isdom = is99[0], isdom[0]
    coords = sc.node_coords_local[sc.edge_nodes]
    hi = sc.node_dims_local - 1
    for k, (cx, cy) in enumerate(coords):
        expect_dom = (cx == 0) or (cy == 0)
        expect_99 = (cx == hi[0]) or (cy == hi[1])
        assert isdom[k] == expect_dom
        assert is99[k] == expect_99
    # corner node shared by domain and patch boundary is in BOTH sets
    # (LODtools.h:367-369)
    corner = np.nonzero((coords[:, 0] == 0) & (coords[:, 1] == hi[1]))[0][0]
    assert isdom[corner] and is99[corner]


def test_pt_weights_sum_to_cell_volume():
    # sum of the P^T column over nodes = integral of 1 over the cell = H^dim
    for dim in (2, 3):
        g = GridSpec(dim=dim, n_coarse=4, n_sub=3)
        sc = ShapeClass((2,) * dim, g)
        sums = sc.PT_node_cell.sum(axis=0)
        np.testing.assert_allclose(sums, g.H ** dim, rtol=1e-14)


def test_pt_trapezoid_pattern_matches_reference():
    # projection_P1_P0 (LODtools.h:7-73): values (1,2,4) * h^2/4 for
    # corner/edge/interior nodes of a single cell in 2D
    g = GridSpec(dim=2, n_coarse=2, n_sub=4)
    sc = ShapeClass((1, 1), g)
    col = sc.PT_node_cell[:, 0]
    h = g.h
    coords = sc.node_coords_local
    on_edge = (coords == 0) | (coords == 4)
    n_ext = on_edge.sum(axis=1)
    expect = np.where(n_ext == 2, h * h / 4,
                      np.where(n_ext == 1, h * h / 2, h * h))
    np.testing.assert_allclose(col, expect, rtol=1e-14)


def test_global_node_indices_by_arithmetic():
    # cf. tests/util.h:451-475 get_dof_indices by index arithmetic
    g = GridSpec(dim=2, n_coarse=4, n_sub=2)
    topo = PatchTopology(g, oversampling=1)
    p = 5  # cell (1,1): window [0,2]x[0,2] -> full 3x3 patch at origin 0
    sc = topo.classes[topo.class_of_patch[p]]
    gidx = topo.global_node_indices(np.array([p]), sc)[0]
    # node (a,b) local == global since origin is 0
    expect = ravel(sc.node_coords_local, g.node_dims)
    assert np.array_equal(gidx, expect)
    # a shifted patch
    p2 = 10  # cell (2,2): window [1,3]x[1,3], origin nodes (2,2)
    sc2 = topo.classes[topo.class_of_patch[p2]]
    gidx2 = topo.global_node_indices(np.array([p2]), sc2)[0]
    expect2 = ravel(sc2.node_coords_local + 2, g.node_dims)
    assert np.array_equal(gidx2, expect2)


@pytest.mark.parametrize("dim", [2, 3])
def test_3d_topology(dim):
    g = GridSpec(dim=dim, n_coarse=4, n_sub=2)
    topo = PatchTopology(g, oversampling=1)
    assert topo.n_patches == 4 ** dim
    assert topo.patch_sizes().max() == 3 ** dim
    assert topo.patch_sizes().min() == 2 ** dim


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_clipped_window_index_matches_bruteforce(dim):
    from dealii_slod_tpu.grid import (cartesian_coords, clipped_window_index,
                                      ravel)
    rng = np.random.default_rng(3)
    dims = np.array([7, 5, 9][:dim])
    extent = np.array([3, 4, 2][:dim])
    # anchors straddling both boundaries and the interior
    anchor = rng.integers(-3, dims + 2, size=(40, dim))
    idx, valid = clipped_window_index(anchor, extent, dims)
    coords = anchor[:, None, :] + cartesian_coords(extent)[None, :, :]
    expect_valid = ((coords >= 0) & (coords < dims)).all(axis=-1)
    expect_idx = ravel(np.clip(coords, 0, dims - 1), dims)
    assert np.array_equal(valid, expect_valid)
    assert np.array_equal(idx, expect_idx)
    assert idx.dtype == np.int32


# ---------------------------------------------------------------------------
# Full-depth golden diffs against the reference's .output files: read the
# actual files from disk rather than re-typed constants.
# ---------------------------------------------------------------------------

import os

_REF_TESTS = "/root/reference/tests"


def _morton_to_lex(n_levels: int) -> np.ndarray:
    """deal.II active-cell index -> lexicographic (x + N*y) cell index for a
    hyper_cube refined ``n_levels`` times.  Global refinement visits cells
    in recursive child order with deal.II 2D child numbering (x fastest:
    (0,0),(1,0),(0,1),(1,1)) == the Morton/Z-order curve, so the coordinate
    bits of cell i are the de-interleaved bits of i (x = even bits, y = odd
    bits)."""
    n = 1 << n_levels
    idx = np.arange(n * n)
    x = np.zeros(n * n, dtype=int)
    y = np.zeros(n * n, dtype=int)
    for b in range(n_levels):
        x |= ((idx >> (2 * b)) & 1) << b
        y |= ((idx >> (2 * b + 1)) & 1) << b
    return x + n * y


@pytest.mark.skipif(not os.path.isdir(_REF_TESTS),
                    reason="reference tree not present")
def test_create_patch_01_full_golden_diff():
    # reference tests/create_patch_01.cc: dim=2, refine=5 (N=32), ell=4;
    # prints ALL 1024 per-patch cell counts in active-cell (Morton) order
    # (tests/create_patch_01.output:2-1025).
    lines = open(os.path.join(_REF_TESTS, "create_patch_01.output")).read()
    lines = lines.strip().splitlines()
    assert lines[0].startswith("printing the vector cells")
    golden = np.empty(len(lines) - 1, dtype=int)
    for ln in lines[1:]:
        # "- 17: {63}"
        i, sz = ln.lstrip("- ").split(": {")
        golden[int(i)] = int(sz.rstrip("}"))
    assert golden.size == 1024

    g = GridSpec(dim=2, n_coarse=32, n_sub=2)
    topo = PatchTopology(g, oversampling=4)
    ours_lex = topo.patch_sizes()                    # lexicographic order
    assert np.array_equal(ours_lex[_morton_to_lex(5)], golden)


@pytest.mark.skipif(not os.path.isdir(_REF_TESTS),
                    reason="reference tree not present")
def test_mv_solve_01_ndofs_golden():
    # reference tests/mv_solve_01.cc: dim=2, refine=3 (8x8 cells),
    # FE_Q_iso_Q1(5) -> prints n_dofs (tests/mv_solve_01.output:1)
    golden = int(open(os.path.join(_REF_TESTS,
                                   "mv_solve_01.output")).read().split()[0])
    g = GridSpec(dim=2, n_coarse=8, n_sub=5)
    assert g.n_fine_dofs == golden == 1681


@pytest.mark.skipif(not os.path.isdir(_REF_TESTS),
                    reason="reference tree not present")
def test_poisson_lod_example_deterministic_lines_golden():
    # the alpha-independent lines of tests/Poisson_LOD_Example.output,
    # parsed from the file on disk (ref=2 -> N=4, ell=1, s=2).
    txt = open(os.path.join(_REF_TESTS,
                            "Poisson_LOD_Example.output")).read()
    lines = [ln.strip() for ln in txt.splitlines()]

    g = GridSpec(dim=2, n_coarse=4, n_sub=2)
    topo = PatchTopology(g, oversampling=1)

    import re
    m = re.search(r"number of patches = (\d+)", lines[0])
    assert topo.n_patches == int(m.group(1))
    m = re.search(r"Patches size in \((\d+), (\d+)\)", lines[1])
    sizes = topo.patch_sizes()
    assert (sizes.min(), sizes.max()) == (int(m.group(1)), int(m.group(2)))
    m = next(re.search(r"size of fem u (\d+)", ln) for ln in lines
             if "size of fem u" in ln)
    # total fine dofs (deal.II keeps constrained boundary rows in place)
    assert int(m.group(1)) == g.n_fine_dofs
    m = next(re.search(r"size of u (\d+)", ln) for ln in lines
             if re.search(r"^size of u ", ln))
    assert int(m.group(1)) == topo.n_patches
