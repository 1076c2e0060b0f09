// Native runtime components for dealii_slod_tpu.
//
// Host-side counterparts of the reference's C++ host-side machinery:
//  - build_patches: the patch-window topology builder (replaces
//    LOD::create_patches / create_mesh_for_patch, reference
//    source/LOD.cc:122-244, :770-858 — the reference's own benchmark
//    comment records 10.97 s for N=32, l=4 with index arithmetic,
//    tests/create_patch_01.cc:149; this builder is vectorizable and
//    OpenMP-free single-pass integer arithmetic).
//  - write_vtu_binary: appended-raw-binary XML VTU writer (replaces the
//    deal.II DataOut writers used at source/LOD.cc:285, :1371).
//
// Exposed with a plain C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// Fill per-patch window data for all N^dim patches of an N^dim coarse grid
// with Chebyshev-radius `ell` windows clipped at the domain boundary.
// Outputs (caller-allocated):
//   lo[P*dim], shape[P*dim] (int32), central[P] (int32, lexicographic index
//   of the central cell inside its window), side_is_domain[P*2*dim] (uint8).
// Index convention: axis 0 fastest (lexicographic), matching grid.py.
void build_patches(int dim, int n_coarse, int ell,
                   int32_t* lo, int32_t* shape, int32_t* central,
                   uint8_t* side_is_domain) {
  int64_t P = 1;
  for (int k = 0; k < dim; ++k) P *= n_coarse;

  std::vector<int32_t> c(dim, 0);
  for (int64_t p = 0; p < P; ++p) {
    int32_t cen_stride = 1;
    int32_t cen = 0;
    for (int k = 0; k < dim; ++k) {
      int32_t l = c[k] - ell;
      if (l < 0) l = 0;
      int32_t h = c[k] + ell;
      if (h > n_coarse - 1) h = n_coarse - 1;
      lo[p * dim + k] = l;
      int32_t sh = h - l + 1;
      shape[p * dim + k] = sh;
      side_is_domain[p * 2 * dim + 2 * k] = (l == 0);
      side_is_domain[p * 2 * dim + 2 * k + 1] = (h == n_coarse - 1);
      cen += (c[k] - l) * cen_stride;
      cen_stride *= sh;
    }
    central[p] = cen;
    // advance lexicographic counter (axis 0 fastest)
    for (int k = 0; k < dim; ++k) {
      if (++c[k] < n_coarse) break;
      c[k] = 0;
    }
  }
}

// Minimal appended-raw-binary VTU writer.
//   points: n_pts x 3 float64 (already padded to 3 components)
//   cells:  n_cells x k int64 (VTK corner order), k = 4 (quad) or 8 (hex)
//   vtk_cell_type: 9 (quad) or 12 (hexahedron)
//   point fields / cell fields: each n x n_comp float64, names
//   '\n'-separated in pnames / cnames.
// Returns 0 on success.
int write_vtu_binary(const char* path,
                     const double* points, int64_t n_pts,
                     const int64_t* cells, int64_t n_cells, int k,
                     int vtk_cell_type,
                     const double* pdata, const int64_t* pcomps,
                     int n_pfields, const char* pnames,
                     const double* cdata, const int64_t* ccomps,
                     int n_cfields, const char* cnames) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;

  std::vector<std::string> pn, cn;
  {
    std::string s(pnames ? pnames : ""), t;
    for (char ch : s) { if (ch == '\n') { pn.push_back(t); t.clear(); } else t += ch; }
    if (!t.empty()) pn.push_back(t);
    s = cnames ? cnames : ""; t.clear();
    for (char ch : s) { if (ch == '\n') { cn.push_back(t); t.clear(); } else t += ch; }
    if (!t.empty()) cn.push_back(t);
  }

  // compute appended-data offsets (each block: uint64 byte count + payload)
  uint64_t off = 0;
  auto block = [&off](uint64_t nbytes) {
    uint64_t o = off;
    off += sizeof(uint64_t) + nbytes;
    return o;
  };
  uint64_t off_pts = block(uint64_t(n_pts) * 3 * sizeof(double));
  uint64_t off_conn = block(uint64_t(n_cells) * k * sizeof(int64_t));
  uint64_t off_offs = block(uint64_t(n_cells) * sizeof(int64_t));
  uint64_t off_types = block(uint64_t(n_cells) * sizeof(uint8_t));
  std::vector<uint64_t> off_pf(n_pfields), off_cf(n_cfields);
  for (int i = 0; i < n_pfields; ++i)
    off_pf[i] = block(uint64_t(n_pts) * pcomps[i] * sizeof(double));
  for (int i = 0; i < n_cfields; ++i)
    off_cf[i] = block(uint64_t(n_cells) * ccomps[i] * sizeof(double));

  std::fprintf(f, "<?xml version=\"1.0\"?>\n");
  std::fprintf(f, "<VTKFile type=\"UnstructuredGrid\" version=\"1.0\" "
                  "byte_order=\"LittleEndian\" header_type=\"UInt64\">\n");
  std::fprintf(f, "  <UnstructuredGrid>\n");
  std::fprintf(f, "    <Piece NumberOfPoints=\"%lld\" NumberOfCells=\"%lld\">\n",
               (long long)n_pts, (long long)n_cells);
  std::fprintf(f, "      <Points>\n"
                  "        <DataArray type=\"Float64\" NumberOfComponents=\"3\" "
                  "format=\"appended\" offset=\"%llu\"/>\n"
                  "      </Points>\n", (unsigned long long)off_pts);
  std::fprintf(f, "      <Cells>\n");
  std::fprintf(f, "        <DataArray type=\"Int64\" Name=\"connectivity\" "
                  "format=\"appended\" offset=\"%llu\"/>\n",
               (unsigned long long)off_conn);
  std::fprintf(f, "        <DataArray type=\"Int64\" Name=\"offsets\" "
                  "format=\"appended\" offset=\"%llu\"/>\n",
               (unsigned long long)off_offs);
  std::fprintf(f, "        <DataArray type=\"UInt8\" Name=\"types\" "
                  "format=\"appended\" offset=\"%llu\"/>\n",
               (unsigned long long)off_types);
  std::fprintf(f, "      </Cells>\n");
  std::fprintf(f, "      <PointData>\n");
  for (int i = 0; i < n_pfields; ++i)
    std::fprintf(f, "        <DataArray type=\"Float64\" Name=\"%s\" "
                    "NumberOfComponents=\"%lld\" format=\"appended\" "
                    "offset=\"%llu\"/>\n",
                 pn[i].c_str(), (long long)pcomps[i],
                 (unsigned long long)off_pf[i]);
  std::fprintf(f, "      </PointData>\n      <CellData>\n");
  for (int i = 0; i < n_cfields; ++i)
    std::fprintf(f, "        <DataArray type=\"Float64\" Name=\"%s\" "
                    "NumberOfComponents=\"%lld\" format=\"appended\" "
                    "offset=\"%llu\"/>\n",
                 cn[i].c_str(), (long long)ccomps[i],
                 (unsigned long long)off_cf[i]);
  std::fprintf(f, "      </CellData>\n");
  std::fprintf(f, "    </Piece>\n  </UnstructuredGrid>\n");
  std::fprintf(f, "  <AppendedData encoding=\"raw\">\n_");

  auto put = [&f](const void* data, uint64_t nbytes) {
    std::fwrite(&nbytes, sizeof(uint64_t), 1, f);
    if (nbytes) std::fwrite(data, 1, nbytes, f);
  };
  put(points, uint64_t(n_pts) * 3 * sizeof(double));
  put(cells, uint64_t(n_cells) * k * sizeof(int64_t));
  {
    std::vector<int64_t> offs(n_cells);
    for (int64_t i = 0; i < n_cells; ++i) offs[i] = (i + 1) * k;
    put(offs.data(), uint64_t(n_cells) * sizeof(int64_t));
    std::vector<uint8_t> types(n_cells, (uint8_t)vtk_cell_type);
    put(types.data(), uint64_t(n_cells) * sizeof(uint8_t));
  }
  {
    const double* ptr = pdata;
    for (int i = 0; i < n_pfields; ++i) {
      put(ptr, uint64_t(n_pts) * pcomps[i] * sizeof(double));
      ptr += n_pts * pcomps[i];
    }
    ptr = cdata;
    for (int i = 0; i < n_cfields; ++i) {
      put(ptr, uint64_t(n_cells) * ccomps[i] * sizeof(double));
      ptr += n_cells * ccomps[i];
    }
  }
  std::fprintf(f, "\n  </AppendedData>\n</VTKFile>\n");
  std::fclose(f);
  return 0;
}

// Fold per-axis clipped window columns into raveled window indices
// (grid.clipped_window_index's final outer-sum folds, the LODSolver-ctor
// hotspot at 3D refine>=5: the (P, K) materialization in NumPy broadcast
// form ran at ~100 MB/s).
//
// Layout: cols_cat / oks_cat are (P, sum_d extents[d]) row-major — axis d's
// column block starts at offset sum_{d'<d} extents[d'].  cols already carry
// the per-axis stride and clipping; oks the per-axis in-bounds bit.
// Outputs idx (P, K) int32 and valid (P, K) uint8 with K = prod(extents),
// axis 0 fastest (lexicographic) — identical to the NumPy fold.
void fold_window_index(int64_t P, int dim, const int32_t* extents,
                       const int32_t* cols_cat, const uint8_t* oks_cat,
                       int32_t* idx, uint8_t* valid) {
  int64_t K = 1;
  for (int d = 0; d < dim; ++d) K *= extents[d];
  int64_t row = 0;
  for (int d = 0; d < dim; ++d) row += extents[d];

  // per-axis lookup tables kd[d][k]: the axis-d digit of window cell k
  std::vector<std::vector<int32_t>> kd(dim, std::vector<int32_t>(K));
  {
    int64_t stride = 1;
    for (int d = 0; d < dim; ++d) {
      const int32_t e = extents[d];
      for (int64_t k = 0; k < K; ++k)
        kd[d][k] = (int32_t)((k / stride) % e);
      stride *= e;
    }
  }
  std::vector<int64_t> offs(dim, 0);
  for (int d = 1; d < dim; ++d) offs[d] = offs[d - 1] + extents[d - 1];

  for (int64_t p = 0; p < P; ++p) {
    const int32_t* c = cols_cat + p * row;
    const uint8_t* o = oks_cat + p * row;
    int32_t* out = idx + p * K;
    uint8_t* vout = valid + p * K;
    const int32_t* k0 = kd[0].data();
    const int32_t* c0 = c + offs[0];
    const uint8_t* o0 = o + offs[0];
    if (dim == 1) {
      for (int64_t k = 0; k < K; ++k) { out[k] = c0[k0[k]]; vout[k] = o0[k0[k]]; }
      continue;
    }
    const int32_t* k1 = kd[1].data();
    const int32_t* c1 = c + offs[1];
    const uint8_t* o1 = o + offs[1];
    if (dim == 2) {
      for (int64_t k = 0; k < K; ++k) {
        out[k] = c0[k0[k]] + c1[k1[k]];
        vout[k] = (uint8_t)(o0[k0[k]] & o1[k1[k]]);
      }
      continue;
    }
    const int32_t* k2 = kd[2].data();
    const int32_t* c2 = c + offs[2];
    const uint8_t* o2 = o + offs[2];
    for (int64_t k = 0; k < K; ++k) {
      out[k] = c0[k0[k]] + c1[k1[k]] + c2[k2[k]];
      vout[k] = (uint8_t)(o0[k0[k]] & o1[k1[k]] & o2[k2[k]]);
    }
  }
}

}  // extern "C"
