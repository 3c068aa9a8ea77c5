// optconpy_native — C++ element-assembly + data-packing kernels.
//
// Native-substrate parity with the reference stack's DOLFIN/FFC layer
// (SURVEY.md SS2 rows 9-10: the reference's only native code is its
// third-party C++ assembly + factorization libraries). This library
// owns the corresponding host-side hot paths of the device build:
//
//   * Taylor-Hood (P2/P1) element matrices (mass, stiffness,
//     divergence) straight from vertex coordinates — the FFC-generated
//     element-kernel equivalent, streamed per element with no
//     intermediate (nt, 6, 6, 6, 2) tensors.
//   * Nonlinear convection evaluation N(v)v on the full dof set — the
//     get_convvec hot path of the reference architecture.
//   * CSR -> padded-ELL packing for the device sparse format.
//
// Exposed as a plain C ABI consumed through ctypes
// (optconpy_tpu/native.py); the numpy implementations in
// fem/taylor_hood.py remain the correctness oracle and fallback.
//
// Build: make -C native   (g++ -O3 -march=native -shared -fPIC)

#include <cstdint>
#include <cstring>

namespace {

// 7-point degree-5 triangle quadrature (barycentric), weights sum 1.
constexpr int NQ = 7;
constexpr double A1 = 0.797426985353087, B1 = 0.101286507323456;
constexpr double A2 = 0.059715871789770, B2 = 0.470142064105115;
constexpr double QW[NQ] = {0.225,
                           0.125939180544827, 0.125939180544827,
                           0.125939180544827,
                           0.132394152788506, 0.132394152788506,
                           0.132394152788506};
constexpr double QL[NQ][3] = {
    {1.0 / 3, 1.0 / 3, 1.0 / 3}, {A1, B1, B1}, {B1, A1, B1},
    {B1, B1, A1},                {A2, B2, B2}, {B2, A2, B2},
    {B2, B2, A2}};

// P2 basis values at a barycentric point (l0, l1, l2).
inline void p2_values(const double l[3], double phi[6]) {
  phi[0] = l[0] * (2 * l[0] - 1);
  phi[1] = l[1] * (2 * l[1] - 1);
  phi[2] = l[2] * (2 * l[2] - 1);
  phi[3] = 4 * l[1] * l[2];
  phi[4] = 4 * l[0] * l[2];
  phi[5] = 4 * l[0] * l[1];
}

// d(phi_i)/d(lambda_j) at a barycentric point.
inline void p2_dlam(const double l[3], double d[6][3]) {
  std::memset(d, 0, sizeof(double) * 18);
  d[0][0] = 4 * l[0] - 1;
  d[1][1] = 4 * l[1] - 1;
  d[2][2] = 4 * l[2] - 1;
  d[3][1] = 4 * l[2];
  d[3][2] = 4 * l[1];
  d[4][0] = 4 * l[2];
  d[4][2] = 4 * l[0];
  d[5][0] = 4 * l[1];
  d[5][1] = 4 * l[0];
}

// Per-triangle geometry: grad(lambda) (3x2) and signed area.
inline double tri_geometry(const double* v0, const double* v1,
                           const double* v2, double glam[3][2]) {
  const double d1x = v1[0] - v0[0], d1y = v1[1] - v0[1];
  const double d2x = v2[0] - v0[0], d2y = v2[1] - v0[1];
  const double det = d1x * d2y - d1y * d2x;  // = 2 * area (ccw)
  glam[1][0] = d2y / det;
  glam[1][1] = -d2x / det;
  glam[2][0] = -d1y / det;
  glam[2][1] = d1x / det;
  glam[0][0] = -glam[1][0] - glam[2][0];
  glam[0][1] = -glam[1][1] - glam[2][1];
  return 0.5 * det;
}

}  // namespace

extern "C" {

// Element matrices for every triangle.
//   vertices: (nv, 2) f64;  triangles: (nt, 3) i32 (ccw).
// Outputs (caller-allocated):
//   m_loc: (nt, 6, 6)  scalar P2 mass blocks
//   k_loc: (nt, 6, 6)  scalar P2 stiffness blocks
//   j_loc: (nt, 3, 6, 2) divergence blocks (P1 row, P2 col, component)
//   area:  (nt,)
void th_element_matrices(const double* vertices, const int32_t* triangles,
                         int64_t nt, double* m_loc, double* k_loc,
                         double* j_loc, double* area) {
  // Reference mass matrix (element-independent): int phi_i phi_j dlam.
  double m_ref[6][6] = {};
  for (int q = 0; q < NQ; ++q) {
    double phi[6];
    p2_values(QL[q], phi);
    const double w = QW[q] * 0.5;
    for (int i = 0; i < 6; ++i)
      for (int j = 0; j < 6; ++j) m_ref[i][j] += w * phi[i] * phi[j];
  }

  for (int64_t e = 0; e < nt; ++e) {
    const int32_t* t = triangles + 3 * e;
    double glam[3][2];
    const double a = tri_geometry(vertices + 2 * t[0], vertices + 2 * t[1],
                                  vertices + 2 * t[2], glam);
    area[e] = a;
    const double two_a = 2.0 * a;

    double* me = m_loc + 36 * e;
    double* ke = k_loc + 36 * e;
    double* je = j_loc + 36 * e;  // 3*6*2 = 36
    std::memset(ke, 0, 36 * sizeof(double));
    std::memset(je, 0, 36 * sizeof(double));
    for (int i = 0; i < 36; ++i) me[i] = two_a * (&m_ref[0][0])[i];

    for (int q = 0; q < NQ; ++q) {
      double dl[6][3];
      p2_dlam(QL[q], dl);
      // gphi[i][d] = sum_l dl[i][l] glam[l][d]
      double gphi[6][2];
      for (int i = 0; i < 6; ++i)
        for (int d = 0; d < 2; ++d)
          gphi[i][d] = dl[i][0] * glam[0][d] + dl[i][1] * glam[1][d] +
                       dl[i][2] * glam[2][d];
      const double w = QW[q] * 0.5 * two_a;
      for (int i = 0; i < 6; ++i)
        for (int j = 0; j < 6; ++j)
          ke[6 * i + j] +=
              w * (gphi[i][0] * gphi[j][0] + gphi[i][1] * gphi[j][1]);
      // Divergence: j_loc[p][j][d] += w * lambda_p * gphi[j][d].
      for (int p = 0; p < 3; ++p) {
        const double wl = w * QL[q][p];
        for (int j = 0; j < 6; ++j) {
          je[12 * p + 2 * j + 0] += wl * gphi[j][0];
          je[12 * p + 2 * j + 1] += wl * gphi[j][1];
        }
      }
    }
  }
}

// Nonlinear convection y += <w, (v.grad)v> on the FULL dof set.
//   v: (2*ns,) velocity [u_x dofs | u_y dofs];  y: (2*ns,) zeroed by
//   caller;  tri_dofs: (nt, 6) scalar P2 dofs.
void th_convection_apply(const double* vertices, const int32_t* triangles,
                         const int32_t* tri_dofs, int64_t nt, int64_t ns,
                         const double* v, double* y) {
  for (int64_t e = 0; e < nt; ++e) {
    const int32_t* t = triangles + 3 * e;
    const int32_t* dofs = tri_dofs + 6 * e;
    double glam[3][2];
    const double a = tri_geometry(vertices + 2 * t[0], vertices + 2 * t[1],
                                  vertices + 2 * t[2], glam);
    const double two_a = 2.0 * a;

    double vx[6], vy[6];
    for (int i = 0; i < 6; ++i) {
      vx[i] = v[dofs[i]];
      vy[i] = v[ns + dofs[i]];
    }

    double yx[6] = {}, yy[6] = {};
    for (int q = 0; q < NQ; ++q) {
      double phi[6], dl[6][3], gphi[6][2];
      p2_values(QL[q], phi);
      p2_dlam(QL[q], dl);
      for (int i = 0; i < 6; ++i)
        for (int d = 0; d < 2; ++d)
          gphi[i][d] = dl[i][0] * glam[0][d] + dl[i][1] * glam[1][d] +
                       dl[i][2] * glam[2][d];
      // u, grad u at the quad point.
      double ux = 0, uy = 0, gux[2] = {0, 0}, guy[2] = {0, 0};
      for (int i = 0; i < 6; ++i) {
        ux += phi[i] * vx[i];
        uy += phi[i] * vy[i];
        gux[0] += gphi[i][0] * vx[i];
        gux[1] += gphi[i][1] * vx[i];
        guy[0] += gphi[i][0] * vy[i];
        guy[1] += gphi[i][1] * vy[i];
      }
      const double cx = ux * gux[0] + uy * gux[1];  // (v.grad)v_x
      const double cy = ux * guy[0] + uy * guy[1];
      const double w = QW[q] * 0.5 * two_a;
      for (int i = 0; i < 6; ++i) {
        yx[i] += w * phi[i] * cx;
        yy[i] += w * phi[i] * cy;
      }
    }
    for (int i = 0; i < 6; ++i) {
      y[dofs[i]] += yx[i];
      y[ns + dofs[i]] += yy[i];
    }
  }
}

// CSR -> padded ELL: data/cols (m, k) caller-zeroed.
void csr_to_ell(const double* csr_data, const int32_t* csr_indices,
                const int64_t* csr_indptr, int64_t m, int64_t k,
                double* ell_data, int32_t* ell_cols) {
  for (int64_t i = 0; i < m; ++i) {
    const int64_t lo = csr_indptr[i], hi = csr_indptr[i + 1];
    for (int64_t j = lo; j < hi; ++j) {
      ell_data[i * k + (j - lo)] = csr_data[j];
      ell_cols[i * k + (j - lo)] = csr_indices[j];
    }
  }
}

}  // extern "C"
