// fastransac: in-repo native LO-RANSAC estimators (homography + essential).
//
// Fills the PoseLib slot of the reference (SURVEY §2.9: the reference wraps
// the third-party PoseLib C++ library for LO-RANSAC pose/homography
// estimation; this framework ships its own native implementation instead of
// depending on it). Exposed through ctypes (no pybind11 in this image).
//
// Algorithms:
//  - homography: 4-point DLT hypotheses, MSAC scoring with symmetric
//    transfer error, iterative local optimization by weighted DLT on inliers;
//  - relative pose: 8-point essential hypotheses (normalized coords), MSAC
//    scoring with symmetric epipolar distance, cheirality-resolved
//    decomposition, LO refit.
//
// The port's copy of native/fastransac.cpp (the JAX package's), unchanged
// but for this note: gluefactory_tpu_torch/ops/_build.py::build_host builds
// it into build/torch_ext/ with the port's host flags (-ffp-contract=off),
// and robust_estimators/native.py binds it with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

// ----------------------------------------------------------------------
// small dense linear algebra (no external deps)
// ----------------------------------------------------------------------

// Jacobi eigen-decomposition of a symmetric n x n matrix (n <= 9).
void jacobi_eigen(double* A, int n, double* eigvals, double* eigvecs) {
  // eigvecs: n x n, columns are eigenvectors; A is destroyed.
  for (int i = 0; i < n * n; i++) eigvecs[i] = 0.0;
  for (int i = 0; i < n; i++) eigvecs[i * n + i] = 1.0;
  for (int sweep = 0; sweep < 100; sweep++) {
    double off = 0.0;
    for (int p = 0; p < n; p++)
      for (int q = p + 1; q < n; q++) off += A[p * n + q] * A[p * n + q];
    if (off < 1e-22) break;
    for (int p = 0; p < n; p++) {
      for (int q = p + 1; q < n; q++) {
        double apq = A[p * n + q];
        if (std::fabs(apq) < 1e-30) continue;
        double app = A[p * n + p], aqq = A[q * n + q];
        double theta = 0.5 * (aqq - app) / apq;
        double t = (theta >= 0 ? 1.0 : -1.0) /
                   (std::fabs(theta) + std::sqrt(theta * theta + 1.0));
        double c = 1.0 / std::sqrt(t * t + 1.0);
        double s = t * c;
        for (int k = 0; k < n; k++) {
          double akp = A[k * n + p], akq = A[k * n + q];
          A[k * n + p] = c * akp - s * akq;
          A[k * n + q] = s * akp + c * akq;
        }
        for (int k = 0; k < n; k++) {
          double apk = A[p * n + k], aqk = A[q * n + k];
          A[p * n + k] = c * apk - s * aqk;
          A[q * n + k] = s * apk + c * aqk;
        }
        for (int k = 0; k < n; k++) {
          double vkp = eigvecs[k * n + p], vkq = eigvecs[k * n + q];
          eigvecs[k * n + p] = c * vkp - s * vkq;
          eigvecs[k * n + q] = s * vkp + c * vkq;
        }
      }
    }
  }
  for (int i = 0; i < n; i++) eigvals[i] = A[i * n + i];
}

// smallest-eigenvector of AtA (n x n symmetric)
void smallest_eigvec(double* AtA, int n, double* out) {
  std::vector<double> vals(n), vecs(n * n);
  jacobi_eigen(AtA, n, vals.data(), vecs.data());
  int imin = 0;
  for (int i = 1; i < n; i++)
    if (vals[i] < vals[imin]) imin = i;
  for (int k = 0; k < n; k++) out[k] = vecs[k * n + imin];
}

// 3x3 SVD: V from the eigen decomposition of M^T M, then U = M V / S.
// Deriving U from M v_c (rather than an independent eigen decomposition of
// M M^T) is essential for correctness with REPEATED singular values — an
// essential matrix always has spectrum {s, s, 0}, where eigenvectors of
// M M^T and M^T M in the repeated subspace are individually arbitrary and
// would not correspond, silently corrupting U S V^T != M (and hence every
// recovered rotation). The M v_c images are automatically orthogonal
// because (M v_i)·(M v_j) = λ_j v_i·v_j = 0.
void svd3(const double* M, double* U, double* S, double* Vt) {
  double MtM[9];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      double a = 0;
      for (int k = 0; k < 3; k++) a += M[k * 3 + i] * M[k * 3 + j];
      MtM[i * 3 + j] = a;
    }
  double valsV[3], vecsV[9];
  double tmp[9];
  std::memcpy(tmp, MtM, sizeof(tmp));
  jacobi_eigen(tmp, 3, valsV, vecsV);
  int idxV[3] = {0, 1, 2};
  std::sort(idxV, idxV + 3, [&](int a, int b) { return valsV[a] > valsV[b]; });
  double u[3][3];
  for (int c = 0; c < 3; c++) {
    for (int r = 0; r < 3; r++) Vt[c * 3 + r] = vecsV[r * 3 + idxV[c]];
    double w[3];
    for (int r = 0; r < 3; r++) {
      double mv = 0;
      for (int k = 0; k < 3; k++) mv += M[r * 3 + k] * Vt[c * 3 + k];
      w[r] = mv;
    }
    S[c] = std::sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
    if (S[c] > 1e-12) {
      for (int r = 0; r < 3; r++) u[c][r] = w[r] / S[c];
    } else if (c == 2) {
      // null direction: cross product of the first two left vectors
      u[2][0] = u[0][1] * u[1][2] - u[0][2] * u[1][1];
      u[2][1] = u[0][2] * u[1][0] - u[0][0] * u[1][2];
      u[2][2] = u[0][0] * u[1][1] - u[0][1] * u[1][0];
    } else {
      // degenerate beyond rank 2: any unit vector orthogonal to previous
      double v0[3] = {1, 0, 0};
      if (c == 1) {
        double d = u[0][0];
        for (int r = 0; r < 3; r++) v0[r] -= d * u[0][r];
        double nn = std::sqrt(v0[0] * v0[0] + v0[1] * v0[1] + v0[2] * v0[2]);
        if (nn < 1e-12) { v0[0] = 0; v0[1] = 1; v0[2] = 0; nn = 1; }
        for (int r = 0; r < 3; r++) v0[r] /= nn;
      }
      for (int r = 0; r < 3; r++) u[c][r] = v0[r];
    }
  }
  for (int c = 0; c < 3; c++)
    for (int r = 0; r < 3; r++) U[r * 3 + c] = u[c][r];
}

double det3(const double* M) {
  return M[0] * (M[4] * M[8] - M[5] * M[7]) -
         M[1] * (M[3] * M[8] - M[5] * M[6]) +
         M[2] * (M[3] * M[7] - M[4] * M[6]);
}

// ----------------------------------------------------------------------
// 5-point essential minimal solver (Li–Hartley hidden variable — the same
// formulation as the batched XLA solver in gluefactory_tpu/ops/essential5.py:
// expand det(E)=0 and 2EE^T E - tr(EE^T)E = 0 over E = xB1+yB2+zB3+B4,
// regroup as a 10x10 matrix polynomial M(z) over the (x,y)-monomials, find
// the real roots of det M(z) by sign-scan + bisection, and read (x,y) from
// the null vector of M(z)). Fills the 5-point slot of the reference's
// poselib/cv2/pycolmap backends (reference relative_pose/opencv.py:31-40).
// ----------------------------------------------------------------------

// polynomials in (x, y, z) with exponents <= 3, dense over a 4x4x4 cube
struct Poly {
  double c[64];  // index = ex*16 + ey*4 + ez
  Poly() { std::memset(c, 0, sizeof(c)); }
};

inline Poly pmul(const Poly& a, const Poly& b) {
  Poly out;
  for (int i = 0; i < 64; i++) {
    if (a.c[i] == 0.0) continue;
    int ex = i >> 4, ey = (i >> 2) & 3, ez = i & 3;
    for (int j = 0; j < 64; j++) {
      if (b.c[j] == 0.0) continue;
      int fx = j >> 4, fy = (j >> 2) & 3, fz = j & 3;
      out.c[(ex + fx) * 16 + (ey + fy) * 4 + (ez + fz)] += a.c[i] * b.c[j];
    }
  }
  return out;
}

inline void padd(Poly& a, const Poly& b, double s) {
  for (int i = 0; i < 64; i++) a.c[i] += s * b.c[i];
}

// det sign of a 10x10 via partial-pivot LU (A destroyed)
inline int lu_sign10(double* A) {
  int sign = 1;
  for (int k = 0; k < 10; k++) {
    int piv = k;
    for (int r = k + 1; r < 10; r++)
      if (std::fabs(A[r * 10 + k]) > std::fabs(A[piv * 10 + k])) piv = r;
    if (std::fabs(A[piv * 10 + k]) < 1e-300) return 0;
    if (piv != k) {
      for (int c = 0; c < 10; c++) std::swap(A[k * 10 + c], A[piv * 10 + c]);
      sign = -sign;
    }
    if (A[k * 10 + k] < 0) sign = -sign;
    for (int r = k + 1; r < 10; r++) {
      double f = A[r * 10 + k] / A[k * 10 + k];
      for (int c = k; c < 10; c++) A[r * 10 + c] -= f * A[k * 10 + c];
    }
  }
  return sign;
}

struct FivePointTables {
  double M0[100], M1[100], M2[100], M3[100];  // z-degree slices of M(z)
};

inline void eval_Mz(const FivePointTables& T, double z, double* Mz) {
  for (int i = 0; i < 100; i++)
    Mz[i] = T.M0[i] + z * (T.M1[i] + z * (T.M2[i] + z * T.M3[i]));
}

inline int detsign_Mz(const FivePointTables& T, double z) {
  double Mz[100];
  eval_Mz(T, z, Mz);
  return lu_sign10(Mz);
}

// returns the number of candidate essential matrices written to E_out
// (each 9 doubles, row major, up to 10)
int essential_5pt(const double* p0, const double* p1, const int64_t* idx,
                  double* E_out) {
  // nullspace basis of the 5x9 epipolar system: 4 smallest eigvecs of AtA
  double AtA[81];
  std::memset(AtA, 0, sizeof(AtA));
  for (int k = 0; k < 5; k++) {
    int64_t i = idx[k];
    double x0 = p0[2 * i], y0 = p0[2 * i + 1];
    double x1 = p1[2 * i], y1 = p1[2 * i + 1];
    double row[9] = {x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, 1.0};
    for (int a = 0; a < 9; a++)
      for (int b = 0; b < 9; b++) AtA[a * 9 + b] += row[a] * row[b];
  }
  double vals[9], vecs[81];
  jacobi_eigen(AtA, 9, vals, vecs);
  int order[9];
  for (int i = 0; i < 9; i++) order[i] = i;
  std::sort(order, order + 9, [&](int a, int b) { return vals[a] < vals[b]; });
  double basis[4][9];  // B1..B4
  for (int k = 0; k < 4; k++)
    for (int r = 0; r < 9; r++) basis[k][r] = vecs[r * 9 + order[k]];

  // E entries as degree-1 polynomials: E = x B1 + y B2 + z B3 + B4
  Poly E[3][3];
  const int var_idx[4] = {1 * 16, 1 * 4, 1, 0};  // x, y, z, 1
  for (int r = 0; r < 3; r++)
    for (int c = 0; c < 3; c++)
      for (int k = 0; k < 4; k++) E[r][c].c[var_idx[k]] = basis[k][r * 3 + c];

  Poly constraints[10];
  // det(E)
  {
    Poly m01 = pmul(E[1][1], E[2][2]); padd(m01, pmul(E[1][2], E[2][1]), -1.0);
    Poly m11 = pmul(E[1][0], E[2][2]); padd(m11, pmul(E[1][2], E[2][0]), -1.0);
    Poly m21 = pmul(E[1][0], E[2][1]); padd(m21, pmul(E[1][1], E[2][0]), -1.0);
    Poly d = pmul(E[0][0], m01);
    padd(d, pmul(E[0][1], m11), -1.0);
    padd(d, pmul(E[0][2], m21), 1.0);
    constraints[0] = d;
  }
  // EE^T and its trace
  Poly EEt[3][3];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      Poly s = pmul(E[i][0], E[j][0]);
      padd(s, pmul(E[i][1], E[j][1]), 1.0);
      padd(s, pmul(E[i][2], E[j][2]), 1.0);
      EEt[i][j] = s;
    }
  Poly tr = EEt[0][0];
  padd(tr, EEt[1][1], 1.0);
  padd(tr, EEt[2][2], 1.0);
  // 2 EE^T E - tr(EE^T) E = 0
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      Poly acc = pmul(EEt[i][0], E[0][j]);
      padd(acc, pmul(EEt[i][1], E[1][j]), 1.0);
      padd(acc, pmul(EEt[i][2], E[2][j]), 1.0);
      for (int m = 0; m < 64; m++) acc.c[m] *= 2.0;
      padd(acc, pmul(tr, E[i][j]), -1.0);
      constraints[1 + i * 3 + j] = acc;
    }

  // z-degree slices over the (x,y)-monomial columns
  static const int XY[10][2] = {{3, 0}, {2, 1}, {1, 2}, {0, 3}, {2, 0},
                                {1, 1}, {0, 2}, {1, 0}, {0, 1}, {0, 0}};
  FivePointTables T;
  for (int r = 0; r < 10; r++) {
    // row normalization for conditioning (constraints are homogeneous)
    double nrm = 0;
    for (int m = 0; m < 64; m++) nrm += constraints[r].c[m] * constraints[r].c[m];
    nrm = std::sqrt(nrm) + 1e-300;
    for (int c = 0; c < 10; c++) {
      int mx = XY[c][0], my = XY[c][1];
      T.M0[r * 10 + c] = constraints[r].c[mx * 16 + my * 4 + 0] / nrm;
      T.M1[r * 10 + c] = constraints[r].c[mx * 16 + my * 4 + 1] / nrm;
      T.M2[r * 10 + c] = constraints[r].c[mx * 16 + my * 4 + 2] / nrm;
      T.M3[r * 10 + c] = constraints[r].c[mx * 16 + my * 4 + 3] / nrm;
    }
  }

  // real roots of det M(z): sign scan on a tan-warped grid + bisection
  const int GRID = 512;
  const double EPS = 1e-3;
  int n_roots = 0;
  double prev_theta = -M_PI / 2 + EPS;
  int prev_sign = detsign_Mz(T, std::tan(prev_theta));
  for (int g = 1; g < GRID && n_roots < 10; g++) {
    double theta = -M_PI / 2 + EPS +
                   (M_PI - 2 * EPS) * (double)g / (double)(GRID - 1);
    int s = detsign_Mz(T, std::tan(theta));
    if (s * prev_sign <= 0 && prev_sign != 0) {
      double lo = prev_theta, hi = theta;
      for (int b = 0; b < 60; b++) {
        double mid = 0.5 * (lo + hi);
        int sm = detsign_Mz(T, std::tan(mid));
        if (sm == prev_sign)
          lo = mid;
        else
          hi = mid;
      }
      double z = std::tan(0.5 * (lo + hi));
      // null vector of M(z) via smallest eigvec of M^T M
      double Mz[100];
      eval_Mz(T, z, Mz);
      double MtM[100];
      for (int a = 0; a < 10; a++)
        for (int b = 0; b < 10; b++) {
          double acc = 0;
          for (int k = 0; k < 10; k++) acc += Mz[k * 10 + a] * Mz[k * 10 + b];
          MtM[a * 10 + b] = acc;
        }
      double v[10];
      smallest_eigvec(MtM, 10, v);
      double w = v[9];
      if (std::fabs(w) > 1e-12) {
        double x = v[7] / w, y = v[8] / w;
        double* Ec = E_out + 9 * n_roots;
        double nrm = 0;
        for (int m = 0; m < 9; m++) {
          Ec[m] = x * basis[0][m] + y * basis[1][m] + z * basis[2][m] +
                  basis[3][m];
          nrm += Ec[m] * Ec[m];
        }
        nrm = std::sqrt(nrm) + 1e-300;
        for (int m = 0; m < 9; m++) Ec[m] /= nrm;
        n_roots++;
      }
    }
    prev_sign = s != 0 ? s : prev_sign;
    prev_theta = theta;
  }
  return n_roots;
}

// ----------------------------------------------------------------------
// homography
// ----------------------------------------------------------------------

// weighted DLT from n correspondences; returns false if degenerate.
bool homography_dlt(const double* p0, const double* p1, const double* w, int n,
                    double* H) {
  // Hartley normalization
  double m0x = 0, m0y = 0, m1x = 0, m1y = 0, wsum = 0;
  for (int i = 0; i < n; i++) {
    double wi = w ? w[i] : 1.0;
    m0x += wi * p0[2 * i];
    m0y += wi * p0[2 * i + 1];
    m1x += wi * p1[2 * i];
    m1y += wi * p1[2 * i + 1];
    wsum += wi;
  }
  if (wsum < 4) return false;
  m0x /= wsum; m0y /= wsum; m1x /= wsum; m1y /= wsum;
  double d0 = 0, d1 = 0;
  for (int i = 0; i < n; i++) {
    double wi = w ? w[i] : 1.0;
    d0 += wi * std::hypot(p0[2 * i] - m0x, p0[2 * i + 1] - m0y);
    d1 += wi * std::hypot(p1[2 * i] - m1x, p1[2 * i + 1] - m1y);
  }
  double s0 = std::sqrt(2.0) * wsum / std::max(d0, 1e-12);
  double s1 = std::sqrt(2.0) * wsum / std::max(d1, 1e-12);

  double AtA[81];
  std::memset(AtA, 0, sizeof(AtA));
  for (int i = 0; i < n; i++) {
    double wi = w ? w[i] : 1.0;
    if (wi <= 0) continue;
    double x = (p0[2 * i] - m0x) * s0, y = (p0[2 * i + 1] - m0y) * s0;
    double u = (p1[2 * i] - m1x) * s1, v = (p1[2 * i + 1] - m1y) * s1;
    double r1[9] = {0, 0, 0, -x, -y, -1, v * x, v * y, v};
    double r2[9] = {x, y, 1, 0, 0, 0, -u * x, -u * y, -u};
    for (int a = 0; a < 9; a++)
      for (int b = 0; b < 9; b++)
        AtA[a * 9 + b] += wi * (r1[a] * r1[b] + r2[a] * r2[b]);
  }
  double h[9];
  smallest_eigvec(AtA, 9, h);
  // denormalize: H = T1^-1 Hn T0 with T = [s, 0, -s*mx; 0, s, -s*my; 0,0,1]
  double Hn[9];
  std::memcpy(Hn, h, sizeof(Hn));
  double T0[9] = {s0, 0, -s0 * m0x, 0, s0, -s0 * m0y, 0, 0, 1};
  double T1inv[9] = {1 / s1, 0, m1x, 0, 1 / s1, m1y, 0, 0, 1};
  double tmp2[9], Hout[9];
  for (int r = 0; r < 3; r++)
    for (int c = 0; c < 3; c++) {
      double a = 0;
      for (int k = 0; k < 3; k++) a += Hn[r * 3 + k] * T0[k * 3 + c];
      tmp2[r * 3 + c] = a;
    }
  for (int r = 0; r < 3; r++)
    for (int c = 0; c < 3; c++) {
      double a = 0;
      for (int k = 0; k < 3; k++) a += T1inv[r * 3 + k] * tmp2[k * 3 + c];
      Hout[r * 3 + c] = a;
    }
  if (std::fabs(Hout[8]) < 1e-15) return false;
  for (int i = 0; i < 9; i++) H[i] = Hout[i] / Hout[8];
  return true;
}

inline bool invert3(const double* H, double* Hi) {
  double d = det3(H);
  if (std::fabs(d) < 1e-18) return false;
  double inv[9] = {
      H[4] * H[8] - H[5] * H[7], H[2] * H[7] - H[1] * H[8], H[1] * H[5] - H[2] * H[4],
      H[5] * H[6] - H[3] * H[8], H[0] * H[8] - H[2] * H[6], H[2] * H[3] - H[0] * H[5],
      H[3] * H[7] - H[4] * H[6], H[1] * H[6] - H[0] * H[7], H[0] * H[4] - H[1] * H[3]};
  for (int i = 0; i < 9; i++) Hi[i] = inv[i] / d;
  return true;
}

inline void warp(const double* H, double x, double y, double* ox, double* oy) {
  double z = H[6] * x + H[7] * y + H[8];
  *ox = (H[0] * x + H[1] * y + H[2]) / z;
  *oy = (H[3] * x + H[4] * y + H[5]) / z;
}

// symmetric transfer error^2
double sym_err2(const double* H, const double* Hi, const double* p0,
                const double* p1, int i) {
  double fx, fy, bx, by;
  warp(H, p0[2 * i], p0[2 * i + 1], &fx, &fy);
  warp(Hi, p1[2 * i], p1[2 * i + 1], &bx, &by);
  double e0 = (fx - p1[2 * i]) * (fx - p1[2 * i]) +
              (fy - p1[2 * i + 1]) * (fy - p1[2 * i + 1]);
  double e1 = (bx - p0[2 * i]) * (bx - p0[2 * i]) +
              (by - p0[2 * i + 1]) * (by - p0[2 * i + 1]);
  return 0.5 * (e0 + e1);
}

}  // namespace

extern "C" {

// Returns number of inliers; H_out (9), inliers (n) 0/1.
int64_t ransac_homography_cpp(const double* p0, const double* p1, int64_t n,
                              double th, int64_t max_iters, uint64_t seed,
                              double* H_out, uint8_t* inliers) {
  if (n < 4) return 0;
  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<int64_t> uni(0, n - 1);
  const double th2 = th * th;
  double best_score = -1.0;
  double best_H[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};

  for (int64_t it = 0; it < max_iters; it++) {
    int64_t idx[4];
    for (int k = 0; k < 4; k++) {
      bool dup = true;
      while (dup) {
        idx[k] = uni(rng);
        dup = false;
        for (int j = 0; j < k; j++) dup |= (idx[j] == idx[k]);
      }
    }
    double s0[8], s1[8];
    for (int k = 0; k < 4; k++) {
      s0[2 * k] = p0[2 * idx[k]];
      s0[2 * k + 1] = p0[2 * idx[k] + 1];
      s1[2 * k] = p1[2 * idx[k]];
      s1[2 * k + 1] = p1[2 * idx[k] + 1];
    }
    double H[9], Hi[9];
    if (!homography_dlt(s0, s1, nullptr, 4, H)) continue;
    if (!invert3(H, Hi)) continue;
    // MSAC score
    double score = 0;
    for (int64_t i = 0; i < n; i++) {
      double e = sym_err2(H, Hi, p0, p1, i);
      score += std::max(0.0, 1.0 - e / th2);
    }
    if (score > best_score) {
      best_score = score;
      std::memcpy(best_H, H, sizeof(best_H));
    }
  }

  // local optimization: weighted refit on inliers, 3 rounds
  std::vector<double> w(n);
  for (int lo = 0; lo < 3; lo++) {
    double Hi[9];
    if (!invert3(best_H, Hi)) break;
    int64_t cnt = 0;
    for (int64_t i = 0; i < n; i++) {
      double e = sym_err2(best_H, Hi, p0, p1, i);
      w[i] = e < th2 ? 1.0 : 0.0;
      cnt += (int64_t)w[i];
    }
    if (cnt < 4) break;
    double H[9];
    if (!homography_dlt(p0, p1, w.data(), (int)n, H)) break;
    std::memcpy(best_H, H, sizeof(best_H));
  }

  double Hi[9];
  int64_t num = 0;
  if (invert3(best_H, Hi)) {
    for (int64_t i = 0; i < n; i++) {
      bool in = sym_err2(best_H, Hi, p0, p1, i) < th2;
      inliers[i] = in ? 1 : 0;
      num += in;
    }
  }
  std::memcpy(H_out, best_H, sizeof(best_H));
  return num;
}

// Essential RANSAC over normalized coords: 5-point minimal hypotheses
// (hidden-variable solver above — matching the reference's cv2/poselib/
// pycolmap 5-point backends), MSAC scoring, weighted 8-point LO refit,
// cheirality-resolved decomposition. Returns num inliers.
// R_out (9), t_out (3), inliers (n).
int64_t ransac_essential_cpp(const double* p0, const double* p1, int64_t n,
                             double th, int64_t max_iters, uint64_t seed,
                             double* R_out, double* t_out, uint8_t* inliers) {
  if (n < 5) return 0;
  std::mt19937_64 rng(seed);
  std::uniform_int_distribution<int64_t> uni(0, n - 1);
  const double th2 = th * th;

  auto epi_err2 = [&](const double* E, int64_t i) {
    double x0 = p0[2 * i], y0 = p0[2 * i + 1];
    double x1 = p1[2 * i], y1 = p1[2 * i + 1];
    double Ep0[3] = {E[0] * x0 + E[1] * y0 + E[2], E[3] * x0 + E[4] * y0 + E[5],
                     E[6] * x0 + E[7] * y0 + E[8]};
    double Etp1[3] = {E[0] * x1 + E[3] * y1 + E[6], E[1] * x1 + E[4] * y1 + E[7],
                      E[2] * x1 + E[5] * y1 + E[8]};
    double num = x1 * Ep0[0] + y1 * Ep0[1] + Ep0[2];
    num = num * num;
    return num * (1.0 / (Ep0[0] * Ep0[0] + Ep0[1] * Ep0[1] + 1e-15) +
                  1.0 / (Etp1[0] * Etp1[0] + Etp1[1] * Etp1[1] + 1e-15));
  };

  auto solve_E = [&](const int64_t* idx, int count, const double* wts,
                     double* E) {
    double AtA[81];
    std::memset(AtA, 0, sizeof(AtA));
    for (int k = 0; k < count; k++) {
      int64_t i = idx ? idx[k] : k;
      double wi = wts ? wts[i] : 1.0;
      if (wi <= 0) continue;
      double x0 = p0[2 * i], y0 = p0[2 * i + 1];
      double x1 = p1[2 * i], y1 = p1[2 * i + 1];
      double row[9] = {x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, 1.0};
      for (int a = 0; a < 9; a++)
        for (int b = 0; b < 9; b++) AtA[a * 9 + b] += wi * row[a] * row[b];
    }
    double e[9];
    smallest_eigvec(AtA, 9, e);
    // project to essential manifold
    double U[9], S[3], Vt[9];
    svd3(e, U, S, Vt);
    for (int r = 0; r < 3; r++)
      for (int c = 0; c < 3; c++)
        E[r * 3 + c] = U[r * 3 + 0] * Vt[0 * 3 + c] + U[r * 3 + 1] * Vt[1 * 3 + c];
  };

  double best_score = -1.0;
  double best_E[9] = {0, 0, 0, 0, 0, 1, 0, -1, 0};
  // adaptive termination at 99.9% confidence (standard RANSAC stopping:
  // enough samples that an all-inlier 5-tuple was drawn w.h.p.)
  int64_t needed_iters = max_iters;
  const double kLogOneMinusConf = std::log(1e-3);
  for (int64_t it = 0; it < max_iters && it < needed_iters; it++) {
    int64_t idx[5];
    for (int k = 0; k < 5; k++) {
      bool dup = true;
      while (dup) {
        idx[k] = uni(rng);
        dup = false;
        for (int j = 0; j < k; j++) dup |= (idx[j] == idx[k]);
      }
    }
    double E_cands[90];
    int n_cands = essential_5pt(p0, p1, idx, E_cands);
    for (int c = 0; c < n_cands; c++) {
      const double* E = E_cands + 9 * c;
      double score = 0;
      for (int64_t i = 0; i < n; i++)
        score += std::max(0.0, 1.0 - epi_err2(E, i) / th2);
      if (score > best_score) {
        best_score = score;
        std::memcpy(best_E, E, sizeof(best_E));
        int64_t cnt = 0;
        for (int64_t i = 0; i < n; i++) cnt += epi_err2(E, i) < th2;
        double w = (double)cnt / (double)n;
        double p_good = std::pow(w, 5);
        if (p_good > 1e-12) {
          double denom = std::log(std::max(1.0 - p_good, 1e-12));
          needed_iters = (int64_t)std::ceil(kLogOneMinusConf / denom);
        }
      }
    }
  }

  // LO: weighted refit on inliers
  std::vector<double> w(n);
  for (int lo = 0; lo < 2; lo++) {
    int64_t cnt = 0;
    for (int64_t i = 0; i < n; i++) {
      w[i] = epi_err2(best_E, i) < th2 ? 1.0 : 0.0;
      cnt += (int64_t)w[i];
    }
    if (cnt < 8) break;
    double E[9];
    solve_E(nullptr, (int)n, w.data(), E);
    std::memcpy(best_E, E, sizeof(best_E));
  }

  // decompose with cheirality
  double U[9], S[3], Vt[9];
  svd3(best_E, U, S, Vt);
  if (det3(U) < 0)
    for (int i = 0; i < 9; i++) U[i] = (i % 3 == 2) ? -U[i] : U[i];
  // recompute determinant properly: flip last column if det < 0
  {
    double dU = det3(U);
    if (dU < 0)
      for (int r = 0; r < 3; r++) U[r * 3 + 2] = -U[r * 3 + 2];
    double dV = det3(Vt);
    if (dV < 0)
      for (int c = 0; c < 3; c++) Vt[2 * 3 + c] = -Vt[2 * 3 + c];
  }
  double W[9] = {0, -1, 0, 1, 0, 0, 0, 0, 1};
  double R1[9], R2[9];
  auto matmul3 = [](const double* A, const double* B, double* C) {
    for (int r = 0; r < 3; r++)
      for (int c = 0; c < 3; c++) {
        double a = 0;
        for (int k = 0; k < 3; k++) a += A[r * 3 + k] * B[k * 3 + c];
        C[r * 3 + c] = a;
      }
  };
  double UW[9], UWt[9];
  matmul3(U, W, UW);
  double Wt[9] = {0, 1, 0, -1, 0, 0, 0, 0, 1};
  matmul3(U, Wt, UWt);
  matmul3(UW, Vt, R1);
  matmul3(UWt, Vt, R2);
  double t[3] = {U[2], U[5], U[8]};

  double bestRt_score = -1;
  double Rbest[9], tbest[3];
  const double* Rcands[2] = {R1, R2};
  for (int rc = 0; rc < 2; rc++)
    for (int sgn = -1; sgn <= 1; sgn += 2) {
      const double* R = Rcands[rc];
      double tc[3] = {sgn * t[0], sgn * t[1], sgn * t[2]};
      int64_t pos = 0;
      for (int64_t i = 0; i < n; i++) {
        if (epi_err2(best_E, i) >= th2) continue;
        // triangulate depth signs (least squares on z0, z1)
        double r0[3] = {p0[2 * i], p0[2 * i + 1], 1.0};
        double r1v[3] = {p1[2 * i], p1[2 * i + 1], 1.0};
        double Rr0[3];
        for (int r = 0; r < 3; r++)
          Rr0[r] = R[r * 3] * r0[0] + R[r * 3 + 1] * r0[1] + R[r * 3 + 2] * r0[2];
        double a11 = 0, a12 = 0, a22 = 0, b1 = 0, b2 = 0;
        for (int k = 0; k < 3; k++) {
          a11 += Rr0[k] * Rr0[k];
          a12 += -Rr0[k] * r1v[k];
          a22 += r1v[k] * r1v[k];
          b1 += -Rr0[k] * tc[k];
          b2 += r1v[k] * tc[k];
        }
        double det = a11 * a22 - a12 * a12;
        if (std::fabs(det) < 1e-15) continue;
        double z0 = (b1 * a22 - b2 * a12) / det;
        double z1 = (a11 * b2 - a12 * b1) / det;
        if (z0 > 0 && z1 > 0) pos++;
      }
      if ((double)pos > bestRt_score) {
        bestRt_score = (double)pos;
        std::memcpy(Rbest, R, sizeof(Rbest));
        std::memcpy(tbest, tc, sizeof(tbest));
      }
    }

  int64_t num = 0;
  for (int64_t i = 0; i < n; i++) {
    bool in = epi_err2(best_E, i) < th2;
    inliers[i] = in ? 1 : 0;
    num += in;
  }
  std::memcpy(R_out, Rbest, sizeof(Rbest));
  std::memcpy(t_out, tbest, sizeof(tbest));
  return num;
}

}  // extern "C"
