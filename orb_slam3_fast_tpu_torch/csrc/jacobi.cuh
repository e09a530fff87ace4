// The port's one symmetric eigen-solver and the small dense routines built on
// it, for one thread in float64: cyclic Jacobi on an n x n symmetric matrix
// (n <= 12), the least eigenvector of A^T A (the right singular vector of
// A's least singular value: the null vector of a DLT system), a 3x3 SVD with
// the singular values in descending order as an SVD returns them, the 4x4
// DLT triangulation of GeometricTools::Triangulate, a 6x6 Cholesky solve and
// the SO(3) exponential.  Kernels G (triangulate_dlt.cu), M
// (twoview_ransac.cu) and P (pnp_ransac.cu) include it.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace jacobi {

constexpr int kMaxSweeps = 30;

// One rotation J(p, q) that zeroes B[p][q]: B <- J^T B J, V <- V J.
template <int N>
__device__ __forceinline__ void rotate(double (&B)[N][N], double (&V)[N][N], int p, int q) {
  const double bpq = B[p][q];
  if (fabs(bpq) < 1e-300) return;
  const double theta = (B[q][q] - B[p][p]) / (2.0 * bpq);
  const double t = (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + sqrt(theta * theta + 1.0));
  const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
#pragma unroll
  for (int k = 0; k < N; ++k) {  // B <- B J
    const double bkp = B[k][p], bkq = B[k][q];
    B[k][p] = c * bkp - s * bkq;
    B[k][q] = s * bkp + c * bkq;
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {  // B <- J^T B
    const double bpk = B[p][k], bqk = B[q][k];
    B[p][k] = c * bpk - s * bqk;
    B[q][k] = s * bpk + c * bqk;
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {  // V <- V J
    const double vkp = V[k][p], vkq = V[k][q];
    V[k][p] = c * vkp - s * vkq;
    V[k][q] = s * vkp + c * vkq;
  }
}

// Cyclic Jacobi: B (symmetric) becomes diagonal to working precision, its
// diagonal the eigenvalues, V's columns the eigenvectors.  Sweeps stop when
// the off-diagonal squares fall below 1e-32 of the diagonal's (at most 30).
// The 4x4 case is unrolled whole so that B and V stay in registers.
template <int N>
__device__ void eigen_sym(double (&B)[N][N], double (&V)[N][N]) {
  double diag2 = 0.0;
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int c = 0; c < N; ++c) V[r][c] = r == c ? 1.0 : 0.0;
    diag2 += B[r][r] * B[r][r];
  }
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0;
#pragma unroll
    for (int p = 0; p < N; ++p)
#pragma unroll
      for (int q = p + 1; q < N; ++q) off += B[p][q] * B[p][q];
    if (off <= 1e-32 * diag2) break;
    if constexpr (N <= 4) {
#pragma unroll
      for (int p = 0; p < N; ++p)
#pragma unroll
        for (int q = p + 1; q < N; ++q) rotate(B, V, p, q);
    } else {
      for (int p = 0; p < N; ++p)
        for (int q = p + 1; q < N; ++q) rotate(B, V, p, q);
    }
  }
}

// The eigenvector of the least eigenvalue of symmetric M (the first on ties).
template <int N>
__device__ void least_eigvec(const double (&M)[N][N], double (&v)[N]) {
  double B[N][N], V[N][N];
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c) B[r][c] = M[r][c];
  eigen_sym(B, V);
  int best = 0;
#pragma unroll
  for (int r = 1; r < N; ++r)
    if (B[r][r] < B[best][best]) best = r;
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = V[k][best];
}

// SVD of a 3x3 M = U diag(s) V^T, s descending: V and s^2 from the eigen-
// decomposition of M^T M, U's first two columns M v / s, the third u0 x u1
// with the sign of M v2 (its sign is free where s2 = 0).
__device__ inline void svd3(const double (&M)[3][3], double (&U)[3][3], double (&s)[3], double (&V)[3][3]) {
  double B[3][3], E[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) B[r][c] = M[0][r] * M[0][c] + M[1][r] * M[1][c] + M[2][r] * M[2][c];
  eigen_sym(B, E);
  int order[3] = {0, 1, 2};
  for (int a = 0; a < 3; ++a)  // descending eigenvalues, the lower index first on ties
    for (int b = a + 1; b < 3; ++b)
      if (B[order[b]][order[b]] > B[order[a]][order[a]]) {
        const int tmp = order[a];
        order[a] = order[b];
        order[b] = tmp;
      }
  double Mv[3][3];
  for (int i = 0; i < 3; ++i) {
    s[i] = sqrt(fmax(B[order[i]][order[i]], 0.0));
    for (int r = 0; r < 3; ++r) V[r][i] = E[r][order[i]];
    for (int r = 0; r < 3; ++r) Mv[r][i] = M[r][0] * V[0][i] + M[r][1] * V[1][i] + M[r][2] * V[2][i];
  }
  for (int i = 0; i < 2; ++i) {
    const double inv = 1.0 / fmax(s[i], 1e-300);
    for (int r = 0; r < 3; ++r) U[r][i] = Mv[r][i] * inv;
  }
  double u2[3] = {U[1][0] * U[2][1] - U[2][0] * U[1][1], U[2][0] * U[0][1] - U[0][0] * U[2][1],
                  U[0][0] * U[1][1] - U[1][0] * U[0][1]};
  const double sgn = (u2[0] * Mv[0][2] + u2[1] * Mv[1][2] + u2[2] * Mv[2][2]) < 0.0 ? -1.0 : 1.0;
  for (int r = 0; r < 3; ++r) U[r][2] = sgn * u2[r];
}

__device__ inline double det3(const double (&A)[3][3]) {
  return A[0][0] * (A[1][1] * A[2][2] - A[1][2] * A[2][1]) - A[0][1] * (A[1][0] * A[2][2] - A[1][2] * A[2][0]) +
         A[0][2] * (A[1][0] * A[2][1] - A[1][1] * A[2][0]);
}

// R = U diag(1, 1, d) V^T.
__device__ inline void udv(const double (&U)[3][3], double d, const double (&V)[3][3], double (&R)[3][3]) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) R[r][c] = U[r][0] * V[c][0] + U[r][1] * V[c][1] + d * U[r][2] * V[c][2];
}

// Triangulation of one match from two 3x4 projections (row-major float):
// the 4x4 A of GeometricTools::Triangulate in float32, A^T A in float64, its
// least eigenvector v, X = v[:3] / v[3] with |v[3]| < 1e-12 held at 1e-12.
__device__ inline void dlt_triangulate(const float* __restrict__ P0, const float* __restrict__ P1, float u0,
                                       float v0, float u1, float v1, float (&X)[3]) {
  double A[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    A[0][c] = __fsub_rn(__fmul_rn(u0, P0[8 + c]), P0[c]);
    A[1][c] = __fsub_rn(__fmul_rn(v0, P0[8 + c]), P0[4 + c]);
    A[2][c] = __fsub_rn(__fmul_rn(u1, P1[8 + c]), P1[c]);
    A[3][c] = __fsub_rn(__fmul_rn(v1, P1[8 + c]), P1[4 + c]);
  }
  double B[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      double s = 0.0;
#pragma unroll
      for (int k = 0; k < 4; ++k) s += A[k][r] * A[k][c];
      B[r][c] = s;
    }
  double v[4];
  least_eigvec(B, v);
  const double w = fabs(v[3]) < 1e-12 ? 1e-12 : v[3];
  X[0] = (float)(v[0] / w);
  X[1] = (float)(v[1] / w);
  X[2] = (float)(v[2] / w);
}

// Solve H x = b for symmetric positive definite 6x6 H (Cholesky, float64).
__device__ inline void cholesky_solve6(const double (&H)[6][6], const double (&b)[6], double (&x)[6]) {
  double L[6][6] = {};
  for (int j = 0; j < 6; ++j) {
    double d = H[j][j];
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    L[j][j] = sqrt(fmax(d, 1e-300));
    for (int i = j + 1; i < 6; ++i) {
      double v = H[i][j];
      for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
      L[i][j] = v / L[j][j];
    }
  }
  double y[6];
  for (int i = 0; i < 6; ++i) {
    double v = b[i];
    for (int k = 0; k < i; ++k) v -= L[i][k] * y[k];
    y[i] = v / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    double v = y[i];
    for (int k = i + 1; k < 6; ++k) v -= L[k][i] * x[k];
    x[i] = v / L[i][i];
  }
}

// Rodrigues, as utils/lie.so3_exp (Taylor terms below theta^2 = 1e-8).
__device__ inline void so3_exp(const double (&w)[3], double (&R)[3][3]) {
  const double th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const double th = sqrt(fmax(th2, 1e-16));
  const bool small = th2 < 1e-8;
  const double a = small ? 1.0 - th2 / 6.0 : sin(th) / th;
  const double b = small ? 0.5 - th2 / 24.0 : (1.0 - cos(th)) / fmax(th2, 1e-16);
  const double W[3][3] = {{0.0, -w[2], w[1]}, {w[2], 0.0, -w[0]}, {-w[1], w[0], 0.0}};
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      double w2 = 0.0;
      for (int k = 0; k < 3; ++k) w2 += W[r][k] * W[k][c];
      R[r][c] = (r == c ? 1.0 : 0.0) + a * W[r][c] + b * w2;
    }
}

// Sum of v over the block (blockDim.x a multiple of 32, at most 1024),
// returned to every thread; ``sh`` holds 33 doubles of shared memory.
__device__ inline double block_sum(double v, double* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // the previous call's readers are done with sh
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double w = lane < (int)(blockDim.x >> 5) ? sh[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w += __shfl_xor_sync(0xFFFFFFFFu, w, o);
    if (lane == 0) sh[32] = w;
  }
  __syncthreads();
  return sh[32];
}

}  // namespace jacobi
