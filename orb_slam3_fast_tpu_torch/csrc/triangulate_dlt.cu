// Kernel G: batched DLT triangulation, one thread per match: the 4x4 A of
// GeometricTools::Triangulate in float32, A^T A in float64, cyclic Jacobi
// until converged, X = v[:3] / v[3] for the least eigenvalue's vector.  See
// the source note in ops/twoview.py; triangulate_dlt_plain there is the SVD
// form.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSweeps = 30;

__device__ __forceinline__ void rotate(double (&B)[4][4], double (&V)[4][4], int p, int q) {
  const double bpq = B[p][q];
  if (fabs(bpq) < 1e-300) return;
  const double theta = (B[q][q] - B[p][p]) / (2.0 * bpq);
  const double t = (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + sqrt(theta * theta + 1.0));
  const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // B <- B J
    const double bkp = B[k][p], bkq = B[k][q];
    B[k][p] = c * bkp - s * bkq;
    B[k][q] = s * bkp + c * bkq;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // B <- J^T B
    const double bpk = B[p][k], bqk = B[q][k];
    B[p][k] = c * bpk - s * bqk;
    B[q][k] = s * bpk + c * bqk;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // V <- V J
    const double vkp = V[k][p], vkq = V[k][q];
    V[k][p] = c * vkp - s * vkq;
    V[k][q] = s * vkp + c * vkq;
  }
}

__global__ void __launch_bounds__(kThreads)
triangulate_dlt_kernel(const float* __restrict__ P0, const float* __restrict__ P1,
                       const float* __restrict__ x0, const float* __restrict__ x1, int n,
                       float* __restrict__ X) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  // rows of A in float32, as the reference forms them: x * P[2] - P[r]
  const float u0 = x0[2 * i], v0 = x0[2 * i + 1], u1 = x1[2 * i], v1 = x1[2 * i + 1];
  double A[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    A[0][c] = __fsub_rn(__fmul_rn(u0, P0[8 + c]), P0[c]);
    A[1][c] = __fsub_rn(__fmul_rn(v0, P0[8 + c]), P0[4 + c]);
    A[2][c] = __fsub_rn(__fmul_rn(u1, P1[8 + c]), P1[c]);
    A[3][c] = __fsub_rn(__fmul_rn(v1, P1[8 + c]), P1[4 + c]);
  }
  double B[4][4], V[4][4];
  double diag2 = 0.0;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      double s = 0.0;
#pragma unroll
      for (int k = 0; k < 4; ++k) s += A[k][r] * A[k][c];
      B[r][c] = s;
      V[r][c] = r == c ? 1.0 : 0.0;
    }
#pragma unroll
  for (int r = 0; r < 4; ++r) diag2 += B[r][r] * B[r][r];
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    double off = 0.0;
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = p + 1; q < 4; ++q) off += B[p][q] * B[p][q];
    if (off <= 1e-32 * diag2) break;
    rotate(B, V, 0, 1);
    rotate(B, V, 0, 2);
    rotate(B, V, 0, 3);
    rotate(B, V, 1, 2);
    rotate(B, V, 1, 3);
    rotate(B, V, 2, 3);
  }
  // the eigenvector of the least eigenvalue (constant indices keep V in registers)
  double best = B[0][0], v[4] = {V[0][0], V[1][0], V[2][0], V[3][0]};
#pragma unroll
  for (int r = 1; r < 4; ++r)
    if (B[r][r] < best) {
      best = B[r][r];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = V[k][r];
    }
  const double w = fabs(v[3]) < 1e-12 ? 1e-12 : v[3];
  X[3 * i] = (float)(v[0] / w);
  X[3 * i + 1] = (float)(v[1] / w);
  X[3 * i + 2] = (float)(v[2] / w);
}

}  // namespace

extern "C" int triangulate_dlt_launch(const float* P0, const float* P1, const float* x0,
                                      const float* x1, int n, float* X, void* stream) {
  if (n > 0) {
    const int grid = (n + kThreads - 1) / kThreads;
    triangulate_dlt_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P0, P1, x0, x1,
                                                                                      n, X);
  }
  return cudaGetLastError();
}
