// Kernel S: Gauss-Newton on the Sim3 essential graph (dense normal
// equations, K <= 128 vertices), three launches per iteration from one C
// entry point.
//  1. One warp per edge: lane d < 14 evaluates the edge residual
//     log(S_ij^-1 exp(dx_i) S_i (exp(dx_j) S_j)^-1) at dx = 0 in float64
//     dual numbers whose tangent is direction d (dx_i's for d < 7, dx_j's
//     after): the value is r, the tangent column d of J_i or J_j.
//  2. One CTA: the (7K)^2 normal matrix in global memory, the edges added in
//     their order (each its four 7x7 blocks and two gradient pieces), the
//     fixed vertices' rows and columns made the identity, 1e-6 I added; a
//     right-looking float64 Cholesky, column by column, and the two
//     substitutions for dx.  A pivot <= 0 sets the flag and zeroes dx.
//  3. One thread per vertex: S <- sim3_exp(dx) S, R re-orthonormalised.
// Every sum has a fixed order, so a run repeats bit for bit.  See the source
// note in optim/pose_graph.py; optimize_sim3_graph_plain there is the same
// function in PyTorch.
#include <cuda_runtime.h>
#include <math.h>

#include "jacobi.cuh"
#include "sim3.cuh"

namespace {

constexpr int kSolveThreads = 1024;
constexpr int kMaxVertices = 128;  // the dense branch's limit, pose_graph.DENSE_MAX_K
constexpr int kEdgeWarps = 8;

__global__ void __launch_bounds__(32 * kEdgeWarps)
edge_kernel(const float* __restrict__ verts, const int* __restrict__ ei, const int* __restrict__ ej,
            const float* __restrict__ meas, int n_edges, double* __restrict__ jac) {
  const int e = blockIdx.x * kEdgeWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= n_edges || lane >= 14) return;
  // jac[e]: r (7) | J_i^T (7x7, row = direction) | J_j^T
  double* out = jac + 105 * e;
  sim3::edge_lane(verts + 13 * ei[e], verts + 13 * ej[e], meas + 13 * e, lane, out + 7 + 7 * lane,
                  lane == 0 ? out : nullptr);
}

__global__ void __launch_bounds__(kSolveThreads)
solve_kernel(const int* __restrict__ ei, const int* __restrict__ ej, const float* __restrict__ w,
             const bool* __restrict__ fixed, int K, int n_edges, double damping, const double* __restrict__ jac,
             double* __restrict__ H, double* __restrict__ vec, int* __restrict__ fail) {
  const int n = 7 * K;
  double* b = vec;
  double* x = vec + n;
  __shared__ bool bad;
  __shared__ double xj;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < n * n; idx += kSolveThreads) H[idx] = 0.0;
  for (int idx = tid; idx < n; idx += kSolveThreads) b[idx] = 0.0;
  if (tid == 0) bad = false;
  __syncthreads();
  for (int e = 0; e < n_edges; ++e) {  // the edges in their order
    const double we = w[e];
    if (we != 0.0) {
      const double* J = jac + 105 * e;  // J_i^T at J + 7, J_j^T at J + 56: [direction][residual row]
      const int vi = ei[e], vj = ej[e];
      if (tid < 196) {
        const int blk = tid / 49, p = (tid % 49) / 7, q = tid % 7;
        const double* A = J + 7 + 49 * (blk == 1 || blk == 3);  // ii, jj, ij, ji: the row side
        const double* B = J + 7 + 49 * (blk == 1 || blk == 2);  // the column side
        double v = 0.0;
        for (int r = 0; r < 7; ++r) v += A[7 * p + r] * we * B[7 * q + r];
        const int a = (blk == 1 || blk == 3) ? vj : vi, c = (blk == 1 || blk == 2) ? vj : vi;
        H[(size_t)(7 * a + p) * n + 7 * c + q] += v;
      } else if (tid < 210) {
        const int side = (tid - 196) / 7, p = (tid - 196) % 7;
        const double* A = J + 7 + 49 * side;
        double v = 0.0;
        for (int r = 0; r < 7; ++r) v += A[7 * p + r] * we * J[r];
        b[7 * (side ? vj : vi) + p] += v;
      }
    }
    __syncthreads();
  }
  // gauge: fixed vertices' rows and columns become the identity; damping
  for (int idx = tid; idx < n * n; idx += kSolveThreads) {
    const int row = idx / n, column = idx % n;
    const bool fr = fixed[row / 7], fc = fixed[column / 7];
    double v = (fr || fc) ? 0.0 : H[idx];
    if (row == column) v += (fr ? 1.0 : 0.0) + damping;
    H[idx] = v;
  }
  for (int idx = tid; idx < n; idx += kSolveThreads) x[idx] = fixed[idx / 7] ? 0.0 : -b[idx];
  __syncthreads();
  // Cholesky of the lower triangle in place
  const int warp = tid >> 5, lane = tid & 31, n_warps = kSolveThreads / 32;
  for (int j = 0; j < n; ++j) {
    if (tid == 0) {
      const double d = H[(size_t)j * n + j];
      if (!(d > 0.0)) bad = true;
      H[(size_t)j * n + j] = sqrt(fmax(d, 1e-300));
    }
    __syncthreads();
    if (bad) break;
    const double ljj = H[(size_t)j * n + j];
    for (int i = j + 1 + tid; i < n; i += kSolveThreads) H[(size_t)i * n + j] /= ljj;
    __syncthreads();
    for (int i = j + 1 + warp; i < n; i += n_warps) {
      const double lij = H[(size_t)i * n + j];
      for (int k = j + 1 + lane; k <= i; k += 32) H[(size_t)i * n + k] -= lij * H[(size_t)k * n + j];
    }
    __syncthreads();
  }
  if (bad) {
    for (int idx = tid; idx < n; idx += kSolveThreads) x[idx] = 0.0;
    if (tid == 0) *fail = 1;
    return;
  }
  // L y = -b, then L^T dx = y, column by column
  for (int j = 0; j < n; ++j) {
    if (tid == 0) {
      xj = x[j] / H[(size_t)j * n + j];
      x[j] = xj;
    }
    __syncthreads();
    for (int i = j + 1 + tid; i < n; i += kSolveThreads) x[i] -= H[(size_t)i * n + j] * xj;
    __syncthreads();
  }
  for (int j = n - 1; j >= 0; --j) {
    if (tid == 0) {
      xj = x[j] / H[(size_t)j * n + j];
      x[j] = xj;
    }
    __syncthreads();
    for (int i = tid; i < j; i += kSolveThreads) x[i] -= H[(size_t)j * n + i] * xj;
    __syncthreads();
  }
  for (int idx = tid; idx < n; idx += kSolveThreads)
    if (fixed[idx / 7]) x[idx] = 0.0;
}

__global__ void update_kernel(float* __restrict__ verts, const double* __restrict__ dx, int K) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  double R[3][3], t[3], s, d[7];
  sim3::load(verts + 13 * k, R, t, s);
  for (int i = 0; i < 7; ++i) d[i] = dx[7 * k + i];
  sim3::left_update(d, R, t, s);
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) verts[13 * k + 3 * r + c] = (float)R[r][c];
    verts[13 * k + 9 + r] = (float)t[r];
  }
  verts[13 * k + 12] = (float)s;
}

}  // namespace

extern "C" int sim3_graph_launch(const float* verts_in, const int* ei, const int* ej, const float* meas,
                                 const float* w, const bool* fixed, int K, int n_edges, int iters, double damping,
                                 float* verts, double* jac, double* H, double* vec, int* fail, void* stream) {
  if (K < 1 || K > kMaxVertices || n_edges < 0 || iters < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(verts, verts_in, sizeof(float) * 13 * K, cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return err;
  for (int it = 0; it < iters; ++it) {
    if (n_edges > 0)
      edge_kernel<<<(n_edges + kEdgeWarps - 1) / kEdgeWarps, 32 * kEdgeWarps, 0, st>>>(verts, ei, ej, meas, n_edges,
                                                                                          jac);
    solve_kernel<<<1, kSolveThreads, 0, st>>>(ei, ej, w, fixed, K, n_edges, damping, jac, H, vec, fail);
    update_kernel<<<(K + 127) / 128, 128, 0, st>>>(verts, vec + 7 * K, K);
  }
  return cudaGetLastError();
}
