// Kernel G: batched DLT triangulation, one thread per match: the 4x4 A of
// GeometricTools::Triangulate in float32, A^T A in float64, cyclic Jacobi
// until converged, X = v[:3] / v[3] for the least eigenvalue's vector (the
// routine of jacobi.cuh, shared with kernels M and P).  See the source note
// in ops/twoview.py; triangulate_dlt_plain there is the SVD form.
#include <cuda_runtime.h>

#include "jacobi.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
triangulate_dlt_kernel(const float* __restrict__ P0, const float* __restrict__ P1,
                       const float* __restrict__ x0, const float* __restrict__ x1, int n,
                       float* __restrict__ X) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float Xi[3];
  jacobi::dlt_triangulate(P0, P1, x0[2 * i], x0[2 * i + 1], x1[2 * i], x1[2 * i + 1], Xi);
  X[3 * i] = Xi[0];
  X[3 * i + 1] = Xi[1];
  X[3 * i + 2] = Xi[2];
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
