// Kernel U: Gauss-Newton on the Sim3 essential graph with the normal
// equations solved by block-Jacobi PCG on the implicit edge operator (the
// PCG branch of _solve_normal_eqs, K > 128 vertices), five launches per
// iteration from one C entry point, no host round trip inside a solve.
//  1. One warp per edge: r and both 7x7 Jacobians in float64 dual numbers
//     (sim3::edge_lane, as kernel S).
//  2. One thread per (edge, entry): the weighted blocks H_ii, H_jj, H_ij
//     and the gradient pieces b_i, b_j, each entry a 7-term sum in order.
//  3. One thread per vertex: b and the diagonal block summed over the
//     vertex's edge list (the CSR ``vptr`` / ``vlist``: the edges that
//     start at it in their order, then those that end at it), the
//     preconditioner inv(D + damping I + 1e-8 I) (I for a fixed vertex) by
//     Gauss-Jordan with partial pivoting.  A zero or non-finite pivot sets
//     the flag, and that iteration's and every later step is zero.
//  4. One CTA of 1024 threads: the CG iterations.  The vectors live in
//     global memory (L2); a thread owns rows row = tid + 1024 i.  H p per
//     row is damping p plus the row's edge blocks over the CSR list in
//     order; every dot product is a warp butterfly, then the 32 warp sums in
//     order.  ``rz <= 1e-12`` freezes x, as alpha = beta = 0 does in the
//     plain version, so the loop stops there; the count of iterations run
//     is written out.
//  5. One thread per vertex: S <- sim3_exp(dx) S, R re-orthonormalised.
// Every sum has a fixed order and there are no floating-point atomics, so
// a run repeats bit for bit.  See the source note in optim/pose_graph.py;
// _solve_normal_eqs there is the same solve in PyTorch.
#include <cuda_runtime.h>
#include <math.h>

#include "sim3.cuh"

namespace {

constexpr int kEdgeWarps = 8;
constexpr int kCgThreads = 1024;
constexpr int kCgWarps = kCgThreads / 32;
constexpr int kBlk = 3 * 49 + 14;  // per edge: H_ii | H_jj | H_ij (row-major 7x7) | b_i | b_j

__global__ void __launch_bounds__(32 * kEdgeWarps)
edge_kernel(const float* __restrict__ verts, const int* __restrict__ ei, const int* __restrict__ ej,
            const float* __restrict__ meas, int n_edges, double* __restrict__ jac) {
  const int e = blockIdx.x * kEdgeWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= n_edges || lane >= 14) return;
  double* out = jac + 105 * e;  // r (7) | J_i^T (7x7, row = direction) | J_j^T
  sim3::edge_lane(verts + 13 * ei[e], verts + 13 * ej[e], meas + 13 * e, lane, out + 7 + 7 * lane,
                  lane == 0 ? out : nullptr);
}

// H_ab[p][c] = sum_r (J_a[r][p] w) J_b[r][c]; b_a[p] = sum_r (J_a[r][p] w) r[r]
__global__ void block_kernel(const double* __restrict__ jac, const float* __restrict__ w, int n_edges,
                             double* __restrict__ blk) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_edges * kBlk) return;
  const int e = idx / kBlk, q = idx % kBlk;
  const double we = w[e];
  const double* J = jac + 105 * e;
  double v = 0.0;
  if (we != 0.0) {
    if (q < 147) {
      const int b = q / 49, p = (q % 49) / 7, c = q % 7;
      const double* A = J + 7 + 49 * (b == 1);  // row side: J_i for ii and ij, J_j for jj
      const double* B = J + 7 + 49 * (b >= 1);  // column side: J_i for ii, J_j for jj and ij
      for (int r = 0; r < 7; ++r) v += A[7 * p + r] * we * B[7 * c + r];
    } else {
      const int side = (q - 147) / 7, p = (q - 147) % 7;
      const double* A = J + 7 + 49 * side;
      for (int r = 0; r < 7; ++r) v += A[7 * p + r] * we * J[r];
    }
  }
  blk[(size_t)kBlk * e + q] = v;
}

__global__ void vertex_kernel(const double* __restrict__ blk, const int* __restrict__ vptr,
                              const int* __restrict__ vlist, const bool* __restrict__ fixed, int K, double damping,
                              double* __restrict__ b, double* __restrict__ Dinv, int* __restrict__ fail) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  double D[7][14], g[7] = {};
  for (int a = 0; a < 7; ++a)
    for (int c = 0; c < 7; ++c) D[a][c] = 0.0;
  for (int s = vptr[k]; s < vptr[k + 1]; ++s) {
    const int e = vlist[s] >> 1, side = vlist[s] & 1;
    const double* H = blk + (size_t)kBlk * e + 49 * side;  // H_ii at the edge's i end, H_jj at its j end
    const double* bb = blk + (size_t)kBlk * e + 147 + 7 * side;
    for (int a = 0; a < 7; ++a) {
      for (int c = 0; c < 7; ++c) D[a][c] += H[7 * a + c];
      g[a] += bb[a];
    }
  }
  for (int a = 0; a < 7; ++a) {
    b[7 * k + a] = g[a];
    for (int c = 0; c < 7; ++c) {
      double v = fixed[k] ? (a == c ? 1.0 : 0.0) : D[a][c] + (a == c ? damping : 0.0);
      D[a][c] = v + (a == c ? 1e-8 : 0.0);
      D[a][7 + c] = a == c ? 1.0 : 0.0;
    }
  }
  for (int c = 0; c < 7; ++c) {  // Gauss-Jordan, partial pivoting
    int piv = c;
    for (int a = c + 1; a < 7; ++a)
      if (fabs(D[a][c]) > fabs(D[piv][c])) piv = a;
    if (!(fabs(D[piv][c]) > 0.0) || !isfinite(D[piv][c])) {
      *fail = 1;
      return;
    }
    if (piv != c)
      for (int q = 0; q < 14; ++q) {
        const double tmp = D[c][q];
        D[c][q] = D[piv][q];
        D[piv][q] = tmp;
      }
    const double inv = 1.0 / D[c][c];
    for (int q = 0; q < 14; ++q) D[c][q] *= inv;
    for (int a = 0; a < 7; ++a) {
      if (a == c) continue;
      const double f = D[a][c];
      for (int q = 0; q < 14; ++q) D[a][q] -= f * D[c][q];
    }
  }
  for (int a = 0; a < 7; ++a)
    for (int c = 0; c < 7; ++c) Dinv[49 * k + 7 * a + c] = D[a][7 + c];
}

// The block's sum of one value per thread: warp butterflies, then the warp
// sums in order by thread 0; every thread gets the total.
__device__ __forceinline__ double block_sum(double v, double* red, double* total) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kCgWarps; ++w) s += red[w];
    *total = s;
  }
  __syncthreads();
  return *total;
}

// Row (k, a) of H p: damping p plus the row's edge blocks, the edges in the
// CSR order (plain: index_add_ at the i ends, then at the j ends).  p is
// zero at fixed vertices, so it needs no mask here.
__device__ __forceinline__ double h_row(const double* __restrict__ blk, const int* __restrict__ ei,
                                        const int* __restrict__ ej, const int* __restrict__ vptr,
                                        const int* __restrict__ vlist, const double* __restrict__ p, int k, int a,
                                        double damping) {
  double out = damping * p[7 * k + a];
  for (int s = vptr[k]; s < vptr[k + 1]; ++s) {
    const int e = vlist[s] >> 1, side = vlist[s] & 1;
    const double* Hb = blk + (size_t)kBlk * e;
    const double* pi = p + 7 * ei[e];
    const double* pj = p + 7 * ej[e];
    double t1 = 0.0, t2 = 0.0;
    if (side == 0) {  // H_ii p_i + H_ij p_j
      for (int c = 0; c < 7; ++c) t1 += Hb[7 * a + c] * pi[c];
      for (int c = 0; c < 7; ++c) t2 += Hb[98 + 7 * a + c] * pj[c];
    } else {  // H_jj p_j + H_ij^T p_i
      for (int c = 0; c < 7; ++c) t1 += Hb[49 + 7 * a + c] * pj[c];
      for (int c = 0; c < 7; ++c) t2 += Hb[98 + 7 * c + a] * pi[c];
    }
    out += t1 + t2;
  }
  return out;
}

__device__ __forceinline__ double precond_row(const double* __restrict__ Dinv, const double* __restrict__ r, int k,
                                              int a) {
  double z = 0.0;
  for (int c = 0; c < 7; ++c) z += Dinv[49 * k + 7 * a + c] * r[7 * k + c];
  return z;
}

__global__ void __launch_bounds__(kCgThreads)
pcg_kernel(const double* __restrict__ blk, const int* __restrict__ ei, const int* __restrict__ ej,
           const int* __restrict__ vptr, const int* __restrict__ vlist, const bool* __restrict__ fixed,
           const double* __restrict__ Dinv, int K, double damping, int cg_iters, const int* __restrict__ fail,
           double* __restrict__ vec, int* __restrict__ cg_run) {
  __shared__ double red[kCgWarps];
  __shared__ double total;
  const int n = 7 * K, tid = threadIdx.x;
  const double* b = vec;
  double* x = vec + n;
  double* r = vec + 2 * n;
  double* z = vec + 3 * n;
  double* p = vec + 4 * n;
  double* Ap = vec + 5 * n;
  const bool bad = *fail != 0;
  for (int row = tid; row < n; row += kCgThreads) {
    x[row] = 0.0;
    r[row] = fixed[row / 7] || bad ? 0.0 : -b[row];
  }
  __syncthreads();
  double part = 0.0;
  for (int row = tid; row < n; row += kCgThreads) {
    const int k = row / 7;
    const double zr = fixed[k] || bad ? 0.0 : precond_row(Dinv, r, k, row % 7);
    z[row] = zr;
    p[row] = zr;
    part += r[row] * zr;
  }
  double rz = block_sum(part, red, &total);
  int it = 0;
  for (; it < cg_iters && rz > 1e-12; ++it) {  // past the freeze x no longer moves
    part = 0.0;
    for (int row = tid; row < n; row += kCgThreads) {
      const int k = row / 7;
      const double h = fixed[k] ? 0.0 : h_row(blk, ei, ej, vptr, vlist, p, k, row % 7, damping);
      Ap[row] = h;
      part += p[row] * h;
    }
    const double pAp = block_sum(part, red, &total);
    const double alpha = rz / fmax(pAp, 1e-20);
    for (int row = tid; row < n; row += kCgThreads) {
      x[row] += alpha * p[row];
      r[row] -= alpha * Ap[row];
    }
    __syncthreads();  // a row's z reads the 7 entries of r of its vertex
    part = 0.0;
    for (int row = tid; row < n; row += kCgThreads) {
      const int k = row / 7;
      const double zr = fixed[k] ? 0.0 : precond_row(Dinv, r, k, row % 7);
      z[row] = zr;
      part += r[row] * zr;
    }
    const double rz_new = block_sum(part, red, &total);
    const double beta = rz_new / fmax(rz, 1e-20);
    for (int row = tid; row < n; row += kCgThreads) p[row] = z[row] + beta * p[row];
    __syncthreads();  // the next H p reads p across vertices
    rz = rz_new;
  }
  if (tid == 0) *cg_run = it;
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

// jac (E, 105), blk (E, kBlk), Dinv (K, 49), vec (6 x 7K: b | x | r | z | p | Ap) float64 scratch;
// cg_run (iters) the CG iterations each Gauss-Newton step ran; fail zeroed by the caller.
extern "C" int sim3_pcg_launch(const float* verts_in, const int* ei, const int* ej, const float* meas, const float* w,
                               const bool* fixed, const int* vptr, const int* vlist, int K, int n_edges, int iters,
                               int cg_iters, double damping, float* verts, double* jac, double* blk, double* Dinv,
                               double* vec, int* cg_run, int* fail, void* stream) {
  if (K < 1 || n_edges < 0 || iters < 0 || cg_iters < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(verts, verts_in, sizeof(float) * 13 * K, cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return err;
  const int n = 7 * K;
  for (int it = 0; it < iters; ++it) {
    if (n_edges > 0) {
      edge_kernel<<<(n_edges + kEdgeWarps - 1) / kEdgeWarps, 32 * kEdgeWarps, 0, st>>>(verts, ei, ej, meas, n_edges,
                                                                                          jac);
      block_kernel<<<(n_edges * kBlk + 255) / 256, 256, 0, st>>>(jac, w, n_edges, blk);
    }
    vertex_kernel<<<(K + 127) / 128, 128, 0, st>>>(blk, vptr, vlist, fixed, K, damping, vec, Dinv, fail);
    pcg_kernel<<<1, kCgThreads, 0, st>>>(blk, ei, ej, vptr, vlist, fixed, Dinv, K, damping, cg_iters, fail, vec,
                                         cg_run + it);
    update_kernel<<<(K + 127) / 128, 128, 0, st>>>(verts, vec + n, K);
  }
  return cudaGetLastError();
}
