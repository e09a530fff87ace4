// Kernel F: the damped pose-landmark Schur solve of local BA in three
// launches: (1) per pair of free poses (ki >= kj), the sum over landmarks of
// the pair products W_i V^-1 W_j^T into block (ki, kj) of S, and on the
// diagonal W_i V^-1 bl into b_s, each in a fixed order (threads stride the
// landmarks, then a shuffle tree and the warps in turn), so that a run
// repeats bit for bit; (2) one CTA
// adds the damped pose blocks and the gauge terms and solves the (6K)^2
// system by Cholesky in float64 shared memory; (3) per landmark, the
// back-substitution of dl.  A Cholesky pivot <= 0 (an indefinite reduced
// system) sets the flag ``fail`` in device memory; dp and dl are then zero
// and the wrapper reports the solve as failed, so that the LM step is
// rejected.  See the source note in optim/ba.py; schur_solve_plain there is
// the JAX form.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kReduceThreads = 256;  // per pose pair, landmarks strided over the threads
constexpr int kSolveThreads = 1024;
constexpr int kBacksubThreads = 128;
constexpr unsigned kFull = 0xFFFFFFFFu;

// lam * max(h, 1e-3) added to a diagonal entry, in float64
__device__ __forceinline__ double damp(float h, float lam) {
  return (double)h + (double)lam * fmax((double)h, 1e-3);
}

// V = (Hll + lam * max(diag, 1e-3) on the diagonal)^-1 in float64, or the
// identity for a landmark no active observation sees.
__device__ __forceinline__ void damped_inverse(const float* __restrict__ H, float lam, bool seen,
                                               double (&V)[3][3]) {
  if (!seen) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) V[i][j] = i == j ? 1.0 : 0.0;
    return;
  }
  double a[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float h = H[3 * i + j];
      a[i][j] = i == j ? damp(h, lam) : (double)h;
    }
  const double c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
  const double c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2];
  const double c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
  const double det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02;
  const double id = 1.0 / det;
  V[0][0] = c00 * id;
  V[1][0] = c01 * id;
  V[2][0] = c02 * id;
  V[0][1] = (a[0][2] * a[2][1] - a[0][1] * a[2][2]) * id;
  V[1][1] = (a[0][0] * a[2][2] - a[0][2] * a[2][0]) * id;
  V[2][1] = (a[0][1] * a[2][0] - a[0][0] * a[2][1]) * id;
  V[0][2] = (a[0][1] * a[1][2] - a[0][2] * a[1][1]) * id;
  V[1][2] = (a[0][2] * a[1][0] - a[0][0] * a[1][2]) * id;
  V[2][2] = (a[0][0] * a[1][1] - a[0][1] * a[1][0]) * id;
}

__global__ void __launch_bounds__(kReduceThreads)
schur_reduce_kernel(const float* __restrict__ Hll, const float* __restrict__ bl,
                    const float* __restrict__ W, const float* __restrict__ w_lm,
                    const uint8_t* __restrict__ pose_fixed, const int* __restrict__ obs_kf,
                    const int* __restrict__ lm_ptr, const int* __restrict__ lm_obs,
                    const float* __restrict__ lam_p, int n_lm, int n_poses, double* __restrict__ S,
                    double* __restrict__ bs) {
  // block -> (ki, kj), ki >= kj, the lower triangle in row order
  const int blk = blockIdx.x;
  int ki = 0;
  while ((ki + 1) * (ki + 2) / 2 <= blk) ++ki;
  const int kj = blk - ki * (ki + 1) / 2;
  if (pose_fixed[ki] || pose_fixed[kj]) return;  // their W are zero; the whole block leaves here
  const bool diag = ki == kj;
  const int n6 = 6 * n_poses;
  const float lam = *lam_p;
  double acc[42];  // the S block at 6 a + b, then b_s at 36 + a
#pragma unroll
  for (int e = 0; e < 42; ++e) acc[e] = 0.0;
  for (int m = threadIdx.x; m < n_lm; m += kReduceThreads) {
    const int beg = lm_ptr[m], end = lm_ptr[m + 1];
    bool has_i = false, has_j = false;
    for (int e = beg; e < end; ++e) {
      const int k = obs_kf[lm_obs[e]];
      has_i |= k == ki;
      has_j |= k == kj;
    }
    if (!(has_i && has_j)) continue;
    double V[3][3];
    damped_inverse(Hll + 9 * m, lam, w_lm[m] > 0.f, V);
    // b_s -= W_i V^-1 bl
    const double b0 = bl[3 * m], b1 = bl[3 * m + 1], b2 = bl[3 * m + 2];
    const double vb[3] = {V[0][0] * b0 + V[0][1] * b1 + V[0][2] * b2,
                          V[1][0] * b0 + V[1][1] * b1 + V[1][2] * b2,
                          V[2][0] * b0 + V[2][1] * b1 + V[2][2] * b2};
    for (int e = beg; e < end; ++e) {
      const int oi = lm_obs[e];
      if (obs_kf[oi] != ki) continue;
      const float* Wi = W + 18 * oi;
      if (diag)
#pragma unroll
        for (int a = 0; a < 6; ++a) acc[36 + a] -= Wi[3 * a] * vb[0] + Wi[3 * a + 1] * vb[1] + Wi[3 * a + 2] * vb[2];
      double wv[6][3];
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          wv[a][c] = Wi[3 * a] * V[0][c] + Wi[3 * a + 1] * V[1][c] + Wi[3 * a + 2] * V[2][c];
      // S -= W_i V^-1 W_j^T over the observations j of this landmark from kj
      for (int f = beg; f < end; ++f) {
        const int oj = lm_obs[f];
        if (obs_kf[oj] != kj) continue;
        const float* Wj = W + 18 * oj;
#pragma unroll
        for (int a = 0; a < 6; ++a)
#pragma unroll
          for (int b = 0; b < 6; ++b) {
            if (diag && b > a) continue;
            acc[6 * a + b] -= wv[a][0] * Wj[3 * b] + wv[a][1] * Wj[3 * b + 1] + wv[a][2] * Wj[3 * b + 2];
          }
      }
    }
  }
  __shared__ double part[kReduceThreads / 32][42];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < 42; ++e) {
    double v = acc[e];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (lane == 0) part[warp][e] = v;
  }
  __syncthreads();
  if (threadIdx.x < 42) {
    const int e = threadIdx.x;
    double v = 0.0;
    for (int w = 0; w < kReduceThreads / 32; ++w) v += part[w][e];
    if (e < 36) {
      const int a = e / 6, b = e % 6;
      if (!diag || b <= a) S[(size_t)(6 * ki + a) * n6 + 6 * kj + b] = v;
    } else if (diag) {
      bs[6 * ki + e - 36] = v;
    }
  }
}

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }  // i >= j

__global__ void __launch_bounds__(kSolveThreads)
schur_solve_kernel(const float* __restrict__ Hpp, const float* __restrict__ bp,
                   const uint8_t* __restrict__ pose_fixed, const float* __restrict__ lam_p, int n6,
                   const double* __restrict__ S, const double* __restrict__ bs,
                   float* __restrict__ dp, int* __restrict__ fail_out) {
  extern __shared__ double sm[];
  double* L = sm;                       // packed lower triangle, n6 (n6 + 1) / 2
  double* y = sm + n6 * (n6 + 1) / 2;   // right-hand side, then the solution
  __shared__ int fail;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = kSolveThreads / 32;
  const float lam = *lam_p;
  if (tid == 0) fail = 0;
  // A = mask(blockdiag(Hpp_d) - S_coup) + (fixed ? I : 0) + 1e-6 I
  for (int i = warp; i < n6; i += n_warps) {
    const int ki = i / 6, a = i % 6;
    const bool fi = !pose_fixed[ki];
    for (int j = lane; j <= i; j += 32) {
      const int kj = j / 6, b = j % 6;
      double v = S[(size_t)i * n6 + j];
      if (ki == kj) {
        const float h = Hpp[36 * ki + 6 * a + b];
        v += a == b ? damp(h, lam) : (double)h;
      }
      v = (fi && !pose_fixed[kj]) ? v : 0.0;
      if (i == j) v += (fi ? 0.0 : 1.0) + 1e-6;
      L[tri(i, j)] = v;
    }
  }
  for (int i = tid; i < n6; i += kSolveThreads)
    y[i] = pose_fixed[i / 6] ? 0.0 : (double)bp[i] + bs[i];
  __syncthreads();
  // right-looking Cholesky, A = L L^T
  for (int j = 0; j < n6; ++j) {
    if (tid == 0) {
      double d = L[tri(j, j)];
      if (!(d > 0.0)) {
        fail = 1;
        d = 1.0;
      }
      L[tri(j, j)] = sqrt(d);
    }
    __syncthreads();
    const double ljj = L[tri(j, j)];
    for (int i = j + 1 + tid; i < n6; i += kSolveThreads) L[tri(i, j)] /= ljj;
    __syncthreads();
    for (int i = j + 1 + warp; i < n6; i += n_warps) {
      const double lij = L[tri(i, j)];
      for (int k = j + 1 + lane; k <= i; k += 32) L[tri(i, k)] -= lij * L[tri(k, j)];
    }
    __syncthreads();
  }
  if (warp == 0) {
    for (int i = 0; i < n6; ++i) {  // L z = y
      double s = 0.0;
      for (int k = lane; k < i; k += 32) s += L[tri(i, k)] * y[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFull, s, o);
      if (lane == 0) y[i] = (y[i] - s) / L[tri(i, i)];
      __syncwarp();
    }
    for (int i = n6 - 1; i >= 0; --i) {  // L^T x = z
      double s = 0.0;
      for (int k = i + 1 + lane; k < n6; k += 32) s += L[tri(k, i)] * y[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFull, s, o);
      if (lane == 0) y[i] = (y[i] - s) / L[tri(i, i)];
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < n6; i += kSolveThreads)
    dp[i] = (fail || pose_fixed[i / 6]) ? 0.f : (float)y[i];
  if (tid == 0) *fail_out = fail;
}

__global__ void __launch_bounds__(kBacksubThreads)
schur_backsub_kernel(const float* __restrict__ Hll, const float* __restrict__ bl,
                     const float* __restrict__ W, const float* __restrict__ w_lm,
                     const uint8_t* __restrict__ lm_valid, const int* __restrict__ obs_kf,
                     const int* __restrict__ lm_ptr, const int* __restrict__ lm_obs,
                     const float* __restrict__ lam_p, const float* __restrict__ dp,
                     const int* __restrict__ fail, int n_lm, float* __restrict__ dl) {
  const int m = blockIdx.x * kBacksubThreads + threadIdx.x;
  if (m >= n_lm) return;
  const bool seen = w_lm[m] > 0.f;
  if (!(seen && lm_valid[m]) || *fail) {
    dl[3 * m] = dl[3 * m + 1] = dl[3 * m + 2] = 0.f;
    return;
  }
  double V[3][3];
  damped_inverse(Hll + 9 * m, *lam_p, true, V);
  double acc[3] = {bl[3 * m], bl[3 * m + 1], bl[3 * m + 2]};
  for (int e = lm_ptr[m]; e < lm_ptr[m + 1]; ++e) {
    const int o = lm_obs[e];
    const float* Wo = W + 18 * o;
    const float* d = dp + 6 * obs_kf[o];
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] -= (double)Wo[3 * a + c] * d[a];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) dl[3 * m + r] = (float)(V[r][0] * acc[0] + V[r][1] * acc[1] + V[r][2] * acc[2]);
}

}  // namespace

extern "C" int ba_schur_launch(const float* Hpp, const float* Hll, const float* bp, const float* bl,
                               const float* W, const float* w_lm, const uint8_t* pose_fixed,
                               const uint8_t* lm_valid, const int* obs_kf, const int* lm_ptr,
                               const int* lm_obs, const float* lam, int n_poses, int n_lm, int n_obs,
                               double* S, double* bs, float* dp, float* dl, int* fail,
                               void* stream) {
  (void)n_obs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n6 = 6 * n_poses;
  if (n_lm > 0) {
    schur_reduce_kernel<<<n_poses * (n_poses + 1) / 2, kReduceThreads, 0, st>>>(
        Hll, bl, W, w_lm, pose_fixed, obs_kf, lm_ptr, lm_obs, lam, n_lm, n_poses, S, bs);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const size_t smem = ((size_t)n6 * (n6 + 1) / 2 + n6) * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(schur_solve_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  schur_solve_kernel<<<1, kSolveThreads, smem, st>>>(Hpp, bp, pose_fixed, lam, n6, S, bs, dp, fail);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n_lm > 0)
    schur_backsub_kernel<<<(n_lm + kBacksubThreads - 1) / kBacksubThreads, kBacksubThreads, 0, st>>>(
        Hll, bl, W, w_lm, lm_valid, obs_kf, lm_ptr, lm_obs, lam, dp, fail, n_lm, dl);
  return cudaGetLastError();
}
