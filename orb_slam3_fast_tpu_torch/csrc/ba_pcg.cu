// Kernel T: the implicit-Schur PCG of global BA (ba_cg.implicit_schur_solve):
// S = Hpp_d - W V^-1 W^T applied as an operator over the per-observation
// coupling W (O,6,3) of kernel E, block-Jacobi preconditioned, in float64.
// Launches, all from one C entry point: landmark setup, pose setup, r.z,
// then per CG iteration a landmark pass, a pose pass and a one-CTA update,
// then the back-substitution: 3 + 3 cg_iters + 1.  The segment sums walk
// the landmark CSR (lm_ptr, lm_obs) and the pose CSR (kf_ptr, kf_obs) in
// their order, the dot products are fixed-order block reductions, so a run
// repeats bit for bit.  See the source note in optim/ba_cg.py;
// implicit_schur_solve_plain there is the same function in PyTorch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "jacobi.cuh"

namespace {

constexpr int kLmThreads = 128;
constexpr int kPoseThreads = 128;
constexpr int kVecThreads = 1024;

struct Scratch {
  double *Vinv, *y, *Hpp_d, *Dinv, *x, *r, *z, *p, *Ap, *scal;  // scal: rz
};

__device__ __forceinline__ void damp_diag(double* H, int n, double lam) {
  for (int i = 0; i < n; ++i) H[i * n + i] += lam * fmax(H[i * n + i], 1e-3);
}

// inverse of an n x n matrix (n <= 6) by Gauss-Jordan with partial pivoting
template <int N>
__device__ void invert(const double (&A)[N][N], double (&Ai)[N][N]) {
  double M[N][2 * N];
  for (int r = 0; r < N; ++r)
    for (int c = 0; c < 2 * N; ++c) M[r][c] = c < N ? A[r][c] : (c - N == r ? 1.0 : 0.0);
  for (int c = 0; c < N; ++c) {
    int piv = c;
    for (int r = c + 1; r < N; ++r)
      if (fabs(M[r][c]) > fabs(M[piv][c])) piv = r;
    if (piv != c)
      for (int k = 0; k < 2 * N; ++k) {
        const double tmp = M[c][k];
        M[c][k] = M[piv][k];
        M[piv][k] = tmp;
      }
    const double inv = 1.0 / M[c][c];
    for (int k = 0; k < 2 * N; ++k) M[c][k] *= inv;
    for (int r = 0; r < N; ++r)
      if (r != c) {
        const double f = M[r][c];
        for (int k = 0; k < 2 * N; ++k) M[r][k] -= f * M[c][k];
      }
  }
  for (int r = 0; r < N; ++r)
    for (int c = 0; c < N; ++c) Ai[r][c] = M[r][N + c];
}

// V^-1 per landmark (the damped Hll, the identity where no weight reached
// it) and y = V^-1 bl.
__global__ void __launch_bounds__(kLmThreads)
lm_setup_kernel(const float* __restrict__ Hll, const float* __restrict__ bl, const float* __restrict__ w_lm,
                const float* __restrict__ lam, int M, Scratch s) {
  const int m = blockIdx.x * kLmThreads + threadIdx.x;
  if (m >= M) return;
  double H[3][3];
  const bool seen = w_lm[m] > 0.f;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) H[r][c] = seen ? (double)Hll[9 * m + 3 * r + c] : (r == c ? 1.0 : 0.0);
  if (seen) damp_diag(&H[0][0], 3, (double)*lam);
  double Vi[3][3];
  invert<3>(H, Vi);
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) s.Vinv[9 * m + 3 * r + c] = Vi[r][c];
    s.y[3 * m + r] = Vi[r][0] * bl[3 * m] + Vi[r][1] * bl[3 * m + 1] + Vi[r][2] * bl[3 * m + 2];
  }
}

// Block sum of N values per thread, in a fixed order; the totals land in
// out (shared) for every thread.
template <int N, int THREADS>
__device__ void block_reduce(double (&v)[N], double (*part)[N], double* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = 0; k < N; ++k) {
    double a = v[k];
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xFFFFFFFFu, a, o);
    if (lane == 0) part[warp][k] = a;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < N; k += THREADS) {
    double a = 0.0;
    for (int w = 0; w < THREADS / 32; ++w) a += part[w][k];
    out[k] = a;
  }
  __syncthreads();
}

// One CTA per pose: D = Hpp_d - sum W V^-1 W^T, its inverse (+1e-5 I), and
// the start of CG: x = 0, r = b_s = (bp - sum W V^-1 bl) free, z = p = D^-1 r.
__global__ void __launch_bounds__(kPoseThreads)
pose_setup_kernel(const float* __restrict__ Hpp, const float* __restrict__ bp, const float* __restrict__ W,
                  const int* __restrict__ obs_lm, const int* __restrict__ kf_ptr, const int* __restrict__ kf_obs,
                  const uint8_t* __restrict__ pose_fixed, const float* __restrict__ lam, Scratch s) {
  __shared__ double part[kPoseThreads / 32][42];
  __shared__ double tot[42];
  const int k = blockIdx.x;
  double acc[42];
  for (int i = 0; i < 42; ++i) acc[i] = 0.0;
  for (int j = kf_ptr[k] + threadIdx.x; j < kf_ptr[k + 1]; j += kPoseThreads) {
    const int o = kf_obs[j], m = obs_lm[o];
    const float* Wo = W + 18 * o;
    const double* Vi = s.Vinv + 9 * m;
    double WV[6][3];
    for (int a = 0; a < 6; ++a)
      for (int c = 0; c < 3; ++c)
        WV[a][c] = Wo[3 * a] * Vi[c] + Wo[3 * a + 1] * Vi[3 + c] + Wo[3 * a + 2] * Vi[6 + c];
    for (int a = 0; a < 6; ++a) {
      for (int b = 0; b < 6; ++b)
        acc[6 * a + b] += WV[a][0] * Wo[3 * b] + WV[a][1] * Wo[3 * b + 1] + WV[a][2] * Wo[3 * b + 2];
      acc[36 + a] += Wo[3 * a] * s.y[3 * m] + Wo[3 * a + 1] * s.y[3 * m + 1] + Wo[3 * a + 2] * s.y[3 * m + 2];
    }
  }
  block_reduce<42, kPoseThreads>(acc, part, tot);
  if (threadIdx.x == 0) {
    const bool fixed = pose_fixed[k];
    double H[6][6], D[6][6], Di[6][6];
    for (int a = 0; a < 6; ++a)
      for (int b = 0; b < 6; ++b) H[a][b] = Hpp[36 * k + 6 * a + b];
    damp_diag(&H[0][0], 6, (double)*lam);
    for (int a = 0; a < 6; ++a)
      for (int b = 0; b < 6; ++b) {
        s.Hpp_d[36 * k + 6 * a + b] = H[a][b];
        D[a][b] = (fixed ? (a == b ? 1.0 : 0.0) : H[a][b] - tot[6 * a + b]) + (a == b ? 1e-5 : 0.0);
      }
    invert<6>(D, Di);
    double r[6];
    for (int a = 0; a < 6; ++a) {
      r[a] = fixed ? 0.0 : (double)bp[6 * k + a] - tot[36 + a];
      s.x[6 * k + a] = 0.0;
      s.r[6 * k + a] = r[a];
    }
    for (int a = 0; a < 6; ++a) {
      double zv = 0.0;
      for (int b = 0; b < 6; ++b) {
        s.Dinv[36 * k + 6 * a + b] = Di[a][b];
        zv += Di[a][b] * r[b];
      }
      zv = fixed ? 0.0 : zv;
      s.z[6 * k + a] = zv;
      s.p[6 * k + a] = zv;
    }
  }
}

__global__ void __launch_bounds__(kVecThreads) dot_rz_kernel(int n, Scratch s) {
  __shared__ double sh[33];
  double v = 0.0;
  for (int i = threadIdx.x; i < n; i += kVecThreads) v += s.r[i] * s.z[i];
  v = jacobi::block_sum(v, sh);
  if (threadIdx.x == 0) s.scal[0] = v;
}

// y_m = V_m^-1 sum over m's observations of W_o^T v_kf, v = p * free.
__global__ void __launch_bounds__(kLmThreads)
lm_pass_kernel(const float* __restrict__ W, const int* __restrict__ obs_kf, const int* __restrict__ lm_ptr,
               const int* __restrict__ lm_obs, const uint8_t* __restrict__ pose_fixed, const double* __restrict__ v,
               int M, Scratch s) {
  const int m = blockIdx.x * kLmThreads + threadIdx.x;
  if (m >= M) return;
  double t[3] = {0.0, 0.0, 0.0};
  for (int j = lm_ptr[m]; j < lm_ptr[m + 1]; ++j) {
    const int o = lm_obs[j], k = obs_kf[o];
    if (pose_fixed[k]) continue;
    const float* Wo = W + 18 * o;
    for (int c = 0; c < 3; ++c)
      for (int a = 0; a < 6; ++a) t[c] += Wo[3 * a + c] * v[6 * k + a];
  }
  const double* Vi = s.Vinv + 9 * m;
  for (int r = 0; r < 3; ++r) s.y[3 * m + r] = Vi[3 * r] * t[0] + Vi[3 * r + 1] * t[1] + Vi[3 * r + 2] * t[2];
}

// (S p)_k = (Hpp_d p_k - sum over k's observations of W_o y_lm) free_k.
__global__ void __launch_bounds__(kPoseThreads)
pose_pass_kernel(const float* __restrict__ W, const int* __restrict__ obs_lm, const int* __restrict__ kf_ptr,
                 const int* __restrict__ kf_obs, const uint8_t* __restrict__ pose_fixed, Scratch s) {
  __shared__ double part[kPoseThreads / 32][6];
  __shared__ double tot[6];
  const int k = blockIdx.x;
  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int j = kf_ptr[k] + threadIdx.x; j < kf_ptr[k + 1]; j += kPoseThreads) {
    const int o = kf_obs[j], m = obs_lm[o];
    const float* Wo = W + 18 * o;
    for (int a = 0; a < 6; ++a)
      acc[a] += Wo[3 * a] * s.y[3 * m] + Wo[3 * a + 1] * s.y[3 * m + 1] + Wo[3 * a + 2] * s.y[3 * m + 2];
  }
  block_reduce<6, kPoseThreads>(acc, part, tot);
  if (threadIdx.x < 6) {
    const int a = threadIdx.x;
    double hv = 0.0;
    if (!pose_fixed[k])
      for (int b = 0; b < 6; ++b) hv += s.Hpp_d[36 * k + 6 * a + b] * s.p[6 * k + b];
    s.Ap[6 * k + a] = pose_fixed[k] ? 0.0 : hv - tot[a];
  }
}

// One CG update over the 6K vector, with the reference's freeze: alpha and
// beta are 0 once r.z <= 1e-12.
__global__ void __launch_bounds__(kVecThreads)
cg_update_kernel(const uint8_t* __restrict__ pose_fixed, int K, Scratch s) {
  __shared__ double sh[33];
  const int n = 6 * K;
  double v = 0.0;
  for (int i = threadIdx.x; i < n; i += kVecThreads) v += s.p[i] * s.Ap[i];
  const double pAp = jacobi::block_sum(v, sh);
  const double rz = s.scal[0];
  const bool ok = rz > 1e-12;
  const double alpha = ok ? rz / fmax(pAp, 1e-20) : 0.0;
  for (int i = threadIdx.x; i < n; i += kVecThreads) {
    s.x[i] += alpha * s.p[i];
    s.r[i] -= alpha * s.Ap[i];
  }
  __syncthreads();
  v = 0.0;
  for (int i = threadIdx.x; i < n; i += kVecThreads) {
    const int k = i / 6, a = i % 6;
    double zv = 0.0;
    if (!pose_fixed[k])
      for (int b = 0; b < 6; ++b) zv += s.Dinv[36 * k + 6 * a + b] * s.r[6 * k + b];
    s.z[i] = zv;
    v += s.r[i] * zv;
  }
  const double rz_new = jacobi::block_sum(v, sh);
  const double beta = ok ? rz_new / fmax(rz, 1e-20) : 0.0;
  for (int i = threadIdx.x; i < n; i += kVecThreads) s.p[i] = s.z[i] + beta * s.p[i];
  if (threadIdx.x == 0) s.scal[0] = rz_new;
}

// dp = x free; dl = V^-1 (bl - sum W_o^T dp) where the landmark is seen and valid.
__global__ void __launch_bounds__(kLmThreads)
backsub_kernel(const float* __restrict__ W, const float* __restrict__ bl, const float* __restrict__ w_lm,
               const uint8_t* __restrict__ lm_valid, const int* __restrict__ obs_kf, const int* __restrict__ lm_ptr,
               const int* __restrict__ lm_obs, const uint8_t* __restrict__ pose_fixed, int K, int M, Scratch s,
               float* __restrict__ dp, float* __restrict__ dl) {
  const int g = blockIdx.x * kLmThreads + threadIdx.x;
  for (int i = g; i < 6 * K; i += gridDim.x * kLmThreads) dp[i] = pose_fixed[i / 6] ? 0.f : (float)s.x[i];
  if (g >= M) return;
  double t[3] = {0.0, 0.0, 0.0};
  for (int j = lm_ptr[g]; j < lm_ptr[g + 1]; ++j) {
    const int o = lm_obs[j], k = obs_kf[o];
    if (pose_fixed[k]) continue;
    const float* Wo = W + 18 * o;
    for (int c = 0; c < 3; ++c)
      for (int a = 0; a < 6; ++a) t[c] += Wo[3 * a + c] * s.x[6 * k + a];
  }
  const bool keep = w_lm[g] > 0.f && lm_valid[g];
  const double* Vi = s.Vinv + 9 * g;
  const double rhs[3] = {bl[3 * g] - t[0], bl[3 * g + 1] - t[1], bl[3 * g + 2] - t[2]};
  for (int r = 0; r < 3; ++r)
    dl[3 * g + r] = keep ? (float)(Vi[3 * r] * rhs[0] + Vi[3 * r + 1] * rhs[1] + Vi[3 * r + 2] * rhs[2]) : 0.f;
}

}  // namespace

extern "C" int ba_pcg_launch(const float* Hpp, const float* Hll, const float* bp, const float* bl, const float* W,
                             const float* w_lm, const uint8_t* pose_fixed, const uint8_t* lm_valid, const int* obs_kf,
                             const int* obs_lm, const int* lm_ptr, const int* lm_obs, const int* kf_ptr,
                             const int* kf_obs, const float* lam, int K, int M, int O, int cg_iters, double* scratch,
                             float* dp, float* dl, void* stream) {
  if (K < 1 || M < 1 || O < 0 || cg_iters < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Scratch s;  // 12 M + 102 K + 8 doubles
  s.Vinv = scratch;
  s.y = s.Vinv + 9 * (size_t)M;
  s.Hpp_d = s.y + 3 * (size_t)M;
  s.Dinv = s.Hpp_d + 36 * (size_t)K;
  s.x = s.Dinv + 36 * (size_t)K;
  s.r = s.x + 6 * K;
  s.z = s.r + 6 * K;
  s.p = s.z + 6 * K;
  s.Ap = s.p + 6 * K;
  s.scal = s.Ap + 6 * K;
  const int lm_grid = (M + kLmThreads - 1) / kLmThreads;
  lm_setup_kernel<<<lm_grid, kLmThreads, 0, st>>>(Hll, bl, w_lm, lam, M, s);
  pose_setup_kernel<<<K, kPoseThreads, 0, st>>>(Hpp, bp, W, obs_lm, kf_ptr, kf_obs, pose_fixed, lam, s);
  dot_rz_kernel<<<1, kVecThreads, 0, st>>>(6 * K, s);
  for (int it = 0; it < cg_iters; ++it) {
    lm_pass_kernel<<<lm_grid, kLmThreads, 0, st>>>(W, obs_kf, lm_ptr, lm_obs, pose_fixed, s.p, M, s);
    pose_pass_kernel<<<K, kPoseThreads, 0, st>>>(W, obs_lm, kf_ptr, kf_obs, pose_fixed, s);
    cg_update_kernel<<<1, kVecThreads, 0, st>>>(pose_fixed, K, s);
  }
  backsub_kernel<<<lm_grid, kLmThreads, 0, st>>>(W, bl, w_lm, lm_valid, obs_kf, lm_ptr, lm_obs, pose_fixed, K, M, s,
                                                 dp, dl);
  return cudaGetLastError();
}
