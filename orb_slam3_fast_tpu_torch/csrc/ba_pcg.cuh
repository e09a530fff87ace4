// Kernel T's device code (csrc/ba_pcg.cu, whose head says what it does): the
// scratch layout, the small inverses, the fixed-order block reductions and
// the PCG's passes.  Included by ba_pcg.cu (kernel T's entry) and
// ba_shard.cu (kernel AF, which reduces each pass's partial sums over the
// ranks).
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "jacobi.cuh"

namespace ba_t {
namespace {

constexpr int kLmThreads = 128;
constexpr int kPoseThreads = 128;
constexpr int kVecThreads = 1024;

struct Scratch {
  double *Vinv, *y, *Hpp_d, *Dinv, *x, *r, *z, *p, *Ap, *scal;  // scal: rz
};

// The scratch's layout in one float64 buffer of 12 M + 102 K + 8 doubles.
Scratch scratch_at(double* scratch, int K, int M) {
  Scratch s;
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
  return s;
}

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

// A thread's share of pose k's sums over its observations in the pose CSR
// (threads kPoseThreads apart): W V^-1 W^T (acc[0..35]) and W V^-1 bl
// (acc[36..41], y holding V^-1 bl).
__device__ __forceinline__ void pose_setup_sums(int k, const float* __restrict__ W, const int* __restrict__ obs_lm,
                                                const int* __restrict__ kf_ptr, const int* __restrict__ kf_obs,
                                                const Scratch& s, double (&acc)[42]) {
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
}

// Pose k from its summed couplings tot (42): D = Hpp_d - tot, its inverse
// (+1e-5 I), and the start of CG: x = 0, r = b_s = (bp - tot[36..]) free,
// z = p = D^-1 r.  One thread.
__device__ __forceinline__ void pose_setup_finish(int k, const double* tot, const float* __restrict__ Hpp,
                                                  const float* __restrict__ bp, const uint8_t* __restrict__ pose_fixed,
                                                  const float* __restrict__ lam, Scratch s) {
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

// One CTA per pose: its sums, reduced in a fixed order, then its setup.
__global__ void __launch_bounds__(kPoseThreads)
pose_setup_kernel(const float* __restrict__ Hpp, const float* __restrict__ bp, const float* __restrict__ W,
                  const int* __restrict__ obs_lm, const int* __restrict__ kf_ptr, const int* __restrict__ kf_obs,
                  const uint8_t* __restrict__ pose_fixed, const float* __restrict__ lam, Scratch s) {
  __shared__ double part[kPoseThreads / 32][42];
  __shared__ double tot[42];
  const int k = blockIdx.x;
  double acc[42];
  pose_setup_sums(k, W, obs_lm, kf_ptr, kf_obs, s, acc);
  block_reduce<42, kPoseThreads>(acc, part, tot);
  if (threadIdx.x == 0) pose_setup_finish(k, tot, Hpp, bp, pose_fixed, lam, s);
}

__global__ void __launch_bounds__(kVecThreads) dot_rz_kernel(int n, Scratch s) {
  __shared__ double sh[33];
  double v = 0.0;
  for (int i = threadIdx.x; i < n; i += kVecThreads) v += s.r[i] * s.z[i];
  v = jacobi::block_sum(v, sh);
  if (threadIdx.x == 0) s.scal[0] = v;
}

// t = sum over landmark m's observations (in the landmark CSR) of W_o^T v_kf,
// the fixed poses left out.
__device__ __forceinline__ void lm_sums(int m, const float* __restrict__ W, const int* __restrict__ obs_kf,
                                        const int* __restrict__ lm_ptr, const int* __restrict__ lm_obs,
                                        const uint8_t* __restrict__ pose_fixed, const double* __restrict__ v,
                                        double (&t)[3]) {
  t[0] = t[1] = t[2] = 0.0;
  for (int j = lm_ptr[m]; j < lm_ptr[m + 1]; ++j) {
    const int o = lm_obs[j], k = obs_kf[o];
    if (pose_fixed[k]) continue;
    const float* Wo = W + 18 * o;
    for (int c = 0; c < 3; ++c)
      for (int a = 0; a < 6; ++a) t[c] += Wo[3 * a + c] * v[6 * k + a];
  }
}

// out = V_m^-1 t.
__device__ __forceinline__ void apply_vinv(const double* __restrict__ Vi, const double (&t)[3], double* out) {
  for (int r = 0; r < 3; ++r) out[r] = Vi[3 * r] * t[0] + Vi[3 * r + 1] * t[1] + Vi[3 * r + 2] * t[2];
}

// y_m = V_m^-1 sum over m's observations of W_o^T v_kf, v = p * free.
__global__ void __launch_bounds__(kLmThreads)
lm_pass_kernel(const float* __restrict__ W, const int* __restrict__ obs_kf, const int* __restrict__ lm_ptr,
               const int* __restrict__ lm_obs, const uint8_t* __restrict__ pose_fixed, const double* __restrict__ v,
               int M, Scratch s) {
  const int m = blockIdx.x * kLmThreads + threadIdx.x;
  if (m >= M) return;
  double t[3];
  lm_sums(m, W, obs_kf, lm_ptr, lm_obs, pose_fixed, v, t);
  apply_vinv(s.Vinv + 9 * m, t, s.y + 3 * m);
}

// A thread's share of sum over pose k's observations of W_o y_lm; with
// kApplyVinv, y_lm = V^-1 t_lm formed here from ``y`` holding t.
template <bool kApplyVinv = false>
__device__ __forceinline__ void pose_sums(int k, const float* __restrict__ W, const int* __restrict__ obs_lm,
                                          const int* __restrict__ kf_ptr, const int* __restrict__ kf_obs,
                                          const double* __restrict__ y, const double* __restrict__ Vinv,
                                          double (&acc)[6]) {
  for (int a = 0; a < 6; ++a) acc[a] = 0.0;
  for (int j = kf_ptr[k] + threadIdx.x; j < kf_ptr[k + 1]; j += kPoseThreads) {
    const int o = kf_obs[j], m = obs_lm[o];
    const float* Wo = W + 18 * o;
    double ym[3];
    if constexpr (kApplyVinv) {
      const double t[3] = {y[3 * m], y[3 * m + 1], y[3 * m + 2]};
      apply_vinv(Vinv + 9 * m, t, ym);
    } else {
      ym[0] = y[3 * m], ym[1] = y[3 * m + 1], ym[2] = y[3 * m + 2];
    }
    for (int a = 0; a < 6; ++a) acc[a] += Wo[3 * a] * ym[0] + Wo[3 * a + 1] * ym[1] + Wo[3 * a + 2] * ym[2];
  }
}

// (S p)_k,a = (Hpp_d p_k - tot)_a free_k.
__device__ __forceinline__ double pose_Ap(int k, int a, double tot_a, const uint8_t* __restrict__ pose_fixed,
                                          const Scratch& s) {
  double hv = 0.0;
  if (!pose_fixed[k])
    for (int b = 0; b < 6; ++b) hv += s.Hpp_d[36 * k + 6 * a + b] * s.p[6 * k + b];
  return pose_fixed[k] ? 0.0 : hv - tot_a;
}

// (S p)_k = (Hpp_d p_k - sum over k's observations of W_o y_lm) free_k.
__global__ void __launch_bounds__(kPoseThreads)
pose_pass_kernel(const float* __restrict__ W, const int* __restrict__ obs_lm, const int* __restrict__ kf_ptr,
                 const int* __restrict__ kf_obs, const uint8_t* __restrict__ pose_fixed, Scratch s) {
  __shared__ double part[kPoseThreads / 32][6];
  __shared__ double tot[6];
  const int k = blockIdx.x;
  double acc[6];
  pose_sums(k, W, obs_lm, kf_ptr, kf_obs, s.y, s.Vinv, acc);
  block_reduce<6, kPoseThreads>(acc, part, tot);
  if (threadIdx.x < 6) s.Ap[6 * k + threadIdx.x] = pose_Ap(k, threadIdx.x, tot[threadIdx.x], pose_fixed, s);
}

// One CG update over the 6K vector, with the reference's freeze: alpha and
// beta are 0 once r.z <= 1e-12.
__device__ __forceinline__ void cg_update(const uint8_t* __restrict__ pose_fixed, int K, Scratch s, double* sh) {
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

__global__ void __launch_bounds__(kVecThreads)
cg_update_kernel(const uint8_t* __restrict__ pose_fixed, int K, Scratch s) {
  __shared__ double sh[33];
  cg_update(pose_fixed, K, s, sh);
}

// dl_g = V^-1 (bl - t) where the landmark is seen and valid, t = sum W_o^T dp.
__device__ __forceinline__ void backsub_landmark(int g, const double (&t)[3], const float* __restrict__ bl,
                                                 const float* __restrict__ w_lm, const uint8_t* __restrict__ lm_valid,
                                                 const Scratch& s, float* __restrict__ dl) {
  const bool keep = w_lm[g] > 0.f && lm_valid[g];
  const double* Vi = s.Vinv + 9 * g;
  const double rhs[3] = {bl[3 * g] - t[0], bl[3 * g + 1] - t[1], bl[3 * g + 2] - t[2]};
  for (int r = 0; r < 3; ++r)
    dl[3 * g + r] = keep ? (float)(Vi[3 * r] * rhs[0] + Vi[3 * r + 1] * rhs[1] + Vi[3 * r + 2] * rhs[2]) : 0.f;
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
  double t[3];
  lm_sums(g, W, obs_kf, lm_ptr, lm_obs, pose_fixed, s.x, t);
  backsub_landmark(g, t, bl, w_lm, lm_valid, s, dl);
}

}  // namespace
}  // namespace ba_t
