// Kernel AC's device code (csrc/ba_lm.cu, whose head says what it does): the
// candidate, cost, commit and chi2-gate kernels.  Included by ba_lm.cu
// (kernel AC's entries) and ba_shard.cu (kernel AF, which reduces the cost
// over the ranks between the cost and the commit launches).
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ba_obs.cuh"
#include "camera.cuh"

namespace ba_ac {
namespace {


constexpr int kThreads = 256;
constexpr int kMaxGrid = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

int grid_for(int n) { return (n + kThreads - 1) / kThreads < kMaxGrid ? (n + kThreads - 1) / kThreads : kMaxGrid; }

// R_out, t_out = exp(xi) (R, t) for xi = [rho, phi] (lie.se3_exp: so3_exp(phi) and the left Jacobian
// Jl(phi) = Jr(-phi) applied to rho).
__device__ void exp_compose(const float* __restrict__ xi, const float* __restrict__ R, const float* __restrict__ t,
                            float* __restrict__ R_out, float* __restrict__ t_out) {
  const float w[3] = {xi[3], xi[4], xi[5]};
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = th2 < 1e-8f;
  const float th = sqrtf(fmaxf(th2, 1e-16f));
  const float a = small ? 1.f - th2 / 6.f : sinf(th) / th;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / fmaxf(th2, 1e-16f);
  const float c = small ? 1.f / 6.f - th2 / 120.f : (th - sinf(th)) / fmaxf(th2 * th, 1e-24f);
  const float W[3][3] = {{0.f, -w[2], w[1]}, {w[2], 0.f, -w[0]}, {-w[1], w[0], 0.f}};
  float E[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float w2 = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float id = i == j ? 1.f : 0.f;
      E[i][j] = id + a * W[i][j] + b * w2;
      V[i][j] = id + b * W[i][j] + c * w2;
    }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R_out[3 * i + j] = E[i][0] * R[j] + E[i][1] * R[3 + j] + E[i][2] * R[6 + j];
    t_out[i] = (E[i][0] * t[0] + E[i][1] * t[1] + E[i][2] * t[2]) +
               (V[i][0] * xi[0] + V[i][1] * xi[1] + V[i][2] * xi[2]);
  }
}

__global__ void __launch_bounds__(kThreads)
candidate_kernel(const float* __restrict__ R, const float* __restrict__ t, const float* __restrict__ xw,
                 const float* __restrict__ dp, const float* __restrict__ dl, int n_kf, int n_lm,
                 float* __restrict__ R_out, float* __restrict__ t_out, float* __restrict__ xw_out,
                 double* __restrict__ acc) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *acc = 0.0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_kf + n_lm; i += gridDim.x * blockDim.x) {
    if (i < n_kf) {
      exp_compose(dp + 6 * i, R + 9 * i, t + 3 * i, R_out + 9 * i, t_out + 3 * i);
    } else {
      const int m = i - n_kf;
#pragma unroll
      for (int c = 0; c < 3; ++c) xw_out[3 * m + c] = xw[3 * m + c] + dl[3 * m + c];
    }
  }
}

template <int kCam>
__global__ void __launch_bounds__(kThreads)
cost_kernel(const float* __restrict__ cam10, const float* __restrict__ R, const float* __restrict__ t,
            const float* __restrict__ xw, const uint8_t* __restrict__ lm_valid, const int* __restrict__ obs_kf,
            const int* __restrict__ obs_lm, const float* __restrict__ obs_uv, const float* __restrict__ inv_s2,
            const uint8_t* __restrict__ is_stereo, const uint8_t* __restrict__ obs_valid,
            const uint8_t* __restrict__ inlier, int n_obs, double* __restrict__ acc) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  float rho = 0.f;
  if (o < n_obs) {
    const int k = obs_kf[o], m = obs_lm[o];
    const ba_obs::Residual ob =
        ba_obs::residual<kCam, true>(cam10, R + 9 * k, t + 3 * k, xw + 3 * m, obs_uv + 3 * o, is_stereo[o], inv_s2[o]);
    if (obs_valid[o] && inlier[o] && ob.xc[2] > 0.05f && lm_valid[m]) rho = ba_obs::huber_rho(ob.chi2, ob.delta2);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) rho += __shfl_down_sync(kFull, rho, s);
  if ((threadIdx.x & 31) == 0 && rho != 0.f) atomicAdd(acc, (double)rho);
}

__global__ void __launch_bounds__(kThreads)
commit_kernel(const float* __restrict__ R, const float* __restrict__ t, const float* __restrict__ xw, int n_kf,
              int n_lm, const double* __restrict__ acc, const float* __restrict__ cost_old,
              const uint8_t* __restrict__ ok, const float* __restrict__ lam, float* __restrict__ R_out,
              float* __restrict__ t_out, float* __restrict__ xw_out, float* __restrict__ lam_out,
              uint8_t* __restrict__ accept_out, float* __restrict__ cost_out) {
  const float cost_new = (float)*acc;
  const bool accept = (ok == nullptr || *ok) && cost_new < *cost_old;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const float l = *lam;
    *lam_out = accept ? fmaxf(l * 0.5f, 1e-8f) : fminf(l * 5.f, 1e6f);
    *accept_out = accept;
    *cost_out = cost_new;
  }
  if (accept) return;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_kf + n_lm; i += gridDim.x * blockDim.x) {
    if (i < n_kf) {
#pragma unroll
      for (int j = 0; j < 9; ++j) R_out[9 * i + j] = R[9 * i + j];
#pragma unroll
      for (int j = 0; j < 3; ++j) t_out[3 * i + j] = t[3 * i + j];
    } else {
      const int m = i - n_kf;
#pragma unroll
      for (int c = 0; c < 3; ++c) xw_out[3 * m + c] = xw[3 * m + c];
    }
  }
}

template <int kCam>
__global__ void __launch_bounds__(kThreads)
classify_kernel(const float* __restrict__ cam10, const float* __restrict__ R, const float* __restrict__ t,
                const float* __restrict__ xw, const int* __restrict__ obs_kf, const int* __restrict__ obs_lm,
                const float* __restrict__ obs_uv, const float* __restrict__ inv_s2,
                const uint8_t* __restrict__ is_stereo, const uint8_t* __restrict__ obs_valid, int n_obs,
                uint8_t* __restrict__ inlier) {
  for (int o = blockIdx.x * blockDim.x + threadIdx.x; o < n_obs; o += gridDim.x * blockDim.x) {
    const int k = obs_kf[o], m = obs_lm[o];
    const ba_obs::Residual ob =
        ba_obs::residual<kCam, true>(cam10, R + 9 * k, t + 3 * k, xw + 3 * m, obs_uv + 3 * o, is_stereo[o], inv_s2[o]);
    inlier[o] = ob.chi2 <= ob.delta2 && ob.xc[2] > 0.05f && obs_valid[o];
  }
}

}  // namespace
}  // namespace ba_ac
