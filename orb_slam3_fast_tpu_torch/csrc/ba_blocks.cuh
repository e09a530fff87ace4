// Kernel E's device code (csrc/ba_blocks.cu, whose head says what it does):
// the per-observation blocks kernel and the float64 -> float32 rounding.
// Included by ba_blocks.cu (kernel E's entry) and ba_shard.cu (kernel AF,
// which reduces the float64 sums over the ranks between the two launches).
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ba_obs.cuh"
#include "camera.cuh"

namespace ba_e {
namespace {


constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int kCam>
__global__ void __launch_bounds__(kThreads)
ba_blocks_kernel(const float* __restrict__ cam10, const float* __restrict__ R,
                 const float* __restrict__ t, const float* __restrict__ xw,
                 const uint8_t* __restrict__ pose_fixed, const uint8_t* __restrict__ lm_valid,
                 const int* __restrict__ obs_kf, const int* __restrict__ obs_lm,
                 const float* __restrict__ obs_uv, const float* __restrict__ inv_s2,
                 const uint8_t* __restrict__ is_stereo, const uint8_t* __restrict__ obs_valid,
                 const uint8_t* __restrict__ inlier, int n_obs, int n_kf, int n_lm,
                 float* __restrict__ W, double* __restrict__ acc) {
  // acc: Hpp (K,6,6) | Hll (M,3,3) | bp (K,6) | bl (M,3) | w_lm (M) | cost
  double* Hpp = acc;
  double* Hll = Hpp + 36 * n_kf;
  double* bp = Hll + 9 * n_lm;
  double* bl = bp + 6 * n_kf;
  double* w_lm = bl + 3 * n_lm;
  double* cost = w_lm + n_lm;
  const int o = blockIdx.x * kThreads + threadIdx.x;
  float rho = 0.f;
  if (o < n_obs) {
    const float fx = cam10[0], fy = cam10[1], bf = cam10[4];
    const int k = obs_kf[o], m = obs_lm[o];
    const float* Rk = R + 9 * k;
    const bool stereo = is_stereo[o];
    const float s2 = inv_s2[o];
    const ba_obs::Residual ob =
        ba_obs::residual<kCam, false>(cam10, Rk, t + 3 * k, xw + 3 * m, obs_uv + 3 * o, stereo, s2);
    const float(&xc)[3] = ob.xc;
    const float(&r)[3] = ob.r;
    const float iz = ob.iz, chi2 = ob.chi2, delta2 = ob.delta2;
    const bool active = obs_valid[o] && inlier[o] && xc[2] > 0.05f && lm_valid[m];
    const float w_h = chi2 <= delta2 ? 1.f : sqrtf(delta2 / fmaxf(chi2, 1e-12f));
    const float w = active ? w_h * s2 : 0.f;
    if (active) rho = ba_obs::huber_rho(chi2, delta2);
    const bool free_pose = !pose_fixed[k];
    // rows a of d(u, v, u_r)/d(xc); Jp row = -(a [I | -hat(xc)]), Jl row = -(a R);
    // the signs cancel in every product below except b = -J^T w r
    const float xn = xc[0] * iz, yn = xc[1] * iz;
    float A[3][3] = {{fx * iz, 0.f, -fx * xn * iz},
                     {0.f, fy * iz, -fy * yn * iz},
                     {fx * iz, 0.f, -fx * xn * iz + bf * iz * iz}};
    if constexpr (kCam != cam::kPinhole) {  // rows of models.stereo_project_jac with the camera's Jacobian
      float J[2][3];
      if constexpr (kCam == cam::kKB8)
        cam::kb8_jac(cam::kb8_from10(cam10), xc[0], xc[1], xc[2], J);
      else
        cam::pixel_jac(fx, fy, ob.dist, xn, yn, iz, J);
      for (int k = 0; k < 3; ++k) {
        A[0][k] = A[2][k] = J[0][k];
        A[1][k] = J[1][k];
      }
      A[2][2] = J[0][2] + bf * iz * iz;
    }
    float hpp[21] = {}, hll[6] = {}, gp[6] = {}, gl[3] = {}, wo[18] = {};
    const int rows = stereo ? 3 : 2;
    for (int q = 0; q < rows; ++q) {
      const float a0 = A[q][0], a1 = A[q][1], a2 = A[q][2];
      float jp[6] = {a0, a1, a2, a2 * xc[1] - a1 * xc[2], a0 * xc[2] - a2 * xc[0],
                     a1 * xc[0] - a0 * xc[1]};
      if (!free_pose)
#pragma unroll
        for (int i = 0; i < 6; ++i) jp[i] = 0.f;
      float jl[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) jl[c] = a0 * Rk[c] + a1 * Rk[3 + c] + a2 * Rk[6 + c];
      int h = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i; j < 6; ++j) hpp[h++] += w * (jp[i] * jp[j]);
      h = 0;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = i; j < 3; ++j) hll[h++] += w * (jl[i] * jl[j]);
#pragma unroll
      for (int i = 0; i < 6; ++i) gp[i] += w * jp[i] * r[q];
#pragma unroll
      for (int i = 0; i < 3; ++i) gl[i] += w * jl[i] * r[q];
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) wo[3 * i + j] += w * (jp[i] * jl[j]);
    }
#pragma unroll
    for (int i = 0; i < 18; ++i) W[18 * o + i] = wo[i];
    if (w != 0.f) {
      double* H = Hpp + 36 * k;
      int h = 0;
      for (int i = 0; i < 6; ++i)
        for (int j = i; j < 6; ++j, ++h) {
          atomicAdd(&H[6 * i + j], (double)hpp[h]);
          if (j != i) atomicAdd(&H[6 * j + i], (double)hpp[h]);
        }
      double* L = Hll + 9 * m;
      h = 0;
      for (int i = 0; i < 3; ++i)
        for (int j = i; j < 3; ++j, ++h) {
          atomicAdd(&L[3 * i + j], (double)hll[h]);
          if (j != i) atomicAdd(&L[3 * j + i], (double)hll[h]);
        }
      for (int i = 0; i < 6; ++i) atomicAdd(&bp[6 * k + i], (double)gp[i]);
      for (int i = 0; i < 3; ++i) atomicAdd(&bl[3 * m + i], (double)gl[i]);
      atomicAdd(&w_lm[m], (double)w);
    }
  }
  // the robust cost: a warp sum, then one atomic per warp
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) rho += __shfl_down_sync(kFull, rho, s);
  if ((threadIdx.x & 31) == 0 && rho != 0.f) atomicAdd(cost, (double)rho);
}

__global__ void round_kernel(const double* __restrict__ acc, float* __restrict__ out, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    out[i] = (float)acc[i];
}

}  // namespace
}  // namespace ba_e
