// Kernel E: local-BA normal-equation blocks, one thread per observation:
// residual, closed-form stereo pin-hole Jacobian, Huber weight, float64
// atomic sums into Hpp / Hll / bp / bl / w_lm / cost and the per-observation
// coupling W_o = Jp^T w Jl; a second launch rounds the sums to float32.  The
// order in which the atomics land moves a float64 sum of float32 terms by
// ~1e-16 of its size, which the rounding hides: a run repeats bit for bit,
// where float32 atomics would round each run differently and a System's
// runs on the card would drift apart.  The camera's kind is a template
// parameter (camera.cuh): a radial-tangential camera takes the kRadtan
// instance, a Kannala-Brandt one kKB8, one without distortion the code it
// always ran.  See the source note in optim/ba.py; build_normal_blocks_plain
// there is the JAX form with the dense Z.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "camera.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;
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
    const float fx = cam10[0], fy = cam10[1], cx = cam10[2], cy = cam10[3], bf = cam10[4];
    const int k = obs_kf[o], m = obs_lm[o];
    const float* Rk = R + 9 * k;
    const float X = xw[3 * m], Y = xw[3 * m + 1], Z = xw[3 * m + 2];
    float xc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) xc[i] = Rk[3 * i] * X + Rk[3 * i + 1] * Y + Rk[3 * i + 2] * Z + t[3 * k + i];
    const float z = fabsf(xc[2]) < 1e-9f ? 1e-9f : xc[2];
    const float iz = 1.f / z;
    float u, v;
    cam::Radtan dist = {};
    if constexpr (kCam == cam::kKB8) {
      cam::kb8_project(cam::kb8_from10(cam10), xc[0], xc[1], xc[2], u, v);
    } else if constexpr (kCam == cam::kRadtan) {
      dist = {cam10[5], cam10[6], cam10[7], cam10[8], cam10[9]};
      float xd, yd;
      cam::distort(dist, xc[0] / z, xc[1] / z, xd, yd);
      u = fx * xd + cx;
      v = fy * yd + cy;
    } else {
      u = fx * (xc[0] * iz) + cx;
      v = fy * (xc[1] * iz) + cy;
    }
    const bool stereo = is_stereo[o];
    float r[3];
    r[0] = obs_uv[3 * o] - u;
    r[1] = obs_uv[3 * o + 1] - v;
    r[2] = stereo ? obs_uv[3 * o + 2] - (u - bf * iz) : 0.f;
    const float s2 = inv_s2[o];
    const float chi2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * s2;
    const float delta2 = stereo ? kChi2Stereo : kChi2Mono;
    const bool active = obs_valid[o] && inlier[o] && xc[2] > 0.05f && lm_valid[m];
    const float w_h = chi2 <= delta2 ? 1.f : sqrtf(delta2 / fmaxf(chi2, 1e-12f));
    const float w = active ? w_h * s2 : 0.f;
    if (active)
      rho = chi2 <= delta2 ? chi2 : 2.f * sqrtf(delta2 * fmaxf(chi2, 1e-12f)) - delta2;
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
        cam::pixel_jac(fx, fy, dist, xn, yn, iz, J);
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

// cam10: the camera's (10,) slots on the device (camera.cuh); kind: cam::Kind (0 pin-hole, 1 radtan, 2 KB8)
extern "C" int ba_blocks_launch(const float* cam10, int kind, const float* R, const float* t, const float* xw,
                                const uint8_t* pose_fixed, const uint8_t* lm_valid,
                                const int* obs_kf, const int* obs_lm, const float* obs_uv,
                                const float* inv_s2, const uint8_t* is_stereo,
                                const uint8_t* obs_valid, const uint8_t* inlier, int n_obs,
                                int n_kf, int n_lm, float* W, double* acc, float* out,
                                void* stream) {
  // acc: the zeroed float64 sums; out: the same layout in float32
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_obs > 0) {
    const int grid = (n_obs + kThreads - 1) / kThreads;
    if (kind == cam::kKB8)
      ba_blocks_kernel<cam::kKB8><<<grid, kThreads, 0, st>>>(cam10, R, t, xw, pose_fixed, lm_valid, obs_kf, obs_lm,
                                                             obs_uv, inv_s2, is_stereo, obs_valid, inlier, n_obs,
                                                             n_kf, n_lm, W, acc);
    else if (kind == cam::kRadtan)
      ba_blocks_kernel<cam::kRadtan><<<grid, kThreads, 0, st>>>(cam10, R, t, xw, pose_fixed, lm_valid, obs_kf,
                                                                obs_lm, obs_uv, inv_s2, is_stereo, obs_valid, inlier,
                                                                n_obs, n_kf, n_lm, W, acc);
    else
      ba_blocks_kernel<cam::kPinhole><<<grid, kThreads, 0, st>>>(cam10, R, t, xw, pose_fixed, lm_valid, obs_kf,
                                                                 obs_lm, obs_uv, inv_s2, is_stereo, obs_valid, inlier,
                                                                 n_obs, n_kf, n_lm, W, acc);
  }
  const int n = 42 * n_kf + 13 * n_lm + 1;
  const int grid = (n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024;
  round_kernel<<<grid, 256, 0, st>>>(acc, out, n);
  return cudaGetLastError();
}
