// One observation of the local and global BA at one state: the camera point,
// the residual of ba._obs_residuals and the Huber cost of ba._robust_cost, in
// float32 and in the order kernel E (ba_blocks.cu) has always computed them.
// Kernel E builds its blocks from it and kernel AC (ba_lm.cu) its candidate's
// cost, so that, at one state, the two costs are the same bits: a zero LM
// step is then rejected on the card as the plain version rejects it.
//
// The compiler fuses a product into the sum it feeds (an FMA) or not by its
// context: in kernel E the products fx x/z, fy y/z and bf/z and the KB8
// camera's x^2 and y^2 are reused by the Jacobian, and its PTX leaves them
// unfused (a mul, then an add or sub), where alone in AC they would fuse and
// round otherwise.  So AC's instance (kPinned) rounds those products and
// sums by __fmul_rn / __fadd_rn, as E does, while E's instance keeps the
// expressions E always had, and so its bits.  Both kernels then compute the
// same residual; chip_smoke.py phase 3 holds them to it one observation at a
// time.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include "camera.cuh"

namespace ba_obs {

constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;

struct Residual {
  float xc[3];  // the camera point
  float z, iz;  // its depth kept off zero, and 1 / z
  float r[3];   // observed - projected (u, v, u_r); r[2] = 0 on a mono edge
  float chi2, delta2;
  cam::Radtan dist;  // the camera's distortion (kRadtan), for the caller's Jacobian
};

// Observation (uv, stereo) of point x from pose (Rk, tk) through the camera's (10,) slots.
template <int kCam, bool kPinned>
__device__ __forceinline__ Residual residual(const float* __restrict__ cam10, const float* __restrict__ Rk,
                                             const float* __restrict__ tk, const float* __restrict__ x,
                                             const float* __restrict__ uv, bool stereo, float s2) {
  Residual q;
  const float fx = cam10[0], fy = cam10[1], cx = cam10[2], cy = cam10[3], bf = cam10[4];
  const float X = x[0], Y = x[1], Z = x[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) q.xc[i] = Rk[3 * i] * X + Rk[3 * i + 1] * Y + Rk[3 * i + 2] * Z + tk[i];
  q.z = fabsf(q.xc[2]) < 1e-9f ? 1e-9f : q.xc[2];
  q.iz = 1.f / q.z;
  float u, v;
  q.dist = {};
  if constexpr (kCam == cam::kKB8 && kPinned) {  // camera.cuh's kb8_project, its radius summed unfused
    const cam::KB8 c = cam::kb8_from10(cam10);
    const float px = q.xc[0], py = q.xc[1];
    const float r = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)), cam::kEps2));
    const float scale = cam::kb8_poly(c, atan2f(r, q.xc[2])) / r;
    u = c.fx * scale * px + c.cx;
    v = c.fy * scale * py + c.cy;
  } else if constexpr (kCam == cam::kKB8) {
    cam::kb8_project(cam::kb8_from10(cam10), q.xc[0], q.xc[1], q.xc[2], u, v);
  } else if constexpr (kCam == cam::kRadtan) {
    q.dist = {cam10[5], cam10[6], cam10[7], cam10[8], cam10[9]};
    float xd, yd;
    cam::distort(q.dist, q.xc[0] / q.z, q.xc[1] / q.z, xd, yd);
    u = fx * xd + cx;
    v = fy * yd + cy;
  } else if constexpr (kPinned) {
    u = __fmul_rn(fx, q.xc[0] * q.iz) + cx;
    v = __fmul_rn(fy, q.xc[1] * q.iz) + cy;
  } else {
    u = fx * (q.xc[0] * q.iz) + cx;
    v = fy * (q.xc[1] * q.iz) + cy;
  }
  q.r[0] = uv[0] - u;
  q.r[1] = uv[1] - v;
  if constexpr (kPinned)
    q.r[2] = stereo ? uv[2] - (u - __fmul_rn(bf, q.iz)) : 0.f;
  else
    q.r[2] = stereo ? uv[2] - (u - bf * q.iz) : 0.f;
  q.chi2 = (q.r[0] * q.r[0] + q.r[1] * q.r[1] + q.r[2] * q.r[2]) * s2;
  q.delta2 = stereo ? kChi2Stereo : kChi2Mono;
  return q;
}

// Huber rho(chi2): chi2 inside delta2, 2 sqrt(delta2 chi2) - delta2 outside.
__device__ __forceinline__ float huber_rho(float chi2, float delta2) {
  return chi2 <= delta2 ? chi2 : 2.f * sqrtf(delta2 * fmaxf(chi2, 1e-12f)) - delta2;
}

}  // namespace ba_obs
