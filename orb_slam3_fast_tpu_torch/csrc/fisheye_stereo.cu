// Kernel AB: the gates and the triangulation of the non-rectified (fisheye)
// two-camera stereo match, one thread per left keypoint, after kernel C's
// mutual mode has given each left keypoint its best and second-best right
// one and each right keypoint its best left one: the ratio gate, TH_HIGH and
// mutual consistency; the KB8 unprojection of both keypoints (camera.cuh);
// the parallax cosine of the two rays in the left frame; the DLT with
// P1 = [I | 0], P2 = [R_rl | t_rl] on the rays' xy (jacobi.cuh, kernel G's
// routine, float64 Jacobi); depth > 0.05 in both views, the reprojection chi2
// within 5.991 sigma^2 in both KB8 views and a finite point.  Products and
// sums that decide a gate are rounded one by one (__f*_rn), as the plain
// version computes them.  See the source note in ops/matching.py;
// fisheye_stereo_gate_plain there is the same function in PyTorch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "camera.cuh"
#include "jacobi.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kChi2 = 5.991f;
constexpr float kMinZ = 0.05f;

struct Rig {
  cam::KB8 l, r;
  float P1[12], P2[12];  // [I | 0] and [R_rl | t_rl], row-major
  float ratio, min_cos;
  int th;
};

__global__ void __launch_bounds__(kThreads)
fisheye_stereo_kernel(const float* __restrict__ xy_l, const int64_t* __restrict__ level_l,
                      const float* __restrict__ xy_r, const int64_t* __restrict__ level_r,
                      const int64_t* __restrict__ idx, const int* __restrict__ dist, const int* __restrict__ dist2,
                      const int64_t* __restrict__ col, const float* __restrict__ sigma2, int n, Rig rig,
                      float* __restrict__ depth, float* __restrict__ x3d, bool* __restrict__ valid) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int j = (int)idx[i];
  // (ii) hamming.ratio_gate and mutual_consistency
  bool ok = dist[i] < rig.th && (float)dist[i] < __fmul_rn(rig.ratio, (float)dist2[i]) && col[j] == i;
  // (iii) the rays, unit z
  const float ul = xy_l[2 * i], vl = xy_l[2 * i + 1], ur = xy_r[2 * j], vr = xy_r[2 * j + 1];
  float r1[3] = {0.f, 0.f, 1.f}, r2[3] = {0.f, 0.f, 1.f};
  cam::kb8_unproject(rig.l, ul, vl, r1[0], r1[1]);
  cam::kb8_unproject(rig.r, ur, vr, r2[0], r2[1]);
  // (iv) the parallax in the left frame: r2 by R_lr = R_rl^T
  const float* P = rig.P2;
  float q[3];
  for (int a = 0; a < 3; ++a)
    q[a] = __fadd_rn(__fadd_rn(__fmul_rn(P[a], r2[0]), __fmul_rn(P[4 + a], r2[1])), __fmul_rn(P[8 + a], r2[2]));
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(r1[0], q[0]), __fmul_rn(r1[1], q[1])), __fmul_rn(r1[2], q[2]));
  const float n1 = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(r1[0], r1[0]), __fmul_rn(r1[1], r1[1])), 1.f));
  const float n2 = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(q[0], q[0]), __fmul_rn(q[1], q[1])), __fmul_rn(q[2], q[2])));
  ok = ok && __fdiv_rn(dot, __fmul_rn(n1, n2)) < rig.min_cos;
  // (v) the DLT in the left frame
  float X[3];
  jacobi::dlt_triangulate(rig.P1, rig.P2, r1[0], r1[1], r2[0], r2[1], X);
  // (vi) depth in both views, the reprojection in both KB8 views, a finite point
  float xc2[3];
  for (int a = 0; a < 3; ++a)
    xc2[a] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(P[4 * a], X[0]), __fmul_rn(P[4 * a + 1], X[1])),
                                 __fmul_rn(P[4 * a + 2], X[2])), P[4 * a + 3]);
  float pu, pv, qu, qv;
  cam::kb8_project(rig.l, X[0], X[1], X[2], pu, pv);
  cam::kb8_project(rig.r, xc2[0], xc2[1], xc2[2], qu, qv);
  const float du1 = __fsub_rn(pu, ul), dv1 = __fsub_rn(pv, vl), du2 = __fsub_rn(qu, ur), dv2 = __fsub_rn(qv, vr);
  const float e1 = __fadd_rn(__fmul_rn(du1, du1), __fmul_rn(dv1, dv1));
  const float e2 = __fadd_rn(__fmul_rn(du2, du2), __fmul_rn(dv2, dv2));
  ok = ok && X[2] > kMinZ && xc2[2] > kMinZ && e1 <= __fmul_rn(kChi2, sigma2[level_l[i]]) &&
       e2 <= __fmul_rn(kChi2, sigma2[level_r[j]]) && isfinite(X[0]) && isfinite(X[1]) && isfinite(X[2]);
  depth[i] = ok ? X[2] : -1.f;
  x3d[3 * i] = X[0];
  x3d[3 * i + 1] = X[1];
  x3d[3 * i + 2] = X[2];
  valid[i] = ok;
}

}  // namespace

// Per left keypoint (n): xy_l (n,2), level_l (n,) int64, and kernel C's mutual best-2: idx (n,) int64, dist,
// dist2 (n,) int32; per right keypoint: xy_r (m,2), level_r (m,) int64, col (m,) int64 (its best left row);
// sigma2 (levels,) on the device.  cams16 (host): the left and right KB8 [fx, fy, cx, cy, k1, k2, k3, k4];
// Rt (host): R_rl (9, row-major) | t_rl (3).  Outputs: depth (n,), x3d (n,3), valid (n,).
extern "C" int fisheye_stereo_launch(const float* xy_l, const int64_t* level_l, const float* xy_r,
                                     const int64_t* level_r, const int64_t* idx, const int* dist, const int* dist2,
                                     const int64_t* col, const float* sigma2, int n, const float* cams16,
                                     const float* Rt, float ratio, int th, float min_cos, float* depth, float* x3d,
                                     bool* valid, void* stream) {
  if (n <= 0) return cudaSuccess;
  Rig rig;
  const float* c = cams16;
  rig.l = {c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7]};
  rig.r = {c[8], c[9], c[10], c[11], c[12], c[13], c[14], c[15]};
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 4; ++b) {
      rig.P1[4 * a + b] = a == b ? 1.f : 0.f;
      rig.P2[4 * a + b] = b < 3 ? Rt[3 * a + b] : Rt[9 + a];
    }
  rig.ratio = ratio;
  rig.min_cos = min_cos;
  rig.th = th;
  fisheye_stereo_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xy_l, level_l, xy_r, level_r, idx, dist, dist2, col, sigma2, n, rig, depth, x3d, valid);
  return cudaGetLastError();
}
