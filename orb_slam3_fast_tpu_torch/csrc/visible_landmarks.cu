// Kernel L: frustum, distance-band and view-angle test of the local map's
// landmark slots and their predicted pyramid level (Frame::isInFrustum and
// MapPoint::PredictScale).  See the source note in frontend/tracker.py;
// visible_landmarks_plain there is the same function in PyTorch.  A
// Kannala-Brandt camera takes the kKB8 instance (camera.cuh); a pin-hole one
// the code it always ran.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "camera.cuh"

namespace {

struct Cam {
  float fx, fy, cx, cy, k1, k2, p1, p2, k3;  // pin-hole + radial-tangential
  cam::KB8 kb;                               // or Kannala-Brandt (kKB8)
  float width, height;                       // image bounds
  float log_sf;                              // log(scale factor)
  int n_lvl;
};

// One thread per landmark slot; R (3,3) and t (3,) are read from device
// memory, so the tracker's pose estimate never comes to the host for this.
template <int kCam>
__global__ void __launch_bounds__(256)
visible_kernel(const float* __restrict__ R, const float* __restrict__ t, const float* __restrict__ pos,
               const bool* __restrict__ mask, const float* __restrict__ normal, const float* __restrict__ dmin,
               const float* __restrict__ dmax, int m, Cam cam, float* __restrict__ uv,
               long long* __restrict__ level, bool* __restrict__ visible) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float r[9], tt[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = R[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) tt[k] = t[k];
  const float px = pos[3 * i], py = pos[3 * i + 1], pz = pos[3 * i + 2];
  const float xc = r[0] * px + r[1] * py + r[2] * pz + tt[0];
  const float yc = r[3] * px + r[4] * py + r[5] * pz + tt[1];
  const float zc = r[6] * px + r[7] * py + r[8] * pz + tt[2];
  float u, v;
  if constexpr (kCam == cam::kKB8) {
    cam::kb8_project(cam.kb, xc, yc, zc, u, v);
  } else {
    // cameras.models.project, pin-hole: safe z, normalise, distort
    const float zs = fabsf(zc) < 1e-9f ? 1e-9f : zc;
    const float x = xc / zs, y = yc / zs;
    const float r2 = x * x + y * y;
    const float radial = 1.0f + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3));
    const float xd = x * radial + 2.0f * cam.p1 * x * y + cam.p2 * (r2 + 2.0f * x * x);
    const float yd = y * radial + cam.p1 * (r2 + 2.0f * y * y) + 2.0f * cam.p2 * x * y;
    u = cam.fx * xd + cam.cx, v = cam.fy * yd + cam.cy;
  }
  const bool z_ok = zc > 0.05f;
  const bool in_img = u >= 0.f && u < cam.width && v >= 0.f && v < cam.height;
  // camera centre -R^T t, the viewing ray from it, its length
  const float ox = px + (r[0] * tt[0] + r[3] * tt[1] + r[6] * tt[2]);
  const float oy = py + (r[1] * tt[0] + r[4] * tt[1] + r[7] * tt[2]);
  const float oz = pz + (r[2] * tt[0] + r[5] * tt[1] + r[8] * tt[2]);
  const float dist = sqrtf(ox * ox + oy * oy + oz * oz);
  const bool dist_ok = dist >= dmin[i] * 0.8f && dist <= dmax[i] * 1.2f;
  const float dsafe = fmaxf(dist, 1e-9f);
  const float view_cos = (ox * normal[3 * i] + oy * normal[3 * i + 1] + oz * normal[3 * i + 2]) / dsafe;
  const bool angle_ok = view_cos > 0.5f;
  const float ratio = fmaxf(dmax[i] / dsafe, 1.0f);
  const long long lvl = static_cast<long long>(ceilf(logf(ratio) / cam.log_sf));
  uv[2 * i] = u;
  uv[2 * i + 1] = v;
  level[i] = lvl < 0 ? 0 : (lvl > cam.n_lvl - 1 ? cam.n_lvl - 1 : lvl);
  visible[i] = mask[i] && z_ok && in_img && dist_ok && angle_ok;
}

}  // namespace

// R: (3,3) row-major T_cw rotation and t: (3,) on the device; pos, normal:
// (m,3); mask, dmin, dmax: (m,); cam_params: the camera's host (9,)
// parameters, pin-hole + radial-tangential [fx, fy, cx, cy, k1, k2, p1, p2,
// k3] or KB8 [fx, fy, cx, cy, k1, k2, k3, k4, 0]; kind: cam::Kind (a pin-hole
// camera runs the radial-tangential code with or without distortion).
// Outputs: uv (m,2), level (m,) int64, visible (m,).
extern "C" int visible_landmarks_launch(const float* R, const float* t, const float* pos, const bool* mask,
                                        const float* normal, const float* dmin, const float* dmax, int m,
                                        const float* cam_params, int kind, float width, float height, float log_sf,
                                        int n_lvl, float* uv, long long* level, bool* visible, void* stream) {
  if (m <= 0) return cudaSuccess;
  const float* p = cam_params;
  const cam::KB8 kb = {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
  const Cam cam{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], kb, width, height, log_sf, n_lvl};
  const int grid = (m + 255) / 256;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == cam::kKB8)
    visible_kernel<cam::kKB8><<<grid, 256, 0, st>>>(R, t, pos, mask, normal, dmin, dmax, m, cam, uv, level, visible);
  else
    visible_kernel<cam::kRadtan><<<grid, 256, 0, st>>>(R, t, pos, mask, normal, dmin, dmax, m, cam, uv, level,
                                                       visible);
  return cudaGetLastError();
}
