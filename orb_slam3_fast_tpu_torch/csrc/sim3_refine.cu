// Kernel R: OptimizeSim3 of loop verification in one CTA: iters // 3
// Gauss-Newton steps, the chi2 re-gate of the pairs, the rest, the final
// gate.  Per step every thread takes its pairs (residuals and the
// closed-form 2x7 Jacobians of sim3.pair_jacobians in float32, the Huber
// IRLS weight), accumulates its share of J^T W J (28 entries) and J^T W r
// (7) in float64, and the block reduces them in a fixed order (warp
// butterflies, then the warps in turn), so a run repeats bit for bit;
// thread 0 pins the scale under fix_scale, adds 1e-6 I, solves by a float64
// Cholesky and applies sim3_exp(dx) on the left with R re-orthonormalised
// (sim3.cuh).  The pair mask lives in the inlier output.  The cameras'
// kind picks the instance (camera.cuh): pin-hole cameras run the code they
// always ran, radial-tangential ones the distorted projection and its
// Jacobian, KB8 ones cam::kb8_project and cam::kb8_jac.  See the source note in
// optim/sim3.py; optimize_sim3_plain there is the same function in PyTorch.
#include <cuda_runtime.h>
#include <math.h>

#include "camera.cuh"
#include "jacobi.cuh"
#include "sim3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 35;  // 28 upper-triangle entries of H, then b
constexpr float kHuber = 3.16227766016838f;  // sqrt(10)

struct Cams {
  float fx1, fy1, cx1, cy1, fx2, fy2, cx2, cy2;
};

struct Dist {
  cam::Radtan d1, d2;
};

struct Fisheye {
  cam::KB8 k1, k2;
};

// y = S x2 and q = S^-1 x1 (float32, as the plain version maps them).
__device__ __forceinline__ void map_pair(const float* S, const float* x1, const float* x2, float (&y)[3],
                                         float (&q)[3]) {
  const float* R = S;
  const float s = S[12], si = 1.f / s;
  float ti[3];
  for (int r = 0; r < 3; ++r) {
    y[r] = s * (R[3 * r] * x2[0] + R[3 * r + 1] * x2[1] + R[3 * r + 2] * x2[2]) + S[9 + r];
    ti[r] = -si * (R[r] * S[9] + R[3 + r] * S[10] + R[6 + r] * S[11]);
  }
  for (int r = 0; r < 3; ++r) q[r] = si * (R[r] * x1[0] + R[3 + r] * x1[1] + R[6 + r] * x1[2]) + ti[r];
}

template <int kCam>
__device__ __forceinline__ void project(float fx, float fy, float cx, float cy, const cam::Radtan& d,
                                        const cam::KB8& kb, const float (&p)[3], float& u, float& v) {
  if constexpr (kCam == cam::kKB8) {
    cam::kb8_project(kb, p[0], p[1], p[2], u, v);
    return;
  }
  const float z = fabsf(p[2]) < 1e-9f ? 1e-9f : p[2];
  if constexpr (kCam == cam::kRadtan) {
    float xd, yd;
    cam::distort(d, p[0] / z, p[1] / z, xd, yd);
    u = fx * xd + cx;
    v = fy * yd + cy;
  } else {
    u = fx * (p[0] / z) + cx;
    v = fy * (p[1] / z) + cy;
  }
}

template <int kCam>
__device__ __forceinline__ bool gate(const float* S, const Cams& c, const Dist& dc, const Fisheye& kb,
                                     const float* x1, const float* x2, const float* uv1, const float* uv2, float is1,
                                     float is2, float chi2) {
  float y[3], q[3], u1, v1, u2, v2;
  map_pair(S, x1, x2, y, q);
  project<kCam>(c.fx1, c.fy1, c.cx1, c.cy1, dc.d1, kb.k1, y, u1, v1);
  project<kCam>(c.fx2, c.fy2, c.cx2, c.cy2, dc.d2, kb.k2, q, u2, v2);
  const float e1 = ((u1 - uv1[0]) * (u1 - uv1[0]) + (v1 - uv1[1]) * (v1 - uv1[1])) * is1;
  const float e2 = ((u2 - uv2[0]) * (u2 - uv2[0]) + (v2 - uv2[1]) * (v2 - uv2[1])) * is2;
  return e1 < chi2 && e2 < chi2 && y[2] > 0.f && q[2] > 0.f;
}

// d proj / d p (2x3) of the camera (cameras.project_jac).
template <int kCam>
__device__ __forceinline__ void proj_jac(float fx, float fy, const cam::Radtan& d, const cam::KB8& kb,
                                         const float (&p)[3], float (&D)[2][3]) {
  if constexpr (kCam == cam::kKB8) {
    cam::kb8_jac(kb, p[0], p[1], p[2], D);
    return;
  }
  const float z = fabsf(p[2]) < 1e-9f ? 1e-9f : p[2];
  const float iz = 1.f / z, xn = p[0] / z, yn = p[1] / z;
  if constexpr (kCam == cam::kRadtan) {
    cam::pixel_jac(fx, fy, d, xn, yn, iz, D);
  } else {
    D[0][0] = fx * iz, D[0][1] = 0.f, D[0][2] = -fx * xn * iz;
    D[1][0] = 0.f, D[1][1] = fy * iz, D[1][2] = -fy * yn * iz;
  }
}

// One edge's weighted contribution: J (2x7), residual r (2), weight w.
__device__ __forceinline__ void accumulate(const float (&J)[2][7], const float (&r)[2], float w, double (&acc)[kSums]) {
  int h = 0;
  for (int i = 0; i < 7; ++i)
    for (int j = i; j < 7; ++j, ++h)
      acc[h] += (double)w * ((double)J[0][i] * J[0][j] + (double)J[1][i] * J[1][j]);
  for (int i = 0; i < 7; ++i) acc[28 + i] += (double)w * ((double)J[0][i] * r[0] + (double)J[1][i] * r[1]);
}

template <int kCam>
__global__ void __launch_bounds__(kThreads)
refine_kernel(const float* __restrict__ xc1, const float* __restrict__ xc2, const float* __restrict__ uv1,
              const float* __restrict__ uv2, const float* __restrict__ is1, const float* __restrict__ is2,
              const bool* __restrict__ valid, const float* __restrict__ S0, int n, Cams c, Dist dc, Fisheye kb, int fix_scale,
              int iters,
              float chi2, float* __restrict__ S_out, bool* __restrict__ mask, int* __restrict__ n_inl) {
  __shared__ float S[13];
  __shared__ double part[kWarps][kSums];
  __shared__ double tot[kSums];
  __shared__ int cnt_w[kWarps];
  if (threadIdx.x < 13) S[threadIdx.x] = S0[threadIdx.x];
  for (int i = threadIdx.x; i < n; i += kThreads) mask[i] = valid[i];
  __syncthreads();
  const int half = iters / 3;
  for (int it = 0; it < iters; ++it) {
    if (it == half) {  // drop the pairs beyond chi2 (Optimizer.cc:2340-2400)
      for (int i = threadIdx.x; i < n; i += kThreads)
        mask[i] =
            mask[i] && gate<kCam>(S, c, dc, kb, xc1 + 3 * i, xc2 + 3 * i, uv1 + 2 * i, uv2 + 2 * i, is1[i], is2[i], chi2);
      __syncthreads();
    }
    double acc[kSums];
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
    const float si = 1.f / S[12];
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if (!mask[i]) continue;  // a zero weight adds nothing
      const float* x1 = xc1 + 3 * i;
      float y[3], q[3], u, v;
      map_pair(S, x1, xc2 + 3 * i, y, q);
      float D[2][3], J[2][7], r[2];
      // forward edge: d proj(y) [I | -hat(y) | y]
      project<kCam>(c.fx1, c.fy1, c.cx1, c.cy1, dc.d1, kb.k1, y, u, v);
      r[0] = u - uv1[2 * i], r[1] = v - uv1[2 * i + 1];
      proj_jac<kCam>(c.fx1, c.fy1, dc.d1, kb.k1, y, D);
      for (int a = 0; a < 2; ++a) {
        J[a][0] = D[a][0], J[a][1] = D[a][1], J[a][2] = D[a][2];
        J[a][3] = D[a][2] * y[1] - D[a][1] * y[2];
        J[a][4] = D[a][0] * y[2] - D[a][2] * y[0];
        J[a][5] = D[a][1] * y[0] - D[a][0] * y[1];
        J[a][6] = D[a][0] * y[0] + D[a][1] * y[1] + D[a][2] * y[2];
      }
      float c1 = sqrtf((r[0] * r[0] + r[1] * r[1]) * is1[i]);
      accumulate(J, r, fminf(kHuber / fmaxf(c1, 1e-9f), 1.f) * is1[i], acc);
      // inverse edge: -d proj(q) (R^T / s) [I | -hat(x1) | x1]
      project<kCam>(c.fx2, c.fy2, c.cx2, c.cy2, dc.d2, kb.k2, q, u, v);
      r[0] = u - uv2[2 * i], r[1] = v - uv2[2 * i + 1];
      proj_jac<kCam>(c.fx2, c.fy2, dc.d2, kb.k2, q, D);
      float P[3][7];  // -(R^T / s) [I | -hat(x1) | x1]
      for (int row = 0; row < 3; ++row) {
        const float g0 = -S[row] * si, g1 = -S[3 + row] * si, g2 = -S[6 + row] * si;  // row of -(R^T / s)
        P[row][0] = g0, P[row][1] = g1, P[row][2] = g2;
        P[row][3] = g2 * x1[1] - g1 * x1[2];
        P[row][4] = g0 * x1[2] - g2 * x1[0];
        P[row][5] = g1 * x1[0] - g0 * x1[1];
        P[row][6] = g0 * x1[0] + g1 * x1[1] + g2 * x1[2];
      }
      for (int a = 0; a < 2; ++a)
        for (int k = 0; k < 7; ++k) J[a][k] = D[a][0] * P[0][k] + D[a][1] * P[1][k] + D[a][2] * P[2][k];
      c1 = sqrtf((r[0] * r[0] + r[1] * r[1]) * is2[i]);
      accumulate(J, r, fminf(kHuber / fmaxf(c1, 1e-9f), 1.f) * is2[i], acc);
    }
    for (int k = 0; k < kSums; ++k) {
      double v = acc[k];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
      if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5][k] = v;
    }
    __syncthreads();
    if (threadIdx.x < kSums) {
      double v = 0.0;
      for (int w = 0; w < kWarps; ++w) v += part[w][threadIdx.x];
      tot[threadIdx.x] = v;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      double H[7][7], b[7], dx[7];
      int h = 0;
      for (int i = 0; i < 7; ++i)
        for (int j = i; j < 7; ++j, ++h) H[i][j] = H[j][i] = tot[h];
      for (int i = 0; i < 7; ++i) b[i] = tot[28 + i];
      if (fix_scale) {  // VertexSim3Expmap _fix_scale
        for (int i = 0; i < 7; ++i) H[6][i] = H[i][6] = 0.0;
        H[6][6] = 1.0;
        b[6] = 0.0;
      }
      for (int i = 0; i < 7; ++i) H[i][i] += 1e-6;
      double L[7][7] = {};  // Cholesky, H = L L^T
      for (int j = 0; j < 7; ++j) {
        double d = H[j][j];
        for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
        L[j][j] = sqrt(fmax(d, 1e-300));
        for (int i = j + 1; i < 7; ++i) {
          double v = H[i][j];
          for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
          L[i][j] = v / L[j][j];
        }
      }
      double y[7];
      for (int i = 0; i < 7; ++i) {
        double v = -b[i];
        for (int k = 0; k < i; ++k) v -= L[i][k] * y[k];
        y[i] = v / L[i][i];
      }
      for (int i = 6; i >= 0; --i) {
        double v = y[i];
        for (int k = i + 1; k < 7; ++k) v -= L[k][i] * dx[k];
        dx[i] = v / L[i][i];
      }
      double R[3][3], t[3], sc = S[12];
      for (int r = 0; r < 3; ++r) {
        for (int cc = 0; cc < 3; ++cc) R[r][cc] = S[3 * r + cc];
        t[r] = S[9 + r];
      }
      sim3::left_update(dx, R, t, sc);
      for (int r = 0; r < 3; ++r) {
        for (int cc = 0; cc < 3; ++cc) S[3 * r + cc] = (float)R[r][cc];
        S[9 + r] = (float)t[r];
      }
      S[12] = (float)sc;
    }
    __syncthreads();
  }
  int cnt = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool in =
        mask[i] && gate<kCam>(S, c, dc, kb, xc1 + 3 * i, xc2 + 3 * i, uv1 + 2 * i, uv2 + 2 * i, is1[i], is2[i], chi2);
    mask[i] = in;
    cnt += in;
  }
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xFFFFFFFFu, cnt, o);
  if ((threadIdx.x & 31) == 0) cnt_w[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x < 13) S_out[threadIdx.x] = S[threadIdx.x];
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += cnt_w[w];
    *n_inl = total;
  }
}

}  // namespace

// cams18 (host): per camera fx fy cx cy and k1 k2 p1 p2 k3 (kind 0 pin-hole, 1 radial-tangential) or k1 k2 k3 k4 0
// (kind 2, KB8), camera 1 then camera 2; both cameras are of the one kind
extern "C" int sim3_refine_launch(const float* xc1, const float* xc2, const float* uv1, const float* uv2,
                                  const float* is1, const float* is2, const bool* valid, const float* S0, int n,
                                  const float* cams18, int kind, int fix_scale, int iters, float chi2, float* S,
                                  bool* inliers, int* n_inl, void* stream) {
  if (n < 1 || iters < 0 || kind < cam::kPinhole || kind > cam::kKB8) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c1 = cams18;
  const float* c2 = cams18 + 9;
  const Cams cams = {c1[0], c1[1], c1[2], c1[3], c2[0], c2[1], c2[2], c2[3]};  // host copies
  const Dist dist = {cam::from(c1 + 4), cam::from(c2 + 4)};
  const Fisheye kb = {{c1[0], c1[1], c1[2], c1[3], c1[4], c1[5], c1[6], c1[7]},
                      {c2[0], c2[1], c2[2], c2[3], c2[4], c2[5], c2[6], c2[7]}};
  if (kind == cam::kKB8)
    refine_kernel<cam::kKB8><<<1, kThreads, 0, st>>>(xc1, xc2, uv1, uv2, is1, is2, valid, S0, n, cams, dist, kb,
                                                     fix_scale, iters, chi2, S, inliers, n_inl);
  else if (kind == cam::kRadtan)
    refine_kernel<cam::kRadtan><<<1, kThreads, 0, st>>>(xc1, xc2, uv1, uv2, is1, is2, valid, S0, n, cams, dist, kb,
                                                        fix_scale, iters, chi2, S, inliers, n_inl);
  else
    refine_kernel<cam::kPinhole><<<1, kThreads, 0, st>>>(xc1, xc2, uv1, uv2, is1, is2, valid, S0, n, cams, dist, kb,
                                                         fix_scale, iters, chi2, S, inliers, n_inl);
  return cudaGetLastError();
}
