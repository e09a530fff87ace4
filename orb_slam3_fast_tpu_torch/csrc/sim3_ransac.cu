// Kernel Q: Sim3 RANSAC of loop verification, two launches.
//  1. One CTA per 3-pair hypothesis: thread 0 solves Horn's closed form in
//     float64 (centroids, M = yc^T xc, the 3x3 SVD of jacobi.cuh, the
//     determinant sign on the least singular direction, the symmetric
//     scale, 1 under fix_scale) and rounds the Sim3 to float32; every thread
//     maps its pairs both ways, projects them through the pin-hole cameras
//     and counts chi2 < 9.210 on both sides with z > 0 (a fixed-order block
//     sum of integers).
//  2. One CTA: the first maximum of the counts (argmax's choice), its Sim3,
//     its inlier mask, and ok = count >= min_inliers with a finite Sim3 and
//     1e-3 < s < 1e3.
// Cameras with radial-tangential distortion take the kDist instances
// (camera.cuh); cameras without, the code they always ran.  See the source
// note in optim/sim3.py; sim3_ransac_plain there is the same function in
// PyTorch.
#include <cuda_runtime.h>
#include <math.h>

#include "camera.cuh"
#include "jacobi.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kChi2 = 9.210f;

struct Cams {
  float fx1, fy1, cx1, cy1, fx2, fy2, cx2, cy2;
};

struct Dist {
  cam::Radtan d1, d2;
};

// Both reprojection tests of pair i under S = (R, t, s) (sim3._two_sided):
// x2 -> s R x2 + t into camera 1, x1 -> (R^T x1 - R^T t) / s into camera 2.
template <bool kDist>
__device__ __forceinline__ bool pair_inlier(const float* __restrict__ S, const Cams& c, const Dist& dc,
                                            const float* __restrict__ x1,
                                            const float* __restrict__ x2, const float* __restrict__ uv1,
                                            const float* __restrict__ uv2, float is1, float is2) {
  const float* R = S;
  const float s = S[12], si = 1.f / s;
  float y[3], q[3], ti[3];
  for (int r = 0; r < 3; ++r) {
    y[r] = s * (R[3 * r] * x2[0] + R[3 * r + 1] * x2[1] + R[3 * r + 2] * x2[2]) + S[9 + r];
    ti[r] = -si * (R[r] * S[9] + R[3 + r] * S[10] + R[6 + r] * S[11]);
  }
  for (int r = 0; r < 3; ++r) q[r] = si * (R[r] * x1[0] + R[3 + r] * x1[1] + R[6 + r] * x1[2]) + ti[r];
  const float z1 = fabsf(y[2]) < 1e-9f ? 1e-9f : y[2], z2 = fabsf(q[2]) < 1e-9f ? 1e-9f : q[2];
  float du1, dv1, du2, dv2;
  if constexpr (kDist) {
    float xd, yd;
    cam::distort(dc.d1, y[0] / z1, y[1] / z1, xd, yd);
    du1 = c.fx1 * xd + c.cx1 - uv1[0], dv1 = c.fy1 * yd + c.cy1 - uv1[1];
    cam::distort(dc.d2, q[0] / z2, q[1] / z2, xd, yd);
    du2 = c.fx2 * xd + c.cx2 - uv2[0], dv2 = c.fy2 * yd + c.cy2 - uv2[1];
  } else {
    du1 = c.fx1 * (y[0] / z1) + c.cx1 - uv1[0], dv1 = c.fy1 * (y[1] / z1) + c.cy1 - uv1[1];
    du2 = c.fx2 * (q[0] / z2) + c.cx2 - uv2[0], dv2 = c.fy2 * (q[1] / z2) + c.cy2 - uv2[1];
  }
  return (du1 * du1 + dv1 * dv1) * is1 < kChi2 && (du2 * du2 + dv2 * dv2) * is2 < kChi2 && y[2] > 0.f &&
         q[2] > 0.f;
}

// Horn: y = s R x + t from three pairs (sim3.horn_sim3), in float64.
__device__ void horn3(const float* __restrict__ xc1, const float* __restrict__ xc2, const int* sub, bool fix_scale,
                      float* S) {
  double x[3][3], y[3][3], mx[3] = {}, my[3] = {};
  for (int k = 0; k < 3; ++k)
    for (int r = 0; r < 3; ++r) {
      x[k][r] = xc2[3 * sub[k] + r];
      y[k][r] = xc1[3 * sub[k] + r];
      mx[r] += x[k][r] / 3.0;
      my[r] += y[k][r] / 3.0;
    }
  double M[3][3] = {}, sx = 0.0, sy = 0.0;
  for (int k = 0; k < 3; ++k) {
    double xc[3], yc[3];
    for (int r = 0; r < 3; ++r) {
      xc[r] = x[k][r] - mx[r];
      yc[r] = y[k][r] - my[r];
      sx += xc[r] * xc[r];
      sy += yc[r] * yc[r];
    }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) M[i][j] += yc[i] * xc[j];
  }
  double U[3][3], sv[3], V[3][3], R[3][3];
  jacobi::svd3(M, U, sv, V);
  const double d = jacobi::det3(U) * jacobi::det3(V);
  jacobi::udv(U, d > 0.0 ? 1.0 : (d < 0.0 ? -1.0 : 0.0), V, R);
  const double s = fix_scale ? 1.0 : sqrt(sy / fmax(sx, 1e-12));
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) S[3 * r + c] = (float)R[r][c];
    S[9 + r] = (float)(my[r] - s * (R[r][0] * mx[0] + R[r][1] * mx[1] + R[r][2] * mx[2]));
  }
  S[12] = (float)s;
}

template <bool kDist>
__global__ void __launch_bounds__(kThreads)
hypotheses_kernel(const float* __restrict__ xc1, const float* __restrict__ xc2, const float* __restrict__ uv1,
                  const float* __restrict__ uv2, const float* __restrict__ is1, const float* __restrict__ is2,
                  const bool* __restrict__ valid, const int* __restrict__ subsets, int n, Cams cams, Dist dist,
                  int fix_scale,
                  float* __restrict__ hyp, int* __restrict__ counts) {
  __shared__ float S[13];
  __shared__ int warp_sum[kThreads / 32];
  const int h = blockIdx.x;
  if (threadIdx.x == 0) horn3(xc1, xc2, subsets + 3 * h, fix_scale != 0, S);
  __syncthreads();
  int cnt = 0;
  for (int i = threadIdx.x; i < n; i += kThreads)
    cnt += valid[i] &&
           pair_inlier<kDist>(S, cams, dist, xc1 + 3 * i, xc2 + 3 * i, uv1 + 2 * i, uv2 + 2 * i, is1[i], is2[i]);
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xFFFFFFFFu, cnt, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x < 13) hyp[13 * h + threadIdx.x] = S[threadIdx.x];
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
    counts[h] = total;
  }
}

template <bool kDist>
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ xc1, const float* __restrict__ xc2, const float* __restrict__ uv1,
              const float* __restrict__ uv2, const float* __restrict__ is1, const float* __restrict__ is2,
              const bool* __restrict__ valid, int n, int n_hyp, Cams cams, Dist dist, int min_inliers,
              const float* __restrict__ hyp, const int* __restrict__ counts, float* __restrict__ S_out,
              bool* __restrict__ inliers, int* __restrict__ n_inl, bool* __restrict__ ok) {
  __shared__ float S[13];
  if (threadIdx.x == 0) {  // the first maximum, as argmax
    int best = 0;
    for (int k = 1; k < n_hyp; ++k)
      if (counts[k] > counts[best]) best = k;
    bool finite = true;
    for (int k = 0; k < 13; ++k) {
      S[k] = hyp[13 * best + k];
      S_out[k] = S[k];
      finite = finite && isfinite(S[k]);
    }
    *n_inl = counts[best];
    *ok = counts[best] >= min_inliers && finite && S[12] > 1e-3f && S[12] < 1e3f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads)
    inliers[i] = valid[i] &&
                 pair_inlier<kDist>(S, cams, dist, xc1 + 3 * i, xc2 + 3 * i, uv1 + 2 * i, uv2 + 2 * i, is1[i], is2[i]);
}

}  // namespace

// cams18 (host): fx fy cx cy k1 k2 p1 p2 k3 of camera 1, then of camera 2
extern "C" int sim3_ransac_launch(const float* xc1, const float* xc2, const float* uv1, const float* uv2,
                                  const float* is1, const float* is2, const bool* valid, const int* subsets, int n,
                                  int n_hyp, const float* cams18, int fix_scale, int min_inliers, float* hyp,
                                  int* counts, float* S, bool* inliers, int* n_inl, bool* ok, void* stream) {
  if (n < 1 || n_hyp < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c1 = cams18;
  const float* c2 = cams18 + 9;
  const Cams cams = {c1[0], c1[1], c1[2], c1[3], c2[0], c2[1], c2[2], c2[3]};  // host copies
  const Dist dist = {cam::from(c1 + 4), cam::from(c2 + 4)};
  if (cam::any(dist.d1) || cam::any(dist.d2)) {
    hypotheses_kernel<true><<<n_hyp, kThreads, 0, st>>>(xc1, xc2, uv1, uv2, is1, is2, valid, subsets, n, cams, dist,
                                                         fix_scale, hyp, counts);
    select_kernel<true><<<1, kThreads, 0, st>>>(xc1, xc2, uv1, uv2, is1, is2, valid, n, n_hyp, cams, dist,
                                                 min_inliers, hyp, counts, S, inliers, n_inl, ok);
  } else {
    hypotheses_kernel<false><<<n_hyp, kThreads, 0, st>>>(xc1, xc2, uv1, uv2, is1, is2, valid, subsets, n, cams,
                                                          dist, fix_scale, hyp, counts);
    select_kernel<false><<<1, kThreads, 0, st>>>(xc1, xc2, uv1, uv2, is1, is2, valid, n, n_hyp, cams, dist,
                                                  min_inliers, hyp, counts, S, inliers, n_inl, ok);
  }
  return cudaGetLastError();
}
