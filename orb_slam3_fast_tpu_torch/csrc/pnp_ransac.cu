// Kernel P: PnP RANSAC for relocalisation, two launches.
//  1. One CTA per 6-point subset: the conditioning (centre, spread) of the
//     valid world points block-reduced; thread 0 takes the 12x12 DLT's null
//     vector as the least eigenvector of A^T A (float64 Jacobi); threads 0
//     and 32 each take one sign: Procrustes (3x3 SVD, the determinant fix on
//     the least singular direction), t = P[:, 3] / mean(s), the
//     un-conditioning t - R ctr, then 4 Gauss-Newton steps on the subset with
//     the closed-form Jacobian, a 6x6 Cholesky, the so3_exp update and the
//     SVD re-orthonormalisation; every thread scores both poses on its
//     points (pin-hole + radtan, chi2 < 5.991 with 1 / sigma^2, z > 0),
//     block-reduced.  A Kannala-Brandt camera scores through the kKB8
//     instance's projection (camera.cuh); a pin-hole one runs the code it
//     always ran.
//  2. One CTA: the first maximum of the counts, its inlier mask, and
//     ok = n >= min_inliers with a finite pose.
// See the source note in optim/pnp.py; pnp_ransac_plain there is the same
// function in PyTorch.
#include <cuda_runtime.h>
#include <math.h>

#include "camera.cuh"
#include "jacobi.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kChi2 = 5.991f;

struct Cam {
  float fx, fy, cx, cy, k1, k2, p1, p2, k3;
  cam::KB8 kb;  // the kKB8 instance's camera
};

// Inlier test of world point x at pose (R, t): cameras/models.project with
// its |z| < 1e-9 guard, radial-tangential distortion, or KB8's projection.
template <int kCam>
__device__ __forceinline__ bool is_inlier(const float* R, const float* t, const Cam& c, const float* x, float u,
                                          float v, float inv_s2) {
  const float xc = R[0] * x[0] + R[1] * x[1] + R[2] * x[2] + t[0];
  const float yc = R[3] * x[0] + R[4] * x[1] + R[5] * x[2] + t[1];
  const float zc = R[6] * x[0] + R[7] * x[1] + R[8] * x[2] + t[2];
  if constexpr (kCam == cam::kKB8) {
    float pu, pv;
    cam::kb8_project(c.kb, xc, yc, zc, pu, pv);
    const float du = pu - u, dv = pv - v;
    return (du * du + dv * dv) * inv_s2 < kChi2 && zc > 0.f;
  }
  const float z = fabsf(zc) < 1e-9f ? 1e-9f : zc;
  const float mx = xc / z, my = yc / z;
  const float r2 = mx * mx + my * my;
  const float radial = 1.f + r2 * (c.k1 + r2 * (c.k2 + r2 * c.k3));
  const float xd = mx * radial + 2.f * c.p1 * mx * my + c.p2 * (r2 + 2.f * mx * mx);
  const float yd = my * radial + c.p1 * (r2 + 2.f * my * my) + 2.f * c.p2 * mx * my;
  const float du = c.fx * xd + c.cx - u, dv = c.fy * yd + c.cy - v;
  return (du * du + dv * dv) * inv_s2 < kChi2 && zc > 0.f;
}

// R <- U diag(1, 1, det(U V^T)) V^T of R's SVD (lie.normalize_rotation).
__device__ void normalize_rotation(double (&R)[3][3]) {
  double U[3][3], s[3], V[3][3];
  jacobi::svd3(R, U, s, V);
  jacobi::udv(U, jacobi::det3(U) * jacobi::det3(V), V, R);
}

// 4 Gauss-Newton steps on the subset (pnp._refine_gn): residual (x/z, y/z) -
// xn with |z| < 1e-6 held at 1e-6, left increment [w, v] with Jacobian
// d(x/z, y/z)/d xc [-hat(xc) | I].
__device__ void refine_gn(double (&R)[3][3], double (&t)[3], const float (&xw)[6][3], const float (&xn)[6][2]) {
  for (int it = 0; it < 4; ++it) {
    double H[6][6] = {}, g[6] = {};
    for (int p = 0; p < 6; ++p) {
      double xc[3];
      for (int r = 0; r < 3; ++r) xc[r] = R[r][0] * xw[p][0] + R[r][1] * xw[p][1] + R[r][2] * xw[p][2] + t[r];
      const bool held = fabs(xc[2]) < 1e-6;
      const double z = held ? 1e-6 : xc[2];
      const double iz = 1.0 / z, dz = held ? 0.0 : iz * iz;
      const double res[2] = {xc[0] * iz - xn[p][0], xc[1] * iz - xn[p][1]};
      const double D[2][3] = {{iz, 0.0, -xc[0] * dz}, {0.0, iz, -xc[1] * dz}};
      const double nh[3][3] = {{0.0, xc[2], -xc[1]}, {-xc[2], 0.0, xc[0]}, {xc[1], -xc[0], 0.0}};  // -hat(xc)
      for (int a = 0; a < 2; ++a) {
        double J[6];
        for (int c = 0; c < 3; ++c) {
          J[c] = D[a][0] * nh[0][c] + D[a][1] * nh[1][c] + D[a][2] * nh[2][c];
          J[3 + c] = D[a][c];
        }
        for (int r = 0; r < 6; ++r) {
          g[r] += J[r] * res[a];
          for (int c = 0; c < 6; ++c) H[r][c] += J[r] * J[c];
        }
      }
    }
    double rhs[6], dx[6];
    for (int r = 0; r < 6; ++r) {
      H[r][r] += 1e-8;
      rhs[r] = -g[r];
    }
    jacobi::cholesky_solve6(H, rhs, dx);
    const double w[3] = {dx[0], dx[1], dx[2]};
    double dR[3][3], Rn[3][3], tn[3];
    jacobi::so3_exp(w, dR);
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) Rn[r][c] = dR[r][0] * R[0][c] + dR[r][1] * R[1][c] + dR[r][2] * R[2][c];
      tn[r] = dR[r][0] * t[0] + dR[r][1] * t[1] + dR[r][2] * t[2] + dx[3 + r];
    }
    normalize_rotation(Rn);
    for (int r = 0; r < 3; ++r) {
      t[r] = tn[r];
      for (int c = 0; c < 3; ++c) R[r][c] = Rn[r][c];
    }
  }
}

template <int kCam>
__global__ void __launch_bounds__(kThreads)
hypotheses_kernel(const float* __restrict__ xw, const float* __restrict__ uv, const float* __restrict__ xn,
                  const float* __restrict__ inv_s2, const bool* __restrict__ valid, const int* __restrict__ subsets,
                  int n, Cam cam, float* __restrict__ hyp_R, float* __restrict__ hyp_t,
                  float* __restrict__ counts) {
  __shared__ double red[33];
  __shared__ double sP[12];
  __shared__ float sR[2][9], st[2][3];
  const int h = blockIdx.x;
  // conditioning: the DLT runs on (x - ctr) / spread
  double c = 0.0, sx = 0.0, sy = 0.0, sz = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (valid[i]) {
      c += 1.0;
      sx += xw[3 * i];
      sy += xw[3 * i + 1];
      sz += xw[3 * i + 2];
    }
  const float cnt = (float)fmax(jacobi::block_sum(c, red), 1.0);
  const float ctr[3] = {(float)jacobi::block_sum(sx, red) / cnt, (float)jacobi::block_sum(sy, red) / cnt,
                        (float)jacobi::block_sum(sz, red) / cnt};
  double d2 = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (valid[i]) {
      const float a = xw[3 * i] - ctr[0], b = xw[3 * i + 1] - ctr[1], e = xw[3 * i + 2] - ctr[2];
      d2 += a * a + b * b + e * e;
    }
  const float spread = fmaxf(sqrtf((float)jacobi::block_sum(d2, red) / cnt), 1e-6f);
  float pw[6][3], pn[6][2];
  if (threadIdx.x == 0 || threadIdx.x == 32) {
    for (int k = 0; k < 6; ++k) {
      const int i = subsets[6 * h + k];
      for (int r = 0; r < 3; ++r) pw[k][r] = xw[3 * i + r];
      pn[k][0] = xn[2 * i];
      pn[k][1] = xn[2 * i + 1];
    }
  }
  if (threadIdx.x == 0) {  // the 12x12 DLT: rows [X 0 -x X ; 0 X -y X] on conditioned points
    double M[12][12] = {};
    for (int k = 0; k < 6; ++k) {
      const float X[4] = {(pw[k][0] - ctr[0]) / spread, (pw[k][1] - ctr[1]) / spread, (pw[k][2] - ctr[2]) / spread,
                          1.f};
      float r1[12], r2[12];
      for (int j = 0; j < 4; ++j) {
        r1[j] = X[j];
        r1[4 + j] = 0.f;
        r1[8 + j] = -pn[k][0] * X[j];
        r2[j] = 0.f;
        r2[4 + j] = X[j];
        r2[8 + j] = -pn[k][1] * X[j];
      }
      for (int a = 0; a < 12; ++a)
        for (int b = a; b < 12; ++b) M[a][b] += (double)r1[a] * r1[b] + (double)r2[a] * r2[b];
    }
    for (int a = 0; a < 12; ++a)
      for (int b = 0; b < a; ++b) M[a][b] = M[b][a];
    double p[12];
    jacobi::least_eigvec(M, p);
    for (int k = 0; k < 12; ++k) sP[k] = p[k];
  }
  __syncthreads();
  if (threadIdx.x == 0 || threadIdx.x == 32) {  // one sign each
    const int sgn = threadIdx.x == 0 ? 0 : 1;
    const double f = sgn == 0 ? 1.0 : -1.0;
    double M[3][3], U[3][3], s[3], V[3][3], R[3][3], t[3];
    for (int r = 0; r < 3; ++r)
      for (int c2 = 0; c2 < 3; ++c2) M[r][c2] = f * sP[4 * r + c2];
    jacobi::svd3(M, U, s, V);
    const double d = jacobi::det3(U) * jacobi::det3(V);
    jacobi::udv(U, d > 0.0 ? 1.0 : (d < 0.0 ? -1.0 : 0.0), V, R);
    const double scale = fmax((s[0] + s[1] + s[2]) / 3.0, 1e-12);
    for (int r = 0; r < 3; ++r) {
      const double tc = f * sP[4 * r + 3] / scale;
      // R((x - ctr) / s) + t == (R x + (s t - R ctr)) / s
      t[r] = spread * tc - (R[r][0] * ctr[0] + R[r][1] * ctr[1] + R[r][2] * ctr[2]);
    }
    refine_gn(R, t, pw, pn);
    for (int r = 0; r < 3; ++r) {
      for (int c2 = 0; c2 < 3; ++c2) sR[sgn][3 * r + c2] = (float)R[r][c2];
      st[sgn][r] = (float)t[r];
    }
  }
  __syncthreads();
  double n0 = 0.0, n1 = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (valid[i]) {
      n0 += is_inlier<kCam>(sR[0], st[0], cam, xw + 3 * i, uv[2 * i], uv[2 * i + 1], inv_s2[i]);
      n1 += is_inlier<kCam>(sR[1], st[1], cam, xw + 3 * i, uv[2 * i], uv[2 * i + 1], inv_s2[i]);
    }
  n0 = jacobi::block_sum(n0, red);
  n1 = jacobi::block_sum(n1, red);
  if (threadIdx.x < 9) {
    hyp_R[9 * (2 * h) + threadIdx.x] = sR[0][threadIdx.x];
    hyp_R[9 * (2 * h + 1) + threadIdx.x] = sR[1][threadIdx.x];
  }
  if (threadIdx.x < 3) {
    hyp_t[3 * (2 * h) + threadIdx.x] = st[0][threadIdx.x];
    hyp_t[3 * (2 * h + 1) + threadIdx.x] = st[1][threadIdx.x];
  }
  if (threadIdx.x == 0) {
    counts[2 * h] = (float)n0;
    counts[2 * h + 1] = (float)n1;
  }
}

template <int kCam>
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ xw, const float* __restrict__ uv, const float* __restrict__ inv_s2,
              const bool* __restrict__ valid, int n, int n_pose, Cam cam, int min_inliers,
              const float* __restrict__ hyp_R, const float* __restrict__ hyp_t, const float* __restrict__ counts,
              float* __restrict__ R_out, float* __restrict__ t_out, bool* __restrict__ inliers,
              int* __restrict__ n_inl, bool* __restrict__ ok) {
  __shared__ int s_best;
  __shared__ float sR[9], st[3];
  if (threadIdx.x == 0) {  // the first maximum, as argmax
    int best = 0;
    for (int k = 1; k < n_pose; ++k)
      if (counts[k] > counts[best]) best = k;
    s_best = best;
    bool finite = true;
    for (int k = 0; k < 9; ++k) {
      sR[k] = hyp_R[9 * best + k];
      R_out[k] = sR[k];
      finite = finite && isfinite(sR[k]);
    }
    for (int k = 0; k < 3; ++k) {
      st[k] = hyp_t[3 * best + k];
      t_out[k] = st[k];
      finite = finite && isfinite(st[k]);
    }
    const int count = (int)counts[best];
    *n_inl = count;
    *ok = count >= min_inliers && finite;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    inliers[i] = valid[i] && is_inlier<kCam>(sR, st, cam, xw + 3 * i, uv[2 * i], uv[2 * i + 1], inv_s2[i]);
}

template <int kCam>
void launch_cam(const float* xw, const float* uv, const float* xn, const float* inv_s2, const bool* valid,
                const int* subsets, int n, int n_hyp, const Cam& cam, int min_inliers, float* hyp_R, float* hyp_t,
                float* counts, float* R, float* t, bool* inliers, int* n_inl, bool* ok, cudaStream_t s) {
  hypotheses_kernel<kCam><<<n_hyp, kThreads, 0, s>>>(xw, uv, xn, inv_s2, valid, subsets, n, cam, hyp_R, hyp_t,
                                                     counts);
  select_kernel<kCam><<<1, kThreads, 0, s>>>(xw, uv, inv_s2, valid, n, 2 * n_hyp, cam, min_inliers, hyp_R, hyp_t,
                                             counts, R, t, inliers, n_inl, ok);
}

}  // namespace

// cam9: the camera's host (9,) parameters, pin-hole + radial-tangential [fx, fy, cx, cy, k1, k2, p1, p2, k3] or
// KB8 [fx, fy, cx, cy, k1, k2, k3, k4, 0]; kind: cam::Kind (a pin-hole camera runs the radial-tangential code).
extern "C" int pnp_ransac_launch(const float* xw, const float* uv, const float* xn, const float* inv_s2,
                                 const bool* valid, const int* subsets, int n, int n_hyp, const float* cam9, int kind,
                                 int min_inliers, float* hyp_R, float* hyp_t, float* counts, float* R, float* t,
                                 bool* inliers, int* n_inl, bool* ok, void* stream) {
  if (n < 1 || n_hyp < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cam::KB8 kb = {cam9[0], cam9[1], cam9[2], cam9[3], cam9[4], cam9[5], cam9[6], cam9[7]};
  const Cam cam = {cam9[0], cam9[1], cam9[2], cam9[3], cam9[4], cam9[5], cam9[6], cam9[7], cam9[8], kb};  // host copy
  if (kind == cam::kKB8)
    launch_cam<cam::kKB8>(xw, uv, xn, inv_s2, valid, subsets, n, n_hyp, cam, min_inliers, hyp_R, hyp_t, counts, R, t,
                          inliers, n_inl, ok, s);
  else
    launch_cam<cam::kRadtan>(xw, uv, xn, inv_s2, valid, subsets, n, n_hyp, cam, min_inliers, hyp_R, hyp_t, counts, R,
                             t, inliers, n_inl, ok, s);
  return cudaGetLastError();
}
