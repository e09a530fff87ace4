// Kernel D: 4 x 10 Levenberg-Marquardt pose optimisation with Huber IRLS and
// the final chi2 classification, all in one CTA.  Every round optimises with
// the round-0 mask, as the reference does.  The camera's kind is a template
// parameter (camera.cuh): a radial-tangential camera takes the kRadtan
// instance, a Kannala-Brandt one the kKB8 instance, and one without
// distortion the code it always ran.  See the source note in optim/pose_opt.py;
// pose_optimization_plain there is the same algorithm.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "camera.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;  // 21 (upper H) + 6 (g) + 1 (cost)
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Cam {
  float fx, fy, cx, cy, bf;
};

struct Edge {
  float r[3];   // residual [du, dv, dur] (dur = 0 on mono edges)
  float xc[3];  // point in the camera frame
  float chi2, w_huber;
  bool active, stereo;
};

// T = [R (row-major 9), t (3)]
template <int kCam>
__device__ __forceinline__ Edge eval_edge(const float* __restrict__ T, const Cam& c, const cam::Radtan& dist,
                                          const cam::KB8& kb,
                                          const float* __restrict__ xw,
                                          const float* __restrict__ uv, float inv_s2,
                                          bool stereo, bool valid) {
  Edge e;
  const float X = xw[0], Y = xw[1], Z = xw[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) e.xc[i] = T[3 * i] * X + T[3 * i + 1] * Y + T[3 * i + 2] * Z + T[9 + i];
  const float z = fabsf(e.xc[2]) < 1e-9f ? 1e-9f : e.xc[2];
  float u, v;
  if constexpr (kCam == cam::kKB8) {
    cam::kb8_project(kb, e.xc[0], e.xc[1], e.xc[2], u, v);
  } else if constexpr (kCam == cam::kRadtan) {
    float xd, yd;
    cam::distort(dist, e.xc[0] / z, e.xc[1] / z, xd, yd);
    u = c.fx * xd + c.cx;
    v = c.fy * yd + c.cy;
  } else {
    u = c.fx * (e.xc[0] / z) + c.cx;
    v = c.fy * (e.xc[1] / z) + c.cy;
  }
  e.r[0] = uv[0] - u;
  e.r[1] = uv[1] - v;
  e.r[2] = stereo ? uv[2] - (u - c.bf / z) : 0.f;
  e.stereo = stereo;
  e.chi2 = (e.r[0] * e.r[0] + e.r[1] * e.r[1] + e.r[2] * e.r[2]) * inv_s2;
  const float delta2 = stereo ? kChi2Stereo : kChi2Mono;
  e.w_huber = e.chi2 <= delta2 ? 1.f : sqrtf(delta2 / fmaxf(e.chi2, 1e-12f));
  e.active = valid && e.xc[2] > 0.05f;
  return e;
}

// Sum kSums (or 1) per-thread values over the block; the totals land in out.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (*red)[kSums], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v[k] += __shfl_down_sync(kFull, v[k], s);
    if (lane == 0) red[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// x = A^-1 b for a 6x6 SPD A by Cholesky; false if A is not positive definite.
__device__ bool cholesky_solve6(double (&A)[6][6], const double (&b)[6], double (&x)[6]) {
  double L[6][6] = {};
  for (int j = 0; j < 6; ++j) {
    double s = A[j][j];
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    if (!(s > 0.0)) return false;
    L[j][j] = sqrt(s);
    for (int i = j + 1; i < 6; ++i) {
      double t = A[i][j];
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t / L[j][j];
    }
  }
  double y[6];
  for (int i = 0; i < 6; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    double s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
  return true;
}

// T_out = se3_exp(dx) * T, dx = [rho, phi]
__device__ void exp_compose(const double (&dx)[6], const float* T, float* T_out) {
  const float rho[3] = {(float)dx[0], (float)dx[1], (float)dx[2]};
  const float p[3] = {(float)dx[3], (float)dx[4], (float)dx[5]};
  const float th2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2];
  const bool small = th2 < 1e-8f;
  const float th = sqrtf(fmaxf(th2, 1e-16f));
  const float a = small ? 1.f - th2 / 6.f : sinf(th) / th;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / fmaxf(th2, 1e-16f);
  const float c = small ? 1.f / 6.f - th2 / 120.f : (th - sinf(th)) / fmaxf(th2 * th, 1e-24f);
  const float W[3][3] = {{0.f, -p[2], p[1]}, {p[2], 0.f, -p[0]}, {-p[1], p[0], 0.f}};
  float W2[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
  float Re[3][3], V[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float id = i == j ? 1.f : 0.f;
      Re[i][j] = id + a * W[i][j] + b * W2[i][j];
      V[i][j] = id + b * W[i][j] + c * W2[i][j];  // left Jacobian Jl(phi)
    }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      T_out[3 * i + j] = Re[i][0] * T[j] + Re[i][1] * T[3 + j] + Re[i][2] * T[6 + j];
    T_out[9 + i] = Re[i][0] * T[9] + Re[i][1] * T[10] + Re[i][2] * T[11] +
                   (V[i][0] * rho[0] + V[i][1] * rho[1] + V[i][2] * rho[2]);
  }
}

template <int kCam>
__global__ void __launch_bounds__(kThreads)
pose_lm_kernel(const float* __restrict__ xw, const float* __restrict__ uv,
               const float* __restrict__ inv_s2, const uint8_t* __restrict__ is_stereo,
               const uint8_t* __restrict__ valid, int n, const float* __restrict__ cam10,
               const float* __restrict__ R0, const float* __restrict__ t0, int n_rounds,
               int iters, float* __restrict__ R_out, float* __restrict__ t_out,
               uint8_t* __restrict__ inlier, int* __restrict__ n_inl_out) {
  __shared__ float sT[12], sTn[12];
  __shared__ float red[kWarps][kSums];
  __shared__ float tot[kSums];
  const int tid = threadIdx.x;
  const Cam c = {cam10[0], cam10[1], cam10[2], cam10[3], cam10[4]};
  cam::Radtan dist = {};
  if constexpr (kCam == cam::kRadtan) dist = {cam10[5], cam10[6], cam10[7], cam10[8], cam10[9]};
  cam::KB8 kb = {};
  if constexpr (kCam == cam::kKB8) kb = cam::kb8_from10(cam10);
  if (tid < 9) sT[tid] = R0[tid];
  if (tid < 3) sT[9 + tid] = t0[tid];
  __syncthreads();

  double lam = 0.0;  // thread 0's damping
  for (int round = 0; round < n_rounds; ++round) {
    lam = 1e-2;
    for (int it = 0; it < iters; ++it) {
      // pass 1: normal equations at T
      float acc[kSums];
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
      for (int e = tid; e < n; e += kThreads) {
        const Edge ed = eval_edge<kCam>(sT, c, dist, kb, xw + 3 * e, uv + 3 * e, inv_s2[e], is_stereo[e], valid[e]);
        if (!ed.active) continue;
        const float w = ed.w_huber * inv_s2[e];
        const float X = ed.xc[0], Y = ed.xc[1], Z = ed.xc[2];
        const float z = fabsf(Z) < 1e-9f ? 1e-9f : Z;
        const float iz = 1.f / z;
        const float xn = X * iz, yn = Y * iz;
        // rows of d(u, v, u_r)/d(xc); the residual Jacobian is -(row * [I | -hat(xc)])
        float A[3][3] = {{c.fx * iz, 0.f, -c.fx * xn * iz},
                         {0.f, c.fy * iz, -c.fy * yn * iz},
                         {c.fx * iz, 0.f, -c.fx * xn * iz + c.bf * iz * iz}};
        if constexpr (kCam != cam::kPinhole) {  // rows of models.stereo_project_jac with the camera's Jacobian
          float J[2][3];
          if constexpr (kCam == cam::kKB8)
            cam::kb8_jac(kb, X, Y, Z, J);
          else
            cam::pixel_jac(c.fx, c.fy, dist, xn, yn, iz, J);
          for (int k = 0; k < 3; ++k) {
            A[0][k] = A[2][k] = J[0][k];
            A[1][k] = J[1][k];
          }
          A[2][2] = J[0][2] + c.bf * iz * iz;
        }
        const int rows = ed.stereo ? 3 : 2;
        for (int q = 0; q < rows; ++q) {
          const float a0 = A[q][0], a1 = A[q][1], a2 = A[q][2];
          const float j6[6] = {a0, a1, a2, a2 * Y - a1 * Z, a0 * Z - a2 * X, a1 * X - a0 * Y};
          int k = 0;
#pragma unroll
          for (int i = 0; i < 6; ++i)
#pragma unroll
            for (int j = i; j < 6; ++j) acc[k++] += w * j6[i] * j6[j];
#pragma unroll
          for (int i = 0; i < 6; ++i) acc[21 + i] += w * j6[i] * ed.r[q];
        }
        acc[27] += ed.w_huber * ed.chi2;
      }
      block_sum<kSums>(acc, red, tot);

      if (tid == 0) {
        double H[6][6], g[6], dx[6];
        int k = 0;
        for (int i = 0; i < 6; ++i)
          for (int j = i; j < 6; ++j) H[i][j] = H[j][i] = tot[k++];
        for (int i = 0; i < 6; ++i) {
          g[i] = tot[21 + i];
          H[i][i] += lam * H[i][i] + 1e-8;
        }
        if (!cholesky_solve6(H, g, dx))
          for (int i = 0; i < 6; ++i) dx[i] = 0.0;  // no step: the cost cannot drop
        exp_compose(dx, sT, sTn);
      }
      __syncthreads();

      // pass 2: cost at the candidate pose
      float cn[1] = {0.f};
      for (int e = tid; e < n; e += kThreads) {
        const Edge ed = eval_edge<kCam>(sTn, c, dist, kb, xw + 3 * e, uv + 3 * e, inv_s2[e], is_stereo[e], valid[e]);
        if (ed.active) cn[0] += ed.w_huber * ed.chi2;
      }
      const float cost = tot[27];
      block_sum<1>(cn, red, tot);
      if (tid == 0) {
        if (tot[0] < cost) {
          for (int i = 0; i < 12; ++i) sT[i] = sTn[i];
          lam = fmax(lam * 0.5, 1e-7);
        } else {
          lam = fmin(lam * 4.0, 1e4);
        }
      }
      __syncthreads();
    }
  }

  // chi2 classification at the final pose
  float cnt[1] = {0.f};
  for (int e = tid; e < n; e += kThreads) {
    const Edge ed = eval_edge<kCam>(sT, c, dist, kb, xw + 3 * e, uv + 3 * e, inv_s2[e], is_stereo[e], valid[e]);
    const float delta2 = ed.stereo ? kChi2Stereo : kChi2Mono;
    const bool in = ed.active && ed.chi2 <= delta2;
    inlier[e] = in;
    cnt[0] += in ? 1.f : 0.f;
  }
  block_sum<1>(cnt, red, tot);
  if (tid < 9) R_out[tid] = sT[tid];
  if (tid < 3) t_out[tid] = sT[9 + tid];
  if (tid == 0) *n_inl_out = (int)tot[0];
}

}  // namespace

// cam10: the camera's (10,) slots on the device (camera.cuh); kind: cam::Kind (0 pin-hole, 1 radtan, 2 KB8)
extern "C" int pose_lm_launch(const float* xw, const float* uv, const float* inv_s2,
                              const uint8_t* is_stereo, const uint8_t* valid, int n,
                              const float* cam10, int kind, const float* R0, const float* t0, int n_rounds,
                              int iters, float* R_out, float* t_out, uint8_t* inlier,
                              int* n_inl_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == cam::kKB8)
    pose_lm_kernel<cam::kKB8><<<1, kThreads, 0, st>>>(xw, uv, inv_s2, is_stereo, valid, n, cam10, R0, t0, n_rounds,
                                                      iters, R_out, t_out, inlier, n_inl_out);
  else if (kind == cam::kRadtan)
    pose_lm_kernel<cam::kRadtan><<<1, kThreads, 0, st>>>(xw, uv, inv_s2, is_stereo, valid, n, cam10, R0, t0,
                                                         n_rounds, iters, R_out, t_out, inlier, n_inl_out);
  else
    pose_lm_kernel<cam::kPinhole><<<1, kThreads, 0, st>>>(xw, uv, inv_s2, is_stereo, valid, n, cam10, R0, t0,
                                                          n_rounds, iters, R_out, t_out, inlier, n_inl_out);
  return cudaGetLastError();
}
