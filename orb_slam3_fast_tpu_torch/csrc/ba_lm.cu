// Kernel AC: the rest of a Levenberg-Marquardt iteration of the local BA
// (optim/ba.py) and the global BA (optim/ba_cg.py) after kernel E's blocks
// and kernel F's (or T's) step, and the chi2 gate of both, so that an
// iteration is E -> F (or T) -> AC on the caller's stream with no host read.
//
// Entry 1, ba_lm_update_launch (ba.lm_update_plain), three launches:
//   (1) one thread per pose: the candidate exp(dp_k) T_k in float32 with
//       lie.se3_exp's branches (Taylor terms below theta^2 = 1e-8); one
//       thread per landmark: xw + dl; both into the outputs; the first thread
//       zeroes the cost's float64 sum;
//   (2) one thread per observation, kernel E's mapping: ba_obs.cuh's residual
//       (its pinned instance, which rounds as E's does) and Huber cost at the
//       candidate, active where the observation is
//       valid, an inlier, in front (z > 0.05) and its landmark valid; summed
//       per warp by shuffles and added to the float64 sum, as kernel E sums
//       its cost: at one state the two costs are the same bits once rounded,
//       so a zero step is rejected;
//   (3) accept = ok && cost_new < cost_old (ok: kernel F's byte, or none for
//       T); the damping halved (at least 1e-8) or multiplied by 5 (at most
//       1e6) in float32; where the step is rejected the old state is copied
//       over the candidate.
// Entry 2, ba_classify_launch (ba.classify_plain): inlier = chi2 <= delta2 &
// z > 0.05 & valid, one thread per observation.
// The camera's kind is a template parameter (camera.cuh), as in kernel E.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ba_obs.cuh"
#include "camera.cuh"

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

// cam10: the camera's (10,) slots on the device (camera.cuh); kind: cam::Kind (0 pin-hole, 1 radtan, 2 KB8);
// ok: kernel F's byte (1 where its solve succeeded) or null; cost_old and lam: () float32 on the device;
// acc: one float64 of scratch.  Writes the state after the iteration (R_out, t_out, xw_out), the damping, the
// accept byte and the candidate's cost.
extern "C" int ba_lm_update_launch(const float* cam10, int kind, const float* R, const float* t, const float* xw,
                                   const float* dp, const float* dl, const uint8_t* lm_valid, const int* obs_kf,
                                   const int* obs_lm, const float* obs_uv, const float* inv_s2,
                                   const uint8_t* is_stereo, const uint8_t* obs_valid, const uint8_t* inlier,
                                   const float* cost_old, const uint8_t* ok, const float* lam, int n_obs, int n_kf,
                                   int n_lm, float* R_out, float* t_out, float* xw_out, float* lam_out,
                                   uint8_t* accept_out, float* cost_out, double* acc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(n_kf + n_lm > 0 ? n_kf + n_lm : 1);
  candidate_kernel<<<grid, kThreads, 0, st>>>(R, t, xw, dp, dl, n_kf, n_lm, R_out, t_out, xw_out, acc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n_obs > 0) {
    const int g = (n_obs + kThreads - 1) / kThreads;
    if (kind == cam::kKB8)
      cost_kernel<cam::kKB8><<<g, kThreads, 0, st>>>(cam10, R_out, t_out, xw_out, lm_valid, obs_kf, obs_lm, obs_uv,
                                                     inv_s2, is_stereo, obs_valid, inlier, n_obs, acc);
    else if (kind == cam::kRadtan)
      cost_kernel<cam::kRadtan><<<g, kThreads, 0, st>>>(cam10, R_out, t_out, xw_out, lm_valid, obs_kf, obs_lm,
                                                        obs_uv, inv_s2, is_stereo, obs_valid, inlier, n_obs, acc);
    else
      cost_kernel<cam::kPinhole><<<g, kThreads, 0, st>>>(cam10, R_out, t_out, xw_out, lm_valid, obs_kf, obs_lm,
                                                         obs_uv, inv_s2, is_stereo, obs_valid, inlier, n_obs, acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  commit_kernel<<<grid, kThreads, 0, st>>>(R, t, xw, n_kf, n_lm, acc, cost_old, ok, lam, R_out, t_out, xw_out,
                                           lam_out, accept_out, cost_out);
  return cudaGetLastError();
}

// inlier_out: (n_obs,) bytes, the observations within their chi2 bound, in front of the camera and valid.
extern "C" int ba_classify_launch(const float* cam10, int kind, const float* R, const float* t, const float* xw,
                                  const int* obs_kf, const int* obs_lm, const float* obs_uv, const float* inv_s2,
                                  const uint8_t* is_stereo, const uint8_t* obs_valid, int n_obs, uint8_t* inlier_out,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_obs <= 0) return cudaSuccess;
  const int g = grid_for(n_obs);
  if (kind == cam::kKB8)
    classify_kernel<cam::kKB8><<<g, kThreads, 0, st>>>(cam10, R, t, xw, obs_kf, obs_lm, obs_uv, inv_s2, is_stereo,
                                                       obs_valid, n_obs, inlier_out);
  else if (kind == cam::kRadtan)
    classify_kernel<cam::kRadtan><<<g, kThreads, 0, st>>>(cam10, R, t, xw, obs_kf, obs_lm, obs_uv, inv_s2, is_stereo,
                                                          obs_valid, n_obs, inlier_out);
  else
    classify_kernel<cam::kPinhole><<<g, kThreads, 0, st>>>(cam10, R, t, xw, obs_kf, obs_lm, obs_uv, inv_s2,
                                                           is_stereo, obs_valid, n_obs, inlier_out);
  return cudaGetLastError();
}
