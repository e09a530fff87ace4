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
#include "ba_lm.cuh"

using namespace ba_ac;  // the kernels and their launch constants (ba_lm.cuh)

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
