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
// always ran.  The residual and the robust cost are ba_obs.cuh's, which
// kernel AC (ba_lm.cu) shares.  See the source note in optim/ba.py;
// build_normal_blocks_plain there is the JAX form with the dense Z.
#include "ba_blocks.cuh"

using namespace ba_e;  // the kernels and their launch constants (ba_blocks.cuh)

// cam10: the camera's (10,) slots on the device (camera.cuh); kind: cam::Kind (0 pin-hole, 1 radtan, 2 KB8)
extern "C" int ba_blocks_launch(const float* cam10, int kind, const float* R, const float* t, const float* xw,
                                const uint8_t* pose_fixed, const uint8_t* lm_valid,
                                const int* obs_kf, const int* obs_lm, const float* obs_uv,
                                const float* inv_s2, const uint8_t* is_stereo,
                                const uint8_t* obs_valid, const uint8_t* inlier, int n_obs,
                                int n_kf, int n_lm, float* W, double* acc, float* out,
                                void* stream) {
  // acc: the float64 sums, zeroed here; out: the same layout in float32
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = 42 * n_kf + 13 * n_lm + 1;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(double) * n, st);
  if (err != cudaSuccess) return err;
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
  const int grid = (n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024;
  round_kernel<<<grid, 256, 0, st>>>(acc, out, n);
  return cudaGetLastError();
}
