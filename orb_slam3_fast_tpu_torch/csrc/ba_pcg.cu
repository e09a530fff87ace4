// Kernel T: the implicit-Schur PCG of global BA (ba_cg.implicit_schur_solve):
// S = Hpp_d - W V^-1 W^T applied as an operator over the per-observation
// coupling W (O,6,3) of kernel E, block-Jacobi preconditioned, in float64.
// Launches, all from one C entry point: landmark setup, pose setup, r.z,
// then per CG iteration a landmark pass, a pose pass and a one-CTA update,
// then the back-substitution: 3 + 3 cg_iters + 1.  The segment sums walk
// the landmark CSR (lm_ptr, lm_obs) and the pose CSR (kf_ptr, kf_obs) in
// their order, the dot products are fixed-order block reductions, so a run
// repeats bit for bit.  See the source note in optim/ba_cg.py;
// implicit_schur_solve_plain there is the same function in PyTorch.
#include "ba_pcg.cuh"

using namespace ba_t;  // the kernels and their launch constants (ba_pcg.cuh)

extern "C" int ba_pcg_launch(const float* Hpp, const float* Hll, const float* bp, const float* bl, const float* W,
                             const float* w_lm, const uint8_t* pose_fixed, const uint8_t* lm_valid, const int* obs_kf,
                             const int* obs_lm, const int* lm_ptr, const int* lm_obs, const int* kf_ptr,
                             const int* kf_obs, const float* lam, int K, int M, int O, int cg_iters, double* scratch,
                             float* dp, float* dl, void* stream) {
  if (K < 1 || M < 1 || O < 0 || cg_iters < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = scratch_at(scratch, K, M);  // 12 M + 102 K + 8 doubles
  const int lm_grid = (M + kLmThreads - 1) / kLmThreads;
  lm_setup_kernel<<<lm_grid, kLmThreads, 0, st>>>(Hll, bl, w_lm, lam, M, s);
  pose_setup_kernel<<<K, kPoseThreads, 0, st>>>(Hpp, bp, W, obs_lm, kf_ptr, kf_obs, pose_fixed, lam, s);
  dot_rz_kernel<<<1, kVecThreads, 0, st>>>(6 * K, s);
  for (int it = 0; it < cg_iters; ++it) {
    lm_pass_kernel<<<lm_grid, kLmThreads, 0, st>>>(W, obs_kf, lm_ptr, lm_obs, pose_fixed, s.p, M, s);
    pose_pass_kernel<<<K, kPoseThreads, 0, st>>>(W, obs_lm, kf_ptr, kf_obs, pose_fixed, s);
    cg_update_kernel<<<1, kVecThreads, 0, st>>>(pose_fixed, K, s);
  }
  backsub_kernel<<<lm_grid, kLmThreads, 0, st>>>(W, bl, w_lm, lm_valid, obs_kf, lm_ptr, lm_obs, pose_fixed, K, M, s,
                                                 dp, dl);
  return cudaGetLastError();
}
