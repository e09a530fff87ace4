// Kernel W's KB8 instances (pose_inertial.cuh), in a translation unit of
// their own so that the build compiles each camera kind's in parallel;
// pose_inertial_launch (pose_inertial.cu) calls this entry for such a camera.
#include "pose_inertial.cuh"

extern "C" int pose_inertial_kb8_launch(
    const float* cam10, const float* tcb, const float* s_prev, const float* pk, const float* s0, const float* prior,
    int last, const float* xw, const float* uv, const float* inv_s2, const uint8_t* is_stereo, const uint8_t* valid,
    int n, int n_rounds, int iters, float* state_out, uint8_t* inlier, int* n_inl, float* H_out, cudaStream_t st) {
  const Edges e = {xw, uv, inv_s2, is_stereo, valid, n};
  if (last)
    pose_inertial_kernel<cam::kKB8, true, true><<<1, kThreads, 0, st>>>(
        cam10, tcb, s_prev, pk, s0, prior, e, n_rounds, iters, state_out, inlier, n_inl, H_out);
  else if (prior)
    pose_inertial_kernel<cam::kKB8, false, true><<<1, kThreads, 0, st>>>(
        cam10, tcb, s_prev, pk, s0, prior, e, n_rounds, iters, state_out, inlier, n_inl, H_out);
  else
    pose_inertial_kernel<cam::kKB8, false, false><<<1, kThreads, 0, st>>>(
        cam10, tcb, s_prev, pk, s0, prior, e, n_rounds, iters, state_out, inlier, n_inl, H_out);
  return cudaGetLastError();
}
