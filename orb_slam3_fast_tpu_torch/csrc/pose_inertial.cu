// Kernel W (pose_inertial.cuh): the pin-hole instances and the entry point,
// which hands a radial-tangential or KB8 camera to its own translation unit
// (pose_inertial_radtan.cu, pose_inertial_kb8.cu).
#include "pose_inertial.cuh"

extern "C" int pose_inertial_radtan_launch(
    const float* cam10, const float* tcb, const float* s_prev, const float* pk, const float* s0, const float* prior,
    int last, const float* xw, const float* uv, const float* inv_s2, const uint8_t* is_stereo, const uint8_t* valid,
    int n, int n_rounds, int iters, float* state_out, uint8_t* inlier, int* n_inl, float* H_out, cudaStream_t st);
extern "C" int pose_inertial_kb8_launch(
    const float* cam10, const float* tcb, const float* s_prev, const float* pk, const float* s0, const float* prior,
    int last, const float* xw, const float* uv, const float* inv_s2, const uint8_t* is_stereo, const uint8_t* valid,
    int n, int n_rounds, int iters, float* state_out, uint8_t* inlier, int* n_inl, float* H_out, cudaStream_t st);

namespace {

int pinhole_launch(
    const float* cam10, const float* tcb, const float* s_prev, const float* pk, const float* s0, const float* prior,
    int last, const float* xw, const float* uv, const float* inv_s2, const uint8_t* is_stereo, const uint8_t* valid,
    int n, int n_rounds, int iters, float* state_out, uint8_t* inlier, int* n_inl, float* H_out, cudaStream_t st) {
  const Edges e = {xw, uv, inv_s2, is_stereo, valid, n};
  if (last)
    pose_inertial_kernel<cam::kPinhole, true, true><<<1, kThreads, 0, st>>>(
        cam10, tcb, s_prev, pk, s0, prior, e, n_rounds, iters, state_out, inlier, n_inl, H_out);
  else if (prior)
    pose_inertial_kernel<cam::kPinhole, false, true><<<1, kThreads, 0, st>>>(
        cam10, tcb, s_prev, pk, s0, prior, e, n_rounds, iters, state_out, inlier, n_inl, H_out);
  else
    pose_inertial_kernel<cam::kPinhole, false, false><<<1, kThreads, 0, st>>>(
        cam10, tcb, s_prev, pk, s0, prior, e, n_rounds, iters, state_out, inlier, n_inl, H_out);
  return cudaGetLastError();
}

}  // namespace

// cam10: the camera's (10,) slots on the device (camera.cuh); kind: cam::Kind (0 pin-hole, 1 radtan, 2 KB8);
// tcb: R_cb (9) | t_cb; states R | p | v | bias (21);
// pk: the packed window; prior: state (21) | H (225), or null; last: the last-frame form (needs the prior).
extern "C" int pose_inertial_launch(const float* cam10, int kind, const float* tcb, const float* s_prev,
                                    const float* pk, const float* s0, const float* prior, int last,
                                    const float* xw, const float* uv, const float* inv_s2,
                                    const uint8_t* is_stereo, const uint8_t* valid, int n, int n_rounds, int iters,
                                    float* state_out, uint8_t* inlier, int* n_inl, float* H_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (last && prior == nullptr) return cudaErrorInvalidValue;
  if (kind == cam::kKB8)
    return pose_inertial_kb8_launch(cam10, tcb, s_prev, pk, s0, prior, last, xw, uv, inv_s2, is_stereo, valid, n,
                                    n_rounds, iters, state_out, inlier, n_inl, H_out, st);
  if (kind == cam::kRadtan)
    return pose_inertial_radtan_launch(cam10, tcb, s_prev, pk, s0, prior, last, xw, uv, inv_s2, is_stereo, valid, n,
                                       n_rounds, iters, state_out, inlier, n_inl, H_out, st);
  return pinhole_launch(cam10, tcb, s_prev, pk, s0, prior, last, xw, uv, inv_s2, is_stereo, valid, n, n_rounds, iters,
                        state_out, inlier, n_inl, H_out, st);
}
