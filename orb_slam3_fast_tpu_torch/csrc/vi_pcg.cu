// Kernel AA: FullInertialBA's LM segment (n_iters steps of the implicit-
// Schur LM over every keyframe's 15-D body state, every landmark and the
// whole preintegration chain), one CTA for the whole segment, its working
// set in a float64 scratch buffer in global memory, no host read inside.
// Per step: the observations' residuals and Jacobians (body pose through
// T_cb, landmark), each thread writing its own (kernel Y's pass,
// vi_ba.cu); the chain's Jacobian columns in dual numbers (inertial.cuh),
// thread (edge, direction), and each edge's 30x30 block; per landmark over
// its observations in CSR order Hll, bl, w_lm and the damped inverse; per
// state over its observations and its edges Hpp, the gradient, the damping,
// the block-Jacobi inverse of its 15x15 diagonal block; the CG iterations
// on the operator (damping + Hpp + the chain's blocks - Z V^-1 Z^T), the
// dot products as fixed-order block sums; the landmarks' back-substitution,
// the candidate's robust cost and the accept on the device.  The second
// entry classifies the observations (chi2 gate), one thread each.  Every
// loop strides by blockDim, so the CTA's width is free.  The camera's kind
// is a template parameter (camera.cuh): pin-hole cameras run the code they
// always ran, radial-tangential and KB8 ones their projection and Jacobian
// rows, as kernel Y's instances.  See the source
// note in optim/vi_ba_cg.py; lm_segment_vi_plain there is the same
// function in PyTorch.
#include "vi_pcg.cuh"

namespace vi_aa {
namespace {

template <int kCam>
__global__ void __launch_bounds__(kThreads) vi_pcg_kernel(Prob P, double* scratch, float* lam_io, float* state_out,
                                                          float* xw_out) {
  __shared__ double red[32 * 2];
  __shared__ double sums[2];
  const Work w = carve(scratch, P);
  const int K = P.K;
  load(P, w, lam_io[0]);
  int cg_run = 0;
  for (int it = 0; it < P.n_iters; ++it) {
    const double lam = w.misc[0];
    // (1) observations and the chain at the current state; the current cost
    double c[2] = {obs_pass<kCam>(P, w, w.st, 25, false), 0.0};
    edge_pass(P, w, w.st);
    c[1] += chain_cost(P, w);
    inr::block_sums(c, 2, red, sums);
    if (threadIdx.x == 0) w.misc[1] = sums[0] + sums[1];
    // (2) per landmark: Hll, bl, w over its observations in order; the damped inverse; y = V^-1 bl
    for (int m = threadIdx.x; m < P.M; m += blockDim.x) {
      double H[3][3] = {}, bl[3] = {}, wl = 0.0;
      landmark_sums(P, w, m, H, bl, wl);
      landmark_finish(w, m, H, bl, wl, lam);
    }
    __syncthreads();
    obs_wv(P, w);
    // (3) per state: Hpp and bp over its observations, the chain's gradient and diagonal block over its edges,
    // the damping, the right side b_s = (b - Z V^-1 bl) on the free states, the block-Jacobi inverse, and CG's
    // start x = 0, r = b_s, z = p = D^-1 r
    double part = 0.0;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      double Hpp[6][6] = {}, g[15] = {}, D[15][15] = {}, corr[6] = {};
      state_obs_sums(P, w, k, Hpp, g);
      state_chain(P, w, k, Hpp, g, D, lam);
      state_coupling(P, w, k, corr, D);
      state_finish(P, w, k, g, corr, D, part);
    }
    double rz = (inr::block_sums(&part, 1, red, sums), sums[0]);
    // (4) PCG on the implicit operator; past the freeze (r.z <= 1e-12) x no longer moves
    for (int cg = 0; cg < P.cg_iters && rz > 1e-12; ++cg) {
      for (int m = threadIdx.x; m < P.M; m += blockDim.x) {
        double u[3] = {};
        landmark_u(P, w, m, w.p, u);
        landmark_apply(w, m, u);
      }
      __syncthreads();
      cg_iteration<false>(P, w, nullptr, rz, red, sums);
      ++cg_run;
    }
    take_step(P, w);
    // (5) landmarks: dl = V^-1 (bl - sum W^T dx6) where seen and valid; the candidate positions and states
    for (int m = threadIdx.x; m < P.M; m += blockDim.x) {
      const double* L = w.lm + (size_t)kLm * m;
      double rhs[3] = {L[9], L[10], L[11]};
      landmark_rhs(P, w, m, rhs);
      landmark_candidate(P, w, m, rhs);
    }
    state_candidates(P, w);
    __syncthreads();
    // (6) the candidate's cost, the accept, the damping
    double c1[2] = {obs_pass<kCam>(P, w, w.cand, 28, true), chain_cost_at_candidate(P, w)};
    inr::block_sums(c1, 2, red, sums);
    commit(P, w, sums[0] + sums[1] < w.misc[1]);
  }
  if (threadIdx.x == 0) w.misc[3] = cg_run;
  store(P, w, lam_io, state_out, xw_out);
}

}  // namespace
}  // namespace vi_aa

using vi_aa::classify_kernel;
using vi_aa::kThreads;
using vi_aa::Prob;
using vi_aa::vi_pcg_kernel;

// n_iters > 0: one LM segment from the state (R, p, v, bias, xw), inlier_in the observations' gate, lam_io[0]
// the damping in; out: the state, xw, lam_io = (damping, the last step's starting cost, the CG iterations run).  The scratch holds
// optim/vi_ba_cg.py vi_pcg_scratch_doubles(K, M, O, E) doubles.  n_iters = 0: classify_vi at (R, p, xw) into
// inlier_out (the CSR, edge and scratch pointers unread).
extern "C" int vi_pcg_launch(const float* cam10, int kind, const float* tcb, int K, int M, int O, int E,
                             const float* R, const float* p, const float* v, const float* b, const uint8_t* fixed,
                             const float* xw, const uint8_t* lm_valid, const int* obs_kf, const int* obs_lm,
                             const float* uv, const float* inv_s2, const uint8_t* is_stereo,
                             const uint8_t* obs_valid, const int* edge_i, const int* edge_j,
                             const uint8_t* edge_valid, const float* pk, const int* lm_ptr, const int* lm_obs,
                             const int* kf_ptr, const int* kf_obs, const int* ke_ptr, const int* ke_edge,
                             const uint8_t* inlier_in, int n_iters, int cg_iters, double* scratch, float* lam_io,
                             float* state_out, float* xw_out, uint8_t* inlier_out, void* stream) {
  if (K < 1 || M < 0 || O < 0 || E < 0 || n_iters < 0 || cg_iters < 0) return cudaErrorInvalidValue;
  const Prob P = {cam10, tcb, K, M, O, E, R, p, v, b, fixed, xw, lm_valid, obs_kf, obs_lm, uv, inv_s2, is_stereo,
                  obs_valid, edge_i, edge_j, edge_valid, pk, lm_ptr, lm_obs, kf_ptr, kf_obs, ke_ptr, ke_edge,
                  inlier_in, n_iters, cg_iters};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind < cam::kPinhole || kind > cam::kKB8) return cudaErrorInvalidValue;
  if (n_iters == 0) {
    if (O > 0) {
      if (kind == cam::kKB8)
        classify_kernel<cam::kKB8><<<(O + 255) / 256, 256, 0, st>>>(P, inlier_out);
      else if (kind == cam::kRadtan)
        classify_kernel<cam::kRadtan><<<(O + 255) / 256, 256, 0, st>>>(P, inlier_out);
      else
        classify_kernel<cam::kPinhole><<<(O + 255) / 256, 256, 0, st>>>(P, inlier_out);
    }
  } else if (kind == cam::kKB8) {
    vi_pcg_kernel<cam::kKB8><<<1, kThreads, 0, st>>>(P, scratch, lam_io, state_out, xw_out);
  } else if (kind == cam::kRadtan) {
    vi_pcg_kernel<cam::kRadtan><<<1, kThreads, 0, st>>>(P, scratch, lam_io, state_out, xw_out);
  } else {
    vi_pcg_kernel<cam::kPinhole><<<1, kThreads, 0, st>>>(P, scratch, lam_io, state_out, xw_out);
  }
  return cudaGetLastError();
}
