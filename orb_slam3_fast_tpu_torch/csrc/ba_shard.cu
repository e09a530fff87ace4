// Kernel AF: bundle adjustment over observation shards, one rank's stages
// (parallel/dist_ba.py).  The stages of kernels E, T and AC, cut where the
// JAX package's psums sit; between two entries the host runs one collective
// (torch.distributed) on the same stream and reads nothing back.
//
//   ba_shard_blocks_launch   E over the shard: per-observation W and the
//                            float64 sums (Hpp, Hll, bp, bl, w_lm, cost),
//                            not rounded                  -> all_reduce
//   ba_shard_round_launch    the reduced sums rounded to float32 (E's second
//                            launch)
//   ba_shard_cost_launch     AC (1)-(2): the candidate, the shard's robust
//                            cost in float64               -> all_reduce
//   ba_shard_commit_launch   AC (3): accept, damping, the old state back
//   ba_shard_cg_setup_launch T's landmark setup (V^-1, V^-1 bl; every
//                            landmark, replicated) and each pose's sums over
//                            the shard, W V^-1 W^T and W V^-1 bl, (K,42)
//                                                          -> all_reduce
//   ba_shard_cg_start_launch each pose's setup from the reduced sums (D^-1,
//                            x, r, z, p) and r.z, one CTA
//   per CG iteration:
//   ba_shard_cg_lm_launch    t_m = sum W^T p over the shard, (M,3)
//                                                          -> all_reduce
//   ba_shard_cg_pose_launch  sum W (V^-1 t) over the shard, (K,6)
//                                                          -> all_reduce
//   ba_shard_cg_update_launch S p = Hpp_d p - that, then T's CG update, one CTA
//   back-substitution:
//   ba_shard_cg_lm_launch    t_m = sum W^T x               -> all_reduce
//   ba_shard_cg_backsub_launch dl = V^-1 (bl - t), dp = x free
//
// Every per-landmark and per-pose sum walks the shard's own CSRs in their
// order, every reduction inside a CTA has a fixed order, and the collectives
// give every rank the same bits, so the ranks solve the same replicated
// system bit for bit.  A world of one runs E's, T's and AC's arithmetic in
// their order.  The dense run gathers the shards' W and calls kernel F
// unchanged.  See the source note in parallel/dist_ba.py.
#include "ba_blocks.cuh"
#include "ba_lm.cuh"
#include "ba_pcg.cuh"

using ba_e::ba_blocks_kernel;
using ba_e::round_kernel;
using ba_ac::candidate_kernel;
using ba_ac::commit_kernel;
using ba_ac::cost_kernel;
using ba_t::kLmThreads;
using ba_t::kPoseThreads;
using ba_t::kVecThreads;
using ba_t::lm_setup_kernel;
using ba_t::Scratch;

namespace {

// One CTA per pose: its sums over the shard's observations (pose CSR), in
// T's order, into part (K,42).
__global__ void __launch_bounds__(kPoseThreads)
setup_partial_kernel(const float* __restrict__ W, const int* __restrict__ obs_lm, const int* __restrict__ kf_ptr,
                     const int* __restrict__ kf_obs, Scratch s, double* __restrict__ part) {
  __shared__ double red[kPoseThreads / 32][42];
  __shared__ double tot[42];
  const int k = blockIdx.x;
  double acc[42];
  ba_t::pose_setup_sums(k, W, obs_lm, kf_ptr, kf_obs, s, acc);
  ba_t::block_reduce<42, kPoseThreads>(acc, red, tot);
  for (int i = threadIdx.x; i < 42; i += kPoseThreads) part[42 * k + i] = tot[i];
}

// One CTA: every pose's setup from the reduced sums, then r.z (T's dot).
__global__ void __launch_bounds__(kVecThreads)
setup_finish_kernel(const float* __restrict__ Hpp, const float* __restrict__ bp, const uint8_t* __restrict__ pose_fixed,
                    const float* __restrict__ lam, const double* __restrict__ part, int K, Scratch s) {
  __shared__ double sh[33];
  for (int k = threadIdx.x; k < K; k += kVecThreads)
    ba_t::pose_setup_finish(k, part + 42 * k, Hpp, bp, pose_fixed, lam, s);
  __syncthreads();
  double v = 0.0;
  for (int i = threadIdx.x; i < 6 * K; i += kVecThreads) v += s.r[i] * s.z[i];
  v = jacobi::block_sum(v, sh);
  if (threadIdx.x == 0) s.scal[0] = v;
}

// One thread per landmark: t_m = sum over the shard's observations of m of W_o^T v (v: p or x), fixed poses out.
__global__ void __launch_bounds__(kLmThreads)
lm_partial_kernel(const float* __restrict__ W, const int* __restrict__ obs_kf, const int* __restrict__ lm_ptr,
                  const int* __restrict__ lm_obs, const uint8_t* __restrict__ pose_fixed, const double* __restrict__ v,
                  int M, double* __restrict__ part) {
  const int m = blockIdx.x * kLmThreads + threadIdx.x;
  if (m >= M) return;
  double t[3];
  ba_t::lm_sums(m, W, obs_kf, lm_ptr, lm_obs, pose_fixed, v, t);
  for (int c = 0; c < 3; ++c) part[3 * m + c] = t[c];
}

// One CTA per pose: sum over the shard's observations of k of W_o V_m^-1 t_m (t reduced) into part (K,6).
__global__ void __launch_bounds__(kPoseThreads)
pose_partial_kernel(const float* __restrict__ W, const int* __restrict__ obs_lm, const int* __restrict__ kf_ptr,
                    const int* __restrict__ kf_obs, const double* __restrict__ t, Scratch s,
                    double* __restrict__ part) {
  __shared__ double red[kPoseThreads / 32][6];
  __shared__ double tot[6];
  const int k = blockIdx.x;
  double acc[6];
  ba_t::pose_sums<true>(k, W, obs_lm, kf_ptr, kf_obs, t, s.Vinv, acc);
  ba_t::block_reduce<6, kPoseThreads>(acc, red, tot);
  if (threadIdx.x < 6) part[6 * k + threadIdx.x] = tot[threadIdx.x];
}

// One CTA: S p = (Hpp_d p - the reduced sums) free, then T's CG update.
__global__ void __launch_bounds__(kVecThreads)
update_kernel(const uint8_t* __restrict__ pose_fixed, const double* __restrict__ part, int K, Scratch s) {
  __shared__ double sh[33];
  for (int i = threadIdx.x; i < 6 * K; i += kVecThreads)
    s.Ap[i] = ba_t::pose_Ap(i / 6, i % 6, part[i], pose_fixed, s);
  __syncthreads();
  ba_t::cg_update(pose_fixed, K, s, sh);
}

// dp = x free; one thread per landmark: dl = V^-1 (bl - t), t the reduced sum W^T dp.
__global__ void __launch_bounds__(kLmThreads)
backsub_finish_kernel(const float* __restrict__ bl, const float* __restrict__ w_lm,
                      const uint8_t* __restrict__ lm_valid, const uint8_t* __restrict__ pose_fixed,
                      const double* __restrict__ part, int K, int M, Scratch s, float* __restrict__ dp,
                      float* __restrict__ dl) {
  const int g = blockIdx.x * kLmThreads + threadIdx.x;
  for (int i = g; i < 6 * K; i += gridDim.x * kLmThreads) dp[i] = pose_fixed[i / 6] ? 0.f : (float)s.x[i];
  if (g >= M) return;
  const double t[3] = {part[3 * g], part[3 * g + 1], part[3 * g + 2]};
  ba_t::backsub_landmark(g, t, bl, w_lm, lm_valid, s, dl);
}

int lm_grid(int M) { return (M + kLmThreads - 1) / kLmThreads; }

}  // namespace

// E over the shard's n_obs observations; acc (42 K + 13 M + 1 float64) zeroed here and left unrounded.
extern "C" int ba_shard_blocks_launch(const float* cam10, int kind, const float* R, const float* t, const float* xw,
                                      const uint8_t* pose_fixed, const uint8_t* lm_valid, const int* obs_kf,
                                      const int* obs_lm, const float* obs_uv, const float* inv_s2,
                                      const uint8_t* is_stereo, const uint8_t* obs_valid, const uint8_t* inlier,
                                      int n_obs, int n_kf, int n_lm, float* W, double* acc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = 42 * n_kf + 13 * n_lm + 1;
  cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(double) * n, st);
  if (err != cudaSuccess) return err;
  if (n_obs > 0) {
    const int grid = (n_obs + ba_e::kThreads - 1) / ba_e::kThreads;
    if (kind == cam::kKB8)
      ba_blocks_kernel<cam::kKB8><<<grid, ba_e::kThreads, 0, st>>>(cam10, R, t, xw, pose_fixed, lm_valid, obs_kf,
                                                                   obs_lm, obs_uv, inv_s2, is_stereo, obs_valid,
                                                                   inlier, n_obs, n_kf, n_lm, W, acc);
    else if (kind == cam::kRadtan)
      ba_blocks_kernel<cam::kRadtan><<<grid, ba_e::kThreads, 0, st>>>(cam10, R, t, xw, pose_fixed, lm_valid, obs_kf,
                                                                      obs_lm, obs_uv, inv_s2, is_stereo, obs_valid,
                                                                      inlier, n_obs, n_kf, n_lm, W, acc);
    else
      ba_blocks_kernel<cam::kPinhole><<<grid, ba_e::kThreads, 0, st>>>(cam10, R, t, xw, pose_fixed, lm_valid, obs_kf,
                                                                       obs_lm, obs_uv, inv_s2, is_stereo, obs_valid,
                                                                       inlier, n_obs, n_kf, n_lm, W, acc);
  }
  return cudaGetLastError();
}

// out = (float)acc, n values.
extern "C" int ba_shard_round_launch(const double* acc, float* out, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024;
  round_kernel<<<grid, 256, 0, st>>>(acc, out, n);
  return cudaGetLastError();
}

// AC's candidate into R_out, t_out, xw_out and the shard's robust cost at it into acc (one float64, zeroed here).
extern "C" int ba_shard_cost_launch(const float* cam10, int kind, const float* R, const float* t, const float* xw,
                                    const float* dp, const float* dl, const uint8_t* lm_valid, const int* obs_kf,
                                    const int* obs_lm, const float* obs_uv, const float* inv_s2,
                                    const uint8_t* is_stereo, const uint8_t* obs_valid, const uint8_t* inlier,
                                    int n_obs, int n_kf, int n_lm, float* R_out, float* t_out, float* xw_out,
                                    double* acc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = ba_ac::grid_for(n_kf + n_lm > 0 ? n_kf + n_lm : 1);
  candidate_kernel<<<grid, ba_ac::kThreads, 0, st>>>(R, t, xw, dp, dl, n_kf, n_lm, R_out, t_out, xw_out, acc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_obs <= 0) return err;
  const int g = (n_obs + ba_ac::kThreads - 1) / ba_ac::kThreads;
  if (kind == cam::kKB8)
    cost_kernel<cam::kKB8><<<g, ba_ac::kThreads, 0, st>>>(cam10, R_out, t_out, xw_out, lm_valid, obs_kf, obs_lm,
                                                          obs_uv, inv_s2, is_stereo, obs_valid, inlier, n_obs, acc);
  else if (kind == cam::kRadtan)
    cost_kernel<cam::kRadtan><<<g, ba_ac::kThreads, 0, st>>>(cam10, R_out, t_out, xw_out, lm_valid, obs_kf, obs_lm,
                                                             obs_uv, inv_s2, is_stereo, obs_valid, inlier, n_obs, acc);
  else
    cost_kernel<cam::kPinhole><<<g, ba_ac::kThreads, 0, st>>>(cam10, R_out, t_out, xw_out, lm_valid, obs_kf, obs_lm,
                                                              obs_uv, inv_s2, is_stereo, obs_valid, inlier, n_obs, acc);
  return cudaGetLastError();
}

// AC's commit from the reduced cost acc: accept = (ok or none) && cost_new < cost_old, the damping, the old state
// copied over the candidate where the step is rejected.
extern "C" int ba_shard_commit_launch(const float* R, const float* t, const float* xw, int n_kf, int n_lm,
                                      const double* acc, const float* cost_old, const uint8_t* ok, const float* lam,
                                      float* R_out, float* t_out, float* xw_out, float* lam_out, uint8_t* accept_out,
                                      float* cost_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = ba_ac::grid_for(n_kf + n_lm > 0 ? n_kf + n_lm : 1);
  commit_kernel<<<grid, ba_ac::kThreads, 0, st>>>(R, t, xw, n_kf, n_lm, acc, cost_old, ok, lam, R_out, t_out, xw_out,
                                                  lam_out, accept_out, cost_out);
  return cudaGetLastError();
}

// T's landmark setup (all M landmarks, from the reduced Hll, bl, w_lm) and each pose's sums over the shard into
// part (K,42).  scratch: 12 M + 102 K + 8 doubles (T's layout).
extern "C" int ba_shard_cg_setup_launch(const float* Hll, const float* bl, const float* w_lm, const float* lam,
                                        const float* W, const int* obs_lm, const int* kf_ptr, const int* kf_obs, int K,
                                        int M, double* scratch, double* part, void* stream) {
  if (K < 1 || M < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = ba_t::scratch_at(scratch, K, M);
  lm_setup_kernel<<<lm_grid(M), kLmThreads, 0, st>>>(Hll, bl, w_lm, lam, M, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  setup_partial_kernel<<<K, kPoseThreads, 0, st>>>(W, obs_lm, kf_ptr, kf_obs, s, part);
  return cudaGetLastError();
}

// Each pose's setup from the reduced part (K,42), and r.z.
extern "C" int ba_shard_cg_start_launch(const float* Hpp, const float* bp, const uint8_t* pose_fixed, const float* lam,
                                        const double* part, int K, int M, double* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = ba_t::scratch_at(scratch, K, M);
  setup_finish_kernel<<<1, kVecThreads, 0, st>>>(Hpp, bp, pose_fixed, lam, part, K, s);
  return cudaGetLastError();
}

// part (M,3) = the shard's sum W^T v per landmark, v = p (which 0) or x (which 1).
extern "C" int ba_shard_cg_lm_launch(const float* W, const int* obs_kf, const int* lm_ptr, const int* lm_obs,
                                     const uint8_t* pose_fixed, int which, int K, int M, double* scratch, double* part,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = ba_t::scratch_at(scratch, K, M);
  lm_partial_kernel<<<lm_grid(M), kLmThreads, 0, st>>>(W, obs_kf, lm_ptr, lm_obs, pose_fixed, which ? s.x : s.p, M,
                                                       part);
  return cudaGetLastError();
}

// part_k (K,6) = the shard's sum W V^-1 t per pose, t = part_m (M,3) reduced.
extern "C" int ba_shard_cg_pose_launch(const float* W, const int* obs_lm, const int* kf_ptr, const int* kf_obs,
                                       const double* part_m, int K, int M, double* scratch, double* part_k,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = ba_t::scratch_at(scratch, K, M);
  pose_partial_kernel<<<K, kPoseThreads, 0, st>>>(W, obs_lm, kf_ptr, kf_obs, part_m, s, part_k);
  return cudaGetLastError();
}

// One CG iteration's update from part_k (K,6) reduced.
extern "C" int ba_shard_cg_update_launch(const uint8_t* pose_fixed, const double* part_k, int K, int M,
                                         double* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = ba_t::scratch_at(scratch, K, M);
  update_kernel<<<1, kVecThreads, 0, st>>>(pose_fixed, part_k, K, s);
  return cudaGetLastError();
}

// dp (K,6) and dl (M,3) from x and part_m = sum W^T x reduced.
extern "C" int ba_shard_cg_backsub_launch(const float* bl, const float* w_lm, const uint8_t* lm_valid,
                                          const uint8_t* pose_fixed, const double* part_m, int K, int M,
                                          double* scratch, float* dp, float* dl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = ba_t::scratch_at(scratch, K, M);
  backsub_finish_kernel<<<lm_grid(M), kLmThreads, 0, st>>>(bl, w_lm, lm_valid, pose_fixed, part_m, K, M, s, dp, dl);
  return cudaGetLastError();
}
