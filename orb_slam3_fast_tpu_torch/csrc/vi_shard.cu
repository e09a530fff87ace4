// Kernel AG: FullInertialBA over observation shards, one rank's stages
// (parallel/dist_ba.py make_distributed_vi_ba_cg).  Kernel AA's device code
// (vi_pcg.cuh) cut where the JAX package's psums sit; between two stages the
// host runs one collective (torch.distributed) on the same stream and reads
// nothing back.  The scratch is AA's layout over the shard's observations
// (kObs rows), every landmark, edge and state; a segment of LM steps is
// begin, the steps, end, as one launch of AA is.  Per LM step:
//
//   obs        over the shard: the observations' rows and the visual cost;
//              every rank: the chain's blocks and cost (replicated); over
//              the shard's CSRs the float64 partial sums Hpp (K,36), the
//              pose gradient (K,6), Hll (M,9), bl (M,3), w_lm (M) and the
//              cost                                   -> all_reduce #1
//   landmarks  every rank: each landmark's damped V^-1 and y0 = V^-1 bl,
//              each state's chain terms, Hpp and damping; over the shard
//              W V^-1 and per state sum W y0 and D's pose block minus
//              sum W V^-1 W^T, the leading rank starting from D      (K,42)
//                                                     -> all_reduce #2
//   start      every rank: each state's block-Jacobi inverse, b_s, x, r,
//              z, p, and r.z
//   per CG iteration (all cg_iters of them; past r.z <= 1e-12 the update
//   does nothing, as AA's loop ends there):
//   cg_lm      the shard's sum W^T p per landmark (M,3) -> all_reduce
//   cg_zy      every rank: y = V^-1 (that); the shard's sum W y per
//              state (K,6)                            -> all_reduce
//   cg_update  S p from the reduced sums, the chain's blocks and the
//              damping, then alpha, x, r, z, beta, p (one CTA)
//   backsub    dx; the shard's bl - sum W^T dx per landmark, the leading
//              rank starting from bl (M,3)            -> all_reduce
//   candidate  every rank: dl, the candidate landmarks and states; the
//              shard's visual cost at the candidate, the chain's
//                                                     -> all_reduce
//   commit     the accept and the damping
//
// and classify, AA's chi2 gate over the shard's observations.  Every stage
// runs AA's passes at AA's width (one CTA of kThreads, loops striding by
// it; cg_lm one thread per landmark), every sum within a shard walks the
// shard's CSRs in their order, and the collectives give every rank the
// same bits, so the ranks hold the same state bit for bit, and a world of
// one computes AA's arithmetic in AA's order.  See the source note in
// parallel/dist_ba.py.
#include "vi_pcg.cuh"

namespace vi_aa {
namespace {

constexpr int kBegin = 0, kObsStage = 1, kLandmarks = 2, kStart = 3, kCgLm = 4, kCgZy = 5, kCgUpdate = 6,
              kBacksub = 7, kCandidate = 8, kCommit = 9, kEnd = 10, kClassify = 11;
constexpr int kLmRowThreads = 128;

// the partial sums of all_reduce #1: Hpp (36 K) | pose gradient (6 K) | Hll (9 M) | bl (3 M) | w_lm (M) | cost
struct SumsA {
  double *Hpp, *g, *H, *bl, *wl, *cost;
};

__device__ inline SumsA sums_a(double* part, int K, int M) {
  SumsA s;
  s.Hpp = part;
  s.g = s.Hpp + 36 * (size_t)K;
  s.H = s.g + 6 * (size_t)K;
  s.bl = s.H + 9 * (size_t)M;
  s.wl = s.bl + 3 * (size_t)M;
  s.cost = s.wl + M;
  return s;
}

__global__ void __launch_bounds__(kThreads) begin_kernel(Prob P, double* scratch, const float* lam_io) {
  load(P, carve(scratch, P), lam_io[0]);
}

template <int kCam>
__global__ void __launch_bounds__(kThreads) obs_kernel(Prob P, double* scratch, double* part) {
  __shared__ double red[32 * 2];
  __shared__ double sums[2];
  const Work w = carve(scratch, P);
  const SumsA s = sums_a(part, P.K, P.M);
  double c[2] = {obs_pass<kCam>(P, w, w.st, 25, false), 0.0};
  edge_pass(P, w, w.st);
  c[1] += chain_cost(P, w);
  inr::block_sums(c, 2, red, sums);
  if (threadIdx.x == 0) s.cost[0] = sums[0], w.misc[4] = sums[1];
  for (int m = threadIdx.x; m < P.M; m += blockDim.x) {
    double H[3][3] = {}, bl[3] = {}, wl = 0.0;
    landmark_sums(P, w, m, H, bl, wl);
    for (int t = 0; t < 9; ++t) s.H[9 * m + t] = H[t / 3][t % 3];
    for (int a = 0; a < 3; ++a) s.bl[3 * m + a] = bl[a];
    s.wl[m] = wl;
  }
  for (int k = threadIdx.x; k < P.K; k += blockDim.x) {
    double Hpp[6][6] = {}, g[15] = {};
    state_obs_sums(P, w, k, Hpp, g);
    for (int t = 0; t < 36; ++t) s.Hpp[36 * k + t] = Hpp[t / 6][t % 6];
    for (int a = 0; a < 6; ++a) s.g[6 * k + a] = g[a];
  }
}

// Every landmark and state from the reduced sums (each state's 15x15 block and gradient left in its Dinv and b
// rows for the start), then over the shard each state's coupling into part (K,42): D's pose block (the
// leading rank's starting from the state's, the others' from zero) minus sum W V^-1 W^T | sum W y0.
__global__ void __launch_bounds__(kThreads) landmarks_kernel(Prob P, double* scratch, double* part, int lead) {
  const Work w = carve(scratch, P);
  const SumsA s = sums_a(part, P.K, P.M);
  const double lam = w.misc[0];
  if (threadIdx.x == 0) w.misc[1] = s.cost[0] + w.misc[4];
  for (int m = threadIdx.x; m < P.M; m += blockDim.x) {
    double H[3][3], bl[3];
    for (int t = 0; t < 9; ++t) H[t / 3][t % 3] = s.H[9 * m + t];
    for (int a = 0; a < 3; ++a) bl[a] = s.bl[3 * m + a];
    landmark_finish(w, m, H, bl, s.wl[m], lam);
  }
  for (int k = threadIdx.x; k < P.K; k += blockDim.x) {
    double Hpp[6][6], g[15] = {}, D[15][15] = {};
    for (int t = 0; t < 36; ++t) Hpp[t / 6][t % 6] = s.Hpp[36 * k + t];
    for (int a = 0; a < 6; ++a) g[a] = s.g[6 * k + a];
    state_chain(P, w, k, Hpp, g, D, lam);
    for (int t = 0; t < 225; ++t) w.Dinv[225 * k + t] = D[t / 15][t % 15];
    for (int a = 0; a < 15; ++a) w.b[15 * k + a] = g[a];
  }
  __syncthreads();
  obs_wv(P, w);
  for (int k = threadIdx.x; k < P.K; k += blockDim.x) {
    double D[15][15], corr[6] = {};
    for (int a = 0; a < 6; ++a)
      for (int bb = 0; bb < 6; ++bb) D[a][bb] = lead ? w.Dinv[225 * k + 15 * a + bb] : 0.0;
    state_coupling(P, w, k, corr, D);
    for (int t = 0; t < 36; ++t) part[42 * k + t] = D[t / 6][t % 6];
    for (int a = 0; a < 6; ++a) part[42 * k + 36 + a] = corr[a];
  }
}

// Each state's end from its 15x15 block with the reduced pose block and the reduced sum W y0; r.z.
__global__ void __launch_bounds__(kThreads) start_kernel(Prob P, double* scratch, const double* part) {
  __shared__ double red[32];
  __shared__ double sums[1];
  const Work w = carve(scratch, P);
  double rz = 0.0;
  for (int k = threadIdx.x; k < P.K; k += blockDim.x) {
    double g[15], D[15][15], corr[6];
    for (int t = 0; t < 225; ++t) D[t / 15][t % 15] = w.Dinv[225 * k + t];
    for (int t = 0; t < 36; ++t) D[t / 6][t % 6] = part[42 * k + t];
    for (int a = 0; a < 15; ++a) g[a] = w.b[15 * k + a];
    for (int a = 0; a < 6; ++a) corr[a] = part[42 * k + 36 + a];
    state_finish(P, w, k, g, corr, D, rz);
  }
  inr::block_sums(&rz, 1, red, sums);
  if (threadIdx.x == 0) w.misc[2] = sums[0];
}

// One thread per landmark: the shard's sum W^T p into part (M,3).
__global__ void __launch_bounds__(kLmRowThreads) cg_lm_kernel(Prob P, double* scratch, double* part) {
  const Work w = carve(scratch, P);
  for (int m = blockIdx.x * blockDim.x + threadIdx.x; m < P.M; m += gridDim.x * blockDim.x) {
    double u[3] = {};
    landmark_u(P, w, m, w.p, u);
    for (int c = 0; c < 3; ++c) part[3 * m + c] = u[c];
  }
}

// y = V^-1 u from the reduced part (M,3) into every landmark's row, then the shard's sum W y per state row into
// part (K,6).
__global__ void __launch_bounds__(kThreads) cg_zy_kernel(Prob P, double* scratch, double* part) {
  const Work w = carve(scratch, P);
  for (int m = threadIdx.x; m < P.M; m += blockDim.x) {
    const double u[3] = {part[3 * m], part[3 * m + 1], part[3 * m + 2]};
    landmark_apply(w, m, u);
  }
  __syncthreads();
  for (int row = threadIdx.x; row < 6 * P.K; row += blockDim.x) part[row] = state_zy(P, w, row / 6, row % 6);
}

// One CG iteration from the reduced sums W y (K,6), unless r.z has fallen to 1e-12 (then nothing moves).
__global__ void __launch_bounds__(kThreads) cg_update_kernel(Prob P, double* scratch, const double* part) {
  __shared__ double red[32];
  __shared__ double sums[1];
  const Work w = carve(scratch, P);
  double rz = w.misc[2];
  if (!(rz > 1e-12)) return;
  cg_iteration<true>(P, w, part, rz, red, sums);
  if (threadIdx.x == 0) w.misc[2] = rz, w.misc[3] += 1.0;
}

// The step dx, then the shard's back-substitution right side per landmark into part (M,3): the leading rank's
// from bl, the others' from zero, less the shard's sum W^T dx.
__global__ void __launch_bounds__(kThreads) backsub_kernel(Prob P, double* scratch, double* part, int lead) {
  const Work w = carve(scratch, P);
  take_step(P, w);
  for (int m = threadIdx.x; m < P.M; m += blockDim.x) {
    const double* L = w.lm + (size_t)kLm * m;
    double rhs[3] = {lead ? L[9] : 0.0, lead ? L[10] : 0.0, lead ? L[11] : 0.0};
    landmark_rhs(P, w, m, rhs);
    for (int c = 0; c < 3; ++c) part[3 * m + c] = rhs[c];
  }
}

// The candidate from the reduced right sides; the shard's visual cost at it into part[0], the chain's into misc.
template <int kCam>
__global__ void __launch_bounds__(kThreads) candidate_kernel(Prob P, double* scratch, double* part) {
  __shared__ double red[32 * 2];
  __shared__ double sums[2];
  const Work w = carve(scratch, P);
  for (int m = threadIdx.x; m < P.M; m += blockDim.x) {
    const double rhs[3] = {part[3 * m], part[3 * m + 1], part[3 * m + 2]};
    landmark_candidate(P, w, m, rhs);
  }
  state_candidates(P, w);
  __syncthreads();
  double c1[2] = {obs_pass<kCam>(P, w, w.cand, 28, true), chain_cost_at_candidate(P, w)};
  inr::block_sums(c1, 2, red, sums);
  if (threadIdx.x == 0) part[0] = sums[0], w.misc[4] = sums[1];
}

__global__ void __launch_bounds__(kThreads) commit_kernel(Prob P, double* scratch, const double* part) {
  const Work w = carve(scratch, P);
  commit(P, w, part[0] + w.misc[4] < w.misc[1]);
}

__global__ void __launch_bounds__(kThreads) end_kernel(Prob P, double* scratch, float* lam_io, float* state_out,
                                                      float* xw_out) {
  store(P, carve(scratch, P), lam_io, state_out, xw_out);
}

}  // namespace
}  // namespace vi_aa

using vi_aa::backsub_kernel;
using vi_aa::begin_kernel;
using vi_aa::candidate_kernel;
using vi_aa::cg_lm_kernel;
using vi_aa::cg_update_kernel;
using vi_aa::cg_zy_kernel;
using vi_aa::classify_kernel;
using vi_aa::commit_kernel;
using vi_aa::end_kernel;
using vi_aa::kBacksub;
using vi_aa::kBegin;
using vi_aa::kCandidate;
using vi_aa::kCgLm;
using vi_aa::kCgUpdate;
using vi_aa::kCgZy;
using vi_aa::kClassify;
using vi_aa::kCommit;
using vi_aa::kEnd;
using vi_aa::kLandmarks;
using vi_aa::kLmRowThreads;
using vi_aa::kObsStage;
using vi_aa::kStart;
using vi_aa::kThreads;
using vi_aa::landmarks_kernel;
using vi_aa::obs_kernel;
using vi_aa::Prob;
using vi_aa::start_kernel;

// One stage of kernel AG (the list above) on this rank's shard: K, M, E and the state, landmark and edge arrays
// whole; O, the observation arrays, their CSRs (lm_ptr / lm_obs, kf_ptr / kf_obs over the shard's valid rows) and
// inlier_in the shard's.  scratch: optim/vi_ba_cg.py vi_pcg_scratch_doubles(K, M, O, E) doubles; part: at least
// 42 K + 13 M + 1 doubles, each stage's sums from its start; lead: 1 on the rank whose sums carry the starting
// terms (rank 0).  begin reads lam_io[0] (the damping); end writes state_out (K,21), xw_out and lam_io (damping,
// the last step's starting cost, CG iterations run); classify writes inlier_out (O,) at (R, p, xw).
extern "C" int vi_shard_launch(int stage, const float* cam10, int kind, const float* tcb, int K, int M, int O, int E,
                               const float* R, const float* p, const float* v, const float* b, const uint8_t* fixed,
                               const float* xw, const uint8_t* lm_valid, const int* obs_kf, const int* obs_lm,
                               const float* uv, const float* inv_s2, const uint8_t* is_stereo,
                               const uint8_t* obs_valid, const int* edge_i, const int* edge_j,
                               const uint8_t* edge_valid, const float* pk, const int* lm_ptr, const int* lm_obs,
                               const int* kf_ptr, const int* kf_obs, const int* ke_ptr, const int* ke_edge,
                               const uint8_t* inlier_in, int lead, double* scratch, double* part, float* lam_io,
                               float* state_out, float* xw_out, uint8_t* inlier_out, void* stream) {
  if (K < 1 || M < 0 || O < 0 || E < 0 || kind < cam::kPinhole || kind > cam::kKB8) return cudaErrorInvalidValue;
  const Prob P = {cam10, tcb, K, M, O, E, R, p, v, b, fixed, xw, lm_valid, obs_kf, obs_lm, uv, inv_s2, is_stereo,
                  obs_valid, edge_i, edge_j, edge_valid, pk, lm_ptr, lm_obs, kf_ptr, kf_obs, ke_ptr, ke_edge,
                  inlier_in, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case kBegin:
      begin_kernel<<<1, kThreads, 0, st>>>(P, scratch, lam_io);
      break;
    case kObsStage:
      if (kind == cam::kKB8)
        obs_kernel<cam::kKB8><<<1, kThreads, 0, st>>>(P, scratch, part);
      else if (kind == cam::kRadtan)
        obs_kernel<cam::kRadtan><<<1, kThreads, 0, st>>>(P, scratch, part);
      else
        obs_kernel<cam::kPinhole><<<1, kThreads, 0, st>>>(P, scratch, part);
      break;
    case kLandmarks:
      landmarks_kernel<<<1, kThreads, 0, st>>>(P, scratch, part, lead);
      break;
    case kStart:
      start_kernel<<<1, kThreads, 0, st>>>(P, scratch, part);
      break;
    case kCgLm:
      if (M > 0) cg_lm_kernel<<<(M + kLmRowThreads - 1) / kLmRowThreads, kLmRowThreads, 0, st>>>(P, scratch, part);
      break;
    case kCgZy:
      cg_zy_kernel<<<1, kThreads, 0, st>>>(P, scratch, part);
      break;
    case kCgUpdate:
      cg_update_kernel<<<1, kThreads, 0, st>>>(P, scratch, part);
      break;
    case kBacksub:
      backsub_kernel<<<1, kThreads, 0, st>>>(P, scratch, part, lead);
      break;
    case kCandidate:
      if (kind == cam::kKB8)
        candidate_kernel<cam::kKB8><<<1, kThreads, 0, st>>>(P, scratch, part);
      else if (kind == cam::kRadtan)
        candidate_kernel<cam::kRadtan><<<1, kThreads, 0, st>>>(P, scratch, part);
      else
        candidate_kernel<cam::kPinhole><<<1, kThreads, 0, st>>>(P, scratch, part);
      break;
    case kCommit:
      commit_kernel<<<1, kThreads, 0, st>>>(P, scratch, part);
      break;
    case kEnd:
      end_kernel<<<1, kThreads, 0, st>>>(P, scratch, lam_io, state_out, xw_out);
      break;
    case kClassify:
      if (O > 0) {
        if (kind == cam::kKB8)
          classify_kernel<cam::kKB8><<<(O + 255) / 256, 256, 0, st>>>(P, inlier_out);
        else if (kind == cam::kRadtan)
          classify_kernel<cam::kRadtan><<<(O + 255) / 256, 256, 0, st>>>(P, inlier_out);
        else
          classify_kernel<cam::kPinhole><<<(O + 255) / 256, 256, 0, st>>>(P, inlier_out);
      }
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
