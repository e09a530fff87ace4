// Kernel W: the visual-inertial frame optimisation, one CTA for the whole
// call (4 rounds of 10 LM iterations, the chi2 reclassification between
// rounds, the information of the solved state).  Threads stride over the
// visual edges and sum the pose block in float64 in a fixed order; threads
// k < 15 (30) evaluate the inertial, bias-walk and prior factors along
// tangent k in dual numbers (inertial.cuh); the normal equations are formed
// entry by entry and solved by the block's Gaussian elimination.  The
// prior-less call (kPrior false), the prior on the current state, and the
// last-frame form (kLast: the previous state free under its prior, then
// marginalised) are template instances, and so is the camera's kind
// (camera.cuh: pin-hole, radial-tangential or KB8).  See the source note in optim/inertial.py.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "camera.cuh"
#include "inertial.cuh"

namespace {

using sim3::Dual;

constexpr int kThreads = 256;
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;

struct Edges {
  const float *xw, *uv, *inv_s2;
  const uint8_t *is_stereo, *valid;
  int n;
};

// Residual, camera point and d(u, v, u_r)/d(xc) rows of edge i at the pose (Rcw, tcw), float32 as kernel D.
template <int kCam>
__device__ __forceinline__ void project(const float* cam, const float (&Rcw)[3][3], const float (&tcw)[3],
                                        const Edges& e, int i, float (&r)[3], float (&xc)[3], float (&A)[3][3]) {
  const float fx = cam[0], fy = cam[1], cx = cam[2], cy = cam[3], bf = cam[4];
  const float X = e.xw[3 * i], Y = e.xw[3 * i + 1], Z = e.xw[3 * i + 2];
  for (int k = 0; k < 3; ++k) xc[k] = Rcw[k][0] * X + Rcw[k][1] * Y + Rcw[k][2] * Z + tcw[k];
  const float z = fabsf(xc[2]) < 1e-9f ? 1e-9f : xc[2];
  const float iz = 1.f / z, xn = xc[0] * iz, yn = xc[1] * iz;
  float u, v;
  if constexpr (kCam == cam::kKB8) {
    cam::kb8_rows(cam::kb8_from10(cam), bf, xc, iz, u, v, A);
  } else if constexpr (kCam == cam::kRadtan) {
    const cam::Radtan d = {cam[5], cam[6], cam[7], cam[8], cam[9]};
    float xd, yd;
    cam::distort(d, xc[0] / z, xc[1] / z, xd, yd);
    u = fx * xd + cx, v = fy * yd + cy;
    float J[2][3];
    cam::pixel_jac(fx, fy, d, xn, yn, iz, J);
    for (int k = 0; k < 3; ++k) A[0][k] = A[2][k] = J[0][k], A[1][k] = J[1][k];
    A[2][2] = J[0][2] + bf * iz * iz;
  } else {
    u = fx * (xc[0] * iz) + cx, v = fy * (xc[1] * iz) + cy;
    A[0][0] = fx * iz, A[0][1] = 0.f, A[0][2] = -fx * xn * iz;
    A[1][0] = 0.f, A[1][1] = fy * iz, A[1][2] = -fy * yn * iz;
    A[2][0] = fx * iz, A[2][1] = 0.f, A[2][2] = -fx * xn * iz + bf * iz * iz;
  }
  const bool st = e.is_stereo[i];
  r[0] = e.uv[3 * i] - u;
  r[1] = e.uv[3 * i + 1] - v;
  r[2] = st ? e.uv[3 * i + 2] - (u - bf * iz) : 0.f;
}

struct Shared {
  double st[2][21];    // [prev, cur] states (R | p | v | b)
  double cand[2][21];  // the candidates
  double prior[21];
  double Hp[15][15];
  double I9[9][9], W6[6][6];
  double F0[30];       // factor residuals at the current states
  double J[30][30];    // factor Jacobian, rows = factors, cols = tangent directions
  double WJ[30][30];   // blockdiag(I9, W6, Hp) J
  double A[30][46];    // augmented system (n + 15 columns for the marginalisation)
  double x[30 * 15];
  double red[8 * 28];
  double vis[28];      // visual H (21 upper) | g (6) | cost
  double lam, cost0, cost1;
  int piv;
};

// The visual pose block at state s (21 upper of H6, g6, the IRLS cost) or, with
// only_cost, the cost alone; inlier is the mask of this round.
template <int kCam>
__device__ void visual_pass(const float* cam, const float* tcb, const double* s, const Edges& e, const uint8_t* inlier,
                            bool only_cost, Shared& sh) {
  inr::State st;
  inr::load_state(s, st);
  double Rcw_d[3][3], tcw_d[3];
  inr::camera_of(tcb, st.R, st.p, Rcw_d, tcw_d);
  float Rcw[3][3], tcw[3], Rcb[3][3];
  for (int r = 0; r < 3; ++r) {
    tcw[r] = (float)tcw_d[r];
    for (int c = 0; c < 3; ++c) Rcw[r][c] = (float)Rcw_d[r][c], Rcb[r][c] = tcb[3 * r + c];
  }
  double acc[28] = {};
  for (int i = threadIdx.x; i < e.n; i += blockDim.x) {
    float r[3], xc[3], A[3][3];
    project<kCam>(cam, Rcw, tcw, e, i, r, xc, A);
    const bool st_i = e.is_stereo[i];
    const float s2 = e.inv_s2[i];
    const float chi2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * s2;
    const float delta2 = st_i ? kChi2Stereo : kChi2Mono;
    const bool active = e.valid[i] && inlier[i] && xc[2] > 0.05f;
    if (!active) continue;
    const float w_h = chi2 <= delta2 ? 1.f : sqrtf(delta2 / fmaxf(chi2, 1e-12f));
    const float w = w_h * s2;
    acc[27] += (double)(w * (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]));
    if (only_cost) continue;
    // y = R_wb^T (x - p); J = -A [R_cb hat(y), -R_cb]
    float y[3];
    {
      const float d0 = e.xw[3 * i] - (float)st.p[0], d1 = e.xw[3 * i + 1] - (float)st.p[1],
                  d2 = e.xw[3 * i + 2] - (float)st.p[2];
      for (int a = 0; a < 3; ++a) y[a] = (float)st.R[0][a] * d0 + (float)st.R[1][a] * d1 + (float)st.R[2][a] * d2;
    }
    const int rows = st_i ? 3 : 2;
    for (int q = 0; q < rows; ++q) {
      float B[3];
      for (int c = 0; c < 3; ++c) B[c] = A[q][0] * Rcb[0][c] + A[q][1] * Rcb[1][c] + A[q][2] * Rcb[2][c];
      const float j[6] = {-(B[1] * y[2] - B[2] * y[1]), -(B[2] * y[0] - B[0] * y[2]), -(B[0] * y[1] - B[1] * y[0]),
                          B[0], B[1], B[2]};
      int h = 0;
      for (int a = 0; a < 6; ++a)
        for (int b = a; b < 6; ++b) acc[h++] += (double)(w * (j[a] * j[b]));
      for (int a = 0; a < 6; ++a) acc[21 + a] -= (double)(w * j[a] * r[q]);
    }
  }
  inr::block_sums(acc, 28, sh.red, sh.vis);
}

// Chi2 classification of every edge at state s into inlier.
template <int kCam>
__device__ void classify(const float* cam, const float* tcb, const double* s, const Edges& e, uint8_t* inlier) {
  inr::State st;
  inr::load_state(s, st);
  double Rcw_d[3][3], tcw_d[3];
  inr::camera_of(tcb, st.R, st.p, Rcw_d, tcw_d);
  float Rcw[3][3], tcw[3];
  for (int r = 0; r < 3; ++r) {
    tcw[r] = (float)tcw_d[r];
    for (int c = 0; c < 3; ++c) Rcw[r][c] = (float)Rcw_d[r][c];
  }
  for (int i = threadIdx.x; i < e.n; i += blockDim.x) {
    float r[3], xc[3], A[3][3];
    project<kCam>(cam, Rcw, tcw, e, i, r, xc, A);
    const float chi2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * e.inv_s2[i];
    inlier[i] = e.valid[i] && chi2 <= (e.is_stereo[i] ? kChi2Stereo : kChi2Mono) && xc[2] > 0.05f;
  }
  __syncthreads();
}

// The factor stack [inertial (9), walk (6), prior (15)] at states (prev, cur)
// along tangent ``dir`` (< 0: values only); nd directions: the current
// state's 15 (after the previous state's 15 in the last-frame form).
template <bool kLast, bool kPrior>
__device__ void factors(const double* sp, const double* sc, const double* prior, const inr::Delta& dl, int dir,
                        Dual (&F)[30]) {
  inr::State Sp, Sc;
  inr::load_state(sp, Sp);
  inr::load_state(sc, Sc);
  Dual dp[15], dc[15];
  for (int k = 0; k < 15; ++k) {
    dp[k] = {0.0, kLast && dir == k ? 1.0 : 0.0};
    dc[k] = {0.0, dir == (kLast ? 15 + k : k) ? 1.0 : 0.0};
  }
  inr::TState<Dual> a, b;
  inr::retract(Sp, dp, a);
  inr::retract(Sc, dc, b);
  Dual r[15];
  inr::inertial_factors(a, b, dl, r);
  for (int k = 0; k < 15; ++k) F[k] = r[k];
  if constexpr (kLast || kPrior) {
    inr::State pr;
    inr::load_state(prior, pr);
    inr::prior_factor(kLast ? a : b, pr, r);
    for (int k = 0; k < 15; ++k) F[15 + k] = r[k];
  }
}

// Weighted quadratic F^T blockdiag(I9, W6, Hp) F of the factor values.
template <bool kPF>
__device__ double factor_cost(const Dual (&F)[30], const Shared& sh) {
  double c = 0.0;
  for (int a = 0; a < 9; ++a)
    for (int b = 0; b < 9; ++b) c += F[a].v * sh.I9[a][b] * F[b].v;
  for (int a = 0; a < 6; ++a)
    for (int b = 0; b < 6; ++b) c += F[9 + a].v * sh.W6[a][b] * F[9 + b].v;
  if constexpr (kPF)
    for (int a = 0; a < 15; ++a)
      for (int b = 0; b < 15; ++b) c += F[15 + a].v * sh.Hp[a][b] * F[15 + b].v;
  return c;
}

// The full normal equations H (n x n) into sh.A (and g into column n) at the
// current states: the factor Jacobian by dual numbers, the visual pose
// block at offset ``off``; returns through sh.cost0 the GN cost.
template <int kCam, bool kLast, bool kPrior>
__device__ void normal_equations(const float* cam, const float* tcb, const inr::Delta& dl, const Edges& e,
                                 const uint8_t* inlier, Shared& sh) {
  constexpr int nd = kLast ? 30 : 15, nf = (kLast || kPrior) ? 30 : 15, off = kLast ? 15 : 0;
  visual_pass<kCam>(cam, tcb, sh.st[1], e, inlier, false, sh);
  if (threadIdx.x < nd) {
    Dual F[30];
    factors<kLast, kPrior>(sh.st[0], sh.st[1], sh.prior, dl, threadIdx.x, F);
    for (int f = 0; f < nf; ++f) sh.J[f][threadIdx.x] = F[f].d;
    if (threadIdx.x == 0) {
      for (int f = 0; f < nf; ++f) sh.F0[f] = F[f].v;
      sh.cost0 = factor_cost<kLast || kPrior>(F, sh) + sh.vis[27];
    }
  }
  __syncthreads();
  // WJ = blockdiag(I9, W6, Hp) J
  for (int t = threadIdx.x; t < nf * nd; t += blockDim.x) {
    const int f = t / nd, k = t % nd;
    double s = 0.0;
    if (f < 9) {
      for (int b = 0; b < 9; ++b) s += sh.I9[f][b] * sh.J[b][k];
    } else if (f < 15) {
      for (int b = 0; b < 6; ++b) s += sh.W6[f - 9][b] * sh.J[9 + b][k];
    } else {
      for (int b = 0; b < 15; ++b) s += sh.Hp[f - 15][b] * sh.J[15 + b][k];
    }
    sh.WJ[f][k] = s;
  }
  __syncthreads();
  // H = J^T WJ, g = -WJ^T F0, plus the visual block
  for (int t = threadIdx.x; t < nd * (nd + 1); t += blockDim.x) {
    const int p = t / (nd + 1), q = t % (nd + 1);
    double s = 0.0;
    if (q < nd) {
      for (int f = 0; f < nf; ++f) s += sh.J[f][p] * sh.WJ[f][q];
      const int pv = p - off, qv = q - off;
      if (pv >= 0 && pv < 6 && qv >= 0 && qv < 6) {
        const int a = pv < qv ? pv : qv, b = pv < qv ? qv : pv;
        s += sh.vis[a * 6 - a * (a - 1) / 2 + (b - a)];
      }
    } else {
      for (int f = 0; f < nf; ++f) s -= sh.WJ[f][p] * sh.F0[f];
      const int pv = p - off;
      if (pv >= 0 && pv < 6) s += sh.vis[21 + pv];
    }
    sh.A[p][q] = s;
  }
  __syncthreads();
}

__device__ void retract_store(const double* s, const double* d, double* out) {
  inr::State S;
  inr::load_state(s, S);
  double dd[15];
  for (int k = 0; k < 15; ++k) dd[k] = d[k];
  inr::TState<double> o;
  inr::retract(S, dd, o);
  // the state is kept in float32 between iterations, as the plain version keeps it
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) out[3 * r + c] = (float)o.R[r][c];
    out[9 + r] = (float)o.p[r];
    out[12 + r] = (float)o.v[r];
  }
  for (int k = 0; k < 6; ++k) out[15 + k] = (float)o.b[k];
}

template <int kCam, bool kLast, bool kPrior>
__global__ void __launch_bounds__(kThreads)
pose_inertial_kernel(const float* __restrict__ cam, const float* __restrict__ tcb, const float* __restrict__ s_prev,
                     const float* __restrict__ pk, const float* __restrict__ s0, const float* __restrict__ prior,
                     Edges e, int n_rounds, int iters, float* __restrict__ state_out, uint8_t* __restrict__ inlier,
                     int* __restrict__ n_inl, float* __restrict__ H_out) {
  constexpr int nd = kLast ? 30 : 15, off = kLast ? 15 : 0;
  __shared__ Shared sh;
  inr::Delta dl;
  inr::load_delta(pk, dl);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 21; ++k) sh.st[0][k] = s_prev[k], sh.st[1][k] = s0[k];
    if (kLast || kPrior) {
      for (int k = 0; k < 21; ++k) sh.prior[k] = prior[k];
      for (int a = 0; a < 15; ++a)
        for (int b = 0; b < 15; ++b) sh.Hp[a][b] = prior[21 + 15 * a + b];
    }
    inr::informations(pk, sh.I9, sh.W6);
  }
  for (int i = threadIdx.x; i < e.n; i += blockDim.x) inlier[i] = 1;  // round 0: every slot
  __syncthreads();
  for (int round = 0; round < n_rounds; ++round) {
    if (threadIdx.x == 0) sh.lam = 1e-2;
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
      normal_equations<kCam, kLast, kPrior>(cam, tcb, dl, e, inlier, sh);
      for (int p = threadIdx.x; p < nd; p += blockDim.x)  // damping: lam * max(diag, 1e-6) + 1e-8
        sh.A[p][p] += sh.lam * fmax(sh.A[p][p], 1e-6) + 1e-8;
      __syncthreads();
      inr::block_solve(&sh.A[0][0], nd, 1, 46, sh.x, &sh.piv);
      if (threadIdx.x == 0) {
        if (kLast) retract_store(sh.st[0], sh.x, sh.cand[0]);
        else
          for (int k = 0; k < 21; ++k) sh.cand[0][k] = sh.st[0][k];
        retract_store(sh.st[1], sh.x + off, sh.cand[1]);
      }
      __syncthreads();
      visual_pass<kCam>(cam, tcb, sh.cand[1], e, inlier, true, sh);
      if (threadIdx.x == 0) {
        Dual F[30];
        factors<kLast, kPrior>(sh.cand[0], sh.cand[1], sh.prior, dl, -1, F);
        const double cost1 = factor_cost<kLast || kPrior>(F, sh) + sh.vis[27];
        const bool accept = cost1 < sh.cost0;
        if (accept)
          for (int k = 0; k < 21; ++k) sh.st[0][k] = sh.cand[0][k], sh.st[1][k] = sh.cand[1][k];
        sh.lam = accept ? fmax(sh.lam * 0.5, 1e-7) : fmin(sh.lam * 5.0, 1e5);
      }
      __syncthreads();
    }
    classify<kCam>(cam, tcb, sh.st[1], e, inlier);
  }
  // the information at the solution with the final inliers
  normal_equations<kCam, kLast, kPrior>(cam, tcb, dl, e, inlier, sh);
  double cnt[1] = {0.0};
  for (int i = threadIdx.x; i < e.n; i += blockDim.x) cnt[0] += inlier[i] ? 1.0 : 0.0;
  inr::block_sums(cnt, 1, sh.red, sh.vis);
  if (threadIdx.x == 0) {
    *n_inl = (int)sh.vis[0];
    for (int k = 0; k < 21; ++k) state_out[k] = (float)sh.st[1][k];
  }
  // symmetrise (H + H^T) / 2 in place
  for (int t = threadIdx.x; t < nd * nd; t += blockDim.x) {
    const int p = t / nd, q = t % nd;
    if (p < q) {
      const double m = 0.5 * (sh.A[p][q] + sh.A[q][p]);
      sh.A[p][q] = m, sh.A[q][p] = m;
    }
  }
  __syncthreads();
  if constexpr (!kLast) {
    for (int t = threadIdx.x; t < 225; t += blockDim.x) H_out[t] = (float)sh.A[t / 15][t % 15];
  } else {
    // H_marg = H22 - H12^T solve(H11 + 1e-6 I, H12): the elimination runs on rows 0..14 with H12 (columns
    // 15..29) as its 15 right sides, leaving rows 15..29 (H21 = H12^T and H22) as they are
    if (threadIdx.x < 15) sh.A[threadIdx.x][threadIdx.x] += 1e-6;
    __syncthreads();
    inr::block_solve(&sh.A[0][0], 15, 15, 46, sh.x, &sh.piv);
    __shared__ double M[15][15];
    for (int t = threadIdx.x; t < 225; t += blockDim.x) {
      const int p = t / 15, q = t % 15;
      double s = 0.0;
      for (int k = 0; k < 15; ++k) s += sh.A[15 + p][k] * sh.x[k * 15 + q];
      M[p][q] = sh.A[15 + p][15 + q] - s;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < 225; t += blockDim.x) {
      const int p = t / 15, q = t % 15;
      H_out[t] = (float)(0.5 * (M[p][q] + M[q][p]));
    }
  }
}

template <int kCam>
int launch_cam(const float* cam, const float* tcb, const float* sp, const float* pk, const float* s0,
                const float* prior, int last, const Edges& e, int n_rounds, int iters, float* state_out,
                uint8_t* inlier, int* n_inl, float* H_out, cudaStream_t st) {
  if (last)
    pose_inertial_kernel<kCam, true, true><<<1, kThreads, 0, st>>>(cam, tcb, sp, pk, s0, prior, e, n_rounds, iters,
                                                                   state_out, inlier, n_inl, H_out);
  else if (prior)
    pose_inertial_kernel<kCam, false, true><<<1, kThreads, 0, st>>>(cam, tcb, sp, pk, s0, prior, e, n_rounds, iters,
                                                                    state_out, inlier, n_inl, H_out);
  else
    pose_inertial_kernel<kCam, false, false><<<1, kThreads, 0, st>>>(cam, tcb, sp, pk, s0, prior, e, n_rounds,
                                                                     iters, state_out, inlier, n_inl, H_out);
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
  const Edges e = {xw, uv, inv_s2, is_stereo, valid, n};
  if (kind == cam::kKB8)
    return launch_cam<cam::kKB8>(cam10, tcb, s_prev, pk, s0, prior, last, e, n_rounds, iters, state_out, inlier,
                                 n_inl, H_out, st);
  if (kind == cam::kRadtan)
    return launch_cam<cam::kRadtan>(cam10, tcb, s_prev, pk, s0, prior, last, e, n_rounds, iters, state_out, inlier,
                                    n_inl, H_out, st);
  return launch_cam<cam::kPinhole>(cam10, tcb, s_prev, pk, s0, prior, last, e, n_rounds, iters, state_out, inlier,
                                   n_inl, H_out, st);
}
