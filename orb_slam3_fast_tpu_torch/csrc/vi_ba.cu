// Kernel Y: the windowed visual-inertial BA, one CTA for the whole call
// (iters1 LM iterations, the chi2 classification, iters2 more, the final
// classification), its working set in a float64 scratch buffer in global
// memory.  Per iteration: the observations' residuals and Jacobians (body
// pose through T_cb, landmark), each thread writing its own; per landmark,
// over its observations in CSR order, Hll, bl and the damped inverse; per
// observation W = Jp^T w Jl and W V^-1; the inertial edges' Jacobian
// columns in dual numbers (inertial.cuh), thread (edge, direction); the
// dense system over the free states, (15 nf)^2, entry by entry in a
// fixed order (the state's edges in turn, a
// state's observations in landmark order, the Schur coupling of a pair of
// states by a merge of their two landmark-sorted lists); the block's
// Gaussian elimination; the landmarks' back-substitution; the candidate's
// robust cost and the accept on the device.  The camera's kind (camera.cuh:
// pin-hole, radial-tangential or KB8) is a template parameter.  See the
// source note in optim/vi_ba.py.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "camera.cuh"
#include "inertial.cuh"

namespace {

using sim3::Dual;

constexpr int kThreads = 512;
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;
constexpr int kObs = 68;   // r 3 | Jp 18 | Jl 9 | w | rho | W 18 | ZV 18
constexpr int kLm = 31;    // Hll 9 | bl 3 | V 9 | w 1 | dl 3 | xw 3 | xw candidate 3
constexpr int kEdge = 1032;  // J 15 x 30 | WJ 15 x 30 | r 15 | I9 81 | W6 36

struct Prob {
  const float *cam, *tcb;
  int K, M, O, E;
  const float *R, *p, *v, *b;
  const uint8_t* fixed;
  const float* xw;
  const uint8_t* lm_valid;
  const int *obs_kf, *obs_lm;
  const float *uv, *inv_s2;
  const uint8_t *is_stereo, *obs_valid;
  const int *edge_i, *edge_j;
  const uint8_t* edge_valid;
  const float* pk;
  const int *lm_ptr, *lm_obs, *kf_ptr, *kf_obs;
  const int *ke_ptr, *ke_edge;  // each state's valid inertial edges, in edge order
  const int *free_ids, *free_pos;  // the nf free states in order; each state's place among them (-1: fixed)
  int nf, iters1, iters2;
};

struct Work {
  double *obs, *lm, *edge, *A, *dxc, *dx, *st, *cand, *misc;
  int n;  // the system's size: 15 per free state
};

__device__ Work carve(double* s, const Prob& P) {
  Work w;
  w.n = 15 * P.nf;
  w.obs = s;
  w.lm = w.obs + (size_t)kObs * P.O;
  w.edge = w.lm + (size_t)kLm * P.M;
  w.A = w.edge + (size_t)kEdge * P.E;
  w.dxc = w.A + (size_t)w.n * (w.n + 1);
  w.dx = w.dxc + w.n;
  w.st = w.dx + 15 * P.K;
  w.cand = w.st + 21 * P.K;
  w.misc = w.cand + 21 * P.K;  // lam, cost0, cost1, accept, block sums scratch
  return w;
}

// The observation's residual, camera point and d(u, v, u_r)/d(xc) rows at state st (float32, as kernel W).
template <int kCam>
__device__ void project(const Prob& P, int o, const double* st, const double* xw_m, float (&r)[3], float (&xc)[3],
                        float (&A)[3][3], float (&y)[3]) {
  inr::State S;
  inr::load_state(st, S);
  double Rcw[3][3], tcw[3];
  inr::camera_of(P.tcb, S.R, S.p, Rcw, tcw);
  const float X = (float)xw_m[0], Y = (float)xw_m[1], Z = (float)xw_m[2];
  for (int k = 0; k < 3; ++k) xc[k] = (float)Rcw[k][0] * X + (float)Rcw[k][1] * Y + (float)Rcw[k][2] * Z + (float)tcw[k];
  const float d0 = X - (float)S.p[0], d1 = Y - (float)S.p[1], d2 = Z - (float)S.p[2];
  for (int a = 0; a < 3; ++a) y[a] = (float)S.R[0][a] * d0 + (float)S.R[1][a] * d1 + (float)S.R[2][a] * d2;
  const float* cam = P.cam;
  const float fx = cam[0], fy = cam[1], cx = cam[2], cy = cam[3], bf = cam[4];
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
  const bool stereo = P.is_stereo[o];
  r[0] = P.uv[3 * o] - u;
  r[1] = P.uv[3 * o + 1] - v;
  r[2] = stereo ? P.uv[3 * o + 2] - (u - bf * iz) : 0.f;
  if (!stereo) A[2][0] = A[2][1] = A[2][2] = 0.f;
}

// Per observation at the states ``st`` and landmarks (offset ``xoff`` in the landmark rows): robust cost, and
// unless only_cost the residual, Jacobians, weight and W = Jp^T w Jl.
template <int kCam>
__device__ double obs_pass(const Prob& P, const Work& w, const double* st, int xoff, const uint8_t* inlier,
                           bool only_cost) {
  double cost = 0.0;
  for (int o = threadIdx.x; o < P.O; o += blockDim.x) {
    const int k = P.obs_kf[o], m = P.obs_lm[o];
    float r[3], xc[3], A[3][3], y[3];
    project<kCam>(P, o, st + 21 * k, w.lm + (size_t)kLm * m + xoff, r, xc, A, y);
    const float s2 = P.inv_s2[o];
    const float chi2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * s2;
    const float delta2 = P.is_stereo[o] ? kChi2Stereo : kChi2Mono;
    const bool active = P.obs_valid[o] && inlier[o] && xc[2] > 0.05f && P.lm_valid[m];
    const float rho = chi2 <= delta2 ? chi2 : 2.f * sqrtf(delta2 * fmaxf(chi2, 1e-12f)) - delta2;
    if (active) cost += (double)rho;
    if (only_cost) continue;
    double* ob = w.obs + (size_t)kObs * o;
    const float wt = active ? (chi2 <= delta2 ? 1.f : sqrtf(delta2 / fmaxf(chi2, 1e-12f))) * s2 : 0.f;
    const bool free_k = !P.fixed[k];
    inr::State S;
    inr::load_state(st + 21 * k, S);
    double Rcw[3][3], tcw[3];
    inr::camera_of(P.tcb, S.R, S.p, Rcw, tcw);
    for (int q = 0; q < 3; ++q) {
      float B[3];
      for (int c = 0; c < 3; ++c) B[c] = A[q][0] * P.tcb[c] + A[q][1] * P.tcb[3 + c] + A[q][2] * P.tcb[6 + c];
      const float j[6] = {-(B[1] * y[2] - B[2] * y[1]), -(B[2] * y[0] - B[0] * y[2]), -(B[0] * y[1] - B[1] * y[0]),
                          B[0], B[1], B[2]};
      ob[q] = r[q];
      for (int a = 0; a < 6; ++a) ob[3 + 6 * q + a] = free_k ? j[a] : 0.0;
      for (int c = 0; c < 3; ++c)
        ob[21 + 3 * q + c] = -(A[q][0] * (float)Rcw[0][c] + A[q][1] * (float)Rcw[1][c] + A[q][2] * (float)Rcw[2][c]);
    }
    ob[30] = wt;
    ob[31] = active ? rho : 0.0;
    for (int a = 0; a < 6; ++a)
      for (int c = 0; c < 3; ++c) {
        double s = 0.0;
        for (int q = 0; q < 3; ++q) s += ob[3 + 6 * q + a] * wt * ob[21 + 3 * q + c];
        ob[32 + 3 * a + c] = s;
      }
  }
  return cost;
}

// The inertial edges at states st: Jacobian columns (thread per edge x direction), residuals, WJ; returns
// nothing; the per-edge costs are summed by the caller from the stored residuals.
__device__ void edge_pass(const Prob& P, const Work& w, const double* st) {
  for (int t = threadIdx.x; t < P.E * 30; t += blockDim.x) {
    const int e = t / 30, dir = t % 30;
    if (!P.edge_valid[e]) continue;
    const int i = P.edge_i[e], j = P.edge_j[e];
    inr::State Si, Sj;
    inr::load_state(st + 21 * i, Si);
    inr::load_state(st + 21 * j, Sj);
    inr::Delta dl;
    inr::load_delta(P.pk + inr::kPacked * e, dl);
    Dual di[15], dj[15];
    for (int k = 0; k < 15; ++k) di[k] = {0.0, dir == k ? 1.0 : 0.0}, dj[k] = {0.0, dir == 15 + k ? 1.0 : 0.0};
    inr::TState<Dual> a, b;
    inr::retract(Si, di, a);
    inr::retract(Sj, dj, b);
    Dual r[15];
    inr::inertial_factors(a, b, dl, r);
    const double m = dir < 15 ? (P.fixed[i] ? 0.0 : 1.0) : (P.fixed[j] ? 0.0 : 1.0);
    double* ed = w.edge + (size_t)kEdge * e;
    for (int row = 0; row < 15; ++row) ed[30 * row + dir] = r[row].d * m;
    if (dir == 0)
      for (int row = 0; row < 15; ++row) ed[900 + row] = r[row].v;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < P.E * 450; t += blockDim.x) {
    const int e = t / 450, row = (t % 450) / 30, col = t % 30;
    if (!P.edge_valid[e]) continue;
    double* ed = w.edge + (size_t)kEdge * e;
    double s = 0.0;
    if (row < 9) {
      for (int b = 0; b < 9; ++b) s += ed[915 + 9 * row + b] * ed[30 * b + col];
    } else {
      for (int b = 0; b < 6; ++b) s += ed[996 + 6 * (row - 9) + b] * ed[30 * (9 + b) + col];
    }
    ed[450 + 30 * row + col] = s;
  }
  __syncthreads();
}

// ev * (r9^T I9 r9 + rb^T W6 rb) of edge e at states st.
__device__ double edge_cost(const Prob& P, const Work& w, const double* st, int e) {
  if (!P.edge_valid[e]) return 0.0;
  const int i = P.edge_i[e], j = P.edge_j[e];
  inr::State Si, Sj;
  inr::load_state(st + 21 * i, Si);
  inr::load_state(st + 21 * j, Sj);
  inr::Delta dl;
  inr::load_delta(P.pk + inr::kPacked * e, dl);
  double z[15] = {};
  inr::TState<double> a, b;
  inr::retract(Si, z, a);
  inr::retract(Sj, z, b);
  double r[15];
  inr::inertial_factors(a, b, dl, r);
  const double* ed = w.edge + (size_t)kEdge * e;
  double c = 0.0;
  for (int p = 0; p < 9; ++p)
    for (int q = 0; q < 9; ++q) c += r[p] * ed[915 + 9 * p + q] * r[q];
  for (int p = 0; p < 6; ++p)
    for (int q = 0; q < 6; ++q) c += r[9 + p] * ed[996 + 6 * p + q] * r[9 + q];
  return c;
}

template <int kCam>
__device__ void classify(const Prob& P, const Work& w, uint8_t* inlier) {
  for (int o = threadIdx.x; o < P.O; o += blockDim.x) {
    float r[3], xc[3], A[3][3], y[3];
    project<kCam>(P, o, w.st + 21 * P.obs_kf[o], w.lm + (size_t)kLm * P.obs_lm[o] + 25, r, xc, A, y);
    const float chi2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * P.inv_s2[o];
    inlier[o] = P.obs_valid[o] && chi2 <= (P.is_stereo[o] ? kChi2Stereo : kChi2Mono) && xc[2] > 0.05f;
  }
  __syncthreads();
}

template <int kCam>
__global__ void __launch_bounds__(kThreads) vi_ba_kernel(Prob P, double* scratch, float* state_out, float* xw_out,
                                                         uint8_t* inlier) {
  __shared__ double red[16 * 2];
  __shared__ double sums[2];
  __shared__ int piv;
  const Work w = carve(scratch, P);
  const int n = w.n, K = P.K;
  // states and landmarks into the scratch (float64), every observation in, the informations
  for (int t = threadIdx.x; t < 21 * K; t += blockDim.x) {
    const int k = t / 21, f = t % 21;
    w.st[t] = f < 9 ? P.R[9 * k + f] : (f < 12 ? P.p[3 * k + f - 9] : (f < 15 ? P.v[3 * k + f - 12] : P.b[6 * k + f - 15]));
  }
  for (int t = threadIdx.x; t < 3 * P.M; t += blockDim.x) w.lm[(size_t)kLm * (t / 3) + 25 + t % 3] = P.xw[t];
  for (int o = threadIdx.x; o < P.O; o += blockDim.x) inlier[o] = 1;
  for (int e = threadIdx.x; e < P.E; e += blockDim.x) {
    double I9[9][9], W6[6][6];
    inr::informations(P.pk + inr::kPacked * e, I9, W6);
    double* ed = w.edge + (size_t)kEdge * e;
    for (int t = 0; t < 81; ++t) ed[915 + t] = I9[t / 9][t % 9];
    for (int t = 0; t < 36; ++t) ed[996 + t] = W6[t / 6][t % 6];
  }
  __syncthreads();
  for (int phase = 0; phase < 2; ++phase) {
    if (threadIdx.x == 0) w.misc[0] = 1e-4;
    __syncthreads();
    const int iters = phase == 0 ? P.iters1 : P.iters2;
    for (int it = 0; it < iters; ++it) {
      const double lam = w.misc[0];
      // (1) observations and inertial edges at the current state; the current cost
      double c[2] = {obs_pass<kCam>(P, w, w.st, 25, inlier, false), 0.0};
      edge_pass(P, w, w.st);
      for (int e = threadIdx.x; e < P.E; e += blockDim.x) {
        if (!P.edge_valid[e]) continue;
        const double* ed = w.edge + (size_t)kEdge * e;
        double s = 0.0;
        for (int p = 0; p < 9; ++p)
          for (int q = 0; q < 9; ++q) s += ed[900 + p] * ed[915 + 9 * p + q] * ed[900 + q];
        for (int p = 0; p < 6; ++p)
          for (int q = 0; q < 6; ++q) s += ed[909 + p] * ed[996 + 6 * p + q] * ed[909 + q];
        c[1] += s;
      }
      inr::block_sums(c, 2, red, sums);
      if (threadIdx.x == 0) w.misc[1] = sums[0] + sums[1];
      // (2) per landmark: Hll, bl, w over its observations in order, the damped inverse
      for (int m = threadIdx.x; m < P.M; m += blockDim.x) {
        double H[3][3] = {}, bl[3] = {}, wl = 0.0;
        for (int t = P.lm_ptr[m]; t < P.lm_ptr[m + 1]; ++t) {
          const double* ob = w.obs + (size_t)kObs * P.lm_obs[t];
          const double wt = ob[30];
          for (int q = 0; q < 3; ++q)
            for (int a = 0; a < 3; ++a) {
              bl[a] -= ob[21 + 3 * q + a] * wt * ob[q];
              for (int b = 0; b < 3; ++b) H[a][b] += ob[21 + 3 * q + a] * wt * ob[21 + 3 * q + b];
            }
          wl += wt;
        }
        double* L = w.lm + (size_t)kLm * m;
        for (int t = 0; t < 9; ++t) L[t] = H[t / 3][t % 3];
        for (int a = 0; a < 3; ++a) L[9 + a] = bl[a];
        L[21] = wl;
        double V[3][3];
        if (wl > 0.0) {
          for (int a = 0; a < 3; ++a) H[a][a] += lam * fmax(H[a][a], 1e-3);
          inr::invert(H, V);
        } else {
          for (int t = 0; t < 9; ++t) V[t / 3][t % 3] = t / 3 == t % 3 ? 1.0 : 0.0;
        }
        for (int t = 0; t < 9; ++t) L[12 + t] = V[t / 3][t % 3];
      }
      __syncthreads();
      // (3) per observation: ZV = W V^-1
      for (int o = threadIdx.x; o < P.O; o += blockDim.x) {
        double* ob = w.obs + (size_t)kObs * o;
        const double* V = w.lm + (size_t)kLm * P.obs_lm[o] + 12;
        for (int a = 0; a < 6; ++a)
          for (int cc = 0; cc < 3; ++cc)
            ob[50 + 3 * a + cc] = ob[32 + 3 * a] * V[cc] + ob[32 + 3 * a + 1] * V[3 + cc] + ob[32 + 3 * a + 2] * V[6 + cc];
      }
      __syncthreads();
      // (4a) the dense system over the free states (a fixed state's rows and columns would be the identity's,
      // coupled to nothing): the state's inertial edges in order, its observations, damping, 1e-6
      for (size_t t = threadIdx.x; t < (size_t)n * (n + 1); t += blockDim.x) {
        const int pp = (int)(t / (n + 1)), q = (int)(t % (n + 1));
        const int ka = P.free_ids[pp / 15], a = pp % 15;
        double s = 0.0;
        if (q < n) {
          const int kb = P.free_ids[q / 15], b = q % 15;
          for (int te = P.ke_ptr[ka]; te < P.ke_ptr[ka + 1]; ++te) {
            const int e = P.ke_edge[te], ei = P.edge_i[e], ej = P.edge_j[e];
            const int lp = ka == ei ? a : 15 + a;
            const int lq = kb == ei ? b : (kb == ej ? 15 + b : -1);
            if (lq < 0) continue;
            const double* ed = w.edge + (size_t)kEdge * e;
            for (int row = 0; row < 15; ++row) s += ed[30 * row + lp] * ed[450 + 30 * row + lq];
          }
          if (ka == kb && a < 6 && b < 6)
            for (int tt = P.kf_ptr[ka]; tt < P.kf_ptr[ka + 1]; ++tt) {
              const double* ob = w.obs + (size_t)kObs * P.kf_obs[tt];
              for (int qq = 0; qq < 3; ++qq) s += ob[3 + 6 * qq + a] * ob[30] * ob[3 + 6 * qq + b];
            }
          if (pp == q) s += lam * fmax(s, 1e-3) + 1e-6;
        } else {
          for (int te = P.ke_ptr[ka]; te < P.ke_ptr[ka + 1]; ++te) {
            const int e = P.ke_edge[te];
            const int lp = ka == P.edge_i[e] ? a : 15 + a;
            const double* ed = w.edge + (size_t)kEdge * e;
            for (int row = 0; row < 15; ++row) s -= ed[450 + 30 * row + lp] * ed[900 + row];
          }
          if (a < 6)
            for (int tt = P.kf_ptr[ka]; tt < P.kf_ptr[ka + 1]; ++tt) {
              const double* ob = w.obs + (size_t)kObs * P.kf_obs[tt];
              for (int qq = 0; qq < 3; ++qq) s -= ob[3 + 6 * qq + a] * ob[30] * ob[qq];
            }
        }
        w.A[t] = s;
      }
      __syncthreads();
      // (4b) the Schur coupling of each pair of free states (kb <= ka, places fa, fb), row a: a merge of their
      // landmark-sorted observation lists; on the diagonal pair also the correction of the right side
      const int nf = P.nf;
      for (int t = threadIdx.x; t < nf * nf * 6; t += blockDim.x) {
        const int fa = t / (6 * nf), fb = (t / 6) % nf, a = t % 6;
        if (fb > fa) continue;
        const int ka = P.free_ids[fa], kb = P.free_ids[fb];
        double s[6] = {};
        int ia = P.kf_ptr[ka], ib = P.kf_ptr[kb];
        const int ea = P.kf_ptr[ka + 1], eb = P.kf_ptr[kb + 1];
        while (ia < ea && ib < eb) {
          const int ma = P.obs_lm[P.kf_obs[ia]], mb = P.obs_lm[P.kf_obs[ib]];
          if (ma < mb) { ++ia; continue; }
          if (mb < ma) { ++ib; continue; }
          int ja = ia;  // the runs of landmark ma in both lists: every pair
          while (ja < ea && P.obs_lm[P.kf_obs[ja]] == ma) {
            const double* za = w.obs + (size_t)kObs * P.kf_obs[ja] + 50 + 3 * a;
            for (int jb = ib; jb < eb && P.obs_lm[P.kf_obs[jb]] == ma; ++jb) {
              const double* wb = w.obs + (size_t)kObs * P.kf_obs[jb] + 32;
              for (int b = 0; b < 6; ++b) s[b] += za[0] * wb[3 * b] + za[1] * wb[3 * b + 1] + za[2] * wb[3 * b + 2];
            }
            ++ja;
          }
          ia = ja;
          while (ib < eb && P.obs_lm[P.kf_obs[ib]] == ma) ++ib;
        }
        for (int b = 0; b < 6; ++b) {
          w.A[(size_t)(15 * fa + a) * (n + 1) + 15 * fb + b] -= s[b];
          if (fa != fb) w.A[(size_t)(15 * fb + b) * (n + 1) + 15 * fa + a] -= s[b];
        }
        if (ka == kb) {
          double bc = 0.0;
          for (int tt = P.kf_ptr[ka]; tt < P.kf_ptr[ka + 1]; ++tt) {
            const int o = P.kf_obs[tt];
            const double* zv = w.obs + (size_t)kObs * o + 50 + 3 * a;
            const double* bl = w.lm + (size_t)kLm * P.obs_lm[o] + 9;
            bc += zv[0] * bl[0] + zv[1] * bl[1] + zv[2] * bl[2];
          }
          w.A[(size_t)(15 * fa + a) * (n + 1) + n] -= bc;
        }
      }
      __syncthreads();
      // (5) the solve; fixed states keep dx = 0
      inr::block_solve(w.A, n, 1, n + 1, w.dxc, &piv);
      for (int pp = threadIdx.x; pp < 15 * K; pp += blockDim.x) {
        const int f = P.free_pos[pp / 15];
        w.dx[pp] = f < 0 ? 0.0 : w.dxc[15 * f + pp % 15];
      }
      __syncthreads();
      // (6) landmarks: dl = V^-1 (bl - sum W^T dp), the candidate positions; (7) the candidate states
      for (int m = threadIdx.x; m < P.M; m += blockDim.x) {
        double* L = w.lm + (size_t)kLm * m;
        double rhs[3] = {L[9], L[10], L[11]};
        for (int t = P.lm_ptr[m]; t < P.lm_ptr[m + 1]; ++t) {
          const int o = P.lm_obs[t];
          const double* W = w.obs + (size_t)kObs * o + 32;
          const double* dp = w.dx + 15 * P.obs_kf[o];
          for (int cc = 0; cc < 3; ++cc)
            for (int a = 0; a < 6; ++a) rhs[cc] -= W[3 * a + cc] * dp[a];
        }
        const bool upd = L[21] > 0.0 && P.lm_valid[m];
        for (int a = 0; a < 3; ++a) {
          const double dl = upd ? L[12 + 3 * a] * rhs[0] + L[12 + 3 * a + 1] * rhs[1] + L[12 + 3 * a + 2] * rhs[2] : 0.0;
          L[28 + a] = (float)(L[25 + a] + dl);
        }
      }
      for (int k = threadIdx.x; k < K; k += blockDim.x) {
        inr::State S;
        inr::load_state(w.st + 21 * k, S);
        double d[15];
        for (int t = 0; t < 15; ++t) d[t] = w.dx[15 * k + t];
        inr::TState<double> o;
        inr::retract(S, d, o);
        double* cs = w.cand + 21 * k;
        for (int r = 0; r < 3; ++r) {
          for (int cc = 0; cc < 3; ++cc) cs[3 * r + cc] = (float)o.R[r][cc];
          cs[9 + r] = (float)o.p[r];
          cs[12 + r] = (float)o.v[r];
        }
        for (int t = 0; t < 6; ++t) cs[15 + t] = (float)o.b[t];
      }
      __syncthreads();
      // (8) the candidate's cost; (9) accept
      double c1[2] = {obs_pass<kCam>(P, w, w.cand, 28, inlier, true), 0.0};
      for (int e = threadIdx.x; e < P.E; e += blockDim.x) c1[1] += edge_cost(P, w, w.cand, e);
      inr::block_sums(c1, 2, red, sums);
      const bool accept = sums[0] + sums[1] < w.misc[1];
      if (accept) {
        for (int t = threadIdx.x; t < 21 * K; t += blockDim.x) w.st[t] = w.cand[t];
        for (int t = threadIdx.x; t < 3 * P.M; t += blockDim.x) {
          double* L = w.lm + (size_t)kLm * (t / 3);
          L[25 + t % 3] = L[28 + t % 3];
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) w.misc[0] = accept ? fmax(lam * 0.5, 1e-8) : fmin(lam * 5.0, 1e6);
      __syncthreads();
    }
    classify<kCam>(P, w, inlier);
  }
  for (int t = threadIdx.x; t < 21 * K; t += blockDim.x) state_out[t] = (float)w.st[t];
  for (int t = threadIdx.x; t < 3 * P.M; t += blockDim.x) xw_out[t] = (float)w.lm[(size_t)kLm * (t / 3) + 25 + t % 3];
}

}  // namespace

// The scratch: kObs doubles per observation, kLm per landmark, kEdge per edge, the system over the nf free states
// (15 nf) x (15 nf + 1), its solution, the step of every state (15K), two sets of states (21 per state) and 8 more
// (optim/vi_ba.py vi_ba_scratch_doubles).  free_ids: the nf free states in order; free_pos (K): each state's place
// among them, -1 for a fixed one.
extern "C" int vi_ba_launch(const float* cam10, int kind, const float* tcb, int K, int M, int O, int E,
                            const float* R, const float* p, const float* v, const float* b, const uint8_t* fixed,
                            const float* xw, const uint8_t* lm_valid, const int* obs_kf, const int* obs_lm,
                            const float* uv, const float* inv_s2, const uint8_t* is_stereo, const uint8_t* obs_valid,
                            const int* edge_i, const int* edge_j, const uint8_t* edge_valid, const float* pk,
                            const int* lm_ptr, const int* lm_obs, const int* kf_ptr, const int* kf_obs,
                            const int* ke_ptr, const int* ke_edge, const int* free_ids, const int* free_pos, int nf,
                            int iters1, int iters2, double* scratch, float* state_out, float* xw_out,
                            uint8_t* inlier, void* stream) {
  const Prob P = {cam10, tcb, K, M, O, E, R, p, v, b, fixed, xw, lm_valid, obs_kf, obs_lm, uv, inv_s2, is_stereo,
                  obs_valid, edge_i, edge_j, edge_valid, pk, lm_ptr, lm_obs, kf_ptr, kf_obs, ke_ptr, ke_edge,
                  free_ids, free_pos, nf, iters1, iters2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == cam::kKB8)
    vi_ba_kernel<cam::kKB8><<<1, kThreads, 0, st>>>(P, scratch, state_out, xw_out, inlier);
  else if (kind == cam::kRadtan)
    vi_ba_kernel<cam::kRadtan><<<1, kThreads, 0, st>>>(P, scratch, state_out, xw_out, inlier);
  else
    vi_ba_kernel<cam::kPinhole><<<1, kThreads, 0, st>>>(P, scratch, state_out, xw_out, inlier);
  return cudaGetLastError();
}
