// Kernel AA's device code (csrc/vi_pcg.cu, whose head says what it does):
// the problem and scratch layout, the observations' and the chain's passes,
// and each LM step's passes cut where a sum over the observations ends.
// Included by vi_pcg.cu (kernel AA, one CTA for a whole segment) and
// vi_shard.cu (kernel AG, which reduces each sum over the observations
// across the ranks between two launches).  Every loop strides by blockDim,
// and every function that sums over a CSR walks it in its order, so a
// caller that runs these passes in AA's order at AA's width gets AA's bits.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "camera.cuh"
#include "inertial.cuh"

namespace vi_aa {
namespace {

using sim3::Dual;

constexpr int kThreads = 512;
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;
constexpr int kObs = 68;     // r 3 | Jp 18 | Jl 9 | w | rho | W 18 | W V^-1 18
constexpr int kLm = 31;      // Hll 9 | bl 3 | V 9 | w 1 | y 3 | xw 3 | xw candidate 3
constexpr int kEdge = 1932;  // J 15 x 30 | WJ 15 x 30 | r 15 | I9 81 | W6 36 | H 30 x 30
constexpr int kH = 1032;     // the offset of an edge's 30x30 block: H_ii | H_ij over H_ji | H_jj

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
  const uint8_t* inlier;
  int n_iters, cg_iters;
};

// The scratch: per observation, landmark and edge rows; per state vectors of 15 (b, damping, CG x r z p Ap,
// the step), Hpp (36), the block-Jacobi inverse (225), the current and the candidate state (21 each).
struct Work {
  double *obs, *lm, *edge, *b, *damp, *x, *r, *z, *p, *Ap, *dx, *Hpp, *Dinv, *st, *cand, *misc;
};

// misc: lam | the step's starting cost | r.z | the CG iterations run | the chain's cost at the candidate
__device__ inline Work carve(double* s, const Prob& P) {
  Work w;
  const int K = P.K;
  w.obs = s;
  w.lm = w.obs + (size_t)kObs * P.O;
  w.edge = w.lm + (size_t)kLm * P.M;
  double* q = w.edge + (size_t)kEdge * P.E;
  double** vecs[8] = {&w.b, &w.damp, &w.x, &w.r, &w.z, &w.p, &w.Ap, &w.dx};
  for (double** v : vecs) {
    *v = q;
    q += 15 * K;
  }
  w.Hpp = q;
  w.Dinv = w.Hpp + 36 * K;
  w.st = w.Dinv + 225 * K;
  w.cand = w.st + 21 * K;
  w.misc = w.cand + 21 * K;
  return w;
}

// The observation's residual, camera point and d(u, v, u_r)/d(xc) rows at state st (float32, as kernel Y; the
// camera's kind picks the projection, camera.cuh).
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

// Per observation at the states ``st`` and landmark positions (offset ``xoff`` in the landmark rows): this
// thread's share of the robust cost, and unless only_cost the residual, Jacobians, weight and W = Jp^T w Jl.
template <int kCam>
__device__ double obs_pass(const Prob& P, const Work& w, const double* st, int xoff, bool only_cost) {
  double cost = 0.0;
  for (int o = threadIdx.x; o < P.O; o += blockDim.x) {
    const int k = P.obs_kf[o], m = P.obs_lm[o];
    float r[3], xc[3], A[3][3], y[3];
    project<kCam>(P, o, st + 21 * k, w.lm + (size_t)kLm * m + xoff, r, xc, A, y);
    const float s2 = P.inv_s2[o];
    const float chi2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * s2;
    const float delta2 = P.is_stereo[o] ? kChi2Stereo : kChi2Mono;
    const bool active = P.obs_valid[o] && P.inlier[o] && xc[2] > 0.05f && P.lm_valid[m];
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

// The valid inertial edges at states st: Jacobian columns (thread per edge x direction; a fixed state's
// columns zero), residuals, WJ = information x J, and each edge's 30x30 block J^T WJ.
__device__ inline void edge_pass(const Prob& P, const Work& w, const double* st) {
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
      for (int c = 0; c < 9; ++c) s += ed[915 + 9 * row + c] * ed[30 * c + col];
    } else {
      for (int c = 0; c < 6; ++c) s += ed[996 + 6 * (row - 9) + c] * ed[30 * (9 + c) + col];
    }
    ed[450 + 30 * row + col] = s;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < P.E * 900; t += blockDim.x) {
    const int e = t / 900, pp = (t % 900) / 30, q = t % 30;
    double* ed = w.edge + (size_t)kEdge * e;
    double s = 0.0;
    if (P.edge_valid[e])
      for (int row = 0; row < 15; ++row) s += ed[30 * row + pp] * ed[450 + 30 * row + q];
    ed[kH + 30 * pp + q] = s;
  }
  __syncthreads();
}

// This thread's share of the chain's cost from the residuals edge_pass left: ev * (r9^T I9 r9 + rb^T W6 rb).
__device__ inline double chain_cost(const Prob& P, const Work& w) {
  double c = 0.0;
  for (int e = threadIdx.x; e < P.E; e += blockDim.x) {
    if (!P.edge_valid[e]) continue;
    const double* ed = w.edge + (size_t)kEdge * e;
    double s = 0.0;
    for (int p = 0; p < 9; ++p)
      for (int q = 0; q < 9; ++q) s += ed[900 + p] * ed[915 + 9 * p + q] * ed[900 + q];
    for (int p = 0; p < 6; ++p)
      for (int q = 0; q < 6; ++q) s += ed[909 + p] * ed[996 + 6 * p + q] * ed[909 + q];
    c += s;
  }
  return c;
}

// ev * (r9^T I9 r9 + rb^T W6 rb) of edge e at states st.
__device__ inline double edge_cost(const Prob& P, const Work& w, const double* st, int e) {
  if (!P.edge_valid[e]) return 0.0;
  inr::State Si, Sj;
  inr::load_state(st + 21 * P.edge_i[e], Si);
  inr::load_state(st + 21 * P.edge_j[e], Sj);
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

// (0) the segment's start: the state and landmarks from the inputs, each edge's informations, the damping.
__device__ inline void load(const Prob& P, const Work& w, float lam) {
  const int K = P.K;
  for (int t = threadIdx.x; t < 21 * K; t += blockDim.x) {
    const int k = t / 21, f = t % 21;
    w.st[t] = f < 9 ? P.R[9 * k + f] : (f < 12 ? P.p[3 * k + f - 9] : (f < 15 ? P.v[3 * k + f - 12] : P.b[6 * k + f - 15]));
  }
  for (int t = threadIdx.x; t < 3 * P.M; t += blockDim.x) w.lm[(size_t)kLm * (t / 3) + 25 + t % 3] = P.xw[t];
  for (int e = threadIdx.x; e < P.E; e += blockDim.x) {
    double I9[9][9], W6[6][6];
    inr::informations(P.pk + inr::kPacked * e, I9, W6);
    double* ed = w.edge + (size_t)kEdge * e;
    for (int t = 0; t < 81; ++t) ed[915 + t] = I9[t / 9][t % 9];
    for (int t = 0; t < 36; ++t) ed[996 + t] = W6[t / 6][t % 6];
  }
  if (threadIdx.x == 0) w.misc[0] = lam, w.misc[1] = 0.0, w.misc[3] = 0.0;
  __syncthreads();
}

// (2) landmark m's sums over its observations in CSR order: Hll, bl and w.
__device__ inline void landmark_sums(const Prob& P, const Work& w, int m, double (&H)[3][3], double (&bl)[3],
                                     double& wl) {
  for (int t = P.lm_ptr[m]; t < P.lm_ptr[m + 1]; ++t) {
    const double* ob = w.obs + (size_t)kObs * P.lm_obs[t];
    const double wt = ob[30];
    for (int q = 0; q < 3; ++q)
      for (int a = 0; a < 3; ++a) {
        bl[a] -= ob[21 + 3 * q + a] * wt * ob[q];
        for (int bb = 0; bb < 3; ++bb) H[a][bb] += ob[21 + 3 * q + a] * wt * ob[21 + 3 * q + bb];
      }
    wl += wt;
  }
}

// (2) landmark m from its sums: its row, the damped inverse V^-1 and y = V^-1 bl.
__device__ inline void landmark_finish(const Work& w, int m, double (&H)[3][3], const double (&bl)[3], double wl,
                                       double lam) {
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
  for (int a = 0; a < 3; ++a) L[22 + a] = V[a][0] * bl[0] + V[a][1] * bl[1] + V[a][2] * bl[2];
}

// per observation: W V^-1
__device__ inline void obs_wv(const Prob& P, const Work& w) {
  for (int o = threadIdx.x; o < P.O; o += blockDim.x) {
    double* ob = w.obs + (size_t)kObs * o;
    const double* V = w.lm + (size_t)kLm * P.obs_lm[o] + 12;
    for (int a = 0; a < 6; ++a)
      for (int cc = 0; cc < 3; ++cc)
        ob[50 + 3 * a + cc] = ob[32 + 3 * a] * V[cc] + ob[32 + 3 * a + 1] * V[3 + cc] + ob[32 + 3 * a + 2] * V[6 + cc];
  }
  __syncthreads();
}

// (3) state k's sums over its observations (state CSR): Hpp and the gradient's pose slots (from g).
__device__ inline void state_obs_sums(const Prob& P, const Work& w, int k, double (&Hpp)[6][6], double (&g)[15]) {
  for (int tt = P.kf_ptr[k]; tt < P.kf_ptr[k + 1]; ++tt) {
    const int o = P.kf_obs[tt];
    const double* ob = w.obs + (size_t)kObs * o;
    for (int a = 0; a < 6; ++a) {
      for (int q = 0; q < 3; ++q) g[a] -= ob[3 + 6 * q + a] * ob[30] * ob[q];
      for (int bb = 0; bb < 6; ++bb)
        for (int q = 0; q < 3; ++q) Hpp[a][bb] += ob[3 + 6 * q + a] * ob[30] * ob[3 + 6 * q + bb];
    }
  }
}

// (3) state k's chain terms over its edges, then Hpp stored and added, the damping from the undamped diagonal
// of Hpp and the chain.
__device__ inline void state_chain(const Prob& P, const Work& w, int k, const double (&Hpp)[6][6], double (&g)[15],
                                   double (&D)[15][15], double lam) {
  for (int te = P.ke_ptr[k]; te < P.ke_ptr[k + 1]; ++te) {
    const int e = P.ke_edge[te];
    const int side = k == P.edge_i[e] ? 0 : 15;
    const double* ed = w.edge + (size_t)kEdge * e;
    for (int a = 0; a < 15; ++a) {
      for (int row = 0; row < 15; ++row) g[a] -= ed[450 + 30 * row + side + a] * ed[900 + row];
      for (int bb = 0; bb < 15; ++bb) D[a][bb] += ed[kH + 30 * (side + a) + side + bb];
    }
  }
  for (int a = 0; a < 6; ++a)
    for (int bb = 0; bb < 6; ++bb) {
      w.Hpp[36 * k + 6 * a + bb] = Hpp[a][bb];
      D[a][bb] += Hpp[a][bb];
    }
  for (int a = 0; a < 15; ++a) {
    const double dmp = lam * fmax(D[a][a], 1e-3);
    w.damp[15 * k + a] = dmp;
    D[a][a] += dmp;
  }
}

// (3) state k's coupling over its observations: corr += sum W y (y: the landmarks' V^-1 bl) and D's pose block
// -= sum W V^-1 W^T, one observation after another.
__device__ inline void state_coupling(const Prob& P, const Work& w, int k, double (&corr)[6], double (&D)[15][15]) {
  for (int tt = P.kf_ptr[k]; tt < P.kf_ptr[k + 1]; ++tt) {
    const int o = P.kf_obs[tt];
    const double* ob = w.obs + (size_t)kObs * o;
    const double* y = w.lm + (size_t)kLm * P.obs_lm[o] + 22;
    for (int a = 0; a < 6; ++a) {
      corr[a] += ob[32 + 3 * a] * y[0] + ob[32 + 3 * a + 1] * y[1] + ob[32 + 3 * a + 2] * y[2];
      for (int bb = 0; bb < 6; ++bb)
        D[a][bb] -= ob[50 + 3 * a] * ob[32 + 3 * bb] + ob[50 + 3 * a + 1] * ob[32 + 3 * bb + 1] +
                    ob[50 + 3 * a + 2] * ob[32 + 3 * bb + 2];
    }
  }
}

// (3) state k's end: the right side b_s = (b - Z V^-1 bl) on the free states, the block-Jacobi inverse, and CG's
// start x = 0, r = b_s, z = p = D^-1 r; this thread's share of r.z into part.
__device__ inline void state_finish(const Prob& P, const Work& w, int k, double (&g)[15], const double (&corr)[6],
                                    double (&D)[15][15], double& part) {
  double Di[15][15];
  const bool fixed = P.fixed[k];
  for (int a = 0; a < 15; ++a) {
    if (a < 6) g[a] -= corr[a];
    for (int bb = 0; bb < 15; ++bb) D[a][bb] = fixed ? (a == bb ? 1.0 : 0.0) : D[a][bb];
    D[a][a] += 1e-5;
  }
  inr::invert(D, Di);
  for (int a = 0; a < 15; ++a) {
    for (int bb = 0; bb < 15; ++bb) w.Dinv[225 * k + 15 * a + bb] = Di[a][bb];
    const double ra = fixed ? 0.0 : g[a];
    w.b[15 * k + a] = ra;
    w.r[15 * k + a] = ra;
    w.x[15 * k + a] = 0.0;
  }
  for (int a = 0; a < 15; ++a) {
    double za = 0.0;
    if (!fixed)
      for (int bb = 0; bb < 15; ++bb) za += Di[a][bb] * w.r[15 * k + bb];
    w.z[15 * k + a] = za;
    w.p[15 * k + a] = za;
    part += w.r[15 * k + a] * za;
  }
}

// Row (k, a) of the chain's blocks times v: each of the state's edges in order (H_ii v_i + H_ij v_j at its i
// end, H_jj v_j + H_ij^T v_i at its j end).
__device__ inline double chain_row(const Prob& P, const Work& w, int k, int a, const double* v) {
  double out = 0.0;
  for (int te = P.ke_ptr[k]; te < P.ke_ptr[k + 1]; ++te) {
    const int e = P.ke_edge[te], ei = P.edge_i[e], ej = P.edge_j[e];
    const double* H = w.edge + (size_t)kEdge * e + kH;
    const double* vi = v + 15 * ei;
    const double* vj = v + 15 * ej;
    double t1 = 0.0, t2 = 0.0;
    if (k == ei) {
      for (int c = 0; c < 15; ++c) t1 += H[30 * a + c] * vi[c];
      for (int c = 0; c < 15; ++c) t2 += H[30 * a + 15 + c] * vj[c];
    } else {
      for (int c = 0; c < 15; ++c) t1 += H[30 * (15 + a) + 15 + c] * vj[c];
      for (int c = 0; c < 15; ++c) t2 += H[30 * c + 15 + a] * vi[c];
    }
    out += t1 + t2;
  }
  return out;
}

// Row (k, a < 6) of Z y: sum over the state's observations (state CSR) of W y, y in the landmark rows.
__device__ inline double state_zy(const Prob& P, const Work& w, int k, int a) {
  double zy = 0.0;
  for (int tt = P.kf_ptr[k]; tt < P.kf_ptr[k + 1]; ++tt) {
    const int o = P.kf_obs[tt];
    const double* W = w.obs + (size_t)kObs * o + 32 + 3 * a;
    const double* y = w.lm + (size_t)kLm * P.obs_lm[o] + 22;
    zy += W[0] * y[0] + W[1] * y[1] + W[2] * y[2];
  }
  return zy;
}

// Row (k, a) of the Schur operator applied to v (v zero at fixed states): damping, Hpp, the chain, - Z y; Z y's
// row from the landmark rows (state_zy), or with kReduced from zy (K,6), the rows summed over the ranks.
template <bool kReduced>
__device__ double op_row(const Prob& P, const Work& w, int k, int a, const double* v, const double* zy) {
  double out = w.damp[15 * k + a] * v[15 * k + a];
  if (a < 6) {
    double h = 0.0;
    for (int c = 0; c < 6; ++c) h += w.Hpp[36 * k + 6 * a + c] * v[15 * k + c];
    out += h;
  }
  out += chain_row(P, w, k, a, v);
  if (a < 6) out -= kReduced ? zy[6 * k + a] : state_zy(P, w, k, a);
  return out;
}

// u_m = sum_o W_o^T v6_(kf o) over landmark m's observations in CSR order (v6: the first 6 slots of v).
__device__ inline void landmark_u(const Prob& P, const Work& w, int m, const double* v, double (&u)[3]) {
  for (int t = P.lm_ptr[m]; t < P.lm_ptr[m + 1]; ++t) {
    const int o = P.lm_obs[t];
    const double* W = w.obs + (size_t)kObs * o + 32;
    const double* vk = v + 15 * P.obs_kf[o];
    for (int c = 0; c < 3; ++c)
      for (int a = 0; a < 6; ++a) u[c] += W[3 * a + c] * vk[a];
  }
}

// y_m = V_m^-1 u_m into landmark m's row.
__device__ inline void landmark_apply(const Work& w, int m, const double (&u)[3]) {
  double* L = w.lm + (size_t)kLm * m;
  for (int a = 0; a < 3; ++a) L[22 + a] = L[12 + 3 * a] * u[0] + L[12 + 3 * a + 1] * u[1] + L[12 + 3 * a + 2] * u[2];
}

// One CG iteration on the operator (op_row<kReduced>) at p: Ap, alpha, x, r, z, beta, p; the dot products as
// fixed-order block sums; rz in and out.
template <bool kReduced>
__device__ void cg_iteration(const Prob& P, const Work& w, const double* zy, double& rz, double* red, double* sums) {
  const int n = 15 * P.K;
  double part = 0.0;
  for (int row = threadIdx.x; row < n; row += blockDim.x) {
    const int k = row / 15;
    const double h = P.fixed[k] ? 0.0 : op_row<kReduced>(P, w, k, row % 15, w.p, zy);
    w.Ap[row] = h;
    part += w.p[row] * h;
  }
  const double pAp = (inr::block_sums(&part, 1, red, sums), sums[0]);
  const double alpha = rz / fmax(pAp, 1e-20);
  for (int row = threadIdx.x; row < n; row += blockDim.x) {
    w.x[row] += alpha * w.p[row];
    w.r[row] -= alpha * w.Ap[row];
  }
  __syncthreads();
  part = 0.0;
  for (int row = threadIdx.x; row < n; row += blockDim.x) {
    const int k = row / 15, a = row % 15;
    double zr = 0.0;
    if (!P.fixed[k])
      for (int bb = 0; bb < 15; ++bb) zr += w.Dinv[225 * k + 15 * a + bb] * w.r[15 * k + bb];
    w.z[row] = zr;
    part += w.r[row] * zr;
  }
  const double rz_new = (inr::block_sums(&part, 1, red, sums), sums[0]);
  const double beta = rz_new / fmax(rz, 1e-20);
  for (int row = threadIdx.x; row < n; row += blockDim.x) w.p[row] = w.z[row] + beta * w.p[row];
  __syncthreads();
  rz = rz_new;
}

// (5) the step on the free states: dx = x.
__device__ inline void take_step(const Prob& P, const Work& w) {
  for (int row = threadIdx.x; row < 15 * P.K; row += blockDim.x) w.dx[row] = P.fixed[row / 15] ? 0.0 : w.x[row];
  __syncthreads();
}

// (5) landmark m's back-substitution right side: rhs -= sum W^T dx6 over its observations in CSR order.
__device__ inline void landmark_rhs(const Prob& P, const Work& w, int m, double (&rhs)[3]) {
  for (int t = P.lm_ptr[m]; t < P.lm_ptr[m + 1]; ++t) {
    const int o = P.lm_obs[t];
    const double* W = w.obs + (size_t)kObs * o + 32;
    const double* dp = w.dx + 15 * P.obs_kf[o];
    for (int cc = 0; cc < 3; ++cc)
      for (int a = 0; a < 6; ++a) rhs[cc] -= W[3 * a + cc] * dp[a];
  }
}

// (5) landmark m's candidate position: dl = V^-1 rhs where seen and valid.
__device__ inline void landmark_candidate(const Prob& P, const Work& w, int m, const double (&rhs)[3]) {
  double* L = w.lm + (size_t)kLm * m;
  const bool upd = L[21] > 0.0 && P.lm_valid[m];
  for (int a = 0; a < 3; ++a) {
    const double dl = upd ? L[12 + 3 * a] * rhs[0] + L[12 + 3 * a + 1] * rhs[1] + L[12 + 3 * a + 2] * rhs[2] : 0.0;
    L[28 + a] = (float)(L[25 + a] + (float)dl);
  }
}

// (5) every state's candidate: the float64 retraction of the float32 step, stored in float32.
__device__ inline void state_candidates(const Prob& P, const Work& w) {
  for (int k = threadIdx.x; k < P.K; k += blockDim.x) {
    inr::State S;
    inr::load_state(w.st + 21 * k, S);
    double d[15];
    for (int t = 0; t < 15; ++t) d[t] = (float)w.dx[15 * k + t];
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
}

// This thread's share of the chain's cost at the candidate.
__device__ inline double chain_cost_at_candidate(const Prob& P, const Work& w) {
  double c = 0.0;
  for (int e = threadIdx.x; e < P.E; e += blockDim.x) c += edge_cost(P, w, w.cand, e);
  return c;
}

// (6) the accept (candidate cost below the step's starting cost) and the damping.
__device__ inline void commit(const Prob& P, const Work& w, bool accept) {
  const double lam = w.misc[0];
  if (accept) {
    for (int t = threadIdx.x; t < 21 * P.K; t += blockDim.x) w.st[t] = w.cand[t];
    for (int t = threadIdx.x; t < 3 * P.M; t += blockDim.x) {
      double* L = w.lm + (size_t)kLm * (t / 3);
      L[25 + t % 3] = L[28 + t % 3];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) w.misc[0] = accept ? fmax(lam * 0.5, 1e-8) : fmin(lam * 5.0, 1e6);
  __syncthreads();
}

// The segment's end: the state, the landmarks, and (damping, the last step's starting cost, CG iterations run).
__device__ inline void store(const Prob& P, const Work& w, float* lam_io, float* state_out, float* xw_out) {
  for (int t = threadIdx.x; t < 21 * P.K; t += blockDim.x) state_out[t] = (float)w.st[t];
  for (int t = threadIdx.x; t < 3 * P.M; t += blockDim.x) xw_out[t] = (float)w.lm[(size_t)kLm * (t / 3) + 25 + t % 3];
  if (threadIdx.x == 0) lam_io[0] = (float)w.misc[0], lam_io[1] = (float)w.misc[1], lam_io[2] = (float)w.misc[3];
}

// classify_vi: obs_valid & chi2 <= delta2 & in front, one thread per observation, at the input state.
template <int kCam>
__global__ void classify_kernel(Prob P, uint8_t* inlier) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= P.O) return;
  const int k = P.obs_kf[o], m = P.obs_lm[o];
  double st[21] = {}, xw[3];
  for (int f = 0; f < 9; ++f) st[f] = P.R[9 * k + f];
  for (int f = 0; f < 3; ++f) st[9 + f] = P.p[3 * k + f], xw[f] = P.xw[3 * m + f];
  float r[3], xc[3], A[3][3], y[3];
  project<kCam>(P, o, st, xw, r, xc, A, y);
  const float chi2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * P.inv_s2[o];
  inlier[o] = P.obs_valid[o] && chi2 <= (P.is_stereo[o] ? kChi2Stereo : kChi2Mono) && xc[2] > 0.05f;
}

}  // namespace
}  // namespace vi_aa
