// The inertial factors on the device, for kernels W (pose_inertial.cu), X
// (imu_init.cu) and Y (vi_ba.cu): the preintegrated window's deltas with
// first-order bias correction (imu/preintegration.py delta_*), the body-state
// retraction (R <- R Exp(dtheta), p <- p + R dp), the 9-D inertial residual,
// the bias walk, the 15-D prior and EdgeInertialGS (optim/inertial.py,
// optim/imu_init.py), written once over a scalar type T: double, or
// sim3::Dual, a float64 forward-mode dual number, so that a thread
// evaluating along tangent k gets column k of the Jacobian that jax.jacfwd
// and torch.func.jacfwd give.  Also: the informations of a window (inverses
// of its covariance blocks), a small Gauss-Jordan inverse, the Gaussian
// elimination with partial pivoting that the whole block runs (the
// counterpart of jnp.linalg.solve / torch.linalg.solve), and fixed-order
// block sums.  The CPU tests compile this header for the host.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include "sim3.cuh"

namespace inr {

using sim3::Dual;

constexpr double kGravity = 9.81;  // ImuTypes.h:42
constexpr int kPacked = 292;       // imu/preintegration.py PACKED
// offsets in a packed Preintegrated: dT | dR | dV | dP | C | JRg JVg JVa JPg JPa | bias
constexpr int kOffR = 1, kOffV = 10, kOffP = 13, kOffC = 16, kOffJ = 241, kOffBias = 286;

// The deltas of a window and their bias Jacobians (C stays packed).
struct Delta {
  double dT, dR[3][3], dV[3], dP[3], J[5][3][3], bias[6];  // J: JRg JVg JVa JPg JPa
};

__device__ inline void load_delta(const float* pk, Delta& d) {
  d.dT = pk[0];
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) {
      d.dR[r][c] = pk[kOffR + 3 * r + c];
      for (int k = 0; k < 5; ++k) d.J[k][r][c] = pk[kOffJ + 9 * k + 3 * r + c];
    }
    d.dV[r] = pk[kOffV + r];
    d.dP[r] = pk[kOffP + r];
  }
  for (int k = 0; k < 6; ++k) d.bias[k] = pk[kOffBias + k];
}

// A body state R (9, row-major) | p | v | bias (6).
struct State {
  double R[3][3], p[3], v[3], b[6];
};

__device__ inline void load_state(const float* s, State& st) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) st.R[r][c] = s[3 * r + c];
  for (int k = 0; k < 3; ++k) st.p[k] = s[9 + k], st.v[k] = s[12 + k];
  for (int k = 0; k < 6; ++k) st.b[k] = s[15 + k];
}

__device__ inline void load_state(const double* s, State& st) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) st.R[r][c] = s[3 * r + c];
  for (int k = 0; k < 3; ++k) st.p[k] = s[9 + k], st.v[k] = s[12 + k];
  for (int k = 0; k < 6; ++k) st.b[k] = s[15 + k];
}

template <class T>
struct TState {
  T R[3][3], p[3], v[3], b[6];
};

// retract(s, d): R Exp(d[0:3]), p + R d[3:6], v + d[6:9], bias + d[9:15].
template <class T>
__device__ void retract(const State& s, const T (&d)[15], TState<T>& o) {
  const T w[3] = {d[0], d[1], d[2]};
  T E[3][3];
  sim3::so3_exp(w, E);
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) o.R[r][c] = s.R[r][0] * E[0][c] + s.R[r][1] * E[1][c] + s.R[r][2] * E[2][c];
    o.p[r] = s.p[r] + (s.R[r][0] * d[3] + s.R[r][1] * d[4] + s.R[r][2] * d[5]);
    o.v[r] = s.v[r] + d[6 + r];
  }
  for (int k = 0; k < 6; ++k) o.b[k] = s.b[k] + d[9 + k];
}

// Bias-corrected dR, dV, dP at ``bias`` (imu/preintegration.py delta_*; no SVD).
template <class T>
__device__ void deltas(const Delta& p, const T (&bias)[6], T (&dR)[3][3], T (&dV)[3], T (&dP)[3]) {
  T dbg[3], dba[3];
  for (int k = 0; k < 3; ++k) dbg[k] = bias[k] - p.bias[k], dba[k] = bias[3 + k] - p.bias[3 + k];
  T w[3];
  for (int r = 0; r < 3; ++r) w[r] = p.J[0][r][0] * dbg[0] + p.J[0][r][1] * dbg[1] + p.J[0][r][2] * dbg[2];
  T E[3][3];
  sim3::so3_exp(w, E);
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) dR[r][c] = p.dR[r][0] * E[0][c] + p.dR[r][1] * E[1][c] + p.dR[r][2] * E[2][c];
    const T vg = p.J[1][r][0] * dbg[0] + p.J[1][r][1] * dbg[1] + p.J[1][r][2] * dbg[2];
    const T va = p.J[2][r][0] * dba[0] + p.J[2][r][1] * dba[1] + p.J[2][r][2] * dba[2];
    const T pg = p.J[3][r][0] * dbg[0] + p.J[3][r][1] * dbg[1] + p.J[3][r][2] * dbg[2];
    const T pa = p.J[4][r][0] * dba[0] + p.J[4][r][1] * dba[1] + p.J[4][r][2] * dba[2];
    dV[r] = (p.dV[r] + vg) + va;
    dP[r] = (p.dP[r] + pg) + pa;
  }
}

// so3_log(A^T B C) for 3x3 A, B, C given as A (T), B (T), C (T).
template <class T>
__device__ void log_atbc(const T (&A)[3][3], const T (&B)[3][3], const T (&C)[3][3], T (&w)[3]) {
  T M[3][3], N[3][3];
  for (int r = 0; r < 3; ++r)  // M = A^T B^T
    for (int c = 0; c < 3; ++c) M[r][c] = A[0][r] * B[c][0] + A[1][r] * B[c][1] + A[2][r] * B[c][2];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) N[r][c] = M[r][0] * C[0][c] + M[r][1] * C[1][c] + M[r][2] * C[2][c];
  sim3::so3_log(N, w);
}

// The 9-D inertial residual [er, ev, ep] (optim/inertial.py inertial_residual)
// and, in r[9:15], the bias walk bias_j - bias_i.
template <class T>
__device__ void inertial_factors(const TState<T>& si, const TState<T>& sj, const Delta& p, T (&r)[15]) {
  T dR[3][3], dV[3], dP[3];
  deltas(p, si.b, dR, dV, dP);
  T RiT[3][3];
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c) RiT[a][c] = si.R[c][a];
  T er[3];
  log_atbc(dR, si.R, sj.R, er);  // log(dR^T Ri^T Rj): (Ri^T)^T = Ri
  const double dt = p.dT;
  const double g[3] = {0.0, 0.0, -kGravity};
  T a[3], b[3];
  for (int k = 0; k < 3; ++k) {
    a[k] = sj.v[k] - si.v[k] - g[k] * dt;
    b[k] = sj.p[k] - si.p[k] - si.v[k] * dt - 0.5 * g[k] * dt * dt;
  }
  for (int k = 0; k < 3; ++k) {
    r[k] = er[k];
    r[3 + k] = (RiT[k][0] * a[0] + RiT[k][1] * a[1] + RiT[k][2] * a[2]) - dV[k];
    r[6 + k] = (RiT[k][0] * b[0] + RiT[k][1] * b[1] + RiT[k][2] * b[2]) - dP[k];
  }
  for (int k = 0; k < 6; ++k) r[9 + k] = sj.b[k] - si.b[k];
}

// The 15-D prior residual [log(Rp^T R), p - pp, v - vp, b - bp].
template <class T>
__device__ void prior_factor(const TState<T>& s, const State& pr, T (&r)[15]) {
  T M[3][3];
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c) M[a][c] = pr.R[0][a] * s.R[0][c] + pr.R[1][a] * s.R[1][c] + pr.R[2][a] * s.R[2][c];
  T w[3];
  sim3::so3_log(M, w);
  for (int k = 0; k < 3; ++k) {
    r[k] = w[k];
    r[3 + k] = s.p[k] - pr.p[k];
    r[6 + k] = s.v[k] - pr.v[k];
  }
  for (int k = 0; k < 6; ++k) r[9 + k] = s.b[k] - pr.b[k];
}

// EdgeInertialGS (optim/imu_init.py gs_residual): poses fixed (double),
// velocities, bias, gravity direction theta (x, y) and log-scale in T.
template <class T>
__device__ void gs_residual(const double (&Ri)[3][3], const double (&pi)[3], const double (&Rj)[3][3],
                            const double (&pj)[3], const T (&vi)[3], const T (&vj)[3], const T (&bias)[6],
                            const T (&theta)[2], T log_s, bool scale_known, const Delta& p, T (&r)[9]) {
  const T s = scale_known ? sim3::cst(1.0, log_s) : sim3::Exp(log_s);
  const T w[3] = {theta[0], theta[1], sim3::cst(0.0, log_s)};
  T Rwg[3][3];
  sim3::so3_exp(w, Rwg);
  T g[3];
  for (int k = 0; k < 3; ++k) g[k] = Rwg[k][2] * (-kGravity);
  T dR[3][3], dV[3], dP[3];
  deltas(p, bias, dR, dV, dP);
  T M[3][3], N[3][3];
  for (int a = 0; a < 3; ++a)  // M = dR^T Ri^T
    for (int c = 0; c < 3; ++c) M[a][c] = dR[0][a] * Ri[c][0] + dR[1][a] * Ri[c][1] + dR[2][a] * Ri[c][2];
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c) N[a][c] = M[a][0] * Rj[0][c] + M[a][1] * Rj[1][c] + M[a][2] * Rj[2][c];
  T er[3];
  sim3::so3_log(N, er);
  const double dt = p.dT;
  T a[3], b[3];
  for (int k = 0; k < 3; ++k) {
    a[k] = s * (vj[k] - vi[k]) - g[k] * dt;
    b[k] = s * ((pj[k] - pi[k]) - vi[k] * dt) - 0.5 * g[k] * dt * dt;
  }
  for (int k = 0; k < 3; ++k) {
    r[k] = er[k];
    r[3 + k] = (Ri[0][k] * a[0] + Ri[1][k] * a[1] + Ri[2][k] * a[2]) - dV[k];
    r[6 + k] = (Ri[0][k] * b[0] + Ri[1][k] * b[1] + Ri[2][k] * b[2]) - dP[k];
  }
}

// Inverse of an N x N matrix by Gauss-Jordan with partial pivoting, one
// thread, float64 (jnp.linalg.inv of a small block).
template <int N>
__device__ void invert(double (&A)[N][N], double (&Ai)[N][N]) {
  for (int r = 0; r < N; ++r)
    for (int c = 0; c < N; ++c) Ai[r][c] = r == c ? 1.0 : 0.0;
  for (int k = 0; k < N; ++k) {
    int p = k;
    for (int i = k + 1; i < N; ++i)
      if (fabs(A[i][k]) > fabs(A[p][k])) p = i;
    if (p != k)
      for (int c = 0; c < N; ++c) {
        double t = A[k][c];
        A[k][c] = A[p][c], A[p][c] = t;
        t = Ai[k][c];
        Ai[k][c] = Ai[p][c], Ai[p][c] = t;
      }
    const double inv = 1.0 / A[k][k];
    for (int c = 0; c < N; ++c) A[k][c] *= inv, Ai[k][c] *= inv;
    for (int i = 0; i < N; ++i) {
      if (i == k) continue;
      const double f = A[i][k];
      for (int c = 0; c < N; ++c) A[i][c] -= f * A[k][c], Ai[i][c] -= f * Ai[k][c];
    }
  }
}

// The inertial information inv(0.5 (C9 + C9^T) + 1e-9 I) and the walk's
// inv(C[9:15, 9:15] + 1e-8 I) of a packed window (optim/inertial.py).
__device__ inline void informations(const float* pk, double (&I9)[9][9], double (&W6)[6][6]) {
  const float* C = pk + kOffC;
  double A[9][9];
  for (int r = 0; r < 9; ++r)
    for (int c = 0; c < 9; ++c) A[r][c] = 0.5 * ((double)C[15 * r + c] + (double)C[15 * c + r]) + (r == c ? 1e-9 : 0.0);
  invert(A, I9);
  double B[6][6];
  for (int r = 0; r < 6; ++r)
    for (int c = 0; c < 6; ++c) B[r][c] = (double)C[15 * (9 + r) + 9 + c] + (r == c ? 1e-8 : 0.0);
  invert(B, W6);
}

// The pivot row of column k of the n x n system A (row stride ld), into
// *piv: the first row i >= k with the largest |A[i][k]| (k itself when
// A[k][k] is NaN), the row a sequential scan picks.  The first warp scans
// rows in strides of 32 and reduces (value, row) by shuffles, the larger
// value and on a tie the lower row winning; then the block synchronises.
// Every thread of the block must call it.
__device__ inline void pivot_row(const double* A, int n, int ld, int k, int* piv) {
  if (threadIdx.x < 32) {
    double best = -1.0;
    int bi = n;
    for (int i = k + (int)threadIdx.x; i < n; i += 32) {
      const double v = fabs(A[i * ld + k]);
      if (v > best) best = v, bi = i;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const double ov = __shfl_down_sync(0xFFFFFFFFu, best, o);
      const int oi = __shfl_down_sync(0xFFFFFFFFu, bi, o);
      if (ov > best || (ov == best && oi < bi)) best = ov, bi = oi;
    }
    if (threadIdx.x == 0) *piv = isnan(A[k * ld + k]) || bi >= n ? k : bi;
  }
  __syncthreads();
}

// Solve A x = B for the n x n system in the first n columns of A (row
// stride ld) and the m right sides in its columns n .. n + m - 1: Gaussian
// elimination with partial pivoting (pivot_row), the row updates shared
// by the whole block, the back-substitution one thread per right side; x
// is n x m, row-major.  A may lie in shared or global memory.  Every
// thread of the block must call it.  ``piv`` is one int of shared memory.
__device__ inline void block_solve(double* A, int n, int m, int ld, double* x, int* piv) {
  for (int k = 0; k < n; ++k) {
    pivot_row(A, n, ld, k, piv);
    const int p = *piv;
    if (p != k)
      for (int j = threadIdx.x; j < n + m; j += blockDim.x) {
        const double t = A[k * ld + j];
        A[k * ld + j] = A[p * ld + j];
        A[p * ld + j] = t;
      }
    __syncthreads();
    const double inv = 1.0 / A[k * ld + k];
    for (int i = k + 1 + threadIdx.x; i < n; i += blockDim.x) A[i * ld + k] *= inv;
    __syncthreads();
    const int rows = n - k - 1, cols = n + m - k - 1;
    for (int t = threadIdx.x; t < rows * cols; t += blockDim.x) {
      const int i = k + 1 + t / cols, j = k + 1 + t % cols;
      A[i * ld + j] -= A[i * ld + k] * A[k * ld + j];
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < m; c += blockDim.x)
    for (int i = n - 1; i >= 0; --i) {
      double s = A[i * ld + n + c];
      for (int j = i + 1; j < n; ++j) s -= A[i * ld + j] * x[j * m + c];
      x[i * m + c] = s / A[i * ld + i];
    }
  __syncthreads();
}

// Sums of nv values per thread over the block, in a fixed order (a shuffle
// tree in each warp, then the warps in turn); the sums land in out[0..nv).
// sh holds 32 * nv doubles; every thread must call it.
__device__ inline void block_sums(double* vals, int nv, double* sh, double* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = (blockDim.x + 31) >> 5;
  for (int v = 0; v < nv; ++v) {
    double x = vals[v];
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xFFFFFFFFu, x, o);
    if (lane == 0) sh[warp * nv + v] = x;
  }
  __syncthreads();
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    double s = 0.0;
    for (int w = 0; w < n_warps; ++w) s += sh[w * nv + v];
    out[v] = s;
  }
  __syncthreads();
}

// The body pose's camera: R_cw = R_cb R_wb^T, t_cw = R_cb (-R_wb^T p) + t_cb.
__device__ inline void camera_of(const float* tcb, const double (&R)[3][3], const double (&p)[3], double (&Rcw)[3][3],
                                 double (&tcw)[3]) {
  double tbw[3];
  for (int a = 0; a < 3; ++a) tbw[a] = -(R[0][a] * p[0] + R[1][a] * p[1] + R[2][a] * p[2]);
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c)
      Rcw[r][c] = tcb[3 * r] * R[c][0] + tcb[3 * r + 1] * R[c][1] + tcb[3 * r + 2] * R[c][2];
    tcw[r] = tcb[3 * r] * tbw[0] + tcb[3 * r + 1] * tbw[1] + tcb[3 * r + 2] * tbw[2] + tcb[9 + r];
  }
}

}  // namespace inr
