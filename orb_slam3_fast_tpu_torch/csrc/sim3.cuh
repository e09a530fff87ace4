// Sim(3) on the device, for kernels R (sim3_refine.cu) and S
// (sim3_graph.cu): the exponential and logarithm of utils/lie.py with the
// same branches (the Taylor terms of so3_exp below theta^2 = 1e-8, the four
// branches of _sim3_W_coeffs split at 0.05, the quaternion logarithm with
// its first-maximum pivot), written once over a scalar type T: double, or
// Dual, a float64 forward-mode dual number (value and one tangent) that
// carries a derivative through the branch its value selects, as jax.jacfwd
// and torch.func.jvp do; and kernel S's edge evaluation (``edge_lane``),
// which the CPU tests compile on the host and hold against jax.jacfwd.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include "jacobi.cuh"

namespace sim3 {

struct Dual {
  double v, d;
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) { return {a.v * b.v, a.d * b.v + a.v * b.d}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  return {a.v / b.v, (a.d * b.v - a.v * b.d) / (b.v * b.v)};
}
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator+(Dual a, double b) { return {a.v + b, a.d}; }
__device__ __forceinline__ Dual operator+(double a, Dual b) { return {a + b.v, b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, double b) { return {a.v - b, a.d}; }
__device__ __forceinline__ Dual operator-(double a, Dual b) { return {a - b.v, -b.d}; }
__device__ __forceinline__ Dual operator*(Dual a, double b) { return {a.v * b, a.d * b}; }
__device__ __forceinline__ Dual operator*(double a, Dual b) { return {a * b.v, a * b.d}; }
__device__ __forceinline__ Dual operator/(Dual a, double b) { return {a.v / b, a.d / b}; }
__device__ __forceinline__ Dual operator/(double a, Dual b) { return {a / b.v, -a * b.d / (b.v * b.v)}; }

__device__ __forceinline__ double val(double x) { return x; }
__device__ __forceinline__ double val(Dual x) { return x.v; }
__device__ __forceinline__ double cst(double c, double) { return c; }
__device__ __forceinline__ Dual cst(double c, Dual) { return {c, 0.0}; }

__device__ __forceinline__ double Sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ Dual Sqrt(Dual x) {
  const double s = sqrt(x.v);
  return {s, x.d / (2.0 * s)};
}
__device__ __forceinline__ double Sin(double x) { return sin(x); }
__device__ __forceinline__ Dual Sin(Dual x) { return {sin(x.v), cos(x.v) * x.d}; }
__device__ __forceinline__ double Cos(double x) { return cos(x); }
__device__ __forceinline__ Dual Cos(Dual x) { return {cos(x.v), -sin(x.v) * x.d}; }
__device__ __forceinline__ double Exp(double x) { return exp(x); }
__device__ __forceinline__ Dual Exp(Dual x) {
  const double e = exp(x.v);
  return {e, e * x.d};
}
__device__ __forceinline__ double Expm1(double x) { return expm1(x); }
__device__ __forceinline__ Dual Expm1(Dual x) { return {expm1(x.v), exp(x.v) * x.d}; }
__device__ __forceinline__ double Log(double x) { return log(x); }
__device__ __forceinline__ Dual Log(Dual x) { return {log(x.v), x.d / x.v}; }
__device__ __forceinline__ double Atan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ Dual Atan2(Dual y, Dual x) {
  return {atan2(y.v, x.v), (x.v * y.d - y.v * x.d) / (x.v * x.v + y.v * y.v)};
}
// torch.clamp(x, min=c): the constant (no derivative) where x < c
template <class T>
__device__ __forceinline__ T ClampMin(T x, double c) {
  return val(x) < c ? cst(c, x) : x;
}

// Rodrigues (lie.so3_exp): Taylor terms below theta^2 = 1e-8.
template <class T>
__device__ void so3_exp(const T (&w)[3], T (&R)[3][3]) {
  const T th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const T th = Sqrt(ClampMin(th2, 1e-16));
  const bool small = val(th2) < 1e-8;
  const T a = small ? 1.0 - th2 / 6.0 : Sin(th) / th;
  const T b = small ? 0.5 - th2 / 24.0 : (1.0 - Cos(th)) / ClampMin(th2, 1e-16);
  const T z = cst(0.0, w[0]);
  const T W[3][3] = {{z, -w[2], w[1]}, {w[2], z, -w[0]}, {-w[1], w[0], z}};
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      T w2 = W[r][0] * W[0][c] + W[r][1] * W[1][c] + W[r][2] * W[2][c];
      R[r][c] = (r == c ? 1.0 : 0.0) + a * W[r][c] + b * w2;
    }
}

// (C, A, B) of Ws = C I + A hat(phi) + B hat(phi)^2 (lie._sim3_W_coeffs):
// double Taylor, theta-Taylor, sigma-series and the closed form, split at
// |theta|, |sigma| = 0.05.
template <class T>
__device__ void W_coeffs(T theta2, T sigma, T& C, T& A, T& B) {
  constexpr double TAU = 0.05;
  const T theta = Sqrt(ClampMin(theta2, 1e-24));
  const bool small_t = val(theta) < TAU, small_s = fabs(val(sigma)) < TAU;
  const T th = small_t ? cst(TAU, theta) : theta;
  const T sg = small_s ? cst(TAU, sigma) : sigma;
  const T s_sg = Exp(sg);
  const bool tiny = fabs(val(sigma)) < 1e-12;
  C = tiny ? 1.0 + sigma / 2.0 : Expm1(sigma) / (tiny ? cst(1.0, sigma) : sigma);
  const T s2 = sigma * sigma;
  if (small_t && small_s) {
    A = 0.5 + sigma / 3.0 + s2 / 8.0 - theta2 / 24.0 - sigma * theta2 / 30.0;
    B = 1.0 / 6.0 + sigma / 8.0 + s2 / 20.0 - theta2 / 120.0 - sigma * theta2 / 144.0;
  } else if (small_t) {
    const T sg2 = sg * sg, sg3 = sg2 * sg, sg4 = sg3 * sg, sg5 = sg4 * sg;
    const T E1 = (s_sg * (sg - 1.0) + 1.0) / sg2;
    const T E2 = (s_sg * (sg2 - 2.0 * sg + 2.0) - 2.0) / sg3;
    const T E3 = (s_sg * (sg3 - 3.0 * sg2 + 6.0 * sg - 6.0) + 6.0) / sg4;
    const T E4 = (s_sg * (sg4 - 4.0 * sg3 + 12.0 * sg2 - 24.0 * sg + 24.0) - 24.0) / sg5;
    A = E1 - theta2 / 6.0 * E3;
    B = E2 / 2.0 - theta2 / 24.0 * E4;
  } else if (small_s) {
    const T sinth = Sin(th), costh = Cos(th), th2 = th * th, th3 = th2 * th;
    const T I0s = (1.0 - costh) / th;
    const T I1s = (sinth - th * costh) / th2;
    const T I2s = (2.0 * th * sinth + (2.0 - th2) * costh - 2.0) / th3;
    const T I0c = 1.0 - sinth / th;
    const T I1c = 0.5 - (costh + th * sinth - 1.0) / th2;
    const T I2c = 1.0 / 3.0 - ((th2 - 2.0) * sinth + 2.0 * th * costh) / th3;
    A = (I0s + sigma * I1s + 0.5 * s2 * I2s) / th;
    B = (I0c + sigma * I1c + 0.5 * s2 * I2c) / th2;
  } else {
    const T sinth = Sin(th), costh = Cos(th);
    const T a_ = s_sg * sinth, b_ = s_sg * costh;
    const T cden = sg * sg + th * th;
    const T C_g = (s_sg - 1.0) / sg;
    A = (a_ * sg + (1.0 - b_) * th) / (th * cden);
    B = (C_g - ((b_ - 1.0) * sg + a_ * th) / cden) / (th * th);
  }
}

template <class T>
__device__ void W_matrix(const T (&phi)[3], T sigma, T (&Wm)[3][3]) {
  T C, A, B;
  W_coeffs(phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2], sigma, C, A, B);
  const T z = cst(0.0, sigma);
  const T H[3][3] = {{z, -phi[2], phi[1]}, {phi[2], z, -phi[0]}, {-phi[1], phi[0], z}};
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      const T h2 = H[r][0] * H[0][c] + H[r][1] * H[1][c] + H[r][2] * H[2][c];
      Wm[r][c] = (r == c ? C : z) + A * H[r][c] + B * h2;
    }
}

// sim(3) exp; xi = [rho(3), phi(3), sigma] -> (R, t, s).
template <class T>
__device__ void sim3_exp(const T (&xi)[7], T (&R)[3][3], T (&t)[3], T& s) {
  const T phi[3] = {xi[3], xi[4], xi[5]};
  so3_exp(phi, R);
  T Wm[3][3];
  W_matrix(phi, xi[6], Wm);
  for (int r = 0; r < 3; ++r) t[r] = Wm[r][0] * xi[0] + Wm[r][1] * xi[1] + Wm[r][2] * xi[2];
  s = Exp(xi[6]);
}

// lie.rotation_to_quaternion then lie.so3_log: Shepperd's four candidates,
// the first of the largest pivots, normalised with w >= 0; the angle by
// atan2, 2 / w below |qv| = 1e-6.
template <class T>
__device__ void so3_log(const T (&R)[3][3], T (&w)[3]) {
  const T tr = R[0][0] + R[1][1] + R[2][2];
  const T piv[4] = {ClampMin(1.0 + tr, 0.0), ClampMin(1.0 + R[0][0] - R[1][1] - R[2][2], 0.0),
                    ClampMin(1.0 - R[0][0] + R[1][1] - R[2][2], 0.0),
                    ClampMin(1.0 - R[0][0] - R[1][1] + R[2][2], 0.0)};
  int best = 0;
  for (int k = 1; k < 4; ++k)
    if (val(piv[k]) > val(piv[best])) best = k;
  const T sq = Sqrt(piv[best] + 1e-8);
  T q[4];
  if (best == 0) {
    q[0] = sq, q[1] = (R[2][1] - R[1][2]) / sq, q[2] = (R[0][2] - R[2][0]) / sq, q[3] = (R[1][0] - R[0][1]) / sq;
  } else if (best == 1) {
    q[0] = (R[2][1] - R[1][2]) / sq, q[1] = sq, q[2] = (R[0][1] + R[1][0]) / sq, q[3] = (R[0][2] + R[2][0]) / sq;
  } else if (best == 2) {
    q[0] = (R[0][2] - R[2][0]) / sq, q[1] = (R[0][1] + R[1][0]) / sq, q[2] = sq, q[3] = (R[1][2] + R[2][1]) / sq;
  } else {
    q[0] = (R[1][0] - R[0][1]) / sq, q[1] = (R[0][2] + R[2][0]) / sq, q[2] = (R[1][2] + R[2][1]) / sq, q[3] = sq;
  }
  for (int k = 0; k < 4; ++k) q[k] = 0.5 * q[k];
  const T nq = Sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const double sgn = val(q[0]) / val(nq) < 0.0 ? -1.0 : 1.0;
  for (int k = 0; k < 4; ++k) q[k] = sgn * (q[k] / nq);
  const T nv = Sqrt(q[1] * q[1] + q[2] * q[2] + q[3] * q[3] + 1e-24);
  const T theta = 2.0 * Atan2(nv, q[0]);
  const T scale = val(nv) < 1e-6 ? 2.0 / ClampMin(q[0], 1e-8) : theta / ClampMin(nv, 1e-8);
  for (int k = 0; k < 3; ++k) w[k] = scale * q[k + 1];
}

// sim(3) log: phi, sigma = log s, then Ws rho = t by Cramer's rule.
template <class T>
__device__ void sim3_log(const T (&R)[3][3], const T (&t)[3], T s, T (&xi)[7]) {
  T phi[3];
  so3_log(R, phi);
  const T sigma = Log(s);
  T M[3][3];
  W_matrix(phi, sigma, M);
  const T c00 = M[1][1] * M[2][2] - M[1][2] * M[2][1], c01 = M[1][2] * M[2][0] - M[1][0] * M[2][2],
          c02 = M[1][0] * M[2][1] - M[1][1] * M[2][0];
  const T det = M[0][0] * c00 + M[0][1] * c01 + M[0][2] * c02;
  const T inv[3][3] = {{c00, M[0][2] * M[2][1] - M[0][1] * M[2][2], M[0][1] * M[1][2] - M[0][2] * M[1][1]},
                       {c01, M[0][0] * M[2][2] - M[0][2] * M[2][0], M[0][2] * M[1][0] - M[0][0] * M[1][2]},
                       {c02, M[0][1] * M[2][0] - M[0][0] * M[2][1], M[0][0] * M[1][1] - M[0][1] * M[1][0]}};
  for (int r = 0; r < 3; ++r) xi[r] = (inv[r][0] * t[0] + inv[r][1] * t[1] + inv[r][2] * t[2]) / det;
  for (int k = 0; k < 3; ++k) xi[3 + k] = phi[k];
  xi[6] = sigma;
}

// S <- sim3_exp(dx) S in float64, R re-orthonormalised as
// lie.normalize_rotation does (U diag(1, 1, det(U V^T)) V^T).
__device__ inline void left_update(const double (&dx)[7], double (&R)[3][3], double (&t)[3], double& s) {
  double dR[3][3], dt[3], ds;
  sim3_exp(dx, dR, dt, ds);
  double Rn[3][3], tn[3];
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) Rn[r][c] = dR[r][0] * R[0][c] + dR[r][1] * R[1][c] + dR[r][2] * R[2][c];
    tn[r] = ds * (dR[r][0] * t[0] + dR[r][1] * t[1] + dR[r][2] * t[2]) + dt[r];
  }
  double U[3][3], sv[3], V[3][3];
  jacobi::svd3(Rn, U, sv, V);
  jacobi::udv(U, jacobi::det3(U) * jacobi::det3(V), V, R);
  for (int r = 0; r < 3; ++r) t[r] = tn[r];
  s = ds * s;
}

// A Sim3 stored as R (9) | t (3) | s (1), float32.
__device__ inline void load(const float* v, double (&R)[3][3], double (&t)[3], double& s) {
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) R[r][c] = v[3 * r + c];
    t[r] = v[9 + r];
  }
  s = v[12];
}

// a o b for a Dual a and a constant b
__device__ inline void compose_dc(const Dual (&Ra)[3][3], const Dual (&ta)[3], Dual sa, const double (&Rb)[3][3],
                                  const double (&tb)[3], double sb, Dual (&R)[3][3], Dual (&t)[3], Dual& s) {
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) R[r][c] = Ra[r][0] * Rb[0][c] + Ra[r][1] * Rb[1][c] + Ra[r][2] * Rb[2][c];
    t[r] = sa * (Ra[r][0] * tb[0] + Ra[r][1] * tb[1] + Ra[r][2] * tb[2]) + ta[r];
  }
  s = sa * sb;
}

// One lane of kernel S's edge evaluation: the residual
// log(S_ij^-1 exp(dx_i) S_i (exp(dx_j) S_j)^-1) at dx = 0 in dual numbers
// whose tangent is direction ``lane`` (dx_i's for lane < 7, dx_j's for
// 7 <= lane < 14).  Writes the 7 derivatives to ``col`` and, where ``r`` is
// given, the 7 values.  vi, vj: the vertices; m: the measurement S_ij.
__device__ inline void edge_lane(const float* vi, const float* vj, const float* m, int lane, double* col, double* r) {
  double Ri[3][3], ti[3], si, Rj[3][3], tj[3], sj, Rm[3][3], tm[3], sm;
  load(vi, Ri, ti, si);
  load(vj, Rj, tj, sj);
  load(m, Rm, tm, sm);
  Dual dxi[7], dxj[7];
  for (int k = 0; k < 7; ++k) {
    dxi[k] = {0.0, lane == k ? 1.0 : 0.0};
    dxj[k] = {0.0, lane == 7 + k ? 1.0 : 0.0};
  }
  Dual ER[3][3], Et[3], Es, AR[3][3], At[3], As, BR[3][3], Bt[3], Bs;
  sim3_exp(dxi, ER, Et, Es);
  compose_dc(ER, Et, Es, Ri, ti, si, AR, At, As);  // A = exp(dx_i) S_i
  sim3_exp(dxj, ER, Et, Es);
  compose_dc(ER, Et, Es, Rj, tj, sj, BR, Bt, Bs);  // B = exp(dx_j) S_j
  Dual BiR[3][3], Bit[3];  // B^-1 = (R^T, -R^T t / s, 1 / s)
  const Dual Bis = 1.0 / Bs;
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c) BiR[a][c] = BR[c][a];
  for (int a = 0; a < 3; ++a) Bit[a] = -Bis * (BiR[a][0] * Bt[0] + BiR[a][1] * Bt[1] + BiR[a][2] * Bt[2]);
  double MiR[3][3], Mit[3];  // S_ij^-1
  const double Mis = 1.0 / sm;
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c) MiR[a][c] = Rm[c][a];
  for (int a = 0; a < 3; ++a) Mit[a] = -Mis * (MiR[a][0] * tm[0] + MiR[a][1] * tm[1] + MiR[a][2] * tm[2]);
  Dual CR[3][3], Ct[3];  // C = S_ij^-1 A
  for (int a = 0; a < 3; ++a) {
    for (int c = 0; c < 3; ++c) CR[a][c] = MiR[a][0] * AR[0][c] + MiR[a][1] * AR[1][c] + MiR[a][2] * AR[2][c];
    Ct[a] = Mis * (MiR[a][0] * At[0] + MiR[a][1] * At[1] + MiR[a][2] * At[2]) + Mit[a];
  }
  const Dual Cs = Mis * As;
  Dual DR[3][3], Dt[3];  // D = C B^-1
  for (int a = 0; a < 3; ++a) {
    for (int c = 0; c < 3; ++c) DR[a][c] = CR[a][0] * BiR[0][c] + CR[a][1] * BiR[1][c] + CR[a][2] * BiR[2][c];
    Dt[a] = Cs * (CR[a][0] * Bit[0] + CR[a][1] * Bit[1] + CR[a][2] * Bit[2]) + Ct[a];
  }
  Dual xi[7];
  sim3_log(DR, Dt, Cs * Bis, xi);
  for (int k = 0; k < 7; ++k) col[k] = xi[k].d;
  if (r != nullptr)
    for (int k = 0; k < 7; ++k) r[k] = xi[k].v;
}

}  // namespace sim3
