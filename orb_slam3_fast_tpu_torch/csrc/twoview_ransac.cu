// Kernel M: two-view reconstruction for mono initialisation, three launches.
//  1. fit_score, one CTA per hypothesis: the Hartley normalisation
//     block-reduced over the valid points; thread 0 solves the 8-point F and
//     thread 32 the 8-point DLT H as the least eigenvector of A^T A (float64
//     Jacobi), F made rank 2, both denormalised; every thread scores its
//     points against both (symmetric transfer), block-reduced.
//  2. refit, one CTA per model: the first best hypothesis, its inliers, the
//     normalisation and the 9x9 A^T A over them, the least-squares model,
//     kept if it scores at least the sampled best; the chosen model, its
//     score and its inlier mask.
//  3. check_rt, one CTA per motion (4 from F, 8 from H): the motion from the
//     model's 3x3 SVD, every match triangulated and tested as CheckRT does,
//     the count and quality block-reduced, the parallax from a bitonic sort
//     of the counted cosines.
// See the source note in ops/twoview.py; reconstruct_plain there is the same
// function in PyTorch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "jacobi.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 2048;
constexpr float kThF = 3.841f;       // CheckFundamental per-direction chi2
constexpr float kThScoreF = 5.991f;
constexpr float kThH = 5.991f;       // CheckHomography chi2
constexpr float kTh2 = 4.0f;         // CheckRT reprojection gate, in sigma^2

struct Norm {
  float mx, my, sx, sy;  // x_n = (x - m) * s
};

// Hartley normalisation over the points where mask(i) holds (every thread
// gets it): mean, then the mean absolute deviation, s = 1 / max(dev, 1e-8).
template <typename Mask>
__device__ Norm normalize(const float2* __restrict__ x, int n, Mask mask, double* red) {
  double c = 0.0, sx = 0.0, sy = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (mask(i)) {
      c += 1.0;
      sx += x[i].x;
      sy += x[i].y;
    }
  const float cnt = (float)fmax(jacobi::block_sum(c, red), 1.0);
  const float mx = (float)jacobi::block_sum(sx, red) / cnt;
  const float my = (float)jacobi::block_sum(sy, red) / cnt;
  double dx = 0.0, dy = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (mask(i)) {
      dx += fabsf(x[i].x - mx);
      dy += fabsf(x[i].y - my);
    }
  const float devx = (float)jacobi::block_sum(dx, red) / cnt;
  const float devy = (float)jacobi::block_sum(dy, red) / cnt;
  return {mx, my, 1.f / fmaxf(devx, 1e-8f), 1.f / fmaxf(devy, 1e-8f)};
}

__device__ __forceinline__ float2 norm_pt(float2 p, const Norm& t) {
  return make_float2((p.x - t.mx) * t.sx, (p.y - t.my) * t.sy);
}

__device__ __forceinline__ void f_row(float2 a, float2 b, float (&r)[9]) {
  r[0] = b.x * a.x; r[1] = b.x * a.y; r[2] = b.x;
  r[3] = b.y * a.x; r[4] = b.y * a.y; r[5] = b.y;
  r[6] = a.x; r[7] = a.y; r[8] = 1.f;
}

__device__ __forceinline__ void h_rows(float2 a, float2 b, float (&r1)[9], float (&r2)[9]) {
  r1[0] = a.x; r1[1] = a.y; r1[2] = 1.f; r1[3] = 0.f; r1[4] = 0.f; r1[5] = 0.f;
  r1[6] = -b.x * a.x; r1[7] = -b.x * a.y; r1[8] = -b.x;
  r2[0] = 0.f; r2[1] = 0.f; r2[2] = 0.f; r2[3] = a.x; r2[4] = a.y; r2[5] = 1.f;
  r2[6] = -b.y * a.x; r2[7] = -b.y * a.y; r2[8] = -b.y;
}

__device__ __forceinline__ void add_row(double (&M)[9][9], const float (&r)[9]) {
  for (int a = 0; a < 9; ++a)
    for (int b = a; b < 9; ++b) M[a][b] += (double)r[a] * (double)r[b];
}

__device__ __forceinline__ void matmul3(const double (&A)[3][3], const double (&B)[3][3], double (&C)[3][3]) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) C[r][c] = A[r][0] * B[0][c] + A[r][1] * B[1][c] + A[r][2] * B[2][c];
}

// The model from the least eigenvector of the (upper-filled) 9x9 normal
// matrix: F made rank 2 (F - F v3 v3^T) and denormalised as T1^T F T0, or H
// denormalised as T1^-1 H T0.
__device__ void solve_model(double (&M)[9][9], bool is_f, const Norm& t0, const Norm& t1, float (&out)[9]) {
  for (int a = 0; a < 9; ++a)
    for (int b = 0; b < a; ++b) M[a][b] = M[b][a];
  double v[9];
  jacobi::least_eigvec(M, v);
  double N[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) N[r][c] = v[3 * r + c];
  const double T0[3][3] = {{t0.sx, 0.0, (double)(-t0.mx * t0.sx)}, {0.0, t0.sy, (double)(-t0.my * t0.sy)},
                           {0.0, 0.0, 1.0}};
  double L[3][3], tmp[3][3], res[3][3];
  if (is_f) {
    double NtN[3][3], w3[3];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) NtN[r][c] = N[0][r] * N[0][c] + N[1][r] * N[1][c] + N[2][r] * N[2][c];
    jacobi::least_eigvec(NtN, w3);
    for (int r = 0; r < 3; ++r) {
      const double nv = N[r][0] * w3[0] + N[r][1] * w3[1] + N[r][2] * w3[2];
      for (int c = 0; c < 3; ++c) N[r][c] -= nv * w3[c];
    }
    const double T1t[3][3] = {{t1.sx, 0.0, 0.0}, {0.0, t1.sy, 0.0},
                              {(double)(-t1.mx * t1.sx), (double)(-t1.my * t1.sy), 1.0}};
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) L[r][c] = T1t[r][c];
  } else {
    const double T1i[3][3] = {{1.0 / t1.sx, 0.0, t1.mx}, {0.0, 1.0 / t1.sy, t1.my}, {0.0, 0.0, 1.0}};
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) L[r][c] = T1i[r][c];
  }
  matmul3(L, N, tmp);
  matmul3(tmp, T0, res);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) out[3 * r + c] = (float)res[r][c];
}

// H^-1 by the adjugate, in float64.
__device__ void inverse3(const float (&H)[9], float (&Hi)[9]) {
  double A[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) A[r][c] = H[3 * r + c];
  const double inv = 1.0 / jacobi::det3(A);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      const int r1 = (c + 1) % 3, r2 = (c + 2) % 3, c1 = (r + 1) % 3, c2 = (r + 2) % 3;
      Hi[3 * r + c] = (float)((A[r1][c1] * A[r2][c2] - A[r1][c2] * A[r2][c1]) * inv);
    }
}

// Symmetric epipolar transfer of one match (CheckFundamental); inl: both ways in.
__device__ __forceinline__ float score_f(const float* F, float2 p0, float2 p1, float sigma2, bool& inl) {
  const float l1x = F[0] * p0.x + F[1] * p0.y + F[2];  // F x0: the line in image 1
  const float l1y = F[3] * p0.x + F[4] * p0.y + F[5];
  const float l1z = F[6] * p0.x + F[7] * p0.y + F[8];
  const float l0x = p1.x * F[0] + p1.y * F[3] + F[6];  // F^T x1: the line in image 0
  const float l0y = p1.x * F[1] + p1.y * F[4] + F[7];
  const float l0z = p1.x * F[2] + p1.y * F[5] + F[8];
  const float e1 = l1x * p1.x + l1y * p1.y + l1z, e0 = l0x * p0.x + l0y * p0.y + l0z;
  const float c1 = e1 * e1 / fmaxf(l1x * l1x + l1y * l1y, 1e-12f) / sigma2;
  const float c0 = e0 * e0 / fmaxf(l0x * l0x + l0y * l0y, 1e-12f) / sigma2;
  const bool in1 = c1 <= kThF, in0 = c0 <= kThF;
  inl = in0 && in1;
  return (in1 ? kThScoreF - c1 : 0.f) + (in0 ? kThScoreF - c0 : 0.f);
}

__device__ __forceinline__ float2 transfer(const float* H, float2 p) {
  float w = H[6] * p.x + H[7] * p.y + H[8];
  w = fabsf(w) < 1e-12f ? 1e-12f : w;
  return make_float2((H[0] * p.x + H[1] * p.y + H[2]) / w, (H[3] * p.x + H[4] * p.y + H[5]) / w);
}

// Symmetric homography transfer of one match (CheckHomography).
__device__ __forceinline__ float score_h(const float* H, const float* Hi, float2 p0, float2 p1, float sigma2,
                                         bool& inl) {
  const float2 q1 = transfer(H, p0), q0 = transfer(Hi, p1);
  const float c1 = ((p1.x - q1.x) * (p1.x - q1.x) + (p1.y - q1.y) * (p1.y - q1.y)) / sigma2;
  const float c0 = ((p0.x - q0.x) * (p0.x - q0.x) + (p0.y - q0.y) * (p0.y - q0.y)) / sigma2;
  const bool in1 = c1 <= kThH, in0 = c0 <= kThH;
  inl = in0 && in1;
  return (in1 ? kThH - c1 : 0.f) + (in0 ? kThH - c0 : 0.f);
}

__global__ void __launch_bounds__(kThreads)
fit_score_kernel(const float2* __restrict__ x0, const float2* __restrict__ x1, const bool* __restrict__ valid,
                 const int* __restrict__ samples, int n, int n_hyp, float sigma2, float* __restrict__ hyp,
                 float* __restrict__ hyp_score) {
  __shared__ double red[33];
  __shared__ float sF[9], sH[9], sHi[9];
  const int h = blockIdx.x;
  auto is_valid = [&](int i) { return valid[i]; };
  const Norm t0 = normalize(x0, n, is_valid, red);
  const Norm t1 = normalize(x1, n, is_valid, red);
  if (threadIdx.x == 0 || threadIdx.x == 32) {  // two warps: F and H side by side
    const bool is_f = threadIdx.x == 0;
    double M[9][9] = {};
    for (int k = 0; k < 8; ++k) {
      const int i = samples[8 * h + k];
      const float2 a = norm_pt(x0[i], t0), b = norm_pt(x1[i], t1);
      float r1[9], r2[9];
      if (is_f) {
        f_row(a, b, r1);
        add_row(M, r1);
      } else {
        h_rows(a, b, r1, r2);
        add_row(M, r1);
        add_row(M, r2);
      }
    }
    if (is_f) {
      solve_model(M, true, t0, t1, sF);
    } else {
      solve_model(M, false, t0, t1, sH);
      inverse3(sH, sHi);
    }
  }
  __syncthreads();
  double sf = 0.0, sh = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (valid[i]) {
      bool in;
      sf += score_f(sF, x0[i], x1[i], sigma2, in);
      sh += score_h(sH, sHi, x0[i], x1[i], sigma2, in);
    }
  sf = jacobi::block_sum(sf, red);
  sh = jacobi::block_sum(sh, red);
  if (threadIdx.x < 9) {
    hyp[9 * h + threadIdx.x] = sF[threadIdx.x];
    hyp[9 * (n_hyp + h) + threadIdx.x] = sH[threadIdx.x];
  }
  if (threadIdx.x == 0) {
    hyp_score[h] = (float)sf;
    hyp_score[n_hyp + h] = (float)sh;
  }
}

__global__ void __launch_bounds__(kThreads)
refit_kernel(const float2* __restrict__ x0, const float2* __restrict__ x1, const bool* __restrict__ valid, int n,
             int n_hyp, float sigma2, const float* __restrict__ hyp, const float* __restrict__ hyp_score,
             float* __restrict__ model, float* __restrict__ model_score, bool* __restrict__ inl_out) {
  __shared__ double red[33];
  __shared__ double sAtA[45];
  __shared__ float sB[9], sBi[9], sR[9], sRi[9];
  __shared__ uint8_t s_inl[kMaxN];
  __shared__ int s_best;
  const int m = blockIdx.x;  // 0: F, 1: H
  const bool is_f = m == 0;
  const float* scores = hyp_score + m * n_hyp;
  if (threadIdx.x == 0) {  // the first maximum, as argmax
    int best = 0;
    for (int h = 1; h < n_hyp; ++h)
      if (scores[h] > scores[best]) best = h;
    s_best = best;
    for (int k = 0; k < 9; ++k) sB[k] = hyp[9 * (m * n_hyp + best) + k];
    if (!is_f) inverse3(sB, sBi);
  }
  __syncthreads();
  const float best_score = scores[s_best];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    bool in;
    if (is_f)
      score_f(sB, x0[i], x1[i], sigma2, in);
    else
      score_h(sB, sBi, x0[i], x1[i], sigma2, in);
    s_inl[i] = valid[i] && in;
  }
  __syncthreads();
  auto is_inl = [&](int i) { return s_inl[i] != 0; };
  const Norm t0 = normalize(x0, n, is_inl, red);
  const Norm t1 = normalize(x1, n, is_inl, red);
  double acc[45] = {};
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!s_inl[i]) continue;
    const float2 a = norm_pt(x0[i], t0), b = norm_pt(x1[i], t1);
    float r1[9], r2[9];
    if (is_f) {
      f_row(a, b, r1);
    } else {
      h_rows(a, b, r1, r2);
    }
    for (int a_ = 0, e = 0; a_ < 9; ++a_)
      for (int b_ = a_; b_ < 9; ++b_, ++e) {
        acc[e] += (double)r1[a_] * (double)r1[b_];
        if (!is_f) acc[e] += (double)r2[a_] * (double)r2[b_];
      }
  }
  for (int e = 0; e < 45; ++e) {
    const double v = jacobi::block_sum(acc[e], red);
    if (threadIdx.x == 0) sAtA[e] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double M[9][9] = {};
    for (int a = 0, e = 0; a < 9; ++a)
      for (int b = a; b < 9; ++b, ++e) M[a][b] = sAtA[e];
    solve_model(M, is_f, t0, t1, sR);
    if (!is_f) inverse3(sR, sRi);
  }
  __syncthreads();
  double sr = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (valid[i]) {
      bool in;
      sr += is_f ? score_f(sR, x0[i], x1[i], sigma2, in) : score_h(sR, sRi, x0[i], x1[i], sigma2, in);
    }
  const float refit_score = (float)jacobi::block_sum(sr, red);
  const bool use_refit = refit_score >= best_score;  // twoview.py:357-362
  const float* chosen = use_refit ? sR : sB;
  const float* chosen_inv = use_refit ? sRi : sBi;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    bool in;
    if (is_f)
      score_f(chosen, x0[i], x1[i], sigma2, in);
    else
      score_h(chosen, chosen_inv, x0[i], x1[i], sigma2, in);
    inl_out[m * n + i] = valid[i] && in;
  }
  if (threadIdx.x < 9) model[9 * m + threadIdx.x] = chosen[threadIdx.x];
  if (threadIdx.x == 0) model_score[m] = fmaxf(best_score, refit_score);
}

// Motion b (0..3) of E = F (DecomposeE): R1 = U W V^T, R2 = U W^T V^T, each
// times the sign of its determinant; t = +-u3.
__device__ void motion_f(const double (&U)[3][3], const double (&V)[3][3], int b, double (&R)[3][3],
                         double (&t)[3]) {
  const bool second = b >= 2;
  double UW[3][3];
  for (int r = 0; r < 3; ++r) {
    UW[r][0] = second ? -U[r][1] : U[r][1];
    UW[r][1] = second ? U[r][0] : -U[r][0];
    UW[r][2] = U[r][2];
  }
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) R[r][c] = UW[r][0] * V[c][0] + UW[r][1] * V[c][1] + UW[r][2] * V[c][2];
  const double d = jacobi::det3(R);
  const double sgn = d > 0.0 ? 1.0 : (d < 0.0 ? -1.0 : 0.0);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) R[r][c] *= sgn;
  const double nrm = fmax(sqrt(U[0][2] * U[0][2] + U[1][2] * U[1][2] + U[2][2] * U[2][2]), 1e-12);
  const double st = (b & 1) ? -1.0 : 1.0;
  for (int r = 0; r < 3; ++r) t[r] = st * U[r][2] / nrm;
}

// Motion i (0..7) of Faugeras' decomposition of H (ReconstructH).
__device__ void motion_h(const double (&U)[3][3], const double (&w)[3], const double (&V)[3][3], int i,
                         double (&R)[3][3], double (&t)[3]) {
  const double S = jacobi::det3(U) * jacobi::det3(V);
  const double d1 = w[0], d2 = w[1], d3 = w[2];
  const double den13 = fmax(d1 * d1 - d3 * d3, 1e-12);
  const double aux1 = sqrt(fmax((d1 * d1 - d2 * d2) / den13, 0.0));
  const double aux3 = sqrt(fmax((d2 * d2 - d3 * d3) / den13, 0.0));
  const double prod = sqrt(fmax((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0));
  const int k = i & 3;
  const double x1 = (k < 2 ? 1.0 : -1.0) * aux1, x3 = ((k & 1) ? -1.0 : 1.0) * aux3;
  const double ssign = (k == 0 || k == 3) ? 1.0 : -1.0;
  double Rp[3][3], tp[3];
  if (i < 4) {  // d' = d2
    const double den = fmax((d1 + d3) * d2, 1e-12);
    const double st = ssign * prod / den, ct = (d2 * d2 + d1 * d3) / den;
    const double Q[3][3] = {{ct, 0.0, -st}, {0.0, 1.0, 0.0}, {st, 0.0, ct}};
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) Rp[r][c] = Q[r][c];
    tp[0] = x1 * (d1 - d3);
    tp[1] = 0.0;
    tp[2] = -x3 * (d1 - d3);
  } else {  // d' = -d2
    const double den = fmax((d1 - d3) * d2, 1e-12);
    const double sp = ssign * prod / den, cp = (d1 * d3 - d2 * d2) / den;
    const double Q[3][3] = {{cp, 0.0, sp}, {0.0, -1.0, 0.0}, {sp, 0.0, -cp}};
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) Rp[r][c] = Q[r][c];
    tp[0] = x1 * (d1 + d3);
    tp[1] = 0.0;
    tp[2] = x3 * (d1 + d3);
  }
  double URp[3][3];
  matmul3(U, Rp, URp);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      R[r][c] = S * (URp[r][0] * V[c][0] + URp[r][1] * V[c][1] + URp[r][2] * V[c][2]);
  double nrm = 0.0;
  for (int r = 0; r < 3; ++r) {
    t[r] = U[r][0] * tp[0] + U[r][1] * tp[1] + U[r][2] * tp[2];
    nrm += t[r] * t[r];
  }
  nrm = fmax(sqrt(nrm), 1e-12);
  for (int r = 0; r < 3; ++r) t[r] /= nrm;
}

__global__ void __launch_bounds__(kThreads)
check_rt_kernel(const float2* __restrict__ x0, const float2* __restrict__ x1, const bool* __restrict__ valid,
                int n, float sigma2, const float* __restrict__ model, const bool* __restrict__ inl,
                float* __restrict__ Rall, float* __restrict__ tall, float* __restrict__ X,
                bool* __restrict__ tri, int* __restrict__ n_good, float* __restrict__ parallax,
                float* __restrict__ qual) {
  __shared__ double red[33];
  __shared__ float sP1[12];  // [R | t], row-major 3x4
  __shared__ float keys[kMaxN];
  const int b = blockIdx.x;
  const int m = b < 4 ? 0 : 1;
  if (threadIdx.x == 0) {
    double M[3][3], U[3][3], s[3], V[3][3], R[3][3], t[3];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) M[r][c] = model[9 * m + 3 * r + c];
    jacobi::svd3(M, U, s, V);
    if (m == 0)
      motion_f(U, V, b, R, t);
    else
      motion_h(U, s, V, b - 4, R, t);
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) {
        sP1[4 * r + c] = (float)R[r][c];
        Rall[9 * b + 3 * r + c] = (float)R[r][c];
      }
      sP1[4 * r + 3] = (float)t[r];
      tall[3 * b + r] = (float)t[r];
    }
  }
  __syncthreads();
  const float P0[12] = {1.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f};
  const float* P1 = sP1;
  // the second camera's centre, -R^T t
  float o1[3];
  for (int c = 0; c < 3; ++c) o1[c] = -(P1[c] * P1[3] + P1[4 + c] * P1[7] + P1[8 + c] * P1[11]);
  int n_pad = 1;
  while (n_pad < n) n_pad <<= 1;
  double ng = 0.0, q = 0.0;
  for (int i = threadIdx.x; i < n_pad; i += blockDim.x) {
    if (i >= n) {
      keys[i] = 3.f;  // after every counted cosine and every 2.0
      continue;
    }
    const float2 p0 = x0[i], p1 = x1[i];
    float Xi[3];
    jacobi::dlt_triangulate(P0, P1, p0.x, p0.y, p1.x, p1.y, Xi);
    const bool finite = isfinite(Xi[0]) && isfinite(Xi[1]) && isfinite(Xi[2]);
    const float n1x = Xi[0] - o1[0], n1y = Xi[1] - o1[1], n1z = Xi[2] - o1[2];
    const float nn0 = sqrtf(Xi[0] * Xi[0] + Xi[1] * Xi[1] + Xi[2] * Xi[2]);
    const float nn1 = sqrtf(n1x * n1x + n1y * n1y + n1z * n1z);
    const float cosp = (Xi[0] * n1x + Xi[1] * n1y + Xi[2] * n1z) / fmaxf(nn0 * nn1, 1e-12f);
    const bool has_par = cosp < 0.99998f;
    const float z0 = Xi[2];
    float c1[3];
    for (int r = 0; r < 3; ++r) c1[r] = P1[4 * r] * Xi[0] + P1[4 * r + 1] * Xi[1] + P1[4 * r + 2] * Xi[2] + P1[4 * r + 3];
    const float z1 = c1[2];
    // cheirality rejects only points with parallax (TwoViewReconstruction.cc:901, :907)
    const bool cheirality_ok = !(z0 <= 0.f && has_par) && !(z1 <= 0.f && has_par);
    const float z0s = fabsf(z0) < 1e-9f ? 1e-9f : z0, z1s = fabsf(z1) < 1e-9f ? 1e-9f : z1;
    const float a0 = Xi[0] / z0s - p0.x, b0 = Xi[1] / z0s - p0.y;
    const float a1 = c1[0] / z1s - p1.x, b1 = c1[1] / z1s - p1.y;
    const float e0 = a0 * a0 + b0 * b0, e1 = a1 * a1 + b1 * b1;
    const bool counted = valid[i] && inl[m * n + i] && finite && cheirality_ok && e0 < kTh2 * sigma2 &&
                         e1 < kTh2 * sigma2;
    X[(size_t)3 * (b * n + i)] = Xi[0];
    X[(size_t)3 * (b * n + i) + 1] = Xi[1];
    X[(size_t)3 * (b * n + i) + 2] = Xi[2];
    tri[b * n + i] = counted && has_par && z0 > 0.f && z1 > 0.f;
    keys[i] = counted ? cosp : 2.f;
    if (counted) {
      ng += 1.0;
      q += 2.f * kTh2 - (e0 + e1) / fmaxf(sigma2, 1e-18f);
    }
  }
  ng = jacobi::block_sum(ng, red);  // its barriers also publish keys
  q = jacobi::block_sum(q, red);
  for (int k = 2; k <= n_pad; k <<= 1)  // bitonic sort, ascending
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n_pad; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const bool up = (i & k) == 0;
          const float a = keys[i], c = keys[l];
          if ((a > c) == up) {
            keys[i] = c;
            keys[l] = a;
          }
        }
      }
      __syncthreads();
    }
  if (threadIdx.x == 0) {
    const int good = (int)ng;
    int k = good - 1 < 50 ? good - 1 : 50;
    k = k < 0 ? 0 : (k > n - 1 ? n - 1 : k);
    const float kth = fminf(fmaxf(keys[k], -1.f), 1.f);
    n_good[b] = good;
    parallax[b] = good > 0 ? acosf(kth) * (180.f / 3.14159265358979f) : 0.f;
    qual[b] = (float)q;
  }
}

}  // namespace

extern "C" int twoview_ransac_launch(const float* x0, const float* x1, const bool* valid, const int* samples,
                                     int n, int n_hyp, float sigma2, float* hyp, float* hyp_score, float* model,
                                     float* model_score, bool* inl, float* Rall, float* tall, float* X, bool* tri,
                                     int* n_good, float* parallax, float* qual, void* stream) {
  if (n < 1 || n > kMaxN || n_hyp < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* p0 = reinterpret_cast<const float2*>(x0);
  const float2* p1 = reinterpret_cast<const float2*>(x1);
  fit_score_kernel<<<n_hyp, kThreads, 0, st>>>(p0, p1, valid, samples, n, n_hyp, sigma2, hyp, hyp_score);
  refit_kernel<<<2, kThreads, 0, st>>>(p0, p1, valid, n, n_hyp, sigma2, hyp, hyp_score, model, model_score, inl);
  check_rt_kernel<<<12, kThreads, 0, st>>>(p0, p1, valid, n, sigma2, model, inl, Rall, tall, X, tri, n_good,
                                           parallax, qual);
  return cudaGetLastError();
}
