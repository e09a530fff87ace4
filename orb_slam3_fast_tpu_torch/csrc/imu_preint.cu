// Kernel V: IMU preintegration, one warp per window.  Every lane carries the
// small state (dR, dV, dP, the five bias Jacobians) in registers and updates
// it redundantly; the lanes share out the covariance products through
// shared memory (A C9, then (A C9) A^T + B N B^T, then the cross block
// A C[:9, 9:15], then the walk on the bias block), float32 throughout and in
// the order of imu/preintegration.py integrate_step.  dR is re-orthonormalised
// every step by jacobi::svd3 in float64 (U diag(1, 1, det(U V^T)) V^T); a
// non-finite entry gives NaNs.  compose: one thread, closed form.  See the
// source note in imu/preintegration.py.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "inertial.cuh"
#include "jacobi.cuh"

namespace {

__device__ __forceinline__ void matmul3(const float (&A)[3][3], const float (&B)[3][3], float (&C)[3][3]) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) C[r][c] = A[r][0] * B[0][c] + A[r][1] * B[1][c] + A[r][2] * B[2][c];
}

// lie.so3_exp in float32: Taylor terms below theta^2 = 1e-8.
__device__ void so3_exp_f(const float (&w)[3], float (&R)[3][3]) {
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float th = sqrtf(fmaxf(th2, 1e-16f));
  const bool small = th2 < 1e-8f;
  const float a = small ? 1.f - th2 / 6.f : sinf(th) / th;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / fmaxf(th2, 1e-16f);
  const float W[3][3] = {{0.f, -w[2], w[1]}, {w[2], 0.f, -w[0]}, {-w[1], w[0], 0.f}};
  float W2[3][3];
  matmul3(W, W, W2);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) R[r][c] = (r == c ? 1.f : 0.f) + a * W[r][c] + b * W2[r][c];
}

// lie.so3_right_jacobian in float32.
__device__ void right_jacobian_f(const float (&w)[3], float (&J)[3][3]) {
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float th = sqrtf(fmaxf(th2, 1e-16f));
  const bool small = th2 < 1e-8f;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cosf(th)) / fmaxf(th2, 1e-16f);
  const float c = small ? 1.f / 6.f - th2 / 120.f : (th - sinf(th)) / fmaxf(th2 * th, 1e-24f);
  const float W[3][3] = {{0.f, -w[2], w[1]}, {w[2], 0.f, -w[0]}, {-w[1], w[0], 0.f}};
  float W2[3][3];
  matmul3(W, W, W2);
  for (int r = 0; r < 3; ++r)
    for (int k = 0; k < 3; ++k) J[r][k] = (r == k ? 1.f : 0.f) - b * W[r][k] + c * W2[r][k];
}

// lie.normalize_rotation: U diag(1, 1, det(U V^T)) V^T by a float64 SVD; NaN where an entry is not finite.
__device__ void normalize_f(const float (&M)[3][3], float (&R)[3][3]) {
  bool finite = true;
  double Md[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      finite = finite && isfinite(M[r][c]);
      Md[r][c] = M[r][c];
    }
  if (!finite) {
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) R[r][c] = nanf("");
    return;
  }
  double U[3][3], s[3], V[3][3], Rd[3][3];
  jacobi::svd3(Md, U, s, V);
  jacobi::udv(U, jacobi::det3(U) * jacobi::det3(V), V, Rd);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) R[r][c] = (float)Rd[r][c];
}

struct P {
  float dT, dR[3][3], dV[3], dP[3], J[5][3][3], bias[6];  // J: JRg JVg JVa JPg JPa
};

__global__ void __launch_bounds__(32)
imu_preint_kernel(const float* __restrict__ start, const float* __restrict__ bias, const float* __restrict__ acc,
                  const float* __restrict__ gyro, const float* __restrict__ dts, const uint8_t* __restrict__ valid,
                  int n, float sg, float sa, float wg, float wa, float* __restrict__ out) {
  __shared__ float C[15][15];
  __shared__ float A[9][9], B[9][6], T[9][9], X[9][6];
  const int lane = threadIdx.x;
  P p;
  if (start != nullptr) {
    p.dT = start[0];
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) {
        p.dR[r][c] = start[inr::kOffR + 3 * r + c];
        for (int k = 0; k < 5; ++k) p.J[k][r][c] = start[inr::kOffJ + 9 * k + 3 * r + c];
      }
      p.dV[r] = start[inr::kOffV + r];
      p.dP[r] = start[inr::kOffP + r];
    }
    for (int k = 0; k < 6; ++k) p.bias[k] = start[inr::kOffBias + k];
    for (int t = lane; t < 225; t += 32) C[t / 15][t % 15] = start[inr::kOffC + t];
  } else {
    p.dT = 0.f;
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) {
        p.dR[r][c] = r == c ? 1.f : 0.f;
        for (int k = 0; k < 5; ++k) p.J[k][r][c] = 0.f;
      }
      p.dV[r] = p.dP[r] = 0.f;
    }
    for (int k = 0; k < 6; ++k) p.bias[k] = bias[k];
    for (int t = lane; t < 225; t += 32) C[t / 15][t % 15] = 0.f;
  }
  const float ng[6] = {sg * sg, sg * sg, sg * sg, sa * sa, sa * sa, sa * sa};
  const float nw[6] = {wg * wg, wg * wg, wg * wg, wa * wa, wa * wa, wa * wa};
  __syncwarp();
  for (int s = 0; s < n; ++s) {
    const float dt = valid[s] ? dts[s] : 0.f;
    const float dt2 = dt * dt;
    float a[3], w[3];
    for (int k = 0; k < 3; ++k) a[k] = acc[3 * s + k] - p.bias[3 + k], w[k] = gyro[3 * s + k] - p.bias[k];
    const float Wa[3][3] = {{0.f, -a[2], a[1]}, {a[2], 0.f, -a[0]}, {-a[1], a[0], 0.f}};
    float dRa[3][3], Ra[3];
    matmul3(p.dR, Wa, dRa);
    for (int r = 0; r < 3; ++r) Ra[r] = p.dR[r][0] * a[0] + p.dR[r][1] * a[1] + p.dR[r][2] * a[2];
    float dP_new[3], dV_new[3];
    for (int r = 0; r < 3; ++r) {
      dP_new[r] = p.dP[r] + p.dV[r] * dt + 0.5f * Ra[r] * dt2;
      dV_new[r] = p.dV[r] + Ra[r] * dt;
    }
    const float wdt[3] = {w[0] * dt, w[1] * dt, w[2] * dt};
    float dRi[3][3], Jr[3][3];
    so3_exp_f(wdt, dRi);
    right_jacobian_f(wdt, Jr);
    // A (9x9) and B (9x6), lanes by entry
    for (int t = lane; t < 81; t += 32) {
      const int r = t / 9, c = t % 9, br = r / 3, bc = c / 3, i = r % 3, j = c % 3;
      float v = 0.f;
      if (bc == 0) v = br == 0 ? dRi[j][i] : (br == 1 ? -dRa[i][j] * dt : -0.5f * dRa[i][j] * dt2);
      else if (bc == 1) v = br == 0 ? 0.f : (br == 1 ? (i == j ? 1.f : 0.f) : (i == j ? dt : 0.f));
      else v = br == 2 && i == j ? 1.f : 0.f;
      A[r][c] = v;
    }
    for (int t = lane; t < 54; t += 32) {
      const int r = t / 6, c = t % 6, br = r / 3, i = r % 3, j = c % 3;
      float v = 0.f;
      if (c < 3) v = br == 0 ? Jr[i][j] * dt : 0.f;
      else v = br == 1 ? p.dR[i][j] * dt : (br == 2 ? 0.5f * p.dR[i][j] * dt2 : 0.f);
      B[r][c] = v;
    }
    __syncwarp();
    // T = A C9, X = A C[:9, 9:]
    for (int t = lane; t < 81 + 54; t += 32) {
      if (t < 81) {
        const int r = t / 9, c = t % 9;
        float v = 0.f;
        for (int k = 0; k < 9; ++k) v += A[r][k] * C[k][c];
        T[r][c] = v;
      } else {
        const int r = (t - 81) / 6, c = (t - 81) % 6;
        float v = 0.f;
        for (int k = 0; k < 9; ++k) v += A[r][k] * C[k][9 + c];
        X[r][c] = v;
      }
    }
    __syncwarp();
    // C9 = T A^T + B N B^T; the cross block and its transpose; the walk on the bias block
    for (int t = lane; t < 81; t += 32) {
      const int r = t / 9, c = t % 9;
      float v = 0.f, u = 0.f;
      for (int k = 0; k < 9; ++k) v += T[r][k] * A[c][k];
      for (int k = 0; k < 6; ++k) u += B[r][k] * ng[k] * B[c][k];
      C[r][c] = v + u;
    }
    for (int t = lane; t < 54; t += 32) {
      const int r = t / 6, c = t % 6;
      C[r][9 + c] = X[r][c];
      C[9 + c][r] = X[r][c];
    }
    if (lane < 6) C[9 + lane][9 + lane] += nw[lane] * dt;
    __syncwarp();
    // bias Jacobians (P before V before R, from the old values), then dR
    float JPa[3][3], JPg[3][3], JVa[3][3], JVg[3][3], JRg[3][3], dRaJ[3][3], dRiT_J[3][3];
    matmul3(dRa, p.J[0], dRaJ);
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        dRiT_J[r][c] = dRi[0][r] * p.J[0][0][c] + dRi[1][r] * p.J[0][1][c] + dRi[2][r] * p.J[0][2][c];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) {
        JPa[r][c] = p.J[4][r][c] + p.J[2][r][c] * dt - 0.5f * p.dR[r][c] * dt2;
        JPg[r][c] = p.J[3][r][c] + p.J[1][r][c] * dt - 0.5f * dRaJ[r][c] * dt2;
        JVa[r][c] = p.J[2][r][c] - p.dR[r][c] * dt;
        JVg[r][c] = p.J[1][r][c] - dRaJ[r][c] * dt;
        JRg[r][c] = dRiT_J[r][c] - Jr[r][c] * dt;
      }
    float M[3][3];
    matmul3(p.dR, dRi, M);
    normalize_f(M, p.dR);
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        p.J[0][r][c] = JRg[r][c], p.J[1][r][c] = JVg[r][c], p.J[2][r][c] = JVa[r][c], p.J[3][r][c] = JPg[r][c],
        p.J[4][r][c] = JPa[r][c];
    for (int r = 0; r < 3; ++r) p.dV[r] = dV_new[r], p.dP[r] = dP_new[r];
    p.dT += dt;
  }
  if (lane == 0) {
    out[0] = p.dT;
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) {
        out[inr::kOffR + 3 * r + c] = p.dR[r][c];
        for (int k = 0; k < 5; ++k) out[inr::kOffJ + 9 * k + 3 * r + c] = p.J[k][r][c];
      }
      out[inr::kOffV + r] = p.dV[r];
      out[inr::kOffP + r] = p.dP[r];
    }
    for (int k = 0; k < 6; ++k) out[inr::kOffBias + k] = p.bias[k];
  }
  for (int t = lane; t < 225; t += 32) out[inr::kOffC + t] = C[t / 15][t % 15];
}

__device__ void load_p(const float* v, P& p, float (&C)[15][15]) {
  p.dT = v[0];
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) {
      p.dR[r][c] = v[inr::kOffR + 3 * r + c];
      for (int k = 0; k < 5; ++k) p.J[k][r][c] = v[inr::kOffJ + 9 * k + 3 * r + c];
    }
    p.dV[r] = v[inr::kOffV + r];
    p.dP[r] = v[inr::kOffP + r];
  }
  for (int k = 0; k < 6; ++k) p.bias[k] = v[inr::kOffBias + k];
  for (int t = 0; t < 225; ++t) C[t / 15][t % 15] = v[inr::kOffC + t];
}

// preintegration.compose_plain: two consecutive windows as one, one thread.
__global__ void imu_compose_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out) {
  P p1, p2;
  float C1[15][15], C2[15][15];
  load_p(a, p1, C1);
  load_p(b, p2, C2);
  const float dT2 = p2.dT;
  float M[3][3], dR[3][3];
  matmul3(p1.dR, p2.dR, M);
  normalize_f(M, dR);
  float dV[3], dP[3];
  for (int r = 0; r < 3; ++r) {
    const float Rv = p1.dR[r][0] * p2.dV[0] + p1.dR[r][1] * p2.dV[1] + p1.dR[r][2] * p2.dV[2];
    const float Rp = p1.dR[r][0] * p2.dP[0] + p1.dR[r][1] * p2.dP[1] + p1.dR[r][2] * p2.dP[2];
    dV[r] = p1.dV[r] + Rv;
    dP[r] = p1.dP[r] + p1.dV[r] * dT2 + Rp;
  }
  const float HV[3][3] = {{0.f, -p2.dV[2], p2.dV[1]}, {p2.dV[2], 0.f, -p2.dV[0]}, {-p2.dV[1], p2.dV[0], 0.f}};
  const float HP[3][3] = {{0.f, -p2.dP[2], p2.dP[1]}, {p2.dP[2], 0.f, -p2.dP[0]}, {-p2.dP[1], p2.dP[0], 0.f}};
  float R1HV[3][3], R1HP[3][3], R1HVJ[3][3], R1HPJ[3][3], R1J2[5][3][3], R2TJ[3][3];
  matmul3(p1.dR, HV, R1HV);
  matmul3(p1.dR, HP, R1HP);
  matmul3(R1HV, p1.J[0], R1HVJ);
  matmul3(R1HP, p1.J[0], R1HPJ);
  for (int k = 0; k < 5; ++k) matmul3(p1.dR, p2.J[k], R1J2[k]);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      R2TJ[r][c] = p2.dR[0][r] * p1.J[0][0][c] + p2.dR[1][r] * p1.J[0][1][c] + p2.dR[2][r] * p1.J[0][2][c];
  float J[5][3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      J[0][r][c] = R2TJ[r][c] + p2.J[0][r][c];
      J[1][r][c] = p1.J[1][r][c] + R1J2[1][r][c] - R1HVJ[r][c];
      J[2][r][c] = p1.J[2][r][c] + R1J2[2][r][c];
      J[3][r][c] = p1.J[3][r][c] + p1.J[1][r][c] * dT2 + R1J2[3][r][c] - R1HPJ[r][c];
      J[4][r][c] = p1.J[4][r][c] + p1.J[2][r][c] * dT2 + R1J2[4][r][c];
    }
  // F1 = [[dR2^T, 0, 0], [-dR1 hat(dV2), I, 0], [-dR1 hat(dP2), I dT2, I]], G = blockdiag(I, dR1, dR1)
  float F[9][9] = {}, G[9][9] = {};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      F[i][j] = p2.dR[j][i];
      F[3 + i][j] = -R1HV[i][j];
      F[6 + i][j] = -R1HP[i][j];
      G[3 + i][3 + j] = p1.dR[i][j];
      G[6 + i][6 + j] = p1.dR[i][j];
    }
  for (int i = 0; i < 3; ++i) {
    F[3 + i][3 + i] = 1.f;
    F[6 + i][3 + i] = dT2;
    F[6 + i][6 + i] = 1.f;
    G[i][i] = 1.f;
  }
  float FC[9][9], GC[9][9];
  for (int r = 0; r < 9; ++r)
    for (int c = 0; c < 9; ++c) {
      float u = 0.f, v = 0.f;
      for (int k = 0; k < 9; ++k) u += F[r][k] * C1[k][c], v += G[r][k] * C2[k][c];
      FC[r][c] = u, GC[r][c] = v;
    }
  out[0] = p1.dT + dT2;
  for (int r = 0; r < 15; ++r)
    for (int c = 0; c < 15; ++c) {
      float v = 0.f;
      if (r < 9 && c < 9) {
        float u = 0.f, w = 0.f;
        for (int k = 0; k < 9; ++k) u += FC[r][k] * F[c][k], w += GC[r][k] * G[c][k];
        v = u + w;
      } else if (r >= 9 && c >= 9) {
        v = C1[r][c] + C2[r][c];
      }
      out[inr::kOffC + 15 * r + c] = v;
    }
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) {
      out[inr::kOffR + 3 * r + c] = dR[r][c];
      for (int k = 0; k < 5; ++k) out[inr::kOffJ + 9 * k + 3 * r + c] = J[k][r][c];
    }
    out[inr::kOffV + r] = dV[r];
    out[inr::kOffP + r] = dP[r];
  }
  for (int k = 0; k < 6; ++k) out[inr::kOffBias + k] = p1.bias[k];
}

}  // namespace

// start: a packed window to continue (merge), or null to start from the identity at ``bias``; noise: the four
// discrete standard deviations on the host (gyro, acc, gyro walk, acc walk); out: the packed result (292 floats).
extern "C" int imu_preint_launch(const float* start, const float* bias, const float* acc, const float* gyro,
                                 const float* dts, const uint8_t* valid, int n, const float* noise, float* out,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  imu_preint_kernel<<<1, 32, 0, st>>>(start, bias, acc, gyro, dts, valid, n, noise[0], noise[1], noise[2], noise[3],
                                      out);
  return cudaGetLastError();
}

extern "C" int imu_compose_launch(const float* a, const float* b, float* out, void* stream) {
  imu_compose_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(a, b, out);
  return cudaGetLastError();
}
