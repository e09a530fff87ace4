// Kernel X: the IMU initialisation's inertial-only optimisation (gravity
// direction, log-scale, one bias, K velocities; 40 LM iterations) and the
// scale refinement (gravity and log-scale; 20 iterations), one CTA for the
// whole call.  Thread (edge, direction) evaluates EdgeInertialGS along one of
// the edge's 15 (3) tangent directions in dual numbers (inertial.cuh); the
// per-edge terms live in a float64 scratch buffer in global memory; each
// thread owns entries of the P x P normal matrix and sums the edges into
// them in edge order; the damped system is solved by the block's Gaussian
// elimination in dynamic shared memory, or in the scratch when it does not
// fit there (P > kSmemMaxP).  See the source note in optim/imu_init.py.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "inertial.cuh"

namespace {

using sim3::Dual;

constexpr int kThreads = 512;
// The system (P x (P + 1), the parameters, the candidate, the step, 2 more) goes in dynamic shared memory up to this
// many bytes (the card's opt-in limit is 227 KB a block), P <= 159 (K <= 50 keyframes); larger in the scratch.
constexpr size_t kSmemMaxBytes = 200 * 1024;

struct Args {
  const float *R, *p, *pk;
  const uint8_t* ev;
  const float *vel, *bias;  // fixed inputs of the refinement
  int K;
  float prior_gyro, prior_acc;
  int iters, fix_scale, refine;
  double* work;  // the per-edge terms, then (sys_global) the system
  int sys_global;
  float* out;
};

// The local tangent index of global parameter p in edge e (-1 if the edge does not depend on it).
__device__ __forceinline__ int local_index(int p, int e, bool refine) {
  if (p < 9) return refine && p > 2 ? -1 : p;
  const int kv = (p - 9) / 3, c = (p - 9) % 3;
  return kv == e ? 9 + c : (kv == e + 1 ? 12 + c : -1);
}

__device__ void load_pose(const float* R, const float* p, int k, double (&Rk)[3][3], double (&pk)[3]) {
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) Rk[r][c] = R[9 * k + 3 * r + c];
    pk[r] = p[3 * k + r];
  }
}

// The residual of edge e at parameters x, the tangent on local direction l (< 0: none).
__device__ void edge_residual(const Args& a, const double* x, int e, int l, Dual (&r)[9]) {
  double Ri[3][3], pi[3], Rj[3][3], pj[3];
  load_pose(a.R, a.p, e, Ri, pi);
  load_pose(a.R, a.p, e + 1, Rj, pj);
  inr::Delta dl;
  inr::load_delta(a.pk + inr::kPacked * e, dl);
  auto dual = [&](double v, int li) { return Dual{v, li == l ? 1.0 : 0.0}; };
  Dual th[2] = {dual(x[0], 0), dual(x[1], 1)};
  const Dual ls = dual(x[2], 2);
  Dual b[6], vi[3], vj[3];
  for (int k = 0; k < 6; ++k) b[k] = a.refine ? Dual{a.bias[k], 0.0} : dual(x[3 + k], 3 + k);
  for (int k = 0; k < 3; ++k) {
    vi[k] = a.refine ? Dual{a.vel[3 * e + k], 0.0} : dual(x[9 + 3 * e + k], 9 + k);
    vj[k] = a.refine ? Dual{a.vel[3 * (e + 1) + k], 0.0} : dual(x[9 + 3 * (e + 1) + k], 12 + k);
  }
  inr::gs_residual(Ri, pi, Rj, pj, vi, vj, b, th, ls, a.fix_scale && !a.refine, dl, r);
}

__global__ void __launch_bounds__(kThreads) imu_init_kernel(Args a) {
  extern __shared__ double smem[];
  const int K = a.K, E = K - 1, P = a.refine ? 3 : 9 + 3 * K, nl = a.refine ? 3 : 15;
  double* I9 = a.work;                   // E x 81
  double* J = I9 + 81 * E;               // E x 9 x 15
  double* WJ = J + 135 * E;              // E x 9 x 15
  double* r = WJ + 135 * E;              // E x 9
  double* ec = r + 9 * E;                // E: per-edge cost
  double* A = a.sys_global ? ec + E : smem;  // P x (P + 1)
  double* x = A + P * (P + 1);           // P
  double* xc = x + P;                    // P: candidate
  double* dx = xc + P;                   // P
  double* misc = dx + P;                 // lam, cost0
  __shared__ int piv;
  // informations (masked by edge_valid), the start
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    double I[9][9], W[6][6];
    inr::informations(a.pk + inr::kPacked * e, I, W);
    const double m = a.ev[e] ? 1.0 : 0.0;
    for (int t = 0; t < 81; ++t) I9[81 * e + t] = I[t / 9][t % 9] * m;
  }
  if (threadIdx.x == 0) {
    misc[0] = 1e-3;
    for (int k = 0; k < P; ++k) x[k] = 0.0;
    if (!a.refine) {
      // LocalMapping::InitializeIMU's start: gravity from the rotated velocity deltas, velocities from positions
      double dirG[3] = {0.0, 0.0, 0.0};
      for (int e = 0; e < E; ++e) {
        if (!a.ev[e]) continue;
        inr::Delta dl;
        inr::load_delta(a.pk + inr::kPacked * e, dl);
        const double z6[6] = {0, 0, 0, 0, 0, 0};
        double dR[3][3], dV[3], dP[3];
        inr::deltas(dl, z6, dR, dV, dP);
        for (int rr = 0; rr < 3; ++rr)
          dirG[rr] -= a.R[9 * e + 3 * rr] * dV[0] + a.R[9 * e + 3 * rr + 1] * dV[1] + a.R[9 * e + 3 * rr + 2] * dV[2];
      }
      const double nG = fmax(sqrt(dirG[0] * dirG[0] + dirG[1] * dirG[1] + dirG[2] * dirG[2]), 1e-9);
      for (int k = 0; k < 3; ++k) dirG[k] /= nG;
      // axis = (0, 0, -1) x dirG
      const double axis[3] = {dirG[1], -dirG[0], 0.0};
      const double sn = sqrt(axis[0] * axis[0] + axis[1] * axis[1]);
      const double ang = atan2(sn, -dirG[2]);
      if (sn > 1e-6) {
        x[0] = (float)(axis[0] / fmax(sn, 1e-9) * ang);
        x[1] = (float)(axis[1] / fmax(sn, 1e-9) * ang);
      }
      for (int e = 0; e < K; ++e) {
        const int s = e < E ? e : E - 1;
        const double dT = fmax((double)a.pk[inr::kPacked * s], 1e-6);
        for (int k = 0; k < 3; ++k) x[9 + 3 * e + k] = (float)((a.p[3 * (s + 1) + k] - a.p[3 * s + k]) / dT);
      }
    }
  }
  __syncthreads();
  for (int it = 0; it < a.iters; ++it) {
    // residuals and Jacobian columns, edge by direction
    for (int t = threadIdx.x; t < E * nl; t += blockDim.x) {
      const int e = t / nl, l = t % nl;
      Dual rr[9];
      edge_residual(a, x, e, l, rr);
      for (int i = 0; i < 9; ++i) J[135 * e + 15 * i + l] = rr[i].d;
      if (l == 0)
        for (int i = 0; i < 9; ++i) r[9 * e + i] = rr[i].v;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < E * 9 * nl; t += blockDim.x) {
      const int e = t / (9 * nl), i = (t / nl) % 9, l = t % nl;
      double s = 0.0;
      for (int b = 0; b < 9; ++b) s += I9[81 * e + 9 * i + b] * J[135 * e + 15 * b + l];
      WJ[135 * e + 15 * i + l] = s;
    }
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      double c = 0.0;
      for (int i = 0; i < 9; ++i)
        for (int b = 0; b < 9; ++b) c += r[9 * e + i] * I9[81 * e + 9 * i + b] * r[9 * e + b];
      ec[e] = c;
    }
    __syncthreads();
    // H (upper triangle, mirrored) and g, each entry summed over the edges in order
    for (int t = threadIdx.x; t < P * (P + 1); t += blockDim.x) {
      const int pp = t / (P + 1), q = t % (P + 1);
      if (q < P && q < pp) continue;
      int e_lo = 0, e_hi = E - 1;  // a velocity's edges: the two around its state
      if (!a.refine && pp >= 9) e_lo = max(e_lo, (pp - 9) / 3 - 1), e_hi = min(e_hi, (pp - 9) / 3);
      if (!a.refine && q < P && q >= 9) e_lo = max(e_lo, (q - 9) / 3 - 1), e_hi = min(e_hi, (q - 9) / 3);
      double s = 0.0;
      for (int e = e_lo; e <= e_hi; ++e) {
        const int lp = local_index(pp, e, a.refine);
        if (lp < 0) continue;
        if (q < P) {
          const int lq = local_index(q, e, a.refine);
          if (lq < 0) continue;
          for (int i = 0; i < 9; ++i) s += J[135 * e + 15 * i + lp] * WJ[135 * e + 15 * i + lq];
        } else {
          for (int i = 0; i < 9; ++i) s -= WJ[135 * e + 15 * i + lp] * r[9 * e + i];
        }
      }
      if (!a.refine && pp >= 3 && pp < 9) {  // the bias priors (EdgePriorGyro / Acc): 2 prior on H, -2 prior x on g
        const double pr = pp < 6 ? a.prior_gyro : a.prior_acc;
        if (q == pp) s += 2.0 * pr;
        if (q == P) s -= 2.0 * pr * x[pp];
      }
      A[pp * (P + 1) + q] = s;
      if (q < P) A[q * (P + 1) + pp] = s;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      double c = 0.0;
      for (int e = 0; e < E; ++e) c += ec[e];
      if (!a.refine)
        for (int k = 0; k < 3; ++k) c += a.prior_gyro * x[3 + k] * x[3 + k] + a.prior_acc * x[6 + k] * x[6 + k];
      misc[1] = c;
    }
    for (int pp = threadIdx.x; pp < P; pp += blockDim.x)
      A[pp * (P + 1) + pp] += misc[0] * fmax(A[pp * (P + 1) + pp], 1e-6) + 1e-9;
    __syncthreads();
    inr::block_solve(A, P, 1, P + 1, dx, &piv);
    for (int k = threadIdx.x; k < P; k += blockDim.x) xc[k] = (float)(x[k] + dx[k]);
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      Dual rr[9];
      edge_residual(a, xc, e, -1, rr);
      double c = 0.0;
      for (int i = 0; i < 9; ++i)
        for (int b = 0; b < 9; ++b) c += rr[i].v * I9[81 * e + 9 * i + b] * rr[b].v;
      ec[e] = c;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      double c = 0.0;
      for (int e = 0; e < E; ++e) c += ec[e];
      if (!a.refine)
        for (int k = 0; k < 3; ++k) c += a.prior_gyro * xc[3 + k] * xc[3 + k] + a.prior_acc * xc[6 + k] * xc[6 + k];
      const bool accept = c < misc[1];
      if (accept)
        for (int k = 0; k < P; ++k) x[k] = xc[k];
      misc[0] = accept ? fmax(misc[0] * 0.5, 1e-8) : fmin(misc[0] * 5.0, 1e6);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const double w[3] = {x[0], x[1], 0.0};
    double Rwg[3][3];
    jacobi::so3_exp(w, Rwg);
    for (int k = 0; k < 9; ++k) a.out[k] = (float)Rwg[k / 3][k % 3];
    a.out[9] = (a.fix_scale && !a.refine) ? 1.f : (float)exp(x[2]);
    if (!a.refine) {
      for (int k = 0; k < 3 * K; ++k) a.out[10 + k] = (float)x[9 + k];
      for (int k = 0; k < 6; ++k) a.out[10 + 3 * K + k] = (float)x[3 + k];
    }
  }
}

}  // namespace

// R (K,3,3), p (K,3): the chain's fixed body poses; pk: K-1 packed windows; ev: K-1 edge flags; vel (K,3), bias
// (6): the refinement's fixed inputs (null otherwise); prior: gyro and acc bias priors on the host; refine: the
// scale refinement (3 parameters); work: float64 scratch of 361 doubles per edge (information, J, WJ, r, cost) and
// P (P + 1) + 3P + 2 for the system (optim/imu_init.py imu_init_scratch_doubles); out: Rwg (9) | scale | vel (3K) |
// bias (6), or Rwg | scale for the refinement.
extern "C" int imu_init_launch(const float* R, const float* p, const float* pk, const uint8_t* ev, const float* vel,
                               const float* bias, int K, const float* prior, int iters, int fix_scale, int refine,
                               double* work, float* out, void* stream) {
  if (K < 2) return cudaErrorInvalidValue;
  const int P = refine ? 3 : 9 + 3 * K;
  const size_t sys = sizeof(double) * ((size_t)P * (P + 1) + 3 * P + 2);
  const bool in_smem = sys <= kSmemMaxBytes;
  if (in_smem) {
    const cudaError_t err = cudaFuncSetAttribute(imu_init_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)sys);
    if (err != cudaSuccess) return err;
  }
  const Args a = {R, p, pk, ev, vel, bias, K, prior[0], prior[1], iters, fix_scale, refine, work, !in_smem, out};
  imu_init_kernel<<<1, kThreads, in_smem ? sys : 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
