// Kernel Z: Gauss-Newton on the 4-DoF essential graph of an inertial map
// (yaw about gravity and translation per vertex), 12 iterations from one C
// entry point, no host round trip inside the solve.  Per iteration:
//  1. One warp per edge: lane d < 8 evaluates the edge residual
//     log_SE3(T_ij T_jw' T_iw'^-1), T' = _yaw_update(dx, T), at dx = 0 in
//     float64 dual numbers whose tangent is direction d (dx_i's for d < 4,
//     dx_j's after): the value is r (6), the tangent column d of J_i or J_j.
//  2. The solve.  Dense (K <= 128): one CTA, the (4K)^2 normal matrix in
//     global memory, the edges added in their order, the fixed vertices'
//     rows and columns made the identity, the damping added, a right-looking
//     float64 Cholesky and two substitutions; a pivot <= 0 sets the flag
//     and zeroes dx.  PCG (K > 128 or _FORCE_CG): one thread per (edge,
//     entry) forms the per-edge 4x4 blocks, one thread per vertex sums its
//     diagonal block and gradient over its edge list (vptr / vlist) and
//     inverts the damped block by Gauss-Jordan, and one CTA runs the CG
//     iterations with the vectors in global memory; r.z <= 1e-12 freezes x.
//  3. One thread per vertex: R' = R Rz(dx_3)^T, t' = t - R' dx[0:3], R'
//     re-orthonormalised by the 3x3 SVD.
// Every sum has a fixed order and there are no floating-point atomics, so a
// run repeats bit for bit.  Every loop strides by blockDim, so the CTA's
// width is free.  See the source note in optim/pose_graph.py;
// optimize_4dof_graph_plain there is the same function in PyTorch.
#include <cuda_runtime.h>
#include <math.h>

#include "jacobi.cuh"
#include "sim3.cuh"

namespace {

using sim3::Dual;

constexpr int kEdgeWarps = 8;
constexpr int kSolveThreads = 1024;
constexpr int kMaxDense = 128;  // pose_graph.DENSE_MAX_K
constexpr int kJac = 54;        // per edge: r (6) | J_i^T (4 directions x 6 rows) | J_j^T
constexpr int kBlk = 3 * 16 + 8;  // per edge: H_ii | H_jj | H_ij (row-major 4x4) | b_i | b_j

// lie.so3_right_jacobian_inv(w): I + W / 2 + coef W^2, the Taylor coef below theta^2 = 1e-8, the
// denominator 2 theta sin(theta) held off zero by +-1e-8 (a constant there, as torch.where gives).
template <class T>
__device__ void right_jacobian_inv(const T (&w)[3], T (&J)[3][3]) {
  const T th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const T th = sim3::Sqrt(sim3::ClampMin(th2, 1e-16));
  const bool small = sim3::val(th2) < 1e-8;
  const T denom = 2.0 * th * sim3::Sin(th);
  const T safe = fabs(sim3::val(denom)) < 1e-8 ? sim3::cst(sim3::val(denom) < 0.0 ? -1e-8 : 1e-8, th) : denom;
  const T coef = small ? 1.0 / 12.0 + th2 / 720.0 : 1.0 / sim3::ClampMin(th2, 1e-16) - (1.0 + sim3::Cos(th)) / safe;
  const T z = sim3::cst(0.0, th);
  const T W[3][3] = {{z, -w[2], w[1]}, {w[2], z, -w[0]}, {-w[1], w[0], z}};
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      const T w2 = W[r][0] * W[0][c] + W[r][1] * W[1][c] + W[r][2] * W[2][c];
      J[r][c] = (r == c ? 1.0 : 0.0) + 0.5 * W[r][c] + coef * w2;
    }
}

// _yaw_update for a constant pose (R, t) and a dual step: R' = R Rz^T, t' = t - R' d[0:3].
__device__ void yaw_update(const Dual (&d)[4], const double (&R)[3][3], const double (&t)[3], Dual (&Rn)[3][3],
                           Dual (&tn)[3]) {
  const Dual cy = sim3::Cos(d[3]), sy = sim3::Sin(d[3]);
  const Dual z = {0.0, 0.0}, one = {1.0, 0.0};
  const Dual RzT[3][3] = {{cy, sy, z}, {-sy, cy, z}, {z, z, one}};
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) Rn[r][c] = R[r][0] * RzT[0][c] + R[r][1] * RzT[1][c] + R[r][2] * RzT[2][c];
  for (int r = 0; r < 3; ++r) tn[r] = t[r] - (Rn[r][0] * d[0] + Rn[r][1] * d[1] + Rn[r][2] * d[2]);
}

// A pose stored as R (9) | t (3), float32.
__device__ void load_pose(const float* v, double (&R)[3][3], double (&t)[3]) {
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) R[r][c] = v[3 * r + c];
    t[r] = v[9 + r];
  }
}

// One lane of the edge evaluation: the residual log_SE3(T_ij T_j' T_i'^-1) at dx = 0 along direction
// ``lane`` (dx_i's for lane < 4, dx_j's for 4 <= lane < 8); the 6 derivatives to ``col``, the 6 values
// to ``r`` where given.
__device__ void edge_lane4(const float* vi, const float* vj, const float* m, int lane, double* col, double* r) {
  double Ri[3][3], ti[3], Rj[3][3], tj[3], Rm[3][3], tm[3];
  load_pose(vi, Ri, ti);
  load_pose(vj, Rj, tj);
  load_pose(m, Rm, tm);
  Dual di[4], dj[4];
  for (int k = 0; k < 4; ++k) {
    di[k] = {0.0, lane == k ? 1.0 : 0.0};
    dj[k] = {0.0, lane == 4 + k ? 1.0 : 0.0};
  }
  Dual RI[3][3], tI[3], RJ[3][3], tJ[3];
  yaw_update(di, Ri, ti, RI, tI);
  yaw_update(dj, Rj, tj, RJ, tJ);
  Dual RA[3][3], tA[3];  // A = T_ij T_j'
  for (int a = 0; a < 3; ++a) {
    for (int c = 0; c < 3; ++c) RA[a][c] = Rm[a][0] * RJ[0][c] + Rm[a][1] * RJ[1][c] + Rm[a][2] * RJ[2][c];
    tA[a] = (Rm[a][0] * tJ[0] + Rm[a][1] * tJ[1] + Rm[a][2] * tJ[2]) + tm[a];
  }
  Dual RiT[3][3], tiI[3];  // T_i'^-1 = (R^T, -R^T t)
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c) RiT[a][c] = RI[c][a];
  for (int a = 0; a < 3; ++a) tiI[a] = -(RiT[a][0] * tI[0] + RiT[a][1] * tI[1] + RiT[a][2] * tI[2]);
  Dual RB[3][3], tB[3];  // B = A T_i'^-1
  for (int a = 0; a < 3; ++a) {
    for (int c = 0; c < 3; ++c) RB[a][c] = RA[a][0] * RiT[0][c] + RA[a][1] * RiT[1][c] + RA[a][2] * RiT[2][c];
    tB[a] = (RA[a][0] * tiI[0] + RA[a][1] * tiI[1] + RA[a][2] * tiI[2]) + tA[a];
  }
  Dual phi[3];
  sim3::so3_log(RB, phi);
  const Dual mphi[3] = {-phi[0], -phi[1], -phi[2]};
  Dual Jinv[3][3];
  right_jacobian_inv(mphi, Jinv);
  Dual xi[6];
  for (int a = 0; a < 3; ++a) {
    xi[a] = Jinv[a][0] * tB[0] + Jinv[a][1] * tB[1] + Jinv[a][2] * tB[2];
    xi[3 + a] = phi[a];
  }
  for (int k = 0; k < 6; ++k) col[k] = xi[k].d;
  if (r != nullptr)
    for (int k = 0; k < 6; ++k) r[k] = xi[k].v;
}

__global__ void __launch_bounds__(32 * kEdgeWarps)
edge_kernel(const float* __restrict__ verts, const int* __restrict__ ei, const int* __restrict__ ej,
            const float* __restrict__ meas, int n_edges, double* __restrict__ jac) {
  const int e = blockIdx.x * kEdgeWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= n_edges || lane >= 8) return;
  double* out = jac + kJac * e;
  edge_lane4(verts + 12 * ei[e], verts + 12 * ej[e], meas + 12 * e, lane, out + 6 + 6 * lane,
             lane == 0 ? out : nullptr);
}

// ---- the dense branch ----------------------------------------------------------------------------

__global__ void __launch_bounds__(kSolveThreads)
dense_kernel(const int* __restrict__ ei, const int* __restrict__ ej, const float* __restrict__ w,
             const bool* __restrict__ fixed, int K, int n_edges, double damping, const double* __restrict__ jac,
             double* __restrict__ H, double* __restrict__ vec, int* __restrict__ fail) {
  const int n = 4 * K, tid = threadIdx.x, nt = blockDim.x;
  double* b = vec;
  double* x = vec + n;
  __shared__ bool bad;
  __shared__ double xj;
  for (int idx = tid; idx < n * n; idx += nt) H[idx] = 0.0;
  for (int idx = tid; idx < n; idx += nt) b[idx] = 0.0;
  if (tid == 0) bad = false;
  __syncthreads();
  for (int e = 0; e < n_edges; ++e) {  // the edges in their order
    const double we = w[e];
    if (we != 0.0) {
      const double* J = jac + kJac * e;  // J_i^T at J + 6, J_j^T at J + 30: [direction][residual row]
      const int vi = ei[e], vj = ej[e];
      for (int q = tid; q < 72; q += nt) {
        if (q < 64) {  // blocks ii, jj, ij, ji
          const int blk = q / 16, p = (q % 16) / 4, c = q % 4;
          const double* A = J + 6 + 24 * (blk == 1 || blk == 3);  // the row side
          const double* B = J + 6 + 24 * (blk == 1 || blk == 2);  // the column side
          double v = 0.0;
          for (int r = 0; r < 6; ++r) v += A[6 * p + r] * we * B[6 * c + r];
          const int ra = (blk == 1 || blk == 3) ? vj : vi, ca = (blk == 1 || blk == 2) ? vj : vi;
          H[(size_t)(4 * ra + p) * n + 4 * ca + c] += v;
        } else {
          const int side = (q - 64) / 4, p = (q - 64) % 4;
          const double* A = J + 6 + 24 * side;
          double v = 0.0;
          for (int r = 0; r < 6; ++r) v += A[6 * p + r] * we * J[r];
          b[4 * (side ? vj : vi) + p] += v;
        }
      }
    }
    __syncthreads();
  }
  for (int idx = tid; idx < n * n; idx += nt) {  // the gauge and the damping
    const int row = idx / n, column = idx % n;
    const bool fr = fixed[row / 4], fc = fixed[column / 4];
    double v = (fr || fc) ? 0.0 : H[idx];
    if (row == column) v += (fr ? 1.0 : 0.0) + damping;
    H[idx] = v;
  }
  for (int idx = tid; idx < n; idx += nt) x[idx] = fixed[idx / 4] ? 0.0 : -b[idx];
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31, n_warps = (nt + 31) >> 5;
  for (int j = 0; j < n; ++j) {  // Cholesky of the lower triangle in place
    if (tid == 0) {
      const double d = H[(size_t)j * n + j];
      if (!(d > 0.0)) bad = true;
      H[(size_t)j * n + j] = sqrt(fmax(d, 1e-300));
    }
    __syncthreads();
    if (bad) break;
    const double ljj = H[(size_t)j * n + j];
    for (int i = j + 1 + tid; i < n; i += nt) H[(size_t)i * n + j] /= ljj;
    __syncthreads();
    for (int i = j + 1 + warp; i < n; i += n_warps) {
      const double lij = H[(size_t)i * n + j];
      for (int k = j + 1 + lane; k <= i; k += 32) H[(size_t)i * n + k] -= lij * H[(size_t)k * n + j];
    }
    __syncthreads();
  }
  if (bad) {
    for (int idx = tid; idx < n; idx += nt) x[idx] = 0.0;
    if (tid == 0) *fail = 1;
    return;
  }
  for (int j = 0; j < n; ++j) {  // L y = -b
    if (tid == 0) {
      xj = x[j] / H[(size_t)j * n + j];
      x[j] = xj;
    }
    __syncthreads();
    for (int i = j + 1 + tid; i < n; i += nt) x[i] -= H[(size_t)i * n + j] * xj;
    __syncthreads();
  }
  for (int j = n - 1; j >= 0; --j) {  // L^T dx = y
    if (tid == 0) {
      xj = x[j] / H[(size_t)j * n + j];
      x[j] = xj;
    }
    __syncthreads();
    for (int i = tid; i < j; i += nt) x[i] -= H[(size_t)j * n + i] * xj;
    __syncthreads();
  }
  for (int idx = tid; idx < n; idx += nt)
    if (fixed[idx / 4]) x[idx] = 0.0;
}

// ---- the PCG branch ------------------------------------------------------------------------------

// H_ab[p][c] = sum_r (J_a[r][p] w) J_b[r][c]; b_a[p] = sum_r (J_a[r][p] w) r[r]
__global__ void block_kernel(const double* __restrict__ jac, const float* __restrict__ w, int n_edges,
                             double* __restrict__ blk) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_edges * kBlk) return;
  const int e = idx / kBlk, q = idx % kBlk;
  const double we = w[e];
  const double* J = jac + kJac * e;
  double v = 0.0;
  if (we != 0.0) {
    if (q < 48) {
      const int bb = q / 16, p = (q % 16) / 4, c = q % 4;
      const double* A = J + 6 + 24 * (bb == 1);  // row side: J_i for ii and ij, J_j for jj
      const double* B = J + 6 + 24 * (bb >= 1);  // column side: J_i for ii, J_j for jj and ij
      for (int r = 0; r < 6; ++r) v += A[6 * p + r] * we * B[6 * c + r];
    } else {
      const int side = (q - 48) / 4, p = (q - 48) % 4;
      const double* A = J + 6 + 24 * side;
      for (int r = 0; r < 6; ++r) v += A[6 * p + r] * we * J[r];
    }
  }
  blk[(size_t)kBlk * e + q] = v;
}

// Per vertex: b and the diagonal block over its edge list in order, inv(D + damping I + 1e-8 I) (I where
// fixed) by Gauss-Jordan with partial pivoting; a zero or non-finite pivot sets the flag.
__global__ void vertex_kernel(const double* __restrict__ blk, const int* __restrict__ vptr,
                              const int* __restrict__ vlist, const bool* __restrict__ fixed, int K, double damping,
                              double* __restrict__ b, double* __restrict__ Dinv, int* __restrict__ fail) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  double D[4][8], g[4] = {};
  for (int a = 0; a < 4; ++a)
    for (int c = 0; c < 4; ++c) D[a][c] = 0.0;
  for (int s = vptr[k]; s < vptr[k + 1]; ++s) {
    const int e = vlist[s] >> 1, side = vlist[s] & 1;
    const double* H = blk + (size_t)kBlk * e + 16 * side;  // H_ii at the edge's i end, H_jj at its j end
    const double* bb = blk + (size_t)kBlk * e + 48 + 4 * side;
    for (int a = 0; a < 4; ++a) {
      for (int c = 0; c < 4; ++c) D[a][c] += H[4 * a + c];
      g[a] += bb[a];
    }
  }
  for (int a = 0; a < 4; ++a) {
    b[4 * k + a] = g[a];
    for (int c = 0; c < 4; ++c) {
      const double v = fixed[k] ? (a == c ? 1.0 : 0.0) : D[a][c] + (a == c ? damping : 0.0);
      D[a][c] = v + (a == c ? 1e-8 : 0.0);
      D[a][4 + c] = a == c ? 1.0 : 0.0;
    }
  }
  for (int c = 0; c < 4; ++c) {
    int piv = c;
    for (int a = c + 1; a < 4; ++a)
      if (fabs(D[a][c]) > fabs(D[piv][c])) piv = a;
    if (!(fabs(D[piv][c]) > 0.0) || !isfinite(D[piv][c])) {
      *fail = 1;
      return;
    }
    if (piv != c)
      for (int q = 0; q < 8; ++q) {
        const double tmp = D[c][q];
        D[c][q] = D[piv][q];
        D[piv][q] = tmp;
      }
    const double inv = 1.0 / D[c][c];
    for (int q = 0; q < 8; ++q) D[c][q] *= inv;
    for (int a = 0; a < 4; ++a) {
      if (a == c) continue;
      const double f = D[a][c];
      for (int q = 0; q < 8; ++q) D[a][q] -= f * D[c][q];
    }
  }
  for (int a = 0; a < 4; ++a)
    for (int c = 0; c < 4; ++c) Dinv[16 * k + 4 * a + c] = D[a][4 + c];
}

// The block's sum of one value per thread: warp butterflies, then the warp sums in order by thread 0.
__device__ __forceinline__ double block_sum(double v, double* red, double* total) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < (int)((blockDim.x + 31) >> 5); ++w) s += red[w];
    *total = s;
  }
  __syncthreads();
  return *total;
}

// Row (k, a) of H p: damping p plus the row's edge blocks over the vertex's edge list in order.
__device__ __forceinline__ double h_row(const double* __restrict__ blk, const int* __restrict__ ei,
                                        const int* __restrict__ ej, const int* __restrict__ vptr,
                                        const int* __restrict__ vlist, const double* __restrict__ p, int k, int a,
                                        double damping) {
  double out = damping * p[4 * k + a];
  for (int s = vptr[k]; s < vptr[k + 1]; ++s) {
    const int e = vlist[s] >> 1, side = vlist[s] & 1;
    const double* Hb = blk + (size_t)kBlk * e;
    const double* pi = p + 4 * ei[e];
    const double* pj = p + 4 * ej[e];
    double t1 = 0.0, t2 = 0.0;
    if (side == 0) {  // H_ii p_i + H_ij p_j
      for (int c = 0; c < 4; ++c) t1 += Hb[4 * a + c] * pi[c];
      for (int c = 0; c < 4; ++c) t2 += Hb[32 + 4 * a + c] * pj[c];
    } else {  // H_jj p_j + H_ij^T p_i
      for (int c = 0; c < 4; ++c) t1 += Hb[16 + 4 * a + c] * pj[c];
      for (int c = 0; c < 4; ++c) t2 += Hb[32 + 4 * c + a] * pi[c];
    }
    out += t1 + t2;
  }
  return out;
}

__device__ __forceinline__ double precond_row(const double* __restrict__ Dinv, const double* __restrict__ r, int k,
                                              int a) {
  double z = 0.0;
  for (int c = 0; c < 4; ++c) z += Dinv[16 * k + 4 * a + c] * r[4 * k + c];
  return z;
}

__global__ void __launch_bounds__(kSolveThreads)
pcg_kernel(const double* __restrict__ blk, const int* __restrict__ ei, const int* __restrict__ ej,
           const int* __restrict__ vptr, const int* __restrict__ vlist, const bool* __restrict__ fixed, int K,
           double damping, int cg_iters, const int* __restrict__ fail, double* __restrict__ vec,
           int* __restrict__ cg_run) {
  __shared__ double red[kSolveThreads / 32];
  __shared__ double total;
  const int n = 4 * K, tid = threadIdx.x, nt = blockDim.x;
  const double* b = vec;
  double* x = vec + n;
  double* r = vec + 2 * n;
  double* z = vec + 3 * n;
  double* p = vec + 4 * n;
  double* Ap = vec + 5 * n;
  const double* Dinv = vec + 6 * n;
  const bool bad = *fail != 0;
  for (int row = tid; row < n; row += nt) {
    x[row] = 0.0;
    r[row] = fixed[row / 4] || bad ? 0.0 : -b[row];
  }
  __syncthreads();
  double part = 0.0;
  for (int row = tid; row < n; row += nt) {
    const int k = row / 4;
    const double zr = fixed[k] || bad ? 0.0 : precond_row(Dinv, r, k, row % 4);
    z[row] = zr;
    p[row] = zr;
    part += r[row] * zr;
  }
  double rz = block_sum(part, red, &total);
  int it = 0;
  for (; it < cg_iters && rz > 1e-12; ++it) {  // past the freeze x no longer moves
    part = 0.0;
    for (int row = tid; row < n; row += nt) {
      const int k = row / 4;
      const double h = fixed[k] ? 0.0 : h_row(blk, ei, ej, vptr, vlist, p, k, row % 4, damping);
      Ap[row] = h;
      part += p[row] * h;
    }
    const double pAp = block_sum(part, red, &total);
    const double alpha = rz / fmax(pAp, 1e-20);
    for (int row = tid; row < n; row += nt) {
      x[row] += alpha * p[row];
      r[row] -= alpha * Ap[row];
    }
    __syncthreads();  // a row's z reads the 4 entries of r of its vertex
    part = 0.0;
    for (int row = tid; row < n; row += nt) {
      const int k = row / 4;
      const double zr = fixed[k] ? 0.0 : precond_row(Dinv, r, k, row % 4);
      z[row] = zr;
      part += r[row] * zr;
    }
    const double rz_new = block_sum(part, red, &total);
    const double beta = rz_new / fmax(rz, 1e-20);
    for (int row = tid; row < n; row += nt) p[row] = z[row] + beta * p[row];
    __syncthreads();  // the next H p reads p across vertices
    rz = rz_new;
  }
  if (tid == 0) *cg_run = it;
}

// ---- the update ----------------------------------------------------------------------------------

__global__ void update_kernel(float* __restrict__ verts, const double* __restrict__ dx, int K) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  double R[3][3], t[3];
  load_pose(verts + 12 * k, R, t);
  const double* d = dx + 4 * k;
  const double cy = cos(d[3]), sy = sin(d[3]);
  const double RzT[3][3] = {{cy, sy, 0.0}, {-sy, cy, 0.0}, {0.0, 0.0, 1.0}};
  double Rn[3][3], tn[3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) Rn[r][c] = R[r][0] * RzT[0][c] + R[r][1] * RzT[1][c] + R[r][2] * RzT[2][c];
  for (int r = 0; r < 3; ++r) tn[r] = t[r] - (Rn[r][0] * d[0] + Rn[r][1] * d[1] + Rn[r][2] * d[2]);
  double U[3][3], sv[3], V[3][3];
  jacobi::svd3(Rn, U, sv, V);
  jacobi::udv(U, jacobi::det3(U) * jacobi::det3(V), V, R);
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) verts[12 * k + 3 * r + c] = (float)R[r][c];
    verts[12 * k + 9 + r] = (float)tn[r];
  }
}

}  // namespace

// verts (K, 12) R | t; meas (E, 12); jac (E, 54) float64 scratch.  Dense (pcg = 0, K <= 128): H (4K)^2 and
// vec (2 x 4K: b | dx).  PCG: H holds the per-edge blocks (E, 56), vec 6 x 4K (b | x | r | z | p | Ap) and the
// preconditioner (K, 16); vptr / vlist the vertices' edge lists (pose_graph.vertex_csr); cg_run (iters) the CG
// iterations each step ran.  fail is zeroed by the caller.
extern "C" int pose_graph4_launch(const float* verts_in, const int* ei, const int* ej, const float* meas,
                                  const float* w, const bool* fixed, const int* vptr, const int* vlist, int K,
                                  int n_edges, int iters, int pcg, int cg_iters, double damping, float* verts,
                                  double* jac, double* H, double* vec, int* cg_run, int* fail, void* stream) {
  if (K < 1 || n_edges < 0 || iters < 0 || cg_iters < 0 || (!pcg && K > kMaxDense)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(verts, verts_in, sizeof(float) * 12 * K, cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return err;
  const int n = 4 * K;
  for (int it = 0; it < iters; ++it) {
    if (n_edges > 0)
      edge_kernel<<<(n_edges + kEdgeWarps - 1) / kEdgeWarps, 32 * kEdgeWarps, 0, st>>>(verts, ei, ej, meas, n_edges,
                                                                                          jac);
    if (pcg) {
      if (n_edges > 0) block_kernel<<<(n_edges * kBlk + 255) / 256, 256, 0, st>>>(jac, w, n_edges, H);
      vertex_kernel<<<(K + 127) / 128, 128, 0, st>>>(H, vptr, vlist, fixed, K, damping, vec, vec + 6 * n, fail);
      pcg_kernel<<<1, kSolveThreads, 0, st>>>(H, ei, ej, vptr, vlist, fixed, K, damping, cg_iters, fail, vec,
                                             cg_run + it);
    } else {
      dense_kernel<<<1, kSolveThreads, 0, st>>>(ei, ej, w, fixed, K, n_edges, damping, jac, H, vec, fail);
    }
    update_kernel<<<(K + 127) / 128, 128, 0, st>>>(verts, vec + n, K);
  }
  return cudaGetLastError();
}
