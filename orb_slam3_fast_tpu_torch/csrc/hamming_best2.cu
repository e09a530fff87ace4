// Kernel C: gated Hamming best / second-best on packed descriptors, one warp
// per row, the (N, M) matrix never written.  See the source note in
// ops/hamming.py; hamming_best2_plain there is the same function in PyTorch.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kStereo = 0;
constexpr int kWindow = 1;
constexpr float kBig = 10000.f;      // soft-gate penalty scale (stereo)
constexpr float kInfDist = 10000.f;  // masked-out distance (window)
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Top2 {
  float v1;
  int i1;
  float v2;
  int i2;
};

// lexicographic (value, index): ties go to the lower index, as argmin
__device__ __forceinline__ bool lex_less(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

__device__ __forceinline__ void push(Top2& t, float v, int j) {
  if (lex_less(v, j, t.v1, t.i1)) {
    t.v2 = t.v1;
    t.i2 = t.i1;
    t.v1 = v;
    t.i1 = j;
  } else if (lex_less(v, j, t.v2, t.i2)) {
    t.v2 = v;
    t.i2 = j;
  }
}

__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  if (lex_less(b.v1, b.i1, a.v1, a.i1)) {
    const Top2 tmp = a;
    a = b;
    b = tmp;
  }
  // a holds the best; the second is the better of a's second and b's best
  if (lex_less(b.v1, b.i1, a.v2, a.i2)) {
    a.v2 = b.v1;
    a.i2 = b.i1;
  }
  return a;
}

__device__ __forceinline__ int hamming(const int4& a0, const int4& a1, const int4& b0,
                                       const int4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

__global__ void __launch_bounds__(32 * kWarps)
hamming_best2_kernel(const int4* __restrict__ desc_a, const int4* __restrict__ desc_b, int n,
                     int m, int mode, const float* __restrict__ row_f,
                     const float* __restrict__ col_f, float max_disp, int* __restrict__ idx,
                     float* __restrict__ dist, float* __restrict__ dist2,
                     int* __restrict__ idx2, unsigned long long* __restrict__ col_key) {
  extern __shared__ unsigned long long s_col[];  // stereo: per-column (value, row) minimum
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (mode == kStereo) {
    for (int j = threadIdx.x; j < m; j += blockDim.x) s_col[j] = ~0ull;
    __syncthreads();
  }
  if (row < n) {
    const int4 a0 = desc_a[2 * row], a1 = desc_a[2 * row + 1];
    const float r0 = row_f[5 * row], r1 = row_f[5 * row + 1], r2 = row_f[5 * row + 2];
    const float r3 = row_f[5 * row + 3], r4 = row_f[5 * row + 4];
    Top2 t = {INFINITY, INT_MAX, INFINITY, INT_MAX};
    for (int j = lane; j < m; j += 32) {
      const int d = hamming(a0, a1, __ldg(&desc_b[2 * j]), __ldg(&desc_b[2 * j + 1]));
      const float c0 = col_f[5 * j], c1 = col_f[5 * j + 1], c2 = col_f[5 * j + 2];
      const float c3 = col_f[5 * j + 3], c4 = col_f[5 * j + 4];
      float v;
      if (mode == kStereo) {
        // row = [xl, yl, level, valid, -], col = [xr, yr, band, level, valid];
        // the reference's relu penalties, summed in its order
        float pen = fmaxf(r1 - (c1 + c2), 0.f);
        pen = pen + fmaxf((c1 - c2) - r1, 0.f);
        pen = pen + fmaxf((c0 + 1.f) - r0, 0.f);
        pen = pen + fmaxf(r0 - (c0 + max_disp), 0.f);
        pen = pen + fmaxf(fabsf(r2 - c3) - 1.f, 0.f);
        pen = pen + (1.f - r3);
        pen = pen + (1.f - c4);
        v = __fadd_rn((float)d, __fmul_rn(kBig, pen));
        const unsigned long long key =
            ((unsigned long long)__float_as_uint(v + 0.f) << 32) | (unsigned)row;
        atomicMin(&s_col[j], key);
      } else {
        // row = [u, v, radius, pred_level, valid], col = [x, y, level, valid, -]
        const bool ok = fabsf(r0 - c0) <= r2 && fabsf(r1 - c1) <= r2 && c2 >= r3 - 1.f &&
                        c2 <= r3 + 1.f && r4 > 0.5f && c3 > 0.5f;
        v = ok ? (float)d : kInfDist;
      }
      push(t, v, j);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      Top2 o;
      o.v1 = __shfl_xor_sync(kFull, t.v1, s);
      o.i1 = __shfl_xor_sync(kFull, t.i1, s);
      o.v2 = __shfl_xor_sync(kFull, t.v2, s);
      o.i2 = __shfl_xor_sync(kFull, t.i2, s);
      t = merge(t, o);
    }
    if (lane == 0) {
      // second-best as argmin of the row with the best set to the excluded
      // value (INF_DIST when masked, +inf when penalised)
      const float excl = mode == kStereo ? INFINITY : kInfDist;
      const bool keep = lex_less(t.v2, t.i2, excl, t.i1);
      idx[row] = t.i1;
      dist[row] = t.v1;
      dist2[row] = keep ? t.v2 : excl;
      idx2[row] = keep ? t.i2 : t.i1;
    }
  }
  if (mode == kStereo) {
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x)
      if (s_col[j] != ~0ull) atomicMin(&col_key[j], s_col[j]);
  }
}

}  // namespace

extern "C" int hamming_best2_launch(const int* desc_a, const int* desc_b, int n, int m, int mode,
                                    const float* row_f, const float* col_f, float max_disp,
                                    int* idx, float* dist, float* dist2, int* idx2,
                                    long long* col_key, void* stream) {
  if (n > 0) {
    const int grid = (n + kWarps - 1) / kWarps;
    const size_t smem = mode == kStereo ? (size_t)m * sizeof(unsigned long long) : 0;
    hamming_best2_kernel<<<grid, 32 * kWarps, smem, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const int4*>(desc_a), reinterpret_cast<const int4*>(desc_b), n, m, mode,
        row_f, col_f, max_disp, idx, dist, dist2, idx2,
        reinterpret_cast<unsigned long long*>(col_key));
  }
  return cudaGetLastError();
}
