// Kernel AD: the epilogue of a gated best-2 search (threshold, ratio, mutual
// check, per-column dedup, rotation histogram, stereo median prune and
// depth) in one CTA, on kernel C's outputs.  See the source note in
// ops/hamming.py; match_epilogue_plain there is the same function in
// PyTorch.  Every product and quotient is one float32 rounding (no FMA
// contraction), as in the JAX package, so the masks agree bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
// stage flags (ops/hamming.py _AD_LE ... _AD_STEREO)
constexpr int kLe = 1;
constexpr int kRatio = 2;
constexpr int kMutual = 4;
constexpr int kDedup = 8;
constexpr int kRotation = 16;
constexpr int kStereo = 32;
constexpr int kHisto = 30;                   // HISTO_LENGTH
constexpr float kThHigh = 100.f;             // TH_HIGH: the median where it is NaN
constexpr int kMaxShared = 48 * 1024;        // dynamic shared memory without an opt-in
// the opt-in limit, sm_90's 227 KB less 1 KB for the static buffers below:
// 28,928 dedup columns, a sort of 32,768 stereo rows
constexpr int kMaxOptIn = 227 * 1024 - 1024;
// float32 of the JAX package's Python doubles 2 pi and 30 / (2 pi)
constexpr float kTwoPi = (float)(2.0 * 3.141592653589793);
constexpr float kBinScale = (float)(30.0 / (2.0 * 3.141592653589793));

__device__ __forceinline__ float load_dist(const void* d, int f32, int i) {
  return f32 ? static_cast<const float*>(d)[i] : (float)static_cast<const int*>(d)[i];
}

// the histogram bin of angle_a - angle_b: jnp.mod (fmod, then + 2 pi where
// the remainder is non-zero and negative), * 30 / (2 pi), rounded half to
// even, clipped to [0, 30], mod 30
__device__ __forceinline__ int rotation_bin(float a, float b) {
  float r = fmodf(__fsub_rn(a, b), kTwoPi);
  if (r != 0.f && r < 0.f) r = __fadd_rn(r, kTwoPi);
  int bin = (int)rintf(__fmul_rn(r, kBinScale));
  bin = bin < 0 ? 0 : (bin > kHisto ? kHisto : bin);
  return bin % kHisto;
}

__global__ void __launch_bounds__(kThreads)
match_epilogue_kernel(int n, int m, int flags, const long long* __restrict__ idx,
                      const void* __restrict__ dist, const void* __restrict__ dist2, int dist_f32,
                      const long long* __restrict__ col, const float* __restrict__ angle_a,
                      const float* __restrict__ angle_b, const float* __restrict__ xy_l,
                      const float* __restrict__ xy_r, float th, float ratio, float bf, bool* __restrict__ accept,
                      float* __restrict__ right_u, float* __restrict__ depth) {
  extern __shared__ unsigned long long keys[];  // the dedup keys or the median's sort
  __shared__ int s_counts[kHisto];
  __shared__ int s_top[3];
  __shared__ int s_n_acc;
  const int tid = threadIdx.x, nt = blockDim.x;

  // threshold, ratio, mutual: per row, no exchange
  for (int i = tid; i < n; i += nt) {
    const float d = load_dist(dist, dist_f32, i);
    bool a = (flags & kLe) ? d <= th : d < th;
    if (flags & kRatio) a = a && d < __fmul_rn(ratio, load_dist(dist2, dist_f32, i));
    if (flags & kMutual) a = a && (col[idx[i]] & 0xFFFFFFFFll) == (long long)i;
    accept[i] = a;
  }

  // dedup: per target column the lowest (distance, row) among the accepted rows
  if (flags & kDedup) {
    for (int j = tid; j < m; j += nt) keys[j] = ~0ull;
    __syncthreads();
    for (int i = tid; i < n; i += nt)
      if (accept[i]) {
        const float d = load_dist(dist, dist_f32, i);
        atomicMin(&keys[idx[i]], ((unsigned long long)__float_as_uint(d + 0.f) << 32) | (unsigned)i);
      }
    __syncthreads();
    for (int i = tid; i < n; i += nt)
      if (accept[i]) {
        const float d = load_dist(dist, dist_f32, i);
        accept[i] = keys[idx[i]] == (((unsigned long long)__float_as_uint(d + 0.f) << 32) | (unsigned)i);
      }
    __syncthreads();  // the buffer is free again
  }

  // rotation histogram: the accepted rows' bins, the top 3 by (count
  // descending, bin ascending), the second and third only at >= 0.1x the
  // first, every kept bin only with a count > 0
  if (flags & kRotation) {
    if (tid < kHisto) s_counts[tid] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += nt)
      if (accept[i]) atomicAdd(&s_counts[rotation_bin(angle_a[i], angle_b[idx[i]])], 1);
    __syncthreads();
    if (tid == 0) {
      int top[3], val[3];
      for (int k = 0; k < 3; ++k) {
        int best = -1;
        for (int h = 0; h < kHisto; ++h) {
          if ((k > 0 && h == top[0]) || (k > 1 && h == top[1])) continue;
          if (best < 0 || s_counts[h] > s_counts[best]) best = h;
        }
        top[k] = best;
        val[k] = s_counts[best];
      }
      const float tenth = __fmul_rn(0.1f, (float)val[0]);
      s_top[0] = val[0] > 0 ? top[0] : -1;
      s_top[1] = ((float)val[1] >= tenth && val[1] > 0) ? top[1] : -1;
      s_top[2] = ((float)val[2] >= tenth && val[2] > 0) ? top[2] : -1;
    }
    __syncthreads();
    for (int i = tid; i < n; i += nt)
      if (accept[i]) {
        const int bin = rotation_bin(angle_a[i], angle_b[idx[i]]);
        accept[i] = bin == s_top[0] || bin == s_top[1] || bin == s_top[2];
      }
  }

  // stereo: the median of the distances (jnp.median: NaN unless every slot
  // is accepted, read as TH_HIGH), the 2.1x prune, right u and the depth
  if (flags & kStereo) {
    if (tid == 0) s_n_acc = 0;
    __syncthreads();
    int mine = 0;
    for (int i = tid; i < n; i += nt) mine += accept[i] ? 1 : 0;
    if (mine) atomicAdd(&s_n_acc, mine);
    __syncthreads();
    float med = kThHigh;
    if (n > 0 && s_n_acc == n) {
      float* s = reinterpret_cast<float*>(keys);
      int p = 1;
      while (p < n) p <<= 1;
      for (int j = tid; j < p; j += nt) s[j] = j < n ? load_dist(dist, dist_f32, j) : INFINITY;
      __syncthreads();
      // bitonic sort, ascending
      for (int k = 2; k <= p; k <<= 1)
        for (int j = k >> 1; j > 0; j >>= 1) {
          for (int t = tid; t < p; t += nt) {
            const int u = t ^ j;
            if (u > t) {
              const float x = s[t], y = s[u];
              if (((t & k) == 0) ? x > y : x < y) {
                s[t] = y;
                s[u] = x;
              }
            }
          }
          __syncthreads();
        }
      med = __fmul_rn(__fadd_rn(s[(n - 1) / 2], s[n / 2]), 0.5f);
    }
    const float cut = __fmul_rn(2.1f, med);
    for (int i = tid; i < n; i += nt) {
      const float ur = xy_r[2 * idx[i]];
      const float z = __fdiv_rn(bf, fmaxf(__fsub_rn(xy_l[2 * i], ur), 1.f));
      const bool a = accept[i] && load_dist(dist, dist_f32, i) <= cut && z > 0.f && z < 1e6f;
      accept[i] = a;
      right_u[i] = a ? ur : -1.f;
      depth[i] = a ? z : -1.f;
    }
  }
}

}  // namespace

extern "C" int match_epilogue_launch(int n, int m, int flags, const long long* idx, const void* dist,
                                     const void* dist2, int dist_f32, const long long* col,
                                     const float* angle_a, const float* angle_b, const float* xy_l,
                                     const float* xy_r, float th, float ratio, float bf, bool* accept,
                                     float* right_u, float* depth, void* stream) {
  if (n > 0) {
    size_t need = (flags & kDedup) ? (size_t)m * 8 : 0;
    if (flags & kStereo) {
      size_t p = 1;
      while (p < (size_t)n) p <<= 1;
      need = need > 4 * p ? need : 4 * p;
    }
    if (need > (size_t)kMaxOptIn) return cudaErrorInvalidValue;
    if (need > (size_t)kMaxShared) {  // one value for every call, so concurrent launches agree
      const cudaError_t err =
          cudaFuncSetAttribute(match_epilogue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxOptIn);
      if (err != cudaSuccess) return err;
    }
    match_epilogue_kernel<<<1, kThreads, need, static_cast<cudaStream_t>(stream)>>>(
        n, m, flags, idx, dist, dist2, dist_f32, col, angle_a, angle_b, xy_l, xy_r, th, ratio, bf, accept, right_u,
        depth);
  }
  return cudaGetLastError();
}
