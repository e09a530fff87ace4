// Kernel I: keypoint selection over all pyramid levels of one image (the
// best 8 of every 32x32 cell, then the best n_l of each level under the
// rank priority) and the parabolic subpixel offsets of the chosen points.
// See the source note in ops/extractor.py; select_subpixel_plain there is
// the same function in PyTorch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kCell = 32;
constexpr int kCellPix = kCell * kCell;
constexpr int kTopThreads = 256;
constexpr int kPerThread = kCellPix / kTopThreads;  // 4
constexpr int kSortThreads = 1024;

struct Levels {
  int n;
  int h[kMaxLevels], w[kMaxLevels], gw[kMaxLevels];
  int cell0[kMaxLevels], ncell[kMaxLevels];  // first cell of each level, cells per level
  int n_sel[kMaxLevels], slot0[kMaxLevels];  // budget and first output slot of each level
  long long off[kMaxLevels];                 // element offset of each level in the flat maps
  float scale[kMaxLevels];                   // level-0 pixels per level pixel
};

// float -> uint32 whose unsigned order is the float order (-0 taken as +0)
__device__ __forceinline__ uint32_t ordered(float v) {
  const uint32_t u = __float_as_uint(v + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// (1) One CTA per 32x32 cell of any level: its best K pixels of the NMS map
// (zero outside the level), largest first, ties to the lower in-cell index
// (lax.top_k's order).  Key = (value, 1023 - index): a total order, K
// rounds of a block-wide max, the winner removed each round.
__global__ void __launch_bounds__(kTopThreads)
cell_top_kernel(const float* __restrict__ nms, Levels L, int K, float* __restrict__ cand_v,
                int* __restrict__ cand_i) {
  __shared__ unsigned long long red[kTopThreads / 32];
  __shared__ unsigned long long win;
  const int cg = blockIdx.x;
  int l = 0;
  while (l + 1 < L.n && cg >= L.cell0[l + 1]) ++l;
  const int c = cg - L.cell0[l];
  const int h = L.h[l], w = L.w[l];
  const int cy = c / L.gw[l], cx = c % L.gw[l];
  const float* map = nms + L.off[l];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float val[kPerThread];
  unsigned long long key[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int j = tid + q * kTopThreads;
    const int y = cy * kCell + j / kCell, x = cx * kCell + j % kCell;
    val[q] = (y < h && x < w) ? map[y * w + x] : 0.f;
    key[q] = (static_cast<unsigned long long>(ordered(val[q])) << 32) | (0xFFFFFFFFu - j);
  }
  for (int r = 0; r < K; ++r) {
    unsigned long long best = 0;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) best = key[q] > best ? key[q] : best;
    best = warp_max(best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      unsigned long long v = lane < kTopThreads / 32 ? red[lane] : 0;
      v = warp_max(v);
      if (lane == 0) win = v;
    }
    __syncthreads();
    const unsigned long long wk = win;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      if (key[q] == wk) {  // keys are unique: exactly one owner
        cand_v[cg * K + r] = val[q];
        cand_i[cg * K + r] = tid + q * kTopThreads;
        key[q] = 0;
      }
    }
  }
}

// (2) One CTA per level: sort its cells' candidates by (priority asc, flat
// index asc) -- priority rank * 1e6 - min(v, 0.99e6), +inf where v <= 0 --
// with a bitonic sort in shared memory, take the first n_l, clamp them into
// the descriptor border and refine them on the dense pre-NMS map.
__global__ void __launch_bounds__(kSortThreads)
level_select_kernel(const float* __restrict__ cand_v, const int* __restrict__ cand_i, const float* __restrict__ raw,
                    Levels L, int K, int border, int* __restrict__ xy_lvl, float* __restrict__ xy,
                    float* __restrict__ resp, bool* __restrict__ valid) {
  extern __shared__ unsigned long long s[];
  const int l = blockIdx.x;
  const int nc = L.ncell[l] * K;
  const int base = L.cell0[l] * K;
  int P = 1;
  while (P < nc) P <<= 1;
  const uint32_t inf_key = ordered(INFINITY);
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    unsigned long long k = ~0ull;
    if (i < nc) {
      const float v = cand_v[base + i];
      const float prio = v > 0.f ? __fsub_rn(__fmul_rn(static_cast<float>(i % K), 1.0e6f), fminf(v, 0.99e6f))
                                 : INFINITY;
      k = (static_cast<unsigned long long>(ordered(prio)) << 32) | static_cast<uint32_t>(i);
    }
    s[i] = k;
  }
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int p = i ^ j;
        if (p > i) {
          const unsigned long long a = s[i], b = s[p];
          if ((a > b) == ((i & k) == 0)) {
            s[i] = b;
            s[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const int h = L.h[l], w = L.w[l];
  const float* map = raw + L.off[l];
  for (int j = threadIdx.x; j < L.n_sel[l]; j += blockDim.x) {
    const unsigned long long k = s[j];
    const int i = static_cast<int>(k & 0xFFFFFFFFu);
    const int c = i / K;
    const int jj = cand_i[base + i];
    const int px = (c % L.gw[l]) * kCell + jj % kCell, py = (c / L.gw[l]) * kCell + jj / kCell;
    const int x = min(max(px, border), w - border - 1), y = min(max(py, border), h - border - 1);
    // parabolic offsets in the plain version's operation order
    const float cc = map[y * w + x];
    const float xm = map[y * w + max(x - 1, 0)], xp = map[y * w + min(x + 1, w - 1)];
    const float ym = map[max(y - 1, 0) * w + x], yp = map[min(y + 1, h - 1) * w + x];
    const float dx_den = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, cc), xp), xm);
    const float dy_den = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, cc), yp), ym);
    float ox = dx_den > 1e-6f ? __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(xp, xm)), fmaxf(dx_den, 1e-6f)) : 0.f;
    float oy = dy_den > 1e-6f ? __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(yp, ym)), fmaxf(dy_den, 1e-6f)) : 0.f;
    ox = fminf(fmaxf(ox, -0.5f), 0.5f);
    oy = fminf(fmaxf(oy, -0.5f), 0.5f);
    const int slot = L.slot0[l] + j;
    xy_lvl[2 * slot] = x;
    xy_lvl[2 * slot + 1] = y;
    xy[2 * slot] = __fmul_rn(__fadd_rn(static_cast<float>(x), ox), L.scale[l]);
    xy[2 * slot + 1] = __fmul_rn(__fadd_rn(static_cast<float>(y), oy), L.scale[l]);
    resp[slot] = cand_v[base + i];
    valid[slot] = static_cast<uint32_t>(k >> 32) != inf_key;
  }
}

}  // namespace

// nms, raw: flat per-image maps of all levels; shapes: host (n_levels, 2)
// [h, w]; offs: host (n_levels,) offsets into them; n_sel: host (n_levels,)
// budgets; scales: host (n_levels,) level-0 pixels per level pixel.
// cand_v / cand_i: scratch of (cells over all levels) * K.  Outputs in the
// slot order of the budgets: xy_lvl (N,2) int32, xy (N,2), resp (N,), valid.
extern "C" int select_subpixel_launch(const float* nms, const float* raw, const int* shapes, const long long* offs,
                                      const int* n_sel, const float* scales, int n_levels, int cell, int K,
                                      int border, float* cand_v, int* cand_i, int* xy_lvl, float* xy, float* resp,
                                      bool* valid, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || cell != kCell || K < 1 || K > kCellPix) return cudaErrorInvalidValue;
  Levels L;
  L.n = n_levels;
  int cells = 0, slots = 0, max_cand = 1;
  for (int l = 0; l < n_levels; ++l) {
    L.h[l] = shapes[2 * l];
    L.w[l] = shapes[2 * l + 1];
    L.gw[l] = (L.w[l] + kCell - 1) / kCell;
    L.cell0[l] = cells;
    L.ncell[l] = L.gw[l] * ((L.h[l] + kCell - 1) / kCell);
    L.n_sel[l] = n_sel[l];
    L.slot0[l] = slots;
    L.off[l] = offs[l];
    L.scale[l] = scales[l];
    if (n_sel[l] > L.ncell[l] * K || L.h[l] < 2 * border + 1 || L.w[l] < 2 * border + 1) return cudaErrorInvalidValue;
    cells += L.ncell[l];
    slots += n_sel[l];
    max_cand = max(max_cand, L.ncell[l] * K);
  }
  int P = 1;
  while (P < max_cand) P <<= 1;
  const size_t smem = static_cast<size_t>(P) * sizeof(unsigned long long);
  if (smem > 48 * 1024) {  // 8192 keys at 1280x720's level 0: 64 KB
    cudaError_t err = cudaFuncSetAttribute(level_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cell_top_kernel<<<cells, kTopThreads, 0, s>>>(nms, L, K, cand_v, cand_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  level_select_kernel<<<n_levels, kSortThreads, smem, s>>>(cand_v, cand_i, raw, L, K, border, xy_lvl, xy, resp, valid);
  return cudaGetLastError();
}
