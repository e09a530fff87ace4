// Kernel A: FAST-16 at two thresholds with per-cell fallback, strict 3x3 NMS
// and the descriptor border, for one pyramid level.  See the source note in
// ops/fast.py; fast_nms_plain there is the same function in PyTorch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCell = 32;                // fallback cell == detection tile
constexpr int kRows = 8;                  // block is 32 x 8 threads
constexpr int kHalo = 3;                  // FAST circle radius
constexpr int kTile = kCell + 2 * kHalo;  // 38
constexpr int kNmsTile = kCell + 2;       // 1-px halo

// Bresenham circle, clockwise from 12 o'clock; bit j of a mask is point j.
__device__ __constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__device__ __constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ bool has_run9(uint32_t m16) {
  // log-step AND-shift on the doubled mask: a circular run of >= 9 bits
  const uint32_t m = m16 | (m16 << 16);
  uint32_t r = m & (m >> 1);
  r &= r >> 2;
  r &= r >> 4;
  r &= m >> 8;
  return (r & 0xFFFFu) != 0;
}

__global__ void __launch_bounds__(kCell * kRows)
fast_score_kernel(const float* __restrict__ img, float* __restrict__ raw, int h, int w,
                  float ini_th, float min_th) {
  __shared__ float tile[kTile][kTile + 1];
  const int x0 = blockIdx.x * kCell, y0 = blockIdx.y * kCell;
  const int tid = threadIdx.y * kCell + threadIdx.x;
  for (int i = tid; i < kTile * kTile; i += kCell * kRows) {
    const int ty = i / kTile, tx = i % kTile;
    const int gy = y0 + ty - kHalo, gx = x0 + tx - kHalo;
    tile[ty][tx] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? img[gy * w + gx] : 0.f;
  }
  __syncthreads();

  float s_hi[kCell / kRows], s_lo[kCell / kRows];
  bool any_hi = false;
#pragma unroll
  for (int k = 0; k < kCell / kRows; ++k) {
    const int ty = threadIdx.y + kRows * k, tx = threadIdx.x;
    const int y = y0 + ty, x = x0 + tx;
    s_hi[k] = 0.f;
    s_lo[k] = 0.f;
    if (y >= 3 && y < h - 3 && x >= 3 && x < w - 3) {
      const float c = tile[ty + kHalo][tx + kHalo];
      uint32_t bm_hi = 0, dm_hi = 0, bm_lo = 0, dm_lo = 0;
      float bs_hi = 0.f, ds_hi = 0.f, bs_lo = 0.f, ds_lo = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float diff = tile[ty + kHalo + kDy[j]][tx + kHalo + kDx[j]] - c;
        // sums in circle order, as the reference accumulates them
        if (diff > ini_th) { bm_hi |= 1u << j; bs_hi = __fadd_rn(bs_hi, diff - ini_th); }
        if (diff < -ini_th) { dm_hi |= 1u << j; ds_hi = __fadd_rn(ds_hi, -diff - ini_th); }
        if (diff > min_th) { bm_lo |= 1u << j; bs_lo = __fadd_rn(bs_lo, diff - min_th); }
        if (diff < -min_th) { dm_lo |= 1u << j; ds_lo = __fadd_rn(ds_lo, -diff - min_th); }
      }
      s_hi[k] = (has_run9(bm_hi) ? bs_hi : 0.f) + (has_run9(dm_hi) ? ds_hi : 0.f);
      s_lo[k] = (has_run9(bm_lo) ? bs_lo : 0.f) + (has_run9(dm_lo) ? ds_lo : 0.f);
      any_hi |= s_hi[k] > 0.f;
    }
  }
  // the block is the cell: it falls back to min_th when nothing fires at ini_th
  const bool cell_hi = __syncthreads_or(any_hi);
#pragma unroll
  for (int k = 0; k < kCell / kRows; ++k) {
    const int y = y0 + threadIdx.y + kRows * k, x = x0 + threadIdx.x;
    if (y < h && x < w) raw[y * w + x] = cell_hi ? s_hi[k] : s_lo[k];
  }
}

__global__ void __launch_bounds__(kCell * kRows)
nms_border_kernel(const float* __restrict__ raw, float* __restrict__ raw_inb,
                  float* __restrict__ nms, int h, int w, int border) {
  __shared__ float tile[kNmsTile][kNmsTile + 1];
  const int x0 = blockIdx.x * kCell, y0 = blockIdx.y * kCell;
  const int tid = threadIdx.y * kCell + threadIdx.x;
  for (int i = tid; i < kNmsTile * kNmsTile; i += kCell * kRows) {
    const int ty = i / kNmsTile, tx = i % kNmsTile;
    const int gy = y0 + ty - 1, gx = x0 + tx - 1;
    tile[ty][tx] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? raw[gy * w + gx] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kCell / kRows; ++k) {
    const int ty = threadIdx.y + kRows * k, tx = threadIdx.x;
    const int y = y0 + ty, x = x0 + tx;
    if (y >= h || x >= w) continue;
    float s_raw = 0.f, s_nms = 0.f;
    // border >= 1, so the 3x3 window of an inner pixel never leaves the level
    if (y >= border && y < h - border && x >= border && x < w - border) {
      s_raw = tile[ty + 1][tx + 1];
      float neigh = -INFINITY;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          if (dy != 1 || dx != 1) neigh = fmaxf(neigh, tile[ty + dy][tx + dx]);
      s_nms = s_raw > neigh ? s_raw : 0.f;
    }
    raw_inb[y * w + x] = s_raw;
    nms[y * w + x] = s_nms;
  }
}

}  // namespace

extern "C" int fast_nms_launch(const float* img, float* raw, float* raw_inb, float* nms, int h,
                               int w, int border, float ini_th, float min_th, void* stream) {
  const dim3 block(kCell, kRows);
  const dim3 grid((w + kCell - 1) / kCell, (h + kCell - 1) / kCell);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fast_score_kernel<<<grid, block, 0, s>>>(img, raw, h, w, ini_th, min_th);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nms_border_kernel<<<grid, block, 0, s>>>(raw, raw_inb, nms, h, w, border);
  return cudaGetLastError();
}
