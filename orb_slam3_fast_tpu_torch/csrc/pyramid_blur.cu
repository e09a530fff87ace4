// Kernel H: the scale pyramid and the 7x7 separable Gaussian blur of every
// level, written into one flat buffer per image.  See the source note in
// ops/image.py; pyramid_blur_plain there is the same function in PyTorch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kTaps = 7;
constexpr int kR = kTaps / 2;            // 3-px halo
constexpr int kTile = 32;                // output tile, 32 x 32 pixels
constexpr int kIn = kTile + 2 * kR;      // 38
constexpr int kThreads = 256;

struct Taps {
  float k[kTaps];
};

// F.pad(mode="reflect") index (reflect-101) for |i| < n; any other index
// lies outside what an in-level output reads and is only kept in range.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

// One pixel of F.interpolate(mode="bilinear", align_corners=False) on the
// card: the expressions of PyTorch's upsample_bilinear2d_out_frame and
// area_pixel_compute_source_index, written as they are there.
__device__ __forceinline__ float bilinear(const float* __restrict__ src, int h_in, int w_in, float rheight,
                                          float rwidth, int h2, int w2) {
  float h1r = rheight * (h2 + static_cast<float>(0.5)) - static_cast<float>(0.5);
  h1r = h1r < static_cast<float>(0) ? static_cast<float>(0) : h1r;
  const int h1 = h1r;
  const int h1p = (h1 < h_in - 1) ? 1 : 0;
  const float h1lambda = h1r - h1;
  const float h0lambda = static_cast<float>(1) - h1lambda;
  float w1r = rwidth * (w2 + static_cast<float>(0.5)) - static_cast<float>(0.5);
  w1r = w1r < static_cast<float>(0) ? static_cast<float>(0) : w1r;
  const int w1 = w1r;
  const int w1p = (w1 < w_in - 1) ? 1 : 0;
  const float w1lambda = w1r - w1;
  const float w0lambda = static_cast<float>(1) - w1lambda;
  const float* r0 = src + h1 * w_in;
  const float* r1 = src + (h1 + h1p) * w_in;
  const float val = h0lambda * (w0lambda * r0[w1] + w1lambda * r0[w1 + w1p]) +
                    h1lambda * (w0lambda * r1[w1] + w1lambda * r1[w1 + w1p]);
  return val;
}

// One level: its pixels (resized from the level before, or copied from the
// input for level 0) and their blur.  A 38 x 38 shared tile holds the level
// around a 32 x 32 output tile, reflected at the level's edges; the halo's
// resized pixels are recomputed from the level before.  Taps are summed in
// order from zero without FMA contraction, as the plain version's chain of
// separate multiplies and adds does, so the blur is bit-equal to it.
__global__ void __launch_bounds__(kThreads)
level_blur_kernel(const float* __restrict__ src, int h_in, int w_in, float* __restrict__ lvl,
                  float* __restrict__ blur, int h, int w, int resize, float rheight, float rwidth, Taps taps) {
  __shared__ float tile[kIn][kIn + 1];
  __shared__ float vert[kTile][kIn + 1];
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  for (int i = tid; i < kIn * kIn; i += kThreads) {
    const int ty = i / kIn, tx = i % kIn;
    const int gy = reflect101(y0 + ty - kR, h), gx = reflect101(x0 + tx - kR, w);
    tile[ty][tx] = resize ? bilinear(src, h_in, w_in, rheight, rwidth, gy, gx) : src[gy * w_in + gx];
  }
  __syncthreads();
  // vertical pass over the tile's 32 rows and all 38 columns
  for (int i = tid; i < kTile * kIn; i += kThreads) {
    const int ty = i / kIn, tx = i % kIn;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) v = __fadd_rn(v, __fmul_rn(taps.k[k], tile[ty + k][tx]));
    vert[ty][tx] = v;
  }
  __syncthreads();
  // horizontal pass; the level's own pixels are written beside their blur
  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int ty = i / kTile, tx = i % kTile;
    const int y = y0 + ty, x = x0 + tx;
    if (y >= h || x >= w) continue;
    float o = 0.f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) o = __fadd_rn(o, __fmul_rn(taps.k[k], vert[ty][tx + k]));
    blur[y * w + x] = o;
    lvl[y * w + x] = tile[ty + kR][tx + kR];
  }
}

}  // namespace

// img: (h0, w0) input; shapes: host (n_levels, 2) [h, w]; offs: host
// (n_levels,) element offsets of each level in img_flat / blur_flat; taps:
// host (7,) Gaussian taps.  One launch per level, on the caller's stream.
extern "C" int pyramid_blur_launch(const float* img, const int* shapes, const long long* offs, int n_levels,
                                   const float* taps, float* img_flat, float* blur_flat, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Taps t;
  for (int k = 0; k < kTaps; ++k) t.k[k] = taps[k];
  for (int l = 0; l < n_levels; ++l) {
    const int h = shapes[2 * l], w = shapes[2 * l + 1];
    if (h <= kR || w <= kR) return cudaErrorInvalidValue;  // reflect-101 needs the pad inside the level
    const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
    const float* src = l == 0 ? img : img_flat + offs[l - 1];
    const int h_in = l == 0 ? h : shapes[2 * (l - 1)];
    const int w_in = l == 0 ? w : shapes[2 * (l - 1) + 1];
    // PyTorch's scale: static_cast<float>(input_size) / output_size
    const float rheight = static_cast<float>(h_in) / h, rwidth = static_cast<float>(w_in) / w;
    level_blur_kernel<<<grid, kThreads, 0, s>>>(src, h_in, w_in, img_flat + offs[l], blur_flat + offs[l], h, w,
                                                l > 0, rheight, rwidth, t);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
