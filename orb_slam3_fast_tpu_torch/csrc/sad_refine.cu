// Kernel J: SAD subpixel refinement of rectified stereo matches -- an
// 11x11 patch, each minus its centre pixel, at 11 integer offsets around
// the Hamming match, the first minimum polished by a parabola.  See the
// source note in ops/matching.py; stereo_subpixel_refine_plain there is the
// same function in PyTorch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWin = 5;                   // patch radius
constexpr int kSearch = 5;                // offsets -kSearch..kSearch
constexpr int kSide = 2 * kWin + 1;       // 11
constexpr int kPix = kSide * kSide;       // 121
constexpr int kPerLane = (kPix + 31) / 32;  // 4
constexpr int kOffsets = 2 * kSearch + 1;  // 11
constexpr int kWarps = 8;                 // keypoints per 256-thread block

__device__ __forceinline__ long long clampll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One warp per keypoint: the left patch sits in registers (4 pixels a
// lane); for each offset the lanes sum |left - right| over their pixels and
// a butterfly reduction gives every lane the SAD.
__global__ void __launch_bounds__(32 * kWarps)
sad_refine_kernel(const float* __restrict__ img_l, const float* __restrict__ img_r, int h, int w,
                  const float* __restrict__ xy_l, const float* __restrict__ right_u, const bool* __restrict__ valid,
                  int n, float* __restrict__ u_out, bool* __restrict__ ok_out) {
  const int kp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (kp >= n) return;
  // torch.round (half to even) then clamp, as the plain version does
  const long long yy = clampll(static_cast<long long>(rintf(xy_l[2 * kp + 1])), kWin, h - kWin - 1);
  const long long xl = clampll(static_cast<long long>(rintf(xy_l[2 * kp])), kWin + kSearch, w - kWin - kSearch - 1);
  const long long xr0 = clampll(static_cast<long long>(rintf(right_u[kp])), kWin + kSearch, w - kWin - kSearch - 1);
  const float cl = img_l[yy * w + xl];
  float pl[kPerLane];
  int oy[kPerLane], ox[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const int p = lane + 32 * q;
    oy[q] = p < kPix ? p / kSide - kWin : 0;
    ox[q] = p < kPix ? p % kSide - kWin : 0;
    pl[q] = p < kPix ? __fsub_rn(img_l[(yy + oy[q]) * w + xl + ox[q]], cl) : 0.f;
  }
  float sad[kOffsets];
#pragma unroll
  for (int k = 0; k < kOffsets; ++k) {
    const long long xr = xr0 + k - kSearch;
    const float cr = img_r[yy * w + xr];
    float part = 0.f;
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      if (lane + 32 * q < kPix) {
        const float pr = __fsub_rn(img_r[(yy + oy[q]) * w + xr + ox[q]], cr);
        part = __fadd_rn(part, fabsf(__fsub_rn(pl[q], pr)));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
    sad[k] = part;
  }
  if (lane != 0) return;
  int best = 0;  // first minimum, as torch.argmin
  float best_sad = sad[0];
#pragma unroll
  for (int k = 1; k < kOffsets; ++k) {
    if (sad[k] < best_sad) {
      best_sad = sad[k];
      best = k;
    }
  }
  const bool interior = best > 0 && best < 2 * kSearch;
  const int bi = min(max(best, 1), 2 * kSearch - 1);
  const float c = sad[bi], m = sad[bi - 1], p = sad[bi + 1];
  const float denom = fmaxf(__fsub_rn(__fadd_rn(m, p), __fmul_rn(2.0f, c)), 1e-6f);
  const float delta = fminf(fmaxf(__fdiv_rn(__fmul_rn(0.5f, __fsub_rn(m, p)), denom), -1.0f), 1.0f);
  const float refined = __fadd_rn(__fadd_rn(static_cast<float>(xr0), static_cast<float>(bi - kSearch)), delta);
  const bool ok = valid[kp] && interior;
  u_out[kp] = ok ? refined : right_u[kp];
  ok_out[kp] = ok;
}

}  // namespace

// img_l, img_r: (h, w) float32; xy_l: (n, 2) float32 left keypoints;
// right_u, valid: (n,) the Hamming matches.  Outputs: u_out (n,) refined
// right-u (right_u where not ok), ok_out (n,).
extern "C" int sad_refine_launch(const float* img_l, const float* img_r, int h, int w, const float* xy_l,
                                 const float* right_u, const bool* valid, int n, float* u_out, bool* ok_out,
                                 void* stream) {
  if (n <= 0) return cudaSuccess;
  if (h < 2 * kWin + 1 || w < 2 * (kWin + kSearch) + 1) return cudaErrorInvalidValue;
  const int blocks = (n + kWarps - 1) / kWarps;
  sad_refine_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(img_l, img_r, h, w, xy_l, right_u,
                                                                                  valid, n, u_out, ok_out);
  return cudaGetLastError();
}
