// Kernel B: intensity-centroid angle + rotated BRIEF, one warp per keypoint,
// all pyramid levels in one launch.  See the source note in ops/extractor.py;
// orb_describe_plain there is the same function in PyTorch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // keypoints per block
constexpr int kPatchR = 15;        // intensity-centroid patch radius
constexpr int kBriefR = 14;        // BRIEF sampling window radius (29x29)
constexpr int kPairs = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(32 * kWarps)
orb_describe_kernel(const float* __restrict__ img, const float* __restrict__ blur,
                    const int64_t* __restrict__ kp_off, const int* __restrict__ kp_w,
                    const int* __restrict__ kp_xy, const int* __restrict__ pattern,
                    const int* __restrict__ umax, int n, float* __restrict__ angle_out,
                    int* __restrict__ desc_out) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= n) return;  // whole warps exit together
  const int64_t off = kp_off[k];
  const int w = kp_w[k];
  const int cx = kp_xy[2 * k], cy = kp_xy[2 * k + 1];

  // moments over the circular 31x31 patch: lane u+15 owns column u
  float m10 = 0.f, m01 = 0.f;
  const int u = lane - kPatchR;
  if (lane < 2 * kPatchR + 1) {
    const float* col = img + off + cx + u;
    for (int v = -kPatchR; v <= kPatchR; ++v) {
      if (abs(u) <= umax[abs(v)]) {
        const float p = col[(int64_t)(cy + v) * w];
        m10 += p * (float)u;
        m01 += p * (float)v;
      }
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    m10 += __shfl_xor_sync(kFull, m10, s);
    m01 += __shfl_xor_sync(kFull, m01, s);
  }
  const float ang = atan2f(m01, m10);
  if (lane == 0) angle_out[k] = ang;

  // rotated BRIEF: lane handles pair j*32 + lane, a ballot packs word j
  const float ca = cosf(ang), sa = sinf(ang);
  const float* win = blur + off + (int64_t)(cy - kBriefR) * w + (cx - kBriefR);
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < kPairs / 32; ++j) {
    const int p = j * 32 + lane;
    const float px1 = (float)pattern[4 * p], py1 = (float)pattern[4 * p + 1];
    const float px2 = (float)pattern[4 * p + 2], py2 = (float)pattern[4 * p + 3];
    // separate multiply and add, as the reference's elementwise ops round
    const float x1 = __fsub_rn(__fmul_rn(px1, ca), __fmul_rn(py1, sa));
    const float y1 = __fadd_rn(__fmul_rn(px1, sa), __fmul_rn(py1, ca));
    const float x2 = __fsub_rn(__fmul_rn(px2, ca), __fmul_rn(py2, sa));
    const float y2 = __fadd_rn(__fmul_rn(px2, sa), __fmul_rn(py2, ca));
    // rintf rounds half to even, as jnp.round
    const int ix1 = clampi((int)rintf(x1) + kBriefR, 0, 2 * kBriefR);
    const int iy1 = clampi((int)rintf(y1) + kBriefR, 0, 2 * kBriefR);
    const int ix2 = clampi((int)rintf(x2) + kBriefR, 0, 2 * kBriefR);
    const int iy2 = clampi((int)rintf(y2) + kBriefR, 0, 2 * kBriefR);
    const float v1 = bf16_round(win[(int64_t)iy1 * w + ix1]);
    const float v2 = bf16_round(win[(int64_t)iy2 * w + ix2]);
    const uint32_t bits = __ballot_sync(kFull, v1 < v2);
    if (lane == j) word = bits;
  }
  if (lane < kPairs / 32) desc_out[8 * k + lane] = (int)word;
}

}  // namespace

extern "C" int orb_describe_launch(const float* img, const float* blur, const int64_t* kp_off,
                                   const int* kp_w, const int* kp_xy, const int* pattern,
                                   const int* umax, int n, float* angle_out, int* desc_out,
                                   void* stream) {
  if (n > 0) {
    const int grid = (n + kWarps - 1) / kWarps;
    orb_describe_kernel<<<grid, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
        img, blur, kp_off, kp_w, kp_xy, pattern, umax, n, angle_out, desc_out);
  }
  return cudaGetLastError();
}
