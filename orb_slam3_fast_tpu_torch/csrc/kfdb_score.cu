// Kernel AE: bag-of-words scoring of a query against the keyframe
// database's sparse rows held on this rank (parallel/dist_kfdb.py): one warp
// per row of the (n_rows, T) word ids and weights.  Each lane walks the
// row's columns lane, lane + 32, ... in order, looks the query's weight up
// in the dense table (id -1 reads the trailing zero at lut[n_words]), counts
// the words both hold and sums min(w, qw); a shuffle tree sums the lanes.
// Every row's sum has one fixed order, so a row scores the same bits on
// whichever rank holds it.  See the source note in parallel/dist_kfdb.py;
// score_rows_plain there is the same function in PyTorch, in the same order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per CTA
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(32 * kWarps)
kfdb_score_kernel(const int* __restrict__ ids, const float* __restrict__ w, const float* __restrict__ lut,
                  int n_rows, int T, int n_words, int* __restrict__ common, float* __restrict__ score) {
  const int row = blockIdx.x * kWarps + (int)(threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // the whole warp leaves together
  const int* ri = ids + (size_t)row * T;
  const float* rw = w + (size_t)row * T;
  int c = 0;
  float s = 0.f;
  for (int j = lane; j < T; j += 32) {
    const int id = ri[j];
    const float qw = lut[id >= 0 ? id : n_words];
    const float v = rw[j];
    const bool shared = qw > 0.f && v > 0.f;
    c += shared ? 1 : 0;
    s += shared ? fminf(v, qw) : 0.f;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    c += __shfl_down_sync(kFull, c, o);
    s += __shfl_down_sync(kFull, s, o);
  }
  if (lane == 0) {
    common[row] = c;
    score[row] = s;
  }
}

}  // namespace

// ids, w: (n_rows, T) int32 / float32 on the device; lut: (n_words + 1,) float32, the query's dense weights and a
// trailing zero.  Writes common (n_rows,) int32 and score (n_rows,) float32.
extern "C" int kfdb_score_launch(const int* ids, const float* w, const float* lut, int n_rows, int T, int n_words,
                                 int* common, float* score, void* stream) {
  if (n_rows < 0 || T < 0 || n_words < 0) return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (n_rows + kWarps - 1) / kWarps;
  kfdb_score_kernel<<<grid, 32 * kWarps, 0, st>>>(ids, w, lut, n_rows, T, n_words, common, score);
  return cudaGetLastError();
}
