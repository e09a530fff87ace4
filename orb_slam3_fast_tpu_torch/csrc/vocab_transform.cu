// Kernel N: vocabulary transform, one warp per descriptor.  At each level
// lanes 0..B-1 take one child each (8 XOR + popcount on the packed words,
// 1 << 20 for a dead child) and a shuffle argmin on (distance, child) picks
// the lowest child among equals; lane 0 writes the word and the node (-1 for
// an invalid descriptor) and adds the word's idf weight into the BoW and the
// float64 total.  A second launch divides the BoW by the total.  See the source note
// in vocab/vocabulary.py; transform_plain there is the same function in
// PyTorch.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // descriptors per block
constexpr int kDead = 1 << 20;
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(32 * kWarps)
descend_kernel(const int* __restrict__ cents, const uint8_t* __restrict__ alive,
               const float* __restrict__ weights, int B, int depth, int node_lvl,
               const int* __restrict__ desc, const bool* __restrict__ valid, int n,
               long long* __restrict__ words, long long* __restrict__ nodes, float* __restrict__ bow,
               double* __restrict__ total) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  if (!valid[row]) {
    if (lane == 0) words[row] = nodes[row] = -1;
    return;
  }
  int d[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) d[w] = desc[8 * row + w];
  long long node = 0, node_at = 0;
  long long off = 0, width = B;  // first node of this level in the flat table, nodes in it
  for (int l = 0; l < depth; ++l) {
    int dist = INT_MAX, j = lane;
    if (lane < B) {
      const long long idx = off + node * B + lane;
      if (alive[idx]) {
        const int* c = cents + 8 * idx;
        dist = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w) dist += __popc(d[w] ^ __ldg(c + w));
      } else {
        dist = kDead;
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const int od = __shfl_xor_sync(kFull, dist, s), oj = __shfl_xor_sync(kFull, j, s);
      if (od < dist || (od == dist && oj < j)) {
        dist = od;
        j = oj;
      }
    }
    node = node * B + j;
    if (l == node_lvl) node_at = node;
    off += width;
    width *= B;
  }
  if (lane == 0) {
    words[row] = node;
    nodes[row] = node_at;
    const float w = weights[node];
    atomicAdd(&bow[node], w);
    atomicAdd(total, (double)w);  // float64: the total's rounding does not depend on the order
  }
}

__global__ void normalize_kernel(float* __restrict__ bow, const double* __restrict__ total, int n_words) {
  const float denom = fmaxf((float)*total, 1e-12f);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_words; i += gridDim.x * blockDim.x)
    bow[i] = bow[i] / denom;
}

}  // namespace

extern "C" int vocab_transform_launch(const int* cents, const uint8_t* alive, const float* weights,
                                      int B, int depth, int node_lvl, const int* desc,
                                      const bool* valid, int n, int n_words, long long* words,
                                      long long* nodes, float* bow, double* total, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(bow, 0, sizeof(float) * (size_t)n_words, st);
  cudaMemsetAsync(total, 0, sizeof(double), st);
  if (n > 0)
    descend_kernel<<<(n + kWarps - 1) / kWarps, 32 * kWarps, 0, st>>>(
        cents, alive, weights, B, depth, node_lvl, desc, valid, n, words, nodes, bow, total);
  const int grid = n_words / 256 + 1 < 1024 ? n_words / 256 + 1 : 1024;
  normalize_kernel<<<grid, 256, 0, st>>>(bow, total, n_words);
  return cudaGetLastError();
}
