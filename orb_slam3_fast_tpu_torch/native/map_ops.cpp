// Native host kernels for the SoA map — the runtime-side hot loops that sit
// OUTSIDE the XLA device programs (the reference implements the equivalent
// logic in C++ inside KeyFrame::UpdateConnections / KeyFrameDatabase walks;
// our Python orchestration keeps the same split: device math in XLA,
// index-table maintenance in native code).
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this environment).
// Build: `make -C native` (g++ -O3 -shared -fPIC).
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Covisibility counts of one keyframe against all keyframes:
// counts[j] = |{ slots s : kf_obs[j,s] in lm_set }| for j in [0,K).
// lm_mark is a caller-provided scratch byte array of size max_lm, zeroed
// here before and after use (KeyFrame::UpdateConnections weight counting,
// reference KeyFrame.cc:379-475).
void covis_counts(const int32_t* kf_obs, int64_t K, int64_t N,
                  const int32_t* lm_ids, int64_t n_lm,
                  uint8_t* lm_mark, int64_t max_lm,
                  int32_t* out_counts) {
  for (int64_t i = 0; i < n_lm; ++i) {
    int32_t id = lm_ids[i];
    if (id >= 0 && id < max_lm) lm_mark[id] = 1;
  }
  for (int64_t k = 0; k < K; ++k) {
    const int32_t* row = kf_obs + k * N;
    int32_t c = 0;
    for (int64_t s = 0; s < N; ++s) {
      int32_t id = row[s];
      if (id >= 0 && id < max_lm && lm_mark[id]) ++c;
    }
    out_counts[k] = c;
  }
  for (int64_t i = 0; i < n_lm; ++i) {
    int32_t id = lm_ids[i];
    if (id >= 0 && id < max_lm) lm_mark[id] = 0;
  }
}

// COO observation gather restricted to (kf_ids x lm_local map):
// for each kf in kf_ids (K_sel rows of kf_obs), emit
// (kf_local_index, lm_local[id], slot) for slots whose landmark id has
// lm_local[id] >= 0.  Returns the number of triplets written (capped at cap).
int64_t observations_of(const int32_t* kf_obs, int64_t N,
                        const int64_t* kf_ids, int64_t K_sel,
                        const int32_t* lm_local, int64_t max_lm,
                        int32_t* out_kf, int32_t* out_lm, int32_t* out_slot,
                        int64_t cap) {
  int64_t n = 0;
  for (int64_t i = 0; i < K_sel; ++i) {
    const int32_t* row = kf_obs + kf_ids[i] * N;
    for (int64_t s = 0; s < N; ++s) {
      int32_t id = row[s];
      if (id < 0 || id >= max_lm) continue;
      int32_t ll = lm_local[id];
      if (ll < 0) continue;
      if (n >= cap) return n;
      out_kf[n] = (int32_t)i;
      out_lm[n] = ll;
      out_slot[n] = (int32_t)s;
      ++n;
    }
  }
  return n;
}

// Redundancy counting for KeyFrameCulling (LocalMapping.cc:908-1050):
// for each landmark id in lm_ids (with observing level lvl_c[i]), count the
// keyframes in kf_sel whose observation of that landmark is at level
// <= lvl_c[i] + 1.  lm_local maps landmark id -> index into out_counts.
void redundancy_counts(const int32_t* kf_obs, const int32_t* kf_level,
                       int64_t N,
                       const int64_t* kf_sel, int64_t K_sel,
                       const int32_t* lm_local, int64_t max_lm,
                       const int32_t* lvl_c, int64_t n_lm,
                       int32_t* out_counts) {
  memset(out_counts, 0, sizeof(int32_t) * n_lm);
  for (int64_t i = 0; i < K_sel; ++i) {
    const int32_t* row = kf_obs + kf_sel[i] * N;
    const int32_t* lrow = kf_level + kf_sel[i] * N;
    for (int64_t s = 0; s < N; ++s) {
      int32_t id = row[s];
      if (id < 0 || id >= max_lm) continue;
      int32_t li = lm_local[id];
      if (li < 0) continue;
      if (lrow[s] <= lvl_c[li] + 1) out_counts[li]++;
    }
  }
}

// Full K x K covisibility matrix in ONE pass (the reference recomputes
// per-keyframe weight maps inside UpdateConnections, KeyFrame.cc:379-475;
// the essential-graph builder needs ALL pairs at once,
// Optimizer.cc:1518-1827).  Inverts kf_obs into per-landmark observer lists
// (counting sort), then bumps every observer pair — O(K*N + sum_l d_l^2)
// instead of O(K^2 * N).
// Scratch (caller-allocated): lm_count[max_lm+1], lm_list[K*N].
void covis_matrix(const int32_t* kf_obs, int64_t K, int64_t N, int64_t max_lm,
                  int32_t* lm_count, int32_t* lm_list,
                  int32_t* out /* K*K */) {
  memset(out, 0, sizeof(int32_t) * K * K);
  memset(lm_count, 0, sizeof(int32_t) * (max_lm + 1));
  for (int64_t k = 0; k < K; ++k) {
    const int32_t* row = kf_obs + k * N;
    for (int64_t s = 0; s < N; ++s) {
      int32_t id = row[s];
      if (id >= 0 && id < max_lm) lm_count[id + 1]++;
    }
  }
  for (int64_t i = 0; i < max_lm; ++i) lm_count[i + 1] += lm_count[i];
  // lm_count[id] is now the write offset for landmark id
  for (int64_t k = 0; k < K; ++k) {
    const int32_t* row = kf_obs + k * N;
    for (int64_t s = 0; s < N; ++s) {
      int32_t id = row[s];
      if (id >= 0 && id < max_lm) lm_list[lm_count[id]++] = (int32_t)k;
    }
  }
  // lm_count[id] is now the END offset; start = end of id-1 (0 for id 0)
  for (int64_t id = 0; id < max_lm; ++id) {
    int64_t start = id ? lm_count[id - 1] : 0;
    int64_t end = lm_count[id];
    for (int64_t a = start; a < end; ++a) {
      int32_t ka = lm_list[a];
      for (int64_t b = a + 1; b < end; ++b) {
        int32_t kb = lm_list[b];
        out[(int64_t)ka * K + kb]++;
        out[(int64_t)kb * K + ka]++;
      }
    }
  }
}

// Landmark statistics in one pass (MapPoint::UpdateNormalAndDepth,
// MapPoint.cc:461-540, for a SET of landmarks): mean viewing direction,
// observation count, and the FIRST observing keyframe + slot per landmark.
// centers: (K,3) camera centers.  lm_local maps landmark id -> output row.
void landmark_stats(const int32_t* kf_obs, int64_t K, int64_t N,
                    const int32_t* lm_local, int64_t max_lm,
                    const float* centers, const float* lm_pos,
                    float* out_normal /* n_lm*3, pre-zeroed by caller */,
                    int32_t* out_nobs /* n_lm, pre-zeroed */,
                    int32_t* out_first_kf /* n_lm, pre-filled -1 */,
                    int32_t* out_first_slot /* n_lm */) {
  for (int64_t k = 0; k < K; ++k) {
    const int32_t* row = kf_obs + k * N;
    const float* c = centers + k * 3;
    for (int64_t s = 0; s < N; ++s) {
      int32_t id = row[s];
      if (id < 0 || id >= max_lm) continue;
      int32_t li = lm_local[id];
      if (li < 0) continue;
      const float* p = lm_pos + (int64_t)id * 3;
      float dx = p[0] - c[0], dy = p[1] - c[1], dz = p[2] - c[2];
      float inv = 1.0f / (sqrtf(dx * dx + dy * dy + dz * dz) + 1e-9f);
      out_normal[li * 3 + 0] += dx * inv;
      out_normal[li * 3 + 1] += dy * inv;
      out_normal[li * 3 + 2] += dz * inv;
      out_nobs[li]++;
      if (out_first_kf[li] < 0) {
        out_first_kf[li] = (int32_t)k;
        out_first_slot[li] = (int32_t)s;
      }
    }
  }
}

}  // extern "C"
