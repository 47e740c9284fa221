// Host-side syllable segmentation (C++), semantics identical to
// sylber_tpu_torch/ops/segment_np.py (the numpy oracle of the Sylber
// algorithm) and to the segmentation kernels' plain versions.
//
// Used for (a) CPU-only preprocessing of a corpus (stage-1 segment .npy
// files: python -m sylber_tpu_torch.precompute_segments --native), and (b) a
// second, independently written oracle in the tests. Built by g++ at first
// use and bound through ctypes (sylber_tpu_torch/utils/native.py).
//
// Exactness contract (margin-gated): dot products and norms here accumulate
// in double, which is more accurate than the numpy oracle's float32 pairwise
// summation, so each thresholded decision (norm gate, cosine merge, sweep
// argmax) agrees with the oracle whenever the oracle's decision margin
// (segment_oracle(return_margin=True)) exceeds the float32 round-off of the
// reductions (~1e-5 at d=768). Decisions inside that margin are numerically
// ambiguous in any implementation and may flip; the tests gate exact
// equality on the reported margin (tests/test_torch_native.py).

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline double vec_norm(const float* x, int d) {
  double s = 0.0;
  for (int i = 0; i < d; ++i) s += double(x[i]) * x[i];
  return std::sqrt(s + 1e-8);
}

inline double cossim(const float* a, const float* b, int d) {
  double dot = 0.0;
  for (int i = 0; i < d; ++i) dot += double(a[i]) * b[i];
  return dot / vec_norm(a, d) / vec_norm(b, d);
}

inline double cossim_d(const std::vector<double>& a, const float* b, int d) {
  double dot = 0.0, na = 0.0;
  for (int i = 0; i < d; ++i) {
    dot += a[i] * b[i];
    na += a[i] * a[i];
  }
  return dot / std::sqrt(na + 1e-8) / vec_norm(b, d);
}

inline double cossim_dd(const std::vector<double>& a,
                        const std::vector<double>& b, int d) {
  double dot = 0.0, na = 0.0, nb = 0.0;
  for (int i = 0; i < d; ++i) {
    dot += a[i] * b[i];
    na += a[i] * a[i];
    nb += b[i] * b[i];
  }
  return dot / std::sqrt(na + 1e-8) / std::sqrt(nb + 1e-8);
}

void segment_mean(const float* states, int d, int s, int e,
                  std::vector<double>* out) {
  out->assign(d, 0.0);
  for (int t = s; t < e; ++t)
    for (int i = 0; i < d; ++i) (*out)[i] += states[size_t(t) * d + i];
  const double inv = 1.0 / double(e - s);
  for (int i = 0; i < d; ++i) (*out)[i] *= inv;
}

}  // namespace

extern "C" {

// states: (L, d) row-major float32. out_segments: capacity >= (L+1)*2 ints.
// Returns the number of segments written.
int sylber_segment(const float* states, int L, int d, float norm_threshold,
                   float merge_threshold, int32_t* out_segments) {
  std::vector<std::pair<int, int>> segs;
  std::vector<std::pair<int, int>> mids;  // (boundary frame, segment index)
  segs.reserve(L + 1);

  // Pass 1: greedy norm-gated merge scan. `curr` is the running mean of the
  // open segment in float32 (matching the numpy oracle's dtype behavior:
  // curr = (curr*cnt + x) / (cnt+1) computed in f32).
  std::vector<float> curr(d, 0.0f);
  int cnt = 0;
  int start = -1;
  for (int i = 0; i < L; ++i) {
    const float* x = states + size_t(i) * d;
    const bool voiced = vec_norm(x, d) >= double(norm_threshold);
    if (!voiced) {
      if (start > -1) segs.emplace_back(start, i);
      start = -1;
      cnt = 0;
    } else if (cnt == 0) {
      for (int j = 0; j < d; ++j) curr[j] = x[j];
      cnt = 1;
      start = i;
    } else {
      if (cossim(curr.data(), x, d) >= double(merge_threshold)) {
        for (int j = 0; j < d; ++j)
          curr[j] = (curr[j] * float(cnt) + x[j]) / float(cnt + 1);
        ++cnt;
      } else {
        segs.emplace_back(start, i);
        mids.emplace_back(i, int(segs.size()) - 1);
        for (int j = 0; j < d; ++j) curr[j] = x[j];
        ++cnt;  // reference quirk: count carries across the boundary
        start = i;
      }
    }
  }
  if (start > -1) segs.emplace_back(start, L);

  // Pass 2: boundary refinement.
  std::vector<bool> merged(segs.size(), false);
  std::vector<double> mean_a, mean_b;
  for (const auto& [bd0, gi] : mids) {
    if (gi >= int(segs.size()) - 1) continue;
    int bd = bd0;
    const auto [a0, a1] = segs[gi];
    const auto [b0, b1] = segs[gi + 1];
    segment_mean(states, d, a0, a1, &mean_a);
    segment_mean(states, d, b0, b1, &mean_b);
    if (cossim_dd(mean_a, mean_b, d) >= double(merge_threshold)) {
      segs[gi + 1] = {a0, b1};
      merged[gi] = true;
      continue;
    }
    const int half_a = std::max(1, (a1 - a0) / 2);
    const int half_b = std::max(1, (b1 - b0) / 2);
    const int ws = std::max(a0, bd - half_a);
    const int we = std::min(b1, bd + half_b);
    // score(t) = sum_{ws<=u<t} cos(u, mean_a) + sum_{t<=u<we} cos(u, mean_b)
    std::vector<double> cp(we - ws), cn(we - ws);
    for (int u = ws; u < we; ++u) {
      cp[u - ws] = cossim_d(mean_a, states + size_t(u) * d, d);
      cn[u - ws] = cossim_d(mean_b, states + size_t(u) * d, d);
    }
    double best = -1e300;
    int opt = ws;
    double prev_sum = 0.0, next_sum = 0.0;
    for (int t = 0; t < we - ws; ++t) next_sum += cn[t];
    for (int t = 0; t < we - ws; ++t) {
      const double score = prev_sum + next_sum;
      if (score > best) {
        best = score;
        opt = ws + t;
      }
      prev_sum += cp[t];
      next_sum -= cn[t];
    }
    segs[gi] = {a0, opt};
    segs[gi + 1] = {opt, b1};
  }

  int n = 0;
  for (size_t i = 0; i < segs.size(); ++i) {
    if (merged[i]) continue;
    out_segments[2 * n] = segs[i].first;
    out_segments[2 * n + 1] = segs[i].second;
    ++n;
  }
  return n;
}

// Batched variant over (B, L, d); out_segments capacity B*(L+1)*2,
// out_counts capacity B.
void sylber_segment_batch(const float* states, int B, int L, int d,
                          float norm_threshold, float merge_threshold,
                          int32_t* out_segments, int32_t* out_counts) {
  const size_t seg_stride = size_t(L + 1) * 2;
  for (int b = 0; b < B; ++b) {
    out_counts[b] = sylber_segment(states + size_t(b) * L * d, L, d,
                                   norm_threshold, merge_threshold,
                                   out_segments + size_t(b) * seg_stride);
  }
}

}  // extern "C"
