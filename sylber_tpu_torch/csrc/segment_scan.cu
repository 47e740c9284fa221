// Pass 1 of the syllable segmentation: the greedy cosine-merge scan over
// frames.
//
// Replaces sylber_tpu/ops/segment.py::_pass1 (an XLA lax.scan, not Pallas):
// in eager PyTorch the scan costs ~15 kernel launches per frame.
//
// Semantics, per batch row, exactly those of the scan (and of
// segment_np.segment_oracle): a running mean `curr` of the open segment, a
// float frame count `cnt` and the open segment's `start`. For frame i with
// voiced flag v and sim = dot(curr, x) / |curr| / |x| (|.| =
// sqrt(sum sq + 1e-8)):
//   close    = (!v && start > -1) || boundary
//   boundary = v && cnt != 0 && sim < thr
//   curr     = !v ? 0 : (cnt != 0 && sim >= thr ? (curr*cnt + x)/(cnt+1) : x)
//   cnt      = !v ? 0 : (cnt == 0 ? 1 : cnt + 1)   (count carries across a
//                                                    mid boundary: the quirk)
//   start    = !v ? -1 : (cnt == 0 || boundary ? i : start)
// and it emits close[i], boundary[i] and the start before the update. The
// scatter of these events into segment buffers stays in torch.
//
// Bound on the H100: latency. The frames of one row are a chain of
// dependent steps, each needing three reductions over d; the bytes
// (B*L*d floats read once) would take microseconds.
//
// Design. One block per batch row, one loop over frames inside it. Each
// thread holds d/256 lanes of curr and of the frame in registers, prefetches
// the next frame's lanes before reducing the current one, and the three
// dot products reduce through warp shuffles and one shared-memory step.
#include "common.cuh"

using namespace sylber;

namespace {

constexpr int THREADS = 256;
constexpr int PER = 4;  // lanes per thread: d <= THREADS * PER
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
    segment_pass1_kernel(const float* __restrict__ states,
                         const uint8_t* __restrict__ voiced,
                         uint8_t* __restrict__ close,
                         uint8_t* __restrict__ boundary,
                         int* __restrict__ seg_start,
                         int* __restrict__ final_start, int L, int d,
                         float thr) {
  __shared__ float red[3][WARPS];
  __shared__ float tot[3];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float* xb = states + (size_t)b * L * d;

  float cr[PER], xr[PER], xn[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int i = tid + p * THREADS;
    cr[p] = 0.f;
    xr[p] = (i < d && L > 0) ? xb[i] : 0.f;
    xn[p] = 0.f;
  }
  float cnt = 0.f;
  int start = -1;

  for (int t = 0; t < L; ++t) {
    if (t + 1 < L) {
      const float* nx = xb + (size_t)(t + 1) * d;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int i = tid + p * THREADS;
        xn[p] = i < d ? nx[i] : 0.f;
      }
    }
    float dot = 0.f, cc = 0.f, xx = 0.f;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      dot = fmaf(cr[p], xr[p], dot);
      cc = fmaf(cr[p], cr[p], cc);
      xx = fmaf(xr[p], xr[p], xx);
    }
    dot = warp_sum(dot);
    cc = warp_sum(cc);
    xx = warp_sum(xx);
    if (lane == 0) {
      red[0][warp] = dot;
      red[1][warp] = cc;
      red[2][warp] = xx;
    }
    __syncthreads();
    if (warp == 0) {
      float a = lane < WARPS ? red[0][lane] : 0.f;
      float c = lane < WARPS ? red[1][lane] : 0.f;
      float x = lane < WARPS ? red[2][lane] : 0.f;
      a = warp_sum(a);
      c = warp_sum(c);
      x = warp_sum(x);
      if (lane == 0) {
        tot[0] = a;
        tot[1] = c;
        tot[2] = x;
      }
    }
    __syncthreads();
    const float sim = tot[0] / sqrtf(tot[1] + 1e-8f) / sqrtf(tot[2] + 1e-8f);

    const bool v = voiced[(size_t)b * L + t] != 0;
    const bool is_open = start > -1;
    const bool is_first = cnt == 0.f;
    const bool merge = sim >= thr;
    const bool bnd = v && !is_first && !merge;
    if (tid == 0) {
      const size_t at = (size_t)b * L + t;
      close[at] = (uint8_t)((!v && is_open) || bnd);
      boundary[at] = (uint8_t)bnd;
      seg_start[at] = start;
    }
    const bool use_mean = v && merge && !is_first;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      cr[p] = !v ? 0.f
                 : (use_mean ? (cr[p] * cnt + xr[p]) / (cnt + 1.f) : xr[p]);
      xr[p] = xn[p];
    }
    const float new_cnt = !v ? 0.f : (is_first ? 1.f : cnt + 1.f);
    start = !v ? -1 : ((is_first || bnd) ? t : start);
    cnt = new_cnt;
  }
  if (tid == 0) final_start[b] = start;
}

}  // namespace

// states (B, L, d) fp32 contiguous; voiced (B, L) uint8;
// close, boundary (B, L) uint8; seg_start (B, L) int32; final_start (B,).
extern "C" int sylber_segment_pass1(const float* states, const uint8_t* voiced,
                                    uint8_t* close, uint8_t* boundary,
                                    int* seg_start, int* final_start, int B,
                                    int L, int d, float thr,
                                    cudaStream_t stream) {
  if (d > THREADS * PER || d < 1) return (int)cudaErrorInvalidValue;
  segment_pass1_kernel<<<B, THREADS, 0, stream>>>(
      states, voiced, close, boundary, seg_start, final_start, L, d, thr);
  return (int)cudaGetLastError();
}
