// The two-pass syllable segmentation, start to end on the card.
//
// Replaces sylber_tpu/ops/segment.py::_pass1 (an XLA lax.scan), ::_pass2 (a
// lax.fori_loop over the mid boundaries) and ::_compact; none is Pallas. In
// eager PyTorch the scan costs ~15 launches per frame and the refinement ~40
// per mid boundary, with a device-to-host sync for the loop bound.
//
// Pass 1, per batch row, exectly the scan (and segment_np.segment_oracle): a
// running mean `curr` of the open segment, a float frame count `cnt` and the
// open segment's `start`. For frame i with voiced flag v and
// sim = dot(curr, x) / |curr| / |x| (|.| = sqrt(sum sq + 1e-8)):
//   close    = (!v && start > -1) || boundary
//   boundary = v && cnt != 0 && sim < thr
//   curr     = !v ? 0 : (cnt != 0 && sim >= thr ? (curr*cnt + x)/(cnt+1) : x)
//   cnt      = !v ? 0 : (cnt == 0 ? 1 : cnt + 1)   (count carries across a
//                                                    mid boundary: the quirk)
//   start    = !v ? -1 : (cnt == 0 || boundary ? i : start)
// It emits close[i], boundary[i] and the start before the update, and it
// fills the segment buffers itself: segs[k] = [start, i) for the k-th close,
// mids[m] = (i, k) for the m-th boundary, the trailing [start, L), the counts.
//
// Pass 2, per batch row, for each mid boundary (bd, gi) in order, skipped
// when gi >= nseg - 1: the means of segments gi and gi+1 from the prefix sums
// P; a cosine >= thr merges them; else the boundary moves to the first
// maximum over t in [ws, we) of
//   sum_{ws<=u<t} cos(x_u, mean_a) + sum_{t<=u<we} cos(x_u, mean_b).
// Then the surviving segments are compacted in order.
//
// Bound on the H100: latency, in both passes. The frames of a row are a chain
// of dependent steps (one d-wide reduction, a square root, two divisions and
// the update of the mean per frame), the mid boundaries of a row another (a
// later one reads the segments as the earlier ones left them). The bytes
// (B*L*d floats) would take microseconds.
//
// Design. Two launches, one block per batch row each, because the passes want
// different blocks: pass 1 a narrow one (the chain pays for every shuffle
// step and barrier), pass 2 a wide one (a warp per window frame).
//   Pass 1: a row's frames reach shared memory through a ring of STAGES
//   chunks of CHUNK frames. Thread 0 asks for a chunk with one bulk copy
//   (cp.async.bulk) that reports to an mbarrier, RING frames ahead of its
//   use; the block waits on a barrier once a chunk. (Loads into a register
//   ring did not run ahead: a warp has few scoreboards, and waiting for the
//   oldest load waited for the newest. With a ring slot and a barrier per
//   frame the waits and requests took a third of a frame's time.) Rows that are not 16-byte
//   aligned (d % 4 != 0) take their frames with plain loads, a thread its own
//   lanes, a frame's time through registers. A thread owns the same chunks of
//   4 floats of every frame and of `curr`. On the chain stay the reduction of
//   dot and |curr|^2, the decision and the new mean. |x|^2 does not depend on
//   the carry and is reduced one frame ahead, in the same shuffle steps. The
//   decision dot / |curr| / |x| >= thr is taken from an estimate of the cosine
//   (two rsqrt.approx and two products, within 1e-6 of the quotient) whenever
//   the estimate is more than 1e-5 off the threshold, which decides as the
//   quotient would; the square roots and IEEE divisions run only for the
//   frames in that band. The merged mean (curr*cnt + x) / (cnt + 1) is formed
//   only when a frame merges, with the reciprocal of the count taken a frame
//   early (common.cuh's Divisor: the IEEE quotient for a frame count and a
//   numerator within its range, __fdiv_rn outside; 0.359 ms against 0.411 ms
//   with __fdiv_rn throughout, H100, B32 L1000 d768); formed before the
//   decision for every frame, it cost more than it hid. The cross-warp step
//   is double-buffered, so a frame costs one barrier. Frames go in blocks of 32: their voiced flags travel as one
//   ballot word, every thread keeps the block's events as bit masks (the
//   frame loop has no thread-dependent branch and no store), and after the
//   block warp 0 writes the events out, a lane per frame, and places the
//   segments by a prefix count. What is left is the latency of the shuffles,
//   the barrier and some 200 dependent instructions a frame in warps that
//   have an SM to themselves.
//   Pass 2: each row loops over its own mid boundaries (the bound max(nmid)
//   of the vectorised plain version exists only because that one is batched),
//   so nothing returns to the host. Means are taken elementwise from P as
//   the plain version takes them; the sweep computes the cosines of the
//   window's frames only, one warp a frame, then thread 0 walks the window
//   in order (the order of a sequential cumsum) and takes the first maximum.
//   A merged segment is marked dead by start = -1 in the row's working copy.
#include "common.cuh"

using namespace sylber;

namespace {

constexpr int MAX_DIM = 1024;
constexpr int CHUNK = 8;   // frames of a row that one bulk copy brings
constexpr int STAGES = 4;  // chunks in flight per row in pass 1
constexpr int RING = CHUNK * STAGES;  // frames the ring holds
// Warps of a pass-1 block. Measured on the H100 at B32 L1000 d768: 1, 2, 3 and
// 6 warps took 0.410, 0.368, 0.361 and 0.418 ms (fewer warps: more lanes a
// thread; more: a longer cross-warp step).
constexpr int P1_WARPS = 3;
constexpr int P1_THREADS = P1_WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

// Sums a, b and c over the block in two steps, so that independent work can
// stand between them and fill the shuffles' latency: the lanes of each warp,
// then the warps. Every thread gets the three totals, added in the same
// order. `red` alternates between two buffers so that one barrier a call is
// enough.
__device__ __forceinline__ void warp_sum3(float& a, float& b, float& c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(FULL, a, o);
    b += __shfl_xor_sync(FULL, b, o);
    c += __shfl_xor_sync(FULL, c, o);
  }
}
__device__ __forceinline__ void cross_warp_sum3(float& a, float& b, float& c,
                                                float (*red)[P1_WARPS][4],
                                                int parity, int warp, int lane) {
  if (lane == 0)
    *reinterpret_cast<float4*>(red[parity][warp]) = make_float4(a, b, c, 0.f);
  __syncthreads();
  a = b = c = 0.f;
#pragma unroll
  for (int w = 0; w < P1_WARPS; ++w) {
    const float4 v = *reinterpret_cast<const float4*>(red[parity][w]);
    a += v.x, b += v.y, c += v.z;
  }
}

struct Pass1Args {
  const float* states;    // (B, L, d)
  const uint8_t* voiced;  // (B, L)
  uint8_t* close;         // (B, L)
  uint8_t* boundary;      // (B, L)
  int* seg_start;         // (B, L)
  int* final_start;       // (B,)
  int2* segs;             // (B, L + 1)
  int* nseg;              // (B,)
  int2* mids;             // (B, L + 1)
  int* nmid;              // (B,)
  int L, d;
  float thr;
  int vec;  // rows are 16-byte aligned: d % 4 == 0 and the base pointer is
};

// A thread owns NC chunks of 4 floats of every frame.
template <int NC>
__global__ void __launch_bounds__(P1_THREADS)
    segment_pass1_kernel(const Pass1Args a) {
  const int L = a.L, d = a.d, vec = a.vec;
  const float thr = a.thr;
  constexpr int T = P1_THREADS;
  extern __shared__ __align__(128) float ring[];  // frame f at (f % RING) * ds
  __shared__ __align__(8) uint64_t full[STAGES];   // a chunk's copy has landed
  __shared__ __align__(16) float red[2][P1_WARPS][4];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ds = (d + 3) / 4 * 4;  // a frame's floats in the ring, zero-padded
  const float* xb = a.states + (size_t)b * L * d;
  const uint8_t* vrow = a.voiced + (size_t)b * L;
  int2* srow = a.segs + (size_t)b * (L + 1);
  int2* mrow = a.mids + (size_t)b * (L + 1);

  // Aligned rows: thread 0 asks for the frames of chunk c, one bulk copy.
  auto request = [&](int c) {
    const int f = c * CHUNK;
    if (f >= L) return;
    const unsigned bytes = 4u * (unsigned)(min(CHUNK, L - f) * d);
    uint64_t* bar = &full[c % STAGES];
    mbar_expect_tx(bar, bytes);
    bulk_copy_to_shared(ring + (f % RING) * d, xb + (size_t)f * d, bytes, bar);
  };
  // Other rows: a thread carries its own lanes of frame f through registers
  // (`pend`, for one frame's time, so that the load is not waited for) into
  // the slot, zeros past the row's width, and nobody else reads them there.
  float pend[NC][4];
  auto load_own = [&](int f) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * (c * T + tid) + e;
        pend[c][e] = (f < L && i < d) ? xb[(size_t)f * d + i] : 0.f;
      }
  };
  auto store_own = [&](int f) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * (c * T + tid) + e;
        if (i < ds) ring[(f % RING) * ds + i] = pend[c][e];
      }
  };
  // This thread's lanes of frame f, which must be the frame after the one
  // taken before; zeros past the row's width and past its last frame.
  const float* slot = ring + 4 * tid;  // of the frame to take next
  auto take = [&](float (&dst)[NC][4], int f) {
    if (f >= L) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[c][e] = 0.f;
      return;
    }
    if (vec && f % CHUNK == 0)
      mbar_wait(&full[f / CHUNK % STAGES], (f / RING) & 1);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * (c * T + tid) < ds)
        v = *reinterpret_cast<const float4*>(slot + 4 * c * T);
      dst[c][0] = v.x, dst[c][1] = v.y, dst[c][2] = v.z, dst[c][3] = v.w;
    }
    slot = (f + 1) % RING == 0 ? ring + 4 * tid : slot + ds;
  };

  if (vec) {
    if (tid == 0) {
      for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
      fence_mbar_init();
      for (int c = 0; c < STAGES; ++c) request(c);
    }
  } else {
    for (int f = 0; f < RING && f < L; ++f) {
      load_own(f);
      store_own(f);
    }
    load_own(RING);
  }
  __syncthreads();
  uint8_t vnext = lane < L ? vrow[lane] : 0;  // the flags of frames 0..31

  float xe[NC][4], xo[NC][4], cr[NC][4];
  take(xe, 0);
  float xx = 0.f, z0 = 0.f, z1 = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cr[c][e] = 0.f;
      xx = fmaf(xe[c][e], xe[c][e], xx);
    }
  warp_sum3(xx, z0, z1);
  cross_warp_sum3(xx, z0, z1, red, 0, warp, lane);
  float rxnorm = rsqrt_approx(xx + 1e-8f);  // about 1 / |x| of the frame at hand
  Divisor by_cnt1(1.f, 1.f);            // cnt + 1

  float cnt = 0.f;
  int start = -1, nseg = 0, nmid = 0;
  // of the 32 frames at hand, a bit a frame, the same in every thread: voiced,
  // closes a segment, is a mid boundary, opens a segment
  unsigned vbits = 0, cbits = 0, bbits = 0, obits = 0;

  // One frame: x is frame t, xn receives frame t + 1.
  auto step = [&](const float (&x)[NC][4], float (&xn)[NC][4], int t) {
    const bool v = (vbits >> (t & 31)) & 1u;
    take(xn, t + 1);

    const float cnt1 = cnt + 1.f;  // 1 .. L, and L <= MAX_COUNT
    // its reciprocal for the next frame, if this one merges: off the chain
    const Divisor by_cnt2(cnt1 + 1.f);
    float dot0 = 0.f, dot1 = 0.f, cc0 = 0.f, cc1 = 0.f, xxn = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        dot0 = fmaf(cr[c][e], x[c][e], dot0);
        dot1 = fmaf(cr[c][e + 1], x[c][e + 1], dot1);
        cc0 = fmaf(cr[c][e], cr[c][e], cc0);
        cc1 = fmaf(cr[c][e + 1], cr[c][e + 1], cc1);
        xxn = fmaf(xn[c][e], xn[c][e], xxn);
        xxn = fmaf(xn[c][e + 1], xn[c][e + 1], xxn);
      }
    float dot = dot0 + dot1, cc = cc0 + cc1;
    warp_sum3(dot, cc, xxn);
    cross_warp_sum3(dot, cc, xxn, red, (t + 1) & 1, warp, lane);
    // every thread has frame t + 1 in registers; after a chunk's last frame
    // its stage takes the chunk STAGES later
    if (vec) {
      if (tid == 0 && (t + 1) % CHUNK == CHUNK - 1)
        request((t + 1) / CHUNK + STAGES);
    } else {
      store_own(t + RING);  // into the slot of frame t, read a frame ago
      load_own(t + 1 + RING);
    }
    // merge = dot / |curr| / |x| >= thr, decided from an estimate of the
    // cosine where that is safe: two approximate reciprocal square roots and
    // two products are within 1e-6 of the quotient while it is below 4, so
    // an estimate more than 1e-5 off the threshold decides as the quotient
    // would. Otherwise (not a number included) the quotient itself decides.
    const float est = (dot * rxnorm) * rsqrt_approx(cc + 1e-8f);
    bool merge = est >= thr;
    if (!(fabsf(est - thr) > 1e-5f && fabsf(est) <= 4.f))
      merge = dot / sqrtf(cc + 1e-8f) / sqrtf(xx + 1e-8f) >= thr;
    rxnorm = rsqrt_approx(xxn + 1e-8f);
    xx = xxn;

    const bool is_first = cnt == 0.f;
    const bool bnd = v && !is_first && !merge;
    const bool cls = (!v && start > -1) || bnd;
    const bool mean = v && merge && !is_first;
    cbits |= (unsigned)cls << (t & 31);
    bbits |= (unsigned)bnd << (t & 31);
    obits |= (unsigned)(v && (is_first || bnd)) << (t & 31);
    // The new mean: separate multiply, add and IEEE division, as the plain
    // version rounds. A numerator outside the divisor's range (an exact zero
    // counts: it costs a second division and no more) is divided again, the
    // slow way.
    if (mean) {  // the same in every thread
      float sum[NC][4];
      float lo = 1.f, hi = 1.f;  // the least and the largest |numerator|
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sum[c][e] = __fadd_rn(__fmul_rn(cr[c][e], cnt), x[c][e]);
          cr[c][e] = by_cnt1.divide(sum[c][e]);
          lo = fminf(lo, fabsf(sum[c][e]));
          hi = fmaxf(hi, fabsf(sum[c][e]));
        }
      if (!(lo >= 0x1p-60f && hi <= 0x1p60f)) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) cr[c][e] = __fdiv_rn(sum[c][e], cnt1);
      }
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) cr[c][e] = v ? x[c][e] : 0.f;
    }
    start = !v ? -1 : ((is_first || bnd) ? t : start);
    cnt = !v ? 0.f : (is_first ? 1.f : cnt1);
    by_cnt1 = !v ? Divisor(1.f, 1.f) : (is_first ? Divisor(2.f, 0.5f) : by_cnt2);
  };

  // 32 frames at a time: their flags arrive as one ballot word (loaded 32
  // frames before), the frame loop has no thread-dependent branch, and then
  // warp 0 writes the events out, a lane per frame, and places the closed
  // segments and mid boundaries by a prefix count.
  for (int t0 = 0; t0 < L; t0 += 32) {
    vbits = __ballot_sync(FULL, vnext != 0);
    vnext = t0 + 32 + lane < L ? vrow[t0 + 32 + lane] : 0;
    cbits = bbits = obits = 0;
    const int start_in = start;
    const int t1 = min(t0 + 32, L);
    for (int t = t0; t < t1; t += 2) {
      step(xe, xo, t);
      if (t + 1 < t1) step(xo, xe, t + 1);
    }
    if (warp == 0 && t0 + lane < L) {
      const int tt = t0 + lane;
      const unsigned below = (1u << lane) - 1u;
      const bool c1 = (cbits >> lane) & 1u, b1 = (bbits >> lane) & 1u;
      // the open segment's start before frame tt: none after an unvoiced
      // frame, else where the last segment opened
      int st = start_in;
      if (lane > 0) {
        const unsigned opened = obits & below;
        if (!((vbits >> (lane - 1)) & 1u)) st = -1;
        else if (opened) st = t0 + 31 - __clz((int)opened);
      }
      const size_t at = (size_t)b * L + tt;
      a.close[at] = (uint8_t)c1;
      a.boundary[at] = (uint8_t)b1;
      a.seg_start[at] = st;
      const int pos = nseg + __popc(cbits & below);
      if (c1) srow[pos] = make_int2(st, tt);
      if (b1) mrow[nmid + __popc(bbits & below)] = make_int2(tt, pos);
    }
    nseg += __popc(cbits);
    nmid += __popc(bbits);
  }

  if (start > -1) {  // the trailing segment
    if (tid == 0) srow[nseg] = make_int2(start, L);
    ++nseg;
  }
  if (tid == 0) {
    a.final_start[b] = start;
    a.nseg[b] = nseg;
    a.nmid[b] = nmid;
  }
  for (int k = nseg + tid; k <= L; k += T) srow[k] = make_int2(0, 0);
  for (int k = nmid + tid; k <= L; k += T) mrow[k] = make_int2(0, 0);
}

// Picks the instance whose threads hold a frame of d floats in NC chunks.
template <int NC = 1>
int launch_pass1(const Pass1Args& a, int B, cudaStream_t stream) {
  if (ceil_div(a.d, 4) <= NC * P1_THREADS) {
    const int smem = RING * 4 * ceil_div(a.d, 4) * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        segment_pass1_kernel<NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    segment_pass1_kernel<NC><<<B, P1_THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  if constexpr (NC * P1_THREADS * 4 < MAX_DIM) {
    return launch_pass1<NC + 1>(a, B, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

constexpr int P2_WARPS = 8;
constexpr int P2_THREADS = P2_WARPS * 32;
constexpr int WIN = 512;  // window frames whose cosines fit in shared memory

// One lane of a segment mean from the prefix sums, rounded as the plain
// version rounds it: a subtraction, then an IEEE division.
__device__ __forceinline__ float mean_lane(float hi, float lo, float len) {
  return __fdiv_rn(__fsub_rn(hi, lo), len);
}

__global__ void __launch_bounds__(P2_THREADS)
    segment_pass2_kernel(const float* __restrict__ states,
                         const float* __restrict__ norms,
                         const float* __restrict__ P,
                         const int2* __restrict__ segs_in,
                         const int* __restrict__ nseg,
                         const int2* __restrict__ mids_in,
                         const int* __restrict__ nmid, int2* work, float* win,
                         int2* __restrict__ out, int* __restrict__ nout, int L,
                         int d, float thr, int vec) {
  __shared__ __align__(16) float ma[MAX_DIM];
  __shared__ __align__(16) float mb[MAX_DIM];
  __shared__ float red[2][3][P2_WARPS];
  __shared__ float swin[2][WIN];
  __shared__ int wtot[P2_WARPS];
  __shared__ int opt_s;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int MS = L + 1;
  const float* xb = states + (size_t)b * L * d;
  const float* nrm = norms + (size_t)b * L;
  const float* Pb = P + (size_t)b * MS * d;
  const int2* segs = segs_in + (size_t)b * MS;
  const int2* mids = mids_in + (size_t)b * MS;
  int2* wk = work + (size_t)b * MS;
  const int n = nseg[b], m = nmid[b];

  for (int k = tid; k < MS; k += P2_THREADS) wk[k] = segs[k];

  // A mid boundary touches segments gi and gi + 1 only, and gi grows from one
  // to the next: segment gi + 1 is still as pass 1 left it, and segment gi is
  // too unless the boundary before was at gi - 1. So every thread carries
  // that one segment along and reads the rest from pass 1's buffers, which
  // nothing writes: the next boundary's entries are loaded one turn ahead.
  int carried = -1, parity = 0;
  int2 carry = make_int2(0, 0);
  auto entries = [&](int j, int2& mid, int& gi, int2& sa, int2& sb) {
    mid = mids[j];
    gi = min(max(mid.y, 0), MS - 2);
    sa = segs[gi];
    sb = segs[gi + 1];
  };
  int2 mid_n = make_int2(0, 0), sa_n = mid_n, sb_n = mid_n;
  int gi_n = 0;
  if (m > 0) entries(0, mid_n, gi_n, sa_n, sb_n);

  for (int j = 0; j < m; ++j) {
    const int2 mid = mid_n, sb = sb_n;
    const int gi = gi_n, bd = mid.x;
    int2 sa = sa_n;
    if (j + 1 < m) entries(j + 1, mid_n, gi_n, sa_n, sb_n);
    if (mid.y >= n - 1) continue;  // the same for every thread of the block
    if (gi == carried) sa = carry;

    const float la = (float)max(sa.y - sa.x, 1);
    const float lb = (float)max(sb.y - sb.x, 1);
    const float* pa1 = Pb + (size_t)sa.y * d;
    const float* pa0 = Pb + (size_t)sa.x * d;
    const float* pb1 = Pb + (size_t)sb.y * d;
    const float* pb0 = Pb + (size_t)sb.x * d;
    float dot = 0.f, aa = 0.f, bb = 0.f;
    if (vec) {
      const int i = 4 * tid;
      if (i < d) {
        const float4 a1 = *reinterpret_cast<const float4*>(pa1 + i);
        const float4 a0 = *reinterpret_cast<const float4*>(pa0 + i);
        const float4 b1 = *reinterpret_cast<const float4*>(pb1 + i);
        const float4 b0 = *reinterpret_cast<const float4*>(pb0 + i);
        const float x[4] = {mean_lane(a1.x, a0.x, la), mean_lane(a1.y, a0.y, la),
                            mean_lane(a1.z, a0.z, la), mean_lane(a1.w, a0.w, la)};
        const float y[4] = {mean_lane(b1.x, b0.x, lb), mean_lane(b1.y, b0.y, lb),
                            mean_lane(b1.z, b0.z, lb), mean_lane(b1.w, b0.w, lb)};
        *reinterpret_cast<float4*>(ma + i) = make_float4(x[0], x[1], x[2], x[3]);
        *reinterpret_cast<float4*>(mb + i) = make_float4(y[0], y[1], y[2], y[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dot = fmaf(x[e], y[e], dot);
          aa = fmaf(x[e], x[e], aa);
          bb = fmaf(y[e], y[e], bb);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < MAX_DIM / P2_THREADS; ++k) {
        const int i = tid + k * P2_THREADS;
        if (i < d) {
          const float x = mean_lane(pa1[i], pa0[i], la);
          const float y = mean_lane(pb1[i], pb0[i], lb);
          ma[i] = x;
          mb[i] = y;
          dot = fmaf(x, y, dot), aa = fmaf(x, x, aa), bb = fmaf(y, y, bb);
        }
      }
    }
    dot = warp_sum(dot);
    aa = warp_sum(aa);
    bb = warp_sum(bb);
    parity ^= 1;  // two buffers: the merge branch has no second barrier
    if (lane == 0) {
      red[parity][0][warp] = dot;
      red[parity][1][warp] = aa;
      red[parity][2][warp] = bb;
    }
    __syncthreads();
    dot = aa = bb = 0.f;
#pragma unroll
    for (int w = 0; w < P2_WARPS; ++w)
    {
      dot += red[parity][0][w];
      aa += red[parity][1][w];
      bb += red[parity][2][w];
    }
    const float na = sqrtf(aa + 1e-8f), nb = sqrtf(bb + 1e-8f);
    carried = gi + 1;
    if (dot / na / nb >= thr) {  // merge: gi dies, gi + 1 takes its start
      carry = make_int2(sa.x, sb.y);
      if (tid == 0) {
        wk[gi] = make_int2(-1, -1);
        wk[gi + 1] = carry;
      }
      continue;
    }

    const int ws = max(sa.x, bd - max((sa.y - sa.x) / 2, 1));
    const int we = min(sb.y, bd + max((sb.y - sb.x) / 2, 1));
    const int nw = we - ws;
    float* cpw = nw <= WIN ? swin[0] : win + (size_t)b * 2 * L;
    float* cnw = nw <= WIN ? swin[1] : win + (size_t)b * 2 * L + L;
    for (int u = ws + warp; u < we; u += P2_WARPS) {
      const float* row = xb + (size_t)u * d;
      float da = 0.f, db = 0.f;
      if (vec) {
        for (int i = lane * 4; i < d; i += 128) {
          const float4 x = *reinterpret_cast<const float4*>(row + i);
          const float4 p = *reinterpret_cast<const float4*>(ma + i);
          const float4 q = *reinterpret_cast<const float4*>(mb + i);
          da = fmaf(x.x, p.x, da), db = fmaf(x.x, q.x, db);
          da = fmaf(x.y, p.y, da), db = fmaf(x.y, q.y, db);
          da = fmaf(x.z, p.z, da), db = fmaf(x.z, q.z, db);
          da = fmaf(x.w, p.w, da), db = fmaf(x.w, q.w, db);
        }
      } else {
        for (int i = lane; i < d; i += 32) {
          da = fmaf(row[i], ma[i], da);
          db = fmaf(row[i], mb[i], db);
        }
      }
      da = warp_sum(da);
      db = warp_sum(db);
      if (lane == 0) {
        cpw[u - ws] = da / (nrm[u] * na);
        cnw[u - ws] = db / (nrm[u] * nb);
      }
    }
    __syncthreads();
    if (tid == 0) {
      float cn_all = 0.f;
      for (int i = 0; i < nw; ++i) cn_all += cnw[i];
      float cp_run = 0.f, cn_run = 0.f, best = 0.f;
      int opt = nw > 0 ? ws : 0;  // an empty window: the argmax of nothing is 0
      for (int i = 0; i < nw; ++i) {
        const float score = cp_run + (cn_all - cn_run);
        if (i == 0 || score > best) best = score, opt = ws + i;
        cp_run += cpw[i];
        cn_run += cnw[i];
      }
      opt_s = opt;
      wk[gi] = make_int2(sa.x, opt);
      wk[gi + 1] = make_int2(opt, sb.y);
    }
    __syncthreads();
    carry = make_int2(opt_s, sb.y);
  }
  __syncthreads();

  // order-preserving compaction of the live segments below nseg
  int2* orow = out + (size_t)b * MS;
  int base = 0;
  for (int k0 = 0; k0 < MS; k0 += P2_THREADS) {
    const int k = k0 + tid;
    const int2 s = k < MS ? wk[k] : make_int2(-1, -1);
    const bool valid = k < n && s.x >= 0;
    const unsigned bal = __ballot_sync(FULL, valid);
    if (lane == 0) wtot[warp] = __popc(bal);
    __syncthreads();
    int at = base + __popc(bal & ((1u << lane) - 1u));
#pragma unroll
    for (int w = 0; w < P2_WARPS; ++w) {
      if (w < warp) at += wtot[w];
      base += wtot[w];
    }
    if (valid) orow[at] = s;
    __syncthreads();
  }
  for (int k = base + tid; k < MS; k += P2_THREADS) orow[k] = make_int2(0, 0);
  if (tid == 0) nout[b] = base;
}

// q[i] = Divisor(c[i]).divide(x[i]) and r[i] = its reciprocal, for the checks.
__global__ void shared_divisor_kernel(const float* __restrict__ x,
                                      const float* __restrict__ c,
                                      float* __restrict__ q,
                                      float* __restrict__ r, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Divisor by(c[i]);
  q[i] = by.divide(x[i]);
  r[i] = by.r;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// states (B, L, d) fp32 contiguous; voiced (B, L) uint8; close, boundary
// (B, L) uint8; seg_start (B, L) int32; final_start, nseg, nmid (B,) int32;
// segs, mids (B, L + 1, 2) int32.
extern "C" int sylber_segment_pass1(const float* states, const uint8_t* voiced,
                                    uint8_t* close, uint8_t* boundary,
                                    int* seg_start, int* final_start, int* segs,
                                    int* nseg, int* mids, int* nmid, int B,
                                    int L, int d, float thr,
                                    cudaStream_t stream) {
  if (d > MAX_DIM || d < 1 || B < 1 || L < 1 || L > MAX_COUNT)
    return (int)cudaErrorInvalidValue;
  const Pass1Args a{states, voiced, close, boundary, seg_start, final_start,
                    (int2*)segs, nseg, (int2*)mids, nmid, L, d, thr,
                    d % 4 == 0 && aligned16(states)};
  return launch_pass1(a, B, stream);
}

// The division pass 1 forms its merged mean with, element by element: x, c,
// q, r (n,) fp32; q = x / c by a shared divisor's steps, r its reciprocal.
extern "C" int sylber_shared_divisor(const float* x, const float* c, float* q,
                                     float* r, int n, cudaStream_t stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  shared_divisor_kernel<<<ceil_div(n, 256), 256, 0, stream>>>(x, c, q, r, n);
  return (int)cudaGetLastError();
}

// Pass 2 and compaction. states (B, L, d), norms (B, L), P (B, L + 1, d) fp32;
// segs, mids (B, L + 1, 2) and nseg, nmid (B,) as pass 1 wrote them; work
// (B, L + 1, 2) int32 and win (B, 2, L) fp32 are scratch; out (B, L + 1, 2)
// int32 and nout (B,) int32 are the compacted segments and their counts.
extern "C" int sylber_segment_pass2(const float* states, const float* norms,
                                    const float* P, const int* segs,
                                    const int* nseg, const int* mids,
                                    const int* nmid, int* work, float* win,
                                    int* out, int* nout, int B, int L, int d,
                                    float thr, cudaStream_t stream) {
  if (d > MAX_DIM || d < 1 || B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const int vec = d % 4 == 0 && aligned16(states) && aligned16(P);
  segment_pass2_kernel<<<B, P2_THREADS, 0, stream>>>(
      states, norms, P, (const int2*)segs, nseg, (const int2*)mids, nmid,
      (int2*)work, win, (int2*)out, nout, L, d, thr, vec);
  return (int)cudaGetLastError();
}
