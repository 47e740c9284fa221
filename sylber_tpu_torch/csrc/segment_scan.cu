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
// the update of the mean per frame). In pass 2 a mid boundary depends on the
// one before only when its segment index is that one's + 1 (it reads the
// segment that one left): the boundaries of a row fall into independent
// chains (794 at B32 L1000 on chip_smoke.py's synthetic states, 131 links
// the longest, against 18,817 boundaries). The bytes (B*L*d floats) would
// take microseconds.
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
//   Pass 2: one block per row, so nothing returns to the host and the
//   compaction stays in the launch. The block lists the chains' first
//   boundaries (a ballot and a prefix count), queues the chains of at least
//   a warp's share of the row's boundaries first, and its 8 warps take
//   chains from the queue; a warp walks its chain link by link with no
//   block barrier. Lanes hold 1/32 of each row in registers: the means are
//   taken elementwise from P as the plain version takes them (the quotients
//   by one shared reciprocal, IEEE-exact; __fdiv_rn for the rare numerator
//   out of its range), the dot, |a|^2 and |b|^2 and each window frame's two
//   dots are warp butterflies (every lane gets the same sums and takes the
//   same decisions). Off the chain: the next link's P rows and pass-1
//   entries are loaded a link ahead, and the window's first frames before
//   the merge decision. The frames' cosines go to the warp's shared memory
//   (a global scratch per warp past WIN frames); every lane walks them in
//   order (the order of a sequential cumsum) and takes the first maximum.
//   A merged segment is marked dead by start = -1 in the row's working
//   copy; after a block barrier the live ones are compacted in order.
//   A link is long straight-line code that one warp runs alone: 4,542
//   cycles with every frame voiced at d 768 (scripts/pass2_probe.py's clock64
//   stamps, H100), most in the window's cosines, the walk and the loads of
//   the window's first frame. A branch inside it costs more than the work it
//   skips, so the loads and the means' range test have none: __fdiv_rn for
//   the means took 0.710 ms against 0.484 at B32 L249 (every frame voiced,
//   248 links a chain), the range test written with || 0.809 (the same
//   probe). L1 prefetches of the next window, asking for the next window's
//   frames at the end of a link, and walking windows of up to FR frames in
//   registers were tried and were not faster at d 768.
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
  float thr;              // the merge threshold, unless thr_ptr is set:
  const float* thr_ptr;   // then read from device memory (a 0-d fp32 tensor)
  int vec;  // rows are 16-byte aligned: d % 4 == 0 and the base pointer is
};

// A thread owns NC chunks of 4 floats of every frame.
template <int NC>
__global__ void __launch_bounds__(P1_THREADS)
    segment_pass1_kernel(const Pass1Args a) {
  const int L = a.L, d = a.d, vec = a.vec;
  const float thr = a.thr_ptr ? *a.thr_ptr : a.thr;
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
constexpr int WIN = 64;  // window frames whose cosines a warp keeps in shared memory
constexpr int FR = 2;    // window frames whose rows a warp holds in registers at once

struct Pass2Args {
  const float* states;  // (B, L, d)
  const float* norms;   // (B, L)
  const float* P;       // (B, L + 1, d) prefix sums
  const int2* segs;     // (B, L + 1), nseg (B,): pass 1's segments
  const int* nseg;
  const int2* mids;     // (B, L + 1), nmid (B,): pass 1's mid boundaries
  const int* nmid;
  int2* work;           // (B, L + 1): the row's segments while they are refined
  int* chains;          // (B, 2, L + 1): the chains' first boundaries, then the queue
  float* win;           // (B, P2_WARPS, 2, L): a warp's cosines of a window past WIN
  int2* out;            // (B, L + 1), nout (B,): the compacted segments
  int* nout;
  int L, d;
  float thr;             // the merge threshold, unless thr_ptr is set
  const float* thr_ptr;
};

// The lane's part of the mean of frames [lo, lo + frames) from the prefix
// sums, rounded as the plain version rounds it: a subtraction, then the IEEE
// quotient by the frame count (at least 1). `hi` and `lo` hold the lane's
// part of the rows P[lo + frames] and P[lo], which lie at hi_row and lo_row.
// The quotients come from one shared reciprocal (common.cuh's Divisor, as
// pass 1 divides; chip_smoke.py checks it for every frame count) and the
// range test from a minimum and a maximum, all branch-free: __fdiv_rn's
// check and branch after every quotient keep a lane's quotients from
// overlapping, and so does a test written with || (scripts/pass2_probe.py).
// If a numerator of the warp is out of the reciprocal's range (zeros are
// not), the warp divides the rows again with __fdiv_rn, element by element
// through its scratch row in shared memory.
template <int V, int NCH>
__device__ __forceinline__ void segment_mean(float (&m)[NCH][V], const float (&hi)[NCH][V],
                                             const float (&lo)[NCH][V], int frames,
                                             const float* hi_row, const float* lo_row, int d,
                                             float* scratch, int lane) {
  const float len = (float)max(frames, 1);
  float least = 1.f, most = 0.f;  // the least nonzero and the largest |numerator|
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      m[c][e] = __fsub_rn(hi[c][e], lo[c][e]);
      const float ax = fabsf(m[c][e]);
      least = fminf(least, ax == 0.f ? 1.f : ax);
      most = fmaxf(most, ax);
    }
  const Divisor by(len);
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < V; ++e) m[c][e] = by.divide(m[c][e]);
  if (__any_sync(FULL, !(least >= 0x1p-60f && most <= 0x1p60f))) {
    for (int i = lane; i < d; i += 32) scratch[i] = __fdiv_rn(__fsub_rn(hi_row[i], lo_row[i]), len);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = (c * 32 + lane) * V + e;
        m[c][e] = i < d ? scratch[i] : 0.f;
      }
    __syncwarp();
  }
}

// Lane `lane`'s part of a d-wide row: elements (32 c + lane) V + e, zeros past d.
template <int V, int NCH>
__device__ __forceinline__ void load_row(float (&r)[NCH][V], const float* row, int d,
                                         int lane) {
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int i = (c * 32 + lane) * V;
    if constexpr (V == 4) {
      const float4 v = i < d ? __ldg(reinterpret_cast<const float4*>(row + i))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      r[c][0] = v.x, r[c][1] = v.y, r[c][2] = v.z, r[c][3] = v.w;
    } else {
      r[c][0] = i < d ? __ldg(row + i) : 0.f;
    }
  }
}

template <int V, int NCH>
__device__ __forceinline__ void copy_row(float (&dst)[NCH][V], const float (&src)[NCH][V]) {
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < V; ++e) dst[c][e] = src[c][e];
}

// Sums each of v[0..N) over the warp's lanes; every lane gets the totals, the
// same bits in each (the butterfly adds the same pairs in every lane).
template <int N>
__device__ __forceinline__ void warp_sum_n(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(FULL, v[i], o);
}

// Order-preserving compaction over the block: dst[r] = val(k) for the r-th k
// of [0, n) with keep(k). Every thread of the block calls it and gets the
// count; it ends on a barrier when n > 0.
template <class Keep, class Val, class T>
__device__ __forceinline__ int block_compact(int n, Keep keep, Val val, T* dst, int* wtot) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int base = 0;
  for (int k0 = 0; k0 < n; k0 += P2_THREADS) {
    const int k = k0 + tid;
    const bool kept = k < n && keep(k);
    const unsigned bal = __ballot_sync(FULL, kept);
    if (lane == 0) wtot[warp] = __popc(bal);
    __syncthreads();
    int at = base + __popc(bal & ((1u << lane) - 1u));
#pragma unroll
    for (int w = 0; w < P2_WARPS; ++w) {
      if (w < warp) at += wtot[w];
      base += wtot[w];
    }
    if (kept) dst[at] = val(k);
    __syncthreads();
  }
  return base;
}

// One warp walks the chain of mid boundaries that starts at boundary j. Every
// lane holds its part of the rows (V floats in each of NCH chunks) and all
// lanes take every decision alike; lane 0 writes the segments.
template <int V, int NCH>
__device__ __forceinline__ void walk_chain(const Pass2Args& a, int b, int j, int n, int m,
                                           float* cps, float* cns, float* scratch, int warp,
                                           int lane) {
  const int L = a.L, d = a.d, MS = L + 1;
  const float* xb = a.states + (size_t)b * L * d;
  const float* nrm = a.norms + (size_t)b * L;
  const float* Pb = a.P + (size_t)b * MS * d;
  const int2* segs = a.segs + (size_t)b * MS;
  const int2* mids = a.mids + (size_t)b * MS;
  int2* wk = a.work + (size_t)b * MS;
  float* cpg = a.win + ((size_t)b * P2_WARPS + warp) * 2 * L;
  float* cng = cpg + L;
  auto index = [&](int2 mid) { return min(max(mid.y, 0), MS - 2); };
  auto row = [&](const float* base, int t) { return base + (size_t)t * d; };

  int2 mid = mids[j];
  int gi = index(mid);
  int2 sa = segs[gi], sb = segs[gi + 1];
  float pa0[NCH][V], pa1[NCH][V], pb0[NCH][V], pb1[NCH][V];
  load_row<V, NCH>(pa0, row(Pb, sa.x), d, lane);
  load_row<V, NCH>(pa1, row(Pb, sa.y), d, lane);
  load_row<V, NCH>(pb0, row(Pb, sb.x), d, lane);
  load_row<V, NCH>(pb1, row(Pb, sb.y), d, lane);
  // the next boundary and pass 1's segment gi + 2, a link ahead
  int2 mid_n = j + 1 < m ? mids[j + 1] : make_int2(0, n);
  int2 sb_n = segs[min(gi + 2, MS - 1)];
  for (;;) {
    const bool more = j + 1 < m && mid_n.y < n - 1 && index(mid_n) == gi + 1;
    float nb1[NCH][V];  // the next link's P[sb.y] (a row of P even without one)
    load_row<V, NCH>(nb1, row(Pb, sb_n.y), d, lane);
    const int2 mid_after = mids[min(j + 2, MS - 1)];
    const int2 mid_nn = j + 2 < m ? mid_after : make_int2(0, n);
    const int2 sb_nn = segs[min(gi + 3, MS - 1)];
    // the sweep window, and its first frames, asked for before the decision
    const int bd = mid.x;
    const int ws = max(sa.x, bd - max((sa.y - sa.x) / 2, 1));
    const int we = min(sb.y, bd + max((sb.y - sb.x) / 2, 1));
    const int nw = we - ws;
    // (a frame past the window is a frame of the row all the same, loaded
    // without a branch and never read: branches in a link's straight-line
    // code cost more here than loads)
    float xw[FR][NCH][V], nr[FR];
#pragma unroll
    for (int f = 0; f < FR; ++f) {
      const int u = min(ws + f, L - 1);
      load_row<V, NCH>(xw[f], row(xb, u), d, lane);
      nr[f] = __ldg(nrm + u);
    }

    float ma[NCH][V], mb[NCH][V];
    segment_mean(ma, pa1, pa0, sa.y - sa.x, row(Pb, sa.y), row(Pb, sa.x), d, scratch, lane);
    segment_mean(mb, pb1, pb0, sb.y - sb.x, row(Pb, sb.y), row(Pb, sb.x), d, scratch, lane);
    float s3[3] = {0.f, 0.f, 0.f};  // dot, |a|^2, |b|^2
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s3[0] = fmaf(ma[c][e], mb[c][e], s3[0]);
        s3[1] = fmaf(ma[c][e], ma[c][e], s3[1]);
        s3[2] = fmaf(mb[c][e], mb[c][e], s3[2]);
      }
    warp_sum_n(s3);
    const float na = sqrtf(s3[1] + 1e-8f), nb = sqrtf(s3[2] + 1e-8f);
    const float thr = a.thr_ptr ? *a.thr_ptr : a.thr;
    int2 carry;
    if (s3[0] / na / nb >= thr) {  // merge: gi dies, gi + 1 takes its start
      carry = make_int2(sa.x, sb.y);
      if (lane == 0) {
        wk[gi] = make_int2(-1, -1);
        wk[gi + 1] = carry;
      }
    } else {
      // the cosines of the window's frames, FR at a time, the next FR asked
      // for before this FR's sums are reduced
      float* cpw = nw <= WIN ? cps : cpg;
      float* cnw = nw <= WIN ? cns : cng;
      for (int f0 = 0; f0 < nw; f0 += FR) {
        float s[2 * FR];
#pragma unroll
        for (int f = 0; f < FR; ++f) {
          float da = 0.f, db = 0.f;
#pragma unroll
          for (int c = 0; c < NCH; ++c)
#pragma unroll
            for (int e = 0; e < V; ++e) {
              da = fmaf(xw[f][c][e], ma[c][e], da);
              db = fmaf(xw[f][c][e], mb[c][e], db);
            }
          s[2 * f] = da, s[2 * f + 1] = db;
        }
        float nr_now[FR];
#pragma unroll
        for (int f = 0; f < FR; ++f) {
          nr_now[f] = nr[f];
          const int u = ws + f0 + FR + f;
          if (u < we) {
            load_row<V, NCH>(xw[f], row(xb, u), d, lane);
            nr[f] = __ldg(nrm + u);
          }
        }
        warp_sum_n(s);
        // lane f divides frame f's two sums (the lanes past FR as frame 0)
        float sp = s[0], sn = s[1], nf = nr_now[0];
#pragma unroll
        for (int f = 1; f < FR; ++f)
          if (lane == f) sp = s[2 * f], sn = s[2 * f + 1], nf = nr_now[f];
        const float cp = sp / (nf * na), cn = sn / (nf * nb);
        if (lane < FR && f0 + lane < nw) {
          cpw[f0 + lane] = cp;
          cnw[f0 + lane] = cn;
        }
      }
      __syncwarp();
      // every lane walks the window in order (the order of a sequential
      // cumsum) and takes the first maximum
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
      __syncwarp();  // the next window writes where this one was read
      carry = make_int2(opt, sb.y);
      if (lane == 0) {
        wk[gi] = make_int2(sa.x, opt);
        wk[gi + 1] = carry;
      }
    }
    if (!more) return;
    // the next link: segment gi + 1 as this one left it (P[carry.y] is pb1)
    // and segment gi + 2 as pass 1 left it; P[carry.x] and P[sb_n.x] are
    // loaded whether or not a register holds them already (L1 has them)
    load_row<V, NCH>(pa0, row(Pb, carry.x), d, lane);
    load_row<V, NCH>(pb0, row(Pb, sb_n.x), d, lane);
    copy_row(pa1, pb1);
    copy_row(pb1, nb1);
    ++j, ++gi;
    mid = mid_n, sa = carry, sb = sb_n;
    mid_n = mid_nn, sb_n = sb_nn;
  }
}

// Pass 2 of one batch row per block. The row's mid boundaries fall into
// chains: a boundary depends on the one before only when its segment index is
// that one's + 1 (it reads the segment that one left), so the chains are
// independent and each writes its own segments. Thread blocks list the
// chains' first boundaries, queue the long chains first, and the warps take
// chains from the queue until it is empty; then the block compacts.
template <int V, int NCH>
__global__ void __launch_bounds__(P2_THREADS) segment_pass2_kernel(const Pass2Args a) {
  __shared__ float swin[P2_WARPS][2][WIN];
  __shared__ __align__(16) float scratch[P2_WARPS][MAX_DIM];  // a warp's row, rarely
  __shared__ int wtot[P2_WARPS];
  __shared__ int taken;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int MS = a.L + 1;
  const int2* segs = a.segs + (size_t)b * MS;
  const int2* mids = a.mids + (size_t)b * MS;
  int2* wk = a.work + (size_t)b * MS;
  int* starts = a.chains + (size_t)b * 2 * MS;
  int* queue = starts + MS;
  const int n = a.nseg[b], m = a.nmid[b];

  for (int k = tid; k < MS; k += P2_THREADS) wk[k] = segs[k];
  if (tid == 0) taken = 0;
  __syncthreads();
  // A boundary is skipped when its segment is the last (gi >= nseg - 1); a
  // chain starts at a boundary that is not, unless the boundary before is
  // not skipped either and its segment index is one less.
  auto index = [&](int j) { return min(max(mids[j].y, 0), MS - 2); };
  auto active = [&](int j) { return mids[j].y < n - 1; };
  const int nch = block_compact(
      m,
      [&](int j) {
        return active(j) && (j == 0 || !active(j - 1) || index(j) != index(j - 1) + 1);
      },
      [](int j) { return j; }, starts, wtot);
  // the queue: chains of at least a warp's share of the boundaries first
  auto links = [&](int c) { return (c + 1 < nch ? starts[c + 1] : m) - starts[c]; };
  const int nlong = block_compact(
      nch, [&](int c) { return links(c) * P2_WARPS >= m; }, [&](int c) { return starts[c]; },
      queue, wtot);
  block_compact(
      nch, [&](int c) { return links(c) * P2_WARPS < m; }, [&](int c) { return starts[c]; },
      queue + nlong, wtot);
  for (;;) {
    int q = 0;
    if (lane == 0) q = atomicAdd(&taken, 1);
    q = __shfl_sync(FULL, q, 0);
    if (q >= nch) break;
    walk_chain<V, NCH>(a, b, queue[q], n, m, swin[warp][0], swin[warp][1], scratch[warp], warp,
                       lane);
  }
  __syncthreads();

  // order-preserving compaction of the live segments below nseg
  int2* orow = a.out + (size_t)b * MS;
  const int live = block_compact(
      MS, [&](int k) { return k < n && wk[k].x >= 0; }, [&](int k) { return wk[k]; }, orow,
      wtot);
  for (int k = live + tid; k < MS; k += P2_THREADS) orow[k] = make_int2(0, 0);
  if (tid == 0) a.nout[b] = live;
}

template <int V, int NCH>
int launch_pass2_with(const Pass2Args& a, int B, cudaStream_t stream) {
  segment_pass2_kernel<V, NCH><<<B, P2_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Picks the instance whose lanes hold a row of d floats: float4 chunks where
// rows are 16-byte aligned, single floats otherwise.
int launch_pass2(const Pass2Args& a, int B, bool vec, cudaStream_t stream) {
  if (vec) {
    const int c = ceil_div(a.d, 128);
    if (c <= 2) return launch_pass2_with<4, 2>(a, B, stream);
    if (c <= 4) return launch_pass2_with<4, 4>(a, B, stream);
    if (c <= 6) return launch_pass2_with<4, 6>(a, B, stream);
    return launch_pass2_with<4, 8>(a, B, stream);
  }
  const int c = ceil_div(a.d, 32);
  if (c <= 2) return launch_pass2_with<1, 2>(a, B, stream);
  if (c <= 4) return launch_pass2_with<1, 4>(a, B, stream);
  if (c <= 8) return launch_pass2_with<1, 8>(a, B, stream);
  if (c <= 16) return launch_pass2_with<1, 16>(a, B, stream);
  return launch_pass2_with<1, 32>(a, B, stream);
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
// segs, mids (B, L + 1, 2) int32. The merge threshold is thr, or the float at
// thr_ptr in device memory where thr_ptr is not null (a CUDA graph replays
// its launch arguments; memory it reads anew).
extern "C" int sylber_segment_pass1(const float* states, const uint8_t* voiced,
                                    uint8_t* close, uint8_t* boundary,
                                    int* seg_start, int* final_start, int* segs,
                                    int* nseg, int* mids, int* nmid, int B,
                                    int L, int d, float thr,
                                    const float* thr_ptr, cudaStream_t stream) {
  if (d > MAX_DIM || d < 1 || B < 1 || L < 1 || L > MAX_COUNT)
    return (int)cudaErrorInvalidValue;
  const Pass1Args a{states, voiced, close, boundary, seg_start, final_start,
                    (int2*)segs, nseg, (int2*)mids, nmid, L, d, thr, thr_ptr,
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
// (B, L + 1, 2) int32, chains (B, 2, L + 1) int32 and win (B, 8, 2, L) fp32
// are scratch; out (B, L + 1, 2) int32 and nout (B,) int32 are the compacted
// segments and their counts. The merge threshold as pass 1 takes it.
extern "C" int sylber_segment_pass2(const float* states, const float* norms,
                                    const float* P, const int* segs,
                                    const int* nseg, const int* mids,
                                    const int* nmid, int* work, int* chains,
                                    float* win, int* out, int* nout, int B,
                                    int L, int d, float thr,
                                    const float* thr_ptr, cudaStream_t stream) {
  if (d > MAX_DIM || d < 1 || B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const Pass2Args a{states, norms, P, (const int2*)segs, nseg, (const int2*)mids,
                    nmid, (int2*)work, chains, win, (int2*)out, nout, L, d, thr, thr_ptr};
  return launch_pass2(a, B, d % 4 == 0 && aligned16(states) && aligned16(P), stream);
}
