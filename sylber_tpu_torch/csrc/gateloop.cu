// The GateLoop recurrence on the card: per channel, in time order,
//   s_t = a_t * s_{t-1} + kv_t   (s_{-1} = 0),   o_t = q_t * s_t.
//
// Replaces sylber_tpu/ops/gateloop.py::gate_loop_operator (:26), which XLA
// evaluates as a log-depth lax.associative_scan (:42).
//
// Bound on the H100: bytes, 16 B L D (three inputs read, one output
// written; 5.2 us at B8 L265 D512), and the chain of dependent multiply and
// add pairs (about 8 cycles a step). A walk over all L steps of a channel
// is a chain of L pairs, and the channels give only B D / 32 warps of work
// (16 blocks at B1 D512 for 132 SMs), so the time is split into chunks of
// CH steps, a chunked scan inside one block (blocks run in no order, so
// nothing is carried between them):
// - a block takes 32 neighbouring channels d of one batch row b (a warp's
//   lanes, so every time step's row of a chunk coalesces) and WARPS warps;
// - the block walks its time in segments of SEG = WARPS * CPW chunks; warp
//   w takes the chunks w, w + WARPS, ... of a segment and loads their q, kv
//   and a into registers (3 CPW CH values a lane) before any arithmetic, so
//   each input is read once and no step of a walk waits on a load;
// - phase 1: each chunk walked from a zero state, S = a S + kv, beside the
//   product of its a, P = P a; (P, S) to shared memory;
// - phase 2: warp 0 combines the chunks in order, carry_{c+1} = P_c carry_c
//   + S_c, from the carry of the previous segment;
// - phase 3: each chunk walked again from its true carry-in, o = q s.
// The chain is 2 CH + (the segment's chunks) pairs a segment: 2 CH ceil(L /
// (CH SEG)) + ceil(L / CH) in all (192 pairs at L 1015, 81 at L 265).
// 16 warps of a chunk each were measured fastest at the regressor's shapes
// against 8 warps of 4 chunks, 16 of 2 and 32 of 1
// (scripts/quantize_gateloop_probe.py). What bounds it there is the loads:
// the few blocks a batch row has (16 at D 512) each wait for 98 KB a
// segment through one SM (clock64 stamps in PERF.md).
// The plain version (ops/gateloop.py) computes the same chunks in the same
// order with the same rounded operations, so the kernel is bit-equal to it;
// both round in another order than JAX's scan (by rounding only).
//
// q, kv and a are (B, L, D) float32 views with a dense last dimension and
// their own (batch, time) strides: the regressor hands in the three thirds
// of its (B, L, 3D) to_qkva product without a copy. The output is (B, L, D)
// contiguous.
#include "common.cuh"

namespace sylber {
namespace gl {

constexpr int CH = 16;            // time steps a chunk (CHUNK in ops/gateloop.py)
constexpr int WARPS = 16;         // a block: 32 channels x 16 warps
constexpr int CPW = 1;            // chunks a warp holds in a segment
constexpr int SEG = WARPS * CPW;  // chunks a segment: 256 time steps
constexpr int THREADS = WARPS * 32;

__global__ void __launch_bounds__(THREADS, 1)
    gate_loop_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                     const float* __restrict__ a, float* __restrict__ out, int B, int L, int D,
                     long long qb, long long qt, long long kb, long long kt, long long ab,
                     long long at) {
  __shared__ float2 ps[SEG][32];     // a segment's chunks: (product of a, end state from 0)
  __shared__ float carry_in[SEG][32];  // the state entering each chunk of the segment
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = (D + 31) / 32;
  const int b = blockIdx.x / groups, d = blockIdx.x % groups * 32 + lane;
  const bool live = d < D;
  const int nch = (L + CH - 1) / CH;
  const float* qc = q + b * qb + d;
  const float* kc = kv + b * kb + d;
  const float* ac = a + b * ab + d;
  float* oc = out + (long long)b * L * D + d;
  float carry = 0.f;  // warp 0: the state entering the segment
  for (int c0 = 0; c0 < nch; c0 += SEG) {
    float qv[CPW][CH], kvv[CPW][CH], av[CPW][CH];
#pragma unroll
    for (int i = 0; i < CPW; ++i)
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const long long t = (long long)(c0 + warp + WARPS * i) * CH + j;
        const bool in = live && t < L;
        qv[i][j] = in ? qc[t * qt] : 0.f;
        kvv[i][j] = in ? kc[t * kt] : 0.f;
        av[i][j] = in ? ac[t * at] : 1.f;
      }
    // phase 1: each chunk from a zero state
    float p[CPW], s[CPW];
#pragma unroll
    for (int i = 0; i < CPW; ++i) p[i] = 1.f, s[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int i = 0; i < CPW; ++i) {
        s[i] = __fadd_rn(__fmul_rn(av[i][j], s[i]), kvv[i][j]);
        p[i] = __fmul_rn(p[i], av[i][j]);
      }
#pragma unroll
    for (int i = 0; i < CPW; ++i) ps[warp + WARPS * i][lane] = make_float2(p[i], s[i]);
    __syncthreads();
    // phase 2: the carries in chunk order
    if (warp == 0) {
      const int n = min(SEG, nch - c0);
#pragma unroll 8
      for (int c = 0; c < n; ++c) {
        carry_in[c][lane] = carry;
        const float2 v = ps[c][lane];
        carry = __fadd_rn(__fmul_rn(v.x, carry), v.y);
      }
    }
    __syncthreads();
    // phase 3: each chunk from its carry-in
#pragma unroll
    for (int i = 0; i < CPW; ++i) s[i] = carry_in[warp + WARPS * i][lane];
#pragma unroll
    for (int j = 0; j < CH; ++j)
#pragma unroll
      for (int i = 0; i < CPW; ++i) {
        s[i] = __fadd_rn(__fmul_rn(av[i][j], s[i]), kvv[i][j]);
        const long long t = (long long)(c0 + warp + WARPS * i) * CH + j;
        if (live && t < L) oc[t * D] = __fmul_rn(qv[i][j], s[i]);
      }
    // the next segment writes ps only after this one's phase 2 has read it
    // (the barrier above), and carry_in only after its own first barrier
  }
}

}  // namespace gl
}  // namespace sylber

// q, kv, a: (B, L, D) float32, last dimension dense, (batch, time) element
// strides in strides[0..5] as (q_b, q_t, kv_b, kv_t, a_b, a_t); out (B, L, D)
// contiguous.
extern "C" int sylber_gate_loop(const void* q, const void* kv, const void* a, void* out, int B,
                                int L, int D, const long long* strides, void* stream) {
  using namespace sylber::gl;
  if (B <= 0 || L <= 0 || D <= 0) return 0;
  const long long blocks = (long long)B * sylber::ceil_div(D, 32);
  gate_loop_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)kv, (const float*)a, (float*)out, B, L, D, strides[0],
      strides[1], strides[2], strides[3], strides[4], strides[5]);
  return (int)cudaGetLastError();
}
