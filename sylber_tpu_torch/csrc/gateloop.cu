// The GateLoop recurrence on the card: per channel, in time order,
//   s_t = a_t * s_{t-1} + kv_t   (s_{-1} = 0),   o_t = q_t * s_t.
//
// Replaces sylber_tpu/ops/gateloop.py::gate_loop_operator (:26), which XLA
// evaluates as a log-depth lax.associative_scan (:42). On the card the
// sequential walk is the simpler and the cheaper form: the work is
// 2 B L D operations and the channels are independent, so one thread per
// (b, d) channel walks t in order; neighbouring threads take neighbouring d,
// so every load and store of a time step coalesces. The scan rounds in
// another order than the walk, so the two differ by rounding only (the
// plain version walks as this kernel does, with the same rounded
// operations, so the kernel is bit-equal to it).
//
// q, kv and a are (B, L, D) float32 views with a dense last dimension and
// their own (batch, time) strides: the regressor hands in the three thirds
// of its (B, L, 3D) to_qkva product without a copy. The output is (B, L, D)
// contiguous.
//
// Bound on the H100: bytes, 16 B L D (three inputs read, one output
// written; 5.2 us at B8 L265 D512), and the chain of L dependent multiply
// and add pairs of a channel (about 8 cycles a step). The loads do not
// depend on the state, so the unrolled loop has them in flight ahead of it.
#include "common.cuh"

namespace sylber {
namespace gl {

constexpr int THREADS = 128;
constexpr int UNROLL = 8;

__global__ void __launch_bounds__(THREADS)
    gate_loop_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                     const float* __restrict__ a, float* __restrict__ out, int B, int L, int D,
                     long long qb, long long qt, long long kb, long long kt, long long ab,
                     long long at) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)B * D) return;
  const int b = (int)(idx / D), d = (int)(idx % D);
  const float* qc = q + b * qb + d;
  const float* kc = kv + b * kb + d;
  const float* ac = a + b * ab + d;
  float* oc = out + (long long)b * L * D + d;
  float s = 0.f;
  int t = 0;
  for (; t + UNROLL <= L; t += UNROLL) {
    float av[UNROLL], kvv[UNROLL], qv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = ac[(t + u) * at];
      kvv[u] = kc[(t + u) * kt];
      qv[u] = qc[(t + u) * qt];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      s = __fadd_rn(__fmul_rn(av[u], s), kvv[u]);
      oc[(long long)(t + u) * D] = __fmul_rn(qv[u], s);
    }
  }
  for (; t < L; ++t) {
    s = __fadd_rn(__fmul_rn(ac[t * at], s), kc[t * kt]);
    oc[(long long)t * D] = __fmul_rn(qc[t * qt], s);
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
  const long long n = (long long)B * D;
  gate_loop_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const float*)q, (const float*)kv, (const float*)a, (float*)out, B, L, D, strides[0],
      strides[1], strides[2], strides[3], strides[4], strides[5]);
  return (int)cudaGetLastError();
}
