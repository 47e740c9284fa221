// Single-pass attention for short sequences (L <= 512) with key padding
// given as a per-item valid length.
//
// Replaces sylber_tpu/ops/pallas/smallattn.py::fused_attention_small
// (_kernel).
//
// Numerics follow the TPU kernel, which follows the XLA path: q is scaled in
// the input dtype before QK^T, scores and softmax are fp32, keys at or past
// kv_len score -1e30 (so an item with kv_len == 0 gets the uniform mean of
// V), and the probabilities are rounded to the input dtype before PV, which
// accumulates in fp32.
//
// Bound on the H100: at the encoder's shape (B32 H12 L250 D64) the least
// time is set by memory in bf16 (q, k, v read and o written, ~0.05 GB) and
// by the fp32 CUDA-core rate in fp32 (~5 GFLOP). This first version is well
// above both: each product reads both operands from shared memory.
//
// Design. The TPU kernel held a whole (H, L, L) fp32 score block per batch
// item in VMEM, 12 MB at L = 512, far beyond the 227 KB of shared memory a
// block may use. Here one block owns QT query rows of one (batch, head): it
// keeps their QT x L fp32 scores in shared memory (32 KB at L = 512) and
// streams K, then V, through shared memory in tiles of KT rows. The row
// softmax runs one warp per row. K/V are read once per QT query rows and
// mostly hit L2.
#include "common.cuh"

using namespace sylber;

namespace {

constexpr int QT = 16;       // query rows per block
constexpr int KT = 32;       // key/value rows per staged tile
constexpr int THREADS = 256;
constexpr int MAX_L = 512;
constexpr int MAX_D = 128;
constexpr int MAX_OUT = QT * MAX_D / THREADS;  // outputs per thread
constexpr float NEG = -1e30f;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    small_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ kv_len, T* __restrict__ o,
                           int H, int L, int D, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                      // QT * D
  float* tile = qs + QT * D;             // KT * (D + 1), padded rows
  float* sc = tile + KT * (D + 1);       // QT * L scores / probabilities
  const int DP = D + 1;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int r0 = blockIdx.x * QT;
  const int nr = min(QT, L - r0);
  const int kvl = kv_len[b];
  const size_t base = (size_t)bh * L * D;
  const int tid = threadIdx.x;

  for (int i = tid; i < QT * D; i += THREADS) {
    const int r = i / D;
    qs[i] = r < nr ? round_to<T>(to_float(q[base + (size_t)(r0 + r) * D + i % D]) * scale)
                   : 0.f;
  }

  // scores = (q * scale) @ k^T, masked past kv_len
  for (int k0 = 0; k0 < L; k0 += KT) {
    const int nk = min(KT, L - k0);
    __syncthreads();
    for (int i = tid; i < nk * D; i += THREADS)
      tile[(i / D) * DP + i % D] = to_float(k[base + (size_t)k0 * D + i]);
    __syncthreads();
    for (int i = tid; i < QT * KT; i += THREADS) {
      const int r = i / KT, j = i % KT;
      if (r < nr && j < nk) {
        const float* qr = qs + r * D;
        const float* kr = tile + j * DP;
        float acc = 0.f;
        for (int c = 0; c < D; ++c) acc = fmaf(qr[c], kr[c], acc);
        sc[r * L + k0 + j] = (k0 + j < kvl) ? acc : NEG;
      }
    }
  }
  __syncthreads();

  // fp32 softmax per row, one warp per row; probabilities rounded to T
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < nr; r += THREADS / 32) {
    float* row = sc + r * L;
    float m = NEG;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int j = lane; j < L; j += 32) row[j] = round_to<T>(row[j] / s);
  }

  // o = p @ v, fp32 accumulation
  float acc[MAX_OUT];
#pragma unroll
  for (int u = 0; u < MAX_OUT; ++u) acc[u] = 0.f;
  for (int k0 = 0; k0 < L; k0 += KT) {
    const int nk = min(KT, L - k0);
    __syncthreads();
    for (int i = tid; i < nk * D; i += THREADS)
      tile[(i / D) * DP + i % D] = to_float(v[base + (size_t)k0 * D + i]);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < MAX_OUT; ++u) {
      const int i = tid + u * THREADS;
      if (i < QT * D) {
        const int r = i / D, c = i % D;
        const float* pr = sc + r * L + k0;
        float a = acc[u];
        for (int j = 0; j < nk; ++j) a = fmaf(pr[j], tile[j * DP + c], a);
        acc[u] = a;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < MAX_OUT; ++u) {
    const int i = tid + u * THREADS;
    const int r = i / D;
    if (i < QT * D && r < nr)
      o[base + (size_t)(r0 + r) * D + i % D] = from_float<T>(acc[u]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* o, int B, int H, int L, int D, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (QT * D + KT * (D + 1) + QT * L);
  static bool configured = false;
  if (!configured) {
    const size_t most = sizeof(float) *
                        (QT * MAX_D + KT * (MAX_D + 1) + QT * MAX_L);
    cudaError_t err = cudaFuncSetAttribute(
        small_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(ceil_div(L, QT), B * H);
  small_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_len, (T*)o, H, L, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o (B, H, L, D) contiguous, fp32 (bf16 == 0) or bf16;
// kv_len (B,) int32; scale already rounded to the input dtype.
extern "C" int sylber_small_attention(const void* q, const void* k,
                                      const void* v, const int* kv_len,
                                      void* o, int B, int H, int L, int D,
                                      float scale, int bf16,
                                      cudaStream_t stream) {
  if (L > MAX_L || D > MAX_D || L < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  return bf16 ? launch<__nv_bfloat16>(q, k, v, kv_len, o, B, H, L, D, scale,
                                      stream)
              : launch<float>(q, k, v, kv_len, o, B, H, L, D, scale, stream);
}
