// Dynamic W8A8 int8 products on the card: a per-row symmetric quantization
// and an int8 x int8 -> int32 GEMM on the tensor cores with the rescale and
// the bias in its epilogue.
//
// Replaces sylber_tpu/ops/int8.py (quantize_symmetric, :43; int8_dense,
// :56), which XLA compiled: per-row (activations) and per-output-channel
// (weights) scales max|x| / 127, q = clip(round_half_even(x / scale), -127,
// 127), an int32 dot_general, then (acc * sx) * sw + b in float32 rounded
// to the output dtype. Weights keep torch's (N, K) layout, so the weight's
// per-output-channel quantization is a per-row one too: one kernel quantizes
// both operands.
//
// sylber_quantize_rows: a warp per row. A pass for max|x| (warp shuffles),
//   the scale max(amax, 1e-8) / 127 and the quotients x / scale as IEEE
//   divisions (as XLA divides; no reciprocal multiply), rintf (half to even,
//   as jnp.round). The int8 output is bit-equal to JAX's. Its row stride is
//   a multiple of 16 bytes and the columns from K to the stride are written
//   as zeros, so the GEMM copies whole 16-byte chunks of any row. Bound:
//   bytes (the input read once, a byte a value written).
// sylber_int8_gemm: out (M, N) = epilogue(A (M, K) . B (N, K)^T), both int8
//   and K-contiguous: the "TN" layout that mma.sync.m16n8k32.row.col.s8.s8
//   takes without a transpose. Blocks of 128 x 128 outputs, 8 warps of 64 x
//   32, K in steps of 64 bytes through a 3-stage ring of cp.async copies
//   (16 bytes a copy, zero-filled past M, N and K: int8 zeros add nothing),
//   fragments by ldmatrix (an m16n8k32 s8 fragment has the bytes of an
//   m16n8k16 b16 one). The int32 sums are exact in any order. The epilogue
//   computes float(acc) * sx[m] * sw[n] + b[n] in that order with rounded
//   operations (no fused multiply-add), so the output is bit-equal to the
//   plain version's. Bound at the encoder's shapes: about even between the
//   bytes (operands and output) and the int8 tensor-core rate; mma.sync
//   reaches part of that rate only, which wgmma would lift (a later change,
//   like quantizing the activations inside the GEMM's prologue).
#include "common.cuh"

namespace sylber {
namespace i8 {

constexpr int Q_THREADS = 256;  // 8 warps, a row per warp
constexpr float MIN_AMAX = 1e-8f;
constexpr float QMAX = 127.f;

constexpr int BM = 128, BN = 128, BK = 64;  // block tile; BK in bytes
constexpr int STAGES = 3;
constexpr int PITCH = BK + 16;  // bytes a row in shared memory: ldmatrix conflict-free
constexpr int G_THREADS = 256;  // 2 x 4 warps of 64 x 32 outputs
constexpr int WM = 64, WN = 32;
constexpr int MI = WM / 16, NI = WN / 8;
constexpr int STAGE_BYTES = (BM + BN) * PITCH;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of the committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
// c += a (16 x 32, row) . b (32 x 8, col), int8 in, int32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// V values of T (16 bytes, or one value) to float.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};
template <int V>
struct alignas(V) Bytes {
  int8_t v[V];
};

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  return (int8_t)fminf(fmaxf(r, -QMAX), QMAX);
}

template <typename T, int V>
__global__ void __launch_bounds__(Q_THREADS)
    quantize_rows_kernel(const T* __restrict__ x, long long ldx, int8_t* __restrict__ q,
                         int ldq, float* __restrict__ scale, int R, int K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * (Q_THREADS / 32) + warp;
  if (r >= R) return;
  const T* xr = x + (long long)r * ldx;
  int8_t* qr = q + (long long)r * ldq;
  float amax = 0.f;
  for (int c = lane * V; c < K; c += 32 * V) {
    const Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(xr + c);
#pragma unroll
    for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(to_float(v.v[i])));
  }
  amax = warp_max(amax);
  const float s = __fdiv_rn(fmaxf(amax, MIN_AMAX), QMAX);
  if (lane == 0) scale[r] = s;
  for (int c = lane * V; c < K; c += 32 * V) {
    const Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(xr + c);
    Bytes<V> out;
#pragma unroll
    for (int i = 0; i < V; ++i) out.v[i] = quantize(to_float(v.v[i]), s);
    *reinterpret_cast<Bytes<V>*>(qr + c) = out;
  }
  for (int c = K + lane; c < ldq; c += 32) qr[c] = 0;  // the zero tail
}

// Copy rows [r0, r0 + rows) x bytes [k0, k0 + BK) of a (R, K) int8 matrix
// (row stride ld, a multiple of 16, zeros from K to ld) into shared memory;
// chunks past R or K are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_tile(int8_t* s, const int8_t* g, int ld, int R, int K,
                                          int r0, int k0) {
  constexpr int CHUNKS = BK / 16;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += G_THREADS) {
    const int r = i / CHUNKS, kc = k0 + (i % CHUNKS) * 16;
    const bool ok = r0 + r < R && kc < K;
    const int8_t* src = ok ? g + (long long)(r0 + r) * ld + kc : g;
    cp_async16(s + r * PITCH + (i % CHUNKS) * 16, src, ok ? 16 : 0);
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b, bool second, bool pair) {
  if (pair && second) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(p) = make_float2(a, b);
    } else {
      __nv_bfloat162 v;
      v.x = from_float<T>(a);
      v.y = from_float<T>(b);
      *reinterpret_cast<__nv_bfloat162*>(p) = v;
    }
  } else {
    p[0] = from_float<T>(a);
    if (second) p[1] = from_float<T>(b);
  }
}

template <typename T>
__global__ void __launch_bounds__(G_THREADS)
    int8_gemm_kernel(const int8_t* __restrict__ A, int lda, const int8_t* __restrict__ B,
                     int ldb, const float* __restrict__ sx, const float* __restrict__ sw,
                     const float* __restrict__ bias, T* __restrict__ out, long long ldo, int M,
                     int N, int K, bool pair) {
  extern __shared__ __align__(128) int8_t gemm_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  auto stage = [&](int s) { return gemm_smem + s * STAGE_BYTES; };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) {
      load_tile<BM>(stage(s), A, lda, M, K, m0, s * BK);
      load_tile<BN>(stage(s) + BM * PITCH, B, ldb, N, K, n0, s * BK);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt has landed; everyone is done with tile kt - 1
    const int nt = kt + STAGES - 1;
    if (nt < ktiles) {  // refill the stage that tile kt - 1 left
      load_tile<BM>(stage(nt % STAGES), A, lda, M, K, m0, nt * BK);
      load_tile<BN>(stage(nt % STAGES) + BM * PITCH, B, ldb, N, K, n0, nt * BK);
    }
    cp_async_commit();
    const int8_t* As = stage(kt % STAGES) + wm * WM * PITCH;
    const int8_t* Bs = stage(kt % STAGES) + BM * PITCH + wn * WN * PITCH;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)  // rows lane % 16, bytes +16 for lanes 16-31
        ldmatrix_x4(af[i], As + (i * 16 + (lane & 15)) * PITCH + kk + (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {  // two n8 tiles: (n, k0-15), (n, k16-31) each
        uint32_t r[4];
        ldmatrix_x4(r, Bs + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * PITCH + kk +
                           ((lane >> 3) & 1) * 16);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: lane (g, t) holds rows g and g + 8, columns 2t and 2t + 1
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int n = n0 + wn * WN + j * 8 + 2 * t;
    if (n >= N) continue;
    const bool second = n + 1 < N;
    const float w0 = sw[n], w1 = second ? sw[n + 1] : 0.f;
    const float b0 = bias ? bias[n] : 0.f, b1 = bias && second ? bias[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * WM + i * 16 + g + 8 * h;
        if (m >= M) continue;
        const float s = sx[m];
        float y0 = __fmul_rn(__fmul_rn((float)acc[i][j][2 * h], s), w0);
        float y1 = __fmul_rn(__fmul_rn((float)acc[i][j][2 * h + 1], s), w1);
        if (bias) {
          y0 = __fadd_rn(y0, b0);
          y1 = __fadd_rn(y1, b1);
        }
        store_pair(out + m * ldo + n, y0, y1, second, pair);
      }
  }
}

template <typename T>
int quantize_launch(const void* x, long long ldx, void* q, int ldq, void* scale, int R, int K,
                    bool vec, cudaStream_t stream) {
  const dim3 grid(ceil_div(R, Q_THREADS / 32));
  constexpr int V = 16 / sizeof(T);
  if (vec)
    quantize_rows_kernel<T, V><<<grid, Q_THREADS, 0, stream>>>(
        (const T*)x, ldx, (int8_t*)q, ldq, (float*)scale, R, K);
  else
    quantize_rows_kernel<T, 1><<<grid, Q_THREADS, 0, stream>>>(
        (const T*)x, ldx, (int8_t*)q, ldq, (float*)scale, R, K);
  return (int)cudaGetLastError();
}

template <typename T>
int gemm_launch(const void* a, int lda, const void* b, int ldb, const void* sx, const void* sw,
                const void* bias, void* out, long long ldo, int M, int N, int K,
                cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const bool pair = ldo % 2 == 0 && (uintptr_t)out % (2 * sizeof(T)) == 0;
  const dim3 grid(ceil_div(N, BN), ceil_div(M, BM));
  int8_gemm_kernel<T><<<grid, G_THREADS, SMEM_BYTES, stream>>>(
      (const int8_t*)a, lda, (const int8_t*)b, ldb, (const float*)sx, (const float*)sw,
      (const float*)bias, (T*)out, ldo, M, N, K, pair);
  return (int)cudaGetLastError();
}

}  // namespace i8
}  // namespace sylber

// x (R, K) float32 or bfloat16 with row stride ldx (elements) -> q (R, K)
// int8 with row stride ldq (a multiple of 16, zeros from K to ldq) and
// scale (R,) float32. `vec`: 16-byte loads (the caller checked K, ldx and
// the address).
extern "C" int sylber_quantize_rows(const void* x, void* q, void* scale, int R, int K,
                                    long long ldx, int ldq, int in_bf16, int vec, void* stream) {
  using namespace sylber::i8;
  if (R <= 0) return 0;
  return in_bf16 ? quantize_launch<__nv_bfloat16>(x, ldx, q, ldq, scale, R, K, vec,
                                                  (cudaStream_t)stream)
                 : quantize_launch<float>(x, ldx, q, ldq, scale, R, K, vec,
                                          (cudaStream_t)stream);
}

// out (M, N), row stride ldo, float32 or bfloat16 = ((float)(A . B^T) * sx)
// * sw + bias; A (M, K), B (N, K) int8 with row strides lda, ldb (multiples
// of 16, zeros from K to the stride), 16-byte aligned; bias may be null.
extern "C" int sylber_int8_gemm(const void* a, const void* b, const void* sx, const void* sw,
                                const void* bias, void* out, int M, int N, int K, int lda,
                                int ldb, long long ldo, int out_bf16, void* stream) {
  using namespace sylber::i8;
  if (M <= 0 || N <= 0) return 0;
  return out_bf16 ? gemm_launch<__nv_bfloat16>(a, lda, b, ldb, sx, sw, bias, out, ldo, M, N, K,
                                               (cudaStream_t)stream)
                  : gemm_launch<float>(a, lda, b, ldb, sx, sw, bias, out, ldo, M, N, K,
                                       (cudaStream_t)stream);
}
