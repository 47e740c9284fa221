// Blocked online-softmax attention for long sequences, key padding given as
// a per-item valid length.
//
// Replaces sylber_tpu/ops/pallas/flash.py::flash_attention
// (_flash -> _flash_kernel).
//
// Numerics follow the TPU kernel: q, k and v are widened to fp32, q is
// scaled in fp32 (the scale may be overridden), the running max, normaliser
// and accumulator are fp32, masked keys contribute exactly 0, and a query
// row whose keys are all masked (kv_len == 0) gives 0, not NaN.
//
// Bound on the H100: arithmetic. At the encoder's long shape (B32 H12
// L1000 D64) the work is up to ~98 GFLOP against ~0.4 GB of q/k/v/o in
// fp32; this first version runs the products on the fp32 CUDA cores, not
// the tensor cores.
//
// Design. One thread owns one query row: its scaled q and its fp32
// accumulator live in registers (2 x D floats), so the online softmax needs
// no cross-thread reduction. A block of BQ rows streams K and V through
// shared memory in tiles of BK keys; every thread reads the same key at the
// same time, a broadcast. The ragged last tile and the keys past kv_len are
// masked in the kernel, so nothing is padded in device memory. The head
// width is a template bound DM (16, 32 or 64); lanes past the real width
// hold zeros.
#include "common.cuh"

using namespace sylber;

namespace {

constexpr int BQ = 128;  // query rows per block, one per thread
constexpr int BK = 32;   // keys per staged tile
constexpr float NEG = -1e30f;

template <typename T, int DM>
__global__ void __launch_bounds__(BQ)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ kv_len,
                 T* __restrict__ o, int H, int L, int D, float scale) {
  __shared__ float ks[BK][DM];
  __shared__ float vs[BK][DM];
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int row = blockIdx.x * BQ + threadIdx.x;
  const bool live = row < L;
  const size_t base = (size_t)bh * L * D;
  const int lim = min(L, kv_len[b]);

  float qr[DM], acc[DM];
#pragma unroll
  for (int c = 0; c < DM; ++c) {
    qr[c] = (live && c < D) ? to_float(q[base + (size_t)row * D + c]) * scale
                            : 0.f;
    acc[c] = 0.f;
  }
  float m = NEG, l = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK * DM; i += BQ) {
      const int j = i / DM, c = i % DM;
      const bool ok = (k0 + j < L) && c < D;
      const size_t at = base + (size_t)(k0 + j) * D + c;
      ks[j][c] = ok ? to_float(k[at]) : 0.f;
      vs[j][c] = ok ? to_float(v[at]) : 0.f;
    }
    __syncthreads();

    float s[BK];
    float mt = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < DM; ++c) d = fmaf(qr[c], ks[j][c], d);
      s[j] = (k0 + j < lim) ? d : NEG;
      mt = fmaxf(mt, s[j]);
    }
    const float alpha = expf(m - mt);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = (k0 + j < lim) ? expf(s[j] - mt) : 0.f;
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int c = 0; c < DM; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int c = 0; c < DM; ++c) acc[c] = fmaf(s[j], vs[j][c], acc[c]);
    }
    m = mt;
  }

  if (live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < DM; ++c)
      if (c < D) o[base + (size_t)row * D + c] = from_float<T>(acc[c] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* o, int B, int H, int L, int D, float scale,
           cudaStream_t stream) {
  const dim3 grid(ceil_div(L, BQ), B * H);
#define SYLBER_FLASH(DM)                                                  \
  flash_kernel<T, DM><<<grid, BQ, 0, stream>>>(                           \
      (const T*)q, (const T*)k, (const T*)v, kv_len, (T*)o, H, L, D, scale)
  if (D <= 16)
    SYLBER_FLASH(16);
  else if (D <= 32)
    SYLBER_FLASH(32);
  else
    SYLBER_FLASH(64);
#undef SYLBER_FLASH
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o (B, H, L, D) contiguous, fp32 (bf16 == 0) or bf16;
// kv_len (B,) int32.
extern "C" int sylber_flash_attention(const void* q, const void* k,
                                      const void* v, const int* kv_len,
                                      void* o, int B, int H, int L, int D,
                                      float scale, int bf16,
                                      cudaStream_t stream) {
  if (D > 64 || D < 1 || L < 1) return (int)cudaErrorInvalidValue;
  return bf16 ? launch<__nv_bfloat16>(q, k, v, kv_len, o, B, H, L, D, scale,
                                      stream)
              : launch<float>(q, k, v, kv_len, o, B, H, L, D, scale, stream);
}
