// Fused HuBERT frontend layer 0: Conv1d(k=10, s=5, no bias) over the raw
// waveform, GroupNorm with one group per channel, affine, exact-erf GELU.
//
// Replaces sylber_tpu/ops/pallas/frontend.py::fused_conv0_gn_gelu
// (_stats_kernel + _normalize_kernel).
//
// Bound on the H100: the output write. The input is B*L floats, the output
// B*T0*D elements with T0 ~ L/5 and D = 512, so the kernel writes ~100x
// the bytes it reads; the arithmetic (10 FMAs and one erf per element) sits
// below the fp32 rate at that byte count.
//
// Design. GroupNorm needs per-(batch, channel) moments over all T0 frames
// before any output can be written, and blocks run in no order, so there
// are two launches:
//   phase 1 (conv0_stats): one block per (time chunk, batch item), one
//     thread per channel; the block stages its stretch of the waveform in
//     shared memory and each thread sums y and y^2 for its channel over the
//     chunk. Partials go to a (B, chunks, 2, D) fp32 scratch, no atomics,
//     so a rerun gives the same bits.
//   phase 2 (conv0_normalize): one block per (time tile, channel group,
//     batch item); it reduces its channels' partials in chunk order, then
//     recomputes the 10-tap conv from the staged waveform (cheaper than
//     storing y), applies the affine and GELU and writes the output once,
//     coalesced along time, in the (B, D, T0) layout that the next conv
//     reads. Moments include every frame of the padded input, the HF
//     GroupNorm behaviour the model keeps.
#include "common.cuh"

using namespace sylber;

namespace {

constexpr int K = 10;           // conv taps
constexpr int S = 5;            // conv stride
constexpr int CHUNK = 1024;     // frames per phase-1 partial and phase-2 tile
constexpr int XS = (CHUNK - 1) * S + K;  // staged waveform samples per chunk
constexpr int P2_THREADS = 256;
constexpr int P2_CH = 64;       // channels per phase-2 block

__device__ __forceinline__ void stage_chunk(const float* __restrict__ xb,
                                            float* xs, int t0, int nt) {
  const int nx = (nt - 1) * S + K;
  const float* src = xb + (size_t)t0 * S;
  for (int i = threadIdx.x; i < nx; i += blockDim.x) xs[i] = src[i];
}

__global__ void conv0_stats(const float* __restrict__ x,
                            const float* __restrict__ w,
                            float* __restrict__ part, int L, int T0, int D,
                            int nchunks) {
  __shared__ float xs[XS];
  const int c = blockIdx.x, b = blockIdx.y;
  const int t0 = c * CHUNK;
  const int nt = min(CHUNK, T0 - t0);
  stage_chunk(x + (size_t)b * L, xs, t0, nt);
  __syncthreads();
  float* out = part + ((size_t)b * nchunks + c) * 2 * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float wr[K];
#pragma unroll
    for (int j = 0; j < K; ++j) wr[j] = w[d * K + j];
    float s1 = 0.f, s2 = 0.f;
    for (int t = 0; t < nt; ++t) {
      const float* p = xs + t * S;
      float y = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) y = fmaf(wr[j], p[j], y);
      s1 += y;
      s2 = fmaf(y, y, s2);
    }
    out[d] = s1;
    out[D + d] = s2;
  }
}

template <typename OutT>
__global__ void __launch_bounds__(P2_THREADS)
    conv0_normalize(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    const float* __restrict__ part, OutT* __restrict__ out,
                    int L, int T0, int D, int nchunks, float eps) {
  __shared__ float xs[XS];
  __shared__ float ws[P2_CH][K];
  __shared__ float mu[P2_CH], sc[P2_CH], sh[P2_CH];
  const int tile = blockIdx.x, d0 = blockIdx.y * P2_CH, b = blockIdx.z;
  const int nd = min(P2_CH, D - d0);
  const int t0 = tile * CHUNK;
  const int nt = min(CHUNK, T0 - t0);

  const float* pb = part + (size_t)b * nchunks * 2 * D;
  for (int i = threadIdx.x; i < nd; i += blockDim.x) {
    const int d = d0 + i;
    float s1 = 0.f, s2 = 0.f;
    for (int c = 0; c < nchunks; ++c) {
      s1 += pb[(2 * c) * D + d];
      s2 += pb[(2 * c + 1) * D + d];
    }
    const float mean = s1 / (float)T0;
    const float var = fmaxf(s2 / (float)T0 - mean * mean, 0.f);
    mu[i] = mean;
    sc[i] = rsqrtf(var + eps) * gamma[d];
    sh[i] = beta[d];
  }
  for (int i = threadIdx.x; i < nd * K; i += blockDim.x)
    ws[i / K][i % K] = w[(size_t)(d0 + i / K) * K + i % K];
  stage_chunk(x + (size_t)b * L, xs, t0, nt);
  __syncthreads();

  OutT* ob = out + (size_t)b * D * T0 + t0;
  for (int tl = threadIdx.x; tl < nt; tl += P2_THREADS) {
    float xr[K];
#pragma unroll
    for (int j = 0; j < K; ++j) xr[j] = xs[tl * S + j];
    for (int i = 0; i < nd; ++i) {
      float y = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) y = fmaf(ws[i][j], xr[j], y);
      const float z = (y - mu[i]) * sc[i] + sh[i];
      const float g = 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
      ob[(size_t)(d0 + i) * T0 + tl] = from_float<OutT>(g);
    }
  }
}

}  // namespace

extern "C" int sylber_conv0_partials_size(int B, int T0, int D) {
  return B * ceil_div(T0, CHUNK) * 2 * D;
}

// x (B, L) fp32; w (D, K) fp32; gamma, beta (D,) fp32;
// part: sylber_conv0_partials_size floats of scratch;
// out (B, D, T0), fp32 (out_bf16 == 0) or bf16.
extern "C" int sylber_conv0_gn_gelu(const float* x, const float* w,
                                    const float* gamma, const float* beta,
                                    float* part, void* out, int B, int L,
                                    int T0, int D, float eps, int out_bf16,
                                    cudaStream_t stream) {
  const int nchunks = ceil_div(T0, CHUNK);
  const int threads1 = min(512, ceil_div(D, 32) * 32);
  conv0_stats<<<dim3(nchunks, B), threads1, 0, stream>>>(x, w, part, L, T0, D,
                                                         nchunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2(nchunks, ceil_div(D, P2_CH), B);
  if (out_bf16) {
    conv0_normalize<__nv_bfloat16><<<grid2, P2_THREADS, 0, stream>>>(
        x, w, gamma, beta, part, (__nv_bfloat16*)out, L, T0, D, nchunks, eps);
  } else {
    conv0_normalize<float><<<grid2, P2_THREADS, 0, stream>>>(
        x, w, gamma, beta, part, (float*)out, L, T0, D, nchunks, eps);
  }
  return (int)cudaGetLastError();
}
