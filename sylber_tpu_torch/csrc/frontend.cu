// Fused HuBERT frontend layer 0: Conv1d(k=10, s=5, no bias) over the raw
// waveform, GroupNorm with one group per channel, affine, erf GELU.
//
// Replaces sylber_tpu/ops/pallas/frontend.py::fused_conv0_gn_gelu
// (_stats_kernel + _normalize_kernel); the moments are taken as
// sylber_tpu/models/hubert.py::_analytic_l0_stats takes them.
//
// Bound on the H100. The input is B*L floats, the output B*T0*D elements with
// T0 ~ L/5 and D = 512: the kernel writes ~100x the bytes it reads, and the
// least time is that of the output write. The first version of this kernel
// did not reach it: fp32 and bf16 output took the same time, so instruction
// issue bound it, not bytes (13 shared loads, 10 FMAs and a 20-instruction
// erff per output element, and a statistics pass that ran the whole
// convolution a second time). This version removes instructions: what is left
// per output element is 11 FMAs, the GELU (~15) and the store, and the fp32
// output is bound by its write; the bf16 output, half the bytes, stays bound
// by issue slots.
//
// Design. GroupNorm needs per-(batch, channel) moments over all T0 frames
// before any output can be written, and blocks run in no order, so there are
// three launches:
//   conv0_moments: the moments of y[t, c] = sum_j w[c, j] x[5t + j] follow
//     from the waveform alone: sum_t y = w_c . u with u_j = sum_t x[5t + j],
//     and sum_t y^2 = w_c' G w_c with G[j, l] = sum_t x[5t + j] x[5t + l].
//     One block per (chunk of frames, batch item) sums the 10 + 55 values in
//     fp64 and writes them to a (B, chunks, 65) scratch: no atomics, a fixed
//     order, so a rerun gives the same bits. Every frame of the padded input
//     counts, the HF GroupNorm behaviour the model keeps.
//   conv0_fold: one block per batch item adds the chunks in order and turns
//     the quadratic form per channel into the folded affine
//     z = y * scale + shift, scale = gamma / sqrt(var + eps),
//     shift = beta - mean * scale, still in fp64.
//   conv0_normalize: one block per (time tile, channel group, batch item)
//     stages its stretch of the waveform in shared memory; a thread keeps the
//     10 samples of R frames a warp-stride apart in registers and walks the
//     block's channels, reading a channel's taps, scale and shift as three
//     128-bit shared loads for R outputs. It recomputes the 10-tap conv
//     (cheaper than storing y), applies the affine and the GELU and writes
//     the output once, each store instruction 32 neighbouring frames of one
//     channel, in the (B, D, T0) layout that the next conv reads.
// The GELU's erf is the TPU kernel's (Abramowitz & Stegun 7.1.26, |error|
// <= 1.5e-7) with the fast exponential and reciprocal, about 15 instructions
// against erff's 20; 1 + erf is formed from the complementary side for
// negative arguments, so nothing cancels.
#include "common.cuh"

using namespace sylber;

namespace {

constexpr int K = 10;  // conv taps
constexpr int S = 5;   // conv stride
constexpr int NMOM = K + K * (K + 1) / 2;  // u_j, then G[j][l] for l >= j
// where G[j][l], l >= j, lies among the NMOM sums
__host__ __device__ constexpr int gram_at(int j, int l) {
  return K + j * K - j * (j - 1) / 2 + (l - j);
}
constexpr int MOM_THREADS = 256;
constexpr int MOM_WARPS = MOM_THREADS / 32;
constexpr int MOM_CHUNK = 4096;  // frames per partial
constexpr int NT = 256;          // threads of the normalise pass
constexpr int R = 4;             // frames a thread
constexpr int TILE = NT * R;     // frames a block
constexpr int XS = (TILE - 1) * S + K;  // staged waveform samples per tile
constexpr int CH = 64;           // channels a block
constexpr int WROW = 12;         // 10 taps, scale, shift

__global__ void __launch_bounds__(MOM_THREADS)
    conv0_moments(const float* __restrict__ x, double* __restrict__ part, int L,
                  int T0, int nchunks) {
  __shared__ double red[MOM_WARPS][NMOM];
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int t1 = min((c + 1) * MOM_CHUNK, T0);
  const float* xb = x + (size_t)b * L;
  double acc[NMOM];
#pragma unroll
  for (int i = 0; i < NMOM; ++i) acc[i] = 0.0;
  for (int t = c * MOM_CHUNK + tid; t < t1; t += MOM_THREADS) {
    double xv[K];
#pragma unroll
    for (int j = 0; j < K; ++j) xv[j] = (double)xb[(size_t)t * S + j];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      acc[j] += xv[j];
#pragma unroll
      for (int l = j; l < K; ++l)
        acc[gram_at(j, l)] = fma(xv[j], xv[l], acc[gram_at(j, l)]);
    }
  }
#pragma unroll
  for (int i = 0; i < NMOM; ++i) {
    const double s = warp_sum(acc[i]);
    if (tid % 32 == 0) red[tid / 32][i] = s;
  }
  __syncthreads();
  if (tid < NMOM) {
    double s = 0.0;
    for (int w = 0; w < MOM_WARPS; ++w) s += red[w][tid];
    part[((size_t)b * nchunks + c) * NMOM + tid] = s;
  }
}

__global__ void __launch_bounds__(MOM_THREADS)
    conv0_fold(const double* __restrict__ part, const float* __restrict__ w,
               const float* __restrict__ gamma, const float* __restrict__ beta,
               float2* __restrict__ fold, int T0, int D, int nchunks,
               float eps) {
  __shared__ double mom[NMOM];
  const int b = blockIdx.x, tid = threadIdx.x;
  if (tid < NMOM) {
    double s = 0.0;
    for (int c = 0; c < nchunks; ++c)
      s += part[((size_t)b * nchunks + c) * NMOM + tid];
    mom[tid] = s;
  }
  __syncthreads();
  for (int ch = tid; ch < D; ch += MOM_THREADS) {
    double wr[K];
    for (int j = 0; j < K; ++j) wr[j] = (double)w[(size_t)ch * K + j];
    double s1 = 0.0, s2 = 0.0;
    for (int j = 0; j < K; ++j) {
      s1 = fma(wr[j], mom[j], s1);
      for (int l = j; l < K; ++l)
        s2 = fma((l == j ? 1.0 : 2.0) * wr[j] * wr[l], mom[gram_at(j, l)], s2);
    }
    const double mean = s1 / (double)T0;
    const double var = fmax(s2 / (double)T0 - mean * mean, 0.0);
    const double scale = (double)gamma[ch] / sqrt(var + (double)eps);
    fold[(size_t)b * D + ch] =
        make_float2((float)scale, (float)((double)beta[ch] - mean * scale));
  }
}

// 0.5 z (1 + erf(z / sqrt 2)); pe is erfc(|z| / sqrt 2).
__device__ __forceinline__ float gelu_erf(float z) {
  const float a = fabsf(z) * 0.70710678118654752f;
  const float t = rcp_approx(fmaf(0.3275911f, a, 1.f));
  float p = fmaf(t, 1.061405429f, -1.453152027f);
  p = fmaf(p, t, 1.421413741f);
  p = fmaf(p, t, -0.284496736f);
  p = fmaf(p, t, 0.254829592f);
  const float pe = p * t * ex2_approx(a * a * -1.4426950408889634f);
  return 0.5f * z * (z >= 0.f ? 2.f - pe : pe);
}

// (NT, 1): promised more blocks an SM, the compiler interleaves the R chains
// of a thread worse and the kernel takes a quarter longer; it uses 64
// registers either way, so four blocks fit.
template <typename OutT>
__global__ void __launch_bounds__(NT, 1)
    conv0_normalize(const float* __restrict__ x, const float* __restrict__ w,
                    const float2* __restrict__ fold, OutT* __restrict__ out,
                    int L, int T0, int D) {
  __shared__ float xs[XS];
  __shared__ __align__(16) float ws[CH][WROW];
  const int tid = threadIdx.x;
  const int d0 = blockIdx.y * CH, b = blockIdx.z;
  const int nd = min(CH, D - d0);
  const int t0 = blockIdx.x * TILE;
  const int nt = min(TILE, T0 - t0);

  const float* src = x + (size_t)b * L + (size_t)t0 * S;
  const int nx = (nt - 1) * S + K;
  for (int i = tid; i < nx; i += NT) xs[i] = src[i];
  for (int i = tid; i < nd * WROW; i += NT) {
    const int c = i / WROW, j = i % WROW;
    const float2 f = fold[(size_t)b * D + d0 + c];
    ws[c][j] = j < K ? w[(size_t)(d0 + c) * K + j] : (j == K ? f.x : f.y);
  }
  __syncthreads();

  // frames tl0 + 32 r, r < R: a warp's store covers 32 neighbouring frames
  const int tl0 = (tid / 32) * 32 * R + tid % 32;
  float xr[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int tl = tl0 + 32 * r;
#pragma unroll
    for (int j = 0; j < K; ++j) xr[r][j] = tl < nt ? xs[tl * S + j] : 0.f;
  }
  OutT* ob = out + ((size_t)b * D + d0) * T0 + t0 + tl0;
  for (int c = 0; c < nd; ++c) {
    const float4 w0 = *reinterpret_cast<const float4*>(&ws[c][0]);
    const float4 w1 = *reinterpret_cast<const float4*>(&ws[c][4]);
    const float4 w2 = *reinterpret_cast<const float4*>(&ws[c][8]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float y = xr[r][0] * w0.x;
      y = fmaf(xr[r][1], w0.y, y);
      y = fmaf(xr[r][2], w0.z, y);
      y = fmaf(xr[r][3], w0.w, y);
      y = fmaf(xr[r][4], w1.x, y);
      y = fmaf(xr[r][5], w1.y, y);
      y = fmaf(xr[r][6], w1.z, y);
      y = fmaf(xr[r][7], w1.w, y);
      y = fmaf(xr[r][8], w2.x, y);
      y = fmaf(xr[r][9], w2.y, y);
      const float g = gelu_erf(fmaf(y, w2.z, w2.w));
      if (tl0 + 32 * r < nt) ob[(size_t)c * T0 + 32 * r] = from_float<OutT>(g);
    }
  }
}

}  // namespace

// Elements of the fp64 scratch `part` for an input of T0 frames.
extern "C" int sylber_conv0_partials_size(int B, int T0) {
  return B * ceil_div(T0, MOM_CHUNK) * NMOM;
}

// x (B, L) fp32; w (D, K) fp32; gamma, beta (D,) fp32;
// part: sylber_conv0_partials_size doubles of scratch; fold: (B, D, 2) fp32
// of scratch (scale, shift); out (B, D, T0), fp32 (out_bf16 == 0) or bf16.
extern "C" int sylber_conv0_gn_gelu(const float* x, const float* w,
                                    const float* gamma, const float* beta,
                                    double* part, float* fold, void* out, int B,
                                    int L, int T0, int D, float eps,
                                    int out_bf16, cudaStream_t stream) {
  const int nchunks = ceil_div(T0, MOM_CHUNK);
  conv0_moments<<<dim3(nchunks, B), MOM_THREADS, 0, stream>>>(x, part, L, T0,
                                                              nchunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  conv0_fold<<<B, MOM_THREADS, 0, stream>>>(part, w, gamma, beta, (float2*)fold,
                                            T0, D, nchunks, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ceil_div(T0, TILE), ceil_div(D, CH), B);
  if (out_bf16) {
    conv0_normalize<__nv_bfloat16><<<grid, NT, 0, stream>>>(
        x, w, (const float2*)fold, (__nv_bfloat16*)out, L, T0, D);
  } else {
    conv0_normalize<float><<<grid, NT, 0, stream>>>(
        x, w, (const float2*)fold, (float*)out, L, T0, D);
  }
  return (int)cudaGetLastError();
}
