// Tiles, fragments and the online-softmax step shared by the two attention
// kernels (smallattn.cu, flash.cu).
//
// Both kernels compute softmax(q k^T * scale) v over (B, H, L, D) with the
// keys at or past kv_len[b] masked, and differ only in the numerics each TPU
// kernel fixes (XLA_NUMERICS below) and in their limits. Each dtype has a
// kernel of its own design:
//
// bf16: attn_mma_kernel, tensor cores. K and V tiles of 64 keys stay in bf16
//   in shared memory and arrive by cp.async (16 bytes a thread) in a ring of
//   stages, the next tiles loading under the current tile's products.
//   S = Q K^T accumulates in fp32 registers (mma.sync.m16n8k16 with ldmatrix,
//   ldmatrix.trans for V), the online softmax runs on the accumulator
//   fragments with shuffles over the 4 lanes that share a row, P is rounded
//   to bf16 in registers and reused as the A operand of P V with no trip
//   through shared memory, O accumulates in fp32 registers and leaves through
//   the block's Q tile as 16-byte stores. Rows are padded by 16 bytes so that
//   every ldmatrix phase touches 8 different 16-byte bank groups; each warp
//   owns MW slabs of 16 query rows and keeps their Q fragments in registers.
//   The kernel is bound by ldmatrix traffic: every B fragment crosses the
//   registers, and two slabs a warp halve that traffic per mma.
//
// fp32: attn_f32_kernel, CUDA cores, register-tiled. TF32 mma keeps three
//   decimal digits and the fp32 mode holds 2e-5, so the products stay fmaf.
//   256 threads as 16 x 16; a thread owns 8 query rows x (BN / 16) keys of
//   S and 8 rows x (DP / 16) channels of O and reads both operands as
//   float4 from shared memory, one 16-byte shared load per 8 fmaf. The 16
//   threads that share a row are one half-warp, so the row maximum is four
//   shuffles and P crosses from the S layout to the PV layout through a
//   warp-private strip of shared memory with no block barrier. K and V tiles
//   arrive by cp.async in 2 stages; one __syncthreads per key tile.
//
// Both: the key loop ends at kv_len[b] (tiles wholly past it are skipped,
// the one that straddles it is masked); rows past L and columns past D are
// zero-filled in shared memory, never in device memory; q, k, v and o are
// addressed by (batch, head, row) strides, the last dimension is dense.
// Head widths are padded to DP = 16, 32, 64 or 128 in shared memory. Rows
// that are not 16-byte aligned (D = 12) take scalar loads and stores.
#pragma once

#include "common.cuh"

namespace sylber {
namespace attn {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  void* o;
  int B, H, L, D;
  long long qs[3], ks[3], vs[3], os[3];  // element strides: batch, head, row
  float scale;
};

constexpr float LOG2E = 1.4426950408889634f;
// The tensor-core kernel's block: keys per tile, warps, 16-row slabs per warp
// and stages of the key ring. Two slabs halve the ldmatrix traffic per mma,
// which is what bounds the kernel; at DP = 128 the registers allow one slab
// and the shared memory two stages.
constexpr int BN_MMA = 64, MMA_NW = 4, MMA_MW = 2, MMA_STAGES = 3;
// Query rows per block of the fp32 kernel: 8 a thread.
constexpr int F32_BM = 128;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; bytes == 0 writes zeros and reads nothing.
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
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Stage rows [r0, r0 + ROWS) of a (L, D) matrix with row stride rs into
// shared memory, row stride DP + 16 bytes; rows >= L and columns >= D
// become zeros. vec: every row start and D are multiples of 16 bytes.
template <typename T, int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(T* s, const T* g, long long rs, int r0,
                                          int L, int D, int vec, int tid) {
  constexpr int E = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = DP / E;
  constexpr int SS = DP + E;
  if (vec) {
    for (int i = tid; i < ROWS * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * E;
      const bool ok = (r0 + r < L) && (c < D);
      const T* src = ok ? g + (long long)(r0 + r) * rs + c : g;
      cp_async16(s + r * SS + c, src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, c = i % DP;
      const bool ok = (r0 + r < L) && (c < D);
      s[r * SS + c] = ok ? g[(long long)(r0 + r) * rs + c] : from_float<T>(0.f);
    }
  }
}

// The valid key count of item b and whether it takes the uniform mean.
template <bool XLA_NUMERICS>
__device__ __forceinline__ int key_limit(const Args& a, int b, bool* uniform) {
  const int kvl = min(a.kv_len[b], a.L);
  *uniform = XLA_NUMERICS && kvl <= 0;
  return *uniform ? a.L : max(kvl, 0);
}

// ---------------------------------------------- accumulator fragments
//
// mma.sync hands a thread this piece of a 16-row slab of scores: for each
// block nb of 8 keys, c[nb][0..1] are row g, keys 2t and 2t + 1, and
// c[nb][2..3] the same keys of row g + 8 (g = lane / 4, t = lane % 4).

// Keys at or past lim weigh 0; an item that takes the uniform mean scores 0
// on every key it has.
template <int NB>
__device__ __forceinline__ void mask_keys(float (&s)[NB][4], int k0, int t, int lim,
                                          bool uniform) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool keep = k0 + nb * 8 + 2 * t + e < lim;
      s[nb][e] = keep ? (uniform ? 0.f : s[nb][e]) : neg_inf();
      s[nb][2 + e] = keep ? (uniform ? 0.f : s[nb][2 + e]) : neg_inf();
    }
  }
}

// One online-softmax step: s becomes exp(s - running max), the running max m,
// the thread's share l of the row sums and the accumulator o are rescaled.
// The first key of every tile is valid, so the new maximum is finite.
template <int NB, int ND>
__device__ __forceinline__ void softmax_step(float (&s)[NB][4], float (&m)[2],
                                             float (&l)[2], float (&o)[ND][4]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = neg_inf();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      mx = fmaxf(mx, fmaxf(s[nb][2 * hh], s[nb][2 * hh + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[hh], mx);
    const float alpha = fast_exp2((m[hh] - mn) * LOG2E);
    const float ms = mn * LOG2E;
    float rs = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = fast_exp2(fmaf(s[nb][2 * hh + e], LOG2E, -ms));
        s[nb][2 * hh + e] = p;
        rs += p;
      }
    }
    l[hh] = l[hh] * alpha + rs;
    m[hh] = mn;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][2 * hh] *= alpha;
      o[nd][2 * hh + 1] *= alpha;
    }
  }
}

// P of keys [16 kk, 16 kk + 16) rounded to bf16: the A operand of P V.
template <int NB>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4], const float (&s)[NB][4], int kk) {
  pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// 1 / row sum for rows g and g + 8, from the four lanes' shares.
__device__ __forceinline__ float inverse_row_sum(float share) {
  share += __shfl_xor_sync(0xffffffffu, share, 1);
  share += __shfl_xor_sync(0xffffffffu, share, 2);
  return 1.f / fmaxf(share, 1e-30f);
}

// q * scale rounded to bf16 in place, as the XLA path scales q in the input
// dtype: rows x width elements from p, row stride in elements.
__device__ __forceinline__ void scale_rows_bf16(__nv_bfloat16* p, int rows, int width,
                                                int stride, float scale, int tid,
                                                int threads) {
  for (int i = tid; i < rows * (width / 2); i += threads) {
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(
        p + (i / (width / 2)) * stride + (i % (width / 2)) * 2);
    const float2 f = __bfloat1622float2(*x);
    *x = __floats2bfloat162_rn(f.x * scale, f.y * scale);
  }
}

// ------------------------------------------------------------------ bf16

template <int DP, int NW, int MW, int ST, bool XLA_NUMERICS>
__global__ void __launch_bounds__(NW * 32)
    attn_mma_kernel(const Args a, const int vec) {
  using T = __nv_bfloat16;
  constexpr int NT = NW * 32, BM = NW * MW * 16, BN = BN_MMA;
  constexpr int SS = DP + 8, KD = DP / 16, ND = DP / 8;
  static_assert(ST >= 2, "the ring needs a tile to compute on and one in flight");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // BM x SS
  T* Ks = Qs + BM * SS;                    // ST stages x BN x SS
  T* Vs = Ks + ST * BN * SS;               // ST stages x BN x SS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BM;
  bool uniform;
  const int lim = key_limit<XLA_NUMERICS>(a, b, &uniform);
  const int nt = (lim + BN - 1) / BN;
  const T* qg = (const T*)a.q + b * a.qs[0] + h * a.qs[1];
  const T* kg = (const T*)a.k + b * a.ks[0] + h * a.ks[1];
  const T* vg = (const T*)a.v + b * a.vs[0] + h * a.vs[1];
  T* og = (T*)a.o + b * a.os[0] + h * a.os[1];

  // Q and the first ST - 1 key tiles, one group each (empty past the end)
  load_tile<T, DP, BM, NT>(Qs, qg, a.qs[2], q0, a.L, a.D, vec, tid);
#pragma unroll
  for (int st = 0; st < ST - 1; ++st) {
    if (st < nt) {
      load_tile<T, DP, BN, NT>(Ks + st * BN * SS, kg, a.ks[2], st * BN, a.L, a.D, vec, tid);
      load_tile<T, DP, BN, NT>(Vs + st * BN * SS, vg, a.vs[2], st * BN, a.L, a.D, vec, tid);
    }
    cp_async_commit();
  }
  cp_async_wait<ST - 2>();
  __syncthreads();
  T* Qw = Qs + warp * MW * 16 * SS;  // the rows this warp owns
  if (XLA_NUMERICS) {
    scale_rows_bf16(Qw, MW * 16, DP, SS, a.scale, lane, 32);
    __syncwarp();
  }
  // otherwise q stays as it is and the fp32 scores are scaled: no rounding
  const float s_scale = XLA_NUMERICS ? 1.f : a.scale;

  uint32_t qf[MW][KD][4];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldmatrix_x4(qf[mi][kk],
                  Qw + (mi * 16 + (lane & 15)) * SS + kk * 16 + (lane >> 4) * 8);

  float o[MW][ND][4];
  float m[MW][2], l[MW][2];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
    m[mi][0] = m[mi][1] = neg_inf();
    l[mi][0] = l[mi][1] = 0.f;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      o[mi][nd][0] = o[mi][nd][1] = o[mi][nd][2] = o[mi][nd][3] = 0.f;
  }

  // lane offsets of the ldmatrix rows inside a 16 x 16 operand block
  const int k_off = ((lane >> 4) * 8 + (lane & 7)) * SS + ((lane >> 3) & 1) * 8;
  const int v_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * SS + (lane >> 4) * 8;

  for (int it = 0; it < nt; ++it) {
    const int k0 = it * BN;
    if (it > 0) {
      cp_async_wait<ST - 2>();
      __syncthreads();  // tile it has landed; everyone is done with tile it-1
    }
    {  // refill the stage that tile it-1 left with tile it + ST - 1
      const int nx = it + ST - 1, st = nx % ST;
      if (nx < nt) {
        load_tile<T, DP, BN, NT>(Ks + st * BN * SS, kg, a.ks[2], nx * BN, a.L, a.D, vec, tid);
        load_tile<T, DP, BN, NT>(Vs + st * BN * SS, vg, a.vs[2], nx * BN, a.L, a.D, vec, tid);
      }
      cp_async_commit();
    }
    const T* Kt = Ks + (it % ST) * BN * SS;
    const T* Vt = Vs + (it % ST) * BN * SS;

    // S = Q K^T
    float s[MW][BN / 8][4];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb)
        s[mi][nb][0] = s[mi][nb][1] = s[mi][nb][2] = s[mi][nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Kt + np * 16 * SS + kk * 16 + k_off);
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          mma_bf16(s[mi][2 * np], qf[mi][kk], kb[0], kb[1]);
          mma_bf16(s[mi][2 * np + 1], qf[mi][kk], kb[2], kb[3]);
        }
      }
    }

    if (!XLA_NUMERICS) {
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mi][nb][e] *= s_scale;
    }

    // mask the tile that straddles the limit (or L), then the softmax step
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) {
      if (uniform || k0 + BN > lim) mask_keys(s[mi], k0, t, lim, uniform);
      softmax_step(s[mi], m[mi], l[mi], o[mi]);
    }

    // O += P V, P rounded to bf16 in registers
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[MW][4];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) pack_p(pa[mi], s[mi], kk);
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vt + kk * 16 * SS + np * 16 + v_off);
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          mma_bf16(o[mi][2 * np], pa[mi], vb[0], vb[1]);
          mma_bf16(o[mi][2 * np + 1], pa[mi], vb[2], vb[3]);
        }
      }
    }
  }

  // normalise, stage through the warp's own Q rows, store 16 bytes a lane
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float inv = inverse_row_sum(l[mi][hh]);
      T* row = Qw + (mi * 16 + g + 8 * hh) * SS + 2 * t;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        *reinterpret_cast<__nv_bfloat162*>(row + nd * 8) = __floats2bfloat162_rn(
            o[mi][nd][2 * hh] * inv, o[mi][nd][2 * hh + 1] * inv);
    }
  }
  __syncwarp();
  const int w0 = q0 + warp * MW * 16;
  if (vec) {
    for (int i = lane; i < MW * 16 * ND; i += 32) {
      const int r = i / ND, c = (i % ND) * 8;
      if (w0 + r < a.L && c < a.D)
        *reinterpret_cast<uint4*>(og + (long long)(w0 + r) * a.os[2] + c) =
            *reinterpret_cast<const uint4*>(Qw + r * SS + c);
    }
  } else {
    for (int i = lane; i < MW * 16 * DP; i += 32) {
      const int r = i / DP, c = i % DP;
      if (w0 + r < a.L && c < a.D) og[(long long)(w0 + r) * a.os[2] + c] = Qw[r * SS + c];
    }
  }
}

// ------------------------------------------------------------------ fp32

template <int N>
__device__ __forceinline__ void load_floats(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int u = 0; u < N / 4; ++u) {
      const float4 x = *reinterpret_cast<const float4*>(src + 4 * u);
      dst[4 * u] = x.x, dst[4 * u + 1] = x.y, dst[4 * u + 2] = x.z, dst[4 * u + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x, dst[1] = x.y;
  } else {
#pragma unroll
    for (int u = 0; u < N; ++u) dst[u] = src[u];
  }
}

__host__ __device__ constexpr int f32_bn(int DP) { return DP == 128 ? 32 : 64; }

template <int DP, int BM, bool XLA_NUMERICS>
__global__ void __launch_bounds__(256)
    attn_f32_kernel(const Args a, const int vec) {
  constexpr int NT = 256, TX = 16, RM = BM / 16, BN = f32_bn(DP);
  constexpr int KN = BN / TX, CH = DP / TX, SS = DP + 4, PS = BM + 4;
  static_assert(RM % 4 == 0, "rows per thread are read as float4");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // BM x SS
  float* Ks = Qs + BM * SS;                        // 2 stages x BN x SS
  float* Vs = Ks + 2 * BN * SS;                    // 2 stages x BN x SS
  float* Pt = Vs + 2 * BN * SS;                    // BN x PS, key-major

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * BM;
  bool uniform;
  const int lim = key_limit<XLA_NUMERICS>(a, b, &uniform);
  const int nt = (lim + BN - 1) / BN;
  const float* qg = (const float*)a.q + b * a.qs[0] + h * a.qs[1];
  const float* kg = (const float*)a.k + b * a.ks[0] + h * a.ks[1];
  const float* vg = (const float*)a.v + b * a.vs[0] + h * a.vs[1];
  float* og = (float*)a.o + b * a.os[0] + h * a.os[1];

  load_tile<float, DP, BM, NT>(Qs, qg, a.qs[2], q0, a.L, a.D, vec, tid);
  load_tile<float, DP, BN, NT>(Ks, kg, a.ks[2], 0, a.L, a.D, vec, tid);
  load_tile<float, DP, BN, NT>(Vs, vg, a.vs[2], 0, a.L, a.D, vec, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < BM * DP; i += NT) Qs[(i / DP) * SS + i % DP] *= a.scale;
  __syncthreads();

  float acc[RM][CH], m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[i][c] = 0.f;
  }
  const float* qb = Qs + ty * RM * SS;
  float* pw = Pt + tx * PS + ty * RM;        // this thread's P entries, key tx
  const float* pr = Pt + ty * RM;            // its rows of P, any key

  for (int it = 0; it < nt; ++it) {
    const int k0 = it * BN;
    if (it > 0) {
      cp_async_wait<0>();
      __syncthreads();  // tile it has landed; everyone is done with tile it-1
    }
    if (it + 1 < nt) {
      const int st = (it + 1) & 1;
      load_tile<float, DP, BN, NT>(Ks + st * BN * SS, kg, a.ks[2], k0 + BN, a.L, a.D, vec, tid);
      load_tile<float, DP, BN, NT>(Vs + st * BN * SS, vg, a.vs[2], k0 + BN, a.L, a.D, vec, tid);
      cp_async_commit();
    }
    const float* kb = Ks + (it & 1) * BN * SS + tx * SS;  // keys tx + 16 j
    const float* vb = Vs + (it & 1) * BN * SS + tx * CH;  // channels tx CH + c

    // S micro-tile: RM rows x KN keys
    float s[RM][KN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < KN; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < DP; d += 4) {
      float4 qv[RM], kv[KN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qb + i * SS + d);
#pragma unroll
      for (int j = 0; j < KN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kb + j * TX * SS + d);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < KN; ++j) {
          float x = s[i][j];
          x = fmaf(qv[i].x, kv[j].x, x);
          x = fmaf(qv[i].y, kv[j].y, x);
          x = fmaf(qv[i].z, kv[j].z, x);
          x = fmaf(qv[i].w, kv[j].w, x);
          s[i][j] = x;
        }
      }
    }

    if (uniform || k0 + BN > lim) {
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const bool keep = k0 + tx + TX * j < lim;
#pragma unroll
        for (int i = 0; i < RM; ++i)
          s[i][j] = keep ? (uniform ? 0.f : s[i][j]) : neg_inf();
      }
    }

    // online softmax; the 16 lanes of a half-warp share a row
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < KN; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mn = fmaxf(m[i], mx);  // finite: key k0 is valid
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < CH; ++c) acc[i][c] *= alpha;
    }

    // P to the key-major strip of this half-warp, then O += P V
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int u = 0; u < RM / 4; ++u)
        *reinterpret_cast<float4*>(pw + j * TX * PS + 4 * u) =
            make_float4(s[4 * u][j], s[4 * u + 1][j], s[4 * u + 2][j], s[4 * u + 3][j]);
    __syncwarp();
#pragma unroll 8
    for (int kk = 0; kk < BN; ++kk) {
      float pv[RM], vv[CH];
      load_floats<RM>(pv, pr + kk * PS);
      load_floats<CH>(vv, vb + kk * SS);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CH; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncwarp();  // the strip is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float sum = l[i];
#pragma unroll
    for (int w = 8; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int row = q0 + ty * RM + i;
    if (row >= a.L) continue;
    float* dst = og + (long long)row * a.os[2] + tx * CH;
    if constexpr (CH % 4 == 0) {
      if (vec) {
#pragma unroll
        for (int u = 0; u < CH / 4; ++u)
          if (tx * CH + 4 * u < a.D)
            *reinterpret_cast<float4*>(dst + 4 * u) =
                make_float4(acc[i][4 * u] * inv, acc[i][4 * u + 1] * inv,
                            acc[i][4 * u + 2] * inv, acc[i][4 * u + 3] * inv);
        continue;
      }
    }
#pragma unroll
    for (int c = 0; c < CH; ++c)
      if (tx * CH + c < a.D) dst[c] = acc[i][c] * inv;
  }
}

// --------------------------------------------------------------- launches

// cudaFuncSetAttribute sets the attribute for the current device only, so
// each instance keeps a flag a device.
constexpr int MAX_DEVICES = 64;

template <typename K>
int configure(K kernel, size_t smem, bool (&done)[MAX_DEVICES]) {
  int device = 0;
  if (const cudaError_t err = cudaGetDevice(&device)) return (int)err;
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidValue;
  if (done[device]) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  done[device] = err == cudaSuccess;
  return (int)err;
}

template <int DP, int NW, int MW, int ST, bool XLA>
int launch_mma(const Args& a, int vec, cudaStream_t stream) {
  constexpr int BM = NW * MW * 16;
  constexpr size_t smem = sizeof(__nv_bfloat16) * (DP + 8) * (BM + 2 * ST * BN_MMA);
  static_assert(smem <= 232448, "a block may use 227 KB of shared memory");
  static bool done[MAX_DEVICES] = {};
  if (int err = configure(attn_mma_kernel<DP, NW, MW, ST, XLA>, smem, done)) return err;
  const dim3 grid(ceil_div(a.L, BM), a.B * a.H);
  attn_mma_kernel<DP, NW, MW, ST, XLA><<<grid, NW * 32, smem, stream>>>(a, vec);
  return (int)cudaGetLastError();
}

template <int DP, int BM, bool XLA>
int launch_f32(const Args& a, int vec, cudaStream_t stream) {
  constexpr int BN = f32_bn(DP);
  constexpr size_t smem =
      sizeof(float) * ((DP + 4) * (BM + 4 * BN) + BN * (BM + 4));
  static_assert(smem <= 232448, "a block may use 227 KB of shared memory");
  static bool done[MAX_DEVICES] = {};
  if (int err = configure(attn_f32_kernel<DP, BM, XLA>, smem, done)) return err;
  const dim3 grid(ceil_div(a.L, BM), a.B * a.H);
  attn_f32_kernel<DP, BM, XLA><<<grid, 256, smem, stream>>>(a, vec);
  return (int)cudaGetLastError();
}

inline bool aligned16(const Args& a, int elem_bytes) {
  const long long e = 16 / elem_bytes;
  bool ok = a.D % e == 0;
  for (int i = 0; i < 3; ++i)
    ok = ok && a.qs[i] % e == 0 && a.ks[i] % e == 0 && a.vs[i] % e == 0 &&
         a.os[i] % e == 0;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.o);
  return ok && ptrs % 16 == 0;
}

// XLA_NUMERICS: q scaled and rounded in the input dtype and an item with
// kv_len == 0 gets the mean of V (smallattn.cu); else q scaled in fp32 and
// such an item gets 0 (flash.cu).
template <bool XLA>
int launch(const Args& a, bool bf16, cudaStream_t stream) {
  if (a.D < 1 || a.D > 128 || a.L < 1 || a.B < 1 || a.H < 1 ||
      (long long)a.B * a.H > 65535)
    return (int)cudaErrorInvalidValue;
  const int vec = aligned16(a, bf16 ? 2 : 4);
  if (bf16) {
    constexpr int NW = MMA_NW, MW = MMA_MW, ST = MMA_STAGES;
    if (a.D <= 16) return launch_mma<16, NW, MW, ST, XLA>(a, vec, stream);
    if (a.D <= 32) return launch_mma<32, NW, MW, ST, XLA>(a, vec, stream);
    if (a.D <= 64) return launch_mma<64, NW, MW, ST, XLA>(a, vec, stream);
    return launch_mma<128, NW, 1, 2, XLA>(a, vec, stream);
  }
  constexpr int BM = F32_BM;
  if (a.D <= 16) return launch_f32<16, BM, XLA>(a, vec, stream);
  if (a.D <= 32) return launch_f32<32, BM, XLA>(a, vec, stream);
  if (a.D <= 64) return launch_f32<64, BM, XLA>(a, vec, stream);
  return launch_f32<128, BM, XLA>(a, vec, stream);
}

inline Args make_args(const void* q, const void* k, const void* v,
                      const int* kv_len, void* o, int B, int H, int L, int D,
                      const long long* strides, float scale) {
  Args a;
  a.q = q, a.k = k, a.v = v, a.kv_len = kv_len, a.o = o;
  a.B = B, a.H = H, a.L = L, a.D = D, a.scale = scale;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i], a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i], a.os[i] = strides[9 + i];
  }
  return a;
}

}  // namespace attn
}  // namespace sylber
