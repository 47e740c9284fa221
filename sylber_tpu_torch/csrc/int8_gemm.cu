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
// sylber_quantize_rows: a warp takes a row at a time and holds it in
//   registers from its max |x| to its store, so every value is read once:
//   each lane keeps NC 16-byte pieces of the row (NC the least of 1, 2, 3,
//   4, 6, 8, 12, 16, 24 that covers K: up to 6,144 bf16 values or 3,072
//   float32). The grid gives a warp a row; the rows' registers let a few
//   blocks reside on an SM at once, and blocks start as others end, so the
//   resident warps are at different steps of their rows: one row's loads
//   overlap another's arithmetic and stores (a persistent grid, rows
//   dealt to warps in turn, was slower for bf16: its warps end unevenly;
//   loading the next row ahead cost the registers of a row, and occupancy,
//   and lost too; scripts/quantize_gateloop_probe.py). The scale is
//   max(amax, 1e-8) / 127 as an IEEE division, once a row, and its
//   reciprocal inv (__frcp_rn) too. A value's integer is that nearest the
//   exact product x * inv (one fused multiply-add, rounding half to even
//   as jnp.round: adding 1.5 * 2^23 leaves the integer in the low bits of
//   the sum, so no conversion instruction), which lies within 1.2e-5 of the
//   IEEE quotient fl(x / scale) as |x / scale| <= 127.00001; only where the
//   product lies within 2^-15 of a half-integer can the two round to
//   different integers, and a 16-byte piece with such a product is
//   quantized again by the IEEE quotients (__fdiv_rn), after the
//   branch-free pass over the whole row. bf16 values are widened by a
//   shift (cvt.f32.bf16 takes the conversion pipe), the int8 values packed
//   into words with byte permutes. The int8 output is bit-equal to JAX's.
//   Rows wider than the held form (or not in 16-byte pieces) take a path
//   that reads each row twice (max, then quantize) with the same
//   arithmetic. The row stride of the output is a multiple of 16 bytes and
//   the columns from K to the stride are written as zeros: the stride is
//   what TMA's global stride must be. Bound: bytes (the input read once, a
//   byte a value written).
// sylber_int8_gemm: out (M, N) = epilogue(A (M, K) . B (N, K)^T), both int8
//   and K-contiguous, the layout wgmma takes for 8-bit operands (both must be
//   K-major). Bound at the encoder's shapes: about even between the bytes
//   (operands and output) and the int8 tensor-core rate, which only wgmma
//   reaches. One kernel for every shape: blocks of 128 x 128 outputs; a
//   producer warp keeps a ring of 5 stages full with TMA 2-D tile loads
//   (cp.async.bulk.tensor, 128 x 128 bytes of A and of B a stage, the
//   128-byte swizzle, out-of-bounds elements filled with zeros past M, N and
//   the true K: int8 zeros add nothing), each stage's full and empty
//   mbarriers ordering it; two consumer warpgroups of 64 rows each run
//   wgmma.mma_async m64n128k32 s8 with both operands read from shared memory
//   through descriptors (K-major, 128-byte swizzle, the k32 steps 32 bytes
//   apart within a row), one k-tile in flight while the previous tile's
//   stage goes back to the producer. A persistent grid, a block an SM: the
//   ring runs across a block's tiles, so the next tile's loads overlap this
//   tile's epilogue. The int32 sums are exact in any order.
//   The epilogue maps the accumulator fragment (row 16 warp + lane / 4
//   (+ 8), column 8 i + 2 (lane % 4) (+ 1)) to the output and computes
//   float(acc) * sx[m] * sw[n] + b[n] in that order with rounded operations
//   (no fused multiply-add), so the output is bit-equal to the plain
//   version's; each warp stages its rows in shared memory and writes them
//   out in 16-byte pieces (stored straight from the fragment, two values a
//   lane, the epilogue took longer than the products at K 768). The
//   tensor maps are encoded on the host per call, the encoder looked up at
//   run time (cudaGetDriverEntryPointByVersion): nothing new is linked.
#include <cuda.h>

#include "common.cuh"

namespace sylber {
namespace i8 {

constexpr int Q_THREADS = 256;  // 8 warps, a row at a time each
constexpr int Q_MAX_PIECES = 24;    // 16-byte pieces of a row a lane holds at most
// A product x * (1 / scale) further than this from a half-integer rounds as
// fl(x / scale) does (they differ by at most 1.2e-5 for |x / scale| <= 128)
constexpr float TIE_TOL = 0x1p-15f;
constexpr float ROUNDER = 12582912.f;  // 1.5 * 2^23
constexpr float MIN_AMAX = 1e-8f;
constexpr float QMAX = 127.f;

constexpr int BM = 128, BN = 128, BK = 128;  // block tile; BK in bytes: one swizzled row
constexpr int STAGES = 5;
constexpr int CONSUMERS = 2;  // warpgroups of 64 rows
constexpr int CONSUMER_WARPS = 4 * CONSUMERS;
constexpr int G_THREADS = (CONSUMER_WARPS + 1) * 32;  // and the producer warp, the last
constexpr int TILE_A = BM * BK, TILE_B = BN * BK;
constexpr int STAGE_BYTES = TILE_A + TILE_B;
// a consumer warp's 16 rows x 64 columns of output on their way out, padded
// (a row's 16-byte chunks off the banks of the next row's)
constexpr int OUT_PITCH = 64 * 4 + 16;  // bytes a staged row (fp32; bf16 uses half)
constexpr int OUT_BYTES = CONSUMER_WARPS * 16 * OUT_PITCH;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + OUT_BYTES + 1024;  // + slack to align to 1024

// Shared-memory helpers of the GEMM: addresses, TMA and wgmma.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// A box of the tensor map at (c0 along K, c1 along rows) into shared memory,
// its bytes reported to `bar`; elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// d (64 x 128, s32) += a (64 x 32 bytes) . b (128 x 32 bytes)^T, s8, both
// K-major in shared memory as their descriptors name them.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
// The descriptor of a K-major operand that TMA wrote with the 128-byte
// swizzle: 128-byte rows, 8-row groups 1024 bytes apart (stride byte offset),
// the leading byte offset unused by this layout (1), layout type 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// Keeps the compiler from moving accesses of the accumulators across a wait.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// V values of T (16 bytes, or one value) to float.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};
// V int8 values packed into 32-bit words (V = 4 or 8), or one in the low byte.
template <int V>
struct Packed {
  uint32_t w[(V + 3) / 4];
};

// A value as float; bf16 widened by a shift (exact: cvt.f32.bf16 would take
// the conversion pipe, a few lanes a clock).
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __uint_as_float((uint32_t)__bfloat16_as_ushort(x) << 16);
}

// The integer nearest x * inv (the exact product; half to even) in the low
// byte of the result, as int8, and in `gap` the distance of the product from
// it: only a gap near 1/2 (a product near a half-integer) can round
// otherwise than the IEEE quotient. |x * inv| < 127.5, so no clip is needed.
// Adding 1.5 * 2^23 leaves the integer in the low bits of the sum (its low
// byte that of the integer's two's complement): no conversion instruction.
__device__ __forceinline__ uint32_t round_product(float x, float inv, float& gap) {
  const float t = fmaf(x, inv, ROUNDER);
  gap = fmaxf(gap, fabsf(fmaf(x, inv, -__fsub_rn(t, ROUNDER))));
  return __float_as_uint(t);
}

// The same for the IEEE quotient q = fl(x / scale).
__device__ __forceinline__ uint32_t round_quotient(float q) {
  return __float_as_uint(__fadd_rn(q, ROUNDER));
}

// The low bytes of q[0..V) into out's words.
template <int V>
__device__ __forceinline__ void pack(const uint32_t (&q)[V], Packed<V>& out) {
  if constexpr (V == 1) {
    out.w[0] = q[0];
  } else {
#pragma unroll
    for (int g = 0; g < V / 4; ++g)
      out.w[g] = __byte_perm(__byte_perm(q[4 * g], q[4 * g + 1], 0x0040),
                             __byte_perm(q[4 * g + 2], q[4 * g + 3], 0x0040), 0x5410);
  }
}

template <int V>
__device__ __forceinline__ void store_piece(int8_t* dst, const Packed<V>& p) {
  if constexpr (V == 8)
    *reinterpret_cast<uint2*>(dst) = make_uint2(p.w[0], p.w[1]);
  else if constexpr (V == 4)
    *reinterpret_cast<uint32_t*>(dst) = p.w[0];
  else
    *dst = (int8_t)p.w[0];
}

// A 16-byte piece (or one value) to int8 by the products with inv = 1 /
// scale, branch-free; true if one of them lies near a half-integer.
template <typename T, int V>
__device__ __forceinline__ bool quantize_piece(const Vec<T, V>& v, float inv, Packed<V>& out) {
  float gap = 0.f;
  uint32_t q[V];
#pragma unroll
  for (int e = 0; e < V; ++e) q[e] = round_product(widen(v.v[e]), inv, gap);
  pack(q, out);
  return gap > 0.5f - TIE_TOL;
}

// The same piece by the IEEE quotients x / scale (a piece that
// quantize_piece found near a half-integer).
template <typename T, int V>
__device__ __forceinline__ void quantize_piece_exact(const Vec<T, V>& v, float scale,
                                                     Packed<V>& out) {
  uint32_t q[V];
#pragma unroll
  for (int e = 0; e < V; ++e) q[e] = round_quotient(__fdiv_rn(widen(v.v[e]), scale));
  pack(q, out);
}

// The row's scale (an IEEE division) and its reciprocal, from its max |x|.
__device__ __forceinline__ float2 row_scale(float amax) {
  const float s = __fdiv_rn(fmaxf(amax, MIN_AMAX), QMAX);
  return make_float2(s, __frcp_rn(s));
}

// The zero columns from K to the row stride.
__device__ __forceinline__ void zero_tail(int8_t* qr, int K, int ldq, int lane) {
  for (int c = K + lane; c < ldq; c += 32) qr[c] = 0;
}

// A row held in registers: lane l keeps the 16-byte pieces i = 0 .. NC - 1
// at columns (32 i + l) V, those past K unused. Warp w takes rows w, w + W,
// ... (W warps in the grid; the launch gives a warp a row).
template <typename T, int NC>
__global__ void __launch_bounds__(Q_THREADS)
    quantize_rows_held(const T* __restrict__ x, long long ldx, int8_t* __restrict__ q, int ldq,
                       float* __restrict__ scale, int R, int K) {
  constexpr int V = 16 / (int)sizeof(T);
  const int lane = threadIdx.x % 32;
  const int W = gridDim.x * (Q_THREADS / 32);
  for (int r = blockIdx.x * (Q_THREADS / 32) + threadIdx.x / 32; r < R; r += W) {
    const T* xr = x + (long long)r * ldx;
    Vec<T, V> row[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = (i * 32 + lane) * V;
      if (c < K) row[i] = *reinterpret_cast<const Vec<T, V>*>(xr + c);
    }
    float m[NC];  // max |x| a piece, then over the pieces: short chains
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      m[i] = 0.f;
      if ((i * 32 + lane) * V < K)
#pragma unroll
        for (int e = 0; e < V; ++e) m[i] = fmaxf(m[i], fabsf(widen(row[i].v[e])));
    }
#pragma unroll
    for (int i = 1; i < NC; ++i) m[0] = fmaxf(m[0], m[i]);
    const float2 s = row_scale(warp_max(m[0]));
    if (lane == 0) scale[r] = s.x;
    Packed<V> out[NC];
    unsigned near = 0;  // a bit a piece with a product near a half-integer
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if ((i * 32 + lane) * V < K) near |= (unsigned)quantize_piece(row[i], s.y, out[i]) << i;
    }
    if (near) {  // rare: those pieces again by the IEEE quotients
#pragma unroll
      for (int i = 0; i < NC; ++i)
        if (near >> i & 1) quantize_piece_exact(row[i], s.x, out[i]);
    }
    int8_t* qr = q + (long long)r * ldq;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = (i * 32 + lane) * V;
      if (c < K) store_piece(qr + c, out[i]);
    }
    zero_tail(qr, K, ldq, lane);
  }
}

// Any width, and V values a load (16 bytes, or one value): a warp a row,
// read twice (max |x|, then the quantization).
template <typename T, int V>
__global__ void __launch_bounds__(Q_THREADS)
    quantize_rows_wide(const T* __restrict__ x, long long ldx, int8_t* __restrict__ q, int ldq,
                       float* __restrict__ scale, int R, int K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * (Q_THREADS / 32) + warp;
  if (r >= R) return;
  const T* xr = x + (long long)r * ldx;
  int8_t* qr = q + (long long)r * ldq;
  float amax = 0.f;
  for (int c = lane * V; c < K; c += 32 * V) {
    const Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(xr + c);
#pragma unroll
    for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(widen(v.v[i])));
  }
  const float2 s = row_scale(warp_max(amax));
  if (lane == 0) scale[r] = s.x;
  for (int c = lane * V; c < K; c += 32 * V) {
    const Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(xr + c);
    Packed<V> out;
    if (quantize_piece(v, s.y, out)) quantize_piece_exact(v, s.x, out);
    store_piece(qr + c, out);
  }
  zero_tail(qr, K, ldq, lane);
}

// A persistent grid: block b takes the output tiles b, b + gridDim.x, ...
// (N tiles fastest, so the blocks at work share A's rows and all of B in L2).
// The ring runs across tiles: while the consumers write a tile out, the
// producer already fills the stages with the next tile's k-tiles.
template <typename T>
__global__ void __launch_bounds__(G_THREADS, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                     const float* __restrict__ sx, const float* __restrict__ sw,
                     const float* __restrict__ bias, T* __restrict__ out, long long ldo, int M,
                     int N, int K, bool vec) {
  extern __shared__ __align__(1024) int8_t gemm_smem[];
  __shared__ __align__(8) uint64_t full[STAGES];   // a stage's tiles have landed
  __shared__ __align__(8) uint64_t empty[STAGES];  // the consumers are done with a stage
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ktiles = (K + BK - 1) / BK;
  const int tiles_n = (N + BN - 1) / BN, tiles = tiles_n * ((M + BM - 1) / BM);
  int8_t* ring = gemm_smem + ((1024 - (smem_addr(gemm_smem) & 1023)) & 1023);
  auto tile_a = [&](int s) { return ring + s * STAGE_BYTES; };
  auto tile_b = [&](int s) { return ring + s * STAGE_BYTES + TILE_A; };
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {  // the producer: one thread keeps the ring full
    if (lane == 0) {
      int it = 0;  // k-tiles asked for, over all of this block's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          mbar_expect_tx(&full[s], STAGE_BYTES);
          tma_load_2d(tile_a(s), &ta, kt * BK, m0, &full[s]);
          tma_load_2d(tile_b(s), &tb, kt * BK, n0, &full[s]);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 wg .. + 64 of each tile, all its columns
  const int wg = warp / 4;
  const int g = lane >> 2, t = lane & 3;
  int acc[64];
  int it = 0;  // k-tiles taken, over all of this block's tiles
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
    // the epilogue's scales and biases, asked for before the products: the
    // lane's rows mr, mr + 8 and columns 8 i + 2 (lane % 4) (+ 1)
    const int mr = m0 + wg * 64 + (warp % 4) * 16 + g;
    const float s0 = mr < M ? sx[mr] : 0.f, s1 = mr + 8 < M ? sx[mr + 8] : 0.f;
    float w[BN / 8][2], bv[BN / 8][2];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = n0 + i * 8 + 2 * t + c;
        w[i][c] = n < N ? sw[n] : 0.f;
        bv[i][c] = bias && n < N ? bias[n] : 0.f;
      }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const uint32_t a0 = smem_addr(tile_a(s) + wg * 64 * BK), b0 = smem_addr(tile_b(s));
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 32; ++k)
        wgmma_s8(acc, smem_desc(a0 + 32 * k), smem_desc(b0 + 32 * k));
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-tile's products are done: give its stage back
      fence_acc(acc);
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);  // the tile's last k-tile

    // epilogue, 64 columns at a time: register 4 i + 2 h + c holds row 16
    // (warp % 4) + lane / 4 + 8 h, column 8 i + 2 (lane % 4) + c of the
    // warpgroup's 64 x 128; the warp stages its 16 rows in shared memory and
    // writes them out as 16-byte pieces of rows
    T* staged = reinterpret_cast<T*>(ring + STAGES * STAGE_BYTES + warp * 16 * OUT_PITCH);
    constexpr int PITCH = OUT_PITCH / (int)sizeof(T);  // values a staged row
    constexpr int VALUES = 16 / (int)sizeof(T), PIECES = 64 / VALUES;  // a row's 16-byte pieces
    const int row0 = m0 + wg * 64 + (warp % 4) * 16;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int i = 8 * half; i < 8 * half + 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float sm = h ? s1 : s0;
          float y0 = __fmul_rn(__fmul_rn((float)acc[4 * i + 2 * h], sm), w[i][0]);
          float y1 = __fmul_rn(__fmul_rn((float)acc[4 * i + 2 * h + 1], sm), w[i][1]);
          if (bias) {
            y0 = __fadd_rn(y0, bv[i][0]);
            y1 = __fadd_rn(y1, bv[i][1]);
          }
          T* p = staged + (g + 8 * h) * PITCH + (i - 8 * half) * 8 + 2 * t;
          p[0] = from_float<T>(y0);
          p[1] = from_float<T>(y1);
        }
      __syncwarp();
#pragma unroll
      for (int q = lane; q < 16 * PIECES; q += 32) {
        const int r = q / PIECES, c = (q % PIECES) * VALUES;
        const int m = row0 + r, n = n0 + 64 * half + c;
        if (m >= M || n >= N) continue;
        const T* src = staged + r * PITCH + c;
        T* dst = out + m * ldo + n;
        if (vec && n + VALUES <= N) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < VALUES && n + e < N; ++e) dst[e] = src[e];
        }
      }
      __syncwarp();  // the next half is staged where this one was read
    }
  }
}

template <typename T, int NC>
int held_launch(const void* x, long long ldx, void* q, int ldq, void* scale, int R, int K,
                cudaStream_t stream) {
  const int grid = ceil_div(R, Q_THREADS / 32);  // a warp a row
  quantize_rows_held<T, NC><<<grid, Q_THREADS, 0, stream>>>((const T*)x, ldx, (int8_t*)q, ldq,
                                                            (float*)scale, R, K);
  return (int)cudaGetLastError();
}

template <typename T>
int quantize_launch(const void* x, long long ldx, void* q, int ldq, void* scale, int R, int K,
                    bool vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int pieces = ceil_div(K, 32 * V);
  if (vec && pieces <= Q_MAX_PIECES) {
    if (pieces <= 1) return held_launch<T, 1>(x, ldx, q, ldq, scale, R, K, stream);
    if (pieces <= 2) return held_launch<T, 2>(x, ldx, q, ldq, scale, R, K, stream);
    if (pieces <= 3) return held_launch<T, 3>(x, ldx, q, ldq, scale, R, K, stream);
    if (pieces <= 4) return held_launch<T, 4>(x, ldx, q, ldq, scale, R, K, stream);
    if (pieces <= 6) return held_launch<T, 6>(x, ldx, q, ldq, scale, R, K, stream);
    if (pieces <= 8) return held_launch<T, 8>(x, ldx, q, ldq, scale, R, K, stream);
    if (pieces <= 12) return held_launch<T, 12>(x, ldx, q, ldq, scale, R, K, stream);
    if (pieces <= 16) return held_launch<T, 16>(x, ldx, q, ldq, scale, R, K, stream);
    return held_launch<T, 24>(x, ldx, q, ldq, scale, R, K, stream);
  }
  const dim3 grid(ceil_div(R, Q_THREADS / 32));
  if (vec)
    quantize_rows_wide<T, V><<<grid, Q_THREADS, 0, stream>>>(
        (const T*)x, ldx, (int8_t*)q, ldq, (float*)scale, R, K);
  else
    quantize_rows_wide<T, 1><<<grid, Q_THREADS, 0, stream>>>(
        (const T*)x, ldx, (int8_t*)q, ldq, (float*)scale, R, K);
  return (int)cudaGetLastError();
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    return (EncodeTiled)p;
  }();
  return fn;
}

// The tensor map of an (R, K) int8 operand with a row stride of ld bytes, in
// boxes of `rows` rows by BK bytes with the 128-byte swizzle; the logical K
// is the true K, so TMA fills the columns past it with zeros.
bool tensor_map(CUtensorMap* map, const void* base, int R, int K, int ld, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)R};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int gemm_launch(const void* a, int lda, const void* b, int ldb, const void* sx, const void* sw,
                const void* bias, void* out, long long ldo, int M, int N, int K,
                cudaStream_t stream) {
  CUtensorMap ta, tb;
  if (!tensor_map(&ta, a, M, K, lda, BM) || !tensor_map(&tb, b, N, K, ldb, BN))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return (int)cudaGetLastError();
  // whole 16-byte pieces of output rows where every row starts 16-byte aligned
  const bool vec = (ldo * (long long)sizeof(T)) % 16 == 0 && (uintptr_t)out % 16 == 0;
  const int grid = min(ceil_div(N, BN) * ceil_div(M, BM), sms);  // a block an SM
  int8_gemm_kernel<T><<<grid, G_THREADS, SMEM_BYTES, stream>>>(
      ta, tb, (const float*)sx, (const float*)sw, (const float*)bias, (T*)out, ldo, M, N, K, vec);
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
// Returns cudaErrorInvalidValue if a tensor map cannot be encoded.
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
