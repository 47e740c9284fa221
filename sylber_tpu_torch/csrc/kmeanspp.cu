// k-means++ seeding on the card: k centers drawn from the rows of x (n, d).
//
// Replaces sylber_tpu/flow/kmeans.py::_kmeanspp_init (an XLA lax.fori_loop
// of k - 1 steps, each a categorical draw over log(max(d2, 1e-30)) and a
// distance update). It is not a copy of that loop: the draws are by the
// inverse CDF.
//   center 0:   row floor(u[0] * n);
//   center j:   the first row i whose float64 prefix sum of
//               w = max(d2, 1e-30) exceeds u[j] * (the sum of all w), so a
//               row is taken with probability w_i / sum w, the law of JAX's
//               categorical(log(max(d2, 1e-30)));
//   after each: d2 = min(d2, sum_d (x - c)^2), a sum of squared differences
//               as JAX writes it (|x|^2 + |c|^2 - 2 x.c cancels near 0 and
//               can go negative).
// The uniforms u (k float64, from a torch.Generator) are on the card before
// the first launch; nothing is read back between steps.
//
// Bound on the H100: bytes. A step reads all of x once (the draw depends on
// the previous step's distances, so x cannot stay on chip unless it fits the
// 50 MB L2): at the production seed pool (n 65,536, d 768, 201 MB) 60 us a
// step at 3.35 TB/s. The arithmetic is 3 n d operations a step, 2.3 us.
//
// Design: two launches a step, enqueued by sylber_kmeanspp without a read.
//   kmeanspp_update: blocks of 8 warps over contiguous chunks of rows; the
//     newest center (its index read from `chosen` on the card) in shared
//     memory, a warp per row, float4 loads where d % 4 == 0; each block
//     writes d2 for its rows and the float64 sum of their weights.
//   kmeanspp_draw: one block. An inclusive scan of the block sums (shared
//     memory, float64), the target u[j] * total, the first chunk whose
//     prefix exceeds it, then a scan of that chunk's row weights from the
//     chunk's base to the first row whose prefix exceeds it (atomicMin over
//     the candidates, so the scan's rounding cannot pick two); the row is
//     copied into centers[j] and its index into chosen[j]. The plain
//     version sums in another order (torch.cumsum): the two can pick
//     neighbouring rows only where u[j] * total lies within float64
//     rounding of a prefix.
// The alternative, one persistent cooperative kernel with a grid barrier
// between the update and the draw, saves a launch a step (about 3 us
// against the 60 us of reading x); it is left for a later change, because a
// grid barrier that waits for a block that never runs hangs the card, and a
// pair of plain launches cannot.
#include "common.cuh"

namespace sylber {
namespace kmpp {

constexpr int UPDATE_THREADS = 256;  // 8 warps, a row per warp at a time
constexpr int DRAW_THREADS = 256;
constexpr int MAX_BLOCKS = 1024;     // block sums the draw keeps in shared memory
constexpr int MIN_ROWS_PER_BLOCK = 64;
constexpr int MAX_DIM = 4096;        // the center in shared memory
constexpr float MIN_WEIGHT = 1e-30f;
constexpr int NONE = 0x7fffffff;  // no row found yet

__device__ __forceinline__ double weight(float d2) {
  return (double)fmaxf(d2, MIN_WEIGHT);
}

__global__ void __launch_bounds__(UPDATE_THREADS)
    kmeanspp_update(const float* __restrict__ x, const int* __restrict__ chosen, int j,
                    float* __restrict__ d2, double* __restrict__ block_sums, int n, int d,
                    int rows_per_block, int first) {
  __shared__ __align__(16) float c[MAX_DIM];
  __shared__ double warp_sums[UPDATE_THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* center = x + (size_t)chosen[j] * d;
  for (int t = threadIdx.x; t < d; t += UPDATE_THREADS) c[t] = center[t];
  __syncthreads();

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  const bool vec = d % 4 == 0;
  double wsum = 0.0;
  for (int r = r0 + warp; r < r1; r += UPDATE_THREADS / 32) {
    const float* row = x + (size_t)r * d;
    float acc = 0.f;
    if (vec) {
      const float4* xr = reinterpret_cast<const float4*>(row);
      const float4* cv = reinterpret_cast<const float4*>(c);
      for (int t = lane; t < d / 4; t += 32) {
        const float4 a = xr[t], b = cv[t];
        const float e0 = a.x - b.x, e1 = a.y - b.y, e2 = a.z - b.z, e3 = a.w - b.w;
        acc += e0 * e0 + e1 * e1 + e2 * e2 + e3 * e3;
      }
    } else {
      for (int t = lane; t < d; t += 32) {
        const float e = row[t] - c[t];
        acc += e * e;
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const float nd = first ? acc : fminf(d2[r], acc);
      d2[r] = nd;
      wsum += weight(nd);
    }
  }
  if (lane == 0) warp_sums[warp] = wsum;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < UPDATE_THREADS / 32; ++w) s += warp_sums[w];
    block_sums[blockIdx.x] = s;
  }
}

// Inclusive scan of DRAW_THREADS doubles in shared memory (one per thread).
__device__ __forceinline__ void block_scan(double* s) {
  for (int off = 1; off < DRAW_THREADS; off <<= 1) {
    const double v = threadIdx.x >= off ? s[threadIdx.x - off] : 0.0;
    __syncthreads();
    s[threadIdx.x] += v;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(DRAW_THREADS)
    kmeanspp_draw(const float* __restrict__ x, const float* __restrict__ d2,
                  const double* __restrict__ block_sums, const double* __restrict__ u,
                  int* __restrict__ chosen, float* __restrict__ centers, int n, int d,
                  int nblocks, int rows_per_block, int j) {
  __shared__ double prefix[MAX_BLOCKS];
  __shared__ double tile[DRAW_THREADS];
  __shared__ int found;
  const int t = threadIdx.x;
  if (j == 0) {
    if (t == 0) found = min((int)floor(u[0] * (double)n), n - 1);
  } else {
    // the blocks' prefix sums, a tile of DRAW_THREADS at a time
    double carry = 0.0;
    for (int b0 = 0; b0 < nblocks; b0 += DRAW_THREADS) {
      tile[t] = b0 + t < nblocks ? block_sums[b0 + t] : 0.0;
      __syncthreads();
      block_scan(tile);
      if (b0 + t < nblocks) prefix[b0 + t] = carry + tile[t];
      carry += tile[DRAW_THREADS - 1];
      __syncthreads();
    }
    const double target = u[j] * prefix[nblocks - 1];
    if (t == 0) found = NONE;
    __syncthreads();
    // the first chunk whose prefix exceeds the target (the last if rounding
    // leaves the target at the total)
    for (int b = t; b < nblocks; b += DRAW_THREADS)
      if (prefix[b] > target) atomicMin(&found, b);
    __syncthreads();
    const int blk = found == NONE ? nblocks - 1 : found;
    const int r0 = blk * rows_per_block, r1 = min(n, r0 + rows_per_block);
    double base = blk > 0 ? prefix[blk - 1] : 0.0;
    __syncthreads();
    if (t == 0) found = NONE;
    __syncthreads();
    // then the first row of that chunk whose prefix exceeds it
    for (int q0 = r0; q0 < r1; q0 += DRAW_THREADS) {
      const int r = q0 + t;
      tile[t] = r < r1 ? weight(d2[r]) : 0.0;
      __syncthreads();
      block_scan(tile);
      if (r < r1 && base + tile[t] > target) atomicMin(&found, r);
      base += tile[DRAW_THREADS - 1];
      __syncthreads();
      if (found != NONE) break;
    }
    if (t == 0 && found == NONE) found = r1 - 1;  // a float64 tie at the chunk's end
  }
  __syncthreads();
  const int idx = found;
  for (int e = t; e < d; e += DRAW_THREADS) centers[(size_t)j * d + e] = x[(size_t)idx * d + e];
  if (t == 0) chosen[j] = idx;
}

}  // namespace kmpp
}  // namespace sylber

using namespace sylber::kmpp;

// The update kernel's grid for n rows: (blocks, rows a block).
static void kmeanspp_grid(int n, int* blocks, int* rows) {
  int b = min(MAX_BLOCKS, max(1, (n + MIN_ROWS_PER_BLOCK - 1) / MIN_ROWS_PER_BLOCK));
  const int r = (n + b - 1) / b;
  *blocks = (n + r - 1) / r;
  *rows = r;
}

// The number of block sums the caller allocates for n rows.
extern "C" int sylber_kmeanspp_blocks(int n) {
  int blocks, rows;
  kmeanspp_grid(n, &blocks, &rows);
  return blocks;
}

// k centers of x (n, d) fp32 into centers (k, d) and their rows into chosen
// (k,) int32, from the uniforms u (k,) float64. d2 (n,) fp32 and block_sums
// (sylber_kmeanspp_blocks(n),) float64 are scratch. 2k - 1 launches on
// `stream`, none waiting for the host.
extern "C" int sylber_kmeanspp(const float* x, const double* u, float* d2, double* block_sums,
                               int* chosen, float* centers, int n, int d, int k,
                               cudaStream_t stream) {
  if (n < 1 || d < 1 || d > MAX_DIM || k < 1) return (int)cudaErrorInvalidValue;
  int blocks, rows;
  kmeanspp_grid(n, &blocks, &rows);
  kmeanspp_draw<<<1, DRAW_THREADS, 0, stream>>>(x, d2, block_sums, u, chosen, centers, n, d,
                                                 blocks, rows, 0);
  cudaError_t err = cudaGetLastError();
  for (int j = 1; j < k && err == cudaSuccess; ++j) {
    kmeanspp_update<<<blocks, UPDATE_THREADS, 0, stream>>>(x, chosen, j - 1, d2, block_sums, n,
                                                           d, rows, j == 1);
    kmeanspp_draw<<<1, DRAW_THREADS, 0, stream>>>(x, d2, block_sums, u, chosen, centers, n, d,
                                                   blocks, rows, j);
    err = cudaGetLastError();
  }
  return (int)err;
}
