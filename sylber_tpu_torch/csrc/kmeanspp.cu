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
//               in fp32 as JAX writes it (|x|^2 + |c|^2 - 2 x.c cancels near
//               0 and can go negative).
// The uniforms u (k float64, from a torch.Generator) are on the card before
// the launch; nothing is read back by the host.
//
// Design: one persistent cooperative launch a seeding
// (cudaLaunchCooperativeKernel, which refuses a grid that cannot be resident
// all at once, so no block waits for a block that never runs).
//   - The grid is the occupancy times the SMs, capped so that a block has at
//     least `min_rows` rows (64: a small pool takes a small grid, whose
//     exchanges are quicker); a block has up to 1,024 threads (more loads in
//     flight), a group of `lanes` lanes a row (8 from d 32, so that a group
//     reads 128 contiguous bytes; 16 from d 256, a warp from d 512). Block b
//     owns the contiguous slice of `rows` rows from b * rows for all k
//     steps. The partition depends on (n, d, the grid, the capacity) alone,
//     so two calls on one card give the same rows bit for bit.
//   - The slice's first `resident` rows sit in dynamic shared memory (rows
//     padded to a multiple of 4 floats with zeros, so always float4 loads),
//     loaded once; the rest stream from device memory every step (L2 hits
//     where the spill fits the 50 MB L2). The slice's d2 stays in shared
//     memory.
//   - A step: the update (the newest center in shared memory, or, where it
//     does not fit, read from exchange 2's words: see the widths below) and
//     the slice's float64 weight sum; exchange 1, every block's sum to every
//     block; every block makes the same fixed-order prefix of the G sums in
//     one warp and finds the owning block of u[j] * total; the owner scans
//     its slice's weights in shared memory to the first row whose prefix
//     exceeds the target and writes the row's index and copy into chosen[j]
//     and centers[j]; exchange 2, the owner's copy of the center to every
//     block.
//   - Both exchanges are 8-byte words that carry a 32-bit value and the step
//     that wrote it (common.cuh's flag words): a reader spins on the word
//     until it holds the step it wants, so the value and its arrival travel
//     together, with no fence, no atomic and no second read. The words are
//     kept by step parity: a block reaches step j + 2's writes only after
//     every block has written step j + 1's sum, which each does after it
//     has read all of step j's words.
//   - The draw sums in another order than the plain version (torch.cumsum):
//     the two can pick neighbouring rows only where u[j] * total lies within
//     float64 rounding of a prefix. Where the rounding leaves the target at
//     or past a prefix's end, the last block, or the owner's last row, is
//     taken, as searchsorted's clamp does.
//   - Widths: a block's fixed part of shared memory is its scratch, the
//     words of exchange 1, the slice's prefix and d2 and, where it fits
//     beside them, the newest center (4 d bytes: up to about 57,000 floats
//     in 227 KB). Past that the update reads center j - 1 from exchange 2's
//     flag words, each with flag_load, through L2 (the copy in `centers` is
//     written after the flag words with no fence between, so a reader may
//     not see it yet); center 0 from its row of x. No row of such a width is
//     resident either (a row takes as much as the center).
// Limits: d up to MAX_WIDTH (2^29: the scratch counts its words in int),
// and as many rows as a block's prefix and d2 (12 bytes a row) hold in
// shared memory on a grid of one block an SM: about 2.5 million rows on the
// H100 (flow/kmeans.py::seeding_refusal says so before a launch).
// Bounds on the H100 (chip_smoke.py::kmeanspp_bounds): bytes, the part of x
// that does not fit the grid's shared memory read once a step at 3.35 TB/s
// (x once where all of it fits: 132 x 227 KB, about 29 MB); and the chain,
// (k - 1) steps of two exchanges, each at least the round trip of one
// exchange of every block's word (sylber_kmeanspp_barrier_probe).
#include "common.cuh"

namespace sylber {
namespace kmpp {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_WIDTH = 1 << 29;
constexpr float MIN_WEIGHT = 1e-30f;
constexpr int NONE = 0x7fffffff;  // no row found yet

__device__ __forceinline__ double weight(float d2) {
  return (double)fmaxf(d2, MIN_WEIGHT);
}

// Floats between two rows in shared memory: d rounded up to a multiple of 4.
__host__ __device__ __forceinline__ int row_stride(int d) { return (d + 3) / 4 * 4; }

// The dynamic shared memory of a block: the block's scratch (two sets of
// warp partials, the step's target, base, row and owner), the words of
// exchange 1, the slice's prefix of weights, the center (where
// `shared_center`), the slice's d2, then the resident rows. Byte offsets,
// each a multiple of 16.
struct Layout {
  int words, prefix, center, d2, rows, bytes;
  __host__ __device__ Layout(int d, int grid, int rows_per_block, int resident,
                             bool shared_center) {
    words = 16 * MAX_WARPS + 32;
    prefix = words + 4 * row_stride(2 * grid);
    center = prefix + 8 * row_stride(rows_per_block);
    d2 = center + (shared_center ? 4 * row_stride(d) : 0);
    rows = d2 + 4 * row_stride(rows_per_block);
    bytes = rows + 4 * row_stride(d) * resident;
  }
};

// The scratch the caller zeroes, in flag words (step 0 is never waited for):
// by step parity, each block's weight sum (two words: the double's high and
// low halves), then the center (stride words).
__host__ __device__ __forceinline__ int parity_words(int grid, int d) {
  return 2 * grid + row_stride(d);
}

// Exchange 1, read: every block's words of step j into shared memory, a
// word a thread, so that the block waits one round trip for all of them.
__device__ __forceinline__ void gather_sums(const unsigned long long* sums, int grid, unsigned j,
                                            unsigned* words) {
  for (int w = threadIdx.x; w < 2 * grid; w += blockDim.x) words[w] = flag_load(sums + w, j);
  __syncthreads();
}
// The double that block q wrote as its sum, from the gathered words.
__device__ __forceinline__ double gathered_sum(const unsigned* words, int q) {
  const unsigned long long bits = (unsigned long long)words[2 * q] << 32 | words[2 * q + 1];
  return __longlong_as_double((long long)bits);
}
__device__ __forceinline__ void store_sum(unsigned long long* sums, int q, unsigned j, double v) {
  const unsigned long long bits = (unsigned long long)__double_as_longlong(v);
  flag_store(sums + 2 * q, (unsigned)(bits >> 32), j);
  flag_store(sums + 2 * q + 1, (unsigned)bits, j);
}

// The inclusive prefix of v over a warp's lanes, in a fixed order.
__device__ __forceinline__ double warp_prefix(double v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double p = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += p;
  }
  return v;
}

// The squared distance of one row to the center, summed by a group of
// `lanes` lanes (a power of two up to 32, aligned in the warp); every lane of
// the warp calls it (the group's shuffles), `live` false past the slice.
__device__ __forceinline__ float row_distance(const float* row, bool in_shared, const float* c,
                                              int d, int lanes, int glane, bool live) {
  float acc = 0.f;
  if (live) {
    if (in_shared || d % 4 == 0) {
      const float4* xr = reinterpret_cast<const float4*>(row);
      const float4* cv = reinterpret_cast<const float4*>(c);
      const int d4 = (d + 3) / 4;
      for (int q = glane; q < d4; q += lanes) {
        const float4 a = in_shared ? xr[q] : __ldg(xr + q), b = cv[q];
        const float e0 = a.x - b.x, e1 = a.y - b.y, e2 = a.z - b.z, e3 = a.w - b.w;
        acc += e0 * e0 + e1 * e1 + e2 * e2 + e3 * e3;
      }
    } else {
      for (int e = glane; e < d; e += lanes) {
        const float v = __ldg(row + e) - c[e];
        acc += v * v;
      }
    }
  }
  for (int o = lanes / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

// row_distance with the center read from exchange 2's flag words of `step`
// (`cw`, a word a float), for a row in device memory: the same sums in the
// same order.
__device__ __forceinline__ float row_distance_words(const float* row,
                                                    const unsigned long long* cw, unsigned step,
                                                    int d, int lanes, int glane, bool live) {
  float acc = 0.f;
  if (live) {
    if (d % 4 == 0) {
      const float4* xr = reinterpret_cast<const float4*>(row);
      for (int q = glane; q < d / 4; q += lanes) {
        const float4 a = __ldg(xr + q);
        const unsigned long long* w = cw + 4 * q;
        const float e0 = a.x - __uint_as_float(flag_load(w, step)),
                    e1 = a.y - __uint_as_float(flag_load(w + 1, step)),
                    e2 = a.z - __uint_as_float(flag_load(w + 2, step)),
                    e3 = a.w - __uint_as_float(flag_load(w + 3, step));
        acc += e0 * e0 + e1 * e1 + e2 * e2 + e3 * e3;
      }
    } else {
      for (int e = glane; e < d; e += lanes) {
        const float v = __ldg(row + e) - __uint_as_float(flag_load(cw + e, step));
        acc += v * v;
      }
    }
  }
  for (int o = lanes / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
    kmeanspp_seed(const float* __restrict__ x, const double* __restrict__ u,
                  unsigned long long* scratch, int* chosen, float* centers, int n, int d, int k,
                  int rows, int resident, int lanes, int shared_center) {
  extern __shared__ __align__(16) unsigned char seed_smem[];
  const Layout lay(d, gridDim.x, rows, resident, shared_center);
  double* part = reinterpret_cast<double*>(seed_smem);  // MAX_WARPS warp partials
  double* scan = part + MAX_WARPS;                      // and again, for the prefix
  double* info = scan + MAX_WARPS;                      // target, base
  int* found = reinterpret_cast<int*>(info + 2);        // row, owner
  unsigned* words = reinterpret_cast<unsigned*>(seed_smem + lay.words);
  double* prefix = reinterpret_cast<double*>(seed_smem + lay.prefix);
  float* c = reinterpret_cast<float*>(seed_smem + lay.center);  // where shared_center
  float* d2 = reinterpret_cast<float*>(seed_smem + lay.d2);
  float* xs = reinterpret_cast<float*>(seed_smem + lay.rows);
  const int threads = blockDim.x, warps = threads / 32;
  const int b = blockIdx.x, G = gridDim.x, t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int stride = row_stride(d);
  const int r0 = b * rows, nr = min(n, r0 + rows) - r0, nres = min(resident, nr);

  for (int i = t; i < nres * stride; i += threads) {
    const int r = i / stride, e = i % stride;
    xs[i] = e < d ? x[(size_t)(r0 + r) * d + e] : 0.f;
  }
  const int first = min((int)floor(u[0] * (double)n), n - 1);
  if (shared_center)
    for (int e = t; e < stride; e += threads) c[e] = e < d ? x[(size_t)first * d + e] : 0.f;
  if (b == 0) {
    for (int e = t; e < d; e += threads) centers[e] = x[(size_t)first * d + e];
    if (t == 0) chosen[0] = first;
  }
  __syncthreads();

  const int glane = t % lanes, group = t / lanes, groups = threads / lanes;
  // a thread's rows of the slice's prefix: [lo, hi)
  const int per = (nr + threads - 1) / threads, lo = min(nr, t * per), hi = min(nr, lo + per);
  for (int j = 1; j < k; ++j) {
    unsigned long long* sums = scratch + (j & 1) * parity_words(G, d);
    unsigned long long* center = sums + 2 * G;
    // the update: d2 of the slice against center j - 1, the slice's weight;
    // without a shared center, center 0 from x and center j - 1 from the
    // words exchange 2 wrote at step j - 1 (the other parity's, not written
    // again before every block has sent step j + 1's sum)
    const float* cx = shared_center ? c : x + (size_t)first * d;
    const unsigned long long* prev =
        shared_center || j == 1 ? nullptr : scratch + ((j - 1) & 1) * parity_words(G, d) + 2 * G;
    double wsum = 0.0;
    for (int i0 = 0; i0 < nr; i0 += groups) {
      const int i = i0 + group;
      const bool live = i < nr, in_shared = i < nres;
      const float* row = in_shared ? xs + (size_t)i * stride : x + (size_t)(r0 + i) * d;
      const float acc = prev ? row_distance_words(row, prev, j - 1, d, lanes, glane, live)
                             : row_distance(row, in_shared, cx, d, lanes, glane, live);
      if (live && glane == 0) {
        const float nd = j == 1 ? acc : fminf(d2[i], acc);
        d2[i] = nd;
        wsum += weight(nd);
      }
    }
    wsum = warp_sum(wsum);
    if (lane == 0) part[warp] = wsum;
    __syncthreads();
    if (warp == 0) {
      const double total = warp_sum(lane < warps ? part[lane] : 0.0);
      if (lane == 0) store_sum(sums, b, j, total);  // exchange 1
    }
    // the slice's prefix of weights, made while the other blocks' sums travel
    double mine = 0.0;
    for (int i = lo; i < hi; ++i) mine += weight(d2[i]);
    const double incl = warp_prefix(mine, lane);
    const double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 31) scan[warp] = incl;
    __syncthreads();
    double p = 0.0;
    for (int w = 0; w < warp; ++w) p += scan[w];
    if (lane > 0) p += excl;
    for (int i = lo; i < hi; ++i) {
      p += weight(d2[i]);
      prefix[i] = p;
    }
    gather_sums(sums, G, j, words);

    // every block: the prefix of the G sums in one warp and one order; the
    // owner is the first block whose prefix exceeds u[j] * total (the last
    // where rounding leaves the target at the total)
    if (warp == 0) {
      const int span = (G + 31) / 32, q0 = min(G, lane * span), q1 = min(G, q0 + span);
      double own = 0.0;
      for (int q = q0; q < q1; ++q) own += gathered_sum(words, q);
      const double upto = warp_prefix(own, lane);
      const double total = __shfl_sync(0xffffffffu, upto, 31);
      const double target = u[j] * total;
      const double before = __shfl_up_sync(0xffffffffu, upto, 1);
      double run = lane == 0 ? 0.0 : before, base = run;
      int owner = NONE;
      for (int q = q0; q < q1; ++q) {
        base = run;
        run += gathered_sum(words, q);
        if (run > target) {
          owner = q;
          break;
        }
      }
      const unsigned hit = __ballot_sync(0xffffffffu, owner != NONE);
      const int from = hit ? __ffs(hit) - 1 : (G - 1) / span;
      owner = hit ? __shfl_sync(0xffffffffu, owner, from) : G - 1;
      base = __shfl_sync(0xffffffffu, base, from);
      if (lane == 0) {
        info[0] = target;
        info[1] = base;
        found[0] = NONE;
        found[1] = owner;
      }
    }
    __syncthreads();

    if (found[1] == b) {
      // the owner: the first row of the slice whose prefix exceeds the target
      const double target = info[0], base = info[1];
      for (int i = lo; i < hi; ++i)
        if (base + prefix[i] > target) {
          atomicMin(found, i);
          break;
        }
      __syncthreads();
      const int i = found[0] == NONE ? nr - 1 : found[0];  // a float64 tie at the slice's end
      const float* src = i < nres ? xs + (size_t)i * stride : x + (size_t)(r0 + i) * d;
      for (int e = t; e < stride; e += threads) {
        const float v = e < d ? src[e] : 0.f;
        flag_store(center + e, __float_as_uint(v), j);  // exchange 2
        if (shared_center) c[e] = v;
        if (e < d) centers[(size_t)j * d + e] = v;
      }
      if (t == 0) chosen[j] = r0 + i;
    } else if (shared_center) {
      for (int e = t; e < stride; e += threads) c[e] = __uint_as_float(flag_load(center + e, j));
    }
    __syncthreads();
  }
}

// `steps` of exchange 1 alone (every block's sum, zeros, to every block):
// its round trip, the unit of the chain bound.
__global__ void __launch_bounds__(MAX_THREADS, 1)
    barrier_probe(unsigned long long* scratch, int steps, int d) {
  extern __shared__ __align__(16) unsigned char seed_smem[];
  unsigned* words = reinterpret_cast<unsigned*>(seed_smem);
  const int G = gridDim.x;
  for (int j = 1; j <= steps; ++j) {
    unsigned long long* sums = scratch + (j & 1) * parity_words(G, d);
    if (threadIdx.x == 0) store_sum(sums, blockIdx.x, j, 0.0);
    gather_sums(sums, G, j, words);
  }
}

// The launch's shape for n rows of width d.
struct Plan {
  int grid, rows, resident, lanes, smem, threads, shared_center;
};

cudaError_t make_plan(int n, int d, int min_rows, int max_threads, int capacity, Plan* p) {
  if (n < 1 || d < 1 || d > MAX_WIDTH || min_rows < 1 || max_threads < 32 ||
      max_threads > MAX_THREADS || max_threads % 32)
    return cudaErrorInvalidValue;
  int device = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kmeanspp_seed, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err != cudaSuccess) return err;
  // lanes a row: 8 from d 32 (128 contiguous bytes a load), then the most
  // that leaves each lane at least 4 float4 of a row, up to a warp
  const int d4 = row_stride(d) / 4;
  p->lanes = d4 >= 8 ? 8 : d4 >= 4 ? 4 : d4 >= 2 ? 2 : 1;
  while (p->lanes < 32 && d4 >= 8 * p->lanes) p->lanes *= 2;
  const long long row_bytes = 4LL * row_stride(d);
  const int by_n = ceil_div(n, min_rows);
  int grid = min(sms, by_n);
  for (int pass = 0; pass < 2; ++pass) {
    p->rows = ceil_div(n, grid);
    p->grid = ceil_div(n, p->rows);  // no block without rows
    // a thread a lane of a row, in whole warps, up to max_threads
    p->threads = min(max_threads, ceil_div(p->rows * p->lanes, 32) * 32);
    // the fixed part: the slice's prefix and d2 must fit, the center where
    // it fits beside them
    const int bare = Layout(d, p->grid, p->rows, 0, false).bytes;
    if (bare > optin) return cudaErrorInvalidValue;
    p->shared_center = bare + row_bytes <= optin;
    const int fixed = Layout(d, p->grid, p->rows, 0, p->shared_center).bytes;
    const int most = (int)((optin - fixed) / row_bytes);
    if (capacity > most) return cudaErrorInvalidValue;
    p->resident = min(p->rows, capacity < 0 ? most : capacity);
    p->smem = fixed + (int)(p->resident * row_bytes);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kmeanspp_seed, p->threads,
                                                        (size_t)p->smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidValue;
    const int next = min(per_sm * sms, by_n);  // fewer rows a block: no more shared memory
    if (next == grid) break;
    grid = next;
  }
  return cudaSuccess;
}

}  // namespace kmpp
}  // namespace sylber

using namespace sylber::kmpp;

// The 8-byte words of scratch a seeding of n rows of width d takes (the
// caller zeroes them), or minus the CUDA error that refuses the shape.
// `min_rows`: the fewest rows a block; `max_threads`: a block's most threads
// (a multiple of 32 up to 1,024); `capacity`: the resident rows a block, -1
// for as many as the card's shared memory holds. `plan`, where not null,
// receives the grid, the rows a block, the resident rows a block, the lanes
// a row, the dynamic shared memory, the threads a block and whether the
// center is in shared memory (1) or read from exchange 2's words (0).
extern "C" int sylber_kmeanspp_scratch(int n, int d, int min_rows, int max_threads, int capacity,
                                       int* plan) {
  Plan p;
  const cudaError_t err = make_plan(n, d, min_rows, max_threads, capacity, &p);
  if (err != cudaSuccess) return -(int)err;
  if (plan) {
    const int fields[] = {p.grid, p.rows, p.resident, p.lanes, p.smem, p.threads, p.shared_center};
    for (int i = 0; i < 7; ++i) plan[i] = fields[i];
  }
  return 2 * parity_words(p.grid, d);
}

// k centers of x (n, d) fp32 into centers (k, d) and their rows into chosen
// (k,) int32, from the uniforms u (k,) float64; scratch as
// sylber_kmeanspp_scratch says, zeroed. One cooperative launch on `stream`.
extern "C" int sylber_kmeanspp(const float* x, const double* u, unsigned long long* scratch,
                               int* chosen, float* centers, int n, int d, int k, int min_rows,
                               int max_threads, int capacity, cudaStream_t stream) {
  Plan p;
  cudaError_t err = make_plan(n, d, min_rows, max_threads, capacity, &p);
  if (err != cudaSuccess) return (int)err;
  if (k < 1) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&x, (void*)&u, (void*)&scratch, (void*)&chosen, (void*)&centers,
                  (void*)&n, (void*)&d, (void*)&k, (void*)&p.rows, (void*)&p.resident,
                  (void*)&p.lanes, (void*)&p.shared_center};
  err = cudaLaunchCooperativeKernel((const void*)kmeanspp_seed, dim3(p.grid), dim3(p.threads),
                                    args, (size_t)p.smem, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// `steps` of exchange 1 alone, on the seeding's grid and block for (n, d):
// scratch as for the seeding, zeroed. One cooperative launch on `stream`.
extern "C" int sylber_kmeanspp_barrier_probe(unsigned long long* scratch, int n, int d,
                                             int min_rows, int max_threads, int steps,
                                             cudaStream_t stream) {
  Plan p;
  cudaError_t err = make_plan(n, d, min_rows, max_threads, -1, &p);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&scratch, (void*)&steps, (void*)&d};
  err = cudaLaunchCooperativeKernel((const void*)barrier_probe, dim3(p.grid), dim3(p.threads),
                                    args, (size_t)(8 * p.grid), stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
