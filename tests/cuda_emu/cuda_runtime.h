// A host stand-in for the part of the CUDA runtime that the kernels of
// sylber_tpu_torch/csrc use, so that the kernel sources can be compiled with
// g++ and run on the CPU by tests/test_torch_cuda_emu.py. Every CUDA thread
// of a block is a fiber (a stack and a saved context of its own) on the one
// host thread that launches: a fiber runs until it waits (a barrier, an
// mbarrier, a flag word), then hands the host thread to the next one, round
// robin: in ascending thread order in one block (or cooperative launch) and
// descending in the next, so that a missing barrier shows whichever thread
// reads what another wrote. Blocks run one after the other, except in a
// cooperative launch, where every block's threads take turns at once. __syncthreads,
// __syncwarp, the warp shuffles and the ballot are barriers with an
// exchange buffer. It checks indexing, masking and pipeline order; it
// cannot check PTX, timing or anything asynchronous (copies complete at once).
#pragma once
#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <type_traits>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __restrict__
#define __launch_bounds__(...)
#define __align__(x) __attribute__((aligned(x)))
#define __grid_constant__
#define CUDART_VERSION 12080

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
struct alignas(8) int2 { int x, y; };
inline int2 make_int2(int a, int b) { return {a, b}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { uint32_t x, y, z, w; };
struct alignas(8) uint2 { uint32_t x, y; };
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorCooperativeLaunchTooLarge = 82 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
constexpr size_t kMaxBlockSharedMemory = 232448;
template <typename K>
cudaError_t cudaFuncSetAttribute(K, int, int bytes) {
  return (size_t)bytes > kMaxBlockSharedMemory ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
// a small card: 3 SMs (a persistent grid walks several tiles a block), each
// running two blocks that take at most half of the shared memory, else one
constexpr int kEmuSMs = 3;
enum { cudaDevAttrMultiProcessorCount = 16, cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
inline cudaError_t cudaGetDevice(int* device) { *device = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* value, int attr, int) {
  if (attr == cudaDevAttrMultiProcessorCount) *value = kEmuSMs;
  else if (attr == cudaDevAttrMaxSharedMemoryPerBlockOptin) *value = (int)kMaxBlockSharedMemory;
  else return cudaErrorInvalidValue;
  return cudaSuccess;
}
inline int emu_blocks_per_sm(size_t smem) {
  return smem > kMaxBlockSharedMemory ? 0 : smem <= kMaxBlockSharedMemory / 2 - 1024 ? 2 : 1;
}
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, K, int, size_t smem) {
  *blocks = emu_blocks_per_sm(smem);
  return cudaSuccess;
}
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0 };
enum { cudaEnableDefault = 0 };
// Hands out emu.cpp's cuTensorMapEncodeTiled for that name, fails for any other.
cudaError_t cudaGetDriverEntryPointByVersion(const char* symbol, void** fn, unsigned version,
                                             unsigned long long flags,
                                             cudaDriverEntryPointQueryResult* found);
// The kernels' dynamic shared memory (emu.cpp): every block's, one after the other.
namespace sylber { namespace attn { extern unsigned char smem_raw[]; } }

// Hands the host thread to the next emulated thread (emu.cpp); returns when
// this one's turn comes round again.
void emu_yield();
// One emulated thread's wait: each turn yields; after `limit` it aborts with
// `what` (a wait that nothing will end).
struct EmuWait {
  const char* what;
  std::chrono::steady_clock::duration limit;
  std::chrono::steady_clock::time_point start = std::chrono::steady_clock::now();
  long turns = 0;
  void turn() {
    emu_yield();
    if (++turns % 4096 == 0 && std::chrono::steady_clock::now() - start > limit) {
      fprintf(stderr, "%s\n", what);
      abort();
    }
  }
};

struct Barrier {
  int n, count = 0;
  unsigned long generation = 0;
  explicit Barrier(int n_) : n(n_) {}
  void wait() {
    const unsigned long g = generation;
    if (++count == n) {
      count = 0;
      ++generation;
      return;
    }
    EmuWait w{"a barrier that some thread of the block never reaches",
              std::chrono::minutes(1)};
    while (generation == g) w.turn();
  }
};

struct WarpCtx {
  Barrier bar{32};
  uint64_t buf[32][8];  // one exchange slot per lane
};
struct BlockCtx {
  Barrier* bar;
  std::vector<WarpCtx*> warps;
  unsigned char* smem;  // the block's dynamic shared memory
};
extern thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
extern thread_local BlockCtx* emu_block;
inline WarpCtx& emu_warp() { return *emu_block->warps[threadIdx.x / 32]; }
inline unsigned char* emu_dynamic_smem() { return emu_block->smem; }
inline int emu_lane() { return threadIdx.x % 32; }

inline void __syncthreads() { emu_block->bar->wait(); }
inline void __syncwarp() { emu_warp().bar.wait(); }
template <typename V>  // float or double
inline V __shfl_xor_sync(unsigned, V v, int lane_mask) {
  WarpCtx& w = emu_warp();
  const int lane = emu_lane();
  memcpy(&w.buf[lane][0], &v, sizeof(V));
  w.bar.wait();
  V r;
  memcpy(&r, &w.buf[lane ^ lane_mask][0], sizeof(V));
  w.bar.wait();
  return r;
}
template <typename V>
inline V __shfl_up_sync(unsigned, V v, int delta) {
  WarpCtx& w = emu_warp();
  const int lane = emu_lane();
  memcpy(&w.buf[lane][0], &v, sizeof(V));
  w.bar.wait();
  V r = v;
  if (lane >= delta) memcpy(&r, &w.buf[lane - delta][0], sizeof(V));
  w.bar.wait();
  return r;
}
template <typename V>
inline V __shfl_sync(unsigned, V v, int src) {
  WarpCtx& w = emu_warp();
  const int lane = emu_lane();
  memcpy(&w.buf[lane][0], &v, sizeof(V));
  w.bar.wait();
  V r;
  memcpy(&r, &w.buf[src & 31][0], sizeof(V));
  w.bar.wait();
  return r;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  WarpCtx& w = emu_warp();
  w.buf[emu_lane()][0] = pred != 0;
  w.bar.wait();
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r |= (unsigned)w.buf[l][0] << l;
  w.bar.wait();
  return r;
}
inline bool __any_sync(unsigned mask, int pred) { return __ballot_sync(mask, pred) != 0; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
// round-to-nearest single operations that the compiler may not contract
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __frcp_rn(float a) { volatile float r = 1.f / a; return r; }

inline double __longlong_as_double(long long x) {
  double f;
  memcpy(&f, &x, 8);
  return f;
}
inline long long __double_as_longlong(double x) {
  long long i;
  memcpy(&i, &x, 8);
  return i;
}
inline float __int_as_float(unsigned x) {
  float f;
  memcpy(&f, &x, 4);
  return f;
}
inline float __uint_as_float(uint32_t x) {
  float f;
  memcpy(&f, &x, 4);
  return f;
}
// bytes 0-3 from x, 4-7 from y; s holds a source byte a result byte (no sign mode)
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (uint64_t)y << 32 | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) r |= (unsigned)(v >> (8 * ((s >> (4 * i)) & 7)) & 0xff) << (8 * i);
  return r;
}
inline uint32_t __float_as_uint(float x) {
  uint32_t i;
  memcpy(&i, &x, 4);
  return i;
}
inline int __float_as_int(float x) {
  int i;
  memcpy(&i, &x, 4);
  return i;
}
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
inline int atomicMin(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v < old && !__atomic_compare_exchange_n(p, &old, v, false, __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return old;
}
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
template <typename T>
inline T __ldg(const T* p) { return *p; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

// Runs `body` once per thread of every block of the grid.
void emu_launch(const std::function<void()>& body, dim3 grid, int threads, size_t smem,
                cudaStream_t);
// The same with every block's threads at once, each block with its own
// dynamic shared memory: cudaLaunchCooperativeKernel. Refuses a grid that
// the small card cannot hold resident at once, as CUDA does.
cudaError_t emu_launch_cooperative(const std::function<void()>& body, dim3 grid, int threads,
                                   size_t smem);
template <typename... A, size_t... I>
void emu_call(void (*kernel)(A...), void** args, std::index_sequence<I...>) {
  kernel(*static_cast<std::remove_reference_t<A>*>(args[I])...);
}
template <typename... A>
cudaError_t cudaLaunchCooperativeKernel(void (*kernel)(A...), dim3 grid, dim3 block, void** args,
                                        size_t smem, cudaStream_t) {
  return emu_launch_cooperative(
      [=] { emu_call(kernel, args, std::index_sequence_for<A...>{}); }, grid, block.x, smem);
}
