// A host stand-in for the part of the CUDA runtime that the attention kernels
// of sylber_tpu_torch/csrc use, so that the kernel sources can be compiled
// with g++ and run on the CPU by tests/test_torch_cuda_emu.py. Every CUDA
// thread of a block is a host thread; blocks run one after the other.
// __syncthreads, __syncwarp and the warp shuffles are barriers with an
// exchange buffer. It checks indexing, masking and pipeline order; it cannot
// check PTX, timing or anything asynchronous (copies complete at once).
#pragma once
#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __restrict__
#define __launch_bounds__(...)
#define __align__(x) __attribute__((aligned(x)))

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { uint32_t x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
constexpr size_t kMaxBlockSharedMemory = 232448;
template <typename K>
cudaError_t cudaFuncSetAttribute(K, int, int bytes) {
  return (size_t)bytes > kMaxBlockSharedMemory ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

struct Barrier {
  std::mutex mu;
  std::condition_variable cv;
  int n, count = 0;
  unsigned long generation = 0;
  explicit Barrier(int n_) : n(n_) {}
  void wait() {
    std::unique_lock<std::mutex> lock(mu);
    const unsigned long g = generation;
    if (++count == n) {
      count = 0;
      ++generation;
      cv.notify_all();
    } else {
      cv.wait(lock, [&] { return generation != g; });
    }
  }
};

struct WarpCtx {
  Barrier bar{32};
  uint64_t buf[32][8];  // one exchange slot per lane
};
struct BlockCtx {
  Barrier* bar;
  std::vector<WarpCtx*> warps;
};
extern thread_local dim3 threadIdx, blockIdx;
extern thread_local BlockCtx* emu_block;
inline WarpCtx& emu_warp() { return *emu_block->warps[threadIdx.x / 32]; }
inline int emu_lane() { return threadIdx.x % 32; }

inline void __syncthreads() { emu_block->bar->wait(); }
inline void __syncwarp() { emu_warp().bar.wait(); }
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  WarpCtx& w = emu_warp();
  const int lane = emu_lane();
  memcpy(&w.buf[lane][0], &v, 4);
  w.bar.wait();
  float r;
  memcpy(&r, &w.buf[lane ^ lane_mask][0], 4);
  w.bar.wait();
  return r;
}
inline float __int_as_float(unsigned x) {
  float f;
  memcpy(&f, &x, 4);
  return f;
}
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

// Runs `body` once per thread of every block of the grid.
void emu_launch(const std::function<void()>& body, dim3 grid, int threads, size_t smem,
                cudaStream_t);
