// The launch loops and the PTX helpers of common.cuh, attn_tile.cuh and
// int8_gemm.cu, emulated on the host after the PTX ISA: mbarriers (arrivals
// and transaction bytes, phases), the bulk copy, ldmatrix and mma.m16n8k16
// bf16 fragment layouts, TMA 2-D tile loads with the 128-byte swizzle and
// wgmma s8 through shared-memory descriptors; the cooperative launch and
// common.cuh's flag words. The emulated threads are fibers (ucontext) that
// the launch runs round robin on its own host thread, in ascending and
// descending order by turns.
#include <sys/mman.h>
#include <ucontext.h>

#include <chrono>
#include <memory>
#include <unordered_map>

#include "cuda.h"
#include "cuda_bf16.h"

thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
thread_local BlockCtx* emu_block;

namespace {
// An emulated thread: its context, its stack, and what the launch loop puts in
// the thread-local registers before it runs.
struct Fiber {
  ucontext_t ctx;
  dim3 tid, bid;
  BlockCtx* block;
  bool done;
};
constexpr size_t kFiberStack = 256 * 1024;
thread_local ucontext_t scheduler;
thread_local Fiber* running;
thread_local const std::function<void()>* fiber_body;
thread_local dim3 fiber_block_dim, fiber_grid;

void fiber_main() {  // returns to `scheduler` (uc_link)
  (*fiber_body)();
  running = nullptr;
}

// Every other call takes the turns in reverse order, so that a block whose
// threads skip a barrier shows it whichever thread reads what another wrote.
thread_local unsigned long fiber_runs;

// Runs `body` once as each of `fibers` (their ids and blocks set), taking
// turns at every wait, until all have returned.
void run_fibers(std::vector<Fiber>& fibers, const std::function<void()>& body, dim3 block_dim,
                dim3 grid) {
  const size_t n = fibers.size();
  unsigned char* stacks = (unsigned char*)mmap(nullptr, n * kFiberStack, PROT_READ | PROT_WRITE,
                                               MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
  if (stacks == MAP_FAILED) {
    fprintf(stderr, "no memory for %zu emulated threads' stacks\n", n);
    abort();
  }
  fiber_body = &body;
  fiber_block_dim = block_dim;
  fiber_grid = grid;
  for (size_t i = 0; i < n; ++i) {
    Fiber& f = fibers[i];
    f.done = false;
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = stacks + i * kFiberStack;
    f.ctx.uc_stack.ss_size = kFiberStack;
    f.ctx.uc_link = &scheduler;
    makecontext(&f.ctx, fiber_main, 0);
  }
  const bool reverse = fiber_runs++ & 1;
  for (size_t live = n; live;) {
    for (size_t i = 0; i < n; ++i) {
      Fiber& f = fibers[reverse ? n - 1 - i : i];
      if (f.done) continue;
      running = &f;
      threadIdx = f.tid;
      blockIdx = f.bid;
      blockDim = fiber_block_dim;
      gridDim = fiber_grid;
      emu_block = f.block;
      swapcontext(&scheduler, &f.ctx);
      // back here when the fiber waits (emu_yield) or its body returns
      if (running == nullptr) {
        f.done = true;
        --live;
      }
    }
  }
  munmap(stacks, n * kFiberStack);
}
}  // namespace

void emu_yield() {
  Fiber* f = running;
  swapcontext(&f->ctx, &scheduler);
}

namespace sylber { namespace attn {
// the kernels' extern __shared__ array; 1024-aligned, as the 128-byte swizzle wants
alignas(1024) unsigned char smem_raw[256 * 1024];
} }

namespace sylber {
namespace {
// An mbarrier: arrivals still expected in this phase (of `count`), transaction
// bytes still expected, phases completed. The state lives beside the
// barrier's word, keyed by its address; a copy lands at once.
struct EmuBarrier {
  int count, pending;
  long long tx;
  unsigned long phase;
};
std::mutex bar_mu;
std::unordered_map<const void*, EmuBarrier> bars;

EmuBarrier& find_barrier(const void* bar) {
  const auto it = bars.find(bar);
  if (it == bars.end()) {
    fprintf(stderr, "an mbarrier used before mbar_init\n");
    abort();
  }
  return it->second;
}
void settle(EmuBarrier& b) {
  if (b.pending == 0 && b.tx == 0) {
    ++b.phase;
    b.pending = b.count;
  }
}
}  // namespace

void mbar_init(uint64_t* bar, int count) {
  std::lock_guard<std::mutex> lock(bar_mu);
  bars[bar] = EmuBarrier{count, count, 0, 0};
}
void mbar_expect_tx(uint64_t* bar, unsigned bytes) {  // an arrival that expects bytes
  std::lock_guard<std::mutex> lock(bar_mu);
  EmuBarrier& b = find_barrier(bar);
  b.tx += bytes;
  --b.pending;
  settle(b);
}
void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> lock(bar_mu);
  EmuBarrier& b = find_barrier(bar);
  --b.pending;
  settle(b);
}
void mbar_complete_tx(uint64_t* bar, unsigned bytes) {
  std::lock_guard<std::mutex> lock(bar_mu);
  EmuBarrier& b = find_barrier(bar);
  b.tx -= bytes;
  settle(b);
}
// Returns once the phase of this parity is complete (at once for the parity
// of the phase before the current one); aborts after a few seconds.
void mbar_wait(uint64_t* bar, int parity) {
  EmuWait w{"a wait for a phase that never completes", std::chrono::seconds(5)};
  for (;;) {
    {
      std::lock_guard<std::mutex> lock(bar_mu);
      if ((int)(find_barrier(bar).phase & 1) != parity) return;
    }
    w.turn();
  }
}
// Takes turns until `done()`; aborts with `what` after two minutes.
template <typename F>
static void spin_until(F done, const char* what) {
  EmuWait w{what, std::chrono::minutes(2)};
  while (!done()) w.turn();
}
// common.cuh's flag words: a store and a spin on the step, as whole 8-byte words
void flag_store(unsigned long long* word, unsigned value, unsigned step) {
  __atomic_store_n(word, (unsigned long long)step << 32 | value, __ATOMIC_SEQ_CST);
}
unsigned flag_load(const unsigned long long* word, unsigned step) {
  unsigned long long v = 0;
  spin_until(
      [&] {
        v = __atomic_load_n(word, __ATOMIC_SEQ_CST);
        return (unsigned)(v >> 32) == step;
      },
      "a wait for a flag word that never holds its step");
  return (unsigned)v;
}
void bulk_copy_to_shared(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  if (bytes % 16 || (uintptr_t)dst % 16 || (uintptr_t)src % 16) {
    fprintf(stderr, "bulk copy of %u bytes: size or an address is not a multiple of 16\n", bytes);
    abort();
  }
  memcpy(dst, src, bytes);
  mbar_complete_tx(bar, bytes);
}
}  // namespace sylber

// The tensor map of a 2-D uint8 tensor: the fields TMA's stand-in needs, after
// the checks the real encoder makes of them (16-byte base and stride, a box of at
// most 256 rows whose inner extent fits the 128-byte swizzle).
CUresult cuTensorMapEncodeTiled(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank,
                                void* base, const cuuint64_t* dims, const cuuint64_t* strides,
                                const cuuint32_t* box, const cuuint32_t* element_strides,
                                CUtensorMapInterleave interleave, CUtensorMapSwizzle swizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill fill) {
  if (type != CU_TENSOR_MAP_DATA_TYPE_UINT8 || rank != 2 || (uintptr_t)base % 16 ||
      strides[0] % 16 || strides[0] < dims[0] || box[0] != 128 || box[1] < 1 || box[1] > 256 ||
      element_strides[0] != 1 || element_strides[1] != 1 ||
      interleave != CU_TENSOR_MAP_INTERLEAVE_NONE || swizzle != CU_TENSOR_MAP_SWIZZLE_128B ||
      fill != CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
    return CUDA_ERROR_INVALID_VALUE;
  memset(map, 0, sizeof *map);
  map->opaque[0] = (uintptr_t)base;
  map->opaque[1] = dims[0];
  map->opaque[2] = dims[1];
  map->opaque[3] = strides[0];
  map->opaque[4] = box[0];
  map->opaque[5] = box[1];
  return CUDA_SUCCESS;
}

cudaError_t cudaGetDriverEntryPointByVersion(const char* symbol, void** fn, unsigned,
                                             unsigned long long,
                                             cudaDriverEntryPointQueryResult* found) {
  if (strcmp(symbol, "cuTensorMapEncodeTiled") != 0) return cudaErrorInvalidValue;
  *fn = (void*)&cuTensorMapEncodeTiled;
  *found = cudaDriverEntryPointSuccess;
  return cudaSuccess;
}

void emu_launch(const std::function<void()>& body, dim3 grid, int threads, size_t smem,
                cudaStream_t) {
  if (smem > kMaxBlockSharedMemory) {
    fprintf(stderr, "launch asks for %zu bytes of shared memory\n", smem);
    abort();
  }
  std::vector<Fiber> fibers(threads);
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      memset(sylber::attn::smem_raw, 0xff, smem);  // NaNs: nothing is zero by luck
      Barrier bar(threads);
      BlockCtx ctx;
      ctx.bar = &bar;
      ctx.smem = sylber::attn::smem_raw;
      for (int w = 0; w < (threads + 31) / 32; ++w) ctx.warps.push_back(new WarpCtx);
      for (int t = 0; t < threads; ++t) {
        fibers[t].tid = dim3(t);
        fibers[t].bid = dim3(bx, by, bz);
        fibers[t].block = &ctx;
      }
      run_fibers(fibers, body, dim3(threads), grid);
      for (auto* w : ctx.warps) delete w;
    }
}

cudaError_t emu_launch_cooperative(const std::function<void()>& body, dim3 grid, int threads,
                                   size_t smem) {
  const unsigned blocks = grid.x * grid.y * grid.z;
  if (smem > kMaxBlockSharedMemory || blocks > (unsigned)(kEmuSMs * emu_blocks_per_sm(smem)))
    return cudaErrorCooperativeLaunchTooLarge;
  std::vector<std::unique_ptr<Barrier>> bars;
  std::vector<BlockCtx> ctxs(blocks);
  std::vector<std::vector<float4>> memory(blocks);  // 16-byte aligned
  for (unsigned b = 0; b < blocks; ++b) {
    bars.emplace_back(new Barrier(threads));
    memory[b].resize(smem / 16 + 1);
    memset(memory[b].data(), 0xff, smem);  // NaNs: nothing is zero by luck
    ctxs[b].bar = bars.back().get();
    ctxs[b].smem = (unsigned char*)memory[b].data();
    for (int w = 0; w < (threads + 31) / 32; ++w) ctxs[b].warps.push_back(new WarpCtx);
  }
  std::vector<Fiber> fibers(blocks * threads);
  for (unsigned b = 0; b < blocks; ++b)
    for (int t = 0; t < threads; ++t) {
      Fiber& f = fibers[b * threads + t];
      f.tid = dim3(t);
      f.bid = dim3(b % grid.x, b / grid.x % grid.y, b / (grid.x * grid.y));
      f.block = &ctxs[b];
    }
  run_fibers(fibers, body, dim3(threads), grid);
  for (auto& c : ctxs)
    for (auto* w : c.warps) delete w;
  return cudaSuccess;
}

namespace sylber { namespace attn {

void cp_async16(void* dst, const void* src, int bytes) {
  if (bytes) memcpy(dst, src, 16); else memset(dst, 0, 16);
}
void cp_async_commit() {}
float fast_exp2(float x) { return exp2f(x); }

// Matrix i of an x4 load takes its 8 row addresses from lanes 8i .. 8i+7; a
// lane gets row lane/4, elements 2(lane%4) and +1, or the transposed pair.
static void ldmatrix(uint32_t (&r)[4], const void* p, bool trans) {
  WarpCtx& w = emu_warp();
  const int lane = emu_lane(), g = lane >> 2, t = lane & 3;
  w.buf[lane][0] = (uint64_t)p;
  w.bar.wait();
  for (int i = 0; i < 4; ++i) {
    if (!trans) {
      const uint16_t* row = (const uint16_t*)w.buf[8 * i + g][0];
      r[i] = row[2 * t] | ((uint32_t)row[2 * t + 1] << 16);
    } else {
      const uint16_t* r0 = (const uint16_t*)w.buf[8 * i + 2 * t][0];
      const uint16_t* r1 = (const uint16_t*)w.buf[8 * i + 2 * t + 1][0];
      r[i] = r0[g] | ((uint32_t)r1[g] << 16);
    }
  }
  w.bar.wait();
}
void ldmatrix_x4(uint32_t (&r)[4], const void* p) { ldmatrix(r, p, false); }
void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) { ldmatrix(r, p, true); }

static float bf16_half(uint32_t reg, int half) {
  const uint32_t u = half ? (reg & 0xffff0000u) : (reg << 16);
  float f;
  memcpy(&f, &u, 4);
  return f;
}
// Element (row, k) of the 16 x 16 A fragments the lanes published in buf[.][0..3].
static float a_fragment(WarpCtx& w, int row, int k) {
  const int lane = (row % 8) * 4 + (k % 8) / 2, reg = (row >= 8) + 2 * (k >= 8);
  return bf16_half((uint32_t)w.buf[lane][reg], k % 2);
}

void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  WarpCtx& w = emu_warp();
  const int lane = emu_lane(), g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) w.buf[lane][i] = a[i];
  w.buf[lane][4] = b0;
  w.buf[lane][5] = b1;
  w.bar.wait();
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i / 2), col = 2 * t + (i % 2);
    float s = c[i];
    for (int k = 0; k < 16; ++k)  // B (k, col): lane col*4 + (k%8)/2, register k/8
      s += a_fragment(w, row, k) *
           bf16_half((uint32_t)w.buf[col * 4 + (k % 8) / 2][4 + (k >= 8)], k % 2);
    c[i] = s;
  }
  w.bar.wait();
}

} }  // namespace sylber::attn

namespace sylber { namespace i8 {

// A shared address is the offset into the dynamic shared memory (the only
// shared memory whose address the GEMM takes).
uint32_t smem_addr(const void* p) {
  const long long off = (const unsigned char*)p - attn::smem_raw;
  if (off < 0 || off >= (long long)sizeof attn::smem_raw) {
    fprintf(stderr, "a shared address outside the dynamic shared memory\n");
    abort();
  }
  return (uint32_t)off;
}

// The 128-byte swizzle as the hardware applies it to a shared address: the
// 16-byte chunk (bits 4-6) XOR the row within a 1024-byte group (bits 7-9).
static uint32_t swizzle128(uint32_t addr) { return addr ^ (((addr >> 7) & 7) << 4); }

// cp.async.bulk.tensor.2d with the 128-byte swizzle: row r, byte x of the box
// lands at dst + 128 r + x, swizzled; elements outside the tensor are zeros.
void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  const int8_t* base = (const int8_t*)(uintptr_t)map->opaque[0];
  const long long dim0 = map->opaque[1], dim1 = map->opaque[2], stride = map->opaque[3];
  const unsigned box0 = map->opaque[4], box1 = map->opaque[5];
  const uint32_t d0 = smem_addr(dst);
  if (d0 % 1024) {
    fprintf(stderr, "a TMA box with the 128-byte swizzle at a shared address off 1024 bytes\n");
    abort();
  }
  for (unsigned r = 0; r < box1; ++r)
    for (unsigned x = 0; x < box0; ++x) {
      const long long row = (long long)c1 + r, col = (long long)c0 + x;
      const bool inside = row >= 0 && row < dim1 && col >= 0 && col < dim0;
      attn::smem_raw[swizzle128(d0 + r * box0 + x)] = inside ? base[row * stride + col] : 0;
    }
  mbar_complete_tx(bar, box0 * box1);
}

// Byte (r, kb) of a K-major operand that a descriptor names: the start
// address (bits 0-13, in 16 bytes), 8-row groups the stride byte offset apart
// (bits 32-45), 128-byte rows, the 128-byte swizzle (layout type 1, bits 62-63).
static int8_t operand(uint64_t desc, int r, int kb) {
  if ((desc >> 62) != 1) {
    fprintf(stderr, "a wgmma descriptor of a layout other than the 128-byte swizzle\n");
    abort();
  }
  const uint32_t start = (uint32_t)(desc & 0x3FFF) << 4;
  const uint32_t sbo = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
  return (int8_t)attn::smem_raw[swizzle128(start + (r / 8) * sbo + (r % 8) * 128 + kb)];
}

// wgmma.mma_async m64n128k32 s32.s8.s8, both operands from shared memory:
// thread t of the warpgroup (warp w = t / 32) holds, in register 4 i + 2 h + c,
// row 16 w + lane / 4 + 8 h and column 8 i + 2 (lane % 4) + c. Computed when
// issued: the operands must be in place then, as the kernel's barriers ensure.
void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  for (int i = 0; i < 16; ++i)
    for (int q = 0; q < 4; ++q) {
      const int row = 16 * w + lane / 4 + 8 * (q / 2), col = 8 * i + 2 * (lane % 4) + q % 2;
      int32_t s = 0;
      for (int k = 0; k < 32; ++k) s += (int32_t)operand(da, row, k) * operand(db, col, k);
      d[4 * i + q] += s;
    }
}

} }  // namespace sylber::i8
