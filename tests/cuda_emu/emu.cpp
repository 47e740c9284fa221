// The launch loop and the PTX helpers of attn_tile.cuh and int8_gemm.cu,
// emulated on the host after the PTX ISA's fragment layouts (ldmatrix,
// mma.m16n8k16 bf16, mma.m16n8k32 s8).
#include "cuda_bf16.h"

thread_local dim3 threadIdx, blockIdx, blockDim;
thread_local BlockCtx* emu_block;
namespace sylber { namespace attn {
alignas(16) unsigned char smem_raw[256 * 1024];  // the kernels' extern __shared__ array
} }

void emu_launch(const std::function<void()>& body, dim3 grid, int threads, size_t smem,
                cudaStream_t) {
  if (smem > kMaxBlockSharedMemory) {
    fprintf(stderr, "launch asks for %zu bytes of shared memory\n", smem);
    abort();
  }
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      memset(sylber::attn::smem_raw, 0xff, smem);  // NaNs: nothing is zero by luck
      Barrier bar(threads);
      BlockCtx ctx;
      ctx.bar = &bar;
      for (int w = 0; w < (threads + 31) / 32; ++w) ctx.warps.push_back(new WarpCtx);
      std::vector<std::thread> pool;
      for (int t = 0; t < threads; ++t)
        pool.emplace_back([&, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by, bz);
          blockDim = dim3(threads);
          emu_block = &ctx;
          body();
        });
      for (auto& t : pool) t.join();
      for (auto* w : ctx.warps) delete w;
    }
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

void cp_async16(void* dst, const void* src, int bytes) { attn::cp_async16(dst, src, bytes); }
void cp_async_commit() {}
void ldmatrix_x4(uint32_t (&r)[4], const void* p) { attn::ldmatrix_x4(r, p); }

// mma.m16n8k32.row.col.s32.s8.s8.s32: lane (g, t) = (lane / 4, lane % 4).
// A (16 x 32): register i holds row g + 8 (i % 2), bytes 4t .. 4t + 3 of
// k-half i / 2 (k = 16 (i / 2) + 4t + byte); B (32 x 8): register j holds
// column g, k = 16 j + 4t + byte; C: rows g and g + 8, columns 2t, 2t + 1.
static int8_t s8(uint64_t reg, int byte) { return (int8_t)((reg >> (8 * byte)) & 0xff); }

void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  WarpCtx& w = emu_warp();
  const int lane = emu_lane(), g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) w.buf[lane][i] = a[i];
  w.buf[lane][4] = b0;
  w.buf[lane][5] = b1;
  w.bar.wait();
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i / 2), col = 2 * t + (i % 2);
    int32_t s = c[i];
    for (int k = 0; k < 32; ++k) {
      const int half = k / 16, tk = (k % 16) / 4, byte = k % 4;
      const int8_t av = s8(w.buf[(row % 8) * 4 + tk][(row >= 8) + 2 * half], byte);
      const int8_t bv = s8(w.buf[col * 4 + tk][4 + half], byte);
      s += (int32_t)av * (int32_t)bv;
    }
    c[i] = s;
  }
  w.bar.wait();
}

} }  // namespace sylber::i8
