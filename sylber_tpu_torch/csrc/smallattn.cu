// Attention for short sequences (L <= 512) with key padding given as a
// per-item valid length.
//
// Replaces sylber_tpu/ops/pallas/smallattn.py::fused_attention_small
// (_kernel).
//
// Numerics are the TPU kernel's, which are the XLA path's: q is scaled in the
// input dtype before QK^T (the wrapper hands the scale already rounded to
// that dtype, the kernel rounds the product), scores and softmax state are
// fp32, keys at or past kv_len weigh exactly 0, an item with kv_len == 0
// gets the uniform mean of all L rows of V, P is rounded to the input dtype
// before PV, PV accumulates in fp32. The TPU kernel held the whole
// (H, L, L) score block of an item in VMEM and normalised P before rounding
// it; a block here has 227 KB, so the key loop is tiled and the softmax is
// online: P is rounded before the division by the row sum. In fp32 that is
// a reordering of the same sums (held to 2e-5 against the plain version),
// in bf16 one more rounding (held to 2e-2).
//
// Bound on the H100 at the encoder's shape (B32 H12 L250 D64): bytes in
// bf16 (q read and o written once, K and V read up to kv_len), the fp32
// CUDA-core rate in fp32 (4 H D L sum(kv_len) operations). The design,
// shared with flash.cu, is in attn_tile.cuh: bf16 on the tensor cores
// (mma.sync with ldmatrix; K, V and P in bf16, S, softmax state and O in fp32
// registers), fp32 register-tiled on the CUDA cores with fmaf. A head's K
// and V at L <= 512 are at most 8 tiles of 64 keys, re-read from L2 by each
// of the head's query blocks of 128 rows.
//
// As built (nvcc 12.8, sm_90a, -Xptxas -v), D = 64: the bf16 kernel uses 254
// registers with 16 bytes spilled, 128 threads and 73,728 bytes of shared
// memory, 2 blocks an SM; the fp32 kernel 224 registers, 256 threads,
// 138,240 bytes, no spill, 1 block an SM. The other widths: 128-222 (fp32,
// 40 bytes spilled at D = 32) and 134-174 (bf16) registers.
#include "attn_tile.cuh"

using namespace sylber;

namespace {

constexpr int MAX_L = 512;

}  // namespace

// q, k, v, o: (B, H, L, D) with element strides (batch, head, row) for each
// in `strides` (12 values, host memory) and a dense last dimension; fp32
// (bf16 == 0) or bf16; kv_len (B,) int32; scale already rounded to the
// input dtype.
extern "C" int sylber_small_attention(const void* q, const void* k,
                                      const void* v, const int* kv_len,
                                      void* o, int B, int H, int L, int D,
                                      const long long* strides, float scale,
                                      int bf16, cudaStream_t stream) {
  if (L > MAX_L) return (int)cudaErrorInvalidValue;
  return attn::launch</*XLA_NUMERICS=*/true>(
      attn::make_args(q, k, v, kv_len, o, B, H, L, D, strides, scale),
      bf16 != 0, stream);
}
