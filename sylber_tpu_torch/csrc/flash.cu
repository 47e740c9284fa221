// Blocked online-softmax attention for long sequences, key padding given as
// a per-item valid length.
//
// Replaces sylber_tpu/ops/pallas/flash.py::flash_attention
// (_flash -> _flash_kernel).
//
// Numerics follow the TPU kernel: the running max, normaliser and
// accumulator are fp32, q is scaled by `scale` (which may be overridden) in
// fp32, masked keys contribute exactly 0, and a query row whose keys are all
// masked (kv_len == 0) gives 0, not NaN. In fp32 everything is fp32, as on
// the TPU. In bf16 the tensor cores take q as it is and the fp32 scores are
// scaled, so q * scale is not rounded; P is rounded to bf16 for the P V
// product where the TPU kernel kept it in fp32, one bf16 rounding held to
// 2e-2 against the fp32 plain version.
//
// Bound on the H100 at the encoder's long shape (B32 H12 L1000 D64):
// operations, 4 H D L sum(kv_len), at the tensor-core rate in bf16 and the
// CUDA-core rate in fp32. The design, shared with smallattn.cu, is in
// attn_tile.cuh: bf16 on the tensor cores (mma.sync with ldmatrix; K, V and
// P in bf16, S, softmax state and O in fp32 registers, cp.async ring of
// 64-key tiles), fp32 register-tiled on the CUDA cores with fmaf (TF32 would
// not hold 2e-5); the key loop ends at kv_len; q, k, v, o by strides.
//
// As built (nvcc 12.8, sm_90a, -Xptxas -v), D = 64: the bf16 kernel uses 255
// registers, no spill, 128 threads and 73,728 bytes of shared memory, 2
// blocks an SM; the fp32 kernel 224 registers, 256 threads, 138,240 bytes,
// no spill, 1 block an SM. The other widths: 128-222 (fp32) and 149-175
// (bf16) registers, no spill.
#include "attn_tile.cuh"

using namespace sylber;

// q, k, v, o: (B, H, L, D) with element strides (batch, head, row) for each
// in `strides` (12 values, host memory) and a dense last dimension; fp32
// (bf16 == 0) or bf16; kv_len (B,) int32.
extern "C" int sylber_flash_attention(const void* q, const void* k,
                                      const void* v, const int* kv_len,
                                      void* o, int B, int H, int L, int D,
                                      const long long* strides, float scale,
                                      int bf16, cudaStream_t stream) {
  return attn::launch</*XLA_NUMERICS=*/false>(
      attn::make_args(q, k, v, kv_len, o, B, H, L, D, strides, scale),
      bf16 != 0, stream);
}
