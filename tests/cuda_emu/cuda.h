// The CUDA types that csrc/int8_gemm.cu takes from <cuda.h>, for the host
// stand-in: a tensor map is a 128-byte block whose first words emu.cpp's
// cuTensorMapEncodeTiled fills (base, dims, row stride, box) and whose TMA
// stand-in reads.
#pragma once
#include "cuda_runtime.h"

typedef int CUresult;
enum { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
typedef uint64_t cuuint64_t;
typedef uint32_t cuuint32_t;
struct alignas(64) CUtensorMap { unsigned long long opaque[16]; };
typedef enum { CU_TENSOR_MAP_DATA_TYPE_UINT8 = 0 } CUtensorMapDataType;
typedef enum { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 } CUtensorMapInterleave;
typedef enum {
  CU_TENSOR_MAP_SWIZZLE_NONE = 0, CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_SWIZZLE_64B,
  CU_TENSOR_MAP_SWIZZLE_128B
} CUtensorMapSwizzle;
typedef enum {
  CU_TENSOR_MAP_L2_PROMOTION_NONE = 0, CU_TENSOR_MAP_L2_PROMOTION_L2_64B,
  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B
} CUtensorMapL2promotion;
typedef enum { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 } CUtensorMapFloatOOBfill;

CUresult cuTensorMapEncodeTiled(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank,
                                void* base, const cuuint64_t* dims, const cuuint64_t* strides,
                                const cuuint32_t* box, const cuuint32_t* element_strides,
                                CUtensorMapInterleave interleave, CUtensorMapSwizzle swizzle,
                                CUtensorMapL2promotion promotion, CUtensorMapFloatOOBfill fill);
