#pragma once
#include "cuda_bf16.h"
// The driver API's tensor maps, as far as csrc/ uses them: a CUtensorMap
// records what cuTensorMapEncodeTiled was given (base, dims, byte strides,
// box), after the checks the driver makes; tma_load_4d in wgmma_impl.h
// copies boxes through it. cudaGetDriverEntryPoint[ByVersion] hands out the
// encoder.
typedef int CUresult;
enum { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
typedef uint64_t cuuint64_t;
typedef uint32_t cuuint32_t;
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_FLOAT32 = 7, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE = 0 };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_NONE = 0, CU_TENSOR_MAP_L2_PROMOTION_L2_128B = 2 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };

struct alignas(64) CUtensorMap {
  const unsigned char* base;
  uint32_t rank, esize;
  uint64_t dims[5], strides[5];  // strides[i]: bytes between steps of dim i (strides[0] = esize)
  uint32_t box[5];
};
static_assert(sizeof(CUtensorMap) <= 128, "a CUtensorMap is 128 bytes");

inline CUresult cuTensorMapEncodeTiled(CUtensorMap* m, CUtensorMapDataType type, cuuint32_t rank,
                                       void* base, const cuuint64_t* dims,
                                       const cuuint64_t* strides, const cuuint32_t* box,
                                       const cuuint32_t* elem_strides, CUtensorMapInterleave,
                                       CUtensorMapSwizzle, CUtensorMapL2promotion,
                                       CUtensorMapFloatOOBfill) {
  const uint32_t esize = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  if (rank < 1 || rank > 5 || reinterpret_cast<uintptr_t>(base) % 16 ||
      box[0] * esize % 16)
    return CUDA_ERROR_INVALID_VALUE;
  *m = {};
  m->base = static_cast<const unsigned char*>(base);
  m->rank = rank;
  m->esize = esize;
  for (uint32_t i = 0; i < rank; ++i) {
    if (dims[i] < 1 || dims[i] > (1ull << 32) || box[i] < 1 || box[i] > 256 ||
        elem_strides[i] != 1)
      return CUDA_ERROR_INVALID_VALUE;
    if (i > 0 && (strides[i - 1] % 16 || strides[i - 1] >= (1ull << 40)))
      return CUDA_ERROR_INVALID_VALUE;
    m->dims[i] = dims[i];
    m->strides[i] = i ? strides[i - 1] : esize;
    m->box[i] = box[i];
  }
  return CUDA_SUCCESS;
}

#define CUDART_VERSION 12080
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0 };
enum { cudaEnableDefault = 0 };
inline int cudaGetDriverEntryPointByVersion(const char* name, void** fn, unsigned,
                                            unsigned long long,
                                            cudaDriverEntryPointQueryResult* q) {
  *fn = strcmp(name, "cuTensorMapEncodeTiled") ? nullptr
                                               : reinterpret_cast<void*>(&cuTensorMapEncodeTiled);
  *q = cudaDriverEntryPointSuccess;
  return *fn ? 0 : 1;
}
