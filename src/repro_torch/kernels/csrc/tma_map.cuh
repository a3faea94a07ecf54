// Tensor maps for TMA loads, encoded on the host before each launch
// (flash_attention.cu, flash_attention_bwd.cu, decode_attention.cu).
//
// cuTensorMapEncodeTiled lives in libcuda: it is reached through the
// runtime's entry-point query, so no library links libcuda.  A map here
// is 3-D over a contiguous [heads, rows, D] tensor (the head dim
// innermost), read in boxes of 128-byte rows in the 128-byte swizzle:
// row r's 16-byte chunk c lands at chunk c ^ (r % 8) of its row, so a box
// wants a 1024-aligned destination.  Elements outside the tensor (columns
// at or past D, rows at or past `rows`) load as zeros.

#pragma once

#include <cuda.h>                       // CUtensorMap and its enums (no -lcuda)
#include <cuda_runtime.h>

namespace tma_map {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once a process; null where the entry
// point is not found
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                                                     : nullptr;
  }();
  return fn;
}

// a map of the [heads, rows, D] tensor at `base` of `elt`-byte elements
// (2: bf16, 4: fp32), boxes of box_cols columns (box_cols * elt = 128
// bytes) x box_rows rows x 1 head
inline int make_3d(CUtensorMap* map, const void* base, int elt, int D, int rows, int heads,
                   int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * elt, (cuuint64_t)rows * D * elt};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, elt == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            3, const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace tma_map
