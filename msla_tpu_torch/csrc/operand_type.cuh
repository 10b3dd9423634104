// The operand type T of a kernel that computes in fp32 whatever T is (float,
// or __nv_bfloat16 for the bf16 compute_dtype): reading a T as fp32, writing
// fp32 as a T, and rounding fp32 to the value a T would hold.
// Used by conv_stem.cu, deconv_stem.cu and flash_attn.cu.
#pragma once

#include <cuda_bf16.h>

namespace operand_type {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// fp32 to T, round to nearest even
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v as a T would hold it, back in fp32: v itself for float
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

}  // namespace operand_type
