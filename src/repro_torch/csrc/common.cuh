// Shared by every kernel source: the export macro and the error-string
// entry point the Python wrappers use to report a failed launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// A launch's own refusals, numbered apart from the CUDA runtime's codes
#define REPRO_ERR_ALIGN 20001     // an operand is not 16-byte aligned
#define REPRO_ERR_TMA_MAP 20002   // cuTensorMapEncodeTiled refused a map
#define REPRO_ERR_NO_TMA 20003    // the driver has no cuTensorMapEncodeTiled

REPRO_EXPORT const char* repro_error_string(int err) {
  switch (err) {
    case REPRO_ERR_ALIGN: return "an operand is not 16-byte aligned";
    case REPRO_ERR_TMA_MAP: return "a TMA tensor map was refused";
    case REPRO_ERR_NO_TMA: return "no cuTensorMapEncodeTiled in the driver";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

static inline int repro_cdiv(long long a, int b) {
  return static_cast<int>((a + b - 1) / b);
}

// Float kernels take float32 or bfloat16 storage, selected by a code the
// wrapper passes (kernels/common.py FLOAT_CODES): 0 float32, 1 bfloat16.
// All arithmetic is float32; `to_store` rounds to nearest even, as
// PyTorch's and XLA's casts do.
#include <cuda_bf16.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T to_store(float x);
template <>
__device__ __forceinline__ float to_store<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_store<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to storage type T and back: the value a cast to T keeps
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(to_store<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
