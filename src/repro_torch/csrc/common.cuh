// Shared by every kernel source: the export macro and the error-string
// entry point the Python wrappers use to report a failed launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

static inline int repro_cdiv(long long a, int b) {
  return static_cast<int>((a + b - 1) / b);
}
