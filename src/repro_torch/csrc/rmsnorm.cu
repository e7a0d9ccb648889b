// rmsnorm: RMSNorm over the last axis, float32 math, eps 1e-6 by default:
// y = x * (1 / sqrt(mean(x^2) + eps)) * w, cast to x's type.
//
// Replaces the Pallas TPU kernel `rmsnorm_pallas`
// (src/repro/kernels/rmsnorm/kernel.py:24, body `_rmsnorm_kernel` :17),
// which tiles (8, d) rows through VMEM.  Here one CTA takes one row: each
// thread reads a strided slice of the row once (kept in registers, up to
// RMS_PER_THREAD values), the sum of squares goes through warp shuffles
// and a shared-memory pass over the warps, and each thread writes its
// slice scaled.  Rows wider than blockDim * RMS_PER_THREAD are refused by
// the wrapper.
//
// Bound on the card: bytes.  The function reads x and w once and writes
// y once: rows*d*(2*sizeof(T)) + 4*d bytes, with 3 flops per element.
// At the decode shape (4 slots x 1024, bf16) that is 20 KB, 0.006 us at
// 3.35 TB/s; at that size a launch costs more than either rate.
#include "common.cuh"

#define RMS_THREADS 256
#define RMS_PER_THREAD 16

namespace {

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ w,
                               T* __restrict__ y, int d, float eps) {
  __shared__ float partial[RMS_THREADS / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float v[RMS_PER_THREAD];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < RMS_PER_THREAD; ++k) {
    const int c = threadIdx.x + k * RMS_THREADS;
    v[k] = c < d ? to_f32(xr[c]) : 0.f;
    ss += v[k] * v[k];
  }
  ss = warp_sum(ss);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < RMS_THREADS / 32 ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) partial[0] = t;
  }
  __syncthreads();
  const float inv = 1.0f / sqrtf(partial[0] / static_cast<float>(d) + eps);
#pragma unroll
  for (int k = 0; k < RMS_PER_THREAD; ++k) {
    const int c = threadIdx.x + k * RMS_THREADS;
    if (c < d) yr[c] = to_store<T>(v[k] * inv * w[c]);
  }
}

}  // namespace

// x [rows, d] (float32 or bfloat16 by `dtype`), w [d] float32,
// y [rows, d] of x's type; d <= RMS_THREADS * RMS_PER_THREAD.
REPRO_EXPORT int rmsnorm_launch(const void* x, const void* w, void* y,
                                int rows, int d, float eps, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return 0;
  if (d > RMS_THREADS * RMS_PER_THREAD) return cudaErrorInvalidValue;
  if (dtype == 0) {
    rmsnorm_kernel<float><<<rows, RMS_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), d, eps);
  } else {
    rmsnorm_kernel<__nv_bfloat16><<<rows, RMS_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<__nv_bfloat16*>(y), d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
