// rmsnorm_bwd: the backward of `rmsnorm.cu`'s RMSNorm,
// y = x * r * w with r = 1 / sqrt(mean(x^2) + eps), float32 math.  From
// x [rows, d] and dy [rows, d] (float32 or bfloat16, one type) and w [d]
// float32 it computes, with g = dy * w,
//
//   dx = r * g - r^3 * x * mean(g * x)        (x's type)
//   dw = sum over rows of dy * x * r          (float32)
//
// Replaces no TPU kernel: the Pallas kernel (`rmsnorm_pallas`,
// src/repro/kernels/rmsnorm/kernel.py:24) is forward only, and the JAX
// package trains through the jnp form `layers.rmsnorm`
// (src/repro/models/layers.py), which jax.vjp differentiates.  This
// kernel computes that vjp on the card.
//
// Bound on the card: bytes.  It reads x and dy and writes dx once,
// 3 * rows * d * sizeof(T), plus w and dw, 8 * d, at about 10 flops an
// element.
//
// Design: two kernels in one launch call, no atomics, so a rerun is
// bitwise the same.
//   1. `rows_kernel`: n_cta CTAs of 256 threads, each taking a run of
//      `per` consecutive rows.  Per row, thread t takes the columns t,
//      t + 256, ... and sums x*x and g*x over them; the warps' sums meet
//      in shared memory behind one barrier (every thread adds the eight
//      warp sums in warp order); then it writes dx and adds
//      dy * x * r to its columns of the CTA's dw partial, a float32 row
//      in shared memory (one writer a column).  The CTA writes that
//      partial to partial[cta, :].
//   2. `dw_kernel`: a thread per column adds the n_cta partials in CTA
//      order.
// Any d up to kMaxD (the partial row's shared memory) and any rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 227 * 1024 / 4 - 2 * kWarps;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
            const T* __restrict__ dy, T* __restrict__ dx,
            float* __restrict__ partial, int rows, int d, int per,
            float eps) {
  extern __shared__ float dwp[];               // [d] this CTA's dw partial
  __shared__ float red[2][kWarps];
  const int t = threadIdx.x;
  for (int c = t; c < d; c += kThreads) dwp[c] = 0.f;
  const long long r0 = static_cast<long long>(blockIdx.x) * per;
  const long long r1 = min(r0 + per, static_cast<long long>(rows));
  for (long long r = r0; r < r1; ++r) {
    const T* xr = x + r * d;
    const T* gr = dy + r * d;
    float ss = 0.f, sg = 0.f;
    for (int c = t; c < d; c += kThreads) {
      const float xf = to_f32(xr[c]);
      ss = fmaf(xf, xf, ss);
      sg = fmaf(to_f32(gr[c]) * w[c], xf, sg);
    }
    ss = warp_sum(ss);
    sg = warp_sum(sg);
    if ((t & 31) == 0) {
      red[0][t >> 5] = ss;
      red[1][t >> 5] = sg;
    }
    __syncthreads();
    ss = 0.f;
    sg = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      ss += red[0][i];
      sg += red[1][i];
    }
    __syncthreads();                           // red is free for the next row
    const float inv = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
    const float coef = inv * inv * inv * (sg / static_cast<float>(d));
    T* dxr = dx + r * d;
    for (int c = t; c < d; c += kThreads) {
      const float xf = to_f32(xr[c]);
      const float gy = to_f32(gr[c]);
      dxr[c] = to_store<T>(inv * (gy * w[c]) - coef * xf);
      dwp[c] = fmaf(gy, xf * inv, dwp[c]);
    }
  }
  float* out = partial + static_cast<long long>(blockIdx.x) * d;
  for (int c = t; c < d; c += kThreads) out[c] = dwp[c];
}

__global__ void __launch_bounds__(kThreads)
dw_kernel(const float* __restrict__ partial, float* __restrict__ dw,
          int n_cta, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int i = 0; i < n_cta; ++i) {
    s += partial[static_cast<long long>(i) * d + c];
  }
  dw[c] = s;
}

template <typename T>
int launch_typed(const void* x, const void* w, const void* dy, void* dx,
                 float* dw, float* partial, int rows, int d, int n_cta,
                 int per, float eps, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  // above 48 KB a block's shared memory (the static `red` included) needs
  // the kernel's opt-in
  if (smem + sizeof(float) * 2 * kWarps > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_cta > 0) {
    rows_kernel<T><<<n_cta, kThreads, smem, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<const T*>(dy), static_cast<T*>(dx), partial, rows, d,
        per, eps);
  }
  dw_kernel<<<repro_cdiv(d, kThreads), kThreads, 0, s>>>(partial, dw, n_cta,
                                                         d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy, dx [rows, d] (float32 or bfloat16 by `dtype`), w [d] float32,
// dw [d] float32, partial an [n_cta, d] float32 scratch; rows run in
// n_cta CTAs of `per` consecutive rows (n_cta = cdiv(rows, per)); d <=
// kMaxD.  rows = 0 (n_cta = 0) writes dw = 0.
REPRO_EXPORT int rmsnorm_bwd_launch(const void* x, const void* w,
                                    const void* dy, void* dx, float* dw,
                                    float* partial, int rows, int d,
                                    int n_cta, int per, float eps, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0) return 0;
  if (d > kMaxD || n_cta < 0 || (n_cta > 0 && per <= 0)) {
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return launch_typed<float>(x, w, dy, dx, dw, partial, rows, d, n_cta,
                               per, eps, s);
  }
  return launch_typed<__nv_bfloat16>(x, w, dy, dx, dw, partial, rows, d,
                                     n_cta, per, eps, s);
}
