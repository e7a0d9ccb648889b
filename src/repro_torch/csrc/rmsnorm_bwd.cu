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
// element: 6.3 MB at the training shape (1024 x 1024 bf16), 1.9 us at
// 3.35 TB/s.
//
// Design: one read of x and dy, and no float atomics, so a rerun is
// bitwise the same.  Two kernels:
//   1. Rows: n_cta CTAs of 8 warps (the wrapper's BWD_CTAS, one an SM of
//      the H100, fewer for few rows); CTA i takes `per` consecutive rows
//      and writes its dw row, partial[i, :].  Where a row is a whole
//      number of 16-byte units and fits a warp's registers (at most 256
//      units: d <= 2048 bf16, 1024 f32; the training width 1024 is 128
//      units), `warp_rows_kernel`: one warp a row (the CTA's warps take
//      its rows in turn).  Each lane loads its units of x and dy once
//      (16-byte loads) and keeps them in registers, the two row sums (x*x
//      and g*x) are warp shuffles (no block barrier), dx is written from
//      the registers, and dy * x * r is added into the lane's float32 dw
//      registers, row after row; the CTA adds its warps' dw in warp order
//      through shared memory.  Other rows (odd widths, off-16-byte rows,
//      d past the registers up to kMaxD) take `cta_rows_kernel`: the
//      whole CTA on one row at a time, thread t on columns t, t + 256,
//      ..., the warps' sums meeting in shared memory, dw in a
//      shared-memory row (one writer a column).
//   2. `dw_kernel`: dw spread over cdiv(d, 8) CTAs, one 8-column slice
//      each; lane l of warp w reads column l % 8 of the partials g, g +
//      32, ... (g = 4w + l / 8: 32 groups, each lane's loads all in
//      flight), the warp adds its four groups by shuffles (xor 8, then
//      16) and warp 0 adds the eight warp sums in warp order.  At the
//      training shape: 128 partial rows of 4 KB, read from L2 by 128
//      CTAs, 4 loads a thread.
// Measured at the training shape on the H100 (700 W), one launch with a
// grid barrier in place of the second kernel took 6.9-7.1 us, these two
// launches 6.2-6.6 us (`F.rms_norm`'s backward 7.5).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 227 * 1024 / 4 - 2 * kWarps;
constexpr int kWarpUnits = 256;    // most 16-byte units a warp's row holds

// Step 2 of the note: dw from the n partial rows.
__global__ void __launch_bounds__(kThreads)
dw_kernel(const float* __restrict__ partial, float* __restrict__ dw, int d,
          int n) {
  __shared__ float red[kWarps][8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 8 + (lane & 7);
  const int g = warp * 4 + (lane >> 3);
  float s = 0.f;
  if (c < d) {
#pragma unroll 8
    for (int p = g; p < n; p += 32) {
      s += partial[static_cast<long long>(p) * d + c];
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 8);
  s += __shfl_xor_sync(0xffffffffu, s, 16);
  if (lane < 8) red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && lane < 8 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w][lane];
    dw[c] = t;
  }
}

template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));   // elements a unit

template <typename T>
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[kVec<T>]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (kVec<T> == 4) {
      f[j] = __uint_as_float(w[j]);
    } else {  // two bf16 a word, the lower address in the low half
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&f)[kVec<T>]) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (kVec<T> == 4) {
      w[j] = __float_as_uint(f[j]);
    } else {
      const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      w[j] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// w for unit `idx`: kVec float32 from a 16-byte-aligned w
template <typename T>
__device__ __forceinline__ void load_w(const float* __restrict__ w, int idx,
                                       float (&f)[kVec<T>]) {
#pragma unroll
  for (int j = 0; j < kVec<T>; j += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(w) +
                           (idx * kVec<T> + j) / 4);
    f[j] = v.x;
    f[j + 1] = v.y;
    f[j + 2] = v.z;
    f[j + 3] = v.w;
  }
}

// A warp a row; lane l holds units l, l + 32, ..., NU of them at most.
template <typename T, int NU>
__global__ void __launch_bounds__(kThreads)
warp_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 const T* __restrict__ dy, T* __restrict__ dx,
                 float* __restrict__ partial, int rows, int d, int per,
                 float eps) {
  constexpr int V = kVec<T>;
  extern __shared__ float sdw[];               // [kWarps][d]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int units = d / V;
  float acc[NU][V];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
#pragma unroll
    for (int e = 0; e < V; ++e) acc[u][e] = 0.f;
  }
  const long long r0 = static_cast<long long>(blockIdx.x) * per;
  const long long r1 = min(r0 + per, static_cast<long long>(rows));
  for (long long r = r0 + warp; r < r1; r += kWarps) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + r * d);
    const uint4* gr = reinterpret_cast<const uint4*>(dy + r * d);
    uint4 xv[NU], gv[NU];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int idx = lane + 32 * u;
      if (idx < units) {
        xv[u] = xr[idx];
        gv[u] = gr[idx];
      }
    }
    float ss = 0.f, sg = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int idx = lane + 32 * u;
      if (idx < units) {
        float xf[V], gf[V], wf[V];
        unpack<T>(xv[u], xf);
        unpack<T>(gv[u], gf);
        load_w<T>(w, idx, wf);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          ss = fmaf(xf[e], xf[e], ss);
          sg = fmaf(gf[e] * wf[e], xf[e], sg);
        }
      }
    }
    ss = warp_sum(ss);
    sg = warp_sum(sg);
    const float inv = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
    const float coef = inv * inv * inv * (sg / static_cast<float>(d));
    uint4* dxr = reinterpret_cast<uint4*>(dx + r * d);
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int idx = lane + 32 * u;
      if (idx < units) {
        float xf[V], gf[V], wf[V], out[V];
        unpack<T>(xv[u], xf);
        unpack<T>(gv[u], gf);
        load_w<T>(w, idx, wf);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          out[e] = inv * (gf[e] * wf[e]) - coef * xf[e];
          acc[u][e] = fmaf(gf[e], xf[e] * inv, acc[u][e]);
        }
        dxr[idx] = pack<T>(out);
      }
    }
  }
  // the CTA's dw: its warps' rows added in warp order
  float4* mine = reinterpret_cast<float4*>(sdw + warp * d);
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int idx = lane + 32 * u;
    if (idx < units) {
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        mine[(idx * V + e) / 4] =
            make_float4(acc[u][e], acc[u][e + 1], acc[u][e + 2],
                        acc[u][e + 3]);
      }
    }
  }
  __syncthreads();
  float* out = partial + static_cast<long long>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += sdw[i * d + c];
    out[c] = s;
  }
}

// A CTA a row, element by element: any d up to kMaxD, any alignment.
template <typename T>
__global__ void __launch_bounds__(kThreads)
cta_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const T* __restrict__ dy, T* __restrict__ dx,
                float* __restrict__ partial, int rows, int d, int per,
                float eps) {
  extern __shared__ float dwp[];               // [d] this CTA's dw row
  __shared__ float sums[2][kWarps];
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
      sums[0][t >> 5] = ss;
      sums[1][t >> 5] = sg;
    }
    __syncthreads();
    ss = 0.f;
    sg = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      ss += sums[0][i];
      sg += sums[1][i];
    }
    __syncthreads();                           // sums is free for the next row
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the rows kernel with `smem` bytes of dynamic shared memory over n_cta
// CTAs, then dw_kernel
template <typename T, typename K>
int launch(K kernel, size_t smem, int n_cta, cudaStream_t s, const T* x,
           const float* w, const T* dy, T* dx, float* dw, float* partial,
           int rows, int d, int per, float eps) {
  if (smem + 2048 > 48 * 1024) {   // with the static shared arrays
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_cta, kThreads, smem, s>>>(x, w, dy, dx, partial, rows, d, per,
                                       eps);
  dw_kernel<<<repro_cdiv(d, 8), kThreads, 0, s>>>(partial, dw, d, n_cta);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* xv, const float* w, const void* dyv, void* dxv,
                 float* dw, float* partial, int rows, int d, int n_cta,
                 int per, float eps, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* dy = static_cast<const T*>(dyv);
  T* dx = static_cast<T*>(dxv);
  const int units = d / kVec<T>;
  const bool vec = d % kVec<T> == 0 && units <= kWarpUnits && aligned16(x) &&
                   aligned16(dy) && aligned16(dx) && aligned16(w);
  if (!vec) {
    return launch(cta_rows_kernel<T>, sizeof(float) * d, n_cta, s, x, w, dy,
                  dx, dw, partial, rows, d, per, eps);
  }
  const size_t smem = sizeof(float) * kWarps * d;
  if (units <= 32) {
    return launch(warp_rows_kernel<T, 1>, smem, n_cta, s, x, w, dy, dx, dw,
                  partial, rows, d, per, eps);
  }
  if (units <= 64) {
    return launch(warp_rows_kernel<T, 2>, smem, n_cta, s, x, w, dy, dx, dw,
                  partial, rows, d, per, eps);
  }
  if (units <= 128) {
    return launch(warp_rows_kernel<T, 4>, smem, n_cta, s, x, w, dy, dx, dw,
                  partial, rows, d, per, eps);
  }
  return launch(warp_rows_kernel<T, 8>, smem, n_cta, s, x, w, dy, dx, dw,
                partial, rows, d, per, eps);
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
  if (n_cta == 0) {
    cudaMemsetAsync(dw, 0, sizeof(float) * d, s);
    return static_cast<int>(cudaGetLastError());
  }
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0) {
    return launch_typed<float>(x, wf, dy, dx, dw, partial, rows, d, n_cta,
                               per, eps, s);
  }
  return launch_typed<__nv_bfloat16>(x, wf, dy, dx, dw, partial, rows, d,
                                     n_cta, per, eps, s);
}
