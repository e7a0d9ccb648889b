// rmsnorm: RMSNorm over the last axis, float32 math, eps 1e-6 by default:
// y = x * (1 / sqrt(mean(x^2) + eps)) * w, cast to x's type.
//
// Replaces the Pallas TPU kernel `rmsnorm_pallas`
// (src/repro/kernels/rmsnorm/kernel.py:24, body `_rmsnorm_kernel` :16),
// which tiles (8, d) rows through VMEM.
//
// Bound on the card: bytes.  The function reads x and w once and writes
// y once: rows*d*(2*sizeof(T)) + 4*d bytes, with 3 flops per element.
// At the decode shape (4 slots x 1024, bf16) that is 20 KB, 0.006 us at
// 3.35 TB/s; a launch costs far more, so the design keeps the chain of
// dependent steps inside the launch short:
//   * One memory trip.  Each thread issues all of its x loads and the
//     matching w loads before the reduction, so no dependent second trip
//     for w follows it.
//   * 16-byte units.  Where d*sizeof(T) % 16 == 0 and x, w and y are
//     16-byte aligned (the launcher checks; a contiguous view keeps its
//     storage offset), x and y move as 16-byte units (8 bf16 or 4 f32)
//     and w as float4.  Otherwise the launcher takes the scalar instance
//     of the same kernel, units of one element.
//   * One CTA a row.  While the row fits in a warp's registers (at most
//     256 units: d <= 2048 bf16, 1024 f32, 256 scalar) the CTA is one
//     warp and the sum is warp shuffles only: no shared memory and no
//     barrier.  A decode step's 4 rows spread over 4 SMs and a prefill's
//     256 rows over all of them; each warp reads its own copy of w, so 4
//     rows in one CTA of 4 warps pulled 4x the bytes through one SM and
//     took 1.86 us against 1.79 us at the decode shape, 2.05 against
//     1.98 at the prefill one (H100 SXM, 700 W).
//   * Wider rows take a CTA of up to 512 threads, each holding up to 4
//     units in registers; the warps' sums meet in one shared-memory pass
//     behind one barrier.  Units past the CTA's registers (d > 16384
//     bf16, 8192 f32, 2048 scalar) are summed as they stream in and read a
//     second time, from L2, to be written.  No d is refused.
//
// Order of the float32 sum of squares: each thread adds x*x (fmaf) over
// its units in order (the units it keeps, then the streamed ones) and
// over a unit's elements in order; the warp adds its 32 lanes by an xor
// butterfly (offsets 16, 8, 4, 2, 1); with a CTA a row, every thread then
// adds the warps' sums in warp order.  The plain version sums in
// PyTorch's order; the two stay within cases.TOL.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarpUnits = 256;    // most units a one-warp CTA's row holds
constexpr int kWideThreads = 512;  // most threads of a wider row's CTA
constexpr int kWidePer = 4;        // units a thread keeps there

// A unit of x as it sits in registers: 16 raw bytes, or one element.
template <typename T, int VEC>
using Raw = typename std::conditional<VEC == 1, T, uint4>::type;

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> load_unit(const T* p) {
  if constexpr (VEC == 1) {
    return *p;
  } else {
    return *reinterpret_cast<const uint4*>(p);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Raw<T, VEC>& r,
                                       float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = to_f32(r);
  } else {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (std::is_same<T, float>::value) {
        f[j] = __uint_as_float(w[j]);
      } else {  // two bf16 a word, the lower address in the low half
        f[2 * j] = __uint_as_float(w[j] << 16);
        f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    }
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));
}

template <typename T, int VEC>
__device__ __forceinline__ void store_unit(T* p, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    *p = to_store<T>(f[0]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (std::is_same<T, float>::value) {
        w[j] = __float_as_uint(f[j]);
      } else {
        w[j] = bf16_bits(f[2 * j]) | (bf16_bits(f[2 * j + 1]) << 16);
      }
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <int VEC>
__device__ __forceinline__ void load_w(const float* p, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = *p;
  } else {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      f[4 * q] = v.x;
      f[4 * q + 1] = v.y;
      f[4 * q + 2] = v.z;
      f[4 * q + 3] = v.w;
    }
  }
}

// Row blockIdx.x in units of VEC elements (16 bytes, or one element when
// VEC == 1).  With ONE_WARP the CTA is one warp and the row has at most
// 32*PER units.  Thread t of the CTA's nt threads keeps units t + i*nt,
// i < PER, and streams the rest.
template <typename T, int VEC, int PER, bool ONE_WARP>
__global__ void __launch_bounds__(ONE_WARP ? 32 : kWideThreads)
rmsnorm_rows_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    T* __restrict__ y, int d, float eps) {
  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = ONE_WARP ? 32 : blockDim.x;
  const int units = d / VEC;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  Raw<T, VEC> raw[PER];
  float wv[PER][VEC];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int u = t + i * nt;
    if (u < units) {
      raw[i] = load_unit<T, VEC>(xr + u * VEC);
      load_w<VEC>(w + u * VEC, wv[i]);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (t + i * nt < units) {
      float f[VEC];
      unpack<T, VEC>(raw[i], f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) ss = fmaf(f[j], f[j], ss);
    }
  }
  if constexpr (!ONE_WARP) {
    for (int u = t + PER * nt; u < units; u += nt) {
      float f[VEC];
      unpack<T, VEC>(load_unit<T, VEC>(xr + u * VEC), f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) ss = fmaf(f[j], f[j], ss);
    }
  }
  ss = warp_sum(ss);
  if constexpr (!ONE_WARP) {
    __shared__ float partial[kWideThreads / 32];
    if ((t & 31) == 0) partial[t >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int i = 0; i < (nt >> 5); ++i) ss += partial[i];
  }
  const float inv = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int u = t + i * nt;
    if (u < units) {
      float f[VEC];
      unpack<T, VEC>(raw[i], f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = f[j] * inv * wv[i][j];
      store_unit<T, VEC>(yr + u * VEC, f);
    }
  }
  if constexpr (!ONE_WARP) {
    for (int u = t + PER * nt; u < units; u += nt) {
      float f[VEC], g[VEC];
      unpack<T, VEC>(load_unit<T, VEC>(xr + u * VEC), f);
      load_w<VEC>(w + u * VEC, g);
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = f[j] * inv * g[j];
      store_unit<T, VEC>(yr + u * VEC, f);
    }
  }
}

template <typename T, int VEC>
void launch_rows(const T* x, const float* w, T* y, int rows, int d,
                 float eps, cudaStream_t s) {
  const int units = d / VEC;
  if (units <= 32) {
    rmsnorm_rows_kernel<T, VEC, 1, true><<<rows, 32, 0, s>>>(x, w, y, d, eps);
  } else if (units <= 64) {
    rmsnorm_rows_kernel<T, VEC, 2, true><<<rows, 32, 0, s>>>(x, w, y, d, eps);
  } else if (units <= 128) {
    rmsnorm_rows_kernel<T, VEC, 4, true><<<rows, 32, 0, s>>>(x, w, y, d, eps);
  } else if (units <= kWarpUnits) {
    rmsnorm_rows_kernel<T, VEC, 8, true><<<rows, 32, 0, s>>>(x, w, y, d, eps);
  } else {
    const int want = repro_cdiv(repro_cdiv(units, kWidePer), 32) * 32;
    const int threads = want < kWideThreads ? want : kWideThreads;
    rmsnorm_rows_kernel<T, VEC, kWidePer, false><<<rows, threads, 0, s>>>(
        x, w, y, d, eps);
  }
}

template <typename T>
void launch_typed(const void* x, const void* w, void* y, int rows, int d,
                  float eps, cudaStream_t s) {
  const bool vec =
      (static_cast<long long>(d) * sizeof(T)) % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  T* yt = static_cast<T*>(y);
  if (vec) {
    constexpr int kVec = static_cast<int>(16 / sizeof(T));
    launch_rows<T, kVec>(xt, wt, yt, rows, d, eps, s);
  } else {
    launch_rows<T, 1>(xt, wt, yt, rows, d, eps, s);
  }
}

}  // namespace

// x [rows, d] (float32 or bfloat16 by `dtype`), w [d] float32,
// y [rows, d] of x's type; any d >= 1.
REPRO_EXPORT int rmsnorm_launch(const void* x, const void* w, void* y,
                                int rows, int d, float eps, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return 0;
  if (dtype == 0) {
    launch_typed<float>(x, w, y, rows, d, eps, s);
  } else {
    launch_typed<__nv_bfloat16>(x, w, y, rows, d, eps, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel, one CTA of 32 threads: the launch floor against which
// chip_smoke.py reads the serving kernels' device times.
__global__ void repro_empty_kernel() {}

REPRO_EXPORT int repro_empty_launch(void* stream) {
  repro_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
