// flash_decode: one-token attention over a KV cache with a per-row valid
// prefix kv_len[b], GQA (q-head h reads kv-head h / (Hq/Hkv)).
//
// Replaces the Pallas TPU kernel `flash_decode_pallas`
// (src/repro/kernels/flash_decode/kernel.py:62, body `_decode_kernel` :29),
// whose grid walks cache chunks per (batch, q-head) and skips chunks past
// kv_len.  The function on the serving path is the model's
// `layers.decode_attention` (src/repro/models/layers.py:139), and this
// kernel follows its rounding points, not `flash_decode_ref`'s:
//   q * scale is rounded to the cache's type; scores are float32 sums of
//   products of cache-typed values; the softmax is float32 and is
//   normalised before P.V; p is rounded to the cache's type; P.V sums in
//   float32; the output is cast to q's type.
// In float32 every rounding is the identity, so there it is also exactly
// the function of `flash_decode_ref` and the Pallas kernel.
//
// Design: one CTA per (batch row, kv-head) computes the whole group of
// q-heads that shares the kv-head, so each K and V row is read once for
// the group.  Only positions s < kv_len are read.  Because p is
// normalised before it is rounded, the softmax needs its max and sum
// before P.V: the scores of the group live in shared memory
// ([group, S] float32; the wrapper refuses caches that do not fit), one
// warp per cache position computes them (lanes split D, the group's dot
// products share each K load), one warp per head takes max, exp, sum and
// the normalised rounded p, and one thread per (head, d) sums P.V along
// the cache, reading V rows coalesced.  kv_len is clamped to [0, S]; a
// row with kv_len 0 gets zeros (the serving path always has kv_len >= 1).
//
// Bound on the card: bytes.  It reads the valid prefix of K and V once:
// 2 * sizeof(T) * D * Hkv * sum_b(kv_len[b]) bytes, plus q and the output.
// Its flops (4 * Hq * D per position) are ~1 per byte read, far below the
// card's ratio.
#include "common.cuh"

#define DEC_THREADS 256
#define DEC_WARPS (DEC_THREADS / 32)
#define DEC_MAX_GROUP 8

namespace {

template <typename T>
__global__ void decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int32_t* __restrict__ kv_len,
                              T* __restrict__ out, int Hq, int Hkv, int S,
                              int D, float scale) {
  extern __shared__ float smem[];
  const int group = Hq / Hkv;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = min(max(kv_len[b], 0), S);
  float* sc = smem;                    // [group, S] scores, then p
  float* qs = smem + group * S;        // [group, D] rounded q * scale
  const long long head0 = static_cast<long long>(b) * Hq + kvh * group;
  for (int i = threadIdx.x; i < group * D; i += DEC_THREADS) {
    qs[i] = round_to<T>(to_f32(q[head0 * D + i]) * scale);
  }
  __syncthreads();

  const long long base = (static_cast<long long>(b) * Hkv + kvh) * S * D;
  const T* kb = k + base;
  const T* vb = v + base;
  for (int s = warp; s < n; s += DEC_WARPS) {
    float acc[DEC_MAX_GROUP];
#pragma unroll
    for (int g = 0; g < DEC_MAX_GROUP; ++g) acc[g] = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float kv = to_f32(kb[static_cast<long long>(s) * D + d]);
#pragma unroll
      for (int g = 0; g < DEC_MAX_GROUP; ++g) {
        if (g < group) acc[g] += qs[g * D + d] * kv;
      }
    }
#pragma unroll
    for (int g = 0; g < DEC_MAX_GROUP; ++g) {
      if (g < group) {
        const float t = warp_sum(acc[g]);
        if (lane == 0) sc[g * S + s] = t;
      }
    }
  }
  __syncthreads();

  for (int g = warp; g < group; g += DEC_WARPS) {
    float* row = sc + g * S;
    float m = -INFINITY;
    for (int s = lane; s < n; s += 32) m = fmaxf(m, row[s]);
    m = warp_max(m);
    float sum = 0.f;
    for (int s = lane; s < n; s += 32) {
      const float p = expf(row[s] - m);
      row[s] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int s = lane; s < n; s += 32) row[s] = round_to<T>(row[s] / sum);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < group * D; i += DEC_THREADS) {
    const int g = i / D, d = i - (i / D) * D;
    const float* p = sc + g * S;
    float acc = 0.f;
    for (int s = 0; s < n; ++s) {
      acc += p[s] * to_f32(vb[static_cast<long long>(s) * D + d]);
    }
    out[head0 * D + i] = to_store<T>(acc);
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v,
                 const void* kv_len, void* out, int B, int Hq, int Hkv, int S,
                 int D, float scale, cudaStream_t s) {
  const size_t smem = sizeof(float) * static_cast<size_t>(Hq / Hkv)
      * (static_cast<size_t>(S) + D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_kernel<T><<<B * Hkv, DEC_THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(kv_len),
      static_cast<T*>(out), Hq, Hkv, S, D, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Hq, D], k/v [B, Hkv, S, D] (float32 or bfloat16 by `dtype`, all
// one type), kv_len [B] int32, out [B, Hq, D] of q's type;
// Hq % Hkv == 0, Hq / Hkv <= DEC_MAX_GROUP.
REPRO_EXPORT int flash_decode_launch(const void* q, const void* k,
                                     const void* v, const void* kv_len,
                                     void* out, int B, int Hq, int Hkv,
                                     int S, int D, float scale, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > DEC_MAX_GROUP) {
    return cudaErrorInvalidValue;
  }
  if (B <= 0) return 0;
  return dtype == 0
      ? launch_typed<float>(q, k, v, kv_len, out, B, Hq, Hkv, S, D, scale, s)
      : launch_typed<__nv_bfloat16>(q, k, v, kv_len, out, B, Hq, Hkv, S, D,
                                    scale, s);
}
