// flash_attention: causal GQA attention forward over one sequence,
// q [B, Hq, S, D] against k/v [B, Hkv, S, D], online softmax in float32
// with masked scores at -1e30, output acc / max(l, 1e-30) in q's type.
// q-head h reads kv-head h / (Hq/Hkv).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py:72, body `_flash_kernel`
// :27).  That kernel carries (m, l, acc) in VMEM scratch across a
// sequential kv grid axis and asserts S % block == 0.  Blocks on Hopper
// run in no order, so here the kv loop is inside the CTA:
//   * one CTA per (q block of 64 rows, batch * q-head), one thread per q
//     row, holding q * scale and its float32 accumulator in registers;
//   * K and V tiles of 64 rows are staged through shared memory as
//     float32 (each thread then reads the same K/V row: a broadcast);
//   * the kv loop stops at the block's diagonal; within a tile each
//     row takes its columns in chunks of 16: 16 scores, one max, one
//     rescale of the accumulator, 16 p*V updates;
//   * any S: the last q block and the last kv tile are masked, rows past
//     S compute nothing and write nothing.
// D is a template parameter (16 and 64: granite's SMOKE and full width).
// This is the simple form of the kernel: CUDA-core float32 math, no
// tensor cores; `wgmma` and TMA are later work.
//
// Bound on the card: operations at long S, bytes at short S.  The
// function needs 4 * D flops per (row, visible column) pair,
// 4*D*B*Hq*S(S+1)/2, against 989 TFLOP/s (bf16 tensor cores), and reads
// q, k, v and writes o once.
#include "common.cuh"

#define FA_BQ 64
#define FA_BK 64
#define FA_CH 16
#define FA_NEG_INF (-1e30f)

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(FA_BQ)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
             int S, float scale) {
  __shared__ float ks[FA_BK][D];
  __shared__ float vs[FA_BK][D];
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int row0 = blockIdx.x * FA_BQ;
  const int row = row0 + threadIdx.x;
  const bool active = row < S;
  const long long qbase = static_cast<long long>(bh) * S * D;
  const long long kvbase = (static_cast<long long>(b) * Hkv + kvh) * S * D;

  float qr[D], acc[D];
  float m = FA_NEG_INF, l = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? to_f32(q[qbase + static_cast<long long>(row) * D + d])
        * scale : 0.f;
    acc[d] = 0.f;
  }
  const int last = min(row0 + FA_BQ - 1, S - 1);
  for (int t0 = 0; t0 <= last; t0 += FA_BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < FA_BK * D; i += FA_BQ) {
      const int r = i / D, d = i - (i / D) * D;
      const bool in = t0 + r < S;
      const long long off = kvbase + static_cast<long long>(t0 + r) * D + d;
      ks[r][d] = in ? to_f32(k[off]) : 0.f;
      vs[r][d] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    const int limit = min(min(FA_BK, S - t0), row - t0 + 1);
    for (int c = 0; c < limit; c += FA_CH) {
      float s[FA_CH];
      float mc = FA_NEG_INF;
#pragma unroll
      for (int j = 0; j < FA_CH; ++j) {
        float dot = FA_NEG_INF;
        if (c + j < limit) {
          dot = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) dot += qr[d] * ks[c + j][d];
        }
        s[j] = dot;
        mc = fmaxf(mc, dot);
      }
      const float m_new = fmaxf(m, mc);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < FA_CH; ++j) {
        if (c + j < limit) {
          const float p = expf(s[j] - m_new);
          l += p;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] += p * vs[c + j][d];
        }
      }
      m = m_new;
    }
  }
  if (active) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    T* orow = o + qbase + static_cast<long long>(row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = to_store<T>(acc[d] * inv);
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int S, int D, float scale, cudaStream_t s) {
  const dim3 grid(repro_cdiv(S, FA_BQ), B * Hq);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if (D == 64) {
    flash_kernel<T, 64><<<grid, FA_BQ, 0, s>>>(qp, kp, vp, op, Hq, Hkv, S,
                                               scale);
  } else if (D == 16) {
    flash_kernel<T, 16><<<grid, FA_BQ, 0, s>>>(qp, kp, vp, op, Hq, Hkv, S,
                                               scale);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Hq, S, D], k/v [B, Hkv, S, D] (float32 or bfloat16 by `dtype`,
// all one type), o [B, Hq, S, D]; Hq % Hkv == 0; D in {16, 64}.
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k,
                                        const void* v, void* o, int B,
                                        int Hq, int Hkv, int S, int D,
                                        float scale, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  if (B <= 0 || S <= 0) return 0;
  return dtype == 0
      ? launch_typed<float>(q, k, v, o, B, Hq, Hkv, S, D, scale, s)
      : launch_typed<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, D, scale, s);
}
