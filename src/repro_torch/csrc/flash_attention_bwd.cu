// flash_attention_bwd: the backward of the causal GQA attention of
// `flash_attention.cu`.  From q [B, Hq, S, D], k/v [B, Hkv, S, D], the
// forward's output o and its row log-sum-exp lse [B, Hq, S] (float32,
// the training instance `flash_attention_lse_launch`) and the output's
// cotangent dO, it computes dQ, dK and dV in the inputs' type, with
// float32 arithmetic throughout:
//
//   P  = exp(scale * q.k^T - lse)      (causal: column j <= row i)
//   dV = P^T . dO            summed over the q heads of each kv head
//   dP = dO . v^T
//   dS = P * (dP - Di),      Di = rowsum(dO * o)
//   dQ = scale * dS . k,     dK = scale * dS^T . q   (summed as dV)
//
// Replaces no TPU kernel: the Pallas kernel (`flash_attention_pallas`,
// src/repro/kernels/flash_attention/kernel.py:72) is forward only, and
// the JAX package trains through the jnp form `blockwise_attention`
// (src/repro/models/layers.py), which jax.vjp differentiates.  This
// kernel computes that vjp on the card.
//
// Bound on the card: operations at the training shapes.  The backward
// needs 2.5 times the forward's causal matmul flops (five products of
// the forward's two sizes against its two), 10 * D flops per (row,
// visible column) pair, against 989 TFLOP/s bf16; it reads q, k, v, o,
// dO and lse and writes dQ, dK, dV once.
//
// Design (FlashAttention-2's backward, on CUDA cores; `wgmma` and TMA
// are later work).  Three kernels in one launch call, each a fixed order
// of float32 sums and no atomics, so a rerun is bitwise the same:
//   1. `delta_kernel`: Di, one warp a row.
//   2. `dkdv_kernel`: one CTA of 64 threads per (64-row kv tile, batch *
//      kv head), a thread per kv row, holding its dK and dV rows in
//      registers.  Its k and v rows sit in shared memory with rows
//      padded to D + 1 floats, so the 32 threads of a warp read 32
//      different banks.  The CTA walks the group's q heads in order and,
//      for each, the q rows from the tile's first row on (the causal
//      mask skips the rows above it), 16 rows at a time staged as float32
//      (q, dO, lse, Di; every thread reads the same row: a broadcast).
//      GQA's sum over the group's heads happens in the registers.
//   3. `dq_kernel`: one CTA of 64 threads per (64-row q tile, batch * q
//      head), a thread per q row with its dQ row in registers and its q
//      and dO rows in padded shared memory; it walks the kv rows up to
//      the tile's diagonal, 16 at a time.
// Any S is taken: rows and columns past S are masked (zero-filled tiles,
// inactive threads).
#include "common.cuh"

#define FB_T 64     // kv rows a dK/dV CTA, q rows a dQ CTA (one a thread)
#define FB_STEP 16  // rows staged per step of either walk

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, long long rows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) {
    s = fmaf(to_f32(dout[row * D + d]), to_f32(o[row * D + d]), s);
  }
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

template <typename T, int D>
__global__ void __launch_bounds__(FB_T)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int S,
            float scale) {
  __shared__ float ks[FB_T][D + 1];
  __shared__ float vs[FB_T][D + 1];
  __shared__ float qs[FB_STEP][D];
  __shared__ float dos[FB_STEP][D];
  __shared__ float ls[FB_STEP];
  __shared__ float dl[FB_STEP];
  const int tid = threadIdx.x;
  const int bkv = blockIdx.y;                  // b * Hkv + kv head
  const int b = bkv / Hkv, kvh = bkv - b * Hkv;
  const int group = Hq / Hkv;
  const int j0 = blockIdx.x * FB_T;
  const int j = j0 + tid;
  const bool active = j < S;
  const long long kvbase = static_cast<long long>(bkv) * S * D;

  for (int i = tid; i < FB_T * D; i += FB_T) {
    const int r = i / D, d = i - (i / D) * D;
    const bool in = j0 + r < S;
    const long long off = kvbase + static_cast<long long>(j0 + r) * D + d;
    ks[r][d] = in ? to_f32(k[off]) : 0.f;
    vs[r][d] = in ? to_f32(v[off]) : 0.f;
  }
  float dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dka[d] = 0.f;
    dva[d] = 0.f;
  }
  for (int g = 0; g < group; ++g) {
    const long long hrow =
        (static_cast<long long>(b) * Hq + kvh * group + g) * S;
    for (int i0 = j0; i0 < S; i0 += FB_STEP) {
      __syncthreads();   // the last step's rows are read; ks/vs are in
      for (int t = tid; t < FB_STEP * D; t += FB_T) {
        const int r = t / D, d = t - (t / D) * D;
        const bool in = i0 + r < S;
        const long long off = (hrow + i0 + r) * D + d;
        qs[r][d] = in ? to_f32(q[off]) : 0.f;
        dos[r][d] = in ? to_f32(dout[off]) : 0.f;
      }
      if (tid < FB_STEP) {
        const bool in = i0 + tid < S;
        ls[tid] = in ? lse[hrow + i0 + tid] : 0.f;
        dl[tid] = in ? delta[hrow + i0 + tid] : 0.f;
      }
      __syncthreads();
      if (!active) continue;
      const int rows = min(FB_STEP, S - i0);
      for (int r = 0; r < rows; ++r) {
        if (i0 + r < j) continue;              // causal: row i >= column j
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          s = fmaf(qs[r][d], ks[tid][d], s);
          dp = fmaf(dos[r][d], vs[tid][d], dp);
        }
        const float p = expf(s * scale - ls[r]);
        const float ds = p * (dp - dl[r]);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dva[d] = fmaf(p, dos[r][d], dva[d]);
          dka[d] = fmaf(ds, qs[r][d], dka[d]);
        }
      }
    }
  }
  if (active) {
    const long long off = kvbase + static_cast<long long>(j) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[off + d] = to_store<T>(dka[d] * scale);
      dv[off + d] = to_store<T>(dva[d]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(FB_T)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int Hq, int Hkv, int S, float scale) {
  __shared__ float qs[FB_T][D + 1];
  __shared__ float dos[FB_T][D + 1];
  __shared__ float ks[FB_STEP][D];
  __shared__ float vs[FB_STEP][D];
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;                   // b * Hq + q head
  const int b = bh / Hq, h = bh - b * Hq;
  const long long kvbase =
      (static_cast<long long>(b) * Hkv + h / (Hq / Hkv)) * S * D;
  const long long qbase = static_cast<long long>(bh) * S * D;
  const int i0 = blockIdx.x * FB_T;
  const int i = i0 + tid;
  const bool active = i < S;

  for (int t = tid; t < FB_T * D; t += FB_T) {
    const int r = t / D, d = t - (t / D) * D;
    const bool in = i0 + r < S;
    const long long off = qbase + static_cast<long long>(i0 + r) * D + d;
    qs[r][d] = in ? to_f32(q[off]) : 0.f;
    dos[r][d] = in ? to_f32(dout[off]) : 0.f;
  }
  const float my_lse = active ? lse[static_cast<long long>(bh) * S + i] : 0.f;
  const float my_dl = active ? delta[static_cast<long long>(bh) * S + i]
                             : 0.f;
  float dqa[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dqa[d] = 0.f;
  const int last = min(i0 + FB_T - 1, S - 1);
  for (int t0 = 0; t0 <= last; t0 += FB_STEP) {
    __syncthreads();     // q/dO are in; the last step's k/v rows are read
    for (int t = tid; t < FB_STEP * D; t += FB_T) {
      const int r = t / D, d = t - (t / D) * D;
      const bool in = t0 + r < S;
      const long long off = kvbase + static_cast<long long>(t0 + r) * D + d;
      ks[r][d] = in ? to_f32(k[off]) : 0.f;
      vs[r][d] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    const int cols = min(FB_STEP, i - t0 + 1);  // causal; i < S bounds it
    for (int c = 0; c < cols; ++c) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[tid][d], ks[c][d], s);
        dp = fmaf(dos[tid][d], vs[c][d], dp);
      }
      const float p = expf(s * scale - my_lse);
      const float ds = p * (dp - my_dl);
#pragma unroll
      for (int d = 0; d < D; ++d) dqa[d] = fmaf(ds, ks[c][d], dqa[d]);
    }
  }
  if (active) {
    const long long off = qbase + static_cast<long long>(i) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) dq[off + d] = to_store<T>(dqa[d] * scale);
  }
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, void* dq, void* dk,
                 void* dv, float* delta, int B, int Hq, int Hkv, int S,
                 float scale, cudaStream_t s) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(B) * Hq * S;
  delta_kernel<T, D><<<repro_cdiv(rows, 8), 256, 0, s>>>(
      static_cast<const T*>(o), dop, delta, rows);
  dkdv_kernel<T, D><<<dim3(repro_cdiv(S, FB_T), B * Hkv), FB_T, 0, s>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Hq, Hkv, S, scale);
  dq_kernel<T, D><<<dim3(repro_cdiv(S, FB_T), B * Hq), FB_T, 0, s>>>(
      qp, kp, vp, dop, lse, delta, static_cast<T*>(dq), Hq, Hkv, S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, void* dq, void* dk,
             void* dv, float* delta, int B, int Hq, int Hkv, int S, int D,
             float scale, cudaStream_t s) {
  if (D == 64) {
    return launch_typed<T, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B,
                               Hq, Hkv, S, scale, s);
  }
  if (D == 16) {
    return launch_typed<T, 16>(q, k, v, o, dout, lse, dq, dk, dv, delta, B,
                               Hq, Hkv, S, scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q/o/dout/dq [B, Hq, S, D], k/v/dk/dv [B, Hkv, S, D] (float32 or
// bfloat16 by `dtype`, all one type), lse [B, Hq, S] float32, delta a
// [B, Hq, S] float32 scratch; Hq % Hkv == 0; D in {16, 64}.
REPRO_EXPORT int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* delta, int B, int Hq, int Hkv, int S, int D, float scale,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  if (B <= 0 || S <= 0) return 0;
  if (dtype == 0) {
    return launch_d<float>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, Hq,
                           Hkv, S, D, scale, s);
  }
  return launch_d<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, delta, B,
                                 Hq, Hkv, S, D, scale, s);
}
