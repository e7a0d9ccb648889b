// topk_router_bwd: the backward of `topk_router.cu`'s router (softmax
// over E, top-k, renormalise).  The gradient reaches the logits through
// the k renormalised weights only (the indices have none).  For token t
// with weights w [k], chosen experts idx [k] and the weights' cotangent
// dw [k]:
//
//   dlogits[t, idx_j] = w_j * (dw_j - sum_l w_l * dw_l),  0 elsewhere
//
// (the softmax's and the renormalisation's vjps compose to this: the
// weights sum to 1, so the softmax's own correction term vanishes).
//
// Replaces no TPU kernel: the Pallas kernel (`topk_router_pallas`,
// src/repro/kernels/topk_router/kernel.py:43) is forward only, and the
// JAX package trains through the jnp form `topk_router_ref`
// (src/repro/kernels/topk_router/ref.py), which jax.vjp differentiates.
// This kernel computes that vjp on the card.
//
// Bound on the card: bytes.  It reads w, idx, dw (12 * T * k bytes) and
// writes the dense float32 dlogits [T, E] once (4 * T * E bytes).
//
// Design: one warp a token, 4 tokens a CTA.  Lane l < k loads w_l, dw_l
// and idx_l; the sum is an xor butterfly, the same in every lane.  Lane
// l owns the experts l, l + 32, ... (R = ceil(E / 32) of them, so the
// warp's stores of a row are coalesced); the k (expert, value) pairs are
// broadcast by shuffles, and each lane writes every one of its experts
// once, zero where it was not chosen: the row needs no memset launch and
// no second write.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // tokens a CTA
constexpr unsigned kFull = 0xffffffffu;

template <int R>
__global__ void __launch_bounds__(32 * kWarps)
topk_router_bwd_kernel(const float* __restrict__ w,
                       const int32_t* __restrict__ idx,
                       const float* __restrict__ dw,
                       float* __restrict__ dlogits, int T, int E, int k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long t = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (t >= T) return;
  float wl = 0.f, gl = 0.f;
  int il = -1;
  if (lane < k) {
    wl = w[t * k + lane];
    gl = dw[t * k + lane];
    il = idx[t * k + lane];
  }
  const float c = warp_sum(wl * gl);
  const float val = wl * (gl - c);
  float out[R];
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = 0.f;
  for (int j = 0; j < k; ++j) {
    const int e = __shfl_sync(kFull, il, j);
    const float vj = __shfl_sync(kFull, val, j);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (e == lane + 32 * r) out[r] = vj;
    }
  }
  float* row = dlogits + t * E;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane + 32 * r < E) row[lane + 32 * r] = out[r];
  }
}

template <int R>
void launch_r(const void* w, const void* idx, const void* dw, void* dl,
              int T, int E, int k, cudaStream_t s) {
  topk_router_bwd_kernel<R><<<repro_cdiv(T, kWarps), 32 * kWarps, 0, s>>>(
      static_cast<const float*>(w), static_cast<const int32_t*>(idx),
      static_cast<const float*>(dw), static_cast<float*>(dl), T, E, k);
}

}  // namespace

// w [T, k] float32, idx [T, k] int32, dw [T, k] float32 -> dlogits
// [T, E] float32; 1 <= E <= 256, 1 <= k <= min(E, 32).
REPRO_EXPORT int topk_router_bwd_launch(const void* w, const void* idx,
                                        const void* dw, void* dlogits, int T,
                                        int E, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > 256 || k < 1 || k > E || k > 32)
    return cudaErrorInvalidValue;
  if (T <= 0) return 0;
  if (E <= 32) launch_r<1>(w, idx, dw, dlogits, T, E, k, s);
  else if (E <= 64) launch_r<2>(w, idx, dw, dlogits, T, E, k, s);
  else if (E <= 128) launch_r<4>(w, idx, dw, dlogits, T, E, k, s);
  else launch_r<8>(w, idx, dw, dlogits, T, E, k, s);
  return static_cast<int>(cudaGetLastError());
}
