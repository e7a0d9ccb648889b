// topk_router: the MoE router.  Softmax over the E experts of each token,
// then k rounds of argmax-and-mask, where an equal value keeps the lower
// expert index (as lax.top_k and the Pallas kernel's jnp.argmax do), then
// the k weights renormalised by max(their sum, 1e-30), summed in round
// order.
//
// Replaces the Pallas TPU kernel `topk_router_pallas`
// (src/repro/kernels/topk_router/kernel.py:43, body `_router_kernel` :29),
// which loads a (256, E) tile into VMEM and reduces along rows.  Here one
// warp takes one token row and each lane one expert (E <= 32, which the
// wrapper checks): the softmax's max and sum and each round's argmax are
// warp shuffles on (value, index) pairs, so the row never leaves
// registers.  Lanes past E hold -inf and never win; a chosen expert is
// masked with -1e30 as in the TPU kernel.
//
// Bound on the card: bytes.  It reads the [T, E] float32 logits once and
// writes [T, k] float32 weights and int32 indices: 4*T*(E + 2k) bytes.
// At a decode trip (T = 4 slots, E = 32, k = 8) that is 768 B, far below
// a launch's cost.
#include "common.cuh"

#define ROUTER_WARPS 4
#define ROUTER_MAX_K 32

namespace {

__global__ void router_kernel(const float* __restrict__ logits,
                              float* __restrict__ w_out,
                              int32_t* __restrict__ i_out, int T, int E,
                              int k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long t = static_cast<long long>(blockIdx.x) * ROUTER_WARPS
      + warp;
  if (t >= T) return;
  const float x = lane < E ? logits[t * E + lane] : -INFINITY;
  const float m = warp_max(x);
  const float e = lane < E ? expf(x - m) : 0.f;
  const float s = warp_sum(e);
  float rem = lane < E ? e / s : -INFINITY;
  float vals[ROUTER_MAX_K];
  int idxs[ROUTER_MAX_K];
  for (int r = 0; r < k; ++r) {
    float bv = rem;
    int bi = lane;
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    vals[r] = bv;
    idxs[r] = bi;
    if (lane == bi) rem = -1e30f;
  }
  if (lane == 0) {
    float total = 0.f;
    for (int r = 0; r < k; ++r) total += vals[r];
    total = fmaxf(total, 1e-30f);
    for (int r = 0; r < k; ++r) {
      w_out[t * k + r] = vals[r] / total;
      i_out[t * k + r] = idxs[r];
    }
  }
}

}  // namespace

// logits [T, E] float32 -> w [T, k] float32, idx [T, k] int32;
// 1 <= k <= E <= 32.
REPRO_EXPORT int topk_router_launch(const void* logits, void* w, void* idx,
                                    int T, int E, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > 32 || k < 1 || k > E) return cudaErrorInvalidValue;
  if (T <= 0) return 0;
  router_kernel<<<repro_cdiv(T, ROUTER_WARPS), 32 * ROUTER_WARPS, 0, s>>>(
      static_cast<const float*>(logits), static_cast<float*>(w),
      static_cast<int32_t*>(idx), T, E, k);
  return static_cast<int>(cudaGetLastError());
}
