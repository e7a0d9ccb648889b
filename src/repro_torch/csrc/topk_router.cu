// topk_router: the MoE router.  Softmax over the E experts of each token,
// then k rounds of argmax-and-mask, where an equal value keeps the lower
// expert index (as lax.top_k and the Pallas kernel's jnp.argmax do), then
// the k weights divided by max(their sum, 1e-30), summed in round order
// (the Pallas kernel's default `renormalize=True`).
//
// Replaces the Pallas TPU kernel `topk_router_pallas`
// (src/repro/kernels/topk_router/kernel.py:43, body `_router_kernel` :19),
// which loads a (256, E) tile into VMEM and reduces along rows.
//
// Bound on the card: bytes.  It reads the [T, E] float32 logits once and
// writes [T, k] float32 weights and int32 indices: 4*T*(E + 2k) bytes.
// At a decode trip (T = 4 slots, E = 32, k = 8) that is 768 B, far below
// a launch's cost, so what sets the time is the chain of dependent warp
// steps inside one launch; the design cuts that chain:
//   * One warp a token, 4 tokens a CTA.  Each lane holds a contiguous run
//     of R = ceil(E/32) experts (R in 1, 2, 4, 8; E <= 256), read one
//     float at a time, and the row stays in registers.
//   * The softmax's max is one `redux.sync` on an order-preserving key of
//     the float; its sum is an xor butterfly of the lanes' run sums.
//   * A key that sorts in one instruction: probabilities are >= 0, so
//     their bits order like uint32.  A live expert's key is bits + 1, a
//     chosen or absent expert's 0, so a chosen expert never wins again,
//     even when every remaining probability has underflowed to 0.0 (the
//     Pallas kernel's -1e30 mask has the same property).
//   * Each lane keeps its run's best key (lowest index on ties).  A round
//     is `__reduce_max_sync` over the lanes' best keys, then
//     `__ballot_sync(best == max)` and `__ffs` for the lowest lane holding
//     it: since the runs are contiguous, that lane holds the lowest
//     global index of the largest value.  With R > 1 one shuffle brings
//     the winner's place in its run; only the winning lane rescans its
//     run.  This replaces five dependent pairs of shuffles a round.
//   * Every lane adds the round's warp-uniform value to a running total,
//     in round order; lane r keeps round r's value and index, and lanes
//     < k divide and store in one coalesced store each.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // tokens a CTA
constexpr unsigned kFull = 0xffffffffu;

// Order-preserving uint32 key of a float, and back.
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

template <int R>
__global__ void __launch_bounds__(32 * kWarps)
topk_router_kernel(const float* __restrict__ logits,
                   float* __restrict__ w_out, int32_t* __restrict__ i_out,
                   int T, int E, int k) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long t = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (t >= T) return;
  const float* row = logits + t * E;
  const int base = lane * R;  // this lane's run: experts base .. base+R-1

  float x[R];
#pragma unroll
  for (int j = 0; j < R; ++j) x[j] = base + j < E ? row[base + j] : -INFINITY;

  float lmax = x[0];
#pragma unroll
  for (int j = 1; j < R; ++j) lmax = fmaxf(lmax, x[j]);
  const float m = key_float(__reduce_max_sync(kFull, order_key(lmax)));
  float e[R];
  float lsum = 0.f;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    e[j] = base + j < E ? expf(x[j] - m) : 0.f;
    lsum += e[j];
  }
  const float s = warp_sum(lsum);  // bitwise the same in every lane

  uint32_t key[R];
  uint32_t best = 0u;
  int bj = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    key[j] = base + j < E ? __float_as_uint(e[j] / s) + 1u : 0u;
    if (key[j] > best) {
      best = key[j];
      bj = j;
    }
  }

  float total = 0.f, my_v = 0.f;
  int my_i = 0;
  for (int r = 0; r < k; ++r) {
    const uint32_t top = __reduce_max_sync(kFull, best);
    const int wl = __ffs(__ballot_sync(kFull, best == top)) - 1;
    const float v = __uint_as_float(top - 1u);
    int idx = wl * R;
    if constexpr (R > 1) idx += __shfl_sync(kFull, bj, wl);
    total += v;
    if (lane == r) {
      my_v = v;
      my_i = idx;
    }
    if (lane == wl) {  // retire the chosen expert; the run's next best
      best = 0u;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j == bj) key[j] = 0u;
      }
      int nj = 0;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (key[j] > best) {
          best = key[j];
          nj = j;
        }
      }
      bj = nj;
    }
  }
  if (lane < k) {
    w_out[t * k + lane] = my_v / fmaxf(total, 1e-30f);
    i_out[t * k + lane] = my_i;
  }
}

template <int R>
void launch_r(const void* logits, void* w, void* idx, int T, int E, int k,
              cudaStream_t s) {
  topk_router_kernel<R><<<repro_cdiv(T, kWarps), 32 * kWarps, 0, s>>>(
      static_cast<const float*>(logits), static_cast<float*>(w),
      static_cast<int32_t*>(idx), T, E, k);
}

}  // namespace

// logits [T, E] float32 -> w [T, k] float32, idx [T, k] int32;
// 1 <= E <= 256, 1 <= k <= min(E, 32).
REPRO_EXPORT int topk_router_launch(const void* logits, void* w, void* idx,
                                    int T, int E, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > 256 || k < 1 || k > E || k > 32)
    return cudaErrorInvalidValue;
  if (T <= 0) return 0;
  if (E <= 32) launch_r<1>(logits, w, idx, T, E, k, s);
  else if (E <= 64) launch_r<2>(logits, w, idx, T, E, k, s);
  else if (E <= 128) launch_r<4>(logits, w, idx, T, E, k, s);
  else launch_r<8>(logits, w, idx, T, E, k, s);
  return static_cast<int>(cudaGetLastError());
}
