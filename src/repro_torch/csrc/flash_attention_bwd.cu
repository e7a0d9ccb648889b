// flash_attention_bwd: the backward of the causal GQA attention of
// `flash_attention.cu`.  From q [B, Hq, S, D], k/v [B, Hkv, S, D], the
// forward's output o and its row log-sum-exp lse [B, Hq, S] (float32,
// the training instance `flash_attention_lse_launch`) and the output's
// cotangent dO, it computes dQ, dK and dV in the inputs' type, with
// float32 accumulation throughout:
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
// Bound on the card: at the training shape (q [4, 16, 256, 64], k/v
// [4, 8, 256, 64] bf16) bytes, 12.6 MB against 3.35 TB/s (3.8 us); the
// products need 2.5 times the forward's causal matmul flops (five
// products of the forward's two sizes against its two), 10 * D flops per
// (row, visible column) pair, 1.35 GFLOP there (1.4 us at 989 TFLOP/s
// bf16); it reads q, k, v, o, dO and lse and writes dQ, dK, dV once.
// At that size each CTA walks only a few tiles, so the time is the
// latency of the longest CTA's chain of dependent steps.
//
// Two kernels, picked by (type, D) in `flash_attention_bwd_launch`.
// Every sum has a fixed order and nothing is added atomically, so a
// rerun is bitwise the same.
//
// * bfloat16, D = 64 (the training instance): `stats_kernel`, then
//   `wgmma_bwd_kernel`, the two passes of FlashAttention-2's backward as
//   the two roles of one launch (so they share the card):
//   - `stats_kernel` writes, per 64-row q tile of each head, the tile's
//     lse * log2(e) and Di = rowsum(dO * o) (eight threads a row, 16-byte
//     loads) into one 512-byte block; rows past S get lse = +inf, so
//     their P is exp2(-inf) = 0 in both roles, and Di = 0.
//   - CTAs [0, n_kv): dK/dV, one per (64-row kv tile, batch * kv head),
//     kv tile 0 (the longest walk) first.  It loads its K and V tiles
//     once by TMA, then walks the group's q heads in order and, for
//     each, the q tiles from the diagonal on; per step S^T = K.Q^T and
//     dP^T = V.dO^T (`wgmma_ss`, float32), P^T and dS^T in float32
//     registers (the diagonal tile masked: q row < kv row), then
//     dV += P^T.dO and dK += dS^T.Q (`wgmma_rs`, A from registers, the
//     Q and dO tiles read MN-major).  dK is scaled once at the end.
//   - CTAs [n_kv, n_kv + n_q): dQ, one per (64-row q tile, batch * q
//     head), the last q tile (the longest walk) first.  It loads its Q,
//     dO tiles and stats once and walks the kv tiles up to the diagonal:
//     S = Q.K^T and dP = dO.V^T (`wgmma_ss`), P and dS (columns past the
//     row masked on the diagonal tile), dQ += dS.K (`wgmma_rs`, the K
//     tile read MN-major).
//   Each CTA is one consumer warpgroup (64 rows of m64n64k16 fragments)
//   and a producer warp whose lane 0 streams the walked tiles (Q, dO and
//   their stats block; or K, V) by TMA into a ring of 2 stages with full
//   and empty mbarriers, as the forward's `wgmma_kernel` does.  The
//   tensor maps are the forward's: 3-D over [B*H, S, 64], 128-byte
//   swizzle, rows past S zero-filled inside each head.
//   Rounding point: the rs products take a bf16 A operand, where the
//   plain version keeps P and dS in float32.  In a CPU model of the
//   rounding (tests/test_torch_bwd_rounding.py, table in PERF.md §6), a
//   single bf16 rounding (relative 2^-9) puts the gradients 3.5x BWD_TOL
//   (2^-7 of kernels/cases.py) off on peaked scores and 1.25-1.94x off on
//   B=2 S=300 and GQA group 8, so each operand is split, x = hi + lo with
//   hi = bf16(x) and lo = bf16(x - hi), and multiplied twice (two rs
//   products into the same float32 accumulator): the operand then
//   carries about 2^-17 of relative error, and each gradient element is
//   off the float32 sum by about 2^-17 * sum |term| plus the
//   accumulation order.
// * float32 (any D of {16, 64}) and bfloat16 D = 16: the CUDA-core form,
//   three kernels.  Float32 must stay float32 (TF32 tensor cores would
//   break the float32 tolerance that the golden run and the grad check
//   rely on), and D = 16 is only granite's SMOKE width.
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
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// wgmma + TMA kernels: bfloat16, D = 64
// ---------------------------------------------------------------------------

#define BW_TILE 8192        // one 64 x 64 bf16 tile
#define BW_STATS 512        // a q tile's stats block: lse2[64], Di[64]
#define BW_THREADS 160      // consumer warpgroup + producer warp
#define BW_STAGES 2         // the ring of walked tiles
// two own tiles, the stages' two walked tiles and stats block each, the
// barriers, and the slack to align the tiles on 1024 bytes
#define BW_SMEM ((2 + 2 * BW_STAGES) * BW_TILE + BW_STAGES * BW_STATS \
                 + 8 * (1 + 2 * BW_STAGES) + 1024)

__global__ void __launch_bounds__(256)
stats_kernel(const __nv_bfloat16* __restrict__ o,
             const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, float* __restrict__ stats,
             int S, int nt) {
  const long long t = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long pr = t >> 3;               // padded row bh * nt*64 + sr
  const int part = static_cast<int>(t & 7);  // 8 of the row's 64 elements
  const long long span = static_cast<long long>(nt) * 64;
  const long long bh = pr / span;
  const int sr = static_cast<int>(pr - bh * span);
  float s = 0.f;
  if (sr < S) {
    const long long off = (bh * S + sr) * 64 + part * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + off);
    const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
    const uint32_t gw[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {    // two bf16 a word, low half first
      s = fmaf(__uint_as_float(gw[w] << 16), __uint_as_float(aw[w] << 16),
               s);
      s = fmaf(__uint_as_float(gw[w] & 0xffff0000u),
               __uint_as_float(aw[w] & 0xffff0000u), s);
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if (part == 0) {
    float* blk = stats + (bh * nt + (sr >> 6)) * 128;
    blk[sr & 63] = sr < S ? lse[bh * S + sr] * 1.4426950408889634f
                          : INFINITY;
    blk[64 + (sr & 63)] = sr < S ? s : 0.f;
  }
}

// x0, x1 as bf16 pairs hi = bf16(x) and lo = bf16(x - hi)
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// d += (hi + lo) . B over 64 reduced rows: 8 m64n64k16 products, B an
// MN-major tile
__device__ __forceinline__ void rs_split(float (&d)[32],
                                         const uint32_t (&hi)[16],
                                         const uint32_t (&lo)[16],
                                         uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs(d, hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3],
             db + 128 * kk);
    wgmma_rs(d, lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3],
             db + 128 * kk);
  }
}

// d = A . B^T over D = 64: 4 m64n64k16 products, both tiles K-major
__device__ __forceinline__ void ss_tile(float (&d)[32], uint64_t da,
                                        uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(d, da + 2 * kk, db + 2 * kk, kk);
}

// The shared-memory plan of a CTA (addresses in the shared window; the
// stats blocks also as generic pointers): two own tiles, a ring of
// BW_STAGES stages of two walked tiles and a stats block each, and the
// barriers: own (the own tiles, and a dQ CTA's stats), full[BW_STAGES],
// empty[BW_STAGES].
struct Plan {
  uint32_t base;
  const float* stats;
  __device__ uint32_t own(int n) const { return base + BW_TILE * n; }
  __device__ uint32_t tile(int st, int n) const {
    return base + BW_TILE * (2 + 2 * st + n);
  }
  __device__ uint32_t stats_at(int st) const {
    return base + (2 + 2 * BW_STAGES) * BW_TILE + BW_STATS * st;
  }
  __device__ uint32_t bar_own() const { return stats_at(BW_STAGES); }
  __device__ uint32_t full(int st) const { return bar_own() + 8 * (1 + st); }
  __device__ uint32_t empty(int st) const {
    return bar_own() + 8 * (1 + BW_STAGES + st);
  }
};

// One dK/dV CTA: kv tile j of kv head bkv = b * Hkv + kvh.
__device__ __forceinline__ void dkdv_cta(
    const Plan& sm, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* domap,
    const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Hq, int Hkv, int S, int nt, int j,
    int bkv, float scale_log2, float scale) {
  const int b = bkv / Hkv, kvh = bkv - b * Hkv;
  const int group = Hq / Hkv;
  const int walk = nt - j;                    // q tiles a head
  const int steps = group * walk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 4) {                  // producer: one lane issues every load
    if (lane == 0) {
      mbar_expect_tx(sm.bar_own(), 2 * BW_TILE);
      tma_load(sm.own(0), kmap, sm.bar_own(), j * 64, bkv);
      tma_load(sm.own(1), vmap, sm.bar_own(), j * 64, bkv);
      for (int step = 0; step < steps; ++step) {
        const int g = step / walk, i = j + step - g * walk;
        const int bh = b * Hq + kvh * group + g;
        const int st = step % BW_STAGES;
        if (step >= BW_STAGES) {
          mbar_wait(sm.empty(st), (step / BW_STAGES - 1) & 1);
        }
        mbar_expect_tx(sm.full(st), 2 * BW_TILE + BW_STATS);
        tma_load(sm.tile(st, 0), qmap, sm.full(st), i * 64, bh);
        tma_load(sm.tile(st, 1), domap, sm.full(st), i * 64, bh);
        bulk_load(sm.stats_at(st),
                  stats + (static_cast<long long>(bh) * nt + i) * 128,
                  BW_STATS, sm.full(st));
      }
    }
    return;
  }

  // consumer warpgroup: fragment rows are kv rows, columns q rows
  float dka[32], dva[32], sacc[32], pacc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    dka[e] = 0.f;
    dva[e] = 0.f;
    sacc[e] = 0.f;
    pacc[e] = 0.f;
  }
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = (lane & 3) * 2;
  const uint64_t dk_a = sw128_desc(sm.own(0), 16, 1024);
  const uint64_t dv_a = sw128_desc(sm.own(1), 16, 1024);
  mbar_wait(sm.bar_own(), 0);
  for (int step = 0; step < steps; ++step) {
    const int st = step % BW_STAGES;
    const bool diag = (step % walk) == 0;       // q tile j: i == j
    mbar_wait(sm.full(st), (step / BW_STAGES) & 1);
    fence_regs(sacc);
    fence_regs(pacc);
    wgmma_fence();
    ss_tile(sacc, dk_a, sw128_desc(sm.tile(st, 0), 16, 1024));   // K.Q^T
    ss_tile(pacc, dv_a, sw128_desc(sm.tile(st, 1), 16, 1024));   // V.dO^T
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    fence_regs(pacc);
    const float* lse2 = sm.stats + 128 * st;    // q columns' lse * log2(e)
    const float* di = lse2 + 64;                // and Di
    uint32_t ph[16], pl[16], dh[16], dl[16];
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      // elements 2n, 2n+1: kv row r0 + 8*(n&1), q columns c, c + 1
      const int c = (n >> 1) * 8 + c0;
      const int r = r0 + 8 * (n & 1);
      const float2 l = *reinterpret_cast<const float2*>(lse2 + c);
      const float2 dd = *reinterpret_cast<const float2*>(di + c);
      float p0 = exp2f(sacc[2 * n] * scale_log2 - l.x);
      float p1 = exp2f(sacc[2 * n + 1] * scale_log2 - l.y);
      if (diag && c < r) p0 = 0.f;              // q row < kv row
      if (diag && c + 1 < r) p1 = 0.f;
      split_pack(p0, p1, ph[n], pl[n]);
      split_pack(p0 * (pacc[2 * n] - dd.x), p1 * (pacc[2 * n + 1] - dd.y),
                 dh[n], dl[n]);
    }
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(dh);
    fence_regs(dl);
    wgmma_fence();
    rs_split(dva, ph, pl, sw128_desc(sm.tile(st, 1), 8192, 1024));  // P^T.dO
    rs_split(dka, dh, dl, sw128_desc(sm.tile(st, 0), 8192, 1024));  // dS^T.Q
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dva);
    fence_regs(dka);
    mbar_arrive(sm.empty(st));
  }

  const long long off = static_cast<long long>(bkv) * S * 64;
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int row = j * 64 + r0 + 8 * ((e >> 1) & 1);
    const int col = (e >> 2) * 8 + c0;
    if (row < S) {
      const long long at = off + static_cast<long long>(row) * 64 + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dka[e] * scale, dka[e + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dva[e], dva[e + 1]);
    }
  }
}

// One dQ CTA: q tile i of q head bh = b * Hq + h.
__device__ __forceinline__ void dq_cta(
    const Plan& sm, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* domap,
    const float* __restrict__ stats, __nv_bfloat16* __restrict__ dq, int Hq,
    int Hkv, int S, int nt, int i, int bh, float scale_log2, float scale) {
  const int b = bh / Hq, h = bh - b * Hq;
  const int kv_head = b * Hkv + h / (Hq / Hkv);
  const int steps = i + 1;                    // kv tiles 0..i
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 4) {
    if (lane == 0) {
      mbar_expect_tx(sm.bar_own(), 2 * BW_TILE + BW_STATS);
      tma_load(sm.own(0), qmap, sm.bar_own(), i * 64, bh);
      tma_load(sm.own(1), domap, sm.bar_own(), i * 64, bh);
      bulk_load(sm.stats_at(0),
                stats + (static_cast<long long>(bh) * nt + i) * 128,
                BW_STATS, sm.bar_own());
      for (int t = 0; t < steps; ++t) {
        const int st = t % BW_STAGES;
        if (t >= BW_STAGES) mbar_wait(sm.empty(st), (t / BW_STAGES - 1) & 1);
        mbar_expect_tx(sm.full(st), 2 * BW_TILE);
        tma_load(sm.tile(st, 0), kmap, sm.full(st), t * 64, kv_head);
        tma_load(sm.tile(st, 1), vmap, sm.full(st), t * 64, kv_head);
      }
    }
    return;
  }

  // consumer warpgroup: fragment rows are q rows, columns kv rows
  float dqa[32], sacc[32], pacc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    dqa[e] = 0.f;
    sacc[e] = 0.f;
    pacc[e] = 0.f;
  }
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = (lane & 3) * 2;
  const uint64_t q_a = sw128_desc(sm.own(0), 16, 1024);
  const uint64_t do_a = sw128_desc(sm.own(1), 16, 1024);
  mbar_wait(sm.bar_own(), 0);
  // this thread's rows r0 and r0 + 8
  const float lr[2] = {sm.stats[r0], sm.stats[r0 + 8]};
  const float dr[2] = {sm.stats[64 + r0], sm.stats[64 + r0 + 8]};
  for (int t = 0; t < steps; ++t) {
    const int st = t % BW_STAGES;
    const bool diag = t == i;
    mbar_wait(sm.full(st), (t / BW_STAGES) & 1);
    fence_regs(sacc);
    fence_regs(pacc);
    wgmma_fence();
    ss_tile(sacc, q_a, sw128_desc(sm.tile(st, 0), 16, 1024));    // Q.K^T
    ss_tile(pacc, do_a, sw128_desc(sm.tile(st, 1), 16, 1024));   // dO.V^T
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);
    fence_regs(pacc);
    uint32_t dh[16], dl[16];
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      // elements 2n, 2n+1: q row r0 + 8*(n&1), kv columns c, c + 1
      const int c = (n >> 1) * 8 + c0;
      const int r = r0 + 8 * (n & 1);
      float p0 = exp2f(sacc[2 * n] * scale_log2 - lr[n & 1]);
      float p1 = exp2f(sacc[2 * n + 1] * scale_log2 - lr[n & 1]);
      if (diag && c > r) p0 = 0.f;              // kv row > q row
      if (diag && c + 1 > r) p1 = 0.f;
      split_pack(p0 * (pacc[2 * n] - dr[n & 1]),
                 p1 * (pacc[2 * n + 1] - dr[n & 1]), dh[n], dl[n]);
    }
    fence_regs(dqa);
    fence_regs(dh);
    fence_regs(dl);
    wgmma_fence();
    rs_split(dqa, dh, dl, sw128_desc(sm.tile(st, 0), 8192, 1024));  // dS.K
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dqa);
    mbar_arrive(sm.empty(st));
  }

  const long long off = static_cast<long long>(bh) * S * 64;
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int row = i * 64 + r0 + 8 * ((e >> 1) & 1);
    const int col = (e >> 2) * 8 + c0;
    if (row < S) {
      *reinterpret_cast<__nv_bfloat162*>(
          dq + off + static_cast<long long>(row) * 64 + col) =
          __floats2bfloat162_rn(dqa[e] * scale, dqa[e + 1] * scale);
    }
  }
}

// CTAs [0, n_kv) are dK/dV CTAs (kv tile x / (B*Hkv), the longest walks
// first), the rest dQ CTAs (q tile nt - 1 - y / (B*Hq), the longest
// first).  Two CTAs an SM: registers capped at 204 a thread.
__global__ void __launch_bounds__(BW_THREADS, 2)
wgmma_bwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap domap,
                 const float* __restrict__ stats,
                 __nv_bfloat16* __restrict__ dq,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int B, int Hq, int Hkv,
                 int S, int nt, float scale_log2, float scale) {
  extern __shared__ unsigned char bw_raw[];
  // tiles on a 1024-byte boundary, where the 128-byte swizzle repeats, so
  // the wgmma descriptors need no base offset
  const uint32_t raw = smem_u32(bw_raw);
  Plan sm;
  sm.base = (raw + 1023u) & ~1023u;
  sm.stats = reinterpret_cast<const float*>(
      bw_raw + (sm.base - raw) + (2 + 2 * BW_STAGES) * BW_TILE);
  if (threadIdx.x == 0) {
    mbar_init(sm.bar_own(), 1);
    for (int st = 0; st < BW_STAGES; ++st) {
      mbar_init(sm.full(st), 1);
      mbar_init(sm.empty(st), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_kv = nt * B * Hkv;
  const int x = blockIdx.x;
  if (x < n_kv) {
    const int j = x / (B * Hkv);
    dkdv_cta(sm, &qmap, &kmap, &vmap, &domap, stats, dk, dv, Hq, Hkv, S, nt,
             j, x - j * (B * Hkv), scale_log2, scale);
  } else {
    const int y = x - n_kv;
    const int k = y / (B * Hq);
    dq_cta(sm, &qmap, &kmap, &vmap, &domap, stats, dq, Hq, Hkv, S, nt,
           nt - 1 - k, y - k * (B * Hq), scale_log2, scale);
  }
}

int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, void* dq, void* dk,
                 void* dv, float* stats, int B, int Hq, int Hkv, int S,
                 float scale, cudaStream_t s) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm, dom;
  if (!encode_map(enc, &qm, q, B * Hq, S) ||
      !encode_map(enc, &km, k, B * Hkv, S) ||
      !encode_map(enc, &vm, v, B * Hkv, S) ||
      !encode_map(enc, &dom, dout, B * Hq, S)) {
    return cudaErrorInvalidValue;
  }
  // above 48 KB of shared memory needs the kernel's opt-in
  const cudaError_t err = cudaFuncSetAttribute(
      wgmma_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BW_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = repro_cdiv(S, 64);
  const long long prows = static_cast<long long>(B) * Hq * nt * 64;
  stats_kernel<<<static_cast<int>(prows * 8 / 256), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, stats, S, nt);
  wgmma_bwd_kernel<<<nt * B * (Hkv + Hq), BW_THREADS, BW_SMEM, s>>>(
      qm, km, vm, dom, stats, static_cast<__nv_bfloat16*>(dq),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B,
      Hq, Hkv, S, nt, scale * 1.4426950408889634f, scale);
  return static_cast<int>(cudaGetLastError());
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

// float32 at D in {16, 64}
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, void* dq, void* dk,
               void* dv, float* delta, int B, int Hq, int Hkv, int S, int D,
               float scale, cudaStream_t s) {
  if (D == 64) {
    return launch_typed<float, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta,
                                   B, Hq, Hkv, S, scale, s);
  }
  if (D == 16) {
    return launch_typed<float, 16>(q, k, v, o, dout, lse, dq, dk, dv, delta,
                                   B, Hq, Hkv, S, scale, s);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// q/o/dout/dq [B, Hq, S, D], k/v/dk/dv [B, Hkv, S, D] (float32 or
// bfloat16 by `dtype`, all one type), lse [B, Hq, S] float32; Hq % Hkv
// == 0; D in {16, 64}.  `scratch` is float32 of B * Hq * cdiv(S, 64) *
// 128 elements: Di for the CUDA-core kernels, the stats blocks for the
// wgmma kernel.  That kernel (bfloat16, D = 64) takes every tensor
// 16-byte aligned (TMA's rule, and the stats kernel's 16-byte loads of o)
// and returns cudaErrorInvalidValue otherwise.
REPRO_EXPORT int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    float* scratch, int B, int Hq, int Hkv, int S, int D, float scale,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  if (B <= 0 || S <= 0) return 0;
  if (dtype == 0) {
    return launch_f32(q, k, v, o, dout, lse, dq, dk, dv, scratch, B, Hq, Hkv,
                      S, D, scale, s);
  }
  if (D == 16) {
    return launch_typed<__nv_bfloat16, 16>(q, k, v, o, dout, lse, dq, dk, dv,
                                           scratch, B, Hq, Hkv, S, scale, s);
  }
  if (D != 64) return cudaErrorInvalidValue;
  const void* const ptrs[] = {q, k, v, o, dout, dq, dk, dv};
  for (const void* p : ptrs) {
    if (!aligned16(p)) return cudaErrorInvalidValue;
  }
  return launch_wgmma(q, k, v, o, dout, lse, dq, dk, dv, scratch, B, Hq, Hkv,
                      S, scale, s);
}
