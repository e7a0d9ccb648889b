// flash_attention: causal GQA attention forward over one sequence,
// q [B, Hq, S, D] against k/v [B, Hkv, S, D], online softmax in float32
// with masked scores at -1e30, output acc / max(l, 1e-30) in q's type.
// q-head h reads kv-head h / (Hq/Hkv).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/kernel.py:72, body `_flash_kernel`
// :27).  That kernel carries (m, l, acc) in VMEM scratch across a
// sequential kv grid axis and asserts S % block == 0.  Blocks on Hopper
// run in no order, so here the kv loop is inside the CTA, and any S is
// taken (the last q block and the diagonal kv tile are masked).
//
// Bound on the card: bytes at the serving shapes, operations from S of
// about 900 on.  The function reads q, k, v and writes o once,
// 2 * sizeof(T) * D * (Hq + Hkv) * B * S bytes, and needs 4 * D flops
// per (row, visible column) pair, 4*D*B*Hq*S(S+1)/2, against 3.35 TB/s
// and 989 TFLOP/s (bf16 tensor cores); at Hq 16, Hkv 8, D 64 the two
// meet near S = 885.
//
// Two kernels, picked by (type, D) in `flash_attention_launch`:
//
// * bfloat16, D = 64 and D = 128 (the served and timed cases):
//   `wgmma_kernel<D>`.  One
//   CTA per (q block of 64 rows, batch * q-head), the q blocks launched
//   longest-first (the causal block qb walks qb + 1 kv tiles).  Warps
//   0-3 are one consumer warpgroup, warp 4 the producer: its lane 0
//   loads the Q tile once and the K and V tiles (64 rows x D bf16: one
//   8 KB panel of 64 columns at D = 64, two at D = 128, since a box row
//   of the 128-byte swizzle holds at most 64 bf16) by TMA into a ring of
//   2 stages, each stage with a full and an
//   empty mbarrier.  The tensor maps are 3-D over [B*H, S, D] with the
//   128-byte swizzle, so rows past S read as zeros inside each head and
//   never as the next head's rows.  The consumer computes
//   S = Q.K^T with wgmma m64n64k16 (D/16 k-steps, four a panel, both
//   operands from shared memory, float32 accumulators), scales and
//   masks it in
//   float32, keeps the online softmax in registers (row max and sum over
//   the 4 threads that share a row of the fragment), rescales O, packs P
//   to bf16 in registers and adds P.V with a second wgmma whose A operand
//   is those registers (the S fragment maps onto the A fragment, as in
//   FlashAttention-3) and whose B operand is the V tile read MN-major
//   (m64n64k16 at D = 64; m64n128k16 at D = 128, a 64-register
//   accumulator a thread, the descriptor's leading byte offset stepping
//   to the second panel).  At D = 128 the shared memory is Q 16 KB and K
//   and V 16 KB each over 2 stages, 80 KB (two CTAs an SM).
//   The scale is applied to the float32 scores, which for the default
//   scale 2^-3 is exactly q * scale . k up to the order of the sums.
//   Rounding point: P.V rounds p to bf16 before the product, where the
//   JAX function (repro/models/layers.py `blockwise_attention`) keeps p
//   in float32.  That adds at most 2^-9 of sum p|v| / l to an output,
//   inside the bfloat16 tolerance 2^-7 of kernels/cases.py; l sums the
//   unrounded p.
// * float32 (any D of {16, 64, 128}) and bfloat16 D = 16: `flash_kernel`,
//   the CUDA-core form.  Float32 must stay float32 (TF32 tensor cores
//   would break the float32 tolerance 2e-5), and D = 16 is only the
//   SMOKE width.  One CTA per (64-row q block, batch * q-head), one
//   thread per q row holding q * scale and its float32 accumulator up to
//   D = 64; at D = 128 (the dense configs' golden run) a row is split over
//   4 neighbouring lanes, each holding every fourth dimension (32 + 32
//   floats, where 256 would spill), their partial dot products summed by
//   two butterfly shuffles (every lane of the row then holds the same
//   bits, and takes the same branches); K and V tiles (64 rows, 32 at D =
//   128) are staged as float32 in shared memory; each row takes its
//   columns in chunks of 16 (16 scores, one max, one rescale, 16 p*V
//   updates) up to the diagonal.
//
// The TMA, mbarrier and `wgmma` helpers and the tensor map builder are
// in `hopper.cuh`, which the backward (`flash_attention_bwd.cu`) shares.
//
// The training instance, `flash_attention_lse_launch`: the same two
// kernels, template instances with LSE set, which also write each row's
// log-sum-exp of its scaled scores, lse [B, Hq, S] float32 (natural
// log: m + log(l), with the wgmma kernel's log2-unit max and sum turned
// back by ln 2).  The backward kernel (`csrc/flash_attention_bwd.cu`)
// rebuilds P from it.  The serving entry launches the LSE = false
// instances, whose code is the one this note describes.
#include <type_traits>

#include "hopper.cuh"

#define FA_BQ 64
#define FA_CH 16
#define FA_NEG_INF (-1e30f)

namespace {

// ---------------------------------------------------------------------------
// CUDA-core kernel: float32, and bfloat16 at D = 16
// ---------------------------------------------------------------------------

// the CUDA-core kernel's split of a q row: TPR threads a row, each holding
// the DT dimensions part, part + TPR, ... of q * scale and of the
// accumulator (one thread a row up to D = 64; four at D = 128, where one
// thread's 256 live floats would spill), and BK kv rows a shared tile (32
// at D = 128, so the K and V tiles stay within 48 KB of static memory)
template <int D>
struct FaShape {
  static constexpr int TPR = D > 64 ? 4 : 1;
  static constexpr int DT = D / TPR;
  static constexpr int BK = D > 64 ? 32 : 64;
};

template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(FA_BQ * FaShape<D>::TPR)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int Hq, int Hkv, int S, float scale) {
  constexpr int TPR = FaShape<D>::TPR, DT = FaShape<D>::DT;
  constexpr int BK = FaShape<D>::BK, NT = FA_BQ * TPR;
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int kvh = h / (Hq / Hkv);
  const int row0 = blockIdx.x * FA_BQ;
  const int row = row0 + threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;      // dims part + TPR * j
  // the TPR lanes of this row, which take every branch together
  const unsigned rmask = TPR == 1 ? 1u << (threadIdx.x & 31)
      : ((1u << TPR) - 1) << ((threadIdx.x & 31) & ~(TPR - 1));
  const bool active = row < S;
  const long long qbase = static_cast<long long>(bh) * S * D;
  const long long kvbase = (static_cast<long long>(b) * Hkv + kvh) * S * D;

  float qr[DT], acc[DT];
  float m = FA_NEG_INF, l = 0.f;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int d = part + TPR * j;
    qr[j] = active ? to_f32(q[qbase + static_cast<long long>(row) * D + d])
        * scale : 0.f;
    acc[j] = 0.f;
  }
  const int last = min(row0 + FA_BQ - 1, S - 1);
  for (int t0 = 0; t0 <= last; t0 += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BK * D; i += NT) {
      const int r = i / D, d = i - (i / D) * D;
      const bool in = t0 + r < S;
      const long long off = kvbase + static_cast<long long>(t0 + r) * D + d;
      ks[r][d] = in ? to_f32(k[off]) : 0.f;
      vs[r][d] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    const int limit = min(min(BK, S - t0), row - t0 + 1);
    for (int c = 0; c < limit; c += FA_CH) {
      float s[FA_CH];
      float mc = FA_NEG_INF;
#pragma unroll
      for (int j = 0; j < FA_CH; ++j) {
        float dot = FA_NEG_INF;
        if (c + j < limit) {
          dot = 0.f;
#pragma unroll
          for (int i = 0; i < DT; ++i) dot += qr[i] * ks[c + j][part + TPR * i];
          // the row's lanes add their partial sums in butterfly order:
          // every lane ends with the same bits
#pragma unroll
          for (int off = 1; off < TPR; off <<= 1) {
            dot += __shfl_xor_sync(rmask, dot, off);
          }
        }
        s[j] = dot;
        mc = fmaxf(mc, dot);
      }
      const float m_new = fmaxf(m, mc);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < DT; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < FA_CH; ++j) {
        if (c + j < limit) {
          const float p = expf(s[j] - m_new);
          l += p;
#pragma unroll
          for (int i = 0; i < DT; ++i) acc[i] += p * vs[c + j][part + TPR * i];
        }
      }
      m = m_new;
    }
  }
  if (active) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    T* orow = o + qbase + static_cast<long long>(row) * D;
#pragma unroll
    for (int i = 0; i < DT; ++i) orow[part + TPR * i] = to_store<T>(acc[i] * inv);
    if constexpr (LSE) {
      if (part == 0) lse[static_cast<long long>(bh) * S + row] = m + logf(l);
    }
  }
}

template <typename T, int D, bool LSE>
void launch_flash(dim3 grid, const T* q, const T* k, const T* v, T* o,
                  float* lse, int Hq, int Hkv, int S, float scale,
                  cudaStream_t s) {
  flash_kernel<T, D, LSE><<<grid, FA_BQ * FaShape<D>::TPR, 0, s>>>(
      q, k, v, o, lse, Hq, Hkv, S, scale);
}

template <typename T, bool LSE>
int launch_cuda_core(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int Hq, int Hkv, int S, int D,
                     float scale, cudaStream_t s) {
  const dim3 grid(repro_cdiv(S, FA_BQ), B * Hq);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if (D == 64) {
    launch_flash<T, 64, LSE>(grid, qp, kp, vp, op, lse, Hq, Hkv, S, scale, s);
  } else if (D == 16) {
    launch_flash<T, 16, LSE>(grid, qp, kp, vp, op, lse, Hq, Hkv, S, scale, s);
  } else if (D == 128 && std::is_same<T, float>::value) {
    // bfloat16 at D = 128 takes the wgmma kernel; float32 stays here
    if constexpr (std::is_same<T, float>::value) {
      launch_flash<T, 128, LSE>(grid, qp, kp, vp, op, lse, Hq, Hkv, S, scale,
                                s);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// wgmma + TMA kernel: bfloat16, D = 64 and D = 128
// ---------------------------------------------------------------------------

#define FW_PANEL_BYTES (64 * 64 * 2)        // 64 rows x 64 bf16, 8 KB
#define FW_THREADS 160                      // warpgroup 0 + producer warp

// a 64-row tile of D bf16 columns: D / 64 panels
template <int D>
__host__ __device__ constexpr uint32_t fw_tile_bytes() {
  return (D / 64) * FW_PANEL_BYTES;
}
// Q, 2 x (K, V), the slack to align the tiles on 1024 bytes, the barriers
template <int D>
constexpr int fw_smem() { return 5 * fw_tile_bytes<D>() + 1024 + 64; }

template <int D, bool LSE>
__global__ void __launch_bounds__(FW_THREADS)
wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
             const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Hq,
             int Hkv, int S, float scale_log2) {
  constexpr int NP = D / 64;                  // 64-column panels a tile
  constexpr uint32_t TILE = fw_tile_bytes<D>();
  extern __shared__ unsigned char fw_raw[];
  // the 128-byte swizzle repeats every 1024 bytes of shared address:
  // tiles start on such a boundary so the wgmma descriptors need no base
  // offset
  const uint32_t raw = smem_u32(fw_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t bars = base + 5 * TILE;      // q, full[2], empty[2]
  const uint32_t qbar = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (3 + st); };
  auto sk = [&](int st) { return base + TILE * (1 + 2 * st); };
  auto sv = [&](int st) { return base + TILE * (2 + 2 * st); };

  const int qb = gridDim.x - 1 - blockIdx.x;     // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh - b * Hq;
  const int kv_head = b * Hkv + h / (Hq / Hkv);
  const int ntiles = qb + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {                  // producer: one lane issues every load
    if (lane == 0) {
      mbar_expect_tx(qbar, TILE);
      for (int p = 0; p < NP; ++p) {
        tma_load_at(sq + p * FW_PANEL_BYTES, &qmap, qbar, p * 64, qb * 64,
                    bh);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int st = t & 1;
        if (t >= 2) mbar_wait(empty(st), ((t >> 1) - 1) & 1);
        mbar_expect_tx(full(st), 2 * TILE);
        for (int p = 0; p < NP; ++p) {
          tma_load_at(sk(st) + p * FW_PANEL_BYTES, &kmap, full(st), p * 64,
                      t * 64, kv_head);
          tma_load_at(sv(st) + p * FW_PANEL_BYTES, &vmap, full(st), p * 64,
                      t * 64, kv_head);
        }
      }
    }
    return;
  }

  // consumer warpgroup.  Fragment of thread (warp, lane): accumulator
  // element i is at row warp*16 + lane/4 + 8*((i>>1)&1), column
  // (i>>2)*8 + (lane&3)*2 + (i&1)
  float sacc[32], oacc[D / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int r0 = warp * 16 + (lane >> 2);          // local rows r0, r0 + 8
  // K-major, 128-byte rows: 8-row groups 1024 bytes apart; a k-step of
  // 16 bf16 advances the start by 32 bytes, and k-step 4p starts panel p
  uint64_t dq[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    dq[p] = sw128_desc(sq + p * FW_PANEL_BYTES, 16, 1024);
  }
  mbar_wait(qbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    mbar_wait(full(st), (t >> 1) & 1);
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const uint64_t dk = sw128_desc(sk(st) + p * FW_PANEL_BYTES, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss(sacc, dq[p] + 2 * kk, dk + 2 * kk, p * 4 + kk);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sacc);

    // scores in log2 units, the diagonal tile masked causally (columns
    // past S lie beyond the diagonal of every row < S)
    const bool diag = t == qb;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
      const int row = r0 + ((i >> 1) & 1) * 8;
      float x = sacc[i] * scale_log2;
      if (diag && col > row) x = -INFINITY;
      sacc[i] = x;
      if ((i >> 1) & 1) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi = (i >> 1) & 1;
      const float p = exp2f(sacc[i] - (hi ? m1 : m0));
      sacc[i] = p;
      if (hi) ps1 += p; else ps0 += p;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] *= (i >> 1) & 1 ? a1 : a0;
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;

    // P (bf16, registers) . V: A register n holds elements 2n, 2n+1
    uint32_t pa[16];
#pragma unroll
    for (int n = 0; n < 16; ++n) pa[n] = pack_bf16(sacc[2 * n],
                                                   sacc[2 * n + 1]);
    // V MN-major: 64 columns (128 bytes) per panel row, 8-row groups 1024
    // bytes apart, a second panel (D = 128) 8192 bytes on; a k-step of 16
    // rows advances the start by 2048 bytes
    const uint64_t dv = sw128_desc(sv(st), FW_PANEL_BYTES, 1024);
    fence_regs(oacc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (D == 64) {
        wgmma_rs(oacc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                 pa[4 * kk + 3], dv + 128 * kk);
      } else {
        wgmma_rs_n128(oacc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                      pa[4 * kk + 3], dv + 128 * kk);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(oacc);
    mbar_arrive(empty(st));
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
  const int g0 = qb * 64 + r0;
  if constexpr (LSE) {   // the 4 threads of a row hold the same m and l
    if ((lane & 3) == 0) {
      float* lb = lse + static_cast<long long>(bh) * S;
      if (g0 < S) lb[g0] = (m0 + log2f(l0)) * 0.6931471805599453f;
      if (g0 + 8 < S) lb[g0 + 8] = (m1 + log2f(l1)) * 0.6931471805599453f;
    }
  }
  __nv_bfloat16* ob = o + static_cast<long long>(bh) * S * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const bool hi = (i >> 1) & 1;
    const int row = g0 + (hi ? 8 : 0);
    const int col = (i >> 2) * 8 + (lane & 3) * 2;
    if (row < S) {
      const float inv = hi ? inv1 : inv0;
      *reinterpret_cast<__nv_bfloat162*>(
          ob + static_cast<long long>(row) * D + col) =
          __floats2bfloat162_rn(oacc[i] * inv, oacc[i + 1] * inv);
    }
  }
}

template <int D, bool LSE>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Hq, int Hkv, int S, float scale,
                 cudaStream_t s) {
  const cudaError_t bound = bind_device_of(q);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return REPRO_ERR_NO_TMA;
  CUtensorMap qm, km, vm;
  if (!encode_map(enc, &qm, q, B * Hq, S, D) ||
      !encode_map(enc, &km, k, B * Hkv, S, D) ||
      !encode_map(enc, &vm, v, B * Hkv, S, D)) {
    return REPRO_ERR_TMA_MAP;
  }
  constexpr int smem = fw_smem<D>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgmma_kernel<D, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(repro_cdiv(S, 64), B * Hq);
  wgmma_kernel<D, LSE><<<grid, FW_THREADS, smem, s>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), lse, Hq, Hkv, S,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <bool LSE>
int launch_any(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Hq, int Hkv, int S, int D, float scale,
               int dtype, cudaStream_t s) {
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  if (B <= 0 || S <= 0) return 0;
  if (dtype == 0) {
    return launch_cuda_core<float, LSE>(q, k, v, o, lse, B, Hq, Hkv, S, D,
                                        scale, s);
  }
  if (D == 64) {
    return launch_wgmma<64, LSE>(q, k, v, o, lse, B, Hq, Hkv, S, scale, s);
  }
  if (D == 128) {
    return launch_wgmma<128, LSE>(q, k, v, o, lse, B, Hq, Hkv, S, scale, s);
  }
  return launch_cuda_core<__nv_bfloat16, LSE>(q, k, v, o, lse, B, Hq, Hkv, S,
                                              D, scale, s);
}

}  // namespace

// q [B, Hq, S, D], k/v [B, Hkv, S, D] (float32 or bfloat16 by `dtype`,
// all one type), o [B, Hq, S, D]; Hq % Hkv == 0; D in {16, 64, 128}
// (bfloat16 at D 64 and 128: every tensor 16-byte aligned, TMA's rule).
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k,
                                        const void* v, void* o, int B,
                                        int Hq, int Hkv, int S, int D,
                                        float scale, int dtype,
                                        void* stream) {
  return launch_any<false>(q, k, v, o, nullptr, B, Hq, Hkv, S, D, scale,
                           dtype, static_cast<cudaStream_t>(stream));
}

// The training instance: as flash_attention_launch, and lse [B, Hq, S]
// float32, each row's natural log-sum-exp of its scaled, masked scores.
REPRO_EXPORT int flash_attention_lse_launch(const void* q, const void* k,
                                            const void* v, void* o,
                                            float* lse, int B, int Hq,
                                            int Hkv, int S, int D,
                                            float scale, int dtype,
                                            void* stream) {
  return launch_any<true>(q, k, v, o, lse, B, Hq, Hkv, S, D, scale, dtype,
                          static_cast<cudaStream_t>(stream));
}
