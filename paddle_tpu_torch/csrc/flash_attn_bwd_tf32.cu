// Flash-attention backward on f32 operands: dQ (K8) and dK/dV (K9) on
// Hopper's tf32 wgmma with TMA loads through an mbarrier ring, for sm_90a.
// The bf16 kernels are flash_attn_bwd.cu; the f32 forward forms (K7, K10)
// are flash_attn_walk.cu.
//
// Replace, in f32: paddle_tpu/ops/pallas_attention.py `_dq_kernel` (:295,
// pallas_call :438) and `_dkv_kernel` (:342, pallas_call :453), both
// reached through `flash_attention_bwd_block` (:395). Same function: from
// q, k, v, dO [B, T, H, D] f32 and lse, delta [B, H, Tq] f32, with P =
// exp(scale * Q K^T [mask] - LSE) and dS = P o (dO V^T - delta), both f32
// and never rounded (the reference's roundings to the operand dtype are
// no-ops in f32):
//   K8: dQ = scale * dS K
//   K9: dV = P^T dO, dK = scale * dS^T Q
//
// Arithmetic. Every product is three tf32 passes (3xTF32): x = hi + lo
// with hi the top 19 bits of x (truncated: what the tensor cores read of a
// raw f32, so a raw tile serves as its own hi) and lo = x - hi (exact)
// rounded to the nearest tf32; a*b is taken as lo_a*hi_b + hi_a*lo_b +
// hi_a*hi_b, |error| < 2^-19 |a b| (the dropped lo*lo and lo's rounding).
// The tensor cores' accumulation does not round to nearest, so the
// sequence-long sums (dQ over keys, dK and dV over queries) take each
// tile's three passes into a zeroed partial that joins the sum by an f32
// add (a chain of 12 k8 steps, not thousands). S is scaled by a rounded
// multiply, P = expf(S - LSE) (no approximate exponential), masked scores
// -1e30, keys or queries past T -inf; dQ and dK are scaled at the end.
//
// Design. Each CTA owns 64 resident rows (queries in K8, keys in K9) for
// one consumer warpgroup and streams the other side's tiles of 32 rows
// through a ring of stages; every output element is written by one CTA,
// without atomics, so a repeated call is bitwise equal. Three roles:
// - a TMA warp (one thread) keeps the ring full: 4-D maps over [B, T, H,
//   D] in place, 32-column boxes (128 bytes, the swizzle span) that land
//   as 128-byte-swizzled blocks; K9's LSE and delta rows by 2-D maps;
// - three split warps turn each landed f32 tile into what tf32 wgmma
//   reads: tf32 wgmma has no transpose bits, so both operands of a
//   product must be K-major in shared memory, and the products whose
//   reduction runs over the streamed rows (dS K; P^T dO, dS^T Q) need the
//   tile transposed. The pass writes lo in the tile's own layout and, where
//   a product needs them, the transposed hi and lo with the k order of
//   each 8-row step permuted (row 2i at k i, row 2i+1 at k i + 4), so that
//   an f32 accumulator (dS, P^T, dS^T) is the register A operand of the
//   next product as it stands (A's register a[0] holds k = l%4 of row l/4,
//   a[2] k + 4; the accumulator's d[4j], d[4j+1] hold columns 8j + 2(l%4)
//   and + 1). Resident tiles are split once. Each thread moves 4x4 blocks
//   by 16-byte accesses, mapped so that no access has a bank conflict;
// - a consumer warpgroup runs every product on wgmma m64nNk8 tf32: S and
//   dP (K9: S^T and dP^T) with both operands in shared memory, the
//   partials of dQ (dV, dK) with A from registers.
// The reference's sequential grid axis is the loop over streamed tiles;
// causal tiles wholly past the diagonal are not visited, and only the
// tiles the mask or a ragged end reaches apply it per element. Grid:
// heads x batch x row tiles, the tiles with the most work first (K8: the
// last query tiles; K9: the first key tiles).
//
// Tile plans (shared memory per CTA; one CTA an SM): K8 at D <= 64 two
// stages of 32 keys (K, K lo, K^T hi, K^T lo, V, V lo: 48 KB a stage)
// beside the resident Q, Q lo, dO, dO lo (64 KB); at D <= 128 one stage
// (96 + 128 KB). K9 at D <= 64 two stages of 32 queries (Q, Q lo, Q^T hi,
// Q^T lo, dO, dO lo, dO^T hi, dO^T lo: 64 KB) beside K, K lo, V, V lo (64
// KB); at D <= 128 two launches, dV (two stages, K and K lo resident)
// then dK (one stage). ptxas serializes the wgmmas of a plan whose wgmma
// pipeline does not fit its register budget (C7511, no spill): K8 with
// three stages, a CTA of two consumer warpgroups, and the D-128 dQ and dK
// plans (K9 at D 64 fits at 246 registers); tests/torch_attn_f32_sweep.py
// times the alternatives.
//
// Bound on an H100: the products run as three TF32 passes, so 495 / 3 =
// 165 TF/s. Causal at the f32 paths' shape [1, 2048, 8, 64], K8 does 3
// products of 2*T^2*D/2 per (b, h), 6.4 GFLOP a call (0.039 ms), K9 4,
// 8.6 GFLOP (0.052 ms); their bytes (f32 operands, one or two outputs)
// take 0.006-0.008 ms at 3.35 TB/s: operation-bound. What the design does
// about the tile walk it replaces (flash_attn_walk.cu's former K8/K9:
// mma.sync m16n8k8, 64-bit shared loads, every thread a loader, each of 4
// warps re-splitting every B fragment it loads): wgmma at N 32-128, TMA
// loads, and one split of each operand element per CTA.

#include "flash_attn_tf32.cuh"

namespace {

using namespace flash_tf32;
using flash::MASKED;

struct Params {
  float* dq;           // [B, Tq, H, D]  K8
  float* dk;           // [B, Tk, H, D]  K9
  float* dv;           // [B, Tk, H, D]  K9
  const float* lse;    // [B, H, Tq]     K8 (K9 reads them by TMA)
  const float* delta;  // [B, H, Tq]
  int h, tq, tk, d, q_off, k_off, causal, tiles;
  float scale;
};

// K8 --------------------------------------------------------------------------

template <int DP, int BK, int STAGES>
struct DqPlan {
  static constexpr int Q_BYTES = ROWS * DP * 4;   // a resident tile
  static constexpr int T_BYTES = BK * DP * 4;     // a streamed tile
  // K, K lo, K^T hi, K^T lo, V, V lo
  static constexpr int STAGE = 6 * T_BYTES;
  static constexpr int BARS = 2 + 3 * STAGES;
  static constexpr int SMEM = 1024 + 4 * Q_BYTES + STAGES * STAGE + BARS * 8;
};

// dS for one key tile on the accumulator layout, in place of s; dp is dO
// V^T. MASK: keys past Tk score -inf, causal keys past the row -1e30.
template <int BK, bool MASK>
__device__ __forceinline__ void dq_ds(float (&s)[BK / 2],
                                      const float (&dp)[BK / 2],
                                      const float (&lse)[2],
                                      const float (&dl)[2], float scale,
                                      int key0, int tk, bool causal,
                                      int qpos0, int k_off, int t) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    float v = __fmul_rn(s[i], scale);
    if constexpr (MASK) {
      const int key = key0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (key >= tk)
        v = -INFINITY;
      else if (causal && qpos0 + 8 * r < k_off + key)
        v = MASKED;
    }
    const float pe = expf(v - lse[r]);
    s[i] = pe * (dp[i] - dl[r]);
  }
}

template <int DP, int BK, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
    dq_tf32_kernel(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mdo,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, Params p) {
  using P = DqPlan<DP, BK, STAGES>;
  constexpr int QB = P::Q_BYTES, TB = P::T_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = flash::align1024(smem_raw);
  uint8_t* q_s = smem;  // Q, Q lo, dO, dO lo
  uint8_t* stages = q_s + 4 * QB;
  const uint32_t q_full = hg::smem_u32(stages + STAGES * P::STAGE);
  const uint32_t q_ready = q_full + 8;
  const uint32_t full0 = q_ready + 8;
  const uint32_t ready0 = full0 + 8 * STAGES;
  const uint32_t empty0 = ready0 + 8 * STAGES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int q0 = (p.tiles - 1 - (int)blockIdx.z) * ROWS;  // heaviest first
  const int last = min(q0 + ROWS, p.tq) - 1;
  const int n = flash::key_tiles(p.tk, BK, p.causal, last, p.q_off, p.k_off);
  int n_free = p.tk / BK;  // key tiles no mask reaches
  if (p.causal) {
    const int x = p.q_off + q0 - p.k_off + 1;
    n_free = min(n_free, x <= 0 ? 0 : x / BK);
  }

  if (tid == 0) {
    hg::mbar_init(q_full, 1);
    hg::mbar_init(q_ready, SPLIT_THREADS);
    for (int s = 0; s < STAGES; ++s) {
      hg::mbar_init(full0 + 8 * s, 1);
      hg::mbar_init(ready0 + 8 * s, SPLIT_THREADS);
      hg::mbar_init(empty0 + 8 * s, 4);  // one per consumer warp
    }
    hg::mbar_fence_init();
  }
  __syncthreads();

  if (warp == TMA_WARP) {
    if (lane != 0 || n == 0) return;
    hg::tma_prefetch(&mq);
    hg::tma_prefetch(&mdo);
    hg::tma_prefetch(&mk);
    hg::tma_prefetch(&mv);
    hg::mbar_expect_tx(q_full, 2 * QB);
#pragma unroll
    for (int c = 0; c < DP / BLOCK; ++c) {
      hg::tma_load_4d(hg::smem_u32(q_s + c * ROWS * 128), &mq, q_full,
                      BLOCK * c, hh, q0, bb);
      hg::tma_load_4d(hg::smem_u32(q_s + 2 * QB + c * ROWS * 128), &mdo,
                      q_full, BLOCK * c, hh, q0, bb);
    }
    for (int j = 0; j < n; ++j) {
      const int s = j % STAGES;
      uint8_t* st = stages + s * P::STAGE;
      const uint32_t full = full0 + 8 * s;
      hg::mbar_wait(empty0 + 8 * s, ((j / STAGES) & 1) ^ 1);
      hg::mbar_expect_tx(full, 2 * TB);
#pragma unroll
      for (int c = 0; c < DP / BLOCK; ++c) {
        hg::tma_load_4d(hg::smem_u32(st + c * BK * 128), &mk, full,
                        BLOCK * c, hh, j * BK, bb);
        hg::tma_load_4d(hg::smem_u32(st + 4 * TB + c * BK * 128), &mv, full,
                        BLOCK * c, hh, j * BK, bb);
      }
    }
    return;
  }

  if (warp >= 4) {
    // ---- split warps ----
    const int ptid = tid - 128;
    if (n == 0) return;
    hg::mbar_wait(q_full, 0);
    split_tile<ROWS, DP, true, false>(q_s, q_s + QB, nullptr, nullptr, ptid);
    split_tile<ROWS, DP, true, false>(q_s + 2 * QB, q_s + 3 * QB, nullptr,
                                      nullptr, ptid);
    hg::fence_proxy_async();
    hg::mbar_arrive(q_ready);
    for (int j = 0; j < n; ++j) {
      const int s = j % STAGES;
      uint8_t* st = stages + s * P::STAGE;
      hg::mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
      split_tile<BK, DP, true, true>(st, st + TB, st + 2 * TB, st + 3 * TB,
                                     ptid);
      split_tile<BK, DP, true, false>(st + 4 * TB, st + 5 * TB, nullptr,
                                      nullptr, ptid);
      hg::fence_proxy_async();
      hg::mbar_arrive(ready0 + 8 * s);
    }
    return;
  }

  // ---- consumers: query rows q0 .. q0 + 63 ----
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // and row0 + 8
  const long long stat = ((long long)bb * p.h + hh) * p.tq;
  float lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row0 + 8 * r < p.tq;
    lse[r] = ok ? p.lse[stat + row0 + 8 * r] : 0.0f;
    dl[r] = ok ? p.delta[stat + row0 + 8 * r] : 0.0f;
  }
  float acc[DP / 2], part[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = part[i] = 0.0f;
  if (n > 0) hg::mbar_wait(q_ready, 0);
  const uint32_t qa = hg::smem_u32(q_s);
  for (int j = 0; j < n; ++j) {
    const int s = j % STAGES;
    hg::mbar_wait(ready0 + 8 * s, (j / STAGES) & 1);
    const uint32_t kb = hg::smem_u32(stages + s * P::STAGE);
    float sc[BK / 2], dp[BK / 2];
    hg::wgmma_fence();
    product_ss<BK, ROWS, DP>(sc, qa, qa + QB, kb, kb + TB, true);  // Q K^T
    product_ss<BK, ROWS, DP>(dp, qa + 2 * QB, qa + 3 * QB, kb + 4 * TB,
                             kb + 5 * TB, true);                   // dO V^T
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs(sc);
    hg::fence_regs(dp);

    if (j < n_free)
      dq_ds<BK, false>(sc, dp, lse, dl, p.scale, j * BK, p.tk, p.causal,
                       p.q_off + row0, p.k_off, t);
    else
      dq_ds<BK, true>(sc, dp, lse, dl, p.scale, j * BK, p.tk, p.causal,
                      p.q_off + row0, p.k_off, t);

    // the tile's dS K into a zeroed partial, joined to dQ by an f32 add
    uint32_t ah[BK / 8][4], al[BK / 8][4];
    product_rs<DP, BK>(part, sc, ah, al, kb + 2 * TB, kb + 3 * TB);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs(part);
    fence_frags<BK>(ah);
    fence_frags<BK>(al);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] += part[i];
    if (lane == 0) hg::mbar_arrive(empty0 + 8 * s);
  }

  const long long stride = (long long)p.h * p.d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.tq) continue;
    float* out = p.dq + ((long long)bb * p.tq + row) * stride +
                 (long long)hh * p.d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < p.d)
        store2(out + col, acc[4 * j + 2 * r] * p.scale,
               acc[4 * j + 2 * r + 1] * p.scale);
    }
  }
}

// K9 --------------------------------------------------------------------------

// PART: which of K9's outputs a launch computes, kDV | kDK for both (D <=
// 64); at D 128 dV, then dK, each in its own launch, so that the resident
// and streamed forms fit shared memory.
constexpr int kDV = 1, kDK = 2;

// The LSE and delta rows of a query tile, each on a 128-byte boundary.
template <int BQ>
__host__ __device__ constexpr int stat_half() {
  return (BQ * 4 + 127) / 128 * 128;
}

template <int DP, int BQ, int STAGES, int PART>
struct DkvPlan {
  static constexpr bool DK = PART & kDK, DV = PART & kDV;
  static constexpr int K_BYTES = ROWS * DP * 4;  // a resident tile
  static constexpr int T_BYTES = BQ * DP * 4;    // a streamed tile
  // resident: K, K lo, then (dK) V, V lo
  static constexpr int RESIDENT = (DK ? 4 : 2) * K_BYTES;
  // a stage: Q, Q lo, dO, then (dK) dO lo, Q^T hi, Q^T lo, then (dV) dO^T
  // hi, dO^T lo, every tile on a 1024-byte boundary; the stages' LSE and
  // delta rows after the last stage
  static constexpr int DO_LO = 3 * T_BYTES;
  static constexpr int QT = DO_LO + (DK ? T_BYTES : 0);
  static constexpr int DOT = QT + (DK ? 2 * T_BYTES : 0);
  static constexpr int STAGE = DOT + (DV ? 2 * T_BYTES : 0);
  static constexpr int STATS = 2 * stat_half<BQ>();  // a stage's rows
  static constexpr int BARS = 2 + 3 * STAGES;
  static constexpr int SMEM =
      1024 + RESIDENT + STAGES * (STAGE + STATS) + BARS * 8;
};

// P^T (in s) and, for dK, dS^T (in dp) for one query tile, whose columns'
// LSE and delta are lse_s and dl_s. MASK: queries past Tq score -inf,
// causal queries before the key -1e30.
template <int BQ, bool MASK, bool DK>
__device__ __forceinline__ void dkv_p_ds(float (&s)[BQ / 2],
                                         float (&dp)[BQ / 2],
                                         const float* lse_s,
                                         const float* dl_s, float scale,
                                         int qrow0, int tq, bool causal,
                                         int q_off, int kpos0, int t) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const int c = 8 * j + 2 * t;  // this thread's columns c, c + 1
    const float2 ls = *reinterpret_cast<const float2*>(lse_s + c);
    const float2 ds = *reinterpret_cast<const float2*>(dl_s + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int i = 4 * j + e;
      float v = __fmul_rn(s[i], scale);
      if constexpr (MASK) {
        const int q = qrow0 + c + (e & 1);
        if (q >= tq)
          v = -INFINITY;
        else if (causal && q_off + q < kpos0 + 8 * r)
          v = MASKED;
      }
      const float pe = expf(v - ((e & 1) ? ls.y : ls.x));
      s[i] = pe;
      if constexpr (DK) dp[i] = pe * (dp[i] - ((e & 1) ? ds.y : ds.x));
    }
  }
}

template <int DP, int BQ, int STAGES, int PART>
__global__ void __launch_bounds__(THREADS, 1)
    dkv_tf32_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mdo,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    const __grid_constant__ CUtensorMap mlse,
                    const __grid_constant__ CUtensorMap mdl, Params p) {
  using P = DkvPlan<DP, BQ, STAGES, PART>;
  constexpr bool DK = P::DK, DV = P::DV;
  constexpr int KB = P::K_BYTES, TB = P::T_BYTES;
  constexpr int STAT_HALF = stat_half<BQ>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = flash::align1024(smem_raw);
  uint8_t* k_s = smem;  // K, K lo, (V, V lo)
  uint8_t* stages = smem + P::RESIDENT;
  uint8_t* stats = stages + STAGES * P::STAGE;
  const uint32_t kv_full = hg::smem_u32(stats + STAGES * P::STATS);
  const uint32_t kv_ready = kv_full + 8;
  const uint32_t full0 = kv_ready + 8;
  const uint32_t ready0 = full0 + 8 * STAGES;
  const uint32_t empty0 = ready0 + 8 * STAGES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int k0 = blockIdx.z * ROWS;  // the first key tiles see the most
  const int n_q = (p.tq + BQ - 1) / BQ;
  // the first query tile (causal: the first whose last row sees key k0),
  // and the first from which no causal mask bites; the ragged last tile
  // keeps its mask
  int j0 = 0, j_free = 0;
  if (p.causal) {
    const int x = p.k_off + k0 - p.q_off - BQ + 1;
    j0 = x <= 0 ? 0 : (x + BQ - 1) / BQ;
    const int y = p.k_off + k0 + ROWS - 1 - p.q_off;
    j_free = max(j0, y <= 0 ? 0 : (y + BQ - 1) / BQ);
  }
  const int j_end_free = p.tq / BQ;

  if (tid == 0) {
    hg::mbar_init(kv_full, 1);
    hg::mbar_init(kv_ready, SPLIT_THREADS);
    for (int s = 0; s < STAGES; ++s) {
      hg::mbar_init(full0 + 8 * s, 1);
      hg::mbar_init(ready0 + 8 * s, SPLIT_THREADS);
      hg::mbar_init(empty0 + 8 * s, 4);
    }
    hg::mbar_fence_init();
  }
  __syncthreads();

  if (warp == TMA_WARP) {
    if (lane != 0 || j0 >= n_q) return;
    hg::tma_prefetch(&mq);
    hg::tma_prefetch(&mdo);
    hg::tma_prefetch(&mk);
    if constexpr (DK) hg::tma_prefetch(&mv);
    hg::tma_prefetch(&mlse);
    hg::tma_prefetch(&mdl);
    hg::mbar_expect_tx(kv_full, (DK ? 2 : 1) * KB);
#pragma unroll
    for (int c = 0; c < DP / BLOCK; ++c) {
      hg::tma_load_4d(hg::smem_u32(k_s + c * ROWS * 128), &mk, kv_full,
                      BLOCK * c, hh, k0, bb);
      if constexpr (DK)
        hg::tma_load_4d(hg::smem_u32(k_s + 2 * KB + c * ROWS * 128), &mv,
                        kv_full, BLOCK * c, hh, k0, bb);
    }
    const int bh = bb * p.h + hh;
    for (int j = j0; j < n_q; ++j) {
      const int idx = j - j0;
      const int s = idx % STAGES;
      uint8_t* st = stages + s * P::STAGE;
      const uint32_t full = full0 + 8 * s;
      hg::mbar_wait(empty0 + 8 * s, ((idx / STAGES) & 1) ^ 1);
      hg::mbar_expect_tx(full, 2 * TB + 2 * BQ * 4);
#pragma unroll
      for (int c = 0; c < DP / BLOCK; ++c) {
        hg::tma_load_4d(hg::smem_u32(st + c * BQ * 128), &mq, full,
                        BLOCK * c, hh, j * BQ, bb);
        hg::tma_load_4d(hg::smem_u32(st + 2 * TB + c * BQ * 128), &mdo, full,
                        BLOCK * c, hh, j * BQ, bb);
      }
      uint8_t* rows = stats + s * P::STATS;
      hg::tma_load_2d(hg::smem_u32(rows), &mlse, full, j * BQ, bh);
      hg::tma_load_2d(hg::smem_u32(rows + STAT_HALF), &mdl, full, j * BQ,
                      bh);
    }
    return;
  }

  if (warp >= 4) {
    // ---- split warps ----
    const int ptid = tid - 128;
    if (j0 >= n_q) return;
    hg::mbar_wait(kv_full, 0);
    split_tile<ROWS, DP, true, false>(k_s, k_s + KB, nullptr, nullptr, ptid);
    if constexpr (DK)
      split_tile<ROWS, DP, true, false>(k_s + 2 * KB, k_s + 3 * KB, nullptr,
                                        nullptr, ptid);
    hg::fence_proxy_async();
    hg::mbar_arrive(kv_ready);
    for (int j = j0; j < n_q; ++j) {
      const int idx = j - j0;
      const int s = idx % STAGES;
      uint8_t* st = stages + s * P::STAGE;
      hg::mbar_wait(full0 + 8 * s, (idx / STAGES) & 1);
      split_tile<BQ, DP, true, DK>(st, st + TB, st + P::QT,
                                   st + P::QT + TB, ptid);
      split_tile<BQ, DP, DK, DV>(st + 2 * TB, st + P::DO_LO, st + P::DOT,
                                 st + P::DOT + TB, ptid);
      hg::fence_proxy_async();
      hg::mbar_arrive(ready0 + 8 * s);
    }
    return;
  }

  // ---- consumers: key rows k0 .. k0 + 63 ----
  const int g = lane >> 2;
  const int t = lane & 3;
  const int krow0 = k0 + warp * 16 + g;  // and krow0 + 8
  float dk[DK ? DP / 2 : 1], dv[DV ? DP / 2 : 1];
  float pk[DK ? DP / 2 : 1], pv[DV ? DP / 2 : 1];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    if constexpr (DK) dk[i] = pk[i] = 0.0f;
    if constexpr (DV) dv[i] = pv[i] = 0.0f;
  }
  if (j0 < n_q) hg::mbar_wait(kv_ready, 0);
  const uint32_t ka = hg::smem_u32(k_s);
  for (int j = j0; j < n_q; ++j) {
    const int idx = j - j0;
    const int s = idx % STAGES;
    hg::mbar_wait(ready0 + 8 * s, (idx / STAGES) & 1);
    uint8_t* st = stages + s * P::STAGE;
    const uint32_t qb = hg::smem_u32(st);
    const float* stat = reinterpret_cast<const float*>(stats + s * P::STATS);
    // S^T = K Q^T and (dK) dP^T = V dO^T
    float sc[BQ / 2], dp[BQ / 2];
    hg::wgmma_fence();
    product_ss<BQ, ROWS, DP>(sc, ka, ka + KB, qb, qb + TB, true);
    if constexpr (DK)
      product_ss<BQ, ROWS, DP>(dp, ka + 2 * KB, ka + 3 * KB, qb + 2 * TB,
                               qb + P::DO_LO, true);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs(sc);
    if constexpr (DK) hg::fence_regs(dp);

    if (j >= j_free && j < j_end_free)
      dkv_p_ds<BQ, false, DK>(sc, dp, stat, stat + STAT_HALF / 4, p.scale,
                              j * BQ, p.tq, p.causal, p.q_off,
                              p.k_off + krow0, t);
    else
      dkv_p_ds<BQ, true, DK>(sc, dp, stat, stat + STAT_HALF / 4, p.scale,
                             j * BQ, p.tq, p.causal, p.q_off,
                             p.k_off + krow0, t);

    // the tile's P^T dO and dS^T Q into zeroed partials, joined by f32 adds
    uint32_t ph[BQ / 8][4], pl[BQ / 8][4], dh[BQ / 8][4], dlo[BQ / 8][4];
    if constexpr (DV)
      product_rs<DP, BQ>(pv, sc, ph, pl, qb + P::DOT, qb + P::DOT + TB);
    if constexpr (DK)
      product_rs<DP, BQ>(pk, dp, dh, dlo, qb + P::QT, qb + P::QT + TB);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    if constexpr (DV) {
      hg::fence_regs(pv);
      fence_frags<BQ>(ph);
      fence_frags<BQ>(pl);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dv[i] += pv[i];
    }
    if constexpr (DK) {
      hg::fence_regs(pk);
      fence_frags<BQ>(dh);
      fence_frags<BQ>(dlo);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dk[i] += pk[i];
    }
    if (lane == 0) hg::mbar_arrive(empty0 + 8 * s);
  }

  const long long stride = (long long)p.h * p.d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow0 + 8 * r;
    if (row >= p.tk) continue;
    const long long at = ((long long)bb * p.tk + row) * stride +
                         (long long)hh * p.d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= p.d) continue;
      if constexpr (DK)
        store2(p.dk + at + col, dk[4 * j + 2 * r] * p.scale,
               dk[4 * j + 2 * r + 1] * p.scale);
      if constexpr (DV)
        store2(p.dv + at + col, dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// ---- host --------------------------------------------------------------------

template <int DP, int BK, int STAGES>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              Params p, int b, cudaStream_t stream) {
  CUtensorMap mq, mdo, mk, mv;
  int rc = flash::map_bthd<float>(&mq, q, b, p.tq, p.h, p.d, ROWS);
  if (rc == 0) rc = flash::map_bthd<float>(&mdo, dout, b, p.tq, p.h, p.d, ROWS);
  if (rc == 0) rc = flash::map_bthd<float>(&mk, k, b, p.tk, p.h, p.d, BK);
  if (rc == 0) rc = flash::map_bthd<float>(&mv, v, b, p.tk, p.h, p.d, BK);
  if (rc != 0) return rc;
  auto kernel = dq_tf32_kernel<DP, BK, STAGES>;
  constexpr int smem = DqPlan<DP, BK, STAGES>::SMEM;
  static bool done = false;
  rc = flash::configure(kernel, smem, &done);
  if (rc != 0) return rc;
  p.tiles = (p.tq + ROWS - 1) / ROWS;
  dim3 grid((unsigned)p.h, (unsigned)b, (unsigned)p.tiles);
  kernel<<<grid, THREADS, smem, stream>>>(mq, mdo, mk, mv, p);
  return (int)cudaGetLastError();
}

template <int DP, int BQ, int STAGES, int PART>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               Params p, int b, cudaStream_t stream) {
  CUtensorMap mq, mdo, mk, mv, mlse, mdl;
  int rc = flash::map_bthd<float>(&mq, q, b, p.tq, p.h, p.d, BQ);
  if (rc == 0) rc = flash::map_bthd<float>(&mdo, dout, b, p.tq, p.h, p.d, BQ);
  if (rc == 0) rc = flash::map_bthd<float>(&mk, k, b, p.tk, p.h, p.d, ROWS);
  if (rc == 0) rc = flash::map_bthd<float>(&mv, v, b, p.tk, p.h, p.d, ROWS);
  if (rc == 0) rc = flash::map_stats(&mlse, p.lse, b * p.h, p.tq, BQ);
  if (rc == 0) rc = flash::map_stats(&mdl, p.delta, b * p.h, p.tq, BQ);
  if (rc != 0) return rc;
  auto kernel = dkv_tf32_kernel<DP, BQ, STAGES, PART>;
  constexpr int smem = DkvPlan<DP, BQ, STAGES, PART>::SMEM;
  static bool done = false;
  rc = flash::configure(kernel, smem, &done);
  if (rc != 0) return rc;
  p.tiles = (p.tk + ROWS - 1) / ROWS;
  dim3 grid((unsigned)p.h, (unsigned)b, (unsigned)p.tiles);
  kernel<<<grid, THREADS, smem, stream>>>(mq, mdo, mk, mv, mlse, mdl, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The entry points take f32 operands and write f32 outputs, with the
// operand rules of the bf16 kernels: D a multiple of 16 up to 128, Tq and
// Tk multiples of 8, 16-byte aligned pointers. Each returns the CUDA error
// code.

// K8: dq [B, Tq, H, D] from q, dout [B, Tq, H, D], k, v [B, Tk, H, D] and
// lse, delta [B, H, Tq].
extern "C" int flash_tf32_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int b, int h,
                                 int tq, int tk, int d, int q_off, int k_off,
                                 float scale, int causal, void* stream) {
  if (bad_head_dim(d)) return (int)cudaErrorInvalidValue;
  Params p{static_cast<float*>(dq), nullptr, nullptr,
           static_cast<const float*>(lse), static_cast<const float*>(delta),
           h, tq, tk, d, q_off, k_off, causal ? 1 : 0, 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_dq<64, 32, 2>(q, k, v, dout, p, b, s);
  return launch_dq<128, 32, 1>(q, k, v, dout, p, b, s);
}

// K9: dk, dv [B, Tk, H, D]; at D > 64 two kernel launches (dV, then dK).
extern "C" int flash_tf32_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int b, int h, int tq, int tk, int d,
                                  int q_off, int k_off, float scale,
                                  int causal, void* stream) {
  if (bad_head_dim(d)) return (int)cudaErrorInvalidValue;
  Params p{nullptr, static_cast<float*>(dk), static_cast<float*>(dv),
           static_cast<const float*>(lse), static_cast<const float*>(delta),
           h, tq, tk, d, q_off, k_off, causal ? 1 : 0, 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_dkv<64, 32, 2, kDV | kDK>(q, k, v, dout, p, b, s);
  const int rc = launch_dkv<128, 32, 2, kDV>(q, k, v, dout, p, b, s);
  return rc != 0 ? rc : launch_dkv<128, 32, 1, kDK>(q, k, v, dout, p, b, s);
}
