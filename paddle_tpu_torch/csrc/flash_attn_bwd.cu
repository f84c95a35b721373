// Flash-attention backward: dQ (K8) and dK/dV (K9) on Hopper's wgmma with
// TMA loads, bf16, for sm_90a.
//
// Replace the TPU kernels paddle_tpu/ops/pallas_attention.py `_dq_kernel`
// (:295) and `_dkv_kernel` (:342), both reached through
// `flash_attention_bwd_block` (:395). Same function: from q, k, v, dO
// [B, T, H, D] bf16 and lse, delta [B, H, Tq] f32 (delta = rowsum(dO o O),
// computed by the caller), with P = exp(scale * Q K^T [mask] - LSE) and
// dS = P o (dO V^T - delta):
//   K8: dQ = scale * dS K                       (in q's dtype, bf16)
//   K9: dV = P^T dO, dK = scale * dS^T Q        (in k's and v's, bf16)
// The caller replaces a non-finite LSE by 1e30 first (the reference's :419),
// so such rows give P = 0.
//
// Design. Two kernels, each owning its output tile, so every output element
// is written by one CTA, without atomics, and a repeated call is bitwise
// equal. Both have the forward's shape (flash_attn_fwd.cu): one producer
// warp (one thread) keeps a 2-stage ring of TMA loads full under
// full/empty mbarrier pairs (4-D maps over [B, T, H, D] in place), and
// consumer warpgroups of 64 resident rows run every product on wgmma, with
// the rounded P and dS fed from registers.
// - K8: a CTA owns 64 query rows per consumer warpgroup (one at D <= 64,
//   three CTAs an SM, which timed faster than one CTA of two; two at
//   D <= 128); Q and dO are loaded once, K and V tiles of BK keys stream
//   (the reference's sequential K axis is the loop). Per
//   tile: S = Q K^T and dP = dO V^T (both operands K-major), then dQ +=
//   bf16(dS) K with K as the MN-major B operand. LSE and delta of the two
//   rows a thread holds are read once from memory. Grid: the last query
//   tiles (the most key tiles under the causal mask) first.
// - K9: a CTA owns 64 key rows (one consumer warpgroup); K and V are
//   loaded once, Q and dO tiles of BQ queries stream with their LSE and
//   delta rows (through the same ring, by 2-D maps over [B*H, Tq]). Per
//   tile: S^T = K Q^T and dP^T = V dO^T (K-major), then dV += bf16(P^T) dO
//   and dK += bf16(dS^T) Q, dO and Q as the MN-major B operand. Grid: the
//   first key tiles (the most query tiles under the causal mask) first.
// Causal tiles wholly on the masked side are not visited (the reference's
// pl.when at :332 and :383); each warpgroup splits its loop into the tiles
// that need the per-element mask (the diagonal, the ragged end) and those
// that do not. Tile sizes keep every accumulator in registers (ptxas
// reports no spill): K8 streams 64 keys (128 registers a thread at D 64,
// 164 at D 128). K9's dK and dV take D f32 registers a thread, so
// its CTA is one warpgroup (160 threads): at D <= 64 two share an SM (168
// registers) with 48-query tiles; at D <= 128 one does (255 registers)
// with 32-query tiles. Two warpgroups per K9 CTA held only 32-query tiles
// without a spill, and timed slower at D 64.
//
// Arithmetic, at the reference's rounding points: S in f32, times scale
// (rounded, never fused); P = exp(S - LSE) in f32 (as ex2((S - LSE) *
// log2 e)); dP = dO V^T in f32; P (for dV) and dS (for dQ and dK) rounded
// to bf16 before their products; dQ and dK scaled at the end and rounded
// once, dV rounded once.
//
// Bound on an H100: causal at the bench shape [8, 2048, 8, 64], K8 does 3
// products of 2*T^2*D/2 per (b, h), 51.5 GFLOP (0.052 ms at 989 TF/s
// bf16); K9 does 4, 68.7 GFLOP (0.069 ms). Their bytes (q, k, v, dO, lse,
// delta in, one or two [B, T, H, D] out) take 0.01-0.015 ms at 3.35 TB/s:
// both are operation-bound. What still holds them back: as in the forward,
// no warpgroup overlaps its own products with its elementwise work, and
// K9's short query tiles keep its S^T and dP^T products at wgmma N 48 or
// 32.

#include "flash_attn_common.cuh"

namespace {

using flash::LOG2E;
using flash::MASKED;
using hg::bf16;

constexpr int STAGES = 2;

struct Params {
  bf16* dq;            // [B, Tq, H, D]  K8
  bf16* dk;            // [B, Tk, H, D]  K9
  bf16* dv;            // [B, Tk, H, D]  K9
  const float* lse;    // [B, H, Tq]     K8 (K9 reads them by TMA)
  const float* delta;  // [B, H, Tq]
  int h, tq, tk, d, q_off, k_off, causal, tiles;
  float scale;
};

// K8 --------------------------------------------------------------------------

// A K8 CTA: NWG consumer warpgroups of 64 query rows each and one
// producer warp; one (NWG 2) or 2-3 (NWG 1) CTAs an SM, as in the forward.
constexpr int dq_min_blocks(int nwg, int dp) {
  return nwg == 2 ? 1 : dp <= 64 ? 3 : 2;
}

template <int DP, int BK, int NWG>
constexpr int dq_smem_bytes() {
  return 1024 + 2 * NWG * 64 * DP * 2 + 2 * STAGES * BK * DP * 2 +
         (1 + 2 * STAGES) * 8;
}

// dS for one key tile of K8 on the accumulator layout, in place of s; dp
// is dO V^T. MASK: keys past Tk score -inf, causal keys past the row -1e30.
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
    const float pe = flash::ex2((v - lse[r]) * LOG2E);
    s[i] = pe * (dp[i] - dl[r]);
  }
}

template <int DP, int BK, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, dq_min_blocks(NWG, DP))
    flash_dq_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mdo,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv, Params p) {
  constexpr int ROWS = NWG * 64;          // query rows of the CTA
  constexpr int Q_BLOCK = ROWS * 128;     // a 64-column block of Q or dO
  constexpr int Q_BYTES = DP / 64 * Q_BLOCK;
  constexpr int KV_BLOCK = BK * 128;
  constexpr int KV_BYTES = DP / 64 * KV_BLOCK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = flash::align1024(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* do_s = q_s + Q_BYTES;
  uint8_t* k_s = do_s + Q_BYTES;
  uint8_t* v_s = k_s + STAGES * KV_BYTES;
  const uint32_t q_full = hg::smem_u32(v_s + STAGES * KV_BYTES);
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int q0 = (p.tiles - 1 - (int)blockIdx.z) * ROWS;  // heaviest first
  // each warpgroup's key tiles, and how many of them no mask reaches
  int n[2] = {0, 0}, n_free[2] = {0, 0};
#pragma unroll
  for (int w = 0; w < NWG; ++w) {
    const int first = q0 + 64 * w;
    n[w] = n_free[w] = 0;
    if (first < p.tq) {
      const int last = min(first + 64, p.tq) - 1;
      n[w] = flash::key_tiles(p.tk, BK, p.causal, last, p.q_off, p.k_off);
      n_free[w] = p.tk / BK;
      if (p.causal) {
        const int x = p.q_off + first - p.k_off + 1;
        n_free[w] = min(n_free[w], x <= 0 ? 0 : x / BK);
      }
    }
  }
  const int n_cta = max(n[0], n[1]);

  if (tid == 0) {
    hg::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hg::mbar_init(full0 + 8 * s, 1);
      hg::mbar_init(empty0 + 8 * s, 4 * NWG);  // one per consumer warp
    }
    hg::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    if (lane != 0 || n_cta == 0) return;
    hg::tma_prefetch(&mq);
    hg::tma_prefetch(&mdo);
    hg::tma_prefetch(&mk);
    hg::tma_prefetch(&mv);
    hg::mbar_expect_tx(q_full, 2 * Q_BYTES);
#pragma unroll
    for (int c = 0; c < DP / 64; ++c) {
      hg::tma_load_4d(hg::smem_u32(q_s + c * Q_BLOCK), &mq, q_full, 64 * c,
                      hh, q0, bb);
      hg::tma_load_4d(hg::smem_u32(do_s + c * Q_BLOCK), &mdo, q_full, 64 * c,
                      hh, q0, bb);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < n_cta; ++j) {
      const uint32_t full = full0 + 8 * stage;
      hg::mbar_wait(empty0 + 8 * stage, phase ^ 1);
      hg::mbar_expect_tx(full, 2 * KV_BYTES);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c) {
        hg::tma_load_4d(hg::smem_u32(k_s + stage * KV_BYTES + c * KV_BLOCK),
                        &mk, full, 64 * c, hh, j * BK, bb);
        hg::tma_load_4d(hg::smem_u32(v_s + stage * KV_BYTES + c * KV_BLOCK),
                        &mv, full, 64 * c, hh, j * BK, bb);
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int nw = wg ? n[1] : n[0];
  const int nf = wg ? n_free[1] : n_free[0];
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + wg * 64 + (warp & 3) * 16 + g;  // and row0 + 8
  const long long stat = ((long long)bb * p.h + hh) * p.tq;
  float lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row0 + 8 * r < p.tq;
    lse[r] = ok ? p.lse[stat + row0 + 8 * r] : 0.0f;
    dl[r] = ok ? p.delta[stat + row0 + 8 * r] : 0.0f;
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  if (nw > 0) hg::mbar_wait(q_full, 0);
  const uint32_t qa = hg::smem_u32(q_s) + wg * 64 * 128;
  const uint32_t doa = hg::smem_u32(do_s) + wg * 64 * 128;
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < n_cta; ++j) {
    hg::mbar_wait(full0 + 8 * stage, phase);
    if (j < nw) {
      const uint32_t kb = hg::smem_u32(k_s + stage * KV_BYTES);
      const uint32_t vb = hg::smem_u32(v_s + stage * KV_BYTES);
      float s[BK / 2], dp[BK / 2];
      hg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        hg::wgmma_ss<BK, 0, 0>(
            s, hg::desc_sw128(qa + (kk >> 2) * Q_BLOCK + off, 16, 1024),
            hg::desc_sw128(kb + (kk >> 2) * KV_BLOCK + off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        hg::wgmma_ss<BK, 0, 0>(
            dp, hg::desc_sw128(doa + (kk >> 2) * Q_BLOCK + off, 16, 1024),
            hg::desc_sw128(vb + (kk >> 2) * KV_BLOCK + off, 16, 1024), kk > 0);
      }
      hg::wgmma_commit();
      hg::wgmma_wait<0>();
      hg::fence_regs(s);
      hg::fence_regs(dp);

      if (j < nf)
        dq_ds<BK, false>(s, dp, lse, dl, p.scale, j * BK, p.tk, p.causal,
                         p.q_off + row0, p.k_off, t);
      else
        dq_ds<BK, true>(s, dp, lse, dl, p.scale, j * BK, p.tk, p.causal,
                        p.q_off + row0, p.k_off, t);

      // dQ += bf16(dS) K, K the MN-major B operand
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) flash::acc_to_a<BK>(da[kk], s, kk);
      hg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hg::wgmma_rs<DP, 1>(acc, da[kk],
                            hg::desc_sw128(kb + kk * 2048, KV_BLOCK, 1024), 1);
      hg::wgmma_commit();
      hg::wgmma_wait<0>();
      hg::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) hg::fence_regs(da[kk]);
    }
    if (lane == 0) hg::mbar_arrive(empty0 + 8 * stage);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  const long long stride = (long long)p.h * p.d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.tq) continue;
    bf16* out = p.dq + ((long long)bb * p.tq + row) * stride +
                (long long)hh * p.d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < p.d)
        *reinterpret_cast<uint32_t*>(out + col) = flash::pack_rn(
            acc[4 * j + 2 * r] * p.scale, acc[4 * j + 2 * r + 1] * p.scale);
    }
  }
}

// K9 --------------------------------------------------------------------------

// A K9 CTA: one consumer warpgroup of 64 key rows and one producer warp
// (160 threads). At D <= 64 two share an SM: ten warps put three on some
// of the SM's four register partitions, so 168 registers a thread, which
// 48-query tiles fit (dK, dV, S^T, dP^T: 112 f32 a thread). At D <= 128
// dK and dV alone are 128 f32 a thread: one CTA an SM, 255 registers.
constexpr int DKV_THREADS = 160;

constexpr int dkv_min_blocks(int dp) { return dp <= 64 ? 2 : 1; }

// The LSE and delta rows of a query tile, each on a 128-byte boundary.
template <int BQ>
__host__ __device__ constexpr int stat_half() {
  return (BQ * 4 + 127) / 128 * 128;
}

template <int DP, int BQ>
constexpr int dkv_smem_bytes() {
  return 1024 + 2 * 64 * DP * 2 + 2 * STAGES * BQ * DP * 2 +
         STAGES * 2 * stat_half<BQ>() + (1 + 2 * STAGES) * 8;
}

// P^T (in s) and dS^T (in dp) for one query tile of K9, whose columns'
// LSE and delta are lse_s and dl_s. MASK: queries past Tq score -inf,
// causal queries before the key -1e30.
template <int BQ, bool MASK>
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
      const float pe = flash::ex2((v - ((e & 1) ? ls.y : ls.x)) * LOG2E);
      s[i] = pe;
      dp[i] = pe * (dp[i] - ((e & 1) ? ds.y : ds.x));
    }
  }
}

template <int DP, int BQ>
__global__ void __launch_bounds__(DKV_THREADS, dkv_min_blocks(DP))
    flash_dkv_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mdo,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     const __grid_constant__ CUtensorMap mlse,
                     const __grid_constant__ CUtensorMap mdl, Params p) {
  constexpr int K_BLOCK = 64 * 128;   // a 64-column block of K or V
  constexpr int K_BYTES = DP / 64 * K_BLOCK;
  constexpr int Q_BLOCK = BQ * 128;   // ... of a Q or dO tile
  constexpr int Q_BYTES = DP / 64 * Q_BLOCK;
  constexpr int STAT_HALF = stat_half<BQ>();
  constexpr int STAT_BYTES = 2 * STAT_HALF;  // a tile's LSE, then delta
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = flash::align1024(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = k_s + K_BYTES;
  uint8_t* q_s = v_s + K_BYTES;
  uint8_t* do_s = q_s + STAGES * Q_BYTES;
  uint8_t* st_s = do_s + STAGES * Q_BYTES;
  const uint32_t kv_full = hg::smem_u32(st_s + STAGES * STAT_BYTES);
  const uint32_t full0 = kv_full + 8;
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int k0 = blockIdx.z * 64;  // the first key tiles see the most
  const int n_q = (p.tq + BQ - 1) / BQ;
  // the first query tile (causal: the first whose last row sees key k0),
  // and the first from which no causal mask bites (every query of the tile
  // at or past the last key); the ragged last tile keeps its mask
  int j0 = 0, j_free = 0;
  if (p.causal) {
    const int x = p.k_off + k0 - p.q_off - BQ + 1;
    j0 = x <= 0 ? 0 : (x + BQ - 1) / BQ;
    const int y = p.k_off + k0 + 63 - p.q_off;
    j_free = max(j0, y <= 0 ? 0 : (y + BQ - 1) / BQ);
  }
  const int j_end_free = p.tq / BQ;

  if (tid == 0) {
    hg::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hg::mbar_init(full0 + 8 * s, 1);
      hg::mbar_init(empty0 + 8 * s, 4);  // one arrival per consumer warp
    }
    hg::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {
    // ---- producer warp: one thread issues every load ----
    if (lane != 0 || j0 >= n_q) return;
    hg::tma_prefetch(&mq);
    hg::tma_prefetch(&mdo);
    hg::tma_prefetch(&mk);
    hg::tma_prefetch(&mv);
    hg::tma_prefetch(&mlse);
    hg::tma_prefetch(&mdl);
    hg::mbar_expect_tx(kv_full, 2 * K_BYTES);
#pragma unroll
    for (int c = 0; c < DP / 64; ++c) {
      hg::tma_load_4d(hg::smem_u32(k_s + c * K_BLOCK), &mk, kv_full, 64 * c,
                      hh, k0, bb);
      hg::tma_load_4d(hg::smem_u32(v_s + c * K_BLOCK), &mv, kv_full, 64 * c,
                      hh, k0, bb);
    }
    const int bh = bb * p.h + hh;
    int stage = 0;
    uint32_t phase = 0;
    for (int j = j0; j < n_q; ++j) {
      const uint32_t full = full0 + 8 * stage;
      hg::mbar_wait(empty0 + 8 * stage, phase ^ 1);
      hg::mbar_expect_tx(full, 2 * Q_BYTES + 2 * BQ * 4);
#pragma unroll
      for (int c = 0; c < DP / 64; ++c) {
        hg::tma_load_4d(hg::smem_u32(q_s + stage * Q_BYTES + c * Q_BLOCK),
                        &mq, full, 64 * c, hh, j * BQ, bb);
        hg::tma_load_4d(hg::smem_u32(do_s + stage * Q_BYTES + c * Q_BLOCK),
                        &mdo, full, 64 * c, hh, j * BQ, bb);
      }
      uint8_t* st = st_s + stage * STAT_BYTES;
      hg::tma_load_2d(hg::smem_u32(st), &mlse, full, j * BQ, bh);
      hg::tma_load_2d(hg::smem_u32(st + STAT_HALF), &mdl, full, j * BQ, bh);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- consumers: key rows k0 .. k0 + 64 ----
  const int g = lane >> 2;
  const int t = lane & 3;
  const int krow0 = k0 + warp * 16 + g;  // and krow0 + 8
  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.0f;
  if (j0 < n_q) hg::mbar_wait(kv_full, 0);
  const uint32_t ka = hg::smem_u32(k_s);
  const uint32_t va = hg::smem_u32(v_s);
  int stage = 0;
  uint32_t phase = 0;
  for (int j = j0; j < n_q; ++j) {
    hg::mbar_wait(full0 + 8 * stage, phase);
    const uint32_t qb = hg::smem_u32(q_s + stage * Q_BYTES);
    const uint32_t dob = hg::smem_u32(do_s + stage * Q_BYTES);
    const float* st =
        reinterpret_cast<const float*>(st_s + stage * STAT_BYTES);
    // S^T = K Q^T and dP^T = V dO^T, both operands K-major
    float s[BQ / 2], dp[BQ / 2];
    hg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      hg::wgmma_ss<BQ, 0, 0>(
          s, hg::desc_sw128(ka + (kk >> 2) * K_BLOCK + off, 16, 1024),
          hg::desc_sw128(qb + (kk >> 2) * Q_BLOCK + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      hg::wgmma_ss<BQ, 0, 0>(
          dp, hg::desc_sw128(va + (kk >> 2) * K_BLOCK + off, 16, 1024),
          hg::desc_sw128(dob + (kk >> 2) * Q_BLOCK + off, 16, 1024), kk > 0);
    }
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs(s);
    hg::fence_regs(dp);

    if (j >= j_free && j < j_end_free)
      dkv_p_ds<BQ, false>(s, dp, st, st + STAT_HALF / 4, p.scale, j * BQ,
                          p.tq, p.causal, p.q_off, p.k_off + krow0, t);
    else
      dkv_p_ds<BQ, true>(s, dp, st, st + STAT_HALF / 4, p.scale, j * BQ, p.tq,
                         p.causal, p.q_off, p.k_off + krow0, t);

    // dV += bf16(P^T) dO, dK += bf16(dS^T) Q; dO and Q MN-major, their
    // 64-column blocks Q_BLOCK apart, 16 queries = 2048 bytes a k16 step
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      flash::acc_to_a<BQ>(pa[kk], s, kk);
      flash::acc_to_a<BQ>(da[kk], dp, kk);
    }
    hg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hg::wgmma_rs<DP, 1>(dv, pa[kk],
                          hg::desc_sw128(dob + kk * 2048, Q_BLOCK, 1024), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hg::wgmma_rs<DP, 1>(dk, da[kk],
                          hg::desc_sw128(qb + kk * 2048, Q_BLOCK, 1024), 1);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs(dv);
    hg::fence_regs(dk);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      hg::fence_regs(pa[kk]);
      hg::fence_regs(da[kk]);
    }
    if (lane == 0) hg::mbar_arrive(empty0 + 8 * stage);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
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
      if (col < p.d) {
        *reinterpret_cast<uint32_t*>(p.dk + at + col) = flash::pack_rn(
            dk[4 * j + 2 * r] * p.scale, dk[4 * j + 2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(p.dv + at + col) =
            flash::pack_rn(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ---- host --------------------------------------------------------------------

template <int DP, int BK, int NWG>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              Params p, int b, cudaStream_t stream) {
  constexpr int ROWS = NWG * 64;
  CUtensorMap mq, mdo, mk, mv;
  int rc = flash::map_bthd(&mq, q, b, p.tq, p.h, p.d, ROWS);
  if (rc == 0) rc = flash::map_bthd(&mdo, dout, b, p.tq, p.h, p.d, ROWS);
  if (rc == 0) rc = flash::map_bthd(&mk, k, b, p.tk, p.h, p.d, BK);
  if (rc == 0) rc = flash::map_bthd(&mv, v, b, p.tk, p.h, p.d, BK);
  if (rc != 0) return rc;
  auto kernel = flash_dq_kernel<DP, BK, NWG>;
  constexpr int smem = dq_smem_bytes<DP, BK, NWG>();
  static bool done = false;
  rc = flash::configure(kernel, smem, &done);
  if (rc != 0) return rc;
  p.tiles = (p.tq + ROWS - 1) / ROWS;
  dim3 grid((unsigned)p.h, (unsigned)b, (unsigned)p.tiles);
  kernel<<<grid, NWG * 128 + 32, smem, stream>>>(mq, mdo, mk, mv, p);
  return (int)cudaGetLastError();
}

template <int DP, int BQ>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               Params p, int b, cudaStream_t stream) {
  CUtensorMap mq, mdo, mk, mv, mlse, mdl;
  int rc = flash::map_bthd(&mq, q, b, p.tq, p.h, p.d, BQ);
  if (rc == 0) rc = flash::map_bthd(&mdo, dout, b, p.tq, p.h, p.d, BQ);
  if (rc == 0) rc = flash::map_bthd(&mk, k, b, p.tk, p.h, p.d, 64);
  if (rc == 0) rc = flash::map_bthd(&mv, v, b, p.tk, p.h, p.d, 64);
  if (rc == 0) rc = flash::map_stats(&mlse, p.lse, b * p.h, p.tq, BQ);
  if (rc == 0) rc = flash::map_stats(&mdl, p.delta, b * p.h, p.tq, BQ);
  if (rc != 0) return rc;
  auto kernel = flash_dkv_kernel<DP, BQ>;
  constexpr int smem = dkv_smem_bytes<DP, BQ>();
  static bool done = false;
  rc = flash::configure(kernel, smem, &done);
  if (rc != 0) return rc;
  p.tiles = (p.tk + 63) / 64;
  dim3 grid((unsigned)p.h, (unsigned)b, (unsigned)p.tiles);
  kernel<<<grid, DKV_THREADS, smem, stream>>>(mq, mdo, mk, mv, mlse, mdl, p);
  return (int)cudaGetLastError();
}

bool bad_head_dim(int d) { return d % 16 != 0 || d > 128 || d <= 0; }

}  // namespace

// K8: dq [B, Tq, H, D] bf16 from q, dout [B, Tq, H, D], k, v [B, Tk, H, D]
// bf16 and lse, delta [B, H, Tq] f32; D a multiple of 16 up to 128, Tq and
// Tk multiples of 8, 16-byte aligned pointers. Key tiles of 64, one
// warpgroup a CTA at D <= 64, two above. Returns the CUDA error code.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int b, int h,
                                 int tq, int tk, int d, int q_off, int k_off,
                                 float scale, int causal, void* stream) {
  if (bad_head_dim(d)) return (int)cudaErrorInvalidValue;
  Params p{static_cast<bf16*>(dq), nullptr, nullptr,
           static_cast<const float*>(lse), static_cast<const float*>(delta),
           h, tq, tk, d, q_off, k_off, causal ? 1 : 0, 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_dq<64, 64, 1>(q, k, v, dout, p, b, s);
  return launch_dq<128, 64, 2>(q, k, v, dout, p, b, s);
}

// K9: dk, dv [B, Tk, H, D] bf16; query tiles of 48 at D <= 64, of 32
// above, one warpgroup a CTA. Otherwise as K8. Returns the CUDA error code.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int b,
                                  int h, int tq, int tk, int d, int q_off,
                                  int k_off, float scale, int causal,
                                  void* stream) {
  if (bad_head_dim(d)) return (int)cudaErrorInvalidValue;
  Params p{nullptr, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
           static_cast<const float*>(lse), static_cast<const float*>(delta),
           h, tq, tk, d, q_off, k_off, causal ? 1 : 0, 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_dkv<64, 48>(q, k, v, dout, p, b, s);
  return launch_dkv<128, 32>(q, k, v, dout, p, b, s);
}
