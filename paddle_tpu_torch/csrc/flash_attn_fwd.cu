// Flash-attention forward (K7) and the ring's unnormalized forward block
// (K10) on Hopper's wgmma with TMA loads, bf16, for sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_attention.py `_fwd_kernel`
// (:143) in both its forms. K7, normalize=True, reached through `_forward`
// (:266) -> `_fwd_call` (:225): q, k, v [B, T, H, D] bf16 ->
// O = softmax(scale * Q K^T [causal mask]) V in bf16 and the per-row
// LSE = m + log(l) as [B, H, Tq] f32 (the reference's [B, T, H, 1] stats,
// already transposed). K10, normalize=False, reached through
// `flash_attention_block` (:276) -> `_fwd_call`: the same walk for one
// (query shard, key shard) pair of the ring with global offsets, ending in
// the raw online-softmax state, acc [B, Tq, H, D] f32 and the row max m and
// row sum l as [B, H, Tq] f32 (the reference's [B, T, H, 2] stats, split
// and transposed). One template with a compile-time NORMALIZE flag: only
// the epilogue differs.
//
// Design. A CTA owns 64 query rows of one (head, batch) per consumer
// warpgroup and walks the key tiles (the reference's sequential grid axis)
// with the running (m, l, acc) in registers. Warp roles: one producer warp
// (one thread) issues the TMA loads, the Q tile once and the K and V tiles
// of BK rows into a 3-stage ring under full/empty mbarrier pairs; the
// consumer warpgroups compute. The entry points pick BK and the
// warpgroups from D (`dispatch`): at D <= 64 one warpgroup a CTA, two or
// three CTAs an SM (BK 64 for K7 at T 2048, 128 for K10 at T 32768); at
// D <= 128 two warpgroups a CTA. At D 64 several small CTAs an SM timed faster on the
// card than one CTA of two warpgroups, for K7 and K10 alike: a CTA's
// warpgroups share one ring, so the slower one holds the stages of the
// faster. The tensor maps are 4-D over [B, T, H, D] in place
// (flash_attn_common.cuh `map_bthd`): no transpose, no copy; rows past T
// and columns past D arrive as zeros (D < 64 is padded to one 64-column
// block, 64 < D <= 128 to two). Per key tile and warpgroup:
//   S = Q K^T     wgmma m64nBKk16, both operands K-major from 128-byte
//                 swizzled shared memory;
//   the online softmax on the accumulator layout (each thread holds 2 rows,
//                 the 4 lanes of a quad share a row), in f32;
//   P rounded to bf16 in registers, fed as wgmma's A-from-registers
//                 operand to acc += P V, V the MN-major B operand (the
//                 transpose bit, as K3 reads its operands).
// Masking is paid only where it can bite: each warpgroup splits its key
// loop into a prefix of tiles that no mask reaches and the rest, which
// test each element. The grid puts the query tile in its slowest axis,
// heaviest (last) tiles first, so under the causal mask the longest walks
// start in the first wave.
//
// Visiting. The plain version (and the f32 forms) visit, per 64 query rows,
// against 64-key tiles; a row of a visited tile whose every key is masked
// takes p = exp(-1e30 - -1e30) = 1, the reference's own behaviour. To give
// the same answer with BK-key tiles, each warpgroup (64 rows, the plain
// version's query tile) computes the 64-key tiles it would visit and
// scores every key past them -inf (p = 0, exactly nothing), as it does the
// keys past Tk. A warpgroup that visits nothing keeps (acc, l, m) = (0, 0,
// -1e30), as the Pallas kernel leaves such rows; the ring merge reads
// m > -5e29 as "valid".
//
// Arithmetic, at the reference's rounding points (:25-28): S in f32, times
// scale (rounded, never fused); masked scores -1e30; row max and sum in
// f32; p = exp(S*scale - m) as ex2((S*scale - m) * log2 e); P rounded to
// bf16 before P V; O = acc / max(l, 1e-30) rounded once; LSE = m +
// log(max(l, 1e-30)). The order of the f32 sums differs from the
// reference's and from the plain version's.
//
// Bound on an H100: causal at the bench shape [8, 2048, 8, 64] the work is
// 4*B*H*T^2*D/2 = 34.4 GFLOP against 989 TF/s bf16 (0.035 ms), far above
// its 33.6 MB of q, k, v, o and lse against 3.35 TB/s (0.010 ms):
// operation-bound. K10 at the ring configuration's one-card shape [1, 32768,
// 8, 64] causal does 1.10 TFLOP (1.11 ms) against 0.17 GB (0.05 ms). What
// still holds it back: no warpgroup overlaps its own products with its
// softmax (the SM's warpgroups interleave). Two in-warpgroup overlaps were
// built and timed slower: S_{j+1} in flight during the softmax of tile j,
// and FlashAttention-3's order (the softmax of tile j+1 under P_j V_j);
// ptxas serialized their wgmmas (C7514/C7515: it cannot tell, across a
// wgmma.wait_group 1, which group's accumulators are settled). At D 64 the
// softmax's special-function and elementwise work is as long as the
// products.

#include "flash_attn_common.cuh"

namespace {

using flash::LOG2E;
using flash::MASKED;
using flash::VISIT;
using hg::bf16;

// A CTA: NWG consumer warpgroups of 64 query rows each and one producer
// warp; the SM holds 1 (NWG 2) or 2-3 (NWG 1) of them, as registers allow:
// ten or fifteen warps put three or four on some of the SM's four register
// partitions, so 168 or 128 registers a thread.
constexpr int fwd_min_blocks(int nwg, int dp, int bk) {
  return nwg == 2 ? 1 : dp <= 64 && bk == 64 ? 3 : 2;
}
constexpr int STAGES = 3;     // K/V ring depth

struct Params {
  bf16* o;     // [B, Tq, H, D]      K7
  float* lse;  // [B, H, Tq]         K7
  float* acc;  // [B, Tq, H, D] f32  K10
  float* m;    // [B, H, Tq]         K10
  float* l;    // [B, H, Tq]         K10
  int h, tq, tk, d, q_off, k_off, causal, q_tiles;
  float scale;
};

template <int DP, int BK, int NWG>
constexpr int smem_bytes() {
  return 1024 + NWG * 64 * DP * 2 + 2 * STAGES * BK * DP * 2 +
         (1 + 2 * STAGES) * 8;
}

// How far the 64 query rows from `first` walk: `n` key tiles of bk, the
// first `n_free` of them reached by no mask, keys at or past `lim` (the
// end of the 64-key tiles the plain version visits, or Tk) scored -inf.
struct Walk {
  int n, n_free, lim;
};

__device__ __forceinline__ Walk walk_of(const Params& p, int first, int bk) {
  Walk w{0, 0, 0};
  if (first >= p.tq) return w;
  const int last = min(first + 64, p.tq) - 1;
  const int visit =
      flash::key_tiles(p.tk, VISIT, p.causal, last, p.q_off, p.k_off);
  w.lim = min(p.tk, visit * VISIT);
  w.n = (w.lim + bk - 1) / bk;
  w.n_free = w.lim / bk;
  if (p.causal) {
    // keys [0, x) are visible to every row of the group
    const int x = p.q_off + first - p.k_off + 1;
    w.n_free = min(w.n_free, x <= 0 ? 0 : x / bk);
  }
  return w;
}

// One key tile's online-softmax step on the accumulator layout: scale and
// (MASK) mask the scores s in place, update the row max m and sum l, turn
// s into p, and return the rescale of the old acc in corr.
template <int BK, bool MASK>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float scale, int key0, int lim,
                                             bool causal, int qpos0,
                                             int k_off, int t) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float v = __fmul_rn(s[4 * j + e], scale);
      if constexpr (MASK) {
        const int key = key0 + 8 * j + 2 * t + (e & 1);
        if (key >= lim)
          v = -INFINITY;
        else if (causal && qpos0 + 8 * r < k_off + key)
          v = MASKED;
      }
      s[4 * j + e] = v;
      mx[r] = fmaxf(mx[r], v);
    }
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = flash::ex2((m[r] - mx[r]) * LOG2E);
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float e = flash::ex2((s[i] - mx[r]) * LOG2E);
    s[i] = e;
    sum[r] += e;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * corr[r] + sum[r];
    m[r] = mx[r];
  }
}

// S = Q K^T for one warpgroup: k16 step kk reads 32 bytes of column block
// kk / 4 of Q (rows qa.., BM rows a block) and of the K tile at kb.
template <int DP, int BK, int BM>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], uint32_t qa,
                                        uint32_t kb) {
  hg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    hg::wgmma_ss<BK, 0, 0>(
        s, hg::desc_sw128(qa + (kk >> 2) * BM * 128 + off, 16, 1024),
        hg::desc_sw128(kb + (kk >> 2) * BK * 128 + off, 16, 1024), kk > 0);
  }
  hg::wgmma_commit();
}

// The per-warpgroup state of the forward walk.
template <int DP, int BK>
struct FwdState {
  float o[DP / 2];            // acc
  float m[2], l[2];           // rows row0 and row0 + 8
  uint32_t pa[BK / 16][4];    // bf16(P), the A operand of P V
};

// One key tile j: S_j, its softmax, P_j V_j, each waited for before the
// next; the SM's consumer warpgroups interleave their products and
// softmaxes.
template <int DP, int BK, int BM>
__device__ __forceinline__ void fwd_step(
    FwdState<DP, BK>& st, float (&s)[BK / 2], int j, const Walk& w,
    const Params& p, uint32_t qa, uint8_t* k_s, uint8_t* v_s, uint32_t full0,
    uint32_t empty0, int qpos0, int lane, int t) {
  constexpr int KV_BYTES = DP / 64 * BK * 128;
  const int sj = j % STAGES;
  hg::mbar_wait(full0 + 8 * sj, (j / STAGES) & 1);
  issue_s<DP, BK, BM>(s, qa, hg::smem_u32(k_s + sj * KV_BYTES));
  hg::wgmma_wait<0>();
  hg::fence_regs(s);
  float corr[2];
  if (j < w.n_free)
    softmax_step<BK, false>(s, st.m, st.l, corr, p.scale, j * BK, w.lim,
                            p.causal, qpos0, p.k_off, t);
  else
    softmax_step<BK, true>(s, st.m, st.l, corr, p.scale, j * BK, w.lim,
                           p.causal, qpos0, p.k_off, t);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) st.o[i] *= corr[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) flash::acc_to_a<BK>(st.pa[kk], s, kk);
  const uint32_t vb = hg::smem_u32(v_s + sj * KV_BYTES);
  hg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    hg::wgmma_rs<DP, 1>(st.o, st.pa[kk],
                        hg::desc_sw128(vb + kk * 2048, BK * 128, 1024), 1);
  hg::wgmma_commit();
  hg::wgmma_wait<0>();
  hg::fence_regs(st.o);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) hg::fence_regs(st.pa[kk]);
  if (lane == 0) hg::mbar_arrive(empty0 + 8 * sj);
}

template <int DP, int BK, int NWG, bool NORMALIZE>
__global__ void __launch_bounds__(NWG * 128 + 32, fwd_min_blocks(NWG, DP, BK))
    flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv, Params p) {
  constexpr int BM = NWG * 64;        // query rows of the CTA
  constexpr int Q_BLOCK = BM * 128;   // one 64-column block of the Q tile
  constexpr int KV_BLOCK = BK * 128;  // ... of a K or V tile
  constexpr int KV_BYTES = DP / 64 * KV_BLOCK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = flash::align1024(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* k_s = q_s + DP / 64 * Q_BLOCK;
  uint8_t* v_s = k_s + STAGES * KV_BYTES;
  const uint32_t q_full = hg::smem_u32(v_s + STAGES * KV_BYTES);
  const uint32_t full0 = q_full + 8;
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const int q0 = (p.q_tiles - 1 - (int)blockIdx.z) * BM;  // heaviest first
  const Walk w0 = walk_of(p, q0, BK);
  const Walk w1 = NWG == 2 ? walk_of(p, q0 + 64, BK) : w0;
  const int n_cta = max(w0.n, w1.n);

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
    // ---- producer warp: one thread issues every load ----
    if (lane != 0 || n_cta == 0) return;
    hg::tma_prefetch(&mq);
    hg::tma_prefetch(&mk);
    hg::tma_prefetch(&mv);
    hg::mbar_expect_tx(q_full, DP / 64 * Q_BLOCK);
#pragma unroll
    for (int c = 0; c < DP / 64; ++c)
      hg::tma_load_4d(hg::smem_u32(q_s + c * Q_BLOCK), &mq, q_full, 64 * c,
                      hh, q0, bb);
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

  // ---- consumers: warpgroup wg owns query rows q0 + 64*wg .. +64 ----
  const int wg = warp >> 2;
  const Walk w = wg ? w1 : w0;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + wg * 64 + (warp & 3) * 16 + g;  // and row0 + 8
  const int qpos0 = p.q_off + row0;
  FwdState<DP, BK> st;
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) st.o[i] = 0.0f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.m[r] = MASKED;
    st.l[r] = 0.0f;
  }
  const uint32_t qa = hg::smem_u32(q_s) + wg * 64 * 128;
  const int n = w.n;
  if (n > 0) hg::mbar_wait(q_full, 0);
  float sa[BK / 2];
  for (int j = 0; j < n; ++j)
    fwd_step<DP, BK, BM>(st, sa, j, w, p, qa, k_s, v_s, full0, empty0,
                         qpos0, lane, t);
  // the key tiles only the other warpgroup walks: free their stages
  for (int j = n; j < n_cta; ++j) {
    hg::mbar_wait(full0 + 8 * (j % STAGES), (j / STAGES) & 1);
    if (lane == 0) hg::mbar_arrive(empty0 + 8 * (j % STAGES));
  }

  // ---- epilogue on the accumulator layout: rows row0 and row0 + 8 ----
  const long long stride = (long long)p.h * p.d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.tq) continue;
    const long long at = ((long long)bb * p.tq + row) * stride +
                         (long long)hh * p.d;
    const long long stat = ((long long)bb * p.h + hh) * p.tq + row;
    if constexpr (NORMALIZE) {
      // O = acc / max(l, 1e-30) rounded once, LSE = m + log(..)
      const float denom = fmaxf(st.l[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < p.d)
          *reinterpret_cast<uint32_t*>(p.o + at + col) = flash::pack_rn(
              st.o[4 * j + 2 * r] / denom, st.o[4 * j + 2 * r + 1] / denom);
      }
      if (t == 0) p.lse[stat] = st.m[r] + logf(denom);
    } else {
      // K10: the raw f32 state
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < p.d)
          *reinterpret_cast<float2*>(p.acc + at + col) =
              make_float2(st.o[4 * j + 2 * r], st.o[4 * j + 2 * r + 1]);
      }
      if (t == 0) {
        p.m[stat] = st.m[r];
        p.l[stat] = st.l[r];
      }
    }
  }
}

template <int DP, int BK, int NWG, bool NORMALIZE>
int launch(const void* q, const void* k, const void* v, Params p, int b,
           cudaStream_t stream) {
  constexpr int BM = NWG * 64;
  CUtensorMap mq, mk, mv;
  int rc = flash::map_bthd(&mq, q, b, p.tq, p.h, p.d, BM);
  if (rc == 0) rc = flash::map_bthd(&mk, k, b, p.tk, p.h, p.d, BK);
  if (rc == 0) rc = flash::map_bthd(&mv, v, b, p.tk, p.h, p.d, BK);
  if (rc != 0) return rc;
  auto kernel = flash_fwd_kernel<DP, BK, NWG, NORMALIZE>;
  constexpr int smem = smem_bytes<DP, BK, NWG>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  p.q_tiles = (p.tq + BM - 1) / BM;
  dim3 grid((unsigned)p.h, (unsigned)b, (unsigned)p.q_tiles);
  kernel<<<grid, NWG * 128 + 32, smem, stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

// The tile plan, by head dim, each timed fastest on the card among the
// tiles that fit the register file without a spill: at D <= 64 one
// warpgroup a CTA with BK 64 (K7) or 128 (K10, whose T-32768 walks are
// long); above, two warpgroups with BK 64.
template <bool NORMALIZE>
int dispatch(const void* q, const void* k, const void* v, const Params& p,
             int b, cudaStream_t s) {
  if (p.d % 16 != 0 || p.d > 128 || p.d <= 0) return (int)cudaErrorInvalidValue;
  if (p.d > 64) return launch<128, 64, 2, NORMALIZE>(q, k, v, p, b, s);
  return launch<64, NORMALIZE ? 64 : 128, 1, NORMALIZE>(q, k, v, p, b, s);
}

}  // namespace

// K7: o [B, Tq, H, D] bf16 and lse [B, H, Tq] f32 from q [B, Tq, H, D] and
// k, v [B, Tk, H, D] bf16; D a multiple of 16, at most 128; Tq, Tk
// multiples of 8; 16-byte aligned pointers. Returns the CUDA error code.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int b, int h, int tq,
                              int tk, int d, int q_off, int k_off,
                              float scale, int causal, void* stream) {
  Params p{static_cast<bf16*>(o), static_cast<float*>(lse), nullptr, nullptr,
           nullptr, h, tq, tk, d, q_off, k_off, causal ? 1 : 0, 0, scale};
  return dispatch<true>(q, k, v, p, b, static_cast<cudaStream_t>(stream));
}

// K10: acc [B, Tq, H, D] f32 and m, l [B, H, Tq] f32, the unnormalized
// online-softmax state of q [B, Tq, H, D] against k, v [B, Tk, H, D] bf16,
// with global offsets q_off, k_off for the causal mask; the same operand
// rules as K7, 8-byte aligned acc. Returns the CUDA error code.
extern "C" int flash_attn_fwd_block(const void* q, const void* k,
                                    const void* v, void* acc, void* m,
                                    void* l, int b, int h, int tq, int tk,
                                    int d, int q_off, int k_off, float scale,
                                    int causal, void* stream) {
  Params p{nullptr, nullptr, static_cast<float*>(acc), static_cast<float*>(m),
           static_cast<float*>(l), h, tq, tk, d, q_off, k_off,
           causal ? 1 : 0, 0, scale};
  return dispatch<false>(q, k, v, p, b, static_cast<cudaStream_t>(stream));
}
