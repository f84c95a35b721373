// Flash-attention forward on f32 operands (K7 f32) on Hopper's tf32 wgmma
// with TMA loads through an mbarrier ring, for sm_90a. The bf16 forward is
// flash_attn_fwd.cu; the f32 backward (K8, K9) is flash_attn_bwd_tf32.cu,
// whose pieces (split warps, 3xTF32 products, flash_attn_tf32.cuh) this
// kernel shares; the ring's unnormalized f32 block (K10 f32) is still the
// tile walk of flash_attn_walk.cu.
//
// Replaces, in f32: paddle_tpu/ops/pallas_attention.py `_fwd_kernel`
// (:143), normalize=True, through `_forward` (:266) -> `_fwd_call` (:225,
// pallas_call :237). Same function: q [B, Tq, H, D] and k, v [B, Tk, H, D]
// f32 -> o = softmax(scale * Q K^T [causal mask]) V [B, Tq, H, D] f32 and
// lse [B, H, Tq] f32. With f32 operands the reference's rounding of P to
// the operand dtype is a no-op, so P stays f32.
//
// Arithmetic: S = Q K^T in three tf32 passes (3xTF32), times scale (a
// rounded multiply); masked scores -1e30 (the reference's value); keys
// past the visited tiles, and past Tk, -inf (p = 0, exactly nothing); the
// online softmax's row max and sum in f32 with expf; P split in registers
// into hi (the raw f32, which the tensor cores truncate) and lo; P V in
// three passes into a zeroed per-tile partial (scale-d 0) that joins o by
// o = o * alpha + partial, the online rescale: the tensor cores'
// accumulation does not round to nearest, and a sequence-long chain of
// k8 steps drifts (2.4e-5 at T 8192, tests/torch_tf32_probe.py), so the
// long sum stays off the tensor-core chain. O = acc / max(l, 1e-30), LSE =
// m + log(max(l, 1e-30)). The order of the f32 sums differs from the
// plain version's.
//
// Visiting: the plain version's (flash_attn_common.cuh `walk_of`): 64
// query rows visit the 64-key tiles up to the one holding their last
// row's position; causal tiles wholly past it are not visited (the
// reference's pl.when). A row of a visited tile whose every key is masked
// takes p = exp(-1e30 - -1e30) = 1, the reference's own behaviour. Only
// the tiles a mask or the ragged end reaches test each element.
//
// Design. A CTA owns 64 query rows of one (head, batch) for its one
// consumer warpgroup and walks the key tiles (the reference's sequential
// grid axis) with the running (m, l, o) in registers. Roles, as in
// flash_attn_bwd_tf32.cu:
// - a TMA warp (one thread) loads the resident Q once and keeps a ring of
//   key-tile stages full: 4-D maps over [B, T, H, D] in place, 32-column
//   boxes (128 bytes, the swizzle span); rows past T and columns past D
//   land as zeros (D < 64 is padded to 64, 64 < D <= 128 to 128);
// - three split warps turn Q once into its lo and each landed K tile into
//   its lo (S = Q K^T reads both K-major), each landed V tile into its
//   transposed hi and lo with each 8-row step's k order permuted (P V
//   reduces over keys, and tf32 wgmma takes no transpose bits), so that
//   the f32 accumulator of P is the register A operand of P V as it
//   stands;
// - the consumer warpgroup runs S as m64nBKk8 with both operands in shared
//   memory, the softmax on the accumulator layout, and P V as m64nDk8
//   with A from registers.
// Grid: heads x batch x query tiles, the last (heaviest causal) tiles
// first. Every output element is written by one CTA, without atomics, so
// a repeated call is bitwise equal.
//
// Tile plans (one CTA an SM, 256 threads, so up to 255 registers a
// thread), timed on the card by tests/torch_attn_f32_sweep.py: D <= 64,
// key tiles of 64, two stages (K, K lo, V, V^T hi, V^T lo: 80 KB a stage)
// beside Q and Q lo (32 KB), 188 registers (four stages of 32 keys were
// 1.2x slower); D <= 128, key tiles of 32, two stages of 80 KB beside 64
// KB, whose wgmmas ptxas serializes (C7511 at 174 registers), as it does
// the D-128 plans of K8 and K9: one stage of 64 keys, and P V in NH = 2
// pieces of 64 columns (fewer partial registers; the sweep's alternative),
// were serialized too and no faster.
//
// Bound on an H100: the products run as three TF32 passes, so 495 / 3 =
// 165 TF/s. Causal at the f32 path's shape [1, 2048, 8, 64], 4.3 GFLOP a
// call (0.026 ms); its bytes (q, k, v, o in f32, lse) take 0.008 ms at
// 3.35 TB/s: operation-bound. What the design does about the tile walk it
// replaces (mma.sync m16n8k8, 64-bit shared loads, every thread a loader,
// each of 4 warps re-splitting every fragment it loads): wgmma at N 32-128,
// TMA loads, one split of each operand element per CTA. What still holds it
// back: one consumer warpgroup an SM waits on its own products and runs
// its softmax with the tensor cores idle.

#include "flash_attn_tf32.cuh"

namespace {

using namespace flash_tf32;
using flash::MASKED;
using flash::Walk;

struct Params {
  float* o;    // [B, Tq, H, D]
  float* lse;  // [B, H, Tq]
  int h, tq, tk, d, q_off, k_off, causal, tiles;
  float scale;
};

template <int DP, int BK, int STAGES>
struct FwdPlan {
  static constexpr int Q_BYTES = ROWS * DP * 4;  // a resident tile
  static constexpr int T_BYTES = BK * DP * 4;    // a streamed tile
  // a stage: K, K lo, V, V^T hi, V^T lo, each on a 1024-byte boundary
  static constexpr int K_LO = T_BYTES;
  static constexpr int V = 2 * T_BYTES;
  static constexpr int VT_HI = 3 * T_BYTES;
  static constexpr int VT_LO = 4 * T_BYTES;
  static constexpr int STAGE = 5 * T_BYTES;
  static constexpr int BARS = 2 + 3 * STAGES;
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + STAGES * STAGE + BARS * 8;
};

// One key tile's online-softmax step on the accumulator layout: scale and
// (MASK) mask the scores s in place, update the row max m and sum l, turn
// s into p, and return the rescale of the old o in corr.
template <int BK, bool MASK>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float scale, int key0, int lim,
                                             bool causal, int qpos0,
                                             int k_off, int t) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    float v = __fmul_rn(s[i], scale);
    if constexpr (MASK) {
      const int key = key0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (key >= lim)
        v = -INFINITY;
      else if (causal && qpos0 + 8 * r < k_off + key)
        v = MASKED;
    }
    s[i] = v;
    mx[r] = fmaxf(mx[r], v);
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = expf(m[r] - mx[r]);
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float e = expf(s[i] - mx[r]);
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

template <int DP, int BK, int STAGES, int NH>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_tf32_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv, Params p) {
  using P = FwdPlan<DP, BK, STAGES>;
  constexpr int QB = P::Q_BYTES, TB = P::T_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = flash::align1024(smem_raw);
  uint8_t* q_s = smem;  // Q, Q lo
  uint8_t* stages = q_s + 2 * QB;
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
  const Walk w =
      flash::walk_of(p.tq, p.tk, p.causal, p.q_off, p.k_off, q0, BK);
  const int n = w.n;

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
    hg::tma_prefetch(&mk);
    hg::tma_prefetch(&mv);
    hg::mbar_expect_tx(q_full, QB);
#pragma unroll
    for (int c = 0; c < DP / BLOCK; ++c)
      hg::tma_load_4d(hg::smem_u32(q_s + c * ROWS * 128), &mq, q_full,
                      BLOCK * c, hh, q0, bb);
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
        hg::tma_load_4d(hg::smem_u32(st + P::V + c * BK * 128), &mv, full,
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
    hg::fence_proxy_async();
    hg::mbar_arrive(q_ready);
    for (int j = 0; j < n; ++j) {
      const int s = j % STAGES;
      uint8_t* st = stages + s * P::STAGE;
      hg::mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
      split_tile<BK, DP, true, false>(st, st + P::K_LO, nullptr, nullptr,
                                      ptid);
      split_tile<BK, DP, false, true>(st + P::V, nullptr, st + P::VT_HI,
                                      st + P::VT_LO, ptid);
      hg::fence_proxy_async();
      hg::mbar_arrive(ready0 + 8 * s);
    }
    return;
  }

  // ---- consumers: query rows q0 .. q0 + 63 ----
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // and row0 + 8
  const int qpos0 = p.q_off + row0;
  constexpr int N = DP / NH;  // P V in NH pieces of N columns
  float o[DP / 2], part[N / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) part[i] = 0.0f;
  float m[2] = {MASKED, MASKED}, l[2] = {0.0f, 0.0f};
  if (n > 0) hg::mbar_wait(q_ready, 0);
  const uint32_t qa = hg::smem_u32(q_s);
  for (int j = 0; j < n; ++j) {
    const int s = j % STAGES;
    hg::mbar_wait(ready0 + 8 * s, (j / STAGES) & 1);
    const uint32_t kb = hg::smem_u32(stages + s * P::STAGE);
    // S = Q K^T
    float sc[BK / 2];
    hg::wgmma_fence();
    product_ss<BK, ROWS, DP>(sc, qa, qa + QB, kb, kb + P::K_LO, true);
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs(sc);

    float corr[2];
    if (j < w.n_free)
      softmax_step<BK, false>(sc, m, l, corr, p.scale, j * BK, w.lim,
                              p.causal, qpos0, p.k_off, t);
    else
      softmax_step<BK, true>(sc, m, l, corr, p.scale, j * BK, w.lim,
                             p.causal, qpos0, p.k_off, t);

    // the tile's P V into a zeroed partial, joined by the online rescale
    uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      product_rs<DP, BK, N>(part, sc, ah, al, kb + P::VT_HI + h * N * 128,
                            kb + P::VT_LO + h * N * 128);
      hg::wgmma_commit();
      hg::wgmma_wait<0>();
      hg::fence_regs(part);
      fence_frags<BK>(ah);
      fence_frags<BK>(al);
#pragma unroll
      for (int i = 0; i < N / 2; ++i)
        o[h * N / 2 + i] =
            __fmaf_rn(o[h * N / 2 + i], corr[(i >> 1) & 1], part[i]);
    }
    if (lane == 0) hg::mbar_arrive(empty0 + 8 * s);
  }

  // ---- epilogue: O = o / max(l, 1e-30), LSE = m + log(..) ----
  const long long stride = (long long)p.h * p.d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.tq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* out = p.o + ((long long)bb * p.tq + row) * stride +
                 (long long)hh * p.d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < p.d)
        store2(out + col, o[4 * j + 2 * r] / denom,
               o[4 * j + 2 * r + 1] / denom);
    }
    if (t == 0)
      p.lse[((long long)bb * p.h + hh) * p.tq + row] = m[r] + logf(denom);
  }
}

// ---- host --------------------------------------------------------------------

template <int DP, int BK, int STAGES, int NH = 1>
int launch_fwd(const void* q, const void* k, const void* v, Params p, int b,
               cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int rc = flash::map_bthd<float>(&mq, q, b, p.tq, p.h, p.d, ROWS);
  if (rc == 0) rc = flash::map_bthd<float>(&mk, k, b, p.tk, p.h, p.d, BK);
  if (rc == 0) rc = flash::map_bthd<float>(&mv, v, b, p.tk, p.h, p.d, BK);
  if (rc != 0) return rc;
  auto kernel = fwd_tf32_kernel<DP, BK, STAGES, NH>;
  constexpr int smem = FwdPlan<DP, BK, STAGES>::SMEM;
  static bool done = false;
  rc = flash::configure(kernel, smem, &done);
  if (rc != 0) return rc;
  p.tiles = (p.tq + ROWS - 1) / ROWS;
  dim3 grid((unsigned)p.h, (unsigned)b, (unsigned)p.tiles);
  kernel<<<grid, THREADS, smem, stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// K7 f32: o [B, Tq, H, D] and lse [B, H, Tq] from q [B, Tq, H, D] and k, v
// [B, Tk, H, D], all f32, with global offsets q_off, k_off for the causal
// mask; D a multiple of 16 up to 128, Tq and Tk multiples of 8, 16-byte
// aligned pointers. Returns the CUDA error code.
extern "C" int flash_tf32_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int b, int h, int tq,
                              int tk, int d, int q_off, int k_off,
                              float scale, int causal, void* stream) {
  if (bad_head_dim(d)) return (int)cudaErrorInvalidValue;
  Params p{static_cast<float*>(o), static_cast<float*>(lse), h, tq, tk, d,
           q_off, k_off, causal ? 1 : 0, 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_fwd<64, 64, 2>(q, k, v, p, b, s);
  return launch_fwd<128, 32, 2>(q, k, v, p, b, s);
}
