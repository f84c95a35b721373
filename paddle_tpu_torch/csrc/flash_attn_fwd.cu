// Flash-attention forward (K7) and the ring's unnormalized forward block
// (K10) on bf16 tensor cores, for sm_90a.
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
// and transposed). A row that no visited key tile reaches, a key shard
// wholly in its causal future, keeps (acc, l, m) = (0, 0, -1e30), as the
// Pallas kernel leaves it; the ring merge reads m > -5e29 as "valid".
// One template with a compile-time NORMALIZE flag: only the epilogue
// differs, and K7's instantiation is the code it was before K10.
//
// Design. One CTA per (query tile of 64 rows, head, batch): heads go into
// the grid where the Pallas kernel unrolls them inside one tile (a Mosaic
// layout rule). 4 warps, 16 query rows each, Q fragments held in
// registers. K/V tiles of BK rows stream through a two-stage cp.async ring;
// the reference's sequential grid axis over K tiles is the loop here, with
// the running (m, l, acc) in registers. Causal: key tiles wholly past the
// tile's last query row are not visited (the reference's pl.when at :188);
// the mask is applied per element, so only the diagonal tiles are partly
// masked. Rows past Tq are zero-filled and never stored; keys past Tk score
// -inf, so they add exactly nothing.
//
// Arithmetic, at the reference's rounding points (:25-28): S = Q K^T in
// f32, times scale; masked scores -1e30; row max and sum in f32; P rounded
// to bf16 before P V (C -> A reuse); O = acc / max(l, 1e-30) rounded once;
// LSE = m + log(max(l, 1e-30)). The order of the f32 sums differs from the
// reference's and from the plain version's.
//
// Bound on an H100: causal at the bench shape [8, 2048, 8, 64] the work is
// 4*B*H*T^2*D/2 = 34.4 GFLOP against 989 TF/s bf16 (0.035 ms), far above
// its 33.6 MB of q, k, v, o and lse against 3.35 TB/s (0.010 ms):
// operation-bound. This first kernel reaches a fraction of it: mma.sync
// runs at a part of the wgmma rate, operands go through 32-bit shared
// loads rather than ldmatrix or TMA, and there is no warp specialisation.
// wgmma + TMA and larger tiles are the next steps.
//
// K10's bound at the ring configuration's one-card shape [1, 32768, 8, 64]
// causal, offsets 0 (one shard): 4*B*H*T^2*D/2 = 1.10 TFLOP, 1.11 ms at
// 989 TF/s bf16, against about 0.17 GB of bf16 q, k, v and f32 acc, m, l
// (0.05 ms at 3.35 TB/s): operation-bound, as K7. Its f32 acc doubles K7's
// output bytes, which stays far below the operations' time. The last query
// tiles walk 512 key tiles and the first one: the grid's load imbalance is
// a matter of speed, left to a later version.

#include "flash_attn_common.cuh"

namespace {

using namespace flash;

struct FwdParams {
  const bf16* q;  // [B, Tq, H, D]
  const bf16* k;  // [B, Tk, H, D]
  const bf16* v;  // [B, Tk, H, D]
  bf16* o;        // [B, Tq, H, D]      K7
  float* lse;     // [B, H, Tq]         K7
  float* acc;     // [B, Tq, H, D] f32  K10
  float* m;       // [B, H, Tq]         K10
  float* l;       // [B, H, Tq]         K10
  int h, tq, tk, d, q_off, k_off, causal;
  float scale;
};

template <int DP, int BK, bool NORMALIZE>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DP + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LD]
  bf16* ks = qs + ROWS * LD;                     // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                   // [2][BK][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * ROWS;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const long long stride = (long long)p.h * p.d;
  const bf16* qg = p.q + (long long)bb * p.tq * stride + (long long)hh * p.d;
  const bf16* kg = p.k + (long long)bb * p.tk * stride + (long long)hh * p.d;
  const bf16* vg = p.v + (long long)bb * p.tk * stride + (long long)hh * p.d;

  const int q_last = min(q0 + ROWS, p.tq) - 1;
  const int n_tiles = key_tiles(p.tk, BK, p.causal, q_last, p.q_off, p.k_off);

  load_rows<ROWS, DP>(qs, qg, q0, p.tq, p.d, stride, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_rows<BK, DP>(ks, kg, 0, p.tk, p.d, stride, tid);
    load_rows<BK, DP>(vs, vg, 0, p.tk, p.d, stride, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    load_a(qf[kk], qs, LD, warp * 16, kk * 16, g, t);

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
  float m[2] = {MASKED, MASKED};  // rows g and g + 8 of this warp
  float l[2] = {0.0f, 0.0f};
  // global query positions of this thread's two rows
  const int qpos[2] = {p.q_off + q0 + warp * 16 + g,
                       p.q_off + q0 + warp * 16 + g + 8};

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_rows<BK, DP>(ks + (st ^ 1) * BK * LD, kg, (j + 1) * BK, p.tk, p.d,
                        stride, tid);
      load_rows<BK, DP>(vs + (st ^ 1) * BK * LD, vg, (j + 1) * BK, p.tk, p.d,
                        stride, tid);
    }
    cp_async_commit();  // possibly empty: keeps the wait count uniform
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = ks + st * BK * LD;
    const bf16* vt = vs + st * BK * LD;

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t b[2];
        load_b_nk(b, kt, LD, n * 8, kk * 16, g, t);
        mma(s[n], qf[kk], b);
      }
    }

    // scale, mask, and the new row maxima
    float mx[2] = {m[0], m[1]};
    const int k0 = j * BK;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int key = k0 + n * 8 + 2 * t + (i & 1);
        float v = s[n][i] * p.scale;
        if (key >= p.tk)
          v = -INFINITY;
        else if (p.causal && qpos[r] < p.k_off + key)
          v = MASKED;
        s[n][i] = v;
        mx[r] = fmaxf(mx[r], v);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) corr[r] = expf(m[r] - mx[r]);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(s[n][i] - mx[i >> 1]);
        s[n][i] = e;
        sum[i >> 1] += e;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += bf16(P) V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s, kk);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        uint32_t b[2];
        load_b_kn(b, vt, LD, kk * 16, n * 8, g, t);
        mma(acc[n], a, b);
      }
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  if constexpr (!NORMALIZE) {
    // K10's epilogue: the raw f32 state, acc with 64-bit row offsets
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= p.tq) continue;
      float* arow = p.acc + ((long long)bb * p.tq + rows[r]) * stride +
                    (long long)hh * p.d;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < p.d)
          *reinterpret_cast<float2*>(arow + col) =
              make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      }
      if (t == 0) {
        const long long row = ((long long)bb * p.h + hh) * p.tq + rows[r];
        p.m[row] = m[r];
        p.l[row] = l[r];
      }
    }
    return;
  }

  // epilogue: O = acc / max(l, 1e-30) rounded once, LSE = m + log(..)
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) denom[r] = fmaxf(l[r], 1e-30f);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.tq) continue;
    bf16* orow = p.o + ((long long)bb * p.tq + rows[r]) * stride +
                 (long long)hh * p.d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.d) {
        const uint32_t v =
            pack_rn(acc[n][2 * r] / denom[r], acc[n][2 * r + 1] / denom[r]);
        *reinterpret_cast<uint32_t*>(orow + col) = v;
      }
    }
    if (t == 0)
      p.lse[((long long)bb * p.h + hh) * p.tq + rows[r]] =
          m[r] + logf(denom[r]);
  }
}

template <int DP, int BK, bool NORMALIZE>
int launch(const FwdParams& p, int b, cudaStream_t stream) {
  const size_t smem = (size_t)(ROWS + 4 * BK) * (DP + 8) * sizeof(bf16);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<DP, BK, NORMALIZE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((unsigned)((p.tq + ROWS - 1) / ROWS), (unsigned)p.h, (unsigned)b);
  flash_fwd_kernel<DP, BK, NORMALIZE><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// K7: o [B, Tq, H, D] bf16 and lse [B, H, Tq] f32 from q [B, Tq, H, D] and
// k, v [B, Tk, H, D] bf16; D a multiple of 16, at most 128; Tq, Tk
// multiples of 8; 16-byte aligned pointers. Returns the CUDA error code.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int b, int h, int tq,
                              int tk, int d, int q_off, int k_off,
                              float scale, int causal, void* stream) {
  if (d % 16 != 0 || d > 128 || d <= 0) return (int)cudaErrorInvalidValue;
  FwdParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), static_cast<bf16*>(o),
              static_cast<float*>(lse), nullptr, nullptr, nullptr, h, tq, tk,
              d, q_off, k_off, causal ? 1 : 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch<64, 64, true>(p, b, s);
  return launch<128, 64, true>(p, b, s);
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
  if (d % 16 != 0 || d > 128 || d <= 0) return (int)cudaErrorInvalidValue;
  FwdParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), nullptr, nullptr,
              static_cast<float*>(acc), static_cast<float*>(m),
              static_cast<float*>(l), h, tq, tk, d, q_off, k_off,
              causal ? 1 : 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch<64, 64, false>(p, b, s);
  return launch<128, 64, false>(p, b, s);
}
