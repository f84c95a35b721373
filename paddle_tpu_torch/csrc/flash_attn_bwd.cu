// Flash-attention backward: dQ (K8) and dK/dV (K9) on bf16 tensor cores,
// for sm_90a.
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
// Design. K8: one CTA per (64 query rows, head, batch), 4 warps of 16 rows;
// Q and dO fragments in registers; K/V tiles stream through a two-stage
// cp.async ring (the reference's sequential K axis is the loop); dQ in f32
// registers. K9: one CTA per (64 key rows, head, batch); K and V stay in
// shared memory; Q, dO, LSE and delta tiles stream (the reference's
// sequential Q axis is the loop); each warp computes its 16 key rows' S^T =
// K Q^T and dP^T = V dO^T directly, so P^T and dS^T are already the A
// operands of P^T dO and dS^T Q (C -> A reuse, no transposed fragments);
// dK and dV in f32 registers. K9 owns its key tile: every output element is
// written by one CTA, without atomics, and a repeated call is bitwise
// equal. Causal: tiles wholly on the masked side are not visited (the
// reference's pl.when at :332 and :383); only diagonal tiles are masked per
// element. Streamed tiles are 64 rows at D <= 64 and 32 rows at D <= 128,
// which keeps the f32 accumulators (2 x 16 x 128 a warp in K9) and the
// score tiles within the register file.
//
// Arithmetic, at the reference's rounding points: S in f32, times scale;
// P = exp(S - LSE) in f32; dP = dO V^T in f32; P (for dV) and dS (for dQ
// and dK) rounded to bf16 before their products; dQ and dK scaled at the
// end and rounded once, dV rounded once.
//
// Bound on an H100: causal at the bench shape [8, 2048, 8, 64], K8 does
// 3 products of 2*T^2*D/2 per (b, h), 51.5 GFLOP (0.052 ms at 989 TF/s
// bf16); K9 does 4, 68.7 GFLOP (0.069 ms). Their bytes (q, k, v, dO, lse,
// delta in, one or two [B, T, H, D] out) take 0.01-0.015 ms at 3.35 TB/s:
// both are operation-bound. mma.sync, 32-bit shared loads and no warp
// specialisation keep this first version well short of that; wgmma + TMA
// and larger tiles are the next steps.

#include "flash_attn_common.cuh"

namespace {

using namespace flash;

struct BwdParams {
  const bf16* q;       // [B, Tq, H, D]
  const bf16* k;       // [B, Tk, H, D]
  const bf16* v;       // [B, Tk, H, D]
  const bf16* dout;    // [B, Tq, H, D]
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  bf16* dq;            // [B, Tq, H, D]
  bf16* dk;            // [B, Tk, H, D]
  bf16* dv;            // [B, Tk, H, D]
  int h, tq, tk, d, q_off, k_off, causal;
  float scale;
};

// K8 --------------------------------------------------------------------------

template <int DP, int BK>
__global__ void __launch_bounds__(THREADS) flash_dq_kernel(BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DP + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LD]
  bf16* dos = qs + ROWS * LD;                    // [ROWS][LD]
  bf16* ks = dos + ROWS * LD;                    // [2][BK][LD]
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
  const long long q_base = (long long)bb * p.tq * stride + (long long)hh * p.d;
  const long long k_base = (long long)bb * p.tk * stride + (long long)hh * p.d;

  const int q_last = min(q0 + ROWS, p.tq) - 1;
  const int n_tiles = key_tiles(p.tk, BK, p.causal, q_last, p.q_off, p.k_off);

  load_rows<ROWS, DP>(qs, p.q + q_base, q0, p.tq, p.d, stride, tid);
  load_rows<ROWS, DP>(dos, p.dout + q_base, q0, p.tq, p.d, stride, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_rows<BK, DP>(ks, p.k + k_base, 0, p.tk, p.d, stride, tid);
    load_rows<BK, DP>(vs, p.v + k_base, 0, p.tk, p.d, stride, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  uint32_t qf[DP / 16][4], dof[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    load_a(qf[kk], qs, LD, warp * 16, kk * 16, g, t);
    load_a(dof[kk], dos, LD, warp * 16, kk * 16, g, t);
  }
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const long long stat = ((long long)bb * p.h + hh) * p.tq;
  float lse[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse[r] = rows[r] < p.tq ? p.lse[stat + rows[r]] : 0.0f;
    dl[r] = rows[r] < p.tq ? p.delta[stat + rows[r]] : 0.0f;
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_rows<BK, DP>(ks + (st ^ 1) * BK * LD, p.k + k_base, (j + 1) * BK,
                        p.tk, p.d, stride, tid);
      load_rows<BK, DP>(vs + (st ^ 1) * BK * LD, p.v + k_base, (j + 1) * BK,
                        p.tk, p.d, stride, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = ks + st * BK * LD;
    const bf16* vt = vs + st * BK * LD;

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        uint32_t b[2];
        load_b_nk(b, kt, LD, n * 8, kk * 16, g, t);
        mma(s[n], qf[kk], b);
        load_b_nk(b, vt, LD, n * 8, kk * 16, g, t);
        mma(dp[n], dof[kk], b);
      }
    }
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
        else if (p.causal && p.q_off + rows[r] < p.k_off + key)
          v = MASKED;
        const float pe = expf(v - lse[r]);
        s[n][i] = pe * (dp[n][i] - dl[r]);  // dS, rounded in c_to_a
      }
    }
    // acc += bf16(dS) K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s, kk);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        uint32_t b[2];
        load_b_kn(b, kt, LD, kk * 16, n * 8, g, t);
        mma(acc[n], a, b);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.tq) continue;
    bf16* out = p.dq + q_base + (long long)rows[r] * stride;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.d)
        *reinterpret_cast<uint32_t*>(out + col) = pack_rn(
            acc[n][2 * r] * p.scale, acc[n][2 * r + 1] * p.scale);
    }
  }
}

// K9 --------------------------------------------------------------------------

template <int DP, int BQ>
__device__ __forceinline__ void load_q_tile(bf16* qs, bf16* dos, float* lses,
                                            float* dls, const BwdParams& p,
                                            long long q_base, long long stat,
                                            int q0, long long stride,
                                            int tid) {
  load_rows<BQ, DP>(qs, p.q + q_base, q0, p.tq, p.d, stride, tid);
  load_rows<BQ, DP>(dos, p.dout + q_base, q0, p.tq, p.d, stride, tid);
  constexpr int CH = BQ / 4;  // 16-byte chunks of f32 stats
  if (tid < 2 * CH) {
    const int c = (tid % CH) * 4;
    const float* src = (tid < CH ? p.lse : p.delta) + stat + q0 + c;
    const bool ok = q0 + c < p.tq;  // Tq % 8 == 0: a chunk is all in or out
    cp_async16((tid < CH ? lses : dls) + c, ok ? src : p.lse, ok);
  }
}

template <int DP, int BQ>
__global__ void __launch_bounds__(THREADS) flash_dkv_kernel(BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DP + 8;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LD]
  bf16* vs = ks + ROWS * LD;                     // [ROWS][LD]
  bf16* qs = vs + ROWS * LD;                     // [2][BQ][LD]
  bf16* dos = qs + 2 * BQ * LD;                  // [2][BQ][LD]
  float* lses = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ]
  float* dls = lses + 2 * BQ;                                 // [2][BQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.x * ROWS;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const long long stride = (long long)p.h * p.d;
  const long long q_base = (long long)bb * p.tq * stride + (long long)hh * p.d;
  const long long k_base = (long long)bb * p.tk * stride + (long long)hh * p.d;
  const long long stat = ((long long)bb * p.h + hh) * p.tq;

  // causal: the first query tile whose last row sees this tile's first key
  const int n_q = (p.tq + BQ - 1) / BQ;
  int j0 = 0;
  if (p.causal) {
    const int x = p.k_off + k0 - p.q_off - BQ + 1;
    j0 = x <= 0 ? 0 : (x + BQ - 1) / BQ;
  }

  load_rows<ROWS, DP>(ks, p.k + k_base, k0, p.tk, p.d, stride, tid);
  load_rows<ROWS, DP>(vs, p.v + k_base, k0, p.tk, p.d, stride, tid);
  cp_async_commit();
  if (j0 < n_q)
    load_q_tile<DP, BQ>(qs, dos, lses, dls, p, q_base, stat, j0 * BQ, stride,
                        tid);
  cp_async_commit();

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.0f;
  // global key positions of this thread's two rows
  const int kpos[2] = {p.k_off + k0 + warp * 16 + g,
                       p.k_off + k0 + warp * 16 + g + 8};

  for (int j = j0; j < n_q; ++j) {
    const int st = (j - j0) & 1;
    if (j + 1 < n_q)
      load_q_tile<DP, BQ>(qs + (st ^ 1) * BQ * LD, dos + (st ^ 1) * BQ * LD,
                          lses + (st ^ 1) * BQ, dls + (st ^ 1) * BQ, p, q_base,
                          stat, (j + 1) * BQ, stride, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qt = qs + st * BQ * LD;
    const bf16* dot = dos + st * BQ * LD;
    const float* lset = lses + st * BQ;
    const float* dlt = dls + st * BQ;

    // S^T = K Q^T and dP^T = V dO^T, 16 keys x BQ queries a warp
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, ks, LD, warp * 16, kk * 16, g, t);
      load_a(va, vs, LD, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        uint32_t b[2];
        load_b_nk(b, qt, LD, n * 8, kk * 16, g, t);
        mma(s[n], ka, b);
        load_b_nk(b, dot, LD, n * 8, kk * 16, g, t);
        mma(dp[n], va, b);
      }
    }
    const int q0 = j * BQ;
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ql = n * 8 + 2 * t + (i & 1);
        float v = s[n][i] * p.scale;
        if (q0 + ql >= p.tq)
          v = -INFINITY;
        else if (p.causal && p.q_off + q0 + ql < kpos[i >> 1])
          v = MASKED;
        const float pe = expf(v - lset[ql]);
        s[n][i] = pe;                        // P^T, rounded in c_to_a
        dp[n][i] = pe * (dp[n][i] - dlt[ql]);  // dS^T, rounded in c_to_a
      }
    }
    // dV += bf16(P^T) dO, dK += bf16(dS^T) Q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      c_to_a(pa, s, kk);
      c_to_a(da, dp, kk);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        uint32_t b[2];
        load_b_kn(b, dot, LD, kk * 16, n * 8, g, t);
        mma(dv[n], pa, b);
        load_b_kn(b, qt, LD, kk * 16, n * 8, g, t);
        mma(dk[n], da, b);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // no copy may outlive the block

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + warp * 16 + g + 8 * r;
    if (row >= p.tk) continue;
    bf16* dkr = p.dk + k_base + (long long)row * stride;
    bf16* dvr = p.dv + k_base + (long long)row * stride;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.d) {
        *reinterpret_cast<uint32_t*>(dkr + col) = pack_rn(
            dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvr + col) =
            pack_rn(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, const BwdParams& p, int b, int rows_total,
           size_t smem, bool* configured, cudaStream_t stream) {
  if (!*configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    *configured = true;
  }
  dim3 grid((unsigned)((rows_total + ROWS - 1) / ROWS), (unsigned)p.h,
            (unsigned)b);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DP, int BK>
int launch_dq(const BwdParams& p, int b, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = (size_t)(2 * ROWS + 4 * BK) * (DP + 8) * sizeof(bf16);
  return launch(flash_dq_kernel<DP, BK>, p, b, p.tq, smem, &configured,
                stream);
}

template <int DP, int BQ>
int launch_dkv(const BwdParams& p, int b, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = (size_t)(2 * ROWS + 4 * BQ) * (DP + 8) * sizeof(bf16) +
                      4 * BQ * sizeof(float);
  return launch(flash_dkv_kernel<DP, BQ>, p, b, p.tk, smem, &configured,
                stream);
}

BwdParams params(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, void* dk, void* dv, int h, int tq, int tk, int d,
                 int q_off, int k_off, float scale, int causal) {
  return BwdParams{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                   static_cast<const float*>(lse),
                   static_cast<const float*>(delta), static_cast<bf16*>(dq),
                   static_cast<bf16*>(dk), static_cast<bf16*>(dv), h, tq, tk,
                   d, q_off, k_off, causal ? 1 : 0, scale};
}

}  // namespace

// K8: dq [B, Tq, H, D] bf16. Requirements as flash_attn_fwd's. Returns the
// CUDA error code.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int b, int h,
                                 int tq, int tk, int d, int q_off, int k_off,
                                 float scale, int causal, void* stream) {
  if (d % 16 != 0 || d > 128 || d <= 0) return (int)cudaErrorInvalidValue;
  BwdParams p = params(q, k, v, dout, lse, delta, dq, nullptr, nullptr, h, tq,
                       tk, d, q_off, k_off, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_dq<64, 64>(p, b, s);
  return launch_dq<128, 32>(p, b, s);
}

// K9: dk, dv [B, Tk, H, D] bf16. Returns the CUDA error code.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int b,
                                  int h, int tq, int tk, int d, int q_off,
                                  int k_off, float scale, int causal,
                                  void* stream) {
  if (d % 16 != 0 || d > 128 || d <= 0) return (int)cudaErrorInvalidValue;
  BwdParams p = params(q, k, v, dout, lse, delta, nullptr, dk, dv, h, tq, tk,
                       d, q_off, k_off, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_dkv<64, 64>(p, b, s);
  return launch_dkv<128, 32>(p, b, s);
}
