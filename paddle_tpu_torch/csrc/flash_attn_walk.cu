// The f32 forms of the flash-attention kernels, for sm_90a: K7 (forward),
// K10 (the ring's unnormalized forward block), K8 (dQ) and K9 (dK, dV) on
// f32 operands, a tile walk on mma.sync with 3xTF32 products. The bf16
// kernels are flash_attn_fwd.cu and flash_attn_bwd.cu.
//
// Replaces, in f32: paddle_tpu/ops/pallas_attention.py `_fwd_kernel` (:143;
// normalize=True through `_forward` :266 -> `_fwd_call` :225 is K7,
// normalize=False through `flash_attention_block` :276 is K10),
// `_dq_kernel` (:295) and `_dkv_kernel` (:342) (through
// `flash_attention_bwd_block` :395). The reference's kernels take any float
// dtype and accumulate in f32 (`_dot` :130); with f32 operands its roundings
// of P and dS to the operand dtype are no-ops, so P and dS stay f32 here.
//
// Design: one CTA of 4 warps per (64 resident rows, head, batch), 16 rows
// a warp (queries in K7/K8, keys in K9); the reference's sequential grid
// axis (key tiles in K7/K8, query tiles in K9) is a loop over a two-stage
// cp.async ring in shared memory, rows padded by 4 floats. The head dim is
// padded to DP (64 or 128) in shared memory; the pad columns are
// zero-filled, so they add nothing to any product, and are never stored.
// Causal tiles wholly on the masked side are not visited (the reference's
// pl.when at :188, :332, :383); the mask is applied per element. Rows past
// T are zero-filled and never stored; keys past Tk score -inf.
//
// Products: mma.sync m16n8k8 tf32 three times (3xTF32, `Tf32x3`): each
// operand x splits into hi = tf32(x) and lo = tf32(x - hi), and a*b is
// taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, which keeps about 21 of
// f32's 24 bits of each product (the dropped lo*lo term and lo's own
// rounding); on the sequence-long sums each k-step's partial joins the sum
// by an f32 add. An f32 accumulator fragment of one product becomes the A
// operand of the next without leaving registers (C -> A reuse), split into
// tf32 pairs with no rounding point of its own: the fragments permute the
// k index within each 8-column step the same way in A and in B (logical k
// t <-> column 2t, t + 4 <-> 2t + 1), so a C fragment is an A fragment as
// it stands and every operand load is a float2.
//
// Fragment layouts (PTX ISA), g = lane / 4, t = lane % 4:
//   m16n8k8 A (16x8):   a[0] = (g, t), a[1] = (g+8, t), a[2] = (g, t+4),
//                       a[3] = (g+8, t+4)
//   m16n8k8 B (8x8):    b[0] = (k t, n g), b[1] = (k t+4, n g)
//   C (16x8, f32):      c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1)
//
// Arithmetic: S = Q K^T in f32, times scale; masked scores -1e30; the
// online softmax's row max and sum in f32 (expf); K7: O = acc / max(l,
// 1e-30), LSE = m + log(max(l, 1e-30)); K10: the raw (acc, l, m), a row no
// visited tile reaches left at (0, 0, -1e30); K8: dQ = scale * dS K; K9:
// dV = P^T dO, dK = scale * dS^T Q, P = exp(S - LSE), dS = P o (dO V^T -
// delta).
//
// Bound on an H100: the products run as three TF32 passes, so 495 / 3 =
// 165 TF/s. Causal at the f32 paths' shape [1, 2048, 8, 64], K7 and K10
// do 4.3 GFLOP (0.026 ms), K8 6.4 and K9 8.6 GFLOP. Their bytes (f32:
// twice bf16's) stay below a tenth of that time: operation-bound. What
// holds this walk back: mma.sync at m16n8k8, 64-bit shared loads, every
// thread a loader, and three passes per product.

#include "flash_attn_common.cuh"

namespace {

using flash::key_tiles;
using flash::MASKED;

constexpr int THREADS = 128;  // 4 warps
constexpr int ROWS = 64;      // resident rows, 16 per warp
constexpr int PAD = 4;        // row padding in shared memory, floats

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_size = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_size)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all groups but the `N` most recently committed ones have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Tf32x3 {
  static constexpr int KS = 8;  // k per product step
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };

  static __device__ __forceinline__ void split(float x, uint32_t& hi,
                                               uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
  }

  // A, 16 x 8 at (r0, k0), k permuted (column 2t is k t, 2t+1 is k t+4)
  static __device__ __forceinline__ void load_a(A& a, const float* s, int ld,
                                                int r0, int k0, int g,
                                                int t) {
    const float* p = s + (r0 + g) * ld + k0 + 2 * t;
    const float2 x0 = *reinterpret_cast<const float2*>(p);
    const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * ld);
    split(x0.x, a.hi[0], a.lo[0]);
    split(x1.x, a.hi[1], a.lo[1]);
    split(x0.y, a.hi[2], a.lo[2]);
    split(x1.y, a.hi[3], a.lo[3]);
  }

  // B, 8 x 8 (k x n) at (k0, n0), of a shared matrix stored [n][k]
  static __device__ __forceinline__ void load_b_nk(B& b, const float* s,
                                                   int ld, int n0, int k0,
                                                   int g, int t) {
    const float2 x =
        *reinterpret_cast<const float2*>(s + (n0 + g) * ld + k0 + 2 * t);
    split(x.x, b.hi[0], b.lo[0]);
    split(x.y, b.hi[1], b.lo[1]);
  }

  // B, 8 x 8 (k x n) at (k0, n0), of a shared matrix stored [k][n]
  static __device__ __forceinline__ void load_b_kn(B& b, const float* s,
                                                   int ld, int k0, int n0,
                                                   int g, int t) {
    const float* p = s + (k0 + 2 * t) * ld + n0 + g;
    split(p[0], b.hi[0], b.lo[0]);
    split(p[ld], b.hi[1], b.lo[1]);
  }

  static __device__ __forceinline__ void mma1(float* c, const uint32_t* a,
                                              const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }

  // c += a * b: the three passes, small terms first
  static __device__ __forceinline__ void mma(float* c, const A& a,
                                             const B& b) {
    mma1(c, a.lo, b.hi);
    mma1(c, a.hi, b.lo);
    mma1(c, a.hi, b.hi);
  }

  // The same into an accumulator that runs the length of the sequence (P V,
  // dS K, P^T dO, dS^T Q): the passes go to a zeroed partial that joins c by
  // an f32 add. The tensor cores' accumulation does not round to nearest,
  // so a chain of thousands of mma into one register drifts (2e-5 of the
  // sum over a T-2048 column); the partial keeps that to one k-step. The
  // scores' chains (D / 8 steps, restarted each tile) need no partial.
  static __device__ __forceinline__ void mma_acc(float* c, const A& a,
                                                 const B& b) {
    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma(t, a, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += t[i];
  }

  // C -> A: the 8 columns kk*8.. of an f32 accumulator as they stand
  static __device__ __forceinline__ void c_to_a(A& a, float (*c)[4], int kk) {
    split(c[kk][0], a.hi[0], a.lo[0]);
    split(c[kk][2], a.hi[1], a.lo[1]);
    split(c[kk][1], a.hi[2], a.lo[2]);
    split(c[kk][3], a.hi[3], a.lo[3]);
  }
};

typedef Tf32x3 O;

// Copy rows row0 .. row0+R-1 (of nrows) and columns 0 .. DP-1 (of d) of a
// [T, D] slice with row stride `stride` into shared memory with row stride
// DP + PAD; rows and columns outside are zero-filled. Issues cp.async only.
template <int R, int DP>
__device__ __forceinline__ void load_rows(float* s, const float* gsrc,
                                          int row0, int nrows, int d,
                                          long long stride, int tid) {
  constexpr int CH = DP / 4;  // 16-byte chunks per row
  for (int i = tid; i < R * CH; i += THREADS) {
    const int r = i / CH;
    const int c = (i - r * CH) * 4;
    const bool ok = (row0 + r < nrows) && (c < d);
    const float* src = ok ? gsrc + (long long)(row0 + r) * stride + c : gsrc;
    cp_async16(s + r * (DP + PAD) + c, src, ok);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

struct FwdParams {
  const float* q;  // [B, Tq, H, D]
  const float* k;  // [B, Tk, H, D]
  const float* v;  // [B, Tk, H, D]
  float* o;        // [B, Tq, H, D]  K7
  float* lse;      // [B, H, Tq]     K7
  float* acc;      // [B, Tq, H, D]  K10
  float* m;        // [B, H, Tq]     K10
  float* l;        // [B, H, Tq]     K10
  int h, tq, tk, d, q_off, k_off, causal;
  float scale;
};

template <int DP, int BK, bool NORMALIZE>
__global__ void __launch_bounds__(THREADS) walk_fwd_kernel(FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DP + PAD;
  float* qs = reinterpret_cast<float*>(smem_raw);  // [ROWS][LD]
  float* ks = qs + ROWS * LD;                      // [2][BK][LD]
  float* vs = ks + 2 * BK * LD;                    // [2][BK][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * ROWS;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const long long stride = (long long)p.h * p.d;
  const float* qg = p.q + (long long)bb * p.tq * stride + (long long)hh * p.d;
  const float* kg = p.k + (long long)bb * p.tk * stride + (long long)hh * p.d;
  const float* vg = p.v + (long long)bb * p.tk * stride + (long long)hh * p.d;

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
    const float* kt = ks + st * BK * LD;
    const float* vt = vs + st * BK * LD;

    // S = Q K^T, Q's fragments read from shared memory at each step (held
    // in registers as tf32 pairs they would spill)
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / O::KS; ++kk) {
      O::A a;
      O::load_a(a, qs, LD, warp * 16, kk * O::KS, g, t);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        O::B b;
        O::load_b_nk(b, kt, LD, n * 8, kk * O::KS, g, t);
        O::mma(s[n], a, b);
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

    // acc += P V
#pragma unroll
    for (int kk = 0; kk < BK / O::KS; ++kk) {
      O::A a;
      O::c_to_a(a, s, kk);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        O::B b;
        O::load_b_kn(b, vt, LD, kk * O::KS, n * 8, g, t);
        O::mma_acc(acc[n], a, b);
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
        if (col < p.d) store2(arow + col, acc[n][2 * r], acc[n][2 * r + 1]);
      }
      if (t == 0) {
        const long long row = ((long long)bb * p.h + hh) * p.tq + rows[r];
        p.m[row] = m[r];
        p.l[row] = l[r];
      }
    }
  } else {
    // epilogue: O = acc / max(l, 1e-30), LSE = m + log(..)
    float denom[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) denom[r] = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= p.tq) continue;
      float* orow = p.o + ((long long)bb * p.tq + rows[r]) * stride +
                    (long long)hh * p.d;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < p.d)
          store2(orow + col, acc[n][2 * r] / denom[r],
                 acc[n][2 * r + 1] / denom[r]);
      }
      if (t == 0)
        p.lse[((long long)bb * p.h + hh) * p.tq + rows[r]] =
            m[r] + logf(denom[r]);
    }
  }
}

struct BwdParams {
  const float* q;      // [B, Tq, H, D]
  const float* k;      // [B, Tk, H, D]
  const float* v;      // [B, Tk, H, D]
  const float* dout;   // [B, Tq, H, D]
  const float* lse;    // [B, H, Tq]
  const float* delta;  // [B, H, Tq]
  float* dq;           // [B, Tq, H, D]
  float* dk;           // [B, Tk, H, D]
  float* dv;           // [B, Tk, H, D]
  int h, tq, tk, d, q_off, k_off, causal;
  float scale;
};

// K8 --------------------------------------------------------------------------

// Left to itself ptxas builds the D-64 form at 128 registers with a spill;
// told that one block an SM will do, it holds it in registers.
template <int DP, int BK>
__global__ void __launch_bounds__(THREADS, 1) walk_dq_kernel(BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DP + PAD;
  float* qs = reinterpret_cast<float*>(smem_raw);  // [ROWS][LD]
  float* dos = qs + ROWS * LD;                     // [ROWS][LD]
  float* ks = dos + ROWS * LD;                     // [2][BK][LD]
  float* vs = ks + 2 * BK * LD;                    // [2][BK][LD]

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
  const float* kg = p.k + k_base;
  const float* vg = p.v + k_base;

  const int q_last = min(q0 + ROWS, p.tq) - 1;
  const int n_tiles = key_tiles(p.tk, BK, p.causal, q_last, p.q_off, p.k_off);

  load_rows<ROWS, DP>(qs, p.q + q_base, q0, p.tq, p.d, stride, tid);
  load_rows<ROWS, DP>(dos, p.dout + q_base, q0, p.tq, p.d, stride, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_rows<BK, DP>(ks, kg, 0, p.tk, p.d, stride, tid);
    load_rows<BK, DP>(vs, vg, 0, p.tk, p.d, stride, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

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
      load_rows<BK, DP>(ks + (st ^ 1) * BK * LD, kg, (j + 1) * BK, p.tk, p.d,
                        stride, tid);
      load_rows<BK, DP>(vs + (st ^ 1) * BK * LD, vg, (j + 1) * BK, p.tk, p.d,
                        stride, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* kt = ks + st * BK * LD;
    const float* vt = vs + st * BK * LD;

    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / O::KS; ++kk) {
      O::A qa, da;
      O::load_a(qa, qs, LD, warp * 16, kk * O::KS, g, t);
      O::load_a(da, dos, LD, warp * 16, kk * O::KS, g, t);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        O::B b;
        O::load_b_nk(b, kt, LD, n * 8, kk * O::KS, g, t);
        O::mma(s[n], qa, b);
        O::load_b_nk(b, vt, LD, n * 8, kk * O::KS, g, t);
        O::mma(dp[n], da, b);
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
        s[n][i] = pe * (dp[n][i] - dl[r]);  // dS
      }
    }
    // acc += dS K
#pragma unroll
    for (int kk = 0; kk < BK / O::KS; ++kk) {
      O::A a;
      O::c_to_a(a, s, kk);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        O::B b;
        O::load_b_kn(b, kt, LD, kk * O::KS, n * 8, g, t);
        O::mma_acc(acc[n], a, b);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.tq) continue;
    float* out = p.dq + q_base + (long long)rows[r] * stride;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.d)
        store2(out + col, acc[n][2 * r] * p.scale, acc[n][2 * r + 1] * p.scale);
    }
  }
}

// K9 --------------------------------------------------------------------------

template <int DP, int BQ>
__device__ __forceinline__ void load_q_tile(float* qs, float* dos,
                                            float* lses, float* dls,
                                            const BwdParams& p,
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

// PART: which of K9's outputs a launch computes, kDV | kDK for both. At D
// 128 K9 runs as two launches, dV then dK: together they hold 128 f32
// accumulators a thread, beside which the tf32 fragment pairs spill; one
// output at a time recomputes S^T (5 products for 4).
constexpr int kDV = 1, kDK = 2;

template <int DP, int BQ, int PART>
__global__ void __launch_bounds__(THREADS) walk_dkv_kernel(BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DP + PAD;
  float* ks = reinterpret_cast<float*>(smem_raw);  // [ROWS][LD]
  float* vs = ks + ROWS * LD;                      // [ROWS][LD]
  float* qs = vs + ROWS * LD;                      // [2][BQ][LD]
  float* dos = qs + 2 * BQ * LD;                   // [2][BQ][LD]
  float* lses = dos + 2 * BQ * LD;                 // [2][BQ]
  float* dls = lses + 2 * BQ;                      // [2][BQ]

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

  float dk[PART & kDK ? DP / 8 : 1][4], dv[PART & kDV ? DP / 8 : 1][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (PART & kDK) dk[n][i] = 0.0f;
      if constexpr (PART & kDV) dv[n][i] = 0.0f;
    }
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
    const float* qt = qs + st * BQ * LD;
    const float* dot = dos + st * BQ * LD;
    const float* lset = lses + st * BQ;
    const float* dlt = dls + st * BQ;

    // S^T = K Q^T and dP^T = V dO^T, 16 keys x BQ queries a warp
    float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / O::KS; ++kk) {
      O::A ka, va;
      O::load_a(ka, ks, LD, warp * 16, kk * O::KS, g, t);
      if constexpr (PART & kDK)
        O::load_a(va, vs, LD, warp * 16, kk * O::KS, g, t);
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        O::B b;
        O::load_b_nk(b, qt, LD, n * 8, kk * O::KS, g, t);
        O::mma(s[n], ka, b);
        if constexpr (PART & kDK) {
          O::load_b_nk(b, dot, LD, n * 8, kk * O::KS, g, t);
          O::mma(dp[n], va, b);
        }
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
        s[n][i] = pe;                          // P^T
        if constexpr (PART & kDK)
          dp[n][i] = pe * (dp[n][i] - dlt[ql]);  // dS^T
      }
    }
    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < BQ / O::KS; ++kk) {
      O::A pa, da;
      if constexpr (PART & kDV) O::c_to_a(pa, s, kk);
      if constexpr (PART & kDK) O::c_to_a(da, dp, kk);
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        O::B b;
        if constexpr (PART & kDV) {
          O::load_b_kn(b, dot, LD, kk * O::KS, n * 8, g, t);
          O::mma_acc(dv[n], pa, b);
        }
        if constexpr (PART & kDK) {
          O::load_b_kn(b, qt, LD, kk * O::KS, n * 8, g, t);
          O::mma_acc(dk[n], da, b);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // no copy may outlive the block

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + warp * 16 + g + 8 * r;
    if (row >= p.tk) continue;
    float* dkr = p.dk + k_base + (long long)row * stride;
    float* dvr = p.dv + k_base + (long long)row * stride;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < p.d) {
        if constexpr (PART & kDK)
          store2(dkr + col, dk[n][2 * r] * p.scale,
                 dk[n][2 * r + 1] * p.scale);
        if constexpr (PART & kDV)
          store2(dvr + col, dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

// ---- host --------------------------------------------------------------------

template <typename Kernel, typename Params>
int launch(Kernel kernel, const Params& p, int b, int rows_total,
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

template <int DP, bool NORMALIZE>
int launch_fwd(const FwdParams& p, int b, cudaStream_t stream) {
  constexpr int BK = 64;
  static bool configured = false;
  const size_t smem = (size_t)(ROWS + 4 * BK) * (DP + PAD) * sizeof(float);
  return launch(walk_fwd_kernel<DP, BK, NORMALIZE>, p, b, p.tq, smem,
                &configured, stream);
}

template <bool NORMALIZE>
int fwd(const FwdParams& p, int b, cudaStream_t s) {
  if (p.d <= 64) return launch_fwd<64, NORMALIZE>(p, b, s);
  return launch_fwd<128, NORMALIZE>(p, b, s);
}

template <int DP, int BK>
int launch_dq(const BwdParams& p, int b, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem =
      (size_t)(2 * ROWS + 4 * BK) * (DP + PAD) * sizeof(float);
  return launch(walk_dq_kernel<DP, BK>, p, b, p.tq, smem, &configured,
                stream);
}

template <int DP, int BQ, int PART>
int launch_dkv(const BwdParams& p, int b, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem =
      (size_t)(2 * ROWS + 4 * BQ) * (DP + PAD) * sizeof(float) +
      4 * BQ * sizeof(float);
  return launch(walk_dkv_kernel<DP, BQ, PART>, p, b, p.tk, smem, &configured,
                stream);
}

bool bad_head_dim(int d) { return d % 16 != 0 || d > 128 || d <= 0; }

BwdParams params(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, void* dk, void* dv, int h, int tq, int tk, int d,
                 int q_off, int k_off, float scale, int causal) {
  return BwdParams{static_cast<const float*>(q),
                   static_cast<const float*>(k),
                   static_cast<const float*>(v),
                   static_cast<const float*>(dout),
                   static_cast<const float*>(lse),
                   static_cast<const float*>(delta),
                   static_cast<float*>(dq),
                   static_cast<float*>(dk),
                   static_cast<float*>(dv),
                   h, tq, tk, d, q_off, k_off, causal ? 1 : 0, scale};
}

}  // namespace

// The entry points take f32 operands and write f32 outputs, with the
// operand rules of the bf16 kernels: D a multiple of 16 up to 128, Tq and
// Tk multiples of 8, 16-byte aligned pointers. Each returns the CUDA error
// code.

// K7: o [B, Tq, H, D] and lse [B, H, Tq].
extern "C" int flash_walk_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int b, int h, int tq,
                              int tk, int d, int q_off, int k_off,
                              float scale, int causal, void* stream) {
  if (bad_head_dim(d)) return (int)cudaErrorInvalidValue;
  FwdParams p{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<float*>(o),
              static_cast<float*>(lse), nullptr, nullptr, nullptr, h, tq, tk,
              d, q_off, k_off, causal ? 1 : 0, scale};
  return fwd<true>(p, b, static_cast<cudaStream_t>(stream));
}

// K10: acc [B, Tq, H, D] and m, l [B, H, Tq].
extern "C" int flash_walk_fwd_block(const void* q, const void* k,
                                    const void* v, void* acc, void* m,
                                    void* l, int b, int h, int tq, int tk,
                                    int d, int q_off, int k_off, float scale,
                                    int causal, void* stream) {
  if (bad_head_dim(d)) return (int)cudaErrorInvalidValue;
  FwdParams p{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), nullptr, nullptr,
              static_cast<float*>(acc), static_cast<float*>(m),
              static_cast<float*>(l), h, tq, tk, d, q_off, k_off,
              causal ? 1 : 0, scale};
  return fwd<false>(p, b, static_cast<cudaStream_t>(stream));
}

// K8: dq [B, Tq, H, D].
extern "C" int flash_walk_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int b, int h,
                                 int tq, int tk, int d, int q_off, int k_off,
                                 float scale, int causal, void* stream) {
  if (bad_head_dim(d)) return (int)cudaErrorInvalidValue;
  BwdParams p = params(q, k, v, dout, lse, delta, dq, nullptr, nullptr, h, tq,
                       tk, d, q_off, k_off, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d <= 64 ? launch_dq<64, 64>(p, b, s) : launch_dq<128, 32>(p, b, s);
}

// K9: dk, dv [B, Tk, H, D]; at D > 64 two kernel launches (dV, then dK).
extern "C" int flash_walk_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int b,
                                  int h, int tq, int tk, int d, int q_off,
                                  int k_off, float scale, int causal,
                                  void* stream) {
  if (bad_head_dim(d)) return (int)cudaErrorInvalidValue;
  BwdParams p = params(q, k, v, dout, lse, delta, nullptr, dk, dv, h, tq, tk,
                       d, q_off, k_off, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_dkv<64, 64, kDV | kDK>(p, b, s);
  const int rc = launch_dkv<128, 32, kDV>(p, b, s);
  return rc != 0 ? rc : launch_dkv<128, 32, kDK>(p, b, s);
}
