// The f32 form of the ring's unnormalized flash-attention forward block
// (K10 f32), for sm_90a: a tile walk on mma.sync with 3xTF32 products. The
// bf16 kernels are flash_attn_fwd.cu and flash_attn_bwd.cu; the f32 forward
// (K7 f32) is flash_attn_fwd_tf32.cu and the f32 backward (K8, K9)
// flash_attn_bwd_tf32.cu, both on tf32 wgmma.
//
// Replaces, in f32: paddle_tpu/ops/pallas_attention.py `_fwd_kernel` (:143)
// with normalize=False, through `flash_attention_block` :276. The
// reference's kernels take any float dtype and accumulate in f32 (`_dot`
// :130); with f32 operands its rounding of P to the operand dtype is a
// no-op, so P stays f32 here.
//
// Design: one CTA of 4 warps per (64 resident query rows, head, batch), 16
// rows a warp; the reference's sequential grid axis (key tiles) is a loop
// over a two-stage cp.async ring in shared memory, rows padded by 4 floats.
// The head dim is padded to DP (64 or 128) in shared memory; the pad
// columns are zero-filled, so they add nothing to any product, and are
// never stored. Causal tiles wholly on the masked side are not visited (the
// reference's pl.when at :188); the mask is applied per element. Rows past
// T are zero-filled and never stored; keys past Tk score -inf.
//
// Products: mma.sync m16n8k8 tf32 three times (3xTF32, `Tf32x3`): each
// operand x splits into hi = tf32(x) and lo = tf32(x - hi), and a*b is
// taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, which keeps about 21 of
// f32's 24 bits of each product (the dropped lo*lo term and lo's own
// rounding); on the sequence-long sum P V each k-step's partial joins the
// sum by an f32 add. An f32 accumulator fragment of S becomes the A
// operand of P V without leaving registers (C -> A reuse), split into tf32
// pairs with no rounding point of its own: the fragments permute the k
// index within each 8-column step the same way in A and in B (logical k t
// <-> column 2t, t + 4 <-> 2t + 1), so a C fragment is an A fragment as it
// stands and every operand load is a float2.
//
// Fragment layouts (PTX ISA), g = lane / 4, t = lane % 4:
//   m16n8k8 A (16x8):   a[0] = (g, t), a[1] = (g+8, t), a[2] = (g, t+4),
//                       a[3] = (g+8, t+4)
//   m16n8k8 B (8x8):    b[0] = (k t, n g), b[1] = (k t+4, n g)
//   C (16x8, f32):      c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1)
//
// Arithmetic: S = Q K^T in f32, times scale; masked scores -1e30; the
// online softmax's row max and sum in f32 (expf); the raw (acc, l, m), a
// row no visited tile reaches left at (0, 0, -1e30).
//
// Bound on an H100: the products run as three TF32 passes, so 495 / 3 =
// 165 TF/s. Causal at the f32 ring step's shape [1, 2048, 8, 64], K10
// does 4.3 GFLOP (0.026 ms). Its bytes (f32: twice bf16's) stay below a
// tenth of that time: operation-bound. What holds this walk back: mma.sync
// at m16n8k8, 64-bit shared loads, every thread a loader, and three passes
// per product; K7 f32's design (flash_attn_fwd_tf32.cu) is its successor.

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
  float* acc;      // [B, Tq, H, D]
  float* m;        // [B, H, Tq]
  float* l;        // [B, H, Tq]
  int h, tq, tk, d, q_off, k_off, causal;
  float scale;
};

template <int DP, int BK>
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

  // the raw f32 state, acc with 64-bit row offsets
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
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
}

// ---- host --------------------------------------------------------------------

template <int DP>
int launch_fwd(const FwdParams& p, int b, cudaStream_t stream) {
  constexpr int BK = 64;
  auto kernel = walk_fwd_kernel<DP, BK>;
  const size_t smem = (size_t)(ROWS + 4 * BK) * (DP + PAD) * sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((unsigned)((p.tq + ROWS - 1) / ROWS), (unsigned)p.h, (unsigned)b);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

bool bad_head_dim(int d) { return d % 16 != 0 || d > 128 || d <= 0; }

}  // namespace

// K10 f32: acc [B, Tq, H, D] and m, l [B, H, Tq] from f32 q [B, Tq, H, D]
// and k, v [B, Tk, H, D], with the operand rules of the bf16 kernels: D a
// multiple of 16 up to 128, Tq and Tk multiples of 8, 16-byte aligned
// pointers. Returns the CUDA error code.
extern "C" int flash_walk_fwd_block(const void* q, const void* k,
                                    const void* v, void* acc, void* m,
                                    void* l, int b, int h, int tq, int tk,
                                    int d, int q_off, int k_off, float scale,
                                    int causal, void* stream) {
  if (bad_head_dim(d)) return (int)cudaErrorInvalidValue;
  FwdParams p{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<float*>(acc),
              static_cast<float*>(m), static_cast<float*>(l), h, tq, tk, d,
              q_off, k_off, causal ? 1 : 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.d <= 64) return launch_fwd<64>(p, b, s);
  return launch_fwd<128>(p, b, s);
}
