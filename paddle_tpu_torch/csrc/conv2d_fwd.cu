// conv2d forward (K1), the dgrad driver's mainloop (K2) and conv2d +
// channel statistics (K4) as an implicit GEMM on Hopper's wgmma, for sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_conv.py `conv2d` (:412) ->
// `_conv_call` (:331) -> `_fwd_kernel` (:204). Same function: x NHWC bf16,
// the filter OHWI bf16 (the layout the serving fold and the training casts
// store; an OIHW view of it at the Python API), symmetric stride/padding/
// dilation (explicit OH/OW, so K2's asymmetric padding comes free), f32
// accumulation rounded once to the output type (bf16, or f32 for tests).
//
// GEMM view: M = N*OH*OW output pixels, N = Co, K = KH*KW*Ci. A block owns
// a 128-pixel x BN-channel tile (BN 64 or 128, the plan's) and walks K in
// 64-deep slices, one tap and 64 channels each. Warp specialisation: one
// producer warp (one thread) keeps a ring of 3 or 4 shared-memory stages
// (the plan's; a reduction of one or two steps holds them all at once)
// full with TMA loads under full/empty mbarrier pairs; two consumer
// warpgroups each run wgmma m64nBNk16 (bf16 -> f32, both operands K-major
// from 128-byte-swizzled shared memory) on 64 of the 128 pixel rows, and
// keep one wgmma group in flight while they wait for the next stage.
//
// Loads, all TMA (`cp.async.bulk.tensor`), none through registers:
// - B, the filter: a 3-D map of the OHWI filter ([Co][taps][Ci]), box
//   (64 channels, 1 tap, BN output channels). K-major as wgmma takes it.
// - A, the pixels, FLAT: a stride-1 1x1 conv with no padding reads the
//   dense [N*H*W, Ci] matrix through a 2-D map, box (64, 128): every row of
//   the tile is a real output pixel.
// - A, the pixels, BOX: every other geometry (3x3 convs, the stride-2 1x1
//   convs, K2's dilated cotangent) reads a 4-D map of x [N][H][W][Ci] with
//   box (64, bw*sw, bh*sh, bn) and element strides (1, sw, sh, 1), at the
//   tap's shifted corner (ow0*sw - pw + kx*dw, oh0*sh - ph + ky*dh, n0).
//   The tile is then bn images x bh rows x bw columns of output pixels
//   (bn*bh*bw = 128, powers of two chosen per shape by the wrapper). TMA
//   fills every coordinate outside x with zeros: that is the padding, and
//   the stride is the element stride, so no shape needs a gather. Rows of
//   the tile outside the output (a ragged edge) are computed and masked in
//   the epilogue: the price of a rectangular box is 12-23 % of the MACs at
//   ResNet-50's 14x14 and 7x7 maps. Hopper's im2col tensor-map mode would
//   avoid it; boxes were chosen because their semantics are the tiled
//   mode's, which the filter loads use anyway.
// - Channel counts that are not multiples of 64 (Ci or Co = 8, 24, ...):
//   the maps' out-of-bounds fill zeroes the rest of the slice or tile, so
//   one instantiation takes every shape the gate admits (Ci, Co % 8 == 0).
//
// Epilogue: the bf16 output is staged through the freed ring as 128-byte
// swizzled rows and leaves by TMA stores, which clip the ragged edge; the
// f32 output (tests) and split partials go out by direct stores from the
// accumulator layout.
//
// Split-K: where the output tiles cannot fill the card (ResNet-50's stage
// 4 at batch 16, the batch-1 and batch-4 buckets), grid z cuts the K steps
// into `splits` contiguous ranges. Each split writes its f32 tile to its
// own slice of a [splits, M, Co] workspace; a second kernel adds the slices
// in order and rounds once. No atomics: a repeated call is bitwise equal,
// and the bf16 output is the f32 sum rounded once.
//
// K4, conv2d_stats (replaces pallas_conv.py `conv2d_stats` :420 ->
// `_fwd_stats_kernel` :241), is the same kernel with STATS set and the same
// plan, so y is bitwise K1's. Unsplit, its epilogue sums per output channel
// the bf16-rounded y and its square over the tile's valid rows, on wgmma's
// accumulator layout: each thread over its 2 rows, a butterfly over the 8
// lanes that share its columns, then the 8 consumer warps in order through
// shared memory, into the tile's row of a [tiles, Co] workspace. Split, a
// pass over the reduced y sums each 128-row block in a fixed order (8 runs
// of 16 rows, then the runs). A last kernel adds the rows in order. No
// atomics.
//
// Requirements (checked by the Python gate and wrapper): Ci % 8 == 0 and
// Co % 8 == 0 (TMA strides are multiples of 16 bytes; K11: Ci, Co % 16),
// 16-byte aligned pointers, contiguous NHWC x, OHWI w, NHWC y.
//
// Bound on an H100: the larger of 2*M*Co*KH*KW*Ci FLOPs against 989 TF/s
// bf16 and the bytes of x (the pixels read), w and y against 3.35 TB/s. In
// ResNet-50 the 3x3 convs are operation-bound and the 1x1 convs byte-bound.
// What still holds it back: a block per output tile (no persistent
// scheduling, so one tile's epilogue does not overlap the next one's loads;
// a 3-stage ring lets two blocks share an SM where the grid is large), the
// masked rows of the BOX tiles, and split-K's workspace round trip.
//
// K11, conv2d_q8 (replaces pallas_conv.py `conv2d_q8` :431 -> `_conv_call
// (dq=...)` :331 -> `_fwd_kernel` :204 in its int8 form, `_dot_i32` :198
// and the dequant of the output row :234-238), is the same kernel body on
// int8 operands (the `S8` traits below): x NHWC int8, the filter OHWI int8,
// a reduction step of one tap and 128 channels (one 128-byte swizzled row,
// as K1's 64 bf16), wgmma m64nBNk32 s8 -> s32 (8-bit wgmma has no
// transpose bits; the pixels and the OHWI filter are K-major already), the
// loads K1's through UINT8 tensor maps (the quantized zero is 0, so TMA's
// zero fill is exact padding), and an epilogue that turns each exact int32
// sum into bf16(__int2float_rn(acc) * dq[co]) (f32 for tests): the
// reference's arithmetic, so kernel and plain version agree bitwise. Split,
// each split writes int32 partials to a [splits, M, Co] workspace; a second
// kernel adds them in order (exact) and dequantizes once, so the split
// result is bitwise the unsplit one. Its plan is conv_cuda.conv_plan with
// the element size: steps = KH*KW*ceil(Ci/128). Bound: 2*M*Co*KH*KW*Ci
// integer operations against 1,979 TOP/s int8 and the bytes of x, w (one
// each), dq and y against 3.35 TB/s; in ResNet-50's O3 route every
// quantized conv is byte-bound at batch 1-16. One body for both element
// types: the producer, the ring and the plan are K1's, only the traits'
// mma and the epilogue's value differ.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using hg::bf16;

constexpr int BM = 128;       // output pixels per block (two warpgroups)
constexpr int ROW = 128;      // bytes of a tile row: one tap's reduction slice
constexpr int STAGES = 4;
constexpr int THREADS = 288;  // two consumer warpgroups + one producer warp
constexpr int A_BYTES = BM * ROW;

// The element types of the kernel body: what a 128-byte tile row holds,
// the wgmma of one ring stage (four 32-byte k steps), the accumulator and
// the output value of an accumulator entry.
struct Bf16 {  // K1, K2, K4: bf16 operands, f32 sums
  typedef float Acc;
  static constexpr int BK = 64;  // channels a row
  static constexpr int SIZE = 2;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr bool DEQUANT = false;
  template <int BN>
  static __device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da,
                                             uint64_t db) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 32 bytes along K per k16 step
      hg::wgmma<BN, 0, 0>(d, da + 2 * kk, db + 2 * kk);
  }
  static __device__ __forceinline__ float value(float a, float) { return a; }
};

struct S8 {  // K11: int8 operands, exact int32 sums, one dequant multiply
  typedef int Acc;
  static constexpr int BK = 128;
  static constexpr int SIZE = 1;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr bool DEQUANT = true;
  template <int BN>
  static __device__ __forceinline__ void mma(int (&d)[BN / 2], uint64_t da,
                                             uint64_t db) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 32 bytes along K per k32 step
      hg::wgmma_s8<BN>(d, da + 2 * kk, db + 2 * kk);
  }
  static __device__ __forceinline__ float value(int a, float dq) {
    return __fmul_rn(__int2float_rn(a), dq);
  }
};

struct Params {
  void* y;          // [N, OH, OW, Co]
  void* ws;         // split-K: [splits, M, Co] of the accumulator type
  const float* dq;  // K11: [Co] dequant scales
  float* part_sum;  // STATS, unsplit: [tiles, Co]
  float* part_sq;
  long long M;      // N*OH*OW
  int ci, co, kw, sh, sw, ph, pw, dh, dw;
  int flat, flip;              // flip: the filter's taps read in reverse
  int lbn, lbh, lbw;           // log2 of the tile's images, rows, columns
  int tiles_w, tiles_h;        // tiles along the epilogue's W and H
  int gn, goh, gow;            // epilogue geometry (FLAT: 1, 1, M)
  int taps, c_chunks, steps, splits, per;
  int stages;                  // ring depth, at most STAGES
};

__device__ __forceinline__ void store2(bf16* y, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* y, float a, float b) {
  *reinterpret_cast<float2*>(y) = make_float2(a, b);
}

__device__ __forceinline__ void store2(int* y, int a, int b) {
  *reinterpret_cast<int2*>(y) = make_int2(a, b);
}

__device__ __forceinline__ float rounded(float v, bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float rounded(float v, float*) { return v; }

__device__ __forceinline__ float as_float(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float as_float(float v) { return v; }

template <int BN>
constexpr int smem_bytes(int stages, bool stats) {
  return 1024 + stages * (A_BYTES + BN * ROW) + (stats ? 2 * 8 * BN * 4 : 0) +
         2 * STAGES * 8;
}

// The kernel body of K1/K2/K4 (E = Bf16) and K11 (E = S8); the __global__
// kernels below name it.
template <typename E, int BN, typename OutT, bool STATS>
__device__ __forceinline__ void conv_body(const CUtensorMap* mx,
                                          const CUtensorMap* mw,
                                          const CUtensorMap* my,
                                          const Params& p) {
  constexpr int BK = E::BK;
  constexpr int B_BYTES = BN * ROW;
  typedef typename E::Acc Acc;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stages = p.stages;
  uint8_t* a_s = smem;
  uint8_t* b_s = a_s + stages * A_BYTES;
  float* red = reinterpret_cast<float*>(b_s + stages * B_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(red) + (STATS ? 2 * 8 * BN * 4 : 0));
  const uint32_t full0 = hg::smem_u32(bars);
  const uint32_t empty0 = full0 + STAGES * 8;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile = blockIdx.x;
  const int tx = tile % p.tiles_w;
  const int rest = tile / p.tiles_w;
  const int ty = rest % p.tiles_h;
  const int tz = rest / p.tiles_h;
  const int ow0 = tx << p.lbw, oh0 = ty << p.lbh, n0 = tz << p.lbn;
  const int co0 = blockIdx.y * BN;
  const int s0 = blockIdx.z * p.per;
  const int nsteps = min(p.steps, s0 + p.per) - s0;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hg::mbar_init(full0 + 8 * s, 1);
      hg::mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    hg::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    // ---- producer: one thread issues every load ----
    if (lane != 0) return;
    hg::tma_prefetch(mx);
    hg::tma_prefetch(mw);
    int tap = s0 / p.c_chunks;
    int cc = s0 - tap * p.c_chunks;
    int ky = tap / p.kw;
    int kx = tap - ky * p.kw;
    int stage = 0;
    uint32_t phase = 0;
    for (int i = 0; i < nsteps; ++i) {
      const uint32_t full = full0 + 8 * stage;
      hg::mbar_wait(empty0 + 8 * stage, phase ^ 1);
      hg::mbar_expect_tx(full, A_BYTES + B_BYTES);
      const int c0 = cc * BK;
      const uint32_t a_dst = hg::smem_u32(a_s + stage * A_BYTES);
      if (p.flat)
        hg::tma_load_2d(a_dst, mx, full, c0, ow0);
      else
        hg::tma_load_4d(a_dst, mx, full, c0, ow0 * p.sw - p.pw + kx * p.dw,
                        oh0 * p.sh - p.ph + ky * p.dh, n0);
      hg::tma_load_3d(hg::smem_u32(b_s + stage * B_BYTES), mw, full, c0,
                      p.flip ? p.taps - 1 - tap : tap, co0);
      if (++cc == p.c_chunks) {
        cc = 0;
        ++tap;
        if (++kx == p.kw) {
          kx = 0;
          ++ky;
        }
      }
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns pixel rows wg*64 .. +64 ----
  const int wg = warp >> 2;
  Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const uint32_t a_base = hg::smem_u32(a_s) + wg * 64 * 128;
  const uint32_t b_base = hg::smem_u32(b_s);
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int i = 0; i < nsteps; ++i) {
    hg::mbar_wait(full0 + 8 * stage, phase);
    const uint64_t da = hg::desc_sw128(a_base + stage * A_BYTES, 16, 1024);
    const uint64_t db = hg::desc_sw128(b_base + stage * B_BYTES, 16, 1024);
    hg::wgmma_fence();
    E::template mma<BN>(acc, da, db);
    hg::wgmma_commit();
    hg::fence_regs(acc);
    hg::wgmma_wait<1>();  // the previous step's products are done
    hg::fence_regs(acc);
    if (i > 0 && lane == 0) hg::mbar_arrive(empty0 + 8 * prev);
    prev = stage;
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  hg::wgmma_wait<0>();
  hg::fence_regs(acc);

  // ---- epilogue on the accumulator layout ----
  const int wl = warp & 3;
  long long m_row[2];
  bool ok_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + wl * 16 + (lane >> 2) + 8 * h;
    const int bw_i = r & ((1 << p.lbw) - 1);
    const int bh_i = (r >> p.lbw) & ((1 << p.lbh) - 1);
    const int bn_i = r >> (p.lbw + p.lbh);
    const int n = n0 + bn_i, oh = oh0 + bh_i, ow = ow0 + bw_i;
    ok_row[h] = n < p.gn && oh < p.goh && ow < p.gow;
    m_row[h] = ((long long)n * p.goh + oh) * p.gow + ow;
  }
  const int colbase = co0 + 2 * (lane & 3);
  const bool split = p.splits > 1;
  // bf16 unsplit: the tile goes through shared memory (the ring is free
  // once both warpgroups are done) and out by TMA stores, 128-byte rows,
  // which clip the rows and channels past the output's edge
  constexpr bool kBf16 = sizeof(OutT) == 2;
  const bool via_tma = kBf16 && !split;
  // K11's dequant scales of columns col, col + 1 (1 for K1; 0 past Co)
  auto scales = [&](int col, float& d0, float& d1) {
    d0 = d1 = 1.0f;
    if constexpr (E::DEQUANT) {
      d0 = col < p.co ? p.dq[col] : 0.0f;
      d1 = col < p.co ? p.dq[col + 1] : 0.0f;
    }
  };
  if (via_tma) {
    hg::consumers_sync(256);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float d0, d1;
      scales(colbase + 8 * j, d0, d1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * 64 + wl * 16 + (lane >> 2) + 8 * h;
        // 64-channel half j/8, 16-byte chunk j%8 of row r, 128-byte swizzle
        const int off = (j >> 3) * (BM * 128) + r * 128 +
                        (((j & 7) ^ (r & 7)) << 4) + (lane & 3) * 4;
        *reinterpret_cast<__nv_bfloat162*>(smem + off) = __floats2bfloat162_rn(
            E::value(acc[4 * j + 2 * h], d0),
            E::value(acc[4 * j + 2 * h + 1], d1));
      }
    }
    hg::fence_proxy_async();
    hg::consumers_sync(256);
    if (tid == 0) {
#pragma unroll
      for (int half = 0; half < BN / 64; ++half) {
        const uint32_t src = hg::smem_u32(smem + half * BM * 128);
        if (p.flat)
          hg::tma_store_2d(my, src, co0 + 64 * half, ow0);
        else
          hg::tma_store_4d(my, src, co0 + 64 * half, ow0, oh0, n0);
      }
      hg::tma_store_drain();
    }
  }
  OutT* y = static_cast<OutT*>(p.y);
  Acc* ws = split ? static_cast<Acc*>(p.ws) + (long long)blockIdx.z * p.M * p.co
                  : nullptr;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = colbase + 8 * j;
    const bool col_ok = col < p.co;
    if (!via_tma) {
      float d0 = 1.0f, d1 = 1.0f;
      if (!split) scales(col, d0, d1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (ok_row[h] && col_ok) {
          const Acc a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
          if (split)
            store2(ws + m_row[h] * p.co + col, a, b);
          else
            store2(y + m_row[h] * p.co + col, E::value(a, d0),
                   E::value(b, d1));
        }
      }
    }
    if constexpr (STATS) {
      if (!split) {
        float s[2], q[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v0 = ok_row[0] ? rounded(acc[4 * j + e], y) : 0.0f;
          const float v1 = ok_row[1] ? rounded(acc[4 * j + 2 + e], y) : 0.0f;
          s[e] = v0 + v1;
          q[e] = v0 * v0 + v1 * v1;
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s[e] += __shfl_xor_sync(0xffffffffu, s[e], off);
            q[e] += __shfl_xor_sync(0xffffffffu, q[e], off);
          }
        if (lane < 4) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * lane + e;
            red[(0 * 8 + warp) * BN + c] = s[e];
            red[(1 * 8 + warp) * BN + c] = q[e];
          }
        }
      }
    }
  }
  if constexpr (STATS) {
    if (!split) {
      hg::consumers_sync(256);
      if (tid < BN && co0 + tid < p.co) {
        float s = 0.0f, q = 0.0f;
        for (int w = 0; w < 8; ++w) {  // the tile's rows, in order
          s += red[w * BN + tid];
          q += red[(8 + w) * BN + tid];
        }
        const long long o = (long long)tile * p.co + co0 + tid;
        p.part_sum[o] = s;
        p.part_sq[o] = q;
      }
    }
  }
}

template <int BN, typename OutT, bool STATS>
__global__ void __launch_bounds__(THREADS, 2)
    conv2d_fwd_kernel(const __grid_constant__ CUtensorMap mx,
                      const __grid_constant__ CUtensorMap mw,
                      const __grid_constant__ CUtensorMap my,
                      const __grid_constant__ Params p) {
  conv_body<Bf16, BN, OutT, STATS>(&mx, &mw, &my, p);
}

template <int BN, typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
    conv2d_fwd_q8_kernel(const __grid_constant__ CUtensorMap mx,
                         const __grid_constant__ CUtensorMap mw,
                         const __grid_constant__ CUtensorMap my,
                         const __grid_constant__ Params p) {
  conv_body<S8, BN, OutT, false>(&mx, &mw, &my, p);
}

// y[r, c..c+3] = sum over the splits, in order, of ws[z, r, c..c+3],
// rounded once. One thread per 4 outputs: every load is in flight at once.
template <typename OutT>
__global__ void splitk_reduce_kernel(const float* __restrict__ ws, int splits,
                                     long long M, int co,
                                     OutT* __restrict__ y) {
  const long long i =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;  // r * co + c
  if (i >= M * co) return;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int z = 0; z < splits; ++z) {
    const float4 t = *reinterpret_cast<const float4*>(ws + z * M * co + i);
    v.x += t.x;
    v.y += t.y;
    v.z += t.z;
    v.w += t.w;
  }
  store2(y + i, v.x, v.y);
  store2(y + i + 2, v.z, v.w);
}

// K11: y[r, c..c+3] = the in-order sum over the splits of the int32
// ws[z, r, c..c+3] (exact), dequantized and rounded once. Co % 16 == 0, so
// the four columns lie in one row.
template <typename OutT>
__global__ void splitk_reduce_q8_kernel(const int* __restrict__ ws,
                                        int splits, long long M, int co,
                                        const float* __restrict__ dq,
                                        OutT* __restrict__ y) {
  const long long i =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;  // r * co + c
  if (i >= M * co) return;
  int4 v = make_int4(0, 0, 0, 0);
  for (int z = 0; z < splits; ++z) {
    const int4 t = *reinterpret_cast<const int4*>(ws + z * M * co + i);
    v.x += t.x;
    v.y += t.y;
    v.z += t.z;
    v.w += t.w;
  }
  const int c = (int)(i % co);
  store2(y + i, S8::value(v.x, dq[c]), S8::value(v.y, dq[c + 1]));
  store2(y + i + 2, S8::value(v.z, dq[c + 2]), S8::value(v.w, dq[c + 3]));
}

// K4 split: part_sum[b, c] = the sum of y[r, c] (y already rounded) over
// rows b*128 .. +128, in a fixed order (8 runs of 16 rows each summed in
// order, then the runs in order); part_sq likewise of y^2. 32 channels x 8
// runs a block.
template <typename OutT>
__global__ void __launch_bounds__(256)
    stats_rows_kernel(const OutT* __restrict__ y, long long M, int co,
                      float* __restrict__ part_sum,
                      float* __restrict__ part_sq) {
  __shared__ float red[2][8][32];
  const int cl = threadIdx.x & 31;
  const int k = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 + cl;
  const long long r0 = (long long)blockIdx.x * 128 + k * 16;
  float s = 0.0f, q = 0.0f;
  if (c < co) {
    float v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u)
      v[u] = r0 + u < M ? as_float(y[(r0 + u) * co + c]) : 0.0f;
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      s += v[u];
      q += v[u] * v[u];
    }
  }
  red[0][k][cl] = s;
  red[1][k][cl] = q;
  __syncthreads();
  if (k == 0 && c < co) {
    s = q = 0.0f;
    for (int kk = 0; kk < 8; ++kk) {
      s += red[0][kk][cl];
      q += red[1][kk][cl];
    }
    part_sum[(long long)blockIdx.x * co + c] = s;
    part_sq[(long long)blockIdx.x * co + c] = q;
  }
}

// csum[c] = the sum over the rows of part_sum[t, c], in a fixed order: 8
// contiguous row ranges each summed in order, then the 8 partials in
// order; csq likewise. 32 channels x 8 ranges a block.
__global__ void __launch_bounds__(256)
    stats_reduce_kernel(const float* __restrict__ part_sum,
                        const float* __restrict__ part_sq, int rows, int co,
                        float* __restrict__ csum, float* __restrict__ csq) {
  __shared__ float red[2][8][32];
  const int cl = threadIdx.x & 31;
  const int k = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + cl;
  const int per = (rows + 7) / 8;
  const int t0 = k * per;
  const int t1 = min(rows, t0 + per);
  float s = 0.0f, q = 0.0f;
  if (c < co) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) {
      s += part_sum[(long long)t * co + c];
      q += part_sq[(long long)t * co + c];
    }
  }
  red[0][k][cl] = s;
  red[1][k][cl] = q;
  __syncthreads();
  if (k == 0 && c < co) {
    s = q = 0.0f;
    for (int kk = 0; kk < 8; ++kk) {
      s += red[0][kk][cl];
      q += red[1][kk][cl];
    }
    csum[c] = s;
    csq[c] = q;
  }
}

template <typename Kernel>
int launch_kernel(Kernel kernel, bool* attr, int max_smem, int smem,
                  const CUtensorMap& mx, const CUtensorMap& mw,
                  const CUtensorMap& my, const Params& p, dim3 grid,
                  cudaStream_t s) {
  if (!*attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (e != cudaSuccess) return (int)e;
    *attr = true;
  }
  kernel<<<grid, THREADS, smem, s>>>(mx, mw, my, p);
  return (int)cudaGetLastError();
}

template <int BN, typename OutT, bool STATS>
int launch(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& my,
           const Params& p, dim3 grid, cudaStream_t s) {
  static bool attr = false;
  return launch_kernel(conv2d_fwd_kernel<BN, OutT, STATS>, &attr,
                       smem_bytes<BN>(STAGES, STATS),
                       smem_bytes<BN>(p.stages, STATS), mx, mw, my, p, grid, s);
}

template <int BN>
int launch_bn(const CUtensorMap& mx, const CUtensorMap& mw,
              const CUtensorMap& my, const Params& p, dim3 grid, int out_f32,
              int stats, cudaStream_t s) {
  if (stats)
    return out_f32 ? launch<BN, float, true>(mx, mw, my, p, grid, s)
                   : launch<BN, bf16, true>(mx, mw, my, p, grid, s);
  return out_f32 ? launch<BN, float, false>(mx, mw, my, p, grid, s)
                 : launch<BN, bf16, false>(mx, mw, my, p, grid, s);
}

template <int BN, typename OutT>
int launch_q8(const CUtensorMap& mx, const CUtensorMap& mw,
              const CUtensorMap& my, const Params& p, dim3 grid,
              cudaStream_t s) {
  static bool attr = false;
  return launch_kernel(conv2d_fwd_q8_kernel<BN, OutT>, &attr,
                       smem_bytes<BN>(STAGES, false),
                       smem_bytes<BN>(p.stages, false), mx, mw, my, p, grid,
                       s);
}

// The tensor maps of one call (x and w of element type E, y bf16 when it
// leaves by TMA stores, that is bf16 and unsplit) and the kernel's
// parameters and grid, from the plan. Returns 0 or a CUDA error code.
template <typename E>
int prepare(const void* x, const void* w, void* y, int n, int h, int w_,
            int ci, int co, int kh, int kw, int oh, int ow, int sh, int sw,
            int ph, int pw, int dh, int dw, int flip, int flat, int lbn,
            int lbh, int lbw, int block_n, int splits, int per, int stages,
            int out_f32, CUtensorMap* mx, CUtensorMap* mw, CUtensorMap* my,
            Params* pp, dim3* grid) {
  constexpr int BK = E::BK;
  constexpr uint64_t SZ = E::SIZE;
  const long long M = (long long)n * oh * ow;
  int rc;
  if (flat) {
    const uint64_t dims[2] = {(uint64_t)ci, (uint64_t)M};
    const uint64_t strides[1] = {(uint64_t)ci * SZ};
    const uint32_t box[2] = {BK, BM};
    const uint32_t estr[2] = {1, 1};
    rc = hg::make_map_typed(mx, E::MAP, CU_TENSOR_MAP_SWIZZLE_128B, x, 2, dims,
                            strides, box, estr);
    if (rc == 0 && !out_f32 && splits == 1) {  // y: [M, Co]
      const uint64_t ydims[2] = {(uint64_t)co, (uint64_t)M};
      const uint64_t ystr[1] = {(uint64_t)co * 2};
      const uint32_t ybox[2] = {64, BM};
      rc = hg::make_map(my, y, 2, ydims, ystr, ybox, estr);
    }
  } else {
    const uint64_t dims[4] = {(uint64_t)ci, (uint64_t)w_, (uint64_t)h,
                              (uint64_t)n};
    const uint64_t strides[3] = {(uint64_t)ci * SZ, (uint64_t)w_ * ci * SZ,
                                 (uint64_t)h * w_ * ci * SZ};
    const uint32_t box[4] = {BK, (uint32_t)((1 << lbw) * sw),
                             (uint32_t)((1 << lbh) * sh), (uint32_t)(1 << lbn)};
    const uint32_t estr[4] = {1, (uint32_t)sw, (uint32_t)sh, 1};
    rc = hg::make_map_typed(mx, E::MAP, CU_TENSOR_MAP_SWIZZLE_128B, x, 4, dims,
                            strides, box, estr);
    if (rc == 0 && !out_f32 && splits == 1) {  // y: [N, OH, OW, Co]
      const uint64_t ydims[4] = {(uint64_t)co, (uint64_t)ow, (uint64_t)oh,
                                 (uint64_t)n};
      const uint64_t ystr[3] = {(uint64_t)co * 2, (uint64_t)ow * co * 2,
                                (uint64_t)oh * ow * co * 2};
      const uint32_t ybox[4] = {64, (uint32_t)(1 << lbw), (uint32_t)(1 << lbh),
                                (uint32_t)(1 << lbn)};
      const uint32_t one[4] = {1, 1, 1, 1};
      rc = hg::make_map(my, y, 4, ydims, ystr, ybox, one);
    }
  }
  if (rc != 0) return rc;
  {
    const uint64_t dims[3] = {(uint64_t)ci, (uint64_t)kh * kw, (uint64_t)co};
    const uint64_t strides[2] = {(uint64_t)ci * SZ,
                                 (uint64_t)kh * kw * ci * SZ};
    const uint32_t box[3] = {BK, 1, (uint32_t)block_n};
    const uint32_t estr[3] = {1, 1, 1};
    rc = hg::make_map_typed(mw, E::MAP, CU_TENSOR_MAP_SWIZZLE_128B, w, 3, dims,
                            strides, box, estr);
    if (rc != 0) return rc;
  }
  Params& p = *pp;
  p.y = y;
  p.M = M;
  p.ci = ci, p.co = co, p.kw = kw, p.sh = sh, p.sw = sw, p.ph = ph, p.pw = pw;
  p.dh = dh, p.dw = dw;
  p.flat = flat, p.flip = flip, p.lbn = lbn, p.lbh = lbh, p.lbw = lbw;
  if (flat) {
    p.gn = 1, p.goh = 1, p.gow = (int)M;
  } else {
    p.gn = n, p.goh = oh, p.gow = ow;
  }
  p.tiles_w = (p.gow + (1 << lbw) - 1) >> lbw;
  p.tiles_h = (p.goh + (1 << lbh) - 1) >> lbh;
  const int tiles_n = (p.gn + (1 << lbn) - 1) >> lbn;
  p.c_chunks = (ci + BK - 1) / BK;
  p.taps = kh * kw;
  p.steps = p.taps * p.c_chunks;
  p.splits = splits, p.per = per;
  // a consumer frees a stage only once the next one has arrived, so a
  // ring of one stage holds a single step
  p.stages = stages > STAGES ? STAGES : stages < 2 && per > 1 ? 2 : stages;
  *grid = dim3((unsigned)(p.tiles_w * p.tiles_h * tiles_n),
               (unsigned)((co + block_n - 1) / block_n), (unsigned)splits);
  return 0;
}

}  // namespace

// K1 (stats = 0) and K4 (stats = 1): y = conv(x, w) and, for K4, csum/csq
// [Co] of the rounded y. w is OHWI; `flip` reads its taps in reverse (K2's
// flipped filter, whose channel axes the wrapper swapped). The plan comes
// from the wrapper
// (conv_cuda.conv_plan): `flat` A, the tile's box as log2 of its images,
// rows and columns, the N tile (64 or 128), and the split of the K steps.
// ws is [splits, M, Co] f32 (unused unsplit); part_sum / part_sq are
// [rows, Co] f32 with rows = the tiles unsplit, ceil(M / 128) split.
extern "C" int conv2d_fwd(const void* x, const void* w, void* y, void* ws,
                          void* part_sum, void* part_sq, void* csum, void* csq,
                          int n, int h, int w_, int ci, int co, int kh, int kw,
                          int oh, int ow, int sh, int sw, int ph, int pw,
                          int dh, int dw, int flip, int flat, int lbn,
                          int lbh, int lbw,
                          int block_n, int splits, int per, int stages,
                          int out_f32, int stats, void* stream) {
  CUtensorMap mx, mw, my{};
  Params p{};
  dim3 grid;
  int rc = prepare<Bf16>(x, w, y, n, h, w_, ci, co, kh, kw, oh, ow, sh, sw, ph,
                         pw, dh, dw, flip, flat, lbn, lbh, lbw, block_n,
                         splits, per, stages, out_f32, &mx, &mw, &my, &p,
                         &grid);
  if (rc != 0) return rc;
  const long long M = p.M;
  const int tiles = (int)grid.x;
  p.ws = ws;
  p.part_sum = static_cast<float*>(part_sum);
  p.part_sq = static_cast<float*>(part_sq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = block_n == 64 ? launch_bn<64>(mx, mw, my, p, grid, out_f32, stats, s)
                     : launch_bn<128>(mx, mw, my, p, grid, out_f32, stats, s);
  if (rc != 0) return rc;
  int rows = tiles;
  if (splits > 1) {
    const unsigned blocks = (unsigned)((M * co / 4 + 255) / 256);
    const float* wsf = static_cast<const float*>(ws);
    if (out_f32)
      splitk_reduce_kernel<float><<<blocks, 256, 0, s>>>(
          wsf, splits, M, co, static_cast<float*>(y));
    else
      splitk_reduce_kernel<bf16><<<blocks, 256, 0, s>>>(
          wsf, splits, M, co, static_cast<bf16*>(y));
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    if (stats) {
      rows = (int)((M + 127) / 128);
      dim3 sgrid((unsigned)rows, (unsigned)((co + 31) / 32));
      float* ps = static_cast<float*>(part_sum);
      float* pq = static_cast<float*>(part_sq);
      if (out_f32)
        stats_rows_kernel<float><<<sgrid, 256, 0, s>>>(
            static_cast<const float*>(y), M, co, ps, pq);
      else
        stats_rows_kernel<bf16><<<sgrid, 256, 0, s>>>(
            static_cast<const bf16*>(y), M, co, ps, pq);
      rc = (int)cudaGetLastError();
      if (rc != 0) return rc;
    }
  }
  if (stats) {
    stats_reduce_kernel<<<(co + 31) / 32, 256, 0, s>>>(
        static_cast<float*>(part_sum), static_cast<float*>(part_sq), rows, co,
        static_cast<float*>(csum), static_cast<float*>(csq));
    rc = (int)cudaGetLastError();
  }
  return rc;
}

// K11: y = dequant(conv(x, w)) for int8 x (NHWC) and w (OHWI), dq [Co] f32,
// y bf16 (or f32, out_f32) NHWC; the plan as K1's (conv_cuda.conv_plan
// with the element size: 128-channel steps); ws is [splits, M, Co] int32
// (unused unsplit). Returns the CUDA error code.
extern "C" int conv2d_q8(const void* x, const void* w, const void* dq,
                         void* y, void* ws, int n, int h, int w_, int ci,
                         int co, int kh, int kw, int oh, int ow, int sh,
                         int sw, int ph, int pw, int dh, int dw, int flat,
                         int lbn, int lbh, int lbw, int block_n, int splits,
                         int per, int stages, int out_f32, void* stream) {
  CUtensorMap mx, mw, my{};
  Params p{};
  dim3 grid;
  int rc = prepare<S8>(x, w, y, n, h, w_, ci, co, kh, kw, oh, ow, sh, sw, ph,
                       pw, dh, dw, 0, flat, lbn, lbh, lbw, block_n, splits,
                       per, stages, out_f32, &mx, &mw, &my, &p, &grid);
  if (rc != 0) return rc;
  p.ws = ws;
  p.dq = static_cast<const float*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_n == 64)
    rc = out_f32 ? launch_q8<64, float>(mx, mw, my, p, grid, s)
                 : launch_q8<64, bf16>(mx, mw, my, p, grid, s);
  else
    rc = out_f32 ? launch_q8<128, float>(mx, mw, my, p, grid, s)
                 : launch_q8<128, bf16>(mx, mw, my, p, grid, s);
  if (rc != 0 || splits == 1) return rc;
  const long long M = p.M;
  const unsigned blocks = (unsigned)((M * co / 4 + 255) / 256);
  const int* wsi = static_cast<const int*>(ws);
  if (out_f32)
    splitk_reduce_q8_kernel<float><<<blocks, 256, 0, s>>>(
        wsi, splits, M, co, p.dq, static_cast<float*>(y));
  else
    splitk_reduce_q8_kernel<bf16><<<blocks, 256, 0, s>>>(
        wsi, splits, M, co, p.dq, static_cast<bf16*>(y));
  return (int)cudaGetLastError();
}
