// Shared pieces of the f32 flash-attention kernels on Hopper's tf32 wgmma:
// the forward (K7, flash_attn_fwd_tf32.cu) and the backward (K8, K9,
// flash_attn_bwd_tf32.cu). Both run a CTA of one consumer warpgroup (64
// resident rows), three split warps and a TMA warp, and every product as
// three tf32 passes (3xTF32): x = hi + lo with hi the top 19 bits of x
// (truncated: what the tensor cores read of a raw f32, so a raw tile serves
// as its own hi) and lo = x - hi (exact) rounded to the nearest tf32; a*b
// is taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b. tf32 wgmma has no
// transpose bits, so both shared-memory operands of a product are K-major;
// the split warps write each landed tile's lo and, where a product reduces
// over the tile's rows, its transposed hi and lo (`split_tile`).

#pragma once

#include "flash_attn_common.cuh"

namespace flash_tf32 {

constexpr int ROWS = 64;              // resident rows (one consumer warpgroup)
constexpr int BLOCK = 32;             // f32 columns of a 128-byte tile row
constexpr int SPLIT_THREADS = 96;     // warps 4-6
constexpr int THREADS = 256;          // consumers, split warps, TMA warp 7
constexpr int TMA_WARP = 7;

// ---- tf32 pieces ---------------------------------------------------------------

// lo of x: x minus its truncation to tf32 (exact), rounded to the nearest
// tf32
__device__ __forceinline__ uint32_t tf32_lo(float x) {
  const float hi = __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x - hi));
  return r;
}

// Byte offset of 16-byte chunk `c` (0..7) of row `r` in a block of
// 128-byte rows with the 128-byte swizzle.
__device__ __forceinline__ int chunk_at(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// The split pass over a raw [R][DP] tile (DP/32 blocks of R 128-byte rows,
// as TMA lands it): LO writes lo in the same layout; TR writes the
// transposed hi and lo, [DP][R] in R/32 blocks of DP rows, each 8-row
// step's k order permuted (row 8q + 2i + e at position 8q + 4e + i). A
// unit is 4 rows (8q + e + 2i, i = 0..3) x 4 columns; the 8 lanes of a
// quarter warp take 8 units whose reads, lo writes and transposed writes
// each fall in 8 distinct 16-byte bank groups.
template <int R, int DP, bool LO, bool TR>
__device__ __forceinline__ void split_tile(const uint8_t* raw, uint8_t* lo,
                                           uint8_t* th, uint8_t* tl,
                                           int ptid) {
  constexpr int UNITS = R * DP / 16;
#pragma unroll 1
  for (int u = ptid; u < UNITS; u += SPLIT_THREADS) {
    const int k = u & 7;
    const int c4b = (u >> 3) & 1;
    const int s = (u >> 4) & 3;
    const int rest = u >> 6;
    const int cb = rest % (DP / BLOCK);   // column block
    const int qh = rest / (DP / BLOCK);   // block of 32 rows
    const int e = k & 1;
    const int c4 = ((k & 6) ^ (2 * s)) | c4b;  // 16-byte chunk in the block
    const int q = (k >> 1) + 4 * qh;           // 8-row step
    const int blk = cb * R * 128;
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(
          raw + blk + chunk_at(8 * q + e + 2 * i, c4));
    uint4 l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      l[i] = make_uint4(tf32_lo(x[i].x), tf32_lo(x[i].y), tf32_lo(x[i].z),
                        tf32_lo(x[i].w));
    if constexpr (LO) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint4*>(lo + blk + chunk_at(8 * q + e + 2 * i, c4)) =
            l[i];
    }
    if constexpr (TR) {
      const int tb = qh * DP * 128;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int off = tb + chunk_at(BLOCK * cb + 4 * c4 + m, k);
        const float* h0 = reinterpret_cast<const float*>(&x[0]);
        const float* h1 = reinterpret_cast<const float*>(&x[1]);
        const float* h2 = reinterpret_cast<const float*>(&x[2]);
        const float* h3 = reinterpret_cast<const float*>(&x[3]);
        *reinterpret_cast<float4*>(th + off) =
            make_float4(h0[m], h1[m], h2[m], h3[m]);
        const uint32_t* l0 = reinterpret_cast<const uint32_t*>(&l[0]);
        const uint32_t* l1 = reinterpret_cast<const uint32_t*>(&l[1]);
        const uint32_t* l2 = reinterpret_cast<const uint32_t*>(&l[2]);
        const uint32_t* l3 = reinterpret_cast<const uint32_t*>(&l[3]);
        *reinterpret_cast<uint4*>(tl + off) =
            make_uint4(l0[m], l1[m], l2[m], l3[m]);
      }
    }
  }
}

// Descriptor of k8 step kk of a K-major operand tile of R rows at `base`.
template <int R>
__device__ __forceinline__ uint64_t kdesc(uint32_t base, int kk) {
  return hg::desc_sw128(base + (kk >> 2) * (R * 128) + (kk & 3) * 32, 16,
                        1024);
}

// d (+)= A B in three tf32 passes, A (M 64) and B (N rows) K-major in
// shared memory as raw tiles (their hi) and lo tiles, K = DP; the first
// pass sets d when `zero`.
template <int N, int AR, int DP>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint32_t a,
                                           uint32_t a_lo, uint32_t b,
                                           uint32_t b_lo, bool zero) {
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk)
    hg::wgmma_tf32_ss<N>(d, kdesc<AR>(a_lo, kk), kdesc<N>(b, kk),
                         (zero && kk == 0) ? 0 : 1);
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk)
    hg::wgmma_tf32_ss<N>(d, kdesc<AR>(a, kk), kdesc<N>(b_lo, kk), 1);
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk)
    hg::wgmma_tf32_ss<N>(d, kdesc<AR>(a, kk), kdesc<N>(b, kk), 1);
}

// The register A operand of k8 step kk of an f32 accumulator of width BN,
// its k order permuted as the transposed tiles' is: hi the raw values (the
// tensor cores truncate them), lo in `lo`.
template <int BN>
__device__ __forceinline__ void acc_hi(uint32_t (&a)[4],
                                       const float (&d)[BN / 2], int kk) {
  a[0] = __float_as_uint(d[4 * kk + 0]);
  a[1] = __float_as_uint(d[4 * kk + 2]);
  a[2] = __float_as_uint(d[4 * kk + 1]);
  a[3] = __float_as_uint(d[4 * kk + 3]);
}

template <int BN>
__device__ __forceinline__ void acc_lo(uint32_t (&a)[4],
                                       const float (&d)[BN / 2], int kk) {
  a[0] = tf32_lo(d[4 * kk + 0]);
  a[1] = tf32_lo(d[4 * kk + 2]);
  a[2] = tf32_lo(d[4 * kk + 1]);
  a[3] = tf32_lo(d[4 * kk + 3]);
}

// part = A B in three tf32 passes, A (M 64, K = BN) the accumulator `src`
// from registers, B the transposed hi/lo tiles [DP][BN] (N = DP), or N < DP
// of their rows from bt_hi and bt_lo (a piece of the product's columns).
template <int DP, int BN, int N = DP>
__device__ __forceinline__ void product_rs(float (&part)[N / 2],
                                           const float (&src)[BN / 2],
                                           uint32_t (&ah)[BN / 8][4],
                                           uint32_t (&al)[BN / 8][4],
                                           uint32_t bt_hi, uint32_t bt_lo) {
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    acc_hi<BN>(ah[kk], src, kk);
    acc_lo<BN>(al[kk], src, kk);
  }
  hg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    hg::wgmma_tf32_rs<N>(part, al[kk], kdesc<DP>(bt_hi, kk), kk > 0);
    hg::wgmma_tf32_rs<N>(part, ah[kk], kdesc<DP>(bt_lo, kk), 1);
    hg::wgmma_tf32_rs<N>(part, ah[kk], kdesc<DP>(bt_hi, kk), 1);
  }
}

template <int BN>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[BN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) hg::fence_regs(a[kk]);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

inline bool bad_head_dim(int d) { return d % 16 != 0 || d > 128 || d <= 0; }

}  // namespace flash_tf32
