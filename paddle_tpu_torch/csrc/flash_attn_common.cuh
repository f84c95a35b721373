// Shared pieces of the flash-attention kernels (K7 in flash_attn_fwd.cu, K8
// and K9 in flash_attn_bwd.cu), for sm_90a.
//
// Layout. q, k, v, o, dO and the gradients are [B, T, H, D] bf16, read and
// written in place: row t of head h of batch b starts at
// ((b*T + t)*H + h)*D, so a (b, h) slice is a [T, D] matrix with row stride
// H*D. lse and delta are [B, H, T] f32. No transpose copies bracket the
// kernels.
//
// Tiles. One CTA of 4 warps owns 64 "resident" rows (queries in K7/K8, keys
// in K9), 16 rows a warp, and streams the other side through a two-stage
// cp.async ring in shared memory. The head dim is padded to DP (64 or 128)
// in shared memory; the pad columns are zero-filled, so they add nothing to
// any product, and are never stored. Rows past T are zero-filled too and
// masked in the scores.
//
// Products. mma.sync m16n8k16 bf16 x bf16 -> f32. Operand fragments are
// read from shared memory with 32-bit loads (row strides padded by 8 bf16,
// so the 32 lanes of a load hit 32 banks); a B operand stored [k][n]
// (n contiguous) is gathered two bf16 at a time. An f32 accumulator
// fragment of one product becomes the A operand of the next without
// leaving registers (C -> A reuse), rounded to bf16 on the way: that is
// the kernels' rounding of P and dS.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA), g = lane / 4, t = lane % 4:
//   A (16x16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..2t+1),
//                         a[2] = (g, 2t+8..2t+9), a[3] = (g+8, 2t+8..2t+9)
//   B (16x8, k x n):      b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8..2t+9, n g)
//   C (16x8, f32):        c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128;    // 4 warps
constexpr int ROWS = 64;        // resident rows per CTA, 16 per warp
constexpr float MASKED = -1e30f;  // the reference's causal mask value

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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// two f32 rounded to bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A, 16x16 at (r0, k0) of a row-major shared matrix with row stride ld
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* s, int ld,
                                       int r0, int k0, int g, int t) {
  const bf16* p = s + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B, 16x8 (k x n) at (k0, n0), of a shared matrix stored [n][k]
__device__ __forceinline__ void load_b_nk(uint32_t* b, const bf16* s, int ld,
                                          int n0, int k0, int g, int t) {
  const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B, 16x8 (k x n) at (k0, n0), of a shared matrix stored [k][n]
__device__ __forceinline__ void load_b_kn(uint32_t* b, const bf16* s, int ld,
                                          int k0, int n0, int g, int t) {
  const bf16* p = s + (k0 + 2 * t) * ld + n0 + g;
  b[0] = pack(p[0], p[ld]);
  b[1] = pack(p[8 * ld], p[9 * ld]);
}

// The A fragment (16 rows x 16 columns kk*16..) of a 16 x (8*NT) f32
// accumulator, rounded to bf16: C -> A reuse.
__device__ __forceinline__ void c_to_a(uint32_t* a, float (*c)[4], int kk) {
  a[0] = pack_rn(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_rn(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_rn(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_rn(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Copy rows row0 .. row0+R-1 (of nrows) and columns 0 .. DP-1 (of d) of a
// [T, D] slice with row stride `stride` into shared memory with row stride
// DP + 8; rows and columns outside are zero-filled. Issues cp.async only.
template <int R, int DP>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* gsrc, int row0,
                                          int nrows, int d, long long stride,
                                          int tid) {
  constexpr int CH = DP / 8;  // 16-byte chunks per row
  for (int i = tid; i < R * CH; i += THREADS) {
    const int r = i / CH;
    const int c = (i - r * CH) * 8;
    const bool ok = (row0 + r < nrows) && (c < d);
    const bf16* src = ok ? gsrc + (long long)(row0 + r) * stride + c : gsrc;
    cp_async16(s + r * (DP + 8) + c, src, ok);
  }
}

// Number of key tiles (of BK) that a causal query tile whose last real row
// is `q_last` reaches; all of them without the mask.
__device__ __forceinline__ int key_tiles(int tk, int bk, bool causal,
                                         int q_last, int q_off, int k_off) {
  const int n = (tk + bk - 1) / bk;
  if (!causal) return n;
  const int last_key = q_off + q_last - k_off;  // keys <= this are visible
  if (last_key < 0) return 0;
  const int reach = last_key / bk + 1;
  return reach < n ? reach : n;
}

}  // namespace flash
