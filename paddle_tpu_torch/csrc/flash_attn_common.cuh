// Shared pieces of the flash-attention kernels: the bf16 Hopper kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu), the f32 ones on tf32 wgmma
// (flash_attn_fwd_tf32.cu, flash_attn_bwd_tf32.cu, through
// flash_attn_tf32.cuh).
//
// Layout. q, k, v, o, dO and the gradients are [B, T, H, D], read and
// written in place: row t of head h of batch b starts at ((b*T + t)*H +
// h)*D, so a (b, h) slice is a [T, D] matrix with row stride H*D. lse and
// delta are [B, H, Tq] f32. No transpose copies bracket the kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace flash {

constexpr float MASKED = -1e30f;  // the reference's causal mask value
// The forward's visiting granularity, that of the plain version
// (attention_cuda.ROWS, FWD_BLOCK_K): 64 query rows visit the 64-key
// tiles up to the one holding their last row's position.
constexpr int VISIT = 64;

// two f32 rounded to bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Number of key tiles (of bk) that a query tile whose last real row is
// `q_last` reaches under the causal mask: every tile not wholly past it.
__host__ __device__ __forceinline__ int key_tiles(int tk, int bk, bool causal,
                                                  int q_last, int q_off,
                                                  int k_off) {
  const int n = (tk + bk - 1) / bk;
  if (!causal) return n;
  const int last_key = q_off + q_last - k_off;  // keys <= this are visible
  if (last_key < 0) return 0;
  const int reach = last_key / bk + 1;
  return reach < n ? reach : n;
}

// How far the 64 query rows from `first` (of tq) walk in key tiles of bk:
// `n` tiles, the first `n_free` of them reached by no mask, keys at or past
// `lim` (the end of the 64-key tiles the plain version visits, or Tk)
// scored -inf. A forward kernel whose tiles are not VISIT keys wide gives
// the plain version's answer by it.
struct Walk {
  int n, n_free, lim;
};

__device__ __forceinline__ Walk walk_of(int tq, int tk, bool causal,
                                        int q_off, int k_off, int first,
                                        int bk) {
  Walk w{0, 0, 0};
  if (first >= tq) return w;
  const int last = min(first + 64, tq) - 1;
  const int visit = key_tiles(tk, VISIT, causal, last, q_off, k_off);
  w.lim = min(tk, visit * VISIT);
  w.n = (w.lim + bk - 1) / bk;
  w.n_free = w.lim / bk;
  if (causal) {
    // keys [0, x) are visible to every row of the group
    const int x = q_off + first - k_off + 1;
    w.n_free = min(w.n_free, x <= 0 ? 0 : x / bk);
  }
  return w;
}

// ---- the Hopper kernels' shared pieces ---------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit. The kernels take exp(y) as
// ex2(y * log2 e) with y = S*scale - m formed first, so a score the mask
// sets to -1e30 in a row whose max is -1e30 gives exactly exp(0) = 1, as
// the reference's exp(-1e30 - -1e30) does.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A 4-D tensor map over a [B, T, H, D] tensor of `T` (bf16 or f32) read in
// place: dims (D, H, T, B), box (one 128-byte row of columns: 64 bf16 or 32
// f32, 1 head, `rows` rows, 1 batch) with the 128-byte swizzle, so a box
// lands as `rows` 128-byte rows of one head. Columns past D and rows past T
// load as zeros. Returns 0 or a CUDA error code.
template <typename T = __nv_bfloat16>
inline int map_bthd(CUtensorMap* map, const void* ptr, int b, int t, int h,
                    int d, int rows) {
  static_assert(sizeof(T) == 2 || sizeof(T) == 4, "bf16 or f32");
  constexpr uint64_t E = sizeof(T);
  const uint64_t dims[4] = {(uint64_t)d, (uint64_t)h, (uint64_t)t,
                            (uint64_t)b};
  const uint64_t strides[3] = {(uint64_t)d * E, (uint64_t)h * d * E,
                               (uint64_t)t * h * d * E};
  const uint32_t box[4] = {(uint32_t)(128 / E), 1, (uint32_t)rows, 1};
  const uint32_t one[4] = {1, 1, 1, 1};
  return hg::make_map_typed(map,
                            E == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            CU_TENSOR_MAP_SWIZZLE_128B, ptr, 4, dims, strides,
                            box, one);
}

// A 2-D tensor map over [B, H, T] f32 row statistics (lse, delta) as [B*H,
// T]: box (`cols` positions, 1 row), no swizzle. Positions past T load as
// zeros.
inline int map_stats(CUtensorMap* map, const void* ptr, int bh, int t,
                     int cols) {
  const uint64_t dims[2] = {(uint64_t)t, (uint64_t)bh};
  const uint64_t strides[1] = {(uint64_t)t * 4};
  const uint32_t box[2] = {(uint32_t)cols, 1};
  const uint32_t one[2] = {1, 1};
  return hg::make_map_typed(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            CU_TENSOR_MAP_SWIZZLE_NONE, ptr, 2, dims, strides,
                            box, one);
}

// Lifts `kernel`'s dynamic shared memory limit to `smem` bytes on its first
// launch (`*done` false). Returns 0 or a CUDA error code.
template <typename Kernel>
int configure(Kernel kernel, int smem, bool* done) {
  if (*done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  *done = true;
  return 0;
}

// The shared memory of a Hopper kernel starts on a 1024-byte boundary, the
// 128-byte swizzle's period.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~uintptr_t(1023));
}

// The bf16 A fragment of one k16 step (columns 16*kk..) of an f32 wgmma
// accumulator d of layout m64nN (hopper_gemm.cuh): P or dS rounded to bf16
// for the next product.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&d)[N / 2], int kk) {
  a[0] = pack_rn(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_rn(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_rn(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_rn(d[8 * kk + 6], d[8 * kk + 7]);
}

}  // namespace flash
