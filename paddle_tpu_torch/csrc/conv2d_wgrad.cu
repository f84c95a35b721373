// conv2d filter gradient (K3) as an implicit GEMM on Hopper's wgmma, for
// sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_conv.py `conv2d_grad_filter`
// (:471) -> `_wgrad_kernel` (:282): dW[co, ci, ky, kx] = sum over n, oh, ow of
// dout[n, oh, ow, co] * x[n, oh*sh - ph + ky*dh, ow*sw - pw + kx*dw, ci],
// f32 accumulation rounded once to the filter's dtype (f32 master weights
// under AMP O2, bf16 when the filter is bf16).
//
// GEMM view: M = Co, N = KH*KW*Ci, and the reduction runs over the
// N*OH*OW output pixels. A block owns a (64 or 128 co) x (64 or 128 ci of
// one tap) tile and walks the pixels in 64-pixel slices. One producer warp
// keeps a ring of up to 6 stages (4 for the 64 x 64 tile; the plan's
// depth) full with TMA loads under full/empty mbarrier pairs;
// one consumer warpgroup per 64 output channels runs wgmma m64nBNk16 with
// both operands MN-major (the transpose bits): a slice's row is one pixel,
// holding 64 contiguous channels of dout (A = dout^T) or of x (B).
//
// Loads, all TMA:
// - FLAT (a stride-1 1x1 conv with no padding): dout and x are dense
//   [pixels, Co] and [pixels, Ci] matrices; a slice is 64 consecutive
//   pixels of each, through 2-D maps.
// - BOX (every other geometry): a slice is a box of bn images x bh rows x
//   bw columns of output pixels (bn*bh*bw = 64, chosen per shape by the
//   wrapper): dout through a 4-D map at (co0, ow0, oh0, n0), x through a
//   4-D map with element strides (1, sw, sh, 1) at the tap's shifted corner
//   (ow0*sw - pw + kx*dw, oh0*sh - ph + ky*dh, n0). TMA zero-fills what
//   lies outside each tensor: the padding of x, and the dout rows of a
//   ragged box, so those pixels add nothing.
// The slice's origin is carried forward from one slice to the next (no
// division per pixel or per slice); the old per-row decode is gone.
//
// Split reduction: grid z cuts the slices into `splits` contiguous ranges
// (`conv_cuda.wgrad_splits`, whose rule comes from timing candidate splits
// on the card). Each split writes its f32 tile to its own slice of a
// workspace [splits, Co, KH*KW*Ci]; a second kernel adds the slices in
// order and writes dW as [Co, Ci, KH, KW]. No atomics: a repeated call is
// bitwise equal.
//
// Requirements (checked by the Python gate and wrapper): Ci % 8 == 0 and
// Co % 8 == 0, 16-byte aligned pointers, contiguous NHWC x and dout.
//
// Bound on an H100: the larger of 2*Co*KH*KW*Ci*N*OH*OW FLOPs against
// 989 TF/s bf16 and the bytes of x, dout and dW against 3.35 TB/s. What
// still holds it back: the workspace round trip of the split, the masked
// pixels of ragged boxes (up to 23 % at 14x14 and 7x7 maps), and the
// small tiles of the 64-channel convs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using hg::bf16;

constexpr int BK = 64;  // reduction slice: 64 output pixels
constexpr int BOX_BYTES = 64 * BK * 2;  // one 64-channel x 64-pixel box

struct Params {
  float* ws;  // [splits, Co, KH*KW*Ci]
  long long kdim;  // KH*KW*Ci
  int ci, co, kw, sh, sw, ph, pw, dh, dw;
  int flat;
  int lbn, lbh, lbw;  // log2 of a slice's images, rows, columns
  int tiles_w, tiles_h;
  int steps, per, ci_tiles;
  int stages;  // ring depth, the plan's, at most max_stages
};

// The deepest ring a tile shape takes: 6 stages of 32 KB, or 4 of the
// 64 x 64 tile's 16 KB (three such blocks share an SM).
template <int NWG, int BN>
__host__ __device__ constexpr int max_stages() {
  return NWG == 1 && BN == 64 ? 4 : 6;
}

template <int NWG, int BN>
constexpr int smem_bytes(int stages) {
  return 1024 + stages * (NWG + BN / 64) * BOX_BYTES +
         2 * max_stages<NWG, BN>() * 8;
}

template <int NWG, int BN>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
    conv2d_wgrad_kernel(const __grid_constant__ CUtensorMap md,
                        const __grid_constant__ CUtensorMap mx, Params p) {
  constexpr int A_BYTES = NWG * BOX_BYTES;
  constexpr int B_BYTES = (BN / 64) * BOX_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stages = p.stages;
  uint8_t* a_s = smem;
  uint8_t* b_s = a_s + stages * A_BYTES;
  const uint32_t full0 = hg::smem_u32(b_s + stages * B_BYTES);
  const uint32_t empty0 = full0 + max_stages<NWG, BN>() * 8;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tap = blockIdx.x / p.ci_tiles;
  const int ci0 = (blockIdx.x - tap * p.ci_tiles) * BN;
  const int ky = tap / p.kw;
  const int kx = tap - ky * p.kw;
  const int co0 = blockIdx.y * (64 * NWG);
  const int s0 = blockIdx.z * p.per;
  const int nsteps = min(p.steps, s0 + p.per) - s0;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hg::mbar_init(full0 + 8 * s, 1);
      hg::mbar_init(empty0 + 8 * s, 4 * NWG);  // one per consumer warp
    }
    hg::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // ---- producer: one thread issues every load ----
    if (lane != 0) return;
    hg::tma_prefetch(&md);
    hg::tma_prefetch(&mx);
    // the first slice's box, then carried forward
    int tw = s0 % p.tiles_w;
    const int t = s0 / p.tiles_w;
    int th = t % p.tiles_h;
    int tn = t / p.tiles_h;
    int stage = 0;
    uint32_t phase = 0;
    for (int i = 0; i < nsteps; ++i) {
      const uint32_t full = full0 + 8 * stage;
      hg::mbar_wait(empty0 + 8 * stage, phase ^ 1);
      hg::mbar_expect_tx(full, A_BYTES + B_BYTES);
      const uint32_t a_dst = hg::smem_u32(a_s + stage * A_BYTES);
      const uint32_t b_dst = hg::smem_u32(b_s + stage * B_BYTES);
      if (p.flat) {
        const int p0 = (s0 + i) * BK;
#pragma unroll
        for (int w = 0; w < NWG; ++w)
          hg::tma_load_2d(a_dst + w * BOX_BYTES, &md, full, co0 + 64 * w, p0);
#pragma unroll
        for (int h = 0; h < BN / 64; ++h)
          hg::tma_load_2d(b_dst + h * BOX_BYTES, &mx, full, ci0 + 64 * h, p0);
      } else {
        const int ow0 = tw << p.lbw, oh0 = th << p.lbh, n0 = tn << p.lbn;
        const int iw = ow0 * p.sw - p.pw + kx * p.dw;
        const int ih = oh0 * p.sh - p.ph + ky * p.dh;
#pragma unroll
        for (int w = 0; w < NWG; ++w)
          hg::tma_load_4d(a_dst + w * BOX_BYTES, &md, full, co0 + 64 * w, ow0,
                          oh0, n0);
#pragma unroll
        for (int h = 0; h < BN / 64; ++h)
          hg::tma_load_4d(b_dst + h * BOX_BYTES, &mx, full, ci0 + 64 * h, iw,
                          ih, n0);
        if (++tw == p.tiles_w) {
          tw = 0;
          if (++th == p.tiles_h) {
            th = 0;
            ++tn;
          }
        }
      }
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns output channels co0 + wg*64 .. +64 ----
  const int wg = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  const uint32_t a_base = hg::smem_u32(a_s) + wg * BOX_BYTES;
  const uint32_t b_base = hg::smem_u32(b_s);
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int i = 0; i < nsteps; ++i) {
    hg::mbar_wait(full0 + 8 * stage, phase);
    // MN-major: 8 pixels per 1024-byte group (SBO), the B tile's 64-channel
    // halves BOX_BYTES apart (LBO), 16 pixels = 2048 bytes per k16 step
    const uint64_t da =
        hg::desc_sw128(a_base + stage * A_BYTES, BOX_BYTES, 1024);
    const uint64_t db =
        hg::desc_sw128(b_base + stage * B_BYTES, BOX_BYTES, 1024);
    hg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hg::wgmma<BN, 1, 1>(acc, da + 128 * kk, db + 128 * kk);
    hg::wgmma_commit();
    hg::fence_acc(acc);
    hg::wgmma_wait<1>();
    hg::fence_acc(acc);
    if (i > 0 && lane == 0) hg::mbar_arrive(empty0 + 8 * prev);
    prev = stage;
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  hg::wgmma_wait<0>();
  hg::fence_acc(acc);

  // ---- epilogue: this split's partial tile into its workspace slice ----
  const long long kdim = p.kdim;
  float* ws = p.ws + (long long)blockIdx.z * p.co * kdim;
  const int wl = warp & 3;
  const int colbase = ci0 + 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int co = co0 + wg * 64 + wl * 16 + (lane >> 2) + 8 * h;
    if (co >= p.co) continue;
    float* row = ws + (long long)co * kdim + (long long)tap * p.ci;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = colbase + 8 * j;
      if (col < p.ci)
        *reinterpret_cast<float2*>(row + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

__device__ __forceinline__ void put(float* out, long long i, float v) {
  out[i] = v;
}

__device__ __forceinline__ void put(bf16* out, long long i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

// dW[co, ci, ky, kx] = sum over the splits, in order, of ws[s, co, tap*Ci + ci].
// One thread per workspace column, so the reads coalesce.
template <typename OutT>
__global__ void wgrad_reduce_kernel(const float* ws, OutT* out, int splits,
                                    int co, int ci, int kh, int kw) {
  const long long kdim = (long long)kh * kw * ci;
  const long long total = (long long)co * kdim;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += ws[(long long)k * total + idx];
  const int co_i = (int)(idx / kdim);
  const int rem = (int)(idx - (long long)co_i * kdim);
  const int tap = rem / ci;
  const int ci_i = rem - tap * ci;
  const int ky = tap / kw;
  const int kx = tap - ky * kw;
  put(out, (((long long)co_i * ci + ci_i) * kh + ky) * kw + kx, s);
}

template <int NWG, int BN>
int launch(const CUtensorMap& md, const CUtensorMap& mx, const Params& p,
           dim3 grid, cudaStream_t s) {
  auto kernel = conv2d_wgrad_kernel<NWG, BN>;
  constexpr int most = max_stages<NWG, BN>();
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<NWG, BN>(most));
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  Params q = p;
  q.stages = p.stages > most ? most : p.stages < 2 && p.per > 1 ? 2 : p.stages;
  kernel<<<grid, NWG * 128 + 32, smem_bytes<NWG, BN>(q.stages), s>>>(md, mx,
                                                                    q);
  return (int)cudaGetLastError();
}

}  // namespace

// K3. The plan comes from the wrapper (conv_cuda.wgrad_plan): `flat`
// slices, the slice's box as log2 of its images, rows and columns, the
// co tile (64 * nwg) and ci tile (block_n), the split of the slices and
// the ring's depth.
// ws is [splits, Co, KH*KW*Ci] f32; out is [Co, Ci, KH, KW].
extern "C" int conv2d_wgrad(const void* x, const void* dout, void* ws,
                            void* out, int n, int h, int w_, int ci, int co,
                            int kh, int kw, int oh, int ow, int sh, int sw,
                            int ph, int pw, int dh, int dw, int flat, int lbn,
                            int lbh, int lbw, int nwg, int block_n, int splits,
                            int per, int stages, int out_f32, void* stream) {
  const long long pixels = (long long)n * oh * ow;
  CUtensorMap md, mx;
  int rc;
  if (flat) {
    const uint32_t box[2] = {64, BK};
    const uint32_t estr[2] = {1, 1};
    const uint64_t ddims[2] = {(uint64_t)co, (uint64_t)pixels};
    const uint64_t dstr[1] = {(uint64_t)co * 2};
    rc = hg::make_map(&md, dout, 2, ddims, dstr, box, estr);
    if (rc != 0) return rc;
    const uint64_t xdims[2] = {(uint64_t)ci, (uint64_t)pixels};
    const uint64_t xstr[1] = {(uint64_t)ci * 2};
    rc = hg::make_map(&mx, x, 2, xdims, xstr, box, estr);
  } else {
    const uint32_t bw = 1u << lbw, bh = 1u << lbh, bn = 1u << lbn;
    const uint64_t ddims[4] = {(uint64_t)co, (uint64_t)ow, (uint64_t)oh,
                               (uint64_t)n};
    const uint64_t dstr[3] = {(uint64_t)co * 2, (uint64_t)ow * co * 2,
                              (uint64_t)oh * ow * co * 2};
    const uint32_t dbox[4] = {64, bw, bh, bn};
    const uint32_t one[4] = {1, 1, 1, 1};
    rc = hg::make_map(&md, dout, 4, ddims, dstr, dbox, one);
    if (rc != 0) return rc;
    const uint64_t xdims[4] = {(uint64_t)ci, (uint64_t)w_, (uint64_t)h,
                               (uint64_t)n};
    const uint64_t xstr[3] = {(uint64_t)ci * 2, (uint64_t)w_ * ci * 2,
                              (uint64_t)h * w_ * ci * 2};
    const uint32_t xbox[4] = {64, bw * sw, bh * sh, bn};
    const uint32_t estr[4] = {1, (uint32_t)sw, (uint32_t)sh, 1};
    rc = hg::make_map(&mx, x, 4, xdims, xstr, xbox, estr);
  }
  if (rc != 0) return rc;
  Params p;
  p.ws = static_cast<float*>(ws);
  p.kdim = (long long)kh * kw * ci;
  p.ci = ci, p.co = co, p.kw = kw, p.sh = sh, p.sw = sw, p.ph = ph, p.pw = pw;
  p.dh = dh, p.dw = dw, p.flat = flat, p.lbn = lbn, p.lbh = lbh, p.lbw = lbw;
  if (flat) {
    p.tiles_w = (int)((pixels + BK - 1) / BK);
    p.tiles_h = 1;
    p.steps = p.tiles_w;
  } else {
    p.tiles_w = (ow + (1 << lbw) - 1) >> lbw;
    p.tiles_h = (oh + (1 << lbh) - 1) >> lbh;
    p.steps = p.tiles_w * p.tiles_h * ((n + (1 << lbn) - 1) >> lbn);
  }
  p.per = per;
  p.stages = stages;
  p.ci_tiles = (ci + block_n - 1) / block_n;
  dim3 grid((unsigned)(kh * kw * p.ci_tiles),
            (unsigned)((co + 64 * nwg - 1) / (64 * nwg)), (unsigned)splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nwg == 1)
    rc = block_n == 64 ? launch<1, 64>(md, mx, p, grid, s)
                       : launch<1, 128>(md, mx, p, grid, s);
  else
    rc = block_n == 64 ? launch<2, 64>(md, mx, p, grid, s)
                       : launch<2, 128>(md, mx, p, grid, s);
  if (rc != 0) return rc;
  const long long total = (long long)co * kh * kw * ci;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  if (out_f32)
    wgrad_reduce_kernel<float><<<blocks, 256, 0, s>>>(
        p.ws, static_cast<float*>(out), splits, co, ci, kh, kw);
  else
    wgrad_reduce_kernel<bf16><<<blocks, 256, 0, s>>>(
        p.ws, static_cast<bf16*>(out), splits, co, ci, kh, kw);
  return (int)cudaGetLastError();
}
