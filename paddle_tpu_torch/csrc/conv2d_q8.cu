// int8 conv2d forward (K11) as an implicit GEMM on int8 tensor cores, for
// sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_conv.py `conv2d_q8` (:431) ->
// `_conv_call(dq=...)` (:331) -> `_fwd_kernel` (:204) in its int8 form
// (:212-238). Same function: x NHWC int8, the filter as [Co, KH, KW, Ci] int8
// (OHWI: the reduction axis minor, as the int8 MMA's B operand wants it),
// symmetric stride/padding/dilation, an exact int32 sum per output, then
// y = bf16(float(acc) * dq[co]) with dq the f32 product of the activation and
// weight scales: the int32 -> f32 conversion rounds to nearest
// (__int2float_rn), the multiply is one f32 multiply, the result is rounded
// once to bf16 (or written as f32 for tests). Zero-filled padding is exact:
// the quantized zero is 0.
//
// GEMM view: M = N*OH*OW output pixels, N = Co, K = KH*KW*Ci. A block owns a
// 128x128 output tile and walks K in slices of 64 input channels (64 bytes)
// of one (kh, kw) tap. The A tile (128 pixels x 64 channels) is gathered from
// x with the im2col addresses computed here, the B tile (128 output channels
// x 64 channels) is a slab of the OHWI filter; both by 16-byte cp.async
// (src-size 0 zero-fills a tap in the padding or past Ci) through a
// two-stage ring. 8 warps (2 along M x 4 along N) each own a 64x32 sub-tile:
// ldmatrix.x4 loads A and B fragments (both K-contiguous, so no transpose),
// mma.sync m16n8k32 s8.s8.s32 accumulates 16 int32 fragments per warp. The
// epilogue dequantizes from registers and writes two outputs per store.
//
// Requirements (checked by the Python wrapper): Ci % 16 == 0 and Co % 16 == 0,
// 16-byte aligned pointers, contiguous NHWC x, OHWI w, NHWC y, f32 dq [Co].
//
// Bound on an H100: the larger of 2*M*Co*KH*KW*Ci integer operations against
// 1,979 TOP/s int8 dense and the bytes of x, w (1 byte each), dq and y
// against 3.35 TB/s. In ResNet-50 at batch 16 the 3x3 convs are
// operation-bound and the 1x1 convs byte-bound. This first kernel reaches
// neither: mma.sync runs at a fraction of the wgmma rate, the ring has two
// stages, and the late stages' grids (M = 784 at batch 16) fill 7 of 132 SMs
// per 128 output channels. wgmma s8, TMA and a fused activation-quantize
// pass are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // output pixels per block
constexpr int BN = 128;       // output channels per block
constexpr int BK = 64;        // reduction slice: 64 channels (bytes) of one tap
constexpr int THREADS = 256;  // 8 warps: 2 along M x 4 along N
constexpr int LD = BK + 16;   // padded shared row stride in bytes (80: the 8
                              // rows of an ldmatrix phase hit distinct banks)
constexpr int STAGES = 2;

struct Params {
  const int8_t* x;   // [N, H, W, Ci]
  const int8_t* w;   // [Co, KH, KW, Ci]
  const float* dq;   // [Co]
  void* y;           // [N, OH, OW, Co]
  int n, h, w_, ci, co, kh, kw, oh, ow, sh, sw, ph, pw, dh, dw;
};

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

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a (16x32 s8, row) * b (32x8 s8, col), int32 accumulation
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store2(__nv_bfloat16* y, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* y, float a, float b) {
  *reinterpret_cast<float2*>(y) = make_float2(a, b);
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS) conv2d_q8_kernel(Params p) {
  __shared__ __align__(128) int8_t As[STAGES][BM * LD];
  __shared__ __align__(128) int8_t Bs[STAGES][BN * LD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int warp_m = warp >> 2;  // 0..1: rows warp_m*64 .. +64
  const int warp_n = warp & 3;   // 0..3: cols warp_n*32 .. +32
  const long long M = (long long)p.n * p.oh * p.ow;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // Loads: this thread fills rows ld_row and ld_row + 64 of both tiles, the
  // 16-byte chunk ld_vec (channels ld_vec*16 .. +16) of each.
  const int ld_vec = tid & 3;
  const int ld_row = tid >> 2;
  int a_ih0[2], a_iw0[2];
  long long a_base[2];
  bool a_ok[2], b_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long m = m0 + ld_row + r * 64;
    a_ok[r] = m < M;
    const long long mm = a_ok[r] ? m : 0;
    const int ow_i = (int)(mm % p.ow);
    const long long t = mm / p.ow;
    const int oh_i = (int)(t % p.oh);
    const long long n_i = t / p.oh;
    a_ih0[r] = oh_i * p.sh - p.ph;
    a_iw0[r] = ow_i * p.sw - p.pw;
    a_base[r] = n_i * p.h * p.w_;
    b_ok[r] = n0 + ld_row + r * 64 < p.co;
  }

  const int n_chunks = (p.ci + BK - 1) / BK;
  const int steps = p.kh * p.kw * n_chunks;
  const int taps = p.kh * p.kw;

  auto load_stage = [&](int stage, int step) {
    const int tap = step / n_chunks;
    const int c = (step - tap * n_chunks) * BK + ld_vec * 16;
    const int ky = tap / p.kw;
    const int kx = tap - ky * p.kw;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ih = a_ih0[r] + ky * p.dh;
      const int iw = a_iw0[r] + kx * p.dw;
      const bool ok = a_ok[r] && c < p.ci && ih >= 0 && ih < p.h && iw >= 0 &&
                      iw < p.w_;
      const int8_t* src =
          ok ? p.x + ((a_base[r] + (long long)ih * p.w_ + iw) * p.ci + c) : p.x;
      cp_async16(&As[stage][(ld_row + r * 64) * LD + ld_vec * 16], src, ok);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int co = n0 + ld_row + r * 64;
      const bool ok = b_ok[r] && c < p.ci;
      const int8_t* src =
          ok ? p.w + (((long long)co * taps + tap) * p.ci + c) : p.w;
      cp_async16(&Bs[stage][(ld_row + r * 64) * LD + ld_vec * 16], src, ok);
    }
  };

  int acc[4][4][4];  // [16-row tile i][8-col tile j][fragment register]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  // ldmatrix.x4 lane addresses. A: matrices (rows 0-7, bytes 0-15), (rows
  // 8-15, bytes 0-15), (rows 0-7, bytes 16-31), (rows 8-15, bytes 16-31) of a
  // 16x32 tile: the m16n8k32 A fragment's registers a0..a3 in order. B (rows
  // = output channels): (n 0-7, k 0-15), (n 0-7, k 16-31), (n 8-15, k 0-15),
  // (n 8-15, k 16-31): b0, b1 of two 8-column tiles.
  const int a_lrow = lane & 15;
  const int a_lcol = (lane >> 4) * 16;
  const int b_lrow = (lane & 7) + ((lane >> 4) << 3);
  const int b_lcol = ((lane >> 3) & 1) * 16;

  load_stage(0, 0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) load_stage((step + 1) & 1, step + 1);
    cp_async_commit();  // possibly empty: keeps the wait count uniform
    cp_async_wait_prev();
    __syncthreads();
    const int8_t* a_s = As[step & 1];
    const int8_t* b_s = Bs[step & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i],
                    a_s + (warp_m * 64 + i * 16 + a_lrow) * LD + kk + a_lcol);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        ldmatrix_x4(bf[jj],
                    b_s + (warp_n * 32 + jj * 16 + b_lrow) * LD + kk + b_lcol);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], af[i], bf[j >> 1][(j & 1) * 2],
                 bf[j >> 1][(j & 1) * 2 + 1]);
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

  // Epilogue: fragment register q holds row (lane >> 2) + 8*(q >> 1), column
  // 2*(lane & 3) + (q & 1) of its 16x8 tile.
  OutT* y = static_cast<OutT*>(p.y);
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + warp_n * 32 + j * 8 + c2;
    if (col >= p.co) continue;
    const float d0 = p.dq[col];
    const float d1 = p.dq[col + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const long long m = m0 + warp_m * 64 + i * 16 + g + hf * 8;
        if (m < M)
          store2(y + m * p.co + col, __int2float_rn(acc[i][j][hf * 2]) * d0,
                 __int2float_rn(acc[i][j][hf * 2 + 1]) * d1);
      }
    }
  }
}

}  // namespace

extern "C" int conv2d_q8(const void* x, const void* w, const void* dq, void* y,
                         int n, int h, int w_, int ci, int co, int kh, int kw,
                         int oh, int ow, int sh, int sw, int ph, int pw,
                         int dh, int dw, int out_f32, void* stream) {
  Params p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
           static_cast<const float*>(dq), y, n, h, w_, ci, co, kh, kw, oh, ow,
           sh, sw, ph, pw, dh, dw};
  const long long M = (long long)n * oh * ow;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((co + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32)
    conv2d_q8_kernel<float><<<grid, THREADS, 0, s>>>(p);
  else
    conv2d_q8_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}
