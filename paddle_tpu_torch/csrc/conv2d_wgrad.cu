// conv2d filter gradient (K3) as an implicit GEMM on bf16 tensor cores, for
// sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_conv.py `conv2d_grad_filter`
// (:471) -> `_wgrad_kernel` (:282): dW[co, ci, ky, kx] = sum over n, oh, ow of
// dout[n, oh, ow, co] * x[n, oh*sh - ph + ky*dh, ow*sw - pw + kx*dw, ci],
// f32 accumulation rounded once to the filter's dtype (f32 master weights
// under AMP O2, bf16 when the filter is bf16).
//
// GEMM view: M = Co, N = KH*KW*Ci, and the reduction runs over the
// N*OH*OW output pixels. A block owns a 128 (co) x 128 (ci of one tap) tile
// and walks the pixels in slices of 32: the A tile is 32 rows of dout (128
// contiguous channels each, read column-major by wmma), the B tile 32 rows
// of x gathered with the im2col addresses computed here, zero-filled
// (cp.async src-size 0) in the padding, past a tile edge or past the last
// pixel. Two-stage cp.async ring, 8 warps of wmma 16x16x16 bf16 MMAs into
// f32 fragments (each warp a 64x32 sub-tile), as in conv2d_fwd.cu.
//
// Split reduction: ResNet-50's 1x1 64->256 conv has 2 output tiles against a
// reduction of 100,352 pixels at batch 32, so the pixels are cut into
// `splits` contiguous ranges (grid z). Each split writes its partial tile to
// its own slice of an f32 workspace [splits, Co, KH*KW*Ci]; a second kernel
// adds the slices in order and writes dW as [Co, Ci, KH, KW]. No atomics: a
// repeated call is bitwise equal.
//
// Requirements (checked by the Python gate and wrapper): Ci % 8 == 0 and
// Co % 8 == 0, 16-byte aligned pointers, contiguous NHWC x and dout.
//
// Bound on an H100: the larger of 2*Co*KH*KW*Ci*N*OH*OW FLOPs against
// 989 TF/s bf16 and the bytes of x, dout and dW against 3.35 TB/s. This
// first kernel reaches neither: mma.sync at a fraction of the wgmma rate, a
// two-stage ring, a 32-pixel slice, a per-row pixel decode (two integer
// divisions per row and slice), and the workspace round trip. wgmma, TMA
// and a split chosen from measurements are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;       // output channels (co) per block
constexpr int BN = 128;       // input channels of one tap per block
constexpr int BK = 32;        // reduction slice: 32 output pixels
constexpr int THREADS = 256;  // 8 warps: 2 along M x 4 along N
constexpr int A_LD = BM + 8;  // padded shared row strides, in bf16 elements
constexpr int B_LD = BN + 8;
constexpr int STAGES = 2;

struct Params {
  const __nv_bfloat16* x;     // [N, H, W, Ci]
  const __nv_bfloat16* dout;  // [N, OH, OW, Co]
  float* ws;                  // [splits, Co, KH*KW*Ci]
  int n, h, w_, ci, co, kh, kw, oh, ow, sh, sw, ph, pw, dh, dw;
  int pixels;           // N*OH*OW
  int steps_per_split;  // pixel slices per split
  int ci_tiles;         // ceil(Ci / BN)
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

__global__ void __launch_bounds__(THREADS) conv2d_wgrad_kernel(Params p) {
  __shared__ __align__(128) __nv_bfloat16 As[STAGES][BK * A_LD];  // [k][m]
  __shared__ __align__(128) __nv_bfloat16 Bs[STAGES][BK * B_LD];  // [k][n]
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int warp_m = warp >> 2;  // 0..1: rows warp_m*64 .. +64
  const int warp_n = warp & 3;   // 0..3: cols warp_n*32 .. +32
  const int tap = blockIdx.x / p.ci_tiles;
  const int ci0 = (blockIdx.x - tap * p.ci_tiles) * BN;
  const int ky = tap / p.kw;
  const int kx = tap - ky * p.kw;
  const int co0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int total_steps = (p.pixels + BK - 1) / BK;
  const int step0 = split * p.steps_per_split;
  const int step1 = min(total_steps, step0 + p.steps_per_split);

  // loads: rows l_row and l_row + 16 of the 32-pixel slice, 16-byte chunk
  // l_vec (8 channels) of each, for both operands
  const int l_vec = tid & 15;
  const int l_row = tid >> 4;
  const int a_col = co0 + l_vec * 8;
  const bool a_col_ok = a_col < p.co;
  const int b_col = ci0 + l_vec * 8;
  const bool b_col_ok = b_col < p.ci;

  auto load_stage = [&](int stage, int step) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = l_row + r * 16;
      const int pix = step * BK + k;
      const bool pix_ok = pix < p.pixels;
      const bool a_ok = pix_ok && a_col_ok;
      const __nv_bfloat16* a_src =
          a_ok ? p.dout + ((long long)pix * p.co + a_col) : p.dout;
      cp_async16(&As[stage][k * A_LD + l_vec * 8], a_src, a_ok);
      const int pp = pix_ok ? pix : 0;
      const int ow_i = pp % p.ow;
      const int t = pp / p.ow;
      const int oh_i = t % p.oh;
      const int n_i = t / p.oh;
      const int ih = oh_i * p.sh - p.ph + ky * p.dh;
      const int iw = ow_i * p.sw - p.pw + kx * p.dw;
      const bool b_ok = pix_ok && b_col_ok && ih >= 0 && ih < p.h && iw >= 0 &&
                        iw < p.w_;
      const __nv_bfloat16* b_src =
          b_ok ? p.x + ((((long long)n_i * p.h + ih) * p.w_ + iw) * p.ci + b_col)
               : p.x;
      cp_async16(&Bs[stage][k * B_LD + l_vec * 8], b_src, b_ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  if (step0 < step1) load_stage(0, step0);
  cp_async_commit();
  for (int step = step0; step < step1; ++step) {
    const int stage = (step - step0) & 1;
    if (step + 1 < step1) load_stage(stage ^ 1, step + 1);
    cp_async_commit();  // possibly empty: keeps the wait count uniform
    cp_async_wait_prev();
    __syncthreads();
    const __nv_bfloat16* a_s = As[stage];
    const __nv_bfloat16* b_s = Bs[stage];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], a_s + kk * A_LD + warp_m * 64 + i * 16, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], b_s + kk * B_LD + warp_n * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

  // Epilogue: this split's partial tile into its workspace slice, one 16x16
  // fragment at a time through the warp's buffer; each lane writes 8
  // consecutive input channels of one output channel.
  const long long kdim = (long long)p.kh * p.kw * p.ci;
  float* ws = p.ws + (long long)split * p.co * kdim;
  float* cs = Cs[warp];
  const int r = lane >> 1;
  const int c8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = co0 + warp_m * 64 + i * 16 + r;
      const int col = ci0 + warp_n * 32 + j * 16 + c8;
      if (m < p.co && col < p.ci) {
        float4* dst = reinterpret_cast<float4*>(
            ws + (long long)m * kdim + (long long)tap * p.ci + col);
        const float* v = cs + r * 16 + c8;
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
      __syncwarp();
    }
  }
}

__device__ __forceinline__ void put(float* out, long long i, float v) {
  out[i] = v;
}

__device__ __forceinline__ void put(__nv_bfloat16* out, long long i, float v) {
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

}  // namespace

extern "C" int conv2d_wgrad(const void* x, const void* dout, void* ws,
                            void* out, int n, int h, int w_, int ci, int co,
                            int kh, int kw, int oh, int ow, int sh, int sw,
                            int ph, int pw, int dh, int dw, int splits,
                            int steps_per_split, int out_f32, void* stream) {
  Params p{static_cast<const __nv_bfloat16*>(x),
           static_cast<const __nv_bfloat16*>(dout),
           static_cast<float*>(ws),
           n, h, w_, ci, co, kh, kw, oh, ow, sh, sw, ph, pw, dh, dw,
           n * oh * ow, steps_per_split, (ci + BN - 1) / BN};
  dim3 grid((unsigned)(kh * kw * p.ci_tiles), (unsigned)((co + BM - 1) / BM),
            (unsigned)splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  conv2d_wgrad_kernel<<<grid, THREADS, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)co * kh * kw * ci;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  if (out_f32)
    wgrad_reduce_kernel<float><<<blocks, 256, 0, s>>>(
        p.ws, static_cast<float*>(out), splits, co, ci, kh, kw);
  else
    wgrad_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        p.ws, static_cast<__nv_bfloat16*>(out), splits, co, ci, kh, kw);
  return (int)cudaGetLastError();
}
