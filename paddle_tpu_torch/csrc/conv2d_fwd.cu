// conv2d forward (K1) and conv2d + channel statistics (K4) as an implicit
// GEMM on bf16 tensor cores, for sm_90a.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_conv.py `conv2d` (:412) ->
// `_conv_call` (:331) -> `_fwd_kernel` (:204). Same function: x NHWC bf16,
// the filter as [KH, KW, Ci, Co] bf16, symmetric stride/padding/dilation,
// f32 accumulation rounded once to the output type (bf16, or f32 for tests).
//
// GEMM view: M = N*OH*OW output pixels, N = Co, K = KH*KW*Ci. A block owns a
// 128x128 output tile and walks K in slices of 32 input channels of one
// (kh, kw) tap. Each slice's A tile (128 pixels x 32 channels) is gathered
// straight from x with the im2col addresses computed here: a 16-byte cp.async
// per 8 channels, zero-filled (src-size 0) where the tap falls in the padding
// or past Ci. The B tile (32 x 128) is a dense slab of the filter. Both go
// through a two-stage cp.async ring in shared memory; 8 warps run
// wmma 16x16x16 bf16 MMAs into f32 fragments (each warp a 64x32 sub-tile).
// The epilogue stages each fragment through a per-warp shared buffer and
// writes 8 outputs per 16-byte store.
//
// K4, conv2d_stats (replaces pallas_conv.py `conv2d_stats` :420 ->
// `_fwd_stats_kernel` :241), is the same kernel with STATS set: the main
// loop and the output stores are K1's own, so y is bitwise K1's. Its
// epilogue also sums, per output channel, the bf16-rounded y and its
// square over the tile's valid rows: each lane over its 4 rows, then a
// butterfly over the 16 lanes that share its columns (IEEE addition is
// commutative, so every order the butterfly takes gives the same bits),
// then the block's two row halves through shared memory. Each block writes
// its [128] partial sums to its own row of a [m_tiles, Co] workspace; a
// second kernel adds the rows in order. No atomics: a repeated call is
// bitwise equal.
//
// Requirements (checked by the Python gate and wrapper): Ci % 8 == 0 and
// Co % 8 == 0 (16-byte vectors never straddle a channel edge), 16-byte
// aligned pointers, contiguous NHWC / HWIO / NHWC tensors.
//
// Bound on an H100: the larger of 2*M*Co*KH*KW*Ci FLOPs against 989 TF/s
// bf16 and the bytes of x, w and y against 3.35 TB/s. In ResNet-50 at batch
// 16 the 3x3 convs are operation-bound and the 1x1 convs byte-bound. This
// first kernel reaches neither: wmma (mma.sync) runs at a fraction of the
// wgmma rate, the ring has two stages, a 1x1 conv reads its A tile through
// shared memory though no element is reused across taps, and the late
// stages' grids (M = 784 at batch 16: 7 row tiles) leave most of the 132
// SMs idle. wgmma, TMA loads, a deeper ring and split-K are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;       // output pixels per block
constexpr int BN = 128;       // output channels per block
constexpr int BK = 32;        // reduction slice: 32 channels of one tap
constexpr int THREADS = 256;  // 8 warps: 2 along M x 4 along N
constexpr int A_LD = BK + 8;  // padded shared row strides, in bf16 elements
constexpr int B_LD = BN + 8;
constexpr int STAGES = 2;

struct Params {
  const __nv_bfloat16* x;  // [N, H, W, Ci]
  const __nv_bfloat16* w;  // [KH, KW, Ci, Co]
  void* y;                 // [N, OH, OW, Co]
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
  // all groups but the most recently committed one have landed
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void store8(__nv_bfloat16* y, const float* v) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  *reinterpret_cast<uint4*>(y) = *reinterpret_cast<const uint4*>(h);
}

__device__ __forceinline__ void store8(float* y, const float* v) {
  reinterpret_cast<float4*>(y)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(y)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float rounded(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float rounded(float v, float*) { return v; }

template <typename OutT, bool STATS>
__global__ void __launch_bounds__(THREADS)
    conv2d_fwd_kernel(Params p, float* part_sum, float* part_sq) {
  __shared__ __align__(128) __nv_bfloat16 As[STAGES][BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Bs[STAGES][BK * B_LD];
  __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int warp_m = warp >> 2;  // 0..1: rows warp_m*64 .. +64
  const int warp_n = warp & 3;   // 0..3: cols warp_n*32 .. +32
  const long long M = (long long)p.n * p.oh * p.ow;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A loads: this thread fills rows a_row and a_row + 64 of the tile, the
  // 16-byte chunk a_vec (channels a_vec*8 .. +8) of each.
  const int a_vec = tid & 3;
  const int a_row = tid >> 2;
  int a_ih0[2], a_iw0[2];
  long long a_base[2];
  bool a_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long m = m0 + a_row + r * 64;
    a_ok[r] = m < M;
    const long long mm = a_ok[r] ? m : 0;
    const int ow_i = (int)(mm % p.ow);
    const long long t = mm / p.ow;
    const int oh_i = (int)(t % p.oh);
    const long long n_i = t / p.oh;
    a_ih0[r] = oh_i * p.sh - p.ph;
    a_iw0[r] = ow_i * p.sw - p.pw;
    a_base[r] = n_i * p.h * p.w_;
  }
  // B loads: rows b_row and b_row + 16 of the 32-row slice, chunk b_vec.
  const int b_vec = tid & 15;
  const int b_row = tid >> 4;
  const int b_col = n0 + b_vec * 8;
  const bool b_col_ok = b_col < p.co;

  const int n_chunks = (p.ci + BK - 1) / BK;
  const int steps = p.kh * p.kw * n_chunks;

  auto load_stage = [&](int stage, int step) {
    const int tap = step / n_chunks;
    const int c0 = (step - tap * n_chunks) * BK;
    const int ky = tap / p.kw;
    const int kx = tap - ky * p.kw;
    const int c = c0 + a_vec * 8;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int ih = a_ih0[r] + ky * p.dh;
      const int iw = a_iw0[r] + kx * p.dw;
      const bool ok = a_ok[r] && c < p.ci && ih >= 0 && ih < p.h && iw >= 0 &&
                      iw < p.w_;
      const __nv_bfloat16* src =
          ok ? p.x + ((a_base[r] + (long long)ih * p.w_ + iw) * p.ci + c) : p.x;
      cp_async16(&As[stage][(a_row + r * 64) * A_LD + a_vec * 8], src, ok);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = b_row + r * 16;
      const int cin = c0 + k;
      const bool ok = b_col_ok && cin < p.ci;
      const __nv_bfloat16* src =
          ok ? p.w + (((long long)tap * p.ci + cin) * p.co + b_col) : p.w;
      cp_async16(&Bs[stage][k * B_LD + b_vec * 8], src, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load_stage(0, 0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) load_stage((step + 1) & 1, step + 1);
    cp_async_commit();  // possibly empty: keeps the wait count uniform
    cp_async_wait_prev();
    __syncthreads();
    const __nv_bfloat16* a_s = As[step & 1];
    const __nv_bfloat16* b_s = Bs[step & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], a_s + (warp_m * 64 + i * 16) * A_LD + kk, A_LD);
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

  // Epilogue: one 16x16 fragment at a time through this warp's buffer; each
  // lane writes 8 consecutive channels of one output row.
  OutT* y = static_cast<OutT*>(p.y);
  float* cs = Cs[warp];
  const int r = lane >> 1;
  const int c8 = (lane & 1) * 8;
  float ssum[2][8], ssq[2][8];  // STATS: this lane's 8 columns of fragment j
  if constexpr (STATS) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q) ssum[j][q] = ssq[j][q] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long m = m0 + warp_m * 64 + i * 16 + r;
      const int col = n0 + warp_n * 32 + j * 16 + c8;
      if (m < M && col < p.co) {
        store8(y + m * p.co + col, cs + r * 16 + c8);
        if constexpr (STATS) {
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float v = rounded(cs[r * 16 + c8 + q], y);
            ssum[j][q] += v;
            ssq[j][q] += v * v;
          }
        }
      }
      __syncwarp();
    }
  }
  if constexpr (STATS) {
    // lanes with equal (lane & 1) hold the same 8 columns of 16 rows each
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int off = 2; off < 32; off <<= 1) {
          ssum[j][q] += __shfl_xor_sync(0xffffffffu, ssum[j][q], off);
          ssq[j][q] += __shfl_xor_sync(0xffffffffu, ssq[j][q], off);
        }
    // the A ring is free after the main loop: [2 row halves][2][BN] floats
    float* red = reinterpret_cast<float*>(&As[0][0]);
    if (lane < 2) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int c = warp_n * 32 + j * 16 + lane * 8 + q;
          red[(warp_m * 2 + 0) * BN + c] = ssum[j][q];
          red[(warp_m * 2 + 1) * BN + c] = ssq[j][q];
        }
    }
    __syncthreads();
    if (tid < BN && n0 + tid < p.co) {
      const long long o = (long long)blockIdx.x * p.co + n0 + tid;
      part_sum[o] = red[0 * BN + tid] + red[2 * BN + tid];
      part_sq[o] = red[1 * BN + tid] + red[3 * BN + tid];
    }
  }
}

// csum[c] = sum over the m tiles, in order, of part_sum[t, c]; csq likewise.
__global__ void stats_reduce_kernel(const float* part_sum, const float* part_sq,
                                    int m_tiles, int co, float* csum,
                                    float* csq) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= co) return;
  float s = 0.0f, q = 0.0f;
  for (int t = 0; t < m_tiles; ++t) {
    s += part_sum[(long long)t * co + c];
    q += part_sq[(long long)t * co + c];
  }
  csum[c] = s;
  csq[c] = q;
}

}  // namespace

extern "C" int conv2d_fwd(const void* x, const void* w, void* y, int n, int h,
                          int w_, int ci, int co, int kh, int kw, int oh,
                          int ow, int sh, int sw, int ph, int pw, int dh,
                          int dw, int out_f32, void* stream) {
  Params p{static_cast<const __nv_bfloat16*>(x),
           static_cast<const __nv_bfloat16*>(w),
           y, n, h, w_, ci, co, kh, kw, oh, ow, sh, sw, ph, pw, dh, dw};
  const long long M = (long long)n * oh * ow;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((co + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32)
    conv2d_fwd_kernel<float, false><<<grid, THREADS, 0, s>>>(p, nullptr, nullptr);
  else
    conv2d_fwd_kernel<__nv_bfloat16, false>
        <<<grid, THREADS, 0, s>>>(p, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// K4: y as conv2d_fwd, plus csum/csq [Co] of the rounded y. part_sum and
// part_sq are [ceil(N*OH*OW / 128), Co] f32 scratch.
extern "C" int conv2d_fwd_stats(const void* x, const void* w, void* y,
                                void* part_sum, void* part_sq, void* csum,
                                void* csq, int n, int h, int w_, int ci,
                                int co, int kh, int kw, int oh, int ow, int sh,
                                int sw, int ph, int pw, int dh, int dw,
                                int out_f32, void* stream) {
  Params p{static_cast<const __nv_bfloat16*>(x),
           static_cast<const __nv_bfloat16*>(w),
           y, n, h, w_, ci, co, kh, kw, oh, ow, sh, sw, ph, pw, dh, dw};
  const long long M = (long long)n * oh * ow;
  const int m_tiles = (int)((M + BM - 1) / BM);
  dim3 grid((unsigned)m_tiles, (unsigned)((co + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(part_sum);
  float* pq = static_cast<float*>(part_sq);
  if (out_f32)
    conv2d_fwd_kernel<float, true><<<grid, THREADS, 0, s>>>(p, ps, pq);
  else
    conv2d_fwd_kernel<__nv_bfloat16, true><<<grid, THREADS, 0, s>>>(p, ps, pq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_reduce_kernel<<<(co + 127) / 128, 128, 0, s>>>(
      ps, pq, m_tiles, co, static_cast<float*>(csum), static_cast<float*>(csq));
  return (int)cudaGetLastError();
}
