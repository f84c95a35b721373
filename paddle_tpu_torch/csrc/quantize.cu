// Q1: the fused quantize pass of AMP O3, for sm_90a.
//
// Replaces no Pallas kernel. The JAX package quantizes with jnp in
// paddle_tpu/quant.py (`quantize_channelwise` :286-298, the conv
// activation's per-tensor scale :374-376) and leaves the arithmetic to XLA,
// which fuses it into one or two loops. The port's plain versions
// (quant.quantize_tensor, quant.quantize_channelwise) are about six eager
// PyTorch kernels a pass (abs, amax, clamp, divide, round, clamp, cast);
// this file does each pass in one or two launches, bitwise equal to them:
//   scale = max(amax, 1e-12) / qmax      (qmax 127, or 448 for e4m3)
//   q     = int8: clamp(rint(x / scale), -127, 127)
//           fp8:  e4m3(x / scale), saturating to +-448
// with the division correctly rounded (__fdiv_rn), rounding half to even
// (rintf) and the e4m3 store saturating (__NV_SATFINITE), the arithmetic of
// torch's CPU and CUDA ops and of jnp. amax is a max, exact in any order.
//
// Three forms, x bf16 or f32:
//   (a) per tensor (a conv activation, int8): q8_partial_kernel writes each
//       block's max|x|; q8_tensor_kernel reduces the partials in every
//       block (a few hundred floats from L2), derives the one scale, writes
//       q, and block 0 writes the scale. Two launches, no atomics, no host
//       sync: the scale stays on the device, so the form runs under graph
//       capture.
//   (b)/(c) per channel, channel-major (a `mul` activation per row; a conv
//       filter per output channel, OIHW in any memory order, written as
//       OHWI; a `mul` Y per column when its columns are contiguous):
//       quant_rows_kernel, one block per channel over a [C, A, B, D] view
//       with explicit element strides for x and q, D innermost; 16-byte
//       loads of 8 values where D's stride is 1 and the view allows it.
//   (c) per column, channel-minor (a `mul` Y [K, N] in row-major memory):
//       blocks of 32 columns by 64 rows, reading coalesced along the rows:
//       cols_partial_kernel writes each block's max per column,
//       quant_cols_kernel derives each column's scale from them and writes
//       its tile of q transposed, as [N, K] (the column-major B that
//       cuBLAS's int8 and fp8 GEMMs take fastest), through shared memory so
//       that the writes are coalesced too. Two launches.
// and, after a quantized `mul`'s GEMM, its dequantize epilogue:
//   dequant_kernel: y = bf16(f32(acc) * (sx[m] * sy[n])), acc the int32 or
//       f32 GEMM result (read once, 4 bytes a value), y written once (2
//       bytes), in place of the plain version's three passes (convert,
//       multiply, cast) over the [M, N] result.
//
// Bound on an H100: bytes. The function reads x once and writes q once
// (1 byte a value) and the scales; this design reads x twice (the max,
// then the scaling pass), so its own floor is 2|x| + |q|. A row or column
// of up to a few thousand values is re-read from L1/L2; a whole activation
// (form a, up to 51 MB at ResNet-50's batch 32) is re-read from device
// memory where it exceeds the 50 MB L2.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

__device__ __forceinline__ float qscale(float amax, float qmax) {
  return __fdiv_rn(fmaxf(amax, 1e-12f), qmax);
}

template <bool FP8>
__device__ __forceinline__ uint8_t quantize(float x, float s) {
  const float v = __fdiv_rn(x, s);
  if (FP8) {
    return static_cast<uint8_t>(__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3));
  }
  const float r = fminf(fmaxf(rintf(v), -127.0f), 127.0f);
  return static_cast<uint8_t>(static_cast<int8_t>(r));
}

// 8 values of x at p (16-byte aligned for bf16, 32-byte for f32)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <bool FP8>
__device__ __forceinline__ void store8(uint8_t* q, const float* v, float s) {
  uint2 out;
  uint8_t* b = reinterpret_cast<uint8_t*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i) b[i] = quantize<FP8>(v[i], s);
  *reinterpret_cast<uint2*>(q) = out;
}

// the max of v over the block; every thread gets it
__device__ float block_max(float v) {
  __shared__ float warp_max[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // warp_max may still be read from an earlier call
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  float m = 0.0f;
  for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) m = fmaxf(m, warp_max[w]);
  return m;
}

// --- (a) per tensor ----------------------------------------------------------

// VEC 8: x 16-byte aligned; the n % 8 tail is read one by one
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) q8_partial_kernel(const T* __restrict__ x, long n,
                                                              float* __restrict__ part) {
  float m = 0.0f;
  const long stride = static_cast<long>(gridDim.x) * blockDim.x;
  const long tid = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long nv = VEC == 8 ? n / 8 : 0;
  for (long i = tid; i < nv; i += stride) {
    float v[8];
    load8(x + i * 8, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
  }
  for (long i = nv * 8 + tid; i < n; i += stride) m = fmaxf(m, fabsf(to_f(x[i])));
  m = block_max(m);
  if (threadIdx.x == 0) part[blockIdx.x] = m;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) q8_tensor_kernel(const T* __restrict__ x, long n,
                                                             const float* __restrict__ part,
                                                             int parts, uint8_t* __restrict__ q,
                                                             float* __restrict__ scale) {
  float m = 0.0f;
  for (int i = threadIdx.x; i < parts; i += blockDim.x) m = fmaxf(m, part[i]);
  const float s = qscale(block_max(m), 127.0f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale = s;
  const long stride = static_cast<long>(gridDim.x) * blockDim.x;
  const long tid = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long nv = VEC == 8 ? n / 8 : 0;
  for (long i = tid; i < nv; i += stride) {
    float v[8];
    load8(x + i * 8, v);
    store8<false>(q + i * 8, v, s);
  }
  for (long i = nv * 8 + tid; i < n; i += stride) q[i] = quantize<false>(to_f(x[i]), s);
}

// --- (b), (c) per channel, channel-major ------------------------------------

struct View {
  long c, a, b, d;  // element strides
};

// VEC 8: D % 8 == 0, x's d stride 1 and its other strides and base 16-byte
// aligned (32-byte for f32), q's d stride 1 and base and strides 8-aligned
template <typename T, bool FP8, int VEC>
__global__ void __launch_bounds__(kThreads) quant_rows_kernel(const T* __restrict__ x, int A, int B,
                                                              int D, View xs,
                                                              uint8_t* __restrict__ q, View qs,
                                                              float* __restrict__ scale,
                                                              float qmax) {
  const long c = blockIdx.x;
  const T* xc = x + c * xs.c;
  uint8_t* qc = q + c * qs.c;
  const int dv = D / VEC;
  const long r_end = static_cast<long>(A) * B * dv;
  float m = 0.0f;
  for (long r = threadIdx.x; r < r_end; r += blockDim.x) {
    const int d = static_cast<int>(r % dv) * VEC;
    const long ab = r / dv;
    const long off = (ab / B) * xs.a + (ab % B) * xs.b;
    if (VEC == 8) {
      float v[8];
      load8(xc + off + d, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
    } else {
      m = fmaxf(m, fabsf(to_f(xc[off + d * xs.d])));
    }
  }
  const float s = qscale(block_max(m), qmax);
  if (threadIdx.x == 0) scale[c] = s;
  for (long r = threadIdx.x; r < r_end; r += blockDim.x) {
    const int d = static_cast<int>(r % dv) * VEC;
    const long ab = r / dv;
    const long a = ab / B, b = ab % B;
    const long xo = a * xs.a + b * xs.b, qo = a * qs.a + b * qs.b;
    if (VEC == 8) {
      float v[8];
      load8(xc + xo + d, v);
      store8<FP8>(qc + qo + d, v, s);
    } else {
      qc[qo + d * qs.d] = quantize<FP8>(to_f(xc[xo + d * xs.d]), s);
    }
  }
}

// --- (c) per column, channel-minor -------------------------------------------

constexpr int kTile = 32;
constexpr int kChunk = 64;  // rows a block takes

// x [R, C] with row stride ldx (columns contiguous). Grid (C / 32, R / 64),
// block (32, 8): threadIdx.x the column within the block's 32, threadIdx.y
// the row phase. part[chunk, c] = max |x| over the chunk's rows.
template <typename T>
__global__ void __launch_bounds__(kThreads) cols_partial_kernel(const T* __restrict__ x, int R,
                                                                int C, long ldx,
                                                                float* __restrict__ part) {
  __shared__ float col_max[8][kTile];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kTile + tx;
  const int r_end = min(R, (blockIdx.y + 1) * kChunk);
  float m = 0.0f;
  if (c < C) {
    for (int r = blockIdx.y * kChunk + ty; r < r_end; r += 8)
      m = fmaxf(m, fabsf(to_f(x[r * ldx + c])));
  }
  col_max[ty][tx] = m;
  __syncthreads();
  if (ty == 0 && c < C) {
#pragma unroll
    for (int i = 1; i < 8; ++i) m = fmaxf(m, col_max[i][tx]);
    part[static_cast<long>(blockIdx.y) * C + c] = m;
  }
}

// The same grid: each column's scale from the chunks' partial maxima (block
// row 0 writes scale[c]), then the block's 64 rows quantized in 32x32
// tiles staged in shared memory, so q [C, R] leaves coalesced: a warp
// writes 32 consecutive bytes of one of its rows.
template <typename T, bool FP8>
__global__ void __launch_bounds__(kThreads) quant_cols_kernel(const T* __restrict__ x, int R,
                                                              int C, long ldx,
                                                              const float* __restrict__ part,
                                                              int chunks,
                                                              uint8_t* __restrict__ q,
                                                              float* __restrict__ scale,
                                                              float qmax) {
  __shared__ float col_scale[kTile];
  __shared__ uint8_t tile[kTile][kTile + 4];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kTile + tx;
  if (ty == 0) {
    float m = 0.0f;
    if (c < C) {
      for (int i = 0; i < chunks; ++i) m = fmaxf(m, part[static_cast<long>(i) * C + c]);
    }
    const float s = qscale(m, qmax);
    col_scale[tx] = s;
    if (c < C && blockIdx.y == 0) scale[c] = s;
  }
  __syncthreads();
  const float s = col_scale[tx];
  const int r_begin = blockIdx.y * kChunk;
  for (int r0 = r_begin; r0 < min(R, r_begin + kChunk); r0 += kTile) {
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const int rr = ty + 8 * i, r = r0 + rr;
      if (r < R && c < C) tile[tx][rr] = quantize<FP8>(to_f(x[r * ldx + c]), s);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const int cc = ty + 8 * i, cq = blockIdx.x * kTile + cc, r = r0 + tx;
      if (cq < C && r < R) q[static_cast<long>(cq) * R + r] = tile[cc][tx];
    }
    __syncthreads();
  }
}

// --- the dequantize epilogue ---------------------------------------------------

__device__ __forceinline__ float acc_f(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float acc_f(float v) { return v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* y, float v) {
  *y = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_out(float* y, float v) { *y = v; }

// y[m, n] = OutT(f32(acc[m, n]) * (sx[m] * sy[n])), each product rounded
// to f32 once, as the plain `(acc.float() * (sx * sy)).to(dtype)` does.
// acc has row stride lda (a slice of a padded GEMM result); y is [M, N]
// contiguous. VEC 4: N % 4 == 0, lda % 4 == 0, acc, sy 16-byte aligned,
// y 8-byte aligned (16 for f32).
template <typename AccT, typename OutT, int VEC>
__global__ void __launch_bounds__(kThreads) dequant_kernel(const AccT* __restrict__ acc,
                                                           long lda,
                                                           const float* __restrict__ sx,
                                                           const float* __restrict__ sy,
                                                           OutT* __restrict__ y, int M,
                                                           int N) {
  const int nv = N / VEC;
  const long total = static_cast<long>(M) * nv;
  const long stride = static_cast<long>(gridDim.x) * blockDim.x;
  for (long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const long m = i / nv;
    const int n = static_cast<int>(i % nv) * VEC;
    const float a = sx[m];
    const AccT* src = acc + m * lda + n;
    OutT* dst = y + m * static_cast<long>(N) + n;
    if (VEC == 4) {
      alignas(16) AccT v[4];
      alignas(16) float s[4];
      alignas(16) OutT o[4];
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
      *reinterpret_cast<float4*>(s) = *reinterpret_cast<const float4*>(sy + n);
#pragma unroll
      for (int j = 0; j < 4; ++j) store_out(o + j, __fmul_rn(acc_f(v[j]), __fmul_rn(a, s[j])));
      if (sizeof(OutT) == 2) {
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(o);
      } else {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
      }
    } else {
      store_out(dst, __fmul_rn(acc_f(*src), __fmul_rn(a, sy[n])));
    }
  }
}

template <typename AccT, typename OutT>
int dequant(const void* acc, long lda, const void* sx, const void* sy, void* y, int M, int N,
            int blocks, int vec, cudaStream_t st) {
  const AccT* a = static_cast<const AccT*>(acc);
  const float* px = static_cast<const float*>(sx);
  const float* py = static_cast<const float*>(sy);
  OutT* o = static_cast<OutT*>(y);
  if (vec == 4) {
    dequant_kernel<AccT, OutT, 4><<<blocks, kThreads, 0, st>>>(a, lda, px, py, o, M, N);
  } else {
    dequant_kernel<AccT, OutT, 1><<<blocks, kThreads, 0, st>>>(a, lda, px, py, o, M, N);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int tensor_q8(const void* x, long n, void* part, int blocks, void* q, void* scale, int vec,
              cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  float* pp = static_cast<float*>(part);
  if (vec == 8) {
    q8_partial_kernel<T, 8><<<blocks, kThreads, 0, st>>>(xp, n, pp);
    q8_tensor_kernel<T, 8><<<blocks, kThreads, 0, st>>>(xp, n, pp, blocks,
                                                        static_cast<uint8_t*>(q),
                                                        static_cast<float*>(scale));
  } else {
    q8_partial_kernel<T, 1><<<blocks, kThreads, 0, st>>>(xp, n, pp);
    q8_tensor_kernel<T, 1><<<blocks, kThreads, 0, st>>>(xp, n, pp, blocks,
                                                        static_cast<uint8_t*>(q),
                                                        static_cast<float*>(scale));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool FP8>
int rows(const void* x, int C, int A, int B, int D, View xs, void* q, View qs, void* scale,
         int vec, int threads, cudaStream_t st) {
  const float qmax = FP8 ? 448.0f : 127.0f;
  if (vec == 8) {
    quant_rows_kernel<T, FP8, 8><<<C, threads, 0, st>>>(
        static_cast<const T*>(x), A, B, D, xs, static_cast<uint8_t*>(q), qs,
        static_cast<float*>(scale), qmax);
  } else {
    quant_rows_kernel<T, FP8, 1><<<C, threads, 0, st>>>(
        static_cast<const T*>(x), A, B, D, xs, static_cast<uint8_t*>(q), qs,
        static_cast<float*>(scale), qmax);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool FP8>
int cols(const void* x, int R, int C, long ldx, void* part, void* q, void* scale,
         cudaStream_t st) {
  const float qmax = FP8 ? 448.0f : 127.0f;
  const int chunks = (R + kChunk - 1) / kChunk;
  const dim3 block(kTile, 8), grid((C + kTile - 1) / kTile, chunks);
  const T* xp = static_cast<const T*>(x);
  float* pp = static_cast<float*>(part);
  cols_partial_kernel<T><<<grid, block, 0, st>>>(xp, R, C, ldx, pp);
  quant_cols_kernel<T, FP8><<<grid, block, 0, st>>>(
      xp, R, C, ldx, pp, chunks, static_cast<uint8_t*>(q), static_cast<float*>(scale), qmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 bf16, 1 f32. mode codes: 0 int8, 1 fp8 e4m3. Each entry
// returns the CUDA error code of its launches.

// (a) x [n] contiguous -> q int8 [n], scale f32 [1]; part f32 [blocks] of
// scratch. vec 8 needs x 16-byte aligned (32 for f32) and q 8-aligned.
extern "C" int quant_tensor(const void* x, long n, void* part, int blocks, void* q,
                            void* scale, int dtype, int vec, void* stream) {
  if (n <= 0 || blocks < 1 || blocks > 4096 || (vec != 8 && vec != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? tensor_q8<__nv_bfloat16>(x, n, part, blocks, q, scale, vec, st)
                    : tensor_q8<float>(x, n, part, blocks, q, scale, vec, st);
}

// (b), (c) channel-major: x viewed as [C, A, B, D] with element strides
// x_c..x_d, q with q_c..q_d; scale f32 [C].
extern "C" int quant_rows(const void* x, int C, int A, int B, int D, long x_c, long x_a,
                          long x_b, long x_d, void* q, long q_c, long q_a, long q_b, long q_d,
                          void* scale, int dtype, int mode, int vec, int threads,
                          void* stream) {
  if (C < 1 || A < 1 || B < 1 || D < 1 || C > 2147483647 || (vec != 8 && vec != 1) ||
      (vec == 8 && D % 8 != 0) || threads < 32 || threads > kThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const View xs{x_c, x_a, x_b, x_d}, qs{q_c, q_a, q_b, q_d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mode ? rows<__nv_bfloat16, true>(x, C, A, B, D, xs, q, qs, scale, vec, threads, st)
                : rows<__nv_bfloat16, false>(x, C, A, B, D, xs, q, qs, scale, vec, threads, st);
  return mode ? rows<float, true>(x, C, A, B, D, xs, q, qs, scale, vec, threads, st)
              : rows<float, false>(x, C, A, B, D, xs, q, qs, scale, vec, threads, st);
}

// (c) channel-minor: x [R, C] with row stride ldx and unit column stride ->
// q [C, R] contiguous (the transpose), scale [C]; part f32 [ceil(R / 64),
// C] of scratch.
extern "C" int quant_cols(const void* x, int R, int C, long ldx, void* part, void* q,
                          void* scale, int dtype, int mode, void* stream) {
  if (R < 1 || C < 1 || ldx < C || (R + kChunk - 1) / kChunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mode ? cols<__nv_bfloat16, true>(x, R, C, ldx, part, q, scale, st)
                : cols<__nv_bfloat16, false>(x, R, C, ldx, part, q, scale, st);
  return mode ? cols<float, true>(x, R, C, ldx, part, q, scale, st)
              : cols<float, false>(x, R, C, ldx, part, q, scale, st);
}

// acc [M, N] int32 (acc_dtype 0) or f32 (1) with row stride lda, sx f32
// [M], sy f32 [N] -> y [M, N] bf16 (out_dtype 0) or f32 (1), contiguous.
extern "C" int quant_dequant(const void* acc, long lda, const void* sx, const void* sy,
                             void* y, int M, int N, int acc_dtype, int out_dtype, int blocks,
                             int vec, void* stream) {
  if (M < 1 || N < 1 || lda < N || blocks < 1 || (vec != 4 && vec != 1) ||
      (vec == 4 && (N % 4 || lda % 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (acc_dtype == 0)
    return out_dtype == 0
               ? dequant<int, __nv_bfloat16>(acc, lda, sx, sy, y, M, N, blocks, vec, st)
               : dequant<int, float>(acc, lda, sx, sy, y, M, N, blocks, vec, st);
  return out_dtype == 0
             ? dequant<float, __nv_bfloat16>(acc, lda, sx, sy, y, M, N, blocks, vec, st)
             : dequant<float, float>(acc, lda, sx, sy, y, M, N, blocks, vec, st);
}
