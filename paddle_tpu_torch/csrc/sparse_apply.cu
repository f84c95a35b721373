// S1: the sparse optimizer apply of a SelectedRows gradient, for sm_90a.
//
// Replaces no Pallas kernel. The JAX package merges a SelectedRows
// gradient and scatter-applies it with plain jnp (paddle_tpu/ops/common.py
// merge_selected_rows :49-67, paddle_tpu/ops/sparse_ops.py :202-244), which
// XLA fuses. The port's plain version (ops/sparse_cuda.py
// `apply_reference`: merge, gather, the *_dense update math, index_copy_)
// is about fifteen eager kernels, sums duplicate ids with an accumulating
// scatter, and writes new tensors where this kernel updates in place.
//
// Input: the gradient's rows sorted stably (`r_s` [K], int64, ascending)
// and its values in the same order (`v_s` [K, D], f32), the table `p`
// [H, D] and its accumulators (momentum: v; Adam: m1, m2), f32, updated in
// place. A block owns the sorted position blockIdx.x: unless that position
// starts a run of equal rows (r_s[i] != r_s[i-1]) the block leaves. Else
// every thread finds the run's end by a binary search (the rows are
// sorted), and the block's eight warps sum the run's values, warp w the
// rows i + w, i + w + 8, ..., each in sorted order, in f32, a lane a
// column; warp 0 adds the eight partial sums in warp order and applies the
// update to that one row, column by column. No atomics: the sums, and so
// the update, are bitwise repeatable. A run of at most eight rows is summed
// in plain sorted order, as the plain version sums it. A row equal to H
// (a freed slot of a merged gradient) or outside [0, H) is skipped. Rows
// no run names are never read or written: the lazy semantics of the
// reference's SparseAdamFunctor (adam_op.h), moments included.
//
// The update is the port's dense math (ops/optimizer_ops.py sgd_dense,
// momentum_dense, adam_dense) one operation at a time, each rounded once
// (__fmul_rn and kin, so nothing contracts into an FMA), with the
// hyperparameters the dense ops take: lr, beta1^t and beta2^t from device
// memory, mu, beta1, beta2, epsilon and 1 - beta as f32 values.
//
// Bound on an H100: bytes. The function reads the gradient once (K*D*4)
// and reads and writes each touched row of the table and its accumulators
// once (U*D*4*2*(1 + accumulators), U the distinct rows). This design reads
// no more than that plus the K sorted rows; a long run of one hot id is
// summed by eight warps in a dependent chain each, which bounds it by
// latency instead (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

enum Kind { kSgd = 0, kMomentum = 1, kAdam = 2 };

struct Hyper {
  const float* lr;     // device scalar
  const float* b1p;    // Adam: beta1^t, device scalar
  const float* b2p;    // Adam: beta2^t, device scalar
  float mu;            // momentum
  int nesterov;        // momentum
  float b1, b2, eps;   // Adam
  float one_m_b1, one_m_b2;
};

// first position in [lo, hi) whose row differs from r (rows ascending)
__device__ __forceinline__ long run_end(const int64_t* r_s, long lo, long hi,
                                        int64_t r) {
  while (lo < hi) {
    const long mid = lo + (hi - lo) / 2;
    if (r_s[mid] == r) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
sparse_apply_kernel(const int64_t* __restrict__ r_s,
                    const float* __restrict__ v_s, long k, int d, long height,
                    float* __restrict__ p, float* __restrict__ a1,
                    float* __restrict__ a2, Hyper h) {
  const long i = blockIdx.x;
  const int64_t r = r_s[i];
  if (i > 0 && r_s[i - 1] == r) return;          // not a run start
  if (r < 0 || r >= height) return;              // freed slot or bad id
  const long end = run_end(r_s, i + 1, k, r);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __shared__ float part[kWarps][32];

  float lr_t = 0.0f;
  if (KIND == kAdam) {  // lr * sqrt(1 - b2p) / (1 - b1p), as adam_dense
    lr_t = __fdiv_rn(__fmul_rn(*h.lr, __fsqrt_rn(__fsub_rn(1.0f, *h.b2p))),
                     __fsub_rn(1.0f, *h.b1p));
  }
  const float lr = *h.lr;
  for (int c0 = 0; c0 < d; c0 += 32) {
    const int c = c0 + lane;
    float acc = 0.0f;
    if (c < d) {
#pragma unroll 8
      for (long j = i + warp; j < end; j += kWarps) {
        acc = __fadd_rn(acc, v_s[j * d + c]);
      }
    }
    part[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && c < d) {
      float g = part[0][lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) g = __fadd_rn(g, part[w][lane]);
      const long at = r * d + c;
      const float pv = p[at];
      if (KIND == kSgd) {
        p[at] = __fsub_rn(pv, __fmul_rn(lr, g));
      } else if (KIND == kMomentum) {
        const float vo = __fadd_rn(__fmul_rn(h.mu, a1[at]), g);
        const float step = h.nesterov ? __fadd_rn(g, __fmul_rn(h.mu, vo)) : vo;
        a1[at] = vo;
        p[at] = __fsub_rn(pv, __fmul_rn(lr, step));
      } else {
        const float m1o = __fadd_rn(__fmul_rn(h.b1, a1[at]),
                                    __fmul_rn(h.one_m_b1, g));
        const float m2o = __fadd_rn(__fmul_rn(h.b2, a2[at]),
                                    __fmul_rn(__fmul_rn(h.one_m_b2, g), g));
        const float den = __fadd_rn(__fsqrt_rn(m2o), h.eps);
        a1[at] = m1o;
        a2[at] = m2o;
        p[at] = __fsub_rn(pv, __fdiv_rn(__fmul_rn(lr_t, m1o), den));
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int sparse_apply(int kind, const void* r_s, const void* v_s, long k,
                            int d, long height, void* p, void* a1, void* a2,
                            const void* lr, const void* b1p, const void* b2p,
                            float mu, int nesterov, float b1, float b2,
                            float eps, float one_m_b1, float one_m_b2,
                            void* stream) {
  if (k <= 0) return 0;
  Hyper h{static_cast<const float*>(lr), static_cast<const float*>(b1p),
          static_cast<const float*>(b2p), mu, nesterov, b1, b2, eps,
          one_m_b1, one_m_b2};
  const dim3 grid(static_cast<unsigned>(k)), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto rows = static_cast<const int64_t*>(r_s);
  auto vals = static_cast<const float*>(v_s);
  auto pp = static_cast<float*>(p);
  auto aa = static_cast<float*>(a1);
  auto bb = static_cast<float*>(a2);
  switch (kind) {
    case kSgd:
      sparse_apply_kernel<kSgd><<<grid, block, 0, s>>>(rows, vals, k, d, height,
                                                      pp, aa, bb, h);
      break;
    case kMomentum:
      sparse_apply_kernel<kMomentum><<<grid, block, 0, s>>>(
          rows, vals, k, d, height, pp, aa, bb, h);
      break;
    case kAdam:
      sparse_apply_kernel<kAdam><<<grid, block, 0, s>>>(rows, vals, k, d,
                                                       height, pp, aa, bb, h);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
