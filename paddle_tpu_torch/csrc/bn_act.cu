// Training batch norm [+ act] with its own statistics (K6) in one
// cooperative launch, for sm_90a.
//
// Replaces: paddle_tpu/ops/fusion.py `_pallas_bn_act` (:738) ->
// `_bn_act_kernel` (:697, pallas_call :760). Same function: x [M, C] bf16,
// scale and bias [C] f32 -> per-channel mean = sum(x) / M and the clamped
// one-pass variance var = max(sum(x^2) / M - mean^2, 0) (fusion.py:720-722),
// both f32; ybn = bf16((x - mean) * (rsqrt(var + eps) * scale) + bias); yact
// = act(ybn). The TPU kernel walks its grid in order, phase 0 summing and
// phase 1 applying; here one launch runs both phases across the card with
// a grid-wide hand-off between them.
//
// Bound on an H100: bytes. x read once and ybn, yact written once (ResNet-50's
// stem at batch 32, [401408, 64] relu: 154 MB, 0.046 ms at 3.35 TB/s); a
// design that reads x twice from device memory cannot beat 0.061 ms. x is
// 51.4 MB, just above the 50 MB L2, and the outputs are twice that.
//
// Design. One cooperative launch (the grid sized by the occupancy query
// times the SMs and capped by the rows; a grid that cannot be co-resident
// makes the launch fail, never hang). x is cut into tiles of R rows, one
// row of each of the CTA's R row groups, and tile t belongs to CTA t mod
// CTAs (ops/bn_cuda.py `bn_act_plan`), so the CTAs sweep x together. A CTA
// takes an SM alone and keeps the last CACHE_BYTES of x it reads in its
// shared memory (192 KB an SM, 25 MB of the card), so that the second read
// of x needs from L2 only what is left (26 MB of the stem's 51.4 MB) and
// next to nothing from device memory.
// - Phase 1: each thread sums VEC channels (8 with 16-byte loads where C is
//   a multiple of 8, else 1) over its row of each of its CTA's tiles, in
//   tile order, in f32. The tiles that will not stay in shared memory are
//   loaded with an L2 evict_last policy, the others with evict_first; each
//   thread keeps its own part of the last tiles in shared memory, where
//   only it reads them back, so no barrier guards them. The CTA adds its R
//   row groups in order into a [CTAs, 2, C] workspace of partials; no
//   float atomics, so a repeated call is bitwise equal.
// - Grid sync. One warp per channel adds the CTAs' partials (lane l the
//   CTAs l, l + 32, ... in order, then a butterfly of shuffles) and writes
//   mean, var and a = rsqrt(var + eps) * scale. Grid sync.
// - Phase 2: the CTAs sweep x again in reverse: first the tiles in shared
//   memory, then those read last in phase 1, from L2, with an evict_first
//   policy (their last use). ybn and yact leave by streaming stores, so the
//   outputs do not evict x.
// The summation order is fixed by the plan alone: bn_cuda's
// `bn_act_stats_in_order` repeats it on the CPU, bit for bit. A grid-sync
// wait that lasts seconds traps, as the conv kernels' mbarrier waits do.
// A channel wider than one slab of THREADS chunks is walked a slab at a
// time; only the last slab's tiles stay in shared memory.
//
// The split form (a batch split over ranks, parallel/spmd.py): the same
// kernel as two launches, MODE a template parameter. The statistics launch
// (MODE_SUMS) runs phase 1 and the CTA-order hand-off and writes the
// per-channel sum and sum of squares ([2, C] f32, in the order above)
// instead of mean and var; the window all-reduces them over the ranks; the
// normalize launch (MODE_APPLY) takes the global sums and the global row
// count, derives mean, var and a in each thread as the whole kernel does
// after its grid sync, and runs phase 2 with the act epilogue, reading x
// again from device memory. On one rank the two launches give the whole
// kernel's bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 512;  // bn_cuda.BN_THREADS
constexpr int WARPS = THREADS / 32;
constexpr int U1 = 4;  // rows in flight a thread, phase 1
constexpr int U2 = 2;  // ..., phase 2
constexpr int UF = 16;  // partials in flight a lane, the statistics
// x a CTA keeps in shared memory between the phases, then the phase-1
// scratch of its row groups' sums: 192 KB + 32 KB of the SM's 227 KB
constexpr int CACHE_BYTES = 192 * 1024;

// what a launch does: the whole K6, its statistics alone, its normalize
constexpr int MODE_WHOLE = 0;
constexpr int MODE_SUMS = 1;
constexpr int MODE_APPLY = 2;

struct Params {
  const __nv_bfloat16* x;  // [M, C]
  const float* scale;      // [C]
  const float* bias;       // [C]
  __nv_bfloat16* ybn;      // [M, C]
  __nv_bfloat16* yact;     // [M, C], or null without an act
  float* mean;             // [C]
  float* var;              // [C]
  float* part;             // [CTAs, 2, C]: each CTA's sum(x), sum(x^2)
  float* a;                // [C]: rsqrt(var + eps) * scale
  unsigned* bar;           // the grid barrier's counter
  const float* sums;       // [2, C]: the global sums (MODE_APPLY)
  int m, c;
  float eps;
  float total;             // the global rows the sums cover (MODE_APPLY)
};

__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

// VEC bf16 channels of one row as loaded or stored: 8 in 16 bytes, or 1
struct Raw8 {
  uint32_t w[4];
};
struct Raw1 {
  unsigned short h;
};
template <int VEC>
using Raw = std::conditional_t<VEC == 8, Raw8, Raw1>;

__device__ __forceinline__ void load(Raw8& r, const __nv_bfloat16* p,
                                     uint64_t pol) {
  asm volatile("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3])
               : "l"(p), "l"(pol));
}

__device__ __forceinline__ void load(Raw1& r, const __nv_bfloat16* p,
                                     uint64_t pol) {
  asm volatile("ld.global.L2::cache_hint.u16 %0, [%1], %2;\n"
               : "=h"(r.h)
               : "l"(p), "l"(pol));
}

// bf16 -> f32 is exact: the bf16 bits are the f32's upper half
__device__ __forceinline__ void unpack(const Raw8& r, float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(r.w[i] << 16);
    f[2 * i + 1] = __uint_as_float(r.w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const Raw1& r, float (&f)[1]) {
  f[0] = __uint_as_float((uint32_t)r.h << 16);
}

// f32 -> bf16 rounded to nearest even, two at a time (one F2FP a pair: a
// conversion of one value at a time runs at a quarter of the ALU rate)
__device__ __forceinline__ void pack(Raw8& r, const float (&y)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
    r.w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
}

__device__ __forceinline__ void pack(Raw1& r, const float (&y)[1]) {
  r.h = __bfloat16_as_ushort(__float2bfloat16_rn(y[0]));
}

// relu on the rounded values, two at a time; NaN stays NaN, as in torch
__device__ __forceinline__ void relu(Raw8& r) {
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v =
        __hmax2_nan(*reinterpret_cast<const __nv_bfloat162*>(&r.w[i]), zero);
    r.w[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
}

__device__ __forceinline__ void relu(Raw1& r) {
  r.h = __bfloat16_as_ushort(
      __hmax_nan(__ushort_as_bfloat16(r.h), __float2bfloat16_rn(0.0f)));
}

// stores with the streaming hint
__device__ __forceinline__ void store(__nv_bfloat16* p, const Raw8& r) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(r.w[0]), "r"(r.w[1]), "r"(r.w[2]), "r"(r.w[3])
               : "memory");
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const Raw1& r) {
  asm volatile("st.global.cs.u16 [%0], %1;\n" ::"l"(p), "h"(r.h) : "memory");
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Every CTA of the (co-resident) grid arrives before any leaves. The
// counter's top bit flips once per sync: CTA 0 adds 2^31 - (CTAs - 1), the
// others 1 each, so its low bits return to where they were (zero, as the
// wrapper allocates it) and the next launch reuses it as it stands. A wait
// of seconds traps, so a fault fails the launch instead of hanging the card.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, add);
    const uint64_t t0 = globaltimer();
    while (((old ^ load_acquire(bar)) & 0x80000000u) == 0)
      if (globaltimer() - t0 > 4000000000ull) __trap();
    __threadfence();
  }
  __syncthreads();
}

// tiles of x a CTA keeps in shared memory, and its dynamic shared memory
template <int VEC>
__host__ __device__ constexpr int slots() {
  return CACHE_BYTES / (THREADS * (int)sizeof(Raw<VEC>));
}

template <int VEC>
__host__ __device__ constexpr int smem_bytes() {
  return CACHE_BYTES + 2 * THREADS * VEC * (int)sizeof(float);
}

template <int VEC, int ACT, int MODE>
__global__ void __launch_bounds__(THREADS, 1) bn_act_kernel(Params p) {
  // [slots][THREADS] Raw<VEC>: each thread's part of the CTA's last tiles
  // of x; then [2][THREADS * VEC] f32: each thread's sums, then x^2's
  extern __shared__ __align__(16) uint8_t smem[];
  Raw<VEC>* cache = reinterpret_cast<Raw<VEC>*>(smem);
  float* red = reinterpret_cast<float*>(smem + CACHE_BYTES);

  const int tid = threadIdx.x;
  const int g = p.c / VEC;            // chunks of VEC channels a row
  const int s = min(g, THREADS);      // chunks a slab
  const int R = THREADS / s;          // row groups: the rows of a tile
  const int rsub = tid / s;           // this thread's row group
  const int cg = tid % s;             // and chunk in the slab
  const int slabs = (g + s - 1) / s;
  const int tiles = (p.m + R - 1) / R;
  const int ctas = (int)gridDim.x;
  // the CTA's tiles: blockIdx.x + ctas * j, j < n; j >= j0 of the last slab
  // stay in shared memory
  const int n = (tiles - (int)blockIdx.x + ctas - 1) / ctas;
  const int j0 = n - min(n, slots<VEC>());
  const auto tile_of = [&](int j) { return j * ctas + (int)blockIdx.x; };
  const auto kept = [&](Raw<VEC>* base, int j) {
    return base + (long long)(j - j0) * THREADS + tid;
  };

  // the last tiles of x stay in shared memory between the phases of the
  // whole kernel only
  constexpr bool CACHE = MODE == MODE_WHOLE;
  const uint64_t keep = policy_evict_last();
  const uint64_t last_use = policy_evict_first();

  // ---- phase 1: per-CTA sums in fixed order --------------------------------
  if constexpr (MODE != MODE_APPLY) {
  for (int sl = 0; sl < slabs; ++sl) {
    const int chunk = sl * s + cg;
    const bool live = rsub < R && chunk < g;
    const bool last = sl == slabs - 1;
    float sum[VEC], sq[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) sum[j] = sq[j] = 0.0f;
    if (live) {
      for (int i = 0; i < n; i += U1) {
        Raw<VEC> raw[U1];
#pragma unroll
        for (int u = 0; u < U1; ++u) {
          raw[u] = {};  // past M: zeros, which add exactly nothing
          const int r = tile_of(i + u) * R + rsub;
          if (i + u < n && r < p.m)
            load(raw[u], p.x + (long long)r * p.c + chunk * VEC,
                 (CACHE && last && i + u >= j0) ? last_use : keep);
        }
#pragma unroll
        for (int u = 0; u < U1; ++u) {
          if (CACHE && last && i + u >= j0 && i + u < n)
            *kept(cache, i + u) = raw[u];
          float f[VEC];
          unpack(raw[u], f);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            sum[j] = __fadd_rn(sum[j], f[j]);
            sq[j] = __fadd_rn(sq[j], __fmul_rn(f[j], f[j]));  // exact square
          }
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        red[(rsub * s + cg) * VEC + j] = sum[j];
        red[THREADS * VEC + (rsub * s + cg) * VEC + j] = sq[j];
      }
    }
    __syncthreads();
    // the CTA's R row groups added in order, one thread a (stat, channel)
    const int chans = min(s, g - sl * s) * VEC;
    for (int k = tid; k < 2 * chans; k += THREADS) {
      const int st = k / chans, ch = k % chans;
      const float* r0 = red + st * THREADS * VEC + ch;
      float t = r0[0];
      for (int i = 1; i < R; ++i) t = __fadd_rn(t, r0[i * s * VEC]);
      p.part[((long long)blockIdx.x * 2 + st) * p.c + sl * s * VEC + ch] = t;
    }
    __syncthreads();
  }

  grid_sync(p.bar);

  // ---- the statistics: one warp a channel -----------------------------------
  const int warp = tid >> 5, lane = tid & 31;
  for (int ch = blockIdx.x * WARPS + warp; ch < p.c; ch += gridDim.x * WARPS) {
    float sum = 0.0f, sq = 0.0f;
    for (int k0 = lane; k0 < ctas; k0 += 32 * UF) {
      float vs[UF], vq[UF];  // loads first, then the adds in order
#pragma unroll
      for (int u = 0; u < UF; ++u) {
        const int k = k0 + 32 * u;
        vs[u] = k < ctas ? __ldcg(p.part + (long long)k * 2 * p.c + ch) : 0.0f;
        vq[u] = k < ctas ? __ldcg(p.part + ((long long)k * 2 + 1) * p.c + ch)
                         : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < UF; ++u) {
        sum = __fadd_rn(sum, vs[u]);
        sq = __fadd_rn(sq, vq[u]);
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));
    }
    if (MODE == MODE_SUMS) {
      if (lane == 0) {
        p.mean[ch] = sum;  // the statistics launch's [2, C] sums
        p.var[ch] = sq;
      }
      continue;
    }
    if (lane == 0) {
      const float fm = (float)p.m;
      const float mean = __fdiv_rn(sum, fm);
      const float var =
          fmaxf(__fsub_rn(__fdiv_rn(sq, fm), __fmul_rn(mean, mean)), 0.0f);
      p.mean[ch] = mean;
      p.var[ch] = var;
      p.a[ch] = __fmul_rn(__fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, p.eps))),
                          p.scale[ch]);
    }
  }

  if constexpr (MODE == MODE_SUMS) return;
  grid_sync(p.bar);
  }  // phases 1 and the statistics

  // ---- phase 2: normalize [+ act], the CTA's tiles in reverse ---------------
  for (int sl = slabs - 1; sl >= 0; --sl) {
    const int chunk = sl * s + cg;
    if (rsub >= R || chunk >= g) continue;
    const bool last = sl == slabs - 1;
    const int c0 = chunk * VEC;
    float mu[VEC], a[VEC], b[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if constexpr (MODE == MODE_APPLY) {
        // the statistics of the global sums, as the whole kernel derives
        // them after its grid sync
        const float fm = p.total;
        const float mean = __fdiv_rn(p.sums[c0 + j], fm);
        const float var = fmaxf(
            __fsub_rn(__fdiv_rn(p.sums[p.c + c0 + j], fm),
                      __fmul_rn(mean, mean)),
            0.0f);
        mu[j] = mean;
        a[j] = __fmul_rn(__fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, p.eps))),
                         p.scale[c0 + j]);
        if (blockIdx.x == 0 && rsub == 0) {
          p.mean[c0 + j] = mean;
          p.var[c0 + j] = var;
        }
      } else {
        mu[j] = __ldcg(p.mean + c0 + j);
        a[j] = __ldcg(p.a + c0 + j);
      }
      b[j] = p.bias[c0 + j];
    }
    for (int i = n - 1; i >= 0; i -= U2) {
      Raw<VEC> raw[U2];
      int r[U2];
#pragma unroll
      for (int u = 0; u < U2; ++u) {
        const int j = i - u;
        r[u] = j >= 0 ? tile_of(j) * R + rsub : p.m;
        if (r[u] >= p.m) continue;
        if (CACHE && last && j >= j0)
          raw[u] = *kept(cache, j);
        else
          load(raw[u], p.x + (long long)r[u] * p.c + c0, last_use);
      }
#pragma unroll
      for (int u = 0; u < U2; ++u) {
        if (r[u] >= p.m) continue;
        float f[VEC], y[VEC];
        unpack(raw[u], f);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          y[j] = __fadd_rn(__fmul_rn(__fsub_rn(f[j], mu[j]), a[j]), b[j]);
        Raw<VEC> out;
        pack(out, y);
        const long long at = (long long)r[u] * p.c + c0;
        store(p.ybn + at, out);
        if constexpr (ACT == 1) {
          relu(out);
          store(p.yact + at, out);
        }
      }
    }
  }
}

template <int VEC, int ACT, int MODE>
int occupancy(int* blocks) {
  static bool done = false;  // the shared-memory opt-in, once a process
  cudaError_t err = cudaSuccess;
  if (!done)
    err = cudaFuncSetAttribute(bn_act_kernel<VEC, ACT, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<VEC>());
  if (err != cudaSuccess) return (int)err;
  done = true;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, bn_act_kernel<VEC, ACT, MODE>, THREADS, smem_bytes<VEC>());
}

template <int VEC, int ACT, int MODE>
int launch(Params p, int ctas, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int rc = occupancy<VEC, ACT, MODE>(&per_sm);
  if (rc != 0) return rc;
  if (ctas < 1 || ctas > per_sm * sms)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      (const void*)bn_act_kernel<VEC, ACT, MODE>, dim3((unsigned)ctas),
      dim3(THREADS), args, smem_bytes<VEC>(), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(const Params& p, int ctas, int vec, int act, cudaStream_t s) {
  if (vec == 8)
    return act ? launch<8, 1, MODE>(p, ctas, s) : launch<8, 0, MODE>(p, ctas, s);
  return act ? launch<1, 1, MODE>(p, ctas, s) : launch<1, 0, MODE>(p, ctas, s);
}

int check(int m, int c, int ctas, int vec) {
  if (m <= 0 || c <= 0 || ctas < 1 || (vec != 8 && vec != 1) ||
      (vec == 8 && c % 8 != 0))
    return (int)cudaErrorInvalidValue;
  const int rows = THREADS / min(c / vec, THREADS);  // a tile
  if (ctas > (m + rows - 1) / rows) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// CTAs of K6 one SM holds at once, for channel chunks of `vec` (8 or 1) and
// act code `act` (0 none, 1 relu): the plan's per-SM cap. Returns the CUDA
// error code.
extern "C" int bn_act_occupancy(int vec, int act, int* blocks) {
  if (vec == 8)
    return act ? occupancy<8, 1, MODE_WHOLE>(blocks)
               : occupancy<8, 0, MODE_WHOLE>(blocks);
  return act ? occupancy<1, 1, MODE_WHOLE>(blocks)
             : occupancy<1, 0, MODE_WHOLE>(blocks);
}

// K6: ybn (and yact unless act is 0), mean, var from x [M, C] bf16 and
// scale, bias [C] f32, over `ctas` CTAs, each at least one tile. vec 8
// needs C a multiple of 8 and 16-byte aligned x. part holds ctas * 2 * C
// floats and a C floats of scratch; bar is a zeroed counter that the
// kernel leaves as it found it. Returns the CUDA error code
// (cudaErrorCooperativeLaunchTooLarge for a grid past the card's room).
extern "C" int bn_act(const void* x, const void* scale, const void* bias,
                      void* ybn, void* yact, void* mean, void* var,
                      void* part, void* a, void* bar, int m, int c, int ctas,
                      float eps, int vec, int act, void* stream) {
  int rc = check(m, c, ctas, vec);
  if (rc != 0 || (act != 0 && yact == nullptr))
    return rc ? rc : (int)cudaErrorInvalidValue;
  Params p{static_cast<const __nv_bfloat16*>(x),
           static_cast<const float*>(scale),
           static_cast<const float*>(bias),
           static_cast<__nv_bfloat16*>(ybn),
           static_cast<__nv_bfloat16*>(yact),
           static_cast<float*>(mean),
           static_cast<float*>(var),
           static_cast<float*>(part),
           static_cast<float*>(a),
           static_cast<unsigned*>(bar),
           nullptr,
           m,
           c,
           eps,
           0.0f};
  return dispatch<MODE_WHOLE>(p, ctas, vec, act,
                              static_cast<cudaStream_t>(stream));
}

// K6's statistics launch (the split form): sums [2, C] f32, the
// per-channel sum of x and of x^2 in the whole kernel's order, over the
// same plan (`ctas`, part, bar as bn_act's).
extern "C" int bn_act_sums(const void* x, void* sums, void* part, void* bar,
                           int m, int c, int ctas, int vec, void* stream) {
  int rc = check(m, c, ctas, vec);
  if (rc != 0) return rc;
  float* out = static_cast<float*>(sums);
  Params p{static_cast<const __nv_bfloat16*>(x), nullptr, nullptr, nullptr,
           nullptr, out, out + c, static_cast<float*>(part), nullptr,
           static_cast<unsigned*>(bar), nullptr, m, c, 0.0f, 0.0f};
  return dispatch<MODE_SUMS>(p, ctas, vec, 0,
                             static_cast<cudaStream_t>(stream));
}

// K6's normalize launch (the split form): from the global sums [2, C] f32
// over `total` rows, mean and var (written to mean, var [C]) and ybn (and
// yact unless act is 0) of this rank's x [M, C].
extern "C" int bn_act_apply(const void* x, const void* scale,
                            const void* bias, const void* sums, void* ybn,
                            void* yact, void* mean, void* var, int m, int c,
                            int ctas, float total, float eps, int vec,
                            int act, void* stream) {
  int rc = check(m, c, ctas, vec);
  if (rc != 0 || (act != 0 && yact == nullptr) || !(total > 0.0f))
    return rc ? rc : (int)cudaErrorInvalidValue;
  Params p{static_cast<const __nv_bfloat16*>(x),
           static_cast<const float*>(scale),
           static_cast<const float*>(bias),
           static_cast<__nv_bfloat16*>(ybn),
           static_cast<__nv_bfloat16*>(yact),
           static_cast<float*>(mean),
           static_cast<float*>(var),
           nullptr,
           nullptr,
           nullptr,
           static_cast<const float*>(sums),
           m,
           c,
           eps,
           total};
  return dispatch<MODE_APPLY>(p, ctas, vec, act,
                              static_cast<cudaStream_t>(stream));
}
