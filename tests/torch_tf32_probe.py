"""What the H100's tf32 wgmma does with the operands of the f32
flash-attention backward (paddle_tpu_torch/csrc/flash_attn_bwd_tf32.cu),
measured on the card with the helpers of csrc/hopper_gemm.cuh:

1. layout: m64n32k8 with both operands from 128-byte-swizzled shared memory
   (ss) and with A from registers (rs) in mma.m16n8k8's tf32 A layout,
   against A @ B^T of small integers (exact);
2. rounding: which tf32 value the hardware takes for a raw f32 operand
   with low bits set, in shared memory and in registers (truncated or
   rounded to nearest);
3. drift: a chain of k8 steps into one accumulator, as a sequence-long sum
   of the backward would be, against the f64 sum of the same products, and
   the same chain taken as partials of `join` k8 steps joined by f32 adds.

Run on a machine with the card and nvcc (about 20 s):

    python tests/torch_tf32_probe.py [--json out.json]

Prints one JSON object.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from paddle_tpu_torch.ops import cuda_build  # noqa: E402

SOURCE = r"""
#include "hopper_gemm.cuh"

// element (r, c) of a [R][32] f32 block with the 128-byte swizzle
__device__ __forceinline__ int sw(int r, int c) {
  return r * 32 + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
}

__device__ __forceinline__ void store_acc(float* out, const float (&d)[16]) {
  const int t = threadIdx.x, w = t >> 5, l = t & 31;
  for (int j = 0; j < 4; ++j)
    for (int e = 0; e < 4; ++e)
      out[(16 * w + l / 4 + 8 * (e >> 1)) * 32 + 8 * j + 2 * (l % 4) + (e & 1)] =
          d[4 * j + e];
}

// D [64][32] = A [64][8] * B^T (B [32][8]) three ways: ss; rs in the
// m16n8k8 tf32 A layout; rs in the pairwise layout
__global__ void layout_probe(const float* a, const float* b, float* d_ss,
                             float* d_rs, float* d_pair) {
  __shared__ __align__(1024) float as[64 * 32];
  __shared__ __align__(1024) float bs[32 * 32];
  const int t = threadIdx.x;
  for (int i = t; i < 64 * 32; i += 128) {
    const int r = i / 32, c = i % 32;
    as[sw(r, c)] = c < 8 ? a[r * 8 + c] : 0.0f;
  }
  for (int i = t; i < 32 * 32; i += 128) {
    const int r = i / 32, c = i % 32;
    bs[sw(r, c)] = c < 8 ? b[r * 8 + c] : 0.0f;
  }
  hg::fence_proxy_async();
  __syncthreads();
  const uint64_t da = hg::desc_sw128(hg::smem_u32(as), 16, 1024);
  const uint64_t db = hg::desc_sw128(hg::smem_u32(bs), 16, 1024);
  const int w = t >> 5, l = t & 31, g = l >> 2, q = l & 3, r = 16 * w + g;
  float d[16];
  for (int i = 0; i < 16; ++i) d[i] = 0.0f;
  hg::wgmma_fence();
  hg::wgmma_tf32_ss<32>(d, da, db, 0);
  hg::wgmma_commit();
  hg::wgmma_wait<0>();
  hg::fence_regs(d);
  store_acc(d_ss, d);
  uint32_t x[4] = {__float_as_uint(a[r * 8 + q]), __float_as_uint(a[(r + 8) * 8 + q]),
                   __float_as_uint(a[r * 8 + q + 4]),
                   __float_as_uint(a[(r + 8) * 8 + q + 4])};
  hg::wgmma_fence();
  hg::wgmma_tf32_rs<32>(d, x, db, 0);
  hg::wgmma_commit();
  hg::wgmma_wait<0>();
  hg::fence_regs(d);
  hg::fence_regs(x);
  store_acc(d_rs, d);
  uint32_t y[4] = {__float_as_uint(a[r * 8 + 2 * q]),
                   __float_as_uint(a[r * 8 + 2 * q + 1]),
                   __float_as_uint(a[(r + 8) * 8 + 2 * q]),
                   __float_as_uint(a[(r + 8) * 8 + 2 * q + 1])};
  hg::wgmma_fence();
  hg::wgmma_tf32_rs<32>(d, y, db, 0);
  hg::wgmma_commit();
  hg::wgmma_wait<0>();
  hg::fence_regs(d);
  hg::fence_regs(y);
  store_acc(d_pair, d);
}

// out [64][32] = reps * A [64][256] * B^T (B [32][256]) as one chain of
// 32 * reps k8 steps (join 0), or as partials of `join` k8 steps joined by
// f32 adds
__global__ void chain_probe(const float* a, const float* b, int reps,
                            int join, float* out) {
  extern __shared__ uint8_t raw[];
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  float* as = smem;              // 8 blocks of [64][32]
  float* bs = smem + 8 * 64 * 32;  // 8 blocks of [32][32]
  const int t = threadIdx.x;
  for (int i = t; i < 64 * 256; i += 128) {
    const int r = i / 256, c = i % 256;
    as[(c / 32) * 64 * 32 + sw(r, c % 32)] = a[i];
  }
  for (int i = t; i < 32 * 256; i += 128) {
    const int r = i / 256, c = i % 256;
    bs[(c / 32) * 32 * 32 + sw(r, c % 32)] = b[i];
  }
  hg::fence_proxy_async();
  __syncthreads();
  float acc[16], part[16];
  for (int i = 0; i < 16; ++i) acc[i] = part[i] = 0.0f;
  int n = 0;
  for (int rep = 0; rep < reps; ++rep) {
    hg::wgmma_fence();
    for (int kk = 0; kk < 32; ++kk) {
      const uint32_t ao = hg::smem_u32(as) + (kk >> 2) * 64 * 128 + (kk & 3) * 32;
      const uint32_t bo = hg::smem_u32(bs) + (kk >> 2) * 32 * 128 + (kk & 3) * 32;
      hg::wgmma_tf32_ss<32>(part, hg::desc_sw128(ao, 16, 1024),
                            hg::desc_sw128(bo, 16, 1024),
                            join == 0 ? (n > 0) : (n % join != 0));
      ++n;
      if (join > 0 && n % join == 0) {
        hg::wgmma_commit();
        hg::wgmma_wait<0>();
        hg::fence_regs(part);
        for (int i = 0; i < 16; ++i) acc[i] += part[i];
        hg::wgmma_fence();
      }
    }
    hg::wgmma_commit();
    hg::wgmma_wait<0>();
    hg::fence_regs(part);
  }
  if (join == 0 || n % join != 0)  // the chain, or the last partial
    for (int i = 0; i < 16; ++i) acc[i] += part[i];
  store_acc(out, acc);
}

extern "C" int probe_layout(const void* a, const void* b, void* d_ss,
                            void* d_rs, void* d_pair) {
  layout_probe<<<1, 128>>>((const float*)a, (const float*)b, (float*)d_ss,
                           (float*)d_rs, (float*)d_pair);
  return (int)cudaDeviceSynchronize();
}

extern "C" int probe_chain(const void* a, const void* b, int reps, int join,
                           void* out) {
  const int smem = (8 * 64 * 32 + 8 * 32 * 32) * 4 + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      chain_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  chain_probe<<<1, 128, smem>>>((const float*)a, (const float*)b, reps, join,
                                (float*)out);
  return (int)cudaDeviceSynchronize();
}
"""


def build():
    out_dir = cuda_build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "tf32_probe.cu"
    src.write_text(SOURCE)
    lib = out_dir / "libtf32_probe.so"
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           "-I", str(cuda_build.CSRC), "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def tf32_trunc(x):
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_rna(x):
    i = x.view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    lib = build()
    vp = ctypes.c_void_p
    lib.probe_layout.argtypes = [vp] * 5
    lib.probe_chain.argtypes = [vp, vp, ctypes.c_int, ctypes.c_int, vp]
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    report = {"card": torch.cuda.get_device_name(0)}

    # 1. layout, small integers: every product and sum exact
    a = torch.randint(-8, 9, (64, 8), generator=gen).float().to(dev)
    b = torch.randint(-8, 9, (32, 8), generator=gen).float().to(dev)
    outs = [torch.zeros((64, 32), device=dev) for _ in range(3)]
    rc = lib.probe_layout(a.data_ptr(), b.data_ptr(),
                          *[o.data_ptr() for o in outs])
    assert rc == 0, rc
    want = a.double() @ b.double().T
    report["layout"] = {name: bool(torch.equal(o.double(), want)) for name, o
                        in zip(("ss", "rs_m16n8k8", "rs_pairwise"), outs)}

    # 2. rounding: B the identity on its first 8 rows, A with low bits set so
    # that truncation and rounding to nearest differ
    base = 1.0 + torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8) / 512
    bits = base.view(torch.int32) | 0x1F00          # above half a tf32 ulp
    a = bits.view(torch.float32).to(dev)
    b = torch.zeros((32, 8), device=dev)
    b[:8, :8] = torch.eye(8, device=dev)
    rc = lib.probe_layout(a.data_ptr(), b.data_ptr(),
                          *[o.data_ptr() for o in outs])
    assert rc == 0, rc
    got = {"ss": outs[0][:, :8], "rs": outs[1][:, :8]}
    report["rounding"] = {
        name: ("truncated" if torch.equal(g, tf32_trunc(a)) else
               "nearest" if torch.equal(g, tf32_rna(a)) else "other")
        for name, g in got.items()}

    # 3. drift: tf32-exact random operands, chains of 32 * reps k8 steps
    a = tf32_rna(torch.randn((64, 256), generator=gen)).to(dev)
    b = tf32_rna(torch.randn((32, 256), generator=gen)).to(dev)
    exact = a.double() @ b.double().T
    mag = a.double().abs() @ b.double().abs().T
    drift = {}
    for reps in (8, 24, 96):                       # T 2048, 6144, 24576 keys
        for join in (0, 4, 12):
            out = torch.zeros((64, 32), device=dev)
            rc = lib.probe_chain(a.data_ptr(), b.data_ptr(), reps, join,
                                 out.data_ptr())
            assert rc == 0, rc
            err = (out.double() - reps * exact).abs() / (reps * mag)
            drift[f"k8_steps_{32 * reps}_join_{join or 'none'}"] = {
                "max_rel": err.max().item(), "mean_rel": err.mean().item(),
                "mean_signed": ((out.double() - reps * exact) /
                                (reps * mag)).mean().item()}
    report["drift"] = drift
    line = json.dumps(report)
    print(line)
    if args.json:
        Path(args.json).write_text(line)


if __name__ == "__main__":
    main()
