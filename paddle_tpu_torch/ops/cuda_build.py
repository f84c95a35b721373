"""Builds the port's hand-written CUDA kernels and loads them with ctypes.

Each source under `paddle_tpu_torch/csrc/` compiles with nvcc into its own
shared library with a plain C entry point, at first use, into `build/kernels/`
at the root of the checkout (listed in .gitignore). A library's file name
carries a hash of its source and flags, so an edited source rebuilds and a
stale library is never loaded. Nothing is built when this module is
imported: the CPU tests import every module, and the CPU has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

from .. import telemetry

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# kernel library name -> source file under csrc/
SOURCES = {"conv2d_fwd": "conv2d_fwd.cu", "conv2d_wgrad": "conv2d_wgrad.cu",
           "flash_attn_fwd": "flash_attn_fwd.cu",
           "flash_attn_bwd": "flash_attn_bwd.cu",
           "flash_attn_fwd_tf32": "flash_attn_fwd_tf32.cu",
           "flash_attn_bwd_tf32": "flash_attn_bwd_tf32.cu",
           "bn_act": "bn_act.cu", "quantize": "quantize.cu",
           "sparse_apply": "sparse_apply.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# kernel name -> {"seconds": build wall time, "log": nvcc/ptxas output}
BUILD_LOG: Dict[str, Dict[str, object]] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the csrc/ headers
    it may include, and the flags."""
    src = (CSRC / SOURCES[name]).read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Dict[str, object]]:
    """Compile every named kernel that has no up-to-date library yet, one
    nvcc process per source, all started together. Raises with nvcc's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "log": log}
        telemetry.note_compile("kernel_build", BUILD_LOG[name]["seconds"])
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {n: BUILD_LOG[n] for n in procs}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def entry(lib_name: str, fn_name: str, argtypes):
    """A C entry point of a kernel library, its argtypes set (ctypes.c_void_p
    for every pointer and the stream, so none is cut to 32 bits) and its
    return type the CUDA error code."""
    fn = getattr(load(lib_name), fn_name)
    if fn.argtypes != argtypes:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def aligned(t):
    """`t` contiguous with a 16-byte aligned data pointer (the kernels' vector
    loads), copied only when it is not already."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
