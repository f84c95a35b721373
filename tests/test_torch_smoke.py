"""chip_smoke.py's ptxas gate on the CPU: the build log of a kernel that
spills registers must stop the smoke, a clean log must pass it, and ptxas's
serialized-wgmma warning (C7511) is recorded without hiding either. Also
`--parent`'s loader of an older checkout's batch-norm module, the
train_feeder phase's copy-overlap share on a made-up trace, and the
kernel counters a profiler event's name counts for (how the launches of a
CUDA graph's replay are counted)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import (_copy_overlap, _trace_launches,  # noqa: E402
                        parent_bn_cuda, ptxas_report)

MANGLED = ("_ZN55_GLOBAL__N__6c76bbb5_22_flash_attn_bwd_tf32_cu_98bb9b7e15"
           "dkv_tf32_kernelILi128ELi32ELi1ELi2EEEv14CUtensorMap_stS1_S1_S1_"
           "S1_S1_NS_6ParamsE")
PROPS = f"ptxas info    : Function properties for {MANGLED}"
USED = "ptxas info    : Used 246 registers, used 1 barriers"
CLEAN = "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
SPILL = "    24 bytes stack frame, 24 bytes spill stores, 24 bytes spill loads"
C7511 = ("ptxas info    : (C7511) Potential Performance Loss: wgmma.mma_async "
         "instructions are serialized due to insufficient register resources "
         f"for the wgmma pipeline in the function '{MANGLED}'")


def _log(*lines):
    return {"flash_attn_bwd_tf32": {"log": "\n".join(lines)}}


@pytest.mark.parametrize("lines", [
    (PROPS, SPILL, USED),
    (C7511, PROPS, SPILL, USED),
    (PROPS, SPILL, USED, C7511),
], ids=["spill", "warning_then_spill", "spill_then_warning"])
def test_spilling_kernel_stops_the_smoke(lines):
    with pytest.raises(RuntimeError, match="kernels spill registers"):
        ptxas_report(_log(*lines))


@pytest.mark.parametrize("lines", [
    (PROPS, CLEAN, USED),
    (C7511, PROPS, CLEAN, USED),
], ids=["clean", "warning"])
def test_clean_kernel_passes_and_is_reported(lines):
    report = ptxas_report(_log(*lines))
    key = "flash_attn_bwd_tf32 dkv_tf32_kernel<128,32,1,2>"
    assert key in report
    assert CLEAN.strip() in report[key] and USED in report[key]
    assert (C7511 in report[key]) == (C7511 in lines)


PARENT_BN = """from dataclasses import dataclass, field
from typing import Dict

import torch


@dataclass
class Counters:
    act_launches: int = 0
    hits: Dict[str, int] = field(default_factory=dict)


COUNTERS = Counters()


def bn_act(x2, scale, bias, eps, act=None):
    COUNTERS.act_launches += 1
    return x2 * 2, None, x2.float().mean(0), x2.float().var(0)
"""


def test_parent_bn_module_loads_by_file_path(tmp_path):
    """`--parent DIR` loads DIR's paddle_tpu_torch/ops/bn_cuda.py (the
    older K6: a module of dataclasses that imports torch and triton only)
    by file path under a private name, apart from this tree's module."""
    ops = tmp_path / "paddle_tpu_torch" / "ops"
    ops.mkdir(parents=True)
    (ops / "bn_cuda.py").write_text(PARENT_BN)
    from paddle_tpu_torch.ops import bn_cuda
    before = bn_cuda.COUNTERS.act_launches
    mod = parent_bn_cuda(tmp_path)
    assert mod is not bn_cuda and mod.__name__ != bn_cuda.__name__
    import torch
    x = torch.ones((4, 3))
    y, _, mean, _ = mod.bn_act(x, None, None, 1e-5)
    assert torch.equal(y, x * 2) and torch.equal(mean, torch.ones(3))
    assert mod.COUNTERS.act_launches == 1
    assert bn_cuda.COUNTERS.act_launches == before


class _Event:
    def __init__(self, name, start, end):
        self.name = name
        self.time_range = type("R", (), {"start": start, "end": end})()


def test_copy_overlap_share():
    """Host-to-device copy time overlapping the union of the kernels'
    intervals (µs in, ms out): copies [0, 10] and [20, 30] against kernels
    [5, 12] and [8, 25] (one interval [5, 25]): 5 + 5 of 20 µs."""
    events = [_Event("Memcpy HtoD (Pinned -> Device)", 0, 10),
              _Event("Memcpy HtoD (Pinned -> Device)", 20, 30),
              _Event("conv2d_fwd_kernel", 5, 12), _Event("relu", 8, 25),
              _Event("Memcpy DtoH (Device -> Pageable)", 40, 50)]
    ms, share = _copy_overlap(events)
    assert ms == pytest.approx(0.020) and share == pytest.approx(0.5)
    assert _copy_overlap(events[2:4]) == (0.0, None)


# full names as the profiler reports the kernels of a training step
TRACED = {
    "void (anonymous namespace)::conv2d_fwd_kernel<128, __nv_bfloat16, "
    "false>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, Params)":
        "conv.dgrad_launches",
    "void (anonymous namespace)::conv2d_fwd_kernel<64, __nv_bfloat16, "
    "true>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, Params)":
        "conv.stats_launches",
    "void (anonymous namespace)::conv2d_wgrad_kernel<2, 128>("
    "CUtensorMap_st, CUtensorMap_st, WParams)": "conv.wgrad_launches",
    "_bn_apply_body": "bn.apply_launches",
    "void (anonymous namespace)::bn_act_kernel<8, 1>(Params)":
        "bn.act_launches",
    "void (anonymous namespace)::flash_fwd_kernel<64, 64, 1, true>("
    "CUtensorMap_st, CUtensorMap_st)": "attn.launches",
    "void (anonymous namespace)::flash_fwd_kernel<64, 128, 1, false>("
    "CUtensorMap_st, CUtensorMap_st)": "attn.block_launches",
    "void (anonymous namespace)::flash_dq_kernel<64, 64, 1>("
    "CUtensorMap_st)": "attn.dq_launches",
    "void (anonymous namespace)::flash_dkv_kernel<64, 48>("
    "CUtensorMap_st)": "attn.dkv_launches",
    "void (anonymous namespace)::fwd_tf32_kernel<64, 64, 2, 1, true>("
    "CUtensorMap_st)": "attn.f32_launches",
    "void (anonymous namespace)::fwd_tf32_kernel<64, 64, 2, 1, false>("
    "CUtensorMap_st)": "attn.f32_block_launches",
    "void (anonymous namespace)::dq_tf32_kernel<64, 32, 2>("
    "CUtensorMap_st)": "attn.f32_dq_launches",
    "void (anonymous namespace)::dkv_tf32_kernel<64, 32, 2, 3>("
    "CUtensorMap_st)": "attn.f32_dkv_launches",
    # K11, which the O3 training step launches, and Q1's three forms
    "void (anonymous namespace)::conv2d_fwd_q8_kernel<64, signed char>("
    "CUtensorMap_st)": "conv.q8_launches",
    "void (anonymous namespace)::q8_tensor_kernel<__nv_bfloat16, 8>("
    "__nv_bfloat16 const*, long, float const*, int, unsigned char*, "
    "float*)": "q1.total",
    "void (anonymous namespace)::quant_rows_kernel<__nv_bfloat16, true, "
    "8>(__nv_bfloat16 const*, int, int, int, (anonymous namespace)::View, "
    "unsigned char*, (anonymous namespace)::View, float*, float)":
        "q1.total",
    "void (anonymous namespace)::quant_cols_kernel<float, false>(float "
    "const*, int, int, long, float const*, int, unsigned char*, float*, "
    "float)": "q1.total",
    "void (anonymous namespace)::dequant_kernel<int, __nv_bfloat16, 4>("
    "int const*, long, float const*, float const*, __nv_bfloat16*, int, "
    "int)": "q1.total",
}
UNCOUNTED = (
    "void (anonymous namespace)::q8_partial_kernel<__nv_bfloat16, 8>("
    "__nv_bfloat16 const*, long, float*)",
    "void (anonymous namespace)::cols_partial_kernel<__nv_bfloat16>("
    "__nv_bfloat16 const*, int, int, long, float*)",
    "void (anonymous namespace)::splitk_reduce_q8_kernel<__nv_bfloat16>("
    "int const*, int, long long, int, float const*, __nv_bfloat16*)",
    "void (anonymous namespace)::splitk_reduce_kernel<__nv_bfloat16>("
    "float const*, int, long long, int, __nv_bfloat16*)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, "
    "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)",
)


@pytest.mark.parametrize("name", sorted(TRACED) + list(UNCOUNTED))
def test_trace_event_counts_for_its_kernel(name):
    """Each hand-written kernel's event counts once, for its counter only;
    other kernels count for none."""
    event = type("Event", (), {"name": name})
    got = {k: v for k, v in _trace_launches([event]).items() if v}
    assert got == ({TRACED[name]: 1} if name in TRACED else {})
