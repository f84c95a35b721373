"""chip_smoke.py's ptxas gate on the CPU: the build log of a kernel that
spills registers must stop the smoke, a clean log must pass it, and ptxas's
serialized-wgmma warning (C7511) is recorded without hiding either. Also
`--parent`'s loader of an older checkout's batch-norm module, the
train_feeder phase's copy-overlap share on a made-up trace, the launch
lead of a made-up profile, the kernel counters a profiler event's name
counts for (how the launches of a CUDA graph's replay are counted), and
the same counters over a CUDA graph's DOT dump."""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import (_copy_overlap, _dot_launches,  # noqa: E402
                        _launch_lead_us, _trace_launches, parent_bn_cuda,
                        ptxas_report)

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


class _Raw:
    """A kineto record as the profiler's raw results hold it."""

    def __init__(self, name, device, corr, start_ns):
        self._v = (name, device, corr, start_ns)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]


def test_launch_lead_pairs_records_with_their_runtime_calls():
    """The least card-record start less its runtime call's start (µs),
    paired by correlation id: a graph launch at 1000 ns whose kernels start
    at 6000 and 800 ns, a kernel launch at 2000 ns whose kernel starts at
    9000; an aten op and an unpaired record count for nothing."""
    from torch.autograd import DeviceType
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_Raw("cudaGraphLaunch", cpu, 7, 1000),
              _Raw("cudaLaunchKernel", cpu, 8, 2000),
              _Raw("aten::add", cpu, 9, 0),
              _Raw("bn_act_kernel", cuda, 7, 6000),
              _Raw("conv2d_fwd_kernel", cuda, 7, 800),
              _Raw("relu", cuda, 8, 9000),
              _Raw("orphan", cuda, 11, 0)]
    prof = type("P", (), {})()
    prof.profiler = type("K", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda s: events})()
    assert _launch_lead_us(prof) == pytest.approx(-0.2)
    prof.profiler.kineto_results = type("R", (), {"events": lambda s: events[2:3]})()
    assert _launch_lead_us(prof) is None
    assert _launch_lead_us(object()) is None


# nodes of a ResNet-50 O3 training step's CUDA graph as
# cudaGraphDebugDotPrint writes them (verbose), trimmed to the label lines
# the count reads
DOT = r"""digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_3"[style="solid" style="solid" shape="record" label="{MEMSET
| {{ID | node handle | dptr | pitch | value | elementSize | width | height} | {3 (topoId: 2688) | 0x000000001F27F048 | 0x00007F8FEA000000 | 0 | 0 | 1 | 25690112 | 1}}}"];
"graph_1_node_8"[style="bold" shape="record" label="{KERNEL
| {ID | 8 (topoId: 2683) | _ZN41_GLOBAL__N__6c6db389_9_bn_act_cu_65c2c48313bn_act_kernelILi8ELi1EEEvNS_6ParamsE\<\<\<132,512,229376\>\>\>}
| {cooperative | 1}
}"];
"graph_1_node_17"[style="bold" shape="record" label="{KERNEL
| {ID | 17 (topoId: 2674) | _ZN46_GLOBAL__N__19570ee1_13_conv2d_fwd_cu_c0cc5bd517conv2d_fwd_kernelILi64E13__nv_bfloat16Lb0EEEv14CUtensorMap_stS2_S2_NS_6ParamsE\<\<\<\{784,4\},288,25664\>\>\>}
| {cooperative | 0}
}"];
"graph_1_node_115"[style="bold" shape="record" label="{KERNEL
| {ID | 115 (topoId: 2576) | _ZN44_GLOBAL__N__d5e697cb_11_quantize_cu_0c0d40a217quant_rows_kernelI13__nv_bfloat16Lb0ELi8EEEvPKT_iiiNS_4ViewEPhS5_Pff\<\<\<512,32,0\>\>\>}
| {cooperative | 0}
}"];
"graph_1_node_117"[style="bold" shape="record" label="{KERNEL
| {ID | 117 (topoId: 2574) | _ZN46_GLOBAL__N__19570ee1_13_conv2d_fwd_cu_c0cc5bd520conv2d_fwd_q8_kernelILi64E13__nv_bfloat16EEv14CUtensorMap_stS2_S2_NS_6ParamsE\<\<\<\{196,8\},288,50240\>\>\>}
| {cooperative | 0}
}"];
"graph_1_node_118"[style="bold" shape="record" label="{KERNEL
| {ID | 118 (topoId: 2573) | _ZN41_GLOBAL__N__6c6db389_9_bn_act_cu_65c2c48313bn_act_kernelILi8ELi0EEEvNS_6ParamsE\<\<\<132,512,229376\>\>\>}
| {cooperative | 1}
}"];
}
}"""


def test_graph_nodes_count_for_their_kernels():
    """A graph's kernel nodes, demangled, count for the same counters as
    the profiler's events of their kernels: two K6 nodes, a K2 (K1's
    kernel without statistics), a K11 and a Q1 row quantize; the memset
    counts for nothing."""
    got = {k: v for k, v in _dot_launches(DOT).items() if v}
    assert got == {"bn.act_launches": 2, "conv.dgrad_launches": 1,
                   "conv.q8_launches": 1, "q1.total": 1}


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


K6_EVENT = "void (anonymous namespace)::bn_act_kernel<8, 1>(Params)"
K11_EVENT = ("void (anonymous namespace)::conv2d_fwd_q8_kernel<64, "
             "__nv_bfloat16>(CUtensorMap_st, CUtensorMap_st, "
             "CUtensorMap_st, Params)")
EXPECT = {"bn.act_launches": 3, "conv.q8_launches": 2}


class _Traced:
    """A device event of a made-up profile."""

    def __init__(self, name, start):
        from torch.autograd import DeviceType
        self.name, self.device_type = name, DeviceType.CUDA
        self.time_range = type("R", (), {
            "start": start, "end": start + 5.0,
            "elapsed_us": lambda s: 5.0})()


@pytest.mark.parametrize("k6_traced, nodes, outcome", [
    (3, {"bn.act_launches": 3, "conv.q8_launches": 2}, {}),
    (2, {"bn.act_launches": 3, "conv.q8_launches": 2}, {"bn.act_launches": 1}),
    (2, None, "raises"),
    (4, {"bn.act_launches": 3, "conv.q8_launches": 2}, "raises"),
    (3, {"bn.act_launches": 2, "conv.q8_launches": 2}, "raises"),
], ids=["trace_whole", "record_lost_graph_whole", "record_lost_no_graph",
        "launch_beyond_graph", "graph_short"])
def test_profile_step_holds_the_graph_and_the_trace(monkeypatch, k6_traced,
                                                     nodes, outcome):
    """_profile_step holds `expect` to the replayed graph's kernel nodes
    first; a trace that lacks records of them in every attempt is
    reported (lost_records) only when the graph holds them all and the
    trace holds nothing beyond them, and raises otherwise."""
    import contextlib

    import chip_smoke

    events = ([_Traced(K6_EVENT, 10.0 * i) for i in range(k6_traced)]
              + [_Traced(K11_EVENT, 100.0 + 10.0 * i) for i in range(2)])

    @contextlib.contextmanager
    def profiled():
        chip_smoke.LAUNCH_LEADS_US.append(None)
        yield type("P", (), {"events": lambda s: events,
                             "key_averages": lambda s: []})()

    monkeypatch.setattr(chip_smoke, "_profiled", profiled)
    monkeypatch.setattr(chip_smoke, "_graph_launches",
                        lambda g: {k: 0 for k in chip_smoke.TRACE_KERNELS}
                        | (nodes or {}))
    exe = type("Exe", (), {"run": lambda s, *a, **k: None})()
    witness = ("K11", lambda n: "conv2d_fwd_q8_kernel" in n)
    call = lambda: chip_smoke._profile_step(  # noqa: E731
        exe, None, {}, None, None, 1.0, "card", witness, expect=EXPECT,
        graph=None if nodes is None else object())
    if outcome == "raises":
        with pytest.raises(RuntimeError):
            call()
    else:
        got = call()
        assert got["lost_records"] == outcome
        assert got["launches"]["bn.act_launches"] == k6_traced
