"""chip_smoke.py's ptxas gate on the CPU: the build log of a kernel that
spills registers must stop the smoke, a clean log must pass it, and ptxas's
serialized-wgmma warning (C7511) is recorded without hiding either."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import ptxas_report  # noqa: E402

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
