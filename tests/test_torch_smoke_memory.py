"""chip_smoke.py's phase `memory` rehearsed on the CPU at a small size: a
CIFAR ResNet (depth 8, 32x32) trained under AMP O2 in place of ResNet-50,
the card stood in for (the executor's place resolves to the CPU, the gate
answers as for a CUDA place, a capture runs its body once and each replay
runs it, the allocator's statistics read 0, and measure_memory, which
reads the caching allocator's peak, returns the static estimate of the
step it runs). The phase's control flow and checks run: the headroom model
fitted and validated, the cost of the sample after each run, the OOM
process's run (in this process) with a synthetic allocator failure past
the fitted max batch, eager and in a capture (the ten largest buffers
named), then the recovery and graphed steps, the served model's
admission and request, the broken program's refusal. No kernel runs here:
the card holds the launches."""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import executor as E  # noqa: E402
from paddle_tpu_torch.ops import bn_cuda, conv_cuda, registry  # noqa: E402

SMALL = {"net": "cifar", "depth": 8, "img": 32, "classes": 10,
         "batches": (8, 16, 32), "budget": 48 << 20, "recover": 32,
         "serve_batch": 16, "device": "cpu", "tracker_steps": 1}


class _Replayed:
    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()

    def pool(self):
        return None


def _capture(body, pool=None, keep=False, generators=()):
    """A capture stood in for: its body runs once (so an allocation failure
    inside it shows), each replay runs it again."""
    body()
    return _Replayed(body)


@pytest.fixture
def card(monkeypatch):
    monkeypatch.setattr(E, "place_device", lambda place: torch.device("cpu"))
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats",
                 "set_per_process_memory_fraction"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated",
                 "memory_reserved"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda *a: (80 << 30, 80 << 30))
    monkeypatch.setattr(chip_smoke, "_card_line", lambda: "cpu stand-in")
    monkeypatch.setattr(E, "capture_graph", _capture)
    gate = E.Executor.graph_gate

    def as_on_a_card(self, program, feed, use_jit=None,
                     use_program_cache=True):
        dev, self.device = self.device, torch.device("cuda", 0)
        try:
            return gate(self, program, feed, use_jit, use_program_cache)
        finally:
            self.device = dev

    monkeypatch.setattr(E.Executor, "graph_gate", as_on_a_card)

    def measure(self, program=None, feed=None, fetch_list=None, scope=None):
        self.run(program, feed=feed, fetch_list=fetch_list, scope=scope,
                 use_jit=False)
        return self.static_memory_analysis(program, feed=feed,
                                           fetch_list=fetch_list, scope=scope)

    monkeypatch.setattr(E.Executor, "measure_memory", measure)


def _planted_oom(monkeypatch, limit):
    """The conv lowering runs out of memory on a batch above limit[0]."""
    opdef = registry.get("conv2d")
    orig = opdef.lower

    def lower(ctx, op, ins):
        if ins["Input"][0].shape[0] > limit[0]:
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB")
        return orig(ctx, op, ins)
    monkeypatch.setattr(opdef, "lower", lower)


def test_memory_phase_rehearsed(card, monkeypatch):
    limit = [1 << 30]
    _planted_oom(monkeypatch, limit)
    seen = {}

    def oom_here(cfg, fit, timeout):
        # under the process's memory limit the allocator fails past the
        # fitted max batch, as the card under the budget does past ~1.25x
        # of it; with the limit lifted (fraction 1) it does not
        bmax = pt.memory.HeadroomModel(
            fit["fixed_bytes"], fit["per_item_bytes"]).max_batch(
                cfg["budget"])
        monkeypatch.setattr(
            torch.cuda, "set_per_process_memory_fraction",
            lambda f, *a: limit.__setitem__(0, 1 << 30 if f >= 1 else bmax))
        seen["fit"] = fit
        return chip_smoke._memory_oom_run(pt, conv_cuda, bn_cuda, cfg, fit)

    monkeypatch.setattr(chip_smoke, "_memory_oom_fresh", oom_here)
    report = {}
    launches = chip_smoke.phase_memory(pt, conv_cuda, bn_cuda, report, SMALL)
    rec = report["memory"]
    assert set(launches) == set(chip_smoke.MEMORY_KERNELS)
    res = rec["what_if"]
    assert res["max_batch"] > max(SMALL["batches"])
    assert res["rel_err"] <= chip_smoke.MEMORY_REL_ERR
    assert sorted(rec["by_batch"]) == sorted(
        set(SMALL["batches"]) | {res["validate_batch"]})
    tr = rec["tracker"]
    assert tr["sample_us"] > 0 and tr["state_tensors"] > 0
    assert len(tr["blocks"]["on"]) == len(tr["blocks"]["off"]) >= 3
    assert np.isfinite(tr["smallnet_loss"])
    oom = rec["oom"]
    assert oom["failures"] == [] and oom["max_batch"] == res["max_batch"]
    assert oom["oom_batch"] == math.ceil(1.25 * res["max_batch"])
    for what in ("eager", "capture"):
        err = oom[what]["error"]
        assert err["cause"] == "OutOfMemoryError"
        bd = err["breakdown"]
        assert bd["params"] + bd["opt_state"] == oom["state_bytes"]
        assert any(r["name"] for r in err["top_buffers"][:10])
        kinds = {r["kind"] for r in err["top_buffers"]}
        assert {"param", "feed"} <= kinds or {"opt_state", "feed"} <= kinds
    assert (oom["graphed_captures"], oom["graphed_replays"]) == (1, 2)
    assert rec["serve"]["admission"]["error"] == 0
    assert rec["refusal"]["codes"] == ["rank-mismatch"]
    assert rec["serve"]["static_total_bytes"] > 0
