"""chip_smoke.py's phase `observe` rehearsed on the CPU at a small size: a
CIFAR ResNet (depth 8, 32x32, batch 4) in place of ResNet-50 and a
2-layer LM (d_model 32, T 16) in place of bench.py's, the card stood in
for (the executor's place resolves to the CPU, the gate answers as for a
CUDA place, a capture runs nothing and each replay runs its body, the
allocator reads 0, a graph lists no kernel node, kernel timings are host
clocks). The phase's control flow and checks run: the probed, audited,
sampled graphed steps with the flight recorder, the step log and tracing
on, the two graphs of the signature, the dynamics rows against the host
recomputation, T1's plain version held on every probe, the plane on and
off in turns; the poisoned LM step attributed to the weight's first
reader, the eager scan agreeing, the scope bitwise, the crash report read
back; the exports parsed; the costs. No kernel runs here: the card holds
the launches."""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import dynamics, inspector, telemetry, tracing  # noqa: E402
from paddle_tpu_torch import executor as E  # noqa: E402
from paddle_tpu_torch.ops import (attention_cuda, bn_cuda, conv_cuda,  # noqa: E402
                                  stats_cuda)

import torch_standin  # noqa: E402

SMALL = dict(chip_smoke.OBSERVE, net="cifar", depth=8, img=32, classes=10,
             batch=4, steps=8, period=4, turns=2, turn_steps=2,
             lm={"batch": 2, "seqlen": 16, "n_layer": 2, "d_model": 32,
                 "n_head": 2, "vocab": 64, "lr": 1e-3},
             smallnet_batch=4, host_reps=20, sample_reps=5, device="cpu")


@pytest.fixture
def card(monkeypatch, tmp_path):
    monkeypatch.setattr(E, "place_device", lambda place: torch.device("cpu"))
    torch_standin.graphed(monkeypatch)
    monkeypatch.setattr(chip_smoke, "_kept_graphs",
                        lambda: __import__("contextlib").nullcontext())
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated",
                 "memory_reserved"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "_card_line", lambda: "cpu stand-in")
    monkeypatch.setattr(chip_smoke, "_graph_launches", lambda graph: {})
    monkeypatch.setattr(chip_smoke, "_device_ms", lambda fn, reps=20: (
        fn(), 1e-3)[1])
    monkeypatch.setattr(chip_smoke, "_eager_ms", lambda fn, reps=10: (
        fn(), 2e-3)[1])
    monkeypatch.setattr(chip_smoke, "_observe_dir", lambda: tmp_path)
    plain = stats_cuda.tensor_stats

    def counted(x):
        # the card's launch, stood in for by the plain version, counted
        stats_cuda.COUNTERS.launches += 1
        return plain(x)
    monkeypatch.setattr(stats_cuda, "tensor_stats", counted)
    yield tmp_path
    tracing.reset()
    telemetry.disable_step_log()
    inspector.disable_flight_recorder()
    dynamics.reset()


def test_observe_phase_rehearsed(card):
    report = {}
    t1, launches = chip_smoke.phase_observe(pt, conv_cuda, bn_cuda,
                                            attention_cuda, report, SMALL)
    rec = report["observe"]
    a = rec["resnet50_o2"]
    assert a["graphs"] == 2 and a["steps"] == SMALL["steps"]
    assert a["run_events"] == SMALL["steps"]
    assert a["dynamics_rows"] > 0 and a["dynamics_max_rel_err"] <= \
        chip_smoke.DYN_RTOL
    assert a["t1_held"] == a["probes"] > a["grad_probes"] > 0
    assert a["t1_max_abs_err"] == 0.0       # the plain version on the CPU
    assert a["prestep_copy_bytes"] == 0
    assert len(a["blocks"]["on"]) == len(a["blocks"]["off"]) == \
        SMALL["turns"]
    b = rec["lm_o2"]
    assert b["named"][0] == b["first_reader"][0]
    assert b["replays"] <= b["replay_bound"]
    assert b["eager_named"] == b["named"][1:]
    assert "program" in b["crash_report_keys"]
    assert rec["exports"]["trace_step_spans"] >= SMALL["steps"]
    c = rec["costs"]
    assert c["plane_off_us"] > 0 and c["memory_hook_us"] > 0
    assert t1["name"] == "tensor_stats" and t1["route"] == "triton"
    assert t1["bound_by"] == "bytes" and t1["library_ms"] is None
    assert t1["launches"] == t1["launches_by_path"]["observe"] > 0
    for f in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
        assert f in t1
    assert (card / "steps.jsonl").exists()
    assert (card / "crash_lm.json").exists()
