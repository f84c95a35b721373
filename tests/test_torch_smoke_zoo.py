"""chip_smoke.py's vision and detection phases rehearsed on the CPU at a
small size: `train_zoo` (alexnet, googlenet and smallnet graphed bitwise
eager, the losses falling), `serve_zoo` (each bucket's first replay
bitwise eager), `train_ssd` (the MobileNet-SSD's whole step, matching and
mining included, graphed bitwise eager) and `serve_ssd` (detection_output
served, its counts against the executor's LoD, the detection_map op eager
under host_metric with its host reads counted, against DetectionMAP's
arithmetic). The card is stood in for as in test_torch_smoke_front_end:
the place resolves to the CPU, the gate answers as for a CUDA place, a
capture records its body and each replay runs it; the profiler and the
kernel counts are left out (no kernel runs here). Also the launches the
port's gates give each path at the card's full sizes, held to the
smoke's ZOO_LAUNCHES, and the SSD's prior count."""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import executor as E  # noqa: E402

from test_torch_smoke_front_end import card  # noqa: E402,F401

SMALL_ZOO = {"alexnet": dict(chip_smoke.ZOO["alexnet"], img=63, classes=10,
                             batch=1, lr=1e-4),
             "googlenet": dict(chip_smoke.ZOO["googlenet"], img=64,
                               classes=10, batch=1, lr=1e-4),
             "smallnet": dict(chip_smoke.ZOO["smallnet"], batch=4, lr=1e-3)}
# train_zoo's steps in turns, rehearsed: one graphed and one eager step
# after the three held bitwise (the card runs ZOO_TURNS)
SMALL_ZOO_TURNS = 1
SMALL_SSD = dict(chip_smoke.SSD, img=64, batch=4, scale=0.125, classes=5)


@pytest.fixture
def no_kernels(card, monkeypatch):
    """No kernel launches here: the paths expect none, and the traces are
    not taken; the engines' pinned staging buffers are plain ones."""
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self, *a, **k: self)
    monkeypatch.setattr(chip_smoke, "path_launches", lambda name, t: {})
    monkeypatch.setattr(
        chip_smoke, "_trace_replays",
        lambda engine, key, reqs, per_run, what, attempts=3, graph=None:
        {k: v * len(reqs) for k, v in per_run.items()})

    def profile(exe, main, feed, loss, scope, p50, card, witness,
                attempts=3, use_jit=None, expect=None, graph=None):
        # a replay whose trace lost records is profiled again, up to
        # `attempts` times: the stand-in always takes them all
        for _ in range(attempts if graph is not None else 1):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    use_jit=use_jit)
        return {"busy_ms": 1.0, "busy_share": 1.0 / p50,
                "busy_lower_bound": False, "by_kernel": {},
                "launches": dict(expect or {}), "lost_records": {}}
    monkeypatch.setattr(chip_smoke, "_profile_step", profile)

    class _NoEvents:
        def events(self):
            return []

    @contextlib.contextmanager
    def profiled():
        yield _NoEvents()
    monkeypatch.setattr(chip_smoke, "_profiled", profiled)


def test_train_zoo_rehearsed(no_kernels, monkeypatch):
    monkeypatch.setattr(chip_smoke, "ZOO", SMALL_ZOO)
    monkeypatch.setattr(chip_smoke, "ZOO_TURNS", SMALL_ZOO_TURNS)
    report = {}
    assert chip_smoke.phase_train_zoo(pt, report) == {}
    for name, rec in report["train_zoo"].items():
        assert len(rec["losses"]) == chip_smoke.ZOO_BITWISE_STEPS + \
            chip_smoke.ZOO_TURNS
        assert rec["gate"] is None and rec["losses"][-1] < rec["losses"][0]


def test_serve_zoo_rehearsed(no_kernels, monkeypatch):
    monkeypatch.setattr(chip_smoke, "ZOO", SMALL_ZOO)
    from paddle_tpu_torch.ops import conv_cuda
    report = {}
    chip_smoke.phase_serve_zoo(pt, conv_cuda, report)
    assert set(report["serve_zoo"]) == set(chip_smoke.ZOO_SERVED)


def test_train_and_serve_ssd_rehearsed(no_kernels, monkeypatch):
    monkeypatch.setattr(chip_smoke, "SSD", SMALL_SSD)
    monkeypatch.setattr(chip_smoke, "SSD_SERVE_BATCH", 4)
    from paddle_tpu_torch.ops import conv_cuda
    report = {}
    launches, scope, det, out = chip_smoke.phase_train_ssd(pt, report)
    rec = report["train_ssd"]
    assert launches == {} and rec["gate"] is None
    assert rec["padded_boxes"] == 8
    chip_smoke.phase_serve_ssd(pt, conv_cuda, scope, det, out, report)
    served = report["serve_ssd"]
    assert served["host_syncs"] == {
        "detection_map": chip_smoke.SSD_MAP_BATCHES}
    assert len(served["batch_maps"]) == chip_smoke.SSD_MAP_BATCHES


@pytest.mark.parametrize("name", sorted(chip_smoke.ZOO) + ["ssd"])
def test_full_size_launches_are_the_smokes(name):
    """The gates' launches a step at the card's full sizes, by
    zoo_kernel_shapes on meta tensors, are ZOO_LAUNCHES[name]."""
    if name == "ssd":
        main, batch = chip_smoke.ssd_programs(pt, chip_smoke.SSD)[0], \
            chip_smoke.SSD["batch"]
    else:
        cfg = chip_smoke.ZOO[name]
        main, batch = chip_smoke.zoo_train_net(pt, cfg)[0], cfg["batch"]
    tables, refused = chip_smoke.zoo_kernel_shapes(main, batch)
    assert chip_smoke.path_launches(name, tables) == \
        chip_smoke.ZOO_LAUNCHES[name]
    assert ("conv2d", "channels") in refused


def test_ssd_served_convs_on_k1():
    """The served SSD's bucket-16 request sends K1 the 21 pointwise and
    extra convs (their inference batch norms folded) and the 6 loc heads:
    the 27 shapes kernel_zoo holds for serve_ssd."""
    from paddle_tpu_torch.ops import conv_cuda
    det = chip_smoke.ssd_programs(pt, chip_smoke.SSD)[4]
    convs = chip_smoke._eligible_convs(conv_cuda, det,
                                       chip_smoke.SSD_SERVE_BATCH)
    assert len(convs) == 27
    assert all(x[0] == chip_smoke.SSD_SERVE_BATCH for x, *_ in convs)


def test_ssd_priors_and_batches():
    """The full-size SSD's six maps (19x19 down to 1x1) hold 2278 priors;
    a synthetic batch has 1..8 boxes an image inside the unit square."""
    main = chip_smoke.ssd_programs(pt, chip_smoke.SSD)[0]
    assert chip_smoke._prior_count(main) == 19 * 19 * 4 + \
        (10 * 10 + 5 * 5 + 3 * 3 + 2 * 2 + 1) * 6 == 2278
    feed, boxes, labels = chip_smoke.ssd_batch(
        np.random.default_rng(0), pt.LoDTensor, 6, dict(chip_smoke.SSD,
                                                        img=8))
    assert all(1 <= len(b) <= 8 for b in boxes)
    flat = feed["gt_box"].array()
    assert (flat[:, :2] < flat[:, 2:]).all() and (flat >= 0).all() and \
        (flat <= 1).all()
    assert feed["gt_label"].array().min() >= 1
    assert E._bucket_len(8) == 8
