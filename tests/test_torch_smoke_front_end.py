"""chip_smoke.py's training front-end phases rehearsed on the CPU at a
tiny size: `train_lm_recipe` (the recipe's LM, graphed bitwise eager,
the LR against the host's noam, the counter, the gauge, the clipped Adam
update against the host's), `train_optimizers` (Adam under ModelAverage:
the parameters and logits inside apply against the host's average,
restore bitwise) and `train_reader_layers` (a tiny classifier reading a
RecordIO file, the batches and losses against the fed path, EOF, the next
pass). The card is stood in for: the executor's place resolves to the
CPU, the gate answers as for a CUDA place, a capture records its body
and each replay runs it, the profiler is skipped. Also the host helpers
the phases hold the card to: ModelAverage's average and the reader's
shuffle order."""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import random
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import executor as E  # noqa: E402

TINY = {"batch": 2, "seqlen": 16, "n_layer": 2, "d_model": 32, "n_head": 4,
        "vocab": 64}


class _Replayed:
    """A captured graph stood in for: each replay runs the body."""

    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()

    def pool(self):
        return None


@pytest.fixture
def card(monkeypatch):
    monkeypatch.setattr(E, "place_device", lambda place: torch.device("cpu"))
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated",
                 "memory_reserved"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "_card_line", lambda: "cpu stand-in")
    monkeypatch.setattr(E, "capture_graph",
                        lambda body, pool=None, keep=False, generators=():
                        _Replayed(body))
    gate = E.Executor.graph_gate

    def as_on_a_card(self, program, feed, use_jit=None,
                     use_program_cache=True):
        dev, self.device = self.device, torch.device("cuda", 0)
        try:
            return gate(self, program, feed, use_jit, use_program_cache)
        finally:
            self.device = dev

    monkeypatch.setattr(E.Executor, "graph_gate", as_on_a_card)

    def profile(exe, main, feed, loss, scope, p50, card, witness,
                attempts=3, use_jit=None, expect=None, graph=None):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                use_jit=use_jit)
        return {"busy_ms": 1.0, "busy_share": 1.0 / p50,
                "launches": dict(expect or {}), "lost_records": {}}

    monkeypatch.setattr(chip_smoke, "_profile_step", profile)


def test_train_lm_recipe_rehearsed(card, monkeypatch):
    for name, steps in (("RECIPE_BITWISE_STEPS", 4), ("RECIPE_TURNS", 3),
                        ("GAUGE_TURNS", 2)):
        monkeypatch.setattr(chip_smoke, name, steps)
    report = {}
    launches = chip_smoke.phase_train_lm_recipe(pt, report, cfg=TINY)
    out = report["train_lm_recipe"]
    assert launches == chip_smoke.TRACE_LM
    assert out["lr_max_rel_err"] <= chip_smoke.LR_RTOL
    assert out["eager_step"]["update_rel_err"] <= chip_smoke.UPDATE_RTOL
    assert out["losses"][-1] < out["losses"][0]
    assert len(out["global_norms"]) == (chip_smoke.RECIPE_BITWISE_STEPS
                                        + chip_smoke.RECIPE_TURNS)


def test_train_optimizers_model_average_rehearsed(card, monkeypatch):
    # the phase holds the process's densify count to zero before it runs,
    # as the card's fresh smoke process has it: an earlier test of this
    # worker may have densified on purpose
    pt.telemetry.reset()
    monkeypatch.setattr(chip_smoke, "OPT_PASSES",
                        ("rmsprop", "adam_model_average"))
    monkeypatch.setattr(chip_smoke, "OPT_TIMED_STEPS", 2)
    report = {}
    launches = chip_smoke.phase_train_optimizers(pt, report, cfg=TINY)
    passes = report["train_optimizers"]["passes"]
    assert launches == {k: 2 * v for k, v in chip_smoke.TRACE_LM.items()}
    assert passes["adam_model_average"]["model_average"]["steps_averaged"] \
        == chip_smoke.OPT_BITWISE_STEPS + chip_smoke.OPT_TIMED_STEPS + 1
    assert passes["rmsprop"]["densified"] == 0


def test_train_reader_layers_rehearsed(card, monkeypatch):
    monkeypatch.setattr(pt.dataset.flowers, "_TRAIN_N", 40)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 8)

    def tiny(img, class_dim=1000):
        L = pt.layers
        h = L.conv2d(img, num_filters=4, filter_size=8, stride=8, act="relu")
        h = L.pool2d(h, pool_size=7, pool_type="avg", pool_stride=7)
        return L.fc(h, size=class_dim)

    report = {"train_feeder": {"per_step_p50_ms": 1.0, "wait_ms": 0.0}}
    with chip_smoke._kept_graphs():
        chip_smoke.phase_train_reader_layers(
            pt, None, None, types.SimpleNamespace(resnet50=tiny), report)
    out = report["train_reader_layers"]
    assert out["samples"] == 40 and len(out["losses"]) == 5
    assert np.isfinite(out["losses"]).all()


def test_model_average_host_is_the_ops():
    """model_average_host against ModelAverage's accumulators run by the
    port's executor over a window that rolls."""
    rng = np.random.RandomState(0)
    snaps = [{"w": rng.randn(3).astype(np.float32)} for _ in range(7)]
    for rate, lo, hi in ((1.0, 1, 1000), (0.5, 2, 3)):
        main = pt.Program()
        with pt.unique_name.guard(), pt.program_guard(main, pt.Program()):
            w = pt.layers.data(name="w", shape=[3], dtype="float32",
                               append_batch_size=False)
            avg = pt.optimizer.ModelAverage(
                rate, params_grads=[(w, None)], min_average_window=lo,
                max_average_window=hi)
        scope = pt.Scope()
        for n in ("sum_1", "sum_2", "sum_3"):
            scope.set_var(avg._get_accumulator(n, w).name,
                          torch.zeros(3))
        for n in ("num_accumulates", "old_num_accumulates", "num_updates"):
            scope.set_var(avg._get_accumulator(n, w).name,
                          torch.zeros(1, dtype=torch.int32))
        exe = pt.Executor(pt.CPUPlace())
        for s in snaps:
            exe.run(main, feed={"w": s["w"]}, scope=scope)
        acc = {n: scope.find_var(avg._get_accumulator(n, w).name).numpy()
               for n in ("sum_1", "sum_2", "sum_3", "num_accumulates",
                         "old_num_accumulates")}
        cnt = max(np.float32(acc["num_accumulates"][0]
                             + acc["old_num_accumulates"][0]), 1.0)
        want = (acc["sum_1"] + acc["sum_2"] + acc["sum_3"]) / cnt
        got = chip_smoke.model_average_host(snaps, rate, lo, hi)["w"]
        np.testing.assert_array_equal(got, want)


def test_layer_shuffle_order_is_the_shuffle_layers():
    samples = [(np.full(2, i, np.float32),) for i in range(23)]

    class _Source:
        source = staticmethod(lambda: iter(samples))
        lod_levels = [0]

    random.seed(3)
    want = chip_smoke.layer_shuffle_order(samples, 8)
    r = pt.layers.shuffle(_Source(), buffer_size=8)
    random.seed(3)
    got = list(r.source())
    assert [int(s[0][0]) for s in got] == [int(s[0][0]) for s in want]
    assert sorted(int(s[0][0]) for s in got) == list(range(23))
