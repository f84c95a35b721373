"""Ops on a batch split over ranks, on a gloo group of 2 CPU processes
(tests/torch_group.py; workers tests/torch_parallel_worker.py `split`
cases: the program over dp 2 beside its one-rank run on the same rank,
from one startup state):

  * the random ops uniform_random_batch_size_like,
    gaussian_random_batch_size_like and nce (its negatives) draw the global
    batch's values and keep their rows, as dropout does: the values
    fetched (gathered) equal the one-rank run's bit for bit, and a step of
    SGD through nce's gradient (from the forward's own SampleLabels) gives
    the one-rank state within f32 rounding;
  * the training batch-norm window of a conv -> bn -> relu net (its conv
    3-channel, so the window is K6's): in O2 it takes K6's split form (on
    the CPU its plain version: this rank's channel sums, one all-reduce,
    the normalize from the global sums), whose statistics and loss equal
    the one-rank run's K6 window within f32 rounding; in f32 it falls back
    (kernel_dtype). Either way every window counts once: hits plus
    fallbacks equal the windows, and no `batch_split` fallback is left."""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
from pathlib import Path

import numpy as np
import pytest

import torch_group
import torch_parallel_nets as nets

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
MESH = ((2,), ("dp",))
CASES = {"random_ops": dict(net="random_ops"),
         "conv_bn_o2": dict(net="conv_bn", amp=True),
         "conv_bn_f32": dict(net="conv_bn")}
_RANKS = []


def _ranks(tmp_path_factory):
    if not _RANKS:
        cases = [dict(spec, name=n, kind="split", mesh=MESH,
                      feeds=nets.feeds(spec["net"], 2, seed=7))
                 for n, spec in CASES.items()]
        _RANKS.extend(torch_group.launch(
            WORKER, 2, cases, tmp_path_factory.mktemp("split"),
            timeout=150)[0])
    return _RANKS


def test_random_ops_draw_the_global_batch(tmp_path_factory):
    for r, res in enumerate(_ranks(tmp_path_factory)):
        got = res["random_ops"]
        for i, (a, b) in enumerate(zip(got["split"]["steps"],
                                       got["one"]["steps"])):
            # u, g and nce's cost: the one-rank draws, bit for bit
            for x, y in zip(a["fetch"][1:], b["fetch"][1:]):
                np.testing.assert_array_equal(x, y, err_msg=f"rank {r}")
            np.testing.assert_allclose(a["fetch"][0], b["fetch"][0],
                                       rtol=1e-6)
        for n, v in got["one"]["state"].items():
            np.testing.assert_allclose(got["split"]["state"][n], v,
                                       rtol=1e-5, atol=1e-7, err_msg=n)


def test_k6_split_plain_path_equals_one_rank(tmp_path_factory):
    """Step 1's SavedMean and SavedVariance (relative L2) within 1e-5 of
    the one-rank window's, its output Y within one bf16 ulp of its mean
    magnitude, and the loss within 1e-5."""
    for res in _ranks(tmp_path_factory):
        a = res["conv_bn_o2"]["split"]["steps"][0]["fetch"]
        b = res["conv_bn_o2"]["one"]["steps"][0]["fetch"]
        np.testing.assert_allclose(a[0], b[0], rtol=1e-5)
        for x, y in zip(a[1:3], b[1:3]):
            assert np.linalg.norm(x - y) <= 1e-5 * np.linalg.norm(y)
        assert np.abs(a[3] - b[3]).mean() <= 2.0 ** -8 * np.abs(b[3]).mean()


@pytest.mark.parametrize("name,want", [("conv_bn_o2", "hit"),
                                       ("conv_bn_f32", "kernel_dtype")])
def test_bn_window_counts_once(name, want, tmp_path_factory):
    for res in _ranks(tmp_path_factory):
        for form in ("split", "one"):
            got = res[name][form]
            for step in got["steps"]:
                hits = step["hits"].get("fused_bn_act", 0)
                falls = sum(n for k, n in step["fallbacks"].items()
                            if k.startswith("fused_bn_act:"))
                assert hits + falls == got["windows"] == 1, step
                assert "fused_bn_act:batch_split" not in step["fallbacks"]
                if want == "hit":
                    assert hits == 1
                else:
                    assert step["fallbacks"] == {f"fused_bn_act:{want}": 1}
