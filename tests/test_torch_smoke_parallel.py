"""chip_smoke.py's sharded phases rehearsed on the CPU at small widths
with their rank processes (this checkout's chip_smoke.py run with --rank,
gloo, the CPU): train_dp (a small ResNet in O2 transpiled over dp 2
against one rank on the same global batch, the replicated state bitwise
across ranks after every step, buckets posted), train_planned_lm (a small
f32 LM planned over (fsdp 2, tp 2) on 4 ranks against the one-rank LM
under the same plan, validate_plan_bytes, each rank's parameter bytes
against per_shard_param_bytes) and train_dlrm_sharded (a 1000-row table
row-sharded over fsdp 2 against the one-rank table). No kernel runs here
(the phases hold the kernels' launches only on the card), and
train_dp_nccl needs NCCL: tests/test_torch_parallel_gpu.py and the card
run it."""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402

SMALL_DP = {"net": "resnet50", "depth": 8, "world": 2, "batch": 8,
            "img": 8, "classes": 4, "device": "cpu"}
SMALL_LM = {"lm": {"batch": 4, "seqlen": 16, "n_layer": 1, "d_model": 32,
                   "n_head": 2, "vocab": 64, "lr": 1e-3},
            "world": 4, "mesh": ((2, 2), ("fsdp", "tp")), "device": "cpu"}
SMALL_DLRM = {"rows": 1000, "world": 2, "device": "cpu"}


@pytest.fixture(autouse=True)
def _scratch(tmp_path, monkeypatch):
    """The phases' rank directories under this test's tmp_path."""
    def par_dir(phase):
        d = tmp_path / phase
        d.mkdir()
        return d
    monkeypatch.setattr(chip_smoke, "_par_dir", par_dir)


def test_train_dp_rehearsed():
    report = {}
    totals = chip_smoke.phase_train_dp(pt, report, SMALL_DP)
    rec = report["train_dp"]
    assert totals == {} and rec["buckets_per_step"] >= 1
    assert len(rec["losses"]) == chip_smoke.PAR_STEPS
    assert rec["step1_loss_rel"] <= chip_smoke.DP_LOSS_RTOL
    # the synchronized statistics at f32 rounding (1.1e-7 measured here)
    assert rec["bn_stats_rel_max"] <= 1e-5
    assert rec["bn_fallbacks_per_rank_step"].get(
        "fused_bn_act:batch_split", 0) >= 1


def test_train_planned_lm_rehearsed():
    report = {}
    chip_smoke.phase_train_planned_lm(pt, report, SMALL_LM)
    rec = report["train_planned_lm"]
    assert set(rec["roles"].values()) >= {"embedding", "attn_qkv",
                                          "attn_out", "ffn_up", "ffn_down",
                                          "lm_head", "norm", "bias"}
    assert len(set(rec["held_bytes"])) == 1 and \
        rec["held_bytes"][0] < rec["plan_total_bytes"]
    assert max(rec["loss_rel"]) <= chip_smoke.LM_F32_LOSS_RTOL


def test_train_dlrm_sharded_rehearsed():
    report = {}
    chip_smoke.phase_train_dlrm_sharded(pt, report, SMALL_DLRM)
    rec = report["train_dlrm_sharded"]
    assert rec["table_shard_shape"] == (500, chip_smoke.DLRM["dim"])
    assert rec["table_rel_err"] <= chip_smoke.DLRM_SHARDED_RTOL
