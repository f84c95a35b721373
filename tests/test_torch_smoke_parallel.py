"""chip_smoke.py's sharded phases rehearsed on the CPU at small widths
with their rank processes (this checkout's chip_smoke.py run with --rank,
gloo, the CPU): train_dp (a small ResNet in O2 transpiled over dp 2
against one rank on the same global batch, the replicated state bitwise
across ranks after every step, buckets posted), train_planned_lm (a small
f32 LM planned over (fsdp 2, tp 2) on 4 ranks against the one-rank LM
under the same plan, validate_plan_bytes, each rank's parameter bytes
against per_shard_param_bytes) and train_dlrm_sharded (a 1000-row table
row-sharded over fsdp 2 against the one-rank table); and the phases of
pipelines, experts and the elastic queue: train_pipeline_lm (a 2-layer
LM through PipelineTranspiler against the one-device LM), train_gpipe and
train_ep on one group of 4 rank processes (gpipe against
gpipe_reference; sparse_moe in forms (a) and (b) against one rank) and
train_elastic (the MLP fed by elastic_reader with a lease expired by the
injected clock). No kernel runs here (the phases hold the kernels'
launches only on the card), and train_dp_nccl needs NCCL:
tests/test_torch_parallel_gpu.py and the card run it."""

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
SMALL_PIPE = {"lm": {"batch": 4, "seqlen": 16, "n_layer": 2, "d_model": 32,
                     "n_head": 2, "vocab": 64, "lr": 1e-3},
              "microbatches": 2, "steps": 3, "device": "cpu"}
SMALL_PP_EP = {"device": "cpu", "world": 4,
               "gpipe": {"stages": 4, "microbatches": 3, "rows": 8, "d": 16,
                         "hidden": 32, "reps": 2},
               "ep": {"tokens": 64, "d": 16, "experts": 8, "hidden": 32,
                      "cf": 1.25, "world": 4, "lr": 0.02, "steps": 3}}
SMALL_ELASTIC = {"samples": 64, "task": 8, "batch": 8, "passes": 2,
                 "timeout_s": 60.0, "device": "cpu"}


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
    # the stem's window takes K6's split form: one hit, no fallback
    assert "fused_bn_act:batch_split" not in rec["bn_fallbacks_per_rank_step"]
    assert rec["bn_hits_per_rank_step"].get("fused_bn_act", 0) >= 1


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


def test_train_pipeline_lm_rehearsed():
    report = {}
    chip_smoke.phase_train_pipeline_lm(pt, report, SMALL_PIPE,
                                       places=[pt.CPUPlace()])
    rec = report["train_pipeline_lm"]
    assert len(rec["stages"]) == SMALL_PIPE["lm"]["n_layer"]
    assert max(rec["loss_rel"]) <= chip_smoke.LM_F32_LOSS_RTOL
    assert all(s["rel_l2"] <= s["bound"] for s in rec["stages"])
    # each microbatch through each stage forward and back, one update a
    # stage; one device: no boundary moved
    m, n = SMALL_PIPE["microbatches"], SMALL_PIPE["lm"]["n_layer"]
    assert rec["runs_per_step"] == {"fwd": m * n, "grad": m * n,
                                    "update": n}
    assert rec["boundary_moves"] == 0 and not rec["fails"]


def test_train_gpipe_and_ep_rehearsed():
    report = {}
    rec = chip_smoke.phase_train_pp_ep(pt, report, SMALL_PP_EP)
    g, ep = report["train_gpipe"], report["train_ep"]
    assert g["grad_rel_max"] <= chip_smoke.GPIPE_RTOL
    assert g["held_bytes"] * g["stages"] == g["stack_bytes"]
    assert g["bubble"] == 3 / 6
    for form in ("a", "b"):
        assert max(ep[form]["loss_rel"]) <= chip_smoke.EP_RTOL
    assert ep["held_expert_bytes"] * SMALL_PP_EP["world"] == \
        ep["expert_bytes"]
    # form (b) dispatches through its reduce-scatter and all-gather; form
    # (a) all-reduces the routed partial sum
    assert ep["b"]["collectives_per_step"].get("expert_dispatch")
    assert ep["a"]["collectives_per_step"].get("expert_combine")
    assert not rec["fails"]


def test_train_elastic_rehearsed():
    report = {}
    chip_smoke.phase_train_elastic(pt, report, SMALL_ELASTIC)
    rec = report["train_elastic"]
    n = SMALL_ELASTIC["samples"]
    assert rec["consumed"] == [n + SMALL_ELASTIC["task"], n]
    assert rec["requeued_samples"] == SMALL_ELASTIC["task"]
    assert not rec["fails"]
