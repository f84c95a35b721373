"""The sharded run's collectives on the card: a gloo group of two rank
processes sharing it (each collective staged through pinned host memory,
counted by collective; bf16 gathered bit for bit), the MLP transpiled over
dp 2 there (eager under the gate's reason host_collective) against one
rank, the synchronized batch-norm windows of a small ResNet over dp 2
against one rank's, and a one-rank NCCL group whose collectives are
captured in CUDA graphs and replayed on new values.

Skipped without a CUDA device; on the card:
    python -m pytest --noconftest tests/test_torch_parallel_gpu.py
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import torch_group  # noqa: E402
import torch_parallel_nets as nets  # noqa: E402
import torch_parallel_phases as phases  # noqa: E402

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the collectives on the card need a CUDA device")


@pytest.mark.gpu
def test_host_staged_collectives_on_the_card(card, tmp_path):
    ranks, _ = torch_group.launch(
        WORKER, 2, [{"name": "c", "kind": "collectives"}], tmp_path,
        timeout=180)
    x = [np.arange(6, dtype=np.float32) + r for r in range(2)]
    for r, res in enumerate(ranks):
        c = res["c"]
        np.testing.assert_array_equal(c["all_reduce"], x[0] + x[1])
        np.testing.assert_array_equal(c["all_gather"], np.concatenate(x))
        np.testing.assert_array_equal(
            c["gather_bf16"], np.concatenate([np.arange(6) + 10 * q
                                              for q in range(2)]))
        np.testing.assert_array_equal(
            c["reduce_scatter"], (x[0] + x[1]).reshape(2, -1)[r:r + 1])
        np.testing.assert_array_equal(c["broadcast"], x[0])
        a, b, where, f32 = c["async"]
        np.testing.assert_array_equal(a, x[0] + x[1])
        np.testing.assert_array_equal(b, 2 * (x[0] + x[1]))
        assert where == "cuda" and f32
        assert c["staged"].get("all_reduce", 0) >= 3 and \
            c["staged"].get("all_gather", 0) >= 2


@pytest.mark.gpu
def test_sharded_mlp_on_the_card_matches_one_rank(card, tmp_path):
    import paddle_tpu_torch as pt
    main, startup, loss = nets.mlp(pt, {})
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    init = {n: scope.find_var(n).cpu().numpy() for n, v in
            startup.global_block().desc.vars.items() if v.persistable}
    feeds = nets.feeds("mlp", 3)
    want = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                   scope=scope, use_jit=False)[0])[0])
            for f in feeds]
    case = {"name": "m", "net": "mlp", "mesh": ((2,), ("dp",)),
            "init": init, "feeds": feeds, "device": "cuda"}
    ranks, _ = torch_group.launch(WORKER, 2, [case], tmp_path, timeout=180)
    for res in ranks:
        np.testing.assert_allclose(res["m"]["losses"], want, rtol=1e-5,
                                   atol=1e-6)
        assert res["m"]["staged"]
        assert res["m"]["eager"] == {"host_collective": 3}


@pytest.mark.gpu
def test_nccl_bucket_captured_in_a_graph(card, tmp_path):
    """On a one-rank NCCL group an all-reduce in place moves nothing, so a
    replay cannot tell it from no collective; an all-gather out of place
    copies, so its replay on new values shows the collective in the graph.
    The graphed sharded step posts its collectives at the warm-up and at
    the capture and none from the host on a replay, and its losses are the
    group-less graph's bit for bit."""
    ranks, _ = torch_group.launch(
        WORKER, 1, [{"name": "g", "kind": "nccl_graph"}], tmp_path,
        timeout=180, env={"PARALLEL_TEST_BACKEND": "nccl"})
    g = ranks[0]["g"]
    np.testing.assert_array_equal(g["replayed"],
                                  np.full(1024, 6.0, np.float32))
    np.testing.assert_array_equal(g["gathered"],
                                  np.full(1024, 9.0, np.float32))
    assert g["gate"] is None
    assert g["captures"] == 2 and g["replays"] >= 2 * 3, g
    assert g["calls"][0] > 0 and g["calls"][1] == g["calls"][0], g["calls"]
    assert g["calls"][2:] == [0, 0, 0], g["calls"]
    assert all(a == b for a, b in g["losses"]), g["losses"]


@pytest.mark.gpu
def test_nccl_across_two_cards_graphed(card, tmp_path):
    """The MLP transpiled over dp 2 on an NCCL group of two ranks, each on
    its own card, graphed: five steps on new global batches (a warm-up, a
    capture, three replays), the losses those of one device graphed on the
    same batches, which the replays reach only if their gradient
    all-reduces run inside the graph; replicated state bitwise across the
    ranks. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("an NCCL group across cards needs two of them")
    import paddle_tpu_torch as pt
    main, startup, loss = nets.mlp(pt, {})
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    init = {n: scope.find_var(n).cpu().numpy() for n, v in
            startup.global_block().desc.vars.items() if v.persistable}
    feeds = nets.feeds("mlp", 5, seed=2)
    want = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                   scope=scope)[0])[0]) for f in feeds]
    case = {"name": "n", "net": "mlp", "mesh": ((2,), ("dp",)),
            "init": init, "feeds": feeds, "device": "cuda"}
    ranks, _ = torch_group.launch(WORKER, 2, [case], tmp_path, timeout=180,
                                  env={"PARALLEL_TEST_BACKEND": "nccl"})
    for res in ranks:
        np.testing.assert_allclose(res["n"]["losses"], want, rtol=1e-5,
                                   atol=1e-6)
        assert res["n"]["graphs"]["captures"] == 1 and \
            res["n"]["graphs"]["replays"] >= 3, res["n"]["graphs"]
        assert not res["n"]["staged"] and not res["n"]["eager"].get(
            "host_collective"), res["n"]
    assert ranks[0]["n"]["digest"] == ranks[1]["n"]["digest"]


@pytest.mark.gpu
def test_synchronized_batch_norm_windows_on_the_card(card, tmp_path,
                                                     monkeypatch):
    """A small ResNet in O2 over dp 2 on the card (WINDOWS_DP): its stem's
    bn + relu window (K6's, taken as `batch_split`: channel sums
    all-reduced, then K5) and its conv -> bn -> relu windows (K4's sums
    all-reduced, then K5) against one rank's windows on the same global
    batch. The first two batch norms, whose inputs agree up to rounding:
    SavedMean, SavedVariance and the output Y within 1e-5 (relative L2;
    Y as mean |difference| over mean |Y|), f32 rounding, where statistics
    over one rank's half of the rows would be ~1e-2 off; the median over
    every batch norm's statistics within 1e-5 and each output within one
    bf16 ulp (bf16 differences grow with depth); the gradients at the
    floor of one rank against itself on the rows permuted; K4 and K5
    launched on each rank, the stem taken as K6's `batch_split`, K6
    launched by the one-rank run."""
    import chip_smoke
    import paddle_tpu_torch as pt

    def par_dir(phase):
        d = tmp_path / phase
        d.mkdir()
        return d
    monkeypatch.setattr(chip_smoke, "_par_dir", par_dir)
    # as the ranks run (chip_smoke._rank_main)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    report = {}
    chip_smoke.phase_train_dp(pt, report, dict(phases.WINDOWS_DP))
    rec = report["train_dp"]
    assert rec["bn_first_rel_max"] <= 1e-5
    assert rec["bn_stats_rel_median"] <= 1e-5
    assert rec["bn_outputs_rel_max"] <= 2.0 ** -8
    assert rec["grad_floor_ratio"] <= chip_smoke.DP_GRAD_FLOOR
    per_rank = rec["launches_per_rank_step"]
    assert per_rank.get("conv.stats_launches") and \
        per_rank.get("bn.apply_launches"), per_rank
    assert rec["bn_fallbacks_per_rank_step"].get(
        "fused_bn_act:batch_split", 0) >= 1
    assert rec["one_rank_launches"].get("bn.act_launches", 0) >= 1
