"""The sharded run's collectives on the card: a gloo group of two rank
processes sharing it (each collective staged through pinned host memory,
counted by collective; bf16 gathered bit for bit), the MLP transpiled over
dp 2 there (eager under the gate's reason host_collective) against one
rank, the synchronized batch-norm windows of a small ResNet over dp 2
against one rank's, and a one-rank NCCL group whose collectives are
captured in CUDA graphs and replayed on new values. K6's split form (the
batch-norm window of a batch split over ranks): its two launches bit for
bit K6's on one rank at ResNet-50's stem and at a K4 window's shape, and
over dp 2 its statistics within 1e-5 of one rank's.

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
    bn + relu window (K6's split form: its statistics launch, the sums
    all-reduced, its normalize launch) and its conv -> bn -> relu windows
    (K4's sums
    all-reduced, then K5) against one rank's windows on the same global
    batch. The first two batch norms, whose inputs agree up to rounding:
    SavedMean, SavedVariance and the output Y within 1e-5 (relative L2;
    Y as mean |difference| over mean |Y|), f32 rounding, where statistics
    over one rank's half of the rows would be ~1e-2 off; the median over
    every batch norm's statistics within 1e-5 and each output within one
    bf16 ulp (bf16 differences grow with depth); the gradients at the
    floor of one rank against itself on the rows permuted; K4 and K5
    launched on each rank, the stem by K6's split form in pairs of
    launches, counted as one K6 hit and no `batch_split` fallback, K6
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
    assert "fused_bn_act:batch_split" not in \
        rec["bn_fallbacks_per_rank_step"]
    split = rec["k6_split_per_rank_step"]
    assert split.get("sums", 0) >= 1 and split["sums"] == split["apply"]
    assert rec["bn_hits_per_rank_step"].get("fused_bn_act", 0) >= 1
    assert per_rank.get("bn.act_launches") == 2 * split["sums"]
    assert rec["one_rank_launches"].get("bn.act_launches", 0) >= 1


# K6's split form at ResNet-50's stem (batch 32: [401408, 64], relu) and
# at the shapes of two conv -> bn windows K4 takes
K6_SPLIT_SHAPES = [(401408, 64, "relu"), (100352, 256, None),
                   (25088, 512, "relu")]


@pytest.mark.gpu
@pytest.mark.parametrize("m,c,act", K6_SPLIT_SHAPES)
def test_k6_split_form_is_k6_on_one_rank(card, m, c, act):
    """The statistics launch bit for bit bn_act_sums_in_order (K6's order
    at its plan); the normalize launch from those sums over M rows bit for
    bit K6 whole (ybn, yact, mean, var); ybn within one bf16 ulp of the
    plain apply; a repeated call bitwise; one launch counted each."""
    from paddle_tpu_torch.ops import bn_cuda
    gen = torch.Generator().manual_seed(m + c)
    x = (torch.randn((m, c), generator=gen) * 2).to(torch.bfloat16).cuda()
    scale = (1 + 0.1 * torch.randn(c, generator=gen)).cuda()
    bias = (0.1 * torch.randn(c, generator=gen)).cuda()
    bn_cuda.COUNTERS.reset()
    sums = bn_cuda.bn_act_sums(x)
    assert torch.equal(sums, bn_cuda.bn_act_sums(x))
    assert torch.equal(sums, bn_cuda.bn_act_sums_in_order(
        x, *bn_cuda.launch_plan(x, None)))
    got = bn_cuda.bn_act_apply(x, sums, m, scale, bias, 1e-5, act)
    again = bn_cuda.bn_act_apply(x, sums, m, scale, bias, 1e-5, act)
    want = bn_cuda.bn_act(x, scale, bias, 1e-5, act)
    for a, b, w in zip(got, again, want):
        assert (a is None) == (w is None)
        if a is not None:
            assert torch.equal(a, b) and torch.equal(a, w)
    plain, _ = bn_cuda.bn_apply_reference(x, scale, bias, got[2], got[3],
                                          1e-5)
    ulp = torch.finfo(torch.bfloat16).eps * plain.float().abs().clamp_min(
        2.0 ** -126)
    assert ((got[0].float() - plain.float()).abs() <= ulp + 1e-6).all()
    assert bn_cuda.COUNTERS.split_launches == {"sums": 2, "apply": 2}
    assert bn_cuda.COUNTERS.act_launches == 5


@pytest.mark.gpu
def test_k6_split_dp2_statistics_match_one_rank(card, tmp_path):
    """A bn -> relu window in O2 on the fed images cast to bf16 (the
    `conv_bn` net's `bare` form: the window's input the same bits on every
    rank and on one) over dp 2 on a gloo group of two processes sharing the
    card: it takes K6's split form, one hit and no fallback, and step 1's
    SavedMean and SavedVariance are within 1e-5 (relative L2) of the
    one-rank K6 window's."""
    case = dict(name="k6", kind="split", net="conv_bn", amp=True, bare=True,
                mesh=((2,), ("dp",)), device="cuda",
                feeds=nets.feeds("conv_bn", 2, seed=7))
    ranks, _ = torch_group.launch(WORKER, 2, [case], tmp_path, timeout=180)
    for res in ranks:
        split, one = res["k6"]["split"], res["k6"]["one"]
        a, b = split["steps"][0]["fetch"], one["steps"][0]["fetch"]
        for x, y in zip(a[1:3], b[1:3]):
            assert np.linalg.norm(x - y) <= 1e-5 * np.linalg.norm(y), \
                np.linalg.norm(x - y) / np.linalg.norm(y)
        for step in split["steps"]:
            assert step["k6"] == (2, {"sums": 1, "apply": 1}), step["k6"]
            assert step["hits"] == {"fused_bn_act": 1} and \
                not step["fallbacks"], step
        assert one["steps"][0]["k6"] == (1, {})
