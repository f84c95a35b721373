"""The port's telemetry exports and the executor's step telemetry against
the JAX package's, on the CPU:

  * `prometheus_text` is identical for the same observations;
    `_merge_snapshots` is equal; `snapshot(reduce=True)` over a two-rank
    gloo group (tests/torch_group.py, tests/torch_telemetry_worker.py)
    equals the sum of the ranks' snapshots.
  * The JSONL step log round-trips (a torn last line skipped); the
    chrome-trace exports of telemetry and tracing and tracing's JSONL
    export have the reference's structure.
  * The executor's `run` events and its executor_* series are the same on
    the same eager runs; on the graphed path (the card's graph stood in
    for: tests/torch_standin.py) a signature's warm-up and capture are
    misses, the capture logs `compile`, later runs are hits, a new batch
    size logs one `cache_miss` (the reference's retrace event) with the
    new signature, and tracing records a `step` span a run with a
    `compile` child on the capture.
  * `pprint_program` and `draw_program` give identical text.
  * The memory gauges, published when read, equal a full sample after the
    run; the per-run hook touches no gauge.
  * The benchmark and record_ops flags."""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import debugger as jdebugger
from paddle_tpu import executor as jexecutor
from paddle_tpu import telemetry as jtelemetry
from paddle_tpu import tracing as jtracing
import paddle_tpu_torch as pt
from paddle_tpu_torch import debugger, memory, telemetry, tracing
from paddle_tpu_torch import executor as E

import torch_group
import torch_standin
import torch_telemetry_worker


@pytest.fixture(autouse=True)
def _keep_jax_op_census():
    """The JAX executor's op census (executor._RECORDED_OPS) gets back the
    types it had before the test: the parity runs here execute reference
    programs, and tests/test_zz_op_coverage.py gates the census of the
    reference's own tests."""
    before = set(jexecutor._RECORDED_OPS)
    yield
    jexecutor._RECORDED_OPS.intersection_update(before)


HERE = Path(__file__).resolve().parent


@pytest.fixture(autouse=True)
def _fresh():
    for t in (telemetry, jtelemetry):
        t.reset()
    yield
    for t in (telemetry, jtelemetry):
        t.disable_step_log()
        t.reset()
    tracing.reset()
    jtracing.reset()


def _observe(t):
    t.counter("req_total", "requests served", labels=("code", "path")
              ).labels(code="200", path='/a"b\\c').inc(3)
    t.counter("req_total", "requests served", labels=("code", "path")
              ).labels(code="500", path="/a").inc()
    t.counter("plain_total").inc(2.5)
    t.gauge("depth", "queue depth", labels=("q",)).labels(q="x").set(7)
    t.gauge("ratio").set(0.125)
    h = t.histogram("lat_seconds", "latency", labels=("phase",))
    for v in (1e-7, 3e-5, 0.02, 0.02, 5.0, 1e4):
        h.labels(phase="run").observe(v)
    t.histogram("small", buckets=(0.1, 1.0)).observe(0.5)


def test_prometheus_text_is_identical():
    _observe(telemetry)
    _observe(jtelemetry)
    text = telemetry.prometheus_text()
    assert text == jtelemetry.prometheus_text()
    assert telemetry.snapshot() == jtelemetry.snapshot()
    for line in text.splitlines():
        if line.startswith("#"):
            assert line.split()[1] in ("HELP", "TYPE")
            continue
        metric, val = line.rsplit(" ", 1)
        float("inf" if val == "+Inf" else val)
        assert metric.count("{") == metric.count("}") <= 1


def test_merge_snapshots_is_equal():
    snaps = []
    for k in range(3):
        telemetry.reset()
        _observe(telemetry)
        telemetry.counter("only_some", labels=("k",)).labels(k=k).inc(k)
        snaps.append(telemetry.snapshot())
    snaps[2]["histograms"]["small"][""]["buckets"] = [0.2, 1.0]  # skew
    assert telemetry._merge_snapshots(snaps) == \
        jtelemetry._merge_snapshots(snaps)


def test_reduced_snapshot_over_two_ranks_is_the_sum(tmp_path):
    out, _tails = torch_group.launch(
        str(HERE / "torch_telemetry_worker.py"), 2, [], tmp_path,
        timeout=240)
    want = telemetry._merge_snapshots([r["local"] for r in out])
    assert out[0]["reduced"] == out[1]["reduced"] == want
    assert want["hosts"] == 2
    assert want["counters"]["w_total"] == {"k=a": 3.0, "k=r0": 1.0,
                                           "k=r1": 1.0}
    assert want["gauges"]["w_depth"][""] == 30.0
    assert want["histograms"]["w_seconds"][""]["count"] == 6
    # one process: the local series
    telemetry.reset()
    torch_telemetry_worker.observe(telemetry, 0)
    assert telemetry.snapshot(reduce=True) == telemetry._merge_snapshots(
        [telemetry.snapshot()])


def test_step_log_round_trips(tmp_path):
    path = str(tmp_path / "steps.jsonl")
    telemetry.enable_step_log(path)
    assert telemetry.step_log_path() == path
    for i in range(3):
        telemetry.log_event("run", step=i, mode="graph", arr=[1, 2])
    telemetry.disable_step_log()
    with open(path, "a") as f:
        f.write('{"kind": "run", "torn')
    recs = telemetry.read_step_log(path)
    assert recs == json.loads(json.dumps(telemetry.recent_events()))
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all({"ts", "mono", "host", "kind"} <= set(r) for r in recs)
    assert jtelemetry.read_step_log(path) == recs


def _events(t):
    t.log_event("run", seconds=0.01, mode="graph", cache="hit",
                signature=[["x", "(2,)", "float32"]], obj=object())
    t.log_event("compile", seconds=0.5, cause="first_compile")
    return t.recent_events()


def test_chrome_trace_exports_have_the_reference_structure(tmp_path):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    telemetry.export_chrome_trace(a, _events(telemetry))
    jtelemetry.export_chrome_trace(b, _events(jtelemetry))
    got, want = json.load(open(a)), json.load(open(b))
    assert set(got) == set(want)
    step = [e for e in want["traceEvents"] if e.get("cat") == "step"]
    assert len(got["traceEvents"]) == len(step) == 2
    for g, w in zip(got["traceEvents"], step):
        assert set(g) == set(w)
        assert {k: g[k] for k in ("name", "ph", "tid", "cat", "dur")} == \
            {k: w[k] for k in ("name", "ph", "tid", "cat", "dur")}
        assert set(g["args"]) == set(w["args"])

    for tr in (tracing, jtracing):
        tr.reset()
        tr.enable()
        with tr.span("request", route="/a"):
            with tr.span("inner"):
                pass
        tr.record_span("step", 1.0, 1.5, attrs={"mode": "graph"})
    c, d = str(tmp_path / "c.json"), str(tmp_path / "d.json")
    assert tracing.export_chrome_trace(c) == jtracing.export_chrome_trace(d)
    got, want = json.load(open(c)), json.load(open(d))
    assert [(e["name"], e["ph"], e["tid"], sorted(e["args"]))
            for e in got["traceEvents"]] == \
        [(e["name"], e["ph"], e["tid"], sorted(e["args"]))
         for e in want["traceEvents"]]
    e, f = str(tmp_path / "e.jsonl"), str(tmp_path / "f.jsonl")
    assert tracing.export_jsonl(e) == jtracing.export_jsonl(f) == 3
    assert [sorted(json.loads(ln)) for ln in open(e)] == \
        [sorted(json.loads(ln)) for ln in open(f)]


def test_trace_jsonl_sink(tmp_path):
    path = str(tmp_path / "live.jsonl")
    tracing.enable(jsonl=path)
    with tracing.span("a"):
        assert tracing.current_span().name == "a"
    assert tracing.current_span().name == ""
    assert [json.loads(ln)["name"] for ln in open(path)] == ["a"]


# --- the executor's step telemetry ------------------------------------------

def _net(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[4], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="float32")
        pred = fl.layers.fc(input=fl.layers.fc(input=x, size=8, act="relu"),
                            size=1)
        loss = fl.layers.mean(fl.layers.square_error_cost(pred, y))
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _feed(n):
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((n, 4)).astype("float32"),
            "y": rng.standard_normal((n, 1)).astype("float32")}


RUN_FIELDS = ("kind", "mode", "cache", "donated", "feeds", "fetches")


def _by_value(series):
    """A family's series keyed by their labels less the program label (the
    packages number their programs differently)."""
    return sorted((",".join(p for p in k.split(",")
                            if not p.startswith("program=")), v)
                  for k, v in series.items())


def test_eager_run_events_and_series_match():
    out = []
    for fl, t in ((pt, telemetry), (jfluid, jtelemetry)):
        main, startup, loss = _net(fl)
        exe = fl.Executor(fl.CPUPlace())
        exe.run(startup, use_jit=False)
        for n in (8, 8, 16):
            exe.run(main, feed=_feed(n), fetch_list=[loss], use_jit=False)
        runs = [tuple(e.get(k) for k in RUN_FIELDS)
                for e in t.recent_events() if e["kind"] == "run"]
        snap = t.snapshot()
        out.append((runs, {n: _by_value(snap["counters"].get(n, {}))
                           for n in ("executor_runs_total",
                                     "executor_steps_total",
                                     "optimizer_steps_total",
                                     "executor_compiles_total",
                                     "executor_cache_misses_total")},
                    [e["kind"] for e in t.recent_events()],
                    {k: v["count"] for k, v in
                     snap["histograms"]["executor_run_seconds"].items()}))
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1]
    assert [k for k in out[0][2] if k in ("compile", "cache_miss")] == []
    assert sorted(out[0][3].values()) == sorted(out[1][3].values())
    assert telemetry.read_gauge("executor_last_step_seconds") > 0


def test_graphed_runs_miss_capture_hit_and_retrace(monkeypatch, tmp_path):
    torch_standin.graphed(monkeypatch)
    log = str(tmp_path / "steps.jsonl")
    telemetry.enable_step_log(log)
    tracing.enable()
    main, startup, loss = _net(pt)
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup)
    for n in (8, 8, 8, 16):
        exe.run(main, feed=_feed(n), fetch_list=[loss])
    evs = [e for e in telemetry.recent_events()
           if e.get("program") == telemetry.program_label(main)]
    kinds = [(e["kind"], e.get("cache")) for e in evs]
    assert kinds == [("run", "miss"), ("compile", None), ("run", "miss"),
                     ("run", "hit"), ("cache_miss", None), ("run", "miss")]
    comp = evs[1]
    assert comp["cause"] == "first_compile" and comp["seconds"] >= 0
    assert ["x", "(8, 4)", "float32"] in comp["signature"]
    miss = evs[4]
    assert ["x", "(16, 4)", "float32"] in miss["signature"]
    assert sorted(miss["changed"]) == [["x", "(16, 4)", "float32"],
                                       ["y", "(16, 1)", "float32"]]
    label = f"place=CPUPlace:0,program={telemetry.program_label(main)}"
    snap = telemetry.snapshot()["counters"]
    assert snap["executor_compiles_total"][label] == 1
    assert snap["executor_cache_hits_total"][label] == 1
    assert snap["executor_cache_misses_total"][label] == 1
    assert snap["executor_runs_total"][
        f"mode=graph,{label}"] == 4
    steps = tracing.recent_spans(name="step")
    assert len(steps) == 5          # the startup's and four steps
    telemetry.disable_step_log()
    recs = [r for r in telemetry.read_step_log(log) if r["kind"] == "run"]
    assert [r["mode"] for r in recs] == ["eager"] + ["graph"] * 4


def test_pprint_and_draw_program_are_identical(tmp_path):
    main, _, _ = _net(pt)
    jmain, _, _ = _net(jfluid)
    a, b = [], []
    debugger.pprint_program(main, print_fn=a.append)
    jdebugger.pprint_program(jmain, print_fn=b.append)
    assert a == b and any("sgd(" in ln for ln in a)
    assert debugger.draw_program(main, path=str(tmp_path / "p.dot"),
                                 render=False) == \
        jdebugger.draw_program(jmain, render=False)
    assert (tmp_path / "p.dot").exists()


# --- the memory gauges, read lazily ------------------------------------------

def test_memory_gauges_read_lazily_equal_the_per_run_sample():
    main, startup, loss = _net(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    memory.reset()
    telemetry.reset()
    feed = _feed(8)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    # the hook kept numbers and touched no gauge
    assert memory.tracker()._pending is not None
    assert "hbm_bytes_in_use" not in {f.name for f in
                                      telemetry.registry().families()}
    got = telemetry.snapshot()["gauges"]
    assert memory.tracker()._pending is None
    # a full sample on the same run's tensors, as every run once took one
    state = {n: scope.find_var(n)
             for n in exe._resolve_state(main, feed, scope)}
    feeds = {n: torch.from_numpy(v) for n, v in feed.items()}
    cls = memory.classify(main, state, {})
    telemetry.reset()
    full = memory.MemoryTracker()
    full.peak_bytes = memory.tracker().peak_bytes
    full.sample(device=torch.device("cpu"), program="p",
                classes=dict(cls, feeds=sum(memory.nbytes_of(v)
                                            for v in feeds.values())),
                tensors=list(state.values()) + list(feeds.values()))
    want = telemetry.snapshot()["gauges"]
    hbm = [n for n in want if n.startswith("hbm_")]
    assert hbm and {n: got[n] for n in hbm} == {n: want[n] for n in hbm}
    assert memory.tracker().last["classes"] == full.last["classes"]


# --- the import-time flags --------------------------------------------------

def test_benchmark_flag_times_each_op_of_an_eager_run(monkeypatch, capsys):
    monkeypatch.setattr(E, "_BENCHMARK", True)
    monkeypatch.setenv("PADDLE_TPU_VLOG", "1")
    main, startup, loss = _net(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    capsys.readouterr()
    exe.run(main, feed=_feed(4), fetch_list=[loss], scope=scope)
    err = capsys.readouterr().err
    assert "[benchmark] win:mul+elementwise_add+relu:" in err
    assert "[benchmark] mul_grad:" in err and " ms" in err


def test_record_ops_appends_each_new_type(monkeypatch, tmp_path):
    path = tmp_path / "ops.txt"
    monkeypatch.setattr(E, "_RECORD_OPS_PATH", str(path))
    monkeypatch.setattr(E, "_RECORDED_OPS", set())
    main, startup, loss = _net(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(4), fetch_list=[loss], scope=scope)
    exe.run(main, feed=_feed(4), fetch_list=[loss], scope=scope)
    types = path.read_text().split()
    assert len(types) == len(set(types)) and {"mul", "sgd", "mean"} <= \
        set(types)
    assert set(types) == E._RECORDED_OPS


def test_compile_seconds_accumulates_builds():
    before = telemetry.compile_seconds()
    telemetry.note_compile("kernel_build", 0.25)
    assert telemetry.compile_seconds() == pytest.approx(before + 0.25)
    snap = telemetry.snapshot()["counters"]
    assert snap["kernel_builds_total"][""] == 1
    assert snap["kernel_build_seconds_total"][""] == 0.25
    assert math.isfinite(telemetry.compile_seconds())


def test_every_family_the_plane_makes_is_cataloged(monkeypatch, tmp_path):
    """A graphed, probed, audited, sampled run, a run_steps window served
    per step and a raising run under the flight recorder make only
    families METRIC_CATALOG declares, with its kinds and labels."""
    from paddle_tpu_torch import dynamics, errors, inspector
    torch_standin.graphed(monkeypatch)
    main, startup, loss = _net(pt)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    audit = inspector.GradientAudit(inspector.instrument(main, auto=True))
    inspector.enable_flight_recorder(str(tmp_path / "c.json"))
    try:
        with dynamics.override(True, 1):
            for _ in range(3):
                exe.run(audit.program, feed=_feed(8), fetch_list=[loss],
                        scope=scope)
            exe.run_steps(audit.program, feed_window=[_feed(8)] * 2,
                          fetch_list=[loss], scope=scope)
        w = scope.find_var("fc_0.w_0").clone()
        w.view(-1)[0] = float("nan")
        scope.set_var("fc_0.w_0", w)
        with pytest.raises(errors.NonFiniteError):
            exe.run(audit.program, feed=_feed(8), fetch_list=[loss],
                    scope=scope)
    finally:
        inspector.disable_flight_recorder()
        dynamics.reset()
    telemetry.note_compile("graph_capture", 0.1)
    fams = {f.name: f for f in telemetry.registry().families()}
    for name in ("executor_runs_total", "executor_window_fallback_total",
                 "nonfinite_detections_total", "grad_l2",
                 "dynamics_samples_total", "inspector_crash_reports_total",
                 "graph_captures_total", "optimizer_steps_total"):
        assert name in fams, name
    for name, fam in fams.items():
        entry = telemetry.METRIC_CATALOG[name]
        assert (fam.kind, fam.labelnames) == (entry["kind"],
                                              entry["labels"]), name
