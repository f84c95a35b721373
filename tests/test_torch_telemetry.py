"""The port's telemetry core, span tracing, SLO monitor and serving error
against the JAX package's (paddle_tpu/telemetry.py, tracing.py,
serving/slo.py, errors.py), on the CPU.

  * The same counter, gauge and histogram operations give the same
    read_series, read_gauge, read_histogram and histogram_quantile values
    in both packages (the same bucket edges and interpolation: equal
    floats, no tolerance).
  * SLOMonitor with one injected clock gives reports equal to the
    reference's.
  * Spans: the deterministic head sampler keeps the same roots, and the
    span trees (names, parents, attrs) match.
"""

import torch_threads  # noqa: F401  (the cores shared among xdist workers)
import threading

import pytest

from paddle_tpu import telemetry as jtelemetry
from paddle_tpu import tracing as jtracing
from paddle_tpu.errors import ServingOverloadError as JaxOverloadError
from paddle_tpu.serving import slo as jslo
from paddle_tpu_torch import telemetry, tracing
from paddle_tpu_torch.errors import ServingOverloadError
from paddle_tpu_torch.serving import slo

BOTH = (telemetry, jtelemetry)


def _name(request, kind):
    """A family name of this test only: both registries are process-wide."""
    return f"tt_{kind}_{request.node.name}".replace("[", "_").replace(
        "]", "").replace("-", "_").replace(".", "_")


def test_default_buckets_match():
    assert telemetry.default_buckets() == jtelemetry.default_buckets()


COUNTER_OPS = [
    [((), 1.0)],
    [(("a",), 1.0), (("b",), 2.5), (("a",), 3.0)],
    [(("x", "y"), 1.0), (("x", "z"), 4.0), (("x", "y"), 0.5)],
]


@pytest.mark.parametrize("ops", COUNTER_OPS, ids=["unlabeled", "one_label",
                                                 "two_labels"])
def test_counter_series_match(request, ops):
    name = _name(request, "counter")
    nlab = len(ops[0][0])
    labelnames = ("program", "bucket")[:nlab]
    for tel in BOTH:
        fam = tel.counter(name, "test counter", labels=labelnames)
        for values, amount in ops:
            (fam.labels(**dict(zip(labelnames, values))) if nlab
             else fam).inc(amount)
    assert telemetry.read_series(name) == jtelemetry.read_series(name)
    assert telemetry.read_series(name)


@pytest.mark.parametrize("values", [[3.0], [1.0, -2.0, 7.5], [0.0]])
def test_gauge_reads_match(request, values):
    name = _name(request, "gauge")
    for tel in BOTH:
        g = tel.gauge(name, "test gauge", labels=("model", "window"))
        for i, v in enumerate(values):
            g.labels(model="m", window=f"w{i % 2}").set(v)
    for tel_read in ("read_series",):
        assert getattr(telemetry, tel_read)(name) == \
            getattr(jtelemetry, tel_read)(name)
    for w in ("w0", "w1", "w9"):
        assert telemetry.read_gauge(name, model="m", window=w) == \
            jtelemetry.read_gauge(name, model="m", window=w)
    # read-only peeks never create a family or a series
    assert telemetry.read_gauge(name, model="m") is None
    assert telemetry.read_gauge(name + "_absent", model="m") is None
    assert telemetry.read_series(name + "_absent") == {}
    assert name + "_absent" not in {f.name for f in
                                    telemetry.registry().families()}


HIST_VALUES = {
    "one": [2e-3],
    "spread": [1e-6, 3e-6, 2e-5, 5e-4, 5e-4, 0.01, 0.3, 2.0],
    "tail": [1e-3, 100.0, 200.0],            # past the last finite edge
    "edges": [1e-6, 4e-6, 1.6e-5],           # on bucket edges
}


@pytest.mark.parametrize("case", sorted(HIST_VALUES))
def test_histogram_reads_and_quantiles_match(request, case):
    name = _name(request, "hist")
    for tel in BOTH:
        h = tel.histogram(name, "test histogram", labels=("program", "phase"))
        for v in HIST_VALUES[case]:
            h.labels(program="p", phase="total").observe(v)
    labels = {"program": "p", "phase": "total"}
    assert telemetry.read_histogram(name, **labels) == \
        jtelemetry.read_histogram(name, **labels)
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert telemetry.histogram_quantile(name, q, **labels) == \
            jtelemetry.histogram_quantile(name, q, **labels), q
    assert telemetry.histogram_quantile(name, 0.5, program="p",
                                        phase="queue") is None
    assert telemetry.read_histogram(name, program="p") is None
    with pytest.raises(ValueError):
        telemetry.histogram_quantile(name, 1.5, **labels)
    if case == "tail":
        key = f"name={name}"
        assert telemetry.read_series(
            "telemetry_quantile_tail_clamped_total").get(key) == \
            jtelemetry.read_series(
                "telemetry_quantile_tail_clamped_total").get(key)


@pytest.mark.parametrize("misuse", ["wrong_labels", "unlabeled_inc",
                                    "kind_clash"])
def test_registry_misuse_raises_like_the_reference(request, misuse):
    name = _name(request, "misuse")
    for tel in BOTH:
        fam = tel.counter(name, labels=("program",))
        with pytest.raises(ValueError):
            if misuse == "wrong_labels":
                fam.labels(bucket="1")
            elif misuse == "unlabeled_inc":
                fam.inc()
            else:
                tel.gauge(name, labels=("program",))


def test_events_and_program_labels():
    rec = telemetry.log_event("tt_event", program="pX", bucket=4)
    assert {"ts", "mono", "host", "kind"} <= set(rec)
    assert telemetry.recent_events(kind="tt_event")[-1] is rec
    assert telemetry.recent_events(1)[-1] is rec

    class P:
        pass

    a, b = P(), P()
    la, lb = telemetry.program_label(a), telemetry.program_label(b)
    assert la != lb and la.startswith("p")
    assert telemetry.program_label(a) == la


def test_catalog_matches_reference():
    """Every family the port declares has the reference's kind and label
    set, but the port's own compile-time counters (telemetry.PORT_ONLY,
    in the place of the reference's jax_backend_compile*_total), which the
    reference does not declare."""
    for name, entry in telemetry.METRIC_CATALOG.items():
        if name in telemetry.PORT_ONLY:
            assert name not in jtelemetry.METRIC_CATALOG, name
            continue
        ref = jtelemetry.METRIC_CATALOG[name]
        assert (entry["kind"], entry["labels"]) == \
            (ref["kind"], ref["labels"]), name


def test_serving_overload_error_matches_reference():
    for cls in (ServingOverloadError, JaxOverloadError):
        e = cls("queue full", reason="queue_full", queue_depth=7)
        assert isinstance(e, RuntimeError)
    mine = ServingOverloadError("queue full", reason="queue_full",
                                queue_depth=7).to_dict()
    ref = JaxOverloadError("queue full", reason="queue_full",
                           queue_depth=7).to_dict()
    assert mine == ref


# --- SLOs ---------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


# (dt since the last record, ok, latency_s) sequences
SLO_CASES = {
    "all_good": [(1.0, True, 0.01)] * 5,
    "sheds": [(1.0, True, 0.01), (0.5, False, None), (0.5, True, 0.02),
              (0.1, False, None)],
    "latency_objective": [(1.0, True, 0.01), (1.0, True, 0.2),
                          (1.0, True, 0.05)],
    "fast_window_expired": [(1.0, False, None), (400.0, True, 0.01),
                            (1.0, True, 0.01)],
    "slow_window_expired": [(1.0, False, None), (4000.0, True, 0.01)],
    "no_traffic": [],
}


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_slo_monitor_reports_match_reference(case):
    reports = []
    for mod in (slo, jslo):
        clock = _Clock()
        mon = mod.SLOMonitor(mod.SLO("m", availability=0.99, latency_ms=100),
                             clock=clock)
        for dt, ok, lat in SLO_CASES[case]:
            clock.t += dt
            mon.record(ok=ok, latency_s=lat)
        clock.t += 1.0
        reports.append((mon.report(), mon.burn_rate(),
                        mon.burn_rate(mod.SLOW_WINDOW_S),
                        mon.report(now=clock.t + 350.0)))
    assert reports[0] == reports[1]
    assert (slo.FAST_WINDOW_S, slo.SLOW_WINDOW_S) == \
        (jslo.FAST_WINDOW_S, jslo.SLOW_WINDOW_S)


def test_slo_objective_and_registry():
    with pytest.raises(ValueError):
        slo.SLO("m", availability=1.0)
    assert slo.SLO("m", 0.999, 50).to_dict() == \
        jslo.SLO("m", 0.999, 50).to_dict()
    slo.reset()
    try:
        first = slo.monitor_for("tt_model", availability=0.9)
        assert slo.monitor_for("tt_model", availability=0.5) is first
        assert first.slo.availability == 0.9
        first.record(ok=False)
        rep = slo.all_reports()
        assert set(rep) == {"tt_model"}
        assert rep["tt_model"]["windows"]["fast"]["bad"] == 1
        assert telemetry.read_gauge("slo_burn_rate", model="tt_model",
                                    window="fast") == pytest.approx(10.0)
    finally:
        slo.reset()


# --- spans ----------------------------------------------------------------------

def _traced(tr, body):
    tr.reset()
    try:
        body(tr)
        return tr.recent_spans()
    finally:
        tr.reset()


def _shape(spans):
    """Span names, parent names and attrs, in the order they finished."""
    by_id = {s["span_id"]: s["name"] for s in spans}
    return [(s["name"], by_id.get(s["parent_id"]), s["attrs"])
            for s in spans]


@pytest.mark.parametrize("rate,roots", [(1.0, 4), (0.5, 8), (0.25, 8),
                                        (0.0, 4)])
def test_head_sampler_keeps_the_same_roots(rate, roots):
    def body(tr):
        tr.enable(sample=rate)
        for i in range(roots):
            with tr.span("root", i=i):
                with tr.span("child", i=i):
                    pass
    mine, ref = _traced(tracing, body), _traced(jtracing, body)
    assert _shape(mine) == _shape(ref)
    assert len(mine) == 2 * int(roots * rate)


def test_span_styles_match_reference():
    def body(tr):
        tr.enable()
        root = tr.start_span("request", parent=None, attrs={"rows": 2})
        tr.record_span("queue", root.start, root.start + 0.5, parent=root,
                       attrs={"close": "size"})
        with tr.adopt(root):
            with tr.span("work", bucket=4) as sp:
                sp.add_event("mark", n=1)
        ctx = {}

        def worker():
            with tr.adopt(ctx["handle"]):
                tr.record_span("remote", 0.0, 1.0,
                               parent=tr.capture_context())
        with tr.span("outer") as outer:
            ctx["handle"] = tr.capture_context()
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10.0)
            assert not t.is_alive()
            outer.set_attr("done", True)
        with pytest.raises(KeyError):
            with tr.span("failing"):
                raise KeyError("x")
        root.end(outcome="ok")
        tr.record_span("orphan", 1.0, 2.0)
    mine, ref = _traced(tracing, body), _traced(jtracing, body)
    assert _shape(mine) == _shape(ref)
    names = [s["name"] for s in mine]
    assert names == ["queue", "work", "remote", "outer", "failing",
                     "request", "orphan"]
    assert mine[4]["attrs"]["error"] == "KeyError: 'x'"
    assert [e["name"] for e in mine[1]["events"]] == ["mark"]


def test_trace_tree_nests_children():
    tracing.reset()
    try:
        tracing.enable()
        with tracing.span("a"):
            with tracing.span("b"):
                with tracing.span("c"):
                    pass
            with tracing.span("d"):
                pass
        tid = tracing.recent_spans(name="a")[0]["trace_id"]
        (a,) = tracing.trace_tree(tid)
        assert [c["name"] for c in a["children"]] == ["b", "d"]
        assert [c["name"] for c in a["children"][0]["children"]] == ["c"]
        assert telemetry.read_series("trace_spans_total")["name=a"] >= 1
    finally:
        tracing.reset()


def test_disabled_tracing_records_nothing():
    tracing.reset()
    assert not tracing.enabled()
    sp = tracing.start_span("x")
    assert not sp.sampled and sp.to_dict() == {}
    assert not tracing.record_span("y", 0.0, 1.0).sampled
    with tracing.span("z") as s:
        s.set_attr("k", 1).add_event("e")
    assert tracing.recent_spans() == []


def test_ring_is_bounded():
    tracing.reset()
    try:
        tracing.enable(capacity=3)
        for i in range(5):
            tracing.record_span(f"s{i}", 0.0, 1.0)
        assert [s["name"] for s in tracing.recent_spans()] == \
            ["s2", "s3", "s4"]
        assert [s["name"] for s in tracing.recent_spans(n=1)] == ["s4"]
    finally:
        tracing.reset()


@pytest.mark.parametrize("raw,sample", [("1", 1.0), ("true", 1.0),
                                        ("0.25", 0.25), ("0", None),
                                        ("off", None), ("junk", None),
                                        ("", None)])
def test_trace_env_switch_matches_reference(monkeypatch, raw, sample):
    monkeypatch.setenv("PADDLE_TPU_TRACE", raw)
    monkeypatch.delenv("PADDLE_TPU_TRACE_JSONL", raising=False)
    got = []
    for tr in (tracing, jtracing):
        tr.reset()
        try:
            tr.maybe_enable_from_env()
            got.append((tr.enabled(), tr._SAMPLE))
        finally:
            tr.reset()
    assert got[0] == got[1]
    assert got[0] == ((True, sample) if sample is not None else (False, 1.0))
