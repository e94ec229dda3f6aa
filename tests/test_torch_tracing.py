"""The port's request tracing (runtime/tracing.py) against the JAX
package's, on the CPU.

The port's module is a copy of the JAX one: each stdlib case of
tests/test_tracing.py runs here over both modules (parametrised: the ring's
bounds and its env knob, 1-in-N sampling and the upstream override,
unsampled traces keeping `always` events only, span trees, the Chrome
export, `Hist`, StepStats' histograms, Prometheus text, the flight
recorder in memory and on disk), and the same events and metrics rendered
through both give byte-identical output.
"""

import json
import re

import pytest

from distributed_llama_tpu.runtime import telemetry as jtel
from distributed_llama_tpu.runtime import tracing as jtr
from distributed_llama_tpu_torch.runtime import telemetry as ptel
from distributed_llama_tpu_torch.runtime import tracing as ptr

# (tracing module, telemetry module) of each package
PKGS = {"jax": (jtr, jtel), "port": (ptr, ptel)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


# -- ring buffer ---------------------------------------------------------------


def test_ring_buffer_bounds_memory_under_100k_events(pkg):
    tr, _ = pkg
    ring = tr.TraceRing(capacity=4096)
    for i in range(100_000):
        ring.append(("t", "e", i, 1, (), ()))
    assert len(ring) == 4096
    snap = ring.snapshot()
    assert len(snap) == 4096
    assert snap[-1][2] == 99_999
    assert snap[0][2] == 100_000 - 4096


def test_ring_capacity_env_knob(pkg, monkeypatch):
    tr, _ = pkg
    monkeypatch.setenv("DLT_TRACE_RING", "64")
    ring = tr.TraceRing()
    for i in range(1000):
        ring.append((str(i),))
    assert len(ring) == 64


# -- sampling ------------------------------------------------------------------


def test_sampling_knob_one_in_n(pkg, monkeypatch):
    tr, _ = pkg
    monkeypatch.setenv("DLT_TRACE_SAMPLE", "3")
    t = tr.Tracer(capacity=1024)
    sampled = [t.start().sampled for _ in range(9)]
    assert sampled == [False, False, True] * 3
    monkeypatch.setenv("DLT_TRACE_SAMPLE", "0")
    assert not any(t.start().sampled for _ in range(5))
    monkeypatch.setenv("DLT_TRACE_SAMPLE", "1")
    assert all(t.start().sampled for _ in range(5))


def test_sampled_override_propagates_upstream_decision(pkg, monkeypatch):
    tr, _ = pkg
    monkeypatch.setenv("DLT_TRACE_SAMPLE", "1000")
    t = tr.Tracer(capacity=64)
    assert t.start(sampled=True).sampled is True
    monkeypatch.setenv("DLT_TRACE_SAMPLE", "1")
    assert t.start(sampled=False).sampled is False
    assert tr.parse_sampled(None) is None
    assert tr.parse_sampled("0") is False
    assert tr.parse_sampled("1") is True


def test_unsampled_trace_records_always_events_only(pkg, monkeypatch):
    tr, _ = pkg
    monkeypatch.setenv("DLT_TRACE_SAMPLE", "0")
    t = tr.Tracer(capacity=1024)
    trace = t.start("tid0")
    assert trace.bind("hot") is None
    trace.event("detail", tr.now_us(), 1)
    trace.event("error", tr.now_us(), 1, always=True)
    assert [e[1] for e in t.for_trace("tid0")] == ["error"]


def test_emitters_append_one_tuple(pkg):
    tr, _ = pkg
    t = tr.Tracer(capacity=16)
    trace = t.start("tid1", sampled=True)
    em = trace.bind("decode_chunk", ("n",))
    em(10, 20, 8)
    t.bind_global("batch_step", ("rows",))(30, 5, 4)
    t.event("prefix_publish", 40, 0, ("tokens",), (16,))
    assert t.ring.snapshot() == [
        ("tid1", "decode_chunk", 10, 20, ("n",), (8,)),
        ("", "batch_step", 30, 5, ("rows",), (4,)),
        ("", "prefix_publish", 40, 0, ("tokens",), (16,)),
    ]
    assert t.for_names(["batch_step"]) == [("", "batch_step", 30, 5, ("rows",), (4,))]


# -- span tree, chrome export, timelines ---------------------------------------

EVENTS = [
    ("t", "request", 100, 1000, ("path",), ("/x",)),
    ("t", "prefill", 150, 300, (), ()),
    ("t", "prefill_chunk", 160, 50, ("size",), (32,)),
    ("t", "decode_chunk", 500, 100, ("n",), (8,)),
    ("t", "spec_round", 620, 30, ("drafted", "accepted"), (4, 2)),
    ("t", "odd", 700, 0, (), (1, "a")),
]
TIMELINE = [
    ("", "batch_step", 10, 40, ("decoding", "prefilling", "free", "pool_pages_used",
                                "queue_depth"), (3, 1, 12, 40, 2)),
    ("", "batch_park", 20, 0, ("row",), (3,)),
    ("", "batch_shed", 30, 0, ("row",), (4,)),
]


def test_trace_tree_nests_by_interval_containment(pkg):
    tr, _ = pkg
    tree = tr.trace_tree(EVENTS[:4])
    assert len(tree) == 1
    root = tree[0]
    assert root["name"] == "request"
    assert [c["name"] for c in root["children"]] == ["prefill", "decode_chunk"]
    assert root["children"][0]["children"][0]["name"] == "prefill_chunk"
    assert root["children"][0]["children"][0]["args"] == {"size": 32}


def test_chrome_trace_export_shape(pkg):
    tr, _ = pkg
    out = tr.chrome_trace([("t", "decode_chunk", 10, 20, ("n",), (8,))])
    assert out[0]["ph"] == "X"
    assert out[0]["ts"] == 10 and out[0]["dur"] == 20
    assert out[0]["args"] == {"n": 8}
    json.dumps(out)


@pytest.mark.parametrize("render", ["trace_payload", "batch_timeline_payload", "render_event"])
def test_renderers_give_the_jax_modules_bytes(render):
    def both(fn):
        return [json.dumps(fn(m), sort_keys=False) for m in (jtr, ptr)]

    if render == "trace_payload":
        want, got = both(lambda m: m.trace_payload("t", EVENTS))
    elif render == "batch_timeline_payload":
        want, got = both(lambda m: m.batch_timeline_payload(TIMELINE))
    else:
        want, got = both(lambda m: [m.render_event(e) for e in EVENTS + TIMELINE])
    assert got == want


# -- histograms and StepStats ----------------------------------------------------


def test_hist_cumulative_le_semantics(pkg):
    tr, _ = pkg
    h = tr.Hist(bounds=(1.0, 10.0, 100.0))
    for v in (0.5, 1.0, 5.0, 50.0, 500.0):
        h.observe(v)
    snap = h.snapshot()
    assert snap["buckets"] == [[1.0, 2], [10.0, 3], [100.0, 4], ["+Inf", 5]]
    assert snap["count"] == 5
    assert snap["sum"] == pytest.approx(556.5)


def test_stepstats_observe_and_snapshot(pkg):
    _, tel = pkg
    s = tel.StepStats()
    s.incr("requests_completed")
    s.gauge("overlap_pct", 92.5)
    s.record("decode[8]", 1500.0)
    s.observe("ttft_ms", 12.0)
    s.observe("ttft_ms", 900.0)
    snap = s.snapshot()
    assert snap["counters"]["requests_completed"] == 1
    assert snap["gauges"]["overlap_pct"] == 92.5
    assert snap["decode[8]"]["count"] == 1
    hist = snap["histograms"]["ttft_ms"]
    assert hist["count"] == 2
    assert hist["buckets"][-1] == ["+Inf", 2]


# -- Prometheus exposition -------------------------------------------------------

_PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
    r' [-+]?[0-9.eE+]+$'
)


def _filled(tel):
    s = tel.StepStats()
    s.incr("requests_completed", 3)
    s.incr("shed_503")
    s.gauge("spec_acceptance_rate", 0.75)
    for us in (900.0, 1500.0, 80_000.0):
        s.record("decode[64]", us)
    s.record("prefill[32]", 4000.0)
    s.observe("ttft_ms", 45.0)
    s.observe("ttft_ms", 45.0, labels={"slo_class": "batch"})
    s.observe("tpot_ms", 2.5)
    return s


def test_render_step_stats_is_valid_prometheus(pkg):
    tr, tel = pkg
    body = tr.render_step_stats(_filled(tel), extra_gauges={"batcher_queue_depth": 2})
    for line in body.splitlines():
        assert not line or line.startswith("#") or _PROM_LINE.match(line), line
    assert "dlt_requests_completed_total 3" in body
    assert "dlt_batcher_queue_depth 2" in body
    assert 'dlt_step_latency_ms{kind="decode[64]",quantile="p95"}' in body
    assert 'dlt_ttft_ms_bucket{le="+Inf"} 1' in body
    assert body.count("# TYPE dlt_ttft_ms histogram") == 1


def test_prometheus_text_and_report_equal_the_jax_modules():
    extra = dict(extra_gauges={"q": 2}, extra_series={"hbm_bytes": [({"component": "kv"}, 7)]},
                 extra_counter_series={"wasted_tokens": [({"reason": "shed"}, 3)]})
    want, got = (m.render_step_stats(_filled(t), **extra) for m, t in ((jtr, jtel), (ptr, ptel)))
    assert got == want
    assert _filled(ptel).report() == _filled(jtel).report()
    assert _filled(ptel).percentiles("decode[64]") == _filled(jtel).percentiles("decode[64]")


# -- flight recorder -------------------------------------------------------------


def test_flight_record_memory_and_disk(pkg, tmp_path, monkeypatch):
    tr, _ = pkg
    monkeypatch.setenv("DLT_FLIGHTREC_DIR", str(tmp_path))
    monkeypatch.setenv("DLT_FLIGHTREC_EVENTS", "100")
    tr.global_event("pre_crash_marker", keys=("k",), vals=("v",))
    rec = tr.flight_record("test-reason", counters={"stall_resets": 1})
    assert rec["reason"] == "test-reason"
    assert rec["counters"]["stall_resets"] == 1
    assert "pre_crash_marker" in [e["name"] for e in rec["events"]]
    assert len(rec["events"]) <= 100
    assert tr.last_flight_record()["reason"] == "test-reason"
    dumps = list(tmp_path.glob("flightrecord-*.json"))
    assert len(dumps) == 1
    assert json.loads(dumps[0].read_text())["reason"] == "test-reason"


def test_flight_record_disk_disabled(pkg, monkeypatch):
    tr, _ = pkg
    monkeypatch.setenv("DLT_FLIGHTREC_DIR", "")
    assert "path" not in tr.flight_record("no-disk")


def test_flight_records_hold_the_same_events(monkeypatch):
    """A private tracer of each module with the same events: the records'
    event lists are equal."""
    monkeypatch.setenv("DLT_FLIGHTREC_DIR", "")
    recs = []
    for m in (jtr, ptr):
        t = m.Tracer(capacity=8)
        for ev in EVENTS:
            t.ring.append(ev)
        recs.append(m.FlightRecorder(t).record("x")["events"])
    assert recs[1] == recs[0] and len(recs[0]) == len(EVENTS)


def test_goodput_ledger_and_aggregator_equal_the_jax_modules():
    outs = []
    for tel in (jtel, ptel):
        assert tel.WASTE_REASONS and tel.LEDGER_TRACE_KEYS
        agg = tel.GoodputAggregator(window_s=60.0)
        for i, outcome in enumerate(("ok", "shed", "ok", "error")):
            led = tel.GoodputLedger(prompt_tokens=10 + i, generated_tokens=5 * i,
                                    discarded_tokens=i, outcome=outcome,
                                    slo_class=("interactive", "batch")[i % 2])
            agg.record(led)
        agg.add_waste("transfer_retry", 7)
        snap = agg.snapshot()
        snap.pop("goodput_tokens_per_s")
        for c in snap["by_class"].values():
            c.pop("goodput_tokens_per_s")
        outs.append((snap, agg.wasted_series(), agg.wasted_by_class_series(),
                     led.as_dict(), led.trace_vals()))
    assert outs[1] == outs[0]
    assert (ptel.WASTE_REASONS, ptel.SLO_CLASSES, ptel.LEDGER_FIELDS) == (
        jtel.WASTE_REASONS, jtel.SLO_CLASSES, jtel.LEDGER_FIELDS)
