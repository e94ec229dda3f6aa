"""The port's observability surface (runtime/telemetry.py, the engine's
StepStats, traces and watchdog) against the JAX package's, on the CPU.

* The watchdog and StepStats cases of tests/test_telemetry.py, over both
  packages' modules; the port's watchdog reads its thresholds when a guard
  is entered and watches every guard from one daemon thread.
* The same calls through both engines (f32, tiny Llama): a greedy
  `generate`, a prefix-cache hit on the contiguous and the paged layout,
  ngram speculation at k 4, `generate_batch` with and without speculation,
  and a traced BatchSession. The StepStats series (with their counts),
  counters and gauge names, and the trace event names in order, equal the
  JAX engine's, and so do the tokens.
* A stall: the fetch of one decode chunk sleeps past the hard timeout
  (log 30 ms, timeout 80 ms, as JAX's test_watchdog_logs_and_times_out,
  set for the guards armed after the first chunk's fetch):
  `StallError` once the fetch returns, the `[EXEC_STALL]` lines, both
  counters, and a flight record with the request's spans and the
  `watchdog_stall` event; after `reset()` the engine gives its tokens
  again. A first call of a key takes the compile threshold; warmup marks
  the ladder's keys.
* The CLI prints the step report, with the JAX CLI's series and counts.
"""

import threading
import time
import uuid

import pytest
import torch

from distributed_llama_tpu import cli as jcli
from distributed_llama_tpu.runtime import telemetry as jtel
from distributed_llama_tpu.runtime import tracing as jtr
from distributed_llama_tpu.runtime.batch_session import BatchSession as JSession
from distributed_llama_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llama_tpu_torch import cli as pcli
from distributed_llama_tpu_torch.runtime import telemetry as ptel
from distributed_llama_tpu_torch.runtime import tracing as ptr
from distributed_llama_tpu_torch.runtime.batch_session import BatchSession
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
from distributed_llama_tpu_torch.runtime.graphs import DecodeGraphs
from distributed_llama_tpu_torch.testing import tiny_header, write_tiny_model, write_tiny_tokenizer

torch.set_num_threads(1)

TEL = {"jax": jtel, "port": ptel}
# a prompt whose tail repeats, so that ngram drafts and some are accepted
A = [(i % 100) + 1 for i in range(48)] + [5, 6, 7, 8] * 6
B = [(i % 90) + 7 for i in range(40)]
N_NEW = 24


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("tel") / "m.m")
    write_tiny_model(p, tiny_header(dim=64, hidden_dim=128, n_layers=2, seq_len=256,
                                    vocab_size=288), seed=3)
    return p


# -- the watchdog and StepStats of both packages --------------------------------


@pytest.mark.parametrize("pkg", sorted(TEL))
def test_watchdog_passthrough(pkg):
    with TEL[pkg].watchdog("fast-step"):
        pass


@pytest.mark.parametrize("pkg", sorted(TEL))
def test_watchdog_logs_and_times_out(pkg, monkeypatch):
    tel = TEL[pkg]
    monkeypatch.setenv("DLT_STALL_LOG_MS", "30")
    monkeypatch.setenv("DLT_STALL_TIMEOUT_MS", "80")
    monkeypatch.setenv("DLT_FLIGHTREC_DIR", "")
    logs = []
    stats = tel.StepStats()
    with pytest.raises(tel.StallError, match="slow-step exceeded 80 ms"):
        with tel.watchdog("slow-step", log_fn=logs.append, stats=stats):
            time.sleep(0.3)
    assert [l.split("]")[0] for l in logs] == ["⏳ [EXEC_STALL", "🚨 [EXEC_STALL"]
    assert "slow-step exceeded 30 ms" in logs[0] and "hard timeout 80 ms" in logs[1]
    assert stats.counters_snapshot() == {"exec_stall_logged": 1, "exec_stall_timeout": 1}


@pytest.mark.parametrize("pkg", sorted(TEL))
def test_watchdog_compile_threshold_and_exceptions(pkg, monkeypatch):
    """A compiling guard logs under DLT_COMPILE_LOG_MS, labelled "compile";
    a guard left by an exception never raises StallError over it."""
    tel = TEL[pkg]
    monkeypatch.setenv("DLT_STALL_LOG_MS", "10")
    monkeypatch.setenv("DLT_COMPILE_LOG_MS", "5000")
    monkeypatch.setenv("DLT_STALL_TIMEOUT_MS", "60000")
    logs = []
    with tel.watchdog("decode[8]", log_fn=logs.append, compiling=True):
        time.sleep(0.1)
    assert logs == []
    with tel.watchdog("decode[8]", log_fn=logs.append):
        time.sleep(0.1)
    assert len(logs) == 1 and "decode[8] exceeded 10 ms" in logs[0]
    monkeypatch.setenv("DLT_STALL_TIMEOUT_MS", "20")
    with pytest.raises(KeyError):
        with tel.watchdog("x", log_fn=logs.append):
            time.sleep(0.1)
            raise KeyError("the call's own error wins")


def test_port_watchdog_reads_thresholds_when_armed_on_one_thread(monkeypatch):
    """The thresholds are read at `__enter__`, not at construction; every
    guard is watched by the one daemon thread, started once."""
    logs = []
    wd = ptel.watchdog("late-env", log_fn=logs.append)
    monkeypatch.setenv("DLT_STALL_LOG_MS", "20")
    monkeypatch.setenv("DLT_STALL_TIMEOUT_MS", "60000")
    with wd:
        time.sleep(0.1)
    assert len(logs) == 1 and "exceeded 20 ms" in logs[0]
    monkeypatch.setenv("DLT_STALL_LOG_MS", "60000")
    before = threading.active_count()
    for _ in range(2000):
        with ptel.watchdog("fast"):
            pass
    assert threading.active_count() == before
    watchers = [t for t in threading.enumerate() if t.name == "dlt-watchdog"]
    assert len(watchers) == 1 and watchers[0].daemon
    assert not ptel._WATCHER._armed


@pytest.mark.parametrize("pkg", sorted(TEL))
def test_step_stats_percentiles_and_report(pkg):
    s = TEL[pkg].StepStats(window=10)
    for us in [100, 200, 300, 400, 1000]:
        s.record("decode[4]", us)
    p = s.percentiles("decode[4]")
    assert p["p50"] <= p["p95"] <= p["p99"] <= 1000
    rep = s.report()
    assert "decode[4]" in rep and "p99" in rep


# -- the engines ------------------------------------------------------------------


def _engines(path, **kw):
    kw = {"compute_dtype": "float32", "decode_chunk_size": 8, "max_chunk": 32,
          "speculative": "off", **kw}
    return (JEngine(path, grammar=False, **kw),
            InferenceEngine(path, device="cpu", **kw))


def _observed(eng, tracing, script):
    """Run `script(eng, trace)` on `eng` with a fresh sampled trace; return
    (the script's result, {series: count}, counters, gauge names, the
    trace's event names in order)."""
    tid = uuid.uuid4().hex[:16]
    trace = tracing.TRACER.start(tid, sampled=True)
    out = script(eng, trace)
    snap = eng.stats.snapshot()
    counters, gauges = snap.pop("counters"), snap.pop("gauges")
    snap.pop("histograms")
    return (out, {k: v["count"] for k, v in snap.items()}, counters, sorted(gauges),
            [e[1] for e in tracing.TRACER.for_trace(tid)])


def _generate_twice(eng, trace):
    eng.trace = trace
    toks = []
    for _ in range(2):
        eng.reset()
        toks.append(eng.generate(A, len(A) + N_NEW).tokens)
    eng.trace = None
    return toks


def _generate_batch(eng, trace):
    outs = [eng.generate_batch([A, A[:40] + B], [N_NEW, N_NEW - 5])]
    eng.reset()
    outs.append(eng.generate_batch([A[:36] + B, A], N_NEW))
    return outs


def _session(eng, trace):
    s = (BatchSession if isinstance(eng, InferenceEngine) else JSession)(eng)
    s.admit(0, A, trace=trace)
    s.admit(1, B)
    toks = [s.step(8).tolist() for _ in range(2)]
    s.release(1)
    s.admit(1, A[:40], trace=trace)
    toks.append(s.step(8).tolist())
    if eng.spec_mode is not None:
        toks.append(s.spec_step({0: [5, 6, 7, 8], 1: []}))
        toks.append(s.spec_step({1: [9]}))
    return toks


CASES = {
    "greedy contiguous": (dict(), _generate_twice),
    "prefix hit contiguous": (dict(prefix_cache_mb=64), _generate_twice),
    "prefix hit paged": (dict(kv_layout="paged", prefix_cache_mb=64), _generate_twice),
    "ngram k 4 with a prefix hit": (dict(prefix_cache_mb=64, speculative="ngram", draft_k=4),
                                    _generate_twice),
    "ngram k 8 paged": (dict(kv_layout="paged", speculative="ngram", draft_k=8),
                        _generate_twice),
    "generate_batch": (dict(batch=2, prefix_cache_mb=64), _generate_batch),
    "generate_batch ngram": (dict(batch=2, kv_layout="paged", speculative="ngram"),
                             _generate_batch),
    "batch session": (dict(batch=2, kv_layout="paged", prefix_cache_mb=64), _session),
    "batch session ngram": (dict(batch=2, speculative="ngram"), _session),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_stats_and_trace_equal_the_jax_engines(path, case):
    kw, script = CASES[case]
    je, pe = _engines(path, **kw)
    want = _observed(je, jtr, script)
    got = _observed(pe, ptr, script)
    assert got[0] == want[0]  # the tokens
    assert got[1] == want[1]  # every series, with its count
    assert got[2] == want[2]  # the counters
    assert got[3] == want[3]  # the gauges' names
    assert got[4] == want[4]  # the trace's event names, in order
    series = got[1]
    if script is _generate_twice:
        assert any(k.startswith("prefill[") for k in series)
        assert any(k.startswith(("decode[", "spec_verify[")) for k in series)
        assert got[4].count("prefill") == 2
    if "ngram" in case:
        assert got[2]["spec_rounds"] > 0
        assert pe.spec_counters["spec_rounds"] == got[2]["spec_rounds"]
        assert pe.spec_counters["spec_acceptance_rate"] == pytest.approx(
            je.stats.gauges_snapshot()["spec_acceptance_rate"])
    if "prefix hit" in case:
        assert got[2]["prefix_hits"] == 1
        assert pe.prefix_cache.counters["prefix_hits"] == 1
    if "paged" in kw.get("kv_layout", ""):
        g = pe.stats.gauges_snapshot()
        assert g["kv_pool_pages_used"] + g["kv_pool_pages_free"] == pe.page_pool.n_pages
    if script is _session:
        assert any(k.startswith("batch_decode[") for k in series)


def test_last_prefill_timing_and_overlap_gauge(path):
    _, pe = _engines(path, prefix_cache_mb=64)
    pe.prefill(A)
    t = pe.last_prefill_timing
    assert (t["n_tokens"], t["n_chunks"], t["prefix_hit_tokens"]) == (len(A), 3, 0)
    assert 0 <= t["dispatch_us"] <= t["total_us"] and t["sync_us"] >= 0
    assert pe.stats.gauges_snapshot()["prefill_dispatch_overlap_pct"] == t["overlap_pct"]
    pe.reset()
    pe.prefill(A)  # a whole-prefix hit but the tail: one chunk
    assert pe.last_prefill_timing["prefix_hit_tokens"] == 64
    assert pe.last_prefill_timing["n_chunks"] == 1


# -- a stall ------------------------------------------------------------------------


def test_stall_raises_after_the_fetch_with_a_flight_record(path, monkeypatch, capsys):
    _, pe = _engines(path)
    want = pe.generate(A, len(A) + N_NEW).tokens
    monkeypatch.setenv("DLT_FLIGHTREC_DIR", "")
    fetch = pe._host_fetch
    calls = []

    def slow_fetch(x):
        calls.append(1)
        if len(calls) == 1:
            # the thresholds for the guards armed from here on: the second
            # chunk's (a loaded CPU may run the prefill past 80 ms)
            monkeypatch.setenv("DLT_STALL_LOG_MS", "30")
            monkeypatch.setenv("DLT_STALL_TIMEOUT_MS", "80")
        if len(calls) == 2:  # the second chunk's fetch
            time.sleep(0.3)
        return fetch(x)

    monkeypatch.setattr(pe, "_host_fetch", slow_fetch)
    tid = uuid.uuid4().hex[:16]
    pe.trace = ptr.TRACER.start(tid, sampled=True)
    pe.reset()
    with pytest.raises(ptel.StallError, match=r"decode\[8\] exceeded 80 ms"):
        pe.generate(A, len(A) + N_NEW)
    pe.trace = None
    err = capsys.readouterr().err
    assert "⏳ [EXEC_STALL] decode[8] exceeded 30 ms" in err
    assert "🚨 [EXEC_STALL] decode[8] exceeded hard timeout 80 ms" in err
    c = pe.stats.counters_snapshot()
    assert (c["exec_stall_logged"], c["exec_stall_timeout"]) == (1, 1)
    assert err.count("[EXEC_STALL]") == 2
    rec = ptr.last_flight_record()
    assert rec["reason"] == "stall:decode[8]"
    assert rec["counters"]["exec_stall_timeout"] == 1
    names = [(e["trace_id"], e["name"]) for e in rec["events"]]
    mine = [n for t, n in names if t == tid]
    assert mine[:2] == ["prefill_chunk", "prefill_chunk"] and "decode_chunk" in mine
    assert ("", "exec_stall_logged") in names and names[-1] == ("", "watchdog_stall")
    # the stalled chunk's tokens reached the host; the engine serves on
    monkeypatch.setattr(pe, "_host_fetch", fetch)
    monkeypatch.delenv("DLT_STALL_LOG_MS")
    monkeypatch.delenv("DLT_STALL_TIMEOUT_MS")
    pe.reset()
    assert pe.generate(A, len(A) + N_NEW).tokens == want


def _spy_guards(eng) -> list:
    """Record (label, first call) of each of `eng`'s guards."""
    firsts = []
    guard = eng._guard

    def spy(label, key):
        firsts.append((label, key not in eng._warm))
        return guard(label, key)

    eng._guard = spy
    return firsts


def test_first_calls_take_the_compile_threshold_and_warmup_marks_the_ladder(path):
    _, pe = _engines(path, speculative="ngram")
    firsts = _spy_guards(pe)
    pe.generate(A, len(A) + N_NEW)
    n = len(firsts)
    pe.reset()
    pe.generate(A, len(A) + N_NEW)
    assert any(f for _, f in firsts[:n]) and not any(f for _, f in firsts[n:])
    # the static buffers' ladder (what warmup captures on the card) joins
    # `_warm`: after warmup a fresh engine's decode and verify calls are
    # warm, and only its first prefill is a first call
    _, we = _engines(path, speculative="ngram")
    we._graphs = DecodeGraphs("cpu", capture=False)
    we.warmup()
    assert ("decode", 8, 256, "greedy") in we._warm and ("verify", 5, 256) in we._warm
    firsts = _spy_guards(we)
    we.generate(A, len(A) + N_NEW)
    assert [label for label, f in firsts if f] == [f"prefill[{len(A) - 1}]"]


# -- the CLI ------------------------------------------------------------------------


def _report(out: str) -> dict:
    """{series: count} of the step report's lines."""
    lines = out.split("📊 Step performance report:")[1].strip().splitlines()
    return {l.split()[0]: int(l.split()[1][2:]) for l in lines}


def test_cli_prints_the_jax_clis_step_report(tmp_path, monkeypatch, capsys):
    mp, tp = str(tmp_path / "m.m"), str(tmp_path / "t.t")
    write_tiny_model(mp, tiny_header(dim=64, hidden_dim=128, n_layers=2, seq_len=256,
                                     vocab_size=288), seed=3)
    write_tiny_tokenizer(tp, pad_to=288)
    monkeypatch.setenv("DLT_GRAMMAR", "0")
    argv = ["inference", "--model", mp, "--tokenizer", tp, "--prompt", "hello world hello world",
            "--steps", "64", "--temperature", "0", "--max-seq-len", "256"]
    reports = {}
    for name, main, extra in (("jax", jcli.main, []), ("port", pcli.main, ["--device", "cpu"])):
        assert main(argv + extra) == 0
        reports[name] = _report(capsys.readouterr().out)
    assert reports["port"] == reports["jax"]
    assert any(k.startswith("prefill[") for k in reports["port"])
    assert any(k.startswith(("decode[", "spec_verify[")) for k in reports["port"])
