"""The port's device-performance observability (runtime/profiling.py) held
to the JAX package's, on the CPU (the twins of tests/test_profiling.py).

The cost table: the analytic decode-FLOPs band and the kv-bucket byte
delta of the JAX suite on the same f32 tiny model; the table's key set
equal to the JAX engine's `warm_plan` for the same engine arguments; the
FLOPs of every model kind within 20% of JAX's table (dots count 2·m·n·k
in both; the rest is each package's elementwise count — JAX also counts a
scatter into the paged pool as FLOPs, the port counts data movement as
none, so the mover kinds carry 0 FLOPs here, and the port's count is
0.82-0.995 of JAX's on the model kinds); the kernel wrappers' stated
cost on the bf16 path; the table built on meta tensors
leaves the engine as it was; a missing entry fails coverage. The HBM
ledger's components, the drift counter and the no-op without a
measurement; roofline units and the unjoinable series; the SLO math; a
single-flight profiler capture with its trace file; and a live port
server's /debug/costs, /metrics and /debug/profile.
"""

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import pytest
import torch

from distributed_llama_tpu.formats.mfile import ArchType, FloatType
from distributed_llama_tpu.runtime import profiling as j_prof
from distributed_llama_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llama_tpu.testing import tiny_header, write_tiny_model, write_tiny_tokenizer
from distributed_llama_tpu_torch.cli import build_arg_parser
from distributed_llama_tpu_torch.runtime import profiling
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
from distributed_llama_tpu_torch.runtime.profiling import CostEntry, CostTable
from distributed_llama_tpu_torch.runtime.telemetry import StepStats, _tree_bytes
from distributed_llama_tpu_torch.server import api as p_api

F32_KW = dict(compute_dtype="float32", decode_chunk_size=4, max_chunk=8, prefix_cache_mb=0,
              speculative="off")


@pytest.fixture(scope="module")
def f32_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pprof") / "m.m")
    write_tiny_model(path, tiny_header(seq_len=64, weight_type=FloatType.F32), seed=7)
    return path


@pytest.fixture(scope="module")
def f32_engine(f32_path):
    eng = InferenceEngine(f32_path, device="cpu", **F32_KW)
    yield eng
    eng.close()


def _matmul_elems(h) -> int:
    qd = h.n_heads * h.head_dim
    kvd = h.n_kv_heads * h.head_dim
    per_layer = h.dim * qd + 2 * h.dim * kvd + qd * h.dim + 3 * h.dim * h.hidden_dim
    return h.n_layers * per_layer + h.dim * h.vocab_size


def _entry(**kw):
    base = dict(kind="decode", size=4, kv_len=64, flops=0.0, bytes_accessed=0.0,
                kernel_flops=0.0, kernel_bytes=0.0, kernel_calls={}, tokens=4)
    return CostEntry(**dict(base, **kw))


def test_decode_flops_analytic(f32_engine):
    """One decode dispatch's FLOPs ~= 2 * matmul params * tokens: a 4-step
    chunk counts 4 steps (the one-step graph times its replays)."""
    table = profiling.build_cost_table(f32_engine, plan=[("decode", 4, 16)])
    assert not table.failures
    e = table.entries[("decode", 4, 16)]
    tokens = f32_engine.batch * 4
    assert e.tokens == tokens
    ratio = e.flops / (2.0 * _matmul_elems(f32_engine.header) * tokens)
    assert 1.0 <= ratio <= 1.5, f"census/analytic FLOP ratio {ratio:.3f}"


def test_kv_bytes_scale_with_bucket(f32_engine):
    table = profiling.build_cost_table(f32_engine, plan=[("decode", 4, 16), ("decode", 4, 64)])
    assert not table.failures
    h = f32_engine.header
    e16, e64 = table.entries[("decode", 4, 16)], table.entries[("decode", 4, 64)]
    assert e64.bytes_accessed > e16.bytes_accessed
    itemsize = f32_engine.cache.k.element_size()
    expected = (4 * h.n_layers * (64 - 16) * h.n_kv_heads * h.head_dim * 2 * itemsize
                ) * f32_engine.batch
    ratio = (e64.bytes_accessed - e16.bytes_accessed) / expected
    assert 0.8 <= ratio <= 3.0, f"kv byte-delta ratio {ratio:.3f}"


_ARGS = [
    dict(F32_KW),
    dict(F32_KW, batch=2, speculative="ngram"),
    dict(F32_KW, prefix_cache_mb=64, batch=2),
    dict(F32_KW, kv_layout="paged", prefix_cache_mb=64, batch=2, speculative="ngram"),
    dict(F32_KW, kv_layout="paged", cache_dtype="int8", prefix_cache_mb=64),
    dict(F32_KW, device_decode=False, batch=2),
]
_IDS = ["plain", "batch2-ngram", "contiguous-prefix", "paged-prefix-ngram", "paged-int8",
        "host-decode"]


@pytest.mark.parametrize("kw", _ARGS, ids=_IDS)
def test_cost_plan_equals_jax_warm_plan(f32_path, kw):
    je = JEngine(f32_path, **kw)
    pe = InferenceEngine(f32_path, device="cpu", **kw)
    try:
        assert pe.cost_plan() == je.warm_plan()
        # the graphed ladder is the decode and verify part of it
        assert set(pe.warm_plan()) <= set(pe.cost_plan())
    finally:
        je.close()
        pe.close()


_MODEL_KINDS = ("prefill", "prefill_row", "decode", "batch_decode", "verify", "verify_row")


@pytest.mark.parametrize("kw", [_ARGS[1], _ARGS[3]], ids=[_IDS[1], _IDS[3]])
def test_flops_per_key_against_jax(f32_path, kw):
    je = JEngine(f32_path, **kw)
    pe = InferenceEngine(f32_path, device="cpu", **kw)
    try:
        jt = j_prof.build_cost_table(je)
        pt = profiling.build_cost_table(pe)
        assert not jt.failures and not pt.failures
        assert set(pt.entries) == set(jt.entries)
        for key, je_ in jt.entries.items():
            pe_ = pt.entries[key]
            assert pe_.tokens == je_.tokens, key
            if key[0] in _MODEL_KINDS:
                assert 0.8 <= pe_.flops / je_.flops <= 1.2, (key, pe_.flops, je_.flops)
            else:
                assert pe_.flops == 0.0, key  # data movement
                assert pe_.bytes_accessed > 0, key
    finally:
        je.close()
        pe.close()


@pytest.mark.parametrize("kw", [dict(kv_layout="contiguous"),
                                dict(kv_layout="paged", cache_dtype="int8")],
                         ids=["contiguous-bf16", "paged-int8"])
def test_bf16_census_counts_the_kernel_wrappers(tmp_path, kw):
    """On the bf16 path the matmuls and attention go through the kernel
    wrappers, which state their cost on meta tensors: a decode step's
    kernel FLOPs are exactly 2 x the matmul weights (plus K5's QK and PV
    over the pages read on the int8 arm), a prefill chunk's calls are K2
    and K3 a layer, and the real engine runs no wrapper meanwhile."""
    from distributed_llama_tpu_torch.ops import cuda_attention, cuda_q40

    path = str(tmp_path / "q.m")
    hk = dict(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=512,
              seq_len=512)
    write_tiny_model(path, tiny_header(**hk), seed=3)
    eng = InferenceEngine(path, device="cpu", compute_dtype="bfloat16", prefix_cache_mb=0,
                          speculative="off", **kw)
    try:
        before = [k.launches for k in (*cuda_q40.KERNELS, *cuda_attention.KERNELS)]
        table = profiling.build_cost_table(eng, plan=[("decode", 1, 256), ("prefill", 32, 256)])
        assert not table.failures, table.failures
        assert [k.launches for k in (*cuda_q40.KERNELS, *cuda_attention.KERNELS)] == before
        h, L = eng.header, hk["n_layers"]
        dec = table.entries[("decode", 1, 256)]
        attn = 0
        if kw.get("cache_dtype") == "int8":
            assert dec.kernel_calls["paged_flash_attention"] == L
            attn = 4.0 * h.n_heads * h.head_dim * 256 * L
        assert dec.kernel_calls["q40_gemv_q80_stacked"] == 4 * L
        assert dec.kernel_calls["q40_gemv_q80"] == 1
        assert dec.kernel_flops == 2.0 * _matmul_elems(h) + attn
        assert dec.kernel_flops < dec.flops and dec.kernel_bytes < dec.bytes_accessed
        pre = table.entries[("prefill", 32, 256)]
        assert pre.kernel_calls["q40_gemm_bf16_stacked"] == 4 * L
        assert pre.kernel_calls["flash_attention"] == L
    finally:
        eng.close()


def test_table_build_leaves_the_engine_as_it_was(f32_path):
    eng = InferenceEngine(f32_path, device="cpu", **dict(F32_KW, kv_layout="paged",
                                                         prefix_cache_mb=64, batch=2))
    try:
        eng.generate([1, 2, 3, 4, 5] * 4, 30, sampler=None, on_token=lambda t: None)
        before = ([t.clone() for t in eng.cache.tensors()], eng.page_pool.refs.copy(),
                  eng.page_pool.tables.copy(), eng.prefix_cache.n_entries,
                  eng.stats.counters_snapshot(), eng.graph_stats()["captures"])
        assert eng.cost_table(build=False) is None
        table = eng.cost_table()
        assert table is eng.cost_table() and not table.partial and not table.failures
        assert profiling.cost_problems(eng, table) == []
        after = ([t.clone() for t in eng.cache.tensors()], eng.page_pool.refs.copy(),
                 eng.page_pool.tables.copy(), eng.prefix_cache.n_entries,
                 eng.stats.counters_snapshot(), eng.graph_stats()["captures"])
        assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
        assert (before[1] == after[1]).all() and (before[2] == after[2]).all()
        assert before[3:] == after[3:]
    finally:
        eng.close()


def test_lookup_takes_the_shallowest_bucket():
    deep = CostTable({("decode", 4, 64): _entry(kv_len=64, flops=1),
                      ("decode", 4, 16): _entry(kv_len=16, flops=2)}, {})
    assert deep.lookup("decode", 4).kv_len == 16
    assert deep.lookup("decode", 99) is None


def test_missing_entry_fails_coverage(f32_engine, monkeypatch):
    real = profiling.census_entry

    def breaks_on_decode(engine, key, meta=None):
        if key[0] == "decode":
            raise RuntimeError("planted: no census for this kind")
        return real(engine, key, meta)

    monkeypatch.setattr(profiling, "census_entry", breaks_on_decode)
    table = profiling.build_cost_table(f32_engine)
    assert table.failures
    problems = profiling.cost_problems(f32_engine, table)
    assert problems and any("decode" in p and "planted" in p for p in problems)
    snap = table.snapshot(f32_engine.cost_plan())
    assert not snap["coverage"]["complete"] and snap["failures"]


# ---- HBM ledger -------------------------------------------------------------


def test_hbm_ledger_components(f32_engine):
    led = profiling.hbm_ledger(f32_engine)
    comp = led["components"]
    assert comp["weights"] == _tree_bytes(f32_engine.params) > 0
    assert comp["rope"] == _tree_bytes(f32_engine.rope) > 0
    assert comp["kv_cache"] == _tree_bytes(f32_engine.cache) > 0
    assert led["modeled_bytes"] == sum(comp.values())
    assert "prefix_cache" not in comp
    assert led["measured_bytes"] is None  # the CPU reports nothing
    assert comp["kv_cache"] == sum(t.numel() * t.element_size() for t in f32_engine.cache.tensors())


def test_memory_report_equals_jax():
    import numpy as np

    from distributed_llama_tpu.runtime.telemetry import memory_report as j_report
    from distributed_llama_tpu_torch.runtime.telemetry import memory_report

    for n in (1000, 3_000_000, 60_000_000):
        params = {"w": np.zeros(n, np.float32), "b": [np.zeros(7, np.int8)]}
        cache = {"k": np.zeros((2, n // 10), np.float16)}
        p_params = {"w": torch.zeros(n), "b": [torch.zeros(7, dtype=torch.int8)]}
        p_cache = {"k": torch.zeros((2, n // 10), dtype=torch.float16)}
        assert memory_report(p_params, p_cache) == j_report(params, cache)


def test_hbm_reconcile_drift_counter(f32_engine, monkeypatch):
    mb = 1024 * 1024
    measured = [0]
    monkeypatch.setattr(profiling, "_device_memory_stats", lambda e: {
        "bytes_in_use": measured[0], "bytes_limit": 1 << 30, "bytes_free": (1 << 30) - measured[0]})
    monkeypatch.setenv("DLT_HBM_DRIFT_MB", "1")
    monkeypatch.setattr(f32_engine, "_hbm_drift_base", None, raising=False)
    modeled = profiling.hbm_ledger(f32_engine)["modeled_bytes"]
    before = f32_engine.stats.counters_snapshot().get("hbm_drift_events", 0)
    measured[0] = modeled + 10 * mb
    assert profiling.reconcile_hbm(f32_engine) == {"drift_bytes": 0, "tripped": False}
    measured[0] += 3 * mb
    r = profiling.reconcile_hbm(f32_engine)
    assert r["tripped"] and r["drift_bytes"] == 3 * mb
    assert f32_engine.stats.counters_snapshot()["hbm_drift_events"] == before + 1
    assert not profiling.reconcile_hbm(f32_engine)["tripped"]
    measured[0] -= 5 * mb
    assert not profiling.reconcile_hbm(f32_engine)["tripped"]
    measured[0] += 3 * mb
    assert profiling.reconcile_hbm(f32_engine)["tripped"]
    led = profiling.hbm_ledger(f32_engine)
    assert led["measured_bytes"] == measured[0]
    assert led["headroom_bytes"] == (1 << 30) - measured[0]
    assert led["unattributed_bytes"] == measured[0] - led["modeled_bytes"]
    gauges, series = profiling.metrics_view(f32_engine)
    assert "hbm_drift_bytes" in gauges and "hbm_headroom_bytes" in gauges
    assert ({"component": "unattributed"}, led["unattributed_bytes"]) in series["hbm_bytes"]


def test_reconcile_noop_without_measurement(f32_engine, monkeypatch):
    monkeypatch.setattr(profiling, "_device_memory_stats", lambda e: None)
    assert profiling.reconcile_hbm(f32_engine) == {"drift_bytes": 0, "tripped": False}


# ---- roofline / MFU / SLO ---------------------------------------------------


def test_peaks_are_the_h100_data_sheet(monkeypatch):
    monkeypatch.delenv("DLT_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("DLT_PEAK_HBM_GBS", raising=False)
    assert profiling.peak_flops() == 989.0e12
    assert profiling.peak_hbm_bytes_s() == 3350.0e9
    monkeypatch.setenv("DLT_PEAK_TFLOPS", "500")
    monkeypatch.setenv("DLT_PEAK_HBM_GBS", "junk")
    assert profiling.peak_flops() == 500.0e12
    assert profiling.peak_hbm_bytes_s() == 3350.0e9


def _roofline_twins(stats_fn, table_entries, monkeypatch):
    """The same walls and entries through both packages' roofline_view."""
    out = []
    for mod, make in ((j_prof, lambda e: j_prof.CostEntry(
            e.kind, e.size, e.kv_len, flops=e.flops, bytes_accessed=e.bytes_accessed,
            xla_body_flops=0, xla_body_bytes=0, arg_bytes=0, out_bytes=0, temp_bytes=0,
            alias_bytes=0, tokens=e.tokens)), (profiling, lambda e: e)):
        stats = stats_fn()
        eng = SimpleNamespace(stats=stats, _t_start=time.perf_counter() - 1.0)
        table = mod.CostTable({k: make(e) for k, e in table_entries.items()}, {})
        out.append(mod.roofline_view(eng, table))
    return out


def test_roofline_mfu_units(monkeypatch):
    monkeypatch.setenv("DLT_PEAK_TFLOPS", "1")
    monkeypatch.setenv("DLT_PEAK_HBM_GBS", "1000")

    def stats_fn():
        stats = StepStats()
        for _ in range(8):
            stats.record("decode[4]", 2000.0)
        return stats

    (jg, js), (gauges, series) = _roofline_twins(
        stats_fn, {("decode", 4, 64): _entry(flops=1e9, bytes_accessed=2e8)}, monkeypatch)
    assert gauges["mfu"] == pytest.approx(0.5, rel=0.01) == jg["mfu"]
    assert gauges["bw_utilization"] == pytest.approx(0.1, rel=0.01) == jg["bw_utilization"]
    assert gauges["device_duty_cycle"] == pytest.approx(0.016, rel=0.2)
    assert series == js
    (labels, gbs), = series["program_gb_s"]
    assert labels == {"program": "decode[4]"} and gbs == pytest.approx(100.0, rel=0.01)


def test_roofline_skips_unjoinable_series(monkeypatch):
    def stats_fn():
        stats = StepStats()
        stats.record("prefill_dispatch[8]", 1000.0)
        stats.record("prefill_sync", 500.0)
        stats.record("decode[4]", 1000.0)
        return stats

    (jg, js), (gauges, series) = _roofline_twins(stats_fn, {}, monkeypatch)
    assert "mfu" not in gauges and "program_gb_s" not in series and series == js
    assert gauges["device_duty_cycle"] == pytest.approx(0.0025, rel=0.2)
    assert gauges.keys() == jg.keys()


def test_slo_gauges_math(monkeypatch):
    from distributed_llama_tpu.runtime.telemetry import StepStats as JStepStats

    monkeypatch.setenv("DLT_SLO_TTFT_MS", "16")
    monkeypatch.setenv("DLT_SLO_TPOT_MS", "8")
    got = []
    for mod, cls in ((j_prof, JStepStats), (profiling, StepStats)):
        stats = cls()
        for v in (10.0, 12.0, 14.0, 5000.0):
            stats.observe("ttft_ms", v)
            stats.observe("ttft_ms", v, labels={"slo_class": "interactive"})
        for v in (4.0, 6.0, 900.0, 900.0):
            stats.observe("tpot_ms", v)
        got.append((mod.slo_gauges(stats), mod.slo_class_series(stats)))
    (jg, jc), (g, c) = got
    assert g == jg and c == jc
    assert g["slo_ttft_attainment"] == pytest.approx(0.75) and g["slo_ttft_target_ms"] == 16.0
    assert g["slo_tpot_attainment"] == pytest.approx(0.5)
    assert c["slo_ttft_attainment"] == [({"slo_class": "interactive"}, 0.75)]
    assert profiling.slo_gauges(StepStats()) == {}


# ---- on-demand capture --------------------------------------------------------


def test_profile_capture_single_flight_and_artifacts(tmp_path, monkeypatch):
    monkeypatch.setenv("DLT_PROFILE_DIR", str(tmp_path))
    cap = profiling.ProfilerCapture()
    out: dict = {}
    errors: list = []

    def bg():
        try:
            # something to record beside the window
            out.update(cap.capture(400))
        except Exception as e:
            errors.append(e)

    t = threading.Thread(target=bg, daemon=True)
    t.start()
    time.sleep(0.1)
    with pytest.raises(profiling.ProfileBusy):
        cap.capture(10)
    x = torch.ones(64, 64)
    for _ in range(10):
        x = x @ x / 64
    t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    assert set(out) == {"path", "requested_ms", "wall_ms", "files", "perfetto_trace"}
    assert out["path"].startswith(str(tmp_path)) and out["files"] == ["trace.json"]
    assert out["wall_ms"] >= out["requested_ms"] == 400
    with open(out["perfetto_trace"]) as f:
        assert "traceEvents" in json.load(f)
    r2 = cap.capture(profiling.ProfilerCapture.MIN_MS)
    assert r2["path"] != out["path"]


# ---- a live port server ---------------------------------------------------------


@pytest.fixture(scope="module")
def prof_server(tmp_path_factory):
    d = tmp_path_factory.mktemp("pprofsrv")
    h = tiny_header(arch=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2, seq_len=128,
                    vocab_size=288)
    mp, tp = str(d / "m.m"), str(d / "t.t")
    write_tiny_model(mp, h, seed=3)
    write_tiny_tokenizer(tp, pad_to=288,
                         chat_template="{% for m in messages %}<|im_start|>...{% endfor %}")
    p = build_arg_parser()
    p.add_argument("--port", type=int, default=0)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    os.environ.pop("DLT_NO_WARMUP", None)
    httpd = p_api.serve(p.parse_args(
        ["inference", "--model", mp, "--tokenizer", tp, "--compute-dtype", "float32",
         "--temperature", "0.0", "--device", "cpu", "--port", str(port)]))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield port, httpd
    httpd.shutdown()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_debug_costs_endpoint_covers_ladder(prof_server):
    port, httpd = prof_server
    engine = httpd.api_state.engine
    # serve() built the table after warmup
    assert engine.cost_table(build=False) is not None
    st, body = _get(port, "/debug/costs")
    assert st == 200
    snap = json.loads(body)
    assert snap["coverage"]["complete"], snap["coverage"]
    assert snap["n_entries"] == snap["coverage"]["plan_size"] == len(engine.cost_plan()) > 0
    assert not snap.get("failures")
    assert {e["kind"] for e in snap["entries"]} == {k for k, _, _ in engine.cost_plan()}
    for k in ("kind", "size", "kv_len", "flops", "bytes_accessed", "flops_per_token",
              "bytes_per_token", "kernel_calls"):
        assert k in snap["entries"][0]
    assert snap["peak_tflops"] == 989.0 and snap["peak_hbm_gb_s"] == 3350.0


def test_metrics_exposes_device_gauges(prof_server):
    port, _ = prof_server
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps({"messages": [{"role": "user", "content": "hi"}],
                         "max_tokens": 8}).encode(),
        headers={"Content-Type": "application/json"})
    urllib.request.urlopen(req, timeout=120).read()
    st, body = _get(port, "/metrics")
    assert st == 200
    for name in ('dlt_hbm_bytes{component="weights"}', 'dlt_hbm_bytes{component="kv_cache"}',
                 "dlt_hbm_modeled_bytes", "dlt_mfu ", "dlt_bw_utilization ",
                 "dlt_device_duty_cycle ", "dlt_slo_ttft_attainment ",
                 "dlt_slo_tpot_attainment ", "dlt_program_gb_s{program="):
        assert name in body, name
    for line in body.splitlines():
        for share in ("dlt_mfu ", "dlt_bw_utilization ", "dlt_device_duty_cycle "):
            if line.startswith(share):
                assert 0.0 <= float(line.split()[-1]) <= 1.0, line


def test_debug_profile_endpoint(prof_server, tmp_path, monkeypatch):
    monkeypatch.setenv("DLT_PROFILE_DIR", str(tmp_path))
    port, _ = prof_server
    st, body = _get(port, "/debug/profile?ms=40")
    assert st == 200
    rec = json.loads(body)
    assert os.path.isdir(rec["path"]) and rec["files"] and rec["requested_ms"] == 40
    assert _get(port, "/debug/profile?ms=bogus")[0] == 400
