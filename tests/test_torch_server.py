"""The port's OpenAI-compatible server held against the JAX server, over
localhost on the CPU.

Both servers run in this process on the tiny model of tests/test_server.py
(dim 64, 2 layers, vocab 288, seed 3, the byte tokenizer with the CHATML
template) at f32 and temperature 0, with the CLI's defaults (paged KV,
ngram speculation, the prefix cache, the grammar arena), at batch 1 (the
serialized path) and batch 2 (the Batcher). Each test sends both the same
requests and compares what comes back: greedy content non-stream and SSE
chunk by chunk, constrained content, the 4xx and 5xx answers and the
recovery after an engine failure, the key sets of the views, the answers
of the KV movement routes of a unified, untiered replica, and the
/metrics series names, which are equal. The JAX gateway fronting a port
replica streams what
it streams fronting a JAX one. A seeded sampled request is held to
reproducibility within the port only: its row's stream is the port's own.
"""

import json
import os
import re
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from distributed_llama_tpu.cli import build_arg_parser as j_build_arg_parser
from distributed_llama_tpu.formats.mfile import ArchType
from distributed_llama_tpu.runtime import batch_session as j_batch_session
from distributed_llama_tpu.runtime.profiling import metrics_view
from distributed_llama_tpu.server import api as j_api
from distributed_llama_tpu.server import gateway as gw_mod
from distributed_llama_tpu.testing import tiny_header, write_tiny_model, write_tiny_tokenizer
from distributed_llama_tpu_torch.cli import build_arg_parser as p_build_arg_parser
from distributed_llama_tpu_torch.runtime import batch_session as p_batch_session
from distributed_llama_tpu_torch.server import api as p_api

CHATML = "{% for m in messages %}<|im_start|>...{% endfor %}"
BOOL_SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}}, "required": ["ok"]}
RF_SCHEMA = {"type": "json_schema", "json_schema": {"name": "t", "schema": BOOL_SCHEMA}}
RF_REGEX = {"type": "regex", "regex": "(?:yes|no)"}

PROMPTS = (
    [{"role": "user", "content": "hello"}],
    [{"role": "system", "content": "you are a terse assistant that answers"},
     {"role": "user", "content": "name a colour"}],
    [{"role": "user", "content": "count: one two three four"}],
)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("tsrv")
    h = tiny_header(
        arch=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2, seq_len=256, vocab_size=288
    )
    mp, tp = str(d / "m.m"), str(d / "t.t")
    write_tiny_model(mp, h, seed=3)
    write_tiny_tokenizer(tp, pad_to=288, chat_template=CHATML)
    return mp, tp


def _start(api_mod, parser, argv):
    p = parser()
    p.add_argument("--port", type=int, default=0)
    port = _free_port()
    httpd = api_mod.serve(p.parse_args(argv + ["--port", str(port)]))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return port, httpd


class Pair:
    """A JAX server and a port server on the same model and flags."""

    def __init__(self, paths, batch):
        mp, tp = paths
        argv = ["inference", "--model", mp, "--tokenizer", tp, "--compute-dtype", "float32",
                "--temperature", "0.0", "--batch", str(batch)]
        self.batch = batch
        self.jport, self.jhttpd = _start(j_api, j_build_arg_parser, argv)
        self.pport, self.phttpd = _start(p_api, p_build_arg_parser, argv + ["--device", "cpu"])

    @property
    def ports(self):
        return self.jport, self.pport

    @property
    def states(self):
        return self.jhttpd.api_state, self.phttpd.api_state

    def close(self):
        self.jhttpd.shutdown()
        self.phttpd.shutdown()


@pytest.fixture(scope="module", params=[1, 2], ids=["batch1", "batch2"])
def pair(request, paths):
    # the JAX server compiles lazily: its warmup (at start and in every
    # rebuild) would compile the whole ladder on the CPU and changes no
    # result; the port's captures nothing on the CPU either way
    os.environ["DLT_NO_WARMUP"] = "1"
    pr = Pair(paths, request.param)
    try:
        yield pr
    finally:
        pr.close()
        os.environ.pop("DLT_NO_WARMUP", None)


def _post(port, payload, path="/v1/chat/completions", headers=None, raw=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=raw if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    return urllib.request.urlopen(req, timeout=120)


def _chat(port, payload):
    with _post(port, payload) as r:
        return json.loads(r.read())


def _sse(port, payload):
    with _post(port, dict(payload, stream=True)) as r:
        raw = r.read().decode()
    return [e for e in raw.split("\r\n\r\n") if e.strip()]


def _status(port, payload=None, path="/v1/chat/completions", raw=None):
    try:
        with _post(port, payload, path=path, raw=raw) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait_serving(port, timeout_s=60.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        code, body = _get(port, "/health")
        if code == 200:
            return json.loads(body)
        time.sleep(0.05)
    raise AssertionError(f"replica on {port} did not rejoin in {timeout_s} s")


def test_greedy_content_non_stream(pair):
    for msgs in PROMPTS:
        out = [_chat(p, {"messages": msgs, "max_tokens": 12}) for p in pair.ports]
        j, p = (o["choices"][0]["message"] for o in out)
        assert p == j, msgs
        assert out[1]["usage"]["prompt_tokens"] == out[0]["usage"]["prompt_tokens"]
        assert out[1]["usage"]["completion_tokens"] == out[0]["usage"]["completion_tokens"] > 0
        # the goodput ledger rides the usage block under the JAX keys
        assert set(out[1]["usage"]["goodput"]) == set(out[0]["usage"]["goodput"])


def test_greedy_sse_chunk_by_chunk(pair):
    for msgs in PROMPTS[:2]:
        j, p = (_sse(port, {"messages": msgs, "max_tokens": 10}) for port in pair.ports)
        assert p == j
        assert p[-1].strip() == "data: [DONE]"
        last = json.loads(p[-2][len("data: "):])
        assert last["choices"][0]["finish_reason"] == "stop"


def test_response_format(pair):
    for rf in (RF_SCHEMA, RF_REGEX):
        body = {"messages": [{"role": "user", "content": "emit the answer"}],
                "max_tokens": 24, "response_format": rf}
        j, p = (_chat(port, body)["choices"][0]["message"]["content"] for port in pair.ports)
        assert p == j
        if rf is RF_SCHEMA:
            assert isinstance(json.loads(p)["ok"], bool)
        else:
            assert p in ("yes", "no")
        j, p = (_sse(port, body) for port in pair.ports)
        assert p == j
    # what neither grammar compiler takes is a 400 on both, before any
    # engine work (json_object and a malformed regex)
    for rf in ({"type": "json_object"}, {"type": "regex"}):
        body = {"messages": [{"role": "user", "content": "x"}], "response_format": rf}
        assert [_status(port, body)[0] for port in pair.ports] == [400, 400]


def test_client_errors_are_400(pair):
    long_msg = "x " * 400  # tokenizes past seq_len=256
    cases = [
        dict(raw=b"{not json"),
        dict(payload={"nope": 1}),
        dict(payload={"messages": [{"role": "user", "content": long_msg}]}),
        dict(payload={"messages": [{"role": "user", "content": long_msg}], "stream": True}),
    ]
    for kw in cases:
        j, p = (_status(port, **kw) for port in pair.ports)
        assert p[0] == j[0] == 400, kw
        assert json.loads(p[1]).keys() == json.loads(j[1]).keys()


def test_unported_routes(pair, tmp_path, monkeypatch):
    """The routes a unified, untiered replica does not serve answer as the
    JAX server's: /v1/prefill and /v1/kv_fetch 404 with its bodies;
    /debug/costs 200 with full coverage of the JAX engine's warm ladder
    (its keys exactly: the JAX server would compile the whole ladder to
    answer, so its table is held to it in tests/test_torch_profiling.py),
    and /debug/profile 200 with the same record keys and 400 on a bad
    window."""
    for path in ("/v1/prefill", "/v1/kv_fetch"):
        j, p = (_status(port, {"ids": [1, 2, 3]}, path=path) for port in pair.ports)
        assert p == j and p[0] == 404
    engine = pair.states[1].engine
    try:
        code, body = _get(pair.pport, "/debug/costs")
    finally:
        # the JAX server here has no table either (DLT_NO_WARMUP): keep the
        # pair's /metrics alike for the tests after this one
        engine._cost_table = None
    assert code == 200
    p = json.loads(body)
    ladder = pair.states[0].engine.warm_plan()
    assert p["coverage"]["complete"] and p["coverage"]["plan_size"] == len(ladder)
    assert sorted((e["kind"], e["size"], e["kv_len"]) for e in p["entries"]) == sorted(ladder)
    monkeypatch.setenv("DLT_PROFILE_DIR", str(tmp_path))
    recs = []
    for port in pair.ports:
        code, body = _get(port, "/debug/profile?ms=20")
        assert code == 200
        recs.append(json.loads(body))
        assert _get(port, "/debug/profile?ms=x")[0] == 400
    assert recs[1].keys() == recs[0].keys()


def _view_keys(port):
    out = {}
    for path in ("/health", "/stats", "/debug/config"):
        code, body = _get(port, path)
        assert code == 200, path
        out[path] = json.loads(body)
    return out


def test_view_key_sets(pair):
    _chat(pair.jport, {"messages": PROMPTS[0], "max_tokens": 4})
    _chat(pair.pport, {"messages": PROMPTS[0], "max_tokens": 4})
    j, p = _view_keys(pair.jport), _view_keys(pair.pport)
    assert p["/health"].keys() == j["/health"].keys()
    assert p["/health"]["supervisor"].keys() == j["/health"]["supervisor"].keys()
    # one section more: the engine's CUDA-graph counters
    assert p["/stats"].keys() == j["/stats"].keys() | {"graphs"}
    assert p["/stats"]["graphs"]["recaptures_after_warmup"] == 0
    for sec in ("kv_pool", "prefix_cache", "speculative", "goodput", "supervisor"):
        assert p["/stats"][sec].keys() == j["/stats"][sec].keys(), sec
    assert (p["/stats"]["batcher"] is None) == (j["/stats"]["batcher"] is None)
    if pair.batch > 1:
        assert p["/stats"]["batcher"].keys() == j["/stats"]["batcher"].keys()
    assert p["/debug/config"].keys() == j["/debug/config"].keys()
    for sec in ("engine", "kv", "speculative", "tracing", "quarantine"):
        assert p["/debug/config"][sec].keys() == j["/debug/config"][sec].keys(), sec
    assert p["/debug/config"]["role"] == j["/debug/config"]["role"] == "unified"
    for path in ("/debug/batch_timeline", "/debug/quarantine", "/debug/hot_prefixes"):
        j, p = (json.loads(_get(port, path)[1]) for port in pair.ports)
        assert p.keys() == j.keys(), path
    # the chain keys of the same messages, byte for byte, with their hits
    # and their tokenized footprint
    j, p = (json.loads(_get(port, "/debug/hot_prefixes")[1]) for port in pair.ports)
    assert p["chains"] and p == j


_TYPE_RE = re.compile(r"^# TYPE (\S+) ", re.M)


def test_metrics_differ_by_the_profiling_set(pair):
    """The /metrics `# TYPE` names of the port equal the JAX server's,
    the profiling set (runtime/profiling.py metrics_view) included."""
    for port in pair.ports:
        _chat(port, {"messages": PROMPTS[1], "max_tokens": 6})
    j, p = (_get(port, "/metrics") for port in pair.ports)
    assert p[0] == j[0] == 200
    jnames, pnames = (set(_TYPE_RE.findall(body.decode())) for _, body in (j, p))
    gauges, series = metrics_view(pair.states[0].engine)
    profiling = {f"dlt_{k}" for k in (*gauges, *series)}
    assert profiling and profiling <= pnames
    assert pnames == jnames
    for name in ("dlt_ttft_ms", "dlt_requests_completed_total", "dlt_hbm_bytes",
                 "dlt_hbm_modeled_bytes", "dlt_slo_ttft_attainment"):
        assert name in pnames


def _poison(monkeypatch, pair):
    """Make the next engine call of each server fail: batch 1 through
    generate (the serialized path), batch 2 through its BatchSession's
    chunk and verify round (the Batcher loop)."""
    def boom(*a, **k):
        raise RuntimeError("injected engine failure")

    if pair.batch == 1:
        for st in pair.states:
            monkeypatch.setattr(st.engine, "generate", boom)
    else:
        for mod in (j_batch_session, p_batch_session):
            monkeypatch.setattr(mod.BatchSession, "step", boom)
            monkeypatch.setattr(mod.BatchSession, "spec_step", boom)


def test_engine_failure_500_then_recover(pair, monkeypatch):
    body = {"messages": [{"role": "user", "content": "again and again"}], "max_tokens": 8}
    before = [_chat(port, body)["choices"][0]["message"] for port in pair.ports]
    assert before[1] == before[0]
    engines = [st.engine for st in pair.states]
    with monkeypatch.context() as m:
        _poison(m, pair)
        j, p = (_status(port, body) for port in pair.ports)
    assert p[0] == j[0] == 500
    assert b"engine error" in p[1]
    for port, st, eng in zip(pair.ports, pair.states, engines):
        health = _wait_serving(port)
        assert health["supervisor"]["rebuilds_total"] >= 1
        assert st.engine is not eng  # rebuilt: fresh engine, empty prefix cache
    assert engines[1].closed  # the port closes the old engine first
    after = [_chat(port, body)["choices"][0]["message"] for port in pair.ports]
    assert after == before


def test_seeded_sampled_reproducible_under_concurrency(pair):
    port = pair.pport
    body = {"messages": [{"role": "user", "content": "tell a tale"}], "max_tokens": 12,
            "temperature": 0.9, "top_p": 0.9, "seed": 1234}
    alone = _chat(port, body)["choices"][0]["message"]["content"]
    out = {}

    def run(key, b):
        out[key] = _chat(port, b)["choices"][0]["message"]["content"]

    threads = [threading.Thread(target=run, args=("seeded", body)),
               threading.Thread(target=run, args=("other", dict(body, seed=99)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out["seeded"] == alone


def test_trace_id_round_trip(pair):
    with _post(pair.pport, {"messages": PROMPTS[0], "max_tokens": 4}) as r:
        tid = r.headers["X-DLT-Trace-Id"]
        r.read()
    code, body = _get(pair.pport, f"/debug/trace?id={tid}")
    assert code == 200
    names = {e["name"] for e in json.loads(body)["events"]}
    assert {"request", "ledger"} <= names


def test_gateway_streams_the_same_through_either_backend(pair):
    """The JAX gateway fronting a port replica streams the bytes it
    streams fronting the JAX replica."""
    body = {"messages": PROMPTS[1], "max_tokens": 8, "stream": True}
    got = []
    for backend in pair.ports:
        gw_port = _free_port()
        cfg = gw_mod.GatewayConfig(
            backends=[gw_mod.Backend("127.0.0.1", backend)],
            probe_interval_s=0, fleet_scrape_s=0,
        )
        stop = threading.Event()
        t = threading.Thread(target=gw_mod.run, args=(gw_port, gw_mod.Balancer(cfg), stop),
                             daemon=True)
        t.start()
        try:
            for _ in range(100):  # the gateway binds on its own thread
                try:
                    socket.create_connection(("127.0.0.1", gw_port), timeout=1).close()
                    break
                except OSError:
                    time.sleep(0.05)
            got.append(_sse(gw_port, body))
        finally:
            stop.set()
            t.join(timeout=10)
    assert got[1] == got[0]
    assert got[1][-1].strip() == "data: [DONE]"
