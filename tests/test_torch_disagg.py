"""The port's prefill/decode disaggregation held to the JAX package's, on
the CPU (the twins of tests/test_disagg.py, tests/test_kv_transport.py's
serving stack and tests/test_kv_integrity.py's chaos cases).

One tiny model, f32, greedy. The port runs a prefill worker, a decode
worker peered at it (the same-process device path: ``auto`` takes it),
and a unified server; the JAX package runs a prefill and a decode worker
likewise. Each request goes to the port's decode worker, its unified
server and JAX's decode worker, and the answers are equal, on the device
path and on the HTTP path (``DLT_KV_TRANSPORT=http``), with JAX's counter
deltas. A growing prefix ships only its missing pages; a mid-stream kill
(the JAX chaos proxy in front of the port's worker), a peer that is down,
and every device-path fault (a raise and each corrupt mode) degrade to
local prefill with equal tokens; the role and endpoint contracts (the
4xx answers, /stats and /debug/config) equal JAX's.
"""

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from distributed_llama_tpu.cli import build_arg_parser as j_parser
from distributed_llama_tpu.formats.mfile import ArchType
from distributed_llama_tpu.runtime import kv_transport as j_kvt
from distributed_llama_tpu.server import api as j_api
from distributed_llama_tpu.server import disagg as j_disagg
from distributed_llama_tpu.server.chaos import MIDSTREAM_RESET, ChaosProxy, Fault, FaultPlan
from distributed_llama_tpu.testing import tiny_header, write_tiny_model, write_tiny_tokenizer
from distributed_llama_tpu_torch.cli import build_arg_parser as p_parser
from distributed_llama_tpu_torch.runtime import kv_transport as p_kvt
from distributed_llama_tpu_torch.server import api as p_api
from distributed_llama_tpu_torch.server import disagg as p_disagg

CHATML = "{% for m in messages %}<|im_start|>...{% endfor %}"


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Stack:
    def __init__(self, d):
        h = tiny_header(arch=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2, seq_len=512,
                        vocab_size=288)
        mp, tp = str(d / "m.m"), str(d / "t.t")
        write_tiny_model(mp, h, seed=3)
        write_tiny_tokenizer(tp, pad_to=288, chat_template=CHATML)
        self.servers = []

        def start(api_mod, parser, extra):
            p = parser()
            p.add_argument("--port", type=int, default=0)
            port = _free_port()
            httpd = api_mod.serve(p.parse_args(
                ["inference", "--model", mp, "--tokenizer", tp, "--compute-dtype", "float32",
                 "--temperature", "0.0", "--port", str(port)] + extra))
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            self.servers.append(httpd)
            return port, httpd

        cpu = ["--device", "cpu"]
        self.pf_port, self.pf = start(p_api, p_parser, cpu + ["--role", "prefill"])
        self.dec_port, self.dec = start(
            p_api, p_parser, cpu + ["--role", "decode", "--prefill-peer", f"127.0.0.1:{self.pf_port}"])
        self.uni_port, self.uni = start(p_api, p_parser, cpu)
        self.jpf_port, self.jpf = start(j_api, j_parser, ["--role", "prefill"])
        self.jdec_port, self.jdec = start(
            j_api, j_parser, ["--role", "decode", "--prefill-peer", f"127.0.0.1:{self.jpf_port}"])
        # the chaos proxy in front of the port's prefill worker (HTTP only)
        self.proxy = ChaosProxy("127.0.0.1", self.pf_port, FaultPlan()).start()

    @property
    def state(self):
        return self.dec.api_state

    def stop(self):
        self.proxy.stop()
        for s in self.servers:
            s.shutdown()


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    os.environ["DLT_NO_WARMUP"] = "1"
    try:
        st = Stack(tmp_path_factory.mktemp("pdisagg"))
        yield st
        st.stop()
    finally:
        os.environ.pop("DLT_NO_WARMUP", None)


def _ask(port, system, user, max_tokens=8, trace_id=None):
    headers = {"Content-Type": "application/json"}
    if trace_id:
        headers["X-DLT-Trace-Id"] = trace_id
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps({"messages": [{"role": "system", "content": system},
                                      {"role": "user", "content": user}],
                         "max_tokens": max_tokens}).encode(),
        headers=headers,
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


def _counters(port):
    return _get(port, "/stats")["steps"]["counters"]


def _content(r):
    return r["choices"][0]["message"]["content"]


_KEYS = ("disagg_kv_fetched", "disagg_kv_tokens", "disagg_local_hits", "disagg_pages_skipped",
         "disagg_degraded", "disagg_degraded_tokens", "kv_integrity_verified",
         "kv_integrity_rejected", "disagg_peer_errors", "disagg_peer_backoff_skips")


def _round(stack, system, user, ports=None):
    """Ask the port's decode worker, its unified server and JAX's decode
    worker; return (contents, the port's counter deltas, JAX's, the port's
    response)."""
    ports = ports or (stack.dec_port, stack.jdec_port)
    before = [_counters(p) for p in ports]
    r_dec = _ask(ports[0], system, user)
    r_uni = _ask(stack.uni_port, system, user)
    r_j = _ask(ports[1], system, user)
    after = [_counters(p) for p in ports]
    deltas = [{k: a.get(k, 0) - b.get(k, 0) for k in _KEYS} for a, b in zip(after, before)]
    return (_content(r_dec), _content(r_uni), _content(r_j)), deltas[0], deltas[1], r_dec


def test_device_path_equals_unified_and_jax(stack):
    snap = stack.state.disagg.snapshot()
    assert snap["transport"] == "auto"
    assert snap["peer_transports"] == {f"127.0.0.1:{stack.pf_port}": "device"}
    before = _counters(stack.dec_port)
    (dec, uni, jx), dp, dj, r = _round(stack, "device-path-prefix " * 7, "what is up")
    assert dec == uni == jx
    assert dp == dj and dp["disagg_kv_fetched"] == 1
    after = _counters(stack.dec_port)
    assert after.get("kv_transfer_bytes_device", 0) > before.get("kv_transfer_bytes_device", 0)
    assert after.get("kv_transfer_bytes_http", 0) == before.get("kv_transfer_bytes_http", 0)
    g = r["usage"]["goodput"]
    assert g["kv_transfer_path"] == "device" and g["remote_prefill_us"] > 0
    assert g["prefix_hit_tokens"] >= 16
    wc = _counters(stack.pf_port)
    assert wc["disagg_prefills"] >= 1 and wc["disagg_prefill_tokens"] >= 16
    with urllib.request.urlopen(f"http://127.0.0.1:{stack.dec_port}/metrics", timeout=30) as m:
        body = m.read().decode()
    assert 'dlt_kv_transfer_bytes_total{path="device"}' in body
    assert 'dlt_kv_transfer_us{path="device"' in body


def test_http_path_equals_unified_and_jax(stack, monkeypatch):
    monkeypatch.setenv("DLT_KV_TRANSPORT", "http")
    pst, jst = stack.state, stack.jdec.api_state
    old = (pst.disagg, jst.disagg)
    pst.disagg = p_disagg.DisaggClient(pst, old[0].peers)
    jst.disagg = j_disagg.DisaggClient(jst, old[1].peers)
    try:
        assert pst.disagg.snapshot()["peer_transports"] == {f"127.0.0.1:{stack.pf_port}": "http"}
        (dec, uni, jx), dp, dj, r = _round(stack, "http-forced-prefix " * 7, "over the wire")
        assert dec == uni == jx
        assert dp == dj and dp["disagg_kv_fetched"] == 1
        assert r["usage"]["goodput"]["kv_transfer_path"] == "http"
        assert _counters(stack.dec_port).get("kv_transfer_bytes_http", 0) > 0
    finally:
        pst.disagg, jst.disagg = old


def test_second_request_hits_local_cache_as_jax(stack):
    shared = "local-hit-prefix " * 9
    _round(stack, shared, "first")
    (dec, uni, jx), dp, dj, _ = _round(stack, shared, "second")
    assert dec == uni == jx
    assert dp == dj and dp["disagg_kv_fetched"] == 0 and dp["disagg_local_hits"] == 1


def test_growing_prefix_ships_only_missing_pages_as_jax(stack):
    base = "grow-prefix-content " * 8
    _round(stack, base, "first question")
    wc0 = _counters(stack.pf_port).get("disagg_send_pages_skipped", 0)
    (dec, uni, jx), dp, dj, r = _round(stack, base + "and now much more context " * 8, "second")
    assert dec == uni == jx
    assert dp == dj and dp["disagg_kv_fetched"] == 1 and dp["disagg_pages_skipped"] >= 1
    assert r["usage"]["goodput"]["kv_transfer_path"] == "device"
    assert _counters(stack.pf_port)["disagg_send_pages_skipped"] - wc0 == dp["disagg_pages_skipped"]


def _proxied_client(stack):
    st = stack.state
    old = st.disagg
    st.disagg = p_disagg.DisaggClient(st, [("127.0.0.1", stack.proxy.port)])
    return old


def test_midstream_kill_degrades_with_equal_tokens(stack):
    """The prefill worker dies mid-KV-body (the proxy resets the stream
    after 2000 response bytes): the request completes on local prefill,
    token-identical, counted, ledgered as transfer_retry and traced; the
    peer backs off, so the next request skips it."""
    st = stack.state
    old = _proxied_client(stack)
    stack.proxy.plan = FaultPlan(default=Fault(MIDSTREAM_RESET, after_bytes=2000))
    shared = "chaos-kill-prefix " * 9
    try:
        waste0 = _get(stack.dec_port, "/stats")["goodput"]["wasted_tokens"].get("transfer_retry", 0)
        before = _counters(stack.dec_port)
        r = _ask(stack.dec_port, shared, "chaos question", trace_id="pdisagg-chaos-0001")
        stack.proxy.plan = FaultPlan()
        assert _content(r) == _content(_ask(stack.uni_port, shared, "chaos question"))
        after = _counters(stack.dec_port)
        assert after["disagg_degraded"] == before.get("disagg_degraded", 0) + 1
        assert after["disagg_peer_errors"] > before.get("disagg_peer_errors", 0)
        g = r["usage"]["goodput"]
        assert g["remote_prefill_us"] == 0 and g["kv_transfer_us"] == 0
        waste = _get(stack.dec_port, "/stats")["goodput"]["wasted_tokens"]["transfer_retry"]
        assert waste >= waste0 + 16
        events = _get(stack.dec_port, "/debug/trace?id=pdisagg-chaos-0001")["events"]
        assert any(e["name"] == "kv_transfer" and e["args"].get("failed") == 1 for e in events)
        assert st.disagg.snapshot()["peers_backing_off"]
        mid = _counters(stack.dec_port)
        _ask(stack.dec_port, "post-chaos-prefix " * 9, "after")
        post = _counters(stack.dec_port)
        assert post["disagg_peer_backoff_skips"] == mid.get("disagg_peer_backoff_skips", 0) + 1
    finally:
        stack.proxy.plan = FaultPlan()
        st.disagg = old


def test_peer_down_degrades_with_equal_tokens(stack):
    st = stack.state
    old = _proxied_client(stack)
    stack.proxy.down()
    try:
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            try:
                socket.create_connection(("127.0.0.1", stack.proxy.port), timeout=0.2).close()
                time.sleep(0.02)
            except OSError:
                break
        before = _counters(stack.dec_port)
        shared = "down-peer-prefix " * 9
        r = _ask(stack.dec_port, shared, "still answered")
        assert _content(r) == _content(_ask(stack.uni_port, shared, "still answered"))
        assert _counters(stack.dec_port)["disagg_degraded"] == before.get("disagg_degraded", 0) + 1
    finally:
        stack.proxy.up()
        st.disagg = old


@pytest.mark.parametrize("fault", ["raise", *p_kvt.DEVICE_CORRUPT_MODES])
def test_device_faults_degrade_as_jax(stack, fault):
    """A device-path failure (a raise) or a wrong result (each corrupt mode,
    caught by the metadata half of verify_transfer) degrades to local
    prefill with equal tokens, and the same counters as JAX's."""
    shared = f"device-{fault}-prefix " * 7
    arms = []
    for mod, port, st in ((p_kvt, stack.dec_port, stack.state),
                          (j_kvt, stack.jdec_port, stack.jdec.api_state)):
        if fault == "raise":
            mod.set_device_chaos(OSError("injected device-path failure"))
        else:
            mod.set_device_chaos(corrupt=fault)
        before = _counters(port)
        try:
            r = _ask(port, shared, "still served")
        finally:
            mod.set_device_chaos(None)
            st.disagg._backoff_until.clear()
            st.disagg._strikes.clear()
        after = _counters(port)
        arms.append((_content(r), {k: after.get(k, 0) - before.get(k, 0) for k in _KEYS},
                     r["usage"]["goodput"]["kv_transfer_path"]))
    assert arms[0] == arms[1]
    assert arms[0][0] == _content(_ask(stack.uni_port, shared, "still served"))
    assert arms[0][1]["disagg_degraded"] == 1 and arms[0][2] == ""
    assert arms[0][1]["kv_integrity_rejected"] == (0 if fault == "raise" else 1)


def _status(port, path, data):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_route_contracts_as_jax(stack):
    chat = json.dumps({"messages": [{"role": "user", "content": "x" * 100}]}).encode()
    ids = json.dumps({"ids": list(range(64))}).encode()
    cases = [
        ("prefill", "/v1/chat/completions", chat),  # a prefill worker serves no chat
        ("decode", "/v1/prefill", ids),  # only prefill workers serve it
        ("prefill", "/v1/prefill", b"not json"),
        ("prefill", "/v1/prefill", b'{"ids": []}'),
        ("prefill", "/v1/prefill", b'{"ids": [1,2,3]}'),  # below the floor
        ("prefill", "/v1/kv_fetch", ids),  # no tier store here
    ]
    ports = {"prefill": (stack.pf_port, stack.jpf_port), "decode": (stack.dec_port, stack.jdec_port)}
    for role, path, data in cases:
        p, j = (_status(port, path, data) for port in ports[role])
        assert p[0] == j[0] and p[0] in (400, 404), (role, path, p, j)
        assert json.loads(p[1]).keys() == json.loads(j[1]).keys()


def test_prefill_endpoint_ships_the_jax_payload(stack):
    ids = [(i * 7) % 250 + 1 for i in range(130)]
    data = json.dumps({"ids": ids}).encode()
    (pc, pb), (jc, jb) = (_status(port, "/v1/prefill", data) for port in (stack.pf_port, stack.jpf_port))
    assert pc == jc == 200
    hp, kp, vp = p_kvt.parse_kv_payload(pb)
    hj, kj, vj = j_kvt.parse_kv_payload(jb)
    drop = ("k_sums", "v_sums", "prefill_us")
    assert {k: v for k, v in hp.items() if k not in drop} == \
        {k: v for k, v in hj.items() if k not in drop}
    assert hp["p"] == p_disagg.prefill_boundary(len(ids), 512) == 128
    assert kp.shape == (2, 128, 2, 16) and hp["prefill_us"] > 0
    # equal to float rounding (the two forward passes round differently)
    np.testing.assert_allclose(kp, kj, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(vp, vj, rtol=1e-4, atol=1e-5)
    res = p_kvt.TransferResult(hp, kp, vp, "http", len(pb))
    assert p_kvt.verify_transfer(res, ids, 128) is None


def test_insert_external_refuses_bad_slices(stack):
    st = stack.state
    pc = st.engine.prefix_cache
    k = np.zeros((2, 17, 2, 16), np.float32)
    assert not pc.insert_external(st.engine, list(range(17)), k, k)
    k16 = np.zeros((2, 16, 2, 16), np.float32)
    assert not pc.insert_external(st.engine, list(range(16)), k16, np.zeros((2, 16, 2, 8)))


def test_stats_and_config_surface_roles_as_jax(stack):
    for port, jport, role in ((stack.dec_port, stack.jdec_port, "decode"),
                              (stack.pf_port, stack.jpf_port, "prefill")):
        p, j = _get(port, "/stats"), _get(jport, "/stats")
        assert p["role"] == j["role"] == role
        assert (p["disagg"] is None) == (j["disagg"] is None)
        pc, jc = _get(port, "/debug/config"), _get(jport, "/debug/config")
        assert pc["role"] == jc["role"] == role
        assert pc["kv"]["layout"] == jc["kv"]["layout"] == "paged"
    p, j = _get(stack.dec_port, "/stats"), _get(stack.jdec_port, "/stats")
    assert p["disagg"].keys() == j["disagg"].keys()
    assert p["disagg"]["integrity"].keys() == j["disagg"]["integrity"].keys()
    assert p["disagg"]["peers"] == [f"127.0.0.1:{stack.pf_port}"]
    assert _get(stack.uni_port, "/stats")["role"] == "unified"
