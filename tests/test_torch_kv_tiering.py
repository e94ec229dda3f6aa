"""The port's tiered KV store held to the JAX package's, on the CPU.

Engine layer (the twins of tests/test_kv_tiering.py): a prefix demoted to
host RAM, or to disk, and promoted back serves tokens identical to a cold
run, with the JAX store's kv_tier_* counters for the same scenario on
contiguous f32, paged f32 and paged int8; a corrupt disk entry is
rejected, unlinked and counted; pinned entries never demote and
`clear()` seeds no tier; an off-bucket entry is not captured; a prefetch
hint lifts a disk entry to the host tier.

Serving layer: replica B fetches a prefix replica A demoted over a real
``POST /v1/kv_fetch`` (the device registry unhooked), and a corrupt
peer transfer degrades to local prefill: the port's two-replica stack
answers what the JAX stack answers, with the same counters.
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
from distributed_llama_tpu.runtime import kv_tiering as j_tier
from distributed_llama_tpu.runtime import kv_transport as j_kvt
from distributed_llama_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llama_tpu.runtime.prefix_cache import PrefixCache as JPrefixCache
from distributed_llama_tpu.server import api as j_api
from distributed_llama_tpu.testing import tiny_header, write_tiny_model, write_tiny_tokenizer
from distributed_llama_tpu_torch.cli import build_arg_parser as p_parser
from distributed_llama_tpu_torch.runtime import kv_tiering as p_tier
from distributed_llama_tpu_torch.runtime import kv_transport as p_kvt
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine as PEngine
from distributed_llama_tpu_torch.runtime.prefix_cache import PREFIX_MIN_TOKENS
from distributed_llama_tpu_torch.runtime.prefix_cache import PrefixCache as PPrefixCache
from distributed_llama_tpu_torch.runtime.prefix_cache import PrefixEntry as PPrefixEntry
from distributed_llama_tpu_torch.server import api as p_api

CHATML = "{% for m in messages %}<|im_start|>...{% endfor %}"
PROMPT_A = [(i % 100) + 1 for i in range(48)]


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("ptier")
    path = str(d / "m.m")
    write_tiny_model(path, tiny_header(seq_len=256), seed=11)
    return path


def _engines(path, **kw):
    kw = dict(compute_dtype="float32", max_chunk=16, decode_chunk_size=8, **kw)
    return JEngine(path, **kw), PEngine(path, device="cpu", **kw)


def _gen(eng, prompt, n_new):
    eng.reset()
    return eng.generate(prompt, len(prompt) + n_new, sampler=None, on_token=lambda t: None).tokens


def _stores(je, pe, tmp_path, **kw):
    kw = dict(dict(host_mb=64, disk_mb=0, peers=[]), **kw)
    js = j_tier.TieredKvStore(je, disk_dir=str(tmp_path / "j"), **kw)
    je.prefix_cache.tier = js
    ps = p_tier.TieredKvStore(pe, disk_dir=str(tmp_path / "p"), **kw)
    ps.attach(pe)
    return js, ps


def _wait(cond, what, timeout_s=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(what)


def _tier_counters(eng):
    return {k: v for k, v in eng.stats.counters_snapshot().items() if k.startswith("kv_tier")}


@pytest.mark.parametrize("layout,dtype", [("contiguous", None), ("paged", None),
                                          ("paged", "int8")],
                         ids=["contiguous", "paged-f32", "paged-int8"])
def test_demote_promote_from_host_equals_cold_and_jax(model_path, tmp_path, layout, dtype):
    pe_cold = PEngine(model_path, device="cpu", compute_dtype="float32", max_chunk=16,
                      decode_chunk_size=8, prefix_cache_mb=0, kv_layout=layout, cache_dtype=dtype)
    want = _gen(pe_cold, PROMPT_A, 12)
    pe_cold.close()
    je, pe = _engines(model_path, prefix_cache_mb=64, kv_layout=layout, cache_dtype=dtype)
    js, ps = _stores(je, pe, tmp_path)
    try:
        outs = []
        for eng, store in ((je, js), (pe, ps)):
            first = _gen(eng, PROMPT_A, 12)
            assert eng.prefix_cache.evict_one()
            _wait(lambda: store._demote_q.empty() and store._host, "no demotion drained")
            out = store.fetch(PROMPT_A)
            assert out["tier_path"] == "host" and out["promoted_tokens"] >= PREFIX_MIN_TOKENS
            assert out["pending_kv"].apply(None)
            again = _gen(eng, PROMPT_A, 12)
            assert eng.last_prefix_hit_tokens >= PREFIX_MIN_TOKENS
            out2 = store.fetch(PROMPT_A)  # a full HBM hit: no lower tier touched
            assert out2["pending_kv"] is None
            outs.append((first, again, _tier_counters(eng), store.snapshot()["host"]))
        (jf, ja, jc, jh), (pf, pa, pc, ph) = outs
        assert pf == want and pa == want and ja == jf
        assert pc == jc and pc["kv_tier_hits_host"] == 1 and pc["kv_tier_local_hits"] == 1
        assert ph == jh
        assert ps.memory_snapshot() == js.memory_snapshot()
    finally:
        js.close()
        ps.close()
        je.close()
        pe.close()


def test_disk_spill_verify_and_corrupt_rejection_as_jax(model_path, tmp_path):
    je, pe = _engines(model_path, prefix_cache_mb=64)
    js, ps = _stores(je, pe, tmp_path, host_mb=0, disk_mb=64)
    try:
        results = []
        for eng, store in ((je, js), (pe, ps)):
            want = _gen(eng, PROMPT_A, 8)
            assert eng.prefix_cache.evict_one()
            _wait(lambda: store._disk, "no spill to disk")
            out = store.fetch(PROMPT_A)  # a clean disk hit, verified
            assert out["tier_path"] == "disk"
            assert out["pending_kv"].apply(None)
            got = _gen(eng, PROMPT_A, 8)
            assert got == want
            (_key, (path, nbytes)), = list(store._disk.items())
            with open(path, "r+b") as f:  # disk rot: one payload byte
                f.seek(nbytes - 3)
                b = f.read(1)
                f.seek(nbytes - 3)
                f.write(bytes([b[0] ^ 0xFF]))
            eng.prefix_cache.clear()
            out = store.fetch(PROMPT_A)
            assert out["pending_kv"] is None and not os.path.exists(path) and not store._disk
            results.append((want, _tier_counters(eng)))
        assert results[1] == results[0]
        assert results[1][1]["kv_tier_disk_corrupt"] == 1
    finally:
        js.close()
        ps.close()
        je.close()
        pe.close()


def test_prefetch_hint_lifts_disk_entry_to_host(model_path, tmp_path):
    pe = PEngine(model_path, device="cpu", compute_dtype="float32", max_chunk=16,
                 decode_chunk_size=8, prefix_cache_mb=64)
    store = p_tier.TieredKvStore(pe, disk_dir=str(tmp_path), host_mb=64, disk_mb=64, peers=[])
    store.attach(pe)
    try:
        _gen(pe, PROMPT_A, 8)
        store.note_chain([0xABCD, 0xBEEF], PROMPT_A)
        assert store.snapshot()["hints_tracked"] == 2
        assert pe.prefix_cache.evict_one()
        _wait(lambda: store._demote_q.empty() and store._host, "no demotion drained")
        with store._lock:
            key, entry = store._host.popitem(last=False)
            store._host_bytes -= entry.nbytes
        store._spill_to_disk(entry)
        assert store._host_get(key) is None and store._disk
        store.prefetch_hint([0xBEEF])
        _wait(lambda: store._host_get(key) is not None, "the hint lifted nothing")
        c = _tier_counters(pe)
        assert c["kv_tier_prefetch_hints"] == 1 and c["kv_tier_prefetched"] == 1
        store.prefetch_hint([0x5150])  # an unknown chain: a no-op
        assert _tier_counters(pe)["kv_tier_prefetch_hints"] == 1
    finally:
        store.close()
        pe.close()


class _CaptureTier:
    def __init__(self):
        self.captured = []

    def capture_demotion(self, entry):
        self.captured.append(entry.tokens)


def test_pinned_entries_never_demote_and_clear_seeds_nothing():
    """The JAX trace of tests/test_kv_tiering.py on both caches: only
    unpinned LRU victims reach the tier, and clear() reaches none."""
    out = []
    for cls in (JPrefixCache, PPrefixCache):
        pc = cls(250, seq_len=4096, max_chunk=16)
        tier = _CaptureTier()
        pc.tier = tier
        entries = []
        for t in (1, 2, 3):
            e = PPrefixEntry(tokens=(t,) * 16, k=None, v=None, nbytes=100)
            pc._insert(e)
            pc._entries[e.tokens] = e
            pc._bytes += e.nbytes
            pc._clock += 1
            e.last_used = pc._clock
            entries.append(e)
        entries[0].refs = 1
        assert pc._evict_until(250)
        assert not pc._evict_until(50)
        pc.clear()
        out.append(tier.captured)
    assert out[1] == out[0] == [(2,) * 16, (3,) * 16]


def test_off_bucket_entries_are_not_captured(model_path, tmp_path):
    pe = PEngine(model_path, device="cpu", compute_dtype="float32", prefix_cache_mb=64)
    store = p_tier.TieredKvStore(pe, disk_dir=str(tmp_path), host_mb=64, disk_mb=0, peers=[])
    try:
        store.capture_demotion(PPrefixEntry(tokens=tuple(range(1, 21)), k=None, v=None,
                                            nbytes=10))
        time.sleep(0.1)
        assert not store._host and store._demote_q.empty()
    finally:
        store.close()
        pe.close()


# -- the serving layer: two replicas, the fleet-cache tier over HTTP ----------


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Fleet:
    """Replica A (host tier) and replica B (host tier, A as its peer) of
    one package, with the same-process registry unhooked so B's fetches
    ride real HTTP."""

    def __init__(self, api_mod, parser, kvt, mp, tp, extra):
        def start(env):
            old = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                p = parser()
                p.add_argument("--port", type=int, default=0)
                port = _free_port()
                args = p.parse_args(["inference", "--model", mp, "--tokenizer", tp,
                                     "--compute-dtype", "float32", "--temperature", "0.0",
                                     "--port", str(port)] + extra)
                httpd = api_mod.serve(args)
            finally:
                for k, v in old.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            kvt.unregister_device_peer(port)
            return port, httpd

        self.a_port, self.a = start({"DLT_KV_HOST_TIER_MB": "64"})
        self.b_port, self.b = start({"DLT_KV_HOST_TIER_MB": "64",
                                     "DLT_KV_TIER_PEERS": f"127.0.0.1:{self.a_port}"})

    def stop(self):
        for h in (self.a, self.b):
            h.shutdown()
            h.server_close()


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    d = tmp_path_factory.mktemp("tierfleet")
    h = tiny_header(arch=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2, seq_len=512,
                    vocab_size=288)
    mp, tp = str(d / "m.m"), str(d / "t.t")
    write_tiny_model(mp, h, seed=3)
    write_tiny_tokenizer(tp, pad_to=288, chat_template=CHATML)
    os.environ["DLT_NO_WARMUP"] = "1"
    os.environ["DLT_KV_DISK_TIER_DIR"] = str(d / "disk")
    try:
        jf = _Fleet(j_api, j_parser, j_kvt, mp, tp, [])
        pf = _Fleet(p_api, p_parser, p_kvt, mp, tp, ["--device", "cpu"])
        yield jf, pf
        jf.stop()
        pf.stop()
    finally:
        os.environ.pop("DLT_NO_WARMUP", None)
        os.environ.pop("DLT_KV_DISK_TIER_DIR", None)


def _ask(port, system, user, max_tokens=8):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps({"messages": [{"role": "system", "content": system},
                                      {"role": "user", "content": user}],
                         "max_tokens": max_tokens}).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _counters(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
        return json.loads(r.read())["steps"]["counters"]


def _demote_on(fleet, shared, answer):
    st = fleet.a.api_state
    n0 = st.kv_tier.snapshot()["host"]["entries"]
    r = _ask(fleet.a_port, shared, answer)
    assert st.engine.prefix_cache.evict_one()
    _wait(lambda: st.kv_tier.snapshot()["host"]["entries"] > n0, "A never demoted", 15.0)
    return r


_KEYS = ("kv_tier_hits_peer", "kv_tier_promotions", "kv_integrity_verified",
         "kv_integrity_rejected", "kv_tier_degraded", "kv_tier_local_hits")


def test_peer_fetch_over_http_equals_jax(fleets):
    shared = "fleet-cache-shared-prefix " * 8
    got = []
    for fleet in fleets:
        r_a = _demote_on(fleet, shared, "what is up")
        before = _counters(fleet.b_port)
        r_b = _ask(fleet.b_port, shared, "what is up")
        after = _counters(fleet.b_port)
        assert r_b["choices"][0]["message"] == r_a["choices"][0]["message"]
        assert r_b["usage"]["goodput"]["promotion_us"] > 0
        a = _counters(fleet.a_port)
        got.append((r_b["choices"][0]["message"],
                    {k: after.get(k, 0) - before.get(k, 0) for k in _KEYS},
                    a.get("kv_tier_peer_served", 0) > 0,
                    fleet.b.api_state.kv_tier.snapshot()["host"]["entries"]))
    assert got[1] == got[0]
    assert got[1][1]["kv_tier_hits_peer"] == 1
    with urllib.request.urlopen(f"http://127.0.0.1:{fleets[1].b_port}/metrics", timeout=30) as r:
        body = r.read().decode()
    assert 'dlt_kv_tier_hits_total{tier="peer"} ' in body
    assert 'dlt_kv_tier_hits_total{tier="disk"} 0' in body


def test_corrupt_peer_transfer_degrades_as_jax(fleets):
    shared = "corrupt-peer-prefix " * 8
    got = []
    for fleet, tier_mod in zip(fleets, (j_tier, p_tier)):
        r_a = _demote_on(fleet, shared, "still served")
        before = _counters(fleet.b_port)
        tier_mod.set_serve_chaos(True)
        try:
            r_b = _ask(fleet.b_port, shared, "still served")
        finally:
            tier_mod.set_serve_chaos(False)
        after = _counters(fleet.b_port)
        assert r_b["choices"][0]["message"] == r_a["choices"][0]["message"]
        snap = fleet.b.api_state.kv_tier.snapshot()["integrity"]
        got.append((r_b["choices"][0]["message"],
                    {k: after.get(k, 0) - before.get(k, 0) for k in _KEYS},
                    list(snap["peer_strikes"].values()), snap["peers_struck_out"]))
        with urllib.request.urlopen(f"http://127.0.0.1:{fleet.b_port}/metrics", timeout=30) as r:
            body = r.read().decode()
        assert any(line.startswith('dlt_wasted_tokens_total{reason="integrity"}')
                   and int(line.rsplit(" ", 1)[1]) > 0 for line in body.splitlines())
    assert got[1] == got[0]
    assert got[1][1]["kv_integrity_rejected"] == 1 and got[1][2] == [1]


def test_kv_fetch_endpoint_contract_as_jax(fleets):
    def post(port, body, raw=False):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/kv_fetch",
            data=body if raw else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    for body, raw in ((b"not json {{", True), ({"ids": []}, False), ({"ids": "nope"}, False),
                      ({"ids": [1, 2, 3] * 80}, False)):
        j, p = (post(f.a_port, body, raw) for f in fleets)
        assert p == j, body
    jh, ph = (next(iter(f.a.api_state.kv_tier._host), None) for f in fleets)
    assert ph is not None and ph == jh
    j, p = (post(f.a_port, {"ids": list(ph) + [9], "have": ["zz!", 42]}) for f in fleets)
    assert p[0] == j[0] == 200
    # the same header but for the checksums, over KV equal to float
    # rounding (the two packages' f32 forward passes round differently)
    (hj, kj, vj), (hp, kp, vp) = (j_kvt.parse_kv_payload(j[1]), p_kvt.parse_kv_payload(p[1]))
    sums = ("k_sums", "v_sums")
    assert {k: v for k, v in hp.items() if k not in sums} == \
        {k: v for k, v in hj.items() if k not in sums}
    assert hp["start"] == 0
    np.testing.assert_allclose(kp, kj, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(vp, vj, rtol=1e-4, atol=1e-5)
