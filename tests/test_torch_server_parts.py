"""The server's stdlib parts in the port, held to the JAX modules they copy.

On the same inputs the port's router chain keys, quarantine fingerprints,
SLO-class and deadline resolvers, scheduler decisions and supervisor
transitions equal the JAX package's. Also: the port's own additions the
server needs (the page pool's snapshot, the per-row stream decoder, the
engine's close, the cached graph view), and the environment resolvers of
the KV movement layer (role, peers, tier peers, transport) equal to JAX's.
"""

import numpy as np
import pytest

from distributed_llama_tpu.runtime import paged_kv as j_paged_kv
from distributed_llama_tpu.runtime import supervisor as j_supervisor
from distributed_llama_tpu.runtime.telemetry import StallError as JStallError
from distributed_llama_tpu.server import quarantine as j_quarantine
from distributed_llama_tpu.server import router as j_router
from distributed_llama_tpu.server import scheduler as j_scheduler
from distributed_llama_tpu.tokenizer import Tokenizer as JTokenizer
from distributed_llama_tpu_torch.formats.mfile import ArchType
from distributed_llama_tpu_torch.runtime import paged_kv as p_paged_kv
from distributed_llama_tpu_torch.runtime import supervisor as p_supervisor
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
from distributed_llama_tpu_torch.runtime.telemetry import StallError as PStallError
from distributed_llama_tpu_torch.server import api as p_api
from distributed_llama_tpu_torch.server import parse_query
from distributed_llama_tpu_torch.server import quarantine as p_quarantine
from distributed_llama_tpu_torch.server import router as p_router
from distributed_llama_tpu_torch.server import scheduler as p_scheduler
from distributed_llama_tpu_torch.testing import (
    byte_vocab_tokenizer, tiny_header, write_tiny_model,
)
from distributed_llama_tpu_torch.tokenizer import Tokenizer as PTokenizer


def _texts(seed=0, n=40):
    """Message texts of every length class: empty, shorter than a block,
    many blocks, past the chain depth cap, non-ASCII."""
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefghij klmnop\n\t{}\"'") + ["é", "漢", "🙂", "\x00"]
    out = ["", "x", "a" * 63, "a" * 64, "b" * 65, "c" * 64 * 40]
    for _ in range(n):
        k = int(rng.integers(0, 700))
        out.append("".join(rng.choice(alphabet, size=k)))
    return out


def _messages(seed=1, n=30):
    rng = np.random.default_rng(seed)
    texts = _texts(seed, n)
    out = [None, [], ["hi"], [{"role": "user"}], [{"content": 3}], "not a list"]
    for i in range(n):
        k = int(rng.integers(1, 4))
        out.append([
            {"role": ["system", "user", "assistant"][j % 3], "content": texts[(i + j) % len(texts)]}
            for j in range(k)
        ])
    return out


def test_router_chain_keys_equal_the_jax_router():
    for text in _texts():
        for block in (16, 64):
            assert p_router.prefix_chain(text, block) == j_router.prefix_chain(text, block)
        assert p_router.fnv1a(text.encode("utf-8", "replace")) == j_router.fnv1a(
            text.encode("utf-8", "replace"))
    for msgs in _messages():
        pt, jt = p_router.messages_prefix_text(msgs), j_router.messages_prefix_text(msgs)
        assert pt == jt
        if pt:
            chain = p_router.prefix_chain(pt)
            assert chain == j_router.prefix_chain(jt)
            assert p_router.chain_header_value(chain) == j_router.chain_header_value(chain)
    for raw in (None, "", "zz", "00ff,10", "ff,,1", chain and p_router.chain_header_value(chain)):
        assert p_router.parse_chain_header(raw) == j_router.parse_chain_header(raw)
    for name in ("PAGE_CHARS", "MAX_BLOCKS", "_FNV64_OFFSET", "_FNV64_PRIME",
                 "PREFETCH_CHAIN_HEADER"):
        assert getattr(p_router, name) == getattr(j_router, name)


def test_quarantine_fingerprints_equal_the_jax_module():
    for msgs in _messages(2):
        text = p_router.messages_prefix_text(msgs)
        pf, jf = p_quarantine.request_fingerprint(text), j_quarantine.request_fingerprint(text)
        assert pf == jf
        if pf is not None:
            assert p_quarantine.fp_hex(pf) == j_quarantine.fp_hex(jf)
            assert p_quarantine.parse_fp_hex(p_quarantine.fp_hex(pf)) == pf
    assert p_quarantine.POISON_HEADER == j_quarantine.POISON_HEADER


def test_quarantine_ledger_runs_as_the_jax_ledger():
    led = [m.QuarantineLedger(limit=2, size=4, ttl_s=600.0) for m in (j_quarantine, p_quarantine)]
    script = [("strike", 1), ("strike", 2), ("q", 1), ("strike", 1), ("q", 1),
              ("strike", 3), ("strike", 4), ("strike", 5), ("strike", 6), ("q", 1),
              ("s", 6), ("s", 2)]
    for op, fp in script:
        outs = []
        for lg in led:
            if op == "strike":
                outs.append(lg.strike(fp))
            elif op == "q":
                outs.append(lg.is_quarantined(fp))
            else:
                outs.append(lg.strikes(fp))
        assert outs[0] == outs[1], (op, fp)
    assert led[0].snapshot().keys() == led[1].snapshot().keys()


@pytest.mark.parametrize("env", [
    {},
    {"DLT_DEFAULT_DEADLINE_MS": "2000"},
    {"DLT_DEFAULT_DEADLINE_MS": "2000", "DLT_DEADLINE_MS_BATCH": "0"},
    {"DLT_DEADLINE_MS_INTERACTIVE": "150.7", "DLT_DEFAULT_DEADLINE_MS": "junk"},
])
def test_slo_class_and_deadline_resolvers_equal(monkeypatch, env):
    for k in [*j_scheduler.DEADLINE_ENVS]:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    raws = [None, "", "interactive", " Batch ", "STANDARD", "premium", 3, b"batch"]
    for raw in raws:
        klass = p_scheduler.resolve_slo_class(raw)
        assert klass == j_scheduler.resolve_slo_class(raw)
        for client in (None, "0", "-5", "250", "1e3", "junk", 17.9):
            assert (p_scheduler.resolve_deadline_ms(raw, client)
                    == j_scheduler.resolve_deadline_ms(raw, client))
    assert p_scheduler.DEADLINE_ENVS == j_scheduler.DEADLINE_ENVS


def test_scheduler_decisions_equal():
    rows = [(0, "batch", 5), (1, "standard", 2), (2, "batch", 1), (3, "interactive", 9)]
    js, ps = j_scheduler.SloScheduler(), p_scheduler.SloScheduler()
    assert ps.shed_victim(rows) == js.shed_victim(rows)
    for waiting in p_scheduler.SLO_CLASSES:
        assert ps.preempt_victim(waiting, rows) == js.preempt_victim(waiting, rows)
    jq, pq = j_scheduler.ClassQueues(), p_scheduler.ClassQueues()
    for i, klass in enumerate(["batch", "batch", "standard", "interactive", "batch"]):
        jq.append(i, klass)
        pq.append(i, klass)
    for klass in p_scheduler.SLO_CLASSES:
        assert (ps.admission_allowed(klass, pq, 8) == js.admission_allowed(klass, jq, 8))
    assert [pq.popleft() for _ in range(5)] == [jq.popleft() for _ in range(5)]
    for s in (js, ps):
        s.record("batch", "preempt")
        s.record("interactive", "admit", 2)
    assert ps.decisions_series() == js.decisions_series()
    assert ps.snapshot() == js.snapshot()


def test_supervisor_transitions_equal():
    """The same failure script through both supervisors: stalls reset
    until the limit, then rebuild; the restart budget runs out to
    `failed`; a rebuild that raises goes to `failed` too."""

    def run(mod, stall_cls):
        calls, slept = [], []
        fail = {"on": False}

        def rebuild():
            calls.append(1)
            if fail["on"]:
                raise RuntimeError("rebuild died")

        cfg = mod.SupervisorConfig(max_restarts=2, window_s=600.0, stall_limit=2,
                                   backoff_s=0.5, backoff_max_s=30.0)
        sup = mod.EngineSupervisor(rebuild, cfg, sleep_fn=slept.append)
        trail = []
        for step in ("stall", "ok", "stall", "stall", "boom", "boom", "die"):
            if step == "ok":
                sup.note_ok()
                trail.append(("ok", sup.state))
                continue
            exc = stall_cls("stalled") if step == "stall" else RuntimeError("x")
            action = sup.classify(exc)
            if action == "reset":
                sup.note_reset(type(exc).__name__)
                trail.append((step, action, sup.state))
                continue
            if step == "die":
                fail["on"] = True
            try:
                ok = sup.recover(type(exc).__name__)
            except RuntimeError:
                ok = "raised"
            trail.append((step, action, ok, sup.state))
        snap = sup.snapshot()
        return trail, calls, slept, snap, sup.transitions_series()

    j, p = run(j_supervisor, JStallError), run(p_supervisor, PStallError)
    assert p == j
    trail = p[0]
    assert trail[-1][-1] == "failed"
    assert p_supervisor.SUPERVISOR_STATES == j_supervisor.SUPERVISOR_STATES


def test_supervisor_rebuild_failure_is_failed():
    for mod in (j_supervisor, p_supervisor):
        def rebuild():
            raise OSError("weights gone")

        sup = mod.EngineSupervisor(rebuild, sleep_fn=lambda s: None)
        with pytest.raises(OSError):
            sup.recover("RuntimeError")
        assert sup.state == "failed" and sup.transitions["failed"] == 1


def test_parse_query():
    assert parse_query("id=ab12&n=3&junk&x=a=b") == {"id": "ab12", "n": "3", "x": "a=b"}


_ROLE_ENVS = [{}, {"DLT_ROLE": "unified"}, {"DLT_ROLE": ""}, {"DLT_ROLE": "prefill"},
              {"DLT_ROLE": "decode"}, {"DLT_ROLE": "typo"}]


def _twin(monkeypatch, env, fn_j, fn_p, *args):
    """fn_j(*args) and fn_p(*args) under `env`: the same value, or the same
    exception type on both."""
    for k in ("DLT_ROLE", "DLT_PREFILL_PEER", "DLT_KV_TIER_PEERS", "DLT_KV_TRANSPORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = []
    for fn in (fn_j, fn_p):
        try:
            out.append(("ok", fn(*args)))
        except Exception as e:
            out.append(("raise", type(e).__name__))
    assert out[1] == out[0], (env, args)
    return out[1]


@pytest.mark.parametrize("env", _ROLE_ENVS, ids=lambda e: str(e.get("DLT_ROLE")))
def test_resolve_role_as_jax(monkeypatch, env):
    from distributed_llama_tpu.server import disagg as j_disagg
    from distributed_llama_tpu_torch.server import disagg as p_disagg

    for explicit in (None, "prefill", "decode", "unified", "bogus"):
        _twin(monkeypatch, env, j_disagg.resolve_role, p_disagg.resolve_role, explicit)


@pytest.mark.parametrize("env", [{}, {"DLT_PREFILL_PEER": "a:1, b:2"},
                                 {"DLT_PREFILL_PEER": ":9990"}, {"DLT_PREFILL_PEER": "x:nope"}])
def test_resolve_peers_as_jax(monkeypatch, env):
    from distributed_llama_tpu.server import disagg as j_disagg
    from distributed_llama_tpu_torch.server import disagg as p_disagg

    for explicit in (None, ["10.0.0.1:900", "h2:901"]):
        _twin(monkeypatch, env, j_disagg.resolve_peers, p_disagg.resolve_peers, explicit)


@pytest.mark.parametrize("env", [{}, {"DLT_KV_TIER_PEERS": "10.0.0.1:8101, :8102,"},
                                 {"DLT_KV_TIER_PEERS": " "}])
def test_resolve_tier_peers_as_jax(monkeypatch, env):
    from distributed_llama_tpu.runtime import kv_tiering as j_tier
    from distributed_llama_tpu_torch.runtime import kv_tiering as p_tier

    for explicit in (None, [("h", 5)], ["q:7"]):
        _twin(monkeypatch, env, j_tier.resolve_tier_peers, p_tier.resolve_tier_peers, explicit)


@pytest.mark.parametrize("env", [{}, {"DLT_KV_TRANSPORT": "device"},
                                 {"DLT_KV_TRANSPORT": "http"}, {"DLT_KV_TRANSPORT": "bogus"}])
def test_resolve_transport_as_jax(monkeypatch, env):
    from distributed_llama_tpu.runtime import kv_transport as j_kvt
    from distributed_llama_tpu_torch.runtime import kv_transport as p_kvt

    for explicit in (None, "auto", "device", "HTTP", "bogus"):
        _twin(monkeypatch, env, j_kvt.resolve_transport, p_kvt.resolve_transport, explicit)


@pytest.mark.parametrize("env", [
    {"DLT_ROLE": "prefill"},
    {"DLT_ROLE": "decode"},
    {"DLT_KV_HOST_TIER_MB": "64"},
    {"DLT_KV_DISK_TIER_MB": "1"},
    {"DLT_KV_TIER_PEERS": "10.0.0.2:9990"},
])
def test_state_builds_under_the_environment_as_jax(monkeypatch, tmp_path, env):
    """The server's ApiState builds under every role and tier variable the
    JAX server accepts, with the role and the tier store JAX's would have."""
    from types import SimpleNamespace

    monkeypatch.setenv("DLT_KV_DISK_TIER_DIR", str(tmp_path / "disk"))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    path = str(tmp_path / "m.m")
    write_tiny_model(path, tiny_header(seq_len=64), seed=1)
    eng = InferenceEngine(path, compute_dtype="float32", device="cpu", prefix_cache_mb=4,
                          kv_layout="paged")
    args = SimpleNamespace(temperature=0.0, topp=0.9, seed=None, chat_template="chatml",
                           host_decode=False, role=None, prefill_peer=None)
    tok = PTokenizer.__new__(PTokenizer)
    tok.eos_token_ids, tok.chat_template = [], None
    tok.piece = lambda t: b""
    state = p_api.ApiState(eng, tok, args)
    try:
        assert state.role == env.get("DLT_ROLE", "unified")
        tiered = any(k.startswith("DLT_KV_") for k in env)
        assert (state.kv_tier is not None) == tiered
        if tiered:
            assert eng.kv_tier is state.kv_tier and eng.prefix_cache.tier is state.kv_tier
        assert state.disagg is None  # decode without --prefill-peer serves locally
    finally:
        state.close()


def test_page_pool_snapshot_and_row_holds_pages_as_jax():
    kw = dict(n_pages=12, page_size=16, n_rows=3, seq_len=96)
    jp = j_paged_kv.PagePool(**kw, page_bytes=4096, kv_dtype="int8")
    pp = p_paged_kv.PagePool(**kw, page_bytes=4096, kv_dtype="int8")
    for pool in (jp, pp):
        pool.ensure(0, 0, 40)
        pool.ensure(2, 0, 17)
        pool.share(1, pool.row_pages(0, 2))
    assert pp.snapshot() == jp.snapshot()
    for r in range(3):
        assert pp.row_holds_pages(r) == jp.row_holds_pages(r)
    for pool in (jp, pp):
        pool.release_row(1)
    assert [pp.row_holds_pages(r) for r in range(3)] == [jp.row_holds_pages(r) for r in range(3)]
    assert pp.snapshot() == jp.snapshot()


def test_stream_decoder_per_row_equals_jax():
    data = byte_vocab_tokenizer(pad_to=288, chat_template="x")
    pt, jt = PTokenizer(data), JTokenizer(data)
    text = "héllo 漢字 🙂 ok".encode()
    ids = list(text)  # the byte vocabulary: token i is byte i
    a, b = pt.stream_decoder(), jt.stream_decoder()
    c = pt.stream_decoder()
    for t in ids:
        assert a.decode(t) == b.decode(t)
    # rows are independent: a second decoder's carry starts empty
    assert c.decode(ids[0]) == "h"


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    h = tiny_header(arch=ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2, seq_len=256,
                    vocab_size=288)
    p = str(tmp_path_factory.mktemp("parts") / "m.m")
    write_tiny_model(p, h, seed=3)
    return p


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_engine_close_releases_device_state(model_path, layout):
    eng = InferenceEngine(model_path, compute_dtype="float32", device="cpu", kv_layout=layout,
                          prefix_cache_mb=8, batch=2)
    eng.generate([1, 2, 3, 4] * 6, 40)
    assert eng.prefix_cache.n_entries > 0
    view = eng.graph_stats(live=False)
    assert view["recaptures_after_warmup"] == 0 and view["pool_bytes"] == 0
    eng.close()
    assert eng.closed and eng.params is None and eng.cache is None
    assert eng._graphs is None and eng.prefix_cache.n_entries == 0
    eng.reset()  # nothing on a closed engine
    eng.close()  # idempotent
    assert eng.stats.counters_snapshot()  # the host surface stays readable


def test_special_token_index_encodes_as_the_jax_scan():
    """The port indexes special pieces by length; the JAX tokenizer scans
    them in vocab order at every position. Same ids: on overlapping
    specials in every order (the first in vocab order wins), on the chat
    template over a vocab padded with specials, and on random text."""
    from distributed_llama_tpu_torch.formats.tfile import TokenizerData

    base = [bytes([i]) for i in range(256)]
    specials = [b"<s>", b"</s>", b"<a>b", b"<a>", b"<", b"<ab", b"<a", b"<pad9>"]
    overlap = TokenizerData(vocab=base + specials, scores=[0.0] * (256 + len(specials)),
                            bos_id=256, eos_token_ids=[257], max_token_length=6)
    rng = np.random.default_rng(5)
    alphabet = list("<a>b/sp9d x") + ["<a>b", "<ab", "<s>", "</s>", "<pad9>", "é"]
    texts = ["".join(rng.choice(alphabet, size=int(rng.integers(0, 40)))) for _ in range(60)]
    texts += ["<|im_start|>user\nName a colour.<|im_end|>\n<|im_start|>assistant\n",
              "<pad300><pad3000>x<s></s><sp3><|eot|>"]
    for data in (overlap, byte_vocab_tokenizer(pad_to=4096, chat_template="x")):
        pt, jt = PTokenizer(data), JTokenizer(data)
        for text in texts:
            for start in (True, False):
                assert pt.encode(text, is_start=start) == jt.encode(text, is_start=start), text
            assert (pt.encode(text, add_special_tokens=False)
                    == jt.encode(text, add_special_tokens=False))


def test_server_defaults_to_the_card_and_raises_without_one(model_path, tmp_path, monkeypatch):
    """`--device` defaults to cuda: with no card the server refuses to
    start instead of serving from the CPU."""
    import torch

    from distributed_llama_tpu_torch.cli import build_arg_parser
    from distributed_llama_tpu_torch.testing import write_tiny_tokenizer

    tp = str(tmp_path / "t.t")
    write_tiny_tokenizer(tp, pad_to=288, chat_template="{% for m in messages %}<|im_start|>...")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = build_arg_parser()
    p.add_argument("--port", type=int, default=0)
    args = p.parse_args(["inference", "--model", model_path, "--tokenizer", tp])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_api.serve(args)
