"""The port's speculative decoding (runtime/speculative.py) on the CPU,
against the JAX package's.

With temperature 0, speculation changes how the greedy chain is computed,
not the chain: the port's spec tokens must equal the JAX spec engine's and
the port's own non-spec tokens, in the same rounds with the same drafts.
The verify forward's ids equal the JAX `verify_chunk`'s and its logits lie
within VERIFY_ATOL of them (f32 compute). The static-buffer verify step (what a CUDA graph
captures on the card, run here eagerly through `DecodeGraphs(capture=
False)`) equals the eager verify bit for bit.
"""

import re

import numpy as np
import pytest
import torch

from distributed_llama_tpu.runtime import speculative as jspec
from distributed_llama_tpu.runtime.batch_session import BatchSession as JSession
from distributed_llama_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llama_tpu.runtime.telemetry import StepStats
from distributed_llama_tpu_torch import cli as pcli
from distributed_llama_tpu_torch.formats.mfile import ArchType
from distributed_llama_tpu_torch.parallel import make_mesh
from distributed_llama_tpu_torch.runtime import speculative as pspec
from distributed_llama_tpu_torch.runtime.batch_session import BatchSession
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
from distributed_llama_tpu_torch.runtime.graphs import DecodeGraphs
from distributed_llama_tpu_torch.runtime.speculative import ModelDraft, NGramDraft
from distributed_llama_tpu_torch.testing import tiny_header, write_tiny_model, write_tiny_tokenizer
from distributed_llama_tpu_torch.tokenizer import Sampler

torch.set_num_threads(1)

# the verify logits against JAX's, f32 compute on both sides; the logits
# are of order 1. On a float cache the two differ by f32 sums in other
# orders; on the int8 cache a K/V value that lands on a rounding boundary
# may quantize one step apart, which moves these logits by up to ~6e-4
VERIFY_ATOL = {None: 1e-4, "int8": 2e-3}
# a verify's logits against the stepwise decode's, of order 1 (measured:
# 7e-7 in f32 and 6e-8 in bf16 on the CPU)
STEPWISE_ATOL = 1e-5
PROMPT = [3, 17, 99, 4]
LAYOUTS = [("contiguous", None), ("paged", None), ("paged", "int8")]
MOE = dict(arch=ArchType.QWEN3_MOE, dim=128, hidden_dim=128, n_layers=2, n_heads=4,
           n_kv_heads=2, head_dim=32, n_experts=16, n_active_experts=2, moe_hidden_dim=128,
           vocab_size=288, seq_len=128)


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("spec") / "m.m")
    write_tiny_model(p, tiny_header(dim=64, hidden_dim=128, n_layers=2, seq_len=128,
                                    vocab_size=288), seed=3)
    return p


@pytest.fixture(scope="module")
def deep_path(tmp_path_factory):
    """seq_len 512: two kv buckets (256, 512), so a round can cross them."""
    p = str(tmp_path_factory.mktemp("spec_deep") / "m.m")
    write_tiny_model(p, tiny_header(dim=64, hidden_dim=128, n_layers=2, seq_len=512,
                                    vocab_size=288), seed=3)
    return p


@pytest.fixture(scope="module")
def moe_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("spec_moe") / "m.m")
    write_tiny_model(p, tiny_header(**MOE), seed=4)
    return p


def _engine(path, static=False, **kw):
    kw.setdefault("compute_dtype", "float32")
    kw.setdefault("decode_chunk_size", 8)
    eng = InferenceEngine(path, device="cpu", **kw)
    if static:
        eng._graphs = DecodeGraphs("cpu", capture=False)
    return eng


def _jengine(path, **kw):
    kw.setdefault("compute_dtype", "float32")
    kw.setdefault("decode_chunk_size", 8)
    return JEngine(path, prefix_cache_mb=0, grammar=False, **kw)


# -- draft sources and resolution --------------------------------------------

_rng = np.random.default_rng(11)
NGRAM_CONTEXTS = [
    [], [1], [1, 2, 3, 4, 5, 6, 7], [1, 2, 3, 4, 5, 2, 3, 9, 8, 2, 3], [2, 3, 7, 7, 3, 5, 2, 3],
    [5, 6, 7, 8, 5, 6], [9, 1, 2, 3, 9, 1], [1, 2, 3, 4, 5, 1, 2],
    *[list(_rng.integers(0, 6, 40)) for _ in range(3)],  # random over a small alphabet
    *[list(_rng.integers(0, 288, 60)) for _ in range(2)],  # random: few matches
    [7, 9, 11, 13] * 12 + [7, 9],  # repetitive
]


@pytest.mark.parametrize("ctx", NGRAM_CONTEXTS)
def test_ngram_draft_matches_jax(ctx):
    for k in (0, 1, 2, 4, 8):
        for n in ((4, 1), (2, 2)):
            assert NGramDraft(*n).draft(ctx, k) == jspec.NGramDraft(*n).draft(ctx, k)
    with pytest.raises(ValueError):
        NGramDraft(1, 2)


def test_ngram_draft_examples():
    """The JAX package's own cases: the most recent match, the longest n,
    a match at the context edge, k respected."""
    ds = NGramDraft()
    assert ds.draft([1, 2, 3, 4, 5, 6, 7], 4) == []
    assert ds.draft([1, 2, 3, 4, 5, 2, 3, 9, 8, 2, 3], 2) == [9, 8]
    assert ds.draft([2, 3, 7, 7, 3, 5, 2, 3], 1) == [7]
    assert ds.draft([5, 6, 7, 8, 5, 6], 4) == [7, 8, 5, 6]
    assert ds.draft([9, 1, 2, 3, 9, 1], 8) == [2, 3, 9, 1]
    assert ds.draft([1, 2, 3, 4, 5, 1, 2], 2) == [3, 4]


@pytest.mark.parametrize("env_mode", [None, "ngram", "model", "off", "bogus", " NGRAM "])
@pytest.mark.parametrize("env_k", [None, "8", "3", "x", "-1"])
def test_resolution_matches_jax(monkeypatch, env_mode, env_k):
    for name, value in (("DLT_SPECULATIVE", env_mode), ("DLT_DRAFT_K", env_k)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    for explicit in (None, "off", "ngram", "model", "Ngram"):
        for default in ("off", "ngram"):
            assert (pspec.resolve_spec_mode(explicit, default=default)
                    == jspec.resolve_spec_mode(explicit, default=default))
    with pytest.raises(ValueError):
        pspec.resolve_spec_mode("bogus")
    for k in (None, 0, -2, 1, 3, 8, 9):
        assert pspec.resolve_draft_k(k) == jspec.resolve_draft_k(k)
    assert pspec.SPEC_MODES == jspec.SPEC_MODES and pspec.DRAFT_BUCKETS == jspec.DRAFT_BUCKETS


def test_buckets_acceptance_and_counters_match_jax():
    for k in range(1, 12):
        assert pspec.spec_buckets(k) == jspec.spec_buckets(k)
        for buckets in ((4,), (4, 8)):
            assert pspec.choose_bucket(buckets, k) == jspec.choose_bucket(buckets, k)
    rng = np.random.default_rng(5)
    for _ in range(20):
        drafts = list(rng.integers(0, 3, rng.integers(0, 9)))
        ids = rng.integers(0, 3, len(drafts) + 1)
        assert pspec.accept_greedy(drafts, ids) == jspec.accept_greedy(drafts, ids)
    counters, stats = {}, StepStats()
    for drafted, accepted in ((4, 2), (8, 8), (3, 0), (0, 0)):
        pspec.note_round(counters, drafted, accepted)
        jspec.note_round(stats, drafted, accepted)
    want = stats.counters_snapshot()
    assert {k: counters[k] for k in want} == want
    assert counters["spec_acceptance_rate"] == stats.gauges_snapshot()["spec_acceptance_rate"]


def test_model_mode_requires_a_draft_source(path):
    with pytest.raises(ValueError, match="draft_source"):
        _engine(path, speculative="model")
    assert pspec.build_draft_source(None) is None
    assert isinstance(pspec.build_draft_source("ngram"), NGramDraft)


# -- the verify forward against JAX's ----------------------------------------


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("layout,kv", LAYOUTS)
def test_verify_matches_jax(path, layout, kv, per_row):
    """The same cache state in both engines (the same prefill; per row, a
    batch of 3 with different prompts and row 1 parked), then one verify
    over the same feed: ids equal, logits within VERIFY_ATOL; the port's
    static-buffer verify equal to its eager verify bit for bit."""
    b = 3 if per_row else 1
    kw = dict(batch=b, kv_layout=layout, cache_dtype=kv, speculative="ngram", draft_k=8)
    prompts = [PROMPT, [5, 5, 5, 5, 5, 5, 9], list(range(1, 40))]
    feed = np.array([[p[-1], 11, 12, 13, 14, 15, 16, 17, 18] for p in prompts[:b]], np.int64)
    kvb = seq_len = 128
    if per_row:
        pos = np.array([len(p) - 1 for p in prompts], np.int64)
        pos[1] = seq_len  # parked
    else:
        pos = len(PROMPT) - 1

    def boot(eng, session):
        if per_row:
            s = session(eng)
            for r in (0, 2):
                s.admit(r, prompts[r])
        else:
            eng.prefill(PROMPT[:-1])

    jeng = _jengine(path, **kw)
    boot(jeng, JSession)
    jids, jlogits = jeng._dispatch_verify(feed.astype(np.int32),
                                          pos.astype(np.int32) if per_row else pos, kvb)
    jids, jlogits = np.asarray(jids), np.asarray(jlogits)
    got = []
    for static in (False, True):
        eng = _engine(path, static, **kw)
        boot(eng, BatchSession)
        ids, logits = eng._dispatch_verify(feed, pos, kvb)
        got.append((ids.clone(), logits.clone()))
        if static:
            key = eng._graph_key("verify_row" if per_row else "verify", kvb, "greedy", 9)
            assert [k for k in eng._graphs.graphs if k.kind.startswith("verify")] == [key]
    (ids, logits), (sids, slogits) = got
    assert torch.equal(ids, sids) and torch.equal(logits, slogits)
    live = [0, 2] if per_row else [0]
    np.testing.assert_array_equal(ids.numpy()[live], jids[live])
    np.testing.assert_allclose(logits.numpy()[live], jlogits[live], rtol=0,
                               atol=VERIFY_ATOL[kv])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_logits_match_stepwise_logits(path, dtype):
    """A verify over the greedy chain's own tokens gives the stepwise decode
    logits at every position within STEPWISE_ATOL (five rows of a matmul
    sum in another order than one) and accepts the whole draft."""
    step = _engine(path, compute_dtype=dtype)
    step.prefill(PROMPT[:-1])
    tok, p, chain = PROMPT[-1], len(PROMPT) - 1, []
    for _ in range(5):
        lg = step.decode_one(tok, p)[0]
        chain.append(lg.copy())
        tok, p = int(np.argmax(lg)), p + 1
    drafts = [int(np.argmax(l)) for l in chain[:4]]
    eng = _engine(path, compute_dtype=dtype, speculative="ngram")
    eng.prefill(PROMPT[:-1])
    ids, logits = eng._dispatch_verify(np.array([[PROMPT[-1]] + drafts]), len(PROMPT) - 1, 128)
    np.testing.assert_allclose(logits[0].numpy(), np.stack(chain), rtol=0, atol=STEPWISE_ATOL)
    assert pspec.accept_greedy(drafts, ids[0].tolist()) == 4


# -- generate ----------------------------------------------------------------

_TIMING_KEYS = ("rounds", "fallback_chunks", "draft_tokens", "accepted_tokens",
                "emitted_tokens", "acceptance_rate")


@pytest.mark.parametrize("model,layout,kv,draft_k", [
    ("llama", "contiguous", None, 4), ("llama", "contiguous", None, 8),
    ("llama", "paged", None, 4), ("llama", "paged", "int8", 8), ("moe", "contiguous", None, 4),
])
def test_generate_matches_jax(path, moe_path, model, layout, kv, draft_k):
    """ngram speculation: the JAX spec engine's tokens, rounds, drafts and
    acceptance; the port's own tokens without speculation; the static
    verify path alike."""
    p = path if model == "llama" else moe_path
    kw = dict(kv_layout=layout, cache_dtype=kv)
    steps = 60
    jeng = _jengine(p, speculative="ngram", draft_k=draft_k, **kw)
    want = jeng.generate(PROMPT, steps, sampler=None).tokens
    plain = _engine(p, **kw).generate(PROMPT, steps).tokens
    for static in (False, True):
        eng = _engine(p, static, speculative="ngram", draft_k=draft_k, **kw)
        got = eng.generate(PROMPT, steps).tokens
        assert got == want == plain
        t, jt = eng.last_spec_timing, jeng.last_spec_timing
        assert {k: t[k] for k in _TIMING_KEYS} == {k: jt[k] for k in _TIMING_KEYS}
        assert t["rounds"] > 0 and t["fallback_chunks"] > 0
        assert 0 < t["accepted_tokens"] <= t["draft_tokens"]
        jc = jeng.stats.counters_snapshot()
        assert {k: eng.spec_counters[k] for k in jc if k.startswith("spec_")} == {
            k: v for k, v in jc.items() if k.startswith("spec_")}
        assert pspec.spec_snapshot(eng) == jspec.spec_snapshot(jeng)
    if static and model == "moe":
        # t = 5 at batch 1 is 10 expert rows < 16: the gather arm, graphed
        assert any(k.kind == "verify" for k in eng._graphs.graphs)


def test_stop_fn_and_streaming_equal_plain_decode(path):
    def run(spec):
        eng = _engine(path, speculative="ngram" if spec else "off")
        seen, n = [], {"n": 0}

        def stop(t):
            n["n"] += 1
            return n["n"] >= 17

        res = eng.generate(PROMPT, 80, on_token=seen.append, stop_fn=stop)
        return res.tokens, seen

    (ta, sa), (tb, sb) = run(True), run(False)
    assert ta == tb and sa == sb and len(sa) == 17


def test_sampled_generation_bypasses_speculation(path):
    a = _engine(path, speculative="ngram")
    b = _engine(path)
    ta = a.generate(PROMPT, 40, sampler=Sampler(288, 0.8, 0.9, 42)).tokens
    assert ta == b.generate(PROMPT, 40, sampler=Sampler(288, 0.8, 0.9, 42)).tokens
    assert "spec_rounds" not in a.spec_counters and a.last_spec_timing is None
    assert pspec.spec_snapshot(b) is None


def test_host_decode_engine_bypasses_speculation(path):
    """device_decode=False: no verify kinds on the ladder, and generate and
    generate_batch take the plain paths."""
    prompts = [PROMPT, [5, 5, 5, 5]]
    eng = _engine(path, batch=2, device_decode=False, speculative="ngram")
    assert not any(k[0].startswith("verify") for k in eng.warm_plan())
    outs = eng.generate_batch(prompts, 12)
    eng.generate(PROMPT, 20)
    assert "spec_rounds" not in eng.spec_counters
    assert outs == _engine(path, batch=2, device_decode=False).generate_batch(prompts, 12)


def test_round_crossing_the_kv_bucket(deep_path):
    """Rounds written across the 256 bucket boundary: the plain tokens, and a
    verify graph of the 512 bucket."""
    prompt = ([7, 9, 11, 13] * 64)[:250]
    want = _engine(deep_path).generate(prompt, len(prompt) + 24).tokens
    eng = _engine(deep_path, True, speculative="ngram")
    assert eng.generate(prompt, len(prompt) + 24).tokens == want
    assert 512 in {k.kv_bucket for k in eng._graphs.graphs if k.kind == "verify"}
    assert eng.spec_counters["spec_rounds"] > 0


def test_kmax_guard_at_the_end_of_the_context(path):
    """Near seq_len a bucket is used only where its whole feed fits; the
    last positions fall back to plain chunks. Tokens equal plain decode to
    the last position, on the contiguous layout (where a write past the
    cache would index out of it) and on the paged one."""
    prompt = ([7, 9, 11, 13] * 40)[:118]
    for layout in ("contiguous", "paged"):
        want = _engine(path, kv_layout=layout).generate(prompt, 128).tokens
        eng = _engine(path, True, kv_layout=layout, speculative="ngram", draft_k=8)
        assert eng.generate(prompt, 128).tokens == want and len(want) == 129
        assert eng.last_spec_timing["rounds"] > 0


def test_sp_mesh_speculates_eagerly(deep_path):
    """On an sp mesh a round runs eagerly at the int position: the plain
    tokens."""
    mesh = make_mesh(sp=2, devices=["cpu"] * 2)
    want = _engine(deep_path, mesh=None).generate(PROMPT * 3, 60).tokens
    eng = InferenceEngine(deep_path, compute_dtype="float32", decode_chunk_size=8,
                          mesh=mesh, speculative="ngram")
    assert eng.generate(PROMPT * 3, 60).tokens == want
    assert eng.last_spec_timing["rounds"] > 0


# -- ModelDraft --------------------------------------------------------------


def test_model_draft_same_model_accepts_everything(path):
    want = _engine(path).generate(PROMPT, 40).tokens
    draft = _engine(path)
    eng = _engine(path, True, speculative="model", draft_source=ModelDraft(draft))
    assert eng.generate(PROMPT, 40).tokens == want
    t = eng.last_spec_timing
    assert t["rounds"] > 0 and t["acceptance_rate"] == 1.0
    closed = []
    draft.close = lambda: closed.append(True)
    eng.close()  # closes the draft engine through the source
    assert closed == [True]


def test_model_draft_refuses_a_batched_draft_engine(path):
    with pytest.raises(ValueError, match="batch=1"):
        ModelDraft(_engine(path, batch=2))


def test_model_draft_snaps_odd_k_to_the_decode_ladder(path):
    draft = _engine(path, kv_layout="paged")
    sizes = []
    chunk = draft._decode_chunk

    def spy(tok, pos, n, *a, **kw):
        sizes.append(n)
        return chunk(tok, pos, n, *a, **kw)

    draft._decode_chunk = spy
    ds = ModelDraft(draft)
    assert len(ds.draft(PROMPT, 3)) == 3 and len(ds.draft(PROMPT + [5], 5)) == 5
    assert sizes == [4, 8]
    plain = _engine(path).generate(PROMPT, 12).tokens
    assert ds.draft(plain, 3) == _engine(path).generate(plain, 15).tokens[len(plain):]


def test_cli_model_draft_and_draft_k(tmp_path, capsys):
    """`--speculative model --draft-model` (the same file: every draft is
    accepted) and `--draft-k` print the tokens of `--speculative off`."""
    mp, tp = str(tmp_path / "m.m"), str(tmp_path / "t.t")
    write_tiny_model(mp, tiny_header(dim=64, hidden_dim=128, n_layers=2, seq_len=128,
                                     vocab_size=288), seed=3)
    write_tiny_tokenizer(tp, pad_to=288)
    args = ["inference", "--model", mp, "--tokenizer", tp, "--prompt", "abcabcabcab",
            "--steps", "60", "--temperature", "0", "--device", "cpu"]

    def tokens(extra):
        """The Pred lines, and their text joined: a line is "| (n tokens)
        text", without the count for one token and with "~" for no text
        (split at newlines only: a token's text may hold a control
        character that `splitlines` would split at)."""
        assert pcli.main(args + extra) == 0
        lines = [l.split("| ", 1)[1] for l in capsys.readouterr().out.split("\n")
                 if l.startswith("🔶 Pred")]
        texts = [re.sub(r"^\(\d+ tokens\) ", "", l) for l in lines]
        return lines, "".join("" if t == "~" else t for t in texts)

    off_lines, off = tokens(["--speculative", "off"])
    for extra in (["--speculative", "model", "--draft-model", mp],
                  ["--draft-k", "8"], ["--speculative", "ngram", "--draft-k", "2"]):
        lines, text = tokens(extra)
        assert text == off and lines != off_lines, extra


def test_cli_perplexity_ignores_speculation(tmp_path, monkeypatch, capsys):
    """perplexity never decodes: the same output with speculation at its
    default, off, and in the JAX CLI at its default."""
    from distributed_llama_tpu import cli as jcli

    mp, tp = str(tmp_path / "m.m"), str(tmp_path / "t.t")
    write_tiny_model(mp, tiny_header(dim=64, hidden_dim=128, n_layers=2, seq_len=128,
                                     vocab_size=288), seed=3)
    write_tiny_tokenizer(tp, pad_to=288)
    monkeypatch.setenv("DLT_GRAMMAR", "0")
    monkeypatch.delenv("DLT_SPECULATIVE", raising=False)
    args = ["perplexity", "--model", mp, "--tokenizer", tp, "--prompt", "hello hello world"]

    def results(main, extra):
        assert main(args + extra) == 0
        return [l for l in capsys.readouterr().out.splitlines()
                if "prob=" in l or l.strip().startswith(("perplexity:", "avgLogProb:"))]

    on = results(pcli.main, ["--device", "cpu"])
    assert len(on) > 4 and on == results(pcli.main, ["--device", "cpu", "--speculative", "off"])
    want = results(jcli.main, [])
    assert want == results(jcli.main, ["--speculative", "off"])
    got = [float(l.split("prob=")[1]) for l in on if "prob=" in l]
    np.testing.assert_allclose(got, [float(l.split("prob=")[1]) for l in want if "prob=" in l],
                               rtol=1e-2, atol=1e-6)


# -- generate_batch and BatchSession -----------------------------------------


@pytest.mark.parametrize("layout,kv", [("contiguous", None), ("paged", "int8")])
def test_generate_batch_mixed_rows(path, layout, kv):
    """Per-row speculation on a mixed batch with per-row budgets: the plain
    chunked loop's rows and streams, and the JAX spec engine's rows."""
    prompts = [PROMPT, [5, 5, 5, 5, 5, 5], [7, 1]]
    budgets = [40, 25, 10]
    kw = dict(batch=3, kv_layout=layout, cache_dtype=kv)

    def run(spec, static=False):
        eng = _engine(path, static, speculative="ngram" if spec else "off", draft_k=8, **kw)
        streamed = [[] for _ in prompts]
        outs = eng.generate_batch(prompts, budgets, on_token=lambda r, t: streamed[r].append(t))
        return eng, outs, streamed

    _, off, s_off = run(False)
    for static in (False, True):
        eng, on, s_on = run(True, static)
        assert on == off and s_on == s_off
        assert [len(o) for o in on] == budgets
        assert eng.spec_counters["spec_rounds"] > 0
    assert any(k.kind == "verify_row" for k in eng._graphs.graphs)
    jeng = _jengine(path, speculative="ngram", draft_k=8, **kw)
    assert jeng.generate_batch(prompts, budgets, sampler=None) == on
    jc = jeng.stats.counters_snapshot()
    assert eng.spec_counters["spec_rounds"] == jc["spec_rounds"]
    assert eng.spec_counters["spec_accepted_tokens"] == jc["spec_accepted_tokens"]


def test_generate_batch_stop_fn(path):
    prompts = [PROMPT, [5, 5, 5, 5]]

    def run(spec):
        eng = _engine(path, batch=2, speculative="ngram" if spec else "off")
        return eng.generate_batch(prompts, 30, stop_fn=lambda r, t: t == 220)

    assert run(True) == run(False)


@pytest.mark.parametrize("layout,kv", [("contiguous", None), ("paged", "int8")])
def test_spec_step_mixed_accept_reject(path, layout, kv):
    """A round with a fully accepted row and a fully rejected one: the rows
    advance unevenly, each along its own plain chain."""
    def boot(spec, static=False):
        eng = _engine(path, static, batch=2, kv_layout=layout, cache_dtype=kv,
                      speculative="ngram" if spec else "off")
        s = BatchSession(eng)
        s.admit(0, PROMPT)
        s.admit(1, [5, 5, 5, 5])
        return eng, s

    _, oracle = boot(False)
    plain = oracle.step(5)
    for static in (False, True):
        eng, sess = boot(True, static)
        good = [int(t) for t in plain[0, :4]]
        out = sess.spec_step({0: good, 1: [280, 281, 282, 283]})
        assert out[0] == [int(t) for t in plain[0, :5]]
        assert out[1] == [int(plain[1, 0])]
        assert int(sess.pos[0]) - int(sess.pos[1]) == 4
        c = eng.spec_counters
        assert c["spec_accepted_tokens"] == 4 and c["spec_rejected_tokens"] == 4
        out2 = sess.spec_step({0: [], 1: [int(plain[1, 1])]})
        assert len(out2[0]) == 1
        assert out2[1] == [int(plain[1, 1]), int(plain[1, 2])]


def test_spec_step_guards(path):
    eng = _engine(path, batch=2, speculative="ngram")
    s = BatchSession(eng)
    s.admit(0, PROMPT, temperature=0.7)
    with pytest.raises(ValueError, match="greedy-only"):
        s.spec_step({0: [1, 2]})
    with pytest.raises(ValueError, match="not active"):
        s.spec_step({1: [1, 2]})
    assert s.spec_step({}) == {}
    s.release(0)
    s.admit(0, [1] * 126)  # pos 125 of seq_len 128: no room for K + 1
    with pytest.raises(ValueError, match="overrun"):
        s.spec_step({0: [1, 2, 3, 4]})
    with pytest.raises(ValueError, match="not enabled"):
        BatchSession(_engine(path, batch=2)).spec_step({0: []})


# -- the warm ladder ---------------------------------------------------------


@pytest.mark.parametrize("batch,draft_k,max_seq_len,device_decode", [
    (1, 4, 0, True), (3, 8, 0, True), (2, 8, 100, True), (2, 4, 0, False), (1, 2, 0, True),
])
def test_warm_plan_matches_jax(deep_path, batch, draft_k, max_seq_len, device_decode):
    kw = dict(batch=batch, draft_k=draft_k, max_seq_len=max_seq_len,
              device_decode=device_decode, speculative="ngram", decode_chunk_size=16)
    kinds = ("prefill", "decode", "prefill_row", "batch_decode", "verify", "verify_row")
    want = [t for t in _jengine(deep_path, **kw).warm_plan() if t[0] in kinds]
    got = _engine(deep_path, **kw).warm_plan()
    assert got == want
    assert any(t[0] == "verify" for t in got) == device_decode


def test_warmup_covers_a_pinned_spec_trace(deep_path):
    """warmup() registers every verify key of the ladder; a spec generate
    across two kv buckets, a generate_batch and BatchSession rounds then
    register none."""
    eng = _engine(deep_path, True, batch=3, kv_layout="paged", cache_dtype="int8",
                  speculative="ngram", draft_k=8, decode_chunk_size=16)
    stats = eng.warmup()
    n_kvb = len(eng._kv_buckets())
    verify = [k for k in eng._graphs.graphs if k.kind.startswith("verify")]
    assert len(verify) == 2 * 2 * n_kvb  # 2 kinds x 2 buckets
    prefill = [k for k in eng._graphs.graphs if k.kind.startswith("prefill")]
    assert len(prefill) == sum(k[0].startswith("prefill") for k in eng.warm_plan())
    assert stats["captures"] == 2 * 3 * n_kvb + len(verify) + len(prefill)
    prompt = ([7, 9, 11, 13] * 64)[:240]
    eng.generate(prompt, 300, on_token=lambda t: None)
    eng.generate_batch([PROMPT, [5] * 6, prompt[:50]], [30, 20, 12])
    s = BatchSession(eng)
    s.admit(0, PROMPT)
    s.admit(2, prompt[:100])
    s.spec_step({0: [1, 2, 3], 2: [9, 11, 13, 7, 9, 11, 13, 7]})
    s.step(8)
    s.spec_step({2: []})
    assert eng.graph_stats()["recaptures_after_warmup"] == 0
    assert eng.spec_counters["spec_rounds"] > 0


def test_graph_eligible_counts_verify_rows(moe_path):
    """The MoE grouped arm (b * t * n_active >= n_experts) stays eager: at
    16 experts and 2 active, a verify of 5 tokens a row is graphed at batch
    1 and eager at batch 2; 9 tokens are eager at batch 1."""
    eng = _engine(moe_path, speculative="ngram", draft_k=8)
    assert eng.graph_eligible("verify", 1, size=5)
    assert not eng.graph_eligible("verify", 1, size=9)
    assert not eng.graph_eligible("verify_row", 2, size=5)
    assert eng.graph_eligible("decode", 7) and not eng.graph_eligible("batch_decode", 8)
    with pytest.raises(ValueError):
        eng.graph_eligible("prefix_copy")
    # the 9-token round then runs eagerly and gives the plain tokens
    static = _engine(moe_path, True, speculative="ngram", draft_k=8)
    assert static.generate(PROMPT * 4, 60).tokens == _engine(moe_path).generate(PROMPT * 4,
                                                                                  60).tokens
    assert all(k.size != 9 for k in static._graphs.graphs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,t", [(1, 5), (1, 9), (2, 5), (4, 5)])
def test_verify_takes_gather_arm_names_the_moe_arm(moe_path, monkeypatch, batch, t, dtype):
    """The MoE arm a verify round of t tokens at `batch` rows takes (16
    experts, 2 active), as `_moe_ffn`'s rules name it: in f32 the gather
    arm at 10 expert rows, the grouped arm at 18 and more
    (`moe_grouped`); on the bf16 kernel path (the engine's `_moe_k4`) K4
    at every row count (`moe_small_rows_grouped` below the grouped arm),
    and the gather arm never."""
    from distributed_llama_tpu_torch.models import transformer

    calls, arms = [], []
    real = transformer._gather_expert
    small = transformer.moe_small_rows_grouped
    monkeypatch.setattr(transformer, "_gather_expert", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(transformer, "moe_small_rows_grouped",
                        lambda *a: arms.append(small(*a)) or arms[-1])
    eng = _engine(moe_path, batch=batch, compute_dtype=dtype)
    pspec.verify_chunk(eng.cfg, eng.params, eng.rope, eng.cache,
                       torch.zeros((batch, t), dtype=torch.long), 0)
    grouped = transformer.moe_grouped(eng.cfg, batch * t)
    assert eng._moe_k4 == (dtype == "bfloat16")
    assert grouped == (batch * t * 2 >= 16)
    assert arms == ([] if grouped else [eng._moe_k4] * eng.cfg.n_layers)
    assert bool(calls) == (not grouped and not eng._moe_k4)


def test_cli_default_is_off_where_a_round_takes_the_moe_gather_arm(path, moe_path,
                                                                     monkeypatch):
    """The CLI's speculation default is ngram, the JAX CLI's, on every
    model: a MoE model's round no longer turns it off (its FFN takes K4 on
    the bf16 kernel path, `moe_small_rows_grouped`); the flag and
    DLT_SPECULATIVE still set it."""
    monkeypatch.delenv("DLT_SPECULATIVE", raising=False)

    def mode(p, *extra):
        eng = pcli.make_engine(pcli.build_arg_parser().parse_args(
            ["inference", "--model", p, "--device", "cpu", "--prefix-cache-mb", "0", *extra]))
        eng.close()
        return eng.spec_mode

    assert mode(path) == "ngram"
    assert mode(moe_path) == "ngram"
    assert mode(moe_path, "--batch", "2") == "ngram"
    assert mode(moe_path, "--speculative", "off") is None
    monkeypatch.setenv("DLT_SPECULATIVE", "off")
    assert mode(moe_path) is None


def test_set_speculation_switches_the_engine(path):
    """`set_speculation` is the one place the mode, draft_k, buckets and
    draft source are set: a replaced source is closed, and one engine
    switched between off, k 4 and k 8 gives the plain tokens each time,
    its verify graphs and buffers made per feed length at first use."""
    want = _engine(path).generate(PROMPT * 4, 40).tokens
    eng = _engine(path, True, speculative="ngram", draft_k=8)
    closed = []
    eng.draft_source.close = lambda: closed.append(1)
    eng.set_speculation("off")
    assert (eng.spec_mode, eng.spec_buckets, eng.draft_source, closed) == (None, (), None, [1])
    assert eng.generate(PROMPT * 4, 40).tokens == want
    for k, buckets in ((4, (4,)), (8, (4, 8))):
        eng.set_speculation("ngram", k)
        assert (eng.spec_mode, eng.draft_k, eng.spec_buckets) == ("ngram", k, buckets)
        assert isinstance(eng.draft_source, NGramDraft)
        eng.reset()
        assert eng.generate(PROMPT * 4, 40).tokens == want
        assert eng.last_spec_timing["rounds"] > 0
    sizes = sorted({key.size for key in eng._graphs.graphs if key.kind == "verify"})
    assert sizes == sorted(eng._bufs.feed) == [5, 9]
