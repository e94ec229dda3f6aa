"""The port's grammar-constrained decoding (runtime/grammar.py and its
threading through the decode and verify steps) on the CPU, against the JAX
package's.

The compiler, arena and sessions are a numpy copy of JAX's: their tables,
versions and walks must be equal exactly. The mask (`apply_grammar_mask`)
is a gather and a `where` on both sides: equal exactly. Engines run f32
compute on the tiny fabricated model with the byte tokenizer padded to
288 (the fixture of tests/test_grammar.py): constrained greedy tokens equal
the JAX engine's with `grammar=True` on the contiguous, paged and paged
int8 layouts, through `generate`, ngram speculation, `generate_batch` and
`BatchSession` (`step` and `spec_step`), with no illegal token and the
output a full match of the grammar. A free row on a grammar engine rides
the FREE state and equals its run on a grammar-less engine bit for bit.
Each engine case also runs on the static buffers the CUDA graphs capture
(`DecodeGraphs(capture=False)`), which must give the eager tokens.
"""

import warnings

import numpy as np
import pytest
import torch

from distributed_llama_tpu.ops import sampling as jsampling
from distributed_llama_tpu.runtime import grammar as jgr
from distributed_llama_tpu.runtime.batch_session import BatchSession as JSession
from distributed_llama_tpu.runtime.engine import InferenceEngine as JEngine
from distributed_llama_tpu.testing import ascii_vocab_tokenizer as j_ascii_vocab_tokenizer
from distributed_llama_tpu.testing import byte_vocab_tokenizer as j_byte_vocab_tokenizer
from distributed_llama_tpu.tokenizer import Tokenizer as JTokenizer
from distributed_llama_tpu_torch import cli as pcli
from distributed_llama_tpu_torch.ops.sampling import advance_grammar, apply_grammar_mask
from distributed_llama_tpu_torch.parallel import make_mesh
from distributed_llama_tpu_torch.runtime import grammar as pgr
from distributed_llama_tpu_torch.runtime.batch_session import BatchSession
from distributed_llama_tpu_torch.runtime.engine import InferenceEngine
from distributed_llama_tpu_torch.runtime.graphs import DecodeGraphs
from distributed_llama_tpu_torch.testing import (
    ascii_vocab_tokenizer, byte_vocab_tokenizer, tiny_header, write_tiny_model,
    write_tiny_tokenizer,
)
from distributed_llama_tpu_torch.tokenizer import Sampler, Tokenizer

torch.set_num_threads(1)

V = 288
#: a schema every tiny random model can finish: a boolean forces a short,
#: fully determined tail (tests/test_grammar.py's)
BOOL_SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}}}
#: an object with an enum, an integer and a nested boolean
OBJ_SCHEMA = {"type": "object", "properties": {
    "kind": {"enum": ["cat", "dog", 7, None]}, "n": {"type": "integer"},
    "inner": {"type": "object", "properties": {"flag": {"type": "boolean"}}}}}
GRAMMARS = {
    "yesno": ("regex", "(?:yes|no)"),
    "bool": ("json_schema", pgr.schema_to_regex(BOOL_SCHEMA)),
    "literal": ("regex", pgr.regex_escape("a+b(c)*[d]")),
    "obj": ("json_schema", pgr.schema_to_regex(OBJ_SCHEMA)),
    "repeat": ("regex", "(?:yes,)*no"),
}
PROMPT = [5, 9, 17, 3]
LAYOUTS = [("contiguous", None), ("paged", None), ("paged", "int8")]


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("grammar") / "m.m")
    write_tiny_model(p, tiny_header(dim=64, hidden_dim=128, n_layers=2, seq_len=256,
                                    vocab_size=V), seed=3)
    return p


@pytest.fixture(scope="module")
def tok():
    return Tokenizer(byte_vocab_tokenizer(pad_to=V))


@pytest.fixture(scope="module")
def comp(tok):
    return pgr.GrammarCompiler(tok, vocab_size=V)


@pytest.fixture(scope="module")
def jcomp():
    return jgr.GrammarCompiler(JTokenizer(j_byte_vocab_tokenizer(pad_to=V)), vocab_size=V)


@pytest.fixture(autouse=True)
def _no_grammar_env(monkeypatch):
    for name in ("DLT_GRAMMAR", "DLT_GRAMMAR_MAX_STATES", "DLT_GRAMMAR_ARENA_MB",
                 "DLT_GRAMMAR_MAX_SPEC_KB", "DLT_GRAMMAR_CACHE_MB", "DLT_SPECULATIVE"):
        monkeypatch.delenv(name, raising=False)


def _engine(path, static=False, **kw):
    kw.setdefault("compute_dtype", "float32")
    kw.setdefault("max_chunk", 8)
    kw.setdefault("decode_chunk_size", 4)
    kw.setdefault("prefix_cache_mb", 0)
    eng = InferenceEngine(path, device="cpu", **kw)
    if static:
        eng._graphs = DecodeGraphs("cpu", capture=False)
    return eng


def _jengine(path, **kw):
    kw.setdefault("compute_dtype", "float32")
    kw.setdefault("max_chunk", 8)
    kw.setdefault("decode_chunk_size", 4)
    kw.setdefault("prefix_cache_mb", 0)
    return JEngine(path, **kw)


def _replay(tok, g, gen):
    """Walk `gen` through a fresh session: (decoded bytes, illegal tokens,
    finished), the legality and validity oracle of a constrained stream."""
    s = pgr.GrammarSession(pgr.GrammarArena(V, n_states=g.n_states + 1), g)
    out, illegal = b"", 0
    for t in gen:
        if s.done:
            break
        r = s.advance(int(t))
        if r == "illegal":
            illegal += 1
        elif r != "eos":
            out += tok.vocab[int(t)]
        if s.done or s.at_terminal:
            break
    finished = s.done or s.at_terminal
    s.close()
    return out, illegal, finished


#: grammars a tiny random model may not finish in a test's budget (an
#: unbounded integer): held to legality only
UNBOUNDED = ("obj",)


def _valid(tok, g, gen, name=None):
    """No illegal token; finished and a full match unless `name` is
    UNBOUNDED."""
    out, illegal, finished = _replay(tok, g, gen)
    assert illegal == 0, gen
    if name not in UNBOUNDED:
        assert finished and g.fullmatch(out), out


def _same_grammar(a, b):
    assert (a.key, a.kind, a.pattern) == (b.key, b.kind, b.pattern)
    assert a.eos_ids == b.eos_ids
    for f in ("table", "trans_byte", "accepting", "terminal"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


# -- the compiler ------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(GRAMMARS))
def test_compiled_grammar_equals_jax(comp, jcomp, name):
    kind, pattern = GRAMMARS[name]
    _same_grammar(comp.compile(kind, pattern), jcomp.compile(kind, pattern))


@pytest.mark.parametrize("schema", [
    BOOL_SCHEMA, OBJ_SCHEMA, {"type": "string"}, {"type": "string", "minLength": 2, "maxLength": 5},
    {"type": "number"}, {"type": "null"}, {"const": {"a": [1, 2]}},
    {"type": "array", "items": {"type": "boolean"}, "minItems": 1, "maxItems": 3},
    {"type": "array"}, {"type": "array", "maxItems": 0}, {"type": "object"},
])
def test_schema_to_regex_equals_jax(schema):
    assert pgr.schema_to_regex(schema) == jgr.schema_to_regex(schema)


def _raises_like_jax(fn, jfn):
    """Both raise, with the same type name and message."""
    with pytest.raises(Exception) as want:
        jfn()
    with pytest.raises(Exception) as got:
        fn()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    return got.value


@pytest.mark.parametrize("bad", [
    "nope", {"type": "banana"}, {"type": "regex"}, {"type": "regex", "regex": 7},
    {"type": "json_schema"}, {"type": "json_schema", "json_schema": "notadict"},
    {"type": "json_schema", "schema": {"type": "tuple"}},
    {"type": "json_schema", "schema": {"enum": []}},
    {"type": "json_schema", "schema": {"type": "string", "maxLength": 1000}},
])
def test_parse_response_format_refusals_equal_jax(bad):
    err = _raises_like_jax(lambda: pgr.parse_response_format(bad),
                           lambda: jgr.parse_response_format(bad))
    assert isinstance(err, pgr.GrammarError) and isinstance(err, ValueError)


@pytest.mark.parametrize("rf", [
    {"type": "regex", "regex": "a|b"}, {"type": "regex", "pattern": "[0-9]+"},
    {"type": "json_schema", "json_schema": {"name": "t", "schema": BOOL_SCHEMA}},
    {"type": "json_schema", "schema": OBJ_SCHEMA},
])
def test_parse_response_format_equals_jax(rf, comp, jcomp):
    assert pgr.parse_response_format(rf) == jgr.parse_response_format(rf)
    _same_grammar(comp.compile_request(rf), jcomp.compile_request(rf))


@pytest.mark.parametrize("pattern", ["(ab", "ab)", "[ab", "*a", "a{600}", "[z-a]", "\\xZZ", "a|"])
def test_regex_errors_equal_jax(comp, jcomp, pattern):
    if pattern == "a|":  # an empty branch compiles: the same grammar
        _same_grammar(comp.compile("regex", pattern), jcomp.compile("regex", pattern))
        return
    _raises_like_jax(lambda: comp.compile("regex", pattern),
                     lambda: jcomp.compile("regex", pattern))


def test_state_cap_and_dead_end_equal_jax(monkeypatch, tok):
    """The grammar-bomb cap and the vocabulary dead-end check raise as
    JAX's do; the spec-size cap too."""
    monkeypatch.setenv("DLT_GRAMMAR_MAX_STATES", "4")
    _raises_like_jax(lambda: pgr.GrammarCompiler(tok, V).compile("regex", "abcdefghij"),
                     lambda: jgr.GrammarCompiler(tok, V).compile("regex", "abcdefghij"))
    monkeypatch.delenv("DLT_GRAMMAR_MAX_STATES")
    pa = pgr.GrammarCompiler(Tokenizer(ascii_vocab_tokenizer(pad_to=V)), V)
    ja = jgr.GrammarCompiler(JTokenizer(j_ascii_vocab_tokenizer(pad_to=V)), V)
    err = _raises_like_jax(lambda: pa.compile("regex", "a\tb"), lambda: ja.compile("regex", "a\tb"))
    assert "dead-ends" in str(err)
    monkeypatch.setenv("DLT_GRAMMAR_MAX_SPEC_KB", "0")
    _raises_like_jax(lambda: pgr.parse_response_format({"type": "regex", "regex": "a"}),
                     lambda: jgr.parse_response_format({"type": "regex", "regex": "a"}))


def test_compile_cache_equals_jax(monkeypatch, tok):
    p, j = pgr.GrammarCompiler(tok, V), jgr.GrammarCompiler(tok, V)
    for kind, pat in (("regex", "(?:a|b)"), ("regex", "(?:a|b)"), ("regex", "x+")):
        p.compile(kind, pat)
        j.compile(kind, pat)
    assert p.cache_stats() == j.cache_stats()
    monkeypatch.setenv("DLT_GRAMMAR_CACHE_MB", "0")
    p.compile("regex", "(?:c|d)")
    j.compile("regex", "(?:c|d)")
    assert p.cache_stats() == j.cache_stats()


@pytest.mark.parametrize("env,explicit,default", [
    (None, None, "0"), (None, None, "1"), (None, True, "0"), (None, False, "1"),
    ("on", None, "0"), ("0", None, "1"), ("yes", False, "1"), ("bogus", None, "1"),
])
def test_resolve_grammar_enabled_equals_jax(monkeypatch, env, explicit, default):
    if env is not None:
        monkeypatch.setenv("DLT_GRAMMAR", env)
    assert pgr.resolve_grammar_enabled(explicit, default) == jgr.resolve_grammar_enabled(
        explicit, default)


# -- the arena and the sessions ------------------------------------------------

# scripted arena traces: ("open", grammar, n) opens n sessions on a grammar,
# ("close", grammar) closes the oldest open one
ARENA_SCRIPTS = {
    "refcount": [("open", "yesno", 2), ("close", "yesno"), ("close", "yesno"),
                 ("open", "bool", 1), ("open", "yesno", 1)],
    "evict": [("open", "yesno", 1), ("close", "yesno"), ("open", "a60", 1),
              ("open", "yesno", 1), ("close", "a60"), ("open", "b20", 1)],
    "exhaust": [("open", "c40", 1), ("open", "d40", 1), ("open", "b70", 1),
                ("close", "c40"), ("open", "d40", 1)],
}
EXTRA = {"a60": ("regex", "a" * 60), "b20": ("regex", "b" * 20), "c40": ("regex", "c" * 40),
         "d40": ("regex", "d" * 40), "b70": ("regex", "b" * 70)}


@pytest.mark.parametrize("script", sorted(ARENA_SCRIPTS))
def test_arena_traces_equal_jax(comp, jcomp, script):
    """Install, refcount, reuse, evict and exhaust: after each step the two
    arenas' tables, versions and snapshots are equal, and a refusal is the
    same refusal."""
    arenas = [pgr.GrammarArena(V, n_states=64), jgr.GrammarArena(V, n_states=64)]
    mods, comps = (pgr, jgr), (comp, jcomp)
    open_ = [{}, {}]
    for op in ARENA_SCRIPTS[script]:
        errs = []
        for i in (0, 1):
            kind, pat = GRAMMARS.get(op[1]) or EXTRA[op[1]]
            g = comps[i].compile(kind, pat)
            try:
                if op[0] == "open":
                    for _ in range(op[2]):
                        open_[i].setdefault(op[1], []).append(mods[i].GrammarSession(arenas[i], g))
                else:
                    open_[i][op[1]].pop(0).close()
                errs.append(None)
            except Exception as e:  # noqa: BLE001 - compared across the packages
                errs.append((type(e).__name__, str(e)))
        assert errs[0] == errs[1], op
        a, b = arenas
        assert a.version == b.version and a.snapshot() == b.snapshot(), op
        assert np.array_equal(a.table, b.table), op
        assert [s.base for s in sum(open_[0].values(), [])] == \
            [s.base for s in sum(open_[1].values(), [])]


def test_arena_budget_equals_jax(monkeypatch):
    """The default 32 MB budget: 65 states at the 1B vocabulary (33.3 MB),
    64 (the floor) at Qwen3's (38.9 MB); other budgets as JAX's."""
    for mb, vocab, states in ((None, 128256, 65), (None, 151936, 64), ("1", V, 910),
                              ("0", 1000, 64)):
        if mb is None:
            monkeypatch.delenv("DLT_GRAMMAR_ARENA_MB", raising=False)
        else:
            monkeypatch.setenv("DLT_GRAMMAR_ARENA_MB", mb)
        a, b = pgr.GrammarArena(vocab), jgr.GrammarArena(vocab)
        assert a.n_states == b.n_states == states
        assert np.array_equal(a.table, b.table) and a.snapshot() == b.snapshot()


TOKEN_LISTS = [
    [ord(c) for c in "yes"], [ord(c) for c in "yeq"], [ord(c) for c in "no"],
    [ord("y"), 266], [ord("n"), ord("o"), 266, ord("y")], [ord(c) for c in "hello"], [],
    [ord(c) for c in '{"ok":true}'] + [266], [ord(c) for c in '{"ok":t'] + [270, ord("r")],
    [9999, ord("y")],
]


@pytest.mark.parametrize("name", ["yesno", "bool", "repeat"])
def test_session_walks_equal_jax(comp, jcomp, name):
    """advance (its results, state, done, terminal, illegal count,
    row_state), legal_prefix and verify_states on pinned token lists,
    from every prefix of each list."""
    kind, pat = GRAMMARS[name]
    for toks in TOKEN_LISTS:
        for cut in range(len(toks) + 1):
            ps = pgr.GrammarSession(pgr.GrammarArena(V, n_states=64), comp.compile(kind, pat))
            js = jgr.GrammarSession(jgr.GrammarArena(V, n_states=64), jcomp.compile(kind, pat))
            for t in toks[:cut]:
                assert ps.advance(t) == js.advance(t)
                assert ps.is_legal(t) == js.is_legal(t)
            rest = toks[cut:]
            assert ps.legal_prefix(rest) == js.legal_prefix(rest)
            a, b = ps.verify_states(rest), js.verify_states(rest)
            assert a.dtype == b.dtype and np.array_equal(a, b)
            assert (ps.state, ps.done, ps.n_illegal, ps.row_state, ps.at_terminal) == (
                js.state, js.done, js.n_illegal, js.row_state, js.at_terminal)


# -- the mask ------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1,), (4,), (3, 5)])
def test_apply_grammar_mask_equals_jax(comp, shape):
    """Seeded logits and states over an arena of three grammars: the masked
    logits equal JAX's exactly; the advance equals JAX's decode step's."""
    import jax.numpy as jnp

    arena = pgr.GrammarArena(V, n_states=64)
    for name in ("yesno", "bool", "repeat"):
        pgr.GrammarSession(arena, comp.compile(*GRAMMARS[name]))
    rng = np.random.default_rng(sum(shape))
    live = np.flatnonzero((arena.table >= 0).any(axis=1))
    states = rng.choice(live, size=shape)
    logits = rng.standard_normal((*shape, V)).astype(np.float32) * 4
    table = torch.from_numpy(arena.table)
    got = apply_grammar_mask(torch.from_numpy(logits), table, torch.from_numpy(states))
    want = jsampling.apply_grammar_mask(jnp.asarray(logits), jnp.asarray(arena.table),
                                        jnp.asarray(states.astype(np.int32)))
    assert np.array_equal(got.numpy(), np.asarray(want))
    x = torch.from_numpy(logits)
    assert apply_grammar_mask(x, None, None) is x and apply_grammar_mask(x, table, None) is x
    if len(shape) == 1:
        tokens = torch.argmax(got, dim=-1)
        adv = advance_grammar(table, torch.from_numpy(states), tokens)
        st = jnp.asarray(states.astype(np.int32))
        nxt = jnp.asarray(arena.table)[st, jnp.asarray(tokens.numpy())]
        assert np.array_equal(adv.numpy(), np.asarray(jnp.where(nxt < 0, st, nxt)))
        assert adv.dtype == torch.int64


# -- the engine: generate ------------------------------------------------------

_JAX_GEN = {}


def _jax_generate(path, layout, kv, name, spec, comp_j, steps=32, prompt=PROMPT):
    key = (layout, kv, name, spec, steps, tuple(prompt))
    if key not in _JAX_GEN:
        jeng = _jengine(path, kv_layout=layout, cache_dtype=kv, grammar=True,
                        speculative="ngram" if spec else "off")
        s = jgr.GrammarSession(jeng.grammar, comp_j.compile(*GRAMMARS[name]))
        res = jeng.generate(prompt, len(prompt) + steps, sampler=None, grammar=s)
        s.close()
        _JAX_GEN[key] = res.tokens[len(prompt):]
    return _JAX_GEN[key]


def _chain_checked(eng, sess, checks: list):
    """Wrap `eng._decode_chunk`: at each chunk after the first, the state the
    host session hands the device (`row_state`, the previous chunk fully
    consumed) equals the device's final state of the previous chunk."""
    orig = eng._decode_chunk
    prev = {}

    def wrapped(tok_arr, pos, n, temperature=0.0, topp=0.9, generator=None, gr_state=None):
        if "state" in prev and gr_state is not None and not sess.done:
            assert np.array_equal(np.asarray(gr_state), prev["state"]), (gr_state, prev)
            checks.append(int(gr_state[0]))
        out = orig(tok_arr, pos, n, temperature, topp, generator, gr_state)
        prev["state"] = eng.last_grammar_state.numpy().copy()
        return out

    eng._decode_chunk = wrapped


@pytest.mark.parametrize("static", [False, True], ids=["eager", "static"])
@pytest.mark.parametrize("name", ["bool", "yesno", "obj"])
@pytest.mark.parametrize("layout,kv", LAYOUTS)
def test_constrained_generate_equals_jax(path, tok, comp, jcomp, layout, kv, name, static):
    """Greedy `generate(grammar=)`: the JAX engine's tokens, 0 illegal,
    finished and a full match; the device's state chain equals the host
    session's at every chunk boundary."""
    want = _jax_generate(path, layout, kv, name, False, jcomp)
    eng = _engine(path, static, kv_layout=layout, cache_dtype=kv, grammar=True)
    g = comp.compile(*GRAMMARS[name])
    s = pgr.GrammarSession(eng.grammar, g)
    checks = []
    _chain_checked(eng, s, checks)
    got = eng.generate(PROMPT, len(PROMPT) + 32, grammar=s).tokens[len(PROMPT):]
    assert got == want
    _valid(tok, g, got, name)
    assert s.n_illegal == 0 and (s.done or s.at_terminal or name in UNBOUNDED)
    assert checks or len(got) <= eng.decode_chunk_size
    s.close()


@pytest.mark.parametrize("static", [False, True], ids=["eager", "static"])
@pytest.mark.parametrize("name,prompt", [
    ("repeat", [ord(c) for c in "lalala"]), ("bool", PROMPT),
    ("yesno", [ord(c) for c in "no no yes no"]),
])
@pytest.mark.parametrize("layout,kv", [("contiguous", None), ("paged", "int8")])
def test_constrained_speculation_equals_plain_and_jax(path, tok, comp, jcomp, layout, kv, name,
                                                      prompt, static):
    """ngram drafts know nothing of the grammar: cut to their legal prefix
    and verified over masked logits, the constrained stream equals the
    constrained stream without speculation and JAX's speculative one."""
    kw = dict(kv_layout=layout, cache_dtype=kv, grammar=True)
    g = comp.compile(*GRAMMARS[name])
    outs = {}
    for spec in (False, True):
        eng = _engine(path, static and spec, speculative="ngram" if spec else "off", draft_k=4,
                      **kw)
        s = pgr.GrammarSession(eng.grammar, g)
        outs[spec] = eng.generate(prompt, len(prompt) + 40, grammar=s).tokens[len(prompt):]
        assert s.n_illegal == 0
        if spec:
            timing = eng.last_spec_timing
    assert outs[True] == outs[False]
    assert outs[True] == _jax_generate(path, layout, kv, name, True, jcomp, steps=40,
                                       prompt=prompt)
    _valid(tok, g, outs[True])
    if name == "repeat":
        # the context's own "yes," drafts are legal: rounds ran and accepted
        assert timing["rounds"] > 0 and timing["accepted_tokens"] > 0


@pytest.mark.parametrize("layout,kv", [("contiguous", None), ("paged", "int8")])
@pytest.mark.parametrize("per_row", [False, True])
def test_verify_round_masked_equals_jax(path, comp, jcomp, layout, kv, per_row):
    """One verify round with [b, t] states (a constrained row, a free row):
    the JAX round's ids, and its masked logits within 1e-4; the static
    verify step's equal to the eager round's bit for bit."""
    b, t = 2, 5
    kw = dict(batch=b, kv_layout=layout, cache_dtype=kv, grammar=True, speculative="ngram")
    jeng = _jengine(path, **kw)
    feed = np.array([[ord(c) for c in "yes,y"], [3, 4, 5, 6, 7]], np.int64)
    pos = np.array([len(PROMPT) - 1, len(PROMPT) - 1 + 3]) if per_row else len(PROMPT) - 1
    out = {}
    for side in ("jax", "eager", "static"):
        e = jeng if side == "jax" else _engine(path, side == "static", **kw)
        mod, cmp = (jgr, jcomp) if side == "jax" else (pgr, comp)
        s = mod.GrammarSession(e.grammar, cmp.compile(*GRAMMARS["repeat"]))
        states = np.zeros((b, t), np.int64)
        vs = s.verify_states(feed[0, 1:])
        states[0, : len(vs)] = vs
        if side == "jax":
            e.prefill(PROMPT[:-1] + [1, 2, 3])
            ids, logits = e._dispatch_verify(feed.astype(np.int32), np.asarray(pos, np.int32)
                                             if per_row else pos, e._kv_bucket(16),
                                             gr_states=states.astype(np.int32))
        else:
            e.prefill(PROMPT[:-1] + [1, 2, 3])
            ids, logits = e._dispatch_verify(feed, pos, e._kv_bucket(16), gr_states=states)
        out[side] = (np.asarray(ids), np.asarray(logits))
    assert np.array_equal(out["eager"][0], out["jax"][0])
    np.testing.assert_allclose(out["eager"][1], out["jax"][1], atol=1e-4, rtol=0)
    assert np.array_equal(out["static"][0], out["eager"][0])
    assert np.array_equal(out["static"][1], out["eager"][1])
    # masked positions hold MASKED exactly; the free row is unmasked
    assert (out["eager"][1][0] == -1e30).any() and not (out["eager"][1][1] == -1e30).any()


# -- BatchSession and generate_batch -------------------------------------------


def _session_run(eng, admissions, n_chunks, chunk=4, spec_rounds=0, ds=None):
    """Admit `admissions` ({row: (prompt, grammar session or None)}), then
    `spec_rounds` spec_step rounds (ngram drafts of each row's own context)
    and `n_chunks` steps; each constrained row's session is advanced by its
    owner (here) from the tokens, until it finishes. Returns {row: tokens}
    and each chunk's last logits."""
    s = BatchSession(eng) if isinstance(eng, InferenceEngine) else JSession(eng)
    for r, (prompt, g) in admissions.items():
        s.admit(r, prompt, grammar=g)
    got = {r: [] for r in admissions}
    logits = []

    def take(r, toks):
        g = admissions[r][1]
        for t in toks:
            if g is not None and (g.done or g.at_terminal):
                return
            got[r].append(int(t))
            if g is not None:
                g.advance(int(t))

    for _ in range(spec_rounds):
        drafts = {r: ds.draft(list(admissions[r][0]) + got[r], 4) for r in admissions}
        for r, e in s.spec_step(drafts).items():
            take(r, e)
    for _ in range(n_chunks):
        host = s.step(chunk)
        if isinstance(eng, InferenceEngine):
            logits.append(eng.last_logits.clone())
        for r in admissions:
            take(r, host[r])
    return got, logits


@pytest.mark.parametrize("spec", [False, True], ids=["step", "spec_step"])
@pytest.mark.parametrize("static", [False, True], ids=["eager", "static"])
@pytest.mark.parametrize("layout,kv", LAYOUTS)
def test_batch_session_mixed_rows(path, tok, comp, jcomp, layout, kv, static, spec):
    """Two constrained rows on two grammars beside two free rows: each free
    row equals its run on a grammar-less engine bit for bit (tokens and
    logits); the constrained rows are valid and equal the JAX session's."""
    from distributed_llama_tpu_torch.runtime.speculative import NGramDraft
    from distributed_llama_tpu.runtime.speculative import NGramDraft as JNGramDraft

    prompts = {0: PROMPT, 1: [7, 1], 2: [ord(c) for c in "yes,yes,"], 3: list(range(20, 31))}
    names = {0: "bool", 2: "repeat"}
    kw = dict(batch=4, kv_layout=layout, cache_dtype=kv,
              speculative="ngram" if spec else "off", draft_k=4)
    n_chunks, rounds = 6, 3 if spec else 0

    def admissions(eng, mod, cmp):
        return {r: (p, mod.GrammarSession(eng.grammar, cmp.compile(*GRAMMARS[names[r]]))
                    if r in names and eng.grammar is not None else None)
                for r, p in prompts.items()}

    eng = _engine(path, static, grammar=True, **kw)
    got, logits = _session_run(eng, admissions(eng, pgr, comp), n_chunks, spec_rounds=rounds,
                               ds=NGramDraft())
    plain = _engine(path, static, grammar=False, **kw)
    want_free, plain_logits = _session_run(plain, admissions(plain, pgr, comp), n_chunks,
                                           spec_rounds=rounds, ds=NGramDraft())
    for r in (1, 3):
        assert got[r] == want_free[r]
        for a, b in zip(logits, plain_logits):
            assert torch.equal(a[r], b[r])
    jeng = _jengine(path, grammar=True, **kw)
    jgot, _ = _session_run(jeng, admissions(jeng, jgr, jcomp), n_chunks, spec_rounds=rounds,
                           ds=JNGramDraft())
    assert got == jgot
    for r, name in names.items():
        _valid(tok, comp.compile(*GRAMMARS[name]), got[r], name)


@pytest.mark.parametrize("spec", [False, True], ids=["chunked", "speculative"])
@pytest.mark.parametrize("layout,kv", [("contiguous", None), ("paged", "int8")])
def test_generate_batch_grammars_equal_jax(path, tok, comp, jcomp, layout, kv, spec):
    """generate_batch(grammars=) with constrained and free rows and per-row
    budgets: JAX's rows, on the static buffers too; constrained rows
    valid, free rows equal to a grammar-less engine's."""
    prompts = [PROMPT, [7, 1], [ord(c) for c in "yes,yes,"]]
    budgets = [30, 12, 30]
    names = {0: "obj", 2: "repeat"}
    kw = dict(batch=3, kv_layout=layout, cache_dtype=kv,
              speculative="ngram" if spec else "off", draft_k=4)

    def sessions(eng, mod, cmp):
        return [mod.GrammarSession(eng.grammar, cmp.compile(*GRAMMARS[names[r]]))
                if r in names else None for r in range(3)]

    outs = []
    for static in (False, True):
        eng = _engine(path, static, grammar=True, **kw)
        outs.append(eng.generate_batch(prompts, budgets, grammars=sessions(eng, pgr, comp)))
    assert outs[0] == outs[1]
    jeng = _jengine(path, grammar=True, **kw)
    assert jeng.generate_batch(prompts, budgets, sampler=None,
                               grammars=sessions(jeng, jgr, jcomp)) == outs[0]
    free = _engine(path, **kw).generate_batch(prompts, budgets)
    assert outs[0][1] == free[1]
    for r, name in names.items():
        _valid(tok, comp.compile(*GRAMMARS[name]), outs[0][r], name)


# -- refusals and fallbacks ------------------------------------------------------


def test_grammar_less_engine_refuses_like_jax(path, comp, jcomp):
    eng, jeng = _engine(path, batch=2), _jengine(path, batch=2, grammar=False)
    assert eng.grammar is None and jeng.grammar is None
    g, jg = comp.compile(*GRAMMARS["yesno"]), jcomp.compile(*GRAMMARS["yesno"])
    s = pgr.GrammarSession(pgr.GrammarArena(V, n_states=64), g)
    js = jgr.GrammarSession(jgr.GrammarArena(V, n_states=64), jg)
    _raises_like_jax(lambda: eng.generate(PROMPT, 12, grammar=s),
                     lambda: jeng.generate(PROMPT, 12, grammar=js))
    _raises_like_jax(lambda: eng.generate_batch([PROMPT, PROMPT], 4, grammars=[s, None]),
                     lambda: jeng.generate_batch([PROMPT, PROMPT], 4, grammars=[js, None]))
    _raises_like_jax(lambda: BatchSession(eng).admit(0, PROMPT, grammar=s),
                     lambda: JSession(jeng).admit(0, PROMPT, grammar=js))
    _raises_like_jax(lambda: BatchSession(eng).begin_admit(0, PROMPT, grammar=s),
                     lambda: JSession(jeng).begin_admit(0, PROMPT, grammar=js))
    geng, gjeng = _engine(path, batch=2, grammar=True), _jengine(path, batch=2, grammar=True)
    _raises_like_jax(lambda: geng.generate_batch([PROMPT, PROMPT], 4, grammars=[None]),
                     lambda: gjeng.generate_batch([PROMPT, PROMPT], 4, grammars=[None]))


@pytest.mark.parametrize("topology", ["sp", "host_decode"])
def test_mesh_and_host_decode_warn_and_serve_unconstrained(tmp_path, topology):
    """An sp mesh or host decode warns, as JAX's does, and builds no arena;
    the engine serves unconstrained requests as one without the flag."""
    p = str(tmp_path / "m.m")
    write_tiny_model(p, tiny_header(dim=64, hidden_dim=128, n_layers=2, seq_len=256,
                                    vocab_size=V), seed=3)
    kw = (dict(mesh=make_mesh(sp=2, devices=["cpu"] * 2)) if topology == "sp"
          else dict(device="cpu", device_decode=False))
    with pytest.warns(UserWarning, match="serves unconstrained"):
        eng = InferenceEngine(p, compute_dtype="float32", max_chunk=8, decode_chunk_size=4,
                              grammar=True, **kw)
    assert eng.grammar is None
    with pytest.warns(UserWarning, match="serves unconstrained"):
        _jengine(p, grammar=True, **({"device_decode": False} if topology == "host_decode"
                                     else {}), **({"mesh": _jax_sp_mesh()} if topology == "sp"
                                                  else {}))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plain = InferenceEngine(p, compute_dtype="float32", max_chunk=8, decode_chunk_size=4,
                                **kw)
    assert eng.generate(PROMPT, 24).tokens == plain.generate(PROMPT, 24).tokens


def _jax_sp_mesh():
    from distributed_llama_tpu.parallel.mesh import make_mesh as jmake_mesh

    return jmake_mesh(sp=2)


# -- the fixed buffer and the warm ladder ----------------------------------------


def test_table_buffer_is_fixed_and_warm_ladder_holds(path, tok, comp):
    """The device table's storage never moves across installs and
    evictions, and its content follows the arena; after `warmup` (the
    static registry) constrained requests, a mixed session with
    `spec_step` and grammar installs that evict add no key."""
    eng = _engine(path, True, batch=2, kv_layout="paged", grammar=True, speculative="ngram",
                  draft_k=4, decode_chunk_size=8)
    ptr = eng._gr_table.data_ptr()
    eng.warmup()
    keys = set(eng._graphs.graphs)
    assert eng._step_buffers().grammar is eng._gr_table
    sessions = []
    for name in ("yesno", "bool", "repeat", "obj"):
        s = pgr.GrammarSession(eng.grammar, comp.compile(*GRAMMARS[name]))
        sessions.append(s)
        eng._gr_operand()
        assert eng._gr_table.data_ptr() == ptr
        assert np.array_equal(eng._gr_table.numpy(), eng.grammar.table)
    for s in sessions:
        s.close()
    v = eng.grammar.version
    big = pgr.GrammarSession(eng.grammar, comp.compile("regex", "a" * 60))  # evicts
    assert eng.grammar.version > v
    out = eng.generate_batch([PROMPT, [7, 1]], [30, 10], grammars=[big, None])
    big.close()
    s = BatchSession(eng)
    g = pgr.GrammarSession(eng.grammar, comp.compile(*GRAMMARS["repeat"]))
    s.admit(0, [ord(c) for c in "yes,yes,"], grammar=g)
    s.admit(1, PROMPT)
    s.spec_step({0: [ord(c) for c in "yes,"], 1: [3]})
    s.step(8)
    s.release(0)
    g.close()
    e1 = pgr.GrammarSession(eng.grammar, comp.compile(*GRAMMARS["yesno"]))
    eng.generate(PROMPT, 40, grammar=e1)
    assert eng._gr_table.data_ptr() == ptr
    assert np.array_equal(eng._gr_table.numpy(), eng.grammar.table)
    assert set(eng._graphs.graphs) == keys
    assert eng.graph_stats()["recaptures_after_warmup"] == 0
    assert _replay(tok, comp.compile("regex", "a" * 60), out[0])[1] == 0
    assert "grammar arena" in eng.memory_report()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dirty_row_upload_keeps_the_table_exact(path, comp, monkeypatch, seed):
    """Random installs, releases and evictions in a 64-state arena, the
    device table brought up to date at random points: it equals the
    arena's host table, though only the spans that changed move. (A
    refused install may evict zero-ref spans without moving the arena's
    version, as in the JAX arena; until the next version the stale rows
    are those of no installed span, which no row's state reaches.)"""
    from distributed_llama_tpu_torch.runtime import engine as engine_mod

    monkeypatch.setattr(engine_mod, "GrammarArena", lambda v: pgr.GrammarArena(v, n_states=64))
    eng = _engine(path, grammar=True)
    real, moved = eng._gr_table, []

    class Table:  # the device buffer, counting the rows each upload moves
        def __getitem__(self, sl):
            view = real[sl]
            moved.append(view.shape[0])
            return view

    rng = np.random.default_rng(seed)
    pats = [("regex", c * n) for c, n in zip("abcdefgh", (3, 9, 20, 30, 5, 14, 40, 2))]
    live, refused_at = [], None
    for _ in range(60):
        if live and rng.random() < 0.45:
            live.pop(int(rng.integers(len(live)))).close()
        else:
            try:
                live.append(pgr.GrammarSession(eng.grammar,
                                               comp.compile(*pats[rng.integers(len(pats))])))
            except pgr.GrammarError:
                refused_at = eng.grammar.version
        if rng.random() < 0.5:
            moved.clear()
            eng._gr_table = Table()
            try:
                eng._gr_operand()
            finally:
                eng._gr_table = real
            assert sum(moved) < 64
            rows = [0] + [r for b, n in eng.grammar.spans().values() for r in range(b, b + n)]
            assert np.array_equal(real.numpy()[rows], eng.grammar.table[rows])
            if refused_at != eng.grammar.version:
                assert np.array_equal(real.numpy(), eng.grammar.table)


# -- sampled rows ----------------------------------------------------------------


@pytest.mark.parametrize("topp", [0.9, 1.0])
@pytest.mark.parametrize("static", [False, True], ids=["eager", "static"])
def test_sampled_rows_stay_legal(path, tok, comp, static, topp):
    """Sampled constrained rows (temperature 0.8; top-p 0.9 or the full
    distribution): every token legal in generate, generate_batch and a
    BatchSession through `row_coins`. Legality only: the random streams are
    not JAX's."""
    eng = _engine(path, static, batch=3, grammar=True)
    names = ["obj", None, "repeat"]
    for seed in (1, 2):
        sess = [pgr.GrammarSession(eng.grammar, comp.compile(*GRAMMARS[n])) if n else None
                for n in names]
        out = eng.generate_batch([PROMPT, [7, 1], [ord("y")]], 40,
                                 sampler=Sampler(V, 0.8, topp, seed), grammars=sess)
        for r, n in enumerate(names):
            if n:
                assert _replay(tok, sess[r].grammar, out[r])[1] == 0
                assert sess[r].n_illegal == 0
        s = BatchSession(eng)
        for r, n in enumerate(names):
            s.admit(r, PROMPT[: r + 2], temperature=0.8, topp=topp, seed=seed + r,
                    grammar=pgr.GrammarSession(eng.grammar, comp.compile(*GRAMMARS[n]))
                    if n else None)
        got = {0: [], 2: []}
        for _ in range(8):
            host = s.step(4)
            for r in got:
                g = s.grammars[r]
                for t in host[r]:
                    if g.done or g.at_terminal:
                        break
                    got[r].append(int(t))
                    assert g.advance(int(t)) != "illegal"
    solo = _engine(path, static, grammar=True)
    g = pgr.GrammarSession(solo.grammar, comp.compile(*GRAMMARS["bool"]))
    res = solo.generate(PROMPT, 40, sampler=Sampler(V, 0.8, topp, 7), grammar=g)
    assert g.n_illegal == 0 and _replay(tok, g.grammar, res.tokens[len(PROMPT):])[1] == 0


# -- the CLI -----------------------------------------------------------------------


@pytest.mark.parametrize("env,extra,built", [
    (None, [], True), ("0", [], False), (None, ["--host-decode"], False),
    (None, ["--sp", "2", "--kv-layout", "contiguous"], False), ("1", ["--kv-dtype", "int8"], True),
])
def test_cli_builds_the_arena_as_jax(tmp_path, monkeypatch, env, extra, built):
    """make_engine builds the arena where the JAX CLI does: one device with
    device decode by default; DLT_GRAMMAR=0, --host-decode and --sp leave
    it off."""
    mp, tp = str(tmp_path / "m.m"), str(tmp_path / "t.t")
    write_tiny_model(mp, tiny_header(dim=64, hidden_dim=128, n_layers=2, seq_len=256,
                                     vocab_size=V), seed=3)
    write_tiny_tokenizer(tp, pad_to=V)
    if env is not None:
        monkeypatch.setenv("DLT_GRAMMAR", env)
    args = pcli.build_arg_parser().parse_args(
        ["inference", "--model", mp, "--tokenizer", tp, "--prompt", "hi", "--steps", "8",
         "--device", "cpu", *extra])
    eng = pcli.make_engine(args)
    assert (eng.grammar is not None) == built


def test_cli_default_prints_the_jax_cli_tokens(tmp_path, monkeypatch, capsys):
    """Both CLIs at their defaults, the arena built (every decode step
    masked at FREE): the same generated text."""
    from distributed_llama_tpu import cli as jcli

    mp, tp = str(tmp_path / "m.m"), str(tmp_path / "t.t")
    write_tiny_model(mp, tiny_header(dim=64, hidden_dim=128, n_layers=2, seq_len=256,
                                     vocab_size=V), seed=3)
    write_tiny_tokenizer(tp, pad_to=V)
    args = ["inference", "--model", mp, "--tokenizer", tp, "--prompt", "hello world",
            "--steps", "48", "--temperature", "0", "--compute-dtype", "float32"]

    def text(main, extra):
        assert main(args + extra) == 0
        out = capsys.readouterr().out
        return [line.split("| ", 1)[1] for line in out.split("\n") if line.startswith("🔶 Pred")]

    got = text(pcli.main, ["--device", "cpu"])
    assert got and got == text(jcli.main, [])
    monkeypatch.setenv("DLT_GRAMMAR", "0")
    assert text(pcli.main, ["--device", "cpu"]) == got
