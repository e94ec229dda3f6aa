"""Grammar-constrained structured decoding.

The counterpart of the JAX package's `runtime/grammar.py`, numpy only (no
torch, as there no jax): the same regex subset and byte DFA, the same
JSON-schema lowering (`schema_to_regex`, `parse_response_format`,
`regex_escape`), the same vocabulary lift (`GrammarCompiler` ->
`CompiledGrammar`), the same arena (`GrammarArena`) and host sessions
(`GrammarSession`), so the tables, versions and walks are equal to JAX's.

A regex (or a JSON schema lowered to a canonical regex) compiles into a DFA
over BYTES, lifted to a DFA over the tokenizer's VOCABULARY:

    token_table[s, t] = the byte-DFA state reached by walking token t's
                        piece bytes from state s, or -1 when any byte dies.

Everything on the device derives from that one int32 table:

* legality mask: ``table[state] >= 0``; `ops/sampling.py:apply_grammar_mask`
  applies it as ``where(legal, logits, -1e30)`` before every sampling arm,
  so no sampled token is ever outside the DFA's legal set;
* state advance: ``table[state, tok]`` moves the per-row grammar state
  inside the decode step (runtime/decode.py, runtime/batch_session.py)
  with no host round trip.

All live grammars share ONE arena (`GrammarArena`): each grammar occupies
a contiguous span of global states (its local table shifted by a base
offset), row/state 0 is the reserved FREE state (all tokens legal,
self-loop) that unconstrained rows ride, and unallocated rows are all -1.
The engine keeps one device buffer of the arena's fixed [S, V] shape and
copies the table into it in place when `arena.version` moves
(`InferenceEngine._gr_operand`), so the decode and verify CUDA graphs,
which hold that buffer's address, serve every grammar and every
constrained/unconstrained mix: an install never recaptures a graph.

EOS semantics: at ACCEPTING byte-DFA states every eos token is legal as a
self-loop; everywhere else eos is illegal. A "terminal" state (accepting
with ONLY eos legal) therefore forces the model to emit EOS next: grammar
completion ends the stream through the ordinary EOS stop. The host-side
`GrammarSession` detects the terminal state one step earlier and lets the
caller stop without spending that step.

Compile-time budgets are grammar-bomb defenses, not tuning knobs: a spec
whose DFA exceeds ``DLT_GRAMMAR_MAX_STATES`` (or whose body exceeds
``DLT_GRAMMAR_MAX_SPEC_KB``) raises `GrammarError`, a client error.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import OrderedDict

import numpy as np

__all__ = [
    "GrammarError",
    "CompiledGrammar",
    "GrammarCompiler",
    "GrammarArena",
    "GrammarSession",
    "schema_to_regex",
    "parse_response_format",
    "resolve_grammar_enabled",
]

#: the reserved all-legal self-loop state unconstrained rows ride
FREE_STATE = 0

#: env knobs, the JAX package's names
ENV_GRAMMAR = "DLT_GRAMMAR"
ENV_CACHE_MB = "DLT_GRAMMAR_CACHE_MB"
ENV_MAX_STATES = "DLT_GRAMMAR_MAX_STATES"
ENV_ARENA_MB = "DLT_GRAMMAR_ARENA_MB"
ENV_MAX_SPEC_KB = "DLT_GRAMMAR_MAX_SPEC_KB"


def resolve_grammar_enabled(explicit: bool | None = None, default: str = "0") -> bool:
    """THE one resolver of the grammar-arena build flag: an explicit engine
    kwarg wins; otherwise ``DLT_GRAMMAR``; unset means `default` (library
    engines pass "0", the server entry point passes "1" — same pattern as
    the speculative/prefix-cache defaults). The arena is a build-time
    choice because its operands are part of every warm decode program."""
    if explicit is not None:
        return bool(explicit)
    raw = (os.environ.get(ENV_GRAMMAR) or "").strip().lower() or default
    return raw in ("1", "on", "true", "yes")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def grammar_cache_mb() -> int:
    """Host compile-cache budget (MB) for `GrammarCompiler`."""
    return _env_int(ENV_CACHE_MB, 64)


def grammar_max_states() -> int:
    """Per-grammar byte-DFA state cap — the grammar-bomb defense."""
    return _env_int(ENV_MAX_STATES, 256)


def grammar_arena_mb() -> int:
    """Device mask-table budget (MB): arena rows = budget / (4 * vocab)."""
    return _env_int(ENV_ARENA_MB, 32)


def grammar_max_spec_kb() -> int:
    """`response_format` body size cap (KB)."""
    return _env_int(ENV_MAX_SPEC_KB, 64)


class GrammarError(ValueError):
    """A client-supplied grammar is malformed or over budget (HTTP 400)."""


def _fnv1a(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


# ---------------------------------------------------------------------------
# Regex subset -> AST
# ---------------------------------------------------------------------------
#
# Byte-level semantics: the pattern's UTF-8 bytes are the alphabet, `.`
# matches any byte except newline, classes hold single bytes (ranges and
# the \d \w \s escapes included), and matching is fully anchored —
# generation must produce a complete match, there is no unanchored search.

_DIGITS = frozenset(range(0x30, 0x3A))
_WORD = _DIGITS | frozenset(range(0x41, 0x5B)) | frozenset(range(0x61, 0x7B)) | {0x5F}
_SPACE = frozenset(b" \t\r\n\x0b\x0c")
_ANY = frozenset(range(256)) - {0x0A}
_ALL = frozenset(range(256))

#: hard caps on quantifier bounds and expanded AST size — a {1000}{1000}
#: nesting must die in the parser, not in subset construction
_MAX_REPEAT = 512
_MAX_ATOMS = 65536


class _Parser:
    def __init__(self, pattern: bytes):
        self.p = pattern
        self.i = 0
        self.atoms = 0

    def _atom_budget(self, n: int = 1):
        self.atoms += n
        if self.atoms > _MAX_ATOMS:
            raise GrammarError("regex expands past the atom budget")

    def error(self, msg: str) -> GrammarError:
        return GrammarError(f"regex: {msg} at byte {self.i}")

    def peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self):
        b = self.peek()
        if b is None:
            raise self.error("unexpected end of pattern")
        self.i += 1
        return b

    def parse(self):
        node = self.alt()
        if self.i != len(self.p):
            raise self.error("unbalanced ')'")
        return node

    def alt(self):
        branches = [self.seq()]
        while self.peek() == 0x7C:  # |
            self.i += 1
            branches.append(self.seq())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def seq(self):
        items = []
        while True:
            b = self.peek()
            if b is None or b in (0x7C, 0x29):  # | )
                break
            items.append(self.repeat())
        if not items:
            return ("seq", [])
        return items[0] if len(items) == 1 else ("seq", items)

    def repeat(self):
        node = self.atom()
        while True:
            b = self.peek()
            if b == 0x2A:  # *
                self.i += 1
                node = ("rep", node, 0, None)
            elif b == 0x2B:  # +
                self.i += 1
                node = ("rep", node, 1, None)
            elif b == 0x3F:  # ?
                self.i += 1
                node = ("rep", node, 0, 1)
            elif b == 0x7B:  # {
                save = self.i
                self.i += 1
                m, n = self._bounds()
                if m is None:  # a literal '{'
                    self.i = save
                    break
                node = ("rep", node, m, n)
            else:
                break
        return node

    def _bounds(self):
        num = b""
        while self.peek() is not None and 0x30 <= self.peek() <= 0x39:
            num += bytes([self.take()])
        if not num:
            return None, None
        m = int(num)
        n = m
        if self.peek() == 0x2C:  # ,
            self.i += 1
            num = b""
            while self.peek() is not None and 0x30 <= self.peek() <= 0x39:
                num += bytes([self.take()])
            n = int(num) if num else None
        if self.peek() != 0x7D:  # }
            return None, None
        self.i += 1
        if m > _MAX_REPEAT or (n is not None and (n > _MAX_REPEAT or n < m)):
            raise self.error(f"repeat bounds over the {_MAX_REPEAT} cap")
        return m, n

    def atom(self):
        b = self.take()
        if b == 0x28:  # (
            # non-capturing group syntax is accepted and ignored
            if self.p[self.i : self.i + 2] == b"?:":
                self.i += 2
            node = self.alt()
            if self.peek() != 0x29:
                raise self.error("unbalanced '('")
            self.i += 1
            return node
        if b == 0x5B:  # [
            return ("lit", self._cls())
        if b == 0x2E:  # .
            self._atom_budget()
            return ("lit", _ANY)
        if b == 0x5C:  # backslash
            self._atom_budget()
            return ("lit", self._escape(in_class=False))
        if b in (0x2A, 0x2B, 0x3F, 0x29):
            raise self.error(f"dangling {chr(b)!r}")
        self._atom_budget()
        return ("lit", frozenset({b}))

    def _escape(self, in_class: bool):
        b = self.take()
        if b == 0x64:  # d
            return _DIGITS
        if b == 0x44:  # D
            return _ALL - _DIGITS
        if b == 0x77:  # w
            return _WORD
        if b == 0x57:  # W
            return _ALL - _WORD
        if b == 0x73:  # s
            return _SPACE
        if b == 0x53:  # S
            return _ALL - _SPACE
        if b == 0x6E:  # n
            return frozenset({0x0A})
        if b == 0x74:  # t
            return frozenset({0x09})
        if b == 0x72:  # r
            return frozenset({0x0D})
        if b == 0x78:  # xHH
            hx = bytes([self.take(), self.take()])
            try:
                return frozenset({int(hx, 16)})
            except ValueError:
                raise self.error(f"bad \\x escape {hx!r}") from None
        return frozenset({b})  # any other byte: itself, escaped

    def _cls(self):
        negate = False
        if self.peek() == 0x5E:  # ^
            negate = True
            self.i += 1
        members: set[int] = set()
        first = True
        while True:
            b = self.peek()
            if b is None:
                raise self.error("unbalanced '['")
            if b == 0x5D and not first:  # ]
                self.i += 1
                break
            first = False
            self.i += 1
            if b == 0x5C:
                sub = self._escape(in_class=True)
                if len(sub) > 1 or self.peek() != 0x2D:
                    members |= sub
                    continue
                b = next(iter(sub))
            if self.peek() == 0x2D and self.p[self.i + 1 : self.i + 2] not in (b"", b"]"):
                self.i += 1
                hi = self.take()
                if hi == 0x5C:
                    sub = self._escape(in_class=True)
                    if len(sub) != 1:
                        raise self.error("multi-byte escape as range bound")
                    hi = next(iter(sub))
                if hi < b:
                    raise self.error("reversed class range")
                members |= set(range(b, hi + 1))
            else:
                members.add(b)
        self._atom_budget()
        return frozenset(_ALL - members if negate else members)


_REGEX_META = b"\\.[]{}()|*+?^$"


def regex_escape(text: bytes | str) -> str:
    """Escape a literal for embedding in the regex subset above."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    out = []
    for b in text:
        if b in _REGEX_META:
            out.append("\\")
        out.append(chr(b) if 0x20 <= b < 0x7F else f"\\x{b:02x}")
    return "".join(out)


# ---------------------------------------------------------------------------
# AST -> Thompson NFA -> byte DFA
# ---------------------------------------------------------------------------


class _Nfa:
    def __init__(self, cap: int):
        self.eps: list[set[int]] = []
        self.edges: list[list[tuple[frozenset, int]]] = []
        self.cap = cap

    def state(self) -> int:
        if len(self.eps) >= self.cap:
            raise GrammarError("regex NFA exceeds the state budget")
        self.eps.append(set())
        self.edges.append([])
        return len(self.eps) - 1

    def build(self, node) -> tuple[int, int]:
        kind = node[0]
        if kind == "lit":
            s, a = self.state(), self.state()
            self.edges[s].append((node[1], a))
            return s, a
        if kind == "seq":
            s = a = self.state()
            for child in node[1]:
                cs, ca = self.build(child)
                self.eps[a].add(cs)
                a = ca
            return s, a
        if kind == "alt":
            s, a = self.state(), self.state()
            for child in node[1]:
                cs, ca = self.build(child)
                self.eps[s].add(cs)
                self.eps[ca].add(a)
            return s, a
        if kind == "rep":
            _, child, m, n = node
            s = a = self.state()
            for _i in range(m):
                cs, ca = self.build(child)
                self.eps[a].add(cs)
                a = ca
            if n is None:  # star tail
                cs, ca = self.build(child)
                self.eps[a].add(cs)
                self.eps[ca].add(cs)
                end = self.state()
                self.eps[a].add(end)
                self.eps[ca].add(end)
                return s, end
            for _i in range(n - m):  # bounded optional tail
                cs, ca = self.build(child)
                end = self.state()
                self.eps[a].add(cs)
                self.eps[a].add(end)
                self.eps[ca].add(end)
                a = end
            return s, a
        raise GrammarError(f"internal: unknown AST node {kind!r}")


def _compile_byte_dfa(pattern: str, max_states: int):
    """(trans_byte [S,256] int32 with -1 dead, accepting [S] bool); state 0
    is the start. Subset construction aborts past `max_states` — the
    grammar-bomb defense the request path relies on."""
    ast = _Parser(pattern.encode("utf-8")).parse()
    nfa = _Nfa(cap=max(4 * _MAX_ATOMS, 1024))
    start, accept = nfa.build(ast)

    def closure(seed):
        seen = set(seed)
        stack = list(seed)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_c = closure({start})
    index = {start_c: 0}
    order = [start_c]
    rows, accepting = [], []
    i = 0
    while i < len(order):
        cur = order[i]
        row = np.full(256, -1, np.int32)
        move: dict[int, set] = {}
        for s in cur:
            for byteset, t in nfa.edges[s]:
                for b in byteset:
                    move.setdefault(b, set()).add(t)
        for b, tgts in move.items():
            c = closure(tgts)
            j = index.get(c)
            if j is None:
                if len(order) >= max_states:
                    raise GrammarError(
                        f"grammar DFA exceeds {max_states} states "
                        f"({ENV_MAX_STATES}) — simplify the pattern"
                    )
                j = len(order)
                index[c] = j
                order.append(c)
            row[b] = j
        rows.append(row)
        accepting.append(accept in cur)
        i += 1
    return np.stack(rows), np.fromiter(accepting, bool, count=len(accepting))


# ---------------------------------------------------------------------------
# JSON schema subset -> canonical regex
# ---------------------------------------------------------------------------

#: JSON string body: any non-quote/backslash byte (control bytes excluded —
#: json.loads rejects raw <0x20 in strings) or a backslash escape
_STR_BODY = '(?:[^"\\\\\\x00-\\x1f]|\\\\.)'
_INT = "-?(?:0|[1-9][0-9]*)"
_NUM = _INT + "(?:\\.[0-9]+)?(?:[eE][-+]?[0-9]+)?"

_MAX_SCHEMA_DEPTH = 8
#: explicit min/max bounds COUNT, and counting costs DFA states linearly —
#: these caps keep a bounded schema inside the state budget
_MAX_BOUND = 256


def schema_to_regex(schema, depth: int = 0) -> str:
    """Lower the supported JSON-schema subset to a canonical (no-whitespace)
    regex. Objects emit properties in DECLARED order, all required —
    a documented limit of the subset. Strings and arrays are UNBOUNDED by
    default (a star costs no DFA states); explicit min/max bounds count,
    and counting costs states linearly, so bounds are capped."""
    if depth > _MAX_SCHEMA_DEPTH:
        raise GrammarError(f"schema nests deeper than {_MAX_SCHEMA_DEPTH}")
    if not isinstance(schema, dict):
        raise GrammarError("schema must be a JSON object")
    if "enum" in schema:
        opts = schema["enum"]
        if not isinstance(opts, list) or not opts:
            raise GrammarError("enum must be a non-empty list")
        return (
            "(?:"
            + "|".join(
                regex_escape(json.dumps(v, separators=(",", ":"))) for v in opts
            )
            + ")"
        )
    if "const" in schema:
        return regex_escape(json.dumps(schema["const"], separators=(",", ":")))
    t = schema.get("type")
    if t == "string":
        if "minLength" not in schema and "maxLength" not in schema:
            return f'"{_STR_BODY}*"'
        lo = int(schema.get("minLength", 0))
        hi = schema.get("maxLength")
        if lo < 0 or lo > _MAX_BOUND or (
            hi is not None and (int(hi) < lo or int(hi) > _MAX_BOUND)
        ):
            raise GrammarError("string length bounds out of range")
        tail = f"{{{lo},{int(hi)}}}" if hi is not None else f"{{{lo},}}"
        return f'"{_STR_BODY}{tail}"'
    if t == "integer":
        return _INT
    if t == "number":
        return _NUM
    if t == "boolean":
        return "(?:true|false)"
    if t == "null":
        return "null"
    if t == "object":
        props = schema.get("properties", {})
        if not isinstance(props, dict):
            raise GrammarError("properties must be an object")
        parts = []
        for name, sub in props.items():
            parts.append(
                '"' + regex_escape(str(name)) + '":' + schema_to_regex(sub, depth + 1)
            )
        if not parts:
            return "\\{\\}"
        return "\\{" + ",".join(parts) + "\\}"
    if t == "array":
        item = schema_to_regex(schema.get("items", {"type": "integer"}), depth + 1)
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        if lo < 0 or lo > _MAX_BOUND or (
            hi is not None and (int(hi) < lo or int(hi) > _MAX_BOUND)
        ):
            raise GrammarError("array item bounds out of range")
        if hi is not None and int(hi) == 0:
            return "\\[\\]"
        tail = (
            f"{{{max(lo - 1, 0)},{int(hi) - 1}}}" if hi is not None
            else (f"{{{lo - 1},}}" if lo > 1 else "*")
        )
        body = f"(?:{item}(?:,{item}){tail})"
        if lo == 0:
            body = body + "?"
        return "\\[" + body + "\\]"
    raise GrammarError(f"unsupported schema type {t!r}")


def parse_response_format(rf) -> tuple[str, str]:
    """Validate a request's `response_format` body -> ("regex"|"json_schema",
    canonical pattern). Raises GrammarError on anything malformed — the
    quarantine classifier treats that as a 400 client error, never a
    poison strike."""
    if not isinstance(rf, dict):
        raise GrammarError("response_format must be an object")
    body = json.dumps(rf, sort_keys=True)
    if len(body) > grammar_max_spec_kb() * 1024:
        raise GrammarError(
            f"response_format exceeds {ENV_MAX_SPEC_KB} "
            f"({grammar_max_spec_kb()} KB)"
        )
    kind = rf.get("type")
    if kind == "regex":
        pat = rf.get("regex", rf.get("pattern"))
        if not isinstance(pat, str) or not pat:
            raise GrammarError("response_format.regex must be a pattern string")
        return "regex", pat
    if kind == "json_schema":
        schema = rf.get("json_schema", rf.get("schema"))
        if isinstance(schema, dict) and "schema" in schema:
            schema = schema["schema"]  # OpenAI-style nesting
        if not isinstance(schema, dict):
            raise GrammarError("response_format.json_schema must carry a schema")
        return "json_schema", schema_to_regex(schema)
    raise GrammarError(
        f"unsupported response_format type {kind!r} (regex | json_schema)"
    )


# ---------------------------------------------------------------------------
# Token-level DFA
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompiledGrammar:
    """One grammar lowered to the tokenizer's vocabulary.

    `table` is the [n_states, vocab] int32 token DFA (-1 = illegal; the
    boolean mask row is `table[s] >= 0`), `trans_byte`/`accepting` the
    underlying byte DFA (kept for host-side full-match validation),
    `terminal` marks accepting states whose ONLY legal tokens are eos."""

    key: int
    kind: str
    pattern: str
    table: np.ndarray
    trans_byte: np.ndarray
    accepting: np.ndarray
    terminal: np.ndarray
    eos_ids: frozenset

    @property
    def n_states(self) -> int:
        return self.table.shape[0]

    @property
    def nbytes(self) -> int:
        return self.table.nbytes + self.trans_byte.nbytes

    def fullmatch(self, data: bytes) -> bool:
        """Host-side byte-DFA walk — the test/bench validity oracle."""
        s = 0
        for b in data:
            s = int(self.trans_byte[s, b])
            if s < 0:
                return False
        return bool(self.accepting[s])


class GrammarCompiler:
    """regex/JSON-schema -> CompiledGrammar over one tokenizer's vocab,
    with an FNV-keyed LRU compile cache budgeted by DLT_GRAMMAR_CACHE_MB.

    The vocab piece matrix is precomputed once; each compile is then a
    vectorized numpy walk (L steps of [S, V] advanced indexing, L = the
    longest piece) — no per-(state, token) Python loop."""

    def __init__(self, tokenizer, vocab_size: int | None = None):
        pieces = list(tokenizer.vocab)
        self.vocab_size = int(vocab_size or len(pieces))
        self.eos_ids = frozenset(
            int(e) for e in tokenizer.eos_token_ids if 0 <= int(e) < self.vocab_size
        )
        self.bos_id = int(getattr(tokenizer, "bos_id", -1))
        V = self.vocab_size
        L = max((len(p) for p in pieces[:V]), default=1) or 1
        self._piece_mat = np.zeros((V, L), np.int32)
        self._piece_len = np.zeros(V, np.int64)
        for t, p in enumerate(pieces[:V]):
            self._piece_len[t] = len(p)
            if p:
                self._piece_mat[t, : len(p)] = np.frombuffer(p, np.uint8)
        self._cache: OrderedDict[int, CompiledGrammar] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- cache -------------------------------------------------------------

    def compile_request(self, response_format) -> CompiledGrammar:
        kind, pattern = parse_response_format(response_format)
        return self.compile(kind, pattern)

    def compile(self, kind: str, pattern: str) -> CompiledGrammar:
        key = _fnv1a(f"{kind}:{pattern}".encode("utf-8"))
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            self.hits += 1
            return hit
        self.misses += 1
        g = self._compile(key, kind, pattern)
        self._cache[key] = g
        self._bytes += g.nbytes
        budget = grammar_cache_mb() * (1 << 20)
        while self._bytes > budget and len(self._cache) > 1:
            _, old = self._cache.popitem(last=False)
            self._bytes -= old.nbytes
            self.evictions += 1
        return g

    def cache_stats(self) -> dict:
        return {
            "entries": len(self._cache),
            "bytes": self._bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }

    # -- the lift ----------------------------------------------------------

    def _compile(self, key: int, kind: str, pattern: str) -> CompiledGrammar:
        trans_byte, accepting = _compile_byte_dfa(pattern, grammar_max_states())
        S, V = trans_byte.shape[0], self.vocab_size
        L = self._piece_mat.shape[1]
        st = np.broadcast_to(np.arange(S, dtype=np.int32)[:, None], (S, V)).copy()
        for step in range(L):
            live = (self._piece_len > step)[None, :] & (st >= 0)
            nxt = trans_byte[np.clip(st, 0, None), self._piece_mat[:, step][None, :]]
            st = np.where(live, np.where(st >= 0, nxt, -1), st)
        st[:, self._piece_len == 0] = -1  # model-vocab padding ids
        if 0 <= self.bos_id < V:
            st[:, self.bos_id] = -1  # bos never appears mid-stream
        ids = np.arange(S, dtype=np.int32)
        for e in self.eos_ids:
            st[:, e] = np.where(accepting, ids, -1)
        # every token-reachable state must keep >= 1 legal token, or a
        # constrained row would mask the entire vocabulary mid-generation
        legal_any = (st >= 0).any(axis=1)
        reach = np.zeros(S, bool)
        stack = [0]
        reach[0] = True
        while stack:
            s = stack.pop()
            if not legal_any[s]:
                raise GrammarError(
                    "grammar dead-ends: a reachable state has no legal "
                    "token under this vocabulary"
                )
            for t in np.unique(st[s][st[s] >= 0]):
                if not reach[t]:
                    reach[t] = True
                    stack.append(int(t))
        non_eos = st.copy()
        for e in self.eos_ids:
            non_eos[:, e] = -1
        terminal = accepting & ~(non_eos >= 0).any(axis=1)
        return CompiledGrammar(
            key=key, kind=kind, pattern=pattern, table=st,
            trans_byte=trans_byte, accepting=accepting, terminal=terminal,
            eos_ids=self.eos_ids,
        )


# ---------------------------------------------------------------------------
# Device arena
# ---------------------------------------------------------------------------


class GrammarArena:
    """All live grammars as ONE [S, V] int32 host table (copied into the
    engine's device buffer by `InferenceEngine._gr_operand` when `version`
    moves). Row 0 is FREE
    (all-legal self-loop); grammars occupy contiguous spans of global
    states, their local tables shifted by the span base. Zero-ref spans
    stay installed (a warm reuse hit is free) until space is needed."""

    def __init__(self, vocab_size: int, n_states: int | None = None):
        if n_states is None:
            per_state = 4 * max(vocab_size, 1)
            n_states = (grammar_arena_mb() * (1 << 20)) // per_state
        self.n_states = int(max(64, min(65536, n_states)))
        self.vocab_size = int(vocab_size)
        self.table = np.full((self.n_states, self.vocab_size), -1, np.int32)
        self.table[FREE_STATE, :] = FREE_STATE
        self.version = 1
        #: key -> [base, size, refs]; insertion order is the LRU order
        self._spans: OrderedDict[int, list] = OrderedDict()

    def _gap(self, need: int) -> int | None:
        used = sorted((s[0], s[1]) for s in self._spans.values())
        prev_end = 1  # row 0 reserved for FREE
        for base, size in used:
            if base - prev_end >= need:
                return prev_end
            prev_end = base + size
        return prev_end if self.n_states - prev_end >= need else None

    def install(self, g: CompiledGrammar) -> int:
        span = self._spans.get(g.key)
        if span is not None:
            span[2] += 1
            self._spans.move_to_end(g.key)
            return span[0]
        need = g.n_states
        if need > self.n_states - 1:
            raise GrammarError(
                f"grammar needs {need} states; the device mask-table "
                f"arena holds {self.n_states - 1} ({ENV_ARENA_MB})"
            )
        base = self._gap(need)
        while base is None:
            evicted = False
            for key, (b, size, refs) in list(self._spans.items()):
                if refs == 0:
                    self.table[b : b + size, :] = -1
                    del self._spans[key]
                    evicted = True
                    break
            if not evicted:
                raise GrammarError(
                    "device mask-table arena exhausted by live grammars "
                    f"({ENV_ARENA_MB}) — retry later or raise the budget"
                )
            base = self._gap(need)
        self.table[base : base + need, :] = np.where(g.table >= 0, g.table + base, -1)
        self._spans[g.key] = [base, need, 1]
        self.version += 1
        return base

    def spans(self) -> dict:
        """{grammar key: (base, size)} of the installed spans, live or not:
        what the engine diffs to upload only the rows an install or an
        eviction changed."""
        return {k: (s[0], s[1]) for k, s in self._spans.items()}

    def release(self, key: int):
        span = self._spans.get(key)
        if span is not None and span[2] > 0:
            span[2] -= 1

    def snapshot(self) -> dict:
        return {
            "n_states": self.n_states,
            "vocab": self.vocab_size,
            "bytes": int(self.table.nbytes),
            "version": self.version,
            "spans": len(self._spans),
            "live": sum(1 for s in self._spans.values() if s[2] > 0),
        }


# ---------------------------------------------------------------------------
# Host-side per-row tracking
# ---------------------------------------------------------------------------


class GrammarSession:
    """One request's authoritative grammar state, advanced from ACCEPTED
    tokens host-side (the in-graph carry is its traced mirror). Owns an
    arena span ref: close() releases it."""

    def __init__(self, arena: GrammarArena, grammar: CompiledGrammar):
        self.arena = arena
        self.grammar = grammar
        self.base = arena.install(grammar)
        self.state = 0
        self.done = False
        self.n_illegal = 0
        self._closed = False

    @property
    def row_state(self) -> int:
        """The global-state operand for this row (FREE once finished)."""
        return FREE_STATE if self.done else self.base + self.state

    @property
    def at_terminal(self) -> bool:
        """Only eos is legal here — the server may stop the stream now and
        count the last emitted token as delivered (EOS-equivalent stop)."""
        return (not self.done) and bool(self.grammar.terminal[self.state])

    def is_legal(self, tok: int) -> bool:
        if self.done:
            return True
        if not 0 <= tok < self.grammar.table.shape[1]:
            return False
        return int(self.grammar.table[self.state, tok]) >= 0

    def advance(self, tok: int) -> str:
        """'ok' | 'terminal' | 'eos' | 'done' | 'illegal'."""
        if self.done:
            return "done"
        g = self.grammar
        nxt = (
            int(g.table[self.state, tok])
            if 0 <= tok < g.table.shape[1]
            else -1
        )
        if nxt < 0:
            self.n_illegal += 1
            return "illegal"
        if tok in g.eos_ids:
            self.done = True
            return "eos"
        self.state = nxt
        return "terminal" if g.terminal[self.state] else "ok"

    def legal_prefix(self, tokens) -> int:
        """Length of the longest draft prefix every token of which is legal
        (stopping before any eos) — speculative drafts are pre-truncated to
        this so greedy longest-prefix acceptance can never admit an illegal
        token."""
        if self.done:
            return 0
        g = self.grammar
        s, n = self.state, 0
        for t in tokens:
            t = int(t)
            if t in g.eos_ids or not 0 <= t < g.table.shape[1]:
                break
            nxt = int(g.table[s, t])
            if nxt < 0:
                break
            s = nxt
            n += 1
        return n

    def verify_states(self, tokens) -> np.ndarray:
        """Global grammar states for the verify operand: position j is the
        state BEFORE feeding tokens[j] emits its logits — i.e. the state
        after walking tokens[:j]. Positions past an illegal/eos token ride
        FREE (their logits are beyond the acceptance horizon)."""
        out = np.zeros(len(tokens) + 1, np.int32)
        if self.done:
            return out
        g = self.grammar
        s = self.state
        out[0] = self.base + s
        for j, t in enumerate(tokens):
            t = int(t)
            if t in g.eos_ids or not 0 <= t < g.table.shape[1]:
                break
            nxt = int(g.table[s, t])
            if nxt < 0:
                break
            s = nxt
            out[j + 1] = self.base + s
        return out

    def close(self):
        if not self._closed:
            self._closed = True
            self.arena.release(self.grammar.key)
