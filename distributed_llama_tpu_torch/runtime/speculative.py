"""Speculative decoding: draft sources and the bucketed greedy verify.

The counterpart of the JAX package's `runtime/speculative.py`. A cheap
draft source proposes up to k tokens; one verify forward scores
`[last_token, d1..dk]` at positions `pos..pos+k` with logits at every
position, and greedy acceptance keeps the longest draft prefix that
matches the model's own argmax chain, plus the bonus token at the first
mismatch. One round emits 1..k+1 tokens of the plain greedy chain.

* `NGramDraft` (prompt lookup) proposes what followed the most recent
  earlier occurrence of the context's longest suffix n-gram: host numpy,
  no device work. `ModelDraft` drafts with a second, smaller engine at
  batch 1, its cache resynced to the accepted context.
* Speculation applies to greedy requests only; sampled ones keep the
  plain chunked path.
* Rejected drafts need no KV rollback: positions past the accepted
  boundary are rewritten by a later round's feed before any query reads
  them.
* Draft lengths are bucketed at k in {4, 8} (`spec_buckets`): the verify
  kinds of the warm ladder are ("verify" | "verify_row", k + 1, kv bucket).
  On the card each is a CUDA graph (runtime/graphs.py) of
  runtime/decode.py's `verify_step`.
* The verify position is a device tensor, eager and graphed alike (a 0-d
  tensor with the rows aligned, a [b] tensor per row), so the two take the
  same arms and agree bit for bit. With the rows aligned a feed of 8 or
  more tokens (k = 8) on a bf16 cache takes the flash kernel (K3), which
  reads the 0-d position on the device, as the JAX package's verify takes
  its flash kernel; shorter feeds and per-row positions take the plain
  attention, as in JAX.
* A MoE model's round of more than one token and fewer than n_experts /
  n_active runs its FFN on K4 on the bf16 kernel path
  (`models/transformer.py:moe_small_rows_grouped`), where the JAX package
  gathers each row's experts: each hit expert read once, its weights
  rounded as JAX's gather arm rounds them (K4's exact-scale rounding).
  Only the f32 and unaligned arms still gather.
* Each round is recorded in the engine's StepStats under the JAX names
  (`note_round`: the spec_* counters and the ``spec_acceptance_rate``
  gauge; the ``spec_verify[K]`` latency series); `engine.spec_counters`
  is their dict view (`spec_snapshot`). A per-row round also emits its
  engine-level ``verify_row`` trace event (runtime/tracing.py).
* Grammar-constrained rows (runtime/grammar.py) compose with speculation
  as in the JAX package: a constrained row's drafts are cut to their
  grammar-legal prefix (`GrammarSession.legal_prefix`), and a grammar
  engine's verify round masks its [b, t] logits with the per-position
  states (`GrammarSession.verify_states`; free rows and positions past
  the acceptance horizon ride FREE), so acceptance, bonus token included,
  never admits an illegal token.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..models.transformer import forward
from ..ops.sampling import apply_grammar_mask
from .tracing import TRACER, to_us

SPEC_MODES = ("off", "ngram", "model")

#: power-of-two draft-length buckets: every verify program's draft capacity
#: is one of these, so the number of verify graphs stays O(|buckets|)
DRAFT_BUCKETS = (4, 8)


def resolve_spec_mode(explicit: str | None, default: str = "off") -> str | None:
    """The speculative mode: an explicit value wins; otherwise
    ``DLT_SPECULATIVE``; an unset or unrecognized env value means
    `default` (library engines pass "off", the CLI passes "ngram").
    Returns None for "off"."""
    mode = explicit
    if mode is None:
        raw = (os.environ.get("DLT_SPECULATIVE") or "").strip().lower()
        mode = raw if raw in SPEC_MODES else default
    mode = mode.strip().lower()
    if mode not in SPEC_MODES:
        raise ValueError(
            f"unknown speculative mode {mode!r} (choose from {SPEC_MODES})"
        )
    return None if mode == "off" else mode


def resolve_draft_k(explicit: int | None = None) -> int:
    """Max drafted tokens per verify round: explicit > ``DLT_DRAFT_K`` env >
    4. Snapped to the available buckets by :func:`spec_buckets`."""
    if explicit is not None and explicit > 0:
        return int(explicit)
    raw = os.environ.get("DLT_DRAFT_K")
    try:
        v = int(raw) if raw else 0
    except ValueError:
        v = 0
    return v if v > 0 else 4


def spec_buckets(draft_k: int) -> tuple:
    """The draft buckets a ``draft_k`` budget enables, ascending: always at
    least the smallest bucket."""
    out = tuple(b for b in DRAFT_BUCKETS if b <= draft_k)
    return out or (DRAFT_BUCKETS[0],)


# -- the verify forward ------------------------------------------------------


def verify_chunk(cfg, params, rope, cache, tokens, pos_start, kv_len=None, page_table=None,
                 page_size=None, grammar_table=None, grammar_state=None):
    """One verify forward over `tokens` [b, t]: logits at every position
    and their greedy argmax. `pos_start` is an int, a 0-d device tensor
    (rows aligned) or a [b] device tensor (per-row positions, a row at
    seq_len parked), as `forward` takes it. The t KV writes land in the
    cache in place. With grammar operands (`grammar_state` [b, t] int64:
    position j's global state after the feed's first j drafts) the logits
    are masked before the argmax (JAX `runtime/speculative.py:132-157`).
    Returns (greedy ids [b, t] int32, logits [b, t, vocab] f32, masked),
    on the device."""
    logits = forward(
        cfg, params, rope, cache, tokens, pos_start, logits_mode="all", kv_len=kv_len,
        page_table=page_table, page_size=page_size,
    )
    logits = apply_grammar_mask(logits, grammar_table, grammar_state)
    return torch.argmax(logits, dim=-1).to(torch.int32), logits


def accept_greedy(drafts, greedy_ids) -> int:
    """Longest-prefix greedy acceptance: the number of leading drafts that
    match the verify forward's own argmax chain. ``greedy_ids[a]`` for the
    returned ``a`` is then the bonus token, so every round emits ``a + 1``
    tokens of the plain-decode chain."""
    a = 0
    for d in drafts:
        if int(greedy_ids[a]) != int(d):
            break
        a += 1
    return a


def note_round(stats, n_drafted: int, n_accepted: int) -> None:
    """Record one verify round in `stats` (the engine's StepStats): the
    four spec_* counters and the lifetime ``spec_acceptance_rate`` gauge
    (accepted / drafted), as JAX :174-190. A plain dict takes the same
    counts and the gauge as a key of its own."""
    counts = (("spec_rounds", 1), ("spec_draft_tokens", n_drafted),
              ("spec_accepted_tokens", n_accepted),
              ("spec_rejected_tokens", n_drafted - n_accepted))
    if isinstance(stats, dict):
        for name, n in counts:
            stats[name] = stats.get(name, 0) + n
        c = stats
    else:
        for name, n in counts:
            stats.incr(name, n)
        c = stats.counters_snapshot()
    drafted = c.get("spec_draft_tokens", 0)
    if drafted:
        rate = round(c.get("spec_accepted_tokens", 0) / drafted, 4)
        if isinstance(stats, dict):
            stats["spec_acceptance_rate"] = rate
        else:
            stats.gauge("spec_acceptance_rate", rate)


def choose_bucket(buckets, dmax: int) -> int:
    """Smallest draft bucket covering `dmax` drafted tokens (the largest
    bucket when none does: callers have already truncated)."""
    return next((k for k in buckets if k >= dmax), buckets[-1])


def verify_row_round(engine, drafts: dict, token, pos, seq_len: int, grammars=None) -> dict:
    """One per-row verify round, the shared core of
    `BatchSession.spec_step` and `InferenceEngine._decode_batch_speculative`.
    `drafts` maps row -> proposed tokens (an empty list: the row takes its
    bonus token only); `token`/`pos` are row-indexable current state; rows
    absent from `drafts` are parked at `seq_len` (writes dropped, no
    progress). `grammars` (row-indexable, entries None or GrammarSession):
    a constrained row's drafts are cut to their legal prefix and the round
    carries a [b, K+1] state operand (JAX :199-260). Assembles the [b, K+1]
    feed, dispatches the ("verify_row", K+1, kv bucket) round and fetches
    the greedy ids once under the engine's watchdog, records the
    ``spec_verify[K]`` series and the round's ``verify_row`` event, and
    returns {row: emitted tokens} after per-row acceptance (counted by
    `note_round`). Callers advance their own position, token and grammar
    state."""
    rows = sorted(drafts)

    def _sess(r):
        return grammars[r] if grammars is not None else None

    clean = {r: [int(t) for t in drafts[r]] for r in rows}
    for r in rows:
        g = _sess(r)
        if g is not None:
            clean[r] = clean[r][: g.legal_prefix(clean[r])]
    K = choose_bucket(engine.spec_buckets, max(len(clean[r]) for r in rows))
    clean = {r: clean[r][:K] for r in rows}
    size = K + 1
    toks = np.zeros((engine.batch, size), np.int64)
    pv = np.full((engine.batch,), seq_len, np.int64)
    for r in rows:
        toks[r, 0] = int(token[r])
        toks[r, 1 : 1 + len(clean[r])] = clean[r]
        pv[r] = int(pos[r])
    gr_states = None
    if engine.grammar is not None and any(_sess(r) is not None for r in rows):
        gr_states = np.zeros((engine.batch, size), np.int64)
        for r in rows:
            g = _sess(r)
            if g is not None:
                vs = g.verify_states(clean[r])
                gr_states[r, : len(vs)] = vs
    kvb = engine._kv_bucket(min(int(max(pv[r] for r in rows)) + size, seq_len))
    t0 = time.perf_counter()
    with engine._guard(f"verify_row[{K}]", ("verify_row", size, kvb)):
        ids_dev, _ = engine._dispatch_verify(toks, pv, kvb, gr_states=gr_states)
        ids = engine._host_fetch(ids_dev)  # the round's one fetch
    engine.stats.record(f"spec_verify[{K}]", (time.perf_counter() - t0) * 1e6)
    # one engine-level event a round (per-row acceptance spans belong to
    # the caller, which owns the row -> request mapping)
    TRACER.event(
        "verify_row", to_us(t0), int((time.perf_counter() - t0) * 1e6),
        ("rows", "bucket"), (len(rows), K),
    )
    out = {}
    for r in rows:
        a = accept_greedy(clean[r], ids[r])
        note_round(engine.stats, len(clean[r]), a)
        out[r] = clean[r][:a] + [int(ids[r, a])]
    return out


def spec_snapshot(engine) -> dict | None:
    """The speculation section of the JAX server's `/stats`: configuration
    and the acceptance counters (None when speculation is off)."""
    if engine.spec_mode is None:
        return None
    c = engine.stats.counters_snapshot()
    drafted = c.get("spec_draft_tokens", 0)
    accepted = c.get("spec_accepted_tokens", 0)
    return {
        "mode": engine.spec_mode,
        "draft_k": engine.draft_k,
        "buckets": list(engine.spec_buckets),
        "rounds": c.get("spec_rounds", 0),
        "draft_tokens": drafted,
        "accepted_tokens": accepted,
        "rejected_tokens": c.get("spec_rejected_tokens", 0),
        "acceptance_rate": round(accepted / drafted, 4) if drafted else None,
    }


# -- draft sources -----------------------------------------------------------


class DraftSource:
    """A proposer of likely next tokens. ``draft(ctx, k)`` returns up to
    ``k`` tokens it expects the model to emit after ``ctx`` (prompt and
    generated tokens so far); an empty list means "no idea", and the
    caller falls back to a plain decode chunk for the round."""

    name = "base"

    def draft(self, ctx: list, k: int) -> list:
        raise NotImplementedError

    def warmup(self) -> None:
        """Capture anything the source will run while serving (called from
        ``InferenceEngine.warmup()`` before the graph cache seals)."""

    def close(self) -> None:
        pass


class NGramDraft(DraftSource):
    """Prompt-lookup drafting: match the context's own suffix n-gram
    against earlier context and propose the tokens that followed the most
    recent match. Longest n wins (``max_n`` down to ``min_n``); a match
    whose continuation runs into the context edge proposes however many
    tokens remain. Host arithmetic over the token list only."""

    name = "ngram"

    def __init__(self, max_n: int = 4, min_n: int = 1):
        if min_n < 1 or max_n < min_n:
            raise ValueError(f"bad n-gram range [{min_n}, {max_n}]")
        self.max_n = max_n
        self.min_n = min_n

    def draft(self, ctx: list, k: int) -> list:
        L = len(ctx)
        if k <= 0 or L < self.min_n + 1:
            return []
        arr = np.asarray(ctx, dtype=np.int64)
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            pat = arr[L - n :]
            # windows start at 0..L-n; the last one is the suffix itself
            windows = np.lib.stride_tricks.sliding_window_view(arr, n)[:-1]
            hits = np.nonzero((windows == pat).all(axis=1))[0]
            if hits.size:
                i = int(hits[-1])  # the most recent earlier occurrence
                cont = ctx[i + n : i + n + k]
                if cont:
                    return [int(t) for t in cont]
        return []


class ModelDraft(DraftSource):
    """A second (smaller) engine at batch 1 drafting greedily. Its cache
    tracks the accepted context by common-prefix resync: each ``draft``
    prefills whatever suffix of ``ctx[:-1]`` the draft cache does not hold,
    then runs one greedy decode chunk (graphed on the card) and returns its
    tokens. The chunk's length is snapped to the draft engine's decode
    ladder (a power of two up to its decode_chunk_size), so an odd k never
    asks for a chunk size the warm ladder lacks."""

    name = "model"

    def __init__(self, engine, owns: bool = True):
        if engine.batch != 1:
            raise ValueError("draft engines run batch=1 (one drafted chain)")
        self.engine = engine
        self._owns = owns
        self._synced: list = []  # tokens whose KV the draft cache holds

    def draft(self, ctx: list, k: int) -> list:
        eng = self.engine
        L = len(ctx)
        if k <= 0 or L == 0:
            return []
        n = 1
        while n < k:
            n *= 2
        n = min(n, eng.decode_chunk_size)
        # the chunk writes draft KV at positions L-1 .. L-2+n, all inside
        # the draft model's context
        if L + n > eng.cfg.seq_len:
            return []
        pre = [int(t) for t in ctx[:-1]]
        cp = 0
        lim = min(len(self._synced), len(pre))
        while cp < lim and self._synced[cp] == pre[cp]:
            cp += 1
        if len(pre) > cp:
            eng.prefill(pre[cp:], pos_start=cp, publish=False)
        # a paged draft engine maps the chunk's pages in `_decode_chunk`
        toks, _ = eng._decode_chunk(eng._tokens([int(ctx[-1])]), L - 1, n)
        out = toks[0].tolist()
        # the chunk fed ctx[-1] and the first n - 1 drafts; the n-th was
        # sampled but never fed
        self._synced = [int(t) for t in ctx] + out[:-1]
        return out[:k]

    def warmup(self) -> None:
        self.engine.warmup()
        self._synced = []

    def close(self) -> None:
        if self._owns:
            self.engine.close()


def build_draft_source(mode: str | None, draft_source=None) -> DraftSource | None:
    """Engine-side factory: an explicit source wins (any mode); otherwise
    ngram builds its default and model requires one (the CLI builds it
    from ``--draft-model``)."""
    if mode is None:
        return None
    if draft_source is not None:
        return draft_source
    if mode == "ngram":
        return NGramDraft()
    raise ValueError(
        "speculative='model' requires a draft_source (a ModelDraft wrapping "
        "the smaller engine; the CLI builds one from --draft-model)"
    )
