"""Continuous batching: rolling admission over parkable batch rows.

The counterpart of the JAX package's `runtime/batch_session.py`:
`batch_decode_chunk` (:62), `prefill_row` (:114) and `BatchSession` (:160)
with `admit`, `begin_admit`, `prefill_pending` (budgeted, interleaved with
decode chunks), `release`, `step`, `spec_step`, `publish_row`,
`pending_resume` and the row queries, the prefix-cache splice and
publish, grammar-constrained rows, and the request traces and StepStats
series (runtime/tracing.py, runtime/telemetry.py).

* Every batch row is an independent slot with its own position, last
  token, sampling settings and random stream.
* A free slot is (re)filled between decode chunks: its prompt prefills
  into its row alone at b = 1 (engine `_dispatch_prefill_row`), in chunks
  of a bounded token budget, so a long prompt interleaves with the other
  rows' decode.
* Admission consults the engine's prefix cache (runtime/prefix_cache.py):
  `begin_admit` matches the prompt and pins the entry; the first
  `prefill_pending` splices it into the row (paged: shares its pages;
  contiguous: copies its slice), unpins it and resumes at its boundary;
  arming publishes the row's prompt, and `publish_row` a retiring row's
  whole sequence.
* `step(n)` decodes n tokens for all slots with per-row positions and
  per-row temperature and top-p; a row's draws come from a counter-based
  stream of its own seed and draw count (ops/sampling.py `row_coins`), so
  its sampled tokens never depend on its co-tenants.
* A finished row is parked (pos = seq_len): it keeps riding the chunk, its
  writes land nowhere, its tokens are discarded.
* On a mesh every step and admission chunk runs the shard loop
  (parallel/pipeline.py; JAX :543), an admission chunk as the full batch
  with the other rows parked.
* On the card `step` replays the engine's "batch_decode" CUDA graph of its
  (batch, kv bucket, sampling arm) key (runtime/graphs.py, `batch_decode_step`),
  unless `engine.graph_eligible` keeps the arm eager.
* `spec_step(drafts)` is one speculative verify round over the named
  greedy rows (runtime/speculative.py `verify_row_round`): the
  "verify_row" graph of `decode.verify_step`; each row advances by its own
  1..k+1 accepted tokens, the others stay parked for the round.
* A row may be constrained by a grammar (runtime/grammar.py): `admit` and
  `begin_admit` take a `GrammarSession`, which the row holds from arming
  to `release` (its owner advances and closes it, as in the JAX session).
  On an engine with a grammar arena every chunk and round carries the
  per-row states (a free row rides the all-legal FREE state 0), masked
  and advanced inside the step, so constrained and free rows share one
  graph; the host sessions are authoritative between chunks.
* A row may carry its request's Trace (`admit(trace=)`): its admission
  emits ``prefix_match``, ``prefix_splice`` and one ``prefill_chunk`` span
  a chunk, with the row (JAX :285, :304, :354). Each admission chunk and
  each `step` runs under the engine's watchdog, and a step's wall lands in
  the engine's StepStats as ``batch_decode[n]`` (JAX :585-596); a
  `spec_step` round is guarded and recorded in `verify_row_round`.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import numpy as np
import torch

from ..models.params import KVCache
from ..models.transformer import forward
from ..ops.sampling import (
    advance_grammar, apply_grammar_mask, row_coins, sample_logits_per_row, sampler_arm,
)
from ..parallel.pipeline import pipeline_forward
from ..parallel.sharding import MeshKV
from .decode import sample_step
from .speculative import choose_bucket, verify_row_round
from .tracing import to_us

_SEED_MASK = (1 << 63) - 1


class Rows(NamedTuple):
    """The per-row operands of a batch_decode chunk, [b] each, on the host
    or the device: what `StepBuffers` holds for its graph."""

    token: Any  # int64: the token each row feeds next
    pos: Any  # int64: its position (seq_len = parked)
    seeds: Any  # int64: its stream seed
    draws: Any  # int64: its draw counter
    temperature: Any  # f32: <= 0 = a greedy row
    topp: Any  # f32


def row_states(grammars) -> np.ndarray | None:
    """The per-row grammar-state operand [b] of `grammars` (GrammarSession
    or None a row; a free row's: FREE 0), or None where no row is
    constrained (an engine with an arena then threads FREE zeros)."""
    if grammars is None or all(g is None for g in grammars):
        return None
    return np.fromiter((g.row_state if g is not None else 0 for g in grammars), np.int64,
                       count=len(grammars))


def row_seeds(base: int, batch: int) -> list[int]:
    """The stream seeds of `batch` rows drawn from one base seed (a
    sampler's state), one stream a row."""
    return [(int(base) ^ (r * 0x9E3779B97F4A7C15)) & _SEED_MASK for r in range(batch)]


def batch_decode_chunk(
    cfg,
    params,
    rope,
    cache: KVCache,
    rows: Rows,  # on the cache's device
    n_steps: int,
    kv_len: int | None = None,
    page_table: torch.Tensor | None = None,
    page_size: int | None = None,
    sampler: str = "topp",  # ops/sampling.py `sampler_arm` of the rows' settings
    grammar_table: torch.Tensor | None = None,  # [S, vocab] int32 grammar arena
    grammar_state: torch.Tensor | None = None,  # [b] int64: free rows at FREE 0
) -> torch.Tensor:
    """n_steps decode iterations with per-row positions and sampling, all
    on the device; with grammar operands each step masks the logits at the
    rows' states and advances them by the token (JAX :76-108). Returns
    (tokens [b, n_steps], the last step's logits), and with
    `grammar_state` the final states as a 3rd output."""
    token, pos, seeds, draws, temperature, topp = rows
    out = []
    logits = None
    for i in range(n_steps):
        logits = forward(
            cfg, params, rope, cache, token[:, None], pos + i,
            kv_len=kv_len, page_table=page_table, page_size=page_size,
        )
        if sampler != "greedy":
            token = sample_logits_per_row(logits, row_coins(seeds, draws + i), temperature, topp,
                                          topp_arm=sampler == "topp", grammar_table=grammar_table,
                                          grammar_state=grammar_state)
        else:
            token = torch.argmax(apply_grammar_mask(logits, grammar_table, grammar_state), dim=-1)
        if grammar_state is not None:
            grammar_state = advance_grammar(grammar_table, grammar_state, token)
        out.append(token)
    if grammar_state is not None:
        return torch.stack(out, dim=1), logits, grammar_state
    return torch.stack(out, dim=1), logits


def batch_decode_step(cfg, params, rope, cache: KVCache, bufs, kv_len: int,
                      page_size: int | None = None, sampler: str = "topp") -> torch.Tensor:
    """One capture-safe `batch_decode_chunk` iteration on static buffers
    (runtime/graphs.py `StepBuffers`): the draw counter is `draws + step`
    with the step counter on the device, so a graph of it replays every
    step of a chunk; the grammar mask and advance at `bufs.gstate` where
    the engine has an arena (`decode.sample_step`). Returns the step's
    logits [b, vocab] f32."""
    logits = forward(
        cfg, params, rope, cache, bufs.token[:, None], bufs.pos, kv_len=kv_len,
        page_table=bufs.table if page_size else None, page_size=page_size,
    )
    token = sample_step(logits, bufs, sampler, lambda: sample_logits_per_row(
        logits, row_coins(bufs.seeds, bufs.draws + bufs.step), bufs.temperature, bufs.topp,
        topp_arm=sampler == "topp", grammar_table=bufs.grammar, grammar_state=bufs.gstate))
    bufs.advance(token)
    return logits


def prefill_row(cfg, params, rope, cache: KVCache, tokens: torch.Tensor, pos_start: int,
                row: int, kv_len: int | None = None) -> None:
    """Prefill one row of a contiguous batched cache with the ordinary b = 1
    forward at a scalar position (flash-eligible), on a view of the row's
    slab: the writes land in place, no copy moves in or out (JAX slices
    the row out and writes it back). On a mesh the view is the row's in
    every shard of its dp group (`MeshKV.row_view`; JAX runs the whole
    batch with the other rows parked, engine.py:1066-1089)."""
    if isinstance(cache, MeshKV):
        view = cache.row_view(row)
        pipeline_forward(cfg, view.mesh, params, rope, view, tokens, pos_start, kv_len=kv_len)
        return
    view = KVCache(*(None if t is None else t[:, row : row + 1]
                     for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)))
    forward(cfg, params, rope, view, tokens, pos_start, kv_len=kv_len)


class BatchSession:
    """Host-side slot state for one continuously-batched engine. Not
    thread-safe. Device work happens in `prefill_pending` and `step`."""

    def __init__(self, engine):
        self.engine = engine
        b = engine.batch
        self.seq_len = engine.cfg.seq_len
        self.pos = np.full((b,), self.seq_len, np.int64)  # parked
        self.token = np.zeros((b,), np.int64)
        self.active = np.zeros((b,), bool)
        self.temp = np.zeros((b,), np.float32)
        self.topp = np.full((b,), 0.9, np.float32)
        self.seeds = np.zeros((b,), np.int64)
        self.draws = np.zeros((b,), np.int64)
        # per-row GrammarSession or None; the session is shared with the
        # request's owner, who advances it from the accepted tokens and
        # closes it: this list only feeds the rows' state operand
        self.grammars: list = [None] * b
        self._admits = 0  # numbers the unseeded admissions' streams
        # rows mid-admission, in staging order: prompt and prefill progress
        self._pending: dict[int, dict] = {}
        engine.reset()

    def free_rows(self) -> list[int]:
        return [r for r in range(len(self.active)) if not self.active[r] and r not in self._pending]

    def active_rows(self) -> list[int]:
        return [r for r in range(len(self.active)) if self.active[r]]

    def pending_rows(self) -> list[int]:
        """Rows whose admission is staged and not yet armed, in staging
        order."""
        return list(self._pending)

    def pending_resume(self, row: int) -> int:
        """The prefix-cache resume boundary of `row`'s staged admission
        (the tokens its splice covers; 0 = cold)."""
        st = self._pending.get(row)
        return 0 if st is None else int(st["resume"])

    def admit(self, row: int, prompt_tokens: list[int], temperature: float = 0.0,
              topp: float = 0.9, seed: int | None = None, grammar=None, trace=None) -> None:
        """Prefill `prompt_tokens[:-1]` into `row` and arm the slot: the
        row decodes from the next `step`."""
        self.begin_admit(row, prompt_tokens, temperature, topp, seed, grammar=grammar,
                         trace=trace)
        self.prefill_pending(row)

    def begin_admit(self, row: int, prompt_tokens: list[int], temperature: float = 0.0,
                    topp: float = 0.9, seed: int | None = None, grammar=None,
                    trace=None) -> None:
        """Stage an admission without running its prefill; `prefill_pending`
        then advances it between decode chunks. The row stays parked until
        its prefill completes. `seed`: the row's stream; None gives each
        admission a stream of its own, numbered in arrival order.
        `grammar`: the GrammarSession constraining the row (None = free);
        an engine without a grammar arena refuses it. `trace`: the
        request's runtime/tracing.py Trace (None = untraced), which takes
        the admission's spans."""
        n = len(prompt_tokens)
        if n == 0:
            raise ValueError("empty prompt")
        if n >= self.seq_len:
            raise ValueError(f"prompt ({n} tokens) exceeds the context window ({self.seq_len})")
        if self.active[row]:
            raise ValueError(f"row {row} is still active")
        if row in self._pending:
            raise ValueError(f"row {row} already has a pending admission")
        if grammar is not None and self.engine.grammar is None:
            raise ValueError("this engine was built without a grammar arena")
        if seed is None:
            self._admits += 1
            seed = (self._admits * 2654435761) & 0xFFFFFFFF
        # the prefix-cache lookup at staging, host-only: the entry stays
        # pinned until its splice in `prefill_pending` (or `release`)
        resume, entry = 0, None
        eng = self.engine
        if eng.prefix_cache is not None and not eng._in_warmup:
            t_match = time.perf_counter()
            resume, entry = eng.prefix_cache.match_for_splice(prompt_tokens[:-1])
            if trace is not None:
                trace.event("prefix_match", to_us(t_match),
                            int((time.perf_counter() - t_match) * 1e6),
                            ("resume_tokens", "row"), (resume, row))
        self._pending[row] = {
            "tokens": list(prompt_tokens),
            "done": 0,  # prefilled prefix length within tokens[:-1]
            "temperature": temperature,
            "topp": topp,
            "seed": int(seed) & _SEED_MASK,
            "grammar": grammar,
            "resume": resume,  # the prefix-cache boundary
            "entry": entry,  # the pinned PrefixEntry to splice, or None
            "trace": trace,
            # one tuple append an admission chunk
            "em_chunk": None if trace is None else trace.bind("prefill_chunk", ("size", "row")),
        }

    def prefill_pending(self, row: int, max_tokens: int | None = None) -> int:
        """Advance `row`'s staged prefill by up to `max_tokens` tokens (None
        = to completion); returns the prefill tokens still remaining. Chunks
        follow the padded power-of-two ladder, planned against the
        remaining budget so a budget below max_chunk is honoured exactly.
        When the last chunk lands the slot arms."""
        from .engine import chunk_plan

        eng = self.engine
        st = self._pending[row]
        pre = st["tokens"][:-1]
        budget = len(pre) if max_tokens is None else max_tokens
        entry = st.pop("entry", None)
        if entry is not None:
            # the splice covers [0, resume); positions past it that the
            # entry also wrote are rewritten by the chunks below before any
            # query reads them
            pc = eng.prefix_cache
            t_splice = time.perf_counter()
            try:
                if eng.paged:
                    pc.share_row(eng, entry, row, st["resume"])
                else:
                    pc.splice_row(eng, entry, row)
            finally:
                pc.entry_release(entry)
            pc.record_hit(st["resume"])
            if st["trace"] is not None:
                st["trace"].event("prefix_splice", to_us(t_splice),
                                  int((time.perf_counter() - t_splice) * 1e6),
                                  ("tokens", "row"), (st["resume"], row))
            st["done"] = min(st["resume"], len(pre))
        em_chunk = st["em_chunk"]
        while st["done"] < len(pre) and budget > 0:
            done = st["done"]
            t_chunk = time.perf_counter()
            _, size, n_real = next(iter(chunk_plan(
                min(len(pre) - done, budget), done, eng.max_chunk, self.seq_len
            )))
            chunk = pre[done : done + n_real] + [0] * (size - n_real)
            kv_len = eng._kv_bucket(done + size)
            # keyed on the chunk's (size, kv bucket): the shapes its first
            # call builds kernels for
            with eng._guard(f"prefill_row[{size}|kv{kv_len}]", ("prefill_row", size, kv_len)):
                eng._dispatch_prefill_row(row, chunk, done, kv_len)
            if em_chunk is not None:
                # the chunk's dispatch wall (the next step's fetch sees it
                # complete, as the solo prefill's spans)
                em_chunk(to_us(t_chunk), int((time.perf_counter() - t_chunk) * 1e6), n_real, row)
            st["done"] = done + n_real
            budget -= n_real
        remaining = len(pre) - st["done"]
        if remaining > 0:
            return remaining
        tokens = st["tokens"]
        self.pos[row] = len(tokens) - 1
        self.token[row] = tokens[-1]
        self.temp[row] = st["temperature"]
        self.topp[row] = st["topp"]
        self.seeds[row] = st["seed"]
        self.draws[row] = 0
        self.grammars[row] = st["grammar"]
        self.active[row] = True
        del self._pending[row]
        if eng.prefix_cache is not None and not eng._in_warmup:
            # at arming, so a burst of admissions sharing a prompt hits
            # from the second one on
            eng.prefix_cache.publish_from_row(eng, row, pre)
        return 0

    def release(self, row: int) -> None:
        """Park the row: its writes land nowhere from the next chunk on, so
        the slot can be re-admitted later without disturbing anyone. Drops
        a staged admission mid-prefill and unpins the prefix entry it never
        spliced; a paged engine unmaps the row's pages (pages that prefix
        entries retain survive)."""
        self.active[row] = False
        self.pos[row] = self.seq_len
        self.temp[row] = 0.0
        self.grammars[row] = None  # the session's owner closes it
        st = self._pending.pop(row, None)
        if st is not None and st.get("entry") is not None:
            self.engine.prefix_cache.entry_release(st["entry"])
        if self.engine.paged:
            self.engine.page_pool.release_row(row)

    def publish_row(self, row: int, tokens: list) -> None:
        """Publish the KV of `row`'s first `len(tokens) - 1` tokens into the
        engine's prefix cache (nothing without one): a retiring row's
        prompt and delivered tokens, every position below the cap fed. The
        last token is left out: its slot is unwritten when it was the last
        sample of the row's last chunk."""
        eng = self.engine
        if eng.prefix_cache is None or eng._in_warmup or len(tokens) < 2:
            return
        eng.prefix_cache.publish_from_row(eng, row, list(tokens), max_len=len(tokens) - 1)

    def spec_step(self, drafts: dict) -> dict:
        """One speculative verify round for the rows named in `drafts` (row
        -> proposed tokens; an empty list is valid: the row still advances
        by its one greedy bonus token). Rows absent from `drafts` are
        parked for the round. Every named row must be active and greedy,
        and the round must fit the context: the JAX session's guards. One
        verify dispatch and one [b, k+1] fetch serve every row; each row
        keeps its longest draft prefix matching its own argmax chain plus
        the bonus token, so rows advance unevenly. Returns {row: emitted
        tokens}."""
        eng = self.engine
        if eng.spec_mode is None or not eng.device_decode:
            raise ValueError("speculative decoding is not enabled on this engine")
        rows = sorted(drafts)
        if not rows:
            return {}
        for r in rows:
            if not self.active[r]:
                raise ValueError(f"row {r} is not active")
            if self.temp[r] > 0.0:
                raise ValueError(f"row {r} is sampled; speculation is greedy-only")
        K = choose_bucket(eng.spec_buckets, max(len(drafts[r]) for r in rows))
        ends = [int(self.pos[r]) + K + 1 for r in rows]
        if max(ends) > self.seq_len:
            raise ValueError(
                f"verify round would overrun seq_len={self.seq_len}: "
                f"max row end {max(ends)} (draft bucket {K})"
            )
        out = verify_row_round(eng, drafts, self.token, self.pos, self.seq_len,
                               grammars=self.grammars)
        for r, emitted in out.items():
            self.pos[r] += len(emitted)
            self.token[r] = emitted[-1]
        return out

    def step(self, n_steps: int) -> np.ndarray:
        """One decode chunk for every slot; returns host tokens [b, n_steps]
        (junk in parked rows). Raises if an active row would run past
        seq_len. A constrained row's chunk starts at its session's state
        and the device advances it from step to step; the session itself
        is advanced by its owner from the returned tokens."""
        eng = self.engine
        ends = [int(self.pos[r]) + 1 + n_steps for r in self.active_rows()]
        if ends and max(ends) > self.seq_len:
            raise ValueError(
                f"decode chunk would overrun seq_len={self.seq_len}: "
                f"max row end {max(ends)} (step n_steps={n_steps})"
            )
        kv_len = eng._kv_bucket(min(max(ends, default=1), self.seq_len))
        t_chunk = time.perf_counter()
        if eng.paged:
            # live rows need private pages over their chunk span before the
            # chunk; parked rows write nothing and need nothing
            eng._ensure_pages(
                (r, int(self.pos[r]), int(self.pos[r]) + n_steps) for r in self.active_rows()
            )
        rows = Rows(self.token, self.pos, self.seeds, self.draws, self.temp, self.topp)
        arm = sampler_arm(self.temp, self.topp)
        # the chunk's dispatch and its one fetch, watched: a wedged card
        # raises StallError into the caller instead of hanging every row
        with eng._guard(f"batch_decode[{n_steps}]", ("batch_decode", n_steps, kv_len, arm)):
            toks, _ = eng._decode_batch(rows, n_steps, kv_len, arm,
                                        gr_state=row_states(self.grammars))
            host = eng._host_fetch(toks)
        # the whole chunk's wall: the batched path's per-program series
        eng.stats.record(f"batch_decode[{n_steps}]", (time.perf_counter() - t_chunk) * 1e6)
        self.pos += n_steps
        # parked rows stay pinned at seq_len
        self.pos[~self.active] = self.seq_len
        self.draws += n_steps
        self.token = host[:, -1].copy()
        return host
