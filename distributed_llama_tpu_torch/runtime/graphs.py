"""CUDA graphs of the decode step, the verify round and the prefill chunk:
the port's counterpart of the JAX engine's jitted programs.

JAX runs a decode chunk as one `lax.scan` program (`runtime/decode.py:
decode_chunk` :36) and compiles the (kind, chunk size, kv bucket) ladder
ahead of time (`runtime/engine.py:warm_plan` :551, `warmup` :816). PyTorch
launches every op from the host, so here one decode *step* is captured as a
CUDA graph a key and replayed n times a chunk: one `cudaGraphLaunch` a
token in place of some 800 kernel launches at 1B width. (A whole chunk in
one graph would hold ~53k nodes at 1B width and need a graph for every
chunk size as well.)

* A key (`GraphKey`) is (kind, batch, kv bucket, layout, kv dtype,
  sampling arm: greedy, full distribution or top-p, the last alone paying
  for a sort over the vocabulary, size): kind "decode" serves `generate`'s chunks (rows aligned),
  "batch_decode" `BatchSession.step` and `generate_batch` (per-row
  positions and sampling). The chunk size is a replay count, not part of
  the key: `size` is 1 for both. The verify kinds (runtime/speculative.py)
  are one forward over a t = k + 1 token feed, greedy, replayed once a
  round: "verify" with the rows aligned (`generate`), "verify_row" at
  per-row positions with absent rows parked at seq_len (`generate_batch`,
  `BatchSession.spec_step`). Their feed length is a shape, so `size` is t.
  The prefill kinds are one forward over a chunk of `size` tokens at a
  device position, replayed once a chunk (JAX's jitted prefill program,
  engine.py:1302-1320, warmed per (chunk size, kv bucket), :570-588):
  "prefill" with every row at the position (`prefill`, `generate_batch`),
  "prefill_row" one row of the batch alone, the row a device operand too
  (an admission chunk: `BatchSession`, `generate_batch` on no engine here),
  so one graph serves every row.
* Every graph of an engine reads and writes one set of static buffers
  (`StepBuffers`): token, positions, seeds, draw counters, temperature,
  top-p, the step counter, the chunk's output and the engine's page table,
  and for each verify feed length t a [b, t] feed and its greedy ids, for
  each prefill chunk size one operand of the chunk's tokens, its position
  and (an admission's) row, filled by one host-to-device copy as JAX's
  prefill moves its tokens and position in one transfer, and the one-row
  page table an admission chunk reads; on
  an engine with a grammar arena also the arena's device table, the [b]
  grammar states the decode steps mask with and advance, and for each t
  a [b, t] state buffer. The engine copies into the table in place
  (`InferenceEngine._gr_operand`), so a grammar install never recaptures:
  the graphs hold its address. Free rows ride state 0, so the grammar
  adds no key.
  The caller fills them before a chunk; each step writes its token into
  the output at the counter and advances token, positions and counter, so
  n replays run the chunk with no host work between them. A verify step
  reads the feed at the positions and writes the ids; it advances
  nothing.
* The graphs of an engine share one memory pool: they never run at once.
* A key's first use runs the step eagerly on a side stream (a real step of
  the chunk), then captures it there, as torch's recipe asks: every lazy
  set-up (a kernel's shared-memory opt-in and SM count, K5's tickets,
  cuBLAS's workspace) happens outside the capture. A failed capture or
  replay raises; nothing falls back to eager.
* Launch accounting: the kernel wrappers count where they launch, and a
  capture runs them once without launching anything. `run` takes back what
  a capture added and keeps it as the graph's launches; each replay adds
  them again, so the counters count the kernels that ran.
* `captures` counts captures; after `seal()` (engine `warmup`) each
  capture also counts in `recaptures_after_warmup`, the warm ladder's
  hole counter.
* Captures run in torch's default global error mode, where a CUDA call
  from another thread may break the capture. Every capture holds the
  process-wide `CAPTURE_LOCK`; a thread that is not its engine's
  device-owning thread (the tier store's drain, a colocated server's
  device-transport fetch, the profiler's start and stop) touches the card
  only under it, so it never runs beside a capture.

Without `capture` (on the CPU) `run` takes the same steps eagerly on the
same buffers and registers each key once, so the static path and the
ladder's coverage can be checked where no card is.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch

from ..ops import cuda_attention, cuda_q40

#: the kinds of step a graph captures
KINDS = ("decode", "batch_decode", "verify", "verify_row", "prefill", "prefill_row")

#: held by every capture, and by any thread other than an engine's
#: device-owning one while it touches the card (see the module docstring)
CAPTURE_LOCK = threading.RLock()


@dataclass(frozen=True)
class GraphKey:
    kind: str  # one of KINDS
    batch: int
    kv_bucket: int
    layout: str  # "contiguous" | "paged"
    kv_dtype: str
    sampler: str  # ops/sampling.py SAMPLERS ("greedy" for the verify and prefill kinds)
    size: int = 1  # the verify feed's length t, the prefill chunk's size; 1 for decode


class StepBuffers:
    """The static operands and outputs of one engine's decode graphs:
    [b] `token`, `pos`, `seeds` and `draws` (int64), `temperature` and
    `topp` (f32), the fields of `batch_session.Rows`; `step` [1] int64 is
    the chunk's step counter, `out` [b, cap] int64 the chunk's tokens,
    `table` the engine's static page table (or None); `feed[t]` [b, t]
    int64 and `ids[t]` [b, t] int32, a verify round's feed and its greedy
    ids, for each feed length t that `verify(t)` has made;
    `prefill_io[(size, row)]` [rows * size + 2] int64, a prefill chunk's
    tokens (rows = b, or 1 for an admission chunk), its position and its
    batch row, for each chunk `prefill(size, row)` has made (views:
    `prefill_views`); `row_table` [1, max_slots] int32 an admission
    chunk's page table row (paged: `paged_kv.DeviceTables.row_operand`
    copies the row's table into it in place). `grammar` is
    the engine's [S, vocab] int32 grammar table (or None: no mask in any
    step), `gstate` [b] int64 the rows' grammar states and `gstates[t]`
    [b, t] int64 a verify round's per-position states."""

    def __init__(self, batch: int, cap: int, device, table: torch.Tensor | None = None,
                 grammar: torch.Tensor | None = None):
        for name in ("token", "pos", "seeds", "draws"):
            setattr(self, name, torch.zeros((batch,), dtype=torch.int64, device=device))
        self.temperature = torch.zeros((batch,), dtype=torch.float32, device=device)
        self.topp = torch.zeros((batch,), dtype=torch.float32, device=device)
        self.step = torch.zeros((1,), dtype=torch.int64, device=device)
        self.out = torch.zeros((batch, cap), dtype=torch.int64, device=device)
        self.table = table
        self.grammar = grammar
        self.gstate = torch.zeros((batch,), dtype=torch.int64, device=device)
        self.feed: dict = {}
        self.ids: dict = {}
        self.gstates: dict = {}
        self.prefill_io: dict = {}
        self.row_table = None if table is None else torch.full(
            (1, table.shape[1]), -1, dtype=table.dtype, device=device)

    def verify(self, t: int) -> tuple:
        """The feed and ids buffers of a verify round of t tokens a row (and
        its grammar states, where the engine has an arena), made at their
        first use (before the round's graph captures)."""
        if t not in self.feed:
            b, device = self.token.shape[0], self.token.device
            self.feed[t] = torch.zeros((b, t), dtype=torch.int64, device=device)
            self.ids[t] = torch.zeros((b, t), dtype=torch.int32, device=device)
            if self.grammar is not None:
                self.gstates[t] = torch.zeros((b, t), dtype=torch.int64, device=device)
        return self.feed[t], self.ids[t]

    def prefill(self, size: int, row: bool = False) -> torch.Tensor:
        """The operand of a prefill chunk of `size` tokens a row (every row,
        or with `row` one admission row): [rows * size + 2] int64, made at
        its first use (before the chunk's graph captures)."""
        if (size, row) not in self.prefill_io:
            rows = 1 if row else self.token.shape[0]
            self.prefill_io[(size, row)] = torch.zeros(
                (rows * size + 2,), dtype=torch.int64, device=self.token.device)
        return self.prefill_io[(size, row)]

    @staticmethod
    def prefill_views(io: torch.Tensor, size: int) -> tuple:
        """A prefill operand's (tokens [rows, size], position 0-d, row [1])
        views."""
        n = io.shape[0] - 2
        return io[:n].view(n // size, size), io[n], io[n + 1 :]

    def load(self, rows) -> None:
        """Copy each field of `rows` (a `batch_session.Rows` of host or
        device [b] arrays) into its buffer."""
        for name, value in rows._asdict().items():
            getattr(self, name).copy_(torch.as_tensor(value))

    def begin(self, n: int) -> None:
        """Start a chunk of n steps: the counter back to 0."""
        if not 1 <= n <= self.out.shape[1]:
            raise ValueError(f"a chunk takes 1..{self.out.shape[1]} steps, got {n}")
        self.step.zero_()

    def advance(self, token: torch.Tensor) -> None:
        """The end of a step: `token` [b] into the output at the counter,
        then token, positions and counter move on, all on the device."""
        self.out.index_copy_(1, self.step, token[:, None])
        self.token.copy_(token)
        self.pos.add_(1)
        self.step.add_(1)


class LaunchCounts:
    """The launch counters of the counted kernel wrappers (each a function
    with a plain int attribute `launches`)."""

    def __init__(self, kernels):
        self.kernels = tuple(kernels)

    def snapshot(self) -> tuple:
        return tuple(k.launches for k in self.kernels)

    def since(self, before: tuple) -> tuple:
        """What each counter gained since `before`."""
        return tuple(k.launches - b for k, b in zip(self.kernels, before))

    def restore(self, before: tuple) -> None:
        for k, b in zip(self.kernels, before):
            k.launches = b

    def add(self, launches: tuple, times: int = 1) -> None:
        for k, n in zip(self.kernels, launches):
            k.launches += n * times


@dataclass
class _Graph:
    graph: object  # torch.cuda.CUDAGraph; None without capture
    logits: torch.Tensor | None  # the captured step's logits, rewritten by each replay
    launches: tuple  # each counted kernel's launches in one replay


class DecodeGraphs:
    """One engine's decode graphs, by key, in one memory pool."""

    def __init__(self, device, capture: bool = True, kernels=None):
        self.device = torch.device(device)
        self.capture = capture
        self.counts = LaunchCounts(
            kernels if kernels is not None else (*cuda_q40.KERNELS, *cuda_attention.KERNELS))
        self.graphs: dict = {}
        self.captures = 0
        self.recaptures_after_warmup = 0
        self.sealed = False
        self.last_logits = None  # the last step's logits, valid until the next run
        self._pool = torch.cuda.graph_pool_handle() if capture else None
        self._stream = torch.cuda.Stream(self.device) if capture else None

    def __contains__(self, key: GraphKey) -> bool:
        return key in self.graphs

    def seal(self) -> None:
        """The warm ladder is captured: from here a capture is a hole."""
        self.sealed = True

    def run(self, key: GraphKey, step, n: int, generator: torch.Generator | None = None) -> None:
        """n steps of `step` (a callable over the static buffers that
        returns the step's logits): the key's graph replayed n times, or,
        for a new key, one eager step, the capture, and n - 1 replays.
        `generator`: the one a sampled step draws from, registered with its
        graph so that each replay draws fresh numbers."""
        entry = self.graphs.get(key)
        done = 0
        if entry is None:
            entry = self._new(key, step, generator)
            done = 1
        if not self.capture:
            for _ in range(done, n):
                self.last_logits = step()
            return
        for _ in range(done, n):
            entry.graph.replay()
            self.counts.add(entry.launches)
        if n > done:
            self.last_logits = entry.logits

    def _new(self, key: GraphKey, step, generator) -> _Graph:
        self.captures += 1
        if self.sealed:
            self.recaptures_after_warmup += 1
        if not self.capture:
            self.last_logits = step()
            entry = self.graphs[key] = _Graph(None, None, ())
            return entry
        with torch.cuda.device(self.device):
            current, side = torch.cuda.current_stream(), self._stream
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.last_logits = step()  # the chunk's first step, for real
            current.wait_stream(side)
            before = self.counts.snapshot()
            graph = torch.cuda.CUDAGraph()
            if generator is not None:
                graph.register_generator_state(generator)
            try:
                with CAPTURE_LOCK, torch.cuda.graph(graph, pool=self._pool, stream=side):
                    logits = step()
            finally:
                launches = self.counts.since(before)
                self.counts.restore(before)
        entry = self.graphs[key] = _Graph(graph, logits, launches)
        return entry

    def pool_bytes(self) -> int:
        """Device bytes the shared pool holds: the segments that
        `torch.cuda.memory_snapshot` files under its id."""
        if not self.capture:
            return 0
        segments = torch.cuda.memory_snapshot()
        pool = tuple(self._pool)
        return sum(s["total_size"] for s in segments if tuple(s["segment_pool_id"]) == pool)

    def stats(self) -> dict:
        return {
            "graphs": len(self.graphs), "captures": self.captures,
            "recaptures_after_warmup": self.recaptures_after_warmup, "sealed": self.sealed,
            "launches_per_replay": {
                f"{key.kind}/kv{key.kv_bucket}/{key.sampler}"
                + (f"/t{key.size}" if key.size != 1 else ""):
                sum(g.launches) for key, g in list(self.graphs.items())},
        }
