"""The inference engine: model loading, prefill/decode orchestration, timing.

The counterpart of the JAX package's `runtime/engine.py` (the reference's
`RootLlmInference` + `inference()` loop, src/app.cpp:223-303,
src/dllama.cpp:13-151), for one device: `chunk_plan`, `__init__` with its
`batch`, `kv_layout`, `kv_page_size` and `kv_pool_mb` arguments,
`_kv_bucket`, `_new_cache`, `reset`, the paged plumbing (`_pt_operand`,
`_ensure_pages`, `_reclaim_pages`), `forward_tokens`, `prefill` with
`prefill_pipelined` and `_pipelined_chunks` (JAX :1177-1198),
`decode_one`, `_dispatch_prefill_row`, `generate`, `_decode_host`,
`_decode_device`, `generate_batch` and `_decode_batch_chunked`, the
`mesh=` and `execution=` arguments with the JAX engine's mesh rules
(:245-365; parallel/), the decode
ladder: `_kv_buckets`, `warm_plan` and `warmup`, whose programs are CUDA
graphs here (runtime/graphs.py), the radix prefix cache's hooks
(`prefix_cache_mb`, runtime/prefix_cache.py), and speculative decoding
(`speculative`, `draft_k`, `draft_source`; runtime/speculative.py):
`_dispatch_verify`, `_decode_speculative`, `_decode_batch_speculative`
and the verify kinds of the ladder, grammar-constrained decoding
(`grammar`, `_gr_operand`; runtime/grammar.py), the observability surface
(`stats`, `trace`, `_warm`, `_guard`, `_host_fetch`, `last_prefill_timing`;
runtime/telemetry.py and runtime/tracing.py), the `q80_activations`
parity mode, and the device views' hooks (runtime/profiling.py):
`cost_plan` (the JAX engine's full warm ladder, key for key), the
`cost_table` with its lock, `_t_start`, and the `kv_tier` a server
attaches (runtime/kv_tiering.py). Not ported: the `execution="gspmd"`
arm and multihost meshes (ROADMAP A13b).

* The engine runs on the card unless the caller asks for the CPU:
  `device=None` means "cuda" and raises where no GPU is present.
* The library default layout is contiguous, as in the JAX package; the
  paged layout (runtime/paged_kv.py) and the int8 cache (ops/kv_quant.py)
  run on either device.
* Prompt chunks are padded to power-of-two buckets, as in the JAX package,
  so a run takes the same chunk shapes (and numerics arms) there and here.
  Padded tail positions write junk into cache slots past the true length;
  those slots are masked (attention sees t <= pos) or overwritten by the
  next real token before they are read.
* The KV cache lives on the device and is updated in place. On a mesh
  the weights and the cache are cut into shards, one per mesh cell, each
  on its cell's device (parallel/sharding.py MeshParams and MeshKV), and
  every step runs the shard loop (parallel/pipeline.py) through
  `models.transformer.forward`, so every entry point (prefill, decode,
  verify, generate_batch, BatchSession) runs on a mesh as on one device;
  tokens and logits live on the mesh's first device.
* Decode runs in chunks of device steps with one token fetch to the host
  per chunk (`_decode_device`). On the card a chunk replays the CUDA graph
  of one decode step (runtime/graphs.py) n times, and each prefill and
  admission chunk replays the graph of its (kind, chunk size, kv bucket),
  its tokens, position and row in one device operand (`_dispatch_chunk`).
  Setting the attribute `cuda_graphs` to False runs the same chunks
  eagerly, as the JAX engine runs under `jax.disable_jit`: the reference
  the graphs are held to and the other arm of their A/B, not a serving
  option.
  `graph_eligible` names the arms that stay eager.
* With a prefix cache, a prefill from position 0 (`prefill`, `generate`,
  `generate_batch`) matches the cache, splices the hit into every row and
  resumes the chunk plan at the hit's boundary; a completed prefill or
  generation publishes its KV. A contiguous splice copies into the live
  cache tensors, which the decode graphs read; a paged one maps shared
  pages, and the page tables upload before the next step.
* With speculation on (the CLI's default is ngram; library engines default
  to off), greedy `generate` and `generate_batch` decode in verify rounds:
  a draft of up to k tokens, one verify forward over the k + 1 feed (a
  CUDA graph on the card, keyed by its draft bucket and kv bucket), one
  fetch of its greedy ids, and longest-prefix acceptance. A round with no
  draft runs one plain decode chunk instead. Sampled requests and
  host-decode engines never speculate.
* With a grammar arena (`grammar=True`; the CLI's default on one device,
  library engines default to off), `generate(grammar=)`,
  `generate_batch(grammars=)` and `BatchSession` rows decode under a
  `GrammarSession`: every decode step and verify round masks the logits
  at the rows' states, and the decode steps advance the states on the
  device; free rows ride the all-legal FREE state. The arena's table
  lives in one device buffer of its full [S, vocab] shape, made at build
  and copied into in place when the arena's version moves (only the rows
  that changed, from page-locked memory on the card), so the graphs keep
  reading it. A chunk starts at the session's `row_state` (there is
  no lookahead to chain); the session advances from the fetched tokens and
  a terminal state stops the stream like EOS. An sp mesh or host decode
  warns and serves unconstrained, as the JAX engine does.
* Observability as in the JAX engine: `stats` (a StepStats) takes the
  ``prefill_dispatch[size]``, ``prefill_sync``, ``prefill[size]``,
  ``decode[n]`` and ``spec_verify[K]`` series, the spec_*, prefix_* and
  kv_pool_* counters and their gauges; with `trace` set to a request's
  Trace, `generate` emits its ``prefix_match``, ``prefix_splice``,
  ``prefill_chunk``, ``prefill_sync``, ``prefill``, ``decode_chunk`` and
  ``spec_round`` spans. Every chunk's and round's dispatch and fetch, and
  a prefill's chunks and sync, run under the stall watchdog (`_guard`),
  whose first call of a key (a graph capture, a kernel's first build) takes
  the compile threshold. All of it is host work around the dispatches and
  fetches: nothing is recorded inside a graph capture and no sync is added.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
import warnings
import weakref
from dataclasses import dataclass, field
from functools import partial

import numpy as np
import torch

from ..device import resolve_device
from ..formats.mfile import MFileReader
from ..models import config_from_header, forward, init_kv_cache, load_params
from ..models.transformer import moe_grouped
from ..ops.moe import grouped_eligible
from ..ops.rope import build_rope_tables
from ..ops.sampling import SAMPLERS, sampler_arm
from ..parallel.sharding import check_mesh, mesh_kv, mesh_pool, shard_params
from ..tokenizer import Sampler
from .batch_session import (
    Rows, batch_decode_chunk, batch_decode_step, row_seeds, row_states,
)
from .decode import decode_chunk, decode_step, prefill_step, verify_step
from .grammar import GrammarArena, resolve_grammar_enabled
from .graphs import KINDS, DecodeGraphs, GraphKey, StepBuffers
from .paged_kv import (
    DeviceTables, PagePool, copy_page, init_kv_pool, page_pool_bytes, resolve_kv_dtype,
    resolve_kv_layout, resolve_page_size, resolve_pool_pages,
)
from .prefix_cache import PrefixCache
from .speculative import (
    accept_greedy, build_draft_source, note_round, resolve_draft_k, resolve_spec_mode,
    spec_buckets, verify_chunk, verify_row_round,
)
from .telemetry import StepStats, watchdog
from .tracing import to_us


@dataclass
class StepTiming:
    """Wall time of one host-observable unit (a prefill chunk, a decode
    chunk, or one host-loop decode step) over `n_tokens` tokens."""

    eval_us: int = 0
    n_tokens: int = 0


@dataclass
class GenerationResult:
    tokens: list[int] = field(default_factory=list)
    n_prompt_tokens: int = 0
    prefill_us: int = 0
    ttft_us: int = 0
    decode_us: int = 0
    total_us: int = 0
    eval_steps: list[StepTiming] = field(default_factory=list)
    pred_steps: list[StepTiming] = field(default_factory=list)

    @property
    def n_pred_tokens(self) -> int:
        return len(self.tokens) - self.n_prompt_tokens


def _chunk_buckets(max_chunk: int) -> list[int]:
    out = [1]
    while out[-1] < max_chunk:
        out.append(min(out[-1] * 2, max_chunk))
    return out


def chunk_plan(n_tokens: int, pos_start: int, max_chunk: int, seq_len: int):
    """The padded power-of-two prefill ladder: yields (offset, size, n_real)
    triples covering `n_tokens` tokens whose first absolute position is
    `pos_start`. The last chunk's tail past `n_real` is padding. Raises when
    a chunk would write past seq_len."""
    buckets = _chunk_buckets(max_chunk)
    i = 0
    while i < n_tokens:
        remaining = n_tokens - i
        size = next(b for b in buckets if b >= min(remaining, max_chunk))
        size = min(size, seq_len - (pos_start + i))
        if size <= 0:
            raise ValueError(
                f"prefill would write past seq_len ({seq_len}): "
                f"{n_tokens} tokens starting at position {pos_start}"
            )
        n_real = min(size, remaining)
        yield i, size, n_real
        i += n_real


class InferenceEngine:
    """Owns params + cache for one model on one device, or on a mesh:
    `batch` rows, in the contiguous or the paged KV layout."""

    def __init__(
        self,
        model_path: str,
        compute_dtype: str = "bfloat16",
        max_seq_len: int = 0,
        batch: int = 1,
        max_chunk: int = 32,
        cache_dtype: str | None = None,
        device_decode: bool = True,
        decode_chunk_size: int = 64,
        verbose: bool = False,
        device=None,
        kv_layout: str | None = None,  # "contiguous" (per-row seq_len slabs)
        # or "paged" (runtime/paged_kv.py). None = DLT_KV_LAYOUT env, else
        # contiguous for library engines; the CLI defaults to paged
        kv_page_size: int | None = None,  # tokens per page; None = DLT_KV_PAGE
        # env, else 16
        kv_pool_mb: int | None = None,  # the paged pool's device budget; None =
        # DLT_KV_POOL_MB env, else batch x seq_len worth of pages
        mesh=None,  # parallel.make_mesh(tp=, pp=, dp=, ep=, sp=): the model
        # and its cache cut over the mesh (float cache; the paged layout on
        # pure pp x tp only). Replaces `device`: the engine runs on the
        # mesh's devices
        execution: str = "auto",  # the JAX engine's: "auto" or "pipeline"
        # run the shard loop on any mesh of more than one shard ("auto" on
        # a one-shard mesh runs one device); "gspmd", JAX's XLA-partitioned
        # arm, is not ported (ROADMAP A13b)
        prefix_cache_mb: int | None = None,  # the radix prefix cache's
        # device budget (runtime/prefix_cache.py). None = DLT_PREFIX_CACHE_MB
        # env, else 0 = off for library engines; the CLI defaults to 512
        speculative: str | None = None,  # "off" | "ngram" | "model": the
        # draft source of greedy speculative decode (runtime/speculative.py).
        # None = DLT_SPECULATIVE env, else off for library engines; the CLI
        # defaults to ngram
        draft_k: int | None = None,  # max drafted tokens a verify round
        # (bucketed at {4, 8}). None = DLT_DRAFT_K env, else 4
        draft_source=None,  # a DraftSource; required for "model" (a
        # speculative.ModelDraft wrapping the smaller engine)
        grammar: bool | None = None,  # build the grammar arena
        # (runtime/grammar.py) so that requests may decode under a
        # GrammarSession. None = DLT_GRAMMAR env, else off for library
        # engines; the CLI defaults to on. One device, device decode only:
        # on an sp mesh or with host decode the engine warns and serves
        # unconstrained
        q80_activations: bool = False,  # the reference-parity mode: every
        # Q40 matmul input round-tripped through Q80 (ModelConfig); library
        # only, as in the JAX engine: no CLI flag maps to it
        prefill_pipelined: bool | None = None,  # None = DLT_PREFILL_PIPELINE
        # env, else on: chunk k + 1 dispatches while the card runs chunk k;
        # False = the strict serial arm (dispatch, wait for the card,
        # dispatch), the bit-parity reference (JAX :194)
    ):
        if mesh is not None and device is not None:
            raise ValueError("give the engine a mesh or a device, not both")
        self.device = mesh.first if mesh is not None else resolve_device(device)
        if batch < 1:
            raise ValueError(f"batch must be at least 1, got {batch}")
        self.mesh = mesh
        # the JAX engine's mesh rules (:274-299, :345-356)
        needs_pipeline = mesh is not None and (mesh.pp > 1 or mesh.sp > 1 or mesh.ep > 1)
        if execution not in ("auto", "gspmd", "pipeline"):
            raise ValueError(f"unknown execution mode {execution!r}")
        if execution == "gspmd" and needs_pipeline:
            raise ValueError("pp/sp/ep mesh axes require the pipeline path")
        if execution == "pipeline" and mesh is None:
            raise ValueError("execution='pipeline' requires a mesh")
        if execution == "gspmd":
            raise NotImplementedError(
                "execution='gspmd' (XLA-partitioned, use_pallas=False) is not "
                "ported: the shard loop runs every mesh (ROADMAP A13b)")
        # every mesh of more than one shard runs the shard loop: JAX's
        # pipeline arm, and for a dp-only mesh its GSPMD arm's work
        self.use_pipeline = mesh is not None and (mesh.size > 1 or execution == "pipeline")
        if mesh is not None and batch % mesh.dp != 0:
            raise ValueError(
                f"batch ({batch}) must divide over the dp mesh axis ({mesh.dp})"
            )
        if (mesh is not None and resolve_kv_layout(kv_layout) == "paged"
                and (not self.use_pipeline or mesh.dp > 1 or mesh.sp > 1 or mesh.ep > 1)):
            raise ValueError(
                "kv_layout='paged' on meshes requires the pure pp x tp "
                "shard_map pipeline path (dp=sp=ep=1); other topologies "
                "keep the contiguous layout"
            )
        cache_dtype = resolve_kv_dtype(cache_dtype)
        if cache_dtype == "int8" and mesh is not None:
            # as the JAX engine: a perf hint, not a topology contract
            warnings.warn(
                "kv_dtype='int8' is single-chip only; mesh engine falls "
                "back to the default float KV cache",
                stacklevel=2,
            )
            cache_dtype = None
        t0 = time.perf_counter()
        self.reader = MFileReader(model_path, max_seq_len=max_seq_len)
        self.header = self.reader.header
        self.cfg = config_from_header(
            self.header, compute_dtype=compute_dtype, cache_dtype=cache_dtype
        )
        if q80_activations:
            self.cfg = dataclasses.replace(self.cfg, q80_activations=True)
        if self.use_pipeline:
            sp = mesh.sp
            if sp > 1 and (self.cfg.seq_len % sp or (self.cfg.seq_len // sp) % 128):
                raise ValueError(
                    f"seq_len {self.cfg.seq_len} must split over sp={sp} into shards of a "
                    f"multiple of 128 rows (the flash kernels' cache tiles)"
                )
            check_mesh(self.cfg, mesh)
        self.params = load_params(self.reader, self.cfg, device=self.device)
        # the MoE FFN's grouped arm runs K4 (capturable) rather than the f32
        # plain arm, which reads its group sizes back to the host
        lp = self.params.layers
        self._moe_k4 = self.cfg.is_moe and grouped_eligible(
            lp.w1, lp.w3, lp.w2, self.cfg.dtype, self.cfg.q80_activations)
        if self.use_pipeline:
            # cut once, then the whole copy goes (the shards own their
            # storage wherever a cut is not a leading-axis view)
            self.params = shard_params(self.cfg, self.params, mesh)
        # the header's seq_len is already capped at max_seq_len, so the
        # tables cover the cache, not the model's 128k context
        self.rope = build_rope_tables(self.header, device=self.device)
        self.batch = batch
        self.max_chunk = max(1, min(max_chunk, self.cfg.seq_len))
        # device_decode: chunked decode on the device (fast path); False =
        # per-token host loop with the reference's exact RNG stream
        self.device_decode = device_decode
        self.decode_chunk_size = decode_chunk_size
        self.stats = StepStats()
        # the request's tracing context (runtime/tracing.py Trace), set by
        # the caller around a request; None = untraced, and every emission
        # site checks it, so library callers pay nothing
        self.trace = None
        # the keys of the calls this engine has run at least once: a first
        # call captures a CUDA graph or builds a kernel, so its watchdog
        # takes the compile threshold (`_guard`)
        self._warm: set = set()
        # the last prefill's dispatch-vs-wall summary (the JAX engine's)
        self.last_prefill_timing: dict | None = None
        if prefill_pipelined is None:
            prefill_pipelined = os.environ.get("DLT_PREFILL_PIPELINE", "1") != "0"
        self.prefill_pipelined = prefill_pipelined
        self.kv_layout = resolve_kv_layout(kv_layout)
        self.paged = self.kv_layout == "paged"
        self.page_size = resolve_page_size(kv_page_size) if self.paged else None
        self.page_pool = None
        self.prefix_cache = None  # prefix_cache.PrefixCache, built below
        self._tables = None  # the device page tables (paged_kv.DeviceTables)
        if self.paged:
            ps = self.page_size
            page_bytes = page_pool_bytes(self.cfg, 1, ps)
            parity = batch * -(-self.cfg.seq_len // ps)
            # the pool reaches the engine through a weak reference: a bound
            # method would make a cycle that keeps the engine's device
            # memory and CUDA graphs alive until a garbage collection, which
            # may then run inside a later engine's graph capture
            engine = weakref.ref(self)
            self.page_pool = PagePool(
                resolve_pool_pages(kv_pool_mb, page_bytes, parity), ps, batch, self.cfg.seq_len,
                reclaim=lambda: engine()._reclaim_pages(), stats=self.stats,
                page_bytes=page_bytes, kv_dtype=self.cfg.cache_dtype,
            )
            # one table buffer a distinct device the shards run on
            self._tables = {dev: DeviceTables(self.page_pool, dev) for dev in self._devices()}
        # decode chunks replay CUDA graphs on the card (runtime/graphs.py);
        # False runs them eagerly: the reference and the A/B's other arm
        self.cuda_graphs = True
        self._graphs = None  # graphs.DecodeGraphs, made at the first graphed chunk
        self._bufs = None  # graphs.StepBuffers, likewise
        self._gen = None  # the device generator of sampled chunks
        self.last_logits = None  # the last decode step's logits [b, vocab]
        self.warmup_seconds = None
        self.warm_pool_bytes = 0  # the graph pool's bytes when warmup ended
        self.closed = False  # `close` released the device state
        self.cache = self._new_cache()
        # warmup's junk steps neither match nor publish
        self._in_warmup = False
        self.prefix_cache = PrefixCache.build(self, prefix_cache_mb)
        self.last_prefix_hit_tokens = 0  # tokens the last prefill skipped by a hit
        self.draft_source = None
        self.set_speculation(speculative, draft_k, draft_source)
        # rounds, drafts and times of the last speculative generate
        self.last_spec_timing: dict | None = None
        # grammar-constrained decoding: the arena (host table) and its one
        # device buffer, which every decode and verify graph reads
        self.grammar = None
        self._gr_host = self._gr_table = None
        self._gr_spans = self._gr_version = None
        self.last_grammar_state = None  # the last chunk's final device states
        if resolve_grammar_enabled(grammar):
            if mesh is not None or not device_decode:
                warnings.warn(
                    "grammar-constrained decoding is single-chip "
                    "device-decode only; this engine serves unconstrained",
                    stacklevel=2,
                )
            else:
                self.grammar = GrammarArena(self.cfg.vocab_size)
                host = torch.from_numpy(self.grammar.table)
                if self.device.type == "cuda":
                    # page-locked, so an upload is a DMA; the arena writes
                    # into this storage in place
                    host = host.pin_memory()
                    self.grammar.table = host.numpy()
                self._gr_host = host
                self._gr_table = torch.empty(host.shape, dtype=torch.int32, device=self.device)
                self._gr_table.copy_(host)
                self._gr_spans, self._gr_version = self.grammar.spans(), self.grammar.version
        # the engine's lifetime anchor: the duty-cycle gauge
        # (runtime/profiling.py roofline_view) divides busy time by it
        self._t_start = time.perf_counter()
        # the warm-ladder cost table (runtime/profiling.py), built by
        # `cost_table()`: serve()'s post-warmup build or /debug/costs
        self._cost_table = None
        self._cost_table_lock = threading.Lock()
        # the tiered KV store a server attaches (runtime/kv_tiering.py);
        # the HBM ledger reads its host section
        self.kv_tier = None
        self._sync()
        self.load_seconds = time.perf_counter() - t0
        if verbose:
            print(self.memory_report())

    def close(self):
        """Release the engine: its model file, its draft source and its
        device state (weights, KV cache, prefix entries, grammar table,
        static buffers, and the decode graphs with their shared pool), so
        an engine built after it never shares the card with this one's
        memory (the server's rebuild, server/api.py). The host-side surface
        (stats, configuration) stays readable; nothing runs after close.
        Idempotent."""
        self.closed = True
        self.reader.close()
        if self.draft_source is not None:
            self.draft_source.close()
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        self._graphs = self._bufs = self._gen = self._tables = None
        self.params = self.cache = self.rope = self.last_logits = None
        self._gr_table = self._gr_host = self.last_grammar_state = None
        if any(dev.type == "cuda" for dev in self._devices()):
            torch.cuda.empty_cache()

    def _devices(self) -> list:
        """The distinct devices the engine's shards run on, first device
        first."""
        if self.mesh is None or not self.use_pipeline:
            return [self.device]
        return list(dict.fromkeys(self.mesh.devices))

    def set_speculation(self, speculative: str | None, draft_k: int | None = None,
                        draft_source=None) -> None:
        """Set speculation from one setting, as `__init__` takes it (None:
        DLT_SPECULATIVE env, else off): the mode, draft_k, the draft buckets
        it enables and the draft source. A source it replaces is closed.
        The verify kinds' graphs and static buffers are keyed and made by
        feed length at first use, so the engine may switch between modes
        and buckets at any time."""
        old = self.draft_source
        self.spec_mode = resolve_spec_mode(speculative, default="off")
        self.draft_k = resolve_draft_k(draft_k)
        self.spec_buckets = spec_buckets(self.draft_k) if self.spec_mode else ()
        self.draft_source = build_draft_source(self.spec_mode, draft_source)
        if old is not None and old is not self.draft_source:
            old.close()

    @property
    def spec_counters(self) -> dict:
        """The spec_* counters and the ``spec_acceptance_rate`` gauge of
        `stats` (the JAX StepStats names), one dict."""
        out = {k: v for k, v in self.stats.counters_snapshot().items() if k.startswith("spec_")}
        rate = self.stats.gauges_snapshot().get("spec_acceptance_rate")
        if rate is not None:
            out["spec_acceptance_rate"] = rate
        return out

    def _guard(self, label: str, key) -> watchdog:
        """The stall watchdog for one blocking call (JAX :1170): `key`
        names what the call runs, so a first call (a CUDA graph capture, a
        kernel's first build) gets the compile threshold."""
        first = key not in self._warm
        self._warm.add(key)
        return watchdog(label, compiling=first, stats=self.stats)

    def _host_fetch(self, x: torch.Tensor) -> np.ndarray:
        """The one blocking device-to-host fetch of a chunk or a round."""
        return x.cpu().numpy()

    def memory_report(self) -> str:
        def nbytes(x):
            if x is None:
                return 0
            if hasattr(x, "q"):
                return x.q.numel() * x.q.element_size() + x.d.numel() * x.d.element_size()
            return x.numel() * x.element_size()

        p = self.params
        if self.use_pipeline:
            w = sum(nbytes(t) for t in p.tensors())
        else:
            w = sum(nbytes(getattr(p.layers, f)) for f in p.layers.__dataclass_fields__)
            w += nbytes(p.embedding) + nbytes(p.final_norm) + nbytes(p.wcls)
        kv = sum(nbytes(t) for t in self._cache_tensors())
        layout = (
            f"paged: {self.page_pool.n_pages} pages of {self.page_size}"
            if self.paged else "contiguous"
        )
        if self.use_pipeline:
            axes = ", ".join(f"{k} {v}" for k, v in self.mesh.shape.items() if v > 1)
            layout += f", mesh {axes or 'of one shard'}"
            if self.mesh.sp > 1:
                layout += f", sp {self.mesh.sp} shards of {self.cfg.seq_len // self.mesh.sp} rows"
        gr = ""
        if self.grammar is not None:
            gr = (f", grammar arena {nbytes(self._gr_table) / 2**20:.1f} MiB "
                  f"({self.grammar.n_states} states)")
        return (
            f"💿 weights {w / 2**20:.1f} MiB, KV cache {kv / 2**20:.1f} MiB "
            f"({self.cfg.cache_dtype}, {layout}, batch {self.batch}){gr} on {self.device}"
        )

    # -- low-level steps ----------------------------------------------------

    def _kv_bucket(self, end_pos: int) -> int:
        """Attention reads the first `bucket` positions: the smallest
        power-of-two bucket covering `end_pos`, floored at 256, as in the
        JAX package."""
        floor = min(256, self.cfg.seq_len)
        b = floor
        while b < end_pos:
            b *= 2
        return min(b, self.cfg.seq_len)

    def _sync(self):
        for dev in self._devices():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _tokens(self, rows) -> torch.Tensor:
        return torch.tensor(rows, dtype=torch.long).to(self.device, non_blocking=True)

    def _new_cache(self):
        if self.use_pipeline:
            if self.paged:
                return mesh_pool(self.cfg, self.mesh, self.page_pool.n_pages, self.page_size)
            return mesh_kv(self.cfg, self.mesh, self.batch)
        if self.paged:
            return init_kv_pool(self.cfg, self.page_pool.n_pages, self.page_size, self.device)
        return init_kv_cache(self.cfg, batch=self.batch, device=self.device)

    def _cache_tensors(self) -> tuple:
        return self.cache.tensors()

    def reset(self):
        """Fresh independent sequences: contiguous zeroes the cache in place
        (prefix entries hold copies of their own); paged unmaps every row
        (the pool's content is junk that later writes replace before any
        query reads it; pages that prefix entries retain survive). Nothing
        on a closed engine."""
        if self.closed:
            return
        if self.paged:
            self.page_pool.release_all_rows()
            return
        for t in self._cache_tensors():
            t.zero_()

    # -- paged-KV plumbing (runtime/paged_kv.py) -----------------------------

    def _reclaim_pages(self) -> bool:
        """The page pool's pressure valve: evict one LRU unpinned prefix
        entry, giving its pages back, so the allocation can be planned
        again. False: nothing to evict."""
        return self.prefix_cache is not None and self.prefix_cache.evict_one()

    def _splice_all_rows(self, tokens: list, tr=None) -> int:
        """Match `tokens` against the prefix cache and splice a hit into
        every row: paged, by sharing the entry's pages; contiguous, by a
        copy into the live cache. The entry is unpinned whatever happens.
        With a trace `tr`, the ``prefix_match`` and ``prefix_splice`` spans.
        Returns the resume boundary (0 = a miss)."""
        pc = self.prefix_cache
        t_match = time.perf_counter()
        resume, entry = pc.match_for_splice(tokens)
        if tr is not None:
            tr.event("prefix_match", to_us(t_match), int((time.perf_counter() - t_match) * 1e6),
                     ("resume_tokens",), (resume,))
        if entry is None:
            return 0
        t_splice = time.perf_counter()
        try:
            if self.paged:
                pc.share_rows(self, entry, resume)
            else:
                pc.splice_rows(self, entry)
        finally:
            pc.entry_release(entry)
        pc.record_hit(resume)
        if tr is not None:
            tr.event("prefix_splice", to_us(t_splice), int((time.perf_counter() - t_splice) * 1e6),
                     ("tokens",), (resume,))
        return resume

    def _pt_operand(self):
        """The device page tables, uploaded again only when the pool's
        tables changed (its version moved), not once per step, and in
        place: the decode graphs read this one buffer. On a mesh, a dict of
        the buffers by device (the tables are replicated: page ids are
        global); else the one device's."""
        tables = {dev: t.operand(self.page_pool) for dev, t in self._tables.items()}
        return tables if self.use_pipeline else tables[self.device]

    def _gr_operand(self) -> torch.Tensor:
        """The device grammar table: the arena's [S, vocab] int32 table,
        brought up to date only when the arena's version moved (an install
        or an eviction), in place, on the current stream: the decode and
        verify graphs read this one buffer (the JAX engine's :766 uploads a
        new array instead). Only the dirty rows move: the table changes only
        where a span appeared, moved or left (an install writes its span,
        an eviction resets its span to -1), and a span of the same key and
        place holds the same rows, so the spans that differ between the
        last upload and now cover every row that differs."""
        ar = self.grammar
        if self._gr_version != ar.version:
            spans, old = ar.spans(), self._gr_spans
            dirty = {sp for k, sp in spans.items() if old.get(k) != sp}
            dirty |= {sp for k, sp in old.items() if spans.get(k) != sp}
            runs = []  # the dirty spans' rows as disjoint [lo, hi) runs
            for base, size in sorted(dirty):
                if runs and base <= runs[-1][1]:
                    runs[-1][1] = max(runs[-1][1], base + size)
                else:
                    runs.append([base, base + size])
            for lo, hi in runs:
                self._gr_table[lo:hi].copy_(self._gr_host[lo:hi])
            self._gr_spans, self._gr_version = spans, ar.version
        return self._gr_table

    def _gr_operands(self, gr_state, shape) -> tuple:
        """An eager step's grammar operands: (the device table, the states
        `gr_state` (host, global) or FREE zeros of `shape` on the device);
        (None, None) without an arena."""
        if self.grammar is None:
            return None, None
        if gr_state is None:
            return self._gr_operand(), torch.zeros(shape, dtype=torch.int64, device=self.device)
        states = torch.as_tensor(np.asarray(gr_state), dtype=torch.int64).to(self.device)
        return self._gr_operand(), states

    def _ensure_pages(self, spans) -> None:
        """Make every (row, start, end) span privately writable before a
        step writes it; a copy-on-write copy runs here, before the write."""
        for row, start, end in spans:
            for src, dst in self.page_pool.ensure(row, start, end):
                copy_page(self.cache, src, dst)

    def _ensure_pages_all_rows(self, start: int, end: int) -> None:
        self._ensure_pages((r, start, end) for r in range(self.batch))

    def _forward(self, tokens: torch.Tensor, pos, logits_mode="last", kv_len=None):
        """One forward step on this engine's cache and layout, through the
        shard loop on a mesh (JAX :660-690: prefill chunks in pp
        microbatches, `parallel.pipeline.microbatch_count`)."""
        return forward(
            self.cfg, self.params, self.rope, self.cache, tokens, pos,
            logits_mode=logits_mode, kv_len=kv_len,
            page_table=self._pt_operand() if self.paged else None, page_size=self.page_size,
        )

    def forward_tokens(self, tokens: list[int], pos_start: int, logits_mode: str = "last") -> np.ndarray:
        """One forward over `tokens` (unpadded, as the caller shapes them)
        in every row; attention reads the whole cache. Returns host logits."""
        if self.paged:
            self._ensure_pages_all_rows(pos_start, pos_start + len(tokens))
        logits = self._forward(self._tokens([tokens] * self.batch), pos_start, logits_mode)
        return logits.cpu().numpy()

    def prefill(self, tokens: list[int], pos_start: int = 0, on_chunk=None,
                publish: bool = True) -> None:
        """Feed `tokens` through the model in padded power-of-two chunks,
        the same sequence in every row. Only the KV cache matters: the first
        generated token's logits come from the decode step that feeds the
        final prompt token (the reference's shape: prefill covers
        nInputTokens-1 tokens, dllama.cpp:44-85).

        From position 0 a prefix-cache hit is spliced into every row and
        the chunk plan resumes at its boundary (`last_prefix_hit_tokens`);
        with `publish`, the completed prefill publishes its KV.

        On the card each chunk replays the CUDA graph of its ("prefill",
        chunk size, kv bucket) key with the tokens and the position as
        device operands (JAX's jitted prefill, :1302-1320); with
        `cuda_graphs` off, or where `graph_eligible` refuses, it runs
        eagerly at a host position, the same bits. The chunk loop is
        `_pipelined_chunks`: chunk after chunk with no wait between, or the
        serial arm (`prefill_pipelined=False`) waits for the card after
        every chunk.

        Each chunk's dispatch wall lands in `stats` as
        ``prefill_dispatch[size]``, the one sync's in ``prefill_sync``, each
        chunk's share of the whole in ``prefill[size]``; the chunks and the
        sync run under one watchdog keyed on every chunk's (size, kv
        bucket) (JAX :1245-1400). `last_prefill_timing` and the
        ``prefill_dispatch_overlap_pct`` gauge give the dispatch walls' share
        of the prefill's: near 100% where the host's launches, not the
        device, set the pace."""
        self.last_prefix_hit_tokens = 0
        n = len(tokens)
        if n == 0:
            return
        t0 = time.perf_counter()
        pc = self.prefix_cache
        tr = self.trace
        cached = pc is not None and pos_start == 0 and not self._in_warmup
        resume = self._splice_all_rows(tokens, tr) if cached else 0
        self.last_prefix_hit_tokens = resume
        rem = tokens[resume:]
        base = pos_start + resume
        plan = list(chunk_plan(len(rem), base, self.max_chunk, self.cfg.seq_len)) if rem else []
        shapes = [(size, self._kv_bucket(base + i + size)) for i, size, _ in plan]
        if self.paged and plan:
            # the whole span, padded tail included, before the first chunk
            i_last, size_last, _ = plan[-1]
            self._ensure_pages_all_rows(base, base + i_last + size_last)
        dispatch_us = sync_us = 0
        sync_t0 = None
        chunk_log = []  # (dispatch start, dispatch us, size) a chunk
        if plan:
            def prep(idx):
                i, size, n_real = plan[idx]
                chunk = rem[i : i + n_real] + [0] * (size - n_real)
                return self._chunk_operand([chunk] * self.batch, base + i)

            def dispatch(idx, host):
                nonlocal dispatch_us
                size, kvb = shapes[idx]
                td = time.perf_counter()
                self._dispatch_chunk("prefill", host, size, kvb)
                dus = int((time.perf_counter() - td) * 1e6)
                dispatch_us += dus
                self.stats.record(f"prefill_dispatch[{size}]", dus)
                chunk_log.append((td, dus, size))

            with self._guard(f"prefill[{len(rem)}]", ("prefill", tuple(shapes))):
                self._pipelined_chunks(len(plan), prep, dispatch)
                sync_t0 = time.perf_counter()
                self._sync()
        elif resume:
            # a whole-prompt hit: wait for the splice, as the cold path waits
            sync_t0 = time.perf_counter()
            self._sync()
        if sync_t0 is not None:
            sync_us = int((time.perf_counter() - sync_t0) * 1e6)
            self.stats.record("prefill_sync", sync_us)
        total_us = int((time.perf_counter() - t0) * 1e6)
        self.last_prefill_timing = {
            "n_tokens": n,
            "n_chunks": len(plan),
            "prefix_hit_tokens": resume,
            "total_us": total_us,
            "dispatch_us": dispatch_us,
            "sync_us": sync_us,
            "overlap_pct": round(100.0 * dispatch_us / max(total_us, 1), 1),
        }
        self.stats.gauge("prefill_dispatch_overlap_pct", self.last_prefill_timing["overlap_pct"])
        if tr is not None:
            em = tr.bind("prefill_chunk", ("size",))
            if em is not None:
                for td, dus, size in chunk_log:
                    em(to_us(td), dus, size)
            if sync_t0 is not None:
                tr.event("prefill_sync", to_us(sync_t0), sync_us)
        for _, size, n_real in plan:
            dt = total_us * n_real // len(rem)
            self.stats.record(f"prefill[{size}]", dt)
            if on_chunk is not None:
                on_chunk(StepTiming(eval_us=dt, n_tokens=n_real))
        if publish and cached:
            # every row holds the same sequence: publish row 0's
            pc.publish_from_row(self, 0, tokens)

    def decode_one(self, token: int, pos: int) -> np.ndarray:
        """One decode step, the same token in every row; returns host logits
        [batch, vocab]."""
        if self.paged:
            self._ensure_pages_all_rows(pos, pos + 1)
        logits = self._forward(
            self._tokens([[token]] * self.batch), pos, kv_len=self._kv_bucket(pos + 1)
        )
        return logits.cpu().numpy()

    def _dispatch_prefill_row(self, row: int, chunk: list, pos: int, kv_len: int) -> None:
        """One admission-prefill chunk into `row` alone, at b = 1 and a
        scalar position (flash-eligible): on the card the "prefill_row"
        graph of (chunk size, kv bucket), the row a device operand, so one
        graph serves every row; eagerly, paged through the row's table
        slice against the shared pool, contiguous on a view of the row's
        slab (no copy: the writes land in place). A mesh runs the same
        step over the row's shards."""
        if self.paged:
            self._ensure_pages([(row, pos, pos + len(chunk))])
        self._dispatch_chunk("prefill_row", self._chunk_operand([chunk], pos, row), len(chunk),
                             kv_len)

    @staticmethod
    def _chunk_operand(rows: list, pos: int, row: int = 0) -> np.ndarray:
        """A prefill chunk's host operand: its token rows flattened, then
        its position and its batch row, [rows * size + 2] int64 (the
        layout of `StepBuffers.prefill`). Host work only."""
        return np.concatenate([np.asarray(rows, dtype=np.int64).reshape(-1),
                               np.asarray([pos, row], dtype=np.int64)])

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """`host` as a tensor the card can copy from without waiting: page-
        locked on the card, as it is on the CPU."""
        t = torch.from_numpy(host)
        return t.pin_memory() if self.device.type == "cuda" else t

    def _dispatch_chunk(self, kind: str, host: np.ndarray, size: int, kv_len: int):
        """One prefill chunk of `kind` ("prefill": every row; "prefill_row":
        the operand's row alone) from its host operand (`_chunk_operand`):
        the kind's graph of (size, kv bucket) replayed on the static
        operand, filled by one copy; or, where `_graphs_for` gives none,
        the eager forward at the host position (the same bits: K3 takes
        one plan at either). Returns the chunk's last-row logits on the
        device (valid until the next chunk, graphed)."""
        rows = 1 if kind == "prefill_row" else self.batch
        pos, row = int(host[rows * size]), int(host[rows * size + 1])
        graphs = self._graphs_for(kind, size=size)
        if graphs is None:
            toks = self._upload(host[: rows * size].reshape(rows, size)).to(
                self.device, non_blocking=True)
            if kind == "prefill":
                return self._forward(toks, pos, kv_len=kv_len)
            if self.paged:
                pt = self._pt_operand()
                pt = ({dev: t[row : row + 1] for dev, t in pt.items()} if self.use_pipeline
                      else pt[row : row + 1])
                return forward(self.cfg, self.params, self.rope, self.cache, toks, pos,
                               kv_len=kv_len, page_table=pt, page_size=self.page_size)
            from .batch_session import prefill_row

            return prefill_row(self.cfg, self.params, self.rope, self.cache, toks, pos, row,
                               kv_len)
        bufs = self._step_buffers()
        one_row = kind == "prefill_row"
        bufs.prefill(size, one_row).copy_(self._upload(host), non_blocking=True)
        if self.paged:
            if one_row:
                self._tables[self.device].row_operand(self.page_pool, row, bufs.row_table)
            else:
                self._pt_operand()
        step = partial(prefill_step, self.cfg, self.params, self.rope, self.cache, bufs, size,
                       kv_len, self.page_size, one_row)
        graphs.run(self._graph_key(kind, kv_len, "greedy", size), step, 1)
        return graphs.last_logits

    def _pipelined_chunks(self, n_chunks: int, prep, dispatch):
        """The one owner of the prefill chunk loop, `prefill`'s and
        `generate_batch`'s (JAX :1177-1198): `prep(idx)` builds chunk idx's
        host operand, `dispatch(idx, operand)` launches it. Pipelined, the
        host goes on to the next chunk while the card runs this one; serial
        (`prefill_pipelined` False), the card finishes each chunk before the
        next (dispatch, wait, dispatch), the reference arm. JAX's worker
        thread overlaps its next chunk's device_put with the dispatch; the
        port's operand is a few ints of host work, built inline. Both arms
        run the same chunks on the same operands: the same bits. Returns
        the last dispatch's output."""
        out = None
        for idx in range(n_chunks):
            out = dispatch(idx, prep(idx))
            if not self.prefill_pipelined:
                self._sync()
        return out

    # -- generation ---------------------------------------------------------

    def generate(
        self,
        prompt_tokens: list[int],
        steps: int,
        sampler: Sampler | None = None,
        on_token=None,
        stop_fn=None,
        pos_start: int = 0,
        grammar=None,  # a GrammarSession (runtime/grammar.py) constraining
        # this generation; advanced from every emitted token, and a terminal
        # state stops like EOS
    ) -> GenerationResult:
        """The reference `inference()` loop (dllama.cpp:13-151): prefill all
        but the last prompt token, then decode until position `steps` or
        `stop_fn(token)` says stop. Every row runs the same sequence; row
        0's tokens are returned."""
        if not prompt_tokens:
            raise ValueError("prompt tokens required")
        if grammar is not None and self.grammar is None:
            raise ValueError(
                "this engine was built without a grammar arena "
                "(grammar=True / DLT_GRAMMAR=1, single-chip device-decode)"
            )
        if pos_start + len(prompt_tokens) > self.cfg.seq_len:
            raise ValueError("prompt is longer than the sequence length")
        res = GenerationResult(tokens=list(prompt_tokens), n_prompt_tokens=len(prompt_tokens))
        wall0 = time.perf_counter()
        # publish=False: the publish below covers the prompt and the reply
        self.prefill(prompt_tokens[:-1], pos_start, on_chunk=res.eval_steps.append,
                     publish=False)
        res.prefill_us = int((time.perf_counter() - wall0) * 1e6)
        if self.trace is not None:
            self.trace.event("prefill", to_us(wall0), res.prefill_us,
                             ("n_tokens", "prefix_hit_tokens"),
                             (len(prompt_tokens) - 1, self.last_prefix_hit_tokens))
        pos = pos_start + len(prompt_tokens) - 1
        token = prompt_tokens[-1]
        max_pos = min(self.cfg.seq_len, steps)
        if self.device_decode:
            # greedy generations only: under a sampler, accepting drafts
            # would change the random stream
            use_spec = (self.spec_mode is not None and not self._in_warmup
                        and (sampler is None or sampler.temperature == 0.0))
            if use_spec:
                self._decode_speculative(res, token, pos, max_pos, on_token, stop_fn, wall0,
                                         grammar=grammar)
            else:
                self._decode_device(res, token, pos, max_pos, sampler, on_token, stop_fn, wall0,
                                    grammar=grammar)
        else:
            self._decode_host(res, token, pos, max_pos, sampler, on_token, stop_fn, wall0)
        res.total_us = int((time.perf_counter() - wall0) * 1e6)
        res.decode_us = res.total_us - res.prefill_us
        if (self.prefix_cache is not None and pos_start == 0 and not self._in_warmup
                and len(res.tokens) > 1):
            # the conversation's publish, so the next turn of a chat
            # matches its whole history; capped at len - 1, since the last
            # sampled token may never have been fed
            self.prefix_cache.publish_from_row(self, 0, res.tokens, max_len=len(res.tokens) - 1)
        return res

    def _decode_host(self, res, token, pos, max_pos, sampler, on_token, stop_fn, wall0):
        """Per-token host loop: one device round trip per token. Bit-parity
        path (host Sampler = the reference's xorshift* stream)."""
        greedy = sampler is None or sampler.temperature == 0.0
        first = True
        while pos < max_pos:
            t0 = time.perf_counter()
            logits = self.decode_one(token, pos)
            token = int(np.argmax(logits[0])) if greedy else sampler.sample(logits[0].copy())
            res.pred_steps.append(StepTiming(eval_us=int((time.perf_counter() - t0) * 1e6), n_tokens=1))
            if first:
                res.ttft_us = int((time.perf_counter() - wall0) * 1e6)
                first = False
            res.tokens.append(token)
            pos += 1
            if on_token is not None:
                on_token(token)
            if stop_fn is not None and stop_fn(token):
                return

    def _rng(self) -> torch.Generator:
        """The engine's device generator: every sampled chunk draws from it,
        and each sampled decode graph has it registered."""
        if self._gen is None:
            self._gen = torch.Generator(device=self.device)
        return self._gen

    def _generator(self, sampler) -> torch.Generator | None:
        """The device generator for sampled chunks, seeded from the host
        sampler's xorshift* state (a different stream from the reference's;
        the host loop is the bit-parity path)."""
        if sampler is None or sampler.temperature == 0.0:
            return None
        gen = self._rng()
        gen.manual_seed(int(sampler._state) & 0xFFFFFFFFFFFFFFFF)
        return gen

    def _decode_chunk(self, tok_arr, pos: int, n: int, temperature: float = 0.0,
                      topp: float = 0.9, generator=None, gr_state=None):
        """n device decode steps from `tok_arr` [b], every row at pos, on
        this engine's cache and layout: the "decode" graph replayed where
        graphs are on, else the eager loop (through the sp pipeline on a
        mesh, the shard loop). Sampled steps draw from the engine's generator unless given
        another (eager only). With a grammar arena the steps start at the
        host states `gr_state` [b] (None: FREE) and advance them on the
        device. Sets `last_logits` and `last_grammar_state`. Returns
        (tokens [b, n], last_token [b]) on the device."""
        kv_len = self._kv_bucket(pos + n)
        sampler = sampler_arm(temperature, topp)
        if sampler != "greedy" and generator is None:
            generator = self._rng()
        if self.paged:
            self._ensure_pages_all_rows(pos, pos + n)
        graphs = self._graphs_for("decode")
        if graphs is None:
            table, gr = self._gr_operands(gr_state, (self.batch,))
            out = decode_chunk(
                self.cfg, self.params, self.rope, self.cache, tok_arr, pos,
                n_steps=n, temperature=temperature, topp=topp, generator=generator, kv_len=kv_len,
                page_table=self._pt_operand() if self.paged else None, page_size=self.page_size,
                grammar_table=table, grammar_state=gr,
            )
            toks, last, self.last_logits = out[:3]
            self.last_grammar_state = out[3] if gr is not None else None
            return toks, last
        if sampler != "greedy" and generator is not self._gen:
            raise ValueError("a graphed sampled chunk draws from the engine's generator")
        bufs = self._step_buffers()
        self._load_gr_state(bufs.gstate, gr_state)
        bufs.token.copy_(tok_arr)
        bufs.pos.fill_(int(pos))
        bufs.temperature.fill_(float(temperature))
        bufs.topp.fill_(float(topp))
        return self._run_graphed(graphs, "decode", n, kv_len, sampler, generator)

    def _decode_batch(self, rows: Rows, n: int, kv_len: int, sampler: str, gr_state=None):
        """n "batch_decode" steps with per-row positions and sampling from
        `rows`, on the host or the device: the graph replayed where graphs
        are on, else the eager loop. With a grammar arena the rows start at
        the host states `gr_state` [b] (None: FREE). Sets `last_logits` and
        `last_grammar_state`. Returns (tokens [b, n], last token [b]) on
        the device."""
        graphs = self._graphs_for("batch_decode")
        if graphs is None:
            rows = Rows(*(torch.as_tensor(x).to(self.device) for x in rows))
            table, gr = self._gr_operands(gr_state, (self.batch,))
            out = batch_decode_chunk(
                self.cfg, self.params, self.rope, self.cache, rows, n_steps=n,
                kv_len=kv_len, page_table=self._pt_operand() if self.paged else None,
                page_size=self.page_size, sampler=sampler, grammar_table=table, grammar_state=gr,
            )
            toks, self.last_logits = out[:2]
            self.last_grammar_state = out[2] if gr is not None else None
            return toks, toks[:, -1]
        bufs = self._step_buffers()
        self._load_gr_state(bufs.gstate, gr_state)
        bufs.load(rows)
        return self._run_graphed(graphs, "batch_decode", n, kv_len, sampler)

    # -- CUDA graphs of the decode step (runtime/graphs.py) ------------------

    def graph_eligible(self, kind: str, batch: int | None = None, size: int = 1) -> bool:
        """Whether a `kind` step (one of graphs.KINDS) at `batch` rows
        (default: the engine's; a "prefill_row" chunk is one row) and
        `size` tokens a row (the verify feed's length, the prefill chunk's
        size; 1 for decode) is captured as a CUDA graph: a rule of shapes
        and the weights' arms alone, whatever the device. Two arms stay
        eager:
        * the shard loop (a mesh): its step spans several devices (graphs
          of a mesh's steps are ROADMAP 13b);
        * the MoE FFN's f32 plain arm, which `_moe_ffn` takes at batch *
          size * n_active >= n_experts off the bf16 kernel path (f32
          compute, unaligned or dense experts, the q80 parity mode): it
          reads its group sizes back to the host (ops/moe.py). On the bf16
          kernel path the grouped arm is K4, which builds the
          expert-grouped layout on the device and reads nothing back: it
          is captured like any other kernel."""
        if kind not in KINDS:
            raise ValueError(f"unknown graph kind {kind!r}")
        b = 1 if kind == "prefill_row" else self.batch if batch is None else batch
        if self.use_pipeline:
            return False
        return not (self.cfg.is_moe and moe_grouped(self.cfg, b * size) and not self._moe_k4)

    def _graphs_for(self, kind: str, size: int = 1) -> DecodeGraphs | None:
        """The graph cache a `kind` step of `size` tokens a row runs
        through, or None: eager."""
        if not (self.cuda_graphs and self.graph_eligible(kind, size=size)):
            return None
        if self._graphs is None:
            if self.device.type != "cuda":
                return None  # the caller asked for the CPU
            self._graphs = DecodeGraphs(self.device)
        return self._graphs

    def _step_buffers(self) -> StepBuffers:
        if self._bufs is None:
            table = self._tables[self.device].buf if self.paged else None
            self._bufs = StepBuffers(self.batch, self.cfg.seq_len, self.device, table,
                                     self._gr_table)
        return self._bufs

    def _load_gr_state(self, buf: torch.Tensor, gr_state) -> None:
        """A graphed chunk's or round's grammar states into its static
        buffer (`bufs.gstate`, `bufs.gstates[t]`): `gr_state` or FREE zeros
        (every chunk and round sets them, so none inherits another's)."""
        if self.grammar is None:
            return
        if gr_state is None:
            buf.zero_()
        else:
            buf.copy_(torch.as_tensor(np.asarray(gr_state), dtype=torch.int64))

    def _graph_key(self, kind: str, kv_len: int, sampler: str, size: int = 1) -> GraphKey:
        return GraphKey(kind, self.batch, kv_len, self.kv_layout, self.cfg.cache_dtype, sampler,
                        size)

    def _dispatch_verify(self, tokens, pos, kv_len: int, gr_states=None):
        """One speculative verify forward (runtime/speculative.py) over the
        host feed `tokens` [b, t]: logits at every position and their
        greedy argmax. `pos` is a host int (rows aligned: the "verify"
        kind) or a [b] host array (per-row positions, rows at seq_len
        parked: "verify_row"). The position reaches the forward pass as a
        device tensor, eager and graphed alike, so the two agree bit for
        bit; on the card the round replays the kind's CUDA graph of (t, kv
        bucket). On a mesh it runs eagerly, through the shard loop.
        Paged: maps [pos, pos + t) of every live row first.
        With a grammar arena the round always carries the mask: `gr_states`
        [b, t] host global states (None: FREE), so the argmax, bonus
        position included, never picks an illegal token.
        Returns (ids [b, t] int32, logits [b, t, vocab] f32) on the device;
        graphed, both are static outputs, valid until the next round."""
        per_row = np.ndim(pos) != 0
        t = np.shape(tokens)[1]
        if self.paged:
            if per_row:
                self._ensure_pages((r, int(p), int(p) + t) for r, p in enumerate(pos)
                                   if int(p) < self.cfg.seq_len)
            else:
                self._ensure_pages_all_rows(int(pos), int(pos) + t)
        feed = torch.as_tensor(np.asarray(tokens), dtype=torch.long)
        kind = "verify_row" if per_row else "verify"
        pos_host = torch.as_tensor(np.asarray(pos), dtype=torch.long)
        graphs = self._graphs_for(kind, size=t)
        if graphs is None:
            table, gr = self._gr_operands(gr_states, (self.batch, t))
            return verify_chunk(
                self.cfg, self.params, self.rope, self.cache, feed.to(self.device),
                pos_host.to(self.device), kv_len=kv_len,
                page_table=self._pt_operand() if self.paged else None, page_size=self.page_size,
                grammar_table=table, grammar_state=gr,
            )
        bufs = self._step_buffers()
        bufs.verify(t)[0].copy_(feed)
        self._load_gr_state(bufs.gstates.get(t), gr_states)
        if per_row:
            bufs.pos.copy_(pos_host)
        else:
            bufs.pos.fill_(int(pos))
        if self.paged:
            self._pt_operand()
        if self.grammar is not None:
            self._gr_operand()
        step = partial(verify_step, self.cfg, self.params, self.rope, self.cache, bufs, t,
                       kv_len, self.page_size, per_row)
        graphs.run(self._graph_key(kind, kv_len, "greedy", size=t), step, 1)
        return bufs.ids[t], graphs.last_logits

    def _run_graphed(self, graphs: DecodeGraphs, kind: str, n: int, kv_len: int, sampler: str,
                     generator=None):
        """n steps of the `kind` step graph of (kv_len, sampler) on the
        filled static buffers; the page table is uploaded first if it moved.
        Sets `last_logits`. Returns fresh (tokens [b, n], last token [b])."""
        bufs = self._step_buffers()
        if self.paged:
            self._pt_operand()
        if self.grammar is not None:
            self._gr_operand()
        bufs.begin(n)
        args = (self.cfg, self.params, self.rope, self.cache, bufs, kv_len, self.page_size)
        if kind == "decode":
            step = partial(decode_step, *args, sampler=sampler, generator=generator)
        else:
            step = partial(batch_decode_step, *args, sampler=sampler)
        graphs.run(self._graph_key(kind, kv_len, sampler), step, n,
                   generator if sampler != "greedy" and kind == "decode" else None)
        self.last_logits = graphs.last_logits
        self.last_grammar_state = bufs.gstate if self.grammar is not None else None
        return bufs.out[:, :n].clone(), bufs.token.clone()

    def _kv_buckets(self) -> list:
        """Every KV read bound `_kv_bucket` can return: the floor bucket
        doubling up to seq_len (the JAX engine's :534)."""
        out = [min(256, self.cfg.seq_len)]
        while out[-1] < self.cfg.seq_len:
            out.append(min(out[-1] * 2, self.cfg.seq_len))
        return out

    def _chunk_size(self, limit: int, ramp: bool = False) -> int:
        """The decode chunk a dispatch loop runs with `limit` tokens left:
        decode_chunk_size, or the TTFT ramp's short first chunk
        (min(8, decode_chunk_size)) for a streaming consumer, halved until
        it fits: a size that `_halving_sizes` lists for the ladder."""
        n = min(8, self.decode_chunk_size) if ramp else self.decode_chunk_size
        while n > limit:
            n //= 2
        return max(n, 1)

    @staticmethod
    def _halving_sizes(top: int) -> list:
        """The sizes a dispatch shrink loop (`n //= 2` until it fits) can
        produce from `top`, ascending."""
        out = set()
        n = max(1, top)
        while n >= 1:
            out.add(n)
            n //= 2
        return sorted(out)

    def warm_plan(self) -> list:
        """The graph ladder: the (kind, size, kv bucket) triples of the
        graphed kinds (graphs.KINDS: "prefill", "decode", "prefill_row",
        "batch_decode", "verify", "verify_row") of `cost_plan`, the JAX
        engine's `warm_plan` (:551) key for key, in its order: every
        prefill chunk bucket at every kv bucket that covers it, every
        decode chunk size of the dispatch loops (the TTFT ramp's included)
        at every reachable bucket, prefill_row and batch_decode where batch
        > 1 and decode runs on the device, and with speculation on (device
        decode) a verify of k + 1 tokens for each draft bucket k at each
        bucket that covers it, verify_row beside it where batch > 1. The
        prefix copy kinds run eagerly here and are not listed.

        A prefill triple's program is the graph of its (kind, size, kv
        bucket) chunk, replayed once a chunk; a decode triple's is the
        graph of its (kind, kv bucket) step, replayed `size` times, for
        each sampling arm (greedy, full distribution, top-p); a verify
        triple's is the greedy graph of its (kind, size, kv bucket) round.
        `graph_eligible` keeps two arms eager: the shard loop and the MoE
        f32 plain arm."""
        return [key for key in self.cost_plan() if key[0] in KINDS]

    def cost_plan(self) -> list:
        """The JAX engine's `warm_plan` (:551) for the same arguments, key
        for key and in its order: the programs of the cost table
        (runtime/profiling.py), whose coverage it audits. Beside this
        engine's graphed kinds (`warm_plan`: "prefill" at every chunk
        bucket of every kv bucket that covers it, "decode", "prefill_row"
        and "batch_decode" where batch > 1 with device decode, the verify
        kinds) it lists the kinds the port runs eagerly: the contiguous
        prefix cache's "prefix_extract", "prefix_copy" and
        "prefix_copy_row" at each prefix bucket, the paged layout's
        "page_copy", and with a paged prefix cache "page_extract" and
        "page_insert" at each prefix bucket of at least a page."""
        kvbs = self._kv_buckets()
        prefill_sizes = _chunk_buckets(self.max_chunk)
        decode_sizes = sorted(set(self._halving_sizes(self.decode_chunk_size)
                                  + self._halving_sizes(min(8, self.decode_chunk_size))))
        plan = []
        for kvb in kvbs:
            plan += [("prefill", s, kvb) for s in prefill_sizes if s <= kvb]
            plan += [("decode", n, kvb) for n in decode_sizes if n <= kvb]
        if self.batch > 1 and self.device_decode:
            for kvb in kvbs:
                plan += [("prefill_row", s, kvb) for s in prefill_sizes if s <= kvb]
                plan += [("batch_decode", n, kvb) for n in decode_sizes if n <= kvb]
        if self.spec_mode is not None and self.device_decode:
            for kvb in kvbs:
                for k in self.spec_buckets:
                    if k + 1 <= kvb:
                        plan.append(("verify", k + 1, kvb))
                        if self.batch > 1:
                            plan.append(("verify_row", k + 1, kvb))
        if self.prefix_cache is not None and not self.paged:
            for P in self.prefix_cache.buckets:
                plan.append(("prefix_extract", P, P))
                plan.append(("prefix_copy", P, P))
                if self.batch > 1 and self.device_decode:
                    plan.append(("prefix_copy_row", P, P))
        if self.paged:
            plan.append(("page_copy", self.page_size, self.page_size))
            if self.prefix_cache is not None:
                for P in self.prefix_cache.buckets:
                    if P >= self.page_size:
                        plan.append(("page_extract", P, P))
                        plan.append(("page_insert", P, P))
        return plan

    def cost_table(self, build: bool = True):
        """The warm-ladder cost table (runtime/profiling.py CostTable), or
        None. ``build=True`` builds the full `cost_plan` table on first use
        (a census on meta tensors: host work, nothing on the card; a
        partial table is upgraded), once, under a lock, so concurrent
        ``/debug/costs`` handlers pay for it once."""
        if build and (self._cost_table is None or self._cost_table.partial):
            from .profiling import build_cost_table

            with self._cost_table_lock:
                if self._cost_table is None or self._cost_table.partial:
                    self._cost_table = build_cost_table(self)
        return self._cost_table

    def warmup(self) -> dict:
        """Capture every graph `warm_plan` needs, every sampling arm and
        every prefill chunk, before the first request (the JAX engine's
        `warmup` :816 compiles the same ladder), then seal the cache: from here a capture is a ladder hole
        and counts in `recaptures_after_warmup` (ROADMAP A14's sentinel).
        Kinds `graph_eligible` refuses, and an engine on the CPU or with
        `cuda_graphs` off, capture nothing. The warm steps write junk into
        the cache at position 0, which `reset` then drops; they neither
        match nor publish, and the prefix cache is left empty, as the JAX
        engine's warmup leaves it. A verify kind's round is greedy and
        feeds zeros at position 0; "verify_row" has row 0 live and the
        other rows parked at seq_len, the serving shape. A draft source's
        own warmup (a ModelDraft's engine) runs before the seal. On an
        engine with a grammar arena every warm step carries the mask at the
        FREE state, as every later chunk and round does (JAX :1139-1153),
        so constrained requests after warmup capture nothing. The keys of
        the captured ladder join `_warm`, as the JAX warmup's guarded fill
        marks them, so their later calls take the stall threshold. Returns
        `graph_stats()`."""
        t0 = time.perf_counter()
        self._in_warmup = True
        try:
            if self.prefix_cache is not None:
                # first: a junk step at position 0 may land on a page an
                # entry shares
                self.prefix_cache.clear()
            for kind, size, kvb in self.warm_plan():
                if kind in ("prefill", "prefill_row"):
                    # a junk chunk of zeros at position 0 (row 0): its
                    # writes land in the cache (paged: unmapped, so the
                    # sink page), which `reset` drops below
                    graphs = self._graphs_for(kind, size=size)
                    if graphs is None:
                        continue
                    if self._graph_key(kind, kvb, "greedy", size) not in graphs:
                        rows = 1 if kind == "prefill_row" else self.batch
                        self._dispatch_chunk(kind, self._chunk_operand([[0] * size] * rows, 0),
                                             size, kvb)
                    if kind == "prefill_row":
                        self._warm.add((kind, size, kvb))  # BatchSession's guard key
                    continue
                if kind in ("verify", "verify_row"):
                    graphs = self._graphs_for(kind, size=size)
                    if graphs is None:
                        continue
                    if self._graph_key(kind, kvb, "greedy", size) in graphs:
                        self._warm.add((kind, size, kvb))
                        continue
                    pos = 0
                    if kind == "verify_row":
                        pos = np.full((self.batch,), self.cfg.seq_len, np.int64)
                        pos[0] = 0
                    self._dispatch_verify(np.zeros((self.batch, size), np.int64), pos, kvb)
                    self._warm.add((kind, size, kvb))
                    continue
                graphs = self._graphs_for(kind)
                if graphs is None:
                    continue
                for sampler in SAMPLERS:
                    # the watchdog keys the ladder serves (`_guard`)
                    self._warm.add((kind, size, kvb, sampler))
                    if self._graph_key(kind, kvb, sampler) in graphs:
                        continue
                    zeros = [0] * self.batch  # token 0 at position 0, seed 0, draw 0
                    bufs = self._step_buffers()
                    bufs.load(
                        Rows(zeros, zeros, zeros, zeros, [1.0] * self.batch, [0.9] * self.batch))
                    self._load_gr_state(bufs.gstate, None)  # every row FREE
                    self._run_graphed(graphs, kind, 1, kvb, sampler, self._rng())
            if self.draft_source is not None:
                self.draft_source.warmup()
        finally:
            self._in_warmup = False
        self.reset()
        if self._graphs is not None:
            self._graphs.seal()
        self._sync()
        self.warmup_seconds = time.perf_counter() - t0
        stats = self.graph_stats()
        self.warm_pool_bytes = stats["pool_bytes"]
        return stats

    def graph_stats(self, live: bool = True) -> dict:
        """Graphs, captures, recaptures after warmup, the shared pool's
        device bytes and the warmup's seconds. `live=False` gives the pool's
        bytes as warmup left them and asks the card nothing: the view a
        thread other than the engine's may read (the server's `/stats`)."""
        g = self._graphs
        out = g.stats() if g is not None else {"graphs": 0, "captures": 0,
                                               "recaptures_after_warmup": 0, "sealed": False}
        if not live:
            out["pool_bytes"] = self.warm_pool_bytes
        else:
            out["pool_bytes"] = g.pool_bytes() if g is not None else 0
        out["warmup_seconds"] = self.warmup_seconds
        return out

    def _decode_device(self, res, token, pos, max_pos, sampler, on_token, stop_fn, wall0,
                       grammar=None):
        """Chunked on-device decode: n forward+sample steps per chunk, one
        token fetch per chunk; each chunk's last token stays on the device
        and feeds the next chunk. On the card a chunk is n replays of the
        decode step's graph.

        Unlike the JAX engine, there is no one-chunk lookahead. An eager
        dispatch is host work as long as the chunk itself, so dispatching
        chunk i + 1 before reading chunk i held chunk i's tokens back by a
        whole chunk (on an H100 at 1B width, chip_smoke.py's eager CLI run:
        TTFT 2.0 s with the lookahead, 0.29 s without). A graphed chunk's
        dispatch is n graph launches, far shorter than the chunk, so there
        a lookahead could hide the fetch; it is not ported, and its TTFT is
        not measured.

        With a `grammar` session each chunk starts at its `row_state` (the
        JAX engine chains the lookahead chunk from the device's final
        states instead; with no lookahead the two agree for every row not
        done), the session advances from each fetched token, and a
        terminal or finished grammar stops like EOS: the token is
        delivered, the chunk's tail is ordinary overrun.

        Each chunk's dispatch and fetch run under the watchdog; its wall
        lands in `stats` as ``decode[n]`` and, traced, as a ``decode_chunk``
        span through an emitter bound once (JAX :2135, :2166-2173)."""
        temperature = 0.0 if sampler is None else sampler.temperature
        topp = sampler.topp if sampler is not None else 0.9
        arm = sampler_arm(temperature, topp)
        gen = self._generator(sampler)
        tok_arr = self._tokens([token] * self.batch)
        # one tuple append a chunk; None = untraced or unsampled
        em_chunk = self.trace.bind("decode_chunk", ("n",)) if self.trace is not None else None
        first = True
        t_prev = time.perf_counter()
        while pos < max_pos:
            # a streaming consumer gets its first tokens after a short first
            # chunk (the JAX engine's TTFT ramp; the same chunk ladder as there)
            n = self._chunk_size(min(max_pos, self.cfg.seq_len) - pos,
                                 ramp=first and on_token is not None)
            gr = None if grammar is None else np.full((self.batch,), grammar.row_state)
            with self._guard(f"decode[{n}]", ("decode", n, self._kv_bucket(pos + n), arm)):
                toks, tok_arr = self._decode_chunk(tok_arr, pos, n, temperature, topp, gen, gr)
                host_toks = self._host_fetch(toks)[0].tolist()  # the chunk's one fetch
            now = time.perf_counter()
            dt = int((now - t_prev) * 1e6)
            if em_chunk is not None:
                em_chunk(to_us(t_prev), dt, n)
            self.stats.record(f"decode[{n}]", dt)
            res.pred_steps.append(StepTiming(eval_us=dt, n_tokens=n))
            t_prev = now
            if first:
                res.ttft_us = int((now - wall0) * 1e6)
                first = False
            for t in host_toks:
                res.tokens.append(t)
                pos += 1
                if grammar is not None:
                    grammar.advance(t)
                if on_token is not None:
                    on_token(t)
                if stop_fn is not None and stop_fn(t):
                    # tokens past the stop are dropped; the cache overran by
                    # up to the chunk's tail, which a continuation rewrites
                    # before reading
                    return
                if grammar is not None and (grammar.done or grammar.at_terminal):
                    return

    def _decode_speculative(self, res, token, pos, max_pos, on_token, stop_fn, wall0,
                            grammar=None):
        """Greedy speculative decode (runtime/speculative.py), the JAX
        engine's `_decode_speculative`: each round the draft source proposes
        up to k tokens from the live context, one verify round scores
        [token, drafts...] at every position, and the longest draft prefix
        matching the model's argmax chain is accepted with the bonus token.
        A bucket qualifies only where the whole feed fits the context (pos
        + k + 1 <= seq_len): at a device position the contiguous write
        would index past the cache. A round with no draft runs one plain
        decode chunk (the TTFT ramp's first). Tokens past max_pos or a stop
        are discarded. Records `last_spec_timing`: `verify_us` covers the
        rounds from dispatch to their ids on the host; `fetch_us`, inside
        it, the fetches, which wait for the device work the dispatch left
        running before they copy. With a `grammar` session the drafts are
        cut to their legal prefix, the round masks each position at the
        session's walk of the drafts (`verify_states`), and the session
        advances and stops as in `_decode_device`. A round's dispatch and
        fetch, and a fallback chunk's, run under the watchdog; `note_round`,
        the ``spec_verify[K]`` and ``decode[n]`` series and, traced, the
        ``spec_round`` and ``decode_chunk`` spans record them (JAX
        :2215-2309)."""
        ds = self.draft_source
        seq_len = self.cfg.seq_len
        t0 = time.perf_counter()
        rounds = fallback_chunks = drafted = accepted = emitted_total = 0
        draft_us = verify_us = fetch_us = 0
        first = True
        # one tuple append a round or a fallback chunk; None = untraced or
        # unsampled
        tr = self.trace
        em_round = tr.bind("spec_round", ("drafted", "accepted")) if tr is not None else None
        em_chunk = tr.bind("decode_chunk", ("n",)) if tr is not None else None
        while pos < max_pos:
            kmax = 0
            for b in self.spec_buckets:
                if pos + b + 1 <= seq_len:
                    kmax = b
            td = time.perf_counter()
            drafts = ds.draft(list(res.tokens), kmax) if kmax else []
            if grammar is not None and drafts:
                # grammar-hostile drafts collapse to their legal prefix
                # before the round is shaped
                drafts = drafts[: grammar.legal_prefix(drafts)]
            draft_us += int((time.perf_counter() - td) * 1e6)
            tv = time.perf_counter()
            if drafts:
                drafts = [int(t) for t in drafts[:kmax]]
                K = next(b for b in self.spec_buckets if b >= len(drafts))
                size = K + 1
                feed = [int(token)] + drafts + [0] * (K - len(drafts))
                gr_states = None
                if grammar is not None:
                    row = np.zeros((size,), np.int64)
                    vs = grammar.verify_states(drafts)
                    row[: len(vs)] = vs
                    gr_states = np.repeat(row[None, :], self.batch, axis=0)
                kvb = self._kv_bucket(pos + size)
                with self._guard(f"verify[{K}]", ("verify", size, kvb)):
                    ids_dev, _ = self._dispatch_verify(
                        np.asarray([feed] * self.batch, np.int64), pos, kvb, gr_states=gr_states)
                    tf = time.perf_counter()
                    ids = self._host_fetch(ids_dev)[0].tolist()  # the round's one fetch
                    fetch_us += int((time.perf_counter() - tf) * 1e6)
                a = accept_greedy(drafts, ids)
                emitted = drafts[:a] + [ids[a]]
                dt = int((time.perf_counter() - tv) * 1e6)
                verify_us += dt
                rounds += 1
                drafted += len(drafts)
                accepted += a
                note_round(self.stats, len(drafts), a)
                self.stats.record(f"spec_verify[{K}]", dt)
                if em_round is not None:
                    em_round(to_us(tv), dt, len(drafts), a)
            else:
                n = self._chunk_size(min(max_pos, seq_len) - pos,
                                     ramp=first and on_token is not None)
                gr = None if grammar is None else np.full((self.batch,), grammar.row_state)
                with self._guard(f"decode[{n}]", ("decode", n, self._kv_bucket(pos + n), "greedy")):
                    toks, _ = self._decode_chunk(self._tokens([token] * self.batch), pos, n,
                                                 gr_state=gr)
                    emitted = self._host_fetch(toks)[0].tolist()  # the chunk's one fetch
                dt = int((time.perf_counter() - tv) * 1e6)
                fallback_chunks += 1
                self.stats.record(f"decode[{n}]", dt)
                if em_chunk is not None:
                    em_chunk(to_us(tv), dt, n)
            if first:
                res.ttft_us = int((time.perf_counter() - wall0) * 1e6)
                first = False
            res.pred_steps.append(StepTiming(eval_us=dt, n_tokens=min(len(emitted), max_pos - pos)))
            stopped = False
            for t in emitted:
                if pos >= max_pos:
                    break  # a round's surplus past the budget is discarded
                res.tokens.append(t)
                pos += 1
                emitted_total += 1
                if grammar is not None:
                    grammar.advance(t)
                if on_token is not None:
                    on_token(t)
                if stop_fn is not None and stop_fn(t):
                    stopped = True
                    break
                if grammar is not None and (grammar.done or grammar.at_terminal):
                    stopped = True
                    break
            token = res.tokens[-1]
            if stopped:
                break
        self.last_spec_timing = {
            "rounds": rounds,
            "fallback_chunks": fallback_chunks,
            "draft_tokens": drafted,
            "accepted_tokens": accepted,
            "emitted_tokens": emitted_total,
            "acceptance_rate": round(accepted / drafted, 4) if drafted else None,
            "draft_us": draft_us,
            "verify_us": verify_us,
            "fetch_us": fetch_us,
            "total_us": int((time.perf_counter() - t0) * 1e6),
        }

    def generate_batch(
        self,
        prompts: list,
        max_new_tokens,  # int (shared) or list[int] (per row)
        sampler: Sampler | None = None,
        on_token=None,  # on_token(row, token) as tokens arrive
        stop_fn=None,  # stop_fn(row, token) -> bool, per row
        grammars=None,  # per-row GrammarSession list (None entries: free
        # rows riding the FREE state)
    ) -> list:
        """Independent continuations of `batch` different prompts in one
        batch, each row its own sequence with its own positions (the JAX
        engine's `generate_batch` :1641). A constrained row (`grammars`)
        advances its session from each token and stops at a terminal or
        finished grammar, as `generate` does.
        A greedy batch on a speculating device-decode engine decodes in
        per-row verify rounds (`_decode_batch_speculative`). With a prefix
        cache the rows' common prefix is matched and a hit
        spliced into every row; a batch without a hit publishes that
        prefix after its decode.

        Rows are right-padded to a common length for prefill (junk written
        past a row's true length is causally masked until decode overwrites
        it); decode then runs chunks with per-row positions. Each row's
        budget is bounded by its own prompt against seq_len; a finished row
        keeps riding the chunks, its writes past seq_len land nowhere
        (forward's per-row arms) and its tokens are discarded. Returns one
        list of generated tokens per row (a stop token included)."""
        if len(prompts) != self.batch:
            raise ValueError(f"need exactly {self.batch} prompts, got {len(prompts)}")
        if any(len(p) == 0 for p in prompts):
            raise ValueError("empty prompt")
        if grammars is not None:
            if self.grammar is None and any(g is not None for g in grammars):
                raise ValueError(
                    "this engine was built without a grammar arena "
                    "(grammar=True / DLT_GRAMMAR=1, single-chip device-decode)"
                )
            if len(grammars) != self.batch:
                raise ValueError("per-row grammars must match the batch size")
        lens = [len(p) for p in prompts]
        if isinstance(max_new_tokens, int):
            budgets = [max_new_tokens] * self.batch
        else:
            budgets = list(max_new_tokens)
            if len(budgets) != self.batch:
                raise ValueError("per-row budgets must match the batch size")
        for r in range(self.batch):
            if lens[r] + budgets[r] > self.cfg.seq_len:
                raise ValueError(
                    f"row {r}: prompt ({lens[r]}) + budget ({budgets[r]}) "
                    f"exceeds the sequence length ({self.cfg.seq_len})"
                )
        pre_t = max(lens) - 1
        pc = self.prefix_cache
        cached = pc is not None and not self._in_warmup and pre_t > 0
        resume = common_len = 0
        if cached:
            # the rows agree on [0, common_len): splice a hit of that
            # prefix into every row; the rows' tails and the entry's
            # positions past the boundary are rewritten before any read
            p0 = prompts[0]
            while common_len < min(lens) and all(p[common_len] == p0[common_len] for p in prompts):
                common_len += 1
            if common_len:
                resume = self._splice_all_rows(list(p0[: min(common_len, pre_t)]))
        self.last_prefix_hit_tokens = resume
        if pre_t > resume:
            padded = [list(p[:-1]) + [0] * (pre_t - (len(p) - 1)) for p in prompts]
            plan = list(chunk_plan(pre_t - resume, resume, self.max_chunk, self.cfg.seq_len))
            if self.paged:
                i_last, size_last, _ = plan[-1]
                self._ensure_pages_all_rows(resume, resume + i_last + size_last)

            def prep(idx):
                i, size, _ = plan[idx]
                at = resume + i
                rows = [row[at : at + size] + [0] * (size - len(row[at : at + size]))
                        for row in padded]
                return self._chunk_operand(rows, at)

            def dispatch(idx, host):
                i, size, _ = plan[idx]
                return self._dispatch_chunk("prefill", host, size,
                                            self._kv_bucket(resume + i + size))

            # JAX :1737-1764: the shared chunk loop, graphed chunks on the card
            self._pipelined_chunks(len(plan), prep, dispatch)
        out: list[list[int]] = [[] for _ in range(self.batch)]
        if max(budgets) > 0:
            if (self.spec_mode is not None and self.device_decode and not self._in_warmup
                    and (sampler is None or sampler.temperature == 0.0)):
                self._decode_batch_speculative(prompts, lens, budgets, out, on_token, stop_fn,
                                               grammars)
            else:
                self._decode_batch_chunked(prompts, lens, budgets, out, sampler, on_token,
                                           stop_fn, grammars)
        if cached and resume == 0:
            # after the decode, so a failed batch publishes nothing; a hit
            # means the prefix is published already
            pc.publish_from_row(self, 0, list(prompts[0]), max_len=min(common_len, lens[0] - 1))
        return out

    def _decode_batch_chunked(self, prompts, lens, budgets, out, sampler, on_token, stop_fn,
                              grammars=None):
        """generate_batch's chunked decode loop, one token fetch per chunk
        and no lookahead (`_decode_device` gives the reason). Chunks are
        planned against the largest per-row budget; rows cap at their own
        budgets as the tokens are consumed. Each chunk is a "batch_decode"
        chunk, `BatchSession.step`'s: per-row positions, and with a sampler
        per-row streams (`row_coins`) seeded from the sampler's state. A
        chunk starts each constrained row at its session's `row_state` (the
        JAX loop chains the device's final states into its lookahead
        chunk: the same states for every row not done)."""
        temperature = 0.0 if sampler is None else sampler.temperature
        topp = sampler.topp if sampler is not None else 0.9
        base = int(sampler._state) if sampler is not None else 0
        b = self.batch
        rows = Rows(*(torch.tensor(x, dtype=torch.long, device=self.device) for x in (
            [p[-1] for p in prompts], [l - 1 for l in lens], row_seeds(base, b), [0] * b)),
            *(torch.full((b,), x, dtype=torch.float32, device=self.device)
              for x in (temperature, topp)))
        done = [False] * self.batch
        total_needed = max(budgets)
        planned = 0
        while planned < total_needed and not all(done):
            n = self._chunk_size(total_needed - planned, ramp=planned == 0 and on_token is not None)
            live = {r: lens[r] - 1 + planned for r in range(self.batch) if not done[r]}
            host, last = self._batch_chunk(rows, live, n, sampler_arm(temperature, topp),
                                           row_states(grammars))
            rows = rows._replace(token=last, pos=rows.pos + n, draws=rows.draws + n)
            planned += n
            host = host.tolist()  # [b][n]
            for j in range(n):
                for r in range(self.batch):
                    if done[r] or len(out[r]) >= budgets[r]:
                        done[r] = True
                        continue
                    tkn = host[r][j]
                    out[r].append(tkn)
                    g = grammars[r] if grammars is not None else None
                    if g is not None:
                        g.advance(tkn)
                    if on_token is not None:
                        on_token(r, tkn)
                    if ((stop_fn is not None and stop_fn(r, tkn))
                            or (g is not None and (g.done or g.at_terminal))
                            or len(out[r]) >= budgets[r]):
                        done[r] = True

    def _batch_chunk(self, rows: Rows, live: dict, n: int, sampler: str, gr_state=None):
        """One "batch_decode" chunk of n steps from `rows` (`_decode_batch`)
        and its fetch, under the watchdog (JAX :1894, :2019). `live` maps
        each live row to its position: those rows get pages over their
        chunk span, and the read bound covers the furthest position one
        reaches. Finished and parked rows step too; their writes to
        unmapped slots go to the sink page. Returns (host tokens [b, n],
        the last token [b] on the device)."""
        seq_len = self.cfg.seq_len
        if self.paged:
            self._ensure_pages((r, p, p + n) for r, p in live.items() if p < seq_len)
        kvb = self._kv_bucket(min(max(live.values()) + 1 + n, seq_len))
        with self._guard(f"decode_batch[{n}]", ("batch_decode", n, kvb, sampler)):
            toks, last = self._decode_batch(rows, n, kvb, sampler, gr_state)
            return self._host_fetch(toks), last  # the chunk's one fetch

    def _decode_batch_speculative(self, prompts, lens, budgets, out, on_token, stop_fn,
                                  grammars=None):
        """generate_batch's speculative loop (greedy batches), the JAX
        engine's `_decode_batch_speculative`: each round drafts per row from
        the row's own context, then runs one per-row verify round
        (`verify_row_round`; a row without a draft still takes its bonus
        token) or, when no row drafted, one plain "batch_decode" chunk at
        per-row positions, whose tokens past a row's budget or stop are
        discarded. Finished rows park at seq_len. Rows advance unevenly, so
        positions and tokens are host lists. Constrained rows (`grammars`)
        are cut to their legal drafts in the round and advance and stop as
        in `_decode_batch_chunked`."""
        b = self.batch
        seq_len = self.cfg.seq_len
        ds = self.draft_source
        pos = [l - 1 for l in lens]
        token = [int(p[-1]) for p in prompts]
        done = [budgets[r] <= 0 for r in range(b)]
        while not all(done):
            live = [r for r in range(b) if not done[r]]
            drafts = {}
            for r in live:
                # emitted <= drafts + 1 <= the remaining budget, which also
                # keeps the round's writes inside the context
                cap = min(self.spec_buckets[-1], budgets[r] - len(out[r]) - 1)
                d = ds.draft(list(prompts[r]) + out[r], cap) if cap > 0 else []
                drafts[r] = [int(t) for t in d[: max(cap, 0)]]
            if any(drafts.values()):
                emitted = verify_row_round(self, drafts, token, pos, seq_len, grammars=grammars)
            else:
                n = self._chunk_size(max(budgets[r] - len(out[r]) for r in live))
                pv = np.full((b,), seq_len, np.int64)
                tv = np.zeros((b,), np.int64)
                for r in live:
                    pv[r], tv[r] = pos[r], token[r]
                zeros = np.zeros((b,), np.int64)
                host, _ = self._batch_chunk(
                    Rows(tv, pv, zeros, zeros, np.zeros((b,), np.float32),
                         np.full((b,), 0.9, np.float32)), {r: pos[r] for r in live}, n, "greedy",
                    row_states(grammars))
                emitted = {r: host[r].tolist() for r in live}
            for r, toks_r in emitted.items():
                pos[r] += len(toks_r)
                token[r] = toks_r[-1]
                g = grammars[r] if grammars is not None else None
                for t in toks_r:
                    out[r].append(t)
                    if g is not None:
                        g.advance(t)
                    if on_token is not None:
                        on_token(r, t)
                    if ((stop_fn is not None and stop_fn(r, t))
                            or (g is not None and (g.done or g.at_terminal))
                            or len(out[r]) >= budgets[r]):
                        done[r] = True
                        break
