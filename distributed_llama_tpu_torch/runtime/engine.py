"""The inference engine: model loading, prefill/decode orchestration, timing.

The counterpart of the JAX package's `runtime/engine.py` (the reference's
`RootLlmInference` + `inference()` loop, src/app.cpp:223-303,
src/dllama.cpp:13-151), for one device: `chunk_plan`, `__init__` with its
`batch`, `kv_layout`, `kv_page_size` and `kv_pool_mb` arguments,
`_kv_bucket`, `_new_cache`, `reset`, the paged plumbing (`_pt_operand`,
`_ensure_pages`, `_reclaim_pages`), `forward_tokens`, `prefill` (serial),
`decode_one`, `_dispatch_prefill_row`, `generate`, `_decode_host`,
`_decode_device`, `generate_batch` and `_decode_batch_chunked`, the
`mesh=` argument for a sequence-parallel mesh (parallel/), the decode
ladder: `_kv_buckets`, `warm_plan` and `warmup`, whose programs are CUDA
graphs here (runtime/graphs.py), and the radix prefix cache's hooks
(`prefix_cache_mb`, runtime/prefix_cache.py). Not ported: speculation,
grammar, and the other mesh axes (ROADMAP A13).

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
* The KV cache lives on the device and is updated in place. On an sp mesh
  it is a list of per-shard [L, b, seq_len / sp, n_kv, hd] slabs, shard i
  on the mesh's device i, and every step goes through
  parallel/pipeline.py; weights, tokens and logits live on the mesh's
  first device.
* Decode runs in chunks of device steps with one token fetch to the host
  per chunk (`_decode_device`). On the card a chunk replays the CUDA graph
  of one decode step (runtime/graphs.py) n times. Setting the
  attribute `cuda_graphs` to False runs the same chunks eagerly, as the
  JAX engine runs under `jax.disable_jit`: the reference the graphs are
  held to and the other arm of their A/B, not a serving option.
  `graph_eligible` names the arms that stay eager.
* With a prefix cache, a prefill from position 0 (`prefill`, `generate`,
  `generate_batch`) matches the cache, splices the hit into every row and
  resumes the chunk plan at the hit's boundary; a completed prefill or
  generation publishes its KV. A contiguous splice copies into the live
  cache tensors, which the decode graphs read; a paged one maps shared
  pages, and the page tables upload before the next step.
"""

from __future__ import annotations

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
from ..ops.rope import build_rope_tables
from ..ops.sampling import SAMPLERS, sampler_arm
from ..parallel.pipeline import pipeline_decode_chunk, pipeline_forward
from ..tokenizer import Sampler
from .batch_session import Rows, batch_decode_chunk, batch_decode_step, row_seeds
from .decode import decode_chunk, decode_step
from .graphs import KINDS, DecodeGraphs, GraphKey, StepBuffers
from .paged_kv import (
    DeviceTables, PagePool, copy_page, init_kv_pool, page_pool_bytes, resolve_kv_dtype,
    resolve_kv_layout, resolve_page_size, resolve_pool_pages,
)
from .prefix_cache import PrefixCache


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
    """Owns params + cache for one model on one device, or on an sp mesh:
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
        mesh=None,  # parallel.make_mesh(sp=n): the KV cache's sequence axis
        # split over n shards (contiguous layout, float cache). Replaces
        # `device`: the engine runs on the mesh's devices
        prefix_cache_mb: int | None = None,  # the radix prefix cache's
        # device budget (runtime/prefix_cache.py). None = DLT_PREFIX_CACHE_MB
        # env, else 0 = off for library engines; the CLI defaults to 512
    ):
        if mesh is not None and device is not None:
            raise ValueError("give the engine a mesh or a device, not both")
        self.device = mesh.devices[0] if mesh is not None else resolve_device(device)
        if batch < 1:
            raise ValueError(f"batch must be at least 1, got {batch}")
        self.mesh = mesh
        # a mesh with more than one shard runs every step through
        # parallel/pipeline.py, as the JAX engine's sp axis requires its
        # shard_map pipeline (engine.py:274-290)
        self.use_pipeline = mesh is not None and mesh.sp > 1
        if mesh is not None and resolve_kv_layout(kv_layout) == "paged":
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
        if self.use_pipeline:
            sp = mesh.sp
            if self.cfg.seq_len % sp or (self.cfg.seq_len // sp) % 128:
                raise ValueError(
                    f"seq_len {self.cfg.seq_len} must split over sp={sp} into shards of a "
                    f"multiple of 128 rows (the flash kernels' cache tiles)"
                )
        self.params = load_params(self.reader, self.cfg, device=self.device)
        # the header's seq_len is already capped at max_seq_len, so the
        # tables cover the cache, not the model's 128k context
        self.rope = build_rope_tables(self.header, device=self.device)
        self.batch = batch
        self.max_chunk = max(1, min(max_chunk, self.cfg.seq_len))
        # device_decode: chunked decode on the device (fast path); False =
        # per-token host loop with the reference's exact RNG stream
        self.device_decode = device_decode
        self.decode_chunk_size = decode_chunk_size
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
                reclaim=lambda: engine()._reclaim_pages(),
            )
            self._tables = DeviceTables(self.page_pool, self.device)
        # decode chunks replay CUDA graphs on the card (runtime/graphs.py);
        # False runs them eagerly: the reference and the A/B's other arm
        self.cuda_graphs = True
        self._graphs = None  # graphs.DecodeGraphs, made at the first graphed chunk
        self._bufs = None  # graphs.StepBuffers, likewise
        self._gen = None  # the device generator of sampled chunks
        self.last_logits = None  # the last decode step's logits [b, vocab]
        self.warmup_seconds = None
        self.cache = self._new_cache()
        # warmup's junk steps neither match nor publish
        self._in_warmup = False
        self.prefix_cache = PrefixCache.build(self, prefix_cache_mb)
        self.last_prefix_hit_tokens = 0  # tokens the last prefill skipped by a hit
        self._sync()
        self.load_seconds = time.perf_counter() - t0
        if verbose:
            print(self.memory_report())

    def close(self):
        self.reader.close()

    def memory_report(self) -> str:
        def nbytes(x):
            if x is None:
                return 0
            if hasattr(x, "q"):
                return x.q.numel() * x.q.element_size() + x.d.numel() * x.d.element_size()
            return x.numel() * x.element_size()

        p = self.params
        w = sum(nbytes(getattr(p.layers, f)) for f in p.layers.__dataclass_fields__)
        w += nbytes(p.embedding) + nbytes(p.final_norm) + nbytes(p.wcls)
        kv = sum(nbytes(t) for t in self._cache_tensors())
        layout = (
            f"paged: {self.page_pool.n_pages} pages of {self.page_size}"
            if self.paged else "contiguous"
        )
        if self.use_pipeline:
            layout += f", sp {self.mesh.sp} shards of {self.cfg.seq_len // self.mesh.sp} rows"
        return (
            f"💿 weights {w / 2**20:.1f} MiB, KV cache {kv / 2**20:.1f} MiB "
            f"({self.cfg.cache_dtype}, {layout}, batch {self.batch}) on {self.device}"
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
        for dev in set(self.mesh.devices if self.mesh is not None else [self.device]):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _tokens(self, rows) -> torch.Tensor:
        return torch.tensor(rows, dtype=torch.long).to(self.device, non_blocking=True)

    def _new_cache(self):
        if self.paged:
            return init_kv_pool(self.cfg, self.page_pool.n_pages, self.page_size, self.device)
        if self.use_pipeline:
            local_seq = self.cfg.seq_len // self.mesh.sp
            return [init_kv_cache(self.cfg, batch=self.batch, seq_len=local_seq, device=dev)
                    for dev in self.mesh.devices]
        return init_kv_cache(self.cfg, batch=self.batch, device=self.device)

    def _cache_tensors(self) -> tuple:
        shards = self.cache if self.use_pipeline else [self.cache]
        return tuple(t for shard in shards for t in shard.tensors())

    def _refuse_on_mesh(self, what: str) -> None:
        if self.use_pipeline:
            raise NotImplementedError(f"{what} on a mesh is not ported (ROADMAP A13)")

    def reset(self):
        """Fresh independent sequences: contiguous zeroes the cache in place
        (prefix entries hold copies of their own); paged unmaps every row
        (the pool's content is junk that later writes replace before any
        query reads it; pages that prefix entries retain survive)."""
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

    def _splice_all_rows(self, tokens: list) -> int:
        """Match `tokens` against the prefix cache and splice a hit into
        every row: paged, by sharing the entry's pages; contiguous, by a
        copy into the live cache. The entry is unpinned whatever happens.
        Returns the resume boundary (0 = a miss)."""
        pc = self.prefix_cache
        resume, entry = pc.match_for_splice(tokens)
        if entry is None:
            return 0
        try:
            if self.paged:
                pc.share_rows(self, entry, resume)
            else:
                pc.splice_rows(self, entry)
        finally:
            pc.entry_release(entry)
        pc.record_hit(resume)
        return resume

    def _pt_operand(self) -> torch.Tensor:
        """The device page tables, uploaded again only when the pool's
        tables changed (its version moved), not once per step, and in
        place: the decode graphs read this one buffer."""
        return self._tables.operand(self.page_pool)

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
        sp pipeline on a mesh."""
        if self.use_pipeline:
            return pipeline_forward(
                self.cfg, self.mesh, self.params, self.rope, self.cache, tokens, pos,
                logits_mode=logits_mode, kv_len=kv_len,
            )
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
        with `publish`, the completed prefill publishes its KV."""
        self.last_prefix_hit_tokens = 0
        n = len(tokens)
        if n == 0:
            return
        t0 = time.perf_counter()
        pc = self.prefix_cache
        cached = pc is not None and pos_start == 0 and not self._in_warmup
        resume = self._splice_all_rows(tokens) if cached else 0
        self.last_prefix_hit_tokens = resume
        rem = tokens[resume:]
        base = pos_start + resume
        plan = list(chunk_plan(len(rem), base, self.max_chunk, self.cfg.seq_len)) if rem else []
        if self.paged and plan:
            # the whole span, padded tail included, before the first chunk
            i_last, size_last, _ = plan[-1]
            self._ensure_pages_all_rows(base, base + i_last + size_last)
        for i, size, n_real in plan:
            chunk = rem[i : i + n_real] + [0] * (size - n_real)
            self._forward(
                self._tokens([chunk] * self.batch), base + i,
                kv_len=self._kv_bucket(base + i + size),
            )
        self._sync()
        total_us = int((time.perf_counter() - t0) * 1e6)
        if on_chunk is not None:
            for _, _, n_real in plan:
                on_chunk(StepTiming(eval_us=total_us * n_real // len(rem), n_tokens=n_real))
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
        scalar position (flash-eligible): paged, through the row's table
        slice against the shared pool; contiguous, on a view of the row's
        slab (no copy: the writes land in place)."""
        toks = self._tokens([chunk])
        if self.paged:
            self._ensure_pages([(row, pos, pos + len(chunk))])
            forward(
                self.cfg, self.params, self.rope, self.cache, toks, pos, kv_len=kv_len,
                page_table=self._pt_operand()[row : row + 1], page_size=self.page_size,
            )
            return
        from .batch_session import prefill_row

        prefill_row(self.cfg, self.params, self.rope, self.cache, toks, pos, row, kv_len)

    # -- generation ---------------------------------------------------------

    def generate(
        self,
        prompt_tokens: list[int],
        steps: int,
        sampler: Sampler | None = None,
        on_token=None,
        stop_fn=None,
        pos_start: int = 0,
    ) -> GenerationResult:
        """The reference `inference()` loop (dllama.cpp:13-151): prefill all
        but the last prompt token, then decode until position `steps` or
        `stop_fn(token)` says stop. Every row runs the same sequence; row
        0's tokens are returned."""
        if not prompt_tokens:
            raise ValueError("prompt tokens required")
        if pos_start + len(prompt_tokens) > self.cfg.seq_len:
            raise ValueError("prompt is longer than the sequence length")
        res = GenerationResult(tokens=list(prompt_tokens), n_prompt_tokens=len(prompt_tokens))
        wall0 = time.perf_counter()
        # publish=False: the publish below covers the prompt and the reply
        self.prefill(prompt_tokens[:-1], pos_start, on_chunk=res.eval_steps.append,
                     publish=False)
        res.prefill_us = int((time.perf_counter() - wall0) * 1e6)
        pos = pos_start + len(prompt_tokens) - 1
        token = prompt_tokens[-1]
        max_pos = min(self.cfg.seq_len, steps)
        if self.device_decode:
            self._decode_device(res, token, pos, max_pos, sampler, on_token, stop_fn, wall0)
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
                      topp: float = 0.9, generator=None):
        """n device decode steps from `tok_arr` [b], every row at pos, on
        this engine's cache and layout: the "decode" graph replayed where
        graphs are on, else the eager loop (through the sp pipeline on a
        mesh). Sampled steps draw from the engine's generator unless given
        another (eager only). Sets `last_logits`. Returns (tokens [b, n],
        last_token [b]) on the device."""
        kv_len = self._kv_bucket(pos + n)
        sampler = sampler_arm(temperature, topp)
        if sampler != "greedy" and generator is None:
            generator = self._rng()
        if self.use_pipeline:
            toks, last, self.last_logits = pipeline_decode_chunk(
                self.cfg, self.mesh, self.params, self.rope, self.cache, tok_arr, pos,
                n_steps=n, temperature=temperature, topp=topp, generator=generator, kv_len=kv_len,
            )
            return toks, last
        if self.paged:
            self._ensure_pages_all_rows(pos, pos + n)
        graphs = self._graphs_for("decode")
        if graphs is None:
            toks, last, self.last_logits = decode_chunk(
                self.cfg, self.params, self.rope, self.cache, tok_arr, pos,
                n_steps=n, temperature=temperature, topp=topp, generator=generator, kv_len=kv_len,
                page_table=self._pt_operand() if self.paged else None, page_size=self.page_size,
            )
            return toks, last
        if sampler != "greedy" and generator is not self._gen:
            raise ValueError("a graphed sampled chunk draws from the engine's generator")
        bufs = self._step_buffers()
        bufs.token.copy_(tok_arr)
        bufs.pos.fill_(int(pos))
        bufs.temperature.fill_(float(temperature))
        bufs.topp.fill_(float(topp))
        return self._run_graphed(graphs, "decode", n, kv_len, sampler, generator)

    def _decode_batch(self, rows: Rows, n: int, kv_len: int, sampler: str):
        """n "batch_decode" steps with per-row positions and sampling from
        `rows`, on the host or the device: the graph replayed where graphs
        are on, else the eager loop. Sets `last_logits`. Returns (tokens
        [b, n], last token [b]) on the device."""
        graphs = self._graphs_for("batch_decode")
        if graphs is None:
            rows = Rows(*(torch.as_tensor(x).to(self.device) for x in rows))
            toks, self.last_logits = batch_decode_chunk(
                self.cfg, self.params, self.rope, self.cache, rows, n_steps=n,
                kv_len=kv_len, page_table=self._pt_operand() if self.paged else None,
                page_size=self.page_size, sampler=sampler,
            )
            return toks, toks[:, -1]
        self._step_buffers().load(rows)
        return self._run_graphed(graphs, "batch_decode", n, kv_len, sampler)

    # -- CUDA graphs of the decode step (runtime/graphs.py) ------------------

    def graph_eligible(self, kind: str, batch: int | None = None) -> bool:
        """Whether a `kind` decode step ("decode" or "batch_decode") at
        `batch` rows (default: the engine's) is captured as a CUDA graph: a
        rule of shapes alone, whatever the device. Two arms stay eager:
        * the sp pipeline (a mesh): its step spans several devices;
        * the MoE grouped arm, which `_moe_ffn` takes at batch * n_active
          >= n_experts (a Qwen3-30B-A3B batch of 16): `moe_ffn_ragged`
          reads its group sizes back to the host."""
        if kind not in KINDS:
            raise ValueError(f"unknown decode kind {kind!r}")
        b = self.batch if batch is None else batch
        if self.use_pipeline:
            return False
        return not (self.cfg.is_moe and b * self.cfg.n_active_experts >= self.cfg.n_experts)

    def _graphs_for(self, kind: str) -> DecodeGraphs | None:
        """The graph cache a `kind` chunk runs through, or None: eager."""
        if not (self.cuda_graphs and self.graph_eligible(kind)):
            return None
        if self._graphs is None:
            if self.device.type != "cuda":
                return None  # the caller asked for the CPU
            self._graphs = DecodeGraphs(self.device)
        return self._graphs

    def _step_buffers(self) -> StepBuffers:
        if self._bufs is None:
            table = self._tables.buf if self.paged else None
            self._bufs = StepBuffers(self.batch, self.cfg.seq_len, self.device, table)
        return self._bufs

    def _graph_key(self, kind: str, kv_len: int, sampler: str) -> GraphKey:
        return GraphKey(kind, self.batch, kv_len, self.kv_layout, self.cfg.cache_dtype, sampler)

    def _run_graphed(self, graphs: DecodeGraphs, kind: str, n: int, kv_len: int, sampler: str,
                     generator=None):
        """n steps of the `kind` step graph of (kv_len, sampler) on the
        filled static buffers; the page table is uploaded first if it moved.
        Sets `last_logits`. Returns fresh (tokens [b, n], last token [b])."""
        bufs = self._step_buffers()
        if self.paged:
            self._pt_operand()
        bufs.begin(n)
        args = (self.cfg, self.params, self.rope, self.cache, bufs, kv_len, self.page_size)
        if kind == "decode":
            step = partial(decode_step, *args, sampler=sampler, generator=generator)
        else:
            step = partial(batch_decode_step, *args, sampler=sampler)
        graphs.run(self._graph_key(kind, kv_len, sampler), step, n,
                   generator if sampler != "greedy" and kind == "decode" else None)
        self.last_logits = graphs.last_logits
        return bufs.out[:, :n].clone(), bufs.token.clone()

    def _kv_buckets(self) -> list:
        """Every KV read bound `_kv_bucket` can return: the floor bucket
        doubling up to seq_len (the JAX engine's :534)."""
        out = [min(256, self.cfg.seq_len)]
        while out[-1] < self.cfg.seq_len:
            out.append(min(out[-1] * 2, self.cfg.seq_len))
        return out

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
        """The decode ladder: the (kind, size, kv bucket) triples of kinds
        "decode" and "batch_decode" that the JAX engine's `warm_plan` (:551)
        lists for the same arguments, in its order: every decode chunk size
        of the dispatch loops (the TTFT ramp's included) at every reachable
        bucket, and batch_decode where batch > 1 and decode runs on the
        device. Prefill, verify and prefix kinds run eagerly here and are
        not listed.

        A triple's program is the graph of its (kind, kv bucket) step,
        replayed `size` times, for each sampling arm (greedy, full
        distribution, top-p). `graph_eligible` keeps
        two arms eager, by shapes alone: the sp pipeline and the MoE
        grouped arm at batch * n_active >= n_experts."""
        kvbs = self._kv_buckets()
        sizes = sorted(set(self._halving_sizes(self.decode_chunk_size)
                           + self._halving_sizes(min(8, self.decode_chunk_size))))
        plan = [("decode", n, kvb) for kvb in kvbs for n in sizes if n <= kvb]
        if self.batch > 1 and self.device_decode:
            plan += [("batch_decode", n, kvb) for kvb in kvbs for n in sizes if n <= kvb]
        return plan

    def warmup(self) -> dict:
        """Capture every graph `warm_plan` needs, every sampling arm, before
        the first request (the JAX engine's `warmup` :816 compiles the same
        ladder), then seal the cache: from here a capture is a ladder hole
        and counts in `recaptures_after_warmup` (ROADMAP A14's sentinel).
        Kinds `graph_eligible` refuses, and an engine on the CPU or with
        `cuda_graphs` off, capture nothing. The warm steps write junk into
        the cache at position 0, which `reset` then drops; they neither
        match nor publish, and the prefix cache is left empty, as the JAX
        engine's warmup leaves it. Returns `graph_stats()`."""
        t0 = time.perf_counter()
        self._in_warmup = True
        try:
            if self.prefix_cache is not None:
                # first: a junk step at position 0 may land on a page an
                # entry shares
                self.prefix_cache.clear()
            for kind, _, kvb in self.warm_plan():
                graphs = self._graphs_for(kind)
                if graphs is None:
                    continue
                for sampler in SAMPLERS:
                    if self._graph_key(kind, kvb, sampler) in graphs:
                        continue
                    zeros = [0] * self.batch  # token 0 at position 0, seed 0, draw 0
                    self._step_buffers().load(
                        Rows(zeros, zeros, zeros, zeros, [1.0] * self.batch, [0.9] * self.batch))
                    self._run_graphed(graphs, kind, 1, kvb, sampler, self._rng())
        finally:
            self._in_warmup = False
        self.reset()
        if self._graphs is not None:
            self._graphs.seal()
        self._sync()
        self.warmup_seconds = time.perf_counter() - t0
        return self.graph_stats()

    def graph_stats(self) -> dict:
        """Graphs, captures, recaptures after warmup, the shared pool's
        device bytes and the warmup's seconds."""
        g = self._graphs
        out = g.stats() if g is not None else {"graphs": 0, "captures": 0,
                                               "recaptures_after_warmup": 0, "sealed": False}
        out["pool_bytes"] = g.pool_bytes() if g is not None else 0
        out["warmup_seconds"] = self.warmup_seconds
        return out

    def _decode_device(self, res, token, pos, max_pos, sampler, on_token, stop_fn, wall0):
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
        not measured."""
        temperature = 0.0 if sampler is None else sampler.temperature
        topp = sampler.topp if sampler is not None else 0.9
        gen = self._generator(sampler)
        tok_arr = self._tokens([token] * self.batch)
        # a streaming consumer gets its first tokens after a short first
        # chunk (the JAX engine's TTFT ramp; the same chunk ladder as there)
        n = min(8, self.decode_chunk_size) if on_token is not None else self.decode_chunk_size
        first = True
        t_prev = time.perf_counter()
        while pos < max_pos:
            limit = min(max_pos, self.cfg.seq_len) - pos
            # largest power-of-two chunk that fits the remaining budget
            while n > limit:
                n //= 2
            n = max(n, 1)
            toks, tok_arr = self._decode_chunk(tok_arr, pos, n, temperature, topp, gen)
            host_toks = toks[0].tolist()  # the one device-to-host fetch of the chunk
            now = time.perf_counter()
            res.pred_steps.append(StepTiming(eval_us=int((now - t_prev) * 1e6), n_tokens=n))
            t_prev = now
            if first:
                res.ttft_us = int((now - wall0) * 1e6)
                first = False
            for t in host_toks:
                res.tokens.append(t)
                pos += 1
                if on_token is not None:
                    on_token(t)
                if stop_fn is not None and stop_fn(t):
                    # tokens past the stop are dropped; the cache overran by
                    # up to the chunk's tail, which a continuation rewrites
                    # before reading
                    return
            n = self.decode_chunk_size

    def generate_batch(
        self,
        prompts: list,
        max_new_tokens,  # int (shared) or list[int] (per row)
        sampler: Sampler | None = None,
        on_token=None,  # on_token(row, token) as tokens arrive
        stop_fn=None,  # stop_fn(row, token) -> bool, per row
    ) -> list:
        """Independent continuations of `batch` different prompts in one
        batch, each row its own sequence with its own positions (the JAX
        engine's `generate_batch` :1641, without speculation or grammar).
        With a prefix cache the rows' common prefix is matched and a hit
        spliced into every row; a batch without a hit publishes that
        prefix after its decode.

        Rows are right-padded to a common length for prefill (junk written
        past a row's true length is causally masked until decode overwrites
        it); decode then runs chunks with per-row positions. Each row's
        budget is bounded by its own prompt against seq_len; a finished row
        keeps riding the chunks, its writes past seq_len land nowhere
        (forward's per-row arms) and its tokens are discarded. Returns one
        list of generated tokens per row (a stop token included)."""
        self._refuse_on_mesh("generate_batch")
        if len(prompts) != self.batch:
            raise ValueError(f"need exactly {self.batch} prompts, got {len(prompts)}")
        if any(len(p) == 0 for p in prompts):
            raise ValueError("empty prompt")
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
            for i, size, _ in plan:
                at = resume + i
                rows = [row[at : at + size] + [0] * (size - len(row[at : at + size])) for row in padded]
                self._forward(self._tokens(rows), at, kv_len=self._kv_bucket(at + size))
        out: list[list[int]] = [[] for _ in range(self.batch)]
        if max(budgets) > 0:
            self._decode_batch_chunked(prompts, lens, budgets, out, sampler, on_token, stop_fn)
        if cached and resume == 0:
            # after the decode, so a failed batch publishes nothing; a hit
            # means the prefix is published already
            pc.publish_from_row(self, 0, list(prompts[0]), max_len=min(common_len, lens[0] - 1))
        return out

    def _decode_batch_chunked(self, prompts, lens, budgets, out, sampler, on_token, stop_fn):
        """generate_batch's chunked decode loop, one token fetch per chunk
        and no lookahead (`_decode_device` gives the reason). Chunks are
        planned against the largest per-row budget; rows cap at their own
        budgets as the tokens are consumed. Each chunk is a "batch_decode"
        chunk, `BatchSession.step`'s: per-row positions, and with a sampler
        per-row streams (`row_coins`) seeded from the sampler's state."""
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
            ramp = planned == 0 and on_token is not None
            n = min(8, self.decode_chunk_size) if ramp else self.decode_chunk_size
            while n > total_needed - planned:
                n //= 2
            n = max(n, 1)
            # the read bound covers the furthest position a live row reaches
            max_end = min(
                max(lens[r] + planned for r in range(self.batch) if not done[r]) + n,
                self.cfg.seq_len,
            )
            if self.paged:
                # live rows need pages over their chunk span; finished rows
                # keep stepping, and their writes to unmapped slots go to
                # the sink page
                self._ensure_pages(
                    (r, lens[r] - 1 + planned, lens[r] - 1 + planned + n)
                    for r in range(self.batch)
                    if not done[r] and lens[r] - 1 + planned < self.cfg.seq_len
                )
            toks, last = self._decode_batch(rows, n, self._kv_bucket(max_end),
                                            sampler_arm(temperature, topp))
            rows = rows._replace(token=last, pos=rows.pos + n, draws=rows.draws + n)
            planned += n
            host = toks.cpu().tolist()  # [b][n], the chunk's one fetch
            for j in range(n):
                for r in range(self.batch):
                    if done[r] or len(out[r]) >= budgets[r]:
                        done[r] = True
                        continue
                    tkn = host[r][j]
                    out[r].append(tkn)
                    if on_token is not None:
                        on_token(r, tkn)
                    if (stop_fn is not None and stop_fn(r, tkn)) or len(out[r]) >= budgets[r]:
                        done[r] = True
