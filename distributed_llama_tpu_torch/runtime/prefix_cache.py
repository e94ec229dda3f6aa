"""Radix prefix cache: cross-request KV reuse on the device.

The counterpart of the JAX package's `runtime/prefix_cache.py`: a radix
tree (RadixAttention, SGLang) over token chains whose published nodes own
KV slices, refcounted and LRU-evicted under a byte budget. A new request
longest-prefix-matches the tree; the match is rounded down to a chunk
boundary B; the cached KV is spliced into the request's row(s); chunked
prefill resumes from B. Completed prefills publish their prompt's KV back,
and completed generations the whole conversation, so the next turn of a
chat resumes near its end.

Ported: `PREFIX_MIN_TOKENS`, `prefix_buckets`, `bucket_down`,
`resolve_budget_mb` (with ``DLT_PREFIX_CACHE_MB``), `PrefixEntry`, `_Node`
and `PrefixCache` with `build`, matching, pinning, splicing, publishing and
eviction. The JAX package's three jitted copy programs (:117-174) are
in-place torch functions here on the engine's `KVCache` tensors, which the
decode graphs (runtime/graphs.py) read: a splice writes into them, it never
rebinds them.

* Contiguous engines store a clone of the publishing row's ``[L, P, kv,
  hd]`` slice and copy it into the live cache on a hit.
* Paged engines store the publishing row's page ids, retained in the
  engine's `PagePool`: a publish and a hit move no KV bytes, and a hit maps
  the pages into the row's table (`PagePool.share`). A shared page is
  never written: `PagePool.ensure` copies it first (`copy_page` copies the
  int8 arm's scales with it).

Why a hit equals a cold run: a published slice of length P holds, at every
position below P, the KV that a cold prefill wrote there (it was copied out
of a completed prefill or decode, never recomputed); positions in [B, P)
may belong to a diverged sibling, but the resumed prefill rewrites every
position >= B before a query at >= B reads it, as padded prefill tails
already rely on.

Observability as in the JAX package: the counters go to the engine's
StepStats (`stats=`, runtime/telemetry.py) under the JAX names, with the
``prefix_cache_bytes`` / ``prefix_cache_entries`` gauges, and a hit and a
publish each emit their engine-level `global_event` (``prefix_hit``,
``prefix_publish``; runtime/tracing.py). `counters` keeps the same
counts in a dict of its own, in step with StepStats, for readers of the
cache alone.

The disaggregation and tiering paths (runtime/kv_transport.py,
runtime/kv_tiering.py, server/disagg.py) use `match_pinned`, `pin_entry`
and `insert_external` (with its ``prefix_insert_external`` event), which
lands a slice computed elsewhere as an ordinary entry: contiguous engines
build one device pair from the base entry's leading span and the shipped
segments (`_materialize_contiguous`), paged engines scatter the segments
into freshly allocated pool pages in place and retain the base's pages
(`_materialize_paged`). With a tier store attached (`tier`), `_remove`
hands each victim to its `capture_demotion` before the victim's pages go
back to the pool; `clear` (engine recovery) bypasses it.

On a mesh (JAX :257-272, `pp_prefix_sharding`) the cache is on unless sp > 1.
A contiguous entry holds one slice per (pp, tp) shard, in that shard's
layout and on its device, as a dict {(p, t): [L/pp, P, kv/tp, hd]}, so a
splice copies shard to shard; a paged entry retains pages, whose ids are
global.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import torch

from .tracing import global_event

#: prefixes shorter than this are not worth a splice; also the smallest
#: published bucket
PREFIX_MIN_TOKENS = 16

#: the counters the cache keeps, under the JAX package's StepStats names
COUNTERS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens", "prefix_inserts",
            "prefix_evictions", "prefix_publish_skipped")


def prefix_buckets(seq_len: int) -> list:
    """Power-of-two published-slice lengths: PREFIX_MIN_TOKENS up to
    seq_len // 2 (a prefix past half the context leaves no room to decode)."""
    out = []
    b = PREFIX_MIN_TOKENS
    while b <= seq_len // 2:
        out.append(b)
        b *= 2
    return out


def bucket_down(n: int, seq_len: int) -> int:
    """Largest prefix bucket <= n (0 = below the publishable floor)."""
    best = 0
    for b in prefix_buckets(seq_len):
        if b <= n:
            best = b
    return best


def resolve_budget_mb(explicit, default_mb: int) -> int:
    """The one resolver of the prefix-cache budget: an explicit value wins;
    otherwise ``DLT_PREFIX_CACHE_MB``; an unset or unparsable env value
    means `default_mb` (library engines pass 0 = off, the CLI 512)."""
    if explicit is not None:
        return int(explicit)
    raw = os.environ.get("DLT_PREFIX_CACHE_MB")
    if raw is None or raw == "":
        return default_mb
    try:
        return int(raw)
    except ValueError:
        return default_mb


# -- the copies (JAX's jitted programs), in place on the live cache ----------


def _mesh_cells(cache, row=None):
    """(shard, (p, t), local row) of a mesh cache's shards: every shard, or
    those of `row`'s dp group."""
    for (d, p, t, _), shard in cache.shards.items():
        bl = shard.k.shape[1]
        if row is None or row // bl == d:
            yield shard, (p, t), None if row is None else row % bl


def copy_prefix_into_rows(cache, k_seg, v_seg) -> None:
    """Copy a cached slice [L, P, kv, hd] into positions [0, P) of every
    row of a contiguous cache, in place (a mesh's: shard by shard)."""
    if getattr(cache, "mesh", None) is not None:
        for shard, key, _ in _mesh_cells(cache):
            copy_prefix_into_rows(shard, k_seg[key], v_seg[key])
        return
    P = k_seg.shape[1]
    cache.k[:, :, :P].copy_(k_seg[:, None])
    cache.v[:, :, :P].copy_(v_seg[:, None])


def copy_prefix_into_row(cache, k_seg, v_seg, row: int) -> None:
    """Copy a cached slice [L, P, kv, hd] into positions [0, P) of one row,
    in place (a mesh's: into the row's dp group, shard by shard)."""
    if getattr(cache, "mesh", None) is not None:
        for shard, key, local in _mesh_cells(cache, row):
            copy_prefix_into_row(shard, k_seg[key], v_seg[key], local)
        return
    P = k_seg.shape[1]
    cache.k[:, row, :P].copy_(k_seg)
    cache.v[:, row, :P].copy_(v_seg)


def extract_prefix_from_row(cache, row: int, length: int) -> tuple:
    """A copy of positions [0, length) of one row: the [L, length, kv, hd]
    pair a contiguous entry stores (a mesh's: a {(p, t): slice} dict of
    each shard's block)."""
    if getattr(cache, "mesh", None) is not None:
        parts = {key: extract_prefix_from_row(shard, local, length)
                 for shard, key, local in _mesh_cells(cache, row)}
        return {k: kv[0] for k, kv in parts.items()}, {k: kv[1] for k, kv in parts.items()}
    return cache.k[:, row, :length].clone(), cache.v[:, row, :length].clone()


def global_slice(cache, x):
    """A contiguous entry's slice as one [L, P, kv, hd] tensor: a mesh
    entry's (pp, tp) blocks joined on the mesh's first device (what the
    wire codec and the tiers take), else `x` itself."""
    if not isinstance(x, dict):
        return x
    from ..parallel.sharding import join_global

    return join_global(x, cache.mesh, 0, 2)


def _nbytes(x) -> int:
    parts = x.values() if isinstance(x, dict) else (x,)
    return sum(t.numel() * t.element_size() for t in parts)


# -- host-side structure ------------------------------------------------------


@dataclass
class PrefixEntry:
    """One published slice: `tokens` (a bucket-length tuple) is the tree's
    key; `refs` pins the entry against eviction between match and splice.
    Contiguous engines store the slice's tensors in k/v; paged engines the
    physical page ids in `pages`, retained in the engine's PagePool."""

    tokens: tuple
    k: object
    v: object
    nbytes: int
    refs: int = 0
    last_used: int = 0
    pages: tuple = ()

    @property
    def length(self) -> int:
        return len(self.tokens)


class _Node:
    """Radix node: `edge` is the token run from the parent (path
    compression), children keyed by first token, `entry` set when a
    published slice ends exactly here."""

    __slots__ = ("edge", "children", "entry")

    def __init__(self, edge=()):
        self.edge = tuple(edge)
        self.children: dict = {}
        self.entry = None


class PrefixCache:
    """The engine-wide radix prefix cache (see the module docstring)."""

    def __init__(self, budget_bytes: int, seq_len: int, max_chunk: int, page_pool=None,
                 stats=None):
        self.budget_bytes = int(budget_bytes)
        self.stats = stats  # the engine's StepStats, or None
        self.seq_len = seq_len
        self.max_chunk = max_chunk
        self.page_pool = page_pool  # paged engines: entries share refcounted pages
        self.paged = page_pool is not None
        self.buckets = prefix_buckets(seq_len)
        self.counters = dict.fromkeys(COUNTERS, 0)
        self._root = _Node()
        self._entries: dict = {}  # token tuple -> PrefixEntry
        self._bytes = 0
        self._clock = 0
        self._lock = threading.Lock()
        # the tiered KV store (runtime/kv_tiering.py) a victim demotes to,
        # or None: eviction deletes
        self.tier = None

    @classmethod
    def build(cls, engine, prefix_cache_mb=None):
        """The engine's factory: the budget (argument > DLT_PREFIX_CACHE_MB
        env > 0 = off) and the JAX package's three gates. Returns None when
        the cache is off: on a mesh with sp > 1 (it shards the sequence
        axis a slice would splice into), for contiguous int8 (the copies would
        need scale twins; paged int8 shares pages and needs none), and when
        the context is too short for a publishable prefix."""
        prefix_cache_mb = resolve_budget_mb(prefix_cache_mb, default_mb=0)
        if prefix_cache_mb <= 0:
            return None
        if engine.mesh is not None and engine.mesh.sp > 1:
            return None
        if engine.cfg.kv_quantized and not engine.paged:
            return None
        if not prefix_buckets(engine.cfg.seq_len):
            return None
        return cls(
            prefix_cache_mb * 1024 * 1024,
            seq_len=engine.cfg.seq_len,
            max_chunk=engine.max_chunk,
            page_pool=engine.page_pool if engine.paged else None,
            stats=engine.stats,
        )

    # -- observability -----------------------------------------------------

    def _incr(self, name, n=1):
        self.counters[name] += n
        if self.stats is not None:
            self.stats.incr(name, n)

    def _gauges(self):
        if self.stats is not None:
            self.stats.gauge("prefix_cache_bytes", self._bytes)
            self.stats.gauge("prefix_cache_entries", len(self._entries))

    @property
    def n_entries(self) -> int:
        return len(self._entries)

    @property
    def total_bytes(self) -> int:
        """Device bytes the published entries hold."""
        return self._bytes

    def stats_snapshot(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "budget_bytes": self.budget_bytes,
                "buckets": list(self.buckets),
                "pinned": sum(1 for e in self._entries.values() if e.refs > 0),
            }

    # -- matching ----------------------------------------------------------

    def resume_boundary(self, m: int) -> int:
        """Round a matched length down to a chunk boundary: a multiple of
        max_chunk, or below one chunk the largest power of two, so the
        resumed prefill walks the chunk ladder a cold prefill walks."""
        if m >= self.max_chunk:
            return (m // self.max_chunk) * self.max_chunk
        b = 0
        p = 1
        while p <= m:
            b = p
            p *= 2
        return b

    def _walk(self, tokens):
        """(m, subtree_node, best_on_path): m = longest shared prefix with
        any published chain; subtree_node roots the entries sharing exactly
        m tokens; best_on_path = deepest entry whose whole chain matched."""
        node = self._root
        t = tuple(tokens)
        m = 0
        best = None
        while True:
            if node.entry is not None:
                best = node.entry
            if m == len(t):
                return m, node, best
            child = node.children.get(t[m])
            if child is None:
                return m, None, best
            e = child.edge
            lim = min(len(e), len(t) - m)
            lcp = 0
            while lcp < lim and e[lcp] == t[m + lcp]:
                lcp += 1
            m += lcp
            if lcp == len(e):
                node = child
                continue
            # diverged (or ran out of tokens) mid-edge: everything below
            # `child` still shares exactly the first m tokens
            return m, child, best

    @staticmethod
    def _first_entry(node):
        if node is None:
            return None
        stack = [node]
        while stack:
            n = stack.pop()
            if n.entry is not None:
                return n.entry
            stack.extend(n.children.values())
        return None

    def match(self, tokens):
        """Longest-prefix match: (covered, entry), `covered` the leading
        tokens of `tokens` whose KV the entry holds; (0, None) on a miss.
        An entry deeper than the divergence is still usable: its positions
        past `covered` are rewritten before any query reads them."""
        with self._lock:
            m, subtree, best = self._walk(tokens)
            entry = self._first_entry(subtree)
            if entry is not None:
                return m, entry
            if best is not None:
                return min(m, best.length), best
            return 0, None

    def match_for_splice(self, tokens):
        """The admission lookup: (resume boundary, entry) with the entry
        pinned (refs + 1) until the caller's `entry_release`. A miss (a
        boundary below the publishable floor included) is counted here; a
        hit is counted by `record_hit` when the splice runs."""
        covered, entry = self.match(tokens)
        B = self.resume_boundary(min(covered, len(tokens)))
        if self.paged and entry is not None:
            # sharing maps whole pages read-only: floor the boundary to a
            # page and cap it at the entry's own coverage
            ps = self.page_pool.page_size
            B = (min(B, entry.length) // ps) * ps
        if entry is None or B < PREFIX_MIN_TOKENS:
            self._incr("prefix_misses")
            return 0, None
        with self._lock:
            entry.refs += 1
            self._clock += 1
            entry.last_used = self._clock
        return B, entry

    def pin_entry(self, entry) -> None:
        """Pin an entry (refs + 1) against eviction; release with
        `entry_release`. Prefer `match_pinned`, which pins under the lock
        hold that found the entry."""
        with self._lock:
            entry.refs += 1
            self._clock += 1
            entry.last_used = self._clock

    def match_pinned(self, tokens):
        """Longest-prefix match with the entry pinned under the same lock
        hold that found it: the merge base of a disaggregated or tier fetch,
        whose pages pool pressure must not recycle before the insert that
        names them. Returns (covered, entry or None); the caller releases a
        non-None entry exactly once."""
        with self._lock:
            m, subtree, best = self._walk(tokens)
            entry = self._first_entry(subtree)
            covered = m
            if entry is None and best is not None:
                covered, entry = min(m, best.length), best
            if entry is None:
                return 0, None
            entry.refs += 1
            self._clock += 1
            entry.last_used = self._clock
            return covered, entry

    def record_hit(self, resume: int) -> None:
        """Count one splice that ran (`resume` = prefill tokens skipped),
        with an engine-level trace event (the request's own prefix_match /
        prefix_splice spans carry the per-request view)."""
        self._incr("prefix_hits")
        self._incr("prefix_hit_tokens", resume)
        global_event("prefix_hit", keys=("tokens",), vals=(resume,))

    def entry_release(self, entry) -> None:
        with self._lock:
            entry.refs = max(0, entry.refs - 1)

    # -- splicing ----------------------------------------------------------

    def splice_rows(self, engine, entry) -> None:
        """Copy the entry's slice into every row of the live cache."""
        copy_prefix_into_rows(engine.cache, entry.k, entry.v)

    def splice_row(self, engine, entry, row: int) -> None:
        """Copy the entry's slice into one row (BatchSession admissions)."""
        copy_prefix_into_row(engine.cache, entry.k, entry.v, row)

    def share_row(self, engine, entry, row: int, resume: int) -> None:
        """The paged splice: map the entry's pages covering [0, resume)
        into `row`'s table with their refcounts bumped. No KV moves; the
        pool's version moves, so the next step uploads the tables."""
        self.page_pool.share(row, entry.pages[: resume // self.page_pool.page_size])

    def share_rows(self, engine, entry, resume: int) -> None:
        """The paged splice into every row."""
        for row in range(engine.batch):
            self.share_row(engine, entry, row, resume)

    # -- publishing --------------------------------------------------------

    def publish_from_row(self, engine, row: int, tokens, max_len=None) -> bool:
        """Publish the KV of `row`'s first `bucket_down(max_len)` tokens:
        a copy (contiguous) or a retain of the row's pages (paged), then
        the tree insert. Every position below max_len must already hold
        final KV (callers cap at the last fed token). Dedupes by token
        key; evicts LRU unpinned entries to fit the budget; skips, counted,
        when pinned entries leave no room. Returns True when an entry was
        inserted or refreshed."""
        n = len(tokens) if max_len is None else min(max_len, len(tokens))
        P = bucket_down(n, self.seq_len)
        if self.paged:
            # only whole pages can be shared read-only
            P = (P // self.page_pool.page_size) * self.page_pool.page_size
        if P < PREFIX_MIN_TOKENS:
            return False
        key = tuple(int(t) for t in tokens[:P])
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:
                self._clock += 1
                existing.last_used = self._clock
                return True
            need = self._slice_nbytes(engine, P)
            if need > self.budget_bytes or not self._evict_until(self.budget_bytes - need):
                self._incr("prefix_publish_skipped")
                return False
        if self.paged:
            # the row's pages below P are final: its later writes land
            # past P, or copy a shared page first. An unmapped slot below
            # P raises (the JAX package counts it as a skipped publish):
            # the caller's length accounting is off
            pages = self.page_pool.row_pages(row, P // self.page_pool.page_size)
            self.page_pool.retain(pages)
            k = v = None
            nbytes = need
        else:
            pages = ()
            k, v = extract_prefix_from_row(engine.cache, row, P)
            nbytes = _nbytes(k) + _nbytes(v)
        with self._lock:
            if key in self._entries:  # raced with another publisher
                if pages:
                    self.page_pool.release(pages)
                return True
            self._clock += 1
            entry = PrefixEntry(tokens=key, k=k, v=v, nbytes=nbytes,
                                last_used=self._clock, pages=pages)
            self._insert(entry)
            self._entries[key] = entry
            self._bytes += entry.nbytes
            self._gauges()
        self._incr("prefix_inserts")
        global_event("prefix_publish", keys=("tokens", "row"), vals=(P, int(row)))
        return True

    def insert_external(self, engine, tokens, k_np, v_np, start: int = 0,
                        base_entry=None) -> bool:
        """Insert a slice computed outside this engine (a prefill worker's
        shipped KV, a tier promotion) exactly like a local publish, so the
        next admission's `match_for_splice` hits it through the ordinary
        splice. `k_np`/`v_np` cover tokens ``[start, P)``: one array, or a
        list of per-segment arrays along `doubling_segments(start, P)`;
        host arrays off the wire (bf16 as uint16 words) or tensors on the
        card. ``start > 0`` merges onto `base_entry` (pinned by the caller,
        its tokens equal to ``tokens[:start]``). Runs on the engine's
        device-owning thread: the paged arm writes the live pool. Returns
        False, never raises to the serving path, when the slice is unusable
        (off-bucket length, misaligned start, wrong shape, no room)."""
        from .kv_transport import doubling_segments

        P = len(tokens)
        if P < PREFIX_MIN_TOKENS or P != bucket_down(P, self.seq_len):
            return False
        if start < 0 or start >= P:
            return False
        if start > 0:
            if base_entry is None or start != bucket_down(start, self.seq_len):
                return False
            if tuple(base_entry.tokens[:start]) != tuple(int(t) for t in tokens[:start]):
                return False
        key = tuple(int(t) for t in tokens)
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None:
                self._clock += 1
                existing.last_used = self._clock
                return True
        segs = doubling_segments(start, P)
        if isinstance(k_np, (list, tuple)):
            if len(k_np) != len(segs) or len(v_np) != len(segs):
                return False
            parts = [(a, k_np[i], v_np[i]) for i, (a, _b) in enumerate(segs)]
        else:
            if k_np.shape[1] != P - start or v_np.shape[1] != P - start:
                return False
            parts = [(a, k_np[:, a - start : b - start], v_np[:, a - start : b - start])
                     for a, b in segs]
        L, _, _, h, d = engine.cache.k.shape
        for a, kp, vp in parts:
            b = a + kp.shape[1]
            if tuple(kp.shape) != (L, b - a, h, d) or tuple(vp.shape) != (L, b - a, h, d):
                return False
        need = self._slice_nbytes(engine, P)
        with self._lock:
            if need > self.budget_bytes or not self._evict_until(self.budget_bytes - need):
                self._incr("prefix_publish_skipped")
                return False
        if self.paged:
            ok, k, v, pages = self._materialize_paged(engine, parts, start, P, base_entry)
        else:
            ok, k, v, pages = self._materialize_contiguous(engine, parts, start, P, base_entry)
        if not ok:
            return False
        with self._lock:
            if key in self._entries:  # raced with another inserter
                if pages:
                    self.page_pool.release(pages)
                return True
            if not self._evict_until(self.budget_bytes - need):
                if pages:
                    self.page_pool.release(pages)
                self._incr("prefix_publish_skipped")
                return False
            self._clock += 1
            entry = PrefixEntry(tokens=key, k=k, v=v, nbytes=need, last_used=self._clock,
                                pages=pages)
            self._insert(entry)
            self._entries[key] = entry
            self._bytes += entry.nbytes
            self._gauges()
        self._incr("prefix_inserts")
        global_event("prefix_insert_external", keys=("tokens", "start"), vals=(P, start))
        return True

    def _materialize_contiguous(self, engine, parts, start, P, base_entry):
        """One new [L, P, h, d] pair on the engine's device: the base
        entry's leading span (its own tensors) and the shipped segments,
        cast to the cache dtype and concatenated."""
        from .kv_transport import from_wire

        dev, dt = engine.cache.k.device, engine.cache.k.dtype
        pieces_k, pieces_v = [], []
        if start > 0:
            # the base may be deeper than `start`; only its verified
            # leading span merges
            bk, bv = (global_slice(engine.cache, x) for x in (base_entry.k, base_entry.v))
            pieces_k.append(bk[:, :start])
            pieces_v.append(bv[:, :start])
        for _a, kp, vp in parts:
            pieces_k.append(from_wire(kp, dev).to(dt))
            pieces_v.append(from_wire(vp, dev).to(dt))
        k = torch.cat(pieces_k, dim=1) if len(pieces_k) > 1 else pieces_k[0].clone()
        v = torch.cat(pieces_v, dim=1) if len(pieces_v) > 1 else pieces_v[0].clone()
        mesh = getattr(engine.cache, "mesh", None)
        if mesh is not None:
            from ..parallel.sharding import split_global

            k, v = split_global(k, mesh, 0, 2), split_global(v, mesh, 0, 2)
        return True, k, v, ()

    def _materialize_paged(self, engine, parts, start, P, base_entry):
        """Scatter each shipped segment into freshly allocated pool pages
        (in place, `scatter_pages`) and retain the base entry's leading
        pages: the merged entry is page content under this pool's ids.
        Allocation runs outside the trie lock (the reclaim hook takes it)."""
        from .kv_transport import from_wire
        from .paged_kv import PagePoolExhausted, scatter_pages

        pool = self.page_pool
        ps = pool.page_size
        if start % ps != 0 or P % ps != 0:
            return False, None, None, ()
        if any((a % ps or kp.shape[1] % ps) for a, kp, _v in parts):
            return False, None, None, ()
        base_pages = ()
        if start > 0:
            base_pages = tuple(base_entry.pages[: start // ps])
            if len(base_pages) != start // ps:
                return False, None, None, ()
        new_pages: list = []
        dev = engine.cache.k.device
        try:
            for _a, kp, vp in parts:
                seg_pages = pool.allocate_pages(kp.shape[1] // ps)
                new_pages.extend(seg_pages)
                scatter_pages(engine.cache, from_wire(kp, dev), from_wire(vp, dev), seg_pages)
        except PagePoolExhausted:
            if new_pages:
                pool.release(new_pages)
            self._incr("prefix_publish_skipped")
            return False, None, None, ()
        pool.retain(base_pages)
        return True, None, None, base_pages + tuple(new_pages)

    def _slice_nbytes(self, engine, P: int) -> int:
        if self.paged:
            from .paged_kv import page_pool_bytes

            ps = self.page_pool.page_size
            return page_pool_bytes(engine.cfg, P // ps, ps)
        cfg = engine.cfg
        return 2 * cfg.n_layers * P * cfg.n_kv_heads * cfg.head_dim * engine.cache.k.element_size()

    # -- tree maintenance (callers hold the lock) --------------------------

    def _insert(self, entry) -> None:
        t = entry.tokens
        node = self._root
        i = 0
        while True:
            if i == len(t):
                node.entry = entry
                return
            child = node.children.get(t[i])
            if child is None:
                leaf = _Node(t[i:])
                leaf.entry = entry
                node.children[t[i]] = leaf
                return
            e = child.edge
            lim = min(len(e), len(t) - i)
            lcp = 0
            while lcp < lim and e[lcp] == t[i + lcp]:
                lcp += 1
            if lcp == len(e):
                node = child
                i += lcp
                continue
            # split the edge at the divergence
            mid = _Node(e[:lcp])
            child.edge = e[lcp:]
            mid.children[child.edge[0]] = child
            node.children[t[i]] = mid
            i += lcp
            if i == len(t):
                mid.entry = entry
            else:
                leaf = _Node(t[i:])
                leaf.entry = entry
                mid.children[t[i]] = leaf
            return

    def _detach(self, entry) -> None:
        """Remove `entry` from the tree, pruning nodes left empty."""
        t = entry.tokens
        path = []  # (parent, first token, node)
        node = self._root
        i = 0
        while i < len(t):
            child = node.children.get(t[i])
            if child is None:
                return  # already detached
            path.append((node, t[i], child))
            i += len(child.edge)
            node = child
        if node.entry is not entry:
            return
        node.entry = None
        for parent, first, n in reversed(path):
            if n.entry is None and not n.children:
                del parent.children[first]
            else:
                break

    def _evict_until(self, target_bytes: int) -> bool:
        """Evict LRU unpinned entries until total <= target; False when
        pinned entries make the target unreachable."""
        while self._bytes > target_bytes:
            victims = [e for e in self._entries.values() if e.refs == 0]
            if not victims:
                return False
            self._remove(min(victims, key=lambda e: e.last_used))
            self._incr("prefix_evictions")
        return True

    def _remove(self, entry) -> None:
        self._detach(entry)
        self._entries.pop(entry.tokens, None)
        self._bytes -= entry.nbytes
        if self.tier is not None:
            # demote, not delete: the capture runs before the victim's
            # pages return to the pool, on this (the device-owning) thread,
            # so its gather reads the victim's bytes into storage of its
            # own before any later scatter can reuse those pages. `clear`
            # (engine recovery) bypasses this: a suspect cache must not
            # seed a tier
            self.tier.capture_demotion(entry)
        if entry.pages:
            self.page_pool.release(entry.pages)
        self._gauges()

    def evict_one(self) -> bool:
        """Evict the LRU unpinned entry (the page pool's reclaim hook:
        allocation pressure trades cached prefixes for live rows' pages).
        False when everything is pinned or the cache is empty."""
        with self._lock:
            victims = [e for e in self._entries.values() if e.refs == 0]
            if not victims:
                return False
            self._remove(min(victims, key=lambda e: e.last_used))
            self._incr("prefix_evictions")
            return True

    def clear(self) -> None:
        """Drop every entry; paged entries give their page references back."""
        with self._lock:
            for entry in self._entries.values():
                if entry.pages:
                    self.page_pool.release(entry.pages)
            self._root = _Node()
            self._entries.clear()
            self._bytes = 0
            self._gauges()
