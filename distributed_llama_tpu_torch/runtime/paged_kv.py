"""Paged KV cache: fixed-size KV pages, per-row page tables, refcounted
sharing and copy-on-write.

The counterpart of the JAX package's `runtime/paged_kv.py`: the resolvers
(:78-150), `page_pool_bytes` (:152), `init_kv_pool` (:162), `copy_page`
(:184), `PagePoolExhausted` (:297) and `PagePool` (:302-552), for one
device, with the prefix cache's hooks (runtime/prefix_cache.py): the
`reclaim` callback that `ensure` loops through, `row_pages`, `retain` and
`release`, and the JAX pool's StepStats hooks (`stats=`, :340-349): the
``kv_pool_*``, ``kv_cow_*`` and ``kv_pages_shared`` counters and the
``kv_pool_pages_used`` / ``kv_pool_pages_free`` gauges, the server's
`/stats` snapshot, and the KV movement layer's page movers
(runtime/kv_transport.py): `gather_pages` (JAX :227), `scatter_pages`
(:257) and `PagePool.allocate_pages` (:440). `scatter_pages` writes into
the live pool tensors in place (the decode graphs read them); on the
int8 arm the gather dequantizes to f32 and the scatter quantizes, as in
JAX.

The pool is ``[L, n_pages + 1, page_size, n_kv, head_dim]`` k/v tensors
(plus ``[L, n_pages + 1, page_size, n_kv]`` f32 scales on the int8 arm).
Page ``n_pages`` is the SINK: no table ever maps it and no read ever
gathers it. The forward pass sends every write that must not land (a
parked row at ``pos >= seq_len``, a slot past the table, an unmapped
``-1`` entry) to the sink through index arithmetic alone, where JAX
scatters with ``mode="drop"``: torch has no dropping scatter, and filtering
the writes with a mask would sync the host every layer.

Device side the forward pass changes in two places (models/transformer.py):
writes scatter to ``(table[row, pos // ps], pos % ps)``; reads gather the
first ``n_read`` table entries (clamped at 0: unmapped slots read page 0,
whose content the causal mask discards), or go to the fused int8 decode
kernel (ops/cuda_attention.py, K5), which reads the pool through the table.

Host side :class:`PagePool` owns allocation: a free list, per-page
refcounts and the page tables, under one lock. ``version`` moves on every
table change, so the engine re-uploads the tables only then, in place,
into one device buffer (:class:`DeviceTables`) that the decode graphs read.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.params import KVCache, kv_cache_of_shape

#: default page size in token positions
DEFAULT_PAGE_SIZE = 16

KV_LAYOUTS = ("contiguous", "paged")
KV_DTYPES = ("bfloat16", "float32", "int8")


def resolve_kv_layout(explicit: str | None, default: str = "contiguous") -> str:
    """The one resolver of the KV layout: an explicit value wins; otherwise
    ``DLT_KV_LAYOUT``; unset or unrecognized means `default`."""
    layout = explicit
    if layout is None:
        raw = (os.environ.get("DLT_KV_LAYOUT") or "").strip().lower()
        layout = raw if raw in KV_LAYOUTS else default
    layout = layout.strip().lower()
    if layout not in KV_LAYOUTS:
        raise ValueError(f"unknown kv layout {layout!r} (choose from {KV_LAYOUTS})")
    return layout


def resolve_page_size(explicit: int | None = None) -> int:
    """Page size in tokens: explicit > ``DLT_KV_PAGE`` env > 16. Must be a
    power of two."""
    v = explicit
    if v is None:
        raw = os.environ.get("DLT_KV_PAGE")
        try:
            v = int(raw) if raw else 0
        except ValueError:
            v = 0
    v = int(v) if v else DEFAULT_PAGE_SIZE
    if v <= 0 or (v & (v - 1)) != 0:
        raise ValueError(f"kv page size must be a positive power of two, got {v}")
    return v


def resolve_kv_dtype(explicit: str | None = None) -> str | None:
    """The one resolver of the KV storage dtype: an explicit value wins;
    otherwise ``DLT_KV_DTYPE``; unset means None (the compute dtype's
    default cache)."""
    v = explicit
    if v is None:
        raw = (os.environ.get("DLT_KV_DTYPE") or "").strip()
        v = raw or None
    if v is None:
        return None
    v = v.strip().lower()
    if v == "bf16":
        v = "bfloat16"
    if v not in KV_DTYPES:
        raise ValueError(f"unknown kv dtype {v!r} (choose from {KV_DTYPES})")
    return v


def resolve_pool_pages(explicit_mb: int | None, page_bytes: int, parity_pages: int) -> int:
    """Pool size in pages: an explicit MB budget (argument >
    ``DLT_KV_POOL_MB`` env) wins; 0 or unset means contiguous parity, the
    pages a ``batch x seq_len`` slab holds."""
    mb = explicit_mb
    if mb is None:
        raw = os.environ.get("DLT_KV_POOL_MB")
        try:
            mb = int(raw) if raw else 0
        except ValueError:
            mb = 0
    if mb and mb > 0:
        return max(1, (int(mb) * 1024 * 1024) // max(page_bytes, 1))
    return parity_pages


def page_pool_bytes(cfg: ModelConfig, n_pages: int, page_size: int) -> int:
    """Device bytes of `n_pages` pages of k+v, the int8 arm's f32 scales
    included (the sink page is not counted)."""
    itemsize = torch.empty((), dtype=cfg.kv_dtype).element_size()
    per_vector = cfg.head_dim * itemsize + (4 if cfg.kv_quantized else 0)
    return 2 * cfg.n_layers * n_pages * page_size * cfg.n_kv_heads * per_vector


def init_kv_pool(cfg: ModelConfig, n_pages: int, page_size: int, device=None) -> KVCache:
    """The zeroed page pool: `n_pages` allocatable pages and the sink, on
    `device` (None: the card)."""
    shape = (cfg.n_layers, n_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim)
    return kv_cache_of_shape(cfg, shape, device)


def copy_page(cache: KVCache, src: int, dst: int) -> None:
    """Copy one physical page (every layer, scales included) onto another,
    in place: the copy-on-write of a write that starts mid-page. On a mesh
    (parallel/sharding.py MeshKV) every shard's pool copies its own part
    of the page."""
    for t in cache.tensors():
        t[:, dst].copy_(t[:, src])


def _page_index(cache: KVCache, pages) -> torch.Tensor:
    """A host page-id list as an int64 index on the pool's device."""
    idx = np.asarray(pages, dtype=np.int64).reshape(-1)
    return torch.from_numpy(idx).to(cache.k.device)


def gather_pages(cache: KVCache, pages) -> tuple:
    """Read the named pool pages into one new contiguous [L, n * ps, h, d]
    k/v pair (the paged extract and demotion path). Negative ids clamp to
    page 0, as in JAX. The int8 pool dequantizes on extract to f32, so
    every consumer of this shape (the wire codec, the device transport,
    the tiers) sees a float slice. The result owns its storage: a later
    scatter into the same pages cannot change it. A mesh's pool gathers
    on every (pp, tp) shard and joins the blocks on the mesh's first
    device."""
    if getattr(cache, "mesh", None) is not None:
        from ..parallel.sharding import join_global

        parts = {(p, t): gather_pages(shard, pages) for (_, p, t, _), shard in cache.shards.items()}
        return tuple(join_global({key: kv[i] for key, kv in parts.items()}, cache.mesh, 0, 2)
                     for i in (0, 1))
    idx = _page_index(cache, pages).clamp(min=0)
    k = cache.k.index_select(1, idx)  # [L, n, ps, h, d]
    v = cache.v.index_select(1, idx)
    if cache.k_scale is not None:
        from ..ops.kv_quant import dequantize_kv

        k = dequantize_kv(k, cache.k_scale.index_select(1, idx), torch.float32)
        v = dequantize_kv(v, cache.v_scale.index_select(1, idx), torch.float32)
    L, n, ps, h, d = k.shape
    return k.reshape(L, n * ps, h, d), v.reshape(L, n * ps, h, d)


def scatter_pages(cache: KVCache, k_seg: torch.Tensor, v_seg: torch.Tensor, pages) -> None:
    """Write a contiguous [L, n * ps, h, d] slice into the named pool pages,
    IN PLACE (`index_copy_` into the live pool tensors, which the decode
    graphs read: nothing is rebound). The int8 pool quantizes the float
    segment and writes the scales beside it. Ids are pairwise distinct by
    allocation. A mesh's pool takes each (pp, tp) shard's block."""
    if getattr(cache, "mesh", None) is not None:
        from ..parallel.sharding import split_global

        ks, vs = (split_global(x, cache.mesh, 0, 2) for x in (k_seg, v_seg))
        for (_, p, t, _), shard in cache.shards.items():
            scatter_pages(shard, ks[(p, t)], vs[(p, t)], pages)
        return
    idx = _page_index(cache, pages)
    L, n = cache.k.shape[0], idx.shape[0]
    ps, h, d = cache.k.shape[2], cache.k.shape[3], cache.k.shape[4]
    dev = cache.k.device
    k_seg = k_seg.to(dev).reshape(L, n, ps, h, d)
    v_seg = v_seg.to(dev).reshape(L, n, ps, h, d)
    if cache.k_scale is not None:
        from ..ops.kv_quant import quantize_kv

        k_seg, ks = quantize_kv(k_seg)
        v_seg, vs = quantize_kv(v_seg)
        cache.k_scale.index_copy_(1, idx, ks)
        cache.v_scale.index_copy_(1, idx, vs)
    cache.k.index_copy_(1, idx, k_seg.to(cache.k.dtype))
    cache.v.index_copy_(1, idx, v_seg.to(cache.v.dtype))


class PagePoolExhausted(RuntimeError):
    """No free page and the reclaim hook made no progress: size the pool or
    free rows."""


class PagePool:
    """Host-side page allocator and per-row page tables.

    ``tables[row, slot]`` is the physical page holding the row's logical
    positions ``[slot*ps, (slot+1)*ps)``, or -1 (unmapped). ``version``
    moves on every table change. `reclaim` (``() -> bool``, the engine's
    prefix-cache eviction) frees pages under pressure: True means it made
    progress and the allocation is planned again. `stats` (the engine's
    StepStats, runtime/telemetry.py) takes the pool's counters and gauges
    under the JAX pool's names. `page_bytes` (device bytes a page, scales
    included) and `kv_dtype` label `snapshot`, the server's `/stats` view."""

    def __init__(self, n_pages: int, page_size: int, n_rows: int, seq_len: int, reclaim=None,
                 stats=None, page_bytes: int = 0, kv_dtype: str | None = None):
        if n_pages <= 0:
            raise ValueError("page pool needs at least one page")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.page_bytes = int(page_bytes)
        self.kv_dtype = kv_dtype
        self.n_rows = int(n_rows)
        self.seq_len = int(seq_len)
        self.max_slots = -(-seq_len // page_size)
        self.reclaim = reclaim
        self.stats = stats
        # releases past a page's last reference, clamped at 0 (the JAX
        # pool's kv_pool_double_release counter)
        self.double_releases = 0
        self.refs = np.zeros(self.n_pages, np.int32)
        self._free: list = list(range(self.n_pages - 1, -1, -1))
        self.tables = np.full((self.n_rows, self.max_slots), -1, np.int32)
        self.version = 0
        self._lock = threading.Lock()

    # -- observability ------------------------------------------------------

    def _incr(self, name: str, n: int = 1):
        if self.stats is not None:
            self.stats.incr(name, n)

    def _gauges(self):
        if self.stats is not None:
            self.stats.gauge("kv_pool_pages_used", self.n_pages - len(self._free))
            self.stats.gauge("kv_pool_pages_free", len(self._free))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def snapshot(self) -> dict:
        """Occupancy and capacity, under the JAX pool's keys (its
        `snapshot`): stored bytes, so an int8 pool shows its real token
        capacity."""
        with self._lock:
            return {
                "n_pages": self.n_pages,
                "page_size": self.page_size,
                "used_pages": self.used_pages,
                "free_pages": self.free_pages,
                "max_slots": self.max_slots,
                "shared_pages": int(np.sum(self.refs > 1)),
                "kv_dtype": self.kv_dtype,
                "page_bytes": self.page_bytes,
                "pool_bytes": self.page_bytes * self.n_pages,
                "used_bytes": self.page_bytes * self.used_pages,
                "tokens_capacity": self.n_pages * self.page_size,
            }

    def row_holds_pages(self, row: int) -> bool:
        """Whether any slot of `row` is mapped: the Batcher's park-or-shed
        test (a parked admission waits only where another row holds pages
        that can free)."""
        with self._lock:
            return bool((self.tables[row] >= 0).any())

    def ensure(self, row: int, start: int, end: int) -> list:
        """Make span ``[start, end)`` of `row` privately writable: allocate
        unmapped slots, copy-on-write shared ones. Returns the ``[(src,
        dst), ...]`` page copies the caller must run (:func:`copy_page`)
        BEFORE the write: only a shared page that holds positions below
        `start` needs its content moved.

        Atomic per span: the whole plan applies only when every page it
        needs is free; otherwise nothing changes, the reclaim hook runs
        outside the lock and the span is planned again, and
        :class:`PagePoolExhausted` raises once reclaim makes no progress."""
        if end <= start:
            return []
        end = min(end, self.seq_len)
        ps = self.page_size
        while True:
            with self._lock:
                plan = []  # (slot, current page or -1)
                for slot in range(start // ps, -(-end // ps)):
                    cur = int(self.tables[row, slot])
                    if cur < 0 or int(self.refs[cur]) > 1:
                        plan.append((slot, cur))
                if not plan:
                    return []
                if len(self._free) >= len(plan):
                    cow: list = []
                    for slot, cur in plan:
                        page = self._free.pop()
                        self.refs[page] = 1
                        if cur >= 0:
                            # the row gives up its claim on the shared
                            # page; the content moves only when positions
                            # below `start` live on it (a page-aligned
                            # write overwrites it whole)
                            self.refs[cur] -= 1
                            if self.refs[cur] == 0:
                                self._free.append(cur)
                            if slot * ps < start:
                                cow.append((cur, page))
                                self._incr("kv_cow_copies")
                            self._incr("kv_cow_pages")
                        self.tables[row, slot] = page
                    self.version += 1
                    self._gauges()
                    return cow
            if self.reclaim is None or not self.reclaim():
                self._incr("kv_pool_exhausted")
                raise PagePoolExhausted(
                    f"kv page pool exhausted ({self.n_pages} pages of {self.page_size} tokens)"
                )
            self._incr("kv_pool_reclaims")

    def allocate_pages(self, n: int) -> tuple:
        """Take `n` free pages with refs = 1, bound to no row: the external
        insert's pages (a shipped slice scatters into them and a prefix
        entry holds them until its release). Retries through the reclaim
        hook under pressure; raises :class:`PagePoolExhausted` when
        nothing frees."""
        if n <= 0:
            return ()
        while True:
            with self._lock:
                if len(self._free) >= n:
                    out = []
                    for _ in range(n):
                        page = self._free.pop()
                        self.refs[page] = 1
                        out.append(page)
                    self._gauges()
                    return tuple(out)
            if self.reclaim is None or not self.reclaim():
                self._incr("kv_pool_exhausted")
                raise PagePoolExhausted(
                    f"kv page pool exhausted ({self.n_pages} pages of {self.page_size} tokens)"
                )
            self._incr("kv_pool_reclaims")

    def share(self, row: int, pages) -> None:
        """Map `pages` into the row's leading slots with their refcounts
        bumped (zero-copy sharing). Mappings they replace are released,
        after the new references are taken, so a self-share is safe."""
        pages = list(pages)
        if len(pages) > self.max_slots:
            raise ValueError("shared prefix longer than the row's table")
        with self._lock:
            for p in pages:
                self.refs[p] += 1
            for slot, p in enumerate(pages):
                cur = int(self.tables[row, slot])
                if cur >= 0:
                    self.refs[cur] -= 1
                    if self.refs[cur] == 0:
                        self._free.append(cur)
                self.tables[row, slot] = p
            self.version += 1
            self._incr("kv_pages_shared", len(pages))
            self._gauges()

    def row_pages(self, row: int, n_slots: int) -> tuple:
        """The row's first `n_slots` physical pages (the publish path).
        Raises when a slot is unmapped: the caller's length accounting is
        off."""
        with self._lock:
            pages = [int(p) for p in self.tables[row, :n_slots]]
        if any(p < 0 for p in pages):
            raise ValueError(f"row {row} has unmapped slots below {n_slots * self.page_size}")
        return tuple(pages)

    def retain(self, pages) -> None:
        """Take one reference per page (a prefix-cache entry's publish): the
        pages survive every row release until the entry releases them."""
        with self._lock:
            for p in pages:
                self.refs[p] += 1

    def release(self, pages) -> None:
        """Drop one reference per page (an entry's eviction or clear). A
        release past the last reference clamps at 0 and is counted in
        `double_releases`."""
        with self._lock:
            for p in pages:
                self.refs[p] -= 1
                if self.refs[p] == 0:
                    self._free.append(p)
                elif self.refs[p] < 0:
                    self.refs[p] = 0
                    self.double_releases += 1
                    self._incr("kv_pool_double_release")
            self._gauges()

    def release_row(self, row: int) -> None:
        """Unmap the whole row: every mapped page loses the row's
        reference; shared pages survive through their other holders."""
        with self._lock:
            for slot in range(self.max_slots):
                cur = int(self.tables[row, slot])
                if cur >= 0:
                    self.refs[cur] -= 1
                    if self.refs[cur] == 0:
                        self._free.append(cur)
                    self.tables[row, slot] = -1
            self.version += 1
            self._gauges()

    def release_all_rows(self) -> None:
        for r in range(self.n_rows):
            self.release_row(r)

    def device_tables(self) -> np.ndarray:
        """A copy of the tables, -1 for unmapped slots: the operand the
        forward pass writes and reads through."""
        with self._lock:
            return self.tables.copy()


class DeviceTables:
    """A pool's page tables on the device, in one ``[n_rows, max_slots]``
    int32 buffer that keeps its storage: a CUDA graph captured against it
    reads whatever was uploaded last. :meth:`operand` uploads into it in
    place (``copy_``), and only when the pool's version moved."""

    def __init__(self, pool: PagePool, device):
        self.buf = torch.full((pool.n_rows, pool.max_slots), -1, dtype=torch.int32, device=device)
        self.version = None

    def operand(self, pool: PagePool) -> torch.Tensor:
        version = pool.version
        if self.version != version:
            self.buf.copy_(torch.from_numpy(pool.device_tables()))
            self.version = version
        return self.buf

    def row_operand(self, pool: PagePool, row: int, out: torch.Tensor) -> torch.Tensor:
        """Row `row`'s table, brought up to date, copied in place into the
        fixed ``[1, max_slots]`` buffer `out` on the device (one
        device-to-device copy): a graphed admission chunk reads `out`,
        whichever row it serves, so one graph serves every row."""
        out.copy_(self.operand(pool)[row : row + 1])
        return out
