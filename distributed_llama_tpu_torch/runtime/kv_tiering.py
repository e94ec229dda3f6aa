"""Tiered KV store: HBM -> host RAM -> disk -> peer fleet cache.

The counterpart of the JAX package's `runtime/kv_tiering.py`, with the
same names, counters, gauges, trace events, environment variables and
wire contracts. The radix prefix cache (runtime/prefix_cache.py) is a
device-budgeted LRU; with a store attached, eviction becomes DEMOTION down
a ladder of cheaper tiers and an admission miss a PROMOTION back up it:

* **tier 0 — the card**: the prefix cache itself (its hit path unchanged).
* **tier 1 — host RAM**: an evicted entry is captured at `_remove` time
  on the device-owning thread (`capture_demotion`): a paged entry's pages
  are gathered into a new tensor of their own (`gather_pages`) before the
  pool recycles them, a contiguous entry's own tensors are simply
  retained. A drain thread copies the capture to the host under
  `graphs.CAPTURE_LOCK` (no capture is open while it touches the card),
  byte-budgeted via ``DLT_KV_HOST_TIER_MB``.
* **tier 2 — disk**: host-tier eviction spills the entry as ONE file in
  the wire format with per-doubling-segment checksums, budgeted via
  ``DLT_KV_DISK_TIER_MB`` under ``DLT_KV_DISK_TIER_DIR``; a read
  re-verifies through `verify_transfer`, and a flipped bit is rejected,
  unlinked and counted.
* **tier 3 — peer fleet**: any replica fetches a named page set from a
  peer that holds it (``DLT_KV_TIER_PEERS``) over ``POST /v1/kv_fetch``,
  on the same verified codec, with per-peer strikes and TTL redemption.

Promotion lands through `PrefixCache.insert_external` on the
device-owning thread (`PendingPromotion.apply`, deferred there by the
server): the paged arm writes the live pool in place, so a promoted
prefix splices through the same decode graphs, with no recapture, token
for token equal to a cold prefill. Paged int8 entries dequantize on
extract, so host and disk budgets charge f32 bytes. The gateway's
``X-DLT-Prefetch-Chain`` hint lifts matching disk/peer entries into the
host tier ahead of the request (`prefetch_hint`). Host and disk arrays
are NumPy; a bf16 slice is held as its uint16 words (runtime/
kv_transport.py).
"""

from __future__ import annotations

import json
import os
import queue
import tempfile
import threading
import time
from collections import OrderedDict

import numpy as np

from .kv_transport import (
    KEY_PAGE_TOKENS,
    WIRE_VERSION,
    KvCodecError,
    KvVersionError,
    TransferResult,
    device_peer,
    doubling_segments,
    kv_payload,
    matching_pages,
    page_keys,
    parse_kv_payload,
    segment_checksum,
    to_wire,
    verify_transfer,
    wire_name,
)
from .prefix_cache import PREFIX_MIN_TOKENS, bucket_down

DEFAULT_TIMEOUT_S = 5.0

#: test hook: one-shot payload corruption on the SERVING side — the next
#: ``serve_fetch`` flips a byte inside the k region after checksumming, so
#: the chaos twin proves the requester's verify gate rejects it and the
#: request degrades to local prefill (tests/test_kv_tiering.py)
_serve_chaos: list = []


def set_serve_chaos(enabled: bool = True) -> None:
    """Arm (or clear) the one-shot corrupt-serve fault."""
    _serve_chaos.clear()
    if enabled:
        _serve_chaos.append("flip")


def _prefill_boundary(n_prompt_tokens: int, seq_len: int) -> int:
    # mirrors server/disagg.prefill_boundary without a runtime->server import
    P = bucket_down(max(n_prompt_tokens - 1, 0), seq_len)
    return P if P >= PREFIX_MIN_TOKENS else 0


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def resolve_tier_peers(explicit=None) -> list:
    """``DLT_KV_TIER_PEERS``: comma-separated host:port fleet-cache peers."""
    raw = list(explicit) if explicit else [
        s for s in os.environ.get("DLT_KV_TIER_PEERS", "").split(",")
        if s.strip()
    ]
    peers = []
    for s in raw:
        if isinstance(s, (tuple, list)) and len(s) == 2:
            peers.append((str(s[0]), int(s[1])))
            continue
        host, _, port = str(s).strip().rpartition(":")
        peers.append((host or "127.0.0.1", int(port)))
    return peers


class _HostEntry:
    """One host-tier (tier 1) resident: full [0, P) coverage as pinned
    host arrays plus the READY wire header (page_keys + per-segment
    checksums computed once at demotion-drain time), so a disk spill or a
    peer serve is a slice + serialize, never a re-hash of the whole
    entry."""

    __slots__ = ("tokens", "k", "v", "header", "nbytes")

    def __init__(self, tokens, k, v, header, nbytes):
        self.tokens = tokens
        self.k = k
        self.v = v
        self.header = header
        self.nbytes = int(nbytes)


def _build_header(tokens, k_np, v_np) -> dict:
    P = len(tokens)
    spans = doubling_segments(0, P)
    return {
        "v": WIRE_VERSION,
        "tokens": [int(t) for t in tokens],
        "p": P,
        "start": 0,
        "page_tokens": KEY_PAGE_TOKENS,
        "page_keys": [format(h, "x") for h in page_keys(tokens)],
        "prefill_us": 0,
        "k_shape": list(k_np.shape),
        "v_shape": list(v_np.shape),
        "dtype": wire_name(k_np),
        "k_sums": [
            format(segment_checksum(k_np[:, a:b].tobytes()), "x")
            for a, b in spans
        ],
        "v_sums": [
            format(segment_checksum(v_np[:, a:b].tobytes()), "x")
            for a, b in spans
        ],
    }


def _slice_payload(tokens, k_np, v_np, start: int) -> bytes:
    """Serialize tokens ``[start, P)`` of a held entry as the v2 wire
    payload — the ``/v1/kv_fetch`` response body (and, with start=0, the
    disk-tier file format). Checksums cover the doubling ladder of the
    SLICE, exactly like server/disagg.run_prefill."""
    P = len(tokens)
    k_s = k_np[:, start:] if start else k_np
    v_s = v_np[:, start:] if start else v_np
    spans = doubling_segments(start, P)
    header = {
        "v": WIRE_VERSION,
        "tokens": [int(t) for t in tokens],
        "p": P,
        "start": start,
        "page_tokens": KEY_PAGE_TOKENS,
        "page_keys": [format(h, "x") for h in page_keys(tokens)],
        "prefill_us": 0,
        "k_shape": list(k_s.shape),
        "v_shape": list(v_s.shape),
        "dtype": wire_name(k_s),
        "k_sums": [
            format(segment_checksum(k_s[:, a - start : b - start].tobytes()), "x")
            for a, b in spans
        ],
        "v_sums": [
            format(segment_checksum(v_s[:, a - start : b - start].tobytes()), "x")
            for a, b in spans
        ],
    }
    return kv_payload(header, np.ascontiguousarray(k_s), np.ascontiguousarray(v_s))


class PendingPromotion:
    """A tier hit fetched but not yet inserted: the host/disk/peer fetch
    ran on the handler thread, and the device insert defers here so it
    runs on the engine's device-owning thread (the paged insert writes
    the live pool). Duck-types server/disagg.PendingExternalKv, so the
    Batcher and the serialized path apply either. ``base_entry`` (a peer
    fetch's content-addressed skip base) stays pinned until applied or
    abandoned."""

    def __init__(self, store, tokens, k, v, tier: str, start: int = 0,
                 base_entry=None):
        self.store = store
        self.tokens = tokens
        self.k = k
        self.v = v
        self.tier = tier
        self.start = start
        self.base_entry = base_entry
        self.engine = store.engine  # the engine the pin belongs to
        self._applied = False

    def apply(self, state) -> bool:
        if self._applied:
            return True
        engine = self.store.engine
        if engine is not self.engine:
            # a rebuild swapped the engine since the fetch: the request
            # prefills locally
            self.abandon()
            return False
        self._applied = True
        pc = engine.prefix_cache
        t0 = time.perf_counter()
        try:
            ok = pc.insert_external(
                engine, self.tokens, self.k, self.v, start=self.start,
                base_entry=self.base_entry,
            )
        finally:
            if self.base_entry is not None:
                pc.entry_release(self.base_entry)
            self.base_entry = None
        engine.stats.record(
            "promotion_insert_us", int((time.perf_counter() - t0) * 1e6)
        )
        if ok:
            engine.stats.incr("kv_tier_promotions")
            engine.stats.incr(
                "kv_tier_promoted_tokens", len(self.tokens) - self.start
            )
        else:
            engine.stats.incr("kv_tier_insert_failed")
            if self.store.goodput is not None:
                self.store.goodput.add_waste(
                    "transfer_retry", len(self.tokens) - self.start
                )
        return ok

    def abandon(self):
        """Release the pinned base without inserting (failed request path
        between fetch and admission)."""
        if self.base_entry is not None:
            self.engine.prefix_cache.entry_release(self.base_entry)
            self.base_entry = None
        self._applied = True


class TieredKvStore:
    """The tier 1-3 ladder behind one engine's prefix cache. Thread
    model: `capture_demotion` runs on the engine's device-owning thread
    inside the trie lock; a drain thread copies captured tensors to the
    host under `graphs.CAPTURE_LOCK`; a prefetch thread lifts disk/peer
    entries toward the host tier (host memory and sockets only);
    `fetch`/`serve_fetch` run on handler threads and touch host memory
    and sockets only (the device insert defers to
    :class:`PendingPromotion`). `engine` follows the server's engine
    across a rebuild (`attach`)."""

    def __init__(self, engine, goodput=None, host_mb=None, disk_mb=None,
                 disk_dir=None, peers=None, timeout_s=None,
                 backoff_s=None, integrity_strikes=None, strike_ttl_s=None):
        self.engine = engine
        self.goodput = goodput
        self.host_budget = (
            _env_int("DLT_KV_HOST_TIER_MB", 0) if host_mb is None else host_mb
        ) * 1024 * 1024
        self.disk_budget = (
            _env_int("DLT_KV_DISK_TIER_MB", 0) if disk_mb is None else disk_mb
        ) * 1024 * 1024
        if disk_dir is None:
            disk_dir = os.environ.get("DLT_KV_DISK_TIER_DIR", "")
        self.disk_dir = disk_dir or os.path.join(
            tempfile.gettempdir(), "dlt_kv_tier"
        )
        self.peers = resolve_tier_peers(peers)
        self.timeout_s = (
            _env_float("DLT_DISAGG_TIMEOUT_S", DEFAULT_TIMEOUT_S)
            if timeout_s is None else timeout_s
        )
        self.backoff_s = (
            _env_float("DLT_DISAGG_PEER_BACKOFF_S", 10.0)
            if backoff_s is None else backoff_s
        )
        self.integrity_strikes = max(
            _env_int("DLT_KV_INTEGRITY_STRIKES", 3)
            if integrity_strikes is None else integrity_strikes, 1,
        )
        self.strike_ttl_s = (
            _env_float("DLT_KV_INTEGRITY_TTL_S", 300.0)
            if strike_ttl_s is None else strike_ttl_s
        )
        self._lock = threading.Lock()  # host/disk indexes + peer ledgers
        self._host: OrderedDict = OrderedDict()  # token tuple -> _HostEntry
        self._host_bytes = 0
        self._disk: OrderedDict = OrderedDict()  # token tuple -> (path, nbytes)
        self._disk_bytes = 0
        self._file_seq = 0
        self._rr = 0
        self._backoff_until: dict = {}
        self._strikes: dict = {}
        # the prefetch-hint index: chain key (router FNV-1a text-block
        # hash) -> known token prefix tuple. Bounded: a hint is a hint.
        self._hints: OrderedDict = OrderedDict()
        self._hints_cap = 1024
        self._demote_q: queue.Queue = queue.Queue(maxsize=64)
        self._prefetch_q: queue.Queue = queue.Queue(maxsize=64)
        self._closed = False
        self._drain_thread = threading.Thread(
            target=self._drain_loop, name="kv-tier-drain", daemon=True
        )
        self._prefetch_thread = threading.Thread(
            target=self._prefetch_loop, name="kv-tier-prefetch", daemon=True
        )
        self._drain_thread.start()
        self._prefetch_thread.start()

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, engine, goodput=None):
        """None unless some tier is configured (host or disk budget > 0,
        or fleet-cache peers named) AND the engine runs a prefix cache —
        without tier 0 there is nothing to demote from or promote into."""
        if engine.prefix_cache is None:
            return None
        host_mb = _env_int("DLT_KV_HOST_TIER_MB", 0)
        disk_mb = _env_int("DLT_KV_DISK_TIER_MB", 0)
        peers = resolve_tier_peers()
        if host_mb <= 0 and disk_mb <= 0 and not peers:
            return None
        return cls(engine, goodput=goodput)

    def attach(self, engine) -> None:
        """Serve `engine` from here on (a supervisor rebuild's fresh
        engine): its prefix cache demotes into this store, its ledger
        reads this store's host section. What the tiers hold stays: it is
        page content, named by tokens, valid for any engine of the model."""
        self.engine = engine
        engine.kv_tier = self
        if engine.prefix_cache is not None:
            engine.prefix_cache.tier = self

    def close(self):
        """Stop the drain/prefetch loops (sentinel per queue; daemon
        threads, so a missed join can never hang exit)."""
        self._closed = True
        for q in (self._demote_q, self._prefetch_q):
            try:
                q.put_nowait(None)
            except queue.Full:
                pass  # dlt: allow(swallowed-exception) — the loop also polls self._closed
        self._drain_thread.join(timeout=2.0)
        self._prefetch_thread.join(timeout=2.0)

    def _incr(self, name, n=1):
        self.engine.stats.incr(name, n)

    def _gauges(self):
        # callers hold self._lock
        self.engine.stats.gauge("kv_tier_host_bytes", self._host_bytes)
        self.engine.stats.gauge("kv_tier_host_entries", len(self._host))
        self.engine.stats.gauge("kv_tier_host_budget_bytes", self.host_budget)
        self.engine.stats.gauge("kv_tier_disk_bytes", self._disk_bytes)
        self.engine.stats.gauge("kv_tier_disk_entries", len(self._disk))

    # -- demotion (tier 0 -> 1 -> 2) ----------------------------------------

    def capture_demotion(self, entry) -> None:
        """Called by PrefixCache._remove under the trie lock, on the
        engine's device-owning thread, before the victim's pages return to
        the pool. Paged: one `gather_pages` over the victim's pages into a
        new tensor, on this thread's stream, so it is ordered ahead of any
        later scatter into those pages and its result owns its bytes.
        Contiguous: the entry owns its tensors; retaining them is the whole
        capture. Never blocks: a full drain queue drops the demotion
        (counted) rather than stall an eviction."""
        if self._closed or (self.host_budget <= 0 and self.disk_budget <= 0):
            return
        engine = self.engine
        pc = engine.prefix_cache
        P = entry.length
        if P != bucket_down(P, pc.seq_len):
            return
        if entry.pages:
            from .paged_kv import gather_pages

            with engine._guard(f"page_extract[{P}]", ("page_extract", P, P)):
                k, v = gather_pages(engine.cache, entry.pages)
        else:
            from .prefix_cache import global_slice

            k, v = (global_slice(engine.cache, x) for x in (entry.k, entry.v))
        try:
            self._demote_q.put_nowait((tuple(entry.tokens), k, v))
        except queue.Full:
            self._incr("kv_tier_demote_dropped")

    def _drain_loop(self):
        while True:
            try:
                item = self._demote_q.get(timeout=0.5)
            except queue.Empty:
                if self._closed:
                    return
                continue
            if item is None:
                return
            tokens, k, v = item
            try:
                # the only device-to-host copy of the subsystem, off the
                # device-owning thread: under CAPTURE_LOCK, so never beside
                # a graph capture (a rebuild's warmup)
                from .graphs import CAPTURE_LOCK

                with CAPTURE_LOCK:
                    k_np = np.ascontiguousarray(to_wire(k))
                    v_np = np.ascontiguousarray(to_wire(v))
                del k, v
                header = _build_header(tokens, k_np, v_np)
                nbytes = int(k_np.nbytes) + int(v_np.nbytes)
                self._host_put(
                    _HostEntry(tokens, k_np, v_np, header, nbytes)
                )
                self._incr("kv_tier_demoted_host")
                self._incr("kv_tier_demoted_bytes", nbytes)
            except Exception:  # dlt: allow(swallowed-exception) — counted; a failed demotion is a cache miss later, never an error now
                self._incr("kv_tier_demote_dropped")

    def _host_put(self, entry: _HostEntry) -> None:
        if self.host_budget <= 0:
            self._spill_to_disk(entry)
            return
        with self._lock:
            old = self._host.pop(entry.tokens, None)
            if old is not None:
                self._host_bytes -= old.nbytes
            self._host[entry.tokens] = entry
            self._host_bytes += entry.nbytes
            spill = []
            while self._host_bytes > self.host_budget and len(self._host) > 1:
                _key, victim = self._host.popitem(last=False)
                self._host_bytes -= victim.nbytes
                spill.append(victim)
            if self._host_bytes > self.host_budget:
                _key, victim = self._host.popitem(last=False)
                self._host_bytes -= victim.nbytes
                spill.append(victim)
            self._gauges()
        for victim in spill:
            self._spill_to_disk(victim)

    def _spill_to_disk(self, entry: _HostEntry) -> None:
        if self.disk_budget <= 0:
            return
        try:
            payload = _slice_payload(entry.tokens, entry.k, entry.v, 0)
            os.makedirs(self.disk_dir, exist_ok=True)
            with self._lock:
                self._file_seq += 1
                seq = self._file_seq
            name = format(page_keys(entry.tokens)[-1], "016x")
            path = os.path.join(
                self.disk_dir, f"{name}_{len(entry.tokens)}_{seq}.kv"
            )
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(payload)
            os.replace(tmp, path)
        except OSError:
            self._incr("kv_tier_disk_errors")
            return
        unlink = []
        with self._lock:
            old = self._disk.pop(entry.tokens, None)
            if old is not None:
                self._disk_bytes -= old[1]
                unlink.append(old[0])
            self._disk[entry.tokens] = (path, len(payload))
            self._disk_bytes += len(payload)
            while self._disk_bytes > self.disk_budget and len(self._disk) > 1:
                _key, (vpath, vbytes) = self._disk.popitem(last=False)
                self._disk_bytes -= vbytes
                unlink.append(vpath)
            self._gauges()
        for vpath in unlink:
            try:
                os.unlink(vpath)
            except OSError:
                pass  # dlt: allow(swallowed-exception) — already gone; the index no longer names it
        self._incr("kv_tier_demoted_disk")

    # -- lookup (tiers 1/2 local, handler-thread safe) ----------------------

    def _held_buckets(self, ids, P: int) -> list:
        """Candidate bucket lengths, longest first, capped at P."""
        pc = self.engine.prefix_cache
        return [B for B in reversed(pc.buckets) if PREFIX_MIN_TOKENS <= B <= P]

    def _host_get(self, key):
        with self._lock:
            entry = self._host.get(key)
            if entry is not None:
                self._host.move_to_end(key)
            return entry

    def _disk_get(self, key):
        """Load + VERIFY one disk-tier entry; a corrupt or unreadable file
        is unlinked and counted — disk rot degrades to a miss, exactly
        like a corrupt peer degrades to local prefill."""
        with self._lock:
            hit = self._disk.get(key)
        if hit is None:
            return None
        path, nbytes = hit
        try:
            with open(path, "rb") as f:
                raw = f.read()
            header, k, v = parse_kv_payload(raw)
            result = TransferResult(header, k, v, "http", len(raw))
            verify_transfer(result, list(key), len(key))
        except (OSError, KvCodecError):
            self._incr("kv_tier_disk_corrupt")
            with self._lock:
                if self._disk.pop(key, None) is not None:
                    self._disk_bytes -= nbytes
                self._gauges()
            try:
                os.unlink(path)
            except OSError:
                pass  # dlt: allow(swallowed-exception) — already gone
            return None
        return _HostEntry(key, k, v, header, int(k.nbytes) + int(v.nbytes))

    def _truncated(self, entry: _HostEntry, B: int) -> _HostEntry:
        """A bucket-B view of a longer resident — valid because causal KV
        at positions < B depends only on tokens[:B] (the same property the
        HBM radix trie exploits). Checksums are recomputed for the slice,
        so the wire/verify contract is unchanged."""
        k = np.ascontiguousarray(entry.k[:, :B])
        v = np.ascontiguousarray(entry.v[:, :B])
        tokens = tuple(entry.tokens[:B])
        return _HostEntry(
            tokens, k, v, _build_header(tokens, k, v),
            int(k.nbytes) + int(v.nbytes),
        )

    def _lookup_local(self, ids, P: int, promote_host: bool):
        """(tier_name, _HostEntry) for the longest held bucket <= P, or
        (None, None). A disk hit optionally re-lands in the host tier."""
        for B in self._held_buckets(ids, P):
            key = tuple(int(t) for t in ids[:B])
            entry = self._host_get(key)
            if entry is not None:
                return "host", entry
            entry = self._disk_get(key)
            if entry is not None:
                if promote_host:
                    self._host_put(entry)
                return "disk", entry
        # exact-length keys missed: a LONGER resident whose leading tokens
        # match still covers the request — a prompt ending exactly on a
        # bucket boundary (publish at bucket_down(n), fetch at
        # bucket_down(n-1)), or a shorter sibling sharing the prefix
        for B in self._held_buckets(ids, P):
            prefix = tuple(int(t) for t in ids[:B])
            with self._lock:
                host_key = next(
                    (
                        k for k in reversed(self._host)
                        if len(k) > B and k[:B] == prefix
                    ),
                    None,
                )
            if host_key is not None:
                entry = self._host_get(host_key)
                if entry is not None:
                    return "host", self._truncated(entry, B)
            with self._lock:
                disk_key = next(
                    (
                        k for k in self._disk
                        if len(k) > B and k[:B] == prefix
                    ),
                    None,
                )
            if disk_key is not None:
                entry = self._disk_get(disk_key)
                if entry is not None:
                    entry = self._truncated(entry, B)
                    if promote_host:
                        self._host_put(entry)
                    return "disk", entry
        return None, None

    # -- peer tier (tier 3) -------------------------------------------------

    def _peer_usable(self, peer) -> bool:
        now = time.monotonic()
        with self._lock:
            if self._backoff_until.get(peer, 0.0) > now:
                return False
            entry = self._strikes.get(peer)
            if entry is None:
                return True
            count, ttl = entry
            if ttl <= now:
                del self._strikes[peer]
                return True
            return count < self.integrity_strikes

    def _peer_failed(self, peer):
        with self._lock:
            self._backoff_until[peer] = time.monotonic() + self.backoff_s

    def _peer_strike(self, peer) -> int:
        now = time.monotonic()
        with self._lock:
            count, ttl = self._strikes.get(peer, (0, 0.0))
            if ttl <= now:
                count = 0
            count += 1
            self._strikes[peer] = (count, now + self.strike_ttl_s)
            return count

    def _peer_ok(self, peer):
        with self._lock:
            self._backoff_until.pop(peer, None)

    def _peer_fetch_raw(self, peer, ids, have) -> bytes:
        """One peer round trip: the same-process registry short-circuits
        the socket (still through the SERIALIZED payload, so the verify
        gate sees real bytes either way); otherwise POST /v1/kv_fetch."""
        host, port = peer
        provider = device_peer(port)
        if provider is not None and hasattr(provider, "kv_tier_payload"):
            raw = provider.kv_tier_payload(list(ids), have_keys=tuple(have))
            if raw is None:
                raise OSError(f"peer {host}:{port} holds no matching pages")
            return raw
        import http.client

        conn = http.client.HTTPConnection(host, port, timeout=self.timeout_s)
        try:
            body = {"ids": [int(t) for t in ids]}
            if have:
                body["have"] = [format(int(h), "x") for h in have]
            conn.request(
                "POST", "/v1/kv_fetch", body=json.dumps(body),
                headers={"Content-Type": "application/json",
                         "Connection": "close"},
            )
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status != 200:
                raise OSError(f"/v1/kv_fetch returned {resp.status}")
        finally:
            conn.close()
        return raw

    def _skip_base(self, ids, covered, entry):
        """(start, base_entry STILL PINNED or None, have_keys) — the
        content-addressed skip claim from a `match_pinned` result
        (server/disagg.DisaggClient._skip_base, tier edition). Releases
        the pin itself (returning None) when nothing local is usable as
        a peer-fetch merge base."""
        engine = self.engine
        pc = engine.prefix_cache
        if entry is None:
            return 0, None, ()
        S = bucket_down(min(covered, entry.length), engine.cfg.seq_len)
        if engine.paged and engine.page_size and S % engine.page_size != 0:
            S = 0
        if S < KEY_PAGE_TOKENS or tuple(entry.tokens[:S]) != tuple(
            int(t) for t in ids[:S]
        ):
            pc.entry_release(entry)
            return 0, None, ()
        return S, entry, page_keys(ids[:S])

    def _fetch_peer(self, ids, P: int, have, S: int = 0):
        """Round-robin the fleet-cache peers for the longest bucket any
        of them holds. Returns (entry, B, r_start, peer_key, err,
        rejected_peer, rejected_err); entry None when every usable peer
        missed/failed. ``S`` is the have/skip claim: a peer may answer
        with ``start == S`` (ships only ``[S, B)`` — the caller merges
        onto its pinned base) or ``start == 0`` (full coverage); any
        other slicing is rejected as corrupt. Integrity semantics are
        the integrity contract verbatim: verify BEFORE anything is kept,
        corrupt peers take strikes, version skew skips without a
        strike."""
        usable = [p for p in self.peers if self._peer_usable(p)]
        err = None
        rejected_peer = None
        rejected_err = ""
        if not usable:
            return None, 0, 0, None, err, rejected_peer, rejected_err
        with self._lock:
            start = self._rr
            self._rr = (self._rr + 1) % len(usable)
        for i in range(len(usable)):
            peer = usable[(start + i) % len(usable)]
            host, port = peer
            try:
                raw = self._peer_fetch_raw(peer, ids[: P + 1], have)
                header, k, v = parse_kv_payload(raw)
                B = int(header.get("p", 0))
                if (
                    B < PREFIX_MIN_TOKENS
                    or B > P
                    or B != bucket_down(B, self.engine.cfg.seq_len)
                ):
                    raise KvCodecError(
                        f"peer names off-ladder boundary p={B}"
                    )
                r_start = int(header.get("start", 0))
                if r_start not in (0, S) or r_start >= B:
                    raise KvCodecError(
                        f"peer shipped start={r_start}, asked {S}"
                    )
                result = TransferResult(header, k, v, "http", len(raw))
                verify_transfer(result, ids, B)
                self._peer_ok(peer)
                self._incr("kv_integrity_verified")
                entry = _HostEntry(
                    tuple(int(t) for t in ids[:B]), k, v, header,
                    int(k.nbytes) + int(v.nbytes),
                )
                return (
                    entry, B, r_start, f"{host}:{port}", None,
                    rejected_peer, rejected_err,
                )
            except KvVersionError as e:
                err = e
                self._incr("kv_tier_peer_version_mismatch")
            except KvCodecError as e:
                err = e
                self._incr("kv_integrity_rejected")
                rejected_peer = f"{host}:{port}"
                rejected_err = f"{type(e).__name__}: {e}"
                self._peer_strike(peer)
            except Exception as e:
                err = e
                self._incr("kv_tier_peer_errors")
                self._peer_failed(peer)
        return None, 0, 0, None, err, rejected_peer, rejected_err

    # -- the admission-path fetch -------------------------------------------

    def fetch(self, ids: list, trace=None) -> dict:
        """Try to land ``ids``' leading bucket from a lower tier ahead of
        admission. Returns ``{promotion_us, tier_path, promoted_tokens,
        pending_kv}`` — ``pending_kv`` (a :class:`PendingPromotion`) is
        the deferred device insert the engine thread applies, exactly
        like the disagg client's pending. Zeros whenever the request
        proceeds on plain local prefill. Never raises."""
        out = {
            "promotion_us": 0, "tier_path": "", "promoted_tokens": 0,
            "pending_kv": None,
        }
        engine = self.engine
        pc = engine.prefix_cache
        if pc is None or self._closed:
            return out
        P = _prefill_boundary(len(ids), engine.cfg.seq_len)
        if P <= 0:
            return out
        # ONE trie walk, the entry pinned under the match's own lock hold
        # — it doubles as the peer fetch's merge base, and pool pressure
        # must never recycle a base's pages between lookup and insert
        covered, matched = pc.match_pinned(ids[:P])
        if matched is not None and covered >= P:
            pc.entry_release(matched)
            self._incr("kv_tier_local_hits")
            return out
        S, base_entry, have = self._skip_base(ids, covered, matched)
        t0 = time.perf_counter()
        tier, entry = self._lookup_local(ids, P, promote_host=True)
        B = len(entry.tokens) if entry is not None else 0
        r_start = 0
        peer_key = None
        err = None
        rejected_peer = None
        rejected_err = ""
        if (entry is None or B <= S) and self.peers:
            p_entry, p_B, r_start, peer_key, err, rejected_peer, rejected_err = (
                self._fetch_peer(ids, P, have, S)
            )
            if p_entry is not None and p_B > max(B, S):
                tier, entry, B = "peer", p_entry, p_B
                if r_start == 0:
                    # a verified FULL peer fetch also lands in the host
                    # tier, so the next replica asking this one can be
                    # served and a re-eviction re-promotes without
                    # another network trip (partial sends can't: the
                    # host tier stores full coverage only)
                    self._host_put(p_entry)
                self._incr("kv_tier_peer_bytes", p_entry.nbytes)
            else:
                r_start = 0
        wall_us = int((time.perf_counter() - t0) * 1e6)
        from .tracing import to_us

        if rejected_peer is not None and trace is not None:
            # ONE event per fetch, outside the peer loop — landed even
            # unsampled and even when failover saved the request
            trace.event(
                "kv_integrity", to_us(t0), wall_us,
                ("peer", "outcome", "error"),
                (rejected_peer, "rejected", rejected_err),
                always=True,
            )
        if entry is None or B <= S:
            if base_entry is not None:
                pc.entry_release(base_entry)
            if tier is None and peer_key is None and err is None:
                self._incr("kv_tier_misses")
            elif err is not None:
                # a peer round trip failed or was rejected AND no lower
                # tier could cover: degrade to local prefill (token-
                # identical). Integrity rejections ledger as integrity
                # waste so a corrupting peer is visible in goodput.
                self._incr("kv_tier_degraded")
                if self.goodput is not None:
                    reason = (
                        "integrity"
                        if isinstance(err, KvCodecError)
                        and not isinstance(err, KvVersionError)
                        else "transfer_retry"
                    )
                    self.goodput.add_waste(reason, P)
                if trace is not None:
                    trace.event(
                        "kv_tier_fetch", to_us(t0), wall_us,
                        ("tier", "tokens", "failed", "error"),
                        (
                            "peer", P, 1,
                            f"{type(err).__name__}: {err}",
                        ),
                        always=True,
                    )
            return out
        if tier != "peer" or r_start == 0:
            # host/disk hits (and full peer sends) ship full coverage:
            # the base pin is no longer a merge base
            if base_entry is not None:
                pc.entry_release(base_entry)
            base_entry = None
            r_start = 0
        self._incr(f"kv_tier_hits_{tier}")
        self.engine.stats.record("promotion_us", wall_us)
        out["promotion_us"] = wall_us
        out["tier_path"] = tier
        out["promoted_tokens"] = B - r_start
        out["pending_kv"] = PendingPromotion(
            self, list(entry.tokens), entry.k, entry.v, tier,
            start=r_start, base_entry=base_entry,
        )
        if trace is not None:
            trace.event(
                "kv_tier_fetch", to_us(t0), wall_us,
                ("tier", "tokens", "failed", "peer"),
                (tier, B - r_start, 0, peer_key or ""),
            )
        return out

    # -- the serving side of tier 3 -----------------------------------------

    def serve_fetch(self, ids: list, have_keys=()) -> bytes | None:
        """Build the ``POST /v1/kv_fetch`` response: the longest held
        bucket covering a prefix of ``ids`` (host tier first, then a disk
        load — VERIFIED before serving), minus the leading pages the
        requester's ``have`` names prove it already holds. Host memory
        and disk only — zero device work, so ANY role can serve its
        tiers from a handler thread. None when nothing is held."""
        if self._closed:
            return None
        P = _prefill_boundary(len(ids), self.engine.cfg.seq_len)
        if P <= 0:
            return None
        tier, entry = self._lookup_local(ids, P, promote_host=False)
        if entry is None:
            return None
        B = len(entry.tokens)
        S = matching_pages(page_keys(entry.tokens), have_keys) * KEY_PAGE_TOKENS
        S = bucket_down(S, self.engine.cfg.seq_len) if S else 0
        if S >= B:
            S = 0  # the requester claims full coverage; ship everything anyway
        payload = _slice_payload(entry.tokens, entry.k, entry.v, S)
        if _serve_chaos:
            _serve_chaos.pop()
            # flip one byte INSIDE the k region (past the length-prefixed
            # header) the way bad hardware would — the checksums upstream
            # already cover it, so the requester's verify gate must reject
            buf = bytearray(payload)
            hdr_len = 4 + int.from_bytes(buf[:4], "big")
            if len(buf) > hdr_len:
                buf[hdr_len] ^= 0xFF
            payload = bytes(buf)
        self._incr("kv_tier_peer_served")
        self._incr("kv_tier_peer_served_bytes", len(payload))
        return payload

    # -- prefetch hints ------------------------------------------------------

    def note_chain(self, chain, ids) -> None:
        """Teach the hint index what token prefix each router chain key
        resolves to (called once per admitted request — the replica side
        of the ``X-DLT-Prefetch-Chain`` contract)."""
        if not chain:
            return
        P = _prefill_boundary(len(ids), self.engine.cfg.seq_len)
        if P <= 0:
            return
        # P+1 tokens, not P: the boundary is bucket_down(n-1), so replaying
        # the hint through the same math must land on the SAME bucket the
        # original request promoted
        prefix = tuple(int(t) for t in ids[: P + 1])
        with self._lock:
            for ck in chain:
                self._hints[int(ck)] = prefix
                self._hints.move_to_end(int(ck))
            while len(self._hints) > self._hints_cap:
                self._hints.popitem(last=False)

    def prefetch_hint(self, chain) -> None:
        """The gateway's ``X-DLT-Prefetch-Chain`` landed: start lifting
        the named prefix toward the host tier NOW, while the request body
        is still being parsed/tokenized. Deepest key first — the longest
        known prefix wins. Non-blocking; the hint is advisory."""
        if self._closed or not chain:
            return
        prefix = None
        with self._lock:
            for ck in reversed(list(chain)):
                prefix = self._hints.get(int(ck))
                if prefix is not None:
                    break
        if prefix is None:
            return
        self._incr("kv_tier_prefetch_hints")
        try:
            self._prefetch_q.put_nowait(prefix)
        except queue.Full:
            pass  # dlt: allow(swallowed-exception) — a dropped hint is just a slower first hit

    def _prefetch_loop(self):
        while True:
            try:
                prefix = self._prefetch_q.get(timeout=0.5)
            except queue.Empty:
                if self._closed:
                    return
                continue
            if prefix is None:
                return
            try:
                ids = list(prefix)
                P = _prefill_boundary(len(ids), self.engine.cfg.seq_len)
                if P <= 0:
                    continue
                if self._host_get(tuple(ids[:P])) is not None:
                    continue  # already tier 1: the admission fetch will hit
                tier, entry = self._lookup_local(
                    ids, P, promote_host=True
                )
                if entry is None and self.peers:
                    entry, B, _rs, _pk, _err, _rp, _re = self._fetch_peer(
                        ids, P, ()
                    )
                    if entry is not None:
                        self._host_put(entry)
                if entry is not None:
                    self._incr("kv_tier_prefetched")
            except Exception:  # dlt: allow(swallowed-exception) — counted at the tiers; a failed prefetch is a slower hit, never an error
                self._incr("kv_tier_peer_errors")

    # -- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            backing_off = [
                f"{h}:{p}" for (h, p), t in self._backoff_until.items()
                if t > now
            ]
            peer_strikes = {
                f"{h}:{p}": c
                for (h, p), (c, ttl) in self._strikes.items() if ttl > now
            }
            struck_out = [
                f"{h}:{p}"
                for (h, p), (c, ttl) in self._strikes.items()
                if ttl > now and c >= self.integrity_strikes
            ]
            return {
                "host": {
                    "entries": len(self._host),
                    "bytes": self._host_bytes,
                    "budget_bytes": self.host_budget,
                },
                "disk": {
                    "entries": len(self._disk),
                    "bytes": self._disk_bytes,
                    "budget_bytes": self.disk_budget,
                    "dir": self.disk_dir,
                },
                "peers": [f"{h}:{p}" for h, p in self.peers],
                "peers_backing_off": backing_off,
                "hints_tracked": len(self._hints),
                "integrity": {
                    "strikes_limit": self.integrity_strikes,
                    "strike_ttl_s": self.strike_ttl_s,
                    "peer_strikes": peer_strikes,
                    "peers_struck_out": struck_out,
                },
            }

    def memory_snapshot(self) -> dict:
        """The hbm_ledger's host-tier section: host RAM held by tier 1
        (NOT an HBM component — it reconciles against process RSS, not
        device memory_stats)."""
        with self._lock:
            return {
                "host_bytes": self._host_bytes,
                "host_budget_bytes": self.host_budget,
                "disk_bytes": self._disk_bytes,
                "disk_budget_bytes": self.disk_budget,
            }
