"""Prefill/decode disaggregation: dedicated prefill workers ship KV.

The counterpart of the JAX package's `server/disagg.py`, with the same
roles, counters, trace events, environment variables and HTTP contract.
TTFT-heavy and decode-heavy traffic contend for one card on a unified
replica; here the roles split:

* a **prefill worker** (``--role prefill``) runs the prompt's leading
  ``P`` tokens (``P`` = the prefix cache's bucket_down boundary) through
  its own engine under its lock and extracts the slice on its layout —
  contiguous through `extract_prefix_from_row`, paged through
  `gather_pages` — as ``[L, n, h, d]`` doubling segments;
* **content-addressed page skip**: the decode worker names the leading
  pages it holds by their chained token hashes and the worker ships only
  the rest (``disagg_pages_skipped``, ``disagg_send_pages_skipped``);
* **transport per peer** (``DLT_KV_TRANSPORT`` = auto|device|http): a
  same-process peer hands its tensors on the card over
  (:class:`~..runtime.kv_transport.DeviceKvTransport`), anyone else gets
  the binary payload of ``POST /v1/prefill``;
* the **decode worker** (``--role decode --prefill-peer host:port``)
  inserts the shipped slice into its radix prefix cache
  (`PrefixCache.insert_external`) and the request then takes the
  ordinary admission path — match, splice, resume — which is what makes
  its tokens equal unified serving's. The insert is deferred to the
  engine's device-owning thread (:class:`PendingExternalKv`): the Batcher
  loop at batch > 1, the lock holder at batch 1; the paged insert writes
  the live pool in place, which the decode graphs read;
* **degradation, not failure**: a dead, hung, corrupt or version-skewed
  peer costs the request one local prefill with equal tokens, counted
  (``disagg_degraded``), ledgered (``transfer_retry`` or ``integrity``
  waste) and traced (a ``kv_transfer`` event with ``failed=1``).
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

# the wire codec lives with the rest of the KV movement layer; re-exported
# here under the JAX module's import surface
from ..runtime.kv_transport import (  # noqa: F401 — re-exported API
    KEY_PAGE_TOKENS,
    WIRE_VERSION,
    KvCodecError,
    KvIntegrityError,
    KvVersionError,
    TransferResult,
    build_transports,
    doubling_segments,
    kv_payload,
    matching_pages,
    page_keys,
    parse_kv_payload,
    resolve_transport,
    segment_checksum,
    to_wire,
    transport_for,
    verify_transfer,
    wire_name,
)

ROLES = ("unified", "prefill", "decode")

#: decode->prefill-worker round-trip budget (connect + prefill + transfer);
#: generous because the worker's wall includes real prefill compute
DEFAULT_TIMEOUT_S = 30.0


def resolve_role(explicit=None) -> str:
    """``--role`` flag > ``DLT_ROLE`` env > unified. Unknown values raise:
    a typo'd role silently serving unified would defeat the topology."""
    role = explicit or os.environ.get("DLT_ROLE") or "unified"
    if role not in ROLES:
        raise ValueError(f"unknown serving role {role!r} (one of {ROLES})")
    return role


def resolve_peers(explicit=None) -> list:
    """``--prefill-peer`` (repeatable) > ``DLT_PREFILL_PEER`` (comma-
    separated) > none. Returns ``[(host, port), ...]``."""
    raw = list(explicit) if explicit else [
        s for s in os.environ.get("DLT_PREFILL_PEER", "").split(",") if s.strip()
    ]
    peers = []
    for s in raw:
        host, _, port = s.strip().rpartition(":")
        peers.append((host or "127.0.0.1", int(port)))
    return peers


# -- the prefill-worker side --------------------------------------------------


def prefill_boundary(n_prompt_tokens: int, seq_len: int) -> int:
    """The bucket boundary a disaggregated transfer covers: the largest
    prefix bucket <= the prompt's prefillable span (the last prompt token is
    fed at decode time, exactly like the local publish cap). 0 = the prompt
    is too short to be worth a transfer."""
    from ..runtime.prefix_cache import PREFIX_MIN_TOKENS, bucket_down

    P = bucket_down(max(n_prompt_tokens - 1, 0), seq_len)
    return P if P >= PREFIX_MIN_TOKENS else 0


def run_prefill_arrays(state, ids: list, have_keys=(), trace=None):
    """The prefill-worker core, shared by both transports: prefill
    ``ids[:P]`` under the server's engine lock (riding the worker's own
    prefix cache, so a repeated shared prefix costs one splice), skip the
    leading pages ``have_keys`` proves the requester holds, and extract
    the rest as doubling segments.

    Returns ``(header, segments)``: ``segments`` is ``[(start, k, v),
    ...]`` of new tensors on the worker's device covering tokens ``[S,
    P)`` — the device transport hands them over as they are, the HTTP
    path (:func:`run_prefill`) flattens them into the binary payload.
    Raises ValueError for client errors (too short / too long); an engine
    failure recovers the worker (under the same lock, so on the thread
    that owns its device) and propagates."""
    from ..runtime.graphs import CAPTURE_LOCK
    from ..runtime.prefix_cache import bucket_down, extract_prefix_from_row
    from .api import _on_device

    engine = state.engine
    n = len(ids)
    if n >= engine.cfg.seq_len:
        raise ValueError(
            f"prompt ({n} tokens) exceeds the context window ({engine.cfg.seq_len})"
        )
    P = prefill_boundary(n, engine.cfg.seq_len)
    if P <= 0:
        raise ValueError(
            f"prompt ({n} tokens) below the disaggregation floor"
        )
    expected = page_keys(ids[:P])
    # content-addressed skip: the longest leading run of the requester's
    # page names matching ours, floored to a prefix bucket (so the shipped
    # remainder splits into bucket-length doubling segments) and to the
    # worker's page granularity
    S = matching_pages(expected, have_keys) * KEY_PAGE_TOKENS
    S = bucket_down(S, engine.cfg.seq_len) if S else 0
    if engine.paged and S % engine.page_size != 0:
        S = 0
    # the lock holder owns the worker's device (its chat path is closed);
    # CAPTURE_LOCK keeps this thread off the card while any engine of the
    # process captures a graph (a colocated server's rebuild)
    with state.lock, CAPTURE_LOCK:
        engine = state.engine  # a rebuild may have swapped it
        t0 = time.perf_counter()
        engine.trace = trace
        try:
            with _on_device(engine):
                engine.reset()
                # publish=True: the worker's own radix cache keeps the slice,
                # so the NEXT request sharing this prefix splices instead of
                # re-prefilling — the prefill tier has cache locality too
                engine.prefill(list(ids[:P]))
                segments = []
                if engine.paged:
                    from ..runtime.paged_kv import gather_pages

                    ps = engine.page_size
                    pages = engine.page_pool.row_pages(0, P // ps)
                    for a, b_ in doubling_segments(S, P):
                        B = b_ - a
                        with engine._guard(f"page_extract[{B}]", ("page_extract", B, B)):
                            k, v = gather_pages(engine.cache, pages[a // ps : b_ // ps])
                        segments.append((a, k, v))
                else:
                    with engine._guard(f"prefix_extract[{P}]", ("prefix_extract", P, P)):
                        k, v = extract_prefix_from_row(engine.cache, 0, P)
                    if S > 0:
                        # partial send: only tokens [S, P) leave
                        k = k[:, S:].contiguous()
                        v = v[:, S:].contiguous()
                    segments.append((S, k, v))
                engine._sync()
        except ValueError:
            raise
        except Exception as e:
            state.recover(exc=e)
            raise
        finally:
            engine.trace = None
        wall_us = int((time.perf_counter() - t0) * 1e6)
    engine.stats.incr("disagg_prefills")
    engine.stats.incr("disagg_prefill_tokens", P - S)
    if S:
        engine.stats.incr("disagg_send_pages_skipped", S // KEY_PAGE_TOKENS)
    header = {
        "v": WIRE_VERSION,
        "tokens": [int(t) for t in ids[:P]],
        "p": P,
        "start": S,
        "page_tokens": KEY_PAGE_TOKENS,
        "page_keys": [format(h, "x") for h in expected],
        "prefill_us": wall_us,
    }
    return header, segments


def run_prefill(state, ids: list, have=(), trace=None) -> bytes:
    """The ``POST /v1/prefill`` body builder — the HTTP transport's worker
    half: run the shared core and flatten its segments into ONE binary
    payload (length-prefixed JSON header + raw k + raw v, covering tokens
    ``[start, P)``)."""
    from ..runtime.graphs import CAPTURE_LOCK

    header, segments = run_prefill_arrays(
        state, ids, have_keys=have, trace=trace
    )
    # the device-to-host copy of the slice, off the device-owning thread:
    # never beside a capture
    with CAPTURE_LOCK:
        ks = [to_wire(k) for _, k, _ in segments]
        vs = [to_wire(v) for _, _, v in segments]
    k_np = np.concatenate(ks, axis=1) if len(ks) > 1 else ks[0]
    v_np = np.concatenate(vs, axis=1) if len(vs) > 1 else vs[0]
    # per-doubling-segment checksums over the CONCATENATED slice: layout-
    # independent (contiguous extract ships one segment, paged ships the
    # ladder — the receiver recomputes the same spans either way)
    S = int(header["start"])
    spans = doubling_segments(S, int(header["p"]))
    header = dict(
        header,
        k_shape=list(k_np.shape),
        v_shape=list(v_np.shape),
        dtype=wire_name(k_np),
        k_sums=[
            format(segment_checksum(k_np[:, a - S : b - S].tobytes()), "x")
            for a, b in spans
        ],
        v_sums=[
            format(segment_checksum(v_np[:, a - S : b - S].tobytes()), "x")
            for a, b in spans
        ],
    )
    return kv_payload(header, k_np, v_np)


# -- the decode-worker side ---------------------------------------------------


class PendingExternalKv:
    """A fetched-but-not-yet-inserted KV slice. The insert must run on the
    engine's device-owning thread (a paged insert scatters into the live
    pool, which a handler thread must never race with the Batcher's
    dispatches), so the fetch defers it here: the Batcher applies it right
    before the request's admission; the serialized path applies it inline
    under the engine lock. ``base_entry`` stays pinned until applied."""

    def __init__(self, client, tokens, k, v, start, base_entry, path):
        self.client = client
        self.engine = client.engine  # the engine the pin belongs to
        self.tokens = tokens
        self.k = k  # array or per-segment list (kv_transport doubling order)
        self.v = v
        self.start = start
        self.base_entry = base_entry
        self.path = path
        self._applied = False

    def apply(self, state) -> bool:
        """Insert into the local prefix cache; idempotent. On refusal the
        request simply cold-prefills (counted; the transferred bytes were
        wasted — ledgered as transfer_retry so the loss is visible)."""
        if self._applied:
            return True
        self._applied = True
        engine = state.engine
        pc = engine.prefix_cache
        if self.engine is not engine:
            # a rebuild swapped the engine since the fetch: the pin (and
            # the pages it names) belonged to the old one; the request
            # prefills locally
            self.abandon()
            return False
        try:
            ok = pc.insert_external(
                engine, self.tokens, self.k, self.v, start=self.start,
                base_entry=self.base_entry,
            )
        finally:
            if self.base_entry is not None:
                pc.entry_release(self.base_entry)
            self.base_entry = None
        if not ok:
            engine.stats.incr("disagg_insert_failed")
            state.goodput.add_waste(
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


class DisaggClient:
    """The decode worker's prefill-tier client: one bounded fetch per
    request over the per-peer transport (device when reachable, the HTTP
    codec otherwise — runtime/kv_transport.py), degraded to local prefill
    on ANY failure — a dead peer must cost this request one timeout, never
    an error. Peers rotate round-robin with in-request failover (the next
    peer is tried before degrading), and a FAILED peer enters a backoff
    window (``DLT_DISAGG_PEER_BACKOFF_S``, default 10 s) during which
    requests skip it — without this, a hung worker (accepts TCP, never
    answers) would add the full fetch timeout to EVERY request's TTFT
    until an operator intervened. With every peer backing off, requests
    prefill locally immediately (counted, no waste: no prefill-tier
    compute was spent). A successful fetch clears the peer's backoff.

    **Corrupt-peer quarantine** (the poison-request idiom rotated 90°):
    a transfer that arrives complete but WRONG — checksum mismatch,
    page_keys echo disagreement, garbage codec — is an integrity
    rejection, not a transport failure: the slice never touches the
    cache, the request degrades (or fails over) exactly as above, and
    the PEER takes a strike. ``DLT_KV_INTEGRITY_STRIKES`` strikes inside
    the ``DLT_KV_INTEGRITY_TTL_S`` redemption window drop the peer from
    rotation (composing with the fail-stop backoff — a peer can be both);
    the TTL expiring redeems it, so a transient corruptor (bad NIC since
    replaced, one stale process since restarted) is not banned forever.
    The ledger rides :meth:`snapshot` into ``/stats`` and — via the fleet
    scraper — ``/gateway/fleet``, so operators see WHICH replica emits
    garbage. A peer speaking an unknown wire version is skipped without a
    strike (``disagg_peer_version_mismatch``): mixed versions mean a
    rolling deploy, not corruption."""

    def __init__(self, state, peers, timeout_s: float | None = None,
                 backoff_s: float | None = None, transport: str | None = None,
                 integrity_strikes: int | None = None,
                 strike_ttl_s: float | None = None):
        self.state = state
        self.engine = state.engine
        self.peers = list(peers)
        if timeout_s is None:
            try:
                timeout_s = float(
                    os.environ.get("DLT_DISAGG_TIMEOUT_S", DEFAULT_TIMEOUT_S)
                )
            except ValueError:
                timeout_s = DEFAULT_TIMEOUT_S
        self.timeout_s = timeout_s
        if backoff_s is None:
            try:
                backoff_s = float(
                    os.environ.get("DLT_DISAGG_PEER_BACKOFF_S", 10.0)
                )
            except ValueError:
                backoff_s = 10.0
        self.backoff_s = backoff_s
        if integrity_strikes is None:
            try:
                integrity_strikes = int(
                    os.environ.get("DLT_KV_INTEGRITY_STRIKES", 3)
                )
            except ValueError:
                integrity_strikes = 3
        self.integrity_strikes = max(integrity_strikes, 1)
        if strike_ttl_s is None:
            try:
                strike_ttl_s = float(
                    os.environ.get("DLT_KV_INTEGRITY_TTL_S", 300.0)
                )
            except ValueError:
                strike_ttl_s = 300.0
        self.strike_ttl_s = strike_ttl_s
        self.transport = resolve_transport(transport)
        self.transports = build_transports(self.timeout_s)
        self._lock = threading.Lock()
        self._rr = 0
        self._backoff_until: dict = {}  # (host, port) -> monotonic deadline
        # the integrity strike ledger: (host, port) -> (count, ttl deadline).
        # Bounded by construction — keys come from self.peers only, and an
        # expired entry is pruned on its next read (TTL redemption).
        self._strikes: dict = {}

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
            "peers": [f"{h}:{p}" for h, p in self.peers],
            "timeout_s": self.timeout_s,
            "peer_backoff_s": self.backoff_s,
            "peers_backing_off": backing_off,
            "transport": self.transport,
            "peer_transports": {
                f"{h}:{p}": transport_for(
                    self.transport, (h, p), self.transports
                ).path
                for h, p in self.peers
            },
            "integrity": {
                "strikes_limit": self.integrity_strikes,
                "strike_ttl_s": self.strike_ttl_s,
                "peer_strikes": peer_strikes,
                "peers_struck_out": struck_out,
            },
        }

    def _peer_usable(self, peer) -> bool:
        now = time.monotonic()
        with self._lock:
            if self._backoff_until.get(peer, 0.0) > now:
                return False
            entry = self._strikes.get(peer)
            if entry is None:
                return True
            count, ttl = entry
            if ttl <= now:  # TTL redemption: the ban (and count) expires
                del self._strikes[peer]
                return True
            return count < self.integrity_strikes

    def _peer_failed(self, peer):
        with self._lock:
            self._backoff_until[peer] = time.monotonic() + self.backoff_s

    def _peer_strike(self, peer) -> int:
        """One integrity rejection = one strike; the TTL window restarts
        with each strike, so a steadily corrupting peer stays out."""
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

    def _skip_base(self, ids, covered, entry):
        """(start, base_entry STILL PINNED or None, have_keys) — the
        content-addressed skip claim from a `match_pinned` result: the
        verified leading span floored to a prefix bucket of whole
        key-pages. Releases the pin itself (returning None) when the local
        cache holds nothing usable as a merge base."""
        from ..runtime.prefix_cache import bucket_down

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

    def fetch(self, ids: list, trace=None) -> dict:
        """Try to land ``ids``' leading-bucket KV ahead of admission.
        Returns the ledger walls ``{remote_prefill_us, kv_transfer_us,
        kv_transfer_path, transferred_tokens, pages_skipped}`` plus, under
        ``"pending_kv"``, the deferred insert the engine thread must apply
        (:class:`PendingExternalKv`; absent on local-hit/degraded paths).
        Zeros whenever the request proceeds on local prefill (short
        prompt, local cache already warm, or a degraded transfer). Never
        raises."""
        out = {
            "remote_prefill_us": 0, "kv_transfer_us": 0,
            "kv_transfer_path": "", "transferred_tokens": 0,
            "pages_skipped": 0, "pending_kv": None,
        }
        engine = self.engine
        pc = engine.prefix_cache
        if pc is None or not self.peers:
            return out
        P = prefill_boundary(len(ids), engine.cfg.seq_len)
        if P <= 0:
            return out
        # ONE trie walk, entry pinned under the match's own lock hold —
        # pool pressure must never evict-and-recycle the merge base's
        # pages between the lookup and the insert that names them
        covered, matched = pc.match_pinned(ids[:P])
        if matched is not None and covered >= P:
            # the local cache already holds the span (an earlier transfer,
            # or plain cross-request reuse): nothing to ship
            pc.entry_release(matched)
            engine.stats.incr("disagg_local_hits")
            return out
        usable = [p for p in self.peers if self._peer_usable(p)]
        if not usable:
            # every peer is in its failure-backoff window: prefill locally
            # NOW instead of burning a timeout per request on known-bad
            # peers. Not waste — no prefill-tier compute was spent.
            if matched is not None:
                pc.entry_release(matched)
            engine.stats.incr("disagg_peer_backoff_skips")
            return out
        S, base_entry, have = self._skip_base(ids, covered, matched)
        t0 = time.perf_counter()
        result = None
        peer_key = None
        err = None
        rejected_peer = None  # last integrity-rejected peer (one trace event)
        rejected_err = ""
        with self._lock:
            start = self._rr
            self._rr = (self._rr + 1) % len(usable)
        for i in range(len(usable)):
            peer = usable[(start + i) % len(usable)]
            host, port = peer
            tr_impl = transport_for(self.transport, peer, self.transports)
            try:
                # ship ids[:P+1]: the worker derives the SAME boundary from
                # the same formula (bucket_down over len-1), so its slice
                # covers exactly ids[:P] — truncating at P would make the
                # worker floor one bucket lower
                got = tr_impl.fetch(
                    peer, ids[: P + 1], have_keys=have,
                    trace_id=None if trace is None else trace.id,
                )
                # THE integrity gate: checksums + page_keys echo (http) /
                # metadata (device) verified BEFORE the slice can reach
                # insert_external — a passing result is the only kind the
                # rest of this function ever sees
                verify_transfer(got, ids, P)
                result = got
                peer_key = f"{host}:{port}"
                self._peer_ok(peer)
                engine.stats.incr("kv_integrity_verified")
                break
            except KvVersionError as e:
                # the peer is healthy, just mid-rolling-deploy on another
                # wire version: skip it for this request — no strike, no
                # backoff (it would quarantine an innocent replica)
                err = e
                engine.stats.incr("disagg_peer_version_mismatch")
            except KvCodecError as e:
                # complete response, wrong content: corruption. Reject
                # before the cache is touched and strike the PEER — enough
                # strikes inside the TTL drop it from rotation entirely.
                err = e
                engine.stats.incr("kv_integrity_rejected")
                rejected_peer = f"{host}:{port}"
                rejected_err = f"{type(e).__name__}: {e}"
                self._peer_strike(peer)
            except Exception as e:
                # OSError: refused/reset/timeout; HTTPException covers
                # mid-body deaths; the device path raises the same
                # families. A fail-stop transfer failure is a peer failure,
                # never a request failure — the degradation contract
                # (counted below, the error rides the kv_transfer event).
                err = e
                engine.stats.incr("disagg_peer_errors")
                self._peer_failed(peer)
        pending = None
        if result is not None:
            try:
                header = result.header
                tokens = [int(t) for t in header["tokens"]]
                if tokens != [int(t) for t in ids[:P]]:
                    raise ValueError("peer returned KV for different tokens")
                r_start = int(header.get("start", 0))
                if r_start != S:
                    # the worker floored differently (defensive path); a
                    # full send is still insertable, anything else is not
                    if r_start == 0:
                        if base_entry is not None:
                            pc.entry_release(base_entry)
                        base_entry = None
                        S = 0
                    else:
                        raise ValueError(
                            f"peer shipped start={r_start}, asked {S}"
                        )
                pending = PendingExternalKv(
                    self, tokens, result.k, result.v, S, base_entry, result.path
                )
                base_entry = None  # ownership moved to the pending insert
                out["remote_prefill_us"] = int(header.get("prefill_us", 0))
                out["transferred_tokens"] = P - S
                out["pages_skipped"] = S // KEY_PAGE_TOKENS
            except (ValueError, KeyError, TypeError) as e:
                err = e
                pending = None
        if base_entry is not None:
            pc.entry_release(base_entry)
        from ..runtime.tracing import to_us

        wall_us = int((time.perf_counter() - t0) * 1e6)
        if rejected_peer is not None and trace is not None:
            # ONE event per fetch, outside the peer loop (trace-hot-emit
            # lint), landed even unsampled AND even when failover to a
            # clean peer saved the request: a corrupting replica must be
            # reconstructable from any trace that touched it
            trace.event(
                "kv_integrity", to_us(t0), wall_us,
                ("peer", "outcome", "error"),
                (rejected_peer, "rejected", rejected_err),
                always=True,
            )
        if pending is not None:
            # the transfer share of the wall: the fetch blocks on the
            # worker's prefill too, which the worker reports separately.
            # Per-path accounting: the labeled dlt_kv_transfer_us series
            # and dlt_kv_transfer_bytes_total{path=...} counters are what
            # the device-vs-http bench bar reads.
            path = pending.path
            transfer_us = max(wall_us - out["remote_prefill_us"], 0)
            out["kv_transfer_us"] = transfer_us
            out["kv_transfer_path"] = path
            out["pending_kv"] = pending
            engine.stats.incr("disagg_kv_fetched")
            engine.stats.incr("disagg_kv_tokens", P - S)
            if out["pages_skipped"]:
                engine.stats.incr("disagg_pages_skipped", out["pages_skipped"])
            engine.stats.record(f"kv_transfer_us[{path}]", transfer_us)
            engine.stats.incr(f"kv_transfer_bytes_{path}", result.nbytes)
            if trace is not None:
                trace.event(
                    "kv_transfer", to_us(t0), wall_us,
                    ("peer", "tokens", "failed", "path", "pages_skipped"),
                    (peer_key, P - S, 0, path, out["pages_skipped"]),
                )
        else:
            # DEGRADE to local prefill: the request must complete (token-
            # identical — it simply takes the unified path). Counted,
            # ledgered as waste (the P tokens the prefill tier computed —
            # or would have — now re-prefill locally), and traced even
            # unsampled so a chaos kill is reconstructable. The waste
            # reason splits the why: `integrity` when the last failure was
            # a complete-but-corrupt response, `transfer_retry` for the
            # fail-stop families (dead peer, version skew, mid-body death).
            engine.stats.incr("disagg_degraded")
            engine.stats.incr("disagg_degraded_tokens", P)
            reason = (
                "integrity"
                if isinstance(err, KvCodecError)
                and not isinstance(err, KvVersionError)
                else "transfer_retry"
            )
            self.state.goodput.add_waste(reason, P)
            if trace is not None:
                trace.event(
                    "kv_transfer", to_us(t0), wall_us,
                    ("peer", "tokens", "failed", "error"),
                    (
                        peer_key or "none", P, 1,
                        "" if err is None else f"{type(err).__name__}: {err}",
                    ),
                    always=True,
                )
        return out
