"""Poison-request quarantine: one bad request must never take down a fleet.

The JAX package's `server/quarantine.py`, copied whole for the port
(stdlib only; it imports the port's copy of the router's hash).

The gateway's zero-byte transparent retry assumes a failed attempt
says something about the *backend*: the request was innocent, the replica
was not, so replaying the bytes elsewhere is free. A **poison request**
inverts that — a pathological body that wedges or crashes whatever engine
it lands on (a tokenizer edge case, a shape the warm ladder missed, a
grammar bomb). The retry machinery then becomes the attack's fan-out: the
gateway faithfully replays the same bytes into replica after replica, each
one stalling or entering recovery, until the whole fleet is down and the
breaker map is a wall of OPEN.

The quarantine breaks that loop with a strike ledger over request
**fingerprints**:

* the fingerprint is the FNV-1a hash of the request's full messages text
  (:func:`request_fingerprint`) — the same chained-hash machinery the
  router's prefix keys use (server/router.py), extended over the whole
  body so only byte-identical conversations share a fingerprint (two
  requests sharing a system prompt must never share a quarantine fate);
* every stall/crash/recovery event a fingerprint is implicated in is a
  **strike**: the gateway strikes on each proxy attempt that died with
  the request IN FLIGHT (zero-byte or midstream death after the bytes
  reached the replica — a connect-level refusal never strikes; the
  request never touched an engine) and on each forwarded 5xx that NAMES
  the fingerprint, and replicas strike when an engine failure kills the
  request server-side — reporting the fingerprint in the 5xx response
  (``X-DLT-Poison-Fp``) and in ``/health`` so direct clients and
  dashboards see the attribution. A plain 503 is never evidence: landing
  on an overloaded or rebuilding replica is not the request's fault;
* at ``limit`` strikes (``DLT_QUARANTINE_STRIKES``, default 2) the
  fingerprint is **quarantined**: the gateway stops retrying it and
  returns a terminal ``422`` (a client error — the request is the
  problem), and replicas refuse it outright before it can touch the
  engine. The waste it already caused is labeled ``quarantined`` in the
  goodput ledger (``dlt_wasted_tokens_total{reason="quarantined"}``).

The ledger is a bounded LRU (``DLT_QUARANTINE_SIZE``) with per-entry
expiry (``DLT_QUARANTINE_TTL_S``): a fingerprint that stops failing ages
out — a once-bad request must not be damned forever (the engine rebuild
that fixed the ladder hole also un-poisons the request).

Strike evidence is a heuristic — at the gateway, a crash-during-my-request
and a crash-because-of-my-request are indistinguishable from the wire
alone. The gateway therefore DISCOUNTS transport-death evidence from a
backend the fleet already knew was sick when the attempt died: breaker
not closed, fleet-table row gone stale, or the backend draining
(autoscaler or operator). Correlated replica deaths during a rolling
drain or a partial outage no longer terminally 422 an innocent
conversation (a documented trade-off, resolved); a replica
NAMING the fingerprint (``X-DLT-Poison-Fp``) always strikes — that is
first-hand engine evidence, not a wire guess. The residual exposure —
two UNcorrelated hard kills of fresh, healthy replicas inside one TTL
window with the same innocent body in flight — is bounded by the TTL.
Stdlib-only.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict

from .router import _FNV64_OFFSET, fnv1a

#: response header a replica reports the implicated fingerprint on when an
#: engine failure kills a request (hex; rides the 5xx back to the gateway
#: and direct clients)
POISON_HEADER = "X-DLT-Poison-Fp"


def request_fingerprint(text: str | None) -> int | None:
    """The quarantine identity of one chat request: FNV-1a over the FULL
    messages text (server/router.py ``messages_prefix_text`` — the one
    hash-text function both gateway and replica share). Unlike the router's
    block-chained prefix keys this covers every byte including the tail:
    requests are quarantined for what they ARE, not what they share."""
    if not text:
        return None
    return fnv1a(text.encode("utf-8", errors="replace"), _FNV64_OFFSET)


def fp_hex(fp: int) -> str:
    return f"{fp:016x}"


def parse_fp_hex(raw: str | None) -> int | None:
    try:
        return int(raw, 16) if raw else None
    except (TypeError, ValueError):
        return None


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


class QuarantineLedger:
    """Bounded, expiring strike counts per request fingerprint.

    One instance per gateway (strikes from the retry loop) and one per
    replica (strikes from engine-failure attribution); both run the same
    policy so a direct client and a routed client see the same verdict.
    Every method is one lock hold around a dict touch — per REQUEST, never
    per token."""

    def __init__(self, limit: int | None = None, size: int | None = None,
                 ttl_s: float | None = None):
        self.limit = limit if limit is not None else _env_int(
            "DLT_QUARANTINE_STRIKES", 2
        )
        self.size = size if size is not None else _env_int(
            "DLT_QUARANTINE_SIZE", 4096
        )
        self.ttl_s = ttl_s if ttl_s is not None else _env_float(
            "DLT_QUARANTINE_TTL_S", 600.0
        )
        self._lock = threading.Lock()
        # fp -> (strikes, last_strike_monotonic); LRU order = strike order
        self._strikes: "OrderedDict[int, tuple]" = OrderedDict()
        self.quarantined_total = 0   # fingerprints that crossed the limit
        self.strikes_total = 0

    def _fresh_locked(self, fp: int, now: float) -> int:
        ent = self._strikes.get(fp)
        if ent is None:
            return 0
        strikes, last = ent
        if now - last > self.ttl_s:
            del self._strikes[fp]
            return 0
        return strikes

    def strike(self, fp: int | None, n: int = 1) -> int:
        """Record ``n`` implication events; returns the fingerprint's
        fresh strike count (0 for None fingerprints — unparsable bodies
        have nothing to quarantine; the 400 path owns those)."""
        if fp is None:
            return 0
        now = time.monotonic()
        with self._lock:
            strikes = self._fresh_locked(fp, now) + n
            crossed = (
                self.limit > 0
                and strikes >= self.limit
                and strikes - n < self.limit
            )
            self._strikes[fp] = (strikes, now)
            self._strikes.move_to_end(fp)
            while len(self._strikes) > self.size:
                self._strikes.popitem(last=False)
            self.strikes_total += n
            if crossed:
                self.quarantined_total += 1
        return strikes

    def is_quarantined(self, fp: int | None) -> bool:
        if fp is None or self.limit <= 0:
            # limit <= 0 DISABLES quarantining (the documented semantics
            # of DLT_QUARANTINE_STRIKES=0) — without this guard a zero
            # limit would invert into quarantine-EVERYTHING (0 strikes >=
            # limit 0), a 100% outage from the off switch
            return False
        now = time.monotonic()
        with self._lock:
            return self._fresh_locked(fp, now) >= self.limit

    def strikes(self, fp: int | None) -> int:
        if fp is None:
            return 0
        with self._lock:
            return self._fresh_locked(fp, time.monotonic())

    # -- crash-only recovery (server/recovery.py) ---------------------------

    def dump(self) -> dict:
        """The ``GET /debug/quarantine`` payload: EVERY fresh entry (not
        just the snapshot's top-N) with its age, so a warm-restarting
        gateway can re-learn strike ledgers — and in-force 422s — from the
        fleet with TTL-correct remaining lifetimes."""
        now = time.monotonic()
        with self._lock:
            entries = [
                {"fp": fp_hex(fp), "strikes": s, "age_s": round(now - last, 3)}
                for fp, (s, last) in self._strikes.items()
                if now - last <= self.ttl_s
            ]
        return {"limit": self.limit, "ttl_s": self.ttl_s, "entries": entries}

    def prime(self, fp: int | None, strikes: int, age_s: float = 0.0) -> None:
        """Seed one recovered entry: the count becomes ``max(existing,
        strikes)`` (idempotent — recovery may merge several sources) and
        the strike clock is backdated by ``age_s`` so a recovered entry
        expires when the original would have, not TTL-from-restart."""
        if fp is None or strikes <= 0:
            return
        now = time.monotonic()
        at = now - max(age_s, 0.0)
        if now - at > self.ttl_s:
            return  # already expired at the source — nothing to recover
        with self._lock:
            existing = self._fresh_locked(fp, now)
            crossed = (
                self.limit > 0 and strikes >= self.limit
                and existing < self.limit
            )
            if strikes <= existing:
                return
            self._strikes[fp] = (strikes, at)
            self._strikes.move_to_end(fp)
            while len(self._strikes) > self.size:
                self._strikes.popitem(last=False)
            if crossed:
                self.quarantined_total += 1

    def snapshot(self, top_n: int = 16) -> dict:
        """The operator view (``/stats`` quarantine section; ``/health``
        carries the quarantined keys): hottest implicated fingerprints as
        hex, strike-count descending."""
        now = time.monotonic()
        with self._lock:
            live = [
                (fp, s) for fp, (s, last) in self._strikes.items()
                if now - last <= self.ttl_s
            ]
            live.sort(key=lambda kv: kv[1], reverse=True)
            return {
                "limit": self.limit,
                "ttl_s": self.ttl_s,
                "tracked": len(live),
                "strikes_total": self.strikes_total,
                "quarantined_total": self.quarantined_total,
                "implicated": [
                    {
                        "fp": fp_hex(fp), "strikes": s,
                        "quarantined": s >= self.limit,
                    }
                    for fp, s in live[:top_n]
                ],
            }
