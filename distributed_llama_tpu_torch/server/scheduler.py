"""SLO-class scheduling: admission quotas, queue priorities, and
preemption policy for the serving tier.

The JAX package's `server/scheduler.py`, copied whole for the port
(stdlib only).

The serving tier built the *sensors* (per-replica signal table, goodput ledger,
SLO attainment) and one *actuator* (cache-aware routing); this module is
the policy half of the control plane that closes the loop. The Batcher
(server/api.py) already knows *how* to park and shed — pool-exhaustion
park/shed, ``max_backlog`` 503s — but treated every request identically.
Real fleets don't: an interactive chat turn, a standard API call, and an
overnight batch job have different latency contracts, and under pressure
the scheduler must know *whom* to delay, shed, or preempt.

Three SLO classes, requested per call (``slo_class`` in the ``/v1/chat``
body, or the ``X-DLT-SLO-Class`` header — which the gateway forwards
byte-transparently, so one client header rides retries and routing):

* ``interactive`` — tightest TTFT contract; admitted first, never the
  preferred shed victim;
* ``standard``    — the default; the pre-SLO-class behavior;
* ``batch``       — throughput traffic; capped backlog share (admission
  quota), first in line for shedding, and preemptible by waiting
  interactive traffic.

The policy core here is deliberately **engine-independent and
stdlib-only**: the real Batcher drives it against live engines, and the
fleet load twin (server/loadtwin.py) drives the SAME code against stub
replicas — so scheduler changes are CI-testable at 10-50-replica scale
without accelerators.

Every decision is counted by ``(class, action)`` and exported as
``dlt_scheduler_decisions_total{class=...,action=...}`` on ``/metrics``
(zero-valued combinations always render), mirrored as batch-timeline
marks, and reflected per class in the goodput ledger
(``dlt_goodput_tokens_per_s{slo_class=...}``,
``dlt_wasted_tokens_total{reason=...,slo_class=...}``).
"""

from __future__ import annotations

import collections
import os
import threading

#: priority order: earlier = higher priority (admitted first, shed last)
SLO_CLASSES = ("interactive", "standard", "batch")
DEFAULT_CLASS = "standard"
#: rank by class name; lower rank = higher priority
CLASS_RANK = {c: i for i, c in enumerate(SLO_CLASSES)}

#: request header carrying the class end-to-end (the gateway forwards all
#: client headers byte-transparently, retries included)
SLO_CLASS_HEADER = "X-DLT-SLO-Class"

#: end-to-end deadline header: milliseconds of budget remaining, minted at
#: the gateway (client header or the class default below) and re-stamped
#: with the REMAINING budget on every retry attempt — so the deadline is
#: one clock across routing, retries, and the replica's Batcher, without
#: ever shipping an absolute timestamp between unsynchronized hosts
DEADLINE_HEADER = "X-DLT-Deadline-Ms"

#: class scaling applied to DLT_DEFAULT_DEADLINE_MS when no per-class env
#: overrides: an interactive request's answer is worthless sooner than a
#: batch job's — the deadline composes with the SLO class, it doesn't
#: flatten it
DEADLINE_CLASS_SCALE = {"interactive": 0.5, "standard": 1.0, "batch": 4.0}

#: every env that can mint a deadline WITHOUT a client header — the
#: gateway checks these to skip chat-body parsing entirely when no
#: consumer (router, quarantine, deadline) is enabled
DEADLINE_ENVS = ("DLT_DEFAULT_DEADLINE_MS",) + tuple(
    f"DLT_DEADLINE_MS_{c.upper()}" for c in SLO_CLASSES
)


def resolve_deadline_ms(klass: str, client_value=None) -> int:
    """The deadline budget (ms) one request rides with; 0 = no deadline
    (the default — deadlines are opt-in via the client header or
    ``DLT_DEFAULT_DEADLINE_MS``). Resolution order: the client's own
    header (clamped positive), then ``DLT_DEADLINE_MS_<CLASS>``, then
    ``DLT_DEFAULT_DEADLINE_MS`` scaled by the class's
    :data:`DEADLINE_CLASS_SCALE` factor."""
    if client_value is not None:
        try:
            ms = int(float(client_value))
            if ms > 0:
                return ms
        except (TypeError, ValueError):
            pass  # a garbage header degrades to the configured default,
            # never fails the request (the resolve_slo_class discipline)
    klass = resolve_slo_class(klass)
    per_class = os.environ.get(f"DLT_DEADLINE_MS_{klass.upper()}")
    if per_class is not None:
        try:
            return max(int(float(per_class)), 0)
        except ValueError:
            pass
    default = _env_float("DLT_DEFAULT_DEADLINE_MS", 0.0)
    if default <= 0:
        return 0
    return max(int(default * DEADLINE_CLASS_SCALE.get(klass, 1.0)), 1)

#: every action ``dlt_scheduler_decisions_total`` is labeled with:
#: * ``admit``        — a request entered a batch slot;
#: * ``shed_backlog`` — turned away at admission (total backlog cap or the
#:                      class's quota share exceeded) with 503+Retry-After;
#: * ``shed_pool``    — an in-flight row shed under KV page-pool pressure;
#: * ``preempt``      — an in-flight lower-class row evicted so a waiting
#:                      higher-class request could take its slot;
#: * ``park``         — an admission parked on pool pressure (will retry).
SCHED_ACTIONS = ("admit", "shed_backlog", "shed_pool", "preempt", "park")


def resolve_slo_class(raw) -> str:
    """Normalize a requested class (header or body value); anything
    unknown — or absent — is ``standard``: a typo'd class must degrade to
    the default contract, never fail the request or grant priority."""
    if isinstance(raw, str):
        k = raw.strip().lower()
        if k in CLASS_RANK:
            return k
    return DEFAULT_CLASS


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class SchedulerConfig:
    """Per-class admission quotas (share of ``max_backlog`` a class may
    occupy, ``DLT_SLO_QUOTA_<CLASS>``) and the preemption switch
    (``DLT_SLO_PREEMPT``, default on). Defaults: interactive and standard
    may fill the whole backlog; batch is capped at half of it, so a batch
    flood can never consume the queue ahead of latency-bound traffic."""

    def __init__(self, quotas: dict | None = None, preempt: bool | None = None):
        base = {"interactive": 1.0, "standard": 1.0, "batch": 0.5}
        for c in SLO_CLASSES:
            base[c] = _env_float(f"DLT_SLO_QUOTA_{c.upper()}", base[c])
        if quotas:
            base.update(quotas)
        self.quotas = {c: max(0.0, min(1.0, base[c])) for c in SLO_CLASSES}
        if preempt is None:
            preempt = os.environ.get("DLT_SLO_PREEMPT", "1") not in ("0", "")
        self.preempt = bool(preempt)

    def snapshot(self) -> dict:
        return {"quotas": dict(self.quotas), "preempt": self.preempt}


class ClassQueues:
    """Per-class FIFO backlog with priority pop: interactive drains before
    standard drains before batch; within a class, arrival order holds.
    Thread-compat with the old plain deque: ``len()``/truthiness are the
    total depth, so existing ``queue_depth`` readers keep working."""

    def __init__(self):
        self._q = {c: collections.deque() for c in SLO_CLASSES}

    def append(self, item, klass: str = DEFAULT_CLASS):
        self._q[resolve_slo_class(klass)].append(item)

    def popleft(self):
        """Highest-priority non-empty class's oldest item."""
        for c in SLO_CLASSES:
            if self._q[c]:
                return self._q[c].popleft()
        raise IndexError("pop from empty ClassQueues")

    def peek_class(self) -> str | None:
        """Class of the item ``popleft`` would return (None when empty)."""
        for c in SLO_CLASSES:
            if self._q[c]:
                return c
        return None

    def remove(self, item, klass: str = DEFAULT_CLASS) -> None:
        """Withdraw a queued item (a waiter that timed out or died) —
        raises ValueError when absent, like deque.remove."""
        self._q[resolve_slo_class(klass)].remove(item)

    def depth(self, klass: str) -> int:
        return len(self._q[resolve_slo_class(klass)])

    def depths(self) -> dict:
        return {c: len(self._q[c]) for c in SLO_CLASSES}

    def __len__(self) -> int:
        return sum(len(q) for q in self._q.values())

    def __iter__(self):
        for c in SLO_CLASSES:
            yield from self._q[c]


class SloScheduler:
    """The per-replica scheduling policy + decision counters. One instance
    per Batcher (and per stub replica in the load twin); every method is a
    host-side dict/deque touch — nothing here goes near the device."""

    def __init__(self, config: SchedulerConfig | None = None):
        self.config = config or SchedulerConfig()
        self._lock = threading.Lock()
        self.decisions = {
            (c, a): 0 for c in SLO_CLASSES for a in SCHED_ACTIONS
        }

    # -- decisions -----------------------------------------------------------

    def record(self, klass: str, action: str, n: int = 1):
        key = (resolve_slo_class(klass), action)
        with self._lock:
            self.decisions[key] = self.decisions.get(key, 0) + n

    def decisions_series(self) -> list:
        """``[(labels, value), ...]`` for the labeled counter family —
        every (class, action) combination present, zeros included, so
        dashboards never see a series appear from nowhere mid-incident."""
        with self._lock:
            d = dict(self.decisions)
        return [
            ({"class": c, "action": a}, d.get((c, a), 0))
            for c in SLO_CLASSES
            for a in SCHED_ACTIONS
        ]

    def decisions_snapshot(self) -> dict:
        with self._lock:
            return {f"{c}:{a}": v for (c, a), v in self.decisions.items() if v}

    # -- admission -----------------------------------------------------------

    def admission_allowed(self, klass: str, queues: ClassQueues,
                          max_backlog: int, extra_depth: int = 0) -> bool:
        """May a new ``klass`` request join the backlog? False on the total
        cap (the pre-class behavior) OR on the class's own quota share —
        a batch flood saturating its share must not consume queue slots
        latency-bound classes would have used. ``extra_depth`` counts this
        class's accepted-but-not-yet-queued submissions (the Batcher's
        self.q race window), so a concurrent burst cannot slip past the
        quota before the loop drains it."""
        klass = resolve_slo_class(klass)
        if len(queues) + extra_depth >= max_backlog:
            return False
        cap = self.config.quotas[klass] * max_backlog
        if cap <= 0:
            return False  # quota 0 means BLOCKED, not one-in-flight —
            # the operator's kill switch for a class during an incident
        return queues.depth(klass) + extra_depth < max(cap, 1)

    # -- victim selection ----------------------------------------------------

    @staticmethod
    def shed_victim(rows) -> int:
        """Whom to shed under pool pressure: ``rows`` is a non-empty list
        of ``(row, klass, progress_tokens)``; returns the chosen row.
        Policy: LOWEST class first (batch before standard before
        interactive), then LEAST progress (the cheapest work to discard),
        then the highest row index (matches the old ``-r`` tiebreak)."""
        return min(
            rows,
            key=lambda t: (-CLASS_RANK.get(t[1], CLASS_RANK[DEFAULT_CLASS]),
                           t[2], -t[0]),
        )[0]

    def preempt_victim(self, waiting_klass: str, rows):
        """Whom to preempt so a waiting ``waiting_klass`` request can take
        a slot: the lowest-class least-progress row whose class is STRICTLY
        below the waiter's (standard never preempts standard; preemption
        off disables entirely). Returns a row index or None."""
        if not self.config.preempt or not rows:
            return None
        wrank = CLASS_RANK.get(resolve_slo_class(waiting_klass), 1)
        eligible = [
            t for t in rows
            if CLASS_RANK.get(t[1], CLASS_RANK[DEFAULT_CLASS]) > wrank
        ]
        if not eligible:
            return None
        return self.shed_victim(eligible)

    def snapshot(self) -> dict:
        return {
            "config": self.config.snapshot(),
            "decisions": self.decisions_snapshot(),
        }


class HotPrefixTracker:
    """Bounded hit counts over the router's chained prefix keys — the
    replica-side half of the **warm drain handoff**: the gateway's
    autoscaler fetches ``GET /debug/hot_prefixes`` from a replica it is
    about to drain and re-homes the listed chains' affinity BEFORE the
    replica disappears, so shared-prefix traffic concentrates on ONE new
    home instead of spraying cold across the fleet.

    The keys are the SAME 64-char-block FNV-1a chain hashes the router's
    locality map learns (server/router.py ``prefix_chain``), computed
    replica-side over the chat messages text — so the snapshot's keys are
    directly re-homeable without any token-to-text mapping. Bounded LRU;
    one lock hold per request (never per token).

    Each chain also carries the KV footprint it resolves to — pages and
    STORED-WIDTH bytes (int8-quantized caches report quantized bytes, not
    the compute-dtype size), attached by the completion path once the
    prompt is tokenized (``note_size``). The autoscaler's warm handoff
    ranks on hits x bytes: a chain that is both hot and expensive to
    recompute is the one worth re-homing first."""

    def __init__(self, size: int = 4096):
        self.size = size
        self._lock = threading.Lock()
        # key -> [hits, pages, nbytes]; pages/nbytes are the largest
        # footprint seen (depths share keys; max is what a re-home moves)
        self._hits: "collections.OrderedDict[int, list]" = (
            collections.OrderedDict()
        )

    def record(self, chain) -> None:
        """Count one request's chain keys (all depths: the locality map
        holds every depth, so every depth must be re-homeable)."""
        if not chain:
            return
        with self._lock:
            for ck in chain:
                ent = self._hits.get(ck)
                if ent is None:
                    ent = self._hits[ck] = [0, 0, 0]
                ent[0] += 1
                self._hits.move_to_end(ck)
            while len(self._hits) > self.size:
                self._hits.popitem(last=False)

    def note_size(self, chain, pages: int, nbytes: int) -> None:
        """Attach the cacheable-prefix footprint to a request's chain keys
        (hits untouched — ``record`` already counted this request). Called
        by the completion path, which knows the tokenized prefix boundary
        and the cache's stored-width byte cost."""
        if not chain or (pages <= 0 and nbytes <= 0):
            return
        with self._lock:
            for ck in chain:
                ent = self._hits.get(ck)
                if ent is None:
                    continue  # evicted (or never recorded): don't resurrect
                ent[1] = max(ent[1], pages)
                ent[2] = max(ent[2], nbytes)

    def snapshot(self, top_n: int = 64) -> dict:
        """The ``/debug/hot_prefixes`` payload: the hottest chain keys as
        zero-padded hex (the handoff wire format), hit-count descending
        with stored bytes as the tiebreak, each with its KV footprint."""
        with self._lock:
            items = sorted(
                self._hits.items(),
                key=lambda kv: (kv[1][0], kv[1][2]), reverse=True,
            )[:top_n]
            n = len(self._hits)
        return {
            "n_tracked": n,
            "chains": [
                {
                    "key": f"{ck:016x}", "hits": hits,
                    "pages": pages, "bytes": nbytes,
                }
                for ck, (hits, pages, nbytes) in items
            ],
        }
