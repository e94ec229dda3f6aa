"""Observability: the stall watchdog, step-latency statistics and the
goodput ledger.

The counterpart of the JAX package's `runtime/telemetry.py`, with the same
names, counters, events and environment variables: `StallError`,
`watchdog`, `_Series`, `StepStats` (with `report`), `GoodputLedger` and
`GoodputAggregator` (reference: the executor's stall watchdog,
src/nn/nn-executor.cpp:9-33,276-353, and the network performance
monitor, src/nn/nn-network.cpp:883-1053), and `memory_report` with its
`_tree_bytes` (JAX :596-616) over the port's tensor trees: the bytes of
every tensor in a dataclass / list / dict tree (a Q40 weight's words and
scales both), which the HBM ledger (runtime/profiling.py) itemizes. The
engine's `memory_report` method prints its own, wider device summary.

* **Stall watchdog**: `watchdog()` wraps a blocking device call (the
  engine's dispatch and fetch of a decode chunk, a verify round, a
  prefill's sync), logs `[EXEC_STALL]` after ``DLT_STALL_LOG_MS`` (default
  60000; ``DLT_COMPILE_LOG_MS``, default 300000, for a first call of a
  shape, where the port captures a CUDA graph or builds a kernel) and
  raises `StallError` once the call returns if it outlasted
  ``DLT_STALL_TIMEOUT_MS`` (default 600000), after a flight record
  (runtime/tracing.py). Like the reference it detects and does not
  cancel: a CUDA call cannot be interrupted.

  The JAX watchdog starts and joins one thread per guarded call; that is
  tens to ~150 µs of host time, several percent of a ~3 ms verify round.
  Here one long-lived daemon thread (`_Watcher`) watches every armed
  guard: entering a guard reads the thresholds from the environment and
  puts its deadline into a slot, leaving takes it out, and the thread is
  woken only when a new deadline is earlier than the one it sleeps until
  (an idle thread sleeps until the next guard arms). The log, the
  counters and the events run on that thread under its lock, so a guard
  that leaves finds them done.
* **Step statistics**: `StepStats` keeps per-step-type latency min / avg /
  max and p50 / p95 / p99 over a recent window, named event counters and
  gauges, and log-bucket histograms, printable with `report()`.
* **Goodput ledger**: per-request accounting of where wall time went and
  what every decoded token became, rolled up into a process
  `GoodputAggregator` (the server's ``dlt_goodput_tokens_per_s`` and
  ``dlt_wasted_tokens_total{reason=...}``).
"""

from __future__ import annotations

import math
import os
import sys
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

from .tracing import Hist, flight_record, global_event


class StallError(RuntimeError):
    pass


# the environment's own dict of encoded names and values, which
# `os.environ` (and so `monkeypatch.setenv`) keeps up to date: one dict
# lookup where `os.environ.get` runs four Python frames, on every armed
# guard (CPython's `os._Environ`; elsewhere `os.environ` itself)
_ENV_DATA = getattr(os.environ, "_data", None)


def _env_ms(name: str, default: int) -> float:
    try:
        if _ENV_DATA is not None:
            raw = _ENV_DATA.get(name.encode())
            return float(raw) if raw is not None else float(default)
        return float(os.environ.get(name, default))
    except ValueError:
        return float(default)


class _Watcher:
    """The one daemon thread that watches every armed `watchdog`. A guard's
    slot holds its next deadline (`_next`, a perf_counter time): the log
    threshold until it has logged, then the hard timeout. The thread sleeps
    until the earliest deadline of the armed guards, or, with none armed,
    until a guard arms; `arm` wakes it only for a deadline earlier than
    the one it sleeps until, so a stream of guards that leave on time costs
    one lock hold each way and no thread switch."""

    def __init__(self):
        self._lock = threading.Lock()  # held directly: a Condition's own
        # __enter__ and __exit__ are Python frames on every guard
        self._cv = threading.Condition(self._lock)
        self._armed: dict = {}  # id(guard) -> guard
        self._wake = math.inf  # the deadline the thread sleeps until
        self._thread = None

    def arm(self, wd) -> None:
        with self._lock:
            self._armed[id(wd)] = wd
            if wd._next < self._wake:
                self._wake = wd._next
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._run, name="dlt-watchdog", daemon=True)
                    self._thread.start()
                self._cv.notify()

    def disarm(self, wd) -> None:
        with self._lock:
            self._armed.pop(id(wd), None)

    def _run(self) -> None:
        with self._cv:
            while True:
                now = time.perf_counter()
                nxt = math.inf
                for key, wd in list(self._armed.items()):
                    if wd._next <= now and not wd._fire(now):
                        del self._armed[key]  # timed out: nothing more to watch
                        continue
                    nxt = min(nxt, wd._next)
                self._wake = nxt
                self._cv.wait(None if nxt == math.inf else max(nxt - now, 0.0))


_WATCHER = _Watcher()


class watchdog:
    """Context manager guarding a blocking device call.

    >>> with watchdog("decode"):
    ...     host = toks.cpu()

    Logs `[EXEC_STALL]` after DLT_STALL_LOG_MS and, when the call outlasts
    DLT_STALL_TIMEOUT_MS, raises StallError as it returns (the blocking
    call itself cannot be cancelled: the same semantics as the reference,
    which also only detects). `compiling` marks a first call of a shape
    (the engine tracks which it has run): the log threshold widens to
    DLT_COMPILE_LOG_MS and the label says what it is. The thresholds are
    read from the environment each time the guard is entered.
    """

    __slots__ = ("what", "stats", "log_fn", "compiling", "log_ms", "timeout_ms", "_logged",
                 "_timed_out", "_t0", "_next")

    def __init__(self, what: str, log_fn=None, compiling: bool = False, stats=None):
        self.what = ("compile " + what) if compiling else what
        self.stats = stats  # optional StepStats: stall events become counters
        # None: diagnostics go to STDERR, so that a tool whose contract is
        # one machine-readable stdout line does not get a stall notice
        # spliced into it
        self.log_fn = log_fn
        self.compiling = compiling
        self._logged = False
        self._timed_out = False

    def _log(self, msg: str) -> None:
        if self.log_fn is None:
            print(msg, file=sys.stderr)
        else:
            self.log_fn(msg)

    def _fire(self, now: float) -> bool:
        """A deadline passed (called on the watcher thread, under its
        lock): log once, then time out. Returns False once timed out."""
        elapsed_ms = (now - self._t0) * 1000.0
        if not self._logged and elapsed_ms >= self.log_ms:
            self._log(
                f"⏳ [EXEC_STALL] {self.what} exceeded {self.log_ms:.0f} ms "
                f"(elapsed {elapsed_ms:.0f} ms)"
            )
            if self.stats is not None:
                self.stats.incr("exec_stall_logged")
            global_event("exec_stall_logged", keys=("what",), vals=(self.what,))
            self._logged = True
        if elapsed_ms >= self.timeout_ms:
            self._timed_out = True
            self._log(
                f"🚨 [EXEC_STALL] {self.what} exceeded hard timeout "
                f"{self.timeout_ms:.0f} ms"
            )
            if self.stats is not None:
                self.stats.incr("exec_stall_timeout")
            global_event("watchdog_stall", keys=("what",), vals=(self.what,))
            return False
        # whichever deadline comes first, so that a timeout shorter than
        # the log threshold is still honoured on time
        wait_ms = self.timeout_ms if self._logged else min(self.log_ms, self.timeout_ms)
        self._next = self._t0 + wait_ms / 1000.0
        return True

    def __enter__(self):
        self.log_ms = _env_ms(
            "DLT_COMPILE_LOG_MS" if self.compiling else "DLT_STALL_LOG_MS",
            300000 if self.compiling else 60000,
        )
        self.timeout_ms = _env_ms("DLT_STALL_TIMEOUT_MS", 600000)
        self._logged = self._timed_out = False
        self._t0 = time.perf_counter()
        self._next = self._t0 + min(self.log_ms, self.timeout_ms) / 1000.0
        _WATCHER.arm(self)
        return self

    def __exit__(self, exc_type, *exc):
        _WATCHER.disarm(self)
        if self._timed_out and exc_type is None:
            # the post-mortem before the raise: the ring still holds the
            # stalled request's spans and the watchdog event
            flight_record(
                f"stall:{self.what}",
                counters=self.stats.counters_snapshot() if self.stats else None,
            )
            raise StallError(f"{self.what} exceeded {self.timeout_ms:.0f} ms")
        return False


@dataclass
class _Series:
    count: int = 0
    total_us: float = 0.0
    min_us: float = float("inf")
    max_us: float = 0.0
    recent: list = field(default_factory=list)  # recent-window latencies
    window: int = 100


class StepStats:
    """Per-step-type latency aggregation with percentile report
    (the reference's NetworkPerfMonitor shape, applied to device steps),
    plus named event counters (stall resets/retries, shed requests) so the
    robustness layer is observable through the same snapshot `/health`,
    `/stats`, and `/gateway/stats` read."""

    def __init__(self, window: int = 100):
        self.series: dict[str, _Series] = defaultdict(lambda: _Series(window=window))
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, float] = {}
        # fixed log-bucket histograms (runtime/tracing.py Hist): unlike the
        # recent-window percentiles above, their cumulative counts are
        # monotone across scrapes — the Prometheus `_bucket` series /metrics
        # exports (TTFT, time-per-output-token)
        self.hists: dict[str, Hist] = {}
        self._counter_lock = threading.Lock()

    def incr(self, name: str, n: int = 1):
        """Bump a named event counter (thread-safe; shows up in
        `snapshot()["counters"]`)."""
        with self._counter_lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float):
        """Set a last-value metric (e.g. the most recent prefill's
        dispatch-vs-compute overlap percentage) — exported in
        `snapshot()["gauges"]` next to the latency series, so `/stats`
        surfaces derived quantities the series alone can't express."""
        with self._counter_lock:
            self.gauges[name] = float(value)

    def observe(self, name: str, value_ms: float, bounds=None, labels=None):
        """Record one observation into the named cumulative histogram
        (created on first use; fixed log-scale ms buckets). Thread-safe;
        exported under ``snapshot()["histograms"]`` and as Prometheus
        ``_bucket``/``_sum``/``_count`` series on `/metrics`. `labels`
        (e.g. ``{"slo_class": "interactive"}``) keys a SEPARATE labeled
        histogram rendered as extra rows of the same family — the
        per-class TTFT/TPOT breakdown (tracing.split_labeled_key is the
        decoding twin)."""
        if labels:
            name = (
                name
                + "{"
                + ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
                + "}"
            )
        with self._counter_lock:
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = Hist(bounds) if bounds else Hist()
        h.observe(value_ms)

    def hists_snapshot(self) -> dict:
        with self._counter_lock:
            hists = dict(self.hists)
        return {k: h.snapshot() for k, h in hists.items()}

    def counters_snapshot(self) -> dict:
        with self._counter_lock:
            return dict(self.counters)

    def gauges_snapshot(self) -> dict:
        with self._counter_lock:
            return dict(self.gauges)

    def record(self, kind: str, us: float):
        s = self.series[kind]
        s.count += 1
        s.total_us += us
        s.min_us = min(s.min_us, us)
        s.max_us = max(s.max_us, us)
        s.recent.append(us)
        if len(s.recent) > s.window:
            s.recent.pop(0)

    def percentiles(self, kind: str) -> dict:
        s = self.series.get(kind)
        if not s or not s.recent:
            return {}
        # list() first: record() on another thread appends concurrently
        arr = np.sort(np.asarray(list(s.recent)))
        pick = lambda p: float(arr[min(len(arr) - 1, int(len(arr) * p))])
        return {"p50": pick(0.50), "p95": pick(0.95), "p99": pick(0.99)}

    def snapshot(self) -> dict:
        """JSON-able view of every series (the /stats endpoint's payload;
        same numbers `report()` prints) plus, under the reserved
        ``"counters"`` and ``"gauges"`` keys, the event counters and
        last-value gauges — the one source `/health` and the gateway's
        `/gateway/stats` both agree with."""
        out = {
            "counters": self.counters_snapshot(),
            "gauges": self.gauges_snapshot(),
            # reserved key like counters/gauges: existing /stats readers
            # (and their tests) key into what they know and keep working
            "histograms": self.hists_snapshot(),
        }
        # materialize the items: engine threads insert new kinds while the
        # /stats handler iterates
        for kind, s in sorted(list(self.series.items())):
            if s.count == 0:
                continue
            p = self.percentiles(kind)
            out[kind] = {
                "count": s.count,
                "avg_ms": round(s.total_us / s.count / 1000, 3),
                "min_ms": round(s.min_us / 1000, 3),
                "max_ms": round(s.max_us / 1000, 3),
                "p50_ms": round(p.get("p50", 0) / 1000, 3),
                "p95_ms": round(p.get("p95", 0) / 1000, 3),
                "p99_ms": round(p.get("p99", 0) / 1000, 3),
            }
        return out

    def report(self) -> str:
        lines = ["📊 Step performance report:"]
        for kind, s in sorted(self.series.items()):
            if s.count == 0:
                continue
            avg = s.total_us / s.count
            p = self.percentiles(kind)
            lines.append(
                f"  {kind:<16} n={s.count:<6} avg={avg/1000:8.2f}ms "
                f"min={s.min_us/1000:8.2f}ms max={s.max_us/1000:8.2f}ms "
                f"p50={p.get('p50', 0)/1000:8.2f}ms p95={p.get('p95', 0)/1000:8.2f}ms "
                f"p99={p.get('p99', 0)/1000:8.2f}ms"
            )
        return "\n".join(lines)


# -- per-request goodput ledger ----------------------------------------------

#: every waste reason the aggregator labels `dlt_wasted_tokens_total` with:
#: * ``overrun``     — decoded past the row's stop/budget before the step
#:                     loop noticed (discarded, never delivered);
#: * ``shed``        — decoded for a request later shed (pool-pressure
#:                     victim, overload 503);
#: * ``stall_retry`` — a failed attempt's tokens discarded before the
#:                     in-place retry re-decoded them;
#: * ``client_gone`` — decoded after the client dropped mid-stream;
#: * ``error``       — decoded before an engine failure killed the request;
#: * ``transfer_retry`` — prompt tokens a dead/failed disaggregated KV
#:                     transfer (server/disagg.py) forced the decode worker
#:                     to re-prefill locally (the prefill worker's compute
#:                     for them is lost fleet-wide);
#: * ``preempt``     — decoded for a lower-SLO-class row the scheduler
#:                     evicted so a waiting higher-class request could take
#:                     its slot (server/scheduler.py);
#: * ``deadline``    — decoded (or queued prompt tokens shed) for a request
#:                     whose end-to-end deadline (``X-DLT-Deadline-Ms``)
#:                     passed before delivery — an answer nobody was still
#:                     waiting for (server/scheduler.py resolve_deadline_ms);
#: * ``quarantined`` — prompt/decode work burned by a poison request before
#:                     its fingerprint crossed the quarantine strike limit
#:                     (server/quarantine.py);
#: * ``integrity``   — prompt tokens re-prefilled locally because the
#:                     fetched KV arrived complete but WRONG (checksum /
#:                     page_keys mismatch — runtime/kv_transport.py
#:                     verify_transfer rejected it before the cache was
#:                     touched); split from ``transfer_retry`` so corrupt
#:                     peers and dead peers are separate lines.
WASTE_REASONS = (
    "overrun", "shed", "stall_retry", "client_gone", "error",
    "transfer_retry", "preempt", "deadline", "quarantined", "integrity",
)

#: the SLO classes goodput breaks down by (server/scheduler.py is the
#: policy owner; this copy keeps telemetry free of the server's imports
#: — a mismatch is pinned by tests)
SLO_CLASSES = ("interactive", "standard", "batch")

#: GoodputLedger fields attached to the request trace (one cold `ledger`
#: event per request) and returned in the `usage` extension — one list so
#: the trace, the HTTP payload, and the tests can never disagree on shape
LEDGER_FIELDS = (
    "queue_us", "prefill_us", "decode_us", "spec_us",
    "remote_prefill_us", "kv_transfer_us", "kv_transfer_path",
    "promotion_us", "prompt_tokens", "prefix_hit_tokens",
    "generated_tokens", "spec_accepted_tokens", "discarded_tokens",
    "retries",
)


@dataclass
class GoodputLedger:
    """One request's goodput accounting: where its wall time went and what
    every decoded token became. Accumulated along the serving path (queue
    wait at admission, prefill/decode/spec walls per chunk, token outcomes
    at retirement), attached to the request's trace, returned in the
    ``usage`` extension, and folded into the process aggregate — so a shed
    storm or draft-hostile traffic shows up as GOODPUT (delivered tokens/s
    net of waste), not just as counters.

    The accounting identity every request must satisfy (tested):
    ``generated_tokens + discarded_tokens == every token the engine decoded
    into this request's row(s)``."""

    queue_us: int = 0      # submit -> admission (batched; 0 serialized)
    prefill_us: int = 0    # prompt prefill wall (splice included)
    decode_us: int = 0     # plain decode-chunk walls
    spec_us: int = 0       # speculative draft+verify round walls
    remote_prefill_us: int = 0  # prefill-WORKER wall of a disaggregated
    # request (server/disagg.py; the worker reports it in its KV payload)
    kv_transfer_us: int = 0     # fetch wall of the shipped KV, net of the
    # worker's reported prefill (runtime/kv_transport.py)
    kv_transfer_path: str = ""  # transport the shipped KV took ("device" |
    # "http"; "" = no transfer) — the per-request twin of the labeled
    # dlt_kv_transfer_us series
    promotion_us: int = 0       # tiered-KV fetch wall: host/disk/peer tier
    # lookup + transfer for this request's prefix (runtime/kv_tiering.py;
    # 0 = no tier promotion)
    prompt_tokens: int = 0
    prefix_hit_tokens: int = 0   # prompt tokens resumed from the radix cache
    generated_tokens: int = 0    # delivered to the client (usage-visible)
    spec_accepted_tokens: int = 0
    discarded_tokens: int = 0    # decoded but never delivered
    retries: int = 0             # in-place stall retries this request took
    outcome: str = "ok"          # ok | shed | error | client_gone
    slo_class: str = "standard"  # interactive | standard | batch
    # (server/scheduler.py): labels the per-class goodput breakdown

    def as_dict(self) -> dict:
        out = {f: getattr(self, f) for f in LEDGER_FIELDS}
        out["outcome"] = self.outcome
        out["slo_class"] = self.slo_class
        return out

    def trace_vals(self) -> tuple:
        return tuple(getattr(self, f) for f in LEDGER_FIELDS) + (
            self.outcome, self.slo_class,
        )


#: trace-event keys for the per-request `ledger` event (pairs trace_vals)
LEDGER_TRACE_KEYS = LEDGER_FIELDS + ("outcome", "slo_class")


class GoodputAggregator:
    """Process-level rollup of request ledgers: cumulative delivered vs
    wasted tokens (by reason) plus a recent-window delivered-token rate —
    the ``dlt_goodput_tokens_per_s`` gauge and
    ``dlt_wasted_tokens_total{reason=...}`` counter family on /metrics.

    Thread-safe; `record()` is one lock hold per REQUEST (never per token),
    so the serving hot path is untouched."""

    def __init__(self, window_s: float = 60.0):
        self.window_s = window_s
        self._lock = threading.Lock()
        self.requests: dict[str, int] = {}   # outcome -> count
        self.delivered_tokens = 0
        self.prompt_tokens = 0
        self.prefix_hit_tokens = 0
        self.wasted: dict[str, int] = {}     # reason -> tokens
        # per-SLO-class breakdowns (server/scheduler.py): delivered/request
        # totals and (reason, class)-keyed waste — the slo_class-labeled
        # series on /metrics and the by_class section of /stats goodput
        self.delivered_by_class: dict[str, int] = {}
        self.requests_by_class: dict[str, int] = {}
        self.wasted_by_class: dict[tuple, int] = {}
        self._window: list = []              # (t, delivered, slo_class)

    def record(
        self,
        ledger: GoodputLedger,
        waste_reason: str | None = None,
        count_request: bool = True,
    ):
        """Fold one finished request (or failed attempt) in. `waste_reason`
        labels the ledger's discarded tokens; None derives it from the
        outcome (`ok` discards are chunk overrun). `count_request=False`
        folds the TOKEN accounting without bumping the request outcome
        counts — a stall-retried attempt's waste belongs to the ledger, but
        the request itself is counted once, by its final attempt."""
        if waste_reason is None:
            waste_reason = "overrun" if ledger.outcome == "ok" else ledger.outcome
        klass = ledger.slo_class if ledger.slo_class in SLO_CLASSES else "standard"
        now = time.monotonic()
        with self._lock:
            if count_request:
                self.requests[ledger.outcome] = (
                    self.requests.get(ledger.outcome, 0) + 1
                )
                self.requests_by_class[klass] = (
                    self.requests_by_class.get(klass, 0) + 1
                )
            self.delivered_tokens += ledger.generated_tokens
            self.delivered_by_class[klass] = (
                self.delivered_by_class.get(klass, 0) + ledger.generated_tokens
            )
            self.prompt_tokens += ledger.prompt_tokens
            self.prefix_hit_tokens += ledger.prefix_hit_tokens
            if ledger.discarded_tokens:
                self.wasted[waste_reason] = (
                    self.wasted.get(waste_reason, 0) + ledger.discarded_tokens
                )
                self.wasted_by_class[(waste_reason, klass)] = (
                    self.wasted_by_class.get((waste_reason, klass), 0)
                    + ledger.discarded_tokens
                )
            self._window.append((now, ledger.generated_tokens, klass))
            self._trim_locked(now)

    def add_waste(self, reason: str, tokens: int, slo_class: str = "standard"):
        """Count waste OUTSIDE any request ledger — tokens whose compute is
        lost without a failed request to pin them on (a degraded KV
        transfer's re-prefill: the REQUEST succeeds, the prefill worker's
        compute for those tokens is what was wasted)."""
        if tokens <= 0:
            return
        klass = slo_class if slo_class in SLO_CLASSES else "standard"
        with self._lock:
            self.wasted[reason] = self.wasted.get(reason, 0) + tokens
            self.wasted_by_class[(reason, klass)] = (
                self.wasted_by_class.get((reason, klass), 0) + tokens
            )

    def _trim_locked(self, now: float):
        cutoff = now - self.window_s
        w = self._window
        i = 0
        while i < len(w) and w[i][0] < cutoff:
            i += 1
        if i:
            del w[:i]

    def goodput_tokens_per_s(self) -> float:
        """Delivered tokens/s over the recent window — the headline gauge.
        The divisor is the observed span, floored at ONE second: a scrape
        landing milliseconds after a fresh replica's first completion must
        not extrapolate one request into a 50k tok/s routing signal (the
        fleet table lifts this gauge verbatim), and once the window has
        aged in the floor is inert."""
        now = time.monotonic()
        with self._lock:
            self._trim_locked(now)
            if not self._window:
                return 0.0
            span = max(now - self._window[0][0], 1.0)
            total = sum(n for _, n, _ in self._window)
        return round(total / span, 3)

    def goodput_series(self) -> list:
        """``[(labels, value), ...]`` for the ``dlt_goodput_tokens_per_s``
        gauge family: the unlabeled fleet-facing total (the signal the
        router/fleet table scores — unchanged shape) PLUS one
        ``slo_class``-labeled row per class over the same recent window,
        zero-valued classes included."""
        now = time.monotonic()
        with self._lock:
            self._trim_locked(now)
            window = list(self._window)
        if not window:
            return [({}, 0.0)] + [({"slo_class": c}, 0.0) for c in SLO_CLASSES]
        span = max(now - window[0][0], 1.0)
        per_class = {c: 0 for c in SLO_CLASSES}
        total = 0
        for _, n, klass in window:
            total += n
            per_class[klass] = per_class.get(klass, 0) + n
        return [({}, round(total / span, 3))] + [
            ({"slo_class": c}, round(per_class[c] / span, 3))
            for c in SLO_CLASSES
        ]

    def wasted_series(self) -> list:
        """``[(labels, value), ...]`` for the labeled counter family —
        every known reason present (zero-valued reasons included, so
        dashboards never see a series appear from nowhere mid-incident).
        These reason-only rows are the TOTALS; ``wasted_by_class_series``
        adds the per-class breakdown rows of the same family."""
        with self._lock:
            wasted = dict(self.wasted)
        return [({"reason": r}, wasted.get(r, 0)) for r in WASTE_REASONS]

    def wasted_by_class_series(self) -> list:
        """The ``{reason, slo_class}``-labeled breakdown rows of
        ``dlt_wasted_tokens_total``. Only (reason, class) pairs that have
        actually wasted tokens render — the zero-fill contract is carried
        by the reason-only totals; 21 always-zero breakdown rows would be
        noise. Summing the whole family double-counts: the reason-only
        rows are totals, the labeled rows their decomposition."""
        with self._lock:
            by_class = dict(self.wasted_by_class)
        return [
            ({"reason": r, "slo_class": c}, v)
            for (r, c), v in sorted(by_class.items())
        ]

    def by_class_snapshot(self) -> dict:
        """Per-SLO-class goodput view (the ``by_class`` section of the
        ``/stats`` goodput payload and ``/gateway/fleet`` rows)."""
        rates = {
            lab["slo_class"]: v
            for lab, v in self.goodput_series()
            if "slo_class" in lab
        }
        with self._lock:
            out = {}
            for c in SLO_CLASSES:
                wasted = {
                    r: v for (r, cc), v in self.wasted_by_class.items()
                    if cc == c
                }
                out[c] = {
                    "requests": self.requests_by_class.get(c, 0),
                    "delivered_tokens": self.delivered_by_class.get(c, 0),
                    "wasted_tokens": wasted,
                    "goodput_tokens_per_s": rates.get(c, 0.0),
                }
        return out

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "window_s": self.window_s,
                "requests": dict(self.requests),
                "delivered_tokens": self.delivered_tokens,
                "prompt_tokens": self.prompt_tokens,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "wasted_tokens": dict(self.wasted),
                "wasted_tokens_sum": sum(self.wasted.values()),
            }
        out["goodput_tokens_per_s"] = self.goodput_tokens_per_s()
        out["by_class"] = self.by_class_snapshot()
        return out


def _tree_bytes(tree) -> int:
    """Bytes of every tensor in `tree`: a tensor, a dataclass (the params,
    the KV cache, the rope tables, a Q40 weight), a list, tuple or dict of
    them, or None."""
    import dataclasses

    import torch

    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(_tree_bytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(x) for x in tree)
    if isinstance(tree, dict):
        return sum(_tree_bytes(x) for x in tree.values())
    return 0


def memory_report(params, cache) -> str:
    """Device-memory footprint summary (reference: per-node RAM requirement
    print, src/nn/nn-core.cpp:177-191), the JAX package's line."""
    pb = _tree_bytes(params)
    cb = _tree_bytes(cache)

    def fmt(n):
        return f"{n / 1e9:.2f} GB" if n >= 1e8 else f"{n / 1e6:.1f} MB"

    return (
        f"💿 Device memory: weights {fmt(pb)}, kv cache {fmt(cb)}, "
        f"total {fmt(pb + cb)}"
    )
