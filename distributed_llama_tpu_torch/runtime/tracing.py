"""Request-lifecycle tracing: trace IDs, span ring buffer, flight recorder,
and Prometheus text exposition.

A copy of the JAX package's `runtime/tracing.py`, whole: the same names,
event tuples, environment variables and renderers, whose outputs are
byte for byte the JAX module's for the same events. Only the words about
the device stack differ.

The aggregate views (`/stats` StepStats percentiles, `/gateway/stats`
counters) answer "how is the fleet doing" but not "why was THIS request's
TTFT 900 ms" or "what was the engine doing when the watchdog fired". This
module is the per-request layer under both servers:

* **Trace IDs** — minted at the first hop (gateway, or the backend for
  direct traffic), propagated via the ``X-DLT-Trace-Id`` header and echoed
  in responses, so one request is one joinable identity across
  gateway -> retry -> backend.
* **Span events** — every stage emits ``(trace_id, name, t_us, dur_us,
  keys, vals)`` tuples into a bounded ring (`TraceRing`): gateway
  routing/retry decisions, Batcher queue wait/admit, prefix-cache
  match/splice/publish, each prefill chunk's dispatch, decode chunks, and
  speculative draft/verify rounds. The hot-loop emit cost is ONE tuple
  append onto a pre-bound :class:`Emitter` (no dict construction, no name
  lookups, no locks — `deque.append` is atomic under the GIL); the repo
  lint's ``trace-hot-emit`` rule enforces the pre-bound discipline inside
  runtime loops.
* **Sampling** — ``DLT_TRACE_SAMPLE=N`` records detail spans for one in N
  requests (default 1 = all; 0 = off). Error/lifecycle events are emitted
  with ``always=True`` and land regardless, so a failed request is always
  reconstructable even at aggressive sampling.
* **Flight recorder** — on `StallError`, ``api.recover()``, or a fatal
  sanitizer breach, the last ``DLT_FLIGHTREC_EVENTS`` ring events are
  snapshotted to a post-mortem JSON: kept in memory for
  ``GET /debug/flightrecord`` and dumped on disk under
  ``DLT_FLIGHTREC_DIR`` (default: a ``dlt-flightrecords`` dir in the
  system tempdir; set the env to ``""``/``0`` to disable the disk copy).
* **Exposition** — ``GET /debug/trace?id=...`` renders one trace's span
  tree plus a Chrome ``trace_event`` export (load in chrome://tracing /
  Perfetto), and ``GET /metrics`` renders StepStats counters, gauges,
  latency-series quantiles, and the log-bucket histograms (TTFT,
  time-per-output-token) as Prometheus text exposition.

Tracing adds zero device work: every timestamp is host-side
(`perf_counter` anchored to the epoch once at import, so timestamps are
wall-aligned AND monotonic), so it adds no host sync and nothing to a
CUDA graph: the engine emits only around its dispatches and fetches,
never inside a capture.

Deliberately stdlib-only (no torch, no numpy): a gateway may import this
module on a box with no accelerator stack.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile
import threading
import time
import uuid

TRACE_HEADER = "X-DLT-Trace-Id"
#: carries the FIRST hop's sampling decision alongside the trace id, so a
#: gateway-sampled request gets its detail spans recorded at the backend
#: too (the two processes' 1-in-N counters are not in phase otherwise)
SAMPLED_HEADER = "X-DLT-Trace-Sampled"

# one epoch anchor at import: timestamps are perf_counter-monotonic but
# reported in wall-clock microseconds, so traces from two processes
# (gateway + backend) line up on one timeline
_T0_EPOCH = time.time()
_T0_PERF = time.perf_counter()


def now_us() -> int:
    """Current wall-aligned monotonic timestamp in microseconds."""
    return int((_T0_EPOCH + (time.perf_counter() - _T0_PERF)) * 1e6)


def to_us(perf_t: float) -> int:
    """Convert a `time.perf_counter()` reading to the event timebase —
    hot loops keep their existing perf_counter reads and convert only when
    emitting."""
    return int((_T0_EPOCH + (perf_t - _T0_PERF)) * 1e6)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def mint_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def parse_sampled(raw: str | None) -> bool | None:
    """Decode an ``X-DLT-Trace-Sampled`` header value: None (absent) means
    "decide locally"; ``"0"`` is the only falsy wire value."""
    if raw is None:
        return None
    return raw.strip() != "0"


# -- the ring ----------------------------------------------------------------


class TraceRing:
    """Bounded ring of span-event tuples ``(trace_id, name, t_us, dur_us,
    keys, vals)``. Appends are one `deque.append` — O(1), atomic under the
    GIL, no lock — and the `maxlen` bound means memory is capped no matter
    how many events flow through (the 100k-event bound test)."""

    def __init__(self, capacity: int | None = None):
        self.capacity = capacity or _env_int("DLT_TRACE_RING", 16384)
        self._events: collections.deque = collections.deque(maxlen=self.capacity)

    def append(self, ev: tuple) -> None:
        self._events.append(ev)

    def __len__(self) -> int:
        return len(self._events)

    def snapshot(self) -> list:
        # list() materializes a consistent-enough copy while emitters append
        return list(self._events)

    def for_trace(self, trace_id: str) -> list:
        return [e for e in self.snapshot() if e[0] == trace_id]


class Emitter:
    """A pre-bound span emitter: trace id, span name, and arg keys are
    fixed at bind time, so the per-event hot-loop cost is ONE tuple append.
    This is the only emission API the repo lint allows inside runtime
    loops (``trace-hot-emit``)."""

    __slots__ = ("_append", "_tid", "name", "keys")

    def __init__(self, ring: TraceRing, trace_id: str, name: str, keys=()):
        self._append = ring._events.append
        self._tid = trace_id
        self.name = name
        self.keys = tuple(keys)

    def __call__(self, t_us: int, dur_us: int, *vals) -> None:
        self._append((self._tid, self.name, t_us, dur_us, self.keys, vals))


class Trace:
    """One request's tracing context: the ID (propagated via
    ``X-DLT-Trace-Id``) plus the sampling decision made at request start."""

    __slots__ = ("id", "sampled", "_ring")

    def __init__(self, trace_id: str, sampled: bool, ring: TraceRing):
        self.id = trace_id
        self.sampled = sampled
        self._ring = ring

    def bind(self, name: str, keys=()) -> Emitter | None:
        """A pre-bound emitter for a hot loop — None when this trace is
        unsampled, so the loop's per-event guard (`if em is not None`)
        covers sampling too."""
        if not self.sampled:
            return None
        return Emitter(self._ring, self.id, name, keys)

    def event(
        self, name: str, t_us: int, dur_us: int = 0, keys=(), vals=(),
        always: bool = False,
    ) -> None:
        """One span event (cold path — request lifecycle, errors, cache
        decisions). `always=True` bypasses sampling: errors and terminal
        request events must land even at DLT_TRACE_SAMPLE=1000."""
        if self.sampled or always:
            self._ring.append((self.id, name, t_us, dur_us, tuple(keys), tuple(vals)))


class Tracer:
    """Process-wide trace registry: mints/records traces over one shared
    ring. The module singleton ``TRACER`` is what the servers and the
    engine share; tests may build private instances."""

    def __init__(self, capacity: int | None = None):
        self.ring = TraceRing(capacity)
        self._lock = threading.Lock()
        self._n = 0

    @staticmethod
    def sample_every() -> int:
        """The ``DLT_TRACE_SAMPLE`` knob: detail spans for 1 in N requests
        (1 = every request, the default; 0 = never)."""
        return _env_int("DLT_TRACE_SAMPLE", 1)

    def start(self, trace_id: str | None = None, sampled: bool | None = None) -> Trace:
        """Open a trace. `sampled=None` makes the local 1-in-N decision;
        a non-None value adopts an upstream hop's decision (propagated via
        ``X-DLT-Trace-Sampled``), so one request samples coherently across
        gateway and backend."""
        if sampled is None:
            every = self.sample_every()
            with self._lock:
                self._n += 1
                n = self._n
            sampled = every > 0 and (n % every == 0)
        return Trace(trace_id or mint_trace_id(), bool(sampled), self.ring)

    def event(self, name: str, t_us: int, dur_us: int = 0, keys=(), vals=()) -> None:
        """An engine-level event not owned by any one request (prefix-cache
        publish, watchdog stall) — trace_id ``""``; flight-recorder context."""
        self.ring.append(("", name, t_us, dur_us, tuple(keys), tuple(vals)))

    def bind_global(self, name: str, keys=()) -> Emitter:
        """A pre-bound emitter for engine-level events NOT owned by any one
        request (trace_id ``""``) — the hot-loop twin of :meth:`event`. The
        Batcher's per-step batch-composition timeline rides this: one tuple
        append per step, no dicts, no locks."""
        return Emitter(self.ring, "", name, keys)

    def for_trace(self, trace_id: str) -> list:
        return self.ring.for_trace(trace_id)

    def for_names(self, names) -> list:
        """Ring events whose NAME is in `names` (any trace id) — the
        batch-timeline view reads the ``batch_*`` families this way."""
        names = frozenset(names)
        return [e for e in self.ring.snapshot() if e[1] in names]


TRACER = Tracer()


def global_event(name: str, t_us: int | None = None, dur_us: int = 0, keys=(), vals=()):
    """Emit an engine-level event on the process tracer (see
    :meth:`Tracer.event`)."""
    TRACER.event(name, now_us() if t_us is None else t_us, dur_us, keys, vals)


# -- rendering ---------------------------------------------------------------


def render_event(ev: tuple) -> dict:
    tid, name, t_us, dur_us, keys, vals = ev
    out = {"trace_id": tid, "name": name, "t_us": int(t_us), "dur_us": int(dur_us)}
    if keys:
        out["args"] = dict(zip(keys, vals))
    elif vals:
        out["args"] = {"values": list(vals)}
    return out


def trace_tree(events: list) -> list:
    """Nest a trace's events into a span tree by interval containment:
    events sorted by (start, -duration); an event whose interval falls
    inside the nearest still-open span becomes its child."""
    evs = sorted(events, key=lambda e: (e[2], -e[3]))
    roots: list = []
    stack: list = []  # (end_us, node)
    for ev in evs:
        node = render_event(ev)
        node["children"] = []
        start = ev[2]
        while stack and stack[-1][0] <= start:
            stack.pop()
        (stack[-1][1]["children"] if stack else roots).append(node)
        stack.append((start + ev[3], node))
    return roots


def chrome_trace(events: list) -> list:
    """Chrome ``trace_event`` format (complete events, microsecond ts/dur)
    — paste into chrome://tracing or Perfetto."""
    out = []
    for ev in events:
        tid, name, t_us, dur_us, keys, vals = ev
        out.append(
            {
                "name": name,
                "cat": "dlt",
                "ph": "X",
                "ts": int(t_us),
                "dur": max(int(dur_us), 1),
                "pid": os.getpid(),
                "tid": 0,
                "args": dict(zip(keys, vals)) if keys else {},
            }
        )
    return out


def trace_payload(trace_id: str, events: list) -> dict:
    """The ``/debug/trace`` response body: raw events, span tree, and the
    chrome://tracing export, one self-contained JSON."""
    return {
        "trace_id": trace_id,
        "n_events": len(events),
        "events": [render_event(e) for e in events],
        "tree": trace_tree(events),
        "chrome_trace": chrome_trace(events),
    }


# -- batch-composition timeline ----------------------------------------------

#: the event families the Batcher's timeline emits (server/api.py): one
#: sampled ``batch_step`` snapshot per step (slot composition + pool
#: occupancy) plus always-landed ``batch_park``/``batch_shed`` marks at the
#: pool-pressure decisions — the post-hoc view of batching pathologies
#: (admission stalls, park livelocks, pool thrash).
BATCH_TIMELINE_NAMES = ("batch_step", "batch_park", "batch_shed")


def batch_timeline_chrome(events: list) -> list:
    """Chrome ``trace_event`` view of a batch timeline: each ``batch_step``
    becomes an ``X`` slice (the chunk wall) PLUS counter (``C``) samples —
    ``batch_slots`` stacks decoding/prefilling/free rows, ``kv_pool`` plots
    pages used — so chrome://tracing / Perfetto render slot composition and
    pool pressure as stacked area charts over time; park/shed marks land as
    global instant events."""
    out: list = []
    pid = os.getpid()
    for ev in events:
        _, name, t_us, dur_us, keys, vals = ev
        args = dict(zip(keys, vals))
        if name == "batch_step":
            out.append(
                {
                    "name": "chunk", "cat": "dlt_batch", "ph": "X",
                    "ts": int(t_us), "dur": max(int(dur_us), 1),
                    "pid": pid, "tid": 0, "args": args,
                }
            )
            slots = {
                k: args[k] for k in ("decoding", "prefilling", "free")
                if k in args
            }
            if slots:
                out.append(
                    {
                        "name": "batch_slots", "cat": "dlt_batch", "ph": "C",
                        "ts": int(t_us), "pid": pid, "args": slots,
                    }
                )
            if "pool_pages_used" in args:
                out.append(
                    {
                        "name": "kv_pool", "cat": "dlt_batch", "ph": "C",
                        "ts": int(t_us), "pid": pid,
                        "args": {"pages_used": args["pool_pages_used"]},
                    }
                )
            if "queue_depth" in args:
                out.append(
                    {
                        "name": "backlog", "cat": "dlt_batch", "ph": "C",
                        "ts": int(t_us), "pid": pid,
                        "args": {"queue_depth": args["queue_depth"]},
                    }
                )
        else:  # batch_park / batch_shed: instant marks, global scope
            out.append(
                {
                    "name": name, "cat": "dlt_batch", "ph": "i", "s": "g",
                    "ts": int(t_us), "pid": pid, "tid": 0, "args": args,
                }
            )
    return out


def batch_timeline_payload(events: list) -> dict:
    """The ``/debug/batch_timeline`` response body: raw step snapshots plus
    the chrome://tracing export, one self-contained JSON."""
    return {
        "n_events": len(events),
        "n_steps": sum(1 for e in events if e[1] == "batch_step"),
        "parks": sum(1 for e in events if e[1] == "batch_park"),
        "sheds": sum(1 for e in events if e[1] == "batch_shed"),
        "events": [render_event(e) for e in events],
        "chrome_trace": batch_timeline_chrome(events),
    }


# -- histograms --------------------------------------------------------------

#: fixed log-scale (powers of two) millisecond buckets: cumulative counts
#: survive scrape-to-scrape (standard Prometheus histogram semantics) where
#: the StepStats recent-window percentiles cannot
DEFAULT_BUCKETS_MS = (
    1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
    1024.0, 2048.0, 4096.0, 8192.0, 16384.0, 32768.0,
)


class Hist:
    """Fixed-bucket cumulative histogram (Prometheus ``le`` semantics:
    a bucket counts observations <= its bound; +Inf is the total)."""

    __slots__ = ("bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, bounds=DEFAULT_BUCKETS_MS):
        self.bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self.bounds) + 1)  # +Inf tail bucket
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, count = self._sum, self._count
        buckets = []
        cum = 0
        for b, n in zip(self.bounds, counts):
            cum += n
            buckets.append([b, cum])
        buckets.append(["+Inf", count])
        return {"buckets": buckets, "sum": round(total, 3), "count": count}


# -- Prometheus text exposition ----------------------------------------------

_METRIC_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric(name: str) -> str:
    n = _METRIC_RE.sub("_", name)
    return ("_" + n) if n and n[0].isdigit() else n


def _esc(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def prom_line(name: str, labels: dict | None, value) -> str:
    lab = (
        ""
        if not labels
        else "{" + ",".join(f'{k}="{_esc(v)}"' for k, v in labels.items()) + "}"
    )
    return f"{name}{lab} {value}"


def render_counters(lines: list, counters: dict, prefix: str = "dlt") -> None:
    for k in sorted(counters):
        m = f"{prefix}_{_metric(k)}_total"
        lines.append(f"# TYPE {m} counter")
        lines.append(prom_line(m, None, counters[k]))


def render_gauges(lines: list, gauges: dict, prefix: str = "dlt") -> None:
    for k in sorted(gauges):
        m = f"{prefix}_{_metric(k)}"
        lines.append(f"# TYPE {m} gauge")
        lines.append(prom_line(m, None, gauges[k]))


def render_hist(lines: list, name: str, snap: dict, labels: dict | None = None,
                type_line: bool = True) -> None:
    """One histogram series; `labels` (e.g. ``{"slo_class": "batch"}``) ride
    every ``_bucket``/``_sum``/``_count`` row next to ``le`` — the per-class
    latency breakdown StepStats.observe(labels=...) produces.
    ``type_line=False`` skips the ``# TYPE`` header: a family with labeled
    breakdown series must declare its TYPE exactly once (the exposition
    format forbids a second TYPE line for the same metric)."""
    if type_line:
        lines.append(f"# TYPE {name} histogram")
    base = dict(labels) if labels else {}
    for le, cum in snap["buckets"]:
        lab = le if isinstance(le, str) else ("%g" % le)
        lines.append(prom_line(name + "_bucket", dict(base, le=lab), cum))
    lines.append(prom_line(name + "_sum", base or None, snap["sum"]))
    lines.append(prom_line(name + "_count", base or None, snap["count"]))


_LABELED_KEY_RE = re.compile(r'^([^{]+)\{(.*)\}$')
_LABEL_PAIR_RE = re.compile(r'(\w+)="([^"]*)"')


def split_labeled_key(key: str):
    """``'ttft_ms{slo_class="batch"}' -> ("ttft_ms", {"slo_class":
    "batch"})`` — the encoding StepStats uses to keep labeled histograms in
    its one flat dict (plain keys pass through with no labels)."""
    m = _LABELED_KEY_RE.match(key)
    if not m:
        return key, None
    labels = dict(_LABEL_PAIR_RE.findall(m.group(2)))
    return m.group(1), labels or None


def render_step_stats(
    stats, extra_gauges: dict | None = None, prefix: str = "dlt",
    extra_series: dict | None = None, extra_counter_series: dict | None = None,
) -> str:
    """Render a StepStats-shaped object (``snapshot()`` with reserved
    ``counters``/``gauges``/``histograms`` keys plus latency series) as
    Prometheus text: counters as ``_total``, gauges as-is, series as
    per-kind quantile gauges + cumulative step counts, histograms as
    cumulative ``_bucket`` series. `extra_series` adds LABELED gauge
    families — ``{name: [(labels_dict, value), ...]}`` — e.g. the HBM
    ledger's ``dlt_hbm_bytes{component=...}`` (runtime/profiling.py);
    `extra_counter_series` the same shape as LABELED counter families
    (``_total`` appended) — e.g. the goodput ledger's
    ``dlt_wasted_tokens_total{reason=...}`` (runtime/telemetry.py)."""
    snap = stats.snapshot()
    counters = snap.pop("counters", {})
    gauges = dict(snap.pop("gauges", {}))
    hists = snap.pop("histograms", {})
    if extra_gauges:
        gauges.update(extra_gauges)
    lines: list = []
    render_counters(lines, counters, prefix)
    render_gauges(lines, gauges, prefix)
    for name in sorted(extra_series or {}):
        m = f"{prefix}_{_metric(name)}"
        lines.append(f"# TYPE {m} gauge")
        for labels, value in extra_series[name]:
            lines.append(prom_line(m, labels, value))
    for name in sorted(extra_counter_series or {}):
        m = f"{prefix}_{_metric(name)}_total"
        lines.append(f"# TYPE {m} counter")
        for labels, value in extra_counter_series[name]:
            lines.append(prom_line(m, labels, value))
    if snap:
        m = f"{prefix}_step_latency_ms"
        lines.append(f"# TYPE {m} gauge")
        for kind in sorted(snap):
            s = snap[kind]
            for q in ("p50", "p95", "p99"):
                lines.append(prom_line(m, {"kind": kind, "quantile": q}, s[f"{q}_ms"]))
        mc = f"{prefix}_steps_total"
        lines.append(f"# TYPE {mc} counter")
        for kind in sorted(snap):
            lines.append(prom_line(mc, {"kind": kind}, snap[kind]["count"]))
    seen_hist_families: set = set()
    for hname in sorted(hists):
        base, labels = split_labeled_key(hname)
        fam = f"{prefix}_{_metric(base)}"
        render_hist(
            lines, fam, hists[hname], labels=labels,
            # ONE TYPE line per family: the unlabeled total and its
            # {slo_class} breakdown series share the declaration
            type_line=fam not in seen_hist_families,
        )
        seen_hist_families.add(fam)
    return "\n".join(lines) + "\n"


PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


# -- flight recorder ---------------------------------------------------------


class FlightRecorder:
    """Post-mortem snapshots of the trace ring. `record(reason)` captures
    the last ``DLT_FLIGHTREC_EVENTS`` events (default 2048) into a JSON
    payload, keeps it for ``/debug/flightrecord``, and best-effort dumps it
    on disk — a failure that takes the process down still leaves the dump
    behind."""

    def __init__(self, tracer: Tracer):
        self.tracer = tracer
        self._lock = threading.Lock()
        self.last: dict | None = None
        self._n = 0

    @staticmethod
    def _dir() -> str | None:
        raw = os.environ.get("DLT_FLIGHTREC_DIR")
        if raw is None:
            return os.path.join(tempfile.gettempdir(), "dlt-flightrecords")
        if raw in ("", "0"):
            return None
        return raw

    def record(self, reason: str, counters: dict | None = None) -> dict:
        keep = _env_int("DLT_FLIGHTREC_EVENTS", 2048)
        events = self.tracer.ring.snapshot()[-keep:]
        payload = {
            "reason": reason,
            "wall_time": time.time(),
            "t_us": now_us(),
            "pid": os.getpid(),
            "n_events": len(events),
            "events": [render_event(e) for e in events],
        }
        if counters:
            payload["counters"] = dict(counters)
        with self._lock:
            self._n += 1
            n = self._n
        d = self._dir()
        if d:
            try:
                os.makedirs(d, exist_ok=True)
                path = os.path.join(
                    d, f"flightrecord-{int(time.time() * 1000)}-{os.getpid()}-{n}.json"
                )
                with open(path, "w") as f:
                    json.dump(payload, f)
                payload["path"] = path
            except OSError:
                pass  # the dump is best-effort: a full disk must not turn
                # a recoverable stall into an unrecoverable crash
        with self._lock:
            self.last = payload
        return payload


FLIGHT = FlightRecorder(TRACER)


def flight_record(reason: str, counters: dict | None = None) -> dict:
    """Snapshot the process trace ring to a post-mortem record (see
    :class:`FlightRecorder`). Called on StallError, ``api.recover()``, and
    fatal sanitizer breaches."""
    return FLIGHT.record(reason, counters)


def last_flight_record() -> dict | None:
    return FLIGHT.last
