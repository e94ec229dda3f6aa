"""Engine supervisor: crash-only replica recovery as a supervised lifecycle.

The JAX package's `runtime/supervisor.py`, copied whole for the port
(stdlib only; it reads the port's telemetry and tracing). On the card the
rebuild closes the old engine, whose graph pool goes with it, before the
new one loads (server/api.py `ApiState._rebuild_engine`).

The serving tier's failure handling grew bottom-up — the watchdog's
`StallError` gets one in-place retry, `api.recover()` resets the
engine and drops the prefix cache, and the gateway's breaker routes around
a dead replica — but every piece assumed the failure was *transient*: one
engine reset, then business as usual. At fleet scale the dangerous
failures are *sticky*: a wedged device runtime that stalls every
subsequent step, a sealed-sentinel breach that means the compiled ladder
no longer matches what serving dispatches, an engine exception that left
the KV pool or dispatch pipeline in an unknown state. Resetting a cache
does not fix any of those — only tearing the engine down and rebuilding it
from the weights up does (crash-only software: recovery IS restart).

This module is the state machine that decides *when* to rebuild and makes
the whole lifecycle observable:

* ``serving``    — the steady state;
* ``recovering`` — a rebuild is in progress: the replica's ``/health``
  reports it with a 503 (the gateway's active prober opens the breaker and
  routes away — the same signal path an operator drain uses), new chat
  requests shed immediately, and the engine-owning thread tears down the
  old engine (sentinel unsubscribed — a sealed fatal sentinel must never
  outlive its engine), builds a fresh one (fresh KV pool, fresh prefix
  cache), re-runs the warm ladder (``warmup()`` re-seals a FRESH recompile
  sentinel), and rejoins;
* ``failed``     — the restart budget is exhausted (``max_restarts``
  rebuilds within ``window_s``): the replica stops trying and reports
  unhealthy until an operator intervenes — a crash-looping replica
  rebuilding forever just burns the fleet's retry budget.

Escalation policy (:meth:`EngineSupervisor.classify`):

* ``StallError`` — the first ``stall_limit - 1`` stalls in the window take
  the cheap path (engine reset; the in-place retry machinery covers them);
  hitting ``stall_limit`` means the stall is sticky — rebuild;
* a fatal sanitizer breach (``RecompileError``, host-sync violation) —
  rebuild: the sealed ladder provably no longer covers what serving
  dispatches, and every further request would re-breach;
* any other unhandled engine exception — rebuild: the engine's device
  state is unknown, and "reset and hope" is how one poisoned replica
  serves corrupt KV for a week.

Every transition bumps ``dlt_supervisor_transitions_total{state=...}``,
dumps a flight record (the trace ring still holds the failing request's
spans), and lands a trace event. Rebuild attempts within the window pay
exponential backoff (``backoff_s`` doubling up to ``backoff_max_s``) so a
crash-looping build doesn't hot-spin the host.

The supervisor is deliberately engine-agnostic: the host (server/api.py
``ApiState``) supplies ``rebuild_fn``, and every decision method is a
host-side dict/clock touch — safe to call from the engine-owning thread
(the Batcher loop / the serialized handler), which is exactly where
rebuilds must run (the engine's dispatches are single-threaded by design).
"""

from __future__ import annotations

import os
import threading
import time

#: the supervisor states dlt_supervisor_transitions_total is labeled with
#: (zero-valued states always render — dashboards must exist before the
#: first incident)
SUPERVISOR_STATES = ("serving", "recovering", "failed")

SERVING = "serving"
RECOVERING = "recovering"
FAILED = "failed"


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


class SupervisorConfig:
    """Restart-budget knobs (``DLT_SUPERVISOR_*`` envs):

    * ``max_restarts`` — rebuilds allowed inside ``window_s`` before the
      replica gives up (state ``failed``); the budget is a sliding window,
      so a replica that crashed twice last week is not one strike from
      death forever;
    * ``stall_limit``  — StallErrors inside the window before a stall is
      treated as sticky (rebuild instead of reset); the default of 2
      matches the serving path's one-in-place-retry contract: the retry's
      second stall IS the exhaustion signal;
    * ``backoff_s`` / ``backoff_max_s`` — exponential pre-rebuild delay
      (the second rebuild in a window waits 2x, the third 4x, ...).
    """

    def __init__(
        self,
        max_restarts: int | None = None,
        window_s: float | None = None,
        stall_limit: int | None = None,
        backoff_s: float | None = None,
        backoff_max_s: float | None = None,
    ):
        self.max_restarts = (
            max_restarts
            if max_restarts is not None
            else _env_int("DLT_SUPERVISOR_RESTARTS", 3)
        )
        self.window_s = (
            window_s
            if window_s is not None
            else _env_float("DLT_SUPERVISOR_WINDOW_S", 600.0)
        )
        self.stall_limit = (
            stall_limit
            if stall_limit is not None
            else _env_int("DLT_SUPERVISOR_STALL_LIMIT", 2)
        )
        self.backoff_s = (
            backoff_s
            if backoff_s is not None
            else _env_float("DLT_SUPERVISOR_BACKOFF_S", 0.5)
        )
        self.backoff_max_s = (
            backoff_max_s
            if backoff_max_s is not None
            else _env_float("DLT_SUPERVISOR_BACKOFF_MAX_S", 30.0)
        )

    def snapshot(self) -> dict:
        return {
            "max_restarts": self.max_restarts,
            "window_s": self.window_s,
            "stall_limit": self.stall_limit,
            "backoff_s": self.backoff_s,
            "backoff_max_s": self.backoff_max_s,
        }


class EngineSupervisor:
    """The replica's engine-lifecycle state machine.

    ``rebuild_fn()`` is the host's teardown-and-rebuild (ApiState
    ``_rebuild_engine``: close the old engine — sentinel unsubscribed —
    build + warm a fresh one, swap it in). It runs on whichever thread
    calls :meth:`recover` — by contract the engine-owning thread, so the
    rebuild can never race a live dispatch.

    Thread-safety: state/budget mutations are under one lock; ``state`` is
    read lock-free by the health endpoint and admission checks (a stale
    read there costs one extra 503, never a race on the engine itself).
    """

    def __init__(self, rebuild_fn, config: SupervisorConfig | None = None,
                 sleep_fn=time.sleep):
        self.rebuild_fn = rebuild_fn
        self.config = config or SupervisorConfig()
        self._sleep = sleep_fn  # injectable: tests must not pay real backoff
        self._lock = threading.Lock()
        self.state = SERVING
        self.transitions = {s: 0 for s in SUPERVISOR_STATES}
        self.last_reason = ""
        self._restarts: list[float] = []   # rebuild timestamps (window)
        self._stalls: list[float] = []     # StallError timestamps (window)
        self.rebuilds_total = 0
        self.resets_total = 0

    # -- policy --------------------------------------------------------------

    def classify(self, exc: BaseException | None) -> str:
        """``"reset"`` or ``"rebuild"`` for one engine failure. StallError
        stays cheap until it proves sticky (``stall_limit`` in the
        window); everything else — fatal sanitizer breaches and unknown
        engine exceptions — rebuilds (the engine's state is unknown)."""
        from .telemetry import StallError

        if isinstance(exc, StallError):
            now = time.monotonic()
            with self._lock:
                self._stalls.append(now)
                self._trim_locked(self._stalls, now)
                if len(self._stalls) >= self.config.stall_limit:
                    self._stalls.clear()
                    return "rebuild"
            return "reset"
        return "rebuild"

    def _trim_locked(self, stamps: list, now: float):
        cutoff = now - self.config.window_s
        while stamps and stamps[0] < cutoff:
            stamps.pop(0)

    def budget_left(self) -> int:
        now = time.monotonic()
        with self._lock:
            self._trim_locked(self._restarts, now)
            return max(self.config.max_restarts - len(self._restarts), 0)

    # -- transitions ---------------------------------------------------------

    def _transition(self, state: str, reason: str):
        with self._lock:
            self.state = state
            self.transitions[state] = self.transitions.get(state, 0) + 1
            self.last_reason = reason
        # post-mortem + trace: the ring still holds the failing request's
        # spans; the flight record is the operator's reconstruction kit
        from .tracing import flight_record, global_event

        global_event(
            "supervisor_transition", keys=("state", "reason"),
            vals=(state, reason),
        )
        if state != SERVING:
            flight_record(f"supervisor:{state}:{reason}")

    def note_reset(self, reason: str):
        """A cheap in-place engine reset handled the failure (no state
        change — the replica never left serving)."""
        with self._lock:
            self.resets_total += 1
            self.last_reason = reason

    def note_ok(self):
        """A request completed successfully: the engine demonstrably
        recovered, so the stall strike window clears — "exhaustion" means
        stalls WITHOUT an intervening success (the in-place-retry
        contract), not N transient stalls spread over a quiet hour. The
        restart BUDGET does not clear: rebuilds are expensive however
        well the replica serves between them."""
        if not self._stalls:
            return  # lock-free fast path: the common case is no strikes
        with self._lock:
            self._stalls.clear()

    def enter_recovering(self, reason: str):
        """Pre-transition to ``recovering`` BEFORE the caller unblocks the
        failed requests' writers: by the time any 500 reaches a client,
        ``/health`` must already answer ``recovering`` — a client that
        polls after its 500 must never read a stale ``serving`` with the
        rebuild still ahead (then get shed by it moments later)."""
        if self.state != RECOVERING:
            self._transition(RECOVERING, reason)

    def recover(self, reason: str, stats=None) -> bool:
        """Run one supervised rebuild: transition to ``recovering`` (a
        no-op when :meth:`enter_recovering` already did), pay the backoff,
        call ``rebuild_fn``, rejoin (or ``failed`` when the budget is gone
        / the rebuild itself died). Returns True when the replica is
        serving again. MUST be called from the engine-owning thread."""
        now = time.monotonic()
        with self._lock:
            self._trim_locked(self._restarts, now)
            if len(self._restarts) >= self.config.max_restarts:
                exhausted = True
            else:
                exhausted = False
                n_recent = len(self._restarts)
                self._restarts.append(now)
        if exhausted:
            self._transition(FAILED, f"restart budget exhausted ({reason})")
            if stats is not None:
                stats.incr("supervisor_budget_exhausted")
            return False
        if self.state != RECOVERING:
            self._transition(RECOVERING, reason)
        if stats is not None:
            stats.incr("supervisor_rebuilds")
        # exponential backoff: the FIRST rebuild in a window is immediate
        # (the fleet is down a replica; don't dawdle), repeats wait
        if n_recent > 0:
            delay = min(
                self.config.backoff_s * (2 ** (n_recent - 1)),
                self.config.backoff_max_s,
            )
            self._sleep(delay)
        try:
            self.rebuild_fn()
        except Exception:
            # the rebuild itself died (bad weights path, OOM): the replica
            # cannot self-heal — report failed instead of crash-looping
            self._transition(FAILED, f"rebuild failed ({reason})")
            if stats is not None:
                stats.incr("supervisor_rebuild_failed")
            raise
        with self._lock:
            self.rebuilds_total += 1
        self._transition(SERVING, f"rejoined after {reason}")
        return True

    # -- views ---------------------------------------------------------------

    def transitions_series(self) -> list:
        """``[(labels, value), ...]`` for the labeled counter family —
        every state present, zeros included (the dashboard-exists-before-
        the-incident contract every counter family here keeps)."""
        with self._lock:
            t = dict(self.transitions)
        return [({"state": s}, t.get(s, 0)) for s in SUPERVISOR_STATES]

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            self._trim_locked(self._restarts, now)
            return {
                "state": self.state,
                "last_reason": self.last_reason,
                "transitions": dict(self.transitions),
                "rebuilds_total": self.rebuilds_total,
                "resets_total": self.resets_total,
                "restarts_in_window": len(self._restarts),
                "config": self.config.snapshot(),
            }
