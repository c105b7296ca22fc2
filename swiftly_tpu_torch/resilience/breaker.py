"""Per-dependency circuit breaker: fail fast instead of piling on.

A fleet front that keeps routing requests at a dead or struggling
replica converts one failure into many: every routed request waits out
a timeout, retries pile onto the struggling device, and the survivors'
capacity drains into futile re-sends. The breaker is the classic
remedy (the pattern DaggerFFT's scheduler applies to failed FFT
workers, arXiv 2601.12209): after ``failure_threshold`` CONSECUTIVE
failures the breaker **opens** and the router stops offering traffic;
after a jittered, escalating reopen delay it goes **half-open** and
admits a bounded number of probe requests; probe successes **close**
it again, a probe failure re-opens it with a longer delay.

States and transitions::

            failures >= threshold                reopen deadline passed
    CLOSED ───────────────────────▶ OPEN ───────────────────────────▶ HALF_OPEN
      ▲                              ▲                                   │
      │   half_open_probes successes │        any probe failure          │
      └──────────────────────────────┼───────────────────────────────────┤
                                     └───────────────────────────────────┘

The reopen delay reuses the PR-4 jittered exponential curve
(`resilience.retry.backoff_delay` over the consecutive-open count,
capped at ``max_reopen_s``) so repeatedly-failing replicas are probed
ever less often — and, with a seeded ``rng``, deterministically in
drills. Every transition is recorded in ``transitions`` (bounded),
counted (``breaker.to_<state>`` via `obs.metrics`) and landed on the
trace as an instant event, so a chaos-drill artifact can show the full
open → half-open → closed cycle.

Thread-safe; ``clock`` and ``rng`` are injectable for deterministic
tests. See docs/resilience.md for the vocabulary.

The port of the JAX package's ``swiftly_tpu/resilience/breaker.py``,
unchanged in behaviour; its user, the serving fleet, is ROADMAP A12.
"""

from __future__ import annotations

import threading
import time

from ..obs import metrics as _metrics
from ..obs import recorder as _recorder
from ..obs import trace as _trace
from .retry import backoff_delay

__all__ = ["CLOSED", "HALF_OPEN", "OPEN", "CircuitBreaker"]

CLOSED = "closed"          # traffic flows; consecutive failures counted
OPEN = "open"              # no traffic until the reopen deadline
HALF_OPEN = "half_open"    # a bounded number of probe requests flow

_MAX_TRANSITIONS = 256  # bound the recorded trail on pathological flapping


class CircuitBreaker:
    """Closed → open → half-open → closed failure gate for one target.

    :param name: metrics/trace label (e.g. ``"replica-2"``)
    :param failure_threshold: consecutive failures that open the breaker
    :param reopen_s: base of the open→half-open delay; each consecutive
        open doubles it (jittered, capped at ``max_reopen_s``)
    :param max_reopen_s: reopen-delay cap
    :param half_open_probes: probe requests admitted while half-open;
        the same number of successes closes the breaker
    :param rng: seeded RNG for the reopen jitter (deterministic drills)
    :param clock: injectable monotonic clock for tests
    """

    def __init__(self, name="", failure_threshold=3, reopen_s=0.5,
                 max_reopen_s=30.0, half_open_probes=2, rng=None,
                 clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if half_open_probes < 1:
            raise ValueError("half_open_probes must be >= 1")
        self.name = name
        self.failure_threshold = int(failure_threshold)
        self.reopen_s = float(reopen_s)
        self.max_reopen_s = float(max_reopen_s)
        self.half_open_probes = int(half_open_probes)
        self._rng = rng
        self._clock = clock
        self._lock = threading.RLock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._open_count = 0        # consecutive opens (escalates reopen)
        self._reopen_t = None       # open → half-open deadline
        self._probes_inflight = 0
        self._probe_successes = 0
        self.transitions = []       # [{"t", "from", "to", "reason"}, ...]
        self.dropped_transitions = 0

    # -- state ---------------------------------------------------------------

    @property
    def state(self):
        """The breaker's current state (``open`` stays ``open`` until a
        probe is actually admitted by `allow` — state peeks never
        transition)."""
        with self._lock:
            return self._state

    def _transition(self, to, reason, now):
        frm = self._state
        self._state = to
        if len(self.transitions) < _MAX_TRANSITIONS:
            self.transitions.append(
                {"t": round(now, 6), "from": frm, "to": to,
                 "reason": reason}
            )
        else:
            self.dropped_transitions += 1
        _metrics.count(f"breaker.to_{to}")
        if self.name:
            _metrics.count(f"breaker.{self.name}.to_{to}")
        _trace.instant("breaker.transition", cat="breaker",
                       breaker=self.name, frm=frm, to=to, reason=reason)
        _recorder.record("breaker",
                         f"breaker.{self.name or 'default'}.{frm}->{to}",
                         reason)

    # -- the gate ------------------------------------------------------------

    def allow(self, now=None):
        """May one request pass right now?

        CLOSED always allows. OPEN denies until the reopen deadline,
        then transitions to HALF_OPEN and admits the call as the first
        probe. HALF_OPEN admits up to ``half_open_probes`` in-flight
        probes. Callers that route a request after a True MUST report
        its outcome via `record_success` / `record_failure` — in
        half-open, that report is what closes (or re-opens) the breaker.
        """
        with self._lock:
            if self._state == CLOSED:
                return True
            now = self._clock() if now is None else now
            if self._state == OPEN:
                if self._reopen_t is not None and now >= self._reopen_t:
                    self._transition(
                        HALF_OPEN,
                        f"reopen deadline passed after "
                        f"{self._open_count} open(s)", now,
                    )
                    self._probes_inflight = 1
                    self._probe_successes = 0
                    return True
                return False
            # HALF_OPEN: bounded probe admission
            if self._probes_inflight < self.half_open_probes:
                self._probes_inflight += 1
                return True
            return False

    # -- outcome reports -----------------------------------------------------

    def record_success(self, now=None):
        """One request against the target succeeded."""
        with self._lock:
            self._consecutive_failures = 0
            if self._state == HALF_OPEN:
                self._probes_inflight = max(0, self._probes_inflight - 1)
                self._probe_successes += 1
                if self._probe_successes >= self.half_open_probes:
                    now = self._clock() if now is None else now
                    self._open_count = 0
                    self._transition(
                        CLOSED,
                        f"{self._probe_successes} probe successes", now,
                    )

    def record_failure(self, now=None, reason=""):
        """One request against the target failed (or timed out)."""
        with self._lock:
            now = self._clock() if now is None else now
            if self._state == HALF_OPEN:
                # a probe failure re-opens with an escalated delay
                self._probes_inflight = max(0, self._probes_inflight - 1)
                self._open(now, reason or "half-open probe failed")
                return
            if self._state == OPEN:
                return  # already open; nothing new to learn
            self._consecutive_failures += 1
            if self._consecutive_failures >= self.failure_threshold:
                self._open(
                    now,
                    reason
                    or f"{self._consecutive_failures} consecutive failures",
                )

    def trip(self, now=None, reason="tripped"):
        """Force the breaker open on external evidence (e.g. a health
        lease revocation) — stronger than one request failure, so it
        does not wait out ``failure_threshold``. A no-op when already
        open."""
        with self._lock:
            if self._state == OPEN:
                return
            now = self._clock() if now is None else now
            self._probes_inflight = 0
            self._open(now, reason)

    def _open(self, now, reason):  # caller holds the lock
        self._open_count += 1
        self._consecutive_failures = 0
        # the PR-4 jittered exponential curve over consecutive opens:
        # a target that keeps failing its probes is probed ever less
        # often, and seeded rng makes the drill schedule replayable
        delay = backoff_delay(
            self._open_count - 1, base_s=self.reopen_s,
            max_s=self.max_reopen_s, rng=self._rng,
        )
        self._reopen_t = now + delay
        self._transition(OPEN, f"{reason} (reopen in {delay:.3f}s)", now)

    # -- export --------------------------------------------------------------

    def stats(self):
        """JSON-ready breaker summary for fleet artifacts."""
        with self._lock:
            return {
                "name": self.name,
                "state": self._state,
                "open_count": self._open_count,
                "consecutive_failures": self._consecutive_failures,
                "transitions": list(self.transitions),
                "dropped_transitions": self.dropped_transitions,
            }

    def __repr__(self):
        return (
            f"CircuitBreaker({self.name!r}, state={self.state}, "
            f"opens={self._open_count})"
        )
