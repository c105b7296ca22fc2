"""Replica health: heartbeat leases and the fleet's health monitor.

A fleet of long-lived serve replicas cannot ask a dead replica whether
it is dead — liveness must be *inferred*. The inference here is the
standard lease protocol (the failover precondition DaggerFFT's
scheduler relies on, arXiv 2601.12209; device processes in practice
get preempted mid-run): each replica's pump loop
**beats** its `HealthLease` every iteration, and the monitor grades
replicas by missed beats:

* ``live``      — fewer than ``miss_suspect`` beat intervals missed;
* ``suspect``   — at least ``miss_suspect`` missed: the monitor fires
  an active **probe** (through the ``fleet.health.probe`` fault site,
  so drills can fail probes deterministically). A successful probe
  renews the lease (a slow-but-alive replica is *revived*, not
  failed over — the lease revival race is a non-event by design); a
  failed probe revokes immediately;
* ``revoked``   — ``miss_revoke`` intervals missed (or a probe failed
  while suspect): the replica is dead to the router, and the fleet
  fails its work over. Revocation LATCHES: a zombie replica's late
  beat after revocation is counted (``health.zombie_beats``) but
  ignored — re-admission requires an explicit `HealthLease.revive`
  (the restore path), never a stray heartbeat.

Clocks are injectable so every state machine here is testable without
sleeping; transitions are recorded (bounded), counted via `obs.metrics`
(``health.suspect`` / ``health.revoked`` / ``health.revived``) and
landed on the trace, so a drill artifact shows the detection timeline
next to the kill it reacted to.

The port of the JAX package's ``swiftly_tpu/serve/health.py``, on the
port's ``metrics``, ``recorder``, ``trace`` and fault sites.
"""

from __future__ import annotations

import threading
import time

from ..obs import metrics as _metrics
from ..obs import recorder as _recorder
from ..obs import trace as _trace
from ..resilience.faults import fault_point as _fault_point

__all__ = ["LIVE", "REVOKED", "SUSPECT", "HealthLease", "HealthMonitor"]

LIVE = "live"
SUSPECT = "suspect"
REVOKED = "revoked"

_MAX_TRANSITIONS = 256


class HealthLease:
    """One replica's heartbeat lease.

    :param owner: label for metrics/trace (e.g. ``"replica-1"``)
    :param interval_s: expected beat period; staleness is measured in
        units of it
    :param miss_suspect: missed intervals before ``suspect``
    :param miss_revoke: missed intervals before ``revoked``
    :param clock: injectable monotonic clock
    """

    def __init__(self, owner="", interval_s=0.05, miss_suspect=2,
                 miss_revoke=5, clock=time.monotonic):
        if not 0 < miss_suspect <= miss_revoke:
            raise ValueError(
                "need 0 < miss_suspect <= miss_revoke "
                f"(got {miss_suspect}, {miss_revoke})"
            )
        self.owner = owner
        self.interval_s = float(interval_s)
        self.miss_suspect = int(miss_suspect)
        self.miss_revoke = int(miss_revoke)
        self._clock = clock
        self._lock = threading.Lock()
        self.last_beat_t = clock()
        self.beats = 0
        self.zombie_beats = 0
        self._revoked = False

    def beat(self, now=None):
        """Renew the lease; returns False for a zombie beat (the lease
        was already revoked — renewal requires `revive`)."""
        with self._lock:
            if self._revoked:
                self.zombie_beats += 1
                _metrics.count("health.zombie_beats")
                return False
            self.last_beat_t = self._clock() if now is None else now
            self.beats += 1
            return True

    def missed(self, now=None):
        """Beat intervals elapsed since the last renewal."""
        now = self._clock() if now is None else now
        return max(0, int((now - self.last_beat_t) / self.interval_s))

    def state(self, now=None):
        """``live`` / ``suspect`` / ``revoked`` — pure, no side effects
        (revocation itself is the monitor's `revoke` call, which
        latches)."""
        with self._lock:
            if self._revoked:
                return REVOKED
        m = self.missed(now)
        if m >= self.miss_revoke:
            return REVOKED
        if m >= self.miss_suspect:
            return SUSPECT
        return LIVE

    @property
    def revoked(self):
        return self._revoked

    def revoke(self):
        """Latch the lease revoked: beats become zombie beats until
        `revive` (the failover path owns this call)."""
        with self._lock:
            self._revoked = True

    def revive(self, now=None):
        """Explicit re-admission after a restore: clears the latch and
        renews, so the next `state` is ``live``."""
        with self._lock:
            self._revoked = False
            self.last_beat_t = self._clock() if now is None else now

    def __repr__(self):
        return (
            f"HealthLease({self.owner!r}, beats={self.beats}, "
            f"revoked={self._revoked})"
        )


class HealthMonitor:
    """Grades a set of leases and drives suspect-probing.

    :param probe: optional ``fn(owner_key) -> bool`` active liveness
        check, called (through the ``fleet.health.probe`` fault site)
        when a lease turns suspect. True renews the lease; False — or a
        raised exception — revokes it.
    :param clock: injectable monotonic clock
    """

    def __init__(self, probe=None, clock=time.monotonic):
        self.probe = probe
        self._clock = clock
        self._lock = threading.Lock()
        self._leases = {}       # key -> HealthLease
        self._last_state = {}   # key -> last observed state
        self.transitions = []   # [{"t", "owner", "from", "to", "via"}]
        self.dropped_transitions = 0

    def register(self, key, lease):
        with self._lock:
            self._leases[key] = lease
            self._last_state[key] = LIVE
        return lease

    def lease(self, key):
        return self._leases.get(key)

    def unregister(self, key):
        """Retire a lease (the autoscaler's drain path): the monitor
        stops grading it. Without this, a drained replica's idle lease
        would decay to revoked and fire a phantom failover."""
        with self._lock:
            self._leases.pop(key, None)
            self._last_state.pop(key, None)

    def _record(self, now, key, frm, to, via):
        if len(self.transitions) < _MAX_TRANSITIONS:
            self.transitions.append(
                {"t": round(now, 6), "owner": key, "from": frm,
                 "to": to, "via": via}
            )
        else:
            self.dropped_transitions += 1
        _metrics.count(f"health.{to}" if to != LIVE else "health.revived")
        _trace.instant("health.transition", cat="health", owner=key,
                       frm=frm, to=to, via=via)
        _recorder.record("lease", f"health.{key}.{frm}->{to}", via)

    def check(self, now=None):
        """One grading pass; returns the transitions it observed as
        ``[(key, from_state, to_state), ...]``.

        A suspect lease is probed (when a probe fn is installed):
        success renews — the slow replica is revived without failover;
        failure (or a probe exception, including an injected
        ``fleet.health.probe`` fault) revokes immediately rather than
        waiting out ``miss_revoke``.
        """
        now = self._clock() if now is None else now
        out = []
        with self._lock:
            items = list(self._leases.items())
        for key, lease in items:
            state = lease.state(now)
            if state == SUSPECT and self.probe is not None:
                ok = False
                try:
                    _fault_point("fleet.health.probe")
                    ok = bool(self.probe(key))
                except Exception:  # noqa: BLE001 - a failed probe IS data
                    ok = False
                _metrics.count(
                    "health.probe_ok" if ok else "health.probe_failed"
                )
                if ok:
                    lease.beat(now)
                    state = LIVE
                else:
                    state = REVOKED
            if state == REVOKED and not lease.revoked:
                lease.revoke()
            prev = self._last_state.get(key, LIVE)
            if state != prev:
                self._last_state[key] = state
                self._record(now, key, prev, state,
                             via="probe" if self.probe else "lease")
                out.append((key, prev, state))
        return out

    def revive(self, key, now=None):
        """Re-admit a restored replica: lease revived, state live."""
        now = self._clock() if now is None else now
        lease = self._leases[key]
        lease.revive(now)
        prev = self._last_state.get(key, LIVE)
        if prev != LIVE:
            self._last_state[key] = LIVE
            self._record(now, key, prev, LIVE, via="revive")

    def states(self, now=None):
        now = self._clock() if now is None else now
        return {k: v.state(now) for k, v in self._leases.items()}

    def stats(self):
        """JSON-ready health summary for fleet artifacts."""
        with self._lock:
            return {
                "states": self.states(),
                "transitions": list(self.transitions),
                "dropped_transitions": self.dropped_transitions,
                "zombie_beats": sum(
                    l.zombie_beats for l in self._leases.values()
                ),
            }
