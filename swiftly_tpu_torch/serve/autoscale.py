"""`FleetAutoscaler`: elastic replica count from the journey signal.

The request-journey decomposition tells a fleet *where* latency lives;
the autoscaler turns its aggregate — `ServeFleet.queue_share`, the
recent queue-wait share of request latency — into replica-count policy
over a ``[min_replicas, max_replicas]`` band:

* **scale out** — queue share at/above ``up_share`` with real backlog
  (``queued_depth >= min_queue_depth``) for ``hold_ticks`` consecutive
  evaluations: requests are spending their lives waiting, so add a
  replica (`ServeFleet.add_replica` — with a cache fabric attached the
  newcomer gets a feed VIEW over the one resident stream, so scale-out
  costs an L1, not a stream copy);
* **scale in** — queue share at/below ``down_share`` AND a near-empty
  fleet queue for ``hold_ticks`` evaluations: drain the least-loaded
  replica through the fleet's zero-loss path (`ServeFleet.begin_drain`:
  routing stops, its backlog completes or fails over, then the pump
  retires — an admitted request is never dropped by scale-in).

Hysteresis is structural: ``down_share`` sits well below ``up_share``
(the band between them is dead zone), actions need ``hold_ticks``
consecutive signals, and ``cooldown_s`` separates consecutive actions —
one zipf burst cannot flap the fleet. Drive it by attaching to the
fleet (``fleet.autoscaler = scaler`` — the supervisor tick evaluates
it) or call `tick` directly with an injected clock (tests, bench).

The signals come from the fleet's `obs.tower.ControlTower`. Attached to a fleet, the supervisor tick passes the tower's per-tick
sample into `tick(signals=...)` — the SAME values the brownout ladder
read that tick; a direct `tick()` call samples the tower on demand (or
falls back to the raw fleet methods when no tower exists). Decisions
are bit-identical either way — the tower sample IS
``fleet.queue_share()``/``queued_depth()`` read once.

The port of the JAX package's ``swiftly_tpu/serve/autoscale.py``.
"""

from __future__ import annotations

import logging
import time

from ..obs import metrics as _metrics
from ..obs import recorder as _recorder
from ..obs import trace as _trace

__all__ = ["FleetAutoscaler"]

log = logging.getLogger(__name__)

_MAX_EVENTS = 256


class FleetAutoscaler:
    """Queue-share-driven replica band controller for a `ServeFleet`.

    :param fleet: the `ServeFleet` to scale
    :param min_replicas / max_replicas: the replica band (inclusive)
    :param up_share: queue-wait share of latency at/above which
        pressure accumulates toward a scale-out
    :param down_share: share at/below which idleness accumulates toward
        a drain; must sit below ``up_share`` (the hysteresis dead zone)
    :param min_queue_depth: fleet-wide queued requests required before
        a scale-out (share alone can be noisy on a near-idle fleet)
    :param hold_ticks: consecutive one-sided evaluations required
        before acting
    :param cooldown_s: minimum seconds between actions (lets the last
        action's effect reach the signal before the next decision)
    :param clock: injectable monotonic clock (defaults to the fleet's)
    """

    def __init__(self, fleet, *, min_replicas=1, max_replicas=8,
                 up_share=0.6, down_share=0.15, min_queue_depth=8,
                 hold_ticks=3, cooldown_s=0.5, clock=None):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas "
                f"(got {min_replicas}, {max_replicas})"
            )
        if not 0.0 <= down_share < up_share:
            raise ValueError(
                "need 0 <= down_share < up_share (the gap is the "
                f"hysteresis dead zone; got {down_share}, {up_share})"
            )
        self.fleet = fleet
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_share = float(up_share)
        self.down_share = float(down_share)
        self.min_queue_depth = int(min_queue_depth)
        self.hold_ticks = int(hold_ticks)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock or getattr(fleet, "_clock", time.monotonic)
        self._up_ticks = 0
        self._down_ticks = 0
        self._last_action_t = None
        self.events = []
        self._counts = {"ticks": 0, "scale_outs": 0, "drains": 0,
                        "held_by_band": 0, "held_by_cooldown": 0}
        tower = getattr(fleet, "tower", None)
        if tower is not None:
            tower.register_source(
                "autoscaler",
                lambda: {"counters": dict(self._counts),
                         "band": [self.min_replicas, self.max_replicas]},
                kind="controller",
            )

    # -- policy --------------------------------------------------------------

    def tick(self, now=None, signals=None):
        """One policy evaluation; returns ``"scale_out"``, ``"drain"``
        or None. Safe to call from the fleet supervisor (scale-in is
        initiated, not awaited — `ServeFleet.begin_drain` retires the
        replica on a later supervision pass once its work is gone).

        ``signals`` is the tower's per-tick sample (the supervisor
        passes the one it already took this tick); absent, the fleet's
        tower is sampled on demand, and a tower-less fleet falls back
        to reading the raw signals directly."""
        now = self._clock() if now is None else now
        self._counts["ticks"] += 1
        if signals is None:
            tower = getattr(self.fleet, "tower", None)
            if tower is not None:
                signals = tower.sample(now)
        if signals is not None and "fleet.queue_share" in signals:
            share = signals["fleet.queue_share"]
            depth = int(signals.get("fleet.queued_depth", 0))
        else:
            share = self.fleet.queue_share()
            depth = self.fleet.queued_depth()
        n = len(self.fleet.replicas)
        if share >= self.up_share and depth >= self.min_queue_depth:
            self._up_ticks += 1
            self._down_ticks = 0
        elif (
            share <= self.down_share
            and depth <= max(1, self.min_queue_depth // 4)
        ):
            self._down_ticks += 1
            self._up_ticks = 0
        else:
            # dead zone: both streaks reset — hysteresis demands an
            # unbroken one-sided signal
            self._up_ticks = 0
            self._down_ticks = 0
        if (
            self._last_action_t is not None
            and now - self._last_action_t < self.cooldown_s
        ):
            self._counts["held_by_cooldown"] += 1
            return None
        if self._up_ticks >= self.hold_ticks:
            self._up_ticks = 0
            if n >= self.max_replicas:
                self._counts["held_by_band"] += 1
                return None
            rid = self.fleet.add_replica()
            self._acted(now, "scale_out", rid, share, depth, n + 1)
            return "scale_out"
        if self._down_ticks >= self.hold_ticks:
            self._down_ticks = 0
            if n <= self.min_replicas:
                self._counts["held_by_band"] += 1
                return None
            rid = self._drain_candidate()
            if rid is None:
                return None
            self.fleet.begin_drain(rid)
            self._acted(now, "drain", rid, share, depth, n - 1)
            return "drain"
        return None

    def _drain_candidate(self):
        """The least-loaded live, non-draining replica (smallest queue,
        ties to the highest rid — later scale-outs drain first, so the
        core fleet keeps its warm forwards)."""
        best = None
        for rid, replica in self.fleet.replicas.items():
            if replica.dead or replica.lease.revoked:
                continue
            if rid in getattr(self.fleet, "draining", ()):
                continue
            load = len(replica.service.queue)
            if best is None or (load, -rid) < (best[1], -best[0]):
                best = (rid, load)
        return None if best is None else best[0]

    def _acted(self, now, action, rid, share, depth, n_after):
        self._last_action_t = now
        self._counts["scale_outs" if action == "scale_out" else
                     "drains"] += 1
        if len(self.events) < _MAX_EVENTS:
            self.events.append(
                {"t": round(now, 6), "action": action, "replica": rid,
                 "queue_share": round(share, 4), "depth": depth,
                 "n_replicas": n_after}
            )
        _metrics.count(f"autoscale.{action}")
        _trace.instant(f"autoscale.{action}", cat="fleet", replica=rid,
                       queue_share=round(share, 4), depth=depth)
        _recorder.record("autoscale", f"autoscale.{action}",
                         f"replica {rid} share={share:.3f} "
                         f"depth={depth} -> {n_after}")
        log.info(
            "autoscale %s: replica %d (share=%.3f depth=%d -> %d "
            "replicas)", action, rid, share, depth, n_after,
        )

    # -- export --------------------------------------------------------------

    def stats(self):
        """JSON-ready autoscaler block for fleet artifacts."""
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "up_share": self.up_share,
            "down_share": self.down_share,
            "hold_ticks": self.hold_ticks,
            "cooldown_s": self.cooldown_s,
            **self._counts,
            "events": list(self.events),
        }
