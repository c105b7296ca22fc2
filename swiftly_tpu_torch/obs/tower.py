"""Fleet control tower: cross-source telemetry aggregation, windowed
signals, and SLO burn-rate alerts.

PRs 1/5 gave every *process* metrics and traces; the system has since
become a fleet — N serve replicas behind `serve.ServeFleet`, an
autoscaler, a shared cache fabric, elastic mesh recovery — and a
cross-replica incident was reconstructed by hand from per-process
JSONL. The tower is the missing aggregation point (the global-timeline
argument DaggerFFT makes for task-scheduled distributed FFTs,
arXiv 2601.12209):

* **Sources.** Each replica, the cache fabric, the autoscaler, the
  fleet itself (and, in the mesh drills, the recovery orchestrator)
  registers a *named telemetry source*: a callable returning a
  JSON-ready dict with optional ``counters`` (flat name → number) and
  ``stages`` (name → ``{"count", "total_s"}``) blocks.
  `fleet_telemetry` merges them into ONE artifact block — per-source
  breakdowns plus fleet ``totals`` that are exactly the per-source
  sums (re-derived and asserted by
  `validate_fleet_telemetry_artifact`).
* **Windowed signals.** Registered signal callables (queue share,
  queued depth, p99, shed rate, cache hit ratio...) are sampled once
  per supervisor tick into sliding windows. The brownout ladder and
  the `serve.FleetAutoscaler` consume THE SAME per-tick sample instead
  of each recomputing the signal — one clock, one value, bit-identical
  decisions.
* **SLO burn-rate alerts.** Declarative `SLO` specs are evaluated
  every tick with the classic multi-window rule: an alert OPENS when
  the breach fraction over both the fast and the slow window reaches
  the burn threshold (a blip cannot page), and CLOSES when the fast
  window clears (recovery is seen quickly). Open/close events land in
  the flight recorder (`obs.recorder`), on the trace, and in the
  ``alerts`` artifact block (`validate_alerts_artifact`).
* **Per-source Perfetto tracks.** Fleet threads name their trace
  tracks (`trace.name_track`), so the existing Chrome exporter renders
  one labelled row per source and ``report.by_source`` groups the
  self-time attribution the same way.

The port of the JAX package's ``swiftly_tpu/obs/tower.py``, on the
port's ``metrics``, ``recorder`` and ``trace``.
"""

from __future__ import annotations

import collections
import threading
import time

from . import metrics as _metrics
from . import recorder as _recorder
from . import trace as _trace

__all__ = [
    "SLO",
    "ControlTower",
    "validate_alerts_artifact",
    "validate_fleet_telemetry_artifact",
]

_WINDOW_SAMPLES = 4096  # per-signal sample ring
_MAX_ALERT_EVENTS = 256


class SLO:
    """One declarative objective over a registered tower signal.

    :param name: alert name (e.g. ``"queue_share"``)
    :param signal: the tower signal it watches (e.g.
        ``"fleet.queue_share"``)
    :param threshold: the objective boundary
    :param direction: ``"above"`` — a sample BREACHES when it exceeds
        ``threshold`` (latency, shed rate, queue share);
        ``"below"`` — a sample breaches when it falls under it (cache
        hit ratio, MFU floor)
    :param fast_s / slow_s: the two burn-rate windows in seconds
    :param burn: breach fraction (0..1] a window must reach to count
        as burning
    """

    __slots__ = ("name", "signal", "threshold", "direction", "fast_s",
                 "slow_s", "burn")

    def __init__(self, name, signal, threshold, direction="above",
                 fast_s=1.0, slow_s=5.0, burn=0.5):
        if direction not in ("above", "below"):
            raise ValueError(
                f"direction must be 'above' or 'below', got {direction!r}"
            )
        if not 0.0 < burn <= 1.0:
            raise ValueError(f"burn must be in (0, 1], got {burn!r}")
        if not 0.0 < fast_s <= slow_s:
            raise ValueError(
                f"need 0 < fast_s <= slow_s (got {fast_s}, {slow_s})"
            )
        self.name = str(name)
        self.signal = str(signal)
        self.threshold = float(threshold)
        self.direction = direction
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.burn = float(burn)

    def breached(self, value):
        if self.direction == "above":
            return value > self.threshold
        return value < self.threshold

    def spec(self):
        return {
            "name": self.name,
            "signal": self.signal,
            "threshold": self.threshold,
            "direction": self.direction,
            "fast_s": self.fast_s,
            "slow_s": self.slow_s,
            "burn": self.burn,
        }


class ControlTower:
    """The fleet-wide aggregation point: sources, signals, alerts.

    :param clock: injectable monotonic clock (share the fleet's so
        windows align with supervision ticks)
    :param slos: initial iterable of `SLO` specs
    """

    def __init__(self, *, clock=time.monotonic, slos=()):
        self._clock = clock
        self._lock = threading.Lock()
        self._sources = {}   # name -> (kind, callable)
        self._signals = {}   # name -> callable
        self._windows = {}   # signal -> deque[(t, value)]
        self._latest = {}    # signal -> last sampled value
        self.slos = [s if isinstance(s, SLO) else SLO(**s) for s in slos]
        self._alerts = {}    # slo name -> open alert dict
        self._alert_events = []
        self._counts = {
            "samples": 0, "alerts_opened": 0, "alerts_closed": 0,
            "source_errors": 0,
        }

    # -- sources -------------------------------------------------------------

    def register_source(self, name, fn, kind="replica"):
        """Register one named telemetry source: ``fn()`` must return a
        JSON-ready dict (optional ``counters``/``stages`` blocks feed
        the fleet totals). Re-registering a name replaces it."""
        with self._lock:
            self._sources[str(name)] = (str(kind), fn)

    def unregister_source(self, name):
        with self._lock:
            self._sources.pop(str(name), None)

    @property
    def sources(self):
        with self._lock:
            return {n: kind for n, (kind, _fn) in self._sources.items()}

    # -- signals -------------------------------------------------------------

    def register_signal(self, name, fn):
        """Register one windowed signal: ``fn()`` returns the current
        float value; the tower samples it on every `tick`."""
        with self._lock:
            self._signals[str(name)] = fn
            self._windows.setdefault(
                str(name), collections.deque(maxlen=_WINDOW_SAMPLES)
            )

    def signal(self, name, default=0.0):
        """The most recently sampled value of one signal."""
        with self._lock:
            return self._latest.get(name, default)

    def sample(self, now=None):
        """Sample every registered signal once into its window; returns
        ``{signal: value}`` — THE per-tick sample the brownout ladder
        and the autoscaler consume (one clock read, one value, shared
        by every consumer)."""
        now = self._clock() if now is None else now
        with self._lock:
            fns = list(self._signals.items())
        out = {}
        for name, fn in fns:
            try:
                v = float(fn())
            except Exception:  # noqa: BLE001 - a signal must not kill ticks
                self._counts["source_errors"] += 1
                continue
            out[name] = v
        with self._lock:
            for name, v in out.items():
                self._windows[name].append((now, v))
                self._latest[name] = v
            self._counts["samples"] += 1
        return out

    def window(self, name, seconds, now=None):
        """``[(t, value), ...]`` samples of one signal from the last
        ``seconds``."""
        now = self._clock() if now is None else now
        cutoff = now - float(seconds)
        with self._lock:
            ring = self._windows.get(name, ())
            return [(t, v) for (t, v) in ring if t >= cutoff]

    def window_mean(self, name, seconds, now=None):
        w = self.window(name, seconds, now)
        return sum(v for _t, v in w) / len(w) if w else None

    # -- SLO burn-rate evaluation --------------------------------------------

    def add_slo(self, slo):
        self.slos.append(slo if isinstance(slo, SLO) else SLO(**slo))

    def set_slos(self, slos):
        self.slos = [s if isinstance(s, SLO) else SLO(**s) for s in slos]

    def _burn(self, slo, seconds, now):
        """Breach fraction of one window, or None with no samples."""
        w = self.window(slo.signal, seconds, now)
        if not w:
            return None
        return sum(1 for _t, v in w if slo.breached(v)) / len(w)

    def evaluate(self, now=None):
        """One multi-window burn-rate pass over every SLO: opens an
        alert when BOTH windows burn at/above the threshold, closes it
        when the fast window clears. Returns the list of open alerts."""
        now = self._clock() if now is None else now
        for slo in self.slos:
            fast = self._burn(slo, slo.fast_s, now)
            slow = self._burn(slo, slo.slow_s, now)
            open_alert = self._alerts.get(slo.name)
            if open_alert is None:
                if (
                    fast is not None and slow is not None
                    and fast >= slo.burn and slow >= slo.burn
                ):
                    self._open_alert(slo, now, fast, slow)
            elif fast is not None and fast < slo.burn:
                self._close_alert(slo, now, fast, slow)
        return self.open_alerts()

    def tick(self, now=None):
        """Sample + evaluate: the supervisor-tick entry point. Returns
        the per-tick signal sample (see `sample`)."""
        now = self._clock() if now is None else now
        out = self.sample(now)
        self.evaluate(now)
        return out

    def _open_alert(self, slo, now, fast, slow):
        alert = {
            "slo": slo.name,
            "signal": slo.signal,
            "threshold": slo.threshold,
            "direction": slo.direction,
            "opened_t": round(now, 6),
            "value": self._latest.get(slo.signal),
            "fast_burn": round(fast, 4),
            "slow_burn": round(slow, 4),
        }
        with self._lock:
            self._alerts[slo.name] = alert
            self._counts["alerts_opened"] += 1
            if len(self._alert_events) < _MAX_ALERT_EVENTS:
                self._alert_events.append(
                    {"t": round(now, 6), "slo": slo.name,
                     "action": "open", "fast_burn": round(fast, 4),
                     "slow_burn": round(slow, 4)}
                )
        _metrics.count("tower.alerts_opened")
        _trace.instant(f"alert.{slo.name}.open", cat="alert",
                       signal=slo.signal, fast_burn=round(fast, 4),
                       slow_burn=round(slow, 4))
        _recorder.record(
            "alert", f"alert.{slo.name}.open",
            f"{slo.signal} fast={fast:.2f} slow={slow:.2f} "
            f"vs burn={slo.burn:.2f}",
        )

    def _close_alert(self, slo, now, fast, slow):
        with self._lock:
            opened = self._alerts.pop(slo.name, None)
            self._counts["alerts_closed"] += 1
            if len(self._alert_events) < _MAX_ALERT_EVENTS:
                self._alert_events.append(
                    {"t": round(now, 6), "slo": slo.name,
                     "action": "close",
                     "fast_burn": round(fast, 4) if fast is not None
                     else None,
                     "open_s": round(now - opened["opened_t"], 6)
                     if opened else None}
                )
        _metrics.count("tower.alerts_closed")
        _trace.instant(f"alert.{slo.name}.close", cat="alert",
                       signal=slo.signal)
        _recorder.record(
            "alert", f"alert.{slo.name}.close",
            f"{slo.signal} fast cleared"
            + (f" ({fast:.2f} < {slo.burn:.2f})" if fast is not None
               else ""),
        )

    def open_alerts(self):
        with self._lock:
            return list(self._alerts.values())

    # -- export --------------------------------------------------------------

    def heartbeat_fields(self):
        """The fleet fields `obs.heartbeat.Heartbeat` stamps when a
        tower is active: replica count, open alerts, queue depth and
        the brownout rung (all from already-sampled state — no source
        calls on the heartbeat path)."""
        with self._lock:
            replicas = sum(
                1 for kind, _fn in self._sources.values()
                if kind == "replica"
            )
            open_alerts = len(self._alerts)
            depth = self._latest.get("fleet.queued_depth")
            rung = self._latest.get("fleet.brownout_level")
        return {
            "fleet_replicas": replicas,
            "fleet_open_alerts": open_alerts,
            "fleet_queue_depth": None if depth is None else int(depth),
            "fleet_brownout_level": None if rung is None else int(rung),
        }

    def fleet_telemetry(self):
        """The ``fleet_telemetry`` artifact block: every source's
        export keyed by name, plus fleet ``totals`` summing the
        per-source ``counters`` and ``stages`` — by construction the
        per-replica breakdowns sum to the fleet totals, and
        `validate_fleet_telemetry_artifact` re-derives the sums to
        prove it."""
        with self._lock:
            sources = list(self._sources.items())
            latest = {
                k: round(v, 6) for k, v in self._latest.items()
            }
        blocks = {}
        for name, (kind, fn) in sources:
            try:
                stats = fn()
            except Exception as exc:  # noqa: BLE001 - keep exporting
                with self._lock:
                    self._counts["source_errors"] += 1
                blocks[name] = {"kind": kind, "error": str(exc)}
                continue
            blocks[name] = {"kind": kind, **(stats or {})}
        with self._lock:
            # counts snapshot AFTER the source calls so this export's
            # own source errors are visible in this export
            counts = dict(self._counts)
        return {
            "n_sources": len(blocks),
            "sources": blocks,
            "totals": _totals(blocks),
            "signals": latest,
            **counts,
        }

    def alerts_block(self):
        """The ``alerts`` artifact block (see
        `validate_alerts_artifact`)."""
        with self._lock:
            return {
                "slos": [s.spec() for s in self.slos],
                "open": list(self._alerts.values()),
                "events": list(self._alert_events),
                "opened": self._counts["alerts_opened"],
                "closed": self._counts["alerts_closed"],
            }


def _totals(blocks):
    """Fleet totals over source blocks: per-name counter sums and
    per-stage ``{count, total_s}`` sums."""
    counters = {}
    stages = {}
    for block in blocks.values():
        for k, v in (block.get("counters") or {}).items():
            if isinstance(v, (int, float)):
                counters[k] = counters.get(k, 0) + v
        for k, st in (block.get("stages") or {}).items():
            if not isinstance(st, dict):
                continue
            agg = stages.setdefault(k, {"count": 0, "total_s": 0.0})
            agg["count"] += int(st.get("count", 0))
            agg["total_s"] += float(st.get("total_s", 0.0))
    for agg in stages.values():
        agg["total_s"] = round(agg["total_s"], 6)
    return {"counters": counters, "stages": stages}


# ---------------------------------------------------------------------------
# Artifact validators (the obs.manifest pattern: a list of problem
# strings, empty when the block holds).
# ---------------------------------------------------------------------------

_SLO_SPEC_FIELDS = ("name", "signal", "threshold", "direction",
                    "fast_s", "slow_s", "burn")


def validate_fleet_telemetry_artifact(record):
    """Problems with a record's ``fleet_telemetry`` block: sources
    present, each carrying a ``kind``, and the stamped ``totals``
    EQUAL to the re-derived per-source sums (a totals block that
    drifts from its breakdowns is a lie, not an aggregate)."""
    problems = []
    if not isinstance(record, dict):
        return [f"record is {type(record).__name__}, expected dict"]
    ft = record.get("fleet_telemetry")
    if not isinstance(ft, dict):
        return ["missing fleet_telemetry block"]
    sources = ft.get("sources")
    if not isinstance(sources, dict) or not sources:
        problems.append("fleet_telemetry has no sources")
        return problems
    for name, block in sources.items():
        if not isinstance(block, dict) or "kind" not in block:
            problems.append(f"source {name!r} missing kind")
    totals = ft.get("totals")
    if not isinstance(totals, dict):
        problems.append("fleet_telemetry missing totals")
        return problems
    derived = _totals(sources)
    for k, v in derived["counters"].items():
        got = (totals.get("counters") or {}).get(k)
        if got is None or abs(float(got) - float(v)) > 1e-6:
            problems.append(
                f"totals.counters[{k!r}] = {got!r} != per-source sum {v}"
            )
    for k, agg in derived["stages"].items():
        got = (totals.get("stages") or {}).get(k)
        if not isinstance(got, dict):
            problems.append(f"totals.stages missing {k!r}")
            continue
        if int(got.get("count", -1)) != agg["count"]:
            problems.append(
                f"totals.stages[{k!r}].count = {got.get('count')!r} "
                f"!= per-source sum {agg['count']}"
            )
        if abs(float(got.get("total_s", -1.0)) - agg["total_s"]) > 1e-5:
            problems.append(
                f"totals.stages[{k!r}].total_s = "
                f"{got.get('total_s')!r} != per-source sum "
                f"{agg['total_s']}"
            )
    return problems


def validate_alerts_artifact(record):
    """Problems with a record's ``alerts`` block: SLO specs complete,
    event trail well-formed (open/close only), and the open/closed
    ledger consistent (open alerts == opened - closed)."""
    problems = []
    if not isinstance(record, dict):
        return [f"record is {type(record).__name__}, expected dict"]
    al = record.get("alerts")
    if not isinstance(al, dict):
        return ["missing alerts block"]
    slos = al.get("slos")
    if not isinstance(slos, list):
        problems.append("alerts.slos is not a list")
        slos = []
    for i, spec in enumerate(slos):
        if not isinstance(spec, dict):
            problems.append(f"alerts.slos[{i}] is not a dict")
            continue
        for field in _SLO_SPEC_FIELDS:
            if field not in spec:
                problems.append(f"alerts.slos[{i}] missing {field!r}")
        if spec.get("direction") not in ("above", "below"):
            problems.append(
                f"alerts.slos[{i}] direction "
                f"{spec.get('direction')!r} not above/below"
            )
    events = al.get("events")
    if not isinstance(events, list):
        problems.append("alerts.events is not a list")
        events = []
    for i, e in enumerate(events):
        if not isinstance(e, dict) or "slo" not in e or "t" not in e:
            problems.append(f"alerts.events[{i}] missing slo/t")
            continue
        if e.get("action") not in ("open", "close"):
            problems.append(
                f"alerts.events[{i}] action {e.get('action')!r} "
                "not open/close"
            )
    opened = al.get("opened")
    closed = al.get("closed")
    open_list = al.get("open")
    if not isinstance(open_list, list):
        problems.append("alerts.open is not a list")
        open_list = []
    if not isinstance(opened, int) or not isinstance(closed, int):
        problems.append("alerts.opened/closed not ints")
    else:
        if closed > opened:
            problems.append(
                f"alerts closed {closed} > opened {opened}"
            )
        if len(open_list) != opened - closed:
            problems.append(
                f"{len(open_list)} open alert(s) != opened {opened} - "
                f"closed {closed}"
            )
    return problems
