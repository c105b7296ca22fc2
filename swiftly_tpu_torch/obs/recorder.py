"""Always-on flight recorder: the last N seconds of events, kept even
when full tracing is off.

The port of the JAX package's ``swiftly_tpu/obs/recorder.py``, unchanged
in behaviour (it has no device code). When a run is killed or a replica
dies, the interesting events (the fault injection, the ladder steps, the
breaker flips) happened seconds before the trigger; unless a full trace
was running, they are gone. The recorder is the black box for that
window:

* **Bounded and lock-light.** A fixed-size ``collections.deque``
  (``maxlen`` evicts the oldest) of event tuples ``(t, kind, name,
  detail)``. ``deque.append`` is atomic in CPython, so the recording path
  takes no lock: one enabled check, one ``perf_counter`` read, one tuple,
  one append (under 5 us an event).
* **Zero cost off.** Disabled (the library default), every hook is one
  attribute check, the ``obs.metrics`` discipline. ``SWIFTLY_RECORDER=1``
  turns it on for any run.
* **Post-mortem bundles.** On a trigger (`resilience.WorkerKilled`, a
  forced drain, an SLO breach) `post_mortem` snapshots the last
  ``SWIFTLY_RECORDER_SECONDS`` (default 60) of events into a JSON-ready
  bundle (trigger, per-kind counts, the event tail) and `dump` writes it
  as JSONL plus a rendered ``.txt`` summary.

Event kinds recorded by the built-in hooks: ``stage`` (via the
``metrics.stage`` bridge), ``fault`` (injections), ``degrade`` (ladder
steps), ``breaker`` (transitions), ``ckpt`` (autosaves).
"""

from __future__ import annotations

import collections
import json
import os
import time

__all__ = [
    "FlightRecorder",
    "disable",
    "dump",
    "enable",
    "enabled",
    "events",
    "get_recorder",
    "post_mortem",
    "record",
    "reset",
]

_DEFAULT_EVENTS = 32768   # ring capacity (tuples — a few MB at worst)
_DEFAULT_SECONDS = 60.0   # post-mortem lookback window


class FlightRecorder:
    """The bounded event ring; a no-op unless enabled.

    One process-wide instance (``get_recorder()``) serves the engine;
    independent instances are constructible for tests.

    :param capacity: ring size in events (oldest evicted beyond it)
    :param seconds: post-mortem lookback window in seconds
    """

    def __init__(self, enabled=False, capacity=_DEFAULT_EVENTS,
                 seconds=_DEFAULT_SECONDS):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.seconds = float(seconds)
        self._ring = collections.deque(maxlen=self.capacity)
        self._t0 = time.perf_counter()
        self._t_epoch = time.time()
        self.dumps = 0

    # -- lifecycle ---------------------------------------------------------

    def enable(self, seconds=None):
        if seconds is not None:
            self.seconds = float(seconds)
        self.enabled = True
        return self

    def disable(self):
        self.enabled = False

    def reset(self):
        self._ring.clear()
        self._t0 = time.perf_counter()
        self._t_epoch = time.time()
        self.dumps = 0

    # -- recording ---------------------------------------------------------

    def record(self, kind, name, detail=None):
        """Append one pre-formatted event. The hot path: enabled check,
        clock read, tuple, atomic append — no lock, no string work
        beyond what the caller already paid."""
        if not self.enabled:
            return
        self._ring.append(
            (time.perf_counter() - self._t0, kind, name, detail)
        )

    # -- export ------------------------------------------------------------

    def events(self, seconds=None):
        """JSON-ready events from the last ``seconds`` (default: the
        configured window), oldest first."""
        window = self.seconds if seconds is None else float(seconds)
        cutoff = (time.perf_counter() - self._t0) - window
        return [
            {"t": round(t, 6), "kind": kind, "name": name,
             "detail": detail}
            for (t, kind, name, detail) in list(self._ring)
            if t >= cutoff
        ]

    def events_since(self, t_watermark):
        """JSON-ready events recorded after ``t_watermark`` (a relative
        ``t`` from a previous event, or ``-1.0`` for everything), plus
        the new watermark: ``(events, watermark)``. The incremental
        export the process-fleet black-box flusher drains the ring with
        — each flush ships only what the last one did not."""
        out = []
        last = t_watermark
        for (t, kind, name, detail) in list(self._ring):
            if t > t_watermark:
                out.append({"t": round(t, 6), "kind": kind,
                            "name": name, "detail": detail})
                last = t  # raw clock value: rounding must not re-emit
        return out, last

    def post_mortem(self, trigger, reason=None, seconds=None):
        """The JSON-ready bundle for one trigger: the recorded window,
        per-kind counts, and the non-stage event tail (the readable
        story — stage events dominate by volume, decisions by value)."""
        evs = self.events(seconds)
        by_kind = {}
        for e in evs:
            by_kind[e["kind"]] = by_kind.get(e["kind"], 0) + 1
        tail = [e for e in evs if e["kind"] != "stage"][-64:]
        return {
            "trigger": str(trigger),
            "reason": None if reason is None else str(reason),
            "t_epoch": self._t_epoch,
            "window_s": self.seconds if seconds is None else seconds,
            "n_events": len(evs),
            "by_kind": by_kind,
            "events": tail,
        }

    def dump(self, path, trigger, reason=None, seconds=None):
        """Write the post-mortem bundle: ``path`` gets one JSONL line
        per event (header line first), ``path + ".txt"`` the rendered
        summary. Returns the bundle dict (what drills stamp into their
        artifact)."""
        bundle = self.post_mortem(trigger, reason=reason,
                                  seconds=seconds)
        evs = self.events(seconds)
        with open(path, "w") as fh:
            header = {k: v for k, v in bundle.items() if k != "events"}
            fh.write(json.dumps({"kind": "post_mortem", **header}) + "\n")
            for e in evs:
                fh.write(json.dumps(e) + "\n")
        with open(str(path) + ".txt", "w") as fh:
            fh.write(render_post_mortem(bundle))
        self.dumps += 1
        return bundle


class _RecorderStage:
    """The recorder-only stage timer: what ``metrics.stage`` returns
    when the registry and tracer are both off but the recorder is on.
    One clock read each side of the block plus one ring append — the
    <5 us/event contract tests/test_trace.py asserts."""

    __slots__ = ("name", "flops", "bytes_moved", "_t0")

    def __init__(self, name):
        self.name = name
        self.flops = 0
        self.bytes_moved = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        _RECORDER.record("stage", self.name, round(t1 - self._t0, 6))
        return False


def render_post_mortem(bundle):
    """A human-readable rendering of one post-mortem bundle."""
    lines = [
        f"post-mortem: {bundle['trigger']}"
        + (f" ({bundle['reason']})" if bundle.get("reason") else ""),
        f"  window {bundle['window_s']}s, "
        f"{bundle['n_events']} recorded event(s)",
        "  by kind: "
        + (
            ", ".join(
                f"{k}={n}" for k, n in sorted(bundle["by_kind"].items())
            )
            or "none"
        ),
        "  last events:",
    ]
    for e in bundle["events"]:
        detail = f"  {e['detail']}" if e.get("detail") else ""
        lines.append(
            f"    t={e['t']:>10.4f}  {e['kind']:<10} {e['name']}{detail}"
        )
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# The process-wide recorder + module-level conveniences (the engine's
# hook API: `from ..obs import recorder` ... `recorder.record(...)`).
# ---------------------------------------------------------------------------

_RECORDER = FlightRecorder(
    enabled=os.environ.get("SWIFTLY_RECORDER", "0") not in ("", "0"),
    seconds=float(os.environ.get("SWIFTLY_RECORDER_SECONDS")
                  or _DEFAULT_SECONDS),
)


def get_recorder() -> FlightRecorder:
    return _RECORDER


def enabled() -> bool:
    return _RECORDER.enabled


def enable(seconds=None):
    return _RECORDER.enable(seconds)


def disable():
    _RECORDER.disable()


def reset():
    _RECORDER.reset()


def record(kind, name, detail=None):
    # keep the disabled path shallow: one attribute check in record()
    _RECORDER.record(kind, name, detail)


def events(seconds=None):
    return _RECORDER.events(seconds)


def post_mortem(trigger, reason=None, seconds=None):
    return _RECORDER.post_mortem(trigger, reason=reason,
                                 seconds=seconds)


def dump(path, trigger, reason=None, seconds=None):
    return _RECORDER.dump(path, trigger, reason=reason,
                          seconds=seconds)
