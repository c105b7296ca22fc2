"""The graceful-degradation ledger: every rung a run steps down is
recorded, counted, and stamped into artifacts.

The engine's degradation ladder (docs/resilience.md) trades cost for
survival, never correctness:

* spill-disk failure      -> host-RAM-only cache -> forward replay
* corrupt checkpoint      -> previous good generation
* fused-batch OOM         -> split batch          -> per-request
* cache-feed eviction     -> recompute (serve; pre-existing)

Each step calls :func:`record` at the moment it happens; `events()` is
the JSON-ready trail the chaos drill and ``bench.py --chaos`` stamp
into the artifact's resilience block, and ``degrade.<site>.<action>``
counters land in `obs.metrics` (zero-cost when metrics are off). The
ledger itself always records (bounded at ``_MAX_EVENTS``) — a
degradation that nobody can see afterwards is half a failure.

The port of the JAX package's ``swiftly_tpu/resilience/degrade.py``,
unchanged in behaviour. The port's executors record the spill ladder
(``spill.disk_to_ram``, ``spill.replay_fallback``) and the checkpoint
generation fallback.
"""

from __future__ import annotations

import threading

from ..obs import metrics as _metrics
from ..obs import recorder as _recorder
from ..obs import trace as _trace

__all__ = ["events", "record", "reset"]

_MAX_EVENTS = 1024  # bound the trail on pathological flapping

_lock = threading.Lock()
_events = []
_dropped = 0


def record(site, action, detail=None):
    """One ladder step: `site` stepped down via `action` (e.g.
    ``record("spill", "disk_to_ram", "write failed: ...")``)."""
    global _dropped
    _metrics.count("degrade.events")
    _metrics.count(f"degrade.{site}.{action}")
    _metrics.event("degrade", site=site, action=action,
                   detail=str(detail) if detail is not None else None)
    # ladder steps land on the trace too: a chaos-drill timeline shows
    # WHERE the run degraded, not just that it did
    _trace.instant(f"degrade.{site}.{action}", cat="degrade",
                   site=site, action=action)
    _recorder.record("degrade", f"degrade.{site}.{action}",
                     str(detail) if detail is not None else None)
    with _lock:
        if len(_events) >= _MAX_EVENTS:
            _dropped += 1
            return
        _events.append(
            {
                "site": site,
                "action": action,
                "detail": str(detail) if detail is not None else None,
            }
        )


def events():
    """The degradation trail so far (JSON-ready list, oldest first)."""
    with _lock:
        out = list(_events)
        if _dropped:
            out.append(
                {
                    "site": "degrade",
                    "action": "events_dropped",
                    "detail": f"{_dropped} past the {_MAX_EVENTS} cap",
                }
            )
        return out


def reset():
    """Clear the trail (drill/test isolation)."""
    global _dropped
    with _lock:
        _events.clear()
        _dropped = 0
