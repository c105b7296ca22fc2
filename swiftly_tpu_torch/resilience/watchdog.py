"""Stalled-collective watchdog: turn a hung collective into a detected
failure.

A lost device on a real mesh does not announce itself — the next
collective that includes it simply never completes, and the host
blocks forever inside a device sync. That silent-hang class is the
worst failure mode a multi-hour streamed transform can have: no
exception, no checkpoint, no operator signal. The wafer-scale
slide-FFT work (arXiv 2401.05427) makes the same point from the other
side — a static layout must be *re-derivable* after topology change,
which first requires the topology change to be DETECTED.

`watch_collective` is that detector: it runs the blocking call (the
device sync downstream of the mesh engine's one all-reduce per
column group) on a worker thread and waits with a deadline. If the
deadline passes, the host raises :class:`CollectiveStalledError` — a
:class:`~swiftly_tpu.resilience.faults.ShardLostError` subclass, so
the elastic recovery ladder treats a stall and an explicit shard loss
identically: re-plan on survivors, migrate the checkpoint, resume.

**Default off.** The knob is ``SWIFTLY_COLLECTIVE_TIMEOUT_S`` (unset,
empty, or ``0`` disables). On CPU simulation a "collective" is just
local math and cannot hang on a peer, so the watchdog would add a
thread hop per group for nothing — it stays off unless an operator
(or a drill) opts in. When disabled, `watch_collective` calls the
function directly: zero overhead, same no-op discipline as
`faults.fault_point` and the disabled metrics registry.

The worker thread is daemonic: if the collective truly never returns
(real device loss), the thread is abandoned and dies with the
process after recovery re-plans around it — there is no portable way
to cancel a blocked device sync, and recovery does not need to.

The port of the JAX package's ``swiftly_tpu/resilience/watchdog.py``,
unchanged in behaviour; its user, the mesh engine on
``torch.distributed``, is ROADMAP A8.
"""

from __future__ import annotations

import os
import threading

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from .faults import ShardLostError

__all__ = [
    "CollectiveStalledError",
    "collective_timeout_s",
    "watch_collective",
]

_ENV_KNOB = "SWIFTLY_COLLECTIVE_TIMEOUT_S"


class CollectiveStalledError(ShardLostError):
    """A watched collective did not complete within the deadline.

    Subclasses :class:`ShardLostError` deliberately: a stall IS the
    symptom of a lost shard, and the recovery ladder handles both the
    same way. Carries the site and the timeout that expired.
    """

    def __init__(self, site, timeout_s):
        super().__init__(
            f"collective at {site!r} stalled past "
            f"{timeout_s:g}s watchdog deadline"
        )
        self.site = site
        self.timeout_s = timeout_s


def collective_timeout_s(env=None):
    """The watchdog deadline in seconds, or None when disabled.

    Reads ``SWIFTLY_COLLECTIVE_TIMEOUT_S`` (from `env` or the process
    environment). Unset, empty, non-numeric, zero, or negative all
    mean disabled — off is the safe default on CPU simulation, where
    a collective cannot hang on a peer.
    """
    raw = (env or os.environ).get(_ENV_KNOB)
    if not raw:
        return None
    try:
        t = float(raw)
    except ValueError:
        return None
    return t if t > 0 else None


def watch_collective(fn, site, timeout_s=None):
    """Run blocking `fn()` under a stall deadline; return its result.

    With `timeout_s` None (or the env knob disabled), this is a direct
    call — the production fast path. Otherwise `fn` runs on a daemon
    thread and the caller waits at most `timeout_s` seconds: on
    expiry a :class:`CollectiveStalledError` is raised (counted as
    ``watchdog.stalls`` / ``watchdog.stalls.<site>`` and stamped as a
    trace instant), converting the silent hang into a failure the
    elastic recovery ladder can catch. If `fn` itself raises, the
    exception is re-raised on the caller's thread unchanged.
    """
    if timeout_s is None:
        timeout_s = collective_timeout_s()
    if timeout_s is None:
        return fn()

    box = {}
    done = threading.Event()

    def _run():
        try:
            box["value"] = fn()
        except BaseException as exc:  # re-raised on the caller thread
            box["error"] = exc
        finally:
            done.set()

    worker = threading.Thread(
        target=_run, name=f"watchdog:{site}", daemon=True
    )
    worker.start()
    if not done.wait(timeout_s):
        _metrics.count("watchdog.stalls")
        _metrics.count(f"watchdog.stalls.{site}")
        _metrics.event(
            "watchdog.stall", site=site, timeout_s=timeout_s
        )
        _trace.instant(
            "watchdog.stall", cat="fault", site=site, timeout_s=timeout_s
        )
        raise CollectiveStalledError(site, timeout_s)
    if "error" in box:
        raise box["error"]
    return box["value"]
