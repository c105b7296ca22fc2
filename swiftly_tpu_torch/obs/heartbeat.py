"""Progress heartbeat and incremental partial artifacts for long runs.

The port of the JAX package's ``swiftly_tpu/obs/heartbeat.py``, unchanged
in kind:

* ``Heartbeat``: rate and ETA reporting for long streaming loops (units
  per second against a known total), throttled to one emission per
  ``interval_s``. Emissions go to the logger and, when the metrics
  registry is enabled, to its JSONL event log, so how far a killed run
  got survives on disk.
* ``PartialArtifactWriter``: append-only JSONL of finished records (one
  fsync'd line each), so a killed multi-leg run leaves every finished
  leg's record on disk.
"""

from __future__ import annotations

import json
import logging
import os
import time

from . import metrics

logger = logging.getLogger(__name__)

__all__ = ["Heartbeat", "PartialArtifactWriter"]


class Heartbeat:
    """Throttled progress reporter for a loop over `total` units.

    ::

        hb = Heartbeat(total=len(subgrids), label="subgrids")
        for ... in stream:
            hb.update(len(items))
        hb.finish()
    """

    def __init__(self, total, label="units", interval_s=30.0,
                 log=None, tower=None, procfleet=None):
        self.total = int(total)
        self.label = label
        self.interval_s = float(interval_s)
        self.done = 0
        self._log = log or logger
        self._tower = tower
        self._procfleet = procfleet
        self._t0 = time.time()
        self._last_emit = 0.0  # first update() emits immediately

    def update(self, n=1, **fields):
        """Advance by `n` units; emit if the throttle interval passed.

        Extra ``fields`` ride along on the emission (e.g. the current
        column group index)."""
        self.done += int(n)
        now = time.time()
        if now - self._last_emit >= self.interval_s:
            self._emit(now, **fields)

    def finish(self, **fields):
        """Unconditional final emission (rate over the whole run)."""
        self._emit(time.time(), final=True, **fields)

    def _emit(self, now, final=False, **fields):
        self._last_emit = now
        elapsed = max(now - self._t0, 1e-9)
        rate = self.done / elapsed
        remaining = max(self.total - self.done, 0)
        eta_s = remaining / rate if rate > 0 else float("inf")
        if self._tower is not None:
            # fleet state rides along on every beat: replica count,
            # open alerts, queue depth, brownout rung — already-sampled
            # tower state, no source calls on this path
            fields = {**self._tower.heartbeat_fields(), **fields}
        if self._procfleet is not None:
            # process-fleet state: live workers, summed generations,
            # open alert count (`ProcessFleet.heartbeat_fields`)
            fields = {**self._procfleet.heartbeat_fields(), **fields}
        self._log.info(
            "%s %d/%d (%.2f/s, elapsed %.0fs%s)",
            self.label, self.done, self.total, rate, elapsed,
            "" if final or eta_s == float("inf")
            else f", ETA {eta_s:.0f}s",
        )
        metrics.event(
            "heartbeat",
            label=self.label,
            done=self.done,
            total=self.total,
            rate_per_s=round(rate, 4),
            elapsed_s=round(elapsed, 2),
            eta_s=None if eta_s == float("inf") else round(eta_s, 1),
            **fields,
        )


class PartialArtifactWriter:
    """Append finished records to a JSONL file, one durable line each.

    ``path=None`` (or "") disables — every method is then a no-op, so
    callers need no branching. Each ``append`` writes one line and
    fsyncs: a SIGKILL between legs loses at most the in-flight leg,
    never a finished one.
    """

    def __init__(self, path):
        self.path = str(path) if path else None

    def append(self, record):
        if not self.path:
            return
        line = json.dumps(record)
        with open(self.path, "a") as fh:
            fh.write(line + "\n")
            fh.flush()
            os.fsync(fh.fileno())

    def read_all(self):
        """All records flushed so far (for tests / resumption tooling)."""
        if not self.path or not os.path.exists(self.path):
            return []
        with open(self.path) as fh:
            return [json.loads(ln) for ln in fh if ln.strip()]
