"""Bounded admission queue for on-demand subgrid serving.

The port of the JAX package's ``swiftly_tpu/serve/queue.py``: the same
states, results, requests, depth and projected-device-memory admission,
and the same ``obs.metrics`` gauges (``serve.queue_depth`` and its
peak).

The serving path admits requests arriving over time, so unlike the
batch drivers it must say NO: an unbounded queue under sustained
overload grows until the host (and the projected device working set)
is exhausted, and every queued request's latency grows with it.
`AdmissionQueue` therefore *sheds at the door* — a request is either
admitted (and will be scheduled) or rejected immediately with a
``shed`` result the client can retry against another replica (the
result's ``retry_after_s`` hint, priced from the queue's observed
drain rate by `retry_after_hint`, tells it *when*; the fleet router in
`serve.fleet` acts on it) — on two budgets:

* **depth** — at most ``max_depth`` requests pending (the classic
  bounded-queue latency cap: past it, added queue depth only adds
  waiting time, never throughput);
* **projected device cost** — each pending request prices its subgrid
  output and each *distinct pending column* one set of column
  intermediates (the plan's byte model, `plan.projected_request_bytes`
  and `plan.projected_column_bytes`); the queue sheds with reason
  ``"hbm"`` past ``hbm_budget_bytes``.

Requests are keyed by subgrid column offset (``off0``) because that is
the unit the scheduler coalesces on; the queue itself imposes no order
beyond arrival — ordering policy lives in
`serve.scheduler.CoalescingScheduler`.

All entry points are lock-guarded: submissions may come from many
client threads while a pump (or the service's worker thread) drains.
"""

from __future__ import annotations

import itertools
import threading
import time

from ..obs import metrics as _metrics

__all__ = [
    "AdmissionQueue",
    "RequestResult",
    "SubgridRequest",
    "STATUS_OK",
    "STATUS_SHED",
    "STATUS_EXPIRED",
    "STATUS_QUARANTINED",
]

# Terminal request states. Every submitted request ends in exactly one.
STATUS_OK = "ok"                    # served; `data` holds the subgrid
STATUS_SHED = "shed"                # rejected at admission (backpressure)
STATUS_EXPIRED = "expired"          # deadline/timeout passed before service
STATUS_QUARANTINED = "quarantined"  # kept failing after retries; isolated

_REQ_IDS = itertools.count()


class RequestResult:
    """Terminal outcome of one request.

    :param status: one of the ``STATUS_*`` constants
    :param data: the subgrid array (``STATUS_OK`` only) — a device array
        row when computed, a host row when served from a cache feed
    :param error: repr of the final exception (failure statuses)
    :param path: how the request was served — ``"coalesced"`` (column
        batch program), ``"cache"`` (spill-cache feed), ``"retry"``
        (isolated per-request fallback after a batch failure)
    :param batch_size: number of requests the serving dispatch carried
    :param coalesced: True when the request shared its column program
        with at least one other request
    :param retry_after_s: structured backpressure hint on ``shed``
        results — seconds after which a retry (against this or another
        replica) is likely to be admitted, priced from the queue's
        observed drain rate (`AdmissionQueue.retry_after_hint`)

    ``journey`` (set by the service on served requests) decomposes
    ``latency_s`` into contiguous segments
    ``{"queue_s", "compute_s", "transfer_s"}`` that SUM to it exactly:
    admission→taken (queue wait), taken→dispatch-landed (coalesce +
    compute), dispatch-landed→completion (d2h/result materialisation +
    completion bookkeeping).
    """

    __slots__ = (
        "status", "data", "error", "latency_s", "path", "batch_size",
        "coalesced", "retries", "shed_reason", "journey",
        "retry_after_s",
    )

    def __init__(self, status, data=None, error=None, latency_s=0.0,
                 path=None, batch_size=0, coalesced=False, retries=0,
                 shed_reason=None, journey=None, retry_after_s=None):
        self.status = status
        self.data = data
        self.error = error
        self.latency_s = latency_s
        self.path = path
        self.batch_size = batch_size
        self.coalesced = coalesced
        self.retries = retries
        self.shed_reason = shed_reason
        self.journey = journey
        self.retry_after_s = retry_after_s

    @property
    def ok(self):
        return self.status == STATUS_OK

    def __repr__(self):
        extra = f", path={self.path}" if self.path else ""
        if self.error:
            extra += f", error={self.error}"
        return (
            f"RequestResult({self.status}, latency_s="
            f"{self.latency_s:.4f}{extra})"
        )


class SubgridRequest:
    """One in-flight subgrid request.

    Completion is signalled through an event so clients on other
    threads can ``wait()``; the pump thread calls ``_complete`` exactly
    once. Deadlines are absolute (``perf_counter`` timebase), derived
    from the relative ``deadline_s`` at submit time.
    """

    __slots__ = (
        "config", "req_id", "priority", "submit_t", "deadline_t",
        "retries", "result", "_event", "take_t", "compute_t",
        "stream_version",
    )

    def __init__(self, config, priority=0, deadline_s=None, now=None):
        self.config = config
        self.req_id = next(_REQ_IDS)
        self.priority = int(priority)
        self.submit_t = time.perf_counter() if now is None else now
        self.deadline_t = (
            None if deadline_s is None else self.submit_t + float(deadline_s)
        )
        self.retries = 0
        self.result = None
        self._event = threading.Event()
        # the facet-stack version this request was admitted under
        # (stamped by `SubgridService.submit`); the cache feed only
        # serves version-matching requests, so an update mid-queue can
        # never hand a request rows from a different stack than the
        # one it was admitted against
        self.stream_version = None
        # journey marks (set by the queue/pump): when the request left
        # the queue and when its compute landed — with submit_t and the
        # completion time these decompose end-to-end latency into
        # queue-wait / compute / transfer segments that sum exactly
        self.take_t = None
        self.compute_t = None

    def expired(self, now):
        return self.deadline_t is not None and now > self.deadline_t

    @property
    def done(self):
        return self.result is not None

    def wait(self, timeout=None):
        """Block until the request reaches a terminal state; returns the
        `RequestResult` (or None on wait timeout)."""
        self._event.wait(timeout)
        return self.result

    def _complete(self, result):
        self.result = result
        self._event.set()

    def __repr__(self):
        return (
            f"SubgridRequest(#{self.req_id}, off0={self.config.off0}, "
            f"off1={self.config.off1}, prio={self.priority})"
        )


class _ColumnSummary:
    """Scheduler-facing snapshot of one pending column."""

    __slots__ = ("off0", "count", "max_priority", "min_deadline_t",
                 "oldest_submit_t")

    def __init__(self, off0, count, max_priority, min_deadline_t,
                 oldest_submit_t):
        self.off0 = off0
        self.count = count
        self.max_priority = max_priority
        self.min_deadline_t = min_deadline_t
        self.oldest_submit_t = oldest_submit_t


class AdmissionQueue:
    """Bounded, column-keyed admission queue with cost-aware shedding.

    :param max_depth: pending-request cap (admission sheds past it)
    :param hbm_budget_bytes: projected-device-cost cap; None disables
    :param request_bytes: per-request projected output bytes (one
        finished subgrid)
    :param column_bytes: per-distinct-pending-column projected bytes
        (the column intermediates the batcher materialises once per
        column program)
    """

    def __init__(self, max_depth=256, hbm_budget_bytes=None,
                 request_bytes=0, column_bytes=0):
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        self.max_depth = int(max_depth)
        self.hbm_budget_bytes = hbm_budget_bytes
        self.request_bytes = int(request_bytes)
        self.column_bytes = int(column_bytes)
        self._lock = threading.Lock()
        self._cols = {}  # off0 -> [SubgridRequest, ...] in arrival order
        self._depth = 0
        # observed drain rate (requests/s leaving via take, EWMA over
        # inter-take gaps) — prices the retry_after_s shed hint
        self._drain_rate = 0.0
        self._last_take_t = None
        self._taken_total = 0

    def __len__(self):
        with self._lock:
            return self._depth

    def _projected_bytes(self, depth, n_cols):  # caller holds the lock
        return depth * self.request_bytes + n_cols * self.column_bytes

    def projected_bytes(self):
        """Projected device cost of the current pending set."""
        with self._lock:
            return self._projected_bytes(self._depth, len(self._cols))

    def offer(self, request, now=None):
        """Admit or shed one request.

        :return: ``(True, None)`` when admitted, else ``(False, reason)``
            with reason in ``("expired", "depth", "hbm")``. The caller
            owns completing a shed request with the matching result.
        """
        now = time.perf_counter() if now is None else now
        with self._lock:
            if request.expired(now):
                return False, "expired"
            if self._depth + 1 > self.max_depth:
                return False, "depth"
            if self.hbm_budget_bytes is not None:
                n_cols = len(self._cols)
                if request.config.off0 not in self._cols:
                    n_cols += 1
                if (
                    self._projected_bytes(self._depth + 1, n_cols)
                    > self.hbm_budget_bytes
                ):
                    return False, "hbm"
            self._cols.setdefault(request.config.off0, []).append(request)
            self._depth += 1
            _metrics.gauge("serve.queue_depth", self._depth)
            _metrics.gauge_max("serve.queue_depth_peak", self._depth)
            return True, None

    def columns(self):
        """Snapshot of pending columns for the scheduler, as a list of
        per-column summaries (count, max priority, earliest deadline,
        oldest arrival)."""
        with self._lock:
            out = []
            for off0, reqs in self._cols.items():
                deadlines = [
                    r.deadline_t for r in reqs if r.deadline_t is not None
                ]
                out.append(
                    _ColumnSummary(
                        off0,
                        len(reqs),
                        max(r.priority for r in reqs),
                        min(deadlines) if deadlines else None,
                        min(r.submit_t for r in reqs),
                    )
                )
            return out

    def take(self, off0, limit=None, now=None):
        """Remove and return up to ``limit`` requests of one column,
        highest priority first (FIFO within a priority). Each taken
        request's ``take_t`` journey mark is stamped here — the end of
        its queue-wait segment."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            reqs = self._cols.get(off0)
            if not reqs:
                return []
            # stable sort: arrival order already holds, so equal
            # priorities keep FIFO
            reqs.sort(key=lambda r: -r.priority)
            if limit is None or limit >= len(reqs):
                taken = reqs
                del self._cols[off0]
            else:
                taken = reqs[:limit]
                self._cols[off0] = reqs[limit:]
            self._depth -= len(taken)
            for r in taken:
                r.take_t = now
            if self._last_take_t is not None and now > self._last_take_t:
                inst = len(taken) / (now - self._last_take_t)
                self._drain_rate = (
                    inst if self._drain_rate == 0.0
                    else 0.8 * self._drain_rate + 0.2 * inst
                )
            self._last_take_t = now
            self._taken_total += len(taken)
            _metrics.gauge("serve.queue_depth", self._depth)
            return taken

    def take_expired(self, now=None):
        """Remove and return every pending request whose deadline has
        passed (the pump times them out before scheduling work)."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            expired = []
            for off0 in list(self._cols):
                keep = []
                for r in self._cols[off0]:
                    (expired if r.expired(now) else keep).append(r)
                if keep:
                    self._cols[off0] = keep
                else:
                    del self._cols[off0]
            self._depth -= len(expired)
            if expired:
                _metrics.gauge("serve.queue_depth", self._depth)
            return expired

    def retry_after_hint(self, now=None):
        """Seconds after which a shed client's retry is likely to be
        admitted: the current backlog priced at the observed drain rate
        (clamped to [0.01, 5.0]; 0.05 before any drain has been
        observed). The structured half of the shed contract — the
        docstring's "retry against another replica" made actionable
        for a router instead of a blind client backoff guess."""
        with self._lock:
            depth = self._depth
            rate = self._drain_rate
        if rate <= 0.0:
            return 0.05
        return min(5.0, max(0.01, (depth + 1) / rate))

    def drain(self):
        """Remove and return everything pending (service shutdown)."""
        with self._lock:
            out = [r for reqs in self._cols.values() for r in reqs]
            self._cols = {}
            self._depth = 0
            _metrics.gauge("serve.queue_depth", 0)
            return out
