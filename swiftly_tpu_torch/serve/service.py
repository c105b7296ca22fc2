"""`SubgridService`: a long-lived, fault-isolated subgrid server.

Wraps a prepared `SwiftlyForward` (facets uploaded once, column LRU
warm across requests) behind an `AdmissionQueue` and a
`CoalescingScheduler`, and serves individual subgrid requests arriving
over time, where the batch drivers enumerate a full cover instead. One pump cycle:

1. time out overdue requests (queue deadlines / the service-wide
   ``timeout_s``) — a request never occupies a dispatch after its
   caller stopped waiting;
2. pick the next column (urgency > LRU locality > batch density, see
   `CoalescingScheduler`) and take up to ``max_batch`` of its requests;
3. serve what it can from the optional **cache feed** (a
   `parallel.streamed.CachedColumnFeed` over a recorded subgrid
   stream) — a feed hit is one host-RAM row read, no device dispatch;
   a feed *eviction* falls through to the compute path (the
   spill-replay fallback: a capacity miss degrades to recomputation,
   never to an error);
4. compute the rest as ONE stacked column program
   (`SwiftlyForward.get_subgrid_tasks` — bit-identical to per-request
   ``get_subgrid_task``), bucket-padded so dispatch shapes stay few;
   with a fabric-backed feed identical concurrent batches collapse
   through the fabric's ``single_flight``;
5. on a batch failure, **isolate**: retry each request singly (up to
   ``max_retries``); a request that keeps failing is *quarantined*
   with a structured error result — one poisoned config (bad mask,
   impossible offsets) can never wedge the queue behind it.

Fused multi-column dispatch (``fuse_columns > 1``) trades per-request
latency for fewer dispatches via `SwiftlyForward.all_subgrids` (the
`_group_columns` + `_pad_ragged_columns` whole-cover path).

SLO instrumentation: per-request latency histogram (p50/p99 via
``obs.metrics.observe("serve.request", ...)`` plus the service's own
quantile ring for metrics-off runs), queue-depth gauge, shed/coalesce/
cache counters, and ``stats()`` — the JSON-ready ``serve`` block of a
run record (``p50_ms``/``p99_ms``/``shed_rate``/``coalesce_hit_rate``,
`obs.manifest.validate_serve_artifact`).

Threading: ``pump_once``/``serve`` for synchronous (test/bench) use;
``start()``/``stop()`` run the pump on a background worker so client
threads just ``submit(...).wait()``. Timeouts are enforced at
scheduling boundaries — an already-dispatched device program is never
preempted (a launched kernel is not cancelled), so a timed-out
request's compute may still run to completion; its result is discarded.

The port of the JAX package's ``swiftly_tpu/serve/service.py``. A
cache-path result is the recorded host row (numpy); a compute-path
result is a row of the forward's stacked device tensor, launched on the
pump thread's current stream (the card's default stream unless the
caller set another) — a client's host read (``.cpu()``) of it waits for
that stream only. Rows are views of a stacked tensor that nothing
writes again, so a result shared through ``single_flight`` never
aliases a buffer a later dispatch reuses. OOM isolation splits a batch
on `resilience.retry.is_oom`, which knows ``torch.cuda.OutOfMemoryError``.
"""

from __future__ import annotations

import logging
import threading
import time

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..resilience import degrade as _degrade
from ..resilience.faults import fault_point as _fault_point
from ..resilience.retry import backoff_delay as _backoff_delay
from ..resilience.retry import is_oom as _is_oom
from .queue import (
    STATUS_EXPIRED,
    STATUS_OK,
    STATUS_QUARANTINED,
    STATUS_SHED,
    AdmissionQueue,
    RequestResult,
    SubgridRequest,
)
from .scheduler import CoalescingScheduler

__all__ = ["SubgridService", "projected_request_bytes",
           "projected_column_bytes"]

log = logging.getLogger(__name__)

_LATENCY_RING = 65536  # newest-wins latency samples kept for quantiles


# The admission cost model is the plan's (`plan.model`: one pricing
# shared with the fleet's admission cap and `compile_plan`'s serve
# block); these names are the serve-facing aliases.
from ..plan.model import (  # noqa: E402 - after the docstring's imports
    projected_column_bytes,
    projected_request_bytes,
)


def _quantile(sorted_samples, q):
    if not sorted_samples:
        return 0.0
    i = min(len(sorted_samples) - 1, int(q * len(sorted_samples)))
    return sorted_samples[i]


class SubgridService:
    """Serve individual subgrid requests through a shared forward.

    :param fwd: a prepared `SwiftlyForward` (its facet stack and column
        LRU are the service's working set)
    :param queue: `AdmissionQueue`; default bounds depth at 256 with
        the cost model priced from ``fwd`` when ``hbm_budget_bytes``
        is given
    :param scheduler: `CoalescingScheduler`; default coalesces up to 64
        requests per column dispatch with bucket padding
    :param cache_feed: optional recorded-stream feed (an object with
        ``lookup(config) -> row | None``, raising LookupError when the
        looked-up entry was evicted) — e.g.
        `parallel.streamed.CachedColumnFeed`
    :param timeout_s: service-wide per-request deadline applied at
        submit (min'd with the request's own ``deadline_s``)
    :param max_retries: single-request retry attempts after a batch
        failure before quarantine
    :param retry_backoff_s: base of the capped jittered exponential
        backoff between single-request retries (cap 16x the base; 0
        disables). Instant retries against a struggling device are a
        thundering herd — the backoff decorrelates them, and the total
        slept is reported as ``retry_backoff_s`` in ``stats()``.
    :param fuse_columns: columns per dispatch; > 1 uses the fused
        whole-cover program (`all_subgrids`) over several columns
    :param slo_ms: latency SLO — served requests slower than this are
        counted as violations in ``stats()``
    :param fault_injector: test/chaos hook ``fn(requests, attempt)``
        called before each dispatch (attempt 0 = coalesced batch,
        >= 1 = isolated retries); an exception it raises is handled
        exactly like a compute failure
    :param cover_columns: optional sparse-cover column list — an
        iterable of served ``off0`` values (e.g. the streamed-sparse
        bench path's partial-FoV cover). A request for any other
        column is shed at the door with reason ``outside_cover``: a
        partial-FoV service has no facet data for it, so computing
        would silently return zeros. None (default) serves every
        column.
    """

    def __init__(self, fwd, queue=None, scheduler=None, cache_feed=None,
                 timeout_s=None, max_retries=2, retry_backoff_s=0.005,
                 fuse_columns=1, slo_ms=None, fault_injector=None,
                 hbm_budget_bytes=None, max_depth=256,
                 cover_columns=None):
        self.fwd = fwd
        self.cover_columns = (
            None if cover_columns is None
            else {int(c) for c in cover_columns}
        )
        # the current facet-stack version (bumped by
        # `post_facet_update`); every admitted request is stamped with
        # it so the cache feed serves only version-matching requests.
        # Adopted from the feed at construction — a feed recorded at
        # version v would otherwise version-gate EVERY request onto
        # the compute path
        self.stream_version = int(
            getattr(cache_feed, "stream_version", 0)
        )
        if queue is None:
            queue = AdmissionQueue(
                max_depth=max_depth,
                hbm_budget_bytes=hbm_budget_bytes,
                request_bytes=projected_request_bytes(fwd.config),
                column_bytes=projected_column_bytes(fwd),
            )
        self.queue = queue
        self.scheduler = scheduler or CoalescingScheduler()
        self.cache_feed = cache_feed
        self.timeout_s = timeout_s
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.fuse_columns = int(fuse_columns)
        self.slo_ms = slo_ms
        self.fault_injector = fault_injector
        self.quarantined = []  # [(request, error_repr), ...]
        self._backoff_slept_s = 0.0
        self._counts = {
            "requests": 0, "served": 0, "shed": 0, "expired": 0,
            "quarantined": 0, "retries": 0, "batches": 0,
            "batch_failures": 0, "batch_splits": 0, "coalesced": 0,
            "cache_hits": 0, "cache_fallbacks": 0, "slo_violations": 0,
            "facet_updates": 0, "version_fallbacks": 0,
        }
        self._shed_reasons = {}
        self._latencies = []
        self._lat_i = 0
        # journey ring, parallel to _latencies: (queue_s, compute_s,
        # transfer_s) per served request — the p99 decomposition
        self._journeys = []
        self._jour_i = 0
        self._pump_lock = threading.Lock()
        self._cond = threading.Condition()
        self._stop = False
        self._thread = None

    # -- submission ---------------------------------------------------------

    def submit(self, config, priority=0, deadline_s=None):
        """Admit one request; returns a `SubgridRequest` whose result is
        set on completion. A shed request returns already-completed
        (``status == "shed"``) — admission never blocks."""
        if deadline_s is None:
            deadline_s = self.timeout_s
        elif self.timeout_s is not None:
            deadline_s = min(deadline_s, self.timeout_s)
        req = SubgridRequest(config, priority=priority,
                            deadline_s=deadline_s)
        req.stream_version = self.stream_version
        self._counts["requests"] += 1
        _metrics.count("serve.requests")
        if (
            self.cover_columns is not None
            and int(config.off0) not in self.cover_columns
        ):
            # sparse-cover locality: this service holds no facet data
            # for the column — shed with a structured reason instead
            # of computing a silent zero
            self._counts["shed"] += 1
            self._shed_reasons["outside_cover"] = (
                self._shed_reasons.get("outside_cover", 0) + 1
            )
            _metrics.count("serve.shed")
            _metrics.count("serve.shed.outside_cover")
            _trace.instant("serve.shed", cat="serve",
                           request_id=req.req_id,
                           reason="outside_cover")
            req._complete(
                RequestResult(STATUS_SHED, shed_reason="outside_cover")
            )
            return req
        admitted, reason = self.queue.offer(req)
        if not admitted:
            if reason == "expired":
                # dead on arrival is a deadline outcome, not backpressure
                self._counts["expired"] += 1
                _metrics.count("serve.expired")
                req._complete(
                    RequestResult(STATUS_EXPIRED, error="deadline")
                )
                return req
            self._counts["shed"] += 1
            self._shed_reasons[reason] = (
                self._shed_reasons.get(reason, 0) + 1
            )
            _metrics.count("serve.shed")
            _metrics.count(f"serve.shed.{reason}")
            _trace.instant("serve.shed", cat="serve",
                           request_id=req.req_id, reason=reason)
            req._complete(
                RequestResult(
                    STATUS_SHED, shed_reason=reason,
                    retry_after_s=self.queue.retry_after_hint(),
                )
            )
            return req
        with self._cond:
            self._cond.notify()
        return req

    def serve(self, configs, priority=0, deadline_s=None):
        """Submit many configs and serve to completion; returns the
        requests in input order (synchronous pump unless the worker
        thread is running)."""
        reqs = [
            self.submit(c, priority=priority, deadline_s=deadline_s)
            for c in configs
        ]
        if self._thread is None:
            while self.pump_once():
                pass
        for r in reqs:
            r.wait()
        return reqs

    # -- the pump -----------------------------------------------------------

    def pump_once(self, now=None):
        """Serve one coalesced dispatch; returns the number of requests
        it brought to a terminal state (0 = nothing pending)."""
        with self._pump_lock:
            now = time.perf_counter() if now is None else now
            handled = 0
            for req in self.queue.take_expired(now):
                self._finish(
                    req, RequestResult(STATUS_EXPIRED, error="deadline")
                )
                self._counts["expired"] += 1
                _metrics.count("serve.expired")
                handled += 1
            summaries = self.queue.columns()
            if not summaries:
                return handled
            hot = set(self.fwd.lru.keys())
            if self.fuse_columns > 1:
                offs = self.scheduler.pick_columns(
                    summaries, hot, now, self.fuse_columns
                )
                requests = []
                for off0 in offs:
                    requests.extend(
                        self.queue.take(off0, limit=self.scheduler.max_batch)
                    )
            else:
                off0 = self.scheduler.pick_column(summaries, hot, now)
                requests = self.queue.take(
                    off0, limit=self.scheduler.max_batch
                )
            if not requests:
                return handled
            remaining = requests
            if self.cache_feed is not None:
                remaining = self._serve_from_feed(requests)
            if remaining:
                self._execute(remaining)
            return handled + len(requests)

    def _serve_from_feed(self, requests):
        """Serve what the recorded-stream feed holds; returns the
        requests that still need compute (feed misses AND evictions —
        the eviction fallback is the serving-path twin of the spill
        cache's degrade-to-replay contract)."""
        remaining = []
        feed_version = getattr(
            self.cache_feed, "stream_version", self.stream_version
        )
        for req in requests:
            if (
                req.stream_version is not None
                and req.stream_version != feed_version
            ):
                # version pinning: this request was admitted under a
                # different facet-stack version than the feed serves —
                # never hand it another version's rows; the compute
                # path serves it against the forward it was admitted to
                self._counts["version_fallbacks"] += 1
                _metrics.count("serve.version_fallbacks")
                remaining.append(req)
                continue
            try:
                with _metrics.stage("serve.cache_feed"):
                    row = self.cache_feed.lookup(req.config)
            except LookupError:
                # indexed but evicted: fall back to the compute path
                self._counts["cache_fallbacks"] += 1
                _metrics.count("serve.cache_fallbacks")
                row = None
            if row is None:
                remaining.append(req)
                continue
            self._counts["cache_hits"] += 1
            _metrics.count("serve.cache_hits")
            req.compute_t = time.perf_counter()  # feed read ≙ compute
            self._finish(
                req,
                RequestResult(
                    STATUS_OK, data=row, path="cache",
                    batch_size=len(requests),
                ),
            )
        return remaining

    def _dedup_key(self, requests):
        """Single-flight identity of one coalesced dispatch, or None
        when dedup does not apply (no fabric-backed feed, or a fused
        multi-column batch). The key is the exact request multiset —
        offsets, sizes AND mask content at the admitted stream version —
        so only genuinely identical concurrent batches collapse;
        near-miss batches (a hedge's singleton vs the primary's
        coalesced batch) stay independent dispatches."""
        fabric = getattr(self.cache_feed, "fabric", None)
        if fabric is None:
            return None
        if len({r.config.off0 for r in requests}) != 1:
            return None
        return (
            "batch", self.stream_version,
            tuple(fabric.request_key(r.config) for r in requests),
        )

    def _execute(self, requests, _split_depth=0):
        """One coalesced dispatch for the taken requests, with
        batch-failure isolation. A fused-batch OOM first steps down the
        degradation ladder — split the batch in half and dispatch each
        half (smaller transients) — before per-request isolation.

        With a fabric-backed feed (`cache.SharedStreamTier` view),
        identical concurrent dispatches across replicas collapse
        through the fabric's single-flight registry: the first replica
        in computes, the rest adopt its (bit-identical) rows. A
        leader's failure never propagates to followers — they fall back
        to computing independently inside `single_flight`."""
        self._counts["batches"] += 1
        _metrics.count("serve.batches")

        def dispatch():
            _fault_point("serve.dispatch")
            if self.fault_injector is not None:
                self.fault_injector(requests, 0)
            with _metrics.stage("serve.batch"):
                if self.fuse_columns > 1:
                    configs, rows = self.scheduler.plan_fused(requests)
                    flat = self.fwd.all_subgrids(configs)
                    return [flat[r] for r in rows]
                configs, _n_pad = self.scheduler.plan_batch(requests)
                return self.fwd.get_subgrid_tasks(configs)[
                    : len(requests)
                ]

        try:
            key = (
                self._dedup_key(requests) if _split_depth == 0 else None
            )
            if key is not None:
                results = self.cache_feed.single_flight(key, dispatch)
            else:
                results = dispatch()
        except Exception as exc:
            self._counts["batch_failures"] += 1
            _metrics.count("serve.batch_failures")
            if _is_oom(exc) and len(requests) > 1 and _split_depth < 4:
                self._counts["batch_splits"] += 1
                _metrics.count("serve.batch_splits")
                _degrade.record(
                    "serve", "batch_split",
                    f"{len(requests)} requests OOM'd; splitting",
                )
                log.warning(
                    "coalesced batch of %d OOM'd (%s); splitting in half",
                    len(requests), type(exc).__name__,
                )
                mid = len(requests) // 2
                self._execute(requests[:mid], _split_depth + 1)
                self._execute(requests[mid:], _split_depth + 1)
                return
            log.warning(
                "coalesced batch of %d failed (%s: %s); isolating",
                len(requests), type(exc).__name__, exc,
            )
            self._retry_singly(requests, exc)
            return
        coalesced = len(requests) > 1
        t_compute = time.perf_counter()
        for req in requests:
            req.compute_t = t_compute
        if coalesced:
            self._counts["coalesced"] += len(requests)
            _metrics.count("serve.coalesce.hits", len(requests))
        for req, data in zip(requests, results):
            self._finish(
                req,
                RequestResult(
                    STATUS_OK, data=data, path="coalesced",
                    batch_size=len(requests), coalesced=coalesced,
                ),
            )

    def _retry_singly(self, requests, batch_exc):
        """Per-request isolation after a batch failure: each request
        retries alone; persistent failures are quarantined so the rest
        of the queue keeps flowing."""
        for req in requests:
            last_err = batch_exc
            served = False
            for attempt in range(1, self.max_retries + 1):
                if self.retry_backoff_s > 0:
                    # capped jittered exponential backoff: retrying
                    # instantly against a struggling device synchronises
                    # the herd; the slept total is reported in stats()
                    delay = _backoff_delay(
                        attempt - 1, base_s=self.retry_backoff_s,
                        max_s=16 * self.retry_backoff_s,
                    )
                    self._backoff_slept_s += delay
                    time.sleep(delay)
                req.retries += 1
                self._counts["retries"] += 1
                _metrics.count("serve.retries")
                try:
                    if self.fault_injector is not None:
                        self.fault_injector([req], attempt)
                    data = self.fwd.get_subgrid_task(req.config)
                except Exception as exc:  # noqa: BLE001 - isolation layer
                    last_err = exc
                    continue
                req.compute_t = time.perf_counter()
                self._finish(
                    req,
                    RequestResult(
                        STATUS_OK, data=data, path="retry",
                        batch_size=1, retries=req.retries,
                    ),
                )
                served = True
                break
            if not served:
                err = f"{type(last_err).__name__}: {last_err}"
                self.quarantined.append((req, err))
                self._counts["quarantined"] += 1
                _metrics.count("serve.quarantined")
                _trace.instant("serve.quarantine", cat="serve",
                               request_id=req.req_id, error=err)
                log.error(
                    "request %r quarantined after %d retries: %s",
                    req, req.retries, err,
                )
                self._finish(
                    req,
                    RequestResult(
                        STATUS_QUARANTINED, error=err,
                        retries=req.retries,
                    ),
                )

    def _finish(self, req, result):
        now = time.perf_counter()
        result.latency_s = max(0.0, now - req.submit_t)
        if result.ok:
            self._counts["served"] += 1
            _metrics.count("serve.served")
            _metrics.observe("serve.request", result.latency_s)
            if req.take_t is not None and req.compute_t is not None:
                # contiguous timestamp diffs: the three segments sum to
                # latency_s EXACTLY (same `now`, monotonic clock) — the
                # p99-outlier decomposition contract
                result.journey = {
                    "queue_s": req.take_t - req.submit_t,
                    "compute_s": req.compute_t - req.take_t,
                    "transfer_s": now - req.compute_t,
                }
                if len(self._journeys) < _LATENCY_RING:
                    self._journeys.append(result.journey)
                else:
                    self._journeys[self._jour_i] = result.journey
                    self._jour_i = (self._jour_i + 1) % _LATENCY_RING
                self._trace_journey(req, result, now)
            if len(self._latencies) < _LATENCY_RING:
                self._latencies.append(result.latency_s)
            else:
                self._latencies[self._lat_i] = result.latency_s
                self._lat_i = (self._lat_i + 1) % _LATENCY_RING
            if (
                self.slo_ms is not None
                and result.latency_s * 1e3 > self.slo_ms
            ):
                self._counts["slo_violations"] += 1
                _metrics.count("serve.slo_violations")
        req._complete(result)

    @staticmethod
    def _trace_journey(req, result, now):
        """Emit the request journey onto the trace as one per-request
        track: an umbrella ``serve.journey`` span with the queue /
        compute / transfer segments as children — Perfetto shows one
        row per request, and trace_report decomposes p99 outliers."""
        if not _trace.enabled():
            return
        tid = _trace.JOURNEY_TID_BASE + (req.req_id % (1 << 20))
        root = _trace.add_span(
            "serve.journey", req.submit_t, now, cat="serve", tid=tid,
            request_id=req.req_id, path=result.path,
            batch_size=result.batch_size, retries=result.retries,
        )
        for name, t0, t1 in (
            ("serve.journey.queue", req.submit_t, req.take_t),
            ("serve.journey.compute", req.take_t, req.compute_t),
            ("serve.journey.transfer", req.compute_t, now),
        ):
            _trace.add_span(name, t0, t1, cat="serve", tid=tid,
                            parent=root, request_id=req.req_id)

    # -- worker thread ------------------------------------------------------

    def start(self):
        """Run the pump on a background worker; clients just submit."""
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._stop = False
        # contextvars do not flow into Thread targets: hand the worker
        # the CALLER's span context so pump spans nest under the run
        # (not as orphan roots) in a recorded trace
        trace_ctx = _trace.current()
        self._thread = threading.Thread(
            target=self._run, args=(trace_ctx,),
            name="subgrid-service", daemon=True,
        )
        self._thread.start()
        return self

    def _run(self, trace_ctx=0):
        _trace.adopt(trace_ctx)
        while True:
            n = self.pump_once()
            if n:
                continue
            with self._cond:
                if self._stop and not len(self.queue):
                    return
                self._cond.wait(timeout=0.02)

    def stop(self, drain=True, timeout=None):
        """Stop the worker; with ``drain`` the queue is served empty
        first, otherwise pending requests are shed."""
        if self._thread is None:
            return
        if not drain:
            for req in self.queue.drain():
                self._counts["shed"] += 1
                _metrics.count("serve.shed")
                req._complete(
                    RequestResult(STATUS_SHED, shed_reason="shutdown")
                )
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout)
        self._thread = None

    # -- incremental facet updates ------------------------------------------

    def post_facet_update(self, engine=None, new_facet_tasks=None, *,
                          report=None, feed=None, fwd=None, **update_kw):
        """Admit a new facet stack and serve from the patched cache.

        Two calling shapes:

        * ``post_facet_update(engine, new_facet_tasks)`` — run the
          `delta.IncrementalForward` update here (delta-stream + cache
          patch, or its degradation ladder) and adopt its feed;
        * ``post_facet_update(report=..., feed=..., fwd=...,
          new_facet_tasks=...)`` — adopt a pre-computed update (the
          fleet runs ``engine.update`` ONCE and propagates the result
          to every replica this way).

        In-flight requests are pinned to the version they were admitted
        under: the queue is DRAINED before the cache rows move, so
        every pending request completes against the facet stack it was
        admitted to; requests submitted after this returns carry the
        new version and are served from the patched rows. No cache
        flush — the feed swap is the only serving-path change.

        The compute FALLBACK moves with the update too: the forward is
        rebuilt over the new stack (an explicit ``fwd=``, or
        ``self.fwd.adopt_facet_tasks`` over the engine's adopted /
        passed ``new_facet_tasks``), so a new-version request that
        misses the feed — a config outside the recorded cover, an
        evicted disk entry, a stale-feed LookupError — is computed
        against the NEW facet data, never silently served stale.
        """
        if engine is None and report is None:
            raise ValueError(
                "post_facet_update needs an engine (to run the update) "
                "or a pre-computed report"
            )
        # drain: in-flight requests complete at their admitted version
        # BEFORE any cache row is patched out from under them (the
        # worker thread contends on _pump_lock, so its pumps drain too)
        while self.pump_once():
            pass
        with self._pump_lock:
            if engine is not None:
                report = engine.update(new_facet_tasks, **update_kw)
                if feed is None:
                    feed = engine.feed()
                if new_facet_tasks is None:
                    new_facet_tasks = engine.facet_tasks
            if fwd is not None:
                self.fwd = fwd
            elif report.get("mode") != "noop" and new_facet_tasks is not None:
                if hasattr(self.fwd, "adopt_facet_tasks"):
                    self.fwd.adopt_facet_tasks(new_facet_tasks)
                else:
                    log.warning(
                        "forward %s cannot adopt the new facet stack "
                        "(no adopt_facet_tasks); compute fallbacks "
                        "would serve the superseded stack — pass fwd= "
                        "explicitly", type(self.fwd).__name__,
                    )
            if feed is not None and self.cache_feed is not None:
                self.cache_feed = feed
            self.stream_version = int(
                report.get("stream_version", self.stream_version + 1)
            )
            self._counts["facet_updates"] += 1
            _metrics.count("serve.facet_updates")
            _trace.instant(
                "serve.facet_update", cat="serve",
                stream_version=self.stream_version,
                mode=report.get("mode"),
                changed_facets=report.get("changed_facets"),
            )
        return report

    # -- SLO export ---------------------------------------------------------

    def stats(self):
        """JSON-ready serving metrics (a run record's ``serve``
        block): request counts, shed/coalesce/cache rates,
        latency quantiles in ms, SLO attainment."""
        c = dict(self._counts)
        lat = sorted(self._latencies)
        served = c["served"]
        requests = c["requests"]
        out = {
            "n_requests": requests,
            "n_served": served,
            "n_shed": c["shed"],
            "n_expired": c["expired"],
            "n_quarantined": c["quarantined"],
            "n_batches": c["batches"],
            "batch_failures": c["batch_failures"],
            "batch_splits": c["batch_splits"],
            "retries": c["retries"],
            "retry_backoff_s": round(self._backoff_slept_s, 4),
            "cache_hits": c["cache_hits"],
            "cache_fallbacks": c["cache_fallbacks"],
            "stream_version": self.stream_version,
            "facet_updates": c["facet_updates"],
            "version_fallbacks": c["version_fallbacks"],
            "shed_rate": round(c["shed"] / requests, 4) if requests else 0.0,
            "shed_reasons": dict(self._shed_reasons),
            "coalesce_hit_rate": (
                round(c["coalesced"] / served, 4) if served else 0.0
            ),
            "mean_batch": (
                round(served / c["batches"], 2) if c["batches"] else 0.0
            ),
            "p50_ms": round(_quantile(lat, 0.50) * 1e3, 3),
            "p99_ms": round(_quantile(lat, 0.99) * 1e3, 3),
            "max_ms": round((lat[-1] if lat else 0.0) * 1e3, 3),
            "journey": self._journey_stats(),
        }
        if self.slo_ms is not None:
            out["slo_ms"] = self.slo_ms
            out["slo_violations"] = c["slo_violations"]
            out["slo_attainment"] = (
                round(1.0 - c["slo_violations"] / served, 4)
                if served else 1.0
            )
        return out

    def recent_journey_totals(self, window=256):
        """``(queue_s_total, total_s)`` over the most recent served
        journeys — the fleet brownout signal (`serve.fleet` divides the
        aggregates across replicas: a queue share near 1 means requests
        spend their life waiting, not computing)."""
        js = list(self._journeys)[-window:]
        if not js:
            return 0.0, 0.0
        total = sum(
            j["queue_s"] + j["compute_s"] + j["transfer_s"] for j in js
        )
        return sum(j["queue_s"] for j in js), total

    def _journey_stats(self):
        """The request-journey decomposition block: per-segment p50/p99
        and each segment's share of total served wall — where a p99
        latency regression LIVES (queue wait vs compute vs transfer),
        not just that it happened."""
        if not self._journeys:
            return None
        total = sum(
            j["queue_s"] + j["compute_s"] + j["transfer_s"]
            for j in self._journeys
        )
        out = {"n": len(self._journeys)}
        for seg in ("queue_s", "compute_s", "transfer_s"):
            vals = sorted(j[seg] for j in self._journeys)
            seg_total = sum(vals)
            key = seg[:-2]  # "queue_s" -> "queue"
            out[key] = {
                "p50_ms": round(_quantile(vals, 0.50) * 1e3, 3),
                "p99_ms": round(_quantile(vals, 0.99) * 1e3, 3),
                "total_s": round(seg_total, 6),
                "share": round(seg_total / total, 4) if total else 0.0,
            }
        return out
