"""`VisibilityService`: visibility samples as the product surface.

The port of the JAX package's ``swiftly_tpu/vis/service.py``. Rows stay on
the device: a computed row is degridded where it lies (the reference copies
it to the host and back), and a cache-fed host row goes up once, through
pinned memory. Each pump fetches the rows of all its subgrids first and
then answers all their samples in one launch of B4, with one copy back
(the reference dispatches once per subgrid); every per-subgrid observable
(``batch_size``, ``path``, ``coalesced``, ``n_batches``, ``mean_batch``,
the 4096-sample cap) stays the reference's, and ``n_pumps`` counts the
pumps that launched. The projected-device-memory admission
(``hbm_budget_bytes``) and the ``obs.metrics`` / ``trace`` hooks are the
reference's (``vis.row_fetch`` and ``vis.degrid`` stages, the request,
sample, shed and cache counters, the ``vis.request`` latencies).
`FleetRowSource` routes the compute fallback through a
`serve.fleet.ServeFleet`.

The reference's serving stack answers *subgrid* requests (`serve.service`);
radio-astronomy clients want *visibilities* — the sky transform sampled
at arbitrary fractional (u, v) baselines. This service closes the gap:
a submitted sample batch is split by owning subgrid
(`vis.mapping.VisCoverIndex`), admitted into the SAME
`serve.queue.AdmissionQueue` / `serve.scheduler.CoalescingScheduler`
machinery (coalesced by owning column, power-of-two sample buckets),
and answered per touched subgrid (one dispatch each in the reference's
count; one B4 launch a pump here, `vis.degrid.degrid_rows`) off a row
obtained through the serving ladder:

1. **cache feed** — `parallel.streamed.CachedColumnFeed.lookup` (one
   host-RAM row read, version-gated: a feed recorded at a superseded
   stream version raises and the request falls through);
2. **compute fallback** — ``row_source(config)`` when given, else
   `SwiftlyForward.get_subgrid_task` on the wrapped forward.

The same kernel (B4) runs on cache-fed and computed rows, so the serve
tier's cache-vs-compute bit-identity carries through to samples (pinned
by tests/test_torch_vis.py).

Version discipline: requests are stamped with the stream
version at submit; `post_facet_update` drains the queue, swaps the
forward/feed, and bumps the version, so a facet update can never serve
a stale sample — stale-stamped stragglers are version-fallback'd onto
the (new) compute path, and a `vis.grid.VisGridder` pinned to the old
version refuses further batches outright.

Samples whose kernel footprint straddles a subgrid boundary (or falls
off the cover) are SHED with ``shed_reason="outside_cover"`` — a
structured refusal, never a silently-wrong answer.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..ops.core import resolve_device
from ..serve.queue import (
    STATUS_EXPIRED,
    STATUS_OK,
    STATUS_SHED,
    AdmissionQueue,
    RequestResult,
    SubgridRequest,
)
from ..serve.scheduler import CoalescingScheduler
from .degrid import degrid_rows
from .kernel import vis_kernel
from .mapping import VisCoverIndex

__all__ = ["VisHandle", "VisRequest", "VisibilityService"]

_LATENCY_RING = 65536


def _quantile(sorted_samples, q):
    if not sorted_samples:
        return 0.0
    i = min(len(sorted_samples) - 1, int(q * len(sorted_samples)))
    return sorted_samples[i]


class VisRequest(SubgridRequest):
    """One owning-subgrid slice of a submitted sample batch.

    The admission/scheduling machinery sees a `SubgridRequest` (it
    keys on ``.config.off0``); the extra slots carry the slice's
    sample geometry and the parent handle to report into.
    """

    __slots__ = ("idx", "iu0", "iv0", "fu", "fv", "parent")

    def __init__(self, config, idx, iu0, iv0, fu, fv, parent,
                 priority=0, deadline_s=None):
        super().__init__(config, priority=priority,
                         deadline_s=deadline_s)
        self.idx = idx
        self.iu0 = iu0
        self.iv0 = iv0
        self.fu = fu
        self.fv = fv
        self.parent = parent

    @property
    def n_samples(self):
        return int(self.idx.size)


class VisHandle:
    """Completion handle for one submitted (u, v) batch.

    ``data`` is the [B] complex128 sample vector, NaN at positions that
    were shed or failed; ``status`` aggregates the per-subgrid slices:
    ``"ok"`` (every sample served), ``"shed"`` (every sample shed —
    ``shed_reason`` says why, e.g. ``outside_cover``), or ``"partial"``
    (mixed; ``shed_idx`` lists the unanswered positions).
    """

    def __init__(self, n_samples, submit_t):
        self.n_samples = int(n_samples)
        self.submit_t = submit_t
        self.data = np.full(self.n_samples, np.nan + 0j,
                            dtype=np.complex128)
        self.shed_idx = []
        self.shed_reason = None
        self.children = []
        self.latency_s = 0.0
        self._served = 0
        self._pending = 0
        self._event = threading.Event()

    @property
    def status(self):
        if self._served == self.n_samples:
            return STATUS_OK
        if self._served == 0:
            return STATUS_SHED
        return "partial"

    @property
    def done(self):
        return self._event.is_set()

    def wait(self, timeout=None):
        self._event.wait(timeout)
        return self

    def _shed(self, idx, reason):
        self.shed_idx.extend(int(i) for i in np.atleast_1d(idx))
        if self.shed_reason is None:
            self.shed_reason = reason

    def _child_done(self, req, result):
        if result.status == STATUS_OK:
            self.data[req.idx] = result.data
            self._served += req.n_samples
        else:
            self._shed(req.idx, result.shed_reason or result.status)
        self._pending -= 1
        if self._pending <= 0:
            self.latency_s = max(
                (r.result.latency_s for r in self.children
                 if r.result is not None),
                default=0.0,
            )
            self._event.set()

    def __repr__(self):
        return (
            f"<VisHandle n={self.n_samples} status={self.status} "
            f"served={self._served} shed={len(self.shed_idx)}>"
        )


class FleetRowSource:
    """Row fetch routed through a `serve.fleet.ServeFleet`.

    Passing one of these as ``row_source=`` puts the fleet's whole
    resilience ladder — rendezvous routing, failover, brownout, hedged
    retries — under visibility serving without either side changing:
    the vis service just sees rows, the fleet just sees subgrid
    requests. A row is returned as the fleet served it: a host array
    from a replica's cache feed, a device tensor from its compute path
    (degridded where it lies; the reference copies every row to the
    host).
    """

    def __init__(self, fleet, priority=0, deadline_s=None):
        self.fleet = fleet
        self.priority = priority
        self.deadline_s = deadline_s

    def __call__(self, config):
        req = self.fleet.submit(config, priority=self.priority,
                                deadline_s=self.deadline_s)
        # FleetRequest.wait returns the RequestResult (None on wait
        # timeout), unlike SubgridRequest.wait which returns itself
        result = req.wait(timeout=self.deadline_s)
        if result is None or not result.ok:
            status = getattr(result, "status", None)
            raise RuntimeError(
                f"fleet row fetch for column {config.off0} failed: "
                f"{status}"
            )
        data = result.data
        return data if isinstance(data, torch.Tensor) else np.asarray(data)


class VisibilityService:
    """Serve visibility sample batches over a prepared forward.

    :param fwd: prepared `SwiftlyForward` (compute fallback + the LRU
        whose resident columns steer the scheduler's locality
        preference); may be None when ``row_source`` is given
    :param subgrid_configs: the served cover (`models.covers
        .make_full_subgrid_cover` or any SubgridConfig list)
    :param N: grid period; defaults to ``fwd.config.image_size``
    :param kernel: `vis.kernel.VisKernel` (default: the cached
        default kernel)
    :param cache_feed: optional `parallel.streamed.CachedColumnFeed`
        (rung 1 of the row ladder)
    :param row_source: optional ``fn(config) -> row`` compute fallback
        (a torch tensor or a host array); default is
        ``fwd.get_subgrid_task``
    :param queue: `serve.queue.AdmissionQueue` (default depth
        ``max_depth``)
    :param scheduler: `serve.scheduler.CoalescingScheduler`
    :param timeout_s: service-wide per-request deadline
    :param slo_ms: per-request latency SLO for ``stats()``
    :param hbm_budget_bytes: optional projected-device-cost admission
        cap, priced with the plan's serve byte projections
        (`plan.model.projected_request_bytes`,
        `plan.model.projected_column_bytes`): past it, slices shed with
        the queue's reason ``"hbm"``
    :param device: where host rows are degridded; defaults to the
        forward's device, else the GPU
    """

    def __init__(self, fwd=None, subgrid_configs=None, N=None,
                 kernel=None, cache_feed=None, row_source=None,
                 queue=None, scheduler=None, timeout_s=None,
                 slo_ms=None, max_depth=512, hbm_budget_bytes=None,
                 device=None):
        if subgrid_configs is None:
            raise ValueError("need the served subgrid cover")
        if fwd is None and row_source is None:
            raise ValueError("need a forward or a row_source")
        if N is None:
            N = getattr(getattr(fwd, "config", None),
                        "image_size", None)
        if N is None:
            raise ValueError(
                "need N (or a forward whose config carries image_size)"
            )
        if device is None and fwd is not None:
            device = fwd.core.device
        self.device = resolve_device(device)
        self.fwd = fwd
        self.kernel = kernel or vis_kernel()
        # the tap table B4 computes the weights from, kept on the device
        self._table = torch.as_tensor(self.kernel.table,
                                      dtype=torch.float64, device=self.device)
        self.cover = VisCoverIndex(
            subgrid_configs, self.kernel.support, int(N)
        )
        self.cache_feed = cache_feed
        self.row_source = row_source
        self.stream_version = int(
            getattr(cache_feed, "stream_version", 0)
        )
        if queue is None:
            # admission byte model: a pending slice pins one served row
            # plus the column intermediates a compute fallback makes
            request_bytes = column_bytes = 0
            if hbm_budget_bytes is not None and fwd is not None:
                from ..plan.model import (
                    projected_column_bytes,
                    projected_request_bytes,
                )

                request_bytes = projected_request_bytes(fwd.config)
                column_bytes = projected_column_bytes(fwd)
            queue = AdmissionQueue(
                max_depth=max_depth,
                hbm_budget_bytes=hbm_budget_bytes,
                request_bytes=request_bytes,
                column_bytes=column_bytes,
            )
        self.queue = queue
        self.scheduler = scheduler or CoalescingScheduler()
        self.timeout_s = timeout_s
        self.slo_ms = slo_ms
        self._counts = {
            "requests": 0, "samples": 0, "served": 0,
            "served_samples": 0, "shed": 0, "shed_samples": 0,
            "expired": 0, "batches": 0, "coalesced": 0,
            "cache_hits": 0, "cache_fallbacks": 0,
            "version_fallbacks": 0, "slo_violations": 0,
            "facet_updates": 0, "pumps": 0,
        }
        self._shed_reasons = {}
        self._latencies = []
        self._lat_i = 0
        self._journeys = []
        self._jour_i = 0
        self._pump_lock = threading.Lock()

    # -- submission ---------------------------------------------------

    def submit(self, uv, priority=0, deadline_s=None):
        """Admit one sample batch; returns a `VisHandle`.

        Outside-cover samples are shed immediately (structured,
        per-sample); the rest are split into one `VisRequest` per
        owning subgrid and admitted. Admission never blocks — a queue
        rejection sheds that slice with the queue's reason.
        """
        if deadline_s is None:
            deadline_s = self.timeout_s
        elif self.timeout_s is not None:
            deadline_s = min(deadline_s, self.timeout_s)
        uv = np.atleast_2d(np.asarray(uv, dtype=float))
        handle = VisHandle(uv.shape[0], time.perf_counter())
        self._counts["requests"] += 1
        self._counts["samples"] += handle.n_samples
        _metrics.count("vis.requests")
        _metrics.count("vis.samples", handle.n_samples)
        owners, shed = self.cover.map_samples(uv)
        if shed:
            self._shed_samples(handle, shed, "outside_cover")
        for (off0, off1), entry in owners.items():
            req = VisRequest(
                self.cover.config(off0, off1), entry["idx"],
                entry["iu0"], entry["iv0"], entry["fu"], entry["fv"],
                handle, priority=priority, deadline_s=deadline_s,
            )
            req.stream_version = self.stream_version
            handle.children.append(req)
            handle._pending += 1
            admitted, reason = self.queue.offer(req)
            if not admitted:
                self._shed_counts(req.n_samples, reason)
                req._complete(RequestResult(
                    STATUS_SHED, shed_reason=reason,
                    retry_after_s=self.queue.retry_after_hint(),
                ))
                handle._child_done(req, req.result)
        _metrics.gauge_max("vis.queue_depth_peak", len(self.queue))
        if handle._pending == 0:
            handle._event.set()
        return handle

    def _shed_counts(self, n_samples, reason):
        self._counts["shed"] += 1
        self._counts["shed_samples"] += n_samples
        self._shed_reasons[reason] = (
            self._shed_reasons.get(reason, 0) + n_samples
        )
        _metrics.count("vis.shed")
        _metrics.count(f"vis.shed.{reason}", n_samples)

    def _shed_samples(self, handle, idx, reason):
        self._shed_counts(len(idx), reason)
        _trace.instant("vis.shed", cat="vis", reason=reason,
                       n_samples=len(idx))
        handle._shed(idx, reason)

    def serve(self, uv, priority=0, deadline_s=None):
        """Submit one batch and pump until it completes (sync use)."""
        handle = self.submit(uv, priority=priority,
                             deadline_s=deadline_s)
        while not handle.done:
            if not self.pump_once():
                break
        return handle

    # -- pump ---------------------------------------------------------

    def pump_once(self, now=None):
        """One scheduling cycle; returns requests completed."""
        with self._pump_lock:
            return self._pump_locked(now)

    def _pump_locked(self, now):
        now = time.perf_counter() if now is None else now
        n_done = 0
        for req in self.queue.take_expired(now):
            self._counts["expired"] += 1
            _metrics.count("vis.expired")
            self._finish(
                req, RequestResult(STATUS_EXPIRED, error="deadline")
            )
            n_done += 1
        summaries = self.queue.columns()
        if not summaries:
            return n_done
        hot = (
            set(self.fwd.lru.keys())
            if self.fwd is not None and hasattr(self.fwd, "lru")
            else set()
        )
        off0 = self.scheduler.pick_column(summaries, hot, now)
        if off0 is None:
            return n_done
        reqs = self.queue.take(
            off0, limit=self.scheduler.max_batch, now=now
        )
        groups = {}
        for req in reqs:
            key = (req.config.off0, req.config.off1)
            groups.setdefault(key, []).append(req)
        fetched = []
        for rs in groups.values():
            got = self._fetch_group(rs)
            if got is not None:
                fetched.append((rs, *got))
        if fetched:
            self._serve_pump(fetched)
        return n_done + len(reqs)

    def _fetch_row(self, sg, reqs):
        """The row ladder: version-gated cache feed, then compute."""
        row_bytes = 2 * sg.size * sg.size * 4
        if self.cache_feed is not None:
            stale = sum(
                1 for r in reqs
                if r.stream_version != self.stream_version
            )
            if stale:
                # admitted under a superseded facet stack: the feed's
                # rows no longer match the request's era — fall
                # through to compute against the CURRENT stack
                # (fresher than asked; never staler)
                self._counts["version_fallbacks"] += stale
                _metrics.count("vis.version_fallbacks", stale)
            else:
                try:
                    with _metrics.stage("vis.row_fetch",
                                        bytes_moved=row_bytes):
                        row = self.cache_feed.lookup(sg)
                except LookupError:
                    self._counts["cache_fallbacks"] += 1
                    _metrics.count("vis.cache_fallbacks")
                    row = None
                if row is not None:
                    self._counts["cache_hits"] += 1
                    _metrics.count("vis.cache_hits")
                    return row, "cache"
        with _metrics.stage("vis.row_fetch", bytes_moved=row_bytes):
            if self.row_source is not None:
                row = self.row_source(sg)
            else:  # stays on the device
                row = self.fwd.get_subgrid_task(sg)
        return row, "compute"

    def _fetch_group(self, reqs):
        """One subgrid's row through the ladder, as (row, path); None when
        the ladder is exhausted and the subgrid's requests were shed."""
        try:
            return self._fetch_row(reqs[0].config, reqs)
        except Exception as exc:  # row ladder exhausted
            for req in reqs:
                self._shed_counts(req.n_samples, "row_fetch_failed")
                self._finish(req, RequestResult(
                    STATUS_SHED, shed_reason="row_fetch_failed",
                    error=repr(exc),
                ))
            return None

    def _serve_pump(self, fetched):
        """Answer every sample of the pump's fetched subgrids in one degrid
        launch, then finish the requests subgrid by subgrid, each with its
        subgrid's dispatch size."""
        reqs = [r for rs, _, _ in fetched for r in rs]
        slot = np.repeat(np.arange(len(fetched)),
                         [sum(r.n_samples for r in rs)
                          for rs, _, _ in fetched])
        W = self.kernel.support
        n_lanes = len(slot)
        with _metrics.stage("vis.degrid", flops=6 * n_lanes * W * W,
                            bytes_moved=2 * n_lanes * W * W * 4):
            vis = degrid_rows(
                [row for _, row, _ in fetched], slot,
                *(np.concatenate([getattr(r, f) for r in reqs])
                  for f in ("iu0", "iv0", "fu", "fv")),
                self._table, device=self.device)
        self._counts["pumps"] += 1
        now = time.perf_counter()
        lo = 0
        for rs, _, path in fetched:
            B = sum(r.n_samples for r in rs)
            for req in rs:
                req.compute_t = now
                n = req.n_samples
                self._counts["coalesced"] += 1 if len(rs) > 1 else 0
                self._counts["served_samples"] += n
                _metrics.count("vis.served_samples", n)
                self._finish(req, RequestResult(
                    STATUS_OK, data=vis[lo:lo + n], path=path,
                    batch_size=B, coalesced=len(rs),
                ))
                lo += n
            self._counts["batches"] += 1

    def _finish(self, req, result):
        now = time.perf_counter()
        result.latency_s = now - req.submit_t
        if result.status == STATUS_OK:
            self._counts["served"] += 1
            _metrics.observe("vis.request", result.latency_s)
            if req.take_t and req.compute_t:
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
                _metrics.count("vis.slo_violations")
        req._complete(result)
        if req.parent is not None:
            req.parent._child_done(req, result)

    # -- incremental facet updates ------------------------------------

    def post_facet_update(self, fwd=None, cache_feed=None,
                          stream_version=None):
        """Adopt an updated facet stack: drain, swap, bump.

        In-flight requests complete at their admitted version BEFORE
        the swap; requests submitted after this returns carry the new
        version. A straggler stamped with the old version that arrives
        at the feed later is version-fallback'd onto the (new) compute
        path — a facet update can never serve a stale sample. With no
        replacement ``cache_feed`` the old feed is DROPPED (its rows
        are the superseded era's) and the compute path serves until a
        re-recorded feed is adopted.
        """
        while self.pump_once():
            pass
        with self._pump_lock:
            if fwd is not None:
                self.fwd = fwd
            # swap or DROP the feed: with no replacement, the old
            # feed's rows belong to the superseded era — keeping them
            # would serve stale samples to new-version requests, the
            # exact hole the version discipline exists to close
            self.cache_feed = cache_feed
            if stream_version is None:
                stream_version = self.stream_version + 1
            self.stream_version = int(stream_version)
            self._counts["facet_updates"] += 1
            _metrics.count("vis.facet_updates")
            _trace.instant("vis.facet_update", cat="vis",
                           stream_version=self.stream_version)
        return self.stream_version

    # -- SLO export ---------------------------------------------------

    def stats(self):
        """JSON-ready serving metrics: request/sample counts, shed/coalesce/cache
        rates, latency quantiles in ms, SLO attainment."""
        c = dict(self._counts)
        lat = sorted(self._latencies)
        served = c["served"]
        requests = c["requests"]
        samples = c["samples"]
        out = {
            "n_requests": requests,
            "n_samples": samples,
            "n_served": served,
            "n_served_samples": c["served_samples"],
            "n_shed": c["shed"],
            "n_shed_samples": c["shed_samples"],
            "n_expired": c["expired"],
            "n_batches": c["batches"],
            "n_pumps": c["pumps"],
            "cache_hits": c["cache_hits"],
            "cache_fallbacks": c["cache_fallbacks"],
            "stream_version": self.stream_version,
            "facet_updates": c["facet_updates"],
            "version_fallbacks": c["version_fallbacks"],
            "shed_rate": (
                round(c["shed_samples"] / samples, 4) if samples
                else 0.0
            ),
            "shed_reasons": dict(self._shed_reasons),
            "coalesce_hit_rate": (
                round(c["coalesced"] / served, 4) if served else 0.0
            ),
            "mean_batch": (
                round(c["served_samples"] / c["batches"], 2)
                if c["batches"] else 0.0
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

    def _journey_stats(self):
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
            out[seg[:-2]] = {
                "p50_ms": round(_quantile(vals, 0.50) * 1e3, 3),
                "p99_ms": round(_quantile(vals, 0.99) * 1e3, 3),
                "total_s": round(seg_total, 6),
                "share": round(seg_total / total, 4) if total else 0.0,
            }
        return out
