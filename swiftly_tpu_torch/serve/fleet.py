"""`ServeFleet`: a self-healing fleet of `SubgridService` replicas.

One `SubgridService` is one in-process server; its death loses every
in-flight request. The fleet runs **N replicas** (threads — each over
its own prepared `SwiftlyForward`; on one GPU they all launch on the
card's default stream, the device programs interleaving in launch
order) behind a routing front, supervised so that replica death is an *absorbed* event:

* **Routing** — rendezvous (highest-random-weight) hashing of the
  subgrid column ``off0`` over the live replicas. Stable by
  construction: each column has one preferred replica (whose column
  LRU therefore stays hot for it), a dead replica's columns
  redistribute over the survivors without disturbing anyone else's
  assignment, and they return when it is restored. Every routing
  decision passes the ``fleet.route`` fault site (injected route
  faults are retried with the jittered backoff).
* **Health** — each replica's pump loop beats a `HealthLease`
  (`serve.health`); the supervisor grades leases every tick, probes
  suspects (``fleet.health.probe`` site), and **revokes** dead ones.
  A revoked replica's lease latches: zombie beats are ignored until an
  explicit restore.
* **Circuit breakers** — one `resilience.breaker.CircuitBreaker` per
  replica. Lease revocation trips it open (and consecutive request
  failures open it the classic way); while open the router skips the
  replica; after the jittered reopen delay, half-open probe requests
  flow and their successes close it.
* **Zero-loss failover** — the fleet keeps a ledger of every admitted
  request. When a replica dies (its pump raises `WorkerKilled` — the
  ``fleet.replica.kill`` site — or its lease is revoked), the
  supervisor re-routes its queued *and* in-flight requests to
  survivors with the jittered backoff ladder between attempts.
  Results are bit-identical wherever they run (the engine is
  deterministic), and an admitted deadline-less request is never
  dropped — admission is the only door that sheds.
* **Brownout** — fleet-wide overload policy driven by the request-journey
  decomposition: when the recent queue-wait share of request latency
  crosses ``brownout_share`` (requests spend their life waiting, not
  computing), the fleet steps down a ladder — rung 1 sheds
  lowest-priority submissions at the door with a structured
  ``retry_after_s`` hint; rung 2 degrades every replica to per-request
  dispatch (``max_batch = 1``) so high-priority requests stop queueing
  behind coalesced batches. Both rungs are recorded in the
  degradation ledger and reversed with hysteresis when pressure clears.
* **Hedged sends** — a request still pending past its p99 budget
  (``hedge_factor`` x the fleet's rolling p99) is duplicated onto a
  second replica; the first completion wins (idempotent), the loser is
  discarded. One hedge per request.

Drive it with ``start()`` (replica pumps + supervisor thread) and
``submit(...).wait()``, or deterministically with ``tick(now)`` and
manual service pumps (tests).

The port of the JAX package's ``swiftly_tpu/serve/fleet.py``: the same
routing (`_rendezvous_score` is pure integer arithmetic, so both packages
route every column to the same replica), leases, breakers, failover,
brownout, hedging, admission cap, elasticity and tower sources. A
replica's compute results are device tensors and its cache-path results
host rows, as its service returns them.
"""

from __future__ import annotations

import itertools
import logging
import random
import threading
import time

from ..obs import metrics as _metrics
from ..obs import recorder as _recorder
from ..obs import trace as _trace
from ..obs.tower import ControlTower
from ..resilience import degrade as _degrade
from ..resilience.breaker import CircuitBreaker
from ..resilience.faults import WorkerKilled, fault_point as _fault_point
from ..resilience.retry import backoff_delay, retry_transient
from .health import HealthLease, HealthMonitor, REVOKED
from .queue import (
    RequestResult,
    STATUS_EXPIRED,
    STATUS_OK,
    STATUS_SHED,
)

__all__ = ["FleetRequest", "Replica", "ServeFleet"]

log = logging.getLogger(__name__)

_FLEET_IDS = itertools.count()
_LAT_RING = 4096  # newest-wins fleet latency samples for the p99 budget


def _rendezvous_score(off0, rid):
    """Deterministic 32-bit mix of (column, replica) — the
    highest-random-weight routing score. Pure integer arithmetic:
    stable across processes and platforms (unlike ``hash()``)."""
    x = (int(off0) * 0x9E3779B1 ^ (int(rid) + 0x85EBCA6B)) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x045D9F3B) & 0xFFFFFFFF
    x ^= x >> 16
    return x


def _replica_telemetry(service):
    """Tower-source adapter over one replica's service: the counters/
    stages contract `ControlTower.fleet_telemetry` sums fleet-wide.
    ``.get`` defaults keep it safe over stub services (tests)."""

    def export():
        s = service.stats()
        out = {
            "counters": {
                "served": s.get("n_served", 0),
                "requests": s.get("n_requests", 0),
                "shed": s.get("n_shed", 0),
                "retries": s.get("retries", 0),
                "cache_hits": s.get("cache_hits", 0),
            },
            "p99_ms": s.get("p99_ms", 0.0),
        }
        j = s.get("journey")
        if j:
            stages = {}
            for seg in ("queue", "compute", "transfer"):
                seg_info = j.get(seg)
                if seg_info:
                    stages[f"serve.journey.{seg}"] = {
                        "count": int(j.get("n", 0)),
                        "total_s": float(seg_info.get("total_s", 0.0)),
                    }
            if stages:
                out["stages"] = stages
        return out

    return export


def _fabric_telemetry(fabric):
    """Tower-source adapter over the shared cache fabric."""

    def export():
        s = fabric.stats()
        return {
            "counters": {
                k: s.get(k, 0)
                for k in ("l1_hits", "l2_hits", "misses", "promotions",
                          "l1_evictions", "rolls", "dedup_hits",
                          "dedup_computes")
            },
            "hit_ratio": s.get("hit_ratio", 0.0),
            "stream_version": s.get("stream_version", 0),
            "views": s.get("views", 0),
        }

    return export


class FleetRequest:
    """Client-facing handle for one fleet request.

    Survives failover and hedging: the underlying per-replica
    `SubgridRequest` may be re-issued on another replica, but the
    client holds ONE handle whose completion is idempotent —
    the first terminal result wins, later (hedge-loser / zombie)
    completions are discarded.
    """

    __slots__ = (
        "config", "priority", "req_id", "submit_t", "deadline_t",
        "result", "replica_trail", "_event", "_lock", "_clock",
    )

    def __init__(self, config, priority=0, deadline_s=None,
                 clock=time.monotonic):
        self.config = config
        self.priority = int(priority)
        self.req_id = next(_FLEET_IDS)
        self._clock = clock
        self.submit_t = clock()
        self.deadline_t = (
            None if deadline_s is None
            else self.submit_t + float(deadline_s)
        )
        self.result = None
        self.replica_trail = []  # rids this request was offered to
        self._event = threading.Event()
        self._lock = threading.Lock()

    @property
    def done(self):
        return self.result is not None

    def wait(self, timeout=None):
        """Block until terminal; returns the `RequestResult` (or None
        on wait timeout)."""
        self._event.wait(timeout)
        return self.result

    def _complete(self, result, now=None):
        """First terminal result wins; returns False for losers."""
        with self._lock:
            if self.result is not None:
                return False
            now = self._clock() if now is None else now
            # fleet latency: client submit -> fleet completion (spans
            # failovers and hedges, not just the winning replica's leg)
            result.latency_s = max(0.0, now - self.submit_t)
            self.result = result
        self._event.set()
        return True

    def __repr__(self):
        return (
            f"FleetRequest(#{self.req_id}, off0={self.config.off0}, "
            f"off1={self.config.off1}, prio={self.priority})"
        )


class Replica:
    """One fleet member: a `SubgridService` plus its pump thread,
    health lease and circuit breaker.

    The pump loop is where simulated chip death lands: every iteration
    calls the ``fleet.replica.kill`` fault site and honours the
    `kill()` drill hook; a raised `WorkerKilled` (a BaseException — it
    tears through like a real SIGKILL) marks the replica dead and ends
    the thread. The service object and its prepared forward survive,
    so `restore()` is just a fresh pump thread over warm state.
    """

    def __init__(self, rid, service, lease, breaker, poll_s=0.001):
        self.rid = int(rid)
        self.service = service
        self.lease = lease
        self.breaker = breaker
        self.poll_s = float(poll_s)
        self.dead = False
        self._kill_flag = False
        self._stop = False
        self._thread = None

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(f"replica {self.rid} already running")
        self._stop = False
        self._kill_flag = False
        self.dead = False
        trace_ctx = _trace.current()
        self._thread = threading.Thread(
            target=self._run, args=(trace_ctx,),
            name=f"fleet-replica-{self.rid}", daemon=True,
        )
        self._thread.start()
        return self

    def _run(self, trace_ctx=0):
        _trace.adopt(trace_ctx)
        _trace.name_track(threading.get_native_id(),
                          f"replica-{self.rid}")
        try:
            while not self._stop:
                if self._kill_flag:
                    raise WorkerKilled(
                        f"replica {self.rid} killed (drill hook)"
                    )
                self.lease.beat()
                if len(self.service.queue):
                    # the kill site fires between "holds pending work"
                    # and "serves it" — a kill here strands a real
                    # backlog, the case failover exists for (an idle
                    # replica's death is trivially lossless and would
                    # otherwise win every call-indexed schedule, since
                    # idle pumps spin far faster than serving ones)
                    _fault_point("fleet.replica.kill")
                if self.service.pump_once() == 0:
                    time.sleep(self.poll_s)
        except WorkerKilled as exc:
            # simulated chip death: stop beating, leave the queue for
            # the supervisor's failover sweep
            self.dead = True
            _metrics.count("fleet.replica_deaths")
            _trace.instant("fleet.replica_death", cat="fleet",
                           replica=self.rid, error=str(exc))
            _recorder.record("fleet", "fleet.replica_death",
                             f"replica {self.rid}: {exc}")
            log.warning("replica %d died: %s", self.rid, exc)

    def alive(self):
        return (
            not self.dead
            and self._thread is not None
            and self._thread.is_alive()
        )

    def kill(self):
        """Drill hook: the pump raises `WorkerKilled` on its next
        iteration (equivalent to a ``fleet.replica.kill`` fault)."""
        self._kill_flag = True

    def stop(self, timeout=5.0):
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def restore(self):
        """Fresh pump thread over the surviving service state (warm
        forward, warm LRU); the lease/breaker are the caller's to
        revive."""
        if self.alive():
            raise RuntimeError(f"replica {self.rid} is still alive")
        self._thread = None
        return self.start()

    def __repr__(self):
        return (
            f"Replica({self.rid}, dead={self.dead}, "
            f"alive={self.alive()})"
        )


class _Entry:
    """Fleet-side ledger record for one pending request."""

    __slots__ = ("freq", "subs", "reroutes", "not_before", "hedged",
                 "shed_rids", "shed_hints", "admitted")

    def __init__(self, freq):
        self.freq = freq
        self.subs = []         # [(rid, SubgridRequest, is_hedge), ...]
        self.reroutes = 0
        self.not_before = 0.0  # backoff gate for the next reroute
        self.hedged = False
        self.shed_rids = set()
        self.shed_hints = []
        self.admitted = False


class ServeFleet:
    """N supervised `SubgridService` replicas behind one front door.

    :param replica_factory: ``fn(rid) -> SubgridService`` — builds one
        replica's service (typically over its own prepared forward)
    :param n_replicas: fleet size
    :param lease_interval_s / miss_suspect / miss_revoke: heartbeat
        lease grading (see `serve.health.HealthLease`)
    :param breaker_threshold / breaker_reopen_s / breaker_max_reopen_s
        / half_open_probes: per-replica circuit breaker tuning
    :param hedge_budget_s: age past which a pending request is hedged
        onto a second replica; None derives it as ``hedge_factor`` x
        the fleet's rolling p99 (floored at ``hedge_min_s``); 0
        disables hedging
    :param brownout_share: recent queue-wait share of latency that
        triggers the brownout ladder
    :param brownout_min_depth: total queued requests below which
        brownout never triggers (an idle fleet has no overload)
    :param brownout_min_priority: rung-1 sheds submissions with
        ``priority <`` this floor
    :param brownout_escalate_s: seconds at rung 1 before rung 2
        (per-request dispatch)
    :param failover_backoff_s: base of the jittered backoff ladder
        between failover reroute attempts
    :param supervise_interval_s: supervisor thread tick period
    :param seed: seeds the breakers' reopen jitter (deterministic
        drills)
    :param clock: injectable monotonic clock (tests drive `tick(now)`)
    :param hbm_budget_bytes: fleet-wide projected device-memory
        admission cap
        (None disables). Each pending request prices
        ``request_bytes`` and each distinct pending column per replica
        prices ``column_bytes`` — the unified plan compiler's serve
        pricing (`plan.compile_plan(...).serve`); a submission whose
        projection would cross the cap is shed at the fleet door with
        a structured ``retry_after_s``, before any replica queue is
        touched.
    :param request_bytes / column_bytes: the admission cost model
        (typically ``plan.serve.request_bytes`` /
        ``plan.serve.column_bytes``)
    :param fabric: optional `cache.SharedStreamTier` — the shared cache
        fabric. When set, the replica factory is called as
        ``fn(rid, feed_view)`` and must build its service over that
        view (ONE resident stream copy for the whole fleet; a factory
        that builds its own per-replica cache defeats the fabric), and
        `post_facet_update` rolls the fabric once instead of building N
        feeds.
    :param drain_timeout_s: grace a draining replica (autoscale
        scale-in) gets to finish its backlog before the fleet
        force-revokes its lease and fails the remainder over — the
        zero-loss escape hatch, not the normal path
    :param tower: optional `obs.tower.ControlTower`; one is built on
        the fleet's clock when not given. Every replica registers a
        telemetry source with it, the supervisor tick samples its
        windowed signals ONCE and hands that sample to both the
        brownout ladder and the autoscaler, and its SLOs are evaluated
        every tick.
    """

    def __init__(self, replica_factory, n_replicas=3, *,
                 lease_interval_s=0.05, miss_suspect=2, miss_revoke=5,
                 breaker_threshold=3, breaker_reopen_s=0.5,
                 breaker_max_reopen_s=8.0, half_open_probes=2,
                 hedge_budget_s=None, hedge_factor=2.0, hedge_min_s=0.05,
                 brownout_share=0.6, brownout_min_depth=8,
                 brownout_min_priority=1, brownout_escalate_s=0.25,
                 failover_backoff_s=0.01, failover_backoff_max_s=0.5,
                 supervise_interval_s=0.002, poll_s=0.001, seed=0,
                 clock=time.monotonic, hbm_budget_bytes=None,
                 request_bytes=0, column_bytes=0, fabric=None,
                 drain_timeout_s=30.0, tower=None):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self._clock = clock
        self.hbm_budget_bytes = hbm_budget_bytes
        self.request_bytes = int(request_bytes)
        self.column_bytes = int(column_bytes)
        self.hedge_budget_s = hedge_budget_s
        self.hedge_factor = float(hedge_factor)
        self.hedge_min_s = float(hedge_min_s)
        self.brownout_share = float(brownout_share)
        self.brownout_min_depth = int(brownout_min_depth)
        self.brownout_min_priority = int(brownout_min_priority)
        self.brownout_escalate_s = float(brownout_escalate_s)
        self.failover_backoff_s = float(failover_backoff_s)
        self.failover_backoff_max_s = float(failover_backoff_max_s)
        self.supervise_interval_s = float(supervise_interval_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.fabric = fabric
        # the autoscaler (serve.autoscale.FleetAutoscaler) attaches
        # here; the supervisor tick evaluates it when present
        self.autoscaler = None
        # the control tower: every replica registers a telemetry
        # source; the supervisor tick samples its signals once for the
        # brownout ladder + autoscaler and evaluates its SLOs
        self.tower = tower if tower is not None else ControlTower(
            clock=clock
        )
        self.last_post_mortem = None
        # replica construction state, kept so `add_replica` can scale
        # out after __init__ with the same factory and tuning
        self._replica_factory = replica_factory
        self._lease_kw = dict(
            interval_s=lease_interval_s, miss_suspect=miss_suspect,
            miss_revoke=miss_revoke,
        )
        self._breaker_kw = dict(
            failure_threshold=breaker_threshold,
            reopen_s=breaker_reopen_s,
            max_reopen_s=breaker_max_reopen_s,
            half_open_probes=half_open_probes,
        )
        self._seed = int(seed)
        self._poll_s = float(poll_s)
        self.monitor = HealthMonitor(probe=self._probe, clock=clock)
        self._lock = threading.RLock()
        self._replicas = {}
        self._draining = {}  # rid -> drain start time
        self._retired = []   # final stats rows of drained replicas
        self._next_rid = 0
        for _ in range(int(n_replicas)):
            self._build_replica()
        self._pending = {}  # freq.req_id -> _Entry
        self._counts = {
            "requests": 0, "served": 0, "shed": 0, "expired": 0,
            "quarantined": 0, "failovers": 0, "reroutes": 0,
            "hedges": 0, "hedge_wins": 0, "route_faults": 0,
            "brownout_sheds": 0, "hbm_sheds": 0, "restores": 0,
            "scale_outs": 0, "drains": 0,
        }
        self._lat = []
        self._lat_i = 0
        self._p99_cache = 0.0
        self._p99_dirty = 0
        self._brownout_level = 0
        self._brownout_since = 0.0
        self._brownout_events = []
        self._saved_max_batch = {}
        self._sup_stop = False
        self._sup_thread = None
        # windowed signals: late-bound so instance-attribute overrides
        # (drill hooks) and live replica sets are always honored
        self.tower.register_signal(
            "fleet.queue_share", lambda: self.queue_share()
        )
        self.tower.register_signal(
            "fleet.queued_depth", lambda: float(self.queued_depth())
        )
        self.tower.register_signal(
            "fleet.p99_ms", lambda: self._rolling_p99() * 1e3
        )
        self.tower.register_signal("fleet.shed_rate", self._shed_rate)
        self.tower.register_signal(
            "fleet.brownout_level",
            lambda: float(self._brownout_level),
        )
        self.tower.register_source(
            "fleet", self._fleet_telemetry, kind="fleet"
        )
        if fabric is not None:
            self.tower.register_signal(
                "cache.hit_ratio",
                lambda: fabric.stats().get("hit_ratio", 0.0),
            )
            self.tower.register_source(
                "fabric", _fabric_telemetry(fabric), kind="cache"
            )

    def _shed_rate(self):
        n = self._counts["requests"]
        return (self._counts["shed"] / n) if n else 0.0

    def _fleet_telemetry(self):
        """The fleet's own tower source: door counters (prefixed so
        they never collide with per-replica counter names in the
        fleet-wide totals)."""
        with self._lock:
            counters = {f"fleet.{k}": v for k, v in self._counts.items()}
            counters["fleet.pending"] = len(self._pending)
        counters["fleet.n_replicas"] = len(self._replicas)
        counters["fleet.brownout_level"] = self._brownout_level
        return {"counters": counters}

    # -- topology ------------------------------------------------------------

    def _build_replica(self):
        """Construct and register one replica (service via the stored
        factory — with a fabric, over its feed view — plus lease and
        breaker); returns it. Does NOT start the pump."""
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            if self.fabric is not None:
                service = self._replica_factory(
                    rid, self.fabric.view(rid)
                )
            else:
                service = self._replica_factory(rid)
            lease = HealthLease(
                owner=f"replica-{rid}", clock=self._clock,
                **self._lease_kw,
            )
            breaker = CircuitBreaker(
                name=f"replica-{rid}",
                rng=random.Random(self._seed + rid + 1),
                clock=self._clock, **self._breaker_kw,
            )
            self.monitor.register(rid, lease)
            replica = Replica(
                rid, service, lease, breaker, poll_s=self._poll_s
            )
            self._replicas[rid] = replica
            self.tower.register_source(
                f"replica-{rid}", _replica_telemetry(service),
                kind="replica",
            )
            return replica

    @property
    def replicas(self):
        return dict(self._replicas)

    @property
    def draining(self):
        """rids currently draining toward retirement (scale-in)."""
        with self._lock:
            return set(self._draining)

    def replica(self, rid):
        return self._replicas[rid]

    def _probe(self, rid):
        replica = self._replicas.get(rid)
        return replica is not None and replica.alive()

    def preferred_replica(self, off0):
        """The rendezvous winner for a column over the FULL fleet
        (health-blind — the router's starting point; drills use it to
        aim traffic at a specific replica)."""
        return max(
            list(self._replicas),
            key=lambda rid: _rendezvous_score(off0, rid),
        )

    # -- routing -------------------------------------------------------------

    def _routable(self, rid, exclude):
        if rid in exclude or rid in self._draining:
            return False
        replica = self._replicas.get(rid)
        if replica is None:
            return False
        return not replica.dead and not replica.lease.revoked

    def _pick(self, off0, exclude, now):
        """The replica one request routes to, or None (every candidate
        excluded, revoked, or breaker-denied). Candidates are tried in
        rendezvous-score order; the breaker gate runs only on actual
        candidates so half-open probe slots are spent on real sends."""
        try:
            retry_transient(
                lambda: _fault_point("fleet.route"),
                site="fleet.route", max_attempts=3,
                base_s=0.001, max_s=0.01,
                on_retry=self._count_route_fault,
            )
        except Exception:  # noqa: BLE001 - exhausted route retries
            self._counts["route_faults"] += 1
            _metrics.count("fleet.route_exhausted")
            return None
        order = sorted(
            (rid for rid in list(self._replicas)
             if self._routable(rid, exclude)),
            key=lambda rid: _rendezvous_score(off0, rid),
            reverse=True,
        )
        for rid in order:
            replica = self._replicas.get(rid)
            if replica is not None and replica.breaker.allow(now):
                return rid
        return None

    def _count_route_fault(self, _attempt, _exc, _delay):
        self._counts["route_faults"] += 1
        _metrics.count("fleet.route_faults")

    # -- submission ----------------------------------------------------------

    def submit(self, config, priority=0, deadline_s=None):
        """Admit one request into the fleet; returns a `FleetRequest`.

        Brownout rung 1 and all-replicas-shed both complete the handle
        immediately with ``status == "shed"`` and an actionable
        ``retry_after_s`` — the fleet door never blocks a client."""
        now = self._clock()
        freq = FleetRequest(
            config, priority=priority, deadline_s=deadline_s,
            clock=self._clock,
        )
        self._counts["requests"] += 1
        _metrics.count("fleet.requests")
        if (
            self._brownout_level >= 1
            and priority < self.brownout_min_priority
        ):
            self._counts["brownout_sheds"] += 1
            self._counts["shed"] += 1
            _metrics.count("fleet.brownout_sheds")
            _trace.instant("fleet.brownout_shed", cat="fleet",
                           request_id=freq.req_id)
            freq._complete(
                RequestResult(
                    STATUS_SHED, shed_reason="brownout",
                    retry_after_s=self._brownout_retry_hint(),
                ),
                now,
            )
            return freq
        if (
            self.hbm_budget_bytes is not None
            and self.projected_fleet_bytes(off0=freq.config.off0)
            > self.hbm_budget_bytes
        ):
            # fleet-wide admission cost cap: the serving-time analogue
            # of the streamed executors' budgeted sizing, priced
            # by the plan compiler's serve block
            self._counts["hbm_sheds"] += 1
            self._counts["shed"] += 1
            _metrics.count("fleet.hbm_sheds")
            _trace.instant("fleet.hbm_shed", cat="fleet",
                           request_id=freq.req_id)
            freq._complete(
                RequestResult(
                    STATUS_SHED, shed_reason="hbm",
                    retry_after_s=self._brownout_retry_hint(),
                ),
                now,
            )
            return freq
        entry = _Entry(freq)
        self._route_and_send(entry, now)
        if not freq.done:
            with self._lock:
                self._pending[freq.req_id] = entry
        return freq

    def _route_and_send(self, entry, now):
        """Offer one request to replicas in routing order until one
        admits it. Exhaustion sheds a fresh submission (backpressure at
        the fleet door) but only DEFERS an already-admitted request —
        failover never drops admitted work."""
        freq = entry.freq
        tried = set(entry.shed_rids)
        while True:
            rid = self._pick(freq.config.off0, tried, now)
            if rid is None:
                break
            tried.add(rid)
            replica = self._replicas.get(rid)
            if replica is None:  # retired between pick and send
                continue
            deadline_s = (
                None if freq.deadline_t is None
                else max(0.0, freq.deadline_t - self._clock())
            )
            sub = replica.service.submit(
                freq.config, priority=freq.priority,
                deadline_s=deadline_s,
            )
            freq.replica_trail.append(rid)
            res = sub.result
            if res is not None and res.status == STATUS_SHED:
                entry.shed_rids.add(rid)
                if res.retry_after_s is not None:
                    entry.shed_hints.append(res.retry_after_s)
                continue
            if res is not None and not res.ok:
                # expired at a replica door: terminal, surface it
                self._finish(entry, res, rid, False, now)
                return
            entry.subs.append((rid, sub, False))
            entry.admitted = True
            entry.shed_rids.clear()
            return
        hint = min(entry.shed_hints) if entry.shed_hints else 0.05
        if not entry.admitted:
            self._counts["shed"] += 1
            _metrics.count("fleet.shed")
            freq._complete(
                RequestResult(
                    STATUS_SHED, shed_reason="fleet",
                    retry_after_s=hint,
                ),
                now,
            )
            return
        # admitted work: defer with the jittered backoff ladder
        delay = max(
            hint,
            backoff_delay(
                entry.reroutes, base_s=self.failover_backoff_s,
                max_s=self.failover_backoff_max_s,
            ),
        )
        entry.reroutes += 1
        self._counts["reroutes"] += 1
        _metrics.count("fleet.reroutes")
        entry.not_before = now + delay
        entry.shed_rids.clear()

    # -- supervision ---------------------------------------------------------

    def tick(self, now=None):
        """One supervision pass: grade health (failing over revoked
        replicas), settle completed sends, re-route abandoned ones,
        hedge laggards, update the brownout ladder. The supervisor
        thread calls this every ``supervise_interval_s``; tests call it
        directly with an explicit ``now``.

        The tower samples every windowed signal ONCE per pass and that
        sample is what the brownout ladder and the autoscaler both
        consume — one clock, one value, no consumer-private
        recomputation (decisions stay bit-identical to when each read
        the raw signal itself, because the sample IS that read)."""
        now = self._clock() if now is None else now
        for rid, _frm, to in self.monitor.check(now):
            if to == REVOKED:
                self._on_revoked(rid, now)
        with self._lock:
            entries = list(self._pending.values())
        for entry in entries:
            self._scan_entry(entry, now)
        sample = self.tower.tick(now)
        self._update_brownout(now, sample)
        self._finalize_drains(now)
        if self.autoscaler is not None:
            try:
                self.autoscaler.tick(now, signals=sample)
            except Exception:  # noqa: BLE001 - policy must not kill ticks
                _metrics.count("fleet.autoscaler_errors")
                log.exception("autoscaler tick failed")

    def _on_revoked(self, rid, now):
        """A replica's lease was revoked: trip its breaker and strand
        its queue (the ledger scan re-routes every abandoned request)."""
        replica = self._replicas.get(rid)
        if replica is None:  # retired while the transition was in flight
            return
        replica.breaker.trip(now, reason="health lease revoked")
        stranded = replica.service.queue.drain()
        _metrics.count("fleet.revocations")
        _trace.instant("fleet.replica_revoked", cat="fleet",
                       replica=rid, stranded=len(stranded))
        _degrade.record(
            "fleet", "replica_revoked",
            f"replica {rid}: lease revoked, {len(stranded)} queued "
            f"request(s) stranded for failover",
        )
        log.warning(
            "replica %d revoked; failing over %d stranded request(s)",
            rid, len(stranded),
        )

    def _scan_entry(self, entry, now):
        freq = entry.freq
        if freq.done:
            with self._lock:
                self._pending.pop(freq.req_id, None)
            return
        if freq.deadline_t is not None and now > freq.deadline_t:
            self._finish(
                entry, RequestResult(STATUS_EXPIRED, error="deadline"),
                None, False, now,
            )
            return
        still = []
        needs_reroute = False
        for rid, sub, is_hedge in entry.subs:
            res = sub.result
            if res is not None:
                if res.ok:
                    self._finish(entry, res, rid, is_hedge, now)
                    return
                if res.status == STATUS_SHED:
                    entry.shed_rids.add(rid)
                    if res.retry_after_s is not None:
                        entry.shed_hints.append(res.retry_after_s)
                    needs_reroute = True
                    continue
                # expired / quarantined: terminal, surface truthfully
                self._finish(entry, res, rid, is_hedge, now)
                return
            replica = self._replicas.get(rid)
            if replica is None or replica.dead or replica.lease.revoked:
                # in-flight on a dead (or retired) replica: abandoned —
                # failover
                self._counts["failovers"] += 1
                _metrics.count("fleet.failover")
                if replica is not None:
                    replica.breaker.record_failure(
                        now, reason="request abandoned by dead replica"
                    )
                _trace.instant("fleet.failover", cat="fleet",
                               request_id=freq.req_id, replica=rid)
                needs_reroute = True
                continue
            still.append((rid, sub, is_hedge))
        entry.subs = still
        if not still:
            if needs_reroute or now >= entry.not_before:
                if now >= entry.not_before:
                    self._route_and_send(entry, now)
            return
        self._maybe_hedge(entry, now)

    def _finish(self, entry, result, rid, is_hedge, now):
        won = entry.freq._complete(result, now)
        with self._lock:
            self._pending.pop(entry.freq.req_id, None)
        if not won:
            return
        status = result.status
        if status == STATUS_OK:
            self._counts["served"] += 1
            _metrics.count("fleet.served")
            if rid is not None:
                winner = self._replicas.get(rid)
                if winner is not None:
                    winner.breaker.record_success(now)
            if is_hedge:
                self._counts["hedge_wins"] += 1
                _metrics.count("fleet.hedge_wins")
            self._observe_latency(result.latency_s)
        elif status == STATUS_SHED:
            self._counts["shed"] += 1
            _metrics.count("fleet.shed")
        elif status == STATUS_EXPIRED:
            self._counts["expired"] += 1
            _metrics.count("fleet.expired")
        else:
            self._counts["quarantined"] += 1
            _metrics.count("fleet.quarantined")

    # -- hedging -------------------------------------------------------------

    def _observe_latency(self, latency_s):
        if len(self._lat) < _LAT_RING:
            self._lat.append(latency_s)
        else:
            self._lat[self._lat_i] = latency_s
            self._lat_i = (self._lat_i + 1) % _LAT_RING
        self._p99_dirty += 1

    def _rolling_p99(self):
        if self._p99_dirty >= 32 or (self._p99_cache == 0.0 and self._lat):
            lat = sorted(self._lat)
            self._p99_cache = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
            self._p99_dirty = 0
        return self._p99_cache

    def _hedge_budget(self):
        if self.hedge_budget_s is not None:
            return self.hedge_budget_s
        if len(self._lat) < 32:
            # too few samples for a trustworthy p99: a cold estimate
            # under-prices the budget and hedges the whole backlog
            return float("inf")
        return max(self.hedge_min_s,
                   self.hedge_factor * self._rolling_p99())

    def _maybe_hedge(self, entry, now):
        budget = self._hedge_budget()
        if budget <= 0 or entry.hedged or len(entry.subs) != 1:
            return
        if now - entry.freq.submit_t <= budget:
            return
        rid0 = entry.subs[0][0]
        rid = self._pick(entry.freq.config.off0, {rid0}, now)
        if rid is None:
            return
        replica = self._replicas.get(rid)
        if replica is None:  # retired between pick and send
            return
        deadline_s = (
            None if entry.freq.deadline_t is None
            else max(0.0, entry.freq.deadline_t - self._clock())
        )
        sub = replica.service.submit(
            entry.freq.config, priority=entry.freq.priority,
            deadline_s=deadline_s,
        )
        entry.freq.replica_trail.append(rid)
        entry.hedged = True
        if sub.result is not None and sub.result.status == STATUS_SHED:
            return  # the hedge was shed; the primary still stands
        entry.subs.append((rid, sub, True))
        self._counts["hedges"] += 1
        _metrics.count("fleet.hedges")
        _trace.instant("fleet.hedge", cat="fleet",
                       request_id=entry.freq.req_id, replica=rid)

    # -- brownout ------------------------------------------------------------

    def queue_share(self, window=256):
        """Recent fleet-wide queue-wait share of request latency (the
        request-journey decomposition aggregated over replicas) — the
        brownout trigger signal."""
        total_q = total = 0.0
        for replica in list(self._replicas.values()):
            q, t = replica.service.recent_journey_totals(window)
            total_q += q
            total += t
        return (total_q / total) if total else 0.0

    def queued_depth(self):
        return sum(
            len(r.service.queue)
            for r in list(self._replicas.values())
        )

    def projected_fleet_bytes(self, off0=None):
        """Projected device cost of everything pending fleet-wide,
        priced by the plan compiler's admission model: pending requests
        x ``request_bytes`` plus each replica's distinct pending
        columns x ``column_bytes``. ``off0`` adds the cost of one more
        request for that column (the admission probe)."""
        total = 0
        extra_col = off0 is not None
        for replica in list(self._replicas.values()):
            if replica.dead or replica.lease.revoked:
                continue
            cols = replica.service.queue.columns()
            total += sum(c.count for c in cols) * self.request_bytes
            total += len(cols) * self.column_bytes
            if extra_col and any(c.off0 == off0 for c in cols):
                extra_col = False  # column already priced somewhere
        if off0 is not None:
            total += self.request_bytes
            if extra_col:
                total += self.column_bytes
        return total

    def _brownout_retry_hint(self):
        hints = [
            r.service.queue.retry_after_hint()
            for r in list(self._replicas.values())
        ]
        return min(hints) if hints else 0.05

    def _set_brownout(self, level, now, share):
        prev = self._brownout_level
        if level == prev:
            return
        self._brownout_level = level
        self._brownout_since = now
        if len(self._brownout_events) < 256:
            self._brownout_events.append(
                {"t": round(now, 6), "from": prev, "to": level,
                 "queue_share": round(share, 4)}
            )
        action = f"brownout_level_{level}"
        _metrics.count(f"fleet.{action}")
        _degrade.record(
            "fleet", action,
            f"queue share {share:.3f} vs threshold "
            f"{self.brownout_share:.3f}",
        )
        if level >= 2 and prev < 2:
            # rung 2: per-request dispatch — coalesced batches stop
            # head-of-line-blocking the high-priority traffic that
            # survived rung 1's shed
            for rid, replica in list(self._replicas.items()):
                self._saved_max_batch[rid] = (
                    replica.service.scheduler.max_batch
                )
                replica.service.scheduler.max_batch = 1
        elif level < 2 and prev >= 2:
            for rid, saved in self._saved_max_batch.items():
                self._replicas[rid].service.scheduler.max_batch = saved
            self._saved_max_batch.clear()

    def _update_brownout(self, now, sample=None):
        if sample is not None and "fleet.queue_share" in sample:
            share = sample["fleet.queue_share"]
            depth = int(sample.get("fleet.queued_depth", 0))
        else:
            share = self.queue_share()
            depth = self.queued_depth()
        overloaded = (
            share > self.brownout_share
            and depth >= self.brownout_min_depth
        )
        level = self._brownout_level
        if overloaded:
            if level == 0:
                self._set_brownout(1, now, share)
            elif (
                level == 1
                and now - self._brownout_since > self.brownout_escalate_s
            ):
                self._set_brownout(2, now, share)
        elif level and (
            share < 0.8 * self.brownout_share
            or depth < max(1, self.brownout_min_depth // 2)
        ):
            # hysteresis: step DOWN one rung at a time
            self._set_brownout(level - 1, now, share)

    @property
    def brownout_level(self):
        return self._brownout_level

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        """Start every replica pump plus the supervisor thread."""
        for replica in list(self._replicas.values()):
            replica.start()
        self._sup_stop = False
        trace_ctx = _trace.current()
        self._sup_thread = threading.Thread(
            target=self._sup_run, args=(trace_ctx,),
            name="fleet-supervisor", daemon=True,
        )
        self._sup_thread.start()
        return self

    def _sup_run(self, trace_ctx=0):
        _trace.adopt(trace_ctx)
        _trace.name_track(threading.get_native_id(), "fleet-supervisor")
        while not self._sup_stop:
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - supervisor must survive
                _metrics.count("fleet.supervisor_errors")
                log.exception("fleet supervisor tick failed")
            time.sleep(self.supervise_interval_s)

    def drain(self, timeout=None):
        """Block until no fleet request is pending (the supervisor —
        thread or caller-driven ticks — completes them); returns True
        when drained, False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                if not self._pending:
                    return True
            if self._sup_thread is None:
                self.tick()
            if deadline is not None and time.monotonic() > deadline:
                with self._lock:
                    return not self._pending
            time.sleep(0.002)

    def post_facet_update(self, engine, new_facet_tasks, **update_kw):
        """Fleet-wide incremental facet update: run the
        `delta.IncrementalForward` update ONCE (one delta stream + one
        cache patch, or its degradation ladder), then propagate the
        patched feed, the new stream version AND the new facet stack to
        every replica's service. Replica pumps keep serving while the
        engine patches: the spill cache is marked mid-patch for the
        whole rewrite window (`utils.spill.SpillCache.begin_patch`), so
        a live feed's lookups raise and requests fall back to compute
        at the version they were admitted under — a partially-patched
        row can never serve. Each replica then drains its own in-flight
        requests before adopting the feed and rebuilding its forward
        over the new stack, so version pinning holds per replica; there
        is no fleet-wide stop-the-world and no cache flush.
        """
        report = engine.update(new_facet_tasks, **update_kw)
        if self.fabric is not None:
            # ONE fabric roll: the shared L2 adopts the engine's new
            # stream version (index rebuilt only on replay), every
            # replica view is re-pointed in place and its hot-row L1
            # cleared iff the version moved — no per-replica re-record
            # and still exactly one resident stream copy
            self.fabric.roll(report)
            for rid, replica in sorted(self.replicas.items()):
                replica.service.post_facet_update(
                    report=report, feed=self.fabric.view(rid),
                    new_facet_tasks=engine.facet_tasks,
                )
        else:
            for replica in list(self._replicas.values()):
                # a fresh feed per replica: feeds carry per-feed
                # stale/hit state and the captured version, so replicas
                # must not share one object — and each replica adopts
                # the new stack into ITS OWN forward (forwards are
                # per-pump-thread state)
                replica.service.post_facet_update(
                    report=report, feed=engine.feed(),
                    new_facet_tasks=engine.facet_tasks,
                )
        self._counts["facet_updates"] = (
            self._counts.get("facet_updates", 0) + 1
        )
        _metrics.count("fleet.facet_updates")
        _trace.instant(
            "fleet.facet_update", cat="fleet",
            stream_version=report.get("stream_version"),
            mode=report.get("mode"),
        )
        return report

    # -- elasticity ----------------------------------------------------------

    def add_replica(self):
        """Scale out: one more replica from the stored factory and
        tuning, pump started iff the fleet is running. With a cache
        fabric attached the newcomer's service is built over a feed
        VIEW of the one resident stream — scale-out costs an L1, never
        a stream copy. Returns the new rid."""
        replica = self._build_replica()
        if self._sup_thread is not None:
            replica.start()
        self._counts["scale_outs"] += 1
        _metrics.count("fleet.scale_outs")
        _trace.instant("fleet.scale_out", cat="fleet",
                       replica=replica.rid)
        log.info("scale-out: replica %d joins (%d replicas)",
                 replica.rid, len(self._replicas))
        return replica.rid

    def begin_drain(self, rid):
        """Initiate zero-loss scale-in for one replica: routing stops
        immediately (`_routable`), its queued and in-flight work
        completes (or fails over), and a later supervision pass retires
        the pump (`_finalize_drains`). Non-blocking and idempotent —
        the autoscaler calls this from inside the supervisor tick."""
        with self._lock:
            if rid not in self._replicas:
                raise KeyError(f"no replica {rid}")
            if rid in self._draining:
                return
            self._draining[rid] = self._clock()
        _metrics.count("fleet.drains_begun")
        _trace.instant("fleet.drain_begin", cat="fleet", replica=rid)
        log.info("drain: replica %d stops taking traffic", rid)

    def _inflight_on(self, rid):
        """Pending fleet requests with a live sub on this replica — a
        racy snapshot; the drain path re-checks every pass."""
        with self._lock:
            entries = list(self._pending.values())
        return sum(
            1
            for entry in entries
            for sub_rid, _sub, _hedge in list(entry.subs)
            if sub_rid == rid
        )

    def _finalize_drains(self, now):
        """Retire draining replicas whose work is gone; force the
        failover path on laggards past ``drain_timeout_s`` so scale-in
        can never wedge the fleet (the requests still complete
        elsewhere — zero loss, slower)."""
        with self._lock:
            items = list(self._draining.items())
        for rid, since in items:
            replica = self._replicas.get(rid)
            if replica is None:
                with self._lock:
                    self._draining.pop(rid, None)
                continue
            if replica.dead or replica.lease.revoked:
                # the health path already failed its work over
                self._retire(rid, reason="dead_during_drain")
                continue
            if (
                len(replica.service.queue) == 0
                and self._inflight_on(rid) == 0
            ):
                self._retire(rid, reason="drained")
                continue
            if now - since > self.drain_timeout_s:
                log.warning(
                    "drain of replica %d exceeded %.1fs; forcing "
                    "failover", rid, self.drain_timeout_s,
                )
                _metrics.count("fleet.drains_forced")
                _recorder.record("fleet", "fleet.drain_forced",
                                 f"replica {rid} past "
                                 f"{self.drain_timeout_s:.1f}s")
                if _recorder.enabled():
                    # a forced drain is a post-mortem trigger: snapshot
                    # the black box for the drill artifact to stamp
                    self.last_post_mortem = _recorder.post_mortem(
                        "forced_drain", reason=f"replica {rid}"
                    )
                # revoke the lease: the monitor's next pass strands the
                # queue and the ledger scan re-routes every sub
                replica.lease.revoke()

    def _retire(self, rid, reason="drained"):
        """Remove one replica from the fleet: pump stopped, lease
        unregistered (so its silence can't fire a phantom failover),
        fabric view dropped, final serving counters kept in the
        retired ledger."""
        with self._lock:
            replica = self._replicas.pop(rid, None)
            self._draining.pop(rid, None)
        if replica is None:
            return
        replica.stop(timeout=2.0)
        self.monitor.unregister(rid)
        self.tower.unregister_source(f"replica-{rid}")
        if self.fabric is not None:
            self.fabric.drop_view(rid)
        s = replica.service.stats()
        self._retired.append({
            "id": rid, "reason": reason,
            "served": s["n_served"], "requests": s["n_requests"],
            "shed": s["n_shed"],
        })
        self._counts["drains"] += 1
        _metrics.count("fleet.drains")
        _trace.instant("fleet.replica_retired", cat="fleet",
                       replica=rid, reason=reason)
        _recorder.record("fleet", "fleet.replica_retired",
                         f"replica {rid}: {reason}")
        log.info("drain: replica %d retired (%s; %d replicas left)",
                 rid, reason, len(self._replicas))

    def drain_replica(self, rid, timeout=None):
        """Blocking convenience over `begin_drain`: returns True once
        the replica is retired, False on timeout. Drives supervision
        itself when no supervisor thread is running."""
        self.begin_drain(rid)
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        while True:
            with self._lock:
                if rid not in self._replicas:
                    return True
            if self._sup_thread is None:
                self.tick()
            if deadline is not None and time.monotonic() > deadline:
                with self._lock:
                    return rid not in self._replicas
            time.sleep(0.002)

    def kill_replica(self, rid):
        """Drill hook: simulated chip death for one replica."""
        self._replicas[rid].kill()

    def restore_replica(self, rid):
        """Bring a dead replica back: fresh pump thread over its warm
        service state, lease revived. Its breaker is deliberately NOT
        reset — half-open probe traffic is what re-earns trust."""
        replica = self._replicas[rid]
        replica.restore()
        self.monitor.revive(rid)
        self._counts["restores"] += 1
        _metrics.count("fleet.restores")
        _trace.instant("fleet.replica_restored", cat="fleet",
                       replica=rid)
        _recorder.record("fleet", "fleet.replica_restored",
                         f"replica {rid}")
        return replica

    def stop(self, timeout=10.0):
        """Stop the supervisor and every replica pump (drain first if
        in-flight work matters)."""
        self._sup_stop = True
        if self._sup_thread is not None:
            self._sup_thread.join(timeout)
            self._sup_thread = None
        for replica in list(self._replicas.values()):
            replica.stop(timeout)

    # -- export --------------------------------------------------------------

    def stats(self, wall_s=None):
        """JSON-ready fleet block (a fleet record's ``fleet`` block):
        counters, rolling latency quantiles, per-replica serving stats
        (+ QPS when ``wall_s`` is given), breaker/health transition
        trails, and the brownout ledger."""
        lat = sorted(self._lat)

        def q(p):
            if not lat:
                return 0.0
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        per_replica = []
        for rid, replica in sorted(self.replicas.items()):
            s = replica.service.stats()
            row = {
                "id": rid,
                "dead": replica.dead,
                "alive": replica.alive(),
                "lease_state": replica.lease.state(),
                "breaker_state": replica.breaker.state,
                "served": s["n_served"],
                "requests": s["n_requests"],
                "shed": s["n_shed"],
                "p99_ms": s["p99_ms"],
            }
            if wall_s:
                row["qps"] = round(s["n_served"] / wall_s, 2)
            per_replica.append(row)
        with self._lock:
            pending = len(self._pending)
            draining = sorted(self._draining)
            retired = list(self._retired)
        out = {
            "n_replicas": len(self._replicas),
            # with a fabric every replica serves a VIEW over the one
            # recorded stream; without one, each factory-built service
            # owns whatever feed it was given
            "stream_copies": (
                1 if self.fabric is not None else len(self._replicas)
            ),
            "draining": draining,
            "retired": retired,
            **{k: v for k, v in self._counts.items()},
            "pending": pending,
            "p50_ms": round(q(0.50) * 1e3, 3),
            "p99_ms": round(q(0.99) * 1e3, 3),
            "queue_share": round(self.queue_share(), 4),
            "brownout": {
                "level": self._brownout_level,
                "sheds": self._counts["brownout_sheds"],
                "events": list(self._brownout_events),
            },
            "admission": {
                "hbm_budget_bytes": self.hbm_budget_bytes,
                "request_bytes": self.request_bytes,
                "column_bytes": self.column_bytes,
                "hbm_sheds": self._counts["hbm_sheds"],
                "projected_bytes": self.projected_fleet_bytes(),
            },
            "breakers": {
                str(rid): r.breaker.stats()
                for rid, r in sorted(self.replicas.items())
            },
            "health": self.monitor.stats(),
            "per_replica": per_replica,
        }
        if self.autoscaler is not None:
            out["autoscale"] = self.autoscaler.stats()
        return out
