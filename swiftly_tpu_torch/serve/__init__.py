"""On-demand subgrid serving: queue, scheduler, service, health, fleet.

The port of the JAX package's ``swiftly_tpu.serve``, in-process half:

* `serve.queue.AdmissionQueue` — bounded admission with backpressure
  (depth cap plus the plan's projected device-memory cost);
* `serve.scheduler.CoalescingScheduler` — groups pending requests by
  subgrid column so one stacked column program serves them;
* `serve.service.SubgridService` — the long-lived server over a prepared
  `SwiftlyForward` (+ optional recorded-stream cache feed): timeouts,
  batch isolation, quarantine, facet updates, SLO metrics;
* `serve.health` — heartbeat `HealthLease` per replica and the
  `HealthMonitor` that grades them (live → suspect → revoked);
* `serve.fleet.ServeFleet` — N supervised service replicas (threads on
  one card) behind a rendezvous-hashed column router with circuit
  breakers, zero-loss failover, brownout and hedged sends; attach a
  `cache.SharedStreamTier` and they serve L1 views over one recorded
  stream;
* `serve.autoscale.FleetAutoscaler` — queue-share-driven replica count.

Not ported yet: the process fleet (``ProcessFleet``,
``SharedSpillReader``, ``make_worker_spec``).
"""

from ..plan.model import projected_column_bytes, projected_request_bytes

from .autoscale import FleetAutoscaler
from .fleet import FleetRequest, Replica, ServeFleet
from .health import LIVE, REVOKED, SUSPECT, HealthLease, HealthMonitor
from .queue import (
    STATUS_EXPIRED,
    STATUS_OK,
    STATUS_QUARANTINED,
    STATUS_SHED,
    AdmissionQueue,
    RequestResult,
    SubgridRequest,
)
from .scheduler import CoalescingScheduler, bucket_shape
from .service import SubgridService

__all__ = [
    "AdmissionQueue",
    "CoalescingScheduler",
    "FleetAutoscaler",
    "FleetRequest",
    "HealthLease",
    "HealthMonitor",
    "LIVE",
    "Replica",
    "RequestResult",
    "REVOKED",
    "ServeFleet",
    "SubgridRequest",
    "SubgridService",
    "SUSPECT",
    "STATUS_EXPIRED",
    "STATUS_OK",
    "STATUS_QUARANTINED",
    "STATUS_SHED",
    "bucket_shape",
    "projected_column_bytes",
    "projected_request_bytes",
]
