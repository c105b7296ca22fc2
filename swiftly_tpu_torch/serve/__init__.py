"""On-demand serving: the admission queue and the coalescing scheduler (the
port of the JAX package's ``swiftly_tpu.serve`` queue and scheduler, with
the plan's admission byte projections; ``SubgridService``, health,
autoscale and the fleets are ROADMAP A12)."""

from ..plan.model import projected_column_bytes, projected_request_bytes

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

__all__ = [
    "AdmissionQueue",
    "CoalescingScheduler",
    "RequestResult",
    "STATUS_EXPIRED",
    "STATUS_OK",
    "STATUS_QUARANTINED",
    "STATUS_SHED",
    "SubgridRequest",
    "bucket_shape",
    "projected_column_bytes",
    "projected_request_bytes",
]
