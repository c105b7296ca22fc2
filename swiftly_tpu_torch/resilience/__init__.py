"""Resilient execution: fault injection, retry/backoff, degradation.

The port of the JAX package's ``swiftly_tpu/resilience/``. Long streamed
transforms treat worker and I/O failure as an expected event; this
package is the discipline layer:

* ``resilience.faults``: the deterministic, seedable `FaultPlan` hooking
  named sites (spill I/O, host-device transfers, checkpoint save and
  restore, the backward's feed); a no-op when no plan is installed.
* ``resilience.retry``: the shared `retry_transient` wrapper: transient
  vs fatal classification (CUDA runtime errors are never transient) and
  jittered exponential backoff, counted as ``retry.*`` metrics; `is_oom`
  is the one allocator-failure classifier.
* ``resilience.breaker``: the per-dependency `CircuitBreaker` (closed ->
  open on consecutive failures, half-open probes, escalating reopen).
* ``resilience.degrade``: the degradation ledger every ladder step
  (spill disk -> RAM -> forward replay; corrupt checkpoint -> previous
  generation) records into.
* ``resilience.watchdog``: the stalled-collective watchdog
  (``SWIFTLY_COLLECTIVE_TIMEOUT_S``).

Hardened checkpointing (atomic tmp + fsync + rename writes, per-array
CRC32, keep-N generations with fallback) lives in `utils.checkpoint`.
"""

from . import degrade
from .breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from .faults import (
    FaultError,
    FaultPlan,
    InjectedResourceExhausted,
    ShardLostError,
    WorkerKilled,
    active,
    fault_point,
    install,
    plan_from_env,
    uninstall,
)
from .retry import backoff_delay, is_oom, is_transient, retry_transient
from .watchdog import (
    CollectiveStalledError,
    collective_timeout_s,
    watch_collective,
)

__all__ = [
    "CLOSED",
    "CircuitBreaker",
    "CollectiveStalledError",
    "FaultError",
    "FaultPlan",
    "HALF_OPEN",
    "InjectedResourceExhausted",
    "OPEN",
    "ShardLostError",
    "WorkerKilled",
    "active",
    "backoff_delay",
    "collective_timeout_s",
    "degrade",
    "fault_point",
    "install",
    "is_oom",
    "is_transient",
    "plan_from_env",
    "retry_transient",
    "uninstall",
    "watch_collective",
]
