"""Shared transient-failure retry: jittered exponential backoff plus
transient-vs-fatal classification.

The port of the JAX package's ``swiftly_tpu/resilience/retry.py``.
`retry_transient` is the one wrapper the spill cache, the host-device
transfers and the checkpoints retry through:

* **Classification first.** Only transiently-classified errors retry
  (`is_transient`): OS-level I/O errors, timeouts, and runtime errors
  whose text carries a transient status code (``RESOURCE_EXHAUSTED``,
  ``UNAVAILABLE``, ...). Deterministic errors (a shape mismatch, a config
  error) re-raise at once. **CUDA runtime errors never retry**
  (`is_cuda_error`): an illegal address or a launch failure is sticky in
  the CUDA context, so a retry could only hide a kernel fault, and a
  CUDA out-of-memory error goes to the OOM ladders (`is_oom`), not to a
  blind repeat. `faults.WorkerKilled` is a ``BaseException`` and never
  enters the handler at all.
* **Jittered exponential backoff.** Delay ``min(max_s, base_s * 2^k)``
  scaled by a uniform [0.5, 1.0) jitter.
* **Accounted.** ``retry.attempts`` / ``retry.attempts.<site>`` count
  every retry, ``retry.recovered`` the calls that succeeded after one,
  ``retry.exhausted`` the ones that ran out of attempts (via
  `obs.metrics`, zero-cost when disabled).

``SWIFTLY_RETRY_MAX`` (default 3) caps retry attempts process-wide.
"""

from __future__ import annotations

import os
import random
import time

from ..obs import metrics as _metrics

__all__ = [
    "OOM_MARKERS",
    "TRANSIENT_MARKERS",
    "backoff_delay",
    "is_cuda_error",
    "is_oom",
    "is_transient",
    "max_retry_attempts",
    "retry_transient",
]

# Runtime status codes that mark a failure worth retrying when they
# appear in an exception's text (runtimes surface these as RuntimeError
# strings, not typed exceptions).
TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "ABORTED",
    "CANCELLED",
    "temporarily unavailable",
)

# Allocator-failure markers (an OOM may surface as RuntimeError text: the
# injected ``RESOURCE_EXHAUSTED``, PyTorch's "CUDA out of memory").
# Shared by every OOM ladder: one rule instead of private forks.
OOM_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory")

# Text of the errors the CUDA runtime, its libraries and PyTorch's CUDA
# layer raise as RuntimeError: "CUDA error: an illegal memory access was
# encountered", "CUDA out of memory", "CUBLAS_STATUS_EXECUTION_FAILED",
# "CUDA driver error", "cuDNN error".
CUDA_ERROR_MARKERS = (
    "CUDA error",
    "CUDA out of memory",
    "CUDA driver error",
    "CUBLAS_STATUS_",
    "CUFFT_",
    "cuDNN error",
    "CUDA kernel errors",
)

_rng = random.Random()


def max_retry_attempts(default=3):
    """Process-wide retry cap (``SWIFTLY_RETRY_MAX``, default 3)."""
    try:
        return max(0, int(os.environ.get("SWIFTLY_RETRY_MAX", default)))
    except ValueError:
        return default


def _cuda_error_types():
    """PyTorch's typed CUDA errors present in this build."""
    import torch

    types = [torch.cuda.OutOfMemoryError]
    acc = getattr(torch, "AcceleratorError", None)
    if isinstance(acc, type):
        types.append(acc)
    return tuple(types)


def is_cuda_error(exc) -> bool:
    """Is this an error of the CUDA runtime, its libraries or PyTorch's
    CUDA layer (typed, or a RuntimeError whose text says so)?"""
    if isinstance(exc, _cuda_error_types()):
        return True
    if not isinstance(exc, RuntimeError):
        return False
    text = str(exc)
    return any(marker in text for marker in CUDA_ERROR_MARKERS)


def is_transient(exc) -> bool:
    """Worth retrying? OS-level I/O failures and timeouts are; anything
    whose message carries a transient runtime status code is; CUDA runtime
    errors (`is_cuda_error`) and other deterministic errors are not."""
    if is_cuda_error(exc):
        return False
    if isinstance(exc, (OSError, TimeoutError, ConnectionError)):
        return True
    text = f"{type(exc).__name__}: {exc}"
    return any(marker in text for marker in TRANSIENT_MARKERS)


def is_oom(exc) -> bool:
    """Is this an allocator failure (device or host out-of-memory)?

    The one classifier behind every OOM degradation ladder: a Python
    ``MemoryError``, PyTorch's ``torch.cuda.OutOfMemoryError``, or an
    exception whose type or message carries an ``OOM_MARKERS`` entry
    (``RESOURCE_EXHAUSTED``, "CUDA out of memory").
    """
    import torch

    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    text = f"{type(exc).__name__}: {exc}"
    lower = text.lower()
    return any(
        m in text or m.lower() in lower for m in OOM_MARKERS
    )


def backoff_delay(attempt, base_s=0.05, max_s=2.0, rng=None):
    """Jittered exponential delay for retry number `attempt` (0-based)."""
    r = (rng or _rng).random()
    return min(max_s, base_s * (2.0 ** attempt)) * (0.5 + 0.5 * r)


def retry_transient(fn, site="", max_attempts=None, base_s=0.05,
                    max_s=2.0, classify=is_transient, sleep=time.sleep,
                    rng=None, on_retry=None):
    """Call ``fn()``; retry transiently-classified failures with jittered
    exponential backoff. Returns ``fn()``'s value or re-raises the last
    error (fatal errors re-raise immediately, unretried).

    :param site: metrics label (``retry.attempts.<site>``)
    :param max_attempts: retry cap (default ``SWIFTLY_RETRY_MAX``)
    :param classify: predicate deciding retryability (`is_transient`)
    :param sleep: injectable for tests (receives the delay in seconds)
    :param on_retry: optional ``fn(attempt, exc, delay_s)`` observer
    """
    attempts = (
        max_retry_attempts() if max_attempts is None else int(max_attempts)
    )
    for attempt in range(attempts + 1):
        try:
            out = fn()
        except Exception as exc:
            if not classify(exc):
                raise
            if attempt >= attempts:
                _metrics.count("retry.exhausted")
                if site:
                    _metrics.count(f"retry.exhausted.{site}")
                raise
            _metrics.count("retry.attempts")
            if site:
                _metrics.count(f"retry.attempts.{site}")
            delay = backoff_delay(attempt, base_s, max_s, rng)
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            _metrics.event("retry", site=site, attempt=attempt,
                           error=f"{type(exc).__name__}: {exc}",
                           delay_s=round(delay, 4))
            sleep(delay)
        else:
            if attempt:
                _metrics.count("retry.recovered")
                if site:
                    _metrics.count(f"retry.recovered.{site}")
            return out
    raise AssertionError("unreachable")  # pragma: no cover
