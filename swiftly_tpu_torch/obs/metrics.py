"""Per-stage metrics registry: counters, gauges, stage timers.

The port of the JAX package's ``swiftly_tpu/obs/metrics.py``. Design
constraints, in order:

1. **Zero cost off.** The executors' loops call ``metrics.stage(...)``
   per launch group; disabled (the default) that is one attribute check
   and the return of a shared no-op context manager: no allocation, no
   clock read, no string work.
2. **One stage vocabulary.** Enabled, each stage timer also opens a
   ``torch.profiler.record_function`` of the same name and, when the
   registry was enabled for a CUDA device, an NVTX range
   (``torch.cuda.nvtx.range_push`` / ``range_pop``), so the host-side
   walls in ``export()``, a PyTorch profiler trace and an Nsight timeline
   index by identical stage names.
3. **Honest attribution.** CUDA launches are asynchronous: a host timer
   around a launch measures launch + backpressure, not device compute.
   Stage timers read the host clock and add no synchronisation (a
   ``torch.cuda.synchronize()`` inside a stage would change the very
   timeline it measures). The executors instrument their completion
   waits (the CUDA events of their in-flight queues) as their own
   ``*.drain`` stages; per-stage MFU (analytic FLOPs from ``utils.flops``
   over host wall) is exact on synchronous backends (the CPU) and a
   launch-side attribution on the card, where the run-level ``total``
   block is meaningful and a profiler trace holds the per-kernel device
   truth.

Stage timing keeps streaming aggregates (count/total/min/max) plus a
bounded sample ring for p99 (capacity 8192; beyond that, samples
overwrite round-robin). All mutation is lock-guarded: worker threads may
record concurrently.
"""

from __future__ import annotations

import json
import os
import threading
import time

from . import recorder as _recorder
from . import trace as _trace

__all__ = [
    "MetricsRegistry",
    "enabled",
    "enable",
    "disable",
    "get_registry",
    "stage",
    "observe",
    "count",
    "gauge",
    "gauge_max",
    "event",
    "export",
    "reset",
]

_P99_RING = 8192  # per-stage sample capacity (see module docstring)


class _NullStage:
    """The shared disabled-path context manager (no state, no work).

    Attribute writes are swallowed so call sites may set
    ``st.flops``/``st.bytes_moved`` inside the block (for values only
    known after the work) without branching on enablement."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __setattr__(self, name, value):
        pass


_NULL_STAGE = _NullStage()


class _StageStats:
    __slots__ = (
        "count", "total_s", "min_s", "max_s", "flops", "bytes_moved",
        "samples", "_ring_i",
    )

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.min_s = float("inf")
        self.max_s = 0.0
        self.flops = 0
        self.bytes_moved = 0
        self.samples = []
        self._ring_i = 0

    def add(self, wall_s, flops, bytes_moved):
        self.count += 1
        self.total_s += wall_s
        if wall_s < self.min_s:
            self.min_s = wall_s
        if wall_s > self.max_s:
            self.max_s = wall_s
        self.flops += flops
        self.bytes_moved += bytes_moved
        if len(self.samples) < _P99_RING:
            self.samples.append(wall_s)
        else:
            self.samples[self._ring_i] = wall_s
            self._ring_i = (self._ring_i + 1) % _P99_RING


def _quantile_sorted(s, q):
    if not s:
        return 0.0
    return s[min(len(s) - 1, int(q * len(s)))]


def _p99(samples):
    return _quantile_sorted(sorted(samples), 0.99)


class _Annotation:
    """The profiler names of one enabled stage: a
    ``torch.profiler.record_function`` range and, with ``nvtx``, an NVTX
    range of the same name (both host-side markers, no synchronisation)."""

    __slots__ = ("_rf", "_nvtx")

    def __init__(self, name, nvtx):
        import torch

        self._rf = torch.profiler.record_function(name)
        self._nvtx = nvtx
        self._rf.__enter__()
        if nvtx:
            torch.cuda.nvtx.range_push(name)

    def close(self, *exc):
        if self._nvtx:
            import torch

            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)


def _resolve_annotation(device=None):
    """The stage's profiler-marker factory for `device` (default: CUDA when
    available): ``name -> _Annotation``, with NVTX on a CUDA device; None
    where torch's profiler is missing."""
    try:
        import torch

        if device is None:
            nvtx = torch.cuda.is_available()
        else:
            nvtx = torch.device(device).type == "cuda"
        torch.profiler.record_function  # noqa: B018 - present in torch
    except Exception:  # pragma: no cover - torch without its profiler
        return None
    return lambda name: _Annotation(name, nvtx)


class _Stage:
    """One enabled stage timing: host wall + profiler-marker pairing.

    Also the metrics→trace bridge: when the span tracer (``obs.trace``)
    is on, each stage opens a trace span of the SAME name, so every
    instrumentation site in the engine feeds both systems with one
    ``with`` block and the Perfetto timeline uses the documented stage
    vocabulary. A stage may run with the registry disabled (tracing
    only) — it then records no registry state."""

    __slots__ = ("_reg", "name", "flops", "bytes_moved", "_t0", "_ann",
                 "_tspan")

    def __init__(self, reg, name, flops, bytes_moved):
        self._reg = reg
        self.name = name
        self.flops = flops
        self.bytes_moved = bytes_moved
        self._ann = None
        self._tspan = None

    def __enter__(self):
        reg = self._reg
        if reg._annotation_cls is not None:
            self._ann = reg._annotation_cls(self.name)
        if _trace._TRACER.enabled:
            self._tspan = _trace.span(self.name, cat="stage")
            self._tspan.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self._t0
        if self._tspan is not None:
            if self.flops:
                self._tspan.set(flops=self.flops)
            if self.bytes_moved:
                self._tspan.set(bytes_moved=self.bytes_moved)
            self._tspan.__exit__(*exc)
        if self._ann is not None:
            self._ann.close(*exc)
        if self._reg.enabled:
            self._reg._record_stage(self.name, wall, self.flops,
                                    self.bytes_moved)
        rec = _recorder._RECORDER
        if rec.enabled:
            rec.record("stage", self.name, round(wall, 6))
        return False


class MetricsRegistry:
    """Counters, gauges and stage timers; a no-op unless enabled.

    One process-wide instance (``get_registry()``) serves the engine;
    independent instances are constructible for tests.
    """

    def __init__(self, enabled=False, jsonl_path=None):
        self._lock = threading.Lock()
        self._annotation_cls = None
        self._jsonl = None
        self._jsonl_path = None
        self._t_epoch = time.time()
        self._t0 = time.perf_counter()
        self.counters = {}
        self.gauges = {}
        self.gauges_max = {}
        self.stages = {}
        self.enabled = False
        if enabled:
            self.enable(jsonl_path)

    # -- lifecycle ---------------------------------------------------------

    def enable(self, jsonl_path=None, device=None):
        """Turn recording on; optionally start a JSONL event log.

        The profiler-marker factory is resolved here (not per stage) so
        enabled-path overhead stays one attribute read: ``device``
        (default: CUDA when available) decides whether stages open NVTX
        ranges beside their ``record_function`` ranges.
        """
        with self._lock:
            self.enabled = True
            self._t_epoch = time.time()
            self._t0 = time.perf_counter()
            if self._annotation_cls is None or device is not None:
                self._annotation_cls = _resolve_annotation(device)
            if jsonl_path:
                self._jsonl_path = str(jsonl_path)
                self._jsonl = open(self._jsonl_path, "a", buffering=1)
                self._emit({"kind": "open", "t_epoch": self._t_epoch})
        return self

    def disable(self):
        """Stop recording and close the event log (state is kept for
        export until ``reset()``)."""
        with self._lock:
            self.enabled = False
            if self._jsonl is not None:
                self._jsonl.close()
                self._jsonl = None

    def reset(self):
        """Drop all recorded state (counters, gauges, stages)."""
        with self._lock:
            self.counters = {}
            self.gauges = {}
            self.gauges_max = {}
            self.stages = {}
            self._t0 = time.perf_counter()
            self._t_epoch = time.time()

    # -- recording ---------------------------------------------------------

    def stage(self, name, flops=0, bytes_moved=0):
        """Context manager timing one stage execution.

        ``flops``/``bytes_moved`` are the dispatch's analytic compute
        and data-movement attribution (accumulated into the stage).
        Disabled this returns a shared no-op object immediately —
        unless the span tracer is on (the stage runs as a trace-only
        span, no registry state) or the flight recorder is on (a
        recorder-only timer appends one ring event).
        """
        if not self.enabled and not _trace._TRACER.enabled:
            if _recorder._RECORDER.enabled:
                return _recorder._RecorderStage(name)
            return _NULL_STAGE
        return _Stage(self, name, flops, bytes_moved)

    def observe(self, name, wall_s, flops=0, bytes_moved=0):
        """Record an externally measured duration into a stage histogram.

        For durations the registry cannot bracket with ``stage(...)`` —
        e.g. a serving request's submit→completion latency, whose span
        crosses queueing, scheduling and dispatch. Lands in the same
        export/quantile machinery as timed stages.
        """
        if not self.enabled:
            return
        self._record_stage(name, wall_s, flops, bytes_moved)

    def count(self, name, n=1):
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name, value):
        if not self.enabled:
            return
        with self._lock:
            self.gauges[name] = value

    def gauge_max(self, name, value):
        """Peak-tracking gauge: keeps the MAX ever recorded, so
        watermark-style gauges (HBM peak, queue-depth high-water)
        survive ``export()`` on long runs instead of reporting
        whatever the last sample happened to be."""
        if not self.enabled:
            return
        with self._lock:
            cur = self.gauges_max.get(name)
            if cur is None or value > cur:
                self.gauges_max[name] = value

    def event(self, kind, **fields):
        """Append a free-form event to the JSONL log (no-op otherwise)."""
        if not self.enabled:
            return
        with self._lock:
            self._emit({"kind": kind, **fields})

    def _record_stage(self, name, wall_s, flops, bytes_moved):
        with self._lock:
            st = self.stages.get(name)
            if st is None:
                st = self.stages[name] = _StageStats()
            st.add(wall_s, flops, bytes_moved)
            self._emit(
                {
                    "kind": "stage",
                    "name": name,
                    "t_s": round(time.perf_counter() - self._t0, 6),
                    "wall_s": round(wall_s, 6),
                    "flops": flops,
                    "bytes": bytes_moved,
                }
            )

    def _emit(self, record):  # caller holds the lock
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")

    # -- export ------------------------------------------------------------

    def export(self):
        """All recorded telemetry as one JSON-ready dict.

        Per stage: count, wall aggregates (total/min/mean/max/p99) and,
        where the instrumentation attributed analytic FLOPs, the derived
        ``tflops`` plus ``mfu_pct`` against the chip's peak
        (``utils.flops.peak_tflops``; absent when no peak is known: the
        CPU, or a card other than an H100, without
        ``SWIFTLY_PEAK_TFLOPS``).
        """
        peak = None
        with self._lock:
            if any(st.flops for st in self.stages.values()):
                try:
                    from ..utils.flops import peak_tflops

                    peak = peak_tflops()
                except Exception:  # pragma: no cover - no CUDA runtime
                    peak = None
            stages = {}
            tot_wall = 0.0
            tot_flops = 0
            tot_bytes = 0
            for name in sorted(self.stages):
                st = self.stages[name]
                samples = sorted(st.samples)
                entry = {
                    "count": st.count,
                    "total_s": round(st.total_s, 6),
                    "min_s": round(st.min_s, 6),
                    "mean_s": round(st.total_s / st.count, 6),
                    "max_s": round(st.max_s, 6),
                    "p50_s": round(_quantile_sorted(samples, 0.50), 6),
                    "p99_s": round(_quantile_sorted(samples, 0.99), 6),
                }
                if st.flops:
                    entry["flops"] = st.flops
                    if st.total_s > 0:
                        tfl = st.flops / st.total_s / 1e12
                        entry["tflops"] = round(tfl, 4)
                        if peak:
                            entry["mfu_pct"] = round(100 * tfl / peak, 2)
                if st.bytes_moved:
                    entry["bytes"] = st.bytes_moved
                    if st.total_s > 0:
                        entry["gbps"] = round(
                            st.bytes_moved / st.total_s / 1e9, 3
                        )
                stages[name] = entry
                tot_wall += st.total_s
                tot_flops += st.flops
                tot_bytes += st.bytes_moved
            total = {
                "wall_s": round(tot_wall, 6),
                "flops": tot_flops,
                "bytes": tot_bytes,
            }
            if tot_flops and tot_wall > 0:
                tfl = tot_flops / tot_wall / 1e12
                total["tflops"] = round(tfl, 4)
                if peak:
                    total["mfu_pct"] = round(100 * tfl / peak, 2)
            if peak:
                total["peak_tflops"] = peak
            out = {
                "enabled": self.enabled,
                "t_epoch": self._t_epoch,
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "gauges_max": dict(self.gauges_max),
                "stages": stages,
                "total": total,
            }
            if self._jsonl_path:
                out["jsonl_path"] = self._jsonl_path
            return out


# ---------------------------------------------------------------------------
# The process-wide registry + module-level conveniences (the engine's
# call-site API: `from ..obs import metrics` ... `metrics.stage(...)`).
# ---------------------------------------------------------------------------

_REGISTRY = MetricsRegistry(
    enabled=os.environ.get("SWIFTLY_METRICS", "0") not in ("", "0"),
    jsonl_path=os.environ.get("SWIFTLY_METRICS_JSONL") or None,
)


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def enabled() -> bool:
    return _REGISTRY.enabled


def enable(jsonl_path=None, device=None):
    return _REGISTRY.enable(jsonl_path, device)


def disable():
    _REGISTRY.disable()


def reset():
    _REGISTRY.reset()


def stage(name, flops=0, bytes_moved=0):
    # keep the disabled path shallow: three attribute checks, shared no-op
    if not _REGISTRY.enabled and not _trace._TRACER.enabled:
        if _recorder._RECORDER.enabled:
            return _recorder._RecorderStage(name)
        return _NULL_STAGE
    return _Stage(_REGISTRY, name, flops, bytes_moved)


def observe(name, wall_s, flops=0, bytes_moved=0):
    _REGISTRY.observe(name, wall_s, flops, bytes_moved)


def count(name, n=1):
    _REGISTRY.count(name, n)


def gauge(name, value):
    _REGISTRY.gauge(name, value)


def gauge_max(name, value):
    _REGISTRY.gauge_max(name, value)


def event(kind, **fields):
    _REGISTRY.event(kind, **fields)


def export():
    return _REGISTRY.export()
