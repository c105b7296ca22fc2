"""Run telemetry of the port: metrics, span trace, flight recorder.

The port of the core of the JAX package's ``swiftly_tpu/obs/``:

* ``obs.metrics``: a near-zero-overhead registry (counters, gauges,
  peak gauges, stage timers with min/mean/max/p99). Disabled (the
  default) every instrumentation site costs one attribute check;
  enabled, each stage pairs a host wall-clock timer with a
  ``torch.profiler.record_function`` range (and an NVTX range on the
  card) of the same name. Optional JSONL event log, and a dict export
  with per-stage analytic FLOPs and MFU against ``utils.peak_tflops``.
* ``obs.trace``: the hierarchical span tracer (pass -> column group ->
  stage), with device peak-memory watermarks at span close, exported as
  Chrome trace-event JSON.
* ``obs.recorder``: the flight recorder, a bounded ring of events kept
  even with tracing off, dumped as a post-mortem bundle.

Enable via ``SWIFTLY_METRICS=1`` (JSONL path in ``SWIFTLY_METRICS_JSONL``),
``SWIFTLY_TRACE=1`` (Chrome JSON in ``SWIFTLY_TRACE_PATH``) and
``SWIFTLY_RECORDER=1`` (window ``SWIFTLY_RECORDER_SECONDS``), or
programmatically with ``metrics.enable(...)`` / ``trace.enable(path)`` /
``recorder.enable()``.

Not ported yet (ROADMAP A9, the rest): the run manifest and artifact
validators, the trace report, the control tower, the plan-accuracy
ledger and the heartbeat.
"""

from . import metrics, recorder, trace

__all__ = ["metrics", "recorder", "trace"]
