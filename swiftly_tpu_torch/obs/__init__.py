"""Run telemetry of the port: metrics, provenance, traces, the control
tower, the plan-accuracy ledger and progress.

The port of the JAX package's ``swiftly_tpu/obs/``:

* ``obs.metrics``: a near-zero-overhead registry (counters, gauges,
  peak gauges, stage timers with min/mean/max/p99). Disabled (the
  default) every instrumentation site costs one attribute check;
  enabled, each stage pairs a host wall-clock timer with a
  ``torch.profiler.record_function`` range (and, on the card, an NVTX
  range and CUDA events for its device time) of the same name. Optional
  JSONL event log, and a dict export with per-stage analytic FLOPs and
  MFU against ``utils.peak_tflops``.
* ``obs.trace``: the hierarchical span tracer (pass -> column group ->
  stage), with device peak-memory watermarks at span close, exported as
  Chrome trace-event JSON.
* ``obs.recorder``: the flight recorder, a bounded ring of events kept
  even with tracing off, dumped as a post-mortem bundle.
* ``obs.manifest``: the run-provenance record (the card, its power
  limit, torch/CUDA/nvcc versions, ``SWIFTLY_*`` knobs, git SHA, config
  hash) and the artifact-block validators.
* ``obs.report``: trace analysis (span trees, critical path and self
  times, journeys, ``merge_traces``) and the trace block's validator.
* ``obs.tower``: the control tower: named sources, windowed signals,
  SLO burn-rate alerts.
* ``obs.ledger``: the plan-accuracy ledger (predicted against measured
  stage walls, the calibration history, the mispricing alarm).
* ``obs.heartbeat``: progress and ETA for long loops, and partial
  artifacts that survive a killed run.

Enable via ``SWIFTLY_METRICS=1`` (JSONL path in ``SWIFTLY_METRICS_JSONL``),
``SWIFTLY_TRACE=1`` (Chrome JSON in ``SWIFTLY_TRACE_PATH``) and
``SWIFTLY_RECORDER=1`` (window ``SWIFTLY_RECORDER_SECONDS``), or
programmatically with ``metrics.enable(...)`` / ``trace.enable(path)`` /
``recorder.enable()``. ``SWIFTLY_CALIBRATION_HISTORY`` names the ledger's
JSONL history (``0`` turns it off).
"""

from . import ledger, metrics, recorder, report, tower, trace
from .heartbeat import Heartbeat, PartialArtifactWriter
from .ledger import validate_plan_accuracy_artifact
from .manifest import (
    run_manifest,
    validate_artifact,
    validate_delta_artifact,
    validate_fleet_artifact,
    validate_mesh_artifact,
    validate_plan_artifact,
    validate_procfleet_artifact,
    validate_resilience_artifact,
    validate_serve_artifact,
    validate_vis_artifact,
)
from .report import (
    by_process,
    merge_traces,
    summarize_trace,
    validate_trace_artifact,
)
from .tower import (
    SLO,
    ControlTower,
    validate_alerts_artifact,
    validate_fleet_telemetry_artifact,
)

__all__ = [
    "ControlTower",
    "Heartbeat",
    "PartialArtifactWriter",
    "SLO",
    "by_process",
    "ledger",
    "merge_traces",
    "metrics",
    "recorder",
    "report",
    "run_manifest",
    "summarize_trace",
    "tower",
    "trace",
    "validate_alerts_artifact",
    "validate_artifact",
    "validate_delta_artifact",
    "validate_fleet_artifact",
    "validate_fleet_telemetry_artifact",
    "validate_mesh_artifact",
    "validate_plan_accuracy_artifact",
    "validate_plan_artifact",
    "validate_procfleet_artifact",
    "validate_resilience_artifact",
    "validate_serve_artifact",
    "validate_trace_artifact",
    "validate_vis_artifact",
]
