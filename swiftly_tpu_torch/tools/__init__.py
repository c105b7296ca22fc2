"""The port's report tools, each a program:
``python -m swiftly_tpu_torch.tools.<name>``.

The twins of the JAX package's ``scripts/`` of the same names, with the
same flags, output and exit codes, over the port's own `obs` and `plan`:

* `calibration_report`: per-stage plan-accuracy drift, calibration
  history and refit readiness from the ledger's JSONL history;
* `tower_report`: a drill artifact's fleet telemetry, alerts and
  post-mortem;
* `trace_report`: the critical path and span attribution of a recorded
  trace (``--by-source``, ``--by-process``).

``scripts/bench_compare.py`` imports neither package and reads the
port's records as they are, so it has no twin.
"""
