"""The port's operator and report tools, each a program:
``python -m swiftly_tpu_torch.tools.<name>``.

The twins of the JAX package's ``scripts/`` of the same names, with the
same flags, output and exit codes, over the port's own packages; the
demos and the measuring tools add ``--device`` (default ``cuda``; no
fall back to the CPU) and share `_cli` (the twin of ``scripts/utils.py``):

* `demo_api` (with `run_streamed_with_checkpoint`), `demo_sparse_facet`,
  `demo_serve`: the round trip over a dense or a sparse facet cover, and
  a zipf request stream against `SubgridService`;
* `plan_explain`: the plan compiler's choice, rejected alternatives and
  degraded mesh layouts for a config;
* `accuracy_vs_n`, `derivation_demo`: the f32 error against N (at
  ``SWIFTLY_PRECISION``), and the 1D pipeline primitive by primitive;
* `estimate_large_config`, `roofline`: per-stage costs measured at full
  shape on the card, against the card's own bounds;
* `calibration_report`: per-stage plan-accuracy drift, calibration
  history and refit readiness from the ledger's JSONL history;
* `tower_report`: a drill artifact's fleet telemetry, alerts and
  post-mortem;
* `trace_report`: the critical path and span attribution of a recorded
  trace (``--by-source``, ``--by-process``).

``scripts/bench_compare.py`` imports neither package and reads the
port's records as they are, so it has no twin.
"""
