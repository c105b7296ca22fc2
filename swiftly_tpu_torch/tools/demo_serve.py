"""On-demand serving demo: a zipf request stream against SubgridService.

The port's twin of the JAX package's ``scripts/demo_serve.py``, the
serving counterpart of `demo_api`: builds a facet cover from random
sources, wraps the prepared forward in the port's
`swiftly_tpu_torch.serve.SubgridService` (bounded admission queue and
column-coalescing scheduler), replays a zipf-over-columns request trace
in bursts, and prints the latency-SLO stats block plus the obs counters.
The same flags, output and exit code, plus ``--device`` (default cuda).

Usage:
    python -m swiftly_tpu_torch.tools.demo_serve --swift_config 1k[1]-n512-256
    python -m swiftly_tpu_torch.tools.demo_serve --swift_config 4k[1]-n2k-512 \\
        --backend planar --precision f32 --requests 1000 --threaded
"""

from __future__ import annotations

import json
import logging
import sys
import time

import numpy as np

from ._cli import (
    catalogue_params,
    cli_parser,
    enable_observability,
    make_sources,
    setup_torch,
    working_dtype,
)

log = logging.getLogger("swiftly-tpu-torch.demo-serve")


def main(argv=None):
    parser = cli_parser("On-demand subgrid serving demo")
    parser.add_argument(
        "--requests", type=int, default=200,
        help="zipf workload length",
    )
    parser.add_argument(
        "--zipf_s", type=float, default=1.1,
        help="zipf exponent over the (shuffled) column popularity ranks",
    )
    parser.add_argument(
        "--burst", type=int, default=20,
        help="requests submitted per burst before pumping",
    )
    parser.add_argument(
        "--max_batch", type=int, default=32,
        help="coalescing cap per column dispatch",
    )
    parser.add_argument(
        "--max_depth", type=int, default=128,
        help="admission-queue depth (overflow sheds)",
    )
    parser.add_argument(
        "--slo_ms", type=float, default=None,
        help="latency SLO; violations are counted in the stats block",
    )
    parser.add_argument(
        "--timeout_s", type=float, default=None,
        help="service-wide per-request deadline",
    )
    parser.add_argument(
        "--threaded", action="store_true",
        help="run the pump on the service worker thread",
    )
    parser.add_argument(
        "--seed", type=int, default=1234,
        help="workload seed",
    )
    args = parser.parse_args(argv)  # --metrics etc. come from cli_parser
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s: %(message)s")
    setup_torch(args)

    from .. import (
        SwiftlyConfig,
        SwiftlyForward,
        make_facet,
        make_full_facet_cover,
        make_full_subgrid_cover,
    )
    from ..obs import metrics
    from ..obs import trace as otrace
    from ..serve import AdmissionQueue, CoalescingScheduler, SubgridService

    trace_path = enable_observability(args)

    name = args.swift_config.split(",")[0]
    params = catalogue_params(name)
    config = SwiftlyConfig(backend=args.backend, dtype=working_dtype(args),
                           device=args.device, **params)
    rng = np.random.default_rng(args.seed)
    sources = make_sources(rng, 8, config.image_size)
    facet_configs = make_full_facet_cover(config)
    subgrid_configs = make_full_subgrid_cover(config)
    t0 = time.time()
    facet_tasks = [
        (fc, make_facet(config.image_size, fc, sources))
        for fc in facet_configs
    ]
    fwd = SwiftlyForward(
        config, facet_tasks,
        lru_forward=max(2, args.lru_forward),
        queue_size=args.queue_size,
    )
    log.info("facets built in %.1fs; %d subgrids over %d columns",
             time.time() - t0, len(subgrid_configs),
             len({sg.off0 for sg in subgrid_configs}))

    # zipf-over-columns trace: shuffled popularity ranking, p ~ 1/rank^s
    cols = sorted({sg.off0 for sg in subgrid_configs})
    by_col = {}
    for sg in subgrid_configs:
        by_col.setdefault(sg.off0, []).append(sg)
    order = rng.permutation(len(cols))
    ranks = np.empty(len(cols), dtype=int)
    ranks[order] = np.arange(len(cols))
    p = 1.0 / (ranks + 1.0) ** args.zipf_s
    p /= p.sum()
    picks = rng.choice(len(cols), size=args.requests, p=p)
    workload = [
        by_col[cols[c]][rng.integers(len(by_col[cols[c]]))] for c in picks
    ]

    service = SubgridService(
        fwd,
        queue=AdmissionQueue(max_depth=args.max_depth),
        scheduler=CoalescingScheduler(
            max_batch=args.max_batch, urgency_s=0.05
        ),
        timeout_s=args.timeout_s,
        slo_ms=args.slo_ms,
    )
    # the run's root span opens before service.start(): the worker
    # thread adopts the caller's trace context at start(), so pump spans
    # (and the per-request journey tracks) nest under the run
    serve_span = otrace.span("demo.serve", cat="demo", config=name)
    serve_span.__enter__()
    if args.threaded:
        service.start()
    reqs = []
    t0 = time.time()
    for i in range(0, len(workload), args.burst):
        for sg in workload[i : i + args.burst]:
            reqs.append(service.submit(
                sg, priority=int(rng.integers(0, 4))
            ))
        if not args.threaded:
            while service.pump_once():
                pass
    if args.threaded:
        for r in reqs:
            r.wait()
        service.stop()
    wall = time.time() - t0
    serve_span.__exit__(None, None, None)

    stats = service.stats()
    stats["wall_s"] = round(wall, 3)
    stats["throughput_rps"] = (
        round(stats["n_served"] / wall, 2) if wall else 0.0
    )
    print(json.dumps(stats, indent=2))
    if trace_path:
        otrace.save(trace_path)
        log.info("trace written: %s (load in Perfetto, or "
                 "`python -m swiftly_tpu_torch.tools.trace_report %s`)",
                 trace_path, trace_path)
    if args.metrics:
        exported = metrics.export()
        print(json.dumps(
            {
                "serve_counters": {
                    k: v for k, v in exported["counters"].items()
                    if k.startswith(("serve.", "lru."))
                },
                "serve_stages": {
                    k: v for k, v in exported["stages"].items()
                    if k.startswith("serve.")
                },
            },
            indent=2,
        ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
