"""End-to-end demo: dense facet cover, forward -> process -> backward.

The port's twin of the JAX package's ``scripts/demo_api.py``: builds
facets from random sources, streams every subgrid through the forward
transform, feeds each into the backward transform, finishes the facets,
and reports per-facet RMS error plus timing and device-memory stats.
The same flags and log lines, plus ``--device`` (default cuda).

Usage:
    python -m swiftly_tpu_torch.tools.demo_api --swift_config 1k[1]-n512-256
    python -m swiftly_tpu_torch.tools.demo_api --swift_config 4k[1]-n2k-512 \\
        --backend planar --precision f32 --execution streamed-device \\
        --checkpoint ck/
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path

import numpy as np

from ._cli import (
    catalogue_params,
    cli_parser,
    enable_observability,
    human_readable_size,
    make_sources,
    resolve_mesh,
    setup_torch,
    working_dtype,
)

log = logging.getLogger("swiftly-tpu-torch.demo")


def run_streamed_with_checkpoint(
    fwd, bwd, subgrid_configs, ck_path=None, every=8, on_column=None
):
    """The streamed forward->backward loop with optional checkpointing.

    Folds each forward column (the device stack, ``add_subgrid_stack``)
    into `bwd`; with `ck_path`, snapshots the backward accumulators every
    `every` columns (atomic, CRC-checked, generations rotated: all in
    `utils.checkpoint`) and, if the file already exists, RESUMES: the
    columns it already holds are skipped (their forward is repeated, the
    forward being stateless; the backward's accumulation is not). A
    corrupt newest generation falls back to the previous good one.
    Returns the finished facets. `on_column(items)` is a progress hook
    (also the kill point of the resume drill)."""
    from ..utils.checkpoint import (
        restore_streamed_backward_state,
        save_streamed_backward_state,
    )

    processed = set()
    if ck_path is not None and Path(ck_path).exists():
        processed = {
            tuple(p) for p in restore_streamed_backward_state(ck_path, bwd)
        }
        log.info("resumed from %s: %d subgrids already folded",
                 ck_path, len(processed))
    cols_since_save = 0
    for items, subgrids in fwd.stream_columns(subgrid_configs,
                                              device_arrays=True):
        keys = [(sg.off0, sg.off1) for _, sg in items]
        if processed and all(k in processed for k in keys):
            continue
        # identity "processing" step sits here in a real pipeline
        bwd.add_subgrid_stack([sg for _, sg in items],
                              subgrids[:len(items)])
        processed.update(keys)
        cols_since_save += 1
        if on_column is not None:
            on_column(items)
        if ck_path is not None and cols_since_save >= every:
            save_streamed_backward_state(ck_path, bwd, sorted(processed))
            cols_since_save = 0
            log.info("checkpoint: %d subgrids folded", len(processed))
    return bwd.finish()


def demo_api(args, params, config_name=""):
    """Run one config end-to-end; returns max facet RMS error."""
    from .. import (
        SwiftlyBackward,
        SwiftlyConfig,
        SwiftlyForward,
        check_facet,
        make_facet,
        make_full_facet_cover,
        make_full_subgrid_cover,
    )
    from ..obs import Heartbeat
    from ..utils.profiling import MemorySampler, device_memory_stats, trace

    mesh = resolve_mesh(args.mesh_devices, args.device)
    config = SwiftlyConfig(backend=args.backend, mesh=mesh,
                           dtype=working_dtype(args), device=args.device,
                           **params)

    rng = np.random.default_rng(1)
    sources = make_sources(rng, args.source_number, config.image_size,
                           params.get("fov", 1.0))

    facet_configs = make_full_facet_cover(config)
    subgrid_configs = make_full_subgrid_cover(config)
    log.info(
        "config N=%d: %d facets (%d^2 px), %d subgrids (%d^2 px), "
        "contribution %d px",
        config.image_size, len(facet_configs), config.max_facet_size,
        len(subgrid_configs), config.max_subgrid_size,
        config.contribution_size,
    )

    t0 = time.time()
    facet_tasks = [
        (fc, make_facet(config.image_size, fc, sources))
        for fc in facet_configs
    ]
    log.info("facet data built in %.2fs", time.time() - t0)

    streamed = args.execution.startswith("streamed")
    if streamed:
        from ..parallel import StreamedBackward, StreamedForward

        residency = (
            "device" if args.execution == "streamed-device" else "host"
        )
        fwd = StreamedForward(
            config, facet_tasks, residency=residency,
            col_group=args.col_group or None,
        )
        bwd = StreamedBackward(config, facet_configs)
    else:
        fwd = SwiftlyForward(config, facet_tasks, args.lru_forward,
                             args.queue_size)
        # the fused mode's backward_all builds its own state
        bwd = None if args.execution == "fused" else SwiftlyBackward(
            config, facet_configs, args.lru_backward, args.queue_size
        )

    sampler = MemorySampler()
    t0 = time.time()
    with trace(args.profile_dir), sampler.sample():
        if args.execution == "fused":
            from .. import backward_all

            subgrids = fwd.all_subgrids(subgrid_configs)
            # identity "processing" step sits here in a real pipeline
            facets = backward_all(
                config, facet_configs,
                [(sg, subgrids[i]) for i, sg in enumerate(subgrid_configs)],
            )
        elif streamed:
            hb = Heartbeat(
                len(subgrid_configs), label="subgrids",
                interval_s=getattr(args, "heartbeat_s", 30.0), log=log,
            )

            def on_column(items):
                hb.update(len(items))

            ck_path = None
            if args.checkpoint:
                ck_dir = Path(args.checkpoint)
                ck_dir.mkdir(parents=True, exist_ok=True)
                tag = f"{config_name or 'run'}-{args.execution}"
                ck_path = ck_dir / f"bwd_{tag.replace('/', '_')}.npz"
            facets = run_streamed_with_checkpoint(
                fwd, bwd, subgrid_configs, ck_path=ck_path,
                every=args.checkpoint_every, on_column=on_column,
            )
        else:
            for i, sg_config in enumerate(subgrid_configs):
                subgrid = fwd.get_subgrid_task(sg_config)
                # identity "processing" step sits here in a real pipeline
                bwd.add_new_subgrid_task(sg_config, subgrid)
                if i % 50 == 0:
                    log.info("subgrid %d/%d off0=%d off1=%d", i,
                             len(subgrid_configs), sg_config.off0,
                             sg_config.off1)
            facets = bwd.finish()
        facets_np = [config.core.as_complex(f) for f in facets]
    elapsed = time.time() - t0
    log.info("forward+backward round trip: %.2fs (%.3fs/subgrid)",
             elapsed, elapsed / len(subgrid_configs))

    mem_stats = device_memory_stats()
    for dev, stats in mem_stats.items():
        log.info("device %s: %s in use", dev,
                 human_readable_size(stats.get("bytes_in_use", 0)))

    errors = [
        check_facet(config.image_size, fc, facets_np[i], sources)
        for i, fc in enumerate(facet_configs)
    ]
    for fc, err in zip(facet_configs, errors):
        log.info("facet off0/off1 %d/%d RMS %e", fc.off0, fc.off1, err)

    if args.artifact_dir:
        _write_artifacts(
            args, config, config_name, mesh, len(subgrid_configs),
            elapsed, errors, sampler, mem_stats,
        )
    return max(errors)


def _write_artifacts(args, config, config_name, mesh, n_subgrids, elapsed,
                     errors, sampler, mem_stats):
    """Per-run artifacts: memory CSV and HTML, transfer bytes (analytic:
    a mesh's collective bytes are exactly computable) and a summary
    JSON."""
    from ..obs import metrics, run_manifest
    from ..parallel.mesh import mesh_size
    from ..utils.profiling import (
        collective_bytes_backward,
        collective_bytes_forward,
    )

    out = Path(args.artifact_dir)
    out.mkdir(parents=True, exist_ok=True)
    tag = f"{config_name or 'run'}-{args.execution}".replace("/", "_")
    mem_csv = out / f"mem_{tag}.csv"
    sampler.to_csv(mem_csv)
    report_html = out / f"report_{tag}.html"
    sampler.to_html(report_html, title=f"{config_name} {args.execution}")

    n_dev = 1 if mesh is None else mesh_size(mesh)
    planar = config.core.backend == "planar"
    dtype = config.core.dtype if planar else np.float64
    transfer = {
        "n_devices": n_dev,
        "forward_bytes_per_subgrid": collective_bytes_forward(
            config.core.xM_size, n_dev, dtype, planar
        ),
        "backward_bytes_per_subgrid": collective_bytes_backward(
            config.max_subgrid_size, n_dev, dtype, planar
        ),
    }
    transfer["forward_bytes_total"] = (
        transfer["forward_bytes_per_subgrid"] * n_subgrids
    )
    transfer["backward_bytes_total"] = (
        transfer["backward_bytes_per_subgrid"] * n_subgrids
    )
    summary = {
        "config": config_name,
        "manifest": run_manifest(
            params={"config": config_name, "execution": args.execution}
        ),
        "backend": args.backend,
        "precision": args.precision,
        "execution": args.execution,
        "device": args.device,
        "n_subgrids": n_subgrids,
        "elapsed_s": round(elapsed, 3),
        "s_per_subgrid": round(elapsed / n_subgrids, 5),
        "max_facet_rms": max(errors),
        "facet_rms": errors,
        "transfer": transfer,
        "device_memory": {
            dev: {
                k: stats.get(k)
                for k in ("bytes_in_use", "peak_bytes_in_use")
                if k in stats
            }
            for dev, stats in mem_stats.items()
        },
        "memory_csv": str(mem_csv),
        "report_html": str(report_html),
    }
    if metrics.enabled():
        summary["telemetry"] = metrics.export()
    summary_path = out / f"summary_{tag}.json"
    summary_path.write_text(json.dumps(summary, indent=2))
    log.info("artifacts written: %s, %s", mem_csv, summary_path)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    parser = cli_parser(__doc__)
    parser.add_argument(
        "--heartbeat_s", type=float, default=30.0,
        help="streamed executions: seconds between progress/ETA lines",
    )
    args = parser.parse_args(argv)
    setup_torch(args)

    trace_path = enable_observability(args)

    from ..obs import trace as otrace

    for name in args.swift_config.split(","):
        params = catalogue_params(name)
        log.info("=== %s ===", name)
        with otrace.span("demo.run", cat="demo", config=name):
            max_err = demo_api(args, params, config_name=name)
        log.info("%s: max facet RMS error %e", name, max_err)
    if trace_path:
        otrace.save(trace_path)
        log.info("trace written: %s (load in Perfetto, or "
                 "`python -m swiftly_tpu_torch.tools.trace_report %s`)",
                 trace_path, trace_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
