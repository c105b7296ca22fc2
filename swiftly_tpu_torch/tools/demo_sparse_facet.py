"""Sparse-facet demo: irregular facet cover over a circular field of view.

The port's twin of the JAX package's ``scripts/demo_sparse_facet.py``:
facets cover only a round FoV (optionally off-centre) instead of tiling
the full image; the subgrid cover stays dense. The same flags and log
lines, plus ``--device`` (default cuda).

Usage:
    python -m swiftly_tpu_torch.tools.demo_sparse_facet \\
        --swift_config 4k[1]-n2k-512 --fov_fraction 0.9 [--check_subgrid]
"""

from __future__ import annotations

import logging
import sys
import time

import numpy as np

from ._cli import catalogue_params, cli_parser, setup_torch, working_dtype

log = logging.getLogger("swiftly-tpu-torch.demo-sparse")


def demo_sparse(args, params):
    """Run one config over the sparse cover; returns max facet RMS."""
    from .. import (
        SwiftlyBackward,
        SwiftlyConfig,
        SwiftlyForward,
        check_facet,
        check_subgrid,
        make_facet,
        make_full_subgrid_cover,
        make_sparse_facet_cover,
        sparse_fov_cover_offsets,
    )

    config = SwiftlyConfig(backend=args.backend, dtype=working_dtype(args),
                           device=args.device, **params)
    fov_pixels = int(config.image_size * args.fov_fraction)
    # FoV offsets must respect the facet offset step
    step = config.facet_off_step
    x0 = (args.fov_x0 // step) * step
    y0 = (args.fov_y0 // step) * step

    offsets, masks = sparse_fov_cover_offsets(config, fov_pixels, x0, y0)
    facet_configs = make_sparse_facet_cover(
        config.max_facet_size, offsets, masks
    )
    subgrid_configs = make_full_subgrid_cover(config)
    log.info(
        "sparse cover: %d facets over FoV %d px (dense would need %d)",
        len(facet_configs), fov_pixels,
        int(np.ceil(config.image_size / config.max_facet_size)) ** 2,
    )

    rng = np.random.default_rng(2)
    # sources restricted to the FoV so the sparse cover can represent them
    lim = max(fov_pixels // 2 - config.max_facet_size // 2, 4)
    sources = [
        (float(rng.integers(1, 100)),
         int(rng.integers(-lim, lim)) + x0,
         int(rng.integers(-lim, lim)) + y0)
        for _ in range(args.source_number)
    ]

    facet_tasks = [
        (fc, make_facet(config.image_size, fc, sources))
        for fc in facet_configs
    ]

    streamed = args.execution.startswith("streamed")
    t0 = time.time()
    sg_errors = []

    def check(sg, data):
        if args.check_subgrid:
            sg_errors.append(check_subgrid(
                config.image_size, sg, config.core.as_complex(data),
                sources))

    if args.execution == "fused":
        from .. import backward_all

        fwd = SwiftlyForward(
            config, facet_tasks, args.lru_forward, args.queue_size
        )
        subgrids = fwd.all_subgrids(subgrid_configs)
        for i, sg in enumerate(subgrid_configs):
            check(sg, subgrids[i])
        facets = backward_all(
            config, facet_configs,
            [(sg, subgrids[i]) for i, sg in enumerate(subgrid_configs)],
        )
    elif streamed:
        from ..parallel import StreamedBackward, StreamedForward

        residency = (
            "device" if args.execution == "streamed-device" else "host"
        )
        fwd = StreamedForward(
            config, facet_tasks, residency=residency,
            col_group=args.col_group or None,
        )
        bwd = StreamedBackward(config, facet_configs, residency=residency)
        for items, subgrids in fwd.stream_columns(subgrid_configs):
            for s, (_, sg) in enumerate(items):
                check(sg, subgrids[s])
            bwd.add_subgrids(
                [(sg, subgrids[s]) for s, (_, sg) in enumerate(items)]
            )
        facets = bwd.finish()
    else:
        fwd = SwiftlyForward(config, facet_tasks, args.lru_forward,
                             args.queue_size)
        bwd = SwiftlyBackward(config, facet_configs, args.lru_backward,
                              args.queue_size)
        for sg_config in subgrid_configs:
            subgrid = fwd.get_subgrid_task(sg_config)
            check(sg_config, subgrid)
            bwd.add_new_subgrid_task(sg_config, subgrid)
        facets = bwd.finish()
    elapsed = time.time() - t0
    log.info("round trip: %.2fs (%.3fs/subgrid)", elapsed,
             elapsed / len(subgrid_configs))

    if sg_errors:
        log.info("max subgrid RMS: %e", max(sg_errors))

    errors = [
        check_facet(config.image_size, fc, config.core.as_complex(facets[i]),
                    sources)
        for i, fc in enumerate(facet_configs)
    ]
    for fc, err in zip(facet_configs, errors):
        log.info("facet off0/off1 %d/%d RMS %e", fc.off0, fc.off1, err)
    return max(errors)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    parser = cli_parser(__doc__)
    parser.add_argument(
        "--fov_fraction", type=float, default=0.9,
        help="FoV diameter as a fraction of the image size",
    )
    parser.add_argument("--fov_x0", type=int, default=0,
                        help="FoV centre offset, axis 0")
    parser.add_argument("--fov_y0", type=int, default=0,
                        help="FoV centre offset, axis 1")
    parser.add_argument(
        "--check_subgrid", action="store_true",
        help="also check every subgrid against the DFT oracle (slow)",
    )
    args = parser.parse_args(argv)
    setup_torch(args)

    for name in args.swift_config.split(","):
        params = catalogue_params(name)
        log.info("=== %s ===", name)
        max_err = demo_sparse(args, params)
        log.info("%s: max facet RMS error %e", name, max_err)
    return 0


if __name__ == "__main__":
    sys.exit(main())
