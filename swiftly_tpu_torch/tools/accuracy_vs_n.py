"""Measure planar-f32 forward accuracy vs image size N.

The port's twin of the JAX package's ``scripts/accuracy_vs_n.py``: how
the matmul-FFT pipeline's error grows with N (the factored FFT and the
sampled-DFT facet pass accumulate over longer contractions). For each
config it computes sample subgrids of the full cover and reports RMS vs
the direct-DFT oracle, absolute and RELATIVE (absolute RMS scales as
1/N^2 for a unit source, so only the relative number compares across
N). The governed products run at ``SWIFTLY_PRECISION`` (read when each
executor is built, like everything else), so a table under each setting
is one run each; the JSON rows record it. The same flags and table, plus
``--device`` (default cuda).

Usage:
    python -m swiftly_tpu_torch.tools.accuracy_vs_n
        [--configs 1k[1]-n512-256,...] [--mode auto|batched|streamed]
        [--json out.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from ._cli import add_device_arg, catalogue_params

DEFAULT_CONFIGS = [
    "1k[1]-n512-256",
    "4k[1]-n2k-512",
    "8k[1]-n4k-512",
    "16k[1]-n8k-512",
    "32k[1]-n16k-512",
]

# The prepared facet stack outgrows the card above this N: the streamed
# (sampled-DFT, facets-resident) executor there, as the JAX package's.
STREAMED_ABOVE = 8192


def measure(config_name, mode, n_samples=16, device="cuda"):
    from .. import (
        SwiftlyConfig,
        SwiftlyForward,
        check_subgrid,
        make_facet,
        make_full_facet_cover,
        make_full_subgrid_cover,
    )
    from ..ops import planar_backend as plk
    from ..parallel import StreamedForward

    config = SwiftlyConfig(backend="planar", dtype=torch.float32,
                           device=device, **catalogue_params(config_name))
    N = config.image_size
    if mode == "auto":
        mode = "streamed" if N > STREAMED_ABOVE else "batched"

    sources = [(1.0, 1, 0)]
    facet_configs = make_full_facet_cover(config)
    subgrid_configs = make_full_subgrid_cover(config)
    facet_tasks = [
        (fc, make_facet(N, fc, sources)) for fc in facet_configs
    ]

    t0 = time.time()
    errs = []
    step = max(1, len(subgrid_configs) // n_samples)
    if mode == "streamed":
        fwd = StreamedForward(config, facet_tasks, residency="device")
        for items, out in fwd.stream_columns(subgrid_configs,
                                             device_arrays=True):
            for srow, (i, sgc) in enumerate(items):
                if i % step == 0:
                    errs.append(check_subgrid(
                        N, sgc, config.core.as_complex(out[srow]), sources))
    else:
        fwd = SwiftlyForward(config, facet_tasks, lru_forward=2,
                             queue_size=64)
        picked = subgrid_configs[::step]
        tasks = fwd.get_subgrid_tasks(picked)
        errs = [
            check_subgrid(N, sg, config.core.as_complex(t), sources)
            for sg, t in zip(picked, tasks)
        ]
    elapsed = time.time() - t0
    rms = max(errs)
    # unit source -> |subgrid| == 1/N^2 everywhere; relative = rms * N^2
    return {
        "config": config_name,
        "N": N,
        "mode": mode,
        "precision": plk.matmul_precision(),
        "n_samples": len(errs),
        "rms_abs": float(f"{rms:.3e}"),
        "rms_rel": float(f"{rms * N * N:.3e}"),
        "elapsed_s": round(elapsed, 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--configs", default=",".join(DEFAULT_CONFIGS))
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "batched", "streamed"])
    ap.add_argument("--json", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    rows = []
    print(f"{'config':24s} {'N':>6s} {'mode':>9s} {'abs RMS':>10s} "
          f"{'rel RMS':>10s} {'time':>7s}")
    for name in args.configs.split(","):
        row = measure(name, args.mode, device=args.device)
        rows.append(row)
        print(f"{row['config']:24s} {row['N']:6d} {row['mode']:>9s} "
              f"{row['rms_abs']:10.3e} {row['rms_rel']:10.3e} "
              f"{row['elapsed_s']:6.1f}s")
    if args.json:
        Path(args.json).write_text(json.dumps(rows, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
