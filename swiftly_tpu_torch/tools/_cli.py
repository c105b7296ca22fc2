"""Shared CLI and instrumentation helpers of the demo tools.

The port's twin of the JAX package's ``scripts/utils.py``: the same flags
(``@file`` argument files, ``--swift_config``, ``--backend``,
``--precision``, the execution and checkpoint options, ``--metrics``,
``--trace``), plus ``--device`` (default ``cuda``: the tools run on the
card unless the caller asks for the CPU). The backends are the port's:
``torch`` (complex tensors, the twin of ``jax``), ``planar``, ``numpy``
and ``native``. ``--precision`` is the working dtype; the governed
products' ``SWIFTLY_PRECISION`` is read from the environment.
"""

from __future__ import annotations

import argparse

import torch

__all__ = [
    "add_device_arg",
    "card_line",
    "catalogue_params",
    "cli_parser",
    "enable_observability",
    "human_readable_size",
    "make_sources",
    "resolve_mesh",
    "setup_torch",
    "working_dtype",
]


def human_readable_size(size: float, decimal_places: int = 3) -> str:
    """Format a byte count with binary units."""
    for unit in ["B", "KiB", "MiB", "GiB", "TiB", "PiB"]:
        if size < 1024 or unit == "PiB":
            break
        size /= 1024
    return f"{size:.{decimal_places}f} {unit}"


def _mesh_devices_arg(value: str) -> str:
    """Validate --mesh_devices at parse time: an integer or 'all'."""
    if value != "all":
        try:
            int(value)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"expected an integer or 'all', got {value!r}"
            ) from None
    return value


def add_device_arg(parser: argparse.ArgumentParser):
    """``--device``: where the tool runs (default the card)."""
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device the tool runs on (default cuda; cpu for a "
             "rehearsal without the card)",
    )
    return parser


def cli_parser(description: str) -> argparse.ArgumentParser:
    """Common demo CLI. Supports @file argument files (one arg per line)."""
    parser = argparse.ArgumentParser(
        description=description,
        fromfile_prefix_chars="@",
    )
    parser.add_argument(
        "--swift_config", type=str, default="1k[1]-n512-256",
        help="comma-separated catalogue key(s), see "
             "swiftly_tpu_torch.SWIFT_CONFIGS",
    )
    parser.add_argument(
        "--backend", type=str, default="torch",
        choices=["torch", "planar", "numpy", "native"],
        help="numerical backend",
    )
    parser.add_argument(
        "--precision", type=str, default="f64", choices=["f32", "f64"],
        help="working precision (the governed products' precision is "
             "SWIFTLY_PRECISION)",
    )
    parser.add_argument(
        "--source_number", type=int, default=10,
        help="number of random point sources in the test image",
    )
    parser.add_argument(
        "--queue_size", type=int, default=20, help="in-flight work cap"
    )
    parser.add_argument(
        "--lru_forward", type=int, default=1, help="forward column cache size"
    )
    parser.add_argument(
        "--lru_backward", type=int, default=1,
        help="backward column accumulator count",
    )
    parser.add_argument(
        "--execution", type=str, default="batched",
        choices=["batched", "fused", "streamed", "streamed-device"],
        help="execution strategy: 'batched' streams subgrid-by-subgrid "
             "with prepared facets on the device; 'fused' runs the whole "
             "cover as one forward and one backward; 'streamed' buffers "
             "column intermediates in host RAM (out-of-core); "
             "'streamed-device' keeps the raw facets on the card and "
             "computes column groups by sampled DFT",
    )
    parser.add_argument(
        "--col_group", type=int, default=0,
        help="streamed-device: columns per sampled-DFT group "
             "(0 = auto-size from the device budget)",
    )
    parser.add_argument(
        "--mesh_devices", type=_mesh_devices_arg, default="0",
        help="shard facets over this many devices "
             "(0 = single device, 'all' = every visible card)",
    )
    parser.add_argument(
        "--checkpoint", type=str, default=None,
        help="streamed executions: snapshot the backward accumulators to "
             "this directory every --checkpoint_every columns and "
             "auto-resume from an existing snapshot",
    )
    parser.add_argument(
        "--checkpoint_every", type=int, default=8,
        help="columns between checkpoint snapshots",
    )
    parser.add_argument(
        "--profile_dir", type=str, default=None,
        help="write a torch.profiler trace to this directory",
    )
    parser.add_argument(
        "--artifact_dir", type=str, default=None,
        help="write per-run artifacts here: device-memory samples CSV, "
             "analytic collective-transfer bytes and a summary JSON",
    )
    parser.add_argument(
        "--metrics", action="store_true",
        help="enable the per-stage metrics registry "
             "(swiftly_tpu_torch.obs; equivalent to SWIFTLY_METRICS=1)",
    )
    parser.add_argument(
        "--metrics_jsonl", type=str, default=None,
        help="also append per-stage telemetry events to this JSONL file "
             "(implies --metrics; equivalent to SWIFTLY_METRICS_JSONL)",
    )
    parser.add_argument(
        "--trace", type=str, default=None, metavar="PATH",
        help="record a span timeline and write Chrome trace-event JSON "
             "to PATH at exit (inspect with "
             "python -m swiftly_tpu_torch.tools.trace_report)",
    )
    return add_device_arg(parser)


def working_dtype(args):
    """The working dtype of ``--precision`` for ``--backend``."""
    if args.backend == "torch":
        return torch.complex64 if args.precision == "f32" else torch.complex128
    return torch.float32 if args.precision == "f32" else torch.float64


def setup_torch(args):
    """Check ``--device`` before first use: a CUDA device needs the card
    (no silent fall back to the CPU). Returns the torch device."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA device is visible "
            "(pass --device cpu to run on the CPU)")
    return device


def enable_observability(args):
    """Turn on the metrics registry and/or span tracer the CLI asked
    for; returns the trace path (None = tracing off)."""
    device = getattr(args, "device", None)
    if getattr(args, "metrics", False) or getattr(args, "metrics_jsonl", None):
        from ..obs import metrics

        metrics.enable(args.metrics_jsonl or None, device=device)
    trace_path = getattr(args, "trace", None)
    if trace_path:
        from ..obs import trace

        trace.enable(trace_path, device=device)
    return trace_path


def resolve_mesh(mesh_devices: str, device="cuda"):
    """The facet mesh of ``--mesh_devices``: None for 0; on the CPU that
    many virtual shards, on the card that many visible cards ('all':
    every one)."""
    from ..parallel.mesh import make_facet_mesh

    if mesh_devices == "all":
        return make_facet_mesh()
    n = int(mesh_devices)
    if not n:
        return None
    if torch.device(device).type == "cpu":
        return make_facet_mesh(devices=["cpu"] * n)
    return make_facet_mesh(n_devices=n)


def make_sources(rng, count, image_size, fov=1.0):
    """Random integer point sources within the field of view."""
    lim = int(image_size // 2 * min(fov, 1.0)) - 1
    return [
        (float(rng.integers(1, 100)),
         int(rng.integers(-lim, lim)),
         int(rng.integers(-lim, lim)))
        for _ in range(count)
    ]


def catalogue_params(name):
    """A catalogue entry's parameters, ``fov`` defaulted to 1."""
    from ..models import SWIFT_CONFIGS

    params = dict(SWIFT_CONFIGS[name])
    params.setdefault("fov", 1.0)
    return params


def card_line():
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, or
    why there is none."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi printed nothing")
