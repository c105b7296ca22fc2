"""Profiling and memory instrumentation of the port.

The port of the JAX package's ``swiftly_tpu/utils/profiling.py``:

* `probe_hbm_bytes` -- the one probe of the card's usable memory
  (``torch.cuda.mem_get_info``'s free bytes plus what PyTorch's allocator
  holds cached but unused); `plan.hbm_budget_bytes` sizes every budget
  from it.
* `trace(dir)` -- a context manager writing a ``torch.profiler`` trace of
  the region as Chrome trace-event JSON (viewable in Perfetto).
* `device_memory_stats()` -- per-device ``torch.cuda.memory_stats``, with
  ``bytes_in_use`` / ``peak_bytes_in_use`` as the JAX package names them.
* `MemorySampler` -- ``torch.cuda.memory_allocated`` polled on a thread
  into rows you can dump to CSV or an HTML timeline.
* `collective_bytes_forward/backward` -- analytic bytes a facet-sharded
  mesh moves per subgrid.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "MemorySampler",
    "collective_bytes_backward",
    "collective_bytes_forward",
    "column_collective_bytes",
    "device_memory_stats",
    "probe_hbm_bytes",
    "trace",
]

# one-shot flag: warn the first time no device reports stats, so the
# memory artifacts written carry a note that they hold only zeros
_warned_empty_stats = False


def probe_hbm_bytes(device=None, held=0):
    """Device bytes a caller may use on a CUDA `device` (default: the
    current one): the driver's free bytes (``torch.cuda.mem_get_info``),
    plus what PyTorch's allocator holds cached but unused, plus `held`,
    device bytes the caller already holds and prices itself (e.g. resident
    facets). Read afresh at each call. None on the CPU, or with
    ``SWIFTLY_HBM_PROBE=0`` (callers then fall back to their own default).

    :raises RuntimeError: when CUDA is present but its driver cannot be
        queried
    """
    import torch

    if os.environ.get("SWIFTLY_HBM_PROBE", "1") == "0":
        return None
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return free + cached + held


@contextlib.contextmanager
def trace(log_dir=None):
    """Profile the enclosed region with ``torch.profiler`` (host, and the
    card's activity where CUDA is available) and write it to `log_dir` as
    Chrome trace-event JSON (``trace_<pid>_<time>.json``); yields the
    profiler. A no-op when `log_dir` is None."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    out = os.path.join(
        str(log_dir), f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(out)
    logger.info("profiler trace written to %s", out)


def device_memory_stats() -> dict:
    """Per-device memory statistics: ``torch.cuda.memory_stats`` of each
    CUDA device, plus ``bytes_in_use`` (``memory_allocated``) and
    ``peak_bytes_in_use`` (``max_memory_allocated``). ``{"cpu": {}}``
    where CUDA is unavailable."""
    import torch

    stats = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            try:
                st = dict(torch.cuda.memory_stats(i))
                st["bytes_in_use"] = torch.cuda.memory_allocated(i)
                st["peak_bytes_in_use"] = torch.cuda.max_memory_allocated(i)
            except RuntimeError:  # pragma: no cover - driver-specific
                st = {}
            stats[f"cuda:{i}"] = st
    else:
        stats["cpu"] = {}
    global _warned_empty_stats
    if not _warned_empty_stats and not any(stats.values()):
        _warned_empty_stats = True
        logger.warning(
            "no device reports memory statistics (%s): memory reports and "
            "CSVs from this run will contain only zeros",
            ", ".join(stats) or "no devices",
        )
    return stats


class MemorySampler:
    """Samples device memory (``torch.cuda.memory_allocated``) on a
    background thread.

    Usage::

        sampler = MemorySampler(interval=0.5)
        with sampler.sample():
            ... work ...
        rows = sampler.rows   # [(t, device, bytes_in_use), ...]
        sampler.to_csv("mem.csv")
    """

    def __init__(self, interval: float = 0.5):
        self.interval = interval
        self.rows = []
        self._stop = threading.Event()
        self._thread = None

    @staticmethod
    def _read():
        import torch

        if not torch.cuda.is_available():
            return [("cpu", 0)]
        return [(f"cuda:{i}", torch.cuda.memory_allocated(i))
                for i in range(torch.cuda.device_count())]

    def _loop(self):
        t0 = time.time()
        while not self._stop.is_set():
            for dev, nbytes in self._read():
                self.rows.append((time.time() - t0, dev, nbytes))
            self._stop.wait(self.interval)

    @contextlib.contextmanager
    def sample(self):
        self.rows = []
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        try:
            yield self
        finally:
            self._stop.set()
            self._thread.join()

    def to_csv(self, path):
        with open(path, "w") as fh:
            fh.write("t_seconds,device,bytes_in_use\n")
            for t, dev, b in self.rows:
                fh.write(f"{t:.3f},{dev},{b}\n")

    def to_html(self, path, title="device memory"):
        """Self-contained HTML report: an inline-SVG memory timeline per
        device ."""
        import html as _html

        title = _html.escape(str(title))
        by_dev = {}
        for t, dev, b in self.rows:
            by_dev.setdefault(str(dev), []).append((t, b))
        t_max = max((t for t, _, _ in self.rows), default=1.0) or 1.0
        b_max = max((b for _, _, b in self.rows), default=1) or 1
        W, H, PAD = 800, 240, 40
        # legend column to the right of the plot so labels never overlap
        # the curves, however many devices there are
        LEG = 180
        colors = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e"]
        parts = [
            "<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{title}</title></head><body>"
            f"<h2>{title}</h2>"
            f"<p>peak {b_max / 2**30:.2f} GiB over {t_max:.1f} s</p>"
            f"<svg width='{W + LEG}' height='{H}' "
            "style='background:#fafafa;border:1px solid #ccc'>"
        ]
        for i, (dev, pts) in enumerate(sorted(by_dev.items())):
            coords = [
                (
                    PAD + (W - 2 * PAD) * t / t_max,
                    H - PAD - (H - 2 * PAD) * b / b_max,
                )
                for t, b in pts
            ]
            c = colors[i % len(colors)]
            if len(coords) == 1:
                # a one-point polyline renders nothing: draw a dot
                x, y = coords[0]
                parts.append(
                    f"<circle cx='{x:.1f}' cy='{y:.1f}' r='3' "
                    f"fill='{c}'/>"
                )
            else:
                poly = " ".join(f"{x:.1f},{y:.1f}" for x, y in coords)
                parts.append(
                    f"<polyline points='{poly}' fill='none' stroke='{c}' "
                    f"stroke-width='1.5'/>"
                )
            parts.append(
                f"<text x='{W + 8}' y='{16 + 14 * i}' fill='{c}' "
                f"font-size='12'>{_html.escape(dev)}</text>"
            )
        parts.append(
            f"<text x='{PAD}' y='{H - 8}' font-size='11'>0 s</text>"
            f"<text x='{W - PAD - 30}' y='{H - 8}' font-size='11'>"
            f"{t_max:.0f} s</text>"
            f"<text x='2' y='{PAD}' font-size='11'>"
            f"{b_max / 2**30:.1f} GiB</text>"
            "</svg></body></html>"
        )
        with open(path, "w") as fh:
            fh.write("".join(parts))


def _itemsize(dtype, planar: bool) -> int:
    """Bytes of one element: a numpy or torch `dtype`, times 2 for the
    planar (re, im) layout."""
    try:
        size = np.dtype(dtype).itemsize
    except TypeError:  # a torch dtype
        import torch

        size = torch.empty((), dtype=dtype).element_size()
    return 2 * size if planar else size


def collective_bytes_forward(
    xM_size: int, n_devices: int, dtype=np.float32, planar: bool = True,
) -> int:
    """Bytes crossing the mesh per forward subgrid (analytic).

    Each device contributes a partial padded subgrid [xM, xM]; a ring
    all-reduce over d devices moves 2*(d-1) buffers in total.
    """
    buf = xM_size * xM_size * _itemsize(dtype, planar)
    return int(buf * 2 * (n_devices - 1))


def collective_bytes_backward(
    xA_size: int, n_devices: int, dtype=np.float32, planar: bool = True,
) -> int:
    """Bytes crossing the mesh per backward subgrid (analytic).

    The subgrid [xA, xA] is broadcast to every device holding facets;
    accumulators stay device-local (no further collectives).
    """
    buf = xA_size * xA_size * _itemsize(dtype, planar)
    return int(buf * (n_devices - 1))


def column_collective_bytes(
    core, n_devices: int, n_subgrids: int, direction: str = "forward",
    subgrid_size: int | None = None,
) -> int:
    """Analytic wire bytes of ONE streamed column's collectives — the
    per-stage transfer attribution the obs instrumentation stamps on
    mesh column passes (zero off-mesh, so single-device stages carry no
    phantom traffic).

    Forward: one psum of the column's [S, xM, xM] partials (ring
    all-reduce accounting, `collective_bytes_forward` per subgrid).
    Backward: the column's subgrids broadcast to every facet shard
    (`collective_bytes_backward`; requires `subgrid_size`).
    """
    if n_devices <= 1:
        return 0
    planar = core.backend == "planar"
    if direction == "forward":
        per = collective_bytes_forward(
            core.xM_size, n_devices, core.dtype, planar
        )
    elif direction == "backward":
        if subgrid_size is None:
            raise ValueError("backward direction requires subgrid_size")
        per = collective_bytes_backward(
            subgrid_size, n_devices, core.dtype, planar
        )
    else:
        raise ValueError(f"direction must be forward|backward, got {direction!r}")
    return per * n_subgrids
