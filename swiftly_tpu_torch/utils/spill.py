"""Subgrid-stream spill cache: a recorded forward stream in host RAM, with
an optional disk tier.

The port of the JAX package's ``swiftly_tpu/utils/spill.py``
`SpillCache`: a forward pass's column-group subgrid stacks are recorded
once (``begin_fill`` / ``put`` / ``end_fill``) and read back by consumers,
either whole (``get``: the streamed executors' replay,
``StreamedForward.stream_column_groups(spill=...)``) or one subgrid at a
time (``get_row``: the serving path's `parallel.streamed.CachedColumnFeed`).

Storage is a host-RAM ring with optional disk backing:

* entries up to ``budget_bytes`` (default `spill_budget_bytes`:
  ``SWIFTLY_SPILL_BUDGET_GB``, else half of ``MemAvailable``) stay in RAM;
* past the budget, entries spill to ``spill_dir`` (default
  ``SWIFTLY_SPILL_DIR``) as ``.npy`` memmaps, written in bounded chunks,
  atomically (tmp sibling + rename);
* with no disk dir, over-budget entries are EVICTED: the fill is marked
  incomplete (``gave_up``) and consumers fall back to computing — a
  capacity miss degrades to the old cost model, never to a wrong answer.

The cache stores plain float arrays, so a row read back is bit-identical to
the row recorded.

Resilience and telemetry, as the JAX package's: reads and disk writes are
fault sites (``spill.read``, ``spill.get_row``, ``spill.write``) that
retry transient I/O errors (`resilience.retry.retry_transient`); a disk
write that stays failed steps the degradation ladder down to a
host-RAM-only cache (``degrade`` record ``spill.disk_to_ram``); disk reads
and writes are ``spill.disk_read`` / ``spill.disk_write`` stages with
their bytes, and evictions, disk reads and swept orphans are ``spill.*``
counters.

Not ported yet: ``patch_entry`` for incremental facet updates with the
reader–writer patch gate it needs (``begin_patch`` / ``end_patch``,
``StreamMidPatch``; ROADMAP A11), ``export_manifest`` for process-fleet
readers (A12) and the compiled plan's ``policy`` stamp (A10).
"""

from __future__ import annotations

import glob
import logging
import os
import shutil
import tempfile
import threading

import numpy as np

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..resilience import degrade as _degrade
from ..resilience.faults import fault_point
from ..resilience.retry import retry_transient

__all__ = ["SpillCache", "spill_budget_bytes"]

logger = logging.getLogger(__name__)

# chunk size for disk-backed writes: bounds the per-write dirty-page
# burst while keeping the stream sequential (memmap-friendly)
_DISK_CHUNK_BYTES = 256e6


def spill_budget_bytes():
    """Host-RAM byte budget for recorded stream entries.

    ``SWIFTLY_SPILL_BUDGET_GB`` (GiB) when set; else half of the kernel's
    ``MemAvailable`` at call time (the stream shares the host with the
    facet data and staging buffers); else 8 GiB.
    """
    env = os.environ.get("SWIFTLY_SPILL_BUDGET_GB")
    if env:
        return float(env) * 2**30
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024 / 2
    except OSError:  # pragma: no cover - no /proc
        pass
    return 8 * 2**30  # pragma: no cover - /proc always present on Linux


class SpillCache:
    """Ordered store of one forward pass's column-group subgrid stacks.

    Lifecycle: ``begin_fill()`` → ``put(meta, array)`` per group →
    ``end_fill()``; then ``complete`` is True iff every put landed (RAM
    or disk). Consumers iterate ``range(len(cache))`` with ``meta(k)`` /
    ``get(k)``, or read single subgrids with ``get_row``. ``reset()``
    returns to empty (deleting disk files).

    :param budget_bytes: host-RAM budget in bytes (default
        `spill_budget_bytes`)
    :param spill_dir: directory for over-budget entries; default
        ``SWIFTLY_SPILL_DIR``; None (and the variable unset or empty)
        disables disk backing: over-budget entries are evicted and the
        fill gives up
    """

    def __init__(self, budget_bytes=None, spill_dir=None):
        self.budget_bytes = (
            spill_budget_bytes() if budget_bytes is None
            else float(budget_bytes)
        )
        if spill_dir is None:
            spill_dir = os.environ.get("SWIFTLY_SPILL_DIR") or None
        self.spill_dir = spill_dir
        self._own_dir = None  # created lazily under spill_dir
        self._entries = []  # ("ram", ndarray) | ("disk", path)
        self._meta = []
        self.ram_bytes = 0
        self.disk_bytes = 0
        self.complete = False
        self.gave_up = False
        self.tag = None  # stream identity (set by begin_fill)
        # monotone facet-stack version; 0 = unversioned. Consumers that
        # captured a version (`parallel.streamed.CachedColumnFeed`)
        # refuse rows once it moves — a patched stream can never serve
        # through a feed indexed before the patch.
        self.stream_version = 0
        # one lock guards entry/meta/counter mutation
        self._lock = threading.Lock()
        self.counters = {
            "writes": 0,
            "evictions": 0,
            "ram_reads": 0,
            "disk_reads": 0,
            "fills": 0,
        }

    # -- concurrency --------------------------------------------------------

    def _bump(self, name, n=1):
        """Thread-safe counter increment."""
        with self._lock:
            self.counters[name] += n

    # -- fill ---------------------------------------------------------------

    def begin_fill(self, tag=None):
        """Start (re)recording a stream; drops any previous entries and
        sweeps orphaned ``.tmp`` files a crashed fill may have left.
        ``tag`` identifies the stream (e.g. the cover's shape) so a
        consumer can refuse a cache recorded for different inputs."""
        self._clear_entries()
        self._sweep_orphans()
        with self._lock:
            self.complete = False
            self.gave_up = False
            self.tag = tag
            self.counters["fills"] += 1
        _trace.instant("spill.begin_fill", cat="spill", tag=str(tag))

    def put(self, meta, array) -> bool:
        """Append one group's host array (+ its per-column metadata).

        Returns False when the entry was evicted (over budget, no disk
        backing) — the fill is then marked ``gave_up`` and ``end_fill``
        will leave the cache incomplete.
        """
        array = np.asarray(array)
        self._bump("writes")
        if self.ram_bytes + array.nbytes <= self.budget_bytes:
            with self._lock:
                self._entries.append(("ram", array))
                self.ram_bytes += array.nbytes
        elif self.spill_dir is not None:
            try:
                path = self._disk_write(len(self._entries), array)
            except OSError as exc:
                # the spill disk failed past its retries: drop to a
                # host-RAM-only cache for the rest of the run (this
                # over-budget entry evicts, so the fill gives up and
                # consumers compute instead: slower, never wrong)
                logger.warning(
                    "spill disk write failed (%s: %s); degrading to "
                    "host-RAM-only cache",
                    type(exc).__name__, exc,
                )
                _degrade.record("spill", "disk_to_ram",
                                f"{type(exc).__name__}: {exc}")
                self.spill_dir = None
                self._bump("evictions")
                self.gave_up = True
                _metrics.count("spill.evictions")
                return False
            with self._lock:
                self._entries.append(("disk", path))
                self.disk_bytes += array.nbytes
        else:
            self._bump("evictions")
            self.gave_up = True
            _metrics.count("spill.evictions")
            _trace.instant("spill.evict", cat="spill",
                           entry=len(self._entries),
                           nbytes=int(array.nbytes))
            return False
        with self._lock:
            self._meta.append(meta)
        return True

    def end_fill(self):
        """Seal the fill: the cache is complete iff nothing was evicted
        and at least one entry landed."""
        self.complete = bool(self._entries) and not self.gave_up
        _trace.instant(
            "spill.end_fill", cat="spill", entries=len(self._entries),
            complete=self.complete, ram_bytes=int(self.ram_bytes),
            disk_bytes=int(self.disk_bytes),
        )
        if self.gave_up:
            logger.warning(
                "spill cache gave up: stream exceeds the %.1f GiB RAM "
                "budget and no spill_dir is set — consumers will "
                "compute instead",
                self.budget_bytes / 2**30,
            )
        return self.complete

    # -- consume ------------------------------------------------------------

    def __len__(self):
        return len(self._meta)

    def meta(self, k):
        return self._meta[k]

    def get(self, k):
        """Entry k as a host ndarray (RAM hit or a full disk read). Reads
        retry transient failures with backoff; a read that stays failed
        raises (the streamed consumer then runs the forward instead: see
        `StreamedForward.stream_column_groups`)."""
        kind, payload = self._entries[k]

        def read():
            fault_point("spill.read")
            if kind == "ram":
                return payload
            with _metrics.stage("spill.disk_read") as st:
                arr = np.load(payload)
                st.bytes_moved = int(arr.nbytes)
            return arr

        out = retry_transient(read, site="spill.read")
        self._count_read(kind)
        return out

    def _count_read(self, kind):
        if kind == "ram":
            self._bump("ram_reads")
        else:
            self._bump("disk_reads")
            _metrics.count("spill.disk_reads")

    def get_row(self, k, index):
        """One sub-array of entry k (e.g. ``(c, s)`` of a [G, S, ...]
        group stack) without materialising the whole entry.

        The serving path (`parallel.streamed.CachedColumnFeed`) reads
        single subgrids out of recorded streams; RAM entries slice in
        place and disk entries go through a read-only memmap, so a
        one-subgrid request against a multi-GiB disk entry costs one
        row's IO, not the entry's.
        """
        kind, payload = self._entries[k]

        def read():
            fault_point("spill.get_row")
            if kind == "ram":
                return payload[index]
            with _metrics.stage("spill.disk_read") as st:
                row = np.array(np.load(payload, mmap_mode="r")[index])
                st.bytes_moved = int(row.nbytes)
            return row

        out = retry_transient(read, site="spill.get_row")
        self._count_read(kind)
        return out

    # -- maintenance --------------------------------------------------------

    def reset(self):
        """Back to empty (disk files deleted, orphaned ``.tmp`` files
        swept); counters are kept."""
        self._clear_entries()
        self._sweep_orphans()
        with self._lock:
            self.complete = False
            self.gave_up = False

    def stats(self):
        """JSON-ready summary."""
        return {
            "entries": len(self._entries),
            "complete": self.complete,
            "ram_bytes": int(self.ram_bytes),
            "disk_bytes": int(self.disk_bytes),
            "budget_bytes": int(self.budget_bytes),
            "disk_backed": self.spill_dir is not None,
            "stream_version": int(self.stream_version),
            **self.counters,
        }

    def _clear_entries(self):
        with self._lock:
            self._entries = []
            self._meta = []
            self.ram_bytes = 0
            self.disk_bytes = 0
            own_dir, self._own_dir = self._own_dir, None
        if own_dir is not None:
            shutil.rmtree(own_dir, ignore_errors=True)

    def _sweep_orphans(self):
        """Remove ``.tmp`` siblings a crashed fill left behind — in this
        cache's own dir and in stale ``swiftly_spill_*`` dirs of a dead
        process under the shared spill dir. An orphaned tmp is a torn
        write; left in place it wastes disk and, worse, a later rename
        collision could surface it as a truncated entry."""
        roots = []
        if self._own_dir is not None:
            roots.append(self._own_dir)
        if self.spill_dir is not None and os.path.isdir(self.spill_dir):
            roots.append(os.path.join(self.spill_dir, "swiftly_spill_*"))
        swept = 0
        for root in roots:
            for tmp in glob.glob(os.path.join(root, "*.npy.tmp")):
                try:
                    os.remove(tmp)
                    swept += 1
                except OSError:  # pragma: no cover - concurrent sweep
                    pass
        if swept:
            logger.warning(
                "swept %d orphaned spill .tmp file(s) from a crashed "
                "fill", swept,
            )
            _metrics.count("spill.orphans_swept", swept)

    def _disk_write(self, k, array):
        """Chunked memmap write of one entry under the spill dir: atomic
        (tmp sibling + rename: a crash mid-write can never leave a
        truncated ``group_*.npy`` that poisons a later read) and retried on
        transient I/O failure."""
        if self._own_dir is None:
            os.makedirs(self.spill_dir, exist_ok=True)
            self._own_dir = tempfile.mkdtemp(
                prefix="swiftly_spill_", dir=self.spill_dir
            )
        path = os.path.join(self._own_dir, f"group_{k:05d}.npy")

        def write():
            fault_point("spill.write")
            tmp = path + ".tmp"
            with _metrics.stage("spill.disk_write") as st:
                mm = np.lib.format.open_memmap(
                    tmp, mode="w+", dtype=array.dtype, shape=array.shape
                )
                row_bytes = max(1, array[:1].nbytes) if array.ndim else 1
                step = max(1, int(_DISK_CHUNK_BYTES // row_bytes))
                for s in range(0, array.shape[0], step):
                    mm[s : s + step] = array[s : s + step]
                mm.flush()
                del mm
                st.bytes_moved = int(array.nbytes)
            os.replace(tmp, path)
            return path

        return retry_transient(write, site="spill.write")

    def __del__(self):  # pragma: no cover - interpreter-shutdown path
        try:
            if self._own_dir is not None:
                shutil.rmtree(self._own_dir, ignore_errors=True)
        except Exception:
            pass
