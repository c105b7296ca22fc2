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

Incremental facet updates (`delta.IncrementalForward`) rewrite entries
through ``patch_entry`` inside a ``begin_patch`` / ``end_patch`` window:
a reader–writer gate drains in-flight row reads before the rewrite and
bounces new ones with `StreamMidPatch` (a LookupError, the serving path's
fall-back-to-compute signal) until the window closes.

``export_manifest`` forces every entry to its atomic on-disk form and
describes the stream for a reader in another process
(`serve.procfleet.SharedSpillReader`).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import glob
import logging
import os
import shutil
import tempfile
import threading
import time

import numpy as np

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..resilience import degrade as _degrade
from ..resilience.faults import fault_point
from ..resilience.retry import retry_transient

__all__ = ["SpillCache", "StreamMidPatch", "spill_budget_bytes"]

logger = logging.getLogger(__name__)

# begin_patch waits this long for in-flight readers to drain before
# proceeding anyway (readers are single-row copies; a wait this long
# means a reader thread died mid-read — blocking the patch forever
# would wedge the whole update path behind a corpse)
_PATCH_DRAIN_TIMEOUT_S = 5.0


class StreamMidPatch(LookupError):
    """A row read raced ``begin_patch``: the stream is mid-rewrite.

    A LookupError subclass so serving-path consumers
    (`parallel.streamed.CachedColumnFeed`, `serve.SubgridService`)
    treat it exactly like a stale-feed bounce — fall back to compute,
    retry once the patch window closes."""

# chunk size for disk-backed writes: bounds the per-write dirty-page
# burst while keeping the stream sequential (memmap-friendly)
_DISK_CHUNK_BYTES = 256e6

# a patch adds an entry's correction on this many host threads (numpy
# releases the GIL in its loops)
_PATCH_THREADS = max(1, min(8, os.cpu_count() or 1))


def _parallel_add(a, b):
    """``a + b`` into a new array, in chunks on `_PATCH_THREADS` threads
    (the new pages are touched in parallel too): the values of
    ``a + b``."""
    out = np.empty(a.shape, np.result_type(a, b))
    fa, fb, fo = a.reshape(-1), b.reshape(-1), out.reshape(-1)
    step = max(1, -(-fo.size // _PATCH_THREADS))
    spans = [(i, min(i + step, fo.size)) for i in range(0, fo.size, step)]
    if len(spans) <= 1:
        np.add(fa, fb, out=fo)
        return out
    with concurrent.futures.ThreadPoolExecutor(len(spans)) as pool:
        list(pool.map(lambda ij: np.add(fa[ij[0]:ij[1]], fb[ij[0]:ij[1]],
                                        out=fo[ij[0]:ij[1]]), spans))
    return out


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
    :param policy: the compiled plan's spill-policy dict
        (`plan.SpillPolicy.make_cache`), stamped into `stats`
    """

    def __init__(self, budget_bytes=None, spill_dir=None, policy=None):
        self.budget_bytes = (
            spill_budget_bytes() if budget_bytes is None
            else float(budget_bytes)
        )
        if spill_dir is None:
            spill_dir = os.environ.get("SWIFTLY_SPILL_DIR") or None
        self.spill_dir = spill_dir
        self.policy = dict(policy) if policy else None
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
        # True while a patcher rewrites entries (begin_patch/end_patch);
        # feeds refuse lookups for the whole window, so a concurrent
        # reader can never observe a partially-patched stream
        self.patching = False
        # one lock guards entry/meta/counter mutation; the condition is
        # the reader–writer gate (`begin_patch` drains in-flight row
        # reads, new reads bounce with `StreamMidPatch` until
        # `end_patch`). The patcher's own thread passes the gate:
        # `patch_entry` reads the base entry inside its window. Nothing
        # holds the lock across a device sync: readers copy host rows.
        self._lock = threading.RLock()
        self._readers = threading.Condition(self._lock)
        self._active_readers = 0
        self._patcher_tid = None
        self.counters = {
            "writes": 0,
            "evictions": 0,
            "ram_reads": 0,
            "disk_reads": 0,
            "fills": 0,
            "patches": 0,
            "exported_entries": 0,
        }

    # -- concurrency --------------------------------------------------------

    def _bump(self, name, n=1):
        """Thread-safe counter increment."""
        with self._lock:
            self.counters[name] += n

    @contextlib.contextmanager
    def _read_gate(self):
        """Row-read side of the reader–writer gate: registers the read
        so `begin_patch` can drain it, and bounces reads that arrive
        inside a patch window (`StreamMidPatch`, unless the reader is
        the patcher, which reads base entries mid-window)."""
        me = threading.get_ident()
        with self._readers:
            if self.patching and me != self._patcher_tid:
                raise StreamMidPatch(
                    "stream is mid-patch (begin_patch/end_patch window); "
                    "fall back to compute and retry after the update"
                )
            self._active_readers += 1
        try:
            yield
        finally:
            with self._readers:
                self._active_readers -= 1
                if self._active_readers == 0:
                    self._readers.notify_all()

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
        with self._read_gate():
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

    def entry_shape(self, k):
        """Entry k's array shape, without reading a disk entry's data."""
        kind, payload = self._entries[k]
        if kind == "ram":
            return payload.shape
        return np.load(payload, mmap_mode="r").shape

    def get_row(self, k, index):
        """One sub-array of entry k (e.g. ``(c, s)`` of a [G, S, ...]
        group stack) without materialising the whole entry.

        The serving path (`parallel.streamed.CachedColumnFeed`) reads
        single subgrids out of recorded streams; RAM entries slice in
        place and disk entries go through a read-only memmap, so a
        one-subgrid request against a multi-GiB disk entry costs one
        row's IO, not the entry's. A read that races `begin_patch`
        raises `StreamMidPatch`, and the patch waits for in-flight reads.
        """
        with self._read_gate():
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

    # -- patch --------------------------------------------------------------

    def begin_patch(self):
        """Mark the cache mid-patch: feeds refuse lookups while the mark
        is set, so a live feed never observes a partially-patched stream
        (its consumers compute at their pinned version). The patcher
        clears the mark with `end_patch` after re-stamping
        ``stream_version``.

        Writer side of the reader–writer gate: after raising the mark
        (which bounces new row reads) it waits up to
        ``_PATCH_DRAIN_TIMEOUT_S`` for in-flight reads to drain.
        """
        deadline = time.monotonic() + _PATCH_DRAIN_TIMEOUT_S
        with self._readers:
            self.patching = True
            self._patcher_tid = threading.get_ident()
            while self._active_readers:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    logger.warning(
                        "begin_patch proceeding with %d reader(s) still "
                        "in flight after %.1fs — a reader thread looks "
                        "dead", self._active_readers,
                        _PATCH_DRAIN_TIMEOUT_S,
                    )
                    break
                self._readers.wait(timeout=remaining)
        _trace.instant("spill.begin_patch", cat="spill")

    def end_patch(self):
        """Clear the mid-patch mark (see `begin_patch`)."""
        with self._readers:
            self.patching = False
            self._patcher_tid = None
            self._readers.notify_all()
        _trace.instant("spill.end_patch", cat="spill")

    def patch_entry(self, k, delta):
        """Add ``delta`` into entry k (`delta.IncrementalForward`'s
        cache patch).

        Atomic and idempotent per entry: a RAM entry is patched out of
        place (the retried closure reads the unmodified base, computes
        ``base + delta`` fresh and swaps the entry reference under the
        lock, so a retry can never apply twice); a disk entry is read,
        added and rewritten through the fill's tmp sibling + rename, so
        a crash mid-patch leaves the old entry intact. A failure that
        outlives the retries raises; the caller degrades to a full
        re-record.
        """
        with self._lock:
            kind, payload = self._entries[k]
        delta = np.asarray(delta)
        base = self.get(k)
        if base.shape != delta.shape:
            raise ValueError(
                f"patch shape {delta.shape} != entry {k} shape "
                f"{base.shape}"
            )
        add = np.ascontiguousarray(delta.astype(base.dtype, copy=False))
        if kind == "ram":

            def write():
                fault_point("spill.write")
                with _metrics.stage("spill.patch") as st:
                    new = _parallel_add(np.ascontiguousarray(payload), add)
                    with self._lock:
                        self._entries[k] = ("ram", new)
                    st.bytes_moved = int(add.nbytes)

            retry_transient(write, site="spill.write")
        else:
            with _metrics.stage("spill.patch") as st:
                self._disk_write(k, base + add)
                st.bytes_moved = int(add.nbytes)
        self._bump("patches")
        _metrics.count("spill.patches")
        _trace.instant("spill.patch", cat="spill", entry=int(k),
                       nbytes=int(add.nbytes))

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
        """JSON-ready summary (with the plan's ``policy`` when one made
        the cache)."""
        out = {
            "entries": len(self._entries),
            "complete": self.complete,
            "ram_bytes": int(self.ram_bytes),
            "disk_bytes": int(self.disk_bytes),
            "budget_bytes": int(self.budget_bytes),
            "disk_backed": self.spill_dir is not None,
            "stream_version": int(self.stream_version),
            **self.counters,
        }
        if self.policy is not None:
            out["policy"] = dict(self.policy)
        return out

    def export_manifest(self):
        """Describe this cache for a reader in ANOTHER process.

        Forces every RAM-resident entry down to its atomic on-disk form
        (`_disk_write`: tmp sibling + rename, so a reader can never map
        a torn entry) and returns a picklable manifest —
        ``{dir, entries, meta, stream_version}`` — that
        `serve.procfleet.SharedSpillReader` turns back into a read-only
        `get_row` surface over memory-mapped files. The entry files are
        immutable once exported; liveness state (``patching`` /
        ``complete`` / ``stream_version``) travels separately through
        the fleet's stream-state file so the owning process can gate
        cross-process readers exactly like in-process ones.
        """
        if not self.complete:
            raise RuntimeError("export_manifest requires a complete cache")
        if self.spill_dir is None:
            raise RuntimeError(
                "export_manifest requires a disk-backed cache (spill_dir)")
        with self._lock:
            if self.patching:
                raise RuntimeError("export_manifest mid-patch")
            for k, (kind, payload) in enumerate(self._entries):
                if kind == "ram":
                    path = self._disk_write(k, payload)
                    self._entries[k] = ("disk", path)
                    self.ram_bytes -= int(payload.nbytes)
                    self.disk_bytes += int(payload.nbytes)
                    self._bump("exported_entries")
            entries = [payload for (_kind, payload) in self._entries]
            meta = list(self._meta)
        _metrics.count("spill.manifest_exports")
        return {
            "dir": self._own_dir,
            "entries": entries,
            "meta": meta,
            "stream_version": int(self.stream_version),
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
