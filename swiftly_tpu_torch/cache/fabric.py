"""Cache fabric: ONE recorded subgrid stream serving N elastic replicas.

A fleet whose replicas each hold a private `CachedColumnFeed` over a
private spill cache scales host memory N× with replica count, and a
facet update has to roll N caches. The fabric collapses that to a
two-tier design in the DaggerFFT shape (work units scheduled over one
shared, located data tier, arXiv 2601.12209):

* **L2** — one shared, versioned, spill-backed `utils.spill.SpillCache`
  holding the single resident copy of the recorded stream. Reads go
  through the cache's reader–writer gate, which composes with the delta
  engine's ``begin_patch`` mark (reads that race a patch bounce with
  `StreamMidPatch`) and with ``stream_version`` pinning (a view indexed
  at version v refuses rows once the version moves).
* **L1** — a small per-replica hot-row cache (`api.LRUCache`) fronting
  the L2: the zipf head of a serving workload is answered from the
  replica's own recently-promoted rows without touching the shared
  tier. L1 rows are version-pinned through the same gate as L2 reads
  and are cleared on every fabric `roll`.
* **Single-flight recompute dedup** — concurrent misses on the same
  key (`single_flight`) collapse to one compute: the first caller in
  wins the leadership and runs the closure, followers block on its
  result. The cache-vs-recompute trade this arbitrates is priced by
  `plan.price_cache_tier`.

One index (`parallel.streamed.CachedColumnFeed.build_index`) is built
per stream and shared by every view — N replicas do not re-scan the
stream metadata N times, and `roll` rebuilds it only when a facet
update actually re-recorded the stream (patch mode rewrites payloads in
place, so row coordinates survive).

The port of the JAX package's ``swiftly_tpu/cache/fabric.py``. Rows are
host numpy arrays (views of the recorded entries; a patch swaps entries
out of place, so a row already served is never rewritten under its
reader). ``request_key`` hashes mask bytes with Python's ``hash``: a
dedup identity within one process, never carried across processes.
"""

from __future__ import annotations

import threading

import numpy as np

from ..api import LRUCache
from ..obs import metrics as _metrics
from ..obs import recorder as _recorder
from ..obs import trace as _trace
from ..parallel.streamed import CachedColumnFeed

__all__ = ["FabricFeedView", "SharedStreamTier"]


class _Flight:
    """One in-flight single-flight computation."""

    __slots__ = ("event", "result", "error")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error = None


class FabricFeedView(CachedColumnFeed):
    """One replica's feed view over the shared stream tier.

    Quacks like the `CachedColumnFeed` the `serve.SubgridService`
    already consumes (``lookup``/``stream_version``/hit counters), but
    is a VIEW: the spill cache, the row index and the version pin are
    the fabric's — only the hot-row L1 and the counters are this
    replica's own. `lookup` order: serve gate (mid-patch / complete /
    version — an L1 row must never bypass it) → L1 → L2 row read with
    promotion into L1.
    """

    def __init__(self, fabric, replica_id, l1_rows=64):
        super().__init__(
            fabric.spill, index=fabric.index,
            stream_version=fabric.stream_version,
        )
        self.fabric = fabric
        self.replica_id = int(replica_id)
        self._l1_rows = int(l1_rows)
        self.l1 = LRUCache(self._l1_rows,
                           name=f"cache.l1.r{self.replica_id}")
        self.l1_hits = 0
        self.l2_hits = 0
        self.promotions = 0
        self.l1_evictions = 0

    def lookup(self, config):
        """Fabric lookup: gate, then L1, then the shared L2 (promoting
        the row). Raises LookupError exactly like the base feed —
        consumers keep their fall-back-to-compute contract."""
        self._gate()
        key = (config.off0, config.off1, config.size)
        row = self.l1.get(key)
        if row is not None:
            hit = self._index.get(key)
            if hit is not None and self._masks_match(config, hit[3]):
                self.l1_hits += 1
                self.hits += 1
                if _metrics.enabled():
                    _metrics.count("cache.l1_hits")
                return row
        row = super().lookup(config)
        if row is None:
            return None
        self.l2_hits += 1
        if _metrics.enabled():
            _metrics.count("cache.l2_hits")
        ev_key, _ev = self.l1.set(key, row)
        self.promotions += 1
        if ev_key is not None:
            self.l1_evictions += 1
            if _metrics.enabled():
                _metrics.count("cache.l1_evictions")
        return row

    def single_flight(self, key, fn):
        """Delegate to the fabric's fleet-wide dedup registry."""
        return self.fabric.single_flight(key, fn)

    def adopt(self, index, stream_version, *, clear_l1=True):
        """Roll this view to the fabric's post-update state: new shared
        index + version pin, L1 dropped (its rows were recorded under
        the superseded facet stack)."""
        self._index = index
        self.stream_version = int(stream_version)
        if clear_l1:
            self.l1 = LRUCache(self._l1_rows,
                               name=f"cache.l1.r{self.replica_id}")

    def stats(self):
        """JSON-ready per-view counters (one ``views`` row of the
        fabric's `SharedStreamTier.stats`)."""
        return {
            "replica": self.replica_id,
            "l1_hits": self.l1_hits,
            "l2_hits": self.l2_hits,
            "misses": self.misses,
            "evictions": self.evicted,
            "stale": self.stale,
            "promotions": self.promotions,
            "l1_evictions": self.l1_evictions,
            "l1_len": len(self.l1),
            "l1_rows": self._l1_rows,
        }


class SharedStreamTier:
    """The fabric: one spill-backed L2 + per-replica L1 views.

    :param spill: a COMPLETE `utils.spill.SpillCache` holding the
        recorded stream (typically `delta.IncrementalForward.spill`) —
        the fleet's single resident stream copy
    :param l1_rows: default hot-row capacity of each replica's L1
    """

    def __init__(self, spill, *, l1_rows=64):
        if not spill.complete:
            raise ValueError(
                "SharedStreamTier requires a COMPLETE spill cache; an "
                "incomplete stream would silently miss-serve every view"
            )
        self.spill = spill
        self.l1_rows = int(l1_rows)
        self.stream_version = int(spill.stream_version)
        self.index = CachedColumnFeed.build_index(spill)
        self.index_builds = 1
        self.rolls = 0
        self.dedup_hits = 0
        self.dedup_computes = 0
        self._views = {}
        self._retired_views = 0
        self._retired_counters = {
            k: 0
            for k in ("l1_hits", "l2_hits", "misses", "evictions",
                      "stale", "promotions", "l1_evictions")
        }
        self._lock = threading.Lock()
        self._inflight = {}  # key -> _Flight

    # -- views ---------------------------------------------------------------

    def view(self, replica_id, l1_rows=None):
        """The feed view for one replica (created on first use, stable
        after — an autoscaled replica that drains and returns gets its
        warm L1 back)."""
        with self._lock:
            v = self._views.get(replica_id)
            if v is None:
                v = FabricFeedView(
                    self, replica_id,
                    self.l1_rows if l1_rows is None else l1_rows,
                )
                self._views[replica_id] = v
            return v

    def drop_view(self, replica_id):
        """Forget a drained replica's view: its L1 is freed and its
        final counters fold into the retired ledger so fabric-wide
        stats survive scale-in."""
        with self._lock:
            view = self._views.pop(replica_id, None)
            if view is not None:
                row = view.stats()
                for k in ("l1_hits", "l2_hits", "misses", "evictions",
                          "stale", "promotions", "l1_evictions"):
                    self._retired_counters[k] += row[k]
                self._retired_views += 1
            return view

    @property
    def views(self):
        with self._lock:
            return dict(self._views)

    # -- facet updates -------------------------------------------------------

    def roll(self, report=None):
        """Adopt a landed facet update: ONE version re-pin + L1 sweep
        for the whole fleet (`ServeFleet.post_facet_update` calls this
        once instead of building N feeds). The shared index is rebuilt
        only when the update re-recorded the stream (``replay``); a
        ``patch`` rewrote payloads in place, so row coordinates — and
        the index — survive. Returns the adopted stream version."""
        with self._lock:
            mode = (report or {}).get("mode")
            old = self.stream_version
            self.stream_version = int(self.spill.stream_version)
            if mode not in ("patch", "noop"):
                self.index = CachedColumnFeed.build_index(self.spill)
                self.index_builds += 1
            moved = self.stream_version != old
            for v in self._views.values():
                v.adopt(self.index, self.stream_version,
                        clear_l1=moved)
            self.rolls += 1
        _trace.instant("cache.roll", cat="cache",
                       stream_version=self.stream_version,
                       mode=mode)
        _recorder.record("cache", "cache.roll",
                         f"v{self.stream_version} mode={mode}")
        if _metrics.enabled():
            _metrics.count("cache.rolls")
        return self.stream_version

    # -- single-flight recompute dedup --------------------------------------

    @staticmethod
    def request_key(config):
        """Dedup identity of one subgrid request: offsets, size AND
        mask content (configs that collide on coordinates but differ in
        masks are different results — same rule as the feed's
        ``_masks_match``)."""

        def digest(m):
            return None if m is None else hash(np.asarray(m).tobytes())

        return (
            int(config.off0), int(config.off1), int(config.size),
            digest(getattr(config, "mask0", None)),
            digest(getattr(config, "mask1", None)),
        )

    def single_flight(self, key, fn):
        """Run ``fn`` once per concurrently-requested ``key``: the
        first caller leads and computes; followers arriving before the
        leader finishes block and adopt its result (bit-identical — the
        engine is deterministic, so whose replica computed is
        unobservable). A leader failure re-raises to the leader and
        followers compute independently — dedup never converts one
        transient failure into N failures."""
        with self._lock:
            fl = self._inflight.get(key)
            leader = fl is None
            if leader:
                fl = _Flight()
                self._inflight[key] = fl
        if leader:
            try:
                fl.result = fn()
            except BaseException as exc:
                fl.error = exc
                raise
            finally:
                with self._lock:
                    self._inflight.pop(key, None)
                    self.dedup_computes += 1
                fl.event.set()
            return fl.result
        fl.event.wait()
        if fl.error is not None:
            return fn()
        with self._lock:
            self.dedup_hits += 1
        if _metrics.enabled():
            _metrics.count("cache.dedup_hits")
        return fl.result

    # -- export --------------------------------------------------------------

    def stats(self):
        """JSON-ready fabric block (a fleet record's ``cache`` block,
        validated by `obs.validate_fleet_artifact`):
        the single-resident-copy claim, fabric-wide hit/miss/eviction/
        promotion counters aggregated over views, the dedup ledger and
        per-view rows."""
        sp = self.spill.stats()
        with self._lock:
            views = [v.stats() for v in self._views.values()]
            dedup_hits = self.dedup_hits
            dedup_computes = self.dedup_computes
            retired = dict(self._retired_counters)
            retired_views = self._retired_views
        agg = {
            k: sum(v[k] for v in views) + retired[k]
            for k in ("l1_hits", "l2_hits", "misses", "evictions",
                      "stale", "promotions", "l1_evictions")
        }
        served = agg["l1_hits"] + agg["l2_hits"]
        lookups = served + agg["misses"]
        return {
            "resident_stream_copies": 1,
            "stream_entries": int(sp["entries"]),
            "stream_bytes": int(sp["ram_bytes"] + sp["disk_bytes"]),
            "stream_version": int(self.stream_version),
            "views": len(views),
            "retired_views": int(retired_views),
            "index_builds": int(self.index_builds),
            "rolls": int(self.rolls),
            **agg,
            "hit_ratio": round(served / lookups, 4) if lookups else 0.0,
            "l1_hit_share": (
                round(agg["l1_hits"] / served, 4) if served else 0.0
            ),
            "dedup_hits": int(dedup_hits),
            "dedup_computes": int(dedup_computes),
            "per_view": sorted(views, key=lambda v: v["replica"]),
        }
