"""Streaming forward/backward API on one device.

The torch twin of the JAX package's ``swiftly_tpu/api.py``.
`SwiftlyForward` streams subgrids out of a set of facets; `SwiftlyBackward`
streams subgrids in and accumulates facets. Both bound their working set:

* prepared facets (`BF_Fs`) are computed once and reused for every subgrid;
* per-column intermediates are cached/accumulated in an LRU keyed by the
  subgrid column offset `off0` — forward recomputes on miss, backward folds
  the evicted column into the per-facet accumulators;
* a flight queue caps the number of in-flight device computations (CUDA
  work is asynchronous; the queue waits on a CUDA event of the oldest
  admitted work).

`SwiftlyForward.all_subgrids` and `backward_all` compute a whole cover in
one call each: the fused round trip that the main path runs.

Telemetry, as the JAX package's (recorded only while ``obs.metrics`` is
enabled): the LRUs count ``<name>.hit`` / ``<name>.miss``; the stages
``fwd.prepare_facets``, ``fwd.fused_forward``, ``bwd.fused_backward`` and
``bwd.finish`` are timed, and so are the flight queues' waits
(``fwd.drain`` / ``bwd.drain``); `last_dispatch_path` (and the gauge
``fwd.dispatch_path``) says which path served the latest batched
request.

Subgrids may be produced/consumed in any order — every accumulation is a
sum of linear contributions.
"""

from __future__ import annotations

import contextlib
import logging
from collections import deque

import numpy as np
import torch

from .models.config import FacetConfig, SubgridConfig, SwiftlyConfig
from .models.covers import (
    make_full_facet_cover,
    make_full_subgrid_cover,
    make_sparse_facet_cover,
    sparse_fov_cover_offsets,
)
from .ops.oracle import (
    SparseRealFacet,
    make_facet_from_sources,
    make_real_facet_plane_from_sources,
    make_sparse_real_facet_from_sources,
    make_subgrid_from_sources,
)
from .obs import metrics as _metrics
from .parallel import batched

log = logging.getLogger(__name__)

__all__ = [
    "FacetConfig",
    "SubgridConfig",
    "SwiftlyConfig",
    "SwiftlyForward",
    "SwiftlyBackward",
    "FlightQueue",
    "LRUCache",
    "backward_all",
    "check_facet",
    "check_residual",
    "check_subgrid",
    "last_dispatch_path",
    "make_facet",
    "make_full_facet_cover",
    "make_full_subgrid_cover",
    "make_real_facet",
    "make_sparse_facet",
    "make_sparse_facet_cover",
    "make_subgrid",
    "sparse_fov_cover_offsets",
]


# ---------------------------------------------------------------------------
# Oracle helpers (host-side)
# ---------------------------------------------------------------------------


def make_facet(image_size, facet_config, sources):
    """Build a facet's data from a source list (test/demo input)."""
    return make_facet_from_sources(
        sources,
        image_size,
        facet_config.size,
        [facet_config.off0, facet_config.off1],
        [facet_config.mask0, facet_config.mask1],
    )


def make_real_facet(image_size, facet_config, sources, dtype=None):
    """`make_facet` as a real plane built pointwise (float32 by default):
    ``== make_facet(...).real`` without the dense complex intermediate,
    the input of large-N streamed runs (a 32k facet is 2 GB complex128 but
    0.5 GB as its real float32 plane)."""
    kwargs = {} if dtype is None else {"dtype": dtype}
    return make_real_facet_plane_from_sources(
        sources,
        image_size,
        facet_config.size,
        [facet_config.off0, facet_config.off1],
        [facet_config.mask0, facet_config.mask1],
        **kwargs,
    )


def make_sparse_facet(image_size, facet_config, sources, dtype=None):
    """`make_facet` as a `SparseRealFacet` (pixel coordinates and values,
    float32 by default): the input of the streamed forward at 128k, which
    synthesises the plane on the device from these pixels instead of
    uploading it. ``densify() == make_facet(...).real``."""
    kwargs = {} if dtype is None else {"dtype": dtype}
    return make_sparse_real_facet_from_sources(
        sources,
        image_size,
        facet_config.size,
        [facet_config.off0, facet_config.off1],
        [facet_config.mask0, facet_config.mask1],
        **kwargs,
    )

def make_subgrid(image_size, sg_config, sources):
    """Build a subgrid's data by direct DFT (test/demo input)."""
    return make_subgrid_from_sources(
        sources,
        image_size,
        sg_config.size,
        [sg_config.off0, sg_config.off1],
        [sg_config.mask0, sg_config.mask1],
    )


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def check_facet(image_size, facet_config, approx_facet, sources):
    """RMS error of a computed facet vs the analytic source model."""
    facet = make_facet(image_size, facet_config, sources)
    return float(np.sqrt(np.mean(np.abs(facet - _host(approx_facet)) ** 2)))


def check_subgrid(image_size, sg_config, approx_subgrid, sources):
    """RMS error of a computed subgrid vs the direct-DFT source model."""
    approx_subgrid = _host(approx_subgrid)
    subgrid = make_subgrid_from_sources(
        sources,
        image_size,
        approx_subgrid.shape[0],
        [sg_config.off0, sg_config.off1],
        [sg_config.mask0, sg_config.mask1],
    )
    return float(np.sqrt(np.mean(np.abs(subgrid - approx_subgrid) ** 2)))


def check_residual(residual):
    """RMS of a residual array."""
    return float(np.sqrt(np.mean(np.abs(_host(residual)) ** 2)))


# ---------------------------------------------------------------------------
# Working-set control
# ---------------------------------------------------------------------------


class LRUCache:
    """Small LRU: bounds the number of live column buffers.

    `set` returns the evicted (key, value) once capacity is exceeded —
    eviction is what triggers the backward fold step.

    Hit/miss counters (``<name>.hit`` / ``<name>.miss``, recorded only
    while metrics are enabled) show how well a workload's column locality
    is used.
    """

    def __init__(self, capacity: int, name: str = "lru"):
        self.capacity = capacity
        self._store = {}  # insertion-ordered; order == recency
        self._hit_name = f"{name}.hit"
        self._miss_name = f"{name}.miss"

    def get(self, key):
        """Return the cached value and refresh its recency, or None."""
        if key not in self._store:
            if _metrics.enabled():
                _metrics.count(self._miss_name)
            return None
        if _metrics.enabled():
            _metrics.count(self._hit_name)
        value = self._store.pop(key)
        self._store[key] = value
        return value

    def keys(self):
        """Cached keys, oldest first (recency order)."""
        return list(self._store)

    def set(self, key, value):
        """Insert/refresh; returns (evicted_key, evicted_value) or
        (None, None)."""
        self._store.pop(key, None)
        self._store[key] = value
        if len(self._store) <= self.capacity:
            return None, None
        oldest = next(iter(self._store))
        return oldest, self._store.pop(oldest)

    def pop_all(self):
        """Drain the cache oldest-first, yielding (key, value)."""
        while self._store:
            oldest = next(iter(self._store))
            yield oldest, self._store.pop(oldest)

    def __len__(self):
        return len(self._store)


# Which path served the latest batched forward request: a silent fall
# back to the per-subgrid loop (the numpy backend) would give numbers
# nobody can read, so the path is recorded (gauge ``fwd.dispatch_path``,
# counter ``fwd.path.<path>`` and `last_dispatch_path`) and the fallback
# warns once per reason.
_LAST_DISPATCH_PATH = None
_FALLBACK_WARNED = set()


def last_dispatch_path():
    """The path the most recent batched-forward call executed:
    ``"batched-column"`` or the host ``"per-subgrid-loop"`` fallback (None
    before any call)."""
    return _LAST_DISPATCH_PATH


def _record_dispatch_path(path, fallback_reason=None):
    global _LAST_DISPATCH_PATH
    _LAST_DISPATCH_PATH = path
    if _metrics.enabled():
        _metrics.gauge("fwd.dispatch_path", path)
        _metrics.count(f"fwd.path.{path}")
    if fallback_reason and fallback_reason not in _FALLBACK_WARNED:
        _FALLBACK_WARNED.add(fallback_reason)
        log.warning(
            "get_subgrid_tasks falling back to the per-subgrid loop (%s): "
            "O(subgrids) dispatches instead of O(columns)", fallback_reason,
        )
        _metrics.event("fwd.path_fallback", path=path,
                       reason=fallback_reason)


class FlightQueue:
    """Bounds in-flight asynchronous device work, counted in logical tasks
    (subgrids), not bytes.

    CUDA kernels run asynchronously to the host; unbounded dispatch can
    enqueue arbitrarily much work. Each `admit` records one CUDA event on
    the current stream of the admitted tensors' device, once per admitted
    task; past `depth` tasks, the oldest event is waited on
    (``Event.synchronize``). Host (CPU) tensors are complete when they are
    returned and hold no event. With `stage`, the waits are timed as that
    ``obs.metrics`` stage (the host's one view of the device's progress).
    """

    def __init__(self, depth: int, stage: str | None = None):
        self.depth = depth
        self.stage = stage
        self._inflight = deque()

    @staticmethod
    def _event(arrays):
        for a in arrays:
            if isinstance(a, torch.Tensor) and a.is_cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(a.device))
                return event
        return None

    def admit(self, arrays):
        """Register newly dispatched arrays, blocking if the queue is full."""
        if not isinstance(arrays, (list, tuple)):
            arrays = [arrays]
        event = self._event(arrays)
        self._inflight.extend([event] * len(arrays))
        if len(self._inflight) > self.depth:
            with self._timed():
                while len(self._inflight) > self.depth:
                    self._ready(self._inflight.popleft())

    def _timed(self):
        return (_metrics.stage(self.stage) if self.stage
                else contextlib.nullcontext())

    @staticmethod
    def _ready(event):
        if event is not None:
            event.synchronize()

    def drain(self):
        """Block until all in-flight work completes."""
        if not self._inflight:
            return
        with self._timed():
            while self._inflight:
                self._ready(self._inflight.popleft())

    def __len__(self):
        return len(self._inflight)


# ---------------------------------------------------------------------------
# Facet stacking
# ---------------------------------------------------------------------------


class _FacetStack:
    """Stacked facet metadata: offsets and realised masks as arrays.

    ``n_real`` and ``n_total`` count the facets (equal: the port runs on
    one device, so the stack is never padded to a mesh size)."""

    def __init__(self, facet_configs):
        if not facet_configs:
            raise ValueError("At least one facet is required")
        sizes = {cfg.size for cfg in facet_configs}
        if len(sizes) != 1:
            raise ValueError("All facets must share one size")
        self.size = sizes.pop()
        self.configs = list(facet_configs)
        self.n_real = self.n_total = len(self.configs)

        def mask_row(mask):
            return np.ones(self.size) if mask is None else np.asarray(mask)

        self.offs0 = np.array([c.off0 for c in facet_configs])
        self.offs1 = np.array([c.off1 for c in facet_configs])
        self.masks0 = np.stack([mask_row(c.mask0) for c in facet_configs])
        self.masks1 = np.stack([mask_row(c.mask1) for c in facet_configs])

    def __len__(self):
        return len(self.configs)


def _subgrid_masks(sg_config):
    size = sg_config.size
    m0 = np.ones(size) if sg_config.mask0 is None else np.asarray(sg_config.mask0)
    m1 = np.ones(size) if sg_config.mask1 is None else np.asarray(sg_config.mask1)
    return m0, m1


def _group_columns(subgrid_configs, key=lambda sg: sg, require_one_size=False):
    """Group items by subgrid column offset (off0), preserving order.

    :param key: maps an item to its SubgridConfig
    :param require_one_size: raise on mixed subgrid sizes
    :return: (groups, rectangular) — groups is {off0: [item, ...]};
        rectangular is True when all subgrids share one size and all
        columns have equal length
    """
    groups = {}
    for item in subgrid_configs:
        groups.setdefault(key(item).off0, []).append(item)
    if not groups:
        raise ValueError("At least one subgrid is required")
    sizes = {key(item).size for col in groups.values() for item in col}
    if require_one_size and len(sizes) != 1:
        raise ValueError(
            f"All subgrids must share one size for stacked output "
            f"(got sizes {sorted(sizes)})"
        )
    rectangular = (
        len(sizes) == 1 and len({len(v) for v in groups.values()}) == 1
    )
    return groups, rectangular


def _pad_ragged_columns(groups, size, make_pad=None):
    """Pad ragged columns ({off0: [(index, SubgridConfig), ...]}) to equal
    length with zero-mask entries (index None) appended at the end.

    Exact by construction: a zero mask zeroes a padded entry's output
    (forward), and zero data contributes zeros to every linear
    accumulation (backward).
    """
    max_S = max(len(col) for col in groups.values())
    zero_mask = np.zeros(size)
    for off0, col in groups.items():
        first = col[0][1] if make_pad is None else None
        while len(col) < max_S:
            if make_pad is not None:
                col.append(make_pad(off0, col[0]))
            else:
                col.append(
                    (None, SubgridConfig(off0, first.off1, size, zero_mask,
                                         zero_mask))
                )
    return max_S


# ---------------------------------------------------------------------------
# Forward: facets -> subgrids
# ---------------------------------------------------------------------------


class SwiftlyForward:
    """Stream subgrids out of a facet set.

    :param swiftly_config: SwiftlyConfig
    :param facet_tasks: list of (FacetConfig, facet_data) pairs; the data is
        a numpy or torch array (complex, or planar for the planar backend)
        or a callable returning one. Facets move to the device one at a
        time when they are first prepared.
    :param lru_forward: number of column intermediates kept resident
    :param queue_size: in-flight computation cap
    """

    def __init__(self, swiftly_config, facet_tasks, lru_forward=1,
                 queue_size=20):
        self.config = swiftly_config
        self.core = swiftly_config.core
        self.lru = LRUCache(lru_forward)
        self.queue = FlightQueue(queue_size, stage="fwd.drain")
        # column intermediates computed (LRU misses of `_get_columns`)
        self.columns_extracted = 0
        self._set_facets(facet_tasks)

    def _set_facets(self, facet_tasks):
        self.stack = _FacetStack([cfg for cfg, _ in facet_tasks])
        # a sparse descriptor is densified when its facet is prepared
        self._facet_data = [
            data.densify if isinstance(data, SparseRealFacet) else data
            for _, data in facet_tasks
        ]
        self._BF_Fs = None

    def adopt_facet_tasks(self, facet_tasks):
        """Swap in a new facet stack: drops the prepared facet planes
        and the column LRU, and rebuilds the stack descriptors, so every
        later subgrid computes from the new data. The serve path's update
        hook (`serve.SubgridService.post_facet_update`) calls this so its
        compute fallback — feed misses, evicted rows, stale feeds — never
        serves a superseded stack. Callables stay lazy and sparse
        descriptors are densified when their facet is prepared."""
        self._set_facets(facet_tasks)
        self.lru = LRUCache(self.lru.capacity)
        return self

    def _get_BF_Fs(self):
        if self._BF_Fs is None:
            with _metrics.stage("fwd.prepare_facets"):
                self._BF_Fs = batched.prepare_facets_batch(
                    self.core, self._facet_data, self.stack.offs0
                )
        return self._BF_Fs

    def _get_columns(self, off0):
        cols = self.lru.get(off0)
        if cols is None:
            cols = batched.extract_columns_batch(
                self.core, self._get_BF_Fs(), off0, self.stack.offs1
            )
            self.columns_extracted += 1
            self.lru.set(off0, cols)
        return cols

    def get_subgrid_task(self, subgrid_config):
        """Compute one subgrid (an asynchronous device tensor)."""
        cols = self._get_columns(subgrid_config.off0)
        subgrid = batched.subgrid_from_columns_batch(
            self.core,
            cols,
            self.stack.offs0,
            self.stack.offs1,
            subgrid_config.off0,
            subgrid_config.off1,
            subgrid_config.size,
            _subgrid_masks(subgrid_config),
        )
        self.queue.admit([subgrid])
        return subgrid

    def get_subgrid_tasks(self, subgrid_configs):
        """Compute many subgrids, one batched call per column.

        Groups the requests by column offset (off0) and computes each
        column's subgrids in one call — same results as mapping
        `get_subgrid_task`, with far fewer launches. Returns the subgrids
        in input order.
        """
        if self.core.backend == "numpy":
            _record_dispatch_path("per-subgrid-loop",
                                  "the numpy backend has no batched path")
            return [self.get_subgrid_task(sg) for sg in subgrid_configs]
        _record_dispatch_path("batched-column")
        groups = {}  # (off0, size) -> list of input indices
        for i, sg in enumerate(subgrid_configs):
            groups.setdefault((sg.off0, sg.size), []).append(i)
        results = [None] * len(subgrid_configs)
        for (off0, size), idxs in groups.items():
            cols = self._get_columns(off0)
            sg_offs = [
                (subgrid_configs[i].off0, subgrid_configs[i].off1)
                for i in idxs
            ]
            masks = [_subgrid_masks(subgrid_configs[i]) for i in idxs]
            stacked = batched.subgrids_from_columns_batch(
                self.core, cols, self.stack.offs0, self.stack.offs1, sg_offs,
                size, masks,
            )
            # One queue slot per subgrid, not per call.
            self.queue.admit([stacked] * len(idxs))
            for k, i in enumerate(idxs):
                results[i] = stacked[k]
        return results

    def all_subgrids(self, subgrid_configs):
        """Every requested subgrid in one call: a stacked tensor
        [n, xA, xA(, 2)] in request order.

        Loops over the cover's columns, each column's subgrids in one
        batched call (`forward_all_batch`). Ragged covers are padded with
        zero-mask entries (exact); only the numpy backend falls back to
        per-column streaming. All subgrids must share one size (the output
        is stacked); raises ValueError otherwise.

        The prepared facet stack ([F, yN, yB], the largest forward
        intermediate) is released when the call returns, so a following
        backward does not hold it beside its accumulator; a later request
        on this object prepares the facets again.
        """
        subgrid_configs = list(subgrid_configs)
        groups, rectangular = _group_columns(
            enumerate(subgrid_configs),
            key=lambda item: item[1],
            require_one_size=True,
        )
        if self.core.backend == "numpy":
            tasks = self.get_subgrid_tasks(subgrid_configs)
            return np.stack([np.asarray(t) for t in tasks])
        size = subgrid_configs[0].size
        if not rectangular:
            _pad_ragged_columns(groups, size)
        col_offs0 = list(groups)
        max_S = len(groups[col_offs0[0]])
        sg_offs1, masks0, masks1, rows = [], [], [], {}
        for c, off0 in enumerate(col_offs0):
            col = groups[off0]
            for s, (i, _) in enumerate(col):
                if i is not None:
                    rows[i] = c * max_S + s
            sg_offs1.append([sg.off1 for _, sg in col])
            ms = [_subgrid_masks(sg) for _, sg in col]
            masks0.append([m[0] for m in ms])
            masks1.append([m[1] for m in ms])
        fused_flops = 0
        if _metrics.enabled():
            from .utils.flops import forward_batched_flops

            fused_flops = forward_batched_flops(
                self.core, n_facets=self.stack.n_real,
                facet_size=self.stack.size, n_columns=len(col_offs0),
                subgrids_per_column=max_S, subgrid_size=size,
            )
            _metrics.count("fwd.subgrids", len(subgrid_configs))
        BF_Fs = self._get_BF_Fs()
        with _metrics.stage("fwd.fused_forward", flops=fused_flops):
            stacked = batched.forward_all_batch(
                self.core, BF_Fs, self.stack.offs0, self.stack.offs1,
                col_offs0, sg_offs1, size, masks0, masks1,
            )
        flat = stacked.reshape((len(col_offs0) * max_S,) + stacked.shape[2:])
        n = len(subgrid_configs)
        order = [rows[i] for i in range(n)]
        if order != list(range(n)):
            flat = flat.index_select(
                0, torch.as_tensor(order, device=flat.device)
            )
        elif flat.shape[0] != n:  # identity order but tail padding rows
            flat = flat[:n]
        self.queue.admit([flat] * n)
        self._BF_Fs = None
        return flat


# ---------------------------------------------------------------------------
# Backward: subgrids -> facets
# ---------------------------------------------------------------------------


class SwiftlyBackward:
    """Stream subgrids in; accumulate and finish facets.

    :param swiftly_config: SwiftlyConfig
    :param facets_config_list: FacetConfigs describing the output facets
    :param lru_backward: number of column accumulators kept live
    :param queue_size: in-flight computation cap
    """

    def __init__(self, swiftly_config, facets_config_list, lru_backward=1,
                 queue_size=20):
        self.config = swiftly_config
        self.core = swiftly_config.core
        self.stack = _FacetStack(facets_config_list)
        self.lru = LRUCache(lru_backward)
        self.queue = FlightQueue(queue_size, stage="bwd.drain")
        self._MNAF_BMNAFs = None
        self._finished = False

    def _zeros(self, shape):
        core = self.core
        if core.backend == "numpy":
            return np.zeros(shape, dtype=complex)
        if core.backend == "planar":
            shape = shape + (2,)
        return torch.zeros(shape, dtype=core.dtype, device=core.device)

    def add_new_subgrid_task(self, subgrid_config, subgrid_data):
        """Fold one subgrid into the streaming accumulators."""
        if self._finished:
            raise RuntimeError("finish() was already called")
        core, stack = self.core, self.stack
        off0, off1 = subgrid_config.off0, subgrid_config.off1
        NAF_NAFs = batched.split_subgrid_batch(
            core, subgrid_data, off0, off1, stack.offs0, stack.offs1
        )
        col = self.lru.get(off0)
        if col is None:
            col = self._zeros((len(stack), core.xM_yN_size, core.yN_size))
        col = batched.accumulate_column_batch(core, NAF_NAFs, off1, col)
        evicted_off0, evicted = self.lru.set(off0, col)
        if evicted is not None:
            self._fold_column(evicted_off0, evicted)
        self.queue.admit([col])
        return col

    def add_new_subgrid_tasks(self, tasks):
        """Fold many (subgrid_config, subgrid_data) pairs, one batched call
        per column. Equivalent to mapping `add_new_subgrid_task`."""
        if self._finished:
            raise RuntimeError("finish() was already called")
        if self.core.backend == "numpy":
            for sg_config, data in tasks:
                self.add_new_subgrid_task(sg_config, data)
            return
        core, stack = self.core, self.stack
        groups = {}
        for sg_config, data in tasks:
            groups.setdefault((sg_config.off0, sg_config.size), []).append(
                (sg_config, data)
            )
        for (off0, _size), group in groups.items():
            col = self.lru.get(off0)
            if col is None:
                col = self._zeros((len(stack), core.xM_yN_size, core.yN_size))
            col = batched.split_accumulate_batch(
                core, [d for _, d in group],
                [(sg.off0, sg.off1) for sg, _ in group],
                stack.offs0, stack.offs1, col,
            )
            evicted_off0, evicted = self.lru.set(off0, col)
            if evicted is not None:
                self._fold_column(evicted_off0, evicted)
            self.queue.admit([col] * len(group))

    def _fold_column(self, off0, col):
        core, stack = self.core, self.stack
        if self._MNAF_BMNAFs is None:
            self._MNAF_BMNAFs = self._zeros(
                (len(stack), core.yN_size, stack.size)
            )
        self._MNAF_BMNAFs = batched.accumulate_facet_batch(
            core, col, off0, stack.offs1, stack.masks1, stack.size,
            self._MNAF_BMNAFs,
        )
        self.queue.admit([self._MNAF_BMNAFs])

    def finish(self):
        """Drain accumulators and return the finished facet stack
        [F, yB, yB]."""
        for off0, col in self.lru.pop_all():
            self._fold_column(off0, col)
        if self._MNAF_BMNAFs is None:
            self._MNAF_BMNAFs = self._zeros(
                (len(self.stack), self.core.yN_size, self.stack.size)
            )
        with _metrics.stage("bwd.finish"):
            facets = batched.finish_facets_batch(
                self.core, self._MNAF_BMNAFs, self.stack.offs0,
                self.stack.masks0, self.stack.size,
            )
        self.queue.drain()
        self._MNAF_BMNAFs = None
        self._finished = True
        return facets


def backward_all(swiftly_config, facet_configs, subgrid_tasks):
    """The full subgrid->facet transform in one call.

    :param subgrid_tasks: list of (SubgridConfig, subgrid_data) pairs
        covering the grid
    :return: finished facet stack [F, yB, yB(, 2)] matching facet_configs

    Numerically the same as streaming the subgrids through
    `SwiftlyBackward` (every accumulation is a sum of linear
    contributions). Ragged covers are padded with zero-data subgrids
    (exact); mixed subgrid sizes and the numpy backend take the streaming
    path.
    """
    core = swiftly_config.core
    subgrid_tasks = list(subgrid_tasks)
    groups, rectangular = _group_columns(
        subgrid_tasks, key=lambda item: item[0]
    )
    sizes = {sg.size for sg, _ in subgrid_tasks}
    if len(sizes) != 1 or core.backend == "numpy":
        bwd = SwiftlyBackward(swiftly_config, facet_configs)
        bwd.add_new_subgrid_tasks(subgrid_tasks)
        return bwd.finish()
    if not rectangular:
        size = sizes.pop()
        zero_data = np.zeros((size, size), dtype=complex)
        _pad_ragged_columns(
            groups, size,
            make_pad=lambda off0, first: (
                SubgridConfig(off0, first[0].off1, size), zero_data
            ),
        )
    stack = _FacetStack(facet_configs)
    subgrids = [[d for _, d in groups[off0]] for off0 in groups]
    sg_offs = [
        [(sg.off0, sg.off1) for sg, _ in groups[off0]] for off0 in groups
    ]
    fused_flops = 0
    if _metrics.enabled():
        from .utils.flops import backward_batched_flops

        fused_flops = backward_batched_flops(
            core, n_facets=stack.n_real, facet_size=stack.size,
            n_columns=len(groups),
            subgrids_per_column=len(next(iter(groups.values()))),
            subgrid_size=subgrid_tasks[0][0].size,
        )
    with _metrics.stage("bwd.fused_backward", flops=fused_flops):
        return batched.backward_all_batch(
            core, subgrids, sg_offs, stack.offs0, stack.offs1, stack.masks0,
            stack.masks1, stack.size,
        )
