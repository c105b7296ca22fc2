"""`IncrementalForward`: facet-delta updates that patch the recorded
subgrid stream instead of recomputing it.

The facet -> subgrid map ``S_i = A_i sum_j ( n_j * m_i (b_j * F_j) )``
is LINEAR in the facets: a changed facet contributes additively, so for
K changed facets of J the correction to every subgrid is exactly a
streamed forward over the K delta facets ``dF_j = F_j_new - F_j_old``
— ~K/J of a full forward's compute — added into the recorded stream.
This engine wraps `parallel.streamed.StreamedForward` with that
workflow:

1. ``record(subgrid_configs)`` runs one full streamed forward
   (``residency="device"``), recording the stream into a
   `utils.spill.SpillCache` and committing the facet stack to a
   `delta.ledger.FacetDeltaLedger`;
2. ``update(new_facet_tasks)`` detects the changed facets by content
   hash, streams the column passes with the facet stack RESTRICTED to
   those K deltas, copies each correction group to the host once
   (pinned staging on a copy stream), routes every correction row onto
   its recorded cache position via the spill metadata's input indices
   (never by position), and patches each cache entry — one
   `SpillCache.patch_entry` per entry (RAM out of place, or disk
   tmp-sibling + rename) — then stamps the ledger's bumped
   ``stream_version`` into the cache so stale feeds invalidate.

Exactness contract: the patched stream equals a full recompute up to
f32 sum-reorder error — the delta adds facet contributions in another
association order than the full column pass. ``SWIFTLY_DELTA_EXACT=1``
(or ``exact=True``) re-records the stream from scratch with the new
stack instead: bit-identical to a fresh forward, at full-forward cost.

Failure posture (the degradation ladder): any failure on the patch
path — a delta-stream error, an unmappable row, a patch write that
stays failed past its retries — degrades to a full re-record of the
stream with the new stack (``delta.patch_to_replay`` in the degradation
ledger). For the whole rewrite window (first ``patch_entry`` through
the version re-stamp, and the replay's reset-to-refill) the cache is
marked mid-patch (`utils.spill.SpillCache.begin_patch`), so a
concurrent consumer — a live `CachedColumnFeed` on a serving replica —
gets LookupError and computes at its pinned version instead of reading
a torn mix of old and new rows. A facet whose `FacetConfig` changed is
not a data delta: the engine replays (``facet_config_changed``).

Break-even: `plan.plan_delta` prices the incremental path against the
full recompute; ``update`` honours the cheaper choice unless
``use_plan=False``, and records the plan in its report.

The port of the JAX package's ``swiftly_tpu/delta/engine.py``. The
report adds ``timings``: the patch path's seconds of the delta pass
(``delta_s``, split into ``compute_s`` — the delta forward's column
passes on the device, B1 on the planar backend — ``d2h_s`` and
``route_s``) and of the cache patch (``patch_s``).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..parallel.streamed import CachedColumnFeed, StreamedForward
from ..parallel.streamed import _PinnedStaging
from ..resilience import degrade as _degrade
from .ledger import FacetDeltaLedger

__all__ = ["IncrementalForward", "facet_delta"]

logger = logging.getLogger(__name__)


def facet_delta(old, new):
    """``new - old`` for one facet's data, keeping sparse descriptors
    sparse (the concatenated coordinate lists with negated old values —
    duplicates accumulate in both the host densify and the device
    synthesis, so the result is exact). Torch tensors are taken as
    their host numpy arrays."""
    from ..ops.oracle import SparseRealFacet

    old = old() if callable(old) else old
    new = new() if callable(new) else new
    if isinstance(old, SparseRealFacet) and isinstance(new, SparseRealFacet):
        if old.size != new.size:
            raise ValueError(
                f"facet size changed ({old.size} -> {new.size}); "
                "not a delta"
            )
        return SparseRealFacet(
            new.size,
            np.concatenate([new.rows, old.rows]),
            np.concatenate([new.cols, old.cols]),
            np.concatenate([new.vals, -np.asarray(old.vals)]),
        )
    old, new = (
        d.densify() if isinstance(d, SparseRealFacet)
        else d.detach().cpu().numpy() if isinstance(d, torch.Tensor)
        else np.asarray(d)
        for d in (old, new)
    )
    if old.shape != new.shape:
        raise ValueError(
            f"facet shape changed ({old.shape} -> {new.shape}); "
            "not a delta"
        )
    return new - old


class IncrementalForward:
    """A streamed forward whose recorded output stream accepts
    facet-delta patches.

    :param swiftly_config: `SwiftlyConfig` (device backend)
    :param facet_tasks: list of (FacetConfig, facet_data) pairs —
        callables are materialised (the ledger hashes content)
    :param spill: the `utils.spill.SpillCache` holding the recorded
        stream (the memo the updates patch)
    :param ledger: a `FacetDeltaLedger` (default: fresh)
    :param col_group / facet_group: forwarded to `StreamedForward`. The
        delta pass groups its columns as the recording did (unless
        ``col_group`` is given), so each correction group lands on one
        cache entry.
    """

    def __init__(self, swiftly_config, facet_tasks, spill, ledger=None,
                 col_group=None, facet_group=None):
        self.config = swiftly_config
        self.facet_tasks = [
            (fc, d() if callable(d) else d) for fc, d in facet_tasks
        ]
        self.spill = spill
        self.ledger = ledger or FacetDeltaLedger()
        self._col_group = col_group
        self._facet_group = facet_group
        self.fwd = self._make_fwd(self.facet_tasks)
        self._subgrid_configs = None
        self.last_report = None

    def _make_fwd(self, tasks, col_group=None):
        return StreamedForward(
            self.config, tasks, residency="device",
            col_group=col_group or self._col_group,
            facet_group=self._facet_group,
        )

    # -- record -------------------------------------------------------------

    def record(self, subgrid_configs):
        """Run one full streamed forward, recording the stream; commits
        the facet stack and stamps the stream version. Re-recording
        (e.g. after an update chose replay) starts from a reset cache."""
        self._subgrid_configs = list(subgrid_configs)
        if len(self.spill):
            self.spill.reset()
        for _ in self.fwd.stream_column_groups(
            self._subgrid_configs, spill=self.spill
        ):
            pass
        if not self.spill.complete:
            raise RuntimeError(
                "the stream did not fit the spill cache (fill gave up); "
                "incremental updates need a complete recording — raise "
                "SWIFTLY_SPILL_BUDGET_GB or set SWIFTLY_SPILL_DIR"
            )
        self.ledger.commit(self.facet_tasks)
        self.ledger.stamp(self.spill)
        _trace.instant("delta.record", cat="delta",
                       version=self.ledger.version,
                       entries=len(self.spill))
        return {"stream_version": self.ledger.version,
                "entries": len(self.spill)}

    def feed(self):
        """A fresh `CachedColumnFeed` over the recorded stream, pinned
        to the CURRENT stream version."""
        return CachedColumnFeed(self.spill)

    def fabric(self, *, l1_rows=64):
        """A `cache.SharedStreamTier` over the recorded stream: ONE
        resident, versioned L2 that N serve replicas front with hot-row
        L1 views (`SharedStreamTier.view`). After `update`, roll the
        fabric (`SharedStreamTier.roll` with the update report) instead
        of re-building per-replica feeds — `serve.ServeFleet` does this
        when constructed with ``fabric=``."""
        from ..cache import SharedStreamTier

        return SharedStreamTier(self.spill, l1_rows=l1_rows)

    # -- update -------------------------------------------------------------

    def update(self, new_facet_tasks, exact=None, use_plan=True):
        """Adopt ``new_facet_tasks``; patch or re-record the stream.

        Returns a report dict: ``mode`` ("patch" | "replay" | "noop"),
        ``reason`` (why replay/noop), ``changed_facets``,
        ``patched_columns`` / ``patched_entries``, ``stream_version``,
        ``plan`` (the `plan.plan_delta` pricing, when asked for and
        available) and, for a patch, ``timings``.
        """
        if self._subgrid_configs is None:
            raise ValueError("record() must run before update()")
        tasks = [
            (fc, d() if callable(d) else d) for fc, d in new_facet_tasks
        ]
        changed = self.ledger.changed(tasks)
        if not changed:
            self.last_report = {
                "mode": "noop", "reason": "no_facets_changed",
                "changed_facets": [], "patched_columns": 0,
                "patched_entries": 0,
                "stream_version": self.ledger.version, "plan": None,
            }
            return self.last_report
        if exact is None:
            exact = os.environ.get("SWIFTLY_DELTA_EXACT") == "1"
        plan_dict = self._plan(len(changed)) if use_plan else None
        reason = None
        if exact:
            reason = "exact_mode"
        elif self.ledger.config_changed(tasks):
            # a config change is not a data delta: the facet->subgrid
            # map depends on the geometry/masks — replay with the new
            # stack
            reason = "facet_config_changed"
        elif not self.spill.complete:
            reason = "incomplete_cache"
        elif len(changed) >= len(tasks):
            reason = "all_facets_changed"
        elif plan_dict is not None and plan_dict.get("mode") == "full":
            reason = "plan_break_even"
        if reason is not None:
            return self._replay(tasks, changed, reason, plan_dict)
        try:
            corrections, patched_columns, timings = self._stream_delta(
                tasks, changed
            )
            n_entries = len(corrections)
            # live feeds refuse lookups from the first patched entry
            # until the bumped version is stamped: a consumer racing
            # the patch falls back to compute at the version its
            # request was admitted under
            t0 = time.perf_counter()
            self.spill.begin_patch()
            try:
                for k in sorted(corrections):
                    self.spill.patch_entry(k, corrections.pop(k))
                self._adopt(tasks)
                self.ledger.commit(self.facet_tasks)
                self.ledger.stamp(self.spill)
            finally:
                self.spill.end_patch()
            timings["patch_s"] = time.perf_counter() - t0
        except Exception as exc:  # noqa: BLE001 - the degradation ladder
            # rung: patch -> replay. A torn patch (some entries updated,
            # some not) is unobservable: the replay re-fills every entry
            # from the new stack.
            logger.warning(
                "incremental patch failed (%s: %s); replaying the full "
                "forward with the new facet stack",
                type(exc).__name__, exc,
            )
            _degrade.record(
                "delta", "patch_to_replay",
                f"{type(exc).__name__}: {exc}",
            )
            _metrics.count("delta.patch_failures")
            return self._replay(
                tasks, changed, "patch_failed", plan_dict
            )
        _metrics.count("delta.patches")
        _metrics.count("delta.patched_entries", n_entries)
        _trace.instant("delta.patch", cat="delta",
                       changed=len(changed),
                       entries=n_entries,
                       version=self.ledger.version)
        self.last_report = {
            "mode": "patch", "reason": None,
            "changed_facets": list(changed),
            "patched_columns": int(patched_columns),
            "patched_entries": n_entries,
            "stream_version": self.ledger.version,
            "plan": plan_dict,
            "timings": timings,
        }
        return self.last_report

    # -- internals ----------------------------------------------------------

    def _plan(self, n_changed):
        """Price incremental vs full via `plan.plan_delta`; None when
        the geometry cannot be priced (pricing is advisory — the engine
        still has the exactness ladder either way)."""
        try:
            from ..plan import PlanInputs, plan_delta

            inputs = PlanInputs.from_cover(
                self.config,
                [fc for fc, _ in self.facet_tasks],
                self._subgrid_configs,
            )
            return plan_delta(inputs, n_changed).as_dict()
        except Exception as exc:  # noqa: BLE001 - pricing is advisory
            logger.debug("plan_delta unavailable: %s", exc)
            return None

    def _stream_delta(self, tasks, changed):
        """Stream the K delta facets; return ``{entry_k: correction}``
        (one dense addend per cache entry), the number of distinct
        columns the corrections touch, and the pass's timings.

        Each group's device stack is copied to the host once (through
        pinned staging on a copy stream on the GPU); a group whose rows
        map onto one entry's positions in order is that entry's
        correction as it stands, else its rows are added into a
        zero-initialised correction one by one."""
        delta_tasks = [
            (self.facet_tasks[j][0],
             facet_delta(self.facet_tasks[j][1], tasks[j][1]))
            for j in changed
        ]
        dfwd = self._make_fwd(delta_tasks, col_group=len(self.spill.meta(0)))
        # Cache positions by the cover's input index: rows are routed by
        # identity, never by position.
        pos = {}
        for k in range(len(self.spill)):
            for c, col in enumerate(self.spill.meta(k)):
                for s, (i, _sg) in enumerate(col):
                    pos[int(i)] = (k, c, s)
        corrections = {}
        columns = set()
        timings = {"compute_s": 0.0, "d2h_s": 0.0, "route_s": 0.0}
        staging = None
        t_start = t0 = time.perf_counter()
        try:
            for per_col, out_g in dfwd.stream_column_groups(
                self._subgrid_configs
            ):
                cuda = out_g.device.type == "cuda"
                if cuda:
                    out_g = out_g.contiguous()
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(out_g.device))
                    ready.synchronize()
                t1 = time.perf_counter()
                timings["compute_s"] += t1 - t0
                with _metrics.stage("delta.d2h") as st:
                    if cuda:
                        if staging is None:
                            staging = _PinnedStaging(out_g.device)
                        host_t = torch.empty(out_g.shape, dtype=out_g.dtype)
                        staging.to_host(out_g, host_t, ready)
                        host = host_t.numpy()
                    else:
                        host = out_g.detach().numpy().copy()
                    st.bytes_moved = int(host.nbytes)
                del out_g
                t2 = time.perf_counter()
                timings["d2h_s"] += t2 - t1
                self._route(per_col, host, pos, corrections, columns)
                t0 = time.perf_counter()
                timings["route_s"] += t0 - t2
        finally:
            if staging is not None:
                staging.close()
        timings["delta_s"] = time.perf_counter() - t_start
        return corrections, len(columns), timings

    def _route(self, per_col, host, pos, corrections, columns):
        """Add one host correction group into its entries' corrections."""
        places = [
            [pos[int(i)] for i, _sg in col] for col in per_col
        ]
        ks = {k for col in places for k, _c, _s in col}
        if len(ks) == 1:
            (k,) = ks
            shape = self.spill.entry_shape(k)
            in_order = all(
                (cc, ss) == (c, s)
                for c, col in enumerate(places)
                for s, (_k, cc, ss) in enumerate(col)
            )
            if (in_order and k not in corrections
                    and host.shape == shape):
                # the group is the entry's correction (padding rows
                # beyond a column's items are zero-mask rows: zero)
                corrections[k] = host
                columns.update((k, c) for c in range(len(places)))
                return
        for c, col in enumerate(places):
            for s, (k, cc, ss) in enumerate(col):
                corr = corrections.get(k)
                if corr is None:
                    corr = corrections[k] = np.zeros(
                        self.spill.entry_shape(k), dtype=host.dtype
                    )
                corr[cc, ss] += host[c, s]
                columns.add((k, cc))

    def _replay(self, tasks, changed, reason, plan_dict):
        """Full re-record with the new stack — the exact path and the
        ladder's landing zone. Bit-identical to a fresh forward. Live
        feeds refuse lookups for the whole reset-to-refill window
        (``begin_patch`` plus the cache's own ``complete`` gate), and a
        refill that overflows the budget raises before the ledger
        commits, so a half-recorded stream is never reported as a
        successful replay."""
        self._adopt(tasks)
        self.spill.begin_patch()
        try:
            self.spill.reset()
            for _ in self.fwd.stream_column_groups(
                self._subgrid_configs, spill=self.spill
            ):
                pass
            if not self.spill.complete:
                raise RuntimeError(
                    "the replay stream did not fit the spill cache "
                    "(fill gave up); the recorded stream is incomplete "
                    "and feeds fall back to compute — raise "
                    "SWIFTLY_SPILL_BUDGET_GB or set SWIFTLY_SPILL_DIR, "
                    "then record() again"
                )
            self.ledger.commit(self.facet_tasks)
            self.ledger.stamp(self.spill)
        finally:
            self.spill.end_patch()
        _metrics.count("delta.replays")
        _trace.instant("delta.replay", cat="delta", reason=reason,
                       version=self.ledger.version)
        self.last_report = {
            "mode": "replay", "reason": reason,
            "changed_facets": list(changed),
            "patched_columns": 0, "patched_entries": 0,
            "stream_version": self.ledger.version,
            "plan": plan_dict,
        }
        return self.last_report

    def _adopt(self, tasks):
        self.facet_tasks = tasks
        self.fwd = self._make_fwd(tasks)
