"""`FacetDeltaLedger`: content-addressed facet-stack versioning.

The incremental re-transform engine (`delta.engine`) patches a recorded
subgrid stream instead of recomputing it — but a patch is only valid
against the EXACT facet stack the stream was recorded for. The ledger
is that provenance: it content-hashes every facet per committed
version, detects which facets changed between a committed version and a
proposed stack, and stamps a monotone ``stream_version`` into the spill
cache (and checkpoint meta) so every consumer — `CachedColumnFeed`, the
serve path, a restored checkpoint — can refuse data recorded for a
stack that is no longer current.

Each facet is versioned as a (config, data) PAIR: `config_hash` covers
the `FacetConfig`'s identity — offsets, size, ownership masks — so a
facet whose geometry changes under identical data still invalidates
the stream (and is reported by ``config_changed`` so the engine
replays instead of mis-pairing the old config with a data diff).

Data hashing is by CONTENT, not identity: a facet rebuilt from the same
sources hashes equal (no spurious invalidation), a one-pixel change
hashes different (no stale serve). Sparse facets
(`ops.oracle.SparseRealFacet`) hash their coordinate/value arrays
directly — at 64k that is a few hundred bytes instead of a 2 GB dense
plane. Callable (lazy) facet tasks are materialised for hashing, the
same contract `parallel.streamed.StreamedForward` applies.

The port of the JAX package's ``swiftly_tpu/delta/ledger.py``: the
digests are SHA-256 over the same numpy bytes, so both packages give the
same hex digests on the same inputs. A facet given as a torch tensor is
hashed as its host numpy bytes.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

__all__ = ["FacetDeltaLedger", "config_hash", "facet_hash"]


def config_hash(fc):
    """Identity hash of one facet's `models.config.FacetConfig` — the
    geometry the data is recorded against (offsets, size, ownership
    masks; masks realised for hashing, so a slice-list and its realised
    array hash equal). A facet whose config changes while its data
    stays identical is NOT the same facet: the facet→subgrid map
    depends on both, so the ledger versions the pair."""
    h = hashlib.sha256()
    if fc is None:
        h.update(b"config:none")
        return h.hexdigest()
    h.update(
        f"config:off0={int(fc.off0)};off1={int(fc.off1)};"
        f"size={int(fc.size)};".encode()
    )
    for name in ("mask0", "mask1"):
        mask = getattr(fc, name, None)
        if mask is None:
            h.update(f"{name}:none;".encode())
        else:
            arr = np.ascontiguousarray(np.asarray(mask))
            h.update(f"{name}:{arr.shape}:{arr.dtype};".encode())
            h.update(arr.tobytes())
    return h.hexdigest()


def facet_hash(data):
    """Content hash of one facet's data (sparse descriptor, dense
    array, or a callable returning either)."""
    from ..ops.oracle import SparseRealFacet

    if callable(data):
        data = data()
    h = hashlib.sha256()
    if isinstance(data, SparseRealFacet):
        h.update(b"sparse:")
        h.update(str(int(data.size)).encode())
        h.update(np.ascontiguousarray(data.rows).tobytes())
        h.update(np.ascontiguousarray(data.cols).tobytes())
        h.update(np.ascontiguousarray(data.vals).tobytes())
    else:
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        arr = np.asarray(data)
        h.update(b"dense:")
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


class FacetDeltaLedger:
    """Versioned content hashes of a facet stack.

    ``commit(facet_tasks)`` records the stack and bumps ``version``
    IFF the content changed (committing an identical stack is a no-op,
    so re-running a pipeline never invalidates a valid cache);
    ``changed(facet_tasks)`` lists the facet indices whose content
    differs from the last committed version; ``stamp(cache)`` writes
    the current version onto any object with a ``stream_version``
    attribute (the `utils.spill.SpillCache` contract).

    Versions start at 0 (nothing committed) and are strictly monotone —
    a consumer that recorded version v can treat ANY other value as
    stale, not just larger ones.
    """

    def __init__(self):
        self.version = 0
        self._hashes = None

    @property
    def n_facets(self):
        return None if self._hashes is None else len(self._hashes)

    def commit(self, facet_tasks):
        """Record ``facet_tasks`` as the current stack; returns the
        (possibly bumped) version. Each facet is hashed as a
        (config, data) PAIR — a config-only change versions the stack
        exactly like a data change (the recorded stream is stale either
        way)."""
        hashes = self._pair_hashes(facet_tasks)
        if self._hashes is None or hashes != self._hashes:
            self.version += 1
        self._hashes = hashes
        return self.version

    def changed(self, facet_tasks):
        """Indices of facets whose content OR config differs from the
        committed stack. Requires a prior ``commit`` and an equal facet
        count — a cover change is not a delta, it is a different
        stream."""
        pairs = self._pair_hashes(facet_tasks, require_committed=True)
        return [
            j for j, (a, b) in enumerate(zip(self._hashes, pairs))
            if a != b
        ]

    def config_changed(self, facet_tasks):
        """Indices of facets whose CONFIG (geometry/masks) differs from
        the committed stack. A changed config is never a data delta —
        the facet→subgrid map depends on it, so
        `delta.IncrementalForward` replays instead of patching. Same
        preconditions as `changed`."""
        pairs = self._pair_hashes(facet_tasks, require_committed=True)
        return [
            j for j, ((ca, _da), (cb, _db))
            in enumerate(zip(self._hashes, pairs))
            if ca != cb
        ]

    def _pair_hashes(self, facet_tasks, require_committed=False):
        """(config_hash, facet_hash) per facet, with the shared
        precondition checks."""
        if require_committed:
            if self._hashes is None:
                raise ValueError(
                    "no committed facet stack; commit() (or "
                    "IncrementalForward.record()) must run before "
                    "changed()"
                )
            if len(facet_tasks) != len(self._hashes):
                raise ValueError(
                    f"facet count changed ({len(self._hashes)} -> "
                    f"{len(facet_tasks)}); an incremental update "
                    "requires the same cover — re-record the stream"
                )
        return [
            (config_hash(fc), facet_hash(d)) for fc, d in facet_tasks
        ]

    def stamp(self, cache):
        """Write the current version onto ``cache.stream_version``;
        returns the version."""
        cache.stream_version = self.version
        return self.version

    def as_dict(self):
        """JSON-ready summary for artifacts/checkpoint meta."""
        return {
            "version": int(self.version),
            "n_facets": self.n_facets,
        }
