"""Sample -> owning-subgrid mapping for visibility serving.

The port of the JAX package's ``swiftly_tpu/vis/mapping.py``, with
`VisCoverIndex.map_samples` vectorised over the samples (the reference
scans the spans in a Python loop per sample) and its outputs kept exactly:
the same owners, indices, fractions and shed list, and the owner dict keyed
in the order of each key's first sample, which decides the order in which
`VisibilityService` admits the slices.

A degrid sample at fractional (u, v) needs a ``support x support`` patch
of integer grid pixels around it, all inside ONE served subgrid (and
inside that subgrid's mask-1 region — masked-out border pixels are zeros,
not grid values). `VisCoverIndex` precomputes, per axis, the sorted span
table of the subgrid cover and answers, per sample:

* the owning ``(off0, off1)`` subgrid and the patch's first-tap index
  into its rows: the FIRST span in sorted order whose mask run holds the
  whole patch (the spans of an overlapping cover overlap), or
* *outside_cover* — the patch straddles a subgrid boundary (or falls off
  the cover / into a masked border). Those samples are SHED with
  ``shed_reason="outside_cover"`` (`vis.service`), never answered wrong.

Coordinates are grid pixels (the subgrid axes of
`ops.oracle.make_subgrid_from_sources`: column ``off`` spans
``[off - size/2, off + size/2)``), periodic in N; inputs are
canonicalised into the cover's principal window first.
"""

from __future__ import annotations

import numpy as np

__all__ = ["VisCoverIndex"]

# samples per vectorised chunk of map_samples: bounds the [chunk, spans]
# boolean table (65536 x 74 spans = 4.8 MB at 32k)
_CHUNK = 65536


def _axis_spans(offs, sizes, masks):
    """Sorted (lo, hi_exclusive, off, mask_lo, mask_hi) spans for one
    axis of the cover; the mask bounds are the contiguous mask-1 run
    (full covers are all-ones -> the whole span)."""
    spans = []
    for off, size, mask in zip(offs, sizes, masks):
        lo = off - size // 2
        m_lo, m_hi = lo, lo + size
        if mask is not None:
            m = np.asarray(mask)
            ones = np.flatnonzero(m != 0)
            if ones.size == 0:
                continue
            m_lo = lo + int(ones[0])
            m_hi = lo + int(ones[-1]) + 1
        spans.append((lo, lo + size, int(off), m_lo, m_hi))
    spans.sort()
    return spans


def _owner_span(spans_arr, first):
    """Index into the sorted spans of the first span whose mask run holds
    the patch [first, first + support) — or -1 — for every sample.

    :param spans_arr: [K, 3] int64 (lo, mask_lo, mask_hi - support + 1)
    :param first: [n] int64 first-tap coordinates
    """
    ok = (first[:, None] >= spans_arr[None, :, 1]) & (
        first[:, None] < spans_arr[None, :, 2]
    )
    k = np.argmax(ok, axis=1)
    return np.where(ok[np.arange(first.size), k], k, -1)


class VisCoverIndex:
    """Owning-subgrid lookup over a subgrid cover.

    :param subgrid_configs: the cover (`models.covers
        .make_full_subgrid_cover` or any SubgridConfig list)
    :param support: kernel tap count (`vis.kernel.VisKernel.support`)
    :param N: grid period (``config.image_size``) for canonicalisation
    """

    def __init__(self, subgrid_configs, support, N):
        self.support = int(support)
        self.N = int(N)
        self.taps_lo = -(self.support // 2 - 1)
        self.taps_hi = self.support // 2  # inclusive
        by_key = {}
        for sg in subgrid_configs:
            by_key[(sg.off0, sg.off1)] = sg
        self._configs = by_key
        offs0 = sorted({sg.off0 for sg in subgrid_configs})
        offs1 = sorted({sg.off1 for sg in subgrid_configs})
        sg0 = {sg.off0: sg for sg in subgrid_configs}
        sg1 = {sg.off1: sg for sg in subgrid_configs}
        self._spans_u = _axis_spans(
            offs0,
            [sg0[o].size for o in offs0],
            [sg0[o].mask0 for o in offs0],
        )
        self._spans_v = _axis_spans(
            offs1,
            [sg1[o].size for o in offs1],
            [sg1[o].mask1 for o in offs1],
        )
        if not self._spans_u or not self._spans_v:
            raise ValueError("empty subgrid cover")
        # principal window: [first span lo, first span lo + N)
        self._win_lo = self._spans_u[0][0]
        # per axis [K, 3]: span lo, and the half-open range of first-tap
        # coordinates whose patch lies inside the span's mask run
        last = self.support - 1
        self._table_u, self._table_v = (
            np.array([(lo, m_lo, m_hi - last)
                      for (lo, _hi, _off, m_lo, m_hi) in spans],
                     dtype=np.int64)
            for spans in (self._spans_u, self._spans_v)
        )
        # (span_u, span_v) pairs that are tiles of the cover (a sparse
        # cover has axis spans whose (off0, off1) tile does not exist)
        self._tile = np.array(
            [[(su[2], sv[2]) in by_key for sv in self._spans_v]
             for su in self._spans_u],
            dtype=bool,
        )

    def config(self, off0, off1):
        return self._configs[(off0, off1)]

    def canonicalise(self, uv):
        """(u, v) folded into the cover's principal window (period N)."""
        uv = np.asarray(uv, dtype=float)
        return (uv - self._win_lo) % self.N + self._win_lo

    def map_samples(self, uv):
        """Partition a sample batch by owning subgrid.

        :param uv: [B, 2] fractional grid coordinates
        :return: ``(owners, shed_idx)`` — ``owners`` maps
            ``(off0, off1) -> dict`` with ``idx`` (input indices),
            ``iu0``/``iv0`` (first-tap row indices into the owning
            subgrid), ``fu``/``fv`` (sub-pixel fractions in [0, 1)),
            keyed in the order of each key's first sample;
            ``shed_idx`` the outside-cover input indices (a list, in
            input order)
        """
        uv = self.canonicalise(np.atleast_2d(uv))
        u0 = np.floor(uv[:, 0]).astype(int)
        v0 = np.floor(uv[:, 1]).astype(int)
        fu = uv[:, 0] - u0
        fv = uv[:, 1] - v0
        first_u = u0 + self.taps_lo
        first_v = v0 + self.taps_lo
        n = uv.shape[0]
        ku = np.empty(n, dtype=np.int64)
        kv = np.empty(n, dtype=np.int64)
        for lo in range(0, n, _CHUNK):
            hi = min(n, lo + _CHUNK)
            ku[lo:hi] = _owner_span(self._table_u, first_u[lo:hi])
            kv[lo:hi] = _owner_span(self._table_v, first_v[lo:hi])
        inside = (ku >= 0) & (kv >= 0)
        inside[inside] = self._tile[ku[inside], kv[inside]]
        shed = np.flatnonzero(~inside)
        kept = np.flatnonzero(inside)
        n_v = len(self._spans_v)
        code = ku[kept] * n_v + kv[kept]
        order = np.argsort(code, kind="stable")  # input order per key
        _, starts = np.unique(code[order], return_index=True)
        bounds = np.append(starts, order.size)
        groups = [order[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
        # keys in the order of their first sample
        groups.sort(key=lambda g: g[0])
        owners = {}
        for g in groups:
            idx = kept[g]
            su = self._spans_u[ku[idx[0]]]
            sv = self._spans_v[kv[idx[0]]]
            owners[(su[2], sv[2])] = {
                "idx": idx.astype(int),
                "iu0": (first_u[idx] - su[0]).astype(int),
                "iv0": (first_v[idx] - sv[0]).astype(int),
                "fu": fu[idx],
                "fv": fv[idx],
            }
        return owners, shed.tolist()
