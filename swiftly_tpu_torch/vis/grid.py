"""Gridding: the exact adjoint of `vis.degrid`, feeding the backward.

The port of the JAX package's ``swiftly_tpu/vis/grid.py``.
``grid_batch`` scatter-adds each weighted visibility into its
``support x support`` patch — the transpose of the degrid gather with the
SAME indices and the SAME real weights, so the dot-product identity

    < degrid(G), y >  ==  < G, grid(y) >

holds to float accumulation order (pinned by tests/test_torch_vis.py). The
scatter is ``ops.kernels.grid`` (``csrc/degrid.cu``), deterministic: each
pixel receives its contributions in sample order, with no atomics, so
gridding the same samples twice gives the same bits.

`VisGridder` is the streaming accumulator on top: visibility batches
accumulate into per-subgrid planes on the device, version-pinned against
the serving stream (a facet update moves the stream version and the
gridder REFUSES further batches — gridding v-era samples into a v+1 image
would corrupt the update, the same stale-read rule
`parallel.streamed.CachedColumnFeed` enforces on reads). ``emit()`` hands
the accumulated columns over in `StreamedBackward.add_subgrid_group` form
— subgrid columns stacked ``[G, S, xA, xA(, 2)]`` on the device — so
gridded visibilities are an ingest source for the backward with no
adapter in between.

Each scatter runs as the ``obs.metrics`` stage ``vis.grid``, with the
FLOPs and bytes `plan.price_vis` prices it by.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..ops import kernels
from ..ops.core import as_torch_dtype, resolve_device

__all__ = ["ADJOINT_TOLERANCE", "VisGridder", "grid_batch"]

# Bound on | <degrid(G), y> - <G, grid(y)> | / |<degrid(G), y>| — the
# dot-product identity holds exactly in exact arithmetic; float32
# accumulation (the serving dtype) leaves reordering noise that
# cancellation in the batched dot products can inflate to ~1e-5, so 1e-4
# still catches a real adjoint bug (those miss by O(1)) while never
# flaking on rounding.
ADJOINT_TOLERANCE = 1e-4

_NP_REAL = {torch.float32: np.float32, torch.float64: np.float64}


def grid_batch(size, iu0, iv0, cu, cv, vis, acc=None, dtype=torch.float32,
               device=None):
    """Scatter one visibility batch into a [size, size] grid plane pair.

    :param vis: [B] complex visibilities (sample weights fold in here)
    :param acc: optional (real, imag) planes to accumulate into, in place
        (e.g. the two planes of an interleaved [size, size, 2] tensor)
    :param dtype: the new planes' dtype (torch or numpy) when ``acc`` is
        None
    :param device: the new planes' device when ``acc`` is None; None means
        the GPU
    :return: (real, imag) planes — two views of one new interleaved
        [size, size, 2] tensor when ``acc`` is None, else ``acc``
    """
    if acc is None:
        planar = torch.zeros((size, size, 2), dtype=as_torch_dtype(dtype),
                             device=resolve_device(device))
        acc = (planar[..., 0], planar[..., 1])
    acc_r, acc_i = acc
    np_dt = _NP_REAL[acc_r.dtype]
    vis = np.asarray(vis, dtype=complex)
    dev = acc_r.device
    idx = torch.as_tensor(np.stack([np.asarray(iu0), np.asarray(iv0)])
                          .astype(np.int64).reshape(2, -1), device=dev)
    w = torch.as_tensor(np.stack([np.asarray(cu), np.asarray(cv)])
                        .astype(np_dt), device=dev)
    y = torch.as_tensor(np.stack([vis.real, vis.imag]).astype(np_dt),
                        device=dev)
    return kernels.grid(acc_r, acc_i, idx[0], idx[1], w[0], w[1], y[0], y[1])


class VisGridder:
    """Version-pinned visibility -> subgrid-column accumulator.

    :param cover_index: `vis.mapping.VisCoverIndex` over the served
        cover (sharing the service's index keeps grid and degrid on the
        same ownership rule)
    :param kernel: `vis.kernel.VisKernel`
    :param stream_version: the facet-stack version these visibilities
        belong to — pin it from `VisibilityService.stream_version` at
        construction
    :param version_of: zero-arg callable returning the CURRENT stream
        version (e.g. ``lambda: service.stream_version``); when it
        moves past the pinned version, `add_batch` raises LookupError
    :param dtype: accumulator real dtype, torch or numpy (match the
        backward core's)
    :param device: where the accumulators live; None means the GPU
    """

    def __init__(self, cover_index, kernel, stream_version=0,
                 version_of=None, dtype=torch.float32, device=None):
        self.cover = cover_index
        self.kernel = kernel
        self.stream_version = int(stream_version)
        self._version_of = version_of
        self.dtype = as_torch_dtype(dtype)
        self.device = resolve_device(device)
        self._acc = {}  # (off0, off1) -> interleaved [size, size, 2] planes
        self.n_gridded = 0
        self.n_shed = 0
        self.batches = 0

    def _gate(self):
        if self._version_of is None:
            return
        current = int(self._version_of())
        if current != self.stream_version:
            raise LookupError(
                f"gridder pinned at stream version "
                f"{self.stream_version} but the serving stream moved "
                f"to {current} (a facet update landed); gridding "
                "stale-era samples would corrupt the updated image — "
                "re-pin a fresh VisGridder"
            )

    def add_batch(self, uv, vis, weights=None):
        """Accumulate one weighted visibility batch.

        :param uv: [B, 2] sample coordinates
        :param vis: [B] complex visibilities
        :param weights: optional [B] real sample weights
        :return: number of samples gridded (outside-cover samples are
            counted in ``n_shed`` and skipped, mirroring the degrid
            shed rule)
        :raises LookupError: when the pinned stream version is stale
        """
        self._gate()
        uv = np.atleast_2d(np.asarray(uv, dtype=float))
        vis = np.asarray(vis, dtype=complex)
        if weights is not None:
            vis = vis * np.asarray(weights, dtype=float)
        owners, shed = self.cover.map_samples(uv)
        self.n_shed += len(shed)
        np_dt = _NP_REAL[self.dtype]
        gridded = 0
        for key, entry in owners.items():
            sg = self.cover.config(*key)
            acc = self._acc.get(key)
            if acc is None:
                acc = self._acc[key] = torch.zeros(
                    (sg.size, sg.size, 2), dtype=self.dtype,
                    device=self.device)
            cu = self.kernel.weights(entry["fu"], dtype=np_dt)
            cv = self.kernel.weights(entry["fv"], dtype=np_dt)
            B, W = cu.shape
            # attributed as plan.price_vis prices the stage (two scattered
            # planes and the weights' outer product)
            with _metrics.stage("vis.grid", flops=8 * B * W * W,
                                bytes_moved=2 * B * W * W * 4):
                grid_batch(
                    sg.size, entry["iu0"], entry["iv0"], cu, cv,
                    vis[entry["idx"]], acc=(acc[..., 0], acc[..., 1]),
                )
            gridded += len(entry["idx"])
        self.n_gridded += gridded
        self.batches += 1
        return gridded

    def subgrid(self, off0, off1):
        """One accumulated plane pair as a complex tensor (a copy)."""
        return torch.view_as_complex(self._acc[(off0, off1)].contiguous())

    def emit(self, planar=True):
        """The accumulated columns in `StreamedBackward
        .add_subgrid_group` form.

        :param planar: stack ``[..., 2]`` real/imag planes (the planar
            backward core's layout); False gives complex rows
        :return: ``(col_sg_lists, subgrids_group)`` — per-column config
            lists (one shared off0 each, in ascending order; trailing rows
            zero-padded by the consumer's contract) and the
            ``[G, S, size, size(, 2)]`` stacked device tensor
        """
        if not self._acc:
            raise ValueError("nothing gridded yet")
        cols = {}
        for (off0, off1) in sorted(self._acc):
            cols.setdefault(off0, []).append(off1)
        S = max(len(v) for v in cols.values())
        size = next(iter(self._acc.values())).shape[0]
        out = torch.zeros((len(cols), S, size, size, 2), dtype=self.dtype,
                          device=self.device)
        col_sg_lists = []
        for c, (off0, off1s) in enumerate(cols.items()):
            col_sg_lists.append([self.cover.config(off0, o1) for o1 in off1s])
            for s, o1 in enumerate(off1s):
                out[c, s] = self._acc[(off0, o1)]
        if not planar:
            out = torch.view_as_complex(out)
        return col_sg_lists, out
