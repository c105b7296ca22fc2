"""Chunk descriptors and the top-level SwiftlyConfig.

The torch twin of the JAX package's ``swiftly_tpu/models/config.py``.
`FacetConfig` / `SubgridConfig` describe one chunk of image/grid space by
its per-axis offsets, size, and optional ownership masks (stored sparsely
as slice lists, realised lazily). `SwiftlyConfig` owns the numerical core
(backend-, dtype- and device-selectable) and exposes the layout accessors.
"""

from __future__ import annotations

from ..ops.core import SwiftlyCore
from ..ops.oracle import mask_from_slices

__all__ = ["ChunkConfig", "FacetConfig", "SubgridConfig", "SwiftlyConfig"]


class ChunkConfig:
    """Base descriptor for one facet or subgrid chunk.

    :param off0: chunk mid-point offset along axis 0 (image coordinates)
    :param off1: chunk mid-point offset along axis 1
    :param size: chunk size in pixels (square)
    :param mask0: ownership mask for axis 0 — either a realised 0/1 array,
        or ``[slice_list, mask_size]`` for lazy sparse storage, or None
    :param mask1: same for axis 1
    """

    def __init__(self, off0, off1, size, mask0=None, mask1=None):
        self.off0 = int(off0)
        self.off1 = int(off1)
        self.size = int(size)
        self._mask0 = mask0
        self._mask1 = mask1

    @staticmethod
    def _realise(mask):
        if isinstance(mask, list):
            slices, size = mask
            return mask_from_slices(slices, size)
        return mask

    @property
    def mask0(self):
        """Axis-0 ownership mask (realised on demand)."""
        return self._realise(self._mask0)

    @property
    def mask1(self):
        """Axis-1 ownership mask (realised on demand)."""
        return self._realise(self._mask1)

    def __repr__(self):
        return (
            f"{type(self).__name__}(off0={self.off0}, off1={self.off1}, "
            f"size={self.size})"
        )


class FacetConfig(ChunkConfig):
    """Descriptor of one facet (image-space chunk)."""


class SubgridConfig(ChunkConfig):
    """Descriptor of one subgrid (grid-space chunk)."""


class SwiftlyConfig:
    """Top-level configuration: sizes, PSWF parameter, and the core.

    :param W: PSWF window parameter
    :param fov: field of view (fraction of image covered by usable data)
    :param N: total image size
    :param yB_size: maximum (true) facet size
    :param yN_size: padded facet size (divides N)
    :param xA_size: maximum (true) subgrid size
    :param xM_size: padded subgrid size (divides N)
    :param backend: numerical backend — "torch" (complex tensors),
        "planar" (real pairs, matmul DFTs through the B3 kernel),
        "numpy" (host reference) or "native" (compiled C++ host kernels)
    :param dtype: forwarded to the core
    :param device: torch device of the tensor backends; None means the
        GPU, and raises on a host without CUDA
    :param mesh: optional `parallel.mesh.FacetMesh`; the streaming API
        then pads the facet stack to the mesh size, gives each shard its
        facets on its device, and sums the facets' contributions over the
        shards with one collective per column (`parallel.sharded`)
    :param spmd_mode: how the mesh's facet sum is expressed:
        "shard_map" (the `parallel.sharded` programs, the collective by
        ``SWIFTLY_MESH_COLLECTIVE``; the default) or "gspmd" (the same
        per-shard bodies with the psum a compiler would insert)
    :param core_state: optional (Fb, Fn) window constants as numpy float64
        arrays (e.g. the JAX core's ``_Fb``/``_Fn``), taken as they are
        instead of recomputed (``SwiftlyCore.from_numpy_state``)
    """

    def __init__(
        self,
        W: float,
        fov: float,
        N: int,
        yB_size: int,
        yN_size: int,
        xA_size: int,
        xM_size: int,
        backend: str = "torch",
        dtype=None,
        device=None,
        mesh=None,
        spmd_mode: str = "shard_map",
        core_state=None,
        **_other,
    ):
        if mesh is not None and backend in ("numpy", "native"):
            raise ValueError(
                f"backend={backend!r} runs on the host; a device mesh "
                "requires the 'torch' or 'planar' backend"
            )
        if spmd_mode not in ("shard_map", "gspmd"):
            raise ValueError(f"Unknown spmd_mode: {spmd_mode!r}")
        self.mesh = mesh
        self.spmd_mode = spmd_mode
        self._W = W
        self._fov = fov
        self._N = N
        self._yB_size = yB_size
        self._yN_size = yN_size
        self._xA_size = xA_size
        self._xM_size = xM_size
        if core_state is None:
            self.core = SwiftlyCore(
                W, N, xM_size, yN_size, backend=backend, dtype=dtype,
                device=device,
            )
        else:
            Fb, Fn = core_state
            self.core = SwiftlyCore.from_numpy_state(
                W, N, xM_size, yN_size, Fb, Fn, backend=backend, dtype=dtype,
                device=device,
            )

    @classmethod
    def from_numpy_state(cls, Fb, Fn, **params):
        """A configuration whose core takes the window constants (Fb, Fn)
        as given (numpy float64, e.g. the JAX core's ``_Fb``/``_Fn``), so
        its operators and windows come from the same numbers; `params`
        are this class's other arguments."""
        return cls(core_state=(Fb, Fn), **params)

    @property
    def image_size(self):
        """Size of the entire (virtual) image in pixels."""
        return self._N

    @property
    def max_facet_size(self):
        """Maximum true facet size in pixels."""
        return self._yB_size

    @property
    def max_subgrid_size(self):
        """Maximum true subgrid size in pixels."""
        return self._xA_size

    @property
    def pswf_parameter(self):
        """PSWF window parameter W."""
        return self._W

    @property
    def fov(self):
        """Field-of-view fraction."""
        return self._fov

    @property
    def internal_facet_size(self):
        """Padded facet size used internally (yN)."""
        return self._yN_size

    @property
    def internal_subgrid_size(self):
        """Padded subgrid size used internally (xM)."""
        return self._xM_size

    @property
    def contribution_size(self):
        """Per-axis size of one facet<->subgrid contribution block."""
        return self.core.xM_yN_size

    @property
    def facet_off_step(self):
        """All facet offsets must be multiples of this (= N/xM)."""
        return self.core.facet_off_step

    @property
    def subgrid_off_step(self):
        """All subgrid offsets must be multiples of this (= N/yN)."""
        return self.core.subgrid_off_step
