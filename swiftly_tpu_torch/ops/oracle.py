"""Analytic source-model oracle and mask generation (host-side, numpy).

A numpy copy of the JAX package's ``swiftly_tpu/ops/oracle.py`` (the parts
the port's slice uses): facets are built by placing point sources on an
integer pixel grid (mod N), subgrids by evaluating the direct Fourier sum of
the same sources. Every numerical claim of the port is checked against
these, exactly as the JAX package checks itself.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "SparseRealFacet",
    "generate_masks",
    "make_facet_from_sources",
    "make_real_facet_plane_from_sources",
    "make_sparse_real_facet_from_sources",
    "make_subgrid_from_sources",
    "mask_from_slices",
]


def make_facet_from_sources(
    sources,
    image_size: int,
    facet_size: int,
    facet_offsets,
    facet_masks=None,
):
    """Build a facet (image-space chunk) from a point-source list.

    Each source is an ``(intensity, *coords)`` tuple with integer image
    coordinates relative to the image centre; coordinates wrap modulo
    `image_size`. The number of offsets determines the dimensionality.
    """
    ndim = len(facet_offsets)
    facet = np.zeros(ndim * (facet_size,), dtype=complex)
    centre_of_facet = np.asarray(facet_offsets, dtype=int) - facet_size // 2

    for intensity, *coords in sources:
        if len(coords) != ndim:
            raise ValueError(
                f"Source has {len(coords)} coordinates, expected {ndim}"
            )
        rel = np.mod(np.asarray(coords, dtype=int) - centre_of_facet, image_size)
        if np.all((rel >= 0) & (rel < facet_size)):
            facet[tuple(rel)] += intensity

    # the masks scale the pixels that hold a value, in the order and with
    # the arithmetic of a whole-plane product (every other pixel is 0 and
    # stays 0), without a pass over the plane per mask
    hit = np.nonzero(facet)
    vals = facet[hit]
    for axis, mask in enumerate(facet_masks or []):
        if mask is not None:
            vals = vals * np.asarray(mask)[hit[axis]]
    facet[hit] = vals
    return facet


def make_real_facet_plane_from_sources(
    sources,
    image_size: int,
    facet_size: int,
    facet_offsets,
    facet_masks=None,
    dtype=np.float32,
):
    """`make_facet_from_sources` as a real plane, built pointwise.

    Point-source facets are real and almost entirely zero; this writes the
    hit pixels, each scaled by its per-axis mask values, into a zeroed
    real array, without the dense complex intermediate. Equal to
    ``make_facet_from_sources(...).real``.
    """
    ndim = len(facet_offsets)
    facet = np.zeros(ndim * (facet_size,), dtype=dtype)
    centre_of_facet = np.asarray(facet_offsets, dtype=int) - facet_size // 2
    masks = [
        None if m is None else np.asarray(m)
        for m in (facet_masks or [None] * ndim)
    ]
    for intensity, *coords in sources:
        if len(coords) != ndim:
            raise ValueError(
                f"Source has {len(coords)} coordinates, expected {ndim}"
            )
        rel = np.mod(np.asarray(coords, dtype=int) - centre_of_facet, image_size)
        if np.all((rel >= 0) & (rel < facet_size)):
            scale = float(intensity)
            for axis, mask in enumerate(masks):
                if mask is not None:
                    scale *= float(mask[rel[axis]])
            facet[tuple(rel)] += scale
    return facet



class SparseRealFacet:
    """A real facet plane as coordinates and values: zeros plus a few
    pixels.

    Point-source facet models are almost entirely zero: at 128k one dense
    real plane is 8.1 GB, its content a handful of mask-scaled pixels. The
    streamed forward synthesises the dense plane on the device from these
    pixels instead of uploading it; the transform itself still runs
    densely.
    """

    def __init__(self, size, rows, cols, vals):
        self.size = int(size)
        self.rows = np.asarray(rows, dtype=np.int32)
        self.cols = np.asarray(cols, dtype=np.int32)
        self.vals = np.asarray(vals)
        if not (len(self.rows) == len(self.cols) == len(self.vals)):
            raise ValueError("rows/cols/vals must have equal length")

    @property
    def n_pixels(self):
        return len(self.vals)

    def densify(self, dtype=None):
        """The equivalent dense real plane (duplicates accumulate, in
        index order)."""
        out = np.zeros((self.size, self.size), dtype=dtype or self.vals.dtype)
        np.add.at(out, (self.rows, self.cols), self.vals)
        return out

    def coalesced(self, dtype=None):
        """(flat pixel indices, values) with each pixel once: duplicates
        summed in index order from a zero of `dtype`, exactly as
        `densify` adds them, so assigning these into a zeroed plane gives
        `densify(dtype)` bit for bit."""
        flat = self.rows.astype(np.int64) * self.size + self.cols
        uniq, inv = np.unique(flat, return_inverse=True)
        vals = np.zeros(len(uniq), dtype=dtype or self.vals.dtype)
        np.add.at(vals, inv.reshape(-1), self.vals)
        return uniq, vals


def make_sparse_real_facet_from_sources(
    sources,
    image_size: int,
    facet_size: int,
    facet_offsets,
    facet_masks=None,
    dtype=np.float32,
):
    """`make_real_facet_plane_from_sources` as a `SparseRealFacet`: the
    same pixel and mask arithmetic (``densify()`` equals that function's
    plane); 2D only, as the streamed executors that take it are."""
    if len(facet_offsets) != 2:
        raise ValueError("sparse facets are 2D (two offsets required)")
    centre = np.asarray(facet_offsets, dtype=int) - facet_size // 2
    masks = [
        None if m is None else np.asarray(m)
        for m in (facet_masks or [None, None])
    ]
    rows, cols, vals = [], [], []
    for intensity, *coords in sources:
        if len(coords) != 2:
            raise ValueError(
                f"Source has {len(coords)} coordinates, expected 2"
            )
        rel = np.mod(np.asarray(coords, dtype=int) - centre, image_size)
        if np.all((rel >= 0) & (rel < facet_size)):
            scale = float(intensity)
            for axis, mask in enumerate(masks):
                if mask is not None:
                    scale *= float(mask[rel[axis]])
            rows.append(int(rel[0]))
            cols.append(int(rel[1]))
            vals.append(scale)
    return SparseRealFacet(
        facet_size, rows, cols, np.asarray(vals, dtype=dtype)
    )

def make_subgrid_from_sources(
    sources,
    image_size: int,
    subgrid_size: int,
    subgrid_offsets,
    subgrid_masks=None,
):
    """Build a subgrid (grid-space chunk) by direct Fourier transform.

    Exact DFT of the point-source model, normalised by image_size per
    dimension. The expensive-but-exact ground truth.
    """
    ndim = len(subgrid_offsets)
    # Per-axis uv coordinate ranges centred on each subgrid offset
    axes_uv = [
        np.arange(off - subgrid_size // 2, off + (subgrid_size + 1) // 2)
        for off in subgrid_offsets
    ]
    subgrid = np.zeros(ndim * (subgrid_size,), dtype=complex)
    for intensity, *coords in sources:
        if len(coords) != ndim:
            raise ValueError(
                f"Source has {len(coords)} coordinates, expected {ndim}"
            )
        term = np.asarray(intensity / image_size**ndim, dtype=complex)
        # Separable phase factors: exp(2πi u_d x_d / N) outer-multiplied
        for axis, (uv, x) in enumerate(zip(axes_uv, coords)):
            phase = np.exp((2j * np.pi / image_size) * uv * x)
            shape = [1] * ndim
            shape[axis] = -1
            term = term * np.reshape(phase, shape)
        subgrid += term

    for axis, mask in enumerate(subgrid_masks or []):
        if mask is not None:
            shape = [1] * ndim
            shape[axis] = -1
            subgrid = subgrid * np.reshape(np.asarray(mask), shape)
    return subgrid


def generate_masks(image_size: int, mask_size: int, offsets) -> np.ndarray:
    """Per-offset 0/1 ownership masks for a 1D cover.

    Boundaries between consecutive chunks sit at the midpoint of their
    offsets (wrapping at image_size), so every image pixel belongs to
    exactly one chunk. Parity: reference ``generate_masks``
    (``fourier_algorithm.py:318-344``).
    """
    offsets = np.asarray(offsets)
    nxt = np.concatenate([offsets[1:], [image_size + offsets[0]]])
    border = (offsets + nxt) // 2
    masks = np.zeros((len(offsets), mask_size), dtype=int)
    for i, off in enumerate(offsets):
        left = border[i - 1] - off + mask_size // 2
        if i == 0:
            # row 0's left border wraps around the image
            left %= image_size
        right = border[i] - off + mask_size // 2
        if left < 0 or right > mask_size:
            raise ValueError(
                "Mask size too small to cover this facet/subgrid layout"
            )
        masks[i, left:right] = 1
    return masks


def mask_from_slices(slice_list, mask_size: int) -> np.ndarray:
    """Realise a 0/1 mask from a list of slices (sparse mask storage)."""
    mask = np.zeros((mask_size,))
    for sl in slice_list:
        mask[sl] = 1
    return mask
