"""Cover generation: how facets/subgrids tile the image and grid planes.

Two families:

* **Full covers** — a regular tiling where every pixel belongs to exactly
  one chunk (mid-point borders between neighbouring offsets, wrapping at
  the image edge).

* **Sparse covers** — irregular facet layouts covering only a circular
  field of view; facets need not tile the whole image.

A copy of the JAX package's ``swiftly_tpu/models/covers.py`` (pure Python
and numpy), kept here so the port imports nothing of that package.
"""

from __future__ import annotations

import math

import numpy as np

from .config import FacetConfig, SubgridConfig

__all__ = [
    "make_full_cover",
    "make_full_facet_cover",
    "make_full_subgrid_cover",
    "sparse_fov_cover_offsets",
    "make_sparse_facet_cover",
]


def make_full_cover(N: int, chunk_size: int, cls):
    """Regular 2D tiling of an N x N plane with `chunk_size` chunks.

    Offsets are multiples of chunk_size; each chunk's ownership mask covers
    the pixels closer to its offset than to any neighbour's (borders at
    offset mid-points, wrapping at N).
    """
    offsets = chunk_size * np.arange(math.ceil(N / chunk_size))
    nxt = np.concatenate([offsets[1:], [N + offsets[0]]])
    border = (offsets + nxt) // 2
    half = chunk_size // 2

    def axis_mask(i, off):
        left = (border[i - 1] - off + half) % N
        right = border[i] - off + half
        return [[slice(int(left), int(right))], chunk_size]

    configs = []
    for i0, off0 in enumerate(offsets):
        for i1, off1 in enumerate(offsets):
            configs.append(
                cls(
                    off0,
                    off1,
                    chunk_size,
                    axis_mask(i0, off0),
                    axis_mask(i1, off1),
                )
            )
    return configs


def make_full_subgrid_cover(swiftly_config):
    """Full subgrid tiling of the grid plane for a SwiftlyConfig."""
    return make_full_cover(
        swiftly_config.image_size,
        swiftly_config.max_subgrid_size,
        SubgridConfig,
    )


def make_full_facet_cover(swiftly_config):
    """Full facet tiling of the image plane for a SwiftlyConfig."""
    return make_full_cover(
        swiftly_config.image_size,
        swiftly_config.max_facet_size,
        FacetConfig,
    )


# ---------------------------------------------------------------------------
# Sparse circular-FoV covers
# ---------------------------------------------------------------------------


def _row_offsets(facet_size: int, nfacet: int, N: int):
    """Offsets of `nfacet` facets covering one row, centre-out.

    Odd counts place a facet at offset 0; even counts straddle the centre.
    Negative offsets are expressed as N - off (mod-N convention).
    """
    offs = []
    if nfacet % 2 == 0:
        first = facet_size // 2
        for i in range(nfacet // 2):
            right = first + i * facet_size
            offs.extend([right, N - right])
    else:
        offs.append(0)
        for i in range(1, (nfacet + 1) // 2):
            right = i * facet_size
            offs.extend([right, N - right])
    return offs


def _rows_for_fov(facet_size: int, fov_pixels: int, N: int):
    """(nfacet, off1) per facet row needed to cover a circular FoV.

    Each row's facet count shrinks with distance from the centre following
    the circle's chord length.
    """
    n_rows = math.ceil(fov_pixels / facet_size)
    rows = []

    def chord(off1_up):
        if off1_up == 0:
            return fov_pixels
        return 2 * math.sqrt(
            max((fov_pixels / 2) ** 2 - (off1_up - facet_size / 2) ** 2, 0.0)
        )

    if n_rows % 2 == 0:
        first = facet_size // 2
        for i in range(n_rows // 2):
            up = first + i * facet_size
            width = fov_pixels if i == 0 else chord(up)
            nfacet = math.ceil(width / facet_size)
            rows.extend([(nfacet, up), (nfacet, N - up)])
    else:
        rows.append((n_rows, 0))
        for i in range(1, (n_rows + 1) // 2):
            up = i * facet_size
            nfacet = math.ceil(chord(up) / facet_size)
            rows.extend([(nfacet, up), (nfacet, N - up)])
    return rows


def sparse_fov_cover_offsets(swiftly_config, fov_pixels: int, x0: int = 0, y0: int = 0):
    """(off0, off1) list + mask list for facets covering a circular FoV.

    :param swiftly_config: SwiftlyConfig
    :param fov_pixels: diameter of the field of view, in pixels
    :param x0: FoV centre offset along axis 0
    :param y0: FoV centre offset along axis 1
    :raises ValueError: if any resulting offset is not a multiple of
        facet_off_step (the core's divisibility requirement)
    """
    N = swiftly_config.image_size
    facet_size = swiftly_config.max_facet_size
    offsets = []
    for nfacet, off1 in _rows_for_fov(facet_size, fov_pixels, N):
        for off0 in _row_offsets(facet_size, nfacet, N):
            offsets.append((off0 + x0, off1 + y0))

    step = swiftly_config.facet_off_step
    for off0, off1 in offsets:
        if off0 % step or off1 % step:
            raise ValueError(
                f"Sparse facet offset ({off0},{off1}) not divisible by "
                f"facet offset step {step}"
            )

    full = [[slice(None)], facet_size]
    masks = [(full, full) for _ in offsets]
    return offsets, masks


def make_sparse_facet_cover(facet_size: int, offsets, masks):
    """Build FacetConfigs from (off0, off1) and (mask0, mask1) lists."""
    return [
        FacetConfig(off0, off1, facet_size, m0, m1)
        for (off0, off1), (m0, m1) in zip(offsets, masks)
    ]
