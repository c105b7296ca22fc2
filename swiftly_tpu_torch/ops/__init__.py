"""Numerical ops: L0 primitives, PSWF windows, the kernels B1, B2, B3, B4
and B4's adjoint, and the SwiftlyCore."""

from .core import SwiftlyCore, resolve_device, validate_core_params
from .io_slices import (
    create_slice,
    roll_and_extract_mid,
    roll_and_extract_mid_axis,
)
from .kernels import (
    cmatmul,
    cmatmul_plain,
    cmatmul_stats,
    colpass,
    colpass_plain,
    colpass_stats,
    degrid,
    degrid_plain,
    degrid_rows,
    degrid_rows_plain,
    degrid_stats,
    fold,
    fold_plain,
    fold_stats,
    grid,
    grid_plain,
    grid_stats,
)
from .oracle import (
    SparseRealFacet,
    generate_masks,
    make_facet_from_sources,
    make_real_facet_plane_from_sources,
    make_sparse_real_facet_from_sources,
    make_subgrid_from_sources,
    mask_from_slices,
)
from .pswf import pswf_fb, pswf_fn, pswf_samples

__all__ = [
    "SparseRealFacet",
    "SwiftlyCore",
    "cmatmul",
    "cmatmul_plain",
    "cmatmul_stats",
    "colpass",
    "colpass_plain",
    "colpass_stats",
    "create_slice",
    "degrid",
    "degrid_plain",
    "degrid_rows",
    "degrid_rows_plain",
    "degrid_stats",
    "fold",
    "fold_plain",
    "fold_stats",
    "generate_masks",
    "grid",
    "grid_plain",
    "grid_stats",
    "make_facet_from_sources",
    "make_real_facet_plane_from_sources",
    "make_sparse_real_facet_from_sources",
    "make_subgrid_from_sources",
    "mask_from_slices",
    "pswf_fb",
    "pswf_fn",
    "pswf_samples",
    "resolve_device",
    "roll_and_extract_mid",
    "roll_and_extract_mid_axis",
    "validate_core_params",
]
