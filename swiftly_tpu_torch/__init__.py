"""swiftly_tpu_torch: the PyTorch/CUDA port of swiftly-tpu.

Bidirectional facet <-> subgrid transforms between image space and uv-grid
space that never materialise the full N x N plane, on one NVIDIA GPU,
whole-cover (``SwiftlyForward`` / ``backward_all``) or streamed
(``StreamedForward`` / ``StreamedBackward``: the facets resident, or
streamed in slabs from the host or synthesised on the device from sparse
facets, ``make_sparse_facet``; the backward's accumulator whole or in
output-row slabs):
complex torch tensors (``backend="torch"``), or the planar (re, im) layout
whose DFTs run in hand-written Hopper kernels (``backend="planar"``), with
a float64 numpy host reference (``backend="numpy"``). The JAX package
``swiftly_tpu`` is the reference this package is tested against; this
package imports nothing of it, and no JAX.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

from .api import (
    FacetConfig,
    FlightQueue,
    LRUCache,
    SubgridConfig,
    SwiftlyBackward,
    SwiftlyConfig,
    SwiftlyForward,
    backward_all,
    check_facet,
    check_residual,
    check_subgrid,
    make_facet,
    make_full_facet_cover,
    make_full_subgrid_cover,
    make_real_facet,
    make_sparse_facet,
    make_sparse_facet_cover,
    make_subgrid,
    sparse_fov_cover_offsets,
)
from .models import SWIFT_CONFIGS
from .ops import (
    SparseRealFacet,
    SwiftlyCore,
    cmatmul_stats,
    colpass_stats,
    degrid_stats,
    fold_stats,
    grid_stats,
    make_facet_from_sources,
    make_subgrid_from_sources,
)
from .parallel import StreamedBackward, StreamedForward, feed_backward_passes

__version__ = "0.1.0"

__all__ = [
    "FacetConfig",
    "FlightQueue",
    "LRUCache",
    "SWIFT_CONFIGS",
    "SparseRealFacet",
    "StreamedBackward",
    "StreamedForward",
    "SubgridConfig",
    "SwiftlyBackward",
    "SwiftlyConfig",
    "SwiftlyCore",
    "SwiftlyForward",
    "backward_all",
    "check_facet",
    "check_residual",
    "check_subgrid",
    "cmatmul_stats",
    "colpass_stats",
    "degrid_stats",
    "feed_backward_passes",
    "fold_stats",
    "grid_stats",
    "make_facet",
    "make_facet_from_sources",
    "make_full_facet_cover",
    "make_full_subgrid_cover",
    "make_real_facet",
    "make_sparse_facet",
    "make_sparse_facet_cover",
    "make_subgrid",
    "make_subgrid_from_sources",
    "sparse_fov_cover_offsets",
]
