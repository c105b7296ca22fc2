"""Transform plans: chunk descriptors, covers, and the parameter catalogue
(the torch port's twin of ``swiftly_tpu.models``)."""

from .catalogue import SWIFT_CONFIGS
from .config import ChunkConfig, FacetConfig, SubgridConfig, SwiftlyConfig
from .covers import (
    make_full_cover,
    make_full_facet_cover,
    make_full_subgrid_cover,
    make_sparse_facet_cover,
    sparse_fov_cover_offsets,
)

__all__ = [
    "SWIFT_CONFIGS",
    "ChunkConfig",
    "FacetConfig",
    "SubgridConfig",
    "SwiftlyConfig",
    "make_full_cover",
    "make_full_facet_cover",
    "make_full_subgrid_cover",
    "make_sparse_facet_cover",
    "sparse_fov_cover_offsets",
]
