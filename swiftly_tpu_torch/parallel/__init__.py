"""Execution over facet and subgrid stacks: the batched whole-cover path,
the streamed (facets-resident / sampled) path, and facet meshes, in one
process or across processes, with their sharded programs (`mesh`,
`sharded`).

Every public name is re-exported here, as the JAX package's
``swiftly_tpu.parallel`` does (``from swiftly_tpu_torch.parallel import
make_facet_mesh, FACET_AXIS``); the mesh-streamed engine is
`swiftly_tpu_torch.mesh`.
"""

from . import batched, mesh, sharded, streamed
from .mesh import (
    FACET_AXIS,
    facet_sharding,
    initialize_multihost,
    make_facet_mesh,
    mesh_size,
    pad_to_shards,
    place_facet_sharded,
    replicated_sharding,
)
from .sharded import (
    backward_all_sharded,
    forward_all_sharded,
    split_accumulate_sharded,
    split_subgrid_sharded,
    subgrid_from_columns_sharded,
    subgrids_from_columns_sharded,
)
from .streamed import (
    CachedColumnFeed,
    StreamedBackward,
    StreamedForward,
    feed_backward_passes,
)

__all__ = [
    "CachedColumnFeed",
    "FACET_AXIS",
    "StreamedBackward",
    "StreamedForward",
    "backward_all_sharded",
    "batched",
    "facet_sharding",
    "feed_backward_passes",
    "forward_all_sharded",
    "initialize_multihost",
    "make_facet_mesh",
    "mesh",
    "mesh_size",
    "pad_to_shards",
    "place_facet_sharded",
    "replicated_sharding",
    "sharded",
    "split_accumulate_sharded",
    "split_subgrid_sharded",
    "streamed",
    "subgrid_from_columns_sharded",
    "subgrids_from_columns_sharded",
]
