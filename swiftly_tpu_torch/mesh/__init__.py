"""Mesh-streamed engine: the streamed facet<->subgrid pipeline over a
facet mesh (the torch twin of ``swiftly_tpu.mesh``).

`MeshStreamedForward` / `MeshStreamedBackward` mirror the streamed
executors' API with the facet stack sharded over a
`parallel.mesh.FacetMesh` (virtual shards on one device, distinct
devices, or the devices of several processes), one collective a forward column (``SWIFTLY_MESH_COLLECTIVE``:
psum or ring), and the plan compiler's `MeshLayout` bound.
`mesh.recovery` adds the elastic rung: a lost shard re-plans the layout
on the survivors, migrates the last autosave across layouts and resumes
the stream.

A mesh spans processes after `initialize_multihost` (or
`parallel.mesh.bootstrap_from_env`): each rank builds and computes only
its own shards, and `host_gather` leaves the other ranks' rows zero.
"""

from ..parallel.mesh import (
    FACET_AXIS,
    facet_sharding,
    initialize_multihost,
    make_facet_mesh,
    mesh_size,
    pad_to_shards,
)
from .engine import (
    MeshStreamedBackward,
    MeshStreamedForward,
    attach_mesh,
    host_gather,
    host_replica,
    resolve_facet_shards,
)
from .recovery import recover_engines, run_elastic_pass, survivor_mesh

__all__ = [
    "FACET_AXIS",
    "MeshStreamedBackward",
    "MeshStreamedForward",
    "attach_mesh",
    "facet_sharding",
    "host_gather",
    "host_replica",
    "initialize_multihost",
    "make_facet_mesh",
    "mesh_size",
    "pad_to_shards",
    "recover_engines",
    "resolve_facet_shards",
    "run_elastic_pass",
    "survivor_mesh",
]
