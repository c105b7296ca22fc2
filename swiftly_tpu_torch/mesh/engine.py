"""Mesh-streamed engine: the streamed pipeline over a facet mesh.

The torch twin of the JAX package's ``swiftly_tpu/mesh/engine.py``.
`MeshStreamedForward` / `MeshStreamedBackward` are the streamed
executors (`parallel.streamed`) built over a config with a
`parallel.mesh.FacetMesh` attached: the facet stack is zero-padded to the
mesh size, each shard runs the streamed bodies on its local facets on
its device, and the forward's per-column partials are summed over the
shards by one `parallel.sharded.collective_sum` a column, the pipeline's
only collective. Every facet-side op (sampled facet pass, backward
column pass, the folds and finishes) is local to its shard.

* The engines bind the plan compiler's `plan.compiler.MeshLayout`
  (``layout=compile_plan(..., n_devices=k).mesh``): the shard count is
  checked against the mesh, the executed padding recorded, and
  ``status`` flipped to ``"bound"`` (gauge ``mesh.layout``).
* `parallel.streamed.feed_backward_passes` drives the mesh engines
  unchanged: they speak the streamed API.
* Fault sites: ``mesh.shard_loss`` once per yielded forward group,
  ``mesh.feed`` once per backward group feed, and ``mesh.psum`` /
  ``mesh.ring_step`` (whichever schedule the group's collective ran) on
  the recording's wait for a group, under the collective watchdog
  (``SWIFTLY_COLLECTIVE_TIMEOUT_S``), so a stalled collective raises
  `resilience.CollectiveStalledError` instead of hanging. `rebuild_on`
  makes the same engine on a survivor mesh for `mesh.recovery`.
* ``SWIFTLY_MESH_COLLECTIVE`` = psum | ring | auto picks the schedule of
  the facet sum, read at each stream.

Exactness: per facet the mesh backward is the single-device backward
(each shard's executor runs the same bodies on its own facets), so a
mesh backward fed a stream gives the bits a single-device backward fed
the same stream gives. The forward's subgrids differ from the
single-device forward's only by the order of the facet sum (the shards'
local sums, then the collective).

Quick start (CPU, 8 virtual shards)::

    from swiftly_tpu_torch.mesh import (
        MeshStreamedBackward, MeshStreamedForward, make_facet_mesh)
    mesh = make_facet_mesh(devices=["cpu"] * 8)
    fwd = MeshStreamedForward(config, facet_tasks, mesh=mesh)
    bwd = MeshStreamedBackward(config, facet_configs, mesh=mesh)
    feed_backward_passes(fwd, subgrid_configs, [bwd])
    facets = bwd.finish()
"""

from __future__ import annotations

import copy
import logging

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..parallel.mesh import (
    FACET_AXIS,
    ShardedStack,
    make_facet_mesh,
    mesh_size,
    resolve_collective,
)
from ..parallel.streamed import StreamedBackward, StreamedForward
from ..resilience.faults import fault_point as _fault_point
from ..resilience.watchdog import watch_collective as _watch

__all__ = [
    "MeshStreamedBackward",
    "MeshStreamedForward",
    "attach_mesh",
    "host_gather",
    "host_replica",
    "resolve_facet_shards",
]

logger = logging.getLogger(__name__)


def resolve_facet_shards(n_facets, n_devices=None):
    """Facet-shard count for a cover: every visible CUDA device (or
    `n_devices`), capped at the facet count (a shard with no real facet
    would hold only zero padding: exact, but pure waste)."""
    if n_devices is None:
        n_devices = torch.cuda.device_count()
    return max(1, min(int(n_devices), int(n_facets)))


def attach_mesh(swiftly_config, mesh):
    """A shallow copy of ``swiftly_config`` with ``mesh`` attached; the
    copy shares the numerical core, and the caller's config is never
    changed."""
    if swiftly_config.core.backend in ("numpy", "native"):
        raise ValueError(
            "a device mesh requires the 'torch' or 'planar' backend"
        )
    cfg = copy.copy(swiftly_config)
    cfg.mesh = mesh
    return cfg


def host_replica(arr):
    """One host copy of a replicated mesh result: a tensor (the first
    shard's copy) or a `ShardedStack` of replicas (its first addressable
    shard: this rank's first, over processes; nothing crosses ranks)."""
    if isinstance(arr, ShardedStack):
        arr = arr.shards[0]
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def host_gather(arr):
    """Host copy of a (possibly facet-sharded) mesh result: a
    `ShardedStack` gathered over its shards, its placement padding
    dropped (over processes the global shape, the rows of other ranks'
    shards zero, as the JAX package's addressable-shard gather); a
    tensor or array as it is."""
    if isinstance(arr, ShardedStack):
        return arr.numpy()
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def _resolve_mesh(swiftly_config, n_facets, layout, mesh, n_devices):
    """(mesh, layout) for an engine: an explicit mesh wins, else the
    config's own mesh, else one over the layout's shard count of visible
    devices, else every visible device (capped at the facet count). A
    layout, when given, must agree with the mesh it is bound to."""
    if mesh is None:
        mesh = getattr(swiftly_config, "mesh", None)
    if mesh is None:
        shards = (
            int(layout.facet_shards)
            if layout is not None
            else resolve_facet_shards(n_facets, n_devices)
        )
        mesh = make_facet_mesh(n_devices=shards)
    if layout is not None and int(layout.facet_shards) != mesh_size(mesh):
        raise ValueError(
            f"MeshLayout plans {layout.facet_shards} facet shard(s) but "
            f"the mesh has {mesh_size(mesh)} device(s); compile the plan "
            f"with n_devices={mesh_size(mesh)} or build the matching mesh"
        )
    return mesh, layout


def _bind_layout(layout, engine):
    """Flip the plan's MeshLayout to ``bound`` and record the padding the
    engine executed."""
    if layout is None:
        return None
    layout.padded_facets = int(engine.stack.n_total)
    layout.status = "bound"
    if _metrics.enabled():
        _metrics.gauge("mesh.layout", dict(layout.as_dict()))
    return layout


class MeshStreamedForward(StreamedForward):
    """`StreamedForward` over a facet mesh (sampled streaming, facets
    resident on their shards).

    :param layout: optional `plan.compiler.MeshLayout` (e.g.
        ``compile_plan(...).mesh``), checked against the mesh and flipped
        to ``status: "bound"``
    :param mesh: the `FacetMesh` (share it with the backward); default:
        the config's mesh, else one over ``n_devices`` visible cards
    :param n_devices: card count when neither layout nor mesh is given
    """

    def __init__(self, swiftly_config, facet_tasks, layout=None, mesh=None,
                 n_devices=None, col_block=512, col_group=None):
        mesh, layout = _resolve_mesh(
            swiftly_config, len(facet_tasks), layout, mesh, n_devices
        )
        super().__init__(
            attach_mesh(swiftly_config, mesh), facet_tasks,
            col_block=col_block, residency="device", col_group=col_group,
        )
        self.mesh = mesh
        self.layout = _bind_layout(layout, self)
        self._rebuild_kw = dict(
            swiftly_config=swiftly_config, facet_tasks=facet_tasks,
            col_block=col_block, col_group=col_group,
        )

    @property
    def facet_shards(self):
        return mesh_size(self.mesh)

    @property
    def collective(self):
        """The facet-axis schedule the next stream runs (``psum`` or
        ``ring``), read from ``SWIFTLY_MESH_COLLECTIVE`` now."""
        return resolve_collective(self.facet_shards)

    def rebuild_on(self, mesh, layout=None):
        """A fresh engine of the same construction on another mesh (the
        elastic recovery hook; the collective re-resolves for the new
        shard count). This engine is left as it is. The rebuilt engine
        keeps this one's column grouping, so a resumed stream cuts the
        groups the autosave's ledger skips whole."""
        engine = type(self)(mesh=mesh, layout=layout, **self._rebuild_kw)
        engine.col_group = self.col_group
        return engine

    def stream_column_groups(self, subgrid_configs, spill=None):
        """`StreamedForward.stream_column_groups` with the
        ``mesh.shard_loss`` fault site fired once per yielded group (the
        place a drill loses a shard mid-stream, between group
        boundaries)."""
        for item in super().stream_column_groups(subgrid_configs,
                                                 spill=spill):
            _fault_point("mesh.shard_loss")
            yield item

    def layout_summary(self):
        """The executed mesh layout as a dict."""
        return {
            "n_devices": self.facet_shards,
            "facet_shards": self.facet_shards,
            "axis": FACET_AXIS,
            "n_facets": int(self.stack.n_real),
            "padded_facets": int(self.stack.n_total),
            "collective": self.collective,
        }

    def _record_sync(self):
        """The recording's wait for a group: the first point where the
        host blocks on the group's collective, so the engine's stall
        detector. It runs the ``mesh.psum`` (under the ring,
        ``mesh.ring_step``) fault site and the wait on the group's CUDA
        event under the collective watchdog, so a collective hung on a
        lost shard raises `CollectiveStalledError` instead of blocking.
        The recorder runs it on its worker one group behind compute."""
        site = ("mesh.ring_step" if self.collective == "ring"
                else "mesh.psum")

        def sync(ready):
            def wait():
                _fault_point(site)
                if ready is not None:
                    ready.synchronize()

            _watch(wait, site)

        return sync


class MeshStreamedBackward(StreamedBackward):
    """`StreamedBackward` over a facet mesh.

    The same API (group and stack feeding, fold groups, ``row_slab``,
    autosave and resume); each shard folds into its own accumulator on
    its device with no collective, and checkpoints record the mesh layout
    (`utils.checkpoint`), which a restore onto another layout migrates.
    """

    def __init__(self, swiftly_config, facet_configs, layout=None,
                 mesh=None, n_devices=None, col_block=512,
                 residency="sampled", fold_group=4, row_slab=None):
        mesh, layout = _resolve_mesh(
            swiftly_config, len(facet_configs), layout, mesh, n_devices
        )
        super().__init__(
            attach_mesh(swiftly_config, mesh), facet_configs,
            col_block=col_block, residency=residency,
            fold_group=fold_group, row_slab=row_slab,
        )
        self.mesh = mesh
        self.layout = _bind_layout(layout, self)
        self._rebuild_kw = dict(
            swiftly_config=swiftly_config, facet_configs=facet_configs,
            col_block=col_block, residency=residency,
            fold_group=fold_group, row_slab=row_slab,
        )

    @property
    def facet_shards(self):
        return mesh_size(self.mesh)

    def rebuild_on(self, mesh, layout=None):
        """A fresh, empty engine of the same construction on another mesh;
        `mesh.recovery` migrates the last autosave into it
        (`utils.checkpoint.restore_streamed_backward_state`)."""
        return type(self)(mesh=mesh, layout=layout, **self._rebuild_kw)

    def add_subgrid_group(self, col_sg_lists, subgrids_group):
        """`StreamedBackward.add_subgrid_group` behind the ``mesh.feed``
        fault site (the mesh feed's own site, apart from ``bwd.feed``
        inside, so a drill can fault the mesh run and not a
        single-device reference beside it)."""
        _fault_point("mesh.feed")
        return super().add_subgrid_group(col_sg_lists, subgrids_group)
