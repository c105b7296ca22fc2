"""Visibility-space serving: degrid/grid as the product surface.

The port of the JAX package's ``swiftly_tpu.vis``. The serving stack
answers *subgrid* rows; this package turns those rows into the quantity
interferometry clients consume — visibility samples at arbitrary
fractional (u, v) — and back:

* `vis.kernel` — PSWF-derived separable degridding kernel + image-plane
  grid correction (host-side precompute, accuracy contract
  ``DEGRID_TOLERANCE``);
* `vis.mapping` — sample -> owning-subgrid index over the served cover
  (outside-cover samples are shed, never answered wrong);
* `vis.degrid` — one launch of kernel B4 per serving pump, over the
  pump's rows, the tap weights computed on the card (the gather fused;
  its plain version on the CPU), and the reference's one-row
  `degrid_batch`;
* `vis.grid` — the exact adjoint, a deterministic scatter kernel, and
  the version-pinned `VisGridder` accumulator feeding
  `parallel.streamed.StreamedBackward.add_subgrid_group`;
* `vis.service` — `VisibilityService`, the product surface: admission /
  coalescing / cache-feed / compute-fallback / facet-update version
  gates, shared with `serve`;
* `vis.oracle` — direct-DFT reference for accuracy audits.
* `vis.service.FleetRowSource` — the row fetch routed through a
  `serve.fleet.ServeFleet`.
"""

from .degrid import bucket_size, degrid_batch, degrid_rows, split_row_planes
from .grid import ADJOINT_TOLERANCE, VisGridder, grid_batch
from .kernel import DEGRID_TOLERANCE, MAX_BAND, VisKernel, vis_kernel
from .mapping import VisCoverIndex
from .oracle import corrected_sources, vis_oracle
from .service import (
    FleetRowSource,
    VisHandle,
    VisibilityService,
    VisRequest,
)

__all__ = [
    "ADJOINT_TOLERANCE",
    "DEGRID_TOLERANCE",
    "FleetRowSource",
    "MAX_BAND",
    "VisCoverIndex",
    "VisGridder",
    "VisHandle",
    "VisKernel",
    "VisRequest",
    "VisibilityService",
    "bucket_size",
    "corrected_sources",
    "degrid_batch",
    "degrid_rows",
    "grid_batch",
    "split_row_planes",
    "vis_kernel",
    "vis_oracle",
]
