"""Shared cache fabric: one recorded subgrid stream, N replica views.

`SharedStreamTier` is the fleet-wide two-tier cache — a single
versioned, spill-backed L2 over the recorded stream plus per-replica
hot-row L1 views (`FabricFeedView`) with single-flight recompute dedup.
`plan.price_cache_tier` prices the L1/L2/recompute trade. The port of
the JAX package's ``swiftly_tpu.cache``.
"""

from .fabric import FabricFeedView, SharedStreamTier

__all__ = ["FabricFeedView", "SharedStreamTier"]
