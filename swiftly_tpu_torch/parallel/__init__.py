"""Execution over facet and subgrid stacks on one device: the batched
whole-cover path and the streamed (facets-resident / sampled) path."""

from . import batched, streamed
from .streamed import (
    CachedColumnFeed,
    StreamedBackward,
    StreamedForward,
    feed_backward_passes,
)

__all__ = [
    "CachedColumnFeed",
    "StreamedBackward",
    "StreamedForward",
    "batched",
    "feed_backward_passes",
    "streamed",
]
