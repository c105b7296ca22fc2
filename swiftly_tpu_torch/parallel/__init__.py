"""Batched execution over facet and subgrid stacks (single device)."""

from . import batched

__all__ = ["batched"]
