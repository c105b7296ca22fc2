"""Planning: the device-memory budget parser and the backward partition
plan (the port of the JAX package's ``swiftly_tpu/plan/``, in part: the
rest of the compiler and cost model is ROADMAP A10)."""

from . import compiler, model
from .compiler import plan_backward_feed, plan_backward_passes, plan_margins
from .model import hbm_budget_bytes

__all__ = [
    "compiler",
    "hbm_budget_bytes",
    "model",
    "plan_backward_feed",
    "plan_backward_passes",
    "plan_margins",
]
