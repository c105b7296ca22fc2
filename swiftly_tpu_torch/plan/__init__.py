"""The plan compiler: one cost model for geometry, memory and schedule.

The port of the JAX package's ``swiftly_tpu/plan/``, in three parts:

* ``plan.model``: the declarative cost model (`PlanInputs` priced into
  per-stage bytes, FLOPs and estimated walls with `CostCoefficients`
  whose defaults were measured on the port's card), the one device
  budget parser (`hbm_budget_bytes`), the serve buckets and the
  admission byte projections;
* ``plan.compiler``: `compile_plan` searches the model and emits one
  `Plan`: the backward pass grid and feed schedule, the spill policy,
  the serve shapes, the mesh layout and the forward's predicted
  grouping; plus `plan_delta` and `price_cache_tier` (pricing only);
* ``plan.autotune``: `refit` and `refit_from_ledger` turn measured
  history into calibrated coefficients, which alone may change a plan's
  parameters; ``plan.vis`` prices the visibility-serving dispatch shape.
"""

from . import autotune, compiler, model
from .autotune import (
    ledger_readiness,
    load_history,
    refit,
    refit_from_ledger,
)
from .compiler import (
    BackwardPlan,
    CacheTierPlan,
    DeltaPlan,
    MeshLayout,
    Plan,
    ServePlan,
    SpillPolicy,
    compile_plan,
    plan_backward_feed,
    plan_backward_passes,
    plan_delta,
    plan_margins,
    plan_mesh_layout,
    price_cache_tier,
    stamp_measured_wall,
)
from .model import (
    CostCoefficients,
    PlanInputs,
    bucket_shape,
    bucket_sizes,
    hbm_budget_bytes,
    price_collective_candidates,
    price_colpass_candidates,
    projected_column_bytes,
    projected_request_bytes,
)
from .vis import VisPlan, price_vis

__all__ = [
    "BackwardPlan",
    "CacheTierPlan",
    "CostCoefficients",
    "DeltaPlan",
    "MeshLayout",
    "Plan",
    "PlanInputs",
    "ServePlan",
    "SpillPolicy",
    "VisPlan",
    "autotune",
    "bucket_shape",
    "bucket_sizes",
    "compile_plan",
    "compiler",
    "hbm_budget_bytes",
    "ledger_readiness",
    "load_history",
    "model",
    "plan_backward_feed",
    "plan_backward_passes",
    "plan_delta",
    "plan_margins",
    "plan_mesh_layout",
    "price_cache_tier",
    "price_collective_candidates",
    "price_colpass_candidates",
    "price_vis",
    "projected_column_bytes",
    "projected_request_bytes",
    "refit",
    "refit_from_ledger",
    "stamp_measured_wall",
]
