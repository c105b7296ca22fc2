"""The device-memory budget: the one parser of ``SWIFTLY_HBM_BUDGET``.

The port of ``hbm_budget_bytes`` from the JAX package's
``swiftly_tpu/plan/model.py``, with the same environment contract. Every
caller that sizes work against the card's memory (the streamed
executors' column-group sizers, the backward partition plan) reads the
budget here, so the contract cannot fork.

Not ported yet (ROADMAP A10): the rest of the cost model (``PlanInputs``,
``StageCost``, ``CostCoefficients``, the serve-batch buckets and byte
projections). The JAX module's ``DEFAULT_FWD_MIN_BYTES`` and
``DEFAULT_RESERVE_BYTES`` are memory sizes chosen on a 16 GB TPU and are
not carried across: `plan.compiler.plan_margins` derives the port's from
its own geometry.
"""

from __future__ import annotations

import os

import torch

__all__ = ["hbm_budget_bytes"]


def _probe_device_bytes(device, held=0):
    """Device bytes a caller may use on a CUDA `device`: the driver's free
    bytes (``torch.cuda.mem_get_info``), plus what PyTorch's allocator
    holds cached but unused, plus `held`, device bytes the caller already
    holds and prices itself (e.g. resident facets)."""
    free, _ = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return free + cached + held


def hbm_budget_bytes(headroom=0.0, device=None, default=None,
                     honor_env_on_cpu=True, held=0):
    """Per-device memory budget in bytes: THE parser of
    ``SWIFTLY_HBM_BUDGET``.

    ``None`` means unlimited (the CPU, or no probe and no ``default``).

    :param headroom: caller-held resident bytes subtracted from the budget
        (e.g. `StreamedForward.hbm_headroom`)
    :param device: the device to size for; None: the card if there is
        one, else the CPU
    :param default: fallback bytes when the probe finds nothing on the
        card
    :param honor_env_on_cpu: True (the planner's semantics) applies an
        explicit ``SWIFTLY_HBM_BUDGET`` even on the CPU, which is how
        tests exercise partitioned plans there; False (the streamed
        executors') stays unlimited on the CPU whatever the variable says
    :param held: ("probe" only) device bytes the caller holds and prices
        itself, counted back into the probed free bytes
        (`_probe_device_bytes`); an explicit budget already is the whole
        device's
    """
    env = os.environ.get("SWIFTLY_HBM_BUDGET")
    if env and honor_env_on_cpu:
        return float(env) - headroom
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if env:
        return float(env) - headroom
    try:
        limit = _probe_device_bytes(device, held)
    except RuntimeError:  # no usable driver: the caller's default
        limit = None
    if limit is None:
        limit = default
    if limit is None:
        return None
    return limit - headroom
