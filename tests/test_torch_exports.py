"""The port's sub-package surfaces against the JAX package's.

For each sub-package of ``swiftly_tpu`` (``obs``, ``resilience``,
``parallel``, ``utils``, ``plan``, ``serve``, ``vis``, ``models``,
``ops``), every name in its ``__all__`` is exported by the port's
counterpart in ``swiftly_tpu_torch``, or is listed below beside the
ROADMAP step (section A) that will bring it. The JAX package's
``__all__`` is read by parsing its source with ``ast``: nothing of it is
imported.
"""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

# names of the JAX package's sub-packages not ported yet, by ROADMAP step
PENDING = {
    "A8": {  # multi-device: meshes, sharded execution
        "parallel": {
            "FACET_AXIS", "backward_all_sharded", "facet_sharding",
            "forward_all_sharded", "initialize_multihost", "make_facet_mesh",
            "mesh", "mesh_size", "pad_to_shards", "place_facet_sharded",
            "replicated_sharding", "sharded", "split_accumulate_sharded",
            "split_subgrid_sharded", "subgrid_from_columns_sharded",
            "subgrids_from_columns_sharded",
        },
    },
    "A9 rest": {  # manifest, report, tower, ledger, heartbeat
        "obs": {
            "ControlTower", "Heartbeat", "PartialArtifactWriter", "SLO",
            "by_process", "ledger", "merge_traces", "report", "run_manifest",
            "summarize_trace", "tower", "validate_alerts_artifact",
            "validate_artifact", "validate_delta_artifact",
            "validate_fleet_artifact", "validate_fleet_telemetry_artifact",
            "validate_mesh_artifact", "validate_plan_accuracy_artifact",
            "validate_plan_artifact", "validate_procfleet_artifact",
            "validate_resilience_artifact", "validate_serve_artifact",
            "validate_trace_artifact", "validate_vis_artifact",
        },
    },
    "A10": {  # the plan compiler, cost model, autotune, profiling
        "plan": {
            "BackwardPlan", "CacheTierPlan", "CostCoefficients", "DeltaPlan",
            "MeshLayout", "Plan", "PlanInputs", "ServePlan", "SpillPolicy",
            "VisPlan", "autotune", "bucket_shape", "bucket_sizes",
            "compile_plan", "ledger_readiness", "load_history", "plan_delta",
            "plan_mesh_layout", "price_cache_tier",
            "price_collective_candidates", "price_colpass_candidates",
            "price_vis", "projected_column_bytes", "projected_request_bytes",
            "refit_from_ledger", "stamp_measured_wall",
        },
        "serve": {"projected_column_bytes", "projected_request_bytes"},
        "utils": {
            "MemorySampler", "collective_bytes_backward",
            "collective_bytes_forward", "column_collective_bytes",
            "device_memory_stats", "trace",
        },
    },
    "A12": {  # serving, the rest: fleet, health, autoscale, process fleet
        "serve": {
            "FleetAutoscaler", "FleetRequest", "HealthLease", "HealthMonitor",
            "LIVE", "ProcessFleet", "REVOKED", "Replica", "SUSPECT",
            "ServeFleet", "SharedSpillReader", "SubgridService",
            "make_worker_spec",
        },
    },
    "A13": {"vis": {"FleetRowSource"}},  # visibility, the rest
    "A15": {"utils": {"enable_compilation_cache"}},  # scripts, leftovers
}
SUBPACKAGES = ["obs", "resilience", "parallel", "utils", "plan", "serve",
               "vis", "models", "ops"]


def _reference_all(sub):
    """The ``__all__`` list of ``swiftly_tpu/<sub>/__init__.py``, parsed."""
    tree = ast.parse((ROOT / "swiftly_tpu" / sub / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"swiftly_tpu/{sub} has no __all__")


def _pending(sub):
    return {name: step for step, subs in PENDING.items()
            for name in subs.get(sub, ())}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_reference_surface_is_exported_or_pending(sub):
    port = importlib.import_module(f"swiftly_tpu_torch.{sub}")
    exported = set(port.__all__)
    pending = _pending(sub)
    missing = [name for name in _reference_all(sub)
               if name not in exported and name not in pending]
    assert not missing, f"swiftly_tpu_torch.{sub} lacks {missing}"
    for name in exported:
        assert hasattr(port, name), f"{sub}.{name} is in __all__ only"


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_pending_names_are_still_missing(sub):
    """A name listed as pending that the port now exports comes off the
    list, and the list names only what the JAX package exports."""
    port = importlib.import_module(f"swiftly_tpu_torch.{sub}")
    pending = _pending(sub)
    assert set(pending) <= set(_reference_all(sub))
    assert not set(pending) & set(port.__all__)


def test_this_slice_is_exported():
    """The names this slice ported, where the JAX package exports them."""
    from swiftly_tpu_torch import obs, parallel, resilience, utils

    assert {"metrics", "recorder", "trace"} <= set(obs.__all__)
    assert set(_reference_all("resilience")) == set(resilience.__all__)
    assert "CachedColumnFeed" in parallel.__all__
    for name in ("SpillCache", "spill_budget_bytes", "peak_tflops",
                 "forward_sampled_flops", "backward_sampled_flops",
                 "save_streamed_backward_state",
                 "restore_streamed_backward_state", "verify_checkpoint"):
        assert name in utils.__all__, name
