"""The port's sub-package surfaces against the JAX package's.

For each sub-package of ``swiftly_tpu`` (``obs``, ``resilience``,
``parallel``, ``utils``, ``plan``, ``serve``, ``vis``, ``models``,
``ops``, ``delta``, ``cache``, ``native``, ``mesh``), every name in its
``__all__`` is exported by the port's
counterpart in ``swiftly_tpu_torch``, or is listed below as not
applicable, with its reason. The JAX package's ``__all__`` is read by
parsing its source with ``ast``: nothing of it is imported.
"""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

# names of the JAX package's sub-packages the port does not export, and why
NOT_APPLICABLE = {
    "utils": {
        "enable_compilation_cache": (
            "JAX's persistent XLA compilation cache: the port compiles no "
            "XLA programs, and its nvcc builds are cached always, keyed by "
            "the digest of source, headers and flags, under "
            "swiftly_tpu_torch/_build/ (ops/_build.py)"),
    },
}
SUBPACKAGES = ["obs", "resilience", "parallel", "utils", "plan", "serve",
               "vis", "models", "ops", "delta", "cache", "native", "mesh"]


def _reference_all(sub):
    """The ``__all__`` list of ``swiftly_tpu/<sub>/__init__.py``, parsed."""
    tree = ast.parse((ROOT / "swiftly_tpu" / sub / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"swiftly_tpu/{sub} has no __all__")


def _not_applicable(sub):
    return NOT_APPLICABLE.get(sub, {})


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_reference_surface_is_exported_or_pending(sub):
    port = importlib.import_module(f"swiftly_tpu_torch.{sub}")
    exported = set(port.__all__)
    skipped = _not_applicable(sub)
    missing = [name for name in _reference_all(sub)
               if name not in exported and name not in skipped]
    assert not missing, f"swiftly_tpu_torch.{sub} lacks {missing}"
    for name in exported:
        assert hasattr(port, name), f"{sub}.{name} is in __all__ only"


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_pending_names_are_still_missing(sub):
    """A name listed as not applicable is one the JAX package exports and
    the port does not, with its reason; nothing is pending any more."""
    port = importlib.import_module(f"swiftly_tpu_torch.{sub}")
    skipped = _not_applicable(sub)
    assert set(skipped) <= set(_reference_all(sub))
    assert not set(skipped) & set(port.__all__)
    assert all(reason for reason in skipped.values())


def test_this_slice_is_exported():
    """The names this slice ported, where the JAX package exports them."""
    from swiftly_tpu_torch import obs, parallel, plan, resilience, serve, utils

    assert {"metrics", "recorder", "trace"} <= set(obs.__all__)
    assert set(_reference_all("resilience")) == set(resilience.__all__)
    assert "CachedColumnFeed" in parallel.__all__
    for name in ("SpillCache", "spill_budget_bytes", "peak_tflops",
                 "forward_sampled_flops", "backward_sampled_flops",
                 "save_streamed_backward_state",
                 "restore_streamed_backward_state", "verify_checkpoint"):
        assert name in utils.__all__, name
    # the run manifest, report, tower, ledger and heartbeat (A9), and the
    # plan compiler, cost model, autotune and profiling (A10): the whole
    # of the JAX package's obs and plan surfaces
    assert set(_reference_all("obs")) == set(obs.__all__)
    assert set(_reference_all("plan")) <= set(plan.__all__)
    for name in ("projected_column_bytes", "projected_request_bytes"):
        assert name in serve.__all__, name
    for name in ("MemorySampler", "collective_bytes_backward",
                 "collective_bytes_forward", "column_collective_bytes",
                 "device_memory_stats", "trace"):
        assert name in utils.__all__, name
    # the process fleet (A12) and the native host backend (A14): the
    # whole of the JAX package's serve and native surfaces
    from swiftly_tpu_torch import native
    from swiftly_tpu_torch.utils import SpillCache

    assert set(_reference_all("serve")) <= set(serve.__all__)
    for name in ("ProcessFleet", "SharedSpillReader", "make_worker_spec"):
        assert name in serve.__all__ and hasattr(serve, name), name
    assert set(_reference_all("native")) == set(native.__all__)
    assert callable(SpillCache.export_manifest)


def test_incremental_and_serving_slice_is_exported():
    """The incremental-update and serving names, from the package's top
    level, and the spill cache's and forward's new methods."""
    import swiftly_tpu_torch as st

    for name in ("IncrementalForward", "facet_delta", "FacetDeltaLedger",
                 "config_hash", "facet_hash", "SharedStreamTier",
                 "FabricFeedView", "SubgridService", "HealthLease",
                 "HealthMonitor", "ServeFleet", "Replica", "FleetRequest",
                 "FleetAutoscaler", "FleetRowSource"):
        assert name in st.__all__ and hasattr(st, name), name
    from swiftly_tpu_torch.utils import SpillCache, StreamMidPatch

    for name in ("patch_entry", "begin_patch", "end_patch"):
        assert callable(getattr(SpillCache, name)), name
    assert issubclass(StreamMidPatch, LookupError)
    assert callable(st.SwiftlyForward.adopt_facet_tasks)


def test_process_spanning_mesh_is_exported():
    """The process-spanning mesh's entry points, where the JAX package
    has them: `initialize_multihost` from ``parallel`` and ``mesh``,
    `bootstrap_from_env` from ``parallel.mesh``."""
    from swiftly_tpu_torch import mesh, parallel
    from swiftly_tpu_torch.parallel import mesh as pmesh

    for sub in (parallel, mesh):
        assert "initialize_multihost" in sub.__all__
        assert sub.initialize_multihost is pmesh.initialize_multihost
    assert callable(pmesh.bootstrap_from_env)
    assert "bootstrap_from_env" in pmesh.__all__
