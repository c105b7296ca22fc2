"""The port stands alone: no JAX and nothing of the JAX package, and no
silent fall back to the CPU when the GPU is missing."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "swiftly_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_are_found():
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda path: str(path.relative_to(ROOT)))
def test_port_sources_import_no_jax_and_no_reference_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "swiftly_tpu", "scripts",
                           "bench"), (path, mod)


def test_port_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['swiftly_tpu'] = None; "
        "import swiftly_tpu_torch, swiftly_tpu_torch.api, "
        "swiftly_tpu_torch.utils.flops, swiftly_tpu_torch.utils.spill, "
        "swiftly_tpu_torch.serve, swiftly_tpu_torch.vis, "
        "swiftly_tpu_torch.plan, swiftly_tpu_torch.plan.model, "
        "swiftly_tpu_torch.plan.compiler, swiftly_tpu_torch.obs, "
        "swiftly_tpu_torch.resilience, swiftly_tpu_torch.utils.checkpoint, "
        "swiftly_tpu_torch.serve.procfleet, swiftly_tpu_torch.serve.ipc, "
        "swiftly_tpu_torch.native, swiftly_tpu_torch.mesh, "
        "swiftly_tpu_torch.mesh.engine, swiftly_tpu_torch.mesh.recovery, "
        "swiftly_tpu_torch.parallel.mesh, swiftly_tpu_torch.parallel.sharded, "
        "swiftly_tpu_torch.tools, swiftly_tpu_torch.tools.calibration_report, "
        "swiftly_tpu_torch.tools.tower_report, "
        "swiftly_tpu_torch.tools.trace_report, "
        "swiftly_tpu_torch.tools.demo_api, "
        "swiftly_tpu_torch.tools.demo_sparse_facet, "
        "swiftly_tpu_torch.tools.demo_serve, "
        "swiftly_tpu_torch.tools.plan_explain, "
        "swiftly_tpu_torch.tools.accuracy_vs_n, "
        "swiftly_tpu_torch.tools.derivation_demo, "
        "swiftly_tpu_torch.tools.estimate_large_config, "
        "swiftly_tpu_torch.tools.roofline, swiftly_tpu_torch.knobs; "
        "assert not any(m == 'jax' or m.startswith(('jax.', 'swiftly_tpu.')) "
        "for m in sys.modules if sys.modules[m] is not None)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_default_device_is_the_gpu_and_raises_without_one(monkeypatch):
    import swiftly_tpu_torch as st

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = st.SWIFT_CONFIGS["1k[1]-n512-256"]
    for backend in ("torch", "planar"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            st.SwiftlyConfig(backend=backend, **params)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            st.SwiftlyCore(params["W"], params["N"], params["xM_size"],
                           params["yN_size"], backend=backend, device="cuda")
    # asking for the host explicitly works
    cfg = st.SwiftlyConfig(backend="planar", device="cpu", **params)
    assert cfg.core.device.type == "cpu"
