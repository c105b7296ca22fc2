"""The port's operator tools (`swiftly_tpu_torch.tools`): the twins of the
JAX package's ``scripts/`` demos, on the CPU at ``1k[1]-n512-256``.

* ``demo_api.run_streamed_with_checkpoint``: the twin of
  ``tests/test_demo_checkpoint.py:57`` (killed after two columns with a
  snapshot every column, resumed without refolding them): the resumed
  run's facets are bit-equal to the uninterrupted port run and within
  1e-10 of the JAX package's loop (``scripts/demo_api.py``) at f64;
* ``plan_explain --devices 8``: the report lines that
  ``tests/test_mesh_engine.py:405-425`` asserts of the JAX package's;
* every tool's ``main([...]) == 0`` with ``--device cpu``, its module
  runnable as ``python -m swiftly_tpu_torch.tools.<name>``, and where the
  JAX package's script returns a number, the port's within a stated
  bound of it (the demo's max facet RMS within 1e-6 relative at f64; the
  derivation demo's error map within 1e-12 absolute; the f32 accuracy
  table's relative RMS within 2x).

Torch runs on one intra-op thread.
"""

import contextlib
import io
import json
import runpy
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import swiftly_tpu_torch as T
from swiftly_tpu_torch.tools import (
    accuracy_vs_n,
    demo_api,
    demo_serve,
    demo_sparse_facet,
    derivation_demo,
    estimate_large_config,
    plan_explain,
    roofline,
)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SMALL = "1k[1]-n512-256"
TOOLS = ["demo_api", "demo_sparse_facet", "demo_serve", "plan_explain",
         "accuracy_vs_n", "derivation_demo", "estimate_large_config",
         "roofline"]
PARAMS = {"W": 13.5625, "fov": 1.0, "N": 1024, "yB_size": 416,
          "yN_size": 512, "xA_size": 228, "xM_size": 256}
SOURCES = [(1, 1, 0), (0.5, -30, 40)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


# -- run_streamed_with_checkpoint ---------------------------------------------


class _Killed(RuntimeError):
    pass


def _executors(config, fcs, tasks):
    return (T.StreamedForward(config, tasks, residency="device"),
            T.StreamedBackward(config, fcs, residency="sampled"))


def test_kill_and_resume_matches_uninterrupted(tmp_path):
    """tests/test_demo_checkpoint.py:57 on the port: the resumed run skips
    the two snapshotted columns and finishes with the uninterrupted run's
    bits; the JAX package's own loop within 1e-10."""
    import swiftly_tpu as J
    from scripts.demo_api import run_streamed_with_checkpoint as jloop
    from swiftly_tpu.parallel import StreamedBackward, StreamedForward

    jconfig = J.SwiftlyConfig(backend="jax", **PARAMS)
    jfcs = J.make_full_facet_cover(jconfig)
    jsgcs = J.make_full_subgrid_cover(jconfig)
    jtasks = [(fc, J.make_facet(jconfig.image_size, fc, SOURCES))
              for fc in jfcs]
    want = jloop(StreamedForward(jconfig, jtasks, col_block=416),
                 StreamedBackward(jconfig, jfcs, residency="sampled"), jsgcs)

    config = T.SwiftlyConfig.from_numpy_state(
        np.asarray(jconfig.core._Fb), np.asarray(jconfig.core._Fn),
        backend="planar", dtype=torch.float64, device="cpu", **PARAMS)
    fcs = T.make_full_facet_cover(config)
    sgcs = T.make_full_subgrid_cover(config)
    tasks = [(fc, d) for fc, (_, d) in zip(fcs, jtasks)]
    ref = demo_api.run_streamed_with_checkpoint(
        *_executors(config, fcs, tasks), sgcs)

    ck = tmp_path / "bwd.npz"
    count = {"n": 0}

    def killer(items):
        count["n"] += 1
        if count["n"] == 3:
            raise _Killed()

    with pytest.raises(_Killed):
        demo_api.run_streamed_with_checkpoint(
            *_executors(config, fcs, tasks), sgcs, ck_path=ck, every=1,
            on_column=killer)
    assert ck.exists()
    folded = {"cols": 0}
    out = demo_api.run_streamed_with_checkpoint(
        *_executors(config, fcs, tasks), sgcs, ck_path=ck, every=1,
        on_column=lambda items: folded.__setitem__("cols",
                                                   folded["cols"] + 1))
    n_cols = len({sg.off0 for sg in sgcs})
    assert folded["cols"] == n_cols - 2
    assert np.array_equal(np.asarray(out), np.asarray(ref))
    np.testing.assert_allclose(config.core.as_complex(out),
                               jconfig.core.as_complex(np.asarray(want)),
                               rtol=0, atol=1e-10)


# -- plan_explain --------------------------------------------------------------


def test_plan_explain_degraded_layouts_and_collectives():
    """tests/test_mesh_engine.py:405-425 on the port's tool."""
    rc, report = _run(plan_explain.main, ["--config", "64k", "--devices",
                                          "8"])
    assert rc == 0
    assert "degraded layouts" in report
    assert "(one shard lost)" in report
    assert "(half the mesh lost)" in report
    assert "collective alternatives" in report
    assert "mesh.ring_step" in report
    assert "<- planned" in report


@pytest.mark.parametrize("argv,want", [
    (["--config", "128k[1]-n32k-512"], "predicted wall"),
    (["--config", "64k", "--colpass"], "B1 tile (csrc/cgemm.cuh"),
    (["--config", "32k", "--vis", "100000"], "max_batch"),
    (["--config", "32k", "--delta", "2"], "break-even"),
    (["--config", "32k", "--cache", "--json"], "l1"),
])
def test_plan_explain_modes(argv, want):
    rc, report = _run(plan_explain.main, argv)
    assert rc == 0 and want in report


def test_plan_explain_bad_config_exits_2(capsys):
    assert plan_explain.main(["--config", "nope"]) == 2
    assert "matches nothing" in capsys.readouterr().err


# -- each tool's main on the CPU -------------------------------------------------


def test_demo_api_main_streamed_with_checkpoint_and_artifacts(tmp_path):
    argv = ["--device", "cpu", "--swift_config", SMALL, "--backend",
            "planar", "--execution", "streamed-device", "--checkpoint",
            str(tmp_path / "ck"), "--checkpoint_every", "2",
            "--artifact_dir", str(tmp_path / "art"), "--metrics"]
    assert demo_api.main(argv) == 0
    assert list((tmp_path / "ck").glob("bwd_*.npz"))
    summary = json.loads(next((tmp_path / "art").glob(
        "summary_*.json")).read_text())
    assert summary["device"] == "cpu" and summary["max_facet_rms"] < 1e-6
    assert "telemetry" in summary


@pytest.mark.parametrize("execution", ["batched", "fused", "streamed"])
def test_demo_api_matches_the_reference_demo(execution):
    """The port's demo and the JAX package's at f64 over the same random
    sources: max facet RMS within 1e-6 relative of each other."""
    from scripts import demo_api as jdemo
    from scripts.utils import cli_parser as jparser
    from swiftly_tpu_torch.tools._cli import catalogue_params, cli_parser

    argv = ["--swift_config", SMALL, "--execution", execution]
    args = cli_parser("t").parse_args(argv + ["--device", "cpu"])
    got = demo_api.demo_api(args, catalogue_params(SMALL), SMALL)
    jargs = jparser("t").parse_args(argv)
    import swiftly_tpu as J

    want = jdemo.demo_api(jargs, dict(J.SWIFT_CONFIGS[SMALL], fov=1.0),
                          SMALL)
    assert got < 1e-6  # ten sources of amplitude 1..99 at f64
    assert abs(got - want) <= 1e-6 * want


def test_demo_sparse_facet_main():
    assert demo_sparse_facet.main(
        ["--device", "cpu", "--backend", "planar", "--execution",
         "streamed-device", "--check_subgrid"]) == 0
    from swiftly_tpu_torch.tools._cli import catalogue_params, cli_parser

    args = cli_parser("t").parse_args(["--device", "cpu"])
    args.fov_fraction, args.fov_x0, args.fov_y0 = 0.9, 100, 0
    args.check_subgrid = False
    assert demo_sparse_facet.demo_sparse(args, catalogue_params(SMALL)) \
        < 1e-6


@pytest.mark.parametrize("threaded", [False, True])
def test_demo_serve_main(threaded):
    argv = ["--device", "cpu", "--backend", "planar", "--precision", "f32",
            "--requests", "60", "--metrics"] + (["--threaded"] if threaded
                                                else [])
    rc, out = _run(demo_serve.main, argv)
    assert rc == 0
    stats = json.loads(out[:out.index("\n}\n") + 2])
    assert stats["n_served"] == 60 and "throughput_rps" in stats
    assert '"serve_counters"' in out


def test_accuracy_vs_n_main_and_the_reference(tmp_path, monkeypatch):
    """The f32 table row at 1k; its relative RMS within 2x of the JAX
    package's, and the JSON rows stamped with the precision read."""
    monkeypatch.setenv("SWIFTLY_PRECISION", "high")
    path = tmp_path / "acc.json"
    rc, out = _run(accuracy_vs_n.main, ["--device", "cpu", "--configs",
                                        SMALL, "--mode", "streamed",
                                        "--json", str(path)])
    assert rc == 0 and out.splitlines()[0].split()[:2] == ["config", "N"]
    (row,) = json.loads(path.read_text())
    assert row["precision"] == "high" and row["mode"] == "streamed"
    from scripts.accuracy_vs_n import measure

    want = measure(SMALL, "streamed")
    assert row["rms_rel"] < 2 * want["rms_rel"] + 1e-7
    assert row["rms_rel"] < 3e-2  # the `high` budget


def test_derivation_demo_main_matches_the_reference(tmp_path):
    csv = tmp_path / "em.csv"
    rc, out = _run(derivation_demo.main, ["--device", "cpu", "--csv",
                                          str(csv)])
    assert rc == 0 and "RMS vs direct DFT oracle" in out
    ref = tmp_path / "ref.csv"
    from scripts import derivation_demo as jdd

    argv = sys.argv
    sys.argv = ["derivation_demo.py", "--csv", str(ref)]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            jdd.main()
    finally:
        sys.argv = argv
    got = np.loadtxt(csv, delimiter=",", skiprows=1)
    want = np.loadtxt(ref, delimiter=",", skiprows=1)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=1e-12)
    with pytest.raises(SystemExit):  # --N must be a multiple of 1024
        derivation_demo.main(["--device", "cpu", "--N", "1000"])


@pytest.mark.parametrize("argv,want", [
    (["--config", SMALL, "--col_block", "128"], "TOTAL:"),
    (["--config", "128k[1]-n32k-512", "--plan_only"], "facet-stack sweeps"),
])
def test_estimate_large_config_main(argv, want):
    rc, out = _run(estimate_large_config.main, ["--device", "cpu"] + argv)
    assert rc == 0 and want in out


def test_estimate_large_config_measure_returns_the_total():
    args = estimate_large_config.parser().parse_args(
        ["--device", "cpu", "--config", SMALL, "--col_block", "416"])
    with contextlib.redirect_stdout(io.StringIO()):
        total = estimate_large_config.measure(args)
    assert total > 0


def test_roofline_main_prints_a_line_per_stage():
    rc, out = _run(roofline.main, ["--device", "cpu", "--config", SMALL,
                                   "--G", "2", "--reps", "1", "--bwd"])
    assert rc == 0
    recs = [json.loads(line) for line in out.splitlines()]
    stages = [r["stage"] for r in recs]
    assert stages == ["dispatch", "synth", "sampled", "column",
                      "column-einsum", "model", "bwd-column", "bwd-fold",
                      "bwd-model"]
    # no share of the card's bounds from a CPU run
    assert all("roofline_share" not in r for r in recs)
    assert recs[2]["precision"] == "highest"


@pytest.mark.parametrize("name", TOOLS)
def test_tool_runs_as_a_module(name, monkeypatch):
    """``python -m swiftly_tpu_torch.tools.<name> --help`` exits 0."""
    monkeypatch.setattr(sys, "argv", [name, "--help"])
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        with pytest.raises(SystemExit) as exit_:
            runpy.run_module(f"swiftly_tpu_torch.tools.{name}",
                             run_name="__main__")
    assert exit_.value.code == 0
    assert "--device" in buf.getvalue() or name == "plan_explain"


def test_a_cuda_device_without_the_card_is_refused(monkeypatch):
    """No fall back to the CPU: ``--device cuda`` with no card exits."""
    from swiftly_tpu_torch.tools._cli import setup_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        setup_torch(SimpleNamespace(device="cuda"))
    with pytest.raises(SystemExit):
        derivation_demo.main([])
