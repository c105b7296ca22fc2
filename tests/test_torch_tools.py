"""The port's report tools (`swiftly_tpu_torch.tools`) and the JAX
package's ``scripts/bench_compare.py`` over the port's own records.

The counterparts of the cases of ``tests/test_plan_ledger.py``,
``tests/test_tower.py``, ``tests/test_obs.py`` and
``tests/test_trace.py`` that drive ``scripts/``:

* ``calibration_report``, ``tower_report`` and ``trace_report`` are the
  port's twins of the scripts of those names, driven here through their
  ``main`` and once each as ``python -m swiftly_tpu_torch.tools.<name>``,
  on blocks the port's own `obs` and `plan` wrote;
* ``scripts/bench_compare.py`` imports neither package and reads the
  port's records unchanged (a leg stamped with the port's
  `obs.run_manifest`, a plan block from the port's `compile_plan`, a
  ``plan_accuracy`` block from the port's ledger), so it has no twin:
  its cases drive it on those records;
* the telemetry-vocabulary guard scans the port's sources: every metric,
  trace-instant and recorder name is documented in
  ``docs/observability.md`` or, for the names only the port emits, in
  the port's README section.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from swiftly_tpu_torch.obs import (  # noqa: E402
    ControlTower,
    metrics,
    recorder,
    report,
    run_manifest,
    trace,
)
from swiftly_tpu_torch.obs import ledger as oledger  # noqa: E402
from swiftly_tpu_torch.obs.recorder import FlightRecorder  # noqa: E402
from swiftly_tpu_torch.plan import PlanInputs, compile_plan  # noqa: E402


@pytest.fixture
def history_off(monkeypatch):
    """Tests must never append to the repo-level calibration file."""
    monkeypatch.setenv("SWIFTLY_CALIBRATION_HISTORY", "0")


@pytest.fixture(autouse=True)
def _obs_off():
    """Tracer, registry and global recorder off and wiped around each
    case."""
    def wipe():
        trace.get_tracer().disable()
        trace.get_tracer().reset()
        metrics.get_registry().disable()
        metrics.get_registry().reset()
        recorder.disable()
        recorder.reset()
    wipe()
    yield
    wipe()


def _accuracy_block(ratio=1.0, coeffs_source="measured", platform="cpu",
                    flops=2.0e9, wall=0.5):
    """A calibrated ``plan_accuracy`` block from the port's ledger whose
    single stage has the given predicted/measured ratio."""
    plan = {
        "config": "synthetic",
        "mode": "roundtrip-streamed",
        "inputs_hash": "cafe1234",
        "coeffs_source": coeffs_source,
        "predicted": {
            "wall_s": wall * ratio,
            "stages": {"bwd.column_pass": {"wall_s": wall * ratio,
                                           "flops": flops}},
        },
    }
    telem = {"enabled": True,
             "stages": {"bwd.column_pass": {"count": 1, "total_s": wall}}}
    return oledger.plan_accuracy_block(
        plan, telem,
        manifest={"device": {"platform": platform}, "git_sha": "abc123"},
    )


def _run_module(name, *args):
    """``python -m swiftly_tpu_torch.tools.<name> args``: (rc, stdout)."""
    proc = subprocess.run(
        [sys.executable, "-m", f"swiftly_tpu_torch.tools.{name}", *args],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
             "SWIFTLY_CALIBRATION_HISTORY": "0"})
    return proc.returncode, proc.stdout


# ---------------------------------------------------------------------------
# bench_compare's plan sentinel and calibration_report
# ---------------------------------------------------------------------------


def test_stage_accuracy_sentinel_is_listed():
    """The sentinel table names the stage-accuracy row, and the port's
    ``plan_accuracy`` block carries what that row reads."""
    from scripts.bench_compare import SENTINELS

    row = next(s for s in SENTINELS if s["name"] == "plan.stage_accuracy")
    assert row["source_pr"] == 16
    assert "predicted/measured" in row["threshold"]
    block = _accuracy_block(ratio=1.5)
    assert block["stages"]["bwd.column_pass"]["ratio"] == pytest.approx(1.5)
    assert block["coverage"] == 1.0


def test_plan_verdicts_stage_level_mispricing(history_off):
    from scripts.bench_compare import plan_verdicts

    accuracy = _accuracy_block(ratio=5.0, coeffs_source="ledger")
    record = {
        "config": "synthetic",
        "plan_compiled": {
            "mode": "roundtrip-streamed",
            "coeffs_source": "ledger",
            "predicted": {"wall_s": 1.0},
            "measured_wall_s": 1.0,   # whole-leg ratio is clean...
        },
        "plan_accuracy": accuracy,
    }
    (v,) = plan_verdicts([record], plan_threshold=2.0)
    # ...but the stage-level join still catches the mispricing
    assert v["mispriced"] is True
    assert v["mispriced_stages"] == [
        {"stage": "bwd.column_pass",
         "ratio": accuracy["stages"]["bwd.column_pass"]["ratio"]}
    ]
    assert v["stage_coverage"] == 1.0
    assert "over-predicted" in v["ratio_direction"]
    # same stages, default pedigree: reported, never mispriced
    record["plan_compiled"]["coeffs_source"] = "default"
    record["plan_accuracy"] = _accuracy_block(ratio=5.0,
                                              coeffs_source="default")
    (v,) = plan_verdicts([record], plan_threshold=2.0)
    assert v["mispriced"] is False
    assert v["mispriced_stages"]  # still named


def test_calibration_report_end_to_end(tmp_path, monkeypatch, capsys):
    from swiftly_tpu_torch.tools.calibration_report import main

    monkeypatch.setenv("SWIFTLY_CALIBRATION_HISTORY", "0")
    path = tmp_path / "cal.jsonl"
    for ratio in (1.0, 1.05):
        oledger.append_history(_accuracy_block(ratio=ratio), path=str(path))
    rc = main([str(path), "--json", "--refit"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert out["n_entries"] == 2
    assert out["problems"] == []
    assert out["readiness"]["ready"]
    assert out["refit"]["source"] == "ledger"
    assert "bwd.column_pass" in out["refit"]["flops_per_s"]
    # a calibrated mispriced latest is a problem -> exit 1
    oledger.append_history(
        _accuracy_block(ratio=5.0, coeffs_source="ledger"), path=str(path))
    rc = main([str(path)])
    captured = capsys.readouterr()
    assert rc == 1
    assert "MISPRICED" in captured.out
    assert "over-predicted" in captured.out
    # no history at all -> bad input
    assert main([str(tmp_path / "missing.jsonl")]) == 2
    # the module runs as a program, with the same exit code
    rc, stdout = _run_module("calibration_report", str(path))
    assert rc == 1 and "MISPRICED" in stdout


def test_calibration_report_reads_artifact_record(tmp_path, monkeypatch,
                                                  capsys):
    from swiftly_tpu_torch.tools.calibration_report import main

    monkeypatch.setenv("SWIFTLY_CALIBRATION_HISTORY", "0")
    artifact = tmp_path / "BENCH_smoke.json"
    artifact.write_text(json.dumps(
        {"parsed": {"plan_accuracy": _accuracy_block(ratio=1.2)}}))
    rc = main([str(tmp_path / "none.jsonl"), "--artifact", str(artifact),
               "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert out["latest"]["calibrated"]
    assert out["latest"]["coverage"] == 1.0


# ---------------------------------------------------------------------------
# trace_report and tower_report
# ---------------------------------------------------------------------------


def _proc_trace(pid, epoch, spans):
    """A hand-built one-process Chrome trace (merge_traces input):
    ``spans`` maps span_id -> (name, ts_us, dur_us, extra_args)."""
    events = [
        {"name": name, "ph": "X", "ts": ts, "dur": dur, "pid": pid,
         "tid": 1, "args": {"span_id": sid, "parent_id": 0, **extra}}
        for sid, (name, ts, dur, extra) in spans.items()
    ]
    return {"traceEvents": events, "otherData": {"t_epoch": epoch}}


def _merged_fleet_timeline():
    """A router and a worker timeline merged by the port's report."""
    router = _proc_trace(1000, 100.0, {5: ("proc.request", 0.0, 1000.0,
                                           {})})
    worker = _proc_trace(2000, 100.7, {
        3: ("proc.worker_request", 100.0, 500.0,
            {"xparent": 5, "xpid": 1000}),
    })
    return report.merge_traces(
        [router, worker],
        offsets={2000: {"offset_s": 0.5, "rtt_s": 0.004}},
        labels={1000: "router", 2000: "worker-0.g1"},
    )


def test_trace_report_by_process_flag(tmp_path, capsys):
    from swiftly_tpu_torch.tools.trace_report import main

    path = tmp_path / "BENCH_merged_trace.json"
    path.write_text(json.dumps(_merged_fleet_timeline()))
    assert main([str(path), "--by-process", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert {r["label"] for r in out["by_process"]} == {
        "router", "worker-0.g1"}
    assert out["clock_offsets"]["2000"]["offset_s"] == 0.5
    # text mode echoes the rows and the alignment uncertainty
    assert main([str(path), "--by-process"]) == 0
    text = capsys.readouterr().out
    assert "worker-0.g1 (pid 2000)" in text
    assert "clock offsets" in text and "rtt/2" in text
    # a trace the port's own tracer recorded, read as a program
    tracer = trace.get_tracer()
    own = tmp_path / "own_trace.json"
    tracer.enable(str(own))
    with trace.span("leg.roundtrip", cat="leg"):
        with trace.span("fwd.column_group", cat="fwd"):
            pass
    tracer.save(str(own))
    rc, stdout = _run_module("trace_report", str(own), "--json")
    assert rc == 0
    summary = json.loads(stdout)
    assert summary["span_count"] == 2 and summary["root"] == "leg.roundtrip"


def _drill_record():
    """The observability blocks of a drill, from the port's tower and
    flight recorder."""
    tower = ControlTower()
    block = {"counters": {"serve.served": 5},
             "stages": {"serve.batch": {"count": 2, "total_s": 0.1}}}
    tower.register_source("replica-0", lambda: block)
    rec = FlightRecorder(enabled=True)
    rec.record("fault", "fault.injected.fleet.replica.kill")
    rec.record("fleet", "fleet.replica_death", "rid=0")
    return {
        "metric": "fleet drill",
        "fleet_telemetry": tower.fleet_telemetry(),
        "alerts": tower.alerts_block(),
        "post_mortem": rec.post_mortem("WorkerKilled", reason="test"),
    }


def test_tower_report_renders_and_validates(tmp_path, capsys):
    from swiftly_tpu_torch.tools.tower_report import main

    path = tmp_path / "BENCH_fleet.json"
    path.write_text(json.dumps(_drill_record()))
    assert main([str(path), "--json"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["problems"] == []
    assert summary["fleet_telemetry"]["n_sources"] == 1
    assert summary["post_mortem"]["trigger"] == "WorkerKilled"
    # text mode renders all three blocks
    assert main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "fleet telemetry" in out and "alerts:" in out
    assert "post-mortem: WorkerKilled" in out
    rc, stdout = _run_module("tower_report", str(path))
    assert rc == 0 and "post-mortem: WorkerKilled" in stdout


def test_tower_report_renders_the_procfleet_plane(tmp_path, capsys):
    """A process-fleet artifact's distributed-observability block: the
    summary carries it through --json verbatim and the text rendering
    shows telemetry coverage, per-worker clock offsets (± rtt/2), the
    exhumed black boxes (flagging a torn index), and the trace merge."""
    from swiftly_tpu_torch.tools.tower_report import main

    record = _drill_record()
    record["procfleet"] = {
        "n_workers": 2,
        "worker_deaths": 1,
        "telemetry": {"frames": 40, "zombie_frames": 1,
                      "retired_generations": 1, "coverage": 0.91},
        "clock_offsets": {"1": {"pid": 4242, "generation": 2,
                                "offset_s": 0.0021, "rtt_s": 0.0004}},
        "black_box": {"exhumed": [
            {"rid": 1, "generation": 2, "n_events": 7,
             "torn_index": True}]},
        "trace_merge": {"n_processes": 3, "pids": [1, 2, 3],
                        "cross_process_requests": 5},
    }
    path = tmp_path / "BENCH_procfleet.json"
    path.write_text(json.dumps(record))
    assert main([str(path), "--json"]) == 0
    summary = json.loads(capsys.readouterr().out)
    pf = summary["procfleet"]
    assert pf["telemetry"]["frames"] == 40
    assert pf["black_box"]["exhumed"][0]["torn_index"] is True
    assert main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "process fleet: 2 worker(s), 1 death(s)" in out
    assert "coverage 0.910" in out
    assert "worker-1 (pid 4242, g2)" in out
    assert "TORN INDEX" in out
    assert "trace merge: 3 process(es)" in out


def test_tower_report_trips_on_doctored_artifact(tmp_path, capsys):
    from swiftly_tpu_torch.tools.tower_report import main

    record = _drill_record()
    record["fleet_telemetry"]["totals"]["counters"]["serve.served"] = 99
    path = tmp_path / "BENCH_fleet.json"
    path.write_text(json.dumps(record))
    assert main([str(path), "--json"]) == 1
    assert main([str(tmp_path / "missing.json")]) == 2
    capsys.readouterr()


# ---------------------------------------------------------------------------
# bench_compare over the port's records
# ---------------------------------------------------------------------------


def _leg(config="1k", mode="streamed", platform="cpu", value=10.0,
         mfu=40.0):
    """A bench leg stamped with the port's run manifest; the platform
    set as a run on it would record it."""
    manifest = run_manifest(params={"config": config, "mode": mode})
    manifest["device"]["platform"] = platform
    return {
        "metric": f"{config} forward facet->subgrid wall-clock "
                  f"(8 subgrids, planar f32, {mode}, {platform})",
        "value": value,
        "unit": "s",
        "mfu_pct": mfu,
        "manifest": manifest,
    }


def test_bench_compare_lists_the_sentinel_table(capsys):
    from scripts.bench_compare import SENTINELS, main

    assert main(["--list-sentinels", "--json"]) == 0
    table = json.loads(capsys.readouterr().out)["sentinels"]
    assert table == SENTINELS and len(table) >= 10
    for row in table:
        assert {"name", "direction", "threshold", "source_pr"} <= set(row)
    names = {row["name"] for row in table}
    assert {"wall", "p99_ms", "cache.hit_ratio",
            "fleet.stream_copies"} <= names
    # without --list-sentinels a latest artifact is still required
    with pytest.raises(SystemExit):
        main([])
    capsys.readouterr()


def test_bench_compare_flags_mispriced_calibrated_plan():
    """A calibrated plan block of the port's compiler whose predicted and
    measured walls diverge more than 2x is flagged; a default-coefficient
    prediction never is."""
    from scripts.bench_compare import plan_verdicts

    plan = compile_plan(PlanInputs.from_config("1k[1]-n512-256"),
                        mode="roundtrip-streamed")
    predicted = plan.artifact_block()["predicted"]["wall_s"]

    def rec(source, measured):
        block = plan.artifact_block(measured_wall_s=measured)
        block["coeffs_source"] = source
        return {"metric": "x", "value": measured, "plan_compiled": block}

    out = plan_verdicts([
        rec("measured", predicted / 5),   # 5x over: mispriced
        rec("measured", predicted * 5),   # 5x under: mispriced
        rec("measured", predicted / 1.5),  # inside 2x: fine
        rec("default", predicted / 5),    # uncalibrated: never flagged
    ])
    assert [v["mispriced"] for v in out] == [True, True, False, False]


def test_bench_compare_verdicts():
    from scripts.bench_compare import compare

    ref = [_leg(value=10.0, mfu=40.0), _leg(value=12.0, mfu=35.0)]
    # identical numbers: no regression (self-comparison must stay green)
    rep = compare([_leg(value=10.0, mfu=40.0)], ref, threshold=0.2)
    assert rep["ok"] and not rep["regressions"]
    # within threshold: green
    rep = compare([_leg(value=11.9, mfu=33.0)], ref, threshold=0.2)
    assert not rep["regressions"]
    # wall regression past 20% vs the best reference
    rep = compare([_leg(value=12.5)], ref, threshold=0.2)
    assert len(rep["regressions"]) == 1
    assert "slower" in rep["regressions"][0]["problems"][0]
    # MFU collapse trips it too
    rep = compare([_leg(value=10.0, mfu=20.0)], ref, threshold=0.2)
    assert any("mfu" in p for v in rep["regressions"]
               for p in v["problems"])
    # cross-platform comparisons are refused: the card's legs never
    # compare with the CPU's
    rep = compare([_leg(platform="gpu", value=99.0)], ref, threshold=0.2)
    assert not rep["regressions"]
    assert rep["skipped"] and "platform" in rep["skipped"][0]["reason"]
    # unknown leg: skipped
    rep = compare([_leg(config="8k", value=99.0)], ref)
    assert not rep["regressions"] and rep["skipped"]


def test_bench_compare_parses_legacy_metric_strings():
    """A leg without a manifest falls back to its metric string; with the
    port's manifest, the manifest's config, mode and platform win."""
    from scripts.bench_compare import leg_key, leg_platform

    legacy = {
        "metric": "32k[1]-n16k-512 forward facet->subgrid wall-clock "
                  "(21609 subgrids, planar f32, streamed, gpu)",
        "value": 54.4,
    }
    assert leg_key(legacy) == ("32k[1]-n16k-512", "streamed")
    assert leg_platform(legacy) == "gpu"
    leg = _leg(config="32k[1]-n16k-512", mode="roundtrip-streamed",
               platform="gpu")
    leg["metric"] = "unparseable"
    assert leg_key(leg) == ("32k[1]-n16k-512", "roundtrip-streamed")
    assert leg_platform(leg) == "gpu"


def test_bench_compare_cli_round_trip(tmp_path):
    from scripts.bench_compare import main as compare_main

    latest = tmp_path / "BENCH_latest.json"
    ref = tmp_path / "BENCH_ref.json"
    latest.write_text(json.dumps(_leg(value=10.0)))
    ref.write_text(json.dumps({"parsed": _leg(value=10.0)}))
    assert compare_main([str(latest), "--against", str(ref), "--json"]) == 0
    # doctored faster baseline -> the sentinel must trip
    ref.write_text(json.dumps({"parsed": _leg(value=5.0)}))
    assert compare_main([str(latest), "--against", str(ref), "--json"]) == 1
    # a file is never its own baseline (self-glob stays green)
    assert compare_main([str(latest), "--against", str(latest),
                         "--json"]) == 0


# ---------------------------------------------------------------------------
# Telemetry-vocabulary drift guard
# ---------------------------------------------------------------------------

_METRIC_RE = re.compile(
    r'(?:_metrics|metrics)\.(?:count|gauge|gauge_max|stage|observe)'
    r'\(\s*(f?)"([^"]+)"'
)
_INSTANT_RE = re.compile(r'(?:_trace|trace|otrace)\.instant\(\s*(f?)"([^"]+)"')
_RECORD_RE = re.compile(
    r'(?:_recorder|recorder|orecorder)\.record\(\s*"([^"]+)",\s*(f?)"([^"]+)"'
)


def port_telemetry_names():
    """Every metric, trace-instant and recorder name the port can emit,
    f-string names reduced to their literal prefix."""
    names = set()
    for path in (REPO / "swiftly_tpu_torch").rglob("*.py"):
        src = path.read_text()
        for fprefix, name in (_METRIC_RE.findall(src)
                              + _INSTANT_RE.findall(src)):
            if fprefix:
                name = name.split("{")[0]
            if name:
                names.add(name)
        for _kind, fprefix, name in _RECORD_RE.findall(src):
            if fprefix:
                name = name.split("{")[0]
            if name:
                names.add(name)
    return names


def test_every_telemetry_name_is_documented():
    # a new metrics.count/gauge/stage, trace.instant or recorder.record
    # name of the port lands in docs/observability.md's vocabulary or in
    # the port's README section in the change that introduces it
    names = port_telemetry_names()
    assert len(names) > 100  # the extraction itself must keep working
    doc = (REPO / "docs" / "observability.md").read_text()
    readme = (REPO / "README.md").read_text()
    port = readme[readme.index("## PyTorch/CUDA port"):]
    missing = sorted(n for n in names if n not in doc and n not in port)
    assert missing == [], (
        f"{len(missing)} telemetry name(s) documented nowhere: {missing}")
