"""The port's run manifest, control tower, flight recorder, heartbeat,
trace report and autotune (`swiftly_tpu_torch.obs`, `plan.autotune`).

The port's counterparts of the module-level cases of
``tests/test_tower.py`` (the recorder, the tower's sources, totals, SLO
alerts, heartbeat fields, per-source tracks, merged cross-process
timelines), of ``tests/test_obs.py`` (the manifest, the artifact
validators, the heartbeat and partial artifacts, the autotune refit and
the plan artifact's validator) and of ``tests/test_trace.py`` (the trace
validators). The cases that drive ``scripts/`` are in
``tests/test_torch_tools.py``, and the serve-journey cases for ``SubgridService`` (A12). Beside them: the
manifest's card facts and versions, `utils.profiling`, and the stage
timers' device time.
"""

import json
import sys
import threading
import time
from pathlib import Path

import pytest

from swiftly_tpu_torch.obs import (
    SLO,
    ControlTower,
    PartialArtifactWriter,
    metrics,
    recorder,
    report,
    run_manifest,
    trace,
    validate_alerts_artifact,
    validate_artifact,
    validate_fleet_telemetry_artifact,
)
from swiftly_tpu_torch.obs.heartbeat import Heartbeat
from swiftly_tpu_torch.obs.recorder import FlightRecorder, render_post_mortem
from swiftly_tpu_torch.obs.report import (
    validate_trace_artifact,
    validate_trace_events,
)
from swiftly_tpu_torch.obs.trace import Tracer

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


@pytest.fixture
def global_registry():
    """The process-global registry, disabled and wiped afterwards."""
    reg = metrics.get_registry()
    yield reg
    reg.disable()
    reg.reset()


@pytest.fixture
def obs_sandbox():
    """Tracer, registry and global recorder all off (and wiped) around
    the test — tests may enable what they need inside."""
    def _wipe():
        trace.get_tracer().disable()
        trace.get_tracer().reset()
        metrics.get_registry().disable()
        metrics.get_registry().reset()
        recorder.disable()
        recorder.reset()
    _wipe()
    yield
    _wipe()


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------


def test_recorder_ring_is_bounded_and_ordered():
    rec = FlightRecorder(enabled=True, capacity=8, seconds=60.0)
    for i in range(20):
        rec.record("fleet", f"ev-{i}")
    evs = rec.events()
    assert len(evs) == 8  # oldest 12 evicted
    assert [e["name"] for e in evs] == [f"ev-{i}" for i in range(12, 20)]
    assert all(evs[i]["t"] <= evs[i + 1]["t"] for i in range(len(evs) - 1))


def test_recorder_disabled_records_nothing():
    rec = FlightRecorder(enabled=False)
    rec.record("fault", "fault.injected.x")
    assert rec.events() == []
    rec.enable()
    rec.record("fault", "fault.injected.x")
    assert len(rec.events()) == 1
    rec.disable()
    rec.record("fault", "fault.injected.y")
    assert len(rec.events()) == 1


def test_recorder_window_filters_old_events():
    rec = FlightRecorder(enabled=True)
    rec.record("fleet", "old")
    assert len(rec.events(seconds=1e9)) == 1
    assert rec.events(seconds=0.0) == []


def test_post_mortem_counts_kinds_and_tails_non_stage_events():
    rec = FlightRecorder(enabled=True)
    for i in range(100):
        rec.record("stage", "fwd.column_pass", 0.001)
    rec.record("fault", "fault.injected.bwd.feed", "kill call 3")
    rec.record("degrade", "degrade.checkpoint.resume")
    pm = rec.post_mortem("WorkerKilled", reason="drill")
    assert pm["trigger"] == "WorkerKilled" and pm["reason"] == "drill"
    assert pm["n_events"] == 102
    assert pm["by_kind"] == {"stage": 100, "fault": 1, "degrade": 1}
    # the tail is the readable story: decisions, not stage volume
    assert [e["kind"] for e in pm["events"]] == ["fault", "degrade"]
    txt = render_post_mortem(pm)
    assert "WorkerKilled" in txt and "fault.injected.bwd.feed" in txt


def test_recorder_dump_writes_jsonl_and_txt(tmp_path):
    rec = FlightRecorder(enabled=True)
    rec.record("fault", "fault.injected.mesh.shard_loss")
    rec.record("mesh", "mesh.recovery.resumed")
    path = tmp_path / "pm.jsonl"
    bundle = rec.dump(path, "ShardLostError", reason="drill")
    lines = [json.loads(l) for l in path.read_text().splitlines()]
    assert lines[0]["kind"] == "post_mortem"
    assert lines[0]["trigger"] == "ShardLostError"
    assert [l["name"] for l in lines[1:]] == [
        "fault.injected.mesh.shard_loss", "mesh.recovery.resumed",
    ]
    assert "ShardLostError" in (tmp_path / "pm.jsonl.txt").read_text()
    assert bundle["n_events"] == 2 and rec.dumps == 1


def test_stage_bridge_records_with_registry_and_tracer_off(obs_sandbox):
    # metrics.stage must reach the ring when ONLY the recorder is on
    recorder.enable()
    with metrics.stage("fwd.column_pass"):
        pass
    evs = recorder.events()
    assert len(evs) == 1
    assert evs[0]["kind"] == "stage"
    assert evs[0]["name"] == "fwd.column_pass"
    assert evs[0]["detail"] >= 0.0  # the measured wall rides in detail


# ---------------------------------------------------------------------------
# Control tower: source aggregation
# ---------------------------------------------------------------------------


def _source(counters=None, stages=None):
    block = {}
    if counters:
        block["counters"] = counters
    if stages:
        block["stages"] = stages
    return lambda: block


def test_fleet_telemetry_totals_sum_per_source_breakdowns():
    tower = ControlTower()
    tower.register_source(
        "replica-0",
        _source({"serve.served": 10}, {"serve.batch": {"count": 4, "total_s": 0.4}}),
    )
    tower.register_source(
        "replica-1",
        _source({"serve.served": 32}, {"serve.batch": {"count": 6, "total_s": 0.2}}),
    )
    tower.register_source(
        "fabric", _source({"cache.l2_hits": 7}), kind="cache"
    )
    ft = tower.fleet_telemetry()
    assert ft["n_sources"] == 3
    assert ft["sources"]["replica-0"]["kind"] == "replica"
    assert ft["sources"]["fabric"]["kind"] == "cache"
    assert ft["totals"]["counters"] == {
        "serve.served": 42, "cache.l2_hits": 7,
    }
    assert ft["totals"]["stages"]["serve.batch"] == {
        "count": 10, "total_s": 0.6,
    }
    assert validate_fleet_telemetry_artifact({"fleet_telemetry": ft}) == []


def test_fleet_telemetry_validator_trips_on_doctored_totals():
    tower = ControlTower()
    tower.register_source("replica-0", _source({"serve.served": 10}))
    ft = tower.fleet_telemetry()
    ft["totals"]["counters"]["serve.served"] = 11  # the lie
    problems = validate_fleet_telemetry_artifact({"fleet_telemetry": ft})
    assert problems and "serve.served" in problems[0]
    assert validate_fleet_telemetry_artifact({}) == [
        "missing fleet_telemetry block"
    ]
    assert validate_fleet_telemetry_artifact(
        {"fleet_telemetry": {"sources": {}}}
    ) == ["fleet_telemetry has no sources"]


def test_raising_source_is_isolated_not_fatal():
    tower = ControlTower()
    tower.register_source("replica-0", _source({"serve.served": 1}))

    def bad():
        raise RuntimeError("replica gone")

    tower.register_source("replica-1", bad)
    ft = tower.fleet_telemetry()
    assert ft["sources"]["replica-1"]["error"] == "replica gone"
    assert ft["source_errors"] >= 1
    # the healthy source still aggregates, and the block still validates
    assert ft["totals"]["counters"] == {"serve.served": 1}
    assert validate_fleet_telemetry_artifact({"fleet_telemetry": ft}) == []


def test_unregister_source_removes_it_from_the_export():
    tower = ControlTower()
    tower.register_source("replica-0", _source({"x": 1}))
    tower.unregister_source("replica-0")
    assert tower.fleet_telemetry()["n_sources"] == 0


# ---------------------------------------------------------------------------
# SLO burn-rate alerts (injected clock)
# ---------------------------------------------------------------------------


def _slo_rig(threshold=100.0, fast_s=1.0, slow_s=5.0, burn=0.5):
    t = [0.0]
    val = [0.0]
    tower = ControlTower(clock=lambda: t[0])
    tower.register_signal("p99", lambda: val[0])
    tower.set_slos([
        SLO("lat", "p99", threshold, direction="above",
            fast_s=fast_s, slow_s=slow_s, burn=burn),
    ])
    return tower, t, val


def test_sustained_breach_opens_then_recovery_closes(obs_sandbox):
    recorder.enable()
    tower, t, val = _slo_rig()
    for _ in range(10):          # healthy 5s baseline
        tower.tick()
        t[0] += 0.5
    assert tower.open_alerts() == []
    val[0] = 250.0
    for _ in range(12):          # sustained 6s breach fills both windows
        tower.tick()
        t[0] += 0.5
    open_alerts = tower.open_alerts()
    assert len(open_alerts) == 1
    assert open_alerts[0]["slo"] == "lat"
    assert open_alerts[0]["fast_burn"] >= 0.5
    val[0] = 50.0
    for _ in range(4):           # fast window clears -> close
        tower.tick()
        t[0] += 0.5
    assert tower.open_alerts() == []
    block = tower.alerts_block()
    assert block["opened"] == 1 and block["closed"] == 1
    assert [e["action"] for e in block["events"]] == ["open", "close"]
    assert validate_alerts_artifact({"alerts": block}) == []
    # the transitions also landed in the black box
    names = [e["name"] for e in recorder.events()]
    assert "alert.lat.open" in names and "alert.lat.close" in names


def test_one_sample_blip_does_not_open():
    # the slow window is the flap guard: one breached sample satisfies
    # the fast window but not the slow one
    tower, t, val = _slo_rig()
    for _ in range(9):
        tower.tick()
        t[0] += 0.5
    val[0] = 250.0
    tower.tick()
    t[0] += 0.5
    val[0] = 50.0
    for _ in range(3):
        tower.tick()
        t[0] += 0.5
    assert tower.open_alerts() == []
    assert tower.alerts_block()["opened"] == 0


def test_slo_constructor_rejects_bad_specs():
    with pytest.raises(ValueError):
        SLO("x", "s", 1.0, direction="sideways")
    with pytest.raises(ValueError):
        SLO("x", "s", 1.0, burn=0.0)
    with pytest.raises(ValueError):
        SLO("x", "s", 1.0, fast_s=5.0, slow_s=1.0)
    below = SLO("x", "s", 0.9, direction="below")
    assert below.breached(0.5) and not below.breached(0.95)


def test_validate_alerts_artifact_failure_modes():
    assert validate_alerts_artifact({}) == ["missing alerts block"]
    bad = {
        "slos": [{"name": "x"}],                      # incomplete spec
        "open": [],
        "events": [{"slo": "x", "t": 0.0, "action": "page"}],
        "opened": 1,
        "closed": 2,                                  # closed > opened
    }
    problems = validate_alerts_artifact({"alerts": bad})
    assert any("missing 'signal'" in p for p in problems)
    assert any("not open/close" in p for p in problems)
    assert any("closed 2 > opened 1" in p for p in problems)
    # ledger consistency: open list must equal opened - closed
    ledger = {
        "slos": [], "open": [], "events": [], "opened": 2, "closed": 1,
    }
    problems = validate_alerts_artifact({"alerts": ledger})
    assert any("0 open alert(s) != opened 2" in p for p in problems)


def test_window_mean_and_signal_read_back():
    tower, t, val = _slo_rig()
    for v in (10.0, 20.0, 30.0):
        val[0] = v
        tower.tick()
        t[0] += 1.0
    assert tower.signal("p99") == 30.0
    assert tower.window_mean("p99", 10.0) == 20.0
    assert tower.window_mean("p99", 1.5) == 30.0  # only the newest


# ---------------------------------------------------------------------------
# Heartbeat fleet fields
# ---------------------------------------------------------------------------


def test_heartbeat_carries_tower_fleet_fields(tmp_path, obs_sandbox):
    tower = ControlTower()
    tower.register_source("replica-0", _source({"x": 1}))
    tower.register_source("replica-1", _source({"x": 1}))
    tower.register_signal("fleet.queued_depth", lambda: 3.0)
    tower.register_signal("fleet.brownout_level", lambda: 1.0)
    tower.tick()
    fields = tower.heartbeat_fields()
    assert fields == {
        "fleet_replicas": 2,
        "fleet_open_alerts": 0,
        "fleet_queue_depth": 3,
        "fleet_brownout_level": 1,
    }
    jsonl = tmp_path / "hb.jsonl"
    metrics.enable(str(jsonl))
    hb = Heartbeat(total=4, interval_s=0.0, tower=tower)
    hb.update(2)
    hb.finish()
    metrics.disable()
    beats = [
        json.loads(l) for l in jsonl.read_text().splitlines()
        if json.loads(l).get("kind") == "heartbeat"
    ]
    assert beats and beats[-1]["fleet_replicas"] == 2
    assert beats[-1]["fleet_queue_depth"] == 3


# ---------------------------------------------------------------------------
# Per-source trace tracks
# ---------------------------------------------------------------------------


def test_by_source_groups_attribution_by_named_track(obs_sandbox):
    tr = trace.get_tracer()
    tr.enable()
    trace.name_track(threading.get_native_id(), "replica-7")
    with trace.span("serve.batch"):
        pass
    trace.instant("fleet.hbm_shed", cat="fleet")
    rows = report.by_source(trace.export())
    labels = {r["label"] for r in rows}
    assert "replica-7" in labels
    row = next(r for r in rows if r["label"] == "replica-7")
    assert row["spans"] >= 1 and row["events"] >= 1


# ---------------------------------------------------------------------------
# Merged cross-process timelines
# ---------------------------------------------------------------------------


def _proc_trace(pid, epoch, spans):
    """A hand-built one-process Chrome trace (merge_traces input):
    ``spans`` maps span_id -> (name, ts_us, dur_us, extra_args)."""
    events = [
        {"name": name, "ph": "X", "ts": ts, "dur": dur,
         "pid": pid, "tid": 1,
         "args": {"span_id": sid, "parent_id": 0, **extra}}
        for sid, (name, ts, dur, extra) in spans.items()
    ]
    return {"traceEvents": events, "otherData": {"t_epoch": epoch}}


def _merged_fleet_timeline():
    router = _proc_trace(1000, 100.0, {
        5: ("proc.request", 0.0, 1000.0, {}),
    })
    # the worker's wall clock runs 0.5s AHEAD of the router's and its
    # tracer booted 0.2s later: epoch 100.7 = 100.0 + 0.5 + 0.2
    worker = _proc_trace(2000, 100.7, {
        3: ("proc.worker_request", 100.0, 500.0,
            {"xparent": 5, "xpid": 1000}),
    })
    return report.merge_traces(
        [router, worker],
        offsets={2000: {"offset_s": 0.5, "rtt_s": 0.004}},
        labels={1000: "router", 2000: "worker-0.g1"},
    )


def test_merge_traces_aligns_clocks_and_reparents_across_pids():
    merged = _merged_fleet_timeline()
    meta = merged["otherData"]
    assert meta["n_processes"] == 2
    assert meta["pids"] == [1000, 2000]
    assert meta["clock_offsets"] == {
        "2000": {"offset_s": 0.5, "rtt_s": 0.004}}
    spans = {
        (e["pid"], e["name"]): e
        for e in merged["traceEvents"] if e.get("ph") == "X"
    }
    # the worker span lands 0.2s after the router's start once the
    # 0.5s clock skew is subtracted: 100us own ts + 200000us shift
    wspan = spans[(2000, "proc.worker_request")]
    assert wspan["ts"] == pytest.approx(200100.0, abs=0.01)
    # ids namespaced per process; the cross-process hop re-parents the
    # worker span under the ROUTER's span 5
    assert wspan["args"]["span_id"] == report.MERGE_SPAN_NS + 3
    assert wspan["args"]["parent_id"] == 5
    assert spans[(1000, "proc.request")]["args"]["span_id"] == 5
    # the merged timeline is structurally valid Chrome trace JSON
    assert report.validate_trace_events(merged) == []


def test_by_process_groups_merged_timeline_by_pid():
    rows = report.by_process(_merged_fleet_timeline())
    by_label = {r["label"]: r for r in rows}
    assert set(by_label) == {"router", "worker-0.g1"}
    assert by_label["router"]["pid"] == 1000
    assert by_label["router"]["spans"] == 1
    assert by_label["worker-0.g1"]["top"][0]["name"] == (
        "proc.worker_request")


def test_run_manifest_completeness():
    m = run_manifest(
        baseline_source="measured", params={"N": 1024, "mode": "streamed"}
    )
    for field in (
        "schema", "timestamp_utc", "hostname", "python", "torch", "cuda",
        "nvcc", "numpy", "device", "git_sha", "git_dirty", "argv", "env",
        "baseline_source", "config_params", "config_hash",
    ):
        assert field in m, field
    assert "jax" not in m
    assert m["baseline_source"] == "measured"
    # the tests run on the CPU: no card, no power limit
    assert m["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    # env capture holds only engine-relevant knobs, no JAX/XLA ones
    assert all(
        k.startswith(("SWIFTLY_", "BENCH_", "CUDA_", "PYTORCH_", "TORCH_",
                      "NVIDIA_", "OMP_")) for k in m["env"]
    )
    # config hash is deterministic and order-insensitive
    m2 = run_manifest(params={"mode": "streamed", "N": 1024})
    assert m2["config_hash"] == m["config_hash"]
    json.dumps(m)


def test_manifest_reads_the_card_and_its_power_limit(monkeypatch):
    """On the card: ``platform`` "gpu", the device's name and count, and
    the power limit as ``nvidia-smi`` prints it (left out where the
    command fails)."""
    import subprocess

    import torch

    from swiftly_tpu_torch.obs import manifest

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    class _Smi:
        returncode = 0
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"

    monkeypatch.setattr(subprocess, "run", lambda *a, **k: _Smi())
    assert manifest._device_info() == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
        "power_limit": "700.00 W"}

    def _missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", _missing)
    assert "power_limit" not in manifest._device_info()
    assert manifest._versions()["nvcc"] is None


def test_config_hash_equals_jax():
    from swiftly_tpu_torch.obs import manifest as jmanifest

    from swiftly_tpu_torch.obs import manifest

    for params in ({"N": 1024}, {"mode": "x", "nested": {"a": [1, 2]}}, {}):
        assert manifest.config_hash(params) == jmanifest.config_hash(params)


def test_run_manifest_rejects_bad_baseline_source():
    with pytest.raises(ValueError, match="baseline_source"):
        run_manifest(baseline_source="guessed")


def test_validate_artifact():
    good = {
        "metric": "x wall-clock", "value": 1.0, "unit": "s",
        "baseline_source": "estimated",
        "manifest": run_manifest(baseline_source="estimated"),
    }
    assert validate_artifact(good) == []
    assert validate_artifact({"value": 1.0}) != []
    missing = dict(good)
    missing["manifest"] = {k: v for k, v in good["manifest"].items()
                           if k != "git_sha"}
    assert any("git_sha" in p for p in validate_artifact(missing))
    bad_src = dict(good, baseline_source="vibes")
    bad_src["manifest"] = dict(good["manifest"], baseline_source="vibes")
    assert any("baseline_source" in p for p in validate_artifact(bad_src))


def test_heartbeat_emits_to_event_log(tmp_path, global_registry):
    global_registry.enable(tmp_path / "hb.jsonl")
    hb = Heartbeat(total=100, label="subgrids", interval_s=0.0)
    hb.update(25)
    hb.update(25)
    hb.finish()
    global_registry.disable()
    records = [
        json.loads(ln)
        for ln in (tmp_path / "hb.jsonl").read_text().splitlines()
    ]
    beats = [r for r in records if r["kind"] == "heartbeat"]
    assert [b["done"] for b in beats] == [25, 50, 50]
    assert beats[0]["total"] == 100
    assert beats[0]["rate_per_s"] > 0
    assert beats[0]["eta_s"] is not None


def test_partial_artifact_writer(tmp_path):
    path = tmp_path / "partial.jsonl"
    w = PartialArtifactWriter(path)
    w.append({"leg": "a", "status": "started"})
    w.append({"leg": "a", "value": 1.5})
    assert w.read_all() == [
        {"leg": "a", "status": "started"}, {"leg": "a", "value": 1.5},
    ]
    # disabled writer: every method a no-op
    off = PartialArtifactWriter(None)
    off.append({"x": 1})
    assert off.read_all() == []


def _doctored_record(platform="cpu", fold_tf_s=2.0, col_tf_s=4.0):
    """A provenance-stamped artifact record whose per-stage telemetry
    encodes known throughputs (flops / total_s), as `autotune.refit`
    reads them."""
    return {
        "metric": "doctored leg", "value": 10.0,
        "manifest": {"device": {"platform": platform}},
        "telemetry": {
            "stages": {
                "bwd.sampled_fold": {
                    "total_s": 10.0, "flops": fold_tf_s * 1e12 * 10.0,
                },
                "bwd.column_pass": {
                    "total_s": 10.0, "flops": col_tf_s * 1e12 * 10.0,
                },
                "spill.h2d": {"total_s": 5.0, "bytes": 30e9},
                "idle.untyped": {"total_s": 3.0},  # no flops: ignored
            }
        },
    }


def test_plan_autotune_refit_fits_measured_rates():
    from swiftly_tpu_torch.plan import refit

    coeffs = refit([_doctored_record()])
    assert coeffs.source == "measured" and coeffs.n_records == 1
    assert coeffs.flops_per_s["bwd.sampled_fold"] == pytest.approx(2e12)
    assert coeffs.flops_per_s["bwd.column_pass"] == pytest.approx(4e12)
    assert coeffs.bytes_per_s["spill.h2d"] == pytest.approx(6e9)
    assert "idle.untyped" not in coeffs.flops_per_s
    # a record from ANOTHER platform must be skipped, not averaged —
    # with nothing left the defaults come back unfit
    assert refit([_doctored_record("tpu")], platform="cpu").source == (
        "default"
    )
    # two same-platform records pool their (flops, seconds) sums
    pooled = refit([_doctored_record(), _doctored_record(fold_tf_s=4.0)])
    assert pooled.flops_per_s["bwd.sampled_fold"] == pytest.approx(3e12)


def test_plan_autotune_changes_plan_parameter_from_history(tmp_path,
                                                          monkeypatch):
    """The acceptance loop: doctored measured artifacts -> refit ->
    `compile_plan(..., history=...)` picks a DIFFERENT fold group than
    the seed heuristic, while the no-history plan provably keeps it. (The
    doctored record times the einsum body's stages, so the plan prices
    that body; the margins are the JAX package's, given explicitly, and
    the spill budget too, so the plan does not depend on this host.)"""
    from swiftly_tpu_torch.plan import PlanInputs, compile_plan

    monkeypatch.setenv("SWIFTLY_COLPASS", "einsum")
    monkeypatch.setenv("SWIFTLY_COLPASS_BWD", "einsum")

    inputs = PlanInputs.from_config(
        "64k[1]-n32k-512", hbm_budget=16.0e9
    )
    margins = dict(fwd_min=3.3e9, reserve=1.2e9, spill_budget=48e9)
    seed = compile_plan(inputs, **margins)
    assert seed.coeffs_source == "default"
    assert seed.backward.fold_group == inputs.fold_group == 2
    # history via an on-disk doctored artifact (the real read path,
    # round-ledger shape included)
    art = tmp_path / "BENCH_doctored.json"
    art.write_text(json.dumps({"parsed": _doctored_record()}))
    tuned = compile_plan(inputs, history=[str(art)], **margins)
    assert tuned.coeffs_source == "measured"
    assert tuned.backward.fold_group != seed.backward.fold_group
    # the measured choice is the predicted-wall argmin of the ranked
    # alternatives the plan records
    best = min(tuned.alternatives, key=lambda a: a["predicted_wall_s"])
    assert best["chosen"] and best["fold_group"] == (
        tuned.backward.fold_group
    )
    # same grids either way at this geometry: only the parameter moved
    assert tuned.backward.n_passes == seed.backward.n_passes


def test_validate_plan_artifact():
    from swiftly_tpu_torch.obs import validate_plan_artifact
    from swiftly_tpu_torch.plan import PlanInputs, compile_plan

    plan = compile_plan(PlanInputs.from_config("4k[1]-n2k-512"))
    record = {"plan_compiled": plan.artifact_block(measured_wall_s=1.5)}
    assert validate_plan_artifact(record) == []
    assert record["plan_compiled"]["predicted_vs_measured"] > 0
    assert validate_plan_artifact({}) == ["missing plan_compiled block"]
    # incoherent pass grid
    bad = {"plan_compiled": dict(plan.artifact_block())}
    bad["plan_compiled"]["backward"] = dict(
        bad["plan_compiled"]["backward"], n_passes=7
    )
    assert any("incoherent" in p for p in validate_plan_artifact(bad))
    # unknown spill mode
    bad2 = {"plan_compiled": dict(plan.artifact_block())}
    bad2["plan_compiled"]["spill"] = {"mode": "floppy"}
    assert any("spill mode" in p for p in validate_plan_artifact(bad2))
    # non-ascending serve buckets
    bad3 = {"plan_compiled": dict(plan.artifact_block())}
    bad3["plan_compiled"]["serve"] = {"bucket_sizes": [4, 2, 8]}
    assert any("bucket_sizes" in p for p in validate_plan_artifact(bad3))
    # coefficient pedigree must be stamped and known
    bad4 = {"plan_compiled": dict(plan.artifact_block())}
    bad4["plan_compiled"]["coeffs_source"] = "vibes"
    assert any("coeffs_source" in p for p in validate_plan_artifact(bad4))


def _demo_trace():
    tr = Tracer(enabled=True)
    with tr.span("bench.leg", cat="bench", config="1k") :
        with tr.span("fwd.pass"):
            time.sleep(0.002)
            with tr.span("fwd.column_group"):
                time.sleep(0.004)
        with tr.span("bwd.pass"):
            time.sleep(0.001)
    tr.instant("fault.injected", site="spill.read")
    return tr.export()


def test_validate_trace_events_failure_modes():
    assert validate_trace_events([]) != []
    assert validate_trace_events({}) == ["missing traceEvents list"]
    assert "empty" in validate_trace_events({"traceEvents": []})[0]
    bad_ph = {"traceEvents": [{"ph": "?", "name": "x"}]}
    assert any("unknown ph" in p for p in validate_trace_events(bad_ph))
    no_dur = {"traceEvents": [
        {"ph": "X", "name": "x", "pid": 1, "tid": 1, "ts": 0}
    ]}
    assert any("bad dur" in p for p in validate_trace_events(no_dur))


def test_validate_trace_artifact_failure_modes():
    good = {"trace": report.summarize_trace(_demo_trace())}
    assert validate_trace_artifact(good) == []
    assert validate_trace_artifact({}) == ["missing trace block"]
    assert validate_trace_artifact({"trace": "x"}) == [
        "missing trace block"
    ]
    empty = {"trace": dict(good["trace"], span_count=0)}
    assert any("no spans" in p for p in validate_trace_artifact(empty))
    nocp = {"trace": dict(good["trace"], critical_path=[])}
    assert any(
        "critical_path is empty" in p for p in validate_trace_artifact(nocp)
    )
    missing = {"trace": {k: v for k, v in good["trace"].items()
                         if k != "wall_s"}}
    assert any("wall_s" in p for p in validate_trace_artifact(missing))
    # attribution not covering the root wall = a torn span tree
    torn = {"trace": dict(good["trace"],
                          attributed_s=good["trace"]["wall_s"] * 0.5)}
    assert any(
        "does not cover" in p for p in validate_trace_artifact(torn)
    )
    json.dumps(report.summarize_trace(_demo_trace()))  # JSON-ready


def test_plan_autotune_learns_colpass_blocks_and_ranks_candidates():
    """The column pass's leg of the autotune loop: refit pools the
    measured column-stage rate of records that ran B1 (colpass "kernel"),
    keeps the tile set of the fastest one, and the compiled plan's forward
    block ranks einsum against the kernel, each row under its own
    coefficient stage, while `resolve_colpass` keeps the choice (the
    kernel body on the planar backend)."""
    from swiftly_tpu_torch.plan import PlanInputs, compile_plan, refit
    from swiftly_tpu_torch.plan import model as tmodel

    def rec(tf_s, blocks):
        r = _doctored_record()
        r["plan"] = {"colpass": "kernel", "colpass_blocks": blocks}
        r["telemetry"]["stages"]["fwd.column_pass"] = {
            "total_s": 10.0, "flops": tf_s * 1e12 * 10.0,
        }
        return r

    fast_blocks = {"bm": 128, "bn": 128, "bk": 32, "sblock": 512}
    coeffs = refit([
        rec(10.0, {"bm": 64, "bn": 64, "bk": 16, "sblock": 64}),
        rec(30.0, fast_blocks),
    ])
    assert coeffs.source == "measured"
    assert coeffs.colpass_blocks == fast_blocks
    assert coeffs.flops_per_s["fwd.column_pass"] == pytest.approx(20e12)
    plan = compile_plan(
        PlanInputs.from_config("64k[1]-n32k-512", hbm_budget=16.0e9),
        coeffs=coeffs,
    )
    fwd = plan.artifact_block()["forward"]
    assert fwd["colpass"] == "kernel"
    assert fwd["colpass_blocks"] == fast_blocks
    ranked = fwd["colpass_candidates"]
    assert {r["colpass"] for r in ranked} == {"einsum", "kernel"}
    rows = {r["colpass"]: r for r in ranked}
    assert rows["einsum"]["flops_per_s"] == pytest.approx(20e12)
    assert rows["kernel"]["coeff_stage"] == "fwd.column_pass.kernel"
    assert rows["kernel"]["flops_per_s"] == \
        tmodel._DEFAULT_FLOPS_PER_S["fwd.column_pass.kernel"]
    assert ranked == sorted(ranked, key=lambda r: r["predicted_wall_s"])


def test_profiling_on_the_cpu(tmp_path):
    """`utils.profiling` without a card: no probe, the CPU's empty stats,
    the sampler's zero rows, a profiler trace in Chrome JSON, and the
    collective accounting for numpy and torch dtypes alike."""
    import numpy as np
    import torch

    from swiftly_tpu.utils import profiling as jprof
    from swiftly_tpu_torch.plan import hbm_budget_bytes
    from swiftly_tpu_torch.utils import profiling

    assert profiling.probe_hbm_bytes() is None
    assert hbm_budget_bytes(device="cpu") is None
    assert profiling.device_memory_stats() == {"cpu": {}}
    sampler = profiling.MemorySampler(interval=0.001)
    with sampler.sample():
        time.sleep(0.01)
    assert sampler.rows and all(r[1:] == ("cpu", 0) for r in sampler.rows)
    sampler.to_csv(tmp_path / "mem.csv")
    sampler.to_html(tmp_path / "mem.html")
    assert (tmp_path / "mem.csv").read_text().startswith("t_seconds,")
    with profiling.trace(tmp_path / "prof") as prof:
        torch.ones(8).sum()
    assert prof is not None
    (out,) = (tmp_path / "prof").iterdir()
    assert json.loads(out.read_text())["traceEvents"]
    with profiling.trace(None) as none:
        assert none is None
    for d in (2, 4, 8):
        for dt, jdt in ((torch.float32, np.float32),
                        (torch.float64, np.float64)):
            assert profiling.collective_bytes_forward(512, d, dt) == \
                jprof.collective_bytes_forward(512, d, jdt)
            assert profiling.collective_bytes_backward(448, d, dt, False) == \
                jprof.collective_bytes_backward(448, d, jdt, False)


def test_stage_device_time_is_off_on_the_cpu_and_read_from_events():
    """The registry times a stage's device time only where it was enabled
    for a CUDA device; the export folds (start, end) event pairs into
    ``device_s`` (here stand-in events with a fixed elapsed time)."""
    from swiftly_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry(enabled=True)
    assert reg._device_events is False
    with reg.stage("fwd.column_pass", flops=10):
        pass
    assert "device_s" not in reg.export()["stages"]["fwd.column_pass"]

    class _Ev:
        def __init__(self, t):
            self.t = t

        def query(self):
            return True

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3  # ms, as CUDA events give it

    reg._record_stage("bwd.sampled_fold", 0.001, 5, 0, (_Ev(0.0), _Ev(0.25)))
    reg._record_stage("bwd.sampled_fold", 0.001, 5, 0, (_Ev(1.0), _Ev(1.5)))
    entry = reg.export()["stages"]["bwd.sampled_fold"]
    assert entry["device_s"] == pytest.approx(0.75)
    assert entry["device_count"] == 2 and entry["count"] == 2
