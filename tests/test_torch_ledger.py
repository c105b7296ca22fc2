"""The plan-accuracy ledger of the port (`swiftly_tpu_torch.obs.ledger`).

The port's counterparts of the module-level cases of
``tests/test_plan_ledger.py`` (the cases that drive ``scripts/`` are in
``tests/test_torch_tools.py``): the join (`stage_accuracy`, `plan_accuracy_block`) with its
ratio, fan-out and coverage; the validator's no-silent-gaps schema; the
sig-fig stamping of measured walls; the total-mapping guard over the
port's own stage sites and compiled plans; the calibration history,
`ledger_readiness` and `refit_from_ledger`; the tower drill and the
flight-recorder trail. Beside them: the join reads a stage's device time
where the registry timed one, the platform rule of the port's refit
(a TPU record never calibrates the card), and both packages' ledgers on
the same blocks.
"""

import json
import re
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from swiftly_tpu_torch.obs import (  # noqa: E402
    ControlTower,
    metrics,
    recorder,
    trace,
    validate_plan_accuracy_artifact,
    validate_plan_artifact,
)
from swiftly_tpu_torch.obs import ledger as oledger  # noqa: E402
from swiftly_tpu_torch.plan import (  # noqa: E402
    CostCoefficients,
    PlanInputs,
    compile_plan,
    ledger_readiness,
    refit_from_ledger,
    stamp_measured_wall,
)


@pytest.fixture
def obs_sandbox():
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


@pytest.fixture
def history_off(monkeypatch):
    """Tests must never append to the repo-level calibration file."""
    monkeypatch.setenv("SWIFTLY_CALIBRATION_HISTORY", "0")


def _plan_block(stages, coeffs_source="default", config="synthetic",
                mode="roundtrip-streamed"):
    """A minimal stamped ``plan_compiled`` block for the join."""
    return {
        "config": config,
        "mode": mode,
        "inputs_hash": "cafe1234",
        "coeffs_source": coeffs_source,
        "predicted": {
            "wall_s": sum(c.get("wall_s", 0.0) for c in stages.values()),
            "stages": stages,
        },
    }


def _telemetry(stage_walls, counts=None):
    """A minimal ``metrics.export()`` shape for the join."""
    return {
        "enabled": True,
        "stages": {
            name: {"count": (counts or {}).get(name, 1),
                   "total_s": wall}
            for name, wall in stage_walls.items()
        },
    }


def _accuracy_block(ratio=1.0, coeffs_source="measured",
                    platform="cpu", flops=2.0e9, wall=0.5):
    """A calibrated ``plan_accuracy`` block whose single stage has the
    given predicted/measured ratio — the drill and refit input."""
    plan = _plan_block(
        {"bwd.column_pass": {"wall_s": wall * ratio, "flops": flops}},
        coeffs_source=coeffs_source,
    )
    telem = _telemetry({"bwd.column_pass": wall})
    return oledger.plan_accuracy_block(
        plan, telem,
        manifest={"device": {"platform": platform}, "git_sha": "abc123"},
    )


# ---------------------------------------------------------------------------
# Sig-fig rounding and measured-wall stamping (the quantization fix)
# ---------------------------------------------------------------------------


def test_round_sig_keeps_sub_millisecond_walls():
    # round(3.2e-05, 4) == 0.0 was the bug: a smoke-leg stage wall
    # vanished and took every downstream ratio with it
    assert round(3.2e-05, 4) == 0.0
    assert oledger.round_sig(3.2e-05) == 3.2e-05
    assert oledger.round_sig(3.24159e-05) == 3.242e-05
    assert oledger.round_sig(123456.7) == 123500.0
    assert oledger.round_sig(0.0) == 0.0
    assert oledger.round_sig(float("inf")) == float("inf")


def test_stamp_measured_wall_emits_ratio_for_tiny_walls():
    block = {"predicted": {"wall_s": 6.4e-05}}
    stamp_measured_wall(block, 3.2e-05)
    assert block["measured_wall_s"] == 3.2e-05  # not quantized to 0.0
    assert block["predicted_vs_measured"] == pytest.approx(2.0)
    # zero measured wall: stamped as-is, no bogus ratio
    zero = {"predicted": {"wall_s": 1.0}}
    stamp_measured_wall(zero, 0.0)
    assert zero["measured_wall_s"] == 0.0
    assert "predicted_vs_measured" not in zero


def test_artifact_block_stamps_tiny_measured_wall():
    inputs = PlanInputs.from_config("1k[1]-n512-256")
    plan = compile_plan(inputs, mode="roundtrip-streamed")
    block = plan.artifact_block(measured_wall_s=3.2e-05)
    assert block["measured_wall_s"] == 3.2e-05
    assert block["predicted_vs_measured"] > 0
    assert validate_plan_artifact({"plan_compiled": block}) == []


# ---------------------------------------------------------------------------
# The join: stage_accuracy / plan_accuracy_block
# ---------------------------------------------------------------------------


def test_stage_accuracy_joins_ratio_and_coverage():
    plan = _plan_block({
        "fwd.column_pass": {"wall_s": 0.2, "flops": 1e9},
        "bwd.column_pass": {"wall_s": 0.6, "flops": 3e9},
        "bwd.sampled_fold": {"wall_s": 0.2, "flops": 1e9},
    })
    telem = _telemetry(
        {"fwd.column_pass": 0.1, "bwd.column_pass": 1.2},
        counts={"bwd.column_pass": 4},
    )
    stages, uncovered, totals = oledger.stage_accuracy(plan, telem)
    # ratio = predicted / measured: >1 over-predicted, <1 optimistic
    assert stages["fwd.column_pass"]["ratio"] == pytest.approx(2.0)
    assert stages["bwd.column_pass"]["ratio"] == pytest.approx(0.5)
    assert stages["bwd.column_pass"]["count"] == 4
    assert stages["fwd.column_pass"]["flops"] == 1e9
    assert "measured_wall_s" not in stages["bwd.sampled_fold"]
    assert uncovered == ["bwd.sampled_fold"]
    # coverage is the PREDICTED wall fraction with a measured join
    assert totals["coverage"] == pytest.approx(0.8)
    assert totals["predicted_stage_wall_s"] == pytest.approx(1.0)
    assert totals["measured_stage_wall_s"] == pytest.approx(1.3)


def test_stage_accuracy_sums_multi_timer_fanout():
    # a priced stage may fan out to several runtime timers (geometry
    # picks the body) — the join sums whichever fired
    plan = _plan_block({"fwd.column_pass": {"wall_s": 0.4, "flops": 1e9}})
    telem = _telemetry({"fwd.column_pass": 0.1, "fwd.slab_step": 0.1})
    stages, uncovered, _ = oledger.stage_accuracy(plan, telem)
    entry = stages["fwd.column_pass"]
    assert entry["measured_wall_s"] == pytest.approx(0.2)
    assert sorted(entry["measured_timers"]) == [
        "fwd.column_pass", "fwd.slab_step",
    ]
    assert entry["ratio"] == pytest.approx(2.0)
    assert uncovered == []


def test_plan_accuracy_block_validates_and_keys_provenance():
    block = _accuracy_block(ratio=1.25)
    assert block["schema"] == oledger.PLAN_ACCURACY_SCHEMA
    assert block["inputs_hash"] == "cafe1234"
    assert block["platform"] == "cpu"
    assert block["git_sha"] == "abc123"
    assert block["coeffs_source"] == "measured"
    assert block["coverage"] == 1.0
    assert validate_plan_accuracy_artifact(block) == []
    # and via the full-record shape bench stamps
    assert validate_plan_accuracy_artifact({"plan_accuracy": block}) == []


def test_validator_failure_modes():
    assert validate_plan_accuracy_artifact({"plan_accuracy": None}) == [
        "missing plan_accuracy block"
    ]
    block = _accuracy_block(ratio=1.0)
    # silent gap: unmeasured stage missing from uncovered
    gap = json.loads(json.dumps(block))
    gap["stages"]["bwd.sampled_fold"] = {"predicted_wall_s": 0.1,
                                         "timers": []}
    problems = validate_plan_accuracy_artifact(gap)
    assert any("silent gap" in p for p in problems)
    # measured stage listed uncovered
    contradictory = json.loads(json.dumps(block))
    contradictory["uncovered"] = ["bwd.column_pass"]
    problems = validate_plan_accuracy_artifact(contradictory)
    assert any("measured AND listed uncovered" in p for p in problems)
    # both walls positive but no ratio
    noratio = json.loads(json.dumps(block))
    del noratio["stages"]["bwd.column_pass"]["ratio"]
    problems = validate_plan_accuracy_artifact(noratio)
    assert any("no ratio" in p for p in problems)
    # out-of-range coverage, unknown pedigree, wrong schema
    bad = json.loads(json.dumps(block))
    bad["coverage"] = 1.5
    bad["coeffs_source"] = "vibes"
    bad["schema"] = "nope"
    problems = validate_plan_accuracy_artifact(bad)
    assert any("[0, 1]" in p for p in problems)
    assert any("not default|measured|ledger" in p for p in problems)
    assert any("schema" in p for p in problems)


# ---------------------------------------------------------------------------
# The stage-contract drift guard (every timer mapped or exempt)
# ---------------------------------------------------------------------------


_STAGE_SITE_RE = re.compile(
    r"_metrics\.(?:stage|observe)\(\s*\"([^\"]+)\"")
# the flight queues time their waits as the stage they are given
# (`api.FlightQueue(..., stage=...)`)
_QUEUE_STAGE_RE = re.compile(r"FlightQueue\([^\n]*stage=\"([a-z_.0-9]+)\"")


def _port_stage_sites():
    found = set()
    for path in sorted((REPO / "swiftly_tpu_torch").rglob("*.py")):
        text = path.read_text()
        found.update(_STAGE_SITE_RE.findall(text))
        found.update(_QUEUE_STAGE_RE.findall(text))
    return found


def test_every_runtime_stage_timer_is_mapped_or_exempt():
    """A new stage or observe site anywhere in the port cannot silently
    fall outside the ledger: its literal name must join a priced stage
    (`PLAN_STAGE_TIMERS`) or carry a documented exemption
    (`EXEMPT_STAGE_TIMERS`)."""
    found = _port_stage_sites()
    assert found, "no stage sites found — regex drifted from the code"
    # the streamed executors' sites are all found, the drains included
    assert {"fwd.column_pass", "fwd.slab_step", "bwd.column_pass",
            "bwd.sampled_fold", "fwd.drain", "bwd.drain",
            "bwd.feed_group", "vis.row_fetch", "vis.grid",
            "vis.degrid"} <= found
    assert oledger.unmapped_stage_names(found) == []
    # the mapping stays two-sided: no exemption shadows a mapped timer
    overlap = oledger.mapped_timer_names() & set(
        oledger.EXEMPT_STAGE_TIMERS
    )
    assert overlap == set()
    # every exemption documents its reason, and names a stage the port
    # times
    assert all(r.strip() for r in oledger.EXEMPT_STAGE_TIMERS.values())
    assert set(oledger.EXEMPT_STAGE_TIMERS) <= found


@pytest.mark.parametrize("colpass", ["auto", "einsum", "fft"])
def test_every_plan_priced_stage_is_mapped(monkeypatch, colpass):
    """Whatever the compiler prices, the ledger can join: priced stage
    names from compiled plans across modes, geometries, bodies, budgets
    and device counts are all `PLAN_STAGE_TIMERS` keys."""
    monkeypatch.setenv("SWIFTLY_COLPASS", colpass)
    monkeypatch.setenv("SWIFTLY_COLPASS_BWD",
                       "pallas" if colpass == "auto" else colpass)
    priced = set()
    for config, mode, kw in (
        ("1k[1]-n512-256", "roundtrip-streamed", {}),
        ("1k[1]-n512-256", "streamed", {"n_devices": 4}),
        ("4k[1]-n2k-512", "roundtrip-streamed", {}),
        ("16k[1]-n4k-1k", "roundtrip-streamed", {"planar": False,
                                                  "dtype_bytes": 8}),
        ("128k[1]-n32k-512", "roundtrip-streamed",
         {"hbm_budget": 80e9, "real_facets": True}),
    ):
        inputs = PlanInputs.from_config(config, **kw)
        for allow_spill in (True, False):
            plan = compile_plan(inputs, mode=mode, allow_spill=allow_spill,
                                spill_budget=1e9)
            priced.update(plan.predicted["stages"])
    assert "fwd.replay" in priced
    if colpass == "auto":  # the planar backend's bodies are B1
        assert {"fwd.column_pass.kernel", "bwd.column_pass.kernel"} <= priced
    unmapped = priced - set(oledger.PLAN_STAGE_TIMERS)
    assert unmapped == set()


# ---------------------------------------------------------------------------
# Calibration history + ledger refit
# ---------------------------------------------------------------------------


def test_history_append_load_roundtrip(tmp_path, monkeypatch):
    path = tmp_path / "BENCH_calibration.jsonl"
    monkeypatch.setenv("SWIFTLY_CALIBRATION_HISTORY", str(path))
    assert oledger.history_path() == str(path)
    a = _accuracy_block(ratio=1.0)
    b = _accuracy_block(ratio=1.1)
    assert oledger.append_history(a) == str(path)
    oledger.append_history(b)
    # non-ledger lines in the same file are skipped, not fatal
    with open(path, "a") as fh:
        fh.write(json.dumps({"schema": "other/1"}) + "\n")
        fh.write("not json\n")
    loaded = oledger.load_calibration_history(str(path))
    assert len(loaded) == 2
    assert loaded[0]["inputs_hash"] == "cafe1234"
    # "0" disables history entirely
    monkeypatch.setenv("SWIFTLY_CALIBRATION_HISTORY", "0")
    assert oledger.history_path() is None
    assert oledger.append_history(a) is None


def test_ledger_readiness_gates(history_off):
    one = [_accuracy_block(ratio=1.0)]
    r = ledger_readiness(one)
    assert not r["ready"]
    assert r["stages"]["bwd.column_pass"]["n"] == 1
    # two consistent runs: ready, platform picked up from the entries
    two = [_accuracy_block(ratio=1.0), _accuracy_block(ratio=1.05)]
    r = ledger_readiness(two)
    assert r["ready"] and r["platform"] == "cpu"
    assert r["stages"]["bwd.column_pass"]["ready"]
    assert r["stages"]["bwd.column_pass"]["rel_spread"] < 0.5
    # wrong-platform entries are skipped, not averaged
    r = ledger_readiness(two, platform="tpu")
    assert not r["ready"] and r["n_records"] == 0
    assert any("platform 'tpu'" in s for s in r["reasons"])
    # a 10x swing between runs fails the variance gate
    noisy = [
        _accuracy_block(ratio=1.0, wall=0.1),
        _accuracy_block(ratio=1.0, wall=1.0),
    ]
    r = ledger_readiness(noisy)
    assert not r["ready"]
    assert not r["stages"]["bwd.column_pass"]["ready"]


def test_refit_from_ledger_compiler_accepts_coefficients(history_off):
    history = [
        _accuracy_block(ratio=1.0, flops=2.0e9, wall=0.5),
        _accuracy_block(ratio=1.0, flops=2.0e9, wall=0.5),
    ]
    coeffs = refit_from_ledger(history)
    assert coeffs.source == "ledger"
    assert coeffs.calibrated
    assert coeffs.platform == "cpu" and coeffs.n_records == 2
    # rate = sum(flops) / sum(measured wall)
    assert coeffs.flops_per_s["bwd.column_pass"] == pytest.approx(4.0e9)
    # the compiler accepts ledger pedigree as calibrated: parameter
    # selection runs and the artifact records the provenance
    inputs = PlanInputs.from_config("1k[1]-n512-256")
    plan = compile_plan(
        inputs, coeffs=coeffs, mode="roundtrip-streamed"
    )
    block = plan.artifact_block(measured_wall_s=0.5)
    assert block["coeffs_source"] == "ledger"
    assert validate_plan_artifact({"plan_compiled": block}) == []
    chosen = [a for a in block["alternatives"] if a["chosen"]]
    assert len(chosen) == 1
    # and the chosen alternative is the predicted-wall argmin — the
    # calibrated gate, same as source="measured"
    assert chosen[0]["predicted_wall_s"] == min(
        a["predicted_wall_s"] for a in block["alternatives"]
    )


def test_refit_from_ledger_not_ready_returns_defaults(history_off):
    coeffs = refit_from_ledger([_accuracy_block(ratio=1.0)])
    assert coeffs.source == "default"
    assert not coeffs.calibrated


def test_refit_from_ledger_reads_jsonl_paths(tmp_path, monkeypatch):
    path = tmp_path / "cal.jsonl"
    monkeypatch.setenv("SWIFTLY_CALIBRATION_HISTORY", str(path))
    for _ in range(2):
        oledger.append_history(_accuracy_block(ratio=1.0))
    coeffs = refit_from_ledger(str(path))
    assert coeffs.source == "ledger" and coeffs.n_records == 2


# ---------------------------------------------------------------------------
# Tower drill: mispricing SLO + flight-recorder post-mortem
# ---------------------------------------------------------------------------


def _tower_rig(threshold=2.0):
    t = [0.0]
    latest = [None]
    tower = ControlTower(clock=lambda: t[0])
    oledger.register_plan_accuracy_source(
        tower, lambda: latest[0], threshold=threshold
    )
    return tower, t, latest


def test_sustained_mispricing_opens_alert_then_recovery_closes(
    obs_sandbox,
):
    tower, t, latest = _tower_rig()
    latest[0] = _accuracy_block(ratio=1.1, coeffs_source="ledger")
    for _ in range(10):          # healthy calibrated baseline
        tower.tick()
        t[0] += 0.5
    assert tower.open_alerts() == []
    ft = tower.fleet_telemetry()
    src = ft["sources"]["plan_accuracy"]
    assert src["calibrated"] and src["coverage"] == 1.0
    assert ft["totals"]["counters"]["plan.stages_priced"] == 1
    # drill: misprice the stage 5x beyond the 2x band, sustained
    latest[0] = _accuracy_block(ratio=5.0, coeffs_source="ledger")
    for _ in range(12):
        tower.tick()
        t[0] += 0.5
    open_alerts = tower.open_alerts()
    assert [a["slo"] for a in open_alerts] == ["plan_mispricing"]
    # the drill also lands the flight-recorder trail
    recorder.enable()
    bad = oledger.record_mispricing(latest[0], threshold=2.0)
    assert bad == [("bwd.column_pass", pytest.approx(5.0))]
    assert "plan.mispriced" in [
        e["name"] for e in recorder.events()
    ]
    # recovery: the plan re-priced, fast window clears, alert closes
    latest[0] = _accuracy_block(ratio=1.0, coeffs_source="ledger")
    for _ in range(4):
        tower.tick()
        t[0] += 0.5
    assert tower.open_alerts() == []
    assert tower.alerts_block()["opened"] == 1


def test_uncalibrated_block_never_alarms(obs_sandbox):
    # a default-coefficient miss is a ranking anchor being wrong, not a
    # broken contract: the signal pins to 1.0 and the recorder hook is
    # a no-op
    tower, t, latest = _tower_rig()
    latest[0] = _accuracy_block(ratio=10.0, coeffs_source="default")
    for _ in range(24):
        tower.tick()
        t[0] += 0.5
    assert tower.open_alerts() == []
    assert tower.signal("plan.mispricing_drift") == 1.0
    recorder.enable()
    assert oledger.record_mispricing(latest[0], threshold=2.0) == []
    assert recorder.events() == []
    # but the source still REPORTS the drift for the fleet block
    src = tower.fleet_telemetry()["sources"]["plan_accuracy"]
    assert not src["calibrated"]
    assert src["mispricing_drift"] == pytest.approx(10.0)


def test_record_mispricing_dumps_post_mortem(obs_sandbox, tmp_path):
    recorder.enable()
    out = tmp_path / "plan_pm.jsonl"
    block = _accuracy_block(ratio=0.2, coeffs_source="measured")
    bad = oledger.record_mispricing(
        block, threshold=2.0, dump_path=str(out)
    )
    assert [name for name, _r in bad] == ["bwd.column_pass"]
    lines = [json.loads(l) for l in out.read_text().splitlines()]
    header = lines[0]
    assert header["trigger"] == "PlanMispriced"
    assert "bwd.column_pass" in header["reason"]
    assert any(
        e.get("name") == "plan.mispriced" for e in lines[1:]
    )


# ---------------------------------------------------------------------------
# The port's additions: device time, the platform rule, both packages
# ---------------------------------------------------------------------------


def test_join_reads_device_time_where_the_registry_timed_one():
    """On the card a stage's host wall is launch-side; the export's
    ``device_s`` (CUDA events at the stage's ends) is what the join
    reads when present."""
    plan = _plan_block({"bwd.sampled_fold": {"wall_s": 0.8, "flops": 1e9}})
    telem = _telemetry({"bwd.sampled_fold": 0.1})
    telem["stages"]["bwd.sampled_fold"]["device_s"] = 0.4
    stages, uncovered, totals = oledger.stage_accuracy(plan, telem)
    assert stages["bwd.sampled_fold"]["measured_wall_s"] == 0.4
    assert stages["bwd.sampled_fold"]["ratio"] == pytest.approx(2.0)
    assert totals["measured_stage_wall_s"] == 0.4 and uncovered == []
    # no device time: the host wall, as the JAX package's join
    del telem["stages"]["bwd.sampled_fold"]["device_s"]
    stages, _, _ = oledger.stage_accuracy(plan, telem)
    assert stages["bwd.sampled_fold"]["measured_wall_s"] == 0.1


def test_ledger_refit_never_counts_a_tpu_entry(history_off):
    """Entries from a platform the port does not run on are skipped
    whatever their order; the card's own entries fit."""
    tpu = [_accuracy_block(ratio=1.0, platform="tpu", wall=0.05)
           for _ in range(3)]
    gpu = [_accuracy_block(ratio=1.0, platform="gpu", wall=0.5)
           for _ in range(2)]
    r = ledger_readiness(tpu + gpu)
    assert r["platform"] == "gpu" and r["n_records"] == 2
    coeffs = refit_from_ledger(tpu + gpu)
    assert coeffs.source == "ledger" and coeffs.platform == "gpu"
    assert coeffs.flops_per_s["bwd.column_pass"] == pytest.approx(4.0e9)
    # asked for the TPU's platform, nothing is fit
    assert not ledger_readiness(tpu, platform="tpu")["ready"]
    assert refit_from_ledger(tpu).source == "default"


def _jax_ledger():
    from swiftly_tpu.obs import ledger as jledger

    return jledger


@pytest.mark.parametrize("ratio", [0.25, 1.0, 3.0])
def test_both_packages_join_the_same_blocks_alike(ratio):
    """The same stamped plan block and telemetry through both packages'
    ledgers: the same stages, ratios, coverage and mispricing verdicts
    (on the stage names both price)."""
    jledger = _jax_ledger()
    plan = _plan_block({
        "fwd.sampled_facet_pass": {"wall_s": 0.3 * ratio, "flops": 3e9},
        "fwd.column_pass": {"wall_s": 0.2 * ratio, "flops": 1e9},
        "bwd.sampled_fold": {"wall_s": 0.5 * ratio, "flops": 2e9},
        "spill.write": {"wall_s": 0.1, "bytes": 1e9},
    }, coeffs_source="ledger")
    telem = _telemetry({"fwd.sampled_facet_pass": 0.3,
                        "fwd.slab_step": 0.1, "fwd.column_pass": 0.1,
                        "bwd.sampled_fold": 0.5})
    manifest = {"device": {"platform": "cpu"}, "git_sha": "abc"}
    got = oledger.plan_accuracy_block(plan, telem, manifest)
    want = jledger.plan_accuracy_block(plan, telem, manifest)
    for key in ("stages", "uncovered", "coverage", "predicted_stage_wall_s",
                "measured_stage_wall_s", "platform", "coeffs_source"):
        assert got[key] == want[key], key
    assert oledger.mispriced_stages(got) == jledger.mispriced_stages(want)
    assert oledger.mispricing_drift(got) == jledger.mispricing_drift(want)
    assert validate_plan_accuracy_artifact(got) == \
        jledger.validate_plan_accuracy_artifact(want) == []


def test_stage_tables_keep_the_jax_names_the_port_times():
    """Every JAX-package table entry whose timer the port emits keeps its
    name and timers; B1's priced stages carry the port's ``.kernel``
    names in place of ``.pallas``."""
    jledger = _jax_ledger()
    found = _port_stage_sites()
    for key, timers in jledger.PLAN_STAGE_TIMERS.items():
        if key.endswith(".pallas"):
            assert key not in oledger.PLAN_STAGE_TIMERS
            port_key = key.replace(".pallas", ".kernel")
            assert set(oledger.PLAN_STAGE_TIMERS[port_key]) <= found
            continue
        assert oledger.PLAN_STAGE_TIMERS[key] == timers
    for name in jledger.EXEMPT_STAGE_TIMERS:
        if name in found:
            assert name in oledger.EXEMPT_STAGE_TIMERS
