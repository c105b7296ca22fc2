"""The port's process fleet (``swiftly_tpu_torch.serve.procfleet``) and
``SpillCache.export_manifest``, against the JAX package's
``tests/test_procfleet.py`` and the JAX package itself.

The 22 test functions of ``tests/test_procfleet.py`` (with their
parametrised cases) run against the port's module and the port's
`obs.validate_procfleet_artifact`: the shared-L2 reader's gates, the
atomic stream state, the dwell knob, startup hygiene against orphans and
stale sockets (with the port's marker), the worker spec, the artifact
schema, telemetry folding with the retired-generation ledger, the black
box and the HELLO clock offsets. Then the port's own contracts:
``export_manifest`` refuses an incomplete, RAM-only or mid-patch cache,
forces RAM entries to disk (counters move), and its rows read through
`SharedSpillReader` are bit-equal to the cache's ``get_row``, with the
JAX package's keys and entry order for the same puts; results cross the
wire as host numpy; a worker that cannot get the card fails its boot and
``start`` raises (no CPU fallback); and one real fleet on the CPU: 2
worker processes (``device="cpu"``) at ``1k[1]-n512-256`` over an
exported recording, 16 zipf requests a window, a mid-burst SIGKILL, a
restart and a mid-L2-read kill, with zero requests lost, cache rows
bit-equal to the recording, computed rows bit-equal to the port's
in-process ``get_subgrid_task`` and within 1e-5 relative L2 of the JAX
package's (the sum-reorder bound of ``tests/test_pallas.py``), in under
120 s of wall.
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import swiftly_tpu_torch as T
from swiftly_tpu_torch.obs import validate_procfleet_artifact
from swiftly_tpu_torch.obs.recorder import FlightRecorder
from swiftly_tpu_torch.resilience import faults
from swiftly_tpu_torch.serve import procfleet
from swiftly_tpu_torch.serve.procfleet import (
    ProcessFleet,
    SharedSpillReader,
    _WorkerBlackBox,
    blackbox_index_path,
    exhume_blackbox,
    make_worker_spec,
    write_stream_state,
)
from swiftly_tpu_torch.utils.spill import SpillCache

DEAD_PID = 2 ** 22 + 12345  # far above any default pid_max allocation


# ---------------------------------------------------------------------------
# shared L2 reader gates
# ---------------------------------------------------------------------------


@pytest.fixture
def manifest(tmp_path):
    rows = np.arange(32, dtype=np.complex64).reshape(4, 8)
    entry = tmp_path / "entry-0.npy"
    np.save(entry, rows)
    return {
        "entries": [str(entry)],
        "meta": [{"shape": (4, 8)}],
        "stream_version": 3,
    }


def test_reader_gates_track_state_file(manifest, tmp_path):
    state = tmp_path / "stream_state.json"
    reader = SharedSpillReader(manifest, str(state))

    # no state file yet: refuse (the feed recomputes, never serves)
    assert reader.complete is False
    assert reader.patching is True
    assert reader.stream_version == -1

    write_stream_state(str(state), stream_version=3)
    assert reader.complete is True
    assert reader.patching is False
    assert reader.stream_version == 3

    # the parent starts a patch: the SAME reader object sees it flip
    write_stream_state(str(state), stream_version=3, patching=True)
    assert reader.patching is True

    # a new stream version invalidates without any worker-side action
    write_stream_state(str(state), stream_version=4)
    assert reader.stream_version == 4


def test_reader_refuses_torn_state_file(manifest, tmp_path):
    state = tmp_path / "stream_state.json"
    state.write_text('{"stream_version": 3, "comp')  # torn mid-write
    reader = SharedSpillReader(manifest, str(state))
    assert reader.complete is False
    assert reader.patching is True
    assert reader.stream_version == -1


def test_reader_get_row_bit_identical(manifest, tmp_path):
    state = tmp_path / "stream_state.json"
    write_stream_state(str(state), stream_version=3)
    reader = SharedSpillReader(manifest, str(state))
    assert len(reader) == 1
    assert reader.meta(0) == {"shape": (4, 8)}
    expect = np.arange(32, dtype=np.complex64).reshape(4, 8)[2]
    got = reader.get_row(0, 2)
    assert np.array_equal(got, expect)
    assert reader.rows_read == 1


def test_reader_dwell_writes_flag(manifest, tmp_path):
    state = tmp_path / "stream_state.json"
    write_stream_state(str(state), stream_version=3)
    flag = tmp_path / "dwell.flag"
    reader = SharedSpillReader(manifest, str(state),
                               dwell_flag_path=str(flag))
    reader.dwell_s = 0.05
    t0 = time.monotonic()
    reader.get_row(0, 1)
    assert time.monotonic() - t0 >= 0.05
    assert flag.read_text() == str(os.getpid())


def test_write_stream_state_atomic(tmp_path):
    state = tmp_path / "stream_state.json"
    write_stream_state(str(state), stream_version=7, complete=False,
                       patching=True)
    assert json.loads(state.read_text()) == {
        "stream_version": 7, "complete": False, "patching": True}
    # no tmp sibling survives the rename
    assert os.listdir(tmp_path) == ["stream_state.json"]


# ---------------------------------------------------------------------------
# worker spec
# ---------------------------------------------------------------------------


def test_make_worker_spec_picklable_and_typed():
    spec = make_worker_spec(
        {"N": 512, "yB_size": 256}, [(1.0, 3, 4)],
        max_depth="128", max_batch=8.0, lease_interval_s="0.05")
    assert spec["params"] == {"N": 512, "yB_size": 256}
    assert spec["device"] == "cuda"  # the card unless the caller asks
    assert spec["sources"] == [(1.0, 3, 4)]
    assert spec["max_depth"] == 128
    assert spec["max_batch"] == 8
    assert spec["lease_interval_s"] == 0.05
    assert spec["stream"] is None
    # crosses the process boundary as-is
    assert pickle.loads(pickle.dumps(spec)) == spec


# ---------------------------------------------------------------------------
# pid helpers + startup hygiene
# ---------------------------------------------------------------------------


def test_pid_alive():
    assert procfleet._pid_alive(os.getpid())
    assert not procfleet._pid_alive(DEAD_PID)


def test_cmdline_matches_requires_marker_and_worker_flag():
    # this test process is python -m pytest: no marker, no --worker
    assert not procfleet._cmdline_matches(os.getpid())
    assert not procfleet._cmdline_matches(DEAD_PID)


def _decoy_worker():
    """A live process whose cmdline carries the worker marker — what a
    real orphaned worker looks like to the sweep (recycled-pid-safe:
    the marker is verified before any signal). Waits until the child
    has exec'd: between fork and exec /proc/<pid>/cmdline still shows
    the PARENT's argv, and a sweep racing that window would (rightly)
    refuse to signal the unmarked pid."""
    decoy = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(600)",
         procfleet.WORKER_MARKER, "--worker"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 10.0
    while not procfleet._cmdline_matches(decoy.pid):
        if time.monotonic() > deadline:  # pragma: no cover - diagnostics
            decoy.kill()
            raise RuntimeError("decoy worker never exec'd")
        time.sleep(0.01)
    return decoy


def test_sweep_reaps_orphans_and_stale_sockets(tmp_path):
    run_root = tmp_path / "procfleet"
    stale = run_root / "run-crashed"
    stale.mkdir(parents=True)
    (stale / "fleet.pid").write_text(str(DEAD_PID))  # owner is dead
    (stale / "worker-0.g1.sock").write_text("")
    (stale / "worker-1.g1.sock").write_text("")
    decoy = _decoy_worker()
    (stale / "worker-0.pid").write_text(str(decoy.pid))
    (stale / "worker-1.pid").write_text(str(DEAD_PID))  # already gone

    fleet = ProcessFleet(make_worker_spec({}, []), 2,
                         run_root=str(run_root))
    try:
        fleet._sweep_stale_runs()
    finally:
        if decoy.poll() is None:
            decoy.kill()
    assert decoy.wait(10) == -signal.SIGKILL
    assert fleet.counts["orphans_reaped"] == 1
    assert fleet.counts["stale_sockets_swept"] == 2
    assert not stale.exists()


def test_sweep_leaves_live_fleet_alone(tmp_path):
    run_root = tmp_path / "procfleet"
    live = run_root / "run-live"
    live.mkdir(parents=True)
    (live / "fleet.pid").write_text(str(os.getpid()))  # owner: us, alive
    (live / "worker-0.g1.sock").write_text("")
    decoy = _decoy_worker()
    (live / "worker-0.pid").write_text(str(decoy.pid))

    fleet = ProcessFleet(make_worker_spec({}, []), 2,
                         run_root=str(run_root))
    try:
        fleet._sweep_stale_runs()
        assert decoy.poll() is None  # NOT killed: the dir has an owner
    finally:
        decoy.kill()
        decoy.wait(10)
    assert fleet.counts["orphans_reaped"] == 0
    assert fleet.counts["stale_sockets_swept"] == 0
    assert (live / "worker-0.g1.sock").exists()


def test_sweep_never_signals_unmarked_pid(tmp_path):
    # a recycled pid (alive, but NOT a worker cmdline) must not be
    # signalled: fabricate a stale dir pointing at a plain sleeper
    run_root = tmp_path / "procfleet"
    stale = run_root / "run-crashed"
    stale.mkdir(parents=True)
    (stale / "fleet.pid").write_text(str(DEAD_PID))
    bystander = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(600)"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    (stale / "worker-0.pid").write_text(str(bystander.pid))

    fleet = ProcessFleet(make_worker_spec({}, []), 2,
                         run_root=str(run_root))
    try:
        fleet._sweep_stale_runs()
        assert bystander.poll() is None  # still running: marker mismatch
    finally:
        bystander.kill()
        bystander.wait(10)
    assert fleet.counts["orphans_reaped"] == 0


# ---------------------------------------------------------------------------
# artifact schema
# ---------------------------------------------------------------------------


def _healthy_record():
    return {
        "metric": "procfleet_drill_wall",
        "value": 4.2,
        "unit": "s",
        "p50_ms": 20.0,
        "p99_ms": 80.0,
        "throughput_rps": 12.0,
        "n_requests": 48,
        "n_served": 48,
        "bit_identical": {"checked": 48, "mismatches": 0},
        "procfleet": {
            "n_workers": 2,
            "worker_deaths": 2,
            "restarts": 2,
            "failovers": 3,
            "lost_requests": 0,
            "failover_ms": 13.5,
            "breaker_cycle": ["open", "half_open", "closed"],
            "per_worker": [
                {"id": 0, "served": 25, "qps": 6.0,
                 "last_stats": {"beats": 120, "served": 25,
                                "pending": 0}},
                {"id": 1, "served": 23, "qps": 5.5,
                 "last_stats": None},  # never beat: no payload yet
            ],
            "health_transitions": [
                {"t": 1.0, "owner": 1, "from": "live", "to": "revoked",
                 "via": "missed"},
            ],
            "orphans": {"orphans_reaped": 1, "stale_sockets_swept": 1},
            "mid_l2_kill": {"killed_mid_read": True,
                            "row_bit_identical": True},
            "wire": {"heartbeats": 120},
            "telemetry": {"frames": 240, "zombie_frames": 1,
                          "coverage": 0.97,
                          "retired_generations": 2},
            "clock_offsets": {
                "0": {"offset_s": 0.0012, "rtt_s": 0.0004,
                      "pid": 1001, "generation": 2},
                "1": {"offset_s": -0.0009, "rtt_s": 0.0003,
                      "pid": 1002, "generation": 2},
            },
            "trace_merge": {"n_processes": 3,
                            "pids": [1000, 1001, 1002],
                            "cross_process_requests": 48},
            "black_box": {
                "exhumed": [{"rid": 0, "generation": 1,
                             "n_events": 40, "torn_index": False}],
                "victim_events_in_post_mortem": True,
            },
        },
        "fleet_telemetry": {
            "n_sources": 3,
            "sources": {
                "router": {"kind": "router",
                           "counters": {"proc.router.requests": 48}},
                "worker-0": {
                    "kind": "worker",
                    "counters": {"proc.served": 25},
                    "stages": {"serve.batch": {"count": 5,
                                               "total_s": 0.5}}},
                "worker-1": {
                    "kind": "worker",
                    "counters": {"proc.served": 23},
                    "stages": {"serve.batch": {"count": 4,
                                               "total_s": 0.4}}},
            },
            "totals": {
                "counters": {"proc.router.requests": 48,
                             "proc.served": 48},
                "stages": {"serve.batch": {"count": 9,
                                           "total_s": 0.9}},
            },
        },
        "manifest": {
            "schema": None,
            "timestamp_utc": "2026-01-01T00:00:00Z",
            "device": {"platform": "cpu"},
            "git_sha": "deadbeef",
            "env": {},
            "baseline_source": "none",
        },
    }


def test_validate_procfleet_artifact_healthy():
    assert validate_procfleet_artifact(_healthy_record()) == []


@pytest.mark.parametrize("doctor,needle", [
    (lambda r: r["procfleet"].__setitem__("lost_requests", 1),
     "lost_requests"),
    (lambda r: r["procfleet"].__setitem__("worker_deaths", 0),
     "killed no worker"),
    (lambda r: r["procfleet"].__setitem__("restarts", 0),
     "restarted no worker"),
    (lambda r: r["procfleet"].__setitem__("n_workers", 1),
     "cannot fail over"),
    (lambda r: r["procfleet"].__setitem__(
        "breaker_cycle", ["open", "half_open"]), "breaker cycle"),
    (lambda r: r["procfleet"].__setitem__("failover_ms", None),
     "failover_ms"),
    (lambda r: r["procfleet"].pop("mid_l2_kill"), "mid_l2_kill"),
    (lambda r: r["procfleet"]["mid_l2_kill"].__setitem__(
        "killed_mid_read", False), "never landed its kill"),
    (lambda r: r["procfleet"]["mid_l2_kill"].__setitem__(
        "row_bit_identical", False), "torn or stale row"),
    (lambda r: r["procfleet"].__setitem__("wire", {"heartbeats": 0}),
     "heartbeats"),
    (lambda r: r["procfleet"]["per_worker"].pop(),
     "per_worker"),
    (lambda r: r["bit_identical"].__setitem__("mismatches", 3),
     "bit-identity audit failed"),
    (lambda r: r.__setitem__("p99_ms", 1.0), "p99_ms"),
    (lambda r: r.pop("procfleet"), "missing procfleet block"),
    # -- distributed observability plane trips --------------------------
    (lambda r: r.pop("fleet_telemetry"),
     "cross-process telemetry plane"),
    (lambda r: r["fleet_telemetry"]["totals"]["counters"].__setitem__(
        "proc.served", 47), "per-source sum"),
    (lambda r: r["procfleet"]["per_worker"][0].__setitem__(
        "last_stats", "garbage"), "expected a heartbeat dict"),
    (lambda r: r["procfleet"]["per_worker"][0].__setitem__(
        "last_stats", {"beats": -1, "served": 25, "pending": 0}),
     "is not a counter"),
    (lambda r: r["procfleet"]["telemetry"].__setitem__("frames", 0),
     "no TELEMETRY frame"),
    (lambda r: r["procfleet"]["telemetry"].__setitem__(
        "coverage", 1.5), "not in [0, 1]"),
    (lambda r: r["procfleet"].__setitem__("clock_offsets", {}),
     "clock_offsets is empty"),
    (lambda r: r["procfleet"]["clock_offsets"]["0"].__setitem__(
        "rtt_s", -0.1), "non-negative uncertainty"),
    (lambda r: r["procfleet"]["trace_merge"].__setitem__(
        "n_processes", 1), "not a merged timeline"),
    (lambda r: r["procfleet"]["trace_merge"].__setitem__(
        "cross_process_requests", 0), "crossed a process boundary"),
    (lambda r: r["procfleet"]["black_box"].__setitem__("exhumed", []),
     "black_box.exhumed is empty"),
    (lambda r: r["procfleet"]["black_box"].__setitem__(
        "victim_events_in_post_mortem", False),
     "never reached the parent's post-mortem"),
])
def test_validate_procfleet_artifact_trips(doctor, needle):
    record = _healthy_record()
    doctor(record)
    problems = validate_procfleet_artifact(record)
    assert problems, f"doctored record passed: {needle}"
    assert any(needle in p for p in problems), problems


# ---------------------------------------------------------------------------
# wire telemetry: frame folding, zombie gate, retired ledger
# ---------------------------------------------------------------------------


def _bare_fleet(tmp_path, n=2):
    """A fleet with hand-built worker slots and NO processes — the
    telemetry fold/retire path needs only the parent-side ledger."""
    fleet = ProcessFleet(make_worker_spec({}, []), n,
                         run_root=str(tmp_path / "procfleet"))
    for rid in range(n):
        w = procfleet._Worker(rid)
        w.generation = 1
        w.dead = False
        fleet._workers[rid] = w
    return fleet


def _snap(generation, counters, stages=None, **extra):
    return {"rid": 0, "pid": 4242, "generation": generation,
            "beats": 10, "served": 5, "pending": 0,
            "counters": dict(counters), "stages": dict(stages or {}),
            **extra}


def test_on_telemetry_folds_live_generation(tmp_path):
    fleet = _bare_fleet(tmp_path)
    w = fleet.worker(0)
    fleet._on_telemetry(w, w.generation,
                        _snap(w.generation, {"proc.served": 5}), 1.0)
    assert fleet.counts["telemetry_frames"] == 1
    assert fleet.counts["telemetry_zombie"] == 0
    assert w.telemetry_frames == 1
    assert w.telemetry["counters"] == {"proc.served": 5}
    src = fleet._worker_source(0)
    assert src["counters"]["proc.served"] == 5
    assert src["alive"] is True


def test_on_telemetry_gates_zombie_generation(tmp_path):
    # a snapshot from a generation the slot no longer runs (or stamped
    # with the wrong generation) is COUNTED and IGNORED — zombie
    # frames must never pollute the live slot's telemetry
    fleet = _bare_fleet(tmp_path)
    w = fleet.worker(0)
    w.generation = 2
    fleet._on_telemetry(w, 1, _snap(1, {"proc.served": 99}), 1.0)
    fleet._on_telemetry(w, 2, _snap(1, {"proc.served": 99}), 1.0)
    fleet._on_telemetry(w, 2, "not-a-dict", 1.0)
    assert fleet.counts["telemetry_frames"] == 3
    assert fleet.counts["telemetry_zombie"] == 3
    assert w.telemetry is None and w.telemetry_frames == 0
    fleet._on_telemetry(w, 2, _snap(2, {"proc.served": 7}), 2.0)
    assert fleet.counts["telemetry_zombie"] == 3
    assert fleet._worker_source(0)["counters"]["proc.served"] == 7


def test_retired_ledger_keeps_totals_monotone_across_failover(tmp_path):
    # the drop_view discipline: a dead generation's counters fold into
    # the retired ledger, so the slot's summed source never regresses
    # when the restarted generation reports from zero
    fleet = _bare_fleet(tmp_path)
    w = fleet.worker(0)
    fleet._on_telemetry(
        w, w.generation,
        _snap(w.generation, {"proc.served": 20},
              {"serve.batch": {"count": 4, "total_s": 0.4}}), 1.0)
    before = fleet._worker_source(0)
    assert before["counters"]["proc.served"] == 20
    with fleet._lock:
        fleet._retire_telemetry(w)
    retired = fleet._worker_source(0)
    assert retired["counters"]["proc.served"] == 20
    assert retired["retired_generations"] == 1
    # the restarted generation starts over; the sum only grows
    w.generation = 2
    fleet._on_telemetry(
        w, 2, _snap(2, {"proc.served": 3},
                    {"serve.batch": {"count": 1, "total_s": 0.1}}), 2.0)
    after = fleet._worker_source(0)
    assert after["counters"]["proc.served"] == 23
    assert after["stages"]["serve.batch"]["count"] == 5
    assert abs(after["stages"]["serve.batch"]["total_s"] - 0.5) < 1e-9


def test_telemetry_coverage_ratio(tmp_path):
    fleet = _bare_fleet(tmp_path)
    w0, w1 = fleet.worker(0), fleet.worker(1)
    assert fleet.telemetry_coverage(now=0.0) is None  # nothing live yet
    w0.live_s = 6.0
    w0.telemetry_covered_s = 5.4
    w1.live_s = 4.0
    w1.telemetry_covered_s = 3.6
    assert abs(fleet.telemetry_coverage(now=0.0) - 0.9) < 1e-9
    w1.telemetry_covered_s = 100.0  # clamped, never > 1
    assert fleet.telemetry_coverage(now=0.0) == 1.0


# ---------------------------------------------------------------------------
# black box: crash-safe persistence + exhumation
# ---------------------------------------------------------------------------


def test_blackbox_flush_publishes_ring_and_index(tmp_path):
    rec = FlightRecorder(enabled=True)
    box = _WorkerBlackBox(str(tmp_path), 0, 1, rec)
    rec.record("proc", "proc.request", "req_id=1")
    rec.record("proc", "proc.l2_dwell", "entry=0 dwell_s=1.5")
    assert box.flush() == 2
    assert box.flush() == 0  # watermark: nothing re-emitted
    rec.record("proc", "proc.request", "req_id=2")
    assert box.flush() == 1
    box.close()
    idx = json.loads(
        (tmp_path / os.path.basename(
            blackbox_index_path(str(tmp_path), 0))).read_text())
    assert idx["generation"] == 1 and idx["n_events"] == 3
    dug = exhume_blackbox(str(tmp_path), 0)
    assert dug["n_events"] == 3 and dug["torn_index"] is False
    assert [e["name"] for e in dug["events"]] == [
        "proc.request", "proc.l2_dwell", "proc.request"]
    # no tmp droppings from the atomic index publish
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_exhume_skips_torn_trailing_line(tmp_path):
    rec = FlightRecorder(enabled=True)
    box = _WorkerBlackBox(str(tmp_path), 0, 1, rec)
    rec.record("proc", "proc.request", "req_id=1")
    box.flush()
    box.close()
    # the write SIGKILL interrupted: half a JSON line at the tail
    with open(tmp_path / "blackbox-0.g1.jsonl", "a") as fh:
        fh.write('{"t": 1.0, "kind": "proc", "na')
    dug = exhume_blackbox(str(tmp_path), 0)
    assert dug["n_events"] == 1  # intact prefix only
    assert dug["events"][0]["name"] == "proc.request"


def test_exhume_torn_index_falls_back_to_generation_scan(tmp_path):
    # generation 2 persisted events, then died mid-index-publish in a
    # way that left a torn index: exhumation must fall back to the
    # newest generation file that replays
    rec = FlightRecorder(enabled=True)
    box = _WorkerBlackBox(str(tmp_path), 3, 2, rec)
    rec.record("proc", "proc.worker_death", "rid=3")
    box.flush()
    box.close()
    with open(blackbox_index_path(str(tmp_path), 3), "w") as fh:
        fh.write('{"rid": 3, "generation"')  # torn index
    dug = exhume_blackbox(str(tmp_path), 3, max_generation=2)
    assert dug["torn_index"] is True
    assert dug["generation"] == 2
    assert dug["n_events"] == 1
    assert exhume_blackbox(str(tmp_path), 7) is None  # nothing left


# ---------------------------------------------------------------------------
# clock offsets: NTP-style HELLO estimate
# ---------------------------------------------------------------------------


def test_clock_offset_from_hello_bounds():
    est = ProcessFleet._clock_offset_from_hello(
        10.0, 10.004, {"t_epoch": 10.502})
    assert abs(est["rtt_s"] - 0.004) < 1e-12
    assert abs(est["offset_s"] - 0.5) < est["rtt_s"] / 2 + 1e-9
    assert ProcessFleet._clock_offset_from_hello(
        10.0, 10.004, {"t_epoch": "soon"}) is None
    assert ProcessFleet._clock_offset_from_hello(10.0, 10.004, None) is None


def test_clock_offset_sane_under_injected_hello_latency():
    # slow the HELLO round trip through the proc.spawn fault site: the
    # estimate must still land within the +-rtt/2 bound it advertises,
    # and the recorded rtt must own the injected delay
    true_skew = 0.25
    delay = 0.05
    faults.install(faults.FaultPlan([
        {"site": "proc.spawn", "kind": "latency", "every": 1,
         "delay_s": delay},
    ]))
    try:
        t_send = time.time()
        faults.fault_point("proc.spawn")  # the wire stalls mid-HELLO
        t_worker = time.time() + true_skew
        faults.fault_point("proc.spawn")  # ...and again on the reply
        t_recv = time.time()
    finally:
        faults.uninstall()
    est = ProcessFleet._clock_offset_from_hello(
        t_send, t_recv, {"t_epoch": t_worker, "pid": 4242})
    assert est["rtt_s"] >= 2 * delay
    assert abs(est["offset_s"] - true_skew) <= est["rtt_s"] / 2 + 0.01


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------


def test_port_names_stay_off_the_jax_packages():
    from swiftly_tpu.serve import procfleet as jax_procfleet

    assert procfleet.WORKER_MARKER == "swiftly_tpu_torch.serve.procfleet"
    assert procfleet.fleet_run_root() != jax_procfleet.fleet_run_root()
    assert os.path.basename(procfleet.fleet_run_root()) == (
        "swiftly_procfleet_torch")
    # neither marker matches the other package's worker cmdline
    assert procfleet.WORKER_MARKER not in jax_procfleet.WORKER_MARKER
    assert jax_procfleet.WORKER_MARKER not in procfleet.WORKER_MARKER


def _filled(spill, rng, n=3):
    spill.begin_fill(tag="t")
    arrays = []
    for k in range(n):
        a = rng.standard_normal((2, 3, 4, 4, 2)).astype(np.float32)
        spill.put([[(k, ("col", k, s)) for s in range(3)]] * 2, a)
        arrays.append(a)
    spill.end_fill()
    return arrays


def test_export_manifest_refuses_incomplete_ramonly_and_midpatch(tmp_path):
    rng = np.random.default_rng(0)
    spill = SpillCache(spill_dir=str(tmp_path))
    spill.begin_fill()
    spill.put([], np.zeros((2, 2), np.float32))
    with pytest.raises(RuntimeError, match="complete"):
        spill.export_manifest()  # the fill is still open
    ram_only = SpillCache(spill_dir=None)
    monkey_env = os.environ.pop("SWIFTLY_SPILL_DIR", None)
    try:
        ram_only = SpillCache(spill_dir=None)
    finally:
        if monkey_env is not None:
            os.environ["SWIFTLY_SPILL_DIR"] = monkey_env
    _filled(ram_only, rng)
    with pytest.raises(RuntimeError, match="disk-backed"):
        ram_only.export_manifest()
    patching = SpillCache(spill_dir=str(tmp_path))
    _filled(patching, rng)
    patching.begin_patch()
    with pytest.raises(RuntimeError, match="mid-patch"):
        patching.export_manifest()
    patching.end_patch()
    assert patching.export_manifest()["entries"]


def test_export_manifest_forces_ram_entries_to_disk(tmp_path):
    from swiftly_tpu_torch.obs import metrics

    rng = np.random.default_rng(1)
    # budget for one entry in RAM: the others spill at put time
    spill = SpillCache(budget_bytes=2 * 3 * 4 * 4 * 2 * 4 * 1.5,
                       spill_dir=str(tmp_path))
    arrays = _filled(spill, rng)
    assert spill.stats()["ram_bytes"] > 0
    metrics.enable()
    metrics.reset()
    try:
        manifest = spill.export_manifest()
        exports = metrics.export()["counters"].get("spill.manifest_exports")
    finally:
        metrics.disable()
    assert exports == 1
    st = spill.stats()
    assert st["exported_entries"] == 1
    assert st["ram_bytes"] == 0
    assert st["disk_bytes"] == sum(a.nbytes for a in arrays)
    assert set(manifest) == {"dir", "entries", "meta", "stream_version"}
    assert all(os.path.isfile(p) and p.startswith(manifest["dir"])
               for p in manifest["entries"])
    assert not [f for f in os.listdir(manifest["dir"]) if ".tmp" in f]
    # the state file a fleet publishes; each row bit-equal to get_row
    state = tmp_path / "stream_state.json"
    write_stream_state(str(state), stream_version=manifest["stream_version"])
    reader = SharedSpillReader(manifest, str(state))
    assert len(reader) == len(spill)
    for k in range(len(spill)):
        assert reader.meta(k) == spill.meta(k)
        for index in ((0, 0), (1, 2), (0, 1)):
            got, want = reader.get_row(k, index), spill.get_row(k, index)
            assert got.dtype == want.dtype
            assert got.tobytes() == want.tobytes()


def test_export_manifest_matches_the_jax_packages(tmp_path):
    from swiftly_tpu.utils.spill import SpillCache as JaxSpillCache

    manifests = []
    for cls, sub in ((SpillCache, "port"), (JaxSpillCache, "jax")):
        rng = np.random.default_rng(2)
        spill = cls(budget_bytes=1e9, spill_dir=str(tmp_path / sub))
        _filled(spill, rng, n=4)
        manifests.append((spill, spill.export_manifest()))
    (port, pm), (ref, jm) = manifests
    assert list(pm) == list(jm)
    assert [os.path.basename(p) for p in pm["entries"]] == [
        os.path.basename(p) for p in jm["entries"]]
    assert pm["meta"] == jm["meta"]
    assert pm["stream_version"] == jm["stream_version"]
    assert port.stats()["exported_entries"] == ref.stats()[
        "exported_entries"] == 4
    for a, b in zip(pm["entries"], jm["entries"]):
        assert np.load(a).tobytes() == np.load(b).tobytes()


def test_result_payload_is_host_numpy():
    from swiftly_tpu_torch.serve.queue import STATUS_OK, RequestResult

    data = torch.arange(8, dtype=torch.float32).reshape(2, 2, 2)
    payload = procfleet._result_payload(
        5, RequestResult(STATUS_OK, data=data, path="coalesced"))
    assert isinstance(payload["data"], np.ndarray)
    assert payload["data"].tobytes() == data.numpy().tobytes()
    assert payload["req_id"] == 5 and payload["path"] == "coalesced"
    # nothing torch crosses the wire
    blob = pickle.dumps(payload)
    assert b"torch" not in blob
    empty = procfleet._result_payload(
        6, RequestResult("shed", shed_reason="depth"))
    assert empty["data"] is None


def test_heartbeat_reads_the_fleets_fields(tmp_path):
    from swiftly_tpu_torch.obs.heartbeat import Heartbeat
    from swiftly_tpu_torch.obs.tower import ControlTower

    fleet = _bare_fleet(tmp_path, n=3)
    fleet.worker(2).dead = True
    fleet.worker(1).generation = 2
    assert fleet.heartbeat_fields() == {
        "proc_workers": 2, "worker_generations": 4,
        "proc_open_alerts": None}
    fleet.register_tower(ControlTower())
    assert fleet.heartbeat_fields()["proc_open_alerts"] == 0
    lines = []

    class _Log:
        def info(self, *args):
            lines.append(args)

    hb = Heartbeat(total=4, label="requests", log=_Log(), procfleet=fleet)
    hb.update(2)
    hb.finish()
    assert len(lines) == 2


def test_worker_without_the_card_fails_its_boot(tmp_path, monkeypatch):
    """A worker asked for the card on a host without one raises at boot;
    the parent reports the failed boot (no CPU fallback)."""
    if torch.cuda.is_available():  # pragma: no cover - CPU-only check
        pytest.skip("this host has a card: the boot would succeed")
    from swiftly_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "build_all", lambda names: {})
    spec = make_worker_spec(T.SWIFT_CONFIGS["1k[1]-n512-256"], SOURCES)
    assert spec["device"] == "cuda"
    fleet = ProcessFleet(spec, 1, run_root=str(tmp_path / "pf"),
                         boot_deadline_s=60.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not boot") as info:
        fleet.start()
    assert "CUDA is not available" in str(info.value)
    assert time.monotonic() - t0 < 60.0  # reported when the worker exited
    assert fleet.worker(0).proc.poll() is not None
    assert not os.path.exists(fleet.run_dir)


# ---------------------------------------------------------------------------
# one real fleet on the CPU
# ---------------------------------------------------------------------------

CONFIG = "1k[1]-n512-256"
SOURCES = [(1, 1, 0), (0.5, -30, 40)]
WINDOW = 16
REL_L2 = 1e-5


def _zipf(sgcs, n, seed, s=1.1):
    """`bench.py:1315`'s zipf-over-columns draw: [configs], hot off0."""
    rng = np.random.default_rng(seed)
    cols = sorted({sg.off0 for sg in sgcs})
    by_col = {}
    for sg in sgcs:
        by_col.setdefault(sg.off0, []).append(sg)
    order = rng.permutation(len(cols))
    ranks = np.empty(len(cols), dtype=int)
    ranks[order] = np.arange(len(cols))
    p = 1.0 / (ranks + 1.0) ** s
    p /= p.sum()
    picks = rng.choice(len(cols), size=n, p=p)
    reqs = [by_col[cols[c]][rng.integers(len(by_col[cols[c]]))]
            for c in picks]
    return reqs, cols[int(np.argmax(p))]


def _preferred(off0, n):
    from swiftly_tpu_torch.serve.fleet import _rendezvous_score

    return max(range(n), key=lambda r: _rendezvous_score(off0, r))


def _wait(cond, timeout_s):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


def _jax_rows(configs):
    """The JAX package's planar f32 ``get_subgrid_task`` of each config
    (complex numpy), same parameters and sources."""
    import jax.numpy as jnp

    import swiftly_tpu as J

    cfg = J.SwiftlyConfig(backend="planar", dtype=jnp.float32,
                          **T.SWIFT_CONFIGS[CONFIG])
    tasks = [(fc, J.make_facet(cfg.image_size, fc, SOURCES))
             for fc in J.make_full_facet_cover(cfg)]
    fwd = J.SwiftlyForward(cfg, tasks, lru_forward=2, queue_size=64)
    cover = {(sg.off0, sg.off1): sg for sg in J.make_full_subgrid_cover(cfg)}
    out = {}
    for sg in configs:
        d = np.asarray(fwd.get_subgrid_task(cover[(sg.off0, sg.off1)]))
        out[(sg.off0, sg.off1)] = d[..., 0] + 1j * d[..., 1]
    return out


def _rel_l2(a, b):
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(b.ravel()), 1e-300))


def test_real_fleet_on_the_cpu(tmp_path, monkeypatch):
    t_test = time.monotonic()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the workers inherit it
    from swiftly_tpu_torch.delta import IncrementalForward

    params = dict(T.SWIFT_CONFIGS[CONFIG])
    cfg = T.SwiftlyConfig(backend="planar", dtype=torch.float32,
                          device="cpu", **params)
    sgcs = T.make_full_subgrid_cover(cfg)
    spec = make_worker_spec(params, SOURCES, max_depth=256, max_batch=16,
                            device="cpu")
    tasks = procfleet._worker_facet_tasks(cfg, spec)
    spill = SpillCache(spill_dir=str(tmp_path / "spill"))
    engine = IncrementalForward(cfg, tasks, spill)
    engine.record(sgcs)

    # the wreckage of a crashed fleet: a dead owner, a stale socket and a
    # live decoy carrying the marker
    run_root = tmp_path / "pf"
    stale = run_root / "run-stale-crashed"
    stale.mkdir(parents=True)
    (stale / "fleet.pid").write_text(str(DEAD_PID))
    (stale / "worker-0.g1.sock").write_text("")
    decoy = _decoy_worker()
    (stale / "worker-0.pid").write_text(str(decoy.pid))

    fleet = ProcessFleet(
        spec, 2, stream_spill=spill, run_root=str(run_root),
        # a 1 s silence revokes: CPU workers share a loaded test host
        lease_interval_s=0.1, miss_suspect=3, miss_revoke=10,
        breaker_threshold=3, breaker_reopen_s=0.3,
        breaker_max_reopen_s=4.0, half_open_probes=2,
        restart_backoff_s=0.2, restart_backoff_max_s=2.0,
        boot_deadline_s=60.0)
    workload, hot = _zipf(sgcs, WINDOW, 1234)
    tracked = []

    def window(reqs):
        frs = [fleet.submit(sg, priority=1) for sg in reqs]
        tracked.extend(zip(reqs, frs))
        assert fleet.drain(timeout_s=30.0)
        return frs

    try:
        fleet.start()
        assert decoy.wait(10) == -signal.SIGKILL
        assert fleet.counts["orphans_reaped"] == 1
        assert fleet.counts["stale_sockets_swept"] == 1
        # before: the L2 gated off (the stream "mid-patch"): compute
        fleet.publish_stream_state(patching=True)
        window(workload)
        # kill: the hot column's preferred worker SIGKILLed mid-burst
        victim = _preferred(hot, 2)
        head = WINDOW // 3
        frs = [fleet.submit(sg, priority=1) for sg in workload[:head]]
        fleet.kill_worker(victim)
        frs += [fleet.submit(sg, priority=1) for sg in workload[head:]]
        tracked.extend(zip(workload, frs))
        assert fleet.drain(timeout_s=30.0)
        fleet.publish_stream_state()
        assert _wait(lambda: fleet.counts["worker_deaths"] >= 1, 15.0)
        # restart: the victim re-earns trust through half-open probes
        assert _wait(lambda: fleet.worker(victim).ready
                     and not fleet.worker(victim).dead
                     and fleet.worker(victim).generation >= 2, 45.0)
        victim_cols = [sg for sg in sgcs
                       if _preferred(sg.off0, 2) == victim]
        i = 0
        deadline = time.monotonic() + 20.0
        while (fleet.worker(victim).breaker.state != "closed"
               and time.monotonic() < deadline):
            window([victim_cols[i % len(victim_cols)]])
            i += 1
            time.sleep(0.02)
        window(workload)
        # mid-L2-read kill of the other worker
        assert fleet.wait_ready(45.0)
        victim2 = 1 - victim
        col2 = next(sg for sg in sgcs if _preferred(sg.off0, 2) == victim2)
        flag = fleet.dwell_flag_path(victim2)
        fleet.set_control(victim2, dwell_l2_s=1.0)
        time.sleep(0.1)
        fr2 = fleet.submit(col2, priority=1)
        tracked.append((col2, fr2))
        assert _wait(lambda: os.path.exists(flag), 20.0)
        fleet.kill_worker(victim2)
        assert fleet.drain(timeout_s=30.0)
        assert _wait(lambda: fleet.counts["blackbox_exhumed"] >= 2, 15.0)
        stats = fleet.stats()
        lost = fleet.lost_requests()
    finally:
        fleet.stop(drain=True)
        if decoy.poll() is None:
            decoy.kill()
    run_dir = fleet.run_dir
    assert not os.path.exists(run_dir)
    assert all(w.proc.poll() is not None for w in fleet._workers.values())

    assert lost == 0 and stats["lost_requests"] == 0
    assert all(fr.result is not None and fr.result.ok for _, fr in tracked)
    assert stats["worker_deaths"] >= 2 and stats["restarts"] >= 1
    cycle = [t["to"] for t in stats["breakers"][victim]["transitions"]]
    assert {"open", "half_open", "closed"} <= set(cycle)
    assert fr2.result.ok
    feed = engine.feed()
    assert np.asarray(fr2.result.data).tobytes() == np.asarray(
        feed.lookup(col2)).tobytes()

    # the audit: cache rows bit-equal to the recording, computed rows
    # bit-equal to the port's in-process get_subgrid_task, every row
    # within 1e-5 relative L2 of the recording's and of the JAX package's
    fwd_ref = T.SwiftlyForward(cfg, tasks, lru_forward=2, queue_size=64)
    paths = {}
    computed = {}
    for sg, fr in tracked:
        res = fr.result
        got = np.asarray(res.data)
        assert isinstance(res.data, np.ndarray)
        rec = np.asarray(feed.lookup(sg))
        paths[res.path] = paths.get(res.path, 0) + 1
        if res.path == "cache":
            assert got.tobytes() == rec.tobytes()
        else:
            want = fwd_ref.get_subgrid_task(sg).numpy()
            assert got.tobytes() == want.tobytes()
            computed[(sg.off0, sg.off1)] = (sg, got)
        assert _rel_l2(got, rec) < REL_L2
    assert paths.get("cache", 0) >= WINDOW and computed, paths
    jax_rows = _jax_rows([sg for sg, _ in computed.values()])
    for key, (_sg, got) in computed.items():
        assert _rel_l2(got[..., 0] + 1j * got[..., 1], jax_rows[key]) < REL_L2
    assert time.monotonic() - t_test < 120.0


@pytest.mark.parametrize("seed", range(6))
def test_worker_facets_are_the_jax_packages(seed):
    """The workers rebuild their facets with the port's ``make_facet``,
    which scales only the pixels a source was placed on: byte-equal to
    the JAX package's oracle, duplicated and cancelling sources, masks
    and 1D facets included."""
    from swiftly_tpu.ops.oracle import make_facet_from_sources as jax_facet
    from swiftly_tpu_torch.ops.oracle import make_facet_from_sources

    rng = np.random.default_rng(seed)
    for _ in range(20):
        size = int(rng.integers(8, 40))
        ndim = int(rng.integers(1, 3))
        sources = [
            (float(rng.choice([1.0, -1.0, 0.5, 0.0])),
             *(int(x) for x in rng.integers(-32, 32, ndim)))
            for _ in range(int(rng.integers(0, 12)))]
        sources += sources[:2]  # duplicates: sums, some to zero
        offs = [int(x) for x in rng.integers(-20, 20, ndim)]
        masks = [rng.random(size) if rng.random() < 0.7 else None
                 for _ in range(ndim)]
        got = make_facet_from_sources(sources, 64, size, offs, masks)
        want = jax_facet(sources, 64, size, offs, masks)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # the workers' tasks at the fleet test's size, against the JAX cover
    import swiftly_tpu as J

    params = T.SWIFT_CONFIGS[CONFIG]
    cfg = T.SwiftlyConfig(backend="planar", device="cpu", **params)
    spec = make_worker_spec(params, SOURCES, device="cpu")
    jcfg = J.SwiftlyConfig(backend="numpy", **params)
    for (fc, task), jfc in zip(procfleet._worker_facet_tasks(cfg, spec),
                               J.make_full_facet_cover(jcfg)):
        assert task().tobytes() == J.make_facet(
            jcfg.image_size, jfc, SOURCES).tobytes()
