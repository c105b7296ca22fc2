"""The port's resilience layer (``swiftly_tpu_torch.resilience``) and its
hooks in the spill cache and the streamed executors, held to the JAX
package's cases (``tests/test_resilience.py:71-399,549-559`` and
``tests/test_fleet.py:91-165`` for the breaker).

Port vs JAX package: the same ``FaultPlan`` spec and seed fire at the same
site calls in both. The port's own contracts: CUDA runtime errors are
never retried; the spill cache's disk cases and the mid-feed fallback to
the forward run on the port's record and replay paths; a kill raised on
a replay worker reaches the consumer and leaves no thread behind; the
wall-clock autosave restores the ``processed`` ledger.

Torch runs on one intra-op thread.
"""

import os
import random
import threading

import numpy as np
import pytest
import torch

import swiftly_tpu_torch as T
from swiftly_tpu_torch.obs import metrics
from swiftly_tpu_torch.resilience import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    CircuitBreaker,
    degrade,
    faults,
)
from swiftly_tpu_torch.resilience.faults import (
    FaultError,
    FaultPlan,
    InjectedResourceExhausted,
    WorkerKilled,
    corrupt_array,
    fault_point,
)
from swiftly_tpu_torch.resilience.retry import (
    backoff_delay,
    is_cuda_error,
    is_oom,
    is_transient,
    retry_transient,
)
from swiftly_tpu_torch.utils.spill import SpillCache

# the executors' cases run at tests/test_obs.py:256's small streamed config
# (5 columns of 5 subgrids, 9 facets of 96), in float64
TEST_PARAMS = {"W": 8.0, "fov": 1.0, "N": 256, "yB_size": 96,
               "yN_size": 128, "xA_size": 56, "xM_size": 64}
SOURCES = [(1.0, 3, -5)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_slate():
    faults.uninstall()
    degrade.reset()
    yield
    faults.uninstall()
    degrade.reset()


@pytest.fixture
def counting():
    metrics.disable()
    metrics.reset()
    metrics.enable()
    yield metrics
    metrics.disable()
    metrics.reset()


def _try_site(site, exc_type=FaultError):
    try:
        fault_point(site)
    except exc_type as exc:
        return exc
    return None


# ---------------------------------------------------------------------------
# fault_point: the clean path and the injection kinds
# ---------------------------------------------------------------------------


def test_fault_point_no_plan_is_identity():
    assert faults.current() is None
    payload = object()
    assert fault_point("spill.read", payload) is payload
    assert fault_point("anything") is None


def test_fault_kinds():
    plan = FaultPlan(faults=[
        {"site": "a", "kind": "ioerror", "at": 0},
        {"site": "b", "kind": "oom", "at": 0},
        {"site": "c", "kind": "kill", "at": 0},
        {"site": "d", "kind": "latency", "at": 0, "delay_s": 0.0},
    ])
    with faults.active(plan):
        with pytest.raises(FaultError):
            fault_point("a")
        with pytest.raises(InjectedResourceExhausted,
                           match="RESOURCE_EXHAUSTED"):
            fault_point("b")
        with pytest.raises(WorkerKilled):
            fault_point("c")
        assert fault_point("d", "x") == "x"
    stats = plan.stats()
    assert stats["total"] == 4
    assert stats["by_kind"] == {"ioerror": 1, "oom": 1, "kill": 1,
                                "latency": 1}


def test_worker_killed_tears_through_exception_handlers():
    assert not issubclass(WorkerKilled, Exception)
    plan = FaultPlan(faults=[{"site": "s", "kind": "kill", "at": 0}])
    with faults.active(plan):
        with pytest.raises(WorkerKilled):
            try:
                fault_point("s")
            except Exception:  # noqa: BLE001 - the point of the test
                pytest.fail("WorkerKilled was caught by except Exception")


def test_schedule_at_every_times():
    plan = FaultPlan(faults=[
        {"site": "x", "kind": "ioerror", "at": 2},
        {"site": "y", "kind": "ioerror", "every": 3, "times": 2},
    ])
    with faults.active(plan):
        hits_x = [_try_site("x") is not None for _ in range(5)]
        hits_y = [_try_site("y") is not None for _ in range(10)]
    assert hits_x == [False, False, True, False, False]
    assert hits_y == [True, False, False, True] + [False] * 6


def test_probabilistic_schedule_is_seed_deterministic():
    spec = {"seed": 42, "faults": [{"site": "p", "kind": "ioerror",
                                    "p": 0.5, "times": 100}]}

    def run():
        plan = FaultPlan.from_spec(spec)
        with faults.active(plan):
            return [_try_site("p") is not None for _ in range(64)]

    first, second = run(), run()
    assert first == second
    assert any(first) and not all(first)


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_same_spec_and_seed_fire_at_the_jax_packages_hits(seed):
    """One (spec, seed) drives both packages' plans over the same sequence
    of site calls: the same calls are hit, with the same kinds."""
    from swiftly_tpu.resilience import faults as jfaults

    spec = {"seed": seed, "faults": [
        {"site": "spill.read", "kind": "ioerror", "p": 0.3, "times": 20},
        {"site": "bwd.feed", "kind": "latency", "every": 4, "delay_s": 0.0},
        {"site": "transfer.h2d", "kind": "oom", "at": 5},
        {"site": "spill.write", "kind": "ioerror", "p": 0.5},
    ]}
    sites = ["spill.read", "bwd.feed", "transfer.h2d", "spill.write"] * 40
    rng = random.Random(seed)
    rng.shuffle(sites)

    def drive(mod):
        plan = mod.FaultPlan.from_spec(spec)
        with mod.active(plan):
            for site in sites:
                try:
                    mod.fault_point(site)
                except (OSError, RuntimeError):
                    pass
        return plan.injected, plan.stats()

    port, jax_ = drive(faults), drive(jfaults)
    assert port[0] == jax_[0] and port[0]
    assert port[1] == jax_[1]


def test_corrupt_array_flips_exactly_one_bit():
    arr = np.arange(64, dtype=np.float32)
    out = corrupt_array(arr)
    assert out.shape == arr.shape and out.dtype == arr.dtype
    assert np.unpackbits(arr.view(np.uint8) ^ out.view(np.uint8)).sum() == 1


def test_plan_spec_roundtrip(monkeypatch, tmp_path):
    plan = FaultPlan(faults=[{"site": "x", "kind": "oom", "at": 1}], seed=9)
    again = FaultPlan.from_spec(plan.spec())
    assert again.spec() == plan.spec()
    import json

    monkeypatch.delenv("SWIFTLY_FAULT_PLAN", raising=False)
    assert faults.plan_from_env() is None
    monkeypatch.setenv("SWIFTLY_FAULT_PLAN", json.dumps(plan.spec()))
    assert faults.plan_from_env().spec() == plan.spec()
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan.spec()))
    monkeypatch.setenv("SWIFTLY_FAULT_PLAN", f"@{path}")
    assert faults.plan_from_env().spec() == plan.spec()


# ---------------------------------------------------------------------------
# retry_transient: classification, backoff, accounting
# ---------------------------------------------------------------------------


def test_transient_classification():
    assert is_transient(IOError("disk hiccup"))
    assert is_transient(TimeoutError())
    assert is_transient(RuntimeError("RESOURCE_EXHAUSTED: oom"))
    assert is_transient(RuntimeError("backend UNAVAILABLE"))
    assert not is_transient(ValueError("bad shape"))
    assert not is_transient(RuntimeError("deterministic failure"))


@pytest.mark.parametrize("exc", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: unspecified launch failure"),
    RuntimeError("CUDA error: device UNAVAILABLE"),
    RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling cublasSgemm"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 9 GiB"),
], ids=["illegal-address", "launch-failure", "marker-in-text", "cublas",
        "oom"])
def test_cuda_errors_are_never_transient(exc):
    """A CUDA error is sticky in its context (or, out of memory, the OOM
    ladders' business): never retried, whatever markers its text holds."""
    assert is_cuda_error(exc)
    assert not is_transient(exc)
    calls = {"n": 0}

    def fail():
        calls["n"] += 1
        raise exc

    with pytest.raises(type(exc)):
        retry_transient(fail, sleep=lambda d: None)
    assert calls["n"] == 1


def test_oom_classification():
    assert is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory."))
    assert is_oom(RuntimeError("CUDA out of memory. Tried to allocate"))
    assert is_oom(MemoryError())
    assert is_oom(InjectedResourceExhausted("RESOURCE_EXHAUSTED: x"))
    assert not is_oom(RuntimeError("CUDA error: an illegal memory access"))
    assert not is_cuda_error(OSError("CUDA error"))  # an OSError is I/O


def test_retry_recovers_and_counts(counting):
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    out = retry_transient(flaky, site="t", sleep=lambda d: None)
    counters = metrics.export()["counters"]
    assert out == "ok" and calls["n"] == 3
    assert counters["retry.attempts"] == 2
    assert counters["retry.attempts.t"] == 2
    assert counters["retry.recovered"] == 1


def test_retry_fatal_raises_immediately():
    calls = {"n": 0}

    def fatal():
        calls["n"] += 1
        raise ValueError("deterministic")

    with pytest.raises(ValueError):
        retry_transient(fatal, sleep=lambda d: None)
    assert calls["n"] == 1


def test_retry_exhaustion_raises_last_error(counting):
    def always():
        raise OSError("still down")

    slept = []
    with pytest.raises(OSError):
        retry_transient(always, site="x", max_attempts=2, sleep=slept.append)
    assert len(slept) == 2
    assert metrics.export()["counters"]["retry.exhausted"] == 1


def test_retry_max_env_knob(monkeypatch):
    monkeypatch.setenv("SWIFTLY_RETRY_MAX", "1")
    calls = {"n": 0}

    def always():
        calls["n"] += 1
        raise OSError("down")

    with pytest.raises(OSError):
        retry_transient(always, sleep=lambda d: None)
    assert calls["n"] == 2


def test_backoff_delay_exponential_and_capped():
    rng = random.Random(0)
    assert 0.05 <= backoff_delay(0, base_s=0.1, max_s=10.0, rng=rng) <= 0.1
    assert backoff_delay(5, base_s=0.1, max_s=1.0, rng=rng) <= 1.0


# ---------------------------------------------------------------------------
# spill cache: atomic writes, orphan sweep, disk->RAM degradation, injected
# read retry
# ---------------------------------------------------------------------------


def test_spill_disk_write_atomic_and_retried(tmp_path):
    arr = np.arange(1024, dtype=np.float32)
    cache = SpillCache(budget_bytes=1, spill_dir=str(tmp_path))
    plan = FaultPlan(faults=[{"site": "spill.write", "kind": "ioerror",
                              "at": 0}])
    with faults.active(plan):
        cache.begin_fill()
        assert cache.put(0, arr)
        assert cache.end_fill()
    np.testing.assert_array_equal(cache.get(0), arr)
    leftovers = [f for _, _, fs in os.walk(tmp_path) for f in fs
                 if f.endswith(".tmp")]
    assert leftovers == []
    assert plan.stats()["total"] == 1


def test_spill_disk_failure_degrades_to_ram_only(tmp_path, monkeypatch):
    cache = SpillCache(budget_bytes=8, spill_dir=str(tmp_path))
    plan = FaultPlan(faults=[{"site": "spill.write", "kind": "ioerror",
                              "every": 1, "times": None}])
    monkeypatch.setenv("SWIFTLY_RETRY_MAX", "1")
    with faults.active(plan):
        cache.begin_fill()
        ok = cache.put(0, np.zeros(64, np.float32))
    assert not ok
    assert cache.gave_up and cache.spill_dir is None
    assert any(e["site"] == "spill" and e["action"] == "disk_to_ram"
               for e in degrade.events())


def test_spill_orphan_tmp_sweep(tmp_path):
    stale_dir = tmp_path / "swiftly_spill_dead"
    stale_dir.mkdir()
    stale = stale_dir / "group_00000.npy.tmp"
    stale.write_bytes(b"torn write")
    cache = SpillCache(budget_bytes=1e9, spill_dir=str(tmp_path))
    cache.begin_fill()
    assert not stale.exists()


@pytest.mark.parametrize("tier", ["ram", "disk"])
def test_spill_injected_read_retries_to_identical_value(tier, tmp_path,
                                                        counting):
    arr = np.arange(16, dtype=np.float32).reshape(4, 4)
    cache = (SpillCache(budget_bytes=1e9) if tier == "ram"
             else SpillCache(budget_bytes=1, spill_dir=str(tmp_path)))
    cache.begin_fill()
    cache.put(0, arr)
    cache.end_fill()
    plan = FaultPlan(faults=[{"site": "spill.read", "kind": "ioerror",
                              "at": 0},
                             {"site": "spill.get_row", "kind": "ioerror",
                              "at": 0}])
    with faults.active(plan):
        out = cache.get(0)
        row = cache.get_row(0, 2)
    np.testing.assert_array_equal(out, arr)
    np.testing.assert_array_equal(row, arr[2])
    assert plan.stats()["by_site"] == {"spill.read": 1, "spill.get_row": 1}
    counters = metrics.export()["counters"]
    assert counters["retry.attempts.spill.read"] == 1
    assert counters["retry.attempts.spill.get_row"] == 1
    if tier == "disk":
        assert counters["spill.disk_reads"] == 2
        assert "spill.disk_read" in metrics.export()["stages"]


# ---------------------------------------------------------------------------
# the executors' record and replay paths
# ---------------------------------------------------------------------------


def _port_setup(backend="planar"):
    dtype = torch.float64 if backend == "planar" else torch.complex128
    config = T.SwiftlyConfig(backend=backend, dtype=dtype, device="cpu",
                             **TEST_PARAMS)
    fcs = T.make_full_facet_cover(config)
    sgcs = T.make_full_subgrid_cover(config)
    tasks = [(fc, T.make_facet(config.image_size, fc, SOURCES)) for fc in fcs]
    return config, fcs, sgcs, tasks


def _stream(fwd, sgcs, spill):
    return [(per_col, g.clone())
            for per_col, g in fwd.stream_column_groups(sgcs, spill=spill)]


def _recorded():
    config, fcs, sgcs, tasks = _port_setup()
    fwd = T.StreamedForward(config, tasks, residency="device", col_group=2)
    spill = SpillCache(budget_bytes=1e9)
    ref = _stream(fwd, sgcs, spill)
    assert spill.complete and len(spill) >= 3
    return fwd, sgcs, spill, ref


def test_midfeed_spill_failure_falls_back_to_forward_replay():
    """A cached group that stays unreadable past its retries mid-feed runs
    the forward for the rest of the stream, from exactly that group: the
    consumer sees the whole stream, bit-identical, and the ledger records
    the fallback."""
    fwd, sgcs, spill, ref = _recorded()
    plan = FaultPlan(faults=[{"site": "spill.read", "kind": "ioerror",
                              "at": k} for k in (2, 3, 4, 5)])
    with faults.active(plan):
        out = _stream(fwd, sgcs, spill)
    assert len(out) == len(ref)
    for (_, ref_g), (_, got_g) in zip(ref, out):
        assert torch.equal(got_g, ref_g)
    assert spill.gave_up and not spill.complete
    assert fwd.last_spill["mode"] == "replay-fallback"
    assert any(e["site"] == "spill" and e["action"] == "replay_fallback"
               for e in degrade.events())


@pytest.mark.parametrize("site", ["transfer.h2d", "spill.read"])
def test_transient_replay_faults_retry_to_the_same_bits(site, counting):
    fwd, sgcs, spill, ref = _recorded()
    plan = FaultPlan(faults=[{"site": site, "kind": "ioerror", "at": 1}])
    with faults.active(plan):
        out = _stream(fwd, sgcs, spill)
    assert fwd.last_spill["mode"] == "replay"
    assert all(torch.equal(a[1], b[1]) for a, b in zip(ref, out))
    counters = metrics.export()["counters"]
    assert counters[f"retry.attempts.{site}"] == 1
    assert counters["spill.replay_feeds"] == 1


def test_transient_recording_fault_retries_to_the_same_bits(counting):
    config, fcs, sgcs, tasks = _port_setup()
    fwd = T.StreamedForward(config, tasks, residency="device", col_group=2)
    ref = _stream(fwd, sgcs, None)
    spill = SpillCache(budget_bytes=1e9)
    plan = FaultPlan(faults=[{"site": "transfer.d2h", "kind": "ioerror",
                              "at": 1}])
    with faults.active(plan):
        rec = _stream(fwd, sgcs, spill)
    assert spill.complete and len(spill) == len(ref)
    for k, (_, g) in enumerate(ref):
        assert torch.equal(rec[k][1], g)
        assert np.array_equal(spill.get(k), g.numpy())
    counters = metrics.export()["counters"]
    assert counters["retry.attempts.transfer.d2h"] == 1
    assert counters["spill.writes"] == len(ref)


def test_kill_on_the_replay_worker_reaches_the_consumer():
    """A WorkerKilled raised on the replay's read thread reaches the
    consumer at the hand-over of its group, through every ``except
    Exception``; the thread is joined and the consumer's earlier groups
    stand."""
    fwd, sgcs, spill, ref = _recorded()
    config, fcs, _, _ = _port_setup()
    bwd = T.StreamedBackward(config, fcs, residency="sampled", fold_group=2)
    plan = FaultPlan(faults=[{"site": "spill.read", "kind": "kill",
                              "at": 2}])
    with faults.active(plan):
        with pytest.raises(WorkerKilled):
            T.feed_backward_passes(fwd, sgcs, [bwd], spill=spill)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("swiftly-spill")]
    assert len(bwd.processed) == 2 * sum(len(c) for c in ref[0][0])


def test_kill_at_bwd_feed_stops_the_feed():
    config, fcs, sgcs, tasks = _port_setup()
    fwd = T.StreamedForward(config, tasks, residency="device", col_group=2)
    bwd = T.StreamedBackward(config, fcs, residency="sampled", fold_group=3)
    plan = FaultPlan(faults=[{"site": "bwd.feed", "kind": "kill", "at": 1}])
    with faults.active(plan):
        with pytest.raises(WorkerKilled):
            T.feed_backward_passes(fwd, sgcs, [bwd])
    assert plan.stats()["by_site"] == {"bwd.feed": 1}
    S = len(sgcs) // len({sg.off0 for sg in sgcs})
    assert len(bwd.processed) == 2 * S  # the first group only
    assert len(bwd._pending_rows) == 2  # 2 columns short of a fold of 3


def test_streamed_backward_wall_clock_autosave(tmp_path):
    """``enable_autosave(every_s=...)`` snapshots from inside the feed on a
    wall-clock cadence; the snapshot restores the processed ledger."""
    from swiftly_tpu_torch.utils.checkpoint import (
        checkpoint_generations,
        restore_streamed_backward_state,
    )

    config, fcs, sgcs, tasks = _port_setup("torch")
    fwd = T.StreamedForward(config, tasks, col_block=TEST_PARAMS["yB_size"])
    bwd = T.StreamedBackward(config, fcs)
    ck = tmp_path / "auto.npz"
    bwd.enable_autosave(ck, every_s=1e-6)  # due after every feed call
    cols = list(fwd.stream_columns(sgcs))[:2]
    for items, subgrids in cols:
        bwd.add_subgrids([(sg, subgrids[s]) for s, (_, sg) in
                          enumerate(items)])
    assert checkpoint_generations(ck)
    bwd2 = T.StreamedBackward(config, fcs)
    processed = restore_streamed_backward_state(ck, bwd2)
    assert set(processed) == set(bwd.processed)
    assert len(processed) == sum(len(items) for items, _ in cols)
    bwd.enable_autosave(ck)  # neither cadence: off
    assert bwd._autosave is None


# ---------------------------------------------------------------------------
# degradation ledger, shard loss and the watchdog (tests/test_resilience.py
# :549-620)
# ---------------------------------------------------------------------------


def test_degrade_ledger_records_and_resets():
    degrade.record("x", "stepped_down", detail=123)
    assert degrade.events() == [
        {"site": "x", "action": "stepped_down", "detail": "123"}]
    degrade.reset()
    assert degrade.events() == []


def test_shard_loss_kind_and_watchdog():
    import time as _time

    from swiftly_tpu_torch.resilience import (
        CollectiveStalledError,
        ShardLostError,
        collective_timeout_s,
        watch_collective,
    )

    plan = FaultPlan(faults=[{"site": "s", "kind": "shard_loss", "at": 0}])
    with faults.active(plan):
        with pytest.raises(ShardLostError, match="injected shard loss"):
            fault_point("s")
    assert plan.stats()["by_kind"] == {"shard_loss": 1}
    assert issubclass(ShardLostError, RuntimeError)
    assert not is_transient(ShardLostError("gone"))
    assert not issubclass(ShardLostError, WorkerKilled)
    assert issubclass(CollectiveStalledError, ShardLostError)
    knob = "SWIFTLY_COLLECTIVE_TIMEOUT_S"
    assert collective_timeout_s(env={}) is None
    for raw in ("", "soon", "0"):
        assert collective_timeout_s(env={knob: raw}) is None
    assert collective_timeout_s(env={knob: "2.5"}) == 2.5
    assert watch_collective(lambda: 41 + 1, "t.direct") == 42
    assert watch_collective(lambda: "ok", "t.fast", timeout_s=5.0) == "ok"
    with pytest.raises(CollectiveStalledError, match="t.slow"):
        watch_collective(lambda: _time.sleep(2.0), "t.slow", timeout_s=0.05)

    def boom():
        raise ValueError("inner failure")

    with pytest.raises(ValueError, match="inner failure"):
        watch_collective(boom, "t.boom", timeout_s=5.0)


# ---------------------------------------------------------------------------
# circuit breaker (tests/test_fleet.py:91-165)
# ---------------------------------------------------------------------------


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _breaker(clock, **kw):
    kw.setdefault("failure_threshold", 3)
    kw.setdefault("reopen_s", 0.5)
    kw.setdefault("half_open_probes", 2)
    kw.setdefault("rng", random.Random(0))
    return CircuitBreaker("b", clock=clock, **kw)


def test_breaker_opens_after_consecutive_failures():
    clk = _Clock()
    b = _breaker(clk)
    assert b.allow() and b.state == CLOSED
    b.record_failure()
    b.record_failure()
    assert b.state == CLOSED and b.allow()
    b.record_failure()
    assert b.state == OPEN and not b.allow()


def test_breaker_success_resets_failure_count():
    b = _breaker(_Clock())
    b.record_failure()
    b.record_failure()
    b.record_success()
    b.record_failure()
    b.record_failure()
    assert b.state == CLOSED


def test_breaker_half_open_probe_budget_and_close():
    clk = _Clock()
    b = _breaker(clk)
    for _ in range(3):
        b.record_failure()
    assert not b.allow()
    clk.t += 1.0
    assert b.allow() and b.state == HALF_OPEN
    assert b.allow()
    assert not b.allow()
    b.record_success()
    assert b.state == HALF_OPEN
    b.record_success()
    assert b.state == CLOSED
    assert [t["to"] for t in b.transitions] == ["open", "half_open", "closed"]


def test_breaker_half_open_probe_failure_reopens_escalated():
    clk = _Clock()
    b = _breaker(clk, reopen_s=0.5, max_reopen_s=64.0)
    for _ in range(3):
        b.record_failure()
    clk.t += 1.0
    assert b.allow() and b.state == HALF_OPEN
    b.record_failure()
    assert b.state == OPEN
    clk.t += 1.0
    assert b.allow() and b.state == HALF_OPEN
    b.record_failure()
    assert b.state == OPEN
    assert len([t for t in b.transitions if t["to"] == "open"]) == 3


def test_breaker_trip_forces_open_and_probes_reclose():
    clk = _Clock()
    b = _breaker(clk)
    b.trip(reason="lease revoked")
    assert b.state == OPEN
    b.trip(reason="again")
    assert sum(1 for t in b.transitions if t["to"] == "open") == 1
    clk.t += 1.0
    assert b.allow()
    b.record_success()
    assert b.allow()
    b.record_success()
    assert b.state == CLOSED
    assert b.stats()["state"] == CLOSED
