"""The port's `SubgridService` against the JAX package's ``tests/test_serve.py``
and the serve journeys of ``tests/test_trace.py``.

Held to the JAX package: the same request multisets served by both
packages' services give the same subgrids — f64 within 3e-10 RMS (the
round-trip bound; the port's planar f64 backend against the JAX package's
complex backend) and planar f32 within 1e-5 (relative RMS). The port's own
contracts are the JAX package's cases: a coalesced batch (stacked,
bucket-padded, fused multi-column, masked, ragged) bit-identical to
sequential ``get_subgrid_task`` on a fresh forward (planar backend),
admission and deadlines, fault isolation and quarantine, OOM batch
splits, the cache feed's hit and eviction paths, scheduling, the worker
thread, SLO stats, the metrics vocabulary and the request journeys.

Torch runs on one intra-op thread.
"""

import functools
import time

import numpy as np
import pytest
import torch

import swiftly_tpu_torch as T
from swiftly_tpu_torch.models.config import SubgridConfig
from swiftly_tpu_torch.obs import metrics, recorder, report, trace
from swiftly_tpu_torch.obs.report import validate_trace_events
from swiftly_tpu_torch.serve import (
    STATUS_EXPIRED,
    STATUS_QUARANTINED,
    STATUS_SHED,
    AdmissionQueue,
    CoalescingScheduler,
    SubgridRequest,
    SubgridService,
)

TEST_PARAMS = {  # tests/test_serve.py:45
    "W": 13.5625,
    "fov": 1.0,
    "N": 1024,
    "yB_size": 416,
    "yN_size": 512,
    "xA_size": 228,
    "xM_size": 256,
}
SOURCES = [(1, 1, 0), (0.5, -30, 40)]
RMS_F64 = 3e-10
RMS_F32 = 1e-5
# tests/test_trace.py:354
SERVE_PARAMS = {"W": 8.0, "fov": 1.0, "N": 256, "yB_size": 96,
                "yN_size": 128, "xA_size": 56, "xM_size": 64}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _setup(dtype=torch.float64, params=tuple(TEST_PARAMS.items()),
           sources=tuple(SOURCES)):
    config = T.SwiftlyConfig(backend="planar", dtype=dtype, device="cpu",
                             **dict(params))
    fcs = T.make_full_facet_cover(config)
    sgs = T.make_full_subgrid_cover(config)
    tasks = [(fc, T.make_facet(config.image_size, fc, list(sources)))
             for fc in fcs]
    return config, tasks, sgs


@pytest.fixture
def cover():
    return _setup()


def _forward(cover, **kwargs):
    config, facet_tasks, _ = cover
    kwargs.setdefault("lru_forward", 2)
    kwargs.setdefault("queue_size", 50)
    return T.SwiftlyForward(config, facet_tasks, **kwargs)


def _assert_all_ok(reqs):
    for r in reqs:
        assert r.result is not None and r.result.ok, r.result


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _complex(x):
    x = _np(x)
    return x[..., 0] + 1j * x[..., 1]


def _workload(sgs, seed, n=30):
    """tests/test_serve.py:87's random request multiset: duplicates,
    random 0/1 masks, random priorities."""
    rng = np.random.default_rng(seed)
    workload, prios = [], []
    for _ in range(n):
        sg = sgs[rng.integers(len(sgs))]
        if rng.random() < 0.3:
            sg = (sg.off0, sg.off1, sg.size,
                  (rng.random(sg.size) < 0.7).astype(float),
                  (rng.random(sg.size) < 0.7).astype(float))
        else:
            sg = (sg.off0, sg.off1, sg.size, None, None)
        workload.append(sg)
        prios.append(int(rng.integers(0, 3)))
    return workload, prios


@functools.cache
def _jax_served(seed, f32):
    """The JAX service's results for `_workload(seed)`: complex backend in
    f64, planar f32."""
    import jax.numpy as jnp

    import swiftly_tpu as J
    from swiftly_tpu.serve import CoalescingScheduler as JSched
    from swiftly_tpu.serve import SubgridService as JService

    kw = dict(backend="planar", dtype=jnp.float32) if f32 else dict(
        backend="jax")
    config = J.SwiftlyConfig(**kw, **TEST_PARAMS)
    fcs = J.make_full_facet_cover(config)
    sgs = J.make_full_subgrid_cover(config)
    tasks = [(fc, J.make_facet(config.image_size, fc, SOURCES)) for fc in fcs]
    workload, prios = _workload(sgs, seed)
    svc = JService(J.SwiftlyForward(config, tasks, lru_forward=2,
                                    queue_size=50),
                   scheduler=JSched(max_batch=4 if seed % 2 else 8))
    reqs = [svc.submit(J.SubgridConfig(*w), priority=p)
            for w, p in zip(workload, prios)]
    while svc.pump_once():
        pass
    out = []
    for r in reqs:
        assert r.result.ok
        d = np.asarray(r.result.data)
        out.append(d[..., 0] + 1j * d[..., 1] if f32 else d)
    return out


def _rms_rel(a, b):
    return float(np.sqrt(np.mean(np.abs(a - b) ** 2))
                 / max(np.max(np.abs(b)), 1e-300))


# ---------------------------------------------------------------------------
# Request/batch parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_service_parity_randomized(cover, seed):
    """Random request multisets through the coalescing batcher: bit-
    identical to sequential `get_subgrid_task` on a fresh forward, and
    within 3e-10 RMS of the JAX service's f64 results."""
    config, _tasks, sgs = cover
    workload, prios = _workload(sgs, seed)
    workload = [SubgridConfig(*w) for w in workload]
    svc = SubgridService(
        _forward(cover),
        scheduler=CoalescingScheduler(max_batch=4 if seed % 2 else 8))
    reqs = [svc.submit(sg, priority=p) for sg, p in zip(workload, prios)]
    while svc.pump_once():
        pass
    _assert_all_ok(reqs)
    fwd_ref = _forward(cover)
    for sg, req in zip(workload, reqs):
        assert torch.equal(req.result.data, fwd_ref.get_subgrid_task(sg))
    for req, want in zip(reqs, _jax_served(seed, False)):
        got = _complex(req.result.data)
        assert np.sqrt(np.mean(np.abs(got - want) ** 2)) < RMS_F64


def test_service_parity_planar_f32_against_the_jax_package():
    config, _tasks, sgs = cover = _setup(torch.float32)
    workload, prios = _workload(sgs, 0)
    svc = SubgridService(_forward(cover),
                         scheduler=CoalescingScheduler(max_batch=8))
    reqs = [svc.submit(SubgridConfig(*w), priority=p)
            for w, p in zip(workload, prios)]
    while svc.pump_once():
        pass
    _assert_all_ok(reqs)
    for req, want in zip(reqs, _jax_served(0, True)):
        assert _rms_rel(_complex(req.result.data), want) < RMS_F32


def test_fused_multicolumn_parity(cover):
    _config, _tasks, sgs = cover
    cols = sorted({sg.off0 for sg in sgs})
    workload = [sg for sg in sgs if sg.off0 == cols[0]] + [
        sg for sg in sgs if sg.off0 == cols[1]][:2]
    svc = SubgridService(_forward(cover), fuse_columns=2,
                         scheduler=CoalescingScheduler(max_batch=16))
    reqs = svc.serve(workload)
    _assert_all_ok(reqs)
    fwd_ref = _forward(cover)
    for sg, req in zip(workload, reqs):
        assert torch.equal(req.result.data, fwd_ref.get_subgrid_task(sg))


# ---------------------------------------------------------------------------
# Coalescing and scheduling
# ---------------------------------------------------------------------------


def test_one_column_coalesces_to_one_batch(cover):
    _config, _tasks, sgs = cover
    col0 = [sg for sg in sgs if sg.off0 == sgs[0].off0]
    svc = SubgridService(_forward(cover),
                         scheduler=CoalescingScheduler(max_batch=16))
    reqs = svc.serve(col0)
    _assert_all_ok(reqs)
    st = svc.stats()
    assert st["n_batches"] == 1
    assert st["coalesce_hit_rate"] == 1.0
    assert all(r.result.batch_size == len(col0) for r in reqs)


def test_scheduler_prefers_hot_column(cover):
    _config, _tasks, sgs = cover
    cols = sorted({sg.off0 for sg in sgs})
    a = [sg for sg in sgs if sg.off0 == cols[0]]
    b = [sg for sg in sgs if sg.off0 == cols[1]]
    svc = SubgridService(_forward(cover),
                         scheduler=CoalescingScheduler(max_batch=8))
    svc.serve(a[:2])
    ra = svc.submit(a[0])
    rbs = [svc.submit(sg) for sg in b]
    svc.pump_once()
    assert ra.result is not None and ra.result.ok
    assert all(r.result is None for r in rbs)
    while svc.pump_once():
        pass
    _assert_all_ok(rbs)


def test_scheduler_urgency_preempts(cover):
    _config, _tasks, sgs = cover
    cols = sorted({sg.off0 for sg in sgs})
    a = [sg for sg in sgs if sg.off0 == cols[0]]
    b = [sg for sg in sgs if sg.off0 == cols[1]]
    svc = SubgridService(
        _forward(cover),
        scheduler=CoalescingScheduler(max_batch=8, urgency_s=3600.0))
    ras = [svc.submit(sg) for sg in a]
    rb = svc.submit(b[0], deadline_s=1800.0)
    svc.pump_once()
    assert rb.result is not None and rb.result.ok
    assert all(r.result is None for r in ras)
    while svc.pump_once():
        pass
    _assert_all_ok(ras)


def test_bucket_padding_bounds_shapes():
    sched = CoalescingScheduler(max_batch=8, bucket_pad=True)
    reqs = [SubgridRequest(SubgridConfig(0, i, 16)) for i in range(5)]
    configs, n_pad = sched.plan_batch(reqs)
    assert len(configs) == 8 and n_pad == 3
    assert all(c is reqs[0].config for c in configs[5:])
    configs2, n_pad2 = CoalescingScheduler(
        max_batch=6, bucket_pad=True).plan_batch(reqs)
    assert len(configs2) == 6 and n_pad2 == 1


def test_scheduler_consumes_compiled_plan_buckets():
    from swiftly_tpu_torch.plan import PlanInputs, bucket_sizes, compile_plan

    plan = compile_plan(PlanInputs.from_config("4k[1]-n2k-512", max_batch=8),
                        mode="streamed")
    assert plan.serve.bucket_sizes == bucket_sizes(8) == [1, 2, 4, 8]
    sched = CoalescingScheduler(max_batch=plan.serve.max_batch,
                                bucket_sizes=plan.serve.bucket_sizes)
    reqs = [SubgridRequest(SubgridConfig(0, i, 16)) for i in range(5)]
    configs, n_pad = sched.plan_batch(reqs)
    assert len(configs) == 8 and n_pad == 3
    default = CoalescingScheduler(max_batch=8)
    for n in range(1, 9):
        sub = reqs[:1] * n
        assert sched.plan_batch(sub)[1] == default.plan_batch(sub)[1]


# ---------------------------------------------------------------------------
# Admission: depth, device-memory cost, deadlines
# ---------------------------------------------------------------------------


def test_depth_shed(cover):
    _config, _tasks, sgs = cover
    svc = SubgridService(_forward(cover), queue=AdmissionQueue(max_depth=4))
    reqs = [svc.submit(sg) for sg in sgs[:10]]
    shed = [r for r in reqs if r.result is not None]
    assert len(shed) == 6
    assert all(r.result.status == STATUS_SHED for r in shed)
    assert all(r.result.shed_reason == "depth" for r in shed)
    while svc.pump_once():
        pass
    _assert_all_ok(reqs[:4])
    st = svc.stats()
    assert st["n_shed"] == 6 and st["shed_rate"] == 0.6


def test_hbm_cost_shed(cover):
    _config, _tasks, sgs = cover
    cols = sorted({sg.off0 for sg in sgs})
    a = next(sg for sg in sgs if sg.off0 == cols[0])
    b = next(sg for sg in sgs if sg.off0 == cols[1])
    queue = AdmissionQueue(max_depth=100, hbm_budget_bytes=1500,
                           request_bytes=100, column_bytes=1000)
    svc = SubgridService(_forward(cover), queue=queue)
    r1, r2, r3 = svc.submit(a), svc.submit(a), svc.submit(b)
    assert r1.result is None and r2.result is None
    assert r3.result is not None and r3.result.shed_reason == "hbm"
    while svc.pump_once():
        pass
    _assert_all_ok([r1, r2])


def test_default_queue_prices_the_forward(cover):
    """With ``hbm_budget_bytes`` the default queue prices requests and
    columns with the plan's byte projections of this forward."""
    fwd = _forward(cover)
    svc = SubgridService(fwd, hbm_budget_bytes=10**12)
    assert svc.queue.request_bytes == T.serve.projected_request_bytes(
        fwd.config)
    assert svc.queue.column_bytes == T.serve.projected_column_bytes(fwd)


def test_deadline_expiry(cover):
    _config, _tasks, sgs = cover
    svc = SubgridService(_forward(cover))
    dead_on_arrival = svc.submit(sgs[2], deadline_s=-1.0)
    fast = svc.submit(sgs[0], deadline_s=0.005)
    slow = svc.submit(sgs[1])
    time.sleep(0.02)
    while svc.pump_once():
        pass
    assert dead_on_arrival.result.status == STATUS_EXPIRED
    assert fast.result.status == STATUS_EXPIRED
    assert slow.result.ok
    assert svc.stats()["n_expired"] == 2


def test_submit_after_deadline_sheds_expired(cover):
    _config, _tasks, sgs = cover
    svc = SubgridService(_forward(cover))
    admitted, reason = svc.queue.offer(SubgridRequest(sgs[0], deadline_s=-1.0))
    assert not admitted and reason == "expired"


def test_queue_take_priority_order():
    q = AdmissionQueue(max_depth=10)
    reqs = [SubgridRequest(SubgridConfig(0, i, 16), priority=p)
            for i, p in enumerate([0, 2, 1, 2])]
    for r in reqs:
        assert q.offer(r)[0]
    taken = q.take(0, limit=3)
    assert [t.priority for t in taken] == [2, 2, 1]
    assert [t.config.off1 for t in taken[:2]] == [1, 3]
    assert len(q) == 1


# ---------------------------------------------------------------------------
# Fault isolation: injection, OOM splits, quarantine, cache eviction
# ---------------------------------------------------------------------------


def test_injected_batch_failure_retries_to_success(cover):
    _config, _tasks, sgs = cover
    col0 = [sg for sg in sgs if sg.off0 == sgs[0].off0]
    state = {"armed": 1}

    def injector(reqs, attempt):
        if attempt == 0 and state["armed"]:
            state["armed"] = 0
            raise RuntimeError("injected transient failure")

    svc = SubgridService(_forward(cover), fault_injector=injector)
    reqs = svc.serve(col0)
    _assert_all_ok(reqs)
    st = svc.stats()
    assert st["batch_failures"] == 1
    assert st["retries"] == len(col0)
    assert all(r.result.path == "retry" for r in reqs)
    fwd_ref = _forward(cover)
    for sg, req in zip(col0, reqs):
        assert torch.equal(req.result.data, fwd_ref.get_subgrid_task(sg))


def test_oom_batch_splits_in_half(cover):
    """A device out-of-memory on a coalesced batch steps down the ladder:
    the batch is split in half (``serve.batch_split`` in the degradation
    ledger) before per-request isolation."""
    from swiftly_tpu_torch.resilience import degrade

    _config, _tasks, sgs = cover
    col0 = [sg for sg in sgs if sg.off0 == sgs[0].off0]
    assert len(col0) >= 4
    state = {"armed": 1}

    def injector(reqs, attempt):
        if attempt == 0 and state["armed"] and len(reqs) == len(col0):
            state["armed"] = 0
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (drill)")

    degrade.reset()
    svc = SubgridService(_forward(cover), fault_injector=injector)
    reqs = svc.serve(col0)
    _assert_all_ok(reqs)
    st = svc.stats()
    assert st["batch_failures"] == 1 and st["batch_splits"] == 1
    assert st["retries"] == 0
    assert st["n_batches"] == 3
    assert all(r.result.path == "coalesced" for r in reqs)
    assert any(e["site"] == "serve" and e["action"] == "batch_split"
               for e in degrade.events())


def test_poisoned_request_quarantined_without_wedging(cover):
    _config, _tasks, sgs = cover
    col0 = [sg for sg in sgs if sg.off0 == sgs[0].off0]
    poisoned = SubgridConfig(col0[0].off0, col0[0].off1, col0[0].size,
                             np.ones(col0[0].size + 5), None)
    svc = SubgridService(_forward(cover), max_retries=2)
    good = [svc.submit(sg) for sg in col0]
    bad = svc.submit(poisoned)
    while svc.pump_once():
        pass
    _assert_all_ok(good)
    assert bad.result.status == STATUS_QUARANTINED
    assert bad.result.error
    assert bad.result.retries == 2
    st = svc.stats()
    assert st["n_quarantined"] == 1 and len(svc.quarantined) == 1
    assert len(svc.queue) == 0


def _one_column_feed(cover, tag):
    from swiftly_tpu_torch.parallel.streamed import CachedColumnFeed
    from swiftly_tpu_torch.utils.spill import SpillCache

    _config, _tasks, sgs = cover
    col0 = [sg for sg in sgs if sg.off0 == sgs[0].off0]
    fwd = _forward(cover)
    stacked = fwd.get_subgrid_tasks(col0)
    spill = SpillCache(budget_bytes=2**28)
    spill.begin_fill(tag=tag)
    assert spill.put([list(enumerate(col0))],
                     np.stack([r.numpy() for r in stacked])[None])
    assert spill.end_fill()
    return fwd, col0, spill, CachedColumnFeed(spill)


def test_cache_feed_hit_and_eviction_fallback(cover):
    fwd, col0, spill, feed = _one_column_feed(cover, "serve-test")
    assert len(feed) == len(col0)
    svc = SubgridService(fwd, cache_feed=feed)
    reqs = svc.serve(col0)
    _assert_all_ok(reqs)
    assert all(r.result.path == "cache" for r in reqs)
    assert svc.stats()["cache_hits"] == len(col0)
    fwd_ref = _forward(cover)
    for sg, req in zip(col0, reqs):
        np.testing.assert_array_equal(
            req.result.data, fwd_ref.get_subgrid_task(sg).numpy())
    spill.reset()
    reqs2 = svc.serve(col0)
    _assert_all_ok(reqs2)
    assert all(r.result.path in ("coalesced", "retry") for r in reqs2)
    assert svc.stats()["cache_fallbacks"] == len(col0)
    assert feed.evicted == len(col0)
    assert feed.stale == 0
    for sg, req in zip(col0, reqs2):
        assert torch.equal(req.result.data, fwd_ref.get_subgrid_task(sg))


def test_cache_feed_mask_mismatch_is_miss(cover):
    _fwd, col0, _spill, feed = _one_column_feed(cover, "mask-test")
    masked = SubgridConfig(col0[0].off0, col0[0].off1, col0[0].size,
                           np.zeros(col0[0].size), None)
    assert feed.lookup(masked) is None
    assert feed.misses == 1


def test_streamed_recorded_feed_bitidentical_to_stream(cover):
    from swiftly_tpu_torch.utils.spill import SpillCache

    config, tasks, sgs = cover
    sfwd = T.StreamedForward(config, tasks, residency="device", col_group=4)
    spill = SpillCache(budget_bytes=2**30)
    recorded = {}
    for per_col, group in sfwd.stream_column_groups(sgs, spill=spill):
        host = group.numpy()
        for c, col in enumerate(per_col):
            for s, (_i, sg) in enumerate(col):
                recorded[(sg.off0, sg.off1)] = host[c, s].copy()
    assert spill.complete
    feed = sfwd.cached_feed(spill)
    for sg in sgs:
        row = feed.lookup(sg)
        assert row is not None
        np.testing.assert_array_equal(row, recorded[(sg.off0, sg.off1)])


# ---------------------------------------------------------------------------
# Worker thread and SLO instrumentation
# ---------------------------------------------------------------------------


def test_threaded_service(cover):
    _config, _tasks, sgs = cover
    svc = SubgridService(_forward(cover)).start()
    try:
        reqs = [svc.submit(sg) for sg in sgs[:8]]
        for r in reqs:
            assert r.wait(timeout=120) is not None
        _assert_all_ok(reqs)
    finally:
        svc.stop(timeout=120)
    assert svc.stats()["n_served"] == 8


def test_slo_and_latency_stats(cover):
    _config, _tasks, sgs = cover
    svc = SubgridService(_forward(cover), slo_ms=1e9)
    svc.serve(sgs[:6])
    st = svc.stats()
    assert st["p50_ms"] > 0 and st["p99_ms"] >= st["p50_ms"]
    assert st["max_ms"] >= st["p99_ms"]
    assert st["slo_violations"] == 0 and st["slo_attainment"] == 1.0
    svc2 = SubgridService(_forward(cover), slo_ms=1e-9)
    svc2.serve(sgs[:2])
    st2 = svc2.stats()
    assert st2["slo_violations"] == 2 and st2["slo_attainment"] == 0.0


def test_serve_metrics_vocabulary(cover):
    _config, _tasks, sgs = cover
    metrics.reset()
    metrics.enable()
    try:
        svc = SubgridService(_forward(cover), queue=AdmissionQueue(max_depth=4))
        for sg in sgs[:6]:
            svc.submit(sg)
        while svc.pump_once():
            pass
        exp = metrics.export()
    finally:
        metrics.disable()
        metrics.reset()
    counters = exp["counters"]
    assert counters["serve.requests"] == 6
    assert counters["serve.served"] == 4
    assert counters["serve.shed"] == 2
    assert counters["serve.shed.depth"] == 2
    assert counters["lru.miss"] >= 1
    assert "serve.queue_depth" in exp["gauges"]
    stages = exp["stages"]
    assert {"serve.batch", "serve.request"} <= set(stages)
    assert stages["serve.request"]["count"] == 4
    assert "p50_s" in stages["serve.request"]


# ---------------------------------------------------------------------------
# Request journeys (tests/test_trace.py:349)
# ---------------------------------------------------------------------------


@pytest.fixture
def global_trace():
    tr = trace.get_tracer()
    tr.reset()
    tr.enable()
    yield tr
    tr.disable()
    tr.reset()


@pytest.fixture
def global_obs_off():
    def off():
        trace.get_tracer().disable()
        trace.get_tracer().reset()
        metrics.get_registry().disable()
        metrics.get_registry().reset()
        recorder.disable()
        recorder.reset()

    off()
    yield
    off()


def _journey_service(**kwargs):
    cover = _setup(torch.float64, tuple(SERVE_PARAMS.items()),
                   ((1.0, 3, -5),))
    return SubgridService(_forward(cover), **kwargs), cover[2]


def test_journey_segments_sum_to_latency(global_obs_off):
    from swiftly_tpu_torch.obs import validate_serve_artifact

    svc, sgs = _journey_service()
    reqs = svc.serve(sgs[:6] + sgs[:2])
    for r in reqs:
        res = r.result
        assert res is not None and res.ok
        j = res.journey
        assert j is not None
        assert j["queue_s"] >= 0 and j["compute_s"] >= 0
        assert j["transfer_s"] >= 0
        assert j["queue_s"] + j["compute_s"] + j["transfer_s"] == (
            pytest.approx(res.latency_s, abs=1e-9))
    jb = svc.stats()["journey"]
    assert jb["n"] == len(reqs)
    shares = [jb[seg]["share"] for seg in ("queue", "compute", "transfer")]
    assert sum(shares) == pytest.approx(1.0, abs=0.01)
    for seg in ("queue", "compute", "transfer"):
        assert jb[seg]["p50_ms"] <= jb[seg]["p99_ms"] + 1e-9
    probs = validate_serve_artifact({"journey": jb})
    assert not any("journey" in p for p in probs)


def test_journey_trace_spans_on_request_tracks(global_trace):
    svc, sgs = _journey_service()
    with trace.span("demo.serve", cat="demo"):
        reqs = svc.serve(sgs[:4])
    assert all(r.result.ok for r in reqs)
    exported = trace.export()
    assert validate_trace_events(exported) == []
    spans = report.build_tree(exported)
    journeys = [s for s in spans.values() if s["name"] == "serve.journey"]
    assert len(journeys) == 4
    for j in journeys:
        segs = {spans[c]["name"] for c in j["children"]}
        assert segs == {"serve.journey.queue", "serve.journey.compute",
                        "serve.journey.transfer"}
        seg_total = sum(spans[c]["dur_s"] for c in j["children"])
        assert seg_total == pytest.approx(j["dur_s"], rel=1e-3, abs=1e-6)
        assert j["tid"] >= trace.JOURNEY_TID_BASE
    js = report.journey_stats(spans)
    assert js["n_requests"] == 4
    assert (js["queue_share"] + js["compute_share"] + js["transfer_share"]
            == pytest.approx(1.0, abs=0.01))
    assert [s for s in spans.values() if s["name"] == "serve.batch"]


def test_worker_pump_spans_nest_under_run(global_trace):
    svc, sgs = _journey_service()
    with trace.span("demo.serve", cat="demo") as root:
        svc.start()
        reqs = [svc.submit(sg) for sg in sgs[:4]]
        for r in reqs:
            assert r.wait(30.0) is not None
        svc.stop()
    assert all(r.result.ok for r in reqs)
    spans = report.build_tree(trace.export())

    def has_root_ancestor(s):
        while s["parent"]:
            if s["parent"] == root.id:
                return True
            s = spans[s["parent"]]
        return False

    batch = [s for s in spans.values() if s["name"] == "serve.batch"]
    assert batch
    assert all(has_root_ancestor(s) for s in batch)
