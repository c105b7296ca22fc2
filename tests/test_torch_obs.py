"""The port's telemetry (``swiftly_tpu_torch.obs``): the metrics registry,
the span tracer and the flight recorder, held to the JAX package's cases
(``tests/test_obs.py:40-134,237-330``, ``tests/test_trace.py:76-302``).

The port's Chrome trace export is read with the JAX package's own
``swiftly_tpu.obs.report`` (tree, validator, critical path), and the same
streamed round trip through both packages must give the same stage names
and the same subgrid counters. The port's twins of the JAX spots: a stage
opens a ``torch.profiler.record_function`` of its name, and the HBM
sampler reads ``torch.cuda.max_memory_allocated`` (None on the CPU, where
the gauge fallback stamps the spans).
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import swiftly_tpu_torch as T
from swiftly_tpu.obs import report
from swiftly_tpu.obs.report import validate_trace_events
from swiftly_tpu_torch.obs import metrics, recorder, trace
from swiftly_tpu_torch.obs.metrics import _NULL_STAGE, MetricsRegistry
from swiftly_tpu_torch.obs.trace import _NULL_SPAN, Tracer
from swiftly_tpu_torch.utils import flops as tflops

# tests/test_obs.py:256's streamed config
OBS_PARAMS = {"W": 8.0, "fov": 1.0, "N": 256, "yB_size": 96,
              "yN_size": 128, "xA_size": 56, "xM_size": 64}
OBS_SOURCES = [(1.0, 3, -5)]
EXPECTED_STAGES = {
    "fwd.facet_upload", "fwd.sampled_facet_pass", "fwd.column_pass",
    "bwd.column_pass", "bwd.sampled_fold", "bwd.finish",
}


def _all_off():
    for mod in (trace, metrics, recorder):
        mod.disable()
        mod.reset()


@pytest.fixture
def obs_off():
    """The three process-wide systems off and wiped around the test."""
    _all_off()
    yield
    _all_off()


def _per_call_s(body, n=20_000, repeats=5):
    """Seconds a call of `body` costs: the least of `repeats` timed runs of
    `n` calls (other processes' load only ever adds time)."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n):
            body()
        best = min(best, (time.perf_counter() - t0) / n)
    return best


def _enter_exit(site, name="fwd.column_pass"):
    def body():
        with site(name):
            pass
    return body


@pytest.fixture
def global_trace(obs_off):
    trace.enable()
    yield trace.get_tracer()


# ---------------------------------------------------------------------------
# Registry semantics (tests/test_obs.py:40-143)
# ---------------------------------------------------------------------------


def test_disabled_registry_is_a_no_op():
    reg = MetricsRegistry()
    s1 = reg.stage("fwd.column_pass", flops=123)
    s2 = reg.stage("bwd.sampled_fold")
    assert s1 is _NULL_STAGE and s2 is _NULL_STAGE
    with s1:
        s1.bytes_moved = 42
    reg.count("fwd.subgrids", 5)
    reg.gauge("plan", {"col_group": 4})
    reg.event("heartbeat", done=1)
    exp = reg.export()
    assert exp["counters"] == {} and exp["gauges"] == {}
    assert exp["stages"] == {}
    assert not exp["enabled"]


def test_disabled_stage_call_overhead_is_negligible():
    reg = MetricsRegistry()
    assert _per_call_s(_enter_exit(reg.stage)) < 5e-6


def test_enabled_registry_records_counts_and_timings():
    reg = MetricsRegistry(enabled=True)
    for _ in range(3):
        with reg.stage("fwd.column_pass", flops=1000, bytes_moved=10):
            time.sleep(0.002)
    with reg.stage("bwd.sampled_fold"):
        pass
    reg.count("fwd.subgrids", 7)
    reg.count("fwd.subgrids", 3)
    reg.gauge("fwd.plan", {"col_group": 2})
    exp = reg.export()
    assert exp["counters"]["fwd.subgrids"] == 10
    assert exp["gauges"]["fwd.plan"] == {"col_group": 2}
    st = exp["stages"]["fwd.column_pass"]
    assert st["count"] == 3
    assert st["flops"] == 3000 and st["bytes"] == 30
    assert st["total_s"] >= 3 * 0.002
    assert st["min_s"] <= st["mean_s"] <= st["max_s"]
    assert st["min_s"] <= st["p99_s"] <= st["max_s"] + 1e-9
    assert "tflops" in st
    assert exp["total"]["flops"] == 3000
    json.dumps(exp)


def test_stage_mfu_against_operator_peak(monkeypatch):
    monkeypatch.setenv("SWIFTLY_PEAK_TFLOPS", "2.0")
    reg = MetricsRegistry(enabled=True)
    with reg.stage("fwd.column_pass", flops=10**9):
        time.sleep(0.001)
    exp = reg.export()
    st = exp["stages"]["fwd.column_pass"]
    assert st["mfu_pct"] == pytest.approx(100 * st["tflops"] / 2.0, rel=0.01)
    assert exp["total"]["peak_tflops"] == 2.0


def test_jsonl_round_trip(tmp_path):
    path = tmp_path / "events.jsonl"
    reg = MetricsRegistry(enabled=True, jsonl_path=path)
    with reg.stage("fwd.sampled_facet_pass", flops=5, bytes_moved=6):
        pass
    with reg.stage("bwd.finish"):
        pass
    reg.event("heartbeat", done=3, total=9)
    reg.disable()
    records = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert records[0]["kind"] == "open"
    stage_events = [r for r in records if r["kind"] == "stage"]
    assert [r["name"] for r in stage_events] == [
        "fwd.sampled_facet_pass", "bwd.finish"]
    assert stage_events[0]["flops"] == 5 and stage_events[0]["bytes"] == 6
    assert all("wall_s" in r for r in stage_events)
    hb = [r for r in records if r["kind"] == "heartbeat"]
    assert hb == [{"kind": "heartbeat", "done": 3, "total": 9}]
    reg.count("x")
    with reg.stage("y"):
        pass
    assert len(path.read_text().splitlines()) == len(records)


def test_reset_drops_state():
    reg = MetricsRegistry(enabled=True)
    reg.count("a")
    with reg.stage("s"):
        pass
    reg.reset()
    exp = reg.export()
    assert exp["counters"] == {} and exp["stages"] == {}
    assert exp["enabled"]


def test_stage_opens_a_profiler_range_of_its_name():
    """The torch twin of the stage's TraceAnnotation: the PyTorch profiler
    sees a range named like the stage (on the CPU: no NVTX)."""
    reg = MetricsRegistry(enabled=True, jsonl_path=None)
    reg.enable(device="cpu")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with reg.stage("fwd.column_pass", flops=1):
            torch.ones(8) @ torch.ones(8)
    names = {e.key for e in prof.key_averages()}
    assert "fwd.column_pass" in names


def test_peak_tflops(monkeypatch):
    monkeypatch.setenv("SWIFTLY_PEAK_TFLOPS", "12.5")
    assert tflops.peak_tflops() == 12.5
    monkeypatch.delenv("SWIFTLY_PEAK_TFLOPS")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tflops.peak_tflops() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert tflops.peak_tflops() == tflops.H100_F32_TFLOPS == 67.0
    assert tflops.peak_tflops("cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA A100-SXM4-80GB")
    assert tflops.peak_tflops() is None


@pytest.mark.parametrize("config", ["1k[1]-n512-256", "4k[1]-n2k-512",
                                    "32k[1]-n16k-512"])
def test_sampled_flops_match_the_jax_package(config):
    """``forward_sampled_flops`` / ``backward_sampled_flops`` count what the
    JAX package's do for the bodies both packages share (einsum, fft)."""
    import swiftly_tpu as J
    from swiftly_tpu.utils import flops as jflops

    params = T.SWIFT_CONFIGS[config]
    tcore = T.SwiftlyCore(params["W"], params["N"], params["xM_size"],
                          params["yN_size"], backend="numpy")
    jcore = J.SwiftlyCore(params["W"], params["N"], params["xM_size"],
                          params["yN_size"], backend="numpy")
    yB, xA = params["yB_size"], params["xA_size"]
    n_cols = -(-params["N"] // xA)
    for colpass in ("einsum", "fft"):
        for real in (False, True):
            args = (9, yB, n_cols, n_cols, xA)
            assert tflops.forward_sampled_flops(
                tcore, *args, real_facets=real, finish_passes=3,
                colpass=colpass) == jflops.forward_sampled_flops(
                jcore, *args, real_facets=real, finish_passes=3,
                colpass=colpass)
        # the FFT body's first extracting iFFT runs over xM rows; the JAX
        # package counts m (ROADMAP C)
        m, xM = tcore.xM_yN_size, tcore.xM_size
        short = 0 if colpass == "einsum" else n_cols * n_cols * 9 * (
            tflops.fft_flops(m, xM) - tflops.fft_flops(m, m))
        assert tflops.backward_sampled_flops(
            tcore, 9, yB, n_cols, n_cols, xA, colpass=colpass
        ) == jflops.backward_sampled_flops(
            jcore, 9, yB, n_cols, n_cols, xA, colpass=colpass) + short
    # the kernel body (the JAX package's "pallas") finishes with a crop too
    assert tflops.forward_sampled_flops(
        tcore, 9, yB, n_cols, n_cols, xA, finish_passes=3, colpass="kernel"
    ) == tflops.forward_sampled_flops(
        tcore, 9, yB, n_cols, n_cols, xA, finish_passes=1, colpass="kernel")


# ---------------------------------------------------------------------------
# Tracer and recorder (tests/test_trace.py:76-302)
# ---------------------------------------------------------------------------


def test_disabled_tracer_is_a_no_op(obs_off):
    s1 = trace.span("fwd.column_group", group=3)
    s2 = trace.span("bwd.sampled_fold")
    assert s1 is _NULL_SPAN and s2 is _NULL_SPAN
    with s1 as s:
        s.set(bytes_moved=42)
        s.args = {"x": 1}
    trace.instant("fault.injected", site="x")
    assert trace.get_tracer().counts() == (0, 0)
    assert trace.add_span("x", 0.0, 1.0) == 0


def test_disabled_path_overhead_is_negligible(obs_off):
    assert metrics.stage("fwd.column_pass") is _NULL_STAGE
    for site in (trace.span, metrics.stage):
        assert _per_call_s(_enter_exit(site)) < 5e-6, site


def test_recorder_hot_path_under_5us(obs_off):
    recorder.enable(seconds=60.0)
    assert _per_call_s(
        lambda: recorder.record("stage", "fwd.column_pass", 0.001)) < 5e-6
    assert _per_call_s(_enter_exit(metrics.stage)) < 5e-6
    rec = recorder.get_recorder()
    assert len(rec._ring) == rec.capacity  # 200k events through the ring


def test_recorder_post_mortem_and_dump(obs_off, tmp_path):
    recorder.enable(seconds=60.0)
    with metrics.stage("fwd.column_pass"):
        pass
    recorder.record("fault", "fault.injected.bwd.feed", "kill call 3")
    recorder.record("degrade", "degrade.spill.disk_to_ram", "disk full")
    pm = recorder.post_mortem("WorkerKilled", reason="drill")
    assert pm["trigger"] == "WorkerKilled" and pm["reason"] == "drill"
    assert pm["by_kind"] == {"stage": 1, "fault": 1, "degrade": 1}
    # the readable tail leaves out stage events
    assert [e["kind"] for e in pm["events"]] == ["fault", "degrade"]
    path = tmp_path / "pm.jsonl"
    bundle = recorder.dump(path, "WorkerKilled")
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert lines[0]["kind"] == "post_mortem" and len(lines) == 4
    assert "fault.injected.bwd.feed" in (tmp_path / "pm.jsonl.txt").read_text()
    assert bundle["n_events"] == 3 and recorder.get_recorder().dumps == 1
    evs, mark = recorder.get_recorder().events_since(-1.0)
    assert len(evs) == 3
    assert recorder.get_recorder().events_since(mark)[0] == []


def test_span_nesting_builds_the_tree(global_trace):
    with trace.span("run", cat="run") as root:
        with trace.span("pass") as p:
            with trace.span("stage"):
                pass
        with trace.span("stage"):
            pass
    spans = report.build_tree(trace.export())
    by_id = {s["id"]: s for s in spans.values()}
    stages = [s for s in spans.values() if s["name"] == "stage"]
    assert len(spans) == 4
    assert by_id[root.id]["parent"] == 0
    assert by_id[p.id]["parent"] == root.id
    assert sorted(s["parent"] for s in stages) == sorted([p.id, root.id])
    assert by_id[root.id]["dur_s"] >= by_id[p.id]["dur_s"]


def test_context_propagates_across_threads_only_via_adopt(global_trace):
    seen = {}

    def worker(ctx):
        if ctx is not None:
            trace.adopt(ctx)
        with trace.span("worker.op") as s:
            pass
        seen[ctx] = s.parent

    with trace.span("run") as root:
        t1 = threading.Thread(target=worker, args=(trace.current(),))
        t1.start()
        t1.join()
        t2 = threading.Thread(target=worker, args=(None,))
        t2.start()
        t2.join()
    assert seen[root.id] == root.id
    assert seen[None] == 0


def test_instants_and_explicit_time_spans(global_trace):
    t0 = time.perf_counter()
    trace.instant("degrade.spill.disk_to_ram", cat="degrade", site="spill")
    tid = trace.JOURNEY_TID_BASE + 7
    root = trace.add_span("serve.journey", t0, t0 + 0.5, tid=tid,
                          request_id=7)
    trace.add_span("serve.journey.queue", t0, t0 + 0.2, tid=tid, parent=root)
    exported = trace.export()
    assert validate_trace_events(exported) == []
    phs = [e["ph"] for e in exported["traceEvents"]]
    assert "i" in phs and "X" in phs and "M" in phs
    names = {s["name"]: s for s in report.build_tree(exported).values()}
    assert names["serve.journey.queue"]["parent"] == root
    assert abs(names["serve.journey"]["dur_s"] - 0.5) < 1e-6


def test_stage_sites_emit_spans_with_registry_off(obs_off):
    trace.enable()
    assert not metrics.get_registry().enabled
    with trace.span("run"):
        with metrics.stage("fwd.column_pass", flops=123,
                           bytes_moved=45) as st:
            st.bytes_moved = 46
    names = {s["name"]: s for s in report.build_tree(trace.export()).values()}
    assert names["fwd.column_pass"]["parent"] == names["run"]["id"]
    assert names["fwd.column_pass"]["args"]["flops"] == 123
    assert names["fwd.column_pass"]["args"]["bytes_moved"] == 46
    assert metrics.export()["stages"] == {}


def test_stage_sites_feed_both_when_both_enabled(obs_off):
    trace.enable()
    metrics.enable()
    with metrics.stage("bwd.sampled_fold", flops=10):
        pass
    assert "bwd.sampled_fold" in metrics.export()["stages"]
    spans = report.build_tree(trace.export())
    assert {s["name"] for s in spans.values()} == {"bwd.sampled_fold"}


def test_hbm_gauge_fallback_stamps_spans(global_trace):
    trace.set_hbm_gauge(123456789)
    with trace.span("fwd.column_group"):
        pass
    (s,) = report.build_tree(trace.export()).values()
    assert s["args"]["hbm_peak_bytes"] == 123456789
    assert report.summarize_trace(trace.export())["hbm_peak_bytes"] == \
        123456789


def test_hbm_sampler_reads_the_cuda_allocator_only_on_cuda(monkeypatch):
    from swiftly_tpu_torch.obs.trace import _resolve_hbm_sampler

    assert _resolve_hbm_sampler("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _resolve_hbm_sampler() is None
    calls = []
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda device=None: calls.append(device) or 4096)
    sample = _resolve_hbm_sampler("cuda:0")
    assert sample() == 4096 and calls == [torch.device("cuda:0")]
    tr = Tracer()
    tr._hbm_sampler = sample
    reg = metrics.get_registry()
    reg.reset()
    reg.enable()
    try:
        tr.enable()
        with tr.span("fwd.column_group"):
            pass
        assert tr.export()["traceEvents"][-1]["args"]["hbm_peak_bytes"] == 4096
        assert metrics.export()["gauges_max"]["hbm.peak_bytes"] == 4096
    finally:
        reg.disable()
        reg.reset()


def test_gauge_max_keeps_the_peak():
    reg = MetricsRegistry(enabled=True)
    reg.gauge("serve.queue_depth", 5)
    reg.gauge_max("serve.queue_depth_peak", 5)
    reg.gauge_max("serve.queue_depth_peak", 17)
    reg.gauge_max("serve.queue_depth_peak", 3)
    reg.gauge("serve.queue_depth", 0)
    exp = reg.export()
    assert exp["gauges"]["serve.queue_depth"] == 0
    assert exp["gauges_max"]["serve.queue_depth_peak"] == 17
    reg.reset()
    assert reg.export()["gauges_max"] == {}
    off = MetricsRegistry()
    off.gauge_max("x", 9)
    assert off.export()["gauges_max"] == {}


def test_chrome_export_is_structurally_valid(tmp_path, global_trace):
    with trace.span("a"):
        pass
    path = tmp_path / "t.json"
    trace.save(path)
    loaded = report.load_trace(path)
    assert validate_trace_events(loaded) == []
    for e in loaded["traceEvents"]:
        if e["ph"] == "X":
            assert e["dur"] >= 0 and isinstance(e["pid"], int)
    assert loaded["otherData"]["n_spans"] == 1
    trace.save(path, atomic=True)
    assert json.loads(path.read_text())["otherData"]["n_spans"] == 1


def test_critical_path_and_self_time_partition():
    tr = Tracer(enabled=True)
    with tr.span("bench.leg", cat="bench", config="1k"):
        with tr.span("fwd.pass"):
            time.sleep(0.005)
            with tr.span("fwd.column_group"):
                time.sleep(0.030)
        with tr.span("bwd.pass"):
            time.sleep(0.001)
    tr.instant("fault.injected", site="spill.read")
    exported = tr.export()
    spans = report.build_tree(exported)
    summary = report.summarize_trace(exported)
    assert summary["root"] == "bench.leg"
    assert [c["name"] for c in summary["critical_path"]] == [
        "bench.leg", "fwd.pass", "fwd.column_group"]
    assert sum(report.self_times(spans).values()) == pytest.approx(
        summary["wall_s"], abs=1e-5)
    assert summary["top"][0]["name"] == "fwd.column_group"
    assert summary["event_count"] == 1


# ---------------------------------------------------------------------------
# The executors' stage contract (tests/test_obs.py:237-330)
# ---------------------------------------------------------------------------


def _round_trip_port():
    cfg = T.SwiftlyConfig(backend="planar", dtype=torch.float32, device="cpu",
                          **OBS_PARAMS)
    fcs = T.make_full_facet_cover(cfg)
    sgs = T.make_full_subgrid_cover(cfg)
    tasks = [(fc, T.make_facet(cfg.image_size, fc, OBS_SOURCES))
             for fc in fcs]
    fwd = T.StreamedForward(cfg, tasks, residency="device")
    bwd = T.StreamedBackward(cfg, fcs, residency="sampled", fold_group=2)
    T.feed_backward_passes(fwd, sgs, [bwd])
    return cfg, fcs, sgs, bwd.finish_device()


def _round_trip_jax():
    import jax

    import swiftly_tpu as J
    from swiftly_tpu.parallel import StreamedBackward, StreamedForward

    config = J.SwiftlyConfig(backend="planar", dtype=jax.numpy.float32,
                             **OBS_PARAMS)
    fcs = J.make_full_facet_cover(config)
    sgs = J.make_full_subgrid_cover(config)
    tasks = [(fc, J.make_facet(config.image_size, fc, OBS_SOURCES))
             for fc in fcs]
    fwd = StreamedForward(config, tasks, residency="device")
    bwd = StreamedBackward(config, fcs, residency="sampled", fold_group=2)
    for per_col, group in fwd.stream_column_groups(sgs):
        bwd.add_subgrid_group([[sg for _, sg in col] for col in per_col],
                              group)
    np.asarray(bwd.finish_device())


def test_streamed_round_trip_emits_expected_stages(tmp_path, obs_off):
    """The port's streamed round trip emits the JAX package's stage names
    (the same set, on the same round trip) with FLOPs on the compute
    stages, and the same subgrid counters; the JSONL log carries them."""
    from swiftly_tpu.obs import metrics as jmetrics

    metrics.enable(tmp_path / "stages.jsonl")
    cfg, fcs, sgs, facets = _round_trip_port()
    errs = [T.check_facet(cfg.image_size, fc, cfg.core.as_complex(facets[i]),
                          OBS_SOURCES) for i, fc in enumerate(fcs)]
    assert max(errs) < 5e-3
    exp = metrics.export()
    metrics.disable()
    jreg = jmetrics.get_registry()
    jreg.reset()
    jreg.enable()
    try:
        _round_trip_jax()
        jexp = jreg.export()
    finally:
        jreg.disable()
        jreg.reset()
    assert EXPECTED_STAGES <= set(exp["stages"]), sorted(exp["stages"])
    # the port's observed feed wall is the one stage the JAX package's
    # hand-written feed loop does not have
    assert set(exp["stages"]) - {"bwd.feed_group"} == set(jexp["stages"])
    for name in ("fwd.subgrids", "bwd.subgrids_folded"):
        assert exp["counters"][name] == jexp["counters"][name] == len(sgs)
    assert exp["gauges"]["fwd.plan"]["mode"] == "resident"
    for name in ("fwd.sampled_facet_pass", "fwd.column_pass",
                 "bwd.column_pass", "bwd.sampled_fold"):
        assert exp["stages"][name].get("flops", 0) > 0, name
    names = {r["name"] for r in map(
        json.loads, (tmp_path / "stages.jsonl").read_text().splitlines())
        if r.get("kind") == "stage"}
    assert EXPECTED_STAGES <= names


def test_streamed_disabled_emits_nothing(obs_off):
    _round_trip_port()
    exp = metrics.export()
    assert exp["stages"] == {} and exp["counters"] == {}
    assert trace.get_tracer().counts() == (0, 0)
    assert recorder.events() == []


def test_instrumentation_keeps_the_bits(obs_off, tmp_path):
    """Metrics, trace and recorder on: the same bits, and a span tree in
    which every stage nests under its column group or feed."""
    ref = _round_trip_port()[3]
    metrics.enable()
    trace.enable(tmp_path / "t.json", device="cpu")
    recorder.enable()
    got = _round_trip_port()[3]
    assert torch.equal(got, ref)
    exported = trace.export()
    assert validate_trace_events(exported) == []
    spans = report.build_tree(exported)
    by_name = {}
    for s in spans.values():
        by_name.setdefault(s["name"], []).append(s)
    groups = {s["id"] for s in by_name["fwd.column_group"]}
    feeds = {s["id"] for s in by_name["bwd.feed_group"]}
    for s in by_name["fwd.sampled_facet_pass"] + by_name["fwd.column_pass"]:
        assert s["parent"] in groups
    for s in by_name["bwd.column_pass"]:
        assert s["parent"] in feeds
    # a fold of the last pending columns runs in finish_device, after the
    # feed
    folds = [s["parent"] for s in by_name["bwd.sampled_fold"]]
    assert set(folds) <= feeds | {0} and set(folds) & feeds
    assert recorder.post_mortem("test")["by_kind"]["stage"] > 0
