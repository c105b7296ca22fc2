"""The port's incremental facet updates (``swiftly_tpu_torch.delta``), its
spill patch gate and the feed's counters, against the JAX package's
``tests/test_delta.py`` at ``1k[1]-n512-256`` (planar f32, sparse facets).

Held to the JAX package: the patched stream of both packages on the same
facets and the same mutation, each within 1e-4 (relative, the f32
sum-reorder bound) of its own fresh stream and the two within 1e-4 of each
other; the ledger's hex digests equal; the feed's ``spill.feed_stale`` /
``spill.feed_evictions`` counters equal on the same stale and evicted
lookups. The port's own contracts are the JAX package's cases: the exact
path bit-identical to the port's fresh forward, the ledger semantics, the
patch -> replay ladder, out-of-place patches, version pinning of feeds and
services, the fleet's update rollout and the plan's break-even.

Torch runs on one intra-op thread.
"""

import functools
import json
import threading

import numpy as np
import pytest
import torch

import swiftly_tpu_torch as T
from swiftly_tpu_torch.delta import (
    FacetDeltaLedger,
    IncrementalForward,
    config_hash,
    facet_delta,
    facet_hash,
)
from swiftly_tpu_torch.models.config import FacetConfig
from swiftly_tpu_torch.ops.oracle import SparseRealFacet
from swiftly_tpu_torch.utils.spill import SpillCache, StreamMidPatch

TEST_NAME = "1k[1]-n512-256"
# tests/test_delta.py:64: spread sources (fractions of N) so several facets
# carry content
_FRACTIONS = [
    (-0.41, -0.37), (-0.23, 0.11), (-0.05, 0.43), (0.02, -0.19),
    (0.17, 0.31), (0.29, -0.45), (0.36, 0.07), (0.44, -0.02),
]
REL_TOL = 1e-4  # tests/test_delta.py:73


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sources(N):
    return [(1.0 + 0.25 * i, int(a * N), int(b * N))
            for i, (a, b) in enumerate(_FRACTIONS)]


@functools.cache
def _jax_cover():
    import jax.numpy as jnp

    import swiftly_tpu as J

    params = dict(J.SWIFT_CONFIGS[TEST_NAME])
    params.setdefault("fov", 1.0)
    config = J.SwiftlyConfig(backend="planar", dtype=jnp.float32, **params)
    fcs = J.make_full_facet_cover(config)
    sgs = J.make_full_subgrid_cover(config)
    N = config.image_size
    tasks = [(fc, J.make_sparse_facet(N, fc, _sources(N), dtype=np.float32))
             for fc in fcs]
    return config, tasks, sgs


@functools.cache
def _cover():
    jconfig = _jax_cover()[0]
    params = dict(T.SWIFT_CONFIGS[TEST_NAME])
    params.setdefault("fov", 1.0)
    config = T.SwiftlyConfig.from_numpy_state(
        np.asarray(jconfig.core._Fb), np.asarray(jconfig.core._Fn),
        backend="planar", dtype=torch.float32, device="cpu", **params)
    fcs = T.make_full_facet_cover(config)
    sgs = T.make_full_subgrid_cover(config)
    N = config.image_size
    tasks = [(fc, T.make_sparse_facet(N, fc, _sources(N), dtype=np.float32))
             for fc in fcs]
    content = [j for j, (_, f) in enumerate(tasks) if f.vals.size]
    assert len(content) >= 2, "spread sources must land in >= 2 facets"
    return config, tasks, sgs, content


@pytest.fixture
def cover():
    return _cover()


def _mutate(tasks, idxs, scale, cls=SparseRealFacet):
    out = list(tasks)
    for j in idxs:
        fc, f = out[j]
        out[j] = (fc, cls(f.size, f.rows, f.cols,
                          np.asarray(f.vals) * np.float32(scale)))
    return out


@functools.cache
def _recorded():
    """One recording of the base stack (``record``'s own contract is held
    by the first test, which records for itself)."""
    config, tasks, sgs, _content = _cover()
    engine = IncrementalForward(config, tasks, SpillCache(budget_bytes=2**30))
    engine.record(sgs)
    return engine.spill


def _engine(cover):
    """An engine over a copy of the base recording: its entries are shared
    arrays, which a patch never writes (patches are out of place)."""
    config, tasks, sgs, _content = cover
    rec = _recorded()
    spill = SpillCache(budget_bytes=2**30)
    spill.begin_fill(tag=rec.tag)
    for k in range(len(rec)):
        spill.put(rec.meta(k), rec.get(k))
    assert spill.end_fill()
    engine = IncrementalForward(config, tasks, spill,
                                ledger=FacetDeltaLedger())
    engine._subgrid_configs = list(sgs)
    engine.ledger.commit(engine.facet_tasks)
    engine.ledger.stamp(spill)
    return engine


def _fresh_stream(config, tasks, sgs, fwd_cls=T.StreamedForward,
                  cache_cls=SpillCache):
    """An independent full stream of ``tasks``: the ground truth."""
    if fwd_cls is T.StreamedForward and config is _cover()[0]:
        return _fresh_port_stream(tuple(
            (config_hash(fc), facet_hash(f)) for fc, f in tasks), tasks)
    ref = cache_cls(budget_bytes=2**30)
    fwd = fwd_cls(config, tasks, residency="device")
    for _ in fwd.stream_column_groups(sgs, spill=ref):
        pass
    assert ref.complete
    return ref


_FRESH = {}


def _fresh_port_stream(key, tasks):
    """The port's fresh stream of a stack, computed once per content."""
    if key not in _FRESH:
        config, _tasks, sgs, _content = _cover()
        ref = SpillCache(budget_bytes=2**30)
        fwd = T.StreamedForward(config, tasks, residency="device")
        for _ in fwd.stream_column_groups(sgs, spill=ref):
            pass
        assert ref.complete
        _FRESH[key] = ref
    return _FRESH[key]


def _rows(spill):
    """input index -> recorded row, over a whole recorded stream."""
    out = {}
    for k in range(len(spill)):
        entry = np.asarray(spill.get(k))
        for c, col in enumerate(spill.meta(k)):
            for s, (i, _sg) in enumerate(col):
                out[int(i)] = entry[c, s]
    return out


def _max_rel_diff(a_rows, b_rows):
    assert a_rows.keys() == b_rows.keys()
    mx = max(float(np.max(np.abs(a_rows[i] - b_rows[i]))) for i in a_rows)
    sc = max(float(np.max(np.abs(b_rows[i]))) for i in b_rows)
    return mx / (sc or 1.0)


def _assert_streams_equal(a, b):
    assert len(a) == len(b)
    for k in range(len(a)):
        np.testing.assert_array_equal(np.asarray(a.get(k)),
                                      np.asarray(b.get(k)))


def _dense(tasks):
    return [(fc, f.densify()) for fc, f in tasks]


# ---------------------------------------------------------------------------
# Patch correctness and the exactness ladder
# ---------------------------------------------------------------------------


def test_patch_matches_full_recompute_and_the_jax_package(cover):
    """Both packages patch K = 1, then 2 facets: each patched stream within
    REL_TOL of its own fresh stream, and the two within REL_TOL of each
    other (rows matched by the cover's input index)."""
    import swiftly_tpu.delta as jdelta
    from swiftly_tpu.ops.oracle import SparseRealFacet as JSparse
    from swiftly_tpu.parallel import StreamedForward as JForward
    from swiftly_tpu.utils.spill import SpillCache as JSpill

    config, tasks, sgs, content = cover
    jconfig, jtasks, jsgs = _jax_cover()
    engine = IncrementalForward(config, tasks, SpillCache(budget_bytes=2**30))
    assert engine.record(sgs) == {"stream_version": 1, "entries": 1}
    _assert_streams_equal(engine.spill, _recorded())
    jengine = jdelta.IncrementalForward(jconfig, jtasks,
                                        JSpill(budget_bytes=2**30))
    jengine.record(jsgs)
    v0 = engine.ledger.version
    assert engine.spill.stream_version == v0
    for kk, scale in ((1, 1.75), (2, 0.6)):
        new = _mutate(engine.facet_tasks, content[:kk], scale)
        report = engine.update(new)
        assert report["mode"] == "patch", report
        assert report["changed_facets"] == content[:kk]
        assert report["patched_columns"] >= 1
        assert report["patched_entries"] >= 1
        assert report["stream_version"] == engine.ledger.version
        assert engine.spill.stream_version == engine.ledger.version
        assert set(report["timings"]) == {"compute_s", "d2h_s", "route_s",
                                          "delta_s", "patch_s"}
        jreport = jengine.update(
            _mutate(jengine.facet_tasks, content[:kk], scale, cls=JSparse))
        for key in ("mode", "changed_facets", "stream_version"):
            assert report[key] == jreport[key], key
        ref = _rows(_fresh_stream(config, engine.facet_tasks, sgs))
        jref = _rows(_fresh_stream(jconfig, jengine.facet_tasks, jsgs,
                                   JForward, JSpill))
        got, jgot = _rows(engine.spill), _rows(jengine.spill)
        assert _max_rel_diff(got, ref) <= REL_TOL
        assert _max_rel_diff(jgot, jref) <= REL_TOL
        assert _max_rel_diff(got, jgot) <= REL_TOL
    assert engine.ledger.version == v0 + 2
    assert engine.spill.counters["patches"] >= 1


def test_patch_routes_rows_by_input_index_across_groupings(cover):
    """A delta pass grouped unlike the recording routes every correction
    row by its input index: the patch still matches a fresh stream."""
    config, tasks, sgs, content = cover
    engine = IncrementalForward(config, tasks, SpillCache(budget_bytes=2**30),
                                col_group=3)
    engine.record(sgs)
    engine._col_group = 2  # the delta pass groups 2 columns, the record 3
    orig = engine._make_fwd
    engine._make_fwd = lambda t, col_group=None: orig(t)
    report = engine.update(_mutate(engine.facet_tasks, content[:1], 1.5))
    assert report["mode"] == "patch"
    ref = _rows(_fresh_stream(config, engine.facet_tasks, sgs))
    assert _max_rel_diff(_rows(engine.spill), ref) <= REL_TOL


def test_noop_and_exact_updates(cover):
    config, _tasks, sgs, content = cover
    engine = _engine(cover)
    v0 = engine.ledger.version
    # identical content in fresh descriptors: nothing changed
    report = engine.update(_mutate(engine.facet_tasks, content[:1], 1.0))
    assert report["mode"] == "noop"
    assert report["reason"] == "no_facets_changed"
    assert engine.ledger.version == v0
    # exact mode: a full replay, bit-identical to the port's fresh stream
    report = engine.update(_mutate(engine.facet_tasks, content[:1], 3.0),
                           exact=True)
    assert report["mode"] == "replay"
    assert report["reason"] == "exact_mode"
    _assert_streams_equal(engine.spill,
                          _fresh_stream(config, engine.facet_tasks, sgs))


def test_exact_env_var_forces_replay(cover, monkeypatch):
    content = cover[3]
    engine = _engine(cover)
    monkeypatch.setenv("SWIFTLY_DELTA_EXACT", "1")
    report = engine.update(_mutate(engine.facet_tasks, content[:1], 2.2))
    assert report["mode"] == "replay"
    assert report["reason"] == "exact_mode"


def test_update_before_record_raises(cover):
    config, tasks, _sgs, _content = cover
    engine = IncrementalForward(config, tasks, SpillCache(budget_bytes=2**30))
    with pytest.raises(ValueError, match="record"):
        engine.update(tasks)


# ---------------------------------------------------------------------------
# Ledger semantics and digests
# ---------------------------------------------------------------------------


def test_ledger_commit_idempotent_and_change_detection():
    a = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    b = np.ones((3, 4), np.float32)
    ledger = FacetDeltaLedger()
    assert ledger.version == 0
    assert ledger.n_facets is None
    assert ledger.commit([(None, a), (None, b)]) == 1
    assert ledger.commit([(None, a.copy()), (None, b.copy())]) == 1
    assert ledger.changed([(None, a), (None, b)]) == []
    a2 = a.copy()
    a2[1, 2] += 1e-3
    assert ledger.changed([(None, a2), (None, b)]) == [0]
    assert ledger.commit([(None, a2), (None, b)]) == 2
    assert ledger.n_facets == 2
    assert ledger.as_dict() == {"version": 2, "n_facets": 2}


def test_ledger_digests_equal_the_jax_package():
    """SHA-256 over the same numpy bytes: the same hex digests, for dense
    planes, torch tensors (as their host bytes), sparse descriptors,
    callables and facet configs (masks realised or as slice lists)."""
    from swiftly_tpu.delta import config_hash as jconfig_hash
    from swiftly_tpu.delta import facet_hash as jfacet_hash
    from swiftly_tpu.models.config import FacetConfig as JFacetConfig
    from swiftly_tpu.ops.oracle import SparseRealFacet as JSparse

    rng = np.random.default_rng(7)
    dense = rng.standard_normal((6, 5)).astype(np.float32)
    assert facet_hash(dense) == jfacet_hash(dense)
    assert facet_hash(torch.from_numpy(dense)) == jfacet_hash(dense)
    assert facet_hash(lambda: dense) == jfacet_hash(dense)
    rows, cols = rng.integers(0, 64, 9), rng.integers(0, 64, 9)
    vals = rng.standard_normal(9).astype(np.float32)
    assert (facet_hash(SparseRealFacet(64, rows, cols, vals))
            == jfacet_hash(JSparse(64, rows, cols, vals)))
    mask = rng.integers(0, 2, 16).astype(float)
    for args in ((0, 0, 16), (3, 5, 16)):
        for kw in ({}, {"mask0": mask}, {"mask1": [[slice(2, 9)], 16]}):
            assert (config_hash(FacetConfig(*args, **kw))
                    == jconfig_hash(JFacetConfig(*args, **kw)))
    assert config_hash(None) == jconfig_hash(None)
    jtasks = _jax_cover()[1]
    assert ([facet_hash(f) for _, f in _cover()[1]]
            == [jfacet_hash(f) for _, f in jtasks])
    assert ([config_hash(fc) for fc, _ in _cover()[1]]
            == [jconfig_hash(fc) for fc, _ in jtasks])


def test_ledger_edge_cases():
    a = np.ones((2, 2), np.float32)
    ledger = FacetDeltaLedger()
    with pytest.raises(ValueError, match="no committed facet stack"):
        ledger.changed([(None, a)])
    ledger.commit([(None, a)])
    with pytest.raises(ValueError, match="facet count changed"):
        ledger.changed([(None, a), (None, a)])
    assert facet_hash(lambda: a.copy()) == facet_hash(a)
    assert facet_hash(a) != facet_hash(a.astype(np.float64))


def test_ledger_empty_sparse_facet_scaling_is_no_change():
    empty = SparseRealFacet(64, np.array([], dtype=np.int64),
                            np.array([], dtype=np.int64),
                            np.array([], dtype=np.float32))
    scaled = SparseRealFacet(64, empty.rows, empty.cols,
                             np.asarray(empty.vals) * np.float32(7.0))
    ledger = FacetDeltaLedger()
    ledger.commit([(None, empty)])
    assert ledger.changed([(None, scaled)]) == []


def test_facet_delta_shapes_and_sparse_exactness():
    old = SparseRealFacet(32, np.array([1, 3]), np.array([2, 2]),
                          np.array([1.0, 2.0], np.float32))
    new = SparseRealFacet(32, np.array([1, 5]), np.array([2, 9]),
                          np.array([4.0, 0.5], np.float32))
    d = facet_delta(old, new)
    np.testing.assert_array_equal(d.densify(),
                                  new.densify() - old.densify())
    with pytest.raises(ValueError, match="size changed"):
        facet_delta(old, SparseRealFacet(64, new.rows, new.cols, new.vals))
    with pytest.raises(ValueError, match="shape changed"):
        facet_delta(np.ones((2, 2)), np.ones((3, 3)))
    # dense and torch operands: new - old on the host
    a, b = np.ones((2, 2)), torch.full((2, 2), 3.0, dtype=torch.float64)
    np.testing.assert_array_equal(facet_delta(a, b), np.full((2, 2), 2.0))
    np.testing.assert_array_equal(facet_delta(old, new.densify()),
                                  new.densify() - old.densify())


def test_ledger_versions_config_changes():
    a = np.ones((4, 4), np.float32)
    ledger = FacetDeltaLedger()
    ledger.commit([(FacetConfig(0, 0, 4), a)])
    assert ledger.changed([(FacetConfig(0, 0, 4), a.copy())]) == []
    assert ledger.config_changed([(FacetConfig(0, 0, 4), a)]) == []
    moved = FacetConfig(8, 0, 4)
    assert ledger.changed([(moved, a)]) == [0]
    assert ledger.config_changed([(moved, a)]) == [0]
    v = ledger.version
    assert ledger.commit([(moved, a)]) == v + 1
    sl = FacetConfig(0, 0, 4, mask0=[[slice(1, 3)], 4])
    realised = FacetConfig(0, 0, 4, mask0=np.asarray(sl.mask0).copy())
    assert config_hash(sl) == config_hash(realised)
    flipped = np.asarray(sl.mask0).copy()
    flipped[0] = 1 - flipped[0]
    assert config_hash(FacetConfig(0, 0, 4, mask0=flipped)) != config_hash(sl)


# ---------------------------------------------------------------------------
# The patch gate and the degradation ladder
# ---------------------------------------------------------------------------


def test_patch_failure_degrades_to_replay(cover, monkeypatch):
    from swiftly_tpu_torch.resilience import degrade, faults

    config, _tasks, sgs, content = cover
    monkeypatch.setenv("SWIFTLY_RETRY_MAX", "1")
    engine = _engine(cover)
    degrade.reset()
    new = _mutate(engine.facet_tasks, content[:1], 2.5)
    plan = faults.FaultPlan(
        [{"site": "spill.write", "kind": "ioerror", "every": 1}])
    with faults.active(plan):
        report = engine.update(new)
    assert report["mode"] == "replay"
    assert report["reason"] == "patch_failed"
    assert any(e["site"] == "delta" and e["action"] == "patch_to_replay"
               for e in degrade.events())
    assert plan.injected
    _assert_streams_equal(engine.spill,
                          _fresh_stream(config, engine.facet_tasks, sgs))


def test_patch_entry_retry_is_idempotent_and_out_of_place():
    from swiftly_tpu_torch.resilience import faults

    spill = SpillCache(budget_bytes=2**20, spill_dir=None)
    spill.begin_fill(tag="patch-idempotency")
    base = np.arange(16.0, dtype=np.float32).reshape(4, 4)
    assert spill.put([[(0, None)]], base.copy())
    assert spill.end_fill()
    d = np.full((4, 4), 0.25, np.float32)
    spill.patch_entry(0, d)
    mid = spill._entries[0][1]  # a concurrent reader's view
    mid_copy = np.array(mid)
    plan = faults.FaultPlan(
        [{"site": "spill.write", "kind": "ioerror", "at": 0}])
    with faults.active(plan):
        spill.patch_entry(0, d)  # fails once, retried
    assert plan.injected
    np.testing.assert_array_equal(mid, mid_copy)
    np.testing.assert_array_equal(spill.get(0), base + d + d)
    with pytest.raises(ValueError, match="patch shape"):
        spill.patch_entry(0, np.zeros((2, 2), np.float32))


def test_patch_entry_rewrites_a_disk_entry_through_rename(tmp_path):
    spill = SpillCache(budget_bytes=0, spill_dir=str(tmp_path))
    spill.begin_fill(tag="disk-patch")
    base = np.arange(24.0, dtype=np.float32).reshape(2, 3, 4)
    assert spill.put([[(0, None)], [(1, None)]], base.copy())
    assert spill.end_fill() and spill._entries[0][0] == "disk"
    assert spill.entry_shape(0) == (2, 3, 4)
    d = np.full((2, 3, 4), 0.5, np.float32)
    spill.patch_entry(0, d)
    np.testing.assert_array_equal(spill.get(0), base + d)
    np.testing.assert_array_equal(spill.get_row(0, (1, 2)), (base + d)[1, 2])
    assert not list(tmp_path.rglob("*.tmp"))
    assert spill.stats()["patches"] == 1


def test_read_gate_bounces_readers_and_drains_before_the_patch():
    """Reads that race ``begin_patch`` raise `StreamMidPatch` (a
    LookupError); the patcher's own thread passes; ``begin_patch`` waits
    for an in-flight read to finish."""
    spill = SpillCache(budget_bytes=2**20, spill_dir=None)
    spill.begin_fill()
    spill.put([[(0, None)]], np.zeros((1, 1, 2), np.float32))
    spill.end_fill()
    events = []
    in_read, release = threading.Event(), threading.Event()

    def slow_reader():
        with spill._read_gate():
            in_read.set()
            release.wait(5)
            events.append("read done")

    reader = threading.Thread(target=slow_reader)
    reader.start()
    in_read.wait(5)
    patcher = threading.Thread(
        target=lambda: (spill.begin_patch(), events.append("patching")))
    patcher.start()
    patcher.join(0.2)
    assert events == []  # the patch waits for the in-flight read
    release.set()
    reader.join(5)
    patcher.join(5)
    assert events == ["read done", "patching"]
    assert spill.patching
    with pytest.raises(StreamMidPatch):
        spill.get_row(0, (0, 0))
    assert issubclass(StreamMidPatch, LookupError)
    spill.end_patch()
    assert spill.get_row(0, (0, 0)).shape == (2,)
    # the patcher's own thread reads inside its window
    spill.begin_patch()
    spill.patch_entry(0, np.ones((1, 1, 2), np.float32))
    spill.end_patch()
    np.testing.assert_array_equal(spill.get(0), np.ones((1, 1, 2)))


def test_replay_overflow_raises_before_commit(cover):
    _config, _tasks, sgs, content = cover
    engine = _engine(cover)
    v0 = engine.ledger.version
    feed = engine.feed()
    engine.spill.budget_bytes = 0
    engine.spill.spill_dir = None
    with pytest.raises(RuntimeError, match="did not fit"):
        engine.update(_mutate(engine.facet_tasks, content[:1], 2.0),
                      exact=True)
    assert engine.ledger.version == v0
    assert engine.spill.complete is False
    assert engine.spill.patching is False
    with pytest.raises(LookupError, match="no longer complete"):
        feed.lookup(sgs[0])
    assert feed.evicted == 1


def test_engine_replays_on_config_change(cover):
    config, _tasks, sgs, content = cover
    engine = _engine(cover)
    j = content[0]
    fc, data = engine.facet_tasks[j]
    m = np.asarray(fc.mask0).copy()
    m[: len(m) // 4] = 0.0
    new = list(engine.facet_tasks)
    new[j] = (FacetConfig(fc.off0, fc.off1, fc.size, mask0=m,
                          mask1=fc._mask1), data)
    report = engine.update(new)
    assert report["mode"] == "replay"
    assert report["reason"] == "facet_config_changed"
    assert j in report["changed_facets"]
    _assert_streams_equal(engine.spill,
                          _fresh_stream(config, engine.facet_tasks, sgs))


# ---------------------------------------------------------------------------
# Version pinning: feeds, their counters, and the serve path
# ---------------------------------------------------------------------------


def test_feed_refuses_mid_patch(cover, monkeypatch):
    _config, _tasks, sgs, content = cover
    engine = _engine(cover)
    feed = engine.feed()
    assert feed.lookup(sgs[0]) is not None
    observed = {"patches": 0, "refused": 0}
    orig = SpillCache.patch_entry

    def guarded(self, k, delta):
        observed["patches"] += 1
        assert self.patching, "patch_entry must run inside begin_patch"
        with pytest.raises(LookupError, match="mid-update"):
            feed.lookup(sgs[0])
        observed["refused"] += 1
        return orig(self, k, delta)

    monkeypatch.setattr(SpillCache, "patch_entry", guarded)
    report = engine.update(_mutate(engine.facet_tasks, content[:1], 1.3))
    assert report["mode"] == "patch"
    assert observed["patches"] >= 1
    assert observed["refused"] == observed["patches"]
    assert engine.spill.patching is False
    with pytest.raises(LookupError, match="stream version moved"):
        feed.lookup(sgs[0])
    assert engine.feed().lookup(sgs[0]) is not None


def test_stale_feed_refuses_after_update(cover):
    _config, _tasks, sgs, content = cover
    engine = _engine(cover)
    feed = engine.feed()
    assert feed.lookup(sgs[0]) is not None
    engine.update(_mutate(engine.facet_tasks, content[:1], 1.4))
    with pytest.raises(LookupError, match="stream version moved"):
        feed.lookup(sgs[0])
    assert feed.stale == 1
    feed2 = engine.feed()
    assert feed2.stream_version == engine.spill.stream_version
    assert feed2.lookup(sgs[0]) is not None


def test_feed_counters_match_the_jax_package():
    """The same mid-patch, stale-version, evicted-entry and dropped-stream
    lookups count the same ``spill.feed_*`` metrics and attributes in both
    packages."""
    from swiftly_tpu.obs import metrics as jmetrics
    from swiftly_tpu.parallel.streamed import CachedColumnFeed as JFeed
    from swiftly_tpu.utils.spill import SpillCache as JSpill
    from swiftly_tpu_torch.obs import metrics as tmetrics
    from swiftly_tpu_torch.parallel.streamed import CachedColumnFeed

    class _Sg:
        def __init__(self, off1):
            self.off0, self.off1, self.size = 0, off1, 2
            self.mask0 = self.mask1 = None

    def drive(spill_cls, feed_cls, metrics):
        metrics.reset()
        metrics.enable()
        try:
            spill = spill_cls(budget_bytes=2**20, spill_dir=None)
            spill.begin_fill()
            spill.put([[(0, _Sg(0)), (1, _Sg(2))]],
                      np.zeros((1, 2, 2, 2, 2), np.float32))
            spill.end_fill()
            feed = feed_cls(spill)
            assert feed.lookup(_Sg(0)) is not None          # hit
            assert feed.lookup(_Sg(9)) is None              # miss
            spill.begin_patch()
            with pytest.raises(LookupError):                # mid-patch
                feed.lookup(_Sg(0))
            spill.end_patch()
            spill.stream_version += 1
            with pytest.raises(LookupError):                # stale
                feed.lookup(_Sg(0))
            feed = feed_cls(spill)
            spill._entries[0] = ("disk", "/nonexistent/entry.npy")
            with pytest.raises(LookupError):                # evicted
                feed.lookup(_Sg(2))
            spill.complete = False
            with pytest.raises(LookupError):                # dropped
                feed.lookup(_Sg(0))
            counters = {k: v for k, v in metrics.export()["counters"].items()
                        if k.startswith("spill.feed_")}
            return counters, (feed.hits, feed.misses, feed.stale,
                              feed.evicted)
        finally:
            metrics.disable()
            metrics.reset()

    import os
    os.environ["SWIFTLY_RETRY_MAX"] = "1"
    try:
        got = drive(SpillCache, CachedColumnFeed, tmetrics)
        want = drive(JSpill, JFeed, jmetrics)
    finally:
        del os.environ["SWIFTLY_RETRY_MAX"]
    assert got == want
    assert got[0]["spill.feed_stale"] == 2
    assert got[0]["spill.feed_evictions"] == 2


def test_serve_version_pinning_after_facet_update(cover):
    config, _tasks, sgs, content = cover
    engine = _engine(cover)
    svc = T.SubgridService(T.SwiftlyForward(config, _dense(engine.facet_tasks)),
                           cache_feed=engine.feed())
    sg = sgs[0]
    pre = svc.serve([sg])
    assert pre[0].result.ok and pre[0].result.path == "cache"
    pre_row = np.array(pre[0].result.data)
    inflight = svc.submit(sg)
    report = svc.post_facet_update(
        engine, _mutate(engine.facet_tasks, content[:1], 2.0))
    assert report["mode"] == "patch"
    assert inflight.result is not None and inflight.result.ok
    np.testing.assert_array_equal(np.asarray(inflight.result.data), pre_row)
    stats = svc.stats()
    assert stats["facet_updates"] == 1
    assert stats["stream_version"] == engine.ledger.version
    post = svc.serve([sg])
    assert post[0].result.ok and post[0].result.path == "cache"
    post_row = np.asarray(post[0].result.data)
    assert not np.array_equal(post_row, pre_row)
    ref = _rows(_fresh_stream(config, engine.facet_tasks, sgs))[0]
    scale = float(np.max(np.abs(ref))) or 1.0
    assert float(np.max(np.abs(post_row - ref))) <= REL_TOL * scale


def test_service_compute_fallback_serves_new_stack_after_update(cover):
    config, _tasks, sgs, content = cover
    engine = _engine(cover)
    svc = T.SubgridService(T.SwiftlyForward(config, _dense(engine.facet_tasks)),
                           cache_feed=engine.feed())
    sg = sgs[0]
    old_row = np.array(np.asarray(svc.serve([sg])[0].result.data))
    report = svc.post_facet_update(
        engine, _mutate(engine.facet_tasks, content[:1], 2.0))
    assert report["mode"] == "patch"
    req = svc.submit(sg)
    req.stream_version = 99  # force the compute path
    svc.pump_once()
    assert req.result is not None and req.result.ok
    assert req.result.path != "cache"
    got = req.result.data.numpy()
    ref = T.SwiftlyForward(config, _dense(engine.facet_tasks)
                           ).get_subgrid_tasks([sg])[0].numpy()
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, old_row)


def test_fleet_post_facet_update_rolls_every_replica(cover):
    config, _tasks, sgs, content = cover
    engine = _engine(cover)

    def factory(_rid):
        return T.SubgridService(
            T.SwiftlyForward(config, _dense(engine.facet_tasks)),
            cache_feed=engine.feed())

    fleet = T.ServeFleet(factory, n_replicas=2)
    report = fleet.post_facet_update(
        engine, _mutate(engine.facet_tasks, content[:1], 2.0))
    assert report["mode"] == "patch"
    j = content[0]
    expected = engine.facet_tasks[j][1].densify()
    feeds = set()
    for replica in fleet.replicas.values():
        svc = replica.service
        assert svc.stream_version == engine.ledger.version
        assert svc.cache_feed.stream_version == engine.ledger.version
        feeds.add(id(svc.cache_feed))
        data = svc.fwd._facet_data[j]
        np.testing.assert_array_equal(data() if callable(data) else data,
                                      expected)
        served = svc.serve([sgs[0]])[0]
        assert served.result.ok and served.result.path == "cache"
    assert len(feeds) == 2


def test_serve_version_mismatch_falls_back_to_compute(cover):
    config, _tasks, sgs, _content = cover
    engine = _engine(cover)
    svc = T.SubgridService(T.SwiftlyForward(config, _dense(engine.facet_tasks)),
                           cache_feed=engine.feed())
    req = svc.submit(sgs[0])
    req.stream_version = 99
    svc.pump_once()
    assert req.result is not None and req.result.ok
    assert req.result.path != "cache"
    assert svc.stats()["version_fallbacks"] == 1


def test_sparse_cover_columns_shed_outside_cover(cover):
    from swiftly_tpu_torch.serve import STATUS_SHED

    config, _tasks, sgs, _content = cover
    engine = _engine(cover)
    off0s = sorted({sg.off0 for sg in sgs})
    covered = off0s[: max(1, int(len(off0s) * 0.6))]
    svc = T.SubgridService(T.SwiftlyForward(config, _dense(engine.facet_tasks)),
                           cache_feed=engine.feed(), cover_columns=covered)
    inside = [sg for sg in sgs if sg.off0 == covered[0]][:2]
    outside = [sg for sg in sgs if sg.off0 not in set(covered)][:2]
    assert inside and outside
    for r in svc.serve(inside):
        assert r.result is not None and r.result.ok, r.result
    for sg in outside:
        req = svc.submit(sg)
        assert req.result.status == STATUS_SHED
        assert req.result.shed_reason == "outside_cover"
    stats = svc.stats()
    assert stats["n_shed"] == len(outside)
    assert stats["shed_reasons"]["outside_cover"] == len(outside)


def test_sparse_facets_served_by_swiftly_forward_as_dense(cover):
    """`SwiftlyForward` takes sparse descriptors (densified when their
    facet is prepared): the same subgrids as from their dense planes."""
    config, tasks, sgs, _content = cover
    a = T.SwiftlyForward(config, tasks).get_subgrid_tasks(sgs[:3])
    b = T.SwiftlyForward(config, _dense(tasks)).get_subgrid_tasks(sgs[:3])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# Planning and checkpoint meta
# ---------------------------------------------------------------------------


def test_plan_delta_break_even_monotone():
    from swiftly_tpu_torch.plan import PlanInputs, plan_delta

    inputs = PlanInputs.from_config(TEST_NAME)
    n = int(inputs.n_facets)
    p1 = plan_delta(inputs, 1)
    assert p1.mode == "patch"
    assert p1.predicted_wall_s < p1.full_wall_s
    pn = plan_delta(inputs, n)
    assert pn.mode == "full"
    assert 1 < p1.break_even_k <= n + 1
    walls = [plan_delta(inputs, k).predicted_wall_s for k in range(1, n + 1)]
    assert walls == sorted(walls)


def test_engine_report_carries_plan(cover):
    content = cover[3]
    engine = _engine(cover)
    report = engine.update(_mutate(engine.facet_tasks, content[:1], 1.1))
    plan = report["plan"]
    assert plan is not None and plan["mode"] == "patch"
    assert plan["changed_facets"] == 1
    # use_plan=False skips the pricing
    report = engine.update(_mutate(engine.facet_tasks, content[:1], 1.2),
                           use_plan=False)
    assert report["mode"] == "patch" and report["plan"] is None


def test_checkpoint_meta_stream_version(cover, tmp_path):
    from swiftly_tpu_torch.utils.checkpoint import save_streamed_backward_state

    config = cover[0]
    facet_configs = T.make_full_facet_cover(config)

    def saved_meta(bwd, path):
        save_streamed_backward_state(path, bwd, [])
        with np.load(path) as data:
            return json.loads(bytes(data["meta"].tobytes()).decode())

    bwd = T.StreamedBackward(config, facet_configs, residency="sampled")
    assert saved_meta(bwd, tmp_path / "ck0.npz")["stream_version"] == 0
    bwd.stream_version = 5
    assert saved_meta(bwd, tmp_path / "ck5.npz")["stream_version"] == 5
