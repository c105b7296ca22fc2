"""The port's visibility path as a whole: the tap table, sample mapping,
serving, gridding and the gridded ingest, against the JAX package's
``swiftly_tpu.vis`` at ``tests/test_vis.py``'s geometry (N = 256, yB 96,
yN 128, xA 56, xM 64, planar float32).

Both packages get the same numpy inputs: facets from the grid-corrected
sky model, the same (u, v) traffic from a seed, the same visibilities to
grid. The port's configuration takes the JAX core's window constants
(``SwiftlyConfig.from_numpy_state``) and runs on the CPU, where kernel B4
and its adjoint run their plain versions. Bounds:

* the tap table and the sample mapping (owners, indices, fractions, shed
  list and the owners' key order) are equal, exactly;
* served samples agree to 1e-5 relative RMS (float32 rows, summed in
  another order), and both meet ``DEGRID_TOLERANCE`` against the
  direct-DFT oracle; the serving counts and shed reasons are equal;
* gridded facets agree to 1e-5 relative once the facet window Fb is
  divided out of both (ROADMAP §C: the backward multiplies each facet row
  and column by Fb, which amplifies rounding at the facet edges);
* within the port, cache-fed and computed rows, and coalesced and combined
  submits, give bit-identical samples.

Each package's serving run is computed once per module; torch runs on one
intra-op thread.
"""

import functools

import numpy as np
import pytest
import torch

import swiftly_tpu as J
import swiftly_tpu_torch as T
from swiftly_tpu import vis as jvis
from swiftly_tpu.parallel.streamed import CachedColumnFeed as JFeed
from swiftly_tpu.parallel.streamed import StreamedBackward as JBackward
from swiftly_tpu.serve import AdmissionQueue as JQueue
from swiftly_tpu.serve import CoalescingScheduler as JScheduler
from swiftly_tpu.utils.spill import SpillCache as JSpill
from swiftly_tpu_torch import serve as tserve
from swiftly_tpu_torch import vis as tvis
from swiftly_tpu_torch.parallel.streamed import CachedColumnFeed
from swiftly_tpu_torch.utils.spill import DEFAULT_BUDGET_BYTES, SpillCache

TEST_PARAMS = {
    "W": 8.0,
    "fov": 1.0,
    "N": 256,
    "yB_size": 96,
    "yN_size": 128,
    "xA_size": 56,
    "xM_size": 64,
}
# inside 0.9 x the kernel band edge (band * N / 2 = 96 here)
SOURCES = [(1.0, 40, 20), (0.6, -30, 50), (0.3, 10, -60)]
REL = 1e-5

# each package's names for the serving path
PKGS = {
    "jax": dict(vis=jvis, Spill=JSpill, Feed=JFeed, Queue=JQueue,
                Scheduler=JScheduler),
    "port": dict(vis=tvis, Spill=SpillCache, Feed=CachedColumnFeed,
                 Queue=tserve.AdmissionQueue,
                 Scheduler=tserve.CoalescingScheduler),
}
# the serving counts both packages must agree on (latencies differ)
COUNTS = ("n_requests", "n_samples", "n_served", "n_served_samples",
          "n_shed", "n_shed_samples", "n_expired", "n_batches",
          "cache_hits", "cache_fallbacks", "version_fallbacks",
          "stream_version", "facet_updates", "shed_rate", "shed_reasons",
          "coalesce_hit_rate", "mean_batch")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _jax_cover():
    import jax.numpy as jnp

    kernel = jvis.vis_kernel()
    config = J.SwiftlyConfig(backend="planar", dtype=jnp.float32,
                             **TEST_PARAMS)
    N = config.image_size
    corrected = kernel.correct_sources(SOURCES, N)
    fcs = J.make_full_facet_cover(config)
    tasks = [(fc, J.make_facet(N, fc, corrected)) for fc in fcs]
    return config, fcs, tasks, J.make_full_subgrid_cover(config)


@functools.cache
def _port_cover():
    jconfig, _, jtasks, _ = _jax_cover()
    config = T.SwiftlyConfig.from_numpy_state(
        np.asarray(jconfig.core._Fb), np.asarray(jconfig.core._Fn),
        backend="planar", dtype=torch.float32, device="cpu", **TEST_PARAMS)
    fcs = T.make_full_facet_cover(config)
    tasks = [(fc, d) for fc, (_, d) in zip(fcs, jtasks)]
    return config, fcs, tasks, T.make_full_subgrid_cover(config)


def _cover(pkg):
    return _jax_cover() if pkg == "jax" else _port_cover()


def _forward(pkg):
    config, _, tasks, _ = _cover(pkg)
    mod = J if pkg == "jax" else T
    return mod.SwiftlyForward(config, tasks, lru_forward=2, queue_size=64)


def _host_row(row):
    return row.cpu().numpy() if isinstance(row, torch.Tensor) else \
        np.asarray(row)


def _seed_feed(pkg, fwd, col_sgs):
    """A cache feed holding one column's rows, recorded through the same
    per-subgrid program the compute fallback uses."""
    names = PKGS[pkg]
    rows = [_host_row(fwd.get_subgrid_task(sg)) for sg in col_sgs]
    spill = names["Spill"](budget_bytes=2**30)
    spill.begin_fill(tag=("vis-test-seed", len(col_sgs)))
    spill.put([list(enumerate(col_sgs))], np.stack(rows)[None])
    spill.end_fill()
    return spill, names["Feed"](spill)


def _interior_uv(sgs, n, seed):
    """n in-cover samples: uniform in subgrid interiors, filtered through
    the cover index (the overlap cover's mask-1 runs are narrower than the
    spans)."""
    rng = np.random.default_rng(seed)
    kernel = tvis.vis_kernel()
    index = tvis.VisCoverIndex(sgs, kernel.support, TEST_PARAMS["N"])
    margin = kernel.support + 1
    out = []
    while len(out) < n:
        sg = sgs[rng.integers(len(sgs))]
        half = sg.size / 2.0 - margin
        uv = np.array([[sg.off0 + rng.uniform(-half, half),
                        sg.off1 + rng.uniform(-half, half)]])
        if not index.map_samples(uv)[1]:
            out.append(uv[0])
    return np.asarray(out)


def _zipf_uv(sgs, n, seed, zipf_s=1.1):
    """Zipf-over-columns traffic with a 10% uniform tail (the reference
    benchmark's ``_vis_zipf_uv``): returns (uv, hottest column's off0)."""
    rng = np.random.default_rng(seed)
    N = TEST_PARAMS["N"]
    margin = tvis.vis_kernel().support + 1
    cols = sorted({sg.off0 for sg in sgs})
    by_col = {}
    for sg in sgs:
        by_col.setdefault(sg.off0, []).append(sg)
    order = rng.permutation(len(cols))
    ranks = np.empty(len(cols), dtype=int)
    ranks[order] = np.arange(len(cols))
    p = 1.0 / (ranks + 1.0) ** zipf_s
    p /= p.sum()
    n_tail = n // 10
    uv = np.empty((n, 2))
    for i, c in enumerate(rng.choice(len(cols), size=n - n_tail, p=p)):
        col = by_col[cols[c]]
        sg = col[rng.integers(len(col))]
        half = sg.size / 2.0 - margin
        uv[i] = (sg.off0 + rng.uniform(-half, half),
                 sg.off1 + rng.uniform(-half, half))
    uv[n - n_tail:] = rng.uniform(0, N, size=(n_tail, 2))
    return uv, cols[int(np.argmax(p))]


@functools.cache
def _serving_run(pkg):
    """The same traffic through each package's VisibilityService: a cache
    feed on the hottest column, an overload burst past the queue depth, an
    outside-cover batch, a forced eviction of the feed, and zipf batches
    drained after every second one. Returns (stats, [(uv, data)], the
    cover's configs, the service)."""
    names = PKGS[pkg]
    vis = names["vis"]
    sgs = _cover(pkg)[3]
    uv_all, hot_off0 = _zipf_uv(sgs, 600, seed=1234)
    hot_col = [sg for sg in sgs if sg.off0 == hot_off0]
    fwd = _forward(pkg)
    spill, feed = _seed_feed(pkg, fwd, hot_col)
    service = vis.VisibilityService(
        fwd, subgrid_configs=sgs, kernel=vis.vis_kernel(), cache_feed=feed,
        queue=names["Queue"](max_depth=16),
        scheduler=names["Scheduler"](max_batch=8, urgency_s=0.05),
    )
    rng = np.random.default_rng(1235)
    tracked = []
    hot_pt = np.array([[hot_col[0].off0 + 0.3, hot_col[0].off1 + 0.3]])
    for _ in range(24):  # 1.5x the depth, no pump between them
        tracked.append((hot_pt, service.submit(hot_pt)))
    while service.pump_once():
        pass
    cols = sorted({sg.off0 for sg in sgs})
    border = (cols[0] + cols[1]) / 2.0
    uv_outside = np.array([[border + 0.25, hot_off0],
                           [border - 0.25, hot_off0]])
    pending = 0
    for k in range(6):
        if k == 1:
            tracked.append((uv_outside, service.serve(uv_outside)))
        if k == 3:
            spill.reset()  # forced eviction: the feed's index dangles
        b = uv_all[k * 100:(k + 1) * 100]
        tracked.append((b, service.submit(
            b, priority=int(rng.integers(0, 4)))))
        pending += 1
        if pending >= 2 or k == 5:
            while service.pump_once():
                pass
            pending = 0
    assert len(service.queue) == 0
    return service.stats(), tracked, sgs, service


def _served(tracked):
    uv, data = [], []
    for uv_b, h in tracked:
        m = np.isfinite(h.data)
        uv.append(np.atleast_2d(uv_b)[m])
        data.append(h.data[m])
    return np.concatenate(uv), np.concatenate(data)


# ---------------------------------------------------------------------------
# Host precompute: the tap table and the sample mapping, exactly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("params", [(8, 128, 0.75), (6, 64, 0.5),
                                    (4, 32, 0.3)], ids=str)
def test_kernel_table_and_weights_equal_jax(params):
    jk, tk = jvis.VisKernel(*params), tvis.VisKernel(*params)
    np.testing.assert_array_equal(tk.table, jk.table)
    frac = np.random.default_rng(0).uniform(0, 1, size=257)
    for dt in (np.float32, np.float64):
        np.testing.assert_array_equal(tk.weights(frac, dtype=dt),
                                      jk.weights(frac, dtype=dt))
    np.testing.assert_array_equal(tk.taper([0.0, 0.1, 0.3]),
                                  jk.taper([0.0, 0.1, 0.3]))
    srcs = [(1.0, 30, 20), (0.5, -35, 3)]
    assert tk.correct_sources(srcs, 256) == jk.correct_sources(srcs, 256)
    with pytest.raises(ValueError):
        tk.correct_sources([(1.0, int(tk.band * 128) + 5, 0)], 256)


def _covers():
    config = _jax_cover()[0]
    full_j = J.make_full_subgrid_cover(config)
    full_t = _port_cover()[3]
    return {"full": (full_j, full_t),
            "sparse": (full_j[::3], full_t[::3])}


@pytest.mark.parametrize("cover", ["full", "sparse"])
@pytest.mark.parametrize("seed", [0, 1])
def test_map_samples_equals_jax_exactly(cover, seed):
    """Owners, indices, fractions and shed list equal, bit for bit, and
    the owners keyed in the same (first-sample) order, on 2000 samples
    spread over three periods (canonicalisation, sheds)."""
    jsgs, tsgs = _covers()[cover]
    N = TEST_PARAMS["N"]
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-N, 2 * N, size=(2000, 2))
    uv[:500] = np.floor(uv[:500])  # integer points: ties at the span edges
    jo, js = jvis.VisCoverIndex(jsgs, 8, N).map_samples(uv)
    to, ts = tvis.VisCoverIndex(tsgs, 8, N).map_samples(uv)
    assert ts == js and len(js) > 0
    assert list(to) == list(jo)
    for key in jo:
        for field in ("idx", "iu0", "iv0", "fu", "fv"):
            assert to[key][field].dtype == jo[key][field].dtype
            np.testing.assert_array_equal(to[key][field], jo[key][field])


# ---------------------------------------------------------------------------
# Serving, against the reference
# ---------------------------------------------------------------------------


def test_serving_counts_and_sheds_equal_jax():
    jstats, _, _, _ = _serving_run("jax")
    tstats, _, _, _ = _serving_run("port")
    for key in COUNTS:
        assert tstats[key] == jstats[key], key
    assert set(tstats["shed_reasons"]) == {"outside_cover", "depth"}
    assert tstats["cache_hits"] > 0 and tstats["cache_fallbacks"] > 0
    assert tstats["coalesce_hit_rate"] > 0


def test_served_samples_match_jax_and_the_oracle():
    _, jtracked, _, _ = _serving_run("jax")
    _, ttracked, _, _ = _serving_run("port")
    juv, jdata = _served(jtracked)
    tuv, tdata = _served(ttracked)
    np.testing.assert_array_equal(tuv, juv)
    assert np.linalg.norm(tdata - jdata) / np.linalg.norm(jdata) <= REL
    ref = tvis.vis_oracle(SOURCES, tuv, TEST_PARAMS["N"])
    for data in (tdata, jdata):
        rms = np.linalg.norm(data - ref) / np.linalg.norm(ref)
        assert rms <= tvis.DEGRID_TOLERANCE, rms


@pytest.mark.parametrize("k", range(3))
def test_outside_cover_and_overload_handles_equal_jax(k):
    """Per-handle outcomes of the drills: the overload burst's sheds
    (k = 0), the outside-cover batch (k = 1), a partial zipf batch
    (k = 2)."""
    _, jtracked, _, _ = _serving_run("jax")
    _, ttracked, _, _ = _serving_run("port")
    pick = {0: range(24), 1: [25], 2: [26]}[k]
    for i in pick:
        jh, th = jtracked[i][1], ttracked[i][1]
        assert th.status == jh.status
        assert th.shed_reason == jh.shed_reason
        assert sorted(th.shed_idx) == sorted(jh.shed_idx)
    if k == 1:
        assert ttracked[25][1].shed_reason == "outside_cover"


def test_hbm_budget_admission_waits_for_the_plan_compiler():
    with pytest.raises(NotImplementedError, match="A10"):
        tserve.AdmissionQueue(hbm_budget_bytes=2**30)
    _, _, _, sgs = _port_cover()
    with pytest.raises(NotImplementedError, match="A10"):
        tvis.VisibilityService(_forward("port"), subgrid_configs=sgs,
                               hbm_budget_bytes=2**30)


# ---------------------------------------------------------------------------
# Bit-discipline inside the port
# ---------------------------------------------------------------------------


def test_cache_feed_and_compute_fallback_are_bit_identical():
    _, _, _, sgs = _port_cover()
    hot_off0 = sorted({sg.off0 for sg in sgs})[0]
    hot_col = [sg for sg in sgs if sg.off0 == hot_off0]
    fwd = _forward("port")
    _, feed = _seed_feed("port", fwd, hot_col)
    uv = _interior_uv(hot_col, 24, seed=2)
    cached = tvis.VisibilityService(fwd, subgrid_configs=sgs,
                                    cache_feed=feed)
    h_cache = cached.serve(uv)
    assert h_cache.status == "ok"
    assert cached.stats()["cache_hits"] > 0
    assert cached.stats()["cache_fallbacks"] == 0
    computed = tvis.VisibilityService(_forward("port"), subgrid_configs=sgs)
    h_comp = computed.serve(uv)
    assert h_comp.status == "ok" and computed.stats()["cache_hits"] == 0
    np.testing.assert_array_equal(h_cache.data, h_comp.data)


def test_sample_bits_do_not_depend_on_coalescing():
    """Two singleton submits coalesced into one dispatch == one combined
    submit, bitwise."""
    _, _, _, sgs = _port_cover()
    uv = _interior_uv([sgs[0]], 2, seed=4)
    fwd = _forward("port")
    svc = tvis.VisibilityService(fwd, subgrid_configs=sgs)
    h1, h2 = svc.submit(uv[:1]), svc.submit(uv[1:])
    while svc.pump_once():
        pass
    assert h1.status == h2.status == "ok"
    assert svc.stats()["n_batches"] == 1
    assert svc.stats()["coalesce_hit_rate"] > 0
    hc = tvis.VisibilityService(fwd, subgrid_configs=sgs).serve(uv)
    np.testing.assert_array_equal(np.concatenate([h1.data, h2.data]),
                                  hc.data)


def _half_cached_pump(seed):
    """A service whose feed holds half of one column's rows, and a batch
    spread over that whole column: one pump mixes cache-fed host rows and
    computed rows. Returns (service, handle, forward, the column)."""
    _, _, _, sgs = _port_cover()
    col = [sg for sg in sgs if sg.off0 == sgs[0].off0]
    fwd = _forward("port")
    _, feed = _seed_feed("port", fwd, col[::2])
    svc = tvis.VisibilityService(fwd, subgrid_configs=sgs, cache_feed=feed)
    handle = svc.submit(_interior_uv(col, 6 * len(col), seed=seed))
    return svc, handle, fwd, col


def test_a_pump_launches_b4_once(monkeypatch):
    """Every subgrid of a pump is answered by one call of the B4 wrapper,
    over all their rows; the per-subgrid counts stay the reference's."""
    from swiftly_tpu_torch.ops import kernels

    calls = []
    real = kernels.degrid_rows

    def counted(rows, *args):
        calls.append(len(rows))
        return real(rows, *args)

    monkeypatch.setattr(kernels, "degrid_rows", counted)
    svc, handle, _, col = _half_cached_pump(seed=11)
    G = len(handle.children)
    assert G == len(col) > 2
    assert svc.pump_once() == G and handle.status == "ok"
    assert calls == [G]
    stats = svc.stats()
    assert stats["n_pumps"] == 1 and stats["n_batches"] == G
    assert 0 < stats["cache_hits"] < G
    assert {r.result.path for r in handle.children} == {"cache", "compute"}
    assert all(r.result.batch_size == r.n_samples for r in handle.children)


def test_pump_samples_equal_degrid_batch_bitwise():
    """Each subgrid's samples served by a pump equal `degrid_batch` on the
    same row fed the host's weights, bit for bit, for cache-fed and
    computed rows alike."""
    svc, handle, fwd, _ = _half_cached_pump(seed=12)
    while svc.pump_once():
        pass
    assert handle.status == "ok"
    kernel = svc.kernel
    paths = set()
    for req in handle.children:
        row = (svc.cache_feed.lookup(req.config) if req.result.path == "cache"
               else fwd.get_subgrid_task(req.config))
        paths.add(req.result.path)
        ref = tvis.degrid_batch(
            row, req.iu0, req.iv0, kernel.weights(req.fu, dtype=np.float64),
            kernel.weights(req.fv, dtype=np.float64), device="cpu")
        np.testing.assert_array_equal(handle.data[req.idx], ref)
    assert paths == {"cache", "compute"}


# ---------------------------------------------------------------------------
# Version gates
# ---------------------------------------------------------------------------


def test_stale_version_straggler_falls_back_to_compute():
    _, _, _, sgs = _port_cover()
    hot_col = [sg for sg in sgs if sg.off0 == sgs[0].off0]
    fwd = _forward("port")
    _, feed = _seed_feed("port", fwd, hot_col)
    svc = tvis.VisibilityService(fwd, subgrid_configs=sgs, cache_feed=feed)
    handle = svc.submit(_interior_uv(hot_col, 4, seed=8))
    svc.stream_version += 1  # the stack moves under the admitted request
    while svc.pump_once():
        pass
    assert handle.status == "ok"
    assert svc.stats()["version_fallbacks"] > 0
    assert svc.stats()["cache_hits"] == 0


def test_facet_update_drops_feed_and_gridder_refuses():
    _, _, _, sgs = _port_cover()
    hot_col = [sg for sg in sgs if sg.off0 == sgs[0].off0]
    fwd = _forward("port")
    _, feed = _seed_feed("port", fwd, hot_col)
    svc = tvis.VisibilityService(fwd, subgrid_configs=sgs, cache_feed=feed)
    uv = _interior_uv(hot_col, 4, seed=9)
    assert svc.serve(uv).status == "ok"
    hits = svc.stats()["cache_hits"]
    assert hits > 0
    gridder = tvis.VisGridder(svc.cover, svc.kernel,
                              stream_version=svc.stream_version,
                              version_of=lambda: svc.stream_version,
                              device="cpu")
    assert gridder.add_batch(uv, np.ones(4, dtype=complex)) == 4
    assert svc.post_facet_update() == 1 and svc.cache_feed is None
    with pytest.raises(LookupError):
        gridder.add_batch(uv, np.ones(4, dtype=complex))
    h = svc.serve(uv)
    assert h.status == "ok"
    assert all(r.result.path == "compute" for r in h.children)
    assert svc.stats()["cache_hits"] == hits
    assert svc.stats()["facet_updates"] == 1


# ---------------------------------------------------------------------------
# Gridding into the backward, against the reference
# ---------------------------------------------------------------------------


@functools.cache
def _gridded(pkg):
    """Every served sample of the serving run, gridded and ingested into
    the sampled backward: (emitted columns, stack, facets)."""
    import jax.numpy as jnp

    _, tracked, sgs, _ = _serving_run("jax")
    uv, data = _served(tracked)
    config, fcs, _, sgs = _cover(pkg)
    vis = PKGS[pkg]["vis"]
    index = vis.VisCoverIndex(sgs, 8, TEST_PARAMS["N"])
    if pkg == "jax":
        gridder = vis.VisGridder(index, vis.vis_kernel())
        gridder.add_batch(uv, data)
        cols, stack = gridder.emit(planar=True)
        bwd = JBackward(config, fcs, residency="sampled")
        bwd.add_subgrid_group(cols, jnp.asarray(stack))
        return cols, np.asarray(stack), config.core.as_complex(bwd.finish())
    gridder = vis.VisGridder(index, vis.vis_kernel(), device="cpu")
    assert gridder.add_batch(uv, data) == len(data)
    cols, stack = gridder.emit(planar=True)
    bwd = T.StreamedBackward(config, fcs, residency="sampled")
    bwd.add_subgrid_group(cols, stack)
    return cols, stack.numpy(), config.core.as_complex(bwd.finish())


def test_gridder_emit_matches_jax():
    jcols, jstack, _ = _gridded("jax")
    tcols, tstack, _ = _gridded("port")
    assert [[(s.off0, s.off1) for s in c] for c in tcols] == \
        [[(s.off0, s.off1) for s in c] for c in jcols]
    assert tstack.shape == jstack.shape and tstack.dtype == jstack.dtype
    assert np.abs(tstack - jstack).max() <= REL * np.abs(jstack).max()


def test_gridded_ingest_facets_match_jax():
    """emit -> add_subgrid_group -> finish: the facets agree with the
    window Fb divided out (ROADMAP §C)."""
    config = _port_cover()[0]
    _, _, jfacets = _gridded("jax")
    _, _, tfacets = _gridded("port")
    fb = config.core._p.extract_mid(config.core._Fb,
                                    TEST_PARAMS["yB_size"], 0).numpy()
    w = fb[:, None] * fb[None, :]
    assert tfacets.shape == jfacets.shape
    assert np.isfinite(tfacets).all() and np.abs(tfacets).max() > 0
    rel = (np.abs(tfacets - jfacets) / w).max() / (np.abs(jfacets) / w).max()
    assert rel <= REL, rel


def test_gridder_emit_layout_and_determinism():
    """``emit`` stacks the accumulators (zero-padded ragged columns);
    ``subgrid`` reads one back; gridding twice gives the same bits."""
    _, stack, _ = _gridded("port")
    _, tracked, _, _ = _serving_run("jax")
    uv, data = _served(tracked)
    _, _, _, sgs = _port_cover()
    gridder = tvis.VisGridder(tvis.VisCoverIndex(sgs, 8, TEST_PARAMS["N"]),
                              tvis.vis_kernel(), device="cpu")
    gridder.add_batch(uv, data)
    cols2, stack2 = gridder.emit(planar=True)
    np.testing.assert_array_equal(stack2.numpy(), stack)
    sg = cols2[0][0]
    np.testing.assert_array_equal(gridder.subgrid(sg.off0, sg.off1).numpy(),
                                  stack[0, 0, ..., 0] + 1j * stack[0, 0, ..., 1])
    _, cstack = gridder.emit(planar=False)
    assert cstack.is_complex() and cstack.shape == stack.shape[:-1]
    for c, col in enumerate(cols2):
        assert not stack[c, len(col):].any()  # padding rows stay zero


# ---------------------------------------------------------------------------
# The spill cache and the serving feed
# ---------------------------------------------------------------------------


def _rows(n=3, size=5, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (1, n, size, size, 2)).astype(np.float32)


@pytest.mark.parametrize("disk", [False, True], ids=["ram", "disk"])
def test_spill_cache_round_trips_rows_exactly(disk, tmp_path):
    rows = _rows()
    spill = SpillCache(budget_bytes=0 if disk else 2**20,
                       spill_dir=str(tmp_path) if disk else None)
    spill.begin_fill(tag="t")
    assert spill.put(["meta"], rows)
    assert spill.end_fill() and spill.complete
    assert (spill.disk_bytes > 0) == disk and len(spill) == 1
    np.testing.assert_array_equal(spill.get(0), rows)
    np.testing.assert_array_equal(spill.get_row(0, (0, 1)), rows[0, 1])
    assert spill.stats()["disk_reads" if disk else "ram_reads"] == 2
    spill.reset()
    assert not spill.complete and len(spill) == 0
    assert not list(tmp_path.glob("swiftly_spill_*/*.npy"))


def test_spill_cache_defaults_read_no_environment(monkeypatch):
    """The budget and the disk tier come from the arguments alone: the
    reference's environment variables are not read."""
    monkeypatch.setenv("SWIFTLY_SPILL_BUDGET_GB", "0")
    monkeypatch.setenv("SWIFTLY_SPILL_DIR", "/nonexistent")
    spill = SpillCache()
    assert spill.budget_bytes == DEFAULT_BUDGET_BYTES
    assert spill.spill_dir is None and not spill.stats()["disk_backed"]


def test_spill_cache_evicts_without_a_disk():
    """Over the RAM budget with no disk the entry is evicted and the fill
    gives up; a feed refuses such a cache."""
    spill = SpillCache(budget_bytes=10, spill_dir=None)
    spill.begin_fill()
    assert not spill.put([], _rows())
    assert not spill.end_fill() and spill.gave_up and len(spill) == 0
    assert spill.stats()["evictions"] == 1
    with pytest.raises(ValueError, match="COMPLETE"):
        CachedColumnFeed(spill)


def test_feed_gates_versions_patches_and_evictions():
    _, _, _, sgs = _port_cover()
    col = [sg for sg in sgs if sg.off0 == sgs[0].off0][:2]
    rows = _rows(n=2, size=col[0].size)
    spill = SpillCache(budget_bytes=2**30)
    with pytest.raises(ValueError, match="COMPLETE"):
        CachedColumnFeed(spill)
    spill.begin_fill()
    spill.put([list(enumerate(col))], rows)
    spill.end_fill()
    feed = CachedColumnFeed(spill)
    assert len(feed) == 2
    np.testing.assert_array_equal(feed.lookup(col[1]), rows[0, 1])
    other = T.SubgridConfig(col[0].off0, col[0].off1, col[0].size,
                            np.zeros(col[0].size), None)
    assert feed.lookup(other) is None  # masks differ: a miss
    spill.stream_version += 1
    with pytest.raises(LookupError, match="version moved"):
        feed.lookup(col[0])
    assert CachedColumnFeed(spill).lookup(col[0]) is not None
    spill.reset()
    with pytest.raises(LookupError, match="no longer complete"):
        feed.lookup(col[0])
    assert (feed.hits, feed.misses, feed.stale, feed.evicted) == (1, 1, 1, 1)


# ---------------------------------------------------------------------------
# The scheduler's batch shaping, against the reference
# ---------------------------------------------------------------------------


class _Req:
    def __init__(self, config):
        self.config = config


@pytest.mark.parametrize("n", [1, 3, 5])
def test_scheduler_batch_shapes_equal_jax(n):
    jsgs, tsgs = _covers()["full"]
    pick = [0, 1, 7, 8, 9][:n]
    jplan = JScheduler(max_batch=4).plan_batch([_Req(jsgs[i]) for i in pick])
    tplan = tserve.CoalescingScheduler(max_batch=4).plan_batch(
        [_Req(tsgs[i]) for i in pick])
    assert tplan[1] == jplan[1]
    assert [(c.off0, c.off1) for c in tplan[0]] == \
        [(c.off0, c.off1) for c in jplan[0]]
    jfused = JScheduler().plan_fused([_Req(jsgs[i]) for i in pick])
    tfused = tserve.CoalescingScheduler().plan_fused(
        [_Req(tsgs[i]) for i in pick])
    assert tfused[1] == jfused[1]
    assert [(c.off0, c.off1, c.mask0 is None) for c in tfused[0]] == \
        [(c.off0, c.off1, c.mask0 is None) for c in jfused[0]]
