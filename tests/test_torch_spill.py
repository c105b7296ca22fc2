"""The port's stream recording and replay (``StreamedForward.
stream_column_groups(spill=...)``, ``feed_backward_passes(spill=...)``),
its backward partition plan (``swiftly_tpu_torch.plan``) and the spill
cache's and the device budget's environment contract, against the JAX
package at ``tests/test_spill.py``'s TEST_PARAMS and ``tests/test_128k.py``.

Port vs JAX package: the facet-partitioned, cache-fed backward gives the
JAX package's facets (f64 RMS < 3e-10, the reference's round-trip bound),
planar and complex; the plan functions and the budget parsers give the
JAX package's values. The port's own contracts (the JAX package's
``tests/test_spill.py``): cache-fed is bit-identical to replay-fed, from
RAM and from disk; an eviction gives up and replays; a failed read
resumes the stream by replaying the forward; one recording feeds every
pass. Forward passes are counted by wrapping
``StreamedForward._sampled_generator``.

Torch runs on one intra-op thread; each replay-fed reference is computed
once per module.
"""

import functools

import numpy as np
import pytest
import torch

import swiftly_tpu_torch as T
from swiftly_tpu_torch import plan as tplan
from swiftly_tpu_torch.models.config import FacetConfig, SubgridConfig
from swiftly_tpu_torch.parallel import streamed as tstreamed
from swiftly_tpu_torch.utils import spill as tspill
from swiftly_tpu_torch.utils.spill import SpillCache

TEST_PARAMS = {
    "W": 13.5625,
    "fov": 1.0,
    "N": 1024,
    "yB_size": 416,
    "yN_size": 512,
    "xA_size": 228,
    "xM_size": 256,
}
SOURCES = [(1, 1, 0), (0.5, -30, 40)]
TWINS = {"planar": ("planar", torch.float64), "torch": ("jax", torch.complex128)}
RMS_BOUND = 3e-10  # tests/conftest.py:6
# tests/test_128k.py's proxy: N and yN of 128k[1]-n32k-512, small facets
PROXY_PARAMS = dict(W=13.5625, fov=1.0, N=131072, yB_size=1024,
                    yN_size=65536, xA_size=448, xM_size=512)
# tests/test_128k.py:226, :275: the JAX package's TPU constants, passed
# explicitly to both packages
JAX_FWD_MIN, JAX_RESERVE = 3.3e9, 1.2e9
PLAN_CONFIGS = ["1k[1]-n512-256", "4k[1]-n2k-512", "32k[1]-n16k-512",
                "64k[1]-n32k-512", "128k[1]-n32k-512"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _jax_setup(jax_backend):
    import swiftly_tpu as J

    config = J.SwiftlyConfig(backend=jax_backend, **TEST_PARAMS)
    fcs = J.make_full_facet_cover(config)
    sgcs = J.make_full_subgrid_cover(config)
    tasks = [(fc, J.make_facet(config.image_size, fc, SOURCES)) for fc in fcs]
    return config, fcs, sgcs, tasks


@functools.cache
def _port_setup(backend):
    jcore = _jax_setup(TWINS[backend][0])[0].core
    config = T.SwiftlyConfig.from_numpy_state(
        np.asarray(jcore._Fb), np.asarray(jcore._Fn), backend=backend,
        dtype=TWINS[backend][1], device="cpu", **TEST_PARAMS)
    fcs = T.make_full_facet_cover(config)
    sgcs = T.make_full_subgrid_cover(config)
    tasks = [(fc, d) for fc, (_, d) in
             zip(fcs, _jax_setup(TWINS[backend][0])[3])]
    return config, fcs, sgcs, tasks


@pytest.fixture
def forwards(monkeypatch):
    """Counts forward passes: calls of ``_sampled_generator``."""
    calls = []
    inner = T.StreamedForward._sampled_generator

    def counted(self, *args, **kwargs):
        calls.append(1)
        return inner(self, *args, **kwargs)

    monkeypatch.setattr(T.StreamedForward, "_sampled_generator", counted)
    return calls


def _partitioned(backend, spill, n_parts=3, fwd=None):
    """tests/test_spill.py:228's partitioned backward: one forward, n_parts
    sampled passes over facet subsets, each fed by
    ``feed_backward_passes(spill=...)``; the facets concatenated."""
    config, fcs, sgcs, tasks = _port_setup(backend)
    if fwd is None:
        fwd = T.StreamedForward(config, tasks, residency="device",
                                col_group=4)
    F_sub = -(-len(fcs) // n_parts)
    outs = []
    for k, i0 in enumerate(range(0, len(fcs), F_sub)):
        bwd = T.StreamedBackward(config, fcs[i0:i0 + F_sub],
                                 residency="sampled")
        T.feed_backward_passes(fwd, sgcs, [bwd], spill=spill, feed_index=k)
        outs.append(bwd.finish())
    return np.concatenate(outs)


@functools.cache
def _replay_fed(backend):
    """The same three passes fed by the forward itself (one feed: each
    pass's bits do not depend on which feed carries it)."""
    config, fcs, sgcs, tasks = _port_setup(backend)
    fwd = T.StreamedForward(config, tasks, residency="device", col_group=4)
    bwds = [T.StreamedBackward(config, fcs[i0:i0 + 3], residency="sampled")
            for i0 in (0, 3, 6)]
    T.feed_backward_passes(fwd, sgcs, bwds)
    return np.concatenate([b.finish() for b in bwds])


def _counting_forwards(fn, *args):
    """``fn(*args)`` and the forward passes it ran, counted by wrapping
    ``_sampled_generator`` (for the module's cached runs; tests use the
    `forwards` fixture)."""
    calls = []
    inner = T.StreamedForward._sampled_generator

    def counted(self, *a, **kw):
        calls.append(1)
        return inner(self, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T.StreamedForward, "_sampled_generator", counted)
        return fn(*args), len(calls)


@functools.cache
def _cache_fed(backend):
    """The partitioned backward fed from one recording: (facets, forward
    passes run, the cache's stats, each feed's ``last_spill`` mode)."""
    spill = SpillCache(budget_bytes=1e9)
    config, _, _, tasks = _port_setup(backend)
    fwd = T.StreamedForward(config, tasks, residency="device", col_group=4)
    modes = []
    feed = T.feed_backward_passes

    def feed_and_note(*args, **kwargs):
        n = feed(*args, **kwargs)
        modes.append(fwd.last_spill["mode"])
        return n

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "feed_backward_passes", feed_and_note)
        out, n_forwards = _counting_forwards(_partitioned, backend, spill,
                                             3, fwd)
    assert spill.complete
    return out, n_forwards, spill.stats(), modes


@functools.cache
def _jax_partitioned(jax_backend):
    """The JAX package's cache-fed partitioned backward
    (tests/test_spill.py:228), complex."""
    from swiftly_tpu.parallel import StreamedBackward, StreamedForward
    from swiftly_tpu.utils.spill import SpillCache as JSpill

    config, fcs, sgcs, tasks = _jax_setup(jax_backend)
    fwd = StreamedForward(config, tasks, residency="device", col_group=4)
    spill = JSpill(budget_bytes=1e9)
    outs = []
    for i0 in range(0, len(fcs), 3):
        bwd = StreamedBackward(config, list(fcs[i0:i0 + 3]),
                               residency="sampled")
        for per_col, group in fwd.stream_column_groups(sgcs, spill=spill):
            bwd.add_subgrid_group([[sg for _, sg in col] for col in per_col],
                                  group)
        outs.append(bwd.finish())
    assert spill.complete
    return config.core.as_complex(np.concatenate(outs))


# -- port vs JAX package ---------------------------------------------------------


@pytest.mark.parametrize("backend", sorted(TWINS))
def test_cache_fed_partitioned_backward_matches_jax(backend):
    """The facet-partitioned backward fed from one recording gives the JAX
    package's facets to the reference's round-trip bound."""
    config = _port_setup(backend)[0]
    got = config.core.as_complex(_cache_fed(backend)[0])
    ref = _jax_partitioned(TWINS[backend][0])
    assert got.shape == ref.shape
    assert np.sqrt(np.mean(np.abs(got - ref) ** 2)) < RMS_BOUND


def _plan_inputs(name):
    params = T.SWIFT_CONFIGS[name]
    yB = params["yB_size"]
    m = params["xM_size"] * params["yN_size"] // params["N"]
    F_total = (-(-params["N"] // yB)) ** 2
    return F_total, yB, yB * yB * 8, m * yB * 8  # planar f32


OVERRIDES = [{}, {"n_facet_env": 3}, {"n_row_env": 2},
             {"n_facet_env": 3, "n_row_env": 2}, {"n_facet_env": 1},
             {"n_row_env": 7}, {"n_facet_env": 100, "n_row_env": 1000}]


@pytest.mark.parametrize("budget", [None, 16e9, 80e9])
@pytest.mark.parametrize("name", PLAN_CONFIGS)
def test_plan_functions_equal_jax(name, budget):
    """``plan_backward_passes`` and ``plan_backward_feed`` give the JAX
    package's plans at every catalogue geometry, budget and override,
    with the JAX package's constants passed to both."""
    from swiftly_tpu.plan import compiler as jcompiler

    F_total, yB, acc, rows = _plan_inputs(name)
    for fold_group in (2, 4):
        for over in OVERRIDES:
            args = (F_total, yB, acc, rows, fold_group, budget)
            want = jcompiler.plan_backward_passes(
                *args, fwd_min=JAX_FWD_MIN, reserve=JAX_RESERVE, **over)
            got = tplan.plan_backward_passes(
                *args, fwd_min=JAX_FWD_MIN, reserve=JAX_RESERVE, **over)
            assert got == want, (name, budget, fold_group, over)
            parts, resident = got
            for feed_env in (0, 1, 2, 5):
                assert tplan.plan_backward_feed(
                    parts, resident, budget, JAX_FWD_MIN, JAX_RESERVE,
                    feed_env=feed_env) == jcompiler.plan_backward_feed(
                    parts, resident, budget, fwd_min=JAX_FWD_MIN,
                    reserve=JAX_RESERVE, feed_env=feed_env)


@pytest.mark.parametrize("env", [None, "16e9", "2.5e10"])
def test_hbm_budget_parser_equals_jax(env, monkeypatch):
    """``hbm_budget_bytes`` under the same ``SWIFTLY_HBM_BUDGET``, on the
    CPU: the planner's semantics honour the variable, the executors' stay
    unlimited (tests/test_128k.py:318)."""
    from swiftly_tpu.plan import hbm_budget_bytes as jparse

    if env is None:
        monkeypatch.delenv("SWIFTLY_HBM_BUDGET", raising=False)
    else:
        monkeypatch.setenv("SWIFTLY_HBM_BUDGET", env)
    for kw in ({}, {"headroom": 1e9}, {"default": 14e9},
               {"honor_env_on_cpu": False, "default": 14e9},
               {"honor_env_on_cpu": False, "headroom": 2e9}):
        assert tplan.hbm_budget_bytes(**kw) == jparse(**kw), kw
    # the executor reads its budget through the parser: unlimited here
    config, _, _, tasks = _port_setup("planar")
    fwd = T.StreamedForward(config, tasks, residency="device")
    fwd.hbm_headroom = 1e9
    assert fwd._hbm_budget() is None


@pytest.mark.parametrize("env", [None, "", "0.25", "3"])
def test_spill_budget_parser_equals_jax(env, monkeypatch, tmp_path):
    """``spill_budget_bytes`` and ``SpillCache()``'s defaults under the
    same ``SWIFTLY_SPILL_BUDGET_GB`` / ``SWIFTLY_SPILL_DIR`` and the same
    ``/proc/meminfo``, as the JAX package's."""
    from swiftly_tpu.utils import spill as jspill

    meminfo = tmp_path / "meminfo"
    meminfo.write_text("MemTotal: 100 kB\nMemAvailable: 12345678 kB\n")
    real_open = open

    def fake_open(path, *args, **kwargs):
        if path == "/proc/meminfo":
            path = meminfo
        return real_open(path, *args, **kwargs)

    for mod in (tspill, jspill):
        monkeypatch.setattr(mod, "open", fake_open, raising=False)
    for name in ("SWIFTLY_SPILL_BUDGET_GB", "SWIFTLY_SPILL_DIR"):
        if env is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, env if "BUDGET" in name or not env
                               else str(tmp_path / env))
    assert tspill.spill_budget_bytes() == jspill.spill_budget_bytes()
    ours, theirs = SpillCache(), jspill.SpillCache()
    assert ours.budget_bytes == theirs.budget_bytes
    assert ours.spill_dir == theirs.spill_dir
    if not env:
        assert ours.budget_bytes == 12345678 * 1024 / 2
        assert ours.spill_dir is None
    # explicit arguments win over the environment
    assert SpillCache(budget_bytes=5, spill_dir="x").budget_bytes == 5.0


# -- the port's own contracts ------------------------------------------------------


@pytest.mark.parametrize("backend", sorted(TWINS))
def test_cache_fed_bitidentical_to_replay(backend):
    """tests/test_spill.py:253: the cache-fed partitioned backward (three
    passes) is bit for bit the replay-fed one, with one forward instead of
    three: the first feed records, the others replay."""
    out, n_forwards, stats, modes = _cache_fed(backend)
    np.testing.assert_array_equal(out, _replay_fed(backend))
    assert n_forwards == 1 and modes == ["record", "replay", "replay"]
    assert stats["fills"] == 1 and stats["evictions"] == 0
    assert stats["ram_reads"] == 2 * stats["entries"]
    assert stats["disk_bytes"] == 0


def test_disk_backed_feed_without_prefetch_is_bitidentical(
        forwards, monkeypatch, tmp_path):
    """tests/test_spill.py:284: every entry on disk, read inline
    (``SWIFTLY_SPILL_PREFETCH=0``): the same bits, one forward."""
    ref = _replay_fed("planar")
    monkeypatch.setenv("SWIFTLY_SPILL_PREFETCH", "0")
    forwards.clear()
    spill = SpillCache(budget_bytes=1, spill_dir=str(tmp_path))
    config, _, _, tasks = _port_setup("planar")
    fwd = T.StreamedForward(config, tasks, residency="device", col_group=4)
    out = _partitioned("planar", spill, fwd=fwd)
    np.testing.assert_array_equal(out, ref)
    assert len(forwards) == 1
    assert fwd.last_spill["mode"] == "replay"
    assert not fwd.last_spill["prefetch_thread"]
    stats = spill.stats()
    assert stats["disk_bytes"] > 0 and stats["ram_bytes"] == 0
    assert stats["disk_reads"] == 2 * len(spill)
    spill.reset()
    assert not list(tmp_path.glob("swiftly_spill_*/*.npy"))


@pytest.mark.parametrize("col_group", [3])
def test_backward_bits_do_not_depend_on_the_forward_grouping(col_group):
    """A recording forward sizes its groups with one more stack held back,
    so on the card it may group the columns otherwise than a forward
    that does not record. The sampled backward folds ``fold_group``
    columns at a time over the whole feed, so its facets are the same
    bits whatever the grouping (here 3 columns a group against 4, with a
    fold group of 4)."""
    config, fcs, sgcs, tasks = _port_setup("planar")
    fwd = T.StreamedForward(config, tasks, residency="device",
                            col_group=col_group)
    bwds = [T.StreamedBackward(config, fcs[i0:i0 + 3], residency="sampled")
            for i0 in (0, 3, 6)]
    assert T.feed_backward_passes(fwd, sgcs, bwds) == 2
    np.testing.assert_array_equal(
        np.concatenate([b.finish() for b in bwds]), _replay_fed("planar"))


def test_spill_eviction_falls_back_to_replay(forwards):
    """tests/test_spill.py:304: over budget with no disk, the fill gives up
    and every feed runs the forward (two feeds here: two passes share the
    first); the facets are the same."""
    ref = _replay_fed("planar")
    config, fcs, sgcs, tasks = _port_setup("planar")
    fwd = T.StreamedForward(config, tasks, residency="device", col_group=4)
    spill = SpillCache(budget_bytes=1, spill_dir=None)
    forwards.clear()
    bwds = [T.StreamedBackward(config, fcs[i0:i0 + 3], residency="sampled")
            for i0 in (0, 3, 6)]
    T.feed_backward_passes(fwd, sgcs, bwds[:2], spill=spill, feed_index=0)
    assert fwd.last_spill["mode"] == "record"
    T.feed_backward_passes(fwd, sgcs, bwds[2:], spill=spill, feed_index=1)
    np.testing.assert_array_equal(
        np.concatenate([b.finish() for b in bwds]), ref)
    assert spill.gave_up and not spill.complete
    assert spill.stats()["evictions"] >= 1
    assert len(forwards) == 2
    assert fwd.last_spill == {"mode": "forward-gave-up"}


@pytest.mark.parametrize("k", [2])
def test_read_error_resumes_the_stream(k, forwards, monkeypatch):
    """A cache read that fails (``OSError``) at group k mid-replay marks the
    cache given up and runs the forward for the rest of the pass, from
    exactly group k: every group once, in order, and facets bit for bit
    those of the recording feed."""
    config, fcs, sgcs, tasks = _port_setup("planar")
    fwd = T.StreamedForward(config, tasks, residency="device", col_group=2)
    spill = SpillCache(budget_bytes=1e9)

    def feed():
        bwds = [T.StreamedBackward(config, fcs[i0:i0 + 3],
                                   residency="sampled") for i0 in (0, 3, 6)]
        fed = []
        for per_col, group in fwd.stream_column_groups(sgcs, spill=spill):
            cols = [[sg for _, sg in col] for col in per_col]
            fed.extend(cols)
            for bwd in bwds:
                bwd.add_subgrid_group(cols, group)
        return fed, np.concatenate([b.finish() for b in bwds])

    forwards.clear()
    recorded, ref = feed()
    assert spill.complete and len(spill) > k
    inner = spill.get

    def failing(j):
        if j == k:
            raise OSError(f"injected read error at group {j}")
        return inner(j)

    monkeypatch.setattr(spill, "get", failing)
    fed, out = feed()
    assert fed == recorded
    assert len(forwards) == 2  # the recording's and the fallback's
    assert spill.gave_up and not spill.complete
    assert fwd.last_spill["mode"] == "replay-fallback"
    assert fwd.last_spill["fallback_from_group"] == k
    np.testing.assert_array_equal(out, ref)


def test_tag_mismatch_raises():
    """A complete cache recorded for another cover is refused."""
    config, _, sgcs, tasks = _port_setup("planar")
    fwd = T.StreamedForward(config, tasks, residency="device", col_group=4)
    spill = SpillCache(budget_bytes=1e9)
    for _ in fwd.stream_column_groups(sgcs, spill=spill):
        pass
    assert spill.complete
    with pytest.raises(ValueError, match="different subgrid stream"):
        next(fwd.stream_column_groups(sgcs[:-1], spill=spill))
    # the cached feed serves the recorded rows, bit for bit
    feed = fwd.cached_feed(spill)
    assert len(feed) == len(sgcs)


def _feed_scheduled(spill, feed_group, n_facets=9):
    """tests/test_spill.py:335: one pass per facet, `feed_group` passes
    sharing each feed; (facets, column groups a feed)."""
    config, fcs, sgcs, tasks = _port_setup("planar")
    fwd = T.StreamedForward(config, tasks, residency="device", col_group=4)
    outs = []
    n_groups = 0
    for k, c0 in enumerate(range(0, n_facets, feed_group)):
        bwds = [T.StreamedBackward(config, [fc], residency="sampled")
                for fc in fcs[c0:min(c0 + feed_group, n_facets)]]
        n_groups = T.feed_backward_passes(fwd, sgcs, bwds, spill=spill,
                                          feed_index=k)
        outs.extend(b.finish() for b in bwds)
    return np.concatenate(outs), n_groups


@functools.cache
def _feed_once_fold_many(feed_group):
    """Per-facet passes in feeds of `feed_group` over one recording:
    (facets, forward passes, whole-group cache reads, groups a feed)."""
    spill = SpillCache(budget_bytes=1e9)
    (out, n_groups), n_forwards = _counting_forwards(
        _feed_scheduled, spill, feed_group)
    assert len(spill) == n_groups
    return out, n_forwards, spill.stats()["ram_reads"], n_groups


@pytest.mark.parametrize("feed_group", [1, 2])
def test_feed_once_fold_many_bitidentical(feed_group):
    """tests/test_spill.py:356: P per-facet passes in feeds of 1 and of 2
    give the same facets bit for bit, each from one forward, with
    (n_feeds - 1) x n_groups whole-group cache reads."""
    out, n_forwards, reads, n_groups = _feed_once_fold_many(feed_group)
    np.testing.assert_array_equal(out, _feed_once_fold_many(3 - feed_group)[0])
    n_feeds = -(-out.shape[0] // feed_group)
    assert n_forwards == 1
    assert reads == (n_feeds - 1) * n_groups


def test_feed_schedule_replay_fallback_shares_forwards(forwards):
    """tests/test_spill.py:400: with no cache, passes in feeds of 2 cost
    ceil(P/2) forwards and give the cache-fed facets (P = 4 of the facets'
    passes)."""
    ref = _feed_once_fold_many(1)[0]
    forwards.clear()
    out, _ = _feed_scheduled(None, 2, n_facets=4)
    np.testing.assert_array_equal(out, ref[:4])
    assert len(forwards) == 2


@pytest.mark.slow
def test_128k_proxy_row_slabs_fed_from_one_recording(forwards):
    """tests/test_128k.py:345: at the 128k proxy geometry (N = 131072, the
    full yN = 65536, complex backend), two row-slab backwards and the
    whole-facet one, each fed separately from one recorded stream: one
    forward, the slabs concatenated bit for bit the whole (the JAX
    package's proxy round trip holds the whole to 1e-12:
    tests/test_torch_slabs.py)."""
    config = T.SwiftlyConfig(backend="torch", dtype=torch.complex128,
                             device="cpu", **PROXY_PARAMS)
    sources = [(1.0, 3, -5)]
    fcs = [FacetConfig(0, 0, 1024), FacetConfig(0, 768, 1024)]
    tasks = [(fc, T.make_facet(config.image_size, fc, sources)) for fc in fcs]
    sgcs = [SubgridConfig(o0, o1, 448) for o0 in (0, 448) for o1 in (0, 448)]
    fwd = T.StreamedForward(config, tasks, residency="device")
    spill = SpillCache(budget_bytes=1e9)
    forwards.clear()

    def feed(**kw):
        bwd = T.StreamedBackward(config, fcs, residency="sampled", **kw)
        T.feed_backward_passes(fwd, sgcs, [bwd], spill=spill)
        return bwd.finish()

    slabs = [feed(row_slab=rows) for rows in ((0, 600), (600, 1024))]
    whole = feed()
    assert spill.complete and len(forwards) == 1
    assert spill.stats()["ram_reads"] == 2 * len(spill)
    np.testing.assert_array_equal(np.concatenate(slabs, axis=1), whole)



# -- the port's margins for the plan ---------------------------------------------


def test_plan_margins_price_the_smallest_forward():
    """``plan_margins``' ``fwd_min`` is exactly what the slab sizer needs
    for its smallest plan (one facet a slab, one slab deep, one column,
    the recording's held-back stack): the sizer fits one column in it and
    none in a byte less; ``reserve`` grows with the fold group."""
    config, fcs, sgcs, tasks = _port_setup("planar")
    fwd = T.StreamedForward(config, tasks, residency="device")
    xA = sgcs[0].size
    fwd_min, reserve = tplan.plan_margins(fwd, xA, 4)
    S = -(-config.image_size // xA)
    flat, per_G = tstreamed.grouped_working_set(
        fwd._base, S, xA, True, 1, 1, slab_depth=1, extra_out_stacks=1)
    assert fwd_min == flat + per_G

    def G(budget):
        return tstreamed.grouped_col_group_for_budget(
            fwd._base, budget, 10, S, xA, True, 1, 1, slab_depth=1,
            warn=False, extra_out_stacks=1)

    assert G(fwd_min) == 1 and G(fwd_min + per_G) == 2
    assert tplan.plan_margins(fwd, xA, 8)[1] > reserve > 0


@pytest.mark.parametrize("name, want_passes, want_slabs", [
    ("32k[1]-n16k-512", 1, 1), ("128k[1]-n32k-512", 9, 1)])
def test_plan_with_the_port_margins_on_one_card(name, want_passes,
                                                want_slabs):
    """At full geometry on an 80 GB card's budget, with the margins the
    port derives: 32k stays one pass, 128k splits into single-facet passes
    (one 45056^2 accumulator, 16.2 GB, fits) with no row slab, several
    passes a feed."""
    params = T.SWIFT_CONFIGS[name]
    config = T.SwiftlyConfig(backend="planar", dtype=torch.float32,
                             device="cpu", **params)
    fcs = T.make_full_facet_cover(config)
    base = tstreamed._StreamedBase(config, fcs, residency="device")
    fwd_min, reserve = tplan.plan_margins(base, params["xA_size"], 4)
    F_total, yB, acc, rows = _plan_inputs(name)
    parts, resident = tplan.plan_backward_passes(
        F_total, yB, acc, rows, 4, 80e9, fwd_min, reserve)
    assert len({p[:2] for p in parts}) == want_passes
    assert len({p[2:] for p in parts}) == want_slabs
    q = tplan.plan_backward_feed(parts, resident, 80e9, fwd_min, reserve)
    assert q * resident <= 80e9 - fwd_min - reserve or q == 1
    assert (q > 1) == (len(parts) > 1)
