"""The port's facet-slab streaming, sparse facets and row-slab backwards,
against the JAX package's ``StreamedForward`` / ``StreamedBackward`` at
``tests/test_streamed.py``'s TEST_PARAMS and at the 128k proxy geometry of
``tests/test_128k.py``.

Both packages get the same facets: the reference's two sources plus six
spread ones drawn from a numpy seed, so that most facets hold signal and
the slabs' partial sums differ from the resident sums by rounding, not by
zeros. Backends: port "planar" float64 against JAX "planar", port "torch"
complex128 against JAX "jax". Bounds, as the reference's tests set them:
grouped forwards agree with resident ones to 1e-10 (atol) and with JAX's
grouped forwards to 1e-12 relative; row slabs concatenated agree with the
whole-facet backward to 1e-12, and within the port they are
``torch.equal`` to it. Sparse facets are bitwise the JAX package's.

Torch runs on one intra-op thread; each forward is computed once per
module. The JAX package is imported inside the helpers that need it, so
the ``cuda``-marked test runs on a machine without JAX:
``python -m pytest --noconftest tests/test_torch_slabs.py -m cuda``.
"""

import functools

import numpy as np
import pytest
import torch

import swiftly_tpu_torch as T
from swiftly_tpu_torch.models.config import FacetConfig, SubgridConfig
from swiftly_tpu_torch.parallel import streamed as tstreamed

TEST_PARAMS = {
    "W": 13.5625,
    "fov": 1.0,
    "N": 1024,
    "yB_size": 416,
    "yN_size": 512,
    "xA_size": 228,
    "xM_size": 256,
}
_rng = np.random.default_rng(8)
SOURCES = [(1, 1, 0), (0.5, -30, 40)] + [
    (float(a), int(x), int(y)) for a, x, y in zip(
        _rng.uniform(0.25, 1.0, 6), _rng.integers(-480, 480, 6),
        _rng.integers(-480, 480, 6))
]
TWINS = {"planar": ("planar", torch.float64), "torch": ("jax", torch.complex128)}
REL = 1e-12
GROUPED_ATOL = 1e-10  # tests/test_streamed.py:328
SLAB_ATOL = 1e-12  # tests/test_streamed.py:513

# the 128k proxy (tests/test_128k.py:145, :345): N and yN of 128k[1]-n32k-512
# with small facets and a 2 x 2 corner of the subgrid cover
PROXY_PARAMS = dict(W=13.5625, fov=1.0, N=131072, yB_size=1024,
                    yN_size=65536, xA_size=448, xM_size=512)
PROXY_SOURCES = [(1.0, 3, -5)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the JAX package's runs ---------------------------------------------------


@functools.cache
def _jax_setup(jax_backend):
    import swiftly_tpu as J

    config = J.SwiftlyConfig(backend=jax_backend, **TEST_PARAMS)
    fcs = J.make_full_facet_cover(config)
    sgcs = J.make_full_subgrid_cover(config)
    tasks = [(fc, J.make_facet(config.image_size, fc, SOURCES)) for fc in fcs]
    return config, fcs, sgcs, tasks


@functools.cache
def _jax_forward(jax_backend, facet_group=None, col_group=None):
    """JAX's subgrids as complex host arrays."""
    from swiftly_tpu.parallel import streamed as jstreamed

    config, _, sgcs, tasks = _jax_setup(jax_backend)
    fwd = jstreamed.StreamedForward(config, tasks, residency="device",
                                    facet_group=facet_group,
                                    col_group=col_group)
    return config.core.as_complex(fwd.all_subgrids(sgcs))


@functools.cache
def _jax_backward(jax_backend):
    """JAX's facets of its resident forward fed into its sampled
    backward, complex."""
    from swiftly_tpu.parallel import streamed as jstreamed

    config, fcs, sgcs, tasks = _jax_setup(jax_backend)
    fwd = jstreamed.StreamedForward(config, tasks, residency="device")
    bwd = jstreamed.StreamedBackward(config, fcs, residency="sampled")
    jstreamed.feed_backward_passes(fwd, sgcs, [bwd])
    return config.core.as_complex(bwd.finish())


# -- the port's runs -----------------------------------------------------------


def _port_config(backend, device="cpu"):
    jcore = _jax_setup(TWINS[backend][0])[0].core
    return T.SwiftlyConfig.from_numpy_state(
        np.asarray(jcore._Fb), np.asarray(jcore._Fn), backend=backend,
        dtype=TWINS[backend][1], device=device, **TEST_PARAMS)


def _port_setup(backend, sparse=False):
    config = _port_config(backend)
    fcs = T.make_full_facet_cover(config)
    sgcs = T.make_full_subgrid_cover(config)
    if sparse:
        tasks = [(fc, T.make_sparse_facet(config.image_size, fc, SOURCES,
                                          dtype=np.float64)) for fc in fcs]
    else:
        tasks = [(fc, d) for fc, (_, d) in
                 zip(fcs, _jax_setup(TWINS[backend][0])[3])]
    return config, fcs, sgcs, tasks


@functools.cache
def _port_forward(backend, facet_group=None, col_group=None, sparse=False):
    """The port's subgrids (complex host arrays) and its last plan."""
    config, _, sgcs, tasks = _port_setup(backend, sparse)
    fwd = T.StreamedForward(config, tasks, residency="device",
                            facet_group=facet_group, col_group=col_group)
    return config.core.as_complex(fwd.all_subgrids(sgcs)), fwd.last_plan


def _close(got, ref, rel=REL):
    assert got.shape == ref.shape
    return np.abs(got - ref).max() <= rel * np.abs(ref).max()


def _assert_facets_match(config, got, ref, rows=slice(None)):
    """Facets agree to REL relative once the window Fb is divided out of
    both (the backward multiplies each facet row and column by Fb, up to
    4.9e3 at the edges here; tests/test_torch_streamed.py)."""
    fb = config.core._p.extract_mid(config.core._Fb, got.shape[-1], 0).numpy()
    w = (fb[:, None] * fb[None, :])[rows]
    assert got.shape == ref.shape
    assert (np.abs(got - ref) / w).max() / (np.abs(ref) / w).max() < REL


# -- facet-slab streaming (tests/test_streamed.py:317-378) ----------------------


@pytest.mark.parametrize("facet_group", [1, 2])
@pytest.mark.parametrize("backend", sorted(TWINS))
def test_facet_slab_streaming_matches(backend, facet_group):
    """Slab-streamed column groups give the resident path's subgrids (the
    slabs' zero padding and the cross-slab sums are exact) and JAX's
    slab-streamed subgrids."""
    got, plan = _port_forward(backend, facet_group, 4)
    assert plan["mode"] == "grouped" and plan["facet_group"] == facet_group
    assert plan["n_slabs"] == -(-9 // facet_group)
    assert plan["col_group"] == 4 and plan["facet_source"] == "host"
    ref = _port_forward(backend)[0]
    np.testing.assert_allclose(got, ref, rtol=0, atol=GROUPED_ATOL)
    assert _close(got, _jax_forward(TWINS[backend][0], facet_group, 4))


def test_facet_slab_streaming_auto_group():
    """facet_group with the column group sized automatically (the CPU
    budget is unlimited: one group)."""
    got, plan = _port_forward("planar", 2)
    assert plan["col_group"] == 5 and plan["slab_depth"] == 2
    np.testing.assert_allclose(got, _port_forward("planar")[0], rtol=0,
                               atol=GROUPED_ATOL)


def test_stack_over_the_budget_streams_slabs_of_one(monkeypatch):
    """With no facet_group, a facet stack over the device budget streams in
    slabs of one facet, its column group sized by the slab sizer."""
    config, _, sgcs, tasks = _port_setup("planar")
    fwd = T.StreamedForward(config, tasks, residency="device")
    monkeypatch.setattr(fwd, "_hbm_budget", lambda: 2e9)
    assert not fwd._facet_stack_fits()
    got = config.core.as_complex(fwd.all_subgrids(sgcs))
    assert fwd.last_plan["facet_group"] == 1
    assert fwd.last_plan["col_group"] == tstreamed.grouped_col_group_for_budget(
        fwd._base, 2e9, 5, 5, 228, True, 1, 1)
    np.testing.assert_array_equal(got, _port_forward("planar", 1)[0])


def test_slab_stream_prefetch_is_bit_identical(monkeypatch):
    """The staging thread that fills the next pinned buffer while the
    current slab computes gives the bits of the two-buffer stream without
    it (SWIFTLY_STREAM_PREFETCH=0), and the plan records the choice."""
    config, _, sgcs, tasks = _port_setup("planar")
    monkeypatch.setenv("SWIFTLY_STREAM_PREFETCH", "0")
    off = T.StreamedForward(config, tasks, residency="device", facet_group=2,
                            col_group=2)
    ref = off.all_subgrids(sgcs)
    assert off.last_plan["stream_prefetch"] is False
    monkeypatch.delenv("SWIFTLY_STREAM_PREFETCH")
    on = T.StreamedForward(config, tasks, residency="device", facet_group=2,
                           col_group=2)
    np.testing.assert_array_equal(on.all_subgrids(sgcs), ref)
    assert on.last_plan["stream_prefetch"] is True


def test_grouped_budget_accounting():
    """The slab sizer's cap, floor and monotonicity
    (tests/test_streamed.py:692), and its price of a second slab."""
    config, _, _, tasks = _port_setup("planar")
    base = T.StreamedForward(config, tasks)._base
    sizer = tstreamed.grouped_col_group_for_budget
    assert sizer(base, 1e15, 40, 5, 228, True, 1, 4) == 40
    assert sizer(base, 1.0, 40, 5, 228, True, 1, 4, warn=False) == 1
    gs = [sizer(base, b, 10**6, 5, 228, True, 1, 4)
          for b in (1e9, 4e9, 16e9, 64e9)]
    assert gs == sorted(gs) and gs[0] < gs[-1]
    assert sizer(base, 4e9, 10**6, 5, 228, True, 1, 1, slab_depth=1) >= (
        sizer(base, 4e9, 10**6, 5, 228, True, 1, 1, slab_depth=2))


# -- sparse facets (tests/test_streamed.py:711-792) -----------------------------


@pytest.mark.parametrize("k", range(9))
def test_sparse_facet_is_the_references(k):
    """``make_sparse_facet`` and ``densify`` are bitwise the JAX
    package's, and equal the dense facet's real plane."""
    import swiftly_tpu as J

    config, fcs, _, tasks = _port_setup("planar")
    fc = fcs[k]
    jfc = _jax_setup("planar")[1][k]
    got = T.make_sparse_facet(config.image_size, fc, SOURCES)
    want = J.make_sparse_facet(config.image_size, jfc, SOURCES)
    for attr in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
        assert getattr(got, attr).dtype == getattr(want, attr).dtype
    for dt in (np.float32, np.float64):
        np.testing.assert_array_equal(got.densify(dt), want.densify(dt))
    exact = T.make_sparse_facet(config.image_size, fc, SOURCES,
                                dtype=np.float64)
    np.testing.assert_allclose(exact.densify(), tasks[k][1].real, rtol=0,
                               atol=1e-12)


def test_sparse_duplicates_accumulate_as_the_reference():
    """Pixels hit more than once add in index order (``np.add.at``), as
    the JAX package's ``densify`` adds them; the coalesced pixels the
    device synthesis assigns give the same bits."""
    from swiftly_tpu.ops.oracle import SparseRealFacet as JSparse

    rng = np.random.default_rng(11)
    rows, cols = rng.integers(0, 7, 200), rng.integers(0, 7, 200)
    vals = rng.standard_normal(200).astype(np.float32)
    got = T.SparseRealFacet(7, rows, cols, vals)
    want = JSparse(7, rows, cols, vals)
    for dt in (np.float32, np.float64):
        dense = got.densify(dt)
        np.testing.assert_array_equal(dense, want.densify(dt))
        flat, v = got.coalesced(dt)
        assigned = np.zeros(49, dt)
        assigned[flat] = v
        np.testing.assert_array_equal(assigned.reshape(7, 7), dense)
    with pytest.raises(ValueError, match="equal length"):
        T.SparseRealFacet(7, rows, cols[:-1], vals)


def test_sparse_facets_match_dense():
    """Sparse facets synthesised on the device give the dense facets'
    subgrids, resident and slab-streamed, and ``synth_facet_device`` is
    the densified plane bit for bit."""
    ref = _port_forward("planar")[0]
    got, plan = _port_forward("planar", sparse=True)
    assert plan["mode"] == "resident"
    np.testing.assert_allclose(got, ref, rtol=0, atol=GROUPED_ATOL)
    got, plan = _port_forward("planar", 2, sparse=True)
    assert plan["facet_source"] == "device-synth-sparse"
    assert plan["stream_prefetch"] is False
    np.testing.assert_allclose(got, ref, rtol=0, atol=GROUPED_ATOL)
    assert _close(got, _jax_forward("planar", 2, 4))

    config, _, _, tasks = _port_setup("planar", sparse=True)
    fwd = T.StreamedForward(config, tasks, residency="device")
    assert fwd._facets_sparse
    for i in (0, 4):
        plane = fwd.synth_facet_device(i)
        assert plane.dtype == torch.float64
        assert torch.equal(plane,
                           torch.as_tensor(tasks[i][1].densify(np.float64)))


def test_mixed_sparse_dense_facets_densify():
    """A stack mixing sparse and dense facets densifies the sparse ones
    and gives the all-dense subgrids."""
    config, _, sgcs, tasks = _port_setup("planar")
    sparse = _port_setup("planar", sparse=True)[3]
    mixed = [sparse[i] if i % 2 == 0 else tasks[i] for i in range(len(tasks))]
    fwd = T.StreamedForward(config, mixed, residency="device")
    assert not fwd._facets_sparse and fwd._facets_real
    with pytest.raises(ValueError, match="sparse facets"):
        fwd.synth_facet_device(0)
    got = config.core.as_complex(fwd.all_subgrids(sgcs))
    np.testing.assert_allclose(got, _port_forward("planar")[0], rtol=0,
                               atol=GROUPED_ATOL)


def test_sparse_facets_densify_on_the_complex_backend():
    """The complex backend synthesises nothing: sparse facets densify and
    give the dense facets' subgrids, slab-streamed from the host."""
    config, _, sgcs, _ = _port_setup("torch")
    sparse = _port_setup("planar", sparse=True)[3]
    fwd = T.StreamedForward(config, sparse, residency="device",
                            facet_group=3)
    assert not fwd._facets_sparse
    got = config.core.as_complex(fwd.all_subgrids(sgcs))
    assert fwd.last_plan["facet_source"] == "host"
    np.testing.assert_allclose(got, _port_forward("torch")[0], rtol=0,
                               atol=GROUPED_ATOL)


def test_group_feeding_matches_per_column():
    """stream_column_groups + add_subgrid_group give the per-column feed's
    facets on the slab-streamed forward (tests/test_streamed.py:795)."""
    config, fcs, sgcs, tasks = _port_setup("planar")

    def forward():
        return T.StreamedForward(config, tasks, residency="device",
                                 facet_group=2, col_group=4)

    bwd_a = T.StreamedBackward(config, fcs, residency="sampled")
    for items, out in forward().stream_columns(sgcs, device_arrays=True):
        bwd_a.add_subgrid_stack([sg for _, sg in items], out[: len(items)])
    ref = bwd_a.finish()
    bwd_b = T.StreamedBackward(config, fcs, residency="sampled")
    n_cols = 0
    for per_col, group in forward().stream_column_groups(sgcs):
        n_cols += len(per_col)
        bwd_b.add_subgrid_group([[sg for _, sg in col] for col in per_col],
                                group)
    assert n_cols == len({sg.off0 for sg in sgcs})
    np.testing.assert_allclose(bwd_b.finish(), ref, rtol=0,
                               atol=GROUPED_ATOL)


# -- row slabs of the backward (tests/test_streamed.py:490, :557) ---------------


@pytest.mark.parametrize("block_mb", ["192", "1"])
@pytest.mark.parametrize("backend", sorted(TWINS))
def test_row_slab_backward_matches_whole_facet(backend, block_mb,
                                               monkeypatch):
    """One forward fed to the whole-facet backward and to two row slabs
    split at a height that is no multiple of the fold's row block: the
    slabs concatenated are the whole, bit for bit, and JAX's facets.
    SWIFTLY_FOLD_BLOCK_MB=1 makes blocks of 33 rows, so each slab folds
    in several blocks and a clamped last one."""
    monkeypatch.setenv("SWIFTLY_FOLD_BLOCK_MB", block_mb)
    config, fcs, sgcs, tasks = _port_setup(backend)
    yB = fcs[0].size
    fwd = T.StreamedForward(config, tasks, residency="device")
    whole = T.StreamedBackward(config, fcs, residency="sampled")
    slabs = [T.StreamedBackward(config, fcs, residency="sampled",
                                row_slab=rows) for rows in ((0, 150),
                                                            (150, yB))]
    assert T.feed_backward_passes(fwd, sgcs, [whole] + slabs) == 1
    full = whole.finish()
    parts = [b.finish() for b in slabs]
    assert [p.shape[1] for p in parts] == [150, yB - 150]
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), full)
    np.testing.assert_allclose(np.concatenate(parts, axis=1), full, rtol=0,
                               atol=SLAB_ATOL)
    _assert_facets_match(config, config.core.as_complex(parts[1]),
                         _jax_backward(TWINS[backend][0])[:, 150:],
                         rows=slice(150, None))


def test_row_slab_validation():
    config, fcs, _, _ = _port_setup("planar")
    yB = fcs[0].size
    with pytest.raises(ValueError, match="residency"):
        T.StreamedBackward(config, fcs, residency="device", row_slab=(0, 10))
    for rows in ((10, yB + 1), (5, 5), (-1, 10)):
        with pytest.raises(ValueError, match="rows"):
            T.StreamedBackward(config, fcs, residency="sampled", row_slab=rows)
    bwd = T.StreamedBackward(config, fcs, residency="sampled",
                             row_slab=(3, 40))
    with pytest.raises(RuntimeError, match="No subgrids"):
        bwd.finish()


# -- the 128k proxies (tests/test_128k.py:145, :345) ----------------------------


@functools.cache
def _proxy():
    """The port's and JAX's 128k proxy configurations (complex backends),
    the port's facet tasks and the 2 x 2 corner of the subgrid cover."""
    import swiftly_tpu as J

    jconfig = J.SwiftlyConfig(backend="jax", **PROXY_PARAMS)
    config = T.SwiftlyConfig.from_numpy_state(
        np.asarray(jconfig.core._Fb), np.asarray(jconfig.core._Fn),
        backend="torch", dtype=torch.complex128, device="cpu", **PROXY_PARAMS)
    fcs = [FacetConfig(0, 0, 1024), FacetConfig(0, 768, 1024)]
    tasks = [(fc, T.make_facet(config.image_size, fc, PROXY_SOURCES))
             for fc in fcs]
    sgcs = [SubgridConfig(o0, o1, 448) for o0 in (0, 448) for o1 in (0, 448)]
    return jconfig, config, fcs, tasks, sgcs


@functools.cache
def _jax_proxy(roundtrip):
    from swiftly_tpu.models.config import FacetConfig as JFacet
    from swiftly_tpu.models.config import SubgridConfig as JSubgrid
    from swiftly_tpu.parallel import streamed as jstreamed

    jconfig, _, fcs, tasks, sgcs = _proxy()
    jfcs = [JFacet(fc.off0, fc.off1, fc.size) for fc in fcs]
    jsgcs = [JSubgrid(sg.off0, sg.off1, sg.size) for sg in sgcs]
    jtasks = [(jfc, d) for jfc, (_, d) in zip(jfcs, tasks)]
    fwd = jstreamed.StreamedForward(jconfig, jtasks, residency="device")
    if not roundtrip:
        return np.asarray(fwd.all_subgrids(jsgcs))
    bwd = jstreamed.StreamedBackward(jconfig, jfcs, residency="sampled")
    jstreamed.feed_backward_passes(fwd, jsgcs, [bwd])
    return np.asarray(bwd.finish())


@pytest.mark.parametrize("facet_group", [None, 1])
def test_128k_proxy_streamed_forward_vs_oracle(facet_group):
    """The forward at N = 131072 with the full yN = 65536, resident and in
    slabs of one facet, against the direct-DFT oracle (the single source
    lies inside facet (0, 0), so the two facets' sum is the whole cover's)
    and JAX's forward."""
    _, config, _, tasks, sgcs = _proxy()
    fwd = T.StreamedForward(config, tasks, residency="device",
                            facet_group=facet_group)
    out = fwd.all_subgrids(sgcs)
    assert fwd.last_plan["mode"] == ("resident" if facet_group is None
                                     else "grouped")
    for i, sg in enumerate(sgcs):
        assert T.check_subgrid(config.image_size, sg, out[i],
                               PROXY_SOURCES) < 1e-8
    assert _close(out, _jax_proxy(False))


def test_128k_proxy_row_slab_roundtrip():
    """At the 128k proxy geometry, one slab-streamed forward feeds two
    row-slab backwards and the whole-facet one through
    ``feed_backward_passes``: the slabs concatenated are the whole, bit
    for bit, and JAX's round trip to 1e-12."""
    _, config, fcs, tasks, sgcs = _proxy()
    fwd = T.StreamedForward(config, tasks, residency="device", facet_group=1)
    slabs = [T.StreamedBackward(config, fcs, residency="sampled",
                                row_slab=rows) for rows in ((0, 600),
                                                            (600, 1024))]
    whole = T.StreamedBackward(config, fcs, residency="sampled")
    assert T.feed_backward_passes(fwd, sgcs, slabs + [whole]) == 1
    full = whole.finish()
    cat = np.concatenate([b.finish() for b in slabs], axis=1)
    np.testing.assert_array_equal(cat, full)
    np.testing.assert_allclose(cat, _jax_proxy(True), rtol=0, atol=SLAB_ATOL)


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned staging ring, the copy "
                    "stream and kernels B1 and B2 run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_slab_streams_match_resident(cuda_device):
    """On the card, in float64: host slabs through the pinned ring and the
    copy stream (prefetch on), and sparse facets synthesised on the card,
    give the resident subgrids to 1e-10, reruns bit for bit; row slabs
    concatenated are the whole backward bit for bit."""
    from swiftly_tpu_torch.ops.oracle import make_facet_from_sources

    config = T.SwiftlyConfig(backend="planar", dtype=torch.float64,
                             device=cuda_device, **TEST_PARAMS)
    fcs = T.make_full_facet_cover(config)
    sgcs = T.make_full_subgrid_cover(config)
    dense = [(fc, make_facet_from_sources(SOURCES, 1024, fc.size,
                                          [fc.off0, fc.off1],
                                          [fc.mask0, fc.mask1])) for fc in fcs]
    sparse = [(fc, T.make_sparse_facet(1024, fc, SOURCES, dtype=np.float64))
              for fc in fcs]
    ref = T.StreamedForward(config, dense).all_subgrids(sgcs)
    for tasks, fg in ((dense, 2), (dense, 1), (sparse, 3)):
        runs = [T.StreamedForward(config, tasks, facet_group=fg, col_group=2)
                for _ in range(2)]
        outs = [f.all_subgrids(sgcs) for f in runs]
        assert runs[0].last_plan["mode"] == "grouped"
        np.testing.assert_allclose(outs[0], ref, rtol=0, atol=GROUPED_ATOL)
        np.testing.assert_array_equal(outs[0], outs[1])
    fwd = T.StreamedForward(config, sparse, facet_group=1)
    whole = T.StreamedBackward(config, fcs)
    slabs = [T.StreamedBackward(config, fcs, row_slab=r)
             for r in ((0, 150), (150, 416))]
    T.feed_backward_passes(fwd, sgcs, [whole] + slabs)
    full = whole.finish_device()
    cat = torch.cat([b.finish_device() for b in slabs], dim=1)
    assert torch.equal(cat, full)
