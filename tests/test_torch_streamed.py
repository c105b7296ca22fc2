"""The port's streamed slice as a whole: the facets-resident forward and the
sampled backward, against the JAX package's ``StreamedForward`` /
``StreamedBackward`` at ``tests/test_streamed.py``'s TEST_PARAMS.

The port's configurations take the JAX core's window constants
(``SwiftlyConfig.from_numpy_state``), and both packages get the same
facets and subgrid data (numpy, from the analytic oracle or a seed).
Backends: port "planar" float64 against JAX "planar", port "torch"
complex128 against JAX "jax". Bounds:

* subgrids agree to 1e-12 x max|subgrid| (f64 rounding is ~1e-15);
* facets agree to 1e-12 relative once the facet window Fb is divided out
  of both: the backward multiplies each facet row and column by Fb, which
  rises to 4.9e3 at the facet edges here, so rounding differences of
  ~1e-16 between two summation orders become ~1e-11 of the largest value
  at the corner pixels (and the JAX package's own two backends differ by
  as much); the window-free values agree to ~4e-16;
* facets meet the reference's oracle bound, RMS < 3e-10.

The round trips run on the CPU. The planar backend takes the kernel bodies
of the column passes and the fold (B1, B2), whose wrappers run the
kernels' plain versions on CPU tensors; the complex backend takes the
complex einsum bodies. Each reference is computed once per module; torch runs on one intra-op thread.
The oracle check runs per facet, which also makes this file one of the
first that pytest-xdist's loadfile queue (largest files first) hands out,
so its JAX references run early, away from ``tests/test_sharded.py``
(ROADMAP §C).
"""

import functools

import numpy as np
import pytest
import torch

import swiftly_tpu as J
import swiftly_tpu_torch as T
from swiftly_tpu.parallel import streamed as jstreamed
from swiftly_tpu_torch.parallel import streamed as tstreamed
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
# the imaginary plane of the complex-facet test: point sources too (random
# dense planes are ill-conditioned here: the forward multiplies every facet
# pixel by Fb, up to 4.9e3 at the facet edges, before the band limit
# cancels them)
IMAG_SOURCES = [(0.75, 20, -10), (0.25, -100, 60)]
TWINS = {"planar": ("planar", torch.float64), "torch": ("jax", torch.complex128)}
REL = 1e-12
RMS_BOUND = 3e-10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _jax_setup(jax_backend):
    config = J.SwiftlyConfig(backend=jax_backend, **TEST_PARAMS)
    fcs = J.make_full_facet_cover(config)
    sgcs = J.make_full_subgrid_cover(config)
    tasks = [(fc, J.make_facet(config.image_size, fc, SOURCES)) for fc in fcs]
    return config, fcs, sgcs, tasks


@functools.cache
def _jax_roundtrip(jax_backend):
    """JAX's (host subgrids in device layout, complex facets) of the
    facets-resident forward fed into the sampled backward."""
    config, fcs, sgcs, tasks = _jax_setup(jax_backend)
    fwd = jstreamed.StreamedForward(config, tasks, residency="device")
    subgrids = fwd.all_subgrids(sgcs)
    bwd = jstreamed.StreamedBackward(config, fcs, residency="sampled")
    jstreamed.feed_backward_passes(fwd, sgcs, [bwd])
    return subgrids, config.core.as_complex(bwd.finish())


def _port_config(backend):
    jcore = _jax_setup(TWINS[backend][0])[0].core
    return T.SwiftlyConfig.from_numpy_state(
        np.asarray(jcore._Fb), np.asarray(jcore._Fn), backend=backend,
        dtype=TWINS[backend][1], device="cpu", **TEST_PARAMS)


def _port_setup(backend):
    config = _port_config(backend)
    fcs = T.make_full_facet_cover(config)
    sgcs = T.make_full_subgrid_cover(config)
    tasks = [(fc, d) for fc, (_, d) in zip(fcs, _jax_setup(TWINS[backend][0])[3])]
    return config, fcs, sgcs, tasks


@functools.cache
def _port_forward(backend, col_group=None):
    config, _, sgcs, tasks = _port_setup(backend)
    fwd = T.StreamedForward(config, tasks, residency="device",
                            col_group=col_group)
    return config.core.as_complex(fwd.all_subgrids(sgcs))


@functools.cache
def _port_roundtrip(backend):
    config, fcs, sgcs, tasks = _port_setup(backend)
    fwd = T.StreamedForward(config, tasks, residency="device")
    bwd = T.StreamedBackward(config, fcs, residency="sampled")
    n_groups = T.feed_backward_passes(fwd, sgcs, [bwd])
    assert n_groups == 1  # the CPU budget is unlimited: one column group
    return config.core.as_complex(bwd.finish())


def _window(config):
    fb = config.core._p.extract_mid(config.core._Fb, TEST_PARAMS["yB_size"], 0)
    fb = fb.numpy()
    return fb[:, None] * fb[None, :]


def _assert_facets_match(config, got, ref):
    """Facets agree to REL relative with the window Fb divided out."""
    w = _window(config)
    assert got.shape == ref.shape
    assert (np.abs(got - ref) / w).max() / (np.abs(ref) / w).max() < REL


def _subgrid_tasks(backend, subgrids, order=None):
    """(SubgridConfig, data) pairs of the port's cover over `subgrids`."""
    sgcs = _port_setup(backend)[2]
    order = range(len(sgcs)) if order is None else order
    return [(sgcs[i], subgrids[i]) for i in order]


@pytest.mark.parametrize("backend", sorted(TWINS))
def test_streamed_forward_matches_reference(backend):
    j_sg = _jax_setup(TWINS[backend][0])[0].core.as_complex(
        _jax_roundtrip(TWINS[backend][0])[0])
    t_sg = _port_forward(backend)
    assert t_sg.shape == j_sg.shape
    assert np.abs(t_sg - j_sg).max() <= REL * np.abs(j_sg).max()


@pytest.mark.parametrize("k", range(5))
def test_streamed_forward_meets_oracle(k):
    """Column k's subgrids against the direct-DFT oracle (the reference's
    streamed bound, 1e-9 RMS)."""
    config, _, sgcs, _ = _port_setup("planar")
    out = _port_forward("planar")
    offs0 = sorted({sg.off0 for sg in sgcs})
    col = [i for i, sg in enumerate(sgcs) if sg.off0 == offs0[k]]
    assert col
    for i in col:
        assert T.check_subgrid(config.image_size, sgcs[i], out[i], SOURCES) < 1e-9


@pytest.mark.parametrize("col_group", [1, 2])
def test_column_groups_equal_the_whole_group_run(col_group):
    np.testing.assert_array_equal(_port_forward("planar", col_group),
                                  _port_forward("planar"))


def test_kernel_bodies_match_einsum_bodies():
    """The planar backend's kernel bodies (B1 forward and adjoint, B2), run
    on the CPU through the wrappers' plain versions, give the complex
    backend's einsum bodies' round trip, and launch nothing."""
    config, fcs, sgcs, tasks = _port_setup("planar")
    for stats in (T.cmatmul_stats, T.colpass_stats, T.fold_stats):
        stats.reset()
    fwd = T.StreamedForward(config, tasks, residency="device")
    subgrids = fwd.all_subgrids(sgcs)
    assert fwd.last_plan["colpass"] == "kernel"
    sg = config.core.as_complex(subgrids)
    ref = _port_forward("torch")
    assert np.abs(sg - ref).max() <= REL * np.abs(ref).max()
    bwd = T.StreamedBackward(config, fcs, residency="sampled")
    bwd.add_subgrids(_subgrid_tasks("planar", subgrids))
    got = config.core.as_complex(bwd.finish())
    _assert_facets_match(config, got, _port_roundtrip("torch"))
    assert T.colpass_stats.launches == T.fold_stats.launches == 0
    assert T.cmatmul_stats.launches == 0


def test_real_and_complex_facet_inputs_agree():
    """Point-source facets take the real-plane path; facets with imaginary
    content the planar-pair path, which matches JAX's on the same facets
    and, by linearity, the real path run on each plane."""
    config, _, sgcs, tasks = _port_setup("planar")
    imag = [J.make_facet(config.image_size, fc, IMAG_SOURCES).real
            for fc, _ in tasks]
    cplx = [(fc, d + 1j * im) for (fc, d), im in zip(tasks, imag)]
    fwd = T.StreamedForward(config, cplx, residency="device")
    assert not fwd._facets_real
    got = config.core.as_complex(fwd.all_subgrids(sgcs))

    jconfig, _, jsgcs, jtasks = _jax_setup("planar")
    jfwd = jstreamed.StreamedForward(
        jconfig, [(fc, d + 1j * im) for (fc, d), im in zip(jtasks, imag)],
        residency="device")
    ref = jconfig.core.as_complex(jfwd.all_subgrids(jsgcs))
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max()

    real_fwd = T.StreamedForward(config, [(fc, im) for (fc, _), im in
                                          zip(tasks, imag)], residency="device")
    assert real_fwd._facets_real and real_fwd._facet_data[0].ndim == 2
    from_planes = _port_forward("planar") + 1j * config.core.as_complex(
        real_fwd.all_subgrids(sgcs))
    assert np.abs(got - from_planes).max() <= REL * np.abs(got).max()


@pytest.mark.parametrize("backend", sorted(TWINS))
def test_sampled_backward_matches_reference(backend):
    config = _port_setup(backend)[0]
    _assert_facets_match(config, _port_roundtrip(backend),
                         _jax_roundtrip(TWINS[backend][0])[1])


@pytest.mark.parametrize("k", range(9))
@pytest.mark.parametrize("backend", sorted(TWINS))
def test_sampled_backward_meets_oracle(backend, k):
    """Facet k of the streamed round trip meets the reference's bound."""
    config, fcs, _, _ = _port_setup(backend)
    assert len(fcs) == 9
    got = _port_roundtrip(backend)
    assert T.check_facet(config.image_size, fcs[k], got[k], SOURCES) < RMS_BOUND


@pytest.mark.parametrize("feed", ["add_subgrids", "add_subgrid_group"])
def test_sampled_backward_feeds_agree(feed):
    """JAX's subgrids fed through each entry point give JAX's facets."""
    config, fcs, sgcs, _ = _port_setup("planar")
    subgrids = _jax_roundtrip("planar")[0]
    bwd = T.StreamedBackward(config, fcs, residency="sampled", fold_group=2)
    if feed == "add_subgrids":
        bwd.add_subgrids(_subgrid_tasks("planar", subgrids))
    else:
        offs0 = sorted({sg.off0 for sg in sgcs})
        for g0 in range(0, len(offs0), 3):  # groups of 3 columns, then 2
            cols = [[i for i, sg in enumerate(sgcs) if sg.off0 == o]
                    for o in offs0[g0:g0 + 3]]
            stack = torch.as_tensor(np.stack([subgrids[c] for c in cols]))
            bwd.add_subgrid_group([[sgcs[i] for i in c] for c in cols], stack)
    got = config.core.as_complex(bwd.finish())
    _assert_facets_match(config, got, _jax_roundtrip("planar")[1])


def test_feed_backward_passes_over_two_facet_subsets():
    """One feed serves two backward passes over disjoint facet subsets;
    together they give the whole-stack backward."""
    config, fcs, sgcs, tasks = _port_setup("planar")
    fwd = T.StreamedForward(config, tasks, residency="device")
    parts = [fcs[:4], fcs[4:]]
    bwds = [T.StreamedBackward(config, p, residency="sampled") for p in parts]
    seen = []
    assert T.feed_backward_passes(fwd, sgcs, bwds, progress=seen.append) == 1
    assert seen == [2 * len(sgcs)]
    got = np.concatenate([config.core.as_complex(b.finish()) for b in bwds])
    _assert_facets_match(config, got, _jax_roundtrip("planar")[1])
    for i, fc in enumerate(fcs):
        assert T.check_facet(config.image_size, fc, got[i], SOURCES) < RMS_BOUND


def test_sampled_backward_is_order_independent():
    """Subgrids fed in a shuffled order (columns taken in the order their
    first subgrid appears, subgrids shuffled within each column, a fold
    group that straddles columns) give the ordered feed's facets."""
    config, fcs, sgcs, _ = _port_setup("planar")
    subgrids = _jax_roundtrip("planar")[0]
    order = np.random.default_rng(5).permutation(len(sgcs))
    bwd = T.StreamedBackward(config, fcs, residency="sampled", fold_group=3)
    bwd.add_subgrids(_subgrid_tasks("planar", subgrids, order))
    got = config.core.as_complex(bwd.finish())
    _assert_facets_match(config, got, _port_roundtrip("planar"))


def test_fold_row_blocking_is_exact(monkeypatch):
    """Row blocks smaller than the facet, with a clamped last block
    (416 % 128 != 0), give the single-block fold."""
    config, fcs, sgcs, _ = _port_setup("planar")
    monkeypatch.setenv("SWIFTLY_FOLD_BLOCK_MB", "4")
    assert tstreamed._fold_row_block(len(fcs), 416, 8) == 128
    subgrids = _jax_roundtrip("planar")[0]
    bwd = T.StreamedBackward(config, fcs, residency="sampled")
    bwd.add_subgrids(_subgrid_tasks("planar", subgrids))
    got = config.core.as_complex(bwd.finish())
    _assert_facets_match(config, got, _port_roundtrip("planar"))


def test_host_helpers_match_reference():
    """Row indices, the int64 phase product (exact at N = 32k and beyond)
    and the real facet plane are the JAX package's."""
    jconfig, fcs, sgcs, _ = _jax_setup("planar")
    config = _port_config("planar")
    offs = sorted({sg.off0 for sg in sgcs})
    np.testing.assert_array_equal(
        tstreamed.sampled_row_indices(config.core, offs),
        jstreamed.sampled_row_indices(jconfig.core, offs))
    for yN in (512, 16384, 65536):
        a = np.random.default_rng(yN).integers(-2**40, 2**40, size=200)
        b = np.random.default_rng(yN + 1).integers(-yN, 3 * yN, size=200)
        got = tstreamed._mulmod(torch.as_tensor(a), torch.as_tensor(b), yN)
        want = [(int(x) * int(y)) % yN for x, y in zip(a, b)]
        assert got.tolist() == want
    for fc in fcs[:3]:
        got = T.make_real_facet(1024, fc, SOURCES)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(
            got, J.make_real_facet(1024, fc, SOURCES))
        np.testing.assert_array_equal(
            T.make_real_facet(1024, fc, SOURCES, dtype=np.float64),
            T.make_facet(1024, fc, SOURCES).real)


def test_col_group_budget_accounting():
    config, _, _, tasks = _port_setup("torch")
    fwd = T.StreamedForward(config, tasks, residency="device")
    base = fwd._base
    assert tstreamed.col_group_for_budget(base, 1e15, 7) == 7
    assert tstreamed.col_group_for_budget(base, 1.0, 7) == 1
    gs = [tstreamed.col_group_for_budget(base, b, 10**6)
          for b in (1e9, 4e9, 16e9, 64e9)]
    assert gs == sorted(gs)
    assert fwd._hbm_budget() is None and fwd._facet_stack_fits()
    # the port's sizer prices the port's own buffers: per column, its
    # sampled rows [F, m, yB] and its finished subgrids [S, xA, xA] beside
    # the previous group's (complex128: 16 bytes), plus the group tensors;
    # flat, the facets, one column's transients and the reserve
    core = config.core
    F, yB, m = len(base.stack), base.stack.size, core.xM_yN_size
    xA = config.max_subgrid_size
    S = -(-config.image_size // xA)
    flat, per_G = tstreamed.resident_working_set(base)
    assert per_G == (F * m * yB + 2 * S * xA * xA) * 16 + S * (2 * xA * 8 + 16)
    assert flat > tstreamed.facet_stack_bytes(base) + tstreamed._RESERVE_BYTES
    for budget in (2e9, 8e9, 32e9):
        assert tstreamed.col_group_for_budget(base, budget, 10**6) == max(
            1, int((budget - flat) // per_G))


def test_stream_peak_model_follows_the_stream_phases():
    """``stream_peak_bytes``: a consumer's resting bytes count beside the
    second group on, not beside the first (it allocates at its first
    fold); the caller's held bytes add; a sampled backward's resting and
    active bytes are its accumulator plus its fold rows."""
    config, fcs, sgcs, tasks = _port_setup("planar")
    fwd = T.StreamedForward(config, tasks, residency="device")
    n_cols = len({sg.off0 for sg in sgcs})
    S, xA = len(sgcs) // n_cols, sgcs[0].size
    fwd.last_plan = {"mode": "resident", "col_group": n_cols}
    one = tstreamed.stream_peak_bytes(fwd, n_cols, S, xA, resting=1e12)
    assert one < 1e12
    assert tstreamed.stream_peak_bytes(fwd, n_cols, S, xA, resting=1e12,
                                       held=5) == one + 5
    fwd.last_plan = {"mode": "resident", "col_group": n_cols - 1}
    assert tstreamed.stream_peak_bytes(fwd, n_cols, S, xA,
                                       resting=1e12) > 1e12
    bwd = T.StreamedBackward(config, fcs, residency="sampled", fold_group=3)
    resting, active = bwd.device_bytes(S, xA)
    yB, m = fcs[0].size, config.core.xM_yN_size
    acc, row = len(fcs) * yB * yB * 16, len(fcs) * m * yB * 16
    assert resting == acc + 2 * row and active > resting
    assert T.StreamedBackward(config, fcs, residency="host").device_bytes(
        S, xA)[0] == 0


def test_left_out_paths_raise(monkeypatch):
    """The host and device residencies construct and run (a column each
    way), and ``spill=`` records a stream that a later call replays; what
    is still missing or refused raises: the sampled-only entry points on
    the kept residencies, and ``row_slab`` with a fold other than the
    sampled one."""
    config, fcs, sgcs, tasks = _port_setup("planar")
    with pytest.raises(ValueError, match="StreamedBackward strategy"):
        T.StreamedForward(config, tasks, residency="sampled")
    for residency in ("host", "device"):
        fwd = T.StreamedForward(config, tasks, residency=residency)
        items, sub = next(fwd.stream_columns(sgcs))
        col = [sg for _, sg in items]
        bwd = T.StreamedBackward(config, fcs, residency=residency)
        bwd.add_subgrid_stack(col, sub)
        with pytest.raises(ValueError, match="requires residency='sampled'"):
            bwd.add_subgrid_group([col], torch.as_tensor(sub[None]))
        with pytest.raises(ValueError, match="requires residency='sampled'"):
            bwd.finish_device()
        assert bwd.finish().shape == (len(fcs), 416, 416, 2)
    with pytest.raises(ValueError, match="sampled-path"):
        next(T.StreamedForward(config, tasks).stream_column_groups(sgcs))
    # spill= records the stream and a later call replays it, bit for bit
    fwd = T.StreamedForward(config, tasks, residency="device")
    spill = SpillCache(budget_bytes=2**30)
    recorded = [g.clone() for _, g in
                fwd.stream_column_groups(sgcs, spill=spill)]
    assert spill.complete and fwd.last_spill["mode"] == "record"
    replayed = [g for _, g in fwd.stream_column_groups(sgcs, spill=spill)]
    assert fwd.last_spill["mode"] == "replay"
    assert len(replayed) == len(recorded)
    assert all(torch.equal(a, b) for a, b in zip(recorded, replayed))
    for fold in ("ct", "fft"):
        monkeypatch.setenv("SWIFTLY_FOLD", fold)
        with pytest.raises(ValueError, match="sampled fold"):
            T.StreamedBackward(config, fcs, residency="sampled",
                               row_slab=(0, 10))
    monkeypatch.delenv("SWIFTLY_FOLD")
    numpy_config = T.SwiftlyConfig(backend="numpy", **TEST_PARAMS)
    with pytest.raises(ValueError, match="device backend"):
        T.StreamedForward(numpy_config, tasks)
    for residency in ("host", "sampled"):
        bwd = T.StreamedBackward(config, fcs, residency=residency)
        with pytest.raises(RuntimeError, match="No subgrids"):
            bwd.finish()


def test_streamed_modules_stand_alone_and_pick_plain_bodies_on_the_cpu():
    """The streamed and kernel modules import with JAX blocked, and the
    body resolvers choose by backend: the kernel bodies for planar (on the
    CPU their wrappers run the plain versions), the complex einsum bodies
    for the complex backend."""
    import subprocess
    import sys
    from pathlib import Path

    from swiftly_tpu_torch.utils import flops

    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['swiftly_tpu'] = None; "
        "import swiftly_tpu_torch.parallel.streamed, swiftly_tpu_torch.ops.kernels; "
        "assert not any(m == 'jax' or m.startswith(('jax.', 'swiftly_tpu.')) "
        "for m in sys.modules if sys.modules[m] is not None)"
    )
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=Path(__file__).resolve().parent.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    planar, cplx = _port_config("planar").core, _port_config("torch").core
    resolvers = (lambda c: flops.resolve_colpass(c, 9),
                 lambda c: flops.resolve_colpass_bwd(c, 9),
                 flops.resolve_fold_kernel)
    for resolve in resolvers:
        assert resolve(planar) == "kernel"
        assert resolve(cplx) == "einsum"
