"""The port's host and device residencies, FFT column bodies and FFT/CT
folds against the JAX package's ``StreamedForward`` / ``StreamedBackward``
at ``tests/test_streamed.py``'s TEST_PARAMS, in float64.

Both packages get the same facets and subgrid data (numpy, from the
analytic oracle or a seed); the port's configurations take the JAX core's
window constants (``SwiftlyConfig.from_numpy_state``). Backends: port
"planar" float64 against JAX "planar", port "torch" complex128 against JAX
"jax". Bounds:

* subgrids agree to 1e-12 x max|subgrid| (f64 rounding is ~1e-15);
* facets agree to 1e-12 relative once the facet window Fb is divided out
  of both (``tests/test_torch_streamed.py`` says why: Fb rises to 4.9e3 at
  the facet edges here and scales the rounding of two summation orders
  with it);
* facets meet the reference's oracle bound, RMS < 3e-10;
* one column's bodies agree to 1e-10 of the largest value (Fb divided out
  of the backward's rows), the reference's own bound for its bodies
  (``tests/test_streamed.py:857-990``).

Each JAX result is computed once per module; torch runs on one intra-op
thread. The planar backend's default bodies are the kernel bodies (B1,
B2), whose wrappers run the kernels' plain versions on CPU tensors; B3
runs its plain version under every DFT of n <= 1024.
"""

import functools

import numpy as np
import pytest
import torch

import swiftly_tpu as J
import swiftly_tpu_torch as T
from swiftly_tpu.parallel import streamed as jstreamed
from swiftly_tpu.utils import flops as jflops
from swiftly_tpu_torch.parallel import streamed as tstreamed
from swiftly_tpu_torch.utils import flops as tflops

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
REL = 1e-12
BODY_REL = 1e-10
RMS_BOUND = 3e-10
KNOBS = ("SWIFTLY_COLPASS", "SWIFTLY_COLPASS_BWD", "SWIFTLY_FOLD")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _default_knobs(monkeypatch):
    """Every test starts from the default bodies."""
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)


@functools.cache
def _jax_setup(jax_backend):
    config = J.SwiftlyConfig(backend=jax_backend, **TEST_PARAMS)
    fcs = J.make_full_facet_cover(config)
    sgcs = J.make_full_subgrid_cover(config)
    tasks = [(fc, J.make_facet(config.image_size, fc, SOURCES)) for fc in fcs]
    return config, fcs, sgcs, tasks


@functools.cache
def _jax_host_forward(jax_backend, col_block):
    """JAX's host forward: every subgrid, in device layout."""
    config, _, sgcs, tasks = _jax_setup(jax_backend)
    fwd = jstreamed.StreamedForward(config, tasks, col_block=col_block,
                                    residency="host")
    return fwd.all_subgrids(sgcs)


@functools.cache
def _jax_backward(jax_backend, residency):
    """JAX's backward through one residency, fed its host forward's
    subgrids (col_block 128): the round trip of tests/test_streamed.py:76
    and the folds' reference (:390), its facets as complex."""
    config, fcs, sgcs, _ = _jax_setup(jax_backend)
    subgrids = _jax_host_forward(jax_backend, 128)
    bwd = jstreamed.StreamedBackward(config, fcs, col_block=128,
                                     residency=residency)
    bwd.add_subgrids([(sg, subgrids[i]) for i, sg in enumerate(sgcs)])
    return config.core.as_complex(bwd.finish())


def _port_config(backend):
    jcore = _jax_setup(TWINS[backend][0])[0].core
    return T.SwiftlyConfig.from_numpy_state(
        np.asarray(jcore._Fb), np.asarray(jcore._Fn), backend=backend,
        dtype=TWINS[backend][1], device="cpu", **TEST_PARAMS)


def _port_setup(backend):
    config = _port_config(backend)
    fcs = T.make_full_facet_cover(config)
    sgcs = T.make_full_subgrid_cover(config)
    tasks = [(fc, d) for fc, (_, d) in
             zip(fcs, _jax_setup(TWINS[backend][0])[3])]
    return config, fcs, sgcs, tasks


@functools.cache
def _port_host_forward(backend, col_block):
    config, _, sgcs, tasks = _port_setup(backend)
    fwd = T.StreamedForward(config, tasks, col_block=col_block)
    out = fwd.all_subgrids(sgcs)
    return out, fwd.last_plan


def _subgrid_tasks(backend):
    """The port's cover with its host forward's subgrids (col_block 128)."""
    sgcs = _port_setup(backend)[2]
    subgrids = _port_host_forward(backend, 128)[0]
    return [(sg, subgrids[i]) for i, sg in enumerate(sgcs)]


@functools.cache
def _port_backward(backend, residency):
    """The port's backward through one residency, fed its host forward's
    subgrids: with `_port_host_forward`, the port's round trip."""
    config, fcs, _, _ = _port_setup(backend)
    bwd = T.StreamedBackward(config, fcs, col_block=128, residency=residency)
    bwd.add_subgrids(_subgrid_tasks(backend))
    return config.core.as_complex(bwd.finish())


def _fb(config):
    fb = config.core._p.extract_mid(config.core._Fb, TEST_PARAMS["yB_size"], 0)
    return fb.numpy()


def _assert_facets_match(config, got, ref):
    """Facets agree to REL relative with the window Fb divided out."""
    fb = _fb(config)
    w = fb[:, None] * fb[None, :]
    assert got.shape == ref.shape
    assert (np.abs(got - ref) / w).max() / (np.abs(ref) / w).max() < REL


def _max_rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(
        np.asarray(ref)).max()


# -- the host forward ---------------------------------------------------------


@pytest.mark.parametrize("col_block", [416, 128])  # one block / ragged
@pytest.mark.parametrize("backend", sorted(TWINS))
def test_host_forward_matches_reference(backend, col_block):
    got, plan = _port_host_forward(backend, col_block)
    ref = _jax_host_forward(TWINS[backend][0], col_block)
    assert plan["mode"] == "host"
    assert plan["n_blocks"] == -(-416 // col_block)
    assert plan["column_uploads"] == 5
    assert got.shape == ref.shape
    assert _max_rel(got, ref) <= REL


@pytest.mark.parametrize("backend", sorted(TWINS))
def test_host_forward_meets_oracle(backend):
    """Every subgrid of the host forward against the direct-DFT oracle
    (the reference's bound, tests/test_streamed.py:59)."""
    config, _, sgcs, _ = _port_setup(backend)
    out = _port_host_forward(backend, 128)[0]
    for i, sg in enumerate(sgcs):
        err = T.check_subgrid(config.image_size, sg,
                              config.core.as_complex(out[i]), SOURCES)
        assert err < 1e-9


def test_sparse_facets_densify_on_host_residency():
    """Sparse descriptors densify on the host residency (only the sampled
    paths synthesise them) into the dense facets' real planes, and give
    their subgrids (the first column's)."""
    config, fcs, sgcs, tasks = _port_setup("planar")
    sparse = [(fc, T.make_sparse_facet(config.image_size, fc, SOURCES,
                                       dtype=np.float64)) for fc in fcs]
    fwd = T.StreamedForward(config, sparse, col_block=128)
    assert not fwd._facets_sparse and fwd._facets_real
    for got, (_, dense) in zip(fwd._facet_data, tasks):
        np.testing.assert_allclose(got, dense.real, rtol=0, atol=1e-15)
    items, out = next(fwd.stream_columns(sgcs))
    ref = _port_host_forward("planar", 128)[0][[i for i, _ in items]]
    assert _max_rel(out, ref) <= REL


# -- the host and device residencies' round trips -----------------------------


@pytest.mark.parametrize("residency", ["host", "device"])
@pytest.mark.parametrize("backend", sorted(TWINS))
def test_residency_roundtrip_matches_reference(backend, residency):
    config, fcs, _, _ = _port_setup(backend)
    got = _port_backward(backend, residency)
    _assert_facets_match(config, got, _jax_backward(TWINS[backend][0],
                                                    residency))
    for i, fc in enumerate(fcs):
        assert T.check_facet(config.image_size, fc, got[i],
                             SOURCES) < RMS_BOUND


def test_residencies_default_to_host():
    config, fcs, _, tasks = _port_setup("planar")
    assert T.StreamedForward(config, tasks)._base.residency == "host"
    assert T.StreamedBackward(config, fcs)._base.residency == "host"


# -- the sampled backward's folds ---------------------------------------------


@pytest.mark.parametrize(
    "fold_group,fold_mode",
    [
        (1, "sampled"),
        (3, "sampled"),
        (1, "fft"),
        (1, "ct"),
        # as tests/test_streamed.py:398-405 marks them
        pytest.param(3, "fft", marks=pytest.mark.slow),
        pytest.param(3, "ct", marks=pytest.mark.slow),
    ],
)
@pytest.mark.parametrize("backend", sorted(TWINS))
def test_sampled_folds_match_the_fft_backward(backend, fold_group, fold_mode,
                                              monkeypatch):
    """Each fold body of the sampled residency gives the device
    residency's backward (the FFT facet pass), the port's and JAX's."""
    monkeypatch.setenv("SWIFTLY_FOLD", fold_mode)
    config, fcs, _, _ = _port_setup(backend)
    bwd = T.StreamedBackward(config, fcs, residency="sampled",
                             fold_group=fold_group)
    assert bwd._fold_mode == fold_mode
    bwd.add_subgrids(_subgrid_tasks(backend))
    got = config.core.as_complex(bwd.finish())
    _assert_facets_match(config, got, _port_backward(backend, "device"))
    _assert_facets_match(config, got, _jax_backward(TWINS[backend][0],
                                                    "device"))


def test_fft_and_ct_folds_feed_by_group(monkeypatch):
    """``add_subgrid_group`` folds through the selected body as the
    per-column feed does."""
    config, fcs, sgcs, _ = _port_setup("torch")
    subgrids = _port_host_forward("torch", 128)[0]
    offs0 = sorted({sg.off0 for sg in sgcs})
    cols = [[i for i, sg in enumerate(sgcs) if sg.off0 == o] for o in offs0]
    for fold in ("fft", "ct"):
        monkeypatch.setenv("SWIFTLY_FOLD", fold)
        bwd = T.StreamedBackward(config, fcs, residency="sampled",
                                 fold_group=2)
        for g0 in range(0, len(cols), 3):  # groups of 3 columns, then 2
            grp = cols[g0:g0 + 3]
            bwd.add_subgrid_group([[sgcs[i] for i in c] for c in grp],
                                  torch.as_tensor(np.stack(
                                      [subgrids[c] for c in grp])))
        _assert_facets_match(config, bwd.finish(),
                             _port_backward("torch", "device"))


def test_row_slab_requires_the_sampled_fold(monkeypatch):
    config, fcs, _, _ = _port_setup("planar")
    for fold in ("ct", "fft"):
        monkeypatch.setenv("SWIFTLY_FOLD", fold)
        with pytest.raises(ValueError, match="sampled fold") as err:
            T.StreamedBackward(config, fcs, residency="sampled",
                               row_slab=(0, 10))
        jconfig, jfcs, _, _ = _jax_setup("planar")
        with pytest.raises(ValueError) as jerr:
            jstreamed.StreamedBackward(jconfig, jfcs, residency="sampled",
                                       row_slab=(0, 10))
        assert str(err.value) == str(jerr.value)
    for fold in ("sampled", "auto"):
        monkeypatch.setenv("SWIFTLY_FOLD", fold)
        bwd = T.StreamedBackward(config, fcs, residency="sampled",
                                 row_slab=(0, 10))
        assert bwd._fold_mode == "sampled"


# -- the FFT column bodies ----------------------------------------------------


def _first_column(backend):
    """The first column's offsets [S, 2] and masks [S, xA], and the
    facets' offsets, as port tensors."""
    from swiftly_tpu_torch.api import _subgrid_masks

    config, fcs, sgcs, _ = _port_setup(backend)
    groups = tstreamed._group_full_columns(sgcs)
    items = groups[next(iter(groups))]
    sg_offs = torch.as_tensor([(sg.off0, sg.off1) for _, sg in items])
    masks = [_subgrid_masks(sg) for _, sg in items]
    m0, m1 = (torch.as_tensor(np.asarray([mk[a] for mk in masks]))
              for a in (0, 1))
    foffs0 = torch.as_tensor([fc.off0 for fc in fcs])
    foffs1 = torch.as_tensor([fc.off1 for fc in fcs])
    return config, sg_offs, m0, m1, foffs0, foffs1


def _random(backend, shape, seed):
    rng = np.random.default_rng(seed)
    if backend == "planar":
        return rng.standard_normal(shape + (2,))
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("backend", sorted(TWINS))
def test_fft_forward_column_body(backend):
    """The per-facet FFT chain equals the default body (B1 on the planar
    backend, the einsums on the complex one) and JAX's FFT body, finished
    per column and as a slab step (``finish=False``) plus the group
    finish."""
    config, sg_offs, m0, m1, foffs0, foffs1 = _first_column(backend)
    core = config.core
    F, m, yB, size = 9, core.xM_yN_size, 416, TEST_PARAMS["xA_size"]
    NMBF_np = _random(backend, (F, m, yB), 7)
    NMBF = torch.as_tensor(NMBF_np)
    default = tflops.resolve_colpass(core, F)
    assert default == ("kernel" if backend == "planar" else "einsum")
    ops = tstreamed._colpass_operators(core, foffs0, foffs1)

    def column(mode):
        return tstreamed._column_pass_fwd(
            core, size, mode, None if mode == "fft" else ops, NMBF, foffs0,
            foffs1, sg_offs, m0, m1).numpy()

    fft_body = column("fft")
    assert _max_rel(column(default), fft_body) <= BODY_REL
    if backend == "planar":  # the operator einsums on planar planes too
        assert _max_rel(column("einsum"), fft_body) <= BODY_REL

    # JAX's FFT body on the same rows
    import jax
    import jax.numpy as jnp

    jcore = _jax_setup(TWINS[backend][0])[0].core
    jfft = jax.jit(jstreamed._column_pass_fwd_fft_fn(jcore, size))(
        jnp.asarray(NMBF_np), jnp.asarray(foffs0.numpy()),
        jnp.asarray(foffs1.numpy()), jnp.asarray(sg_offs.numpy()),
        jnp.asarray(m0.numpy()), jnp.asarray(m1.numpy()))
    assert _max_rel(fft_body, np.asarray(jfft)) <= REL

    # a one-column group: the slab step's partials plus the group finish
    S, xM = sg_offs.shape[0], core.xM_size
    tail = (2,) if backend == "planar" else ()
    for mode in ("fft", default):
        acc = torch.zeros((1, S, xM, xM) + tail, dtype=NMBF.dtype)
        tstreamed._column_slab_step(core, mode, None if mode == "fft" else ops,
                                    NMBF, foffs0, foffs1, sg_offs[None], acc)
        out = tstreamed._column_group_finish(core, mode, size, acc,
                                             sg_offs[None], m0[None],
                                             m1[None])
        assert _max_rel(out[0].numpy(), fft_body) <= BODY_REL


@pytest.mark.parametrize("backend", sorted(TWINS))
def test_fft_backward_column_body(backend):
    """The adjoint per-facet FFT chain equals the default adjoint body and
    JAX's FFT body on the same subgrids (the rows with Fb divided out)."""
    config, sg_offs, _, _, foffs0, foffs1 = _first_column(backend)
    core = config.core
    F, m, yB, xA = 9, core.xM_yN_size, 416, TEST_PARAMS["xA_size"]
    sgs_np = _random(backend, (sg_offs.shape[0], xA, xA), 11)
    sgs = torch.as_tensor(sgs_np)
    masks1 = torch.as_tensor(np.asarray(T.api._FacetStack(
        _port_setup(backend)[1]).masks1), dtype=core.real_dtype)
    default = tflops.resolve_colpass_bwd(core, F)
    ops = tstreamed._bwd_colpass_operators(core, foffs0, foffs1)
    fb = _fb(config)
    fb = fb[:, None] if backend == "planar" else fb

    def rows(mode):
        out = torch.empty((F, m, yB) + ((2,) if backend == "planar" else ()),
                          dtype=sgs.dtype)
        tstreamed._column_pass_bwd(core, yB, mode,
                                   None if mode == "fft" else ops, sgs,
                                   sg_offs, foffs0, foffs1, masks1, out)
        return out.numpy() / fb

    fft_body = rows("fft")
    assert _max_rel(rows(default), fft_body) <= BODY_REL
    if backend == "planar":
        assert _max_rel(rows("einsum"), fft_body) <= BODY_REL

    import jax
    import jax.numpy as jnp

    jcore = _jax_setup(TWINS[backend][0])[0].core
    jfft = jax.jit(jstreamed._column_pass_bwd_fft_fn(jcore, yB))(
        jnp.asarray(sgs_np), jnp.asarray(sg_offs.numpy()),
        jnp.asarray(foffs0.numpy()), jnp.asarray(foffs1.numpy()),
        jnp.asarray(masks1.numpy()))
    assert _max_rel(fft_body, np.asarray(jfft) / fb) <= REL


def test_executors_take_the_selected_bodies(monkeypatch):
    """``SWIFTLY_COLPASS=fft`` runs the host forward's column passes
    through the FFT chain and ``SWIFTLY_COLPASS_BWD=fft`` the device
    backward's, with the default bodies' results."""
    config, fcs, sgcs, tasks = _port_setup("planar")
    monkeypatch.setenv("SWIFTLY_COLPASS", "fft")
    fwd = T.StreamedForward(config, tasks, col_block=128)
    out = fwd.all_subgrids(sgcs)
    assert fwd.last_plan["colpass"] == "fft"
    assert _max_rel(out, _port_host_forward("planar", 128)[0]) <= REL
    monkeypatch.setenv("SWIFTLY_COLPASS_BWD", "fft")
    bwd = T.StreamedBackward(config, fcs, col_block=128, residency="device")
    bwd.add_subgrids(_subgrid_tasks("planar"))
    _assert_facets_match(config, config.core.as_complex(bwd.finish()),
                         _port_backward("planar", "device"))


# -- the resolvers ------------------------------------------------------------


def _raised(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_resolvers_read_the_reference_knobs(monkeypatch):
    """The knobs take the JAX package's values and raise its errors;
    "pallas" is B1 on the planar backend and the einsum body on the
    complex one; unset or "auto", the body goes by backend."""
    planar = _port_config("planar").core
    cplx = _port_config("torch").core
    cases = [
        ("SWIFTLY_COLPASS", None, "kernel", "einsum"),
        ("SWIFTLY_COLPASS", "auto", "kernel", "einsum"),
        ("SWIFTLY_COLPASS", "pallas", "kernel", "einsum"),
        ("SWIFTLY_COLPASS", "einsum", "einsum", "einsum"),
        ("SWIFTLY_COLPASS", "fft", "fft", "fft"),
        ("SWIFTLY_COLPASS_BWD", None, "kernel", "einsum"),
        ("SWIFTLY_COLPASS_BWD", "pallas", "kernel", "einsum"),
        ("SWIFTLY_COLPASS_BWD", "einsum", "einsum", "einsum"),
        ("SWIFTLY_COLPASS_BWD", "fft", "fft", "fft"),
    ]
    resolve = {"SWIFTLY_COLPASS": tflops.resolve_colpass,
               "SWIFTLY_COLPASS_BWD": tflops.resolve_colpass_bwd}
    for knob, value, want_planar, want_cplx in cases:
        if value is None:
            monkeypatch.delenv(knob, raising=False)
        else:
            monkeypatch.setenv(knob, value)
        assert resolve[knob](planar, 9) == want_planar
        assert resolve[knob](cplx, 9) == want_cplx
        monkeypatch.delenv(knob, raising=False)
    for fold, want in (("auto", "sampled"), ("sampled", "sampled"),
                       ("fft", "fft"), ("ct", "ct")):
        monkeypatch.setenv("SWIFTLY_FOLD", fold)
        assert tflops.resolve_fold_mode() == want
        assert tstreamed.resolve_fold_mode() == want
    monkeypatch.delenv("SWIFTLY_FOLD")
    assert tflops.resolve_fold_mode() == "sampled"
    assert tflops.resolve_fold_kernel(planar) == "kernel"
    assert tflops.resolve_fold_kernel(cplx) == "einsum"
    jcore = _jax_setup("planar")[0].core
    bad = [
        ("SWIFTLY_COLPASS", "pallas2",
         lambda: tflops.resolve_colpass(planar, 9),
         lambda: jflops.resolve_colpass(jcore, 9)),
        ("SWIFTLY_COLPASS_BWD", "auto",
         lambda: tflops.resolve_colpass_bwd(planar, 9),
         lambda: jflops.resolve_colpass_bwd(jcore, 9)),
        ("SWIFTLY_FOLD", "dense", tflops.resolve_fold_mode,
         jstreamed.resolve_fold_mode),
    ]
    for knob, value, port, ref in bad:
        monkeypatch.setenv(knob, value)
        assert _raised(port) == _raised(ref)
        monkeypatch.delenv(knob)
    config, fcs, _, _ = _port_setup("planar")
    monkeypatch.setenv("SWIFTLY_FOLD", "dense")
    with pytest.raises(ValueError, match="SWIFTLY_FOLD"):
        T.StreamedBackward(config, fcs, residency="sampled")
