"""The port's native C++ host backend (``swiftly_tpu_torch.native`` and
``SwiftlyCore(backend="native")``) against the JAX package's
``tests/test_native.py`` and the JAX package's own ``NativeKernels``.

The 7 cases of ``tests/test_native.py`` run against the port: the full
chain against the numpy core (power-of-two and Bluestein sizes), the
fused 2D path, accumulate (``out=``) semantics, negative offsets,
pickling by parameters and the parameter checks. Then the two packages
against each other: the port builds the same source with the same g++
flags, so its primitives are held BIT-EQUAL to the JAX package's on the
same inputs; the port's ``backend="native"`` chain within 3e-10 RMS of
its ``backend="torch"`` complex128 chain on the CPU and of the analytic
oracle; and where ``g++`` cannot build the library, ``backend="native"``
raises instead of falling back to the numpy core.
"""

import pickle

import numpy as np
import pytest

import swiftly_tpu_torch.native as port_native
from swiftly_tpu_torch.native import NativeKernels, native_available
from swiftly_tpu_torch.ops import SwiftlyCore, make_facet_from_sources

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native toolchain unavailable"
)

SOURCES = [(1.0, 40, -30), (0.5, -100, 7)]


def _cores(params):
    W, N, xM, yN = params
    return (
        SwiftlyCore(W, N, xM, yN, backend="numpy"),
        SwiftlyCore(W, N, xM, yN, backend="native"),
    )


@pytest.mark.parametrize(
    "params",
    [
        (13.5625, 1024, 256, 512),  # power-of-two sizes
        (10.75, 1536, 384, 768),    # 3*2^k sizes -> Bluestein FFT
    ],
)
def test_native_matches_numpy_full_chain(params):
    cn, cc = _cores(params)
    N = cn.N
    yB = 13 * cn.yN_size // 16
    xA = cn.xM_size - 28
    facet = make_facet_from_sources(SOURCES, N, yB, [0, 0])
    results = []
    for core in (cn, cc):
        p = core.prepare_facet(core.prepare_facet(facet, 0, 0), 0, 1)
        c = core.extract_from_facet(
            core.extract_from_facet(p, core.xM_size, 0), 0, 1
        )
        a = core.add_to_subgrid(core.add_to_subgrid(c, 0, 0), 0, 1)
        results.append(np.asarray(core.finish_subgrid(a, [core.xM_size, 0], xA)))
    np.testing.assert_allclose(results[0], results[1], atol=1e-11)


def test_native_fused_2d_matches_per_axis():
    _, cc = _cores((13.5625, 1024, 256, 512))
    rng = np.random.default_rng(0)
    m = cc.xM_yN_size
    contrib = rng.normal(size=(m, m)) + 1j * rng.normal(size=(m, m))
    per_axis = cc.add_to_subgrid(cc.add_to_subgrid(contrib, 256, 0), 512, 1)
    fused = cc._native.add_to_subgrid_2d(contrib, (256, 512))
    np.testing.assert_allclose(np.asarray(per_axis), fused, atol=1e-13)


def test_native_accumulates_into_out():
    _, cc = _cores((13.5625, 1024, 256, 512))
    rng = np.random.default_rng(1)
    m = cc.xM_yN_size
    c1 = rng.normal(size=m) + 1j * rng.normal(size=m)
    c2 = rng.normal(size=m) + 1j * rng.normal(size=m)
    acc = np.zeros(cc.xM_size, dtype=complex)
    cc.add_to_subgrid(c1, 0, 0, out=acc)
    cc.add_to_subgrid(c2, 256, 0, out=acc)
    expect = np.asarray(cc.add_to_subgrid(c1, 0, 0)) + np.asarray(
        cc.add_to_subgrid(c2, 256, 0)
    )
    np.testing.assert_allclose(acc, expect, atol=1e-13)


def test_native_negative_offsets_match_numpy():
    cn, cc = _cores((13.5625, 1024, 256, 512))
    rng = np.random.default_rng(2)
    m = cn.xM_yN_size
    contrib = rng.normal(size=m) + 1j * rng.normal(size=m)
    a_np = np.asarray(cn.add_to_subgrid(contrib, -256, 0))
    a_cc = np.asarray(cc.add_to_subgrid(contrib, -256, 0))
    np.testing.assert_allclose(a_np, a_cc, atol=1e-13)


def test_native_pickles_by_params():
    _, cc = _cores((13.5625, 1024, 256, 512))
    clone = pickle.loads(pickle.dumps(cc._native))
    rng = np.random.default_rng(3)
    facet = rng.normal(size=416) + 1j * rng.normal(size=416)
    np.testing.assert_array_equal(
        np.asarray(cc._native.prepare_facet(facet, 0, 0)),
        np.asarray(clone.prepare_facet(facet, 0, 0)),
    )


def test_native_rejects_bad_params():
    with pytest.raises(ValueError):
        NativeKernels(1000, 256, 512, np.ones(511), np.ones(128))


def test_native_rejects_bad_out_shape():
    _, cc = _cores((13.5625, 1024, 256, 512))
    with pytest.raises(ValueError):
        cc.add_to_subgrid(
            np.zeros(cc.xM_yN_size, dtype=complex),
            0,
            0,
            out=np.zeros(7, dtype=complex),
        )


# ---------------------------------------------------------------------------
# the port against the JAX package's native kernels and the torch core
# ---------------------------------------------------------------------------

PARAMS = (13.5625, 1024, 256, 512)


def _pair():
    from swiftly_tpu.native import NativeKernels as JaxNativeKernels

    port = SwiftlyCore(*PARAMS, backend="native")._native
    ref = JaxNativeKernels(port.N, port.xM_size, port.yN_size,
                           port._fb, port._fn)
    return port, ref


def _crand(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def test_source_matches_the_jax_package_apart_from_comments():
    from pathlib import Path

    import swiftly_tpu

    def code(path):
        lines = Path(path).read_text().splitlines()
        return [ln for ln in lines if not ln.lstrip().startswith("//")]

    ref = Path(swiftly_tpu.__file__).parent / "native" / "swiftly_native.cpp"
    assert code(port_native._SRC) == code(ref)
    assert port_native.GXX_FLAGS == (
        "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp")
    # built under the port's _build/, never beside the source
    lib = port_native._library_path()
    assert lib.parent.name == "_build"
    assert lib.parent.parent.name == "swiftly_tpu_torch"


@pytest.mark.parametrize("prim", [
    "prepare_facet", "extract_from_facet", "add_to_subgrid",
    "add_to_subgrid_2d", "finish_subgrid", "prepare_subgrid",
    "extract_from_subgrid", "add_to_facet", "finish_facet",
])
def test_primitives_bit_equal_to_the_jax_package(prim):
    port, ref = _pair()
    rng = np.random.default_rng(hash(prim) % 2**32)
    m, xM, yN = port.xM_yN_size, port.xM_size, port.yN_size
    if prim == "prepare_facet":
        args = (_crand(rng, (416, 416)), 512, 1)
    elif prim == "extract_from_facet":
        args = (_crand(rng, (yN, 416)), 256, 0)
    elif prim == "add_to_subgrid":
        args = (_crand(rng, (m, m)), -256, 1)
    elif prim == "add_to_subgrid_2d":
        args = (_crand(rng, (m, m)), (256, 512))
    elif prim == "finish_subgrid":
        args = (_crand(rng, (xM, xM)), [256, -512], 228)
    elif prim == "prepare_subgrid":
        args = (_crand(rng, (228, 228)), [256, 512])
    elif prim == "extract_from_subgrid":
        args = (_crand(rng, (xM, xM)), 512, 0)
    elif prim == "add_to_facet":
        args = (_crand(rng, (m, xM)), 256, 0)
    else:
        args = (_crand(rng, (yN, m)), 0, 416, 0)
    got = getattr(port, prim)(*args)
    want = getattr(ref, prim)(*args)
    assert got.dtype == want.dtype == np.complex128
    np.testing.assert_array_equal(got, want)


def _chain(core, facet, offs):
    """Facet -> one subgrid, then that subgrid -> the facet's contribution
    (both directions of the eight primitives)."""
    fo, so, xA = offs
    p = core.prepare_facet(core.prepare_facet(facet, fo[0], 0), fo[1], 1)
    c = core.extract_from_facet(core.extract_from_facet(p, so[0], 0), so[1], 1)
    a = core.add_to_subgrid(core.add_to_subgrid(c, fo[0], 0), fo[1], 1)
    sg = core.as_complex(core.finish_subgrid(a, list(so), xA))
    ps = core.prepare_subgrid(sg, list(so))
    e = core.extract_from_subgrid(
        core.extract_from_subgrid(ps, fo[0], 0), fo[1], 1)
    f = core.add_to_facet(core.add_to_facet(e, so[0], 0), so[1], 1)
    facet_back = core.as_complex(core.finish_facet(
        core.finish_facet(f, fo[0], facet.shape[0], 0),
        fo[1], facet.shape[1], 1))
    return sg, facet_back


def _rms(a, b):
    return np.sqrt(np.mean(np.abs(np.asarray(a) - np.asarray(b)) ** 2))


def test_native_chain_matches_torch_complex128():
    W, N, xM, yN = PARAMS
    yB, xA = 416, 228
    fo, so = (512, -512), (256, 512)
    sources = [(1.0, 40, -30), (0.5, -100, 7)]
    facet = make_facet_from_sources(sources, N, yB, list(fo))
    native = _chain(SwiftlyCore(*PARAMS, backend="native"), facet,
                    (fo, so, xA))
    ref = _chain(SwiftlyCore(*PARAMS, backend="torch", dtype="complex128",
                             device="cpu"), facet, (fo, so, xA))
    assert native[0].dtype == native[1].dtype == np.complex128
    assert _rms(native[0], ref[0]) < 3e-10
    assert _rms(native[1], ref[1]) < 3e-10


def test_native_round_trip_matches_torch_complex128_and_the_oracle():
    import swiftly_tpu_torch as st

    params = st.SWIFT_CONFIGS["1k[1]-n512-256"]
    sources = [(1.0, 40, -30), (0.5, -100, 7)]
    out = {}
    for backend, kw in (("native", {}),
                        ("torch", {"dtype": "complex128", "device": "cpu"})):
        cfg = st.SwiftlyConfig(backend=backend, **kw, **params)
        fcs = st.make_full_facet_cover(cfg)
        sgcs = st.make_full_subgrid_cover(cfg)
        tasks = [(fc, st.make_facet(cfg.image_size, fc, sources))
                 for fc in fcs]
        subgrids = [cfg.core.as_complex(s) for s in
                    st.SwiftlyForward(cfg, tasks).get_subgrid_tasks(sgcs)]
        facets = cfg.core.as_complex(
            st.backward_all(cfg, fcs, list(zip(sgcs, subgrids))))
        out[backend] = (subgrids, facets, cfg, fcs, sgcs)
    subgrids, facets, cfg, fcs, sgcs = out["native"]
    assert isinstance(facets, np.ndarray) and facets.dtype == np.complex128
    for sg, ref, sgc in zip(subgrids, out["torch"][0], sgcs):
        assert _rms(sg, ref) < 3e-10
        assert _rms(sg, st.make_subgrid(cfg.image_size, sgc, sources)) < 3e-10
    for f, ref, fc in zip(facets, out["torch"][1], fcs):
        assert _rms(f, ref) < 3e-10
        assert _rms(f, st.make_facet(cfg.image_size, fc, sources)) < 3e-10


def test_native_numpy_in_numpy_out_and_accumulates():
    core = SwiftlyCore(*PARAMS, backend="native")
    rng = np.random.default_rng(7)
    m = core.xM_yN_size
    c = _crand(rng, (m, m))
    out = np.zeros((m, core.yN_size), dtype=complex)
    first = core.add_to_facet(c, 256, 1, out=out)
    assert first is out
    core.add_to_facet(c, 256, 1, out=out)
    np.testing.assert_allclose(out, 2 * core.add_to_facet(c, 256, 1),
                               atol=1e-13)
    assert core.device is None and core.dtype == np.complex128


def test_native_without_gxx_raises_and_never_falls_back(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(port_native, "_LIB", None)
    monkeypatch.setattr(port_native, "_LIB_ERR", None)
    monkeypatch.setattr(port_native, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(port_native.shutil, "which", lambda name: None)
    assert not native_available()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        SwiftlyCore(*PARAMS, backend="native")
    assert not list(tmp_path.iterdir())
