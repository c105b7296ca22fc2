"""Port host layer vs the JAX package: catalogue, covers, configs, PSWF.

The port (`swiftly_tpu_torch`) carries its own copies of the JAX package's
host-side modules; these tests hold each copy to the original on the same
inputs, exactly (the data is integer or float64 host arithmetic, so any
difference is a porting fault).
"""

import numpy as np
import pytest
import torch

import swiftly_tpu.models as jm
import swiftly_tpu.ops as jops
import swiftly_tpu_torch.models as tm
import swiftly_tpu_torch.ops as tops
from swiftly_tpu.ops.core import SwiftlyCore as JaxCore
from swiftly_tpu_torch.ops.core import SwiftlyCore as TorchCore

CONFIGS = ["1k[1]-n512-256", "4k[1]-n2k-512", "1k[1]-n1k-256", "16k[.75]-n4k-1k"]


def test_catalogue_equal_row_for_row():
    assert len(tm.SWIFT_CONFIGS) == 244
    assert list(tm.SWIFT_CONFIGS) == list(jm.SWIFT_CONFIGS)
    for name, row in jm.SWIFT_CONFIGS.items():
        assert tm.SWIFT_CONFIGS[name] == row, name


def _configs(name):
    params = jm.SWIFT_CONFIGS[name]
    return (
        jm.SwiftlyConfig(backend="numpy", **params),
        tm.SwiftlyConfig(backend="numpy", **params),
    )


def _same_chunks(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.off0, x.off1, x.size) == (y.off0, y.off1, y.size)
        for mx, my in ((x.mask0, y.mask0), (x.mask1, y.mask1)):
            if mx is None:
                assert my is None
            else:
                np.testing.assert_array_equal(mx, my)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_properties_and_full_covers_equal(name):
    jc, tc = _configs(name)
    for prop in ("image_size", "max_facet_size", "max_subgrid_size",
                 "pswf_parameter", "fov", "internal_facet_size",
                 "internal_subgrid_size", "contribution_size",
                 "facet_off_step", "subgrid_off_step"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    _same_chunks(jm.make_full_facet_cover(jc), tm.make_full_facet_cover(tc))
    _same_chunks(jm.make_full_subgrid_cover(jc), tm.make_full_subgrid_cover(tc))


@pytest.mark.parametrize("name,fov_frac", [("4k[1]-n2k-512", 0.5),
                                           ("16k[.75]-n4k-1k", 0.6)])
def test_sparse_covers_equal(name, fov_frac):
    jc, tc = _configs(name)
    fov = int(jc.image_size * fov_frac)
    j_offs, j_masks = jm.sparse_fov_cover_offsets(jc, fov)
    t_offs, t_masks = tm.sparse_fov_cover_offsets(tc, fov)
    assert t_offs == j_offs
    _same_chunks(
        jm.make_sparse_facet_cover(jc.max_facet_size, j_offs, j_masks),
        tm.make_sparse_facet_cover(tc.max_facet_size, t_offs, t_masks),
    )


@pytest.mark.parametrize("name", CONFIGS)
def test_pswf_constants_bit_equal(name):
    p = jm.SWIFT_CONFIGS[name]
    j_pswf = jops.pswf_samples(p["W"], p["yN_size"])
    t_pswf = tops.pswf_samples(p["W"], p["yN_size"])
    assert np.array_equal(t_pswf, j_pswf)
    assert np.array_equal(tops.pswf_fb(t_pswf), jops.pswf_fb(j_pswf))
    assert np.array_equal(
        tops.pswf_fn(t_pswf, p["N"], p["xM_size"], p["yN_size"]),
        jops.pswf_fn(j_pswf, p["N"], p["xM_size"], p["yN_size"]),
    )


@pytest.mark.parametrize("backend,dtype", [("torch", torch.complex128),
                                           ("planar", torch.float64)])
def test_core_windows_bit_equal_and_from_numpy_state(backend, dtype):
    p = jm.SWIFT_CONFIGS["1k[1]-n512-256"]
    args = (p["W"], p["N"], p["xM_size"], p["yN_size"])
    jcore = JaxCore(*args, backend="numpy")
    tcore = TorchCore(*args, backend=backend, dtype=dtype, device="cpu")
    assert np.array_equal(tcore._Fb.numpy(), jcore._Fb)
    assert np.array_equal(tcore._Fn.numpy(), jcore._Fn)
    state = TorchCore.from_numpy_state(
        *args, np.asarray(jcore._Fb), np.asarray(jcore._Fn),
        backend=backend, dtype=dtype, device="cpu",
    )
    assert np.array_equal(state._Fb.numpy(), jcore._Fb)
    assert np.array_equal(state._Fn.numpy(), jcore._Fn)
    assert (state.xM_yN_size, state.facet_off_step, state.subgrid_off_step) == (
        jcore.xM_yN_size, jcore.facet_off_step, jcore.subgrid_off_step)
    with pytest.raises(ValueError, match="window constants"):
        TorchCore.from_numpy_state(*args, jcore._Fb[:-1], jcore._Fn,
                                   backend=backend, device="cpu")


def test_oracle_and_io_slices_equal():
    rng = np.random.default_rng(5)
    sources = [(float(rng.uniform(0.5, 2)), int(rng.integers(-500, 500)),
                int(rng.integers(-500, 500))) for _ in range(5)]
    masks = [jops.mask_from_slices([slice(10, 300)], 352), None]
    np.testing.assert_array_equal(
        tops.make_facet_from_sources(sources, 1024, 352, [352, -352], masks),
        jops.make_facet_from_sources(sources, 1024, 352, [352, -352], masks),
    )
    np.testing.assert_array_equal(
        tops.make_subgrid_from_sources(sources, 1024, 160, [160, 320]),
        jops.make_subgrid_from_sources(sources, 1024, 160, [160, 320]),
    )
    np.testing.assert_array_equal(
        tops.generate_masks(1024, 400, [0, 352, 704]),
        jops.generate_masks(1024, 400, [0, 352, 704]),
    )
    data = rng.normal(size=(40, 30))
    for size, off, win in ((40, 7, 13), (40, -18, 40), (40, 19, 8)):
        assert tops.roll_and_extract_mid(size, off, win) == \
            jops.roll_and_extract_mid(size, off, win)
        np.testing.assert_array_equal(
            tops.roll_and_extract_mid_axis(data, off, win, 0),
            jops.roll_and_extract_mid_axis(data, off, win, 0),
        )


def test_mesh_is_not_ported_yet():
    """Meshes are ported (A8): a config takes a mesh and an spmd_mode on
    the device backends, and refuses a mesh on the host backends or an
    unknown spmd_mode with ValueError, as the JAX package's does."""
    from swiftly_tpu_torch.parallel.mesh import make_facet_mesh

    p = jm.SWIFT_CONFIGS["1k[1]-n512-256"]
    mesh = make_facet_mesh(devices=["cpu"] * 2)
    for backend in ("torch", "planar"):
        cfg = tm.SwiftlyConfig(backend=backend, device="cpu", mesh=mesh, **p)
        assert cfg.mesh is mesh and cfg.spmd_mode == "shard_map"
    cfg = tm.SwiftlyConfig(backend="torch", device="cpu", mesh=mesh,
                           spmd_mode="gspmd", **p)
    assert cfg.spmd_mode == "gspmd"
    assert tm.SwiftlyConfig(backend="torch", device="cpu", **p).mesh is None
    with pytest.raises(ValueError, match="spmd_mode"):
        tm.SwiftlyConfig(backend="torch", device="cpu", mesh=mesh,
                         spmd_mode="pmap", **p)
    # the native host backend (A14) is ported: a host core, no device
    cfg = tm.SwiftlyConfig(backend="native", device="cpu", **p)
    assert cfg.core.backend == "native" and cfg.core.device is None
    for backend in ("numpy", "native"):
        with pytest.raises(ValueError, match="runs on the host"):
            tm.SwiftlyConfig(backend=backend, mesh=mesh, **p)
        with pytest.raises(ValueError, match="runs on the host"):
            jm.SwiftlyConfig(backend=backend, mesh=object(), **p)
