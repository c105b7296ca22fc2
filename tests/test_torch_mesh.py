"""The port's facet mesh and sharded programs, against the JAX package's
single-device results: the counterparts of ``tests/test_sharded.py``.

A mesh here is 8 virtual shards on the CPU (``make_facet_mesh(devices=
["cpu"] * 8)``), as the JAX package's tests simulate theirs over 8
virtual CPU devices; 9 facets pad to 16. No JAX mesh program runs: the
port's mesh is held to the JAX package's single-device round trips on
the same numpy inputs (the port's configurations take the JAX core's
window constants), to the port's own single-device path, and to the
oracle. Bounds, float64, for the reference's single unit source: its
oracle bound, RMS < 3e-10; the port's mesh within 1e-13 of the port's
single-device path (``tests/test_sharded.py``'s mesh-vs-single bound)
and within 1e-12 of the JAX package's (the bound
``tests/test_torch_api.py`` holds the two packages' fused paths to).
With sources in several facets, so that every shard's partial sum is
nonzero and the order of the facet sum shows, the backward's window Fb
(up to 4.9e3 at the facet edges) amplifies that order's rounding, and
the facets agree to 1e-12 relative once Fb is divided out
(``tests/test_torch_streamed.py``'s bound).

The HLO-reading cases of ``tests/test_sharded.py`` become counts: each
collective is one ``mesh.psum`` / ``mesh.ring_step`` stage, one a
column, with the bytes of ``utils.profiling.collective_bytes_forward``.
"""

import functools

import numpy as np
import pytest
import torch

import swiftly_tpu as J
import swiftly_tpu_torch as T
from swiftly_tpu_torch.obs import metrics
from swiftly_tpu_torch.parallel import mesh as tmesh
from swiftly_tpu_torch.parallel import sharded
from swiftly_tpu_torch.parallel.mesh import (
    FacetMesh,
    ShardedStack,
    facet_sharding,
    make_facet_mesh,
    pad_to_shards,
    place_facet_sharded,
    replicated_sharding,
)

TEST_PARAMS = {
    "W": 13.5625,
    "fov": 1.0,
    "N": 1024,
    "yB_size": 416,
    "yN_size": 512,
    "xA_size": 228,
    "xM_size": 256,
}
SOURCES = [(1, 1, 0)]
# for the mesh-vs-single comparisons: sources in several facets, so the
# shards' partial sums are all nonzero and the reduction order matters
RICH_SOURCES = [(1.0, 1, 0), (0.5, -300, 200), (0.75, 250, -180),
                (0.25, -120, -350), (0.6, 380, 360)]
TWINS = {"planar": ("planar", torch.float64), "torch": ("jax", torch.complex128)}
RMS_BOUND = 3e-10
MESH_ATOL = 1e-13  # mesh against single device, tests/test_sharded.py
PKG_ATOL = 1e-12  # port against the JAX package, tests/test_torch_api.py
REL = 1e-12  # window-free facets, tests/test_torch_streamed.py
N_SHARDS = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def metrics_on():
    metrics.reset()
    metrics.enable()
    yield metrics
    metrics.disable()
    metrics.reset()


def cpu_mesh(n=N_SHARDS):
    return make_facet_mesh(devices=["cpu"] * n)


@functools.cache
def _jax_config(jax_backend):
    return J.SwiftlyConfig(backend=jax_backend, **TEST_PARAMS)


def _config(backend, mesh=None, spmd_mode="shard_map"):
    jcore = _jax_config(TWINS[backend][0]).core
    return T.SwiftlyConfig.from_numpy_state(
        np.asarray(jcore._Fb), np.asarray(jcore._Fn), backend=backend,
        dtype=TWINS[backend][1], device="cpu", mesh=mesh,
        spmd_mode=spmd_mode, **TEST_PARAMS)


@functools.cache
def _facets(sources):
    config = _jax_config("jax")
    return [J.make_facet(config.image_size, fc, list(sources))
            for fc in J.make_full_facet_cover(config)]


def _roundtrip(config, sources=SOURCES):
    """The port's per-subgrid API round trip: (subgrid RMS, facet RMS,
    forward, facets)."""
    sgcs = T.make_full_subgrid_cover(config)
    fcs = T.make_full_facet_cover(config)
    tasks = list(zip(fcs, _facets(tuple(sources))))
    fwd = T.SwiftlyForward(config, tasks, 2, 50)
    bwd = T.SwiftlyBackward(config, fcs, 2, 50)
    sg_err = []
    for sg in sgcs:
        subgrid = fwd.get_subgrid_task(sg)
        sg_err.append(T.check_subgrid(config.image_size, sg,
                                      config.core.as_complex(subgrid),
                                      sources))
        bwd.add_new_subgrid_task(sg, subgrid)
    facets = bwd.finish()
    f_err = [T.check_facet(config.image_size, fc,
                           config.core.as_complex(facets[i]), sources)
             for i, fc in enumerate(fcs)]
    return sg_err, f_err, fwd, config.core.as_complex(facets)


@functools.cache
def _jax_fused(jax_backend, sources):
    """The JAX package's single-device fused round trip: (subgrids,
    facets), complex."""
    config = _jax_config(jax_backend)
    sgcs = J.make_full_subgrid_cover(config)
    fcs = J.make_full_facet_cover(config)
    tasks = list(zip(fcs, _facets(sources)))
    fwd = J.SwiftlyForward(config, tasks, 2, 50)
    subgrids = fwd.all_subgrids(sgcs)
    facets = J.backward_all(config, fcs, [(sg, subgrids[i])
                                          for i, sg in enumerate(sgcs)])
    core = config.core
    return (np.asarray(core.as_complex(np.asarray(subgrids))),
            np.asarray(core.as_complex(np.asarray(facets))))


def _assert_facets_match(config, got, ref):
    """Facets agree to REL relative with the window Fb divided out."""
    fb = config.core._p.extract_mid(config.core._Fb,
                                    TEST_PARAMS["yB_size"], 0).numpy()
    w = fb[:, None] * fb[None, :]
    assert got.shape == ref.shape
    assert (np.abs(got - ref) / w).max() / (np.abs(ref) / w).max() < REL


def _fused(config, sources):
    sgcs = T.make_full_subgrid_cover(config)
    fcs = T.make_full_facet_cover(config)
    tasks = list(zip(fcs, _facets(sources)))
    fwd = T.SwiftlyForward(config, tasks, 2, 50)
    subgrids = fwd.all_subgrids(sgcs)
    facets = T.backward_all(config, fcs, [(sg, subgrids[i])
                                          for i, sg in enumerate(sgcs)])
    core = config.core
    return sgcs, fcs, core.as_complex(subgrids), core.as_complex(facets)


# -- the mesh itself ----------------------------------------------------------


def test_virtual_shards_and_visible_devices(monkeypatch):
    """Virtual shards come only from an explicit device list; with none,
    the visible CUDA devices, and a request for more than there are
    raises, as the JAX package's `make_facet_mesh` does."""
    mesh = cpu_mesh()
    assert len(mesh) == N_SHARDS
    assert mesh.devices == (torch.device("cpu"),) * N_SHARDS
    assert mesh.distinct_devices == [torch.device("cpu")]
    assert tmesh.mesh_size(mesh) == N_SHARDS and tmesh.mesh_size(None) == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no CUDA device"):
        make_facet_mesh()
    with pytest.raises(ValueError, match="only 0 devices"):
        make_facet_mesh(n_devices=2)
    with pytest.raises(ValueError):
        FacetMesh([])


def test_pad_to_shards():
    from swiftly_tpu.parallel.mesh import pad_to_shards as jpad

    assert pad_to_shards(9, 8) == 16
    assert pad_to_shards(8, 8) == 8
    assert pad_to_shards(1, 8) == 8
    for n in range(1, 20):
        for k in (1, 2, 3, 4, 7, 8):
            assert pad_to_shards(n, k) == jpad(n, k)


def test_resolve_collective_reads_the_knob_like_the_jax_package(
        monkeypatch):
    from swiftly_tpu.parallel.mesh import resolve_collective as jresolve

    for mode in (None, "auto", "psum", "ring"):
        if mode is None:
            monkeypatch.delenv("SWIFTLY_MESH_COLLECTIVE", raising=False)
        else:
            monkeypatch.setenv("SWIFTLY_MESH_COLLECTIVE", mode)
        for n in (None, 1, 2, 8):
            assert tmesh.resolve_collective(n) == jresolve(n)
    assert tmesh.resolve_collective(1) == "psum"  # no ring of one
    monkeypatch.setenv("SWIFTLY_MESH_COLLECTIVE", "tree")
    with pytest.raises(ValueError, match="psum|ring|auto"):
        tmesh.resolve_collective(4)
    assert tmesh.COLLECTIVES == ("psum", "ring")
    assert tmesh.FACET_AXIS == "facet"


def test_facet_sharding_spec():
    mesh = cpu_mesh()
    sh = facet_sharding(mesh)
    assert sh.spec == ("facet",) and sh.axis == 0
    assert replicated_sharding(mesh).spec == ()
    x = place_facet_sharded(np.zeros((16, 4, 4)), mesh)
    assert isinstance(x, ShardedStack) and x.shape == (16, 4, 4)
    assert len(x.shards) == N_SHARDS and x.n_pad == 0
    # each shard holds 2 facets
    assert x.shards[0].shape == (2, 4, 4)
    # 9 facets pad to 16 and the padding is dropped on the way back
    y = np.arange(9 * 3, dtype=np.float64).reshape(9, 3)
    z = place_facet_sharded(y, mesh)
    assert z.shape == (16, 3) and z.n_pad == 7 and z.n_real == 9
    np.testing.assert_array_equal(z.numpy(), y)
    assert z.gather(real=False).shape == (16, 3)
    assert not z.shards[-1].any()
    # along another axis
    w = place_facet_sharded(np.ones((3, 8)), cpu_mesh(4), facet_axis=1)
    assert [t.shape for t in w.shards] == [(3, 2)] * 4


def test_shard_core_moves_only_the_window_constants():
    core = _config("planar").core
    assert tmesh.shard_core(core, "cpu") is core
    # another device copies the core once and keeps the copy
    other = torch.device("meta")
    sc = tmesh.shard_core(core, other)
    assert sc is tmesh.shard_core(core, other) and sc is not core
    assert sc.device == other and sc._Fb.device == other
    assert sc.N == core.N and sc.backend == core.backend
    assert core.device == torch.device("cpu")


# -- the collectives ------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_ring_matches_psum_and_is_repeatable(n):
    """The ring's sum agrees with the psum's within reduction-order
    rounding, is bit-identical run to run and on every shard; the psum is
    the shard-order sum, one tensor a distinct device."""
    g = np.random.default_rng(n)
    mesh = cpu_mesh(n)
    # a size that does not split into n chunks evenly (the zero pad)
    parts = [torch.as_tensor(g.normal(size=(5, 7, 3))) for _ in range(n)]
    ps = sharded.psum(parts, mesh)
    want = parts[0] + parts[1]
    for p in parts[2:]:
        want = want + p
    assert torch.equal(ps[0], want)
    assert all(t is ps[0] for t in ps)  # one copy on the one device
    ring, moved = sharded.ring_allreduce(parts, mesh)
    ring2, _ = sharded.ring_allreduce(parts, mesh)
    per = -(-parts[0].numel() // n)
    assert moved == 2 * (n - 1) * n * per * 8
    for a, b in zip(ring, ring2):
        assert torch.equal(a, b)
    for t in ring[1:]:
        assert torch.equal(t, ring[0]) and t is not ring[0]
    torch.testing.assert_close(ring[0], want, rtol=0, atol=1e-13)
    # each chunk is summed in ring order from its owner
    flat = [p.reshape(-1) for p in parts]
    c = 1
    lo, hi = c * per, min((c + 1) * per, flat[0].numel())
    chain = flat[c][lo:hi].clone()
    for k in range(1, n):
        chain = chain + flat[(c + k) % n][lo:hi]
    assert torch.equal(ring[0].reshape(-1)[lo:hi], chain)


def test_collective_sum_is_one_stage_with_its_bytes(metrics_on,
                                                    monkeypatch):
    mesh = cpu_mesh(4)
    parts = [torch.ones(6, 4, dtype=torch.float64) * k for k in range(4)]
    out = sharded.collective_sum(parts, mesh)
    assert torch.equal(out[0], torch.full((6, 4), 6.0, dtype=torch.float64))
    monkeypatch.setenv("SWIFTLY_MESH_COLLECTIVE", "ring")
    sharded.collective_sum(parts, mesh)
    stages = metrics.export()["stages"]
    assert stages["mesh.psum"]["count"] == 1
    assert stages["mesh.ring_step"]["count"] == 1
    wire = 2 * 3 * 6 * 4 * 8  # 2(n-1) buffers
    assert stages["mesh.psum"]["bytes"] == wire
    assert stages["mesh.ring_step"]["bytes"] == wire
    assert metrics.export()["counters"]["mesh.collectives"] == 2
    # one shard: no collective at all
    assert sharded.collective_sum(parts[:1], cpu_mesh(1)) == parts[:1]
    assert metrics.export()["counters"]["mesh.collectives"] == 2


# -- the API on a mesh ----------------------------------------------------------


# the JAX test's marks: gspmd and the complex backend ride -m slow
@pytest.mark.parametrize("backend, spmd_mode", [
    ("planar", "shard_map"),
    pytest.param("planar", "gspmd", marks=pytest.mark.slow),
    pytest.param("torch", "shard_map", marks=pytest.mark.slow),
    pytest.param("torch", "gspmd", marks=pytest.mark.slow)])
def test_sharded_roundtrip_accuracy(backend, spmd_mode):
    config = _config(backend, cpu_mesh(), spmd_mode)
    sg_err, f_err, fwd, _ = _roundtrip(config)
    assert max(sg_err) < RMS_BOUND
    assert max(f_err) < RMS_BOUND
    # the facet stack (9 facets) is padded to 16 and sharded over 8
    assert fwd.stack.n_total == 16 and fwd.stack.n_real == 9
    BF_Fs = fwd._get_BF_Fs()
    assert isinstance(BF_Fs, ShardedStack) and len(BF_Fs.shards) == 8
    assert all(t.shape[0] == 2 for t in BF_Fs.shards)


@pytest.mark.parametrize(
    "spmd_mode", ["shard_map", pytest.param("gspmd", marks=pytest.mark.slow)])
def test_sharded_matches_single_device(spmd_mode):
    """The mesh's per-subgrid round trip against the port's single-device
    one and the JAX package's single-device fused one (another order of
    the same sums: window-free, to REL)."""
    config = _config("torch", cpu_mesh(), spmd_mode)
    _, _, _, mesh_f = _roundtrip(config)
    _, _, _, single_f = _roundtrip(_config("torch"))
    np.testing.assert_allclose(mesh_f, single_f, rtol=0, atol=MESH_ATOL)
    _assert_facets_match(config, mesh_f, _jax_fused("jax", tuple(SOURCES))[1])


def test_mesh_subset_of_devices():
    config = _config("torch", cpu_mesh(4))
    sg_err, f_err, fwd, _ = _roundtrip(config)
    assert fwd.stack.n_total == 12  # 9 padded to a multiple of 4
    assert max(sg_err) < RMS_BOUND and max(f_err) < RMS_BOUND


@pytest.mark.parametrize(
    "spmd_mode", ["shard_map", pytest.param("gspmd", marks=pytest.mark.slow)])
def test_fused_mesh_matches_single_device(spmd_mode):
    """The whole-cover paths on the mesh against the JAX package's
    single-device ones, and the oracle."""
    config = _config("torch", cpu_mesh(), spmd_mode)
    sgcs, fcs, sgs, facets = _fused(config, tuple(SOURCES))
    j_sgs, j_facets = _jax_fused("jax", tuple(SOURCES))
    np.testing.assert_allclose(sgs, j_sgs, rtol=0, atol=PKG_ATOL)
    _assert_facets_match(config, facets, j_facets)
    _, _, s_sgs, s_facets = _fused(_config("torch"), tuple(SOURCES))
    np.testing.assert_allclose(sgs, s_sgs, rtol=0, atol=MESH_ATOL)
    np.testing.assert_allclose(facets, s_facets, rtol=0, atol=MESH_ATOL)
    assert max(T.check_subgrid(config.image_size, sg, sgs[i], SOURCES)
               for i, sg in enumerate(sgcs)) < RMS_BOUND
    assert max(T.check_facet(config.image_size, fc, facets[i], SOURCES)
               for i, fc in enumerate(fcs)) < RMS_BOUND
    sources = tuple(RICH_SOURCES)
    _, _, r_sgs, r_facets = _fused(config, sources)
    j_sgs, j_facets = _jax_fused("jax", sources)
    np.testing.assert_allclose(r_sgs, j_sgs, rtol=0,
                               atol=PKG_ATOL * np.abs(j_sgs).max())
    _assert_facets_match(config, r_facets, j_facets)


@pytest.mark.slow
def test_fused_mesh_planar_roundtrip():
    """The planar float64 backend (B1/B3's plain versions) through the
    fused mesh paths."""
    config = _config("planar", cpu_mesh())
    _, fcs, _, facets = _fused(config, tuple(SOURCES))
    assert max(T.check_facet(config.image_size, fc, facets[i], SOURCES)
               for i, fc in enumerate(fcs)) < RMS_BOUND


@pytest.mark.parametrize("spmd_mode, path", [
    ("shard_map", "sharded-column"), ("gspmd", "batched-column")])
def test_column_batched_mesh_matches_single_device(spmd_mode, path):
    """get_subgrid_tasks / add_new_subgrid_tasks on the mesh (one call and
    one collective a column) against the single-device column batching,
    and the dispatch path named as the JAX package names it."""
    from swiftly_tpu_torch.api import last_dispatch_path

    sources = tuple(SOURCES)

    def run(config):
        sgcs = T.make_full_subgrid_cover(config)
        fcs = T.make_full_facet_cover(config)
        fwd = T.SwiftlyForward(config, list(zip(fcs, _facets(sources))),
                               2, 50)
        tasks = fwd.get_subgrid_tasks(sgcs)
        dispatched = last_dispatch_path()
        bwd = T.SwiftlyBackward(config, fcs, 2, 50)
        bwd.add_new_subgrid_tasks(list(zip(sgcs, tasks)))
        core = config.core
        return (core.as_complex(torch.stack(tasks)),
                core.as_complex(bwd.finish()), dispatched)

    config = _config("torch", cpu_mesh(), spmd_mode)
    t_mesh, f_mesh, dispatched = run(config)
    t_single, f_single, _ = run(_config("torch"))
    assert dispatched == path
    np.testing.assert_allclose(t_mesh, t_single, rtol=0, atol=MESH_ATOL)
    np.testing.assert_allclose(f_mesh, f_single, rtol=0, atol=MESH_ATOL)
    _assert_facets_match(config, f_mesh, _jax_fused("jax", sources)[1])


def test_fused_mesh_psum_per_column(metrics_on):
    """The fused forward on the mesh reduces with one collective a column
    (not a subgrid): its ``mesh.psum`` stage counts the columns."""
    config = _config("torch", cpu_mesh())
    sgcs = T.make_full_subgrid_cover(config)
    n_cols = len({sg.off0 for sg in sgcs})
    _fused(config, tuple(SOURCES))
    stages = metrics.export()["stages"]
    assert stages["mesh.psum"]["count"] == n_cols
    assert "mesh.ring_step" not in stages


@pytest.mark.parametrize("collective", ["psum", "ring"])
def test_collective_bytes_model_matches_the_counts(metrics_on, monkeypatch,
                                                   collective):
    """The streamed column pass on the mesh runs exactly one collective a
    column, whose bytes are `collective_bytes_forward` for each of the
    column's subgrids (the [S, xM, xM, 2] partial stack, 2(d-1) buffers):
    the counts that stand in for ``tests/test_sharded.py``'s reading of
    the compiled HLO."""
    from swiftly_tpu_torch.utils.profiling import collective_bytes_forward

    monkeypatch.setenv("SWIFTLY_MESH_COLLECTIVE", collective)
    mesh = cpu_mesh()
    config = _config("planar", mesh)
    sgcs = T.make_full_subgrid_cover(config)
    fcs = T.make_full_facet_cover(config)
    fwd = T.StreamedForward(config, list(zip(fcs, _facets(tuple(SOURCES)))),
                            residency="device")
    fwd.all_subgrids(sgcs)
    n_cols = len({sg.off0 for sg in sgcs})
    S = len(sgcs) // n_cols
    stage = "mesh.ring_step" if collective == "ring" else "mesh.psum"
    got = metrics.export()["stages"][stage]
    assert got["count"] == n_cols
    per_subgrid = collective_bytes_forward(config.core.xM_size, N_SHARDS,
                                           dtype=np.float64, planar=True)
    assert got["bytes"] == n_cols * S * per_subgrid
    assert fwd.last_plan["collective"] == collective
    assert fwd.last_plan["mesh_shards"] == N_SHARDS
