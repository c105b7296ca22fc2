"""The port's mesh-streamed engine (`swiftly_tpu_torch.mesh`) over 8
virtual CPU shards, pinned to the JAX package's single-chip streamed
engine: the counterparts of ``tests/test_mesh_engine.py`` (the
multi-process bootstrap cases are in ``tests/test_torch_multiproc.py``).

The JAX test's geometry: N = 256, 3 x 3 facets over 8 shards, so the
stack pads 9 -> 16 in every case. No JAX mesh program runs (ROADMAP §C:
XLA's CPU all-reduce aborts xdist workers under load, and the JAX ring
fails on this tree): the port's mesh is held to the JAX package's
single-chip stream and facets on the same numpy inputs (the port's
config takes the JAX core's window constants), to the port's own
single-device engine, and its ring to its psum. Sources sit in several
facets, so every shard's partial sum is nonzero. Bounds, float64:

* the mesh's subgrid groups within 1e-12 of the JAX package's
  single-chip groups (``tests/test_mesh_engine.py``'s bound), and its
  facets within 1e-12 relative of the JAX package's once the window Fb
  is divided out (``tests/test_torch_streamed.py``'s bound);
* the ring within ``tests/test_mesh_engine.py``'s 1e-9 x max|facet| of
  the psum;
* bit for bit: the mesh backward against the single-device backward fed
  the same stream, two ring runs, a cache-fed pass against the recorded
  one, elastic recovery and ring kill-and-resume against the undisturbed
  run, and the checkpoint migration (8 -> 5 shards, 5 -> 8, 8 -> one
  device).
"""

import contextlib
import functools
import json
import os

import numpy as np
import pytest
import torch

import swiftly_tpu as J
import swiftly_tpu_torch as T
from swiftly_tpu_torch.mesh import (
    MeshStreamedBackward,
    MeshStreamedForward,
    make_facet_mesh,
)
from swiftly_tpu_torch.parallel.mesh import ShardedStack
from swiftly_tpu_torch.resilience import FaultPlan, faults
from swiftly_tpu_torch.utils.spill import SpillCache

PARAMS = dict(
    W=8.0, fov=1.0, N=256, yB_size=96, yN_size=128, xA_size=56,
    xM_size=64,
)
SOURCES = [(1.0, 3, -5), (0.5, -70, 60), (0.75, 80, -75), (0.3, -90, -40),
           (0.6, 60, 90)]
N_SHARDS = 8
ATOL = 1e-12
REL = 1e-12
RING_TOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_plan():
    faults.uninstall()
    yield
    faults.uninstall()


def cpu_mesh(n=N_SHARDS):
    return make_facet_mesh(devices=["cpu"] * n)


@functools.cache
def _jax_cover():
    config = J.SwiftlyConfig(backend="planar", **PARAMS)
    fcs = J.make_full_facet_cover(config)
    sgcs = J.make_full_subgrid_cover(config)
    tasks = [(fc, J.make_facet(config.image_size, fc, SOURCES))
             for fc in fcs]
    return config, fcs, sgcs, tasks


@functools.cache
def cover():
    """(config, facet_configs, facet_tasks, subgrid_configs) of the port,
    planar float64, on the JAX package's inputs."""
    jconfig, _, _, jtasks = _jax_cover()
    jcore = jconfig.core
    config = T.SwiftlyConfig.from_numpy_state(
        np.asarray(jcore._Fb), np.asarray(jcore._Fn), backend="planar",
        dtype=torch.float64, device="cpu", **PARAMS)
    fcs = T.make_full_facet_cover(config)
    sgcs = T.make_full_subgrid_cover(config)
    return config, fcs, [(fc, d) for fc, (_, d) in zip(fcs, jtasks)], sgcs


def _feed(fwd, bwd, subgrid_configs, spill=None, skip=()):
    """Stream the cover forward into the backward, group-fed; returns
    the yielded groups (host copies)."""
    groups = []
    skip = set(skip)
    for k, (per_col, group) in enumerate(
            fwd.stream_column_groups(subgrid_configs, spill=spill)):
        groups.append(group.numpy().copy())
        if k in skip:
            continue
        bwd.add_subgrid_group([[sg for _, sg in col] for col in per_col],
                              group)
    return groups


def _resume(fwd, bwd, subgrid_configs, processed):
    """Feed the groups the restored ledger does not hold whole."""
    done = set(processed)
    for per_col, group in fwd.stream_column_groups(subgrid_configs):
        keys = [(sg.off0, sg.off1) for col in per_col for _, sg in col]
        if all(k in done for k in keys):
            continue
        bwd.add_subgrid_group([[sg for _, sg in col] for col in per_col],
                              group)
    return bwd.finish()


@functools.cache
def jax_single_chip():
    """The JAX package's single-chip streamed round trip: (facets as
    planar host arrays, its forward groups)."""
    from swiftly_tpu.parallel import StreamedBackward, StreamedForward

    config, fcs, sgcs, tasks = _jax_cover()
    fwd = StreamedForward(config, tasks, residency="device")
    bwd = StreamedBackward(config, fcs, residency="sampled")
    groups = []
    for per_col, group in fwd.stream_column_groups(sgcs):
        groups.append(np.asarray(group))
        bwd.add_subgrid_group([[sg for _, sg in c] for c in per_col], group)
    return np.asarray(bwd.finish()), groups


def _assert_facets_match(got, ref):
    """Planar facets agree to REL relative with the window Fb divided
    out."""
    config = cover()[0]
    fb = config.core._p.extract_mid(config.core._Fb, PARAMS["yB_size"],
                                    0).numpy()
    w = (fb[:, None] * fb[None, :])[..., None]
    assert got.shape == ref.shape
    assert (np.abs(got - ref) / w).max() / (np.abs(ref) / w).max() < REL


@contextlib.contextmanager
def _knobs(**values):
    """The executors' knobs as given (None: unset) for the block, restored
    after: the module's cached references never see a test's knobs."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@functools.cache
def recorded(collective="psum", col_group=3):
    """A recorded mesh stream of `col_group` columns a group and the
    undisturbed mesh facets fed from it: (spill, facets)."""
    with _knobs(SWIFTLY_MESH_COLLECTIVE=collective, SWIFTLY_FOLD=None):
        config, fcs, tasks, sgcs = cover()
        mesh = cpu_mesh()
        mfwd = MeshStreamedForward(config, tasks, mesh=mesh)
        mfwd.col_group = col_group
        spill = SpillCache(budget_bytes=1e9)
        bwd = MeshStreamedBackward(config, fcs, mesh=mesh)
        _feed(mfwd, bwd, sgcs, spill=spill)
        return spill, bwd.finish()


def test_mesh_roundtrip_matches_single_chip_with_spill_feed():
    """The mesh-streamed round trip over 8 shards (9 facets padded to 16)
    against the JAX package's single-chip engine; the plan's MeshLayout
    bound by the engine; the stack split over every shard; the stream
    recorded under sharding and a cache-fed second pass bit-identical to
    the recorded one; and the mesh backward bit-equal to a single-device
    backward fed the same stream."""
    from swiftly_tpu_torch.plan import PlanInputs, compile_plan

    config, fcs, tasks, sgcs = cover()
    mesh = cpu_mesh()
    ref_facets, ref_groups = jax_single_chip()
    plan = compile_plan(
        PlanInputs.from_cover(config, fcs, sgcs, n_devices=N_SHARDS),
        mode="roundtrip-streamed")
    assert plan.mesh.status == "stub"
    assert plan.mesh.facet_shards == N_SHARDS
    assert plan.mesh.collective_bytes_total > 0

    mfwd = MeshStreamedForward(config, tasks, layout=plan.mesh, mesh=mesh)
    assert plan.mesh.status == "bound"
    assert plan.mesh.padded_facets == mfwd.stack.n_total == 16
    assert mfwd.stack.n_real == 9
    assert mfwd.facet_shards == N_SHARDS
    assert mfwd.layout_summary()["padded_facets"] == 16
    # the facet stack is split over every shard, 2 facets each
    mfwd._upload_resident_facets()
    assert len(mfwd._shards) == N_SHARDS
    assert all(s._dev_facets[0].shape[0] == 2 for s in mfwd._shards)

    spill = SpillCache(budget_bytes=1e9)
    bwd1 = MeshStreamedBackward(config, fcs, mesh=mesh)
    groups1 = _feed(mfwd, bwd1, sgcs, spill=spill)
    facets1 = bwd1.finish()
    assert spill.complete
    assert len(groups1) == len(ref_groups)
    for g_mesh, g_ref in zip(groups1, ref_groups):
        np.testing.assert_allclose(g_mesh, g_ref, rtol=0, atol=ATOL)
    _assert_facets_match(facets1, ref_facets)

    # cache-fed pass 2: the same stream, bit-identical folds; a mesh
    # backward and a single-device backward fed it give the same bits
    bwd2 = MeshStreamedBackward(config, fcs, mesh=mesh)
    single = T.StreamedBackward(config, fcs, residency="sampled")
    groups2 = []
    for per_col, group in mfwd.stream_column_groups(sgcs, spill=spill):
        groups2.append(group.numpy().copy())
        cols = [[sg for _, sg in col] for col in per_col]
        bwd2.add_subgrid_group(cols, group)
        single.add_subgrid_group(cols, group)
    for g1, g2 in zip(groups1, groups2):
        np.testing.assert_array_equal(g1, g2)
    facets2 = bwd2.finish()
    np.testing.assert_array_equal(facets1, facets2)
    np.testing.assert_array_equal(facets2, single.finish())


@pytest.mark.parametrize("fold", ["ct", "fft"])
def test_mesh_folds_are_shard_local_and_bit_equal(monkeypatch, fold):
    """The FFT and CT folds run in each shard's executor: the mesh
    backward keeps the single-device backward's bits under either."""
    monkeypatch.setenv("SWIFTLY_FOLD", fold)
    config, fcs, tasks, sgcs = cover()
    spill, _ = recorded()
    mesh = cpu_mesh()
    mbwd = MeshStreamedBackward(config, fcs, mesh=mesh)
    single = T.StreamedBackward(config, fcs, residency="sampled")
    T.feed_backward_passes(MeshStreamedForward(config, tasks, mesh=mesh),
                           sgcs, [mbwd, single], spill=spill)
    np.testing.assert_array_equal(mbwd.finish(), single.finish())


def test_mesh_row_slab_concat_equals_whole():
    """Output-row slabs under sharding concatenate to the whole-facet
    backward."""
    config, fcs, tasks, sgcs = cover()
    mesh = cpu_mesh()
    spill, whole = recorded()
    r_split = 60  # unaligned with any block size
    mfwd = MeshStreamedForward(config, tasks, mesh=mesh)
    slabs = [MeshStreamedBackward(config, fcs, mesh=mesh, row_slab=rs)
             for rs in [(0, r_split), (r_split, PARAMS["yB_size"])]]
    T.feed_backward_passes(mfwd, sgcs, slabs, spill=spill)
    np.testing.assert_allclose(
        np.concatenate([b.finish() for b in slabs], axis=1), whole,
        rtol=0, atol=ATOL)


def test_mesh_host_residency_matches_single_device():
    """The FFT facet pass on each shard into its own host rows (the host
    residency) and the host/device backward residencies on the mesh:
    the forward within reduction-order rounding of the single-device
    one, each backward bit-equal to its single-device twin fed the same
    columns."""
    config, fcs, tasks, sgcs = cover()
    mcfg = T.SwiftlyConfig.from_numpy_state(
        config.core._Fb.numpy(), config.core._Fn.numpy(), backend="planar",
        dtype=torch.float64, device="cpu", mesh=cpu_mesh(), **PARAMS)
    mfwd = T.StreamedForward(mcfg, tasks, residency="host")
    got = mfwd.all_subgrids(sgcs)
    want = T.StreamedForward(config, tasks, residency="host").all_subgrids(
        sgcs)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL * np.abs(want).max())
    assert mfwd.last_plan["mode"] == "host"
    assert mfwd.last_plan["mesh_shards"] == N_SHARDS
    for residency in ("host", "device"):
        mb = T.StreamedBackward(mcfg, fcs, residency=residency)
        sb = T.StreamedBackward(config, fcs, residency=residency)
        for items, sgs in mfwd.stream_columns(sgcs, device_arrays=True):
            cfgs = [sg for _, sg in items]
            mb.add_subgrid_stack(cfgs, sgs[:len(items)])
            sb.add_subgrid_stack(cfgs, sgs[:len(items)])
        np.testing.assert_array_equal(mb.finish(), sb.finish())


def test_mesh_refuses_slabs_and_densifies_sparse_facets():
    """As the JAX package: a mesh shards the stack instead of streaming
    facet slabs, and sparse facets are densified (no synthesis on a
    mesh)."""
    config, fcs, tasks, sgcs = cover()
    mcfg = T.SwiftlyConfig.from_numpy_state(
        config.core._Fb.numpy(), config.core._Fn.numpy(), backend="planar",
        dtype=torch.float64, device="cpu", mesh=cpu_mesh(), **PARAMS)
    fwd = T.StreamedForward(mcfg, tasks, residency="device", facet_group=2)
    with pytest.raises(ValueError, match="single-device strategy"):
        next(fwd.stream_column_groups(sgcs))
    sparse = [(fc, T.make_sparse_facet(config.image_size, fc, SOURCES,
                                       dtype=np.float64)) for fc in fcs]
    sfwd = T.StreamedForward(mcfg, sparse, residency="device")
    assert not sfwd._facets_sparse and sfwd._facets_real
    dense = T.StreamedForward(config, [(fc, d.densify(np.float64))
                                       for fc, d in sparse],
                              residency="device")
    np.testing.assert_allclose(sfwd.all_subgrids(sgcs),
                               dense.all_subgrids(sgcs), rtol=0,
                               atol=ATOL)


def test_mesh_checkpoint_records_and_migrates_layout(tmp_path):
    """The snapshot's meta records the mesh layout; a restore onto the
    same sharding resumes bit-identically; onto 5 shards, back onto 8,
    and onto one device it migrates (real facets kept, padding regrown,
    ``ckpt.migrations``) and resumes to the same bits; a torn snapshot
    is still corruption, not a layout mismatch."""
    from swiftly_tpu_torch.obs import metrics
    from swiftly_tpu_torch.resilience import degrade
    from swiftly_tpu_torch.utils.checkpoint import (
        CorruptCheckpointError,
        restore_streamed_backward_state,
        save_streamed_backward_state,
    )

    config, fcs, tasks, sgcs = cover()
    mesh = cpu_mesh()
    mfwd = MeshStreamedForward(config, tasks, mesh=mesh)
    mfwd.col_group = 3  # two groups: "half-fed" is a group boundary
    want = _want_fold2()

    bwd = MeshStreamedBackward(config, fcs, mesh=mesh, fold_group=2)
    _feed(mfwd, bwd, sgcs, skip={1})
    ck = tmp_path / "mesh_bwd.npz"
    save_streamed_backward_state(ck, bwd)
    with np.load(ck) as data:
        meta = json.loads(bytes(data["meta"].tobytes()).decode())
        assert data["acc"].shape[0] == 16  # the padded stack, gathered
    assert meta["mesh"] == {
        "n_devices": N_SHARDS, "facet_shards": N_SHARDS, "axis": "facet"}
    assert meta["pending_offs"]  # 3 columns, folds of 2: one pending

    def resumed(target):
        b = target()
        done = restore_streamed_backward_state(ck, b)
        assert done == bwd.processed == b.processed
        for part in b._shards or [b]:  # the state is back on each shard
            assert part._acc is not None and len(part._pending_rows) == 1
        return _resume(mfwd, b, sgcs, done), b

    same, _ = resumed(lambda: MeshStreamedBackward(config, fcs, mesh=mesh,
                                                   fold_group=2))
    np.testing.assert_array_equal(same, want)

    metrics.reset()
    metrics.enable()
    degrade.reset()
    try:
        on5, b5 = resumed(lambda: MeshStreamedBackward(
            config, fcs, mesh=cpu_mesh(5), fold_group=2))
        assert b5.stack.n_total == 10
        np.testing.assert_array_equal(on5, want)
        on1, _ = resumed(lambda: T.StreamedBackward(
            config, fcs, residency="sampled", fold_group=2))
        np.testing.assert_array_equal(on1, want)
        assert metrics.export()["counters"]["ckpt.migrations"] == 2
    finally:
        metrics.disable()
        metrics.reset()
    assert any(d["site"] == "checkpoint" and d["action"] == "migrate_layout"
               for d in degrade.events())

    # 5 -> 8: a snapshot of the 5-shard layout migrates back
    b5 = MeshStreamedBackward(config, fcs, mesh=cpu_mesh(5), fold_group=2)
    _feed(mfwd, b5, sgcs, skip={1})
    ck5 = tmp_path / "mesh5.npz"
    save_streamed_backward_state(ck5, b5)
    b8 = MeshStreamedBackward(config, fcs, mesh=mesh, fold_group=2)
    done = restore_streamed_backward_state(ck5, b8)
    np.testing.assert_array_equal(_resume(mfwd, b8, sgcs, done), want)

    raw = bytearray(ck.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    (tmp_path / "torn.npz").write_bytes(raw)
    with pytest.raises((CorruptCheckpointError, ValueError)):
        restore_streamed_backward_state(
            tmp_path / "torn.npz",
            MeshStreamedBackward(config, fcs, mesh=mesh, fold_group=2))


@functools.cache
def _want_fold2():
    """The undisturbed mesh run at fold group 2 (the checkpoint case's)."""
    config, fcs, tasks, sgcs = cover()
    spill, _ = recorded()
    with _knobs(SWIFTLY_FOLD=None):
        bwd = MeshStreamedBackward(config, fcs, mesh=cpu_mesh(),
                                   fold_group=2)
        T.feed_backward_passes(MeshStreamedForward(config, tasks,
                                                   mesh=cpu_mesh()),
                               sgcs, [bwd], spill=spill)
        return bwd.finish()


def test_mesh_elastic_recovery_survives_shard_loss(tmp_path):
    """A ``mesh.shard_loss`` injected mid-pass: `run_elastic_pass`
    re-plans 8 -> 7 on the survivors through the plan compiler, rebuilds
    both engines, migrates the last autosave, resumes at its group
    boundary, and the facets are bit-identical to the undisturbed mesh
    run; a second loss past ``max_recoveries`` re-raises."""
    from swiftly_tpu_torch.mesh import run_elastic_pass, survivor_mesh
    from swiftly_tpu_torch.plan import PlanInputs
    from swiftly_tpu_torch.resilience import ShardLostError, degrade

    config, fcs, tasks, sgcs = cover()
    mesh = cpu_mesh()
    spill, want = recorded()
    mfwd = MeshStreamedForward(config, tasks, mesh=mesh)
    mfwd.col_group = 3
    degrade.reset()
    bwd = MeshStreamedBackward(config, fcs, mesh=mesh)
    plan = FaultPlan(faults=[
        {"site": "mesh.shard_loss", "kind": "shard_loss", "at": 1}])
    inputs = PlanInputs.from_cover(config, fcs, sgcs, n_devices=N_SHARDS)
    with faults.active(plan):
        fwd2, bwd, report = run_elastic_pass(
            mfwd, bwd, sgcs, spill, str(tmp_path / "elastic.npz"),
            plan_inputs=inputs)
    assert plan.stats()["total"] == 1
    np.testing.assert_array_equal(bwd.finish(), want)
    assert report["events"] == 1
    assert report["shards_before"] == N_SHARDS
    assert report["shards_after"] == N_SHARDS - 1
    info = report["recoveries"][0]
    assert info["detected_via"] == "ShardLostError"
    assert info["replanned"]["facet_shards"] == N_SHARDS - 1
    assert info["migrated"] and info["subgrids_migrated"] > 0
    assert report["recovery_wall_s"] > 0
    assert any(d["site"] == "mesh" and d["action"] == "replan_survivors"
               for d in degrade.events())
    assert len(fwd2.mesh.devices) == N_SHARDS - 1
    assert len(bwd.mesh.devices) == N_SHARDS - 1
    assert bwd.stack.n_total == 14

    plan2 = FaultPlan(faults=[
        {"site": "mesh.shard_loss", "kind": "shard_loss", "at": 0}])
    with faults.active(plan2), pytest.raises(ShardLostError):
        run_elastic_pass(
            fwd2, MeshStreamedBackward(config, fcs, mesh=fwd2.mesh), sgcs,
            spill, str(tmp_path / "e2.npz"), plan_inputs=inputs,
            max_recoveries=0)
    with pytest.raises(ValueError, match="out of range"):
        survivor_mesh(mesh, lost_shard=N_SHARDS)
    assert survivor_mesh(mesh, lost_shard=2)[1] == 2


def test_engine_binds_and_refuses_a_layout_of_another_mesh():
    """The layout flip and the artifact validator accept the bound
    status; an engine refuses a layout whose shard count disagrees with
    its mesh."""
    from swiftly_tpu_torch.obs import validate_plan_artifact
    from swiftly_tpu_torch.plan import PlanInputs, compile_plan, \
        plan_mesh_layout

    config, fcs, tasks, sgcs = cover()
    plan = compile_plan(PlanInputs.from_cover(config, fcs, sgcs,
                                              n_devices=4))
    MeshStreamedBackward(config, fcs, layout=plan.mesh, mesh=cpu_mesh(4))
    assert plan.mesh.status == "bound" and plan.mesh.padded_facets == 12
    record = {"plan_compiled": plan.artifact_block()}
    assert validate_plan_artifact(record) == []
    assert record["plan_compiled"]["mesh"]["status"] == "bound"
    wrong = plan_mesh_layout(PlanInputs.from_cover(config, fcs, sgcs,
                                                   n_devices=2))
    with pytest.raises(ValueError, match="facet shard"):
        MeshStreamedForward(config, tasks, layout=wrong, mesh=cpu_mesh())


@pytest.mark.parametrize("n_shards", [2, 4, N_SHARDS])
def test_ring_matches_psum_across_shard_counts(monkeypatch, n_shards):
    """The ring reproduces the psum round trip at 2, 4 and 8 shards
    (9 facets pad to 10, 12, 16: the padding adds exact zeros to every
    chunk), within reduction-order tolerance; the engine reports the
    schedule it ran; both agree with the JAX package's single chip."""
    config, fcs, tasks, sgcs = cover()
    mesh = cpu_mesh(n_shards)

    def run(collective):
        monkeypatch.setenv("SWIFTLY_MESH_COLLECTIVE", collective)
        mfwd = MeshStreamedForward(config, tasks, mesh=mesh)
        assert mfwd.collective == collective
        bwd = MeshStreamedBackward(config, fcs, mesh=mesh)
        groups = _feed(mfwd, bwd, sgcs)
        assert mfwd.last_plan["collective"] == collective
        return groups, bwd.finish()

    groups_psum, facets_psum = run("psum")
    groups_ring, facets_ring = run("ring")
    scale = float(np.max(np.abs(facets_psum)))
    for g_ring, g_psum in zip(groups_ring, groups_psum):
        np.testing.assert_allclose(g_ring, g_psum, rtol=0,
                                   atol=RING_TOL * max(scale, 1.0))
    np.testing.assert_allclose(facets_ring, facets_psum, rtol=0,
                               atol=RING_TOL * max(scale, 1.0))
    _assert_facets_match(facets_ring, jax_single_chip()[0])


def test_two_ring_runs_are_bit_identical(monkeypatch):
    monkeypatch.setenv("SWIFTLY_MESH_COLLECTIVE", "ring")
    config, fcs, tasks, sgcs = cover()
    mesh = cpu_mesh()
    runs = []
    for _ in range(2):
        bwd = MeshStreamedBackward(config, fcs, mesh=mesh)
        groups = _feed(MeshStreamedForward(config, tasks, mesh=mesh), bwd,
                       sgcs)
        runs.append((groups, bwd.finish()))
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_ring_kill_resume_bit_identity(tmp_path, monkeypatch):
    """A ``mesh.shard_loss`` mid-pass under the ring re-plans 8 -> 7 with
    the ring re-resolved for the survivors, and the recovered facets are
    bit-identical to the undisturbed ring run."""
    from swiftly_tpu_torch.mesh import run_elastic_pass
    from swiftly_tpu_torch.plan import PlanInputs

    monkeypatch.setenv("SWIFTLY_MESH_COLLECTIVE", "ring")
    config, fcs, tasks, sgcs = cover()
    mesh = cpu_mesh()
    spill, want = recorded("ring")
    mfwd = MeshStreamedForward(config, tasks, mesh=mesh)
    mfwd.col_group = 3
    bwd = MeshStreamedBackward(config, fcs, mesh=mesh)
    plan = FaultPlan(faults=[
        {"site": "mesh.shard_loss", "kind": "shard_loss", "at": 1}])
    inputs = PlanInputs.from_cover(config, fcs, sgcs, n_devices=N_SHARDS)
    with faults.active(plan):
        fwd2, bwd, report = run_elastic_pass(
            mfwd, bwd, sgcs, spill, str(tmp_path / "ring_elastic.npz"),
            plan_inputs=inputs)
    np.testing.assert_array_equal(bwd.finish(), want)
    assert report["shards_after"] == N_SHARDS - 1
    info = report["recoveries"][0]
    assert info["replanned"]["facet_shards"] == N_SHARDS - 1
    assert info["replanned"]["collective"] == "ring"
    assert fwd2.collective == "ring"


def test_ring_step_stall_triggers_replan_to_survivors(tmp_path,
                                                      monkeypatch):
    """A stalled ``mesh.ring_step`` (injected latency past a small
    SWIFTLY_COLLECTIVE_TIMEOUT_S, in the recording pass, whose wait for
    each group is the site) raises `CollectiveStalledError` from the
    watchdog, and `run_elastic_pass` re-plans onto the survivors; the
    groups after the recovery compute on 7 shards, so the facets agree
    with the undisturbed run to reduction-order tolerance."""
    from swiftly_tpu_torch.mesh import run_elastic_pass
    from swiftly_tpu_torch.plan import PlanInputs

    monkeypatch.setenv("SWIFTLY_MESH_COLLECTIVE", "ring")
    config, fcs, tasks, sgcs = cover()
    mesh = cpu_mesh()
    want = recorded("ring")[1]
    mfwd = MeshStreamedForward(config, tasks, mesh=mesh)
    mfwd.col_group = 3
    monkeypatch.setenv("SWIFTLY_COLLECTIVE_TIMEOUT_S", "0.15")
    bwd = MeshStreamedBackward(config, fcs, mesh=mesh)
    plan = FaultPlan(faults=[
        {"site": "mesh.ring_step", "kind": "latency", "at": 1,
         "delay_s": 0.6}])
    inputs = PlanInputs.from_cover(config, fcs, sgcs, n_devices=N_SHARDS)
    with faults.active(plan):
        _fwd2, bwd, report = run_elastic_pass(
            mfwd, bwd, sgcs, SpillCache(budget_bytes=1e9),
            str(tmp_path / "ring_stall.npz"), plan_inputs=inputs)
    assert plan.stats()["by_site"] == {"mesh.ring_step": 1}
    info = report["recoveries"][0]
    assert info["detected_via"] == "CollectiveStalledError"
    assert report["shards_after"] == N_SHARDS - 1
    assert report["watchdog"]["timeout_s"] == 0.15
    got = bwd.finish()
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RING_TOL * max(scale, 1.0))


def test_mesh_sizers_price_the_collective_buffers(monkeypatch):
    """The sizers price a mesh on its device: the shards' facets and
    rows together, a shard's column transients beside the partials held
    to the collective, the ring's buffers above the psum's; the mesh
    backward's device bytes are its shards' on the device."""
    from swiftly_tpu_torch.parallel import streamed as ts

    config, fcs, tasks, sgcs = cover()
    single = T.StreamedForward(config, tasks, residency="device")._base
    mcfg = T.SwiftlyConfig.from_numpy_state(
        config.core._Fb.numpy(), config.core._Fn.numpy(), backend="planar",
        dtype=torch.float64, device="cpu", mesh=cpu_mesh(), **PARAMS)
    mesh = T.StreamedForward(mcfg, tasks, residency="device")._base
    S, xA, yB = 5, PARAMS["xA_size"], PARAMS["yB_size"]
    part = S * PARAMS["xM_size"] ** 2 * 16
    psum_T = ts._resident_transients(mesh, S, xA, yB)
    assert psum_T >= (N_SHARDS + 1) * part
    monkeypatch.setenv("SWIFTLY_MESH_COLLECTIVE", "ring")
    assert ts._resident_transients(mesh, S, xA, yB) > psum_T
    flat_m, col_m = ts.resident_working_set(mesh)
    flat_s, col_s = ts.resident_working_set(single)
    assert flat_m > flat_s  # 16 facets resident (7 of them padding)
    sb = T.StreamedBackward(config, fcs, residency="sampled")
    mb = T.StreamedBackward(mcfg, fcs, residency="sampled")
    rest_s, act_s = sb.device_bytes(S, xA)
    rest_m, act_m = mb.device_bytes(S, xA)
    assert rest_m == sum(s.device_bytes(S, xA)[0] for s in mb._shards)
    assert rest_m >= rest_s and act_m >= rest_m


def test_mesh_backward_finish_device_is_sharded():
    config, fcs, tasks, sgcs = cover()
    spill, want = recorded()
    bwd = MeshStreamedBackward(config, fcs, mesh=cpu_mesh())
    T.feed_backward_passes(MeshStreamedForward(config, tasks,
                                               mesh=cpu_mesh()),
                           sgcs, [bwd], spill=spill)
    out = bwd.finish_device()
    assert isinstance(out, ShardedStack) and out.n_pad == 7
    assert [t.shape[0] for t in out.shards] == [2] * N_SHARDS
    np.testing.assert_array_equal(out.numpy(), want)
    assert not out.shards[-1].any()  # padding facets fold to zero
    with pytest.raises(RuntimeError):
        bwd.finish()


@pytest.mark.slow
@pytest.mark.parametrize("collective", ["psum", "ring"])
def test_mesh_engine_1k_drill(collective, monkeypatch):
    """The 1k catalogue config, planar f32: the mesh round trip over 8
    shards within reduction-order tolerance of the single-device one
    (``tests/test_mesh_engine.py``'s 5e-5 x max|facet|)."""
    monkeypatch.setenv("SWIFTLY_MESH_COLLECTIVE", collective)
    params = dict(T.SWIFT_CONFIGS["1k[1]-n512-256"])
    config = T.SwiftlyConfig(backend="planar", dtype=torch.float32,
                             device="cpu", **params)
    fcs = T.make_full_facet_cover(config)
    sgcs = T.make_full_subgrid_cover(config)
    tasks = [(fc, T.make_real_facet(config.image_size, fc, SOURCES))
             for fc in fcs]
    bwd = T.StreamedBackward(config, fcs, residency="sampled")
    T.feed_backward_passes(T.StreamedForward(config, tasks,
                                             residency="device"),
                           sgcs, [bwd])
    ref = bwd.finish()
    mesh = cpu_mesh()
    mbwd = MeshStreamedBackward(config, fcs, mesh=mesh)
    T.feed_backward_passes(MeshStreamedForward(config, tasks, mesh=mesh),
                           sgcs, [mbwd])
    got = mbwd.finish()
    scale = float(np.max(np.abs(ref)))
    assert float(np.max(np.abs(got - ref))) <= 5e-5 * scale
