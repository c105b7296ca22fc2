"""The port's facet mesh across processes (``torch.distributed``, gloo on
the CPU): the counterparts of ``tests/test_mesh_engine.py``'s bootstrap
cases, and real runs of several ranks against the single-process mesh.

The bootstrap cases pin `bootstrap_from_env`'s env contract with
``torch.distributed.init_process_group`` monkeypatched. The real runs
spawn this file as a script, one process a rank, each joining through
`bootstrap_from_env` at a ``file://`` rendezvous in the test's tmp dir
(no TCP port, so that parallel test workers cannot race for one), and
two more processes beside them for the single-process mesh. Each
rank runs the mesh-streamed round trip under psum and under ring over
its own shards of ``1k[1]-n512-256`` (planar float64, the JAX package's
window constants and facets, passed in a file), checks inside itself
that the placement holds its own shards only and that a gather leaves
the other ranks' rows zero, and writes its forward groups and facets
back; another case loses a shard mid-pass under `run_elastic_pass`, so
that the autosave's rows move between ranks on the restore. Bounds:

* bit for bit: every rank's forward groups and its own facets against
  the single-process port mesh over the same number of shards, under
  both collectives (the backward is shard-local: one device's bits);
* the other ranks' facet rows zero;
* the facets the ranks hold between them within the JAX package's f64
  bounds (RMS < 3e-10, ``tests/conftest.py``) of its single-device
  streamed round trip, and of the input facets.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
CONFIG = "1k[1]-n512-256"
SOURCES = [(1.0, 1, 0), (0.5, -300, 200), (0.75, 250, -180),
           (0.25, -120, -350), (0.6, 380, 360)]
COL_GROUP = 3
RMS_BOUND = 3e-10
RANK_TIMEOUT_S = 120
KNOBS = ("SWIFTLY_COORDINATOR", "SWIFTLY_NUM_PROCESSES",
         "SWIFTLY_PROCESS_ID")


# -- the rank body (run as a script) -----------------------------------------


def _port_cover(inputs):
    """The port's config, facet configs, facet tasks and subgrid configs
    on the inputs file's window constants and facets."""
    import swiftly_tpu_torch as T

    data = np.load(inputs)
    params = dict(T.SWIFT_CONFIGS[CONFIG])
    config = T.SwiftlyConfig.from_numpy_state(
        data["Fb"], data["Fn"], backend="planar", dtype=torch.float64,
        device="cpu", **params)
    fcs = T.make_full_facet_cover(config)
    sgcs = T.make_full_subgrid_cover(config)
    tasks = [(fc, data["facets"][i]) for i, fc in enumerate(fcs)]
    return config, fcs, tasks, sgcs


def _held_rows(mesh, n_real):
    """The real facet rows this rank's shards of `mesh` hold."""
    from swiftly_tpu_torch.parallel.mesh import local_bounds

    n_total = -(-n_real // len(mesh)) * len(mesh)
    return np.array([j for lo, hi in local_bounds(n_total, mesh)
                     for j in range(lo, min(hi, n_real))], int)


def _elastic(mesh, config, fcs, tasks, sgcs, ckpt_path):
    """The psum stream recorded into a spill cache, then fed from it by
    `run_elastic_pass` into a fresh backward that loses shard 0 at the
    second group: (the recording's groups, the recovered facets, the
    survivor mesh). Over 2 ranks x 2 shards of 9 facets the survivors
    are shards (0, 1, 1) of 3 facets each, so facets 3-5 move from rank
    0 to rank 1 through the autosave's restore."""
    from swiftly_tpu_torch.mesh import (
        MeshStreamedBackward,
        MeshStreamedForward,
        engine,
        run_elastic_pass,
    )
    from swiftly_tpu_torch.resilience import ShardLostError
    from swiftly_tpu_torch.utils.checkpoint import rank_checkpoint_path
    from swiftly_tpu_torch.utils.spill import SpillCache

    fwd = MeshStreamedForward(config, tasks, mesh=mesh, col_group=COL_GROUP)
    spill = SpillCache(budget_bytes=1e9)
    groups = [g.numpy().copy()
              for _, g in fwd.stream_column_groups(sgcs, spill=spill)]
    real, seen = engine._fault_point, []

    def lose_shard_0(site, *args, **kwargs):
        if site == "mesh.shard_loss":
            seen.append(site)
            if len(seen) == 2:
                raise ShardLostError("shard 0 lost", shard=0)
        return real(site, *args, **kwargs)

    engine._fault_point = lose_shard_0
    try:
        _, bwd, report = run_elastic_pass(
            fwd, MeshStreamedBackward(config, fcs, mesh=mesh), sgcs, spill,
            ckpt_path)
    finally:
        engine._fault_point = real
    info = report["recoveries"][0]
    assert report["events"] == 1, report
    assert report["shards_after"] == len(mesh) - 1, report
    assert info["lost_shard"] == 0 and info["migrated"], info
    assert info["subgrids_migrated"] > 0, info
    # each rank autosaved to a file of its own
    assert os.path.exists(rank_checkpoint_path(ckpt_path, mesh))
    assert os.path.exists(ckpt_path) != mesh.spans_processes
    return np.concatenate(groups), bwd.finish(), bwd.mesh


def _round_trips(mesh, inputs, modes=("psum", "ring"), ckpt_path=None):
    """{mode: (forward subgrids [C, S, xA, xA, 2] or [n, xA, xA, 2],
    facets, the real facet rows this rank holds)} of the round trip under
    each of `modes`: ``psum`` and ``ring``, the mesh-streamed round trip
    under that collective; ``api``, `SwiftlyForward.get_subgrid_tasks`
    and `backward_all` on a config with the mesh attached (psum);
    ``ckpt``, the psum stream whose backward is saved after its first
    group to `ckpt_path`, restored into a fresh backward and fed the
    rest; ``elastic``, `_elastic` with its autosave beside `ckpt_path`
    at one path for all ranks."""
    import swiftly_tpu_torch as T
    from swiftly_tpu_torch.mesh import (
        MeshStreamedBackward,
        MeshStreamedForward,
        attach_mesh,
    )
    from swiftly_tpu_torch.utils.checkpoint import (
        restore_streamed_backward_state,
        save_streamed_backward_state,
    )

    config, fcs, tasks, sgcs = _port_cover(inputs)
    held = _held_rows(mesh, len(fcs))
    out = {}
    for mode in modes:
        os.environ["SWIFTLY_MESH_COLLECTIVE"] = (
            "ring" if mode == "ring" else "psum")
        if mode == "api":
            cfg = attach_mesh(config, mesh)
            subgrids = T.SwiftlyForward(cfg, tasks).get_subgrid_tasks(sgcs)
            facets = T.backward_all(cfg, fcs, list(zip(sgcs, subgrids)))
            out[mode] = (torch.stack(subgrids).numpy(), facets.numpy(),
                         held)
            continue
        if mode == "elastic":
            # one path for every rank (each writes its own file), and
            # another for the single-process mesh running beside them
            name = "elastic.npz" if mesh.spans_processes else "single.npz"
            groups, facets, survivors = _elastic(
                mesh, config, fcs, tasks, sgcs,
                str(Path(ckpt_path).parent / name))
            out[mode] = (groups, facets, _held_rows(survivors, len(fcs)))
            continue
        fwd = MeshStreamedForward(config, tasks, mesh=mesh,
                                  col_group=COL_GROUP)
        bwd = MeshStreamedBackward(config, fcs, mesh=mesh)
        groups = []
        for k, (per_col, group) in enumerate(
                fwd.stream_column_groups(sgcs)):
            groups.append(group.numpy().copy())
            bwd.add_subgrid_group(
                [[sg for _, sg in col] for col in per_col], group)
            if mode == "ckpt" and k == 0:
                save_streamed_backward_state(ckpt_path, bwd)
                bwd = MeshStreamedBackward(config, fcs, mesh=mesh)
                restore_streamed_backward_state(ckpt_path, bwd)
        assert fwd.last_plan["collective"] == os.environ[
            "SWIFTLY_MESH_COLLECTIVE"]
        out[mode] = (np.concatenate(groups), bwd.finish(), held)
    os.environ.pop("SWIFTLY_MESH_COLLECTIVE")
    return out


def _rank_main(inputs, out_path, shards, modes):
    """One rank: bootstrap from the env, a mesh of `shards` CPU shards a
    rank, the placement and gather checks, the round trips of `modes`
    (`_round_trips`). Without the env's knobs, the single-process mesh of
    `shards` shards."""
    from swiftly_tpu_torch.mesh import host_gather, host_replica
    from swiftly_tpu_torch.parallel.mesh import (
        bootstrap_from_env,
        make_facet_mesh,
        place_facet_sharded,
    )

    torch.set_num_threads(1)
    info = bootstrap_from_env()
    mesh = make_facet_mesh(devices=["cpu"] * shards)
    if info is not None:
        rank, world = info["process_id"], info["num_processes"]
        assert mesh.backend == "gloo" and "gloo" in repr(mesh), repr(mesh)
        assert len(mesh) == world * shards and mesh.spans_processes
        assert mesh.local == tuple(range(rank * shards,
                                         (rank + 1) * shards))
        assert mesh.ranks == tuple(r for r in range(world)
                                   for _ in range(shards))
        # the placement holds this rank's shards only; a gather fills
        # the other ranks' rows with zeros, the placement's padding
        # dropped
        n = len(mesh)
        glob = np.arange(1.0, (2 * n - 1) * 3 + 1).reshape(2 * n - 1, 3)
        x = place_facet_sharded(glob, mesh)
        assert len(x.shards) == shards and x.n_pad == 1
        assert x.shape == (2 * n, 3)
        padded = np.concatenate([glob, np.zeros((1, 3))])
        for i, t in zip(mesh.local, x.shards):
            assert np.array_equal(t.numpy(), padded[2 * i:2 * i + 2])
        got = host_gather(x)
        assert got.shape == glob.shape
        mine = np.zeros(2 * n, bool)
        for i in mesh.local:
            mine[2 * i:2 * i + 2] = True
        mine = mine[:2 * n - 1]
        assert np.array_equal(got[mine], glob[mine])
        assert not got[~mine].any()
        assert np.array_equal(host_replica(x), x.shards[0].numpy())
    res = _round_trips(mesh, inputs, modes,
                       out_path.replace(".npz", "_ckpt.npz"))
    np.savez(out_path, **{f"{c}_{k}": v for c, (g, f, h) in res.items()
                          for k, v in (("groups", g), ("facets", f),
                                       ("rows", h))})


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2], int(sys.argv[3]),
               sys.argv[4].split(","))
    sys.exit(0)


# -- the cases ---------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_bootstrap_from_env_noop_without_env(monkeypatch):
    """With none of the SWIFTLY_* knobs set, `bootstrap_from_env` is a
    no-op returning None: a single-process run never touches
    torch.distributed."""
    import torch.distributed as dist

    from swiftly_tpu_torch.parallel.mesh import bootstrap_from_env

    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    assert bootstrap_from_env() is None
    assert calls == []


def test_bootstrap_from_env_passes_knobs(monkeypatch):
    """The three knobs reach init_process_group as a tcp:// init method,
    world size and rank, coerced to ints, and come back in the resolved
    dict; a partial env forwards only the knobs that are set (env://
    without a coordinator)."""
    import torch.distributed as dist

    from swiftly_tpu_torch.parallel.mesh import bootstrap_from_env

    monkeypatch.setenv("SWIFTLY_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("SWIFTLY_NUM_PROCESSES", "4")
    monkeypatch.setenv("SWIFTLY_PROCESS_ID", "2")
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    resolved = bootstrap_from_env()
    assert calls == [{
        "backend": "gloo",
        "init_method": "tcp://10.0.0.1:8476",
        "world_size": 4,
        "rank": 2,
    }]
    assert resolved == {
        "coordinator": "10.0.0.1:8476",
        "num_processes": 4,
        "process_id": 2,
    }
    monkeypatch.delenv("SWIFTLY_COORDINATOR")
    monkeypatch.delenv("SWIFTLY_PROCESS_ID")
    calls.clear()
    assert bootstrap_from_env() == {
        "coordinator": None, "num_processes": 4, "process_id": None}
    assert calls == [{"backend": "gloo", "init_method": "env://",
                      "world_size": 4}]


def test_backend_rule():
    """nccl only when every rank has CUDA cards of its own."""
    from swiftly_tpu_torch.parallel.mesh import backend_rule

    def rank(devices, cards, host="h"):
        return {"devices": devices, "host": host, "cards": cards}

    assert backend_rule([rank(["cuda:0"], ["a"]),
                         rank(["cuda:1"], ["b"])]) == "nccl"
    assert backend_rule([rank(["cuda:0"], ["a"]),
                         rank(["cuda:0"], ["a"])]) == "gloo"
    assert backend_rule([rank(["cuda:0"], ["a"], "h1"),
                         rank(["cuda:0"], ["a"], "h2")]) == "nccl"
    assert backend_rule([rank(["cpu"], []),
                         rank(["cuda:0"], ["a"])]) == "gloo"
    assert backend_rule([rank(["cuda:0", "cuda:0"], ["a", "a"]),
                         rank(["cuda:1"], ["b"])]) == "nccl"


def test_a_process_mesh_holds_its_own_shards_and_loses_no_rank():
    """A mesh over processes, built from its shard list: this rank's
    shards, the zero rows of a gather, and the survivor mesh of a lost
    shard, which keeps the process group and raises, naming the rank,
    where a rank would be left with no shard."""
    from swiftly_tpu_torch.mesh import host_gather, survivor_mesh
    from swiftly_tpu_torch.parallel.mesh import (
        FacetMesh,
        place_facet_sharded,
    )

    mesh = FacetMesh(["cpu"] * 4, ranks=[0, 0, 1, 1], rank=1,
                     backend="gloo")
    assert mesh.local == (2, 3) and mesh.spans_processes
    assert "backend='gloo'" in repr(mesh)
    x = place_facet_sharded(np.arange(8.0)[:, None] + 1, mesh)
    assert [t.flatten().tolist() for t in x.shards] == [[5, 6], [7, 8]]
    assert host_gather(x).flatten().tolist() == [0, 0, 0, 0, 5, 6, 7, 8]
    survivors, lost = survivor_mesh(mesh, 0)
    assert lost == 0 and survivors.ranks == (0, 1, 1)
    assert survivors.local == (1, 2) and survivors.backend == "gloo"
    with pytest.raises(RuntimeError, match="rank 0 with no shard"):
        survivor_mesh(survivors, 0)


def test_a_rank_without_the_card_its_mesh_names_raises(monkeypatch):
    """No CPU fallback: a rank whose mesh names a CUDA card it cannot see
    raises before it joins the exchange."""
    from swiftly_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(pmesh, "_process_group", lambda: (1, 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="rank 1: the mesh names cuda:0"):
        pmesh.make_facet_mesh(devices=["cuda:0"])


@functools.cache
def _inputs(tmp_dir):
    """The JAX package's window constants and planar facets of CONFIG
    with SOURCES, in a file the ranks read, and the port's cover on
    them."""
    import swiftly_tpu as J
    import swiftly_tpu_torch as T

    jconfig = J.SwiftlyConfig(backend="planar", **T.SWIFT_CONFIGS[CONFIG])
    jcore = jconfig.core
    fcs = J.make_full_facet_cover(jconfig)
    facets = np.stack([np.asarray(J.make_facet(jconfig.image_size, fc,
                                               SOURCES)) for fc in fcs])
    path = Path(tmp_dir) / "inputs.npz"
    np.savez(path, Fb=np.asarray(jcore._Fb), Fn=np.asarray(jcore._Fn),
             facets=facets)
    return str(path)


@functools.cache
def _jax_single_device(inputs):
    """The JAX package's single-device streamed round trip's facets."""
    import swiftly_tpu as J
    from swiftly_tpu.parallel import StreamedBackward, StreamedForward

    data = np.load(inputs)
    import swiftly_tpu_torch as T

    config = J.SwiftlyConfig(backend="planar", **T.SWIFT_CONFIGS[CONFIG])
    fcs = J.make_full_facet_cover(config)
    sgcs = J.make_full_subgrid_cover(config)
    tasks = [(fc, data["facets"][i]) for i, fc in enumerate(fcs)]
    fwd = StreamedForward(config, tasks, residency="device")
    bwd = StreamedBackward(config, fcs, residency="sampled")
    for per_col, group in fwd.stream_column_groups(sgcs):
        bwd.add_subgrid_group([[sg for _, sg in col] for col in per_col],
                              group)
    return np.asarray(bwd.finish())


def _spawn(tmp_path, inputs, ranks, shards, modes):
    """Start `ranks` rank processes of `shards` shards each through a
    file:// rendezvous, each running the round trips of `modes`, and
    beside them the single-process mesh over as many shards (a process a
    mode); a function that waits for them
    all and returns (the ranks' outputs in rank order, the
    single-process mesh's), so that the caller computes the JAX
    reference meanwhile."""
    rdv = tmp_path / "rendezvous"
    jobs = [(f"rank{r}", shards, ",".join(modes),
             dict(SWIFTLY_COORDINATOR=f"file://{rdv}",
                  SWIFTLY_NUM_PROCESSES=str(ranks),
                  SWIFTLY_PROCESS_ID=str(r)))
            for r in range(ranks)]
    jobs += [(f"single_{m}", ranks * shards, m, {}) for m in modes]
    procs, outs = [], []
    for name, n, mode_list, knobs in jobs:
        env = {k: v for k, v in os.environ.items() if k not in KNOBS}
        env.update(knobs, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        out = tmp_path / f"{name}.npz"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, inputs, str(out), str(n), mode_list],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))

    def wait():
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for (name, *_), p, log in zip(jobs, procs, logs):
            assert p.returncode == 0, f"{name} failed:\n{log[-3000:]}"
        res = [dict(np.load(o)) for o in outs]
        return res[:ranks], {k: v for r in res[ranks:] for k, v in r.items()}

    return wait


def _rms(a, b):
    return float(np.sqrt(np.mean(np.abs(a - b) ** 2)))


def _check_ranks(wait, shards, inputs, modes):
    jax_facets = _jax_single_device(inputs)
    truth = np.load(inputs)["facets"]
    outs, ref = wait()
    for mode in modes:
        ref_groups = ref[f"{mode}_groups"]
        ref_facets = ref[f"{mode}_facets"]
        n_facets = ref_facets.shape[0]
        per = -(-n_facets // (len(outs) * shards)) * shards  # a rank's
        held = np.zeros_like(ref_facets)
        for r, out in enumerate(outs):
            assert np.array_equal(out[f"{mode}_groups"], ref_groups), (
                mode, r)
            facets = out[f"{mode}_facets"]
            assert facets.shape == ref_facets.shape
            mine = np.zeros(n_facets, bool)
            mine[out[f"{mode}_rows"]] = True
            if mode != "elastic":  # the mesh the pass started on
                assert np.array_equal(
                    np.flatnonzero(mine),
                    np.arange(r * per, min((r + 1) * per, n_facets)))
            assert np.array_equal(facets[mine], ref_facets[mine]), (
                mode, r)
            assert not facets[~mine].any(), (mode, r)
            held += facets
        assert np.array_equal(held, ref_facets)
        assert _rms(held, jax_facets) < RMS_BOUND
        assert _rms(held[..., 0] + 1j * held[..., 1], truth) < RMS_BOUND


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return _inputs(str(tmp_path_factory.mktemp("multiproc_inputs")))


def test_two_ranks_of_two_shards_match_the_single_process_mesh(tmp_path,
                                                               inputs):
    """2 ranks x 2 CPU shards over gloo, the mesh-streamed engines:
    bit-equal to the single-process 4-shard mesh under psum and ring;
    the JAX package's f64 bounds."""
    modes = ("psum", "ring")
    _check_ranks(_spawn(tmp_path, inputs, 2, 2, modes), 2, inputs, modes)


def test_two_ranks_api_and_checkpoint_match_the_single_process_mesh(
        tmp_path, inputs):
    """2 ranks x 2 CPU shards over gloo: the API's mesh branches
    (`SwiftlyForward`, `backward_all`) and a streamed backward saved after
    its first group and restored on each rank, bit-equal to the
    single-process 4-shard mesh's; the JAX package's f64 bounds."""
    modes = ("api", "ckpt")
    _check_ranks(_spawn(tmp_path, inputs, 2, 2, modes), 2, inputs, modes)


def test_two_ranks_survive_a_lost_shard_like_the_single_process_mesh(
        tmp_path, inputs):
    """2 ranks x 2 CPU shards over gloo: `run_elastic_pass` loses shard 0
    at the second group, re-plans onto shards (0, 1, 1), and the
    autosave's restore moves facets 3-5 from rank 0 to rank 1; each
    rank's facets bit-equal to the single-process 4-shard mesh's elastic
    pass (the other rows zero), each rank's autosave a file of its own;
    the JAX package's f64 bounds."""
    modes = ("elastic",)
    _check_ranks(_spawn(tmp_path, inputs, 2, 2, modes), 2, inputs, modes)


@pytest.mark.slow
def test_three_ranks_of_one_shard_match_the_single_process_mesh(tmp_path,
                                                                inputs):
    """3 ranks x 1 CPU shard (a rank a shard, as chip_smoke's phase 17
    runs on one card), every mode: bit-equal to the single-process
    3-shard mesh."""
    modes = ("psum", "ring", "api", "ckpt")
    _check_ranks(_spawn(tmp_path, inputs, 3, 1, modes), 1, inputs, modes)


@pytest.mark.slow
def test_dryrun_distributed_two_process_bootstrap(tmp_path):
    """A real 2-process bootstrap through `bootstrap_from_env` at a TCP
    coordinator: both children join, agree on the world size, and span
    one mesh over both (the twin of the JAX package's
    ``dryrun_distributed``)."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    code = (
        "import torch.distributed as dist\n"
        "from swiftly_tpu_torch.parallel.mesh import "
        "bootstrap_from_env, make_facet_mesh\n"
        "info = bootstrap_from_env()\n"
        "assert info is not None and dist.get_world_size() == 2, info\n"
        "mesh = make_facet_mesh(devices=['cpu'])\n"
        "assert len(mesh) == 2 and mesh.backend == 'gloo', mesh\n"
        "print('distributed bootstrap OK', dist.get_rank(), mesh)\n"
        "dist.destroy_process_group()\n")
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT),
                   SWIFTLY_COORDINATOR=f"127.0.0.1:{port}",
                   SWIFTLY_NUM_PROCESSES="2", SWIFTLY_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {r}: {log[-2000:]}"
        assert "distributed bootstrap OK" in log
