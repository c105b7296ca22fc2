"""The port's checkpoints (``swiftly_tpu_torch.utils.checkpoint``) and the
streamed backward's autosave, held to the JAX package's cases
(``tests/test_demo_checkpoint.py:64-300``, ``tests/test_utils.py:38-220``)
at their 1k f64 config.

Port vs JAX package: a killed and resumed run gives the JAX package's
uninterrupted facets within 1e-10; at a point with no pending fold rows
the port's snapshot arrays (``acc``, ``naf_*``) are the JAX package's
within 1e-12 relative. The port's own contract: a kill and resume is
bit-equal to the uninterrupted port run, also where ``processed`` is no
multiple of ``fold_group`` (the snapshot then carries the pending fold
rows). The failure modes: truncated, checksum fallback, all corrupt,
legacy version, v1, cross-kind, kill during save, mismatched config, and
the refusals (a mesh snapshot, another row slab or residency).

Torch runs on one intra-op thread; the uninterrupted runs are computed
once per module.
"""

import functools
import json
import zipfile
import zlib

import numpy as np
import pytest
import torch

import swiftly_tpu_torch as T
from swiftly_tpu_torch.resilience import FaultPlan, WorkerKilled, faults
from swiftly_tpu_torch.resilience.faults import corrupt_file
from swiftly_tpu_torch.utils import checkpoint as tck
from swiftly_tpu_torch.utils.checkpoint import (
    CorruptCheckpointError,
    checkpoint_generations,
    restore_backward_state,
    restore_streamed_backward_state,
    save_backward_state,
    save_streamed_backward_state,
    verify_checkpoint,
)

PARAMS = {
    "W": 13.5625,
    "fov": 1.0,
    "N": 1024,
    "yB_size": 416,
    "yN_size": 512,
    "xA_size": 228,
    "xM_size": 256,
}
SOURCES = [(1, 1, 0), (0.5, -30, 40)]
# tests/test_obs.py:256's streamed config, for the cases whose point is the
# control flow (5 columns of 5 subgrids, 9 facets)
SMALL = {"W": 8.0, "fov": 1.0, "N": 256, "yB_size": 96, "yN_size": 128,
         "xA_size": 56, "xM_size": 64}
SMALL_SOURCES = [(1.0, 3, -5)]
CONFIGS = {"1k": (PARAMS, SOURCES), "small": (SMALL, SMALL_SOURCES)}
TWINS = {"planar": ("planar", torch.float64), "torch": ("jax", torch.complex128)}


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


@functools.cache
def _jax_setup(backend, size="small"):
    import swiftly_tpu as J

    params, sources = CONFIGS[size]
    config = J.SwiftlyConfig(backend=backend, **params)
    fcs = J.make_full_facet_cover(config)
    sgcs = J.make_full_subgrid_cover(config)
    tasks = [(fc, J.make_facet(config.image_size, fc, sources)) for fc in fcs]
    return config, fcs, sgcs, tasks


@functools.cache
def _setup(backend="planar", size="small"):
    jcore = _jax_setup(TWINS[backend][0], size)[0].core
    config = T.SwiftlyConfig.from_numpy_state(
        np.asarray(jcore._Fb), np.asarray(jcore._Fn), backend=backend,
        dtype=TWINS[backend][1], device="cpu", **CONFIGS[size][0])
    fcs = T.make_full_facet_cover(config)
    sgcs = T.make_full_subgrid_cover(config)
    tasks = [(fc, d) for fc, (_, d) in
             zip(fcs, _jax_setup(TWINS[backend][0], size)[3])]
    return config, fcs, sgcs, tasks


def _cols(sgcs):
    return list(dict.fromkeys(sg.off0 for sg in sgcs))


@functools.cache
def _jax_facets(size="small"):
    """The JAX package's uninterrupted streamed round trip (planar,
    sampled), as complex host facets."""
    from swiftly_tpu.parallel import StreamedBackward, StreamedForward

    config, fcs, sgcs, tasks = _jax_setup("planar", size)
    fwd = StreamedForward(config, tasks, residency="device")
    bwd = StreamedBackward(config, fcs, residency="sampled")
    for per_col, group in fwd.stream_column_groups(sgcs):
        bwd.add_subgrid_group([[sg for _, sg in col] for col in per_col],
                              group)
    return np.asarray(config.core.as_complex(np.asarray(bwd.finish())))


def _feed_run(size, fold_group, ck=None, save_cols=0, kill_feed=None):
    """The port's streamed round trip through ``feed_backward_passes`` (one
    column a group), autosaving once after `save_cols` columns and killed
    at the `kill_feed`-th ``bwd.feed``; None when killed, else the facets.
    """
    config, fcs, sgcs, tasks = _setup("planar", size)
    fwd = T.StreamedForward(config, tasks, residency="device", col_group=1)
    bwd = T.StreamedBackward(config, fcs, residency="sampled",
                             fold_group=fold_group)
    if ck is not None and save_cols:
        S = len(sgcs) // len(_cols(sgcs))
        bwd.enable_autosave(ck, every_subgrids=save_cols * S)
    if kill_feed is None:
        T.feed_backward_passes(fwd, sgcs, [bwd])
        return bwd.finish()
    with faults.active(FaultPlan([{"site": "bwd.feed", "kind": "kill",
                                   "at": kill_feed}])):
        with pytest.raises(WorkerKilled):
            T.feed_backward_passes(fwd, sgcs, [bwd])
    return None


@functools.cache
def _uninterrupted(size, fold_group):
    return _feed_run(size, fold_group)


def _resume(size, ck, fold_group):
    """A fresh forward and backward: restore, feed the rest in order."""
    config, fcs, sgcs, tasks = _setup("planar", size)
    fwd = T.StreamedForward(config, tasks, residency="device", col_group=1)
    bwd = T.StreamedBackward(config, fcs, residency="sampled",
                             fold_group=fold_group)
    processed = set(restore_streamed_backward_state(ck, bwd))
    pending = [o for o, _ in bwd._pending_rows]
    rest = [sg for sg in sgcs if (sg.off0, sg.off1) not in processed]
    T.feed_backward_passes(fwd, rest, [bwd])
    return bwd.finish(), processed, pending, rest


# ---------------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size, save_cols, fold_group", [
    ("1k", 2, 3),  # two columns pending in the snapshot
    ("small", 3, 3),  # processed a multiple of fold_group: none pending
    ("small", 3, 2),  # one column pending
    ("small", 1, 4),  # killed before any fold: only pending rows
], ids=["1k-two-pending", "aligned", "one-pending", "no-fold-yet"])
def test_kill_and_resume_through_the_feed_is_bit_identical(
        tmp_path, size, save_cols, fold_group):
    """Autosave at a group boundary, a kill at the next ``bwd.feed``, a
    resume by a fresh forward and backward: the uninterrupted port run's
    bits, the pending columns carried in the snapshot, and the JAX
    package's facets within 1e-10."""
    config, fcs, sgcs, _ = _setup("planar", size)
    ck = tmp_path / "bwd.npz"
    assert _feed_run(size, fold_group, ck, save_cols,
                     kill_feed=save_cols) is None
    assert checkpoint_generations(ck) == [str(ck)]
    out, processed, pending, rest = _resume(size, ck, fold_group)
    cols = _cols(sgcs)
    assert pending == cols[save_cols - save_cols % fold_group:save_cols]
    assert len(_cols(rest)) == len(cols) - save_cols
    assert processed == {(sg.off0, sg.off1) for sg in sgcs
                         if sg.off0 in cols[:save_cols]}
    ref = _uninterrupted(size, fold_group)
    np.testing.assert_array_equal(out, ref)
    got = config.core.as_complex(out)
    np.testing.assert_allclose(got, _jax_facets(size), rtol=0, atol=1e-10)


def _column_loop(fwd, bwd, sgcs, ck=None, every=1, on_column=None):
    """``scripts/demo_api.py``'s ``run_streamed_with_checkpoint`` on the
    port: fold each forward column, snapshot every `every` columns, resume
    from the snapshot if one exists, skipping the folded columns."""
    processed = set()
    if ck is not None and ck.exists():
        processed = {tuple(p) for p in restore_streamed_backward_state(ck,
                                                                       bwd)}
    since = 0
    for items, subgrids in fwd.stream_columns(sgcs, device_arrays=True):
        keys = [(sg.off0, sg.off1) for _, sg in items]
        if processed and all(k in processed for k in keys):
            continue
        bwd.add_subgrid_stack([sg for _, sg in items], subgrids[:len(items)])
        processed.update(keys)
        since += 1
        if on_column is not None:
            on_column(items)
        if ck is not None and since >= every:
            save_streamed_backward_state(ck, bwd, sorted(processed))
            since = 0
    return bwd.finish()


class _Killed(RuntimeError):
    pass


@pytest.mark.parametrize("residency", ["sampled", "host"])
def test_kill_and_resume_matches_uninterrupted(tmp_path, residency):
    """tests/test_demo_checkpoint.py:57: killed after two columns (a
    snapshot every column), resumed without refolding them; the same bits
    as the uninterrupted port run, the JAX package's within 1e-10."""
    config, fcs, sgcs, tasks = _setup()
    fold_group = 2

    def executors():
        return (T.StreamedForward(config, tasks, residency="device"),
                T.StreamedBackward(config, fcs, residency=residency,
                                   fold_group=fold_group))

    ref = _column_loop(*executors(), sgcs)
    ck = tmp_path / "bwd.npz"
    count = {"n": 0}

    def killer(items):
        count["n"] += 1
        if count["n"] == 3:
            raise _Killed()

    with pytest.raises(_Killed):
        _column_loop(*executors(), sgcs, ck=ck, on_column=killer)
    folded = {"cols": 0}
    out = _column_loop(*executors(), sgcs, ck=ck,
                       on_column=lambda items: folded.__setitem__(
                           "cols", folded["cols"] + 1))
    assert folded["cols"] == len(_cols(sgcs)) - 2
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(config.core.as_complex(out), _jax_facets(),
                               rtol=0, atol=1e-10)


def test_snapshot_arrays_match_the_jax_packages(tmp_path):
    """With no pending rows (fold_group 1), the port's sampled snapshot
    holds the JAX package's accumulator, and the host residency's the JAX
    package's column rows, within 1e-12 relative."""
    from swiftly_tpu.parallel import StreamedBackward as JB
    from swiftly_tpu.parallel import StreamedForward as JF
    from swiftly_tpu.utils.checkpoint import (
        save_streamed_backward_state as jsave,
    )

    def arrays(path):
        with np.load(path) as data:
            return {k: data[k] for k in data.files
                    if k not in ("meta", "meta_crc")}

    for backend, residency in (("planar", "sampled"), ("torch", "host")):
        config, fcs, sgcs, tasks = _setup(backend)
        jconfig, jfcs, jsgcs, jtasks = _jax_setup(TWINS[backend][0])
        yB = fcs[0].size
        fb = config.core._p.extract_mid(config.core._Fb, yB, 0).numpy()
        half = _cols(sgcs)[:3]
        port = T.StreamedBackward(config, fcs, residency=residency,
                                  fold_group=1, col_block=yB)
        fwd = T.StreamedForward(config, tasks, residency="device")
        for items, sub in fwd.stream_columns(sgcs, device_arrays=True):
            if items[0][1].off0 in half:
                port.add_subgrid_stack([sg for _, sg in items],
                                       sub[:len(items)])
        jbwd = JB(jconfig, jfcs, residency=residency, fold_group=1,
                  col_block=yB)
        for items, sub in JF(jconfig, jtasks, col_block=yB).stream_columns(
                jsgcs):
            if items[0][1].off0 in half:
                jbwd.add_subgrids([(sg, sub[s]) for s, (_, sg) in
                                   enumerate(items)])
        save_streamed_backward_state(tmp_path / "p.npz", port)
        jsave(tmp_path / "j.npz", jbwd)
        got, want = arrays(tmp_path / "p.npz"), arrays(tmp_path / "j.npz")
        assert set(got) == set(want) and got
        for name in want:
            g, w = got[name], want[name]
            if backend == "planar":  # (re, im) pairs: the port's layout
                g, w = g[..., 0] + 1j * g[..., 1], w[..., 0] + 1j * w[..., 1]
            # the window Fb weights the accumulator's rows and the rows'
            # columns (its edges amplify rounding: divided out)
            win = fb[None, :, None] * fb[None, None, :] if name == "acc" \
                else fb[None, None, :]
            g, w = g / win, w / win
            assert np.abs(g - w).max() <= 1e-12 * np.abs(w).max(), name


# ---------------------------------------------------------------------------
# the failure modes (tests/test_demo_checkpoint.py:111-300)
# ---------------------------------------------------------------------------


def _saved_streamed(tmp_path, n_saves=1):
    """A real sampled snapshot (plus older generations)."""
    config, fcs, sgcs, tasks = _setup()
    fwd = T.StreamedForward(config, tasks, residency="device")
    bwd = T.StreamedBackward(config, fcs, residency="sampled", fold_group=1)
    ck = tmp_path / "bwd.npz"
    done = []
    for k, (items, sub) in enumerate(fwd.stream_columns(
            sgcs, device_arrays=True)):
        bwd.add_subgrid_stack([sg for _, sg in items], sub[:len(items)])
        done.extend((sg.off0, sg.off1) for _, sg in items)
        if k < n_saves:
            save_streamed_backward_state(ck, bwd, sorted(done))
    return config, fcs, ck


def test_truncated_checkpoint_raises_corrupt(tmp_path):
    config, fcs, ck = _saved_streamed(tmp_path)
    blob = ck.read_bytes()
    ck.write_bytes(blob[: len(blob) // 2])
    assert verify_checkpoint(ck) != []
    bwd = T.StreamedBackward(config, fcs, residency="sampled")
    with pytest.raises(CorruptCheckpointError):
        restore_streamed_backward_state(ck, bwd)
    assert bwd._acc is None  # a corrupt generation leaves it untouched


def test_checksum_mismatch_falls_back_to_previous_generation(tmp_path):
    from swiftly_tpu_torch.resilience import degrade

    degrade.reset()
    config, fcs, ck = _saved_streamed(tmp_path, n_saves=2)
    assert len(checkpoint_generations(ck)) == 2
    corrupt_file(str(ck))
    assert verify_checkpoint(ck) != []
    bwd = T.StreamedBackward(config, fcs, residency="sampled")
    processed = restore_streamed_backward_state(ck, bwd)
    S = len(processed)
    assert S == len(T.make_full_subgrid_cover(config)) // len(_cols(
        T.make_full_subgrid_cover(config)))  # the first column's
    assert bwd.processed == processed
    assert [e["action"] for e in degrade.events()] == ["fallback_generation"]
    degrade.reset()


def test_all_generations_corrupt_raises(tmp_path):
    config, fcs, ck = _saved_streamed(tmp_path, n_saves=2)
    for gen in checkpoint_generations(ck):
        corrupt_file(gen)
    bwd = T.StreamedBackward(config, fcs, residency="sampled")
    with pytest.raises(CorruptCheckpointError, match="generation"):
        restore_streamed_backward_state(ck, bwd)


def _rewrite_meta(ck, mutate):
    """Re-write the snapshot with a mutated meta (valid CRCs)."""
    with np.load(ck) as data:
        arrays = {name: data[name] for name in data.files
                  if name not in ("meta", "meta_crc")}
        meta = json.loads(bytes(data["meta"].tobytes()).decode())
    mutate(meta)
    meta_bytes = json.dumps(meta).encode()
    arrays["meta"] = np.frombuffer(meta_bytes, dtype=np.uint8)
    arrays["meta_crc"] = np.asarray([zlib.crc32(meta_bytes)], dtype=np.uint32)
    with open(ck, "wb") as fh:
        np.savez(fh, **arrays)


def test_legacy_version_rejected_loudly(tmp_path):
    config, fcs, ck = _saved_streamed(tmp_path)
    _rewrite_meta(ck, lambda m: m.update(version=99))
    bwd = T.StreamedBackward(config, fcs, residency="sampled")
    with pytest.raises(ValueError, match="Unsupported checkpoint version"):
        restore_streamed_backward_state(ck, bwd)


def test_v1_snapshot_without_checksums_still_restores(tmp_path):
    config, fcs, ck = _saved_streamed(tmp_path)

    def to_v1(meta):
        meta["version"] = 1
        meta.pop("crc", None)

    _rewrite_meta(ck, to_v1)
    assert verify_checkpoint(ck) == []
    bwd = T.StreamedBackward(config, fcs, residency="sampled")
    processed = restore_streamed_backward_state(ck, bwd)
    assert processed and bwd._acc is not None


@pytest.mark.parametrize("change, match", [
    (lambda m: m.update(mesh={"n_devices": 2, "facet_shards": 2,
                              "axis": "facets"}), "A8"),
    (lambda m: m.update(row_slab=[0, 100]), "row_slab"),
    (lambda m: m.update(residency="host"), "residency"),
    (lambda m: m.update(backend="torch"), "backend"),
])
def test_snapshots_of_another_session_are_refused(tmp_path, change, match):
    """A snapshot of a device mesh (the port has none yet: ROADMAP A8),
    another row slab, residency or backend raises a clear ValueError and
    is not skipped as a corrupt generation."""
    config, fcs, ck = _saved_streamed(tmp_path)
    _rewrite_meta(ck, change)
    bwd = T.StreamedBackward(config, fcs, residency="sampled")
    with pytest.raises(ValueError, match=match) as err:
        restore_streamed_backward_state(ck, bwd)
    assert not isinstance(err.value, CorruptCheckpointError)


def test_cross_kind_restore_rejected(tmp_path):
    config, fcs, ck = _saved_streamed(tmp_path)
    bwd = T.SwiftlyBackward(config, fcs, 1, 10)
    with pytest.raises(ValueError, match="streamed_backward"):
        restore_backward_state(ck, bwd)
    ck2 = tmp_path / "plain.npz"
    save_backward_state(ck2, bwd, [])
    sbwd = T.StreamedBackward(config, fcs, residency="sampled")
    with pytest.raises(ValueError, match="backward"):
        restore_streamed_backward_state(ck2, sbwd)


def test_checkpoint_file_is_valid_zip_after_kill_during_save(tmp_path):
    config, fcs, ck = _saved_streamed(tmp_path)
    good = ck.read_bytes()
    bwd2 = T.StreamedBackward(config, fcs, residency="sampled")
    restore_streamed_backward_state(ck, bwd2)
    plan = FaultPlan(faults=[{"site": "checkpoint.save", "kind": "kill",
                              "at": 0}])
    with faults.active(plan):
        with pytest.raises(WorkerKilled):
            save_streamed_backward_state(ck, bwd2, bwd2.processed)
    assert ck.read_bytes() == good
    assert verify_checkpoint(ck) == []
    assert zipfile.is_zipfile(ck)


def test_transient_save_and_restore_faults_retry(tmp_path, monkeypatch):
    """``checkpoint.save`` / ``checkpoint.restore`` retry a transient I/O
    error; ``SWIFTLY_CKPT_KEEP`` bounds the generations."""
    monkeypatch.setenv("SWIFTLY_CKPT_KEEP", "2")
    config, fcs, ck = _saved_streamed(tmp_path, n_saves=3)
    assert len(checkpoint_generations(ck)) == 2
    bwd = T.StreamedBackward(config, fcs, residency="sampled")
    restore_streamed_backward_state(ck, bwd)
    plan = FaultPlan(faults=[
        {"site": "checkpoint.save", "kind": "ioerror", "at": 0},
        {"site": "checkpoint.restore", "kind": "ioerror", "at": 0}])
    with faults.active(plan):
        save_streamed_backward_state(ck, bwd)
        again = T.StreamedBackward(config, fcs, residency="sampled")
        restore_streamed_backward_state(ck, again)
    assert plan.stats()["by_site"] == {"checkpoint.save": 1,
                                       "checkpoint.restore": 1}
    assert torch.equal(again._acc, bwd._acc)
    monkeypatch.setenv("SWIFTLY_CKPT_KEEP", "1")
    save_streamed_backward_state(ck, bwd)
    assert tck.ckpt_keep() == 1


# ---------------------------------------------------------------------------
# tests/test_utils.py:38-220
# ---------------------------------------------------------------------------


def test_checkpoint_resume_mid_stream(tmp_path):
    """A SwiftlyBackward killed half way, snapshotted, restored into a new
    session and finished: the uninterrupted run's facets (1e-13) and the
    oracle's (3e-10)."""
    config, fcs, sgcs, tasks = _setup("torch", "1k")
    fwd = T.SwiftlyForward(config, tasks, 2, 50)
    subgrids = {(sg.off0, sg.off1): fwd.get_subgrid_task(sg) for sg in sgcs}
    ref = T.SwiftlyBackward(config, fcs, 2, 50)
    for sg in sgcs:
        ref.add_new_subgrid_task(sg, subgrids[(sg.off0, sg.off1)])
    facets_ref = np.asarray(ref.finish().cpu())
    half = len(sgcs) // 2
    bwd1 = T.SwiftlyBackward(config, fcs, 2, 50)
    done = []
    for sg in sgcs[:half]:
        bwd1.add_new_subgrid_task(sg, subgrids[(sg.off0, sg.off1)])
        done.append((sg.off0, sg.off1))
    ck = tmp_path / "bwd.npz"
    save_backward_state(ck, bwd1, done)
    bwd2 = T.SwiftlyBackward(config, fcs, 2, 50)
    processed = restore_backward_state(ck, bwd2)
    assert set(processed) == set(done)
    for sg in sgcs:
        if (sg.off0, sg.off1) not in set(processed):
            bwd2.add_new_subgrid_task(sg, subgrids[(sg.off0, sg.off1)])
    facets = np.asarray(bwd2.finish().cpu())
    np.testing.assert_allclose(facets, facets_ref, atol=1e-13)
    assert max(T.check_facet(config.image_size, fc, facets[i], SOURCES)
               for i, fc in enumerate(fcs)) < 3e-10


def test_checkpoint_rejects_mismatched_config(tmp_path):
    config, fcs, _, _ = _setup("torch")
    bwd = T.SwiftlyBackward(config, fcs, 1, 10)
    ck = tmp_path / "bwd.npz"
    save_backward_state(ck, bwd, [])
    other = T.SwiftlyConfig(backend="numpy", **SMALL)
    with pytest.raises(ValueError):
        restore_backward_state(ck, T.SwiftlyBackward(
            other, T.make_full_facet_cover(other), 1, 10))


@pytest.mark.parametrize("residency", ["host", "device"])
def test_streamed_checkpoint_resume_mid_stream(tmp_path, residency):
    config, fcs, sgcs, tasks = _setup("torch")
    fwd = T.StreamedForward(config, tasks, residency=residency)
    columns = [(items, sub.clone()) for items, sub in
               fwd.stream_columns(sgcs, device_arrays=True)]

    def feed(bwd, cols):
        for items, sub in cols:
            bwd.add_subgrid_stack([sg for _, sg in items], sub[:len(items)])

    ref = T.StreamedBackward(config, fcs, residency=residency)
    feed(ref, columns)
    facets_ref = ref.finish()
    half = len(columns) // 2
    bwd1 = T.StreamedBackward(config, fcs, residency=residency)
    feed(bwd1, columns[:half])
    done = [(sg.off0, sg.off1) for items, _ in columns[:half]
            for _, sg in items]
    ck = tmp_path / "streamed_bwd.npz"
    save_streamed_backward_state(ck, bwd1, done)
    bwd2 = T.StreamedBackward(config, fcs, residency=residency)
    assert set(restore_streamed_backward_state(ck, bwd2)) == set(done)
    feed(bwd2, columns[half:])
    np.testing.assert_array_equal(bwd2.finish(), facets_ref)


def test_streamed_checkpoint_rejects_mismatch(tmp_path):
    config, fcs, _, _ = _setup("torch")
    bwd = T.StreamedBackward(config, fcs)
    bwd._naf[0] = torch.zeros((len(bwd.stack), config.core.xM_yN_size,
                               bwd._base._yB_pad), dtype=torch.complex128)
    ck = tmp_path / "bad.npz"
    save_streamed_backward_state(ck, bwd)
    other = T.SwiftlyConfig(backend="torch", dtype=torch.complex128,
                            device="cpu", **{**SMALL, "W": 7.0})
    with pytest.raises(ValueError):
        restore_streamed_backward_state(
            ck, T.StreamedBackward(other, T.make_full_facet_cover(other)))


def test_streamed_checkpoint_rejects_col_block_mismatch(tmp_path):
    config, fcs, _, _ = _setup("torch")
    bwd = T.StreamedBackward(config, fcs, col_block=512)
    bwd._naf[0] = torch.zeros((len(bwd.stack), config.core.xM_yN_size,
                               bwd._base._yB_pad), dtype=torch.complex128)
    ck = tmp_path / "cb.npz"
    save_streamed_backward_state(ck, bwd)
    bwd2 = T.StreamedBackward(config, fcs, col_block=100)
    with pytest.raises(ValueError, match="col_block"):
        restore_streamed_backward_state(ck, bwd2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex128])
def test_device_copies_are_exact(dtype):
    """The snapshot's host and device copies (pinned chunks on the card;
    plain copies here) return the same bits."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 7), generator=g).to(dtype)
    host = tck._to_host(x)
    assert isinstance(host, np.ndarray)
    back = tck._to_device(host, "cpu")
    assert torch.equal(back, x) and back.data_ptr() != x.data_ptr()
