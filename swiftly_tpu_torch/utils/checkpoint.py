"""Checkpoint and resume for the backward sessions, hardened.

The port of the JAX package's ``swiftly_tpu/utils/checkpoint.py``. A
backward session is a long-running accumulation; its state is (a) the
accumulators, (b) for ``SwiftlyBackward`` the live column accumulators in
its LRU, and (c) which subgrids have been folded in. This module
snapshots that state to one ``.npz`` so a killed run resumes without
folding the finished subgrids again. The layout and the meta keys are the
JAX package's, with the port's backend names (``"torch"``, ``"planar"``,
``"numpy"``): arrays go to the host as numpy (planar arrays keep their
trailing (re, im) axis), and a restore places them back on the
backward's device.

Durability:

* **Atomic writes.** Every snapshot lands via tmp + ``fsync`` +
  ``os.replace``: a crash mid-save can truncate only the tmp file, never
  the live checkpoint.
* **Per-array CRC32.** Each array's checksum is stored in the meta and
  verified on restore; silent disk corruption raises
  :class:`CorruptCheckpointError` instead of folding garbage.
* **Keep-N generations.** Saves rotate ``path`` -> ``path.1`` -> ...
  (``SWIFTLY_CKPT_KEEP`` in all, default 3); restore falls back
  generation by generation past corrupt or truncated snapshots (counted
  as ``ckpt.fallbacks`` and recorded in the degradation ledger).
* **Fault sites.** ``checkpoint.save`` / ``checkpoint.save.done`` /
  ``checkpoint.restore`` are `resilience.faults` hook points; the save's
  write and each generation's read retry transient I/O errors
  (`resilience.retry.retry_transient`).
* **Observability.** The ``ckpt.save`` / ``ckpt.restore`` stages (with
  the bytes written) double as trace spans when `obs.trace` is on.

**Device copies.** At 32k a sampled backward's accumulator is ~9 GB; a
pageable ``.cpu()`` of that much is slow, so device arrays go to the host
and back through two pinned chunk buffers (`_to_host`, `_to_device`), in
the order of the device's current stream (no synchronisation beyond the
chunks' own events).

**The port's sampled backward saves its pending fold rows.** The JAX
package's sampled backward folds each column group's columns before the
next group arrives, and its save folds the pending rows first. The
port's folds take ``fold_group`` columns over the whole feed (a group's
last columns short of a fold wait for the next group's), so folding them
at a save would change the fold grouping, and a run with autosave would
lose the bits of a run without it. Its snapshot therefore holds the
pending columns' rows as extra arrays (``pending_<k>``, their column
offsets in the meta's ``pending_offs``), and a restore puts them back
into the backward's pending list: a resumed run folds exactly the
columns, in exactly the groups, of an undisturbed run. This is the one
place where the port's snapshot holds more than the JAX package's.

Config-mismatch errors (wrong params, backend, kind or version) are not
retried against older generations: every generation was written by the
same session, so a mismatch is a caller's bug and surfaces loudly. A
snapshot whose ``mesh`` records more than one device is refused: the
port has no mesh yet (ROADMAP A8).
"""

from __future__ import annotations

import json
import logging
import os
import zlib

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..resilience import degrade as _degrade
from ..resilience.faults import fault_point
from ..resilience.retry import retry_transient

__all__ = [
    "CorruptCheckpointError",
    "checkpoint_generations",
    "ckpt_keep",
    "restore_backward_state",
    "restore_streamed_backward_state",
    "save_backward_state",
    "save_streamed_backward_state",
    "verify_checkpoint",
]

logger = logging.getLogger(__name__)

# v2 adds per-array CRC32 checksums to the meta; v1 snapshots (no
# checksums) still restore, with integrity verification skipped.
_VERSION = 2
_SUPPORTED_VERSIONS = (1, 2)

# bytes of each of the two pinned buffers device copies are staged through
_STAGE_BYTES = 256 * 2**20


class CorruptCheckpointError(ValueError):
    """The snapshot file is unreadable or fails integrity verification
    (truncated archive, bad CRC, undecodable meta). Restore treats this
    as a damaged generation and falls back; config mismatches raise plain
    ``ValueError`` and do not."""


def ckpt_keep(default=3):
    """Total checkpoint generations kept (``SWIFTLY_CKPT_KEEP``, >= 1)."""
    try:
        return max(1, int(os.environ.get("SWIFTLY_CKPT_KEEP", default)))
    except ValueError:
        return default


def checkpoint_generations(path):
    """Existing generation files for `path`, newest first."""
    path = str(path)
    out = [path] if os.path.exists(path) else []
    k = 1
    while os.path.exists(f"{path}.{k}"):
        out.append(f"{path}.{k}")
        k += 1
    return out


def _crc(arr) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).view(np.uint8).data)


# -- device <-> host copies ----------------------------------------------------


def _pinned_pair(dtype, n):
    step = max(1, min(n, _STAGE_BYTES // torch.empty((), dtype=dtype)
                      .element_size()))
    return step, [torch.empty(step, dtype=dtype, pin_memory=True)
                  for _ in range(2)]


def _to_host(x):
    """A host numpy array of `x` (a tensor on any device, or an array).
    CUDA tensors copy through two pinned chunk buffers on the current
    stream, double-buffered: a chunk's device copy runs while the host
    copies the other buffer out."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach()
    if x.device.type != "cuda":
        return x.resolve_conj().contiguous().numpy()
    src = x.contiguous().view(-1)
    host = torch.empty(x.shape, dtype=x.dtype)
    dst = host.view(-1)
    n = src.numel()
    if n == 0:
        return host.numpy()
    step, bufs = _pinned_pair(x.dtype, n)
    stream = torch.cuda.current_stream(x.device)
    pending = None
    for i, c0 in enumerate(range(0, n, step)):
        k = min(step, n - c0)
        buf = bufs[i % 2][:k]
        buf.copy_(src[c0:c0 + k], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(stream)
        if pending is not None:
            pev, pbuf, pc0, pk = pending
            pev.synchronize()
            dst[pc0:pc0 + pk].copy_(pbuf)
        pending = (ev, buf, c0, k)
    pev, pbuf, pc0, pk = pending
    pev.synchronize()
    dst[pc0:pc0 + pk].copy_(pbuf)
    return host.numpy()


def _to_device(arr, device):
    """The host array `arr` as a new tensor on `device`: a private copy on
    the CPU; on the card, through two pinned chunk buffers on the current
    stream (a buffer is refilled once its previous copy has run)."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    device = torch.device(device)
    if device.type != "cuda":
        return src.clone().to(device)
    out = torch.empty(src.shape, dtype=src.dtype, device=device)
    s, o = src.view(-1), out.view(-1)
    n = s.numel()
    if n == 0:
        return out
    step, bufs = _pinned_pair(src.dtype, n)
    stream = torch.cuda.current_stream(device)
    events = [None, None]
    for i, c0 in enumerate(range(0, n, step)):
        k = min(step, n - c0)
        j = i % 2
        if events[j] is not None:
            events[j].synchronize()
        buf = bufs[j][:k]
        buf.copy_(s[c0:c0 + k])
        o[c0:c0 + k].copy_(buf, non_blocking=True)
        events[j] = torch.cuda.Event()
        events[j].record(stream)
    for ev in events:
        if ev is not None:
            ev.synchronize()  # the pinned buffers are freed on return
    return out


# -- the snapshot file ---------------------------------------------------------


def _rotate(path, keep):
    """Shift path -> path.1 -> ... -> path.(keep-1); the oldest drops."""
    if keep <= 1 or not os.path.exists(path):
        return
    for k in range(keep - 1, 0, -1):
        src = path if k == 1 else f"{path}.{k - 1}"
        dst = f"{path}.{k}"
        if os.path.exists(src):
            os.replace(src, dst)


def _atomic_savez(path, arrays, meta):
    """Checksummed meta + atomic tmp/fsync/rename write + rotation; the
    write retries transient I/O errors."""
    path = str(path)
    meta = dict(meta)
    meta["crc"] = {name: _crc(arr) for name, arr in arrays.items()}
    meta_bytes = json.dumps(meta).encode()
    arrays["meta"] = np.frombuffer(meta_bytes, dtype=np.uint8)
    # the meta's own integrity: a bit-flip inside the JSON could parse to
    # a silently different session description
    arrays["meta_crc"] = np.asarray([zlib.crc32(meta_bytes)], dtype=np.uint32)
    tmp = path + ".tmp"

    def write():
        fault_point("checkpoint.save", path)
        with _metrics.stage("ckpt.save") as st:
            with open(tmp, "wb") as fh:
                np.savez(fh, **arrays)
                fh.flush()
                os.fsync(fh.fileno())
            _rotate(path, ckpt_keep())
            os.replace(tmp, path)
            st.bytes_moved = int(os.path.getsize(path))

    retry_transient(write, site="checkpoint.save")
    _metrics.count("ckpt.saves")
    # post-landing hook: a "corrupt" fault flips a byte in the final file,
    # the generation the next restore must detect and skip
    fault_point("checkpoint.save.done", path)


def _open_verified(path):
    """np.load the snapshot and parse+verify its meta; any structural
    failure (torn zip, undecodable meta) -> CorruptCheckpointError."""
    try:
        data = np.load(path)
    except Exception as exc:
        raise CorruptCheckpointError(
            f"checkpoint {path!r} unreadable: {type(exc).__name__}: {exc}"
        ) from exc
    try:
        meta_bytes = bytes(data["meta"].tobytes())
        if "meta_crc" in data.files:
            want = int(data["meta_crc"][0])
            got = zlib.crc32(meta_bytes)
            if got != want:
                raise CorruptCheckpointError(
                    f"checkpoint {path!r} meta failed CRC32 verification "
                    f"(stored {want}, got {got})"
                )
        meta = json.loads(meta_bytes.decode())
    except CorruptCheckpointError:
        data.close()
        raise
    except Exception as exc:
        data.close()
        raise CorruptCheckpointError(
            f"checkpoint {path!r} meta undecodable: "
            f"{type(exc).__name__}: {exc}"
        ) from exc
    return data, meta


def _load_array(data, meta, name, path):
    """One array out of the snapshot, CRC-verified when the snapshot
    carries checksums (v2+)."""
    try:
        arr = data[name]
    except Exception as exc:
        raise CorruptCheckpointError(
            f"checkpoint {path!r} array {name!r} unreadable: "
            f"{type(exc).__name__}: {exc}"
        ) from exc
    want = (meta.get("crc") or {}).get(name)
    if want is not None and _crc(arr) != want:
        raise CorruptCheckpointError(
            f"checkpoint {path!r} array {name!r} failed CRC32 verification "
            f"(stored {want}, got {_crc(arr)})"
        )
    return arr


def verify_checkpoint(path):
    """Integrity problems with the snapshot at `path` (empty = good):
    reads every array and checks its CRC, the offline twin of what restore
    does."""
    problems = []
    try:
        data, meta = _open_verified(str(path))
    except CorruptCheckpointError as exc:
        return [str(exc)]
    with data:
        if meta.get("version") not in _SUPPORTED_VERSIONS:
            problems.append(f"unsupported version {meta.get('version')!r}")
        if meta.get("version", 0) >= 2 and "crc" not in meta:
            problems.append("v2 snapshot missing crc table")
        for name in data.files:
            if name == "meta":
                continue
            try:
                _load_array(data, meta, name, str(path))
            except CorruptCheckpointError as exc:
                problems.append(str(exc))
    return problems


def _restore_with_fallback(path, restore_one):
    """Run `restore_one(generation)` against path, then older generations,
    skipping corrupt snapshots (counted + recorded); each generation's
    read retries transient I/O errors."""
    gens = checkpoint_generations(path)
    if not gens:
        raise FileNotFoundError(f"no checkpoint at {path!r}")
    last_exc = None
    for k, gen in enumerate(gens):

        def one(gen=gen):
            fault_point("checkpoint.restore", gen)
            with _metrics.stage("ckpt.restore"):
                return restore_one(gen)

        try:
            out = retry_transient(one, site="checkpoint.restore")
        except CorruptCheckpointError as exc:
            last_exc = exc
            logger.warning("checkpoint generation %r: %s", gen, exc)
            continue
        if k:
            _metrics.count("ckpt.fallbacks", k)
            _degrade.record(
                "checkpoint", "fallback_generation",
                f"{path!r} generations 0..{k - 1} corrupt; restored {gen!r}",
            )
            logger.warning(
                "checkpoint %r corrupt; restored previous generation %r",
                path, gen,
            )
        _metrics.count("ckpt.restores")
        return out
    raise CorruptCheckpointError(
        f"all {len(gens)} checkpoint generation(s) of {path!r} are corrupt "
        f"(last: {last_exc})"
    ) from last_exc


def _params(core):
    return [core.W, core.N, core.xM_size, core.yN_size]


def _check_meta(meta, core, n_total, kind):
    if meta["version"] not in _SUPPORTED_VERSIONS:
        raise ValueError(f"Unsupported checkpoint version {meta['version']}")
    # legacy files (written before "kind" existed) default to "backward",
    # so a cross-kind restore fails loudly here
    if meta.get("kind", "backward") != kind:
        raise ValueError(
            f"Checkpoint holds {meta.get('kind')!r} state, expected {kind!r}"
        )
    expect = _params(core)
    if meta["params"] != expect or meta["backend"] != core.backend:
        raise ValueError(
            f"Checkpoint was written for params {meta['params']} backend "
            f"{meta['backend']!r}; this session has {expect} backend "
            f"{core.backend!r}"
        )
    if meta["n_total"] != n_total:
        raise ValueError("Facet stack size mismatch")
    n_devices = (meta.get("mesh") or {}).get("n_devices", 1)
    if n_devices != 1:
        raise ValueError(
            f"Checkpoint was written on a {n_devices}-device mesh; the port "
            "has no device meshes yet (ROADMAP A8) and restores "
            "single-device snapshots only"
        )


# -- SwiftlyBackward -----------------------------------------------------------


def _place(core, arr):
    """A restored array in `core`'s form: numpy for the numpy backend, else
    a tensor on its device."""
    if core.backend == "numpy":
        return np.array(arr)
    return _to_device(arr, core.device)


def save_backward_state(path, backward, processed_subgrids=None):
    """Snapshot a `SwiftlyBackward` session to `path` (.npz): atomic,
    checksummed, keep-N rotated.

    :param backward: the SwiftlyBackward instance
    :param processed_subgrids: optional list of (off0, off1) already folded
        in, stored for the caller to skip on resume
    """
    core = backward.core
    arrays = {}
    meta = {
        "version": _VERSION,
        "kind": "backward",
        "backend": core.backend,
        "params": _params(core),
        "n_real": backward.stack.n_real,
        "n_total": backward.stack.n_total,
        "lru_keys": [],
        "processed": list(map(list, processed_subgrids or [])),
        "has_mnaf": backward._MNAF_BMNAFs is not None,
    }
    if backward._MNAF_BMNAFs is not None:
        arrays["MNAF_BMNAFs"] = _to_host(backward._MNAF_BMNAFs)
    for key, col in backward.lru._store.items():
        meta["lru_keys"].append(int(key))
        arrays[f"lru_{int(key)}"] = _to_host(col)
    _atomic_savez(path, arrays, meta)


def restore_backward_state(path, backward):
    """Restore a snapshot into a freshly constructed `SwiftlyBackward`
    (built with the same config and facets as the one saved). Corrupt
    generations fall back to the previous good one. Returns the list of
    (off0, off1) subgrids already processed."""
    return _restore_with_fallback(
        path, lambda gen: _restore_backward_one(gen, backward)
    )


def _restore_backward_one(path, backward):
    data, meta = _open_verified(path)
    with data:
        core = backward.core
        _check_meta(meta, core, backward.stack.n_total, "backward")
        if meta["has_mnaf"]:
            backward._MNAF_BMNAFs = _place(
                core, _load_array(data, meta, "MNAF_BMNAFs", path))
        for key in meta["lru_keys"]:
            backward.lru.set(
                key, _place(core, _load_array(data, meta, f"lru_{key}", path))
            )
        return [tuple(p) for p in meta["processed"]]


# -- StreamedBackward ----------------------------------------------------------


def save_streamed_backward_state(path, backward, processed_subgrids=None):
    """Snapshot a `StreamedBackward` session to `path` (.npz): atomic,
    checksummed, keep-N rotated.

    The state: ``residency="sampled"``, the image-space accumulator and
    the pending fold rows (module docstring); ``"host"`` / ``"device"``,
    the per-column row accumulators [F, m, yB_pad(,2)]. Nothing is folded
    by the save.

    :param processed_subgrids: optional list of (off0, off1) already folded
        in, stored for the caller to skip on resume; default the
        backward's own ``processed`` ledger
    """
    core = backward.core
    base = backward._base
    if processed_subgrids is None:
        processed_subgrids = getattr(backward, "processed", None)
    arrays = {}
    meta = {
        "version": _VERSION,
        "kind": "streamed_backward",
        "backend": core.backend,
        "params": _params(core),
        "n_real": backward.stack.n_real,
        "n_total": backward.stack.n_total,
        "residency": base.residency,
        "yB_pad": base._yB_pad,
        "naf_keys": [],
        "processed": list(map(list, processed_subgrids or [])),
        "stream_version": int(getattr(backward, "stream_version", 0)),
        "mesh": None,  # one device (meshes: ROADMAP A8)
    }
    if base.residency == "sampled":
        meta["has_acc"] = backward._acc is not None
        slab = backward._row_slab
        meta["row_slab"] = list(slab) if slab else None
        if backward._acc is not None:
            arrays["acc"] = _to_host(backward._acc)
        meta["pending_offs"] = [int(o) for o, _ in backward._pending_rows]
        for k, (_, rows) in enumerate(backward._pending_rows):
            arrays[f"pending_{k}"] = _to_host(rows)
    for key, rows in backward._naf.items():
        meta["naf_keys"].append(int(key))
        arrays[f"naf_{int(key)}"] = _to_host(rows)
    _atomic_savez(path, arrays, meta)


def restore_streamed_backward_state(path, backward):
    """Restore a snapshot into a freshly constructed `StreamedBackward`
    (the same config, facets and residency; for the host and device
    residencies the same ``col_block``; for the sampled one the same
    ``row_slab``). Corrupt generations fall back to the previous good one.
    Returns the list of (off0, off1) subgrids already processed (also
    assigned to ``backward.processed``)."""
    return _restore_with_fallback(
        path, lambda gen: _restore_streamed_one(gen, backward)
    )


def _restore_streamed_one(path, backward):
    data, meta = _open_verified(path)
    with data:
        core = backward.core
        base = backward._base
        _check_meta(meta, core, backward.stack.n_total, "streamed_backward")
        saved_res = meta.get("residency")
        is_sampled = base.residency == "sampled"
        if (saved_res == "sampled") != is_sampled:
            raise ValueError(
                f"Checkpoint holds residency={saved_res!r} state; this "
                f"session uses {base.residency!r} (the sampled accumulator "
                "and the column rows are not interchangeable)"
            )
        processed = [tuple(p) for p in meta["processed"]]
        if is_sampled:
            saved_slab = meta.get("row_slab")
            have_slab = backward._row_slab
            if (saved_slab or None) != (list(have_slab) if have_slab
                                        else None):
                # a slab accumulator restored at another row window would
                # fold garbage silently: refuse
                raise ValueError(
                    f"Checkpoint holds row_slab={saved_slab} state; this "
                    f"session uses row_slab="
                    f"{list(have_slab) if have_slab else None}"
                )
            # load and check every array before touching the backward, so
            # a corrupt generation leaves it as it was
            acc = (_load_array(data, meta, "acc", path)
                   if meta.get("has_acc") else None)
            pending = [
                (int(off), _load_array(data, meta, f"pending_{k}", path))
                for k, off in enumerate(meta.get("pending_offs") or [])
            ]
            backward._acc = (None if acc is None
                             else _to_device(acc, core.device))
            del acc
            backward._pending_rows = [
                (off, _to_device(rows, core.device)) for off, rows in pending
            ]
            backward.processed = list(processed)
            return processed
        # older snapshots did not record yB_pad; the rows arrays carry it as
        # their last data axis either way
        saved_pad = meta.get("yB_pad")
        if saved_pad is None and meta["naf_keys"]:
            # rows are [F, m, yB_pad] (+ trailing planar pair axis)
            saved_pad = _load_array(
                data, meta, f"naf_{meta['naf_keys'][0]}", path
            ).shape[2]
        if saved_pad is not None and saved_pad != base._yB_pad:
            # rows are stored at the saving session's col_block padding; a
            # different padding would make finish() slice garbage
            raise ValueError(
                f"Checkpoint rows are padded to yB_pad={saved_pad} (col_block "
                f"of the saving session); this session uses {base._yB_pad}: "
                "construct StreamedBackward with the same col_block"
            )
        rows = {int(key): _load_array(data, meta, f"naf_{key}", path)
                for key in meta["naf_keys"]}
        device = base.residency == "device"
        backward._naf = {
            key: (_to_device(r, core.device) if device
                  else torch.from_numpy(np.array(r)))
            for key, r in rows.items()
        }
        backward.processed = list(processed)
        return processed
