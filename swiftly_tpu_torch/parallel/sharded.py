"""Facet-sharded execution: each shard's facets on its device, and one
explicit facet-axis sum per column.

The torch twin of the JAX package's ``swiftly_tpu/parallel/sharded.py``.
Where the JAX package maps a stage over the mesh with ``shard_map`` and
reduces with ``lax.psum`` (or a ``ppermute`` ring), the port loops over
the shards in one process: shard i runs the batched bodies
(`parallel.batched`) on its local facets with a copy of the core on its
device (`mesh.shard_core`), and the facet sum is `collective_sum` over
the shards' partials, the only cross-shard traffic.

Forward (`subgrids_from_columns_sharded`, `forward_all_sharded`):
  per shard: its facets' contributions to the column's subgrids, summed
             over its local facets -> a partial [S, xM, xM]
  collective: the partials summed over the shards, once per column
  then:      the finish (iFFT, crop, masks) on the first shard's device

Backward (`split_subgrid_sharded`, `split_accumulate_sharded`,
`backward_all_sharded`): the subgrids go to each shard's device and
every facet-side op is local to the shard: no collective.

The two schedules of the facet sum (``SWIFTLY_MESH_COLLECTIVE``,
`mesh.resolve_collective`):

* ``psum`` adds the shards' partials in shard order on the first shard's
  device, then copies the sum to each other distinct device of the mesh
  (one copy a device, not one a virtual shard), so a reader gets the
  same bits wherever it reads.
* ``ring`` is the JAX package's ``ring_allreduce`` step for step: the
  partials flattened and zero-padded into n chunks, n-1 reduce-scatter
  rotations and n-1 all-gather rotations, each rotation an explicit copy
  of one chunk a shard to the next shard's device (a copy even where the
  next shard shares the device). Every chunk is summed in ring order,
  starting at the shard that owns it, so the result is deterministic and
  repeatable, and differs from psum's only by the order of the sums.

On a mesh over processes (`parallel.mesh`) each rank runs only its own
shards, and the two schedules keep their single-process bits: psum's
partials reach shard 0's rank in shard order (one batch of point-to-point
sends and receives), are added there in shard order on shard 0's device,
and the sum is broadcast; the ring is the same algorithm, a rotation
between ranks one batch of sends and receives to the neighbours, a
rotation within a rank a copy. On a gloo mesh a CUDA tensor crosses
through a pinned host buffer (``mesh.staging`` totals the copies).

Each call of `collective_sum` is one ``metrics.stage`` named for its
schedule (``mesh.psum`` / ``mesh.ring_step``), with the all-reduce's
wire bytes (2(n-1) partial buffers, the ring accounting of
`utils.profiling.collective_bytes_forward`; the ring's own count, which
includes its chunk padding) and, on the card, its device time.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..obs import metrics as _metrics
from .batched import (
    _index,
    accumulate_column_batch,
    backward_all_batch,
    extract_columns_batch,
    facet_contrib_to_subgrid,
    finish_masked_subgrid,
    prepare_facets_batch,
    split_accumulate_batch,
    split_subgrid_batch,
)
from .mesh import (
    ShardedStack,
    mesh_size,
    resolve_collective,
    shard_core,
)

__all__ = [
    "backward_all_sharded",
    "collective_sum",
    "forward_all_sharded",
    "prepare_facets_sharded",
    "ring_allreduce",
    "split_accumulate_sharded",
    "split_subgrid_sharded",
    "subgrid_from_columns_sharded",
    "subgrids_from_columns_sharded",
]


def _nbytes(t):
    return t.numel() * t.element_size()


def _replicas(mesh, per_device):
    """A per-shard list (this rank's shards) from one tensor a distinct
    device."""
    return [per_device[d] for d in mesh.local_devices]


def _staged(mesh, t):
    """Whether `t` crosses ranks through a host buffer: a CUDA tensor on
    a gloo mesh (gloo's point-to-point sends read host memory: handed a
    CUDA tensor, they abort the process)."""
    return mesh.backend == "gloo" and t.device.type == "cuda"


def _wire(t):
    """The real view a tensor crosses ranks in."""
    return torch.view_as_real(t) if t.is_complex() else t


def _pinned(mesh, key, shape, dtype):
    """A pinned host buffer of the mesh's, kept for reuse under `key`:
    each is read or written only inside one collective call, which waits
    for its transfers and copies what it received out."""
    k = (key, tuple(shape), dtype)
    if k not in mesh.pinned:
        mesh.pinned[k] = torch.empty(shape, dtype=dtype, pin_memory=True)
    return mesh.pinned[k]


def _send_buffer(mesh, t, key):
    """`t` ready to send: a copy in the pinned buffer `key` when staged,
    else itself, contiguous."""
    if not _staged(mesh, t):
        return t.contiguous()
    torch.cuda.current_stream(t.device).synchronize()
    t0 = time.perf_counter()
    host = _pinned(mesh, key, t.shape, t.dtype)
    host.copy_(t)
    mesh.staging["seconds"] += time.perf_counter() - t0
    mesh.staging["d2h_bytes"] += _nbytes(t)
    return host


def _recv_buffer(mesh, like, device, key):
    """A buffer to receive a tensor shaped as `like` for `device`: the
    pinned host buffer `key` when staged, else a new one on the
    device."""
    if mesh.backend == "gloo" and device.type == "cuda":
        return _pinned(mesh, key, like.shape, like.dtype)
    return torch.empty(like.shape, dtype=like.dtype, device=device)


def _landed(mesh, buf, device):
    """A received buffer on `device` (its upload timed as staging)."""
    if buf.device == device:
        return buf
    t0 = time.perf_counter()
    out = buf.to(device)
    mesh.staging["seconds"] += time.perf_counter() - t0
    mesh.staging["h2d_bytes"] += _nbytes(buf)
    return out


def _exchange(mesh, ops):
    """Run point-to-point ``(kind, tensor, peer rank, tag)`` operations as
    one batch on the mesh's group and wait for them all."""
    import torch.distributed as dist

    if not ops:
        return
    p2p = [dist.P2POp(dist.isend if kind == "send" else dist.irecv,
                      _wire(t), peer, mesh.group, tag)
           for kind, t, peer, tag in ops]
    for work in dist.batch_isend_irecv(p2p):
        work.wait()


def _psum_across(parts, mesh):
    """`psum` over ranks: the partials of every shard reach shard 0's
    rank in shard order (one batch of sends and receives), are added
    there in shard order on shard 0's device, and the sum is broadcast;
    each rank keeps one copy a distinct device of its own."""
    import torch.distributed as dist

    n = mesh_size(mesh)
    root, dev0 = mesh.ranks[0], mesh.devices[0]
    like = parts[0]
    if mesh.rank == root:
        full = [None] * n
        for i, p in zip(mesh.local, parts):
            full[i] = p
        bufs = {i: _recv_buffer(mesh, like, dev0, ("psum", i))
                for i in range(n) if full[i] is None}
        _exchange(mesh, [("recv", b, mesh.ranks[i], i)
                         for i, b in bufs.items()])
        for i, b in bufs.items():
            full[i] = _landed(mesh, b, dev0)
        acc = full[0] + full[1].to(dev0)
        for p in full[2:]:
            acc.add_(p.to(dev0))
        wire = _send_buffer(mesh, acc, ("psum", 0))
    else:
        _exchange(mesh, [("send", _send_buffer(mesh, p, ("psum", i)), root,
                          i) for i, p in zip(mesh.local, parts)])
        acc = None
        wire = _recv_buffer(mesh, like, mesh.local_devices[0], ("psum", 0))
    dist.broadcast(_wire(wire), src=root, group=mesh.group)
    per_device = {}
    for d in mesh.distinct_devices:
        if acc is not None:
            per_device[d] = acc if d == dev0 else acc.to(d)
        else:
            per_device[d] = _landed(mesh, wire, d)
    return _replicas(mesh, per_device)


def psum(parts, mesh):
    """The shards' partials summed in shard order on the first shard's
    device, then one copy on each other distinct device: a per-shard list
    of this rank's shards (shards on one device share one tensor). Over
    processes `parts` are this rank's partials (`_psum_across`)."""
    if mesh.spans_processes:
        return _psum_across(parts, mesh)
    dev0 = mesh.devices[0]
    if len(parts) == 1:
        return [parts[0]]
    acc = parts[0] + parts[1].to(dev0)
    for p in parts[2:]:
        acc.add_(p.to(dev0))
    per_device = {dev0: acc}
    for d in mesh.distinct_devices[1:]:
        per_device[d] = acc.to(d)
    return _replicas(mesh, per_device)


def ring_allreduce(parts, mesh):
    """The facet-axis all-reduce as a ring: reduce-scatter, then
    all-gather, 2(n-1) rotations of a 1/n chunk.

    `parts` holds one partial a shard of this rank (every shard, in one
    process), on the shard's device. Each is flattened and zero-padded to
    n equal chunks (the pad never aliases a real element). Shard i starts
    with its own chunk i; each reduce-scatter step moves every shard's
    running chunk to the next shard, where the local copy of that chunk
    is added, so after n-1 steps shard i holds chunk (i + 1) % n fully
    reduced, its sum taken in ring order from the chunk's owner. The
    all-gather rotates the finished chunks the rest of the way round. A
    rotation within a rank is a copy to the next shard's device (a copy
    even where it shares the device); between ranks, one batch of sends
    and receives to the neighbours. Returns one result a local shard
    (each its own gathered buffer), and the bytes the rotations moved
    over the whole ring."""
    n = mesh_size(mesh)
    if n <= 1:
        return list(parts), 0
    devs, ranks = mesh.devices, mesh.ranks
    local = mesh.local
    shape = parts[0].shape
    size = parts[0].numel()
    per = -(-size // n)
    chunks = {}
    for i, p in zip(local, parts):
        flat = p.reshape(-1)
        if n * per != size:
            flat = torch.cat([flat, flat.new_zeros(n * per - size)])
        chunks[i] = flat.view(n, per)

    def rotate(bufs):
        out, ops, recv = {}, [], {}
        for j in local:  # shard j sends to shard j + 1
            k = (j + 1) % n
            if ranks[k] == mesh.rank:
                out[k] = bufs[j].to(devs[k], copy=True)
            else:
                ops.append(("send", _send_buffer(mesh, bufs[j], ("out", j)),
                            ranks[k], k))
        for i in local:
            h = (i - 1) % n
            if ranks[h] != mesh.rank:
                recv[i] = _recv_buffer(mesh, bufs[local[0]], devs[i],
                                       ("in", i))
                ops.append(("recv", recv[i], ranks[h], i))
        _exchange(mesh, ops)
        for i, b in recv.items():
            out[i] = _landed(mesh, b, devs[i])
        return out

    acc = {i: chunks[i][i] for i in local}
    for s in range(1, n):  # reduce-scatter
        acc = rotate(acc)
        acc = {i: acc[i] + chunks[i][(i - s) % n] for i in local}
    gathered = {i: torch.empty((n, per), dtype=parts[0].dtype,
                               device=devs[i]) for i in local}
    own = {i: (i + 1) % n for i in local}  # shard i finished chunk i + 1
    for i in local:
        gathered[i][own[i]] = acc[i]
    cur = acc
    for s in range(1, n):  # all-gather
        cur = rotate(cur)
        for i in local:
            gathered[i][(own[i] - s) % n] = cur[i]
    out = [gathered[i].view(-1)[:size].view(shape) for i in local]
    return out, 2 * (n - 1) * n * per * parts[0].element_size()


def collective_sum(parts, mesh, collective=None):
    """The facet-axis sum of one partial a shard of this rank under
    `collective` (``psum`` or ``ring``; None: `resolve_collective`),
    timed as the stage of that name with its bytes (those of the whole
    mesh, on every rank). Returns one tensor a local shard."""
    n = mesh_size(mesh)
    if collective is None:
        collective = resolve_collective(n)
    if n <= 1:
        return list(parts)
    with (_metrics.stage("mesh.ring_step") if collective == "ring"
          else _metrics.stage("mesh.psum")) as st:
        if collective == "ring":
            out, moved = ring_allreduce(parts, mesh)
        else:
            out = psum(parts, mesh)
            moved = 2 * (n - 1) * _nbytes(parts[0])
        st.bytes_moved = int(moved)
    if _metrics.enabled():
        _metrics.count("mesh.collectives")
        _metrics.count("mesh.collective_bytes", int(moved))
    return out


def _local(x, mesh):
    """This rank's per-shard pieces of a facet-stacked argument: a
    `ShardedStack`'s shards, or those of a global array split along its
    first axis."""
    if isinstance(x, ShardedStack):
        return x.shards
    n = mesh_size(mesh)
    if isinstance(x, torch.Tensor):
        pieces = list(torch.chunk(x, n))
    else:
        arr = np.asarray(x)
        if len(arr) % n:
            raise ValueError(f"{len(arr)} facets do not split over {n} "
                             f"shards")
        pieces = list(np.split(arr, n))
    return [pieces[i] for i in mesh.local]


def _column_partial_then_finish(core, mesh, cols, offs0, offs1, off0,
                                sg_offs1, masks0, masks1, subgrid_size,
                                collective):
    """The S subgrids of one column: each shard's partial over its local
    facets (`cols` one [Fs, m, yN] a shard), one collective, the finish
    on the first shard's device."""
    parts = []
    devs = mesh.local_devices
    for i, (c, o0, o1) in enumerate(zip(cols, _local(offs0, mesh),
                                        _local(offs1, mesh))):
        sc = shard_core(core, devs[i])
        parts.append(facet_contrib_to_subgrid(
            sc, c, o0, o1, _index(sc, sg_offs1)).sum(dim=1))
    summed = collective_sum(parts, mesh, collective)[0]
    c0 = shard_core(core, devs[0])
    return finish_masked_subgrid(c0, summed, [off0, _index(c0, sg_offs1)],
                                 subgrid_size, masks0, masks1)


def prepare_facets_sharded(core, mesh, facets, offs0):
    """Each shard's facets prepared along axis 0 on its device: a
    `ShardedStack` of [Fs, yN, yB]. `facets` is the padded stack's list
    of per-facet arrays (or callables); `offs0` the padded offsets."""
    n = mesh_size(mesh)
    per = len(facets) // n
    offs0 = np.asarray(offs0)
    shards = []
    for i in mesh.local:
        sc = shard_core(core, mesh.devices[i])
        shards.append(prepare_facets_batch(
            sc, facets[i * per:(i + 1) * per], offs0[i * per:(i + 1) * per]))
    return ShardedStack(shards, mesh)


def extract_columns_sharded(core, mesh, BF_Fs, off0, offs1):
    """One column's prepared rows on each shard: a `ShardedStack` of
    [Fs, m, yN] (shard-local)."""
    return ShardedStack(
        [extract_columns_batch(shard_core(core, mesh.local_devices[i]), bf,
                               off0,
                               o1)
         for i, (bf, o1) in enumerate(zip(_local(BF_Fs, mesh),
                                          _local(offs1, mesh)))],
        mesh)


def subgrid_from_columns_sharded(core, mesh, NMBF_BFs, offs0, offs1, sg_off0,
                                 sg_off1, subgrid_size, masks,
                                 collective=None):
    """Facet-sharded NMBF_BFs -> one finished subgrid [xA, xA] on the
    first shard's device: `batched.subgrid_from_columns_batch` with the
    facet sum as one collective."""
    return _column_partial_then_finish(
        core, mesh, _local(NMBF_BFs, mesh), offs0, offs1, int(sg_off0),
        [sg_off1], np.asarray(masks[0])[None], np.asarray(masks[1])[None],
        subgrid_size, collective)[0]


def subgrids_from_columns_sharded(core, mesh, NMBF_BFs, offs0, offs1,
                                  sg_offs_list, subgrid_size, masks_list,
                                  collective=None):
    """All subgrids of one column on the mesh, [S, xA, xA]: the local
    facet sums and one collective for the whole column."""
    return _column_partial_then_finish(
        core, mesh, _local(NMBF_BFs, mesh), offs0, offs1,
        _index(shard_core(core, mesh.local_devices[0]),
               [so[0] for so in sg_offs_list]),
        [so[1] for so in sg_offs_list],
        np.stack([m[0] for m in masks_list]),
        np.stack([m[1] for m in masks_list]), subgrid_size, collective)


def forward_all_sharded(core, mesh, BF_Fs, offs0, offs1, col_offs0, sg_offs1,
                        subgrid_size, masks0, masks1, collective=None):
    """The full forward cover on the mesh, [C, S, xA, xA] on the first
    shard's device: per column, each shard's column blocks and partials,
    one collective, the finish."""
    n_cols = len(col_offs0)
    out = None
    for c, off0 in enumerate(col_offs0):
        cols = extract_columns_sharded(core, mesh, BF_Fs, off0, offs1)
        sgs = _column_partial_then_finish(
            core, mesh, cols.shards, offs0, offs1, int(off0), sg_offs1[c],
            masks0[c], masks1[c], subgrid_size, collective)
        del cols
        if out is None:
            out = sgs.new_empty((n_cols,) + tuple(sgs.shape))
        out[c] = sgs
        del sgs
    return out


def split_subgrid_sharded(core, mesh, subgrid, sg_off0, sg_off1, offs0,
                          offs1):
    """One subgrid -> facet-sharded NAF_NAFs, a `ShardedStack` of
    [Fs, m, m]: the subgrid goes to each shard's device, the extraction
    is local."""
    return ShardedStack(
        [split_subgrid_batch(shard_core(core, mesh.local_devices[i]), subgrid,
                             sg_off0, sg_off1, o0, o1)
         for i, (o0, o1) in enumerate(zip(_local(offs0, mesh),
                                          _local(offs1, mesh)))],
        mesh)


def accumulate_column_sharded(core, mesh, NAF_NAFs, sg_off1, NAF_MNAFs):
    """`batched.accumulate_column_batch` on each shard, in place."""
    for i, (a, acc) in enumerate(zip(NAF_NAFs.shards, NAF_MNAFs.shards)):
        accumulate_column_batch(shard_core(core, mesh.local_devices[i]), a,
                                sg_off1, acc)
    return NAF_MNAFs


def split_accumulate_sharded(core, mesh, subgrids, sg_offs_list, offs0, offs1,
                             NAF_MNAFs):
    """`batched.split_accumulate_batch` on each shard: one column of
    subgrids folded into the facet-sharded accumulator (a `ShardedStack`,
    updated in place and returned). No collective."""
    if isinstance(subgrids, (list, tuple)):
        subgrids = torch.stack([core._prep(sg) for sg in subgrids])
    for i, (o0, o1, acc) in enumerate(zip(_local(offs0, mesh),
                                          _local(offs1, mesh),
                                          NAF_MNAFs.shards)):
        sc = shard_core(core, mesh.local_devices[i])
        split_accumulate_batch(sc, sc._prep(subgrids), sg_offs_list, o0, o1,
                               acc)
    return NAF_MNAFs


def backward_all_sharded(core, mesh, subgrids, sg_offs, offs0, offs1, masks0,
                         masks1, facet_size):
    """The full backward cover on the mesh: a `ShardedStack` of finished
    facets [Fs, yB, yB], each shard's from its local facets (no
    collective)."""
    if isinstance(subgrids, (list, tuple)):
        subgrids = torch.stack(
            [torch.stack([core._prep(sg) for sg in col]) for col in subgrids])
    shards = []
    for i, (o0, o1, m0, m1) in enumerate(zip(
            _local(offs0, mesh), _local(offs1, mesh), _local(masks0, mesh),
            _local(masks1, mesh))):
        sc = shard_core(core, mesh.local_devices[i])
        shards.append(backward_all_batch(
            sc, sc._prep(subgrids), sg_offs, o0, o1, m0, m1, facet_size))
    return ShardedStack(shards, mesh)
