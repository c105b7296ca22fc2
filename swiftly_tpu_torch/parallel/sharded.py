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

Each call of `collective_sum` is one ``metrics.stage`` named for its
schedule (``mesh.psum`` / ``mesh.ring_step``), with the all-reduce's
wire bytes (2(n-1) partial buffers, the ring accounting of
`utils.profiling.collective_bytes_forward`; the ring's own count, which
includes its chunk padding) and, on the card, its device time.
"""

from __future__ import annotations

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
    """A per-shard list from one tensor a distinct device."""
    return [per_device[d] for d in mesh.devices]


def psum(parts, mesh):
    """The shards' partials summed in shard order on the first shard's
    device, then one copy on each other distinct device: a per-shard list
    (shards on one device share one tensor)."""
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

    `parts` holds one partial a shard, on the shard's device. Each is
    flattened and zero-padded to n equal chunks (the pad never aliases a
    real element). Shard i starts with its own chunk i; each
    reduce-scatter step copies every shard's running chunk to the next
    shard's device, where the local copy of that chunk is added, so after
    n-1 steps shard i holds chunk (i + 1) % n fully reduced, its sum
    taken in ring order from the chunk's owner. The all-gather rotates
    the finished chunks the rest of the way round. Returns one result a
    shard (each its own gathered buffer), and the bytes the rotations
    copied."""
    n = len(parts)
    if n <= 1:
        return list(parts), 0
    devs = mesh.devices
    shape = parts[0].shape
    size = parts[0].numel()
    per = -(-size // n)
    chunks = []
    for p in parts:
        flat = p.reshape(-1)
        if n * per != size:
            flat = torch.cat([flat, flat.new_zeros(n * per - size)])
        chunks.append(flat.view(n, per))
    moved = 0

    def rotate(bufs):
        nonlocal moved
        out = [None] * n
        for j in range(n):  # shard j sends to shard j + 1
            out[(j + 1) % n] = bufs[j].to(devs[(j + 1) % n], copy=True)
            moved += _nbytes(bufs[j])
        return out

    acc = [chunks[i][i] for i in range(n)]
    for s in range(1, n):  # reduce-scatter
        acc = rotate(acc)
        acc = [acc[i] + chunks[i][(i - s) % n] for i in range(n)]
    gathered = [torch.empty((n, per), dtype=parts[0].dtype, device=devs[i])
                for i in range(n)]
    own = [(i + 1) % n for i in range(n)]  # shard i finished chunk i + 1
    for i in range(n):
        gathered[i][own[i]] = acc[i]
    cur = acc
    for s in range(1, n):  # all-gather
        cur = rotate(cur)
        for i in range(n):
            gathered[i][(own[i] - s) % n] = cur[i]
    out = [g.view(-1)[:size].view(shape) for g in gathered]
    return out, moved


def collective_sum(parts, mesh, collective=None):
    """The facet-axis sum of one partial a shard under `collective`
    (``psum`` or ``ring``; None: `resolve_collective`), timed as the
    stage of that name with its bytes. Returns one tensor a shard."""
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
    """Per-shard pieces of a facet-stacked argument: a `ShardedStack`'s
    shards, or a global array split along its first axis."""
    if isinstance(x, ShardedStack):
        return x.shards
    n = mesh_size(mesh)
    if isinstance(x, torch.Tensor):
        return list(torch.chunk(x, n))
    arr = np.asarray(x)
    if len(arr) % n:
        raise ValueError(f"{len(arr)} facets do not split over {n} shards")
    return list(np.split(arr, n))


def _column_partial_then_finish(core, mesh, cols, offs0, offs1, off0,
                                sg_offs1, masks0, masks1, subgrid_size,
                                collective):
    """The S subgrids of one column: each shard's partial over its local
    facets (`cols` one [Fs, m, yN] a shard), one collective, the finish
    on the first shard's device."""
    parts = []
    for i, (c, o0, o1) in enumerate(zip(cols, _local(offs0, mesh),
                                        _local(offs1, mesh))):
        sc = shard_core(core, mesh.devices[i])
        parts.append(facet_contrib_to_subgrid(
            sc, c, o0, o1, _index(sc, sg_offs1)).sum(dim=1))
    summed = collective_sum(parts, mesh, collective)[0]
    c0 = shard_core(core, mesh.devices[0])
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
    for i in range(n):
        sc = shard_core(core, mesh.devices[i])
        shards.append(prepare_facets_batch(
            sc, facets[i * per:(i + 1) * per], offs0[i * per:(i + 1) * per]))
    return ShardedStack(shards, mesh)


def extract_columns_sharded(core, mesh, BF_Fs, off0, offs1):
    """One column's prepared rows on each shard: a `ShardedStack` of
    [Fs, m, yN] (shard-local)."""
    return ShardedStack(
        [extract_columns_batch(shard_core(core, mesh.devices[i]), bf, off0,
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
        _index(shard_core(core, mesh.devices[0]),
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
        [split_subgrid_batch(shard_core(core, mesh.devices[i]), subgrid,
                             sg_off0, sg_off1, o0, o1)
         for i, (o0, o1) in enumerate(zip(_local(offs0, mesh),
                                          _local(offs1, mesh)))],
        mesh)


def accumulate_column_sharded(core, mesh, NAF_NAFs, sg_off1, NAF_MNAFs):
    """`batched.accumulate_column_batch` on each shard, in place."""
    for i, (a, acc) in enumerate(zip(NAF_NAFs.shards, NAF_MNAFs.shards)):
        accumulate_column_batch(shard_core(core, mesh.devices[i]), a,
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
        sc = shard_core(core, mesh.devices[i])
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
        sc = shard_core(core, mesh.devices[i])
        shards.append(backward_all_batch(
            sc, sc._prep(subgrids), sg_offs, o0, o1, m0, m1, facet_size))
    return ShardedStack(shards, mesh)
