"""Device meshes over the facet axis, in one process or across processes.

The torch twin of the JAX package's ``swiftly_tpu/parallel/mesh.py``.
A `FacetMesh` is an ordered list of shards along the one mesh axis,
``facet``: the facet stack is zero-padded to a multiple of the mesh size
and split into equal shards, shard i on ``mesh.devices[i]``. A device may
repeat: shards on the same device are *virtual shards*, each doing its
own share of the work, with the collectives as explicit device copies
(`parallel.sharded`). That is how a mesh runs on one card
(``make_facet_mesh(devices=["cuda:0"] * 3)``) or on the CPU
(``["cpu"] * 8``), as the JAX package's tests simulate theirs over 8
virtual CPU devices; the same code runs over several distinct cards of
one process. Nothing here repeats a device unless asked to.

A mesh may span processes (``torch.distributed``): after
`bootstrap_from_env` (or `initialize_multihost`) `make_facet_mesh`
gathers every rank's local devices into one global, ordered list of
shards, each a (rank, device) pair (``mesh.ranks``, ``mesh.devices``),
and each rank holds and computes only its own shards (``mesh.local``):
`ShardedStack` keeps their tensors alone, `place_facet_sharded` slices
them alone out of the global host array, and a gather leaves the other
ranks' rows zero, as the JAX package's addressable-shard reads do. The
collectives cross ranks over the mesh's process group, whose backend
`backend_rule` picks: ``nccl`` when every rank has a CUDA card of its
own, ``gloo`` when a rank is on the CPU or two ranks share a card; on
gloo a CUDA tensor crosses through pinned host buffers.
"""

from __future__ import annotations

import copy
import os
import socket

import numpy as np
import torch

FACET_AXIS = "facet"

COLLECTIVES = ("psum", "ring")

__all__ = [
    "COLLECTIVES",
    "FACET_AXIS",
    "FacetMesh",
    "FacetSharding",
    "ShardedStack",
    "backend_rule",
    "bootstrap_from_env",
    "facet_sharding",
    "initialize_multihost",
    "make_facet_mesh",
    "mesh_size",
    "pad_to_shards",
    "place_facet_sharded",
    "replicated_sharding",
    "resolve_collective",
    "shard_core",
]


def resolve_collective(n_shards: int | None = None) -> str:
    """The facet-axis reduction schedule a sharded column pass runs.

    ``SWIFTLY_MESH_COLLECTIVE`` in {psum, ring, auto} (default auto):
    ``psum`` sums the shards' partials in shard order on the first
    shard's device, then copies the sum to every other device of the
    mesh; ``ring`` is the reduce-scatter + all-gather of 2(n-1) chunk
    rotations (`parallel.sharded.ring_allreduce`); ``auto`` is psum (the
    plan compiler exports a calibrated choice through this knob). Read at
    call time, so one process can run psum and ring back to back. A
    one-shard mesh always resolves to psum: there is no ring of one.
    """
    mode = os.environ.get("SWIFTLY_MESH_COLLECTIVE", "auto")
    if mode not in ("psum", "ring", "auto"):
        raise ValueError(
            f"SWIFTLY_MESH_COLLECTIVE must be psum|ring|auto, got {mode!r}"
        )
    if n_shards is not None and n_shards <= 1:
        return "psum"
    if mode == "auto":
        return "psum"
    return mode


def _device(d) -> torch.device:
    """A torch device with its index filled in for CUDA, so that devices
    compare equal to the ones tensors report."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def initialize_multihost(coordinator=None, num_processes=None,
                         process_id=None):
    """Join this process to a ``torch.distributed`` process group.

    ``init_process_group`` with ``init_method="tcp://<coordinator>"``
    (a coordinator that already names its scheme, such as
    ``file:///path``, is passed as it is), ``world_size`` and ``rank``
    where they are given; without a coordinator ``env://`` (torch's
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``). The
    default group is gloo: it carries the meshes' exchange of device
    lists, and each mesh runs its collectives on the group `backend_rule`
    picks. Call it once a process, before any mesh is made.
    """
    import torch.distributed as dist

    kwargs = {"backend": "gloo"}
    if coordinator is None:
        kwargs["init_method"] = "env://"
    elif "://" in coordinator:
        kwargs["init_method"] = coordinator
    else:
        kwargs["init_method"] = f"tcp://{coordinator}"
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group(**kwargs)


def bootstrap_from_env():
    """Env-driven bootstrap of a process-spanning mesh.

    Reads ``SWIFTLY_COORDINATOR`` (host:port of rank 0's rendezvous),
    ``SWIFTLY_NUM_PROCESSES`` and ``SWIFTLY_PROCESS_ID`` and calls
    `initialize_multihost` with whatever is set. With none of them set
    this is a no-op returning ``None``: a single-process run needs no
    environment. Returns the resolved ``{coordinator, num_processes,
    process_id}`` dict when a bootstrap happened (the counts as ints), so
    callers can log what they joined.
    """
    coordinator = os.environ.get("SWIFTLY_COORDINATOR") or None
    num_processes = os.environ.get("SWIFTLY_NUM_PROCESSES") or None
    process_id = os.environ.get("SWIFTLY_PROCESS_ID") or None
    if coordinator is None and num_processes is None and process_id is None:
        return None
    if num_processes is not None:
        num_processes = int(num_processes)
    if process_id is not None:
        process_id = int(process_id)
    initialize_multihost(
        coordinator=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return {
        "coordinator": coordinator,
        "num_processes": num_processes,
        "process_id": process_id,
    }


def _process_group():
    """(rank, world size) of this process's default group; (0, 1)
    without one."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def backend_rule(facts):
    """The collective backend of a mesh over the ranks' `facts` (one
    ``{"devices": [...], "host": ..., "cards": [...]}`` a rank, in rank
    order): ``nccl`` when every rank's devices are CUDA cards that no
    other rank uses, else ``gloo`` (a rank on the CPU, or two ranks on
    one card, which NCCL refuses)."""
    seen = set()
    for f in facts:
        if not f["devices"] or any(not d.startswith("cuda")
                                   for d in f["devices"]):
            return "gloo"
        cards = {(f["host"], c) for c in f["cards"]}
        if cards & seen:
            return "gloo"
        seen |= cards
    return "nccl"


_GROUPS = {}  # (default group, backend) -> the mesh collectives' group


def _collective_group(backend):
    """The process group a mesh's collectives run on: the default group
    where its backend is the rule's, else a new group over every rank
    with the rule's backend (made once a default group, collectively)."""
    import torch.distributed as dist

    if dist.get_backend() == backend:
        return None
    key = (id(dist.group.WORLD), backend)
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(backend=backend)
    return _GROUPS[key]


def _card_id(d):
    props = torch.cuda.get_device_properties(d)
    return str(getattr(props, "uuid", None) or f"cuda:{d.index}")


class FacetMesh:
    """A 1-D mesh: the ordered shards of the facet axis, each a device
    of one rank.

    :param devices: torch devices (or their names), one a shard; a device
        that repeats within a rank holds several virtual shards
    :param ranks: the rank of each shard (default: all this process's)
    :param rank: this process's rank
    :param backend: the collectives' backend across ranks (None in one
        process)
    :param group: their process group (None: the default group)
    """

    def __init__(self, devices, ranks=None, rank=0, backend=None,
                 group=None):
        ranks = tuple(rank for _ in devices) if ranks is None else tuple(
            int(r) for r in ranks)
        if len(ranks) != len(devices):
            raise ValueError(f"{len(ranks)} ranks for {len(devices)} shards")
        self.rank = int(rank)
        self.ranks = ranks
        self.devices = tuple(
            _device(d) if r == self.rank else torch.device(d)
            for d, r in zip(devices, ranks))
        if not self.devices:
            raise ValueError("a facet mesh needs at least one device")
        if self.rank not in ranks:
            raise ValueError(f"rank {self.rank} holds no shard of the mesh")
        self.backend = backend
        self.group = group
        # the collectives' host staging across ranks on gloo: its bytes
        # each way and the host seconds of its copies, and the pinned
        # buffers it reuses (`parallel.sharded`)
        self.staging = {"d2h_bytes": 0, "h2d_bytes": 0, "seconds": 0.0}
        self.pinned = {}

    @property
    def spans_processes(self) -> bool:
        """Whether the shards lie in more than one process."""
        return len(set(self.ranks)) > 1

    @property
    def local(self):
        """Indices of this rank's shards, in shard order."""
        return tuple(i for i, r in enumerate(self.ranks) if r == self.rank)

    @property
    def local_devices(self):
        """The devices of this rank's shards, in shard order."""
        return tuple(self.devices[i] for i in self.local)

    @property
    def distinct_devices(self):
        """This rank's devices without repeats, in shard order."""
        return list(dict.fromkeys(self.local_devices))

    def without_shard(self, lost):
        """The mesh over every shard but `lost`, on the same ranks and
        process group. A rank left with no shard is a lost process, which
        this group cannot drop: that raises, naming the rank."""
        ranks = [r for i, r in enumerate(self.ranks) if i != lost]
        gone = self.ranks[lost]
        if gone not in ranks:
            raise RuntimeError(
                f"losing shard {lost} leaves rank {gone} with no shard: the "
                f"process group of {len(set(self.ranks))} ranks cannot drop "
                f"a rank; restart the job over the surviving ranks and "
                f"resume from the last autosave")
        return FacetMesh([d for i, d in enumerate(self.devices) if i != lost],
                         ranks, self.rank, self.backend, self.group)

    def __len__(self):
        return len(self.devices)

    def __repr__(self):
        if not self.spans_processes:
            return f"FacetMesh({[str(d) for d in self.devices]})"
        shards = [(r, str(d)) for r, d in zip(self.ranks, self.devices)]
        return (f"FacetMesh({shards}, rank={self.rank}, "
                f"backend={self.backend!r})")


def _visible_cards(n_devices):
    visible = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        if len(visible) < n_devices:
            raise ValueError(
                f"Requested a {n_devices}-device mesh but only "
                f"{len(visible)} devices are available"
            )
        visible = visible[:n_devices]
    return visible


def _process_mesh(rank, world, n_devices, devices):
    """A mesh over every rank of the default group: this rank's devices
    (`devices`; else ``cuda:$LOCAL_RANK``; else its share of `n_devices`
    visible cards, or all of them), every rank's gathered in rank order,
    and the collectives' group by `backend_rule`."""
    import torch.distributed as dist

    if devices is not None:
        local = [_device(d) for d in devices]
    elif os.environ.get("LOCAL_RANK") is not None:
        local = [torch.device("cuda", int(os.environ["LOCAL_RANK"]))]
    else:
        if n_devices is not None and n_devices % world:
            raise ValueError(f"{n_devices} devices do not split over "
                             f"{world} ranks")
        local = _visible_cards(None if n_devices is None
                               else n_devices // world)
    if not local:
        raise ValueError(f"rank {rank}: no device for the mesh")
    for d in local:
        if d.type == "cuda" and not (torch.cuda.is_available()
                                     and d.index < torch.cuda.device_count()):
            raise RuntimeError(
                f"rank {rank}: the mesh names {d}, but this process sees "
                f"no such CUDA card (no CPU fallback)")
    facts = {"devices": [str(d) for d in local],
             "host": socket.gethostname(),
             "cards": [_card_id(d) for d in local if d.type == "cuda"]}
    every = [None] * world
    dist.all_gather_object(every, facts)
    backend = backend_rule(every)
    ranks = [r for r, f in enumerate(every) for _ in f["devices"]]
    devs = [d for f in every for d in f["devices"]]
    return FacetMesh(devs, ranks, rank, backend, _collective_group(backend))


def make_facet_mesh(n_devices: int | None = None, devices=None) -> FacetMesh:
    """1-D mesh over the facet stack axis.

    In one process: `devices` (the only way to get virtual shards, e.g.
    ``[torch.device("cuda:0")] * 3`` or ``["cpu"] * 8``), else the first
    `n_devices` visible CUDA cards (default: all). After a bootstrap
    (`bootstrap_from_env`) a collective call of every rank: each adds
    its local devices (`devices`, else ``cuda:$LOCAL_RANK``, else its
    share of `n_devices`, the global count, of the visible cards) and the
    mesh spans them all, in rank order.
    """
    rank, world = _process_group()
    if world > 1:
        return _process_mesh(rank, world, n_devices, devices)
    if devices is not None:
        return FacetMesh(devices)
    visible = _visible_cards(n_devices)
    if not visible:
        raise ValueError(
            "no CUDA device is visible; pass devices=[...] for a mesh of "
            "virtual shards (e.g. ['cpu'] * 8)"
        )
    return FacetMesh(visible)


class FacetSharding:
    """How an array lies on a mesh: split along axis `axis` into one
    equal shard a device (``axis`` 0, `facet_sharding`) or replicated
    (``axis`` None, `replicated_sharding`)."""

    def __init__(self, mesh: FacetMesh, axis: int | None = 0):
        self.mesh = mesh
        self.axis = axis

    @property
    def spec(self):
        return () if self.axis is None else (None,) * self.axis + (FACET_AXIS,)

    def __repr__(self):
        return f"FacetSharding({self.mesh!r}, axis={self.axis})"


def facet_sharding(mesh: FacetMesh) -> FacetSharding:
    """Sharding that splits the leading (facet-stack) axis over the mesh."""
    return FacetSharding(mesh, 0)


def replicated_sharding(mesh: FacetMesh) -> FacetSharding:
    """Fully replicated sharding on the mesh."""
    return FacetSharding(mesh, None)


def mesh_size(mesh) -> int:
    """Shard count of a (possibly absent) mesh."""
    return 1 if mesh is None else len(mesh.devices)


def pad_to_shards(n: int, n_shards: int) -> int:
    """Facet count padded up to a multiple of the mesh size.

    Zero-padded facets contribute zeros to every linear accumulation, so
    padding is exact (not approximate)."""
    return ((n + n_shards - 1) // n_shards) * n_shards


def shard_bounds(n_total: int, mesh: FacetMesh):
    """[(lo, hi)] of each shard's facets in a stack of `n_total` (a
    multiple of the mesh size)."""
    n = mesh_size(mesh)
    if n_total % n:
        raise ValueError(f"{n_total} facets do not split over {n} shards")
    per = n_total // n
    return [(i * per, (i + 1) * per) for i in range(n)]


def local_bounds(n_total: int, mesh: FacetMesh):
    """`shard_bounds` of this rank's shards only, in shard order."""
    bounds = shard_bounds(n_total, mesh)
    return [bounds[i] for i in mesh.local]


class ShardedStack:
    """An array split along its facet axis over a mesh: one tensor for
    each of this rank's shards (every shard, in one process), on the
    shard's device, and the zero padding the placement added at the end
    of the facet axis.

    :param shards: this rank's per-shard tensors, equal in shape
    :param mesh: the `FacetMesh` they lie on
    :param facet_axis: the split axis
    :param n_pad: zero facets appended to reach a multiple of the mesh
    """

    def __init__(self, shards, mesh, facet_axis=0, n_pad=0):
        if len(shards) != len(mesh.local):
            raise ValueError(
                f"{len(shards)} shards for the {len(mesh.local)} of rank "
                f"{mesh.rank} in a {mesh_size(mesh)}-shard mesh")
        self.shards = list(shards)
        self.mesh = mesh
        self.facet_axis = facet_axis
        self.n_pad = int(n_pad)

    @property
    def shape(self):
        s = list(self.shards[0].shape)
        s[self.facet_axis] *= mesh_size(self.mesh)
        return tuple(s)

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def n_real(self) -> int:
        return self.shape[self.facet_axis] - self.n_pad

    def gather(self, device=None, real=True):
        """The whole array on `device` (default: the first shard's), the
        placement's padding dropped unless ``real=False``. On a mesh over
        processes the other ranks' shards are zero (as the JAX package's
        addressable-shard gather leaves them): nothing crosses ranks."""
        device = self.shards[0].device if device is None else device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        per = self.shards[0].shape[self.facet_axis]
        local = dict(zip(self.mesh.local, self.shards))
        for i in range(mesh_size(self.mesh)):
            part = out.narrow(self.facet_axis, i * per, per)
            if i in local:
                part.copy_(local[i])
            else:
                part.zero_()
        if real and self.n_pad:
            out = out.narrow(self.facet_axis, 0, self.n_real)
        return out

    def numpy(self, real=True):
        """A host copy of `gather`."""
        return self.gather("cpu", real).numpy()

    def __repr__(self):
        return (f"ShardedStack(shape={self.shape}, dtype={self.dtype}, "
                f"mesh={self.mesh!r}, n_pad={self.n_pad})")


def place_facet_sharded(arr, mesh: FacetMesh, facet_axis: int = 0):
    """Place the GLOBAL array `arr` (numpy or tensor) facet-sharded over
    the mesh: zero-padded along `facet_axis` to a multiple of the mesh
    size, split into equal shards, and this rank's shards (every shard,
    in one process) copied to their devices. A tensor keeps its dtype; a
    numpy array becomes the matching tensor."""
    if not isinstance(arr, torch.Tensor):
        arr = torch.as_tensor(np.ascontiguousarray(arr))
    n = arr.shape[facet_axis]
    total = pad_to_shards(n, mesh_size(mesh))
    if total != n:
        pad_shape = list(arr.shape)
        pad_shape[facet_axis] = total - n
        arr = torch.cat([arr, arr.new_zeros(pad_shape)], dim=facet_axis)
    parts = torch.chunk(arr, mesh_size(mesh), dim=facet_axis)
    shards = [parts[i].to(mesh.devices[i]).contiguous() for i in mesh.local]
    return ShardedStack(shards, mesh, facet_axis, total - n)


def shard_core(core, device):
    """`core` on `device`: the core itself where it already lies there,
    else a shallow copy whose window constants live on `device` (one per
    device, kept on the core). The numerics are the core's."""
    device = _device(device)
    if core.device == device:
        return core
    cache = core.__dict__.setdefault("_shard_cores", {})
    if device not in cache:
        other = copy.copy(core)
        other.__dict__.pop("_shard_cores", None)
        other.__dict__.pop("_knob_cores", None)
        other.device = device
        other._Fb = core._Fb.to(device)
        other._Fn = core._Fn.to(device)
        cache[device] = other
    return cache[device]
