"""Device meshes over the facet axis, in one process.

The torch twin of the JAX package's ``swiftly_tpu/parallel/mesh.py``.
A `FacetMesh` is an ordered list of torch devices along the one mesh
axis, ``facet``: the facet stack is zero-padded to a multiple of the
mesh size and split into equal shards, shard i on ``mesh.devices[i]``.
A device may repeat: shards on the same device are *virtual shards*,
each doing its own share of the work, with the collectives as explicit
device copies (`parallel.sharded`). That is how a mesh runs on one card
(``make_facet_mesh(devices=["cuda:0"] * 3)``) or on the CPU
(``["cpu"] * 8``), as the JAX package's tests simulate theirs over 8
virtual CPU devices; the same code runs over several distinct cards of
one process. Nothing here repeats a device unless asked to.

Process-spanning meshes (the JAX package's ``initialize_multihost`` /
``bootstrap_from_env``) are not here: ROADMAP A8b.
"""

from __future__ import annotations

import copy
import os

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
    "facet_sharding",
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


class FacetMesh:
    """A 1-D mesh: the ordered devices of the facet axis.

    :param devices: torch devices (or their names), one per shard; a
        device that repeats holds several virtual shards
    """

    def __init__(self, devices):
        devices = tuple(_device(d) for d in devices)
        if not devices:
            raise ValueError("a facet mesh needs at least one device")
        self.devices = devices

    @property
    def distinct_devices(self):
        """The mesh's devices without repeats, in shard order."""
        return list(dict.fromkeys(self.devices))

    def __len__(self):
        return len(self.devices)

    def __repr__(self):
        return f"FacetMesh({[str(d) for d in self.devices]})"


def make_facet_mesh(n_devices: int | None = None, devices=None) -> FacetMesh:
    """1-D mesh over the facet stack axis.

    :param n_devices: number of visible CUDA devices to use (default: all)
    :param devices: explicit device list (overrides `n_devices`); the only
        way to get virtual shards, e.g. ``[torch.device("cuda:0")] * 3``
        or ``["cpu"] * 8``
    """
    if devices is not None:
        return FacetMesh(devices)
    visible = [torch.device("cuda", i)
               for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        if len(visible) < n_devices:
            raise ValueError(
                f"Requested a {n_devices}-device mesh but only "
                f"{len(visible)} devices are available"
            )
        visible = visible[:n_devices]
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


class ShardedStack:
    """An array split along its facet axis over a mesh: one tensor a
    shard, on the shard's device, and the zero padding the placement
    added at the end of the facet axis.

    :param shards: per-shard tensors, equal in shape
    :param mesh: the `FacetMesh` they lie on
    :param facet_axis: the split axis
    :param n_pad: zero facets appended to reach a multiple of the mesh
    """

    def __init__(self, shards, mesh, facet_axis=0, n_pad=0):
        if len(shards) != mesh_size(mesh):
            raise ValueError(
                f"{len(shards)} shards for a {mesh_size(mesh)}-shard mesh")
        self.shards = list(shards)
        self.mesh = mesh
        self.facet_axis = facet_axis
        self.n_pad = int(n_pad)

    @property
    def shape(self):
        s = list(self.shards[0].shape)
        s[self.facet_axis] *= len(self.shards)
        return tuple(s)

    @property
    def n_real(self) -> int:
        return self.shape[self.facet_axis] - self.n_pad

    def gather(self, device=None, real=True):
        """The whole array on `device` (default: the first shard's), the
        placement's padding dropped unless ``real=False``."""
        device = self.shards[0].device if device is None else device
        out = torch.cat([t.to(device) for t in self.shards],
                        dim=self.facet_axis)
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
    size, split into equal shards, each copied to its shard's device. A
    tensor keeps its dtype; a numpy array becomes the matching tensor."""
    if not isinstance(arr, torch.Tensor):
        arr = torch.as_tensor(np.ascontiguousarray(arr))
    n = arr.shape[facet_axis]
    total = pad_to_shards(n, mesh_size(mesh))
    if total != n:
        pad_shape = list(arr.shape)
        pad_shape[facet_axis] = total - n
        arr = torch.cat([arr, arr.new_zeros(pad_shape)], dim=facet_axis)
    parts = torch.chunk(arr, mesh_size(mesh), dim=facet_axis)
    shards = [p.to(d).contiguous() for p, d in zip(parts, mesh.devices)]
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
        other.device = device
        other._Fb = core._Fb.to(device)
        other._Fn = core._Fn.to(device)
        cache[device] = other
    return cache[device]
