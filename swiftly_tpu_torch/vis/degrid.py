"""Batched degridding: one dispatch of kernel B4 per served subgrid row.

The port of the JAX package's ``swiftly_tpu/vis/degrid.py``. One dispatch
answers every sample of one served subgrid row: each sample's
``support x support`` pixel patch is contracted against the separable tap
weights, ``vis[b] = sum_ij patch[b, i, j] * cu[b, i] * cv[b, j]``. Real
arithmetic throughout (tap weights are real, rows arrive as real/imag
planes), which is also what makes `vis.grid` the EXACT adjoint: the same
indices and the same real weights, transposed.

Kernel B4 (``ops.kernels.degrid``, ``csrc/degrid.cu``) reads the patches
where they lie in the row, so neither the [B, W, W] patches nor the weight
plane are built; on CPU tensors its wrapper runs the plain version (gather
plus ``einsum``). Rows stay where they are: a row computed on the device
is read there, and a host row (the cache feed's) is uploaded once per
dispatch, with the indices and weights in two more copies. The samples
come back as one [B] complex128 host vector, as in the reference.

Batch sizes are padded to power-of-two buckets with a floor of 2 and a
cap of 4096, the reference's jit-cache discipline. B4 reduces each sample
in an order that depends on the tap count alone, so a sample's bits do not
depend on the bucket (or on how its batch was coalesced) in any case; the
padding keeps the reference's dispatch shapes, and its cap.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels
from ..ops.core import resolve_device

__all__ = ["bucket_size", "degrid_batch", "split_row_planes"]

_MAX_BUCKET = 4096

_NP_REAL = {torch.float32: np.float32, torch.float64: np.float64}


def bucket_size(n, max_bucket=_MAX_BUCKET):
    """Smallest power-of-two >= n (capped) — the dispatch-shape bucket.

    The floor is 2, not 1: the reference's XLA compiles the B=1 einsum
    with a different reduction order than every B>=2 bucket, which would
    break the contract that a sample's bits do not depend on how its batch
    was coalesced. The port keeps the same buckets.
    """
    b = 2
    while b < n and b < max_bucket:
        b *= 2
    return b


def split_row_planes(row):
    """A served subgrid row as (real, imag) float planes, as torch views.

    Accepts the three layouts the serve path produces, as torch tensors or
    numpy arrays: planar ``[..., 2]`` (the planar backend and every
    recorded stream of it), complex (the torch and numpy backends), and
    real (imag plane zero).
    """
    if not isinstance(row, torch.Tensor):
        row = torch.from_numpy(np.asarray(row))
    if row.is_complex():
        return row.real, row.imag
    if row.ndim == 3 and row.shape[-1] == 2:
        return row[..., 0], row[..., 1]
    return row, torch.zeros_like(row)


def _on_device(row, device):
    """The row as a torch tensor on its device, or uploaded (one copy) to
    ``device`` (default: the GPU) when it is a host array."""
    if isinstance(row, torch.Tensor):
        return row
    return torch.as_tensor(np.asarray(row), device=resolve_device(device))


def degrid_batch(row, iu0, iv0, cu, cv, *, support=None, device=None):
    """Degrid one sample batch off one served subgrid row.

    :param row: the served row ([size, size] complex / real / planar
        ``[..., 2]``), a torch tensor (read where it lies) or a host
        array (uploaded to ``device``)
    :param iu0/iv0: [B] first-tap indices into the row (from
        `vis.mapping.VisCoverIndex.map_samples`)
    :param cu/cv: [B, W] separable tap weights
        (`vis.kernel.VisKernel.weights`), cast to the row's dtype
    :param device: where a host row is uploaded; None means the GPU
    :return: [B] complex128 visibilities (host)
    :raises ValueError: for more than 4096 samples — the reference's
        bucket cap, past which its padding raises too

    The same kernel serves cache-fed host rows and compute-fallback device
    rows: identical row BITS in give identical sample bits out, which is
    what makes the cache-vs-compute bit-identity contract of serving carry
    over to samples (tests/test_torch_vis.py pins it).
    """
    iu0 = np.asarray(iu0)
    n = int(iu0.size)
    if n > _MAX_BUCKET:
        raise ValueError(
            f"degrid_batch answers at most {_MAX_BUCKET} samples per "
            f"dispatch (the reference's bucket cap; its padding raises past "
            f"it too), got {n}"
        )
    row_r, row_i = split_row_planes(_on_device(row, device))
    cu = np.asarray(cu)
    W = int(cu.shape[1]) if support is None else int(support)
    b = bucket_size(n)
    idx = np.zeros((2, b), dtype=np.int64)
    idx[0, :n] = iu0
    idx[1, :n] = iv0
    w = np.zeros((2, b, W), dtype=_NP_REAL[row_r.dtype])
    w[0, :n] = cu
    w[1, :n] = cv
    dev = row_r.device
    idx = torch.as_tensor(idx, device=dev)
    w = torch.as_tensor(w, device=dev)
    vr, vi = kernels.degrid(row_r, row_i, idx[0], idx[1], w[0], w[1])
    out = torch.stack([vr[:n], vi[:n]]).cpu().numpy().astype(np.float64)
    return out[0] + 1j * out[1]
