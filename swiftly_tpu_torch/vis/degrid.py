"""Batched degridding: one launch of kernel B4 per serving pump.

The port of the JAX package's ``swiftly_tpu/vis/degrid.py``. Each sample's
``support x support`` pixel patch of its served subgrid row is contracted
against the separable tap weights,
``vis[b] = sum_ij patch[b, i, j] * cu[b, i] * cv[b, j]``. Real arithmetic
throughout (tap weights are real, rows arrive as real/imag planes), which
is also what makes `vis.grid` the EXACT adjoint: the same indices and the
same real weights, transposed.

`degrid_rows` answers every sample of one serving pump, over the G rows of
its subgrids, in one launch of B4 (``ops.kernels.degrid_rows``,
``csrc/degrid.cu``): the patches are read where they lie in the rows, and
the tap weights are computed on the card from the `VisKernel` table, the
host's bits. A row computed on the device is read there; a host row (the
cache feed's) goes up through pinned memory in one non-blocking copy; the
rows' descriptors and the samples' slots, first taps and fractions go up
in one more; the samples come back in one copy, as one [B] complex128 host
vector. On CPU tensors the wrapper runs the plain version (the weights by
torch float64 operations, then gather plus ``einsum``).

`degrid_batch` is the reference's one-row API, with the weights given: B4
on one row (``ops.kernels.degrid``). Its batch sizes are padded to
power-of-two buckets with a floor of 2 and a cap of 4096, the reference's
jit-cache discipline. B4 reduces each sample in an order that depends on
the tap count alone, so a sample's bits do not depend on the bucket, the
pump or how its batch was coalesced; `degrid_batch` fed the host's weights
gives the bits `degrid_rows` serves. Both keep the reference's cap of 4096
samples a subgrid.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels
from ..ops.core import resolve_device

__all__ = ["bucket_size", "degrid_batch", "degrid_rows", "split_row_planes"]

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


def _staged(row, device):
    """The row as a torch tensor on its device, or, for a host array, on
    ``device`` (default: the GPU): through pinned memory in one
    non-blocking copy on the card (nothing waits for it but the launch
    behind it on the stream)."""
    if isinstance(row, torch.Tensor):
        return row
    host = torch.from_numpy(np.ascontiguousarray(row))
    device = resolve_device(device)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def _check_cap(n, what):
    if n > _MAX_BUCKET:
        raise ValueError(
            f"{what} answers at most {_MAX_BUCKET} samples per subgrid row "
            f"(the reference's bucket cap; its padding raises past it too), "
            f"got {n}"
        )


def degrid_rows(rows, slot, iu0, iv0, fu, fv, table, *, device=None):
    """Degrid every sample of one serving pump off its G served rows, in
    one launch of B4, the tap weights computed on the card.

    :param rows: G served rows ([size, size] complex / real / planar
        ``[..., 2]``), torch tensors (read where they lie) or host arrays
        (staged to ``device``)
    :param slot: [B] row slot of each sample, in [0, G)
    :param iu0/iv0: [B] first-tap indices into the sample's row (from
        `vis.mapping.VisCoverIndex.map_samples`)
    :param fu/fv: [B] sub-pixel fractions, the weights'
        (`vis.kernel.VisKernel.weights`) argument
    :param table: the kernel's tap table (`vis.kernel.VisKernel.table`) as
        a float64 tensor, best kept on the rows' device (it is copied
        there otherwise)
    :param device: where host rows go; None means the GPU
    :return: [B] complex128 visibilities (host), each sample's bits those
        of `degrid_batch` on its row fed the host's weights,
        ``VisKernel.weights(f, float64)``
    :raises ValueError: for more than 4096 samples of one row (the
        reference's cap a dispatch), or a table whose largest lookup would
        read past it
    """
    slot = np.asarray(slot, dtype=np.int64)
    if slot.size:
        _check_cap(int(np.bincount(slot, minlength=len(rows)).max()),
                   "degrid_rows")
    planes = [split_row_planes(_staged(row, device)) for row in rows]
    dev = planes[0][0].device
    samples = [torch.from_numpy(np.ascontiguousarray(a, dtype=dt))
               for a, dt in ((slot, np.int64), (iu0, np.int64),
                             (iv0, np.int64), (fu, np.float64),
                             (fv, np.float64))]
    vr, vi = kernels.degrid_rows(planes, *samples, table.to(dev))
    out = torch.stack([vr, vi]).cpu().numpy().astype(np.float64)
    return out[0] + 1j * out[1]


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
    _check_cap(n, "degrid_batch")
    row_r, row_i = split_row_planes(_staged(row, device))
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
