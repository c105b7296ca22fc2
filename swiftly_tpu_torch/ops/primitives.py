"""L0 array primitives on complex torch tensors (``backend="torch"``).

The torch twin of the JAX package's ``swiftly_tpu/ops/primitives.py``: the
building blocks of the streaming distributed Fourier transform, with the
same centre conventions:

  - the centre index of a length-n axis is n//2
  - extract_mid keeps indices [c - n//2, c - n//2 + n) of the source
  - pad_mid places the source at [n//2 - n0//2, n//2 - n0//2 + n0) of the target

Offsets. JAX traces its offsets and ``vmap``s over stacks whose rows carry
different offsets. Here batching is written out as leading dimensions, so
every offset argument (``shift``) is either a Python int, applied to the
whole tensor with plain slicing, or an int64 tensor whose shape lines up
with the LEADING dimensions of the data (size 1 where an offset is shared),
applied as a gather/scatter with one index row per batch row.

Axes may be negative. The batched code (``parallel/batched.py``) counts the
per-item axes from the end, so the same math runs on one item and on a
stack of items.

The functions are dtype-generic, so the planar backend reuses them on its
physical axes (``planar_backend.py``).
"""

from __future__ import annotations

import torch

__all__ = [
    "broadcast_along",
    "extract_mid",
    "fft",
    "ifft",
    "ndim",
    "pad_mid",
    "roll_axis",
    "wrapped_embed",
    "wrapped_embed_add_",
    "wrapped_extract",
]


def ndim(a) -> int:
    """Logical dimensionality of `a` (the planar backend subtracts its
    trailing re/im axis)."""
    return a.ndim


def broadcast_along(vec, ndim: int, axis: int):
    """Reshape a 1D vector so it broadcasts along `axis` of an `ndim` array."""
    shape = [1] * ndim
    shape[axis] = -1
    return vec.reshape(shape)


def pad_mid(a, n: int, axis: int):
    """Zero-pad `a` to size `n` along `axis`, keeping the centre aligned."""
    n0 = a.shape[axis]
    if n == n0:
        return a
    shape = list(a.shape)
    shape[axis] = n
    out = a.new_zeros(shape)
    out.narrow(axis, n // 2 - n0 // 2, n0).copy_(a)
    return out


def extract_mid(a, n: int, axis: int):
    """Extract the centred length-`n` window along `axis` (a view)."""
    n0 = a.shape[axis]
    if n == n0:
        return a
    return a.narrow(axis, n0 // 2 - n // 2, n)


def fft(a, axis: int):
    """Centred-zero FFT along one axis: fftshift(fft(ifftshift(a)))."""
    return torch.fft.fftshift(
        torch.fft.fft(torch.fft.ifftshift(a, dim=axis), dim=axis), dim=axis
    )


def ifft(a, axis: int):
    """Centred-zero inverse FFT along one axis."""
    return torch.fft.fftshift(
        torch.fft.ifft(torch.fft.ifftshift(a, dim=axis), dim=axis), dim=axis
    )


def _is_scalar(shift) -> bool:
    return not isinstance(shift, torch.Tensor)


def _row_index(a, axis: int, length: int, base, shift, mod: int):
    """``(base + arange(length) + shift) % mod`` as an int64 index that
    broadcasts against `a` with `length` along `axis`; `shift` is a tensor
    aligned with a's leading dimensions."""
    ax = axis % a.ndim
    shift = torch.as_tensor(shift, dtype=torch.int64, device=a.device)
    if shift.ndim > ax:
        raise ValueError(
            f"offset tensor of shape {tuple(shift.shape)} must align with "
            f"the dimensions before axis {ax} of a {a.ndim}-d tensor"
        )
    s = shift.reshape(tuple(shift.shape) + (1,) * (a.ndim - shift.ndim))
    ar_shape = [1] * a.ndim
    ar_shape[ax] = length
    ar = torch.arange(length, dtype=torch.int64, device=a.device)
    return torch.remainder(base + ar.reshape(ar_shape) + s, mod), ax


def roll_axis(a, shift, axis: int):
    """``torch.roll`` along one axis, with one shift per batch row when
    `shift` is a tensor."""
    if _is_scalar(shift):
        return torch.roll(a, int(shift), dims=axis)
    n = a.shape[axis]
    idx, ax = _row_index(a, axis, n, 0, -shift, n)
    return torch.gather(a, ax, idx.expand(a.shape))


def wrapped_extract(a, n: int, shift, axis: int):
    """Extract the length-`n` centre window of `a` after a circular shift.

    Equivalent to ``extract_mid(roll(a, -shift, axis), n, axis)`` but moves
    only `n` elements: one contiguous slice, or two where the window wraps.
    """
    size = a.shape[axis]
    if _is_scalar(shift):
        start = (size // 2 - n // 2 + int(shift)) % size
        if start + n <= size:
            return a.narrow(axis, start, n)
        head = a.narrow(axis, start, size - start)
        return torch.cat([head, a.narrow(axis, 0, n - (size - start))], axis)
    idx, ax = _row_index(a, axis, n, size // 2 - n // 2, shift, size)
    out_shape = list(a.shape)
    out_shape[ax] = n
    return torch.gather(a, ax, idx.expand(out_shape))


def wrapped_embed(a, n: int, shift, axis: int):
    """Embed `a` into the centre of a length-`n` zero array, then shift.

    Equivalent to ``roll(pad_mid(a, n, axis), shift, axis)`` with
    wraparound, but moves only ``a.shape[axis]`` elements. Adjoint of
    :func:`wrapped_extract`: the part of `a` that runs past the end folds
    back onto the head (``n >= a.shape[axis]``, so the positions are
    distinct and the fold is a placement).
    """
    m = a.shape[axis]
    out_shape = list(a.shape)
    out_shape[axis] = n
    out = a.new_zeros(out_shape)
    if _is_scalar(shift):
        start = (n // 2 - m // 2 + int(shift)) % n
        first = min(m, n - start)
        out.narrow(axis, start, first).copy_(a.narrow(axis, 0, first))
        if first < m:
            out.narrow(axis, 0, m - first).copy_(
                a.narrow(axis, first, m - first)
            )
        return out
    idx, ax = _row_index(a, axis, m, n // 2 - m // 2, shift, n)
    return out.scatter_(ax, idx.expand(a.shape), a)


def wrapped_embed_add_(out, a, shift: int, axis: int):
    """``out += wrapped_embed(a, out.shape[axis], shift, axis)``, in place.

    Touches only the ``a.shape[axis]`` positions of the window, so a
    streaming accumulator takes one small summand at a time without a
    full-size zero buffer. `shift` is a Python int.
    """
    n = out.shape[axis]
    m = a.shape[axis]
    start = (n // 2 - m // 2 + int(shift)) % n
    first = min(m, n - start)
    out.narrow(axis, start, first).add_(a.narrow(axis, 0, first))
    if first < m:
        out.narrow(axis, 0, m - first).add_(a.narrow(axis, first, m - first))
    return out
