"""Numpy twins of the L0 primitives (``backend="numpy"``).

A copy of the JAX package's ``swiftly_tpu/ops/numpy_backend.py``: the same
signatures and semantics as :mod:`swiftly_tpu_torch.ops.primitives`,
executed eagerly with numpy. This is the host reference backend: it runs
anywhere, keeps full float64 precision, and cross-checks the torch
backends.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "broadcast_along",
    "extract_mid",
    "fft",
    "ifft",
    "pad_mid",
    "roll_axis",
    "wrapped_extract",
    "wrapped_embed",
]


def ndim(a) -> int:
    """Logical dimensionality of `a`."""
    return a.ndim


def broadcast_along(vec, ndim: int, axis: int):
    """Reshape a 1D vector so it broadcasts along `axis` of an `ndim` array."""
    shape = [1] * ndim
    shape[axis] = -1
    return np.reshape(vec, shape)


def pad_mid(a, n: int, axis: int):
    """Zero-pad `a` to size `n` along `axis`, keeping the centre aligned."""
    n0 = a.shape[axis]
    if n == n0:
        return a
    before = n // 2 - n0 // 2
    pads = [(0, 0)] * a.ndim
    pads[axis] = (before, n - n0 - before)
    return np.pad(a, pads)


def extract_mid(a, n: int, axis: int):
    """Extract the centred length-`n` window along `axis`."""
    n0 = a.shape[axis]
    if n == n0:
        return a
    start = n0 // 2 - n // 2
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(start, start + n)
    return a[tuple(sl)]


def fft(a, axis: int):
    """Centred-zero FFT along one axis."""
    return np.fft.fftshift(
        np.fft.fft(np.fft.ifftshift(a, axes=axis), axis=axis), axes=axis
    )


def ifft(a, axis: int):
    """Centred-zero inverse FFT along one axis."""
    return np.fft.fftshift(
        np.fft.ifft(np.fft.ifftshift(a, axes=axis), axis=axis), axes=axis
    )


def roll_axis(a, shift, axis: int):
    """np.roll along one axis."""
    return np.roll(a, int(shift), axis=axis)


def wrapped_extract(a, n: int, shift, axis: int):
    """Gather the length-`n` centre window of `a` after a circular shift."""
    size = a.shape[axis]
    idx = (size // 2 - n // 2 + np.arange(n) + int(shift)) % size
    return np.take(a, idx, axis=axis)


def wrapped_embed(a, n: int, shift, axis: int):
    """Scatter `a` into the centre of a length-`n` zero array, then shift."""
    m = a.shape[axis]
    idx = (n // 2 - m // 2 + np.arange(m) + int(shift)) % n
    moved = np.moveaxis(a, axis, 0)
    out = np.zeros((n,) + moved.shape[1:], dtype=a.dtype)
    out[idx] = moved
    return np.moveaxis(out, 0, axis)
