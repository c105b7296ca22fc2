"""Host-side wrap-around slicing for big-array IO (no rolls materialised).

When facets/subgrids are read out of (or written into) a full-size image or
grid array held on disk or host memory, rolling the full N² array to centre a
chunk would defeat the whole point of the streaming transform. Instead the
wrapped window [centre+offset-w/2, centre+offset+w/2) is decomposed into at
most two contiguous intervals modulo the array size, which are then copied
slice-by-slice.

A copy of the JAX package's ``swiftly_tpu/ops/io_slices.py`` (numpy only):
``create_slice``, ``roll_and_extract_mid``, ``roll_and_extract_mid_axis``,
via a generic modular interval split.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "create_slice",
    "roll_and_extract_mid",
    "roll_and_extract_mid_axis",
]


def create_slice(fill, axis_val, dims: int, axis: int) -> tuple:
    """n-dim index tuple: `axis_val` at `axis`, `fill` everywhere else.

    Parity: reference ``create_slice`` (``fourier_algorithm.py:10-35``).
    """
    if not isinstance(dims, int) or not isinstance(axis, int):
        raise ValueError("create_slice: dims and axis must be integers")
    return tuple(axis_val if d == axis else fill for d in range(dims))


def roll_and_extract_mid(size: int, offset: int, window: int) -> list:
    """Slices covering the centred window of a rolled axis, without rolling.

    Returns 1 or 2 slices of a length-`size` axis that, concatenated, equal
    ``extract_mid(roll(x, -offset), window)``. The window
    ``[size//2 + offset - window//2, ... + window)`` is split into contiguous
    intervals modulo `size`.

    Parity: reference ``roll_and_extract_mid``
    (``fourier_algorithm.py:141-175``).
    """
    if window > size:
        raise ValueError(f"Window {window} larger than axis size {size}")
    start = size // 2 + offset - window // 2
    end = start + window
    # Reduce so that start lies in [0, size)
    shift = (start % size) - start
    start += shift
    end += shift
    if end <= size:
        return [slice(start, end)]
    return [slice(start, size), slice(0, end - size)]


def roll_and_extract_mid_axis(data, offset: int, window: int, axis: int):
    """Gather the wrapped centred window along `axis` of a host array.

    Equivalent to ``extract_mid(np.roll(data, -offset, axis), window, axis)``
    but copies only the window. Parity: reference
    ``roll_and_extract_mid_axis`` (``fourier_algorithm.py:178-215``).
    """
    slices = roll_and_extract_mid(data.shape[axis], offset, window)
    out_shape = list(data.shape)
    out_shape[axis] = window
    out = np.empty(out_shape, dtype=data.dtype)
    pos = 0
    for sl in slices:
        n = sl.stop - sl.start
        dst = create_slice(slice(None), slice(pos, pos + n), data.ndim, axis)
        src = create_slice(slice(None), sl, data.ndim, axis)
        out[dst] = data[src]
        pos += n
    return out
