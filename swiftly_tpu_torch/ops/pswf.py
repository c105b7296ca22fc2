"""Prolate-spheroidal wave function (PSWF) window precomputation.

Host-side (scipy) — the PSWF is evaluated once per configuration at facet
resolution and shipped to the device as constants:

* ``Fb`` — reciprocal of the PSWF: the convolution-correction applied to
  facets (image space).
* ``Fn`` — the PSWF subsampled at grid resolution: the window applied to
  facet contributions (grid space).

A copy of the JAX package's ``swiftly_tpu/ops/pswf.py``; the two packages
must produce bit-identical windows (the port's tests assert it). See VLA
Scientific Memoranda 129, 131, 132 for the PSWF background.
"""

from __future__ import annotations

import numpy as np
import scipy.special

__all__ = ["coordinates", "pswf_samples", "pswf_fb", "pswf_fn"]

# scipy.special.pro_ang1 can crash when asked to fill very large arrays in
# one call; evaluating in bounded chunks is reliable at every size we use.
_CHUNK = 500


def coordinates(n: int) -> np.ndarray:
    """1D coordinate array spanning [-0.5, 0.5) with 0 at index n//2.

    Host-side numpy, a copy of the JAX package's
    ``swiftly_tpu.ops.primitives.coordinates``.
    """
    half = n // 2
    return (np.arange(n) - half) / n


def pswf_samples(W: float, yN_size: int) -> np.ndarray:
    """Zeroth-order PSWF sampled at facet resolution.

    Evaluated on 2*coordinates(yN_size), i.e. [-1, 1). The first sample
    (at exactly -1) is defined as 0.

    :param W: grid-space support of the window (the tuning parameter)
    :param yN_size: padded facet size (number of samples)
    """
    x = 2 * coordinates(yN_size)
    out = np.empty(yN_size, dtype=float)
    c = np.pi * W / 2
    for lo in range(1, yN_size, _CHUNK):
        hi = min(lo + _CHUNK, yN_size)
        out[lo:hi] = scipy.special.pro_ang1(0, 0, c, x[lo:hi])[0]
    out[0] = 0.0
    return out


def pswf_fb(pswf: np.ndarray) -> np.ndarray:
    """Facet correction: elementwise reciprocal (skipping the zero sample)."""
    return 1.0 / pswf[1:]


def pswf_fn(pswf: np.ndarray, N: int, xM_size: int, yN_size: int) -> np.ndarray:
    """Contribution window: the PSWF subsampled with stride N/xM_size.

    Result has length xM_size*yN_size/N (the contribution size).
    """
    stride = N // xM_size
    start = (yN_size // 2) % stride
    return pswf[start::stride]
