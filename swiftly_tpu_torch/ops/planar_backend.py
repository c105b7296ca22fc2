"""Planar-complex backend: complex tensors as (..., 2) real pairs, FFTs as
matmuls (``backend="planar"``).

The torch twin of the JAX package's ``swiftly_tpu/ops/planar_backend.py``.
Every complex array is a real tensor with a trailing length-2 axis (re, im)
and the centred FFT is a product with a precomputed DFT matrix:

* n <= 1024: one direct centred DFT, whose four real products run in the
  hand-written planar complex-matmul kernel (``ops/kernels.py``, kernel
  B3: the port of ``cmatmul_pallas``);
* larger n: the four-step factorisation n = n1*n2, whose two complex
  contractions are plain ``torch.matmul`` products (the JAX package leaves
  them to XLA outside any Pallas kernel).

The module implements the same namespace protocol as
:mod:`swiftly_tpu_torch.ops.primitives` (``ndim``, ``broadcast_along``,
``pad_mid``, ``extract_mid``, ``fft``, ``ifft``, ``roll_axis``,
``wrapped_extract``, ``wrapped_embed``), so the ``SwiftlyCore`` math runs
on it unchanged. Axes are logical (the re/im axis is not counted); negative
axes count from the last logical axis.

Precision: float32 products accumulate in float32 with no TF32 (the twin
of ``Precision.HIGHEST``); float64 for the exactness tests.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import primitives as tpk
from .kernels import cmatmul

__all__ = [
    "broadcast_along",
    "extract_mid",
    "fft",
    "from_planar",
    "ifft",
    "ndim",
    "pad_mid",
    "roll_axis",
    "set_matmul_precision",
    "to_planar",
    "wrapped_embed",
    "wrapped_embed_add_",
    "wrapped_extract",
]

# Largest size transformed by a single direct DFT matmul; larger sizes are
# factored n = n1*n2 with both factors <= this.
_DIRECT_MAX = 1024


def set_matmul_precision():
    """Full-f32 matmuls: no TF32 in cuBLAS (the twin of the JAX package's
    ``Precision.HIGHEST``, ``planar_backend.py:158-175``). TF32 keeps about
    three decimal digits, which would degrade every FFT to ~1e-3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def to_planar(a, dtype=torch.float32, device="cpu"):
    """Convert a complex array (numpy or torch) to a planar (..., 2) tensor."""
    if isinstance(a, torch.Tensor):
        if not a.is_complex():
            a = a.to(torch.complex128)
        return torch.view_as_real(a).to(device=device, dtype=dtype)
    a = np.asarray(a)
    if a.dtype not in (np.complex64, np.complex128):
        a = a.astype(np.complex128)
    # a zero-copy (re, im) view of the input; one copy (cast and move) out
    planar = torch.view_as_real(torch.from_numpy(np.ascontiguousarray(a)))
    return planar.to(device=device, dtype=dtype, copy=True)


def from_planar(a) -> np.ndarray:
    """Convert a planar (..., 2) tensor or array back to numpy complex."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a)
    return a[..., 0] + 1j * a[..., 1]


def ndim(a) -> int:
    """Logical (complex) dimensionality: the trailing re/im axis is not a
    data dimension."""
    return a.ndim - 1


def _phys(axis: int) -> int:
    """Physical axis of a logical one: negative axes skip the re/im axis."""
    return axis - 1 if axis < 0 else axis


def broadcast_along(vec, ndim: int, axis: int):
    """Reshape a real 1D window so it broadcasts along logical `axis` and
    over both re/im planes."""
    shape = [1] * (ndim + 1)
    shape[axis % ndim] = -1
    return vec.reshape(shape)


def pad_mid(a, n: int, axis: int):
    return tpk.pad_mid(a, n, _phys(axis))


def extract_mid(a, n: int, axis: int):
    return tpk.extract_mid(a, n, _phys(axis))


def roll_axis(a, shift, axis: int):
    return tpk.roll_axis(a, shift, _phys(axis))


def wrapped_extract(a, n: int, shift, axis: int):
    return tpk.wrapped_extract(a, n, shift, _phys(axis))


def wrapped_embed(a, n: int, shift, axis: int):
    return tpk.wrapped_embed(a, n, shift, _phys(axis))


def wrapped_embed_add_(out, a, shift: int, axis: int):
    return tpk.wrapped_embed_add_(out, a, shift, _phys(axis))


# ---------------------------------------------------------------------------
# Matmul FFT
# ---------------------------------------------------------------------------


def _factor(n: int):
    """Split n = n1*n2 with both factors <= _DIRECT_MAX, taking the
    LARGEST valid n1 (smallest n2), as the JAX package does."""
    for n2 in range(2, int(np.sqrt(n)) + 1):
        if n % n2 == 0 and n // n2 <= _DIRECT_MAX:
            return n // n2, n2
    raise ValueError(
        f"FFT size {n} cannot be factored into factors <= {_DIRECT_MAX}"
    )


@functools.lru_cache(maxsize=None)
def _dft_matrix(n: int, sign: int, centred: bool) -> tuple[np.ndarray, np.ndarray]:
    """(re, im) of the DFT matrix, float64 (as ``planar_backend.py:128-142``).

    With `centred`, the fftshift/ifftshift index shifts and (for the
    inverse) the 1/n scale are folded into the matrix, so a centred
    transform is the bare matmul: W[j, k] = exp(sign*2πi (j-c)(k-c)/n)/s
    with c = n//2, s = n if sign > 0 else 1.
    """
    idx = np.arange(n) - (n // 2 if centred else 0)
    w = np.exp(sign * 2j * np.pi * np.outer(idx, idx % n) / n)
    if centred and sign > 0:
        w = w / n
    return np.ascontiguousarray(w.real), np.ascontiguousarray(w.imag)


@functools.lru_cache(maxsize=None)
def _twiddle(n1: int, n2: int, sign: int) -> tuple[np.ndarray, np.ndarray]:
    """(re, im) of T[k1, i2] = exp(sign*2πi k1 i2/(n1 n2)), float64, with
    the inverse transform's 1/n scale folded in."""
    k1i2 = np.outer(np.arange(n1), np.arange(n2))
    t = np.exp(sign * 2j * np.pi * k1i2 / (n1 * n2))
    if sign > 0:
        t = t / (n1 * n2)
    return np.ascontiguousarray(t.real), np.ascontiguousarray(t.imag)


@functools.lru_cache(maxsize=64)
def _planes(kind: str, args: tuple, dtype, device: str):
    """A float64 numpy matrix pair cast to `dtype` on `device` (cached:
    the constants are built once per size, as XLA bakes them in)."""
    build = _dft_matrix if kind == "dft" else _twiddle
    return tuple(
        torch.from_numpy(m).to(device=device, dtype=dtype)
        for m in build(*args)
    )


def _cmatmul(ar, ai, br, bi):
    """``(ar + i ai) @ (br + i bi)`` as four real ``torch.matmul`` products
    ("4mul"), the factored FFT's contractions."""
    return (
        torch.matmul(ar, br) - torch.matmul(ai, bi),
        torch.matmul(ar, bi) + torch.matmul(ai, br),
    )


def _fft_direct_centred(z, sign: int):
    """Centred DFT along the second-to-last axis of planar z (..., n, 2):
    one planar complex matmul in the B3 kernel, over every leading row."""
    n = z.shape[-2]
    wr, wi = _planes("dft", (n, sign, True), z.dtype, str(z.device))
    lead = z.shape[:-2]
    zr = z[..., 0].reshape(-1, n).contiguous()
    zi = z[..., 1].reshape(-1, n).contiguous()
    outr, outi = cmatmul(zr, zi, wr, wi)
    return torch.stack([outr, outi], dim=-1).reshape(lead + (n, 2))


def _fft_factored(z, sign: int):
    """Uncentred DFT (four-step n = n1*n2) along the second-to-last axis
    of planar z; the inverse 1/n scale is folded into the twiddle.

    The reference's steps (``planar_backend.py:239-269``) in a transposed
    layout that suits ``torch.matmul``: the big n1-point DFT is one
    [rows*n2, n1] x [n1, n1] product, the small n2-point DFT a product
    with an [n2, n2] matrix, and the result lands in output order.
    """
    n = z.shape[-2]
    n1, n2 = _factor(n)
    dev, dt = str(z.device), z.dtype
    # i = i2 + n2*i1: split the index into (i1, i2), then lay out (i2, i1)
    xr = z[..., 0].unflatten(-1, (n1, n2)).transpose(-1, -2).contiguous()
    xi = z[..., 1].unflatten(-1, (n1, n2)).transpose(-1, -2).contiguous()

    # Step 1: DFT over i1 -> (..., i2, k1)
    w1r, w1i = _planes("dft", (n1, sign, False), dt, dev)
    ar, ai = _cmatmul(xr, xi, w1r, w1i)
    del xr, xi

    # Step 2: twiddle T[k1, i2] (elementwise, transposed)
    tr, ti = _planes("twiddle", (n1, n2, sign), dt, dev)
    tr, ti = tr.T, ti.T
    br = ar * tr - ai * ti
    bi = ar * ti + ai * tr
    del ar, ai

    # Step 3: DFT over i2 -> (..., k2, k1), i.e. W2^T @ b
    w2r, w2i = _planes("dft", (n2, sign, False), dt, dev)
    cr, ci = _cmatmul(w2r.T, w2i.T, br, bi)
    del br, bi

    # Output index k = k1 + n1*k2: (k2, k1) flattens in output order
    return torch.stack([cr, ci], dim=-1).reshape(z.shape[:-2] + (n, 2))


def _fft_centred(a, axis: int, sign: int):
    ax = _phys(axis) % a.ndim
    n = a.shape[ax]
    z = a.movedim(ax, -2)
    if n <= _DIRECT_MAX:
        z = _fft_direct_centred(z, sign)
    else:
        z = torch.roll(z, -(n // 2), dims=-2)  # ifftshift
        z = _fft_factored(z, sign)
        z = torch.roll(z, n // 2, dims=-2)  # fftshift
    return z.movedim(-2, ax)


def fft(a, axis: int):
    """Centred-zero FFT along logical `axis` of a planar tensor."""
    return _fft_centred(a, axis, -1)


def ifft(a, axis: int):
    """Centred-zero inverse FFT along logical `axis` of a planar tensor."""
    return _fft_centred(a, axis, +1)
