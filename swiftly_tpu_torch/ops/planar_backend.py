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

Precision: ``SWIFTLY_PRECISION`` (``highest`` | ``high`` | ``default``,
``matmul_precision``) and ``SWIFTLY_CMATMUL`` (``4mul`` | ``karatsuba``,
``_cmatmul_algo``) govern the products the JAX package leaves to XLA, and
only those: the factored FFT's contractions here and the streamed
executors' facet pass, einsum bodies and plain folds
(``parallel/streamed.py``). Every governed product goes through
``contract``: ``highest`` is IEEE float32 (TF32 off, the twin of
``Precision.HIGHEST``), ``default`` one TF32 pass (each operand rounded
to TF32's 10-bit mantissa, as the TPU's one bf16 pass rounds to 7 bits),
``high`` three TF32 passes over a hi/lo split (the TPU's bf16 x 3).
float64 ignores the knob, as XLA does. The hand-written kernels (B1-B4,
``grid``) are the counterparts of the JAX package's Pallas kernels,
which hard-code ``HIGHEST``: they stay IEEE float32 under every setting,
and so does the direct DFT (n <= 1024, kernel B3, always 4mul).
A core or executor reads both knobs when it is built and keeps them
(``SwiftlyCore.precision`` / ``.cmatmul``; its ``_p`` is this module with
the FFTs bound to them, ``bound``).
"""

from __future__ import annotations

import functools
import os
import sys
import threading
from typing import NamedTuple

import numpy as np
import torch

from . import primitives as tpk
from .kernels import cmatmul

__all__ = [
    "PRECISION_RMS_BUDGET_REL",
    "Split",
    "bound",
    "broadcast_along",
    "contract",
    "contract_plain",
    "extract_mid",
    "fft",
    "from_planar",
    "ifft",
    "ndim",
    "pad_mid",
    "presplit",
    "matmul_precision",
    "roll_axis",
    "round_tf32",
    "to_planar",
    "wrapped_embed",
    "wrapped_embed_add_",
    "wrapped_extract",
]

# Largest size transformed by a single direct DFT matmul; larger sizes are
# factored n = n1*n2 with both factors <= this.
_DIRECT_MAX = 1024


# The relative-RMS budget of a forward against the direct-DFT oracle under
# each setting (relative RMS = absolute RMS x N^2, the unit-source
# normalisation): a copy of the JAX package's ``PRECISION_RMS_BUDGET_REL``
# (``bench.py``), its loose bounds on a lost flag or a dtype downcast.
PRECISION_RMS_BUDGET_REL = {
    "highest": 3e-4,
    "high": 3e-2,
    "default": 3e-2,
}


def matmul_precision() -> str:
    """The governed products' precision, ``SWIFTLY_PRECISION``
    (highest|high|default, default highest; the JAX package's
    ``planar_backend.py:164-176``). Read when a core or executor is
    built."""
    name = os.environ.get("SWIFTLY_PRECISION", "highest").lower()
    if name not in ("default", "high", "highest"):
        raise ValueError(
            f"SWIFTLY_PRECISION must be default|high|highest, got {name!r}"
        )
    return name


def _cmatmul_algo() -> str:
    """The factored FFT's and the einsum bodies' complex-product algorithm,
    ``SWIFTLY_CMATMUL``: "4mul" (four real products, the most accurate) or
    "karatsuba" (three, ~2x the float32 rounding error). Read when a core
    or executor is built."""
    algo = os.environ.get("SWIFTLY_CMATMUL", "4mul")
    if algo not in ("4mul", "karatsuba"):
        raise ValueError(f"SWIFTLY_CMATMUL must be 4mul|karatsuba, got {algo!r}")
    return algo


# -- the contraction helper --------------------------------------------------
#
# cuBLAS takes TF32 from one process-wide flag
# (torch.backends.cuda.matmul.allow_tf32), read when a product launches.
# Every governed product on the card launches under _TF32_LOCK with the
# flag set to its own mode and restored in a `finally`: a TF32 pass holds
# the lock from setting the flag to restoring it, and an IEEE product
# launches under the lock with the flag forced off, so no governed product
# of another executor or thread can launch inside another's window, and
# an exception restores the flag. The lock is held for the launch only
# (cuBLAS fixes the math mode when it enqueues), not the device time. The
# port's other float32 work on the card is its hand-written kernels, which
# no flag reaches.

_TF32_LOCK = threading.Lock()


def round_tf32(x):
    """float32 `x` rounded to TF32's 10-bit mantissa (to nearest, ties to
    even), on `x`'s device; the result is a float32 tensor that TF32 holds
    exactly."""
    bits = x.contiguous().view(torch.int32)
    bits = bits + (0x0FFF + ((bits >> 13) & 1))
    return (bits & ~0x1FFF).view(torch.float32)


def _product(a, b, spec):
    return torch.matmul(a, b) if spec is None else torch.einsum(spec, a, b)


def _launch(a, b, spec, tf32):
    """One cuBLAS product on the card with TF32 `tf32`, under the lock."""
    flags = torch.backends.cuda.matmul
    with _TF32_LOCK:
        prev = flags.allow_tf32
        flags.allow_tf32 = tf32
        try:
            return _product(a, b, spec)
        finally:
            flags.allow_tf32 = prev


def _tf32_pass(a, b, spec, plain):
    """One TF32 pass: cuBLAS with TF32 on the card, else (or with `plain`)
    the plain version, each operand rounded to TF32 and an IEEE product."""
    if a.device.type != "cuda":
        return _product(round_tf32(a), round_tf32(b), spec)
    if plain:
        return _launch(round_tf32(a), round_tf32(b), spec, False)
    return _launch(a, b, spec, True)


class Split(NamedTuple):
    """A float32 operand split for ``high``: ``hi`` rounded to TF32 and
    ``lo = x - hi`` (exact). `presplit` makes one, so that an operand
    used in many products is split once."""
    hi: torch.Tensor
    lo: torch.Tensor


def presplit(x, precision):
    """`x` as `contract` takes it at `precision`: a `Split` for ``high``
    on a float32 tensor, else `x` itself."""
    if precision != "high" or x.dtype != torch.float32:
        return x
    hi = round_tf32(x)
    return Split(hi, x - hi)


def _real_contract(a, b, precision, spec, plain):
    if precision == "default":
        return _tf32_pass(a, b, spec, plain)
    # high: x = hi + lo with hi = x rounded to TF32 (lo = x - hi is exact),
    # hi.hi + hi.lo + lo.hi, the small terms summed first
    ah, al = a if isinstance(a, Split) else presplit(a, "high")
    bh, bl = b if isinstance(b, Split) else presplit(b, "high")
    return ((_tf32_pass(ah, bl, spec, plain) + _tf32_pass(al, bh, spec, plain))
            + _tf32_pass(ah, bh, spec, plain))


def contract(a, b, precision="highest", spec=None, plain=False):
    """``torch.matmul(a, b)`` (or ``torch.einsum(spec, a, b)``) at the
    governed products' `precision`: "highest" IEEE, "default" one TF32
    pass, "high" three. float64 ignores the knob; a complex64 operand runs
    as real products on its planes (the TF32 modes' four real products).
    `plain` runs the TF32 passes' plain version on any device. Under
    ``high`` either operand may be a `Split` (`presplit`)."""
    if isinstance(a, Split) or isinstance(b, Split):
        return _real_contract(a, b, precision, spec, plain)
    dt = a.dtype
    if precision == "highest" or dt in (torch.float64, torch.complex128):
        if a.device.type != "cuda":
            return _product(a, b, spec)
        return _launch(a, b, spec, False)
    if precision not in ("high", "default"):
        raise ValueError(
            f"precision must be default|high|highest, got {precision!r}")
    if not (a.is_complex() or b.is_complex()):
        return _real_contract(a, b, precision, spec, plain)
    ar, ai = (a.real, a.imag) if a.is_complex() else (a, None)
    br, bi = (b.real, b.imag) if b.is_complex() else (b, None)

    def f(x, y):
        return _real_contract(x.contiguous(), y.contiguous(), precision,
                              spec, plain)

    re = f(ar, br)
    im = None
    if ai is not None and bi is not None:
        re = re - f(ai, bi)
    if bi is not None:
        im = f(ar, bi)
    if ai is not None:
        im = f(ai, br) if im is None else im + f(ai, br)
    return torch.complex(re, im)


def contract_plain(a, b, precision="highest", spec=None):
    """`contract`'s plain version: TF32 passes as rounded operands and IEEE
    products on the tensors' own device (what the CPU runs)."""
    return contract(a, b, precision, spec, plain=True)


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
def _planes(kind: str, args: tuple, dtype, device: str, karatsuba=False):
    """A float64 numpy matrix pair cast to `dtype` on `device` (cached:
    the constants are built once per size, as XLA bakes them in); with
    `karatsuba` also the sums Karatsuba takes, ``(wr, wi, wr + wi,
    wi - wr)``."""
    if karatsuba:
        wr, wi = _planes(kind, args, dtype, device)
        return wr, wi, wr + wi, wi - wr
    build = _dft_matrix if kind == "dft" else _twiddle
    return tuple(
        torch.from_numpy(m).to(device=device, dtype=dtype)
        for m in build(*args)
    )


def _cmatmul(zr, zi, w, precision="highest", algo="4mul", spec=None,
             w_left=False):
    """The complex product of data ``z = zr + i zi`` and matrix `w`
    (``z @ w``, or ``w @ z`` with `w_left`; ``torch.einsum(spec, z, w)``
    with `spec`), each real product through `contract` at `precision`
    (the JAX package's ``_cmatmul``, ``planar_backend.py:192-211``).

    "4mul": four real products, `w` = (wr, wi). "karatsuba": three, `w` =
    (wr, wi, wr + wi, wi - wr) (``_planes(..., karatsuba=True)``):
    k1 = (zr+zi)·wr, k2 = zi·(wr+wi), k3 = zr·(wi-wr);
    re = k1 - k2, im = k1 + k3."""
    if w_left:
        def f(x, m):
            return contract(m, x, precision, spec)
    else:
        def f(x, m):
            return contract(x, m, precision, spec)
    if algo == "karatsuba":
        k1 = f(zr + zi, w[0])
        k2 = f(zi, w[2])
        k3 = f(zr, w[3])
        return k1 - k2, k1 + k3
    # each operand enters two products: under "high" split it once
    zr, zi, wr, wi = (presplit(x, precision) for x in (zr, zi, w[0], w[1]))
    return f(zr, wr) - f(zi, wi), f(zr, wi) + f(zi, wr)


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


def _fft_factored(z, sign: int, precision="highest", algo="4mul"):
    """Uncentred DFT (four-step n = n1*n2) along the second-to-last axis
    of planar z; the inverse 1/n scale is folded into the twiddle.

    The reference's steps (``planar_backend.py:239-269``) in a transposed
    layout that suits ``torch.matmul``: the big n1-point DFT is one
    [rows*n2, n1] x [n1, n1] product, the small n2-point DFT a product
    with an [n2, n2] matrix, and the result lands in output order. Both
    contractions are governed products (`_cmatmul`).
    """
    n = z.shape[-2]
    n1, n2 = _factor(n)
    dev, dt = str(z.device), z.dtype
    kara = algo == "karatsuba"
    # i = i2 + n2*i1: split the index into (i1, i2), then lay out (i2, i1)
    xr = z[..., 0].unflatten(-1, (n1, n2)).transpose(-1, -2).contiguous()
    xi = z[..., 1].unflatten(-1, (n1, n2)).transpose(-1, -2).contiguous()

    # Step 1: DFT over i1 -> (..., i2, k1)
    w1 = _planes("dft", (n1, sign, False), dt, dev, kara)
    ar, ai = _cmatmul(xr, xi, w1, precision, algo)
    del xr, xi

    # Step 2: twiddle T[k1, i2] (elementwise, transposed)
    tr, ti = _planes("twiddle", (n1, n2, sign), dt, dev)
    tr, ti = tr.T, ti.T
    br = ar * tr - ai * ti
    bi = ar * ti + ai * tr
    del ar, ai

    # Step 3: DFT over i2 -> (..., k2, k1), i.e. W2^T @ b
    w2 = tuple(m.T for m in _planes("dft", (n2, sign, False), dt, dev, kara))
    cr, ci = _cmatmul(br, bi, w2, precision, algo, w_left=True)
    del br, bi

    # Output index k = k1 + n1*k2: (k2, k1) flattens in output order
    return torch.stack([cr, ci], dim=-1).reshape(z.shape[:-2] + (n, 2))


def _fft_centred(a, axis: int, sign: int, precision="highest", algo="4mul"):
    ax = _phys(axis) % a.ndim
    n = a.shape[ax]
    z = a.movedim(ax, -2)
    if n <= _DIRECT_MAX:
        z = _fft_direct_centred(z, sign)
    else:
        z = torch.roll(z, -(n // 2), dims=-2)  # ifftshift
        z = _fft_factored(z, sign, precision, algo)
        z = torch.roll(z, n // 2, dims=-2)  # fftshift
    return z.movedim(-2, ax)


def fft(a, axis: int):
    """Centred-zero FFT along logical `axis` of a planar tensor (IEEE
    float32 products, 4mul; a core's ``_p.fft`` takes its knobs)."""
    return _fft_centred(a, axis, -1)


def ifft(a, axis: int):
    """Centred-zero inverse FFT along logical `axis` of a planar tensor."""
    return _fft_centred(a, axis, +1)


class _Bound:
    """This module's namespace with `fft` / `ifft` bound to one precision
    and complex-product algorithm: a core's ``_p``. Every other name is
    the module's."""

    def __init__(self, precision, cmatmul):
        self.precision = precision
        self.cmatmul = cmatmul

    def __getattr__(self, name):
        return getattr(sys.modules[__name__], name)

    def __reduce__(self):
        return bound, (self.precision, self.cmatmul)

    def __repr__(self):
        return f"planar_backend.bound({self.precision!r}, {self.cmatmul!r})"

    def fft(self, a, axis: int):
        return _fft_centred(a, axis, -1, self.precision, self.cmatmul)

    def ifft(self, a, axis: int):
        return _fft_centred(a, axis, +1, self.precision, self.cmatmul)


@functools.lru_cache(maxsize=None)
def bound(precision="highest", cmatmul="4mul"):
    """The namespace a core at these knobs computes with (one per pair)."""
    if precision not in PRECISION_RMS_BUDGET_REL:
        raise ValueError(
            f"precision must be default|high|highest, got {precision!r}")
    if cmatmul not in ("4mul", "karatsuba"):
        raise ValueError(f"cmatmul must be 4mul|karatsuba, got {cmatmul!r}")
    return _Bound(precision, cmatmul)
