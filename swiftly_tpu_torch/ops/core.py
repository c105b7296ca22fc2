"""SwiftlyCore — the eight streaming-FT primitives on torch tensors.

The torch twin of the JAX package's ``swiftly_tpu/ops/core.py``:

  facet -> subgrid:  prepare_facet -> extract_from_facet -> add_to_subgrid
                     -> finish_subgrid
  subgrid -> facet:  prepare_subgrid -> extract_from_subgrid -> add_to_facet
                     -> finish_facet

The math lives in module-level functions (``*_math``) parameterised by an
array namespace ``p`` — :mod:`.primitives` (complex torch),
:mod:`.planar_backend` (planar torch) or :mod:`.numpy_backend` (host
float64) — so one formulation serves all three backends.

Batching is written out. Where JAX ``vmap``s a primitive over stacked
facets or subgrids, the port passes the stack itself: per-item axes are
then given counted from the end (-2 and -1 for a 2D item), and each offset
is a Python int shared by the whole stack or an int64 tensor with one
value per leading batch row (see :mod:`.primitives`).

All primitives are linear in their array argument; accumulation order is
therefore irrelevant to the result.
"""

from __future__ import annotations

import numpy as np
import torch

from . import numpy_backend as npk
from . import planar_backend as plk
from . import primitives as tpk
from .pswf import pswf_fb, pswf_fn, pswf_samples

__all__ = [
    "SwiftlyCore",
    "as_torch_dtype",
    "resolve_device",
    "scaled_offset",
    "validate_core_params",
]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another. ``None`` means ``"cuda"``; asking for CUDA on a host
    without it raises rather than running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU by default; "
            "pass device='cpu' to run on the host explicitly"
        )
    return dev


_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}
_REAL_OF = {torch.complex64: torch.float32, torch.complex128: torch.float64}
_COMPLEX_OF = {v: k for k, v in _REAL_OF.items()}


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch, numpy or string dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype)]


def validate_core_params(N: int, xM_size: int, yN_size: int) -> None:
    """Check the divisibility constraints that make offsets exact."""
    if N % yN_size != 0:
        raise ValueError(
            f"Image size {N} must be divisible by padded facet size {yN_size}"
        )
    if N % xM_size != 0:
        raise ValueError(
            f"Image size {N} must be divisible by padded subgrid size {xM_size}"
        )
    if (xM_size * yN_size) % N != 0:
        raise ValueError(
            f"Contribution size xM_size*yN_size/N must be an integer "
            f"(got {xM_size}*{yN_size}/{N})"
        )


# ---------------------------------------------------------------------------
# The eight primitives as pure math functions (``swiftly_tpu/ops/core.py:
# 103-200``). ``p`` is the array namespace; window vectors and sizes are
# explicit arguments.
# ---------------------------------------------------------------------------


def scaled_offset(off, num, N):
    """``floor((off mod N) * num / N)`` — int32-overflow-safe.

    Exactly the JAX package's arithmetic (``swiftly_tpu/ops/core.py:75-100``):
    ``off`` is reduced mod N first (exact, since the result is only used
    mod ``num``), then an 8-bit-limb divmod bounds every partial product
    by ``(N >> 8) * num``. Torch offsets are int64, but the same staging
    keeps the port's results identical to the reference's for every
    catalogue size. Works for Python ints and int64 tensors alike.
    """
    assert (N >> 8) * num < 1 << 31 and (N + num) << 8 < 1 << 31, (N, num)
    r = off % N
    hi, lo = r >> 8, r & 0xFF
    t = hi * num
    q1, r1 = t // N, t % N
    return (q1 << 8) + ((r1 << 8) + lo * num) // N


def prepare_facet_math(p, Fb, yN_size, facet, facet_off, axis):
    """Correct facet by Fb, embed at its offset in the padded frame, iFFT."""
    n = facet.shape[: p.ndim(facet)][axis]  # logical axis: skips a re/im axis
    fb = p.extract_mid(Fb, n, 0)
    weighted = facet * p.broadcast_along(fb, p.ndim(facet), axis)
    embedded = p.wrapped_embed(weighted, yN_size, facet_off, axis)
    return p.ifft(embedded, axis)


def extract_from_facet_math(p, xM_yN_size, N, yN_size, prep_facet, subgrid_off, axis):
    """Down-select the compact contribution of a prepared facet to a subgrid."""
    scaled = scaled_offset(subgrid_off, yN_size, N)
    window = p.wrapped_extract(prep_facet, xM_yN_size, scaled, axis)
    return p.roll_axis(window, scaled, axis)


def add_to_subgrid_math(p, Fn, xM_size, N, contrib, facet_off, axis):
    """Transform one facet contribution into its padded-subgrid summand:
    FFT to grid space, window by Fn, embed at the facet offset."""
    scaled = scaled_offset(facet_off, xM_size, N)
    spectrum = p.roll_axis(p.fft(contrib, axis), -scaled, axis)
    windowed = spectrum * p.broadcast_along(Fn, p.ndim(contrib), axis)
    return p.wrapped_embed(windowed, xM_size, scaled, axis)


def finish_subgrid_math(p, subgrid_size, summed, subgrid_offs):
    """iFFT the summed padded subgrid and cut out the true subgrid, over
    the last ``len(subgrid_offs)`` logical axes."""
    out = summed
    nd = len(subgrid_offs)
    for i, off in enumerate(subgrid_offs):
        axis = i - nd
        out = p.wrapped_extract(p.ifft(out, axis), subgrid_size, off, axis)
    return out


def prepare_subgrid_math(p, xM_size, subgrid, subgrid_offs):
    """Embed a subgrid at its offsets in the padded frame and FFT, over the
    last ``len(subgrid_offs)`` logical axes."""
    out = subgrid
    nd = len(subgrid_offs)
    for i, off in enumerate(subgrid_offs):
        axis = i - nd
        out = p.fft(p.wrapped_embed(out, xM_size, off, axis), axis)
    return out


def extract_from_subgrid_math(p, Fn, xM_yN_size, xM_size, N, prep_subgrid, facet_off, axis):
    """Extract and window the contribution of a prepared subgrid to a facet."""
    scaled = scaled_offset(facet_off, xM_size, N)
    window = p.wrapped_extract(prep_subgrid, xM_yN_size, scaled, axis)
    windowed = window * p.broadcast_along(Fn, p.ndim(window), axis)
    return p.ifft(p.roll_axis(windowed, scaled, axis), axis)


def add_to_facet_math(p, yN_size, N, contrib, subgrid_off, axis):
    """Embed a subgrid contribution in the padded-facet frame for summation."""
    scaled = scaled_offset(subgrid_off, yN_size, N)
    centred = p.roll_axis(contrib, -scaled, axis)
    return p.wrapped_embed(centred, yN_size, scaled, axis)


def finish_facet_math(p, Fb, facet_size, summed, facet_off, axis):
    """FFT the contribution sum, cut the facet window, correct by Fb."""
    fb = p.extract_mid(Fb, facet_size, 0)
    window = p.wrapped_extract(p.fft(summed, axis), facet_size, facet_off, axis)
    return window * p.broadcast_along(fb, p.ndim(window), axis)


# ---------------------------------------------------------------------------
# SwiftlyCore: configuration + window constants + backend dispatch
# ---------------------------------------------------------------------------


def _apply_out(result, out=None, add=False):
    """Reference-compatible ``out=`` handling: writes (or adds) in place."""
    if out is None:
        return result
    if tuple(out.shape) != tuple(result.shape):
        raise ValueError(f"Output shape {out.shape}, expected {result.shape}")
    if isinstance(out, np.ndarray):
        if add:
            out += np.asarray(result)
        else:
            out[...] = np.asarray(result)
        return out
    if add:
        out += result
    else:
        out.copy_(result)
    return out


class SwiftlyCore:
    """Streaming distributed Fourier transform core.

    Holds the configuration (W, N, xM_size, yN_size), the PSWF window
    constants, and the eight per-axis primitives for both directions.
    Three backends, one behavioural contract:

    * ``backend="torch"`` — complex tensors and ``torch.fft`` (the twin of
      the JAX package's ``"jax"``); dtype complex64 (default) or complex128;
    * ``backend="planar"`` — complex data as (..., 2) real pairs, FFTs as
      matmuls through the B3 kernel; dtype float32 (default) or float64;
    * ``backend="numpy"`` — eager float64 host reference.

    :param W: PSWF grid-space support parameter
    :param N: total (virtual) image size
    :param xM_size: padded subgrid size
    :param yN_size: padded facet size
    :param backend: "torch", "planar" or "numpy"
    :param dtype: torch or numpy dtype of the device data
    :param device: torch device of the tensor backends; None means the
        card, and raises where there is none
    """

    def __init__(self, W, N, xM_size, yN_size, backend="torch", dtype=None,
                 device=None):
        validate_core_params(N, xM_size, yN_size)
        pswf = pswf_samples(W, yN_size)
        self._setup(W, N, xM_size, yN_size, pswf_fb(pswf),
                    pswf_fn(pswf, N, xM_size, yN_size), backend, dtype, device)

    @classmethod
    def from_numpy_state(cls, W, N, xM_size, yN_size, Fb, Fn,
                         backend="torch", dtype=None, device=None):
        """A core built from given window constants (numpy float64 arrays,
        e.g. the JAX core's ``_Fb``/``_Fn``) instead of recomputing them."""
        validate_core_params(N, xM_size, yN_size)
        Fb = np.array(Fb, dtype=np.float64)  # a writable copy: e.g. of a
        Fn = np.array(Fn, dtype=np.float64)  # read-only JAX array's buffer
        if Fb.shape != (yN_size - 1,) or Fn.shape != (xM_size * yN_size // N,):
            raise ValueError(
                f"window constants of shapes {Fb.shape}, {Fn.shape} do not "
                f"match yN_size={yN_size}, xM_yN_size={xM_size * yN_size // N}"
            )
        core = cls.__new__(cls)
        core._setup(W, N, xM_size, yN_size, Fb, Fn, backend, dtype, device)
        return core

    def _setup(self, W, N, xM_size, yN_size, fb, fn, backend, dtype, device):
        self.W = W
        self.N = N
        self.xM_size = xM_size
        self.yN_size = yN_size
        self.xM_yN_size = xM_size * yN_size // N
        self.backend = backend
        if backend == "numpy":
            self._p = npk
            self.dtype = np.dtype(complex)
            self.device = None
            self._Fb, self._Fn = fb, fn
            return
        if backend == "native":
            raise NotImplementedError(
                "backend='native' (compiled C++ host kernels) is not ported "
                "yet: ROADMAP A14"
            )
        if backend not in ("torch", "planar"):
            raise ValueError(f"Unknown SwiFTly backend: {backend}")
        self.device = resolve_device(device)
        if backend == "torch":
            self._p = tpk
            dt = torch.complex64 if dtype is None else as_torch_dtype(dtype)
            self.dtype = _COMPLEX_OF.get(dt, dt)
            real = _REAL_OF[self.dtype]
        else:
            self._p = plk
            plk.set_matmul_precision()
            dt = torch.float32 if dtype is None else as_torch_dtype(dtype)
            self.dtype = _REAL_OF.get(dt, dt)
            real = self.dtype
        if real not in (torch.float32, torch.float64):
            raise ValueError(f"Unsupported dtype {dtype!r} for {backend!r}")
        self.real_dtype = real
        self._Fb = torch.as_tensor(fb, dtype=real, device=self.device)
        self._Fn = torch.as_tensor(fn, dtype=real, device=self.device)

    # -- layout properties -------------------------------------------------

    @property
    def subgrid_off_step(self):
        """All subgrid offsets must be multiples of this (= N/yN_size)."""
        return self.N // self.yN_size

    @property
    def facet_off_step(self):
        """All facet offsets must be multiples of this (= N/xM_size)."""
        return self.N // self.xM_size

    def __repr__(self):
        return (
            f"{type(self).__name__}(W={self.W}, N={self.N}, "
            f"xM_size={self.xM_size}, yN_size={self.yN_size}, "
            f"backend={self.backend!r}, device={self.device})"
        )

    # -- data layout ---------------------------------------------------------

    def _prep(self, a):
        """Any input (numpy or torch, complex or planar) in this core's
        layout, dtype and device."""
        if self.backend == "numpy":
            if isinstance(a, torch.Tensor):
                a = a.detach().cpu().numpy()
            return np.asarray(a, dtype=complex)
        if self.backend == "planar":
            if isinstance(a, torch.Tensor):
                if a.is_complex():
                    return plk.to_planar(a, self.dtype, self.device)
                return a.to(device=self.device, dtype=self.dtype)
            a = np.asarray(a)
            if not np.iscomplexobj(a) and a.shape and a.shape[-1] == 2:
                return torch.as_tensor(a).to(device=self.device, dtype=self.dtype)
            if a.dtype.kind == "f":
                # a real plane: moved as it is, its zero imaginary plane
                # made where it lies (the values `to_planar` gives, without
                # the host's complex128 copy)
                re = torch.from_numpy(np.ascontiguousarray(a)).to(
                    device=self.device, dtype=self.dtype)
                return torch.stack([re, torch.zeros_like(re)], -1)
            return plk.to_planar(a, self.dtype, self.device)
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        return a.to(device=self.device, dtype=self.dtype)

    def to_planar(self, a):
        """Convert complex input to this core's planar representation."""
        return plk.to_planar(a, getattr(self, "real_dtype", torch.float64),
                             self.device or "cpu")

    @staticmethod
    def from_planar(a):
        """Convert a planar (..., 2) result back to numpy complex."""
        return plk.from_planar(a)

    def as_complex(self, a) -> np.ndarray:
        """Return any backend's result as a numpy complex array."""
        if self.backend == "planar":
            return plk.from_planar(a)
        if isinstance(a, torch.Tensor):
            return a.detach().cpu().numpy()
        return np.asarray(a)

    # -- facet -> subgrid --------------------------------------------------

    def prepare_facet(self, facet, facet_off, axis, out=None):
        """Prepare a facet for contribution extraction (per axis).

        Expensive (full-size iFFT); done once per facet and reused for
        every subgrid.
        """
        return _apply_out(
            prepare_facet_math(self._p, self._Fb, self.yN_size,
                               self._prep(facet), facet_off, axis),
            out,
        )

    def extract_from_facet(self, prep_facet, subgrid_off, axis, out=None):
        """Extract a facet's compact contribution to one subgrid (per axis)."""
        return _apply_out(
            extract_from_facet_math(self._p, self.xM_yN_size, self.N,
                                    self.yN_size, self._prep(prep_facet),
                                    subgrid_off, axis),
            out,
        )

    def add_to_subgrid(self, facet_contrib, facet_off, axis, out=None):
        """Turn a facet contribution into its padded-subgrid summand;
        with ``out`` given, adds onto it."""
        return _apply_out(
            add_to_subgrid_math(self._p, self._Fn, self.xM_size, self.N,
                                self._prep(facet_contrib), facet_off, axis),
            out,
            add=True,
        )

    def finish_subgrid(self, summed_contribs, subgrid_off, subgrid_size, out=None):
        """Finish a subgrid from summed contributions (all axes at once)."""
        data = self._prep(summed_contribs)
        offs = self._as_offsets(subgrid_off, self._p.ndim(data))
        return _apply_out(
            finish_subgrid_math(self._p, subgrid_size, data, offs), out
        )

    # -- subgrid -> facet --------------------------------------------------

    def prepare_subgrid(self, subgrid, subgrid_off, out=None):
        """Embed + FFT a subgrid into image space (all axes at once)."""
        data = self._prep(subgrid)
        offs = self._as_offsets(subgrid_off, self._p.ndim(data))
        return _apply_out(prepare_subgrid_math(self._p, self.xM_size, data, offs), out)

    def extract_from_subgrid(self, prep_subgrid, facet_off, axis, out=None):
        """Extract a subgrid's windowed contribution to one facet (per axis)."""
        return _apply_out(
            extract_from_subgrid_math(self._p, self._Fn, self.xM_yN_size,
                                      self.xM_size, self.N,
                                      self._prep(prep_subgrid), facet_off, axis),
            out,
        )

    def add_to_facet(self, subgrid_contrib, subgrid_off, axis, out=None):
        """Turn a subgrid contribution into its padded-facet summand;
        with ``out`` given, adds onto it."""
        return _apply_out(
            add_to_facet_math(self._p, self.yN_size, self.N,
                              self._prep(subgrid_contrib), subgrid_off, axis),
            out,
            add=True,
        )

    def finish_facet(self, summed, facet_off, facet_size, axis, out=None):
        """Finish a facet from summed subgrid contributions (per axis)."""
        return _apply_out(
            finish_facet_math(self._p, self._Fb, facet_size,
                              self._prep(summed), facet_off, axis),
            out,
        )

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _as_offsets(off, ndim):
        """Normalise scalar/list offsets to a per-axis list."""
        if isinstance(off, (list, tuple)):
            if len(off) != ndim:
                raise ValueError("One offset required per array dimension")
            return list(off)
        if ndim != 1:
            raise ValueError("One offset required per array dimension")
        return [off]
