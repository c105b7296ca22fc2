"""Hand-written Hopper kernels of the port, their wrappers and their plain
versions.

Kernel B3, ``cmatmul``: the planar complex matrix product
``(zr + i zi) @ (wr + i wi) -> (zr@wr - zi@wi, zr@wi + zi@wr)``, the port of
the JAX package's Pallas kernel ``cmatmul_pallas``
(``swiftly_tpu/ops/pallas_kernels.py:102``). CUDA C++ in
``csrc/cmatmul.cu``, built by ``ops/_build.py`` at first use and bound with
``ctypes``. The source's head comment says what bounds it on the card and
what its design does about that.

The wrapper takes the plain version (four ``torch.matmul`` products) only
when every tensor lies on the CPU. For CUDA tensors it launches the kernel
or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from . import _build

__all__ = ["KernelStats", "cmatmul", "cmatmul_plain", "cmatmul_stats", "load_cmatmul"]


class KernelStats:
    """Launch counts of one kernel wrapper.

    ``launches`` goes up by one where the wrapper launches its kernel and
    nowhere else (the plain CPU version does not count); ``shapes`` counts
    launches per argument shape, e.g. (B, K, N) for ``cmatmul``.
    """

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def reset(self):
        """Set every count to 0."""
        self.launches = 0
        self.shapes = Counter()

    def record(self, shape):
        self.launches += 1
        self.shapes[shape] += 1


cmatmul_stats = KernelStats("cmatmul")

_lib = None


def load_cmatmul():
    """Build (if needed) and load the B3 library; returns the ctypes handle."""
    global _lib
    if _lib is None:
        path, _ = _build.build("cmatmul")
        lib = ctypes.CDLL(str(path))
        for fn in (lib.swiftly_cmatmul_f32, lib.swiftly_cmatmul_f64):
            fn.argtypes = [ctypes.c_void_p] * 6 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        lib.swiftly_cuda_error_string.argtypes = [ctypes.c_int]
        lib.swiftly_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def cmatmul_plain(zr, zi, wr, wi):
    """The plain PyTorch version of B3: four real products on the planes."""
    return (
        torch.matmul(zr, wr) - torch.matmul(zi, wi),
        torch.matmul(zr, wi) + torch.matmul(zi, wr),
    )


def _check(zr, zi, wr, wi):
    dev = zr.device
    if dev.type != "cuda" or any(t.device != dev for t in (zi, wr, wi)):
        raise ValueError(
            "cmatmul: all four planes must lie on one CUDA device (got "
            f"{[str(t.device) for t in (zr, zi, wr, wi)]})"
        )
    if zr.dtype not in (torch.float32, torch.float64) or any(
        t.dtype != zr.dtype for t in (zi, wr, wi)
    ):
        raise TypeError(
            "cmatmul: planes must all be float32 or all float64 (got "
            f"{[t.dtype for t in (zr, zi, wr, wi)]})"
        )
    if (zr.ndim != 2 or wr.ndim != 2 or zi.shape != zr.shape
            or wi.shape != wr.shape or zr.shape[1] != wr.shape[0]):
        raise ValueError(
            f"cmatmul: expected z [B, K] and w [K, N] planes, got "
            f"{tuple(zr.shape)}, {tuple(zi.shape)}, {tuple(wr.shape)}, "
            f"{tuple(wi.shape)}"
        )
    if not all(t.is_contiguous() for t in (zr, zi, wr, wi)):
        raise ValueError("cmatmul: planes must be contiguous (row-major)")


def cmatmul(zr, zi, wr, wi):
    """``(zr + i zi) @ (wr + i wi)`` -> ``(out_r, out_i)``: kernel B3.

    :param zr, zi: [B, K] real and imaginary planes (contiguous)
    :param wr, wi: [K, N] real and imaginary planes (contiguous)
    :return: two new [B, N] tensors
    """
    if all(t.device.type == "cpu" for t in (zr, zi, wr, wi)):
        return cmatmul_plain(zr, zi, wr, wi)
    _check(zr, zi, wr, wi)
    B, K = zr.shape
    N = wr.shape[1]
    outr = torch.empty((B, N), dtype=zr.dtype, device=zr.device)
    outi = torch.empty((B, N), dtype=zr.dtype, device=zr.device)
    if B == 0 or N == 0:
        return outr, outi
    lib = load_cmatmul()
    fn = (lib.swiftly_cmatmul_f32 if zr.dtype == torch.float32
          else lib.swiftly_cmatmul_f64)
    with torch.cuda.device(zr.device):
        stream = torch.cuda.current_stream(zr.device).cuda_stream
        err = fn(zr.data_ptr(), zi.data_ptr(), wr.data_ptr(), wi.data_ptr(),
                 outr.data_ptr(), outi.data_ptr(), B, K, N, stream)
    if err != 0:
        msg = lib.swiftly_cuda_error_string(err).decode()
        raise RuntimeError(
            f"cmatmul kernel launch failed for (B, K, N) = ({B}, {K}, {N}): "
            f"CUDA error {err} ({msg})"
        )
    cmatmul_stats.record((B, K, N))
    return outr, outi
