"""Native C++ host backend: build, bindings, and the NativeKernels class.

The port of the JAX package's ``swiftly_tpu/native``: a compiled host
backend behind the same eight-primitive API, complex128 numpy on the
host, with accumulate semantics and pickling-by-parameters (the native
handle is rebuilt on unpickle, for multi-process host pipelines). It is
the role the external ``ska-sdp-func`` C library plays beside a Python
core: ``SwiftlyCore(backend="native")`` dispatches every primitive here.

The library is compiled from ``csrc/swiftly_native.cpp`` (the port's copy
of the JAX package's source) at first use with ``g++`` and the JAX
package's flags (`GXX_FLAGS`), into ``swiftly_tpu_torch/_build/`` (never
next to the source) under a name that carries a digest of the source and
the flags, through a tmp file and a rename, so a concurrent loader never
sees half a library and a fresh checkout builds once. Nothing is built
at import. Where ``g++`` is missing or the build fails, `load_library`
raises: the native backend never falls back to the numpy core.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

__all__ = ["NativeKernels", "load_library", "native_available"]

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "swiftly_native.cpp"
_BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp")
_LIB = None
_LIB_ERR = None


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libswiftly_native_{h.hexdigest()[:16]}.so"


def _build_library() -> Path:
    out = _library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native backend is built "
                           "from C++ at first use")
    _BUILD_DIR.mkdir(exist_ok=True)
    # Compile into a temp file then atomically rename, so concurrent
    # importers never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=str(_BUILD_DIR))
    os.close(fd)
    cmd = [gxx, *GXX_FLAGS, str(_SRC), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    except subprocess.CalledProcessError as err:
        raise RuntimeError(
            f"Native backend build failed:\n{err.stderr}"
        ) from err
    finally:
        if os.path.exists(tmp):  # compile failed
            os.unlink(tmp)
    return out


def load_library():
    """Build (if needed) and load the native library; cached per process."""
    global _LIB, _LIB_ERR
    if _LIB is not None:
        return _LIB
    if _LIB_ERR is not None:
        raise _LIB_ERR
    try:
        lib = ctypes.CDLL(str(_build_library()))
    except (RuntimeError, OSError) as err:  # toolchain missing etc.
        _LIB_ERR = RuntimeError(f"Native backend unavailable: {err}")
        raise _LIB_ERR from err

    i64 = ctypes.c_int64
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.sw_create.restype = ctypes.c_void_p
    lib.sw_create.argtypes = [i64, i64, i64, dptr, dptr]
    lib.sw_destroy.argtypes = [ctypes.c_void_p]
    per_axis = [ctypes.c_void_p, dptr, dptr, i64, i64, i64]
    lib.sw_prepare_facet.argtypes = per_axis + [i64]
    lib.sw_extract_from_facet.argtypes = per_axis
    lib.sw_add_to_subgrid.argtypes = per_axis
    lib.sw_extract_from_subgrid.argtypes = per_axis
    lib.sw_add_to_facet.argtypes = per_axis
    lib.sw_finish_subgrid_axis.argtypes = per_axis + [i64]
    lib.sw_prepare_subgrid_axis.argtypes = per_axis + [i64]
    lib.sw_finish_facet_axis.argtypes = per_axis + [i64]
    lib.sw_add_to_subgrid_2d.argtypes = [
        ctypes.c_void_p, dptr, dptr, i64, i64,
    ]
    lib.sw_num_threads.restype = ctypes.c_int
    _LIB = lib
    return lib


def native_available() -> bool:
    """True if the native library can be built/loaded on this host."""
    try:
        load_library()
        return True
    except RuntimeError:
        return False


def _cbuf(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeKernels:
    """Handle to a native Swiftly kernel set for one configuration.

    Methods mirror the math-function layer (ops/core.py): per-axis
    primitives take (array, offset, axis); `add_*` accumulate into `out`.
    Arrays are contiguous numpy complex128; 1D and 2D supported.
    """

    def __init__(self, N: int, xM_size: int, yN_size: int,
                 fb: np.ndarray, fn: np.ndarray):
        self._params = (N, xM_size, yN_size)
        self._fb = np.ascontiguousarray(fb, dtype=float)
        self._fn = np.ascontiguousarray(fn, dtype=float)
        # sw_create copies yN-1 / xM*yN/N doubles unconditionally — length
        # mismatches must be caught here, not read out of bounds there.
        if self._fb.shape != (yN_size - 1,):
            raise ValueError(
                f"Fb must have {yN_size - 1} samples, got {self._fb.shape}"
            )
        m = xM_size * yN_size // N if N else 0
        if self._fn.shape != (m,):
            raise ValueError(
                f"Fn must have {m} samples, got {self._fn.shape}"
            )
        self._lib = load_library()
        self._handle = self._lib.sw_create(
            N, xM_size, yN_size, _cbuf(self._fb), _cbuf(self._fn)
        )
        if not self._handle:
            raise ValueError(
                f"Invalid native Swiftly parameters N={N}, "
                f"xM={xM_size}, yN={yN_size}"
            )
        self.N, self.xM_size, self.yN_size = N, xM_size, yN_size
        self.xM_yN_size = xM_size * yN_size // N

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.sw_destroy(self._handle)
            self._handle = None

    # Rebuild the handle on unpickle (native state is not serialisable) —
    # as the external library's Python wrapper does.
    def __reduce__(self):
        return (NativeKernels, self._params + (self._fb, self._fn))

    @staticmethod
    def _lanes(shape, axis):
        """Map (shape, axis) onto the [pre, n, post] lane decomposition."""
        axis = axis % len(shape)
        pre = int(np.prod(shape[:axis], dtype=int))
        post = int(np.prod(shape[axis + 1 :], dtype=int))
        return pre, post

    @staticmethod
    def _prep(a) -> np.ndarray:
        return np.ascontiguousarray(a, dtype=complex)

    def _out(self, shape, axis, n, out, zero):
        out_shape = list(shape)
        out_shape[axis % len(shape)] = n
        if out is not None:
            if list(out.shape) != out_shape:
                raise ValueError(
                    f"Output shape {out.shape}, expected {tuple(out_shape)}"
                )
            if out.dtype != np.complex128 or not out.flags.c_contiguous:
                raise ValueError("Output must be contiguous complex128")
            return out
        if zero:
            return np.zeros(out_shape, dtype=complex)
        return np.empty(out_shape, dtype=complex)

    def _axis_op(self, fn, a, axis, n_out, out=None, zero_out=False,
                 extra=()):
        a = self._prep(a)
        pre, post = self._lanes(a.shape, axis)
        res = self._out(a.shape, axis, n_out, out, zero_out)
        fn(self._handle, _cbuf(a), _cbuf(res), pre, post,
           *(int(x) for x in extra))
        return res

    # -- facet -> subgrid ---------------------------------------------------

    def _check_facet_size(self, n):
        # Fb has yN-1 samples; the kernels index Fb[(yN-1)//2 - n//2 + j]
        # for j < n, so any facet larger than yN-1 would read out of bounds.
        if n > self.yN_size - 1:
            raise ValueError(
                f"Facet size {n} exceeds Fb support {self.yN_size - 1}"
            )

    def prepare_facet(self, facet, facet_off, axis):
        facet = self._prep(facet)
        nF = facet.shape[axis]
        self._check_facet_size(nF)
        pre, post = self._lanes(facet.shape, axis)
        res = self._out(facet.shape, axis, self.yN_size, None, False)
        self._lib.sw_prepare_facet(
            self._handle, _cbuf(facet), _cbuf(res), pre, nF, post,
            int(facet_off),
        )
        return res

    def extract_from_facet(self, prep_facet, subgrid_off, axis):
        return self._axis_op(
            self._lib.sw_extract_from_facet, prep_facet, axis,
            self.xM_yN_size, extra=(subgrid_off,),
        )

    def add_to_subgrid(self, contrib, facet_off, axis, out=None):
        return self._axis_op(
            self._lib.sw_add_to_subgrid, contrib, axis, self.xM_size,
            out=out, zero_out=True, extra=(facet_off,),
        )

    def add_to_subgrid_2d(self, contrib, facet_offs, out=None):
        """Fused both-axes add_to_subgrid (single native call)."""
        contrib = self._prep(contrib)
        m = self.xM_yN_size
        if contrib.shape != (m, m):
            raise ValueError(f"Contribution must be [{m}, {m}]")
        out = self._out((self.xM_size, self.xM_size), 0, self.xM_size,
                        out, True)
        self._lib.sw_add_to_subgrid_2d(
            self._handle, _cbuf(contrib), _cbuf(out),
            int(facet_offs[0]), int(facet_offs[1]),
        )
        return out

    def finish_subgrid(self, summed, subgrid_offs, subgrid_size):
        res = self._prep(summed)
        for axis, off in enumerate(subgrid_offs):
            res = self._axis_op(
                self._lib.sw_finish_subgrid_axis, res, axis, subgrid_size,
                extra=(off, subgrid_size),
            )
        return res

    # -- subgrid -> facet ---------------------------------------------------

    def prepare_subgrid(self, subgrid, subgrid_offs):
        res = self._prep(subgrid)
        for axis, off in enumerate(subgrid_offs):
            sz = res.shape[axis]
            res = self._axis_op(
                self._lib.sw_prepare_subgrid_axis, res, axis, self.xM_size,
                extra=(off, sz),
            )
        return res

    def extract_from_subgrid(self, prep_subgrid, facet_off, axis):
        return self._axis_op(
            self._lib.sw_extract_from_subgrid, prep_subgrid, axis,
            self.xM_yN_size, extra=(facet_off,),
        )

    def add_to_facet(self, contrib, subgrid_off, axis, out=None):
        return self._axis_op(
            self._lib.sw_add_to_facet, contrib, axis, self.yN_size,
            out=out, zero_out=True, extra=(subgrid_off,),
        )

    def finish_facet(self, summed, facet_off, facet_size, axis):
        self._check_facet_size(facet_size)
        return self._axis_op(
            self._lib.sw_finish_facet_axis, summed, axis, facet_size,
            extra=(facet_off, facet_size),
        )
