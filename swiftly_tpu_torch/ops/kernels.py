"""Hand-written Hopper kernels of the port, their wrappers and their plain
versions.

* Kernel B3, ``cmatmul``: the planar complex matrix product
  ``(zr + i zi) @ (wr + i wi) -> (zr@wr - zi@wi, zr@wi + zi@wr)``, the port
  of the JAX package's Pallas kernel ``cmatmul_pallas``
  (``swiftly_tpu/ops/pallas_kernels.py:102``); ``csrc/cmatmul.cu``.
* Kernel B1, ``colpass``: the streamed column pass's fused complex triple
  product ``A_f @ X_sf @ B_f``, summed over the facets f or per facet, the
  port of ``colpass_pallas`` (``pallas_kernels.py:265``);
  ``csrc/colpass.cu``.
* Kernel B2, ``fold``: the streamed backward's adjoint sampled fold
  ``acc += w * ((Bc - i Bs)^T @ (Rr + i Ri))``, in place, the port of
  ``bwd_fold_pallas`` (``pallas_kernels.py:171``); ``csrc/fold.cu``.
* Kernel B4, ``degrid_rows``: the visibility degrid reduction
  ``vis[b] = sum_ij row[u0_b + i, v0_b + j] cu[b, i] cv[b, j]`` over both
  planes of the row of each sample, for every sample of a serving pump over
  G rows in one launch, with the gather fused and the tap weights computed
  on the card from the kernel's table, the port of the ``use_pallas``
  branch of ``swiftly_tpu/vis/degrid.py:71`` ``_degrid_fn``; ``degrid``
  runs the same reduction on one row with the weights given; and its exact
  adjoint ``grid``, a deterministic in-place scatter-add (the port of
  ``swiftly_tpu/vis/grid.py:42``, not a TPU kernel); all in
  ``csrc/degrid.cu``.

CUDA C++ for ``sm_90a``, built by ``ops/_build.py`` at first use and bound
with ``ctypes``. Each source's head comment says what bounds it on the card
and what its design does about that; B1 and B2 share the strided tile
engine of ``csrc/cgemm.cuh``, so they take their operands as strided views
(e.g. one plane of an interleaved (..., 2) tensor). Their wrappers build
the engine's launches in Python (``colpass_launches``, ``fold_launch``:
strides, sizes, and per operand the copy path that its strides, sizes and
alignment allow, ``_cgemm_paths``), which the CPU tests check through
``cgemm_emulate``; the one copy they add is of B1's operators A and B,
each with its run axis contiguous (``_operator``).

Each wrapper takes its plain version (``torch.matmul`` products) only when
every tensor lies on the CPU. For CUDA tensors it launches the kernel or
raises; nothing falls back. Each kernel has a launch counter
(``cmatmul_stats``, ``colpass_stats``, ``fold_stats``, ``degrid_stats``,
``grid_stats``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from typing import NamedTuple

import torch

from . import _build

__all__ = [
    "KernelStats",
    "Launch",
    "Plane",
    "cgemm_emulate",
    "cmatmul",
    "cmatmul_plain",
    "cmatmul_stats",
    "colpass",
    "colpass_launches",
    "colpass_plain",
    "colpass_staging",
    "colpass_stats",
    "check_tap_table",
    "degrid",
    "degrid_plain",
    "degrid_rows",
    "degrid_rows_plain",
    "degrid_stats",
    "engine_tile",
    "fold",
    "fold_launch",
    "fold_plain",
    "fold_stats",
    "grid",
    "grid_plain",
    "grid_stats",
    "load_cmatmul",
    "tap_weights",
]


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
colpass_stats = KernelStats("colpass")
fold_stats = KernelStats("fold")
degrid_stats = KernelStats("degrid")
grid_stats = KernelStats("grid")

_libs = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_DEGRID_ARGS = [_P, _P, _LL, _LL, _I, _I, _P, _P, _P, _P, _P, _P, _LL, _I, _P]
# argument types of the entry points swiftly_<entry>_f32/_f64 of each
# library csrc/<name>.cu; each library also exports
# swiftly_<name>_error_string
_ARGTYPES = {
    "cmatmul": {"cmatmul": [_P] * 6 + [_LL, _I, _I, _I, _P]},
    "colpass": {"colpass": [_P, _P, _STRIDES, _P, _P, _STRIDES, _P, _P,
                            _STRIDES, _I, _I, _I, _I, _LL, _I, _I, _P]},
    "fold": {"fold": [_P, _P, _STRIDES, _P, _P, _STRIDES, _P, _P, _STRIDES,
                      _P, _LL, _LL, _I, _I, _I, _I, _P]},
    "degrid": {"degrid": _DEGRID_ARGS,
               "degrid_rows": [_P, _LL, _LL, _I, _P, _I, _P, _P, _P],
               "grid": _DEGRID_ARGS[:10] + [_P, _P, _LL, _I, _P]},
}


def _load(name):
    """Build (if needed) and load one kernel library; returns the ctypes
    handle, with its entry points typed."""
    if name not in _libs:
        path, _ = _build.build(name)
        lib = ctypes.CDLL(str(path))
        for entry, argtypes in _ARGTYPES[name].items():
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, f"swiftly_{entry}{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        err = getattr(lib, f"swiftly_{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def load_cmatmul():
    """Build (if needed) and load the B3 library; returns the ctypes handle."""
    return _load("cmatmul")


def _launch(name, dtype, what, *args, entry=None):
    """Call the f32 or f64 entry point `entry` (default: `name`) of the
    library `name`; raise on a failed launch."""
    lib = _load(name)
    entry = name if entry is None else entry
    suffix = "_f32" if dtype == torch.float32 else "_f64"
    err = getattr(lib, f"swiftly_{entry}{suffix}")(*args)
    if err != 0:
        msg = getattr(lib, f"swiftly_{name}_error_string")(err).decode()
        raise RuntimeError(
            f"{entry} kernel launch failed for {what}: CUDA error {err} ({msg})"
        )


def _strides(*values):
    return (ctypes.c_longlong * len(values))(*[int(v) for v in values])


def _on_cpu(tensors):
    return all(t.device.type == "cpu" for t in tensors)


def _check_cuda(name, tensors):
    """One CUDA device and one float dtype (float32 or float64) for all."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            f"{name}: all planes must lie on one CUDA device (got "
            f"{[str(t.device) for t in tensors]})"
        )
    dt = tensors[0].dtype
    if dt not in (torch.float32, torch.float64) or any(
        t.dtype != dt for t in tensors
    ):
        raise TypeError(
            f"{name}: planes must all be float32 or all float64 (got "
            f"{[t.dtype for t in tensors]})"
        )


def cmatmul_plain(zr, zi, wr, wi):
    """The plain PyTorch version of B3: four real products on the planes."""
    return (
        torch.matmul(zr, wr) - torch.matmul(zi, wi),
        torch.matmul(zr, wi) + torch.matmul(zi, wr),
    )


def _check(zr, zi, wr, wi):
    _check_cuda("cmatmul", (zr, zi, wr, wi))
    if (zr.ndim != 2 or wr.ndim != 2 or zi.shape != zr.shape
            or wi.shape != wr.shape or zr.shape[1] != wr.shape[0]):
        raise ValueError(
            f"cmatmul: expected z [B, K] and w [K, N] planes, got "
            f"{tuple(zr.shape)}, {tuple(zi.shape)}, {tuple(wr.shape)}, "
            f"{tuple(wi.shape)}"
        )
    if not all(t.is_contiguous() for t in (zr, zi, wr, wi)):
        raise ValueError("cmatmul: planes must be contiguous (row-major)")


# B3's tile variants, by the id that csrc/cmatmul.cu's `launch` takes: per
# type, the (rows of z, columns of w) of one block's output tile, largest
# first. f64's large tile is half as tall: 8 x 8 doubles of both planes a
# thread would need more than 255 registers.
_CMATMUL_TILES = {
    torch.float32: {0: (128, 128), 1: (32, 64)},
    torch.float64: {0: (64, 128), 1: (32, 64)},
}
H100_SMS = 132  # streaming multiprocessors of an H100 SXM


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _cmatmul_blocks(B, N, variant, dtype=torch.float32):
    bm, bn = _CMATMUL_TILES[dtype][variant]
    return -(-B // bm) * -(-N // bn)


def _cmatmul_config(B, K, N, dtype=torch.float32, sms=H100_SMS):
    """The tile variant of B3 for one product ``[B, K] @ [K, N]`` on a card
    of `sms` SMs: the large tile (one block an SM) where its grid holds at
    least four waves of blocks, so that the last wave's idle SMs cost
    little, else the 32 x 64 tile. Every variant gives the same bits (the
    same chain of FMAs per output), so the choice moves only the time. K
    does not enter: no variant splits the contraction."""
    return 0 if _cmatmul_blocks(B, N, 0, dtype) >= 4 * sms else 1


def _cmatmul_launch(zr, zi, wr, wi, variant):
    """Launch B3's tile `variant` on checked CUDA planes; count it."""
    B, K = zr.shape
    N = wr.shape[1]
    outr = torch.empty((B, N), dtype=zr.dtype, device=zr.device)
    outi = torch.empty((B, N), dtype=zr.dtype, device=zr.device)
    if B == 0 or N == 0:
        return outr, outi
    with torch.cuda.device(zr.device):
        stream = torch.cuda.current_stream(zr.device).cuda_stream
        _launch("cmatmul", zr.dtype,
                f"(B, K, N) = ({B}, {K}, {N}), variant {variant}",
                zr.data_ptr(), zi.data_ptr(), wr.data_ptr(), wi.data_ptr(),
                outr.data_ptr(), outi.data_ptr(), B, K, N, variant, stream)
    cmatmul_stats.record((B, K, N))
    return outr, outi


def cmatmul(zr, zi, wr, wi):
    """``(zr + i zi) @ (wr + i wi)`` -> ``(out_r, out_i)``: kernel B3.

    :param zr, zi: [B, K] real and imaginary planes (contiguous)
    :param wr, wi: [K, N] real and imaginary planes (contiguous)
    :return: two new [B, N] tensors
    """
    if _on_cpu((zr, zi, wr, wi)):
        return cmatmul_plain(zr, zi, wr, wi)
    _check(zr, zi, wr, wi)
    B, K = zr.shape
    variant = _cmatmul_config(B, K, wr.shape[1], zr.dtype,
                              _sm_count(zr.device.index))
    return _cmatmul_launch(zr, zi, wr, wi, variant)


# ---------------------------------------------------------------------------
# The strided tile engine of B1 and B2 (csrc/cgemm.cuh)
# ---------------------------------------------------------------------------

# One launch of the engine computes, per batch entry (b0, b1),
#   out (=|+= w *) sum_{r < nR} L[b0, b1, r] @ R[b0, b1, r]
# from planes given by a base tensor and element strides: (b0, b1, r, row,
# col) for L [M, K] and R [K, N], (b0, b1, row, col) for the output.
# `paths` tells it how to copy each operand (csrc/cgemm.cuh `kPathLRuns`,
# `kPathRRuns`, `OutPath`): 16-byte runs where the fast axis allows them,
# else one element a copy.
PATH_L_RUNS = 1  # L in 16-byte runs along m
PATH_R_RUNS = 2  # R in 16-byte runs along n
OUT_ELEMENTS, OUT_RUNS_N, OUT_RUNS_M, OUT_PAIRS = range(4)
_OUT_SHIFT = 2


class Plane(NamedTuple):
    """A strided complex operand: its real and imaginary planes (tensors
    whose data pointers are the operand's element 0) and its element
    strides, which both planes share."""

    re: torch.Tensor
    im: torch.Tensor
    strides: tuple


class Launch(NamedTuple):
    """One launch of the tile engine: L, R and the output as `Plane`s,
    the sizes, and the copy paths (`_cgemm_paths`)."""

    L: Plane
    R: Plane
    O: Plane
    M: int
    N: int
    K: int
    nR: int
    nb0: int
    nb1: int
    paths: int


def engine_tile(name, dtype):
    """The tile of B1's (`name` "colpass") or B2's ("fold") engine as its
    library reports it: {"tile": (BM, BN), "thread": (RM, RN), "stages",
    "shared_bytes"} (dynamic shared memory a block asks for)."""
    fn = getattr(_load(name), f"swiftly_{name}_tile")
    fn.argtypes = [ctypes.c_int, _STRIDES]
    fn.restype = None
    out = (ctypes.c_longlong * 6)()
    fn(int(dtype == torch.float64), out)
    return {"tile": (out[0], out[1]), "thread": (out[2], out[3]),
            "stages": out[4], "shared_bytes": out[5]}


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _runs_fit(op, fast, length):
    """Whether `op` can be copied in 16-byte runs along the axis whose
    stride is ``op.strides[fast]``: that axis contiguous and `length` a
    whole number of runs, every other stride a whole number of runs (so
    every run starts 16-byte aligned), and both planes aligned."""
    v = 16 // op.re.element_size()
    return (op.strides[fast] == 1 and length % v == 0
            and all(s % v == 0 for i, s in enumerate(op.strides) if i != fast)
            and _aligned(op.re, op.im))


def _out_path(O, M, N):
    """How the engine writes the output (strides (b0, b1, row, col))."""
    item = O.re.element_size()
    v = 16 // item
    if _runs_fit(O, 3, N):
        return OUT_RUNS_N
    if _runs_fit(O, 2, M):
        return OUT_RUNS_M
    if (O.im.data_ptr() == O.re.data_ptr() + item and O.strides[3] == 2
            and N % (v // 2) == 0 and all(s % v == 0 for s in O.strides[:3])
            and _aligned(O.re)):
        return OUT_PAIRS  # interleaved (re, im): both planes in one vector
    return OUT_ELEMENTS


def _cgemm_paths(L, R, O, M, N):
    """The copy paths of one launch: L in runs along m (its row axis) and R
    in runs along n (its column axis) where `_runs_fit`, and the output's
    path (`_out_path`)."""
    paths = PATH_L_RUNS if _runs_fit(L, 3, M) else 0
    if _runs_fit(R, 4, N):
        paths |= PATH_R_RUNS
    return paths | _out_path(O, M, N) << _OUT_SHIFT


def _launch_of(L, R, O, M, N, K, nR, nb0, nb1):
    return Launch(L, R, O, M, N, K, nR, nb0, nb1, _cgemm_paths(L, R, O, M, N))


def cgemm_emulate(launch, w=None, conj_l=False):
    """What one launch of the engine computes, on CPU tensors, through the
    same strides (``torch.as_strided`` over the planes' storage), in the
    planes' dtype; for testing the launches the wrappers build. The sum
    over (r, k) is torch's, not the kernel's FMA chain."""
    L, R, O, M, N, K, nR, nb0, nb1, _ = launch

    def view(t, strides, shape):
        return torch.as_strided(t, shape, strides, t.storage_offset())

    lr = view(L.re, L.strides, (nb0, nb1, nR, M, K))
    li = view(L.im, L.strides, (nb0, nb1, nR, M, K))
    li = -li if conj_l else li
    rr = view(R.re, R.strides, (nb0, nb1, nR, K, N))
    ri = view(R.im, R.strides, (nb0, nb1, nR, K, N))
    pr = (torch.matmul(lr, rr) - torch.matmul(li, ri)).sum(2)
    pi = (torch.matmul(lr, ri) + torch.matmul(li, rr)).sum(2)
    outr = view(O.re, O.strides, (nb0, nb1, M, N))
    outi = view(O.im, O.strides, (nb0, nb1, M, N))
    if w is None:
        outr.copy_(pr)
        outi.copy_(pi)
    else:
        outr += w[:, None] * pr
        outi += w[:, None] * pi


# ---------------------------------------------------------------------------
# B1: the fused column-pass product
# ---------------------------------------------------------------------------


def colpass_plain(ar, ai, xr, xi, br, bi, reduce_f=True):
    """The plain PyTorch version of B1: ``T = A_f @ X_sf`` then
    ``T @ B_f``, four real products each, summed over f with
    ``reduce_f``."""
    tr = torch.matmul(ar, xr) - torch.matmul(ai, xi)  # [S, F, M, Q]
    ti = torch.matmul(ar, xi) + torch.matmul(ai, xr)
    pr = torch.matmul(tr, br) - torch.matmul(ti, bi)  # [S, F, M, N]
    pi = torch.matmul(tr, bi) + torch.matmul(ti, br)
    if reduce_f:
        return pr.sum(1), pi.sum(1)
    return pr, pi


def _colpass_shapes(ar, ai, xr, xi, br, bi):
    if ar.ndim != 3 or xr.ndim != 4 or br.ndim != 3 or ai.shape != ar.shape \
            or xi.shape != xr.shape or bi.shape != br.shape:
        raise ValueError(
            "colpass: expected A [F, M, P], X [S, Fx, P, Q] and B [F, Q, N] "
            f"planes, got {[tuple(t.shape) for t in (ar, ai, xr, xi, br, bi)]}"
        )
    F, M, P = ar.shape
    S, Fx, P2, Q = xr.shape
    F2, Q2, N = br.shape
    if P2 != P or Q2 != Q or F2 != F or Fx not in (1, F):
        raise ValueError(
            f"colpass: shapes do not chain: A {tuple(ar.shape)}, "
            f"X {tuple(xr.shape)}, B {tuple(br.shape)}"
        )
    return F, M, P, S, Fx, Q, N


def _same_strides(a, b):
    if a.stride() != b.stride():
        raise ValueError(
            "the real and imaginary planes of an operand must share strides "
            f"(got {a.stride()} and {b.stride()})"
        )


def colpass_staging(S, F, M, Q, dtype, device):
    """B1's staged product T = A @ X, TRANSPOSED: one [2, S, F, Q, M]
    buffer, whose two planes the first launch writes as runs along m and
    the second reads as runs along m into its transposed L slices."""
    return torch.empty((2, S, F, Q, M), dtype=dtype, device=device)


def _operator(re, im, strides, fast):
    """One of B1's operators as a `Plane` with the engine strides
    `strides`: A [F, M, P], launch 1's L (`fast` = 3, its row axis m), or
    B [F, Q, N], launch 2's R (`fast` = 4, its column axis n). As given
    where it can be copied in 16-byte runs along that axis; else, where the
    axis is a whole number of runs, a copy of both planes with that axis
    contiguous ([2, F, K, length]; on the path both are interleaved
    operators of a few MB, copied inside the wrapper, whose time includes
    the copies); else as given, one element a copy."""
    F, K, length = (re.shape[0], re.shape[2], re.shape[1]) if fast == 3 \
        else re.shape
    op = Plane(re, im, strides)
    if _runs_fit(op, fast, length) or length % (16 // re.element_size()):
        return op
    copy = torch.empty((2, F, K, length), dtype=re.dtype, device=re.device)
    for plane, src in zip(copy, (re, im)):
        plane.copy_(src.transpose(1, 2) if fast == 3 else src)
    st = [0] * 5
    st[next((i for i in range(3) if strides[i]), 1)] = K * length  # f's
    st[fast] = 1
    st[7 - fast] = length  # the contraction axis: L's col, R's row
    return Plane(copy[0], copy[1], tuple(st))


def colpass_launches(ar, ai, xr, xi, br, bi, t, outr, outi, reduce_f=True):
    """B1 as two launches of the tile engine (`Launch`), for planes of the
    shapes `colpass` takes, the staging buffer `t` (`colpass_staging`) and
    the output planes; the operators A and B as `_operator` gives them:

    1. ``T[s, f]^T = (A[f] @ X[s, f])^T`` for all (s, f), X's facet axis
       broadcast (stride 0) when Fx = 1;
    2. ``out[s] = sum_f T[s, f] @ B[f]`` (f the summed axis r, so the sum
       stays in registers) with `reduce_f`, else
       ``out[s, f] = T[s, f] @ B[f]``.
    """
    F, M, P, S, Fx, Q, N = _colpass_shapes(ar, ai, xr, xi, br, bi)
    sa, sx, sb, so = ar.stride(), xr.stride(), br.stride(), outr.stride()
    st = t[0].stride()  # (s, f, q, m), m contiguous
    tr, ti = t[0], t[1]
    first = _launch_of(
        _operator(ar, ai, (0, sa[0], 0, sa[1], sa[2]), 3),
        Plane(xr, xi, (sx[0], sx[1] if Fx == F else 0, 0, sx[2], sx[3])),
        Plane(tr, ti, (st[0], st[1], st[3], st[2])),
        M, Q, P, 1, S, F)
    if reduce_f:  # the facets are the contraction's r
        second = _launch_of(
            Plane(tr, ti, (st[0], 0, st[1], st[3], st[2])),
            _operator(br, bi, (0, 0, sb[0], sb[1], sb[2]), 4),
            Plane(outr, outi, (so[0], 0, so[1], so[2])),
            M, N, Q, F, S, 1)
    else:  # the facets are the batch's b1
        second = _launch_of(
            Plane(tr, ti, (st[0], st[1], 0, st[3], st[2])),
            _operator(br, bi, (0, sb[0], 0, sb[1], sb[2]), 4),
            Plane(outr, outi, so),
            M, N, Q, 1, S, F)
    return first, second


def colpass(ar, ai, xr, xi, br, bi, reduce_f=True):
    """Kernel B1: the column pass's complex triple product.

    ``out[s] = sum_f A[f] @ X[s, f] @ B[f]`` with ``reduce_f`` (the
    forward body), else ``out[s, f] = A[f] @ X[s, f] @ B[f]`` (the adjoint
    body). Planes may be strided views (e.g. ``t[..., 0]`` of an
    interleaved planar tensor); the re and im planes of one operand share
    their strides.

    :param ar, ai: [F, M, P] left operator planes
    :param xr, xi: [S, Fx, P, Q] middle planes; Fx is F, or 1 (broadcast
        over the facet axis)
    :param br, bi: [F, Q, N] right operator planes
    :return: two new planes, [S, M, N] with ``reduce_f``, else [S, F, M, N]
    """
    planes = (ar, ai, xr, xi, br, bi)
    F, M, P, S, Fx, Q, N = _colpass_shapes(*planes)
    if _on_cpu(planes):
        return colpass_plain(*planes, reduce_f=reduce_f)
    _check_cuda("colpass", planes)
    for a, b in ((ar, ai), (xr, xi), (br, bi)):
        _same_strides(a, b)
    dt, dev = ar.dtype, ar.device
    out_shape = (S, M, N) if reduce_f else (S, F, M, N)
    outr = torch.empty(out_shape, dtype=dt, device=dev)
    outi = torch.empty(out_shape, dtype=dt, device=dev)
    if min(S, F, M, N) == 0:
        return outr, outi
    if P == 0 or Q == 0:
        return outr.zero_(), outi.zero_()
    t = colpass_staging(S, F, M, Q, dt, dev)
    what = f"(S, F, Fx, M, P, Q, N) = ({S}, {F}, {Fx}, {M}, {P}, {Q}, {N})"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for ln in colpass_launches(*planes, t, outr, outi, reduce_f):
            _launch("colpass", dt, what,
                    ln.L.re.data_ptr(), ln.L.im.data_ptr(),
                    _strides(*ln.L.strides), ln.R.re.data_ptr(),
                    ln.R.im.data_ptr(), _strides(*ln.R.strides),
                    ln.O.re.data_ptr(), ln.O.im.data_ptr(),
                    _strides(*ln.O.strides), ln.M, ln.N, ln.K, ln.nR, ln.nb0,
                    ln.nb1, ln.paths, stream)
    colpass_stats.record((S, F, Fx, M, P, Q, N, bool(reduce_f)))
    return outr, outi


# ---------------------------------------------------------------------------
# B2: the adjoint sampled fold
# ---------------------------------------------------------------------------


def fold_plain(acc_r, acc_i, bc, bs, rr, ri, w):
    """The plain PyTorch version of B2, in place:
    ``acc += w * ((Bc - i Bs)^T @ (Rr + i Ri))`` per facet."""
    bct, bst = bc.transpose(0, 1), bs.transpose(0, 1)  # [B, R]
    out_r = torch.matmul(bct, rr) + torch.matmul(bst, ri)  # [F, B, J]
    out_i = torch.matmul(bct, ri) - torch.matmul(bst, rr)
    wc = w.reshape(-1, 1)
    acc_r += wc * out_r
    acc_i += wc * out_i
    return acc_r, acc_i


def fold_launch(acc_r, acc_i, bc, bs, rr, ri):
    """B2 as one launch of the tile engine (`Launch`), the facet axis its
    batch: ``acc[f] += w * (L @ rows[f])`` with ``L[b, r] = Bc[r, b] -
    i Bs[r, b]`` (the transpose a stride, the conjugate the engine's
    negated imaginary plane)."""
    F, B, J = acc_r.shape
    R = bc.shape[0]
    sb, sr, sa = bc.stride(), rr.stride(), acc_r.stride()
    return _launch_of(Plane(bc, bs, (0, 0, 0, sb[1], sb[0])),
                      Plane(rr, ri, (sr[0], 0, 0, sr[1], sr[2])),
                      Plane(acc_r, acc_i, (sa[0], 0, sa[1], sa[2])),
                      B, J, R, 1, F, 1)


def fold(acc_r, acc_i, bc, bs, rr, ri, w):
    """Kernel B2: one adjoint-fold row block, accumulated in place.

    ``acc[f] += w (.) ((Bc - i Bs)^T @ (Rr + i Ri)[f])`` for every facet f.
    Every argument may be a strided view: the accumulator planes are
    typically ``acc[:, rows, :, 0]`` and ``acc[:, rows, :, 1]`` of the
    interleaved [F, yB, yB, 2] image accumulator, updated where they lie.

    :param acc_r, acc_i: [F, B, J] accumulator planes (updated in place)
    :param bc, bs: [R, B] adjoint DFT phase planes (cos/sin of kt * i)
    :param rr, ri: [F, R, J] phase-rotated row planes
    :param w: [B] per-output-row weights (Fb window x keep mask)
    :return: (acc_r, acc_i)
    """
    tensors = (acc_r, acc_i, bc, bs, rr, ri, w)
    if acc_r.ndim != 3 or rr.ndim != 3 or bc.ndim != 2 or w.ndim != 1:
        raise ValueError(
            "fold: expected acc [F, B, J], bc/bs [R, B], rows [F, R, J] and "
            f"w [B], got {[tuple(t.shape) for t in tensors]}"
        )
    F, B, J = acc_r.shape
    R = bc.shape[0]
    if (acc_i.shape != acc_r.shape or bs.shape != bc.shape
            or ri.shape != rr.shape or tuple(bc.shape) != (R, B)
            or tuple(rr.shape) != (F, R, J) or tuple(w.shape) != (B,)):
        raise ValueError(
            f"fold: shapes do not match: {[tuple(t.shape) for t in tensors]}"
        )
    if _on_cpu(tensors):
        return fold_plain(*tensors)
    _check_cuda("fold", tensors)
    for a, b in ((acc_r, acc_i), (bc, bs), (rr, ri)):
        _same_strides(a, b)
    if min(F, B, J, R) == 0:
        return acc_r, acc_i
    ln = fold_launch(acc_r, acc_i, bc, bs, rr, ri)
    with torch.cuda.device(acc_r.device):
        stream = torch.cuda.current_stream(acc_r.device).cuda_stream
        _launch("fold", acc_r.dtype, f"(F, B, J, R) = ({F}, {B}, {J}, {R})",
                acc_r.data_ptr(), acc_i.data_ptr(), _strides(*acc_r.stride()),
                bc.data_ptr(), bs.data_ptr(), _strides(*bc.stride()),
                rr.data_ptr(), ri.data_ptr(), _strides(*rr.stride()),
                w.data_ptr(), w.stride(0), F, B, J, R, ln.paths, stream)
    fold_stats.record((F, B, J, R))
    return acc_r, acc_i


# ---------------------------------------------------------------------------
# B4: the visibility degrid reduction, and its adjoint scatter
# ---------------------------------------------------------------------------


def _tap_indices(iu0, iv0, W, H, Wd):
    """[B, W] row and column indices of every sample's taps, a negative one
    counted once from the end (JAX's index rule)."""
    offs = torch.arange(W, device=iu0.device, dtype=torch.int64)
    iu, iv = iu0[:, None] + offs, iv0[:, None] + offs
    return torch.where(iu < 0, iu + H, iu), torch.where(iv < 0, iv + Wd, iv)


def degrid_plain(row_r, row_i, iu0, iv0, cu, cv):
    """The plain PyTorch version of B4: gather the [B, W, W] patches (by
    JAX's gather rules: a negative index counts once from the end, the rest
    clamp to the row), then ``einsum("bij,bi,bj->b")`` per plane."""
    H, Wd = row_r.shape
    iu, iv = _tap_indices(iu0, iv0, cu.shape[1], H, Wd)
    iu, iv = iu.clamp(0, H - 1), iv.clamp(0, Wd - 1)
    pr = row_r[iu[:, :, None], iv[:, None, :]]
    pi = row_i[iu[:, :, None], iv[:, None, :]]
    return (torch.einsum("bij,bi,bj->b", pr, cu, cv),
            torch.einsum("bij,bi,bj->b", pi, cu, cv))


def _vis_shapes(name, planes, iu0, iv0, cu, cv, per_sample):
    tensors = (*planes, iu0, iv0, cu, cv, *per_sample)
    if (planes[0].ndim != 2 or planes[1].shape != planes[0].shape
            or iu0.ndim != 1 or cu.ndim != 2):
        raise ValueError(
            f"{name}: expected [H, W] planes, [B] indices and [B, W] weights, "
            f"got {[tuple(t.shape) for t in tensors]}"
        )
    B, W = cu.shape
    if (tuple(iv0.shape) != (B,) or tuple(iu0.shape) != (B,)
            or tuple(cv.shape) != (B, W)
            or any(tuple(t.shape) != (B,) for t in per_sample)):
        raise ValueError(
            f"{name}: shapes do not match: {[tuple(t.shape) for t in tensors]}"
        )
    return tensors, B, W


def _check_vis_cuda(name, planes, iu0, iv0, dense):
    _check_cuda(name, (*planes, *dense))
    _same_strides(*planes)
    for t in (iu0, iv0):
        if t.dtype != torch.int64 or t.device != planes[0].device:
            raise TypeError(
                f"{name}: indices must be int64 on the planes' device (got "
                f"{t.dtype} on {t.device})"
            )
    if not all(t.is_contiguous() for t in (iu0, iv0, *dense)):
        raise ValueError(f"{name}: indices, weights and samples must be "
                         "contiguous")


def degrid(row_r, row_i, iu0, iv0, cu, cv):
    """Kernel B4: ``vis[b] = sum_ij row[iu0_b + i, iv0_b + j] cu[b, i]
    cv[b, j]`` for both planes, the gather fused.

    The planes may be strided views (e.g. ``row[..., 0]`` and
    ``row[..., 1]`` of an interleaved [xA, xA, 2] row) sharing their
    strides. A sample's bits do not depend on B or on its place in the
    batch.

    :param row_r, row_i: [H, W'] real and imaginary planes of one row
    :param iu0, iv0: [B] int64 first-tap indices (JAX's gather rules past
        the row's edges)
    :param cu, cv: [B, W] tap weights (contiguous), the planes' dtype
    :return: two new [B] tensors (vr, vi)
    """
    tensors, B, W = _vis_shapes("degrid", (row_r, row_i), iu0, iv0, cu, cv,
                                ())
    if _on_cpu(tensors):
        return degrid_plain(row_r, row_i, iu0, iv0, cu, cv)
    _check_vis_cuda("degrid", (row_r, row_i), iu0, iv0, (cu, cv))
    vr = torch.empty((B,), dtype=row_r.dtype, device=row_r.device)
    vi = torch.empty_like(vr)
    H, Wd = row_r.shape
    if B == 0:
        return vr, vi
    if W == 0 or H == 0 or Wd == 0:
        return vr.zero_(), vi.zero_()
    s0, s1 = row_r.stride()
    with torch.cuda.device(row_r.device):
        stream = torch.cuda.current_stream(row_r.device).cuda_stream
        _launch("degrid", row_r.dtype, f"(B, W, H, W') = ({B}, {W}, {H}, {Wd})",
                row_r.data_ptr(), row_i.data_ptr(), s0, s1, H, Wd,
                iu0.data_ptr(), iv0.data_ptr(), cu.data_ptr(), cv.data_ptr(),
                vr.data_ptr(), vi.data_ptr(), B, W, stream)
    degrid_stats.record((B, W, H))
    return vr, vi


# the words of one row's descriptor in a pump's buffer (csrc/degrid.cu
# kRowWords): the two planes' addresses, their strides (s0, s1), (H, W')
_ROW_WORDS = 6
_ONE_BELOW = math.nextafter(1.0, 0.0)  # the largest fraction a table takes
_DEGRID_WARPS = 8  # samples a block (csrc/degrid.cu kWarpsPerBlock)
_MAX_SMEM = 232448  # shared memory a block may have on Hopper


def check_tap_table(table):
    """(oversample, W) of a [oversample + 1, W] float64 tap table
    (``vis.kernel.VisKernel.table``).

    :raises ValueError: when the table is no such table, or when its
        largest lookup, rows i0 and i0 + 1 at ``i0 = int(nextafter(1, 0) *
        oversample)``, would read past its last row, as the host's lookup
        does (and then raises) for a table of one row. For every integer
        oversample from 1 to 2^53 the product rounds below oversample, so
        those tables pass.
    """
    if table.ndim != 2 or table.dtype != torch.float64:
        raise ValueError(
            "tap table: expected a [oversample + 1, W] float64 table, got "
            f"{tuple(table.shape)} {table.dtype}")
    oversample, W = table.shape[0] - 1, table.shape[1]
    if int(_ONE_BELOW * oversample) + 1 > oversample:
        raise ValueError(
            f"tap table: {oversample + 1} rows; the lookup of fractions "
            f"just below 1 would read row {int(_ONE_BELOW * oversample) + 1},"
            " past the table")
    return oversample, W


def tap_weights(frac, table, dtype):
    """[B, W] tap weights of fractions ``frac`` [B] from the table, the
    plain PyTorch version of what B4 computes on the card: the operations
    of ``vis.kernel.VisKernel.weights(frac, float64)`` in float64 in the
    same order (numpy's clip, then ``table[i0] * (1 - t) + table[i0 + 1] *
    t``), then rounded to ``dtype``, so the bits are the host's."""
    oversample, _ = check_tap_table(table)
    frac = frac.to(torch.float64)
    if not bool(torch.isfinite(frac).all()):
        raise ValueError("tap weights: fractions must be finite")
    c = torch.where(frac > 0.0, frac, 0.0)
    c = torch.where(c < _ONE_BELOW, c, _ONE_BELOW)
    a = c * oversample
    i0 = a.to(torch.int64)
    t = (a - i0.to(torch.float64))[:, None]
    return (table[i0] * (1.0 - t) + table[i0 + 1] * t).to(dtype)


def degrid_rows_plain(rows, slot, iu0, iv0, fu, fv, table):
    """The plain PyTorch version of B4 over a pump, on the rows' device:
    the weights by `tap_weights`, then per row the gather and ``einsum`` of
    `degrid_plain` over the samples of that row's slot."""
    dev, dtype = rows[0][0].device, rows[0][0].dtype
    slot, iu0, iv0, fu, fv, table = (t.to(dev) for t in (slot, iu0, iv0, fu,
                                                         fv, table))
    cu, cv = tap_weights(fu, table, dtype), tap_weights(fv, table, dtype)
    vr = torch.zeros(slot.shape, dtype=dtype, device=dev)
    vi = torch.zeros_like(vr)
    for g, (row_r, row_i) in enumerate(rows):
        sel = torch.nonzero(slot == g)[:, 0]
        if sel.numel():
            vr[sel], vi[sel] = degrid_plain(row_r, row_i, iu0[sel], iv0[sel],
                                            cu[sel], cv[sel])
    return vr, vi


def _pump_shapes(rows, slot, iu0, iv0, fu, fv, table):
    samples = (slot, iu0, iv0, fu, fv)
    B = slot.shape[0] if slot.ndim == 1 else -1
    if (not rows or any(len(pair) != 2 or pair[0].ndim != 2
                        or pair[1].shape != pair[0].shape for pair in rows)
            or any(tuple(t.shape) != (B,) for t in samples)):
        raise ValueError(
            "degrid_rows: expected (real, imag) [H, W'] plane pairs and [B] "
            f"samples, got {[tuple(p.shape) for pair in rows for p in pair]} "
            f"and {[tuple(t.shape) for t in samples]}")
    if (any(t.device.type != "cpu" for t in samples)
            or any(t.dtype != torch.int64 for t in (slot, iu0, iv0))
            or any(t.dtype != torch.float64 for t in (fu, fv))):
        raise TypeError(
            "degrid_rows: slots and first taps must be int64 and fractions "
            "float64, on the host (got "
            f"{[(t.dtype, str(t.device)) for t in samples]})")
    if B and (int(slot.min()) < 0 or int(slot.max()) >= len(rows)):
        raise ValueError(f"degrid_rows: row slots outside [0, {len(rows)})")
    return B


def degrid_rows(rows, slot, iu0, iv0, fu, fv, table):
    """Kernel B4 over a serving pump, one launch: for every sample b,
    ``vis[b] = sum_ij row[iu0_b + i, iv0_b + j] cu[b, i] cv[b, j]`` on the
    row of its slot, the weights ``cu``, ``cv`` computed on the card from
    the table and the fractions, bit for bit `tap_weights`.

    A sample's bits do not depend on B, on the rows, on its slot or on its
    place in the pump; they equal `degrid` fed `tap_weights`. The rows are
    read where they lie (strided views, e.g. ``row[..., 0]`` and
    ``row[..., 1]`` of an interleaved row, or a complex row's ``.real`` and
    ``.imag``); the descriptors and the samples go up in one pinned buffer,
    one non-blocking copy.

    :param rows: G pairs (row_r, row_i) of [H, W'] planes, each pair
        sharing its strides, all on one device and of one dtype
    :param slot: [B] int64 row slot of each sample (host)
    :param iu0, iv0: [B] int64 first-tap indices (host; JAX's gather rules
        past the row's edges)
    :param fu, fv: [B] float64 finite sub-pixel fractions (host)
    :param table: [oversample + 1, W] float64 tap table on the rows' device
        (`check_tap_table`)
    :return: two new [B] tensors (vr, vi) on the rows' device
    """
    B = _pump_shapes(rows, slot, iu0, iv0, fu, fv, table)
    planes = [p for pair in rows for p in pair]
    if _on_cpu(planes + [table]):
        return degrid_rows_plain(rows, slot, iu0, iv0, fu, fv, table)
    _check_cuda("degrid_rows", planes)
    for pair in rows:
        _same_strides(*pair)
    dev, dtype = planes[0].device, planes[0].dtype
    oversample, W = check_tap_table(table)
    if table.device != dev or not table.is_contiguous():
        raise ValueError("degrid_rows: the tap table must be contiguous on "
                         f"the rows' device {dev} (got {table.device})")
    if not (bool(torch.isfinite(fu).all()) and bool(torch.isfinite(fv).all())):
        raise ValueError("degrid_rows: fractions must be finite")
    smem = (8 * (oversample + 1) * W
            + _DEGRID_WARPS * 2 * W * planes[0].element_size())
    if smem > _MAX_SMEM:
        raise ValueError(
            f"degrid_rows: a [{oversample + 1}, {W}] tap table takes {smem} "
            f"bytes of shared memory a block, more than the {_MAX_SMEM} a "
            "block may have")
    vr = torch.empty((B,), dtype=dtype, device=dev)
    vi = torch.empty_like(vr)
    if B == 0:
        return vr, vi
    if W == 0 or any(p.numel() == 0 for p in planes):
        return vr.zero_(), vi.zero_()
    G = len(rows)
    desc = []
    for row_r, row_i in rows:
        desc += [row_r.data_ptr(), row_i.data_ptr(), *row_r.stride(),
                 *row_r.shape]
    pump = torch.empty((_ROW_WORDS * G + 5 * B,), dtype=torch.int64,
                       pin_memory=True)
    pump[:_ROW_WORDS * G] = torch.tensor(desc, dtype=torch.int64)
    at = _ROW_WORDS * G
    for t in (slot, iu0, iv0, fu, fv):
        pump[at:at + B].view(t.dtype).copy_(t)
        at += B
    with torch.cuda.device(dev):
        pump = pump.to(dev, non_blocking=True)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("degrid", dtype, f"(B, W, G) = ({B}, {W}, {G})",
                pump.data_ptr(), G, B, W, table.data_ptr(), oversample,
                vr.data_ptr(), vi.data_ptr(), stream, entry="degrid_rows")
    degrid_stats.record((B, W, G, rows[0][0].shape[0]))
    return vr, vi


def grid_plain(acc_r, acc_i, iu0, iv0, cu, cv, yr, yi):
    """The plain PyTorch version of the adjoint, in place:
    ``acc[iu0_b + i, iv0_b + j] += y[b] * (cu[b, i] * cv[b, j])``, each
    pixel's additions in sample order; taps outside the planes (after JAX's
    negative-index rule) are dropped, as the JAX scatter drops them.

    ``index_put_(accumulate=True)`` adds in an order that varies between
    runs on several CPU threads (and on CUDA), so the additions go in
    rounds instead: a stable sort by pixel ranks each pixel's
    contributions in sample order, and round r adds every pixel's r-th
    contribution with one ``index_put_`` over distinct pixels.
    """
    H, Wd = acc_r.shape
    W = cu.shape[1]
    iu, iv = _tap_indices(iu0, iv0, W, H, Wd)
    iu = iu[:, :, None].expand(-1, W, W).reshape(-1)
    iv = iv[:, None, :].expand(-1, W, W).reshape(-1)
    w2 = cu[:, :, None] * cv[:, None, :]
    keep = (iu >= 0) & (iu < H) & (iv >= 0) & (iv < Wd)
    iu, iv = iu[keep], iv[keep]
    vr = (yr[:, None, None] * w2).reshape(-1)[keep]
    vi = (yi[:, None, None] * w2).reshape(-1)[keep]
    if iu.numel() == 0:
        return acc_r, acc_i
    pix = iu * Wd + iv
    order = torch.sort(pix, stable=True).indices
    sp = pix[order]
    pos = torch.arange(sp.numel(), device=sp.device)
    first = torch.ones_like(sp, dtype=torch.bool)
    first[1:] = sp[1:] != sp[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    for r in range(int(rank.max()) + 1):
        sel = order[rank == r]
        idx = (iu[sel], iv[sel])
        acc_r.index_put_(idx, acc_r[idx] + vr[sel])
        acc_i.index_put_(idx, acc_i[idx] + vi[sel])
    return acc_r, acc_i


def grid(acc_r, acc_i, iu0, iv0, cu, cv, yr, yi):
    """The adjoint of B4, a deterministic scatter-add in place:
    ``acc[iu0_b + i, iv0_b + j] += y[b] * cu[b, i] * cv[b, j]``, the
    samples added in input order (no atomics), taps outside the planes
    dropped.

    :param acc_r, acc_i: [H, W'] accumulator planes (updated in place;
        strided views of an interleaved [xA, xA, 2] tensor are fine)
    :param iu0, iv0: [B] int64 first-tap indices
    :param cu, cv: [B, W] tap weights (contiguous)
    :param yr, yi: [B] sample planes (contiguous)
    :return: (acc_r, acc_i)
    """
    tensors, B, W = _vis_shapes("grid", (acc_r, acc_i), iu0, iv0, cu, cv,
                                (yr, yi))
    if _on_cpu(tensors):
        return grid_plain(acc_r, acc_i, iu0, iv0, cu, cv, yr, yi)
    _check_vis_cuda("grid", (acc_r, acc_i), iu0, iv0, (cu, cv, yr, yi))
    H, Wd = acc_r.shape
    if min(B, W, H, Wd) == 0:
        return acc_r, acc_i
    s0, s1 = acc_r.stride()
    with torch.cuda.device(acc_r.device):
        stream = torch.cuda.current_stream(acc_r.device).cuda_stream
        _launch("degrid", acc_r.dtype, f"(B, W, H, W') = ({B}, {W}, {H}, {Wd})",
                acc_r.data_ptr(), acc_i.data_ptr(), s0, s1, H, Wd,
                iu0.data_ptr(), iv0.data_ptr(), cu.data_ptr(), cv.data_ptr(),
                yr.data_ptr(), yi.data_ptr(), B, W, stream, entry="grid")
    grid_stats.record((B, W, H))
    return acc_r, acc_i
