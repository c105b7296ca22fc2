"""Streamed execution on one device: the host, device and sampled
residencies, with the facets resident or streamed in slabs.

The torch twin of the single-device paths of the JAX package's
``swiftly_tpu/parallel/streamed.py``. Both executors default to
``residency="host"``, as the JAX package's do.

Forward (facets -> subgrids):

* ``StreamedForward(residency="host")``: the *FFT facet pass* runs over
  the facets in blocks of ``col_block`` facet columns: each block is
  uploaded, prepared along axis 0 (an FFT of size yN) and cut into every
  subgrid column's contribution rows [K, F, m, Cb], which return to a
  [K, F, m, yB_pad] row buffer in host memory (pinned on the card) through
  a two-deep device-to-host pipeline. Then one column at a time: its rows
  go up and through the column pass.
* ``StreamedForward(residency="device")``: the *sampled facet pass* --
  each group of G subgrid columns' contribution rows [F, G*m, yB] is a
  sampled DFT of the facets: one matrix product against
  ``A[r, j] = Fb[j]/yN * w^(j*kt_r)`` plus a per-facet diagonal phase
  (``w = e^(2 pi i/yN)``, ``kt_r`` the extracted spectral rows). The facets
  either move to the device once and stay (``facet_group`` None or at
  least the facet count, and the stack fits), or stream in slabs of
  ``facet_group`` facets per column group: uploaded from the host through
  a ring of pinned buffers on a copy stream, or synthesised on the device
  from sparse facets (``ops.oracle.SparseRealFacet``). Each slab's
  pre-finish partials add into the group's [G, S, xM, xM] accumulator
  (every stage is linear in the facets), and the finish runs once per
  group.

The facet passes' products are plain ``torch.matmul`` products (the JAX
package leaves them to XLA). The *column pass* takes one column's rows
[F, m, yB], prepares them along axis 1 and gives every subgrid of the
column, through the body ``resolve_colpass`` picks (``SWIFTLY_COLPASS``):
kernel B1 (``ops.kernels.colpass``, ``reduce_f=True``, precomputed
operators ``P_s = sum_f A0_f @ Xn_sf @ B1_f``) for the planar backend, the
operator einsums for the complex backend, or the per-facet FFT chain
(``parallel.batched.facet_contrib_to_subgrid``, batched over subgrids and
facets, so kernel B3 runs its DFTs in a few large launches). The operator
bodies' partials are in image space and finish with a crop and the
masks; the FFT chain's are in grid space and finish with the crop iFFTs.

Backward (subgrids -> facets):

1. *Column pass* -- per column, every facet's contribution block
   ``Z_sf`` (B1 with ``reduce_f=False``, the complex einsum pair, or the
   FFT chain ``parallel.batched.subgrid_contrib_to_facet``, per
   ``resolve_colpass_bwd`` / ``SWIFTLY_COLPASS_BWD``), scattered into the
   column's [F, m, yN] rows one subgrid at a time (a fixed order: within
   one subgrid the destination indices are distinct), then finished along
   axis 1.
2. ``residency="host"`` / ``"device"``: the column's rows [F, m, yB_pad]
   are kept, summed per column offset, in host memory or on the device;
   ``finish`` runs the *FFT facet pass* backwards over blocks of
   ``col_block`` columns of all of them (embed, an FFT of size yN, the
   masks), two deep, into the host facet stack.
   ``residency="sampled"``: the rows of ``fold_group`` columns fold
   straight into the [F, yB, yB] image-space accumulator (or the output
   rows ``row_slab`` of it) through the fold ``resolve_fold_mode`` picks
   (``SWIFTLY_FOLD``): the adjoint sampled DFT (kernel B2,
   ``ops.kernels.fold``, in place for the planar backend, the complex
   einsum fold for the complex one), the FFT fold (the rows embedded in
   the spectrum and finished by an FFT, in chunks of the pass-through
   axis), or the Cooley-Tukey-factored fold (three dense stages of plain
   products).

On the card the planar bodies launch B1, B2 and B3; on the CPU they run
too, and the kernels' wrappers take their plain versions there.

``feed_backward_passes`` feeds one pass over the forward's column groups
to several sampled backward passes (facet subsets, row slabs), on the
device. With a spill cache (`utils.spill.SpillCache`) the first pass over
the stream records it (``StreamedForward.stream_column_groups(spill=...)``:
each group's stack copied to the host on a copy stream, off the
consumer's path) and every later pass replays it from host RAM or disk,
the next group's read and upload started before the current one is
yielded: a partitioned backward (`plan.plan_backward_passes`) costs one
forward plus cache feeds.

The port runs eagerly: columns run in sequence (JAX's ``lax.map`` and
``lax.scan`` chunks), the column-pass operators are built once per
executor, a short final column group is not padded (there is no program
to recompile), and JAX's depth-2 in-flight pipelines and checksum pulls
are CUDA events (``api.FlightQueue``). Every accumulation runs in a fixed
order, so reruns are bit-identical.

`CachedColumnFeed` is the serving path's view of a recorded stream
(`utils.spill.SpillCache`): one host row per lookup, version-gated.

Telemetry and resilience, in the JAX package's vocabulary (`obs`,
`resilience`): the executors' steps are ``metrics.stage`` sites
(``fwd.facet_upload``, ``fwd.sampled_facet_pass``, ``fwd.column_pass``,
``fwd.slab_*``, ``fwd.facet_pass``, ``fwd.drain``, ``bwd.column_pass``,
``bwd.sampled_fold`` / ``bwd.fft_fold`` / ``bwd.ct_fold``,
``bwd.facet_pass``, ``bwd.finish``, ``bwd.drain``, ``spill.*``), the
compute stages with their analytic FLOPs (`utils.flops`); a ``*.drain``
stage is a wait on an in-flight queue's CUDA event, the only place where
the host learns of the device's progress (the stages add no
synchronisation). Counters: ``fwd.subgrids``, ``fwd.passes``,
``bwd.subgrids_folded``, ``bwd.feed_groups``, ``bwd.feed_passes``,
``spill.*``; the gauge ``fwd.plan``. Fault sites: ``transfer.d2h`` /
``transfer.h2d`` (the recording's and the replay's copies, retried on a
transient error) and ``bwd.feed``; a replay whose cache read stays failed
falls back to the forward (degradation record ``spill.replay_fallback``).
A fault or `resilience.WorkerKilled` raised on a worker thread reaches
the consumer when its group is handed over, and the threads are joined
and the pinned chunks released on the way out. `StreamedBackward`
snapshots itself (`utils.checkpoint`) through ``enable_autosave``, at
group boundaries.

Not ported yet: meshes (ROADMAP A8; ``SwiftlyConfig(mesh=...)`` raises
``NotImplementedError``).
"""

from __future__ import annotations

import concurrent.futures
import functools
import logging
import math
import os
import time

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..ops import kernels
from ..ops import planar_backend as plk
from ..ops.core import (
    add_to_subgrid_math,
    extract_from_facet_math,
    extract_from_subgrid_math,
    finish_facet_math,
    prepare_facet_math,
    scaled_offset,
)
from ..resilience import degrade as _degrade
from ..resilience.faults import fault_point
from ..resilience.retry import retry_transient
from ..utils import flops as _flops
from ..utils.flops import (
    resolve_colpass,
    resolve_colpass_bwd,
    resolve_fold_kernel,
    resolve_fold_mode,
)
from .batched import (
    _fold_into,
    _mask_along,
    _split_subgrids,
    facet_contrib_to_subgrid,
    finish_masked_subgrid,
)

logger = logging.getLogger(__name__)

__all__ = [
    "CachedColumnFeed",
    "StreamedBackward",
    "StreamedForward",
    "col_group_for_budget",
    "facet_stack_bytes",
    "feed_backward_passes",
    "grouped_col_group_for_budget",
    "grouped_working_set",
    "resident_working_set",
    "resolve_fold_mode",
    "sampled_row_indices",
    "stream_peak_bytes",
]

_NP_DTYPES = {
    torch.float32: np.float32,
    torch.float64: np.float64,
    torch.complex64: np.complex64,
    torch.complex128: np.complex128,
}


def _planar(core):
    return core.backend == "planar"


def _tail(core):
    """Trailing data-layout axes: the planar backend carries (re, im)."""
    return (2,) if _planar(core) else ()


def _np_dtype(core):
    return np.dtype(_NP_DTYPES[core.dtype])


def _host_array(data):
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def _real_plane_or_none(core, data):
    """The facet's real plane as [yB, yB] float, or None if it has any
    imaginary content (or the backend is not planar).

    Point-source facet models are exactly real; the sampled pass then
    stores and uploads half the bytes and skips half its products.
    """
    if not _planar(core):
        return None
    data = _host_array(data)
    if data.ndim and data.shape[-1] == 2 and not np.iscomplexobj(data):
        if np.any(data[..., 1]):
            return None
        return np.asarray(data[..., 0], dtype=_np_dtype(core))
    if np.iscomplexobj(data) and np.any(data.imag):
        return None
    return np.asarray(data.real, dtype=_np_dtype(core))


def _to_host_layout(core, data):
    """One facet/subgrid as a host numpy array in device layout."""
    data = _host_array(data)
    if _planar(core):
        if data.ndim and data.shape[-1] == 2 and not np.iscomplexobj(data):
            return np.asarray(data, dtype=_np_dtype(core))
        # assign planes directly (casting on write): no full-precision
        # stacked intermediate for multi-GiB facets
        out = np.empty(data.shape + (2,), dtype=_np_dtype(core))
        out[..., 0] = data.real
        out[..., 1] = data.imag
        return out
    return np.asarray(data, dtype=_np_dtype(core))


def _identity(core, n):
    """The n x n identity in the core's layout, on its device."""
    eye = torch.eye(n, dtype=core.real_dtype, device=core.device)
    if _planar(core):
        return torch.stack([eye, torch.zeros_like(eye)], dim=-1)
    return eye.to(core.dtype)


def _nbytes(t):
    return t.numel() * t.element_size()



# ---------------------------------------------------------------------------
# Shared plumbing
# ---------------------------------------------------------------------------


class _StreamedBase:
    def __init__(self, swiftly_config, facet_configs, col_block=512,
                 residency="device"):
        from ..api import _FacetStack

        self.config = swiftly_config
        self.core = swiftly_config.core
        if self.core.backend in ("numpy", "native"):
            raise ValueError(
                "Streamed execution requires a device backend "
                "('torch' or 'planar')"
            )
        if residency not in ("host", "device", "sampled"):
            raise ValueError(
                f"residency must be host|device|sampled, got {residency}"
            )
        if not facet_configs:
            raise ValueError(
                "facet_configs must be non-empty (the streamed paths "
                "size their programs from the first facet)"
            )
        plk.set_matmul_precision()  # full f32 products: no TF32
        self.residency = residency
        self.stack = _FacetStack(facet_configs)
        # the host/device residencies' facet-column blocks: yB_pad is the
        # facet width rounded up to whole blocks (the pad columns are zero)
        self.col_block = int(col_block)
        self._n_blocks = -(-self.stack.size // self.col_block)
        self._yB_pad = self._n_blocks * self.col_block
        dev = self.core.device
        self._foffs0 = torch.as_tensor(
            np.asarray(self.stack.offs0, np.int64), device=dev)
        self._foffs1 = torch.as_tensor(
            np.asarray(self.stack.offs1, np.int64), device=dev)
        rdt = self.core.real_dtype
        self._masks0_dev = torch.as_tensor(self.stack.masks0, dtype=rdt,
                                           device=dev)
        self._masks1_dev = torch.as_tensor(self.stack.masks1, dtype=rdt,
                                           device=dev)

    def _alloc_buffer(self, n_cols):
        """A host row buffer [n_cols, F, m, yB_pad(,2)], pinned when the
        core runs on the card (the column uploads then read it by DMA).
        Not zeroed: the forward facet pass writes every element, the pad
        columns included."""
        core = self.core
        shape = (n_cols, len(self.stack), core.xM_yN_size,
                 self._yB_pad) + _tail(core)
        return torch.empty(shape, dtype=core.dtype,
                           pin_memory=core.device.type == "cuda")


def _group_full_columns(subgrid_configs):
    """Group configs by off0, padding ragged columns to equal length.

    Short columns are padded with zero-mask configs whose rows are
    computed then discarded (exact: masks zero the padded outputs).
    Padded entries carry index None and sit at the END of each column, so
    rows [0:n_real] always match the real items.
    """
    from ..api import _group_columns, _pad_ragged_columns

    groups, rectangular = _group_columns(
        list(enumerate(subgrid_configs)),
        key=lambda item: item[1],
        require_one_size=True,
    )
    if not rectangular:
        size = next(iter(groups.values()))[0][1].size
        _pad_ragged_columns(groups, size)
    return groups


def _real_items(prog_items):
    return [it for it in prog_items if it[0] is not None]


def _column_index(core, offs1):
    """Facet-row positions [S, m] of each subgrid's m contribution columns
    (int64): the wrapped extract + roll of ``extract_from_facet_math`` (and
    the roll + wrapped embed of ``add_to_facet_math``) as one index map,
    ``(yN//2 - m//2 + s + ((j - s) mod m)) mod yN`` with s the scaled
    offset."""
    m, yN = core.xM_yN_size, core.yN_size
    scaled = scaled_offset(offs1, yN, core.N)[:, None]
    j = torch.arange(m, dtype=torch.int64, device=offs1.device)[None, :]
    return torch.remainder(
        yN // 2 - m // 2 + scaled + torch.remainder(j - scaled, m), yN
    )


def _colpass_sblock() -> int:
    """Subgrids per column-pass block (``SWIFTLY_COLPASS_SBLOCK``, default
    512): bounds the gather transient; every catalogue column fits one
    block (S <= 293, at 128k). The JAX package's default, 256, meant the
    same but splits 128k's columns in two."""
    return max(1, int(os.environ.get("SWIFTLY_COLPASS_SBLOCK", "512")))


def _sblocks(S):
    """[(s0, s1)] blocks of at most ``_colpass_sblock()`` subgrids,
    rebalanced to near-equal sizes."""
    Sb = min(_colpass_sblock(), S)
    nb = -(-S // Sb)
    Sb = -(-S // nb)
    return [(s0, min(S, s0 + Sb)) for s0 in range(0, S, Sb)]


# -- sampled-DFT facet pass -------------------------------------------------
#
# The forward facet pass per output row r of subgrid column offset sigma is
# a linear map of the facet column f[j] (j < yB):
#
#   NMBF[r] = (1/yN) sum_j Fb[j] f[j] w^{(e0 + j) * kt_r},  w = e^{+2pi i/yN}
#
# with s = sigma*yN/N, kt_r = ((yN//2 - m//2 + s + ((r - s) mod m)) mod yN)
# - yN//2 the extracted spectral row and e0 = delta - yB//2 the embedding
# shift. The phase separates into w^{e0*kt} (per facet and row) times
# w^{j*kt} (facet-independent), so the pass for any set of rows is one
# complex matrix product plus a per-facet diagonal phase (JAX package,
# swiftly_tpu/parallel/streamed.py:1121-1139).


def sampled_row_indices(core, col_offs0):
    """Centred spectral row indices kt [G*m] (int64) of a group of subgrid
    column offsets."""
    m = core.xM_yN_size
    yN = core.yN_size
    r = np.arange(m)
    rows = []
    for off0 in col_offs0:
        s = int(off0) * yN // core.N
        k = (yN // 2 - m // 2 + s + ((r - s) % m)) % yN
        rows.append(k - yN // 2)
    return np.concatenate(rows).astype(np.int64)


def _mulmod(a, b, yN):
    """``(a*b) mod yN`` on int64 tensors, exact: both factors are reduced
    mod yN first, so the product stays below yN**2 <= 2**32 (the JAX
    package's int32 product overflowed once yN*yB passed 2**31)."""
    return torch.remainder(
        torch.remainder(a, yN) * torch.remainder(b, yN), yN
    )


@functools.lru_cache(maxsize=32)
def _phase_table(yN, dtype, device):
    theta = (2 * np.pi / yN) * np.arange(yN)
    return (
        torch.as_tensor(np.cos(theta), dtype=dtype, device=device),
        torch.as_tensor(np.sin(theta), dtype=dtype, device=device),
    )


def _sampled_phases(core, residues, dtype):
    """(cos, sin) of ``2 pi residues / yN`` for int64 residues in [0, yN):
    a lookup in a float64-computed table of the yN angles, cast to
    `dtype`."""
    cos_t, sin_t = _phase_table(core.yN_size, dtype, str(residues.device))
    return cos_t[residues], sin_t[residues]


def _sampled_A_real(core, yB, dt, krows):
    """The sampled-DFT phase matrix pair (A_re, A_im) [R, yB]."""
    yN = core.yN_size
    fb = core._p.extract_mid(core._Fb, yB, 0).to(dt) / yN  # [yB] real
    j = torch.arange(yB, dtype=torch.int64, device=krows.device)
    a_cos, a_sin = _sampled_phases(
        core, _mulmod(krows[:, None], j[None, :], yN), dt)
    return a_cos.mul_(fb), a_sin.mul_(fb)


def _facet_pass_sampled(core, facets, e0, krows, real_facets=False):
    """Resident facets -> sampled contribution rows [F, R, yB(,2)].

    `facets` is a tuple: (Fr,) real planes [F, yB, yB] with
    ``real_facets`` (planar only: no imaginary plane, half the products),
    (Fr, Fi) planar planes, or (facets,) complex. `krows` [R] are centred
    spectral indices (``sampled_row_indices``), `e0` [F] the per-facet
    embedding shifts (facet_off0 - yB//2). The products run one column
    (m rows) at a time into the output, which bounds the transients to
    [F, m, yB] planes; every row is independent, so this is the JAX
    package's single einsum, chunked.
    """
    yN = core.yN_size
    F, yB = facets[0].shape[0], facets[0].shape[1]
    R = krows.shape[0]
    step = core.xM_yN_size
    if _planar(core):
        dt = facets[0].dtype
        out = torch.empty((F, R, yB, 2), dtype=dt, device=facets[0].device)
    else:
        dt = core.real_dtype
        out = torch.empty((F, R, yB), dtype=core.dtype,
                          device=facets[0].device)
    for r0 in range(0, R, step):
        kr = krows[r0:r0 + step]
        A_re, A_im = _sampled_A_real(core, yB, dt, kr)
        # the per-facet phase w^(e0_f kt_r), [F, rows, 1]
        p_cos, p_sin = _sampled_phases(
            core, _mulmod(e0[:, None], kr[None, :], yN), dt)
        p_cos, p_sin = p_cos[..., None], p_sin[..., None]
        dst = out[:, r0:r0 + step]
        if not _planar(core):
            (fc,) = facets
            torch.mul(torch.matmul(torch.complex(A_re, A_im), fc),
                      torch.complex(p_cos, p_sin), out=dst)
            continue
        if real_facets:
            (Fr,) = facets
            o_re = torch.matmul(A_re, Fr)  # [F, rows, yB]
            o_im = torch.matmul(A_im, Fr)
        else:
            Fr, Fi = facets
            o_re = torch.matmul(A_re, Fr) - torch.matmul(A_im, Fi)
            o_im = torch.matmul(A_re, Fi) + torch.matmul(A_im, Fr)
        torch.sub(o_re * p_cos, o_im * p_sin, out=dst[..., 0])
        torch.add(o_re * p_sin, o_im * p_cos, out=dst[..., 1])
        del o_re, o_im
    return out


# -- forward column pass ----------------------------------------------------
#
# After the axis-1 preparation every per-facet op of the forward column
# pass is linear with a fixed [xM, m] operator: the axis-0 chain (fft,
# roll, Fn window, wrapped embed) is a matrix A0_f, the axis-1 chain a
# matrix B1_f, and the finish iFFTs fold into them. The whole column pass
# is then P_s = sum_f A0_f @ X_sf @ B1_f, X_sf gathering subgrid s's m
# columns of the prepared rows, and the finish is a crop + masks. The
# operators come from applying the *_math chain to an identity block.


def _group_tensors(core, groups, grp):
    """A column group's device tensors: the sampled rows' spectral indices
    krows [G*m], and per column and subgrid (zero-mask padding included)
    the offsets [G, S, 2] and the masks [G, S, xA] along each axis."""
    from ..api import _subgrid_masks

    dev = core.device
    krows = torch.as_tensor(sampled_row_indices(core, grp), device=dev)
    items = [groups[off0] for off0 in grp]
    sg_offs = [[(sg.off0, sg.off1) for _, sg in col] for col in items]
    masks = [[_subgrid_masks(sg) for _, sg in col] for col in items]
    m0, m1 = ([[mk[a] for mk in col] for col in masks] for a in (0, 1))
    rdt = core.real_dtype
    return (krows,
            torch.as_tensor(np.asarray(sg_offs, np.int64), device=dev),
            torch.as_tensor(np.asarray(m0), dtype=rdt, device=dev),
            torch.as_tensor(np.asarray(m1), dtype=rdt, device=dev))


def _colpass_operators(core, foffs0, foffs1):
    """Forward column-pass operators, built from an identity.

    A0 [F, xM, m(,2)]: axis-0 ``add_to_subgrid_math`` with the finish iFFT
    folded along the output axis. B1 [F, m, xM(,2)]: the axis-1 operator
    in row-basis layout (B1[f, j, b] = op1_f[b, j]), iFFT folded.
    """
    p = core._p
    m, xM = core.xM_yN_size, core.xM_size
    F = foffs0.shape[0]
    eye = _identity(core, m)
    eye = eye.expand((F,) + tuple(eye.shape))
    A0 = p.ifft(add_to_subgrid_math(p, core._Fn, xM, core.N, eye, foffs0,
                                    -2), -2)
    B1 = p.ifft(add_to_subgrid_math(p, core._Fn, xM, core.N, eye, foffs1,
                                    -1), -1)
    return A0, B1


def _crop_masked_subgrid(core, P, sg_offs, subgrid_size, mask0, mask1):
    """Finish image-space padded subgrids P [S, xM, xM(,2)]: crop both axes
    at the subgrid offsets [S, 2] and apply the masks [S, xA] (the iFFTs
    already live in the operators)."""
    p = core._p
    out = p.wrapped_extract(P, subgrid_size, sg_offs[:, 0], -2)
    out = p.wrapped_extract(out, subgrid_size, sg_offs[:, 1], -1)
    out = _mask_along(p, out, mask0, -2)
    return _mask_along(p, out, mask1, -1)


def _prepare_rows(core, NMBF, foffs1):
    """A column's rows [F, m, yB(,2)] prepared along axis 1 -> [F, m, yN]."""
    return prepare_facet_math(core._p, core._Fb, core.yN_size, NMBF, foffs1,
                              -1)


def _ceinsum(core, spec, a, b):
    """A complex einsum written for the logical axes: complex tensors
    directly, planar ones as four real einsums (the JAX package's
    ``_ceinsum``)."""
    if not _planar(core):
        return torch.einsum(spec, a, b)
    ar, ai, br, bi = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    return torch.stack([
        torch.einsum(spec, ar, br) - torch.einsum(spec, ai, bi),
        torch.einsum(spec, ar, bi) + torch.einsum(spec, ai, br),
    ], dim=-1)


def _colpass_einsum_body(core, ops, NMBF_BF, sg_offs):
    """The column's image-space partials P [S, xM, xM(,2)] through the
    operator einsums (the complex backend's body; on the planar backend
    with ``SWIFTLY_COLPASS=einsum``), as kernel B1 computes them: a
    gather of each subgrid's m columns of NMBF_BF, then A0 @ X and a
    K = F*m contraction with B1. (The JAX package applies A0 to all yN
    columns first, an [F, xM, yN] product; gathering first does the same
    sums over S*m columns, far fewer than yN on a partial cover.)"""
    A0, B1 = ops
    parts = []
    for s0, s1 in _sblocks(sg_offs.shape[0]):
        idx = _column_index(core, sg_offs[s0:s1, 1])  # [Sb, m]
        X = _ceinsum(core, "fai,fisj->fasj", A0, NMBF_BF[:, :, idx])
        parts.append(_ceinsum(core, "fasj,fjb->sab", X, B1))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _colpass_kernel_blocks(core, ops, NMBF_BF, sg_offs):
    """Kernel B1's partials of one column, planar, per subgrid block:
    yields (s0, s1, P_re, P_im) with P_s = sum_f A0_f @ Xn_sf @ B1_f,
    where Xn_sf gathers the subgrid's m columns of NMBF_BF directly (the
    gather commutes past the first product, so the [F, xM, yN] H transient
    never exists). The planes go to the kernel as strided views of the
    interleaved tensors."""
    A0, B1 = ops
    for s0, s1 in _sblocks(sg_offs.shape[0]):
        idx = _column_index(core, sg_offs[s0:s1, 1])  # [Sb, m]
        Xn = NMBF_BF[:, :, idx].permute(2, 0, 1, 3, 4)  # [Sb, F, m, m, 2]
        Pr, Pi = kernels.colpass(
            A0[..., 0], A0[..., 1], Xn[..., 0], Xn[..., 1],
            B1[..., 0], B1[..., 1], reduce_f=True,
        )
        yield s0, s1, Pr, Pi


def _colpass_kernel_body(core, ops, NMBF_BF, sg_offs):
    """The same partials as the einsum body, planar, through kernel B1
    (`_colpass_kernel_blocks`), as one [S, xM, xM, 2] tensor."""
    parts = [torch.stack([Pr, Pi], dim=-1) for _, _, Pr, Pi in
             _colpass_kernel_blocks(core, ops, NMBF_BF, sg_offs)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _column_partials(core, mode, ops, NMBF_BF, foffs0, foffs1, sg_offs):
    """One column's pre-finish partials [S, xM, xM(,2)] from its prepared
    rows NMBF_BF [F, m, yN(,2)], through the body `mode`
    (``resolve_colpass``): "kernel" (B1) and "einsum" give image-space
    partials with the prebuilt operators `ops`; "fft" (the per-facet FFT
    chain, the JAX package's ``_column_pass_fwd_fft_fn`` with
    ``finish=False``) gives grid-space ones and takes no operators.
    Partials of one mode pair only with `_finish_partials` of the same."""
    if mode == "kernel":
        return _colpass_kernel_body(core, ops, NMBF_BF, sg_offs)
    if mode == "einsum":
        return _colpass_einsum_body(core, ops, NMBF_BF, sg_offs)
    return facet_contrib_to_subgrid(core, NMBF_BF, foffs0, foffs1,
                                    sg_offs[:, 1]).sum(dim=1)


def _finish_partials(core, mode, P, sg_offs, subgrid_size, mask0, mask1):
    """Partials [S, xM, xM(,2)] of body `mode` -> finished subgrids
    [S, xA, xA(,2)]: a crop and the masks for the operator bodies (their
    iFFTs live in the operators), the crop iFFTs too for the FFT chain."""
    if mode == "fft":
        return finish_masked_subgrid(core, P, [sg_offs[:, 0], sg_offs[:, 1]],
                                     subgrid_size, mask0, mask1)
    return _crop_masked_subgrid(core, P, sg_offs, subgrid_size, mask0, mask1)


def _column_pass_fwd(core, subgrid_size, mode, ops, NMBF, foffs0, foffs1,
                     sg_offs, mask0, mask1):
    """One column's rows [F, m, yB(,2)] -> its finished subgrids
    [S, xA, xA(,2)] through body `mode` (the JAX package's
    ``_column_pass_fwd_fn``)."""
    NMBF_BF = _prepare_rows(core, NMBF, foffs1)
    P = _column_partials(core, mode, ops, NMBF_BF, foffs0, foffs1, sg_offs)
    del NMBF_BF
    return _finish_partials(core, mode, P, sg_offs, subgrid_size, mask0,
                            mask1)


def _column_pass_fwd_group(core, subgrid_size, mode, ops, buf, foffs0,
                           foffs1, sg_offs_g, masks0_g, masks1_g):
    """Sampled group buffer [F, G*m, yB(,2)] -> subgrids [G, S, xA, xA(,2)].

    The group's columns run in sequence (JAX's ``lax.map``), each through
    `_column_pass_fwd`: one B1 launch per column on the card with the
    default planar body."""
    m = core.xM_yN_size
    G, S = sg_offs_g.shape[0], sg_offs_g.shape[1]
    out = torch.empty((G, S, subgrid_size, subgrid_size) + _tail(core),
                      dtype=buf.dtype, device=buf.device)
    for g in range(G):
        out[g] = _column_pass_fwd(
            core, subgrid_size, mode, ops, buf[:, g * m:(g + 1) * m], foffs0,
            foffs1, sg_offs_g[g], masks0_g[g], masks1_g[g])
    return out


# -- facet-slab forward step -----------------------------------------------
#
# A facet stack larger than the device (9 facets of 45056^2 at 128k: 73 GB
# as real f32 planes) streams in slabs of Fg facets within each column
# group. Every stage of the forward is linear in the facets, so each slab's
# PRE-FINISH partials [S, xM, xM] add into the group's accumulator, and the
# finish runs once per group (JAX package, streamed.py:2101-2240).


def _column_slab_step(core, mode, ops, buf, foffs0, foffs1, sg_offs_g, acc):
    """``acc [G, S, xM, xM(,2)] +=`` one facet slab's pre-finish partials
    of body `mode`, in place. `buf` [Fg, G*m, yB(,2)] holds the slab's
    sampled rows for the whole column group, `ops` the slab's operators,
    `foffs0`/`foffs1` [Fg] its facets' offsets. Columns run one at a time:
    with B1, one launch per subgrid block (reducing over the slab's
    facets), added block by block; the other bodies add a column's
    partials with a plain ``add_``."""
    m = core.xM_yN_size
    for g in range(acc.shape[0]):
        NMBF_BF = _prepare_rows(core, buf[:, g * m:(g + 1) * m], foffs1)
        if mode == "kernel":
            for s0, s1, Pr, Pi in _colpass_kernel_blocks(core, ops, NMBF_BF,
                                                         sg_offs_g[g]):
                acc[g, s0:s1, ..., 0].add_(Pr)
                acc[g, s0:s1, ..., 1].add_(Pi)
                del Pr, Pi
        else:
            acc[g].add_(_column_partials(core, mode, ops, NMBF_BF, foffs0,
                                         foffs1, sg_offs_g[g]))
        del NMBF_BF
    return acc


def _column_group_finish(core, mode, subgrid_size, acc, sg_offs_g, masks0_g,
                         masks1_g):
    """A group's accumulated partials [G, S, xM, xM(,2)] of body `mode` ->
    finished subgrids [G, S, xA, xA(,2)], once per group, one column at a
    time (the JAX package's ``_column_group_finish_fn``)."""
    G, S = acc.shape[0], acc.shape[1]
    out = torch.empty((G, S, subgrid_size, subgrid_size) + _tail(core),
                      dtype=acc.dtype, device=acc.device)
    for g in range(G):
        out[g] = _finish_partials(core, mode, acc[g], sg_offs_g[g],
                                  subgrid_size, masks0_g[g], masks1_g[g])
    return out


# -- backward column pass ---------------------------------------------------


def _bwd_scatter_rows(core, Z, sg_offs):
    """One column's per-subgrid contribution blocks [S, F, m, m(,2)] ->
    the [F, m, yN(,2)] accumulator of the column.

    Block row j of subgrid s lands at facet-row position
    ``_column_index(s)[j]`` (the roll + wrapped embed of
    ``add_to_facet_math``). Neighbouring subgrids' windows overlap, and
    ``index_add_`` on CUDA adds with atomics, so the subgrids are added
    one at a time, in order: within one subgrid the m positions are
    distinct, so every element receives its sums in a fixed order and
    reruns are bit-identical.
    """
    F = Z.shape[1]
    m, yN = core.xM_yN_size, core.yN_size
    acc = torch.zeros((F, m, yN) + _tail(core), dtype=Z.dtype,
                      device=Z.device)
    idx = _column_index(core, sg_offs[:, 1])
    for s in range(Z.shape[0]):
        acc.index_add_(2, idx[s], Z[s])
    return acc


def _bwd_colpass_operators(core, foffs0, foffs1):
    """Backward (adjoint) column-pass operators, built from an identity.

    E0 [F, m, xM(,2)]: the axis-0 ``extract_from_subgrid_math`` chain with
    the prepare-fft folded in. E1 [F, xM, m(,2)]: the axis-1 chain in
    row-basis layout (E1[f, b, j] = op1_f[j, b]).
    """
    p = core._p
    m, xM = core.xM_yN_size, core.xM_size
    F = foffs0.shape[0]
    eye = _identity(core, xM)

    def batch(a):
        return a.expand((F,) + tuple(a.shape))

    E0 = extract_from_subgrid_math(p, core._Fn, m, xM, core.N,
                                   batch(p.fft(eye, 0)), foffs0, -2)
    E1 = extract_from_subgrid_math(p, core._Fn, m, xM, core.N,
                                   batch(p.fft(eye, 1)), foffs1, -1)
    return E0, E1


def _column_pass_bwd(core, facet_size, mode, ops, subgrids, sg_offs,
                     foffs0, foffs1, masks1, out):
    """A column's subgrids [S, xA, xA(,2)] -> its finished rows
    [F, m, yB(,2)], written into `out`.

    Per block of subgrids (`_sblocks`, rebalanced), every facet's
    contribution block Z_sf through the body `mode`
    (``resolve_colpass_bwd``): "kernel", B1 with ``reduce_f=False``
    (Z_sf = E0_f @ emb_s @ E1_f with the adjoint operators `ops`, the
    embedded subgrid broadcast over the facets); "einsum", the same two
    K = xM products as einsums; "fft", the per-(subgrid, facet) FFT chain
    (``parallel.batched._split_subgrids``: prepare, then both extracts,
    batched over [Sb, F], no operators). Then the scatter into the
    column's [F, m, yN] rows, block by block, the axis-1 finish and the
    facet masks (the JAX package's ``_column_pass_bwd_fn``)."""
    p = core._p
    xM = core.xM_size
    if mode != "fft":
        E0, E1 = ops
        emb = p.wrapped_embed(subgrids, xM, sg_offs[:, 0], -2)
        emb = p.wrapped_embed(emb, xM, sg_offs[:, 1], -1)  # [S, xM, xM(,2)]
    acc = None
    for s0, s1 in _sblocks(sg_offs.shape[0]):
        if mode == "fft":
            Z = _split_subgrids(core, subgrids[s0:s1], sg_offs[s0:s1, 0],
                                sg_offs[s0:s1, 1], foffs0, foffs1)
        elif mode == "kernel":
            blk = emb[s0:s1]
            Zr, Zi = kernels.colpass(
                E0[..., 0], E0[..., 1], blk[:, None, ..., 0],
                blk[:, None, ..., 1], E1[..., 0], E1[..., 1],
                reduce_f=False,
            )
            Z = torch.stack([Zr, Zi], dim=-1)  # [Sb, F, m, m, 2]
            del Zr, Zi
        else:
            Y = _ceinsum(core, "fia,sab->sfib", E0, emb[s0:s1])
            Z = _ceinsum(core, "sfib,fbj->sfij", Y, E1)
            del Y
        part = _bwd_scatter_rows(core, Z, sg_offs[s0:s1])
        acc = part if acc is None else acc.add_(part)
        del Z, part
    rows = finish_facet_math(p, core._Fb, facet_size, acc, foffs1, -1)
    out.copy_(_mask_along(p, rows, masks1, -1))
    return out


def _column_pass_bwd_group(core, facet_size, mode, ops, subgrids_g,
                           sg_offs_g, foffs0, foffs1, masks1):
    """A group of columns' subgrids [g, S, xA, xA(,2)] -> their rows
    concatenated along R, [F, g*m, yB(,2)]: the sampled folds' layout,
    written in place (no transpose copy). Columns run in sequence."""
    m = core.xM_yN_size
    g = subgrids_g.shape[0]
    F = foffs0.shape[0]
    out = torch.empty((F, g * m, facet_size) + _tail(core),
                      dtype=subgrids_g.dtype, device=subgrids_g.device)
    for j in range(g):
        _column_pass_bwd(core, facet_size, mode, ops, subgrids_g[j],
                         sg_offs_g[j], foffs0, foffs1, masks1,
                         out[:, j * m:(j + 1) * m])
    return out


# -- sampled-DFT backward fold (the exact adjoint) -------------------------
#
# The backward facet pass along axis 0 is, per facet f and output row i,
#
#   out[f, i] = fb[i] * sum_k sum_r rows_k[f, r] * w^{-kt_r (e0_f + i)}
#
# (no 1/yN: the fft is unnormalised), the conjugate-phase transpose of the
# forward's sampled product, accumulated straight into the [F, yB, yB]
# image-space facet accumulator (JAX package, streamed.py:1348-1367).


def _fold_row_block(F, yB, itemsize):
    """Output-row block size of the fold (``SWIFTLY_FOLD_BLOCK_MB``,
    default 192): bounds the einsum fold's [F, B, yB] transients, and
    gives B2 its row block."""
    target = float(os.environ.get("SWIFTLY_FOLD_BLOCK_MB", "192")) * 1e6
    per_row = max(1, F * yB * itemsize)
    B = int(target // per_row)
    if B >= yB:
        return yB
    return max(1, (B // 128) * 128 or B)


def _bwd_sampled_fold(core, acc, rows, e0, krows, row0=0):
    """``acc [F, Rs, yB(,2)] += `` the adjoint sampled fold of rows
    [F, R, yB(,2)], in place, for the facets' output rows
    [row0, row0 + Rs) (the whole facet: row0 = 0, Rs = yB).

    `krows` [R] are the rows' centred spectral indices and `e0` [F] the
    per-facet embedding shifts. The accumulator's rows run in blocks of
    ``_fold_row_block``; the last block is clamped to end at the last row,
    and its weight ``keep`` zeroes the rows the previous block already
    folded, so the tiling is exact for any height. A block's phases and
    window weights are those of its absolute facet rows (``row0`` +
    the block's rows), so a row slab folds exactly what the whole facet's
    fold gives those rows. The body is ``resolve_fold_kernel``'s: for the
    planar backend each block is one call of B2, which updates the block
    where it lies in the accumulator; for the complex backend one complex
    product.
    """
    yN = core.yN_size
    F, Rs = acc.shape[0], acc.shape[1]
    yB = rows.shape[2]  # the full facet width (the pass-through axis)
    kernel = resolve_fold_kernel(core) == "kernel"
    dt = core.real_dtype
    fb = core._p.extract_mid(core._Fb, yB, 0).to(dt)  # no 1/yN
    p_cos, p_sin = _sampled_phases(
        core, _mulmod(e0[:, None], krows[None, :], yN), dt)  # [F, R]
    p_cos, p_sin = p_cos[..., None], p_sin[..., None]
    # conjugate per-facet phase: rows * w^{-e0_f kt_r}
    if kernel:
        Rr, Ri = rows[..., 0], rows[..., 1]
        Rr2 = Rr * p_cos + Ri * p_sin
        Ri2 = Ri * p_cos - Rr * p_sin
    else:
        rows2 = rows * torch.complex(p_cos, -p_sin)
    B = min(_fold_row_block(F, yB, acc.element_size()), Rs)
    n_blk = -(-Rs // B)
    for i0 in range(0, n_blk * B, B):
        start = min(i0, Rs - B)
        jj = start + torch.arange(B, dtype=torch.int64, device=acc.device)
        b_cos, b_sin = _sampled_phases(
            core, _mulmod(krows[:, None], row0 + jj[None, :], yN), dt)  # [R, B]
        w = fb[row0 + start:row0 + start + B] * (jj >= i0).to(dt)
        cur = acc[:, start:start + B]  # [F, B, yB(,2)] view
        if kernel:
            kernels.fold(cur[..., 0], cur[..., 1], b_cos, b_sin, Rr2, Ri2, w)
        else:
            Bm = torch.complex(b_cos, -b_sin).transpose(0, 1)  # [B, R]
            cur += torch.matmul(Bm, rows2) * w[None, :, None]
    return acc


# -- FFT backward fold -------------------------------------------------------
#
# The same accumulation as the sampled fold, as the adjoint chain: embed
# each column's rows at its spectral window (``add_to_facet_math``), ONE
# FFT of size yN along the output axis (``finish_facet_math``), add into
# the image accumulator. Its cost per fold is F FFTs over the pass-through
# axis, flat in the number of columns folded. The [F, yN, Cj] spectrum is
# bounded by chunking the pass-through axis j; the last chunk is clamped
# to end at the last column and its ``keep`` weight zeroes the columns the
# previous chunk already folded, so the tiling is exact for any yB (JAX
# package, streamed.py:1680-1775).


def _fft_fold_chunk(core, F, yB) -> int:
    """The FFT fold's j-chunk width: its spectrum [F, yN, Cj(,2)] near
    ``SWIFTLY_FFT_FOLD_CHUNK_MB`` (default 96), rounded down to a multiple
    of 128 columns where that leaves any."""
    target = float(os.environ.get("SWIFTLY_FFT_FOLD_CHUNK_MB", "96")) * 1e6
    dsize = _np_dtype(core).itemsize * (2 if _planar(core) else 1)
    per_col = max(1, F * core.yN_size * dsize)
    C = int(target // per_col)
    if C >= yB:
        return yB
    return max(1, (C // 128) * 128 or C)


def _bwd_fft_fold(core, acc, rows, col_offs0, foffs0):
    """``acc [F, yB, yB(,2)] +=`` the FFT fold of the concatenated rows
    [F, g*m, yB(,2)] of the columns at `col_offs0`, in place, chunk by
    chunk of the pass-through axis; `foffs0` [F] are the facets' axis-0
    offsets. The accumulator contract is the sampled fold's (Fb applied,
    the axis-0 masks left to the finish)."""
    p = core._p
    m, yN = core.xM_yN_size, core.yN_size
    F, yB = acc.shape[0], acc.shape[1]
    Cj = min(_fft_fold_chunk(core, F, yB), yB)
    for j0 in range(0, yB, Cj):
        start = min(j0, yB - Cj)
        spec = acc.new_zeros((F, yN, Cj) + _tail(core))
        for k, off0 in enumerate(col_offs0):
            _fold_into(core, spec, rows[:, k * m:(k + 1) * m, start:start + Cj],
                       int(off0), -2)
        out = finish_facet_math(p, core._Fb, yB, spec, foffs0, -2)
        del spec
        j = start + torch.arange(Cj, device=acc.device)
        keep = (j >= j0).to(core.real_dtype)
        acc[:, :, start:start + Cj] += out * p.broadcast_along(keep, 3, 2)
    return acc


# -- Cooley-Tukey backward fold -----------------------------------------------
#
# The sampled fold out[f, i, j] = fb[i] sum_r rows2[f, r, j] W^{-kt_r i}
# (W = e^{2 pi i/yN}, rows2 the rows with the per-facet phase W^{-e0 kt}
# applied) factored over kt_r = Q*a_r + b_r and i = q*P + p (P = yN/Q):
#
#   W^{-kt i} = e^{-2 pi i a p/P} * e^{-2 pi i b p/yN} * e^{-2 pi i b q/Q}
#
# gives three dense stages: the rows grouped by b-lane (a fixed gather: a
# column's m consecutive kt values hit each lane ceil(m/Q) times at most)
# contracted with their a-phases, G[b, p, j]; the twiddle
# e^{-2 pi i b p/yN}; and one [q, b] DFT product, out[q*P + p, j]. Exact
# index algebra; plain products (JAX package, streamed.py:1800-2025).


def _ct_fold_tables(core, col_offs0):
    """The CT fold's index tables for one fold's columns, in exact int64
    host arithmetic: (Q, P, kmax, r_idx, a_vals). ``r_idx[c, b, k]`` is the
    row (into the g*m concatenated rows) of the k-th row of column c in
    lane b (0 for pads), ``a_vals[c, b, k]`` its a-value in [0, P), -1 for
    pads (their contributions are masked)."""
    yN = core.yN_size
    m = core.xM_yN_size
    Q = math.gcd(128, yN)
    P = yN // Q
    kmax = -(-m // Q) if m >= Q else 1
    g = len(col_offs0)
    kt = sampled_row_indices(core, col_offs0)  # [g*m] int64
    r_idx = np.zeros((g, Q, kmax), dtype=np.int64)
    a_vals = np.full((g, Q, kmax), -1, dtype=np.int64)
    fill = np.zeros((g, Q), dtype=np.int64)
    for c in range(g):
        for rp in range(m):
            r = c * m + rp
            b = int(kt[r] % Q)
            k = fill[c, b]
            r_idx[c, b, k] = r
            a_vals[c, b, k] = int((kt[r] // Q) % P)
            fill[c, b] += 1
    return Q, P, kmax, r_idx, a_vals


def _ct_fold_width(yB, all_planes_bytes) -> int:
    """The CT fold's j-window: the largest divisor of yB that keeps all
    facets' stage planes near ``SWIFTLY_CT_FOLD_MB`` (default 4096)."""
    target = float(os.environ.get("SWIFTLY_CT_FOLD_MB", "4096")) * 1e6
    want = max(1, int(np.ceil(all_planes_bytes / target)))
    for n in range(want, yB + 1):
        if yB % n == 0:
            return yB // n
    return 1


def _bwd_ct_fold(core, acc, rows, e0, krows, col_offs0):
    """``acc [F, yB, yB(,2)] +=`` the CT-factored adjoint sampled fold of
    the concatenated rows [F, g*m, yB(,2)] of the columns at `col_offs0`,
    in place, one j-window and one facet at a time. `e0` [F] are the
    per-facet embedding shifts and `krows` [g*m] the rows' centred
    spectral indices (as for the sampled fold). Every phase is a lookup in
    the float64 table of the yN angles (``_sampled_phases``), at residues
    reduced exactly (``_mulmod``); both backends run the same real
    products on (re, im) planes."""
    yN = core.yN_size
    F, yB = acc.shape[0], acc.shape[1]
    dev = acc.device
    dt = core.real_dtype
    Q, P, kmax, r_idx, a_vals = _ct_fold_tables(core, col_offs0)
    g = r_idx.shape[0]
    itemsize = _np_dtype(core).itemsize
    planes = 2 * F * yN * yB * (itemsize if _planar(core) else itemsize // 2)
    W = _ct_fold_width(yB, planes)
    Qi = -(-yB // P)  # output rows i = q*P + p, q < Qi

    def phases(residues):  # e^{-2 pi i residues/yN} as (re, im)
        c, s_ = _sampled_phases(core, residues, dt)
        return c, -s_

    p_cos, p_sin = _sampled_phases(
        core, _mulmod(e0[:, None], krows[None, :], yN), dt)  # [F, R]
    a = torch.as_tensor(a_vals, device=dev)
    pj = torch.arange(P, dtype=torch.int64, device=dev)
    bj = torch.arange(Q, dtype=torch.int64, device=dev)
    qj = torch.arange(Qi, dtype=torch.int64, device=dev)
    # stage 1: e^{-2 pi i a p/P} = W^{-Q (a p mod P)}, zero on the pads
    T_re, T_im = phases(Q * torch.remainder(a.clamp(min=0)[..., None] * pj, P))
    pad = (a >= 0).to(dt)[..., None]
    T_re, T_im = T_re * pad, T_im * pad  # [g, Q, kmax, P]
    # stage 2: e^{-2 pi i b p/yN} (b p < Q P = yN)
    W2_re, W2_im = phases(bj[:, None] * pj[None, :])  # [Q, P]
    W2_re, W2_im = W2_re[..., None], W2_im[..., None]
    # stage 3: e^{-2 pi i q b/Q} = W^{-P (q b mod Q)}
    D_re, D_im = phases(P * torch.remainder(qj[:, None] * bj[None, :], Q))
    fb = core._p.extract_mid(core._Fb, yB, 0).to(dt)[:, None]  # no 1/yN
    flat = torch.as_tensor(r_idx.reshape(-1), device=dev)

    def cmul(spec, ar, ai, br, bi):
        return (torch.einsum(spec, ar, br) - torch.einsum(spec, ai, bi),
                torch.einsum(spec, ar, bi) + torch.einsum(spec, ai, br))

    for j0 in range(0, yB, W):
        for f in range(F):
            blk = rows[f, :, j0:j0 + W]  # [R, W(,2)]
            if _planar(core):
                Rr, Ri = blk[..., 0], blk[..., 1]
            else:
                Rr, Ri = blk.real, blk.imag
            pc, ps = p_cos[f, :, None], p_sin[f, :, None]
            # rows * W^{-e0_f kt_r}, gathered into lanes [g, Q, kmax, W]
            Gr = (Rr * pc + Ri * ps)[flat].reshape(g, Q, kmax, W)
            Gi = (Ri * pc - Rr * ps)[flat].reshape(g, Q, kmax, W)
            G_re, G_im = cmul("cbkp,cbkj->bpj", T_re, T_im, Gr, Gi)
            del Gr, Gi
            G2_re = G_re * W2_re - G_im * W2_im
            G2_im = G_im * W2_re + G_re * W2_im
            del G_re, G_im
            O_re, O_im = cmul("qb,bpj->qpj", D_re, D_im, G2_re, G2_im)
            del G2_re, G2_im
            O_re = O_re.reshape(Qi * P, W)[:yB] * fb
            O_im = O_im.reshape(Qi * P, W)[:yB] * fb
            cur = acc[f, :, j0:j0 + W]
            if _planar(core):
                cur[..., 0] += O_re
                cur[..., 1] += O_im
            else:
                cur += torch.complex(O_re, O_im)
            del O_re, O_im
    return acc


# -- the host/device residencies' FFT facet passes ---------------------------


def _facet_pass_fwd(core, block, foffs0, col_offs0, out):
    """A facet block [F, yB, Cb(,2)] of all facets' columns -> every
    subgrid column's contribution rows, written into `out`
    [K, F, m, Cb(,2)]: prepared along axis 0 (Fb window, embed, an iFFT of
    size yN) with the facets' offsets `foffs0` [F], then each column's
    rows extracted at its offset (the JAX package's
    ``_facet_pass_fwd_fn``)."""
    p = core._p
    prep = prepare_facet_math(p, core._Fb, core.yN_size, block, foffs0, -2)
    for k, off0 in enumerate(col_offs0):
        out[k] = extract_from_facet_math(p, core.xM_yN_size, core.N,
                                         core.yN_size, prep, int(off0), -2)
    return out


def _facet_pass_bwd(core, facet_size, blocks, col_offs0, foffs0, masks0):
    """The columns' rows, one block [F, m, Cb(,2)] per column offset in
    `col_offs0` -> the facets' block [F, yB, Cb(,2)]: each embedded at its
    spectral window and summed in order, then finished along axis 0 (an
    FFT of size yN, the crop, Fb) and masked (the JAX package's
    ``_facet_pass_bwd_fn``)."""
    p = core._p
    acc = None
    for blk, off0 in zip(blocks, col_offs0):
        if acc is None:
            acc = blk.new_zeros((blk.shape[0], core.yN_size) +
                                tuple(blk.shape[2:]))
        _fold_into(core, acc, blk, int(off0), -2)
    out = finish_facet_math(p, core._Fb, facet_size, acc, foffs0, -2)
    return _mask_along(p, out, masks0, -2)


class _HostPipe:
    """A two-deep device-to-host pipeline: `put` starts a non-blocking
    copy of a device tensor into one of two pinned staging buffers and then
    hands the previous one, once its copy has landed (a CUDA event), to
    ``consume(tag, host_tensor)``. A staging buffer is written again two
    puts later, after the host consumed it. On the CPU the copies are
    plain."""

    def __init__(self, consume, cuda):
        self._consume = consume
        self._cuda = cuda
        self._stage = [None, None]
        self._pending = None
        self._n = 0

    def put(self, tag, dev):
        i = self._n % 2
        self._n += 1
        st = self._stage[i]
        if st is None or st.shape != dev.shape:
            st = self._stage[i] = torch.empty(dev.shape, dtype=dev.dtype,
                                              pin_memory=self._cuda)
        st.copy_(dev, non_blocking=self._cuda)
        ev = None
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev.device))
        prev, self._pending = self._pending, (tag, st, ev)
        if prev is not None:
            self._land(prev)

    def _land(self, item):
        tag, st, ev = item
        if ev is not None:
            ev.synchronize()
        self._consume(tag, st)

    def flush(self):
        if self._pending is not None:
            item, self._pending = self._pending, None
            self._land(item)


# bytes of each of the two pinned buffers a spill copy is staged through
_SPILL_STAGE_BYTES = 256 * 2**20


class _PinnedStaging:
    """Copies between device tensors and pageable host tensors through two
    pinned chunk buffers of `_SPILL_STAGE_BYTES` on a copy stream of their
    own, double-buffered: a chunk's device copy runs while the host copies
    the other buffer. The calling thread blocks on the chunks' events, so
    a caller runs it on a worker thread to keep it off the consumer's
    path. The pinned memory stays two chunks whatever the stack's size."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._bufs = None
        self._events = [None, None]  # the last device copy of each buffer

    def _buffers(self, dtype, step):
        if self._bufs is None or self._bufs[0].dtype != dtype:
            self._bufs = [torch.empty(step, dtype=dtype, pin_memory=True)
                          for _ in range(2)]
        return self._bufs

    @staticmethod
    def _chunks(n, itemsize):
        step = max(1, _SPILL_STAGE_BYTES // itemsize)
        return step, [(c0, min(step, n - c0)) for c0 in range(0, n, step)]

    def _reuse(self, i):
        ev, self._events[i] = self._events[i], None
        if ev is not None:
            ev.synchronize()

    def to_host(self, src, dst, ready):
        """Device `src` into host `dst` (both contiguous, same shape),
        after the event `ready` on the producer's stream."""
        s, d = src.reshape(-1), dst.reshape(-1)
        step, chunks = self._chunks(s.numel(), s.element_size())
        bufs = self._buffers(s.dtype, step)
        self.stream.wait_event(ready)
        pending = None
        for i, (c0, k) in enumerate(chunks):
            st = bufs[i % 2][:k]
            with torch.cuda.stream(self.stream):
                st.copy_(s[c0:c0 + k], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self.stream)
            if pending is not None:
                self._land(*pending, d)
            pending = (ev, st, c0, k)
        if pending is not None:
            self._land(*pending, d)

    @staticmethod
    def _land(ev, st, c0, k, d):
        ev.synchronize()
        d[c0:c0 + k].copy_(st)

    def to_device(self, src):
        """Host `src` as a new device tensor allocated on the copy stream;
        returns it and the event that marks its last copy."""
        s = src.reshape(-1)
        with torch.cuda.stream(self.stream):
            out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        o = out.view(-1)
        step, chunks = self._chunks(s.numel(), s.element_size())
        bufs = self._buffers(s.dtype, step)
        ev = None
        for i, (c0, k) in enumerate(chunks):
            self._reuse(i % 2)
            st = bufs[i % 2][:k]
            st.copy_(s[c0:c0 + k])
            with torch.cuda.stream(self.stream):
                o[c0:c0 + k].copy_(st, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self.stream)
            self._events[i % 2] = ev
        if ev is None:  # an empty tensor
            ev = torch.cuda.Event()
            ev.record(self.stream)
        return out, ev

    def close(self):
        """Drain the copy stream and release the pinned chunks (after a
        kill or a fault, before the staging is dropped)."""
        self.stream.synchronize()
        self._bufs = None
        self._events = [None, None]


class _StreamRecorder:
    """Records a column-group stream into a spill cache, off the
    consumer's path.

    `put` hands a group's device stack to a worker thread, which copies it
    into a new host array through `_PinnedStaging` (the copy stream waits
    for the compute stream's event, so the copy starts as soon as the
    stack is computed and runs beside the consumer's work and the next
    group's) and puts it in the cache, in stream order. The worker holds
    the stack until its copy has landed; `put` waits for the previous
    group's recording before handing over the next, so at most one stack
    is held back (the sizers price it: ``spill_out_stacks``). Entries are
    ordinary host arrays, as ``get_row`` and the disk tier expect. After an
    eviction (``gave_up``) nothing more is copied. On the CPU each group is
    copied and put inline.

    The copy is the fault site ``transfer.d2h``, retried on a transient
    error (``spill.write`` stage, ``spill.writes`` / ``spill.bytes_written``
    counters). An error or `resilience.WorkerKilled` raised on the worker
    reaches the consumer at the next `put` or at `close`; `close` joins the
    worker and releases the pinned chunks either way."""

    def __init__(self, spill, device):
        self._spill = spill
        self._cuda = device.type == "cuda"
        self._fut = None
        self._tctx = _trace.current()
        self._stats = {"mode": "record", "groups": 0, "bytes": 0,
                       "land_s": 0.0, "blocked_s": 0.0}
        self._staging = _PinnedStaging(device) if self._cuda else None
        self._pool = (concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="swiftly-spill-record")
            if self._cuda else None)

    def put(self, meta, out_g):
        if self._spill.gave_up:
            return
        self._stats["groups"] += 1
        self._stats["bytes"] += out_g.numel() * out_g.element_size()
        if not self._cuda:
            t0 = time.perf_counter()

            def pull():
                fault_point("transfer.d2h")
                with _metrics.stage("spill.write") as st:
                    host = out_g.detach().numpy().copy()
                    st.bytes_moved = host.nbytes
                return host

            self._store(meta, retry_transient(pull, site="transfer.d2h"))
            self._stats["land_s"] += time.perf_counter() - t0
            return
        self._wait()
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(out_g.device))
        self._fut = self._pool.submit(self._record, meta, out_g, ready)

    def _wait(self):
        if self._fut is not None:
            t0 = time.perf_counter()
            fut, self._fut = self._fut, None
            fut.result()
            self._stats["blocked_s"] += time.perf_counter() - t0

    def _store(self, meta, host):
        if not self._spill.gave_up and self._spill.put(meta, host):
            _metrics.count("spill.writes")
            _metrics.count("spill.bytes_written", int(host.nbytes))

    def _record(self, meta, out_g, ready):
        if _trace.current() != self._tctx:
            _trace.adopt(self._tctx)
        t0 = time.perf_counter()
        host = torch.empty(out_g.shape, dtype=out_g.dtype)

        def pull():
            fault_point("transfer.d2h")
            with _metrics.stage("spill.write") as st:
                self._staging.to_host(out_g, host, ready)
                st.bytes_moved = _nbytes(host)

        retry_transient(pull, site="transfer.d2h")
        del out_g
        self._store(meta, host.numpy())
        self._stats["land_s"] += time.perf_counter() - t0

    def close(self, wait=True):
        """Wait for the last recording (raising the worker's error, if
        any); with ``wait=False`` (an abandoned stream: a fault, a kill)
        only stop the worker. Either way the worker is joined, the copy
        stream drained and the pinned chunks released."""
        if self._pool is None:
            return
        try:
            if wait:
                self._wait()
        finally:
            self._pool.shutdown(wait=True, cancel_futures=not wait)
            self._staging.close()

    def stats(self):
        return dict(self._stats)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


class StreamedForward:
    """Facets -> subgrids with bounded device residency.

    :param swiftly_config: SwiftlyConfig (device backend: "torch" or
        "planar")
    :param facet_tasks: list of (FacetConfig, facet_data) pairs; the data
        is a numpy array or tensor (complex, planar, or a real plane), a
        `SparseRealFacet` (``make_sparse_facet``), or a callable returning
        one (built when the executor is made, one facet at a time).
        Sparse facets stay sparse for the planar backend with
        ``residency="device"``, which synthesises them on the device, when
        every facet is sparse; else they are densified.
    :param col_block: ("host") facet columns per block of the FFT facet
        pass, the device working-set knob
    :param residency: "host" (default): the FFT facet pass into a host
        row buffer, each column's rows uploaded for its column pass (scales
        to any N whose rows fit host memory); "device": each column
        group's rows are a sampled DFT of the facets on the device, with
        no row buffer at all (the facets resident, or streamed in slabs)
    :param col_group: ("device") columns per sampled group (None: the
        largest that fits the device memory budget,
        ``col_group_for_budget`` or, for facet slabs,
        ``grouped_col_group_for_budget``)
    :param facet_group: ("device") facets on the device at once. None: all
        of them if the stack fits the budget, else slabs of 1. Below the
        facet count, each column group streams the facets in slabs of
        `facet_group`.
    """

    def __init__(self, swiftly_config, facet_tasks, col_block=512,
                 residency="host", col_group=None, facet_group=None):
        from ..ops.oracle import SparseRealFacet

        if residency == "sampled":
            raise ValueError(
                "residency='sampled' is a StreamedBackward strategy; the "
                "forward equivalent is residency='device' (sampled DFT)"
            )
        self._base = _StreamedBase(
            swiftly_config, [cfg for cfg, _ in facet_tasks], col_block,
            residency)
        core = self.core = self._base.core
        self.stack = self._base.stack
        # Facet data held on the host in device layout, one array per facet.
        # All-real facets (planar) are kept as single real planes: half the
        # host memory and upload, and the sampled pass skips the zero
        # imaginary plane's products. Sparse facets stay sparse where the
        # device synthesises them (the planar backend's sampled paths).
        sparse_ok = _planar(core) and residency == "device"
        store, real_flags, sparse_flags = [], [], []
        for _, d in facet_tasks:
            raw = d() if callable(d) else d
            if isinstance(raw, SparseRealFacet):
                if sparse_ok:
                    store.append(raw)
                    real_flags.append(True)
                    sparse_flags.append(True)
                    continue
                raw = raw.densify(_np_dtype(core))
            plane = _real_plane_or_none(core, raw)
            if plane is not None:
                store.append(plane)
                real_flags.append(True)
            else:
                store.append(_to_host_layout(core, raw))
                real_flags.append(False)
            sparse_flags.append(False)
            del raw
        # all or nothing: a mixed stack densifies its sparse facets (the
        # synthesis writes whole slabs)
        self._facets_sparse = all(sparse_flags)
        if not self._facets_sparse:
            for i, is_sparse in enumerate(sparse_flags):
                if is_sparse:
                    store[i] = store[i].densify(_np_dtype(core))
        self._facets_real = all(real_flags)
        if not self._facets_real and any(real_flags):
            # mixed: re-expand the real planes to planar pairs
            for i, (s, is_real) in enumerate(zip(store, real_flags)):
                if is_real:
                    pair = np.zeros(s.shape + (2,), dtype=s.dtype)
                    pair[..., 0] = s
                    store[i] = pair
        self._facet_data = store
        self._slab_pixels = {}  # (i0, i1) -> device (flat index, value)
        self._nmbf = None  # ("host") the row buffer [K, F, m, yB_pad(,2)]
        self._col_index = None  # ("host") off0 -> its index in the buffer
        self._pass_stats = None  # ("host") the facet pass's seconds, bytes
        self.col_group = col_group
        self.facet_group = facet_group
        self._dev_facets = None
        self._ops = None
        self.last_plan = None
        # device bytes the CALLER keeps resident while streaming (e.g. a
        # backward's accumulator): subtracted from the budget the
        # column-group sizer sees
        self.hbm_headroom = 0
        # extra finished [G, S, xA, xA] stacks the sizers must price: a
        # recording stream holds one back until its copy to the host lands
        self.spill_out_stacks = 0
        # the last stream_column_groups(spill=...) call: what it did with
        # the cache, its groups and bytes, and its host seconds
        self.last_spill = None

    # -- sparse synthesis --------------------------------------------------

    def _synth_slab(self, i0, i1):
        """Facets [i0, i1) as a real slab [i1 - i0, yB, yB] synthesised on
        the device: the pixels (each once, duplicates summed on the host in
        index order as ``SparseRealFacet.densify`` sums them) assigned into
        zeros. Facets past the stack are zero. The pixels go up once per
        slab and stay cached."""
        core = self.core
        yB = self._base.stack.size
        key = (i0, i1)
        if key not in self._slab_pixels:
            idx, vals = [], []
            for j, i in enumerate(range(i0, min(i1, len(self._facet_data)))):
                flat, v = self._facet_data[i].coalesced(_np_dtype(core))
                idx.append(flat + j * yB * yB)
                vals.append(v)
            idx = np.concatenate(idx) if idx else np.zeros(0, np.int64)
            vals = (np.concatenate(vals) if vals
                    else np.zeros(0, _np_dtype(core)))
            self._slab_pixels[key] = (
                torch.as_tensor(idx, device=core.device),
                torch.as_tensor(vals, device=core.device),
            )
        idx, vals = self._slab_pixels[key]
        slab = torch.zeros((i1 - i0, yB, yB), dtype=core.real_dtype,
                           device=core.device)
        slab.view(-1)[idx] = vals  # distinct indices: no accumulation
        return slab

    def synth_facet_device(self, i):
        """Facet i's dense real plane [yB, yB], synthesised on the device
        (sparse facets only): equal, bit for bit, to its ``densify()``
        uploaded."""
        if not self._facets_sparse:
            raise ValueError("synth_facet_device requires sparse facets")
        return self._synth_slab(i, i + 1)[0]

    # -- facet residency ---------------------------------------------------

    def _upload_resident_facets(self):
        """Move the facet stack to the device once: real planes [F, yB, yB]
        (synthesised on the device from sparse facets), planar (re, im)
        planes as two such tensors (the sampled pass never slices planes
        out of a stacked tensor), or complex facets."""
        core = self.core
        yB = self.stack.size
        F = len(self.stack)
        dev = core.device

        def upload(planes_of):
            dt = core.dtype if not _planar(core) else core.real_dtype
            out = torch.empty((F, yB, yB), dtype=dt, device=dev)
            for i, d in enumerate(self._facet_data):
                out[i].copy_(torch.from_numpy(np.ascontiguousarray(
                    planes_of(d))))
            return out

        with _metrics.stage("fwd.facet_upload") as st:
            if self._facets_sparse:
                self._dev_facets = (self._synth_slab(0, F),)
            elif self._facets_real:
                self._dev_facets = (upload(lambda d: d),)
            elif _planar(core):
                self._dev_facets = (upload(lambda d: d[..., 0]),
                                    upload(lambda d: d[..., 1]))
            else:
                self._dev_facets = (upload(lambda d: d),)
            st.bytes_moved = sum(_nbytes(t) for t in self._dev_facets)

    def _hbm_budget(self):
        """Device bytes this executor may use (None = unlimited: the CPU).

        Through the one parser `plan.hbm_budget_bytes`, with the executors'
        semantics (``honor_env_on_cpu=False``): ``SWIFTLY_HBM_BUDGET`` on
        the card if set, else ``torch.cuda.mem_get_info`` 's free bytes,
        plus what PyTorch's allocator holds cached but unused, plus the
        resident facets once uploaded (the sizer prices them itself); less
        ``hbm_headroom``.
        """
        from ..plan.model import hbm_budget_bytes

        held = 0
        if self._dev_facets is not None:
            held = sum(t.numel() * t.element_size() for t in self._dev_facets)
        return hbm_budget_bytes(headroom=self.hbm_headroom,
                                device=self.core.device,
                                honor_env_on_cpu=False, held=held)

    def _facet_stack_fits(self):
        """Whether the whole facet stack can stay resident with room for
        at least a one-column working set."""
        budget = self._hbm_budget()
        if budget is None:
            return True
        return facet_stack_bytes(self._base, self._facets_real) + 3e9 <= budget

    def _auto_col_group(self, n_cols):
        """Largest column group whose buffer and transients fit the budget
        (the whole column set on the CPU)."""
        budget = self._hbm_budget()
        if budget is None:
            return n_cols
        return col_group_for_budget(self._base, budget, n_cols,
                                    real=self._facets_real,
                                    extra_out_stacks=self.spill_out_stacks)

    # -- streaming ---------------------------------------------------------

    def _operators(self):
        if self._ops is None:
            self._ops = _colpass_operators(self.core, self._base._foffs0,
                                           self._base._foffs1)
        return self._ops

    def _sampled_generator(self, groups, size, whole_groups=False):
        """The resident generator, or the facet-slab one when `facet_group`
        is below the facet count or (None) the stack does not fit the
        budget: the one place that choice is made."""
        fg = self.facet_group
        if fg is None and not self._facet_stack_fits():
            fg = 1
        if fg is not None and fg < self._base.stack.n_total:
            return self._grouped_device_columns(groups, size, fg,
                                                whole_groups=whole_groups)
        return self._device_columns(groups, size, whole_groups=whole_groups)

    def _device_columns(self, groups, subgrid_size, whole_groups=False):
        """Facets-resident sampled-DFT pass in column groups.

        Per group: one sampled facet pass into a [F, G*m, yB] buffer, then
        the group's column passes; nothing returns to the host. The host
        waits for the previous group to finish before it starts the next
        (a CUDA event), so at most one group's work is queued ahead.
        """
        from ..api import FlightQueue

        base = self._base
        core = base.core
        dev = core.device
        yB = base.stack.size
        if self._dev_facets is None:
            self._upload_resident_facets()
        e0 = torch.as_tensor(
            (np.asarray(base.stack.offs0) - yB // 2).astype(np.int64),
            device=dev)
        col_offs0 = list(groups)
        G = self.col_group or self._auto_col_group(len(col_offs0))
        colpass = resolve_colpass(core, base.stack.n_total)
        self.last_plan = {"mode": "resident", "col_group": G,
                          "colpass": colpass}
        ops = self._operators() if colpass != "fft" else None
        fp_flops = cp_flops = 0
        if _metrics.enabled():
            _metrics.gauge("fwd.plan", dict(self.last_plan))
            S = len(next(iter(groups.values())))
            F = base.stack.n_real
            fp_flops = _flops.sampled_facet_pass_flops(
                core, F, yB, core.xM_yN_size, self._facets_real)
            cp_flops = _flops.column_pass_flops(core, F, S, subgrid_size,
                                                colpass)
        inflight = FlightQueue(1, stage="fwd.drain")
        for g0 in range(0, len(col_offs0), G):
            grp = col_offs0[g0:g0 + G]
            # one span a column group, closed before the yield (a
            # generator's context is the consumer's between yields)
            with _trace.span("fwd.column_group", cat="fwd", group=g0 // G,
                             n_cols=len(grp)):
                krows, sg_offs_g, m0_g, m1_g = _group_tensors(core, groups,
                                                              grp)
                with _metrics.stage("fwd.sampled_facet_pass",
                                    flops=fp_flops * len(grp)):
                    buf = _facet_pass_sampled(core, self._dev_facets, e0,
                                              krows, self._facets_real)
                with _metrics.stage("fwd.column_pass",
                                    flops=cp_flops * len(grp)):
                    out_g = _column_pass_fwd_group(
                        core, subgrid_size, colpass, ops, buf, base._foffs0,
                        base._foffs1, sg_offs_g, m0_g, m1_g)  # [G, S, xA, xA(,2)]
                del buf
                inflight.admit([out_g])
            self._count_group(groups, grp)
            if whole_groups:
                yield [_real_items(groups[off0]) for off0 in grp], out_g
                continue
            for gi, off0 in enumerate(grp):
                yield _real_items(groups[off0]), out_g[gi]

    @staticmethod
    def _count_group(groups, grp):
        if _metrics.enabled():
            _metrics.count("fwd.subgrids", sum(len(_real_items(groups[o]))
                                               for o in grp))
            _metrics.count("fwd.column_groups")

    def _grouped_device_columns(self, groups, subgrid_size, facet_group,
                                whole_groups=False):
        """Sampled-DFT pass streaming facet slabs: stacks larger than the
        device.

        Column groups of G are the outer loop; within one, the facets come
        in slabs of `facet_group` (zero-padded to a whole number of slabs),
        each synthesised on the device (sparse facets) or uploaded from the
        host, and each slab's pre-finish partials add into the group's
        [G, S, xM, xM] accumulator (`_column_slab_step`); the crop and
        masks run once per group (`_column_group_finish`). The device holds
        `slab_depth` slabs, the accumulator and one slab's sampled rows,
        whatever N.

        Host slabs go up through a ring of pinned staging buffers, copied
        without blocking on a copy stream into `slab_depth` device buffers;
        CUDA events fence each buffer's reuse (a staging buffer until its
        copy has run, a device buffer until the step that read it has run).
        A background thread fills the next staging buffer while the current
        slab computes (``SWIFTLY_STREAM_PREFETCH=0`` turns it off).
        """
        from ..api import FlightQueue

        base = self._base
        core = base.core
        dev = core.device
        cuda = dev.type == "cuda"
        yB = base.stack.size
        F_total = base.stack.n_total
        Fg = int(facet_group)
        n_slabs = -(-F_total // Fg)
        F_pad = n_slabs * Fg
        col_offs0 = list(groups)
        S = len(next(iter(groups.values())))
        # slab depth: 2 overlaps a slab's upload with the previous slab's
        # compute; where two slabs alone would take half the budget, 1
        budget = self._hbm_budget()
        fsize = _np_dtype(core).itemsize * (
            1 if self._facets_real else (2 if _planar(core) else 1))
        slab_bytes = Fg * yB * yB * fsize
        depth = 2
        if budget is not None and 2 * slab_bytes > 0.5 * budget:
            depth = 1
        if self.col_group:
            G = max(1, int(self.col_group))
        elif budget is None:
            G = len(col_offs0)
        else:
            G = grouped_col_group_for_budget(
                base, budget, len(col_offs0), S, subgrid_size,
                self._facets_real, Fg, 1,
                slab_depth=1 if self._facets_sparse else depth,
                extra_out_stacks=self.spill_out_stacks)
        G = min(G, len(col_offs0))
        n_groups = -(-len(col_offs0) // G)
        use_prefetch = (
            not self._facets_sparse
            and os.environ.get("SWIFTLY_STREAM_PREFETCH", "1") != "0"
            and n_slabs * n_groups > 1
        )
        colpass = resolve_colpass(core, Fg)
        self.last_plan = {
            "mode": "grouped", "col_group": G, "facet_group": Fg,
            "n_slabs": n_slabs, "slab_depth": depth,
            "facet_source": ("device-synth-sparse" if self._facets_sparse
                             else "host"),
            "colpass": colpass, "stream_prefetch": use_prefetch,
        }
        fp_flops = step_flops = 0
        if _metrics.enabled():
            _metrics.gauge("fwd.plan", dict(self.last_plan))
            fp_flops = _flops.sampled_facet_pass_flops(
                core, Fg, yB, core.xM_yN_size, self._facets_real)
            # the whole column pass's FLOPs attributed to the slab step (the
            # group finish's crop is folded in)
            step_flops = _flops.column_pass_flops(core, Fg, S, subgrid_size,
                                                  colpass)

        # per-slab facet metadata, zero-padded to F_pad facets
        pad = np.zeros(F_pad - F_total, np.int64)
        offs0 = np.concatenate([np.asarray(base.stack.offs0, np.int64), pad])
        offs1 = np.concatenate([np.asarray(base.stack.offs1, np.int64), pad])
        e0 = torch.as_tensor(offs0 - yB // 2, device=dev)
        foffs0 = torch.as_tensor(offs0, device=dev)
        foffs1 = torch.as_tensor(offs1, device=dev)
        if colpass != "fft":
            A0, B1 = _colpass_operators(core, foffs0, foffs1)

        # planar facets: real planes, or (re, im) pairs; complex facets
        n_planes = 2 if (_planar(core) and not self._facets_real) else 1
        if not self._facets_sparse:
            n_stage = 3 if use_prefetch else 2
            stage = [[torch.empty((Fg, yB, yB), dtype=core.dtype,
                                  pin_memory=cuda) for _ in range(n_planes)]
                     for _ in range(n_stage)]
            ring = [[torch.empty((Fg, yB, yB), dtype=core.dtype, device=dev)
                     for _ in range(n_planes)] for _ in range(depth)]
            copy_stream = torch.cuda.Stream(dev) if cuda else None
        copied = {}  # dispatch -> event: its staging buffer was copied
        stepped = {}  # dispatch -> event: its device buffer was read

        def wait(events, d):
            ev = events.pop(d, None)
            if ev is not None:
                ev.synchronize()

        tctx = _trace.current()

        def fill(d):
            """Stage slab d (facets from (d % n_slabs) * Fg) in its pinned
            buffer, once the copy that last read the buffer has run."""
            if _trace.current() != tctx:
                _trace.adopt(tctx)
            with _metrics.stage("fwd.slab_prefetch"):
                return _fill(d)

        def _fill(d):
            wait(copied, d - n_stage)
            bufs = stage[d % n_stage]
            s0 = (d % n_slabs) * Fg
            for k in range(Fg):
                i = s0 + k
                for pi, buf in enumerate(bufs):
                    if i >= base.stack.n_real:
                        buf[k].zero_()
                    elif n_planes == 2:
                        buf[k].copy_(torch.from_numpy(
                            self._facet_data[i][..., pi]))
                    else:
                        buf[k].copy_(torch.from_numpy(self._facet_data[i]))
            return bufs

        def upload(d, bufs):
            """Slab d's staged planes into device buffer d % depth."""
            dst = ring[d % depth]
            if not cuda:
                for a, b in zip(dst, bufs):
                    a.copy_(b)
                return tuple(dst)
            prev = stepped.pop(d - depth, None)
            with torch.cuda.stream(copy_stream):
                if prev is not None:
                    copy_stream.wait_event(prev)
                for a, b in zip(dst, bufs):
                    a.copy_(b, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(copy_stream)
            copied[d] = ev
            torch.cuda.current_stream(dev).wait_event(ev)
            return tuple(dst)

        prefetch = None
        fut = None  # (dispatch, future)
        if use_prefetch:
            prefetch = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="swiftly-slab-stage")
            fut = (0, prefetch.submit(fill, 0))
        n_dispatch = n_slabs * n_groups
        d = 0  # slab dispatches so far, continuous across groups
        xM = core.xM_size
        inflight = FlightQueue(1, stage="fwd.drain")
        try:
            for g0 in range(0, len(col_offs0), G):
                grp = col_offs0[g0:g0 + G]
                # one span a column group, entered and exited explicitly so
                # it closes before the yield
                grp_span = _trace.span("fwd.column_group", cat="fwd",
                                       group=g0 // G, n_cols=len(grp))
                grp_span.__enter__()
                krows, sg_offs_g, m0_g, m1_g = _group_tensors(core, groups,
                                                              grp)
                acc = torch.zeros((len(grp), S, xM, xM) + _tail(core),
                                  dtype=core.dtype, device=dev)
                for s0 in range(0, F_pad, Fg):
                    with _metrics.stage("fwd.slab_upload") as st:
                        if self._facets_sparse:
                            slab = (self._synth_slab(s0, s0 + Fg),)
                        else:
                            if fut is not None and fut[0] == d:
                                bufs = fut[1].result()
                            else:
                                bufs = fill(d)
                            fut = None
                            slab = upload(d, bufs)
                            if prefetch is not None and d + 1 < n_dispatch:
                                fut = (d + 1, prefetch.submit(fill, d + 1))
                        st.bytes_moved = sum(_nbytes(t) for t in slab)
                    sl = slice(s0, s0 + Fg)
                    with _metrics.stage("fwd.sampled_facet_pass",
                                        flops=fp_flops * len(grp)):
                        buf = _facet_pass_sampled(core, slab, e0[sl], krows,
                                                  self._facets_real)
                    del slab
                    ops = None if colpass == "fft" else (A0[sl], B1[sl])
                    with _metrics.stage("fwd.slab_step",
                                        flops=step_flops * len(grp)):
                        _column_slab_step(core, colpass, ops, buf, foffs0[sl],
                                          foffs1[sl], sg_offs_g, acc)
                    del buf
                    if cuda and not self._facets_sparse:
                        ev = torch.cuda.Event()
                        ev.record(torch.cuda.current_stream(dev))
                        stepped[d] = ev
                    d += 1
                with _metrics.stage("fwd.group_finish"):
                    out_g = _column_group_finish(core, colpass, subgrid_size,
                                                 acc, sg_offs_g, m0_g, m1_g)
                del acc
                inflight.admit([out_g])
                grp_span.__exit__(None, None, None)
                self._count_group(groups, grp)
                if whole_groups:
                    yield [_real_items(groups[off0]) for off0 in grp], out_g
                    continue
                for gi, off0 in enumerate(grp):
                    yield _real_items(groups[off0]), out_g[gi]
        finally:
            if prefetch is not None:
                prefetch.shutdown(wait=True, cancel_futures=True)

    # -- host residency: the FFT facet pass --------------------------------

    def _facet_block(self, j0, out):
        """Facet columns [j0, j0 + Cb) of every facet into the host tensor
        `out` [F, yB, Cb(,2)] (zero past the facet's edge): the real planes
        alone for real facets on the planar backend (the device adds the
        zero imaginary plane), else the facets' device layout."""
        yB = self._base.stack.size
        j1 = min(j0 + self._base.col_block, yB)
        for i, data in enumerate(self._facet_data):
            out[i, :, :j1 - j0].copy_(torch.from_numpy(data[:, j0:j1]))
            out[i, :, j1 - j0:].zero_()
        return out

    def _build_nmbf(self, col_offs0):
        """The FFT facet pass into the host row buffer: per block of
        ``col_block`` facet columns, an upload, the pass on the device
        (`_facet_pass_fwd`) and the rows [K, F, m, Cb] back into buffer
        columns [j0, j0 + Cb), two deep (`_HostPipe`)."""
        base = self._base
        core = base.core
        dev = core.device
        cuda = dev.type == "cuda"
        stack = base.stack
        F, yB, Cb = len(stack), stack.size, base.col_block
        t0 = time.perf_counter()
        buf = base._alloc_buffer(len(col_offs0))
        real = self._facets_real and _planar(core)
        in_shape = (F, yB, Cb) + (() if real else _tail(core))
        in_dtype = core.real_dtype if real else core.dtype
        # two upload stages: block b's is written again at block b + 2,
        # after block b's rows landed on the host (the pipe's event), so
        # its upload, which came before them on the stream, is done
        stages = [torch.empty(in_shape, dtype=in_dtype, pin_memory=cuda)
                  for _ in range(2)]
        out = None
        h2d = d2h = 0

        def land(j0, host):
            buf[:, :, :, j0:j0 + Cb] = host

        pipe = _HostPipe(land, cuda)
        for b, j0 in enumerate(range(0, base._yB_pad, Cb)):
            block = self._facet_block(j0, stages[b % 2])
            h2d += block.numel() * block.element_size()
            block = block.to(dev, non_blocking=cuda)
            if real:
                planar = torch.zeros(block.shape + (2,), dtype=block.dtype,
                                     device=dev)
                planar[..., 0] = block
                block = planar
            if out is None:
                out = torch.empty((len(col_offs0), F, core.xM_yN_size, Cb) +
                                  _tail(core), dtype=core.dtype, device=dev)
            with _metrics.stage("fwd.facet_pass"):
                _facet_pass_fwd(core, block, base._foffs0, col_offs0, out)
            del block
            d2h += out.numel() * out.element_size()
            with _metrics.stage("fwd.d2h", bytes_moved=_nbytes(out)):
                pipe.put(j0, out)
        with _metrics.stage("fwd.d2h"):
            pipe.flush()
        self._nmbf = buf
        self._col_index = {int(o): k for k, o in enumerate(col_offs0)}
        return {"facet_pass_s": time.perf_counter() - t0,
                "facet_h2d_bytes": h2d, "facet_d2h_bytes": d2h}

    def _host_columns(self, groups, subgrid_size):
        """The host residency's stream: the FFT facet pass (once per
        executor and column set), then per column its rows
        [F, m, yB_pad] uploaded from the host buffer and its column pass
        (the body ``resolve_colpass`` picks), one column at a time."""
        from ..api import FlightQueue

        base = self._base
        core = base.core
        dev = core.device
        yB = base.stack.size
        col_offs0 = list(groups)
        if self._nmbf is None or any(int(o) not in self._col_index
                                     for o in col_offs0):
            self._pass_stats = self._build_nmbf(col_offs0)
        colpass = resolve_colpass(core, base.stack.n_total)
        ops = self._operators() if colpass != "fft" else None
        plan = self.last_plan = dict(
            self._pass_stats, mode="host", col_block=base.col_block,
            n_blocks=base._n_blocks, colpass=colpass, column_uploads=0,
            column_upload_bytes=0)
        cp_flops = 0
        if _metrics.enabled():
            _metrics.gauge("fwd.plan", dict(plan))
            cp_flops = _flops.column_pass_flops(
                core, base.stack.n_real, len(next(iter(groups.values()))),
                subgrid_size, colpass)
        inflight = FlightQueue(2, stage="fwd.drain")
        for off0 in col_offs0:
            host = self._nmbf[self._col_index[int(off0)]]
            with _metrics.stage("fwd.h2d", bytes_moved=_nbytes(host)):
                NMBF = host.to(dev, non_blocking=dev.type == "cuda")[:, :, :yB]
            plan["column_uploads"] += 1
            plan["column_upload_bytes"] += host.numel() * host.element_size()
            _, sg_offs, m0, m1 = _group_tensors(core, groups, [off0])
            with _metrics.stage("fwd.column_pass", flops=cp_flops):
                out = _column_pass_fwd(core, subgrid_size, colpass, ops, NMBF,
                                       base._foffs0, base._foffs1, sg_offs[0],
                                       m0[0], m1[0])
            del NMBF
            inflight.admit([out])
            self._count_group(groups, [off0])
            yield _real_items(groups[off0]), out

    def stream_column_groups(self, subgrid_configs, spill=None):
        """Yield (per_col_items, group_subgrids) per column group of the
        sampled paths (``residency="device"``): `per_col_items` holds one
        list per column of [(input_index, SubgridConfig), ...],
        `group_subgrids` the group's device tensor [G, S, xA, xA(,2)]
        (rows past a column's items are its zero-mask padding). For
        consumers that take a whole group at once
        (``StreamedBackward.add_subgrid_group``).

        With `spill` (a `utils.spill.SpillCache`) the stream is recorded:
        the first call runs one forward pass and copies each group's stack
        to the host on a copy stream while the consumer and the next group
        compute (`_StreamRecorder`); every later call with a complete cache
        yields the same stream, bit for bit, from host RAM or disk, with
        the next group's read and upload started before the current group
        is yielded (`_replay_spilled_groups`), and no forward. A partitioned
        backward of P passes thus costs one forward and P cache feeds. A
        fill over the cache's budget with no disk gives up, and every later
        call runs the forward without recording; a cache read that fails
        mid-replay (``OSError``) marks the cache given up and runs the
        forward for the rest of the stream, from exactly that group. A
        complete cache recorded for another cover raises ``ValueError``.
        ``last_spill`` says what the call did.
        """
        if self._base.residency != "device":
            raise ValueError(
                "stream_column_groups is a sampled-path (residency="
                "'device') API"
            )
        subgrid_configs = list(subgrid_configs)
        groups = _group_full_columns(subgrid_configs)
        size = subgrid_configs[0].size
        spill_tag = (
            len(subgrid_configs), size,
            (subgrid_configs[0].off0, subgrid_configs[0].off1),
            (subgrid_configs[-1].off0, subgrid_configs[-1].off1),
        )
        if spill is not None and spill.complete:
            if spill.tag != spill_tag:
                raise ValueError(
                    f"spill cache holds a different subgrid stream "
                    f"(tag {spill.tag} != {spill_tag}); reset() it or "
                    "pass the cover it was recorded for"
                )
            _metrics.count("spill.replay_feeds")
            n_yielded = 0
            try:
                for item in self._replay_spilled_groups(spill):
                    yield item
                    n_yielded += 1
                return
            except OSError as exc:
                # a cached group could not be read: run the forward for
                # the rest of this pass, from exactly that group (groups
                # stream in a fixed order); slower, never wrong
                logger.warning(
                    "spill cache read failed at group %d (%s: %s); "
                    "running the forward for the rest of this pass",
                    n_yielded, type(exc).__name__, exc,
                )
                _degrade.record(
                    "spill", "replay_fallback",
                    f"group {n_yielded}: {type(exc).__name__}: {exc}",
                )
                _metrics.count("spill.fallback_replays")
                _metrics.count("fwd.passes")
                spill.gave_up = True
                spill.complete = False
                self.last_spill = dict(self.last_spill or {},
                                       mode="replay-fallback",
                                       fallback_from_group=n_yielded)
                gen = self._sampled_generator(groups, size, whole_groups=True)
                for k, item in enumerate(gen):
                    if k >= n_yielded:
                        yield item
                return
        if spill is not None and spill.gave_up:
            # an earlier fill overflowed the budget: recording again would
            # overflow again, so run the forward without the copies
            spill = None
            self.last_spill = {"mode": "forward-gave-up"}
            _metrics.count("spill.fallback_replays")
        elif spill is None:
            self.last_spill = None
        _metrics.count("fwd.passes")
        if spill is None:
            yield from self._sampled_generator(groups, size,
                                               whole_groups=True)
            return
        # the sizers price the stack held back until its copy lands
        self.spill_out_stacks = 1
        recorder = _StreamRecorder(spill, self.core.device)
        try:
            spill.begin_fill(tag=spill_tag)
            for per_col, out_g in self._sampled_generator(groups, size,
                                                          whole_groups=True):
                recorder.put(per_col, out_g)
                yield per_col, out_g
            recorder.close()
            spill.end_fill()
        finally:
            self.spill_out_stacks = 0
            recorder.close(wait=False)
            self.last_spill = recorder.stats()

    def cached_feed(self, spill):
        """A `CachedColumnFeed` over a stream this forward recorded (one
        complete ``stream_column_groups(spill=...)`` pass): the serving
        view of the cache a partitioned backward reads in order."""
        return CachedColumnFeed(spill)

    def _replay_spilled_groups(self, spill):
        """Yield a complete cache's stream, uploaded to the device.

        Group k + 1's host read and upload start before group k is
        yielded: a background thread (``SWIFTLY_SPILL_PREFETCH=0`` turns
        it off: the reads run inline) reads the entry (RAM, or the disk
        tier) and uploads it through `_PinnedStaging` on a copy stream into
        a tensor allocated there; the consumer's stream waits for the
        upload's event only when the group is yielded, and
        ``record_stream`` keeps the tensor's memory from being reused before
        the consumer's work on it has run. A read that fails raises when
        its group is due, after the previous group was yielded, so the
        caller's fallback resumes at exactly that group. On the CPU each
        group is a copy of its entry."""
        dev = self.core.device
        cuda = dev.type == "cuda"
        n = len(spill)
        use_thread = (os.environ.get("SWIFTLY_SPILL_PREFETCH", "1") != "0"
                      and n > 1)
        staging = _PinnedStaging(dev) if cuda else None
        stats = self.last_spill = {
            "mode": "replay", "groups": 0, "bytes": 0, "read_s": 0.0,
            "blocked_s": 0.0, "prefetch_thread": use_thread}
        tctx = _trace.current()

        def prepare(k):
            """Entry k on the device (a private host copy on the CPU), and
            the event its upload records: the cache read (``spill.read``,
            retried inside the cache) and the upload (the fault site
            ``transfer.h2d``, retried on a transient error)."""
            # the worker adopts the caller's span, so its stages nest under
            # the feed in the timeline
            if _trace.current() != tctx:
                _trace.adopt(tctx)
            t0 = time.perf_counter()
            with _metrics.stage("spill.read") as st:
                host = spill.get(k)
                st.bytes_moved = int(host.nbytes)

            def upload():
                fault_point("transfer.h2d")
                with _metrics.stage("spill.h2d") as st:
                    if cuda:
                        out, ev = staging.to_device(
                            torch.from_numpy(np.ascontiguousarray(host)))
                    else:
                        out, ev = torch.from_numpy(np.array(host)), None
                    st.bytes_moved = _nbytes(out)
                return out, ev

            out, ev = retry_transient(upload, site="transfer.h2d")
            stats["read_s"] += time.perf_counter() - t0
            stats["bytes"] += out.numel() * out.element_size()
            return out, ev

        ex = (concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="swiftly-spill-read")
            if use_thread else None)
        try:
            fut = ex.submit(prepare, 0) if ex is not None else None
            for k in range(n):
                t0 = time.perf_counter()
                if fut is not None:
                    out, ev = fut.result()
                    fut = ex.submit(prepare, k + 1) if k + 1 < n else None
                    _metrics.count("spill.async_reads")
                else:
                    out, ev = prepare(k)
                if ev is not None:
                    stream = torch.cuda.current_stream(dev)
                    stream.wait_event(ev)
                    out.record_stream(stream)
                stats["blocked_s"] += time.perf_counter() - t0
                stats["groups"] += 1
                yield spill.meta(k), out
                del out
        finally:
            if ex is not None:
                ex.shutdown(wait=True, cancel_futures=True)
            if staging is not None:
                staging.close()

    def stream_columns(self, subgrid_configs, device_arrays=False):
        """Yield (col_items, subgrids) per column: `col_items` is the
        column's [(input_index, SubgridConfig), ...] and `subgrids` the
        matching [S, xA, xA(,2)] stack, a host numpy array, or the device
        tensor with ``device_arrays=True``."""
        subgrid_configs = list(subgrid_configs)
        groups = _group_full_columns(subgrid_configs)
        size = subgrid_configs[0].size
        _metrics.count("fwd.passes")
        if self._base.residency == "device":
            gen = self._sampled_generator(groups, size)
        else:
            gen = self._host_columns(groups, size)

        def pull(out):
            fault_point("transfer.d2h")
            with _metrics.stage("fwd.d2h") as st:
                host = out.cpu().numpy()
                st.bytes_moved = host.nbytes
            return host

        for items, out in gen:
            yield items, (out if device_arrays else
                          retry_transient(lambda: pull(out),
                                          site="transfer.d2h"))

    def all_subgrids(self, subgrid_configs):
        """Every subgrid, in request order, as one host array
        [n, xA, xA(,2)]."""
        out = None
        for items, subgrids in self.stream_columns(subgrid_configs):
            if out is None:
                out = np.zeros(
                    (len(subgrid_configs),) + subgrids.shape[1:],
                    dtype=subgrids.dtype,
                )
            for s, (i, _) in enumerate(items):
                out[i] = subgrids[s]
        return out


def facet_stack_bytes(base, real=False):
    """Device bytes of the resident facet stack."""
    core = base.core
    itemsize = _np_dtype(core).itemsize
    per_el = itemsize if real else itemsize * (2 if _planar(core) else 1)
    yB = base.stack.size
    return base.stack.n_total * yB * yB * per_el


# -- device-memory pricing ---------------------------------------------------
#
# The sizers price the buffers the port's bodies hold, in bytes, from the
# geometry (held to the peaks ``torch.cuda.max_memory_allocated`` reads on
# the card by ``chip_smoke.py``). Per column of a group: the sampled rows
# [F, m, yB(,2)], the finished subgrids [S, xA, xA(,2)] and (slab stream)
# the pre-finish partials [S, xM, xM(,2)]. Flat: the facets (or slabs) and
# one column's transients, at the larger of the column pass's two phases
# (the prepare FFT of the rows [F, m, yN]: the embedded rows, the FFT's
# output and three rows' worth of factored-FFT planes, beside the weighted
# input rows; the gather and B1's partials with the crop) and the sampled
# pass's products.

_RESERVE_BYTES = 0.5e9  # operators, phase tables, group tensors, cuBLAS


def _sizes(core):
    """(dsize, rsize): bytes of one element in the core's layout (a planar
    (re, im) pair counts both), and of one real."""
    rsize = torch.empty((), dtype=core.real_dtype).element_size()
    return rsize * 2, rsize


def _column_transients(core, F, S, subgrid_size, yB):
    """Device bytes of one forward column pass's transients beside its
    input rows and its output stack (the larger of its phases)."""
    dsize, _ = _sizes(core)
    m, xM, yN, xA = core.xM_yN_size, core.xM_size, core.yN_size, subgrid_size
    rows_b = F * m * yN
    prepare = 5 * rows_b + F * m * yB  # + the weighted input rows
    Sb = min(_colpass_sblock(), S)
    Sb = -(-S // -(-S // Sb))  # executed blocks are rebalanced
    mode = resolve_colpass(core, F)
    if mode == "fft":
        body = rows_b + 2 * S * F * xM * xM
    elif mode == "einsum":
        body = rows_b + Sb * F * m * (m + 2 * xM) + 2 * S * xM * xM
    else:
        body = rows_b + Sb * F * m * m + 2 * Sb * xM * xM + S * xM * xM
    body += S * xA * (xM + xA)  # the crop
    return max(prepare, body) * dsize


def _sampled_transients(core, F, yB):
    """Device bytes of the sampled facet pass's transients (one column's m
    rows at a time): the int64 residues, the (A_re, A_im) planes, the
    products' planes."""
    dsize, rsize = _sizes(core)
    m = core.xM_yN_size
    return m * yB * (2 * 8 + 2 * rsize) + 3 * F * m * yB * dsize


def resident_working_set(base, real=False, extra_out_stacks=0):
    """(flat bytes, bytes per unit G) of the facets-resident stream's
    device working set, as ``col_group_for_budget`` prices it: flat, the
    facet stack, one column's transients (`_column_transients`, or the
    sampled pass's where larger) and a reserve; per column of a group, its
    sampled rows [F, m, yB(,2)], its group tensors, and its finished
    subgrids [S, xA, xA(,2)] twice (the group's stack beside the previous
    one, which the consumer and the generator hold while the next group
    computes), plus `extra_out_stacks` more."""
    core = base.core
    dsize, rsize = _sizes(core)
    yB = base.stack.size
    F = base.stack.n_total
    m = core.xM_yN_size
    xA = base.config.max_subgrid_size
    S = -(-core.N // xA)
    flat = (facet_stack_bytes(base, real) + _RESERVE_BYTES
            + max(_column_transients(core, F, S, xA, yB),
                  _sampled_transients(core, F, yB)))
    col_b = (F * m * yB + (2 + extra_out_stacks) * S * xA * xA) * dsize
    col_b += S * (2 * xA * rsize + 16)  # masks and offsets
    return flat, col_b


def col_group_for_budget(base, budget, n_cols, real=False,
                         extra_out_stacks=0):
    """Largest sampled-DFT column group G whose working set fits `budget`
    bytes on the device (the JAX package's signature,
    ``swiftly_tpu/parallel/streamed.py:3829``), pricing the port's own
    buffers (`resident_working_set`): flat + G * per column <= budget."""
    flat, col_b = resident_working_set(base, real, extra_out_stacks)
    headroom = budget - flat
    if headroom <= col_b:
        logger.warning(
            "device memory budget %.2f GiB cannot fit the resident facet "
            "stack and one column's transients (%.2f GiB) plus one column "
            "group (%.2f GiB); proceeding with G=1 - expect an "
            "out-of-memory error",
            budget / 2**30, flat / 2**30, col_b / 2**30,
        )
    G = int(headroom // col_b)
    return max(1, min(n_cols, G))


def grouped_working_set(base, S, subgrid_size, real, facet_group, chunk,
                        slab_depth=2, extra_out_stacks=0):
    """(flat bytes, bytes per unit G) of the facet-slab stream's device
    working set, as ``grouped_col_group_for_budget`` prices it: flat,
    `slab_depth` facet slabs, the sampled pass's transients or `chunk`
    columns' column-pass transients (the larger), and a reserve; per column
    of a group, the slab's sampled rows [Fg, m, yB(,2)], the pre-finish
    partials [S, xM, xM(,2)], the group tensors, and the finished subgrids
    [S, xA, xA(,2)] twice (beside the previous group's) plus
    `extra_out_stacks` more."""
    core = base.core
    dsize, rsize = _sizes(core)
    fsize = rsize if real else dsize
    yB = base.stack.size
    m = core.xM_yN_size
    xM = core.xM_size
    xA = subgrid_size
    Fg = facet_group
    slab_b = slab_depth * Fg * yB * yB * fsize
    flat = slab_b + _RESERVE_BYTES + max(
        chunk * _column_transients(core, Fg, S, xA, yB),
        _sampled_transients(core, Fg, yB))
    per_G = (Fg * m * yB + S * xM * xM
             + (2 + extra_out_stacks) * S * xA * xA) * dsize
    per_G += S * (2 * xA * rsize + 16)
    return flat, per_G


def grouped_col_group_for_budget(base, budget, n_cols, S, subgrid_size, real,
                                 facet_group, chunk, slab_depth=2, warn=True,
                                 extra_out_stacks=0):
    """Largest column group G for the facet-slab stream whose working set
    fits `budget` bytes on the device.

    The JAX package's signature (``swiftly_tpu/parallel/streamed.py:3727``),
    pricing the port's own buffers (`grouped_working_set`): flat + G * per
    column <= budget; `slab_depth` is the number of slabs the stream holds
    at once (1 where the slabs are synthesised on the device, one at a
    time). ``warn=False`` sizes quietly.
    """
    flat, per_G = grouped_working_set(base, S, subgrid_size, real,
                                      facet_group, chunk, slab_depth,
                                      extra_out_stacks)
    headroom = budget - flat
    if warn and headroom <= per_G:
        logger.warning(
            "device memory budget %.2f GiB cannot fit %d facet slab(s) of "
            "%d plus one column (flat %.2f GiB, %.2f GiB a column); "
            "proceeding with G=1 - expect an out-of-memory error",
            budget / 2**30, slab_depth, facet_group, flat / 2**30,
            per_G / 2**30,
        )
    G = int(headroom // per_G)
    return max(1, min(G, -(-n_cols // chunk) * chunk))


def stream_peak_bytes(forward, n_cols, S, subgrid_size, resting=0, active=0,
                      held=0):
    """The modelled device peak of `forward`'s last sampled stream (its
    ``last_plan``) over `n_cols` columns of `S` subgrids, beside consumers
    that hold `resting` bytes between groups and `active` bytes (all of
    them, one at work) while one folds a group, and `held` bytes the
    caller keeps. The largest of the stream's phases: each group's
    sampled pass and column passes (or slab steps and finish) beside the
    previous group's stack and, from the second group on, the consumers'
    resting state (a consumer allocates at its first fold); each group in
    the consumers' hands."""
    base = forward._base
    core = base.core
    plan = forward.last_plan
    dsize, rsize = _sizes(core)
    yB = base.stack.size
    m, xM, xA = core.xM_yN_size, core.xM_size, subgrid_size
    G = int(plan["col_group"])
    sizes = [min(G, n_cols - g0) for g0 in range(0, n_cols, G)]
    out_c = S * xA * xA * dsize
    tens_c = S * (2 * xA * rsize + 16)
    real = forward._facets_real
    if plan["mode"] == "resident":
        F = base.stack.n_total
        buf_c = F * m * yB * dsize
        facets = facet_stack_bytes(base, real) + _RESERVE_BYTES
        T = max(_column_transients(core, F, S, xA, yB),
                _sampled_transients(core, F, yB))
        phases = [facets + T + g * (buf_c + out_c + tens_c)
                  + (sizes[k - 1] * out_c + resting if k else 0)
                  for k, g in enumerate(sizes)]
        phases += [facets + g * (out_c + tens_c) + active for g in sizes]
        return max(phases) + held
    Fg = int(plan["facet_group"])
    slab_b = Fg * yB * yB * (rsize if real else dsize)
    if forward._facets_sparse:  # one slab synthesised at a time
        ring, slab = 0, slab_b
    else:  # the device ring of host slabs, held throughout
        ring, slab = int(plan["slab_depth"]) * slab_b, 0
    acc_c = S * xM * xM * dsize
    buf_c = Fg * m * yB * dsize
    T = max(_column_transients(core, Fg, S, xA, yB),
            _sampled_transients(core, Fg, yB))
    fin = S * xA * (xM + xA) * dsize
    phases = []
    for k, g in enumerate(sizes):
        before = sizes[k - 1] * out_c + resting if k else 0
        phases.append(slab + T + g * (acc_c + buf_c + tens_c) + before)
        phases.append(fin + g * (acc_c + out_c + tens_c) + before)
        phases.append(g * (out_c + tens_c) + active)
    return max(phases) + ring + _RESERVE_BYTES + held


# ---------------------------------------------------------------------------
# Serving feed over a recorded stream
# ---------------------------------------------------------------------------


class CachedColumnFeed:
    """On-demand lookups into a recorded subgrid stream.

    The port of the JAX package's ``CachedColumnFeed``
    (``swiftly_tpu/parallel/streamed.py:2359``): the SERVING-path view of
    a `utils.spill.SpillCache`. It indexes every recorded subgrid by
    ``(off0, off1, size)`` at construction, and `lookup` returns one host
    row — a RAM slice or a single-row memmap read for disk-backed entries
    — so an individual request is answered without a device dispatch and
    without materialising a whole group stack.

    Exactness contract: a hit is a verbatim copy of the recorded stream's
    row (the cache stores plain float arrays), so a feed-served request is
    bit-identical to the forward that recorded it. A config whose offsets
    match but whose masks differ from the recorded one is a MISS (masks
    are part of the result), as is any config the stream never covered. A
    hit whose backing entry has been evicted since indexing raises
    LookupError — consumers (`vis.VisibilityService`) treat that as the
    signal to fall back to computing the row.

    Version pinning: the feed captures the cache's ``stream_version`` at
    construction. Once a facet update moves the cache's version, every
    lookup raises LookupError — a feed indexed before the update can never
    serve a row recorded for a different facet stack. While the cache is
    mid-patch (``SpillCache.begin_patch``) every lookup raises too.
    Refused lookups count into ``stale`` / ``evicted`` and into the
    ``spill.feed_stale`` / ``spill.feed_evictions`` metrics, hits and
    misses into ``spill.feed_hits`` / ``spill.feed_misses``, as the JAX
    package's feed counts them.
    """

    def __init__(self, spill, *, index=None, stream_version=None):
        if not spill.complete:
            raise ValueError(
                "CachedColumnFeed requires a COMPLETE spill cache "
                "(begin_fill/put/end_fill with nothing evicted); an "
                "incomplete stream would silently miss-serve"
            )
        self._spill = spill
        self.stream_version = int(
            spill.stream_version if stream_version is None
            else stream_version)
        # views over one shared stream (`cache.SharedStreamTier`) pass a
        # prebuilt index, so N replicas do not scan the metadata N times
        self._index = self.build_index(spill) if index is None else index
        self.hits = 0
        self.misses = 0
        self.evicted = 0
        self.stale = 0

    @staticmethod
    def build_index(spill):
        """``(off0, off1, size) -> (k, c, s, recorded config)`` over a
        complete recorded stream — the per-subgrid lookup table. A patch
        rewrites entry payloads in place, so the index survives it; only
        a re-record (replay) invalidates it."""
        index = {}
        for k in range(len(spill)):
            for c, col in enumerate(spill.meta(k)):
                for s, (_i, sg) in enumerate(col):
                    index[(sg.off0, sg.off1, sg.size)] = (k, c, s, sg)
        return index

    def __len__(self):
        return len(self._index)

    @staticmethod
    def _masks_match(a, b):
        for ma, mb in ((a.mask0, b.mask0), (a.mask1, b.mask1)):
            ma = np.ones(a.size) if ma is None else np.asarray(ma)
            mb = np.ones(b.size) if mb is None else np.asarray(mb)
            if not np.array_equal(ma, mb):
                return False
        return True

    def _count_stale(self):
        self.stale += 1
        if _metrics.enabled():
            _metrics.count("spill.feed_stale")

    def _count_evicted(self):
        self.evicted += 1
        if _metrics.enabled():
            _metrics.count("spill.feed_evictions")

    def _gate(self):
        """Raise LookupError unless the backing stream is safe to read at
        this feed's pinned version (not mid-patch, still complete,
        version unmoved). Views that front this feed with a hot-row L1
        (`cache.FabricFeedView`) run the same gate before serving an L1
        row."""
        if self._spill.patching:
            self._count_stale()
            raise LookupError(
                "cached stream is mid-update (a facet patch or replay "
                "is rewriting its entries); fall back to compute and "
                "rebuild the feed once the update lands"
            )
        if not self._spill.complete:
            self._count_evicted()
            raise LookupError(
                "recorded stream is no longer complete (a reset or "
                "eviction dropped its entries since this feed was "
                "indexed); fall back to compute"
            )
        current = int(self._spill.stream_version)
        if current != self.stream_version:
            self._count_stale()
            raise LookupError(
                f"cached stream version moved "
                f"({self.stream_version} -> {current}); this feed "
                "indexes a superseded facet stack — rebuild it"
            )

    def lookup(self, config):
        """The recorded host row for ``config``, or None on a miss.

        Raises LookupError when the index hit an evicted entry or the
        whole recorded stream was dropped (a ``reset`` cleared
        ``complete``), when the cache's stream version moved since this
        feed was built, or when the cache is mid-patch (a read that
        races ``begin_patch`` bounces with `utils.spill.StreamMidPatch`,
        a LookupError)."""
        self._gate()
        hit = self._index.get((config.off0, config.off1, config.size))
        if hit is None or not self._masks_match(config, hit[3]):
            self.misses += 1
            if _metrics.enabled():
                _metrics.count("spill.feed_misses")
            return None
        k, c, s, _cfg = hit
        try:
            row = self._spill.get_row(k, (c, s))
        except (IndexError, FileNotFoundError, OSError) as exc:
            self._count_evicted()
            raise LookupError(
                f"recorded stream entry {k} for subgrid "
                f"({config.off0}, {config.off1}) was evicted"
            ) from exc
        self.hits += 1
        if _metrics.enabled():
            _metrics.count("spill.feed_hits")
        return row


# ---------------------------------------------------------------------------
# Feed-once/fold-many scheduling
# ---------------------------------------------------------------------------


def feed_backward_passes(forward, subgrid_configs, backwards, spill=None,
                         progress=None, feed_index=None):
    """Feed ONE pass over the subgrid stream to MANY backward passes.

    Each column group of ``forward.stream_column_groups`` is folded, on
    the device, into every backward in `backwards` before the stream
    advances: a facet x row-slab partitioned backward
    (`plan.plan_backward_passes`) feeds its passes in chunks of
    `plan.plan_backward_feed`'s feed group, one call per chunk, and with
    a spill cache the stream is computed once and replayed for the
    other chunks.

    :param forward: a `StreamedForward`
    :param subgrid_configs: the cover every pass consumes
    :param backwards: the `StreamedBackward` passes sharing this feed
    :param spill: the shared `utils.spill.SpillCache`: the schedule's
        first feed records the stream into it, later feeds replay it
        (``StreamedForward.stream_column_groups``)
    :param progress: optional callable(n_subgrids_folded)
    :param feed_index: this feed's position in a schedule (0-based): an
        uncached later feed (index > 0, the forward run again) records its
        wall as ``fwd.replay`` instead of ``bwd.feed_group``
    :returns: number of column groups fed

    Telemetry (the JAX package's): the whole feed is one
    ``bwd.feed_group`` trace span; the wall spent blocked on the stream
    (the generator's advance: the forward, or a cache read and upload) is
    observed as the ``bwd.feed_group`` stage, with the cache-fed bytes, or
    as ``fwd.replay`` for an uncached later feed; counters
    ``bwd.feed_groups`` (feeds run) and ``bwd.feed_passes`` (passes
    served). A kill or an error in a pass closes the stream on the way out
    (its worker threads joined, its pinned chunks released).
    """
    backwards = list(backwards)
    if not backwards:
        return 0
    cached = spill is not None and spill.complete
    n_groups = 0
    feed_wall = 0.0
    feed_bytes = 0
    with _trace.span("bwd.feed_group", cat="bwd", n_passes=len(backwards),
                     feed_index=feed_index):
        gen = forward.stream_column_groups(subgrid_configs, spill=spill)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    per_col, group = next(gen)
                except StopIteration:
                    break
                feed_wall += time.perf_counter() - t0
                if cached:
                    feed_bytes += _nbytes(group)
                n_groups += 1
                cols = [[sg for _, sg in col] for col in per_col]
                for bwd in backwards:
                    bwd.add_subgrid_group(cols, group)
                del group
                if progress is not None:
                    progress(sum(len(c) for c in cols) * len(backwards))
        finally:
            gen.close()
    if _metrics.enabled():
        _metrics.count("bwd.feed_groups")
        _metrics.count("bwd.feed_passes", len(backwards))
        if feed_index is not None and feed_index > 0 and not cached:
            # an uncached later feed ran the forward again: replay cost
            _metrics.observe("fwd.replay", feed_wall, bytes_moved=feed_bytes)
        else:
            _metrics.observe("bwd.feed_group", feed_wall,
                             bytes_moved=feed_bytes)
    return n_groups


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------


class StreamedBackward:
    """Subgrids -> facets with bounded device residency.

    Subgrids are fed column-grouped in any order; repeated columns
    accumulate (every fold is linear).

    :param col_block: ("host", "device") facet columns per block of the
        backward FFT facet pass in `finish`
    :param residency: "host" (default) keeps each column's rows
        [F, m, yB_pad(,2)], summed per column offset, in host memory;
        "device" keeps them on the device (both hold K*F*m*yB values, the
        whole cover's rows, and `finish` streams them through the backward
        FFT facet pass); "sampled" folds each column's rows straight into
        a [F, yB, yB(,2)] device accumulator through the fold
        ``resolve_fold_mode`` picks (``SWIFTLY_FOLD``: the adjoint sampled
        DFT, the FFT fold or the CT fold), so the device state is the size
        of the output
    :param fold_group: ("sampled") columns folded per fold (its
        contraction depth is fold_group*m rows)
    :param row_slab: ("sampled", sampled fold) optional (r0, r1): the
        accumulator covers only the facets' output rows [r0, r1),
        [F, r1 - r0, yB(,2)], so a facet stack whose whole accumulator
        exceeds the device splits into row slabs, each a backward over the
        same subgrid stream (one forward feeds them all through
        ``feed_backward_passes``). The finished slabs, concatenated along
        axis 1, are the whole-facet backward.
    """

    def __init__(self, swiftly_config, facet_configs, col_block=512,
                 residency="host", fold_group=4, row_slab=None):
        from ..api import FlightQueue

        self._base = _StreamedBase(swiftly_config, facet_configs, col_block,
                                   residency)
        self.core = self._base.core
        self.stack = self._base.stack
        self._naf = {}  # ("host", "device") off0 -> rows [F, m, yB_pad(,2)]
        self._fold_mode = resolve_fold_mode()  # sampled | ct | fft
        self._row_slab = None
        if row_slab is not None:
            r0, r1 = int(row_slab[0]), int(row_slab[1])
            yB = self.stack.size
            if residency != "sampled":
                raise ValueError("row_slab requires residency='sampled'")
            if self._fold_mode != "sampled":
                raise ValueError(
                    "row_slab requires the sampled fold body "
                    f"(SWIFTLY_FOLD=sampled|auto, got {self._fold_mode!r})"
                )
            if not 0 <= r0 < r1 <= yB:
                raise ValueError(
                    f"row_slab {(r0, r1)} outside the facet rows [0, {yB})"
                )
            self._row_slab = (r0, r1)
        self._acc = None  # ("sampled") device [F, r1 - r0, yB(,2)]
        self._fold_group = max(1, int(fold_group))
        self._pending_rows = []  # ("sampled") [(off0, rows [F, m, yB(,2)])]
        self._ops = None
        self._e0 = None
        # depth-2 in-flight pipelines (CUDA events): folds, and column
        # passes fed one column at a time
        self._fold_inflight = FlightQueue(2, stage="bwd.drain")
        self._rows_inflight = FlightQueue(2, stage="bwd.drain")
        self._finished = False
        # (off0, off1) of every folded subgrid: the resume ledger the
        # autosave snapshots and `utils.checkpoint` restores
        self.processed = []
        self._autosave = None

    def enable_autosave(self, path, every_subgrids=0, every_s=0.0):
        """Periodic checkpoints driven by the feed: a snapshot to `path`
        (atomic, checksummed, keep-N rotated: `utils.checkpoint`) once
        `every_subgrids` subgrids were folded since the last one and/or
        `every_s` seconds of wall clock passed, whichever comes first,
        checked at the end of each `add_subgrid_group` (a whole forward
        column group) and each `add_subgrid_stack`. The snapshot carries
        ``processed``, so a killed run resumes through
        `utils.checkpoint.restore_streamed_backward_state` and skips the
        processed subgrids; the sampled residency's pending fold rows are
        in it, so the resumed run keeps the bits of an undisturbed one.
        Costs a counter until a save is due. Pass neither to disable."""
        every_subgrids = int(every_subgrids)
        every_s = float(every_s)
        if every_subgrids <= 0 and every_s <= 0:
            self._autosave = None
            return
        self._autosave = {
            "path": str(path),
            "every_n": every_subgrids,
            "every_s": every_s,
            "since": 0,
            "last_t": time.monotonic(),
        }

    def _autosave_tick(self, n_folded):
        a = self._autosave
        if a is None:
            return
        a["since"] += n_folded
        now = time.monotonic()
        due = (a["every_n"] > 0 and a["since"] >= a["every_n"]) or (
            a["every_s"] > 0 and now - a["last_t"] >= a["every_s"]
        )
        if not due:
            return
        from ..utils.checkpoint import save_streamed_backward_state

        save_streamed_backward_state(a["path"], self, self.processed)
        a["since"] = 0
        a["last_t"] = time.monotonic()
        _metrics.count("ckpt.autosaves")
        _trace.instant("ckpt.autosave_tick", cat="ckpt",
                       processed=len(self.processed))
        from ..obs import recorder as _recorder

        _recorder.record("ckpt", "ckpt.autosave",
                         f"{len(self.processed)} subgrids processed")

    def device_bytes(self, S, subgrid_size):
        """(resting, active): the device bytes this backward holds between
        the column groups fed to it, and at most while it takes one
        (columns of `S` subgrids of `subgrid_size`). Sampled: the
        accumulator (or its row slab), up to ``fold_group`` - 1 pending
        columns' rows; at work, a fold's rows beside the pending ones and
        the column pass's transients, or the fold's conjugated rows and
        its row block's tables. Host: one column's rows and transients at
        work, nothing between. Device: the rows it keeps now, and one
        column's more at work."""
        base = self._base
        core = base.core
        dsize, rsize = _sizes(core)
        F = base.stack.n_total
        m, xM, yN = core.xM_yN_size, core.xM_size, core.yN_size
        yB = base.stack.size
        Sb = min(_colpass_sblock(), S)
        Sb = -(-S // -(-S // Sb))
        T = (2 * S * xM * xM + 2 * Sb * F * m * m + 5 * F * m * yN) * dsize
        rows_pad = F * m * base._yB_pad * dsize
        if base.residency == "host":
            return 0, rows_pad + T
        if base.residency == "device":
            kept = len(self._naf) * rows_pad
            return kept, kept + rows_pad + T
        r0, r1 = self._row_slab or (0, yB)
        acc = F * (r1 - r0) * yB * dsize
        row = F * m * yB * dsize
        cap = self._fold_group
        B = min(_fold_row_block(F, yB, rsize), r1 - r0)
        fold = 4 * cap * row + cap * m * B * (2 * 8 + 2 * rsize)
        return acc + (cap - 1) * row, acc + max((2 * cap - 1) * row + T, fold)

    def _bwd_cp_flops(self, n_subgrids, subgrid_size):
        """Analytic FLOPs of one backward column pass over `n_subgrids`
        subgrids (stage attribution; 0 when metrics are disabled)."""
        if not _metrics.enabled():
            return 0
        base = self._base
        return _flops.bwd_column_pass_flops(
            self.core, base.stack.n_real, n_subgrids, base.stack.size,
            subgrid_size, resolve_colpass_bwd(self.core, len(base.stack)))

    def _operators(self, mode):
        """The adjoint operators of the operator bodies (None for the FFT
        chain, which takes none)."""
        if mode == "fft":
            return None
        if self._ops is None:
            self._ops = _bwd_colpass_operators(self.core, self._base._foffs0,
                                               self._base._foffs1)
        return self._ops

    def _device_subgrids(self, subgrids):
        """A stack of subgrids in the core's layout, dtype and device."""
        core = self.core
        if isinstance(subgrids, torch.Tensor):
            if _planar(core) and subgrids.is_complex():
                return plk.to_planar(subgrids, core.dtype, core.device)
            return subgrids.to(device=core.device, dtype=core.dtype)
        host = np.stack([_to_host_layout(core, d) for d in subgrids])
        return torch.as_tensor(host, device=core.device)

    def _offsets(self, pairs):
        return torch.as_tensor(np.asarray(pairs, np.int64).reshape(-1, 2),
                               device=self.core.device)

    def add_subgrids(self, tasks):
        """Fold (SubgridConfig, subgrid_data) pairs into the accumulators."""
        if self._finished:
            raise RuntimeError("finish() was already called")
        groups = {}
        for sg, data in tasks:
            groups.setdefault(sg.off0, []).append((sg, data))
        for group in groups.values():
            self.add_subgrid_stack([sg for sg, _ in group],
                                   [d for _, d in group])

    def add_subgrid_stack(self, sg_configs, subgrids):
        """Fold one column's subgrids, given as a stack.

        :param sg_configs: the column's SubgridConfigs (one shared off0)
        :param subgrids: matching [S, xA, xA(,2)]: a device tensor (e.g.
            from ``StreamedForward.stream_columns(..., device_arrays=True)``)
            or host arrays
        """
        if self._finished:
            raise RuntimeError("finish() was already called")
        fault_point("bwd.feed")
        base = self._base
        core = base.core
        off0s = {sg.off0 for sg in sg_configs}
        if len(off0s) != 1:
            raise ValueError(
                f"add_subgrid_stack takes ONE column, got offsets {off0s}"
            )
        key = int(off0s.pop())
        yB = base.stack.size
        m = core.xM_yN_size
        subgrids = self._device_subgrids(subgrids)
        sg_offs = self._offsets([(sg.off0, sg.off1) for sg in sg_configs])
        mode = resolve_colpass_bwd(core, len(base.stack))
        sampled = base.residency == "sampled"
        # the kept residencies' rows carry zero pad columns to yB_pad
        width = yB if sampled else base._yB_pad
        alloc = torch.empty if width == yB else torch.zeros
        rows = alloc((len(base.stack), m, width) + _tail(core),
                     dtype=subgrids.dtype, device=subgrids.device)
        _metrics.count("bwd.subgrids_folded", len(sg_configs))
        with _metrics.stage(
                "bwd.column_pass",
                flops=self._bwd_cp_flops(len(sg_configs), sg_configs[0].size)):
            _column_pass_bwd(core, yB, mode, self._operators(mode), subgrids,
                             sg_offs, base._foffs0, base._foffs1,
                             base._masks1_dev, rows[:, :, :yB])
        self.processed.extend((sg.off0, sg.off1) for sg in sg_configs)
        if sampled:
            self._rows_inflight.admit([rows])
            self._pending_rows.append((key, rows))
            if len(self._pending_rows) >= self._fold_group:
                self._flush_folds()
        elif base.residency == "device":
            prev = self._naf.get(key)
            self._naf[key] = rows if prev is None else prev.add_(rows)
            self._rows_inflight.admit([self._naf[key]])
        else:
            with _metrics.stage("bwd.d2h", bytes_moved=_nbytes(rows)):
                host = rows.cpu()
            if key in self._naf:
                self._naf[key].add_(host)
            else:
                self._naf[key] = host
        self._autosave_tick(len(sg_configs))

    def _ensure_acc(self):
        base = self._base
        if self._acc is None:
            yB = base.stack.size
            r0, r1 = self._row_slab or (0, yB)
            self._acc = torch.zeros(
                (base.stack.n_total, r1 - r0, yB) + _tail(base.core),
                dtype=base.core.dtype, device=base.core.device,
            )

    def _fold_rows(self, offs, rows_cat):
        """One fold of concatenated column rows [F, P*m, yB(,2)] into the
        image-space accumulator, through the fold ``resolve_fold_mode``
        picked: the adjoint sampled fold (kernel B2 or the complex einsum
        fold, per ``resolve_fold_kernel``), the FFT fold or the CT fold."""
        base = self._base
        core = base.core
        yB = base.stack.size
        self._ensure_acc()
        if self._e0 is None:
            self._e0 = torch.as_tensor(
                (np.asarray(base.stack.offs0) - yB // 2).astype(np.int64),
                device=core.device)
        if self._fold_mode == "fft":
            with _metrics.stage("bwd.fft_fold"):
                _bwd_fft_fold(core, self._acc, rows_cat, offs, base._foffs0)
        else:
            krows = torch.as_tensor(sampled_row_indices(core, offs),
                                    device=core.device)
            if self._fold_mode == "ct":
                with _metrics.stage("bwd.ct_fold"):
                    _bwd_ct_fold(core, self._acc, rows_cat, self._e0, krows,
                                 offs)
            else:
                fold_flops = 0
                if _metrics.enabled():
                    fold_flops = _flops.bwd_fold_flops(
                        core, base.stack.n_real, yB, int(rows_cat.shape[1]))
                    if self._row_slab is not None:
                        # the fold's FLOPs scale with the rows it computes
                        r0, r1 = self._row_slab
                        fold_flops = int(fold_flops * (r1 - r0) / yB)
                with _metrics.stage("bwd.sampled_fold", flops=fold_flops):
                    _bwd_sampled_fold(core, self._acc, rows_cat, self._e0,
                                      krows,
                                      row0=(self._row_slab or (0, 0))[0])
        self._fold_inflight.admit([self._acc])

    def _flush_folds(self):
        """Fold the pending columns' rows into the accumulator, in one
        fold."""
        if not self._pending_rows:
            return
        offs = [o for o, _ in self._pending_rows]
        rows_cat = (
            self._pending_rows[0][1]
            if len(self._pending_rows) == 1
            else torch.cat([r for _, r in self._pending_rows], dim=1)
        )  # [F, P*m, yB(,2)]
        self._pending_rows = []
        self._fold_rows(offs, rows_cat)

    def add_subgrid_group(self, col_sg_lists, subgrids_group):
        """("sampled") fold a whole forward column group: its column
        passes and one fold per ``fold_group`` columns, counted over the
        whole feed (a group's last columns short of a fold wait for the
        next group's, or for ``finish_device``), so the result does not
        depend on the forward's column grouping.

        :param col_sg_lists: per-column lists of SubgridConfigs (one shared
            off0 each). A column may hold fewer configs than the group's S
            rows: the trailing rows are the forward's zero-mask padding,
            exactly zero, which folds to zero at any offsets.
        :param subgrids_group: device [G, S, xA, xA(,2)], e.g. one yield
            of ``StreamedForward.stream_column_groups``.
        """
        if self._finished:
            raise RuntimeError("finish() was already called")
        base = self._base
        if base.residency != "sampled":
            raise ValueError(
                "add_subgrid_group requires residency='sampled'"
            )
        fault_point("bwd.feed")
        core = base.core
        yB = base.stack.size
        subgrids_group = self._device_subgrids(subgrids_group)
        S = subgrids_group.shape[1]
        offs, sg_offs = [], []
        for col in col_sg_lists:
            off0s = {sg.off0 for sg in col}
            if len(off0s) != 1:
                raise ValueError(
                    f"each group entry must be ONE column, got {off0s}"
                )
            off0 = off0s.pop()
            offs.append(int(off0))
            pairs = [(sg.off0, sg.off1) for sg in col]
            pairs += [(off0, 0)] * (S - len(pairs))  # zero-pad rows
            sg_offs.append(pairs)
        sg_offs = torch.as_tensor(np.asarray(sg_offs, np.int64),
                                  device=core.device)
        mode = resolve_colpass_bwd(core, len(base.stack))
        cap = self._fold_group
        m = core.xM_yN_size
        j = 0
        while j < len(offs):
            # a fold takes `cap` columns in feed order: the pending columns
            # (a previous group's or stack's remainder) topped up from this
            # group, whose own remainder waits for the next; so the folds,
            # and the bits, do not depend on how the stream was grouped
            g = min(cap - len(self._pending_rows), len(offs) - j)
            _metrics.count("bwd.subgrids_folded", g * S)
            with _metrics.stage(
                    "bwd.column_pass",
                    flops=g * self._bwd_cp_flops(S, subgrids_group.shape[2])):
                rows_cat = _column_pass_bwd_group(
                    core, yB, mode, self._operators(mode),
                    subgrids_group[j:j + g], sg_offs[j:j + g], base._foffs0,
                    base._foffs1, base._masks1_dev,
                )  # [F, g*m, yB(,2)]
            if g == cap:
                self._fold_rows(offs[j:j + g], rows_cat)
            else:
                self._rows_inflight.admit([rows_cat])
                self._pending_rows.extend(
                    (offs[j + c], rows_cat[:, c * m:(c + 1) * m])
                    for c in range(g))
                if len(self._pending_rows) >= cap:
                    self._flush_folds()
            del rows_cat
            j += g
        # the whole group folded or pending: the ledger and the autosave at
        # group boundaries only, so a resumed feed skips whole groups
        n_group = 0
        for col in col_sg_lists:
            self.processed.extend((sg.off0, sg.off1) for sg in col)
            n_group += len(col)
        self._autosave_tick(n_group)

    def finish_device(self):
        """("sampled") the finished facet stack [F, yB, yB(,2)] as a device
        tensor (the accumulator itself, masked in place); with
        ``row_slab`` its rows [F, r1 - r0, yB(,2)]."""
        if self._base.residency != "sampled":
            raise ValueError("finish_device() requires residency='sampled'")
        if self._finished:
            raise RuntimeError("finish() was already called")
        self._flush_folds()
        if self._acc is None:
            raise RuntimeError("No subgrids were added")
        acc, self._acc = self._acc, None
        masks0 = self._base._masks0_dev
        if self._row_slab is not None:
            # the finish mask runs along the output rows: slice it to the slab
            masks0 = masks0[:, self._row_slab[0]:self._row_slab[1]]
        m = masks0[:, :, None]
        if _planar(self.core):
            m = m[..., None]
        with _metrics.stage("bwd.finish"):
            acc.mul_(m)
        self._fold_inflight.drain()
        self._finished = True
        return acc

    def finish(self):
        """The finished facet stack [F, yB, yB(,2)] (or its row slab) as a
        host array. For the host and device residencies, the backward FFT
        facet pass over blocks of ``col_block`` facet columns of every
        column's rows (`_facet_pass_bwd`), each block's facets back to the
        host two deep (`_HostPipe`)."""
        base = self._base
        if base.residency == "sampled":
            return self.finish_device()[: self.stack.n_real].cpu().numpy()
        if self._finished:
            raise RuntimeError("finish() was already called")
        core = base.core
        dev = core.device
        cuda = dev.type == "cuda"
        yB, Cb = base.stack.size, base.col_block
        col_offs0 = sorted(self._naf)
        if not col_offs0:
            raise RuntimeError("No subgrids were added")
        facets = torch.empty((len(base.stack), yB, yB) + _tail(core),
                             dtype=core.dtype)

        def land(j0, host):
            j1 = min(j0 + Cb, yB)
            facets[:, :, j0:j1] = host[:, :, :j1 - j0]

        pipe = _HostPipe(land, cuda)
        stages = [None, None]
        for b, j0 in enumerate(range(0, base._yB_pad, Cb)):
            cols = [self._naf[o][:, :, j0:j0 + Cb] for o in col_offs0]
            if base.residency == "host":
                # stage b is written again at block b + 2, after block b's
                # facets landed, so its upload before them is done
                if stages[b % 2] is None:
                    stages[b % 2] = torch.empty(
                        (len(cols),) + tuple(cols[0].shape),
                        dtype=core.dtype, pin_memory=cuda)
                torch.stack(cols, out=stages[b % 2])
                cols = stages[b % 2].to(dev, non_blocking=cuda)
            with _metrics.stage("bwd.facet_pass"):
                out = _facet_pass_bwd(core, yB, cols, col_offs0,
                                      base._foffs0, base._masks0_dev)
            del cols
            with _metrics.stage("bwd.d2h", bytes_moved=_nbytes(out)):
                pipe.put(j0, out)
        with _metrics.stage("bwd.d2h"):
            pipe.flush()
        self._naf = {}
        self._finished = True
        return facets[: self.stack.n_real].numpy()
