"""Streamed execution on one device: the sampled forward, the facets
resident or streamed in slabs, and the sampled backward.

The torch twin of the single-device sampled paths of the JAX package's
``swiftly_tpu/parallel/streamed.py``:

Forward (facets -> subgrids), ``StreamedForward(residency="device")``:

1. *Sampled facet pass* -- each group of G subgrid columns' contribution
   rows [F, G*m, yB] is a sampled DFT of the facets: one matrix product
   against ``A[r, j] = Fb[j]/yN * w^(j*kt_r)`` plus a per-facet diagonal
   phase (``w = e^(2 pi i/yN)``, ``kt_r`` the extracted spectral rows).
   Plain ``torch.matmul`` products, as the JAX package leaves these
   einsums to XLA.
2. *Column pass* -- per column, the rows are prepared along axis 1 and
   every subgrid of the column comes out of one contraction with
   precomputed operators, ``P_s = sum_f A0_f @ Xn_sf @ B1_f``: kernel B1
   (``ops.kernels.colpass``, ``reduce_f=True``) for the planar backend,
   the complex operator einsums for the complex backend; then a crop and
   the masks.

The facets either move to the device once and stay (``facet_group`` None
or at least the facet count, and the stack fits), or stream in slabs of
``facet_group`` facets per column group: uploaded from the host through a
ring of pinned buffers on a copy stream, or synthesised on the device from
sparse facets (``ops.oracle.SparseRealFacet``). Each slab's pre-finish
partials add into the group's [G, S, xM, xM] accumulator (every stage is
linear in the facets), and the crop and masks run once per group.

Backward (subgrids -> facets), ``StreamedBackward(residency="sampled")``:

1. *Column pass* -- per column, the adjoint operators give every facet's
   contribution block ``Z_sf = E0_f @ emb_s @ E1_f`` (B1 with
   ``reduce_f=False`` for the planar backend, the complex einsum pair for
   the complex one), scattered into the column's
   [F, m, yN] rows one subgrid at a time (a fixed order: within one
   subgrid the destination indices are distinct), then finished along
   axis 1.
2. *Sampled fold* -- the rows of ``fold_group`` columns fold straight into
   the [F, yB, yB] image-space accumulator (or the output rows
   ``row_slab`` of it) through the conjugate-phase transpose of the
   forward's sampled DFT, in output-row blocks: kernel B2
   (``ops.kernels.fold``) in place on the accumulator for the planar
   backend, the complex einsum fold for the complex one.

On the card the planar bodies launch B1 and B2; on the CPU they run too,
and the kernels' wrappers take their plain versions there.

``feed_backward_passes`` feeds one pass over the forward's column groups
to several backward passes (facet subsets, row slabs), on the device.

The port runs eagerly: columns run in sequence (JAX's ``lax.map`` and
``lax.scan`` chunks), the column-pass operators are built once per
executor, a short final column group is not padded (there is no program
to recompile), and JAX's depth-2 in-flight pipelines and checksum pulls
are CUDA events (``api.FlightQueue``).

`CachedColumnFeed` is the serving path's view of a recorded stream
(`utils.spill.SpillCache`): one host row per lookup, version-gated.

Not ported yet (ROADMAP A5/A6): the host/device residencies with their FFT
facet passes, the executors' ``spill=`` arguments (recording and
replaying the stream), the fft and CT folds, meshes, autosave, and the
metrics/trace hooks. Each entry point to them raises
``NotImplementedError``.
"""

from __future__ import annotations

import concurrent.futures
import functools
import logging
import os

import numpy as np
import torch

from ..ops import kernels
from ..ops import planar_backend as plk
from ..ops.core import (
    add_to_subgrid_math,
    extract_from_subgrid_math,
    finish_facet_math,
    prepare_facet_math,
    scaled_offset,
)
from ..utils.flops import (
    resolve_colpass,
    resolve_colpass_bwd,
    resolve_fold_kernel,
)
from .batched import _mask_along

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
    "sampled_row_indices",
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


# ---------------------------------------------------------------------------
# Shared plumbing
# ---------------------------------------------------------------------------


class _StreamedBase:
    def __init__(self, swiftly_config, facet_configs):
        from ..api import _FacetStack

        self.config = swiftly_config
        self.core = swiftly_config.core
        if self.core.backend in ("numpy", "native"):
            raise ValueError(
                "Streamed execution requires a device backend "
                "('torch' or 'planar')"
            )
        if not facet_configs:
            raise ValueError(
                "facet_configs must be non-empty (the streamed paths "
                "size their programs from the first facet)"
            )
        plk.set_matmul_precision()  # full f32 products: no TF32
        self.stack = _FacetStack(facet_configs)
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


def _colpass_einsum_body(core, ops, NMBF_BF, sg_offs):
    """The column's image-space partials P [S, xM, xM] through the complex
    operator einsums (the complex backend), as kernel B1 computes them: a
    gather of each subgrid's m columns of NMBF_BF, then A0 @ X and a
    K = F*m contraction with B1. (The JAX package applies A0 to all yN
    columns first, an [F, xM, yN] product; gathering first does the same
    sums over S*m columns, far fewer than yN on a partial cover.)"""
    A0, B1 = ops
    parts = []
    for s0, s1 in _sblocks(sg_offs.shape[0]):
        idx = _column_index(core, sg_offs[s0:s1, 1])  # [Sb, m]
        X = torch.einsum("fai,fisj->fasj", A0, NMBF_BF[:, :, idx])
        parts.append(torch.einsum("fasj,fjb->sab", X, B1))  # [Sb, xM, xM]
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


def _column_pass_fwd_group(core, subgrid_size, ops, buf, foffs1, sg_offs_g,
                           masks0_g, masks1_g):
    """Sampled group buffer [F, G*m, yB(,2)] -> subgrids [G, S, xA, xA(,2)].

    The group's columns run in sequence (JAX's ``lax.map``), each through
    the body ``resolve_colpass`` picks: one B1 launch per column on the
    card."""
    m = core.xM_yN_size
    F = buf.shape[0]
    G, S = sg_offs_g.shape[0], sg_offs_g.shape[1]
    body = (_colpass_kernel_body
            if resolve_colpass(core, F) == "kernel" else _colpass_einsum_body)
    out = torch.empty((G, S, subgrid_size, subgrid_size) + _tail(core),
                      dtype=buf.dtype, device=buf.device)
    for g in range(G):
        NMBF_BF = _prepare_rows(core, buf[:, g * m:(g + 1) * m], foffs1)
        P = body(core, ops, NMBF_BF, sg_offs_g[g])
        del NMBF_BF
        out[g] = _crop_masked_subgrid(core, P, sg_offs_g[g], subgrid_size,
                                      masks0_g[g], masks1_g[g])
    return out


# -- facet-slab forward step -----------------------------------------------
#
# A facet stack larger than the device (9 facets of 45056^2 at 128k: 73 GB
# as real f32 planes) streams in slabs of Fg facets within each column
# group. Every stage of the forward is linear in the facets, so each slab's
# PRE-FINISH partials [S, xM, xM] add into the group's accumulator, and the
# crop and masks run once per group (JAX package, streamed.py:2101-2240).


def _column_slab_step(core, ops, buf, foffs1, sg_offs_g, acc):
    """``acc [G, S, xM, xM(,2)] +=`` one facet slab's pre-finish partials,
    in place. `buf` [Fg, G*m, yB(,2)] holds the slab's sampled rows for the
    whole column group, `ops` the slab's operators, `foffs1` [Fg] its
    facets' axis-1 offsets. Columns run one at a time, each through one
    B1 launch per subgrid block (reducing over the slab's facets) for the
    planar backend, or the einsum body; the add is a plain ``add_``."""
    m = core.xM_yN_size
    kernel = resolve_colpass(core, buf.shape[0]) == "kernel"
    for g in range(acc.shape[0]):
        NMBF_BF = _prepare_rows(core, buf[:, g * m:(g + 1) * m], foffs1)
        if kernel:
            for s0, s1, Pr, Pi in _colpass_kernel_blocks(core, ops, NMBF_BF,
                                                         sg_offs_g[g]):
                acc[g, s0:s1, ..., 0].add_(Pr)
                acc[g, s0:s1, ..., 1].add_(Pi)
                del Pr, Pi
        else:
            acc[g].add_(_colpass_einsum_body(core, ops, NMBF_BF,
                                             sg_offs_g[g]))
        del NMBF_BF
    return acc


def _column_group_finish(core, subgrid_size, acc, sg_offs_g, masks0_g,
                         masks1_g):
    """A group's accumulated partials [G, S, xM, xM(,2)] -> finished
    subgrids [G, S, xA, xA(,2)]: the crop and masks (the finish iFFTs live
    in the operators), once per group, one column at a time."""
    G, S = acc.shape[0], acc.shape[1]
    out = torch.empty((G, S, subgrid_size, subgrid_size) + _tail(core),
                      dtype=acc.dtype, device=acc.device)
    for g in range(G):
        out[g] = _crop_masked_subgrid(core, acc[g], sg_offs_g[g],
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


def _column_pass_bwd(core, facet_size, ops, subgrids, sg_offs, foffs1,
                     masks1, out):
    """A column's subgrids [S, xA, xA(,2)] -> its finished rows
    [F, m, yB(,2)], written into `out`.

    The per-(facet, subgrid) extract chains collapse into two K = xM
    products with the adjoint operators: B1 with ``reduce_f=False``
    (Z_sf = E0_f @ emb_s @ E1_f, the embedded subgrid broadcast over the
    facets) for the planar backend, or the complex einsum pair, per
    ``resolve_colpass_bwd``. Then the
    scatter into the column's [F, m, yN] rows, the axis-1 finish and the
    facet masks."""
    p = core._p
    xM = core.xM_size
    E0, E1 = ops
    F = E0.shape[0]
    kernel = resolve_colpass_bwd(core, F) == "kernel"
    emb = p.wrapped_embed(subgrids, xM, sg_offs[:, 0], -2)
    emb = p.wrapped_embed(emb, xM, sg_offs[:, 1], -1)  # [S, xM, xM(,2)]
    acc = None
    for s0, s1 in _sblocks(sg_offs.shape[0]):
        blk = emb[s0:s1]
        if kernel:
            Zr, Zi = kernels.colpass(
                E0[..., 0], E0[..., 1], blk[:, None, ..., 0],
                blk[:, None, ..., 1], E1[..., 0], E1[..., 1],
                reduce_f=False,
            )
            Z = torch.stack([Zr, Zi], dim=-1)  # [Sb, F, m, m, 2]
            del Zr, Zi
        else:
            Y = torch.einsum("fia,sab->sfib", E0, blk)
            Z = torch.einsum("sfib,fbj->sfij", Y, E1)
            del Y
        part = _bwd_scatter_rows(core, Z, sg_offs[s0:s1])
        acc = part if acc is None else acc.add_(part)
        del Z, part
    rows = finish_facet_math(p, core._Fb, facet_size, acc, foffs1, -1)
    out.copy_(_mask_along(p, rows, masks1, -1))
    return out


def _column_pass_bwd_group(core, facet_size, ops, subgrids_g, sg_offs_g,
                           foffs1, masks1):
    """A group of columns' subgrids [g, S, xA, xA(,2)] -> their rows
    concatenated along R, [F, g*m, yB(,2)]: the sampled fold's layout,
    written in place (no transpose copy). Columns run in sequence."""
    m = core.xM_yN_size
    g = subgrids_g.shape[0]
    F = ops[0].shape[0]
    out = torch.empty((F, g * m, facet_size) + _tail(core),
                      dtype=subgrids_g.dtype, device=subgrids_g.device)
    for j in range(g):
        _column_pass_bwd(core, facet_size, ops, subgrids_g[j], sg_offs_g[j],
                         foffs1, masks1, out[:, j * m:(j + 1) * m])
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


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


class StreamedForward:
    """Facets -> subgrids through the sampled DFT, the facets resident on
    the device or streamed to it in slabs.

    :param swiftly_config: SwiftlyConfig (device backend: "torch" or
        "planar")
    :param facet_tasks: list of (FacetConfig, facet_data) pairs; the data
        is a numpy array or tensor (complex, planar, or a real plane), a
        `SparseRealFacet` (``make_sparse_facet``), or a callable returning
        one (built when the executor is made, one facet at a time).
        Sparse facets stay sparse for the planar backend, which
        synthesises them on the device, when every facet is sparse; else
        they are densified.
    :param col_block: unused; the reference's signature (the block width
        of the host residency, ROADMAP A5)
    :param residency: "device" (the only one ported): each column group's
        rows are a sampled DFT of the facets on the device. "host" is
        ROADMAP A5.
    :param col_group: columns per sampled group (None: the largest that
        fits the device memory budget, ``col_group_for_budget`` or, for
        facet slabs, ``grouped_col_group_for_budget``)
    :param facet_group: facets on the device at once. None: all of them if
        the stack fits the budget, else slabs of 1. Below the facet count,
        each column group streams the facets in slabs of `facet_group`.
    """

    def __init__(self, swiftly_config, facet_tasks, col_block=512,
                 residency="device", col_group=None, facet_group=None):
        from ..ops.oracle import SparseRealFacet

        if residency == "sampled":
            raise ValueError(
                "residency='sampled' is a StreamedBackward strategy; the "
                "forward equivalent is residency='device' (sampled DFT)"
            )
        if residency == "host":
            raise NotImplementedError(
                "StreamedForward(residency='host'), the FFT facet pass with "
                "a host row buffer, is not ported yet (ROADMAP A5); use "
                "residency='device'"
            )
        if residency != "device":
            raise ValueError(f"residency must be host|device, got {residency}")
        self._base = _StreamedBase(
            swiftly_config, [cfg for cfg, _ in facet_tasks])
        core = self.core = self._base.core
        self.stack = self._base.stack
        # Facet data held on the host in device layout, one array per facet.
        # All-real facets (planar) are kept as single real planes: half the
        # host memory and upload, and the sampled pass skips the zero
        # imaginary plane's products. Sparse facets stay sparse where the
        # device synthesises them (the planar backend).
        store, real_flags, sparse_flags = [], [], []
        for _, d in facet_tasks:
            raw = d() if callable(d) else d
            if isinstance(raw, SparseRealFacet):
                if _planar(core):
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
        self.col_group = col_group
        self.facet_group = facet_group
        self._dev_facets = None
        self._ops = None
        self.last_plan = None
        # device bytes the CALLER keeps resident while streaming (e.g. a
        # backward's accumulator): subtracted from the budget the
        # column-group sizer sees
        self.hbm_headroom = 0

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

        if self._facets_sparse:
            self._dev_facets = (self._synth_slab(0, F),)
        elif self._facets_real:
            self._dev_facets = (upload(lambda d: d),)
        elif _planar(core):
            self._dev_facets = (upload(lambda d: d[..., 0]),
                                upload(lambda d: d[..., 1]))
        else:
            self._dev_facets = (upload(lambda d: d),)

    def _hbm_budget(self):
        """Device bytes this executor may use (None = unlimited: the CPU).

        ``torch.cuda.mem_get_info`` 's free bytes, plus what PyTorch's
        allocator holds cached but unused, plus the resident facets once
        uploaded (the sizer prices them itself), less ``hbm_headroom``.
        """
        dev = self.core.device
        if dev.type != "cuda":
            return None
        free, _ = torch.cuda.mem_get_info(dev)
        cached = (torch.cuda.memory_reserved(dev)
                  - torch.cuda.memory_allocated(dev))
        held = 0
        if self._dev_facets is not None:
            held = sum(t.numel() * t.element_size() for t in self._dev_facets)
        return free + cached + held - self.hbm_headroom

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
                                    real=self._facets_real)

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
        self.last_plan = {
            "mode": "resident", "col_group": G,
            "colpass": resolve_colpass(core, base.stack.n_total),
        }
        ops = self._operators()
        inflight = FlightQueue(1)
        for g0 in range(0, len(col_offs0), G):
            grp = col_offs0[g0:g0 + G]
            krows, sg_offs_g, m0_g, m1_g = _group_tensors(core, groups, grp)
            buf = _facet_pass_sampled(core, self._dev_facets, e0, krows,
                                      self._facets_real)
            out_g = _column_pass_fwd_group(
                core, subgrid_size, ops, buf, base._foffs1, sg_offs_g, m0_g,
                m1_g)  # [G, S, xA, xA(,2)]
            del buf
            inflight.admit([out_g])
            if whole_groups:
                yield [_real_items(groups[off0]) for off0 in grp], out_g
                continue
            for gi, off0 in enumerate(grp):
                yield _real_items(groups[off0]), out_g[gi]

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
                self._facets_real, Fg, 1, slab_depth=depth)
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

        # per-slab facet metadata, zero-padded to F_pad facets
        pad = np.zeros(F_pad - F_total, np.int64)
        offs0 = np.concatenate([np.asarray(base.stack.offs0, np.int64), pad])
        offs1 = np.concatenate([np.asarray(base.stack.offs1, np.int64), pad])
        e0 = torch.as_tensor(offs0 - yB // 2, device=dev)
        foffs0 = torch.as_tensor(offs0, device=dev)
        foffs1 = torch.as_tensor(offs1, device=dev)
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

        def fill(d):
            """Stage slab d (facets from (d % n_slabs) * Fg) in its pinned
            buffer, once the copy that last read the buffer has run."""
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
        inflight = FlightQueue(1)
        try:
            for g0 in range(0, len(col_offs0), G):
                grp = col_offs0[g0:g0 + G]
                krows, sg_offs_g, m0_g, m1_g = _group_tensors(core, groups,
                                                              grp)
                acc = torch.zeros((len(grp), S, xM, xM) + _tail(core),
                                  dtype=core.dtype, device=dev)
                for s0 in range(0, F_pad, Fg):
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
                    sl = slice(s0, s0 + Fg)
                    buf = _facet_pass_sampled(core, slab, e0[sl], krows,
                                              self._facets_real)
                    del slab
                    _column_slab_step(core, (A0[sl], B1[sl]), buf,
                                      foffs1[sl], sg_offs_g, acc)
                    del buf
                    if cuda and not self._facets_sparse:
                        ev = torch.cuda.Event()
                        ev.record(torch.cuda.current_stream(dev))
                        stepped[d] = ev
                    d += 1
                out_g = _column_group_finish(core, subgrid_size, acc,
                                             sg_offs_g, m0_g, m1_g)
                del acc
                inflight.admit([out_g])
                if whole_groups:
                    yield [_real_items(groups[off0]) for off0 in grp], out_g
                    continue
                for gi, off0 in enumerate(grp):
                    yield _real_items(groups[off0]), out_g[gi]
        finally:
            if prefetch is not None:
                prefetch.shutdown(wait=True, cancel_futures=True)

    def stream_column_groups(self, subgrid_configs, spill=None):
        """Yield (per_col_items, group_subgrids) per column group:
        `per_col_items` holds one list per column of
        [(input_index, SubgridConfig), ...], `group_subgrids` the group's
        device tensor [G, S, xA, xA(,2)] (rows past a column's items are
        its zero-mask padding). For consumers that take a whole group at
        once (``StreamedBackward.add_subgrid_group``).

        :param spill: a spill cache to record the stream into and replay
            it from; recording and replaying through `spill=` is not
            ported yet (ROADMAP A6), so it must be None
        """
        if spill is not None:
            raise NotImplementedError(
                "recording and replaying the column stream through spill= "
                "is not ported yet (ROADMAP A6); pass spill=None"
            )
        subgrid_configs = list(subgrid_configs)
        groups = _group_full_columns(subgrid_configs)
        size = subgrid_configs[0].size
        yield from self._sampled_generator(groups, size, whole_groups=True)

    def stream_columns(self, subgrid_configs, device_arrays=False):
        """Yield (col_items, subgrids) per column: `col_items` is the
        column's [(input_index, SubgridConfig), ...] and `subgrids` the
        matching [S, xA, xA(,2)] stack, a host numpy array, or the device
        tensor with ``device_arrays=True``."""
        subgrid_configs = list(subgrid_configs)
        groups = _group_full_columns(subgrid_configs)
        size = subgrid_configs[0].size
        for items, out in self._sampled_generator(groups, size):
            yield items, (out if device_arrays else out.cpu().numpy())

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


def col_group_for_budget(base, budget, n_cols, real=False,
                         extra_out_stacks=0):
    """Largest sampled-DFT column group G whose working set fits `budget`
    bytes on the device (facet stack + per-G buffers).

    The JAX package's formula (``swiftly_tpu/parallel/streamed.py:3829``).
    Live per unit G: the sampled group buffer and its product transients
    (3 * F*m*yB) and the in-flight output stacks (2 * S*xA^2). Flat: the
    facet stack, one column's transients (prepared rows, the gather block
    or the reference's einsum body's [F, xM, yN] H buffer, more than the
    port's gather-first einsum body holds, the partials) and a 0.4 GB
    reserve for tables and fragmentation. The reserve is the reference's
    value; it was not calibrated on the port's device.
    """
    core = base.core
    dsize = _np_dtype(core).itemsize * (2 if _planar(core) else 1)
    yB = base.stack.size
    facets_b = facet_stack_bytes(base, real)
    F = len(base.stack)
    reserve = 0.4e9
    m = core.xM_yN_size
    xA = base.config.max_subgrid_size
    xM = core.xM_size
    S = -(-core.N // xA)
    Sb = min(_colpass_sblock(), S)
    Sb = -(-S // -(-S // Sb))  # executed blocks are rebalanced
    if resolve_colpass(core, F) == "einsum":
        flat_col = (
            F * m * core.yN_size
            + F * xM * (2 * core.yN_size + m)
            + Sb * F * xM * m
            + S * xM * xM
        ) * dsize
    else:
        flat_col = (
            F * m * core.yN_size + 2 * Sb * F * m * m + S * xM * xM
        ) * dsize
    col_b = (3 * F * m * yB + (2 + extra_out_stacks) * S * xA * xA) * dsize
    headroom = budget - facets_b - reserve - flat_col
    if headroom <= col_b:
        logger.warning(
            "device memory budget %.2f GiB cannot fit the resident facet "
            "stack (%.2f GiB) plus one column group (%.2f GiB); proceeding "
            "with G=1 - expect an out-of-memory error",
            budget / 2**30, facets_b / 2**30, col_b / 2**30,
        )
    G = int(headroom // col_b)
    return max(1, min(n_cols, G))


def grouped_working_set(base, S, subgrid_size, real, facet_group, chunk,
                        slab_depth=2, extra_out_stacks=0):
    """(flat bytes, bytes per unit G) of the facet-slab stream's device
    working set, as ``grouped_col_group_for_budget`` prices it."""
    core = base.core
    dsize = _np_dtype(core).itemsize * (2 if _planar(core) else 1)
    rsize = torch.empty((), dtype=core.real_dtype).element_size()
    fsize = rsize if real else dsize
    yB = base.stack.size
    m = core.xM_yN_size
    xM = core.xM_size
    yN = core.yN_size
    xA = subgrid_size
    Fg = facet_group
    slab_b = slab_depth * Fg * yB * yB * fsize
    sampled_b = m * yB * (3 * 8 + 2 * rsize) + 4 * Fg * m * yB * dsize
    Sb = min(_colpass_sblock(), S)
    Sb = -(-S // -(-S // Sb))  # executed blocks are rebalanced
    if resolve_colpass(core, Fg) == "einsum":
        body = Fg * Sb * m * (m + xM) + Sb * xM * xM
    else:
        body = 2 * Sb * Fg * m * m
    chunk_b = chunk * (4 * Fg * m * yN + body + 2 * S * xM * xM) * dsize
    per_G = (Fg * m * yB + S * xM * xM
             + (2 + extra_out_stacks) * S * xA * xA) * dsize
    return slab_b + sampled_b + chunk_b + 0.6e9, per_G


def grouped_col_group_for_budget(base, budget, n_cols, S, subgrid_size, real,
                                 facet_group, chunk, slab_depth=2, warn=True,
                                 extra_out_stacks=0):
    """Largest column group G for the facet-slab stream whose working set
    fits `budget` bytes on the device.

    The JAX package's signature (``swiftly_tpu/parallel/streamed.py:3727``),
    pricing the port's own buffers (``grouped_working_set``). Flat:
    `slab_depth` facet slabs; the sampled pass's per-column transients (the
    int64 residue matrix [m, yB], the (A_re, A_im) phase planes and the
    products' planes); `chunk` columns' column-pass transients (the
    prepared rows [Fg, m, yN] with their FFT's planes, the gather block and
    B1's or the einsum's partials, the crop), the executor running one
    column at a time (chunk 1); and a 0.6 GB reserve for tables and
    fragmentation (the reference's). Per unit G: the slab's sampled rows
    [Fg, m, yB], the pre-finish accumulator [S, xM, xM], and the finished
    stack plus one in flight (and `extra_out_stacks` more) [S, xA, xA].
    ``warn=False`` sizes quietly.
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
    serve a row recorded for a different facet stack.
    """

    def __init__(self, spill):
        if not spill.complete:
            raise ValueError(
                "CachedColumnFeed requires a COMPLETE spill cache "
                "(begin_fill/put/end_fill with nothing evicted); an "
                "incomplete stream would silently miss-serve"
            )
        self._spill = spill
        self.stream_version = int(spill.stream_version)
        self._index = self._build_index(spill)
        self.hits = 0
        self.misses = 0
        self.evicted = 0
        self.stale = 0

    @staticmethod
    def _build_index(spill):
        """``(off0, off1, size) -> (k, c, s, recorded config)`` over a
        complete recorded stream — the per-subgrid lookup table."""
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

    def _gate(self):
        """Raise LookupError unless the backing stream is safe to read at
        this feed's pinned version (still complete, version unmoved)."""
        if not self._spill.complete:
            self.evicted += 1
            raise LookupError(
                "recorded stream is no longer complete (a reset or "
                "eviction dropped its entries since this feed was "
                "indexed); fall back to compute"
            )
        current = int(self._spill.stream_version)
        if current != self.stream_version:
            self.stale += 1
            raise LookupError(
                f"cached stream version moved "
                f"({self.stream_version} -> {current}); this feed "
                "indexes a superseded facet stack — rebuild it"
            )

    def lookup(self, config):
        """The recorded host row for ``config``, or None on a miss.

        Raises LookupError when the index hit an evicted entry or the
        whole recorded stream was dropped (a ``reset`` cleared
        ``complete``), or when the cache's stream version moved since this
        feed was built."""
        self._gate()
        hit = self._index.get((config.off0, config.off1, config.size))
        if hit is None or not self._masks_match(config, hit[3]):
            self.misses += 1
            return None
        k, c, s, _cfg = hit
        try:
            row = self._spill.get_row(k, (c, s))
        except (IndexError, FileNotFoundError, OSError) as exc:
            self.evicted += 1
            raise LookupError(
                f"recorded stream entry {k} for subgrid "
                f"({config.off0}, {config.off1}) was evicted"
            ) from exc
        self.hits += 1
        return row


# ---------------------------------------------------------------------------
# Feed-once/fold-many scheduling
# ---------------------------------------------------------------------------


def feed_backward_passes(forward, subgrid_configs, backwards, spill=None,
                         progress=None, feed_index=None):
    """Feed ONE pass over the subgrid stream to MANY backward passes.

    Each column group of ``forward.stream_column_groups`` is folded, on
    the device, into every backward in `backwards` before the stream
    advances.

    :param forward: a `StreamedForward`
    :param subgrid_configs: the cover every pass consumes
    :param backwards: the `StreamedBackward` passes sharing this feed
    :param spill: a spill cache to record and replay the stream through;
        not ported yet (ROADMAP A6), must be None
    :param progress: optional callable(n_subgrids_folded)
    :param feed_index: this feed's position in a schedule (kept for the
        reference's signature; the metrics it labels are ROADMAP A9)
    :returns: number of column groups fed
    """
    backwards = list(backwards)
    if not backwards:
        return 0
    n_groups = 0
    for per_col, group in forward.stream_column_groups(subgrid_configs,
                                                        spill=spill):
        n_groups += 1
        cols = [[sg for _, sg in col] for col in per_col]
        for bwd in backwards:
            bwd.add_subgrid_group(cols, group)
        if progress is not None:
            progress(sum(len(c) for c in cols) * len(backwards))
    return n_groups


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------


class StreamedBackward:
    """Subgrids -> facets, accumulated in an image-space facet stack on
    the device.

    Subgrids are fed column-grouped in any order; repeated columns
    accumulate (every fold is linear).

    :param col_block: unused; the reference's signature (ROADMAP A6)
    :param residency: "sampled" (the only one ported): each column's rows
        fold straight into a [F, yB, yB(,2)] device accumulator through
        the adjoint sampled DFT, so the device state is the size of the
        output. "host" and "device" are ROADMAP A6.
    :param fold_group: columns folded per fold (its contraction depth is
        fold_group*m rows)
    :param row_slab: optional (r0, r1): the accumulator covers only the
        facets' output rows [r0, r1), [F, r1 - r0, yB(,2)], so a facet
        stack whose whole accumulator exceeds the device splits into row
        slabs, each a backward over the same subgrid stream (one forward
        feeds them all through ``feed_backward_passes``). The finished
        slabs, concatenated along axis 1, are the whole-facet backward.
    """

    def __init__(self, swiftly_config, facet_configs, col_block=512,
                 residency="sampled", fold_group=4, row_slab=None):
        from ..api import FlightQueue

        if residency not in ("host", "device", "sampled"):
            raise ValueError(
                f"residency must be host|device|sampled, got {residency}"
            )
        if row_slab is not None and residency != "sampled":
            raise ValueError("row_slab requires residency='sampled'")
        if residency != "sampled":
            raise NotImplementedError(
                f"StreamedBackward(residency={residency!r}), the column "
                "row buffer with the FFT facet pass, is not ported yet "
                "(ROADMAP A6); use residency='sampled'"
            )
        self._base = _StreamedBase(swiftly_config, facet_configs)
        self.core = self._base.core
        self.stack = self._base.stack
        self._row_slab = None
        if row_slab is not None:
            r0, r1 = int(row_slab[0]), int(row_slab[1])
            yB = self.stack.size
            if not 0 <= r0 < r1 <= yB:
                raise ValueError(
                    f"row_slab {(r0, r1)} outside the facet rows [0, {yB})"
                )
            self._row_slab = (r0, r1)
        self._acc = None  # device [F, r1 - r0, yB(,2)] accumulator
        self._fold_group = max(1, int(fold_group))
        self._pending_rows = []  # [(off0, rows [F, m, yB(,2)])]
        self._ops = None
        self._e0 = None
        # depth-2 in-flight pipelines (CUDA events): folds, and column
        # passes fed one column at a time
        self._fold_inflight = FlightQueue(2)
        self._rows_inflight = FlightQueue(2)
        self._finished = False
        # (off0, off1) of every folded subgrid
        self.processed = []

    def _operators(self):
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
        """Fold (SubgridConfig, subgrid_data) pairs into the accumulator."""
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
        base = self._base
        core = base.core
        off0s = {sg.off0 for sg in sg_configs}
        if len(off0s) != 1:
            raise ValueError(
                f"add_subgrid_stack takes ONE column, got offsets {off0s}"
            )
        off0 = off0s.pop()
        yB = base.stack.size
        m = core.xM_yN_size
        subgrids = self._device_subgrids(subgrids)
        sg_offs = self._offsets([(sg.off0, sg.off1) for sg in sg_configs])
        rows = torch.empty((len(base.stack), m, yB) + _tail(core),
                           dtype=subgrids.dtype, device=subgrids.device)
        _column_pass_bwd(core, yB, self._operators(), subgrids, sg_offs,
                         base._foffs1, base._masks1_dev, rows)
        self._rows_inflight.admit([rows])
        self._pending_rows.append((int(off0), rows))
        if len(self._pending_rows) >= self._fold_group:
            self._flush_folds()
        self.processed.extend((sg.off0, sg.off1) for sg in sg_configs)

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
        """One adjoint sampled fold of concatenated column rows
        [F, P*m, yB(,2)] into the image-space accumulator: kernel B2 or
        the complex einsum fold, per ``resolve_fold_kernel``."""
        base = self._base
        core = base.core
        yB = base.stack.size
        self._ensure_acc()
        if self._e0 is None:
            self._e0 = torch.as_tensor(
                (np.asarray(base.stack.offs0) - yB // 2).astype(np.int64),
                device=core.device)
        krows = torch.as_tensor(sampled_row_indices(core, offs),
                                device=core.device)
        _bwd_sampled_fold(core, self._acc, rows_cat, self._e0, krows,
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
        """Fold a whole forward column group: its column passes and one
        fold per ``fold_group`` columns.

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
        # pending per-column rows first, so folds follow the feed order
        self._flush_folds()
        sg_offs = torch.as_tensor(np.asarray(sg_offs, np.int64),
                                  device=core.device)
        cap = self._fold_group
        for j in range(0, len(offs), cap):
            rows_cat = _column_pass_bwd_group(
                core, yB, self._operators(), subgrids_group[j:j + cap],
                sg_offs[j:j + cap], base._foffs1, base._masks1_dev,
            )  # [F, g*m, yB(,2)]
            self._fold_rows(offs[j:j + cap], rows_cat)
            del rows_cat
        for col in col_sg_lists:
            self.processed.extend((sg.off0, sg.off1) for sg in col)

    def finish_device(self):
        """The finished facet stack [F, yB, yB(,2)] as a device tensor (the
        accumulator itself, masked in place); with ``row_slab`` its rows
        [F, r1 - r0, yB(,2)]."""
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
        acc.mul_(m)
        self._fold_inflight.drain()
        self._finished = True
        return acc

    def finish(self):
        """The finished facet stack [F, yB, yB(,2)] (or its row slab) as a
        host array."""
        return self.finish_device()[: self.stack.n_real].cpu().numpy()
