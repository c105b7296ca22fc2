"""Batched execution: whole facet and subgrid stacks per call.

The torch twin of the JAX package's ``swiftly_tpu/parallel/batched.py``.
Where JAX ``vmap``s the per-axis primitives over stacked facets and
subgrids, the port writes the batch dimensions out: one call transforms a
whole column's subgrids for all facets at once ([S, F, ...] stacks), so the
B3 kernel underneath sees every row of the column in one launch. JAX's
``scan`` over columns becomes a Python loop. Offsets that differ between
the rows of a stack are int64 tensors (see ``ops/primitives.py``); offsets
shared by a stack are Python ints.

Memory. The accumulators update in place (the backward's column and facet
accumulators, and the forward's output stack), and the full-size facet
transforms (prepare and finish, FFTs of size yN over whole facets) run one
facet at a time, so the 32k configuration's stacks fit one card.

The numpy backend executes the same semantics with an eager loop over the
core's per-item methods, as the JAX package does for its host backends.

Array conventions (complex backends; planar adds a trailing (re,im) axis):
  facets       [F, yB, yB]     stacked facet data
  BF_Fs        [F, yN, yB]     facets prepared along axis 0
  NMBF_BFs     [F, m, yN]      one subgrid column's contributions (m=xM_yN)
  NAF_NAFs     [F, m, m]       per-facet contribution from one subgrid
  NAF_MNAFs    [F, m, yN]      per-column backward accumulators
  MNAF_BMNAFs  [F, yN, yB]     per-facet backward accumulators
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.core import (
    add_to_subgrid_math,
    extract_from_facet_math,
    extract_from_subgrid_math,
    finish_facet_math,
    finish_subgrid_math,
    prepare_facet_math,
    prepare_subgrid_math,
    scaled_offset,
)

__all__ = [
    "accumulate_column_batch",
    "accumulate_facet_batch",
    "backward_all_batch",
    "extract_columns_batch",
    "finish_facets_batch",
    "forward_all_batch",
    "prepare_facets_batch",
    "split_accumulate_batch",
    "split_subgrid_batch",
    "subgrid_from_columns_batch",
    "subgrids_from_columns_batch",
]


def _is_host(core):
    """Host-eager backend: loop over the stack calling the core's methods."""
    return core.backend in ("numpy", "native")


def _index(core, values):
    """Offsets as an int64 tensor on the core's device."""
    if isinstance(values, torch.Tensor):
        return values.to(device=core.device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(values, dtype=np.int64), device=core.device)


def _real(core, values):
    """Masks as a tensor of the core's real dtype on its device."""
    if isinstance(values, torch.Tensor):
        return values.to(device=core.device, dtype=core.real_dtype)
    return torch.as_tensor(np.asarray(values), dtype=core.real_dtype,
                           device=core.device)


def _mask_along(p, data, mask, axis):
    """``data`` times a 0/1 mask along logical `axis`.

    `mask` is [..., size]: a 1D mask is shared by every row of the stack,
    and leading mask dimensions line up with data's leading dimensions.
    """
    nd = p.ndim(data)
    ax = axis % nd
    lead = tuple(mask.shape[:-1])
    shape = (lead + (1,) * (ax - len(lead)) + (mask.shape[-1],)
             + (1,) * (data.ndim - ax - 1))
    return data * mask.reshape(shape)


def _fold_into(core, acc, contrib, sg_off: int, axis):
    """``acc += add_to_facet_math(contrib, sg_off, axis)``, in place and
    touching only the window (`sg_off` is a Python int)."""
    p = core._p
    scaled = scaled_offset(int(sg_off), core.yN_size, core.N)
    p.wrapped_embed_add_(acc, p.roll_axis(contrib, -scaled, axis), scaled, axis)
    return acc


# -- facet -> subgrid -------------------------------------------------------


def prepare_facets_batch(core, facets, offs0):
    """facets [F, yB, yB] -> BF_Fs [F, yN, yB]: prepare all facets along
    axis 0.

    Done once per facet set and reused for every subgrid. `facets`
    may be a stacked array or a sequence of per-facet arrays (numpy or
    torch, complex or planar; a callable is called for its data). Each
    facet moves to the device and is transformed on its own, into a
    preallocated stack, so only one facet's transients are live at a time.
    """
    if _is_host(core):
        return np.stack(
            [core.prepare_facet(f() if callable(f) else f, int(o), 0)
             for f, o in zip(facets, offs0)]
        )
    out = None
    for i, (facet, off) in enumerate(zip(facets, offs0)):
        data = core._prep(facet() if callable(facet) else facet)
        prepped = prepare_facet_math(
            core._p, core._Fb, core.yN_size, data, int(off), 0
        )
        if out is None:
            out = prepped.new_empty((len(offs0),) + tuple(prepped.shape))
        out[i] = prepped
        del data, prepped
    return out


def extract_columns_batch(core, BF_Fs, off0, offs1):
    """BF_Fs [F, yN, yB] -> NMBF_BFs [F, m, yN] for one subgrid column.

    Axis-0 extraction at the column's off0 plus axis-1 preparation; shared
    by every subgrid with this off0.
    """
    if _is_host(core):
        out = []
        for BF_F, off1 in zip(BF_Fs, offs1):
            col = core.extract_from_facet(BF_F, int(off0), 0)
            out.append(core.prepare_facet(col, int(off1), 1))
        return np.stack(out)
    p = core._p
    col = extract_from_facet_math(
        p, core.xM_yN_size, core.N, core.yN_size, BF_Fs, int(off0), -2
    )
    return prepare_facet_math(
        p, core._Fb, core.yN_size, col, _index(core, offs1), -1
    )


def facet_contrib_to_subgrid(core, NMBF_BFs, offs0, offs1, sg_offs1):
    """One column's prepared rows NMBF_BFs [F, m, yN] -> every facet's
    padded-subgrid summand for each of the column's subgrids,
    [S, F, xM, xM] (grid space).

    The twin of the JAX package's per-facet ``facet_contrib_to_subgrid``
    (``swiftly_tpu/parallel/batched.py:79``), batched as its ``vmap`` over
    subgrids and facets: every (subgrid, facet) pair is one row of an
    [S, F, ...] stack, so each add_to_subgrid FFT is one batched DFT over
    S*F*m (axis 0) or S*F*xM (axis 1) rows. `sg_offs1` [S] are the
    subgrids' axis-1 offsets.
    """
    p = core._p
    foffs0 = _index(core, offs0).reshape(1, -1)
    foffs1 = _index(core, offs1).reshape(1, -1)
    sg1 = _index(core, sg_offs1)
    S = sg1.shape[0]
    stack = NMBF_BFs.unsqueeze(0).expand((S,) + tuple(NMBF_BFs.shape))
    NMBF_NMBFs = extract_from_facet_math(
        p, core.xM_yN_size, core.N, core.yN_size, stack, sg1.reshape(S, 1), -1
    )
    acc = add_to_subgrid_math(
        p, core._Fn, core.xM_size, core.N, NMBF_NMBFs, foffs0, -2
    )
    del NMBF_NMBFs
    return add_to_subgrid_math(p, core._Fn, core.xM_size, core.N, acc,
                               foffs1, -1)


def finish_masked_subgrid(core, summed, sg_offs, subgrid_size, masks0,
                          masks1):
    """Summed padded subgrids [S, xM, xM] -> finished subgrids
    [S, xA, xA]: the finish iFFTs, the crops at ``sg_offs`` = [off0, off1]
    (each a Python int or one offset per subgrid) and the ownership masks
    [S, xA] (the twin of ``swiftly_tpu/parallel/batched.py:114``)."""
    p = core._p
    subgrids = finish_subgrid_math(p, subgrid_size, summed, sg_offs)
    subgrids = _mask_along(p, subgrids, _real(core, masks0), -2)
    return _mask_along(p, subgrids, _real(core, masks1), -1)


def _subgrids_from_columns(core, NMBF_BFs, offs0, offs1, sg_off0, sg_offs1,
                           subgrid_size, masks0, masks1):
    """One column's S subgrids from its NMBF_BFs [F, m, yN]: [S, xA, xA].

    The facet sum is a reduction over F of `facet_contrib_to_subgrid`'s
    stack."""
    sg1 = _index(core, sg_offs1)
    summed = facet_contrib_to_subgrid(core, NMBF_BFs, offs0, offs1,
                                      sg1).sum(dim=1)
    return finish_masked_subgrid(core, summed, [sg_off0, sg1], subgrid_size,
                                 masks0, masks1)


def subgrid_from_columns_batch(
    core, NMBF_BFs, offs0, offs1, sg_off0, sg_off1, subgrid_size, masks
):
    """NMBF_BFs [F, m, yN] -> finished subgrid [xA, xA] for one subgrid.

    Extracts the axis-1 contribution per facet, embeds both axes into the
    padded-subgrid frame, sums over facets, finishes, and applies the
    ownership masks.
    """
    if _is_host(core):
        p = core._p
        summed = None
        for NMBF_BF, foff0, foff1 in zip(NMBF_BFs, offs0, offs1):
            NMBF_NMBF = core.extract_from_facet(NMBF_BF, int(sg_off1), 1)
            acc = core.add_to_subgrid(NMBF_NMBF, int(foff0), 0)
            acc = core.add_to_subgrid(acc, int(foff1), 1)
            summed = acc if summed is None else summed + acc
        subgrid = core.finish_subgrid(
            summed, [int(sg_off0), int(sg_off1)], subgrid_size
        )
        subgrid = subgrid * p.broadcast_along(np.asarray(masks[0]), 2, 0)
        return subgrid * p.broadcast_along(np.asarray(masks[1]), 2, 1)
    return _subgrids_from_columns(
        core, NMBF_BFs, offs0, offs1, int(sg_off0), [sg_off1], subgrid_size,
        np.asarray(masks[0])[None], np.asarray(masks[1])[None],
    )[0]


def subgrids_from_columns_batch(
    core, NMBF_BFs, offs0, offs1, sg_offs_list, subgrid_size, masks_list
):
    """Several subgrids of one column in a single call: [S, xA, xA].

    :param sg_offs_list: [(off0, off1), ...] for the column's subgrids
    :param masks_list: [(mask0, mask1), ...] matching sg_offs_list
    """
    if _is_host(core):
        return np.stack(
            [
                subgrid_from_columns_batch(
                    core, NMBF_BFs, offs0, offs1, so[0], so[1],
                    subgrid_size, masks,
                )
                for so, masks in zip(sg_offs_list, masks_list)
            ]
        )
    return _subgrids_from_columns(
        core, NMBF_BFs, offs0, offs1,
        _index(core, [so[0] for so in sg_offs_list]),
        [so[1] for so in sg_offs_list], subgrid_size,
        np.stack([m[0] for m in masks_list]),
        np.stack([m[1] for m in masks_list]),
    )


def forward_all_batch(
    core, BF_Fs, offs0, offs1, col_offs0, sg_offs1, subgrid_size,
    masks0, masks1,
):
    """The full forward cover: [C, S, xA, xA].

    Loops over the C subgrid columns; per column, extracts the facet column
    blocks once and computes all S subgrids of the column in one batched
    call, written into a preallocated output stack.

    :param col_offs0: [C] column offsets
    :param sg_offs1: [C, S] per-column subgrid off1 values
    :param masks0/masks1: [C, S, xA] per-subgrid ownership masks
    """
    if _is_host(core):
        out = []
        for c, off0 in enumerate(col_offs0):
            cols = extract_columns_batch(core, BF_Fs, off0, offs1)
            out.append(
                np.stack(
                    [
                        subgrid_from_columns_batch(
                            core, cols, offs0, offs1, off0, sg_offs1[c][s],
                            subgrid_size,
                            (masks0[c][s], masks1[c][s]),
                        )
                        for s in range(len(sg_offs1[c]))
                    ]
                )
            )
        return np.stack(out)
    out = None
    for c, off0 in enumerate(col_offs0):
        cols = extract_columns_batch(core, BF_Fs, off0, offs1)
        sgs = _subgrids_from_columns(
            core, cols, offs0, offs1, int(off0), sg_offs1[c], subgrid_size,
            masks0[c], masks1[c],
        )
        del cols
        if out is None:
            out = sgs.new_empty((len(col_offs0),) + tuple(sgs.shape))
        out[c] = sgs
        del sgs
    return out


# -- subgrid -> facet -------------------------------------------------------


def subgrid_contrib_to_facet(core, prepped, offs0, offs1):
    """Prepared subgrids [S, xM, xM] -> each one's contribution to every
    facet, [S, F, m, m]: the twin of the JAX package's per-facet
    ``subgrid_contrib_to_facet`` (``swiftly_tpu/parallel/batched.py:98``),
    batched over [S, F] stacks of DFT rows."""
    p = core._p
    foffs0 = _index(core, offs0)
    F = foffs0.numel()
    stack = prepped.unsqueeze(1).expand(
        (prepped.shape[0], F) + tuple(prepped.shape[1:])
    )
    e0 = extract_from_subgrid_math(
        p, core._Fn, core.xM_yN_size, core.xM_size, core.N, stack,
        foffs0.reshape(1, F), -2,
    )
    del stack
    return extract_from_subgrid_math(
        p, core._Fn, core.xM_yN_size, core.xM_size, core.N, e0,
        _index(core, offs1).reshape(1, F), -1,
    )


def _split_subgrids(core, subgrids, sg_offs0, sg_offs1, offs0, offs1):
    """Subgrids [S, xA, xA] -> NAF_NAFs [S, F, m, m]: every subgrid's
    contribution to every facet, as [S, F] stacks of DFT rows."""
    prepped = prepare_subgrid_math(
        core._p, core.xM_size, subgrids,
        [_index(core, sg_offs0), _index(core, sg_offs1)],
    )
    return subgrid_contrib_to_facet(core, prepped, offs0, offs1)


def split_subgrid_batch(core, subgrid, sg_off0, sg_off1, offs0, offs1):
    """Subgrid [xA, xA] -> NAF_NAFs [F, m, m]: contributions to all facets."""
    if _is_host(core):
        prepped = core.prepare_subgrid(
            np.asarray(subgrid, dtype=complex), [int(sg_off0), int(sg_off1)]
        )
        out = []
        for foff0, foff1 in zip(offs0, offs1):
            e0 = core.extract_from_subgrid(prepped, int(foff0), 0)
            out.append(core.extract_from_subgrid(e0, int(foff1), 1))
        return np.stack(out)
    return _split_subgrids(
        core, core._prep(subgrid).unsqueeze(0), [sg_off0], [sg_off1],
        offs0, offs1,
    )[0]


def _stack_subgrids(core, subgrids):
    """A list of subgrids (any layout) or a stacked tensor -> one device
    stack in the core's layout."""
    if isinstance(subgrids, (list, tuple)):
        return torch.stack([core._prep(sg) for sg in subgrids])
    return core._prep(subgrids)


def split_accumulate_batch(core, subgrids, sg_offs_list, offs0, offs1,
                           NAF_MNAFs):
    """Fold a whole column of subgrids into its accumulator.

    Equivalent to `split_subgrid_batch` + `accumulate_column_batch` per
    subgrid; `subgrids` is the stacked [S, xA, xA] column (or a list),
    `sg_offs_list` the matching [(off0, off1), ...]. The split runs as one
    batched call over the S subgrids; each subgrid's [F, m, m] summand is
    then added into NAF_MNAFs [F, m, yN] in place, which is returned.
    """
    if _is_host(core):
        for sg, (o0, o1) in zip(subgrids, sg_offs_list):
            NAF_NAFs = split_subgrid_batch(core, sg, o0, o1, offs0, offs1)
            NAF_MNAFs = accumulate_column_batch(core, NAF_NAFs, o1, NAF_MNAFs)
        return NAF_MNAFs
    NAF_NAFs = _split_subgrids(
        core, _stack_subgrids(core, subgrids),
        [o[0] for o in sg_offs_list], [o[1] for o in sg_offs_list],
        offs0, offs1,
    )
    for s, (_, o1) in enumerate(sg_offs_list):
        _fold_into(core, NAF_MNAFs, NAF_NAFs[s], o1, -1)
    return NAF_MNAFs


def accumulate_column_batch(core, NAF_NAFs, sg_off1, NAF_MNAFs):
    """Fold one subgrid's NAF_NAFs [F, m, m] into the column accumulator
    NAF_MNAFs [F, m, yN], in place."""
    if _is_host(core):
        for i, c in enumerate(NAF_NAFs):
            core.add_to_facet(c, int(sg_off1), 1, out=NAF_MNAFs[i])
        return NAF_MNAFs
    return _fold_into(core, NAF_MNAFs, NAF_NAFs, int(sg_off1), -1)


def accumulate_facet_batch(
    core, NAF_MNAFs, sg_off0, offs1, masks1, facet_size, MNAF_BMNAFs
):
    """Fold a finished column accumulator into the per-facet accumulators
    MNAF_BMNAFs [F, yN, yB], in place.

    Axis-1 finish + mask (batched over facets), then axis-0 embed at the
    column's sg_off0.
    """
    if _is_host(core):
        p = core._p
        for i, (NAF_MNAF, off1, mask1) in enumerate(
            zip(NAF_MNAFs, offs1, masks1)
        ):
            NAF_BMNAF = core.finish_facet(NAF_MNAF, int(off1), facet_size, 1)
            NAF_BMNAF = np.ascontiguousarray(
                NAF_BMNAF * p.broadcast_along(np.asarray(mask1), 2, 1)
            )
            core.add_to_facet(NAF_BMNAF, int(sg_off0), 0, out=MNAF_BMNAFs[i])
        return MNAF_BMNAFs
    p = core._p
    NAF_BMNAFs = finish_facet_math(
        p, core._Fb, facet_size, NAF_MNAFs, _index(core, offs1), -1
    )
    NAF_BMNAFs = _mask_along(p, NAF_BMNAFs, _real(core, masks1), -1)
    return _fold_into(core, MNAF_BMNAFs, NAF_BMNAFs, int(sg_off0), -2)


def finish_facets_batch(core, MNAF_BMNAFs, offs0, masks0, facet_size):
    """MNAF_BMNAFs [F, yN, yB] -> finished facets [F, yB, yB].

    Each facet's full-size FFT runs on its own, into a preallocated stack.
    """
    if _is_host(core):
        p = core._p
        out = []
        for MNAF_BMNAF, off0, mask0 in zip(MNAF_BMNAFs, offs0, masks0):
            facet = core.finish_facet(MNAF_BMNAF, int(off0), facet_size, 0)
            out.append(facet * p.broadcast_along(np.asarray(mask0), 2, 0))
        return np.stack(out)
    p = core._p
    masks0 = _real(core, masks0)
    out = None
    for i, off0 in enumerate(offs0):
        facet = finish_facet_math(
            p, core._Fb, facet_size, MNAF_BMNAFs[i], int(off0), 0
        )
        facet = _mask_along(p, facet, masks0[i], 0)
        if out is None:
            out = facet.new_empty((len(offs0),) + tuple(facet.shape))
        out[i] = facet
        del facet
    return out


def backward_all_batch(
    core, subgrids, sg_offs, offs0, offs1, masks0, masks1, facet_size
):
    """The full backward cover: facets [F, yB, yB].

    Loops over the C subgrid columns: each column's subgrids split into all
    facets in one batched call and fold into a column accumulator, which
    then folds into the per-facet accumulators; finally every facet is
    finished. Accumulators update in place.

    :param subgrids: [C, S, xA, xA] stacked column-major subgrid data, or
        nested lists of per-subgrid arrays (stacked one column at a time,
        so no second copy of the whole cover is made)
    :param sg_offs: [C, S, 2] matching (off0, off1) pairs (off0 constant
        within a column)
    """
    if _is_host(core):
        MNAF_BMNAFs = np.zeros(
            (len(offs0), core.yN_size, facet_size), dtype=complex
        )
        for c in range(len(subgrids)):
            col = np.zeros(
                (len(offs0), core.xM_yN_size, core.yN_size), dtype=complex
            )
            col = split_accumulate_batch(
                core, subgrids[c], [tuple(o) for o in sg_offs[c]],
                offs0, offs1, col,
            )
            MNAF_BMNAFs = accumulate_facet_batch(
                core, col, sg_offs[c][0][0], offs1, masks1, facet_size,
                MNAF_BMNAFs,
            )
        return finish_facets_batch(
            core, MNAF_BMNAFs, offs0, masks0, facet_size
        )
    F = len(offs0)
    planar = (2,) if core.backend == "planar" else ()
    zeros = lambda shape: torch.zeros(shape + planar, dtype=core.dtype,
                                      device=core.device)
    MNAF_BMNAFs = zeros((F, core.yN_size, facet_size))
    for c in range(len(subgrids)):
        col_offs = [tuple(int(v) for v in o) for o in sg_offs[c]]
        col = split_accumulate_batch(
            core, subgrids[c], col_offs, offs0, offs1,
            zeros((F, core.xM_yN_size, core.yN_size)),
        )
        accumulate_facet_batch(
            core, col, col_offs[0][0], offs1, masks1, facet_size, MNAF_BMNAFs
        )
        del col
    return finish_facets_batch(core, MNAF_BMNAFs, offs0, masks0, facet_size)
