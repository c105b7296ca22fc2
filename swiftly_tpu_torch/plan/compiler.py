"""The backward partition plan: a facet x output-row-slab grid of sampled
backward passes over one subgrid stream, and how many passes share a
feed of that stream.

The port of ``plan_backward_passes`` and ``plan_backward_feed`` from the
JAX package's ``swiftly_tpu/plan/compiler.py``: the same arguments, the
same operator overrides and the same results. Every pass consumes the
same stream, so with a recorded stream (`utils.spill.SpillCache`) the
whole plan costs one forward plus cache-fed feeds
(`parallel.streamed.feed_backward_passes`).

The JAX functions default ``fwd_min`` and ``reserve`` to memory sizes
chosen on a 16 GB TPU; here they are required, and `plan_margins`
derives them from the port's own geometry.

Not ported yet (ROADMAP A10): ``compile_plan`` and the rest of the
compiler (``PlanInputs``, ``SpillPolicy``, the mesh layout, autotune).
"""

from __future__ import annotations

__all__ = ["plan_backward_feed", "plan_backward_passes", "plan_margins"]


def plan_backward_passes(
    F_total, yB, per_facet_acc, per_facet_rows, fold_group, budget,
    fwd_min, reserve, n_facet_env=0, n_row_env=0,
):
    """Facet x output-row-slab partition plan for the sampled backward.

    Returns ``(parts, resident_bytes)``: `parts` is the pass list
    [(i0, i1, r0, r1), ...] -- facet subset [i0, i1) x accumulator rows
    [r0, r1) -- and `resident_bytes` the largest pass's accumulator and
    fold-row residency (what the forward's sizers must leave free,
    ``StreamedForward.hbm_headroom``).

    Facets are partitioned first (single-facet passes leave the shared
    stream the most room), then output-row slabs within a facet once even
    one facet's accumulator exceeds the per-pass budget
    (``StreamedBackward(row_slab=...)``).

    :param per_facet_acc: one facet's whole [yB, yB] accumulator bytes
    :param per_facet_rows: one facet's [m, yB] column-row bytes (the fold
        pipeline keeps 2*fold_group + 2 of these live per facet)
    :param budget: device bytes (None = unpartitioned, e.g. the CPU)
    :param fwd_min: bytes the forward's smallest plan needs beside the
        passes (`plan_margins`)
    :param reserve: a pass's transients beside its accumulator and rows
        (`plan_margins`)
    :param n_facet_env, n_row_env: operator overrides of the facet-pass
        and row-slab counts (0: planned)
    """
    rows_resident = (2 * fold_group + 2) * per_facet_rows
    usable = None if budget is None else budget - fwd_min - reserve
    if n_facet_env:
        n_parts = max(1, min(int(n_facet_env), F_total))
    elif usable is None:
        n_parts = 1
    elif F_total * (per_facet_acc + rows_resident) <= usable:
        n_parts = 1
    else:
        # once partitioning is forced, single-facet passes: the stream
        # feed dominates each pass and its sizing scales with the room
        # the accumulator leaves
        n_parts = F_total
    F_sub = -(-F_total // n_parts)
    n_row = 1
    if n_row_env:
        n_row = max(1, min(int(n_row_env), yB))
    elif usable is not None and n_parts > 1:
        per_pass = F_sub * (per_facet_acc + rows_resident)
        if per_pass > usable:
            # slab the accumulator; the column rows stay full width (the
            # fold consumes every row whatever slab it outputs)
            acc_budget = usable - F_sub * rows_resident
            per_row = max(1.0, F_sub * per_facet_acc / yB)
            h = int(acc_budget // per_row) if acc_budget > 0 else 0
            n_row = -(-yB // max(1, h))
    row_h = -(-yB // n_row)
    parts = [
        (i0, min(i0 + F_sub, F_total), r0, min(r0 + row_h, yB))
        for i0 in range(0, F_total, F_sub)
        for r0 in range(0, yB, row_h)
    ]
    resident = max(
        (i1 - i0) * (per_facet_acc * (r1 - r0) / yB + rows_resident)
        for i0, i1, r0, r1 in parts
    )
    return parts, int(resident)


def plan_backward_feed(parts, resident_per_pass, budget, fwd_min, reserve,
                       feed_env=0):
    """Passes per feed for the feed-once/fold-many schedule.

    ``q`` passes sharing one feed keep ``q`` accumulators (and their fold
    rows) resident at once beside the feed's working set; in exchange the
    stream is fed once per feed instead of once per pass. So q is the
    largest pass count whose summed residency fits the per-pass budget the
    grid was sized against (``budget - fwd_min - reserve``); the grid
    itself is unchanged.

    :param resident_per_pass: `plan_backward_passes`' second return
    :param feed_env: operator override (0: planned)
    :returns: passes per feed, in [1, len(parts)]
    """
    n_passes = len(parts)
    if feed_env:
        return max(1, min(int(feed_env), n_passes))
    if n_passes <= 1:
        return 1
    if budget is None:
        return n_passes  # unlimited (the CPU): one feed serves every pass
    usable = budget - fwd_min - reserve
    if resident_per_pass <= 0:
        return n_passes
    return max(1, min(int(usable // resident_per_pass), n_passes))


def plan_margins(forward, subgrid_size, fold_group):
    """``(fwd_min, reserve)`` for the plan functions, derived from the
    port's geometry rather than the JAX package's TPU constants.

    ``fwd_min`` is the forward's smallest plan as its slab sizer prices it
    (``parallel.streamed.grouped_working_set``): one facet a slab, one
    slab deep, one column a group, plus the stack a recording forward
    holds back until its copy to the host lands (``extra_out_stacks=1``):
    the sizer's flat bytes plus one column's.

    ``reserve`` is a backward pass's transients beside its accumulator and
    the fold rows `plan_backward_passes` prices: the sampled fold's
    conjugated rows (one fold group's), its row-block tables (the int64
    residues and the (cos, sin) planes [fold_group*m, B], B from
    ``_fold_row_block``), and the adjoint column pass's working set (the
    embedded subgrids [S, xM, xM], the contribution blocks [Sb, F, m, m]
    and the scatter's and finish's [F, m, yN] rows), for the whole facet
    stack: an upper bound for any pass.

    :param forward: a `StreamedForward` (or its ``_base``)
    :param subgrid_size: xA
    :param fold_group: the backward's columns per fold
    """
    import numpy as np
    import torch

    from ..parallel import streamed as sm

    base = getattr(forward, "_base", forward)
    core = base.core
    real = bool(getattr(forward, "_facets_real", True))
    m, xM, yN = core.xM_yN_size, core.xM_size, core.yN_size
    yB = base.stack.size
    F = base.stack.n_total
    S = -(-core.N // subgrid_size)
    flat, per_G = sm.grouped_working_set(
        base, S, subgrid_size, real, 1, 1, slab_depth=1, extra_out_stacks=1)
    fwd_min = flat + per_G
    dsize = np.dtype(sm._np_dtype(core)).itemsize * (
        2 if sm._planar(core) else 1)
    rsize = torch.empty((), dtype=core.real_dtype).element_size()
    R = fold_group * m
    B = sm._fold_row_block(
        F, yB, torch.empty((), dtype=core.dtype).element_size())
    Sb = min(sm._colpass_sblock(), S)
    reserve = (
        F * R * yB * dsize  # the conjugated rows
        + R * B * (3 * 8 + 2 * rsize)  # a row block's residues, phases
        + (S * xM * xM + 2 * Sb * F * m * m + 2 * F * m * yN) * dsize
    )
    return float(fwd_min), float(reserve)
