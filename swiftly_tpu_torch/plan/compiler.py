"""`compile_plan`: search the cost model, emit one executable plan.

The port of the JAX package's ``swiftly_tpu/plan/compiler.py``. The plan
is the one source for the decisions the executors and services take:

* the backward facet x output-row-slab pass grid (`plan_backward_passes`)
  and its feed-once/fold-many schedule (`plan_backward_feed`: how many
  passes share each feed of the subgrid stream under the device budget;
  the grid is grouped, never changed);
* the spill policy (RAM / disk / forward replay) for the subgrid stream
  every backward pass consumes;
* the serve batch shapes (power-of-two buckets under the coalescing
  cap) and the admission byte projections;
* the forward's column/facet grouping, predicted through the port's own
  streamed sizers (`PlanInputs.base()`): the executors still make the
  binding choice at dispatch time, and a test holds the two equal;
* the `MeshLayout`, priced for the planned device count and bound by the
  mesh-streamed engines (`swiftly_tpu_torch.mesh`) that execute it.

Selection policy: with default coefficients the compiler keeps the seed
heuristics' choices (the fold group the inputs carry), so default plans
equal hand-composed ones; with calibrated coefficients
(``compile_plan(..., history=...)``, or ``coeffs`` from
`autotune.refit_from_ledger`) it picks the fold group by predicted wall
from (1, 2, 4, 8), and records every evaluated alternative.

The JAX functions default ``fwd_min`` and ``reserve`` to memory sizes
chosen for a TPU; here `plan_margins` derives them from the port's
own geometry (``compile_plan`` does so per fold group unless the caller
passes them). Nothing in the port calls ``compile_plan`` implicitly: a
caller composes the plan and hands its parts to the executors.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from .model import (
    CostCoefficients,
    PlanInputs,
    bucket_sizes,
    price_backward,
    price_forward,
)

__all__ = [
    "BackwardPlan",
    "CacheTierPlan",
    "DeltaPlan",
    "MeshLayout",
    "Plan",
    "ServePlan",
    "SpillPolicy",
    "compile_plan",
    "plan_backward_feed",
    "plan_backward_passes",
    "plan_delta",
    "plan_margins",
    "plan_mesh_layout",
    "price_cache_tier",
    "stamp_measured_wall",
]

PLAN_SCHEMA = "swiftly-tpu-plan/1"


def stamp_measured_wall(block, measured_wall_s):
    """Close a stamped plan block with its measured wall.

    Sig-fig rounding, not decimal (``round(x, 4)`` zeroes sub-0.1 ms
    walls); the ratio (predicted / measured) is emitted whenever both
    walls are positive. Shared by `Plan.artifact_block` and the callers'
    leg close.
    """
    from ..obs.ledger import round_sig

    measured = float(measured_wall_s)
    block["measured_wall_s"] = round_sig(measured)
    pred = (block.get("predicted") or {}).get("wall_s") or 0
    if pred > 0 and measured > 0:
        block["predicted_vs_measured"] = round_sig(pred / measured)
    return block


# Fold groups the calibrated search ranks (the seed default is always
# among them; larger groups trade dispatch count against the fold
# pipeline's resident rows).
_FOLD_GROUP_CANDIDATES = (1, 2, 4, 8)


def _pad_to_shards(n, n_shards):
    """Facet count padded up to a multiple of the shard count (padded
    facets carry zero masks and contribute exact zeros)."""
    return ((n + n_shards - 1) // n_shards) * n_shards


def _resolve_collective():
    """``SWIFTLY_MESH_COLLECTIVE`` (psum | ring | auto, default auto),
    rejecting anything else loudly."""
    mode = os.environ.get("SWIFTLY_MESH_COLLECTIVE", "auto")
    if mode not in ("psum", "ring", "auto"):
        raise ValueError(
            f"SWIFTLY_MESH_COLLECTIVE must be psum|ring|auto, got {mode!r}"
        )
    return mode


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


# ---------------------------------------------------------------------------
# Plan components
# ---------------------------------------------------------------------------


@dataclass
class BackwardPlan:
    parts: list
    fold_group: int
    resident_bytes: int
    feed_group: int = 1  # passes sharing one stream feed

    @property
    def n_passes(self):
        return len(self.parts)

    @property
    def n_facet_passes(self):
        return len({(p[0], p[1]) for p in self.parts})

    @property
    def n_row_slabs(self):
        return len({(p[2], p[3]) for p in self.parts})

    @property
    def n_feeds(self):
        return -(-self.n_passes // max(1, self.feed_group))

    def feed_chunks(self):
        """The pass list chunked by the feed schedule: each chunk is
        the group of parts one `feed_backward_passes` call serves."""
        q = max(1, self.feed_group)
        return [self.parts[i : i + q] for i in range(0, len(self.parts), q)]

    def as_dict(self):
        return {
            "n_passes": self.n_passes,
            "n_facet_passes": self.n_facet_passes,
            "n_row_slabs": self.n_row_slabs,
            "fold_group": self.fold_group,
            "feed_group": self.feed_group,
            "n_feeds": self.n_feeds,
            "resident_bytes": int(self.resident_bytes),
        }


@dataclass
class SpillPolicy:
    """Where the subgrid stream lives between backward passes."""

    use_spill: bool
    mode: str                 # "none" | "ram" | "disk" | "replay"
    budget_bytes: int
    stream_bytes: int
    spill_dir: str | None = None

    def as_dict(self):
        return {
            "use_spill": self.use_spill,
            "mode": self.mode,
            "budget_bytes": int(self.budget_bytes),
            "stream_bytes": int(self.stream_bytes),
            "disk_backed": self.spill_dir is not None,
        }

    def make_cache(self):
        """A `SpillCache` budgeted per this policy (the fork the cache
        used to price for itself)."""
        from ..utils.spill import SpillCache

        return SpillCache(
            budget_bytes=self.budget_bytes, spill_dir=self.spill_dir,
            policy=self.as_dict(),
        )


@dataclass
class ServePlan:
    """Serve-side shapes + admission pricing for this geometry."""

    max_batch: int
    bucket_sizes: list
    request_bytes: int
    column_bytes: int

    def as_dict(self):
        return {
            "max_batch": self.max_batch,
            "bucket_sizes": list(self.bucket_sizes),
            "request_bytes": int(self.request_bytes),
            "column_bytes": int(self.column_bytes),
        }


@dataclass
class MeshLayout:
    """How the plan shards the streamed pipeline over a device mesh
    (ROADMAP item 1).

    The facet axis is the natural shard — every accumulation is a sum
    over facets, the contraction-over-mesh shape of arXiv 2002.03260 —
    so the layout is 1-D: ``facet_shards`` devices, the facet stack
    zero-padded to ``padded_facets`` (`_pad_to_shards`;
    padded facets carry zero masks and contribute exact zeros). The
    cost model prices per-shard HBM (``per_shard_stack_bytes`` vs the
    budget → ``fits_hbm``) and the collective traffic (one psum of
    the column's [S, xM, xM] partials per column —
    `utils.profiling.column_collective_bytes`).

    ``status`` records pedigree: ``"stub"`` until an executor consumes
    the layout; the mesh-streamed engine
    (ROADMAP A8) flips it
    to ``"bound"`` and records the padding it actually executed.

    ``collective`` is the PLANNED facet-axis reduction schedule (psum —
    the blocking all-reduce — or ring, the `ppermute` pipeline whose
    chunk rotations hide behind compute; `parallel.sharded`): an
    explicit SWIFTLY_MESH_COLLECTIVE wins, ``auto`` lets CALIBRATED
    coefficients pick the faster-priced row of
    ``collective_candidates`` (`model.price_collective_candidates`) and
    stays psum under defaults — the same defaults-only-RANK rule as the
    colpass candidates. A run checks executed == planned.
    """

    n_devices: int = 1
    facet_shards: int = 1
    axis: str = "facets"
    status: str = "stub"
    padded_facets: int = 0
    per_shard_stack_bytes: int = 0
    fits_hbm: bool | None = None
    collective_bytes_per_column: int = 0
    collective_bytes_total: int = 0
    collective: str = "psum"
    collective_candidates: list = field(default_factory=list)

    def bind(self):
        """Mark the layout consumed by an executor."""
        self.status = "bound"
        return self

    def as_dict(self):
        out = {
            "n_devices": self.n_devices,
            "facet_shards": self.facet_shards,
            "axis": self.axis,
            "status": self.status,
            "padded_facets": self.padded_facets,
            "per_shard_stack_bytes": int(self.per_shard_stack_bytes),
            "fits_hbm": self.fits_hbm,
            "collective_bytes_per_column": int(
                self.collective_bytes_per_column
            ),
            "collective_bytes_total": int(self.collective_bytes_total),
            "collective": self.collective,
        }
        if self.collective_candidates:
            out["collective_candidates"] = list(
                self.collective_candidates
            )
        return out


def plan_mesh_layout(inputs, mode="roundtrip-streamed", coeffs=None):
    """The mesh layout the cost model chooses for ``inputs``.

    Shard count: every planned device, capped at the facet count (a
    shard holding only zero-padding is exact but pure waste). The HBM
    budget enters as the per-shard residency check: the sharded facet
    stack slice plus a one-column working set must fit the per-device
    budget (``fits_hbm``; None with no budget, e.g. CPU). Collective
    bytes are the forward column psum (ring all-reduce accounting) plus
    — for round-trip modes — the backward's replicated-subgrid
    placement traffic, totalled over the cover.

    Collective schedule: SWIFTLY_MESH_COLLECTIVE=psum|ring forces the
    stage; ``auto`` (default) prices both schedules when ``coeffs`` is
    given and lets a CALIBRATED model pick the cheaper one, otherwise
    keeps psum — defaults only rank, they never flip the executed
    schedule (the same gate the colpass candidates obey).
    """
    from ..utils.profiling import column_collective_bytes

    shards = max(1, min(int(inputs.n_devices), int(inputs.n_facets)))
    padded = _pad_to_shards(inputs.n_facets, shards)
    per_facet = inputs.yB * inputs.yB * (
        inputs.dtype_bytes if inputs.real_facets else inputs.per_el
    )
    per_shard = (padded // shards) * per_facet
    fits = None
    if inputs.hbm_budget:
        fits = bool(per_shard + 3e9 <= inputs.hbm_budget)
    core = inputs.base().core
    col_fwd = column_collective_bytes(
        core, shards, inputs.subgrids_per_column, "forward"
    )
    total = col_fwd * inputs.n_columns
    if mode == "roundtrip-streamed":
        total += inputs.n_columns * column_collective_bytes(
            core, shards, inputs.subgrids_per_column, "backward",
            subgrid_size=inputs.xA,
        )
    layout = MeshLayout(
        n_devices=int(inputs.n_devices),
        facet_shards=shards,
        padded_facets=int(padded),
        per_shard_stack_bytes=int(per_shard),
        fits_hbm=fits,
        collective_bytes_per_column=int(col_fwd),
        collective_bytes_total=int(total),
    )
    env = _resolve_collective()
    if coeffs is not None and shards > 1 and total:
        from .model import price_collective_candidates

        layout.collective_candidates = price_collective_candidates(
            inputs, coeffs, mesh=layout, mode=mode
        )
    if shards <= 1:
        layout.collective = "psum"
    elif env in ("psum", "ring"):
        layout.collective = env
    elif (
        coeffs is not None
        and coeffs.calibrated
        and layout.collective_candidates
    ):
        layout.collective = layout.collective_candidates[0]["collective"]
    else:
        layout.collective = "psum"
    return layout


@dataclass
class Plan:
    """One compiled, executable plan plus its self-description."""

    inputs: PlanInputs
    mode: str
    backward: BackwardPlan
    spill: SpillPolicy
    serve: ServePlan
    mesh: MeshLayout
    forward: dict
    predicted: dict
    alternatives: list = field(default_factory=list)
    coeffs_source: str = "default"

    def artifact_block(self, measured_wall_s=None):
        """The ``plan_compiled`` block a run's artifact stamps (validated
        by `obs.validate_plan_artifact`)."""
        block = {
            "schema": PLAN_SCHEMA,
            "inputs_hash": self.inputs.inputs_hash(),
            "config": self.inputs.config_name,
            "mode": self.mode,
            "backward": self.backward.as_dict(),
            "spill": self.spill.as_dict(),
            "serve": self.serve.as_dict(),
            "mesh": self.mesh.as_dict(),
            "forward": dict(self.forward),
            "predicted": dict(self.predicted),
            "coeffs_source": self.coeffs_source,
            "alternatives": list(self.alternatives),
        }
        if measured_wall_s is not None:
            stamp_measured_wall(block, measured_wall_s)
        return block

    def explain(self):
        """Human-readable plan report."""
        i = self.inputs
        gib = 2.0 ** 30
        lines = [
            f"plan for {i.config_name or 'custom geometry'} "
            f"({self.mode})",
            f"  cover: N={i.N} facets={i.n_facets}x{i.yB} "
            f"columns={i.n_columns} subgrids={i.n_subgrids}x{i.xA}",
            f"  budget: "
            + (
                f"{i.hbm_budget / gib:.2f} GiB/device"
                if i.hbm_budget
                else "unlimited (CPU)"
            )
            + f" x {i.n_devices} device(s)",
            f"  forward: {self.forward}",
            f"  backward: {self.backward.n_passes} pass(es) = "
            f"{self.backward.n_facet_passes} facet subset(s) x "
            f"{self.backward.n_row_slabs} row slab(s), "
            f"fold_group={self.backward.fold_group}, "
            f"resident {self.backward.resident_bytes / gib:.2f} GiB",
            self._explain_feed(),
            f"  spill: {self.spill.mode} "
            f"(stream {self.spill.stream_bytes / gib:.2f} GiB, "
            f"budget {self.spill.budget_bytes / gib:.2f} GiB)",
            f"  serve: buckets {self.serve.bucket_sizes} "
            f"(request {self.serve.request_bytes} B, "
            f"column {self.serve.column_bytes / 1e6:.1f} MB)",
            f"  mesh: {self.mesh.facet_shards} facet shard(s) over "
            f"{self.mesh.n_devices} device(s) [{self.mesh.status}]"
            + (
                f" — {i.n_facets} facets padded to "
                f"{self.mesh.padded_facets}, "
                f"{self.mesh.per_shard_stack_bytes / gib:.2f} GiB "
                f"stack/shard"
                + (
                    ""
                    if self.mesh.fits_hbm is None
                    else (" (fits HBM)" if self.mesh.fits_hbm
                          else " (EXCEEDS HBM)")
                )
                + f", {self.mesh.collective_bytes_total / 1e9:.2f} GB "
                f"collectives/cover ({self.mesh.collective})"
                if self.mesh.facet_shards > 1
                else ""
            ),
            f"  predicted wall: {self.predicted['wall_s']:.1f} s "
            f"({self.coeffs_source} coefficients), HBM peak "
            f"{self.predicted['hbm_peak_bytes'] / gib:.2f} GiB",
        ]
        stages = self.predicted.get("stages") or {}
        for name, st in stages.items():
            lines.append(f"    {name}: {st['wall_s']:.1f} s")
        if self.alternatives:
            lines.append("  rejected alternatives:")
            for alt in self.alternatives:
                if alt.get("chosen"):
                    continue
                if alt.get("schedule"):
                    lines.append(
                        f"    schedule={alt['schedule']}: "
                        f"{alt['n_feeds']} feed(s) of "
                        f"{alt['feed_group']} pass(es), "
                        f"predicted {alt['predicted_wall_s']:.1f} s"
                    )
                    continue
                lines.append(
                    f"    fold_group={alt['fold_group']}: "
                    f"{alt['n_passes']} passes "
                    f"({alt['n_facet_passes']}x{alt['n_row_slabs']}"
                    + (
                        f", {alt['n_feeds']} feed(s)"
                        if "n_feeds" in alt
                        else ""
                    )
                    + f"), predicted {alt['predicted_wall_s']:.1f} s"
                )
        return "\n".join(lines)

    def _explain_feed(self):
        """The feed-once/fold-many schedule line: passes-per-feed, h2d
        bytes the shared feed removes vs per-pass feeding, and whether
        the fold compute is predicted to hide the feed (overlap)."""
        gib = 2.0 ** 30
        bwd = self.backward
        saved = (bwd.n_passes - bwd.n_feeds) * self.inputs.stream_bytes
        line = (
            f"  feed schedule: {bwd.n_feeds} feed(s) x "
            f"{bwd.feed_group} pass(es)/feed "
            f"(h2d saved vs per-pass feeding: {saved / gib:.2f} GiB)"
        )
        stages = self.predicted.get("stages") or {}
        feed = (stages.get("bwd.feed_group") or {}).get("wall_s")
        fold = (stages.get("bwd.sampled_fold") or {}).get("wall_s")
        if feed and fold:
            if fold >= feed:
                line += (
                    f" — overlap: fold compute ({fold:.1f} s) is "
                    f"predicted to hide the feed ({feed:.1f} s)"
                )
            else:
                line += (
                    f" — overlap: feed-bound ({feed:.1f} s feed vs "
                    f"{fold:.1f} s fold)"
                )
        return line


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------


def _predict(inputs, parts, fold_group, coeffs, mode, use_spill,
             fwd_min, reserve, mesh=None, feed_group=1):
    """Predicted per-stage walls + totals for one candidate plan.

    With a multi-shard ``mesh`` the prediction prices PER-SHARD HBM
    (facet stack, backward accumulator and row pipeline all shard over
    the facet axis) and adds the collective stage — `mesh.psum` or
    `mesh.ring_step` per the layout's planned ``collective``, priced by
    bytes (`model.price_collective_stage`, overlap-discounted for
    default-pedigree ring rates). Under the
    feed-once/fold-many schedule the HBM peak carries ``feed_group``
    shared pass residencies, and the feed traffic prices once per feed
    (`price_backward`'s ``bwd.feed_group`` stage).
    """
    shards = mesh.facet_shards if mesh is not None else 1
    stages = []
    if mode in ("streamed", "roundtrip-streamed"):
        stages += price_forward(inputs, coeffs)
    if mode == "roundtrip-streamed":
        stages += price_backward(
            inputs, parts, fold_group, coeffs, spill_fed=use_spill,
            feed_group=feed_group,
        )
    if mesh is not None and shards > 1 and mesh.collective_bytes_total:
        from .model import price_collective_stage

        stages.append(
            price_collective_stage(
                coeffs,
                getattr(mesh, "collective", "psum"),
                mesh.collective_bytes_total,
            )
        )
    wall = sum(s.wall_s for s in stages)
    resident = max(
        (i1 - i0)
        * (
            inputs.per_facet_acc_bytes * (r1 - r0) / inputs.yB
            + (2 * fold_group + 2) * inputs.per_facet_row_bytes
        )
        for i0, i1, r0, r1 in parts
    ) if mode == "roundtrip-streamed" else 0
    if mode == "roundtrip-streamed":
        q = min(max(1, feed_group), len(parts))
        peak = q * resident / shards + fwd_min + reserve
    else:
        peak = inputs.facet_stack_bytes / shards + 3e9
    if inputs.hbm_budget:
        peak = min(peak, inputs.hbm_budget)
    return {
        "wall_s": round(wall, 3),
        "hbm_peak_bytes": int(peak),
        "stages": {s.name: s.as_dict() for s in stages},
    }


def _forward_prediction(inputs, coeffs=None, headroom=0,
                        extra_out_stacks=0):
    """The forward's grouping as the port's `StreamedForward(residency=
    "device")` will choose it, through its own sizers on the geometry
    shim: resident facets while the stack and a one-column working set
    fit the budget (`col_group_for_budget`), else facet slabs of one
    (`grouped_col_group_for_budget`, one slab deep for facets synthesised
    on the card, else two unless two slabs take half the budget).

    `headroom` is what the caller leaves the backward (the executor's
    ``hbm_headroom``), `extra_out_stacks` the stacks a recording stream
    holds back (its ``spill_out_stacks``). The colpass entry records the
    body the executor resolves (`resolve_colpass`), so a run can check
    executed == planned; the candidates are the ranked einsum-vs-kernel
    pricing (`price_colpass_candidates`)."""
    from ..parallel.streamed import (
        col_group_for_budget,
        facet_stack_bytes,
        grouped_col_group_for_budget,
    )
    from ..utils.flops import resolve_colpass
    from .model import price_colpass_candidates

    base = inputs.base()
    budget = inputs.hbm_budget
    if budget is not None:
        budget = budget - headroom

    def _with_colpass(pred, facets_in_program):
        pred["colpass"] = resolve_colpass(
            base.core, max(1, facets_in_program)
        )
        if coeffs is not None:
            pred["colpass_candidates"] = price_colpass_candidates(
                inputs, coeffs
            )
            if (
                pred["colpass"] == "kernel"
                and coeffs.colpass_blocks is not None
            ):
                pred["colpass_blocks"] = dict(coeffs.colpass_blocks)
        return pred

    resident_facets = inputs.n_facets // max(1, inputs.n_devices)
    if budget is None:
        return _with_colpass(
            {"mode": "resident", "col_group": inputs.n_columns,
             "facet_group": None},
            resident_facets,
        )
    if facet_stack_bytes(base, inputs.real_facets) + 3e9 <= budget:
        G = col_group_for_budget(
            base, budget, inputs.n_columns, real=inputs.real_facets,
            extra_out_stacks=extra_out_stacks,
        )
        return _with_colpass(
            {"mode": "resident", "col_group": G, "facet_group": None},
            resident_facets,
        )
    Fg = 1
    slab_b = Fg * inputs.yB * inputs.yB * (
        inputs.dtype_bytes if inputs.real_facets else inputs.per_el
    )
    depth = 1 if 2 * slab_b > 0.5 * budget else 2
    G = grouped_col_group_for_budget(
        base, budget, inputs.n_columns, inputs.subgrids_per_column,
        inputs.xA, inputs.real_facets, Fg, 1,
        slab_depth=1 if inputs.sparse_facets else depth, warn=False,
        extra_out_stacks=extra_out_stacks,
    )
    return _with_colpass(
        {"mode": "grouped", "col_group": min(G, inputs.n_columns),
         "facet_group": Fg, "chunk": 1, "slab_depth": depth},
        Fg,
    )


def compile_plan(
    inputs, history=None, coeffs=None, mode="roundtrip-streamed",
    fwd_min=None, reserve=None,
    n_facet_env=0, n_row_env=0, allow_spill=True,
    spill_budget=None, spill_dir=None, feed_env=0,
):
    """Search the cost model; emit one `Plan`.

    :param inputs: `PlanInputs` (geometry + budget + device count)
    :param history: artifact records (dicts or paths) for
        `autotune.refit` (records of a platform the port does not run on
        are skipped); measured coefficients unlock parameter selection by
        predicted wall; without history the seed heuristics' choices are
        kept
    :param coeffs: explicit `CostCoefficients` (overrides history)
    :param fwd_min, reserve: the backward plan's margins; each left None
        is `plan_margins` of the inputs' geometry at the fold group priced
    :param n_facet_env, n_row_env: operator pass-grid overrides
    :param allow_spill: False forces the replay cost model
    :param spill_budget, spill_dir: spill-policy overrides; defaults
        are `utils.spill.spill_budget_bytes()` and ``SWIFTLY_SPILL_DIR``
    :param feed_env: operator passes-per-feed override for the
        feed-once/fold-many schedule (0: `plan_backward_feed` sizes it)
    """
    if coeffs is None:
        if history:
            from .autotune import refit

            coeffs = refit(history)
        else:
            coeffs = CostCoefficients()

    def _margins(fold_group):
        if fwd_min is not None and reserve is not None:
            return fwd_min, reserve
        fm, rs = plan_margins(inputs.base(), inputs.xA, fold_group)
        return (fm if fwd_min is None else fwd_min,
                rs if reserve is None else reserve)

    def _passes(fold_group):
        fm, rs = _margins(fold_group)
        return plan_backward_passes(
            inputs.n_facets, inputs.yB, inputs.per_facet_acc_bytes,
            inputs.per_facet_row_bytes, fold_group, inputs.hbm_budget,
            fm, rs, n_facet_env=n_facet_env, n_row_env=n_row_env,
        )

    # spill policy resolution happens before the candidate search: a
    # stream too large for the cache budget (and with no disk backing)
    # replays the forward per feed, and the fold-group ranking must see
    # that cost
    if spill_budget is None:
        from ..utils.spill import spill_budget_bytes

        spill_budget = spill_budget_bytes()
    if spill_dir is None:
        spill_dir = os.environ.get("SWIFTLY_SPILL_DIR") or None

    def _feed(parts, resident, fold_group):
        fm, rs = _margins(fold_group)
        return plan_backward_feed(
            parts, resident, inputs.hbm_budget, fm, rs, feed_env=feed_env,
        )

    def _spill_mode(parts, feed_group=1):
        # the cache serves the feeds after the first; a schedule whose one
        # feed serves every pass never re-reads the stream
        n_feeds = -(-len(parts) // max(1, feed_group))
        if not (allow_spill and n_feeds > 1):
            return "none"
        if inputs.stream_bytes <= spill_budget:
            return "ram"
        if spill_dir:
            return "disk"
        return "replay"

    # the mesh layout, chosen before the candidate search so every
    # prediction prices the same layout
    mesh = plan_mesh_layout(inputs, mode=mode, coeffs=coeffs)

    # -- fold-group search (the calibrated lever) ------------------------------
    candidates = sorted(
        {inputs.fold_group}
        | {
            fg for fg in _FOLD_GROUP_CANDIDATES
            if fg <= max(1, inputs.n_columns)
        }
    )
    alternatives = []
    best = None
    for fg in candidates:
        parts_c, resident_c = _passes(fg)
        feed_c = _feed(parts_c, resident_c, fg)
        use_spill_c = _spill_mode(parts_c, feed_c) in ("ram", "disk")
        pred_c = _predict(inputs, parts_c, fg, coeffs, mode,
                          use_spill_c, *_margins(fg), mesh=mesh,
                          feed_group=feed_c)
        alt = {
            "fold_group": fg,
            "n_passes": len(parts_c),
            "n_facet_passes": len({(p[0], p[1]) for p in parts_c}),
            "n_row_slabs": len({(p[2], p[3]) for p in parts_c}),
            "feed_group": feed_c,
            "n_feeds": -(-len(parts_c) // feed_c),
            "predicted_wall_s": pred_c["wall_s"],
            "chosen": False,
        }
        alternatives.append(alt)
        cand = (
            pred_c["wall_s"], fg, parts_c, resident_c, feed_c, pred_c,
            alt,
        )
        if best is None or cand[0] < best[0]:
            best = cand
    if coeffs.calibrated and mode == "roundtrip-streamed":
        (_wall, fold_group, parts, resident, feed_group, predicted,
         chosen_alt) = best
    else:
        # default coefficients: keep the seed heuristic's fold group
        fold_group = inputs.fold_group
        parts, resident = _passes(fold_group)
        feed_group = _feed(parts, resident, fold_group)
        predicted = _predict(
            inputs, parts, fold_group, coeffs, mode,
            _spill_mode(parts, feed_group) in ("ram", "disk"),
            *_margins(fold_group), mesh=mesh, feed_group=feed_group,
        )
        chosen_alt = next(
            a for a in alternatives if a["fold_group"] == fold_group
        )
    chosen_alt["chosen"] = True
    fm, rs = _margins(fold_group)

    # the same grid fed once per pass, recorded so an explanation can show
    # what the shared feed buys
    if mode == "roundtrip-streamed" and len(parts) > 1:
        pred_pp = _predict(
            inputs, parts, fold_group, coeffs, mode,
            _spill_mode(parts, 1) in ("ram", "disk"), fm, rs, mesh=mesh,
            feed_group=1,
        )
        alternatives.append(
            {
                "schedule": "per_pass_feed",
                "fold_group": fold_group,
                "n_passes": len(parts),
                "n_facet_passes": len({(p[0], p[1]) for p in parts}),
                "n_row_slabs": len({(p[2], p[3]) for p in parts}),
                "feed_group": 1,
                "n_feeds": len(parts),
                "predicted_wall_s": pred_pp["wall_s"],
                "chosen": feed_group == 1,
            }
        )

    # -- spill policy ----------------------------------------------------------
    spill_mode = _spill_mode(parts, feed_group)
    use_spill = spill_mode in ("ram", "disk")
    spill = SpillPolicy(
        use_spill=use_spill, mode=spill_mode,
        budget_bytes=int(spill_budget),
        stream_bytes=int(inputs.stream_bytes), spill_dir=spill_dir,
    )

    # -- serve shapes + admission pricing --------------------------------------
    serve = ServePlan(
        max_batch=inputs.max_batch,
        bucket_sizes=bucket_sizes(inputs.max_batch),
        request_bytes=inputs.xA * inputs.xA * inputs.per_el,
        column_bytes=inputs.n_facets * inputs.m * inputs.yN
        * inputs.per_el,
    )

    # the forward is sized beside what the backward keeps resident (the
    # executor's hbm_headroom: the feed's passes and their transients)
    headroom = 0
    if mode == "roundtrip-streamed" and inputs.hbm_budget is not None:
        headroom = int(min(feed_group, len(parts)) * resident + rs)
    forward = _forward_prediction(
        inputs, coeffs, headroom=headroom,
        extra_out_stacks=1 if use_spill else 0)
    forward["hbm_headroom"] = headroom
    predicted["fwd_min_bytes"] = int(fm)
    predicted["reserve_bytes"] = int(rs)

    return Plan(
        inputs=inputs,
        mode=mode,
        backward=BackwardPlan(parts, fold_group, resident, feed_group),
        spill=spill,
        serve=serve,
        mesh=mesh,
        forward=forward,
        predicted=predicted,
        alternatives=alternatives,
        coeffs_source=coeffs.source,
    )


# ---------------------------------------------------------------------------
# Incremental (facet-delta) planning
# ---------------------------------------------------------------------------


@dataclass
class DeltaPlan:
    """Incremental-vs-full pricing for a K-of-J facet update.

    ``mode`` is the cheaper choice for the REQUESTED K ("patch" = delta
    stream + cache patch, "full" = re-record); ``break_even_k`` the
    smallest K at which the full recompute wins (J+1 when the patch
    wins at every K — e.g. replay-mode streams where the full path
    pays no re-record IO either way price differently). Every scanned
    K is kept in ``alternatives`` so `explain` prints the whole
    break-even table, and the rejected choice for the
    requested K is among them (``chosen`` flags), matching
    `compile_plan`'s alternative-recording contract.
    """

    changed_facets: int
    n_facets: int
    mode: str  # "patch" | "full"
    predicted_wall_s: float
    full_wall_s: float
    break_even_k: int
    alternatives: list = field(default_factory=list)
    coeffs_source: str = "default"

    def as_dict(self):
        return {
            "changed_facets": int(self.changed_facets),
            "n_facets": int(self.n_facets),
            "mode": self.mode,
            "predicted_wall_s": round(float(self.predicted_wall_s), 4),
            "full_wall_s": round(float(self.full_wall_s), 4),
            "break_even_k": int(self.break_even_k),
            "coeffs_source": self.coeffs_source,
            "alternatives": list(self.alternatives),
        }

    def explain(self):
        """Human-readable break-even table
        """
        lines = [
            f"delta plan: {self.changed_facets} of {self.n_facets} "
            f"facet(s) changed -> {self.mode} "
            f"({self.predicted_wall_s:.2f} s vs full "
            f"{self.full_wall_s:.2f} s, {self.coeffs_source} "
            "coefficients)",
            f"  break-even: full recompute wins from K = "
            f"{self.break_even_k}"
            + (
                " (never within this cover)"
                if self.break_even_k > self.n_facets
                else ""
            ),
            "  K  patch_wall_s  full_wall_s  choice",
        ]
        for alt in self.alternatives:
            mark = " *" if alt.get("chosen") else ""
            lines.append(
                f"  {alt['changed_facets']:>2}  "
                f"{alt['patch_wall_s']:>12.3f}  "
                f"{alt['full_wall_s']:>11.3f}  "
                f"{alt['mode']}{mark}"
            )
        return "\n".join(lines)


def plan_delta(inputs, changed_facets, coeffs=None, history=None):
    """Price a K-changed-facet incremental update against the full
    streamed recompute; pick the cheaper (`DeltaPlan`).

    The incremental path prices a forward RESTRICTED to the K delta
    facets (the linearity argument of docs/incremental.md: the
    restricted column pass is exactly the additive correction) plus the
    patch IO — the delta stream's d2h pull and the cached stream's
    read-modify-write. The full path prices the whole-stack forward
    plus the re-record d2h. Both use the same stage coefficients as
    `compile_plan` — with ``history``, `autotune.refit`'s measured
    rates (autotune-refittable break-even).
    """
    if coeffs is None:
        if history:
            from .autotune import refit

            coeffs = refit(history)
        else:
            coeffs = CostCoefficients()
    k = int(changed_facets)
    n = int(inputs.n_facets)
    if not 1 <= k <= n:
        raise ValueError(
            f"changed_facets must be in [1, {n}] (got {k})"
        )
    stream = int(inputs.stream_bytes)

    def patch_wall(kk):
        # fwd restricted to the K deltas, plus the correction stream's
        # d2h+store (every facet touches every column, so the
        # correction spans the full stream — same bytes the full
        # re-record moves), plus the patch's ONLY extra IO: reading
        # the recorded base for the in-place add.
        fwd = sum(
            s.wall_s
            for s in price_forward(inputs.replace(n_facets=kk), coeffs)
        )
        store = coeffs.price("spill.write", bytes_moved=stream).wall_s
        base_read = coeffs.price("spill.read", bytes_moved=stream).wall_s
        return fwd + store + base_read

    full_wall = (
        sum(s.wall_s for s in price_forward(inputs, coeffs))
        + coeffs.price("spill.write", bytes_moved=stream).wall_s
    )
    alternatives = []
    break_even = n + 1
    for kk in range(1, n + 1):
        pw = patch_wall(kk)
        mode_k = "patch" if pw < full_wall else "full"
        if mode_k == "full" and break_even > n:
            break_even = kk
        alternatives.append(
            {
                "changed_facets": kk,
                "patch_wall_s": round(pw, 4),
                "full_wall_s": round(full_wall, 4),
                "mode": mode_k,
                "chosen": kk == k,
            }
        )
    chosen = alternatives[k - 1]
    return DeltaPlan(
        changed_facets=k,
        n_facets=n,
        mode=chosen["mode"],
        predicted_wall_s=(
            chosen["patch_wall_s"]
            if chosen["mode"] == "patch"
            else full_wall
        ),
        full_wall_s=full_wall,
        break_even_k=break_even,
        alternatives=alternatives,
        coeffs_source=coeffs.source,
    )


# ---------------------------------------------------------------------------
# Cache-tier (serve fabric) planning
# ---------------------------------------------------------------------------


@dataclass
class CacheTierPlan:
    """L1 / L2 / recompute pricing for the shared serve cache fabric.

    For a replica fleet over one `cache.SharedStreamTier`, price where
    each request lands: a per-replica hot-row **L1** hit (the
    ``cache.l1`` rate), an **L2** read of the one resident stream (the
    ``spill.read`` rate the spill cache serves at), or a **recompute**
    (one coalesced column pass — what a stale bounce mid-patch falls
    back to). The L1 hit share follows a zipf-over-subgrids popularity
    model at ``zipf_s``; every scanned L1 size is kept in
    ``alternatives`` (``chosen`` flags) so
    `explain` prints the break-even table,
    matching `compile_plan`'s alternative-recording contract.

    ``break_even_l1_rows`` is the smallest per-replica L1 at which the
    expected per-request wall sits within 1% of the best scanned size:
    a bigger L1 buys latency the coefficients can no longer measure,
    it only buys HBM.
    """

    replicas: int
    n_subgrids: int
    row_bytes: int
    zipf_s: float
    stale_rate: float
    l1_hit_wall_s: float
    l2_hit_wall_s: float
    recompute_wall_s: float
    l1_rows: int
    break_even_l1_rows: int
    expected_wall_s: float
    alternatives: list = field(default_factory=list)
    coeffs_source: str = "default"

    def as_dict(self):
        return {
            "replicas": int(self.replicas),
            "n_subgrids": int(self.n_subgrids),
            "row_bytes": int(self.row_bytes),
            "zipf_s": float(self.zipf_s),
            "stale_rate": float(self.stale_rate),
            "l1_hit_wall_s": round(float(self.l1_hit_wall_s), 9),
            "l2_hit_wall_s": round(float(self.l2_hit_wall_s), 9),
            "recompute_wall_s": round(float(self.recompute_wall_s), 6),
            "l1_rows": int(self.l1_rows),
            "break_even_l1_rows": int(self.break_even_l1_rows),
            "expected_wall_s": round(float(self.expected_wall_s), 9),
            "coeffs_source": self.coeffs_source,
            "alternatives": list(self.alternatives),
        }

    def explain(self):
        """Human-readable L1-size table
        """
        lines = [
            f"cache tier plan: {self.replicas} replica(s) over ONE "
            f"resident stream of {self.n_subgrids} rows "
            f"({self.coeffs_source} coefficients)",
            f"  per request: L1 hit {self.l1_hit_wall_s * 1e6:.2f} us"
            f" | L2 read {self.l2_hit_wall_s * 1e6:.2f} us"
            f" | recompute {self.recompute_wall_s * 1e3:.3f} ms"
            f" (one column pass; stale rate {self.stale_rate})",
            f"  popularity: zipf_s={self.zipf_s} over "
            f"{self.n_subgrids} subgrids; row_bytes={self.row_bytes}",
            f"  break-even L1: {self.break_even_l1_rows} rows/replica "
            "(larger L1s are within 1% of the best scanned wall)",
            "  l1_rows  hit_l1  hit_l2  wall_per_req_us  "
            "fleet_l1_bytes  choice",
        ]
        for alt in self.alternatives:
            mark = " *" if alt.get("chosen") else ""
            lines.append(
                f"  {alt['l1_rows']:>7}  "
                f"{alt['hit_l1']:>6.3f}  "
                f"{alt['hit_l2']:>6.3f}  "
                f"{alt['wall_per_req_s'] * 1e6:>15.2f}  "
                f"{alt['fleet_l1_bytes']:>14d}"
                f"{mark}"
            )
        return "\n".join(lines)


def price_cache_tier(inputs, coeffs=None, history=None, *,
                     replicas=3, l1_rows=None, zipf_s=1.1,
                     stale_rate=0.02):
    """Price the serve fabric's cache tiers for one config + replica
    count; returns a `CacheTierPlan`.

    The L2 (the one resident `utils.spill.SpillCache` recording) is
    COMPLETE, so in steady state a request either hits a replica's L1,
    reads the L2, or — at ``stale_rate``, the mid-patch / stale-bounce
    fraction during facet updates — recomputes one coalesced column
    pass. The L1 hit share for a per-replica capacity of ``c`` rows is
    the zipf top-``c`` mass (rendezvous routing makes each replica's
    popular set look like the global one over its column shard).
    Candidate L1 sizes are scanned in powers of two up to the cover;
    with ``l1_rows`` given, that size is the chosen row, otherwise the
    break-even size is. Coefficients refit from artifact ``history``
    exactly like `plan_delta` (autotune-refittable).
    """
    if coeffs is None:
        if history:
            from .autotune import refit

            coeffs = refit(history)
        else:
            coeffs = CostCoefficients()
    n_replicas = int(replicas)
    if n_replicas < 1:
        raise ValueError(f"replicas must be >= 1 (got {replicas})")
    if not 0.0 <= float(stale_rate) < 1.0:
        raise ValueError(
            f"stale_rate must be in [0, 1) (got {stale_rate})"
        )
    n_rows = int(inputs.n_subgrids)
    row_bytes = inputs.xA * inputs.xA * inputs.per_el
    l1_wall = coeffs.price("cache.l1", bytes_moved=row_bytes).wall_s
    l2_wall = coeffs.price("spill.read", bytes_moved=row_bytes).wall_s
    # a miss recomputes ONE coalesced column pass (the serve scheduler's
    # unit of compute); amortizing over co-batched requests is the
    # scheduler's bonus, not the plan's promise
    recompute_wall = (
        sum(s.wall_s for s in price_forward(inputs, coeffs))
        / max(1, inputs.n_columns)
    )

    # zipf top-c mass: H_c(s) / H_n(s)
    weights = [1.0 / (i ** float(zipf_s)) for i in range(1, n_rows + 1)]
    total_mass = sum(weights)
    prefix = []
    acc = 0.0
    for w in weights:
        acc += w
        prefix.append(acc)

    def expected(c):
        hit_l1 = 0.0 if c <= 0 else prefix[min(c, n_rows) - 1] / total_mass
        hit_l1 *= 1.0 - stale_rate
        hit_l2 = 1.0 - stale_rate - hit_l1
        wall = (
            hit_l1 * l1_wall
            + hit_l2 * l2_wall
            + stale_rate * recompute_wall
        )
        return hit_l1, hit_l2, wall

    candidates = [0]
    c = 1
    while c < n_rows:
        candidates.append(c)
        c *= 2
    candidates.append(n_rows)
    if l1_rows is not None and int(l1_rows) not in candidates:
        candidates = sorted(set(candidates) | {int(l1_rows)})

    priced = [(cc, *expected(cc)) for cc in candidates]
    best_wall = min(p[3] for p in priced)
    break_even = next(
        cc for cc, _h1, _h2, wall in priced
        if wall <= best_wall * 1.01
    )
    chosen_rows = break_even if l1_rows is None else int(l1_rows)
    alternatives = []
    chosen_wall = best_wall
    for cc, h1, h2, wall in priced:
        if cc == chosen_rows:
            chosen_wall = wall
        alternatives.append(
            {
                "l1_rows": cc,
                "hit_l1": round(h1, 4),
                "hit_l2": round(h2, 4),
                "wall_per_req_s": round(wall, 9),
                "fleet_l1_bytes": int(cc * row_bytes * n_replicas),
                "chosen": cc == chosen_rows,
            }
        )
    return CacheTierPlan(
        replicas=n_replicas,
        n_subgrids=n_rows,
        row_bytes=int(row_bytes),
        zipf_s=float(zipf_s),
        stale_rate=float(stale_rate),
        l1_hit_wall_s=l1_wall,
        l2_hit_wall_s=l2_wall,
        recompute_wall_s=recompute_wall,
        l1_rows=chosen_rows,
        break_even_l1_rows=break_even,
        expected_wall_s=chosen_wall,
        alternatives=alternatives,
        coeffs_source=coeffs.source,
    )
