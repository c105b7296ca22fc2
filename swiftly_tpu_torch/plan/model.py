"""Declarative cost model: one pricing of the streamed pipeline's stages,
and the device-memory budget parser.

The port of the JAX package's ``swiftly_tpu/plan/model.py``. It takes
``(N, facet/subgrid geometry, dtype, device budget, device count)`` as a
`PlanInputs` and prices every stage (facet pass, column passes, sampled
fold, spill traffic, serve batch shapes) as bytes + FLOPs + an estimated
wall built from `CostCoefficients`: defaults measured on this port's
card, or per-stage rates refit from measured history by `plan.autotune`.

The FLOP formulas are not re-derived here: every count delegates to the
port's `utils.flops` (the same functions the obs instrumentation
attributes with), and the forward's group sizing reuses the port's
`parallel.streamed` sizers through a geometry shim (`PlanInputs.base()`).
The port's kernel bodies price under their own stage names: B1 as
``fwd.column_pass.kernel`` / ``bwd.column_pass.kernel`` (the JAX
package's ``.pallas`` stages).

The JAX module's ``DEFAULT_FWD_MIN_BYTES`` / ``DEFAULT_RESERVE_BYTES``
are memory sizes chosen for a TPU and are not carried across:
`plan.compiler.plan_margins` derives the port's from its own geometry.
Nor is any of its coefficient anchors: see `_DEFAULT_FLOPS_PER_S`.
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass, field, replace

import torch

__all__ = [
    "CostCoefficients",
    "PlanInputs",
    "StageCost",
    "bucket_shape",
    "bucket_sizes",
    "hbm_budget_bytes",
    "price_backward",
    "price_collective_candidates",
    "price_collective_stage",
    "price_colpass_candidates",
    "price_forward",
    "projected_column_bytes",
    "projected_request_bytes",
]


def hbm_budget_bytes(headroom=0.0, device=None, default=None,
                     honor_env_on_cpu=True, held=0):
    """Per-device memory budget in bytes: THE parser of
    ``SWIFTLY_HBM_BUDGET``.

    ``None`` means unlimited (the CPU, or no probe and no ``default``).

    :param headroom: caller-held resident bytes subtracted from the budget
        (e.g. `StreamedForward.hbm_headroom`)
    :param device: the device to size for; None: the card if there is
        one, else the CPU
    :param default: fallback bytes when the probe finds nothing on the
        card
    :param honor_env_on_cpu: True (the planner's semantics) applies an
        explicit ``SWIFTLY_HBM_BUDGET`` even on the CPU, which is how
        tests exercise partitioned plans there; False (the streamed
        executors') stays unlimited on the CPU whatever the variable says
    :param held: ("probe" only) device bytes the caller holds and prices
        itself, counted back into the probed free bytes
        (`utils.profiling.probe_hbm_bytes`); an explicit budget already is
        the whole device's
    """
    from ..utils.profiling import probe_hbm_bytes

    env = os.environ.get("SWIFTLY_HBM_BUDGET")
    if env and honor_env_on_cpu:
        return float(env) - headroom
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if env:
        return float(env) - headroom
    try:
        limit = probe_hbm_bytes(device, held)
    except RuntimeError:  # no usable driver: the caller's default
        limit = None
    if limit is None:
        limit = default
    if limit is None:
        return None
    return limit - headroom


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


class _GeomCore:
    """The geometry surface of a core, detached from any data or device:
    what `utils.flops` and the `parallel.streamed` sizers read."""

    def __init__(self, N, yN, xM, dtype_bytes, planar):
        self.N = int(N)
        self.yN_size = int(yN)
        self.xM_size = int(xM)
        self.xM_yN_size = int(xM) * int(yN) // int(N)
        self.backend = "planar" if planar else "torch"
        real = {4: torch.float32, 8: torch.float64}
        if planar:
            self.real_dtype = real[int(dtype_bytes)]
            self.dtype = self.real_dtype
        else:
            half = int(dtype_bytes) // 2
            self.real_dtype = real.get(half, torch.float32)
            self.dtype = {4: torch.complex64, 8: torch.complex128}.get(
                half, torch.complex64)
        self.device = torch.device("cpu")


class _GeomStack:
    def __init__(self, size, n):
        self.size = int(size)
        self.n_real = self.n_total = int(n)

    def __len__(self):
        return self.n_total


class _GeomConfig:
    def __init__(self, xA):
        self.max_subgrid_size = int(xA)


class _GeomBase:
    """Duck-typed `_StreamedBase` (and forward, for `plan_margins`) for the
    port's streamed sizers."""

    def __init__(self, core, stack, config, real_facets):
        self.core = core
        self.stack = stack
        self.config = config
        self.mesh = None
        self._facets_real = bool(real_facets)


@dataclass(frozen=True)
class PlanInputs:
    """Everything the plan compiler needs to price one cover.

    Geometry is the cover's, not just the catalogue row's, so sparse and
    partial covers price what they run (`from_cover`). ``sparse_facets``
    (the port's addition) says the forward synthesises its facet slabs on
    the card, one slab deep, as `StreamedForward` does for sparse facets.
    """

    N: int
    yB: int                      # padded facet size
    yN: int
    xA: int                      # subgrid size
    xM: int
    n_facets: int
    n_columns: int               # distinct subgrid column offsets
    subgrids_per_column: int
    dtype_bytes: int = 4
    planar: bool = True
    real_facets: bool = False
    hbm_budget: float | None = None   # per-device bytes; None = unlimited
    n_devices: int = 1
    fold_group: int = 2
    max_batch: int = 64               # serve coalescing cap
    config_name: str | None = None
    sparse_facets: bool = False

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_config(cls, name, **overrides):
        """Inputs for a full cover of one catalogue config."""
        from ..models import SWIFT_CONFIGS

        params = SWIFT_CONFIGS[name]
        N, yB = params["N"], params["yB_size"]
        xA = params["xA_size"]
        n_side = -(-N // xA)
        return cls(
            N=N, yB=yB, yN=params["yN_size"], xA=xA,
            xM=params["xM_size"],
            n_facets=(-(-N // yB)) ** 2,
            n_columns=n_side, subgrids_per_column=n_side,
            config_name=name,
            **overrides,
        )

    @classmethod
    def from_cover(cls, config, facet_configs, subgrid_configs,
                   **overrides):
        """Inputs priced from an actual cover (sparse/partial included) of
        a port `SwiftlyConfig`."""
        core = config.core
        n_cols = len({sg.off0 for sg in subgrid_configs})
        planar = core.backend == "planar"
        return cls(
            N=config.image_size, yB=facet_configs[0].size,
            yN=core.yN_size, xA=subgrid_configs[0].size,
            xM=core.xM_size,
            n_facets=len(facet_configs), n_columns=n_cols,
            subgrids_per_column=len(subgrid_configs) // n_cols,
            dtype_bytes=torch.empty((), dtype=core.dtype).element_size(),
            planar=planar,
            **overrides,
        )

    def replace(self, **kw):
        return replace(self, **kw)

    # -- derived geometry ------------------------------------------------------

    @property
    def m(self):
        """Contribution rows per column (xM * yN / N)."""
        return self.xM * self.yN // self.N

    @property
    def per_el(self):
        """Bytes per grid element (planar keeps (re, im) planes)."""
        return self.dtype_bytes * (2 if self.planar else 1)

    @property
    def n_subgrids(self):
        return self.n_columns * self.subgrids_per_column

    @property
    def per_facet_acc_bytes(self):
        """One facet's whole [yB, yB] image accumulator."""
        return self.yB * self.yB * self.per_el

    @property
    def per_facet_row_bytes(self):
        """One facet's [m, yB] column-rows buffer."""
        return self.m * self.yB * self.per_el

    @property
    def stream_bytes(self):
        """The whole subgrid stream (what one spill fill persists)."""
        return self.n_subgrids * self.xA * self.xA * self.per_el

    @property
    def facet_stack_bytes(self):
        per = self.dtype_bytes if self.real_facets else self.per_el
        return self.n_facets * self.yB * self.yB * per

    def base(self):
        """Geometry shim the `parallel.streamed` sizers (and
        `plan.compiler.plan_margins`) accept."""
        return _GeomBase(
            _GeomCore(self.N, self.yN, self.xM, self.dtype_bytes,
                      self.planar),
            _GeomStack(self.yB, self.n_facets),
            _GeomConfig(self.xA),
            self.real_facets,
        )

    def inputs_hash(self):
        """Deterministic short hash of the pricing inputs (stamped into
        artifacts so two plans are comparable iff their hashes match)."""
        from ..obs.manifest import config_hash

        return config_hash(asdict(self))


# ---------------------------------------------------------------------------
# Serve batch shapes + admission byte projections
# ---------------------------------------------------------------------------


def bucket_shape(n):
    """Next power of two >= n: the serve dispatch-shape bucket (one
    definition; `serve.scheduler` delegates here)."""
    b = 1
    while b < n:
        b *= 2
    return b


def bucket_sizes(max_batch):
    """The distinct dispatch shapes bucket padding can produce under a
    ``max_batch`` cap: 1 (the single-request program) and every power
    of two up to the cap, with the cap itself as the largest shape."""
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(int(max_batch))
    return sizes


def _per_element_bytes(core):
    return torch.empty((), dtype=core.dtype).element_size() * (
        2 if core.backend == "planar" else 1
    )


def projected_request_bytes(config):
    """Projected device bytes of one finished subgrid: the admission
    queue's per-request cost."""
    return config.max_subgrid_size ** 2 * _per_element_bytes(config.core)


def projected_column_bytes(fwd):
    """Projected device bytes of one pending column's intermediates: the
    [F, m, yN] ``extract_columns_batch`` product the coalescing batcher
    materialises once per column program."""
    core = fwd.core
    return (
        len(fwd.stack) * core.xM_yN_size * core.yN_size
        * _per_element_bytes(core)
    )


# ---------------------------------------------------------------------------
# Stage pricing
# ---------------------------------------------------------------------------


@dataclass
class StageCost:
    """One stage's priced cost: FLOPs and/or bytes plus the wall the
    coefficients predict for it."""

    name: str
    flops: int = 0
    bytes_moved: int = 0
    dispatches: int = 0
    wall_s: float = 0.0

    def as_dict(self):
        out = {"wall_s": round(self.wall_s, 4)}
        if self.flops:
            out["flops"] = int(self.flops)
        if self.bytes_moved:
            out["bytes"] = int(self.bytes_moved)
        if self.dispatches:
            out["dispatches"] = int(self.dispatches)
        return out


# Default per-stage effective rates, each measured on this port's card (an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit; PERF.md gives every
# source) or the card's peak times a stated fraction. Coarse: they rank
# alternatives and give an order-of-magnitude wall; artifact blocks stamp
# ``coeffs_source: "default"``, and the compiler lets only calibrated
# coefficients (`plan.autotune`) change a plan parameter.
_H100_F32_PEAK = 67e12  # f32 FLOP/s without tensor cores (data sheet)
_DEFAULT_FLOPS_PER_S = {
    # the 32k streamed round trip's legs (chip_smoke.py phase 6): the
    # forward's 1.4951e14 FLOPs in 4.454 s, the backward's 2.3644e14 in
    # 5.600 s
    "fwd": 1.4951e14 / 4.454,
    "bwd": 2.3644e14 / 5.600,
    # the sampled facet pass's SGEMM, ~49 TFLOP/s (phase 9's profile)
    "fwd.sampled_facet_pass": 49e12,
    # B1 at 32k: 10.996 ms forward, 11.127 ms adjoint a launch, against
    # an 8.005 ms bound at the f32 peak (phase 7)
    "fwd.column_pass.kernel": _H100_F32_PEAK * 8.005 / 10.996,
    "bwd.column_pass.kernel": _H100_F32_PEAK * 8.005 / 11.127,
    # B2 at 32k: 6.668 ms a launch against a 4.762 ms bound (phase 7)
    "bwd.sampled_fold": _H100_F32_PEAK * 4.762 / 6.668,
    # visibility: B4's largest pump, 13977 lanes of 8 x 8 taps at 6 FLOPs
    # a tap in 0.0375 ms; `grid`'s largest, 3268 lanes at 8 FLOPs a tap
    # in 0.02528 ms (phase 7)
    "vis.degrid": 6 * 13977 * 8 * 8 / 0.0375e-3,
    "vis.grid": 8 * 3268 * 8 * 8 / 0.02528e-3,
}
_DEFAULT_BYTES_PER_S = {
    # chip_smoke.py phase 13's copy rates, 1 GiB best of 3: a pinned
    # host-to-card copy at 44.02 GB/s, and the host memcpy between pageable
    # and pinned memory at 19.14 GB/s, which bounds a cache read, the
    # recording's landing of its pinned chunks (the card-to-host copy ran
    # at 43.51 GB/s) and a hot-row copy
    "spill.h2d": 44.02e9,
    "spill.read": 19.14e9,
    "spill.write": 19.14e9,
    "cache.l1": 19.14e9,
    # the feed-once/fold-many feed: phase 11's cache-fed feeds, the
    # 8.792 GB stream in 3.8-3.9 s, three passes folded meanwhile
    "bwd.feed_group": 8.792e9 / 3.85,
    # half the 450 GB/s one-direction NVLink 4 peak of an H100 SXM: the
    # one card's virtual shards copy through its own memory, which says
    # nothing of the link between cards (no multi-card mesh measured)
    "mesh.psum": 0.5 * 450e9,
    "mesh.ring_step": 0.5 * 450e9,
}
# host cost of one kernel wrapper's call (B3's, 0.04-0.07 ms: phase 7)
_DEFAULT_DISPATCH_S = 7e-5

# Fraction of the ring collective's wire wall hidden behind compute. Not
# measured between cards, so none is assumed: the ring prices as the
# psum until a measured mesh.ring_step rate (the exposed wall) refits it.
RING_OVERLAP_DISCOUNT = 0.0


@dataclass
class CostCoefficients:
    """Per-stage throughput coefficients the wall model divides by.

    ``source`` records pedigree: ``"default"`` (the card's anchors above),
    ``"measured"`` (refit from raw artifact telemetry by
    `plan.autotune.refit`) or ``"ledger"`` (fit from the accumulated
    ``plan_accuracy`` calibration history by
    `plan.autotune.refit_from_ledger`). The compiler lets only calibrated
    coefficients (`calibrated`: measured or ledger) change plan
    parameters; defaults rank alternatives but the seed heuristics keep
    the choice.
    """

    flops_per_s: dict = field(default_factory=dict)
    bytes_per_s: dict = field(default_factory=dict)
    dispatch_s: float = _DEFAULT_DISPATCH_S
    source: str = "default"
    n_records: int = 0
    platform: str | None = None
    # measured-best kernel tile sizes from artifact history (the JAX
    # package's Pallas blocks); None until a record stamps them
    colpass_blocks: dict | None = None

    @property
    def calibrated(self):
        """Measurement-backed pedigree: what unlocks plan parameter
        selection in `compiler.compile_plan`."""
        return self.source in ("measured", "ledger")

    def flops_rate(self, stage):
        for key in (stage, stage.split(".")[0]):
            if key in self.flops_per_s:
                return self.flops_per_s[key]
            if key in _DEFAULT_FLOPS_PER_S:
                return _DEFAULT_FLOPS_PER_S[key]
        return _DEFAULT_FLOPS_PER_S["bwd"]

    def bytes_rate(self, stage):
        for key in (stage, stage.split(".")[0]):
            if key in self.bytes_per_s:
                return self.bytes_per_s[key]
            if key in _DEFAULT_BYTES_PER_S:
                return _DEFAULT_BYTES_PER_S[key]
        return _DEFAULT_BYTES_PER_S["spill.h2d"]

    def price(self, name, flops=0, bytes_moved=0, dispatches=0):
        wall = dispatches * self.dispatch_s
        if flops:
            wall += flops / self.flops_rate(name)
        if bytes_moved:
            wall += bytes_moved / self.bytes_rate(name)
        return StageCost(name, int(flops), int(bytes_moved),
                         int(dispatches), wall)


def _stage_name(prefix, colpass):
    """The priced stage of a column-pass body: B1 ("kernel") prices under
    its own name, every other body under the bare prefix."""
    return prefix + (".kernel" if colpass == "kernel" else "")


def price_forward(inputs, coeffs, colpass=None):
    """Stage costs of one streamed forward pass over the cover."""
    from ..utils.flops import (
        forward_sampled_flops,
        resolve_colpass,
        sampled_facet_pass_flops,
    )

    core = inputs.base().core
    if colpass is None:
        colpass = resolve_colpass(core, inputs.n_facets)
    total = forward_sampled_flops(
        core, n_facets=inputs.n_facets, facet_size=inputs.yB,
        n_columns=inputs.n_columns,
        subgrids_per_column=inputs.subgrids_per_column,
        subgrid_size=inputs.xA, real_facets=inputs.real_facets,
        colpass=colpass,
    )
    facet_pass = sampled_facet_pass_flops(
        core, inputs.n_facets, inputs.yB, inputs.n_columns * inputs.m,
        real_facets=inputs.real_facets,
    )
    return [
        coeffs.price("fwd.sampled_facet_pass", flops=facet_pass),
        coeffs.price(_stage_name("fwd.column_pass", colpass),
                     flops=total - facet_pass),
    ]


def price_colpass_candidates(inputs, coeffs):
    """Ranked forward column-pass candidates (einsum vs B1's kernel).

    Prices only the column-pass stage of each body (the facet pass is
    identical) with that body's exact FLOP shape and its own coefficient
    stage name, so a refit kernel coefficient prices the kernel row with
    measured pedigree while einsum keeps its own. Returns dicts sorted
    fastest-first; the executor's `resolve_colpass` keeps the choice.
    """
    from ..utils.flops import (
        forward_sampled_flops,
        sampled_facet_pass_flops,
    )

    core = inputs.base().core
    facet_pass = sampled_facet_pass_flops(
        core, inputs.n_facets, inputs.yB, inputs.n_columns * inputs.m,
        real_facets=inputs.real_facets,
    )
    out = []
    for colpass in ("einsum", "kernel"):
        total = forward_sampled_flops(
            core, n_facets=inputs.n_facets, facet_size=inputs.yB,
            n_columns=inputs.n_columns,
            subgrids_per_column=inputs.subgrids_per_column,
            subgrid_size=inputs.xA, real_facets=inputs.real_facets,
            colpass=colpass,
        )
        stage = _stage_name("fwd.column_pass", colpass)
        cost = coeffs.price(stage, flops=total - facet_pass)
        out.append({
            "colpass": colpass,
            "coeff_stage": stage,
            "flops": int(total - facet_pass),
            "flops_per_s": coeffs.flops_rate(stage),
            "predicted_wall_s": round(cost.wall_s, 4),
        })
    out.sort(key=lambda c: c["predicted_wall_s"])
    return out


def price_collective_stage(coeffs, collective, bytes_moved):
    """The planned facet-axis collective as one priced `StageCost`:
    ``psum`` at the ``mesh.psum`` rate, ``ring`` at the ``mesh.ring_step``
    rate less `RING_OVERLAP_DISCOUNT` while that rate is a default (a
    measured rate already is the exposed wall)."""
    stage = "mesh.ring_step" if collective == "ring" else "mesh.psum"
    cost = coeffs.price(stage, bytes_moved=bytes_moved)
    if collective == "ring" and stage not in coeffs.bytes_per_s:
        cost.wall_s *= 1.0 - RING_OVERLAP_DISCOUNT
    return cost


def price_collective_candidates(inputs, coeffs, mesh=None,
                                mode="roundtrip-streamed"):
    """Ranked facet-axis collective candidates (psum vs ring).

    Each schedule is priced over the same layout's collective bytes with
    its own coefficient stage as pedigree; the ring row carries the
    schedule shape (2(shards-1) steps of per-chunk bytes) and the overlap
    discount applied. Returns dicts sorted fastest-first; defaults only
    rank.
    """
    if mesh is None:
        from .compiler import plan_mesh_layout

        mesh = plan_mesh_layout(inputs, mode=mode)
    shards = int(mesh.facet_shards)
    total = int(mesh.collective_bytes_total)
    if shards <= 1 or not total:
        return []
    steps = 2 * (shards - 1)
    per_column = int(mesh.collective_bytes_per_column)
    out = []
    for collective in ("psum", "ring"):
        stage = "mesh.ring_step" if collective == "ring" else "mesh.psum"
        measured = stage in coeffs.bytes_per_s
        cost = price_collective_stage(coeffs, collective, total)
        out.append({
            "collective": collective,
            "coeff_stage": stage,
            "bytes": total,
            "steps": 1 if collective == "psum" else steps,
            "chunk_bytes": (
                per_column if collective == "psum"
                else per_column // max(1, steps * shards)
            ),
            "overlap_discount": (
                0.0 if collective == "psum" or measured
                else RING_OVERLAP_DISCOUNT
            ),
            "bytes_per_s": coeffs.bytes_rate(stage),
            "predicted_wall_s": round(cost.wall_s, 4),
        })
    out.sort(key=lambda c: c["predicted_wall_s"])
    return out


def price_backward(inputs, parts, fold_group, coeffs,
                   spill_fed=True, colpass=None, feed_group=1):
    """Stage costs of a facet x row-slab partitioned sampled backward.

    Every pass consumes the whole subgrid stream, but under the
    feed-once/fold-many schedule ``feed_group`` passes share each feed
    (`parallel.streamed.feed_backward_passes`), so the stream crosses the
    wire once per feed. With ``spill_fed`` the feeds after the first read
    the recorded stream back (the ``bwd.feed_group`` stage, priced by
    bytes); without a usable cache each later feed replays the forward.
    Fold FLOPs restrict with the pass's output-row slab.
    """
    from ..utils.flops import (
        bwd_column_pass_flops,
        bwd_fold_flops,
        resolve_colpass_bwd,
    )

    core = inputs.base().core
    if colpass is None:
        colpass = resolve_colpass_bwd(core, inputs.n_facets)
    col_flops = fold_flops = 0
    for i0, i1, r0, r1 in parts:
        F_pass = i1 - i0
        col_flops += inputs.n_columns * bwd_column_pass_flops(
            core, F_pass, inputs.subgrids_per_column, inputs.yB,
            inputs.xA, colpass,
        )
        fold_flops += int(
            bwd_fold_flops(core, F_pass, inputs.yB,
                           inputs.n_columns * inputs.m)
            * (r1 - r0) / inputs.yB
        )
    n_passes = len(parts)
    n_feeds = -(-n_passes // max(1, int(feed_group)))
    folds_per_pass = -(-inputs.n_columns // max(1, fold_group))
    stages = [
        coeffs.price(_stage_name("bwd.column_pass", colpass),
                     flops=col_flops, dispatches=n_passes * folds_per_pass),
        coeffs.price("bwd.sampled_fold", flops=fold_flops,
                     dispatches=n_passes * folds_per_pass),
    ]
    if spill_fed and n_feeds > 1:
        stages.append(
            coeffs.price("spill.write", bytes_moved=inputs.stream_bytes)
        )
        stages.append(
            coeffs.price("bwd.feed_group",
                         bytes_moved=(n_feeds - 1) * inputs.stream_bytes,
                         dispatches=n_feeds - 1)
        )
    elif n_feeds > 1:
        # replay cost model: feeds 2..n re-run the forward (aggregated
        # into one stage)
        replays = price_forward(inputs, coeffs)
        stages.append(
            StageCost(
                "fwd.replay",
                (n_feeds - 1) * sum(s.flops for s in replays),
                (n_feeds - 1) * sum(s.bytes_moved for s in replays),
                (n_feeds - 1) * sum(s.dispatches for s in replays),
                (n_feeds - 1) * sum(s.wall_s for s in replays),
            )
        )
    return stages
