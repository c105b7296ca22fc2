"""Plan-accuracy ledger: per-stage predicted-vs-measured reconciliation.

The port of the JAX package's ``swiftly_tpu/obs/ledger.py``. The plan
compiler prices every stage of a run (``plan.predicted.stages``) and the
metrics registry times the matching runtime stages; this module joins
the two, stage by stage, so a run answers "where was the model wrong,
and by how much?" from its artifacts alone:

* **The stage-name mapping.** `PLAN_STAGE_TIMERS` names, for every
  plan-priced stage, the runtime timer(s) whose measured wall is its
  counterpart; `EXEMPT_STAGE_TIMERS` lists every runtime timer that is
  deliberately outside the priced model, each with its reason. The
  contract is total: a timer in neither table is drift
  (`unmapped_stage_names`; the port's tests scan its own stage sites).
  The port's kernel bodies price under their own names: B1 as
  ``fwd.column_pass.kernel`` / ``bwd.column_pass.kernel`` (the JAX
  package's ``.pallas`` keys), timed by the same ``fwd.column_pass`` /
  ``fwd.slab_step`` / ``bwd.column_pass`` timers.
* **The ``plan_accuracy`` artifact block.** `plan_accuracy_block` joins
  a stamped ``plan_compiled`` block against the run's ``telemetry``
  export: per-stage predicted/measured walls and their ratio
  (predicted / measured: > 1 means the plan over-predicted), the
  coverage fraction of predicted stage wall that has a measured
  counterpart, and the uncovered stages by name. On the card a stage
  timer's host wall is launch-side (CUDA is asynchronous); where the
  export carries a stage's device time (``device_s``, CUDA events at
  the stage's ends), the join reads that instead. Every block appends to
  a JSONL calibration history (`append_history`) keyed by inputs hash,
  geometry, platform and git SHA; `plan.autotune.refit_from_ledger`
  refits per-stage coefficients from it with ``source="ledger"``.
* **The drift alarm.** `register_plan_accuracy_source` wires the latest
  block into an `obs.tower.ControlTower` as a ``plan_accuracy`` source
  plus a ``plan.mispricing_drift`` signal with a burn-rate SLO;
  `record_mispricing` lands ``plan.mispriced`` flight-recorder events
  (and a post-mortem dump) when a calibrated stage misprices beyond a
  threshold. Default-coefficient blocks are reported, never alarmed.
"""

from __future__ import annotations

import glob as _glob
import json
import logging
import math
import os
import time

__all__ = [
    "CALIBRATED_SOURCES",
    "EXEMPT_STAGE_TIMERS",
    "PLAN_ACCURACY_SCHEMA",
    "PLAN_STAGE_TIMERS",
    "append_history",
    "history_path",
    "load_calibration_history",
    "mapped_timer_names",
    "mispriced_stages",
    "mispricing_drift",
    "plan_accuracy_block",
    "record_mispricing",
    "register_plan_accuracy_source",
    "round_sig",
    "stage_accuracy",
    "unmapped_stage_names",
    "validate_plan_accuracy_artifact",
]

logger = logging.getLogger(__name__)

PLAN_ACCURACY_SCHEMA = "swiftly-tpu-plan-accuracy/1"

# Coefficient pedigrees that make a prediction a CONTRACT rather than a
# ranking anchor: "measured" (plan.autotune.refit over raw telemetry)
# and "ledger" (refit_from_ledger over accumulated plan_accuracy
# history). Only calibrated blocks can alarm.
CALIBRATED_SOURCES = ("measured", "ledger")

# Every plan-priced stage name -> the runtime timer(s) whose measured
# wall is its counterpart. A priced stage may fan out to several timers
# (the executor picks a body per geometry: the grouped column pass
# records ``fwd.column_pass``, the facet-slab streaming path records
# ``fwd.slab_step`` — both are the SAME priced work); the join sums
# whichever of them fired. Keys must cover everything
# `plan.model.price_forward` / `price_backward` / the compiler's
# ``mesh.psum`` pricing can emit (the port's tests compile plans and
# assert it). The ``mesh.*`` timers are the mesh's collectives
# (`parallel.sharded.collective_sum`).
PLAN_STAGE_TIMERS = {
    "fwd.sampled_facet_pass": ("fwd.sampled_facet_pass", "fwd.facet_pass"),
    "fwd.column_pass": ("fwd.column_pass", "fwd.slab_step"),
    "fwd.column_pass.kernel": ("fwd.column_pass", "fwd.slab_step"),
    "bwd.column_pass": ("bwd.column_pass",),
    "bwd.column_pass.kernel": ("bwd.column_pass",),
    "bwd.sampled_fold": ("bwd.sampled_fold",),
    "spill.write": ("spill.write",),
    "bwd.feed_group": ("bwd.feed_group",),
    "fwd.replay": ("fwd.replay",),
    "mesh.psum": ("mesh.psum",),
    "mesh.ring_step": ("mesh.ring_step",),
    # visibility serving (plan.vis.price_vis): every stage records
    # under its priced name (the row fetch's hit/miss tier split is
    # blended into one priced wall at the expected hit rate)
    "vis.degrid": ("vis.degrid",),
    "vis.grid": ("vis.grid",),
    "vis.row_fetch": ("vis.row_fetch",),
}

# Runtime timers deliberately OUTSIDE the priced model, each with its
# reason — the other half of the total-mapping contract. Anything the
# engine times that is in neither table is drift and fails the guard.
EXEMPT_STAGE_TIMERS = {
    "fwd.h2d": "facet upload inside the column pass's overlap window; "
               "priced into the stage's effective rate, not separately",
    "fwd.d2h": "subgrid drain hidden behind compute by the double "
               "buffer; part of the column stage's effective rate",
    "fwd.drain": "end-of-stream flush of in-flight buffers (bounded "
                 "tail, not steady-state work)",
    "fwd.facet_upload": "one-time facet-stack upload (setup, amortized "
                        "over the whole run)",
    "fwd.slab_prefetch": "async slab h2d the slab compute hides; the "
                         "exposed part surfaces in fwd.slab_step",
    "fwd.slab_upload": "synchronous slab upload fallback (setup path)",
    "fwd.group_finish": "column-group boundary bookkeeping",
    "spill.read": "cache read the feed prefetch hides; the exposed "
                  "feed wall is priced as bwd.feed_group",
    "spill.h2d": "cache h2d dispatch inside the feed's overlap window; "
                 "priced as bwd.feed_group traffic",
    "bwd.drain": "backward end-of-stream flush (bounded tail)",
    "bwd.ct_fold": "sub-stage of the priced backward column pass; "
                   "mapping it too would double-count the wall",
    "bwd.fft_fold": "sub-stage of the priced adjoint fold (fft "
                    "residency variant); same double-count hazard",
    "bwd.finish": "final per-facet finish, paid once per pass outside "
                  "the steady-state price",
    "bwd.facet_pass": "legacy full-residency backward body (not the "
                      "sampled path the plan prices)",
    "bwd.d2h": "result download after the fold (bounded tail)",
    "fwd.prepare_facets": "the fused (batched) API path's facet "
                          "preparation; the plan prices the streamed modes",
    "fwd.fused_forward": "the fused (batched) API forward, outside the "
                         "streamed modes the plan prices",
    "bwd.fused_backward": "the fused (batched) API backward, outside the "
                          "streamed modes the plan prices",
    "spill.disk_read": "disk-tier sub-stage of a cache read; the exposed "
                       "feed wall is priced as bwd.feed_group",
    "spill.disk_write": "disk-tier sub-stage of the recording; priced "
                        "inside spill.write",
    "ckpt.save": "snapshot IO of the resilience layer, outside the priced "
                 "steady state",
    "ckpt.restore": "snapshot IO of the resilience layer, outside the "
                    "priced steady state",
    "vis.request": "a served request's submit-to-completion latency (the "
                   "SLO's metric), not a stage of work",
    "serve.request": "a served subgrid request's submit-to-completion "
                     "latency (the SLO's metric), not a stage of work",
    "serve.cache_feed": "one recorded-row read of the serving path, "
                        "outside the streamed modes the plan prices",
    "serve.batch": "one coalesced compute dispatch of the serving path "
                   "(the fused API's column program), outside the "
                   "streamed modes the plan prices",
    "delta.d2h": "the delta pass's correction copy; plan.plan_delta "
                 "prices the update as a whole, not per stage",
    "spill.patch": "the cache patch of an incremental update; "
                   "plan.plan_delta prices the update as a whole",
}


def mapped_timer_names():
    """Every runtime timer name some plan-priced stage claims."""
    names = set()
    for timers in PLAN_STAGE_TIMERS.values():
        names.update(timers)
    return names


def unmapped_stage_names(names):
    """The runtime timer names in ``names`` that are neither mapped to
    a plan-priced stage nor on the documented exemption list — i.e.
    ledger drift. The stage-contract guard asserts this is empty over
    every ``_metrics.stage``/``observe`` site of the port."""
    known = mapped_timer_names() | set(EXEMPT_STAGE_TIMERS)
    return sorted(set(names) - known)


def round_sig(value, sig=4):
    """Round to ``sig`` significant figures (NOT decimal places).

    ``round(x, 4)`` zeroed sub-0.1 ms walls — a smoke leg's 3.2e-5 s
    stage became 0.0 and every downstream ratio silently vanished.
    Sig-fig rounding keeps small walls comparable at any scale."""
    v = float(value)
    if v == 0.0 or not math.isfinite(v):
        return v
    return round(v, int(sig) - 1 - int(math.floor(math.log10(abs(v)))))


# ---------------------------------------------------------------------------
# The join
# ---------------------------------------------------------------------------


def _measured_wall(entry):
    """A stage's measured wall in a ``metrics.export()`` entry: its device
    time (``device_s``) where the registry timed one, else its host wall
    (``total_s``); 0.0 for anything else."""
    if not isinstance(entry, dict):
        return 0.0
    dev = entry.get("device_s")
    if isinstance(dev, (int, float)) and dev > 0:
        return float(dev)
    return float(entry.get("total_s") or 0.0)


def stage_accuracy(plan_block, telemetry):
    """Join one plan's predicted stage walls against measured timers.

    :param plan_block: a stamped ``plan_compiled`` artifact block
    :param telemetry: the leg's ``metrics.export()`` block
    :return: ``(stages, uncovered, totals)`` — per-plan-stage entries
        (predicted/measured walls, ``ratio = predicted / measured``,
        the timers joined, the analytic flops/bytes the refit divides),
        the priced stages with NO measured counterpart, and the wall
        totals the coverage fraction is computed from
    """
    predicted = ((plan_block or {}).get("predicted") or {}).get(
        "stages"
    ) or {}
    measured = (telemetry or {}).get("stages") or {}
    stages = {}
    uncovered = []
    total_pred = covered_pred = total_meas = 0.0
    for name, cost in predicted.items():
        cost = cost if isinstance(cost, dict) else {}
        pred_wall = float(cost.get("wall_s") or 0.0)
        timers = PLAN_STAGE_TIMERS.get(name)
        entry = {
            "predicted_wall_s": round_sig(pred_wall),
            "timers": list(timers) if timers else [],
        }
        if timers is None:
            entry["unmapped"] = True
        for key in ("flops", "bytes", "dispatches"):
            if cost.get(key):
                entry[key] = cost[key]
        meas_wall = 0.0
        count = 0
        fired = []
        for timer in timers or ():
            m = measured.get(timer)
            wall = _measured_wall(m)
            if wall > 0:
                meas_wall += wall
                count += int(m.get("count") or 0)
                fired.append(timer)
        total_pred += pred_wall
        if meas_wall > 0:
            entry["measured_wall_s"] = round_sig(meas_wall)
            entry["measured_timers"] = fired
            entry["count"] = count
            covered_pred += pred_wall
            total_meas += meas_wall
            if pred_wall > 0:
                entry["ratio"] = round_sig(pred_wall / meas_wall)
        else:
            uncovered.append(name)
        stages[name] = entry
    totals = {
        "predicted_stage_wall_s": round_sig(total_pred),
        "measured_stage_wall_s": round_sig(total_meas),
        "coverage": round(
            covered_pred / total_pred if total_pred > 0 else 0.0, 4
        ),
    }
    return stages, uncovered, totals


def plan_accuracy_block(plan_block, telemetry, manifest=None):
    """The validated ``plan_accuracy`` artifact block one run stamps.

    Keyed for the calibration history: inputs-hash + config (geometry
    identity), platform + git SHA (provenance), coefficient pedigree.
    ``stages[*].ratio`` is predicted / measured — > 1 is an
    OVER-prediction (the run beat the price), < 1 an optimistic plan.
    """
    plan_block = plan_block or {}
    manifest = manifest or {}
    stages, uncovered, totals = stage_accuracy(plan_block, telemetry)
    return {
        "schema": PLAN_ACCURACY_SCHEMA,
        "t_epoch": round(time.time(), 3),
        "inputs_hash": plan_block.get("inputs_hash"),
        "config": plan_block.get("config"),
        "mode": plan_block.get("mode"),
        "coeffs_source": plan_block.get("coeffs_source") or "default",
        "platform": (manifest.get("device") or {}).get("platform"),
        "git_sha": manifest.get("git_sha"),
        "stages": stages,
        "uncovered": uncovered,
        **totals,
    }


def validate_plan_accuracy_artifact(record):
    """Problems with an artifact's ``plan_accuracy`` block, as strings.

    Accepts the full BENCH record (reads ``record["plan_accuracy"]``)
    or a bare block. The no-silent-gaps rule is schema: every priced
    stage without a measured wall MUST be listed in ``uncovered``,
    coverage must be a [0, 1] fraction, and a measured stage with a
    positive prediction must carry its ratio.
    """
    block = record
    if isinstance(record, dict) and "plan_accuracy" in record:
        block = record.get("plan_accuracy")
    if not isinstance(block, dict):
        return ["missing plan_accuracy block"]
    problems = []
    if block.get("schema") != PLAN_ACCURACY_SCHEMA:
        problems.append(
            f"plan_accuracy schema {block.get('schema')!r} != "
            f"{PLAN_ACCURACY_SCHEMA!r}"
        )
    for field in ("inputs_hash", "mode", "coeffs_source"):
        if not block.get(field):
            problems.append(f"plan_accuracy missing {field!r}")
    if block.get("coeffs_source") not in (
        None, "default", *CALIBRATED_SOURCES
    ):
        problems.append(
            f"plan_accuracy coeffs_source {block.get('coeffs_source')!r}"
            " not default|measured|ledger"
        )
    coverage = block.get("coverage")
    if not isinstance(coverage, (int, float)) or not (
        0.0 <= coverage <= 1.0
    ):
        problems.append(
            f"plan_accuracy coverage {coverage!r} is not a [0, 1] "
            "fraction"
        )
    stages = block.get("stages")
    uncovered = block.get("uncovered")
    if not isinstance(uncovered, list):
        problems.append("plan_accuracy uncovered is not a list")
        uncovered = []
    if not isinstance(stages, dict) or not stages:
        problems.append("plan_accuracy stages is not a non-empty dict")
        return problems
    for name, entry in stages.items():
        if not isinstance(entry, dict):
            problems.append(f"plan_accuracy stage {name} is not a dict")
            continue
        pred = entry.get("predicted_wall_s")
        if not isinstance(pred, (int, float)) or pred < 0:
            problems.append(
                f"plan_accuracy stage {name} predicted_wall_s {pred!r} "
                "is not a non-negative number"
            )
        meas = entry.get("measured_wall_s")
        if meas is None:
            if name not in uncovered:
                problems.append(
                    f"plan_accuracy stage {name} has no measured wall "
                    "but is not listed uncovered (silent gap)"
                )
            continue
        if not isinstance(meas, (int, float)) or meas <= 0:
            problems.append(
                f"plan_accuracy stage {name} measured_wall_s {meas!r} "
                "is not a positive number"
            )
        elif (
            isinstance(pred, (int, float)) and pred > 0
            and not isinstance(entry.get("ratio"), (int, float))
        ):
            problems.append(
                f"plan_accuracy stage {name} has both walls but no "
                "ratio"
            )
        if name in uncovered:
            problems.append(
                f"plan_accuracy stage {name} is measured AND listed "
                "uncovered"
            )
    for name in uncovered:
        if name not in stages:
            problems.append(
                f"plan_accuracy uncovered stage {name} not in stages"
            )
    return problems


# ---------------------------------------------------------------------------
# Calibration history (JSONL)
# ---------------------------------------------------------------------------

DEFAULT_HISTORY_PATH = "BENCH_calibration.jsonl"


def history_path(default=DEFAULT_HISTORY_PATH):
    """Where the calibration history accumulates:
    ``SWIFTLY_CALIBRATION_HISTORY`` (``0`` disables → None), else
    ``BENCH_calibration.jsonl`` next to the other artifacts."""
    env = os.environ.get("SWIFTLY_CALIBRATION_HISTORY")
    if env == "0":
        return None
    return env or default


def append_history(block, path=None):
    """Append one ``plan_accuracy`` block to the JSONL history; returns
    the path written (None when history is disabled)."""
    path = history_path() if path is None else path
    if not path:
        return None
    with open(path, "a") as fh:
        fh.write(json.dumps(block, sort_keys=True) + "\n")
    return path


def load_calibration_history(patterns=None):
    """Every ``plan_accuracy`` block from JSONL history file(s).

    :param patterns: path/glob strings (or one string); default the
        `history_path` file
    """
    if patterns is None:
        patterns = [history_path() or DEFAULT_HISTORY_PATH]
    if isinstance(patterns, (str, bytes)):
        patterns = [patterns]
    blocks = []
    for pattern in patterns:
        for path in sorted(_glob.glob(str(pattern))):
            try:
                text = open(path).read()
            except OSError as exc:
                logger.warning("ledger: cannot read %s: %s", path, exc)
                continue
            for line in text.splitlines():
                if not line.strip():
                    continue
                try:
                    data = json.loads(line)
                except json.JSONDecodeError:
                    logger.warning("ledger: bad JSONL line in %s", path)
                    continue
                if (
                    isinstance(data, dict)
                    and data.get("schema") == PLAN_ACCURACY_SCHEMA
                ):
                    blocks.append(data)
    return blocks


# ---------------------------------------------------------------------------
# Drift signal, tower source, flight-recorder hook
# ---------------------------------------------------------------------------


def mispriced_stages(block, threshold=2.0):
    """``[(stage, ratio), ...]`` whose predicted/measured ratio leaves
    ``[1/threshold, threshold]`` — regardless of pedigree (callers gate
    on `CALIBRATED_SOURCES` where only contracts may alarm)."""
    out = []
    for name, entry in ((block or {}).get("stages") or {}).items():
        ratio = entry.get("ratio") if isinstance(entry, dict) else None
        if (
            isinstance(ratio, (int, float)) and ratio > 0
            and not (1.0 / threshold <= ratio <= threshold)
        ):
            out.append((name, ratio))
    return out


def mispricing_drift(block):
    """The worst per-stage mispricing factor, symmetric in direction:
    ``max over stages of max(ratio, 1/ratio)`` — 1.0 is a perfect
    price, 2.0 means some stage is off 2x either way. 1.0 with no
    joined stages (nothing to misprice yet)."""
    worst = 1.0
    for name, entry in ((block or {}).get("stages") or {}).items():
        ratio = entry.get("ratio") if isinstance(entry, dict) else None
        if isinstance(ratio, (int, float)) and ratio > 0:
            worst = max(worst, ratio, 1.0 / ratio)
    return worst


def register_plan_accuracy_source(tower, provider, threshold=2.0,
                                  fast_s=1.0, slow_s=5.0, burn=0.5):
    """Wire the ledger into a control tower.

    Registers a ``plan_accuracy`` source (coverage, pedigree, drift and
    the stage counters the fleet totals sum), a
    ``plan.mispricing_drift`` signal (the `mispricing_drift` factor of
    the CURRENT block — pinned to 1.0 for uncalibrated blocks, which
    must never alarm), and a ``plan_mispricing`` burn-rate SLO at
    ``threshold``.

    :param tower: an `obs.tower.ControlTower`
    :param provider: callable returning the latest ``plan_accuracy``
        block (or None before the first run)
    """
    from .tower import SLO

    def _block():
        try:
            return provider() or {}
        except Exception:  # noqa: BLE001 - a source must not kill ticks
            return {}

    def source():
        block = _block()
        stages = block.get("stages") or {}
        uncovered = block.get("uncovered") or []
        bad = mispriced_stages(block, threshold)
        return {
            "coeffs_source": block.get("coeffs_source"),
            "calibrated": (
                block.get("coeffs_source") in CALIBRATED_SOURCES
            ),
            "coverage": block.get("coverage"),
            "mispricing_drift": round(mispricing_drift(block), 4),
            "mispriced": [name for name, _r in bad],
            "counters": {
                "plan.stages_priced": len(stages),
                "plan.stages_covered": len(stages) - len(uncovered),
                "plan.stages_mispriced": len(bad),
            },
        }

    def signal():
        block = _block()
        if block.get("coeffs_source") not in CALIBRATED_SOURCES:
            return 1.0
        return mispricing_drift(block)

    tower.register_source("plan_accuracy", source, kind="plan")
    tower.register_signal("plan.mispricing_drift", signal)
    tower.add_slo(SLO(
        name="plan_mispricing", signal="plan.mispricing_drift",
        threshold=float(threshold), direction="above",
        fast_s=fast_s, slow_s=slow_s, burn=burn,
    ))


def record_mispricing(block, threshold=2.0, dump_path=None):
    """Flight-recorder trail for a mispriced CALIBRATED block.

    One ``plan.mispriced`` event per offending stage, plus a
    post-mortem bundle dump when ``dump_path`` is given. Uncalibrated
    blocks return ``[]`` untouched — a default-coefficient miss is a
    ranking anchor being wrong, not a broken contract.

    :return: the `mispriced_stages` list that was recorded
    """
    block = block or {}
    if block.get("coeffs_source") not in CALIBRATED_SOURCES:
        return []
    bad = mispriced_stages(block, threshold)
    if not bad:
        return []
    from . import recorder as _recorder

    for name, ratio in bad:
        _recorder.record(
            "plan", "plan.mispriced",
            f"{name} predicted/measured x{ratio:.3g} outside "
            f"[1/{threshold:g}, {threshold:g}] "
            f"({block.get('config')}, {block.get('coeffs_source')} "
            "coeffs)",
        )
    if dump_path:
        _recorder.dump(
            dump_path, trigger="PlanMispriced",
            reason=(
                f"{len(bad)} calibrated stage(s) mispriced beyond "
                f"x{threshold:g}: "
                + ", ".join(name for name, _r in bad)
            ),
        )
    return bad
