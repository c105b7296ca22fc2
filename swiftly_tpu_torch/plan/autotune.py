"""Measured-feedback autotune: refit the cost model from run history.

The port of the JAX package's ``swiftly_tpu/plan/autotune.py``. A run's
artifact is provenance-stamped (manifest: device platform and kind, env,
config hash) and carries per-stage telemetry (``telemetry.stages[name]``
with ``total_s`` and the analytic ``flops`` / ``bytes`` the obs
instrumentation attributed). That history is a measured throughput
table:

    rate(stage) = sum(flops) / sum(total_s)          (compute stages)
    rate(stage) = sum(bytes) / sum(total_s)          (transfer stages)

`refit(history)` folds the matching records into `CostCoefficients` with
``source = "measured"``; `refit_from_ledger` does the same from the
plan-accuracy ledger's reconciled stages with ``source = "ledger"``.
Either unlocks parameter selection in `compiler.compile_plan`.

Records are skipped, not averaged, when they come from another platform
than the one fitted, and always when they come from a platform the port
does not run on (`PORT_PLATFORMS`): the repository's TPU artifacts never
calibrate the card. With no platform given, the first record stamped with
one of the port's platforms names it.
"""

from __future__ import annotations

import glob
import json
import logging
import math

from .model import CostCoefficients

__all__ = [
    "PORT_PLATFORMS",
    "ledger_readiness",
    "load_history",
    "refit",
    "refit_from_ledger",
]

logger = logging.getLogger(__name__)

# the manifest platforms a record of this port carries (`obs.manifest`):
# the card, or the CPU of the tests
PORT_PLATFORMS = ("gpu", "cpu")


def load_history(patterns):
    """BENCH records from artifact files (JSON record/list/JSONL or the
    round-ledger ``{"parsed": ...}`` shape), for `refit`.

    :param patterns: path/glob strings (or one string)
    """
    if isinstance(patterns, (str, bytes)):
        patterns = [patterns]
    records = []
    for pattern in patterns:
        for path in sorted(glob.glob(str(pattern))):
            try:
                text = open(path).read()
            except OSError as exc:
                logger.warning("history: cannot read %s: %s", path, exc)
                continue
            try:
                data = json.loads(text)
            except json.JSONDecodeError:
                try:
                    data = [
                        json.loads(line)
                        for line in text.splitlines()
                        if line.strip()
                    ]
                except json.JSONDecodeError:
                    logger.warning("history: %s is not JSON/JSONL", path)
                    continue
            if isinstance(data, dict) and "parsed" in data:
                data = data["parsed"]
            if isinstance(data, dict):
                data = [data]
            records.extend(r for r in data if isinstance(r, dict))
    return records


def _record_platform(record):
    manifest = record.get("manifest") or {}
    return (manifest.get("device") or {}).get("platform")


def _first_port_platform(platforms):
    """The first of `platforms` the port runs on (None if none is)."""
    return next((p for p in platforms if p in PORT_PLATFORMS), None)


def _foreign(plat, platform):
    """Whether a record stamped `plat` is left out of a fit for
    `platform`: another platform than the one fitted, or one the port
    does not run on (an unstamped record is kept)."""
    if not plat:
        return False
    return plat not in PORT_PLATFORMS or bool(platform and plat != platform)


def refit(history, platform=None, dispatch_s=None):
    """Fit per-stage throughput coefficients from artifact history.

    :param history: records (dicts) or paths/globs (`load_history`)
    :param platform: only fold in records stamped for this platform
        (default: the first record stamped with one of `PORT_PLATFORMS`;
        mixing a CPU smoke into a card's fit would poison every rate)
    :param dispatch_s: override the per-dispatch host cost (not
        derivable from stage telemetry)
    :return: `CostCoefficients` with ``source="measured"`` when at
        least one stage was fit, else the defaults (``"default"``)
    """
    if history and all(
        isinstance(h, (str, bytes)) for h in (
            history if isinstance(history, (list, tuple)) else [history]
        )
    ):
        history = load_history(history)
    elif isinstance(history, dict):
        history = [history]
    history = [r for r in (history or []) if isinstance(r, dict)]
    if platform is None:
        platform = _first_port_platform(
            _record_platform(rec) for rec in history)
    flops_acc = {}   # stage -> [flops, seconds]
    bytes_acc = {}   # stage -> [bytes, seconds]
    n_used = 0
    best_blocks = None  # fastest recorded kernel column-pass tile set
    best_block_rate = 0.0
    for rec in history:
        plat = _record_platform(rec)
        if _foreign(plat, platform):
            continue
        stages = (rec.get("telemetry") or {}).get("stages") or {}
        # learn the column pass's tile sizes: of the records that ran
        # B1 (colpass "kernel") and stamped their tiles, keep the tile set
        # of the record with the best measured column-stage rate
        plan = rec.get("plan") or {}
        blocks = plan.get("colpass_blocks")
        if plan.get("colpass") == "kernel" and isinstance(blocks, dict):
            for stage_name in ("fwd.column_pass", "fwd.slab_step"):
                entry = stages.get(stage_name) or {}
                total_s = entry.get("total_s") or 0.0
                if entry.get("flops") and total_s > 0:
                    rate = entry["flops"] / total_s
                    if rate > best_block_rate:
                        best_block_rate = rate
                        best_blocks = dict(blocks)
                    break
        used = False
        for name, entry in stages.items():
            total_s = entry.get("total_s") or 0.0
            if total_s <= 0:
                continue
            if entry.get("flops"):
                acc = flops_acc.setdefault(name, [0.0, 0.0])
                acc[0] += entry["flops"]
                acc[1] += total_s
                used = True
            if entry.get("bytes"):
                acc = bytes_acc.setdefault(name, [0.0, 0.0])
                acc[0] += entry["bytes"]
                acc[1] += total_s
                used = True
        # only flops/bytes stages fit: a stage with a wall but no
        # attribution says nothing about throughput
        if used:
            n_used += 1
    if not n_used:
        return CostCoefficients()
    coeffs = CostCoefficients(
        flops_per_s={
            name: acc[0] / acc[1] for name, acc in flops_acc.items()
        },
        bytes_per_s={
            name: acc[0] / acc[1] for name, acc in bytes_acc.items()
        },
        source="measured",
        n_records=n_used,
        platform=platform,
        colpass_blocks=best_blocks,
    )
    if dispatch_s is not None:
        coeffs.dispatch_s = float(dispatch_s)
    return coeffs


# ---------------------------------------------------------------------------
# Ledger-driven refit (obs.ledger plan_accuracy history)
# ---------------------------------------------------------------------------


def _ledger_entries(history):
    """``plan_accuracy`` blocks from mixed input: blocks, full BENCH
    records carrying one, or paths/globs (`load_history` shapes,
    including the ledger's own JSONL)."""
    from ..obs.ledger import PLAN_ACCURACY_SCHEMA

    if history and all(
        isinstance(h, (str, bytes)) for h in (
            history if isinstance(history, (list, tuple)) else [history]
        )
    ):
        history = load_history(history)
    elif isinstance(history, dict):
        history = [history]
    entries = []
    for rec in history or []:
        if not isinstance(rec, dict):
            continue
        block = rec
        if isinstance(rec.get("plan_accuracy"), dict):
            block = rec["plan_accuracy"]
        if block.get("schema") == PLAN_ACCURACY_SCHEMA:
            entries.append(block)
    return entries


def _ledger_stage_stats(entries):
    """Per-stage fit accumulators over ledger entries.

    Each covered stage contributes one throughput sample per entry:
    ``flops / measured_wall_s`` when the plan attributed FLOPs, else
    ``bytes / measured_wall_s`` (a stage priced by both would
    double-count one wall — prefer the compute rate, like `refit`'s
    pricing the other way around). Returns
    ``{stage: {"kind", "n", "sum_units", "sum_s", "rates"}}``.
    """
    stats = {}
    for entry in entries:
        for name, stage in (entry.get("stages") or {}).items():
            if not isinstance(stage, dict):
                continue
            meas = stage.get("measured_wall_s")
            if not isinstance(meas, (int, float)) or meas <= 0:
                continue
            if stage.get("flops"):
                kind, units = "flops", float(stage["flops"])
            elif stage.get("bytes"):
                kind, units = "bytes", float(stage["bytes"])
            else:
                continue
            acc = stats.setdefault(
                name,
                {"kind": kind, "n": 0, "sum_units": 0.0, "sum_s": 0.0,
                 "rates": []},
            )
            if acc["kind"] != kind:
                continue  # mixed attribution across entries: keep first
            acc["n"] += 1
            acc["sum_units"] += units
            acc["sum_s"] += float(meas)
            acc["rates"].append(units / float(meas))
    return stats


def ledger_readiness(history, platform=None, min_samples=2,
                     max_rel_spread=0.5):
    """Is the accumulated calibration history good enough to refit?

    Three gates per stage, all from the ledger alone: enough samples
    (``min_samples``), the right platform (entries from another
    platform are skipped, not averaged — same rule as `refit`), and
    low variance (relative std of the per-entry throughput samples at
    most ``max_rel_spread`` — a stage whose measured rate swings 2x
    between runs would fit a coefficient that misprices every run).
    Entries of a platform the port does not run on never count.

    :return: ``{"ready", "platform", "n_records", "stages": {name:
        {"kind", "n", "rate", "rel_spread", "ready"}}, "reasons"}`` —
        ``ready`` is True when at least one stage passes every gate
    """
    entries = _ledger_entries(history)
    if platform is None:
        platform = _first_port_platform(e.get("platform") for e in entries)
    matched = [e for e in entries if not _foreign(e.get("platform"), platform)]
    stats = _ledger_stage_stats(matched)
    stages = {}
    for name in sorted(stats):
        acc = stats[name]
        rates = acc["rates"]
        mean = sum(rates) / len(rates)
        rel = None
        if len(rates) > 1 and mean > 0:
            var = sum((r - mean) ** 2 for r in rates) / len(rates)
            rel = math.sqrt(var) / mean
        ok = (
            acc["n"] >= int(min_samples)
            and rel is not None and rel <= float(max_rel_spread)
            and acc["sum_s"] > 0
        )
        stages[name] = {
            "kind": acc["kind"],
            "n": acc["n"],
            "rate": acc["sum_units"] / acc["sum_s"],
            "rel_spread": None if rel is None else round(rel, 4),
            "ready": ok,
        }
    ready = any(s["ready"] for s in stages.values())
    reasons = []
    if not entries:
        reasons.append("no plan_accuracy entries in history")
    elif not matched:
        reasons.append(f"no entries for platform {platform!r}")
    elif not stats:
        reasons.append("no covered stages with flops/bytes attribution")
    elif not ready:
        reasons.append(
            f"no stage has >= {min_samples} samples with relative "
            f"spread <= {max_rel_spread}"
        )
    return {
        "ready": ready,
        "platform": platform,
        "n_records": len(matched),
        "min_samples": int(min_samples),
        "max_rel_spread": float(max_rel_spread),
        "stages": stages,
        "reasons": reasons,
    }


def refit_from_ledger(history, platform=None, min_samples=2,
                      max_rel_spread=0.5, dispatch_s=None):
    """Fit coefficients from accumulated ``plan_accuracy`` history.

    The ledger-driven twin of `refit`: instead of raw telemetry this
    reads the reconciled per-stage records the ledger stamped
    (`obs.ledger.plan_accuracy_block` / the JSONL calibration history),
    so ONLY stages that passed the `ledger_readiness` gates are fit —
    ``rate = Σ units / Σ measured_wall_s`` over the matched entries.
    The result carries ``source="ledger"`` provenance, which the plan
    compiler accepts as calibrated exactly like ``"measured"``
    (`CostCoefficients.calibrated`): a run on the card refits the next
    plan from its own artifacts.

    :param history: ``plan_accuracy`` blocks, records carrying one, or
        paths/globs of the JSONL calibration history
    :return: `CostCoefficients` with ``source="ledger"`` when at least
        one stage was ready, else the defaults (``"default"``)
    """
    readiness = ledger_readiness(
        history, platform=platform, min_samples=min_samples,
        max_rel_spread=max_rel_spread,
    )
    if not readiness["ready"]:
        logger.info(
            "ledger refit not ready: %s", "; ".join(readiness["reasons"])
        )
        return CostCoefficients()
    flops_per_s = {}
    bytes_per_s = {}
    for name, stage in readiness["stages"].items():
        if not stage["ready"]:
            continue
        target = flops_per_s if stage["kind"] == "flops" else bytes_per_s
        target[name] = stage["rate"]
    coeffs = CostCoefficients(
        flops_per_s=flops_per_s,
        bytes_per_s=bytes_per_s,
        source="ledger",
        n_records=readiness["n_records"],
        platform=readiness["platform"],
    )
    if dispatch_s is not None:
        coeffs.dispatch_s = float(dispatch_s)
    return coeffs
