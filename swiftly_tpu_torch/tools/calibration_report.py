"""Calibration report over the plan-accuracy ledger: per-stage
predicted-vs-measured drift, history, and refit readiness, in one read.

The port's twin of the JAX package's ``scripts/calibration_report.py``:
the same flags, output and exit codes, over the port's own ledger
(`swiftly_tpu_torch.obs.ledger`) and plan (`swiftly_tpu_torch.plan`).

Every bench/drill leg since the plan-accuracy ledger stamps a
``plan_accuracy`` block (obs.ledger) and appends it to a persisted
JSONL calibration history. This script is the operator's read of that
history before the first real TPU session (the ROADMAP re-anchor's
"re-run matrix → check coverage → refit → refresh sentinels" runbook,
docs/planning.md Calibration):

* **latest block** — per-stage predicted/measured walls and the ratio
  (predicted / measured; > 1 = plan over-predicted, < 1 = plan
  optimistic), coverage of the plan-priced stage wall, the uncovered
  stages by name, and any stage mispriced beyond ``--threshold``;
* **history** — entries accumulated per (platform, config), so drift
  ACROSS runs is visible, not just the last run's snapshot;
* **refit readiness** — `plan.autotune.ledger_readiness`: per stage,
  enough samples / right platform / low variance, and whether
  `refit_from_ledger` would produce usable ``source="ledger"``
  coefficients right now (``--refit`` prints the fitted rates).

Usage:
    python -m swiftly_tpu_torch.tools.calibration_report
        [BENCH_calibration.jsonl ...]
        [--artifact BENCH_smoke.json] [--platform cpu]
        [--threshold 2.0] [--min-samples 2] [--max-rel-spread 0.5]
        [--refit] [--json]

Exit: 0 ok, 1 a calibrated stage is mispriced beyond ``--threshold``
or a stamped block fails validation, 2 bad input.
"""

import argparse
import json
import sys

from ..obs import ledger as oledger
from ..plan import ledger_readiness, refit_from_ledger


def summarize(entries, latest=None, platform=None, threshold=2.0,
              min_samples=2, max_rel_spread=0.5, refit=False):
    """The JSON-ready calibration summary (what ``--json`` prints)."""
    latest = latest or (entries[-1] if entries else None)
    out = {
        "n_entries": len(entries),
        "threshold": threshold,
        "problems": [],
    }
    by_key = {}
    for e in entries:
        key = f"{e.get('platform') or '?'}/{e.get('config') or '?'}"
        by_key[key] = by_key.get(key, 0) + 1
    out["history"] = by_key
    if latest is not None:
        out["problems"].extend(
            oledger.validate_plan_accuracy_artifact(latest)
        )
        bad = oledger.mispriced_stages(latest, threshold)
        calibrated = (
            latest.get("coeffs_source") in oledger.CALIBRATED_SOURCES
        )
        out["latest"] = {
            "config": latest.get("config"),
            "mode": latest.get("mode"),
            "platform": latest.get("platform"),
            "git_sha": latest.get("git_sha"),
            "coeffs_source": latest.get("coeffs_source"),
            "calibrated": calibrated,
            "coverage": latest.get("coverage"),
            "uncovered": latest.get("uncovered"),
            "stages": latest.get("stages"),
            "mispricing_drift": round(
                oledger.mispricing_drift(latest), 4
            ),
            "mispriced_stages": [
                {"stage": n, "ratio": r} for n, r in bad
            ],
        }
        if calibrated and bad:
            out["problems"].append(
                f"{len(bad)} calibrated stage(s) mispriced beyond "
                f"x{threshold:g}: "
                + ", ".join(n for n, _r in bad)
            )
    out["readiness"] = ledger_readiness(
        entries, platform=platform, min_samples=min_samples,
        max_rel_spread=max_rel_spread,
    )
    if refit:
        coeffs = refit_from_ledger(
            entries, platform=platform, min_samples=min_samples,
            max_rel_spread=max_rel_spread,
        )
        out["refit"] = {
            "source": coeffs.source,
            "platform": coeffs.platform,
            "n_records": coeffs.n_records,
            "flops_per_s": coeffs.flops_per_s,
            "bytes_per_s": coeffs.bytes_per_s,
        }
    return out


def _render(summary):
    lines = [
        f"calibration ledger: {summary['n_entries']} entr"
        f"{'y' if summary['n_entries'] == 1 else 'ies'}"
    ]
    for key in sorted(summary.get("history") or {}):
        lines.append(f"  {key:<28} {summary['history'][key]} run(s)")
    latest = summary.get("latest")
    if latest:
        lines.append(
            f"latest: {latest['config']} ({latest['mode']}, "
            f"{latest['platform']}, {latest['coeffs_source']} coeffs"
            f"{'' if latest['calibrated'] else ' — never alarmed'})"
        )
        cov = latest.get("coverage")
        lines.append(
            "  coverage "
            + (f"{cov:.0%}" if isinstance(cov, (int, float)) else "?")
            + " of plan-priced stage wall"
            + (
                f"; uncovered: {', '.join(latest['uncovered'])}"
                if latest.get("uncovered")
                else ""
            )
        )
        lines.append(
            "  ratio = predicted/measured (>1 = plan over-predicted, "
            "<1 = plan optimistic); worst drift "
            f"x{latest['mispricing_drift']}"
        )
        for name in sorted(latest.get("stages") or {}):
            entry = latest["stages"][name]
            meas = entry.get("measured_wall_s")
            lines.append(
                f"    {name:<26} predicted "
                f"{entry.get('predicted_wall_s', 0):.4g}s"
                + (
                    f"  measured {meas:.4g}s  "
                    f"x{entry.get('ratio', float('nan')):.4g}"
                    if isinstance(meas, (int, float))
                    else "  (uncovered)"
                )
            )
        for s in latest.get("mispriced_stages") or []:
            lines.append(
                f"  MISPRICED: {s['stage']} x{s['ratio']:g}"
            )
    readiness = summary.get("readiness") or {}
    lines.append(
        "refit readiness: "
        + ("READY" if readiness.get("ready") else "not ready")
        + f" ({readiness.get('n_records', 0)} record(s), platform "
        f"{readiness.get('platform')!r})"
    )
    for reason in readiness.get("reasons") or []:
        lines.append(f"  - {reason}")
    for name in sorted(readiness.get("stages") or {}):
        st = readiness["stages"][name]
        spread = st.get("rel_spread")
        lines.append(
            f"    {name:<26} {st['n']} sample(s), "
            f"{st['kind']} rate {st['rate']:.4g}/s, spread "
            + (f"{spread:.2%}" if spread is not None else "n/a")
            + f" -> {'ready' if st['ready'] else 'not ready'}"
        )
    refit = summary.get("refit")
    if refit:
        lines.append(
            f"refit: source={refit['source']!r} over "
            f"{refit['n_records']} record(s)"
        )
        for kind in ("flops_per_s", "bytes_per_s"):
            for name in sorted(refit.get(kind) or {}):
                lines.append(
                    f"    {name:<26} {kind} {refit[kind][name]:.4g}"
                )
    return lines


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="per-stage plan-accuracy drift, calibration "
                    "history and refit readiness from the ledger"
    )
    parser.add_argument(
        "history", nargs="*",
        help="calibration history JSONL path(s)/glob(s) "
             "(default: SWIFTLY_CALIBRATION_HISTORY or "
             "BENCH_calibration.jsonl)",
    )
    parser.add_argument(
        "--artifact", default=None,
        help="a BENCH artifact whose stamped plan_accuracy block is "
             "the 'latest' (default: the last history entry)",
    )
    parser.add_argument(
        "--platform", default=None,
        help="fit/readiness platform (default: first entry's)",
    )
    parser.add_argument(
        "--threshold", type=float, default=2.0,
        help="per-stage mispricing band [1/x, x] (default 2.0)",
    )
    parser.add_argument(
        "--min-samples", type=int, default=2, dest="min_samples",
        help="readiness: samples per stage (default 2)",
    )
    parser.add_argument(
        "--max-rel-spread", type=float, default=0.5,
        dest="max_rel_spread",
        help="readiness: max relative std of a stage's throughput "
             "samples (default 0.5)",
    )
    parser.add_argument(
        "--refit", action="store_true",
        help="also run refit_from_ledger and print the fitted rates",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the summary as one JSON object (for tooling/tests)",
    )
    args = parser.parse_args(argv)

    entries = oledger.load_calibration_history(args.history or None)
    latest = None
    if args.artifact:
        try:
            with open(args.artifact) as fh:
                record = json.load(fh)
        except (OSError, json.JSONDecodeError) as exc:
            print(f"cannot read {args.artifact}: {exc}", file=sys.stderr)
            return 2
        if isinstance(record, dict) and "parsed" in record:
            record = record["parsed"]
        latest = (
            record.get("plan_accuracy")
            if isinstance(record, dict) else None
        )
        if not isinstance(latest, dict):
            print(
                f"{args.artifact} stamps no plan_accuracy block",
                file=sys.stderr,
            )
            return 2
    if not entries and latest is None:
        print(
            "no calibration history found (run a bench leg with "
            "telemetry on, or pass the JSONL path)",
            file=sys.stderr,
        )
        return 2
    summary = summarize(
        entries, latest=latest, platform=args.platform,
        threshold=args.threshold, min_samples=args.min_samples,
        max_rel_spread=args.max_rel_spread, refit=args.refit,
    )
    if args.as_json:
        print(json.dumps(summary, indent=2))
    else:
        print("\n".join(_render(summary)))
        for p in summary["problems"]:
            print(f"PROBLEM: {p}", file=sys.stderr)
    return 0 if not summary["problems"] else 1


if __name__ == "__main__":
    sys.exit(main())
