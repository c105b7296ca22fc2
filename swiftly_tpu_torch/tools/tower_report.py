"""Control-tower report over a drill artifact: fleet timeline, alerts,
and the last post-mortem, in one read.

The port's twin of the JAX package's ``scripts/tower_report.py``: the
same flags, output and exit codes, validating through the port's own
`swiftly_tpu_torch.obs`.

The drills stamp three observability blocks into their BENCH artifacts
(see docs/observability.md, "Control tower"):

* ``fleet_telemetry`` — every registered tower source (replicas, the
  cache fabric, the autoscaler, the fleet itself) keyed by name, with
  fleet ``totals`` that the per-source breakdowns sum to, and the last
  sampled signal values;
* ``alerts`` — the declarative SLO specs, the open/close event log of
  the multi-window burn-rate engine, and any alert still open;
* ``post_mortem`` — the flight recorder's bundle for the drill's
  trigger (`WorkerKilled`, `ShardLostError`, a forced drain): per-kind
  event counts and the non-stage event tail.

This script renders all three from one artifact — the post-incident
read ("what was the fleet doing, what burned, what does the black box
say") without opening the raw JSON. Blocks a drill didn't stamp (a
chaos artifact has no fleet) are skipped, and stamped blocks are
re-validated on the way through (`obs.validate_fleet_telemetry_artifact`
/ `obs.validate_alerts_artifact` — a doctored totals block turns the
exit code nonzero).

``--procfleet`` artifacts (``bench.py --procfleet``) additionally
carry the distributed observability plane: per-worker telemetry
sources inside ``fleet_telemetry`` (``worker-<rid>`` rows merged from
TELEMETRY frames + the retired-generation ledger), the per-worker
clock offsets estimated from the HELLO exchange (± rtt/2), the
TELEMETRY-frame coverage counters, and the black-box exhumation
summaries the supervisor recovered from dead workers. Those render as
one extra "process fleet" section — no new flag needed.

Usage:
    python -m swiftly_tpu_torch.tools.tower_report BENCH_fleet.json
        [--events 16] [--json]
"""

import argparse
import json
import sys

from ..obs import (
    validate_alerts_artifact,
    validate_fleet_telemetry_artifact,
)
from ..obs.recorder import render_post_mortem


def summarize(record, events=16):
    """The JSON-ready summary of one drill artifact's observability
    blocks (what ``--json`` prints); ``problems`` collects validator
    findings for the stamped blocks."""
    out = {"metric": record.get("metric"), "problems": []}
    ft = record.get("fleet_telemetry")
    if isinstance(ft, dict):
        out["problems"].extend(validate_fleet_telemetry_artifact(record))
        out["fleet_telemetry"] = {
            "n_sources": ft.get("n_sources"),
            "sources": {
                name: {
                    "kind": block.get("kind"),
                    "counters": block.get("counters"),
                    "stages": block.get("stages"),
                    "error": block.get("error"),
                }
                for name, block in (ft.get("sources") or {}).items()
            },
            "totals": ft.get("totals"),
            "signals": ft.get("signals"),
            "samples": ft.get("samples"),
            "source_errors": ft.get("source_errors"),
        }
    alerts = record.get("alerts")
    if isinstance(alerts, dict):
        out["problems"].extend(validate_alerts_artifact(record))
        out["alerts"] = {
            "slos": alerts.get("slos"),
            "opened": alerts.get("opened"),
            "closed": alerts.get("closed"),
            "open": alerts.get("open"),
            "events": (alerts.get("events") or [])[-events:],
        }
    pf = record.get("procfleet")
    if isinstance(pf, dict):
        out["procfleet"] = {
            "n_workers": pf.get("n_workers"),
            "worker_deaths": pf.get("worker_deaths"),
            "telemetry": pf.get("telemetry"),
            "clock_offsets": pf.get("clock_offsets"),
            "black_box": pf.get("black_box"),
            "trace_merge": pf.get("trace_merge"),
        }
    pm = record.get("post_mortem")
    if isinstance(pm, dict):
        out["post_mortem"] = {
            **{k: v for k, v in pm.items() if k != "events"},
            "events": (pm.get("events") or [])[-events:],
        }
    return out


def _render_telemetry(ft):
    lines = [
        f"fleet telemetry: {ft['n_sources']} source(s), "
        f"{ft.get('samples', '?')} tower sample(s), "
        f"{ft.get('source_errors', 0)} source error(s)"
    ]
    for name, block in sorted((ft.get("sources") or {}).items()):
        if block.get("error"):
            lines.append(
                f"  {name:<18} [{block.get('kind')}] "
                f"ERROR: {block['error']}"
            )
            continue
        counters = block.get("counters") or {}
        shown = ", ".join(
            f"{k}={counters[k]}" for k in sorted(counters)[:6]
        )
        lines.append(
            f"  {name:<18} [{block.get('kind')}] {shown}"
        )
        for sname, st in sorted((block.get("stages") or {}).items()):
            lines.append(
                f"    {sname:<28} x{st.get('count', 0):<6} "
                f"{st.get('total_s', 0.0):.4f}s"
            )
    totals = ft.get("totals") or {}
    lines.append("  fleet totals:")
    for k in sorted(totals.get("counters") or {}):
        lines.append(f"    {k:<32} {totals['counters'][k]}")
    for k, st in sorted((totals.get("stages") or {}).items()):
        lines.append(
            f"    {k:<32} x{st.get('count', 0):<6} "
            f"{st.get('total_s', 0.0):.4f}s"
        )
    signals = ft.get("signals") or {}
    if signals:
        lines.append(
            "  last signals: "
            + ", ".join(
                f"{k}={signals[k]}" for k in sorted(signals)
            )
        )
    return lines


def _render_alerts(alerts):
    lines = [
        f"alerts: {alerts.get('opened', 0)} opened, "
        f"{alerts.get('closed', 0)} closed, "
        f"{len(alerts.get('open') or [])} still open"
    ]
    for spec in alerts.get("slos") or []:
        lines.append(
            f"  slo {spec['name']}: {spec['signal']} "
            f"{spec['direction']} {spec['threshold']} "
            f"(burn {spec['burn']} over {spec['fast_s']}s/"
            f"{spec['slow_s']}s)"
        )
    for a in alerts.get("open") or []:
        lines.append(f"  OPEN: {a}")
    for e in alerts.get("events") or []:
        lines.append(
            f"  t={e.get('t', 0):>10.4f}  {e.get('action'):<6} "
            f"{e.get('slo')}"
        )
    return lines


def _render_procfleet(pf):
    lines = [
        f"process fleet: {pf.get('n_workers', '?')} worker(s), "
        f"{pf.get('worker_deaths', 0)} death(s)"
    ]
    tel = pf.get("telemetry") or {}
    if tel:
        cov = tel.get("coverage")
        lines.append(
            f"  telemetry: {tel.get('frames', 0)} frame(s), "
            f"{tel.get('zombie_frames', 0)} zombie-gated, "
            f"{tel.get('retired_generations', 0)} retired "
            "generation(s), coverage "
            + (f"{cov:.3f}" if isinstance(cov, (int, float)) else "-")
        )
    offsets = pf.get("clock_offsets") or {}
    if offsets:
        lines.append("  clock offsets (vs the router):")
        for rid, off in sorted(offsets.items()):
            lines.append(
                f"    worker-{rid} (pid {off.get('pid', '?')}, "
                f"g{off.get('generation', '?')}): "
                f"offset {off.get('offset_s', 0.0):+.6f}s "
                f"± rtt/2 {off.get('rtt_s', 0.0) / 2:.6f}s"
            )
    bb = pf.get("black_box") or {}
    for ex in bb.get("exhumed") or []:
        lines.append(
            f"  black box: worker-{ex.get('rid')} "
            f"g{ex.get('generation')} exhumed, "
            f"{ex.get('n_events', 0)} event(s)"
            + (" (TORN INDEX, fell back a generation)"
               if ex.get("torn_index") else "")
        )
    tm = pf.get("trace_merge") or {}
    if tm:
        lines.append(
            f"  trace merge: {tm.get('n_processes', '?')} process(es) "
            f"{tm.get('pids')}, "
            f"{tm.get('cross_process_requests', 0)} cross-process "
            "request span(s)"
        )
    return lines


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="fleet timeline + alerts + post-mortem from a "
                    "drill artifact"
    )
    parser.add_argument(
        "artifact", help="a drill artifact JSON (BENCH_fleet.json, "
                         "BENCH_chaos.json, BENCH_mesh_chaos.json)"
    )
    parser.add_argument(
        "--events", type=int, default=16,
        help="alert / post-mortem tail length to show (default 16)",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the summary as one JSON object (for tooling/tests)",
    )
    args = parser.parse_args(argv)

    try:
        with open(args.artifact) as fh:
            record = json.load(fh)
    except (OSError, json.JSONDecodeError) as exc:
        print(f"cannot read {args.artifact}: {exc}", file=sys.stderr)
        return 2
    if isinstance(record, dict) and "parsed" in record:
        record = record["parsed"]  # the BENCH_r0* round-ledger shape
    summary = summarize(record, events=args.events)

    if args.as_json:
        print(json.dumps(summary))
        return 0 if not summary["problems"] else 1

    print(f"artifact: {args.artifact}")
    if summary.get("metric"):
        print(f"  {summary['metric']}")
    rendered = False
    if "fleet_telemetry" in summary:
        print()
        print("\n".join(_render_telemetry(summary["fleet_telemetry"])))
        rendered = True
    if "alerts" in summary:
        print()
        print("\n".join(_render_alerts(summary["alerts"])))
        rendered = True
    if "procfleet" in summary:
        print()
        print("\n".join(_render_procfleet(summary["procfleet"])))
        rendered = True
    if "post_mortem" in summary:
        print()
        print(render_post_mortem(summary["post_mortem"]), end="")
        rendered = True
    if not rendered:
        print(
            "no observability blocks stamped (fleet_telemetry / "
            "alerts / post_mortem) — re-run the drill with the "
            "control tower enabled"
        )
    for p in summary["problems"]:
        print(f"PROBLEM: {p}", file=sys.stderr)
    return 0 if not summary["problems"] else 1


if __name__ == "__main__":
    sys.exit(main())
