"""Critical-path report over a recorded swiftly-tpu trace.

The port's twin of the JAX package's ``scripts/trace_report.py``: the
same flags, output and exit codes, through the port's own
`swiftly_tpu_torch.obs.report`.

Reads the Chrome trace-event JSON that ``bench.py --trace``,
``demo_api.py --trace`` / ``demo_serve.py --trace`` or
``SWIFTLY_TRACE=1`` + ``SWIFTLY_TRACE_PATH`` wrote, reconstructs the
span tree, and prints the questions the raw timeline only answers
visually: the critical-path chain, top-k span attribution (wall, self
time, HBM peak), and — when the trace holds serve request journeys —
the queue-wait vs compute vs transfer decomposition of request
latency.

The printed "critical path total" is the sum of self times under the
root, which partitions the root span's wall exactly — it matches the
leg wall within 5% by construction on a healthy trace (asserted by
``bench.py --smoke --trace``); a larger gap means spans leaked or the
tree is torn.

``--by-source`` groups the attribution per Perfetto track instead —
one row per named fleet source (``replica-N``, ``fleet-supervisor``,
request journeys), the view the control tower's track naming exists
for.

``--by-process`` groups per pid — the view for the process fleet's
MERGED timeline (`ProcessFleet.merged_trace`): one row per process
(``router``, ``worker-N.gG``), labelled from the merge's
``process_name`` metadata, with the recorded clock offsets echoed so
the cross-process alignment uncertainty is visible next to the rows.

Usage:
    python -m swiftly_tpu_torch.tools.trace_report BENCH_trace.json
        [--top 10] [--json] [--by-source] [--by-process]
"""

import argparse
import json
import sys

from ..obs import report


def _fmt_bytes(n):
    if n is None:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="critical-path report over a recorded trace"
    )
    parser.add_argument("trace", help="Chrome trace-event JSON path")
    parser.add_argument(
        "--top", type=int, default=10,
        help="rows in the self-time attribution table",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the summary as one JSON object (for tooling/tests)",
    )
    parser.add_argument(
        "--by-source", action="store_true", dest="by_source",
        help="group attribution per Perfetto track (replica-N, "
        "fleet-supervisor, request journeys) instead of fleet-wide",
    )
    parser.add_argument(
        "--by-process", action="store_true", dest="by_process",
        help="group attribution per process (router, worker-N.gG) — "
        "for merged process-fleet timelines",
    )
    args = parser.parse_args(argv)

    trace = report.load_trace(args.trace)
    problems = report.validate_trace_events(trace)
    if problems:
        print(
            f"warning: {len(problems)} structural problem(s): "
            + "; ".join(problems[:5]),
            file=sys.stderr,
        )
    if args.by_process:
        rows = report.by_process(trace, top_k=args.top)
        offsets = (trace.get("otherData") or {}).get("clock_offsets")
        if args.as_json:
            print(json.dumps({"by_process": rows,
                              "clock_offsets": offsets}))
            return 0 if not problems else 1
        print(f"trace: {args.trace} — {len(rows)} process(es)")
        for row in rows:
            print(
                f"\n{row['label']} (pid {row['pid']}): "
                f"{row['spans']} span(s), {row['events']} event(s), "
                f"self {row['self_s']:.4f}s"
            )
            for st in row["top"]:
                print(
                    f"  {st['name']:<28} x{st['count']:<6} "
                    f"self {st['self_s']:>10.4f}s"
                )
        if offsets:
            print("\nclock offsets (vs the base process):")
            for pid, off in sorted(offsets.items()):
                print(
                    f"  pid {pid}: offset {off.get('offset_s', 0.0):+.6f}s"
                    f" ± rtt/2 {off.get('rtt_s', 0.0) / 2:.6f}s"
                )
        return 0 if not problems else 1
    if args.by_source:
        rows = report.by_source(trace, top_k=args.top)
        if args.as_json:
            print(json.dumps({"by_source": rows}))
            return 0 if not problems else 1
        print(f"trace: {args.trace} — {len(rows)} source track(s)")
        for row in rows:
            print(
                f"\n{row['label']} (tid {row['tid']}): "
                f"{row['spans']} span(s), {row['events']} event(s), "
                f"self {row['self_s']:.4f}s"
            )
            for st in row["top"]:
                print(
                    f"  {st['name']:<28} x{st['count']:<6} "
                    f"self {st['self_s']:>10.4f}s"
                )
        return 0 if not problems else 1
    summary = report.summarize_trace(trace, top_k=args.top)
    if args.as_json:
        print(json.dumps(summary))
        return 0 if not problems else 1

    spans = report.build_tree(trace)
    print(f"trace: {args.trace}")
    print(
        f"  {summary['span_count']} spans, "
        f"{summary['event_count']} events"
        + (
            f", HBM peak {_fmt_bytes(summary['hbm_peak_bytes'])}"
            if summary["hbm_peak_bytes"] is not None
            else ""
        )
    )
    if summary["root"] is not None:
        print(
            f"  root: {summary['root']}  wall {summary['wall_s']:.3f}s  "
            f"critical-path total (sum of self times) "
            f"{summary['attributed_s']:.3f}s"
        )
    print("\ncritical path (dominant chain, root first):")
    for entry in summary["critical_path"]:
        print(
            f"  {entry['name']:<28} {entry['dur_s']:>10.4f}s  "
            f"self {entry['self_s']:>10.4f}s"
        )
    print(f"\ntop {args.top} by self time:")
    print(
        f"  {'span':<28} {'count':>6} {'total_s':>10} {'self_s':>10} "
        f"{'share%':>7}  hbm_peak"
    )
    wall = summary["wall_s"] or sum(a["self_s"] for a in summary["top"])
    for a in summary["top"]:
        share = 100.0 * a["self_s"] / wall if wall else 0.0
        print(
            f"  {a['name']:<28} {a['count']:>6} {a['total_s']:>10.4f} "
            f"{a['self_s']:>10.4f} {share:>7.2f}  "
            f"{_fmt_bytes(a['hbm_peak_bytes'])}"
        )
    journeys = summary.get("journeys") or report.journey_stats(spans)
    if journeys:
        print(
            f"\nserve request journeys ({journeys['n_requests']} "
            f"requests, {journeys['total_s']:.3f}s total):"
        )
        for seg in ("queue", "compute", "transfer"):
            if f"{seg}_s" in journeys:
                print(
                    f"  {seg:<10} {journeys[f'{seg}_s']:>10.4f}s  "
                    f"{100 * journeys[f'{seg}_share']:>6.2f}% of "
                    "request wall"
                )
    return 0 if not problems else 1


if __name__ == "__main__":
    sys.exit(main())
