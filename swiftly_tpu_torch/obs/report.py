"""Trace analysis: span trees, critical-path attribution, journey
decomposition, and the trace artifact schema check.

The port of the JAX package's ``swiftly_tpu/obs/report.py``, unchanged in
kind (pure Python). It reads the Chrome trace-event JSON that the port's
``obs.trace`` writes (every span an ``"X"`` event whose args carry
``span_id``/``parent_id``) and answers what the raw timeline only shows:

* **critical path**: for a root span (a round trip, a serve run), the
  dominant child chain and the top-k spans by aggregated *self time*
  (wall minus children). Self times partition the root's wall exactly,
  so the attribution always sums back to the root's wall (a smoke run
  holds it to 5%).
* **journey decomposition**: ``serve.journey.*`` segment totals (queue
  wait vs compute vs transfer share).
* **memory watermarks**: the max ``hbm_peak_bytes`` any span carried.

``summarize_trace`` builds the JSON block an artifact stamps as
``record["trace"]``; ``validate_trace_artifact`` is its schema guard;
``validate_trace_events`` is the structural Chrome-format check.
"""

from __future__ import annotations

import json

__all__ = [
    "TRACE_ARTIFACT_FIELDS",
    "build_tree",
    "by_process",
    "by_source",
    "critical_path",
    "journey_stats",
    "load_trace",
    "merge_traces",
    "self_times",
    "summarize_trace",
    "validate_trace_artifact",
    "validate_trace_events",
]

TRACE_SCHEMA = "swiftly-tpu-trace/1"

# Per-process span-id namespace stride used by `merge_traces`: each
# non-base process's span ids are lifted into their own block so the
# merged timeline has ONE consistent id space (per-process tracers all
# start their id counters at 1).
MERGE_SPAN_NS = 1 << 24


def load_trace(path):
    """The Chrome trace dict at ``path`` (accepts the bare event list
    some tools emit, normalising to the object form)."""
    with open(path) as fh:
        data = json.load(fh)
    if isinstance(data, list):
        data = {"traceEvents": data}
    return data


def validate_trace_events(trace):
    """Structural problems with a Chrome trace dict (empty = loads in
    Perfetto): event list present, required per-phase fields, complete
    events with non-negative microsecond durations."""
    problems = []
    if not isinstance(trace, dict):
        return [f"trace is {type(trace).__name__}, expected dict"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["missing traceEvents list"]
    if not events:
        problems.append("traceEvents is empty")
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            problems.append(f"event {i} is {type(e).__name__}")
            continue
        ph = e.get("ph")
        if ph not in ("X", "i", "I", "M", "b", "e", "B", "E", "C"):
            problems.append(f"event {i} has unknown ph {ph!r}")
            continue
        if ph == "M":
            continue
        for field in ("name", "pid", "tid", "ts"):
            if field not in e:
                problems.append(f"event {i} ({ph}) missing {field!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} (X) has bad dur {dur!r}")
    return problems


def build_tree(trace):
    """Span records from a trace dict: ``{id: {name, cat, ts_s, dur_s,
    parent, children, args}}``. Spans whose parent never closed (or a
    cross-process import) are treated as roots."""
    spans = {}
    for e in trace.get("traceEvents", ()):
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        sid = args.get("span_id")
        if sid is None:
            continue
        spans[sid] = {
            "id": sid,
            "name": e.get("name", "?"),
            "cat": e.get("cat", ""),
            "tid": e.get("tid"),
            "ts_s": float(e.get("ts", 0.0)) / 1e6,
            "dur_s": float(e.get("dur", 0.0)) / 1e6,
            "parent": args.get("parent_id", 0) or 0,
            "children": [],
            "args": args,
        }
    for s in spans.values():
        if s["parent"] not in spans:
            s["parent"] = 0
    for s in spans.values():
        if s["parent"]:
            spans[s["parent"]]["children"].append(s["id"])
    return spans


def _subtree_ids(spans, root_id):
    out, stack = [], [root_id]
    while stack:
        sid = stack.pop()
        out.append(sid)
        stack.extend(spans[sid]["children"])
    return out


def self_times(spans):
    """Per-span self time (wall minus direct children's wall, clamped
    at 0 against clock jitter). Self times of a subtree sum to the
    root's wall exactly when no child overhangs its parent."""
    out = {}
    for sid, s in spans.items():
        child_wall = sum(spans[c]["dur_s"] for c in s["children"])
        out[sid] = max(0.0, s["dur_s"] - child_wall)
    return out


def _roots(spans, root_id=None):
    if root_id is not None:
        return [root_id] if root_id in spans else []
    return [sid for sid, s in spans.items() if not s["parent"]]


def critical_path(spans, root_id=None):
    """The dominant chain: from the longest root, repeatedly descend
    into the longest child. Returns ``[{name, dur_s, self_s}, ...]``
    root-first (sequential siblings are ALL on the critical path of a
    single-threaded trace — the chain names where the time is, the
    self-time table says how much each level keeps for itself)."""
    roots = _roots(spans, root_id)
    if not roots:
        return []
    selfs = self_times(spans)
    sid = max(roots, key=lambda r: spans[r]["dur_s"])
    chain = []
    while True:
        s = spans[sid]
        chain.append(
            {
                "name": s["name"],
                "dur_s": round(s["dur_s"], 6),
                "self_s": round(selfs[sid], 6),
            }
        )
        if not s["children"]:
            return chain
        sid = max(s["children"], key=lambda c: spans[c]["dur_s"])


def aggregate(spans, root_id=None):
    """Per-name aggregation over the (sub)tree: count, total wall,
    self wall, max HBM watermark. Sorted by self time, descending."""
    selfs = self_times(spans)
    if root_id is not None and root_id in spans:
        ids = _subtree_ids(spans, root_id)
    else:
        ids = list(spans)
    by_name = {}
    for sid in ids:
        s = spans[sid]
        a = by_name.setdefault(
            s["name"],
            {"name": s["name"], "count": 0, "total_s": 0.0,
             "self_s": 0.0, "hbm_peak_bytes": None},
        )
        a["count"] += 1
        a["total_s"] += s["dur_s"]
        a["self_s"] += selfs[sid]
        hbm = s["args"].get("hbm_peak_bytes")
        if hbm is not None:
            a["hbm_peak_bytes"] = max(a["hbm_peak_bytes"] or 0, int(hbm))
    out = sorted(by_name.values(), key=lambda a: -a["self_s"])
    for a in out:
        a["total_s"] = round(a["total_s"], 6)
        a["self_s"] = round(a["self_s"], 6)
    return out


def journey_stats(spans):
    """Serve request-journey decomposition from the ``serve.journey.*``
    segment spans: per-segment totals and the share of end-to-end
    request wall each claims (queue-wait share is the p99 postmortem
    headline). None when the trace holds no journeys."""
    segs = {}
    total = 0.0
    n = 0
    for s in spans.values():
        if s["name"] == "serve.journey":
            total += s["dur_s"]
            n += 1
        elif s["name"].startswith("serve.journey."):
            seg = s["name"].rsplit(".", 1)[1]
            segs[seg] = segs.get(seg, 0.0) + s["dur_s"]
    if not n:
        return None
    out = {"n_requests": n, "total_s": round(total, 6)}
    for seg, t in sorted(segs.items()):
        out[f"{seg}_s"] = round(t, 6)
        out[f"{seg}_share"] = round(t / total, 4) if total else 0.0
    return out


def summarize_trace(trace, root_id=None, top_k=5):
    """The JSON block bench artifacts stamp as ``record["trace"]``:
    span counts, the root wall, top-k self-time attribution, the
    critical-path chain, journey decomposition and the HBM peak."""
    spans = build_tree(trace)
    roots = _roots(spans, root_id)
    selfs = self_times(spans)
    if root_id is None and roots:
        root_id = max(roots, key=lambda r: spans[r]["dur_s"])
    wall = spans[root_id]["dur_s"] if root_id in spans else 0.0
    sub = set(_subtree_ids(spans, root_id)) if root_id in spans else set()
    attributed = sum(selfs[sid] for sid in sub)
    hbm = [
        int(s["args"]["hbm_peak_bytes"])
        for s in spans.values()
        if s["args"].get("hbm_peak_bytes") is not None
    ]
    out = {
        "schema": TRACE_SCHEMA,
        "span_count": len(spans),
        "event_count": sum(
            1 for e in trace.get("traceEvents", ())
            if e.get("ph") in ("i", "I")
        ),
        "root": spans[root_id]["name"] if root_id in spans else None,
        "wall_s": round(wall, 6),
        "attributed_s": round(attributed, 6),
        "critical_path": critical_path(spans, root_id),
        "top": aggregate(spans, root_id)[:top_k],
        "hbm_peak_bytes": max(hbm) if hbm else None,
    }
    journeys = journey_stats(spans)
    if journeys:
        out["journeys"] = journeys
    return out


def by_source(trace, top_k=5):
    """Per-source attribution: spans and instants grouped by Perfetto
    track (tid), each labelled with its ``"M"`` thread-name metadata —
    the fleet tracks `trace.name_track` registered (``replica-N``,
    ``fleet-supervisor``) plus the synthetic journey rows. Returns
    rows sorted by self time, busiest source first."""
    labels = {}
    for e in trace.get("traceEvents", ()):
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            labels[e.get("tid")] = (e.get("args") or {}).get("name")
    spans = build_tree(trace)
    selfs = self_times(spans)
    groups = {}

    def group(tid):
        return groups.setdefault(tid, {
            "label": labels.get(tid) or f"tid {tid}",
            "spans": 0, "events": 0, "wall_s": 0.0, "self_s": 0.0,
            "stages": {},
        })

    for sid, s in spans.items():
        g = group(s["tid"])
        g["spans"] += 1
        g["wall_s"] += s["dur_s"]
        g["self_s"] += selfs[sid]
        st = g["stages"].setdefault(
            s["name"], {"count": 0, "self_s": 0.0}
        )
        st["count"] += 1
        st["self_s"] += selfs[sid]
    for e in trace.get("traceEvents", ()):
        if e.get("ph") in ("i", "I"):
            group(e.get("tid"))["events"] += 1
    rows = []
    for tid, g in sorted(
        groups.items(), key=lambda kv: -kv[1]["self_s"]
    ):
        top = sorted(
            g["stages"].items(), key=lambda kv: -kv[1]["self_s"]
        )[:top_k]
        rows.append({
            "tid": tid,
            "label": g["label"],
            "spans": g["spans"],
            "events": g["events"],
            "wall_s": round(g["wall_s"], 6),
            "self_s": round(g["self_s"], 6),
            "top": [
                {"name": n, "count": v["count"],
                 "self_s": round(v["self_s"], 6)}
                for n, v in top
            ],
        })
    return rows


def merge_traces(traces, offsets=None, labels=None):
    """ONE Perfetto timeline from per-process Chrome traces.

    ``traces[0]`` is the time base (the process-fleet router); every
    other trace's events are shifted onto its clock using the traces'
    ``otherData.t_epoch`` anchors corrected by ``offsets`` — the
    per-process wall-clock offsets the fleet estimated from the HELLO
    exchange (``{pid: {"offset_s": ..., "rtt_s": ...}}``, or a bare
    float per pid). A worker whose wall clock runs ``offset_s`` ahead
    of the router's has that much subtracted, so a request's
    router→worker→router journey lines up on one axis within the
    recorded RTT uncertainty.

    Span ids are namespaced per process (``MERGE_SPAN_NS`` stride, base
    trace unshifted) so `build_tree` sees one consistent id space, and
    worker spans carrying the fleet's cross-process trace context
    (``args.xparent`` + ``args.xpid``) are re-parented onto the
    originating process's span — the merged tree walks the hop.

    Returns a Chrome trace dict whose ``otherData`` records the base
    epoch, the merged pids, and the clock offsets applied.
    """
    traces = [t for t in traces if isinstance(t, dict)]
    if not traces:
        raise ValueError("merge_traces needs at least one trace")
    offsets = offsets or {}

    def _offset_s(pid):
        off = offsets.get(pid, offsets.get(str(pid), 0.0))
        if isinstance(off, dict):
            return float(off.get("offset_s", 0.0) or 0.0)
        return float(off or 0.0)

    def _pids(trace):
        return {
            e.get("pid") for e in trace.get("traceEvents", ())
            if isinstance(e, dict) and e.get("pid") is not None
        }

    base_epoch = float(
        (traces[0].get("otherData") or {}).get("t_epoch") or 0.0
    )
    # process index per trace: the base keeps index 0 (ids unshifted)
    pid_index = {}
    for i, trace in enumerate(traces):
        for pid in sorted(_pids(trace), key=str):
            pid_index.setdefault(pid, i)

    def _ns(pid, sid):
        if not sid:
            return 0
        return pid_index.get(pid, 0) * MERGE_SPAN_NS + int(sid)

    merged = []
    pids = []
    n_events = 0
    for i, trace in enumerate(traces):
        epoch = float(
            (trace.get("otherData") or {}).get("t_epoch") or base_epoch
        )
        trace_pids = _pids(trace)
        pids.extend(p for p in sorted(trace_pids, key=str)
                    if p not in pids)
        for e in trace.get("traceEvents", ()):
            if not isinstance(e, dict):
                continue
            e = dict(e)
            pid = e.get("pid")
            shift_us = (
                (epoch - _offset_s(pid) - base_epoch) * 1e6
                if i else 0.0
            )
            if "ts" in e:
                e["ts"] = round(float(e["ts"]) + shift_us, 3)
            if e.get("ph") == "X":
                args = dict(e.get("args") or {})
                sid = args.get("span_id")
                if sid is not None:
                    args["span_id"] = _ns(pid, sid)
                    xparent = args.get("xparent")
                    xpid = args.get("xpid")
                    if xparent and xpid in pid_index:
                        # the cross-process hop: adopt the originating
                        # process's span as the parent in the merged tree
                        args["parent_id"] = _ns(xpid, xparent)
                    else:
                        args["parent_id"] = _ns(
                            pid, args.get("parent_id", 0))
                e["args"] = args
            if e.get("ph") in ("i", "I"):
                n_events += 1
            merged.append(e)
    meta = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "args": {
                "name": (labels or {}).get(
                    pid, (labels or {}).get(str(pid), f"pid {pid}")),
            },
        }
        for pid in pids
    ]
    clock = {}
    for pid in pids:
        off = offsets.get(pid, offsets.get(str(pid)))
        if off is None:
            continue
        if isinstance(off, dict):
            clock[str(pid)] = {
                "offset_s": float(off.get("offset_s", 0.0) or 0.0),
                "rtt_s": float(off.get("rtt_s", 0.0) or 0.0),
            }
        else:
            clock[str(pid)] = {"offset_s": float(off), "rtt_s": 0.0}
    return {
        "traceEvents": meta + merged,
        "displayTimeUnit": "ms",
        "otherData": {
            "schema": TRACE_SCHEMA,
            "t_epoch": base_epoch,
            "n_processes": len(pids),
            "pids": pids,
            "clock_offsets": clock,
            "n_spans": sum(
                1 for e in merged if e.get("ph") == "X"
            ),
            "n_events": n_events,
        },
    }


def by_process(trace, top_k=5):
    """Per-process attribution: spans and instants grouped by pid, each
    labelled with its ``"M"`` process-name metadata — the merged
    process-fleet timeline's router/worker rows. Returns rows sorted by
    self time, busiest process first (the `by_source` twin, one level
    up the hierarchy)."""
    labels = {}
    span_pid = {}
    for e in trace.get("traceEvents", ()):
        if not isinstance(e, dict):
            continue
        if e.get("ph") == "M" and e.get("name") == "process_name":
            labels[e.get("pid")] = (e.get("args") or {}).get("name")
        elif e.get("ph") == "X":
            sid = (e.get("args") or {}).get("span_id")
            if sid is not None:
                span_pid[sid] = e.get("pid")
    spans = build_tree(trace)
    selfs = self_times(spans)
    groups = {}

    def group(pid):
        return groups.setdefault(pid, {
            "label": labels.get(pid) or f"pid {pid}",
            "spans": 0, "events": 0, "wall_s": 0.0, "self_s": 0.0,
            "stages": {},
        })

    for sid, s in spans.items():
        g = group(span_pid.get(sid))
        g["spans"] += 1
        g["wall_s"] += s["dur_s"]
        g["self_s"] += selfs[sid]
        st = g["stages"].setdefault(
            s["name"], {"count": 0, "self_s": 0.0}
        )
        st["count"] += 1
        st["self_s"] += selfs[sid]
    for e in trace.get("traceEvents", ()):
        if isinstance(e, dict) and e.get("ph") in ("i", "I"):
            group(e.get("pid"))["events"] += 1
    rows = []
    for pid, g in sorted(
        groups.items(), key=lambda kv: -kv[1]["self_s"]
    ):
        top = sorted(
            g["stages"].items(), key=lambda kv: -kv[1]["self_s"]
        )[:top_k]
        rows.append({
            "pid": pid,
            "label": g["label"],
            "spans": g["spans"],
            "events": g["events"],
            "wall_s": round(g["wall_s"], 6),
            "self_s": round(g["self_s"], 6),
            "top": [
                {"name": n, "count": v["count"],
                 "self_s": round(v["self_s"], 6)}
                for n, v in top
            ],
        })
    return rows


# The block every ``--trace`` BENCH artifact must carry — the timeline's
# schema contract, guarded the same way validate_serve_artifact guards
# the SLO block.
TRACE_ARTIFACT_FIELDS = (
    "schema",
    "span_count",
    "wall_s",
    "attributed_s",
    "critical_path",
    "top",
)


def validate_trace_artifact(record):
    """Problems with a traced BENCH artifact, as a list of strings.

    The record must carry a ``trace`` block with recorded spans, a
    positive root wall, a non-empty critical path, and self-time
    attribution that sums back to the root wall within 5% — an
    attribution that doesn't cover the leg is a broken span tree, not
    a timeline.
    """
    problems = []
    if not isinstance(record, dict):
        return [f"record is {type(record).__name__}, expected dict"]
    tr = record.get("trace")
    if not isinstance(tr, dict):
        return ["missing trace block"]
    for field in TRACE_ARTIFACT_FIELDS:
        if field not in tr:
            problems.append(f"trace block missing {field!r}")
    if tr.get("schema") not in (None, TRACE_SCHEMA):
        problems.append(
            f"trace schema {tr.get('schema')!r} != {TRACE_SCHEMA!r}"
        )
    sc = tr.get("span_count")
    if isinstance(sc, int) and sc < 1:
        problems.append("trace recorded no spans")
    wall = tr.get("wall_s")
    if isinstance(wall, (int, float)) and wall <= 0:
        problems.append(f"trace wall_s {wall!r} not positive")
    cp = tr.get("critical_path")
    if isinstance(cp, list):
        if not cp:
            problems.append("critical_path is empty")
        for k, entry in enumerate(cp):
            if not isinstance(entry, dict) or not (
                {"name", "dur_s", "self_s"} <= set(entry)
            ):
                problems.append(
                    f"critical_path[{k}] missing name/dur_s/self_s"
                )
    elif cp is not None:
        problems.append("critical_path is not a list")
    att = tr.get("attributed_s")
    if (
        isinstance(wall, (int, float))
        and isinstance(att, (int, float))
        and wall > 0
        and not (0.95 * wall <= att <= 1.05 * wall)
    ):
        problems.append(
            f"attributed self time {att} does not cover the root wall "
            f"{wall} within 5%"
        )
    return problems
