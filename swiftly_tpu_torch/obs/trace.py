"""Critical-path tracing: hierarchical spans, HBM watermarks, Chrome
trace-event export.

The port of the JAX package's ``swiftly_tpu/obs/trace.py``.
``obs.metrics`` answers "how much time did stage X cost in total"; this
module answers "where did this run spend its time, and what was on the
critical path": structured spans with parent/child context, exported to
the Chrome trace-event JSON format that Perfetto and ``chrome://tracing``
load.

Design constraints, in the ``metrics.py`` discipline:

1. **Zero cost off.** Disabled (the default), ``trace.span(...)`` is one
   attribute check and the return of a shared no-op context manager: no
   allocation, no clock read, no contextvar touch. Every
   ``metrics.stage(...)`` site doubles as a trace site through the bridge
   in ``metrics._Stage``, so the executors carry one set of
   instrumentation for both systems.
2. **One vocabulary.** Spans opened by the metrics bridge carry the stage
   names of the executors (``fwd.sampled_facet_pass``,
   ``bwd.sampled_fold``, ...), the names the stage's
   ``torch.profiler.record_function`` and NVTX ranges carry, so host spans
   line up with the device timeline of a profiler trace.
3. **Hierarchy via contextvars.** The current span is a context variable:
   nested ``with`` blocks build the run -> pass -> column group -> stage
   tree. Worker threads inherit the spawning context explicitly via
   ``current()`` / ``adopt(ctx)`` (contextvars do not flow into
   ``threading.Thread``).
4. **Peak-memory attribution.** At every span close the tracer samples
   the device's peak allocated bytes (``torch.cuda.max_memory_allocated``
   on the CUDA device it was enabled for; the ``set_hbm_gauge`` fallback
   on the CPU) and stamps the watermark into the span and into the
   ``metrics.gauge_max("hbm.peak_bytes")`` peak gauge. The sample reads an
   allocator counter on the host: it adds no synchronisation.

Explicit-time spans (`add_span`) record segments whose ends are known
only afterwards, on a synthetic track of their own.

Enable via ``SWIFTLY_TRACE=1`` (``SWIFTLY_TRACE_PATH`` names the Chrome
JSON written at interpreter exit) or programmatically with
``trace.enable(path)``.
"""

from __future__ import annotations

import atexit
import contextvars
import itertools
import json
import os
import threading
import time

__all__ = [
    "Tracer",
    "adopt",
    "current",
    "disable",
    "enable",
    "enabled",
    "export",
    "get_tracer",
    "instant",
    "name_track",
    "reset",
    "save",
    "set_hbm_gauge",
    "span",
]

# Synthetic-track base: journey spans get tid = base + request id so
# every serve request renders as its own Perfetto row (real thread ids
# stay far below this).
JOURNEY_TID_BASE = 1 << 20

_SPAN_IDS = itertools.count(1)
_CURRENT = contextvars.ContextVar("swiftly_trace_span", default=0)


class _NullSpan:
    """The shared disabled-path context manager (no state, no work).

    Attribute writes and ``set(...)`` calls are swallowed so call sites
    may annotate spans unconditionally without branching on enablement.
    """

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __setattr__(self, name, value):
        pass

    def set(self, **args):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """One enabled span: perf_counter bracket + contextvar parenting."""

    __slots__ = ("_tr", "id", "parent", "name", "cat", "args", "tid",
                 "_t0", "_token")

    def __init__(self, tracer, name, cat, args):
        self._tr = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **args):
        """Attach args discovered inside the block (bytes, counts...)."""
        self.args.update(args)
        return self

    def __enter__(self):
        self.id = next(_SPAN_IDS)
        self.parent = _CURRENT.get()
        self._token = _CURRENT.set(self.id)
        self.tid = threading.get_native_id()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        try:
            _CURRENT.reset(self._token)
        except ValueError:  # pragma: no cover - exited in a peer context
            _CURRENT.set(self.parent)
        self._tr._finish(self, self._t0, t1)
        return False


class Tracer:
    """Span recorder + Chrome trace-event exporter; no-op unless enabled.

    One process-wide instance (``get_tracer()``) serves the engine;
    independent instances are constructible for tests.
    """

    def __init__(self, enabled=False, path=None):
        self._lock = threading.Lock()
        self.enabled = False
        self.path = None
        self._spans = []   # finished spans, completion order
        self._events = []  # instant events
        self._track_names = {}  # tid -> label ("M" metadata + --by-source)
        self._t0 = time.perf_counter()
        self._t_epoch = time.time()
        self._hbm_sampler = None
        self._hbm_gauge = None
        self._atexit_registered = False
        if enabled:
            self.enable(path)

    # -- lifecycle ---------------------------------------------------------

    def enable(self, path=None, device=None):
        """Turn recording on; ``path`` names the Chrome JSON written by
        ``save()`` (and at interpreter exit, so ``SWIFTLY_TRACE=1``
        runs that never call save still leave a loadable timeline).

        The HBM sampler is resolved here (not per span) so the
        enabled-path cost stays one callable check: ``device`` (default:
        the current CUDA device when CUDA is available) names the device
        whose peak allocated bytes are sampled; a CPU device falls back to
        whatever the instrumentation last pushed through
        ``set_hbm_gauge``.
        """
        with self._lock:
            self.enabled = True
            self._t0 = time.perf_counter()
            self._t_epoch = time.time()
            if path:
                self.path = str(path)
                if not self._atexit_registered:
                    self._atexit_registered = True
                    atexit.register(self._atexit_save)
            if self._hbm_sampler is None or device is not None:
                self._hbm_sampler = _resolve_hbm_sampler(device)
        return self

    def disable(self):
        """Stop recording (spans are kept for export until reset())."""
        with self._lock:
            self.enabled = False

    def reset(self):
        """Drop all recorded spans/events and rebase the clock."""
        with self._lock:
            self._spans = []
            self._events = []
            self._track_names = {}
            self._t0 = time.perf_counter()
            self._t_epoch = time.time()
            self._hbm_gauge = None

    def _atexit_save(self):  # pragma: no cover - interpreter shutdown
        try:
            if self.path and (self._spans or self._events):
                self.save(self.path)
        except Exception:
            pass

    # -- recording ---------------------------------------------------------

    def span(self, name, cat="host", **args):
        """Context manager opening one span as a child of the current
        context; disabled this returns the shared no-op immediately."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def name_track(self, tid, label):
        """Label one Perfetto track (thread row): fleet sources name
        their own tid (``replica-3``, ``fleet-supervisor``) so the
        exported timeline reads per-source and ``trace_report.py
        --by-source`` can group attribution the same way."""
        if not self.enabled:
            return
        with self._lock:
            self._track_names[int(tid)] = str(label)

    def track_names(self):
        """``{tid: label}`` of explicitly named tracks."""
        with self._lock:
            return dict(self._track_names)

    def instant(self, name, cat="event", **args):
        """One timestamped point event (fault injections, degradation
        steps, shed/quarantine decisions...)."""
        if not self.enabled:
            return
        rec = {
            "name": name,
            "cat": cat,
            "ts": time.perf_counter() - self._t0,
            "tid": threading.get_native_id(),
            "args": args,
        }
        with self._lock:
            self._events.append(rec)

    def add_span(self, name, t0, t1, cat="host", tid=None, parent=0,
                 **args):
        """Record a span with EXPLICIT perf_counter endpoints (for
        retroactive emission — e.g. a serve request's queue segment,
        known only at completion). Returns the span id (0 disabled)."""
        if not self.enabled:
            return 0
        sid = next(_SPAN_IDS)
        rec = {
            "id": sid,
            "parent": parent,
            "name": name,
            "cat": cat,
            "tid": threading.get_native_id() if tid is None else int(tid),
            "ts": t0 - self._t0,
            "dur": max(0.0, t1 - t0),
            "args": args,
        }
        with self._lock:
            self._spans.append(rec)
        return sid

    def _finish(self, span, t0, t1):
        rec = {
            "id": span.id,
            "parent": span.parent,
            "name": span.name,
            "cat": span.cat,
            "tid": span.tid,
            "ts": t0 - self._t0,
            "dur": t1 - t0,
            "args": span.args,
        }
        hbm = self._sample_hbm()
        if hbm is not None:
            rec["args"]["hbm_peak_bytes"] = hbm
        with self._lock:
            self._spans.append(rec)

    # -- HBM watermarks -----------------------------------------------------

    def set_hbm_gauge(self, nbytes):
        """Fallback watermark for runtimes without memory_stats: the
        instrumentation pushes its best projection (plan bytes, RSS...)
        and subsequent span closes stamp it."""
        self._hbm_gauge = int(nbytes)

    def _sample_hbm(self):
        sampler = self._hbm_sampler
        if sampler is not None:
            try:
                v = sampler()
            except Exception:  # pragma: no cover - runtime hiccup
                v = None
            if v:
                self._push_hbm_peak(v)
                return v
        return self._hbm_gauge

    @staticmethod
    def _push_hbm_peak(v):
        # local import: metrics imports this module (the stage bridge),
        # so the reverse edge must stay function-scoped
        from . import metrics as _metrics

        _metrics.gauge_max("hbm.peak_bytes", int(v))

    # -- export ------------------------------------------------------------

    def counts(self):
        """(n_spans, n_events) recorded so far."""
        with self._lock:
            return len(self._spans), len(self._events)

    def export(self):
        """The recorded timeline as a Chrome trace-event JSON dict.

        Every span is a complete ``"ph": "X"`` event whose args carry
        ``span_id``/``parent_id`` (the explicit tree — nesting-by-time
        reconstruction is not needed), instants are ``"ph": "i"``
        thread-scoped events, and synthetic tracks (request journeys)
        get ``"M"`` thread-name metadata so Perfetto labels the rows.
        """
        pid = os.getpid()
        with self._lock:
            spans = list(self._spans)
            events = list(self._events)
            t_epoch = self._t_epoch
            named_tids = dict(self._track_names)
        out = []
        for s in spans:
            args = dict(s["args"])
            args["span_id"] = s["id"]
            args["parent_id"] = s["parent"]
            out.append(
                {
                    "name": s["name"],
                    "cat": s["cat"],
                    "ph": "X",
                    "ts": round(s["ts"] * 1e6, 3),
                    "dur": round(s["dur"] * 1e6, 3),
                    "pid": pid,
                    "tid": s["tid"],
                    "args": args,
                }
            )
            if s["tid"] >= JOURNEY_TID_BASE and s["tid"] not in named_tids:
                named_tids[s["tid"]] = (
                    f"req {s['tid'] - JOURNEY_TID_BASE}"
                )
        for e in events:
            out.append(
                {
                    "name": e["name"],
                    "cat": e["cat"],
                    "ph": "i",
                    "s": "t",
                    "ts": round(e["ts"] * 1e6, 3),
                    "pid": pid,
                    "tid": e["tid"],
                    "args": dict(e["args"]),
                }
            )
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": label},
            }
            for tid, label in sorted(named_tids.items())
        ]
        return {
            "traceEvents": meta + out,
            "displayTimeUnit": "ms",
            "otherData": {
                "schema": "swiftly-tpu-trace/1",
                "t_epoch": t_epoch,
                "n_spans": len(spans),
                "n_events": len(events),
            },
        }

    def save(self, path=None, atomic=False):
        """Write the Chrome trace JSON; returns the path written.

        ``atomic=True`` publishes via a tmp sibling + rename (the
        `write_stream_state` discipline) so a concurrent reader — the
        process-fleet parent merging worker timelines while the worker
        is still serving — sees the previous complete trace or the new
        one, never a torn file."""
        path = str(path or self.path)
        if not path:
            raise ValueError("no trace path given and none configured")
        if atomic:
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(self.export(), fh)
            os.replace(tmp, path)
        else:
            with open(path, "w") as fh:
                json.dump(self.export(), fh)
        return path


def _resolve_hbm_sampler(device=None):
    """A zero-arg callable returning the peak allocated bytes of a CUDA
    device (``torch.cuda.max_memory_allocated``), or None for a CPU device
    or a host without CUDA. ``device`` None: the current CUDA device when
    CUDA is available."""
    try:
        import torch

        if device is None:
            if not torch.cuda.is_available():
                return None
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        if device.type != "cuda":
            return None

        def sample():
            return int(torch.cuda.max_memory_allocated(device))

        return sample
    except Exception:  # pragma: no cover - a CUDA runtime without stats
        return None


# ---------------------------------------------------------------------------
# The process-wide tracer + module-level conveniences (the engine's
# call-site API: `from ..obs import trace` ... `trace.span(...)`).
# ---------------------------------------------------------------------------

_TRACER = Tracer(
    enabled=os.environ.get("SWIFTLY_TRACE", "0") not in ("", "0"),
    path=os.environ.get("SWIFTLY_TRACE_PATH") or None,
)


def get_tracer() -> Tracer:
    return _TRACER


def enabled() -> bool:
    return _TRACER.enabled


def path():
    return _TRACER.path


def enable(path=None, device=None):
    return _TRACER.enable(path, device)


def disable():
    _TRACER.disable()


def reset():
    _TRACER.reset()


def span(name, cat="host", **args):
    if not _TRACER.enabled:  # keep the disabled path one check deep
        return _NULL_SPAN
    return _Span(_TRACER, name, cat, args)


def instant(name, cat="event", **args):
    _TRACER.instant(name, cat=cat, **args)


def name_track(tid, label):
    _TRACER.name_track(tid, label)


def add_span(name, t0, t1, cat="host", tid=None, parent=0, **args):
    return _TRACER.add_span(name, t0, t1, cat=cat, tid=tid,
                            parent=parent, **args)


def set_hbm_gauge(nbytes):
    _TRACER.set_hbm_gauge(nbytes)


def current() -> int:
    """The current span id — capture before handing work to a thread."""
    return _CURRENT.get()


def adopt(ctx: int):
    """Adopt ``ctx`` (a ``current()`` capture) as this thread's parent
    span — contextvars do not flow into ``threading.Thread`` targets."""
    _CURRENT.set(int(ctx))


def export():
    return _TRACER.export()


def save(path=None, atomic=False):
    return _TRACER.save(path, atomic=atomic)
