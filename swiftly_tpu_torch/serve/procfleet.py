"""Process fleet: the serve tier across REAL process boundaries.

`serve.fleet.ServeFleet` drills failover with threads in one process —
every kill is an injected exception. This module is the same serving
contract with the simulation removed: each replica is a separate OS
process (a spawned worker hosting a `SubgridService` over its own
prepared forward), the parent is a front-door router, and the only
thing crossing the boundary is `serve.ipc`'s versioned length-prefixed
frames. What the thread fleet asserted, this tier must *survive*:

* **Heartbeats on the wire.** Each worker's main loop sends a
  ``HEARTBEAT`` frame every lease interval; the parent's reader thread
  beats that worker's `HealthLease`. A silent socket IS the missed
  beat — ``SIGKILL -9`` needs no cooperation from the victim to be
  detected, because detection was never cooperative.
* **The ledger above the transport.** Routing is the same rendezvous
  hash (`serve.fleet._rendezvous_score` — pure integer, stable across
  processes), gated by per-worker `resilience.CircuitBreaker`s; every
  submitted request sits in a parent-side ledger until a terminal
  result lands, so requests in flight on a killed worker are re-routed
  to survivors (``proc.failovers``) with zero loss, exactly the thread
  fleet's failover discipline.
* **Cross-process L2.** The recorded stream is shared through the
  spill directory: `utils.spill.SpillCache.export_manifest` forces
  every entry to its atomic on-disk form, and each worker wraps a
  read-only `SharedSpillReader` in the UNCHANGED
  `parallel.streamed.CachedColumnFeed` — the ``stream_version`` /
  mid-patch gates read liveness from the fleet's stream-state file, so
  a worker that maps a stale or mid-patch L2 refuses and recomputes,
  exactly like the in-process feed. Entry files are immutable and
  renamed into place, so a worker killed mid-read can never leave a
  torn row for a survivor to observe.
* **Supervision with capped backoff.** A supervisor thread reaps dead
  workers (``waitpid`` — no zombies), restarts them with
  `resilience.retry.backoff_delay`-capped delays (``proc.restarts``),
  and the restarted worker re-earns trust through the breaker's
  half-open path — its trips are NOT erased by the restart.
* **Startup hygiene.** Fleet start sweeps run directories abandoned by
  a crashed parent: stale unix-socket files are removed
  (``proc.stale_sockets_swept``) and orphaned worker processes —
  identified by pidfile + cmdline marker, never by pid alone — are
  reaped (``proc.orphans_reaped``), mirroring `SpillCache`'s
  orphaned-``.tmp`` sweep.

* **A distributed observability plane.** Observability must not stop
  at the process boundary: each worker ships cumulative
  ``TELEMETRY`` frames (its metrics counters + stage timers) every
  heartbeat, and the parent registers one ``worker-<rid>`` source per
  slot (plus a ``router`` source) with an `obs.tower.ControlTower` —
  dead generations fold into a per-slot retired ledger (the cache
  fabric's ``drop_view`` discipline) so fleet totals NEVER regress on
  failover, and `validate_fleet_telemetry_artifact` proves the
  cross-process sums. REQUEST frames carry trace context (router span
  id + pid); workers publish their own Chrome timelines atomically and
  the parent merges them onto one clock (`obs.report.merge_traces`)
  using per-worker offsets estimated from the HELLO exchange. Each
  worker also keeps a **black box**: its flight-recorder ring is
  continuously appended to a per-generation JSONL with an atomically
  published index, and on worker death the supervisor exhumes the dead
  worker's ring and folds its tail into the parent's post-mortem — a
  SIGKILL victim still tells its own side of the story.

``chip_smoke.py --procfleet`` is the headline drill: a real mid-burst
``SIGKILL -9``, zero lost requests, bit-identity to per-request
compute, the full lease→breaker→failover→half-open→closed cycle in the
artifact, and a second kill landed *while the victim holds an L2 read*
(the ``CONTROL`` dwell knob) to prove no torn row is observable
cross-process.

The port of the JAX package's ``swiftly_tpu/serve/procfleet.py``. Where
it differs:

* **The worker's device.** The spec carries ``device`` (``"cuda"``
  unless the caller asks for ``"cpu"``); each worker resolves it with
  `ops.core.resolve_device` in its own process and CUDA context, and a
  worker that cannot get the card fails its boot — it never serves from
  the CPU. `ProcessFleet.start` raises when a worker has not booted by
  the boot deadline (or one exited before it was ready), with the
  tails of their logs.
* **Kernels.** For a CUDA spec the parent builds the CUDA sources
  (`ops._build.build_all`) before it spawns anything, so N workers do
  not run ``nvcc`` N times; each worker loads the libraries from
  ``_build/`` into its own context. A worker prepares its facet stack
  at boot, retrying a CUDA out-of-memory with capped backoff until the
  boot deadline (a SIGKILLed predecessor's device memory is freed only
  once the driver has torn its context down), and reports its
  wrappers' launch counters (`ops.kernels`) in its heartbeats and
  TELEMETRY frames (``kernel.<name>.launches`` and, per argument shape,
  ``kernel.<name>.shape.<dims>``), with its device peak and each slot's
  boot seconds in `ProcessFleet.stats`.
* **Results.** A computed subgrid is a device tensor; the worker's main
  loop copies it to pinned host memory without blocking (a copy on the
  stream it was computed on and an event it polls), so a busy card
  never holds back a heartbeat, and the frame carries host numpy: a
  frame never carries a torch tensor.
* **Names.** The orphan sweep's cmdline marker is this module's name
  (``WORKER_MARKER``), and the run root is ``swiftly_procfleet_torch``
  under the temp dir, so neither package's sweep walks the other's run
  dirs.
* **Facets.** A worker's facet tasks are ``make_facet`` calls made when
  the forward prepares each facet, so a worker's host holds one facet
  at a time.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import pickle
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..obs import recorder as _recorder
from ..obs import trace as _trace
from ..obs.tower import SLO
from ..resilience.breaker import CircuitBreaker
from ..resilience.faults import fault_point as _fault_point
from ..resilience.retry import backoff_delay, retry_transient
from . import ipc
from .fleet import _rendezvous_score
from .health import HealthLease, HealthMonitor
from .queue import (
    STATUS_EXPIRED,
    STATUS_SHED,
    RequestResult,
    SubgridRequest,
)

__all__ = [
    "ProcessFleet",
    "SharedSpillReader",
    "blackbox_index_path",
    "exhume_blackbox",
    "fleet_run_root",
    "make_worker_spec",
    "write_stream_state",
]

log = logging.getLogger(__name__)

# cmdline marker the orphan sweep matches before it will signal a pid
# from a stale pidfile — a recycled pid can never be mistaken for ours.
WORKER_MARKER = "swiftly_tpu_torch.serve.procfleet"

_LAT_RING = 4096
_STATE_FILE = "stream_state.json"
_SPEC_FILE = "spec.pkl"
_FLEET_PIDFILE = "fleet.pid"


def fleet_run_root():
    """Parent directory for every fleet's run dir (sockets, pidfiles,
    worker logs) — one fixed place so startup hygiene can find the
    wreckage of a crashed previous run. Not the JAX package's root: a
    sweep never walks the other package's run dirs."""
    return os.path.join(tempfile.gettempdir(), "swiftly_procfleet_torch")


def make_worker_spec(params, sources, *, backend="planar", dtype="float32",
                     max_depth=256, max_batch=16, max_retries=2,
                     lru_forward=2, queue_size=64, lease_interval_s=0.02,
                     stream=None, device="cuda"):
    """The picklable recipe a worker process rebuilds its serving stack
    from: catalogue ``params`` + point ``sources`` (the facet data is
    deterministic given both), service knobs, the device the worker
    serves on (``"cuda"`` unless the caller asks for ``"cpu"``), and
    optionally the recorded stream's manifest
    (`SpillCache.export_manifest`) for cross-process L2 serving."""
    return {
        "params": dict(params),
        "sources": list(sources),
        "backend": backend,
        "dtype": str(dtype),
        "max_depth": int(max_depth),
        "max_batch": int(max_batch),
        "max_retries": int(max_retries),
        "lru_forward": int(lru_forward),
        "queue_size": int(queue_size),
        "lease_interval_s": float(lease_interval_s),
        "stream": stream,
        "device": str(device),
    }


# ---------------------------------------------------------------------------
# Cross-process L2: read-only view over an exported spill manifest
# ---------------------------------------------------------------------------


class SharedSpillReader:
    """Duck-typed `utils.spill.SpillCache` read surface over an
    exported manifest, for a feed in ANOTHER process.

    `parallel.streamed.CachedColumnFeed` gates every lookup on the
    backing cache's ``complete`` / ``patching`` / ``stream_version``
    attributes; here those are properties that re-read the owning
    fleet's stream-state file, so the in-process gate semantics carry
    across the boundary unchanged: the parent flips the state file and
    every worker's feed starts refusing (LookupError → the service's
    fall-back-to-compute path) without any extra protocol.

    ``dwell_s`` is the drill knob behind the ``CONTROL`` frame: a
    positive value makes the next `get_row` hold its memory-mapped
    read open for that long (announcing itself through
    ``dwell_flag_path``), giving ``chip_smoke.py --procfleet`` a real
    mid-L2-read window to land a ``SIGKILL`` in.
    """

    def __init__(self, manifest, state_path, dwell_flag_path=None):
        self._entries = list(manifest["entries"])
        self._meta = list(manifest["meta"])
        self._state_path = state_path
        self._export_version = int(manifest.get("stream_version", 0))
        self.dwell_s = 0.0
        self.dwell_flag_path = dwell_flag_path
        self.flush_hook = None  # black-box sync point before the flag
        self.rows_read = 0

    def _state(self):
        try:
            with open(self._state_path) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            # no state file, or a torn/partial write: refuse — the feed
            # sees an incomplete cache and the service recomputes
            return {"complete": False, "patching": True,
                    "stream_version": -1}

    @property
    def complete(self):
        return bool(self._state().get("complete", False))

    @property
    def patching(self):
        return bool(self._state().get("patching", True))

    @property
    def stream_version(self):
        return int(self._state().get("stream_version", -1))

    def __len__(self):
        return len(self._meta)

    def meta(self, k):
        return self._meta[k]

    def get_row(self, k, index):
        def read():
            _fault_point("spill.get_row")
            mm = np.load(self._entries[k], mmap_mode="r")
            if self.dwell_s > 0:
                # hold the mapped read open: the drill's kill window
                _recorder.record("proc", "proc.l2_dwell",
                                 f"entry={k} dwell_s={self.dwell_s}")
                if self.flush_hook is not None:
                    # persist the dwell event BEFORE announcing the
                    # window — the SIGKILL that the flag invites lands
                    # faster than the next heartbeat-cadence flush, and
                    # the exhumed black box must show the dwell
                    self.flush_hook()
                if self.dwell_flag_path:
                    with open(self.dwell_flag_path, "w") as fh:
                        fh.write(str(os.getpid()))
                time.sleep(self.dwell_s)
            row = np.array(mm[index])
            _metrics.count("proc.l2_rows_read")
            return row

        out = retry_transient(read, site="spill.get_row")
        self.rows_read += 1
        return out


def write_stream_state(path, *, stream_version, complete=True,
                       patching=False):
    """Atomically publish the stream's liveness for cross-process
    readers (tmp sibling + rename — a reader can never see a torn
    state file, only the old one or the new one)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"stream_version": int(stream_version),
                   "complete": bool(complete),
                   "patching": bool(patching)}, fh)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Black-box recorder: a worker's flight-recorder ring, persisted
# continuously so a SIGKILL victim still tells its own story
# ---------------------------------------------------------------------------


def blackbox_index_path(run_dir, rid):
    """The atomically published black-box index for one worker slot."""
    return os.path.join(run_dir, f"blackbox-{rid}.idx.json")


def _blackbox_events_file(rid, generation):
    return f"blackbox-{rid}.g{generation}.jsonl"


class _WorkerBlackBox:
    """Worker-side black-box flusher: continuously persists the
    flight-recorder ring so the story survives ``SIGKILL -9``.

    Two-file discipline, mirroring `write_stream_state`:

    * the per-generation events file (``blackbox-<rid>.g<G>.jsonl``)
      is append-only — each flush drains
      `obs.recorder.FlightRecorder.events_since` and appends one JSON
      line per event. A kill mid-write leaves at most one torn trailing
      line, which `exhume_blackbox` skips;
    * the index (``blackbox-<rid>.idx.json``) is published atomically
      (tmp sibling + rename) naming the current generation, events file
      and count — an exhumer can never read a torn index, only the
      previously published one.
    """

    def __init__(self, run_dir, rid, generation, recorder):
        self.run_dir = run_dir
        self.rid = int(rid)
        self.generation = int(generation)
        self.recorder = recorder
        self.events_file = _blackbox_events_file(rid, generation)
        self.n_events = 0
        self._watermark = -1.0
        self._published = -1
        self._lock = threading.Lock()  # heartbeat loop vs dwell hook
        self._fh = open(os.path.join(run_dir, self.events_file), "a")

    def flush(self):
        """Append everything the ring recorded since the last flush,
        then republish the index if the count moved."""
        with self._lock:
            evs, self._watermark = self.recorder.events_since(
                self._watermark)
            if evs:
                for e in evs:
                    self._fh.write(json.dumps(e) + "\n")
                self._fh.flush()
                self.n_events += len(evs)
            if self.n_events != self._published:
                self._publish_index()
            return len(evs)

    def _publish_index(self):
        path = blackbox_index_path(self.run_dir, self.rid)
        tmp = f"{path}.tmp{self.generation}"
        with open(tmp, "w") as fh:
            json.dump({"rid": self.rid, "generation": self.generation,
                       "events_file": self.events_file,
                       "n_events": self.n_events,
                       "t_epoch": time.time()}, fh)
        os.replace(tmp, path)
        self._published = self.n_events

    def close(self):
        try:
            self.flush()
        except Exception:
            pass
        try:
            self._fh.close()
        except Exception:
            pass


def _read_jsonl_tolerant(path):
    """Events from one black-box JSONL, or None if unreadable. A torn
    trailing line — the write the kill interrupted — ends the replay
    instead of raising: everything before it is intact by append-order."""
    try:
        with open(path) as fh:
            raw = fh.read()
    except OSError:
        return None
    events = []
    for line in raw.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            e = json.loads(line)
        except ValueError:
            break  # torn tail: stop at the interrupted write
        if isinstance(e, dict):
            events.append(e)
    return events


def exhume_blackbox(run_dir, rid, max_generation=None):
    """Exhume a dead worker's black box: read the atomically published
    index, then replay the events file it names.

    A torn or missing index falls back to scanning per-generation
    events files downward from ``max_generation`` — the last
    generation that managed to persist anything still tells its story.
    Returns ``{rid, generation, n_events, events, t_epoch,
    torn_index}`` or None when the worker left nothing readable."""
    idx = None
    torn_index = False
    try:
        with open(blackbox_index_path(run_dir, rid)) as fh:
            idx = json.load(fh)
    except ValueError:
        torn_index = True
    except OSError:
        pass
    from_index = isinstance(idx, dict) and idx.get("events_file")
    if from_index:
        candidates = [(int(idx.get("generation", 0)),
                       os.path.join(run_dir, idx["events_file"]))]
    else:
        top = int(max_generation) if max_generation else 8
        candidates = [
            (g, os.path.join(run_dir, _blackbox_events_file(rid, g)))
            for g in range(top, 0, -1)
        ]
    for generation, path in candidates:
        events = _read_jsonl_tolerant(path)
        if events is None:
            continue
        if not events and not from_index:
            continue  # empty fallback candidate: try the older one
        return {
            "rid": int(rid),
            "generation": int(generation),
            "n_events": len(events),
            "events": events,
            "t_epoch": (idx or {}).get("t_epoch")
            if isinstance(idx, dict) else None,
            "torn_index": torn_index,
        }
    return None


# ---------------------------------------------------------------------------
# Worker process
# ---------------------------------------------------------------------------


def _worker_facet_tasks(config, spec):
    """The worker's facet tasks: one ``make_facet`` call per facet of the
    full cover, made when the forward prepares that facet (a host holds
    one facet at a time). `chip_smoke.py` builds its audit forward from
    the same tasks."""
    from ..api import make_facet, make_full_facet_cover

    return [
        (fc, functools.partial(make_facet, config.image_size, fc,
                               spec["sources"]))
        for fc in make_full_facet_cover(config)
    ]


def _prepare_facets(fwd, deadline_t):
    """Prepare the forward's facet stack on its device at boot, retrying
    an out-of-memory with capped backoff until ``deadline_t``: a restart
    can boot before the driver has freed its SIGKILLed predecessor's
    device memory, and that is a wait, not a failed worker slot."""
    from ..resilience.retry import is_oom

    attempt = 0
    while True:
        try:
            fwd._get_BF_Fs()
            break
        except Exception as exc:  # noqa: BLE001 - OOM filter below
            if not is_oom(exc) or time.monotonic() >= deadline_t:
                raise
            fwd._BF_Fs = None
            if fwd.core.device.type == "cuda":
                torch.cuda.empty_cache()
            delay = backoff_delay(attempt, base_s=0.25, max_s=2.0)
            _recorder.record("proc", "proc.boot_oom_wait",
                             f"attempt={attempt} delay_s={delay:.3f}")
            log.warning("facet preparation ran out of device memory; "
                        "retrying in %.2f s", delay)
            time.sleep(min(delay, max(0.0, deadline_t - time.monotonic())))
            attempt += 1
    if fwd.core.device.type == "cuda":
        torch.cuda.synchronize(fwd.core.device)


def _worker_serving_stack(spec, run_dir, rid, boot_deadline_s=240.0):
    """Rebuild config → facets → forward → service from the spec, on the
    spec's device (resolved in this process: a worker that cannot get
    the card raises here and fails its boot). Imports live here: the
    parent pays them once, each worker pays them at boot (the
    supervisor's lease registration waits for the first heartbeat, so
    boot time never reads as a missed beat)."""
    from ..api import SwiftlyConfig, SwiftlyForward
    from ..ops.core import as_torch_dtype, resolve_device
    from ..parallel.streamed import CachedColumnFeed
    from .queue import AdmissionQueue
    from .scheduler import CoalescingScheduler
    from .service import SubgridService

    device = resolve_device(spec.get("device", "cuda"))
    config = SwiftlyConfig(
        backend=spec["backend"], dtype=as_torch_dtype(spec["dtype"]),
        device=device, **spec["params"])
    fwd = SwiftlyForward(
        config, _worker_facet_tasks(config, spec),
        lru_forward=spec["lru_forward"], queue_size=spec["queue_size"],
    )
    _prepare_facets(fwd, time.monotonic() + boot_deadline_s)
    if device.type == "cuda":
        # hand the preparation's transients back to the driver: the card
        # is shared with the other workers' contexts
        torch.cuda.empty_cache()
    reader = None
    feed = None
    if spec.get("stream"):
        reader = SharedSpillReader(
            spec["stream"],
            os.path.join(run_dir, _STATE_FILE),
            dwell_flag_path=os.path.join(run_dir, f"l2_dwell_{rid}.flag"),
        )
        try:
            feed = CachedColumnFeed(
                reader, stream_version=reader.stream_version)
        except ValueError:
            feed = None  # stream not complete: serve pure compute
    service = SubgridService(
        fwd,
        queue=AdmissionQueue(max_depth=spec["max_depth"]),
        scheduler=CoalescingScheduler(max_batch=spec["max_batch"]),
        max_retries=spec["max_retries"],
        cache_feed=feed,
    )
    return service, reader


class _HostCopy:
    """A result's data on its way to host numpy without blocking the
    worker's main loop: a device tensor is copied into pinned host memory
    on the current stream (the one the service computed it on) behind an
    event that `ready` polls; host data is ready at once."""

    def __init__(self, res):
        self.result = res
        self._event = None
        data = res.data
        if isinstance(data, torch.Tensor):
            data = data.detach()
            if data.is_cuda:
                host = torch.empty(data.shape, dtype=data.dtype,
                                   pin_memory=True)
                host.copy_(data, non_blocking=True)
                self._event = torch.cuda.Event()
                self._event.record()
                data = host
        self._data = data

    def ready(self):
        return self._event is None or self._event.query()

    def host(self):
        """The data as host numpy (None for a result without data)."""
        data = self._data
        if data is None:
            return None
        if isinstance(data, torch.Tensor):
            if self._event is not None:
                self._event.synchronize()
            return data.numpy().copy()
        return np.asarray(data)


_KERNELS = ("cmatmul", "colpass", "fold", "degrid", "grid")


def _kernel_stats():
    """The kernel wrappers' launch counters (`ops.kernels`) of this
    process: {name: KernelStats}."""
    from ..ops import kernels

    return {name: getattr(kernels, f"{name}_stats") for name in _KERNELS}


def _kernel_launches():
    """{name: launches} of this process's kernel wrappers."""
    return {name: st.launches for name, st in _kernel_stats().items()}


def _kernel_counters():
    """The wrappers' counters as TELEMETRY counters, summable across
    workers and generations: ``kernel.<name>.launches`` and, per argument
    shape, ``kernel.<name>.shape.<d0>x<d1>...``."""
    out = {}
    for name, st in _kernel_stats().items():
        out[f"kernel.{name}.launches"] = st.launches
        for shape, n in st.shapes.items():
            dims = "x".join(str(d) for d in shape)
            out[f"kernel.{name}.shape.{dims}"] = n
    return out


def _result_payload(req_id, res, data=None):
    """The RESULT frame's payload: plain Python and host numpy only."""
    if data is None:
        data = _HostCopy(res).host()
    return {
        "req_id": req_id,
        "status": res.status,
        "data": data,
        "error": res.error,
        "latency_s": float(res.latency_s),
        "path": res.path,
        "retries": int(res.retries),
        "shed_reason": res.shed_reason,
        "retry_after_s": res.retry_after_s,
    }


def _worker_main(run_dir, rid, sock_path, generation=1):
    """Worker process entry: serve REQUEST frames over one unix socket,
    heartbeat every lease interval, drain on DRAIN. Runs until the
    parent drains it, the parent's socket dies, or it is killed.

    Observability boots with the worker: metrics + flight recorder are
    always on (telemetry frames and the black box need them), the
    tracer when the spec asks (``spec["trace"]``). A device result
    waits in ``staged`` for its host copy (`_HostCopy`) while the loop
    goes on beating; nothing in the loop synchronises the card."""
    logging.basicConfig(
        level=os.environ.get("SWIFTLY_LOGLEVEL", "WARNING"),
        format=f"%(asctime)s worker-{rid}: %(message)s",
        stream=sys.stderr,
    )
    with open(os.path.join(run_dir, f"worker-{rid}.pid"), "w") as fh:
        fh.write(str(os.getpid()))
    with open(os.path.join(run_dir, _SPEC_FILE), "rb") as fh:
        spec = pickle.load(fh)

    _metrics.enable()
    _recorder.enable()
    tracing = bool(spec.get("trace"))
    if tracing:
        _trace.enable()
    trace_path = os.path.join(run_dir, f"trace-{rid}.g{generation}.json")
    blackbox = _WorkerBlackBox(run_dir, rid, generation,
                               _recorder.get_recorder())

    service, reader = _worker_serving_stack(
        spec, run_dir, rid,
        boot_deadline_s=float(spec.get("boot_deadline_s", 240.0)))
    if reader is not None:
        reader.flush_hook = blackbox.flush

    lsock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        os.unlink(sock_path)
    except OSError:
        pass
    lsock.bind(sock_path)
    lsock.listen(1)
    lsock.settimeout(60.0)
    conn, _ = lsock.accept()

    service.start()
    stream = ipc.FrameStream(conn)
    hb_interval = float(spec["lease_interval_s"])
    device = service.fwd.core.device
    on_cuda = device is not None and device.type == "cuda"
    pending = {}  # parent req_id -> SubgridRequest
    staged = {}  # parent req_id -> _HostCopy of its finished result
    pending_trace = {}  # parent req_id -> (trace ctx, t_accept)
    served = 0
    beats = 0
    last_hb = 0.0
    last_trace_pub = 0.0
    running = True
    frame_deadline = max(1.0, 4 * hb_interval)

    def telemetry_snapshot():
        # `snapshot`, not `export`: export waits for the stages' CUDA
        # events, which would hold the loop (and its beats) on the card
        snap = _metrics.snapshot()
        counters = snap["counters"]
        counters.update(_kernel_counters())
        return {
            "rid": rid, "pid": os.getpid(), "generation": generation,
            "t_epoch": time.time(), "beats": beats, "served": served,
            "pending": len(pending) + len(staged),
            "counters": counters,
            "stages": snap["stages"],
        }

    try:
        while running:
            now = time.monotonic()
            if now - last_hb >= hb_interval:
                beats += 1
                ipc.send_frame(
                    conn, ipc.FRAME_HEARTBEAT,
                    {"rid": rid, "beats": beats, "served": served,
                     "pending": len(pending) + len(staged),
                     "launches": _kernel_launches(),
                     # an allocator counter read on the host: no sync
                     "device_peak_bytes": (
                         torch.cuda.max_memory_allocated(device)
                         if on_cuda else None)},
                    deadline_s=frame_deadline)
                last_hb = now
                # the observability plane rides the heartbeat cadence:
                # persist the ring, ship the cumulative snapshot
                blackbox.flush()
                ipc.send_frame(conn, ipc.FRAME_TELEMETRY,
                               telemetry_snapshot(),
                               deadline_s=frame_deadline)
                if tracing and now - last_trace_pub >= 0.5:
                    _trace.save(trace_path, atomic=True)
                    last_trace_pub = now
            for req_id in list(pending):
                freq = pending[req_id]
                if freq.done:
                    del pending[req_id]
                    staged[req_id] = _HostCopy(freq.result)
            for req_id in list(staged):
                copy = staged[req_id]
                if not copy.ready():
                    continue
                del staged[req_id]
                ipc.send_frame(
                    conn, ipc.FRAME_RESULT,
                    _result_payload(req_id, copy.result, copy.host()),
                    deadline_s=frame_deadline)
                served += 1
                ctx, t_req = pending_trace.pop(req_id, (None, None))
                if ctx and tracing:
                    # the worker half of the cross-process hop:
                    # xparent/xpid let merge_traces re-parent this
                    # span under the router's proc.request
                    _trace.add_span(
                        "proc.worker_request", t_req,
                        time.perf_counter(), cat="proc",
                        req_id=req_id, rid=rid,
                        status=copy.result.status,
                        xparent=ctx.get("span"),
                        xpid=ctx.get("pid"))
            try:
                ftype, _flags, obj = stream.recv_frame(
                    deadline_s=min(0.005, hb_interval / 4))
            except ipc.WireDeadline:
                continue
            except (ipc.TruncatedFrame, OSError):
                break  # parent gone: nothing left to serve
            except ipc.WireError as exc:
                # desynced stream cannot resync under length-prefixed
                # framing: report once, then drop the connection
                try:
                    ipc.send_frame(conn, ipc.FRAME_ERROR,
                                   {"rid": rid, "error": repr(exc)},
                                   deadline_s=frame_deadline)
                except ipc.WireError:
                    pass
                break
            if ftype == ipc.FRAME_REQUEST:
                _recorder.record("proc", "proc.request",
                                 f"req_id={obj['req_id']}")
                freq = service.submit(
                    obj["config"], priority=obj.get("priority", 0),
                    deadline_s=obj.get("deadline_s"))
                pending[obj["req_id"]] = freq
                pending_trace[obj["req_id"]] = (
                    obj.get("trace"), time.perf_counter())
            elif ftype == ipc.FRAME_HELLO:
                ipc.send_frame(
                    conn, ipc.FRAME_HELLO,
                    {"rid": rid, "pid": os.getpid(),
                     "wire_version": ipc.WIRE_VERSION,
                     "generation": generation,
                     # the wall-clock stamp the parent's NTP-style
                     # offset estimate anchors on (±rtt/2 uncertainty)
                     "t_epoch": time.time()},
                    deadline_s=frame_deadline)
            elif ftype == ipc.FRAME_CONTROL:
                if reader is not None and "dwell_l2_s" in obj:
                    reader.dwell_s = float(obj["dwell_l2_s"])
                ipc.send_frame(conn, ipc.FRAME_CONTROL, {"ack": True},
                               deadline_s=frame_deadline)
            elif ftype == ipc.FRAME_DRAIN:
                service.stop(drain=True)
                for req_id, copy in list(staged.items()):
                    ipc.send_frame(conn, ipc.FRAME_RESULT,
                                   _result_payload(req_id, copy.result,
                                                   copy.host()),
                                   deadline_s=frame_deadline)
                    served += 1
                staged.clear()
                for req_id, freq in list(pending.items()):
                    res = freq.wait(timeout=5.0)
                    if res is not None:
                        ipc.send_frame(conn, ipc.FRAME_RESULT,
                                       _result_payload(req_id, res),
                                       deadline_s=frame_deadline)
                        served += 1
                pending.clear()
                ipc.send_frame(conn, ipc.FRAME_DRAIN,
                               {"rid": rid, "served": served},
                               deadline_s=frame_deadline)
                running = False
    finally:
        try:
            service.stop(drain=False)
        except Exception:
            pass
        blackbox.close()
        if tracing:
            try:
                _trace.save(trace_path, atomic=True)
            except Exception:
                pass
        for path in (sock_path, os.path.join(run_dir, f"worker-{rid}.pid")):
            try:
                os.unlink(path)
            except OSError:
                pass
        conn.close()
        lsock.close()
    return 0


# ---------------------------------------------------------------------------
# Parent side
# ---------------------------------------------------------------------------


class _Worker:
    """Parent-side handle for one worker process (one generation)."""

    def __init__(self, rid):
        self.rid = rid
        self.generation = 0
        self.proc = None
        self.sock = None    # reader-thread side
        self.wsock = None   # sender side: a dup()'d object so send and
        #                     recv timeouts never race on one socket
        self.sock_path = None
        self.send_lock = threading.Lock()
        self.reader_thread = None
        self.lease = None
        self.breaker = None
        self.ready = False      # hello + first heartbeat seen
        self.dead = True
        self.restarts = 0
        self.restart_at = None
        self.served = 0
        self.heartbeats = 0
        self.last_stats = None
        self.hello = None
        self.drained = False
        # distributed observability plane
        self.last_beat_t = None      # monotonic time of the last beat
        self.ready_since = None      # start of the current live span
        self.live_s = 0.0            # completed live spans (dead gens)
        self.telemetry = None        # latest live TELEMETRY snapshot
        self.telemetry_t = None
        self.telemetry_frames = 0
        self.telemetry_covered_s = 0.0
        self.clock_offset = None     # latest generation's estimate
        self.clock_offsets = {}      # generation -> estimate (history)
        self.blackbox = None         # last exhumed black-box bundle
        self.spawn_t = None          # monotonic time of the last spawn
        self.boot_s = {}             # generation -> spawn-to-ready seconds

    @property
    def pid(self):
        return self.proc.pid if self.proc is not None else None


class _Entry:
    """Parent ledger row: one submitted request until terminal."""

    __slots__ = ("freq", "rid", "reroutes", "not_before", "failover",
                 "trace_ctx")

    def __init__(self, freq):
        self.freq = freq
        self.rid = None
        self.reroutes = 0
        self.not_before = 0.0
        self.failover = False
        self.trace_ctx = None


class ProcessFleet:
    """N worker processes behind a front-door router.

    :param spec: `make_worker_spec` output — the recipe workers rebuild
        their serving stack from
    :param n_workers: fleet size
    :param stream_spill: optional COMPLETE `utils.spill.SpillCache`
        holding the recorded stream; exported (`export_manifest`) into
        the spec so workers serve the shared L2 cross-process
    :param auto_restart: supervisor restarts dead workers with capped
        backoff (`restart_backoff_s` → `restart_backoff_max_s`, at most
        `max_restarts` times per worker slot)

    Workers serve on the spec's device (`make_worker_spec`: the card
    unless the spec asks for the CPU). ``start`` raises when a worker has
    not booted by ``boot_deadline_s`` (or one exited before it was
    ready), after stopping the fleet.

    Lifecycle: ``start()`` (sweeps stale runs, spawns, waits ready) →
    ``submit(config).wait()`` / ``drain()`` → ``stop()``. The drill
    surface: ``kill_worker(rid, sig)``, ``set_control(rid, ...)``,
    ``publish_stream_state(...)``, ``worker(rid)``.
    """

    def __init__(self, spec, n_workers, *, stream_spill=None,
                 run_root=None,
                 lease_interval_s=0.02, miss_suspect=3, miss_revoke=6,
                 breaker_threshold=3, breaker_reopen_s=0.3,
                 breaker_max_reopen_s=4.0, half_open_probes=2,
                 restart_backoff_s=0.1, restart_backoff_max_s=2.0,
                 max_restarts=5, auto_restart=True,
                 request_deadline_s=None, boot_deadline_s=120.0,
                 frame_deadline_s=2.0, worker_trace=False):
        self.spec = dict(spec)
        self.spec["lease_interval_s"] = float(lease_interval_s)
        self.spec["trace"] = bool(worker_trace)
        self.spec["boot_deadline_s"] = float(boot_deadline_s)
        self.worker_trace = bool(worker_trace)
        self.n_workers = int(n_workers)
        self.stream_spill = stream_spill
        self.run_root = run_root or fleet_run_root()
        self.lease_interval_s = float(lease_interval_s)
        self.miss_suspect = miss_suspect
        self.miss_revoke = miss_revoke
        self.breaker_threshold = breaker_threshold
        self.breaker_reopen_s = breaker_reopen_s
        self.breaker_max_reopen_s = breaker_max_reopen_s
        self.half_open_probes = half_open_probes
        self.restart_backoff_s = restart_backoff_s
        self.restart_backoff_max_s = restart_backoff_max_s
        self.max_restarts = max_restarts
        self.auto_restart = auto_restart
        self.request_deadline_s = request_deadline_s
        self.boot_deadline_s = boot_deadline_s
        self.frame_deadline_s = frame_deadline_s

        self.run_dir = None
        self._workers = {}
        self._pending = {}
        self._lock = threading.RLock()
        self._monitor = HealthMonitor(probe=self._probe,
                                      clock=time.monotonic)
        self._supervisor = None
        self._stopping = threading.Event()
        self._started = False
        self._lats = []
        self.counts = {
            "requests": 0, "served": 0, "shed": 0, "expired": 0,
            "failed": 0, "completed": 0, "failovers": 0, "reroutes": 0,
            "worker_deaths": 0, "restarts": 0, "orphans_reaped": 0,
            "stale_sockets_swept": 0, "heartbeats": 0,
            "telemetry_frames": 0, "telemetry_zombie": 0,
            "blackbox_exhumed": 0,
        }
        self._episodes = []  # [{"t0", "done", "failovers"}]
        self._tower = None
        # per-slot retired telemetry ledger: dead generations' final
        # counters/stages fold here (the cache fabric's drop_view
        # discipline) so fleet totals never regress on failover
        self._retired = {}

    # -- startup hygiene ----------------------------------------------------

    def _sweep_stale_runs(self):
        """Reap the wreckage of a crashed previous fleet: for every run
        dir whose owner pid is dead, kill still-running workers (pid
        from pidfile, verified against the cmdline marker so a recycled
        pid is never signalled) and remove stale socket files."""
        root = self.run_root
        if not os.path.isdir(root):
            return
        for name in os.listdir(root):
            rdir = os.path.join(root, name)
            if not os.path.isdir(rdir):
                continue
            try:
                with open(os.path.join(rdir, _FLEET_PIDFILE)) as fh:
                    owner = int(fh.read().strip())
            except (OSError, ValueError):
                owner = None
            if owner is not None and _pid_alive(owner):
                continue  # a live fleet owns this dir: hands off
            for entry in os.listdir(rdir):
                path = os.path.join(rdir, entry)
                if entry.endswith(".sock"):
                    try:
                        os.unlink(path)
                        self.counts["stale_sockets_swept"] += 1
                        _metrics.count("proc.stale_sockets_swept")
                    except OSError:
                        pass
                elif entry.startswith("worker-") and entry.endswith(".pid"):
                    try:
                        with open(path) as fh:
                            pid = int(fh.read().strip())
                    except (OSError, ValueError):
                        continue
                    if _pid_alive(pid) and _cmdline_matches(pid):
                        try:
                            os.kill(pid, signal.SIGKILL)
                            self.counts["orphans_reaped"] += 1
                            _metrics.count("proc.orphans_reaped")
                            log.warning(
                                "reaped orphaned worker pid %d from "
                                "stale run %s", pid, name)
                        except OSError:
                            pass
            shutil.rmtree(rdir, ignore_errors=True)

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        if self._started:
            raise RuntimeError("fleet already started")
        os.makedirs(self.run_root, exist_ok=True)
        self._sweep_stale_runs()
        self.run_dir = tempfile.mkdtemp(
            prefix=f"run-{os.getpid()}-", dir=self.run_root)
        with open(os.path.join(self.run_dir, _FLEET_PIDFILE), "w") as fh:
            fh.write(str(os.getpid()))
        if self.stream_spill is not None:
            manifest = self.stream_spill.export_manifest()
            self.spec["stream"] = manifest
            write_stream_state(
                os.path.join(self.run_dir, _STATE_FILE),
                stream_version=manifest["stream_version"])
        with open(os.path.join(self.run_dir, _SPEC_FILE), "wb") as fh:
            pickle.dump(self.spec, fh, protocol=pickle.HIGHEST_PROTOCOL)
        if torch.device(self.spec.get("device", "cuda")).type == "cuda":
            # once here, so the workers load the libraries and N workers
            # never run nvcc N times (the build is atomic: tmp + rename)
            from ..ops import _build

            _build.build_all(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
        now = time.monotonic()
        for rid in range(self.n_workers):
            w = _Worker(rid)
            w.breaker = CircuitBreaker(
                name=f"worker-{rid}",
                failure_threshold=self.breaker_threshold,
                reopen_s=self.breaker_reopen_s,
                max_reopen_s=self.breaker_max_reopen_s,
                half_open_probes=self.half_open_probes,
                clock=time.monotonic,
            )
            self._workers[rid] = w
            self._spawn(w, now)
        self._started = True
        self._supervisor = threading.Thread(
            target=self._supervise, name="procfleet-supervisor",
            daemon=True)
        self._supervisor.start()
        if not self._wait_booted(self.boot_deadline_s):
            failed = self._boot_report()
            self.stop(drain=False)
            raise RuntimeError(
                f"process fleet: {len(failed)} of {self.n_workers} "
                f"worker(s) did not boot within {self.boot_deadline_s} s:"
                + "".join(f"\n{line}" for line in failed))
        return self

    def _boot_report(self):
        """One line per worker that is not ready: its pid, exit code and
        the tail of its log."""
        lines = []
        for w in self._workers.values():
            if w.ready and not w.dead:
                continue
            code = w.proc.poll() if w.proc is not None else None
            path = os.path.join(
                self.run_dir, f"worker-{w.rid}.g{w.generation}.log")
            try:
                with open(path, "rb") as fh:
                    tail = fh.read()[-2000:].decode("utf-8", "replace")
            except OSError:
                tail = ""
            lines.append(f"worker {w.rid} (pid {w.pid}, exit code {code}): "
                         f"{tail.strip()}")
        return lines

    def _spawn(self, w, now):
        _fault_point("proc.spawn")
        w.generation += 1
        w.sock_path = os.path.join(
            self.run_dir, f"worker-{w.rid}.g{w.generation}.sock")
        env = dict(os.environ)
        logf = open(os.path.join(
            self.run_dir, f"worker-{w.rid}.g{w.generation}.log"), "wb")
        w.proc = subprocess.Popen(
            [sys.executable, "-m", WORKER_MARKER, "--worker",
             "--run-dir", self.run_dir, "--rid", str(w.rid),
             "--sock", w.sock_path, "--generation", str(w.generation)],
            stdout=logf, stderr=subprocess.STDOUT, env=env,
            cwd=os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
        )
        logf.close()
        w.dead = False
        w.ready = False
        w.drained = False
        w.sock = None
        w.spawn_t = time.monotonic()
        _metrics.count("proc.workers_spawned")
        _trace.instant("proc.worker_spawned", cat="proc",
                       rid=w.rid, pid=w.proc.pid, generation=w.generation)
        w.reader_thread = threading.Thread(
            target=self._attach_and_read, args=(w, w.generation),
            name=f"procfleet-reader-{w.rid}", daemon=True)
        w.reader_thread.start()

    def _attach_and_read(self, w, generation):
        """Connect to the worker's socket (retry ladder while it boots)
        then pump its frames: heartbeats beat the lease, results settle
        the ledger. Exits when the socket dies — the resulting silence
        is exactly how the lease learns the worker is gone. The connect
        retries in one-second rounds, and gives up once the fleet stops,
        the slot moves to another generation or the process has exited."""
        deadline = time.monotonic() + self.boot_deadline_s
        while True:
            try:
                sock = ipc.connect_unix(w.sock_path, deadline_s=min(
                    1.0, max(0.05, deadline - time.monotonic())))
                break
            except OSError:
                if (self._stopping.is_set() or w.generation != generation
                        or w.proc.poll() is not None
                        or time.monotonic() >= deadline):
                    return  # supervisor will see the silence
        with self._lock:
            if w.generation != generation or self._stopping.is_set():
                sock.close()
                return
            w.sock = sock
            w.wsock = sock.dup()
        t_hello = time.time()
        try:
            with w.send_lock:
                ipc.send_frame(w.wsock, ipc.FRAME_HELLO,
                               {"fleet_pid": os.getpid(),
                                "t_epoch": t_hello},
                               deadline_s=self.frame_deadline_s)
        except ipc.WireError:
            pass
        stream = ipc.FrameStream(sock)
        while not self._stopping.is_set():
            try:
                ftype, _flags, obj = stream.recv_frame(deadline_s=0.25)
            except ipc.WireDeadline:
                continue
            except (ipc.TruncatedFrame, ipc.WireError, OSError):
                break
            now = time.monotonic()
            if ftype == ipc.FRAME_HEARTBEAT:
                self._on_heartbeat(w, generation, obj, now)
            elif ftype == ipc.FRAME_RESULT:
                self._on_result(w, obj, now)
            elif ftype == ipc.FRAME_TELEMETRY:
                self._on_telemetry(w, generation, obj, now)
            elif ftype == ipc.FRAME_HELLO:
                self._on_hello(w, generation, obj, t_hello, time.time())
            elif ftype == ipc.FRAME_DRAIN:
                w.drained = True
            elif ftype == ipc.FRAME_ERROR:
                log.warning("worker %d wire error: %s",
                            w.rid, obj.get("error"))
        with self._lock:
            if w.generation == generation:
                w.sock = None

    def _on_heartbeat(self, w, generation, obj, now):
        self.counts["heartbeats"] += 1
        w.heartbeats += 1
        w.last_stats = obj
        _metrics.count("proc.heartbeats")
        with self._lock:
            if w.generation != generation:
                return
            w.last_beat_t = now
            if not w.ready:
                w.ready = True
                w.ready_since = now
                if w.spawn_t is not None:
                    w.boot_s[generation] = now - w.spawn_t
                if w.lease is None:
                    w.lease = HealthLease(
                        f"worker-{w.rid}", self.lease_interval_s,
                        miss_suspect=self.miss_suspect,
                        miss_revoke=self.miss_revoke,
                        clock=time.monotonic,
                    )
                    self._monitor.register(w.rid, w.lease)
                elif w.lease.revoked:
                    self._monitor.revive(w.rid)
        w.lease.beat(now)

    @staticmethod
    def _clock_offset_from_hello(t_send, t_recv, hello):
        """NTP-style one-exchange offset estimate: the worker stamped
        its wall clock (``t_epoch``) somewhere inside the HELLO round
        trip, so assuming the midpoint, the worker's clock runs
        ``t_worker - (t_send + rtt/2)`` ahead of ours. Correct within
        ±rtt/2 — which is exactly why the RTT is recorded next to the
        offset and carried into the merged-trace manifest."""
        t_worker = (hello or {}).get("t_epoch")
        if not isinstance(t_worker, (int, float)):
            return None
        rtt = max(0.0, float(t_recv) - float(t_send))
        return {"offset_s": float(t_worker) - (float(t_send) + rtt / 2.0),
                "rtt_s": rtt}

    def _on_hello(self, w, generation, obj, t_send, t_recv):
        with self._lock:
            if w.generation != generation:
                return
            w.hello = obj
            off = self._clock_offset_from_hello(t_send, t_recv, obj)
            if off is not None:
                off["pid"] = (obj or {}).get("pid")
                off["generation"] = generation
                w.clock_offset = off
                w.clock_offsets[generation] = off

    def _on_telemetry(self, w, generation, obj, now):
        self.counts["telemetry_frames"] += 1
        _metrics.count("proc.telemetry_frames")
        with self._lock:
            if (not isinstance(obj, dict)
                    or w.generation != generation
                    or obj.get("generation", generation) != generation):
                # a zombie generation's snapshot (or garbage): counted,
                # never folded into the live slot's telemetry
                self.counts["telemetry_zombie"] += 1
                _metrics.count("proc.telemetry_zombie")
                return
            w.telemetry_frames += 1
            if w.telemetry_t is not None:
                # coverage accrual: the wall this frame vouches for,
                # capped so a stalled worker's late frame cannot claim
                # the stall as observed time
                gap = max(0.0, now - w.telemetry_t)
                w.telemetry_covered_s += min(
                    gap, 4 * self.lease_interval_s)
            w.telemetry = obj
            w.telemetry_t = now

    def _retire_telemetry(self, w):
        """Fold the dead generation's final telemetry snapshot into the
        per-slot retired ledger — the cache fabric's ``drop_view``
        discipline: a worker's counters outlive its process, so the
        fleet totals the tower sums NEVER regress on failover."""
        snap, w.telemetry = w.telemetry, None
        w.telemetry_t = None
        if not isinstance(snap, dict):
            return
        led = self._retired.setdefault(
            w.rid, {"counters": {}, "stages": {}, "generations": 0})
        led["generations"] += 1
        for name, v in (snap.get("counters") or {}).items():
            if isinstance(v, (int, float)):
                led["counters"][name] = led["counters"].get(name, 0) + v
        for name, st in (snap.get("stages") or {}).items():
            if not isinstance(st, dict):
                continue
            agg = led["stages"].setdefault(
                name, {"count": 0, "total_s": 0.0})
            agg["count"] += int(st.get("count", 0) or 0)
            agg["total_s"] += float(st.get("total_s", 0.0) or 0.0)

    def _on_result(self, w, obj, now):
        req_id = obj["req_id"]
        with self._lock:
            entry = self._pending.get(req_id)
        if entry is None:
            return  # duplicate after a reroute: first result won
        res = RequestResult(
            obj["status"], data=obj["data"], error=obj["error"],
            latency_s=obj["latency_s"], path=obj["path"],
            retries=obj["retries"], shed_reason=obj["shed_reason"],
            retry_after_s=obj["retry_after_s"],
        )
        if res.status == STATUS_SHED and self._has_alternative(w.rid):
            # the worker's own admission door shed it but a survivor
            # can serve: reroute instead of surfacing the shed
            with self._lock:
                entry.rid = None
                entry.reroutes += 1
                entry.not_before = now + backoff_delay(
                    entry.reroutes, base_s=0.005, max_s=0.1)
            self.counts["reroutes"] += 1
            _metrics.count("proc.reroutes")
            return
        if res.ok:
            w.served += 1
            w.breaker.record_success(now)
            if w.lease is not None:
                w.lease.beat(now)  # a result is evidence of life
        self._finish(entry, res, now)

    def _finish(self, entry, res, now):
        with self._lock:
            if self._pending.pop(entry.freq.req_id, None) is None:
                return
            self.counts["completed"] += 1
            if res.ok:
                self.counts["served"] += 1
                _metrics.count("proc.served")
                lat = now - entry.freq.submit_t
                self._lats.append(lat)
                if len(self._lats) > _LAT_RING:
                    del self._lats[: _LAT_RING // 4]
            elif res.status == STATUS_SHED:
                self.counts["shed"] += 1
                _metrics.count("proc.shed")
            elif res.status == STATUS_EXPIRED:
                self.counts["expired"] += 1
                _metrics.count("proc.expired")
            else:
                self.counts["failed"] += 1
            if entry.failover and self._episodes:
                self._episodes[-1]["done"] = now
        if entry.trace_ctx is not None and _trace.enabled():
            # the router half of the cross-process request: duration-
            # derived endpoints keep this clock-safe even where
            # monotonic and perf_counter differ
            t1 = time.perf_counter()
            dur = max(0.0, now - entry.freq.submit_t)
            _trace.add_span(
                "proc.request", t1 - dur, t1, cat="proc",
                parent=entry.trace_ctx.get("span") or 0,
                req_id=entry.freq.req_id, rid=entry.rid,
                status=res.status, failover=entry.failover)
        entry.freq._complete(res)

    # -- routing ------------------------------------------------------------

    def _probe(self, rid):
        w = self._workers.get(rid)
        return (w is not None and not w.dead and w.proc is not None
                and w.proc.poll() is None and w.sock is not None)

    def _has_alternative(self, excluded_rid):
        now = time.monotonic()
        return any(
            self._routable(w, now) for w in self._workers.values()
            if w.rid != excluded_rid)

    def _routable(self, w, now):
        return (not w.dead and w.ready and w.sock is not None
                and w.lease is not None and not w.lease.revoked
                and w.breaker.allow(now))

    def _pick(self, off0, exclude, now):
        retry_transient(lambda: _fault_point("proc.route"),
                        site="proc.route", max_attempts=3, base_s=0.001)
        candidates = [
            w for w in self._workers.values()
            if w.rid not in exclude and self._routable(w, now)
        ]
        candidates.sort(
            key=lambda w: _rendezvous_score(off0, w.rid), reverse=True)
        return candidates[0] if candidates else None

    def submit(self, config, priority=0, deadline_s=None):
        """Route one request to a worker; returns a
        `serve.queue.SubgridRequest` handle (``wait()`` for the
        `RequestResult`). Never blocks: with no routable worker the
        request is parked in the ledger and the supervisor routes it
        the moment one recovers (or expires it at its deadline)."""
        if not self._started:
            raise RuntimeError("fleet not started")
        if deadline_s is None:
            deadline_s = self.request_deadline_s
        freq = SubgridRequest(config, priority=priority,
                              deadline_s=deadline_s)
        entry = _Entry(freq)
        if self.worker_trace and _trace.enabled():
            # the cross-process trace context REQUEST frames carry:
            # the router's current span + pid let the worker stamp
            # xparent/xpid, which merge_traces re-parents across the hop
            entry.trace_ctx = {"id": freq.req_id,
                               "span": _trace.current(),
                               "pid": os.getpid()}
        with self._lock:
            self._pending[freq.req_id] = entry
            self.counts["requests"] += 1
        _metrics.count("proc.requests")
        self._route(entry, time.monotonic())
        return freq

    def _route(self, entry, now, exclude=()):
        w = self._pick(entry.freq.config.off0, exclude, now)
        if w is None:
            # no routable worker right now: park; the supervisor
            # re-routes on its tick (capped by the request's deadline)
            with self._lock:
                entry.rid = None
                entry.not_before = now + backoff_delay(
                    entry.reroutes, base_s=0.01, max_s=0.25)
            return False
        remaining = None
        if entry.freq.deadline_t is not None:
            remaining = max(0.01, entry.freq.deadline_t
                            - time.perf_counter())
        payload = {
            "req_id": entry.freq.req_id,
            "config": entry.freq.config,
            "priority": entry.freq.priority,
            "deadline_s": remaining,
            "trace": entry.trace_ctx,
        }
        with self._lock:
            # claim BEFORE sending so the supervisor's scan can never
            # double-route this entry while the send is in flight
            entry.rid = w.rid
            wsock = w.wsock
        if wsock is None:
            with self._lock:
                entry.rid = None
            return self._route(entry, now, exclude=(*exclude, w.rid))
        try:
            with w.send_lock:
                ipc.send_frame(wsock, ipc.FRAME_REQUEST, payload,
                               deadline_s=self.frame_deadline_s)
        except (ipc.WireError, OSError) as exc:
            # a failed send may have left a partial frame: the stream
            # is indeterminate, so the connection is dead — drop it and
            # let the lease's silence drive reap + restart
            w.breaker.record_failure(time.monotonic(), reason=repr(exc))
            self._drop_connection(w)
            with self._lock:
                entry.rid = None
                entry.reroutes += 1
            return self._route(entry, now, exclude=(*exclude, w.rid))
        return True

    def _drop_connection(self, w):
        with self._lock:
            sock, w.sock = w.sock, None
            wsock, w.wsock = w.wsock, None
        for s in (sock, wsock):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass

    # -- supervision --------------------------------------------------------

    def _supervise(self):
        tick = max(0.005, self.lease_interval_s / 2)
        while not self._stopping.wait(tick):
            now = time.monotonic()
            try:
                for rid, _frm, to in self._monitor.check(now):
                    if to == "revoked":
                        self._on_revoked(rid, now)
                self._scan(now)
                self._restart_due(now)
                if self._tower is not None:
                    self._tower.tick(now)
            except Exception:  # pragma: no cover - supervisor must live
                log.exception("supervisor tick failed")

    def _on_revoked(self, rid, now):
        w = self._workers.get(rid)
        if w is None or w.dead:
            return
        w.dead = True
        self.counts["worker_deaths"] += 1
        _metrics.count("proc.worker_deaths")
        w.breaker.trip(now, reason="lease_revoked")
        _trace.instant("proc.worker_death", cat="proc", rid=rid,
                       pid=w.pid, generation=w.generation)
        _recorder.record("proc", "proc.worker_death",
                         f"rid={rid} pid={w.pid}")
        # reap: kill if somehow still alive (silent socket, live
        # process), then waitpid so no zombie accumulates
        if w.proc is not None:
            if w.proc.poll() is None:
                try:
                    w.proc.kill()
                except OSError:
                    pass
            try:
                w.proc.wait(timeout=5.0)
            except Exception:
                pass
        self._drop_connection(w)
        with self._lock:
            if w.ready_since is not None:
                w.live_s += max(0.0, now - w.ready_since)
                w.ready_since = None
            self._retire_telemetry(w)
        self._exhume_worker(w)
        # fail the dead worker's in-flight ledger rows over
        failovers = 0
        with self._lock:
            for entry in self._pending.values():
                if entry.rid == rid:
                    entry.rid = None
                    entry.failover = True
                    entry.reroutes += 1
                    entry.not_before = now
                    failovers += 1
            self._episodes.append(
                {"t0": now, "done": None, "failovers": failovers})
        if failovers:
            self.counts["failovers"] += failovers
            _metrics.count("proc.failovers", failovers)
        if self.auto_restart and w.restarts < self.max_restarts:
            w.restart_at = now + backoff_delay(
                w.restarts, base_s=self.restart_backoff_s,
                max_s=self.restart_backoff_max_s)

    def _exhume_worker(self, w):
        """Dig up the dead worker's black box and fold its event tail
        into the PARENT's flight recorder: the next post-mortem shows
        what the victim itself saw in its last seconds — the L2 dwell
        it held, the request it was serving — not just the router's
        outside view of the silence."""
        try:
            box = exhume_blackbox(self.run_dir, w.rid,
                                  max_generation=w.generation)
        except Exception:  # pragma: no cover - exhumation best-effort
            log.exception("black-box exhumation failed for rid %d",
                          w.rid)
            return
        if box is None:
            return
        w.blackbox = box
        self.counts["blackbox_exhumed"] += 1
        _metrics.count("proc.blackbox_exhumed")
        _recorder.record(
            "proc", "proc.blackbox_exhumed",
            f"rid={w.rid} g={box['generation']} "
            f"events={box['n_events']}"
            + (" torn_index" if box.get("torn_index") else ""))
        tail = [e for e in box["events"]
                if isinstance(e, dict) and e.get("kind") != "stage"][-32:]
        for e in tail:
            detail = e.get("detail")
            _recorder.record(
                e.get("kind", "proc"), str(e.get("name", "?")),
                f"[worker-{w.rid} g{box['generation']} t={e.get('t')}]"
                + ("" if detail is None else f" {detail}"))

    def _scan(self, now):
        with self._lock:
            entries = list(self._pending.values())
        for entry in entries:
            if entry.freq.done:
                continue
            if entry.freq.expired(time.perf_counter()):
                self._finish(entry, RequestResult(
                    STATUS_EXPIRED, error="deadline passed",
                    latency_s=now - entry.freq.submit_t), now)
                continue
            rid = entry.rid
            if rid is not None:
                w = self._workers.get(rid)
                if w is not None and w.dead:
                    with self._lock:
                        entry.rid = None
                        entry.failover = True
                        entry.reroutes += 1
                    rid = None
            if rid is None and now >= entry.not_before:
                self._route(entry, now)

    def _restart_due(self, now):
        for w in self._workers.values():
            if w.dead and w.restart_at is not None and now >= w.restart_at:
                w.restart_at = None
                w.restarts += 1
                self.counts["restarts"] += 1
                _metrics.count("proc.restarts")
                _trace.instant("proc.worker_restarted", cat="proc",
                               rid=w.rid, restarts=w.restarts)
                _recorder.record("proc", "proc.worker_restarted",
                                 f"rid={w.rid} restarts={w.restarts}")
                # trips persist: the restarted worker re-earns trust
                # through the breaker's half-open probe path
                self._spawn(w, now)

    # -- distributed observability plane ------------------------------------

    def register_tower(self, tower, *, slos=True, queue_depth_limit=None,
                       failover_budget_ms=1000.0):
        """Plug the fleet into an `obs.tower.ControlTower`: one
        ``router`` source (the parent's ledger counters), one
        ``worker-<rid>`` source per slot (live TELEMETRY snapshot +
        the retired ledger, so totals survive failover), the fleet
        signals (``proc.heartbeat_gap_s``, ``proc.queue_depth``,
        ``proc.failover_ms``) and — unless ``slos=False`` — the
        matching burn-rate SLOs (``proc_heartbeat_gap``,
        ``proc_queue_depth``, ``proc_failover``). The supervisor ticks
        the tower once registered, so sampling shares the fleet's
        supervision clock."""
        self._tower = tower
        tower.register_source("router", self._router_source,
                              kind="router")
        for rid in range(self.n_workers):
            tower.register_source(
                f"worker-{rid}",
                (lambda r=rid: self._worker_source(r)),
                kind="worker")
        tower.register_signal("proc.heartbeat_gap_s",
                              self._signal_heartbeat_gap)
        tower.register_signal(
            "proc.queue_depth", lambda: float(len(self._pending)))
        tower.register_signal("proc.failover_ms",
                              self._signal_failover_ms)
        if slos:
            fast = max(0.2, 10 * self.lease_interval_s)
            slow = 3 * fast
            if queue_depth_limit is None:
                queue_depth_limit = 8 * self.n_workers
            tower.add_slo(SLO(
                "proc_heartbeat_gap", "proc.heartbeat_gap_s",
                threshold=self.miss_revoke * self.lease_interval_s,
                direction="above", fast_s=fast, slow_s=slow, burn=0.5))
            tower.add_slo(SLO(
                "proc_queue_depth", "proc.queue_depth",
                threshold=float(queue_depth_limit),
                direction="above", fast_s=fast, slow_s=slow, burn=0.5))
            tower.add_slo(SLO(
                "proc_failover", "proc.failover_ms",
                threshold=float(failover_budget_ms),
                direction="above", fast_s=fast, slow_s=slow, burn=0.5))
        return tower

    def _router_source(self):
        """The parent's own telemetry source: ledger counters under a
        ``proc.router.`` prefix so they never collide with the workers'
        in-process ``proc.*`` metric names."""
        with self._lock:
            counters = {f"proc.router.{k}": v
                        for k, v in self.counts.items()}
        return {"counters": counters, "pid": os.getpid()}

    def _worker_source(self, rid):
        """One slot's telemetry source: the retired ledger (every dead
        generation's final snapshot) plus the live generation's latest
        TELEMETRY frame — monotone across restarts by construction."""
        w = self._workers.get(rid)
        with self._lock:
            led = self._retired.get(rid) or {}
            counters = dict(led.get("counters") or {})
            stages = {name: dict(st)
                      for name, st in (led.get("stages") or {}).items()}
            snap = w.telemetry if w is not None else None
            if isinstance(snap, dict):
                for name, v in (snap.get("counters") or {}).items():
                    if isinstance(v, (int, float)):
                        counters[name] = counters.get(name, 0) + v
                for name, st in (snap.get("stages") or {}).items():
                    if not isinstance(st, dict):
                        continue
                    agg = stages.setdefault(
                        name, {"count": 0, "total_s": 0.0})
                    agg["count"] += int(st.get("count", 0) or 0)
                    agg["total_s"] += float(st.get("total_s", 0.0) or 0.0)
        return {
            "counters": counters,
            "stages": stages,
            "pid": w.pid if w is not None else None,
            "generation": w.generation if w is not None else 0,
            "alive": bool(w is not None and not w.dead),
            "retired_generations": int(led.get("generations", 0)),
            "telemetry_frames": w.telemetry_frames if w is not None
            else 0,
            "last_stats": w.last_stats if w is not None else None,
        }

    def _signal_heartbeat_gap(self):
        """Seconds since the quietest live worker's last heartbeat —
        the wire-level liveness signal the SLO watches."""
        now = time.monotonic()
        with self._lock:
            gaps = [now - w.last_beat_t for w in self._workers.values()
                    if not w.dead and w.last_beat_t is not None]
        return max(gaps) if gaps else 0.0

    def _signal_failover_ms(self):
        """The latest COMPLETED failover episode's duration (0 with
        none yet) — burns the ``proc_failover`` SLO when recovery
        blows its budget."""
        with self._lock:
            for ep in reversed(self._episodes):
                if ep["done"] is not None and ep["failovers"]:
                    return (ep["done"] - ep["t0"]) * 1e3
        return 0.0

    def telemetry_coverage(self, now=None):
        """Fraction of worker live-seconds vouched for by TELEMETRY
        frames (clamped to [0, 1]; None before any worker went live).
        The ``procfleet.telemetry_coverage`` bench sentinel: a wire
        regression that drops frames shows up here before anyone
        misses the data."""
        now = time.monotonic() if now is None else now
        covered = 0.0
        live = 0.0
        with self._lock:
            for w in self._workers.values():
                covered += w.telemetry_covered_s
                live += w.live_s
                if w.ready_since is not None and not w.dead:
                    live += max(0.0, now - w.ready_since)
        if live <= 0.0:
            return None
        return max(0.0, min(1.0, covered / live))

    def merged_trace(self, labels=None):
        """ONE Perfetto timeline for the whole fleet: the router's own
        trace as the time base, every worker generation's atomically
        published timeline shifted onto it using the HELLO clock
        offsets (`obs.report.merge_traces`). Call BEFORE `stop()` —
        workers publish into the run dir, which stop() removes."""
        from ..obs.report import merge_traces

        traces = [_trace.export()]
        offsets = {}
        label_map = {os.getpid(): "router"}
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            for g, off in sorted(w.clock_offsets.items()):
                pid = off.get("pid")
                if pid is not None:
                    offsets[pid] = off
                    label_map.setdefault(pid, f"worker-{w.rid}.g{g}")
            for g in range(1, w.generation + 1):
                path = os.path.join(self.run_dir,
                                    f"trace-{w.rid}.g{g}.json")
                try:
                    with open(path) as fh:
                        traces.append(json.load(fh))
                except (OSError, ValueError):
                    continue
        if labels:
            label_map.update(labels)
        return merge_traces(traces, offsets=offsets, labels=label_map)

    def heartbeat_fields(self):
        """The fleet fields `obs.heartbeat.Heartbeat` stamps when a
        ProcessFleet rides along on a beat: live worker count, summed
        worker generations, open tower alerts (None without a tower)."""
        with self._lock:
            alive = sum(1 for w in self._workers.values() if not w.dead)
            gens = sum(w.generation for w in self._workers.values())
        return {
            "proc_workers": alive,
            "worker_generations": gens,
            "proc_open_alerts": (
                len(self._tower.open_alerts())
                if self._tower is not None else None),
        }

    # -- drill / operator surface -------------------------------------------

    def worker(self, rid):
        return self._workers[rid]

    def kill_worker(self, rid, sig=signal.SIGKILL):
        """Signal a worker process — the drill's real kill. Returns the
        signalled pid."""
        w = self._workers[rid]
        pid = w.pid
        os.kill(pid, sig)
        return pid

    def set_control(self, rid, **payload):
        """Send a ``CONTROL`` frame (e.g. ``dwell_l2_s=0.5`` arms the
        mid-L2-read kill window)."""
        w = self._workers[rid]
        with w.send_lock:
            ipc.send_frame(w.wsock, ipc.FRAME_CONTROL, payload,
                           deadline_s=self.frame_deadline_s)

    def dwell_flag_path(self, rid):
        return os.path.join(self.run_dir, f"l2_dwell_{rid}.flag")

    def publish_stream_state(self, *, stream_version=None, complete=True,
                             patching=False):
        """Re-stamp the cross-process stream-state file — flipping
        ``patching`` or bumping ``stream_version`` makes every worker's
        feed refuse (and recompute) on its next lookup, the same gates
        the in-process feed enforces."""
        if stream_version is None:
            stream_version = (self.spec.get("stream") or {}).get(
                "stream_version", 0)
        write_stream_state(
            os.path.join(self.run_dir, _STATE_FILE),
            stream_version=stream_version, complete=complete,
            patching=patching)

    def latencies_s(self):
        """The router-side latencies of the served requests, in the order
        they completed (the newest 4096 at most)."""
        with self._lock:
            return list(self._lats)

    def wait_ready(self, timeout_s=60.0, n=None):
        """Block until ``n`` (default: all) workers are ready."""
        need = self.n_workers if n is None else n
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if sum(1 for w in self._workers.values()
                   if w.ready and not w.dead) >= need:
                return True
            time.sleep(0.01)
        return False

    def _wait_booted(self, timeout_s):
        """`wait_ready` for the first boot: False at the deadline, or as
        soon as a worker's process has exited before it was ready (it
        never will be: boot failures are not restarted)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(w.ready and not w.dead for w in self._workers.values()):
                return True
            if any(not w.ready and w.proc is not None
                   and w.proc.poll() is not None
                   for w in self._workers.values()):
                return False
            time.sleep(0.01)
        return False

    def drain(self, timeout_s=30.0):
        """Wait for every ledger row to reach a terminal state."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not self._pending:
                    return True
            time.sleep(0.005)
        return False

    def stop(self, drain=True):
        """Drain the ledger (``drain``), send DRAIN to every connected
        worker and wait up to 5 s for it to exit; a worker that was not
        sent DRAIN (still booting, or its socket gone) is killed at once.
        Then reap every process and remove the run dir."""
        if drain:
            self.drain()
        self._stopping.set()
        sent = set()
        for w in self._workers.values():
            if w.wsock is not None and not w.dead:
                try:
                    with w.send_lock:
                        ipc.send_frame(w.wsock, ipc.FRAME_DRAIN, {},
                                       deadline_s=0.5)
                    sent.add(w.rid)
                except (ipc.WireError, OSError):
                    pass
        for w in self._workers.values():
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=5.0 if w.rid in sent else 0.01)
                except Exception:
                    try:
                        w.proc.kill()
                        w.proc.wait(timeout=2.0)
                    except Exception:
                        pass
            self._drop_connection(w)
        if self._supervisor is not None:
            self._supervisor.join(timeout=2.0)
        if self.run_dir is not None:
            shutil.rmtree(self.run_dir, ignore_errors=True)

    # -- stats ---------------------------------------------------------------

    def lost_requests(self):
        """Requests that never reached a terminal state and are no
        longer in the ledger — the zero-loss drill's headline number
        (0 or the drill failed). Requests still pending are not lost
        yet; drain first."""
        with self._lock:
            return (self.counts["requests"] - self.counts["completed"]
                    - len(self._pending))

    def stats(self, wall_s=None):
        with self._lock:
            lats = sorted(self._lats)
            pending = len(self._pending)
            episodes = [dict(e) for e in self._episodes]

        def q(p):
            if not lats:
                return 0.0
            return lats[min(len(lats) - 1, int(p * len(lats)))] * 1e3

        failover_ms = None
        for ep in episodes:
            if ep["done"] is not None and ep["failovers"]:
                ms = (ep["done"] - ep["t0"]) * 1e3
                failover_ms = ms if failover_ms is None else max(
                    failover_ms, ms)
        out = {
            "n_workers": self.n_workers,
            "pending": pending,
            "lost_requests": (self.counts["requests"]
                              - self.counts["completed"] - pending),
            "p50_ms": q(0.50),
            "p99_ms": q(0.99),
            "failover_ms": failover_ms,
            "failover_episodes": [
                {"failovers": ep["failovers"],
                 "ms": None if ep["done"] is None
                 else (ep["done"] - ep["t0"]) * 1e3}
                for ep in episodes
            ],
            **self.counts,
            "health": self._monitor.stats(),
            "breakers": {
                w.rid: w.breaker.stats() for w in self._workers.values()
            },
            "telemetry": {
                "frames": self.counts["telemetry_frames"],
                "zombie_frames": self.counts["telemetry_zombie"],
                "coverage": self.telemetry_coverage(),
                "retired_generations": sum(
                    led.get("generations", 0)
                    for led in self._retired.values()),
            },
            "clock_offsets": {
                str(w.rid): dict(w.clock_offset)
                for w in self._workers.values()
                if w.clock_offset is not None
            },
            "black_box": {
                "exhumed": [
                    {"rid": w.rid,
                     "generation": w.blackbox["generation"],
                     "n_events": w.blackbox["n_events"],
                     "torn_index": bool(w.blackbox.get("torn_index"))}
                    for w in self._workers.values()
                    if w.blackbox is not None
                ],
            },
            "per_worker": [
                {
                    "id": w.rid,
                    "pid": w.pid,
                    "alive": not w.dead,
                    "generation": w.generation,
                    "restarts": w.restarts,
                    "served": w.served,
                    "heartbeats": w.heartbeats,
                    "telemetry_frames": w.telemetry_frames,
                    "clock_offset": w.clock_offset,
                    "boot_s": {str(g): s for g, s in w.boot_s.items()},
                    "last_stats": w.last_stats,
                    "qps": (w.served / wall_s) if wall_s else None,
                }
                for w in self._workers.values()
            ],
        }
        return out


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _cmdline_matches(pid, marker=WORKER_MARKER):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as fh:
            cmdline = fh.read().replace(b"\x00", b" ").decode(
                "utf-8", "replace")
    except OSError:
        return False
    return marker in cmdline and "--worker" in cmdline


def main(argv=None):
    """``python -m swiftly_tpu_torch.serve.procfleet --worker ...`` — the
    worker-process entry the parent spawns."""
    import argparse

    parser = argparse.ArgumentParser(prog=WORKER_MARKER)
    parser.add_argument("--worker", action="store_true", required=True)
    parser.add_argument("--run-dir", required=True)
    parser.add_argument("--rid", type=int, required=True)
    parser.add_argument("--sock", required=True)
    parser.add_argument("--generation", type=int, default=1)
    args = parser.parse_args(argv)
    return _worker_main(args.run_dir, args.rid, args.sock,
                        generation=args.generation)


if __name__ == "__main__":  # pragma: no cover - subprocess entry
    sys.exit(main())
