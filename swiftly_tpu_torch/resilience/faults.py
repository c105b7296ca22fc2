"""Deterministic, seedable fault injection for resilience testing.

Multi-hour streamed transforms at 64k-128k scale make worker and I/O
failure an *expected* event (DaggerFFT, arXiv 2601.12209, schedules
recovery; large-scale linear algebra depends on resumable long jobs,
arXiv 2112.09017). This module is how the repo rehearses those events
on CPU in seconds: the engine's failure-prone sites — spill disk
read/write, host<->device transfers, checkpoint save/restore, serve
dispatch, backward feed — each call ``fault_point(site)``, and an
installed `FaultPlan` injects failures there on a deterministic
schedule.

**The clean path costs nothing.** With no plan installed (production),
``fault_point`` is one module-global ``None`` check and an immediate
return — the hooks compile away to no-ops exactly like the disabled
metrics registry (`obs.metrics`). Chaos is strictly opt-in via
``install(plan)`` / ``active(plan)`` or the ``SWIFTLY_FAULT_PLAN`` env
knob.

Fault kinds:

* ``ioerror``   — raise :class:`FaultError` (an ``IOError``; classified
  transient by `resilience.retry.is_transient`)
* ``oom``       — raise :class:`InjectedResourceExhausted` (message
  carries ``RESOURCE_EXHAUSTED`` so the engine's OOM ladders trigger)
* ``corrupt``   — bit-flip the payload: an ``ndarray`` payload returns
  a flipped copy; a file-path payload gets one byte flipped in place
  (checkpoint CRCs must catch it on restore)
* ``latency``   — sleep ``delay_s`` (SLO/backpressure drills)
* ``kill``      — raise :class:`WorkerKilled` (a ``BaseException``:
  it tears through every ``except Exception`` isolation layer, the
  way a real SIGKILL would — only an explicit drill harness catches it)
* ``shard_loss`` — raise :class:`ShardLostError` (an ``Exception``,
  unlike ``kill``: losing ONE shard of a mesh is a survivable,
  *recoverable* event — the elastic recovery ladder catches it,
  re-plans the layout on the survivors and resumes; it is deliberately
  NOT transient-classified, because retrying the same collective on
  the same dead mesh cannot succeed)

Schedules are per-site call-indexed and deterministic: ``at`` fires on
the Nth call to the site (0-based), ``every`` fires periodically, ``p``
fires probabilistically from the plan's seeded RNG — same seed, same
plan, same run, same faults. Every injection is counted
(``fault.injected`` / ``fault.injected.<site>`` via obs) and recorded
in ``plan.injected`` for the resilience artifact block.

Known sites (see docs/resilience.md for the full table):
``spill.write``, ``spill.read``, ``spill.get_row``, ``transfer.h2d``,
``transfer.d2h``, ``checkpoint.save``, ``checkpoint.save.done``,
``checkpoint.restore``, ``serve.dispatch``, ``bwd.feed``,
``fleet.replica.kill`` (every replica pump iteration — ``kill`` here
is simulated chip death), ``fleet.health.probe`` (each active health
probe), ``fleet.route`` (every fleet routing decision),
``mesh.psum`` (the mesh engine's one collective per column group —
``latency`` here simulates a stalled all-reduce for the watchdog,
``shard_loss`` a device dropping out of it), ``mesh.ring_step``
(the same collective site when SWIFTLY_MESH_COLLECTIVE=ring schedules
the ppermute pipeline — a stalled ring step raises
``CollectiveStalledError`` and the re-plan ladder rebuilds on
survivors with the ring re-resolved for the new shard count),
``mesh.feed`` (each
mesh backward group feed), ``mesh.shard_loss`` (each mesh forward
column-group yield — the canonical site for killing one of N virtual
shards mid-stream).

The port of the JAX package's ``swiftly_tpu/resilience/faults.py``,
unchanged in behaviour: the same (spec, seed) fires at the same site
calls in both packages. The port's executors call the sites
``spill.write``, ``spill.read``, ``spill.get_row``, ``transfer.h2d``,
``transfer.d2h``, ``checkpoint.save``, ``checkpoint.save.done``,
``checkpoint.restore`` and ``bwd.feed``; the fleet's serve sites and the
mesh engine's ``mesh.shard_loss``, ``mesh.feed``, ``mesh.psum`` and
``mesh.ring_step`` (`swiftly_tpu_torch.mesh`) the others.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import threading
import time

from ..obs import metrics as _metrics
from ..obs import recorder as _recorder
from ..obs import trace as _trace

__all__ = [
    "KINDS",
    "FaultError",
    "FaultPlan",
    "InjectedResourceExhausted",
    "ShardLostError",
    "WorkerKilled",
    "active",
    "corrupt_array",
    "corrupt_file",
    "current",
    "fault_point",
    "install",
    "plan_from_env",
    "uninstall",
]

KINDS = ("ioerror", "oom", "corrupt", "latency", "kill", "shard_loss")


class FaultError(IOError):
    """An injected I/O failure (transient by classification)."""


class InjectedResourceExhausted(RuntimeError):
    """An injected allocator failure; message carries RESOURCE_EXHAUSTED
    so `bench._is_oom`-style ladders treat it like the real thing."""


class WorkerKilled(BaseException):
    """Simulated worker death. Deliberately NOT an ``Exception``: retry
    wrappers and isolation layers must not absorb it — only a drill
    harness that then exercises the resume path catches it."""


class ShardLostError(RuntimeError):
    """One shard of a mesh dropped out mid-stream.

    Unlike :class:`WorkerKilled` this IS an ``Exception`` — a single
    shard loss on an N-device mesh is survivable, and the elastic
    recovery ladder (``mesh.recovery``) is built to catch it, re-plan
    the layout on the surviving devices and resume from the last
    autosave. It carries no transient marker and is not an
    ``OSError``, so `resilience.retry.is_transient` correctly refuses
    to retry it in place: the same collective on the same broken mesh
    can never succeed, only a re-planned one can.

    :param shard: the lost shard's index when known, else None.
    """

    def __init__(self, message, shard=None):
        super().__init__(message)
        self.shard = shard


def corrupt_array(arr, rng=None):
    """A copy of `arr` with one bit flipped (position from `rng`)."""
    import numpy as np

    out = np.array(arr)
    flat = out.view(np.uint8).reshape(-1)
    if flat.size:
        r = rng or random
        i = r.randrange(flat.size) if hasattr(r, "randrange") else 0
        flat[i] ^= 1 << (r.randrange(8) if hasattr(r, "randrange") else 0)
    return out


def corrupt_file(path, rng=None):
    """Flip one byte of the file at `path` in place (returns `path`).

    The position avoids the first/last 64 bytes when possible so the
    flip lands in array data (exercising CRC verification) rather than
    always in the zip directory.
    """
    size = os.path.getsize(path)
    if size == 0:
        return path
    lo, hi = (64, size - 64) if size > 192 else (0, size)
    r = rng or random
    pos = r.randrange(lo, hi) if hi > lo else 0
    with open(path, "r+b") as fh:
        fh.seek(pos)
        byte = fh.read(1)
        fh.seek(pos)
        fh.write(bytes([byte[0] ^ 0xFF]))
    return path


class _Rule:
    __slots__ = ("site", "kind", "at", "every", "p", "times", "delay_s",
                 "fired")

    def __init__(self, spec):
        self.site = spec["site"]
        self.kind = spec.get("kind", "ioerror")
        if self.kind not in KINDS:
            raise ValueError(
                f"fault kind {self.kind!r} not in {KINDS}"
            )
        self.at = spec.get("at")
        self.every = spec.get("every")
        self.p = spec.get("p")
        if self.at is None and self.every is None and self.p is None:
            raise ValueError(
                f"fault rule for {self.site!r} needs one of at/every/p"
            )
        # `at` fires once by default; every/p keep firing unless capped
        default_times = 1 if self.at is not None else None
        self.times = spec.get("times", default_times)
        self.delay_s = float(spec.get("delay_s", 0.05))
        self.fired = 0

    def spec(self):
        out = {"site": self.site, "kind": self.kind}
        for f in ("at", "every", "p"):
            v = getattr(self, f)
            if v is not None:
                out[f] = v
        if self.times is not None:
            out["times"] = self.times
        if self.kind == "latency":
            out["delay_s"] = self.delay_s
        return out

    def matches(self, n, rng):
        if self.times is not None and self.fired >= self.times:
            return False
        if self.at is not None and n == self.at:
            return True
        if self.every is not None and self.every > 0 and n % self.every == 0:
            return True
        if self.p is not None and rng.random() < self.p:
            return True
        return False


class FaultPlan:
    """A deterministic schedule of injected faults over named sites.

    :param faults: iterable of rule dicts — ``{"site": ..., "kind": ...,
        "at"/"every"/"p": ..., "times": ..., "delay_s": ...}``
    :param seed: seeds the plan RNG (probabilistic rules and bit-flip
        positions) — the whole plan is replayable from (faults, seed)
    """

    def __init__(self, faults=(), seed=0):
        self.seed = int(seed)
        self.rules = [
            r if isinstance(r, _Rule) else _Rule(dict(r)) for r in faults
        ]
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self.calls = {}  # site -> call count
        self.injected = []  # [(site, kind, call_index), ...]

    @classmethod
    def from_spec(cls, spec):
        """Build from a JSON-able dict ``{"seed": ..., "faults": [...]}``
        (or a bare fault list)."""
        if isinstance(spec, (list, tuple)):
            return cls(faults=spec)
        return cls(faults=spec.get("faults", ()), seed=spec.get("seed", 0))

    def spec(self):
        return {"seed": self.seed, "faults": [r.spec() for r in self.rules]}

    def fire(self, site, payload=None):
        """One site call: match rules, inject at most one fault."""
        with self._lock:
            n = self.calls.get(site, 0)
            self.calls[site] = n + 1
            hit = None
            for rule in self.rules:
                if rule.site == site and rule.matches(n, self._rng):
                    rule.fired += 1
                    hit = rule
                    break
            if hit is not None:
                self.injected.append((site, hit.kind, n))
        if hit is None:
            return payload
        _metrics.count("fault.injected")
        _metrics.count(f"fault.injected.{site}")
        _metrics.event("fault", site=site, fault_kind=hit.kind, call=n)
        # a chaos-drill trace shows WHERE the run was hit: each
        # injection is an instant event on the recorded timeline
        _trace.instant("fault.injected", cat="fault", site=site,
                       fault_kind=hit.kind, call=n)
        # the black box keeps injections even with tracing off — a
        # post-mortem must show what was fired before the trigger raise
        _recorder.record("fault", f"fault.injected.{site}",
                         f"{hit.kind} call {n}")
        if hit.kind == "ioerror":
            raise FaultError(f"injected IOError at {site} (call {n})")
        if hit.kind == "oom":
            raise InjectedResourceExhausted(
                f"RESOURCE_EXHAUSTED: injected allocator failure at "
                f"{site} (call {n})"
            )
        if hit.kind == "kill":
            raise WorkerKilled(f"injected worker death at {site} (call {n})")
        if hit.kind == "shard_loss":
            raise ShardLostError(
                f"injected shard loss at {site} (call {n})"
            )
        if hit.kind == "latency":
            time.sleep(hit.delay_s)
            return payload
        # corrupt: bit-flip the payload (array copy or file in place)
        if payload is None:
            return payload
        if isinstance(payload, (str, os.PathLike)):
            return corrupt_file(payload, self._rng)
        return corrupt_array(payload, self._rng)

    def stats(self):
        """JSON-ready injection summary for resilience artifacts."""
        with self._lock:
            by_site = {}
            by_kind = {}
            for site, kind, _n in self.injected:
                by_site[site] = by_site.get(site, 0) + 1
                by_kind[kind] = by_kind.get(kind, 0) + 1
            return {
                "total": len(self.injected),
                "by_site": by_site,
                "by_kind": by_kind,
                "seed": self.seed,
            }


# ---------------------------------------------------------------------------
# The installed plan. `fault_point` is on hot paths (per-group transfers):
# the disabled check must stay one global read + None test.
# ---------------------------------------------------------------------------

_ACTIVE = None


def fault_point(site, payload=None):
    """Hook one failure-prone call site; returns `payload` (possibly
    corrupted). A no-op returning `payload` unchanged when no plan is
    installed — the production fast path."""
    plan = _ACTIVE
    if plan is None:
        return payload
    return plan.fire(site, payload)


def current():
    return _ACTIVE


def install(plan):
    """Install `plan` process-wide (None uninstalls). Returns the plan."""
    global _ACTIVE
    _ACTIVE = plan
    return plan


def uninstall():
    global _ACTIVE
    _ACTIVE = None


@contextlib.contextmanager
def active(plan):
    """Scoped installation: the plan applies inside the block only."""
    prev = _ACTIVE
    install(plan)
    try:
        yield plan
    finally:
        install(prev)


def plan_from_env():
    """The `FaultPlan` named by ``SWIFTLY_FAULT_PLAN`` (inline JSON, or
    ``@/path/to/plan.json``), or None when unset. Not auto-installed —
    chaos entry points (``bench.py --chaos``, scripts/chaos_drill.py)
    install it explicitly so a stray env var can never fault a
    production run that did not ask for chaos."""
    raw = os.environ.get("SWIFTLY_FAULT_PLAN")
    if not raw:
        return None
    if raw.startswith("@"):
        with open(raw[1:]) as fh:
            raw = fh.read()
    return FaultPlan.from_spec(json.loads(raw))
