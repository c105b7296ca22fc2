"""Run provenance: the manifest stamped into every artifact of a run, and
the artifact-block validators.

The port of the JAX package's ``swiftly_tpu/obs/manifest.py``: the same
schema, ``config_hash`` and ``validate_*`` functions, with the device
facts read from ``torch.cuda`` (``platform: "gpu"``, the card's name and
count, and its power limit where ``nvidia-smi`` answers) and the versions
of torch, CUDA and the ``nvcc`` that builds the port's kernels in place
of jax's. ``baseline_source`` says where a run's baseline came from:

* ``"measured"``  -- the reference ran on this machine this run;
* ``"operator"``  -- supplied by the operator (``BENCH_NUMPY_BASELINE_S``),
  auditable through the env capture;
* ``"estimated"`` -- extrapolated from timed sub-operations.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import subprocess
import sys
import time

__all__ = [
    "BASELINE_SOURCES",
    "CACHE_ARTIFACT_FIELDS",
    "DELTA_ARTIFACT_FIELDS",
    "FLEET_ARTIFACT_FIELDS",
    "MANIFEST_SCHEMA",
    "MESH_ARTIFACT_FIELDS",
    "PLAN_ARTIFACT_FIELDS",
    "PROCFLEET_ARTIFACT_FIELDS",
    "RESILIENCE_ARTIFACT_FIELDS",
    "SERVE_ARTIFACT_FIELDS",
    "config_hash",
    "run_manifest",
    "validate_artifact",
    "validate_delta_artifact",
    "validate_fleet_artifact",
    "validate_mesh_artifact",
    "validate_plan_artifact",
    "validate_procfleet_artifact",
    "validate_resilience_artifact",
    "validate_serve_artifact",
]

MANIFEST_SCHEMA = "swiftly-tpu-run-manifest/1"

BASELINE_SOURCES = ("measured", "operator", "estimated")

# Env prefixes that change what the engine executes (captured verbatim);
# anything else in the environment is noise for reproduction purposes.
_ENV_PREFIXES = ("SWIFTLY_", "BENCH_", "CUDA_", "PYTORCH_", "TORCH_",
                 "NVIDIA_", "OMP_")


def _git_revision(path):
    """(sha, dirty) of the repo containing `path`, or (None, None)."""
    try:
        cwd = os.path.dirname(os.path.abspath(path))
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=10,
        )
        if sha.returncode != 0:
            return None, None
        status = subprocess.run(
            ["git", "status", "--porcelain"], cwd=cwd,
            capture_output=True, text=True, timeout=10,
        )
        dirty = bool(status.stdout.strip()) if status.returncode == 0 else None
        return sha.stdout.strip(), dirty
    except Exception:  # pragma: no cover - no git binary
        return None, None


def config_hash(params) -> str:
    """Deterministic short hash of a config/parameter mapping."""
    blob = json.dumps(params, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _power_limit():
    """(name, power limit) of card 0 as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them, or (None, None) where
    the command is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except Exception:  # no nvidia-smi on this machine
        return None, None
    lines = out.stdout.strip().splitlines() if out.returncode == 0 else []
    if not lines:
        return None, None
    name, _, limit = lines[0].partition(",")
    return name.strip(), limit.strip() or None


def _device_info():
    """The card the run used: ``platform`` "gpu" with the name of CUDA
    device 0 and the device count, or "cpu" where CUDA is unavailable;
    on the card also ``power_limit`` as ``nvidia-smi`` prints it."""
    try:
        import torch

        if not torch.cuda.is_available():
            return {"platform": "cpu", "kind": "cpu", "count": 1}
        info = {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }
    except Exception:  # no usable torch/CUDA runtime
        return {"platform": None, "kind": None, "count": 0}
    _name, limit = _power_limit()
    if limit is not None:
        info["power_limit"] = limit
    return info


def _versions():
    """torch's, its CUDA's and the kernels' ``nvcc``'s versions (None where
    absent)."""
    try:
        import torch

        torch_v, cuda_v = torch.__version__, torch.version.cuda
    except Exception:  # pragma: no cover - torch is a dependency
        torch_v, cuda_v = None, None
    nvcc_v = None
    try:
        from ..ops import _build

        out = subprocess.run([_build.find_nvcc(), "--version"],
                             capture_output=True, text=True, timeout=30)
        tail = out.stdout.strip().splitlines()
        nvcc_v = tail[-1] if out.returncode == 0 and tail else None
    except Exception:  # no nvcc on this machine (RuntimeError, OSError)
        nvcc_v = None
    return {"torch": torch_v, "cuda": cuda_v, "nvcc": nvcc_v}


def run_manifest(baseline_source=None, params=None, extra=None) -> dict:
    """The full provenance record for one run/artifact.

    :param baseline_source: one of ``BASELINE_SOURCES`` (or None when
        the artifact carries no baseline comparison at all)
    :param params: the config parameter mapping the run executed
        (hashed into ``config_hash`` and recorded verbatim)
    :param extra: caller fields merged in at top level (must not
        collide with schema fields)
    """
    if baseline_source is not None and baseline_source not in BASELINE_SOURCES:
        raise ValueError(
            f"baseline_source must be one of {BASELINE_SOURCES}, "
            f"got {baseline_source!r}"
        )
    sha, dirty = _git_revision(__file__)
    env = {
        k: v
        for k, v in sorted(os.environ.items())
        if k.startswith(_ENV_PREFIXES)
    }
    import numpy as np

    # the tracing state is recorded explicitly (not just via the env
    # capture): a programmatic trace.enable(path) leaves no env trail,
    # but the artifact must still name the timeline it belongs to
    from . import trace as _trace_mod

    manifest = {
        "schema": MANIFEST_SCHEMA,
        "timestamp_utc": time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
        ),
        "hostname": platform.node(),
        "platform": platform.platform(),
        "python": sys.version.split()[0],
        **_versions(),
        "numpy": np.__version__,
        "device": _device_info(),
        "git_sha": sha,
        "git_dirty": dirty,
        "argv": list(sys.argv),
        "env": env,
        "baseline_source": baseline_source,
        "trace": {
            "enabled": bool(_trace_mod.enabled()),
            "path": _trace_mod.path(),
        },
    }
    if params is not None:
        manifest["config_params"] = dict(params)
        manifest["config_hash"] = config_hash(params)
    if extra:
        overlap = set(extra) & set(manifest)
        if overlap:
            raise ValueError(f"extra fields collide with schema: {overlap}")
        manifest.update(extra)
    return manifest


# Fields every stamped manifest must carry (schema check for the
# bench --smoke leg and the obs tests).
_REQUIRED_MANIFEST_FIELDS = (
    "schema", "timestamp_utc", "device", "git_sha", "env",
    "baseline_source",
)


def validate_artifact(record, require_baseline=True):
    """Problems with a BENCH-style artifact record, as a list of strings.

    An empty list means the record passes: it carries a complete
    manifest, a valid ``baseline_source``, and (for measured legs) the
    headline metric fields. Used by the smoke runs and the
    schema tests — schema drift fails fast instead of surfacing as an
    unauditable artifact months later.
    """
    problems = []
    if not isinstance(record, dict):
        return [f"record is {type(record).__name__}, expected dict"]
    manifest = record.get("manifest")
    if not isinstance(manifest, dict):
        problems.append("missing manifest")
        manifest = {}
    for field in _REQUIRED_MANIFEST_FIELDS:
        if field not in manifest:
            problems.append(f"manifest missing field {field!r}")
    if manifest.get("schema") not in (None, MANIFEST_SCHEMA):
        problems.append(
            f"manifest schema {manifest.get('schema')!r} != "
            f"{MANIFEST_SCHEMA!r}"
        )
    if require_baseline:
        src = record.get("baseline_source", manifest.get("baseline_source"))
        if src not in BASELINE_SOURCES:
            problems.append(
                f"baseline_source {src!r} not in {BASELINE_SOURCES}"
            )
    for field in ("metric", "value", "unit"):
        if field not in record:
            problems.append(f"missing metric field {field!r}")
    return problems


# The latency-SLO block every `bench.py --serve` artifact must carry
# (`SubgridService.stats()` flattened into the record) — the serving
# workload's schema contract, guarded by the --serve --smoke leg the
# same way validate_artifact guards the batch legs.
SERVE_ARTIFACT_FIELDS = (
    "p50_ms",
    "p99_ms",
    "shed_rate",
    "coalesce_hit_rate",
    "throughput_rps",
    "n_requests",
    "n_served",
)


def validate_serve_artifact(record):
    """Problems with a serve-mode BENCH artifact, as a list of strings.

    Serving legs carry no numpy baseline (there is no reference serving
    implementation to race) but must carry the full manifest plus the
    SLO metric block, with rates in [0, 1] and a coherent latency
    ordering — schema drift in the serving telemetry fails in seconds
    on CPU, not in a production latency regression nobody can read.

    One of the serving-family validators (`validate_serve_artifact`,
    `validate_fleet_artifact`, `validate_vis_artifact`): all three
    share the manifest + latency-ordering + bit-identity checks and
    differ in the workload block they enforce.
    """
    problems = validate_artifact(record, require_baseline=False)
    for field in SERVE_ARTIFACT_FIELDS:
        if field not in record:
            problems.append(f"missing serve field {field!r}")
    for rate in ("shed_rate", "coalesce_hit_rate"):
        v = record.get(rate)
        if v is not None and not (0.0 <= v <= 1.0):
            problems.append(f"{rate} {v!r} outside [0, 1]")
    p50, p99 = record.get("p50_ms"), record.get("p99_ms")
    if (
        isinstance(p50, (int, float))
        and isinstance(p99, (int, float))
        and p99 < p50
    ):
        problems.append(f"p99_ms {p99} < p50_ms {p50}")
    if record.get("n_served") and not record.get("throughput_rps"):
        problems.append("served requests but no throughput_rps")
    bit = record.get("bit_identical")
    if not isinstance(bit, dict) or not (
        {"checked", "mismatches"} <= set(bit)
    ):
        problems.append(
            "missing bit_identical {checked, mismatches} block"
        )
    journey = record.get("journey")
    if isinstance(journey, dict):
        # the request-journey decomposition must partition the served
        # wall: segment shares sum to 1 (each segment is a contiguous
        # timestamp diff of the same per-request interval)
        shares = [
            journey[seg]["share"]
            for seg in ("queue", "compute", "transfer")
            if isinstance(journey.get(seg), dict)
            and "share" in journey[seg]
        ]
        if len(shares) != 3:
            problems.append(
                "journey block missing queue/compute/transfer segments"
            )
        elif not 0.99 <= sum(shares) <= 1.01:
            problems.append(
                f"journey segment shares sum to {sum(shares)}, not 1"
            )
    return problems


# The visibility block every `bench.py --vis` artifact must carry
# (`VisibilityService.stats()` plus the accuracy/adjoint/grid audits)
# — the visibility-serving schema contract, guarded by the --vis
# --smoke leg like the serve/fleet families above.
VIS_ARTIFACT_FIELDS = (
    "p50_ms",
    "p99_ms",
    "shed_rate",
    "coalesce_hit_rate",
    "throughput_ksamples_s",
    "n_requests",
    "n_samples",
    "n_served_samples",
    "degrid_rms",
    "kernel",
    "adjoint",
    "grid",
)


def validate_vis_artifact(record):
    """Problems with a vis-mode BENCH artifact, as a list of strings.

    Visibility legs are audited against the direct-DFT oracle instead
    of a numpy baseline race, so beyond the manifest + SLO checks of
    the serve family this validator enforces the ACCURACY contract:
    ``degrid_rms`` within the stamped kernel's ``tolerance``
    (`vis.kernel.DEGRID_TOLERANCE`), the adjoint dot-product identity
    within its own tolerance, and a gridding block showing the batch
    round-tripped into the backward ingest — a vis artifact that
    serves fast but wrong must fail validation, not ship.
    """
    problems = validate_artifact(record, require_baseline=False)
    vis = record.get("vis")
    if not isinstance(vis, dict):
        problems.append("missing vis block")
        return problems
    for field in VIS_ARTIFACT_FIELDS:
        if field not in vis:
            problems.append(f"missing vis field {field!r}")
    for rate in ("shed_rate", "coalesce_hit_rate"):
        v = vis.get(rate)
        if v is not None and not (0.0 <= v <= 1.0):
            problems.append(f"vis {rate} {v!r} outside [0, 1]")
    p50, p99 = vis.get("p50_ms"), vis.get("p99_ms")
    if (
        isinstance(p50, (int, float))
        and isinstance(p99, (int, float))
        and p99 < p50
    ):
        problems.append(f"vis p99_ms {p99} < p50_ms {p50}")
    if vis.get("n_served_samples") and not vis.get(
        "throughput_ksamples_s"
    ):
        problems.append("served samples but no throughput_ksamples_s")
    kernel = vis.get("kernel")
    if not isinstance(kernel, dict) or not (
        {"support", "oversample", "band", "tolerance"} <= set(kernel)
    ):
        problems.append(
            "missing kernel {support, oversample, band, tolerance} "
            "block"
        )
        kernel = {}
    rms = vis.get("degrid_rms")
    tol = kernel.get("tolerance")
    if (
        isinstance(rms, (int, float))
        and isinstance(tol, (int, float))
        and rms > tol
    ):
        problems.append(
            f"degrid_rms {rms} exceeds the kernel tolerance {tol}"
        )
    adjoint = vis.get("adjoint")
    if not isinstance(adjoint, dict) or not (
        {"rel_err", "tolerance"} <= set(adjoint)
    ):
        problems.append("missing adjoint {rel_err, tolerance} block")
    elif adjoint["rel_err"] > adjoint["tolerance"]:
        problems.append(
            f"adjoint rel_err {adjoint['rel_err']} exceeds "
            f"{adjoint['tolerance']}"
        )
    grid = vis.get("grid")
    if not isinstance(grid, dict) or not (
        {"n_gridded", "ingested"} <= set(grid)
    ):
        problems.append("missing grid {n_gridded, ingested} block")
    elif grid.get("n_gridded") and not grid.get("ingested"):
        problems.append(
            "gridded samples never ingested into the backward "
            "(add_subgrid_group round-trip missing)"
        )
    bit = record.get("bit_identical")
    if not isinstance(bit, dict) or not (
        {"checked", "mismatches"} <= set(bit)
    ):
        problems.append(
            "missing bit_identical {checked, mismatches} block"
        )
    journey = vis.get("journey")
    if isinstance(journey, dict):
        shares = [
            journey[seg]["share"]
            for seg in ("queue", "compute", "transfer")
            if isinstance(journey.get(seg), dict)
            and "share" in journey[seg]
        ]
        if len(shares) != 3:
            problems.append(
                "vis journey block missing queue/compute/transfer "
                "segments"
            )
        elif not 0.99 <= sum(shares) <= 1.01:
            problems.append(
                f"vis journey segment shares sum to {sum(shares)}, "
                "not 1"
            )
    return problems


# The fleet block every `bench.py --fleet` artifact must carry — the
# self-healing serve drill's schema contract: the kill/restore cycle
# (replica deaths, failovers, restores), the full breaker cycle, the
# p99 before/during/after windows, and zero-loss + bit-identity.
FLEET_ARTIFACT_FIELDS = (
    "p50_ms",
    "p99_ms",
    "throughput_rps",
    "n_requests",
    "n_served",
)

_FLEET_BLOCK_FIELDS = (
    "n_replicas",
    "failovers",
    "replica_deaths",
    "restores",
    "zero_lost",
    "p99_before_ms",
    "p99_during_ms",
    "p99_after_ms",
    "breaker_cycle",
    "per_replica",
    "brownout",
    "health_transitions",
)


def validate_fleet_artifact(record):
    """Problems with a fleet-mode BENCH artifact, as a list of strings.

    Fleet legs carry no numpy baseline (nothing is raced) but must
    carry the full manifest, the fleet-wide latency/QPS block, and a
    coherent ``fleet`` drill block: at least one replica killed and
    restored, its breaker showing the full open → half-open → closed
    cycle, a per-replica QPS table covering the whole fleet,
    ``zero_lost`` True and a clean bit-identity audit — a failover
    drill that dropped or corrupted a request is a correctness bug,
    not an availability result. Serving-family sibling of
    `validate_serve_artifact` / `validate_vis_artifact`.
    """
    problems = validate_artifact(record, require_baseline=False)
    for field in FLEET_ARTIFACT_FIELDS:
        if field not in record:
            problems.append(f"missing fleet field {field!r}")
    p50, p99 = record.get("p50_ms"), record.get("p99_ms")
    if (
        isinstance(p50, (int, float))
        and isinstance(p99, (int, float))
        and p99 < p50
    ):
        problems.append(f"p99_ms {p99} < p50_ms {p50}")
    bit = record.get("bit_identical")
    if not isinstance(bit, dict) or not (
        {"checked", "mismatches"} <= set(bit)
    ):
        problems.append(
            "missing bit_identical {checked, mismatches} block"
        )
    elif bit["mismatches"]:
        problems.append(
            f"bit-identity audit failed: {bit['mismatches']} "
            f"mismatch(es) in {bit['checked']} checked"
        )
    fleet = record.get("fleet")
    if not isinstance(fleet, dict):
        problems.append("missing fleet block")
        return problems
    for field in _FLEET_BLOCK_FIELDS:
        if field not in fleet:
            problems.append(f"fleet block missing {field!r}")
    n = fleet.get("n_replicas")
    if isinstance(n, int) and n < 2:
        problems.append(
            f"n_replicas {n} < 2 (a one-replica fleet cannot fail over)"
        )
    if isinstance(fleet.get("replica_deaths"), int):
        if fleet["replica_deaths"] < 1:
            problems.append("fleet drill killed no replica")
    if isinstance(fleet.get("restores"), int) and fleet["restores"] < 1:
        problems.append("fleet drill restored no replica")
    if fleet.get("zero_lost") is not True:
        problems.append(
            f"zero_lost is {fleet.get('zero_lost')!r}: the drill must "
            "complete every admitted request"
        )
    cycle = fleet.get("breaker_cycle")
    if isinstance(cycle, list):
        missing = {"open", "half_open", "closed"} - set(cycle)
        if missing:
            problems.append(
                f"breaker cycle {cycle} missing state(s) "
                f"{sorted(missing)} — the victim's breaker must open, "
                "half-open and close in the artifact"
            )
    per = fleet.get("per_replica")
    if isinstance(per, list):
        if isinstance(n, int) and len(per) != n:
            problems.append(
                f"per_replica has {len(per)} row(s) for {n} replicas"
            )
        for row in per:
            if not isinstance(row, dict) or not (
                {"id", "served", "qps"} <= set(row)
            ):
                problems.append(
                    "per_replica rows need {id, served, qps}"
                )
                break
    for field in ("p99_before_ms", "p99_during_ms", "p99_after_ms"):
        v = fleet.get(field)
        if v is not None and (
            not isinstance(v, (int, float)) or v < 0
        ):
            problems.append(f"{field} {v!r} is not a latency")
    problems.extend(_validate_cache_block(record, fleet))
    return problems


# The shared-cache-fabric block a fabric-backed `bench.py --fleet`
# artifact carries (`cache.SharedStreamTier.stats` plus the QPS
# equivalence audit) — the fabric's schema contract: exactly ONE
# resident stream copy, a coherent hit/miss ledger, and per-view rows.
CACHE_ARTIFACT_FIELDS = (
    "resident_stream_copies",
    "stream_version",
    "views",
    "l1_hits",
    "l2_hits",
    "misses",
    "hit_ratio",
    "dedup_hits",
    "per_view",
)


def _validate_cache_block(record, fleet):
    """Problems with a fleet artifact's ``cache`` (fabric) block. The
    block is optional — pre-fabric fleet artifacts validate as before —
    but when present it must show one resident stream copy and a
    coherent hit ledger, and the fleet block must agree."""
    cache = record.get("cache")
    if cache is None:
        return []
    problems = []
    if not isinstance(cache, dict):
        return ["cache block is not a dict"]
    for field in CACHE_ARTIFACT_FIELDS:
        if field not in cache:
            problems.append(f"cache block missing {field!r}")
    copies = cache.get("resident_stream_copies")
    if copies is not None and copies != 1:
        problems.append(
            f"resident_stream_copies is {copies!r}: the fabric's whole "
            "contract is ONE resident stream across the fleet"
        )
    fleet_copies = fleet.get("stream_copies")
    if fleet_copies is not None and copies == 1 and fleet_copies != 1:
        problems.append(
            f"fleet.stream_copies {fleet_copies!r} disagrees with the "
            "cache block's one resident copy"
        )
    ratio = cache.get("hit_ratio")
    if ratio is not None and (
        not isinstance(ratio, (int, float)) or not 0.0 <= ratio <= 1.0
    ):
        problems.append(f"hit_ratio {ratio!r} is not in [0, 1]")
    for field in ("l1_hits", "l2_hits", "misses", "dedup_hits"):
        v = cache.get(field)
        if v is not None and (not isinstance(v, int) or v < 0):
            problems.append(f"cache {field} {v!r} is not a count")
    served = (
        cache.get("l1_hits", 0) + cache.get("l2_hits", 0)
        + cache.get("misses", 0)
    )
    if isinstance(ratio, (int, float)) and served == 0 and ratio:
        problems.append(
            f"hit_ratio {ratio} with an empty hit/miss ledger"
        )
    per_view = cache.get("per_view")
    if isinstance(per_view, list):
        views = cache.get("views")
        if isinstance(views, int) and len(per_view) != views:
            problems.append(
                f"per_view has {len(per_view)} row(s) for "
                f"{views} view(s)"
            )
        for row in per_view:
            if not isinstance(row, dict) or not (
                {"replica", "l1_hits", "l2_hits"} <= set(row)
            ):
                problems.append(
                    "per_view rows need {replica, l1_hits, l2_hits}"
                )
                break
    return problems


PROCFLEET_ARTIFACT_FIELDS = (
    "p50_ms",
    "p99_ms",
    "throughput_rps",
    "n_requests",
    "n_served",
)

_PROCFLEET_BLOCK_FIELDS = (
    "n_workers",
    "worker_deaths",
    "restarts",
    "failovers",
    "lost_requests",
    "failover_ms",
    "breaker_cycle",
    "per_worker",
    "health_transitions",
    "orphans",
    "mid_l2_kill",
    "wire",
    "telemetry",
    "clock_offsets",
    "trace_merge",
    "black_box",
)


def validate_procfleet_artifact(record):
    """Problems with a process-fleet BENCH artifact (``--procfleet``),
    as a list of strings.

    The process drill's contract is the thread fleet's, survived for
    real: at least one worker ``SIGKILL``ed and restarted, its breaker
    showing the full open → half-open → closed cycle, ``lost_requests``
    exactly 0, ``failover_ms`` a real measurement, a clean bit-identity
    audit, a ``mid_l2_kill`` phase that landed its kill inside an L2
    read and still served the row bit-identically, and a ``wire`` block
    whose heartbeats actually flowed (a drill whose leases never beat
    proved nothing).

    The distributed observability plane extends the contract: a
    ``fleet_telemetry`` block whose cross-process totals sum exactly
    (`obs.tower.validate_fleet_telemetry_artifact`), a ``telemetry``
    block with frames flowing and coverage in [0, 1], HELLO-estimated
    ``clock_offsets`` with their RTT uncertainty, a ``trace_merge``
    summary proving one timeline across ≥2 processes, and a
    ``black_box`` block showing an exhumed worker's own events folded
    into the parent's post-mortem. Per-worker heartbeat payloads
    (``last_stats``) are schema-checked: a worker shipping garbage
    stats trips the validator, not a downstream dashboard.
    """
    problems = validate_artifact(record, require_baseline=False)
    for field in PROCFLEET_ARTIFACT_FIELDS:
        if field not in record:
            problems.append(f"missing procfleet field {field!r}")
    p50, p99 = record.get("p50_ms"), record.get("p99_ms")
    if (
        isinstance(p50, (int, float))
        and isinstance(p99, (int, float))
        and p99 < p50
    ):
        problems.append(f"p99_ms {p99} < p50_ms {p50}")
    bit = record.get("bit_identical")
    if not isinstance(bit, dict) or not (
        {"checked", "mismatches"} <= set(bit)
    ):
        problems.append(
            "missing bit_identical {checked, mismatches} block"
        )
    elif bit["mismatches"]:
        problems.append(
            f"bit-identity audit failed: {bit['mismatches']} "
            f"mismatch(es) in {bit['checked']} checked"
        )
    pf = record.get("procfleet")
    if not isinstance(pf, dict):
        problems.append("missing procfleet block")
        return problems
    for field in _PROCFLEET_BLOCK_FIELDS:
        if field not in pf:
            problems.append(f"procfleet block missing {field!r}")
    n = pf.get("n_workers")
    if isinstance(n, int) and n < 2:
        problems.append(
            f"n_workers {n} < 2 (a one-worker fleet cannot fail over)"
        )
    if isinstance(pf.get("worker_deaths"), int) and pf["worker_deaths"] < 1:
        problems.append("procfleet drill killed no worker")
    if isinstance(pf.get("restarts"), int) and pf["restarts"] < 1:
        problems.append("procfleet drill restarted no worker")
    if pf.get("lost_requests") != 0:
        problems.append(
            f"lost_requests is {pf.get('lost_requests')!r}: the drill "
            "must complete every admitted request"
        )
    fo = pf.get("failover_ms")
    if not isinstance(fo, (int, float)) or fo < 0:
        problems.append(
            f"failover_ms {fo!r} is not a measured failover latency"
        )
    cycle = pf.get("breaker_cycle")
    if isinstance(cycle, list):
        missing = {"open", "half_open", "closed"} - set(cycle)
        if missing:
            problems.append(
                f"breaker cycle {cycle} missing state(s) "
                f"{sorted(missing)} — the victim's breaker must open, "
                "half-open and close in the artifact"
            )
    per = pf.get("per_worker")
    if isinstance(per, list):
        if isinstance(n, int) and len(per) != n:
            problems.append(
                f"per_worker has {len(per)} row(s) for {n} workers"
            )
        for row in per:
            if not isinstance(row, dict) or not (
                {"id", "served", "qps"} <= set(row)
            ):
                problems.append("per_worker rows need {id, served, qps}")
                break
        for row in per:
            if not isinstance(row, dict):
                continue
            stats = row.get("last_stats")
            if stats is None:
                continue  # a worker that never beat has no payload
            if not isinstance(stats, dict):
                problems.append(
                    f"per_worker[{row.get('id')!r}].last_stats is "
                    f"{type(stats).__name__}, expected a heartbeat dict"
                )
                continue
            for counter in ("beats", "served", "pending"):
                v = stats.get(counter)
                if not isinstance(v, int) or v < 0:
                    problems.append(
                        f"per_worker[{row.get('id')!r}].last_stats."
                        f"{counter} = {v!r} is not a counter"
                    )
    orphans = pf.get("orphans")
    if orphans is not None:
        if not isinstance(orphans, dict) or not (
            {"orphans_reaped", "stale_sockets_swept"} <= set(orphans)
        ):
            problems.append(
                "orphans block needs {orphans_reaped, stale_sockets_swept}"
            )
    l2 = pf.get("mid_l2_kill")
    if not isinstance(l2, dict) or not (
        {"killed_mid_read", "row_bit_identical"} <= set(l2)
    ):
        problems.append(
            "missing mid_l2_kill {killed_mid_read, row_bit_identical} "
            "block"
        )
    else:
        if l2.get("killed_mid_read") is not True:
            problems.append(
                "mid_l2_kill phase never landed its kill inside an L2 "
                "read"
            )
        if l2.get("row_bit_identical") is not True:
            problems.append(
                "mid_l2_kill phase observed a torn or stale row "
                "cross-process"
            )
    wire = pf.get("wire")
    if wire is not None:
        if not isinstance(wire, dict) or not isinstance(
            wire.get("heartbeats"), int
        ):
            problems.append("wire block needs a heartbeats count")
        elif wire["heartbeats"] < 1:
            problems.append(
                "wire block shows no heartbeats — leases never beat "
                "on the wire"
            )
    # -- distributed observability plane --------------------------------
    if "fleet_telemetry" in record:
        from .tower import validate_fleet_telemetry_artifact

        problems.extend(validate_fleet_telemetry_artifact(record))
    else:
        problems.append(
            "missing fleet_telemetry block — the fleet ran without "
            "its cross-process telemetry plane"
        )
    tel = pf.get("telemetry")
    if tel is not None:
        if not isinstance(tel, dict):
            problems.append("procfleet telemetry block is not a dict")
        else:
            frames = tel.get("frames")
            if not isinstance(frames, int) or frames < 1:
                problems.append(
                    f"telemetry.frames {frames!r}: no TELEMETRY frame "
                    "ever crossed the wire"
                )
            zombies = tel.get("zombie_frames")
            if not isinstance(zombies, int) or zombies < 0:
                problems.append(
                    f"telemetry.zombie_frames {zombies!r} is not a count"
                )
            cov = tel.get("coverage")
            if not isinstance(cov, (int, float)) or not 0.0 <= cov <= 1.0:
                problems.append(
                    f"telemetry.coverage {cov!r} is not in [0, 1]"
                )
    offs = pf.get("clock_offsets")
    if offs is not None:
        if not isinstance(offs, dict) or not offs:
            problems.append(
                "clock_offsets is empty — no HELLO exchange estimated "
                "a worker clock"
            )
        else:
            for rid, off in offs.items():
                if not isinstance(off, dict) or not isinstance(
                    off.get("offset_s"), (int, float)
                ):
                    problems.append(
                        f"clock_offsets[{rid!r}] has no offset_s number"
                    )
                    continue
                rtt = off.get("rtt_s")
                if not isinstance(rtt, (int, float)) or rtt < 0:
                    problems.append(
                        f"clock_offsets[{rid!r}].rtt_s {rtt!r} is not "
                        "a non-negative uncertainty"
                    )
    tm = pf.get("trace_merge")
    if tm is not None:
        if not isinstance(tm, dict):
            problems.append("trace_merge block is not a dict")
        else:
            nproc = tm.get("n_processes")
            if not isinstance(nproc, int) or nproc < 2:
                problems.append(
                    f"trace_merge.n_processes {nproc!r} < 2 — one "
                    "process is not a merged timeline"
                )
            pids = tm.get("pids")
            if not isinstance(pids, list) or (
                isinstance(nproc, int) and len(pids) != nproc
            ):
                problems.append(
                    f"trace_merge.pids {pids!r} does not list "
                    f"{nproc!r} process(es)"
                )
            xreq = tm.get("cross_process_requests")
            if not isinstance(xreq, int) or xreq < 1:
                problems.append(
                    f"trace_merge.cross_process_requests {xreq!r}: no "
                    "request span crossed a process boundary"
                )
    bb = pf.get("black_box")
    if bb is not None:
        if not isinstance(bb, dict):
            problems.append("black_box block is not a dict")
        else:
            exhumed = bb.get("exhumed")
            if not isinstance(exhumed, list) or not exhumed:
                problems.append(
                    "black_box.exhumed is empty — no dead worker's "
                    "ring was recovered"
                )
            else:
                for i, box in enumerate(exhumed):
                    if not isinstance(box, dict) or not (
                        {"rid", "generation", "n_events"} <= set(box)
                    ):
                        problems.append(
                            f"black_box.exhumed[{i}] needs "
                            "{rid, generation, n_events}"
                        )
            if bb.get("victim_events_in_post_mortem") is not True:
                problems.append(
                    "black_box: the victim's own events never reached "
                    "the parent's post-mortem"
                )
    return problems


# The compiled-plan block streamed/roundtrip bench artifacts stamp
# (`plan.Plan.artifact_block`) — the plan compiler's schema
# contract: which inputs were priced (hash), the chosen pass grid /
# spill policy / serve shapes, and predicted vs measured wall so a
# mispriced model (future bad plans) is visible in the artifact itself.
PLAN_ARTIFACT_FIELDS = (
    "inputs_hash",
    "mode",
    "backward",
    "spill",
    "serve",
    "mesh",
    "predicted",
    "coeffs_source",
)

_PLAN_BACKWARD_FIELDS = (
    "n_passes", "n_facet_passes", "n_row_slabs", "fold_group",
    "feed_group", "n_feeds", "resident_bytes",
)

_PLAN_SPILL_MODES = ("none", "ram", "disk", "replay")


def validate_plan_artifact(record):
    """Problems with an artifact's ``plan_compiled`` block, as strings.

    The block must carry the pricing-inputs hash, a coherent backward
    pass grid (``n_passes == n_facet_passes * n_row_slabs``), a known
    spill mode, ascending serve bucket shapes, numeric predicted
    wall/HBM peak, and a coefficient pedigree — so a plan nobody can
    reprice (or a grid that disagrees with itself) fails in seconds on
    CPU instead of silently producing bad plans later.
    """
    problems = []
    block = record.get("plan_compiled")
    if not isinstance(block, dict):
        return ["missing plan_compiled block"]
    for field in PLAN_ARTIFACT_FIELDS:
        if field not in block:
            problems.append(f"plan_compiled missing {field!r}")
    if not block.get("inputs_hash"):
        problems.append("plan_compiled inputs_hash is empty")
    bwd = block.get("backward")
    if isinstance(bwd, dict):
        for field in _PLAN_BACKWARD_FIELDS:
            if field not in bwd:
                problems.append(f"plan backward block missing {field!r}")
        n, nf, nr = (
            bwd.get("n_passes"), bwd.get("n_facet_passes"),
            bwd.get("n_row_slabs"),
        )
        if (
            all(isinstance(v, int) for v in (n, nf, nr))
            and n != nf * nr
        ):
            problems.append(
                f"plan pass grid incoherent: {n} passes != "
                f"{nf} facet passes x {nr} row slabs"
            )
        # feed-once/fold-many schedule coherence: q in [1, n_passes]
        # and n_feeds == ceil(n_passes / q) — a schedule that disagrees
        # with its own grid would mis-size every feed's residency
        q, nfe = bwd.get("feed_group"), bwd.get("n_feeds")
        if all(isinstance(v, int) for v in (n, q, nfe)):
            if not (1 <= q <= max(1, n)):
                problems.append(
                    f"plan feed_group {q} outside [1, {n}] passes"
                )
            elif nfe != -(-n // q):
                problems.append(
                    f"plan feed schedule incoherent: {nfe} feeds != "
                    f"ceil({n} passes / {q} per feed)"
                )
    elif "backward" in block:
        problems.append("plan backward block is not a dict")
    spill = block.get("spill")
    if isinstance(spill, dict):
        if spill.get("mode") not in _PLAN_SPILL_MODES:
            problems.append(
                f"plan spill mode {spill.get('mode')!r} not in "
                f"{_PLAN_SPILL_MODES}"
            )
    serve = block.get("serve")
    if isinstance(serve, dict):
        buckets = serve.get("bucket_sizes")
        if not isinstance(buckets, list) or not buckets or any(
            b2 <= b1 for b1, b2 in zip(buckets, buckets[1:])
        ):
            problems.append(
                f"plan serve bucket_sizes {buckets!r} is not an "
                "ascending non-empty list"
            )
    pred = block.get("predicted")
    if isinstance(pred, dict):
        for field in ("wall_s", "hbm_peak_bytes"):
            v = pred.get(field)
            if not isinstance(v, (int, float)) or v < 0:
                problems.append(
                    f"plan predicted.{field} {v!r} is not a "
                    "non-negative number"
                )
    elif "predicted" in block:
        problems.append("plan predicted block is not a dict")
    if "measured_wall_s" in block and not isinstance(
        block["measured_wall_s"], (int, float)
    ):
        problems.append(
            f"plan measured_wall_s {block['measured_wall_s']!r} is "
            "not a number"
        )
    if block.get("coeffs_source") not in (
        None, "default", "measured", "ledger"
    ):
        problems.append(
            f"plan coeffs_source {block.get('coeffs_source')!r} not "
            "default|measured|ledger"
        )
    mesh = block.get("mesh")
    if isinstance(mesh, dict):
        if mesh.get("status") not in _PLAN_MESH_STATUSES:
            problems.append(
                f"plan mesh status {mesh.get('status')!r} not in "
                f"{_PLAN_MESH_STATUSES}"
            )
        shards = mesh.get("facet_shards")
        if isinstance(shards, int) and shards < 1:
            problems.append(f"plan mesh facet_shards {shards} < 1")
    elif "mesh" in block:
        problems.append("plan mesh block is not a dict")
    return problems


# "stub": the compiler planned a layout no executor consumed (incl. the
# trivial single-device layout); "bound": the mesh-streamed engine
# executed it (the mesh engine flips the status at construction).
_PLAN_MESH_STATUSES = ("stub", "bound")


# The mesh block every `bench.py --mesh` artifact must carry — the
# mesh-streamed drill's schema contract: the layout that ran (shards,
# padding), the cross-device traffic, scaling vs the single-chip
# engine, and the reduction-order match audit.
MESH_ARTIFACT_FIELDS = (
    "n_devices",
    "facet_shards",
    "padded_facets",
    "collective_bytes",
    "single_chip_wall_s",
    "mesh_wall_s",
    "scaling_efficiency",
    "match",
    "hlo",
)

# The mesh block of a `bench.py --mesh --chaos` artifact: the chaos
# drill races nothing (no single-chip leg, no HLO audit — those are the
# scaling leg's contract); its match audit is the BIT-identity of the
# recovered run vs the undisturbed mesh run, and it must carry the
# recovery block below.
MESH_CHAOS_ARTIFACT_FIELDS = (
    "n_devices",
    "facet_shards",
    "padded_facets",
    "collective_bytes",
    "match",
    "recovery",
)

# The `mesh.recovery` block schema — the elastic-recovery drill's
# contract: what was lost, what the survivors re-planned to (priced by
# the plan compiler, not guessed), whether the checkpoint migrated
# across layouts, how long the ladder took (`recovery_wall_s`, and
# `recovery_overhead` = disturbed/undisturbed wall ratio — the
# bench_compare sentinel), and whether the resumed result stayed
# bit-identical.
MESH_RECOVERY_FIELDS = (
    "events",
    "shards_before",
    "shards_after",
    "replanned",
    "migrated",
    "subgrids_migrated",
    "watchdog",
    "recovery_wall_s",
    "recovery_overhead",
    "bit_identical",
)


def _mesh_recovery_problems(recovery):
    """Schema problems with one `mesh.recovery` block."""
    if not isinstance(recovery, dict):
        return ["mesh recovery block is not a dict"]
    problems = []
    for field in MESH_RECOVERY_FIELDS:
        if field not in recovery:
            problems.append(f"mesh recovery block missing {field!r}")
    events = recovery.get("events")
    if isinstance(events, int) and events < 1:
        problems.append(
            "mesh recovery drill recovered from no shard loss"
        )
    before = recovery.get("shards_before")
    after = recovery.get("shards_after")
    if (
        isinstance(before, int) and isinstance(after, int)
        and not (1 <= after < before)
    ):
        problems.append(
            f"recovery shards {before} -> {after} did not shrink to a "
            "surviving layout"
        )
    replanned = recovery.get("replanned")
    if isinstance(replanned, dict):
        if (
            isinstance(after, int)
            and replanned.get("facet_shards") not in (None, after)
        ):
            problems.append(
                f"re-planned layout shards "
                f"{replanned.get('facet_shards')} != surviving "
                f"shard count {after}"
            )
    elif "replanned" in recovery:
        problems.append(
            "recovery replanned block is not a layout dict — the "
            "survivor layout must come from the plan compiler, not "
            "be guessed"
        )
    if recovery.get("migrated") is not True:
        problems.append(
            "recovery did not migrate a checkpoint across layouts"
        )
    if not isinstance(recovery.get("watchdog"), dict):
        problems.append("recovery watchdog block is not a dict")
    for field in ("recovery_wall_s", "recovery_overhead"):
        v = recovery.get(field)
        if v is not None and (
            not isinstance(v, (int, float)) or v <= 0
        ):
            problems.append(f"recovery {field} {v!r} is not positive")
    if recovery.get("bit_identical") is not True:
        problems.append(
            f"recovery bit_identical is "
            f"{recovery.get('bit_identical')!r}; the recovered stream "
            "must equal the undisturbed run exactly"
        )
    return problems


def validate_mesh_artifact(record):
    """Problems with a mesh-mode BENCH artifact, as a list of strings.

    Mesh legs carry no numpy baseline (the single-chip streamed engine
    is the reference, recorded in the block itself) but must carry the
    full manifest plus a coherent ``mesh`` block: a real multi-shard
    layout (>= 2 facet shards — a one-shard "mesh" proves nothing), the
    padded facet count a multiple of the shard count, non-negative
    collective bytes, a positive scaling_efficiency, a match audit
    whose max |diff| sits inside the stamped reduction-order tolerance,
    an HLO audit showing >= 1 facet-axis all-reduce in the lowered
    streamed stage, and ``plan_compiled.mesh.status == "bound"`` — a
    mesh drill whose plan nothing consumed, or whose results drifted
    past tolerance, is a correctness bug, not a scaling result.

    A ``mesh.recovery`` block switches the schema to the elastic
    recovery drill's (``bench.py --mesh --chaos``): the scaling-leg
    fields (single-chip wall, scaling_efficiency, hlo) are not
    required, but the recovery block must be coherent — >= 1 recovery
    event, shards genuinely shrunk, a re-planned survivor layout whose
    shard count matches, a checkpoint migration, positive recovery
    wall/overhead, and ``bit_identical`` True (the recovered stream
    must equal the undisturbed run EXACTLY; a drifted recovery is a
    correctness bug, not a resilience result).
    """
    problems = validate_artifact(record, require_baseline=False)
    mesh = record.get("mesh")
    if not isinstance(mesh, dict):
        problems.append("missing mesh block")
        return problems
    recovery = mesh.get("recovery")
    required = (
        MESH_ARTIFACT_FIELDS if recovery is None
        else MESH_CHAOS_ARTIFACT_FIELDS
    )
    for field in required:
        if field not in mesh:
            problems.append(f"mesh block missing {field!r}")
    if recovery is not None:
        problems.extend(_mesh_recovery_problems(recovery))
    shards = mesh.get("facet_shards")
    if isinstance(shards, int) and shards < 2:
        problems.append(
            f"facet_shards {shards} < 2 (a one-shard mesh leg "
            "exercises no collective)"
        )
    padded = mesh.get("padded_facets")
    if (
        isinstance(shards, int) and shards >= 1
        and isinstance(padded, int) and padded % shards
    ):
        problems.append(
            f"padded_facets {padded} is not a multiple of "
            f"facet_shards {shards}"
        )
    cb = mesh.get("collective_bytes")
    if cb is not None and (not isinstance(cb, (int, float)) or cb < 0):
        problems.append(f"collective_bytes {cb!r} is not a byte count")
    se = mesh.get("scaling_efficiency")
    if se is not None and (not isinstance(se, (int, float)) or se <= 0):
        problems.append(
            f"scaling_efficiency {se!r} is not a positive number"
        )
    match = mesh.get("match")
    if not isinstance(match, dict) or not (
        {"max_abs_diff", "tolerance", "within_tolerance"} <= set(match)
    ):
        problems.append(
            "missing match {max_abs_diff, tolerance, within_tolerance} "
            "block"
        )
    else:
        if match.get("within_tolerance") is not True:
            problems.append(
                f"mesh result outside the reduction-order tolerance: "
                f"{match}"
            )
        mad, tol = match.get("max_abs_diff"), match.get("tolerance")
        if (
            isinstance(mad, (int, float))
            and isinstance(tol, (int, float))
            and mad > tol
        ):
            problems.append(
                f"match max_abs_diff {mad} > tolerance {tol} but "
                "within_tolerance claims otherwise"
            )
    hlo = mesh.get("hlo")
    if isinstance(hlo, dict):
        # the HLO audit proves the EXECUTED collective matches the
        # schedule: psum lowers to a facet-axis all-reduce, ring to the
        # 2(n-1) collective-permute pipeline (and must NOT silently
        # fall back to all-reduce)
        if mesh.get("collective") == "ring":
            if not hlo.get("collective_permute"):
                problems.append(
                    "ring collective requested but lowered streamed "
                    "stage shows no collective-permute pipeline"
                )
        elif not hlo.get("all_reduce"):
            problems.append(
                "lowered streamed stage shows no facet-axis all-reduce"
            )
    elif "hlo" in mesh:
        problems.append("mesh hlo block is not a dict")
    pc = record.get("plan_compiled")
    if isinstance(pc, dict):
        status = (pc.get("mesh") or {}).get("status")
        if status != "bound":
            problems.append(
                f"plan_compiled.mesh.status {status!r} != 'bound' — "
                "the engine must consume the compiled layout"
            )
    else:
        problems.append("mesh artifact missing plan_compiled block")
    return problems


# The resilience block every `bench.py --chaos` artifact must carry —
# the chaos drill's schema contract (what was injected, what survived,
# how the run degraded, and whether the killed-and-resumed output is
# bit-identical to the undisturbed run).
RESILIENCE_ARTIFACT_FIELDS = (
    "faults_injected",
    "faults_injected_total",
    "faults_survived",
    "retries",
    "degradations",
    "resume_count",
    "bit_identical",
)


def validate_resilience_artifact(record):
    """Problems with a chaos-mode BENCH artifact, as a list of strings.

    Chaos legs carry no numpy baseline (nothing is being raced) but must
    carry the full manifest plus a coherent ``resilience`` block: at
    least one fault injected, every fault survived or resumed past, a
    resume count >= 1 (the drill kills mid-run by contract), the
    degradation trail as a list, and ``bit_identical`` True — a chaos
    drill whose output drifted is a correctness bug, not a resilience
    result.
    """
    problems = validate_artifact(record, require_baseline=False)
    res = record.get("resilience")
    if not isinstance(res, dict):
        problems.append("missing resilience block")
        return problems
    for field in RESILIENCE_ARTIFACT_FIELDS:
        if field not in res:
            problems.append(f"resilience block missing {field!r}")
    injected = res.get("faults_injected")
    if injected is not None and not isinstance(injected, dict):
        problems.append(
            f"faults_injected is {type(injected).__name__}, expected "
            "a site -> count dict"
        )
    elif isinstance(injected, dict):
        total = res.get("faults_injected_total")
        if isinstance(total, int) and total != sum(injected.values()):
            problems.append(
                f"faults_injected_total {total} != sum of by-site "
                f"counts {sum(injected.values())}"
            )
    if isinstance(res.get("faults_injected_total"), int):
        if res["faults_injected_total"] < 1:
            problems.append("chaos drill injected no faults")
    if not isinstance(res.get("degradations"), list):
        problems.append("degradations is not a list")
    rc = res.get("resume_count")
    if isinstance(rc, int) and rc < 1:
        problems.append("resume_count < 1 (the drill must kill+resume)")
    if res.get("bit_identical") is not True:
        problems.append(
            f"bit_identical is {res.get('bit_identical')!r}, the "
            "resumed run must match the undisturbed run exactly"
        )
    return problems


# The delta block every `bench.py --delta` artifact must carry — the
# incremental-update drill's schema contract (which facets moved, how
# many cached columns were patched, the patch-vs-full speedup, and the
# audit that the patched stream matches a fresh full recompute).
DELTA_ARTIFACT_FIELDS = (
    "changed_facets",
    "patched_columns",
    "speedup_vs_full",
    "max_abs_diff",
    "plan",
)


def validate_delta_artifact(record):
    """Problems with a delta-mode BENCH artifact, as a list of strings.

    Delta legs carry no numpy baseline (the full re-record of the same
    engine is the reference, timed in the block itself) but must carry
    the full manifest plus a coherent ``delta`` block: at least one
    changed facet, at least one patched column, a positive
    speedup_vs_full, a match audit whose max |diff| sits inside the
    stamped f32 sum-reorder tolerance, and a ``plan`` block whose mode
    names the path actually taken (``"patch"`` or ``"full"``) — a delta
    drill whose patched stream drifted past tolerance is a correctness
    bug, not a speedup result.
    """
    problems = validate_artifact(record, require_baseline=False)
    delta = record.get("delta")
    if not isinstance(delta, dict):
        problems.append("missing delta block")
        return problems
    for field in DELTA_ARTIFACT_FIELDS:
        if field not in delta:
            problems.append(f"delta block missing {field!r}")
    changed = delta.get("changed_facets")
    if isinstance(changed, list) and not changed:
        problems.append("delta drill changed no facets")
    elif changed is not None and not isinstance(changed, list):
        problems.append(
            f"changed_facets is {type(changed).__name__}, expected a "
            "facet-index list"
        )
    pc = delta.get("patched_columns")
    if isinstance(pc, int) and pc < 1 and not delta.get("exact_mode"):
        # SWIFTLY_DELTA_EXACT=1 legs replay instead of patching —
        # zero patched columns is the contract there, not a failure
        problems.append("delta drill patched no cached columns")
    sp = delta.get("speedup_vs_full")
    if sp is not None and (not isinstance(sp, (int, float)) or sp <= 0):
        problems.append(
            f"speedup_vs_full {sp!r} is not a positive number"
        )
    match = delta.get("match")
    if not isinstance(match, dict) or not (
        {"max_abs_diff", "tolerance", "within_tolerance"} <= set(match)
    ):
        problems.append(
            "missing match {max_abs_diff, tolerance, within_tolerance} "
            "block"
        )
    else:
        if match.get("within_tolerance") is not True:
            problems.append(
                f"patched stream outside the f32 sum-reorder "
                f"tolerance: {match}"
            )
        mad, tol = match.get("max_abs_diff"), match.get("tolerance")
        if (
            isinstance(mad, (int, float))
            and isinstance(tol, (int, float))
            and mad > tol
        ):
            problems.append(
                f"match max_abs_diff {mad} > tolerance {tol} but "
                "within_tolerance claims otherwise"
            )
    plan = delta.get("plan")
    if isinstance(plan, dict):
        mode = plan.get("mode")
        if mode not in ("patch", "full"):
            problems.append(
                f"delta plan mode {mode!r} not in ('patch', 'full')"
            )
    elif plan is not None:
        problems.append("delta plan block is not a dict")
    return problems
