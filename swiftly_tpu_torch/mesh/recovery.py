"""Elastic mesh recovery: survive the loss of a shard mid-stream.

The torch twin of the JAX package's ``swiftly_tpu/mesh/recovery.py``.
A lost shard (`ShardLostError`: injected, or the watchdog's
`CollectiveStalledError` from a stalled collective) walks this rung of
the degradation ladder::

    shard lost
      -> re-plan the layout on the survivors (`plan.plan_mesh_layout` on
         ``inputs.replace(n_devices=k)``: priced by the cost model)
      -> rebuild the engines on a survivor mesh (`rebuild_on`)
      -> migrate the last autosave across layouts
         (`utils.checkpoint.restore_streamed_backward_state`: real facets
         kept, padding regrown, re-placed; ``ckpt.migrations``)
      -> resume the column stream at the last autosave's group boundary.

Bit-identity: the backward's folds and finishes are per-facet math local
to each shard, the same bits on any layout, and a cache-fed pass replays
the recorded bytes; so a loss during a cache-fed pass recovers to the
bits of the undisturbed run.

Observable as the JAX package's: ``mesh.recovery.*`` counters, trace
instants at detection, re-plan and resume, flight-recorder lines, the
degradation record ``mesh / replan_survivors`` and a report shaped for
the ``mesh.recovery`` artifact block (`obs.validate_mesh_artifact`).
"""

from __future__ import annotations

import logging
import time

from ..obs import metrics as _metrics
from ..obs import recorder as _recorder
from ..obs import trace as _trace
from ..parallel.mesh import mesh_size
from ..resilience import degrade as _degrade
from ..resilience.faults import ShardLostError
from ..resilience.watchdog import collective_timeout_s
from ..utils.checkpoint import (
    checkpoint_generations,
    rank_checkpoint_path,
    restore_streamed_backward_state,
)

__all__ = [
    "recover_engines",
    "run_elastic_pass",
    "survivor_mesh",
]

logger = logging.getLogger(__name__)


def survivor_mesh(mesh, lost_shard=None):
    """(mesh', lost): a facet mesh over the survivors of losing one shard
    of `mesh`.

    :param lost_shard: index of the dead shard; default the last one
        (deterministic for drills; a detector passes the shard whose
        collective stalled)

    A mesh over processes re-plans within its process group: every rank
    must name the same lost shard, and a loss that leaves a rank with no
    shard (a lost process) raises a `RuntimeError` naming the rank. The
    survivors' shards may lie on other ranks than before: the autosave's
    restore brings each row to its new rank (`utils.checkpoint`).
    """
    devices = list(mesh.devices)
    lost = len(devices) - 1 if lost_shard is None else int(lost_shard)
    if not 0 <= lost < len(devices):
        raise ValueError(
            f"lost_shard {lost} out of range for a "
            f"{len(devices)}-device mesh"
        )
    survivors = [d for i, d in enumerate(devices) if i != lost]
    if not survivors:
        raise ShardLostError(
            "no surviving devices to re-plan onto", shard=lost
        )
    return mesh.without_shard(lost), lost


def recover_engines(forward, backward, plan_inputs=None,
                    mode="roundtrip-streamed", lost_shard=None,
                    ckpt_path=None):
    """One recovery step: re-plan, rebuild, migrate. Returns
    ``(forward', backward', processed, info)``.

    The original engines are left untouched. ``processed`` is the migrated
    snapshot's (off0, off1) ledger, the subgrids the resumed feed skips,
    or ``()`` when no snapshot exists yet (the loss came before the first
    autosave: the pass runs again whole on the survivors, still exact).

    :param plan_inputs: the `plan.PlanInputs` of the original layout; when
        given, the survivor layout is `plan.plan_mesh_layout` of
        ``replace(n_devices=survivors)``, bound by the rebuilt engines
    """
    t0 = time.monotonic()
    before = mesh_size(forward.mesh)
    _metrics.count("mesh.recovery.events")
    _trace.instant(
        "mesh.recovery.detected", cat="fault",
        shards=before, lost_shard=lost_shard,
    )
    _recorder.record("mesh", "mesh.recovery.detected",
                     f"{before} shard(s), lost {lost_shard}")
    mesh, lost = survivor_mesh(forward.mesh, lost_shard)
    layout = None
    if plan_inputs is not None:
        from ..plan import plan_mesh_layout

        layout = plan_mesh_layout(
            plan_inputs.replace(n_devices=mesh_size(mesh)), mode
        )
        _metrics.count("mesh.recovery.replans")
    _trace.instant(
        "mesh.recovery.replanned", cat="fault",
        shards=mesh_size(mesh),
        facet_shards=(layout.facet_shards if layout else None),
    )
    _recorder.record("mesh", "mesh.recovery.replanned",
                     f"{before} -> {mesh_size(mesh)} shard(s)")
    new_fwd = forward.rebuild_on(mesh, layout)
    new_bwd = backward.rebuild_on(mesh, layout)
    processed = ()
    migrated = False
    if ckpt_path and checkpoint_generations(
            rank_checkpoint_path(ckpt_path, forward.mesh)):
        processed = restore_streamed_backward_state(ckpt_path, new_bwd)
        migrated = True
    wall = time.monotonic() - t0
    _degrade.record(
        "mesh", "replan_survivors",
        f"shard {lost} lost; re-planned {before} -> {mesh_size(mesh)} "
        f"shard(s), {len(processed)} subgrid(s) migrated",
    )
    _trace.instant(
        "mesh.recovery.resumed", cat="fault",
        shards=mesh_size(mesh), skipped=len(processed),
        recovery_wall_s=wall,
    )
    _recorder.record("mesh", "mesh.recovery.resumed",
                     f"{len(processed)} subgrid(s) migrated, "
                     f"{wall:.3f}s")
    logger.warning(
        "mesh recovery: shard %s lost; re-planned %d -> %d shard(s) "
        "in %.3fs (%d subgrid(s) already folded)",
        lost, before, mesh_size(mesh), wall, len(processed),
    )
    info = {
        "shards_before": int(before),
        "shards_after": int(mesh_size(mesh)),
        "lost_shard": int(lost),
        "replanned": layout.as_dict() if layout is not None else None,
        "migrated": migrated,
        "subgrids_migrated": len(processed),
        "recovery_wall_s": wall,
    }
    return new_fwd, new_bwd, processed, info


def run_elastic_pass(forward, backward, subgrid_configs, spill,
                     ckpt_path, plan_inputs=None,
                     mode="roundtrip-streamed", autosave_every=1,
                     max_recoveries=1):
    """Feed the column stream into `backward`, surviving shard loss.

    Streams ``forward.stream_column_groups(subgrid_configs, spill=...)``
    into ``backward.add_subgrid_group``, autosaving to `ckpt_path` every
    `autosave_every` subgrids (over processes each rank to its own file,
    `utils.checkpoint.rank_checkpoint_path`). A `ShardLostError` in the
    loop (an injected ``mesh.shard_loss`` / ``mesh.feed`` fault, or the
    watchdog's `CollectiveStalledError` at ``mesh.psum`` /
    ``mesh.ring_step``) runs `recover_engines`, and the pass resumes on
    the rebuilt engines, skipping the groups the migrated snapshot
    holds.

    Returns ``(forward', backward', report)``: the (possibly rebuilt)
    engines, the backward with the whole pass folded in, and::

        {"events": int, "recoveries": [info, ...],
         "watchdog": {"timeout_s": float|None},
         "shards_before": int, "shards_after": int,
         "recovery_wall_s": float}

    At most `max_recoveries` losses are absorbed; one more re-raises.
    """
    fwd, bwd = forward, backward
    shards0 = mesh_size(fwd.mesh)
    bwd.enable_autosave(ckpt_path, every_subgrids=autosave_every)
    skip = set()
    recoveries = []
    while True:
        try:
            for per_col, group in fwd.stream_column_groups(
                subgrid_configs, spill=spill
            ):
                keys = [
                    (sg.off0, sg.off1) for col in per_col for _, sg in col
                ]
                if skip and all(k in skip for k in keys):
                    continue
                bwd.add_subgrid_group(
                    [[sg for _, sg in col] for col in per_col], group
                )
            break
        except ShardLostError as exc:
            if len(recoveries) >= max_recoveries:
                raise
            logger.warning(
                "mesh pass: %s; walking the recovery ladder", exc
            )
            fwd, bwd, processed, info = recover_engines(
                fwd, bwd,
                plan_inputs=plan_inputs, mode=mode,
                lost_shard=getattr(exc, "shard", None),
                ckpt_path=ckpt_path,
            )
            info["detected_via"] = type(exc).__name__
            recoveries.append(info)
            skip = set(map(tuple, processed))
            bwd.enable_autosave(ckpt_path, every_subgrids=autosave_every)
    report = {
        "events": len(recoveries),
        "recoveries": recoveries,
        "watchdog": {"timeout_s": collective_timeout_s()},
        "shards_before": int(shards0),
        "shards_after": int(mesh_size(bwd.mesh)),
        "recovery_wall_s": float(
            sum(r["recovery_wall_s"] for r in recoveries)
        ),
    }
    return fwd, bwd, report
