"""Print the compiled plan for a config: what was chosen, what it
costs, and what was rejected.

The port's twin of the JAX package's ``scripts/plan_explain.py``, over
the port's own plan compiler (`swiftly_tpu_torch.plan`), whose default
coefficients are the card's measured rates. It prices a cover's geometry
(backward facet x row-slab pass grid and feed schedule, spill policy,
serve bucket shapes, forward grouping prediction) from one cost model,
with no device needed:

    python -m swiftly_tpu_torch.tools.plan_explain --config 64k
    python -m swiftly_tpu_torch.tools.plan_explain \
        --config 128k[1]-n32k-512 --hbm-gib 80 --history 'BENCH*.json'

``--config`` takes a catalogue prefix (``64k`` resolves to the first
``64k[...`` entry) or a full name. ``--hbm-gib`` defaults to the
``SWIFTLY_HBM_BUDGET`` environment variable or the probed card
(`plan.hbm_budget_bytes`); pass it to plan for a machine you are not on.
``--history`` globs feed `plan.autotune.refit`. ``--vis N``, ``--delta
K``, ``--cache`` and ``--colpass`` switch to the visibility batch table,
the incremental-update break-even table, the cache-fabric tier table and
the ranked forward column-pass table (einsum against kernel B1, whose
tile is fixed in ``csrc/cgemm.cuh`` and printed). With ``--devices N``
(N > 1) the report adds the ranked collective alternatives
(``mesh.psum`` against ``mesh.ring_step``) and the degraded-layout
table: the layouts the elastic recovery ladder re-plans onto after
losing one shard (N-1) and half the mesh (N/2).

Exit: 0 on a printed plan, 2 on a bad config/inputs.
"""

from __future__ import annotations

import argparse
import json
import sys


def resolve_config(name):
    """Exact catalogue name, else the first entry starting ``name[``."""
    from ..models import SWIFT_CONFIGS

    if name in SWIFT_CONFIGS:
        return name
    for key in SWIFT_CONFIGS:
        if key.startswith(f"{name}["):
            return key
    raise KeyError(
        f"config {name!r} matches nothing in the catalogue "
        f"({len(SWIFT_CONFIGS)} entries; try e.g. "
        f"{next(iter(SWIFT_CONFIGS))!r})"
    )


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="print the unified plan compiler's choice for a "
                    "config (pass grid, spill policy, serve shapes, "
                    "predicted wall/HBM peak, rejected alternatives)"
    )
    ap.add_argument(
        "--config", default="64k",
        help="catalogue name or prefix (default 64k -> the first "
             "64k[... entry)",
    )
    ap.add_argument(
        "--mode", default="roundtrip-streamed",
        choices=["streamed", "roundtrip-streamed"],
        help="which pipeline to price (default roundtrip-streamed)",
    )
    ap.add_argument(
        "--hbm-gib", type=float, default=None,
        help="per-device memory budget in GiB (default: "
             "SWIFTLY_HBM_BUDGET env / probed card, unlimited on the CPU)",
    )
    ap.add_argument(
        "--devices", type=int, default=1,
        help="device count for the mesh-layout stub (default 1); with "
             "N > 1 the report adds the degraded-layout table (the "
             "re-planned layouts at N-1 and N/2 survivors)",
    )
    ap.add_argument(
        "--fold-group", type=int, default=2,
        help="seed fold group (default 2, bench's BENCH_FOLD_GROUP)",
    )
    ap.add_argument(
        "--max-batch", type=int, default=64,
        help="serve coalescing cap for the bucket shapes (default 64)",
    )
    ap.add_argument(
        "--feed-group", type=int, default=0,
        help="force passes-per-feed for the feed-once/fold-many "
             "backward schedule (default 0: sized from the budget; "
             "bench's BENCH_BWD_FEED_GROUP)",
    )
    ap.add_argument(
        "--history", action="append", default=[], metavar="GLOB",
        help="artifact path/glob for plan.autotune.refit; repeatable. "
             "Measured coefficients unlock parameter selection by "
             "predicted wall",
    )
    ap.add_argument(
        "--spill-dir", default=None,
        help="spill directory the policy may assume (default: "
             "SWIFTLY_SPILL_DIR)",
    )
    ap.add_argument(
        "--delta", type=int, default=None, metavar="K",
        help="print the incremental-update break-even table instead: "
             "price a K-of-J changed-facet patch (delta stream + cache "
             "patch) against the full re-record (plan.plan_delta)",
    )
    ap.add_argument(
        "--vis", type=int, default=None, metavar="SAMPLES",
        help="print the visibility-serving batch table instead: price "
             "a SAMPLES-sample degrid workload over the config's "
             "subgrid size, scanning the power-of-two coalescing caps "
             "(plan.price_vis); --vis-hit-rate blends the per-dispatch "
             "row fetch between cache and spill tiers",
    )
    ap.add_argument(
        "--vis-hit-rate", type=float, default=0.0, metavar="R",
        help="expected cache-feed hit rate in [0, 1] for --vis "
             "(default 0.0: every dispatch reads through spill)",
    )
    ap.add_argument(
        "--vis-grid", action="store_true",
        help="also price the adjoint vis.grid accumulation into the "
             "--vis wall (the gridding ingest workload)",
    )
    ap.add_argument(
        "--colpass", action="store_true",
        help="print the ranked forward column-pass candidate table "
             "instead: einsum vs kernel B1, each priced with its own "
             "FLOP shape and coefficient stage "
             "(plan.price_colpass_candidates); with --history the "
             "rates carry measured pedigree; B1's tile is printed",
    )
    ap.add_argument(
        "--cache", action="store_true",
        help="print the serve cache-fabric tier table instead: price a "
             "per-replica L1 hit vs an L2 read of the one resident "
             "stream vs a recompute, with the break-even L1 size "
             "(plan.price_cache_tier)",
    )
    ap.add_argument(
        "--replicas", type=int, default=3,
        help="serve replica count for --cache (default 3)",
    )
    ap.add_argument(
        "--l1-rows", type=int, default=None,
        help="force the chosen per-replica L1 size for --cache "
             "(default: the break-even size)",
    )
    ap.add_argument(
        "--zipf-s", type=float, default=1.1,
        help="zipf popularity exponent for the --cache hit model "
             "(default 1.1, bench's BENCH_FLEET_ZIPF_S)",
    )
    ap.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the plan's artifact block as JSON instead of the "
             "human report",
    )
    args = ap.parse_args(argv)

    from ..plan import (
        PlanInputs,
        compile_plan,
        hbm_budget_bytes,
        plan_delta,
        price_cache_tier,
        refit,
    )

    try:
        name = resolve_config(args.config)
    except KeyError as exc:
        print(exc.args[0], file=sys.stderr)
        return 2
    budget = (
        args.hbm_gib * 2.0 ** 30
        if args.hbm_gib is not None
        else hbm_budget_bytes()
    )
    inputs = PlanInputs.from_config(
        name, hbm_budget=budget, n_devices=args.devices,
        fold_group=args.fold_group, max_batch=args.max_batch,
    )
    coeffs = refit(args.history) if args.history else None
    if args.colpass:
        from ..ops.kernels import colpass_blocks
        from ..plan import CostCoefficients, price_colpass_candidates
        from ..utils.flops import resolve_colpass

        ccoeffs = coeffs if coeffs is not None else CostCoefficients()
        rows = price_colpass_candidates(inputs, ccoeffs)
        chosen = resolve_colpass(
            inputs.base().core,
            inputs.n_facets // max(1, inputs.n_devices),
        )
        if args.as_json:
            print(json.dumps({
                "config": name,
                "chosen": chosen,
                "coefficients": ccoeffs.source,
                "colpass_blocks": ccoeffs.colpass_blocks,
                "b1_tile": colpass_blocks(inputs.base().core.real_dtype),
                "candidates": rows,
            }, indent=2))
            return 0
        print(f"forward column-pass candidates for {name} "
              f"(coefficients: {ccoeffs.source})")
        print("  rank  colpass  coeff stage              "
              "TFLOP   TF/s  predicted wall")
        for i, row in enumerate(rows):
            mark = " <- resolve_colpass" if row["colpass"] == chosen \
                else ""
            print(
                f"  {i + 1:4d}  {row['colpass']:7s}  "
                f"{row['coeff_stage']:23s}  "
                f"{row['flops'] / 1e12:5.1f}  "
                f"{row['flops_per_s'] / 1e12:5.1f}  "
                f"{row['predicted_wall_s']:10.2f} s{mark}"
            )
        tile = colpass_blocks(inputs.base().core.real_dtype)
        print("  B1 tile (csrc/cgemm.cuh, fixed at compile time): "
              + ", ".join(f"{k}={tile[k]}" for k in sorted(tile)))
        if ccoeffs.colpass_blocks:
            blk = ccoeffs.colpass_blocks
            print(
                "  refit-learned blocks (the tile the history's B1 ran): "
                + ", ".join(f"{k}={blk[k]}" for k in sorted(blk))
            )
        print(
            "  note: the table only RANKS — resolve_colpass keeps the "
            "choice (SWIFTLY_COLPASS env, platform, backend)"
        )
        return 0
    if args.vis is not None:
        from ..plan import price_vis

        try:
            vplan = price_vis(
                args.vis, subgrid_size=inputs.xA,
                cache_hit_rate=args.vis_hit_rate,
                include_grid=args.vis_grid, coeffs=coeffs,
            )
        except ValueError as exc:
            print(exc.args[0], file=sys.stderr)
            return 2
        if args.as_json:
            print(json.dumps(vplan.as_dict(), indent=2))
        else:
            print(vplan.explain())
        return 0
    if args.delta is not None:
        try:
            dplan = plan_delta(inputs, args.delta, coeffs=coeffs)
        except ValueError as exc:
            print(exc.args[0], file=sys.stderr)
            return 2
        if args.as_json:
            print(json.dumps(dplan.as_dict(), indent=2))
        else:
            print(dplan.explain())
        return 0
    if args.cache:
        try:
            cplan = price_cache_tier(
                inputs, coeffs=coeffs, replicas=args.replicas,
                l1_rows=args.l1_rows, zipf_s=args.zipf_s,
            )
        except ValueError as exc:
            print(exc.args[0], file=sys.stderr)
            return 2
        if args.as_json:
            print(json.dumps(cplan.as_dict(), indent=2))
        else:
            print(cplan.explain())
        return 0
    plan = compile_plan(
        inputs, coeffs=coeffs, mode=args.mode,
        spill_dir=args.spill_dir, feed_env=args.feed_group,
    )
    if args.as_json:
        print(json.dumps(plan.artifact_block(), indent=2))
        return 0
    print(plan.explain())
    if args.devices > 1:
        from ..plan import plan_mesh_layout

        cands = plan.mesh.collective_candidates
        if cands:
            print()
            print(
                f"  collective alternatives over "
                f"{plan.mesh.facet_shards} shard(s) "
                f"(planned: {plan.mesh.collective}):"
            )
            print(
                "    rank  collective  coeff stage     bytes/cover  "
                "steps  chunk/step    GB/s  overlap  predicted wall"
            )
            for i, row in enumerate(cands):
                mark = (
                    "  <- planned"
                    if row["collective"] == plan.mesh.collective
                    else ""
                )
                print(
                    f"    {i + 1:4d}  {row['collective']:10s}  "
                    f"{row['coeff_stage']:14s}  "
                    f"{row['bytes'] / 2 ** 30:7.2f} GiB  "
                    f"{row['steps']:5d}  "
                    f"{row['chunk_bytes'] / 2 ** 20:6.1f} MiB  "
                    f"{row['bytes_per_s'] / 1e9:6.0f}  "
                    f"{row['overlap_discount']:7.2f}  "
                    f"{row['predicted_wall_s']:10.4f} s{mark}"
                )
            print(
                "    note: the table only RANKS — "
                "SWIFTLY_MESH_COLLECTIVE forces the schedule, auto "
                "needs calibrated coefficients to flip off psum"
            )
        print()
        print(
            "  degraded layouts (what the elastic recovery ladder "
            "re-plans onto after shard loss):"
        )
        print(
            "    devices  shards  padded  per-shard stack  "
            "collective/col  fits HBM"
        )
        for k in dict.fromkeys(
            [args.devices, args.devices - 1, args.devices // 2]
        ):
            if k < 1:
                continue
            lay = plan_mesh_layout(
                inputs.replace(n_devices=k), args.mode
            )
            tag = "" if k == args.devices else (
                "  (one shard lost)" if k == args.devices - 1
                else "  (half the mesh lost)"
            )
            print(
                f"    {k:7d}  {lay.facet_shards:6d}  "
                f"{lay.padded_facets:6d}  "
                f"{lay.per_shard_stack_bytes / 2 ** 20:12.1f} MiB  "
                f"{lay.collective_bytes_per_column / 2 ** 20:11.1f} MiB"
                f"  {str(lay.fits_hbm):>8s}{tag}"
            )
    if coeffs is not None:
        print(
            f"  coefficients: {coeffs.source} "
            f"({coeffs.n_records} record(s), platform "
            f"{coeffs.platform or '?'})"
        )
        for stage, rate in sorted(coeffs.flops_per_s.items()):
            print(f"    {stage}: {rate / 1e12:.2f} TF/s")
        for stage, rate in sorted(coeffs.bytes_per_s.items()):
            print(f"    {stage}: {rate / 1e9:.2f} GB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
