"""Pricing the visibility-serving path (`plan.price_vis`).

The port of the JAX package's ``swiftly_tpu/plan/vis.py``, unchanged in
kind.

The one free parameter of `vis.service.VisibilityService`'s dispatch
shape is the scheduler's ``max_batch`` — how many coalesced samples one
degrid program answers. Small batches pay the per-dispatch overhead
per few samples; large ones pad harder (power-of-two buckets,
`vis.degrid.bucket_size`) and wait longer to fill. `price_vis` scans
the power-of-two candidates with the SAME `plan.model
.CostCoefficients` the rest of the compiler prices with:

* ``vis.row_fetch`` — one row read per dispatch, blended between the
  cache feed's L1 rate and the spill read rate at the expected hit
  rate (the serve cache fabric's tiering, `plan.price_cache_tier`);
* ``vis.degrid`` / ``vis.grid`` — the batch contraction, flops/bytes
  attributed exactly as `vis.service` / `vis.grid.VisGridder` record
  them, so `plan.autotune.refit` refits these stages from any recorded
  serving artifact and the next plan prices with measured rates
  (``coeffs_source`` records the pedigree).

Every scanned candidate is kept in ``alternatives`` (`VisPlan.explain`
prints the table), matching `compile_plan`'s alternative-recording
contract.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .model import CostCoefficients, StageCost

__all__ = ["VisPlan", "price_vis"]

# flops/bytes attribution per padded sample lane, shared with the
# recording sites (vis.service's degrid stage, vis.grid.VisGridder):
# 2 planes x (W*W multiply-adds) + the [B, W, W] weight outer product
DEGRID_FLOPS_PER_LANE = 6  # x W^2
DEGRID_BYTES_PER_LANE = 8  # x W^2 (two gathered f32 patch planes)


@dataclass
class VisPlan:
    """Priced visibility-serving dispatch shape.

    ``max_batch`` is the chosen coalescing cap (power-of-two, so the
    bucket pad is the identity); ``predicted`` holds the per-stage
    `plan.model.StageCost` dicts for the chosen shape and
    ``alternatives`` every scanned candidate (``chosen`` flags).
    """

    n_samples: int
    support: int
    subgrid_size: int
    cache_hit_rate: float
    max_batch: int
    predicted_wall_s: float
    throughput_ksamples_s: float
    predicted: dict = field(default_factory=dict)
    alternatives: list = field(default_factory=list)
    coeffs_source: str = "default"

    def as_dict(self):
        return {
            "n_samples": int(self.n_samples),
            "support": int(self.support),
            "subgrid_size": int(self.subgrid_size),
            "cache_hit_rate": round(float(self.cache_hit_rate), 4),
            "max_batch": int(self.max_batch),
            "predicted_wall_s": round(float(self.predicted_wall_s), 6),
            "throughput_ksamples_s": round(
                float(self.throughput_ksamples_s), 3
            ),
            "predicted": {
                k: v.as_dict() for k, v in self.predicted.items()
            },
            "coeffs_source": self.coeffs_source,
            "alternatives": list(self.alternatives),
        }

    def explain(self):
        """Human-readable candidate table."""
        lines = [
            f"vis plan: {self.n_samples} samples, support "
            f"{self.support}, subgrid {self.subgrid_size}, cache hit "
            f"rate {self.cache_hit_rate:.2f} -> max_batch "
            f"{self.max_batch} "
            f"({self.predicted_wall_s * 1e3:.2f} ms predicted, "
            f"{self.throughput_ksamples_s:.1f} ksamples/s, "
            f"{self.coeffs_source} coefficients)",
            "  max_batch  dispatches  wall_ms  ksamples_s  choice",
        ]
        for alt in self.alternatives:
            mark = " *" if alt.get("chosen") else ""
            lines.append(
                f"  {alt['max_batch']:>9}  "
                f"{alt['dispatches']:>10}  "
                f"{alt['wall_ms']:>7.2f}  "
                f"{alt['ksamples_s']:>10.1f}{mark}"
            )
        return "\n".join(lines)


def price_vis(n_samples, subgrid_size, support=8, cache_hit_rate=0.0,
              include_grid=False, coeffs=None, history=None,
              candidates=None):
    """Price a visibility workload and pick the coalescing cap.

    :param n_samples: expected samples per pump window
    :param subgrid_size: served row size (``xA``)
    :param support: kernel tap count (`vis.kernel.VisKernel.support`)
    :param cache_hit_rate: expected feed hit rate in [0, 1] — splits
        the per-dispatch row read between ``cache.l1`` and
        ``spill.read`` pricing
    :param include_grid: also price the adjoint accumulation
        (``vis.grid``) into the wall — the gridding ingest workload
    :param coeffs: `plan.model.CostCoefficients`; with ``history``
        given, refit from recorded artifacts instead
        (`plan.autotune.refit`: the vis stages record attributed
        flops, so measured rates supersede the defaults)
    :param candidates: max-batch candidates to scan (default powers of
        two 16..4096)
    :return: `VisPlan`
    """
    if coeffs is None:
        if history:
            from .autotune import refit

            coeffs = refit(history)
        else:
            coeffs = CostCoefficients()
    n = max(1, int(n_samples))
    W = int(support)
    hit = min(1.0, max(0.0, float(cache_hit_rate)))
    row_bytes = 2 * int(subgrid_size) ** 2 * 4
    if candidates is None:
        candidates = [1 << i for i in range(4, 13)]  # 16 .. 4096

    def stage_costs(m):
        n_disp = -(-n // m)  # ceil
        lanes = n_disp * m  # power-of-two m: bucket pad == m
        # one priced row-fetch stage, hit/miss tiers blended at the
        # expected hit rate (the runtime times it as one stage too)
        fetch_bytes = n_disp * row_bytes
        fetch_wall = (
            hit * fetch_bytes / coeffs.bytes_rate("cache.l1")
            + (1 - hit) * fetch_bytes / coeffs.bytes_rate("spill.read")
        )
        costs = {
            "vis.row_fetch": StageCost(
                "vis.row_fetch", 0, int(fetch_bytes), n_disp,
                fetch_wall,
            ),
            "vis.degrid": coeffs.price(
                "vis.degrid",
                flops=DEGRID_FLOPS_PER_LANE * lanes * W * W,
                bytes_moved=DEGRID_BYTES_PER_LANE * lanes * W * W,
                dispatches=n_disp,
            ),
        }
        if include_grid:
            costs["vis.grid"] = coeffs.price(
                "vis.grid",
                flops=8 * lanes * W * W,
                bytes_moved=DEGRID_BYTES_PER_LANE * lanes * W * W,
                dispatches=n_disp,
            )
        return n_disp, costs

    alternatives, best = [], None
    for m in candidates:
        n_disp, costs = stage_costs(m)
        wall = sum(c.wall_s for c in costs.values())
        alternatives.append({
            "max_batch": m,
            "dispatches": n_disp,
            "wall_ms": round(wall * 1e3, 3),
            "ksamples_s": round(n / wall / 1e3, 1) if wall else 0.0,
            "chosen": False,
        })
        if best is None or wall < best[1]:
            best = (m, wall, n_disp, costs)
    m, wall, n_disp, costs = best
    for alt in alternatives:
        alt["chosen"] = alt["max_batch"] == m
    return VisPlan(
        n_samples=n,
        support=W,
        subgrid_size=int(subgrid_size),
        cache_hit_rate=hit,
        max_batch=m,
        predicted_wall_s=wall,
        throughput_ksamples_s=(n / wall / 1e3) if wall else 0.0,
        predicted=costs,
        alternatives=alternatives,
        coeffs_source=coeffs.source,
    )
