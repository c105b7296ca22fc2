"""Per-stage capacity estimate for configs beyond one card's memory.

The port's twin of the JAX package's ``scripts/estimate_large_config.py``.
For a config whose raw facet stack outgrows the card (on an 80 GB H100,
128k: 9 facets of 45056^2, 73 GB as real f32 planes), the one-card path
that holds the facets on the host is the host-residency streamed
executor; its full-cover wall decomposes into per-stage costs this tool
MEASURES at full shape on the card, then extrapolates by stage counts
(never by size):

  forward total ~= n_blocks  * (t_assemble + t_upload_block
                                + t_facet_pass_block + t_download_rows)
                 + n_columns * (t_upload_column + t_column_pass)

It also prints the mesh alternative: the fewest cards whose facet shard
fits (the sampled-DFT path, no host round trip). ``--plan_only`` prints
the facet-slab plan (the path phase 9 of chip_smoke.py runs at 128k on one
card) with no device: the column grouping, the stack sweeps, the h2d
volume and the FLOPs at the port's default rates (`plan.model`, measured
on the card). Every number is printed beside the card's name and power
limit.

Usage:
    python -m swiftly_tpu_torch.tools.estimate_large_config
        [--config 64k[1]-n32k-1k] [--hbm_gib 80] [--plan_only]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ._cli import add_device_arg, card_line, catalogue_params, setup_torch


def _config(args, device):
    from .. import SwiftlyConfig, make_full_facet_cover, make_full_subgrid_cover

    config = SwiftlyConfig(backend="planar", dtype=torch.float32,
                           device=device, **catalogue_params(args.config))
    return (config, make_full_facet_cover(config),
            make_full_subgrid_cover(config))


def plan_only(args):
    """Static one-card plan (no device): the facet-slab stream, extrapolated
    to any config, plus the multi-host sizing for stacks beyond one host's
    RAM."""
    from ..parallel.streamed import (
        facet_stack_bytes,
        grouped_col_group_for_budget,
    )
    from ..utils.flops import forward_sampled_flops

    config, fcs, sgs = _config(args, "cpu")
    core = config.core
    F, yB = len(fcs), fcs[0].size
    col_offs0 = sorted({sg.off0 for sg in sgs})
    K = len(col_offs0)
    S = len(sgs) // K
    xA = sgs[0].size
    budget = args.hbm_gib * 2**30 * 0.875

    class _Base:  # the slice of the executors' base the sizers read
        pass

    class _Stack:
        size = yB
        n_total = F

    base = _Base()
    base.core, base.mesh, base.stack = core, None, _Stack()
    real_bytes = facet_stack_bytes(base, real=True)
    G = grouped_col_group_for_budget(base, budget, K, S, xA, True, 1, 4,
                                     warn=False)
    sweeps = -(-K // G)
    h2d = sweeps * real_bytes
    flops = forward_sampled_flops(
        core, n_facets=F, facet_size=yB, n_columns=K,
        subgrids_per_column=S, subgrid_size=xA, real_facets=True,
        finish_passes=F,
    )
    print(f"{args.config}: N={config.image_size} F={F} yB={yB} "
          f"yN={core.yN_size} columns={K} subgrids={len(sgs)}")
    print(f"  real-plane facet stack: {real_bytes / 2**30:.1f} GiB "
          f"(host); single-card plan: column groups of G={G}, "
          f"{sweeps} facet-stack sweeps")
    print(f"  dense-input h2d volume {h2d / 2**30:.0f} GiB "
          f"(~{h2d / 2**30 / args.h2d_gibs:.0f} s at {args.h2d_gibs} GiB/s; "
          f"~zero with sparse facets synthesised on the card: "
          f"SparseRealFacet uploads coordinates only), analytic "
          f"{flops / 1e12:.0f} TFLOP (~{flops / 1e12 / args.tflops:.0f} s "
          f"at {args.tflops:.1f} TF/s, the card's measured facet-pass rate, "
          f"plan.model)")
    host_ram = real_bytes / 2**30
    if host_ram > args.host_ram_gib:
        n_hosts = int(np.ceil(host_ram / (args.host_ram_gib * 0.7)))
        print(f"  host RAM: stack EXCEEDS {args.host_ram_gib:.0f} GiB — "
              f"multi-host required: each of >= {n_hosts} processes builds "
              f"only ITS facet shard, {host_ram / n_hosts:.0f} GiB/process")
    n_mesh = int(np.ceil(2 * real_bytes / 2**30 / (args.hbm_gib * 0.55)))
    per_dev = 2 * real_bytes / n_mesh / 2**30
    print(f"  device-resident mesh: >= {n_mesh} cards hold the planar stack "
          f"sharded ({per_dev:.1f} GiB/card), sampled-DFT path, zero host "
          f"round trips")
    print(f"  card: {card_line()} (plan only: nothing measured)")


def measure(args):
    """The host-residency forward's stages at full shape on the device;
    returns the extrapolated forward seconds."""
    from ..api import _subgrid_masks
    from ..parallel import streamed as sm
    from ..utils.flops import resolve_colpass

    device = setup_torch(args)
    cuda = device.type == "cuda"
    config, fcs, sgs = _config(args, device)
    core = config.core
    F, yB = len(fcs), fcs[0].size
    m, yN, xA = core.xM_yN_size, core.yN_size, config.max_subgrid_size
    Cb = args.col_block
    n_blocks = -(-yB // Cb)
    col_offs0 = sorted({sg.off0 for sg in sgs})
    K = len(col_offs0)
    S = len(sgs) // K

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    print(f"{args.config}: N={config.image_size} F={F} yB={yB} yN={yN} "
          f"m={m} columns={K} subgrids={len(sgs)}")
    print(f"card: {card_line() if cuda else 'none (--device cpu)'}")
    facet_gib = F * yB * yB * 2 * 4 / 2**30  # planar f32 pairs
    print(f"raw facet stack: {facet_gib:.1f} GiB "
          f"({'fits' if facet_gib < args.hbm_gib * 0.8 else 'EXCEEDS'} "
          f"one device's {args.hbm_gib:.0f} GiB)")

    def timed(label, fn, *a):
        sync()
        t0 = time.perf_counter()
        out = fn(*a)
        sync()
        dt = time.perf_counter() - t0
        print(f"  {label}: {dt:.2f} s")
        return out, dt

    # -- one facet-pass block at full shape --------------------------------
    # the host-side block assembly: the executor stages a [F, yB, Cb, 2]
    # block per step (counted: it matters once the copies stop dominating)
    block = torch.empty((F, yB, Cb, 2), dtype=torch.float32,
                        pin_memory=cuda)
    t0 = time.perf_counter()
    block.zero_()
    block[..., 0] = 1.0
    t_asm = time.perf_counter() - t0
    print(f"  assemble facet block on host: {t_asm:.2f} s")
    foffs0 = torch.as_tensor([fc.off0 for fc in fcs], device=device)
    foffs1 = torch.as_tensor([fc.off1 for fc in fcs], device=device)
    dev_block, t_up_block = timed(
        f"upload facet block [{F},{yB},{Cb}] "
        f"({block.numel() * 4 / 2**30:.2f} GiB)",
        lambda: block.to(device, non_blocking=True))
    rows = torch.empty((K, F, m, Cb, 2), dtype=torch.float32, device=device)

    def facet_pass():
        return sm._facet_pass_fwd(core, dev_block, foffs0, col_offs0, rows)

    timed("facet pass (cold, incl. first use)", facet_pass)
    _, t_fp = timed("facet pass (warm)", facet_pass)
    host_rows = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=cuda)
    _, t_dl_block = timed(
        f"download rows [{K},{F},{m},{Cb}] "
        f"({rows.numel() * 4 / 2**30:.2f} GiB)",
        lambda: host_rows.copy_(rows, non_blocking=True))
    del rows, host_rows, dev_block, block

    # -- one column pass at full shape ------------------------------------
    col_host = torch.zeros((F, m, yB, 2), dtype=torch.float32,
                           pin_memory=cuda)
    NMBF, t_up_col = timed(
        f"upload column [{F},{m},{yB}] "
        f"({col_host.numel() * 4 / 2**30:.2f} GiB)",
        lambda: col_host.to(device, non_blocking=True))
    mode = resolve_colpass(core, F)
    ops = (None if mode == "fft"
           else sm._colpass_operators(core, foffs0, foffs1))
    col = [sg for sg in sgs if sg.off0 == col_offs0[0]]
    sg_offs = torch.as_tensor([(sg.off0, sg.off1) for sg in col],
                              device=device)
    masks = [_subgrid_masks(sg) for sg in col]
    m0 = torch.as_tensor(np.asarray([mk[0] for mk in masks]),
                         dtype=torch.float32, device=device)
    m1 = torch.as_tensor(np.asarray([mk[1] for mk in masks]),
                         dtype=torch.float32, device=device)

    def column_pass():
        return sm._column_pass_fwd(core, xA, mode, ops, NMBF, foffs0,
                                   foffs1, sg_offs, m0, m1)

    timed(f"column pass, {mode} body (cold, incl. first use)", column_pass)
    _, t_col = timed(f"column pass, {mode} body (warm)", column_pass)
    del NMBF, ops

    total = (n_blocks * (t_asm + t_up_block + t_fp + t_dl_block)
             + K * (t_up_col + t_col))
    compute = n_blocks * t_fp + K * t_col
    host = n_blocks * t_asm
    transfer = total - compute - host
    print(f"\nextrapolated full-cover forward ({n_blocks} blocks x facet "
          f"pass + {K} columns):")
    print(f"  device compute: {compute:8.1f} s")
    print(f"  host assembly:  {host:8.1f} s (block staging)")
    print(f"  transfer:       {transfer:8.1f} s (host<->device copies)")
    print(f"  TOTAL:          {total:8.1f} s  [estimated]")

    n_mesh = int(np.ceil(facet_gib / (args.hbm_gib * 0.55)))
    print(f"\nmulti-card alternative: a facet-sharded mesh of >= {n_mesh} "
          f"cards keeps the stack on the cards ({facet_gib / n_mesh:.1f} "
          f"GiB/card) and runs the sampled-DFT path with no host round "
          f"trip at all.")
    return total


def parser():
    """The tool's argument parser (``measure`` takes its namespace)."""
    from ..plan.model import CostCoefficients

    rates = CostCoefficients()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="64k[1]-n32k-1k")
    ap.add_argument("--col_block", type=int, default=512)
    ap.add_argument("--hbm_gib", type=float, default=80.0,
                    help="per-card memory for the fit and mesh-size "
                    "estimates (default 80: one H100)")
    ap.add_argument("--plan_only", action="store_true",
                    help="static plan (no device): slab-streamed "
                    "single-card + multi-host sizing, incl. 128k")
    ap.add_argument("--h2d_gibs", type=float,
                    default=round(rates.bytes_rate("spill.h2d")
                                  / 2**30, 2),
                    help="h2d bandwidth for --plan_only (default: the "
                    "card's measured pinned copy rate, plan.model)")
    ap.add_argument("--tflops", type=float,
                    default=rates.flops_rate("fwd.sampled_facet_pass")
                    / 1e12,
                    help="sustained TF/s for --plan_only (default: the "
                    "card's measured facet-pass rate, plan.model)")
    ap.add_argument("--host_ram_gib", type=float, default=96.0,
                    help="host RAM for the multi-host threshold")
    return add_device_arg(ap)


def main(argv=None):
    args = parser().parse_args(argv)
    if args.plan_only:
        plan_only(args)
        return 0
    measure(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
