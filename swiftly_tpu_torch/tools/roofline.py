"""Per-stage roofline of the streamed (sampled-DFT) forward on the card.

The port's twin of the JAX package's ``scripts/roofline.py``: times each
stage of one column group IN ISOLATION (synchronised, host clock, warm),
and prints one JSON line per stage with its seconds, FLOPs and TF/s, its
bytes, and its share of the card's bounds: the stage's least time (the
larger of its FLOPs over the peak rate of its arithmetic and its bytes
over the memory rate) over its measured time. The bounds are one H100
SXM's (NVIDIA's data sheet, dense, at 700 W): 67 TFLOP/s IEEE float32
(the hand-written kernels, and the governed products at
``SWIFTLY_PRECISION=highest``), 494.7 TFLOP/s TF32 (the governed products
at ``high`` / ``default``; `utils.flops.H100_TF32_TFLOPS`) and 3.35 TB/s.
Every line carries the card's name and power limit (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``). On the CPU
(``--device cpu``, a rehearsal) the times are the CPU's and no share of
the card's bounds is printed.

Stages (32k default):
  dispatch   - a tiny op and a synchronise: the per-launch floor
  synth      - sparse facet-slab synthesis (scatter into zeros)
  sampled    - the sampled-DFT facet pass of one column group (governed)
  column     - the group column pass (prepare + the body
               resolve_colpass picks: B1 on the planar backend)
  column-*   - the OTHER operator body (einsum vs kernel) at the same
               geometry: the evidence row of the plan's colpass table
  finish     - the group finish (the fft body only)

Usage: python -m swiftly_tpu_torch.tools.roofline [--config 32k[1]-n16k-512]
       [--G 8] [--reps 5] [--bwd] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ._cli import add_device_arg, card_line, catalogue_params, setup_torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="32k[1]-n16k-512")
    ap.add_argument("--G", type=int, default=8, help="column group size")
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--bwd", action="store_true",
                    help="also time the backward stages (group column "
                    "pass + adjoint sampled fold, fold_group=2)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = setup_torch(args)
    cuda = device.type == "cuda"

    from .. import (
        SwiftlyConfig,
        make_full_facet_cover,
        make_full_subgrid_cover,
        make_sparse_facet,
    )
    from ..api import _subgrid_masks
    from ..parallel import StreamedForward
    from ..parallel import streamed as sm
    from ..utils import flops as fl

    config = SwiftlyConfig(backend="planar", dtype=torch.float32,
                           device=device, **catalogue_params(args.config))
    fcs = make_full_facet_cover(config)
    sgs = make_full_subgrid_cover(config)
    sources = [(1.0, 1, 0)]
    fwd = StreamedForward(
        config,
        [(fc, make_sparse_facet(config.image_size, fc, sources))
         for fc in fcs],
        residency="device",
    )
    core = fwd.core  # at the knobs read when the executor was built
    F, yB = len(fcs), fcs[0].size
    m, xM = core.xM_yN_size, core.xM_size
    xA = sgs[0].size
    col_offs0 = sorted({sg.off0 for sg in sgs})
    G = min(args.G, len(col_offs0))
    grp = col_offs0[:G]
    by_col = {}
    for sg in sgs:
        by_col.setdefault(sg.off0, []).append(sg)
    S = len(by_col[grp[0]])
    card = card_line() if cuda else None
    tf32 = core.precision != "highest"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def timed(fn, *a, reps=args.reps):
        out = fn(*a)
        sync()  # warm
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*a)
        sync()
        return (time.perf_counter() - t0) / reps, out

    def emit(stage, dt, flops, bytes_touched=None, note="", governed=False):
        rec = {
            "stage": stage,
            "seconds": round(dt, 6),
            "gflops": round(flops / 1e9, 2),
            "tflops_per_s": round(flops / dt / 1e12, 3),
        }
        if bytes_touched is not None:
            rec["bytes"] = int(bytes_touched)
            rec["effective_GBps"] = round(bytes_touched / dt / 1e9, 1)
        if cuda:
            peak = (fl.H100_TF32_TFLOPS if governed and tf32
                    else fl.H100_F32_TFLOPS)
            t_ops = flops / (peak * 1e12)
            t_bytes = (bytes_touched or 0) / (fl.H100_HBM_TB_PER_S * 1e12)
            rec.update(
                peak_tflops=peak,
                pct_of_compute_peak=round(100 * t_ops / dt, 2),
                pct_of_hbm=round(100 * t_bytes / dt, 2),
                bound_s=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                roofline_share=round(max(t_ops, t_bytes) / dt, 4),
                card=card)
        rec["device"] = str(device)
        rec["precision"] = core.precision if governed else "ieee"
        if note:
            rec["note"] = note
        print(json.dumps(rec), flush=True)
        return rec

    # -- dispatch floor ---------------------------------------------------
    tiny = torch.ones((8, 128), dtype=torch.float32, device=device)

    def one_add(x):
        out = x + 1.0
        sync()
        return out

    dt, _ = timed(one_add, tiny, reps=10)
    emit("dispatch", dt, 0.0,
         note="one launch and a synchronise: the per-step floor every "
              "streamed stage pays at least once")
    t_lat = dt

    # -- sparse slab synthesis ------------------------------------------
    dt, slab = timed(fwd._synth_slab, 0, 1)
    emit("synth", dt, 0.0, bytes_touched=slab.numel() * slab.element_size(),
         note="scatter into zeros; replaces a multi-GB upload")
    del slab

    # -- sampled facet pass ----------------------------------------------
    krows = torch.as_tensor(sm.sampled_row_indices(core, grp), device=device)
    e0 = torch.as_tensor(
        (np.asarray(fwd.stack.offs0) - yB // 2).astype(np.int64),
        device=device)
    stack = fwd._synth_slab(0, fwd.stack.n_total)
    dt_sampled, buf = timed(
        lambda: sm._facet_pass_sampled(core, (stack,), e0, krows,
                                       real_facets=True))
    flops = fl.sampled_facet_pass_flops(core, F, yB, G * m, True)
    nbytes = (stack.numel() + buf.numel()) * 4
    emit("sampled", dt_sampled, flops, bytes_touched=nbytes, governed=True,
         note=f"[{G * m},{yB}]x[{F},{yB},{yB}] real product pair "
              f"(SWIFTLY_PRECISION={core.precision})")
    del stack

    # -- column pass --------------------------------------------------------
    sg_offs_g = torch.as_tensor(
        np.asarray([[(sg.off0, sg.off1) for sg in by_col[o]] for o in grp],
                   np.int64), device=device)
    ms = [[_subgrid_masks(sg) for sg in by_col[o]] for o in grp]
    m0_g = torch.as_tensor(np.asarray([[mk[0] for mk in r] for r in ms]),
                           dtype=core.real_dtype, device=device)
    m1_g = torch.as_tensor(np.asarray([[mk[1] for mk in r] for r in ms]),
                           dtype=core.real_dtype, device=device)
    foffs0, foffs1 = fwd._base._foffs0, fwd._base._foffs1
    colpass = fl.resolve_colpass(core, F)
    col_flops = {mode: G * fl.column_pass_flops(core, F, S, xA, mode)
                 for mode in ("kernel", "einsum", "fft")}
    notes = {
        "kernel": f"prepare + kernel B1 (K={F * m}) incl. crop for {G} "
                  f"columns x {S} subgrids (all {F} facets)",
        "einsum": f"prepare + operator einsums (K={F * m}) incl. crop for "
                  f"{G} columns x {S} subgrids (all {F} facets)",
        "fft": f"prepare + per-subgrid FFT chain for {G} columns x {S} "
               f"subgrids (all {F} facets)",
    }
    if colpass in ("kernel", "einsum"):
        ops = fwd._operators()

        def run_col(mode):
            return sm._column_pass_fwd_group(core, xA, mode, ops, buf,
                                             foffs0, foffs1, sg_offs_g,
                                             m0_g, m1_g)

        dt_column, out = timed(run_col, colpass)
        emit("column", dt_column, col_flops[colpass],
             bytes_touched=(buf.numel() + out.numel()) * 4,
             note=notes[colpass], governed=colpass == "einsum")
        other = "einsum" if colpass == "kernel" else "kernel"
        if other == "einsum" or core.backend == "planar":
            dt_other, out = timed(run_col, other)
            emit(f"column-{other}", dt_other, col_flops[other],
                 bytes_touched=(buf.numel() + out.numel()) * 4,
                 note=notes[other] + " [comparison row: the body "
                      "resolve_colpass does not pick here]",
                 governed=other == "einsum")
        del out
        dt_fin = 0.0  # crop and masks are inside the column stage
    else:
        def run_step():
            acc = torch.zeros((G, S, xM, xM, 2), dtype=torch.float32,
                              device=device)
            return sm._column_slab_step(core, "fft", None, buf, foffs0,
                                        foffs1, sg_offs_g, acc)

        dt_column, acc = timed(run_step)
        emit("column", dt_column, col_flops["fft"],
             bytes_touched=(buf.numel() + acc.numel()) * 4,
             note=notes["fft"])
        dt_fin, fin = timed(lambda: sm._column_group_finish(
            core, "fft", xA, acc, sg_offs_g, m0_g, m1_g))
        emit("finish", dt_fin, 0.0, bytes_touched=fin.numel() * 4,
             note="once per group")
        del acc, fin

    # Full-cover bracket from the per-group stage sum: each timed stage
    # embeds one synchronise (~t_lat); the real pipeline overlaps them.
    n_groups = -(-len(col_offs0) // G)
    per_group = dt_sampled + dt_column + dt_fin
    n_stages = 2 if colpass in ("kernel", "einsum") else 3
    print(json.dumps({
        "stage": "model",
        "full_cover_lower_s": round(n_groups * (per_group
                                                - n_stages * t_lat), 3),
        "full_cover_upper_s": round(n_groups * (per_group + 2 * t_lat), 3),
        "device": str(device), "card": card,
        "note": f"{len(col_offs0)} columns in {n_groups} groups of {G}; "
                "the measured full-cover forward should fall inside",
    }), flush=True)

    if not args.bwd:
        return 0

    # -- backward stages ----------------------------------------------------
    del buf
    from .. import StreamedBackward

    bwd = StreamedBackward(config, fcs, residency="sampled", fold_group=2)
    bcore = bwd.core
    Gb = min(2, G)
    rng = np.random.default_rng(3)
    sgs_dev = torch.as_tensor(
        rng.standard_normal((Gb, S, xA, xA, 2)).astype(np.float32),
        device=device)
    bmode = fl.resolve_colpass_bwd(bcore, F)
    bops = bwd._operators(bmode)
    m1 = torch.as_tensor(np.asarray(fwd.stack.masks1), dtype=torch.float32,
                         device=device)
    dt_bcol, rows = timed(lambda: sm._column_pass_bwd_group(
        bcore, yB, bmode, bops, sgs_dev, sg_offs_g[:Gb], foffs0, foffs1, m1))
    emit("bwd-column", dt_bcol,
         Gb * fl.bwd_column_pass_flops(bcore, F, S, yB, xA, bmode),
         bytes_touched=(sgs_dev.numel() + rows.numel()) * 4,
         note=f"{Gb}-column backward group pass ({bmode} body)",
         governed=bmode == "einsum")
    krows_b = torch.as_tensor(sm.sampled_row_indices(bcore, grp[:Gb]),
                              device=device)

    def run_fold():
        acc = torch.zeros((F, yB, yB, 2), dtype=torch.float32, device=device)
        sm._bwd_sampled_fold(bcore, acc, rows, e0, krows_b)
        return acc.sum()

    dt_fold, _ = timed(run_fold)
    emit("bwd-fold", dt_fold, fl.bwd_fold_flops(bcore, F, yB, Gb * m),
         bytes_touched=rows.numel() * 4 + 2 * F * yB * yB * 4 * 2,
         note=f"adjoint sampled fold (kernel B2 on the planar backend), "
              f"K={Gb * m} rows -> [F, yB, yB] (incl. the zeros rebuild)")
    n_folds = -(-len(col_offs0) // Gb)
    print(json.dumps({
        "stage": "bwd-model",
        "full_cover_lower_s": round(
            n_folds * (dt_bcol + dt_fold - 2 * t_lat), 3),
        "full_cover_upper_s": round(
            n_folds * (dt_bcol + dt_fold + 2 * t_lat), 3),
        "device": str(device), "card": card,
        "note": f"{len(col_offs0)} columns in {n_folds} fold groups of "
                f"{Gb}; the round trip adds this to the forward model",
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
