"""Executable derivation record: the 1D streaming FT, step by step.

The port's twin of the JAX package's ``scripts/derivation_demo.py``: it
builds the 1D facet->subgrid pipeline primitive by primitive on a small
config (float64, the complex ``torch`` backend), prints the intermediate
shapes and names (BF, MBF, NMBF), and emits an error map over (source
position x subgrid offset) plus a per-primitive timing table. The same
flags and output, plus ``--device`` (default cuda).

Usage:
    python -m swiftly_tpu_torch.tools.derivation_demo [--N 1024]
        [--csv errmap.csv] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ._cli import add_device_arg, setup_torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--N", type=int, default=1024)
    ap.add_argument("--csv", default=None,
                    help="write the error map as CSV (source, sg_off, rms)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = setup_torch(args)

    from ..ops import SwiftlyCore
    from ..ops.oracle import make_facet_from_sources, make_subgrid_from_sources

    # Small exact config (the tests' family): N=1024 scaled by --N/1024
    if args.N < 1024 or args.N % 1024:
        ap.error("--N must be a multiple of 1024 (sizes scale from the "
                 "N=1024 test config)")
    s = args.N // 1024
    N, yB, yN, xA, xM = args.N, 416 * s, 512 * s, 228 * s, 256 * s
    core = SwiftlyCore(13.5625, N, xM, yN, backend="torch",
                       dtype=torch.complex128, device=device)
    print(f"config: N={N} yB={yB} yN={yN} xA={xA} xM={xM} "
          f"contribution={core.xM_yN_size} "
          f"(= xM*yN/N — the ONLY data that travels facet->subgrid)")

    def host(a):
        return core.as_complex(a)

    # -- step-by-step pipeline on one facet, one subgrid ------------------
    src = [(1.0, 40)]
    facet = make_facet_from_sources(src, N, yB, [0])
    print(f"\nF    facet                 {facet.shape}  (image space)")

    t = {}

    def step(name, fn, *a):
        t0 = time.time()
        out = fn(*a)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t[name] = time.time() - t0
        return out

    BF = step("prepare_facet", core.prepare_facet, facet, 0, 0)
    print(f"BF   prepare_facet(F)      {tuple(BF.shape)}  (Fb-weighted, "
          f"padded to yN, iFFT: image space at padded resolution)")

    sg_off = xA
    MBF = step("extract_from_facet", core.extract_from_facet, BF, sg_off, 0)
    print(f"MBF  extract_from_facet    {tuple(MBF.shape)}  (the compact "
          f"window this subgrid needs — the 'M' mid-extraction)")

    NMBF = step("add_to_subgrid", core.add_to_subgrid, MBF, 0, 0)
    print(f"NMBF add_to_subgrid        {tuple(NMBF.shape)}  (FFT, Fn-window "
          f"'N', embedded in the padded subgrid frame; summing these over "
          f"facets is the facet sum of a mesh)")

    subgrid = host(step("finish_subgrid", core.finish_subgrid, NMBF,
                        [sg_off], xA))
    truth = make_subgrid_from_sources(src, N, xA, [sg_off])
    rms = float(np.sqrt(np.mean(np.abs(subgrid - truth) ** 2)))
    print(f"S    finish_subgrid        {subgrid.shape}  (iFFT + crop)")
    print(f"\nRMS vs direct DFT oracle: {rms:.3e}")

    print(f"\nper-primitive wall-clock (first call, on {device}):")
    for name, dt in t.items():
        print(f"  {name:22s} {dt*1e3:8.1f} ms")

    # -- error map: source position x subgrid offset ----------------------
    print("\nerror map (max RMS per cell, 1D):")
    sg_offs = list(range(0, N, max(xA, N // 8)))
    src_xs = list(range(-N // 2, N // 2, max(1, N // 8)))
    rows = []
    for x in src_xs:
        facet = make_facet_from_sources([(1.0, x)], N, yB, [0])
        BF = core.prepare_facet(facet, 0, 0)
        line = []
        for off in sg_offs:
            MBF = core.extract_from_facet(BF, off, 0)
            NMBF = core.add_to_subgrid(MBF, 0, 0)
            sg = host(core.finish_subgrid(NMBF, [off], xA))
            truth = make_subgrid_from_sources([(1.0, x)], N, xA, [off])
            err = float(np.sqrt(np.mean(np.abs(sg - truth) ** 2)))
            line.append(err)
            rows.append((x, off, err))
        print(f"  src {x:6d}: " + " ".join(f"{e:.1e}" for e in line))
    print("(sources beyond the facet's yB window correctly do not appear "
          "— their rows show the masked-truth error instead)")

    if args.csv:
        with open(args.csv, "w") as fh:
            fh.write("source_x,subgrid_off,rms\n")
            for x, off, err in rows:
                fh.write(f"{x},{off},{err:.6e}\n")
        print(f"error map written to {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
