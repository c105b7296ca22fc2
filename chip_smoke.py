#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``swiftly_tpu_torch``) on the card through the entry
points a user calls, builds its hand-written kernels from the sources in
this checkout, and holds each kernel against its plain PyTorch version:

1. device: the card's name and power limit;
2. build: the CUDA source of kernel B3 (``swiftly_tpu_torch/csrc``), with
   ptxas's registers/shared memory/spills;
3. kernel B3 (planar complex matmul) against its plain version at a
   ragged shape, in float32 and float64;
4. a float64 round trip at ``1k[1]-n512-256`` on the card, fused and per
   subgrid, against the analytic oracle;
5. the main path: the fused round trip (``SwiftlyForward.all_subgrids``
   then ``backward_all``) at ``32k[1]-n16k-512``, planar float32, from
   facets held as numpy arrays on the host, a warm run and a timed run,
   checked against the oracle on sampled subgrids and on all facets;
6. B3 against its plain version and one PyTorch library call, timed with
   CUDA events at every shape the main path gave it (the most frequent
   first).

Every phase that fails ends the run with a non-zero exit code. The line
before the last is the ``kernels`` JSON record; the last line is
``{"ok": true, "device": {...}}``. Needs one CUDA card; exits non-zero,
and prints no result, without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

MAIN_CONFIG = "32k[1]-n16k-512"
SMALL_CONFIG = "1k[1]-n512-256"

# Centre-relative source positions (fractions of N): the eight spread
# sources of the JAX package's benchmark, so every subgrid column band
# carries signal and the oracle check has power everywhere.
SOURCE_FRACTIONS = [
    (-0.41, -0.37), (-0.23, 0.11), (-0.05, 0.43), (0.02, -0.19),
    (0.17, 0.31), (0.29, -0.45), (0.36, 0.07), (0.44, -0.02),
]

# The reference's own round-trip bound for float64 (tests/conftest.py),
# at its test source: one unit point source near the centre.
F64_ROUNDTRIP_RMS = 3e-10
SMALL_SOURCES = [(1.0, 1, 0)]

# Float32 main path. Subgrid values are at most sum(|intensity|) / N**2
# (~1.4e-8 at 32k); the f32 matmul-DFT chain (float32 products and sums,
# no TF32) loses ~1e-7 of that per stage, and a wrong offset or window
# gives errors of the order of the signal itself. So a subgrid's RMS
# error must stay below 1e-4 of that scale (two orders above the
# rounding, three below a fault).
SUBGRID_REL_RMS = 1e-4
# Facets hold the sources at amplitude 1..2.75 on single pixels; the
# round trip's f32 rounding spreads to ~1e-8 RMS over a facet, a fault to
# ~1e-4 or more. Bound: 1e-6.
FACET_RMS = 1e-6
MIN_SUBGRID_SAMPLES = 100

# Kernel checks: float32 sum-reorder bound (tests/test_pallas.py), and a
# float64 bound far above f64 rounding over K <= 1024 terms.
KERNEL_REL_TOL = {"float32": 1e-5, "float64": 1e-12}


class PhaseFailed(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def log(msg):
    print(msg, flush=True)


def sources_for(N):
    return [
        (1.0 + 0.25 * k, int(a * N), int(b * N))
        for k, (a, b) in enumerate(SOURCE_FRACTIONS)
    ]


# -- phase 2: build ----------------------------------------------------------


def build_b3():
    """Build kernel B3 from its source and print ptxas's report."""
    from swiftly_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path, report = _build.build("cmatmul")
    log(f"built cmatmul: {path.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "ptxas" in line or "spill" in line:
            log(f"  {line.strip()}")


# -- kernel checks -----------------------------------------------------------


def _planes(torch, shape_z, shape_w, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    zr, zi = (torch.randn(shape_z, generator=g, device="cuda", dtype=dtype)
              for _ in range(2))
    wr, wi = (torch.randn(shape_w, generator=g, device="cuda", dtype=dtype)
              for _ in range(2))
    return zr, zi, wr, wi


def _cuda_ms(torch, fn, iters):
    """Mean device time of `fn` over `iters` launches (CUDA events, after
    two warm-up calls)."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def check_cmatmul(torch, shape, dtype, seed=0, timed=False):
    """B3 against its plain version at one (B, K, N); with `timed`, also
    the kernel, plain and library times and the bound."""
    from swiftly_tpu_torch.ops.kernels import cmatmul, cmatmul_plain
    from swiftly_tpu_torch.utils.flops import H100_F32_TFLOPS, H100_HBM_TB_PER_S

    B, K, N = shape
    zr, zi, wr, wi = _planes(torch, (B, K), (K, N), dtype, seed)
    outr, outi = cmatmul(zr, zi, wr, wi)
    torch.cuda.synchronize()
    pr, pi = cmatmul_plain(zr, zi, wr, wi)
    max_abs = max((outr - pr).abs().max().item(), (outi - pi).abs().max().item())
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    name = str(dtype).replace("torch.", "")
    rel = max_abs / scale
    again = cmatmul(zr, zi, wr, wi)
    bit_identical = bool(torch.equal(again[0], outr) and torch.equal(again[1], outi))
    res = {"shape": [B, K, N], "dtype": name, "max_abs_err": max_abs,
           "max_rel_err": rel, "tol_rel": KERNEL_REL_TOL[name],
           "bit_identical_rerun": bit_identical}
    require(rel <= KERNEL_REL_TOL[name],
            f"cmatmul {shape} {name}: relative error {rel:.3e} > "
            f"{KERNEL_REL_TOL[name]:.0e}")
    require(bit_identical, f"cmatmul {shape} {name}: reruns differ")
    if timed:
        iters = max(3, min(50, int(2e11 / (8 * B * K * N))))
        res["ms"] = _cuda_ms(torch, lambda: cmatmul(zr, zi, wr, wi), iters)
        res["plain_ms"] = _cuda_ms(
            torch, lambda: cmatmul_plain(zr, zi, wr, wi), iters)
        zc, wc = torch.complex(zr, zi), torch.complex(wr, wi)
        res["library_ms"] = _cuda_ms(torch, lambda: torch.matmul(zc, wc), iters)
        res["library_call"] = f"torch.matmul on {zc.dtype}"
        item = zr.element_size()
        nbytes = item * (2 * B * K + 2 * K * N + 2 * B * N)
        flops = 8 * B * K * N
        # H100 SXM peaks (utils/flops.py); B3's products are plain f32 FMAs
        # and it is timed in float32 only
        t_bytes = nbytes / (H100_HBM_TB_PER_S * 1e12)
        t_ops = flops / (H100_F32_TFLOPS * 1e12)
        res["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        res["bound_by"] = "bytes" if t_bytes > t_ops else "operations"
        res["tflops"] = flops / res["ms"] / 1e9
    log(f"cmatmul {tuple(shape)} {name}: " + ", ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in res.items() if k not in ("shape", "dtype")))
    return res


# -- round trips ------------------------------------------------------------


def roundtrip_small(torch, device="cuda"):
    """Float64 round trip at SMALL_CONFIG, fused and per subgrid."""
    import swiftly_tpu_torch as st

    stats = st.cmatmul_stats
    cfg = st.SwiftlyConfig(backend="planar", dtype=torch.float64,
                           device=device, **st.SWIFT_CONFIGS[SMALL_CONFIG])
    fcs = st.make_full_facet_cover(cfg)
    sgcs = st.make_full_subgrid_cover(cfg)
    tasks = [(fc, st.make_facet(cfg.image_size, fc, SMALL_SOURCES)) for fc in fcs]
    out = {}
    stats.reset()
    subgrids = st.SwiftlyForward(cfg, tasks).all_subgrids(sgcs)
    facets = st.backward_all(cfg, fcs, list(zip(sgcs, subgrids)))
    out["fused_launches"] = stats.launches
    out["fused_facet_rms"] = max(
        st.check_facet(cfg.image_size, fc, cfg.core.as_complex(facets[i]),
                       SMALL_SOURCES) for i, fc in enumerate(fcs))
    fwd = st.SwiftlyForward(cfg, tasks)
    bwd = st.SwiftlyBackward(cfg, fcs)
    for sg in sgcs:
        bwd.add_new_subgrid_task(sg, fwd.get_subgrid_task(sg))
    facets2 = bwd.finish()
    out["per_subgrid_facet_rms"] = max(
        st.check_facet(cfg.image_size, fc, cfg.core.as_complex(facets2[i]),
                       SMALL_SOURCES) for i, fc in enumerate(fcs))
    out["fused_vs_per_subgrid_max_abs"] = float(
        (facets - facets2).abs().max().item())
    log(f"{SMALL_CONFIG} f64 round trip: {out}")
    for key in ("fused_facet_rms", "per_subgrid_facet_rms"):
        require(out[key] < F64_ROUNDTRIP_RMS,
                f"{SMALL_CONFIG} {key} {out[key]:.3e} >= {F64_ROUNDTRIP_RMS}")
    if device == "cuda":
        require(out["fused_launches"] > 0, "B3 was not launched at 1k")
    return out


def roundtrip_main(torch, config_name=MAIN_CONFIG, device="cuda",
                   dtype=None, warm=True):
    """The main path: fused forward + backward round trip, planar."""
    import swiftly_tpu_torch as st
    from swiftly_tpu_torch.utils.flops import (
        backward_batched_flops, forward_batched_flops)

    dtype = torch.float32 if dtype is None else dtype
    stats = st.cmatmul_stats
    cfg = st.SwiftlyConfig(backend="planar", dtype=dtype, device=device,
                           **st.SWIFT_CONFIGS[config_name])
    core = cfg.core
    N = cfg.image_size
    sources = sources_for(N)
    fcs = st.make_full_facet_cover(cfg)
    sgcs = st.make_full_subgrid_cover(cfg)
    t0 = time.perf_counter()
    facets_in = [st.make_facet(N, fc, sources) for fc in fcs]  # numpy, host
    setup_s = time.perf_counter() - t0
    log(f"{config_name}: {len(fcs)} facets of {fcs[0].size}, {len(sgcs)} "
        f"subgrids of {sgcs[0].size}; facets made on the host in "
        f"{setup_s:.1f} s")

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def one_run():
        # forward time includes moving the host facets to the card
        t0 = time.perf_counter()
        fwd = st.SwiftlyForward(cfg, list(zip(fcs, facets_in)))
        subgrids = fwd.all_subgrids(sgcs)
        sync()
        t_fwd = time.perf_counter() - t0
        t0 = time.perf_counter()
        facets = st.backward_all(cfg, fcs, list(zip(sgcs, subgrids)))
        sync()
        return subgrids, facets, t_fwd, time.perf_counter() - t0

    if warm:
        one_run()
        log(f"{config_name}: warm run done")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    stats.reset()
    subgrids, facets, t_fwd, t_bwd = one_run()
    launches = stats.launches
    shapes = dict(stats.shapes)
    n_cols = len({sg.off0 for sg in sgcs})
    counts = dict(n_facets=len(fcs), facet_size=fcs[0].size, n_columns=n_cols,
                  subgrids_per_column=len(sgcs) // n_cols,
                  subgrid_size=sgcs[0].size)
    fwd_flops = forward_batched_flops(core, **counts)
    bwd_flops = backward_batched_flops(core, **counts)
    out = {
        "config": config_name, "dtype": str(dtype).replace("torch.", ""),
        "forward_s": t_fwd, "backward_s": t_bwd, "roundtrip_s": t_fwd + t_bwd,
        "forward_tflop": fwd_flops / 1e12, "backward_tflop": bwd_flops / 1e12,
        "forward_tflops_per_s": fwd_flops / t_fwd / 1e12,
        "backward_tflops_per_s": bwd_flops / t_bwd / 1e12,
        "cmatmul_launches": launches,
        # [B, K, N, launches], most frequent first (ties: most work)
        "cmatmul_shapes": sorted(
            ([*k, v] for k, v in shapes.items()),
            key=lambda r: (r[3], r[0] * r[1] * r[2]), reverse=True,
        ),
        "facet_setup_s": setup_s,
    }
    if device == "cuda":
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"{config_name} timed run: forward {t_fwd:.3f} s, backward "
        f"{t_bwd:.3f} s, B3 launches {launches}")

    # Accuracy: sampled subgrids and every facet against the oracle.
    n = len(sgcs)
    stride = max(1, n // MIN_SUBGRID_SAMPLES)
    idxs = list(range(0, n, stride))
    scale = sum(abs(s[0]) for s in sources) / N**2
    sg_rms = [st.check_subgrid(N, sgcs[i], core.as_complex(subgrids[i]),
                               sources) for i in idxs]
    del subgrids
    f_rms = [st.check_facet(N, fc, core.as_complex(facets[i]), sources)
             for i, fc in enumerate(fcs)]
    out.update(n_subgrid_samples=len(idxs), max_subgrid_rms=max(sg_rms),
               subgrid_rms_bound=SUBGRID_REL_RMS * scale,
               max_facet_rms=max(f_rms), facet_rms_bound=FACET_RMS)
    log(f"{config_name} accuracy: max subgrid RMS {max(sg_rms):.3e} over "
        f"{len(idxs)} samples (bound {SUBGRID_REL_RMS * scale:.3e}), max "
        f"facet RMS {max(f_rms):.3e} over {len(fcs)} facets (bound "
        f"{FACET_RMS:.0e})")
    require(all(np.isfinite(sg_rms)) and all(np.isfinite(f_rms)),
            "non-finite RMS")
    require(max(sg_rms) <= SUBGRID_REL_RMS * scale, "subgrid RMS over bound")
    require(max(f_rms) <= FACET_RMS, "facet RMS over bound")
    if device == "cuda":
        require(launches > 0, "the main path launched B3 no time")
    return out


# -- main -------------------------------------------------------------------


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    import swiftly_tpu_torch  # noqa: F401  (fails outside the repo)

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(smi)

    build_b3()
    for dt in (torch.float32, torch.float64):
        check_cmatmul(torch, (300, 228, 228), dt)
    roundtrip_small(torch)
    main_run = roundtrip_main(torch)
    launches = main_run["cmatmul_launches"]

    # B3 at every shape the main path gave it, most frequent first (ties:
    # most work); float64 checks at the first two.
    shapes = [tuple(r[:3]) for r in main_run["cmatmul_shapes"]]
    timed = [check_cmatmul(torch, s, torch.float32, seed=i + 1, timed=True)
             for i, s in enumerate(shapes)]
    for i, s in enumerate(shapes[:2]):
        check_cmatmul(torch, s, torch.float64, seed=i + 1)
    # device time B3 spends in one round trip: launches x time per shape
    b3_s = sum(r[3] * t["ms"] for r, t in zip(main_run["cmatmul_shapes"], timed)) / 1e3
    main_run["b3_seconds_per_roundtrip"] = b3_s
    log(f"B3 device time per round trip: {b3_s:.3f} s of "
        f"{main_run['roundtrip_s']:.3f} s")
    top = timed[0]
    kernels = {"kernels": [{
        "name": "cmatmul",
        "route": "cuda",
        "source": "swiftly_tpu_torch/csrc/cmatmul.cu",
        "replaces": "swiftly_tpu/ops/pallas_kernels.py:102",
        "launches": launches,
        "max_abs_err": top["max_abs_err"],
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "shape": top["shape"],
        "check": "pass",
        "shapes": [{k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by", "max_abs_err",
                                      "tflops")}
                   for r in timed],
    }]}
    log(json.dumps({"roundtrip": {k: main_run[k] for k in (
        "config", "forward_s", "backward_s", "peak_memory_gib",
        "forward_tflops_per_s", "backward_tflops_per_s", "cmatmul_launches",
        "b3_seconds_per_roundtrip", "max_subgrid_rms", "max_facet_rms")}}))
    log(smi)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
