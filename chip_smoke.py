#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``swiftly_tpu_torch``) on the card through the entry
points a user calls, builds its hand-written kernels from the sources in
this checkout, and holds each kernel against its plain PyTorch version:

1. device: the card's name and power limit;
2. build: the CUDA sources of kernels B3, B1 and B2
   (``swiftly_tpu_torch/csrc``), one nvcc each, started together, with
   ptxas's registers/shared memory/spills;
3. kernel B3 (planar complex matmul) against its plain version at a
   ragged shape, in float32 and float64; kernels B1 (column pass, both
   forms) and B2 (sampled fold) likewise at ragged shapes;
4. float64 round trips at ``1k[1]-n512-256`` on the card against the
   analytic oracle: fused and per subgrid, then streamed;
5. the fused round trip (``SwiftlyForward.all_subgrids`` then
   ``backward_all``) at ``32k[1]-n16k-512``, planar float32, from facets
   held as numpy arrays on the host, a warm run and a timed run, checked
   against the oracle on sampled subgrids and on all facets;
6. the main path of the streamed slice: ``StreamedForward(residency=
   "device")`` fed by ``feed_backward_passes`` into a
   ``StreamedBackward(residency="sampled")`` and ``finish_device``, at
   ``32k[1]-n16k-512``, planar float32, from real facet planes on the
   host; a warm run and a timed run, checked against the oracle on
   sampled subgrids and on all facets, the two runs' facets bit-identical;
   then one more round trip under torch.profiler, its device-busy time
   against its own synchronised window;
7. B3, B1 and B2 against their plain versions and one PyTorch library
   call, timed with CUDA events at every shape each 32k path gave them
   (B3 at the fused path's shapes and at the streamed path's).

The launch counters are set to 0 just before each 32k path runs and read
just after it. Every phase that fails ends the run with a non-zero exit
code. The line before the last is the ``kernels`` JSON record: per
kernel, ``launches`` and the times beside it are the streamed path's
(the main path of the streamed slice), and ``paths`` holds each 32k
path's launches with the times at that path's shapes. The last line is
``{"ok": true, "device": {...}}``. Needs one CUDA card; exits non-zero,
and prints no result, without one.
"""

from __future__ import annotations

import hashlib
import json
import resource
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

# Ragged check shapes: no dimension a multiple of the kernels' 64-wide
# tiles or 16-deep slices.
B1_RAGGED = [  # (S, F, Fx, M, P, Q, N, reduce_f)
    (5, 3, 3, 40, 24, 24, 40, True),
    (5, 3, 1, 70, 33, 50, 90, False),
    (3, 2, 2, 130, 17, 70, 65, True),
]
B2_RAGGED = [(3, 70, 100, 50), (2, 130, 200, 33)]  # (F, B, J, R)

KERNEL_SOURCES = {
    "cmatmul": ("swiftly_tpu_torch/csrc/cmatmul.cu",
                "swiftly_tpu/ops/pallas_kernels.py:102"),
    "colpass": ("swiftly_tpu_torch/csrc/colpass.cu",
                "swiftly_tpu/ops/pallas_kernels.py:265"),
    "fold": ("swiftly_tpu_torch/csrc/fold.cu",
             "swiftly_tpu/ops/pallas_kernels.py:171"),
}


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


def build_kernels():
    """Build kernels B3, B1 and B2 from their sources (one nvcc each,
    started together) and print ptxas's reports."""
    from swiftly_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all(KERNEL_SOURCES)
    log(f"built {', '.join(built)} in {time.perf_counter() - t0:.1f} s")
    for name, (path, report) in built.items():
        log(f"{name}: {path.relative_to(ROOT)}")
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


def _bound(flops, nbytes):
    """(bound_ms, bound_by) on an H100 SXM (utils/flops.py): the larger of
    the operations over the f32 FMA peak and the bytes over the memory
    rate. The kernels' products are plain FMAs, timed in float32."""
    from swiftly_tpu_torch.utils.flops import H100_F32_TFLOPS, H100_HBM_TB_PER_S

    t_bytes = nbytes / (H100_HBM_TB_PER_S * 1e12)
    t_ops = flops / (H100_F32_TFLOPS * 1e12)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def _iters(flops):
    return max(3, min(50, int(2e11 / max(flops, 1))))


def _interleaved(torch, shape, dtype, g):
    """A random planar (..., 2) tensor, as the port's data lie."""
    return torch.randn(tuple(shape) + (2,), generator=g, device="cuda",
                       dtype=dtype)


def check_colpass(torch, shape, dtype, seed=0, timed=False):
    """B1 against its plain version at one (S, F, Fx, M, P, Q, N,
    reduce_f), its planes strided views of interleaved tensors as on the
    main path; with `timed`, also the kernel, plain and library times and
    the bound."""
    from swiftly_tpu_torch.ops.kernels import colpass, colpass_plain

    S, F, Fx, M, P, Q, N, reduce_f = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = _interleaved(torch, (F, M, P), dtype, g)
    if Fx == F:  # a gathered, permuted view, as the forward body passes it
        X = _interleaved(torch, (F, P, S, Q), dtype, g).permute(2, 0, 1, 3, 4)
    else:
        X = _interleaved(torch, (S, P, Q), dtype, g)[:, None]
    Bm = _interleaved(torch, (F, Q, N), dtype, g)
    planes = (A[..., 0], A[..., 1], X[..., 0], X[..., 1], Bm[..., 0],
              Bm[..., 1])
    outr, outi = colpass(*planes, reduce_f=reduce_f)
    torch.cuda.synchronize()
    pr, pi = colpass_plain(*planes, reduce_f=reduce_f)
    max_abs = max((outr - pr).abs().max().item(), (outi - pi).abs().max().item())
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    name = str(dtype).replace("torch.", "")
    rel = max_abs / scale
    again = colpass(*planes, reduce_f=reduce_f)
    bit_identical = bool(torch.equal(again[0], outr)
                         and torch.equal(again[1], outi))
    res = {"shape": list(shape), "dtype": name, "max_abs_err": max_abs,
           "max_rel_err": rel, "tol_rel": KERNEL_REL_TOL[name],
           "bit_identical_rerun": bit_identical}
    require(rel <= KERNEL_REL_TOL[name],
            f"colpass {shape} {name}: relative error {rel:.3e} > "
            f"{KERNEL_REL_TOL[name]:.0e}")
    require(bit_identical, f"colpass {shape} {name}: reruns differ")
    if timed:
        flops = 8 * S * F * (M * P * Q + M * Q * N)
        n_out = S * M * N * (1 if reduce_f else F)
        nbytes = 2 * A.element_size() * (F * M * P + S * Fx * P * Q
                                         + F * Q * N + n_out)
        iters = _iters(flops)
        res["ms"] = _cuda_ms(
            torch, lambda: colpass(*planes, reduce_f=reduce_f), iters)
        res["plain_ms"] = _cuda_ms(
            torch, lambda: colpass_plain(*planes, reduce_f=reduce_f), iters)
        Ac, Xc, Bc = (torch.view_as_complex(t.contiguous()) for t in (A, X, Bm))
        if reduce_f:
            lib = lambda: torch.einsum("fmp,sfpq,fqn->smn", Ac, Xc, Bc)
        else:
            Xs = Xc[:, 0]
            lib = lambda: torch.einsum("fmp,spq,fqn->sfmn", Ac, Xs, Bc)
        res["library_ms"] = _cuda_ms(torch, lib, iters)
        res["library_call"] = f"torch.einsum on {Ac.dtype}"
        res["bound_ms"], res["bound_by"] = _bound(flops, nbytes)
        res["tflops"] = flops / res["ms"] / 1e9
    log(f"colpass {tuple(shape)} {name}: " + ", ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in res.items() if k not in ("shape", "dtype")))
    return res


def check_fold(torch, shape, dtype, seed=0, timed=False):
    """B2 against its plain version at one (F, B, J, R), updating a row
    block of an interleaved [F, B + 3, J, 2] accumulator in place as the
    main path does; with `timed`, also the times and the bound."""
    from swiftly_tpu_torch.ops.kernels import fold, fold_plain

    F, B, J, R = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    acc0 = _interleaved(torch, (F, B + 3, J), dtype, g)
    bc = torch.randn((R, B), generator=g, device="cuda", dtype=dtype)
    bs = torch.randn((R, B), generator=g, device="cuda", dtype=dtype)
    rr = torch.randn((F, R, J), generator=g, device="cuda", dtype=dtype)
    ri = torch.randn((F, R, J), generator=g, device="cuda", dtype=dtype)
    w = torch.rand((B,), generator=g, device="cuda", dtype=dtype)

    def run(fn, acc):
        cur = acc[:, 2:2 + B]
        fn(cur[..., 0], cur[..., 1], bc, bs, rr, ri, w)
        return acc

    got = run(fold, acc0.clone())
    torch.cuda.synchronize()
    want = run(fold_plain, acc0.clone())
    max_abs = (got - want).abs().max().item()
    scale = (want - acc0).abs().max().item()
    name = str(dtype).replace("torch.", "")
    rel = max_abs / scale
    again = run(fold, acc0.clone())
    bit_identical = bool(torch.equal(again, got))
    untouched = bool(torch.equal(got[:, :2], acc0[:, :2])
                     and torch.equal(got[:, 2 + B:], acc0[:, 2 + B:]))
    res = {"shape": list(shape), "dtype": name, "max_abs_err": max_abs,
           "max_rel_err": rel, "tol_rel": KERNEL_REL_TOL[name],
           "bit_identical_rerun": bit_identical,
           "rows_outside_block_untouched": untouched}
    require(rel <= KERNEL_REL_TOL[name],
            f"fold {shape} {name}: relative error {rel:.3e} > "
            f"{KERNEL_REL_TOL[name]:.0e}")
    require(bit_identical, f"fold {shape} {name}: reruns differ")
    require(untouched, f"fold {shape} {name}: wrote outside its row block")
    if timed:
        flops = 8 * F * B * J * R + 4 * F * B * J
        nbytes = acc0.element_size() * (2 * 2 * F * B * J + 2 * R * B
                                        + 2 * F * R * J + B)
        iters = _iters(flops)
        acc = acc0.clone()
        res["ms"] = _cuda_ms(torch, lambda: run(fold, acc), iters)
        res["plain_ms"] = _cuda_ms(torch, lambda: run(fold_plain, acc), iters)
        accc = torch.view_as_complex(acc)
        Bmc = torch.complex(bc, -bs).transpose(0, 1)
        rowsc = torch.complex(rr, ri)
        wc = w.to(accc.dtype)[:, None]

        def lib():
            cur = accc[:, 2:2 + B]
            cur += wc * torch.matmul(Bmc, rowsc)

        res["library_ms"] = _cuda_ms(torch, lib, iters)
        res["library_call"] = f"torch.matmul on {accc.dtype} plus the weighted add"
        res["bound_ms"], res["bound_by"] = _bound(flops, nbytes)
        res["tflops"] = flops / res["ms"] / 1e9
    log(f"fold {tuple(shape)} {name}: " + ", ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in res.items() if k not in ("shape", "dtype")))
    return res


def check_cmatmul(torch, shape, dtype, seed=0, timed=False):
    """B3 against its plain version at one (B, K, N); with `timed`, also
    the kernel, plain and library times and the bound."""
    from swiftly_tpu_torch.ops.kernels import cmatmul, cmatmul_plain

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
        res["bound_ms"], res["bound_by"] = _bound(flops, nbytes)
        res["tflops"] = flops / res["ms"] / 1e9
    log(f"cmatmul {tuple(shape)} {name}: " + ", ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in res.items() if k not in ("shape", "dtype")))
    return res


# -- round trips ------------------------------------------------------------


def _stats():
    import swiftly_tpu_torch as st

    return {"cmatmul": st.cmatmul_stats, "colpass": st.colpass_stats,
            "fold": st.fold_stats}


def reset_counts():
    """Every kernel's launch count to 0."""
    for stats in _stats().values():
        stats.reset()


def read_counts():
    """{kernel: (launches, {shape: launches})}."""
    return {name: (stats.launches, dict(stats.shapes))
            for name, stats in _stats().items()}


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
    reset_counts()
    subgrids, facets, t_fwd, t_bwd = one_run()
    counts_run = read_counts()
    launches = counts_run["cmatmul"][0]
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
        "launches": {k: v[0] for k, v in counts_run.items()},
        "counts": counts_run,
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


class _TimedFeed:
    """The forward as ``feed_backward_passes`` sees it, with CUDA events
    recorded around each step of the forward's generator (no host
    synchronisation inside the timed window: the events mark where the
    device reached the step's first and last work), and copies of the
    `wanted` subgrids kept on the device as they pass."""

    def __init__(self, torch, forward, wanted):
        self.forward = forward
        self.wanted = set(wanted)
        self.samples = {}
        self.n_groups = 0
        self._torch = torch
        self._marks = []

    def _mark(self):
        ev = self._torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def forward_s(self):
        """Device seconds inside the forward's generator; call after the
        device is synchronised."""
        return sum(a.elapsed_time(b) for a, b in self._marks) / 1e3

    def stream_column_groups(self, subgrid_configs, spill=None):
        gen = self.forward.stream_column_groups(subgrid_configs, spill=spill)
        while True:
            before = self._mark()
            item = next(gen, None)
            self._marks.append((before, self._mark()))
            if item is None:
                return
            per_col, group = item
            self.n_groups += 1
            for c, col in enumerate(per_col):
                for s, (i, _) in enumerate(col):
                    if i in self.wanted:
                        self.samples[i] = group[c, s].clone()
            yield per_col, group


def roundtrip_streamed_small(torch, device="cuda"):
    """Float64 streamed round trip at SMALL_CONFIG against the oracle."""
    import swiftly_tpu_torch as st

    cfg = st.SwiftlyConfig(backend="planar", dtype=torch.float64,
                           device=device, **st.SWIFT_CONFIGS[SMALL_CONFIG])
    fcs = st.make_full_facet_cover(cfg)
    sgcs = st.make_full_subgrid_cover(cfg)
    tasks = [(fc, st.make_facet(cfg.image_size, fc, SMALL_SOURCES)) for fc in fcs]
    reset_counts()
    fwd = st.StreamedForward(cfg, tasks, residency="device")
    bwd = st.StreamedBackward(cfg, fcs, residency="sampled")
    st.feed_backward_passes(fwd, sgcs, [bwd])
    facets = bwd.finish_device()
    counts = {k: v[0] for k, v in read_counts().items()}
    out = {"launches": counts, "col_group": fwd.last_plan["col_group"],
           "colpass": fwd.last_plan["colpass"]}
    out["facet_rms"] = max(
        st.check_facet(cfg.image_size, fc, cfg.core.as_complex(facets[i]),
                       SMALL_SOURCES) for i, fc in enumerate(fcs))
    log(f"{SMALL_CONFIG} f64 streamed round trip: {out}")
    require(out["facet_rms"] < F64_ROUNDTRIP_RMS,
            f"{SMALL_CONFIG} streamed facet RMS {out['facet_rms']:.3e} >= "
            f"{F64_ROUNDTRIP_RMS}")
    if device == "cuda":
        require(all(counts[k] > 0 for k in ("colpass", "fold")),
                f"the 1k streamed round trip did not launch B1 and B2: {counts}")
    return out


def streamed_main(torch, config_name=MAIN_CONFIG, device="cuda", dtype=None,
                  warm=True, fold_group=4):
    """The main path of the streamed slice: StreamedForward (facets
    resident) fed into a sampled StreamedBackward by feed_backward_passes,
    planar, from real facet planes on the host."""
    import swiftly_tpu_torch as st
    from swiftly_tpu_torch.utils.flops import (
        bwd_column_pass_flops, bwd_fold_flops, column_pass_flops,
        sampled_facet_pass_flops)

    dtype = torch.float32 if dtype is None else dtype
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    cfg = st.SwiftlyConfig(backend="planar", dtype=dtype, device=device,
                           **st.SWIFT_CONFIGS[config_name])
    core = cfg.core
    N = cfg.image_size
    sources = sources_for(N)
    fcs = st.make_full_facet_cover(cfg)
    sgcs = st.make_full_subgrid_cover(cfg)
    F, yB, m = len(fcs), fcs[0].size, core.xM_yN_size
    t0 = time.perf_counter()
    facets_in = [st.make_real_facet(N, fc, sources, dtype=np_dtype)
                 for fc in fcs]  # real planes on the host
    setup_s = time.perf_counter() - t0
    n = len(sgcs)
    stride = max(1, n // MIN_SUBGRID_SAMPLES)
    idxs = list(range(0, n, stride))
    log(f"{config_name} streamed: {F} real facets of {yB} made on the host "
        f"in {setup_s:.1f} s; {n} subgrids, {len(idxs)} sampled")

    # what the backward keeps beside the forward's groups: its accumulator
    # and a fold group's rows (the forward's column-group sizer leaves it)
    item = torch.empty((), dtype=dtype).element_size()
    acc_bytes = F * yB * yB * 2 * item
    row_bytes = F * m * yB * 2 * item

    def round_trip():
        """One round trip through the public entry points, in a window
        synchronised at both ends (and nowhere inside): the facets on the
        device, the feed, and the window's host seconds."""
        fwd = st.StreamedForward(cfg, list(zip(fcs, facets_in)),
                                 residency="device")
        fwd.hbm_headroom = acc_bytes + (2 * fold_group + 2) * row_bytes
        bwd = st.StreamedBackward(cfg, fcs, residency="sampled",
                                  fold_group=fold_group)
        feed = _TimedFeed(torch, fwd, idxs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st.feed_backward_passes(feed, sgcs, [bwd])
        facets = bwd.finish_device()
        torch.cuda.synchronize()
        feed.plan = fwd.last_plan
        return facets, feed, time.perf_counter() - t0

    def one_run():
        facets, feed, total = round_trip()
        t_fwd = feed.forward_s()
        digests = []
        for i in range(F):  # one facet on the host at a time
            digests.append(hashlib.sha256(
                facets[i].cpu().numpy().tobytes()).hexdigest())
        return (facets, feed.samples, t_fwd, total - t_fwd, feed.plan,
                feed.n_groups, digests)

    warm_digests = None
    if warm:
        out_w = one_run()
        warm_digests = out_w[-1]
        del out_w
        log(f"{config_name} streamed: warm run done")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    facets, samples, t_fwd, t_bwd, plan, n_groups, digests = one_run()
    counts = read_counts()
    S = n // len({sg.off0 for sg in sgcs})
    n_cols = n // S
    xA = sgcs[0].size
    fwd_flops = (sampled_facet_pass_flops(core, F, yB, n_cols * m, True)
                 + n_cols * column_pass_flops(core, F, S, xA, plan["colpass"]))
    bwd_flops = (n_cols * bwd_column_pass_flops(core, F, S, yB, xA,
                                                plan["colpass"])
                 + bwd_fold_flops(core, F, yB, n_cols * m))
    out = {
        "config": config_name, "dtype": str(dtype).replace("torch.", ""),
        "forward_s": t_fwd, "backward_s": t_bwd, "roundtrip_s": t_fwd + t_bwd,
        "col_group": plan["col_group"], "n_groups": n_groups,
        "fold_group": fold_group, "colpass": plan["colpass"],
        "forward_tflop": fwd_flops / 1e12, "backward_tflop": bwd_flops / 1e12,
        "forward_tflops_per_s": fwd_flops / t_fwd / 1e12,
        "backward_tflops_per_s": bwd_flops / t_bwd / 1e12,
        "launches": {k: v[0] for k, v in counts.items()},
        "counts": counts,
        "facet_setup_s": setup_s,
    }
    if device == "cuda":
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"{config_name} streamed timed run: forward {t_fwd:.3f} s, backward "
        f"{t_bwd:.3f} s, G {plan['col_group']} ({n_groups} groups), "
        f"launches {out['launches']}")

    # Accuracy: sampled subgrids and every facet against the oracle.
    scale = sum(abs(s[0]) for s in sources) / N**2
    require(sorted(samples) == idxs, "sampled subgrids missing from the feed")
    sg_rms = [st.check_subgrid(N, sgcs[i], core.as_complex(samples[i]),
                               sources) for i in idxs]
    del samples
    f_rms = []
    for i, fc in enumerate(fcs):  # the oracle is the input real plane
        ref = torch.as_tensor(facets_in[i], device=facets.device,
                              dtype=torch.float64)
        d2 = ((facets[i][..., 0].double() - ref) ** 2
              + facets[i][..., 1].double() ** 2)
        f_rms.append(float(d2.mean().sqrt().item()))
        del ref, d2
    out.update(n_subgrid_samples=len(idxs), max_subgrid_rms=max(sg_rms),
               subgrid_rms_bound=SUBGRID_REL_RMS * scale,
               max_facet_rms=max(f_rms), facet_rms_bound=FACET_RMS,
               bit_identical_to_warm_run=(None if warm_digests is None
                                          else digests == warm_digests))
    log(f"{config_name} streamed accuracy: max subgrid RMS {max(sg_rms):.3e} "
        f"over {len(idxs)} samples (bound {SUBGRID_REL_RMS * scale:.3e}), "
        f"max facet RMS {max(f_rms):.3e} over {F} facets (bound "
        f"{FACET_RMS:.0e}), facets bit-identical to the warm run: "
        f"{out['bit_identical_to_warm_run']}")
    require(all(np.isfinite(sg_rms)) and all(np.isfinite(f_rms)),
            "non-finite RMS")
    require(max(sg_rms) <= SUBGRID_REL_RMS * scale,
            "streamed subgrid RMS over bound")
    require(max(f_rms) <= FACET_RMS, "streamed facet RMS over bound")
    require(warm_digests is None or digests == warm_digests,
            "the warm and timed runs' facets differ")
    if device == "cuda":
        missing = [k for k, v in out["launches"].items() if v == 0]
        require(not missing, f"the streamed main path launched {missing} "
                             "no time")
        fwd_b1 = sum(v for key, v in counts["colpass"][1].items() if key[-1])
        bwd_b1 = sum(v for key, v in counts["colpass"][1].items()
                     if not key[-1])
        require(fwd_b1 > 0 and bwd_b1 > 0,
                f"B1 ran {fwd_b1} forward and {bwd_b1} backward launches")
    if device == "cuda":
        out.update(streamed_stages(torch, cfg, fcs, facets_in))
        out.update(profile_streamed(torch, round_trip))
    return out


def streamed_stages(torch, cfg, fcs, facets_in):
    """Device times of the streamed forward's two stages that are no
    kernel of the port: the facet upload (host clock, synchronised) and
    the sampled facet pass over the whole cover's rows (CUDA events, plain
    ``torch.matmul`` products)."""
    import swiftly_tpu_torch as st
    from swiftly_tpu_torch.parallel import streamed as sm

    fwd = st.StreamedForward(cfg, list(zip(fcs, facets_in)), residency="device")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd._upload_resident_facets()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    core = cfg.core
    yB = fcs[0].size
    offs0 = sorted({sg.off0 for sg in st.make_full_subgrid_cover(cfg)})
    krows = torch.as_tensor(sm.sampled_row_indices(core, offs0), device="cuda")
    e0 = torch.as_tensor(np.asarray([fc.off0 - yB // 2 for fc in fcs]),
                         device="cuda")
    sampled_ms = _cuda_ms(torch, lambda: sm._facet_pass_sampled(
        core, fwd._dev_facets, e0, krows, real_facets=True), 1)
    out = {"facet_upload_s": upload_s, "sampled_pass_s": sampled_ms / 1e3,
           "sampled_pass_rows": int(krows.shape[0])}
    log(f"streamed stages: facet upload {upload_s:.3f} s, sampled facet pass "
        f"over {krows.shape[0]} rows {sampled_ms / 1e3:.3f} s")
    return out


def _busy_seconds(intervals):
    """Length of the union of (start, end) intervals, in seconds (the
    profiler's microseconds in)."""
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e6


def profile_streamed(torch, round_trip, rows=15):
    """One more streamed round trip under torch.profiler: the device time
    by kernel (the top `rows`), and the device's busy time (the union of
    its kernels' and copies' intervals) against the round trip's own
    window (host clock, synchronised at both ends; no digest or other
    host copy inside it). The profiler adds host work per launch, so the
    idle share under it is an upper bound of the unprofiled run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, feed, window_s = round_trip()
    fwd_s = feed.forward_s()
    del feed
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_s = _busy_seconds(
        [(e.time_range.start, e.time_range.end) for e in device])
    out = {"profiled_window_s": window_s, "profiled_forward_s": fwd_s,
           "profiled_device_busy_s": busy_s,
           "profiled_idle_share": (1.0 - busy_s / window_s
                                   if busy_s > 0 else None)}
    log("profiled streamed round trip: " + json.dumps(out))
    if busy_s == 0:
        log("the profiler recorded no device time")
        return out
    log(prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=rows, max_name_column_width=60))
    return out


# -- main -------------------------------------------------------------------


def _by_frequency(shapes):
    """[(shape, launches)] from a {shape: launches} counter, most frequent
    first (ties: most work first)."""
    return sorted(shapes.items(),
                  key=lambda kv: (kv[1], np.prod(kv[0], dtype=float)),
                  reverse=True)


def time_path(torch, check, path_shapes, f64_first=2):
    """Check and time one kernel at every shape one 32k path gave it: f32
    against the plain version (timed), f64 at the first `f64_first`.
    Returns (timed records, each with its shape's launches, seconds of
    this kernel per round trip)."""
    timed = []
    for i, (shape, n) in enumerate(path_shapes):
        rec = check(torch, tuple(shape), torch.float32, seed=i + 1, timed=True)
        rec["launches"] = n
        timed.append(rec)
    for i, (shape, _) in enumerate(path_shapes[:f64_first]):
        check(torch, tuple(shape), torch.float64, seed=i + 1)
    return timed, sum(r["launches"] * r["ms"] for r in timed) / 1e3


def _kernel_record(name, paths, main_path="streamed"):
    """One entry of the `kernels` line. `paths` maps each 32k path that
    launched the kernel to (launches, timed records at its shapes). The
    contract's keys are the main path's: its launches, and the times at
    its most frequent shape; ``paths`` keeps every path's launches beside
    the times at that path's own shapes."""
    source, replaces = KERNEL_SOURCES[name]
    launches, timed = paths[main_path]
    top = timed[0]
    keys = ("shape", "launches", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err", "tflops")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(t["max_abs_err"] for _, ts in paths.values()
                           for t in ts),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"], "shape": top["shape"],
        "check": "pass", "main_path": main_path,
        "paths": {p: {"launches": n, "shapes": [{k: r[k] for k in keys}
                                                for r in ts]}
                  for p, (n, ts) in paths.items()},
    }


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    import swiftly_tpu_torch  # noqa: F401  (fails outside the repo)

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(smi)

    def done(phase):
        # ru_maxrss: the host's peak resident memory so far, in KiB
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        log(f"[{phase} done at {time.perf_counter() - t_start:.1f} s, host "
            f"peak memory {peak:.1f} GiB]")

    build_kernels()
    done("build")
    for dt in (torch.float32, torch.float64):
        check_cmatmul(torch, (300, 228, 228), dt)
        for i, shape in enumerate(B1_RAGGED):
            check_colpass(torch, shape, dt, seed=i)
        for i, shape in enumerate(B2_RAGGED):
            check_fold(torch, shape, dt, seed=i)
    done("kernels")
    roundtrip_small(torch)
    roundtrip_streamed_small(torch)
    done("small")
    fused = roundtrip_main(torch)
    done("fused")
    streamed = streamed_main(torch)
    done("streamed")

    # Each kernel at every shape each 32k path gave it.
    checks = {"cmatmul": check_cmatmul, "colpass": check_colpass,
              "fold": check_fold}
    paths = {k: {} for k in checks}
    for path, counts in (("fused", fused["counts"]),
                         ("streamed", streamed["counts"])):
        for kname, (launches, shapes) in counts.items():
            if launches == 0:
                continue
            timed, secs = time_path(torch, checks[kname],
                                    _by_frequency(shapes))
            paths[kname][path] = (launches, timed)
            result = fused if path == "fused" else streamed
            result[f"{kname}_seconds_per_roundtrip"] = secs
            log(f"{kname} device time per {path} round trip: {secs:.3f} s "
                f"of {result['roundtrip_s']:.3f} s")
    done("timing")
    kernels = {"kernels": [_kernel_record(k, paths[k]) for k in checks]}
    log(json.dumps({"roundtrip": {k: fused[k] for k in (
        "config", "forward_s", "backward_s", "peak_memory_gib",
        "forward_tflops_per_s", "backward_tflops_per_s", "launches",
        "cmatmul_seconds_per_roundtrip", "max_subgrid_rms",
        "max_facet_rms")}}))
    log(json.dumps({"streamed_roundtrip": {k: streamed[k] for k in (
        "config", "forward_s", "backward_s", "col_group", "n_groups",
        "fold_group", "peak_memory_gib", "forward_tflops_per_s",
        "backward_tflops_per_s", "launches", "cmatmul_seconds_per_roundtrip",
        "colpass_seconds_per_roundtrip", "fold_seconds_per_roundtrip",
        "facet_upload_s", "sampled_pass_s", "profiled_window_s",
        "profiled_forward_s", "profiled_device_busy_s",
        "profiled_idle_share", "max_subgrid_rms", "max_facet_rms",
        "bit_identical_to_warm_run")}}))
    log(f"[total {time.perf_counter() - t_start:.1f} s]")
    log(smi)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
