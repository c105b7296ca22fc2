#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``swiftly_tpu_torch``) on the card through the entry
points a user calls, builds its hand-written kernels from the sources in
this checkout, and holds each kernel against its plain PyTorch version:

1. device: the card's name and power limit;
2. build: the CUDA sources of kernels B3, B1, B2 and B4 with its adjoint
   (``swiftly_tpu_torch/csrc``), one nvcc each, started together, with
   ptxas's registers/shared memory/spills, and the tile and dynamic shared
   memory of B1's and B2's engine;
3. kernel B3 (planar complex matmul) against its plain version at
   ragged shapes that take each of its tile variants, in float32 and
   float64, every variant bit-identical to the chosen one, and its f32
   output digests at one path-like shape per variant against the
   recorded ones; kernels B1 (column pass, both forms) and B2 (sampled
   fold) likewise at ragged shapes, in layouts that take every copy path
   of their tile engine (``B1_RAGGED``, ``B2_RAGGED``), and their f32
   output digests at path-like shapes and layouts (``B1_DIGESTS``,
   ``B2_DIGESTS``); kernel B4
   (visibility degrid) and its adjoint ``grid`` likewise at ragged shapes
   (B no power of two, rows no multiple of anything, taps at the rows'
   edges, many samples on one pixel for ``grid``, and first taps that
   wrap across the plane's ends), with B4's lanes bit-identical between
   B = 2 and B = 4096, ``grid`` bit-equal to its plain version, two
   ``grid`` runs bit-identical and ``grid`` writing nothing outside the
   patches; B4 over a serving pump (``degrid_rows``) at ragged (B, W, G,
   H) (``VIS_PUMP_RAGGED``: one row to 64, device, complex and
   host-staged rows, wrapping first taps) against its plain version,
   with the weights it computes on the card equal to the host's, its
   samples equal to ``degrid`` fed the host's weights, and bits that do
   not change with the rows' order, the samples' order and slots, B or G;
   and B4's f32 output digests (``B4_DIGESTS``), met by ``degrid`` and by
   ``degrid_rows``;
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
   against its own synchronised window; then the slab paths at 32k: the
   forward with ``facet_group`` forced to 1 and 3, from dense real planes
   on the host (the pinned staging ring) and from sparse facets
   synthesised on the card, against the resident forward and the oracle,
   reruns bit-identical, each beside the slab sizer's modelled bytes and
   its measured peak; one forward fed into the whole backward and two
   row slabs split at a height that is no multiple of the fold's row
   block, the slabs concatenated equal to the whole; and
   ``synth_facet_device`` equal to the densified upload;
7. every kernel against its plain version and one PyTorch library call,
   timed at every shape each path gave it (B3 at the fused path's
   shapes, the streamed path's and the visibility path's; B1, B2 and B3
   also at the 128k path's (phase 9); ``grid``, whose
   batch size varies per dispatch, at its four most frequent and its four
   largest, beside its device time over all its launches traced in
   phase 8; B4 likewise at the pumps' four most frequent and four largest
   (B, W, G, H); B3 also in each of its tile variants): with CUDA
   events around a run of calls, and for B3, B4 and ``grid``, whose
   launches at the visibility shapes take less device time than their
   wrappers take on the host, with the run queued behind a device-side
   spin so that the events time the device alone (``call_ms`` beside it
   is the plain CUDA-event time per call, the host's call rate); it runs
   last, after phases 8 and 9, whose shapes it times too;
8. visibility serving and gridding at ``32k[1]-n16k-512``, planar f32
   (the main path of the visibility slice): a ``SwiftlyForward`` over
   facets of the grid-corrected, band-limited sky model, a cache feed
   (``SpillCache`` / ``CachedColumnFeed``) seeded with the hottest
   column's rows, 2^20 zipf-over-columns samples with a 10% uniform tail
   cut into 16 batches, of which the first 3 (``--serve-full``: all 16)
   are served through ``VisibilityService`` (pumped dry after every
   second, the feed force-evicted after the second), every served
   sample gridded by a version-pinned ``VisGridder`` and ingested by a
   sampled ``StreamedBackward``; gated on the oracle, the shed reasons,
   the cache ladder, the adjoint identity, bit-identity to a fresh
   forward's rows at another bucket (``degrid_batch`` fed the host's
   weights) and of a second gridding, the facet-update version gates, and
   B4 launched once per pump that served a sample; then the traffic's
   first batch (65,536 samples, from a freshly seeded feed) served again
   under torch.profiler for the device's idle share and B4's device
   time;
9. the 128k streamed round trip at ``128k[1]-n32k-512``, planar f32, the
   full cover of 293 x 293 = 85,849 subgrids: facets made by
   ``make_sparse_facet`` (9 of 45056^2, 73 GB as dense real planes, never
   resident), ``StreamedForward(residency="device")`` choosing slabs of
   one facet synthesised on the card, fed by ``feed_backward_passes`` into
   a ``StreamedBackward(residency="sampled", fold_group=4)`` over one
   2048-row slab that holds a source pixel, then ``finish_device``; one
   run synchronised at both ends, gated on the oracle RMS of >= 2% of the
   subgrids from every column and on the slab's rows of all 9 facets
   against ``synth_facet_device``, the forward under an ``obs.Heartbeat``
   (progress and ETA every 30 s, gated on counting every subgrid); its
   plan, seconds, peak memory beside the slab sizer's model, and
   launches; then its first column group again under torch.profiler for
   the device's busy share and the time by stage;
10. the host and device residencies at ``32k[1]-n16k-512``, planar f32,
   from real facet planes on the host (run after the slab checks): (a)
   ``StreamedForward(residency="host", col_block=512)`` (the FFT facet
   pass into the pinned host row buffer, two deep) ->
   ``stream_columns(..., device_arrays=True)`` ->
   ``StreamedBackward(residency="device").add_subgrid_stack`` per column
   -> ``finish()`` (the backward FFT facet pass), a warm and a timed run,
   gated on the oracle RMS of >= 100 subgrids from every part of the
   cover and of every facet, and on the two runs' facets being
   bit-identical; the facet pass's seconds and bytes, the column uploads,
   the column passes' and ``finish``'s seconds, peak device memory, peak
   host memory (``getrusage``) and the B1 and B3 launches; (b) a resident
   forward feeding ``StreamedBackward(residency="host")`` once, its facets
   within 1e-6 (RMS over the largest value) of (a)'s and (a)'s host-forward
   subgrids within 1e-5 (relative) of its resident forward's; (c) on the
   first column group (``fold_group`` = 4 columns, full width)
   ``SWIFTLY_COLPASS=fft``, ``SWIFTLY_COLPASS_BWD=fft``,
   ``SWIFTLY_FOLD=fft`` and ``SWIFTLY_FOLD=ct`` against the default
   bodies, each within 1e-5 (relative), with its seconds;
11. the partitioned sampled round trip at ``32k[1]-n16k-512`` as the JAX
   package's ``roundtrip-streamed`` composes it, planar f32, from real
   facet planes on the host (run after phase 10): the plan from
   ``plan.compile_plan(..., n_facet_env=3, n_row_env=3, feed_env=3)``
   (3 facet passes x 3 row slabs of 3755 rows, no multiple of the fold's
   row block; 3 passes a feed) on the card's budget
   (``plan.hbm_budget_bytes``), gated equal to what
   ``plan.plan_backward_passes`` and ``plan.plan_backward_feed`` give by
   hand with the margins the port derives (``plan.plan_margins``); per
   feed chunk ``StreamedBackward(residency=
   "sampled", fold_group=4, row_slab=...)`` over its facets, fed by
   ``feed_backward_passes(..., spill=..., feed_index=k)`` from one
   ``StreamedForward(residency="device")`` whose ``hbm_headroom`` is the
   feed group's accumulators plus the reserve, then ``finish_device``:
   (a) cache-fed from a fresh ``SpillCache()`` (default budget), a warm
   and a timed run, the warm run's recording then feeding the
   whole-facet backward (the unpartitioned reference); (b) replay-fed
   (``spill=None``); (c) a cache about 1 GB under the stream with a
   temporary disk tier, removed at the end. Gated on (a)'s two runs, (b)
   and (c) giving the same bits part for part, the parts within 1e-6
   (RMS over the largest value) of the unpartitioned reference, the
   oracle facet RMS, 74 B1 forward launches in (a) and (c) and 3 x 74 in
   (b), (a) recording once and replaying (n_feeds - 1) x n_groups
   whole groups with no fallback, and (c) writing and reading its disk
   tier; then (a)'s second feed once more from its recording with one
   transient ``spill.read`` fault injected (``resilience.FaultPlan``),
   gated on one retry (the ``retry.*`` counters, metrics on) and the same
   bits; it prints each feed's seconds, the bytes and seconds recorded
   and replayed, and the peaks;
12. telemetry, and a kill and resume of the streamed round trip at
   ``32k[1]-n16k-512``, planar f32 (run after phase 6):
   ``StreamedForward(residency="device", col_group=10)`` into
   ``StreamedBackward(residency="sampled", fold_group=4)``, once
   unobserved (the new grouping's warm-up, its wall printed), then (a)
   with ``obs.metrics``, ``obs.trace`` and ``obs.recorder`` on, gated on
   phase 6's facet SHA-256, a wall within 5% of phase 6's timed run, the
   stage vocabulary with FLOPs and the export's MFU against
   ``utils.peak_tflops``, a Chrome trace whose spans nest, and the HBM
   gauge equal to ``torch.cuda.max_memory_allocated``; (b) with
   ``SWIFTLY_CKPT_KEEP=1``, an autosave after group 3 (30 columns, 2 of
   them pending a fold) and a ``FaultPlan`` killing the 4th ``bwd.feed``
   (``WorkerKilled``), then a fresh forward and backward restored from the
   snapshot feeding the 44 columns left, gated on phase 6's facet SHA-256,
   2 pending columns in the snapshot, the recorder's post-mortem naming
   the kill, 44 B1 forward launches, and the device memory back to its
   start after the kill; it prints the snapshot's GB, its save and
   restore seconds, the peak across the kill and the resume and the
   launches, and deletes the snapshot;
13. the plan compiler and its calibration loop at ``32k[1]-n16k-512``,
   planar f32, on phase 6's path (run after phase 12): (a)
   ``plan.compile_plan(PlanInputs.from_cover(..., hbm_budget=
   plan.hbm_budget_bytes(...), real_facets=True))`` with the card's
   default coefficients, gated on ``coeffs_source == "default"``, the
   seed fold group (4) and the planned forward mode and column group
   equal to what ``StreamedForward(residency="device")`` executes; (b)
   two round trips to that plan with metrics and trace on, each closed
   by ``stamp_measured_wall``, ``run_manifest``, ``plan_accuracy_block``
   and ``append_history`` into a calibration history in a temporary
   file (``SWIFTLY_CALIBRATION_HISTORY``), gated on phase 6's facet
   SHA-256, ``validate_artifact``, ``validate_plan_accuracy_artifact``
   and no timed stage outside the ledger's tables; (c)
   ``refit_from_ledger`` on that history (gated on ``ledger_readiness``
   and ``source == "ledger"``), the plan recompiled, and a third observed
   run to it, held to phase 6's SHA-256 where it keeps phase 6's
   parameters, else to the oracle's facet RMS, with the whole leg's
   predicted / measured wall within 0.8-1.25 and no stage mispriced
   beyond x2 (``record_mispricing``); (d) ``report.summarize_trace`` of
   (c)'s trace from the leg's span, its self times within 5% of the leg
   wall, ``validate_trace_artifact``; (e) the 128k round trip's plan
   with the default and the ledger coefficients, printed, not run; and
   the card's copy rates (pinned host to device and back, and a host
   memcpy), the sources of the model's byte defaults;
14. incremental facet updates and the serving fleet at
   ``32k[1]-n16k-512``, planar f32 (run after phase 13), from
   ``make_sparse_facet`` facets of phase 8's grid-corrected sky model:
   (a) ``IncrementalForward(cfg, tasks, SpillCache(), col_group=10)`` and
   ``record`` (74 x 74 subgrids, 8.79 GB of host RAM in 8 entries),
   timed; (b) ``update(new, use_plan=False)`` scaling K = 1 facet, then K
   = 3, each gated on ``mode == "patch"``, the ledger's version equal to
   the cache's, and max |patched - fresh| <= 1e-4 of max |fresh| over
   every entry against an independent ``stream_column_groups(...,
   spill=fresh)`` of the new stack; its seconds split into the delta
   pass's device work (B1 and its facet pass), d2h and route, and the
   patch, beside the full re-record's and ``plan_delta``'s prediction;
   then ``update(..., exact=True)`` back to the K = 1 stack, its stream's
   SHA-256 equal to the fresh K = 1 stream's, and a ``delta`` record
   (``run_manifest``) gated on ``validate_delta_artifact``; (c) the
   patched recording fed through ``feed_backward_passes(..., spill=
   engine.spill)`` into ``StreamedBackward(residency="sampled",
   fold_group=4)`` and ``finish_device``, within 1e-6 (RMS over the
   largest value) of the same backward fed from the fresh stream, its
   facets within phase 6's facet RMS of ``synth_facet_device``, B2
   launched; (d) ``ServeFleet`` of 2 ``SubgridService`` replicas (each
   over its own ``SwiftlyForward``, ``lru_forward=2``,
   ``CoalescingScheduler(max_batch=8)``, its facets prepared first)
   over ``engine.fabric()``, 4096 zipf-over-columns requests of
   priorities 0 and 1 from 4 closed-loop client threads: a quarter
   before ``fleet.post_facet_update(engine, ...)`` (K = 1, back to the
   first stack), the next 1536 paced while it runs, then
   ``kill_replica(0)`` with work in flight, ``restore_replica(0)`` and
   the rest paced past the victim's breaker reopen delay; gated on zero
   requests lost, every request admitted before the update returning
   the old stream's row and every one admitted after it the new
   stream's (bit-equal on the cache path, within 1e-5 relative L2 on
   the compute path; those admitted during it either), at least one
   compute fallback with B3 launches inside the patch window, the
   victim's breaker open -> half-open -> closed, one fabric roll and one
   stream copy, and a fleet record gated on ``validate_fleet_artifact``
   (each replica's ``serve`` block on ``validate_serve_artifact``); (e)
   phase 8's first batch of 65,536 samples served through
   ``VisibilityService(row_source=FleetRowSource(fleet))``, gated on
   the oracle (``DEGRID_TOLERANCE``) and B4 launched once per pump that
   served a sample. It prints the device peak after every step.

At phases 6, 10 (b), 11 (a) and 9 the streamed forward's sizer model
(``parallel.streamed.stream_peak_bytes`` beside the backwards'
``device_bytes``) is printed beside the measured device peak
(``torch.cuda.max_memory_allocated``) and gated to lie within 1.0 and
1.3 times it (``SIZER_BAND``).

The launch counters are set to 0 just before each 32k and 128k path runs
and read just after it. Every phase that fails ends the run with a non-zero exit
code. The last lines are the ``residency_32k`` JSON record of phase
10, the ``spill_32k`` record of phase 11, the ``resume_32k`` record of
phase 12, the ``plan_32k`` record of phase 13, the ``delta_32k`` record
of phase 14, the ``vis`` JSON record of phase 8, the
``kernels`` JSON record (per kernel, ``launches`` and the times beside it
are its main path's: the 32k streamed path's for B3, B1 and B2, the
visibility path's for B4 and ``grid``; ``paths`` holds each path's
launches, the 128k one's, phase 10's (``residency``, its part (a), and
``residency_bodies``, its part (c)), phase 11's (``spill``, its timed
run (a)), phase 12's (``resume``, its observed run (a)) and phase 13's
(``plan``, its calibrated run (c)) and phase 14's (``delta``, (a) to (c)
and the exact update; ``fleet``, (d) and (e)) too, with the times at that
path's shapes) and
``{"ok": true, "device": {...}}``. Needs one CUDA card; exits non-zero,
and prints no result, without one.

``python3 chip_smoke.py --quick`` runs phase 2, phase 3 for B1 and B2 (with
every digest), phase 6, and phase 7 for B1 and B2 at the streamed path's
shapes, and prints them as one ``quick`` JSON line instead of the result:
for a kernel change's first calls. ``--b4`` runs phase 2 and phase 3's B4
checks and digests; ``--b4-digests`` only B4's digests, through
``degrid``, which every checkout since the visibility slice has (with
``--root DIR``, the checkout in DIR). ``--serve-short`` serves phase 8's
first two batches once (131,072 samples, one pump-dry cycle) and prints
one ``serve_short`` JSON line; ``--big`` runs phase 2, phase 3's B1 and
B2 checks and digests, phase 9 and phase 7 at phase 9's shapes, and
prints one ``big`` JSON line; ``--serve-ab DIR --pairs N`` builds the
kernels of the checkout DIR and of this one, then runs ``--serve-short``
on each in turn, N times each in their own processes (parent, tree, tree,
parent, ...), and prints the medians and spreads. ``--residency`` runs
phase 2 and phase 10 alone and prints one ``residency_32k`` JSON line;
``--spill`` runs phase 2, phase 11 and phase 7 at phase 11's shapes and
prints one ``spill_32k`` JSON line; ``--resume`` runs phase 2, phase 6's
warm and timed round trips (unprofiled) and phase 12, and prints one
``resume_32k`` JSON line; ``--plan`` runs phase 2, phase 6's warm and
timed round trips (unprofiled) and phase 13, and prints one ``plan_32k``
JSON line; ``--delta`` runs phase 2 and phase 14 alone, and prints one
``delta_32k`` JSON line (with B1, B2 and B3 timed at the delta path's
shapes).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import resource
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent

MAIN_CONFIG = "32k[1]-n16k-512"
SMALL_CONFIG = "1k[1]-n512-256"
# Phase 9: the reference's scale target (swift_configs.py:30), 9 facets of
# 45056^2 (73 GB as real f32 planes: never resident on one card), and the
# height of the backward's output-row slab
BIG_CONFIG = "128k[1]-n32k-512"
BIG_SLAB_ROWS = 2048

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

# Ragged check shapes: no dimension a multiple of the kernels' tiles or
# 16-deep slices, each in a layout that takes the tile engine
# (csrc/cgemm.cuh) through one set of its copy paths. B1 layouts: "path",
# the planes as the 32k path gives them (interleaved; X a permuted gather,
# or broadcast over f with Fx = 1), copied one element a copy, the staged
# T in 16-byte runs where M allows; "planar", contiguous planes (16-byte
# runs of X and B where Q and N allow); "offset", planes one element off
# 16-byte alignment (every copy one element). B2 layouts: "path", a row
# block of an interleaved accumulator (written as 16-byte (re, im) pairs;
# phases and rows in 16-byte runs where B and J allow); "odd", odd J and
# an odd first row, phases and rows off alignment (every copy and store
# one element); "planar", contiguous accumulator planes (16-byte runs
# along j); "shifted", the block one (re, im) pair off 16-byte alignment.
B1_RAGGED = [  # ((S, F, Fx, M, P, Q, N, reduce_f), layout)
    ((5, 3, 3, 40, 24, 24, 40, True), "path"),
    # phase 9's forward shape: one facet a slab, S = 293 (prime) subgrids
    ((293, 1, 1, 512, 256, 256, 512, True), "path"),
    ((5, 3, 1, 70, 33, 50, 90, False), "path"),
    ((3, 2, 2, 130, 17, 70, 65, True), "path"),
    ((4, 3, 1, 132, 40, 33, 72, False), "path"),  # odd Q, interleaved
    ((3, 2, 2, 136, 20, 48, 200, True), "planar"),
    ((3, 2, 1, 70, 33, 41, 90, True), "offset"),
]
B2_RAGGED = [  # ((F, B, J, R), layout)
    ((3, 70, 100, 50), "path"),
    ((2, 132, 200, 33), "path"),
    ((3, 70, 101, 50), "odd"),
    ((2, 64, 96, 40), "planar"),
    ((2, 36, 64, 24), "shifted"),
]

# B3 at ragged shapes on which ops/kernels.py `_cmatmul_config` picks each
# tile variant in turn (variant 0, 1), then shapes too small to fill the
# card; every variant runs at each of them and gives the same bits
B3_RAGGED = [(40000, 100, 300), (4100, 70, 270), (130, 33, 1000),
             (2300, 33, 250), (300, 228, 228)]
# B3's f32 output digests: (B, K, N), the numpy seed of its inputs, and the
# SHA-256 of the output planes' bytes (real, then imaginary), read from the
# first, one-tile version of csrc/cmatmul.cu on an H100; one shape per tile
# variant and the visibility path's most frequent one, K as on the 32k
# paths. Every variant must give these bits.
B3_DIGESTS = [
    ((33152, 512, 512), 105,
     "159577a7dcaa82cbf93d23802402560ce1783cbdbaff6877636232daf110fa28"),
    ((4608, 256, 256), 102,
     "fcd6825273957ab9d8b2fd68aaba00574f2a104b744a6b06cee26d75319ae156"),
    ((448, 512, 512), 103,
     "e33ebfab3e3933d732afb5d19a1d8fe3f0416dc29f4e1a1094b915d21537a364"),
]

# B1's and B2's f32 output digests, read from their first kernels (the
# 64 x 64 tile engine of csrc/cgemm.cuh) on an H100, at one path-like shape per
# form with S or J cut so that hashing stays quick: inputs from a numpy
# seed, laid out as on the 32k path (interleaved planes; B1's forward X
# a permuted gather, the adjoint's X broadcast over f; B2's accumulator a
# row block of an interleaved tensor). SHA-256 of B1's output planes
# (real, then imaginary) and of B2's whole accumulator after the update.
B1_DIGESTS = [  # ((S, F, Fx, M, P, Q, N, reduce_f), seed, sha256)
    ((8, 9, 9, 512, 256, 256, 512, True), 201,
     "96d52b99c6ab155dc4c7d40adba854aa6b8b4750e63543ade8e56d40318b482d"),
    ((8, 9, 1, 256, 512, 512, 256, False), 202,
     "b22a9167fa70133117bc86bb8c17fe4ab39b8bdfb98f5bee6e7780f76faea437"),
]
B2_DIGESTS = [  # ((F, B, J, R), seed, sha256)
    ((9, 384, 1408, 1024), 203,
     "5cb9b2fabf7a2a3e7623babb6401f322330d0fa68a930926b4b35d80dd7de329"),
]

# B4's f32 output digests with the weights given (``degrid``, which runs
# the same reduction as a pump's launch): (B, W, H), the numpy seed of the
# inputs (a strided interleaved row, first taps inside it, the host's
# weights), and the SHA-256 of the output planes (real, then imaginary),
# read from the first B4 kernel (one launch a served subgrid, the host's
# weights) on an H100: a mean dispatch, a ragged row, and the 4096-sample
# cap. `degrid_rows` must give the same bits from the fractions.
B4_DIGESTS = [
    ((13, 8, 448), 301,
     "ce8c5abbba6728a597cf501bc846dde13562bce17167c7c1be9da8967ba9371a"),
    ((300, 8, 61), 302,
     "049375553f02e5c00bff1b98138fcf75833b28a6e3e2979d2e44042aa9a237e1"),
    ((4096, 8, 448), 303,
     "cff9db4104ef1d43e6778093d0680235757078e6a7cfd158f0bd4593b5ed81d3"),
]

# (B, W, H) of B4 and its adjoint: ragged batches and rows, B4 also at
# the 4096-sample cap for the lane bits
VIS_RAGGED = [(5, 8, 37), (300, 8, 61), (17, 4, 24), (4096, 8, 448)]
# (B, W, G, H) of B4 over a pump: G rows of mixed sizes up to H in every
# layout (device interleaved views, complex views, host rows staged
# through pinned memory), samples spread over them, first taps that wrap
# across the rows' ends; G = 1, the cap, and a pump's most rows (64)
VIS_PUMP_RAGGED = [(5, 8, 1, 37), (300, 8, 3, 61), (17, 4, 7, 24),
                   (4096, 8, 1, 448), (900, 8, 20, 448), (2000, 6, 64, 61)]
GRID_RAGGED = [(5, 8, 37), (300, 8, 61), (33, 6, 50), (1000, 8, 448),
               (3300, 8, 448)]
# grid with first taps drawn from [-2W, H + 2): patches wholly or partly
# wrapped from negative indices, across the 32-pixel tiles at both ends of
# the plane, and partly past its far edge
GRID_WRAPPED = [(300, 8, 61), (200, 4, 70), (200, 6, 70), (3300, 8, 448)]

# Phase 7's traffic (the reference benchmark's visibility leg,
# bench.py:1747, at the full 2^20 samples)
VIS_SAMPLES = 2**20
VIS_BATCHES = 16
# batches phase 8 serves by default (--serve-full: all VIS_BATCHES), to keep
# the whole script inside its time limit beside phases 9 and 12
VIS_SERVED = 3
VIS_SEED = 1234
VIS_ZIPF_S = 1.1
VIS_MAX_DEPTH = 65536
VIS_MAX_BATCH = 64
VIS_EVICT_AFTER = 2  # batches served from the feed before it is evicted
# whole batches in the profiled serving window, from the traffic's first
VIS_PROFILE_BATCHES = 1
# kernels whose batch varies per launch (grid, B4's pumps) are timed at
# their most frequent and at their largest shapes
VARIED_TIMED_SHAPES = 4

# the library (csrc/<name>.cu) each kernel is built from
KERNEL_LIBS = {"cmatmul": "cmatmul", "colpass": "colpass", "fold": "fold",
               "degrid": "degrid", "grid": "degrid"}
KERNEL_SOURCES = {
    "cmatmul": ("swiftly_tpu_torch/csrc/cmatmul.cu",
                "swiftly_tpu/ops/pallas_kernels.py:102"),
    "colpass": ("swiftly_tpu_torch/csrc/colpass.cu",
                "swiftly_tpu/ops/pallas_kernels.py:265"),
    "fold": ("swiftly_tpu_torch/csrc/fold.cu",
             "swiftly_tpu/ops/pallas_kernels.py:171"),
    "degrid": ("swiftly_tpu_torch/csrc/degrid.cu",
               "swiftly_tpu/vis/degrid.py:71"),
    # not a TPU kernel: the port of the scatter-add adjoint of B4
    "grid": ("swiftly_tpu_torch/csrc/degrid.cu",
             "swiftly_tpu/vis/grid.py:42"),
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
    """Build kernels B3, B1, B2 and B4 (with its adjoint) from their
    sources (one nvcc each, started together) and print ptxas's reports."""
    from swiftly_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all(sorted(set(KERNEL_LIBS.values())))
    log(f"built {', '.join(built)} in {time.perf_counter() - t0:.1f} s")
    for name, (path, report) in built.items():
        log(f"{name}: {path.relative_to(ROOT)}")
        for line in report.splitlines():
            if "ptxas" in line or "spill" in line:
                log(f"  {line.strip()}")
    import torch

    from swiftly_tpu_torch.ops import kernels

    for name in ("colpass", "fold"):  # dynamic shared memory: not in ptxas's
        for dt in (torch.float32, torch.float64):
            log(f"{name} engine tile, {dt}: {kernels.engine_tile(name, dt)}")


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


def _device_ms(torch, fn, iters, hold_cycles=200_000_000):
    """Mean device time of `fn` per call, for launches of a few
    microseconds: CUDA events around a run of calls would time the host's
    call rate instead. The device first spins for `hold_cycles` clock
    cycles (~0.1 s), so the host enqueues the events and all `iters` calls
    behind the spin and the device then runs them back to back. A call that
    synchronises the host (the plain scatter's rounds do) breaks the queue:
    its time then includes host work."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(hold_cycles)
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


def _colpass_inputs(torch, shape, dtype, g, layout):
    """B1's planes at one shape in one layout (B1_RAGGED), and the
    interleaved A, X, B of the "path" layout (else None)."""
    S, F, Fx, M, P, Q, N, _ = shape
    if layout == "path":
        A = _interleaved(torch, (F, M, P), dtype, g)
        if Fx == F:  # a gathered, permuted view, as the forward body passes it
            X = _interleaved(torch, (F, P, S, Q), dtype, g).permute(
                2, 0, 1, 3, 4)
        else:
            X = _interleaved(torch, (S, P, Q), dtype, g)[:, None]
        Bm = _interleaved(torch, (F, Q, N), dtype, g)
        return (A[..., 0], A[..., 1], X[..., 0], X[..., 1], Bm[..., 0],
                Bm[..., 1]), (A, X, Bm)
    skip = {"planar": 0, "offset": 1}[layout]
    planes = []
    for dims in ((F, M, P), (S, Fx, P, Q), (F, Q, N)):
        n = int(np.prod(dims))
        flat = torch.randn((2 * n + skip,), generator=g, device="cuda",
                           dtype=dtype)[skip:]
        planes += [flat[:n].view(dims), flat[n:].view(dims)]
    return tuple(planes), None


def check_colpass(torch, shape, dtype, seed=0, timed=False, layout="path"):
    """B1 against its plain version at one (S, F, Fx, M, P, Q, N,
    reduce_f), its planes in `layout` (B1_RAGGED; "path": strided views of
    interleaved tensors as on the main path); with `timed`, also the
    kernel, plain and library times and the bound."""
    from swiftly_tpu_torch.ops.kernels import colpass, colpass_plain

    S, F, Fx, M, P, Q, N, reduce_f = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    planes, interleaved = _colpass_inputs(torch, shape, dtype, g, layout)
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
    res = {"shape": list(shape), "dtype": name, "layout": layout,
           "max_abs_err": max_abs,
           "max_rel_err": rel, "tol_rel": KERNEL_REL_TOL[name],
           "bit_identical_rerun": bit_identical}
    require(rel <= KERNEL_REL_TOL[name],
            f"colpass {shape} {layout} {name}: relative error {rel:.3e} > "
            f"{KERNEL_REL_TOL[name]:.0e}")
    require(bit_identical, f"colpass {shape} {layout} {name}: reruns differ")
    if timed:
        A, X, Bm = interleaved
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


def _fold_inputs(torch, shape, dtype, g, layout):
    """B2's inputs at one (F, B, J, R) in one layout (B2_RAGGED): the
    accumulator tensor, a function giving the block's (acc_r, acc_i) views
    of it (or of a tensor like it), and (bc, bs, rr, ri, w)."""
    F, B, J, R = shape

    def randn(*dims):
        return torch.randn(dims, generator=g, device="cuda", dtype=dtype)

    if layout == "planar":
        acc0 = randn(2, F, B, J)
        block = lambda acc: (acc[0], acc[1])  # noqa: E731
    elif layout == "shifted":
        acc0 = randn(F, B + 3, J + 1, 2)
        block = lambda acc: (acc[:, 2:2 + B, 1:, 0],  # noqa: E731
                             acc[:, 2:2 + B, 1:, 1])
    else:
        start = 1 if layout == "odd" else 2
        acc0 = _interleaved(torch, (F, B + 3, J), dtype, g)
        block = lambda acc: (acc[:, start:start + B, :, 0],  # noqa: E731
                             acc[:, start:start + B, :, 1])
    if layout == "odd":
        bc, bs = randn(R, B + 1)[:, 1:], randn(R, B + 1)[:, 1:]
        rr, ri = (randn(F * R * J + 1)[1:].view(F, R, J) for _ in range(2))
    else:
        bc, bs = randn(R, B), randn(R, B)
        rr, ri = randn(F, R, J), randn(F, R, J)
    w = torch.rand((B,), generator=g, device="cuda", dtype=dtype)
    return acc0, block, (bc, bs, rr, ri, w)


def check_fold(torch, shape, dtype, seed=0, timed=False, layout="path"):
    """B2 against its plain version at one (F, B, J, R), updating the
    accumulator block of `layout` (B2_RAGGED; "path": a row block of an
    interleaved [F, B + 3, J, 2] accumulator, as the main path does) in
    place; with `timed`, also the times and the bound."""
    from swiftly_tpu_torch.ops.kernels import fold, fold_plain

    F, B, J, R = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    acc0, block, args = _fold_inputs(torch, shape, dtype, g, layout)
    bc, bs, rr, ri, w = args

    def run(fn, acc):
        fn(*block(acc), *args)
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
    outside = torch.ones_like(acc0, dtype=torch.bool)
    for view in block(outside):
        view.fill_(False)
    untouched = bool(torch.equal(got[outside], acc0[outside]))
    res = {"shape": list(shape), "dtype": name, "layout": layout,
           "max_abs_err": max_abs,
           "max_rel_err": rel, "tol_rel": KERNEL_REL_TOL[name],
           "bit_identical_rerun": bit_identical,
           "outside_block_untouched": untouched}
    require(rel <= KERNEL_REL_TOL[name],
            f"fold {shape} {layout} {name}: relative error {rel:.3e} > "
            f"{KERNEL_REL_TOL[name]:.0e}")
    require(bit_identical, f"fold {shape} {layout} {name}: reruns differ")
    require(untouched,
            f"fold {shape} {layout} {name}: wrote outside its block")
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
    from swiftly_tpu_torch.ops import kernels
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
    variants_equal = True
    for v in kernels._CMATMUL_TILES[dtype]:  # the same FMAs per output
        other = kernels._cmatmul_launch(zr, zi, wr, wi, v)
        variants_equal &= bool(torch.equal(other[0], outr)
                               and torch.equal(other[1], outi))
    res = {"shape": [B, K, N], "dtype": name,
           "variant": kernels._cmatmul_config(B, K, N, dtype,
                                              kernels._sm_count(0)),
           "max_abs_err": max_abs,
           "max_rel_err": rel, "tol_rel": KERNEL_REL_TOL[name],
           "bit_identical_rerun": bit_identical,
           "variants_bit_identical": variants_equal}
    require(rel <= KERNEL_REL_TOL[name],
            f"cmatmul {shape} {name}: relative error {rel:.3e} > "
            f"{KERNEL_REL_TOL[name]:.0e}")
    require(bit_identical, f"cmatmul {shape} {name}: reruns differ")
    require(variants_equal, f"cmatmul {shape} {name}: tile variants differ")
    if timed:
        # device times: at the visibility shapes a launch takes less device
        # time than the wrapper takes on the host (call_ms)
        iters = max(3, min(50, int(2e11 / (8 * B * K * N))))
        run = lambda: cmatmul(zr, zi, wr, wi)  # noqa: E731
        res["ms"] = _device_ms(torch, run, iters)
        res["call_ms"] = _cuda_ms(torch, run, iters)
        # every tile variant at this shape, beside the chooser's
        res["variant_ms"] = {
            v: _device_ms(torch, lambda: kernels._cmatmul_launch(
                zr, zi, wr, wi, v), iters)
            for v in kernels._CMATMUL_TILES[dtype]}
        res["plain_ms"] = _device_ms(
            torch, lambda: cmatmul_plain(zr, zi, wr, wi), iters)
        zc, wc = torch.complex(zr, zi), torch.complex(wr, wi)
        res["library_ms"] = _device_ms(
            torch, lambda: torch.matmul(zc, wc), iters)
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


def check_cmatmul_digest(torch, shape, seed, want):
    """B3's f32 output at one (B, K, N) from seeded numpy planes: its
    SHA-256 against the recorded one, for the kernel's chosen variant and
    for every other."""
    from swiftly_tpu_torch.ops import kernels

    B, K, N = shape
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((2, B, K)).astype(np.float32)
    w = rng.standard_normal((2, K, N)).astype(np.float32)
    planes = [torch.as_tensor(a, device="cuda") for a in (*z, *w)]

    def sha(outr, outi):
        h = hashlib.sha256(outr.cpu().numpy().tobytes())
        h.update(outi.cpu().numpy().tobytes())
        return h.hexdigest()

    got = sha(*kernels.cmatmul(*planes))
    others = {v: sha(*kernels._cmatmul_launch(*planes, v))
              for v in kernels._CMATMUL_TILES[torch.float32]}
    variant = kernels._cmatmul_config(B, K, N, torch.float32,
                                      kernels._sm_count(0))
    log(f"cmatmul digest {tuple(shape)} seed {seed} variant "
        f"{variant}: sha256 {got} "
        f"({'as recorded' if got == want else 'recorded ' + want})")
    require(got == want, f"cmatmul {shape}: output digest {got} is not the "
            f"recorded {want}")
    require(all(d == want for d in others.values()),
            f"cmatmul {shape}: a tile variant's digest differs: {others}")
    return got


def _sha(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def _report_digest(kernel, shape, seed, got, want):
    """Log a digest beside the recorded one; gate on it once recorded."""
    state = ("not recorded" if want is None
             else "as recorded" if got == want else "recorded " + want)
    log(f"{kernel} digest {tuple(shape)} seed {seed}: sha256 {got} ({state})")
    require(want is None or got == want,
            f"{kernel} {shape}: output digest {got} is not the recorded {want}")
    return got


def colpass_digest_inputs(torch, shape, seed):
    """B1's f32 planes at one (S, F, Fx, M, P, Q, N, reduce_f) from a numpy
    seed, as the 32k path lays them out: interleaved A [F, M, P, 2] and
    B [F, Q, N, 2]; X the forward's permuted gather of an [F, P, S, Q, 2]
    tensor, or the adjoint's [S, P, Q, 2] broadcast over f."""
    S, F, Fx, M, P, Q, N, _ = shape
    rng = np.random.default_rng(seed)

    def draw(*dims):
        return torch.as_tensor(
            rng.standard_normal(dims + (2,)).astype(np.float32), device="cuda")

    A = draw(F, M, P)
    if Fx == F:
        X = draw(F, P, S, Q).permute(2, 0, 1, 3, 4)
    else:
        X = draw(S, P, Q)[:, None]
    Bm = draw(F, Q, N)
    return (A[..., 0], A[..., 1], X[..., 0], X[..., 1], Bm[..., 0],
            Bm[..., 1])


def check_colpass_digest(torch, shape, seed, want):
    """B1's f32 output digest at one path-like shape."""
    from swiftly_tpu_torch.ops.kernels import colpass

    planes = colpass_digest_inputs(torch, shape, seed)
    got = _sha(*colpass(*planes, reduce_f=shape[-1]))
    return _report_digest("colpass", shape, seed, got, want)


def fold_digest_inputs(torch, shape, seed):
    """B2's f32 inputs at one (F, B, J, R) from a numpy seed: an interleaved
    [F, B + 5, J, 2] accumulator whose rows 3 .. 3 + B are the block, the
    phase planes [R, B], the row planes [F, R, J] and the weights [B]."""
    F, B, J, R = shape
    rng = np.random.default_rng(seed)

    def draw(*dims):
        return torch.as_tensor(rng.standard_normal(dims).astype(np.float32),
                               device="cuda")

    acc = draw(F, B + 5, J, 2)
    return acc, (draw(R, B), draw(R, B), draw(F, R, J), draw(F, R, J),
                 draw(B))


def check_fold_digest(torch, shape, seed, want):
    """B2's f32 digest (the whole accumulator after one update of its row
    block) at one path-like shape."""
    from swiftly_tpu_torch.ops.kernels import fold

    B = shape[1]
    acc, args = fold_digest_inputs(torch, shape, seed)
    cur = acc[:, 3:3 + B]
    fold(cur[..., 0], cur[..., 1], *args)
    return _report_digest("fold", shape, seed, _sha(acc), want)


def _vis_inputs(torch, shape, dtype, seed, one_pixel=False, wrap=False):
    """Inputs of B4 and its adjoint at (B, W, H): an interleaved tensor
    whose [H, H, 2] view (at an offset, so strided) is the row or the
    accumulator, int64 first-tap indices (the first two samples at opposite
    corners of the row), the kernel's tap weights and sample planes; the
    host indices too."""
    from swiftly_tpu_torch.vis import vis_kernel

    B, W, H = shape
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(seed)
    iu0 = rng.integers(0, H - W + 1, size=B)
    iv0 = rng.integers(0, H - W + 1, size=B)
    if one_pixel:
        iu0[:], iv0[:] = H // 3, H // 2
    iu0[:2], iv0[:2] = (0, H - W)[:B], (H - W, 0)[:B]
    if wrap:
        iu0 = rng.integers(-2 * W, H + 2, size=B)
        iv0 = rng.integers(-2 * W, H + 2, size=B)
    k = vis_kernel(support=W)
    cu = k.weights(rng.uniform(0, 1, size=B), dtype=np_dt)
    cv = k.weights(rng.uniform(0, 1, size=B), dtype=np_dt)
    y = rng.standard_normal((2, B)).astype(np_dt)
    big = torch.as_tensor(rng.standard_normal((H + 3, H + 2, 2)).astype(np_dt),
                          device="cuda")
    dev = [torch.as_tensor(a, device="cuda") for a in (iu0, iv0, cu, cv, y)]
    return big, (iu0, iv0), dev


def _touched(iu0, iv0, W, H):
    """Flat indices (into an [H, H] plane) of the distinct pixels the
    samples' patches cover, by JAX's scatter rules: a negative index counts
    once from the end, what then lies outside the plane is dropped."""
    offs = np.arange(W)
    u = iu0[:, None] + offs
    v = iv0[:, None] + offs
    u, v = np.where(u < 0, u + H, u), np.where(v < 0, v + H, v)
    u = np.broadcast_to(u[:, :, None], (len(iu0), W, W))
    v = np.broadcast_to(v[:, None, :], (len(iv0), W, W))
    keep = (u >= 0) & (u < H) & (v >= 0) & (v < H)
    return np.unique((u * H + v)[keep])


def check_degrid(torch, shape, dtype, seed=0):
    """B4 with the weights given (``degrid``) against its plain version at
    one (B, W, H), the row a strided view; its lanes against runs of two
    (B = 2) at the start, middle and end."""
    from swiftly_tpu_torch.ops.kernels import degrid, degrid_plain

    B, W, H = shape
    big, _, (iu0, iv0, cu, cv, _) = _vis_inputs(torch, shape, dtype, seed)
    row = big[1:1 + H, 2:2 + H]
    planes = (row[..., 0], row[..., 1])
    vr, vi = degrid(*planes, iu0, iv0, cu, cv)
    torch.cuda.synchronize()
    pr, pi = degrid_plain(*planes, iu0, iv0, cu, cv)
    max_abs = max((vr - pr).abs().max().item(), (vi - pi).abs().max().item())
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    name = str(dtype).replace("torch.", "")
    rel = max_abs / scale
    again = degrid(*planes, iu0, iv0, cu, cv)
    bit_identical = bool(torch.equal(again[0], vr) and torch.equal(again[1], vi))
    lanes_ok = True
    for k in sorted({0, max(0, B // 2 - 1), max(0, B - 2)}):
        sl = slice(k, k + 2)
        two = degrid(*planes, iu0[sl], iv0[sl], cu[sl], cv[sl])
        lanes_ok &= bool(torch.equal(two[0], vr[sl])
                         and torch.equal(two[1], vi[sl]))
    res = {"shape": list(shape), "dtype": name, "max_abs_err": max_abs,
           "max_rel_err": rel, "tol_rel": KERNEL_REL_TOL[name],
           "bit_identical_rerun": bit_identical,
           "lanes_bit_identical_at_B2": lanes_ok}
    require(rel <= KERNEL_REL_TOL[name],
            f"degrid {shape} {name}: relative error {rel:.3e} > "
            f"{KERNEL_REL_TOL[name]:.0e}")
    require(bit_identical, f"degrid {shape} {name}: reruns differ")
    require(lanes_ok, f"degrid {shape} {name}: a lane's bits depend on B")
    log(f"degrid {tuple(shape)} {name}: " + ", ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in res.items() if k not in ("shape", "dtype")))
    return res


def degrid_digest_inputs(torch, shape, seed):
    """B4's f32 inputs at one (B, W, H) from a numpy seed: the planes of a
    strided interleaved row, device first taps inside it, the host
    fractions and the host's weights for them on the card."""
    from swiftly_tpu_torch.vis import vis_kernel

    B, W, H = shape
    rng = np.random.default_rng(seed)
    big = torch.as_tensor(
        rng.standard_normal((H + 3, H + 2, 2)).astype(np.float32),
        device="cuda")
    row = big[1:1 + H, 2:2 + H]
    iu0, iv0 = rng.integers(0, H - W + 1, size=(2, B))
    fu, fv = rng.uniform(0, 1, size=(2, B))
    k = vis_kernel(support=W)
    cu, cv = (torch.as_tensor(k.weights(f, dtype=np.float64).astype(
        np.float32), device="cuda") for f in (fu, fv))
    idx = [torch.as_tensor(a, device="cuda") for a in (iu0, iv0)]
    return (row[..., 0], row[..., 1]), (iu0, iv0, fu, fv), idx, (cu, cv)


def degrid_digest(torch, shape, seed):
    """SHA-256 of ``degrid``'s f32 output at one (B, W, H), the weights
    given: the kernel of any checkout that has ``ops.kernels.degrid``."""
    from swiftly_tpu_torch.ops.kernels import degrid

    planes, _, idx, (cu, cv) = degrid_digest_inputs(torch, shape, seed)
    return _sha(*degrid(*planes, *idx, cu, cv))


def check_degrid_digest(torch, shape, seed, want):
    """B4's digest at one (B, W, H), with the weights given and over a
    one-row pump that computes them from the fractions."""
    from swiftly_tpu_torch.ops.kernels import degrid_rows
    from swiftly_tpu_torch.vis import vis_kernel

    got = degrid_digest(torch, shape, seed)
    planes, host, _, _ = degrid_digest_inputs(torch, shape, seed)
    table = torch.as_tensor(vis_kernel(support=shape[1]).table, device="cuda")
    pump = _sha(*degrid_rows([planes], *_host_samples(
        torch, np.zeros(shape[0], dtype=np.int64), *host), table))
    require(pump == got, f"degrid_rows {shape}: digest {pump} is not "
            f"degrid's {got}")
    return _report_digest("degrid", shape, seed, got, want)


def _host_samples(torch, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _pump_inputs(torch, shape, dtype, seed, ragged=False):
    """B4's inputs over a pump at (B, W, G, H): G rows, each the planes of
    a strided view of a larger interleaved tensor on the card (sides H, or
    with `ragged` from W + 3 to H, and rows 1, 4, 7, ... as complex views,
    rows 2, 5, 8, ... host arrays staged through pinned memory as the
    service stages the cache feed's rows), and B samples sorted by row
    slot, as the service packs them: slots, first taps (with `ragged`,
    from [-2W, side + 2): wrapped, clamped and inside) and fractions (the
    first three at 0, nextafter(1, 0) and 5/128)."""
    from swiftly_tpu_torch.vis import split_row_planes
    from swiftly_tpu_torch.vis.degrid import _staged

    B, W, G, H = shape
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(seed)
    sizes = np.full(G, H)
    if ragged:
        sizes[1:] = rng.integers(W + 3, H + 1, size=G - 1)
    rows = []
    for g, n in enumerate(sizes):
        big = rng.standard_normal((n + 3, n + 2, 2)).astype(np_dt)
        if ragged and g % 3 == 2:
            row = _staged(np.ascontiguousarray(big[1:1 + n, 2:2 + n]),
                          torch.device("cuda"))
        else:
            row = torch.as_tensor(big, device="cuda")[1:1 + n, 2:2 + n]
            if ragged and g % 3 == 1:
                row = torch.view_as_complex(row)
        rows.append(split_row_planes(row))
    slot = np.sort(rng.integers(0, G, size=B))
    n_of = sizes[slot]
    if ragged:
        iu0 = rng.integers(-2 * W, n_of + 2)
        iv0 = rng.integers(-2 * W, n_of + 2)
    else:
        iu0 = rng.integers(0, n_of - W + 1)
        iv0 = rng.integers(0, n_of - W + 1)
    fu, fv = rng.uniform(0, 1, size=(2, B))
    fu[:3] = [0.0, np.nextafter(1.0, 0.0), 5 / 128][:B]
    fv[:3] = [np.nextafter(1.0, 0.0), 5 / 128, 0.0][:B]
    return rows, (slot, iu0, iv0, fu, fv)


def _weights_probe(torch, kernel, fu, fv, dtype):
    """Whether the weights B4 computes on the card equal the host's: for
    each fraction pair, the W^2 samples of a row whose one pixel is 1, each
    sample's first taps set so that its tap (i, j) meets that pixel, give
    the device's cu[i] * cv[j] exactly; against the host's weights'
    products, bitwise."""
    from swiftly_tpu_torch.ops.kernels import degrid_rows

    W = kernel.support
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    row = torch.zeros((2 * W + 1, 2 * W + 1), dtype=dtype, device="cuda")
    row[W, W] = 1
    i, j = (a.reshape(-1) for a in np.meshgrid(np.arange(W), np.arange(W),
                                               indexing="ij"))
    P = len(fu)
    samples = _host_samples(
        torch, np.zeros(P * W * W, dtype=np.int64), np.tile(W - i, P),
        np.tile(W - j, P), np.repeat(fu, W * W), np.repeat(fv, W * W))
    table = torch.as_tensor(kernel.table, device="cuda")
    got, _ = degrid_rows([(row, torch.zeros_like(row))], *samples, table)
    cu, cv = (torch.from_numpy(kernel.weights(f, dtype=np.float64).astype(
        np_dt)) for f in (fu, fv))
    return bool(torch.equal(got.cpu(), (cu[:, :, None] * cv[:, None, :])
                            .reshape(-1)))


def check_degrid_rows(torch, shape, dtype, seed=0, timed=False,
                      ragged=False):
    """B4 over a pump against its plain version at one (B, W, G, H): the
    device weights equal to the host's (a probe, and each row's samples
    bitwise equal to ``degrid`` fed the host's weights), a sample's bits
    the same with the rows reversed and the samples shuffled (slots and
    order), over half the samples (B) and over one row (G), and reruns
    bit-identical; with `timed`, also the times and the bound."""
    from swiftly_tpu_torch.ops.kernels import (degrid, degrid_rows,
                                               degrid_rows_plain)
    from swiftly_tpu_torch.vis import vis_kernel

    B, W, G, H = shape
    rows, host = _pump_inputs(torch, shape, dtype, seed, ragged)
    slot, iu0, iv0, fu, fv = host
    k = vis_kernel(support=W)
    table = torch.as_tensor(k.table, device="cuda")
    samples = _host_samples(torch, *host)
    vr, vi = degrid_rows(rows, *samples, table)
    torch.cuda.synchronize()
    pr, pi = degrid_rows_plain(rows, *samples, table)
    max_abs = max((vr - pr).abs().max().item(), (vi - pi).abs().max().item())
    scale = max(pr.abs().max().item(), pi.abs().max().item())
    name = str(dtype).replace("torch.", "")
    rel = max_abs / scale

    def same(got, sel):
        return bool(torch.equal(got[0], vr[sel])
                    and torch.equal(got[1], vi[sel]))

    np_dt = np.float32 if dtype == torch.float32 else np.float64
    cu, cv = (torch.as_tensor(k.weights(f, dtype=np.float64).astype(np_dt),
                              device="cuda") for f in (fu, fv))
    idx = [torch.as_tensor(a, device="cuda") for a in (iu0, iv0)]
    host_bits = alone = True
    for g in range(G):
        sel_h = np.flatnonzero(slot == g)
        if sel_h.size == 0:
            continue
        sel = torch.as_tensor(sel_h, device="cuda")
        host_bits &= same(degrid(*rows[g], idx[0][sel], idx[1][sel], cu[sel],
                                 cv[sel]), sel)
        if g < 4:  # a pump of this row alone (G = 1)
            alone &= same(degrid_rows([rows[g]], *_host_samples(
                torch, slot[sel_h] * 0, *(a[sel_h] for a in host[1:])),
                table), sel)
    perm = np.random.default_rng(seed + 7).permutation(B)
    shuffled = same(degrid_rows(rows[::-1], *_host_samples(
        torch, G - 1 - slot[perm], *(a[perm] for a in host[1:])), table),
        torch.as_tensor(perm, device="cuda"))
    h = max(1, B // 2)
    halved = same(degrid_rows(rows, *(t[:h] for t in samples), table),
                  slice(0, h))
    rerun = same(degrid_rows(rows, *samples, table), slice(None))
    res = {"shape": list(shape), "dtype": name, "max_abs_err": max_abs,
           "max_rel_err": rel, "tol_rel": KERNEL_REL_TOL[name],
           "weights_equal_host": _weights_probe(torch, k, fu[:32], fv[:32],
                                                dtype),
           "equal_to_degrid_with_host_weights": host_bits,
           "bits_independent_of_order": shuffled,
           "bits_independent_of_B": halved, "bits_independent_of_G": alone,
           "bit_identical_rerun": rerun}
    require(rel <= KERNEL_REL_TOL[name],
            f"degrid_rows {shape} {name}: relative error {rel:.3e} > "
            f"{KERNEL_REL_TOL[name]:.0e}")
    for key in ("weights_equal_host", "equal_to_degrid_with_host_weights",
                "bits_independent_of_order", "bits_independent_of_B",
                "bits_independent_of_G", "bit_identical_rerun"):
        require(res[key], f"degrid_rows {shape} {name}: {key} fails")
    if timed:
        item = vr.element_size()
        pixels = sum(_touched(iu0[slot == g], iv0[slot == g], W, H).size
                     for g in range(G))
        # per sample 2 W weights (two products and a sum each, f64), the
        # tap weight and an FMA per plane per tap
        flops = B * (5 * W * W + 6 * W)
        nbytes = (item * (2 * pixels + 2 * B) + 8 * (5 * B + 6 * G)
                  + 8 * k.table.size)
        iters = 50
        run = lambda: degrid_rows(rows, *samples, table)  # noqa: E731
        res["ms"] = _device_ms(torch, run, iters)
        res["call_ms"] = _cuda_ms(torch, run, iters)
        res["plain_ms"] = _device_ms(
            torch, lambda: degrid_rows_plain(rows, *samples, table), 5)
        rowsc = torch.stack([torch.view_as_complex(torch.stack(p, -1))
                             for p in rows])
        cuc, cvc = cu.to(rowsc.dtype), cv.to(rowsc.dtype)
        offs = torch.arange(W, device="cuda")
        s = torch.as_tensor(slot, device="cuda")[:, None, None]
        iu, iv = idx[0][:, None] + offs, idx[1][:, None] + offs

        def lib():
            patches = rowsc[s, iu[:, :, None], iv[:, None, :]]
            return torch.einsum("bij,bi,bj->b", patches, cuc, cvc)

        res["library_ms"] = _device_ms(torch, lib, iters)
        res["library_call"] = (f"gather plus torch.einsum on {rowsc.dtype} "
                               "over the pump's stacked rows, the weights "
                               "given")
        res["bound_ms"], res["bound_by"] = _bound(flops, nbytes)
        res["distinct_pixels"] = int(pixels)
    log(f"degrid_rows {tuple(shape)} {name}: " + ", ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in res.items() if k not in ("shape", "dtype")))
    return res


def check_grid(torch, shape, dtype, seed=0, timed=False, one_pixel=False,
               wrap=False):
    """B4's adjoint against its plain version at one (B, W, H), adding into
    a strided view of a larger accumulator: bit-equal to the plain version,
    two runs bit-identical, nothing written outside the patches; with
    `timed`, also the times and the bound."""
    from swiftly_tpu_torch.ops.kernels import grid, grid_plain

    B, W, H = shape
    big, (iu0_h, iv0_h), (iu0, iv0, cu, cv, y) = _vis_inputs(
        torch, shape, dtype, seed, one_pixel=one_pixel, wrap=wrap)

    def run(fn, acc):
        view = acc[1:1 + H, 2:2 + H]
        fn(view[..., 0], view[..., 1], iu0, iv0, cu, cv, y[0], y[1])
        return acc

    got = run(grid, big.clone())
    again = run(grid, big.clone())
    torch.cuda.synchronize()
    want = run(grid_plain, big.clone())
    max_abs = (got - want).abs().max().item()
    scale = (want - big).abs().max().item()
    name = str(dtype).replace("torch.", "")
    rel = max_abs / scale
    touched = np.zeros((H + 3, H + 2), dtype=bool)
    flat = _touched(iu0_h, iv0_h, W, H)
    touched[1 + flat // H, 2 + flat % H] = True
    outside = torch.as_tensor(~touched, device="cuda")
    untouched = bool(torch.equal(got[outside], big[outside]))
    res = {"shape": list(shape), "dtype": name, "one_pixel": one_pixel,
           "wrapped": wrap, "max_abs_err": max_abs, "max_rel_err": rel,
           "equal_to_plain": bool(torch.equal(got, want)),
           "bit_identical_rerun": bool(torch.equal(got, again)),
           "nothing_outside_patches": untouched}
    require(res["equal_to_plain"],
            f"grid {shape} {name}: differs from its plain version (relative "
            f"error {rel:.3e})")
    require(res["bit_identical_rerun"], f"grid {shape} {name}: reruns differ")
    require(untouched, f"grid {shape} {name}: wrote outside the patches")
    if timed:
        item = big.element_size()
        pixels = flat.size
        flops = 5 * W * W * B  # the tap weight, then a multiply and an add per plane
        nbytes = item * (2 * 2 * pixels + 2 * W * B + 2 * B) + 8 * 2 * B
        iters = 20
        acc = big.clone()
        res["ms"] = _device_ms(torch, lambda: run(grid, acc), iters)
        res["call_ms"] = _cuda_ms(torch, lambda: run(grid, acc), iters)
        res["plain_ms"] = _device_ms(torch, lambda: run(grid_plain, acc),
                                     iters)
        flat_acc = acc.view(-1)  # interleaved: pixel p's planes at 2p, 2p + 1
        offs = torch.arange(W, device="cuda")
        u = (iu0[:, None] + offs)[:, :, None] + 1
        v = (iv0[:, None] + offs)[:, None, :] + 2
        pix = (u * (H + 2) + v).reshape(-1)
        w2 = (cu[:, :, None] * cv[:, None, :]).reshape(B, -1)
        idx = torch.cat([2 * pix, 2 * pix + 1])
        vals = torch.cat([(y[0][:, None] * w2).reshape(-1),
                          (y[1][:, None] * w2).reshape(-1)])
        res["library_ms"] = _device_ms(
            torch, lambda: flat_acc.index_add_(0, idx, vals), iters)
        res["library_call"] = f"index_add_ on {flat_acc.dtype} (atomics)"
        res["bound_ms"], res["bound_by"] = _bound(flops, nbytes)
        res["distinct_pixels"] = int(pixels)
    log(f"grid {tuple(shape)} {name}: " + ", ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in res.items() if k not in ("shape", "dtype")))
    return res


# -- round trips ------------------------------------------------------------


def _stats():
    import swiftly_tpu_torch as st

    return {"cmatmul": st.cmatmul_stats, "colpass": st.colpass_stats,
            "fold": st.fold_stats, "degrid": st.degrid_stats,
            "grid": st.grid_stats}


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

    def __init__(self, torch, forward, wanted, heartbeat=None):
        self.forward = forward
        self.wanted = set(wanted)
        self.samples = {}
        self.n_groups = 0
        self.heartbeat = heartbeat  # an obs.Heartbeat over the subgrids
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
            if self.heartbeat is not None:
                self.heartbeat.update(
                    sum(i is not None for col in per_col for i, _ in col),
                    group=self.n_groups)
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
                  warm=True, fold_group=4, profile=True):
    """The main path of the streamed slice: StreamedForward (facets
    resident) fed into a sampled StreamedBackward by feed_backward_passes,
    planar, from real facet planes on the host."""
    import swiftly_tpu_torch as st
    from swiftly_tpu_torch.parallel import streamed as sm
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
    S = n // len({sg.off0 for sg in sgcs})
    xA = sgcs[0].size
    models = []

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
        models.append(sm.stream_peak_bytes(
            fwd, n // S, S, xA, *_consumers([bwd], S, xA),
            held=len(idxs) * xA * xA * 2 * item))
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
    before = _reset_peak(torch)
    reset_counts()
    facets, samples, t_fwd, t_bwd, plan, n_groups, digests = one_run()
    counts = read_counts()
    n_cols = n // S
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
        out["sizer"] = _sizer_record(f"{config_name} streamed",
                                     models[-1] + before, _peak(torch))
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
                                          else digests == warm_digests),
        facet_digests=digests)
    log(f"{config_name} streamed accuracy: max subgrid RMS {max(sg_rms):.3e} "
        f"over {len(idxs)} samples (bound {SUBGRID_REL_RMS * scale:.3e}), "
        f"max facet RMS {max(f_rms):.3e} over {F} facets (bound "
        f"{FACET_RMS:.0e}), facets bit-identical to the warm run: "
        f"{out['bit_identical_to_warm_run']}; facet sha256 "
        f"{' '.join(d[:16] for d in digests)}")
    require(all(np.isfinite(sg_rms)) and all(np.isfinite(f_rms)),
            "non-finite RMS")
    require(max(sg_rms) <= SUBGRID_REL_RMS * scale,
            "streamed subgrid RMS over bound")
    require(max(f_rms) <= FACET_RMS, "streamed facet RMS over bound")
    require(warm_digests is None or digests == warm_digests,
            "the warm and timed runs' facets differ")
    if device == "cuda":
        missing = [k for k in ("cmatmul", "colpass", "fold")
                   if out["launches"][k] == 0]
        require(not missing, f"the streamed main path launched {missing} "
                             "no time")
        fwd_b1 = sum(v for key, v in counts["colpass"][1].items() if key[-1])
        bwd_b1 = sum(v for key, v in counts["colpass"][1].items()
                     if not key[-1])
        require(fwd_b1 > 0 and bwd_b1 > 0,
                f"B1 ran {fwd_b1} forward and {bwd_b1} backward launches")
    if device == "cuda" and profile:
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


def _device_events(prof):
    """[(name, start_ns, end_ns)] of every device activity of a finished
    profile, read from its kineto results: the profiler's event tree takes
    minutes to build for a trace of many thousands of launches."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def _kernel_seconds(events, kernel):
    """(device seconds, launches) of the hand-written `kernel` (its C++
    name, e.g. ``grid_kernel``) among `_device_events`."""
    spans = [b - a for name, a, b in events if f"::{kernel}<" in name]
    return sum(spans) / 1e9, len(spans)


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


# -- beside phase 6: the slab paths at 32k ---------------------------------


def _subgrids_in_order(torch, fwd, sgcs, out):
    """Every subgrid of `fwd`'s stream written into `out` [n, xA, xA, 2]
    on the device, in cover order; the stream's device seconds."""
    t0 = time.perf_counter()
    for items, sg in fwd.stream_columns(sgcs, device_arrays=True):
        idx = torch.as_tensor([i for i, _ in items], device=out.device)
        out[idx] = sg[:len(items)]
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _max_abs(torch, a, b, chunk=256):
    """max |a - b| and max |b| over [n, ...] device tensors, in chunks."""
    diff = scale = 0.0
    for k in range(0, a.shape[0], chunk):
        diff = max(diff, (a[k:k + chunk] - b[k:k + chunk]).abs().max().item())
        scale = max(scale, b[k:k + chunk].abs().max().item())
    return diff, scale


def slabs_main(torch, config_name=MAIN_CONFIG, fold_group=4,
               split_row=5000, device="cuda"):
    """The slab paths at 32k beside phase 6 (planar f32): the forward with
    facet_group forced to 1 and 3, from dense real planes on the host (the
    pinned staging ring) and from sparse facets synthesised on the card,
    against the resident forward (the f32 kernel bound, relative to the
    largest value) and the oracle, reruns bit-identical; one forward fed
    into the whole backward and two row slabs split at `split_row` (no
    multiple of the fold's row block), the slabs concatenated equal to the
    whole; ``synth_facet_device`` equal to the densified upload."""
    import swiftly_tpu_torch as st
    from swiftly_tpu_torch.parallel import streamed as sm

    cfg = st.SwiftlyConfig(backend="planar", dtype=torch.float32,
                           device=device, **st.SWIFT_CONFIGS[config_name])
    core = cfg.core
    N = cfg.image_size
    sources = sources_for(N)
    fcs = st.make_full_facet_cover(cfg)
    sgcs = st.make_full_subgrid_cover(cfg)
    n, xA, yB = len(sgcs), sgcs[0].size, fcs[0].size
    dense = [st.make_real_facet(N, fc, sources) for fc in fcs]
    sparse = [st.make_sparse_facet(N, fc, sources) for fc in fcs]
    stride = max(1, n // MIN_SUBGRID_SAMPLES)
    idxs = list(range(0, n, stride))
    bound = SUBGRID_REL_RMS * sum(abs(s[0]) for s in sources) / N**2
    out = {"config": config_name}

    def forward(data, fg):
        fwd = st.StreamedForward(cfg, list(zip(fcs, data)),
                                 residency="device", facet_group=fg)
        got = torch.empty((n, xA, xA, 2), dtype=torch.float32, device=device)
        before = _reset_peak(torch)
        secs = _subgrids_in_order(torch, fwd, sgcs, got)
        fwd.peak_bytes = _peak(torch) - before
        return got, fwd, secs

    ref, fwd_ref, ref_s = forward(dense, None)
    require(fwd_ref.last_plan["mode"] == "resident",
            f"the 32k forward did not stay resident: {fwd_ref.last_plan}")
    out["resident_s"] = ref_s
    runs = {}
    for source, data in (("host", dense), ("sparse", sparse)):
        for fg in (1, 3):
            got, fwd, secs = forward(data, fg)
            plan = fwd.last_plan
            diff, scale = _max_abs(torch, got, ref)
            rms = max(st.check_subgrid(N, sgcs[i], core.as_complex(got[i]),
                                       sources) for i in idxs)
            rec = {"plan": plan, "seconds": secs, "max_rel_to_resident":
                   diff / scale, "max_subgrid_rms": rms,
                   "peak_gb": fwd.peak_bytes / 1e9,
                   "modelled_gb": _modelled_bytes(fwd, sgcs) / 1e9}
            want = "device-synth-sparse" if source == "sparse" else "host"
            require(plan["mode"] == "grouped" and plan["facet_group"] == fg
                    and plan["facet_source"] == want,
                    f"32k {source} facet_group {fg}: plan {plan}")
            require(diff / scale <= KERNEL_REL_TOL["float32"],
                    f"32k {source} facet_group {fg}: {diff / scale:.3e} from "
                    "the resident forward")
            require(rms <= bound, f"32k {source} facet_group {fg}: subgrid "
                    f"RMS {rms:.3e} over {bound:.3e}")
            if (source, fg) in (("host", 3), ("sparse", 1)):
                again, _, rec["rerun_s"] = forward(data, fg)
                rec["bit_identical_rerun"] = bool(torch.equal(again, got))
                require(rec["bit_identical_rerun"],
                        f"32k {source} facet_group {fg}: reruns differ")
                del again
            del got
            runs[f"{source}_fg{fg}"] = rec
            log(f"{config_name} slabs {source} facet_group {fg}: " +
                json.dumps(rec))
    out["forwards"] = runs
    del ref

    # row slabs: one resident forward feeds the whole backward and two slabs
    block = sm._fold_row_block(len(fcs), yB, 4)
    require(split_row % block != 0, "the row split is a multiple of the "
            "fold's row block")
    fwd = st.StreamedForward(cfg, list(zip(fcs, dense)), residency="device")
    # the three backwards' accumulators (the whole and two slabs: two
    # facet stacks) and rows in flight
    fwd.hbm_headroom = 2 * len(fcs) * yB * yB * 8 + 3 * (
        2 * fold_group + 2) * len(fcs) * core.xM_yN_size * yB * 8
    whole = st.StreamedBackward(cfg, fcs, residency="sampled",
                                fold_group=fold_group)
    slabs = [st.StreamedBackward(cfg, fcs, residency="sampled",
                                 fold_group=fold_group, row_slab=rows)
             for rows in ((0, split_row), (split_row, yB))]
    st.feed_backward_passes(fwd, sgcs, [whole] + slabs)
    full = whole.finish_device()
    parts = [b.finish_device() for b in slabs]
    out["row_slabs"] = {"split_row": split_row, "fold_row_block": block,
                        "concatenated_equal_whole": all(
                            torch.equal(p, full[:, a:b]) for p, (a, b) in
                            zip(parts, ((0, split_row), (split_row, yB))))}
    require(out["row_slabs"]["concatenated_equal_whole"],
            "32k row slabs differ from the whole backward")
    del full, parts, whole, slabs, fwd

    sfwd = st.StreamedForward(cfg, list(zip(fcs, sparse)), residency="device")
    out["synth_equal_densified"] = all(
        torch.equal(sfwd.synth_facet_device(i),
                    torch.as_tensor(sp.densify(np.float32), device=device))
        for i, sp in enumerate(sparse))
    require(out["synth_equal_densified"],
            "synth_facet_device differs from the densified upload")
    log(f"{config_name} slabs: " + json.dumps(
        {k: v for k, v in out.items() if k != "forwards"}))
    return out


def _reset_peak(torch):
    """Reset the device's peak-memory count; the bytes allocated now."""
    if not torch.cuda.is_available():
        return 0
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak(torch):
    return (torch.cuda.max_memory_allocated() if torch.cuda.is_available()
            else 0)


def _modelled_bytes(fwd, sgcs):
    """The device bytes the slab sizer prices for the plan `fwd` ran:
    its flat costs plus G times its cost a column
    (``streamed.grouped_working_set``)."""
    from swiftly_tpu_torch.parallel import streamed as sm

    plan = fwd.last_plan
    S = len(sgcs) // len({sg.off0 for sg in sgcs})  # a full cover
    flat, per_G = sm.grouped_working_set(
        fwd._base, S, sgcs[0].size, fwd._facets_real, plan["facet_group"], 1,
        1 if fwd._facets_sparse else plan["slab_depth"])
    return flat + plan["col_group"] * per_G


# the band each sizer's modelled peak must lie in, as a multiple of the
# device peak measured beside it (torch.cuda.max_memory_allocated)
SIZER_BAND = (1.0, 1.3)


def _sizer_record(tag, model, peak):
    """The sizer's modelled peak beside the measured one, gated on
    `SIZER_BAND` on the card."""
    rec = {"modelled_peak_gb": model / 1e9, "peak_gb": peak / 1e9,
           "model_over_peak": model / peak if peak else None}
    log(f"{tag}: the sizer's modelled peak {model / 1e9:.3f} GB beside the "
        f"measured {peak / 1e9:.3f} GB (x{rec['model_over_peak'] or 0:.4f})")
    if peak:
        require(SIZER_BAND[0] <= rec["model_over_peak"] <= SIZER_BAND[1],
                f"{tag}: the sizer's model is {rec['model_over_peak']:.4f} "
                f"times the measured peak, outside {SIZER_BAND}")
    return rec


def _consumers(backwards, S, xA):
    """(resting, active) of the backwards one feed serves together: their
    resting bytes summed, and one of them at work."""
    pairs = [b.device_bytes(S, xA) for b in backwards]
    resting = sum(r for r, _ in pairs)
    return resting, resting + max(a - r for r, a in pairs)


# -- phase 10: the host and device residencies at 32k ----------------------


def _rss_gib():
    """The process's resident host memory now (``/proc/self/statm``),
    GiB."""
    import os

    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 2**30


def _host_peak_gib():
    """The process's peak resident host memory so far (``getrusage``),
    GiB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _release_pinned(torch):
    """Drop freed device blocks and hand PyTorch's cached pinned host
    blocks back to the system (a host row buffer is ~16 GiB at 32k)."""
    import gc

    gc.collect()
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()
    torch.cuda.empty_cache()


class _env:
    """Set one environment variable for a ``with`` block."""

    def __init__(self, name, value):
        import os

        self.os, self.name, self.value = os, name, value

    def __enter__(self):
        self.prior = self.os.environ.get(self.name)
        self.os.environ[self.name] = self.value

    def __exit__(self, *exc):
        if self.prior is None:
            del self.os.environ[self.name]
        else:
            self.os.environ[self.name] = self.prior


def _host_facets_rel_rms(torch, got, ref, device="cuda"):
    """RMS of ``got - ref`` over max |ref|, for host facet stacks
    [F, yB, yB, 2], facet by facet on `device` in float64."""
    d2 = count = scale = 0.0
    for a, b in zip(got, ref):
        a = torch.as_tensor(a, device=device).double()
        b = torch.as_tensor(b, device=device).double()
        d2 += float(((a - b) ** 2).sum().item())
        count += a.numel() / 2
        scale = max(scale, float((b ** 2).sum(-1).max().sqrt().item()))
        del a, b
    return (d2 / count) ** 0.5 / scale


def residency_main(torch, config_name=MAIN_CONFIG, fold_group=4,
                   col_block=512, device="cuda", warm=True):
    """Phase 10: the host and device residencies at 32k, planar f32, from
    real facet planes on the host. (a) ``StreamedForward(residency=
    "host")`` (the FFT facet pass into the host row buffer, a column's
    rows uploaded for each column pass) -> ``stream_columns(...,
    device_arrays=True)`` -> ``StreamedBackward(residency="device")
    .add_subgrid_stack`` per column -> ``finish()`` (the backward FFT facet
    pass), a warm and a timed run; (b) a resident forward feeding
    ``StreamedBackward(residency="host")`` once; (c) on the first column
    group (`fold_group` columns), the FFT column bodies and the FFT and CT
    folds against the default bodies."""
    import swiftly_tpu_torch as st

    cfg = st.SwiftlyConfig(backend="planar", dtype=torch.float32,
                           device=device, **st.SWIFT_CONFIGS[config_name])
    core = cfg.core
    N = cfg.image_size
    sources = sources_for(N)
    fcs = st.make_full_facet_cover(cfg)
    sgcs = st.make_full_subgrid_cover(cfg)
    F = len(fcs)
    t0 = time.perf_counter()
    facets_in = [st.make_real_facet(N, fc, sources) for fc in fcs]
    tasks = list(zip(fcs, facets_in))
    n = len(sgcs)
    idxs = list(range(0, n, max(1, n // MIN_SUBGRID_SAMPLES)))
    wanted = set(idxs)
    scale = sum(abs(s[0]) for s in sources) / N**2
    out = {"config": config_name, "col_block": col_block,
           "fold_group": fold_group, "n_subgrid_samples": len(idxs),
           "facet_setup_s": time.perf_counter() - t0}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def feed(fwd, bwd):
        """Every column of `fwd` into `bwd`, the wanted subgrids kept on
        the card; (samples, seconds, synchronised at both ends)."""
        samples = {}
        sync()
        t = time.perf_counter()
        for items, sub in fwd.stream_columns(sgcs, device_arrays=True):
            for s, (i, _) in enumerate(items):
                if i in wanted:
                    samples[i] = sub[s].clone()
            bwd.add_subgrid_stack([sg for _, sg in items], sub[:len(items)])
        sync()
        return samples, time.perf_counter() - t

    def host_run():
        fwd = st.StreamedForward(cfg, tasks, col_block=col_block,
                                 residency="host")
        bwd = st.StreamedBackward(cfg, fcs, col_block=col_block,
                                  residency="device")
        samples, stream_s = feed(fwd, bwd)
        plan = fwd.last_plan
        del fwd
        t = time.perf_counter()
        facets = bwd.finish()
        return facets, samples, plan, stream_s, time.perf_counter() - t

    def digests(facets):
        return [hashlib.sha256(f.data).hexdigest() for f in facets]

    # (a) the host forward into the device backward, warm then timed
    warm_digests = None
    if warm:
        facets, _, _, _, _ = host_run()
        warm_digests = digests(facets)
        del facets
        gc_collect(torch)
        log(f"{config_name} residency: warm run done")
    rss0 = _rss_gib()
    _reset_peak(torch)
    reset_counts()
    facets_a, samples_a, plan, stream_s, finish_s = host_run()
    counts = read_counts()
    rec = {
        "plan": plan, "forward_and_column_passes_s": stream_s,
        "facet_pass_s": plan["facet_pass_s"],
        "facet_pass_d2h_gb": plan["facet_d2h_bytes"] / 1e9,
        "facet_pass_h2d_gb": plan["facet_h2d_bytes"] / 1e9,
        "column_uploads": plan["column_uploads"],
        "column_upload_gb": plan["column_upload_bytes"] / 1e9,
        "column_passes_s": stream_s - plan["facet_pass_s"],
        "finish_s": finish_s, "roundtrip_s": stream_s + finish_s,
        "peak_device_gib": _peak(torch) / 2**30,
        "host_rss_gib_before": rss0, "host_rss_gib_after": _rss_gib(),
        "host_peak_gib": _host_peak_gib(),
        "launches": {k: v[0] for k, v in counts.items()},
    }
    dig = digests(facets_a)
    sg_rms = [st.check_subgrid(N, sgcs[i], core.as_complex(samples_a[i]),
                               sources) for i in idxs]
    f_rms = []
    for i in range(F):  # the oracle is the input real plane
        got = torch.as_tensor(facets_a[i], device=device).double()
        ref = torch.as_tensor(facets_in[i], device=device).double()
        d2 = (got[..., 0] - ref) ** 2 + got[..., 1] ** 2
        f_rms.append(float(d2.mean().sqrt().item()))
        del got, ref, d2
    rec.update(max_subgrid_rms=max(sg_rms), subgrid_rms_bound=(
        SUBGRID_REL_RMS * scale), max_facet_rms=max(f_rms),
        facet_rms_bound=FACET_RMS, bit_identical_to_warm_run=(
            None if warm_digests is None else dig == warm_digests),
        facet_digests=dig)
    fwd_b1 = sum(v for key, v in counts["colpass"][1].items() if key[-1])
    bwd_b1 = sum(v for key, v in counts["colpass"][1].items() if not key[-1])
    rec["b1_forward_launches"], rec["b1_adjoint_launches"] = fwd_b1, bwd_b1
    out["host"] = rec
    out["counts"] = counts
    log(f"{config_name} residency (a) host forward -> device backward: " +
        json.dumps({k: v for k, v in rec.items() if k != "facet_digests"}))
    require(all(np.isfinite(sg_rms)) and all(np.isfinite(f_rms)),
            "residency: non-finite RMS")
    require(max(sg_rms) <= SUBGRID_REL_RMS * scale,
            "residency: host-forward subgrid RMS over bound")
    require(max(f_rms) <= FACET_RMS,
            "residency: device-backward facet RMS over bound")
    require(warm_digests is None or dig == warm_digests,
            "residency: the warm and timed runs' facets differ")
    require(device != "cuda" or (fwd_b1 > 0 and bwd_b1 > 0
                                 and rec["launches"]["cmatmul"] > 0),
            f"residency: B1 ran {fwd_b1} forward and {bwd_b1} adjoint "
            f"launches, B3 {rec['launches']['cmatmul']}")
    _release_pinned(torch)

    # (b) a resident forward feeding the host backward once
    from swiftly_tpu_torch.parallel import streamed as sm

    fwd = st.StreamedForward(cfg, tasks, residency="device")
    bwd = st.StreamedBackward(cfg, fcs, col_block=col_block,
                              residency="host")
    before_b = _reset_peak(torch)
    samples_b, stream_b = feed(fwd, bwd)
    plan_b = fwd.last_plan
    S, xA = len(sgcs) // len({sg.off0 for sg in sgcs}), sgcs[0].size
    model_b = sm.stream_peak_bytes(
        fwd, len(sgcs) // S, S, xA, *_consumers([bwd], S, xA),
        held=len(idxs) * xA * xA * 8) + before_b
    peak_b = _peak(torch)
    del fwd
    t = time.perf_counter()
    facets_b = bwd.finish()
    finish_b = time.perf_counter() - t
    del bwd
    diff = sub_scale = 0.0
    for i in idxs:
        diff = max(diff, (samples_a[i] - samples_b[i]).abs().max().item())
        sub_scale = max(sub_scale, samples_b[i].abs().max().item())
    rec_b = {"forward_plan": plan_b, "resident_forward_and_column_passes_s":
             stream_b, "finish_s": finish_b, "host_peak_gib": _host_peak_gib(),
             "host_rss_gib_after": _rss_gib(),
             "host_forward_max_rel_to_resident": diff / sub_scale,
             "facets_rel_rms_to_a": _host_facets_rel_rms(torch, facets_b,
                                                         facets_a, device)}
    if device == "cuda":
        rec_b["sizer"] = _sizer_record(f"{config_name} residency (b)",
                                       model_b, peak_b)
    del facets_a, facets_b, samples_a, samples_b
    out["host_backward"] = rec_b
    log(f"{config_name} residency (b) resident forward -> host backward: " +
        json.dumps(rec_b))
    require(rec_b["host_forward_max_rel_to_resident"]
            <= KERNEL_REL_TOL["float32"],
            "residency: the host forward's subgrids differ from the "
            f"resident forward's by {diff / sub_scale:.3e}")
    require(rec_b["facets_rel_rms_to_a"] <= FACET_RMS,
            "residency: the host backward's facets differ from (a)'s by "
            f"{rec_b['facets_rel_rms_to_a']:.3e}")
    _release_pinned(torch)

    # (c) the selectable bodies on the first column group
    offs = list(dict.fromkeys(sg.off0 for sg in sgcs))[:fold_group]
    group = [sg for sg in sgcs if sg.off0 in offs]
    reset_counts()

    def columns(fwd):
        sync()
        t = time.perf_counter()
        cols = list(fwd.stream_columns(group, device_arrays=True))
        sync()
        return cols, time.perf_counter() - t

    fwd = st.StreamedForward(cfg, tasks, col_block=col_block,
                             residency="host")
    columns(fwd)  # the facet pass for these columns' rows
    ref_cols, default_s = columns(fwd)
    with _env("SWIFTLY_COLPASS", "fft"):
        fft_cols, fft_s = columns(fwd)
    del fwd
    diff = sub_scale = 0.0
    for (_, a), (_, b) in zip(fft_cols, ref_cols):
        d, sc = _max_abs(torch, a, b)
        diff, sub_scale = max(diff, d), max(sub_scale, sc)
    del fft_cols
    bodies = {"columns": len(offs), "subgrids": len(group),
              "forward_default_s": default_s, "SWIFTLY_COLPASS=fft": {
                  "seconds": fft_s, "max_rel": diff / sub_scale}}

    def backward():
        bwd = st.StreamedBackward(cfg, fcs, residency="sampled",
                                  fold_group=fold_group)
        sync()
        t = time.perf_counter()
        for items, sub in ref_cols:
            bwd.add_subgrid_stack([sg for _, sg in items], sub)
        facets = bwd.finish_device()
        sync()
        return facets, time.perf_counter() - t

    ref_f, bodies["backward_default_s"] = backward()
    for knob, value in (("SWIFTLY_COLPASS_BWD", "fft"),
                        ("SWIFTLY_FOLD", "fft"), ("SWIFTLY_FOLD", "ct")):
        with _env(knob, value):
            got, secs = backward()
        d, sc = _max_abs(torch, got, ref_f)
        bodies[f"{knob}={value}"] = {"seconds": secs, "max_rel": d / sc}
        del got
    del ref_f, ref_cols
    bodies["counts"] = read_counts()
    bodies["launches"] = {k: v[0] for k, v in bodies["counts"].items()}
    out["bodies"] = bodies
    log(f"{config_name} residency (c) bodies on {len(offs)} columns: " +
        json.dumps({k: v for k, v in bodies.items() if k != "counts"}))
    for key, val in bodies.items():
        if isinstance(val, dict) and "max_rel" in val:
            require(val["max_rel"] <= KERNEL_REL_TOL["float32"],
                    f"residency: {key} differs from the default body by "
                    f"{val['max_rel']:.3e}")
    require(device != "cuda" or bodies["launches"]["cmatmul"] > 0,
            "residency: the FFT bodies launched B3 no time")
    del facets_in, tasks
    gc_collect(torch)
    return out


def _residency_line(res):
    """Phase 10's JSON record without the per-shape launch counts (the
    `kernels` line's ``paths`` holds them)."""
    line = {k: v for k, v in res.items() if k != "counts"}
    line["bodies"] = {k: v for k, v in res["bodies"].items()
                      if k != "counts"}
    line["host"] = {k: v for k, v in res["host"].items()
                    if k != "facet_digests"}
    return line


# -- phase 11: the partitioned round trip over a recorded stream -----------

# The plan's operator overrides: 3 facet passes x 3 output-row slabs, 3
# passes a feed (3 feeds). At 3 facets a pass the fold's row block is 1408
# rows, so 2 slabs of 5632 rows would be 4 blocks each; 3 slabs of 3755
# rows are no multiple of it (the clamped last block runs).
SPILL_FACET_PASSES = 3
SPILL_ROW_SLABS = 3
SPILL_FEED_GROUP = 3


def _device_digest(torch, x, chunk=1 << 26):
    """A digest of a tensor's bits computed where it lies: the sum of its
    32-bit words and their index-weighted sum, each as wrapping 64-bit
    integers. It tells two runs' outputs apart (any one changed word moves
    the first sum); it is no cryptographic hash."""
    w = x.contiguous().view(-1).view(torch.int32)
    s1 = s2 = 0
    for c0 in range(0, w.numel(), chunk):
        c = w[c0:c0 + chunk].long()
        idx = torch.arange(c0 + 1, c0 + 1 + c.numel(), dtype=torch.int64,
                           device=c.device)
        s1 += int(c.sum().item())
        s2 += int((c * idx).sum().item())
        del c, idx
    return f"{s1 & (2**64 - 1):016x}{s2 & (2**64 - 1):016x}"


class _RssPeak:
    """The process's peak resident host memory inside a ``with`` block
    (``/proc/self/statm`` read every 50 ms on a thread), GiB."""

    def __enter__(self):
        import threading

        self.peak = _rss_gib()
        self._stop = threading.Event()

        def poll():
            while not self._stop.wait(0.05):
                self.peak = max(self.peak, _rss_gib())

        self._thread = threading.Thread(target=poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_gib())


def spill_main(torch, config_name=MAIN_CONFIG, fold_group=4, device="cuda",
               facet_passes=SPILL_FACET_PASSES, row_slabs=SPILL_ROW_SLABS,
               feed_group=SPILL_FEED_GROUP, warm=True, phase6_digests=None):
    """Phase 11: the partitioned sampled round trip at 32k as the JAX
    package's ``roundtrip-streamed`` composes it (bench.py:700-960), planar
    f32, from real facet planes on the host: the plan
    (``plan_backward_passes`` with the operator overrides,
    ``plan_backward_feed``), then per feed chunk ``StreamedBackward(
    residency="sampled", row_slab=...)`` over the chunk's facets fed by
    ``feed_backward_passes(..., spill=..., feed_index=k)`` from one
    ``StreamedForward(residency="device")``. (a) cache-fed from a fresh
    ``SpillCache()`` (its default budget), warm and timed; the warm run's
    cache then feeds the whole-facet backward, the unpartitioned
    reference; (b) replay-fed (``spill=None``); (c) a cache about 1 GB
    under the stream with a temporary disk tier. Gated on bit-identity
    across the runs, the unpartitioned reference, the oracle, and the
    forwards and cache reads each run must take."""
    import shutil
    import tempfile

    import swiftly_tpu_torch as st
    from swiftly_tpu_torch import plan
    from swiftly_tpu_torch.parallel import streamed as sm
    from swiftly_tpu_torch.utils.spill import SpillCache

    cuda = device == "cuda"
    cfg = st.SwiftlyConfig(backend="planar", dtype=torch.float32,
                           device=device, **st.SWIFT_CONFIGS[config_name])
    core = cfg.core
    N = cfg.image_size
    sources = sources_for(N)
    fcs = st.make_full_facet_cover(cfg)
    sgcs = st.make_full_subgrid_cover(cfg)
    F, yB, m, xA = len(fcs), fcs[0].size, core.xM_yN_size, sgcs[0].size
    n_cols = len({sg.off0 for sg in sgcs})
    S = len(sgcs) // n_cols
    rss0 = _rss_gib()
    t0 = time.perf_counter()
    facets_in = [st.make_real_facet(N, fc, sources) for fc in fcs]
    tasks = list(zip(fcs, facets_in))
    out = {"config": config_name, "fold_group": fold_group,
           "facet_setup_s": time.perf_counter() - t0}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # the plan from the compiler, with the operator overrides, gated equal
    # to the parts and feed group the plan functions give by hand
    budget = plan.hbm_budget_bytes(device=device)
    compiled = plan.compile_plan(
        plan.PlanInputs.from_cover(cfg, fcs, sgcs, hbm_budget=budget,
                                   real_facets=True, fold_group=fold_group,
                                   config_name=config_name),
        n_facet_env=facet_passes, n_row_env=row_slabs, feed_env=feed_group)
    parts, resident = compiled.backward.parts, compiled.backward.resident_bytes
    q = compiled.backward.feed_group
    fwd_min, reserve = plan.plan_margins(
        st.StreamedForward(cfg, tasks, residency="device"), xA, fold_group)
    hand = plan.plan_backward_passes(
        F, yB, yB * yB * 8, m * yB * 8, fold_group, budget, fwd_min, reserve,
        n_facet_env=facet_passes, n_row_env=row_slabs)
    hand_q = plan.plan_backward_feed(hand[0], hand[1], budget, fwd_min,
                                     reserve, feed_env=feed_group)
    require(compiled.coeffs_source == "default"
            and compiled.backward.fold_group == fold_group
            and (parts, resident, q) == (*hand, hand_q),
            f"spill: compile_plan gave {compiled.backward.as_dict()}, by "
            f"hand {len(hand[0])} parts, feed group {hand_q}")
    chunks = [parts[i:i + q] for i in range(0, len(parts), q)]
    headroom = q * resident + reserve
    F_sub = max(i1 - i0 for i0, i1, _, _ in parts)
    block = sm._fold_row_block(F_sub, yB, 4)
    heights = sorted({r1 - r0 for _, _, r0, r1 in parts})
    out["plan"] = {
        "budget_gb": None if budget is None else budget / 1e9,
        "compiled": True, "spill_mode": compiled.spill.mode,
        "predicted_wall_s": compiled.predicted["wall_s"],
        "fwd_min_gb": fwd_min / 1e9, "reserve_gb": reserve / 1e9,
        "parts": parts, "resident_gb": resident / 1e9, "feed_group": q,
        "n_feeds": len(chunks), "hbm_headroom_gb": headroom / 1e9,
        "slab_heights": heights, "fold_row_block": block}
    log(f"{config_name} spill plan: {json.dumps(out['plan'])}")
    require(len({p[:2] for p in parts}) == facet_passes
            and len({p[2:] for p in parts}) == row_slabs,
            f"spill: the plan is not {facet_passes} x {row_slabs}: {parts}")
    require(all(h % block for h in heights),
            f"spill: a slab height of {heights} is a multiple of the fold's "
            f"row block {block}")

    def run(spill, keep=None, only=None):
        """One partitioned round trip (`only`: those feeds alone); per feed
        its seconds (synchronised at both ends of the feed and its
        finishes), groups and what the forward did with the cache; each
        part's digest."""
        fwd = st.StreamedForward(cfg, tasks, residency="device")
        fwd.hbm_headroom = headroom
        feeds, digests, plan_g = [], {}, None
        for k, chunk in enumerate(chunks):
            if only is not None and k not in only:
                continue
            bwds = [st.StreamedBackward(cfg, fcs[i0:i1], residency="sampled",
                                        fold_group=fold_group,
                                        row_slab=(r0, r1))
                    for i0, i1, r0, r1 in chunk]
            timed = _TimedFeed(torch, fwd, []) if cuda else fwd
            sync()
            t = time.perf_counter()
            n_groups = st.feed_backward_passes(timed, sgcs, bwds, spill=spill,
                                               feed_index=k)
            res = [b.finish_device() for b in bwds]
            sync()
            rec = {"seconds": time.perf_counter() - t, "groups": n_groups,
                   "spill": fwd.last_spill,
                   "generator_device_s": timed.forward_s() if cuda else None}
            if fwd.last_plan is not None and plan_g is None:
                plan_g = dict(fwd.last_plan)
            for part, r in zip(chunk, res):
                digests[part] = _device_digest(torch, r)
                if keep is not None:
                    keep(part, r)
            # this feed's modelled peak: the forward's stream beside the
            # chunk's backwards, or, replayed, a group in their hands
            # beside the next one uploaded
            resting, active = _consumers(bwds, S, xA)
            if rec["spill"] and rec["spill"].get("mode") == "replay":
                group_b = len(spill.meta(0)) * S * xA * xA * 8
                rec["model"] = 2 * group_b + active + sm._RESERVE_BYTES
            else:
                rec["model"] = sm.stream_peak_bytes(fwd, n_cols, S, xA,
                                                    resting, active)
            del res, bwds
            feeds.append(rec)
        model = max(f["model"] for f in feeds)
        return {"feeds": feeds, "seconds": sum(f["seconds"] for f in feeds),
                "digests": digests, "forward_plan": plan_g,
                "model": model,
                "spill": None if spill is None else spill.stats()}

    def b1_forward(counts):
        return sum(v for key, v in counts["colpass"][1].items() if key[-1])

    def launches(counts):
        return {k: v[0] for k, v in counts.items()}

    # (a) cache-fed from the default cache: warm, then the reference
    a_warm = None
    ref_host = None
    if warm:
        spill_w = SpillCache()
        a_warm = run(spill_w)
        # the unpartitioned reference (phase 6's composition) fed from the
        # warm run's recording
        whole = st.StreamedBackward(cfg, fcs, residency="sampled",
                                    fold_group=fold_group)
        st.feed_backward_passes(st.StreamedForward(cfg, tasks,
                                                   residency="device"),
                                sgcs, [whole], spill=spill_w)
        ref_dev = whole.finish_device()
        ref_host = ref_dev.cpu()
        del ref_dev, whole
        spill_w.reset()
        del spill_w
        gc_collect(torch)
        log(f"{config_name} spill: warm run done ({a_warm['seconds']:.3f} s)")
    if phase6_digests is not None and ref_host is not None:
        out["reference_equal_phase6"] = [
            hashlib.sha256(ref_host[i].numpy().tobytes()).hexdigest()
            for i in range(F)] == list(phase6_digests)
    acc = {"d2_ref": 0.0, "n": 0, "ref_scale": 0.0, "equal_ref": True,
           "oracle_d2": [0.0] * F, "oracle_n": [0] * F}

    def check(part, r):
        """A part against the unpartitioned reference and the oracle."""
        i0, i1, r0, r1 = part
        if ref_host is not None:
            ref = ref_host[i0:i1, r0:r1].to(r.device)
            acc["equal_ref"] &= bool(torch.equal(r, ref))
            acc["d2_ref"] += float(((r.double() - ref.double()) ** 2)
                                   .sum().item()) / 2
            acc["n"] += r.numel() // 2
            acc["ref_scale"] = max(acc["ref_scale"], float(
                (ref.double() ** 2).sum(-1).max().sqrt().item()))
            del ref
        for j, i in enumerate(range(i0, i1)):
            orc = torch.as_tensor(facets_in[i][r0:r1], device=r.device,
                                  dtype=torch.float64)
            d2 = (r[j][..., 0].double() - orc) ** 2 + r[j][..., 1].double() ** 2
            acc["oracle_d2"][i] += float(d2.sum().item())
            acc["oracle_n"][i] += d2.numel()
            del orc, d2

    spill_a = SpillCache()
    before_a = _reset_peak(torch)
    reset_counts()
    with _RssPeak() as rss_a:
        a = run(spill_a, keep=check)
    counts_a = read_counts()
    a["peak_device_gib"] = _peak(torch) / 2**30 if cuda else None
    if cuda:
        a["sizer"] = _sizer_record(f"{config_name} spill (a)",
                                   a["model"] + before_a, _peak(torch))
    a["host_peak_gib"] = rss_a.peak
    a["host_peak_above_start_gib"] = rss_a.peak - rss0
    a["launches"] = launches(counts_a)
    a["b1_forward_launches"] = b1_forward(counts_a)
    del ref_host
    a["retry"] = _replay_with_read_fault(torch, run, spill_a, a["digests"],
                                         device)
    spill_a.reset()
    del spill_a
    gc_collect(torch)
    f_rms = [(d2 / max(1, n)) ** 0.5 for d2, n in
             zip(acc["oracle_d2"], acc["oracle_n"])]
    a["max_facet_rms"] = max(f_rms)
    if warm:
        a["rel_rms_to_unpartitioned"] = (
            (acc["d2_ref"] / max(1, acc["n"])) ** 0.5 / acc["ref_scale"])
        a["bit_equal_unpartitioned"] = acc["equal_ref"]
        a["bit_identical_to_warm_run"] = a["digests"] == a_warm["digests"]

    # (b) replay-fed: a forward a feed
    reset_counts()
    with _RssPeak() as rss_b:
        b = run(None)
    counts_b = read_counts()
    b["host_peak_gib"] = rss_b.peak
    b["launches"] = launches(counts_b)
    b["b1_forward_launches"] = b1_forward(counts_b)
    gc_collect(torch)

    # (c) RAM and disk: a budget about 1 GB under the stream
    stream_bytes = a["spill"]["ram_bytes"] + a["spill"]["disk_bytes"]
    tmp = tempfile.mkdtemp(prefix="swiftly_spill_smoke_")
    try:
        spill_c = SpillCache(budget_bytes=stream_bytes - 1e9, spill_dir=tmp)
        reset_counts()
        with _RssPeak() as rss_c:
            c = run(spill_c)
        counts_c = read_counts()
        c["host_peak_gib"] = rss_c.peak
        c["launches"] = launches(counts_c)
        c["b1_forward_launches"] = b1_forward(counts_c)
        spill_c.reset()
        del spill_c
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc_collect(torch)

    n_groups = a["feeds"][0]["groups"]
    n_feeds = len(chunks)
    n_cols = len({sg.off0 for sg in sgcs})
    rec_a = a["feeds"][0]["spill"]
    rep_a = [f["spill"] for f in a["feeds"][1:]]
    a["recording"] = {
        "forward_and_passes_s": a["feeds"][0]["seconds"],
        "forward_device_s": a["feeds"][0]["generator_device_s"],
        "bytes_gb": rec_a["bytes"] / 1e9, "land_s": rec_a["land_s"],
        "blocked_s": rec_a["blocked_s"]}
    a["replays"] = [{"feed_s": f["seconds"], "bytes_gb": r["bytes"] / 1e9,
                     "read_s": r["read_s"], "blocked_s": r["blocked_s"],
                     "generator_device_s": f["generator_device_s"]}
                    for f, r in zip(a["feeds"][1:], rep_a)]
    for run_rec in (a, b, c):
        run_rec["digests_equal_a"] = run_rec["digests"] == a["digests"]
    out.update(
        stream_gb=stream_bytes / 1e9, n_groups=n_groups,
        a=a, b=b, c=c, counts=counts_a,
        warm_s=None if a_warm is None else a_warm["seconds"],
        host_rss_gib_before=rss0)
    log(f"{config_name} spill: (a) {a['seconds']:.3f} s (feeds "
        f"{[round(f['seconds'], 3) for f in a['feeds']]}), (b) "
        f"{b['seconds']:.3f} s, (c) {c['seconds']:.3f} s; stream "
        f"{stream_bytes / 1e9:.3f} GB in {n_groups} groups; (c) "
        f"{c['spill']['disk_bytes'] / 1e9:.3f} GB on disk; B1 forward "
        f"launches {a['b1_forward_launches']} / {b['b1_forward_launches']} / "
        f"{c['b1_forward_launches']}")
    modes_a = [f["spill"]["mode"] for f in a["feeds"]]
    require(all(np.isfinite(f_rms)), "spill: non-finite facet RMS")
    require(a["max_facet_rms"] <= FACET_RMS,
            f"spill: facet RMS {a['max_facet_rms']:.3e} over {FACET_RMS:.0e}")
    require(not warm or a["rel_rms_to_unpartitioned"] <= FACET_RMS,
            "spill: the partitioned facets differ from the unpartitioned by "
            f"{a.get('rel_rms_to_unpartitioned')}")
    require(not warm or a["bit_identical_to_warm_run"],
            "spill: (a)'s timed and warm runs differ")
    require(b["digests_equal_a"] and c["digests_equal_a"],
            "spill: (a), (b) and (c) are not bit-identical")
    require(modes_a == ["record"] + ["replay"] * (n_feeds - 1),
            f"spill: (a)'s feeds ran {modes_a}")
    require(a["spill"]["fills"] == 1 and not a["spill"]["evictions"]
            and a["spill"]["complete"],
            f"spill: (a)'s cache {a['spill']}")
    require(a["spill"]["ram_reads"] + a["spill"]["disk_reads"]
            == (n_feeds - 1) * n_groups,
            f"spill: (a) read {a['spill']} for {n_feeds} feeds of "
            f"{n_groups} groups")
    require(c["spill"]["disk_bytes"] > 0 and c["spill"]["disk_reads"] > 0
            and c["spill"]["complete"], f"spill: (c)'s cache {c['spill']}")
    if cuda:
        require(a["b1_forward_launches"] == n_cols
                and c["b1_forward_launches"] == n_cols
                and b["b1_forward_launches"] == n_feeds * n_cols,
                f"spill: B1 forward launches (a) {a['b1_forward_launches']}, "
                f"(b) {b['b1_forward_launches']}, (c) "
                f"{c['b1_forward_launches']}")
        missing = [k for k in ("colpass", "fold") if a["launches"][k] == 0]
        require(not missing, f"spill: the path launched {missing} no time")
    del facets_in, tasks
    gc_collect(torch)
    return out


def _replay_with_read_fault(torch, run, spill, digests, device):
    """Phase 11's feed 1 once more from the recording, with one transient
    ``spill.read`` fault injected and the metrics on: the read must be
    retried once (``retry.*`` counters) to the recorded parts' bits."""
    from swiftly_tpu_torch.obs import metrics
    from swiftly_tpu_torch.resilience import FaultPlan, faults

    metrics.disable()
    metrics.reset()
    metrics.enable(device=device)
    plan = FaultPlan([{"site": "spill.read", "kind": "ioerror", "at": 0}])
    try:
        with faults.active(plan):
            r = run(spill, only=[1])
        counters = {k: v for k, v in metrics.export()["counters"].items()
                    if k.startswith("retry.")}
    finally:
        metrics.disable()
        metrics.reset()
    out = {"seconds": r["seconds"], "mode": r["feeds"][0]["spill"]["mode"],
           "parts": len(r["digests"]), "counters": counters,
           "injected": plan.stats()["by_site"],
           "digests_equal": all(r["digests"][p] == digests[p]
                                for p in r["digests"])}
    log(f"spill: a replay feed with one injected spill.read fault: "
        f"{json.dumps(out)}")
    require(out["mode"] == "replay" and out["parts"] > 0
            and out["digests_equal"],
            f"spill: the retried replay feed differs: {out}")
    require(counters.get("retry.attempts") == 1
            and counters.get("retry.attempts.spill.read") == 1
            and counters.get("retry.recovered") == 1,
            f"spill: retry counters {counters}")
    return out


def _spill_line(res):
    """Phase 11's JSON record without the per-shape launch counts and the
    digests."""
    line = {k: v for k, v in res.items() if k not in ("counts", "a", "b",
                                                       "c")}
    for k in ("a", "b", "c"):
        line[k] = {kk: vv for kk, vv in res[k].items() if kk != "digests"}
    return line


# -- phase 12: telemetry, and a kill and resume of the 32k round trip ------

RESUME_COL_GROUP = 10
RESUME_SAVE_GROUPS = 3  # the autosave fires once, after this many groups
RESUME_KILL_FEED = 3  # the 0-based bwd.feed call that is killed
RESUME_WALL_TOL = 0.05
STAGES_WITH_FLOPS = ("fwd.sampled_facet_pass", "fwd.column_pass",
                     "bwd.column_pass", "bwd.sampled_fold")
STAGES_EXPECTED = STAGES_WITH_FLOPS + ("fwd.facet_upload", "fwd.drain",
                                       "bwd.finish", "bwd.drain")


def _spans_nest(events):
    """Problems with a Chrome trace's span tree: every ``X`` span's parent
    exists, and a parent on the same thread covers its child's interval
    (to the export's microsecond rounding)."""
    spans = {e["args"]["span_id"]: e for e in events
             if e.get("ph") == "X" and "span_id" in e.get("args", {})}
    problems = []
    for e in spans.values():
        pid = e["args"]["parent_id"]
        if not pid:
            continue
        par = spans.get(pid)
        if par is None:
            problems.append(f"{e['name']}: parent {pid} missing")
        elif par["tid"] == e["tid"] and not (
                par["ts"] - 1e-3 <= e["ts"]
                and e["ts"] + e["dur"] <= par["ts"] + par["dur"] + 2e-3):
            problems.append(f"{e['name']} outside its parent {par['name']}")
    return problems, len(spans)


def resume_main(torch, phase6=None, config_name=MAIN_CONFIG, fold_group=4,
                col_group=RESUME_COL_GROUP, save_groups=RESUME_SAVE_GROUPS,
                kill_feed=RESUME_KILL_FEED, device="cuda"):
    """Phase 12 (module docstring): the streamed round trip with
    ``StreamedForward(residency="device", col_group=...)`` into
    ``StreamedBackward(residency="sampled", fold_group=...)``: (a) with
    metrics, trace and recorder on, against phase 6's bits and wall time
    (`phase6`: its ``facet_digests`` and ``roundtrip_s``; None: an
    unobserved run here is the reference); (b) killed at the
    `kill_feed`-th ``bwd.feed`` after one autosave at `save_groups`
    groups, then resumed by a fresh forward and backward from the
    snapshot, against the same bits."""
    import os
    import shutil
    import tempfile

    import swiftly_tpu_torch as st
    from swiftly_tpu_torch.obs import metrics, recorder, trace
    from swiftly_tpu_torch.resilience import FaultPlan, WorkerKilled, faults
    from swiftly_tpu_torch.utils import checkpoint, peak_tflops

    cuda = device == "cuda"
    cfg = st.SwiftlyConfig(backend="planar", dtype=torch.float32,
                           device=device, **st.SWIFT_CONFIGS[config_name])
    N = cfg.image_size
    fcs = st.make_full_facet_cover(cfg)
    sgcs = st.make_full_subgrid_cover(cfg)
    F = len(fcs)
    S = len(sgcs) // len({sg.off0 for sg in sgcs})
    n_cols = len(sgcs) // S
    idxs = list(range(0, len(sgcs), max(1, len(sgcs) // MIN_SUBGRID_SAMPLES)))
    t0 = time.perf_counter()
    tasks = list(zip(fcs, [st.make_real_facet(N, fc, sources_for(N))
                           for fc in fcs]))
    out = {"config": config_name, "col_group": col_group,
           "fold_group": fold_group, "facet_setup_s": time.perf_counter() - t0}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def executors():
        fwd = st.StreamedForward(cfg, tasks, residency="device",
                                 col_group=col_group)
        bwd = st.StreamedBackward(cfg, fcs, residency="sampled",
                                  fold_group=fold_group)
        return fwd, bwd

    def digests(facets):
        return [hashlib.sha256(facets[i].cpu().numpy().tobytes()).hexdigest()
                for i in range(F)]

    def round_trip(fwd, bwd, cover):
        """The feed and the finish in a window synchronised at both ends,
        as phase 6 times it."""
        feed = _TimedFeed(torch, fwd, idxs) if cuda else fwd
        sync()
        t = time.perf_counter()
        st.feed_backward_passes(feed, cover, [bwd])
        facets = bwd.finish_device()
        sync()
        return facets, time.perf_counter() - t

    # the same configuration unobserved first: the first run at a new
    # column grouping runs ~10% slower (at 32k on an H100 80GB HBM3 at 700
    # W: 11.0 s, then 9.9 s), so it warms this grouping up for the observed
    # run, and its wall is printed beside it
    facets, plain_s = round_trip(*executors(), sgcs)
    if phase6 is None:
        phase6 = {"facet_digests": digests(facets), "roundtrip_s": plain_s}
    del facets
    gc_collect(torch)

    tmp = tempfile.mkdtemp(prefix="swiftly_resume_smoke_")
    keep_env = os.environ.get("SWIFTLY_CKPT_KEEP")
    os.environ["SWIFTLY_CKPT_KEEP"] = "1"
    try:
        # (a) observability on
        trace_path = os.path.join(tmp, "trace.json")
        for mod in (metrics, trace, recorder):
            mod.disable()
            mod.reset()
        metrics.enable(device=device)
        trace.enable(trace_path, device=device)
        recorder.enable()
        _reset_peak(torch)
        reset_counts()
        facets, wall = round_trip(*executors(), sgcs)
        out["counts"] = read_counts()
        dig_a = digests(facets)
        del facets
        exp = metrics.export()
        peak_a = _peak(torch)
        trace.save(trace_path)
        with open(trace_path) as fh:
            events = json.load(fh)["traceEvents"]
        nest, n_spans = _spans_nest(events)
        trace.disable()
        trace.reset()
        stages = exp["stages"]
        a = {
            "roundtrip_s": wall, "phase6_roundtrip_s": phase6["roundtrip_s"],
            "wall_ratio": wall / phase6["roundtrip_s"],
            "unobserved_roundtrip_s": plain_s,
            "wall_ratio_to_unobserved": wall / plain_s,
            "bits_equal_phase6": dig_a == phase6["facet_digests"],
            # the analytic FLOPs over the synchronised wall: the stages'
            # host walls time launches, not the device
            "wall_tflops": exp["total"]["flops"] / wall / 1e12,
            "stages": {k: {kk: v.get(kk) for kk in (
                "count", "total_s", "flops", "tflops", "mfu_pct")}
                for k, v in stages.items()},
            "total": exp["total"], "peak_tflops": peak_tflops(),
            "counters": {k: v for k, v in exp["counters"].items()},
            "trace_spans": n_spans, "trace_problems": nest[:5],
            "hbm_gauge_peak": exp["gauges_max"].get("hbm.peak_bytes"),
            "max_memory_allocated": peak_a,
        }
        out["a"] = a
        log(f"{config_name} resume (a): observed round trip {wall:.3f} s "
            f"(phase 6 {phase6['roundtrip_s']:.3f} s, ratio "
            f"{a['wall_ratio']:.4f}; unobserved at col_group {col_group} "
            f"{plain_s:.3f} s), {a['wall_tflops']:.2f} TFLOP/s over the "
            f"wall, bits equal phase 6: "
            f"{a['bits_equal_phase6']}, {n_spans} spans, HBM gauge "
            f"{a['hbm_gauge_peak']} vs {peak_a}; total "
            f"{json.dumps(exp['total'])}")
        log("  stages: " + json.dumps(a["stages"]))
        missing = [k for k in STAGES_EXPECTED if k not in stages]
        require(a["bits_equal_phase6"], "resume (a): the observed round "
                "trip's facets differ from phase 6's")
        require(not missing, f"resume (a): stages {missing} missing")
        require(all(stages[k].get("flops", 0) > 0 for k in STAGES_WITH_FLOPS),
                "resume (a): a compute stage carries no FLOPs")
        require(exp["counters"].get("fwd.subgrids") == len(sgcs)
                and exp["counters"].get("bwd.subgrids_folded") == len(sgcs),
                f"resume (a): counters {exp['counters']}")
        require(not nest and n_spans > 0,
                f"resume (a): the trace's spans do not nest: {nest[:5]}")
        if cuda:
            require(abs(a["wall_ratio"] - 1) <= RESUME_WALL_TOL,
                    f"resume (a): wall {wall:.3f} s against phase 6's "
                    f"{phase6['roundtrip_s']:.3f} s")
            require(a["peak_tflops"] and "mfu_pct" in exp["total"],
                    f"resume (a): no MFU ({exp['total']})")
            require(a["hbm_gauge_peak"] == peak_a,
                    f"resume (a): HBM gauge {a['hbm_gauge_peak']} != "
                    f"max_memory_allocated {peak_a}")
        gc_collect(torch)

        # (b) kill after one autosave, then resume
        ck = os.path.join(tmp, "bwd.npz")
        metrics.reset()
        recorder.reset()
        base_alloc = torch.cuda.memory_allocated() if cuda else 0
        _reset_peak(torch)
        plan = FaultPlan([{"site": "bwd.feed", "kind": "kill",
                           "at": kill_feed}])

        def killed_run():
            fwd, bwd = executors()
            bwd.enable_autosave(ck, every_subgrids=save_groups * col_group * S)
            t = time.perf_counter()
            try:
                with faults.active(plan):
                    st.feed_backward_passes(fwd, sgcs, [bwd])
            except WorkerKilled as exc:
                return str(exc), time.perf_counter() - t
            raise AssertionError("the planned kill did not fire")

        kill_msg, killed_s = killed_run()
        pm = recorder.post_mortem("WorkerKilled", reason=kill_msg)
        gc_collect(torch)
        after_kill = torch.cuda.memory_allocated() if cuda else 0
        saves = metrics.export()["stages"].get("ckpt.save", {})
        snap_bytes = os.path.getsize(ck)
        gens = checkpoint.checkpoint_generations(ck)
        reset_counts()
        fwd, bwd = executors()
        sync()
        t = time.perf_counter()
        processed = set(checkpoint.restore_streamed_backward_state(ck, bwd))
        sync()
        restore_s = time.perf_counter() - t
        pending = [o for o, _ in bwd._pending_rows]
        rest = [sg for sg in sgcs if (sg.off0, sg.off1) not in processed]
        counts_before = read_counts()
        reset_counts()
        facets, resumed_s = round_trip(fwd, bwd, rest)
        counts = read_counts()
        dig_b = digests(facets)
        del facets, fwd, bwd
        peak_b = _peak(torch)
        b1_fwd = sum(v for key, v in counts["colpass"][1].items() if key[-1])
        rest_cols = len({sg.off0 for sg in rest})
        b = {
            "kill": kill_msg, "killed_run_s": killed_s,
            "snapshot_gb": snap_bytes / 1e9, "generations": len(gens),
            "save_s": saves.get("total_s"), "saves": saves.get("count"),
            "restore_s": restore_s, "processed": len(processed),
            "pending_columns": len(pending), "resumed_columns": rest_cols,
            "resumed_s": resumed_s, "peak_device_gib": peak_b / 2**30,
            "allocated_before_gib": base_alloc / 2**30,
            "allocated_after_kill_gib": after_kill / 2**30,
            "b1_forward_launches": b1_fwd,
            "launches": {k: v[0] for k, v in counts.items()},
            "restore_launches": {k: v[0] for k, v in counts_before.items()},
            "bits_equal_phase6": dig_b == phase6["facet_digests"],
            "post_mortem": {k: pm[k] for k in ("trigger", "reason",
                                               "n_events", "by_kind")},
        }
        out["b"] = b
        log(f"{config_name} resume (b): {json.dumps(b)}")
        named = any(e["kind"] == "fault" and "bwd.feed" in e["name"]
                    and "kill" in str(e["detail"]) for e in pm["events"])
        want_cols = n_cols - save_groups * col_group
        want_pending = (save_groups * col_group) % fold_group
        require(b["bits_equal_phase6"], "resume (b): the resumed facets "
                "differ from phase 6's")
        require(b["saves"] == 1 and len(gens) == 1,
                f"resume (b): {b['saves']} autosaves, generations {gens}")
        require(len(processed) == save_groups * col_group * S,
                f"resume (b): the snapshot holds {len(processed)} subgrids")
        require(len(pending) == want_pending,
                f"resume (b): {len(pending)} pending columns, not "
                f"{want_pending}")
        require(rest_cols == want_cols, f"resume (b): {rest_cols} columns "
                f"left, not {want_cols}")
        require(named, "resume (b): the post-mortem does not name the kill")
        if cuda:
            require(b1_fwd == want_cols, f"resume (b): the resumed forward "
                    f"launched B1 {b1_fwd} times, not {want_cols}")
            require(after_kill <= base_alloc + 64 * 2**20,
                    f"resume (b): {after_kill / 2**30:.3f} GiB still allocated"
                    f" after the kill ({base_alloc / 2**30:.3f} before)")
    finally:
        faults.uninstall()
        for mod in (metrics, trace, recorder):
            mod.disable()
            mod.reset()
        if keep_env is None:
            os.environ.pop("SWIFTLY_CKPT_KEEP", None)
        else:
            os.environ["SWIFTLY_CKPT_KEEP"] = keep_env
        shutil.rmtree(tmp, ignore_errors=True)
    out["snapshot_files_left"] = os.path.exists(tmp)
    require(not out["snapshot_files_left"], "resume: files left behind")
    gc_collect(torch)
    return out


def _resume_line(res):
    """Phase 12's JSON record without the per-shape launch counts."""
    return {k: v for k, v in res.items() if k != "counts"}


# -- phase 9: the 128k streamed round trip ---------------------------------


PLAN_RATIO_BAND = (0.8, 1.25)  # a calibrated leg's predicted / measured
PLAN_MISPRICED = 2.0  # a calibrated stage's predicted / measured, either way
TRACE_ATTRIBUTION_TOL = 0.05  # self times against the leg wall
PLAN_LEG = "leg.roundtrip"


def copy_rates(torch, nbytes=1 << 30, reps=3):
    """GB/s of the copies the cost model's byte stages price, best of
    `reps` on `nbytes`: pinned host to card (``spill.h2d``), card to pinned
    host (``spill.write``'s copy), and a host memcpy between pageable and
    pinned memory (``spill.read``, ``cache.l1``)."""
    n = nbytes // 4
    dev = torch.empty(n, dtype=torch.float32, device="cuda")
    pinned = torch.empty(n, dtype=torch.float32, pin_memory=True)
    host = torch.ones(n, dtype=torch.float32)

    def best(fn, sync):
        times = []
        for _ in range(reps):
            if sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            if sync:
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return nbytes / min(times) / 1e9

    out = {"bytes": nbytes,
           "h2d_pinned_gbps": best(lambda: dev.copy_(pinned, non_blocking=True),
                                   True),
           "d2h_pinned_gbps": best(lambda: pinned.copy_(dev, non_blocking=True),
                                   True),
           "host_memcpy_gbps": best(lambda: pinned.copy_(host), False)}
    del dev, pinned, host
    return out


def _stage_ratios(acc):
    return {name: e.get("ratio") for name, e in acc["stages"].items()}


def _plan_summary(p):
    """What a compiled plan decided, for the JSON line and the log."""
    return {"coeffs_source": p.coeffs_source,
            "backward": p.backward.as_dict(), "spill_mode": p.spill.mode,
            "forward": {k: v for k, v in p.forward.items()
                        if k != "colpass_candidates"},
            "predicted_wall_s": p.predicted["wall_s"],
            "hbm_peak_gb": p.predicted["hbm_peak_bytes"] / 1e9,
            "fwd_min_gb": p.predicted["fwd_min_bytes"] / 1e9,
            "reserve_gb": p.predicted["reserve_bytes"] / 1e9,
            "stages": {k: v["wall_s"]
                       for k, v in p.predicted["stages"].items()}}


def plan_main(torch, phase6=None, config_name=MAIN_CONFIG, fold_group=4,
              device="cuda"):
    """Phase 13: the plan compiler and its calibration loop on the card,
    at `config_name`, planar f32, on phase 6's path (module docstring):
    (a) ``compile_plan`` with the card's default coefficients, against the
    executor's own choice; (b) two observed round trips to that plan,
    each stamped, manifested, reconciled and appended to a calibration
    history in a temporary file; (c) ``refit_from_ledger`` on that
    history, a recompiled plan and a third observed round trip held to
    the calibrated prediction; (d) the trace of (c) summarised from the
    leg's span; (e) the 128k round trip's plan with both coefficient
    sets, not run. `phase6`: its ``facet_digests`` (None: the first run
    here is the reference)."""
    import os
    import shutil
    import tempfile

    import swiftly_tpu_torch as st
    from swiftly_tpu_torch import plan
    from swiftly_tpu_torch.obs import (
        ledger,
        metrics,
        recorder,
        report,
        run_manifest,
        trace,
        validate_artifact,
        validate_plan_accuracy_artifact,
        validate_trace_artifact,
    )

    cuda = device == "cuda"
    cfg = st.SwiftlyConfig(backend="planar", dtype=torch.float32,
                           device=device, **st.SWIFT_CONFIGS[config_name])
    N = cfg.image_size
    fcs = st.make_full_facet_cover(cfg)
    sgcs = st.make_full_subgrid_cover(cfg)
    F, yB = len(fcs), fcs[0].size
    sources = sources_for(N)
    t0 = time.perf_counter()
    facets_in = [st.make_real_facet(N, fc, sources) for fc in fcs]
    tasks = list(zip(fcs, facets_in))
    out = {"config": config_name, "facet_setup_s": time.perf_counter() - t0}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def digests(facets):
        return [hashlib.sha256(facets[i].cpu().numpy().tobytes()).hexdigest()
                for i in range(F)]

    def facet_rms(facets):
        return max(_facet_rms(torch, facets[i],
                              torch.as_tensor(facets_in[i],
                                              device=facets.device))
                   for i in range(F))

    def round_trip(p):
        """One round trip to plan `p` (one pass: every facet, every row),
        in a window synchronised at both ends and traced as the leg's
        span; the facets, the wall and what the forward chose."""
        (i0, i1, r0, r1), = p.backward.parts
        fwd = st.StreamedForward(cfg, tasks, residency="device")
        fwd.hbm_headroom = p.forward["hbm_headroom"]
        slab = None if (r0, r1) == (0, yB) else (r0, r1)
        bwd = st.StreamedBackward(cfg, fcs[i0:i1], residency="sampled",
                                  fold_group=p.backward.fold_group,
                                  row_slab=slab)
        sync()
        with trace.span(PLAN_LEG, cat="bench", config=config_name):
            t = time.perf_counter()
            st.feed_backward_passes(fwd, sgcs, [bwd])
            facets = bwd.finish_device()
            sync()
            wall = time.perf_counter() - t
        return facets, wall, dict(fwd.last_plan)

    def observed(p, history, manifest_params):
        """A round trip to `p` with metrics and trace on; the stamped plan
        block, the manifest, the plan-accuracy block (appended to
        `history`) and the trace."""
        for mod in (metrics, trace, recorder):
            mod.disable()
            mod.reset()
        metrics.enable(device=device)
        trace.enable(device=device)
        facets, wall, executed = round_trip(p)
        exp = metrics.export()
        exported = trace.export()
        metrics.disable()
        trace.disable()
        block = plan.stamp_measured_wall(p.artifact_block(), wall)
        manifest = run_manifest(params=manifest_params)
        acc = ledger.plan_accuracy_block(block, exp, manifest)
        record = {"metric": f"{config_name} round trip wall", "value": wall,
                  "unit": "s", "manifest": manifest, "plan_compiled": block,
                  "telemetry": exp, "plan_accuracy": acc}
        problems = (validate_artifact(record, require_baseline=False)
                    + validate_plan_accuracy_artifact(record))
        require(not problems, f"phase 13: invalid artifact: {problems}")
        unmapped = ledger.unmapped_stage_names(exp["stages"])
        require(not unmapped, f"phase 13: stages outside the ledger: "
                              f"{unmapped}")
        ledger.append_history(acc, history)
        return facets, wall, executed, block, acc, exported, manifest

    tmp = tempfile.mkdtemp(prefix="swiftly_plan_smoke_")
    history = os.path.join(tmp, "calibration.jsonl")
    keep_env = os.environ.get("SWIFTLY_CALIBRATION_HISTORY")
    os.environ["SWIFTLY_CALIBRATION_HISTORY"] = history
    try:
        # (a) the default-coefficient plan against the executor's choice
        budget = plan.hbm_budget_bytes(device=device)
        inputs = plan.PlanInputs.from_cover(
            cfg, fcs, sgcs, hbm_budget=budget, real_facets=True,
            fold_group=fold_group, config_name=config_name)
        p0 = plan.compile_plan(inputs)
        out["budget_gb"] = None if budget is None else budget / 1e9
        out["default_plan"] = _plan_summary(p0)
        log(f"{config_name} plan (default coefficients): "
            f"{json.dumps(out['default_plan'])}")
        require(p0.coeffs_source == "default",
                f"phase 13: the plan's coefficients are {p0.coeffs_source}")
        require(p0.backward.fold_group == fold_group,
                f"phase 13: the default plan moved the seed fold group "
                f"{fold_group} to {p0.backward.fold_group}")
        require(p0.backward.n_passes == 1,
                f"phase 13: {p0.backward.n_passes} passes at "
                f"{config_name}; this phase runs one")

        # (b) two observed round trips to it, each reconciled and recorded
        params = {"config": config_name, "mode": "roundtrip-streamed",
                  "dtype": "float32", "fold_group": fold_group}
        runs = []
        want = None if phase6 is None else phase6["facet_digests"]
        for k in range(2):
            facets, wall, executed, block, acc, _, manifest = observed(
                p0, history, params)
            dig = digests(facets)
            del facets
            want = dig if want is None else want
            run = {"wall_s": wall, "executed_forward": executed,
                   "predicted_vs_measured": block["predicted_vs_measured"],
                   "coverage": acc["coverage"], "uncovered": acc["uncovered"],
                   "stage_ratios": _stage_ratios(acc),
                   "bits_equal_phase6": dig == want}
            runs.append(run)
            log(f"{config_name} plan run {k}: wall {wall:.3f} s, predicted / "
                f"measured {block['predicted_vs_measured']}, coverage "
                f"{acc['coverage']}, uncovered {acc['uncovered']}, stages "
                f"{json.dumps(run['stage_ratios'])}, forward {executed}")
            require(run["bits_equal_phase6"],
                    f"phase 13 run {k}: the facets differ from phase 6's")
            require(executed["mode"] == p0.forward["mode"]
                    and executed["col_group"] == p0.forward["col_group"],
                    f"phase 13: planned forward {p0.forward['mode']} "
                    f"G {p0.forward['col_group']}, executed {executed}")
            gc_collect(torch)
        out["runs"] = runs
        out["manifest_device"] = manifest["device"]

        # (c) refit from the ledger, recompile, and run to the new plan
        entries = ledger.load_calibration_history(history)
        ready = plan.ledger_readiness(entries)
        out["readiness"] = {
            "ready": ready["ready"], "platform": ready["platform"],
            "n_records": ready["n_records"], "reasons": ready["reasons"],
            "stages": {k: {"n": v["n"], "rel_spread": v["rel_spread"],
                           "ready": v["ready"]}
                       for k, v in ready["stages"].items()}}
        require(ready["ready"]
                and ready["platform"] == ("gpu" if cuda else "cpu"),
                f"phase 13: the ledger is not ready: {out['readiness']}")
        coeffs = plan.refit_from_ledger(entries)
        require(coeffs.source == "ledger",
                f"phase 13: refit_from_ledger gave {coeffs.source}")
        out["ledger_rates"] = {**coeffs.flops_per_s, **coeffs.bytes_per_s}
        p1 = plan.compile_plan(inputs, coeffs=coeffs)
        out["calibrated_plan"] = _plan_summary(p1)
        same = (p1.backward.fold_group == fold_group
                and p1.backward.parts == p0.backward.parts)
        gate = "phase 6's facet SHA-256" if same else "the oracle's facet RMS"
        out["calibrated_gate"] = gate
        log(f"{config_name} plan (ledger coefficients, {coeffs.n_records} "
            f"records): {json.dumps(out['calibrated_plan'])}; held to {gate}")
        require(p1.backward.n_passes == 1,
                f"phase 13: the calibrated plan has {p1.backward.n_passes} "
                "passes")
        _reset_peak(torch)
        reset_counts()
        facets, wall, executed, block, acc, exported, _ = observed(
            p1, history, params)
        out["counts"] = read_counts()
        out["launches"] = {k: v[0] for k, v in out["counts"].items()}
        if same:
            ok = digests(facets) == want
        else:
            rms = facet_rms(facets)
            out["calibrated_facet_rms"] = rms
            ok = rms <= FACET_RMS
        del facets
        bad = ledger.record_mispricing(acc, threshold=PLAN_MISPRICED)
        ratio = block["predicted_vs_measured"]
        out["calibrated_run"] = {
            "wall_s": wall, "predicted_wall_s": block["predicted"]["wall_s"],
            "predicted_vs_measured": ratio, "coverage": acc["coverage"],
            "uncovered": acc["uncovered"], "stage_ratios": _stage_ratios(acc),
            "mispriced": [name for name, _ in bad], "gate_met": ok,
            "executed_forward": executed}
        log(f"{config_name} calibrated run: wall {wall:.3f} s, predicted "
            f"{block['predicted']['wall_s']} s, predicted / measured {ratio}, "
            f"stages {json.dumps(out['calibrated_run']['stage_ratios'])}, "
            f"mispriced {out['calibrated_run']['mispriced']}")
        require(ok, f"phase 13: the calibrated run fails {gate}")
        require(PLAN_RATIO_BAND[0] <= ratio <= PLAN_RATIO_BAND[1],
                f"phase 13: the calibrated leg's predicted / measured "
                f"{ratio} is outside {PLAN_RATIO_BAND}")
        require(not bad, f"phase 13: mispriced stages {bad}")
        missing = [k for k in ("cmatmul", "colpass", "fold")
                   if out["launches"][k] == 0]
        require(not cuda or not missing,
                f"phase 13 launched {missing} no time")

        # (d) the trace of (c), attributed from the leg's span
        spans = report.build_tree(exported)
        leg = [sid for sid, sp in spans.items() if sp["name"] == PLAN_LEG]
        require(len(leg) == 1, f"phase 13: {len(leg)} leg spans")
        summary = report.summarize_trace(exported, root_id=leg[0])
        attributed = summary["attributed_s"]
        out["trace"] = {"span_count": summary["span_count"],
                        "wall_s": summary["wall_s"],
                        "attributed_s": attributed, "leg_wall_s": wall,
                        "critical_path": [c["name"] for c in
                                          summary["critical_path"]],
                        "top": [(t["name"], t["self_s"])
                                for t in summary["top"]]}
        log(f"{config_name} trace of the calibrated run: "
            f"{json.dumps(out['trace'])}")
        problems = validate_trace_artifact({"trace": summary})
        require(not problems, f"phase 13: trace block: {problems}")
        require(abs(attributed - wall) <= TRACE_ATTRIBUTION_TOL * wall,
                f"phase 13: self times {attributed:.3f} s against the leg's "
                f"{wall:.3f} s")

        # (e) the 128k round trip's plan on this card, not run
        big = plan.PlanInputs.from_config(
            BIG_CONFIG, hbm_budget=budget, real_facets=True,
            sparse_facets=True, fold_group=fold_group)
        out["plan_128k"] = {}
        for name, c in (("default", None), ("ledger", coeffs)):
            pb = plan.compile_plan(big, coeffs=c)
            out["plan_128k"][name] = _plan_summary(pb)
            log(f"{BIG_CONFIG} plan ({name} coefficients), not run: "
                f"{pb.backward.n_passes} passes, {pb.backward.n_feeds} "
                f"feeds of {pb.backward.feed_group}, spill "
                f"{pb.spill.mode}, predicted {pb.predicted['wall_s']} s, "
                f"peak {pb.predicted['hbm_peak_bytes'] / 1e9:.3f} GB")
        if cuda:
            out["rates"] = copy_rates(torch)
            log(f"copy rates: {json.dumps(out['rates'])}")
    finally:
        for mod in (metrics, trace, recorder):
            mod.disable()
            mod.reset()
        if keep_env is None:
            os.environ.pop("SWIFTLY_CALIBRATION_HISTORY", None)
        else:
            os.environ["SWIFTLY_CALIBRATION_HISTORY"] = keep_env
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _plan_line(res):
    """Phase 13's JSON record: every key but the per-shape launch counts
    (the `kernels` line's ``paths`` holds them)."""
    return {k: v for k, v in res.items() if k != "counts"}


# -- phase 14: incremental facet updates and the serving fleet at 32k --------

# the engine records the stream in groups of 10 columns (8 entries of ~1.2
# GB at 32k): an out-of-place patch doubles one entry at a time
DELTA_COL_GROUP = 10
# K = 1: facet a scaled; K = 3: facets a, b, c scaled again (the first three
# facets holding a source)
DELTA_SCALES_K1 = (1.75,)
DELTA_SCALES_K3 = (0.6, 1.3, 2.1)
# the f32 sum-reorder bound of a patched stream against a fresh one, over
# the stream's largest value (tests/test_delta.py:73)
DELTA_REL_TOL = 1e-4
# a computed row against the recorded stream's (another program: the
# fused column pass against the sampled one), relative L2
FLEET_COMPUTE_REL = 1e-5
FLEET_REQUESTS = 4096
FLEET_CLIENTS = 4
FLEET_REPLICAS = 2
# the traffic's segments: before the update, while it runs, after the kill,
# after the restore (fractions of FLEET_REQUESTS, cumulative)
FLEET_SEGMENTS = (0.25, 0.625, 0.8125, 1.0)
# pacing per client and request while the update runs, so that traffic
# spans its patch window; after the restore, one request a client at a
# time, the last segment spread over FLEET_RESTORE_SPAN_S until the
# victim's breaker closes (its reopen delay is 0.25-0.5 s after the trip)
FLEET_UPDATE_PACE_S = 0.02
FLEET_RESTORE_SPAN_S = 1.5
# requests of the kill segment done before the kill: the victim then holds
# work in flight
FLEET_KILL_AFTER = 64
FLEET_SEED = 1414


def _mutate_sparse(tasks, idxs, scales):
    """`tasks` with the sparse facets `idxs` scaled by `scales`."""
    from swiftly_tpu_torch.ops.oracle import SparseRealFacet

    out = list(tasks)
    for j, s in zip(idxs, scales):
        fc, f = out[j]
        out[j] = (fc, SparseRealFacet(f.size, f.rows, f.cols,
                                      f.vals * np.float32(s)))
    return out


def _stream_digest(spill):
    """SHA-256 over the entries' SHA-256 (hex, in order), the entries hashed
    in parallel: the recorded stream's bytes, in one digest."""
    import concurrent.futures

    def one(k):
        return hashlib.sha256(memoryview(
            np.ascontiguousarray(spill.get(k))).cast("B")).hexdigest()

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        digests = list(pool.map(one, range(len(spill))))
    return hashlib.sha256("".join(digests).encode()).hexdigest()


def _stream_diff(torch, spill, ref):
    """(max |spill - ref|, max |ref|) over two recordings of one cover,
    entry by entry (host, torch's threads)."""
    require(len(spill) == len(ref), "the streams have different entries")
    mx = sc = 0.0
    buf = torch.empty(1 << 26, dtype=torch.float32)
    for k in range(len(spill)):
        require([[i for i, _ in col] for col in spill.meta(k)]
                == [[i for i, _ in col] for col in ref.meta(k)],
                f"entry {k} holds other subgrids than the reference's")
        a = torch.from_numpy(np.asarray(spill.get(k))).reshape(-1)
        b = torch.from_numpy(np.asarray(ref.get(k))).reshape(-1)
        for i in range(0, a.numel(), 1 << 26):  # 256 MB of f32 a chunk
            a_i, b_i = a[i:i + (1 << 26)], b[i:i + (1 << 26)]
            tmp = torch.sub(a_i, b_i, out=buf[:a_i.numel()])
            mx = max(mx, float(tmp.abs_().max()))
            sc = max(sc, float(b_i.abs().max()))
    return mx, sc


def _rel_l2(a, b):
    d = np.linalg.norm((np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).ravel())
    return d / max(np.linalg.norm(np.asarray(b, np.float64).ravel()), 1e-300)


def _quantile_ms(lat, q):
    lat = sorted(lat)
    return (lat[min(len(lat) - 1, int(q * len(lat)))] * 1e3) if lat else 0.0


def _fleet_traffic(sgcs, n, seed):
    """`n` zipf-over-columns subgrid requests (shuffled popularity, p ~
    1/rank^VIS_ZIPF_S, a uniform subgrid of the column), priorities 0 and
    1: [(config, priority)]."""
    rng = np.random.default_rng(seed)
    cols = sorted({sg.off0 for sg in sgcs})
    by_col = {c: [sg for sg in sgcs if sg.off0 == c] for c in cols}
    ranks = np.empty(len(cols), dtype=int)
    ranks[rng.permutation(len(cols))] = np.arange(len(cols))
    p = 1.0 / (ranks + 1.0) ** VIS_ZIPF_S
    p /= p.sum()
    out = []
    for c, prio in zip(rng.choice(len(cols), size=n, p=p),
                       rng.integers(0, 2, size=n)):
        col = by_col[cols[c]]
        out.append((col[rng.integers(len(col))], int(prio)))
    return out


class _FleetClients:
    """`FLEET_CLIENTS` closed-loop client threads over one request list:
    each takes the next request, submits it to the fleet and waits for its
    result before the next. A request is taken only below the gate
    ``allowed`` (the caller moves it); ``epoch`` (the caller's state when a
    request is submitted) and the submit time are kept with the handle."""

    def __init__(self, fleet, work, n_clients=FLEET_CLIENTS):
        import threading

        self.fleet, self.work = fleet, work
        self.cond = threading.Condition()
        self.allowed = 0
        self.next = 0
        self.done = 0
        self.epoch = "before"
        self.pace_s = 0.0
        self.closed = False
        self.tracked = [None] * len(work)
        self.errors = []
        self.threads = [threading.Thread(target=self._run, daemon=True,
                                         name=f"fleet-client-{i}")
                        for i in range(n_clients)]
        for t in self.threads:
            t.start()

    def _run(self):
        while True:
            with self.cond:
                while (not self.closed and self.next >= self.allowed
                       and self.next < len(self.work)):
                    self.cond.wait()
                if self.closed or self.next >= len(self.work):
                    return
                i = self.next
                self.next += 1
                epoch, pace = self.epoch, self.pace_s
            sg, prio = self.work[i]
            try:
                t0 = time.perf_counter()
                freq = self.fleet.submit(sg, priority=prio)
                freq.wait(timeout=600.0)
                self.tracked[i] = (sg, freq, epoch, t0)
            except Exception as exc:  # noqa: BLE001 - reported as a failure
                self.errors.append(f"request {i}: {exc!r}")
            with self.cond:
                self.done += 1
                self.cond.notify_all()
            if pace:
                time.sleep(pace)

    def release(self, upto, epoch=None, pace_s=None):
        with self.cond:
            self.allowed = upto
            if epoch is not None:
                self.epoch = epoch
            if pace_s is not None:
                self.pace_s = pace_s
            self.cond.notify_all()

    def wait_done(self, upto, timeout=600.0):
        deadline = time.monotonic() + timeout
        with self.cond:
            while self.done < upto:
                left = deadline - time.monotonic()
                require(left > 0, f"fleet clients: {self.done} of {upto} "
                                  "requests done before the timeout")
                self.cond.wait(timeout=min(left, 1.0))

    def close(self):
        """No request is taken any more; the threads end once their
        requests in flight are done."""
        with self.cond:
            self.closed = True
            self.cond.notify_all()
        for t in self.threads:
            t.join(timeout=600.0)


def delta_main(torch, config_name=MAIN_CONFIG, device="cuda", fold_group=4,
               col_group=DELTA_COL_GROUP, n_requests=FLEET_REQUESTS,
               n_vis=VIS_SAMPLES // VIS_BATCHES):
    """Phase 14: incremental facet updates and the serving fleet at
    `config_name`, planar f32, from sparse facets of the grid-corrected sky
    model (module docstring): (a) ``IncrementalForward.record``; (b) K = 1
    and K = 3 patches against fresh streams, then an exact update against
    a fresh stream's SHA-256; (c) the backward fed from the patched
    recording against the one fed from the fresh stream and the facets
    themselves; (d) a ``ServeFleet`` of `FLEET_REPLICAS` ``SubgridService``
    replicas over the engine's fabric, `n_requests` zipf requests from
    `FLEET_CLIENTS` client threads, a facet update, a kill and a restore
    midway; (e) `n_vis` samples of phase 8's traffic served through
    ``FleetRowSource``."""
    import swiftly_tpu_torch as st
    from swiftly_tpu_torch import plan
    from swiftly_tpu_torch import vis as sv
    from swiftly_tpu_torch.obs import (
        run_manifest,
        validate_delta_artifact,
        validate_fleet_artifact,
        validate_serve_artifact,
    )
    from swiftly_tpu_torch.parallel.streamed import CachedColumnFeed
    from swiftly_tpu_torch.serve import AdmissionQueue, CoalescingScheduler
    from swiftly_tpu_torch.utils.spill import SpillCache

    cuda = device == "cuda"
    t_phase = time.perf_counter()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30 if cuda else None

    def mark(step):
        p = peak_gib()
        log(f"  [delta: {step} at {time.perf_counter() - t_phase:.1f} s"
            + ("" if p is None else f", device peak {p:.2f} GiB") + "]")

    cfg = st.SwiftlyConfig(backend="planar", dtype=torch.float32,
                           device=device, **st.SWIFT_CONFIGS[config_name])
    N = cfg.image_size
    kernel = sv.vis_kernel()
    raw = vis_sources(N, kernel)
    corrected = kernel.correct_sources(raw, N)
    fcs = st.make_full_facet_cover(cfg)
    sgcs = st.make_full_subgrid_cover(cfg)
    S0 = [(fc, st.make_sparse_facet(N, fc, corrected)) for fc in fcs]
    content = [j for j, (_, f) in enumerate(S0) if np.count_nonzero(f.vals)]
    require(len(content) >= 3, f"only {len(content)} facets hold a source")
    a, b, c = content[:3]
    S1 = _mutate_sparse(S0, [a], DELTA_SCALES_K1)
    S3 = _mutate_sparse(S1, [a, b, c], DELTA_SCALES_K3)
    params = {"config": config_name, **st.SWIFT_CONFIGS[config_name]}
    inputs = plan.PlanInputs.from_cover(cfg, fcs, sgcs)
    out = {"config": config_name, "col_group": col_group,
           "changed": {"k1": [a], "k3": [a, b, c]}}
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    # -- the delta path: (a) record, (b) patches, (c) backward, exact ------
    reset_counts()
    engine = st.IncrementalForward(cfg, S0, SpillCache(), col_group=col_group)
    sync()
    t0 = time.perf_counter()
    rec = engine.record(sgcs)
    sync()
    out["record_s"] = time.perf_counter() - t0
    out["entries"] = rec["entries"]
    out["stream_gb"] = engine.spill.stats()["ram_bytes"] / 1e9
    out["record_peak_gib"] = peak_gib()
    log(f"{config_name} delta: recorded {out['entries']} entries, "
        f"{out['stream_gb']:.3f} GB, in {out['record_s']:.3f} s")
    mark("(a) recorded")

    def fresh_stream(tasks):
        ref = SpillCache()
        fwd = st.StreamedForward(cfg, tasks, residency="device",
                                 col_group=col_group)
        for _ in fwd.stream_column_groups(sgcs, spill=ref):
            pass
        require(ref.complete, "the fresh stream did not fit its cache")
        return ref, fwd

    legs = {}
    fresh3 = fwd3 = None
    for key, tasks, K in (("k1", S1, 1), ("k3", S3, 3)):
        sync()
        t0 = time.perf_counter()
        rep = engine.update(tasks, use_plan=False)
        sync()
        wall = time.perf_counter() - t0
        require(rep["mode"] == "patch",
                f"K={K} update took {rep['mode']} ({rep['reason']})")
        require(engine.ledger.version == engine.spill.stream_version
                == rep["stream_version"],
                f"K={K}: ledger version {engine.ledger.version}, cache "
                f"{engine.spill.stream_version}")
        require(len(rep["changed_facets"]) == K,
                f"K={K} update changed {rep['changed_facets']}")
        t1 = time.perf_counter()
        fresh, ffwd = fresh_stream(engine.facet_tasks)
        fresh_s = time.perf_counter() - t1
        mx, sc = _stream_diff(torch, engine.spill, fresh)
        priced = plan.plan_delta(inputs, K).as_dict()
        legs[key] = {
            "k": K, "changed_facets": rep["changed_facets"],
            "patched_columns": rep["patched_columns"],
            "patched_entries": rep["patched_entries"],
            "update_s": wall, **rep["timings"],
            "full_record_s": out["record_s"],
            "speedup_vs_full": out["record_s"] / wall,
            "fresh_stream_s": fresh_s,
            "match": {"max_abs_diff": mx, "scale": sc,
                      "tolerance": DELTA_REL_TOL * sc,
                      "within_tolerance": bool(mx <= DELTA_REL_TOL * sc)},
            "plan": {"mode": priced["mode"],
                     "predicted_wall_s": priced["predicted_wall_s"],
                     "full_wall_s": priced["full_wall_s"],
                     "break_even_k": priced["break_even_k"]},
            "stream_version": rep["stream_version"],
        }
        log(f"{config_name} delta K={K}: patch {wall:.3f} s (delta pass "
            f"{rep['timings']['delta_s']:.3f} s: B1 and its facet pass "
            f"{rep['timings']['compute_s']:.3f}, d2h "
            f"{rep['timings']['d2h_s']:.3f}, route "
            f"{rep['timings']['route_s']:.3f}; patch "
            f"{rep['timings']['patch_s']:.3f} s) against the full re-record's "
            f"{out['record_s']:.3f} s: x{out['record_s'] / wall:.2f}; "
            f"plan_delta {priced['mode']} predicted "
            f"{priced['predicted_wall_s']:.3f} s (full "
            f"{priced['full_wall_s']:.3f} s); max |patched - fresh| "
            f"{mx:.3e} of {sc:.3e} ({mx / sc:.2e})")
        require(mx <= DELTA_REL_TOL * sc,
                f"K={K}: the patched stream is {mx / sc:.2e} off the fresh "
                f"one (bound {DELTA_REL_TOL})")
        if key == "k1":
            legs[key]["fresh_digest"] = _stream_digest(fresh)
            fresh.reset()
            del fresh, ffwd
        else:
            fresh3, fwd3 = fresh, ffwd
        mark(f"(b) K={K} patched and held to a fresh stream")

    # (c) one imaging cycle after the update: the backward fed from the
    # patched recording against the same backward fed from the fresh one
    def backward(fwd, spill):
        bwd = st.StreamedBackward(cfg, fcs, residency="sampled",
                                  fold_group=fold_group)
        sync()
        t0 = time.perf_counter()
        st.feed_backward_passes(fwd, sgcs, [bwd], spill=spill)
        facets = bwd.finish_device()
        sync()
        return facets, time.perf_counter() - t0, fwd.last_spill

    fp, out["backward_patched_s"], sp_p = backward(engine.fwd, engine.spill)
    ff, out["backward_fresh_s"], sp_f = backward(fwd3, fresh3)
    require((sp_p or {}).get("mode") == "replay"
            and (sp_f or {}).get("mode") == "replay",
            f"the backwards were not fed from the recordings: {sp_p}, {sp_f}")
    d2 = scale = 0.0
    for i in range(len(fcs)):  # RMS over the largest value, facet by facet
        a_i, b_i = fp[i].double(), ff[i].double()
        d2 += float((a_i - b_i).pow(2).sum(-1).mean())
        scale = max(scale, float(b_i.pow(2).sum(-1).max().sqrt()))
        del a_i, b_i
    out["backward_rel_rms"] = (d2 / len(fcs)) ** 0.5 / scale
    f_rms = [_facet_rms(torch, fp[i], engine.fwd.synth_facet_device(i))
             for i in range(len(fcs))]
    out["backward_max_facet_rms"] = max(f_rms)
    counts_c = read_counts()
    log(f"{config_name} delta (c): backward from the patched recording "
        f"{out['backward_patched_s']:.3f} s, from the fresh one "
        f"{out['backward_fresh_s']:.3f} s; rel RMS between them "
        f"{out['backward_rel_rms']:.3e} (bound {FACET_RMS:.0e}), max facet "
        f"RMS against the new facets {max(f_rms):.3e} (bound "
        f"{FACET_RMS:.0e}); B2 launches {counts_c['fold'][0]}")
    require(out["backward_rel_rms"] <= FACET_RMS,
            "the patched recording's backward is off the fresh one's")
    require(max(f_rms) <= FACET_RMS,
            "the patched recording's backward is off the new facets")
    require(not cuda or counts_c["fold"][0] > 0, "(c) launched B2 no time")
    del fp, ff
    fresh3.reset()
    del fresh3, fwd3
    if cuda:
        gc_collect(torch)
    mark("(c) backward fed from the patched recording")

    # the exact update: back to S1, re-recorded; its stream's digest is the
    # fresh S1 stream's
    sync()
    t0 = time.perf_counter()
    rep = engine.update(S1, exact=True)
    sync()
    out["exact"] = {"mode": rep["mode"], "reason": rep["reason"],
                    "seconds": time.perf_counter() - t0,
                    "digest": _stream_digest(engine.spill),
                    "fresh_digest": legs["k1"]["fresh_digest"]}
    out["exact"]["sha256_equal"] = (out["exact"]["digest"]
                                    == out["exact"]["fresh_digest"])
    log(f"{config_name} delta exact: {rep['mode']} ({rep['reason']}) in "
        f"{out['exact']['seconds']:.3f} s, stream sha256 "
        f"{out['exact']['digest'][:16]} (fresh {legs['k1']['fresh_digest'][:16]})")
    require(rep["mode"] == "replay" and rep["reason"] == "exact_mode",
            f"the exact update took {rep['mode']} ({rep['reason']})")
    require(out["exact"]["sha256_equal"],
            "the exact update's stream differs from a fresh forward's")
    delta_counts = read_counts()
    out["delta_launches"] = {k: v[0] for k, v in delta_counts.items()}
    out["counts_delta"] = delta_counts
    require(not cuda or all(out["delta_launches"][k] > 0
                            for k in ("colpass", "fold")),
            f"the delta path launched {out['delta_launches']}")
    mark("exact update")

    head = legs["k1"]
    delta_record = {
        "metric": f"{config_name} incremental K-facet update wall-clock "
                  f"({len(sgcs)} subgrids, planar f32, delta, "
                  f"{'gpu' if cuda else 'cpu'})",
        "value": head["update_s"], "unit": "s", "n_subgrids": len(sgcs),
        "full_record_wall_s": out["record_s"],
        "delta": {
            "n_facets": len(fcs),
            "changed_facets": head["changed_facets"],
            "patched_columns": head["patched_columns"],
            "patched_entries": head["patched_entries"],
            "speedup_vs_full": head["speedup_vs_full"],
            "max_abs_diff": head["match"]["max_abs_diff"],
            "match": head["match"], "plan": head["plan"],
            "exact": {"mode": out["exact"]["mode"],
                      "bit_identical": out["exact"]["sha256_equal"]},
            "exact_mode": False,
            "legs": [{k: v for k, v in leg.items() if k != "fresh_digest"}
                     for leg in legs.values()],
            "spill": engine.spill.stats(),
        },
        "manifest": run_manifest(params={**params, "mode": "delta"}),
    }
    problems = validate_delta_artifact(delta_record)
    require(not problems, f"the delta record: {problems}")
    out["legs"] = delta_record["delta"]["legs"]

    # -- (d) the fleet over the engine's fabric ---------------------------
    fabric = engine.fabric()
    stack = engine.facet_tasks

    def factory(rid, feed):
        fwd = st.SwiftlyForward(cfg, stack, lru_forward=2)
        return st.SubgridService(
            fwd, scheduler=CoalescingScheduler(max_batch=8), cache_feed=feed)

    # as in the JAX package's fleet drill (bench.py:2414), an impossible
    # brownout share keeps the ladder out of the update and kill windows
    # (hedge losers left queued behind the patch window's fallbacks would
    # otherwise read as overload and shed priority-0 submissions); a
    # replica busy preparing its facets is probed, not revoked, unless
    # the supervisor misses it for 1 s; a fast supervisor and pumps, as
    # (e) fetches rows one by one
    fleet = st.ServeFleet(factory, FLEET_REPLICAS, fabric=fabric,
                          seed=FLEET_SEED, poll_s=0.0005,
                          supervise_interval_s=0.0005,
                          lease_interval_s=0.05, miss_suspect=2,
                          miss_revoke=20, brownout_share=2.0)
    victim = 0
    # the replicas' forwards prepare their facet stacks (one request each)
    for r in fleet.replicas.values():
        r.service.fwd.get_subgrid_tasks([sgcs[0]])
    sync()
    mark("(d) fleet built, replicas' facets prepared")
    index = CachedColumnFeed.build_index(engine.spill)
    old_entries = [engine.spill.get(k) for k in range(len(engine.spill))]
    work = _fleet_traffic(sgcs, n_requests, FLEET_SEED)
    bounds = [int(round(f * n_requests)) for f in FLEET_SEGMENTS]
    reset_counts()
    window = {"b3": 0, "fallbacks": 0}
    spill = engine.spill
    begin_patch, end_patch = spill.begin_patch, spill.end_patch

    def fallbacks():
        return sum(r.service.stats()["cache_fallbacks"]
                   for r in fleet.replicas.values())

    def begin():  # the patch window opens: no engine launch until it closes
        window["b3"] -= st.cmatmul_stats.launches
        window["fallbacks"] -= fallbacks()
        begin_patch()

    def end():
        end_patch()
        window["b3"] += st.cmatmul_stats.launches
        window["fallbacks"] += fallbacks()

    spill.begin_patch, spill.end_patch = begin, end
    fleet.start()
    clients = _FleetClients(fleet, work)
    t_fleet = time.perf_counter()
    try:
        clients.release(bounds[0], epoch="before")
        clients.wait_done(bounds[0])
        mark(f"(d) {bounds[0]} requests served before the update")
        clients.release(bounds[1], epoch="during",
                        pace_s=FLEET_UPDATE_PACE_S)
        t0 = time.perf_counter()
        rep = fleet.post_facet_update(engine, S0, use_plan=False)
        out["fleet_update_s"] = time.perf_counter() - t0
        clients.release(bounds[1], epoch="after", pace_s=0.0)
        require(rep["mode"] == "patch",
                f"the fleet's update took {rep['mode']} ({rep['reason']})")
        clients.wait_done(bounds[1])
        mark("(d) facet update landed")
        clients.release(bounds[2])
        clients.wait_done(min(bounds[1] + FLEET_KILL_AFTER, bounds[2]))
        fleet.kill_replica(victim)
        clients.wait_done(bounds[2])
        deadline = time.monotonic() + 30.0
        while (not fleet.replica(victim).lease.revoked
               and time.monotonic() < deadline):
            time.sleep(0.01)
        require(fleet.replica(victim).lease.revoked,
                "the killed replica's lease was never revoked")
        fleet.restore_replica(victim)
        # the rest in steps of one request a client, until the victim's
        # breaker has closed again (its half-open probes succeeded), then
        # all at once
        clients.release(bounds[2], epoch="restored")
        breaker = fleet.replica(victim).breaker
        step_s = FLEET_RESTORE_SPAN_S * FLEET_CLIENTS / (bounds[3] - bounds[2])
        while clients.allowed < bounds[3] and breaker.state != "closed":
            clients.release(min(bounds[3], clients.allowed + FLEET_CLIENTS))
            time.sleep(step_s)
        clients.release(bounds[3])
        clients.wait_done(bounds[3])
        require(fleet.drain(timeout=120.0), "the fleet did not drain")
        fleet_s = time.perf_counter() - t_fleet
        mark(f"(d) {n_requests} requests served")
        sync()
        fleet_counts_d = read_counts()

        # -- (e) visibilities through the fleet ---------------------------
        uv_all, _ = vis_traffic(sgcs, n_vis * VIS_BATCHES, VIS_SEED,
                                VIS_ZIPF_S, kernel.support + 1, N)
        uv = np.array_split(uv_all, VIS_BATCHES)[0]
        vsvc = sv.VisibilityService(
            subgrid_configs=sgcs, N=N, kernel=kernel,
            row_source=sv.FleetRowSource(fleet, priority=1),
            queue=AdmissionQueue(max_depth=VIS_MAX_DEPTH),
            scheduler=CoalescingScheduler(max_batch=VIS_MAX_BATCH,
                                          urgency_s=0.05),
            device=device)
        b4_0 = st.degrid_stats.launches
        sync()
        t0 = time.perf_counter()
        handle = vsvc.submit(uv, priority=1)
        while vsvc.pump_once():
            pass
        sync()
        out["vis_s"] = time.perf_counter() - t0
        vstats = vsvc.stats()
        out["vis_b4_launches"] = st.degrid_stats.launches - b4_0
        fleet_counts = read_counts()
        fleet_wall = time.perf_counter() - t_fleet
        fstats = fleet.stats(wall_s=fleet_wall)
        fabric_stats = fabric.stats()
        tower = fleet.tower.fleet_telemetry()
    finally:
        clients.close()
        fleet.stop()
        spill.begin_patch, spill.end_patch = begin_patch, end_patch
    mark("(e) visibilities served through the fleet")

    # -- gates of (d) -------------------------------------------------------
    require(not clients.errors, f"fleet clients: {clients.errors[:3]}")
    new_entries = [engine.spill.get(k) for k in range(len(engine.spill))]

    def recorded(entries, sg):
        k, ci, si, _ = index[(sg.off0, sg.off1, sg.size)]
        return entries[k][ci, si]

    paths = {"cache": 0, "coalesced": 0, "compute": 0}
    bad = {"old": 0, "new": 0, "either": 0}
    lat = {"before": [], "during": [], "after": []}
    n_ok = checked = cache_checked = 0
    for i, item in enumerate(clients.tracked):
        require(item is not None, f"request {i} was never submitted")
        sg, freq, epoch, _t = item
        res = freq.result
        if res is None or not res.ok:
            continue
        n_ok += 1
        lat["before" if i < bounds[0] else "during" if i < bounds[2]
            else "after"].append(res.latency_s)
        if res.path == "cache":
            paths["cache"] += 1
            got = np.asarray(res.data)
            def match(ref):
                return np.array_equal(got, ref)
        else:
            paths["coalesced" if res.coalesced else "compute"] += 1
            got = res.data.cpu().numpy() if hasattr(res.data, "cpu") \
                else np.asarray(res.data)
            def match(ref):
                return _rel_l2(got, ref) <= FLEET_COMPUTE_REL
        old_ok = match(recorded(old_entries, sg))
        new_ok = match(recorded(new_entries, sg))
        checked += 1
        cache_checked += res.path == "cache"
        want = {"before": "old", "during": "either"}.get(epoch, "new")
        ok = {"old": old_ok, "new": new_ok, "either": old_ok or new_ok}[want]
        bad[want] += not ok
    breaker = fstats["breakers"][str(victim)]
    cycle = [t["to"] for t in breaker["transitions"]]
    out["fleet"] = {
        "requests": n_requests, "served_ok": n_ok, "zero_lost":
        n_ok == n_requests, "fleet_s": fleet_s, "update_s":
        out["fleet_update_s"], "p50_ms": fstats["p50_ms"],
        "p99_ms": fstats["p99_ms"],
        "p99_before_ms": _quantile_ms(lat["before"], 0.99),
        "p99_during_ms": _quantile_ms(lat["during"], 0.99),
        "p99_after_ms": _quantile_ms(lat["after"], 0.99),
        "paths": paths, "mismatches": bad, "checked": checked,
        "patch_window": dict(window), "breaker_cycle": cycle,
        "failovers": fstats["failovers"], "hedges": fstats["hedges"],
        "restores": fstats["restores"], "rolls": fabric_stats["rolls"],
        "resident_stream_copies": fabric_stats["resident_stream_copies"],
        "stream_copies": fstats["stream_copies"],
        "l1_hits": fabric_stats["l1_hits"], "l2_hits": fabric_stats["l2_hits"],
        "dedup_hits": fabric_stats["dedup_hits"],
        "dedup_computes": fabric_stats["dedup_computes"],
        "launches": {k: v[0] for k, v in fleet_counts_d.items()},
        "peak_gib": peak_gib(),
    }
    log(f"{config_name} fleet: {n_ok} of {n_requests} requests served in "
        f"{fleet_s:.3f} s, p50 {fstats['p50_ms']:.3f} ms, p99 "
        f"{fstats['p99_ms']:.3f} ms (before / during / after "
        f"{out['fleet']['p99_before_ms']:.3f} / "
        f"{out['fleet']['p99_during_ms']:.3f} / "
        f"{out['fleet']['p99_after_ms']:.3f}); paths {paths}; update "
        f"{out['fleet_update_s']:.3f} s, patch window {window}; fabric L1 "
        f"{fabric_stats['l1_hits']}, L2 {fabric_stats['l2_hits']}, dedup "
        f"{fabric_stats['dedup_hits']} of {fabric_stats['dedup_computes']} "
        f"computes; failovers {fstats['failovers']}, hedges "
        f"{fstats['hedges']}, breaker {cycle}; mismatches {bad}; launches "
        f"{out['fleet']['launches']}")
    lost = {}
    for item in clients.tracked:
        res = item[1].result
        if res is None or not res.ok:
            why = "no result" if res is None else (
                f"{res.status}: {res.shed_reason or res.error}")
            lost[why] = lost.get(why, 0) + 1
    require(n_ok == n_requests, f"{n_requests - n_ok} requests lost: {lost}")
    require(not any(bad.values()), f"served rows off their version: {bad}")
    require(not cuda or (window["fallbacks"] >= 1 and window["b3"] >= 1),
            f"no compute fallback ran B3 in the patch window: {window}")
    require({"open", "half_open", "closed"} <= set(cycle),
            f"the victim's breaker went {cycle}")
    require(fabric_stats["rolls"] == 1 and fstats["stream_copies"] == 1
            and fabric_stats["resident_stream_copies"] == 1,
            f"rolls {fabric_stats['rolls']}, copies {fstats['stream_copies']}")

    manifest = run_manifest(params={**params, "mode": "fleet"})
    bit = {"checked": checked, "mismatches": sum(bad.values()),
           "cache_path_checked": cache_checked}
    per_replica = fstats["per_replica"]
    fleet_record = {
        "metric": f"{config_name} serve fleet ({n_requests} zipf requests "
                  f"over {len({sg.off0 for sg in sgcs})} columns, "
                  f"{FLEET_REPLICAS} replicas + cache fabric, facet update, "
                  f"kill and restore, planar f32, {'gpu' if cuda else 'cpu'})",
        "value": fleet_s, "unit": "s",
        "throughput_rps": fstats["served"] / fleet_wall,
        "p50_ms": fstats["p50_ms"], "p99_ms": fstats["p99_ms"],
        "n_requests": fstats["requests"], "n_served": fstats["served"],
        "bit_identical": bit,
        "fleet": {
            "n_replicas": FLEET_REPLICAS, "victim": victim,
            "replica_deaths": 1, "restores": fstats["restores"],
            "failovers": fstats["failovers"], "reroutes": fstats["reroutes"],
            "hedges": fstats["hedges"], "zero_lost": n_ok == n_requests,
            "p99_before_ms": out["fleet"]["p99_before_ms"],
            "p99_during_ms": out["fleet"]["p99_during_ms"],
            "p99_after_ms": out["fleet"]["p99_after_ms"],
            "breaker_cycle": cycle, "breakers": fstats["breakers"],
            "health_transitions": fstats["health"]["transitions"],
            "brownout": fstats["brownout"], "per_replica": per_replica,
            "stream_copies": fstats["stream_copies"],
            "facet_updates": fstats.get("facet_updates", 0),
        },
        "cache": fabric_stats,
        "fleet_telemetry": tower,
        "manifest": manifest,
    }
    serve_blocks = []
    for rid, replica in sorted(fleet.replicas.items()):
        s = replica.service.stats()
        serve_blocks.append({
            **s, "manifest": manifest, "replica": rid,
            "metric": f"{config_name} serve fleet replica {rid} "
                      "(SubgridService over the fabric's view)",
            "value": fleet_wall, "unit": "s",
            "throughput_rps": s["n_served"] / fleet_wall,
            "bit_identical": bit})
    fleet_record["serve"] = serve_blocks
    problems = validate_fleet_artifact(fleet_record)
    for blk in serve_blocks:
        problems += [f"serve block of replica {blk['replica']}: {p}"
                     for p in validate_serve_artifact(blk)]
    require(not problems, f"the fleet record: {problems}")

    # -- gates of (e) -------------------------------------------------------
    m = np.isfinite(handle.data)
    served_uv, served_vis = np.atleast_2d(uv)[m], handle.data[m]
    oracle = sv.vis_oracle(raw, served_uv, N)
    out["vis"] = {
        "samples": len(uv), "served_samples": int(m.sum()),
        "seconds": out["vis_s"], "pumps": vstats["n_pumps"],
        "rows_fetched": vstats["n_batches"],
        "b4_launches": out["vis_b4_launches"],
        "shed_reasons": vstats["shed_reasons"],
        "oracle_rel_rms": float(
            np.sqrt(np.mean(np.abs(served_vis - oracle) ** 2))
            / np.sqrt(np.mean(np.abs(oracle) ** 2))),
    }
    log(f"{config_name} fleet vis: {out['vis']['served_samples']} of "
        f"{len(uv)} samples served through FleetRowSource in "
        f"{out['vis_s']:.3f} s ({vstats['n_batches']} rows in "
        f"{vstats['n_pumps']} pumps, B4 launches "
        f"{out['vis_b4_launches']}); oracle rel RMS "
        f"{out['vis']['oracle_rel_rms']:.3e} (bound {sv.DEGRID_TOLERANCE})")
    require(out["vis"]["oracle_rel_rms"] <= sv.DEGRID_TOLERANCE,
            "fleet-served samples off the oracle")
    require(not cuda or out["vis_b4_launches"] == vstats["n_pumps"] > 0,
            f"B4 launched {out['vis_b4_launches']} times in "
            f"{vstats['n_pumps']} pumps")
    out["counts_fleet"] = fleet_counts
    out["fleet_launches"] = {k: v[0] for k, v in fleet_counts.items()}
    out["peak_gib"] = peak_gib()
    out["phase_s"] = time.perf_counter() - t_phase
    engine.spill.reset()
    mark("phase 14 done")
    return out


def _delta_line(res):
    """Phase 14's JSON record: every key but the per-shape launch counts
    (the `kernels` line's ``paths`` holds them)."""
    return {k: v for k, v in res.items() if not k.startswith("counts")}


def _facet_rms(torch, got, ref):
    """RMS of a planar [..., 2] device tensor against a real one, in
    float64."""
    d2 = (got[..., 0].double() - ref.double()) ** 2 + got[..., 1].double() ** 2
    return float(d2.mean().sqrt().item())


def big_main(torch, config_name=BIG_CONFIG, fold_group=4,
             slab_rows=BIG_SLAB_ROWS, profile=True, device="cuda"):
    """Phase 9: the 128k streamed round trip, planar f32, the full cover,
    from sparse facets (module docstring)."""
    import swiftly_tpu_torch as st

    cfg = st.SwiftlyConfig(backend="planar", dtype=torch.float32,
                           device=device, **st.SWIFT_CONFIGS[config_name])
    core = cfg.core
    N = cfg.image_size
    sources = sources_for(N)
    t0 = time.perf_counter()
    fcs = st.make_full_facet_cover(cfg)
    sgcs = st.make_full_subgrid_cover(cfg)
    tasks = [(fc, st.make_sparse_facet(N, fc, sources)) for fc in fcs]
    setup_s = time.perf_counter() - t0
    F, yB, m = len(fcs), fcs[0].size, core.xM_yN_size
    n, xA = len(sgcs), sgcs[0].size
    # a row slab that holds a source pixel: the first facet with one
    sp = next(sp for _, sp in tasks if sp.n_pixels)
    r0 = int(min(max(0, int(sp.rows[0]) - slab_rows // 3), yB - slab_rows))
    rows = (r0, r0 + slab_rows)
    n_samples = max(MIN_SUBGRID_SAMPLES, -(-n * 2 // 100))
    idxs = list(range(0, n, max(1, n // n_samples)))
    log(f"{config_name} streamed: {F} sparse facets of {yB} "
        f"({sum(s.n_pixels for _, s in tasks)} pixels) made in "
        f"{setup_s:.1f} s; {n} subgrids, {len(idxs)} sampled; backward row "
        f"slab {rows}")
    item = 4
    acc_bytes = F * slab_rows * yB * 2 * item
    row_bytes = F * m * yB * 2 * item
    sample_bytes = len(idxs) * xA * xA * 2 * item
    headroom = acc_bytes + (2 * fold_group + 2) * row_bytes + sample_bytes

    def executors(col_group=None):
        fwd = st.StreamedForward(cfg, tasks, residency="device",
                                 col_group=col_group)
        fwd.hbm_headroom = headroom
        bwd = st.StreamedBackward(cfg, fcs, residency="sampled",
                                  fold_group=fold_group, row_slab=rows)
        return fwd, bwd

    from swiftly_tpu_torch.obs import Heartbeat

    fwd, bwd = executors()
    # progress and ETA over the 85,849 subgrids, every 30 s
    hb = Heartbeat(total=n, label=f"{config_name} subgrids", interval_s=30.0,
                   log=SimpleNamespace(info=lambda fmt, *a: log(fmt % a)))
    feed = _TimedFeed(torch, fwd, idxs, heartbeat=hb)
    gc_collect(torch)
    before = _reset_peak(torch)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st.feed_backward_passes(feed, sgcs, [bwd])
    facets = bwd.finish_device()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    hb.finish()
    counts = read_counts()
    plan = fwd.last_plan
    require(hb.done == n, f"the heartbeat counted {hb.done} of {n} subgrids")
    t_fwd = feed.forward_s()
    peak = _peak(torch)
    from swiftly_tpu_torch.parallel import streamed as sm

    n_cols = len({sg.off0 for sg in sgcs})
    S = n // n_cols
    model = sm.stream_peak_bytes(fwd, n_cols, S, xA,
                                 *_consumers([bwd], S, xA),
                                 held=sample_bytes) + before
    out = {"config": config_name, "dtype": "float32", "subgrids": n,
           "facets": F, "facet_size": yB, "last_plan": plan,
           "n_groups": feed.n_groups, "fold_group": fold_group,
           "row_slab": list(rows), "forward_s": t_fwd,
           "backward_s": total - t_fwd, "roundtrip_s": total,
           "peak_memory_gib": peak / 2**30, "peak_memory_gb": peak / 1e9,
           "hbm_headroom_gb": headroom / 1e9,
           "allocated_before_gb": before / 1e9,
           "forward_modelled_gb": _modelled_bytes(fwd, sgcs) / 1e9,
           "launches": {k: v[0] for k, v in counts.items()},
           "counts": counts, "facet_setup_s": setup_s,
           "heartbeat_subgrids": hb.done,
           "sizer": _sizer_record(f"{config_name} streamed", model, peak)}
    log(f"{config_name} streamed round trip: forward {t_fwd:.3f} s, backward "
        f"{total - t_fwd:.3f} s, plan {json.dumps(plan)}, {feed.n_groups} "
        f"groups, peak {peak / 2**30:.2f} GiB, launches {out['launches']}")

    # gates: sampled subgrids against the oracle, the slab against the input
    scale = sum(abs(s[0]) for s in sources) / N**2
    require(sorted(feed.samples) == idxs, "sampled subgrids missing")
    t0 = time.perf_counter()
    sg_rms = [st.check_subgrid(N, sgcs[i], core.as_complex(feed.samples[i]),
                               sources) for i in idxs]
    feed.samples.clear()
    cols = {sgcs[i].off0 for i in idxs}
    f_rms = []
    for i in range(F):
        ref = fwd.synth_facet_device(i)[rows[0]:rows[1]]
        f_rms.append(_facet_rms(torch, facets[i], ref))
        del ref
    out.update(n_subgrid_samples=len(idxs), sampled_columns=len(cols),
               max_subgrid_rms=max(sg_rms),
               subgrid_rms_bound=SUBGRID_REL_RMS * scale,
               max_facet_rms=max(f_rms), facet_rms=f_rms,
               facet_rms_bound=FACET_RMS,
               slab_source_pixels=int(sum(
                   ((s.rows >= rows[0]) & (s.rows < rows[1])).sum()
                   for _, s in tasks)),
               gates_s=time.perf_counter() - t0)
    log(f"{config_name} accuracy: max subgrid RMS {max(sg_rms):.3e} over "
        f"{len(idxs)} samples in {len(cols)} columns (bound "
        f"{SUBGRID_REL_RMS * scale:.3e}), max slab RMS {max(f_rms):.3e} over "
        f"{F} facets (bound {FACET_RMS:.0e}), {out['slab_source_pixels']} "
        "source pixels in the slab")
    require(all(np.isfinite(sg_rms)) and all(np.isfinite(f_rms)),
            "non-finite RMS at 128k")
    require(len(cols) == len({sg.off0 for sg in sgcs}),
            "the sampled subgrids miss a column")
    require(max(sg_rms) <= SUBGRID_REL_RMS * scale,
            "128k subgrid RMS over bound")
    require(out["slab_source_pixels"] > 0, "the row slab holds no source")
    require(max(f_rms) <= FACET_RMS, "128k slab RMS over bound")
    require(peak < 80e9, f"128k peak {peak / 1e9:.1f} GB")
    require(plan["mode"] == "grouped" and plan["facet_group"] == 1
            and plan["facet_source"] == "device-synth-sparse",
            f"the 128k forward chose {plan}")
    fwd_b1 = sum(v for key, v in counts["colpass"][1].items() if key[-1])
    bwd_b1 = sum(v for key, v in counts["colpass"][1].items() if not key[-1])
    require(fwd_b1 > 0 and bwd_b1 > 0 and out["launches"]["fold"] > 0
            and out["launches"]["cmatmul"] > 0,
            f"the 128k path's launches: {out['launches']}")
    del facets, feed, fwd, bwd
    gc_collect(torch)
    if profile:
        out.update(profile_big(torch, executors, sgcs, plan["col_group"]))
    return out


def gc_collect(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _big_category(name):
    """The stage a device activity of the 128k round trip belongs to, by
    kernel name (B1 and B2 are one engine, told apart by its kConjL
    template argument: false for B1)."""
    lower = name.lower()
    if "cgemm_kernel<" in name:
        return "B1" if name.split(">")[0].endswith("false") else "B2"
    if "cmatmul_kernel<" in name:
        return "B3"
    for key, words in (("cuBLAS GEMM", ("gemm",)), ("fill", ("fill",)),
                       ("index", ("index",)), ("add", ("add",)),
                       ("copy", ("memcpy", "copy"))):
        if any(w in lower for w in words):
            return key
    return "other"


def profile_big(torch, executors, sgcs, G, rows=12):
    """One column group of the 128k round trip again (its first G columns
    through the same executors) under torch.profiler, device activity
    only: the busy share of its synchronised window and the device time
    by stage; the facet pass of one slab over the group's rows, timed
    alone with CUDA events."""
    import swiftly_tpu_torch as st
    from swiftly_tpu_torch.parallel import streamed as sm

    cols = sorted({sg.off0 for sg in sgcs})[:G]
    wanted = set(cols)
    sub = [sg for sg in sgcs if sg.off0 in wanted]
    fwd, bwd = executors(col_group=G)
    with _device_profile(torch, True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st.feed_backward_passes(fwd, sub, [bwd])
        bwd.finish_device()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = _device_events(prof)
    busy_s = _busy_seconds([(a / 1e3, b / 1e3) for _, a, b in events])
    by_cat, by_name = {}, {}
    for name, a, b in events:
        for table, key in ((by_cat, _big_category(name)), (by_name, name)):
            k, total = table.get(key, (0, 0))
            table[key] = (k + 1, total + b - a)
    out = {"profiled_columns": len(cols), "profiled_window_s": window_s,
           "profiled_device_busy_s": busy_s,
           "profiled_busy_share": busy_s / window_s,
           "profiled_by_stage_s": {k: v[1] / 1e9 for k, v in by_cat.items()},
           "profiled_by_stage_launches": {k: v[0] for k, v in by_cat.items()}}
    # one slab's synthesis, its facet pass over the group's rows and one
    # column's add of partials, each alone (CUDA events), and their totals
    # over the group (one slab a facet, G columns a slab)
    core = fwd.core
    xM, S = core.xM_size, len(sub) // len(cols)
    synth_ms = _cuda_ms(torch, lambda: fwd._synth_slab(0, 1), 3)
    slab = (fwd._synth_slab(0, 1),)
    krows = torch.as_tensor(sm.sampled_row_indices(core, cols), device="cuda")
    e0 = torch.zeros(1, dtype=torch.int64, device="cuda")
    pass_ms = _cuda_ms(torch, lambda: sm._facet_pass_sampled(
        core, slab, e0, krows, real_facets=True), 1)
    del slab
    acc = torch.zeros((S, xM, xM, 2), device="cuda")
    part = torch.ones((S, xM, xM), device="cuda")

    def add():
        acc[..., 0].add_(part)
        acc[..., 1].add_(part)

    add_ms = _cuda_ms(torch, add, 3)
    del acc, part
    n_slabs = len(fwd.stack)
    out.update(synth_one_slab_s=synth_ms / 1e3,
               facet_pass_one_slab_s=pass_ms / 1e3,
               add_one_column_s=add_ms / 1e3,
               synth_group_s=synth_ms / 1e3 * n_slabs,
               facet_pass_group_s=pass_ms / 1e3 * n_slabs,
               add_group_s=add_ms / 1e3 * n_slabs * len(cols))
    log("profiled 128k column group: " + json.dumps(out))
    for name, (k, total) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:rows]:
        log(f"  {total / 1e6:10.1f} ms {k:8d}  {name[:90]}")
    return out


# -- phase 8: visibility serving and gridding -------------------------------


def vis_sources(N, kernel):
    """The spread sources scaled to 0.9 of the kernel's band edge (the fit
    error grows toward the edge) — the raw sky model the oracle audits;
    the facets are built from its grid-corrected twin."""
    maxc = max(max(abs(a), abs(b)) for a, b in SOURCE_FRACTIONS)
    scale = 0.9 * kernel.band / 2.0 / maxc
    return [(w, int(x * scale), int(y * scale)) for (w, x, y) in sources_for(N)]


def vis_traffic(sgcs, n, seed, zipf_s, margin, N):
    """Zipf-over-columns (u, v) samples (shuffled popularity, p ~ 1/rank^s),
    each uniform inside a random subgrid of its column, ``margin`` pixels
    in from its edge, then a 10% uniform-over-the-grid tail: the reference
    benchmark's ``_vis_zipf_uv`` (bench.py:1712), drawn vectorised.

    :return: ([n, 2] uv, the hottest column's off0)
    """
    rng = np.random.default_rng(seed)
    cols = sorted({sg.off0 for sg in sgcs})
    by_col = {c: [] for c in cols}
    for sg in sgcs:
        by_col[sg.off0].append(sg)
    order = rng.permutation(len(cols))
    ranks = np.empty(len(cols), dtype=int)
    ranks[order] = np.arange(len(cols))
    p = 1.0 / (ranks + 1.0) ** zipf_s
    p /= p.sum()
    n_tail = n // 10
    n_zipf = n - n_tail
    picks = rng.choice(len(cols), size=n_zipf, p=p)
    S = max(len(v) for v in by_col.values())
    n_in = np.array([len(by_col[c]) for c in cols])
    off1 = np.zeros((len(cols), S))
    size = np.ones((len(cols), S))
    for c, col in enumerate(cols):
        off1[c, :n_in[c]] = [sg.off1 for sg in by_col[col]]
        size[c, :n_in[c]] = [sg.size for sg in by_col[col]]
    s = np.minimum((rng.uniform(size=n_zipf) * n_in[picks]).astype(int),
                   n_in[picks] - 1)
    half = size[picks, s] / 2.0 - margin
    uv = np.empty((n, 2))
    uv[:n_zipf, 0] = np.asarray(cols)[picks] + rng.uniform(-half, half)
    uv[:n_zipf, 1] = off1[picks, s] + rng.uniform(-half, half)
    uv[n_zipf:] = rng.uniform(0, N, size=(n_tail, 2))
    return uv, cols[int(np.argmax(p))]


def vis_feed(hot_col, hot_stack, tag):
    """A `SpillCache` recorded with the hottest column's rows (one
    [1, S, xA, xA, 2] entry) and the `CachedColumnFeed` over it."""
    from swiftly_tpu_torch.parallel.streamed import CachedColumnFeed
    from swiftly_tpu_torch.utils.spill import SpillCache

    spill = SpillCache(budget_bytes=2**30)
    spill.begin_fill(tag=tag)
    spill.put([list(enumerate(hot_col))], hot_stack)
    spill.end_fill()
    return spill, CachedColumnFeed(spill)


def _served(tracked):
    """(uv, samples) of every served sample of the tracked handles."""
    uv, data = [], []
    for uv_b, h in tracked:
        m = np.isfinite(h.data)
        uv.append(np.atleast_2d(uv_b)[m])
        data.append(h.data[m])
    return np.concatenate(uv), np.concatenate(data)


def vis_setup(torch, config_name=MAIN_CONFIG, device="cuda",
              n_samples=VIS_SAMPLES, n_batches=VIS_BATCHES):
    """Phase 8's set-up: the forward over the grid-corrected sky model's
    facets, the cache feed seeded with the hottest column's rows, the
    service, and the traffic cut into batches with their priorities. Uses
    only entry points that every checkout of the port since its visibility
    slice has, so that it drives an earlier checkout too."""
    import swiftly_tpu_torch as st
    from swiftly_tpu_torch import vis as sv
    from swiftly_tpu_torch.serve import AdmissionQueue, CoalescingScheduler

    kernel = sv.vis_kernel()
    cfg = st.SwiftlyConfig(backend="planar", dtype=torch.float32,
                           device=device, **st.SWIFT_CONFIGS[config_name])
    N = cfg.image_size
    raw = vis_sources(N, kernel)
    corrected = kernel.correct_sources(raw, N)
    fcs = st.make_full_facet_cover(cfg)
    sgcs = st.make_full_subgrid_cover(cfg)
    t0 = time.perf_counter()
    tasks = [(fc, st.make_real_facet(N, fc, corrected)) for fc in fcs]
    uv_all, hot_off0 = vis_traffic(sgcs, n_samples, VIS_SEED, VIS_ZIPF_S,
                                   kernel.support + 1, N)
    hot_col = [sg for sg in sgcs if sg.off0 == hot_off0]
    setup_s = time.perf_counter() - t0
    log(f"{config_name} vis: {len(fcs)} real facets, {len(sgcs)} subgrids, "
        f"{n_samples} samples drawn in {setup_s:.1f} s; hottest column "
        f"{hot_off0} ({len(hot_col)} subgrids)")

    # the forward, and the cache feed seeded with the hottest column's rows
    # through the same per-subgrid program the compute fallback runs
    fwd = st.SwiftlyForward(cfg, tasks, lru_forward=2, queue_size=64)
    hot_stack = np.stack(
        [fwd.get_subgrid_task(sg).cpu().numpy() for sg in hot_col])[None]
    feed_tag = ("vis-seed", config_name, len(hot_col))
    spill, feed = vis_feed(hot_col, hot_stack, feed_tag)
    service = sv.VisibilityService(
        fwd, subgrid_configs=sgcs, kernel=kernel, cache_feed=feed,
        queue=AdmissionQueue(max_depth=VIS_MAX_DEPTH),
        scheduler=CoalescingScheduler(max_batch=VIS_MAX_BATCH,
                                      urgency_s=0.05),
    )
    rng = np.random.default_rng(VIS_SEED + 1)
    return SimpleNamespace(
        cfg=cfg, kernel=kernel, N=N, raw=raw, fcs=fcs, sgcs=sgcs,
        tasks=tasks, hot_col=hot_col, fwd=fwd, hot_stack=hot_stack,
        feed_tag=feed_tag, spill=spill, feed=feed, service=service,
        batches=np.array_split(uv_all, n_batches),
        priorities=rng.integers(0, 4, size=n_batches), setup_s=setup_s)


def vis_main(torch, config_name=MAIN_CONFIG, device="cuda",
             n_samples=VIS_SAMPLES, n_batches=VIS_BATCHES, fold_group=4,
             n_bitcheck=48, n_serve=None):
    """The main path of the visibility slice: serve, grid and ingest, with
    its gates (module docstring, phase 8). The traffic is cut into
    `n_batches` batches, of which the first `n_serve` (None: all) are
    served."""
    import swiftly_tpu_torch as st
    from swiftly_tpu_torch import vis as sv

    cuda = device == "cuda"
    t_phase = time.perf_counter()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def mark(step):
        log(f"  [vis: {step} at {time.perf_counter() - t_phase:.1f} s]")

    ctx = vis_setup(torch, config_name, device, n_samples, n_batches)
    kernel, cfg, N, fcs, sgcs, tasks = (ctx.kernel, ctx.cfg, ctx.N, ctx.fcs,
                                        ctx.sgcs, ctx.tasks)
    hot_col, hot_stack, feed_tag = ctx.hot_col, ctx.hot_stack, ctx.feed_tag
    fwd, spill, feed, service = ctx.fwd, ctx.spill, ctx.feed, ctx.service
    batches, priorities, raw = ctx.batches, ctx.priorities, ctx.raw
    n_serve = n_batches if n_serve is None else min(n_serve, n_batches)
    mark("forward and cache feed ready")

    # -- the counted path: serve, then grid and ingest ----------------------
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    extractions0 = fwd.columns_extracted
    reset_counts()
    sync()
    t0 = time.perf_counter()
    tracked, pending = [], 0
    for k, b in enumerate(batches[:n_serve]):
        if k == VIS_EVICT_AFTER:
            spill.reset()  # forced eviction: the feed's index dangles
        tracked.append((b, service.submit(b, priority=int(priorities[k]))))
        pending += 1
        if pending >= 2 or k == n_serve - 1:
            while service.pump_once():
                pass
            pending = 0
    sync()
    serve_s = time.perf_counter() - t0
    serve_counts = read_counts()
    stats = service.stats()
    served_uv, served_vis = _served(tracked)

    gridder = sv.VisGridder(service.cover, kernel,
                            stream_version=service.stream_version,
                            version_of=lambda: service.stream_version,
                            device=device)
    sync()
    t0 = time.perf_counter()
    gridder.add_batch(served_uv, served_vis)
    cols, stack = gridder.emit(planar=True)
    sync()
    grid_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bwd = st.StreamedBackward(cfg, fcs, residency="sampled",
                              fold_group=fold_group)
    bwd.add_subgrid_group(cols, stack)
    facets = bwd.finish_device()
    sync()
    ingest_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    n_served = stats["n_served_samples"]
    out = {
        "config": config_name, "samples": n_samples, "batches": n_batches,
        "served_batches": n_serve,
        "submitted_samples": int(sum(map(len, batches[:n_serve]))),
        "serve_s": serve_s, "samples_per_s": n_served / serve_s,
        "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
        "max_ms": stats["max_ms"], "dispatches": stats["n_batches"],
        "mean_batch": stats["mean_batch"], "served_samples": n_served,
        "shed_reasons": stats["shed_reasons"],
        "rows_from_cache": stats["cache_hits"],
        "rows_computed": stats["n_batches"] - stats["cache_hits"],
        "cache_fallbacks": stats["cache_fallbacks"],
        "column_extractions": fwd.columns_extracted - extractions0,
        "grid_s": grid_s, "ingest_s": ingest_s,
        "gridded_columns": len(cols), "gridded_subgrids": sum(map(len, cols)),
        "serve_launches": {k: v[0] for k, v in serve_counts.items()},
        "launches": {k: v[0] for k, v in counts.items()},
        "counts": counts, "peak_memory_gib": peak, "setup_s": ctx.setup_s,
        "pumps": stats["n_pumps"],
        "serve_b4_launches": serve_counts["degrid"][0],
    }
    log(f"{config_name} vis: served {n_served} of "
        f"{out['submitted_samples']} samples submitted in "
        f"{serve_s:.3f} s ({out['samples_per_s']:.0f}/s, {stats['n_batches']} "
        f"dispatches, mean {stats['mean_batch']}, in {stats['n_pumps']} "
        f"pumps), gridded in {grid_s:.3f} s, ingested in {ingest_s:.3f} s; "
        f"launches {out['launches']}")

    mark("served, gridded and ingested")

    # -- gates ----------------------------------------------------------------
    oracle = sv.vis_oracle(raw, served_uv, N)
    out["oracle_rel_rms"] = float(
        np.sqrt(np.mean(np.abs(served_vis - oracle) ** 2))
        / np.sqrt(np.mean(np.abs(oracle) ** 2)))
    out["max_dispatch"] = max(
        (r.result.batch_size for _, h in tracked for r in h.children
         if r.result is not None and r.result.ok), default=0)
    out["facets_finite"] = bool(torch.isfinite(facets).all().item())

    # gridding twice: the same emitted stack and the same facets, bitwise;
    # the second gridding runs under torch.profiler (device activity only)
    # for the grid kernel's device time over all its launches
    gridder2 = sv.VisGridder(service.cover, kernel, device=device)
    with _device_profile(torch, cuda) as prof:
        gridder2.add_batch(served_uv, served_vis)
        cols2, stack2 = gridder2.emit(planar=True)
        sync()
    del gridder2
    if cuda:
        out["grid_traced_s"], out["grid_traced_launches"] = _kernel_seconds(
            _device_events(prof), "grid_kernel")
        log(f"grid kernel in the traced regridding: {out['grid_traced_s']:.4f}"
            f" s of device time over {out['grid_traced_launches']} launches")
    out["regrid_stack_bit_identical"] = bool(
        [[(g.off0, g.off1) for g in c] for c in cols2]
        == [[(g.off0, g.off1) for g in c] for c in cols]
        and torch.equal(stack2, stack))
    del stack, bwd
    bwd2 = st.StreamedBackward(cfg, fcs, residency="sampled",
                               fold_group=fold_group)
    bwd2.add_subgrid_group(cols2, stack2)
    del stack2
    out["regrid_facets_bit_identical"] = bool(
        torch.equal(bwd2.finish_device(), facets))
    del bwd2, facets
    mark("gridded and ingested again")

    # the adjoint identity on 32k rows: < degrid(G), y > == < G, grid(y) >
    rng_adj = np.random.default_rng(VIS_SEED + 5)
    sg = hot_col[0]
    half = sg.size / 2.0 - kernel.support - 1
    uv_adj = np.stack([sg.off0 + rng_adj.uniform(-half, half, size=64),
                       sg.off1 + rng_adj.uniform(-half, half, size=64)], 1)
    owners, _ = service.cover.map_samples(uv_adj)
    lhs = rhs = 0j
    for key, entry in owners.items():
        sg_k = service.cover.config(*key)
        row = fwd.get_subgrid_task(sg_k)
        cu = kernel.weights(entry["fu"], dtype=np.float64)
        cv = kernel.weights(entry["fv"], dtype=np.float64)
        d = sv.degrid_batch(row, entry["iu0"], entry["iv0"], cu, cv)
        y = rng_adj.normal(size=d.size) + 1j * rng_adj.normal(size=d.size)
        gr, gi = sv.grid_batch(sg_k.size, entry["iu0"], entry["iv0"], cu, cv,
                               y, device=device)
        host = row.cpu().numpy().astype(np.float64)
        lhs += np.vdot(d, y)
        rhs += np.vdot(host[..., 0] + 1j * host[..., 1],
                       gr.cpu().numpy() + 1j * gi.cpu().numpy())
    out["adjoint_rel"] = float(abs(lhs - rhs) / abs(lhs))

    # the facet update: the pinned gridder refuses, serving is compute-only
    hits = service.stats()["cache_hits"]
    service.post_facet_update()
    try:
        gridder.add_batch(served_uv[:4], served_vis[:4])
        out["stale_gridder_refused"] = False
    except LookupError:
        out["stale_gridder_refused"] = True
    del gridder
    hot_pt = np.array([[hot_col[0].off0 + 0.3, hot_col[0].off1 + 0.3]])
    post = service.serve(np.vstack([hot_pt, batches[0][:256]]))
    out["post_update_compute_only"] = bool(
        all(r.result is not None and r.result.ok and r.result.path == "compute"
            for r in post.children)
        and service.stats()["cache_hits"] == hits)

    mark("adjoint identity and facet update checked")

    # bit-identity: served samples against degrid_batch on rows computed
    # by a fresh forward, at another bucket (4096 lanes)
    del service, fwd, feed
    fwd_ref = st.SwiftlyForward(cfg, tasks, lru_forward=2, queue_size=64)
    index = sv.VisCoverIndex(sgcs, kernel.support, N)
    checked = mismatches = 0
    per_batch = max(1, n_bitcheck // 2)
    for k in (0, n_serve - 1):  # a cache-era and a compute-era batch
        uv_b, h = tracked[k]
        owners, _ = index.map_samples(uv_b)
        keys = list(owners)
        for key in keys[:: max(1, len(keys) // per_batch)][:per_batch]:
            entry = owners[key]
            n = entry["idx"].size
            if n > 2048:
                continue
            rep = -(-sv.bucket_size(4096) // n)  # lanes to reach 4096
            take = lambda a: np.tile(a, (rep,) + (1,) * (a.ndim - 1))[:4096]
            cu = kernel.weights(entry["fu"], dtype=np.float64)
            cv = kernel.weights(entry["fv"], dtype=np.float64)
            ref = sv.degrid_batch(
                fwd_ref.get_subgrid_task(index.config(*key)),
                take(entry["iu0"]), take(entry["iv0"]), take(cu), take(cv))[:n]
            got = h.data[entry["idx"]]
            checked += n
            mismatches += int(np.sum(got != ref))
    out["bitcheck_samples"] = checked
    out["bitcheck_mismatches"] = mismatches
    mark("bit-identity to a fresh forward checked")

    log(f"{config_name} vis gates: " + json.dumps({k: out[k] for k in (
        "oracle_rel_rms", "shed_reasons", "rows_from_cache", "cache_fallbacks",
        "max_dispatch", "adjoint_rel", "bitcheck_samples",
        "bitcheck_mismatches", "regrid_stack_bit_identical",
        "regrid_facets_bit_identical", "facets_finite",
        "stale_gridder_refused", "post_update_compute_only")}))
    require(out["oracle_rel_rms"] <= sv.DEGRID_TOLERANCE,
            f"served samples' oracle RMS {out['oracle_rel_rms']:.3e} > "
            f"{sv.DEGRID_TOLERANCE}")
    require(set(stats["shed_reasons"]) == {"outside_cover"},
            f"shed reasons {stats['shed_reasons']}, expected outside_cover "
            "only")
    require(stats["cache_hits"] > 0 and stats["cache_fallbacks"] > 0,
            f"cache hits {stats['cache_hits']}, fallbacks "
            f"{stats['cache_fallbacks']}: the row ladder was not exercised")
    require(0 < out["max_dispatch"] <= 4096,
            f"largest degrid dispatch {out['max_dispatch']} samples")
    require(out["adjoint_rel"] <= sv.ADJOINT_TOLERANCE,
            f"adjoint identity {out['adjoint_rel']:.3e} > "
            f"{sv.ADJOINT_TOLERANCE}")
    require(checked > 0 and mismatches == 0,
            f"{mismatches} of {checked} served samples differ from a fresh "
            "forward's rows")
    require(out["regrid_stack_bit_identical"]
            and out["regrid_facets_bit_identical"],
            "gridding twice gave different stacks or facets")
    require(out["facets_finite"], "the ingested facets are not finite")
    require(out["stale_gridder_refused"],
            "the pinned gridder accepted a batch after the facet update")
    require(out["post_update_compute_only"],
            "post-update serving touched the dropped feed")
    if cuda:
        missing = [k for k, v in out["launches"].items() if v == 0]
        require(not missing, f"the visibility path launched {missing} no time")
        require(out["serve_b4_launches"] == out["pumps"] > 0,
                f"serving launched B4 {out['serve_b4_launches']} times in "
                f"{out['pumps']} pumps that served a sample")
        # the traffic's first batch again, from a freshly seeded feed
        _, feed = vis_feed(hot_col, hot_stack, feed_tag)
        out.update(profile_vis(
            torch, sv, fwd_ref, sgcs, kernel, feed,
            [(batches[k], int(priorities[k]))
             for k in range(VIS_PROFILE_BATCHES)]))
        mark("profiled")
    return out


def _device_profile(torch, cuda):
    """torch.profiler recording device activity only (on the card), else a
    context that records nothing."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    return (profile(activities=[ProfilerActivity.CUDA]) if cuda
            else contextlib.nullcontext())


def profile_vis(torch, sv, fwd, sgcs, kernel, feed, window, rows=12):
    """Whole batches of the main traffic, `window` = [(samples, priority)],
    served again under torch.profiler (device activity only) by a fresh
    service with the cache feed `feed`, submitted together and pumped dry
    as the counted run does: the device's busy time against the window's
    own synchronised host seconds, and the device time per kernel. The
    profiler adds host work per launch, so the idle share under it is an
    upper bound of the unprofiled run's."""
    from swiftly_tpu_torch.serve import AdmissionQueue, CoalescingScheduler

    service = sv.VisibilityService(
        fwd, subgrid_configs=sgcs, kernel=kernel, cache_feed=feed,
        queue=AdmissionQueue(max_depth=VIS_MAX_DEPTH),
        scheduler=CoalescingScheduler(max_batch=VIS_MAX_BATCH, urgency_s=0.05))
    with _device_profile(torch, True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for uv, priority in window:
            service.submit(uv, priority=priority)
        while service.pump_once():
            pass
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    events = _device_events(prof)
    busy_s = _busy_seconds([(a / 1e3, b / 1e3) for _, a, b in events])
    stats = service.stats()
    out = {"profiled_batches": len(window),
           "profiled_samples": int(sum(len(uv) for uv, _ in window)),
           "profiled_dispatches": stats["n_batches"],
           "profiled_mean_batch": stats["mean_batch"],
           "profiled_rows_from_cache": stats["cache_hits"],
           "profiled_window_s": window_s, "profiled_device_busy_s": busy_s,
           "profiled_idle_share": (1.0 - busy_s / window_s
                                   if busy_s > 0 else None)}
    out["profiled_pumps"] = stats["n_pumps"]
    for name, kernel in (("degrid", "degrid_rows_kernel"),
                         ("cmatmul", "cmatmul_kernel")):
        out[f"profiled_{name}_s"], out[f"profiled_{name}_launches"] = (
            _kernel_seconds(events, kernel))
    log("profiled visibility serving: " + json.dumps(out))
    by_name = {}
    for name, a, b in events:
        n, total = by_name.get(name, (0, 0))
        by_name[name] = (n + 1, total + b - a)
    log(f"device time by kernel ({len(events)} device activities, read in "
        f"{time.perf_counter() - t0:.1f} s):")
    for name, (n, total) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:rows]:
        log(f"  {total / 1e6:10.1f} ms {n:8d}  {name[:90]}")
    return out


# -- main -------------------------------------------------------------------


def _by_frequency(shapes):
    """[(shape, launches)] from a {shape: launches} counter, most frequent
    first (ties: most work first)."""
    return sorted(shapes.items(),
                  key=lambda kv: (kv[1], np.prod(kv[0], dtype=float)),
                  reverse=True)


def _varied_shapes(shapes):
    """The shapes to time of a kernel whose batch varies per launch (the
    scatter's B per dispatch, B4's (B, G) per pump, over hundreds of
    values): the `VARIED_TIMED_SHAPES` most frequent, then the
    `VARIED_TIMED_SHAPES` largest."""
    frequent = _by_frequency(shapes)[:VARIED_TIMED_SHAPES]
    largest = sorted(shapes.items(), key=lambda kv: np.prod(kv[0], dtype=float),
                     reverse=True)[:VARIED_TIMED_SHAPES]
    return frequent + [kv for kv in largest if kv not in frequent]


def time_path(torch, check, path_shapes, f64_first=2, done=None):
    """Check and time one kernel at the shapes one 32k path gave it: f32
    against the plain version (timed), f64 at the first `f64_first`.
    `done` maps shapes already timed on another path to their records,
    which are reused. Returns (timed records, each with its shape's
    launches on this path, seconds of this kernel in the path's run at the
    timed shapes, the launches those cover)."""
    done = {} if done is None else done
    timed = []
    for i, (shape, n) in enumerate(path_shapes):
        shape = tuple(shape)
        if shape not in done:
            done[shape] = check(torch, shape, torch.float32, seed=i + 1,
                                timed=True)
            if i < f64_first:
                check(torch, shape, torch.float64, seed=i + 1)
        timed.append(dict(done[shape], launches=n))
    return (timed, sum(r["launches"] * r["ms"] for r in timed) / 1e3,
            sum(r["launches"] for r in timed))


def _kernel_record(name, paths, main_path):
    """One entry of the `kernels` line. `paths` maps each 32k path that
    launched the kernel to (launches, timed records at its shapes). The
    contract's keys are the main path's: its launches, and the times at
    its most frequent shape; ``paths`` keeps every path's launches beside
    the times at that path's own shapes."""
    source, replaces = KERNEL_SOURCES[name]
    launches, timed = paths[main_path]
    top = timed[0]
    keys = ("shape", "launches", "ms", "call_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "max_abs_err", "tflops", "variant",
            "variant_ms")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(t["max_abs_err"] for _, ts in paths.values()
                           for t in ts),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"], "shape": top["shape"],
        "check": "pass", "main_path": main_path,
        "paths": {p: {"launches": n, "shapes": [{k: r.get(k) for k in keys}
                                                for r in ts]}
                  for p, (n, ts) in paths.items()},
    }


def quick_main(torch):
    """``--quick``: phases 2 and 3 for B1 and B2 (ragged checks, every
    digest), phase 6, and phase 7 for B1 and B2 at the streamed path's
    shapes. For a kernel change's first calls; not the smoke run."""
    for dt in (torch.float32, torch.float64):
        for i, (shape, layout) in enumerate(B1_RAGGED):
            check_colpass(torch, shape, dt, seed=i, layout=layout)
        for i, (shape, layout) in enumerate(B2_RAGGED):
            check_fold(torch, shape, dt, seed=i, layout=layout)
    for shape, seed, want in B1_DIGESTS:
        check_colpass_digest(torch, shape, seed, want)
    for shape, seed, want in B2_DIGESTS:
        check_fold_digest(torch, shape, seed, want)
    for shape, seed, want in B3_DIGESTS:
        check_cmatmul_digest(torch, shape, seed, want)
    streamed = streamed_main(torch)
    checks = {"colpass": check_colpass, "fold": check_fold}
    out = {}
    for kname, check in checks.items():
        launches, shapes = streamed["counts"][kname]
        timed, secs, _ = time_path(torch, check, _by_frequency(shapes))
        out[kname] = {"launches": launches, "seconds": secs, "shapes": [
            {k: r.get(k) for k in ("shape", "launches", "ms", "plain_ms",
                                   "library_ms", "bound_ms", "tflops")}
            for r in timed]}
    out["streamed"] = {k: streamed[k] for k in (
        "forward_s", "backward_s", "max_subgrid_rms", "max_facet_rms",
        "bit_identical_to_warm_run", "facet_digests", "profiled_idle_share")}
    log(json.dumps({"quick": out}))
    return 0


def b4_main(torch, tree=True):
    """``--b4-digests``: B4's digests with the weights given, on whichever
    checkout is imported (``--root``). ``--b4``: also phase 3's B4 checks
    of this checkout, the one-row reduction and the pump."""
    if tree:
        for dt in (torch.float32, torch.float64):
            for i, shape in enumerate(VIS_RAGGED):
                check_degrid(torch, shape, dt, seed=i)
            for i, shape in enumerate(VIS_PUMP_RAGGED):
                check_degrid_rows(torch, shape, dt, seed=i, ragged=True)
    for shape, seed, want in B4_DIGESTS:
        if tree:
            check_degrid_digest(torch, shape, seed, want)
        else:
            _report_digest("degrid", shape, seed,
                           degrid_digest(torch, shape, seed), want)
    return 0


def serve_short_main(torch, smi, tasks_equal=False):
    """``--serve-short``: phase 8's set-up, then its traffic's first two
    batches (131,072 samples, one pump-dry cycle) served once, timed on
    the host clock between synchronisations; one ``serve_short`` JSON line.
    Drives any checkout of the port since its visibility slice
    (``--root``). With `tasks_equal`, also whether
    ``SwiftlyForward.get_subgrid_tasks`` gives the rows of
    ``get_subgrid_task`` bit for bit, for the hottest column."""
    import swiftly_tpu_torch as st
    from swiftly_tpu_torch.ops import _build

    _build.build_all(sorted(set(KERNEL_LIBS.values())))
    ctx = vis_setup(torch)
    service = ctx.service
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(2):
        service.submit(ctx.batches[k], priority=int(ctx.priorities[k]))
    while service.pump_once():
        pass
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    stats = service.stats()
    n = stats["n_served_samples"]
    out = {"package": str(Path(st.__file__).resolve().parent.parent),
           "card": smi, "samples": int(sum(map(len, ctx.batches[:2]))),
           "served_samples": n, "serve_s": serve_s,
           "samples_per_s": n / serve_s, "p50_ms": stats["p50_ms"],
           "p99_ms": stats["p99_ms"], "dispatches": stats["n_batches"],
           "mean_batch": stats["mean_batch"],
           "pumps": stats.get("n_pumps"),  # None before the pump launch
           "b4_launches": st.degrid_stats.launches,
           "rows_from_cache": stats["cache_hits"], "setup_s": ctx.setup_s}
    if tasks_equal:
        single = [ctx.fwd.get_subgrid_task(sg) for sg in ctx.hot_col]
        stacked = ctx.fwd.get_subgrid_tasks(ctx.hot_col)
        out["subgrid_tasks_rows"] = len(single)
        out["subgrid_tasks_bitwise_equal"] = sum(
            bool(torch.equal(a, b)) for a, b in zip(single, stacked))
        out["subgrid_tasks_max_abs_diff"] = max(
            (a - b).abs().max().item() for a, b in zip(single, stacked))
    log(json.dumps({"serve_short": out}))
    return 0


def serve_ab_main(parent, pairs, smi):
    """``--serve-ab DIR``: the short serving run of the checkout DIR (e.g.
    the parent commit, unpacked with ``git archive``) and of this one in
    turn, `pairs` runs each (parent, tree, tree, parent, ...), each in its
    own process driven by this script, after both checkouts' kernels are
    built; one ``ab_run`` line a run, then the medians and spreads."""
    roots = {"parent": Path(parent).resolve(), "tree": ROOT}
    libs = sorted(set(KERNEL_LIBS.values()))
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from swiftly_tpu_torch.ops import _build; "
             "_build.build_all(sys.argv[2:])")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", build, str(r), *libs])
             for r in roots.values()]
    codes = [proc.wait() for proc in procs]
    require(codes == [0, 0], f"the kernel builds exited {codes}")
    log(f"built both checkouts' kernels in {time.perf_counter() - t0:.1f} s")
    runs = {side: [] for side in roots}
    for i in range(pairs):
        for side in ("parent", "tree") if i % 2 == 0 else ("tree", "parent"):
            cmd = [sys.executable, str(ROOT / "chip_smoke.py"),
                   "--serve-short", "--root", str(roots[side])]
            if side == "tree" and i == pairs - 1:
                cmd.append("--tasks-equal")
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=900)
            require(proc.returncode == 0,
                    f"{side} run {i} exited {proc.returncode}:\n"
                    f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[side].append(rec["serve_short"])
            log(json.dumps({"ab_run": i, "side": side, **rec["serve_short"]}))
    summary = {"card": smi, "pairs": pairs}
    for side, recs in runs.items():
        summary[side] = {"package": recs[0]["package"]}
        for key in ("serve_s", "samples_per_s", "p50_ms", "p99_ms"):
            vals = [r[key] for r in recs]
            summary[side][key] = {"median": float(np.median(vals)),
                                  "min": min(vals), "max": max(vals)}
        for key in ("served_samples", "dispatches", "pumps", "b4_launches"):
            summary[side][key] = sorted({r[key] for r in recs},
                                        key=lambda v: (v is None, v))
    summary["subgrid_tasks"] = {k: runs["tree"][-1][k] for k in (
        "subgrid_tasks_rows", "subgrid_tasks_bitwise_equal",
        "subgrid_tasks_max_abs_diff")}
    log(json.dumps({"serve_ab": summary}))
    return 0


def _args():
    p = argparse.ArgumentParser(
        description="Smoke run of the PyTorch/CUDA port on one NVIDIA GPU "
        "(the module docstring says what each phase does); with no "
        "argument, every phase.")
    p.add_argument("--quick", action="store_true",
                   help="phases 2 and 3 for B1 and B2, phase 6, phase 7 for "
                   "B1 and B2")
    p.add_argument("--b4", action="store_true",
                   help="phase 2, then phase 3's B4 checks and digests")
    p.add_argument("--b4-digests", action="store_true",
                   help="phase 2, then B4's digests (works on an earlier "
                   "checkout, through --root)")
    p.add_argument("--serve-short", action="store_true",
                   help="phase 8's first two batches served once")
    p.add_argument("--tasks-equal", action="store_true",
                   help="with --serve-short: get_subgrid_tasks against "
                   "get_subgrid_task on the hottest column")
    p.add_argument("--serve-ab", metavar="DIR",
                   help="the short serving run of checkout DIR and of this "
                   "one in turn, --pairs runs each")
    p.add_argument("--big", action="store_true",
                   help="phase 2, phase 3's B1 and B2 checks, phase 9 (the "
                   "128k round trip) and phase 7 at its shapes")
    p.add_argument("--residency", action="store_true",
                   help="phase 2, then phase 10 (the host and device "
                   "residencies at 32k) alone")
    p.add_argument("--spill", action="store_true",
                   help="phase 2, then phase 11 (the partitioned round trip "
                   "over a recorded stream) and phase 7 at its shapes")
    p.add_argument("--resume", action="store_true",
                   help="phase 2, then phase 6's round trip (warm and timed, "
                   "unprofiled) and phase 12 (telemetry, kill and resume)")
    p.add_argument("--plan", action="store_true",
                   help="phase 2, then phase 6's round trip (warm and timed, "
                   "unprofiled) and phase 13 (the plan compiler and its "
                   "calibration loop)")
    p.add_argument("--delta", action="store_true",
                   help="phase 2, then phase 14 (incremental facet updates "
                   "and the serving fleet) alone")
    p.add_argument("--serve-full", action="store_true",
                   help="phase 8 serves all its batches (default: the first "
                   f"{VIS_SERVED})")
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--root", metavar="DIR",
                   help="import swiftly_tpu_torch from checkout DIR")
    return p.parse_args()


def _big_line(big):
    """Phase 9's JSON record: every key but the per-shape launch counts
    (the `kernels` line's ``paths`` holds them)."""
    return {k: v for k, v in big.items() if k != "counts"}


def big_only_main(torch):
    """``--big``: phase 2, phase 3's B1 and B2 checks and digests, phase 9,
    and phase 7 for B1, B2 and B3 at phase 9's shapes; one ``big`` JSON
    line."""
    for dt in (torch.float32, torch.float64):
        for i, (shape, layout) in enumerate(B1_RAGGED):
            check_colpass(torch, shape, dt, seed=i, layout=layout)
        for i, (shape, layout) in enumerate(B2_RAGGED):
            check_fold(torch, shape, dt, seed=i, layout=layout)
    for shape, seed, want in B1_DIGESTS:
        check_colpass_digest(torch, shape, seed, want)
    for shape, seed, want in B2_DIGESTS:
        check_fold_digest(torch, shape, seed, want)
    big = big_main(torch)
    log(json.dumps({"big": {"streamed_128k": _big_line(big),
                            "kernels": _time_streamed_kernels(torch,
                                                              big)}}))
    return 0


def _time_streamed_kernels(torch, result):
    """Phase 7 for B3, B1 and B2 at the shapes one path's run gave them
    (``result["counts"]``): per kernel its launches, its seconds at the
    timed shapes and each shape's record."""
    checks = {"cmatmul": check_cmatmul, "colpass": check_colpass,
              "fold": check_fold}
    timed = {}
    for kname, check in checks.items():
        launches, shapes = result["counts"][kname]
        if not launches:
            continue
        recs, secs, _ = time_path(torch, check, _by_frequency(shapes))
        timed[kname] = {"launches": launches, "seconds": secs, "shapes": [
            {k: r.get(k) for k in ("shape", "launches", "ms", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by",
                                   "tflops", "max_abs_err")}
            for r in recs]}
    return timed


def spill_only_main(torch):
    """``--spill``: phase 11, then phase 7 for B1, B2 and B3 at its shapes;
    one ``spill_32k`` JSON line."""
    res = spill_main(torch)
    line = _spill_line(res)
    line["kernels"] = _time_streamed_kernels(torch, res)
    log(json.dumps({"spill_32k": line}))
    return 0


def main():
    import torch

    args = _args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
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

    if args.serve_ab:
        return serve_ab_main(args.serve_ab, args.pairs, smi)
    if args.serve_short:
        return serve_short_main(torch, smi, args.tasks_equal)
    build_kernels()
    done("build")
    if args.quick:
        return quick_main(torch)
    if args.b4 or args.b4_digests:
        return b4_main(torch, tree=args.b4)
    if args.big:
        return big_only_main(torch)
    if args.residency:
        res = residency_main(torch)
        done("residency")
        log(json.dumps({"residency_32k": _residency_line(res)}))
        return 0
    if args.spill:
        return spill_only_main(torch)
    if args.resume:
        streamed = streamed_main(torch, profile=False)
        done("streamed")
        res = resume_main(torch, phase6=streamed)
        done("resume")
        log(json.dumps({"resume_32k": _resume_line(res)}))
        return 0
    if args.plan:
        streamed = streamed_main(torch, profile=False)
        done("streamed")
        gc_collect(torch)
        res = plan_main(torch, phase6=streamed)
        done("plan")
        log(json.dumps({"plan_32k": _plan_line(res)}))
        return 0
    if args.delta:
        res = delta_main(torch)
        done("delta")
        line = _delta_line(res)
        line["kernels"] = _time_streamed_kernels(
            torch, {"counts": res["counts_delta"]})
        done("timing")
        log(smi)
        log(json.dumps({"delta_32k": line}))
        return 0
    for dt in (torch.float32, torch.float64):
        for i, shape in enumerate(B3_RAGGED):
            check_cmatmul(torch, shape, dt, seed=i)
        for i, (shape, layout) in enumerate(B1_RAGGED):
            check_colpass(torch, shape, dt, seed=i, layout=layout)
        for i, (shape, layout) in enumerate(B2_RAGGED):
            check_fold(torch, shape, dt, seed=i, layout=layout)
        for i, shape in enumerate(VIS_RAGGED):
            check_degrid(torch, shape, dt, seed=i)
        for i, shape in enumerate(VIS_PUMP_RAGGED):
            check_degrid_rows(torch, shape, dt, seed=i, ragged=True)
        for i, shape in enumerate(GRID_RAGGED):
            check_grid(torch, shape, dt, seed=i)
        for i, shape in enumerate(GRID_WRAPPED):
            check_grid(torch, shape, dt, seed=i, wrap=True)
        check_grid(torch, (700, 8, 61), dt, one_pixel=True)
    for shape, seed, want in B3_DIGESTS:
        check_cmatmul_digest(torch, shape, seed, want)
    for shape, seed, want in B1_DIGESTS:
        check_colpass_digest(torch, shape, seed, want)
    for shape, seed, want in B2_DIGESTS:
        check_fold_digest(torch, shape, seed, want)
    for shape, seed, want in B4_DIGESTS:
        check_degrid_digest(torch, shape, seed, want)
    done("kernels")
    roundtrip_small(torch)
    roundtrip_streamed_small(torch)
    done("small")
    fused = roundtrip_main(torch)
    done("fused")
    streamed = streamed_main(torch)
    done("streamed")
    gc_collect(torch)
    resume = resume_main(torch, phase6=streamed)
    done("resume")
    gc_collect(torch)
    plan13 = plan_main(torch, phase6=streamed)
    done("plan")
    gc_collect(torch)
    delta = delta_main(torch)
    done("delta")
    gc_collect(torch)
    slabs = slabs_main(torch)
    done("slabs")
    gc_collect(torch)
    residency = residency_main(torch)
    done("residency")
    gc_collect(torch)
    spill = spill_main(torch, phase6_digests=streamed["facet_digests"])
    done("spill")
    gc_collect(torch)  # the earlier phases' device state
    vis = vis_main(torch, n_serve=None if args.serve_full else VIS_SERVED)
    done("vis")
    gc_collect(torch)
    big = big_main(torch)
    done("128k")

    # Phase 7: each kernel at the shapes each 32k path gave it.
    checks = {"cmatmul": check_cmatmul, "colpass": check_colpass,
              "fold": check_fold, "degrid": check_degrid_rows,
              "grid": check_grid}
    main_paths = {"cmatmul": "streamed", "colpass": "streamed",
                  "fold": "streamed", "degrid": "vis", "grid": "vis"}
    paths = {k: {} for k in checks}
    timed_shapes = {k: {} for k in checks}
    results = {"fused": fused, "streamed": streamed, "vis": vis,
               "128k": big, "residency": residency,
               "residency_bodies": residency["bodies"], "spill": spill,
               "resume": resume, "plan": plan13,
               "delta": {"counts": delta["counts_delta"]},
               "fleet": {"counts": delta["counts_fleet"]}}
    for path, result in results.items():
        for kname, (launches, shapes) in result["counts"].items():
            if launches == 0:
                continue
            timed, secs, covered = time_path(
                torch, checks[kname],
                _varied_shapes(shapes) if kname in ("grid", "degrid")
                else _by_frequency(shapes),
                done=timed_shapes[kname])
            paths[kname][path] = (launches, timed)
            result[f"{kname}_seconds"] = secs
            log(f"{kname} device time in the {path} run: {secs:.3f} s over "
                f"{covered} of its {launches} launches (the timed shapes)")
    done("timing")
    kernels = {"kernels": [_kernel_record(k, paths[k], main_paths[k])
                           for k in checks]}
    log(json.dumps({"roundtrip": {k: fused[k] for k in (
        "config", "forward_s", "backward_s", "peak_memory_gib",
        "forward_tflops_per_s", "backward_tflops_per_s", "launches",
        "cmatmul_seconds", "max_subgrid_rms", "max_facet_rms")}}))
    log(json.dumps({"streamed_roundtrip": {k: streamed[k] for k in (
        "config", "forward_s", "backward_s", "col_group", "n_groups",
        "fold_group", "peak_memory_gib", "forward_tflops_per_s",
        "backward_tflops_per_s", "launches", "cmatmul_seconds",
        "colpass_seconds", "fold_seconds", "facet_upload_s", "sampled_pass_s",
        "profiled_window_s", "profiled_forward_s", "profiled_device_busy_s",
        "profiled_idle_share", "max_subgrid_rms", "max_facet_rms",
        "bit_identical_to_warm_run")}}))
    log(json.dumps({"slabs_32k": slabs}))
    log(json.dumps({"residency_32k": _residency_line(residency)}))
    log(json.dumps({"spill_32k": _spill_line(spill)}))
    log(json.dumps({"resume_32k": _resume_line(resume)}))
    log(json.dumps({"streamed_128k": _big_line(big)}))
    log(json.dumps({"plan_32k": _plan_line(plan13)}))
    log(json.dumps({"delta_32k": _delta_line(delta)}))
    vis_line = {k: vis[k] for k in (
        "config", "samples", "batches", "served_batches",
        "submitted_samples", "serve_s", "samples_per_s", "p50_ms",
        "p99_ms", "dispatches", "mean_batch", "served_samples",
        "shed_reasons", "rows_from_cache", "rows_computed",
        "column_extractions", "grid_s", "ingest_s", "launches",
        "serve_launches", "peak_memory_gib", "oracle_rel_rms", "adjoint_rel",
        "max_dispatch", "bitcheck_samples", "grid_traced_s",
        "grid_traced_launches", "profiled_batches", "profiled_samples",
        "profiled_dispatches", "profiled_mean_batch",
        "profiled_rows_from_cache", "profiled_window_s",
        "profiled_device_busy_s", "profiled_idle_share", "profiled_pumps",
        "profiled_degrid_s", "profiled_degrid_launches", "profiled_cmatmul_s",
        "pumps", "serve_b4_launches")}
    for kname in ("degrid", "grid", "cmatmul", "colpass", "fold"):
        launches, timed = paths[kname]["vis"]
        covered = sum(r["launches"] for r in timed)
        vis_line[kname] = {
            "launches": launches, "timed_launches": covered,
            "seconds_at_timed_shapes": vis[f"{kname}_seconds"],
            "top_shape": timed[0]["shape"], "ms": timed[0]["ms"],
            "call_ms": timed[0].get("call_ms"),
            "bound_ms": timed[0]["bound_ms"]}
    log(f"[total {time.perf_counter() - t_start:.1f} s]")
    log(smi)
    log(json.dumps({"vis": vis_line}))
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
