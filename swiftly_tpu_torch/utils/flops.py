"""Analytic FLOP accounting for the planar matmul-FFT pipeline, and the
choice of the streamed bodies.

The counting functions of the JAX package's ``swiftly_tpu/utils/flops.py``
for the batched (fused whole-cover) path and the streamed stages: every
compute op of the planar backend is a matmul (or elementwise op) of
statically known shape, so the FLOP count of a whole transform is exact.

``resolve_colpass`` / ``resolve_colpass_bwd`` pick the body of the
streamed column passes, ``resolve_fold_mode`` the sampled backward's fold
and ``resolve_fold_kernel`` the sampled fold's body. They read the JAX
package's knobs, with its values and errors: ``SWIFTLY_COLPASS``
(einsum|fft|pallas|auto), ``SWIFTLY_COLPASS_BWD`` (einsum|fft|pallas) and
``SWIFTLY_FOLD`` (ct|fft|sampled|auto). "pallas" names the hand-written
column-pass kernel B1, which contracts split real/imaginary planes: on
the planar backend it resolves to "kernel", on the complex backend to
"einsum", as the JAX package degrades it. Unset or "auto", the body goes
by backend: "kernel" (B1, and B2 for the sampled fold) for the planar
backend, "einsum" (complex ``torch.einsum`` products) for the complex
"torch" backend. On the card the kernel bodies launch B1 and B2; on the
CPU the same bodies run, and the kernels' wrappers take their plain
versions there.

Conventions: one multiply-add = 2 FLOPs; counts follow the "4mul" complex
product (4 real matmuls per complex matmul); elementwise twiddle, phase
and window multiplies are included (6 FLOPs per complex point).
"""

from __future__ import annotations

import os

from ..ops.planar_backend import _DIRECT_MAX, _factor

__all__ = [
    "H100_F32_TFLOPS",
    "H100_HBM_TB_PER_S",
    "backward_batched_flops",
    "backward_sampled_flops",
    "bwd_column_pass_flops",
    "bwd_fold_flops",
    "colpass_mode",
    "column_pass_flops",
    "fft_flops",
    "forward_batched_flops",
    "forward_sampled_flops",
    "peak_tflops",
    "resolve_colpass",
    "resolve_colpass_bwd",
    "resolve_fold_kernel",
    "resolve_fold_mode",
    "sampled_facet_pass_flops",
]

# Peak float32 rate of one H100 SXM outside the tensor cores (FMA on the
# CUDA cores), TFLOP/s, at the 700 W power limit: NVIDIA H100 Tensor Core
# GPU data sheet. The planar pipeline's products are full f32 (no TF32),
# so this is the rate its kernels are held against.
H100_F32_TFLOPS = 67.0
# Its HBM3 memory rate, TB/s (same data sheet): the bytes side of a
# kernel's bound.
H100_HBM_TB_PER_S = 3.35


def fft_flops(n: int, batch: int) -> int:
    """FLOPs of one planar matmul (i)FFT of size n over `batch` rows.

    Direct (n <= 1024): 4 real [batch, n] x [n, n] matmuls.
    Factored n = n1*n2: two matmul rounds (8*batch*n*(n1+n2)) plus the
    elementwise twiddle (6 per complex point).
    """
    if n <= _DIRECT_MAX:
        return 8 * batch * n * n
    n1, n2 = _factor(n)
    return 8 * batch * n * (n1 + n2) + 6 * batch * n


def _body(core) -> str:
    return "kernel" if getattr(core, "backend", "") == "planar" else "einsum"


def colpass_mode() -> str:
    """The forward column-pass setting ``SWIFTLY_COLPASS``
    (einsum|fft|pallas|auto, default auto), read at each call."""
    mode = os.environ.get("SWIFTLY_COLPASS", "auto")
    if mode not in ("einsum", "fft", "pallas", "auto"):
        raise ValueError(
            f"SWIFTLY_COLPASS must be einsum|fft|pallas|auto, got {mode!r}"
        )
    return mode


def resolve_colpass(core, n_facets_in_program: int) -> str:
    """The forward column-pass body: "kernel" (B1, ``reduce_f=True``),
    "einsum" (the operator einsums) or "fft" (the per-facet FFT chain).
    ``SWIFTLY_COLPASS=pallas`` is B1 on the planar backend and the einsum
    body on the complex one; "auto" goes by backend. Every facet count
    `n_facets_in_program` takes the same body (kept for the reference's
    signature)."""
    mode = colpass_mode()
    return mode if mode in ("einsum", "fft") else _body(core)


def resolve_colpass_bwd(core, n_facets_in_program: int) -> str:
    """The backward column-pass body: ``SWIFTLY_COLPASS_BWD`` if set
    (einsum|fft|pallas; "pallas" as in `resolve_colpass`), else by
    backend (B1 with ``reduce_f=False`` for the planar backend)."""
    mode = os.environ.get("SWIFTLY_COLPASS_BWD", "")
    if mode and mode not in ("einsum", "fft", "pallas"):
        raise ValueError(
            f"SWIFTLY_COLPASS_BWD must be einsum|fft|pallas, got {mode!r}"
        )
    if mode in ("einsum", "fft"):
        return mode
    return _body(core)


def resolve_fold_mode() -> str:
    """The sampled backward's fold: ``SWIFTLY_FOLD`` = sampled | ct | fft
    | auto (default auto, which is "sampled"), read when the backward is
    made."""
    mode = os.environ.get("SWIFTLY_FOLD", "auto")
    if mode not in ("ct", "fft", "sampled", "auto"):
        raise ValueError(
            f"SWIFTLY_FOLD must be ct|fft|sampled|auto, got {mode!r}"
        )
    return "sampled" if mode == "auto" else mode


def resolve_fold_kernel(core) -> str:
    """The sampled fold's body: "kernel" (B2) for the planar backend, the
    complex "einsum" fold for the complex backend."""
    return _body(core)


def _per_subgrid_flops(core, subgrid_size: int, n_facets: int,
                       colpass: str = "fft") -> int:
    """FLOPs to turn one column's NMBF_BFs into one finished subgrid.

    ``colpass="fft"`` (the batched path): per facet, add_to_subgrid axis 0
    (fft size m over m rows) and axis 1 (fft size m over xM rows) plus the
    Fn windows; then one finish_subgrid (ifft size xM over xM rows, crop,
    ifft size xM over xA rows, crop).

    ``colpass="einsum"``: one complex [xM, F*m] x [F*m, xM] contraction;
    the finish is a crop + masks. The per-program operator build is
    excluded (understating, never overstating, the achieved rate).

    ``colpass="kernel"``: B1 runs the prepare matmul per subgrid: per
    facet a complex [xM, m] x [m, m] then [xM, m] x [m, xM] product.
    """
    m, xM = core.xM_yN_size, core.xM_size
    if colpass == "einsum":
        return 8 * xM * xM * n_facets * m + 4 * subgrid_size**2
    if colpass == "kernel":
        return 8 * xM * m * (m + xM) * n_facets + 4 * subgrid_size**2
    per_facet = (
        fft_flops(m, m) + 6 * m * m  # axis 0 fft + Fn window
        + fft_flops(m, xM) + 6 * xM * m  # axis 1 fft + Fn window
    )
    finish = fft_flops(xM, xM) + fft_flops(xM, subgrid_size)
    # facet-sum (2 adds per complex point per facet) + masks
    reduce_mask = 2 * (n_facets - 1) * xM * xM + 4 * subgrid_size**2
    return n_facets * per_facet + finish + reduce_mask


def _column_prepare_flops(core, n_facets: int, colpass: str = "fft") -> int:
    """Axis-1 preparation of one column's rows: per facet, Fb window +
    ifft size yN over m rows; the einsum body adds its hoisted
    H = A0 @ NMBF_BF contraction ([xM, m] x [m, yN] per facet), which the
    kernel body fuses into its per-subgrid product."""
    m, yN = core.xM_yN_size, core.yN_size
    base = n_facets * (fft_flops(yN, m) + 6 * m * yN)
    if colpass == "einsum":
        base += n_facets * 8 * core.xM_size * m * yN
    return base


# -- per-stage counts of the streamed path ------------------------------------


def sampled_facet_pass_flops(core, n_facets: int, facet_size: int,
                             n_rows: int, real_facets: bool = False) -> int:
    """FLOPs of one sampled-DFT facet pass extracting `n_rows` rows from
    `n_facets` resident facets (one column group; `n_rows` = G*m).
    ``real_facets`` halves the products (no imaginary plane)."""
    yB = facet_size
    mm = 4 if real_facets else 8
    return mm * n_rows * yB * (n_facets * yB) + 6 * n_facets * n_rows * yB


def column_pass_flops(core, n_facets: int, n_subgrids: int,
                      subgrid_size: int, colpass: str = "fft") -> int:
    """FLOPs of one forward column pass (axis-1 preparation plus the
    column's `n_subgrids` subgrids) for the body that runs."""
    return _column_prepare_flops(core, n_facets, colpass) + (
        n_subgrids * _per_subgrid_flops(core, subgrid_size, n_facets, colpass)
    )


def bwd_column_pass_flops(core, n_facets: int, n_subgrids: int,
                          facet_size: int, subgrid_size: int,
                          colpass: str = "einsum") -> int:
    """FLOPs of one backward column pass (subgrid column -> rows
    [F, m, yB]) for the body that runs: "einsum" or "kernel", two K = xM
    complex products per (subgrid, facet) (the einsum pair, or B1 with
    ``reduce_f=False``: the same contractions) and the scatter-add; "fft",
    the subgrid's prepare (two FFTs) and per facet the two extracting
    iFFTs with their windows, the first over the prepared subgrid's xM
    rows (the JAX package's count takes m rows there: ROADMAP C); then
    the per-column axis-1 finish."""
    m, xM, yN = core.xM_yN_size, core.xM_size, core.yN_size
    if colpass == "fft":
        per_sg = fft_flops(xM, subgrid_size) + fft_flops(xM, xM)
        per_sg += n_facets * (
            fft_flops(m, xM) + 6 * m * xM + fft_flops(m, m) + 6 * m * m
        )
    else:
        per_sg = n_facets * 8 * (m * xM * xM + m * m * xM)
        per_sg += n_facets * 2 * m * yN
    col_fin = n_facets * (fft_flops(yN, m) + 6 * m * facet_size)
    return n_subgrids * per_sg + col_fin


def bwd_fold_flops(core, n_facets: int, facet_size: int, n_rows: int) -> int:
    """FLOPs of one adjoint sampled fold of `n_rows` concatenated column
    rows into the [F, yB, yB] image accumulator (`n_rows` = P*m)."""
    yB = facet_size
    return 8 * n_rows * yB * (n_facets * yB) + 6 * n_facets * n_rows * yB


def forward_batched_flops(
    core, n_facets: int, facet_size: int, n_columns: int,
    subgrids_per_column: int, subgrid_size: int,
) -> int:
    """Total FLOPs of the batched whole-cover forward transform:
    prepare_facets (once) + per-column extraction/preparation + per-subgrid
    summation/finish (`parallel.batched.forward_all_batch`)."""
    yN = core.yN_size
    prepare = n_facets * (fft_flops(yN, facet_size) + 6 * facet_size * yN)
    columns = n_columns * _column_prepare_flops(core, n_facets)
    subgrids = (
        n_columns
        * subgrids_per_column
        * _per_subgrid_flops(core, subgrid_size, n_facets)
    )
    return prepare + columns + subgrids


def backward_batched_flops(
    core, n_facets: int, facet_size: int, n_columns: int,
    subgrids_per_column: int, subgrid_size: int,
) -> int:
    """Total FLOPs of the batched whole-cover backward transform.

    Per subgrid: prepare_subgrid (two ffts) + per-facet extraction (two
    iffts + Fn windows); per column: per-facet axis-1 finish
    (fft size yN over m rows) + Fb window; finish: per-facet axis-0
    finish (fft size yN over yB rows).

    The axis-0 extraction's iFFT (size m) runs over the xM rows of the
    prepared subgrid: the JAX package's count (``swiftly_tpu/utils/
    flops.py:346``) takes m rows there and is short by 8*m*m*(xM - m)
    per (subgrid, facet).
    """
    m, xM, yN = core.xM_yN_size, core.xM_size, core.yN_size
    prep = fft_flops(xM, subgrid_size) + fft_flops(xM, xM)
    extract = n_facets * (
        fft_flops(m, xM) + 6 * m * xM + fft_flops(m, m) + 6 * m * m
    )
    per_sg = prep + extract
    col_fin = n_facets * (
        fft_flops(yN, m) + 6 * m * facet_size
    )
    facet_fin = n_facets * (
        fft_flops(yN, facet_size) + 6 * facet_size * yN
    )
    return (
        n_columns * subgrids_per_column * per_sg
        + n_columns * col_fin
        + facet_fin
    )


def forward_sampled_flops(
    core, n_facets: int, facet_size: int, n_columns: int,
    subgrids_per_column: int, subgrid_size: int,
    real_facets: bool = False, finish_passes: int = 1,
    colpass: str | None = None,
) -> int:
    """Total FLOPs of the streamed sampled forward (``residency="device"``).

    The facet pass: one [R, yB] x [F*yB, yB] complex product with R = C*m
    sampled rows, plus the per-facet diagonal phase; the column passes as
    `column_pass_flops` counts them for the body that runs (`colpass`,
    default ``resolve_colpass``). ``real_facets`` halves the facet pass's
    products (no imaginary plane). ``finish_passes``: the facet-slab
    stream of the FFT body finishes each subgrid once per slab; the
    operator bodies ("einsum", "kernel") finish with a crop, so repeats
    cost nothing there.
    """
    yB = facet_size
    xM = core.xM_size
    m = core.xM_yN_size
    if colpass is None:
        colpass = resolve_colpass(core, n_facets)
    facet_pass = sampled_facet_pass_flops(
        core, n_facets, yB, n_columns * m, real_facets=real_facets
    )
    columns = n_columns * _column_prepare_flops(core, n_facets, colpass)
    subgrids = (
        n_columns
        * subgrids_per_column
        * _per_subgrid_flops(core, subgrid_size, n_facets, colpass)
    )
    if colpass in ("einsum", "kernel"):
        extra_finish = 0
    else:
        extra_finish = (
            (finish_passes - 1)
            * n_columns
            * subgrids_per_column
            * (fft_flops(xM, xM) + fft_flops(xM, subgrid_size)
               + 4 * subgrid_size**2)
        )
    return facet_pass + columns + subgrids + extra_finish


def backward_sampled_flops(
    core, n_facets: int, facet_size: int, n_columns: int,
    subgrids_per_column: int, subgrid_size: int,
    colpass: str | None = None,
) -> int:
    """Total FLOPs of the streamed sampled backward
    (``residency="sampled"``): the column passes (`bwd_column_pass_flops`
    for the body that runs, default ``resolve_colpass_bwd``), the adjoint
    sampled fold over all R = n_columns*m rows (`bwd_fold_flops`) and the
    finish mask."""
    m = core.xM_yN_size
    yB = facet_size
    if colpass is None:
        colpass = resolve_colpass_bwd(core, n_facets)
    columns = n_columns * bwd_column_pass_flops(
        core, n_facets, subgrids_per_column, yB, subgrid_size, colpass
    )
    fold = bwd_fold_flops(core, n_facets, yB, n_columns * m)
    finish_mask = 2 * n_facets * yB * yB
    return columns + fold + finish_mask


def peak_tflops(device=None) -> float | None:
    """The peak rate, TFLOP/s, that stage MFU is held against, or None.

    ``SWIFTLY_PEAK_TFLOPS`` when set; otherwise `H100_F32_TFLOPS` when the
    CUDA device (`device`, default the current one) is an H100 (the
    pipeline's products are IEEE f32 on the CUDA cores), and None for any
    other card, or where CUDA is not available.
    """
    env = os.environ.get("SWIFTLY_PEAK_TFLOPS")
    if env:
        return float(env)
    import torch

    if not torch.cuda.is_available():
        return None
    if device is not None and torch.device(device).type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return H100_F32_TFLOPS if "H100" in name else None
