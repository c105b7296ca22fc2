"""Analytic FLOP accounting for the planar matmul-FFT pipeline.

The counting functions of the JAX package's ``swiftly_tpu/utils/flops.py``
for the batched (fused whole-cover) path: every compute op of the planar
backend is a matmul (or elementwise op) of statically known shape, so the
FLOP count of a whole transform is exact.

Conventions: one multiply-add = 2 FLOPs; counts follow the "4mul" complex
product (4 real matmuls per complex matmul); elementwise twiddle, phase
and window multiplies are included (6 FLOPs per complex point).
"""

from __future__ import annotations

from ..ops.planar_backend import _DIRECT_MAX, _factor

__all__ = [
    "H100_F32_TFLOPS",
    "H100_HBM_TB_PER_S",
    "backward_batched_flops",
    "fft_flops",
    "forward_batched_flops",
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


def _per_subgrid_flops(core, subgrid_size: int, n_facets: int) -> int:
    """FLOPs to turn one column's NMBF_BFs into one finished subgrid.

    Per facet, add_to_subgrid axis 0 (fft size m over m rows) and axis 1
    (fft size m over xM rows) plus the Fn windows; then one
    finish_subgrid (ifft size xM over xM rows, crop, ifft size xM over
    xA rows, crop).
    """
    m, xM = core.xM_yN_size, core.xM_size
    per_facet = (
        fft_flops(m, m) + 6 * m * m  # axis 0 fft + Fn window
        + fft_flops(m, xM) + 6 * xM * m  # axis 1 fft + Fn window
    )
    finish = fft_flops(xM, xM) + fft_flops(xM, subgrid_size)
    # facet-sum (2 adds per complex point per facet) + masks
    reduce_mask = 2 * (n_facets - 1) * xM * xM + 4 * subgrid_size**2
    return n_facets * per_facet + finish + reduce_mask


def _column_prepare_flops(core, n_facets: int) -> int:
    """Axis-1 preparation of one column's rows: per facet, Fb window +
    ifft size yN over m rows."""
    m, yN = core.xM_yN_size, core.yN_size
    return n_facets * (fft_flops(yN, m) + 6 * m * yN)


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
