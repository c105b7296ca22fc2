"""Analytic FLOP accounting for the planar matmul-FFT pipeline, and the
choice of the streamed bodies.

The counting functions of the JAX package's ``swiftly_tpu/utils/flops.py``
for the batched (fused whole-cover) path and the streamed stages: every
compute op of the planar backend is a matmul (or elementwise op) of
statically known shape, so the FLOP count of a whole transform is exact.

``resolve_colpass`` / ``resolve_colpass_bwd`` / ``resolve_fold_kernel``
pick the body of the streamed column passes and of the sampled fold by
backend: "kernel" (the hand-written kernels B1 and B2, which contract
split real/imaginary planes) for the planar backend, "einsum" (complex
``torch.einsum`` products) for the complex "torch" backend. On the card
the kernel bodies launch B1 and B2; on the CPU the same bodies run, and
the kernels' wrappers take their plain versions there.

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
    "bwd_column_pass_flops",
    "bwd_fold_flops",
    "column_pass_flops",
    "fft_flops",
    "forward_batched_flops",
    "resolve_colpass",
    "resolve_colpass_bwd",
    "resolve_fold_kernel",
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


def resolve_colpass(core, n_facets_in_program: int) -> str:
    """The forward column-pass body: "kernel" (B1, ``reduce_f=True``) for
    the planar backend, "einsum" for the complex backend.
    `n_facets_in_program` is kept for the reference's signature; every
    facet count takes the same body."""
    return _body(core)


def resolve_colpass_bwd(core, n_facets_in_program: int) -> str:
    """The backward column-pass body, by the forward's rule (B1 with
    ``reduce_f=False``)."""
    return _body(core)


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
    [F, m, yB]): two K = xM complex products per (subgrid, facet) (the
    einsum pair, or B1 with ``reduce_f=False``: the same contractions),
    the scatter-add, and the per-column axis-1 finish."""
    m, xM, yN = core.xM_yN_size, core.xM_size, core.yN_size
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
