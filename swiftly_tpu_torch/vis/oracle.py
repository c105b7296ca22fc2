"""Direct-DFT visibility oracle — the accuracy reference (a copy of the
JAX package's ``swiftly_tpu/vis/oracle.py``).

The grid convention is `ops.oracle.make_subgrid_from_sources` extended
off the integer lattice: a subgrid pixel at integer (u, v) is

    G[u, v] = (1/N^2) * sum_s I_s * exp(+2 pi i (u x_s + v y_s) / N)

so the continuous visibility at arbitrary (u, v) is the same sum with
fractional coordinates. `vis_oracle` evaluates it directly (O(B * S),
vectorised over samples) and is what chip_smoke.py's phase 8 and
tests/test_torch_vis.py audit degridded samples against.

`corrected_sources` re-exports the kernel's grid correction: the sky
model the ENGINE should transform (facets built from the corrected
sources) so that degrid output approximates the TRUE visibilities of
the uncorrected model — see docs/visibility.md for why the correction
lives in image space.
"""

from __future__ import annotations

import numpy as np

__all__ = ["corrected_sources", "vis_oracle"]


def vis_oracle(sources, uv, N):
    """Direct-DFT visibilities of a point-source sky model.

    :param sources: [(intensity, x, y), ...] centre-relative pixels
        (the `ops.oracle` source convention)
    :param uv: [B, 2] fractional grid coordinates
    :param N: image/grid size
    :return: [B] complex128 visibilities
    """
    uv = np.atleast_2d(np.asarray(uv, dtype=float))
    out = np.zeros(uv.shape[0], dtype=complex)
    for (w, x, y) in sources:
        out += (w / N**2) * np.exp(
            2j * np.pi * (uv[:, 0] * x + uv[:, 1] * y) / N
        )
    return out


def corrected_sources(kernel, sources, N):
    """Grid-corrected sky model for serving through ``kernel`` —
    `vis.kernel.VisKernel.correct_sources` under its smoke-run/test name."""
    return kernel.correct_sources(sources, N)
