"""PSWF-derived separable degridding kernel (host-side precompute).

A plain copy of the JAX package's ``swiftly_tpu/vis/kernel.py`` (numpy and
scipy only): the same (support, oversample, band) gives the same tap table,
bit for bit (``tests/test_torch_vis.py``).

Visibility serving answers arbitrary fractional (u, v) samples off the
integer-pixel subgrid rows the engine already serves. Truncated-support
interpolation of a DFT is fundamentally limited unless the IMAGE is
pre-shaped for it, so the kernel here is the classical gridding pair:

* **Grid correction (image space)** — the sky model is divided, per
  axis, by the kernel's *taper* (its continuous Fourier transform), so
  the grid the engine computes carries exactly the spectrum the
  truncated kernel can reconstruct. `grid_correction` /
  `correct_sources` apply it; `vis.oracle.corrected_sources` is the
  smoke-run/test entry.
* **Interpolation weights (grid space)** — for each sub-pixel fraction
  ``f`` the ``support`` weights are the least-squares solution of

      sum_d  c_d  exp(2 pi i d xi)  ~=  taper(xi) exp(2 pi i f xi)

  over the represented image band ``|xi| <= band / 2`` (xi = x / N).
  The target carries the taper, so interpolation error and correction
  cancel to quadrature accuracy instead of compounding. The taper is
  the quadrature Fourier transform of the same zeroth-order PSWF window
  `ops.pswf` builds the facet machinery from (``c = pi W / 2``,
  ``psi(2 t / W)`` on ``|t| <= W/2``) — the anti-aliasing pedigree the
  paper's window brings carries over to the serving path unchanged.

The weights are tabulated at ``oversample`` fractions and linearly
interpolated at lookup (`weights`). Measured worst-case relative error
of the full degrid path against the direct DFT (W = 8, oversample
= 128): 3.2e-5 at band 0.5, 8.2e-4 at band 0.75 — the documented
serving tolerance is ``DEGRID_TOLERANCE`` (1e-3) for sky models inside
``band <= 0.75``; see docs/visibility.md for the derivation and the
accuracy table.

Everything here is host-side numpy/scipy, evaluated once per
(support, oversample, band) and cached — the device-facing batch math
lives in `vis.degrid` / `vis.grid`.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.special

__all__ = [
    "DEGRID_TOLERANCE",
    "MAX_BAND",
    "VisKernel",
    "vis_kernel",
]

# The exactness contract of the visibility path: relative RMS of
# degridded samples against the direct-DFT oracle, for band-limited
# sky models (|x|/N <= MAX_BAND / 2) served with the default kernel.
# Pinned by tests/test_torch_vis.py and gated by chip_smoke.py's phase 8.
DEGRID_TOLERANCE = 1e-3
MAX_BAND = 0.75

# pro_ang1 chunking, same reliability bound as ops.pswf._CHUNK
_CHUNK = 500


class VisKernel:
    """One precomputed separable degridding kernel.

    :param support: tap count W per axis (even; the taps sit at
        ``floor(u) + d`` for ``d in [-(W/2 - 1), W/2]``)
    :param oversample: tabulated sub-pixel fractions per pixel
    :param band: represented image band as a fraction of N — sources
        outside ``|x| / N <= band / 2`` are outside the fit and carry
        no accuracy guarantee
    """

    def __init__(self, support=8, oversample=128, band=MAX_BAND):
        support = int(support)
        if support < 4 or support % 2:
            raise ValueError(
                f"support must be an even integer >= 4, got {support}"
            )
        if not 0.0 < band <= MAX_BAND:
            raise ValueError(
                f"band must be in (0, {MAX_BAND}], got {band}"
            )
        self.support = support
        self.oversample = int(oversample)
        self.band = float(band)
        self.tolerance = DEGRID_TOLERANCE
        # tap offsets relative to floor(u): patch rows are gathered at
        # u0 + taps, so a sample needs taps[0]..taps[-1] inside its
        # owning subgrid span (vis.mapping enforces it)
        self.taps = np.arange(-(support // 2 - 1), support // 2 + 1)
        self._c = np.pi * support / 2
        self._taper_t, self._taper_w = self._quadrature()
        self.table = self._fit_table()

    # -- PSWF taper -------------------------------------------------

    def _psi(self, x):
        """psi_00 on |x| <= 1, chunked (pro_ang1 misbehaves on large
        fills, see ops.pswf)."""
        x = np.asarray(x, dtype=float)
        out = np.empty_like(x)
        for lo in range(0, x.size, _CHUNK):
            hi = min(lo + _CHUNK, x.size)
            out[lo:hi] = scipy.special.pro_ang1(
                0, 0, self._c, x[lo:hi]
            )[0]
        return out

    def _quadrature(self, n=1024):
        """Midpoint quadrature nodes/weights of psi(2t/W) over
        |t| <= W/2 — the taper integrand."""
        half = self.support / 2
        dt = self.support / n
        t = -half + dt * (np.arange(n) + 0.5)
        w = self._psi(t / half) * dt
        return t, w

    def taper(self, xi):
        """Continuous Fourier transform of the window at image
        coordinate(s) ``xi = x / N`` (real and even — psi is even)."""
        xi = np.asarray(xi, dtype=float)
        out = (
            np.cos(2 * np.pi * xi.reshape(-1, 1) * self._taper_t)
            @ self._taper_w
        ).reshape(xi.shape)
        return float(out) if xi.ndim == 0 else out

    # -- weight table -----------------------------------------------

    def _fit_table(self):
        """[oversample + 1, support] least-squares weights, one row per
        tabulated fraction f = i / oversample (row oversample = f -> 1
        duplicates f -> 0 shifted one pixel; kept so the linear lookup
        never wraps)."""
        n_xi = 4 * self.support + 1
        xi = np.linspace(-self.band / 2, self.band / 2, n_xi)
        tap_phase = np.exp(2j * np.pi * np.outer(xi, self.taps))
        A = np.concatenate([tap_phase.real, tap_phase.imag])
        taper = self.taper(xi)
        table = np.empty(
            (self.oversample + 1, self.support), dtype=float
        )
        for i in range(self.oversample + 1):
            f = i / self.oversample
            b_c = taper * np.exp(2j * np.pi * f * xi)
            b = np.concatenate([b_c.real, b_c.imag])
            table[i] = np.linalg.lstsq(A, b, rcond=None)[0]
        return table

    def weights(self, frac, dtype=np.float32):
        """Per-sample tap weights by linear interpolation of the
        oversampled table.

        :param frac: [B] sub-pixel fractions in [0, 1)
        :return: [B, support] weights, ``dtype``
        """
        frac = np.asarray(frac, dtype=float)
        a = np.clip(frac, 0.0, np.nextafter(1.0, 0.0)) * self.oversample
        i0 = a.astype(int)
        t = (a - i0)[:, None]
        return (
            self.table[i0] * (1.0 - t) + self.table[i0 + 1] * t
        ).astype(dtype)

    # -- grid correction --------------------------------------------

    def grid_correction(self, x, N):
        """Per-axis image-plane correction divisor at pixel offset(s)
        ``x`` from centre: ``taper(x / N)``."""
        return self.taper(np.asarray(x, dtype=float) / N)

    def correct_sources(self, sources, N):
        """Sky-model sources with the separable grid correction applied
        (intensity divided by ``taper(x/N) * taper(y/N)``) — the image
        the engine should transform so degridded samples approximate
        the TRUE visibilities of the input model.

        :param sources: [(intensity, x, y), ...] centre-relative pixels
        :raises ValueError: when a source lies outside the kernel band
            (no accuracy guarantee exists there — widen ``band`` or
            shrink the model instead of serving silently-wrong samples)
        """
        out = []
        for (w, x, y) in sources:
            if max(abs(x), abs(y)) > self.band * N / 2:
                raise ValueError(
                    f"source at ({x}, {y}) outside the kernel band "
                    f"(|x| <= {self.band * N / 2:.0f} for band "
                    f"{self.band} at N={N})"
                )
            out.append(
                (
                    w
                    / (
                        self.grid_correction(x, N)
                        * self.grid_correction(y, N)
                    ),
                    x,
                    y,
                )
            )
        return out

    def as_dict(self):
        """JSON-ready stamp of the kernel's parameters."""
        return {
            "support": self.support,
            "oversample": self.oversample,
            "band": self.band,
            "tolerance": self.tolerance,
        }

    def __repr__(self):
        return (
            f"VisKernel(support={self.support}, "
            f"oversample={self.oversample}, band={self.band})"
        )


@functools.lru_cache(maxsize=8)
def vis_kernel(support=8, oversample=128, band=MAX_BAND):
    """Cached `VisKernel` — the table fit costs ~0.1 s of scipy/lstsq
    per (support, oversample, band), paid once per process."""
    return VisKernel(support, oversample, band)
