"""
The yardstick's work counts and peaks: what the imaging algorithm has to
do for one call, whatever kernels the program does it with, and the least
time an NVIDIA H100 could take for it.

Frozen copies, so that a later change to the program cannot move the
yardstick:

* the peaks and :func:`bound_seconds` of ``chip_smoke.py:bound``;
* the w-stacking geometry the planner derives from the configuration
  (``ops/kernels.py:kernel_support_for_epsilon``,
  ``ops/plan.py:next_even_grid_size``, ``nm1_min_of``,
  ``resolve_sigma`` and the plane count of ``make_plan``);
* ``chip_smoke.py:gridding_work``'s formula, counted over the dataset's
  visibilities instead of the plan's slots (padding and duplicated
  straddlers are overhead, not work), and ``b2_work``'s FFT count over
  a whole 2-D transform a w-plane.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

#: Published peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

SPEED_OF_LIGHT = 299792458.0

#: The planner's sigma="auto" cost model (only the ratio matters).
SIGMA_COST_GRID_PER_VIS_PLANE = 1.7e-9
SIGMA_COST_FFT_PER_CELL_PLANE = 3.3e-10
SIGMA_CANDIDATES = (2.0, 1.5)


def bound_seconds(nbytes: float, flops: float) -> float:
    """Least time: ``nbytes`` at the HBM rate or ``flops`` float32
    operations at the FP32 rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def kernel_support_for_epsilon(epsilon: float, sigma: float) -> int:
    """Cells per axis of the ES kernel for accuracy ``epsilon``."""
    digits = -np.log10(epsilon)
    rate = np.sqrt(2.0 * (1.0 - 1.0 / sigma))
    support = int(np.ceil(digits / rate)) + 2
    if sigma < 1.6:
        support += 1
    return int(np.clip(support, 4, 16))


def next_even_grid_size(n: int) -> int:
    """Smallest even 7-smooth integer >= n."""
    n = max(int(n), 2)
    while True:
        m = n
        for p in (2, 3, 5, 7):
            while m % p == 0:
                m //= p
        if m == 1 and n % 2 == 0:
            return n
        n += 1


def nm1_min_of(num_pixels: int, pixel_size_lm: float) -> float:
    """``n - 1`` at the image's corner."""
    half_fov = (num_pixels / 2) * pixel_size_lm
    corner_r2 = min(2.0 * half_fov * half_fov, 0.999)
    return -corner_r2 / (1.0 + np.sqrt(1.0 - corner_r2))


def w_range(uvw: np.ndarray, freqs: np.ndarray) -> tuple[float, float]:
    """(min, max) of |w| in wavelengths over every (row, channel)."""
    w = np.abs(np.asarray(uvw, np.float64)[:, 2])
    scale = np.asarray(freqs, np.float64) / SPEED_OF_LIGHT
    return float(w.min() * scale.min()), float(w.max() * scale.max())


def _planes(w_extent: float, nm1_min: float, sigma: float,
            support: int) -> int:
    dw = 1.0 / (sigma * abs(nm1_min))
    return int(np.floor(w_extent / dw)) + support


@dataclass(frozen=True)
class Geometry:
    """What w-stacking at the configuration's accuracy needs for one
    set of visibilities: oversampling, kernel support, padded grid,
    number of w-planes and the visibilities themselves."""

    sigma: float
    support: int
    ngrid: int
    nplanes: int
    npix: int
    nvis: int


def geometry(uvw, freqs, npix: int, pixel_size_lm: float, *,
             epsilon: float, sigma) -> Geometry:
    """The planner's geometry, sigma="auto" resolved by its cost model."""
    nvis = len(uvw) * len(freqs)
    wmin, wmax = w_range(uvw, freqs)
    nm1_min = nm1_min_of(npix, pixel_size_lm)

    def size(s: float) -> tuple:
        support = kernel_support_for_epsilon(epsilon, s)
        ngrid = next_even_grid_size(int(np.ceil(s * npix)))
        return support, ngrid, _planes(wmax - wmin, nm1_min, s, support)

    if sigma == "auto":
        def cost(s: float) -> float:
            support, ngrid, nplanes = size(s)
            return (nvis * support * SIGMA_COST_GRID_PER_VIS_PLANE
                    + nplanes * ngrid * ngrid * SIGMA_COST_FFT_PER_CELL_PLANE)

        sigma = min(SIGMA_CANDIDATES, key=cost)
    sigma = float(sigma)
    support, ngrid, nplanes = size(sigma)
    return Geometry(sigma, support, ngrid, nplanes, npix, nvis)


def fft_work(g: Geometry) -> tuple[float, float]:
    """Bytes and flops of every w-plane's whole 2-D transform in one
    direction: the complex grid read once (or written once), the cropped
    real image written once (or read once), 5 M log2 M a transform of
    M = ngrid^2 points."""
    cells = g.ngrid * g.ngrid
    nbytes = g.nplanes * (8 * cells + 4 * g.npix * g.npix)
    flops = g.nplanes * 5.0 * cells * math.log2(cells)
    return nbytes, flops


def gridding_work(g: Geometry) -> tuple[float, float]:
    """Bytes and flops of gridding (or degridding) every visibility
    once: its three coordinates and complex value read (or written)
    once, every w-plane's complex grid written (or read) once, and two
    FMAs (re, im) a kernel cell on each of the ``support`` planes it
    touches."""
    nbytes = g.nvis * (12 + 8) + g.nplanes * 8 * g.ngrid * g.ngrid
    flops = 4.0 * g.nvis * g.support ** 3
    return nbytes, flops


def invert_bounds(g: Geometry) -> dict:
    """Least seconds of one invert, by layer."""
    return {"fft": bound_seconds(*fft_work(g)),
            "gridding": bound_seconds(*gridding_work(g))}


def cycle_bounds(g: Geometry) -> dict:
    """Least seconds of one major cycle (a predict and an invert)."""
    return {k: 2.0 * v for k, v in invert_bounds(g).items()}
