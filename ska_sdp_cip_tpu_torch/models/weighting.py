"""
Imaging weighting schemes: natural, uniform, and Briggs robust.

Counterpart: ``ska_sdp_cip_tpu/models/weighting.py``, which is numpy
only and therefore copied here, held equal by
``tests/test_torch_weighting.py``. Per-visibility weights are divided
by (a function of) the gridded weight density at their uv cell,

    uniform:  w' = w / rho(cell)
    robust:   w' = w / (1 + rho(cell) * f^2),
              f^2 = (5 * 10^-R)^2 / (sum rho^2 / sum w)

computed on the un-oversampled image grid (cell = 1 / (npix * pixsize)).
The density fit is global: :class:`ImagingWeighter` is fitted once on
the full dataset and then applied per shard, so sharded inverts see
exactly the weights a single-device run would.

The density pass runs on the native engine's multithreaded C++ branch
(``native.py``) where the engine is available, else on the numpy
``bincount`` pass below; the tests hold the two equal. It is the host
span ``weighting.density`` (``utils/task_metrics.py``) and counts the
visibilities it takes in ``weighted_visibilities``.
"""

from __future__ import annotations

import numpy as np

from ..utils.task_metrics import count, span

SPEED_OF_LIGHT = 299792458.0

SCHEMES = ("natural", "uniform", "robust")


class ImagingWeighter:
    """Density-based imaging weights for one imaging configuration."""

    def __init__(
        self,
        num_pixels: int,
        pixel_size_lm: float,
        *,
        scheme: str = "natural",
        robust: float = 0.0,
    ) -> None:
        if scheme not in SCHEMES:
            raise ValueError(
                f"Unknown weighting scheme {scheme!r}; pick from {SCHEMES}"
            )
        self.scheme = scheme
        self.robust = float(robust)
        self.num_pixels = num_pixels
        self.cell = 1.0 / (num_pixels * pixel_size_lm)
        self.density = None
        self._f2 = 0.0

    def _cells(self, uvw: np.ndarray, freqs: np.ndarray) -> tuple:
        # Multiply by 1/cell (not divide by cell): the counterpart's
        # native density pass computes its cell indices this way.
        scale = (
            np.asarray(freqs, np.float64) / SPEED_OF_LIGHT / self.cell
        )
        u = np.multiply.outer(uvw[:, 0], scale).ravel()
        v = np.multiply.outer(uvw[:, 1], scale).ravel()
        half = self.num_pixels // 2
        iu = np.round(u).astype(np.int64) + half
        iv = np.round(v).astype(np.int64) + half
        iu = np.clip(iu, 0, self.num_pixels - 1)
        iv = np.clip(iv, 0, self.num_pixels - 1)
        return iu, iv

    def accumulate_density(
        self,
        uvw: np.ndarray,
        freqs: np.ndarray,
        weights: np.ndarray,
        density: np.ndarray | None = None,
    ) -> np.ndarray:
        """
        Add one chunk's weight density into ``density`` (allocated when
        None) and return it. Conjugate symmetry: each sample also
        counts at its mirrored cell, so mirrored baselines see the same
        density. Density grids from different chunks/processes add, so
        a distributed fit is per-shard accumulation plus one sum.
        """
        with span("weighting.density"):
            count("weighted_visibilities", np.size(weights))
            return self._accumulate_density(uvw, freqs, weights, density)

    def _accumulate_density(self, uvw, freqs, weights, density):
        if density is None:
            density = np.zeros((self.num_pixels, self.num_pixels))
        from .. import native as _native

        if (
            len(uvw)
            and density.flags.c_contiguous
            and _native.available()
        ):
            # Multithreaded C++ pass (lock-free double adds): the
            # single-threaded per-sample fit is the plan-time
            # bottleneck at production sample counts.
            return _native.density_accumulate(
                uvw,
                freqs,
                weights,
                inv_cell=1.0 / self.cell,
                npix=self.num_pixels,
                density=density,
            )
        npix = self.num_pixels
        iu, iv = self._cells(uvw, freqs)
        w = np.asarray(weights, np.float64).ravel()
        # The mirror of cell round(u/cell) + half is round(-u/cell) +
        # half = num_pixels - iu (for even num_pixels), NOT
        # num_pixels - 1 - iu, which lands one cell off. One bincount
        # over direct + mirrored flat cells (np.add.at is ~5x slower).
        flat = np.concatenate(
            [
                iu * npix + iv,
                np.clip(npix - iu, 0, npix - 1) * npix
                + np.clip(npix - iv, 0, npix - 1),
            ]
        )
        density += np.bincount(
            flat, weights=np.concatenate([w, w]), minlength=npix * npix
        ).reshape(npix, npix)
        return density

    def finalize(self, density: np.ndarray) -> "ImagingWeighter":
        """Install the (fully reduced) density grid and derived terms."""
        self.density = density
        if self.scheme == "robust":
            total_w = float(density.sum())
            mean_density = float((density**2).sum()) / max(total_w, 1e-30)
            self._f2 = (5.0 * 10.0 ** (-self.robust)) ** 2 / max(
                mean_density, 1e-30
            )
        return self

    def fit(
        self, uvw: np.ndarray, freqs: np.ndarray, weights: np.ndarray
    ) -> "ImagingWeighter":
        """Single-pass fit over one whole dataset."""
        if self.scheme == "natural":
            return self
        return self.finalize(
            self.accumulate_density(uvw, freqs, weights)
        )

    def apply(
        self, uvw: np.ndarray, freqs: np.ndarray, weights: np.ndarray
    ) -> np.ndarray:
        """Return re-weighted weights with the fitted density."""
        if self.scheme == "natural":
            return np.asarray(weights)
        if self.density is None:
            raise RuntimeError("fit() must run before apply()")
        iu, iv = self._cells(uvw, freqs)
        rho = self.density[iu, iv].reshape(np.shape(weights))
        weights = np.asarray(weights, np.float64)
        if self.scheme == "uniform":
            out = np.where(rho > 0, weights / np.maximum(rho, 1e-30), 0.0)
        else:
            out = weights / (1.0 + rho * self._f2)
        return out.astype(np.float32)


def fit_weighter_for_reader(
    reader,
    num_pixels: int,
    pixel_size_lm: float,
    *,
    scheme: str,
    robust: float = 0.0,
) -> ImagingWeighter:
    """
    Fit an :class:`ImagingWeighter` on a whole dataset's effective
    Stokes-I weights (one pass over the reader).
    """
    from ..invert import StokesIGridderInput

    weighter = ImagingWeighter(
        num_pixels, pixel_size_lm, scheme=scheme, robust=robust
    )
    if scheme == "natural":
        return weighter
    gridder_input = StokesIGridderInput.from_reader(reader)
    return weighter.fit(
        gridder_input.uvw,
        gridder_input.channel_frequencies,
        gridder_input.effective_weights(),
    )
