"""
Invert: visibility dataset -> Stokes-I dirty image.

Counterpart: ``ska_sdp_cip_tpu/invert.py`` (``StokesIGridderInput``,
``grid_invert``, ``invert_dataset``, ``integrate_weighted_images``),
with the gridder replaced by the port's (``ops/gridder.py``) and an
explicit ``device`` on every entry point. ``invert_dataset`` takes the
counterpart's weighting schemes (natural, uniform, Briggs robust;
``models/weighting.py``); ``sharded_invert_dataset``, the multi-device
invert (``parallel/sharded_invert.py``), is re-exported here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from numpy.typing import NDArray

from .io.visibility_dataset import VisibilityReader
from .ops import gridder
from .utils.task_metrics import span


@dataclass
class StokesIGridderInput:
    """
    Stokes-I visibilities plus associated arrays, ready for gridding.
    Assumes a linear or circular 4-pol frame with indices 0 and 3 being
    {XX, YY} or {RR, LL}.
    """

    channel_frequencies: NDArray
    """Channel frequencies, shape (nchan,)."""

    flags: NDArray
    """Stokes-I flags, shape (nrows, nchan)."""

    uvw: NDArray
    """UVW coordinates in meters, shape (nrows, 3)."""

    visibilities: NDArray
    """Stokes-I visibilities, shape (nrows, nchan)."""

    weights: NDArray
    """Stokes-I weights, shape (nrows, nchan)."""

    def effective_weights(self) -> NDArray:
        """``weights * (1 - flags)``."""
        return np.logical_not(self.flags) * self.weights

    @classmethod
    def from_reader(cls, reader: VisibilityReader) -> "StokesIGridderInput":
        """
        Load a reader window, converting to Stokes I: ``I = 0.5 *
        (vis[..., 0] + vis[..., 3])``, flagged if either correlation is
        flagged, ``w = 4 / (1/wxx + 1/wyy)`` with non-finite weights
        clamped to 0.
        """
        vis = reader.visibilities()
        stokes_i_vis = 0.5 * (vis[..., 0] + vis[..., 3])

        flags = reader.flags()
        stokes_i_flags = flags[..., (0, 3)].max(axis=-1)

        weights = reader.weights()
        with np.errstate(divide="ignore", invalid="ignore"):
            wxx = weights[..., 0]
            wyy = weights[..., 3]
            stokes_i_weights = 4.0 / (1.0 / wxx + 1.0 / wyy)
        stokes_i_weights = np.where(
            np.isfinite(stokes_i_weights), stokes_i_weights, 0.0
        )

        return cls(
            channel_frequencies=reader.channel_frequencies(),
            flags=stokes_i_flags,
            uvw=reader.uvw(),
            visibilities=stokes_i_vis,
            weights=stokes_i_weights,
        )

    # Alias matching the reference classmethod name
    from_measurement_set_reader = from_reader


def pixel_size_lm_from_asec(pixel_size_asec: float) -> float:
    """``sin(radians(asec / 3600))``."""
    return float(np.sin(np.radians(pixel_size_asec / 3600.0)))


def grid_invert(
    gridder_input: StokesIGridderInput,
    num_pixels: int,
    pixel_size_asec: float,
    *,
    epsilon: float = 1e-4,
    do_wstacking: bool = True,
    sigma: float | str = 2.0,
    device,
) -> tuple[NDArray, float]:
    """
    Invert gridder input on ``device``, returning ``(unnormalized
    image, total weight)``.
    """
    effective_weights = gridder_input.effective_weights()
    image = gridder.dirty_image(
        gridder_input.uvw,
        gridder_input.channel_frequencies,
        gridder_input.visibilities,
        effective_weights,
        num_pixels,
        pixel_size_lm_from_asec(pixel_size_asec),
        epsilon=epsilon,
        do_wstacking=do_wstacking,
        sigma=sigma,
        device=device,
    )
    return image, float(effective_weights.sum())


def invert_dataset(
    reader: VisibilityReader,
    num_pixels: int,
    pixel_size_asec: float,
    *,
    epsilon: float = 1e-4,
    do_wstacking: bool = True,
    weighting: str = "natural",
    robust: float = 0.0,
    sigma: float | str = 2.0,
    device,
) -> NDArray:
    """
    Single-device invert of a visibility dataset to a normalized dirty
    image, on ``device`` (e.g. ``"cuda"`` or ``"cpu"``). ``weighting``
    selects the imaging weighting scheme (natural/uniform/robust; see
    ``models/weighting.py``).
    The reader's load is the span ``read``
    (``utils/task_metrics.py``), before ``dirty_image``'s, which is
    looked up on ``ops.gridder`` at each call, so that a wrapper put
    there sees the dataset's invert too.
    """
    with span("read"):
        gridder_input = StokesIGridderInput.from_reader(reader)
    if weighting != "natural":
        from .models.weighting import ImagingWeighter

        weighter = ImagingWeighter(
            num_pixels,
            pixel_size_lm_from_asec(pixel_size_asec),
            scheme=weighting,
            robust=robust,
        ).fit(
            gridder_input.uvw,
            gridder_input.channel_frequencies,
            gridder_input.effective_weights(),
        )
        reweighted = weighter.apply(
            gridder_input.uvw,
            gridder_input.channel_frequencies,
            gridder_input.effective_weights(),
        )
        # Fold flags back out: effective weights already zero them.
        gridder_input = StokesIGridderInput(
            channel_frequencies=gridder_input.channel_frequencies,
            flags=np.zeros_like(gridder_input.flags),
            uvw=gridder_input.uvw,
            visibilities=gridder_input.visibilities,
            weights=reweighted,
        )
    image, total_weight = grid_invert(
        gridder_input,
        num_pixels,
        pixel_size_asec,
        epsilon=epsilon,
        do_wstacking=do_wstacking,
        sigma=sigma,
        device=device,
    )
    return (1.0 / total_weight) * image


# Alias matching the reference function name
invert_measurement_set = invert_dataset


def integrate_weighted_images(weighted_images) -> NDArray:
    """Sum per-chunk weighted images and normalize by total weight."""
    images = [img for img, _ in weighted_images]
    weights = [weight for _, weight in weighted_images]
    return sum(images) / sum(weights)


def sharded_invert_dataset(*args, **kwargs):
    """Multi-device invert; see ``parallel/sharded_invert.py``."""
    from .parallel.sharded_invert import sharded_invert_dataset as impl

    return impl(*args, **kwargs)
