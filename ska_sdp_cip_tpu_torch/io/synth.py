"""
Synthetic visibility dataset generation.

Counterpart: ``ska_sdp_cip_tpu/io/synth.py``, copied unchanged in
behaviour (same seeds, same arrays) because the port cannot import the
JAX package. A random compact antenna layout observed over an
hour-angle arc, point sources on the sky, and 4-pol visibilities with
flags and weights: a dataset with known sky truth.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .visibility_dataset import PathLike, write_vz_dataset

#: Channel frequencies (Hz) matching the reference's test dataset
#: (reference: tests/test_measurement_set.py:25-28).
MKT_NANO_CHAN_FREQS = np.array(
    [959969726.5625, 960805664.0625, 961641601.5625, 962477539.0625]
)

SPEED_OF_LIGHT = 299792458.0


def synthetic_uvw(
    num_times: int,
    num_antennas: int,
    *,
    max_baseline_m: float = 7700.0,
    declination_deg: float = -28.0,
    hour_angle_range: tuple[float, float] = (-0.5, 0.5),
    seed: int = 1234,
) -> tuple[np.ndarray, np.ndarray]:
    """
    Earth-rotation-synthesis UVW tracks for a random 2-D antenna layout.

    Returns ``(uvw, time)`` with shapes ``(num_times * num_baselines, 3)``
    and ``(num_times * num_baselines,)``; rows are time-ordered (all
    baselines of time 0 first), matching MSv2 row ordering assumptions
    the reference relies on for time-interval partitioning
    (reference: uvw_tiling/reorder.py:54-67).
    """
    rng = np.random.default_rng(seed)

    # Clustered antenna layout (dense core + outliers), roughly MeerKAT-like
    radii = max_baseline_m / 2 * rng.beta(1.0, 4.0, size=num_antennas)
    angles = rng.uniform(0, 2 * np.pi, size=num_antennas)
    east = radii * np.cos(angles)
    north = radii * np.sin(angles)
    up = rng.normal(0.0, 5.0, size=num_antennas)
    antennas = np.stack([east, north, up], axis=-1)

    # Baseline vectors in local ENU coordinates, i < j
    idx_a, idx_b = np.triu_indices(num_antennas, k=1)
    baselines_enu = antennas[idx_b] - antennas[idx_a]

    latitude = np.radians(-30.7)  # MeerKAT site latitude
    declination = np.radians(declination_deg)
    hour_angles = np.linspace(
        hour_angle_range[0], hour_angle_range[1], num_times
    ) * (np.pi / 12.0)

    # ENU -> equatorial XYZ
    sin_lat, cos_lat = np.sin(latitude), np.cos(latitude)
    e, n, u = baselines_enu.T
    bx = -n * sin_lat + u * cos_lat
    by = e
    bz = n * cos_lat + u * sin_lat

    uvw_list = []
    for hour_angle in hour_angles:
        sin_ha, cos_ha = np.sin(hour_angle), np.cos(hour_angle)
        sin_dec, cos_dec = np.sin(declination), np.cos(declination)
        uu = sin_ha * bx + cos_ha * by
        vv = -sin_dec * cos_ha * bx + sin_dec * sin_ha * by + cos_dec * bz
        ww = cos_dec * cos_ha * bx - cos_dec * sin_ha * by + sin_dec * bz
        uvw_list.append(np.stack([uu, vv, ww], axis=-1))

    uvw = np.concatenate(uvw_list, axis=0)
    num_baselines = len(baselines_enu)
    time = np.repeat(
        4.9e9 + np.arange(num_times, dtype=np.float64) * 8.0, num_baselines
    )
    return uvw, time


def point_source_visibilities(
    uvw: np.ndarray,
    channel_frequencies: np.ndarray,
    source_lm: np.ndarray,
    source_flux: np.ndarray,
) -> np.ndarray:
    """
    Stokes-I point-source visibilities with the full w-term:
    ``V_k = sum_s S_s * exp(-2 pi i (u l + v m + w (n - 1)))`` in
    wavelength units — the forward model whose adjoint is the dirty
    image definition the invert operator is tested against
    (see ops/dft.py). Shape ``(num_rows, num_channels)`` complex128.
    """
    source_lm = np.atleast_2d(source_lm)
    lf = channel_frequencies / SPEED_OF_LIGHT  # (nchan,)
    # uvw_wavelengths: (nrow, nchan, 3)
    uvw_wl = uvw[:, None, :] * lf[None, :, None]
    ll, mm = source_lm[:, 0], source_lm[:, 1]
    nm1 = -(ll**2 + mm**2) / (1.0 + np.sqrt(1.0 - ll**2 - mm**2))
    vis = np.zeros(uvw_wl.shape[:2], dtype=np.complex128)
    for flux, l, m, n_minus_1 in zip(source_flux, ll, mm, nm1):
        phase = (
            uvw_wl[..., 0] * l + uvw_wl[..., 1] * m + uvw_wl[..., 2] * n_minus_1
        )
        vis += flux * np.exp(-2j * np.pi * phase)
    return vis


def make_synthetic_dataset(
    path: PathLike,
    *,
    num_times: int = 8,
    num_antennas: int = 24,
    channel_frequencies: np.ndarray = MKT_NANO_CHAN_FREQS,
    num_sources: int = 5,
    field_of_view_deg: float = 1.0,
    flag_fraction: float = 0.03,
    weight_spectrum: bool = True,
    seed: int = 1234,
) -> Path:
    """
    Write a synthetic 4-pol VZ dataset and return its path.

    The XX and YY correlations each carry the full Stokes-I point-source
    signal plus independent noise, so the Stokes-I conversion
    ``0.5 * (XX + YY)`` (reference: invert.py:89) recovers the signal;
    XY/YX are pure noise. Weights are drawn per-sample when
    ``weight_spectrum`` is set, else a row-level WEIGHT column is
    written to exercise the fallback path
    (reference: measurement_set.py:334-358).
    """
    rng = np.random.default_rng(seed)
    uvw, time = synthetic_uvw(num_times, num_antennas, seed=seed)
    num_rows = len(uvw)
    num_channels = len(channel_frequencies)

    half_fov = np.radians(field_of_view_deg) / 2
    source_lm = rng.uniform(-half_fov, half_fov, size=(num_sources, 2))
    source_flux = rng.uniform(0.5, 3.0, size=num_sources)

    stokes_i = point_source_visibilities(
        uvw, channel_frequencies, source_lm, source_flux
    )

    noise = lambda scale: (
        rng.normal(0, scale, size=(num_rows, num_channels))
        + 1j * rng.normal(0, scale, size=(num_rows, num_channels))
    )
    vis = np.zeros((num_rows, num_channels, 4), dtype=np.complex64)
    vis[..., 0] = stokes_i + noise(0.05)  # XX
    vis[..., 1] = noise(0.05)  # XY
    vis[..., 2] = noise(0.05)  # YX
    vis[..., 3] = stokes_i + noise(0.05)  # YY

    flags = rng.random((num_rows, num_channels, 4)) < flag_fraction

    kwargs = {}
    if weight_spectrum:
        kwargs["weight_spectrum"] = rng.uniform(
            0.5, 2.0, size=(num_rows, num_channels, 4)
        ).astype(np.float32)
    else:
        kwargs["weights"] = rng.uniform(0.5, 2.0, size=(num_rows, 4)).astype(
            np.float32
        )

    return write_vz_dataset(
        path,
        uvw=uvw,
        visibilities=vis,
        flags=flags,
        channel_frequencies=channel_frequencies,
        time=time,
        corr_types=(9, 10, 11, 12),
        **kwargs,
    )
