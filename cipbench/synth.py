"""
The benchmark's data, made from ``--seed``: the observation's fixed
geometry and a seeded sky, noise, flags and weights.

* :func:`synthetic_uvw` is a frozen copy of
  ``ska_sdp_cip_tpu_torch/io/synth.py:synthetic_uvw`` (the clustered,
  MeerKAT-like layout observed over an hour-angle arc), so that a later
  change to the program cannot move the uv-coverage.
* :func:`sky_visibilities` is the point-source sky of
  ``io/synth.py:point_source_visibilities``, in torch so that it runs on
  the card, with the w-term's sign of the imaging convention
  (``ops/dft.py:predict_dft``): a source at (l, m) comes out in focus
  at its pixel. The original's sign (``+ w (n - 1)``) equals this one on
  uvw with w negated.
* The bulk draws (noise, flags, weights) come from a ``torch.Generator``
  on the data's device, seeded with ``--seed``: a few large calls.
"""

from __future__ import annotations

import numpy as np
import torch

SPEED_OF_LIGHT = 299792458.0


def synthetic_uvw(num_times: int, num_antennas: int, *,
                  max_baseline_m: float = 7700.0,
                  declination_deg: float = -28.0,
                  hour_angle_range: tuple = (-0.5, 0.5),
                  seed: int = 1234) -> tuple[np.ndarray, np.ndarray]:
    """``(uvw, time)``, rows time-ordered: every baseline of dump 0
    first."""
    rng = np.random.default_rng(seed)
    radii = max_baseline_m / 2 * rng.beta(1.0, 4.0, size=num_antennas)
    angles = rng.uniform(0, 2 * np.pi, size=num_antennas)
    east = radii * np.cos(angles)
    north = radii * np.sin(angles)
    up = rng.normal(0.0, 5.0, size=num_antennas)
    antennas = np.stack([east, north, up], axis=-1)

    idx_a, idx_b = np.triu_indices(num_antennas, k=1)
    baselines_enu = antennas[idx_b] - antennas[idx_a]

    latitude = np.radians(-30.7)
    declination = np.radians(declination_deg)
    hour_angles = np.linspace(
        hour_angle_range[0], hour_angle_range[1], num_times
    ) * (np.pi / 12.0)

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
    time = np.repeat(
        4.9e9 + np.arange(num_times, dtype=np.float64) * 8.0,
        len(baselines_enu),
    )
    return uvw, time


def observation(cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """The configuration's uvw (every dump, time-ordered) and the node's
    channel frequencies."""
    obs = cfg["observation"]
    uvw, _ = synthetic_uvw(
        obs["num_dumps"], obs["num_antennas"],
        max_baseline_m=obs["layout_disc_diameter_m"],
        declination_deg=obs["declination_deg"],
        hour_angle_range=tuple(obs["hour_angle_range_h"]),
        seed=obs["layout_seed"],
    )
    first = obs["node_channel_start"]
    chans = np.arange(first, first + obs["num_channels"], dtype=np.float64)
    freqs = obs["band_start_hz"] + chans * obs["channel_width_hz"]
    return uvw, freqs


def layout_extent(cfg: dict) -> dict:
    """What the configuration's layout reaches: its longest baseline and
    largest |w| in metres, and its largest |(u, v)| in wavelengths at the
    node's top channel. ``synthetic_uvw``'s ``max_baseline_m`` is the
    diameter of the disc the dishes are drawn in, not a baseline."""
    uvw, freqs = observation(cfg)
    uv = np.hypot(uvw[:, 0], uvw[:, 1])
    return {"longest_baseline_m": float(np.linalg.norm(uvw, axis=1).max()),
            "max_abs_w_m": float(np.abs(uvw[:, 2]).max()),
            "max_uv_wavelengths_top_channel":
                float(uv.max() * freqs.max() / SPEED_OF_LIGHT)}


def pixel_size_lm(asec: float) -> float:
    return float(np.sin(np.radians(asec / 3600.0)))


def nm1_of(l, m):
    """``n - 1`` at direction cosines (l, m)."""
    r2 = l * l + m * m
    return -r2 / (1.0 + torch.sqrt(1.0 - r2))


def sky_sources(seed: int, sky: dict, npix: int) -> tuple:
    """Pixel positions (num, 2) and fluxes of the seed's point sources,
    at pixel centres inside the central ``inner_fraction`` of the image,
    distinct."""
    rng = np.random.default_rng([seed, 1])
    half = int(npix * sky["inner_fraction"] / 2)
    num = sky["num_sources"]
    flat = rng.choice((2 * half) ** 2, size=num, replace=False)
    pix = np.stack([flat // (2 * half), flat % (2 * half)], axis=1)
    pix = pix + npix // 2 - half
    flux = rng.uniform(*sky["flux_range_jy"], size=num)
    return pix.astype(np.int64), flux


def sky_visibilities(uvw: torch.Tensor, freqs: torch.Tensor, lm: torch.Tensor,
                     flux: torch.Tensor) -> torch.Tensor:
    """Point-source visibilities ``sum_s S_s exp(-2 pi i (u l + v m - w
    (n - 1)))`` (rows, channels), complex128, on the device of ``uvw``."""
    scale = freqs.to(torch.float64) / SPEED_OF_LIGHT
    l, m = lm[:, 0], lm[:, 1]
    direction = torch.stack([l, m, -nm1_of(l, m)])           # (3, S)
    path = uvw.to(torch.float64) @ direction                  # (rows, S)
    vis = torch.zeros((uvw.shape[0], len(freqs)), dtype=torch.complex128,
                      device=uvw.device)
    for s in range(lm.shape[0]):
        phase = (-2.0 * np.pi) * path[:, s, None] * scale[None, :]
        vis += flux[s] * torch.polar(torch.ones_like(phase), phase)
    return vis


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    return gen


def complex_noise(shape, sigma: float, gen: torch.Generator,
                  device) -> torch.Tensor:
    """Complex Gaussian noise, ``sigma`` on each of re and im, complex64."""
    parts = torch.randn((*shape, 2), generator=gen, device=device,
                        dtype=torch.float32) * sigma
    return torch.view_as_complex(parts)


def uniform(shape, lo: float, hi: float, gen: torch.Generator,
            device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device,
                                       dtype=torch.float32)


def bernoulli(shape, p: float, gen: torch.Generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) < p


def sample_pixels(seed: int, npix: int, sources: np.ndarray,
                  count: int) -> np.ndarray:
    """The pixels every check compares at: the sources' pixels and
    ``count`` others drawn from the seed over the whole image."""
    rng = np.random.default_rng([seed, 2])
    others = rng.integers(0, npix, size=(count, 2))
    return np.concatenate([sources, others]).astype(np.int64)
