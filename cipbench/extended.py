"""
A sky with extended emission, made from ``--seed``: the configuration's
point sources (``data.Sky``) and circular Gaussians, and its Stokes-I
visibilities with the noise, flags and weights of ``data.stokes_i``,
drawn in the same order from the same generator.

A Gaussian of integrated flux S and full width at half maximum theta
(radians) centred at (l0, m0) has the visibility

    S exp(-pi^2 theta^2 (u^2 + v^2) / (4 ln 2))
      * exp(-2 pi i (u l0 + v m0 - w (n0 - 1)))

(u, v, w in wavelengths; the w-term's sign of the imaging convention,
as ``synth.sky_visibilities`` has it), exact for a Gaussian small
against the field, where the sky is flat across it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import data, synth

ASEC = math.pi / 180.0 / 3600.0


@dataclass
class ExtendedSky:
    points: data.Sky
    centres: np.ndarray  # (G, 2) pixel positions of the Gaussians
    fwhm_asec: np.ndarray  # (G,)
    flux: np.ndarray  # (G,) Jy, integrated

    @classmethod
    def of(cls, cfg: dict, seed: int) -> "ExtendedSky":
        """The point sources of ``data.Sky`` and ``num_gaussians``
        Gaussians at pixel centres in the central ``inner_fraction``,
        their FWHM log-uniform over ``gaussian_fwhm_asec``, their flux
        uniform over ``gaussian_flux_jy``."""
        sky, npix = cfg["sky"], cfg["imaging"]["num_pixels"]
        points = data.Sky.of(cfg, seed)
        rng = np.random.default_rng([seed, 4])
        half = int(npix * sky["inner_fraction"] / 2)
        num = sky["num_gaussians"]
        taken = {tuple(p) for p in points.pixels.tolist()}
        centres = []
        while len(centres) < num:
            p = tuple(int(x) for x in rng.integers(-half, half, size=2)
                      + npix // 2)
            if p not in taken:
                taken.add(p)
                centres.append(p)
        lo, hi = np.log(sky["gaussian_fwhm_asec"])
        fwhm = np.exp(rng.uniform(lo, hi, size=num))
        flux = rng.uniform(*sky["gaussian_flux_jy"], size=num)
        return cls(points, np.array(centres, np.int64), fwhm, flux)

    @property
    def pixels(self) -> np.ndarray:
        """Every component's pixel: the point sources', then the
        Gaussians' centres."""
        return np.concatenate([self.points.pixels, self.centres])

    def lm(self, cfg: dict, device) -> torch.Tensor:
        img = cfg["imaging"]
        pix = synth.pixel_size_lm(img["pixel_size_asec"])
        rel = torch.as_tensor(self.centres - img["num_pixels"] // 2,
                              dtype=torch.float64, device=device)
        return rel * pix


def gaussian_visibilities(uvw: torch.Tensor, freqs: torch.Tensor,
                          lm: torch.Tensor, fwhm_rad: torch.Tensor,
                          flux: torch.Tensor) -> torch.Tensor:
    """Visibilities (rows, channels) complex128 of circular Gaussians
    (see the module's docstring), on the device of ``uvw``."""
    scale = freqs.to(torch.float64) / synth.SPEED_OF_LIGHT
    uvw = uvw.to(torch.float64)
    l, m = lm[:, 0], lm[:, 1]
    direction = torch.stack([l, m, -synth.nm1_of(l, m)])
    path = uvw @ direction                                    # (rows, G)
    q2 = (uvw[:, 0] ** 2 + uvw[:, 1] ** 2)[:, None] * scale[None, :] ** 2
    vis = torch.zeros((uvw.shape[0], len(freqs)), dtype=torch.complex128,
                      device=uvw.device)
    for g in range(lm.shape[0]):
        amp = flux[g] * torch.exp(-(math.pi ** 2) * fwhm_rad[g] ** 2 * q2
                                  / (4.0 * math.log(2.0)))
        phase = (-2.0 * math.pi) * path[:, g, None] * scale[None, :]
        vis += torch.polar(amp, phase)
    return vis


def stokes_i(cfg: dict, seed: int, uvw: np.ndarray, freqs: np.ndarray,
             sky: ExtendedSky, device) -> tuple[np.ndarray, np.ndarray]:
    """``data.stokes_i`` of the extended sky: Stokes-I visibilities
    (rows, chans) complex64 and effective weights float32, on the
    host."""
    s = cfg["sky"]
    rows, chans = len(uvw), len(freqs)
    baselines = cfg["observation"]["num_antennas"] * (
        cfg["observation"]["num_antennas"] - 1) // 2
    vis = np.empty((rows, chans), np.complex64)
    wgt = np.empty((rows, chans), np.float32)
    gen = synth.generator(seed, device)
    lm = sky.points.lm(cfg, device)
    flux = torch.as_tensor(sky.points.flux, device=device)
    g_lm = sky.lm(cfg, device)
    g_fwhm = torch.as_tensor(sky.fwhm_asec * ASEC, device=device)
    g_flux = torch.as_tensor(sky.flux, device=device)
    freqs_t = torch.as_tensor(freqs, device=device)
    for r0, r1 in data._blocks(rows, baselines):
        shape = (r1 - r0, chans)
        u = torch.as_tensor(uvw[r0:r1], device=device)
        v = (synth.sky_visibilities(u, freqs_t, lm, flux)
             + gaussian_visibilities(u, freqs_t, g_lm, g_fwhm, g_flux))
        v = v.to(torch.complex64)
        v += synth.complex_noise(shape, s["noise_sigma_jy"], gen, device)
        w = synth.uniform(shape, *s["weight_range"], gen, device)
        w[synth.bernoulli(shape, s["flag_fraction"], gen, device)] = 0.0
        vis[r0:r1] = v.cpu().numpy()
        wgt[r0:r1] = w.cpu().numpy()
    return vis, wgt
