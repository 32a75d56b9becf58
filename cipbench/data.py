"""
A cell's visibilities, made from the seed on the card in blocks of dumps
and brought to the host, where the program's entries take them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from . import synth

DUMPS_PER_BLOCK = 16


class Stopwatch(dict):
    """Seconds of each named phase of a set-up, in order."""

    def __init__(self):
        super().__init__()
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self[name] = now - self._t
        self._t = now


@dataclass
class Sky:
    pixels: np.ndarray   # (S, 2) pixel positions
    flux: np.ndarray     # (S,) Jy

    @classmethod
    def of(cls, cfg: dict, seed: int) -> "Sky":
        pixels, flux = synth.sky_sources(seed, cfg["sky"],
                                         cfg["imaging"]["num_pixels"])
        return cls(pixels, flux)

    def lm(self, cfg: dict, device) -> torch.Tensor:
        img = cfg["imaging"]
        pix = synth.pixel_size_lm(img["pixel_size_asec"])
        rel = torch.as_tensor(self.pixels - img["num_pixels"] // 2,
                              dtype=torch.float64, device=device)
        return rel * pix


def _blocks(num_rows: int, baselines: int):
    step = DUMPS_PER_BLOCK * baselines
    for r0 in range(0, num_rows, step):
        yield r0, min(r0 + step, num_rows)


def stokes_i(cfg: dict, seed: int, uvw: np.ndarray, freqs: np.ndarray,
             sky: Sky, device) -> tuple[np.ndarray, np.ndarray]:
    """Stokes-I visibilities (rows, chans) complex64 and their effective
    weights (0 where flagged) float32, on the host."""
    s = cfg["sky"]
    rows, chans = len(uvw), len(freqs)
    baselines = cfg["observation"]["num_antennas"] * (
        cfg["observation"]["num_antennas"] - 1) // 2
    vis = np.empty((rows, chans), np.complex64)
    wgt = np.empty((rows, chans), np.float32)
    gen = synth.generator(seed, device)
    lm = sky.lm(cfg, device)
    flux = torch.as_tensor(sky.flux, device=device)
    freqs_t = torch.as_tensor(freqs, device=device)
    for r0, r1 in _blocks(rows, baselines):
        shape = (r1 - r0, chans)
        u = torch.as_tensor(uvw[r0:r1], device=device)
        v = synth.sky_visibilities(u, freqs_t, lm, flux).to(torch.complex64)
        v += synth.complex_noise(shape, s["noise_sigma_jy"], gen, device)
        w = synth.uniform(shape, *s["weight_range"], gen, device)
        w[synth.bernoulli(shape, s["flag_fraction"], gen, device)] = 0.0
        vis[r0:r1] = v.cpu().numpy()
        wgt[r0:r1] = w.cpu().numpy()
    return vis, wgt
