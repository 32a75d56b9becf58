"""
The benchmark's extended-sky generator (``cipbench/extended.py``): the
analytic visibilities of a circular Gaussian against a DFT of the same
Gaussian sampled on a fine (l, m) grid, with and without the w-term,
and its sky drawn from the seed.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cipbench import extended, synth

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _sampled(uvw, freqs, l0, m0, fwhm, flux, step_frac=0.04, extent=4.0):
    """The DFT of the Gaussian's brightness sampled every ``step_frac``
    FWHM over +-``extent`` FWHM, each sample a point source with the
    imaging w-sign (``synth.sky_visibilities``)."""
    sigma = fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    step = step_frac * fwhm
    axis = np.arange(-extent * fwhm, extent * fwhm + step / 2, step)
    ll, mm = np.meshgrid(axis, axis, indexing="ij")
    bright = np.exp(-(ll ** 2 + mm ** 2) / (2 * sigma ** 2))
    bright *= flux / bright.sum()
    lm = np.stack([ll.ravel() + l0, mm.ravel() + m0], axis=1)
    return synth.sky_visibilities(torch.as_tensor(uvw), torch.as_tensor(freqs),
                                  torch.as_tensor(lm),
                                  torch.as_tensor(bright.ravel())).numpy()


@pytest.mark.parametrize("with_w", [False, True])
@pytest.mark.parametrize("fwhm_asec", [5.0, 40.0])
def test_gaussian_is_its_sampled_dft(with_w, fwhm_asec):
    uvw, _ = synth.synthetic_uvw(3, 8, max_baseline_m=4000.0, seed=9)
    if not with_w:
        uvw = uvw * [1.0, 1.0, 0.0]
    freqs = np.array([1.40e9, 1.42e9])
    fwhm = fwhm_asec * extended.ASEC
    l0, m0 = 3e-3, -2e-3
    got = extended.gaussian_visibilities(
        torch.as_tensor(uvw), torch.as_tensor(freqs),
        torch.tensor([[l0, m0]], dtype=torch.float64),
        torch.tensor([fwhm]), torch.tensor([1.7])).numpy()
    want = _sampled(uvw, freqs, l0, m0, fwhm, 1.7)
    # The analytic form takes the w-term at the centre; across a 40 asec
    # Gaussian it moves by |w| (n - 1)'s change there, ~1e-4 of a turn.
    assert np.abs(got - want).max() <= (2e-3 if with_w else 1e-4) * 1.7
    assert np.abs(got).max() <= 1.7 + 1e-12


def test_sky_from_the_seed():
    cfg = json.loads((ROOT / "cipbench" / "configs" / "csd3-10k-briggs.json")
                     .read_text())
    a = extended.ExtendedSky.of(cfg, 2**31 + 7)
    b = extended.ExtendedSky.of(cfg, 2**31 + 7)
    c = extended.ExtendedSky.of(cfg, 2**31 + 8)
    assert np.array_equal(a.pixels, b.pixels)
    assert not np.array_equal(a.pixels, c.pixels)
    npix, sky = cfg["imaging"]["num_pixels"], cfg["sky"]
    assert len(a.centres) == sky["num_gaussians"] == 12
    assert len({tuple(p) for p in a.pixels.tolist()}) == len(a.pixels)
    half = int(npix * sky["inner_fraction"] / 2)
    assert np.all(np.abs(a.centres - npix // 2) <= half)
    lo, hi = sky["gaussian_fwhm_asec"]
    assert np.all((a.fwhm_asec >= lo) & (a.fwhm_asec <= hi))
    assert np.all((a.flux >= 0.5) & (a.flux <= 3.0))
