"""The plain reference against brute force at a tiny size, and the plain
Hogbom against the program's minor cycle on the same input."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cipbench import synth
from cipbench.reference import clean, dft

C = 299792458.0


def _problem(seed=1, rows=40, chans=3):
    rng = np.random.default_rng(seed)
    uvw = rng.normal(0, 60.0, size=(rows, 3))
    freqs = np.array([1.40e9, 1.41e9, 1.42e9])[:chans]
    vis = rng.normal(size=(rows, chans)) + 1j * rng.normal(size=(rows, chans))
    return uvw, freqs, vis


def _brute_dirty(uvw, freqs, x, pix, npix, pixels):
    out = []
    for i, j in pixels:
        l, m = (i - npix // 2) * pix, (j - npix // 2) * pix
        nm1 = -(l * l + m * m) / (1 + np.sqrt(1 - l * l - m * m))
        acc = 0.0
        for r in range(len(uvw)):
            for c, f in enumerate(freqs):
                u, v, w = uvw[r] * f / C
                acc += (x[r, c] * np.exp(2j * np.pi * (u * l + v * m - w * nm1))).real
        out.append(acc / (nm1 + 1))
    return np.array(out)


def test_dirty_at_matches_brute_force_and_the_programs_oracle():
    from ska_sdp_cip_tpu_torch.ops.dft import dirty_image_dft

    uvw, freqs, vis = _problem()
    npix, pix = 16, synth.pixel_size_lm(600.0)
    pixels = np.array([[0, 0], [8, 8], [3, 11], [15, 2]])
    got = dft.dirty_at(uvw, freqs, torch.as_tensor(vis)[..., None], pixels,
                       npix, pix)[0].numpy()
    np.testing.assert_allclose(got, _brute_dirty(uvw, freqs, vis, pix, npix,
                                                 pixels), rtol=1e-10, atol=1e-10)
    full = dirty_image_dft(uvw, freqs, vis, np.ones(vis.shape), npix, pix)
    np.testing.assert_allclose(got, full[pixels[:, 0], pixels[:, 1]],
                               rtol=1e-10, atol=1e-10)


def test_model_visibilities_is_the_programs_predict_dft():
    from ska_sdp_cip_tpu_torch.ops.dft import predict_dft

    uvw, freqs, _ = _problem(rows=12)
    npix, pix = 16, synth.pixel_size_lm(600.0)
    image = np.zeros((npix, npix))
    pixels = np.array([[8, 8], [2, 13], [11, 5]])
    image[pixels[:, 0], pixels[:, 1]] = [1.0, -0.5, 2.0]
    got = dft.model_visibilities(uvw, freqs, pixels,
                                 torch.tensor([1.0, -0.5, 2.0]), npix, pix)
    np.testing.assert_allclose(got.numpy(), predict_dft(uvw, freqs, image, pix),
                               rtol=1e-10, atol=1e-10)


def test_bfloat16_dirty_at_is_far_off():
    uvw, freqs, vis = _problem()
    uvw = uvw * 100
    npix, pix = 16, synth.pixel_size_lm(600.0)
    pixels = np.array([[0, 0], [3, 11], [15, 2]])
    x = torch.as_tensor(vis)[..., None]
    ref = dft.dirty_at(uvw, freqs, x, pixels, npix, pix)[0]
    low = dft.dirty_at(uvw, freqs, x, pixels, npix, pix, dtype=torch.bfloat16)[0]
    assert float((low - ref).abs().max() / ref.abs().max()) > 1e-2


@pytest.mark.parametrize("patch", [None, 32])
def test_hogbom_follows_the_program_bit_for_bit(patch):
    from ska_sdp_cip_tpu_torch.models.clean import hogbom_clean

    gen = torch.Generator().manual_seed(4)
    n = 64
    dirty = torch.randn((n, n), generator=gen)
    psf = 0.1 * torch.randn((n, n), generator=gen)
    psf[n // 2, n // 2] = 1.3
    want, want_res = hogbom_clean(dirty, psf, gain=0.1, max_iter=40,
                                  psf_patch=patch)
    got, got_res = clean.hogbom(dirty, psf, gain=0.1, max_iter=40,
                                psf_patch=patch)
    assert torch.equal(got, want) and torch.equal(got_res, want_res)
    low, _ = clean.hogbom(dirty, psf, gain=0.1, max_iter=40, psf_patch=patch,
                          dtype=torch.bfloat16)
    assert not torch.equal(low, want)
