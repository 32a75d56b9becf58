"""
The port's imaging weighting (``models/weighting.py``, a copy of the
JAX package's numpy module) against the JAX package, on the CPU.

* the density grid, ``finalize`` and ``apply`` of uniform and Briggs
  robust weighting are bit-equal to the JAX module's numpy branch (its
  native density pass switched off), natural weighting is the identity;
* ``invert_dataset(weighting="uniform"|"robust")`` matches the JAX
  ``invert_dataset`` (its XLA path) to 2 x 1.03e-5 of the image max, the
  tolerance ``tests/test_torch_invert.py`` holds natural weighting to,
  and the explicit DFT of the reweighted visibilities to the 1e-4
  contract;
* an unknown scheme raises ``ValueError``.
"""

import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu import invert_dataset as jax_invert_dataset
from ska_sdp_cip_tpu import native as jnative
from ska_sdp_cip_tpu.io.visibility_dataset import VisibilityReader as JaxReader
from ska_sdp_cip_tpu.models import weighting as jweighting
from ska_sdp_cip_tpu_torch import VisibilityReader, invert_dataset
from ska_sdp_cip_tpu_torch.invert import (
    StokesIGridderInput,
    pixel_size_lm_from_asec,
)
from ska_sdp_cip_tpu_torch.models import weighting as tweighting
from ska_sdp_cip_tpu_torch.ops.dft import dirty_image_dft

torch.set_num_threads(1)

NPIX = 128
ASEC = 30.0
PIX = pixel_size_lm_from_asec(ASEC)
#: The JAX package's Pallas-vs-XLA gap (1.03e-5), doubled, as in
#: tests/test_torch_invert.py.
INVERT_RTOL = 2 * 1.03e-5
SCHEMES = [("uniform", 0.0), ("robust", 0.0), ("robust", -1.5),
           ("robust", 2.0)]


@pytest.fixture(scope="module")
def gridder_input(dataset_path):
    return StokesIGridderInput.from_reader(VisibilityReader(dataset_path))


@pytest.fixture
def numpy_only(monkeypatch):
    """The JAX module's density pass on its numpy branch."""
    monkeypatch.setattr(jnative, "available", lambda: False)


@pytest.mark.parametrize("scheme,robust", SCHEMES)
def test_weights_bit_equal_to_jax(gridder_input, numpy_only, scheme, robust):
    args = (gridder_input.uvw, gridder_input.channel_frequencies,
            gridder_input.effective_weights())
    ours = tweighting.ImagingWeighter(NPIX, PIX, scheme=scheme,
                                      robust=robust).fit(*args)
    ref = jweighting.ImagingWeighter(NPIX, PIX, scheme=scheme,
                                     robust=robust).fit(*args)
    np.testing.assert_array_equal(ours.density, ref.density)
    assert ours._f2 == ref._f2
    out, want = ours.apply(*args), ref.apply(*args)
    assert out.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(out, want)
    assert not np.array_equal(out, args[2])
    # Chunked accumulation adds up to the whole fit.
    rows = len(args[0]) // 2
    density = ours.accumulate_density(args[0][:rows], args[1],
                                      args[2][:rows])
    density = ours.accumulate_density(args[0][rows:], args[1],
                                      args[2][rows:], density)
    np.testing.assert_allclose(density, ref.density, rtol=1e-12)


def test_natural_is_identity_and_reader_fit(dataset_path, gridder_input,
                                            numpy_only):
    weights = gridder_input.effective_weights()
    natural = tweighting.ImagingWeighter(NPIX, PIX)
    args = (gridder_input.uvw, gridder_input.channel_frequencies, weights)
    np.testing.assert_array_equal(natural.fit(*args).apply(*args), weights)
    assert natural.density is None
    ours = tweighting.fit_weighter_for_reader(
        VisibilityReader(dataset_path), NPIX, PIX, scheme="robust",
        robust=0.5)
    ref = jweighting.fit_weighter_for_reader(
        JaxReader(dataset_path), NPIX, PIX, scheme="robust", robust=0.5)
    np.testing.assert_array_equal(ours.density, ref.density)
    assert ours._f2 == ref._f2
    assert tweighting.fit_weighter_for_reader(
        VisibilityReader(dataset_path), NPIX, PIX, scheme="natural"
    ).density is None
    with pytest.raises(RuntimeError, match="fit"):
        tweighting.ImagingWeighter(NPIX, PIX, scheme="uniform").apply(*args)


@pytest.mark.parametrize("scheme,robust", [("uniform", 0.0),
                                           ("robust", 0.0)])
def test_invert_dataset_weighted_matches_jax_and_dft(dataset_path,
                                                     gridder_input,
                                                     numpy_only, scheme,
                                                     robust):
    ours = invert_dataset(VisibilityReader(dataset_path), NPIX, ASEC,
                          weighting=scheme, robust=robust, device="cpu")
    ref = jax_invert_dataset(JaxReader(dataset_path), NPIX, ASEC,
                             weighting=scheme, robust=robust)
    natural = invert_dataset(VisibilityReader(dataset_path), NPIX, ASEC,
                             device="cpu")
    assert ours.shape == (NPIX, NPIX) and ours.dtype == np.float32
    assert np.abs(ours - ref).max() / np.abs(ref).max() <= INVERT_RTOL
    # The weighting changed the image.
    assert np.abs(ours - natural).max() > 1e-2 * np.abs(natural).max()

    gi = gridder_input
    weights = tweighting.ImagingWeighter(
        NPIX, PIX, scheme=scheme, robust=robust
    ).fit(gi.uvw, gi.channel_frequencies, gi.effective_weights()).apply(
        gi.uvw, gi.channel_frequencies, gi.effective_weights())
    dft = dirty_image_dft(gi.uvw, gi.channel_frequencies, gi.visibilities,
                          weights, NPIX, PIX) / weights.sum()
    assert np.abs(ours - dft).max() / np.abs(dft).max() <= 1e-4


def test_unknown_scheme_raises(dataset_path):
    with pytest.raises(ValueError, match="bogus"):
        tweighting.ImagingWeighter(64, 1e-4, scheme="bogus")
    with pytest.raises(ValueError, match="bogus"):
        invert_dataset(VisibilityReader(dataset_path), 64, ASEC,
                       weighting="bogus", device="cpu")
