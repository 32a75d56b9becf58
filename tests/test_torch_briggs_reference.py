"""
The port's Briggs robust weights (``models/weighting.py``:
``ImagingWeighter``, on the native engine's density pass and on the
numpy one) against the benchmark's plain float64 reference
(``cipbench/reference/weighting.py``), on seeded data at a small size:
every weight within 1e-6 of the reference's (the port's are float32),
flagged weights zero; and the reference's bfloat16 control far off.
"""

import numpy as np
import pytest
import torch

from cipbench import synth
from cipbench.reference import weighting as ref_w
from ska_sdp_cip_tpu_torch import native
from ska_sdp_cip_tpu_torch.models.weighting import ImagingWeighter

torch.set_num_threads(1)


def _problem(seed=3):
    uvw, _ = synth.synthetic_uvw(12, 10, max_baseline_m=800.0, seed=seed)
    freqs = np.linspace(1.40e9, 1.43e9, 6)
    rng = np.random.default_rng(seed)
    wgt = rng.uniform(0.5, 2.0, size=(len(uvw), len(freqs))).astype(
        np.float32)
    wgt[rng.random(wgt.shape) < 0.05] = 0.0
    return uvw, freqs, wgt


def _rel(got, want):
    nz = want > 0
    assert not got[~nz].any()
    return float((np.abs(got[nz] - want[nz]) / want[nz]).max())


@pytest.mark.parametrize("engine", ["native", "numpy"])
@pytest.mark.parametrize("robust", [-2.0, -0.5, 0.0, 1.5])
def test_briggs_weights_match_the_reference(monkeypatch, engine, robust):
    if engine == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    uvw, freqs, wgt = _problem()
    npix, pix = 128, synth.pixel_size_lm(20.0)
    got = ImagingWeighter(npix, pix, scheme="robust", robust=robust).fit(
        uvw, freqs, wgt).apply(uvw, freqs, wgt)
    want = ref_w.briggs(uvw, freqs, torch.as_tensor(wgt), npix, pix,
                        robust).numpy()
    assert got.dtype == np.float32
    assert _rel(got, want) <= 1e-6
    # Robust weighting moved the weights: this is no natural weighting.
    assert _rel(wgt, want) > 1e-2


def test_bfloat16_control_is_far_off():
    uvw, freqs, wgt = _problem(5)
    npix, pix = 128, synth.pixel_size_lm(20.0)
    w = torch.as_tensor(wgt)
    want = ref_w.briggs(uvw, freqs, w, npix, pix, -0.5).numpy()
    low = ref_w.briggs(uvw, freqs, w, npix, pix, -0.5,
                       dtype=torch.bfloat16).numpy()
    assert _rel(low, want) > 1e-4
