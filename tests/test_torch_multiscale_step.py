"""
The port's multiscale major-cycle step (``models/multiscale.py``:
``build_multiscale_cycle_step``) on the CPU at 256 px:

* three steps from an empty model against the benchmark's plain
  reference (``cipbench/reference/multiscale.py``), whose residual
  images and PSF are explicit DFTs and whose frames, cross PSFs and
  minor cycle are its own: the same components after every cycle
  (exact and Clark paths; the default bias, under which scale 0 always
  wins, and a rising one, under which the larger scales are picked),
  values to 1e-3 of the largest;
* ``multiscale_clean`` is the step looped, bit for bit, though it
  starts from the dirty image: one invert and one gradient a cycle, no
  predict of the empty model;
* the cross PSFs are built once a step, however many cycles it runs;
* the spans and counters: recorded when traced (the picks by scale sum
  to the iterations), absent otherwise; the weighting's density pass
  is a span and counts its visibilities.
"""

import numpy as np
import pytest
import torch

from cipbench import extended, synth
from cipbench.reference import multiscale as ref_ms
from ska_sdp_cip_tpu_torch.models import MeasurementOperator
from ska_sdp_cip_tpu_torch.models import multiscale as tms
from ska_sdp_cip_tpu_torch.models.weighting import ImagingWeighter
from ska_sdp_cip_tpu_torch.utils import task_metrics

torch.set_num_threads(1)

NPIX = 256
ASEC = 20.0


@pytest.fixture(scope="module")
def problem():
    """A small observation of two point sources and a Gaussian, with
    noise and uniform weights 0.5-2 (some zero)."""
    uvw, _ = synth.synthetic_uvw(4, 8, max_baseline_m=1500.0, seed=7)
    freqs = np.array([1.40e9, 1.42e9])
    pix = synth.pixel_size_lm(ASEC)
    u = torch.as_tensor(uvw)
    f = torch.as_tensor(freqs)
    lm = torch.tensor([[30.0, -20.0], [-45.0, 10.0]], dtype=torch.float64)
    vis = synth.sky_visibilities(u, f, lm * pix, torch.tensor([2.0, 1.2]))
    vis += extended.gaussian_visibilities(
        u, f, torch.tensor([[10.0, 25.0]], dtype=torch.float64) * pix,
        torch.tensor([80.0 * extended.ASEC]), torch.tensor([1.5]))
    rng = np.random.default_rng(11)
    vis = vis.numpy() + 0.05 * (rng.normal(size=vis.shape)
                                + 1j * rng.normal(size=vis.shape))
    wgt = rng.uniform(0.5, 2.0, size=vis.shape).astype(np.float32)
    wgt[rng.random(vis.shape) < 0.03] = 0.0
    op = MeasurementOperator.build(uvw, freqs, wgt, NPIX, pix, epsilon=1e-6,
                                   device="cpu")
    return uvw, freqs, vis.astype(np.complex64), wgt, pix, op


CASES = {"exact-default": (None, 0.6), "clark-rising": (64, -0.8)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_the_plain_reference(problem, case):
    uvw, freqs, vis, wgt, pix, op = problem
    psf_patch, slope = CASES[case]
    kw = dict(scales=(0.0, 2.0, 4.0), bias_slope=slope, gain=0.2,
              minor_iter=30, psf_patch=psf_patch)
    step = tms.build_multiscale_cycle_step(op, **kw)
    staged = op.stage(vis)
    want = ref_ms.multiscale_clean_dft(uvw, freqs, vis, wgt, NPIX, pix,
                                       num_major=3, **kw)
    model = torch.zeros((NPIX, NPIX))
    for cycle, ref in enumerate(want):
        model = step(model, staged.re, staged.im)
        assert torch.equal(model != 0, ref != 0), cycle
        scale = float(ref.abs().max())
        assert float((model - ref).abs().max()) <= 1e-3 * scale, cycle
    if slope > 0:
        assert 0 < int((model != 0).sum()) <= 90
    else:
        # Blobs of the 4-px scale (19 x 19 cells) were picked.
        assert int((model != 0).sum()) > 19 * 19


def test_multiscale_clean_is_the_step_looped(problem):
    *_, vis, _, _, op = problem
    kw = dict(scales=(0.0, 2.0, 4.0), bias_slope=0.6, gain=0.2,
              minor_iter=20, psf_patch=64)
    model, residual = tms.multiscale_clean(op, vis, num_major=2, **kw)
    staged = op.stage(vis)
    step = tms.build_multiscale_cycle_step(op, **kw)
    want = torch.zeros((NPIX, NPIX))
    for _ in range(2):
        want = step(want, staged.re, staged.im)
    assert torch.equal(model, want)
    assert torch.equal(residual, -op.residual_gradient(want, staged))


def test_multiscale_clean_starts_from_the_dirty_image(problem, monkeypatch):
    *_, vis, _, _, op = problem
    calls = []
    for name in ("dirty_image", "residual_gradient", "model_slots"):
        real = getattr(MeasurementOperator, name)

        def counted(self, *args, _name=name, _real=real, **kwargs):
            calls.append(_name)
            return _real(self, *args, **kwargs)

        monkeypatch.setattr(MeasurementOperator, name, counted)
    tms.multiscale_clean(op, vis, scales=(0.0, 2.0), num_major=3, gain=0.2,
                         minor_iter=5, psf_patch=64)
    assert calls == ["dirty_image"] + ["residual_gradient", "model_slots"] * 3


def _traced_cycles(op, vis, cycles, psf_patch):
    staged = op.stage(vis)
    step = tms.build_multiscale_cycle_step(
        op, scales=(0.0, 2.0, 4.0), gain=0.2, minor_iter=25,
        psf_patch=psf_patch)
    model = torch.zeros((NPIX, NPIX))
    for _ in range(cycles):
        model = step(model, staged.re, staged.im)
    return task_metrics.summary()


@pytest.mark.parametrize("psf_patch", [None, 64], ids=["exact", "clark"])
def test_spans_and_counters_when_traced(problem, psf_patch):
    *_, vis, _, _, op = problem
    task_metrics.reset()
    with task_metrics.tracing():
        out = _traced_cycles(op, vis, 2, psf_patch)
    spans, counters = out["spans"], out["counters"]
    assert spans["multiscale.cross_psfs"]["count"] == 1
    assert spans["multiscale.frames"]["count"] == 2
    assert spans["multiscale.minor"]["count"] == 2
    for name in ("multiscale.frames", "multiscale.minor"):
        assert spans[name]["device_s"] > 0 and spans[name]["host_s"] > 0
    assert counters["multiscale_iterations"] == 50
    assert counters["scale_frames"] == 6
    picks = [counters.get(f"multiscale_picks.s{k}", 0) for k in range(3)]
    assert sum(picks) == 50 and picks[0] == 50
    # Read once: a second summary counts nothing twice.
    assert task_metrics.summary()["counters"] == counters
    task_metrics.reset()
    out = _traced_cycles(op, vis, 1, psf_patch)
    assert out == {"spans": {}, "counters": {}}


def test_weighting_density_span(problem):
    uvw, freqs, _, wgt, pix, _ = problem
    task_metrics.reset()
    weighter = ImagingWeighter(NPIX, pix, scheme="robust", robust=-0.5)
    with task_metrics.tracing():
        weighter.fit(uvw, freqs, wgt)
    out = task_metrics.summary()
    assert out["spans"]["weighting.density"]["count"] == 1
    assert out["counters"]["weighted_visibilities"] == wgt.size
    task_metrics.reset()
    weighter.fit(uvw, freqs, wgt)
    assert task_metrics.summary() == {"spans": {}, "counters": {}}


def test_cross_psfs_built_once_a_step(problem, monkeypatch):
    *_, vis, _, _, op = problem
    calls = []
    real = tms._neg_cross_psfs

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tms, "_neg_cross_psfs", counted)
    tms.multiscale_clean(op, vis, scales=(0.0, 2.0), num_major=3, gain=0.2,
                         minor_iter=5, psf_patch=64)
    assert len(calls) == 1
