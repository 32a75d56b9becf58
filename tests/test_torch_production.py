"""
The production configuration on the CPU: the host side at full size,
and a small FFT-dominated problem end to end.

* (host side) ``scripts/production_bench.py``'s configuration (the CSD3
  deployment: 10240 px at 1.1 asec, epsilon 1e-4, ``sigma="auto"``,
  ``synthetic_uvw(4, 64, max_baseline_m=7700, seed=11)``, 32 channels
  over 1.40-1.507 GHz, 258,048 visibilities): the port's planner
  builds the JAX planner's plan exactly (sigma 1.5, ngrid 15360,
  support 8, 10 w-planes in groups of 2, alloc 15408 x 15744, 3271
  blocks, 418,688 slots, every slot column and block table), its
  fused-pass geometry at n = 15360 (out- and in-cropped) is the JAX
  geometry, and its
  float32 factors equal the JAX hi + lo factor pairs to the pair's own
  precision (2e-5, as ``tests/test_torch_fft.py``). No transform of
  that size runs here.
* (end to end) 512 px at 10 asec with 1,984 visibilities, where
  ``sigma="auto"`` resolves to 1.5 (ngrid 768, support 8):
  ``dirty_image`` and ``predict_visibilities`` against the JAX package
  at the tolerances of ``tests/test_torch_invert.py`` /
  ``tests/test_torch_predict.py`` (2e-5 of max, the reference's own
  Pallas-vs-XLA gap doubled), and the invert against the explicit DFT
  at sampled pixels (1e-4); ``major_cycle_clean`` on the Clark minor
  cycle (explicit ``psf_patch``) against the JAX solver on one plan
  (``tests/test_torch_clean.py``'s tolerances).

At sigma 1.5 the reference's Pallas gridder (interpret mode) is 9.2e-5
of max from the DFT while its XLA path is 6.1e-6 and the port 8.0e-6
(ROADMAP.md C2): the invert is held to the XLA path at 2e-5 and to the
Pallas path only at the 1e-4 contract that the Pallas path itself
meets.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu.io.synth import synthetic_uvw
from ska_sdp_cip_tpu.models import clean as jclean
from ska_sdp_cip_tpu.models import operators as jops
from ska_sdp_cip_tpu.ops import fft as jfft
from ska_sdp_cip_tpu.ops import fft_pallas as jfp
from ska_sdp_cip_tpu.ops import gridder as jg
from ska_sdp_cip_tpu.ops import plan as jplan
from ska_sdp_cip_tpu_torch import native as tnative
from ska_sdp_cip_tpu_torch.models import clean as tclean
from ska_sdp_cip_tpu_torch.models import operators as tops
from ska_sdp_cip_tpu_torch.ops import fft as tfft
from ska_sdp_cip_tpu_torch.ops import fft_cuda as tfc
from ska_sdp_cip_tpu_torch.ops import gridder as tg
from ska_sdp_cip_tpu_torch.ops import plan as tplan
from ska_sdp_cip_tpu_torch.ops.dft import SPEED_OF_LIGHT

torch.set_num_threads(1)

JAX_RTOL = 2 * 1.03e-5
DFT_RTOL = 1e-4


def _production_inputs():
    uvw, _ = synthetic_uvw(4, 64, max_baseline_m=7700.0, seed=11)
    freqs = np.linspace(1.40e9, 1.507e9, 32)
    pixel = float(np.sin(np.radians(1.1 / 3600.0)))
    return uvw, freqs, pixel


def test_production_plan_matches_jax(monkeypatch):
    # The copy's numpy path; tests/test_torch_native.py holds the native
    # engine to it at this configuration.
    monkeypatch.setattr(tnative, "available", lambda: False)
    uvw, freqs, pixel = _production_inputs()
    ref = jplan.make_plan(uvw, freqs, 10240, pixel, sigma="auto")
    ours = tplan.make_plan(uvw, freqs, 10240, pixel, sigma="auto")
    want = {"sigma": 1.5, "ngrid": 15360, "support": 8, "nplanes": 10,
            "plane_group": 2, "nalloc_x": 15408, "nalloc_y": 15744,
            "num_blocks": 3271, "num_vis": 418688, "num_vis_data": 258048}
    for name, value in want.items():
        assert getattr(ours, name) == getattr(ref, name) == value, name
    assert ours.num_groups == 5
    # Every field the port's plan has, the slot columns (order, flip,
    # x0, y0, fx, fy, ws) and block tables included: exactly equal.
    names = {f.name for f in dataclasses.fields(ours)}
    assert names == ({f.name for f in dataclasses.fields(ref)}
                     - tplan.COUNTERPART_ONLY_FIELDS)
    for name in sorted(names):
        a, b = getattr(ours, name), getattr(ref, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name
    # The planner copy carries the JAX plan into the port unchanged.
    carried = tplan.plan_from_fields(dataclasses.asdict(ref))
    np.testing.assert_array_equal(carried.order, ours.order)
    assert carried.num_blocks == ours.num_blocks


@pytest.mark.parametrize("kind", ["out_crop", "in_crop"])
def test_production_fft_geometry_and_factors_match_jax(kind):
    n, npix = 15360, 10240
    crop = ((n - npix) // 2, npix)
    args = ((crop,), {}) if kind == "out_crop" else ((None,),
                                                      {"in_crop": crop})
    jplan_f = jfft.make_fft_plan(n, shifted=True)
    tplan_f = tfft.make_fft_plan(n, shifted=True)
    jmeta = jfp.fused_pass_meta(jplan_f, *args[0], **args[1])
    tmeta = tfc.fused_pass_meta(tplan_f, *args[0], **args[1])
    assert dataclasses.asdict(tmeta) == dataclasses.asdict(jmeta)
    assert (tmeta.n1, tmeta.n2, tmeta.c) == (120, 128, 64)
    if kind == "out_crop":
        assert (tmeta.qb, tmeta.qs, tmeta.trim0, tmeta.size) == (1, 86, 40,
                                                                  10240)
    else:
        assert (tmeta.n1_in, tmeta.qb, tmeta.qs) == (80, 2, 64)
    sign = +1 if kind == "out_crop" else -1
    ours = tfc.fused_pass_host_arrays(tplan_f, tmeta, sign=sign, prefix="p")
    ref = jfp.fused_pass_host_arrays(jplan_f, jmeta, sign=sign, prefix="p")
    shapes = {"out_crop": ((240, 240), (1, 2, 172, 128)),
              "in_crop": ((240, 160), (2, 2, 128, 128))}[kind]
    for name, shape in zip(("m1", "m2"), shapes):
        hi = np.asarray(ref[f"p_{name}_hi"]).astype(np.float32)
        lo = np.asarray(ref[f"p_{name}_lo"]).astype(np.float32)
        assert ours[f"p_{name}"].shape == shape
        np.testing.assert_allclose(ours[f"p_{name}"], hi + lo, atol=2e-5)
    for name in ("twc", "tws"):
        np.testing.assert_array_equal(ours[f"p_{name}"], ref[f"p_{name}"])


NPIX = 512
PIXEL = float(np.sin(np.radians(10.0 / 3600.0)))


@pytest.fixture(scope="module")
def small():
    """An FFT-dominated problem: many pixels, few visibilities."""
    uvw, _ = synthetic_uvw(2, 32, max_baseline_m=7700.0, seed=11)
    freqs = np.linspace(1.40e9, 1.507e9, 2)
    rng = np.random.default_rng(7)
    shape = (len(uvw), len(freqs))
    vis = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64
    )
    wgt = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    image = rng.normal(size=(NPIX, NPIX)).astype(np.float32)
    return uvw, freqs, vis, wgt, image


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


def test_small_config_resolves_sigma_1_5(small):
    uvw, freqs = small[:2]
    ours = tplan.make_plan(uvw, freqs, NPIX, PIXEL, sigma="auto")
    ref = jplan.make_plan(uvw, freqs, NPIX, PIXEL, sigma="auto")
    assert ours.sigma == ref.sigma == 1.5
    assert ours.ngrid == ref.ngrid == 768
    assert ours.support == ref.support == 8
    assert ours.num_vis_data == 1984


def _dft_at(uvw, freqs, wvis, pts):
    """The unnormalized explicit DFT dirty image (``ops/dft.py``'s
    formula, float64) at pixels ``pts`` (n, 2)."""
    x = (pts[:, 0] - NPIX // 2) * PIXEL
    y = (pts[:, 1] - NPIX // 2) * PIXEL
    r2 = x * x + y * y
    nm1 = -r2 / (1.0 + np.sqrt(1.0 - r2))
    acc = np.zeros(len(pts))
    for c, freq in enumerate(freqs):
        u, v, w = (uvw * (freq / SPEED_OF_LIGHT)).T
        phase = 2 * np.pi * (np.outer(u, x) + np.outer(v, y)
                             - np.outer(w, nm1))
        acc += (wvis[:, c, None] * np.exp(1j * phase)).real.sum(0)
    return acc / (nm1 + 1.0)


@pytest.mark.parametrize("path", ["xla", "pallas_interpret"])
def test_fft_dominated_invert_matches_jax_and_dft(small, path, monkeypatch):
    uvw, freqs, vis, wgt, _ = small
    ours = tg.dirty_image(uvw, freqs, vis, wgt, NPIX, PIXEL, sigma="auto",
                          device="cpu")
    monkeypatch.setenv("CIP_GRIDDER", path)
    monkeypatch.setenv("CIP_AOT", "0")
    ref = jg.dirty_image(uvw, freqs, vis, wgt, NPIX, PIXEL, sigma="auto")
    assert ours.shape == (NPIX, NPIX)
    # C2: the reference's Pallas path meets only the 1e-4 contract here.
    assert _rel(ours, ref) <= (JAX_RTOL if path == "xla" else DFT_RTOL)
    pts = np.random.default_rng(3).integers(0, NPIX, size=(256, 2))
    dft = _dft_at(uvw, freqs, (vis * wgt).astype(np.complex128), pts)
    err = np.abs(ours[pts[:, 0], pts[:, 1]] - dft).max()
    assert err <= DFT_RTOL * np.abs(dft).max()


@pytest.mark.parametrize("path", ["xla", "pallas_interpret"])
def test_fft_dominated_predict_matches_jax(small, path, monkeypatch):
    uvw, freqs, _, _, image = small
    ours = tg.predict_visibilities(uvw, freqs, image, PIXEL, sigma="auto",
                                   device="cpu")
    monkeypatch.setenv("CIP_GRIDDER", path)
    monkeypatch.setenv("CIP_AOT", "0")
    ref = jg.predict_visibilities(uvw, freqs, image, PIXEL, sigma="auto")
    assert ours.shape == ref.shape == (len(uvw), len(freqs))
    assert _rel(ours, ref) <= JAX_RTOL


def test_clark_major_cycle_matches_jax_on_one_plan(small):
    """Three major cycles with the Clark minor cycle (a 128-cell PSF
    patch) on one sigma-1.5 plan: model to 1e-4 of its max, residual to
    1e-4, residual below 0.6 x the dirty peak."""
    uvw, freqs, _, wgt, _ = small
    # Five point sources at pixel centres, as predict_dft would give.
    rng = np.random.default_rng(11)
    pix = rng.integers(NPIX // 4, 3 * NPIX // 4, size=(5, 2))
    flux = rng.uniform(0.5, 3.0, size=5)
    x = (pix[:, 0] - NPIX // 2) * PIXEL
    y = (pix[:, 1] - NPIX // 2) * PIXEL
    r2 = x * x + y * y
    nm1 = -r2 / (1.0 + np.sqrt(1.0 - r2))
    lf = freqs / SPEED_OF_LIGHT
    u, v, w = (uvw[:, None, :] * lf[None, :, None]).transpose(2, 0, 1)
    phase = (u[..., None] * x + v[..., None] * y - w[..., None] * nm1)
    vis = (flux / (nm1 + 1.0) * np.exp(-2j * np.pi * phase)).sum(-1)
    jax_op = jops.MeasurementOperator.build(uvw, freqs, wgt, NPIX, PIXEL,
                                            sigma="auto")
    assert jax_op.plan.sigma == 1.5
    port_op = tops.MeasurementOperator.from_plan(
        tplan.plan_from_fields(dataclasses.asdict(jax_op.plan)), wgt,
        device="cpu",
    )
    vis = vis.ravel().astype(np.complex64)
    ref_model, ref_res = jclean.major_cycle_clean(
        jax_op, vis, num_major=3, minor_iter=60, psf_patch=128
    )
    model, res = tclean.major_cycle_clean(
        port_op, vis, num_major=3, minor_iter=60, psf_patch=128
    )
    ref_model = np.asarray(ref_model)
    assert np.abs(model.numpy() - ref_model).max() <= 1e-4 * np.abs(
        ref_model).max()
    assert _rel(res.numpy(), ref_res) <= 1e-4
    dirty_peak = float(np.abs(port_op.dirty_image(vis).numpy()).max())
    assert np.abs(res.numpy()).max() < 0.6 * dirty_peak
    brightest = np.unravel_index(np.argmax(model.numpy()), model.shape)
    assert tuple(brightest) == tuple(pix[np.argmax(flux)])
