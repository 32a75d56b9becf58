"""
The taper maps' plain version on the CPU, the oracle that kernel T1
(``csrc/taper.cu``, ``ops/taper_cuda.py``) is held to on the card.

* ``_geometry_maps`` on CPU tensors, with and without w-stacking, at
  small geometries (an odd image, and sigma 1.5 with support 8, the
  production rule) against the same maps in float64 from
  ``correction_np``: within 1.5e-6 of each map's largest value (the
  plain version reads at most 7.6e-7, float32 rounding of the
  quadrature's cosines and sums; the sigma 1.5 case the most).
* The same plain maps against the JAX package's
  (``compute_geometry_maps``) on the same plan, at the same geometries:
  within 3e-6 of each map's largest value (measured: ``inv_corr``
  1.33e-6 at sigma 1.5 with support 8, where c(k) is steep at the
  band's edge, at most 4.3e-7 at the others; ``nm1s`` equal bit for
  bit but at sigma 1.5, 1.9e-7).
* The CPU path never loads the kernels' library nor counts a T1 launch:
  ``dirty_image`` and ``predict_visibilities`` on the CPU, with the
  library's loader made to raise, and no ``taper_kernel`` counter while
  the recorder is on.
* :func:`taper_maps` refuses what T1 does not take before it loads the
  library: other dtypes or shapes, more nodes than ``MAX_NODES``,
  tensors off the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu.ops import gridder as jg
from ska_sdp_cip_tpu.ops import plan as jplan
from ska_sdp_cip_tpu_torch.invert import pixel_size_lm_from_asec
from ska_sdp_cip_tpu_torch.io.synth import synthetic_uvw
from ska_sdp_cip_tpu_torch.ops import _build
from ska_sdp_cip_tpu_torch.ops import gridder as tg
from ska_sdp_cip_tpu_torch.ops import taper_cuda as ttc
from ska_sdp_cip_tpu_torch.ops.kernels import correction_np
from ska_sdp_cip_tpu_torch.ops.plan import make_plan, plan_from_fields
from ska_sdp_cip_tpu_torch.utils import task_metrics

torch.set_num_threads(1)

ORACLE_RTOL = 1.5e-6
JAX_RTOL = 3e-6

#: name -> (npix, asec, plan options).
GEOMETRIES = {
    "wstack": (96, 40.0, {}),
    "no_wstack": (96, 40.0, {"do_wstacking": False}),
    "odd": (97, 40.0, {}),
    "sigma15": (256, 20.0, {"sigma": 1.5}),
}


def _observation(seed=23):
    uvw, _ = synthetic_uvw(3, 10, max_baseline_m=5000.0, seed=seed)
    return uvw, np.linspace(1.0e9, 1.07e9, 2)


def _maps_f64(plan):
    """The maps of ``_geometry_maps`` in float64, from ``correction_np``."""
    npix = plan.num_pixels
    pix = np.arange(npix) - npix // 2
    corr = np.outer(*2 * [correction_np(pix / plan.ngrid, plan.support,
                                        plan.beta)])
    axis = pix * plan.pixel_size_lm
    r2 = axis[:, None] ** 2 + axis[None, :] ** 2
    nm1 = -r2 / (1.0 + np.sqrt(np.maximum(1.0 - r2, 0.0)))
    if plan.wstacking:
        corr = corr * correction_np(plan.dw * (nm1 - plan.n_mid),
                                    plan.support, plan.beta) * (nm1 + 1.0)
    return 1.0 / corr, nm1 - plan.n_mid


@pytest.mark.parametrize("name", GEOMETRIES)
def test_plain_maps_match_float64(name):
    npix, asec, opts = GEOMETRIES[name]
    uvw, freqs = _observation()
    plan = make_plan(uvw, freqs, npix, pixel_size_lm_from_asec(asec), **opts)
    assert plan.wstacking == opts.get("do_wstacking", True)
    if name == "sigma15":
        assert plan.support == 8 and len(plan.quad_nodes) == 24
    arrays = tg.stage_arrays(tg._quad_arrays(plan), "cpu")
    got = tg._geometry_maps(plan, arrays)
    for g, r in zip(got, _maps_f64(plan)):
        assert g.dtype == torch.float32 and g.shape == (npix, npix)
        err = np.abs(g.numpy().astype(np.float64) - r).max()
        assert err <= ORACLE_RTOL * np.abs(r).max()


@pytest.mark.parametrize("name", GEOMETRIES)
def test_plain_maps_match_jax(name):
    npix, asec, opts = GEOMETRIES[name]
    uvw, freqs = _observation()
    jax_plan = jplan.make_plan(uvw, freqs, npix,
                               pixel_size_lm_from_asec(asec), **opts)
    plan = plan_from_fields(dataclasses.asdict(jax_plan))
    assert plan.wstacking == opts.get("do_wstacking", True)
    expected = jg.compute_geometry_maps(jax_plan)
    arrays = tg.stage_arrays(tg._quad_arrays(plan), "cpu")
    got = tg._geometry_maps(plan, arrays)
    for key, g in zip(("inv_corr", "nm1s"), got):
        r = np.asarray(expected[key])
        assert g.shape == r.shape == (npix, npix)
        err = np.abs(g.numpy() - r).max()
        assert err <= JAX_RTOL * np.abs(r).max()


def test_cpu_path_never_loads_the_kernel(monkeypatch):
    def refuse():
        raise AssertionError("the CPU path loaded the CUDA library")

    monkeypatch.setattr(_build, "load_library", refuse)
    uvw, freqs = _observation(seed=5)
    rng = np.random.default_rng(5)
    shape = (len(uvw), len(freqs))
    vis = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)
    wgt = np.ones(shape, np.float32)
    image = rng.normal(size=(64, 64)).astype(np.float32)
    pixel = pixel_size_lm_from_asec(40.0)
    before = ttc.TAPER_LAUNCHES
    task_metrics.reset()
    with task_metrics.tracing() as recorder:
        tg.dirty_image(uvw, freqs, vis, wgt, 64, pixel, device="cpu")
        tg.predict_visibilities(uvw, freqs, image, pixel, device="cpu")
        counters = dict(recorder.counters)
    task_metrics.reset()
    assert ttc.TAPER_LAUNCHES == before
    assert "taper_kernel" not in counters
    assert counters["visibilities"] > 0


def _rule(n=24, **kw):
    return (torch.zeros(n, **kw), torch.zeros(n, **kw))


GEOMETRY = dict(npix=64, ngrid=128, support=8, pixel_size_lm=1e-4,
                wstacking=True, dw=10.0, n_mid=-1e-4)


@pytest.mark.parametrize("rule,error,match", [
    (_rule(), ValueError, "CUDA device"),
    (_rule(dtype=torch.float64), TypeError, "float32"),
    ((torch.zeros(24), torch.zeros(23)), ValueError, "one shape"),
    (_rule(ttc.MAX_NODES + 1), ValueError, "quadrature nodes"),
], ids=["cpu_tensors", "float64", "shapes", "too_many_nodes"])
def test_taper_maps_refuses_before_loading(monkeypatch, rule, error, match):
    def refuse():
        raise AssertionError("loaded the library before checking")

    monkeypatch.setattr(_build, "load_library", refuse)
    before = ttc.TAPER_LAUNCHES
    with pytest.raises(error, match=match):
        ttc.taper_maps(*rule, **GEOMETRY)
    assert ttc.TAPER_LAUNCHES == before
