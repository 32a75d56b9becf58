"""
The torch port's predict (degridding, the adjoint of invert) on the
CPU, against the JAX package and the explicit DFT:

* ``predict_visibilities`` against the JAX ``predict_visibilities`` on
  its Pallas path (kernels in interpret mode,
  ``CIP_GRIDDER=pallas_interpret``) to 2e-5 of the max — the
  reference's own Pallas-vs-XLA gap (1.03e-5), doubled — with and
  without w-stacking;
* against ``ops/dft.py:predict_dft`` to the 1e-4 contract (point
  sources, as ``tests/test_gridder_accuracy.py``);
* the dot-product adjoint identity ``<invert(v), I> = Re<v,
  predict(I)>`` at rel 1e-4;
* ``dirty2ms`` against the JAX ``dirty2ms``;
* the copied host helpers (``plan_order_host``, ``stage_slot_vis``,
  ``stage_slot_weights``, ``slot_duplicate_pairs``) equal to the JAX
  ones, and ``slot_group_sum``/``_unfold_wraps`` against theirs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu.io.synth import synthetic_uvw
from ska_sdp_cip_tpu.ops import gridder as jg
from ska_sdp_cip_tpu.ops import plan as jplan
from ska_sdp_cip_tpu_torch import dirty2ms, predict_visibilities
from ska_sdp_cip_tpu_torch import native as tnative
from ska_sdp_cip_tpu_torch.ops import gridder as tg
from ska_sdp_cip_tpu_torch.ops import plan as tplan
from ska_sdp_cip_tpu_torch.ops.dft import predict_dft

torch.set_num_threads(1)

NPIX = 128
PIXEL = float(np.sin(np.radians(20.0 / 3600.0)))
PALLAS_RTOL = 2 * 1.03e-5
DFT_RTOL = 1e-4


@pytest.fixture(scope="module")
def problem():
    uvw, _ = synthetic_uvw(3, 16, max_baseline_m=4000.0, seed=11)
    freqs = np.linspace(1.3e9, 1.45e9, 3)
    rng = np.random.default_rng(1)
    image = rng.normal(size=(NPIX, NPIX)).astype(np.float32)
    shape = (len(uvw), len(freqs))
    vis = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64
    )
    return uvw, freqs, image, vis


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("wstack", [True, False], ids=["wstack", "no_wstack"])
def test_predict_matches_jax_pallas(problem, wstack, monkeypatch):
    uvw, freqs, image, _ = problem
    ours = predict_visibilities(uvw, freqs, image, PIXEL,
                                do_wstacking=wstack, device="cpu")
    monkeypatch.setenv("CIP_GRIDDER", "pallas_interpret")
    ref = jg.predict_visibilities(uvw, freqs, image, PIXEL,
                                  do_wstacking=wstack)
    assert ours.shape == ref.shape == (len(uvw), len(freqs))
    assert ours.dtype == np.complex64
    assert _rel(ours, ref) <= PALLAS_RTOL


@pytest.mark.parametrize("wstack", [True, False], ids=["wstack", "no_wstack"])
def test_predict_matches_dft_point_sources(wstack):
    uvw, _ = synthetic_uvw(2, 6, max_baseline_m=2000.0, seed=3)
    freqs = np.array([1.2e9])
    npix = 64
    pixel = float(np.sin(np.radians(40.0 / 3600.0)))
    image = np.zeros((npix, npix), np.float32)
    image[npix // 2 + 5, npix // 2 - 3] = 1.7
    image[npix // 2 - 9, npix // 2 + 8] = 0.8
    ref = predict_dft(uvw, freqs, image, pixel, apply_w=wstack)
    ours = predict_visibilities(uvw, freqs, image, pixel, epsilon=1e-5,
                                do_wstacking=wstack, device="cpu")
    assert _rel(ours, ref) < DFT_RTOL


@pytest.mark.parametrize("wstack", [True, False], ids=["wstack", "no_wstack"])
def test_predict_is_adjoint_of_invert(problem, wstack):
    uvw, freqs, image, vis = problem
    wgt = np.ones(vis.shape, np.float32)
    dirty = tg.dirty_image(uvw, freqs, vis, wgt, NPIX, PIXEL,
                           do_wstacking=wstack, device="cpu")
    model = predict_visibilities(uvw, freqs, image, PIXEL,
                                 do_wstacking=wstack, device="cpu")
    lhs = float(np.vdot(image.astype(np.float64), dirty.astype(np.float64)))
    rhs = float(np.real(np.vdot(model.astype(np.complex128),
                                vis.astype(np.complex128))))
    assert lhs == pytest.approx(rhs, rel=1e-4)


def test_dirty2ms_matches_jax(problem):
    from ska_sdp_cip_tpu.wgridder import dirty2ms as jax_dirty2ms

    uvw, freqs, image, vis = problem
    wgt = np.random.default_rng(2).uniform(0.5, 2.0, vis.shape)
    mask = (np.arange(vis.size).reshape(vis.shape) % 7 != 0).astype(
        np.float32
    )
    ours = dirty2ms(uvw, freqs, image, wgt, PIXEL, PIXEL, 1e-4, True,
                    nthreads=4, mask=mask, device="cpu")
    ref = jax_dirty2ms(uvw, freqs, image, wgt, PIXEL, PIXEL, 1e-4, True,
                       nthreads=4, mask=mask)
    assert _rel(ours, ref) <= PALLAS_RTOL
    assert np.all(ours[mask == 0] == 0)
    with pytest.raises(NotImplementedError):
        dirty2ms(uvw, freqs, image, None, PIXEL, 2 * PIXEL, device="cpu")


@pytest.fixture(scope="module")
def plans(problem):
    uvw, freqs, _, vis = problem
    plan = jplan.make_plan(uvw, freqs, NPIX, PIXEL)
    return plan, tplan.plan_from_fields(dataclasses.asdict(plan)), vis


def test_copied_slot_helpers_match_jax(plans, monkeypatch):
    # The copies' numpy branches (tests/test_torch_native.py holds the
    # native engine's to them).
    monkeypatch.setattr(tnative, "available", lambda: False)
    plan, port_plan, vis = plans
    host, ref = tg.plan_order_host(port_plan), jg.plan_order_host(plan)
    assert sorted(host) == sorted(ref)
    for key in host:
        np.testing.assert_array_equal(host[key], ref[key], err_msg=key)
    flat = vis.ravel()
    for got, want in zip(tg.stage_slot_vis(port_plan, flat.real, flat.imag),
                         jg.stage_slot_vis(plan, flat.real, flat.imag)):
        np.testing.assert_array_equal(got, want)
    weights = np.random.default_rng(4).uniform(0.5, 2.0, flat.size)
    np.testing.assert_array_equal(tg.stage_slot_weights(port_plan, weights),
                                  jg.stage_slot_weights(plan, weights))
    dup = tg.slot_duplicate_pairs(port_plan)
    ref_dup = jg.slot_duplicate_pairs(plan)
    assert len(dup[0]) > 0
    for got, want in zip(dup, ref_dup):
        np.testing.assert_array_equal(got, want)


def test_slot_group_sum_matches_jax(plans):
    plan, port_plan, _ = plans
    dup_a, dup_b = tg.slot_duplicate_pairs(port_plan)
    rng = np.random.default_rng(6)
    re, im = rng.normal(size=(2, plan.num_vis)).astype(np.float32)
    ours = tg.slot_group_sum(
        torch.from_numpy(re), torch.from_numpy(im),
        torch.from_numpy(dup_a.astype(np.int64)),
        torch.from_numpy(dup_b.astype(np.int64)),
    )
    ref = jg.slot_group_sum(jnp.asarray(re), jnp.asarray(im),
                            jnp.asarray(dup_a), jnp.asarray(dup_b))
    for got, want in zip(ours, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    empty = torch.zeros(0, dtype=torch.int64)
    same = tg.slot_group_sum(torch.from_numpy(re), torch.from_numpy(im),
                             empty, empty)
    assert torch.equal(same[0], torch.from_numpy(re))


def test_unfold_wraps_matches_jax(plans):
    plan, port_plan, _ = plans
    rng = np.random.default_rng(8)
    grid = rng.normal(size=(plan.ngrid, plan.ngrid)).astype(np.float32)
    out = torch.zeros((plan.nalloc_x, plan.nalloc_y))
    tg._unfold_wraps(port_plan, torch.from_numpy(grid), out)
    ref = jg._unfold_wraps(plan, jnp.asarray(grid))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # The fold is its adjoint: <fold(a), g> == <a, unfold(g)>.
    alloc = rng.normal(size=out.shape).astype(np.float32)
    folded = tg._fold_wraps(port_plan, torch.from_numpy(alloc)).numpy()
    lhs = np.vdot(folded.astype(np.float64), grid.astype(np.float64))
    rhs = np.vdot(alloc.astype(np.float64), out.numpy().astype(np.float64))
    assert lhs == pytest.approx(rhs, rel=1e-6)  # float32 fold sums


def test_predict_options():
    uvw, _ = synthetic_uvw(2, 6, max_baseline_m=2000.0, seed=3)
    image = np.zeros((64, 64), np.float32)
    with pytest.raises(TypeError):
        predict_visibilities(uvw, [1.2e9], image, PIXEL)  # no device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            predict_visibilities(uvw, [1.2e9], image, PIXEL, device="cuda")
