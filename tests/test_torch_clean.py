"""
The torch port's measurement operator and solvers against the JAX
package's, on the CPU. Both operators are built from one JAX plan
(``plan_from_fields``); the JAX side runs its XLA path.

* ``MeasurementOperator`` ``psf``, ``dirty_image``, ``model_slots``,
  ``residual_gradient``, ``forward`` and ``adjoint`` to 1e-5 of the max
  (``tests/test_slot_space.py``'s tolerances);
* ``hogbom_clean``, exact and Clark, on seeded inputs whose peaks are
  distinct (argmax ties cannot fork): model and residual to 1e-6;
* ``major_cycle_clean``, 3 cycles: model to 1e-4 of its max, residual
  max below 0.6 x the dirty peak (``tests/test_clean.py``);
* a checkpoint written by the JAX major cycle resumes in the port, and
  ``models/checkpoint.py`` is a verbatim copy;
* ``restore_image`` and ``build_major_cycle_step``.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu.invert import StokesIGridderInput, pixel_size_lm_from_asec
from ska_sdp_cip_tpu.models import checkpoint as jckpt
from ska_sdp_cip_tpu.models import clean as jclean
from ska_sdp_cip_tpu.models import operators as jops
from ska_sdp_cip_tpu.models import restore as jrestore
from ska_sdp_cip_tpu_torch.models import checkpoint as tckpt
from ska_sdp_cip_tpu_torch.models import clean as tclean
from ska_sdp_cip_tpu_torch.models import operators as tops
from ska_sdp_cip_tpu_torch.models import restore as trestore
from ska_sdp_cip_tpu_torch.ops import plan as tplan

torch.set_num_threads(1)

NUM_PIXELS = 128
PIXEL_SIZE_ASEC = 30.0
OPERATOR_RTOL = 1e-5


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(got, ref):
    ref = _np(ref)
    return np.abs(_np(got) - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def operators(reader):
    gi = StokesIGridderInput.from_reader(reader)
    jax_op = jops.MeasurementOperator.build(
        gi.uvw, gi.channel_frequencies, gi.effective_weights(), NUM_PIXELS,
        pixel_size_lm_from_asec(PIXEL_SIZE_ASEC), epsilon=1e-4,
    )
    plan = tplan.plan_from_fields(dataclasses.asdict(jax_op.plan))
    port_op = tops.MeasurementOperator.from_plan(
        plan, gi.effective_weights(), device="cpu"
    )
    return jax_op, port_op, gi.visibilities.ravel()


@pytest.mark.parametrize(
    "method",
    ["psf", "dirty_image", "model_slots", "residual_gradient", "forward",
     "adjoint"],
)
def test_operator_matches_jax(operators, method):
    jax_op, port_op, vis = operators
    image = np.random.default_rng(9).normal(
        size=(NUM_PIXELS, NUM_PIXELS)
    ).astype(np.float32)
    if method == "psf":
        pairs = [(port_op.psf(), jax_op.psf())]
    elif method == "dirty_image":
        pairs = [(port_op.dirty_image(vis), jax_op.dirty_image(vis))]
    elif method == "model_slots":
        pairs = zip(port_op.model_slots(image), jax_op.model_slots(image))
    elif method == "residual_gradient":
        pairs = [(port_op.residual_gradient(image, vis),
                  jax_op.residual_gradient(image, vis))]
    elif method == "forward":
        pairs = zip(port_op.forward(image), jax_op.forward(image))
    else:
        weighted = vis * np.asarray(jax_op.weights)[: vis.size]
        re = weighted.real.astype(np.float32)
        im = weighted.imag.astype(np.float32)
        pairs = [(port_op.adjoint(re, im),
                  jax_op.adjoint(jnp.asarray(re), jnp.asarray(im)))]
    for got, ref in pairs:
        assert _np(got).shape == _np(ref).shape
        assert _rel(got, ref) <= OPERATOR_RTOL
    staged = port_op.stage(vis)
    assert port_op.stage(staged) is staged
    assert isinstance(staged, tops.SlotVis)


def _distinct_peak_problem(npix=128, seed=21):
    """A compact Gaussian PSF and a dirty image of three sources plus
    noise (``tests/test_clean.py``): every peak the minor cycle meets
    is distinct."""
    rng = np.random.default_rng(seed)
    psf = np.zeros((npix, npix), np.float32)
    axis = np.arange(-15, 16)
    core = np.exp(-0.5 * np.add.outer(axis**2, axis**2) / 9.0)
    psf[npix // 2 - 15 : npix // 2 + 16, npix // 2 - 15 : npix // 2 + 16] = (
        core
    )
    dirty = 0.01 * rng.normal(size=(npix, npix)).astype(np.float32)
    for (i, j), flux in (((30, 100), 2.0), ((90, 40), 1.1), ((64, 64), 0.7)):
        rows = slice(max(i - 15, 0), i + 16)
        cols = slice(max(j - 15, 0), j + 16)
        dirty[rows, cols] += flux * core[: dirty[rows, cols].shape[0]]
    # A sidelobed PSF makes the exact and Clark paths differ.
    psf += 0.05 * np.cos(np.arange(npix) / 3.0)[None, :].astype(np.float32)
    return dirty, psf


@pytest.mark.parametrize("psf_patch", [None, 64], ids=["exact", "clark"])
@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_hogbom_matches_jax(psf_patch, threshold):
    dirty, psf = _distinct_peak_problem()
    ref_model, ref_res = jclean.hogbom_clean(
        jnp.asarray(dirty), jnp.asarray(psf), gain=0.2, max_iter=40,
        threshold=threshold, psf_patch=psf_patch,
    )
    model, res = tclean.hogbom_clean(
        torch.from_numpy(dirty), torch.from_numpy(psf), gain=0.2,
        max_iter=40, threshold=threshold, psf_patch=psf_patch,
    )
    np.testing.assert_allclose(model.numpy(), np.asarray(ref_model),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(res.numpy(), np.asarray(ref_res),
                               atol=1e-6, rtol=0)
    assert np.count_nonzero(model.numpy()) > 0


def test_major_cycle_matches_jax(operators):
    jax_op, port_op, vis = operators
    dirty_peak = float(np.abs(_np(port_op.dirty_image(vis))).max())
    ref_model, ref_res = jclean.major_cycle_clean(
        jax_op, vis, num_major=3, minor_iter=100
    )
    model, res = tclean.major_cycle_clean(
        port_op, vis, num_major=3, minor_iter=100
    )
    ref_model = np.asarray(ref_model)
    assert np.abs(model.numpy() - ref_model).max() <= 1e-4 * np.abs(
        ref_model
    ).max()
    assert _rel(res, ref_res) <= 1e-4
    assert model.numpy().sum() > 0
    assert np.abs(res.numpy()).max() < 0.6 * dirty_peak


def test_checkpoint_written_by_jax_resumes_in_port(operators, tmp_path):
    """
    The JAX major cycle's state after one of three cycles, in its
    checkpoint file, resumes in the port: two more cycles give the
    port's uninterrupted three-cycle result.
    """
    jax_op, port_op, vis = operators
    kwargs = dict(num_major=3, gain=0.1, minor_iter=50)
    config = {"num_pixels": NUM_PIXELS, "num_vis": port_op.plan.num_vis_data,
              "num_major": 3, "gain": 0.1, "minor_iter": 50}
    one_model, one_res = jclean.major_cycle_clean(
        jax_op, vis, num_major=1, gain=0.1, minor_iter=50
    )
    jckpt.MajorCycleCheckpoint(tmp_path, config).save(1, one_model, one_res)
    resumed = tclean.major_cycle_clean(port_op, vis, checkpoint_dir=tmp_path,
                                       **kwargs)
    whole = tclean.major_cycle_clean(port_op, vis, **kwargs)
    for got, want in zip(resumed, whole):
        assert _rel(got, want) <= 1e-4
    cycle, model, _ = jckpt.MajorCycleCheckpoint(tmp_path, config).load()
    assert cycle == 3
    np.testing.assert_array_equal(model, resumed[0].numpy())


def test_checkpoint_module_is_a_verbatim_copy():
    assert Path(tckpt.__file__).read_text() == Path(jckpt.__file__).read_text()


def test_restore_matches_jax(operators):
    jax_op, port_op, vis = operators
    psf = np.array(jax_op.psf())
    dirty, _ = _distinct_peak_problem()
    model = np.zeros_like(dirty)
    model[30, 100], model[90, 40] = 2.0, 1.1
    ours = trestore.restore_image(model, dirty, torch.from_numpy(psf),
                                  device="cpu")
    ref = jrestore.restore_image(model, dirty, psf)
    assert ours.dtype == np.float32
    assert _rel(ours, ref) <= 1e-5
    assert trestore.fit_restoring_beam(psf) == jrestore.fit_restoring_beam(psf)


def test_major_cycle_step_matches_jax(operators):
    jax_op, port_op, vis = operators
    staged, jstaged = port_op.stage(vis), jax_op.stage(vis)
    step = tclean.build_major_cycle_step(port_op, minor_iter=30)
    jstep = jclean.build_major_cycle_step(jax_op, minor_iter=30)
    model = step(torch.zeros((NUM_PIXELS, NUM_PIXELS)), *staged)
    ref = jstep(jnp.zeros((NUM_PIXELS, NUM_PIXELS)), *jstaged)
    assert _rel(model, ref) <= 1e-4
    assert model.numpy().max() > 0
