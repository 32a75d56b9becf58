"""
The port's FISTA (``models/fista.py``) against the JAX package's, on
the CPU, with both operators built from one JAX plan
(``plan_from_fields``); the JAX side runs its XLA path.

* ``power_method_step_size`` matches JAX's to 1e-4 relative;
* ``fista_clean`` (5 iterations) matches JAX's model, residual and
  trace to 1e-4 of their max; the soft threshold is discontinuous, so
  the count of pixels whose support (model > 0) differs is reported in
  the assertion messages;
* the port of ``tests/test_fista.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu.invert import StokesIGridderInput as JaxGridderInput
from ska_sdp_cip_tpu.models import fista as jfista
from ska_sdp_cip_tpu.models import operators as jops
from ska_sdp_cip_tpu_torch import VisibilityReader
from ska_sdp_cip_tpu_torch.invert import (
    StokesIGridderInput,
    pixel_size_lm_from_asec,
)
from ska_sdp_cip_tpu_torch.models import MeasurementOperator
from ska_sdp_cip_tpu_torch.models import fista as tfista
from ska_sdp_cip_tpu_torch.ops import plan as tplan

torch.set_num_threads(1)

RTOL = 1e-4


@pytest.fixture(scope="module")
def operators(reader):
    gi = JaxGridderInput.from_reader(reader)
    jax_op = jops.MeasurementOperator.build(
        gi.uvw, gi.channel_frequencies, gi.effective_weights(), 128,
        pixel_size_lm_from_asec(30.0), epsilon=1e-4,
    )
    plan = tplan.plan_from_fields(dataclasses.asdict(jax_op.plan))
    port_op = MeasurementOperator.from_plan(plan, gi.effective_weights(),
                                            device="cpu")
    return jax_op, port_op, gi.visibilities.ravel()


def test_power_method_matches_jax(operators):
    jax_op, port_op, _ = operators
    # The weights are padded to the plan's slot count; the forward
    # output is the data's length.
    assert port_op.weights.shape[0] == port_op.plan.num_vis
    assert port_op.forward(np.zeros((128, 128), np.float32))[0].shape[0] == (
        port_op.plan.num_vis_data)
    ours = tfista.power_method_step_size(port_op)
    ref = jfista.power_method_step_size(jax_op)
    assert isinstance(ours, float)
    assert abs(ours - ref) <= RTOL * abs(ref)
    assert ours > 0.0


@pytest.mark.parametrize("nonneg", [True, False])
def test_fista_matches_jax(operators, nonneg):
    jax_op, port_op, vis = operators
    kwargs = dict(num_iter=5, lam_factor=5e-2, nonneg=nonneg)
    ref_model, ref_res, ref_trace = jfista.fista_clean(jax_op, vis, **kwargs)
    model, res, trace = tfista.fista_clean(port_op, vis, **kwargs)
    assert model.device.type == res.device.type == "cpu"
    assert trace.dtype == np.float64 and trace.shape == (5,)
    model, res = model.numpy(), res.numpy()
    support = int(np.count_nonzero((model > 0) != (ref_model > 0)))
    note = f"{support} of {model.size} pixels differ in support"
    scale = np.abs(ref_model).max()
    assert np.abs(model - ref_model).max() <= RTOL * scale, note
    assert np.abs(res - ref_res).max() <= RTOL * np.abs(ref_res).max(), note
    assert np.abs(trace - ref_trace).max() <= RTOL * ref_trace.max(), note
    if nonneg:
        assert model.min() >= 0.0
    else:
        assert model.min() < 0.0


def test_fista_recovers_sparse_sky(dataset_path):
    gi = StokesIGridderInput.from_reader(VisibilityReader(dataset_path))
    op = MeasurementOperator.build(
        gi.uvw, gi.channel_frequencies, gi.effective_weights(), 96,
        pixel_size_lm_from_asec(40.0), epsilon=1e-3, device="cpu",
    )
    vis = gi.visibilities.ravel()
    dirty_peak = float(op.dirty_image(vis).abs().max())
    model, residual, trace = tfista.fista_clean(op, vis, num_iter=15,
                                                lam_factor=5e-2)
    model, residual = model.numpy(), residual.numpy()
    # Model is sparse and nonnegative
    assert model.min() >= 0.0
    assert (model > 1e-3).sum() < 0.2 * model.size
    assert model.max() > 0.1
    # Gradient magnitude decreased substantially
    assert trace[-1] < 0.7 * trace[0]
    # Residual well below the dirty peak
    assert np.abs(residual).max() < 0.8 * dirty_peak
