"""
The port's multiscale CLEAN (``models/multiscale.py``) against the JAX
package's, on the CPU (the JAX side on its XLA path).

* ``scale_kernel`` is bit-equal to the JAX one;
* ``_conv_same`` (``conv2d``) matches ``lax.conv`` to 1e-6 of the max
  (2e-6 for the wide scale kernels, whose float32 sums torch orders
  less exactly) and to the float64 sum;
* the exact and Clark minor cycles match JAX's ``_multiscale_minor`` on
  seeded inputs whose peaks are well separated (argmax ties cannot
  fork): model and residual to 1e-5 of their max; a zero residual stops
  both at once;
* Clark equals exact when the patch holds every cross PSF (the port of
  ``tests/test_multiscale.py``'s test);
* ``multiscale_clean`` through one shared plan's operators matches
  JAX's to 1e-4 of the max;
* the ports of the two residual-reduction tests.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu.invert import StokesIGridderInput as JaxGridderInput
from ska_sdp_cip_tpu.models import multiscale as jms
from ska_sdp_cip_tpu.models import operators as jops
from ska_sdp_cip_tpu_torch import VisibilityReader
from ska_sdp_cip_tpu_torch.invert import (
    StokesIGridderInput,
    pixel_size_lm_from_asec,
)
from ska_sdp_cip_tpu_torch.models import MeasurementOperator
from ska_sdp_cip_tpu_torch.models import multiscale as tms
from ska_sdp_cip_tpu_torch.ops import plan as tplan

torch.set_num_threads(1)

MINOR_RTOL = 1e-5
SOLVER_RTOL = 1e-4


def _rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("scale,radius", [(0.0, 5), (2.0, 5), (4.0, 9),
                                          (8.0, 17), (1.5, 4)])
def test_scale_kernel_bit_equal_to_jax(scale, radius):
    ours = tms.scale_kernel(scale, radius)
    ref = jms.scale_kernel(scale, radius)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    assert abs(ours.sum() - 1.0) < 1e-6
    assert ours[radius, radius] == ours.max()


def _correlate64(image, kernel):
    """SAME cross-correlation in float64 (the exact reference)."""
    r = kernel.shape[0] // 2
    padded = np.pad(image.astype(np.float64), r)
    windows = np.lib.stride_tricks.sliding_window_view(padded, kernel.shape)
    return np.einsum("ijkl,kl->ij", windows, kernel.astype(np.float64))


@pytest.mark.parametrize("shape,scale,radius", [
    ((64, 64), None, 5), ((48, 80), None, 3), ((96, 96), 4.0, 9),
    ((96, 96), 8.0, 17), ((128, 128), 2.0, 17)])
def test_conv_same_matches_lax(shape, scale, radius):
    """
    1e-6 of the max against ``lax.conv``, and 1e-6 in the L2 norm. With
    the scale kernels of radius 9 and 17 (361 and 1225 products a pixel;
    17 is the default scales') torch's CPU convolution sums in float32 in
    an order that reads above 1e-6 of the max against the float64 sum,
    so there the max is held at 2e-6, and both sides to the float64
    sum.
    """
    rng = np.random.default_rng(sum(shape) + radius)
    # A residual image of the kind the minor cycle convolves: sources and
    # noise (on pure noise a wide kernel cancels the output down, and
    # float32 rounding reads larger against its max).
    image = _separated_problem()[0][-shape[0] :, -shape[1] :]
    # A random kernel is not symmetric: both are cross-correlations.
    kernel = (rng.normal(size=(2 * radius + 1,) * 2).astype(np.float32)
              if scale is None else tms.scale_kernel(scale, radius))
    ours = tms._conv_same(torch.from_numpy(image), torch.from_numpy(kernel))
    ref = np.asarray(jms._conv_same(jnp.asarray(image), jnp.asarray(kernel)))
    assert tuple(ours.shape) == shape
    assert _rel(ours, ref) <= (1e-6 if radius <= 5 else 2e-6)
    assert np.linalg.norm(ours.numpy() - ref) <= 1e-6 * np.linalg.norm(ref)
    exact = _correlate64(image, kernel)
    assert _rel(ours, exact) <= 2e-6 and _rel(ref, exact) <= 2e-6


def _separated_problem(npix=128, seed=41):
    """A compact Gaussian PSF with sidelobes and a dirty image of three
    well-separated sources plus noise: every peak the minor cycle meets
    is distinct across (scale, pixel)."""
    rng = np.random.default_rng(seed)
    psf = np.zeros((npix, npix), np.float32)
    axis = np.arange(-15, 16)
    core = np.exp(-0.5 * np.add.outer(axis**2, axis**2) / 9.0)
    c = npix // 2
    psf[c - 15 : c + 16, c - 15 : c + 16] = core
    psf += 0.05 * np.cos(np.arange(npix) / 3.0)[None, :].astype(np.float32)
    dirty = 0.01 * rng.normal(size=(npix, npix)).astype(np.float32)
    for (i, j), flux in (((30, 100), 2.0), ((90, 40), 1.1), ((64, 64), 0.7)):
        dirty[i - 15 : i + 16, j - 15 : j + 16] += flux * core
    # An extended source, which the larger scales model.
    blob = np.exp(-0.5 * np.add.outer(axis**2, axis**2) / 36.0)
    dirty[95 - 15 : 95 + 16, 95 - 15 : 95 + 16] += 1.5 * blob
    return dirty, psf


def _kernels(scales, radius):
    return np.stack([tms.scale_kernel(s, radius) for s in scales])


#: Peak-selection biases: the default slope (scale 0 always wins: a
#: unit-sum non-negative kernel never raises a residual's peak) and a
#: negative one, under which the extended source is modelled at scale
#: 2 and 4.
BIASES = {"default": [1.0, 0.85, 0.7], "rising": [1.0, 1.4, 1.8]}


@pytest.mark.parametrize("bias", sorted(BIASES))
@pytest.mark.parametrize("psf_patch", [None, 64], ids=["exact", "clark"])
def test_minor_cycle_matches_jax(psf_patch, bias):
    dirty, psf = _separated_problem()
    kernels = _kernels((0.0, 2.0, 4.0), 9)
    biases = np.array(BIASES[bias], np.float32)
    kwargs = dict(gain=0.2, max_iter=40, num_scales=3, psf_patch=psf_patch)
    ref_model, ref_res = jms._multiscale_minor(
        jnp.asarray(dirty), jnp.asarray(psf), jnp.asarray(kernels),
        jnp.asarray(biases), **kwargs)
    model, res = tms._multiscale_minor(
        torch.from_numpy(dirty), torch.from_numpy(psf),
        torch.from_numpy(kernels), torch.from_numpy(biases), **kwargs)
    assert _rel(model, ref_model) <= MINOR_RTOL
    assert _rel(res, ref_res) <= MINOR_RTOL
    components = np.count_nonzero(model.numpy())
    if bias == "default":
        assert 0 < components <= 40
    else:
        # Blobs of 19 x 19 cells: scales > 0 were picked.
        assert components > 19 * 19


def test_minor_cycle_stops_on_zero_residual():
    npix = 64
    psf = np.zeros((npix, npix), np.float32)
    psf[npix // 2, npix // 2] = 1.0
    kernels = torch.from_numpy(_kernels((0.0, 2.0), 5))
    biases = torch.tensor([1.0, 0.7])
    for patch in (None, 32):
        model, res = tms._multiscale_minor(
            torch.zeros((npix, npix)), torch.from_numpy(psf), kernels,
            biases, gain=0.1, max_iter=5, num_scales=2, psf_patch=patch)
        assert not model.any() and not res.any()


def test_clark_matches_exact_for_compact_psf():
    """When the cross PSFs are fully contained in the truncation patch,
    the Clark path makes the same (scale, pixel) choices and
    subtractions as the exact path."""
    npix = 128
    rng = np.random.default_rng(31)
    psf = np.zeros((npix, npix), np.float32)
    axis = np.arange(-7, 8)
    psf[npix // 2 - 7 : npix // 2 + 8, npix // 2 - 7 : npix // 2 + 8] = (
        np.exp(-0.5 * np.add.outer(axis**2, axis**2) / 4.0)
    )
    dirty = 0.02 * rng.normal(size=(npix, npix)).astype(np.float32)
    dirty[30, 100] += 2.0
    dirty[90, 40] += 1.2
    args = (torch.from_numpy(dirty), torch.from_numpy(psf),
            torch.from_numpy(_kernels((0.0, 2.0), 5)),
            torch.tensor([1.0, 0.7]))
    kwargs = dict(gain=0.2, max_iter=25, num_scales=2)
    exact = tms._multiscale_minor(*args, **kwargs)
    # Patch 64 >= psf support (15) + 2 kernel diameters (2 x 11).
    fast = tms._multiscale_minor(*args, psf_patch=64, **kwargs)
    for got, want in zip(fast, exact):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)
    with pytest.raises(ValueError, match="even"):
        tms._multiscale_minor(*args, psf_patch=63, **kwargs)
    with pytest.raises(ValueError, match="exceeds"):
        tms._multiscale_minor(*args, psf_patch=112, **kwargs)


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


@pytest.mark.parametrize("bias_slope", [0.6, -0.8])
@pytest.mark.parametrize("psf_patch", [None, 32], ids=["exact", "clark"])
def test_multiscale_clean_matches_jax(operators, psf_patch, bias_slope):
    jax_op, port_op, vis = operators
    kwargs = dict(scales=(0.0, 2.0, 4.0), num_major=2, gain=0.2,
                  minor_iter=30, psf_patch=psf_patch, bias_slope=bias_slope)
    ref_model, ref_res = jms.multiscale_clean(jax_op, vis, **kwargs)
    model, res = tms.multiscale_clean(port_op, vis, **kwargs)
    assert model.device.type == res.device.type == "cpu"
    assert _rel(model, ref_model) <= SOLVER_RTOL
    assert _rel(res, ref_res) <= SOLVER_RTOL


def _port_operator(dataset_path, npix, asec, epsilon):
    gi = StokesIGridderInput.from_reader(VisibilityReader(dataset_path))
    op = MeasurementOperator.build(
        gi.uvw, gi.channel_frequencies, gi.effective_weights(), npix,
        pixel_size_lm_from_asec(asec), epsilon=epsilon, device="cpu",
    )
    vis = gi.visibilities.ravel()
    return op, vis, float(op.dirty_image(vis).abs().max())


def test_multiscale_reduces_residual(dataset_path):
    op, vis, dirty_peak = _port_operator(dataset_path, 96, 40.0, 1e-3)
    model, residual = tms.multiscale_clean(
        op, vis, scales=(0.0, 2.0, 4.0), num_major=2, gain=0.2,
        minor_iter=30)
    assert float(model.sum()) > 0
    assert float(residual.abs().max()) < 0.7 * dirty_peak
    assert torch.isfinite(model).all() and torch.isfinite(residual).all()


def test_clark_multiscale_reduces_residual(dataset_path):
    """Truncated path still cleans with a real (sidelobed) PSF."""
    op, vis, dirty_peak = _port_operator(dataset_path, 128, 30.0, 1e-4)
    model, residual = tms.multiscale_clean(
        op, vis, scales=(0.0, 2.0), num_major=2, gain=0.2, minor_iter=20,
        psf_patch=32)
    assert float(residual.abs().max()) < dirty_peak
    assert float(model.sum()) > 0
