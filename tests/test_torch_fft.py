"""
The torch port's DFT axis passes against the JAX package's.

``fft_first_axis_reference`` (the plain version of the fused CUDA pass,
kernel B2) must match the Pallas fused pass in interpret mode
(bf16x3, ~1e-6) and the XLA four-step ``fft_first_axis`` to 1e-5
relative, out-cropped (invert) and in-cropped at sign -1 (predict);
the port's float32 factors (``fftp_*``, ``fftq_*``) must equal the JAX
hi/lo factor pairs to bf16x3 precision.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu.ops import fft as jfft
from ska_sdp_cip_tpu.ops import fft_pallas as jfp
from ska_sdp_cip_tpu_torch.ops import fft as tfft
from ska_sdp_cip_tpu_torch.ops import fft_cuda as tfc

torch.set_num_threads(1)

RTOL = 1e-5


def _setup(n, crop, sign, in_crop=None, prefix="fftp"):
    plan = jfft.make_fft_plan(n, shifted=True)
    meta = jfp.fused_pass_meta(plan, crop, in_crop=in_crop)
    jax_f = {
        k: jnp.asarray(v)
        for k, v in jfp.fused_pass_host_arrays(
            plan, meta, sign=sign, prefix="fp"
        ).items()
    }
    jax_f.update(jfft.fft_plan_arrays(plan))
    tplan = tfft.make_fft_plan(n, shifted=True)
    tmeta = tfc.fused_pass_meta(tplan, crop, in_crop=in_crop)
    host = tfft.fft_plan_arrays(tplan, prefix="fft")
    host.update(
        tfc.fused_pass_host_arrays(tplan, tmeta, sign=sign, prefix=prefix)
    )
    torch_f = {
        k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        for k, v in host.items()
    }
    return plan, meta, jax_f, tplan, tmeta, torch_f, host


def _inputs(n, m, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(n, m)).astype(np.float32),
        rng.normal(size=(n, m)).astype(np.float32),
    )


def _assert_close(got, ref):
    scale = max(np.abs(ref[0]).max(), np.abs(ref[1]).max())
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   atol=RTOL * scale, rtol=0)


def test_fft_plan_and_meta_match_jax():
    for n, crop in ((96, (24, 48)), (256, (64, 128)), (4096, (1024, 2048))):
        ref = jfft.make_fft_plan(n, shifted=True)
        ours = tfft.make_fft_plan(n, shifted=True)
        for field in dataclasses.fields(ref):
            np.testing.assert_array_equal(
                getattr(ours, field.name), getattr(ref, field.name)
            )
        assert dataclasses.asdict(
            tfc.fused_pass_meta(ours, crop)
        ) == dataclasses.asdict(jfp.fused_pass_meta(ref, crop))


@pytest.mark.parametrize("sign", [+1, -1])
def test_fused_factors_are_float32_twins_of_jax(sign):
    _, _, jax_f, _, _, _, host = _setup(96, (24, 48), sign)
    assert host["fftp_sign"] == sign
    for name in ("m1", "m2"):
        hi = np.asarray(jax_f[f"fp_{name}_hi"]).astype(np.float32)
        lo = np.asarray(jax_f[f"fp_{name}_lo"]).astype(np.float32)
        assert host[f"fftp_{name}"].dtype == np.float32
        np.testing.assert_allclose(host[f"fftp_{name}"], hi + lo, atol=2e-5)
    for name in ("twc", "tws"):
        np.testing.assert_array_equal(
            host[f"fftp_{name}"], np.asarray(jax_f[f"fp_{name}"])
        )


@pytest.mark.parametrize("sign", [+1, -1])
@pytest.mark.parametrize("crop", [None, (24, 48)], ids=["full", "crop"])
def test_fused_pass_reference_matches_jax(sign, crop):
    n, m = 96, 128
    _, meta, jax_f, _, tmeta, torch_f, _ = _setup(n, crop, sign)
    re, im = _inputs(n, m, seed=3)
    ours = tfc.fft_first_axis_fused(
        torch.from_numpy(re), torch.from_numpy(im), torch_f,
        meta=tmeta, sign=sign,
    )
    ours = [o.numpy() for o in ours]
    fused = jfp.fft_first_axis_fused(
        jnp.asarray(re), jnp.asarray(im), jax_f, meta=meta, prefix="fp",
        interpret=True,
    )
    _assert_close(ours, fused)
    xla = jfft.fft_first_axis(
        jnp.asarray(re), jnp.asarray(im), jax_f, sign=sign, out_crop=crop
    )
    _assert_close(ours, xla)


def test_bench_geometry_pass_matches_jax_xla():
    """The invert's pass at a 128-aligned grid (n = 256 -> 128 crop)."""
    n, m, crop = 256, 256, (64, 128)
    _, _, jax_f, _, tmeta, torch_f, _ = _setup(n, crop, +1)
    re, im = _inputs(n, m, seed=5)
    ours = tfc.fft_first_axis_reference(
        torch.from_numpy(re), torch.from_numpy(im), torch_f,
        meta=tmeta, sign=+1,
    )
    ref = jfft.fft_first_axis(
        jnp.asarray(re), jnp.asarray(im), jax_f, sign=+1, out_crop=crop
    )
    _assert_close([o.numpy() for o in ours], ref)


@pytest.mark.parametrize("crop", [None, (24, 48)], ids=["full", "crop"])
def test_last_axis_matches_jax(crop):
    n = 96
    _, _, jax_f, _, _, torch_f, _ = _setup(n, None, +1)
    re, im = _inputs(5, n, seed=7)
    ours = tfft.fft_last_axis(
        torch.from_numpy(re), torch.from_numpy(im), torch_f, sign=-1,
        out_crop=crop,
    )
    ref = jfft.fft_last_axis(
        jnp.asarray(re), jnp.asarray(im), jax_f, sign=-1, out_crop=crop
    )
    _assert_close([o.numpy() for o in ours], ref)


def test_cpu_tensors_take_the_plain_version():
    n, crop = 96, (24, 48)
    _, _, _, _, tmeta, torch_f, _ = _setup(n, crop, +1)
    re, im = _inputs(n, 128, seed=9)
    before = tfc.LAUNCHES
    got = tfc.fft_first_axis_fused(
        torch.from_numpy(re), torch.from_numpy(im), torch_f,
        meta=tmeta, sign=+1,
    )
    ref = tfc.fft_first_axis_reference(
        torch.from_numpy(re), torch.from_numpy(im), torch_f,
        meta=tmeta, sign=+1,
    )
    assert tfc.LAUNCHES == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


#: In-cropped geometries: (n, in_crop) with the crop centred (predict's
#: image in the 2x grid) and off-centre with a low pad (pad_lo > 0).
IN_CROPS = [(96, (24, 48)), (256, (64, 128)), (96, (30, 40))]


@pytest.mark.parametrize("n,in_crop", IN_CROPS)
def test_in_crop_meta_and_factors_match_jax(n, in_crop):
    """The predict pass's geometry and its ``fftq_*`` factors (sign -1)
    are the JAX ones; the factors are float32 twins of hi + lo."""
    _, meta, jax_f, _, tmeta, _, host = _setup(
        n, None, -1, in_crop=in_crop, prefix="fftq"
    )
    assert dataclasses.asdict(tmeta) == dataclasses.asdict(meta)
    assert tmeta.in_size == in_crop[1] and tmeta.n1_in < tmeta.n1
    assert host["fftq_sign"] == -1
    for name in ("m1", "m2"):
        hi = np.asarray(jax_f[f"fp_{name}_hi"]).astype(np.float32)
        lo = np.asarray(jax_f[f"fp_{name}_lo"]).astype(np.float32)
        np.testing.assert_allclose(host[f"fftq_{name}"], hi + lo, atol=2e-5)
    for name in ("twc", "tws"):
        np.testing.assert_array_equal(
            host[f"fftq_{name}"], np.asarray(jax_f[f"fp_{name}"])
        )


@pytest.mark.parametrize("n,in_crop", IN_CROPS)
def test_in_crop_axis_passes_match_jax(n, in_crop):
    """``in_crop`` of both plain axis passes against the JAX XLA ones."""
    _, _, jax_f, _, _, torch_f, _ = _setup(n, None, -1)
    size = in_crop[1]
    re, im = _inputs(size, 128, seed=13)
    ours = tfft.fft_first_axis(
        torch.from_numpy(re), torch.from_numpy(im), torch_f, sign=-1,
        in_crop=in_crop,
    )
    ref = jfft.fft_first_axis(
        jnp.asarray(re), jnp.asarray(im), jax_f, sign=-1, in_crop=in_crop
    )
    assert ours[0].shape == (n, 128)
    _assert_close([o.numpy() for o in ours], ref)
    ours = tfft.fft_last_axis(
        torch.from_numpy(re.T.copy()), torch.from_numpy(im.T.copy()),
        torch_f, sign=-1, in_crop=in_crop,
    )
    ref = jfft.fft_last_axis(
        jnp.asarray(re.T), jnp.asarray(im.T), jax_f, sign=-1,
        in_crop=in_crop,
    )
    assert ours[0].shape == (128, n)
    _assert_close([o.numpy() for o in ours], ref)


@pytest.mark.parametrize("n,in_crop", IN_CROPS)
def test_fused_in_crop_pass_matches_pallas(n, in_crop):
    """
    The port's fused in-cropped pass (its plain version on CPU tensors)
    against the Pallas pass in interpret mode, sign -1, to 1e-5 of max;
    no kernel launch is counted.
    """
    _, meta, jax_f, _, tmeta, torch_f, _ = _setup(
        n, None, -1, in_crop=in_crop, prefix="fftq"
    )
    re, im = _inputs(in_crop[1], 128, seed=17)
    before = tfc.IN_CROP_LAUNCHES
    ours = tfc.fft_first_axis_fused(
        torch.from_numpy(re), torch.from_numpy(im), torch_f,
        meta=tmeta, sign=-1, prefix="fftq",
    )
    assert tfc.IN_CROP_LAUNCHES == before
    fused = jfp.fft_first_axis_fused(
        jnp.asarray(re), jnp.asarray(im), jax_f, meta=meta, prefix="fp",
        interpret=True,
    )
    assert ours[0].shape == (n, 128)
    _assert_close([o.numpy() for o in ours], fused)


def test_fft2_from_image_matches_jax():
    """Predict's forward 2-D transform of a zero-padded image."""
    n, in_crop = 256, (64, 128)
    _, meta, jax_f, _, tmeta, torch_f, _ = _setup(
        n, None, -1, in_crop=in_crop, prefix="fftq"
    )
    re, im = _inputs(128, 128, seed=19)
    ours = tfc.fft2_from_image_fused(
        torch_f, torch.from_numpy(re), torch.from_numpy(im), meta=tmeta
    )
    ref = jfp.fft2_from_image_fused(
        jax_f, jnp.asarray(re), jnp.asarray(im), meta=meta, prefix="fp",
        interpret=True,
    )
    assert ours[0].shape == (n, n)
    _assert_close([o.numpy() for o in ours], ref)
