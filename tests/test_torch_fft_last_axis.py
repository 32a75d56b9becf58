"""
The port's DFT along the last axis (kernel B2L's plain version) and the
w-screen in its loads and stores, against the JAX package.

* ``fft_last_axis_fused`` on CPU tensors (its plain version) against
  the Pallas first-axis pass in interpret mode on the transposed input,
  to 1e-5 of the max (the port's B2 tests' tolerance): both signs, out-
  and in-cropped, an n1 that is not a multiple of 32 (n = 240: n1 = 15;
  n = 960: n1 = 30) and an odd crop;
* the same plain pass equal bit for bit to the port's first-axis
  reference on the transpose (its definition; the CUDA kernel is held
  to B2 on the transpose on the card, ``tests/test_torch_cuda.py``);
* the screened accumulation (invert) and the screened load (predict)
  against the JAX composition they replace (``_fft2_to_image_fused_t``
  + the screen; the screen + ``fft2_from_image_fused``), to 1e-5 of
  the max;
* ``dirty_image`` / ``predict_visibilities`` on the CPU, through B2 and
  B2L with the screen in B2L, against the JAX package's (its XLA path),
  with and without w-stacking, at two image sizes (128 and 90 px), to
  1e-5 of the max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu.io.synth import synthetic_uvw
from ska_sdp_cip_tpu.ops import fft as jfft
from ska_sdp_cip_tpu.ops import fft_pallas as jfp
from ska_sdp_cip_tpu.ops import gridder as jg
from ska_sdp_cip_tpu_torch.ops import fft as tfft
from ska_sdp_cip_tpu_torch.ops import fft_cuda as tfc
from ska_sdp_cip_tpu_torch.ops import gridder as tg

torch.set_num_threads(1)

RTOL = 1e-5
ROWS = 128


def _setup(n, out_crop, sign, in_crop=None):
    """JAX factors (prefix ``fftp``: what ``_fft2_to_image_fused_t``
    reads) and the port's plan factors ``fft_*`` with B2L's tables."""
    plan = jfft.make_fft_plan(n, shifted=True)
    meta = jfp.fused_pass_meta(plan, out_crop, in_crop=in_crop)
    jax_f = {k: jnp.asarray(v) for k, v in jfp.fused_pass_host_arrays(
        plan, meta, sign=sign, prefix="fftp").items()}
    jax_f.update(jfft.fft_plan_arrays(plan))
    tplan = tfft.make_fft_plan(n, shifted=True)
    tmeta = tfc.fused_pass_meta(tplan, out_crop, in_crop=in_crop)
    host = tfft.fft_plan_arrays(tplan, prefix="fft")
    host.update(tfc.last_axis_kernel_arrays(tplan, tmeta, sign=sign,
                                            prefix="fftp"))
    torch_f = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in host.items()}
    return meta, jax_f, tmeta, torch_f


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(2))


def _assert_close(got, ref):
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   atol=RTOL * scale, rtol=0)


def _crops(kind, n, size):
    crop = ((n - size) // 2, size)
    return (crop, None) if kind == "out" else (None, crop)


# (crop kind, n, size): n = 96 (n1 = 8, n2 = 12), 240 (15 x 16) and 960
# (30 x 32): no n1 a multiple of 32; size 47 an odd crop.
CASES = [("out", 96, 48), ("in", 96, 48), ("out", 240, 120),
         ("in", 240, 120), ("out", 960, 480), ("in", 960, 480),
         ("out", 96, 47), ("in", 96, 47)]


@pytest.mark.parametrize("sign", [+1, -1])
@pytest.mark.parametrize("kind,n,size", CASES)
def test_last_axis_pass_matches_pallas_on_transpose(kind, n, size, sign):
    out_crop, in_crop = _crops(kind, n, size)
    meta, jax_f, tmeta, torch_f = _setup(n, out_crop, sign, in_crop)
    re, im = _inputs((ROWS, size if in_crop else n), seed=n + size)
    before = (tfc.LAST_AXIS_LAUNCHES, tfc.LAST_AXIS_IN_CROP_LAUNCHES)
    ours = tfc.fft_last_axis_fused(
        torch.from_numpy(re), torch.from_numpy(im), torch_f, meta=tmeta,
        sign=sign)
    assert (tfc.LAST_AXIS_LAUNCHES, tfc.LAST_AXIS_IN_CROP_LAUNCHES) == before
    assert ours[0].shape == (ROWS, tmeta.size) and ours[0].is_contiguous()
    ref = jfp.fft_first_axis_fused(
        jnp.asarray(re.T), jnp.asarray(im.T), jax_f, meta=meta,
        prefix="fftp", interpret=True)
    _assert_close([o.numpy() for o in ours], [np.asarray(r).T for r in ref])


@pytest.mark.parametrize("kind,n,size", CASES)
def test_last_axis_pass_is_first_axis_reference_on_transpose(kind, n, size):
    out_crop, in_crop = _crops(kind, n, size)
    sign = +1 if kind == "out" else -1
    _, _, tmeta, torch_f = _setup(n, out_crop, sign, in_crop)
    re, im = (torch.from_numpy(x)
              for x in _inputs((ROWS, size if in_crop else n), seed=7))
    want = tfc.fft_first_axis_reference(re.t().contiguous(),
                                        im.t().contiguous(), torch_f,
                                        meta=tmeta, sign=sign)
    stack = torch.full((2, ROWS, tmeta.size), float("nan"))
    got = tfc.fft_last_axis_fused(re, im, torch_f, meta=tmeta, sign=sign,
                                  out=(stack[0], stack[1]))
    assert all(g.data_ptr() == s.data_ptr() for g, s in zip(got, stack))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.t(), rtol=0, atol=0)


# Grids and images of the plane tests: the JAX fused pass takes widths
# that are multiples of 128 (n = 384: n1 = 16, n2 = 24).
JAX_PLANES = [(256, 128), (384, 256)]


def _nm1s(npix, pixel=2e-3, n_mid=-0.05):
    """A transpose-symmetric screen argument n(l, m) - 1 - n_mid."""
    axis = (np.arange(npix) - npix // 2) * pixel
    r2 = axis[:, None] ** 2 + axis[None, :] ** 2
    return (-r2 / (1.0 + np.sqrt(np.clip(1.0 - r2, 0.0, None)))
            - n_mid).astype(np.float32)


@pytest.mark.parametrize("wstack", [True, False])
@pytest.mark.parametrize("n,npix", JAX_PLANES)
def test_screened_accumulation_matches_jax_composition(n, npix, wstack):
    """Invert's plane step: B2 then B2L adding Re(screen x plane) into
    the image, two planes, against JAX's ``_fft2_to_image_fused_t`` with
    the screen (``gridder.py``'s ``correct``) on its transposed image."""
    crop = ((n - npix) // 2, npix)
    meta, jax_f, tmeta, torch_f = _setup(n, crop, +1)
    nm1s = _nm1s(npix)
    ws = np.array([310.0, -905.0], np.float32)
    coefs = (-2.0 * np.pi) * torch.from_numpy(ws)
    image = torch.zeros((npix, npix))
    want = np.zeros((npix, npix), np.float32)
    for p, w in enumerate(ws):
        g_re, g_im = _inputs((n, n), seed=11 + p)
        a_re, a_im = tfc.fft_first_axis_fused(
            torch.from_numpy(g_re), torch.from_numpy(g_im), torch_f,
            meta=tmeta, sign=+1)
        screen = ((torch.from_numpy(nm1s), coefs[p : p + 1]) if wstack
                  else None)
        got = tfc.fft_last_axis_fused(a_re, a_im, torch_f, meta=tmeta,
                                      sign=+1, screen=screen, acc=image)
        assert got is image
        t_re, t_im = jg._fft2_to_image_fused_t(
            jax_f, jnp.asarray(g_re), jnp.asarray(g_im), meta)
        if wstack:
            theta = (-2.0 * np.pi * w) * jnp.asarray(nm1s)
            plane = t_re * jnp.cos(theta) - t_im * jnp.sin(theta)
        else:
            plane = t_re
        want = want + np.asarray(plane).T
    _assert_close([image.numpy()], [want])


@pytest.mark.parametrize("wstack", [True, False])
@pytest.mark.parametrize("n,npix", JAX_PLANES)
def test_screened_load_matches_jax_composition(n, npix, wstack):
    """Predict's plane step: B2L screening the real image in its load,
    then B2 in-cropped along axis 0, against JAX's screen and
    ``fft2_from_image_fused`` (interpret mode)."""
    crop = ((n - npix) // 2, npix)
    meta, jax_f, tmeta, torch_f = _setup(n, None, -1, in_crop=crop)
    nm1s = _nm1s(npix)
    img0 = _inputs((npix, npix), seed=5)[0]
    w = np.float32(-640.0)
    coef = (2.0 * np.pi) * torch.tensor([w])
    if wstack:
        b = tfc.fft_last_axis_fused(torch.from_numpy(img0), None, torch_f,
                                    meta=tmeta, sign=-1,
                                    screen=(torch.from_numpy(nm1s), coef))
        theta = (2.0 * np.pi * w) * jnp.asarray(nm1s)
        j_re = jnp.asarray(img0) * jnp.cos(theta)
        j_im = jnp.asarray(img0) * jnp.sin(theta)
    else:
        b = tfc.fft_last_axis_fused(torch.from_numpy(img0),
                                    torch.zeros((npix, npix)), torch_f,
                                    meta=tmeta, sign=-1)
        j_re, j_im = jnp.asarray(img0), jnp.zeros((npix, npix))
    assert b[0].shape == (npix, n)
    grid = tfc.fft_first_axis_fused(*b, torch_f, meta=tmeta, sign=-1)
    ref = jfp.fft2_from_image_fused(jax_f, j_re, j_im, meta=meta,
                                    prefix="fftp", interpret=True)
    assert grid[0].shape == (n, n)
    _assert_close([g.numpy() for g in grid], ref)


def test_screens_are_the_replaced_torch_ops():
    """The plain screens compute what the composition they replace did,
    op for op (so the CPU images do not move)."""
    rng = np.random.default_rng(3)
    nm1s = torch.from_numpy(_nm1s(40))
    x, y, acc = (torch.from_numpy(rng.normal(size=(40, 40))
                                  .astype(np.float32)) for _ in range(3))
    w = torch.tensor([412.5])
    coef = (-2.0 * np.pi) * w
    theta = (-2.0 * np.pi * w[0]) * nm1s
    want = acc + (x * torch.cos(theta) - y * torch.sin(theta))
    got = tfc.screen_accumulate_reference(acc.clone(), x, y, nm1s, coef)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    theta = (2.0 * np.pi * w[0]) * nm1s
    got = tfc.screen_load_reference(x, nm1s, (2.0 * np.pi) * w)
    for g, want in zip(got, (x * torch.cos(theta), x * torch.sin(theta))):
        torch.testing.assert_close(g, want, rtol=0, atol=0)


@pytest.fixture(scope="module")
def problem():
    uvw, _ = synthetic_uvw(3, 16, max_baseline_m=4000.0, seed=11)
    freqs = np.linspace(1.3e9, 1.45e9, 3)
    rng = np.random.default_rng(1)
    shape = (len(uvw), len(freqs))
    vis = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)
    return uvw, freqs, vis, np.ones(shape, np.float32)


@pytest.mark.parametrize("wstack", [True, False], ids=["G", "G1"])
@pytest.mark.parametrize("npix", [128, 90])
def test_invert_and_predict_match_the_jax_package(problem, npix, wstack,
                                                  monkeypatch):
    """``dirty_image`` and ``predict_visibilities`` on the CPU, through
    B2 + B2L with the screen in B2L, against the JAX package's (its XLA
    path) at 1e-5 of the max."""
    uvw, freqs, vis, wgt = problem
    pix = float(np.sin(np.radians(20.0 / 3600.0)))
    image = np.random.default_rng(2).normal(size=(npix, npix)).astype(
        np.float32)
    dirty = tg.dirty_image(uvw, freqs, vis, wgt, npix, pix,
                           do_wstacking=wstack, device="cpu")
    model = tg.predict_visibilities(uvw, freqs, image, pix,
                                    do_wstacking=wstack, device="cpu")
    monkeypatch.setenv("CIP_GRIDDER", "xla")
    monkeypatch.setenv("CIP_AOT", "0")
    dirty_ref = jg.dirty_image(uvw, freqs, vis, wgt, npix, pix,
                               do_wstacking=wstack)
    model_ref = jg.predict_visibilities(uvw, freqs, image, pix,
                                        do_wstacking=wstack)
    for got, ref in ((dirty, dirty_ref), (model, model_ref)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert np.abs(ref).max() > 0
        assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()


def test_last_axis_columns_fit_shared_memory():
    for n, cols in ((12, 32), (128, 32), (256, 32), (432, 32), (448, 16),
                    (840, 16), (896, 8), (900, 8)):
        assert tfc.last_axis_columns(n) == cols
        assert 2 * 2 * n * (cols + 1) * 4 <= tfc.SMEM_BYTES
    with pytest.raises(ValueError):
        tfc.last_axis_columns(11)


@pytest.mark.parametrize("sign", [+1, -1])
def test_last_axis_tables_are_b2s_values(sign):
    """B2L's twiddle is B2's (``twc``/``tws``) in the plan's (n1, n2)
    layout, value for value; its sub-FFT tables are B2's."""
    plan = tfft.make_fft_plan(960, shifted=True)
    meta = tfc.fused_pass_meta(plan, (240, 480))
    b2 = tfc.fused_pass_kernel_arrays(plan, meta, sign=sign, prefix="p")
    b2l = tfc.last_axis_kernel_arrays(plan, meta, sign=sign, prefix="p")
    assert set(b2l) == {f"p_{k}" for k in tfc.B2L_FACTORS} | {"p_sign"}
    n1, n2, c = meta.n1, meta.n2, meta.c
    for ours, theirs in (("p_twlc", "p_twc"), ("p_twls", "p_tws")):
        assert b2l[ours].shape == (n1, n2) and b2l[ours].dtype == np.float32
        laid = b2[theirs][..., 0].transpose(1, 0, 2).reshape(n1, n2)
        np.testing.assert_array_equal(b2l[ours], laid)
    for key in ("p_fft1_tw", "p_fft2_tw", "p_sign"):
        np.testing.assert_array_equal(b2l[key], b2[key])
    staged = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
              for k, v in b2l.items()}
    got = tfc.pass_factors(staged, meta, sign=sign, prefix="p",
                           device=torch.device("cpu"), names=tfc.B2L_FACTORS)
    assert set(got) == set(tfc.B2L_FACTORS)
    with pytest.raises(ValueError):
        tfc.pass_factors(staged, meta, sign=-sign, prefix="p",
                         device=torch.device("cpu"), names=tfc.B2L_FACTORS)


@pytest.mark.parametrize("bad", ["im_none", "im_with_screen", "acc_and_out",
                                 "acc_shape", "nm1s_shape", "coef",
                                 "z_on_cpu", "width", "meta_device"])
def test_last_axis_pass_refuses_bad_arguments(bad):
    n, size = 96, 48
    _, _, tmeta, torch_f = _setup(n, ((n - size) // 2, size), +1)
    re, im = (torch.from_numpy(x) for x in _inputs((16, n), seed=1))
    acc = torch.zeros((16, size))
    nm1s = torch.zeros((16, size))
    coef = torch.tensor([1.0])
    kw = {
        "im_none": dict(im=None),
        "im_with_screen": dict(screen=(torch.zeros((16, n)), coef)),
        "acc_and_out": dict(acc=acc, out=(torch.empty(16, size),
                                          torch.empty(16, size))),
        "acc_shape": dict(acc=torch.zeros((16, size + 1))),
        "nm1s_shape": dict(acc=acc, screen=(torch.zeros((16, n)), coef)),
        "coef": dict(acc=acc, screen=(nm1s, torch.tensor([1.0, 2.0]))),
        "z_on_cpu": dict(z=(torch.empty(16, n), torch.empty(16, n))),
        "width": dict(re=re[:, :-1], im=im[:, :-1]),
        "meta_device": dict(re=re.to(torch.float64).to("meta"),
                            im=im.to("meta")),
    }[bad]
    args = {"re": re, "im": im, **kw}
    with pytest.raises((ValueError, TypeError)):
        tfc.fft_last_axis_fused(args.pop("re"), args.pop("im"), torch_f,
                                meta=tmeta, sign=+1, **args)
