"""
The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips unless ``torch.cuda.is_available()``
(decided inside the fixture, never at import). Run them on a machine
with a card: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest``: the suite's conftest
imports jax, which such a machine need not have).
Tolerances: 1e-5 of the reference's max between a float32 kernel and
its float32 plain version (summation order differs; the gridding
kernel adds with atomics), 1e-4 against the explicit DFT; exact where
a kernel only moves data (B6, P2's ``load``) or sums another kernel's
values in its order (tiled B2 as row-major B2, P1 as the dense pass
P2 ``full``).
"""

import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu_torch.io.synth import synthetic_uvw
from ska_sdp_cip_tpu_torch.ops import cuda_gridder as tcg
from ska_sdp_cip_tpu_torch.ops import fft_cuda as tfc
from ska_sdp_cip_tpu_torch.ops import gridder as tg
from ska_sdp_cip_tpu_torch.ops.dft import dirty_image_dft, predict_dft
from ska_sdp_cip_tpu_torch.ops.fft import fft_plan_arrays, make_fft_plan
from ska_sdp_cip_tpu_torch.ops.plan import make_plan

pytestmark = pytest.mark.cuda

PIXEL = float(np.sin(np.radians(40.0 / 3600)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _small(seed=23):
    rng = np.random.default_rng(seed)
    uvw, _ = synthetic_uvw(3, 10, max_baseline_m=5000.0, seed=seed)
    freqs = np.array([1.0e9, 1.07e9])
    shape = (len(uvw), 2)
    vis = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64
    )
    wgt = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    return uvw, freqs, vis, wgt


@pytest.mark.parametrize("wstack", [False, True], ids=["G1", "G2"])
def test_grid_kernel_matches_plain(cuda, wstack):
    uvw, freqs, vis, wgt = _small()
    plan = make_plan(uvw, freqs, 96, PIXEL, do_wstacking=wstack,
                     export_packed=False)
    arrays, re_s, im_s = tg.stage_compact(plan, uvw, freqs, vis * wgt, cuda)
    for k, ids in enumerate(tg.group_active_blocks(plan)):
        args = (
            arrays["packed"], re_s, im_s, arrays["block_len"],
            arrays["cblock_ox"], arrays["block_oy"], arrays["plane_wg"][k],
            arrays["group_blocks"][k, : len(ids)],
        )
        before = tcg.LAUNCHES
        got = tcg.grid_planes(*args, plan=plan)
        torch.cuda.synchronize()
        assert tcg.LAUNCHES == before + 1
        ref = tcg.grid_planes_reference(*args, plan=plan)
        for p in range(ref.shape[0]):
            scale = ref[p].abs().max()
            assert float((got[p] - ref[p]).abs().max() / scale) <= 1e-5


@pytest.mark.parametrize("wstack", [False, True], ids=["G1", "G2"])
def test_degrid_kernel_matches_plain(cuda, wstack):
    uvw, freqs, _, _ = _small()
    plan = make_plan(uvw, freqs, 96, PIXEL, do_wstacking=wstack)
    arrays = tg.stage_arrays(tg.slot_plan_host_arrays(plan, cuda), cuda)
    G = plan.plane_group
    gen = torch.Generator(device=cuda).manual_seed(7)
    grids = torch.randn((2 * G, plan.nalloc_x, plan.nalloc_y),
                        generator=gen, device=cuda)
    for k, ids in enumerate(tg.group_active_blocks(plan)):
        args = (
            arrays["packed"], arrays["block_len"], arrays["cblock_ox"],
            arrays["block_oy"], grids, arrays["plane_wg"][k],
            arrays["group_blocks"][k, : len(ids)],
        )
        acc = torch.zeros((2, plan.num_vis), device=cuda)
        before = tcg.DEGRID_LAUNCHES
        got = tcg.degrid_planes(*args, acc, plan=plan)
        torch.cuda.synchronize()
        assert tcg.DEGRID_LAUNCHES == before + 1
        ref = tcg.degrid_planes_reference(
            *args, torch.zeros_like(acc), plan=plan
        )
        scale = ref.abs().max()
        assert float((got - ref).abs().max() / scale) <= 1e-5


#: B2's in-cropped cases: m = 102 and 98 are not multiples of 4 (the
#: kernel's 4-byte staging); 156250 = 250 x 625 runs a 16-column stage.
@pytest.mark.parametrize("n,in_crop,m", [(96, (24, 48), 128),
                                         (96, (30, 40), 96),
                                         (512, (128, 256), 384),
                                         (768, (100, 300), 256),
                                         (840, (210, 420), 200),
                                         (192, (40, 100), 102),
                                         (156250, (39062, 78126), 98)])
def test_in_crop_fft_kernel_matches_plain(cuda, n, in_crop, m):
    plan = make_fft_plan(n, shifted=True)
    meta = tfc.fused_pass_meta(plan, None, in_crop=in_crop)
    host = fft_plan_arrays(plan, prefix="fft")
    host.update(tfc.fused_pass_kernel_arrays(plan, meta, sign=-1,
                                             prefix="fftq"))
    f = tg.stage_arrays(host, cuda)
    rng = np.random.default_rng(n + m)
    size = in_crop[1]
    re = torch.from_numpy(rng.normal(size=(size, m)).astype(np.float32))
    im = torch.from_numpy(rng.normal(size=(size, m)).astype(np.float32))
    re, im = re.to(cuda), im.to(cuda)
    before = tfc.IN_CROP_LAUNCHES
    got = tfc.fft_first_axis_fused(re, im, f, meta=meta, sign=-1,
                                   prefix="fftq")
    torch.cuda.synchronize()
    assert tfc.IN_CROP_LAUNCHES == before + 1
    ref = tfc.fft_first_axis_reference(re, im, f, meta=meta, sign=-1)
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (n, m)
        assert float((g - r).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("wstack", [False, True])
def test_predict_on_card_matches_dft(cuda, wstack):
    uvw, _ = synthetic_uvw(2, 6, max_baseline_m=2000.0, seed=3)
    freqs = np.array([1.2e9])
    image = np.zeros((64, 64), np.float32)
    image[37, 29], image[23, 40] = 1.7, 0.8
    ref = predict_dft(uvw, freqs, image, PIXEL, apply_w=wstack)
    before = (tcg.DEGRID_LAUNCHES, tfc.IN_CROP_LAUNCHES)
    got = tg.predict_visibilities(uvw, freqs, image, PIXEL, epsilon=1e-5,
                                  do_wstacking=wstack, device=cuda)
    assert tcg.DEGRID_LAUNCHES > before[0]
    assert tfc.IN_CROP_LAUNCHES > before[1]
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-4


#: B2's out-cropped cases: m = 98 and 102 are not multiples of 4;
#: 156250 = 250 x 625 runs a 16-column stage 2, 1647086 = 686 x 2401
#: a 4-column one.
@pytest.mark.parametrize("n,crop,m", [(96, (24, 48), 128), (256, None, 200),
                                      (512, (128, 256), 384),
                                      (768, (192, 384), 256),
                                      (840, (210, 420), 200),
                                      (768, (192, 384), 98),
                                      (156250, (39062, 78126), 102),
                                      (1647086, (411771, 823543), 4)])
def test_fft_kernel_matches_plain(cuda, n, crop, m):
    plan = make_fft_plan(n, shifted=True)
    meta = tfc.fused_pass_meta(plan, crop)
    host = fft_plan_arrays(plan, prefix="fft")
    host.update(tfc.fused_pass_kernel_arrays(plan, meta, sign=+1,
                                             prefix="fftp"))
    f = tg.stage_arrays(host, cuda)
    rng = np.random.default_rng(n)
    re = torch.from_numpy(rng.normal(size=(n, m)).astype(np.float32)).to(cuda)
    im = torch.from_numpy(rng.normal(size=(n, m)).astype(np.float32)).to(cuda)
    before = tfc.LAUNCHES
    got = tfc.fft_first_axis_fused(re, im, f, meta=meta, sign=+1)
    torch.cuda.synchronize()
    assert tfc.LAUNCHES == before + 1
    ref = tfc.fft_first_axis_reference(re, im, f, meta=meta, sign=+1)
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= 1e-5 * scale


def test_fft_kernel_refuses_factors_of_the_other_sign(cuda):
    plan = make_fft_plan(96, shifted=True)
    meta = tfc.fused_pass_meta(plan, (24, 48))
    f = tg.stage_arrays(
        tfc.fused_pass_host_arrays(plan, meta, sign=+1, prefix="fftp"), cuda
    )
    re = torch.zeros((96, 128), dtype=torch.float32, device=cuda)
    before = tfc.LAUNCHES
    with pytest.raises(ValueError, match="sign"):
        tfc.fft_first_axis_fused(re, re.clone(), f, meta=meta, sign=-1)
    assert tfc.LAUNCHES == before


@pytest.mark.parametrize("wstack", [False, True])
def test_dirty_image_on_card_matches_dft(cuda, wstack):
    uvw, freqs, vis, wgt = _small(seed=5)
    ref = dirty_image_dft(uvw, freqs, vis, wgt, 128, PIXEL, apply_w=wstack)
    got = tg.dirty_image(uvw, freqs, vis, wgt, 128, PIXEL,
                         do_wstacking=wstack, device=cuda)
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-4


def _pass(cuda, n, m, *, in_crop=None, seed=0):
    """Geometry, staged factors and (rows, m) normal input of one pass:
    out-cropped to the counterpart probes' rows, or in-cropped at -1."""
    from ska_sdp_cip_tpu_torch.probes.common import crop_rows

    plan = make_fft_plan(n, shifted=True)
    host = fft_plan_arrays(plan, prefix="fft")
    if in_crop is None:
        npix = crop_rows(n)
        meta = tfc.fused_pass_meta(plan, ((n - npix) // 2, npix))
        sign, prefix, rows = +1, "fftp", n
    else:
        meta = tfc.fused_pass_meta(plan, None, in_crop=in_crop)
        sign, prefix, rows = -1, "fftq", meta.in_size
    host.update(tfc.fused_pass_host_arrays(plan, meta, sign=sign,
                                           prefix=prefix))
    host.update(tfc.fused_pass_kernel_arrays(plan, meta, sign=sign,
                                             prefix=prefix))
    f = tg.stage_arrays(host, cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    re = torch.randn((rows, m), generator=gen, device=cuda)
    im = torch.randn((rows, m), generator=gen, device=cuda)
    return meta, f, sign, prefix, re, im


def _rel_close(got, ref, rtol=1e-5):
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= rtol * scale


@pytest.mark.parametrize("n,m,in_crop", [(512, 512, None), (960, 1024, None),
                                         (512, 256, (128, 256))],
                         ids=["512", "960", "in_crop"])
def test_pretile_kernel_equals_plain(cuda, n, m, in_crop):
    meta, _, _, _, re, im = _pass(cuda, n, m, in_crop=in_crop)
    before = tfc.PRETILE_LAUNCHES
    got = tfc.pretile_first_axis(re, im, meta=meta)
    torch.cuda.synchronize()
    assert tfc.PRETILE_LAUNCHES == before + 1
    ref = tfc.pretile_first_axis_reference(re, im, meta=meta)
    for g, r in zip(got, ref):
        assert g.shape == tfc.tiled_shape(meta, m)
        assert torch.equal(g, r)


@pytest.mark.parametrize("n,m,in_crop", [(512, 512, None), (960, 1024, None),
                                         (512, 256, (128, 256))],
                         ids=["512", "960", "in_crop"])
def test_tiled_pass_equals_untiled_kernel(cuda, n, m, in_crop):
    meta, f, sign, prefix, re, im = _pass(cuda, n, m, in_crop=in_crop)
    base = tfc.fft_first_axis_fused(re, im, f, meta=meta, sign=sign,
                                    prefix=prefix)
    tiles = tfc.pretile_first_axis(re, im, meta=meta)
    before = tfc.TILED_LAUNCHES
    got = tfc.fft_first_axis_fused(*tiles, f, meta=meta, sign=sign,
                                   prefix=prefix, tiled=True)
    torch.cuda.synchronize()
    assert tfc.TILED_LAUNCHES == before + 1
    for g, b in zip(got, base):
        assert torch.equal(g, b)
    _rel_close(got, tfc.fft_first_axis_tiled_reference(
        *tiles, f, meta=meta, sign=sign))


@pytest.mark.parametrize("in_crop", [None, (240, 480)], ids=["out", "in"])
def test_scalar_staging_equals_vector_staging(cuda, in_crop):
    """B2 at m = 98 (4-byte copies) equals, bit for bit and twice over,
    the first 98 columns of the same pass at m = 128 (16-byte copies):
    a column's arithmetic does not depend on how it was staged."""
    meta, f, sign, prefix, re, im = _pass(cuda, 960, 128, in_crop=in_crop)
    wide = tfc.fft_first_axis_fused(re, im, f, meta=meta, sign=sign,
                                    prefix=prefix)
    narrow = [tfc.fft_first_axis_fused(re[:, :98].contiguous(),
                                       im[:, :98].contiguous(), f, meta=meta,
                                       sign=sign, prefix=prefix)
              for _ in range(2)]
    for got in narrow:
        for g, w in zip(got, wide):
            assert torch.equal(g, w[:, :98])


@pytest.mark.parametrize("in_crop", [None, (240, 480)], ids=["out", "in"])
def test_fft_kernel_ragged_n1_matches_plain(cuda, in_crop):
    """B2 at n = 960 (n1 = 30: not a multiple of the kernel's 16-deep
    chunk or 64-row tile), m = 1024."""
    meta, f, sign, prefix, re, im = _pass(cuda, 960, 1024, in_crop=in_crop)
    assert meta.n1 == 30
    got = tfc.fft_first_axis_fused(re, im, f, meta=meta, sign=sign,
                                   prefix=prefix)
    _rel_close(got, tfc.fft_first_axis_reference(re, im, f, meta=meta,
                                                 sign=sign))


@pytest.mark.parametrize("n", [512, 960])
def test_async_fetch_probe_equals_b2(cuda, n):
    """P1 equals the dense pass it probes (B2's first design, P2
    ``full``) bit for bit."""
    from ska_sdp_cip_tpu_torch.probes import fft_ablation as p2
    from ska_sdp_cip_tpu_torch.probes import fft_async_fetch as p1

    meta, f, _, _, re, im = _pass(cuda, n, 1024)
    base = p2.ablation("full", re, im, f, meta=meta)
    ref = tfc.fft_first_axis_reference(re, im, f, meta=meta, sign=+1)
    for stages in p1.STAGES:
        before = p1.LAUNCHES[stages]
        got = p1.async_fetch_pass(re, im, f, meta=meta, stages=stages)
        torch.cuda.synchronize()
        assert p1.LAUNCHES[stages] == before + 1
        for g, b in zip(got, base):
            assert torch.equal(g, b)
        _rel_close(got, ref)


@pytest.mark.parametrize("n", [512, 960])
def test_ablation_variants_match_plain(cuda, n):
    from ska_sdp_cip_tpu_torch.probes import fft_ablation as p2

    meta, f, _, _, re, im = _pass(cuda, n, 1024)
    z = p2.ablation_reference("s1tw", re, im, f, meta=meta)
    for variant in p2.VARIANTS:
        x = z if variant == "s2" else (re, im)
        before = p2.LAUNCHES[variant]
        got = p2.ablation(variant, *x, f, meta=meta)
        torch.cuda.synchronize()
        assert p2.LAUNCHES[variant] == before + 1
        if variant == "load":
            assert all(torch.equal(g, r) for g, r in zip(got, x))
        _rel_close(got, p2.ablation_reference(variant, *x, f, meta=meta))
    full = p2.ablation("full", re, im, f, meta=meta)
    _rel_close(full, tfc.fft_first_axis_fused(re, im, f, meta=meta,
                                              sign=+1))


@pytest.mark.parametrize("probe", ["fft_tiled", "fft_async_fetch",
                                   "fft_ablation"])
def test_fft_probes_run_on_card(cuda, probe):
    import importlib

    mod = importlib.import_module(f"ska_sdp_cip_tpu_torch.probes.{probe}")
    out = mod.run(512, device=cuda, iters=2)
    assert out["ngrid"] == 512 and out["device"] != "cpu"


def test_smem_probe_maximum_is_the_device_attribute(cuda):
    from ska_sdp_cip_tpu_torch.probes import smem

    before = smem.LAUNCHES
    out = smem.run(device=cuda, iters=2)
    assert smem.LAUNCHES > before
    assert out["max_bytes"] == out["optin_attribute_bytes"]
    assert out["matches_attribute"]
    assert out["read_back_exact"] and out["max_abs_err"] == 0
    assert smem.smem_probe(out["max_bytes"] + 1, cuda) is None
