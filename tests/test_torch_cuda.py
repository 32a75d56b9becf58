"""
The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips unless ``torch.cuda.is_available()``
(decided inside the fixture, never at import). Run them on a machine
with a card: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest``: the suite's conftest
imports jax, which such a machine need not have).
Tolerances: 1e-5 of the reference's max between a float32 kernel and
its float32 plain version (the two sum in different orders), 1e-4
against the explicit DFT; exact where
a kernel only moves data (B6, P2's ``load``) or sums another kernel's
values in its order (tiled B2 as row-major B2, P1 as the dense pass
P2 ``full``) and between two launches of the gridding kernel on the
same inputs (it sums every cell in an order fixed by its work list).
B2 also runs at the distributed mode's slab widths, and
the distributed invert on 2 shards of an NCCL world of one; a small
MeasurementSet's invert on the card is held to its VZ's.
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


def _small(seed=23, num_times=3, num_antennas=10, num_channels=2):
    rng = np.random.default_rng(seed)
    uvw, _ = synthetic_uvw(num_times, num_antennas, max_baseline_m=5000.0,
                           seed=seed)
    freqs = np.linspace(1.0e9, 1.07e9, num_channels)
    shape = (len(uvw), num_channels)
    vis = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64
    )
    wgt = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    return uvw, freqs, vis, wgt


#: B1/B3 plans (``tests/test_torch_grid_schedule.py``'s): name ->
#: (problem size, npix, asec, plan options, blocks a chunk). "small":
#: every tile an edge tile; "edge": footprints across the periodic edge
#: beside interior tiles; "split": hot tiles split over chunks of two
#: (B3) and over column pieces (B1).
GRID_PLANS = {
    "small": ((3, 10, 2), 96, 40.0, {}, None),
    "edge": ((4, 16, 3), 256, 20.0, {}, None),
    "split": ((4, 16, 3), 256, 12.0, {"block": 32}, 2),
}


def _grid_problem(cuda, name, wstack):
    size, npix, asec, kw, blocks = GRID_PLANS[name]
    uvw, freqs, vis, wgt = _small(23, *size)
    pixel = float(np.sin(np.radians(asec / 3600.0)))
    plan = make_plan(uvw, freqs, npix, pixel, do_wstacking=wstack,
                     export_packed=False, **kw)
    arrays, re_s, im_s = tg.stage_compact(plan, uvw, freqs, vis * wgt, cuda)
    blocks = blocks or tg.CHUNK_BLOCKS
    chunks = {
        "grid": [torch.from_numpy(c).to(cuda)
                 for c in tg.group_grid_chunks(plan, blocks)],
        "degrid": [torch.from_numpy(c).to(cuda)
                   for c in tg.group_tile_chunks(plan, blocks)],
    }
    return plan, arrays, re_s, im_s, chunks


def _grid_args(plan, arrays, re_s, im_s, k, ids):
    return (
        arrays["packed"], re_s, im_s, arrays["block_len"],
        arrays["cblock_ox"], arrays["block_oy"], arrays["plane_wg"][k],
        arrays["group_blocks"][k, : len(ids)],
    )


def _launches(degrid, G):
    if degrid:
        return tcg.DEGRID_GROUP1_LAUNCHES if G == 1 else tcg.DEGRID_LAUNCHES
    return tcg.GROUP1_LAUNCHES if G == 1 else tcg.LAUNCHES


@pytest.mark.parametrize("name", list(GRID_PLANS))
@pytest.mark.parametrize("wstack", [False, True], ids=["G1", "G2"])
def test_grid_kernel_matches_plain(cuda, wstack, name):
    """B1 (B4 at G = 1) against its folded plain version, plane by plane,
    at 1e-5 of the plane's max."""
    plan, arrays, re_s, im_s, chunks = _grid_problem(cuda, name, wstack)
    G = plan.plane_group
    assert G == (2 if wstack else 1)
    for k, ids in enumerate(tg.group_active_blocks(plan)):
        args = _grid_args(plan, arrays, re_s, im_s, k, ids)
        before = _launches(False, G)
        got = tcg.grid_planes(*args, plan=plan, chunks=chunks["grid"][k])
        torch.cuda.synchronize()
        assert _launches(False, G) == before + 1
        ref = tcg.grid_planes_folded_reference(*args, plan=plan)
        assert got.shape == ref.shape == (2 * G, plan.ngrid, plan.ngrid)
        for p in range(ref.shape[0]):
            scale = ref[p].abs().max()
            assert float((got[p] - ref[p]).abs().max() / scale) <= 1e-5


@pytest.mark.parametrize("name", list(GRID_PLANS))
@pytest.mark.parametrize("wstack", [False, True], ids=["G1", "G2"])
def test_degrid_kernel_matches_plain(cuda, wstack, name):
    """B3 (B5 at G = 1) on random periodic planes against its folded
    plain version, at 1e-5 of the max."""
    plan, arrays, _, _, chunks = _grid_problem(cuda, name, wstack)
    G = plan.plane_group
    gen = torch.Generator(device=cuda).manual_seed(7)
    grids = torch.randn((2 * G, plan.ngrid, plan.ngrid), generator=gen,
                        device=cuda)
    for k, ids in enumerate(tg.group_active_blocks(plan)):
        args = (
            arrays["packed"], arrays["block_len"], arrays["cblock_ox"],
            arrays["block_oy"], grids, arrays["plane_wg"][k],
            arrays["group_blocks"][k, : len(ids)],
        )
        acc = torch.zeros((2, plan.num_vis), device=cuda)
        before = _launches(True, G)
        got = tcg.degrid_planes(*args, acc, plan=plan,
                                chunks=chunks["degrid"][k])
        torch.cuda.synchronize()
        assert _launches(True, G) == before + 1
        ref = tcg.degrid_planes_folded_reference(
            *args, torch.zeros_like(acc), plan=plan
        )
        scale = ref.abs().max()
        assert float((got - ref).abs().max() / scale) <= 1e-5


@pytest.mark.parametrize("name", list(GRID_PLANS))
@pytest.mark.parametrize("wstack", [False, True], ids=["G1", "G2"])
def test_grid_kernel_repeats_bit_for_bit(cuda, wstack, name):
    """Two B1 (B4 at G = 1) launches on the same inputs give the same
    bits: every cell's sum runs in the work list's order."""
    plan, arrays, re_s, im_s, chunks = _grid_problem(cuda, name, wstack)
    for k, ids in enumerate(tg.group_active_blocks(plan)):
        args = _grid_args(plan, arrays, re_s, im_s, k, ids)
        once = tcg.grid_planes(*args, plan=plan, chunks=chunks["grid"][k])
        twice = tcg.grid_planes(*args, plan=plan, chunks=chunks["grid"][k])
        torch.cuda.synchronize()
        assert once.abs().max() > 0
        assert torch.equal(once.view(torch.int32), twice.view(torch.int32))


def test_kernels_need_the_chunk_table(cuda):
    plan, arrays, re_s, im_s, _ = _grid_problem(cuda, "small", True)
    ids = tg.group_active_blocks(plan)[0]
    before = tcg.LAUNCHES
    with pytest.raises(ValueError, match="chunk"):
        tcg.grid_planes(
            arrays["packed"], re_s, im_s, arrays["block_len"],
            arrays["cblock_ox"], arrays["block_oy"], arrays["plane_wg"][0],
            arrays["group_blocks"][0, : len(ids)], plan=plan,
        )
    assert tcg.LAUNCHES == before


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
    before = (tcg.DEGRID_LAUNCHES + tcg.DEGRID_GROUP1_LAUNCHES,
              tfc.IN_CROP_LAUNCHES)
    got = tg.predict_visibilities(uvw, freqs, image, PIXEL, epsilon=1e-5,
                                  do_wstacking=wstack, device=cuda)
    assert tcg.DEGRID_LAUNCHES + tcg.DEGRID_GROUP1_LAUNCHES > before[0]
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
    before = tcg.LAUNCHES + tcg.GROUP1_LAUNCHES
    got = tg.dirty_image(uvw, freqs, vis, wgt, 128, PIXEL,
                         do_wstacking=wstack, device=cuda)
    assert tcg.LAUNCHES + tcg.GROUP1_LAUNCHES > before
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


#: Kernels for the solvers' convolution on the card: the default scales'
#: widest (radius 17), and a random one (mixed signs, no smoothing), on
#: which a TF32 algorithm's rounding would show most.
CONV_KERNELS = ("scale8", "random")


@pytest.mark.parametrize("kind", CONV_KERNELS)
def test_conv_same_on_card_is_float32(cuda, kind):
    """``_conv_same`` on the card against the CPU with cuDNN's TF32 left
    at PyTorch's default (allowed): the function's own flag keeps the
    convolution in float32 (1e-5 of the max), whichever algorithm cuDNN
    picks (on an H100 with torch 2.11 it runs a direct kernel that uses
    no tensor cores even with TF32 allowed)."""
    from ska_sdp_cip_tpu_torch.models import multiscale as tms

    rng = np.random.default_rng(13)
    image = rng.normal(size=(512, 512)).astype(np.float32)
    kernel = (tms.scale_kernel(8.0, 17) if kind == "scale8"
              else rng.normal(size=(35, 35)).astype(np.float32))
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = tms._conv_same(torch.from_numpy(image).to(cuda),
                             torch.from_numpy(kernel).to(cuda))
        torch.cuda.synchronize()
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    ref = tms._conv_same(torch.from_numpy(image), torch.from_numpy(kernel))
    err = (got.cpu() - ref).abs().max() / ref.abs().max()
    assert err <= 1e-5


def _solver_problem(npix=128, seed=41):
    """A sidelobed compact PSF and a dirty image of three point sources,
    an extended one and noise (well-separated peaks)."""
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
    blob = np.exp(-0.5 * np.add.outer(axis**2, axis**2) / 36.0)
    dirty[80:111, 80:111] += 1.5 * blob
    return dirty, psf


@pytest.mark.parametrize("biases", [(1.0, 0.85, 0.7), (1.0, 1.4, 1.8)],
                         ids=["default", "rising"])
@pytest.mark.parametrize("psf_patch", [None, 64], ids=["exact", "clark"])
def test_multiscale_minor_on_card_matches_cpu(cuda, psf_patch, biases):
    from ska_sdp_cip_tpu_torch.models import multiscale as tms

    dirty, psf = _solver_problem()
    kernels = np.stack([tms.scale_kernel(s, 9) for s in (0.0, 2.0, 4.0)])
    args = [torch.from_numpy(a) for a in
            (dirty, psf, kernels, np.array(biases, np.float32))]
    kwargs = dict(gain=0.2, max_iter=40, num_scales=3, psf_patch=psf_patch)
    ref = tms._multiscale_minor(*args, **kwargs)
    got = tms._multiscale_minor(*[a.to(cuda) for a in args], **kwargs)
    for g, r in zip(got, ref):
        assert g.device.type == "cuda"
        assert (g.cpu() - r).abs().max() <= 1e-5 * r.abs().max()


def test_cli_on_card_matches_cpu(cuda, tmp_path):
    """One ``tpu-cip-torch`` call on the card (robust weighting, two
    multiscale major cycles) against the same call on the CPU: the dirty
    image to 1e-5 of its max, model, residual and restored image to
    1e-4."""
    from ska_sdp_cip_tpu_torch.apps.pipeline_app import run_program
    from ska_sdp_cip_tpu_torch.io.synth import make_synthetic_dataset

    path = make_synthetic_dataset(tmp_path / "obs.vz", num_times=6,
                                  num_antennas=16, seed=4321)
    common = [str(path), "-n", "128", "-p", "30.0", "--weighting", "robust",
              "--clean", "2", "--algorithm", "multiscale", "--minor-iter",
              "30"]
    before = tcg.LAUNCHES + tcg.DEGRID_LAUNCHES
    run_program([common[0], str(tmp_path / "card.npy"), *common[1:]])
    assert tcg.LAUNCHES + tcg.DEGRID_LAUNCHES > before
    run_program([common[0], str(tmp_path / "host.npy"), *common[1:],
                 "--device", "cpu"])
    for suffix, rtol in ((".npy", 1e-5), (".model.npy", 1e-4),
                         (".residual.npy", 1e-4), (".restored.npy", 1e-4)):
        got = np.load(tmp_path / f"card{suffix}")
        ref = np.load(tmp_path / f"host{suffix}")
        assert np.isfinite(got).all(), suffix
        assert np.abs(got - ref).max() <= rtol * np.abs(ref).max(), suffix


def test_pinned_round_trips_equal_pageable(cuda):
    """Uploads (one pageable copy each, through ``device_put_parallel``
    and ``AsyncStager``) and downloads through a pinned buffer on a side
    stream (``device_get``) give the pageable copies' values."""
    from ska_sdp_cip_tpu_torch.utils import staging

    rng = np.random.default_rng(9)
    host = {
        "f32": rng.normal(size=(37, 5)).astype(np.float32),
        "i32": rng.integers(-9, 9, size=1001).astype(np.int32),
        "u16": rng.integers(0, 60000, size=13).astype(np.uint16),
        "big": rng.normal(size=(4 << 20) + 17).astype(np.float32),
        "count": 3,
    }
    for wait in (False, True):
        staged = staging.device_put_parallel(host, cuda, wait=wait)
        assert staged["count"] == 3
        for key, value in host.items():
            if isinstance(value, int):
                continue
            want = torch.from_numpy(value.astype(np.int32)
                                    if value.dtype == np.uint16 else value)
            got = staged[key]
            assert got.device.type == "cuda" and got.dtype == want.dtype
            assert torch.equal(got.cpu(), want), key
            back = staging.device_get(got * 1)
            assert torch.from_numpy(back).is_pinned(), key
            np.testing.assert_array_equal(back, got.cpu().numpy())
    with staging.AsyncStager(cuda) as stager:
        stager.submit("big", host["big"])
        stager.submit_dict({"f32": host["f32"]})
        got = stager.result("big") + 1
        arrays = stager.wait_all()
    assert torch.equal(got.cpu(), torch.from_numpy(host["big"]) + 1)
    assert torch.equal(arrays["f32"].cpu(), torch.from_numpy(host["f32"]))


def test_tiled_invert_on_card_matches_cpu(cuda, tmp_path):
    """``invert_tile_chunks`` from the tiles that
    ``tpu-cip-reorder-uvw-torch`` writes, on the card (through B1 and
    B2) against the same call on the CPU: 1e-5 of the max."""
    from ska_sdp_cip_tpu_torch import VisibilityReader
    from ska_sdp_cip_tpu_torch.apps.uvw_reorder_app import run_program
    from ska_sdp_cip_tpu_torch.invert import pixel_size_lm_from_asec
    from ska_sdp_cip_tpu_torch.io.synth import make_synthetic_dataset
    from ska_sdp_cip_tpu_torch.uvw_tiling.tiled_invert import (
        invert_tile_chunks,
    )

    path = make_synthetic_dataset(tmp_path / "obs.vz", num_times=6,
                                  num_antennas=16, seed=4321)
    outdir = tmp_path / "tiles"
    run_program([str(path), "-t", "3000", "3000", "6000", "-o", str(outdir),
                 "-n", "2", "-m", "5000", "-j", "2"])
    paths = sorted(outdir.glob("tile_iu*chunk*.npz"))
    freqs = VisibilityReader(path).channel_frequencies()
    pixel = pixel_size_lm_from_asec(30.0)
    before = tcg.LAUNCHES, tfc.LAUNCHES
    got = invert_tile_chunks(paths, freqs, 128, pixel, device=cuda)
    assert tcg.LAUNCHES > before[0] and tfc.LAUNCHES > before[1]
    ref = invert_tile_chunks(paths, freqs, 128, pixel, device="cpu")
    assert np.isfinite(got).all() and got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


#: The distributed mode's slab widths (N/S, npix/S) of two transforms at
#: S = 4: the bench one (4096 -> 2048) and a 960 -> 480 one (n1 = 30).
SLAB_CASES = [(4096, 2048, 4), (960, 480, 4)]


@pytest.mark.parametrize("n,npix,shards", SLAB_CASES,
                         ids=[f"{n}_S{s}" for n, _, s in SLAB_CASES])
@pytest.mark.parametrize("crop", ["out", "in"])
def test_fft_kernel_at_slab_widths_matches_plain(cuda, n, npix, shards,
                                                 crop):
    """B2, out-cropped (invert) and in-cropped (predict), at the column
    widths N/S and npix/S of the distributed mode's slabs."""
    plan = make_fft_plan(n, shifted=True)
    window = ((n - npix) // 2, npix)
    if crop == "out":
        meta = tfc.fused_pass_meta(plan, window)
        sign, prefix, rows = +1, "fftp", n
    else:
        meta = tfc.fused_pass_meta(plan, None, in_crop=window)
        sign, prefix, rows = -1, "fftq", npix
    host = fft_plan_arrays(plan, prefix="fft")
    host.update(tfc.fused_pass_kernel_arrays(plan, meta, sign=sign,
                                             prefix=prefix))
    f = tg.stage_arrays(host, cuda)
    gen = torch.Generator(device=cuda).manual_seed(n + shards)
    for m in (n // shards, npix // shards):
        re = torch.randn((rows, m), generator=gen, device=cuda)
        im = torch.randn((rows, m), generator=gen, device=cuda)
        launches = tfc.LAUNCHES + tfc.IN_CROP_LAUNCHES
        got = tfc.fft_first_axis_fused(re, im, f, meta=meta, sign=sign,
                                       prefix=prefix)
        torch.cuda.synchronize()
        assert tfc.LAUNCHES + tfc.IN_CROP_LAUNCHES == launches + 1
        _rel_close(got, tfc.fft_first_axis_reference(re, im, f, meta=meta,
                                                     sign=sign))


def test_distributed_invert_on_card_matches_invert_dataset(cuda, tmp_path):
    """S = 2 shards in one process (an NCCL world of one) on the card, in
    the distributed FFT mode and the replicated one, against
    ``invert_dataset`` on the card at the reference's tolerance (rtol
    1e-5, atol 1e-5 of the max); both go through B1 and B2."""
    from ska_sdp_cip_tpu_torch import VisibilityReader, invert_dataset
    from ska_sdp_cip_tpu_torch.io.synth import make_synthetic_dataset
    from ska_sdp_cip_tpu_torch.parallel import (
        make_device_mesh,
        sharded_invert_dataset,
    )

    path = make_synthetic_dataset(tmp_path / "obs.vz", num_times=6,
                                  num_antennas=16, seed=4321)
    reader = VisibilityReader(path)
    want = invert_dataset(reader, 128, 30.0, device=cuda)
    mesh = make_device_mesh(2, device=cuda)
    for mode in ("distributed", "replicated"):
        before = tcg.LAUNCHES, tfc.LAUNCHES
        got = sharded_invert_dataset(reader, 128, 30.0, mesh=mesh,
                                     row_chunks=2, freq_chunks=1,
                                     fft_mode=mode)
        assert tcg.LAUNCHES > before[0] and tfc.LAUNCHES > before[1]
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_ms_invert_on_card_matches_vz_invert(cuda, tmp_path):
    """A small MeasurementSet (``chip_smoke.write_measurement_set``, read
    by the casacore-free ``_NativeMSBackend``) inverted on the card
    through B1 and B2, against the invert of its VZ on the card: 1e-5 of
    the max (the reader's columns are the VZ's, so the two are expected
    to agree bit for bit)."""
    import importlib.util
    from pathlib import Path

    from ska_sdp_cip_tpu_torch import VisibilityReader, invert_dataset
    from ska_sdp_cip_tpu_torch.io.synth import make_synthetic_dataset

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    vz = make_synthetic_dataset(tmp_path / "obs.vz", num_times=6,
                                num_antennas=16, seed=4321)
    ms = tmp_path / "obs.ms"
    chip_smoke.write_measurement_set(ms, chip_smoke.vz_columns(vz),
                                     tile_bytes=8192)
    reader = VisibilityReader(ms)
    assert type(reader._metadata.backend).__name__ == "_NativeMSBackend"
    before = tcg.LAUNCHES, tfc.LAUNCHES
    got = invert_dataset(reader, 128, 30.0, device=cuda)
    assert tcg.LAUNCHES > before[0] and tfc.LAUNCHES > before[1]
    want = invert_dataset(VisibilityReader(vz), 128, 30.0, device=cuda)
    assert np.isfinite(got).all() and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
