"""
The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips unless ``torch.cuda.is_available()``
(decided inside the fixture, never at import). Run them on a machine
with a card: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest``: the suite's conftest
imports jax, which such a machine need not have).
Tolerances: 1e-5 of the reference's max between a float32 kernel and
its float32 plain version (the two sum in different orders), 1e-4
against the explicit DFT; exact where a kernel only moves data (B6,
P2's ``load`` and ``load2``) or sums another kernel's values in its
order (tiled B2 as row-major B2, P1 and P2's ``s1tw``, ``s2`` and
``full`` as B2) and between two launches of the gridding kernel on the
same inputs (it sums every cell in an order fixed by its work list);
the taper maps (T1) within 1e-6 of the max of their plain version (the
two sum the quadrature in different orders), and T1's mirrored
evaluation bit-equal to its one-pixel-at-a-time evaluation; the scale
frames (S1) within 2e-6 of the max of the float64 2-D convolution, and
scale 0's delta frame equal to the image.
B2 also runs at the distributed mode's slab widths, and the
distributed invert on 2 shards of an NCCL world of one; a small
MeasurementSet's invert on the card is held to its VZ's.
"""

import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu_torch.io.synth import synthetic_uvw
from ska_sdp_cip_tpu_torch.ops import cuda_gridder as tcg
from ska_sdp_cip_tpu_torch.ops import fft_cuda as tfc
from ska_sdp_cip_tpu_torch.ops import gridder as tg
from ska_sdp_cip_tpu_torch.ops import scale_conv_cuda as tsc
from ska_sdp_cip_tpu_torch.ops import taper_cuda as ttc
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
#: (B3) and over column pieces (B1); "tiny64", "tiny32" and "tiny72":
#: grids of 64, 32 and 72 cells, narrower than a patch (48 x 128), whose
#: rectangles B1 cuts to N - W + 1 cells; "wide": a 32768^2 grid
#: (16384 px at 0.5 asec) with 480 visibilities; "eps3", "eps5" and
#: "eps5_sigma15": supports 5, 7 and 10, B1's generic kernel.
GRID_PLANS = {
    "small": ((3, 10, 2), 96, 40.0, {}, None),
    "edge": ((4, 16, 3), 256, 20.0, {}, None),
    "split": ((4, 16, 3), 256, 12.0, {"block": 32}, 2),
    "tiny64": ((4, 16, 3), 32, 60.0, {}, None),
    "tiny32": ((4, 16, 3), 16, 120.0, {}, None),
    "tiny72": ((4, 16, 3), 36, 60.0, {}, None),
    "wide": ((2, 16, 2), 16384, 0.5, {}, None),
    "eps3": ((4, 16, 3), 256, 20.0, {"epsilon": 1e-3}, None),
    "eps5": ((4, 16, 3), 256, 20.0, {"epsilon": 1e-5}, None),
    "eps5_sigma15": ((4, 16, 3), 256, 20.0,
                     {"epsilon": 1e-5, "sigma": 1.5}, None),
}


def _grid_problem(cuda, name, wstack):
    size, npix, asec, kw, blocks = GRID_PLANS[name]
    uvw, freqs, vis, wgt = _small(23, *size)
    pixel = float(np.sin(np.radians(asec / 3600.0)))
    plan = make_plan(uvw, freqs, npix, pixel, do_wstacking=wstack,
                     export_packed=False, **kw)
    arrays, re_s, im_s = tg.stage_compact(plan, uvw, freqs, vis * wgt, cuda)
    lists = tg.work_lists(plan, invert=True, predict=True)
    if blocks:  # another chunk size than the plan's lists
        lists = {key: [builder(plan, ids, blocks) for ids in lists["blocks"]]
                 for key, builder in (("grid", tg.grid_chunks),
                                      ("tile", tg.tile_chunks))}
    chunks = {
        "grid": [torch.from_numpy(c).to(cuda) for c in lists["grid"]],
        "degrid": [torch.from_numpy(c).to(cuda) for c in lists["tile"]],
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
    for k, ids in enumerate(tg.work_lists(plan)["blocks"]):
        args = _grid_args(plan, arrays, re_s, im_s, k, ids)
        before = _launches(False, G)
        got = tcg.grid_planes(*args, plan=plan, chunks=chunks["grid"][k])
        torch.cuda.synchronize()
        assert _launches(False, G) == before + 1
        ref = tcg.grid_planes_folded_reference(*args, plan=plan)
        assert got.shape == ref.shape == (2 * G, plan.ngrid, plan.ngrid)
        for p in range(ref.shape[0]):
            # A ragged final group's pad plane is zero: then exactly.
            scale = float(ref[p].abs().max())
            assert float((got[p] - ref[p]).abs().max()) <= 1e-5 * scale
        del got, ref  # "wide": 17 GB a stack


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
    for k, ids in enumerate(tg.work_lists(plan)["blocks"]):
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
    for k, ids in enumerate(tg.work_lists(plan)["blocks"]):
        args = _grid_args(plan, arrays, re_s, im_s, k, ids)
        once = tcg.grid_planes(*args, plan=plan, chunks=chunks["grid"][k])
        twice = tcg.grid_planes(*args, plan=plan, chunks=chunks["grid"][k])
        torch.cuda.synchronize()
        assert once.abs().max() > 0
        assert torch.equal(once.view(torch.int32), twice.view(torch.int32))
        del once, twice  # "wide": 17 GB a stack


def test_kernels_need_the_chunk_table(cuda):
    plan, arrays, re_s, im_s, _ = _grid_problem(cuda, "small", True)
    ids = tg.work_lists(plan)["blocks"][0]
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


#: Probe sizes: n1 = 16 and 30 (radix 2, 3, 5) with n2 = 32, and the
#: large image's grid (n1 = 128, n2 = 256: one ring depth less).
PROBE_GRIDS = [512, 960, 32768]


@pytest.mark.parametrize("n", PROBE_GRIDS)
def test_async_fetch_probe_equals_b2(cuda, n):
    """P1 equals B2 bit for bit at every engine and ring depth that fits,
    whole and stage by stage, and its plain version to 1e-5."""
    from ska_sdp_cip_tpu_torch.probes import fft_async_fetch as p1

    meta, f, _, _, re, im = _pass(cuda, n, 1024)
    z = tuple(torch.empty((n, 1024), device=cuda) for _ in range(2))
    base = tfc.fft_first_axis_fused(re, im, f, meta=meta, sign=+1, z=z)
    ref = tfc.fft_first_axis_reference(re, im, f, meta=meta, sign=+1)
    for engine in p1.ENGINES:
        fit = p1.depths(meta, engine)
        assert fit == ((1, 2) if n == 32768 else (1, 2, 3))
        for stages in fit:
            key = f"{engine}_S{stages}"
            before = p1.LAUNCHES[key]
            stats = {}
            got = p1.async_fetch_pass(re, im, f, meta=meta, engine=engine,
                                      stages=stages, stats=stats)
            torch.cuda.synchronize()
            assert p1.LAUNCHES[key] == before + 1
            assert set(stats) == {"stage1", "stage2"}
            assert all(st["blocks_per_sm"] >= 1 for st in stats.values())
            for g, b in zip(got, base):
                assert torch.equal(g, b)
            _rel_close(got, ref)
            y = p1.async_fetch_pass(re, im, f, meta=meta, engine=engine,
                                    stages=stages, stage=1)
            assert all(torch.equal(a, b) for a, b in zip(y, z))
            w = p1.async_fetch_pass(*z, f, meta=meta, engine=engine,
                                    stages=stages, stage=2)
            assert all(torch.equal(a, b) for a, b in zip(w, base))
        if n == 32768:
            with pytest.raises(ValueError, match="does not fit"):
                p1.async_fetch_pass(re, im, f, meta=meta, engine=engine,
                                    stages=3)


@pytest.mark.parametrize("n", PROBE_GRIDS)
def test_ablation_variants_match_plain(cuda, n):
    """P2's B2 launches equal B2's bit for bit, its load variants their
    input, and every variant its plain version to 1e-5."""
    from ska_sdp_cip_tpu_torch.probes import fft_ablation as p2

    meta, f, _, _, re, im = _pass(cuda, n, 1024)
    z = tuple(torch.empty((n, 1024), device=cuda) for _ in range(2))
    base = tfc.fft_first_axis_fused(re, im, f, meta=meta, sign=+1, z=z)
    same = {"load": (re, im), "load2": z, "s1tw": z, "s2": base,
            "full": base}
    for variant in p2.VARIANTS:
        x = z if variant in p2.Z_INPUT else (re, im)
        before = p2.LAUNCHES[variant]
        got = p2.ablation(variant, *x, f, meta=meta)
        torch.cuda.synchronize()
        assert p2.LAUNCHES[variant] == before + 1
        if variant in same:
            assert all(torch.equal(g, r) for g, r in zip(got, same[variant]))
        _rel_close(got, p2.ablation_reference(variant, *x, f, meta=meta))


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


@pytest.mark.parametrize("npix,asec", [(32, 60.0), (16, 120.0)])
@pytest.mark.parametrize("wstack", [False, True], ids=["G1", "G2"])
def test_tiny_invert_on_card_matches_cpu(cuda, tmp_path, npix, asec,
                                         wstack):
    """``invert_dataset`` on grids of 64 and 32 cells, narrower than a
    B1 patch, on the card (B4 or B1, and B2) against the same call on
    the CPU: 1e-5 of the max."""
    from ska_sdp_cip_tpu_torch import VisibilityReader, invert_dataset
    from ska_sdp_cip_tpu_torch.io.synth import make_synthetic_dataset

    path = make_synthetic_dataset(tmp_path / "obs.vz", num_times=4,
                                  num_antennas=16, seed=4321)
    reader = VisibilityReader(path)
    before = _launches(False, 2 if wstack else 1), tfc.LAUNCHES
    got = invert_dataset(reader, npix, asec, do_wstacking=wstack,
                         device=cuda)
    assert _launches(False, 2 if wstack else 1) > before[0]
    assert tfc.LAUNCHES > before[1]
    ref = invert_dataset(reader, npix, asec, do_wstacking=wstack,
                         device="cpu")
    assert np.isfinite(got).all() and got.shape == ref.shape == (npix, npix)
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
    """A small MeasurementSet (``tests/helpers/ms_writer.py``, read by
    the casacore-free ``_NativeMSBackend``) inverted on the card through
    B1 and B2, against the invert of its VZ on the card: 1e-5 of the max
    (the reader's columns are the VZ's, so the two are expected to agree
    bit for bit)."""
    from helpers.ms_writer import vz_columns, write_measurement_set

    from ska_sdp_cip_tpu_torch import VisibilityReader, invert_dataset
    from ska_sdp_cip_tpu_torch.io.synth import make_synthetic_dataset

    vz = make_synthetic_dataset(tmp_path / "obs.vz", num_times=6,
                                num_antennas=16, seed=4321)
    ms = tmp_path / "obs.ms"
    write_measurement_set(ms, vz_columns(vz), tile_bytes=8192)
    reader = VisibilityReader(ms)
    assert type(reader._metadata.backend).__name__ == "_NativeMSBackend"
    before = tcg.LAUNCHES, tfc.LAUNCHES
    got = invert_dataset(reader, 128, 30.0, device=cuda)
    assert tcg.LAUNCHES > before[0] and tfc.LAUNCHES > before[1]
    want = invert_dataset(VisibilityReader(vz), 128, 30.0, device=cuda)
    assert np.isfinite(got).all() and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _last_axis_pass(cuda, n, out_crop, in_crop, sign, prefix):
    plan = make_fft_plan(n, shifted=True)
    meta = tfc.fused_pass_meta(plan, out_crop, in_crop=in_crop)
    host = fft_plan_arrays(plan, prefix="fft")
    host.update(tfc.fused_pass_kernel_arrays(plan, meta, sign=sign,
                                             prefix=prefix))
    host.update(tfc.last_axis_kernel_arrays(plan, meta, sign=sign,
                                            prefix=prefix))
    return meta, tg.stage_arrays(host, cuda)


#: B2L's cases (crop kind, n, crop, rows): n1 = 30 (960), 250 (156250:
#: a 16-lane stage 2) and 686 (1647086 = 686 x 2401: a 4-lane stage 2);
#: a 41-column in-crop runs the 4-byte staging of stage 1.
LAST_AXIS_CASES = [("out", 96, (24, 48), 128), ("in", 96, (24, 48), 128),
                   ("out", 960, (240, 480), 100), ("in", 960, (240, 480), 37),
                   ("in", 960, (300, 41), 64),
                   ("out", 15360, (2560, 10240), 6),
                   ("in", 15360, (2560, 10240), 5),
                   ("out", 156250, (39062, 78126), 6),
                   ("in", 156250, (39062, 78126), 3),
                   ("out", 1647086, (411771, 823543), 2)]


@pytest.mark.parametrize("kind,n,crop,rows", LAST_AXIS_CASES)
def test_last_axis_kernel_matches_plain_and_b2_on_transpose(cuda, kind, n,
                                                            crop, rows):
    """B2L within 1e-5 of the max of its plain version, equal bit for bit
    to B2 on the transposed input (the same arithmetic, other
    addresses), and to itself run again."""
    sign, prefix = (+1, "fftp") if kind == "out" else (-1, "fftq")
    meta, f = _last_axis_pass(cuda, n, crop if kind == "out" else None,
                              crop if kind == "in" else None, sign, prefix)
    width = crop[1] if kind == "in" else n
    rng = np.random.default_rng(n + rows)
    re, im = (torch.from_numpy(rng.normal(size=(rows, width))
                               .astype(np.float32)).to(cuda)
              for _ in range(2))
    before = tfc.LAST_AXIS_LAUNCHES + tfc.LAST_AXIS_IN_CROP_LAUNCHES
    got = tfc.fft_last_axis_fused(re, im, f, meta=meta, sign=sign,
                                  prefix=prefix)
    torch.cuda.synchronize()
    assert tfc.LAST_AXIS_LAUNCHES + tfc.LAST_AXIS_IN_CROP_LAUNCHES \
        == before + 1
    ref = tfc.fft_last_axis_reference(re, im, f, meta=meta, sign=sign)
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (rows, meta.size)
        assert float((g - r).abs().max()) <= 1e-5 * scale
    b2 = tfc.fft_first_axis_fused(re.t().contiguous(), im.t().contiguous(),
                                  f, meta=meta, sign=sign, prefix=prefix)
    again = tfc.fft_last_axis_fused(re, im, f, meta=meta, sign=sign,
                                    prefix=prefix)
    for g, b, a in zip(got, b2, again):
        assert torch.equal(g, b.t()) and torch.equal(g, a)


@pytest.mark.parametrize("mode", ["screen_accumulate", "accumulate",
                                  "screened_load"])
@pytest.mark.parametrize("n,npix", [(96, 48), (15360, 10240)])
def test_last_axis_screens_match_plain(cuda, mode, n, npix):
    """B2L's screened store and load against their plain versions (1e-5
    of the max), and the store bit-equal to B2 on the transpose with
    torch's screen and sum after it (the path it replaced)."""
    crop = ((n - npix) // 2, npix)
    load = mode == "screened_load"
    sign, prefix = (-1, "fftq") if load else (+1, "fftp")
    meta, f = _last_axis_pass(cuda, n, None if load else crop,
                              crop if load else None, sign, prefix)
    rows = 16
    rng = np.random.default_rng(7)

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape)
                                .astype(np.float32)).to(cuda)

    nm1s = rand(rows, npix) * 1e-3
    coef = torch.tensor([2.0 * np.pi * 1234.5], device=cuda)
    if load:
        img = rand(rows, npix)
        got = tfc.fft_last_axis_fused(img, None, f, meta=meta, sign=sign,
                                      prefix=prefix, screen=(nm1s, coef))
        s_re, s_im = tfc.screen_load_reference(img, nm1s, coef)
        ref = tfc.fft_last_axis_reference(s_re, s_im, f, meta=meta,
                                          sign=sign)
        got, ref = list(got), list(ref)
    else:
        re, im, acc = rand(rows, n), rand(rows, n), rand(rows, npix)
        screen = (nm1s, -coef) if mode == "screen_accumulate" else None
        got = [tfc.fft_last_axis_fused(re, im, f, meta=meta, sign=sign,
                                       prefix=prefix, screen=screen,
                                       acc=acc.clone())]
        b2 = tfc.fft_first_axis_fused(re.t().contiguous(),
                                      im.t().contiguous(), f, meta=meta,
                                      sign=sign, prefix=prefix)
        b_re, b_im = (x.t().contiguous() for x in b2)
        if screen:
            theta = screen[1] * nm1s
            unfused = acc + (b_re * torch.cos(theta) - b_im * torch.sin(theta))
        else:
            unfused = acc + b_re
        assert torch.equal(got[0], unfused)
        p_re, p_im = tfc.fft_last_axis_reference(re, im, f, meta=meta,
                                                 sign=sign)
        ref = [tfc.screen_accumulate_reference(acc.clone(), p_re, p_im,
                                               *screen) if screen
               else acc + p_re]
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("wstack", [False, True], ids=["G1", "G"])
def test_fused_invert_and_predict_equal_unfused_on_card(cuda, wstack):
    """``dirty_image`` and ``predict_visibilities`` on the card, one B2 and
    one B2L launch a plane, against the same calls on the CPU (the
    kernels' plain versions): within 1e-5 of the max."""
    uvw, freqs, vis, wgt = _small(num_times=4, num_antennas=12)
    image = np.random.default_rng(3).normal(size=(96, 96)).astype(np.float32)

    def run(device):
        return (tg.dirty_image(uvw, freqs, vis, wgt, 96, PIXEL,
                               do_wstacking=wstack, device=device),
                tg.predict_visibilities(uvw, freqs, image, PIXEL,
                                        do_wstacking=wstack, device=device))

    before = (tfc.LAUNCHES, tfc.LAST_AXIS_LAUNCHES,
              tfc.IN_CROP_LAUNCHES, tfc.LAST_AXIS_IN_CROP_LAUNCHES)
    dirty, model = (np.array(x) for x in run(cuda))
    after = (tfc.LAUNCHES, tfc.LAST_AXIS_LAUNCHES,
             tfc.IN_CROP_LAUNCHES, tfc.LAST_AXIS_IN_CROP_LAUNCHES)
    steps = [a - b for a, b in zip(after, before)]
    assert steps[0] == steps[1] > 0 and steps[2] == steps[3] > 0
    dirty_ref, model_ref = run("cpu")
    assert np.abs(dirty - dirty_ref).max() <= 1e-5 * np.abs(dirty_ref).max()
    assert np.abs(model - model_ref).max() <= 1e-5 * np.abs(model_ref).max()


#: T1's geometries: name -> (npix, asec, plan options, ngrid, support).
#: "production" is the snapshot's image (dw = 1 / (sigma |nm1_min|) and
#: n_mid = nm1_min / 2 follow from the image and sigma alone, so every
#: dump plan of the snapshot has this plan's); "large" the 16384 px
#: image at 0.5 asec; "odd" an odd image, whose mirrored evaluation has
#: a mirror for its first row and column.
TAPER_CASES = {
    "production": (10240, 1.1, {"sigma": 1.5}, 15360, 8),
    "small": (96, 40.0, {}, 192, 6),
    "odd": (97, 40.0, {}, 196, 6),
    "no_wstacking": (10240, 1.1, {"sigma": 1.5, "do_wstacking": False},
                     15360, 8),
    "large": (16384, 0.5, {"sigma": 2.0}, 32768, 6),
}


@pytest.mark.parametrize("name", TAPER_CASES)
def test_taper_kernel_matches_plain(cuda, name):
    """T1 (one launch a map pair) within 1e-6 of each map's max of its
    plain version on the card, and its mirrored evaluation equal bit
    for bit to the one-pixel-at-a-time one."""
    npix, asec, opts, ngrid, support = TAPER_CASES[name]
    uvw, freqs, _, _ = _small()
    plan = make_plan(uvw, freqs, npix,
                     float(np.sin(np.radians(asec / 3600))), **opts)
    assert (plan.ngrid, plan.support) == (ngrid, support)
    assert plan.wstacking == opts.get("do_wstacking", True)
    arrays = tg.stage_arrays(tg._quad_arrays(plan), cuda)
    before = ttc.TAPER_LAUNCHES
    got = tg._geometry_maps(plan, arrays)
    torch.cuda.synchronize()
    assert ttc.TAPER_LAUNCHES == before + 1
    one_by_one = ttc.taper_maps(
        arrays["quad_nodes"], arrays["quad_folded"], npix=npix, ngrid=ngrid,
        support=support, pixel_size_lm=plan.pixel_size_lm,
        wstacking=plan.wstacking, dw=plan.dw, n_mid=plan.n_mid,
        mirror=False)
    for g, o in zip(got, one_by_one):
        assert torch.equal(g, o)
    del one_by_one
    ref = tg._geometry_maps_reference(plan, arrays)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (npix, npix)
        assert bool(torch.isfinite(g).all())
        assert float((g - r).abs().max()) <= 1e-6 * float(r.abs().max())


def test_taper_kernel_once_per_invert_and_predict(cuda):
    """Every call of ``build_invert``'s invert and ``build_predict``'s
    predict on the card launches T1 once."""
    uvw, freqs, vis, wgt = _small(num_times=4, num_antennas=12)
    image = np.random.default_rng(3).normal(size=(96, 96)).astype(np.float32)
    for _ in range(2):
        before = ttc.TAPER_LAUNCHES
        tg.dirty_image(uvw, freqs, vis, wgt, 96, PIXEL, device=cuda)
        assert ttc.TAPER_LAUNCHES == before + 1
        tg.predict_visibilities(uvw, freqs, image, PIXEL, device=cuda)
        assert ttc.TAPER_LAUNCHES == before + 2


#: S1's cases: name -> (npix, scales, radius, pad). The CLI's scales
#: (radius 17) and the benchmark cell's (33), a factor of 3 taps and of
#: 131 (scale 32), and one of 151, which takes the 32-cell tile; even,
#: odd and ragged images; pads 0, npix / 2 and a Clark patch's P / 2.
SCALE_CONV_CASES = {
    "k3_97_pad0": (97, (0.0, 0.5, 1.0), 1, 0),
    "k35_97_half": (97, (0.0, 2.0, 4.0, 8.0), 17, 48),
    "k35_512_clark": (512, (0.0, 2.0, 4.0, 8.0), 17, 32),
    "k67_512_half": (512, (0.0, 4.0, 8.0, 16.0), 33, 256),
    "k67_1000_clark": (1000, (0.0, 4.0, 8.0, 16.0), 33, 1024),
    "k131_1000_pad0": (1000, (0.0, 8.0, 16.0, 32.0), 65, 0),
    "k131_512_clark": (512, (0.0, 8.0, 16.0, 32.0), 65, 32),
    "k151_200_tile32": (200, (0.0, 37.0), 75, 7),
}


def _scale_image(npix, seed=5):
    """Noise, two compact sources and an extended one: a residual of the
    kind the minor cycle convolves."""
    rng = np.random.default_rng(seed)
    image = 0.01 * rng.normal(size=(npix, npix))
    y, x = np.mgrid[:npix, :npix]
    for (fy, fx), flux, width in (((0.3, 0.7), 2.0, 1.5),
                                  ((0.7, 0.35), 1.1, 2.5),
                                  ((0.55, 0.6), 0.8, 9.0)):
        r2 = (y - fy * npix) ** 2 + (x - fx * npix) ** 2
        image += flux * np.exp(-0.5 * r2 / width**2)
    return image.astype(np.float32)


@pytest.mark.parametrize("name", SCALE_CONV_CASES)
def test_scale_conv_kernel_matches_float64(cuda, name):
    """S1 (one launch for all S frames) within 2e-6 of the max of the
    float64 2-D convolution with each scale kernel; against cuDNN's
    float32 one within 2e-6 plus cuDNN's own distance from the float64
    convolution (which reaches 2.6e-6 at 67 taps and 5.9e-6 at 131 on an
    H100: more taps summed in float32); scale 0's frame equal to the
    image bit for bit; every margin cell zero (the frames come from a
    block the caching allocator held filled with NaN)."""
    from ska_sdp_cip_tpu_torch.models import multiscale as tms

    npix, scales, radius, pad = SCALE_CONV_CASES[name]
    image = torch.from_numpy(_scale_image(npix)).to(cuda)
    kernels = torch.from_numpy(
        np.stack([tms.scale_kernel(s, radius) for s in scales])).to(cuda)
    factors = tms.scale_factors(kernels)
    shape = (len(scales), npix + 2 * pad, npix + 2 * pad)
    nan = torch.full(shape, float("nan"), device=cuda)
    del nan
    before = tsc.SCALE_CONV_LAUNCHES
    frames = tsc.scale_frames(image, factors, pad)
    torch.cuda.synchronize()
    assert tsc.SCALE_CONV_LAUNCHES == before + 1
    assert frames.shape == shape
    inner = frames[:, pad : pad + npix, pad : pad + npix]
    margins = frames.clone()
    margins[:, pad : pad + npix, pad : pad + npix] = 0
    assert not bool(margins.any())
    assert torch.equal(inner[0], image)
    for s in range(len(scales)):
        exact = tms._conv_same(image.double(), kernels[s].double())
        scale = float(exact.abs().max())
        err = float((inner[s].double() - exact).abs().max()) / scale
        assert err <= 2e-6, (s, err)
        cudnn = tms._conv_same(image, kernels[s])
        cudnn_err = float((cudnn.double() - exact).abs().max()) / scale
        gap = float((inner[s] - cudnn).abs().max()) / scale
        assert gap <= 2e-6 + cudnn_err, (s, gap, cudnn_err)


def test_scale_conv_once_per_minor_cycle(cuda):
    """Building a minor cycle launches S1 once for the PSF's frames and
    once for each of their S cross frames; each minor cycle once for
    its residual (the recorder's counter ``scale_conv_kernel`` one a
    cycle while tracing), and no scale convolution reaches ``conv2d``."""
    from ska_sdp_cip_tpu_torch.models import multiscale as tms
    from ska_sdp_cip_tpu_torch.utils import task_metrics

    dirty, psf = _solver_problem()
    kernels = torch.from_numpy(
        np.stack([tms.scale_kernel(s, 9) for s in (0.0, 2.0, 4.0)]))
    args = [torch.from_numpy(a).to(cuda) for a in (dirty, psf)]
    conv2d = torch.nn.functional.conv2d

    def refused(*a, **k):
        raise AssertionError("a CUDA scale convolution reached conv2d")

    torch.nn.functional.conv2d = refused
    try:
        for patch in (None, 64):
            before = tsc.SCALE_CONV_LAUNCHES
            minor = tms.prepare_multiscale_minor(
                args[1], kernels.to(cuda), torch.ones(3, device=cuda),
                psf_patch=patch)
            assert tsc.SCALE_CONV_LAUNCHES == before + 4
            task_metrics.reset()
            with task_metrics.tracing():
                for k in range(2):
                    model, _ = minor(args[0], gain=0.2, max_iter=10)
                    assert tsc.SCALE_CONV_LAUNCHES == before + 5 + k
            counters = task_metrics.summary()["counters"]
            assert counters["scale_conv_kernel"] == 2
            assert counters["scale_frames"] == 2 * 3
            assert bool(model.any())
    finally:
        torch.nn.functional.conv2d = conv2d
