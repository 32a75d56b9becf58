"""The frozen copies in the harness give the originals' numbers."""

from __future__ import annotations

import json
import math
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cipbench import synth, trace, work

from .conftest import ROOT


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as module
    finally:
        sys.path.remove(str(ROOT))
    return module


def test_synthetic_uvw_is_the_programs():
    from ska_sdp_cip_tpu_torch.io.synth import synthetic_uvw

    for kw in (dict(seed=42), dict(seed=7, max_baseline_m=200.0,
                                   declination_deg=-40.0)):
        got = synth.synthetic_uvw(5, 9, **kw)
        want = synthetic_uvw(5, 9, **kw)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_sky_is_the_programs_point_sources_with_the_imaging_w_sign():
    from ska_sdp_cip_tpu_torch.io.synth import point_source_visibilities

    uvw, _ = synth.synthetic_uvw(3, 6, seed=2)
    freqs = np.array([1.4e9, 1.5e9])
    lm = np.array([[0.01, -0.02], [-0.03, 0.005]])
    flux = np.array([1.5, 0.7])
    got = synth.sky_visibilities(torch.as_tensor(uvw), torch.as_tensor(freqs),
                                 torch.as_tensor(lm), torch.as_tensor(flux))
    want = point_source_visibilities(uvw * [1, 1, -1], freqs, lm, flux)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_configurations_state_their_layouts_extent():
    for path in (ROOT / "cipbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        stated = cfg["layout_extent"]
        for key, value in synth.layout_extent(cfg).items():
            assert stated[key] == pytest.approx(value, abs=0.1), (path, key)


def test_snapshot_order_spreads_every_prefix_over_the_hour():
    from cipbench.drivers.snapshot import dump_order

    spec = json.loads((ROOT / "cipbench" / "traffic" / "snapshot.json")
                      .read_text())
    for path in (ROOT / "cipbench" / "configs").glob("*.json"):
        n = json.loads(path.read_text())["observation"]["num_dumps"]
        order = dump_order(n, spec["dump_step"])
        assert sorted(order) == list(range(n))
        # From 20 images on, a prefix's mean dump is within 3% of the
        # hour of the middle, and from n/10 on it holds every tenth.
        for length in range(20, n + 1):
            assert abs(order[:length].mean() - (n - 1) / 2) < 0.03 * n
        for length in range(n // 10, n + 1, 7):
            assert len({d * 10 // n for d in order[:length]}) == 10
    with pytest.raises(ValueError):
        dump_order(450, 6)


@pytest.mark.parametrize("npix,asec,sigma", [(64, 60.0, "auto"),
                                             (64, 60.0, 1.5), (48, 90.0, 2.0)])
def test_geometry_is_the_planners(npix, asec, sigma):
    from ska_sdp_cip_tpu_torch.ops.plan import make_plan

    uvw, _ = synth.synthetic_uvw(6, 7, max_baseline_m=300.0, seed=5)
    freqs = np.linspace(1.4e9, 1.43e9, 4)
    pix = synth.pixel_size_lm(asec)
    g = work.geometry(uvw, freqs, npix, pix, epsilon=1e-4, sigma=sigma)
    plan = make_plan(uvw, freqs, npix, pix, epsilon=1e-4, sigma=sigma)
    assert (g.support, g.ngrid, g.nplanes) == (plan.support, plan.ngrid,
                                               plan.nplanes)
    assert g.nvis == plan.num_vis_data


def test_bound_is_chip_smokes(chip_smoke):
    for nbytes, flops in ((1e9, 1e9), (1e6, 1e12)):
        want = chip_smoke.bound(nbytes, flops)["bound_ms"] / 1e3
        assert work.bound_seconds(nbytes, flops) == pytest.approx(want)


def test_fft_count_is_two_b2_passes(chip_smoke):
    # A 2-D transform of N^2 points is B2's first-axis pass over N
    # columns twice: 5 N log2 N a column each.
    n1, n2 = 16, 8
    N = n1 * n2
    meta = SimpleNamespace(n1=n1, n2=n2, size=N)
    flops_pass = chip_smoke.b2_work(meta, N, N)[2]
    g = work.Geometry(sigma=2.0, support=6, ngrid=N, nplanes=3, npix=N // 2,
                      nvis=1)
    nbytes, flops = work.fft_work(g)
    assert flops == pytest.approx(3 * 2 * flops_pass)
    assert nbytes == 3 * (8 * N * N + 4 * (N // 2) ** 2)


def test_gridding_count_is_chip_smokes_over_visibilities(chip_smoke):
    # chip_smoke.gridding_work: slots * (12 + 8) bytes and two FMAs a
    # cell and plane; here every visibility once, on its W planes.
    g = work.Geometry(sigma=2.0, support=6, ngrid=64, nplanes=9, npix=32,
                      nvis=1000)
    nbytes, flops = work.gridding_work(g)
    assert nbytes == 1000 * 20 + 9 * 8 * 64 * 64
    assert flops == 4.0 * 1000 * 6 * 6 * 6


def test_kernel_layers_cover_the_ports_kernels(chip_smoke):
    t = trace.Trace(window_s=1.0, ops=[
        ("void stage1_kernel<4>(Pass, float const*)", 0.0, 0.1),
        ("last_stage2_kernel(LPass, float const*)", 0.1, 0.2),
        ("grid_chunks_kernel(float const*)", 0.2, 0.4),
        ("degrid_chunks_kernel(float const*)", 0.3, 0.5),
        ("void at::native::elementwise_kernel<128, 4>", 0.6, 0.7),
    ])
    assert t.seconds_of("fft") == pytest.approx(0.2)
    assert t.seconds_of("gridding") == pytest.approx(0.4)
    for name, *_ in t.ops[:4]:
        assert any(k in name for k in chip_smoke.PORT_KERNELS)


def test_busy_union_and_idle_gaps():
    t = trace.Trace(window_s=10.0, ops=[("a", 1.0, 3.0), ("b", 2.0, 4.0),
                                        ("c", 6.0, 7.0)],
                    spans=[("plan", 0.0, 1.5), ("stage", 4.5, 6.5)])
    assert t.busy_s() == pytest.approx(4.0)
    gaps = dict(t.idle_gaps())
    assert gaps["idle in plan"] == pytest.approx(1.0)
    assert gaps["idle in stage"] == pytest.approx(1.5)
    assert gaps["idle outside spans"] == pytest.approx(3.5)
    assert t.device_ops()[0] == ["a", 2.0]
    assert math.isclose(sum(s for _, s in t.idle_gaps()), 6.0)
