"""
The port's native C++ planner engine (``ska_sdp_cip_tpu_torch/native.py``
and ``csrc/cip_native.cpp``) against the port's numpy planner and the
JAX package's, on the CPU: the port's version of
``tests/test_plan_native.py`` and of
``tests/test_weighting.py::test_native_density_matches_numpy``.

* ``csrc/cip_native.cpp`` is a byte-for-byte copy of
  ``native/cip_native.cpp``;
* the engine (built here with the host C++ compiler into
  ``build/torch_native/``; the tests skip only when no compiler is on
  ``PATH``) builds the numpy planner's plan: every slot and block column
  and every scalar exactly, the exported ``packed`` / ``flip_sign``
  columns exactly as the numpy path builds them on demand, the phase
  factors within 1e-6 (the two sides take cos/sin through different
  libraries), and the compact path's ``order_enc`` as its numpy
  encoding; at the bench geometry, the production configuration and
  against the JAX package's numpy plan through ``plan_from_fields``;
* ``stage_slot_vis`` and ``density_accumulate`` (at a size where the
  engine runs on several threads) match numpy: the staging to 1e-6 of
  the max, the density to rtol 1e-12 (the threads' atomic adds sum in
  another order); ``w_minmax`` equals ``w_range``'s numpy branch to
  the last bit;
* with no compiler the numpy planner runs; a failing build raises with
  the compiler's output and nothing falls back.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu.io.synth import synthetic_uvw
from ska_sdp_cip_tpu.ops import plan as jplan
from ska_sdp_cip_tpu_torch import native as tnative
from ska_sdp_cip_tpu_torch.models import weighting as tweighting
from ska_sdp_cip_tpu_torch.ops import cuda_gridder as tcg
from ska_sdp_cip_tpu_torch.ops import gridder as tg
from ska_sdp_cip_tpu_torch.ops import plan as tplan

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PHASE_ATOL = 1e-6
SLOT_COLUMNS = ("order", "flip", "x0", "y0", "fx", "fy", "ws")
BLOCK_COLUMNS = ("block_start", "block_len", "block_ox", "block_oy")
#: The columns only the engine exports (the numpy path leaves them None).
EXPORTED = ("packed", "flip_sign", "phase_cos", "phase_sin", "order_enc")


@pytest.fixture
def engine():
    if tnative.find_cxx() is None:
        pytest.skip("no C++ compiler on PATH: the numpy planner runs")
    assert tnative.available()


@pytest.fixture
def numpy_planner(monkeypatch):
    """Call ``fn`` with the engine switched off."""

    def run(fn, *args, **kwargs):
        with monkeypatch.context() as m:
            m.setattr(tnative, "available", lambda: False)
            return fn(*args, **kwargs)

    return run


def _inputs(num_times=4, num_antennas=24, num_channels=5, asec=8.0,
            seed=7, baseline=4000.0):
    uvw, _ = synthetic_uvw(num_times, num_antennas, max_baseline_m=baseline,
                           seed=seed)
    freqs = np.linspace(1.4e9, 1.5e9, num_channels)
    return uvw, freqs, float(np.sin(np.radians(asec / 3600.0)))


def _assert_plans_equal(engine_plan, numpy_plan):
    """Every field of the numpy plan, exactly, except the engine's
    exports, which the numpy path leaves None."""
    for field in dataclasses.fields(numpy_plan):
        a = getattr(engine_plan, field.name)
        b = getattr(numpy_plan, field.name)
        if field.name in EXPORTED:
            assert b is None, field.name
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert type(a) is type(b) and a == b, field.name


def _assert_exports_match(engine_plan, numpy_plan, numpy_planner):
    """The engine's exported columns against the numpy path's on-demand
    versions of them."""
    if engine_plan.order_enc is not None:
        assert engine_plan.packed is None
        flipped = numpy_plan.flip
        enc = np.where(flipped, -numpy_plan.order.astype(np.int64) - 1,
                       numpy_plan.order).astype(np.int32)
        np.testing.assert_array_equal(engine_plan.order_enc, enc)
        return
    np.testing.assert_array_equal(engine_plan.packed,
                                  tcg.pack_plan_columns(numpy_plan))
    host = numpy_planner(tg.plan_order_host, numpy_plan)
    np.testing.assert_array_equal(engine_plan.flip_sign, host["flip_sign"])
    for key in ("phase_cos", "phase_sin"):
        np.testing.assert_allclose(getattr(engine_plan, key), host[key],
                                   rtol=0, atol=PHASE_ATOL, err_msg=key)


def test_engine_source_is_a_verbatim_copy():
    ours = REPO / "ska_sdp_cip_tpu_torch" / "csrc" / "cip_native.cpp"
    ref = REPO / "native" / "cip_native.cpp"
    assert ours.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize(
    "kwargs",
    [
        {},
        {"do_wstacking": False},
        {"export_packed": False, "sigma": 1.5},
        {"block": 32, "bin_group": 2, "min_blocks": 400},
    ],
    ids=["wstack", "no_wstack", "compact_sigma1.5", "block32_padded"],
)
def test_engine_plan_equals_numpy_plan(engine, numpy_planner, kwargs):
    uvw, freqs, pixel = _inputs()
    ours = tplan.make_plan(uvw, freqs, 256, pixel, export_coords=True,
                           **kwargs)
    ref = numpy_planner(tplan.make_plan, uvw, freqs, 256, pixel, **kwargs)
    _assert_plans_equal(ours, ref)
    _assert_exports_match(ours, ref, numpy_planner)


def test_engine_skips_the_coordinates_unless_asked(engine, numpy_planner):
    uvw, freqs, pixel = _inputs()
    ours = tplan.make_plan(uvw, freqs, 256, pixel)
    ref = numpy_planner(tplan.make_plan, uvw, freqs, 256, pixel)
    for name in SLOT_COLUMNS[1:]:
        assert getattr(ours, name) is None, name
    np.testing.assert_array_equal(ours.order, ref.order)
    np.testing.assert_array_equal(tg.packed_rows(ours), tg.packed_rows(ref))
    compact = tplan.make_plan(uvw, freqs, 256, pixel, export_packed=False)
    assert compact.packed is None and compact.x0 is None
    assert compact.order_enc is not None


def test_engine_plan_equals_jax_plan(engine):
    """The JAX package's (numpy) plan, carried into the port by
    ``plan_from_fields``, is the engine's."""
    uvw, freqs, pixel = _inputs()
    ref = tplan.plan_from_fields(
        dataclasses.asdict(jplan.make_plan(uvw, freqs, 256, pixel))
    )
    ours = tplan.make_plan(uvw, freqs, 256, pixel, export_coords=True)
    for name in SLOT_COLUMNS + BLOCK_COLUMNS + ("active_table", "plane_w"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(ref, name), err_msg=name)
    for name in ("num_blocks", "nplanes", "plane_group", "nalloc_x",
                 "nalloc_y", "w0", "dw", "n_mid", "sigma", "support"):
        assert getattr(ours, name) == getattr(ref, name), name
    np.testing.assert_array_equal(tg.packed_rows(ours), tg.packed_rows(ref))


@pytest.mark.parametrize("geometry", ["bench", "production"])
def test_engine_plan_at_the_smoke_geometries(engine, numpy_planner,
                                             geometry):
    """The bench geometry (2048 px at 5 asec, ngrid 4096) on a cut
    dataset, and the production configuration (10240 px at 1.1 asec,
    sigma "auto", 258,048 visibilities) at full size."""
    if geometry == "bench":
        uvw, _ = synthetic_uvw(2, 40, max_baseline_m=7700.0, seed=42)
        freqs = np.linspace(1.40e9, 1.507e9, 8)
        npix, asec, kw = 2048, 5.0, {}
    else:
        uvw, _ = synthetic_uvw(4, 64, max_baseline_m=7700.0, seed=11)
        freqs = np.linspace(1.40e9, 1.507e9, 32)
        npix, asec, kw = 10240, 1.1, {"sigma": "auto"}
    pixel = float(np.sin(np.radians(asec / 3600.0)))
    ours = tplan.make_plan(uvw, freqs, npix, pixel, export_coords=True, **kw)
    ref = numpy_planner(tplan.make_plan, uvw, freqs, npix, pixel, **kw)
    _assert_plans_equal(ours, ref)
    _assert_exports_match(ours, ref, numpy_planner)


def test_stage_slot_vis_matches_numpy(engine, numpy_planner):
    uvw, freqs, pixel = _inputs()
    plan = tplan.make_plan(uvw, freqs, 256, pixel, export_coords=True)
    ref_plan = numpy_planner(tplan.make_plan, uvw, freqs, 256, pixel)
    rng = np.random.default_rng(3)
    re, im = rng.normal(size=(2, plan.num_vis_data)).astype(np.float32)
    ours = tg.stage_slot_vis(plan, re, im)
    ref = numpy_planner(tg.stage_slot_vis, ref_plan, re, im)
    scale = max(np.abs(ref[0]).max(), np.abs(ref[1]).max())
    for got, want in zip(ours, ref):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    # Padding slots stage as zero.
    pad = plan.order >= plan.num_vis_data
    assert pad.any() and not ours[0][pad].any() and not ours[1][pad].any()
    # The engine's phase pass on a plan without exported phases.
    carried = tplan.plan_from_fields(dataclasses.asdict(ref_plan))
    host = tg.plan_order_host(carried)
    want = numpy_planner(tg.plan_order_host, carried)
    for key in ("phase_cos", "phase_sin"):
        np.testing.assert_allclose(host[key], want[key], rtol=0,
                                   atol=PHASE_ATOL, err_msg=key)


def test_density_matches_numpy(engine, numpy_planner):
    """70,000 rows: above the engine's threading threshold (65,536), so
    its threads add into the grid concurrently."""
    rng = np.random.default_rng(11)
    uvw = rng.normal(scale=2000.0, size=(70_000, 3))
    freqs = np.array([1.0e9, 1.2e9])
    weights = rng.uniform(0.5, 2.0, size=(len(uvw), len(freqs)))
    pixel = float(np.sin(np.radians(20.0 / 3600.0)))
    weighter = tweighting.ImagingWeighter(256, pixel, scheme="uniform")
    ours = weighter.accumulate_density(uvw, freqs, weights)
    ref = numpy_planner(weighter.accumulate_density, uvw, freqs, weights)
    assert ours.sum() > 0
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="contiguous"):
        tnative.density_accumulate(uvw, freqs, weights, inv_cell=1.0,
                                   npix=256,
                                   density=np.zeros((256, 256), np.float32))


def test_w_minmax_and_prewarm(engine, numpy_planner):
    uvw, freqs, _ = _inputs()
    # The engine scales w by freq / c in another order: a last-bit
    # difference.
    np.testing.assert_allclose(
        tplan.w_range(uvw, freqs),
        numpy_planner(tplan.w_range, uvw, freqs), rtol=1e-15, atol=0,
    )
    assert tplan.w_range(uvw[:0], freqs) == (0.0, 0.0)
    tplan.prewarm_plan_arenas(len(uvw) * len(freqs))
    tplan.prewarm_plan_arenas(0)


def test_gather_and_argsort_match_numpy(engine):
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 50, size=1000).astype(np.int64)
    np.testing.assert_array_equal(tnative.argsort_i64(keys),
                                  np.argsort(keys, kind="stable"))
    order = rng.integers(0, 300, size=500)
    for dtype in (np.float32, np.int32, np.uint8, np.float64):
        src = rng.integers(0, 200, size=300).astype(dtype)
        np.testing.assert_array_equal(tnative.gather(src, order), src[order])
    with pytest.raises(IndexError):
        tnative.gather(src, np.array([300]))


def test_c1_positions_hold_with_the_engine_plan(engine):
    """ROADMAP.md C1's test (``tests/test_torch_gridder.py``) on a plan
    the engine built, as the main path builds it."""
    import test_torch_gridder

    test_torch_gridder.test_assemble_positions_hold_at_the_bench_grid()


def test_invert_dataset_same_with_either_engine(engine, numpy_planner,
                                                dataset_path):
    from ska_sdp_cip_tpu_torch import VisibilityReader, invert_dataset

    reader = VisibilityReader(dataset_path)
    ours = invert_dataset(reader, 128, 30.0, weighting="robust",
                          device="cpu")
    ref = numpy_planner(invert_dataset, reader, 128, 30.0,
                        weighting="robust", device="cpu")
    assert np.abs(ours - ref).max() <= 1e-6 * np.abs(ref).max()


def test_no_compiler_runs_the_numpy_planner(monkeypatch):
    monkeypatch.setattr(tnative, "find_cxx", lambda: None)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_SEARCHED", False)
    assert not tnative.available()
    uvw, freqs, pixel = _inputs(num_antennas=10)
    plan = tplan.make_plan(uvw, freqs, 128, pixel)
    assert plan.packed is None and plan.x0 is not None


def test_failed_build_raises(engine, monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "CXX_FLAGS",
                        tnative.CXX_FLAGS + ("-fno-such-option",))
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_SEARCHED", False)
    with pytest.raises(RuntimeError, match="no-such-option"):
        tnative.available()
    uvw, freqs, pixel = _inputs(num_antennas=10)
    with pytest.raises(RuntimeError, match="native planner engine"):
        tplan.make_plan(uvw, freqs, 128, pixel)
    assert not list(tmp_path.glob("*.so"))
