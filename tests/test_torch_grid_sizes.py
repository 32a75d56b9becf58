"""
Grids outside the sizes the bench and production plans make, on the CPU.

* ``invert_dataset`` at 32 px / 60 asec (a 64-cell grid) and 16 px /
  120 asec (32 cells), grids narrower than a B1 patch (48 x 128), with
  and without w-stacking, against the JAX package's ``dirty_image`` (its
  XLA path, the default on the CPU) of the same weighted visibilities,
  normalized by their weight: 1e-5 of the max.
* B1's work list at a 32768^2 grid (16384 px at 0.5 asec) of a plan with
  480 visibilities, read without any N x N array: the rectangles' areas
  sum to N^2 and no two overlap (each band's column intervals, sorted,
  touch end to start); every rectangle that runs reach is at most tile_x
  x ``grid_piece_cols``; and every footprint that meets a rectangle
  starts, rectangle-local as the kernel keeps it, in (-W, tile_x) x
  (-W, ``grid_piece_cols``), the range that makes the kernel's byte
  fields of a staged start safe at any N.
* The w-taper correction computed in row slabs equals the one computed
  whole; a grid narrower than the support has no work list.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu.io.visibility_dataset import (
    VisibilityReader as JaxReader,
)
from ska_sdp_cip_tpu.ops.gridder import dirty_image as jax_dirty_image
from ska_sdp_cip_tpu_torch import VisibilityReader, invert_dataset
from ska_sdp_cip_tpu_torch.invert import (
    StokesIGridderInput,
    pixel_size_lm_from_asec,
)
from ska_sdp_cip_tpu_torch.io.synth import (
    make_synthetic_dataset,
    synthetic_uvw,
)
from ska_sdp_cip_tpu_torch.ops import cuda_gridder as tcg
from ska_sdp_cip_tpu_torch.ops import gridder as tg
from ska_sdp_cip_tpu_torch.ops.plan import make_plan

torch.set_num_threads(1)

RTOL = 1e-5


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("grid_sizes") / "obs.vz"
    return make_synthetic_dataset(path, num_times=4, num_antennas=16,
                                  seed=4321)


@pytest.mark.parametrize("npix,asec", [(32, 60.0), (16, 120.0)])
@pytest.mark.parametrize("wstack", [True, False],
                         ids=["wstack", "no_wstack"])
def test_tiny_invert_matches_jax_dirty_image(dataset, npix, asec, wstack):
    ours = invert_dataset(VisibilityReader(dataset), npix, asec,
                          do_wstacking=wstack, device="cpu")
    gi = StokesIGridderInput.from_reader(JaxReader(dataset))
    weights = gi.effective_weights()
    ref = jax_dirty_image(
        gi.uvw, gi.channel_frequencies, gi.visibilities, weights, npix,
        pixel_size_lm_from_asec(asec), do_wstacking=wstack,
    ) / weights.sum()
    plan = make_plan(gi.uvw, gi.channel_frequencies, npix,
                     pixel_size_lm_from_asec(asec), do_wstacking=wstack)
    assert plan.ngrid == 2 * npix < plan.patch_y
    assert ours.shape == ref.shape == (npix, npix)
    assert np.abs(ours - ref).max() <= RTOL * np.abs(ref).max()


@pytest.fixture(scope="module")
def wide_plan():
    uvw, _ = synthetic_uvw(2, 16, max_baseline_m=7700.0, seed=42)
    freqs = np.linspace(1.40e9, 1.507e9, 2)
    plan = make_plan(uvw, freqs, 16384, pixel_size_lm_from_asec(0.5))
    assert plan.ngrid == 32768 and plan.num_vis_data == 480
    return plan


def test_wide_work_list_partitions_the_grid(wide_plan):
    plan = wide_plan
    N = plan.ngrid
    for ids in tg.group_active_blocks(plan):
        chunks = tg.grid_chunks(plan, ids).astype(np.int64)
        row0, nrows, col0, ncols = chunks[:, :4].T
        assert (nrows >= 1).all() and (ncols >= 1).all()
        assert ((row0 + nrows <= N) & (col0 + ncols <= N)).all()
        assert int((nrows * ncols).sum()) == N * N
        # Rows come in bands: a band's rectangles share (row0, nrows),
        # bands tile [0, N), and a band's columns tile [0, N).
        bands = np.unique(chunks[:, :2], axis=0)
        assert bands[0, 0] == 0
        assert (bands[1:, 0] == bands[:-1].sum(axis=1)).all()
        assert bands[-1].sum() == N
        for r0, nr in bands:
            mine = chunks[(row0 == r0) & (nrows == nr)]
            order = np.argsort(mine[:, 2])
            lo, width = mine[order, 2], mine[order, 3]
            assert lo[0] == 0 and lo[-1] + width[-1] == N
            assert (lo[1:] == lo[:-1] + width[:-1]).all()
        busy = chunks[chunks[:, 5] > 0]
        assert len(busy) > 0
        assert (busy[:, 1] <= plan.tile_x).all()
        assert (busy[:, 3] <= tcg.grid_piece_cols(plan)).all()


def test_wide_footprint_starts_fit_the_packing(wide_plan):
    """Every footprint that meets a rectangle starts, rectangle-local as
    ``csrc/grid.cu`` keeps it, in (-W, tile_x) x (-W, grid_piece_cols)."""
    plan = wide_plan
    N, W = plan.ngrid, plan.support
    packed = tg.packed_rows(plan)
    half = 0.5 * W
    met = 0
    for ids in tg.group_active_blocks(plan):
        chunks = tg.grid_chunks(plan, ids).astype(np.int64)
        for row0, nrows, col0, ncols, *src in chunks[chunks[:, 5] > 0]:
            for first, count in zip(src[::2], src[1::2]):
                if count == 0:
                    break
                blocks = ids[first : first + count]
                slots = np.concatenate([
                    np.arange(b * plan.block, b * plan.block
                              + plan.block_len[b]) for b in blocks])
                b0 = blocks[0]
                starts = []
                for pos, origin, lo in (
                        (packed[0][slots], plan.block_ox[b0], row0),
                        (packed[1][slots], plan.block_oy[b0], col0)):
                    local = (int(origin) - W - lo
                             + np.floor(pos - half).astype(np.int64) + 1) % N
                    starts.append(np.where(local > N - W, local - N, local))
                lr, lc = starts
                meets = (lr < nrows) & (lc < ncols)
                met += int(meets.sum())
                assert (lr[meets] > -W).all() and (lc[meets] > -W).all()
                assert (lr[meets] < plan.tile_x).all()
                assert (lc[meets] < tcg.grid_piece_cols(plan)).all()
    assert met >= plan.num_vis_data


def test_correction_in_row_slabs_equals_whole(monkeypatch):
    uvw, _ = synthetic_uvw(3, 10, max_baseline_m=5000.0, seed=23)
    freqs = np.linspace(1.0e9, 1.07e9, 2)
    plan = make_plan(uvw, freqs, 96, pixel_size_lm_from_asec(40.0))
    assert plan.wstacking
    arrays = tg.stage_arrays(tg._quad_arrays(plan), "cpu")
    whole = tg._geometry_maps(plan, arrays)
    # Slabs of 7 rows: 14 of them, the last of 5.
    monkeypatch.setattr(tg, "CORRECTION_TERMS",
                        7 * 96 * len(plan.quad_nodes))
    slabs = tg._geometry_maps(plan, arrays)
    for a, b in zip(whole, slabs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_grid_narrower_than_the_support_has_no_work_list(wide_plan):
    small = dataclasses.replace(wide_plan, ngrid=wide_plan.support - 1)
    with pytest.raises(ValueError, match="narrower than the support"):
        tg.grid_chunks(small, tg.group_active_blocks(wide_plan)[0])
