"""
The port's UVW tile store (``ska_sdp_cip_tpu_torch/uvw_tiling``) on the
CPU, against the JAX package's: port versions of
``tests/uvw_tiling/test_reordering.py``, ``test_tiling_plan.py`` and
``test_tiled_invert.py::test_tiled_invert_matches_direct``.

* ``tiling_plan.py``, ``tile.py`` and ``__init__.py`` are byte-for-byte
  copies of the JAX package's (numpy and the standard library only),
  and ``reorder.py`` is one below its docstring (it reads through the
  port's reader and ``StokesIGridderInput``);
* the port's ``reorder_by_uvw_tile`` writes the JAX package's tiles on
  the same dataset, file by file and array by array, and conserves
  every sample (uvw, visibility, weight), also when two hosts share the
  work;
* ``invert_tile_chunks`` on the CPU matches the port's
  ``invert_dataset`` and the JAX ``invert_tile_chunks`` within the
  reference's own tolerance (atol 1e-4 of the max, rtol 1e-3, at
  epsilon 1e-5); ``sharded_invert_tile_chunks`` on a mesh of shards (in
  one gloo process), empty groups included, equals it at rtol 1e-5.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu import uvw_tiling as juvw
from ska_sdp_cip_tpu.io.synth import synthetic_uvw
from ska_sdp_cip_tpu.io.visibility_dataset import VisibilityReader as JaxReader
from ska_sdp_cip_tpu.uvw_tiling import tiled_invert as jtiled
from ska_sdp_cip_tpu_torch import VisibilityReader, invert_dataset
from ska_sdp_cip_tpu_torch import uvw_tiling as tuvw
from ska_sdp_cip_tpu_torch.invert import (
    StokesIGridderInput,
    pixel_size_lm_from_asec,
)
from ska_sdp_cip_tpu_torch.uvw_tiling import Tile, reorder_by_uvw_tile
from ska_sdp_cip_tpu_torch.uvw_tiling import tiled_invert as ttiled
from ska_sdp_cip_tpu_torch.uvw_tiling.tiling_plan import (
    SPEED_OF_LIGHT,
    create_uvw_tile_mapping,
    merge_tile_mappings,
)

torch.set_num_threads(1)

TILE_SIZE = (3000.0, 3000.0, 6000.0)
MAX_VIS_PER_CHUNK = 10_000
NUM_PIXELS = 128
PIXEL_SIZE_ASEC = 30.0
REPO = Path(__file__).resolve().parent.parent


def _reorder(module, reader, outdir):
    return module.reorder_by_uvw_tile(
        reader, TILE_SIZE, outdir, num_time_intervals=4,
        max_vis_per_chunk=MAX_VIS_PER_CHUNK, max_workers=2,
    )


@pytest.fixture(scope="module")
def port_tiles(dataset_path, tmp_path_factory):
    return _reorder(tuvw, VisibilityReader(dataset_path),
                    tmp_path_factory.mktemp("port_tiles"))


@pytest.fixture(scope="module")
def jax_tiles(dataset_path, tmp_path_factory):
    return _reorder(juvw, JaxReader(dataset_path),
                    tmp_path_factory.mktemp("jax_tiles"))


@pytest.mark.parametrize("name", ["__init__.py", "tiling_plan.py", "tile.py",
                                  "reorder.py"])
def test_tiling_modules_are_verbatim_copies(name):
    ours = (REPO / "ska_sdp_cip_tpu_torch" / "uvw_tiling" / name).read_text()
    ref = (REPO / "ska_sdp_cip_tpu" / "uvw_tiling" / name).read_text()
    if name == "reorder.py":  # its own docstring, then the same bytes
        ours, ref = (text.split('"""', 2)[2] for text in (ours, ref))
    assert ours == ref


def test_tiles_equal_jax_tiles(port_tiles, jax_tiles):
    assert sorted(p.name for p in port_tiles) == sorted(
        p.name for p in jax_tiles
    )
    ref = {p.name: p for p in jax_tiles}
    for path in port_tiles:
        ours, want = np.load(path), np.load(ref[path.name])
        assert sorted(ours.files) == sorted(want.files), path.name
        for key in want.files:
            assert ours[key].dtype == want[key].dtype, (path.name, key)
            np.testing.assert_array_equal(ours[key], want[key],
                                          err_msg=f"{path.name}:{key}")


def test_reorder_conserves_visibilities(dataset_path, port_tiles):
    reader = VisibilityReader(dataset_path)
    paths = port_tiles
    assert paths and all(p.name.startswith("tile_iu") for p in paths)
    # Pass-1 interval files were deleted by pass 2
    assert not list(paths[0].parent.glob("*interval*.npz"))

    scale = reader.channel_frequencies() / SPEED_OF_LIGHT
    got_uvw, got_vis, got_wgt = [], [], []
    for path in paths:
        tile = Tile.load_npz(path)
        assert tile.num_visibilities <= MAX_VIS_PER_CHUNK
        lengths = tile.channel_stop_indices - tile.channel_start_indices
        rows = np.repeat(np.arange(tile.num_rows), lengths)
        chans = np.concatenate([
            np.arange(c0, c1) for c0, c1 in zip(tile.channel_start_indices,
                                                tile.channel_stop_indices)
        ])
        got_uvw.append(tile.uvw[rows] * scale[chans, None])
        got_vis.append(tile.visibilities)
        got_wgt.append(tile.weights)
    got_uvw = np.concatenate(got_uvw)

    gridder_input = StokesIGridderInput.from_reader(reader)
    expected_uvw = (
        reader.uvw()[:, None, :] * scale[None, :, None]
    ).reshape(-1, 3)
    assert len(got_uvw) == len(expected_uvw)

    def _sort(arr):
        return arr[np.lexsort(arr.T[::-1])]

    np.testing.assert_allclose(_sort(got_uvw), _sort(expected_uvw),
                               rtol=1e-12)
    np.testing.assert_allclose(
        np.sort(np.abs(np.concatenate(got_vis))),
        np.sort(np.abs(gridder_input.visibilities.ravel())), rtol=1e-5,
    )
    np.testing.assert_allclose(
        np.sort(np.concatenate(got_wgt)),
        np.sort(gridder_input.effective_weights().ravel().astype(np.float32)),
        rtol=1e-5,
    )


def test_multihost_reorder_striding(dataset_path, tmp_path, port_tiles):
    """Two hosts sharing a filesystem split intervals (pass 1) and tile
    groups (pass 2) by stride; together they write the single-host
    run's files."""
    from ska_sdp_cip_tpu_torch.uvw_tiling.reorder import (
        reorder_pass1,
        reorder_pass2,
    )

    reader = VisibilityReader(dataset_path)
    outdir = tmp_path / "tiles_mh"
    for host_index in range(2):
        reorder_pass1(reader, TILE_SIZE, outdir, num_time_intervals=4,
                      max_workers=2, num_hosts=2, host_index=host_index)
    paths = []
    for host_index in range(2):
        paths += reorder_pass2(outdir, max_vis_per_chunk=MAX_VIS_PER_CHUNK,
                               max_workers=2, num_hosts=2,
                               host_index=host_index)
    assert {p.name for p in paths} == {p.name for p in port_tiles}
    assert sum(Tile.load_npz(p).num_visibilities for p in paths) == sum(
        Tile.load_npz(p).num_visibilities for p in port_tiles
    )
    with pytest.raises(ValueError, match="barrier"):
        reorder_by_uvw_tile(reader, TILE_SIZE, tmp_path / "x", num_hosts=2)


def test_tile_npz_roundtrip(tmp_path):
    tile = Tile(
        coords=(1, -2, 0),
        uvw=np.arange(6, dtype=float).reshape(2, 3),
        visibilities=np.array([1 + 2j, 3 - 4j, 5j], np.complex64),
        channel_start_indices=np.array([0, 1]),
        channel_stop_indices=np.array([2, 2]),
        weights=np.array([1.0, 0.5, 2.0], np.float32),
    )
    path = tmp_path / "tile.npz"
    tile.save_npz(path)
    loaded = Tile.load_npz(path)
    assert loaded.coords == (1, -2, 0)
    np.testing.assert_array_equal(loaded.uvw, tile.uvw)
    np.testing.assert_array_equal(loaded.visibilities, tile.visibilities)
    np.testing.assert_array_equal(loaded.weights, tile.weights)
    assert ttiled._tile_chunk_num_vis(path) == 3


def test_reference_format_without_weights_loads(tmp_path):
    """Reference-written npz files (no weights) load with unit weights."""
    path = tmp_path / "ref_tile.npz"
    np.savez(
        path,
        coords=np.array([0, 0, 0]),
        uvw=np.zeros((1, 3)),
        visibilities=np.array([1 + 1j], np.complex64),
        channel_start_indices=np.array([0]),
        channel_stop_indices=np.array([1]),
    )
    tile = Tile.load_npz(path)
    np.testing.assert_array_equal(tile.weights, [1.0])


def test_every_sample_in_exactly_one_tile():
    uvw, _ = synthetic_uvw(4, 16, max_baseline_m=7000.0, seed=21)
    channel_freqs = np.linspace(856e6, 1712e6, 256)
    mapping = create_uvw_tile_mapping(uvw, TILE_SIZE, channel_freqs)
    coverage = np.zeros((len(uvw), len(channel_freqs)), dtype=int)
    for row_slices in mapping.values():
        for irow, c0, c1 in row_slices:
            coverage[irow, c0:c1] += 1
    assert (coverage == 1).all()
    assert mapping == juvw.create_uvw_tile_mapping(uvw, TILE_SIZE,
                                                   channel_freqs)


def test_runs_are_maximal():
    """Adjacent row slices of the same row map to different tiles."""
    uvw, _ = synthetic_uvw(2, 12, max_baseline_m=7000.0, seed=3)
    channel_freqs = np.linspace(856e6, 1712e6, 128)
    mapping = create_uvw_tile_mapping(uvw, TILE_SIZE, channel_freqs)
    runs_by_row = {}
    for coords, row_slices in mapping.items():
        for irow, c0, c1 in row_slices:
            runs_by_row.setdefault(irow, []).append((c0, c1, coords))
    for runs in runs_by_row.values():
        runs.sort()
        for (_, stop_a, coords_a), (start_b, _, coords_b) in zip(
            runs, runs[1:]
        ):
            assert stop_a == start_b
            assert coords_a != coords_b


def test_row_offset_and_merge():
    uvw, _ = synthetic_uvw(2, 8, max_baseline_m=5000.0, seed=5)
    channel_freqs = np.linspace(856e6, 1712e6, 64)
    half = len(uvw) // 2
    whole = create_uvw_tile_mapping(uvw, TILE_SIZE, channel_freqs)
    merged = merge_tile_mappings([
        create_uvw_tile_mapping(uvw[:half], TILE_SIZE, channel_freqs),
        create_uvw_tile_mapping(uvw[half:], TILE_SIZE, channel_freqs,
                                row_offset=half),
    ])
    assert set(whole) == set(merged)
    for coords in whole:
        assert sorted(whole[coords]) == sorted(merged[coords])


def _assert_reference_tolerance(got, want):
    """tests/uvw_tiling/test_tiled_invert.py's gate: atol 1e-4 of the
    max (its 1e-5 x 10), rtol 1e-3."""
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-5 * np.abs(want).max() * 10)


def test_tiled_invert_matches_direct(dataset_path, port_tiles):
    reader = VisibilityReader(dataset_path)
    tiled = ttiled.invert_tile_chunks(
        port_tiles, reader.channel_frequencies(), NUM_PIXELS,
        pixel_size_lm_from_asec(PIXEL_SIZE_ASEC), epsilon=1e-5, device="cpu",
    )
    direct = invert_dataset(reader, NUM_PIXELS, PIXEL_SIZE_ASEC,
                            epsilon=1e-5, device="cpu")
    assert tiled.shape == direct.shape == (NUM_PIXELS, NUM_PIXELS)
    assert tiled.dtype == np.float32
    _assert_reference_tolerance(tiled, direct)


def test_tiled_invert_matches_jax(dataset_path, port_tiles, jax_tiles):
    freqs = VisibilityReader(dataset_path).channel_frequencies()
    pixel = pixel_size_lm_from_asec(PIXEL_SIZE_ASEC)
    ours = ttiled.invert_tile_chunks(port_tiles, freqs, NUM_PIXELS, pixel,
                                     epsilon=1e-5, device="cpu")
    ref = jtiled.invert_tile_chunks(jax_tiles, freqs, NUM_PIXELS, pixel,
                                    epsilon=1e-5)
    _assert_reference_tolerance(ours, np.asarray(ref))
    for path in port_tiles[:3]:
        assert ttiled._tile_chunk_num_vis(path) == jtiled._tile_chunk_num_vis(
            path)
    samples = ttiled.load_tile_samples(port_tiles, freqs)
    for got, want in zip(samples, jtiled.load_tile_samples(jax_tiles, freqs)):
        assert got.shape == want.shape and got.dtype == want.dtype


@pytest.mark.parametrize("fft_mode", ["replicated", "distributed"])
def test_sharded_tiled_invert_waits_for_a9(port_tiles, dataset_path,
                                           fft_mode):
    """``sharded_invert_tile_chunks`` (A9, done) on 4 shards, and on more
    shards than chunk files (empty groups), equals
    ``invert_tile_chunks`` at the reference's tolerance (rtol 1e-5,
    atol 1e-5 of the max)."""
    from ska_sdp_cip_tpu_torch.parallel.mesh import make_device_mesh

    freqs = VisibilityReader(dataset_path).channel_frequencies()
    pixel = pixel_size_lm_from_asec(PIXEL_SIZE_ASEC)
    want = ttiled.invert_tile_chunks(port_tiles, freqs, NUM_PIXELS, pixel,
                                     device="cpu")
    # More shards than files (a power of two: the distributed mode needs
    # one dividing ngrid and npix): some shards hold no file.
    many = 1 << len(port_tiles).bit_length()
    groups = ttiled.balanced_groups(port_tiles, many)
    assert min(map(len, groups)) == 0
    for shards in (4, many):
        timings = {}
        got = ttiled.sharded_invert_tile_chunks(
            port_tiles, freqs, NUM_PIXELS, pixel, fft_mode=fft_mode,
            mesh=make_device_mesh(shards, device="cpu"), timings=timings,
            repeats=2,
        )
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        assert {"load_s", "plan_s", "stage_s", "compile_first_s",
                "execute_s"} <= set(timings)
    with pytest.raises(ValueError, match="No tile chunk"):
        ttiled.sharded_invert_tile_chunks([], freqs, 64, pixel,
                                          device="cpu")
    with pytest.raises(ValueError, match="No visibilities"):
        ttiled.invert_tile_chunks([], np.ones(1), 64, 1e-5, device="cpu")
