"""
UVW tile re-ordering: a dataset converted to Stokes I (weights kept)
and re-ordered into per-tile npz chunk files, the layout the tiled
invert reads.

Counterpart: ``ska_sdp_cip_tpu/uvw_tiling/reorder.py``, copied below
this docstring byte for byte onto the port's reader and
``StokesIGridderInput``: two passes over a pool of spawned worker
processes (host work), each host of a multi-host run taking its stride
of time intervals (pass 1) and of tile groups (pass 2) over a shared
filesystem.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Optional


def _pool(max_workers: Optional[int]) -> ProcessPoolExecutor:
    """
    Process pool with the *spawn* start method: the default fork is
    unsafe after JAX initialization (multithreaded parent) and emits
    deadlock warnings; spawn children re-import cleanly.
    """
    return ProcessPoolExecutor(
        max_workers=max_workers,
        mp_context=multiprocessing.get_context("spawn"),
    )

from ..io.visibility_dataset import VisibilityReader
from .tile import Tile, rechunk_tiles_on_disk
from .tiling_plan import TileCoords, TileMapping, create_uvw_tile_mapping


def reorder_by_uvw_tile(
    reader: VisibilityReader,
    tile_size: tuple,
    outdir: Path,
    *,
    num_time_intervals: Optional[int] = None,
    max_vis_per_chunk: int = 5_000_000,
    max_workers: Optional[int] = None,
    num_hosts: int = 1,
    host_index: int = 0,
) -> list:
    """
    Re-order a dataset into UVW tile chunks.

    Pass 1: partition rows into time intervals (rows are time-ordered,
    reference: reorder.py:54-67); per interval, bin samples to tiles
    and write one npz per (tile, interval) named
    ``tile_iu±NN_iv±NN_iw±NN_intervalNN.npz``.
    Pass 2: per tile coordinate, rechunk the interval files into
    ``<= max_vis_per_chunk`` chunks and delete the inputs
    (reference: reorder.py:96-111,158-183).

    For single-host runs this performs both passes. Multi-host runs
    over a shared filesystem must call :func:`reorder_pass1` on every
    host, barrier, then :func:`reorder_pass2` — pass 2 can only start
    once every host's interval files exist (the reference has the same
    barrier at reorder.py:87-90). Calling this function with
    ``num_hosts > 1`` raises to prevent silent data loss.

    Returns the list of written chunk paths (this host's share).
    """
    if num_hosts != 1:
        raise ValueError(
            "Multi-host reorder requires an inter-pass barrier: call "
            "reorder_pass1 on every host, barrier, then reorder_pass2"
        )
    reorder_pass1(
        reader,
        tile_size,
        outdir,
        num_time_intervals=num_time_intervals,
        max_workers=max_workers,
    )
    return reorder_pass2(
        outdir,
        max_vis_per_chunk=max_vis_per_chunk,
        max_workers=max_workers,
    )


def reorder_pass1(
    reader: VisibilityReader,
    tile_size: tuple,
    outdir: Path,
    *,
    num_time_intervals: Optional[int] = None,
    max_workers: Optional[int] = None,
    num_hosts: int = 1,
    host_index: int = 0,
) -> list:
    """
    Pass 1 only: write per-(tile, interval) npz files for this host's
    stride of time intervals. Returns the tile coordinates this host
    touched.
    """
    if num_time_intervals is None:
        if num_hosts > 1:
            # Must be identical on every host or the per-host interval
            # stride stops being a partition of the rows; derive from
            # dataset properties only (never local core counts).
            num_time_intervals = max(2 * num_hosts, 2)
        else:
            num_time_intervals = max(
                2 * (max_workers or os.cpu_count()), 2
            )
    num_time_intervals = min(num_time_intervals, reader.num_data_rows)

    outdir = Path(outdir).resolve()
    outdir.mkdir(parents=True, exist_ok=True)

    intervals = reader.partition(num_time_intervals, 1)
    my_intervals = [
        (index, chunk)
        for index, chunk in enumerate(intervals)
        if index % num_hosts == host_index
    ]

    tile_coords_set: set[TileCoords] = set()
    with _pool(max_workers) as pool:
        for coords_list in pool.map(
            _reorder_interval_task,
            [
                (index, chunk, tile_size, outdir)
                for index, chunk in my_intervals
            ],
        ):
            tile_coords_set.update(coords_list)
    return sorted(tile_coords_set)


def reorder_pass2(
    outdir: Path,
    *,
    max_vis_per_chunk: int = 5_000_000,
    max_workers: Optional[int] = None,
    num_hosts: int = 1,
    host_index: int = 0,
) -> list:
    """
    Pass 2 only: discover tile coordinates from the interval files ON
    DISK (so every host's pass-1 output is covered regardless of which
    host binned it), take this host's stride of tile groups, and
    rechunk them. Must run after every host finished pass 1.
    """
    outdir = Path(outdir).resolve()
    coords_set = set()
    for path in outdir.glob("tile_iu*_interval*.npz"):
        parts = path.name.split("_")
        coords_set.add(
            (
                int(parts[1][2:]),
                int(parts[2][2:]),
                int(parts[3][2:]),
            )
        )
    # Stride on a stable value hash (not list position): hosts may
    # observe different residual file sets while others' pass-2
    # deletions are in flight, but a coordinate always maps to the
    # same host.
    def _owner(coords) -> int:
        iu, iv, iw = coords
        return (
            iu * 73856093 ^ iv * 19349663 ^ iw * 83492791
        ) % num_hosts

    my_tiles = sorted(
        coords
        for coords in coords_set
        if _owner(coords) == host_index
    )
    with _pool(max_workers) as pool:
        output_lists = pool.map(
            _rechunk_task,
            [
                (coords, outdir, max_vis_per_chunk)
                for coords in my_tiles
            ],
        )
        return [path for paths in output_lists for path in paths]


def create_time_interval_tile_mapping(
    reader: VisibilityReader,
    tile_size: tuple,
    channel_freqs,
) -> TileMapping:
    """
    Tile mapping for one time interval
    (reference: reorder.py:114-126).
    """
    return create_uvw_tile_mapping(reader.uvw(), tile_size, channel_freqs)


def reorder_time_interval(
    reader: VisibilityReader,
    tile_mapping: TileMapping,
    outdir: Path,
    *,
    interval_index: int,
) -> list:
    """
    Write one npz tile file per mapping entry for this interval,
    converting to Stokes I and carrying effective weights
    (reference: reorder.py:129-155, with the Q3 weights fix).
    Returns the tile coordinates present.
    """
    from ..invert import StokesIGridderInput

    gridder_input = StokesIGridderInput.from_reader(reader)
    vis = gridder_input.visibilities
    weights = gridder_input.effective_weights()
    uvw = gridder_input.uvw

    for coords, row_slices in tile_mapping.items():
        tile = Tile.from_visibility_block(
            vis, weights, uvw, coords, row_slices
        )
        tile.save_npz(outdir / _tile_filename(coords, interval_index))
    return list(tile_mapping.keys())


def rechunk_tile_chunk_group(
    tile_coords: TileCoords,
    outdir: Path,
    *,
    max_vis_per_chunk: int = 5_000_000,
) -> list:
    """
    Rechunk all interval files of one tile coordinate
    (reference: reorder.py:158-183). Deletes the inputs.
    """
    iu, iv, iw = tile_coords
    pattern = f"tile_iu{iu:+03d}_iv{iv:+03d}_iw{iw:+03d}_interval*.npz"
    input_paths = sorted(outdir.glob(pattern))
    basename = f"tile_iu{iu:+03d}_iv{iv:+03d}_iw{iw:+03d}"
    output_paths = rechunk_tiles_on_disk(
        input_paths, outdir, basename, max_vis_per_chunk=max_vis_per_chunk
    )
    for path in input_paths:
        path.unlink()
    return output_paths


def _tile_filename(tile_coords: TileCoords, interval_index: int) -> str:
    """Reference-compatible file naming (reference: reorder.py:186-192)."""
    iu, iv, iw = tile_coords
    return (
        f"tile_iu{iu:+03d}_iv{iv:+03d}_iw{iw:+03d}_"
        f"interval{interval_index:02d}.npz"
    )


# -- process pool task wrappers (picklable top-level functions) --------


def _reorder_interval_task(args) -> list:
    index, chunk, tile_size, outdir = args
    mapping = create_time_interval_tile_mapping(
        chunk, tile_size, chunk.channel_frequencies()
    )
    return reorder_time_interval(
        chunk, mapping, outdir, interval_index=index
    )


def _rechunk_task(args) -> list:
    coords, outdir, max_vis_per_chunk = args
    return rechunk_tile_chunk_group(
        coords, outdir, max_vis_per_chunk=max_vis_per_chunk
    )
