"""
Tile container and on-disk npz chunk format.

Stores the jagged per-tile visibility data produced by the UVW
re-ordering stage (reference: src/ska_sdp_cip/uvw_tiling/tile.py).
File layout and naming are compatible with the reference's npz tiles,
with one deliberate fix: tiles here also carry **weights**, because the
reference's tiles store only Stokes-I visibilities and therefore cannot
feed a properly weighted invert (SURVEY.md quirk Q3; reference:
tile.py:20-24, reorder.py:143-154). Weight-less reference files load
fine (weights default to ones).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Sequence, Union

import numpy as np
from numpy.typing import NDArray

from .tiling_plan import RowSliceId, TileCoords


@dataclass(repr=False)
class Tile:
    """
    Jagged visibility storage for one UVW tile: per row slice a uvw
    row and a [chan_start, chan_stop) channel run; visibilities (and
    weights) are stored flat in row-slice order.
    """

    coords: TileCoords
    uvw: NDArray
    visibilities: NDArray
    channel_start_indices: NDArray
    channel_stop_indices: NDArray
    weights: NDArray = field(default=None)

    def __post_init__(self) -> None:
        if self.weights is None:
            self.weights = np.ones(
                len(self.visibilities), dtype=np.float32
            )

    @property
    def num_rows(self) -> int:
        """Number of row slices stored."""
        return len(self.uvw)

    @property
    def num_visibilities(self) -> int:
        """Total number of visibility samples stored."""
        return len(self.visibilities)

    def save_npz(self, path: Union[str, os.PathLike]) -> None:
        """
        Save in the reference-compatible npz layout
        (reference: tile.py:40-51), plus the weights column.
        """
        np.savez(
            path,
            coords=np.asarray(self.coords, dtype=int),
            uvw=self.uvw,
            visibilities=self.visibilities,
            channel_start_indices=self.channel_start_indices,
            channel_stop_indices=self.channel_stop_indices,
            weights=self.weights,
        )

    @classmethod
    def load_npz(cls, path: Union[str, os.PathLike]) -> "Tile":
        """
        Load from npz; reference-written files (without weights) get
        unit weights.
        """
        npz = np.load(path)
        weights = (
            npz["weights"] if "weights" in npz.files else None
        )
        return cls(
            coords=tuple(int(c) for c in npz["coords"]),
            uvw=npz["uvw"],
            visibilities=npz["visibilities"],
            channel_start_indices=npz["channel_start_indices"],
            channel_stop_indices=npz["channel_stop_indices"],
            weights=weights,
        )

    @classmethod
    def from_visibility_block(
        cls,
        visibilities: NDArray,
        weights: NDArray,
        uvw: NDArray,
        coords: TileCoords,
        row_slices: Sequence[RowSliceId],
    ) -> "Tile":
        """
        Extract the given row slices from (row, chan) visibility and
        weight blocks into one tile (the vectorized equivalent of the
        reference's per-slice copy loop, tile.py:83-115).
        """
        starts = np.fromiter(
            (s.chan_start for s in row_slices), dtype=np.int64
        )
        stops = np.fromiter(
            (s.chan_stop for s in row_slices), dtype=np.int64
        )
        rows = np.fromiter((s.irow for s in row_slices), dtype=np.int64)
        lengths = stops - starts

        # Flat (row, chan) gather indices for all slices at once
        offsets = np.concatenate(([0], np.cumsum(lengths)[:-1]))
        total = int(lengths.sum())
        positions = np.arange(total)
        slice_of_pos = np.repeat(np.arange(len(rows)), lengths)
        chan_idx = starts[slice_of_pos] + (
            positions - offsets[slice_of_pos]
        )
        row_idx = rows[slice_of_pos]

        num_chans = visibilities.shape[1]
        flat_idx = row_idx * num_chans + chan_idx
        return cls(
            coords=coords,
            uvw=np.asarray(uvw, dtype=float)[rows],
            visibilities=np.asarray(visibilities).reshape(-1)[flat_idx],
            channel_start_indices=starts,
            channel_stop_indices=stops,
            weights=np.asarray(weights, np.float32).reshape(-1)[flat_idx],
        )

    def __str__(self) -> str:
        return (
            f"Tile(coords={self.coords}, nrows={self.num_rows}, "
            f"nvis={self.num_visibilities})"
        )

    def __repr__(self) -> str:
        return str(self)


def concatenate_tiles(tiles: Sequence[Tile]) -> Tile:
    """Concatenate same-coordinate tiles (reference: tile.py:127-152)."""
    if not tiles:
        raise ValueError("Cannot concatenate empty sequence of tiles")
    coords = tiles[0].coords
    if any(tile.coords != coords for tile in tiles):
        raise ValueError("Cannot merge tiles with different coordinates")

    return Tile(
        coords=coords,
        uvw=np.concatenate([t.uvw for t in tiles]),
        visibilities=np.concatenate([t.visibilities for t in tiles]),
        channel_start_indices=np.concatenate(
            [t.channel_start_indices for t in tiles]
        ),
        channel_stop_indices=np.concatenate(
            [t.channel_stop_indices for t in tiles]
        ),
        weights=np.concatenate([t.weights for t in tiles]),
    )


def split_tile(tile: Tile, max_vis_per_chunk: int) -> list:
    """
    Split into chunks of at most ``max_vis_per_chunk`` visibilities,
    never splitting a row slice (reference: tile.py:155-211).
    """
    lengths = (
        tile.channel_stop_indices - tile.channel_start_indices
    ).astype(np.int64)
    vis_offsets = np.concatenate(([0], np.cumsum(lengths)))

    chunks: list[Tile] = []
    row_start = 0
    chunk_vis_start = 0
    chunk_vis = 0
    for row, size in enumerate(lengths):
        if chunk_vis + size > max_vis_per_chunk and row > row_start:
            chunks.append(_tile_slice(tile, row_start, row, vis_offsets))
            row_start = row
            chunk_vis_start += chunk_vis
            chunk_vis = 0
        chunk_vis += int(size)
    if row_start < tile.num_rows or not chunks:
        chunks.append(
            _tile_slice(tile, row_start, tile.num_rows, vis_offsets)
        )
    return chunks


def _tile_slice(tile: Tile, r0: int, r1: int, vis_offsets) -> Tile:
    v0, v1 = int(vis_offsets[r0]), int(vis_offsets[r1])
    return Tile(
        coords=tile.coords,
        uvw=tile.uvw[r0:r1],
        visibilities=tile.visibilities[v0:v1],
        channel_start_indices=tile.channel_start_indices[r0:r1],
        channel_stop_indices=tile.channel_stop_indices[r0:r1],
        weights=tile.weights[v0:v1],
    )


def iter_rechunked_tiles(
    tile_paths: Iterable[Path], max_vis_per_chunk: int
) -> Iterable[Tile]:
    """
    Lazily yield tiles of at most ``max_vis_per_chunk`` visibilities
    covering the concatenation of same-coordinate tile files, splitting
    only at row-slice boundaries. Memory stays bounded by roughly one
    chunk plus one input file; trailing data is merged into a final
    (possibly short) tile.
    """
    held: list[Tile] = []
    held_vis = 0
    for path in tile_paths:
        tile = Tile.load_npz(path)
        held.append(tile)
        held_vis += tile.num_visibilities
        if held_vis <= max_vis_per_chunk:
            continue
        merged = concatenate_tiles(held) if len(held) > 1 else held[0]
        pieces = split_tile(merged, max_vis_per_chunk)
        yield from pieces[:-1]
        held = [pieces[-1]]
        held_vis = pieces[-1].num_visibilities
    if held:
        merged = concatenate_tiles(held) if len(held) > 1 else held[0]
        if merged.num_visibilities:
            yield merged


def rechunk_tiles_on_disk(
    tile_paths: Iterable[Path],
    outdir: Path,
    basename: str,
    *,
    max_vis_per_chunk: int = 5_000_000,
) -> list:
    """
    Write the re-chunked stream of :func:`iter_rechunked_tiles` to
    ``{basename}_chunk{NNN:03d}.npz`` files — the reference's tile
    chunk naming (reference: reorder.py:186-192).
    """
    paths = []
    chunks = iter_rechunked_tiles(tile_paths, max_vis_per_chunk)
    for index, chunk in enumerate(chunks):
        path = outdir / f"{basename}_chunk{index:03d}.npz"
        chunk.save_npz(path)
        paths.append(path)
    return paths
