"""
Invert directly from the UVW tile store.

Counterpart: ``ska_sdp_cip_tpu/uvw_tiling/tiled_invert.py``
(``load_tile_samples``, ``invert_tile_chunks``, ``_tile_chunk_num_vis``,
copied onto the port's gridder). Tile chunk files (which carry Stokes-I
visibilities, weights and uvw; see ``tile.py``) are loaded and gridded
without touching the original dataset: one plan over every stored
sample (uvw pre-scaled to one reference frequency), the samples staged
into slot order on the host (the native engine's ``stage_slot_vis``
where it is available), then the slot-input invert on ``device`` (B1
and B2 on a CUDA card).

``sharded_invert_tile_chunks`` waits for the port's multi-device path
(ROADMAP.md, A9) and raises ``NotImplementedError``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from ..ops.gridder import (
    build_invert,
    packed_rows,
    plan_host_arrays,
    resolve_device,
    stage_arrays,
    stage_slot_vis,
)
from ..ops.plan import make_plan
from ..utils.staging import device_get
from .tile import Tile


def load_tile_samples(
    paths: Iterable[Path],
    channel_frequencies: np.ndarray,
) -> tuple:
    """
    Flatten tile chunk files into per-sample arrays
    ``(uvw_m, freq_per_sample, vis, weights)``: one entry per stored
    visibility, with uvw in meters and the per-sample channel frequency
    resolved from the stored channel indices.
    """
    freqs = np.asarray(channel_frequencies, dtype=np.float64)
    uvw_list, freq_list, vis_list, wgt_list = [], [], [], []
    for path in paths:
        tile = Tile.load_npz(path)
        lengths = (
            tile.channel_stop_indices - tile.channel_start_indices
        ).astype(np.int64)
        total = int(lengths.sum())
        if total == 0:
            continue
        slice_idx = np.repeat(np.arange(tile.num_rows), lengths)
        offsets = np.concatenate(([0], np.cumsum(lengths)[:-1]))
        within = np.arange(total) - offsets[slice_idx]
        chan_idx = tile.channel_start_indices[slice_idx] + within

        uvw_list.append(tile.uvw[slice_idx])
        freq_list.append(freqs[chan_idx])
        vis_list.append(tile.visibilities)
        wgt_list.append(tile.weights)

    if not uvw_list:
        raise ValueError("No visibilities found in tile chunks")
    return (
        np.concatenate(uvw_list),
        np.concatenate(freq_list),
        np.concatenate(vis_list),
        np.concatenate(wgt_list),
    )


def invert_tile_chunks(
    paths: Sequence[Path],
    channel_frequencies: np.ndarray,
    num_pixels: int,
    pixel_size_lm: float,
    *,
    epsilon: float = 1e-4,
    do_wstacking: bool = True,
    device,
) -> np.ndarray:
    """
    Normalized Stokes-I dirty image from tile chunk files, on
    ``device``. Numerically equivalent (to gridder accuracy) to
    inverting the original dataset, since tiles carry exact uvw,
    visibilities, and weights.
    """
    device = resolve_device(device)
    uvw, freq_per_sample, vis, weights = load_tile_samples(
        paths, channel_frequencies
    )

    # Per-sample frequencies: feed the planner one sample per "row"
    # with a single pseudo-channel by pre-scaling uvw to a common
    # reference frequency.
    ref_freq = float(np.max(freq_per_sample))
    uvw_scaled = uvw * (freq_per_sample / ref_freq)[:, None]

    plan = make_plan(
        uvw_scaled,
        np.array([ref_freq]),
        num_pixels,
        pixel_size_lm,
        epsilon=epsilon,
        do_wstacking=do_wstacking,
    )
    weighted = vis.astype(np.complex64) * weights.astype(np.float32)
    host = plan_host_arrays(plan, device)
    host["packed"] = packed_rows(plan)
    host["re"], host["im"] = stage_slot_vis(
        plan, weighted.real.ravel(), weighted.imag.ravel()
    )
    arrays = stage_arrays(host, device)
    image = build_invert(plan)(arrays, arrays.pop("re"), arrays.pop("im"))
    return device_get(image) / float(weights.sum())


def _tile_chunk_num_vis(path: Path) -> int:
    """
    Exact stored-visibility count of a tile chunk file, read from the
    npy header of the ``visibilities`` zip member alone — no array data
    is decompressed or loaded.
    """
    import zipfile

    with zipfile.ZipFile(path) as archive:
        with archive.open("visibilities.npy") as member:
            version = np.lib.format.read_magic(member)
            if version >= (2, 0):
                header = np.lib.format.read_array_header_2_0
            else:
                header = np.lib.format.read_array_header_1_0
            shape, _, _ = header(member)
    return int(np.prod(shape))


def sharded_invert_tile_chunks(*args, **kwargs) -> np.ndarray:
    """The tile store's distributed invert: still to be ported."""
    raise NotImplementedError(
        "sharded_invert_tile_chunks needs the port's multi-device path "
        "(ROADMAP.md, A9); use invert_tile_chunks on one device"
    )
