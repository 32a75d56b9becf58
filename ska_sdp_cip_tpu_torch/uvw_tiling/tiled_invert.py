"""
Invert directly from the UVW tile store.

Counterpart: ``ska_sdp_cip_tpu/uvw_tiling/tiled_invert.py``
(``load_tile_samples``, ``invert_tile_chunks``, ``_tile_chunk_num_vis``,
``_scaled_tile_samples``, copied onto the port's gridder, and
``sharded_invert_tile_chunks`` on the mesh of ``parallel/mesh.py``).
Tile chunk files (which carry Stokes-I visibilities, weights and uvw;
see ``tile.py``) are loaded and gridded without touching the original
dataset: one plan over every stored sample (uvw pre-scaled to one
reference frequency), the samples staged into slot order on the host
(the native engine's ``stage_slot_vis`` where it is available), then
the slot-input invert on ``device`` (B1 and B2 on a CUDA card).
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


def _scaled_tile_samples(paths: Sequence[Path], channel_frequencies,
                         ref_freq: float) -> tuple:
    """(uvw scaled to ref_freq, vis, weights) for a group of chunks."""
    if not paths:
        return (
            np.zeros((0, 3)),
            np.zeros(0, np.complex64),
            np.zeros(0, np.float32),
        )
    uvw, freq_per_sample, vis, weights = load_tile_samples(
        paths, channel_frequencies
    )
    return uvw * (freq_per_sample / ref_freq)[:, None], vis, weights


def balanced_groups(paths: Sequence[Path], num_groups: int) -> list:
    """
    Chunk files in ``num_groups`` groups of about equal size on disk:
    greedy, largest file first onto the lightest group (counterpart's
    grouping), the same on every rank.
    """
    groups = [[] for _ in range(num_groups)]
    loads = [0] * num_groups
    for path in sorted(paths, key=lambda p: p.stat().st_size, reverse=True):
        index = loads.index(min(loads))
        groups[index].append(path)
        loads[index] += path.stat().st_size
    return groups


def sharded_invert_tile_chunks(
    paths: Sequence[Path],
    channel_frequencies: np.ndarray,
    num_pixels: int,
    pixel_size_lm: float,
    *,
    mesh=None,
    device=None,
    epsilon: float = 1e-4,
    do_wstacking: bool = True,
    fft_mode: str = "replicated",
    timings: dict | None = None,
    repeats: int = 1,
) -> np.ndarray:
    """
    Distributed invert straight from the tile store, on ``mesh.device``
    (or a one-shard-per-rank mesh on ``device``): chunk files are
    balanced over the shards by size on disk (:func:`balanced_groups`),
    each rank loads and plans only its own shards' groups (a group may
    be empty), and the partial images are summed over the mesh
    (``parallel/sharded_invert.py``). ``fft_mode="distributed"`` plans
    every shard on the global w range and splits the plane transforms
    over the shards. Equal to :func:`invert_tile_chunks` at gridder
    accuracy.

    ``timings`` (a dict) receives the seconds of each stage (``load_s``,
    ``prewarm_s``, ``plan_s``, ``stage_s``, the first invert
    ``compile_first_s`` — the counterpart's key; nothing compiles here —
    and with ``repeats > 1`` the best later invert, ``execute_s``).
    """
    import time

    from ..ops.plan import auto_block_and_group, prewarm_plan_arenas, w_range
    from ..parallel.sharded_invert import (
        FFT_MODES,
        global_w_range,
        resolve_mesh,
        sharded_invert_staged,
        stage_planned_shards,
    )

    if fft_mode not in FFT_MODES:
        raise ValueError(f"unknown fft_mode {fft_mode!r}")
    mesh = resolve_mesh(mesh, device)
    paths = sorted(Path(p) for p in paths)
    if not paths:
        raise ValueError("No tile chunk files given")
    groups = balanced_groups(paths, mesh.num_shards)
    ref_freq = float(np.max(np.asarray(channel_frequencies)))
    # The shards agree on the block size and w-bin grouping, from the
    # mean per-shard load.
    total_vis = sum(_tile_chunk_num_vis(path) for path in paths)
    block, bin_group = auto_block_and_group(total_vis // mesh.num_shards)
    local_ids = mesh.addressable_shard_indices
    if timings is None:
        timings = {}

    t0 = time.perf_counter()
    scaled = {
        index: _scaled_tile_samples(groups[index], channel_frequencies,
                                    ref_freq)
        for index in local_ids
    }
    global_w = None
    if fft_mode == "distributed":
        # The distributed FFT sums plane grids across shards, and tiles
        # have disjoint |w| ranges: every shard plans the global grid.
        ref = np.array([ref_freq])
        global_w = global_w_range(mesh, (w_range(s[0], ref)
                                         for s in scaled.values()))
    timings["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prewarm_plan_arenas(max(len(scaled[i][0]) for i in local_ids))
    timings["prewarm_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plans, samples = {}, {}
    for index in local_ids:
        uvw_scaled, vis, weights = scaled[index]
        plans[index] = make_plan(
            uvw_scaled, np.array([ref_freq]), num_pixels, pixel_size_lm,
            epsilon=epsilon, do_wstacking=do_wstacking, block=block,
            bin_group=bin_group, w_range=global_w,
        )
        samples[index] = (vis, weights)
    timings["plan_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    staging = stage_planned_shards(mesh, plans, samples, slot_mode=True)
    timings["stage_s"] = time.perf_counter() - t0
    weighted = staging.weighted()

    def run():
        return device_get(sharded_invert_staged(staging, *weighted,
                                                fft_mode=fft_mode))

    t0 = time.perf_counter()
    image = run() / staging.total_weight
    timings["compile_first_s"] = time.perf_counter() - t0
    best = None
    for _ in range(max(repeats - 1, 0)):
        t0 = time.perf_counter()
        run()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    if best is not None:
        timings["execute_s"] = best
    return image
