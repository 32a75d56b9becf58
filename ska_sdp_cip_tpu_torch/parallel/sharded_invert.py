"""
Sharded invert: the multi-device replacement of the reference's
dask-distributed invert (reference: src/ska_sdp_cip/invert.py:212-270).

Counterpart: ``ska_sdp_cip_tpu/parallel/sharded_invert.py``
(``shard_chunk_counts``, copied; ``ShardedStaging``,
``stage_sharded_inputs``, ``stage_planned_shards`` and
``sharded_invert_dataset`` on a mesh of ``parallel/mesh.py``). Here
``stage_sharded_inputs`` is split after its load:
:func:`stage_loaded_shards` weights, plans and stages shards already in
memory, given the global visibility count.

The dataset is partitioned into (row_chunks x freq_chunks) shards with
the reference's balanced-chunk semantics; a rank loads, weights, plans
and stages only its own shards, and the ranks agree through small host
allgathers (plan shape maxima, w range, weight density, total weight).
Each shard runs the gridder eagerly on the rank's device. The images
are summed over the mesh (``fft_mode="replicated"``: every shard runs
the full plane transforms) or the plane grids are, with the transforms
split over the shards (``"distributed"``: ``ops/gridder.py``'s
distributed mode). The image is normalised by the global weight after
the reduction.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from ..invert import StokesIGridderInput, pixel_size_lm_from_asec
from ..io.visibility_dataset import VisibilityReader
from ..ops.gridder import (
    build_invert,
    slot_duplicate_pairs,
    slot_plan_host_arrays,
    stage_arrays,
    stage_slot_vis,
    stage_slot_weights,
)
from ..ops.plan import (
    auto_block_and_group,
    make_plan,
    nm1_min_of,
    pad_plans_uniform,
    plan_shape_maxima,
    resolve_sigma,
    w_range,
)
from ..utils.staging import device_get
from .mesh import DeviceMesh, make_device_mesh

#: The staged keys the slot-input invert never reads (the data-order
#: transform): dropped in ``slot_mode``.
ORDER_KEYS = ("order", "flip_sign", "phase_cos", "phase_sin")

FFT_MODES = ("replicated", "distributed")


def shard_chunk_counts(
    num_devices: int, num_channels: int, row_chunks, freq_chunks
) -> tuple[int, int]:
    """
    Resolve (row_chunks, freq_chunks) so their product equals the mesh
    size (counterpart copy). Mirrors the reference's defaults —
    row_chunks=1 and one frequency chunk per worker, capped by the
    channel count (reference: invert.py:248-252 as intended; see
    SURVEY.md Q1/Q2) — then fills the remainder onto the row axis.
    """
    if freq_chunks is None:
        freq_chunks = min(num_channels, num_devices)
    if row_chunks is None:
        if num_devices % freq_chunks:
            raise ValueError(
                f"num_devices={num_devices} not divisible by "
                f"freq_chunks={freq_chunks}; pass explicit chunk counts"
            )
        row_chunks = num_devices // freq_chunks
    if row_chunks * freq_chunks != num_devices:
        raise ValueError(
            "row_chunks * freq_chunks must equal the number of mesh "
            f"devices ({row_chunks} * {freq_chunks} != {num_devices})"
        )
    return row_chunks, freq_chunks


@dataclass
class ShardedStaging:
    """
    This rank's staged shards, in the order of
    ``mesh.addressable_shard_indices``: the padded ``plans``, their
    staged ``arrays`` (``slot_plan_host_arrays``), the slot-order
    unweighted visibilities ``vis_re``/``vis_im`` and slot ``weights``
    (``stage_slot_vis`` / ``stage_slot_weights``), and the straddler
    pairs ``dup_a``/``dup_b`` (``slot_duplicate_pairs``), one tensor
    per shard each, on ``mesh.device``; and the global ``total_weight``.
    """

    mesh: DeviceMesh
    plans: list
    arrays: list = field(repr=False)
    vis_re: list = field(repr=False)
    vis_im: list = field(repr=False)
    weights: list = field(repr=False)
    total_weight: float
    dup_a: list = field(repr=False, default=None)
    dup_b: list = field(repr=False, default=None)

    def weighted(self) -> tuple:
        """Per shard, the weighted slot visibilities (re list, im list)."""
        return ([re * w for re, w in zip(self.vis_re, self.weights)],
                [im * w for im, w in zip(self.vis_im, self.weights)])


def resolve_mesh(mesh, device) -> DeviceMesh:
    """``mesh``, or one shard per rank on ``device``; one of the two
    must be given."""
    if mesh is not None:
        return mesh
    if device is None:
        raise ValueError("pass a mesh (parallel.make_device_mesh) or a "
                         "device")
    return make_device_mesh(device=device)


def global_w_range(mesh: DeviceMesh, local_ranges) -> tuple:
    """The (min, max) |w| over every shard of the mesh from this rank's
    shards' ``(min, max)`` pairs (two host allgathers). A rank without
    samples contributes nothing."""
    local_ranges = list(local_ranges)
    hi = max((r[1] for r in local_ranges), default=0.0)
    global_hi = float(mesh.allgather_max(np.asarray([hi]))[0])
    lo = min((r[0] for r in local_ranges), default=global_hi)
    global_lo = -float(mesh.allgather_max(np.asarray([-lo]))[0])
    return global_lo, global_hi


def stage_sharded_inputs(
    reader: VisibilityReader,
    num_pixels: int,
    pixel_size_asec: float,
    *,
    mesh: DeviceMesh | None = None,
    device=None,
    row_chunks: int | None = None,
    freq_chunks: int | None = None,
    epsilon: float = 1e-4,
    do_wstacking: bool = True,
    weighting: str = "natural",
    robust: float = 0.0,
    step=None,
    sigma: float | str = 2.0,
    common_w_grid: bool = False,
    slot_mode: bool = False,
) -> ShardedStaging:
    """
    Partition and load a dataset on the mesh, then weight, plan and
    stage this rank's shards (:func:`stage_loaded_shards`): the front
    half of every sharded operation (invert, major cycle). ``step`` is
    an optional ``name -> context manager`` (``TaskRecorder.step``).

    ``sigma="auto"`` resolves one oversampling factor for the whole
    mesh (global visibility count and allgathered w range), since every
    shard must plan the same grid. ``common_w_grid=True`` plans every
    shard on the global w range, which the distributed FFT mode needs:
    it sums plane grids across shards, so plane p must mean the same w
    everywhere.
    """
    if step is None:
        step = lambda name: nullcontext()  # noqa: E731
    mesh = resolve_mesh(mesh, device)
    row_chunks, freq_chunks = shard_chunk_counts(
        mesh.num_shards, reader.num_channels, row_chunks, freq_chunks
    )
    chunk_readers = reader.partition(row_chunks, freq_chunks)

    with step("load_shards"):
        shards = {
            index: StokesIGridderInput.from_reader(chunk_readers[index])
            for index in mesh.addressable_shard_indices
        }
    return stage_loaded_shards(
        shards, reader.num_data_rows * reader.num_channels, num_pixels,
        pixel_size_asec, mesh=mesh, epsilon=epsilon,
        do_wstacking=do_wstacking, weighting=weighting, robust=robust,
        step=step, sigma=sigma, common_w_grid=common_w_grid,
        slot_mode=slot_mode,
    )


def stage_loaded_shards(
    shards: dict,
    num_visibilities: int,
    num_pixels: int,
    pixel_size_asec: float,
    *,
    mesh: DeviceMesh,
    epsilon: float = 1e-4,
    do_wstacking: bool = True,
    weighting: str = "natural",
    robust: float = 0.0,
    step=None,
    sigma: float | str = 2.0,
    common_w_grid: bool = False,
    slot_mode: bool = False,
) -> ShardedStaging:
    """
    Weight, plan and stage this rank's loaded shards: ``shards`` maps
    each of ``mesh.addressable_shard_indices`` to its
    ``StokesIGridderInput`` (from a reader's partition, or made in
    memory), and ``num_visibilities`` is the count over every shard of
    the mesh (rows x channels of the whole dataset). The rest of
    :func:`stage_sharded_inputs`, with its arguments: a weighting other
    than ``"natural"`` from the global density (step
    ``weight_shards``), the block size and w-bin grouping from the
    global count over the shard count, sigma and the w range from the
    global count and the allgathered w range (``plan_shards``), then
    padding and staging (``stage_shards``).
    """
    if step is None:
        step = lambda name: nullcontext()  # noqa: E731
    pixel_size_lm = pixel_size_lm_from_asec(pixel_size_asec)

    if weighting != "natural":
        with step("weight_shards"):
            # Global density from per-shard histograms and one sum, so
            # the shards see the weights of a single-device run.
            from ..models.weighting import ImagingWeighter

            weighter = ImagingWeighter(num_pixels, pixel_size_lm,
                                       scheme=weighting, robust=robust)
            density = np.zeros((num_pixels, num_pixels))
            for shard in shards.values():
                density = weighter.accumulate_density(
                    shard.uvw, shard.channel_frequencies,
                    shard.effective_weights(), density,
                )
            weighter.finalize(mesh.allgather_sum(density))
            for shard in shards.values():
                shard.weights = weighter.apply(
                    shard.uvw, shard.channel_frequencies,
                    shard.effective_weights(),
                )
                shard.flags = np.zeros_like(shard.flags)

    with step("plan_shards"):
        # The shards agree on block size and w-bin grouping, from the
        # global per-shard visibility count.
        block, bin_group = auto_block_and_group(
            num_visibilities // mesh.num_shards
        )
        global_w = None
        if sigma == "auto" or common_w_grid:
            global_w = global_w_range(
                mesh, (w_range(s.uvw, s.channel_frequencies)
                       for s in shards.values()))
        if sigma == "auto":
            sigma = resolve_sigma(
                num_visibilities,
                num_pixels,
                w_extent=global_w[1] - global_w[0],
                nm1_min=nm1_min_of(num_pixels, pixel_size_lm),
                epsilon=epsilon,
                do_wstacking=do_wstacking,
            )
        local_plans = {
            index: make_plan(
                shard.uvw, shard.channel_frequencies, num_pixels,
                pixel_size_lm, epsilon=epsilon, do_wstacking=do_wstacking,
                block=block, bin_group=bin_group, sigma=sigma,
                w_range=global_w if common_w_grid else None,
            )
            for index, shard in shards.items()
        }

    with step("stage_shards"):
        samples = {
            index: (shard.visibilities.ravel(),
                    shard.effective_weights().ravel())
            for index, shard in shards.items()
        }
        return stage_planned_shards(mesh, local_plans, samples,
                                    slot_mode=slot_mode)


def stage_planned_shards(mesh: DeviceMesh, local_plans: dict, samples: dict,
                         slot_mode: bool = False) -> ShardedStaging:
    """
    Stage this rank's planned shards: pad the plans to the globally
    agreed shapes (one host allgather of :func:`plan_shape_maxima`),
    then per shard its plan arrays, slot-order visibilities and weights
    and straddler pairs, uploaded to ``mesh.device``; and the total
    weight (one host allgather). ``local_plans`` / ``samples`` map each
    of ``mesh.addressable_shard_indices`` to its plan and its
    ``(complex visibilities, effective weights)``.

    ``slot_mode=True`` (invert only) leaves out the data-order transform
    (:data:`ORDER_KEYS`) and the predict pass's factors; the major cycle
    keeps them (its PSF reads the staged phase factors).
    """
    local_ids = mesh.addressable_shard_indices
    if sorted(local_plans) != local_ids or sorted(samples) != local_ids:
        raise KeyError(f"this rank stages shards {local_ids}, got plans for "
                       f"{sorted(local_plans)}")
    local_maxima = plan_shape_maxima([local_plans[i] for i in local_ids])
    keys = sorted(local_maxima)
    gathered = mesh.allgather_max(
        np.asarray([local_maxima[key] for key in keys], np.int64))
    maxima = dict(zip(keys, (int(v) for v in gathered)))
    plans = pad_plans_uniform([local_plans[i] for i in local_ids], maxima)

    arrays, vis_re, vis_im, weights, dup_a, dup_b = ([] for _ in range(6))
    local_weight = 0.0
    for plan, index in zip(plans, local_ids):
        vis, effective = samples[index]
        effective = np.asarray(effective, np.float32).ravel()
        v = np.asarray(vis).ravel()
        host = slot_plan_host_arrays(plan, mesh.device, predict=not slot_mode)
        if slot_mode:
            for key in ORDER_KEYS:
                del host[key]
        host["vis_re"], host["vis_im"] = stage_slot_vis(plan, v.real, v.imag)
        host["weights"] = stage_slot_weights(plan, effective)
        pair = slot_duplicate_pairs(plan)
        host["dup_a"], host["dup_b"] = (x.astype(np.int64) for x in pair)
        staged = stage_arrays(host, mesh.device)
        vis_re.append(staged.pop("vis_re"))
        vis_im.append(staged.pop("vis_im"))
        weights.append(staged.pop("weights"))
        dup_a.append(staged.pop("dup_a"))
        dup_b.append(staged.pop("dup_b"))
        arrays.append(staged)
        local_weight += float(effective.sum())
    total_weight = float(mesh.allgather_sum(np.asarray([local_weight]))[0])
    return ShardedStaging(mesh, plans, arrays, vis_re, vis_im, weights,
                          total_weight, dup_a, dup_b)


def sharded_invert_staged(staging: ShardedStaging, re_list, im_list, *,
                          fft_mode: str = "replicated") -> torch.Tensor:
    """
    The unnormalized image of this rank's staged shards' weighted slot
    visibilities ``re_list``/``im_list`` summed over the mesh, on the
    device, the same on every rank: per shard inverts whose images are
    summed (``"replicated"``), or the distributed mode's one invert over
    the local shards (``"distributed"``, S > 1).
    """
    if fft_mode not in FFT_MODES:
        raise ValueError(f"unknown fft_mode {fft_mode!r}")
    mesh = staging.mesh
    if fft_mode == "distributed" and mesh.num_shards > 1:
        invert = build_invert(staging.plans, mesh=mesh)
        return invert(staging.arrays, re_list, im_list)
    total = None
    for plan, arrays, re, im in zip(staging.plans, staging.arrays, re_list,
                                    im_list):
        image = build_invert(plan)(arrays, re, im)
        total = image if total is None else total.add_(image)
    return mesh.psum([total])


def sharded_invert_dataset(
    reader: VisibilityReader,
    num_pixels: int,
    pixel_size_asec: float,
    *,
    mesh: DeviceMesh | None = None,
    device=None,
    row_chunks: int | None = None,
    freq_chunks: int | None = None,
    epsilon: float = 1e-4,
    do_wstacking: bool = True,
    weighting: str = "natural",
    robust: float = 0.0,
    recorder=None,
    sigma: float | str = 2.0,
    fft_mode: str = "replicated",
) -> np.ndarray:
    """
    Invert a visibility dataset into a normalized Stokes-I dirty image
    over a mesh of shards (reference API: dask_invert_measurement_set,
    invert.py:212-270), on ``mesh.device`` (or a one-shard-per-rank
    mesh on ``device``). Every rank returns the same image.

    ``recorder`` is an optional ``utils.task_metrics.TaskRecorder``
    whose steps (``load_shards``, ``plan_shards``, ``stage_shards``,
    ``grid_fft_reduce``) replace the reference's dask task stream.
    ``fft_mode="distributed"`` reduces the partial plane grids and
    splits each plane's transforms over the shards (``ops/gridder.py``);
    it plans every shard on the global w range and needs ngrid and npix
    divisible by the shard count.
    """
    if fft_mode not in FFT_MODES:
        raise ValueError(f"unknown fft_mode {fft_mode!r}")
    step = recorder.step if recorder is not None else (
        lambda name: nullcontext()
    )
    staging = stage_sharded_inputs(
        reader, num_pixels, pixel_size_asec, mesh=mesh, device=device,
        row_chunks=row_chunks, freq_chunks=freq_chunks, epsilon=epsilon,
        do_wstacking=do_wstacking, weighting=weighting, robust=robust,
        step=step, sigma=sigma, common_w_grid=fft_mode == "distributed",
        slot_mode=True,
    )
    with step("grid_fft_reduce"):
        image = sharded_invert_staged(staging, *staging.weighted(),
                                      fft_mode=fft_mode)
        return device_get(image) / staging.total_weight
