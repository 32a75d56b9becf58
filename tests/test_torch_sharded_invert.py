"""
The port's sharded invert (``ska_sdp_cip_tpu_torch/parallel``) on the
CPU: S shards over a gloo world of one process, every shard's collective
run through the process group.

* ``sharded_invert_dataset`` at S = 1, 2, 4 and 8 equals the port's
  ``invert_dataset`` and the JAX package's ``sharded_invert_dataset``
  (XLA gridder, its 8-device CPU mesh) on the same row and frequency
  chunks, at the reference's tolerance (rtol 1e-5, atol 1e-5 of the
  max); so does robust weighting (a global density over the shards);
* the distributed FFT mode equals the replicated mode at that tolerance;
* ``shard_chunk_counts`` gives the JAX package's results and errors;
* a rank loads and stages only its own shards;
* the padded per-shard plans equal the JAX package's field by field;
* the mesh's collectives act on the local shards as a 4-device mesh's
  would, and the distributed mode refuses shard counts that do not
  divide the grid.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu.parallel import mesh as jmesh
from ska_sdp_cip_tpu.parallel import sharded_invert as jsharded
from ska_sdp_cip_tpu_torch import (
    VisibilityReader,
    invert_dataset,
    sharded_invert_dataset,
)
from ska_sdp_cip_tpu_torch import native as torch_native
from ska_sdp_cip_tpu_torch.invert import StokesIGridderInput
from ska_sdp_cip_tpu_torch.ops import plan as tplan
from ska_sdp_cip_tpu_torch.parallel import sharded_invert as tsharded
from ska_sdp_cip_tpu_torch.parallel.mesh import DeviceMesh, make_device_mesh
from ska_sdp_cip_tpu_torch.utils.task_metrics import TaskRecorder

torch.set_num_threads(1)

NUM_PIXELS = 128
PIXEL_SIZE_ASEC = 30.0
TOLERANCE = 1e-5
#: (row_chunks, freq_chunks) per shard count.
CHUNKS = {1: (1, 1), 2: (2, 1), 4: (2, 2), 8: (2, 4)}


def _assert_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOLERANCE,
                               atol=TOLERANCE * np.abs(want).max())


@pytest.fixture(scope="module")
def local_image(dataset_path):
    return invert_dataset(VisibilityReader(dataset_path), NUM_PIXELS,
                          PIXEL_SIZE_ASEC, device="cpu")


@pytest.mark.parametrize("shards", sorted(CHUNKS))
def test_sharded_matches_local_and_jax(dataset_path, reader, local_image,
                                       shards):
    row_chunks, freq_chunks = CHUNKS[shards]
    recorder = TaskRecorder(worker="test")
    ours = sharded_invert_dataset(
        VisibilityReader(dataset_path), NUM_PIXELS, PIXEL_SIZE_ASEC,
        mesh=make_device_mesh(shards, device="cpu"), row_chunks=row_chunks,
        freq_chunks=freq_chunks, recorder=recorder,
    )
    _assert_close(ours, local_image)
    ref = jsharded.sharded_invert_dataset(
        reader, NUM_PIXELS, PIXEL_SIZE_ASEC,
        mesh=jmesh.make_device_mesh(shards), row_chunks=row_chunks,
        freq_chunks=freq_chunks, gridder="xla",
    )
    _assert_close(ours, ref)
    assert [t["name"] for t in recorder.tasks] == [
        "load_shards", "plan_shards", "stage_shards", "grid_fft_reduce",
    ]


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_distributed_matches_replicated(dataset_path, shards):
    reader = VisibilityReader(dataset_path)
    mesh = make_device_mesh(shards, device="cpu")
    row_chunks, freq_chunks = CHUNKS[shards]
    kwargs = dict(mesh=mesh, row_chunks=row_chunks, freq_chunks=freq_chunks)
    replicated = sharded_invert_dataset(reader, NUM_PIXELS, PIXEL_SIZE_ASEC,
                                        **kwargs)
    mesh.reset_stats()
    distributed = sharded_invert_dataset(reader, NUM_PIXELS, PIXEL_SIZE_ASEC,
                                         fft_mode="distributed", **kwargs)
    _assert_close(distributed, replicated)
    calls = mesh.collective_stats()["calls"]
    # Per plane two reduce-scatters and two all-to-alls; one gather.
    assert calls["reduce_scatter"] == calls["all_to_all"] > 0
    assert calls["all_gather"] == 1 and "all_reduce" not in calls


def test_robust_weighting_matches_local(dataset_path):
    reader = VisibilityReader(dataset_path)
    kwargs = dict(weighting="robust", robust=0.5)
    local = invert_dataset(reader, NUM_PIXELS, PIXEL_SIZE_ASEC,
                           device="cpu", **kwargs)
    ours = sharded_invert_dataset(
        reader, NUM_PIXELS, PIXEL_SIZE_ASEC,
        mesh=make_device_mesh(4, device="cpu"), row_chunks=2,
        freq_chunks=2, **kwargs,
    )
    _assert_close(ours, local)


@pytest.mark.parametrize(
    "args",
    [(8, 4, None, None), (8, 4, 2, None), (8, 4, None, 2), (8, 4, 2, 4),
     (4, 8, None, None), (1, 4, None, None), (6, 4, None, None),
     (8, 4, 3, 4), (8, 4, 3, None)],
)
def test_shard_chunk_counts_matches_jax(args):
    try:
        want = jsharded.shard_chunk_counts(*args)
    except ValueError as err:
        with pytest.raises(ValueError, match=re.escape(str(err))):
            tsharded.shard_chunk_counts(*args)
        return
    assert tsharded.shard_chunk_counts(*args) == want


class _FirstHalfMesh(DeviceMesh):
    """A rank of a 4-shard mesh that holds shards 0 and 1 only."""

    @property
    def addressable_shard_indices(self):
        return [0, 1]


def test_staging_loads_only_local_shards(dataset_path, monkeypatch):
    make_device_mesh(1, device="cpu")  # the process group
    loaded = []
    original = StokesIGridderInput.from_reader.__func__

    def recording(cls, chunk):
        loaded.append((chunk.row_start, chunk.channel_start))
        return original(cls, chunk)

    monkeypatch.setattr(StokesIGridderInput, "from_reader",
                        classmethod(recording))
    staging = tsharded.stage_sharded_inputs(
        VisibilityReader(dataset_path), 64, PIXEL_SIZE_ASEC,
        mesh=_FirstHalfMesh(4, "cpu"), row_chunks=2, freq_chunks=2,
    )
    assert len(loaded) == 2 and len(staging.plans) == 2
    # Staging plans of shards this rank does not hold fails loudly.
    mesh = make_device_mesh(4, device="cpu")
    plan = staging.plans[0]
    with pytest.raises(KeyError):
        tsharded.stage_planned_shards(mesh, {0: plan},
                                      {0: (np.zeros(1), np.zeros(1))})


@pytest.mark.parametrize(
    "kwargs",
    [{"common_w_grid": True}, {"sigma": "auto"}],
    ids=["common_w_grid", "sigma_auto"],
)
def test_shard_plans_match_jax(dataset_path, reader, monkeypatch, kwargs):
    monkeypatch.setattr(torch_native, "available", lambda: False)
    ours = tsharded.stage_sharded_inputs(
        VisibilityReader(dataset_path), NUM_PIXELS, PIXEL_SIZE_ASEC,
        mesh=make_device_mesh(4, device="cpu"), row_chunks=2, freq_chunks=2,
        **kwargs,
    )
    ref = jsharded.stage_sharded_inputs(
        reader, NUM_PIXELS, PIXEL_SIZE_ASEC, mesh=jmesh.make_device_mesh(4),
        row_chunks=2, freq_chunks=2, **kwargs,
    )
    assert len(ours.plans) == len(ref.plans) == 4
    for got, want in zip(ours.plans, ref.plans):
        want = tplan.plan_from_fields(dataclasses.asdict(want))
        for field in dataclasses.fields(tplan.GridderPlan):
            a, b = getattr(got, field.name), getattr(want, field.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=field.name)
            else:
                assert a == b, field.name
    assert ours.total_weight == pytest.approx(ref.total_weight, rel=1e-12)


def test_mesh_collectives_on_local_shards():
    mesh = make_device_mesh(4, device="cpu")
    assert mesh.addressable_shard_indices == [0, 1, 2, 3]
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn((8, 3), generator=gen) for _ in range(4)]
    total = sum(parts)
    torch.testing.assert_close(mesh.psum([p.clone() for p in parts]), total)
    slabs = mesh.psum_scatter(parts)
    torch.testing.assert_close(torch.cat(slabs), total)
    received = mesh.all_to_all(parts)
    for j, got in enumerate(received):  # shard j: chunk j of every shard
        torch.testing.assert_close(
            got, torch.stack([p[2 * j : 2 * j + 2] for p in parts]))
    torch.testing.assert_close(mesh.all_gather(parts), torch.stack(parts))
    np.testing.assert_array_equal(mesh.allgather_max(np.array([3, 7])),
                                  [3, 7])
    assert mesh.allgather_sum(np.array([0.25]))[0] == 0.25
    stats = mesh.collective_stats()
    assert stats["calls"] == {"all_reduce": 1, "reduce_scatter": 1,
                              "all_to_all": 1, "all_gather": 1,
                              "host_allgather": 2}


def test_distributed_mode_needs_divisible_grid(dataset_path):
    with pytest.raises(ValueError, match="divisible"):
        sharded_invert_dataset(
            VisibilityReader(dataset_path), 120, PIXEL_SIZE_ASEC,
            mesh=make_device_mesh(16, device="cpu"), row_chunks=4,
            freq_chunks=4, fft_mode="distributed",
        )
    with pytest.raises(ValueError, match="fft_mode"):
        sharded_invert_dataset(
            VisibilityReader(dataset_path), 64, PIXEL_SIZE_ASEC,
            device="cpu", fft_mode="sideways")
