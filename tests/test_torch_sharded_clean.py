"""
The port's sharded major cycles (``parallel/sharded_clean.py``) on the
CPU, S shards over a gloo world of one process, against the port's
single-device solvers at the JAX package's tolerances
(``tests/test_sharded_clean.py``), 96 px at 40 asec:

* Hogbom (model within 2e-4, residual within 2e-3 of the local
  residual's max), multiscale (2e-3, 5e-3), FISTA (1e-3 of the model's
  and of the residual's max);
* the distributed FFT mode equals the replicated mode within 1e-5 of
  the residual's max;
* a checkpointed run stopped after one cycle resumes to the
  uninterrupted result, and only rank 0 writes the checkpoint;
* an unknown algorithm raises.
"""

import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu_torch import VisibilityReader
from ska_sdp_cip_tpu_torch.invert import (
    StokesIGridderInput,
    pixel_size_lm_from_asec,
)
from ska_sdp_cip_tpu_torch.models import MeasurementOperator, major_cycle_clean
from ska_sdp_cip_tpu_torch.models.checkpoint import CHECKPOINT_NAME
from ska_sdp_cip_tpu_torch.models.fista import fista_clean
from ska_sdp_cip_tpu_torch.models.multiscale import multiscale_clean
from ska_sdp_cip_tpu_torch.parallel import sharded_clean
from ska_sdp_cip_tpu_torch.parallel.mesh import DeviceMesh, make_device_mesh
from ska_sdp_cip_tpu_torch.parallel.sharded_clean import (
    sharded_major_cycle_clean,
)

torch.set_num_threads(1)

NUM_PIXELS = 96
PIXEL_SIZE_ASEC = 40.0
SHALLOW = dict(num_major=2, gain=0.3, minor_iter=6)
MESH = dict(row_chunks=2, freq_chunks=4)


@pytest.fixture(scope="module")
def local_operator(dataset_path):
    gi = StokesIGridderInput.from_reader(VisibilityReader(dataset_path))
    operator = MeasurementOperator.build(
        gi.uvw, gi.channel_frequencies, gi.effective_weights(), NUM_PIXELS,
        pixel_size_lm_from_asec(PIXEL_SIZE_ASEC), epsilon=1e-4, device="cpu",
    )
    return operator, gi.visibilities.ravel()


def _sharded(dataset_path, mesh=None, **kwargs):
    return sharded_major_cycle_clean(
        VisibilityReader(dataset_path), NUM_PIXELS, PIXEL_SIZE_ASEC,
        mesh=mesh or make_device_mesh(8, device="cpu"), epsilon=1e-4,
        **{**MESH, **kwargs},
    )


def test_sharded_hogbom_matches_local(dataset_path, local_operator):
    model_s, residual_s, psf = _sharded(dataset_path, **SHALLOW)
    operator, vis = local_operator
    model_l, residual_l = (t.numpy() for t in
                           major_cycle_clean(operator, vis, **SHALLOW))
    scale = np.abs(residual_l).max()
    np.testing.assert_allclose(model_s, model_l, atol=2e-4 * scale)
    np.testing.assert_allclose(residual_s, residual_l, atol=2e-3 * scale)
    np.testing.assert_allclose(psf, operator.psf().numpy(),
                               atol=1e-5 * np.abs(psf).max())


def test_sharded_multiscale_matches_local(dataset_path, local_operator):
    scales = (0.0, 2.0, 4.0)
    model_s, residual_s, _ = _sharded(dataset_path, algorithm="multiscale",
                                      scales=scales, **SHALLOW)
    operator, vis = local_operator
    model_l, residual_l = (t.numpy() for t in multiscale_clean(
        operator, vis, scales=scales, **SHALLOW))
    scale = np.abs(residual_l).max()
    np.testing.assert_allclose(model_s, model_l, atol=2e-3 * scale)
    np.testing.assert_allclose(residual_s, residual_l, atol=5e-3 * scale)


def test_sharded_fista_matches_local(dataset_path, local_operator):
    num_iter = 8
    model_s, residual_s, _ = _sharded(dataset_path, algorithm="fista",
                                      num_major=1, minor_iter=num_iter * 10)
    operator, vis = local_operator
    model_l, residual_l, _ = fista_clean(operator, vis, num_iter=num_iter)
    model_l, residual_l = model_l.numpy(), residual_l.numpy()
    np.testing.assert_allclose(
        model_s, model_l, atol=1e-3 * max(np.abs(model_l).max(), 1e-9))
    np.testing.assert_allclose(residual_s, residual_l,
                               atol=1e-3 * np.abs(residual_l).max())
    assert model_s.min() >= 0


@pytest.mark.parametrize("algorithm", ["hogbom", "fista"])
def test_distributed_cycle_matches_replicated(dataset_path, algorithm):
    kwargs = dict(SHALLOW, algorithm=algorithm)
    model_r, residual_r, _ = _sharded(dataset_path, **kwargs)
    model_d, residual_d, _ = _sharded(dataset_path, fft_mode="distributed",
                                      **kwargs)
    scale = np.abs(residual_r).max()
    np.testing.assert_allclose(model_d, model_r, atol=1e-5 * scale)
    np.testing.assert_allclose(residual_d, residual_r, atol=1e-5 * scale)


def test_checkpoint_resume_on_rank_zero(dataset_path, tmp_path, monkeypatch):
    mesh = make_device_mesh(2, device="cpu")
    kwargs = dict(num_major=2, gain=0.3, minor_iter=6, row_chunks=2,
                  freq_chunks=1)
    model_a, residual_a, _ = _sharded(dataset_path, mesh, **kwargs)

    # A run stopped in its second cycle leaves the first cycle's state.
    calls = []
    residual = sharded_clean.ShardedOperator.residual

    def failing(self, model):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt("stopped")
        return residual(self, model)

    monkeypatch.setattr(sharded_clean.ShardedOperator, "residual", failing)
    with pytest.raises(KeyboardInterrupt):
        _sharded(dataset_path, mesh, checkpoint_dir=tmp_path, **kwargs)
    monkeypatch.setattr(sharded_clean.ShardedOperator, "residual", residual)
    assert (tmp_path / CHECKPOINT_NAME).is_file()
    model_b, residual_b, _ = _sharded(dataset_path, mesh,
                                      checkpoint_dir=tmp_path, **kwargs)
    scale = np.abs(residual_a).max()
    np.testing.assert_allclose(model_b, model_a, atol=1e-6 * scale)
    np.testing.assert_allclose(residual_b, residual_a, atol=1e-6 * scale)

    class _RankOne(DeviceMesh):
        """Rank 1 of a world whose rank 0 holds the same shards."""

        @property
        def addressable_shard_indices(self):
            return list(range(self.num_shards))

    other = _RankOne(2, "cpu")
    other.rank = 1
    quiet = tmp_path / "rank1"
    model_c, _, _ = _sharded(dataset_path, other, checkpoint_dir=quiet,
                             **kwargs)
    assert not (quiet / CHECKPOINT_NAME).exists()
    np.testing.assert_allclose(model_c, model_a, atol=1e-6 * scale)


def test_unknown_algorithm_raises(dataset_path):
    with pytest.raises(ValueError, match="algorithm"):
        _sharded(dataset_path, algorithm="nope")
