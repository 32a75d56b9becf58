"""
The port's sharded Hogbom step
(``parallel/sharded_clean.py:build_sharded_major_cycle_step``) across two
real processes on the CPU: each rank of an explicit gloo world
(``tests/helpers/sharded_step_worker.py``, waited on 120 s) holds one
channel chunk of the synthetic VZ, staged in memory through
``stage_loaded_shards``, and runs two steps at 128 px from the dirty
image. Checked here:

* the in-memory staging equals ``stage_sharded_inputs`` on the same VZ,
  array for array;
* the PSF and each residual image (the two the minor cycles were handed
  and the last) at sample pixels against the benchmark's float64 DFT
  (``cipbench/reference/dft.py``) of the whole dataset, at the
  configuration's epsilon (1e-4);
* each model update against plain Hogbom (``cipbench/reference/clean.py``)
  on the residual and PSF the program handed its minor cycle;
* both ranks' models and residuals bit-equal;
* the models, residual and PSF equal to ``sharded_major_cycle_clean``'s
  after as many cycles;
* within gridder accuracy of the single-device ``build_major_cycle_step``
  on the union of the shards at the same sigma.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cipbench.reference import clean as plain
from cipbench.reference import dft
from helpers.sharded_step_worker import (
    CLEAN,
    CYCLES,
    NUM_PIXELS,
    PIXEL_SIZE_ASEC,
)
from ska_sdp_cip_tpu_torch import VisibilityReader
from ska_sdp_cip_tpu_torch.invert import (
    StokesIGridderInput,
    pixel_size_lm_from_asec,
)
from ska_sdp_cip_tpu_torch.models import MeasurementOperator
from ska_sdp_cip_tpu_torch.models.clean import build_major_cycle_step
from ska_sdp_cip_tpu_torch.parallel.mesh import free_port

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).parent / "helpers" / "sharded_step_worker.py"
WAIT_S = 120
EPS = 1e-4


@pytest.fixture(scope="module")
def ranks(dataset_path, tmp_path_factory):
    """Each rank's npz, in rank order."""
    out = tmp_path_factory.mktemp("sharded_step")
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(rank), port, str(dataset_path),
         str(out / f"rank{rank}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=WAIT_S)[0].decode(
                errors="replace"))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, f"rank failed:\n{log[-4000:]}"
    return [dict(np.load(out / f"rank{rank}.npz")) for rank in range(2)]


@pytest.fixture(scope="module")
def union(dataset_path):
    return StokesIGridderInput.from_reader(VisibilityReader(dataset_path))


def _pixels(npix: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    centre = [[npix // 2, npix // 2]]
    return np.concatenate([centre, rng.integers(0, npix, size=(24, 2))])


def _reference(gi, models: list, pixels) -> np.ndarray:
    """(2 + len(models), P) at ``pixels``, over the total weight: the
    dirty image, the residual image at each model and the PSF."""
    pix = pixel_size_lm_from_asec(PIXEL_SIZE_ASEC)
    w = torch.as_tensor(gi.effective_weights()).double()
    v = torch.as_tensor(gi.visibilities).to(torch.complex128)
    batch = [v * w]
    for model in models:
        nz = np.argwhere(model != 0)
        m = dft.model_visibilities(gi.uvw, gi.channel_frequencies, nz,
                                   torch.as_tensor(model[nz[:, 0], nz[:, 1]]),
                                   NUM_PIXELS, pix)
        batch.append((v - m) * w)
    batch.append(w.to(torch.complex128))
    out = dft.dirty_at(gi.uvw, gi.channel_frequencies,
                       torch.stack(batch, dim=-1), pixels, NUM_PIXELS, pix)
    return (out / w.sum()).numpy()


def test_in_memory_staging_equals_the_readers(ranks):
    assert all(bool(r["staged_equal"]) for r in ranks)


def test_step_against_the_dft_and_plain_hogbom(ranks, union):
    r = ranks[0]
    models = [np.zeros((NUM_PIXELS, NUM_PIXELS), np.float32), *r["models"]]
    pixels = _pixels(NUM_PIXELS)
    dirty, *residuals, psf = _reference(union, models, pixels)
    at = (pixels[:, 0], pixels[:, 1])
    scale = np.abs(dirty).max()
    assert np.abs(r["psf"][at] - psf).max() <= EPS * abs(psf[0])
    assert np.abs(r["residuals"][0][at] - dirty).max() <= EPS * scale
    for k in range(CYCLES + 1):
        got = r["residuals"][k][at]
        assert np.abs(got - residuals[k]).max() <= EPS * scale, k
    for k in range(CYCLES):
        # The minor cycle got the residual the cycle before left.
        np.testing.assert_array_equal(r["handed_dirty"][k], r["residuals"][k])
        np.testing.assert_array_equal(r["handed_psf"][k], r["psf"])
        delta, _ = plain.hogbom(torch.as_tensor(r["handed_dirty"][k]),
                                torch.as_tensor(r["psf"]),
                                gain=CLEAN["gain"],
                                max_iter=CLEAN["minor_iter"])
        update = r["models"][k] - models[k]
        assert np.abs(update - delta.numpy()).max() <= (
            1e-6 * float(delta.abs().max())), k
        assert np.count_nonzero(update) > 0


def test_ranks_bit_equal(ranks):
    for name in ("models", "residuals", "psf"):
        np.testing.assert_array_equal(ranks[1][name], ranks[0][name],
                                      err_msg=name)


def test_step_equals_the_loop(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["loop_model"], r["models"][-1])
        np.testing.assert_array_equal(r["loop_residual"], r["residuals"][-1])
        np.testing.assert_array_equal(r["loop_psf"], r["psf"])


def test_sharded_matches_single_device_at_the_same_sigma(ranks, union):
    r = ranks[0]
    op = MeasurementOperator.build(
        union.uvw, union.channel_frequencies, union.effective_weights(),
        NUM_PIXELS, pixel_size_lm_from_asec(PIXEL_SIZE_ASEC), epsilon=1e-4,
        sigma=float(r["sigma"]), device="cpu")
    step = build_major_cycle_step(op, **CLEAN)
    slots = op.stage(union.visibilities.ravel())
    model = torch.zeros((NUM_PIXELS, NUM_PIXELS))
    for _ in range(CYCLES):
        model = step(model, slots.re, slots.im)
    scale = np.abs(r["residuals"][0]).max()
    np.testing.assert_allclose(r["models"][-1], model.numpy(),
                               atol=2e-4 * scale)
    np.testing.assert_allclose(r["psf"], op.psf().numpy(),
                               atol=1e-5 * np.abs(r["psf"]).max())
