"""The check fails its control and the faults each cell can have, with
the rest of a run driven as usual on the CPU at a tiny size."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from cipbench import run

from .conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
IMAGE_CELLS = [c for c in CELLS if not c.endswith(".cycle")]
CYCLE_CELLS = [c for c in CELLS if c.endswith(".cycle")]


def _run(root, workload, **kw):
    cell = run.load_cell(root, workload)
    return run.run_cell(cell, 2**31 + 21, 0.3, False, torch.device("cpu"),
                        **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny_root, workload):
    assert _run(tiny_root, workload)["correct"]
    assert not _run(tiny_root, workload, control=True)["correct"]


def _half_weights(weights):
    w = np.array(weights, copy=True)
    w.reshape(len(w), -1)[::2] = 0.0
    return w


@pytest.mark.parametrize("fault", ["half_left_out", "image_shifted"])
@pytest.mark.parametrize("workload", IMAGE_CELLS)
def test_image_faults(tiny_root, monkeypatch, workload, fault):
    import ska_sdp_cip_tpu_torch.ops.gridder as gridder

    real = gridder.dirty_image

    def faulty(uvw, freqs, vis, weights, *args, **kwargs):
        if fault == "half_left_out":
            # Half the rows dropped; the image of the rest, scaled to the
            # whole weight: the mean over what is left.
            half = _half_weights(weights)
            image = real(uvw, freqs, vis, half, *args, **kwargs)
            return image * (np.sum(weights) / np.sum(half))
        return np.roll(real(uvw, freqs, vis, weights, *args, **kwargs), 1, 0)

    monkeypatch.setattr(gridder, "dirty_image", faulty)
    assert not _run(tiny_root, workload)["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "component_moved", "gradient_drifts"])
@pytest.mark.parametrize("workload", CYCLE_CELLS)
def test_cycle_faults(tiny_root, monkeypatch, workload, fault):
    import ska_sdp_cip_tpu_torch.models.clean as clean
    from ska_sdp_cip_tpu_torch.models.operators import MeasurementOperator

    real_minor = clean.hogbom_clean
    real_gradient = MeasurementOperator.residual_gradient

    if fault == "state_unchanged":
        def minor(dirty, psf, **kw):
            model, res = real_minor(dirty, psf, **kw)
            return torch.zeros_like(model), res
        monkeypatch.setattr(clean, "hogbom_clean", minor)
    elif fault == "component_moved":
        def minor(dirty, psf, **kw):
            model, res = real_minor(dirty, psf, **kw)
            return torch.roll(model, 1, 1), res
        monkeypatch.setattr(clean, "hogbom_clean", minor)
    elif fault == "gradient_drifts":
        # Right at the window's first step, off by 1% from the second
        # on: only the last step's residual can see it.
        calls = []

        def gradient(self, image, vis):
            calls.append(1)
            out = real_gradient(self, image, vis)
            return out if len(calls) <= 2 else out * 1.01
        monkeypatch.setattr(MeasurementOperator, "residual_gradient", gradient)
    else:
        def gradient(self, image, vis):
            keep = self.slot_weights.clone()
            keep[::2] = 0.0
            full, self.slot_weights = self.slot_weights, keep
            try:
                out = real_gradient(self, image, vis)
            finally:
                self.slot_weights = full
            return out * (float(full.sum()) / float(keep.sum()))
        monkeypatch.setattr(MeasurementOperator, "residual_gradient", gradient)
    assert not _run(tiny_root, workload)["correct"]
