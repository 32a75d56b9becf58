"""The cell ``csd3-10k.image``: its frozen values, the VZ its set-up
writes (read back by the program's reader as the Stokes-I data it was
made from), a read of the VZ every call, a fault its check must catch,
and its readers of the program's span ``read`` and of the harness's
spans of the planner and staging."""

from __future__ import annotations

import dataclasses
import importlib
import json
import time

import numpy as np
import pytest
import torch

from cipbench import data, run, synth
from cipbench.drivers import image

from .conftest import ROOT, shrink

CELL = "csd3-10k.image"


def test_frozen_values():
    cfg = json.loads((ROOT / "cipbench" / "configs" / "csd3-10k.json")
                     .read_text())
    traffic = json.loads((ROOT / "cipbench" / "traffic" / "image.json")
                         .read_text())
    obs = cfg["observation"]
    baselines = obs["num_antennas"] * (obs["num_antennas"] - 1) // 2
    rows = image.dump_rows(obs["num_dumps"], baselines,
                           traffic["dump_stride"])
    assert len(rows) == 57 * 2016
    assert len(rows) * obs["num_channels"] == 14_708_736
    assert rows[0] == 0 and rows[-1] == 448 * 2016 + 2015


def test_written_dataset_reads_back(tmp_path):
    from ska_sdp_cip_tpu_torch.invert import StokesIGridderInput
    from ska_sdp_cip_tpu_torch.io.visibility_dataset import VisibilityReader

    rng = np.random.default_rng(4)
    uvw, _ = synth.synthetic_uvw(3, 5, seed=1)
    freqs = np.array([1.4e9, 1.41e9, 1.42e9])
    shape = (len(uvw), len(freqs))
    vis = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)
    wgt = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    wgt[0, 1] = 0.0
    files = image.write_dataset(tmp_path / "obs.vz", uvw, freqs, vis, wgt)
    assert {f.name for f in files} >= {"data.npy", "flag.npy", "uvw.npy",
                                       "weight_spectrum.npy", "metadata.json"}
    gi = StokesIGridderInput.from_reader(VisibilityReader(tmp_path / "obs.vz"))
    assert np.array_equal(gi.visibilities, vis)
    np.testing.assert_allclose(gi.effective_weights(), wgt, rtol=1e-6)
    assert gi.effective_weights()[0, 1] == 0.0
    np.testing.assert_array_equal(gi.uvw, uvw)


def _run(root, trace=False, **kw):
    cell = run.load_cell(root, CELL)
    return run.run_cell(cell, 2**31 + 29, 0.3, trace, torch.device("cpu"),
                        **kw)


def test_half_the_dataset_left_unread(tiny_root, monkeypatch):
    from ska_sdp_cip_tpu_torch import invert

    real = invert.StokesIGridderInput.from_reader.__func__

    def half(cls, reader):
        full = real(cls, reader)
        n = len(full.uvw) // 2
        return cls(channel_frequencies=full.channel_frequencies,
                   flags=full.flags[:n], uvw=full.uvw[:n],
                   visibilities=full.visibilities[:n],
                   weights=full.weights[:n])

    assert _run(tiny_root)["correct"]
    monkeypatch.setattr(invert.StokesIGridderInput, "from_reader",
                        classmethod(half))
    result = _run(tiny_root)
    assert not result["correct"]
    assert result["checks"]["img_err"]["value"] > 1e-4


def test_each_call_reads_the_dataset(tiny_root, monkeypatch):
    from ska_sdp_cip_tpu_torch.io import visibility_dataset

    opened = []
    real = visibility_dataset.VisibilityReader.__init__

    def counted(self, *args, **kwargs):
        opened.append(1)
        real(self, *args, **kwargs)

    monkeypatch.setattr(visibility_dataset.VisibilityReader, "__init__",
                        counted)
    result = _run(tiny_root)
    assert result["correct"]
    # The warm-up call and every call of the window.
    assert len(opened) == result["attempted"] + 1


def test_traced_run_reads_the_planner_and_staging(tiny_root):
    # The harness's own spans; the program's recorder and the device
    # trace are read only under the card's profiler.
    result = _run(tiny_root, trace=True)
    for name in ("plan_s.image", "stage_s.image"):
        assert result["metrics"][name]["value"] > 0, name


def test_read_reader(monkeypatch):
    from ska_sdp_cip_tpu_torch.utils import task_metrics

    torch.set_num_threads(1)
    cell = run.load_cell(ROOT, CELL)
    shrink(cell.config)
    driver = importlib.import_module("cipbench.drivers.image")
    state = driver.setup(cell.config, cell.traffic, 5, torch.device("cpu"))
    task_metrics.reset()
    calls = []
    with task_metrics.tracing():
        for _ in range(2):
            t = time.perf_counter()
            state.call()
            calls.append(time.perf_counter() - t)
    state.close()
    summary = task_metrics.summary()
    task_metrics.reset()
    run_ = run.Run(unit="image", setup_s=0.0, window_s=sum(calls),
                   calls=calls, bounds={})
    monkeypatch.setattr(task_metrics, "summary", lambda: summary)
    reader = cell.readers["read_s.image"]
    assert reader.read(run_) == pytest.approx(
        summary["spans"]["read"]["host_s"] / 2)
    assert summary["spans"]["read"]["count"] == 2
    assert reader.read(dataclasses.replace(run_, unit="cycle")) is None
    monkeypatch.setattr(task_metrics, "summary",
                        lambda: {"spans": {}, "counters": {}})
    assert reader.read(run_) is None


def test_same_points_as_the_snapshot():
    cfg = json.loads((ROOT / "cipbench" / "configs" / "csd3-10k.json")
                     .read_text())
    a = data.Sky.of(cfg, 17)
    assert len(a.pixels) == cfg["sky"]["num_sources"]
