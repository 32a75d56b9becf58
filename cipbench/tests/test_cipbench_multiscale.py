"""The cell ``csd3-10k-briggs.multiscale``: its configuration's frozen
values, its work count, the plain references it holds the program to,
the faults each of its checks must catch at a tiny size on the CPU, and
its per-layer readers."""

from __future__ import annotations

import dataclasses
import importlib
import json
import time

import numpy as np
import pytest
import torch

from cipbench import run, synth, work, work_multiscale
from cipbench.reference import multiscale as ref_ms

from .conftest import ROOT, shrink

CELL = "csd3-10k-briggs.multiscale"
CFG = json.loads((ROOT / "cipbench" / "configs" / "csd3-10k-briggs.json")
                 .read_text())


def test_frozen_values():
    base = json.loads((ROOT / "cipbench" / "configs" / "csd3-10k.json")
                      .read_text())
    assert CFG["observation"] == base["observation"]
    img = CFG["imaging"]
    uvw, freqs = synth.observation(CFG)
    g = work.geometry(uvw, freqs, img["num_pixels"],
                      synth.pixel_size_lm(img["pixel_size_asec"]),
                      epsilon=img["epsilon"], sigma=img["sigma"])
    assert g.nvis == 116_121_600
    assert (g.sigma, g.ngrid, g.support, g.nplanes) == (1.5, 15360, 8, 10)
    assert img["scales"] == [0.0, 4.0, 8.0, 16.0]
    assert ref_ms.kernel_radius(img["scales"]) == 33
    assert (img["weighting"], img["robust"]) == ("robust", -0.5)
    assert CFG["reduced"] == ["num_channels"]


def test_scale_conv_bound():
    # 10240 px, 67 taps: M = 10306^2; the flops bound it (1.09 ms), the
    # bytes (residual and four frames, 2.1 GB) take 0.63 ms.
    nbytes, flops = work_multiscale.scale_conv_work(10240, 67, 4)
    m = 10306 ** 2
    assert nbytes == 10240 ** 2 * 4 * 5
    assert flops == pytest.approx(5 * 5.0 * m * np.log2(m) + 4 * 6.0 * m)
    bound = work_multiscale.scale_conv_bound(10240, CFG["imaging"]["scales"])
    assert bound == pytest.approx(flops / work.FP32_FLOPS_PER_S)
    assert 1.0e-3 < bound < 1.2e-3


def test_reference_pieces_agree_with_each_other():
    gen = torch.Generator().manual_seed(3)
    image = torch.randn((40, 36), generator=gen, dtype=torch.float64)
    kernels, _ = ref_ms.kernels_and_biases((0.0, 2.0, 3.0), 0.6, "cpu",
                                           torch.float64)
    k = kernels[2]
    full = ref_ms.conv_same(image, k)
    pixels = np.array([[0, 0], [39, 35], [20, 3], [7, 30]])
    direct = ref_ms.conv_at(image, k, pixels)
    assert torch.allclose(direct, full[pixels[:, 0], pixels[:, 1]],
                          rtol=0, atol=1e-12)
    tf32 = ref_ms.conv_at(image, k, pixels, "tf32")
    gap = float((tf32 - direct).abs().max() / image.abs().max())
    assert 1e-5 < gap < 2e-3
    assert abs(float(kernels.sum((1, 2)).max()) - 1.0) < 1e-12


def test_reference_minor_follows_the_program_bit_for_bit():
    from ska_sdp_cip_tpu_torch.models import multiscale as tms

    gen = torch.Generator().manual_seed(8)
    n = 64
    dirty = torch.randn((n, n), generator=gen)
    dirty[20, 40] += 9.0
    psf = torch.zeros((n, n))
    psf[n // 2 - 3 : n // 2 + 4, n // 2 - 3 : n // 2 + 4] = 0.2
    psf[n // 2, n // 2] = 1.0
    for patch, slope in ((None, 0.6), (32, -0.8)):
        kernels, biases = tms.scale_kernels_and_biases((0.0, 2.0), slope,
                                                       "cpu")
        minor = tms.prepare_multiscale_minor(psf, kernels, biases,
                                             psf_patch=patch)
        P = patch or n
        frames = tms._scale_frames(dirty, kernels, 2, P // 2)
        want, _ = minor(dirty, gain=0.2, max_iter=30)
        got, _ = ref_ms.minor(frames, minor.neg_cross.reshape(2, 2, P, P),
                              kernels, biases, npix=n, gain=0.2, max_iter=30,
                              block=ref_ms.minor_block(n, P) if patch
                              else None)
        assert torch.equal(got, want), patch


# -- faults --------------------------------------------------------------


def _run(root, trace=False, **kw):
    cell = run.load_cell(root, CELL)
    return run.run_cell(cell, 2**31 + 23, 0.3, trace, torch.device("cpu"),
                        **kw)


def _over(result, name):
    check = result["checks"][name]
    return check["value"] > check["limit"]


def test_runs_correct_and_fails_its_controls(tiny_root):
    ok = _run(tiny_root)
    assert ok["correct"] and not any(_over(ok, k) for k in ok["checks"])
    control = _run(tiny_root, control=True)
    assert all(_over(control, k) for k in control["checks"]), control


def _tf32_conv(image, kernel):
    return torch.nn.functional.conv2d(
        ref_ms.tf32_round(image)[None, None],
        ref_ms.tf32_round(kernel)[None, None], padding="same")[0, 0]


FAULTS = {
    "natural_weights": "weight_err",
    "tf32_conv": "frame_err",
    "cross_psf_shifted": "cross_psf_err",
    "kernels_scaled": "cross_psf_err",
    "update_dropped": "minor_err",
    "wrong_scale": "minor_err",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults(tiny_root, monkeypatch, fault):
    from ska_sdp_cip_tpu_torch.models import multiscale as tms
    from ska_sdp_cip_tpu_torch.models.weighting import ImagingWeighter

    if fault == "natural_weights":
        monkeypatch.setattr(ImagingWeighter, "apply",
                            lambda self, uvw, freqs, w: np.asarray(w))
    elif fault == "tf32_conv":
        monkeypatch.setattr(tms, "_conv_same", _tf32_conv)
    elif fault == "cross_psf_shifted":
        real = tms._neg_cross_psfs

        def shifted(psf, kernels, num_scales, crop=None):
            out = real(psf, kernels, num_scales, crop)
            n = crop[1] if crop is not None else psf.shape[0]
            return torch.roll(out.reshape(num_scales, num_scales, n, n), 1,
                              -1).reshape(out.shape)
        monkeypatch.setattr(tms, "_neg_cross_psfs", shifted)
    elif fault == "kernels_scaled":
        # The program's own kernels 1% off: the cross PSFs built from
        # them must be held to the reference's kernels, not to these.
        real = tms.scale_kernels_and_biases

        def scaled(*args, **kwargs):
            kernels, biases = real(*args, **kwargs)
            return kernels * 1.01, biases
        monkeypatch.setattr(tms, "scale_kernels_and_biases", scaled)
    else:
        call = tms.MultiscaleMinor.__call__

        def faulty(self, residual, **kw):
            if fault == "wrong_scale":
                self = dataclasses.replace(
                    self, kernels=torch.roll(self.kernels, 1, 0))
            model, res = call(self, residual, **kw)
            return (torch.zeros_like(model) if fault == "update_dropped"
                    else model), res
        monkeypatch.setattr(tms.MultiscaleMinor, "__call__", faulty)
    result = _run(tiny_root)
    assert not result["correct"]
    assert _over(result, FAULTS[fault]), result["checks"]


def test_a_program_without_the_step_fails_before_making_data(
        tiny_root, monkeypatch):
    from cipbench import extended
    from ska_sdp_cip_tpu_torch.models import multiscale as tms

    made = []
    monkeypatch.setattr(extended, "stokes_i",
                        lambda *a, **k: made.append(1))
    monkeypatch.delattr(tms, "build_multiscale_cycle_step")
    t = time.perf_counter()
    with pytest.raises(SystemExit):
        _run(tiny_root)
    assert not made and time.perf_counter() - t < 5


# -- per-layer readers ---------------------------------------------------


READERS = ("scale_conv_s.cycle", "scale_conv_roofline.cycle",
           "ms_minor_s.cycle", "ms_minor_host_s.cycle")


@pytest.fixture(scope="module")
def traced():
    """(a Run of 2 traced calls at a tiny size, the recorder's summary,
    the cell's readers)."""
    from ska_sdp_cip_tpu_torch.utils import task_metrics

    torch.set_num_threads(1)
    cell = run.load_cell(ROOT, CELL)
    shrink(cell.config)
    driver = importlib.import_module("cipbench.drivers.multiscale")
    state = driver.setup(cell.config, cell.traffic, 3, torch.device("cpu"))
    task_metrics.reset()
    calls, bounds = [], {}
    with task_metrics.tracing():
        for _ in range(2):
            t = time.perf_counter()
            for k, v in state.call().items():
                bounds[k] = bounds.get(k, 0.0) + v
            calls.append(time.perf_counter() - t)
    state.release()
    state.close()
    out = (run.Run(unit=driver.UNIT, setup_s=0.0, window_s=sum(calls),
                   calls=calls, bounds=bounds), task_metrics.summary(),
           cell.readers)
    task_metrics.reset()
    return out


def test_traced_run_reads_the_gradient(tiny_root):
    # The harness's own span; the program's recorder and the device
    # trace are read only under the card's profiler.
    result = _run(tiny_root, trace=True)
    assert result["correct"]
    assert result["metrics"]["gradient_s.cycle"]["value"] > 0


def test_readers_are_declared():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = declared[name]
        assert m["workloads"] == [CELL] and m["moves"] == "cycle_s"
        assert m["source"] == "program_span"
    cycle = next(m for m in bench["end_to_end"] if m["name"] == "cycle_s")
    assert CELL in cycle["workloads"]


@pytest.mark.parametrize("name", READERS)
def test_readers_read_the_recorder(traced, monkeypatch, name):
    from ska_sdp_cip_tpu_torch.utils import task_metrics

    run_, summary, readers = traced
    monkeypatch.setattr(task_metrics, "summary", lambda: summary)
    spans = summary["spans"]
    value = readers[name].read(run_)
    if name == "scale_conv_roofline.cycle":
        # No device trace on the CPU: no roofline of the card.
        assert value is None
        run_ = dataclasses.replace(run_, trace=object())
        value = readers[name].read(run_)
        want = 100.0 * run_.bounds["scale_conv"] / (
            spans["multiscale.frames"]["device_s"])
    else:
        span = "multiscale.frames" if "scale" in name else "multiscale.minor"
        clock = "host_s" if "host" in name else "device_s"
        want = spans[span][clock] / 2
    assert value == pytest.approx(want) and value > 0
    assert spans["multiscale.frames"]["count"] == 2
    monkeypatch.setattr(task_metrics, "summary",
                        lambda: {"spans": {}, "counters": {}})
    assert readers[name].read(run_) is None
    other = dataclasses.replace(run_, unit="image")
    assert readers[name].read(other) is None
