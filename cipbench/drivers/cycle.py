"""
Traffic ``cycle``: major cycles of Hogbom CLEAN over the node's whole
share, on the card, with no host round trip. Set-up builds the
measurement operator, stages the visibilities into slot order and runs
``warmup_cycles`` cycles; each call is one step of

    build_major_cycle_step(operator, gain=..., minor_iter=...)

followed by ``torch.cuda.synchronize()``.

The check covers each stage of a step: the PSF that the minor cycle uses,
and the residual images of the window's first and last steps (predict,
residual in slot space, invert), each at the sample pixels against the
DFT of the visibilities less that of the model the step started from;
and the last step's minor cycle and model update, against the plain
Hogbom run on the residual and PSF that the program handed its minor
cycle (a capture on ``models.clean.hogbom_clean``, which keeps
references and adds no work). So a fault of the gradient that shows
only after the first cycle is caught at the last.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import data, synth, work
from ..reference import clean, dft
from ..trace import resolve

UNIT = "cycle"
MINOR = "ska_sdp_cip_tpu_torch.models.clean:hogbom_clean"


class Capture:
    """Keeps the residual and PSF of the last minor-cycle call."""

    def __init__(self):
        self.dirty = self.psf = None
        self._undo = None

    def install(self) -> None:
        owner, name, raw = resolve(MINOR)

        def minor(dirty, psf, *args, **kwargs):
            self.dirty, self.psf = dirty, psf
            return raw(dirty, psf, *args, **kwargs)

        setattr(owner, name, minor)
        self._undo = (owner, name, raw)

    def remove(self) -> None:
        if self._undo is not None:
            owner, name, raw = self._undo
            setattr(owner, name, raw)
            self._undo = None


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from ska_sdp_cip_tpu_torch.models.clean import build_major_cycle_step
        from ska_sdp_cip_tpu_torch.models.operators import (
            MeasurementOperator,
        )

        self.cfg, self.device = cfg, device
        self.setup_split = watch = data.Stopwatch()
        img = cfg["imaging"]
        self.uvw, self.freqs = synth.observation(cfg)
        sky = data.Sky.of(cfg, seed)
        self.vis, self.wgt = data.stokes_i(cfg, seed, self.uvw, self.freqs,
                                           sky, device)
        watch.lap("data")
        self.npix = img["num_pixels"]
        self.pixel_lm = synth.pixel_size_lm(img["pixel_size_asec"])
        g = work.geometry(self.uvw, self.freqs, self.npix, self.pixel_lm,
                          epsilon=img["epsilon"], sigma=img["sigma"])
        self.bounds = work.cycle_bounds(g)
        centre = np.array([[self.npix // 2, self.npix // 2]])
        self.pixels = np.concatenate([centre, synth.sample_pixels(
            seed, self.npix, sky.pixels, cfg["check"]["sample_pixels"])])
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

        watch.lap("geometry")
        self.capture = Capture()
        self.capture.install()
        self.op = MeasurementOperator.build(
            self.uvw, self.freqs, self.wgt, self.npix, self.pixel_lm,
            epsilon=img["epsilon"], do_wstacking=img["do_wstacking"],
            sigma=img["sigma"], device=device)
        watch.lap("operator")
        self.slots = self.op.stage(self.vis)
        watch.lap("stage")
        self.step = build_major_cycle_step(
            self.op, gain=img["gain"], minor_iter=img["minor_iter"])
        self.model = torch.zeros((self.npix, self.npix), dtype=torch.float32,
                                 device=device)
        for _ in range(traffic["warmup_cycles"]):
            self._step()
        self.start_model = self.model.cpu().numpy()
        watch.lap("warmup")
        self.first_residual = None
        self.prev = None

    def _step(self) -> None:
        self.capture.dirty = None
        self.prev = self.model
        self.model = self.step(self.model, self.slots.re, self.slots.im)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def call(self) -> dict:
        self._step()
        if self.first_residual is None:
            px = torch.as_tensor(self.pixels, device=self.device)
            self.first_residual = self.capture.dirty[px[:, 0], px[:, 1]]
        return self.bounds

    def release(self) -> None:
        self.capture.remove()
        del self.op, self.slots, self.step
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference_images(self, models: list, dtype) -> np.ndarray:
        """(2 + len(models), P) at the sample pixels, each over the total
        weight: the dirty image, the residual image of each of
        ``models`` (the dirty image of the visibilities less the model's)
        and the PSF."""
        dev = self.device
        sparse = []
        for model in models:
            nz = np.argwhere(model != 0)
            sparse.append((nz, torch.as_tensor(model[nz[:, 0], nz[:, 1]],
                                               device=dev)))
        rows = self.cfg["observation"]["num_antennas"]
        rows = rows * (rows - 1) // 2
        w = torch.as_tensor(self.wgt, device=dev).double()
        batch = torch.empty((*w.shape, 2 + len(models)),
                            dtype=torch.complex128, device=dev)
        for r0 in range(0, len(self.uvw), rows):
            r = slice(r0, r0 + rows)
            v = torch.as_tensor(self.vis[r], device=dev).to(torch.complex128)
            batch[r, :, 0] = v * w[r]
            for k, (nz, values) in enumerate(sparse, start=1):
                m = (dft.model_visibilities(self.uvw[r], self.freqs, nz,
                                            values, self.npix, self.pixel_lm)
                     if len(nz) else 0.0)
                batch[r, :, k] = (v - m) * w[r]
            batch[r, :, -1] = w[r]
        out = dft.dirty_at(self.uvw, self.freqs, batch, self.pixels,
                           self.npix, self.pixel_lm, dtype=dtype)
        if dtype != torch.float64:
            return (out.to(dtype) / w.to(dtype).sum()).double().cpu().numpy()
        return (out / w.sum()).cpu().numpy()

    def check(self, limits: dict, control: bool = False) -> tuple:
        """``({name: (value, limit)}, failed)``. ``psf_err``: the PSF's
        widest gap at the sample pixels over its centre; ``res_err`` and
        ``last_res_err``: the first and the last step's residual image's
        widest gap there over the dirty image's largest value;
        ``minor_err``: the last step's model update's widest gap from
        plain Hogbom's over Hogbom's largest component."""
        img = self.cfg["imaging"]
        models = [self.start_model, self.prev.cpu().numpy()]
        print(f"components: {int((models[0] != 0).sum())} in the first "
              f"step's model, {int((models[1] != 0).sum())} in the last's",
              file=sys.stderr)
        dirty, res, last_res, psf = self._reference_images(models,
                                                           torch.float64)
        px = torch.as_tensor(self.pixels, device=self.device)
        kw = dict(gain=img["gain"], max_iter=img["minor_iter"],
                  psf_patch=img["minor_psf_patch"])
        delta, _ = clean.hogbom(self.capture.dirty, self.capture.psf, **kw)
        expected = self.prev + delta
        if control:
            _, got_res, got_last, got_psf = self._reference_images(
                models, torch.bfloat16)
            low, _ = clean.hogbom(self.capture.dirty, self.capture.psf,
                                  dtype=torch.bfloat16, **kw)
            got_model = self.prev + low
        else:
            got_psf = self.capture.psf[px[:, 0], px[:, 1]].double().cpu()
            got_psf = got_psf.numpy()
            got_res = self.first_residual.double().cpu().numpy()
            got_last = self.capture.dirty[px[:, 0], px[:, 1]]
            got_last = got_last.double().cpu().numpy()
            got_model = self.model
        gaps = {
            "psf_err": float(np.abs(got_psf - psf).max() / abs(psf[0])),
            "res_err": float(np.abs(got_res - res).max()
                             / np.abs(dirty).max()),
            "last_res_err": float(np.abs(got_last - last_res).max()
                                  / np.abs(dirty).max()),
            "minor_err": float((got_model - expected).abs().max()
                               / delta.abs().max()),
        }
        checks = {k: (v, limits[k]) for k, v in gaps.items()}
        return checks, int(any(v > limits[k] for k, v in gaps.items()))

    def close(self) -> None:
        self.capture.remove()


def setup(cfg: dict, traffic: dict, seed: int, device) -> Cell:
    return Cell(cfg, traffic, seed, device)
