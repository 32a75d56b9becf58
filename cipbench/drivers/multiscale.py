"""
Traffic ``multiscale``: major cycles of multiscale CLEAN over the node's
whole share, on Briggs weights, on the card, with no host round trip.
Set-up makes the visibilities of the extended sky (``extended.py``),
fits Briggs weights with the program's ``ImagingWeighter``, makes the
weighted dirty image as ``tpu-cip-torch --clean`` writes it beside the
model (``ops.gridder.dirty_image``), builds the measurement operator on
the weights, stages the visibilities, builds the step and runs
``warmup_cycles`` cycles; each call is one step of

    build_multiscale_cycle_step(operator, scales=..., bias_slope=...,
                                gain=..., minor_iter=..., psf_patch=...)

followed by ``torch.cuda.synchronize()``. A program without
``build_multiscale_cycle_step`` fails before any data is made.

The check holds each stage of a step against the plain reference at the
timed sizes, in the manner of ``cycle.py``, the reference weights being
the plain Briggs weights (``reference/weighting.py``):

* ``weight_err``: the program's Briggs weights against the reference's,
  over every visibility (the widest relative gap; a weight that should
  be zero and is not counts 1);
* ``psf_err``, ``dirty_err``, ``res_err``, ``last_res_err``: the PSF, the
  dirty image, and the residual images the window's first and last
  steps hand their minor cycles, at the sample pixels, against DFTs of
  the reference weights (over the PSF's centre and the dirty image's
  largest value);
* ``frame_err``: the last step's S scale frames, as the program made
  them, against float64 convolutions of the residual it handed its
  minor cycle, at the sample pixels of every scale, over the residual's
  largest value;
* ``cross_psf_err``: the cross-PSF patches against float64 convolutions
  of the PSF's window with the reference's own scale kernels, at the
  patch's centre and 48 offsets from the seed, over the largest cross
  PSF there;
* ``minor_err``: the last step's model update against the plain minor
  cycle run on the program's frames and cross PSFs, over its largest
  component.

What the check reads of the program is captured by wrappers on
``models.multiscale.prepare_multiscale_minor`` (the PSF and the built
minor cycle: kept as they are) and ``_scale_frames`` (the residual, kept,
and a copy of the frames before the minor loop changes them: one device
copy a cycle, outside the program's spans). The controls: the reference
in the program's place in bfloat16, except ``frame_err``'s, a TF32
convolution.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import data, extended, synth, work
from ..reference import dft
from ..reference import multiscale as ref_ms
from ..reference import weighting as ref_w
from ..trace import resolve
from ..work_multiscale import scale_conv_bound

UNIT = "cycle"
PROGRAM = "ska_sdp_cip_tpu_torch.models.multiscale"
STEP = PROGRAM + ":build_multiscale_cycle_step"
PREPARE = PROGRAM + ":prepare_multiscale_minor"
FRAMES = PROGRAM + ":_scale_frames"


class Capture:
    """The PSF and minor cycle a step was built with, and the residual
    and frames of the last minor cycle."""

    def __init__(self):
        self.psf = self.minor = self.residual = self.frames = None
        self._undo = []

    def install(self) -> None:
        owner, name, prepare = resolve(PREPARE)

        def prepare_minor(psf, *args, **kwargs):
            self.psf = psf
            self.minor = prepare(psf, *args, **kwargs)
            return self.minor

        _, fname, frames_of = resolve(FRAMES)

        def scale_frames(residual, *args, **kwargs):
            frames = frames_of(residual, *args, **kwargs)
            self.residual = residual
            if self.frames is None or self.frames.shape != frames.shape:
                self.frames = torch.empty_like(frames)
            self.frames.copy_(frames)
            return frames

        for attr, raw, new in ((name, prepare, prepare_minor),
                               (fname, frames_of, scale_frames)):
            setattr(owner, attr, new)
            self._undo.append((owner, attr, raw))

    def remove(self) -> None:
        for owner, name, raw in reversed(self._undo):
            setattr(owner, name, raw)
        self._undo.clear()


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        if resolve(STEP) is None:
            raise SystemExit("the program has no " + STEP)
        from ska_sdp_cip_tpu_torch.models.multiscale import (
            build_multiscale_cycle_step,
        )
        from ska_sdp_cip_tpu_torch.models.operators import (
            MeasurementOperator,
        )
        from ska_sdp_cip_tpu_torch.models.weighting import ImagingWeighter
        from ska_sdp_cip_tpu_torch.ops import gridder

        self.cfg, self.seed, self.device = cfg, seed, device
        self.setup_split = watch = data.Stopwatch()
        img = cfg["imaging"]
        self.uvw, self.freqs = synth.observation(cfg)
        sky = extended.ExtendedSky.of(cfg, seed)
        self.vis, self.natural = extended.stokes_i(cfg, seed, self.uvw,
                                                   self.freqs, sky, device)
        watch.lap("data")
        self.npix = img["num_pixels"]
        self.pixel_lm = synth.pixel_size_lm(img["pixel_size_asec"])
        g = work.geometry(self.uvw, self.freqs, self.npix, self.pixel_lm,
                          epsilon=img["epsilon"], sigma=img["sigma"])
        self.bounds = {**work.cycle_bounds(g), "scale_conv":
                       scale_conv_bound(self.npix, img["scales"])}
        centre = np.array([[self.npix // 2, self.npix // 2]])
        self.pixels = np.concatenate([centre, synth.sample_pixels(
            seed, self.npix, sky.pixels, cfg["check"]["sample_pixels"])])
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        watch.lap("geometry")
        self.wgt = ImagingWeighter(
            self.npix, self.pixel_lm, scheme=img["weighting"],
            robust=img["robust"],
        ).fit(self.uvw, self.freqs, self.natural).apply(
            self.uvw, self.freqs, self.natural)
        watch.lap("weights")
        dirty = gridder.dirty_image(
            self.uvw, self.freqs, self.vis, self.wgt, self.npix,
            self.pixel_lm, epsilon=img["epsilon"],
            do_wstacking=img["do_wstacking"], sigma=img["sigma"],
            device=device)
        self.dirty = np.asarray(dirty[self.pixels[:, 0], self.pixels[:, 1]],
                                np.float64) / float(np.sum(self.wgt,
                                                           dtype=np.float64))
        del dirty
        watch.lap("dirty_image")
        self.capture = Capture()
        self.capture.install()
        self.op = MeasurementOperator.build(
            self.uvw, self.freqs, self.wgt, self.npix, self.pixel_lm,
            epsilon=img["epsilon"], do_wstacking=img["do_wstacking"],
            sigma=img["sigma"], device=device)
        watch.lap("operator")
        self.slots = self.op.stage(self.vis)
        watch.lap("stage")
        self.step = build_multiscale_cycle_step(
            self.op, scales=tuple(img["scales"]),
            bias_slope=img["bias_slope"], gain=img["gain"],
            minor_iter=img["minor_iter"], psf_patch=img["minor_psf_patch"])
        watch.lap("step")
        self.model = torch.zeros((self.npix, self.npix), dtype=torch.float32,
                                 device=device)
        self.prev = None
        for _ in range(traffic["warmup_cycles"]):
            self._step()
        self.start_model = self.model.cpu().numpy()
        watch.lap("warmup")
        self.first_residual = None

    def _step(self) -> None:
        self.prev = self.model
        self.model = self.step(self.model, self.slots.re, self.slots.im)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def call(self) -> dict:
        self._step()
        if self.first_residual is None:
            px = torch.as_tensor(self.pixels, device=self.device)
            self.first_residual = self.capture.residual[px[:, 0], px[:, 1]]
        return self.bounds

    def release(self) -> None:
        self.capture.remove()
        del self.op, self.slots, self.step
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------

    def _reference_images(self, w: torch.Tensor, models: list,
                          dtype) -> np.ndarray:
        """(2 + len(models), P) at the sample pixels, each over the total
        weight ``w``: the dirty image, the residual image of each of
        ``models`` and the PSF (``cycle.py``'s, on these weights)."""
        dev = self.device
        sparse = []
        for model in models:
            nz = np.argwhere(model != 0)
            sparse.append((nz, torch.as_tensor(model[nz[:, 0], nz[:, 1]],
                                               device=dev)))
        rows = self.cfg["observation"]["num_antennas"]
        rows = rows * (rows - 1) // 2
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

    def _weight_err(self, want: torch.Tensor, control: bool) -> float:
        img = self.cfg["imaging"]
        if control:
            got = ref_w.briggs(self.uvw, self.freqs, want.new_tensor(
                self.natural), self.npix, self.pixel_lm, img["robust"],
                dtype=torch.bfloat16)
        else:
            got = torch.as_tensor(self.wgt, device=self.device).double()
        nonzero = want > 0
        gap = torch.where(nonzero, (got - want).abs() / torch.where(
            nonzero, want, torch.ones_like(want)), (got != 0).double())
        return float(gap.max())

    def _cross_psf_err(self, control: bool) -> float:
        """The cross PSFs at the patch's centre and 48 offsets drawn from
        the seed, over the largest there, against the reference's own
        float64 scale kernels."""
        img = self.cfg["imaging"]
        minor, psf = self.capture.minor, self.capture.psf
        kernels = ref_ms.kernels_and_biases(img["scales"], img["bias_slope"],
                                            self.device, torch.float64)[0]
        S, k = kernels.shape[0], kernels.shape[-1]
        n = self.npix
        if minor.psf_patch is not None:
            P = minor.psf_patch
            M = P + 2 * k
            start = n // 2 - M // 2
            window, crop = psf[start : start + M, start : start + M], (k, P)
        else:
            P, window, crop = n, psf, None
        want = ref_ms.cross_psfs(window.double(), kernels, crop)
        if control:
            got = ref_ms.cross_psfs(
                window.to(torch.bfloat16).double(),
                kernels.to(torch.bfloat16).double(), crop).to(torch.bfloat16)
        else:
            got = -minor.neg_cross.reshape(S, S, P, P)
        rng = np.random.default_rng([self.seed, 5])
        at = np.concatenate([[[P // 2, P // 2]],
                             rng.integers(0, P, size=(48, 2))])
        a = torch.as_tensor(at[:, 0], device=want.device)
        b = torch.as_tensor(at[:, 1], device=want.device)
        want_at = want[:, :, a, b]
        got_at = got[:, :, a, b].double()
        return float((got_at - want_at).abs().max() / want_at.abs().max())

    def check(self, limits: dict, control: bool = False) -> tuple:
        """``({name: (value, limit)}, failed)``; the numbers are the
        module's docstring's."""
        from ska_sdp_cip_tpu_torch.utils import task_metrics

        img = self.cfg["imaging"]
        dev = self.device
        picks = {k: v for k, v in task_metrics.summary()["counters"].items()
                 if k.startswith("multiscale_picks.")}
        models = [self.start_model, self.prev.cpu().numpy()]
        print(f"components: {int((models[0] != 0).sum())} in the first "
              f"step's model, {int((models[1] != 0).sum())} in the last's; "
              f"picks by scale (traced runs): {picks}", file=sys.stderr)
        natural = torch.as_tensor(self.natural, device=dev)
        w = ref_w.briggs(self.uvw, self.freqs, natural, self.npix,
                         self.pixel_lm, img["robust"])
        gaps = {"weight_err": self._weight_err(w, control)}
        del natural
        dirty, res, last_res, psf = self._reference_images(w, models,
                                                           torch.float64)
        px = torch.as_tensor(self.pixels, device=dev)
        residual = self.capture.residual
        frames, minor = self.capture.frames, self.capture.minor
        S = minor.kernels.shape[0]
        pad = (frames.shape[-1] - self.npix) // 2
        kernels = minor.kernels
        want_frames = torch.stack([
            ref_ms.conv_at(residual, ref_kernel, self.pixels)
            for ref_kernel in ref_ms.kernels_and_biases(
                img["scales"], img["bias_slope"], dev, torch.float64)[0]])
        ref_k, ref_b = ref_ms.kernels_and_biases(img["scales"],
                                                 img["bias_slope"], dev)
        P = minor.psf_patch or self.npix
        block = (ref_ms.minor_block(self.npix, P)
                 if minor.psf_patch is not None else None)
        neg = minor.neg_cross.reshape(S, S, P, P)
        kw = dict(npix=self.npix, gain=img["gain"],
                  max_iter=img["minor_iter"], block=block)
        if control:
            got_dirty, got_res, got_last, got_psf = self._reference_images(
                w, models, torch.bfloat16)
            got_frames = torch.stack([
                ref_ms.conv_at(residual, kernels[s], self.pixels, "tf32")
                for s in range(S)])
            delta, _ = ref_ms.minor(frames, neg, ref_k, ref_b, **kw)
            low, _ = ref_ms.minor(frames, neg, ref_k, ref_b,
                                  dtype=torch.bfloat16, **kw)
            got_model = self.prev + low
        else:
            got_psf = self.capture.psf[px[:, 0], px[:, 1]].double().cpu()
            got_psf = got_psf.numpy()
            got_dirty = self.dirty
            got_res = self.first_residual.double().cpu().numpy()
            got_last = residual[px[:, 0], px[:, 1]].double().cpu().numpy()
            got_frames = frames[:, pad + px[:, 0], pad + px[:, 1]].double()
            delta, _ = ref_ms.minor(frames, neg, ref_k, ref_b, **kw)
            got_model = self.model
        expected = self.prev + delta
        scale = float(residual.abs().max())
        gaps.update({
            "psf_err": float(np.abs(got_psf - psf).max() / abs(psf[0])),
            "dirty_err": float(np.abs(got_dirty - dirty).max()
                               / np.abs(dirty).max()),
            "res_err": float(np.abs(got_res - res).max()
                             / np.abs(dirty).max()),
            "last_res_err": float(np.abs(got_last - last_res).max()
                                  / np.abs(dirty).max()),
            "frame_err": float((got_frames - want_frames).abs().max()
                               / scale),
            "cross_psf_err": self._cross_psf_err(control),
            "minor_err": float((got_model - expected).abs().max()
                               / delta.abs().max()),
        })
        checks = {k: (v, limits[k]) for k, v in gaps.items()}
        return checks, int(any(v > limits[k] for k, v in gaps.items()))

    def close(self) -> None:
        self.capture.remove()


def setup(cfg: dict, traffic: dict, seed: int, device) -> Cell:
    return Cell(cfg, traffic, seed, device)
