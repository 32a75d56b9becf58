"""
Traffic ``snapshot``: one full-resolution dirty image a dump, as a
transient search makes them. Set-up makes every dump's Stokes-I
visibilities and weights on the host; call i images dump ``(i *
dump_step) mod num_dumps`` with

    dirty_image(uvw_d, freqs, vis_d, weights_d, npix, pixel, ...)

``dump_step`` is coprime to the number of dumps, so that the order
visits every dump once before any twice, and near the golden section of
it, so that any prefix of the order spreads over the whole hour: a
faster program images more dumps, not other ones. Set-up images the
``warmup_calls`` dumps of the most w-planes.

Each image is kept at the check's sample pixels; after the window a
sample of the images, drawn from the seed, with the last among them, is
compared there with the DFT of its dump.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import data, synth, work
from ..reference import dft

UNIT = "image"


def dump_order(num_dumps: int, step: int) -> np.ndarray:
    """The dump of each call, ``(i * step) mod num_dumps``."""
    if math.gcd(step, num_dumps) != 1:
        raise ValueError(f"dump_step {step} shares a factor with "
                         f"{num_dumps} dumps")
    return np.arange(num_dumps) * step % num_dumps


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = (
            cfg, traffic, seed, device)
        self.setup_split = watch = data.Stopwatch()
        img, obs = cfg["imaging"], cfg["observation"]
        self.uvw, self.freqs = synth.observation(cfg)
        sky = data.Sky.of(cfg, seed)
        self.vis, self.wgt = data.stokes_i(cfg, seed, self.uvw, self.freqs,
                                           sky, device)
        watch.lap("data")
        self.rows = obs["num_antennas"] * (obs["num_antennas"] - 1) // 2
        self.num_dumps = obs["num_dumps"]
        self.npix = img["num_pixels"]
        self.pixel_lm = synth.pixel_size_lm(img["pixel_size_asec"])
        self.order = dump_order(self.num_dumps, traffic["dump_step"])
        geometry = [
            work.geometry(self.uvw[self._rows(d)], self.freqs, self.npix,
                          self.pixel_lm, epsilon=img["epsilon"],
                          sigma=img["sigma"])
            for d in range(self.num_dumps)
        ]
        self.bounds = [work.invert_bounds(g) for g in geometry]
        planes = np.array([g.nplanes for g in geometry])
        self.pixels = synth.sample_pixels(seed, self.npix, sky.pixels,
                                          cfg["check"]["sample_pixels"])
        self.samples = []
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        watch.lap("geometry")
        for d in np.argsort(-planes, kind="stable")[:traffic["warmup_calls"]]:
            self._image(int(d))
        watch.lap("warmup")

    def _rows(self, d: int) -> slice:
        return slice(d * self.rows, (d + 1) * self.rows)

    def call(self) -> dict:
        d = int(self.order[len(self.samples) % self.num_dumps])
        image = self._image(d)
        self.samples.append(np.asarray(
            image[self.pixels[:, 0], self.pixels[:, 1]], np.float64))
        return self.bounds[d]

    def _image(self, d: int) -> np.ndarray:
        from ska_sdp_cip_tpu_torch.ops.gridder import dirty_image

        img = self.cfg["imaging"]
        r = self._rows(d)
        return dirty_image(
            self.uvw[r], self.freqs, self.vis[r], self.wgt[r], self.npix,
            self.pixel_lm, epsilon=img["epsilon"],
            do_wstacking=img["do_wstacking"], sigma=img["sigma"],
            device=self.device,
        )

    def release(self) -> None:
        pass

    def check(self, limits: dict, control: bool = False) -> tuple:
        """``({name: (value, limit)}, failed)``: the widest gap at the
        sample pixels between an image and the DFT of its dump, over the
        DFT's largest value there, across the sampled images."""
        n = len(self.samples)
        rng = np.random.default_rng([self.seed, 3])
        picked = set(rng.choice(n, size=min(self.traffic["check_images"], n),
                                replace=False).tolist()) | {n - 1}
        errs = []
        for i in sorted(picked):
            r = self._rows(int(self.order[i % self.num_dumps]))
            weighted = torch.as_tensor(
                self.vis[r].astype(np.complex128) * self.wgt[r],
                device=self.device)[..., None]
            ref = dft.dirty_at(self.uvw[r], self.freqs, weighted, self.pixels,
                               self.npix, self.pixel_lm)[0].cpu().numpy()
            if control:
                got = dft.dirty_at(self.uvw[r], self.freqs, weighted,
                                   self.pixels, self.npix, self.pixel_lm,
                                   dtype=torch.bfloat16)[0].cpu().numpy()
            else:
                got = self.samples[i]
            errs.append(float(np.abs(got - ref).max() / np.abs(ref).max()))
        limit = limits["img_err"]
        return ({"img_err": (max(errs), limit)},
                sum(e > limit for e in errs))

    def close(self) -> None:
        pass


def setup(cfg: dict, traffic: dict, seed: int, device) -> Cell:
    return Cell(cfg, traffic, seed, device)
