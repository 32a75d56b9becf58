"""
Traffic ``image``: a one-shot dirty image of a node's averaged share of
the observation from a VZ on local disk, as the reference's ``invert``
images an MS chunk. Set-up makes the Stokes-I visibilities and weights
of every ``dump_stride``-th dump (``data.stokes_i``) and writes them with
the program's ``write_vz_dataset`` into a folder under ``TMPDIR`` as four
correlations (XX and YY each the Stokes-I value, XY and YX zero, each of
XX and YY weighted half the Stokes-I weight, every correlation of a
flagged visibility flagged), then fsyncs every file. Each call reads
the dataset through the page cache (dropping its pages first spread the
runs more, and on an H100 host the read took as long either way):

    invert_dataset(VisibilityReader(path), npix, asec, epsilon=...,
                   do_wstacking=..., sigma=..., device=...)

Set-up runs ``warmup_calls`` calls. The check, ``img_err``: the window's
first and last images at the sample pixels against the float64 DFT of
the written visibilities (their Stokes-I values and weights), over the
DFT's largest value there.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from .. import data, synth, work
from ..reference import dft

UNIT = "image"


def dump_rows(num_dumps: int, baselines: int, stride: int) -> np.ndarray:
    """The rows of dumps 0, stride, 2 stride, ..."""
    dumps = np.arange(0, num_dumps, stride)
    return (dumps[:, None] * baselines + np.arange(baselines)).reshape(-1)


def write_dataset(path: Path, uvw, freqs, vis, wgt) -> list:
    """The VZ of Stokes-I ``vis`` and effective weights ``wgt``, fsynced;
    returns its files."""
    from ska_sdp_cip_tpu_torch.io.visibility_dataset import write_vz_dataset

    rows, chans = vis.shape
    pols = np.zeros((rows, chans, 4), np.complex64)
    pols[..., 0] = pols[..., 3] = vis
    half = np.zeros((rows, chans, 4), np.float32)
    half[..., 0] = half[..., 3] = wgt / 2
    flags = np.broadcast_to((wgt == 0)[..., None], (rows, chans, 4))
    write_vz_dataset(path, uvw=uvw, visibilities=pols, flags=flags,
                     channel_frequencies=freqs, weight_spectrum=half)
    files = sorted(p for p in path.iterdir() if p.is_file())
    for f in files:
        fd = os.open(f, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    return files


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.setup_split = watch = data.Stopwatch()
        img, obs = cfg["imaging"], cfg["observation"]
        uvw, self.freqs = synth.observation(cfg)
        baselines = obs["num_antennas"] * (obs["num_antennas"] - 1) // 2
        self.uvw = uvw[dump_rows(obs["num_dumps"], baselines,
                                 traffic["dump_stride"])]
        sky = data.Sky.of(cfg, seed)
        self.vis, self.wgt = data.stokes_i(cfg, seed, self.uvw, self.freqs,
                                           sky, device)
        watch.lap("data")
        self.npix = img["num_pixels"]
        self.pixel_lm = synth.pixel_size_lm(img["pixel_size_asec"])
        self.bounds = work.invert_bounds(work.geometry(
            self.uvw, self.freqs, self.npix, self.pixel_lm,
            epsilon=img["epsilon"], sigma=img["sigma"]))
        self.pixels = synth.sample_pixels(seed, self.npix, sky.pixels,
                                          cfg["check"]["sample_pixels"])
        watch.lap("geometry")
        self.folder = Path(tempfile.mkdtemp(prefix="cipbench-image-"))
        self.path = self.folder / "obs.vz"
        write_dataset(self.path, self.uvw, self.freqs, self.vis, self.wgt)
        watch.lap("write")
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.first = self.last = None
        for _ in range(traffic["warmup_calls"]):
            self._image()
        watch.lap("warmup")

    def _image(self) -> np.ndarray:
        from ska_sdp_cip_tpu_torch.invert import invert_dataset
        from ska_sdp_cip_tpu_torch.io.visibility_dataset import (
            VisibilityReader,
        )

        img = self.cfg["imaging"]
        image = invert_dataset(
            VisibilityReader(self.path), self.npix, img["pixel_size_asec"],
            epsilon=img["epsilon"], do_wstacking=img["do_wstacking"],
            sigma=img["sigma"], device=self.device)
        return np.asarray(image[self.pixels[:, 0], self.pixels[:, 1]],
                          np.float64)

    def call(self) -> dict:
        self.last = self._image()
        if self.first is None:
            self.first = self.last
        return self.bounds

    def release(self) -> None:
        pass

    def check(self, limits: dict, control: bool = False) -> tuple:
        """``({"img_err": (value, limit)}, failed)``: the widest gap of
        the first and the last image from the DFT."""
        w = torch.as_tensor(self.wgt, device=self.device).double()
        weighted = (torch.as_tensor(self.vis, device=self.device)
                    .to(torch.complex128) * w)[..., None]
        ref = dft.dirty_at(self.uvw, self.freqs, weighted, self.pixels,
                           self.npix, self.pixel_lm)[0].cpu().numpy()
        ref = ref / float(w.sum())
        if control:
            low = dft.dirty_at(self.uvw, self.freqs, weighted, self.pixels,
                               self.npix, self.pixel_lm,
                               dtype=torch.bfloat16)[0].cpu().numpy()
            images = [low / float(w.sum())]
        else:
            images = [self.first, self.last]
        errs = [float(np.abs(got - ref).max() / np.abs(ref).max())
                for got in images]
        limit = limits["img_err"]
        return {"img_err": (max(errs), limit)}, sum(e > limit for e in errs)

    def close(self) -> None:
        shutil.rmtree(self.folder, ignore_errors=True)


def setup(cfg: dict, traffic: dict, seed: int, device) -> Cell:
    return Cell(cfg, traffic, seed, device)
