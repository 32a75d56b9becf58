"""
Traffic ``sharded_cycle``: Hogbom major cycles of the whole job over the
program's sharded path, every rank of the cell's world in lockstep, one
shard a rank. Set-up joins the program's world
(``parallel/mesh.py:initialize_distributed``, from the ranks'
environment, or a world of one), builds the mesh of the configuration's
``sharding.devices`` shards on this rank's device, makes this rank's
shards in memory (shard i is channel chunk i of ``freq_chunks``, every
dump, its noise, flags and weights drawn on the device from ``(seed,
i)``), stages them through ``parallel/sharded_invert.py:
stage_loaded_shards`` (the CLI's code from the weights on: sigma and
w range from the global count, planning, padding, staging), builds the
``ShardedOperator`` and

    build_sharded_major_cycle_step(operator, gain=..., minor_iter=...)

(the PSF), images the dirty image and runs ``warmup_cycles`` steps.
Each call is one step, ``(model, residual) -> (model', residual')``,
followed by ``torch.cuda.synchronize()``.

The check is the cycle cell's (``drivers/cycle.py``) over the whole job:
the PSF and the residual images of the window's first and last steps at
the sample pixels against the float64 DFT of all the job's
visibilities, which each rank sums over its own shards (weighted data,
data less each model's visibilities, weights) and the ranks add with
``torch.distributed.all_reduce`` on CPU float64 tensors (the library's
collective, not the program's mesh) before dividing by the global
weight; the last minor cycle against plain Hogbom on the residual and
PSF this rank's program handed it; and ``rank_model_err``, the widest
gap between this rank's final model and rank 0's (every rank gets the
same reduced residual and makes the same update, so ranks that drift
apart are a fault).
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from .. import data, synth, work, work_sharded
from ..reference import clean, dft
from .cycle import Capture

UNIT = "cycle"


def shard_seed(seed: int, shard: int) -> int:
    """The seed of shard ``shard``'s noise, flags and weights."""
    state = np.random.SeedSequence([seed % 2**64, shard]).generate_state(
        1, np.uint64)
    return int(state[0])


def channel_chunks(num_channels: int, freq_chunks: int) -> list:
    """The channel indices of each frequency chunk (the reference's
    balanced chunks, equal where ``freq_chunks`` divides the band)."""
    if num_channels % freq_chunks:
        raise ValueError(f"{freq_chunks} chunks do not divide "
                         f"{num_channels} channels evenly")
    return np.split(np.arange(num_channels), freq_chunks)


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from ska_sdp_cip_tpu_torch.invert import StokesIGridderInput
        from ska_sdp_cip_tpu_torch.parallel.mesh import (
            backend_for,
            initialize_distributed,
            make_device_mesh,
        )
        from ska_sdp_cip_tpu_torch.parallel.sharded_clean import (
            ShardedOperator,
            build_sharded_major_cycle_step,
        )
        from ska_sdp_cip_tpu_torch.parallel.sharded_invert import (
            stage_loaded_shards,
        )

        self.cfg, self.device = cfg, device
        self.setup_split = watch = data.Stopwatch()
        img, sharding = cfg["imaging"], cfg["sharding"]
        if sharding["row_chunks"] != 1:
            raise ValueError("the driver shards the band only "
                             "(row_chunks 1)")
        self.own_world = not dist.is_initialized()
        initialize_distributed(backend=backend_for(device))
        self.mesh = make_device_mesh(sharding["devices"], device=device)
        self.rank = self.mesh.rank
        watch.lap("world")

        self.uvw, freqs = synth.observation(cfg)
        chunks = channel_chunks(len(freqs), sharding["freq_chunks"])
        if len(chunks) != self.mesh.num_shards:
            raise ValueError(f"{len(chunks)} channel chunks for "
                             f"{self.mesh.num_shards} shards")
        sky = data.Sky.of(cfg, seed)
        self.shards = {}
        for index in self.mesh.addressable_shard_indices:
            f = freqs[chunks[index]]
            vis, wgt = data.stokes_i(cfg, shard_seed(seed, index), self.uvw,
                                     f, sky, device)
            self.shards[index] = StokesIGridderInput(
                channel_frequencies=f, flags=np.zeros(vis.shape, bool),
                uvw=self.uvw, visibilities=vis, weights=wgt)
        watch.lap("data")
        self.npix = img["num_pixels"]
        self.pixel_lm = synth.pixel_size_lm(img["pixel_size_asec"])
        num_visibilities = len(self.uvw) * len(freqs)
        geometries = work_sharded.shard_geometries(
            self.uvw, freqs, [s.channel_frequencies
                              for s in self.shards.values()],
            self.npix, self.pixel_lm, epsilon=img["epsilon"],
            sigma=img["sigma"], num_visibilities=num_visibilities)
        self.geometries = geometries
        self.bounds = {}
        for g in geometries:
            for k, v in work.cycle_bounds(g).items():
                self.bounds[k] = self.bounds.get(k, 0.0) + v
        centre = np.array([[self.npix // 2, self.npix // 2]])
        self.pixels = np.concatenate([centre, synth.sample_pixels(
            seed, self.npix, sky.pixels, cfg["check"]["sample_pixels"])])
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        watch.lap("geometry")

        self.capture = Capture()
        self.capture.install()
        staging = stage_loaded_shards(
            self.shards, num_visibilities, self.npix,
            img["pixel_size_asec"], mesh=self.mesh, epsilon=img["epsilon"],
            do_wstacking=img["do_wstacking"], weighting=img["weighting"],
            sigma=img["sigma"],
            common_w_grid=sharding["fft_mode"] == "distributed")
        #: (sigma, support, ngrid, nplanes) of each shard's plan, padded.
        self.plan_geometry = [(p.sigma, p.support, p.ngrid, p.nplanes)
                              for p in staging.plans]
        watch.lap("stage")
        self.op = ShardedOperator(staging, sharding["fft_mode"])
        self.step = build_sharded_major_cycle_step(
            self.op, gain=img["gain"], minor_iter=img["minor_iter"])
        self.residual = self.op.dirty()
        self.model = torch.zeros((self.npix, self.npix), dtype=torch.float32,
                                 device=device)
        watch.lap("operator")
        for _ in range(traffic["warmup_cycles"]):
            self._step()
        self.start_model = self.model.cpu().numpy()
        watch.lap("warmup")
        self.first_residual = None
        self.prev = None

    def _step(self) -> None:
        self.capture.dirty = None
        self.prev = self.model
        self.model, self.residual = self.step(self.model, self.residual)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self) -> dict:
        self._step()
        if self.first_residual is None:
            px = torch.as_tensor(self.pixels, device=self.device)
            self.first_residual = self.capture.dirty[px[:, 0], px[:, 1]]
        return self.bounds

    def release(self) -> None:
        self.capture.remove()
        del self.op, self.step, self.residual
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _partial_sums(self, models: list, dtype) -> tuple:
        """This rank's part of the reference images at the sample
        pixels: ``(sums, weight)``, ``sums`` (2 + len(models), P) the
        unnormalized dirty image, residual images of ``models`` and PSF
        of this rank's shards, ``weight`` their total weight, each
        rounded to ``dtype``."""
        dev = self.device
        sparse = []
        for model in models:
            nz = np.argwhere(model != 0)
            sparse.append((nz, torch.as_tensor(model[nz[:, 0], nz[:, 1]],
                                               device=dev)))
        rows = self.cfg["observation"]["num_antennas"]
        rows = rows * (rows - 1) // 2
        sums = torch.zeros((2 + len(models), len(self.pixels)),
                           dtype=torch.float64)
        weight = torch.zeros((), dtype=torch.float64)
        for shard in self.shards.values():
            freqs = shard.channel_frequencies
            w = torch.as_tensor(shard.weights, device=dev).double()
            batch = torch.empty((*w.shape, 2 + len(models)),
                                dtype=torch.complex128, device=dev)
            for r0 in range(0, len(self.uvw), rows):
                r = slice(r0, r0 + rows)
                v = torch.as_tensor(shard.visibilities[r],
                                    device=dev).to(torch.complex128)
                batch[r, :, 0] = v * w[r]
                for k, (nz, values) in enumerate(sparse, start=1):
                    m = (dft.model_visibilities(self.uvw[r], freqs, nz,
                                                values, self.npix,
                                                self.pixel_lm)
                         if len(nz) else 0.0)
                    batch[r, :, k] = (v - m) * w[r]
                batch[r, :, -1] = w[r]
            out = dft.dirty_at(self.uvw, freqs, batch, self.pixels,
                               self.npix, self.pixel_lm, dtype=dtype)
            del batch
            sums += out.to(dtype).double().cpu()
            weight += w.to(dtype).sum().double().cpu()
        return sums, weight

    def _reference_images(self, models: list, dtype) -> np.ndarray:
        """(2 + len(models), P): the images of the whole job at the
        sample pixels over its total weight, the ranks' partial sums
        added by ``all_reduce``."""
        sums, weight = self._partial_sums(models, dtype)
        both = torch.cat([sums.reshape(-1), weight.reshape(1)])
        dist.all_reduce(both)
        sums, weight = both[:-1].reshape(sums.shape), both[-1]
        if dtype != torch.float64:
            return (sums.to(dtype) / weight.to(dtype)).double().numpy()
        return (sums / weight).numpy()

    def _rank_gap(self) -> float:
        """The widest gap between this rank's final model and rank
        0's."""
        first = self.model.clone()
        dist.broadcast(first, src=0)
        return float((self.model - first).abs().max())

    def check(self, limits: dict, control: bool = False) -> tuple:
        """``({name: (value, limit)}, failed)``: ``psf_err``, ``res_err``,
        ``last_res_err`` and ``minor_err`` as in ``drivers/cycle.py``, over
        the whole job's visibilities; ``rank_model_err``, the widest gap
        between this rank's final model and rank 0's."""
        img = self.cfg["imaging"]
        models = [self.start_model, self.prev.cpu().numpy()]
        print(f"rank {self.rank}: components: "
              f"{int((models[0] != 0).sum())} in the first step's model, "
              f"{int((models[1] != 0).sum())} in the last's",
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
            "rank_model_err": self._rank_gap(),
        }
        checks = {k: (v, limits[k]) for k, v in gaps.items()}
        return checks, int(any(v > limits[k] for k, v in gaps.items()))

    def close(self) -> None:
        from ska_sdp_cip_tpu_torch.parallel.mesh import shutdown_distributed

        self.capture.remove()
        if self.own_world:
            shutdown_distributed()


def setup(cfg: dict, traffic: dict, seed: int, device) -> Cell:
    return Cell(cfg, traffic, seed, device)
