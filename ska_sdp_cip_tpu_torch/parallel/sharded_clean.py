"""
Distributed major-cycle deconvolution.

Counterpart: ``ska_sdp_cip_tpu/parallel/sharded_clean.py``
(``sharded_major_cycle_clean``, ``_sharded_fista``). Every shard
predicts its model visibilities, forms the weighted residual in slot
space and grids it; the partial images (or, in the distributed FFT
mode, the partial plane grids) are summed over the mesh, and the minor
cycle runs on the reduced residual, which every rank holds whole — so
the model update is the same on every rank and no host round trip
happens inside a cycle. A Hogbom cycle is one step of
:func:`build_sharded_major_cycle_step`; the host loop sequences the
cycles and the checkpoints.

Spans and counters (``utils/task_metrics.py``): ``sharded.residual``
(device) around :meth:`ShardedOperator.residual`, this rank's predicts,
slot residuals and inverts and the image psum (``collective.all_reduce``
inside it, ``parallel/mesh.py``), with the counters
``shard_visibilities`` (this rank's staged visibilities) and
``useful_visits`` (``ops/gridder.py:useful_slot_visits``, against the
inverts' ``slot_visits``) once a residual; ``sharded.step`` (host)
around a step.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from ..io.visibility_dataset import VisibilityReader
from ..models import clean
from ..ops.gridder import build_predict, slot_group_sum, useful_slot_visits
from ..utils.task_metrics import count, enabled, span
from .mesh import DeviceMesh
from .sharded_invert import (
    FFT_MODES,
    ShardedStaging,
    sharded_invert_staged,
    stage_sharded_inputs,
)

ALGORITHMS = ("hogbom", "multiscale", "fista")


class ShardedOperator:
    """
    The measurement operator of a sharded staging: the normalized
    invert of per-shard slot visibilities summed over the mesh, the PSF,
    the dirty image and the residual image at a model (predict ->
    straddler group sum -> weight -> invert -> reduce), all on
    ``staging.mesh.device``.
    """

    def __init__(self, staging: ShardedStaging, fft_mode: str):
        if fft_mode not in FFT_MODES:
            raise ValueError(f"unknown fft_mode {fft_mode!r}")
        self.staging = staging
        self.fft_mode = fft_mode
        #: This rank's staged visibilities (padding and straddler copies
        #: left out).
        self.num_visibilities = sum(plan.num_vis_data
                                    for plan in staging.plans)
        mesh = staging.mesh
        if fft_mode == "distributed" and mesh.num_shards > 1:
            self._predict = build_predict(staging.plans, slot_output=True,
                                          mesh=mesh)
        else:
            shard_predicts = [build_predict(plan, slot_output=True)
                              for plan in staging.plans]

            def predict(arrays_list, image):
                return [fn(arrays, image)
                        for fn, arrays in zip(shard_predicts, arrays_list)]

            self._predict = predict

    def invert(self, re_list, im_list) -> torch.Tensor:
        image = sharded_invert_staged(self.staging, re_list, im_list,
                                      fft_mode=self.fft_mode)
        return image / self.staging.total_weight

    def psf(self) -> torch.Tensor:
        """The dirty image of unit visibilities: in slot order, the
        staged w-shift phase factors scaled by the slot weights."""
        s = self.staging
        return self.invert(
            [w * a["phase_cos"] for w, a in zip(s.weights, s.arrays)],
            [w * a["phase_sin"] for w, a in zip(s.weights, s.arrays)],
        )

    def dirty(self) -> torch.Tensor:
        return self.invert(*self.staging.weighted())

    def residual(self, model) -> torch.Tensor:
        """G* w (v - G model) / sum(w): the residual image at ``model``,
        entirely in slot space."""
        s = self.staging
        if enabled():
            count("shard_visibilities", self.num_visibilities)
            for plan, arrays in zip(s.plans, s.arrays):
                count("useful_visits", useful_slot_visits(plan, arrays))
        with span("sharded.residual", device=True):
            res_re, res_im = [], []
            predicted = self._predict(s.arrays, model)
            for (m_re, m_im), re, im, w, da, db in zip(
                    predicted, s.vis_re, s.vis_im, s.weights, s.dup_a,
                    s.dup_b):
                m_re, m_im = slot_group_sum(m_re, m_im, da, db)
                res_re.append((re - m_re) * w)
                res_im.append((im - m_im) * w)
            del predicted
            return self.invert(res_re, res_im)


def build_sharded_major_cycle_step(op: ShardedOperator, *, gain: float,
                                   minor_iter: int, psf_patch="auto"):
    """
    One Hogbom major cycle over a sharded operator, ``(model, residual)
    -> (model', residual')``: the minor cycle on the residual image the
    cycle before left (the dirty image before the first), ``model' =
    model +`` its components, and the residual image at ``model'``
    (:meth:`ShardedOperator.residual`: per shard a predict, a slot
    residual and an invert, then one image psum). So a run starts from
    the dirty image and costs one residual a cycle, with no host round
    trip. Every rank holds the same reduced residual and makes the same
    update; every rank calls the step together.

    The PSF is built once, here, and kept as the step's ``psf``.
    ``psf_patch="auto"`` is ``models.clean.pick_psf_patch`` of the image
    size. The minor cycle is ``models.clean.hogbom_clean``, looked up at
    each call.
    """
    if psf_patch == "auto":
        psf_patch = clean.pick_psf_patch(op.staging.plans[0].num_pixels)
    psf = op.psf()

    def step(model, residual):
        with span("sharded.step"):
            delta, _ = clean.hogbom_clean(residual, psf, gain=gain,
                                          max_iter=minor_iter,
                                          psf_patch=psf_patch)
            model = model + delta
            return model, op.residual(model)

    step.psf = psf
    return step


def sharded_major_cycle_clean(
    reader: VisibilityReader,
    num_pixels: int,
    pixel_size_asec: float,
    *,
    mesh: DeviceMesh | None = None,
    device=None,
    row_chunks: int | None = None,
    freq_chunks: int | None = None,
    epsilon: float = 1e-4,
    do_wstacking: bool = True,
    weighting: str = "natural",
    robust: float = 0.0,
    num_major: int = 3,
    gain: float = 0.1,
    minor_iter: int = 100,
    recorder=None,
    algorithm: str = "hogbom",
    scales=(0.0, 2.0, 4.0, 8.0),
    bias_slope: float = 0.6,
    lam_factor: float = 1e-3,
    psf_patch: int | str | None = "auto",
    sigma: float | str = 2.0,
    checkpoint_dir=None,
    fft_mode: str = "replicated",
) -> tuple:
    """
    Deconvolve a dataset over a mesh of shards (on ``mesh.device``, or
    a one-shard-per-rank mesh on ``device``). Returns ``(model,
    residual_image, psf)`` as numpy arrays, the same on every rank,
    matching the single-device solvers to gridder accuracy.

    ``algorithm``: "hogbom" (Clark-accelerated from 4096 px,
    ``models.clean.pick_psf_patch``), "multiscale" (the minor cycle of
    ``models.multiscale`` on the reduced residual) or "fista"
    (``num_major * minor_iter // 10`` iterations, the single-device CLI's
    convention). ``fft_mode="distributed"`` splits every plane transform
    over the shards in both directions (``parallel/sharded_invert.py``).

    ``checkpoint_dir``: the (model, residual) after every cycle, written
    by rank 0 only and loaded by every rank on resume
    (``models/checkpoint.py``); SIGTERM flushes the last completed
    cycle.
    """
    if fft_mode not in FFT_MODES:
        raise ValueError(f"unknown fft_mode {fft_mode!r}")
    if algorithm not in ALGORITHMS:
        raise ValueError(f"Unknown deconvolution algorithm {algorithm!r}")
    step = recorder.step if recorder is not None else (
        lambda name: nullcontext()
    )
    staging = stage_sharded_inputs(
        reader, num_pixels, pixel_size_asec, mesh=mesh, device=device,
        row_chunks=row_chunks, freq_chunks=freq_chunks, epsilon=epsilon,
        do_wstacking=do_wstacking, weighting=weighting, robust=robust,
        step=step, sigma=sigma, common_w_grid=fft_mode == "distributed",
    )
    mesh = staging.mesh
    op = ShardedOperator(staging, fft_mode)
    with step("psf"):
        if algorithm == "hogbom":
            cycle_step = build_sharded_major_cycle_step(
                op, gain=gain, minor_iter=minor_iter, psf_patch=psf_patch)
            psf = cycle_step.psf
        else:
            psf = op.psf()
    with step("dirty"):
        residual = op.dirty()

    if algorithm == "fista":
        model, residual = _sharded_fista(
            op, residual, num_pixels=num_pixels,
            num_iter=max(1, num_major * minor_iter // 10),
            lam_factor=lam_factor, step=step,
        )
        return _host(model), _host(residual), _host(psf)

    if algorithm == "multiscale":
        if psf_patch == "auto":
            psf_patch = clean.pick_psf_patch(num_pixels)
        from ..models.multiscale import (
            prepare_multiscale_minor,
            scale_kernels_and_biases,
        )

        kernels, biases = scale_kernels_and_biases(scales, bias_slope,
                                                   mesh.device)
        # The cross PSFs, built once for every cycle.
        minor = prepare_multiscale_minor(psf, kernels, biases,
                                         psf_patch=psf_patch)

        def cycle_step(model, residual):
            delta, _ = minor(residual, gain=gain, max_iter=minor_iter)
            model = model + delta
            return model, op.residual(model)

    from ..models.checkpoint import MajorCycleCheckpoint, graceful_shutdown

    checkpoint = None
    start_cycle = 0
    model = torch.zeros((num_pixels, num_pixels), dtype=torch.float32,
                        device=mesh.device)
    if checkpoint_dir is not None:
        checkpoint = MajorCycleCheckpoint(
            checkpoint_dir,
            {
                "num_pixels": num_pixels,
                "num_major": num_major,
                "gain": gain,
                "minor_iter": minor_iter,
                "algorithm": algorithm,
                "distributed": True,
            },
        )
        restored = checkpoint.load()
        if restored is not None:
            start_cycle, model_np, residual_np = restored
            model = torch.as_tensor(model_np, device=mesh.device)
            residual = torch.as_tensor(residual_np, device=mesh.device)

    state = {"cycle": start_cycle, "model": model, "res": residual}

    def flush():
        if checkpoint is not None and mesh.rank == 0:
            checkpoint.save(state["cycle"], _host(state["model"]),
                            _host(state["res"]))

    with graceful_shutdown(flush):
        for cycle in range(start_cycle, num_major):
            with step("major_cycle"):
                # One predict + invert round trip per cycle: the minor
                # cycle takes the residual carried from the last cycle.
                model, residual = cycle_step(model, residual)
                state.update(cycle=cycle + 1, model=model, res=residual)
                flush()
    return _host(model), _host(residual), _host(psf)


def _host(tensor) -> np.ndarray:
    return tensor.detach().cpu().numpy()


def _sharded_fista(op: ShardedOperator, dirty, *, num_pixels: int,
                   num_iter: int, lam_factor: float, step) -> tuple:
    """
    Distributed FISTA (``models/fista.py`` over the sharded residual):
    each iteration's gradient is one sharded predict -> residual ->
    invert round trip; the proximal update runs on the reduced image.
    The step size comes from a power iteration through the same sharded
    normal operator (the gradient is affine in the image, so
    grad(y) - grad(0) is the normal operator at y). Returns
    ``(model, residual)`` tensors.
    """
    device = op.staging.mesh.device

    def gradient(image):
        return -op.residual(image)

    with step("fista_step_size"):
        zero = torch.zeros((num_pixels, num_pixels), dtype=torch.float32,
                           device=device)
        grad_at_zero = gradient(zero)
        x = torch.ones_like(zero)
        eigenvalue = 1.0
        for _ in range(8):
            y = gradient(x) - grad_at_zero
            eigenvalue = float(torch.sqrt(torch.sum(y * y)))
            x = y / eigenvalue
        step_size = 1.0 / max(eigenvalue, 1e-6)

    lam = lam_factor * float(torch.amax(torch.abs(dirty)))
    threshold = lam * step_size
    x = torch.zeros((num_pixels, num_pixels), dtype=torch.float32,
                    device=device)
    y = x
    t = torch.tensor(1.0, dtype=torch.float32, device=device)
    for _ in range(num_iter):
        with step("fista_iter"):
            z = y - step_size * gradient(y)
            z = torch.sign(z) * torch.clamp(torch.abs(z) - threshold,
                                            min=0.0)
            z = torch.clamp(z, min=0.0)
            t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
            y = z + ((t - 1.0) / t_next) * (z - x)
            x, t = z, t_next
    with step("fista_residual"):
        residual = -gradient(x)
    return x, residual
