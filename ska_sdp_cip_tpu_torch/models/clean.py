"""
Deconvolution on the device: Hogbom minor cycle + Cotton-Schwab-style
major cycle.

Counterpart: ``ska_sdp_cip_tpu/models/clean.py``. The minor cycle runs
all ``max_iter`` steps on the device with no host read per step: once
``|peak| <= threshold`` every later update is masked to zero, which
matches the counterpart's ``lax.while_loop`` (its frame no longer
changes after that point). Windowed subtractions index the frame with
device-side offsets (``index_add_`` at a flat base + fixed window),
never with Python slices of tensor values. The major cycle recomputes
exact residuals through the measurement operator (predict -> weight ->
invert), so minor-cycle approximation error does not accumulate.
``hogbom_clean`` is the root span ``minor`` (``utils/task_metrics.py``;
its host time is the loop's issue time, its device time the loop's work
on the card) and counts ``minor_iterations``.
"""

from __future__ import annotations

import torch

from ..utils.task_metrics import count, span
from .operators import MeasurementOperator


def pick_psf_patch(npix: int) -> int | None:
    """
    Default minor-cycle PSF truncation for an ``npix`` image: None
    (exact Hogbom) below 4096 px; a 2048-cell central patch above.
    """
    return None if npix < 4096 else 2048


def _minor_block(npix: int, psf_patch: int) -> int:
    """Largest power-of-two block (<= 256) tiling npix and psf_patch."""
    for block in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        if npix % block == 0 and psf_patch % block == 0:
            return block
    return 1


def _window(rows: int, cols: int, stride: int, device) -> torch.Tensor:
    """Flat offsets of a (rows, cols) window in a frame of row ``stride``."""
    r = torch.arange(rows, device=device)[:, None] * stride
    return (r + torch.arange(cols, device=device)[None, :]).reshape(-1)


def hogbom_clean(
    dirty,
    psf,
    *,
    gain: float = 0.1,
    max_iter: int = 100,
    threshold=0.0,
    psf_patch: int | None = None,
):
    """
    Hogbom CLEAN minor cycle on the device of ``dirty``.

    ``dirty`` and ``psf`` are (npix, npix) tensors with the PSF peak at
    the centre pixel. Iterates: find the absolute peak, add
    ``gain * peak`` to the model there, subtract the shifted scaled
    PSF — for ``max_iter`` steps, masked to no-ops once
    ``|peak| <= threshold`` (a float or a 0-d tensor).

    With ``psf_patch`` (an even number of cells) below ``npix``, the
    Clark-style fast minor cycle runs: only the PSF's central
    (patch, patch) window is subtracted and the peak search runs on
    incrementally maintained per-block maxima.

    Returns ``(model, residual)``.
    """
    npix = dirty.shape[0]
    with span("minor", device=True):
        count("minor_iterations", max_iter)
        if psf_patch is not None and psf_patch < npix:
            return _clark_minor(dirty, psf, gain=gain, max_iter=max_iter,
                                threshold=threshold,
                                psf_patch=int(psf_patch))
        return _hogbom_exact(dirty, psf, gain=gain, max_iter=max_iter,
                             threshold=threshold)


def _hogbom_exact(dirty, psf, *, gain: float, max_iter: int, threshold):
    """Full-PSF Hogbom (exact within the minor cycle)."""
    npix = dirty.shape[0]
    half = npix // 2
    device = dirty.device
    psf = psf / psf[half, half]
    neg_psf = (-psf).reshape(-1)

    # Residual lives in a (2 npix, 2 npix) frame so the PSF subtraction
    # at (i, j) is one fixed window with no boundary cases.
    frame = torch.zeros((2 * npix, 2 * npix), dtype=dirty.dtype,
                        device=device)
    frame[half : half + npix, half : half + npix] = dirty
    flat_frame = frame.view(-1)
    window = _window(npix, npix, 2 * npix, device)
    model = torch.zeros_like(dirty)
    flat_model = model.view(-1)
    inner = frame[half : half + npix, half : half + npix]

    for _ in range(max_iter):
        flat_idx = torch.argmax(torch.abs(inner))
        i = torch.div(flat_idx, npix, rounding_mode="floor")
        j = flat_idx - i * npix
        peak = inner[i, j]
        scale = torch.where(torch.abs(peak) > threshold, gain * peak,
                            torch.zeros_like(peak))
        flat_model.index_add_(0, flat_idx[None], scale[None])
        flat_frame.index_add_(0, i * (2 * npix) + j + window,
                              scale * neg_psf)
    return model, inner.clone()


def _clark_minor(dirty, psf, *, gain: float, max_iter: int, threshold,
                 psf_patch: int):
    """
    Clark-style fast minor cycle: truncated-PSF subtraction plus an
    incrementally maintained per-block maximum pyramid, so neither the
    peak search nor the subtraction touches the full frame.
    """
    npix = dirty.shape[0]
    half = npix // 2
    P = psf_patch
    if P % 2:
        raise ValueError("psf_patch must be even")
    device = dirty.device
    block = _minor_block(npix, P)
    nb = npix // block
    K = P // block + 1  # blocks (per axis) a patch can touch

    psf = psf / psf[half, half]
    neg_psf_win = (
        -psf[half - P // 2 : half + P // 2, half - P // 2 : half + P // 2]
    ).reshape(-1)

    pad = P // 2
    stride = npix + P
    frame = torch.zeros((stride, stride), dtype=dirty.dtype, device=device)
    frame[pad : pad + npix, pad : pad + npix] = dirty
    flat_frame = frame.view(-1)
    model = torch.zeros_like(dirty)
    flat_model = model.view(-1)
    block_max = torch.abs(dirty).reshape(nb, block, nb, block).amax(
        dim=(1, 3)
    )
    flat_block_max = block_max.view(-1)
    tile_win = _window(block, block, stride, device)
    patch_win = _window(P, P, stride, device)
    region_win = _window(K * block, K * block, stride, device)
    kk = torch.arange(K, device=device)
    bm_win = (kk[:, None] * nb + kk[None, :]).reshape(-1)

    for _ in range(max_iter):
        active = torch.amax(block_max) > threshold
        # Two-level peak find: coarse block, then within the block.
        coarse = torch.argmax(block_max)
        bi = torch.div(coarse, nb, rounding_mode="floor")
        bj = coarse - bi * nb
        tile = flat_frame[
            (pad + bi * block) * stride + pad + bj * block + tile_win
        ]
        fine = torch.argmax(torch.abs(tile))
        fi = torch.div(fine, block, rounding_mode="floor")
        i = bi * block + fi
        j = bj * block + (fine - fi * block)
        peak = tile[fine]
        scale = torch.where(active, gain * peak, torch.zeros_like(peak))
        flat_model.index_add_(0, (i * npix + j)[None], scale[None])
        # Peak sits at frame (i + pad, j + pad); the patch (centre at
        # (P/2, P/2)) therefore starts at frame (i, j).
        flat_frame.index_add_(0, i * stride + j + patch_win,
                              scale * neg_psf_win)
        # Refresh the K x K block neighbourhood the patch touched.
        bi0 = torch.clamp(
            torch.div(i - P // 2, block, rounding_mode="floor"), 0, nb - K
        )
        bj0 = torch.clamp(
            torch.div(j - P // 2, block, rounding_mode="floor"), 0, nb - K
        )
        region = flat_frame[
            (pad + bi0 * block) * stride + pad + bj0 * block + region_win
        ]
        refreshed = torch.abs(region).reshape(K, block, K, block).amax(
            dim=(1, 3)
        ).reshape(-1)
        at = bi0 * nb + bj0 + bm_win
        flat_block_max[at] = torch.where(active, refreshed,
                                         flat_block_max[at])
    residual = frame[pad : pad + npix, pad : pad + npix].clone()
    return model, residual


def major_cycle_clean(
    operator: MeasurementOperator,
    vis,
    *,
    num_major: int = 3,
    gain: float = 0.1,
    minor_iter: int = 100,
    threshold_factor: float = 0.0,
    checkpoint_dir=None,
    psf_patch: int | str | None = "auto",
):
    """
    Cotton-Schwab major cycle: each cycle computes the exact residual
    image through the measurement operator and runs a Hogbom minor
    cycle on it.

    With ``checkpoint_dir``, state is persisted after every cycle and a
    matching prior checkpoint resumes the run (SIGTERM mid-cycle
    flushes the latest completed state first) — see
    ``models/checkpoint.py``; the file format is the counterpart's, so
    either package resumes the other's run.

    Returns ``(model, residual_image)`` as tensors on the operator's
    device.
    """
    from .checkpoint import MajorCycleCheckpoint, graceful_shutdown

    if psf_patch == "auto":
        psf_patch = pick_psf_patch(operator.plan.num_pixels)
    vis = operator.stage(vis)
    psf = operator.psf()
    npix = operator.plan.num_pixels
    model = torch.zeros((npix, npix), dtype=torch.float32,
                        device=operator.device)

    checkpoint = None
    start_cycle = 0
    residual_image = None
    if checkpoint_dir is not None:
        checkpoint = MajorCycleCheckpoint(
            checkpoint_dir,
            {
                "num_pixels": operator.plan.num_pixels,
                "num_vis": operator.plan.num_vis_data,
                "num_major": num_major,
                "gain": gain,
                "minor_iter": minor_iter,
            },
        )
        restored = checkpoint.load()
        if restored is not None:
            start_cycle, model_np, residual_np = restored
            model = torch.as_tensor(model_np, device=operator.device)
            residual_image = torch.as_tensor(residual_np,
                                             device=operator.device)

    if residual_image is None:
        residual_image = operator.dirty_image(vis)

    state = {"cycle": start_cycle, "model": model, "res": residual_image}

    def flush():
        if checkpoint is not None:
            checkpoint.save(
                state["cycle"],
                state["model"].cpu().numpy(),
                state["res"].cpu().numpy(),
            )

    with graceful_shutdown(flush):
        for cycle in range(start_cycle, num_major):
            threshold = threshold_factor * torch.amax(
                torch.abs(residual_image)
            )
            delta, _ = hogbom_clean(
                residual_image,
                psf,
                gain=gain,
                max_iter=minor_iter,
                threshold=threshold,
                psf_patch=psf_patch,
            )
            model = model + delta
            residual_image = -operator.residual_gradient(model, vis)
            state.update(cycle=cycle + 1, model=model, res=residual_image)
            flush()
    return model, residual_image


def build_major_cycle_step(operator: MeasurementOperator, **clean_kwargs):
    """
    One major-cycle step ``(model, slot_re, slot_im) -> model'``:
    gradient through the measurement operator + minor cycle + model
    update, with no host round trip. The visibility arguments are
    slot-staged (``operator.stage(vis)``), so the step is gather-free.
    """
    from .operators import SlotVis

    gain = clean_kwargs.get("gain", 0.1)
    minor_iter = clean_kwargs.get("minor_iter", 30)
    psf_patch = clean_kwargs.get("psf_patch", "auto")
    if psf_patch == "auto":
        psf_patch = pick_psf_patch(operator.plan.num_pixels)
    psf = operator.psf()

    def step(model, vis_re, vis_im):
        residual_image = -operator.residual_gradient(
            model, SlotVis(vis_re, vis_im)
        )
        delta, _ = hogbom_clean(
            residual_image,
            psf,
            gain=gain,
            max_iter=minor_iter,
            psf_patch=psf_patch,
        )
        return model + delta

    return step
