"""
Multiscale CLEAN minor cycle (Cornwell 2008 style) on the device.

Counterpart: ``ska_sdp_cip_tpu/models/multiscale.py``. Per major cycle:

* scale kernels ``k_s`` (tapered Gaussians, k_0 = delta), each the
  outer product ``f_s (x) f_s`` of a 1-D factor (:func:`scale_factors`,
  derived once and checked when the minor cycle is built), and the
  cross-convolved PSFs ``P_st = psf * k_s * k_t``, built once. Every
  scale convolution is separable: a row pass and a column pass of
  ``f_s`` (the counterpart's ``lax.conv`` is a cross-correlation too;
  the kernels are symmetric), in float32: kernel S1
  (``ops/scale_conv_cuda.py``) on the card, all S frames of an image in
  one launch, and its plain version (``conv2d`` with (1, k) and (k, 1)
  kernels) on the CPU;
* the minor loop keeps one residual map per scale in a padded frame,
  picks the global (scale, pixel) peak with per-scale bias weights,
  adds ``gain * peak * k_s`` to the model, and subtracts
  ``gain * peak * P_st`` from every scale's residual at the peak.

As in the port's Hogbom/Clark (``models/clean.py``), the minor loop runs
all ``max_iter`` steps on the device with no host read per step: once
the counterpart's ``lax.while_loop`` would stop (biased peak metric
<= 0) every later update is masked to zero. Windows are indexed with
device-side flat offsets (``index_add_`` at a flat base + fixed window).
Every window lies inside its padded frame for any peak position, so
none needs the clamp of the counterpart's ``lax.dynamic_slice``.

The major cycle recomputes exact residuals through the measurement
operator, so minor-cycle approximation does not accumulate. One cycle
is a step of :func:`build_multiscale_cycle_step` (gradient, minor
cycle, model update on the device), which builds the PSF, the kernels
and biases, and the cross PSFs once, when it is built
(:func:`prepare_multiscale_minor`); ``multiscale_clean`` runs the same
minor update from the dirty image, one invert and ``num_major``
gradients in all.

Spans and counters (``utils/task_metrics.py``): ``multiscale.cross_psfs``
(device, at step build), ``multiscale.frames`` (device: the S scale
convolutions of a minor cycle's residual; counter ``scale_frames``) and
``multiscale.minor`` (device, its host time the loop's launches; counter
``multiscale_iterations``). While the recorder is on, the loop also
counts on the card the components taken at each scale, which reach the
counters ``multiscale_picks.s<k>`` only when the recorder is read.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import scale_conv_cuda
from ..utils.task_metrics import count, count_later, enabled, span
from .clean import _minor_block, _window, pick_psf_patch
from .operators import MeasurementOperator, SlotVis


def scale_kernel(scale: float, radius: int) -> np.ndarray:
    """
    Normalized (unit-sum) tapered Gaussian of characteristic width
    ``scale`` pixels; scale 0 is a delta.
    """
    size = 2 * radius + 1
    kernel = np.zeros((size, size), np.float32)
    if scale <= 0:
        kernel[radius, radius] = 1.0
        return kernel
    axis = np.arange(-radius, radius + 1, dtype=np.float64)
    rr2 = np.add.outer(axis**2, axis**2)
    sigma = scale / 2.0
    kernel = np.exp(-0.5 * rr2 / sigma**2)
    return (kernel / kernel.sum()).astype(np.float32)


def _conv_same(image, kernel):
    """Real 2-D convolution (cross-correlation), SAME padding."""
    # A float32 convolution would otherwise run in TF32 on the card.
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return torch.nn.functional.conv2d(
            image[None, None], kernel[None, None], padding="same"
        )[0, 0]


#: How far a scale kernel may lie from the outer product of its factors,
#: from its transpose and from its mirror image, over its largest tap: a
#: few float32 roundings (the scale kernels read ~1e-7).
SEPARABLE_RTOL = 1e-6


def scale_factors(kernels):
    """
    The (S, ksize) float32 factors ``f`` of the (S, ksize, ksize) scale
    kernels, ``kernels[s] = f[s] (x) f[s]``, on the kernels' device: each
    kernel's row sums over the square root of its sum (the row sums
    themselves for a unit-sum kernel), in float64 on the host. Raises
    ValueError unless every kernel is square of an odd size, has a
    positive sum, equals its transpose and its mirror image, and is the
    outer product of its factor within :data:`SEPARABLE_RTOL` of its
    largest tap: no kernel is convolved as what it is not.
    """
    k = kernels.detach().to("cpu", torch.float64)
    if k.dim() != 3 or k.shape[1] != k.shape[2] or k.shape[1] % 2 == 0:
        raise ValueError(f"scale kernels must be (S, k, k) with k odd, not "
                         f"{tuple(k.shape)}")
    total = k.sum((1, 2))
    if not bool((total > 0).all()):
        raise ValueError(f"scale kernels must have a positive sum: "
                         f"{total.tolist()}")
    factors = k.sum(2) / total.sqrt()[:, None]
    peak = k.abs().amax((1, 2))
    for what, other in (("its transpose", k.transpose(1, 2)),
                        ("its mirror image", k.flip(1)),
                        ("the outer product of its factor",
                         factors[:, :, None] * factors[:, None, :])):
        gap = (k - other).abs().amax((1, 2)) / peak
        for s in torch.nonzero(gap > SEPARABLE_RTOL).flatten().tolist():
            raise ValueError(f"scale kernel {s} differs from {what} by "
                             f"{float(gap[s]):.3g} of its largest tap")
    return factors.to(dtype=torch.float32, device=kernels.device)


def _separable_frames_reference(image, factors, pad: int):
    """
    The plain version of S1 (``ops/scale_conv_cuda.py:scale_frames``):
    each factor trimmed to its outermost nonzero taps (exact zeros, so
    the sums are unchanged), a row pass and then a column pass through
    ``_conv_same`` with (1, k) and (k, 1) kernels, each frame in a zero
    margin of ``pad`` cells.
    """
    rows, cols = image.shape
    radius = factors.shape[1] // 2
    frames = torch.zeros((factors.shape[0], rows + 2 * pad, cols + 2 * pad),
                         dtype=torch.float32, device=image.device)
    for s, factor in enumerate(factors):
        taps = torch.nonzero(factor).flatten()
        r = int((taps - radius).abs().max()) if len(taps) else 0
        f = factor[radius - r : radius + r + 1]
        frames[s, pad : pad + rows, pad : pad + cols] = _conv_same(
            _conv_same(image, f[None, :]), f[:, None])
    return frames


def _separable_frames(image, factors, pad: int):
    """``image`` convolved with every ``factors[s] (x) factors[s]``, each
    in a zero margin of ``pad`` cells: (S, rows + 2 pad, cols + 2 pad).
    S1 for a CUDA tensor, its plain version for a CPU one."""
    if image.device.type == "cuda":
        return scale_conv_cuda.scale_frames(image, factors, pad)
    return _separable_frames_reference(image, factors, pad)


def _scale_frames(residual, kernels, num_scales: int, pad: int, *,
                  factors=None):
    """
    The scale-convolved residuals, each in a zero frame with a margin of
    ``pad`` cells on every side: (S, npix + 2 pad, npix + 2 pad). The
    kernels' ``factors`` (:func:`scale_factors`) are derived here when
    not given.
    """
    if factors is None:
        factors = scale_factors(kernels)
    with span("multiscale.frames", device=True):
        count("scale_frames", num_scales)
        return _separable_frames(residual, factors[:num_scales], pad)


def _neg_cross_psfs(psf, factors, num_scales: int, crop=None):
    """
    ``-P_st = -(psf * k_s * k_t)`` for every (s, t), flattened per s:
    (S, S * n * n), with each P_st cut to its central ``crop`` =
    (start, size) window when given; ``k_s = factors[s] (x) factors[s]``.
    The PSF is not renormalized: its peak is assumed ~1, as in the
    counterpart.
    """
    factors = factors[:num_scales]
    psf_s = _separable_frames(psf, factors, 0)
    rows = []
    for s in range(num_scales):
        cross = _separable_frames(psf_s[s], factors, 0)
        if crop is not None:
            m0, size = crop
            cross = cross[:, m0 : m0 + size, m0 : m0 + size]
        rows.append(-cross.reshape(-1))
    return torch.stack(rows)


def _clark_psf_window(psf, ksize: int, psf_patch: int):
    """
    The PSF's central (M, M) window, M = psf_patch + 2 ksize, from which
    the Clark path's cross-PSF patches are convolved (the 2 ksize margin
    keeps SAME-conv edge effects outside the kept patch); and the start
    of the kept (psf_patch, psf_patch) window inside it.
    """
    npix = psf.shape[0]
    half = npix // 2
    M = psf_patch + 2 * ksize
    if M > npix:
        # The counterpart's dynamic_slice of an (M, M) window out of an
        # (npix, npix) PSF fails to trace here; below, its start
        # half - M // 2 and end half - M // 2 + M lie in [0, npix].
        raise ValueError(
            f"psf_patch {psf_patch} + 2 x kernel size {ksize} exceeds "
            f"the image ({npix} px)"
        )
    start = half - M // 2
    return psf[start : start + M, start : start + M], (M - psf_patch) // 2


def prepare_multiscale_minor(psf, kernels, biases, *,
                             psf_patch: int | None = None):
    """
    The minor cycle of one PSF: the cross PSFs ``-P_st`` built once
    (span ``multiscale.cross_psfs``), over the whole image or, with
    ``psf_patch`` (an even number of cells) below the image's size, cut
    to the central patch of the Clark path — at production sizes the
    exact path would build (S, S, npix, npix) cross PSFs (6.7 GB at
    10240 px) and pay O(S npix^2) per iteration.
    """
    npix = psf.shape[0]
    num_scales = kernels.shape[0]
    clark = psf_patch is not None and psf_patch < npix
    if clark and psf_patch % 2:
        raise ValueError("psf_patch must be even")
    factors = scale_factors(kernels)
    with span("multiscale.cross_psfs", device=True):
        if clark:
            psf_win, m0 = _clark_psf_window(psf, kernels.shape[1],
                                            int(psf_patch))
            neg_cross = _neg_cross_psfs(psf_win, factors, num_scales,
                                        crop=(m0, int(psf_patch)))
        else:
            neg_cross = _neg_cross_psfs(psf, factors, num_scales)
    return MultiscaleMinor(kernels, factors, biases, neg_cross,
                           int(psf_patch) if clark else None)


@dataclass(frozen=True)
class MultiscaleMinor:
    """
    A multiscale minor cycle with its cross PSFs built
    (:func:`prepare_multiscale_minor`): call it on a residual image for
    ``(model, residual)``. ``neg_cross`` is ``-P_st`` flattened per s,
    (S, S * n * n), n the image's size or the Clark patch
    (``psf_patch``; None on the exact path). ``factors`` are the
    kernels' (:func:`scale_factors`), with which the frames of every
    residual are convolved.
    """

    kernels: torch.Tensor  # (S, ksize, ksize)
    factors: torch.Tensor  # (S, ksize)
    biases: torch.Tensor  # (S,)
    neg_cross: torch.Tensor
    psf_patch: int | None

    def __call__(self, residual, *, gain: float, max_iter: int):
        if self.psf_patch is not None:
            return _multiscale_minor_clark(residual, self, gain=gain,
                                           max_iter=max_iter)
        return _multiscale_minor_exact(residual, self, gain=gain,
                                       max_iter=max_iter)


def _multiscale_minor(
    residual,
    psf,
    kernels,  # (S, ksize, ksize)
    biases,  # (S,)
    *,
    gain: float,
    max_iter: int,
    num_scales: int,
    psf_patch: int | None = None,
):
    """
    One multiscale minor cycle of ``psf``, its cross PSFs built for this
    call alone (a :class:`MultiscaleMinor` keeps them over calls). With
    ``psf_patch`` (< npix) the Clark-style fast path runs: cross-PSF
    subtraction truncated to the central patch and per-(scale, block)
    maxima maintained incrementally.

    Returns ``(model, residual)``.
    """
    minor = prepare_multiscale_minor(
        psf, kernels[:num_scales], biases[:num_scales], psf_patch=psf_patch
    )
    return minor(residual, gain=gain, max_iter=max_iter)


def _pick_counter(num_scales: int, device):
    """Components taken at each scale, kept on the device while the
    recorder is on (else None)."""
    if not enabled():
        return None
    return torch.zeros(num_scales, dtype=torch.int64, device=device)


def _count_picks(picks) -> None:
    if picks is not None:
        count_later([f"multiscale_picks.s{k}" for k in range(len(picks))],
                    picks)


def _multiscale_minor_exact(residual, minor: MultiscaleMinor, *,
                            gain: float, max_iter: int):
    """The exact multiscale minor cycle: every cross PSF whole, the
    global (scale, pixel) peak searched every iteration."""
    npix = residual.shape[0]
    half = npix // 2
    kernels, biases, neg_cross = minor.kernels, minor.biases, minor.neg_cross
    S = kernels.shape[0]
    device = residual.device
    ksize = kernels.shape[1]
    kr = ksize // 2

    # Scale-convolved residual frames (S, 2 npix, 2 npix) for even npix:
    # the subtraction of an (npix, npix) cross PSF centred on any inner
    # pixel (i, j) starts at frame (i, j), inside the frame.
    frames = _scale_frames(residual, kernels, S, half,
                           factors=minor.factors)
    with span("multiscale.minor", device=True):
        count("multiscale_iterations", max_iter)
        picks = _pick_counter(S, device)
        stride = frames.shape[-1]
        flat_frames = frames.view(-1)
        inner = frames[:, half : half + npix, half : half + npix]
        scale_base = torch.arange(S, device=device)[:, None] * stride * stride
        frame_win = (scale_base
                     + _window(npix, npix, stride, device)).reshape(-1)

        # The model lives in a (npix + 2 kr)^2 frame so the s-scale blob
        # at (i, j) is one fixed window; its margin is cut off at the end
        # (the counterpart crops it every step; nothing reads it).
        mstride = npix + 2 * kr
        pad_model = torch.zeros((mstride, mstride), dtype=torch.float32,
                                device=device)
        flat_model = pad_model.view(-1)
        model_win = _window(ksize, ksize, mstride, device)
        flat_kernels = kernels.reshape(S, -1)
        plane = npix * npix

        for _ in range(max_iter):
            biased = torch.abs(inner) * biases[:, None, None]
            flat_idx = torch.argmax(biased).reshape(1)
            metric = biased.reshape(-1)[flat_idx]
            s = torch.div(flat_idx, plane, rounding_mode="floor")
            rem = flat_idx - s * plane
            i = torch.div(rem, npix, rounding_mode="floor")
            j = rem - i * npix
            value = flat_frames[s * stride * stride + (half + i) * stride
                                + half + j]
            active = metric > 0.0
            amplitude = torch.where(active, gain * value,
                                    torch.zeros_like(value))
            flat_model.index_add_(
                0, i * mstride + j + model_win,
                amplitude * torch.index_select(flat_kernels, 0, s)[0],
            )
            # Every scale's residual loses amplitude * P_{s,t} at (i, j).
            flat_frames.index_add_(
                0, i * stride + j + frame_win,
                amplitude * torch.index_select(neg_cross, 0, s)[0],
            )
            if picks is not None:
                picks.index_add_(0, s, active.to(torch.int64))
        _count_picks(picks)
        model = pad_model[kr : kr + npix, kr : kr + npix].clone()
        return model, inner[0].clone()


def _multiscale_minor_clark(residual, minor: MultiscaleMinor, *,
                            gain: float, max_iter: int):
    """
    Clark-style multiscale minor cycle (see
    :func:`prepare_multiscale_minor`): per-(scale, block) biased maxima
    refreshed only where the truncated cross-PSF patches landed. All
    scales' frames update in one ``index_add_`` per iteration.
    """
    npix = residual.shape[0]
    kernels, biases, neg_cross = minor.kernels, minor.biases, minor.neg_cross
    S = kernels.shape[0]
    P = minor.psf_patch
    device = residual.device
    pad = P // 2
    block = _minor_block(npix, P)
    nb = npix // block
    K = P // block + 1  # blocks (per axis) a patch can touch
    ksize = kernels.shape[1]
    kr = ksize // 2

    stride = npix + P
    frames = _scale_frames(residual, kernels, S, pad,
                           factors=minor.factors)
    with span("multiscale.minor", device=True):
        count("multiscale_iterations", max_iter)
        picks = _pick_counter(S, device)
        flat_frames = frames.view(-1)

        def biased_block_max(region):
            # region (S, R, R) -> (S, R/block, R/block) of biased |.|
            R = region.shape[1]
            mb = torch.abs(
                region.reshape(S, R // block, block, R // block, block)
            ).amax(dim=(2, 4))
            return mb * biases[:, None, None]

        block_max = biased_block_max(
            frames[:, pad : pad + npix, pad : pad + npix])
        flat_block_max = block_max.view(-1)

        scale_base = torch.arange(S, device=device)[:, None] * stride * stride
        tile_win = _window(block, block, stride, device)
        patch_win = (scale_base + _window(P, P, stride, device)).reshape(-1)
        region_win = (
            scale_base + _window(K * block, K * block, stride, device)
        ).reshape(-1)
        kk = torch.arange(K, device=device)
        bm_win = (
            torch.arange(S, device=device)[:, None] * nb * nb
            + (kk[:, None] * nb + kk[None, :]).reshape(-1)
        ).reshape(-1)

        mstride = npix + 2 * kr
        pad_model = torch.zeros((mstride, mstride), dtype=torch.float32,
                                device=device)
        flat_model = pad_model.view(-1)
        model_win = _window(ksize, ksize, mstride, device)
        flat_kernels = kernels.reshape(S, -1)

        for _ in range(max_iter):
            active = torch.amax(block_max) > 0.0
            coarse = torch.argmax(block_max).reshape(1)
            s = torch.div(coarse, nb * nb, rounding_mode="floor")
            rem = coarse - s * nb * nb
            bi = torch.div(rem, nb, rounding_mode="floor")
            bj = rem - bi * nb
            tile = flat_frames[
                s * stride * stride + (pad + bi * block) * stride + pad
                + bj * block + tile_win
            ]
            fine = torch.argmax(torch.abs(tile)).reshape(1)
            fi = torch.div(fine, block, rounding_mode="floor")
            i = bi * block + fi
            j = bj * block + (fine - fi * block)
            value = tile[fine]
            amplitude = torch.where(active, gain * value,
                                    torch.zeros_like(value))

            flat_model.index_add_(
                0, i * mstride + j + model_win,
                amplitude * torch.index_select(flat_kernels, 0, s)[0],
            )
            # All scales lose amplitude * P_{s,t} patches at (i, j): peak
            # at frame (i + pad, j + pad), patch centred -> start (i, j).
            flat_frames.index_add_(
                0, i * stride + j + patch_win,
                amplitude * torch.index_select(neg_cross, 0, s)[0],
            )
            # Refresh the K x K biased block maxima for every scale.
            bi0 = torch.clamp(
                torch.div(i - P // 2, block, rounding_mode="floor"), 0,
                nb - K
            )
            bj0 = torch.clamp(
                torch.div(j - P // 2, block, rounding_mode="floor"), 0,
                nb - K
            )
            region = flat_frames[
                (pad + bi0 * block) * stride + pad + bj0 * block + region_win
            ]
            refreshed = biased_block_max(
                region.reshape(S, K * block, K * block)
            ).reshape(-1)
            at = bi0 * nb + bj0 + bm_win
            flat_block_max[at] = torch.where(active, refreshed,
                                             flat_block_max[at])
            if picks is not None:
                picks.index_add_(0, s, active.reshape(1).to(torch.int64))
        _count_picks(picks)
        model = pad_model[kr : kr + npix, kr : kr + npix].clone()
        return model, frames[0, pad : pad + npix, pad : pad + npix].clone()


def scale_kernels_and_biases(scales, bias_slope: float, device) -> tuple:
    """
    The (S, 2r+1, 2r+1) scale kernels (r = ceil(2 max_scale) + 1) and
    the (S,) peak-selection biases ``1 - slope * scale / max_scale``, as
    float32 tensors on ``device``.
    """
    max_scale = max(max(scales), 1.0)
    radius = int(np.ceil(2.0 * max_scale)) + 1
    kernels = np.stack([scale_kernel(s, radius) for s in scales])
    biases = np.array(
        [1.0 - bias_slope * s / max_scale for s in scales], np.float32
    )
    return (torch.as_tensor(kernels, device=device),
            torch.as_tensor(biases, device=device))


def _build_minor_update(operator: MeasurementOperator, *, scales,
                        bias_slope: float, gain: float, minor_iter: int,
                        psf_patch):
    """
    ``update(model, residual) -> model'``: one multiscale minor cycle on
    the residual image, added to the model. The PSF, the scale kernels
    and biases and the cross PSFs are built once, here.
    """
    if psf_patch == "auto":
        psf_patch = pick_psf_patch(operator.plan.num_pixels)
    kernels, biases = scale_kernels_and_biases(scales, bias_slope,
                                               operator.device)
    minor = prepare_multiscale_minor(operator.psf(), kernels, biases,
                                     psf_patch=psf_patch)

    def update(model, residual):
        delta, _ = minor(residual, gain=gain, max_iter=minor_iter)
        return model + delta

    return update


def build_multiscale_cycle_step(
    operator: MeasurementOperator,
    *,
    scales=(0.0, 2.0, 4.0, 8.0),
    bias_slope: float = 0.6,
    gain: float = 0.1,
    minor_iter: int = 100,
    psf_patch: int | str | None = "auto",
):
    """
    One multiscale major-cycle step ``(model, slot_re, slot_im) ->
    model'``: gradient through the measurement operator, multiscale
    minor cycle, model update, with no host round trip; the counterpart
    of ``models/clean.py:build_major_cycle_step``. The PSF, the scale
    kernels and biases and the cross PSFs are built once, here. The
    visibility arguments are slot-staged (``operator.stage(vis)``).

    ``bias_slope`` down-weights large scales in peak selection
    (standard multiscale bias ``1 - slope * scale/max_scale``).
    ``psf_patch`` as in models/clean.py ("auto": Clark-truncated
    above 4096 px).
    """
    update = _build_minor_update(
        operator, scales=scales, bias_slope=bias_slope, gain=gain,
        minor_iter=minor_iter, psf_patch=psf_patch,
    )

    def step(model, vis_re, vis_im):
        residual = -operator.residual_gradient(model,
                                               SlotVis(vis_re, vis_im))
        return update(model, residual)

    return step


def multiscale_clean(
    operator: MeasurementOperator,
    vis,
    *,
    scales=(0.0, 2.0, 4.0, 8.0),
    num_major: int = 3,
    gain: float = 0.1,
    minor_iter: int = 100,
    bias_slope: float = 0.6,
    psf_patch: int | str | None = "auto",
):
    """
    Multiscale Cotton-Schwab CLEAN: ``num_major`` cycles of
    :func:`build_multiscale_cycle_step`'s minor update, the first on
    the dirty image (which equals the step's gradient of an empty
    model, without its predict), each later one on the residual of the
    model so far. Returns ``(model, residual)`` as tensors on the
    operator's device.
    """
    vis = operator.stage(vis)
    update = _build_minor_update(
        operator, scales=scales, bias_slope=bias_slope, gain=gain,
        minor_iter=minor_iter, psf_patch=psf_patch,
    )
    npix = operator.plan.num_pixels
    model = torch.zeros((npix, npix), dtype=torch.float32,
                        device=operator.device)
    residual = operator.dirty_image(vis)
    for _ in range(num_major):
        model = update(model, residual)
        residual = -operator.residual_gradient(model, vis)
    return model, residual
