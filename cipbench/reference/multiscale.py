"""
Multiscale CLEAN (Cornwell 2008; Cotton-Schwab major cycles, as WSClean's
``-multiscale`` runs them, Offringa & Smirnov 2017), written plainly:

* scale kernels: scale 0 a delta, scale s > 0 the Gaussian
  ``exp(-r^2 / (2 (s/2)^2))`` on a square of radius
  ``ceil(2 max(s_max, 1)) + 1`` cells, normalized to unit sum; the
  peak-selection bias of scale s is ``1 - slope * s / s_max``;
* a scale frame is the residual image convolved with k_s (SAME: the
  image's size, zero outside it); a cross PSF ``P_st`` is the PSF
  convolved with k_s and then with k_t, each SAME over the window
  given, in float64 through FFTs;
* the minor cycle: ``max_iter`` times, pick the scale and pixel of the
  largest biased |frame| (first in scale, row, column order; with
  ``block``, first in the order of (scale, block row, block column)
  and then row-major inside the block, which is how the Clark search
  of the program breaks exact ties), add ``gain`` times the frame's
  value there times k_s to the model, and subtract as much of every
  ``P_st`` (t over the scales) from frame t, centred on that pixel.
  It stops once the biased peak is not above zero. It runs on frames
  and cross PSFs it is given, in float32 (or the control's type), with
  the operations of the program's minor cycle in their order, so that
  near ties break alike;
* :func:`multiscale_clean_dft`: major cycles whose residual images and
  PSF are explicit DFTs (``dft.py``), with their own frames, cross
  PSFs and minor cycle: the reference of small problems.

TF32 is off for matmul and cuDNN inside these functions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import dft
from .weighting import no_tf32


def kernel_radius(scales) -> int:
    return int(math.ceil(2.0 * max(max(scales), 1.0))) + 1


def scale_kernel(scale: float, radius: int) -> torch.Tensor:
    """(2 radius + 1)^2 float64, unit sum."""
    size = 2 * radius + 1
    if scale <= 0:
        kernel = torch.zeros((size, size), dtype=torch.float64)
        kernel[radius, radius] = 1.0
        return kernel
    axis = torch.arange(-radius, radius + 1, dtype=torch.float64)
    rr2 = axis[:, None] ** 2 + axis[None, :] ** 2
    kernel = torch.exp(-0.5 * rr2 / (scale / 2.0) ** 2)
    return kernel / kernel.sum()


def kernels_and_biases(scales, bias_slope: float, device,
                       dtype=torch.float32) -> tuple:
    """(S, k, k) kernels and (S,) biases in ``dtype`` on ``device``."""
    radius = kernel_radius(scales)
    s_max = max(max(scales), 1.0)
    kernels = torch.stack([scale_kernel(s, radius) for s in scales])
    biases = torch.tensor([1.0 - bias_slope * s / s_max for s in scales],
                          dtype=torch.float64)
    return kernels.to(device, dtype), biases.to(device, dtype)


def conv_same(image: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME cross-correlation of a 2-D ``image`` with an odd square
    ``kernel``, float64, through zero-padded FFTs."""
    with no_tf32():
        image = image.double()
        kernel = kernel.to(image.device, torch.float64)
        k = kernel.shape[0]
        r = k // 2
        n0, n1 = image.shape
        size = (n0 + k - 1, n1 + k - 1)
        full = torch.fft.irfft2(
            torch.fft.rfft2(image, s=size)
            * torch.fft.rfft2(torch.flip(kernel, (0, 1)), s=size), s=size)
        return full[r : r + n0, r : r + n1]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded (to nearest, ties to even) to TF32's 10
    mantissa bits, as a tensor core reads its operands."""
    bits = x.float().contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


def conv_at(image: torch.Tensor, kernel: torch.Tensor, pixels,
            precision: str = "float64") -> torch.Tensor:
    """``image`` convolved (SAME) with ``kernel`` at ``pixels`` (P, 2),
    by direct sums over each pixel's window, float64 out. ``precision``:
    "float64"; "tf32" (operands rounded to TF32, products summed in
    float32, as a TF32 convolution does); "bfloat16" (operands and
    products in bfloat16, summed in float32)."""
    with no_tf32():
        r = kernel.shape[0] // 2
        dtype = {"float64": torch.float64, "tf32": torch.float32,
                 "bfloat16": torch.bfloat16}[precision]
        img = image.to(dtype if precision != "tf32" else torch.float32)
        ker = kernel.to(img.device, img.dtype)
        if precision == "tf32":
            img, ker = tf32_round(img), tf32_round(ker)
        padded = torch.nn.functional.pad(img[None, None], (r, r, r, r))[0, 0]
        out = []
        for i, j in np.asarray(pixels).tolist():
            window = padded[i : i + 2 * r + 1, j : j + 2 * r + 1]
            prod = window * ker
            out.append(prod.sum(dtype=torch.float64 if dtype == torch.float64
                                else torch.float32))
        return torch.stack(out).double()


def cross_psfs(psf: torch.Tensor, kernels: torch.Tensor,
               crop: tuple | None = None) -> torch.Tensor:
    """``P_st = (psf * k_s) * k_t`` (S, S, n, n) float64, each
    convolution SAME over ``psf``'s window, cut to ``crop`` = (start,
    size) when given."""
    S = kernels.shape[0]
    psf_s = [conv_same(psf, kernels[s]) for s in range(S)]
    out = []
    for s in range(S):
        row = []
        for t in range(S):
            cross = conv_same(psf_s[s], kernels[t])
            if crop is not None:
                m0, size = crop
                cross = cross[m0 : m0 + size, m0 : m0 + size]
            row.append(cross)
        out.append(torch.stack(row))
    return torch.stack(out)


def minor_block(npix: int, patch: int) -> int:
    """The program's Clark block: the largest power of two up to 256
    that divides both the image and the patch."""
    for block in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        if npix % block == 0 and patch % block == 0:
            return block
    return 1


def minor(frames: torch.Tensor, neg_cross: torch.Tensor,
          kernels: torch.Tensor, biases: torch.Tensor, *, npix: int,
          gain: float, max_iter: int, block: int | None = None,
          dtype=torch.float32) -> tuple:
    """The minor cycle on ``frames`` (S, npix + P, npix + P: each scale's
    residual with a margin of P/2) and ``neg_cross`` (S, S, P, P: minus
    the cross PSFs). Returns ``(model, frames)``, float32; ``frames``
    is not changed."""
    with no_tf32():
        res = frames.to(dtype).clone()
        neg = neg_cross.to(res.device, dtype)
        ker = kernels.to(res.device, dtype)
        bias = biases.to(res.device, dtype)
        S, P = neg.shape[0], neg.shape[-1]
        pad = (res.shape[-1] - npix) // 2
        k = ker.shape[-1]
        kr = k // 2
        model = torch.zeros((npix + 2 * kr, npix + 2 * kr), dtype=dtype,
                            device=res.device)
        for _ in range(max_iter):
            inner = res[:, pad : pad + npix, pad : pad + npix]
            if block is None:
                biased = torch.abs(inner) * bias[:, None, None]
                peak = biased.max()
                s, rest = divmod(int(torch.argmax(biased)), npix * npix)
                i, j = divmod(rest, npix)
            else:
                nb = npix // block
                biased = torch.abs(inner).reshape(
                    S, nb, block, nb, block).amax(dim=(2, 4))
                biased = biased * bias[:, None, None]
                peak = biased.max()
                s, rest = divmod(int(torch.argmax(biased)), nb * nb)
                bi, bj = divmod(rest, nb)
                tile = inner[s, bi * block : (bi + 1) * block,
                             bj * block : (bj + 1) * block]
                fi, fj = divmod(int(torch.argmax(torch.abs(tile))), block)
                i, j = bi * block + fi, bj * block + fj
            if not bool(peak > 0.0):
                break
            amplitude = gain * inner[s, i, j]
            model[i : i + k, j : j + k] += amplitude * ker[s]
            res[:, i : i + P, j : j + P] += amplitude * neg[s]
        return (model[kr : kr + npix, kr : kr + npix].float(), res.float())


def multiscale_clean_dft(uvw, freqs, vis, weights, npix: int,
                         pixel_lm: float, *, scales, bias_slope: float,
                         gain: float, minor_iter: int, num_major: int,
                         psf_patch: int | None = None) -> list:
    """The model after each of ``num_major`` cycles from an empty one
    (float32 (npix, npix) each), with every residual image and the PSF
    worked out by DFT over every pixel. Small problems only."""
    device = torch.device("cpu")
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float64)
    v = torch.as_tensor(np.asarray(vis)).to(torch.complex128)
    pixels = np.stack(np.meshgrid(np.arange(npix), np.arange(npix),
                                  indexing="ij"), -1).reshape(-1, 2)
    total = float(w.sum())

    def image_of(x):
        return (dft.dirty_at(uvw, freqs, x[..., None], pixels, npix,
                             pixel_lm, rows_per_block=64)[0]
                / total).reshape(npix, npix)

    psf = image_of(w.to(torch.complex128))
    k32, b32 = kernels_and_biases(scales, bias_slope, device)
    k64, _ = kernels_and_biases(scales, bias_slope, device, torch.float64)
    k = k64.shape[-1]
    if psf_patch is not None and psf_patch < npix:
        P = psf_patch
        M = P + 2 * k
        start = npix // 2 - M // 2
        window = psf[start : start + M, start : start + M]
        neg = -cross_psfs(window, k64, crop=((M - P) // 2, P))
        block = minor_block(npix, P)
    else:
        P = npix
        neg = -cross_psfs(psf, k64)
        block = None
    neg = neg.float()
    model = torch.zeros((npix, npix), dtype=torch.float32)
    models = []
    for _ in range(num_major):
        nz = torch.nonzero(model).numpy()
        if len(nz):
            m = dft.model_visibilities(uvw, freqs, nz,
                                       model[nz[:, 0], nz[:, 1]], npix,
                                       pixel_lm)
        else:
            m = 0.0
        residual = image_of((v - m) * w)
        pad = P // 2
        frames = torch.zeros((len(scales), npix + P, npix + P))
        for s in range(len(scales)):
            frames[s, pad : pad + npix, pad : pad + npix] = conv_same(
                residual, k64[s]).float()
        delta, _ = minor(frames, neg, k32, b32, npix=npix, gain=gain,
                         max_iter=minor_iter, block=block)
        model = model + delta
        models.append(model)
    return models
