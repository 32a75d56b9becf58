"""
Briggs robust weighting (Briggs 1995), written plainly in float64:

    rho(cell)  = sum of the weights that fall in the uv cell, each
                 sample also counted at its conjugate's cell
    f^2        = (5 * 10^-R)^2 / (sum rho^2 / sum rho)
    w'         = w / (1 + rho(cell) * f^2)

on the image's own uv grid: npix cells a side of 1 / (npix * pixel)
wavelengths, a sample at cell round(u nu / c * (npix * pixel)) + npix/2
(the same for v; half to even), clipped to the grid; its conjugate at
npix - i, clipped. ``dtype`` below float64 gives the control: the last
formula's operands and result rounded to that type. TF32 is off for
matmul and cuDNN inside :func:`briggs`.
"""

from __future__ import annotations

import numpy as np
import torch

SPEED_OF_LIGHT = 299792458.0


def cells(uvw, freqs, npix: int, pixel_lm: float) -> tuple:
    """(iu, iv) int64 (rows, chans) of every sample, on ``uvw``'s device."""
    inv_cell = 1.0 / (1.0 / (npix * pixel_lm))
    scale = torch.as_tensor(np.asarray(freqs), dtype=torch.float64,
                            device=uvw.device) / SPEED_OF_LIGHT * inv_cell
    half = npix // 2
    iu = torch.round(uvw[:, 0, None] * scale[None, :]).long() + half
    iv = torch.round(uvw[:, 1, None] * scale[None, :]).long() + half
    return iu.clamp_(0, npix - 1), iv.clamp_(0, npix - 1)


class no_tf32:
    """Full float32 in matmuls and cuDNN inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


def briggs(uvw, freqs, weights: torch.Tensor, npix: int, pixel_lm: float,
           robust: float, *, dtype=torch.float64) -> torch.Tensor:
    """Briggs weights (rows, chans) of ``weights`` (rows, chans, 0 where
    flagged), float64 (or ``dtype``) on ``weights``' device; ``uvw`` may
    lie on the host."""
    with no_tf32():
        return _briggs(uvw, freqs, weights, npix, pixel_lm, robust, dtype)


def _briggs(uvw, freqs, weights, npix, pixel_lm, robust, dtype):
    device = weights.device
    uvw = torch.as_tensor(np.asarray(uvw), dtype=torch.float64, device=device)
    w = weights.to(torch.float64)
    iu, iv = cells(uvw, freqs, npix, pixel_lm)
    mu = (npix - iu).clamp_(0, npix - 1)
    mv = (npix - iv).clamp_(0, npix - 1)
    direct = (iu * npix + iv).reshape(-1)
    density = torch.zeros(npix * npix, dtype=torch.float64, device=device)
    density.index_add_(0, direct, w.reshape(-1))
    density.index_add_(0, (mu * npix + mv).reshape(-1), w.reshape(-1))
    del iu, iv, mu, mv
    f2 = (5.0 * 10.0 ** (-robust)) ** 2 / float(
        (density * density).sum() / density.sum())
    rho = density[direct].reshape(w.shape)
    if dtype == torch.float64:
        return w / (1.0 + rho * f2)
    one = torch.ones((), dtype=dtype, device=device)
    return (w.to(dtype) / (one + rho.to(dtype) * torch.tensor(
        f2, dtype=dtype, device=device))).double()
