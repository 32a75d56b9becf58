"""
The Hogbom minor cycle, written plainly: ``max_iter`` times, find the
first pixel of largest |residual| (row-major), add ``gain`` times its
value to the model there, and subtract as much of the PSF, normalised to
1 at its centre and cut to its central ``psf_patch`` cells a side where
one is given, centred on that pixel; what falls outside the image is
dropped. Updates stop once the peak is not above ``threshold``.

It runs on the residual image and the PSF that the program's major cycle
hands its minor cycle: a PSF of every pixel and the residual the minor
cycle starts from are too dear to work out again by DFT at these sizes, so
the check follows the program's state here and checks those two inputs
at sampled pixels by themselves (``drivers/cycle.py``). In float32 it
does the program's arithmetic in the same order, so that near ties are
broken alike.
"""

from __future__ import annotations

import torch


def hogbom(residual: torch.Tensor, psf: torch.Tensor, *, gain: float,
           max_iter: int, psf_patch: int | None = None,
           threshold: float = 0.0, dtype=torch.float32) -> tuple:
    """Returns ``(components, residual)``, float32, like the input."""
    npix = residual.shape[0]
    half = npix // 2
    res = residual.to(dtype).clone()
    psf = psf.to(dtype)
    psf = psf / psf[half, half]
    if psf_patch is None or psf_patch >= npix:
        p = npix
        lo = 0
    else:
        p = psf_patch
        lo = half - p // 2
    neg = -psf[lo : lo + p, lo : lo + p]
    model = torch.zeros_like(res)
    for _ in range(max_iter):
        flat = int(torch.argmax(torch.abs(res)))
        i, j = divmod(flat, npix)
        peak = res[i, j]
        if not bool(torch.abs(peak) > threshold):
            break
        scale = gain * peak
        model[i, j] += scale
        # The patch's centre (p/2, p/2) lands on (i, j).
        r0, c0 = i - p // 2, j - p // 2
        ra, rb = max(r0, 0), min(r0 + p, npix)
        ca, cb = max(c0, 0), min(c0 + p, npix)
        res[ra:rb, ca:cb] += scale * neg[ra - r0 : rb - r0, ca - c0 : cb - c0]
    return model.float(), res.float()
