"""
Restored image: CLEAN model convolved with the fitted restoring beam,
plus the residual.

Counterpart: ``ska_sdp_cip_tpu/models/restore.py``. The beam fit and
kernel (``fit_restoring_beam``, ``gaussian_beam_kernel``) are numpy and
copied; the convolution is ``torch.nn.functional.conv2d`` (the
counterpart computes it with ``lax.conv`` outside any kernel) on the
given device, in full float32 (TF32 off for cuDNN).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gridder import resolve_device


def fit_restoring_beam(psf: np.ndarray) -> tuple:
    """
    Fit an elliptical Gaussian to the PSF main lobe. Returns
    ``(bmaj_px, bmin_px, position_angle_rad)`` as the 1-sigma axes in
    pixels, from the second moments of the above-half-max core.
    """
    psf = np.asarray(psf)
    npix = psf.shape[0]
    peak = psf[npix // 2, npix // 2]
    mask = psf >= 0.5 * peak

    # Keep only the core component containing the centre: limit to a
    # window, since distant sidelobes can exceed half max in sparse uv
    # coverage.
    window = max(npix // 8, 8)
    core = np.zeros_like(mask)
    lo, hi = npix // 2 - window, npix // 2 + window
    core[lo:hi, lo:hi] = mask[lo:hi, lo:hi]

    ii, jj = np.nonzero(core)
    weights = psf[ii, jj]
    di = ii - npix // 2
    dj = jj - npix // 2
    total = weights.sum()
    cov_ii = (weights * di * di).sum() / total
    cov_jj = (weights * dj * dj).sum() / total
    cov_ij = (weights * di * dj).sum() / total
    cov = np.array([[cov_ii, cov_ij], [cov_ij, cov_jj]])
    # Half-max core of a Gaussian has moments sigma^2 * c with a known
    # constant; calibrate via the FWHM relation instead: the above-half
    # region of N(0, sigma^2) is an ellipse with semi-axes
    # sigma * sqrt(2 ln 2), and uniform+gaussian weighting keeps the
    # eigenvector structure, so scale eigenvalues to match.
    eigvals, eigvecs = np.linalg.eigh(cov)
    eigvals = np.maximum(eigvals, 1e-6)
    # Moment->sigma calibration for the half-max-truncated weighted
    # core of a Gaussian: var_axis = kappa * sigma^2 with
    # kappa = 1 - ln2 / (2 (1 - 1/2... analytically
    # (1/2) * [2(1 - (1+ln2)/2)] / (1/2) = 0.3069.
    kappa = 0.3069
    sigmas = np.sqrt(eigvals / kappa)
    angle = float(np.arctan2(eigvecs[1, -1], eigvecs[0, -1]))
    return float(sigmas[-1]), float(sigmas[0]), angle


def gaussian_beam_kernel(
    bmaj_sigma: float, bmin_sigma: float, angle: float, radius: int
) -> np.ndarray:
    """Normalized (peak=1) elliptical Gaussian kernel, (2r+1, 2r+1)."""
    axis = np.arange(-radius, radius + 1, dtype=np.float64)
    xx, yy = np.meshgrid(axis, axis, indexing="ij")
    ca, sa = np.cos(angle), np.sin(angle)
    u = xx * ca + yy * sa
    v = -xx * sa + yy * ca
    kernel = np.exp(
        -0.5 * ((u / bmaj_sigma) ** 2 + (v / bmin_sigma) ** 2)
    )
    return kernel.astype(np.float32)


def restore_image(model, residual, psf, *, device) -> np.ndarray:
    """
    ``model (*) beam + residual``: the restored CLEAN image, with the
    beam fitted from the PSF, convolved on ``device``. All inputs
    (npix, npix) arrays or tensors; returns float32 numpy.
    """
    device = resolve_device(device)

    def host(x):
        return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    bmaj, bmin, angle = fit_restoring_beam(host(psf))
    radius = int(np.ceil(4.0 * max(bmaj, bmin))) + 1
    kernel = gaussian_beam_kernel(bmaj, bmin, angle, radius)

    def tensor(x):
        return torch.as_tensor(np.asarray(host(x), np.float32),
                               device=device)

    # conv2d is a cross-correlation, as lax.conv is; a float32
    # convolution would otherwise run in TF32 on the card.
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        convolved = torch.nn.functional.conv2d(
            tensor(model)[None, None], tensor(kernel)[None, None],
            padding="same",
        )[0, 0]
    return (convolved + tensor(residual)).cpu().numpy()
