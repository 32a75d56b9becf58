"""
Explicit DFT dirty image — the correctness oracle.

Counterpart: ``ska_sdp_cip_tpu/ops/dft.py``, copied (pure numpy) so the
port can check itself on a machine without JAX.

Computes the dirty image definition that the invert operator must
approximate to ``epsilon``:

    dirty[i, j] = sum_k Re( vis_k * w_k *
                  exp(2 pi i (u_k x_i + v_k y_j - w_k nm1_ij)) ) / n_ij

with ``x_i = (i - npix/2) * pixsize`` ('ij' indexing, x along the first
axis), ``nm1 = n - 1 = -(x^2+y^2) / (1 + sqrt(1 - x^2 - y^2))`` and
``u,v,w`` per-channel coordinates in wavelengths. With
``apply_w=False``: ``nm1 = 0, n = 1``.

This is exactly the brute-force definition ducc0's own test-suite checks
``ms2dirty`` against; since the dirty image is the adjoint of the
measurement operator, matching this DFT at epsilon is equivalent to the
reference's accuracy contract (reference: src/ska_sdp_cip/invert.py:
170-183, epsilon=1e-4). Pure numpy float64, O(npix^2 * nvis) — for
tests and golden data only.
"""

from __future__ import annotations

import numpy as np

SPEED_OF_LIGHT = 299792458.0


def dirty_image_dft(
    uvw: np.ndarray,
    channel_frequencies: np.ndarray,
    visibilities: np.ndarray,
    weights: np.ndarray,
    num_pixels: int,
    pixel_size_lm: float,
    *,
    apply_w: bool = True,
    row_block: int = 4096,
) -> np.ndarray:
    """
    Brute-force dirty image.

    Parameters mirror the invert operator: ``uvw`` (nrow, 3) in meters,
    ``channel_frequencies`` (nchan,) Hz, ``visibilities`` and ``weights``
    (nrow, nchan). Returns float64 image of shape
    ``(num_pixels, num_pixels)`` (unnormalized — divide by total weight
    for fluxes).
    """
    uvw = np.asarray(uvw, dtype=np.float64)
    freqs = np.asarray(channel_frequencies, dtype=np.float64)
    vis = np.asarray(visibilities, dtype=np.complex128)
    wgt = np.asarray(weights, dtype=np.float64)

    half = num_pixels // 2
    axis = (np.arange(num_pixels) - half) * pixel_size_lm
    x = axis[:, None]
    y = axis[None, :]
    r2 = x**2 + y**2
    if apply_w:
        nm1 = -r2 / (1.0 + np.sqrt(1.0 - r2))
        n = nm1 + 1.0
    else:
        nm1 = np.zeros_like(r2)
        n = 1.0

    image = np.zeros((num_pixels, num_pixels), dtype=np.float64)
    scale = freqs / SPEED_OF_LIGHT

    for start in range(0, len(uvw), row_block):
        stop = min(start + row_block, len(uvw))
        # Per-channel uvw in wavelengths: (nrow_blk, nchan, 3)
        uvw_wl = uvw[start:stop, None, :] * scale[None, :, None]
        weighted = (vis[start:stop] * wgt[start:stop]).reshape(-1)
        u = uvw_wl[..., 0].reshape(-1)
        v = uvw_wl[..., 1].reshape(-1)
        w = uvw_wl[..., 2].reshape(-1)

        nonzero = weighted != 0
        u, v, w, weighted = (a[nonzero] for a in (u, v, w, weighted))

        for k in range(len(weighted)):
            phase = u[k] * x + v[k] * y - w[k] * nm1
            image += (weighted[k] * np.exp(2j * np.pi * phase)).real

    return image / n


def predict_dft(
    uvw: np.ndarray,
    channel_frequencies: np.ndarray,
    image: np.ndarray,
    pixel_size_lm: float,
    *,
    apply_w: bool = True,
) -> np.ndarray:
    """
    Brute-force forward model (degridding / dirty2ms analog), the exact
    adjoint of :func:`dirty_image_dft`:

        vis[k] = sum_ij image[i,j] / n_ij *
                 exp(-2 pi i (u_k x_i + v_k y_j - w_k nm1_ij))

    Returns complex128 visibilities of shape (nrow, nchan).
    """
    uvw = np.asarray(uvw, dtype=np.float64)
    freqs = np.asarray(channel_frequencies, dtype=np.float64)
    image = np.asarray(image, dtype=np.float64)
    num_pixels = image.shape[0]

    half = num_pixels // 2
    axis = (np.arange(num_pixels) - half) * pixel_size_lm
    x = axis[:, None]
    y = axis[None, :]
    r2 = x**2 + y**2
    if apply_w:
        nm1 = -r2 / (1.0 + np.sqrt(1.0 - r2))
        n = nm1 + 1.0
    else:
        nm1 = np.zeros_like(r2)
        n = 1.0

    image_over_n = image / n
    scale = freqs / SPEED_OF_LIGHT
    num_rows, num_chans = len(uvw), len(freqs)
    vis = np.zeros((num_rows, num_chans), dtype=np.complex128)
    for row in range(num_rows):
        for chan in range(num_chans):
            u, v, w = uvw[row] * scale[chan]
            phase = u * x + v * y - w * nm1
            vis[row, chan] = np.sum(
                image_over_n * np.exp(-2j * np.pi * phase)
            )
    return vis
