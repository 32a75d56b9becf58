"""
The explicit DFT of the imaging convention (``ops/dft.py`` of the program,
written again):

    dirty(p) = sum_k Re( x_k exp(2 pi i (u_k l_p + v_k m_p - w_k nm1_p)) ) / n_p
    model_k  = sum_s I_s / n_s exp(-2 pi i (u_k l_s + v_k m_s - w_k nm1_s))

with ``l_p = (i_p - npix/2) * pixel``, ``m_p = (j_p - npix/2) * pixel``
('ij' indexing), ``nm1 = n - 1 = -(l^2 + m^2) / (1 + sqrt(1 - l^2 - m^2))``
and u, v, w in wavelengths, over blocks of rows so that it fits beside
nothing else on the card. ``dtype`` is float64 for the reference and
bfloat16 for its control (every tensor of the arithmetic in that type).
"""

from __future__ import annotations

import math

import numpy as np
import torch

SPEED_OF_LIGHT = 299792458.0


def directions(pixels: np.ndarray, npix: int, pixel_lm: float, device,
               dtype=torch.float64) -> torch.Tensor:
    """(3, P) l, m and -(n - 1) of each pixel, and (P,) n."""
    p = torch.as_tensor(np.asarray(pixels), dtype=torch.float64, device=device)
    l = (p[:, 0] - npix // 2) * pixel_lm
    m = (p[:, 1] - npix // 2) * pixel_lm
    r2 = l * l + m * m
    nm1 = -r2 / (1.0 + torch.sqrt(1.0 - r2))
    return torch.stack([l, m, -nm1]).to(dtype), (nm1 + 1.0).to(dtype)


def _phases(uvw, freqs, dirs, dtype):
    """(rows * chans, P) phases 2 pi (u l + v m - w nm1), in ``dtype``."""
    scale = (freqs.to(dtype) / SPEED_OF_LIGHT)
    uvw_wl = (uvw.to(dtype)[:, None, :] * scale[None, :, None]).reshape(-1, 3)
    if dtype == torch.float64:
        return (2.0 * math.pi) * (uvw_wl @ dirs)
    # Lower precision: the same products and sums, each rounded to dtype.
    return (2.0 * math.pi) * (uvw_wl[:, 0:1] * dirs[0] + uvw_wl[:, 1:2] * dirs[1]
                              + uvw_wl[:, 2:3] * dirs[2])


def dirty_at(uvw, freqs, weighted: torch.Tensor, pixels, npix: int,
             pixel_lm: float, *, dtype=torch.float64,
             rows_per_block: int = 2048) -> torch.Tensor:
    """The dirty images of weighted visibilities ``weighted`` (rows,
    chans, B), complex, at ``pixels`` (P, 2): (B, P) float64, on the
    device of ``weighted``; ``uvw`` may lie on the host."""
    device = weighted.device
    dirs, n = directions(pixels, npix, pixel_lm, device, dtype)
    freqs_t = torch.as_tensor(np.asarray(freqs), dtype=torch.float64,
                              device=device)
    batch = weighted.shape[2]
    acc = torch.zeros((batch, len(pixels)), dtype=dtype, device=device)
    for r0 in range(0, len(uvw), rows_per_block):
        r1 = min(r0 + rows_per_block, len(uvw))
        u = torch.as_tensor(np.asarray(uvw[r0:r1]), device=device)
        x = weighted[r0:r1].reshape(-1, batch)
        ph = _phases(u, freqs_t, dirs, dtype)
        xr, xi = x.real.to(dtype), x.imag.to(dtype)
        if dtype == torch.float64:
            acc += xr.T @ torch.cos(ph) - xi.T @ torch.sin(ph)
        else:
            for b in range(batch):
                acc[b] += (xr[:, b, None] * torch.cos(ph)
                           - xi[:, b, None] * torch.sin(ph)).sum(0)
    return (acc / n).double()


def model_visibilities(uvw, freqs, pixels, values, npix: int,
                       pixel_lm: float, *,
                       pixels_per_block: int = 512) -> torch.Tensor:
    """Forward model of a sparse image (``values`` at ``pixels``):
    complex128 (rows, chans) on the device of ``values``, summed over
    blocks of ``pixels_per_block`` components."""
    device = values.device
    freqs_t = torch.as_tensor(np.asarray(freqs), dtype=torch.float64,
                              device=device)
    u = torch.as_tensor(np.asarray(uvw), device=device)
    out = torch.zeros(len(uvw) * len(freqs), dtype=torch.complex128,
                      device=device)
    for p0 in range(0, len(pixels), pixels_per_block):
        p1 = min(p0 + pixels_per_block, len(pixels))
        dirs, n = directions(pixels[p0:p1], npix, pixel_lm, device)
        ph = _phases(u, freqs_t, dirs, torch.float64)
        amp = (values[p0:p1].double() / n).to(torch.complex128)
        out += torch.polar(torch.ones_like(ph), -ph) @ amp
    return out.reshape(len(uvw), len(freqs))
