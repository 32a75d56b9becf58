"""
Four-step DFT axis passes on split (re, im) float32 tensors.

Counterpart: ``ska_sdp_cip_tpu/ops/fft.py``. ``make_fft_plan`` (numpy
factors) is copied unchanged; ``fft_last_axis`` and ``fft_first_axis``
are plain torch ports of the counterparts with ``out_crop`` (the
invert's image crop). They are the plain version of the fused CUDA
pass (``ops/fft_cuda.py``) and the port's oracle for it. The factor
dict ``f`` holds the plan's factors as tensors under
``{prefix}_d1_cos`` etc. (see :func:`fft_plan_arrays`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _near_square_factors(n: int) -> tuple[int, int]:
    """Factor n = n1 * n2 with n1 <= n2 as close to sqrt(n) as possible."""
    best = (1, n)
    for n1 in range(1, int(np.sqrt(n)) + 1):
        if n % n1 == 0:
            best = (n1, n // n1)
    return best


@dataclass(frozen=True)
class FFTPlan:
    """Four-step DFT factors for one axis length (host numpy, f32)."""

    n: int
    n1: int
    n2: int
    d1_cos: np.ndarray
    d1_sin: np.ndarray
    d2_cos: np.ndarray
    d2_sin: np.ndarray
    tw_cos: np.ndarray
    tw_sin: np.ndarray


def make_fft_plan(n: int, *, shifted: bool = False) -> FFTPlan:
    """
    Factor matrices for a length-``n`` DFT with the negative exponent
    convention; ``sign=+1`` at apply time gives the inverse. With
    ``shifted=True`` the factors implement the centred transform
    ``fftshift o DFT o ifftshift`` (even n).
    """
    n1, n2 = _near_square_factors(n)

    j1 = np.arange(n1)
    j2 = np.arange(n2)
    a1 = 2.0 * np.pi * np.outer(j1, j1) / n1
    a2 = 2.0 * np.pi * np.outer(j2, j2) / n2
    at = 2.0 * np.pi * np.outer(j1, j2) / n

    d1 = np.exp(-1j * a1)
    d2 = np.exp(-1j * a2)
    tw = np.exp(-1j * at)

    if shifted:
        if n % 2:
            raise ValueError("shifted transform requires even n")
        sign_j1 = (-1.0) ** (j1 * n2)
        sign_k1 = (-1.0) ** j1
        sign_j2 = (-1.0) ** j2
        sign_k2 = (-1.0) ** (n1 * j2)
        constant = np.exp(-1j * np.pi * (n / 2.0))
        d1 = d1 * sign_j1[None, :]
        tw = tw * sign_k1[:, None]
        d2 = d2 * sign_j2[:, None] * sign_k2[None, :] * constant

    return FFTPlan(
        n=n,
        n1=n1,
        n2=n2,
        d1_cos=np.real(d1).astype(np.float32),
        d1_sin=(-np.imag(d1)).astype(np.float32),
        d2_cos=np.real(d2).astype(np.float32),
        d2_sin=(-np.imag(d2)).astype(np.float32),
        tw_cos=np.real(tw).astype(np.float32),
        tw_sin=(-np.imag(tw)).astype(np.float32),
    )


def fft_plan_arrays(plan: FFTPlan, prefix: str = "fft") -> dict:
    """Plan factors as a dict of host numpy arrays (stage with torch)."""
    return {
        f"{prefix}_d1_cos": plan.d1_cos,
        f"{prefix}_d1_sin": plan.d1_sin,
        f"{prefix}_d2_cos": plan.d2_cos,
        f"{prefix}_d2_sin": plan.d2_sin,
        f"{prefix}_tw_cos": plan.tw_cos,
        f"{prefix}_tw_sin": plan.tw_sin,
    }


def _factors(f, prefix, sign):
    return (
        f[f"{prefix}_d1_cos"],
        f[f"{prefix}_d1_sin"],
        f[f"{prefix}_d2_cos"],
        f[f"{prefix}_d2_sin"],
        f[f"{prefix}_tw_cos"],
        f[f"{prefix}_tw_sin"],
        float(sign),
    )


def _stage1_block(d1_cos, d1_sin, s):
    """Real 2x2-block form ``[[C, -sS], [sS, C]]`` of the stage-1 factor."""
    top = torch.cat([d1_cos, -s * d1_sin], dim=1)
    bot = torch.cat([s * d1_sin, d1_cos], dim=1)
    return torch.cat([top, bot], dim=0)


def _stage2_block(d2_cos, d2_sin, s):
    """Real 2x2-block form ``[[C, sS], [-sS, C]]`` of the stage-2 factor."""
    left = torch.cat([d2_cos, s * d2_sin], dim=1)
    right = torch.cat([-s * d2_sin, d2_cos], dim=1)
    return torch.cat([left, right], dim=0)


def _crop_range(n1: int, out_crop):
    """Covering k2 range and the trim of a cropped stage 2."""
    c0, size = out_crop
    k2a, k2b = c0 // n1, -(-(c0 + size) // n1)
    return k2a, k2b, (c0 - k2a * n1, size)


def fft_last_axis(re, im, f, *, sign: int, prefix: str = "fft", out_crop=None):
    """
    DFT along the last axis of (..., n) split tensors (counterpart
    ``fft_last_axis``). ``sign=-1`` is the forward transform, ``+1``
    the unnormalized inverse; ``out_crop=(start, size)`` computes only
    those output columns.
    """
    d1_cos, d1_sin, d2_cos, d2_sin, tw_cos, tw_sin, s = _factors(
        f, prefix, sign
    )
    n1, n2 = d1_cos.shape[0], d2_cos.shape[0]
    n = n1 * n2
    batch = re.shape[:-1]
    xr = re.reshape(-1, n1, n2)
    xi = im.reshape(-1, n1, n2)

    x2 = torch.cat([xr, xi], dim=1)
    y = torch.einsum("kj,bjn->bkn", _stage1_block(d1_cos, d1_sin, s), x2)
    yr, yi = y[:, :n1, :], y[:, n1:, :]

    tr = tw_cos[None, :, :]
    ti = s * tw_sin[None, :, :]
    z2 = torch.cat([yr * tr - yi * ti, yr * ti + yi * tr], dim=-1)

    trim = None
    n_out = n
    if out_crop is not None:
        k2a, k2b, trim = _crop_range(n1, out_crop)
        d2_cos, d2_sin = d2_cos[:, k2a:k2b], d2_sin[:, k2a:k2b]
        n_out = (k2b - k2a) * n1
    q = d2_cos.shape[1]

    out = torch.einsum("bkn,nq->bqk", z2, _stage2_block(d2_cos, d2_sin, s))
    outr = out[:, :q, :].reshape(batch + (n_out,))
    outi = out[:, q:, :].reshape(batch + (n_out,))
    if trim is not None:
        outr = outr[..., trim[0] : trim[0] + trim[1]]
        outi = outi[..., trim[0] : trim[0] + trim[1]]
    return outr, outi


def fft_first_axis(
    re, im, f, *, sign: int, prefix: str = "fft", out_crop=None
):
    """
    DFT along the first axis of (n, m) split tensors, transpose-free
    (counterpart ``fft_first_axis``); ``out_crop`` as in
    :func:`fft_last_axis`, applied to the first axis.
    """
    d1_cos, d1_sin, d2_cos, d2_sin, tw_cos, tw_sin, s = _factors(
        f, prefix, sign
    )
    n1, n2 = d1_cos.shape[0], d2_cos.shape[0]
    n = n1 * n2
    m = re.shape[-1]
    xr = re.reshape(n1, n2, m)
    xi = im.reshape(n1, n2, m)

    x2 = torch.cat([xr, xi], dim=0)
    y = torch.einsum("kj,jnm->knm", _stage1_block(d1_cos, d1_sin, s), x2)
    yr, yi = y[:n1], y[n1:]

    tr = tw_cos[:, :, None]
    ti = s * tw_sin[:, :, None]
    z2 = torch.cat([yr * tr - yi * ti, yr * ti + yi * tr], dim=1)

    trim = None
    n_out = n
    if out_crop is not None:
        k2a, k2b, trim = _crop_range(n1, out_crop)
        d2_cos, d2_sin = d2_cos[:, k2a:k2b], d2_sin[:, k2a:k2b]
        n_out = (k2b - k2a) * n1
    q = d2_cos.shape[1]

    out = torch.einsum("knm,nq->qkm", z2, _stage2_block(d2_cos, d2_sin, s))
    outr = out[:q].reshape(n_out, m)
    outi = out[q:].reshape(n_out, m)
    if trim is not None:
        outr = outr[trim[0] : trim[0] + trim[1], :]
        outi = outi[trim[0] : trim[0] + trim[1], :]
    return outr, outi
