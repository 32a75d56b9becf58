"""
Exponential-of-semicircle (ES) gridding kernel and its Fourier-domain
correction.

Counterpart: ``ska_sdp_cip_tpu/ops/kernels.py``. The numpy part
(``kernel_support_for_epsilon``, ``es_beta``, ``es_kernel_np``,
``gauss_legendre_kernel_quadrature``, ``correction_np``) is copied
unchanged; ``es_kernel`` and ``correction`` are the torch twins of
``es_kernel_jnp`` and ``correction_jnp`` with the same operation order
(``t = 1 - z*z``, ``exp(beta*s - beta)``), so both frameworks round
alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def kernel_support_for_epsilon(epsilon: float, sigma: float = 2.0) -> int:
    """
    Kernel support (cells per axis) for a target gridding accuracy
    ``epsilon`` at oversampling ``sigma`` (see the counterpart for the
    derivation).
    """
    if not 0 < epsilon < 1:
        raise ValueError("epsilon must be in (0, 1)")
    if sigma <= 1.05:
        raise ValueError("sigma must exceed 1.05")
    digits = -np.log10(epsilon)
    rate = np.sqrt(2.0 * (1.0 - 1.0 / sigma))  # decades/cell vs sigma=2
    support = int(np.ceil(digits / rate)) + 2
    if sigma < 1.6:
        support += 1
    return int(np.clip(support, 4, 16))


def es_beta(support: int, sigma: float = 2.0) -> float:
    """ES kernel shape parameter ``0.98 pi W (1 - 1/(2 sigma))``."""
    return 0.98 * np.pi * support * (1.0 - 1.0 / (2.0 * sigma))


def es_kernel_np(z: np.ndarray, beta: float) -> np.ndarray:
    """ES kernel on |z|<=1, zero outside (numpy, float64)."""
    z = np.asarray(z)
    inside = np.abs(z) <= 1.0
    arg = np.sqrt(np.maximum(1.0 - z * z, 0.0)) - 1.0
    return np.where(inside, np.exp(beta * arg), 0.0)


def es_kernel(z: torch.Tensor, beta: float) -> torch.Tensor:
    """
    ES kernel on |z|<1, zero outside (torch; counterpart
    ``es_kernel_jnp``). At ``|z| == 1`` exactly this returns 0, below
    the kernel's own truncation floor.
    """
    t = 1.0 - z * z
    s = torch.sqrt(torch.clamp(t, min=0.0))
    return torch.where(
        t > 0.0, torch.exp(beta * s - beta), torch.zeros_like(t)
    )


def gauss_legendre_kernel_quadrature(
    support: int, beta: float, num_points: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """
    Quadrature rule ``(nodes, weights)`` on [0, 1] for the kernel's
    Fourier transform, weights folded with ``phi(nodes)`` (float64).
    """
    if num_points <= 0:
        num_points = 2 * support + 8
    nodes, gl_weights = np.polynomial.legendre.leggauss(num_points)
    nodes = 0.5 * (nodes + 1.0)
    gl_weights = 0.5 * gl_weights
    return nodes, gl_weights * es_kernel_np(nodes, beta)


def correction_np(
    k: np.ndarray, support: int, beta: float, num_points: int = 0
) -> np.ndarray:
    """Fourier-domain correction ``c(k)`` (numpy float64)."""
    nodes, folded = gauss_legendre_kernel_quadrature(support, beta, num_points)
    k = np.asarray(k, dtype=np.float64)
    angles = 2.0 * np.pi * (support / 2.0) * np.multiply.outer(k, nodes)
    return support * (np.cos(angles) @ folded)


def correction(
    k: torch.Tensor,
    nodes: torch.Tensor,
    folded: torch.Tensor,
    support: int,
) -> torch.Tensor:
    """
    Fourier-domain correction ``c(k)`` with a precomputed quadrature
    rule (torch; counterpart ``correction_jnp``). ``k`` may have any
    shape; the rule is contracted over a new trailing axis.
    """
    angles = 2.0 * math.pi * (support / 2.0) * k[..., None] * nodes
    return support * torch.sum(torch.cos(angles) * folded, dim=-1)
