"""
First-order regularized least-squares imaging (FISTA).

Counterpart: ``ska_sdp_cip_tpu/models/fista.py``. Imaging as

    min_I  || sqrt(w) (G I - v) ||^2  +  lam * || I ||_1  (+ I >= 0)

solved with accelerated proximal gradient iterations whose gradient is
one on-device predict-residual-regrid round trip through the
measurement operator — the "major-cycle first-order iteration". Each
step is a function of tensors on the operator's device (the momentum
``t`` included); the host reads one number per iteration, the trace.
"""

from __future__ import annotations

import numpy as np
import torch

from .operators import MeasurementOperator


def power_method_step_size(
    operator: MeasurementOperator, iterations: int = 8
) -> float:
    """
    1 / L with L an estimate of the largest eigenvalue of the normal
    operator G* w G / sum(w) (power iteration through the
    forward/adjoint pair). The PSF peak normalization makes L ~ 1;
    the estimate tightens the step.
    """
    npix = operator.plan.num_pixels
    x = torch.ones((npix, npix), dtype=torch.float32, device=operator.device)
    eigenvalue = 1.0
    for _ in range(iterations):
        re, im = operator.forward(x)
        # The operator's weights are padded to the plan's slot count.
        w = operator.weights[: re.shape[0]]
        y = operator.adjoint(re * w, im * w) / operator.total_weight
        eigenvalue = float(torch.sqrt(torch.sum(y * y)))
        x = y / eigenvalue
    return 1.0 / max(eigenvalue, 1e-6)


def fista_clean(
    operator: MeasurementOperator,
    vis,
    *,
    num_iter: int = 20,
    lam_factor: float = 1e-3,
    nonneg: bool = True,
    step_size: float | None = None,
):
    """
    Run FISTA; returns ``(model, residual_image, objective_trace)``:
    the model and residual as tensors on the operator's device, the
    trace (max |gradient| per iteration) as float64 numpy.

    ``lam_factor`` sets the soft-threshold as a fraction of the dirty
    peak (scale-free across datasets). The residual image returned is
    the gradient image at the final model (same normalization as the
    dirty image).
    """
    vis = operator.stage(vis)
    npix = operator.plan.num_pixels
    dirty = operator.dirty_image(vis)
    lam = lam_factor * float(torch.amax(torch.abs(dirty)))
    if step_size is None:
        step_size = power_method_step_size(operator)

    def step(x, y, t):
        gradient = operator.residual_gradient(y, vis)
        z = y - step_size * gradient
        # prox of lam ||.||_1 (+ nonnegativity)
        threshold = lam * step_size
        z = torch.sign(z) * torch.clamp(torch.abs(z) - threshold, min=0.0)
        if nonneg:
            z = torch.clamp(z, min=0.0)
        t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        y_next = z + ((t - 1.0) / t_next) * (z - x)
        return z, y_next, t_next, gradient

    x = torch.zeros((npix, npix), dtype=torch.float32, device=operator.device)
    y = x
    t = torch.tensor(1.0, dtype=torch.float32, device=operator.device)
    trace = []
    for _ in range(num_iter):
        x, y, t, gradient = step(x, y, t)
        trace.append(float(torch.amax(torch.abs(gradient))))

    residual = -operator.residual_gradient(x, vis)
    return x, residual, np.asarray(trace, dtype=np.float64)
