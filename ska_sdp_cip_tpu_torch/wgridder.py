"""
ducc0.wgridder-compatible ``ms2dirty`` on the port's gridder.

Counterpart: ``ska_sdp_cip_tpu/wgridder.py:ms2dirty``. ``nthreads`` is
accepted and ignored; ``device`` is an extra keyword-only argument.
``dirty2ms`` (predict) is still to be ported (ROADMAP.md, queue A).
"""

from __future__ import annotations

import numpy as np

from .ops.gridder import dirty_image


def ms2dirty(
    uvw,
    freq,
    ms,
    wgt,
    npix_x,
    npix_y,
    pixsize_x,
    pixsize_y,
    epsilon=1e-4,
    do_wstacking=True,
    nthreads=None,
    mask=None,
    *,
    device,
    **_ignored,
):
    """Dirty image of weighted visibilities (ducc0 ms2dirty analog)."""
    if npix_x != npix_y or pixsize_x != pixsize_y:
        raise NotImplementedError(
            "Only square images with isotropic pixels are supported"
        )
    if wgt is None:
        wgt = np.ones(np.shape(ms), np.float32)
    if mask is not None:
        wgt = np.asarray(wgt) * np.asarray(mask)
    return dirty_image(
        uvw,
        freq,
        ms,
        wgt,
        int(npix_x),
        float(pixsize_x),
        epsilon=float(epsilon),
        do_wstacking=bool(do_wstacking),
        device=device,
    )
