"""
ducc0.wgridder-compatible ``ms2dirty`` and ``dirty2ms`` on the port's
gridder.

Counterpart: ``ska_sdp_cip_tpu/wgridder.py``. ``nthreads`` is accepted
and ignored; ``device`` is an extra keyword-only argument.
"""

from __future__ import annotations

import numpy as np

from .ops.gridder import dirty_image, predict_visibilities


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


def dirty2ms(
    uvw,
    freq,
    dirty,
    wgt=None,
    pixsize_x=None,
    pixsize_y=None,
    epsilon=1e-4,
    do_wstacking=True,
    nthreads=None,
    mask=None,
    *,
    device,
    **_ignored,
):
    """Model visibilities from an image (ducc0 dirty2ms analog)."""
    if pixsize_y is not None and pixsize_x != pixsize_y:
        raise NotImplementedError("Anisotropic pixels are not supported")
    vis = predict_visibilities(
        uvw,
        freq,
        dirty,
        float(pixsize_x),
        epsilon=float(epsilon),
        do_wstacking=bool(do_wstacking),
        device=device,
    )
    if wgt is not None:
        vis = vis * np.asarray(wgt)
    if mask is not None:
        vis = vis * np.asarray(mask)
    return vis
