"""
The yardstick's work count for the scale convolutions of a multiscale
minor cycle: the least work that turns one residual image into its S
scale frames, whatever implements the convolutions, so that a direct,
an FFT or a hand-written convolution all read against the same count
and none can read over 100% of it.

* bytes: the residual read once and the S frames written once,
  ``npix^2 * 4 * (1 + S)``;
* flops: the FFT route, ``(1 + S)`` transforms of the padded frame at
  ``5 M log2 M`` each and ``S`` pointwise complex products at ``6 M``
  each, ``M = (npix + ksize - 1)^2``.

The least time is the longer of the bytes at the HBM rate and the flops
at the FP32 rate (``work.bound_seconds``).
"""

from __future__ import annotations

import math

from .reference.multiscale import kernel_radius
from .work import bound_seconds


def scale_conv_work(npix: int, ksize: int, num_scales: int) -> tuple:
    """(bytes, flops) of one residual's S scale frames."""
    nbytes = npix * npix * 4 * (1 + num_scales)
    m = (npix + ksize - 1) ** 2
    flops = (1 + num_scales) * 5.0 * m * math.log2(m) + num_scales * 6.0 * m
    return nbytes, flops


def scale_conv_bound(npix: int, scales) -> float:
    """Least seconds of one minor cycle's scale convolutions."""
    ksize = 2 * kernel_radius(scales) + 1
    return bound_seconds(*scale_conv_work(npix, ksize, len(scales)))
