"""
The image-domain taper maps ``(inv_corr, nm1s)`` on the card: kernel
T1 (``csrc/taper.cu``).

Counterpart: none; the JAX package builds the maps with XLA
(``ska_sdp_cip_tpu/ops/gridder.py:_geometry_maps``). The plain version
of T1 is the port's ``ops/gridder.py:_geometry_maps_reference``, which
``_geometry_maps`` runs on CPU tensors; it calls :func:`taper_maps` for
CUDA tensors: nothing falls back from one to the other.

T1 evaluates the plain version's formulas pixel by pixel, with no
intermediate tensor: a first launch works out the npix-long uv
correction, the second writes both maps, each (+-l, +-m) quadruple of
pixels from one evaluation of n - 1 and the w correction (``mirror``;
``mirror=False`` evaluates every pixel on its own, for the tests and
``chip_smoke.py``, and gives the same bits).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.task_metrics import count

#: Calls of :func:`taper_maps` that launched T1 (one per map pair; its
#: two launches count once). Callers reset it to 0 and read it to show
#: that a run went through the kernel.
TAPER_LAUNCHES = 0

#: Most quadrature nodes T1 takes (``csrc/taper.cu:kMaxNodes``); the
#: planner's rule has 2 support + 8 <= 40.
MAX_NODES = 64


def taper_maps(nodes: torch.Tensor, folded: torch.Tensor, *, npix: int,
               ngrid: int, support: int, pixel_size_lm: float,
               wstacking: bool, dw: float, n_mid: float,
               mirror: bool = True) -> tuple:
    """
    ``(inv_corr, nm1s)``, each (npix, npix) float32 on the card of
    ``nodes``, from the quadrature rule ``nodes`` / ``folded`` (float32
    vectors on that card) and the plan's geometry, by T1.
    """
    global TAPER_LAUNCHES
    from . import _build

    for name, t in (("nodes", nodes), ("folded", folded)):
        if t.dtype != torch.float32 or t.dim() != 1:
            raise TypeError(f"{name} must be a float32 vector")
    if folded.device != nodes.device or folded.shape != nodes.shape:
        raise ValueError("nodes and folded must have one shape and device")
    nq = nodes.shape[0]
    if not 0 < nq <= MAX_NODES:
        raise ValueError(f"{nq} quadrature nodes; T1 takes 1 to "
                         f"{MAX_NODES}")
    if npix <= 0:
        raise ValueError(f"npix must be positive, not {npix}")
    if nodes.device.type != "cuda":
        raise ValueError(f"T1 runs on a CUDA device, not {nodes.device}")
    nodes, folded = nodes.contiguous(), folded.contiguous()
    device = nodes.device
    cuv = torch.empty(npix, dtype=torch.float32, device=device)
    inv_corr = torch.empty((npix, npix), dtype=torch.float32, device=device)
    nm1s = torch.empty_like(inv_corr)
    lib = _build.load_library()
    err = lib.cip_taper_maps(
        nodes.data_ptr(), folded.data_ptr(), nq, cuv.data_ptr(),
        inv_corr.data_ptr(), nm1s.data_ptr(), int(npix),
        # PyTorch's CUDA pix / ngrid is pix * fl(1 / ngrid).
        float(np.float32(1.0) / np.float32(ngrid)),
        float(pixel_size_lm), 2.0 * math.pi * (support / 2.0),
        float(support), float(dw), float(n_mid), int(bool(wstacking)),
        int(bool(mirror)), torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(err, "cip_taper_maps")
    TAPER_LAUNCHES += 1
    count("taper_kernel", 1)
    return inv_corr, nm1s
