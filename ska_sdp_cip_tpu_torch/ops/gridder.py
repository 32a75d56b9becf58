"""
Invert (visibilities -> dirty image) on the plane-group path.

Counterpart: ``ska_sdp_cip_tpu/ops/gridder.py``, the parts the invert
slice runs:

* ``_geometry_maps`` / ``_quad_arrays`` (image-domain correction maps);
* ``plan_host_arrays`` — here only what the port reads;
* ``compact_plan_host_arrays`` (numpy, copied) and ``build_assemble``
  with its double-float helpers (``_two_sum`` ... ``_df_grid_coord``),
  as torch ops;
* ``_fold_wraps``;
* the plane-group branch of ``build_invert``: per group of G planes,
  gridding (kernel B1, ``ops/cuda_gridder.py``) -> ``_fold_wraps`` ->
  two fused first-axis DFT passes per plane (kernel B2,
  ``ops/fft_cuda.py``; the counterpart's ``_fft2_to_image_fused_t``) ->
  w-screen correction -> accumulate -> ``finalize_image``. The same
  loop serves ``plane_group == 1``;
* ``dirty_image`` on the compact staging path.

Everything runs eagerly on the device of the staged tensors; the
kernels' plain versions run where the tensors lie on the CPU. The
XLA-scan gridder, predict, the distributed FFT and the AOT cache are
not part of this slice (ROADMAP.md, queue A).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .cuda_gridder import grid_planes
from .fft import fft_plan_arrays, make_fft_plan
from .fft_cuda import (
    fft_first_axis_fused,
    fused_pass_host_arrays,
    fused_pass_meta,
)
from .kernels import correction
from .plan import GridderPlan, make_plan

SPEED_OF_LIGHT = 299792458.0


def resolve_device(device) -> torch.device:
    """The ``torch.device`` for ``device``; a CUDA device needs a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def stage_arrays(host: dict, device) -> dict:
    """
    Host numpy arrays -> tensors on ``device`` (same keys); Python ints
    stay as they are. uint16 arrays are widened to int32 first: torch's
    unsigned 16-bit type supports few operations.
    """
    device = resolve_device(device)
    staged = {}
    for key, value in host.items():
        if isinstance(value, int):
            staged[key] = value
            continue
        value = np.ascontiguousarray(value)
        if value.dtype == np.uint16:
            value = value.astype(np.int32)
        staged[key] = torch.from_numpy(value).to(device)
    return staged


def _geometry_maps(plan: GridderPlan, arrays: dict) -> tuple:
    """
    Image-domain maps ``(inv_corr, nm1s)``: the fused uv-taper x
    w-taper x 1/n correction and n(l,m) - 1 - n_mid (the w-screen
    argument), computed on the device of ``arrays``.
    """
    npix, ngrid = plan.num_pixels, plan.ngrid
    nodes = arrays["quad_nodes"]
    folded = arrays["quad_folded"]
    support = plan.support

    pix = (
        torch.arange(npix, dtype=torch.float32, device=nodes.device)
        - npix // 2
    )
    cuv = correction(pix / ngrid, nodes, folded, support)
    corr = torch.outer(cuv, cuv)
    axis = pix * plan.pixel_size_lm
    r2 = axis[:, None] ** 2 + axis[None, :] ** 2
    nm1 = -r2 / (1.0 + torch.sqrt(torch.clamp(1.0 - r2, min=0.0)))
    if plan.wstacking:
        cw = correction(plan.dw * (nm1 - plan.n_mid), nodes, folded, support)
        corr = corr * cw * (nm1 + 1.0)
    return 1.0 / corr, nm1 - plan.n_mid


def _quad_arrays(plan: GridderPlan) -> dict:
    """The quadrature rule `_geometry_maps` reads, as float32."""
    return {
        "quad_nodes": plan.quad_nodes.astype(np.float32),
        "quad_folded": plan.quad_folded.astype(np.float32),
    }


def _fused_fft_meta(plan: GridderPlan):
    """Geometry of the fused invert FFT passes (image crop)."""
    npix = plan.num_pixels
    crop0 = (plan.ngrid - npix) // 2
    return fused_pass_meta(
        make_fft_plan(plan.ngrid, shifted=True), (crop0, npix)
    )


def group_active_blocks(plan: GridderPlan) -> list:
    """
    Per plane group, the sorted ids of the blocks active on any of its
    planes: the union of the group's rows of ``plan.active_table``.
    """
    G = plan.plane_group
    table = plan.active_table
    groups = []
    for k in range(plan.num_groups):
        rows = table[k * G : min((k + 1) * G, plan.nplanes)]
        groups.append(np.unique(rows[rows >= 0]).astype(np.int32))
    return groups


def plan_host_arrays(plan: GridderPlan, device) -> dict:
    """
    Host (numpy) arrays of a plan that the port's invert reads on
    ``device``: the per-block tables, the (num_groups, G) plane w's,
    the per-group active block lists (padded with -1), the quadrature
    rule, and the first-axis DFT factors of the pass that runs there —
    the fused kernel's (``fftp_*``) on a CUDA device, the plain
    version's (``fft_*``) on the CPU.
    """
    G = plan.plane_group
    wg = plan.w0 + plan.dw * np.arange(G * plan.num_groups, dtype=np.float64)
    lists = group_active_blocks(plan)
    width = max(max((len(x) for x in lists), default=0), 1)
    group_blocks = np.full((len(lists), width), -1, np.int32)
    for k, ids in enumerate(lists):
        group_blocks[k, : len(ids)] = ids
    arrays = {
        "block_len": plan.block_len.astype(np.int32),
        "block_oy": plan.block_oy.astype(np.int32),
        # Ragged final groups are padded with would-be planes >= nplanes,
        # outside every block's ES window (zero contributions).
        "plane_wg": wg.astype(np.float32).reshape(-1, G),
        "group_blocks": group_blocks,
    }
    arrays.update(_quad_arrays(plan))
    fft_plan = make_fft_plan(plan.ngrid, shifted=True)
    if resolve_device(device).type == "cuda":
        arrays.update(
            fused_pass_host_arrays(
                fft_plan, _fused_fft_meta(plan), sign=+1, prefix="fftp"
            )
        )
    else:
        arrays.update(fft_plan_arrays(fft_plan, prefix="fft"))
    return arrays


def compact_plan_host_arrays(
    plan: GridderPlan,
    uvw: np.ndarray,
    channel_frequencies: np.ndarray,
    device,
) -> dict:
    """
    Host staging dict of the compact path for ``device`` (counterpart
    copy): :func:`plan_host_arrays` plus the delta-compressed slot
    source-index map (``oe_first``/``oe_delta``/``oe_exc_pos``/
    ``oe_exc_val``), hi/lo float32 splits of the f64 ``uvw`` and
    ``freq / c``, and the per-block x origin ``cblock_ox``. Consumed by
    :func:`build_assemble`.
    """
    arrays = plan_host_arrays(plan, device)
    if plan.order_enc is not None:
        enc = plan.order_enc
    else:
        order = plan.order
        if plan.flip_sign is not None:
            flipped = plan.flip_sign < 0
        elif plan.flip is not None:
            flipped = plan.flip.astype(bool)
        else:
            flipped = np.zeros(len(order), bool)
        enc = np.where(
            flipped, -order.astype(np.int64) - 1, order
        ).astype(np.int32)
    idx = np.where(enc < 0, -enc - 1, enc).astype(np.int64)
    num_blocks = plan.num_blocks
    block = plan.block
    blocks = idx.reshape(num_blocks, block)
    deltas = np.zeros((num_blocks, block), np.int64)
    deltas[:, 1:] = np.diff(blocks, axis=1)
    bad = (deltas < 0) | (deltas >= 65536)
    exc_pos = np.flatnonzero(bad).astype(np.int32)
    arrays["oe_first"] = blocks[:, 0].astype(np.int32)
    arrays["oe_delta"] = (
        np.where(bad, 0, deltas).astype(np.uint16).reshape(-1)
    )
    arrays["oe_exc_pos"] = exc_pos
    arrays["oe_exc_val"] = deltas.reshape(-1)[exc_pos].astype(np.int32)
    uvw64 = np.ascontiguousarray(uvw, np.float64)
    hi = uvw64.astype(np.float32)
    arrays["uvw_hi"] = hi
    arrays["uvw_lo"] = (uvw64 - hi).astype(np.float32)
    scale = np.asarray(channel_frequencies, np.float64) / SPEED_OF_LIGHT
    shi = scale.astype(np.float32)
    arrays["scale_hi"] = shi
    arrays["scale_lo"] = (scale - shi).astype(np.float32)
    arrays["cblock_ox"] = plan.block_ox.astype(np.int32)
    return arrays


# Double-float (f32 hi + lo) arithmetic. Every operation is its own
# eager torch op, so no multiply-add is contracted into an FMA and the
# error-free transforms stay exact. Scalars enter as 0-d float32
# tensors so that splits happen in float32, not in Python's double.


def _two_sum(a, b):
    """Knuth two-sum: (s, e) with s + e == a + b exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """Dekker/Veltkamp product: (p, e) with p + e == a * b exactly."""
    split = 4097.0  # 2^12 + 1
    p = a * b
    abig = a * split
    ahi = abig - (abig - a)
    alo = a - ahi
    bbig = b * split
    bhi = bbig - (bbig - b)
    blo = b - bhi
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def _df_mul(ah, al, bh, bl):
    """Double-float multiply: (ah+al) * (bh+bl) to ~48-bit precision."""
    p, e = _two_prod(ah, bh)
    e = e + (ah * bl + al * bh)
    return _two_sum(p, e)


def _df_add_exact(ah, al, b):
    """Double-float plus an exactly-representable f32 value."""
    s, e = _two_sum(ah, b)
    return s, e + al


def _df_grid_coord(bh, bl, sgn, sh, sl, inv_du, ngrid, support):
    """
    Grid coordinate ``mod(coord * freq/c / du + ngrid/2, ngrid) +
    support`` in double-float, mirroring the host planner's f64 path.
    Returns an (hi, lo) pair in the alloc frame.
    """

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=bh.device)

    ih = f32(float(np.float32(inv_du)))
    il = f32(float(inv_du) - float(np.float32(inv_du)))
    xh, xl = _df_mul(bh * sgn, bl * sgn, sh, sl)
    xh, xl = _df_mul(xh, xl, ih, il)
    xh, xl = _df_add_exact(xh, xl, f32(ngrid / 2.0))
    k = torch.floor(xh / ngrid)
    xh, xl = _df_add_exact(xh, xl, -k * f32(ngrid))
    xh = torch.where(xh >= ngrid, xh - ngrid, xh)
    xh = torch.where(xh < 0, xh + ngrid, xh)
    return _df_add_exact(xh, xl, f32(support))


def build_assemble(plan: GridderPlan):
    """
    Device prologue of the compact staging path: rebuild the per-slot
    ``packed`` rows (patch-relative x, y, |w|) and gather/conjugate/
    pre-phase the data-order visibilities into slot order. Returns
    ``assemble(arrays, re_data, im_data) -> (arrays_with_packed, re_s,
    im_s)``. The double-float positions are collapsed to float32 at grid
    scale before the block origin is subtracted, as in the counterpart
    (one float32 ulp of the grid size; ROADMAP.md Queue C, C1).
    """
    num_data = plan.num_vis_data
    support = plan.support
    ngrid = plan.ngrid
    inv_du = 1.0 / plan.du
    factor = float(np.float32(-2.0 * np.pi * plan.n_mid))
    block = plan.block
    wstacking = plan.wstacking

    def assemble(arrays, re_data, im_data):
        device = re_data.device
        one = torch.tensor(1.0, dtype=torch.float32, device=device)
        # Dense data-order pass: geometry, flip, pre-phase.
        uh2 = arrays["uvw_hi"][:, :, None]
        ul2 = arrays["uvw_lo"][:, :, None]
        sh = arrays["scale_hi"][None, :]
        sl = arrays["scale_lo"][None, :]
        w_hi = uh2[:, 2] * sh
        sgn_d = torch.where(w_hi < 0, -one, one)
        xh, xl = _df_grid_coord(
            uh2[:, 0], ul2[:, 0], sgn_d, sh, sl, inv_du, ngrid, support
        )
        yh, yl = _df_grid_coord(
            uh2[:, 1], ul2[:, 1], sgn_d, sh, sl, inv_du, ngrid, support
        )
        wh, wl = _df_mul(uh2[:, 2] * sgn_d, ul2[:, 2] * sgn_d, sh, sl)
        xglob = (xh + xl).reshape(-1)
        yglob = (yh + yl).reshape(-1)
        ws_d = (wh + wl).reshape(-1)
        sgn_d = sgn_d.reshape(-1)
        re_d = re_data
        im_d = im_data * sgn_d
        if wstacking:
            theta = factor * ws_d
            cos = torch.cos(theta)
            sin = torch.sin(theta)
            re_d, im_d = re_d * cos - im_d * sin, re_d * sin + im_d * cos

        # Slot pass: expand the delta-compressed slot indices and
        # gather one (N, 5) row table.
        deltas = arrays["oe_delta"].to(torch.int32, copy=True)
        deltas[arrays["oe_exc_pos"].to(torch.int64)] = arrays["oe_exc_val"]
        deltas = deltas.reshape(arrays["oe_first"].shape[0], block)
        idx = (
            torch.cumsum(deltas, dim=1, dtype=torch.int64)
            + arrays["oe_first"][:, None]
        ).reshape(-1)
        num_slots = idx.shape[0]
        mask = idx < num_data

        def per_block(table):
            return (
                table[:, None]
                .expand(table.shape[0], block)
                .reshape(-1)[:num_slots]
                .to(torch.float32)
            )

        box = per_block(arrays["cblock_ox"])
        boy = per_block(arrays["block_oy"])
        table = torch.stack([xglob, yglob, ws_d, re_d, im_d], dim=1)
        g = table[idx.clamp(0, table.shape[0] - 1)]

        def col(k, fill):
            return torch.where(mask, g[:, k], fill)

        pad_pos = torch.tensor(
            support + 0.5, dtype=torch.float32, device=device
        )
        zero_s = torch.zeros((), dtype=torch.float32, device=device)
        out = dict(arrays)
        out["packed"] = torch.stack(
            [
                col(0, pad_pos + box) - box,
                col(1, pad_pos + boy) - boy,
                col(2, zero_s),
            ]
        )
        return out, col(3, zero_s), col(4, zero_s)

    return assemble


def stage_compact(plan: GridderPlan, uvw, channel_frequencies, weighted,
                  device) -> tuple:
    """
    Compact staging of weighted (nrow, nchan) visibilities onto
    ``device`` and the :func:`build_assemble` prologue: returns
    ``(arrays, re_s, im_s)`` ready for :func:`build_invert`.
    """
    arrays = stage_arrays(
        compact_plan_host_arrays(plan, uvw, channel_frequencies, device),
        device,
    )
    weighted = np.asarray(weighted, np.complex64).ravel()
    re = torch.from_numpy(np.ascontiguousarray(weighted.real))
    im = torch.from_numpy(np.ascontiguousarray(weighted.imag))
    return build_assemble(plan)(arrays, re.to(device), im.to(device))


def _fold_wraps(plan: GridderPlan, grid: torch.Tensor) -> torch.Tensor:
    """Fold the padded alloc frame back onto the periodic N x N grid."""
    N, W = plan.ngrid, plan.support
    g = grid[W : W + N, :].clone()
    g[0:W, :] += grid[W + N : N + 2 * W, :]
    g[N - W : N, :] += grid[0:W, :]
    g2 = g[:, W : W + N].clone()
    g2[:, 0:W] += g[:, W + N : N + 2 * W]
    g2[:, N - W : N] += g[:, 0:W]
    return g2


def _fft2_to_image_t(arrays, grid_re, grid_im, fmeta):
    """
    Centred inverse 2-D DFT of the (N, N) grid cropped to the image,
    returned TRANSPOSED: two fused first-axis passes (B2) with one
    transpose between them (counterpart ``_fft2_to_image_fused_t``).
    """
    a_re, a_im = fft_first_axis_fused(
        grid_re, grid_im, arrays, meta=fmeta, sign=+1
    )
    return fft_first_axis_fused(
        a_re.t().contiguous(), a_im.t().contiguous(), arrays,
        meta=fmeta, sign=+1,
    )


def build_invert(plan: GridderPlan):
    """
    Returns ``invert(arrays, re_s, im_s) -> image``: the unnormalized
    (npix, npix) float32 dirty image from slot-order visibilities
    (``build_assemble``'s output), on the device of the tensors.
    ``arrays`` must hold ``packed`` and the arrays of
    :func:`compact_plan_host_arrays`.
    """
    G = plan.plane_group
    npix = plan.num_pixels
    fmeta = _fused_fft_meta(plan)
    counts = [len(ids) for ids in group_active_blocks(plan)]

    def invert(arrays, re_s, im_s):
        inv_corr, nm1s = _geometry_maps(plan, arrays)
        image = torch.zeros(
            (npix, npix), dtype=torch.float32, device=re_s.device
        )
        for k in range(plan.num_groups):
            w_g = arrays["plane_wg"][k]
            planes = grid_planes(
                arrays["packed"],
                re_s,
                im_s,
                arrays["block_len"],
                arrays["cblock_ox"],
                arrays["block_oy"],
                w_g,
                arrays["group_blocks"][k, : counts[k]],
                plan=plan,
            )
            # Planes of a ragged final group beyond nplanes are empty.
            for i in range(min(G, plan.nplanes - k * G)):
                img_re, img_im = _fft2_to_image_t(
                    arrays,
                    _fold_wraps(plan, planes[2 * i]),
                    _fold_wraps(plan, planes[2 * i + 1]),
                    fmeta,
                )
                if plan.wstacking:
                    # nm1s is transpose-symmetric, so the transposed
                    # images accumulate correctly.
                    theta = (-2.0 * math.pi * w_g[i]) * nm1s
                    image = image + (
                        img_re * torch.cos(theta) - img_im * torch.sin(theta)
                    )
                else:
                    image = image + img_re
        return (image * inv_corr).t().contiguous()

    return invert


def dirty_image(
    uvw,
    channel_frequencies,
    visibilities,
    weights,
    num_pixels: int,
    pixel_size_lm: float,
    *,
    epsilon: float = 1e-4,
    do_wstacking: bool = True,
    sigma: float | str = 2.0,
    device,
) -> np.ndarray:
    """
    Unnormalized dirty image of weighted visibilities (``ms2dirty``
    analog; counterpart ``dirty_image`` on its compact path).
    ``visibilities``/``weights`` have shape (nrow, nchan); the work
    runs on ``device`` and a float32 (npix, npix) numpy array returns.
    """
    device = resolve_device(device)
    plan = make_plan(
        uvw,
        channel_frequencies,
        num_pixels,
        pixel_size_lm,
        epsilon=epsilon,
        do_wstacking=do_wstacking,
        sigma=sigma,
        export_packed=False,
    )
    weighted = np.asarray(visibilities, np.complex64) * np.asarray(
        weights, np.float32
    )
    arrays, re_s, im_s = stage_compact(
        plan, uvw, channel_frequencies, weighted, device
    )
    image = build_invert(plan)(arrays, re_s, im_s)
    return image.cpu().numpy()
