"""
Gridding of visibility blocks onto a group of w-planes, and its
adjoint: kernel B1 (``csrc/grid.cu``, which is B4 at G = 1), kernel B3
(``csrc/degrid.cu``, which is B5 at G = 1), and their plain PyTorch
versions.

Counterpart: ``ska_sdp_cip_tpu/ops/pallas_gridder.py`` —
``pack_plan_columns`` (copied), the ES factor build
``_kernel_factors_group`` (ported in the plain versions), the kernels
built by ``build_grid_planes_pallas_group`` (G >= 2) and
``build_grid_planes_pallas`` (G = 1), replaced by :func:`grid_planes`,
and those built by ``build_degrid_planes_pallas_group`` and
``build_degrid_planes_pallas``, replaced by :func:`degrid_planes`.

:func:`grid_planes` and :func:`degrid_planes` dispatch on the device of
their tensors: CUDA tensors go to the hand-written kernel (or raise),
CPU tensors to the plain version. Nothing falls back from one to the
other. Unlike the TPU kernels, which read and write lane segments that
the caller seam-adds, all of them read or write whole
``(nalloc_x, nalloc_y)`` planes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.hostmem import alloc_populated
from .kernels import es_kernel
from .plan import GridderPlan

#: Launches of the B1 kernel (one per :func:`grid_planes` call on CUDA
#: tensors). Callers reset it to 0 and read it to show that a run went
#: through the kernel.
LAUNCHES = 0

#: Launches of the B3 kernel (one per :func:`degrid_planes` call on CUDA
#: tensors), read the same way.
DEGRID_LAUNCHES = 0

#: Plane-group sizes the kernel is instantiated for.
KERNEL_GROUPS = (1, 2)

#: Blocks per chunk of the plain version: bounds its (chunk, patch, B)
#: ES factor tensors (~50 MB at B = 1024).
REFERENCE_CHUNK = 64


def pack_plan_columns(plan: GridderPlan) -> np.ndarray:
    """
    (4, num_vis) f32 packed per-visibility plan data: patch-relative
    positions (xpos, ypos), |w| and the broadcast block length
    (counterpart ``pack_plan_columns``, copied).
    """
    num = plan.num_vis
    slot_block = np.arange(num) // plan.block
    packed = alloc_populated(4 * num, np.float32).reshape(4, num)
    packed[0] = (
        plan.x0 - plan.block_ox[slot_block]
    ).astype(np.float32) + plan.fx
    packed[1] = (
        plan.y0 - plan.block_oy[slot_block]
    ).astype(np.float32) + plan.fy
    packed[2] = plan.ws
    packed[3] = plan.block_len[slot_block].astype(np.float32)
    return packed


def _constants(plan: GridderPlan) -> dict:
    """Scalar kernel constants, rounded to float32 as the TPU kernel does."""
    return {
        "beta": float(np.float32(plan.beta)),
        "inv_half": float(np.float32(2.0 / plan.support)),
        "inv_whalf": float(np.float32(2.0 / (plan.support * plan.dw))),
    }


def _check_inputs(plan, packed, re, im, block_len, block_ox, block_oy,
                  w_g, blocks):
    device = packed.device
    for name, t, dtype in (
        ("packed", packed, torch.float32),
        ("re", re, torch.float32),
        ("im", im, torch.float32),
        ("block_len", block_len, torch.int32),
        ("block_ox", block_ox, torch.int32),
        ("block_oy", block_oy, torch.int32),
        ("w_g", w_g, torch.float32),
        ("blocks", blocks, torch.int32),
    ):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, packed on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if packed.dim() != 2 or packed.shape[0] < 3:
        raise ValueError(f"packed must be (>=3, V), got {tuple(packed.shape)}")
    num_vis = packed.shape[1]
    if num_vis != plan.num_vis or re.shape != (num_vis,) or im.shape != (
        num_vis,
    ):
        raise ValueError(
            f"slot columns must have plan.num_vis={plan.num_vis} entries"
        )
    for name, t in (
        ("block_len", block_len),
        ("block_ox", block_ox),
        ("block_oy", block_oy),
    ):
        if t.shape != (plan.num_blocks,):
            raise ValueError(f"{name} must be ({plan.num_blocks},)")
    if w_g.dim() != 1 or blocks.dim() != 1:
        raise ValueError("w_g and blocks must be 1-D")


def grid_planes(
    packed: torch.Tensor,
    re: torch.Tensor,
    im: torch.Tensor,
    block_len: torch.Tensor,
    block_ox: torch.Tensor,
    block_oy: torch.Tensor,
    w_g: torch.Tensor,
    blocks: torch.Tensor,
    *,
    plan: GridderPlan,
) -> torch.Tensor:
    """
    Grid the listed blocks onto the G = ``len(w_g)`` w-planes at ``w_g``.

    ``packed`` is (>= 3, num_vis) f32 with rows (xpos, ypos, |w|) as
    ``pack_plan_columns``/``build_assemble`` make them; ``re``/``im``
    the slot-order visibilities; ``block_len/ox/oy`` the plan's
    per-block int32 tables; ``blocks`` the int32 ids of the blocks
    active on any plane of the group (-1 entries are skipped). Returns
    (2G, nalloc_x, nalloc_y) f32 planes ordered re_0, im_0, re_1, ...
    """
    _check_inputs(plan, packed, re, im, block_len, block_ox, block_oy,
                  w_g, blocks)
    if packed.device.type == "cuda":
        return _grid_planes_cuda(
            packed, re, im, block_len, block_ox, block_oy, w_g, blocks,
            plan=plan,
        )
    if packed.device.type == "cpu":
        return grid_planes_reference(
            packed, re, im, block_len, block_ox, block_oy, w_g, blocks,
            plan=plan,
        )
    raise ValueError(f"unsupported device {packed.device}")


def _check_kernel_shape(plan: GridderPlan, G: int, name: str) -> None:
    """Raise unless the B1/B3 kernels are built for G and the patch fits."""
    if G not in KERNEL_GROUPS:
        raise ValueError(
            f"the {name} kernel is built for plane groups {KERNEL_GROUPS}, "
            f"got {G}"
        )
    smem = 2 * G * plan.patch_x * plan.patch_y * 4
    if smem > 227 * 1024:
        raise ValueError(
            f"patch ({plan.patch_x}, {plan.patch_y}) x {G} planes needs "
            f"{smem} B of shared memory, above the 227 KiB a block has"
        )
    if plan.support + 2 > 18:
        raise ValueError(f"support {plan.support} above the kernel's 16")


def _grid_planes_cuda(packed, re, im, block_len, block_ox, block_oy, w_g,
                      blocks, *, plan):
    global LAUNCHES
    from . import _build

    G = w_g.shape[0]
    _check_kernel_shape(plan, G, "B1")
    rows = [packed[i].contiguous() for i in range(3)]
    cols = [t.contiguous() for t in (re, im, block_len, block_ox, block_oy,
                                     blocks, w_g)]
    out = torch.zeros(
        (2 * G, plan.nalloc_x, plan.nalloc_y),
        dtype=torch.float32,
        device=packed.device,
    )
    lib = _build.load_library()
    k = _constants(plan)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = lib.cip_grid_planes(
        rows[0].data_ptr(), rows[1].data_ptr(), rows[2].data_ptr(),
        cols[0].data_ptr(), cols[1].data_ptr(), cols[2].data_ptr(),
        cols[3].data_ptr(), cols[4].data_ptr(), cols[5].data_ptr(),
        int(cols[5].shape[0]), cols[6].data_ptr(), int(G), out.data_ptr(),
        int(plan.block), int(plan.patch_x), int(plan.patch_y),
        int(plan.support), k["beta"], k["inv_half"], k["inv_whalf"],
        int(bool(plan.wstacking)), int(plan.nalloc_x), int(plan.nalloc_y),
        stream,
    )
    _build.check(err, "cip_grid_planes")
    LAUNCHES += 1
    return out


def grid_planes_reference(
    packed, re, im, block_len, block_ox, block_oy, w_g, blocks, *, plan
) -> torch.Tensor:
    """
    Plain PyTorch version of :func:`grid_planes`: per block, the dense
    ES factor matrices ax (patch_x, B) and ay (patch_y, B) and the
    patch product ``(ax * vis * amp) @ ay^T`` per plane (counterpart:
    the XLA branch of ``build_invert`` and ``_kernel_factors_group``),
    overlap-added into the planes, batched over ``REFERENCE_CHUNK``
    blocks at a time. Runs on any device, in the dtype of ``re``.
    """
    device = packed.device
    G = w_g.shape[0]
    PX, PY, B = plan.patch_x, plan.patch_y, plan.block
    nx, ny = plan.nalloc_x, plan.nalloc_y
    k = _constants(plan)
    out = torch.zeros((2 * G, nx * ny), dtype=re.dtype, device=device)
    blocks = blocks[blocks >= 0].to(torch.int64)
    iota_x = torch.arange(PX, dtype=torch.float32, device=device)
    iota_y = torch.arange(PY, dtype=torch.float32, device=device)
    lane_iota = torch.arange(B, device=device)
    cell = (
        torch.arange(PX, device=device)[:, None] * ny
        + torch.arange(PY, device=device)[None, :]
    )
    for start in range(0, blocks.shape[0], REFERENCE_CHUNK):
        bs = blocks[start : start + REFERENCE_CHUNK]
        slots = bs[:, None] * B + lane_iota[None, :]
        xpos, ypos, ws = (packed[i][slots] for i in range(3))
        ax = es_kernel(
            (iota_x[None, :, None] - xpos[:, None, :]) * k["inv_half"],
            k["beta"],
        )
        ay = es_kernel(
            (iota_y[None, :, None] - ypos[:, None, :]) * k["inv_half"],
            k["beta"],
        )
        lane = lane_iota[None, :] < block_len[bs].to(torch.int64)[:, None]
        origin = (
            block_ox[bs].to(torch.int64) * ny + block_oy[bs].to(torch.int64)
        )
        flat = (origin[:, None, None] + cell[None]).reshape(-1)
        vre, vim = re[slots], im[slots]
        for p in range(G):
            if plan.wstacking:
                kw = es_kernel((w_g[p] - ws) * k["inv_whalf"], k["beta"])
            else:
                kw = torch.ones_like(ws)
            amp = torch.where(lane, kw, torch.zeros_like(kw))
            for q, vis in enumerate((vre, vim)):
                patch = torch.einsum(
                    "nrk,nck->nrc", ax * (vis * amp)[:, None, :], ay
                )
                out[2 * p + q].index_add_(0, flat, patch.reshape(-1))
    return out.reshape(2 * G, nx, ny)


def degrid_planes(
    packed: torch.Tensor,
    block_len: torch.Tensor,
    block_ox: torch.Tensor,
    block_oy: torch.Tensor,
    grids: torch.Tensor,
    w_g: torch.Tensor,
    blocks: torch.Tensor,
    acc: torch.Tensor,
    *,
    plan: GridderPlan,
) -> torch.Tensor:
    """
    Degrid the listed blocks off the G = ``len(w_g)`` w-planes at
    ``w_g`` and ADD the summed contributions into ``acc`` (in place;
    returned). The adjoint of :func:`grid_planes`.

    ``packed``, ``block_len/ox/oy``, ``w_g`` and ``blocks`` are as in
    :func:`grid_planes`; ``grids`` is the (2G, nalloc_x, nalloc_y) f32
    stack of (already transformed and unfolded) planes ordered re_0,
    im_0, re_1, ...; ``acc`` is the (2, num_vis) f32 slot accumulator
    (re, im). Every slot belongs to exactly one block, so a block's
    slots are written by its own thread block only.
    """
    device = packed.device
    _check_inputs(plan, packed, acc[0], acc[1], block_len, block_ox,
                  block_oy, w_g, blocks)
    G = w_g.shape[0]
    shape = (2 * G, plan.nalloc_x, plan.nalloc_y)
    if tuple(grids.shape) != shape or grids.dtype != packed.dtype:
        raise ValueError(f"grids must be {packed.dtype} of shape {shape}")
    if grids.device != device:
        raise ValueError(f"grids is on {grids.device}, packed on {device}")
    if device.type == "cuda":
        return _degrid_planes_cuda(
            packed, block_len, block_ox, block_oy, grids, w_g, blocks, acc,
            plan=plan,
        )
    if device.type == "cpu":
        return degrid_planes_reference(
            packed, block_len, block_ox, block_oy, grids, w_g, blocks, acc,
            plan=plan,
        )
    raise ValueError(f"unsupported device {device}")


def _degrid_planes_cuda(packed, block_len, block_ox, block_oy, grids, w_g,
                        blocks, acc, *, plan):
    global DEGRID_LAUNCHES
    from . import _build

    G = w_g.shape[0]
    _check_kernel_shape(plan, G, "B3")
    if not (grids.is_contiguous() and acc.is_contiguous()):
        raise ValueError("grids and acc must be contiguous")
    rows = [packed[i].contiguous() for i in range(3)]
    cols = [t.contiguous() for t in (block_len, block_ox, block_oy, blocks,
                                     w_g)]
    lib = _build.load_library()
    k = _constants(plan)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = lib.cip_degrid_planes(
        rows[0].data_ptr(), rows[1].data_ptr(), rows[2].data_ptr(),
        cols[0].data_ptr(), cols[1].data_ptr(), cols[2].data_ptr(),
        cols[3].data_ptr(), int(cols[3].shape[0]), cols[4].data_ptr(),
        int(G), grids.data_ptr(), acc[0].data_ptr(), acc[1].data_ptr(),
        int(plan.block), int(plan.patch_x), int(plan.patch_y),
        int(plan.support), k["beta"], k["inv_half"], k["inv_whalf"],
        int(bool(plan.wstacking)), int(plan.nalloc_x), int(plan.nalloc_y),
        stream,
    )
    _build.check(err, "cip_degrid_planes")
    DEGRID_LAUNCHES += 1
    return acc


def degrid_planes_reference(
    packed, block_len, block_ox, block_oy, grids, w_g, blocks, acc, *, plan
) -> torch.Tensor:
    """
    Plain PyTorch version of :func:`degrid_planes` (counterpart: the
    XLA branch of ``build_predict``): per block, the dense ES factor
    matrices ax (patch_x, B) and ay (patch_y, B), ``tmp = ax^T @
    patch`` per plane, ``sum(tmp * ay)`` over the lanes, scaled by each
    plane's amp and summed over the planes, batched over
    ``REFERENCE_CHUNK`` blocks at a time. Runs on any device, in the
    dtype of ``grids``.
    """
    device = packed.device
    G = w_g.shape[0]
    PX, PY, B = plan.patch_x, plan.patch_y, plan.block
    ny = plan.nalloc_y
    k = _constants(plan)
    flat_planes = grids.reshape(2 * G, -1)
    blocks = blocks[blocks >= 0].to(torch.int64)
    iota_x = torch.arange(PX, dtype=grids.dtype, device=device)
    iota_y = torch.arange(PY, dtype=grids.dtype, device=device)
    lane_iota = torch.arange(B, device=device)
    cell = (
        torch.arange(PX, device=device)[:, None] * ny
        + torch.arange(PY, device=device)[None, :]
    )
    for start in range(0, blocks.shape[0], REFERENCE_CHUNK):
        bs = blocks[start : start + REFERENCE_CHUNK]
        slots = bs[:, None] * B + lane_iota[None, :]
        xpos, ypos, ws = (packed[i][slots] for i in range(3))
        ax = es_kernel(
            (iota_x[None, :, None] - xpos[:, None, :]) * k["inv_half"],
            k["beta"],
        )
        ay = es_kernel(
            (iota_y[None, :, None] - ypos[:, None, :]) * k["inv_half"],
            k["beta"],
        )
        lane = lane_iota[None, :] < block_len[bs].to(torch.int64)[:, None]
        origin = (
            block_ox[bs].to(torch.int64) * ny + block_oy[bs].to(torch.int64)
        )
        flat = origin[:, None, None] + cell[None]
        con = torch.zeros((2,) + slots.shape, dtype=grids.dtype,
                          device=device)
        for p in range(G):
            if plan.wstacking:
                kw = es_kernel((w_g[p] - ws) * k["inv_whalf"], k["beta"])
            else:
                kw = torch.ones_like(ws)
            amp = torch.where(lane, kw, torch.zeros_like(kw))
            for q in range(2):
                patch = flat_planes[2 * p + q][flat]  # (n, PX, PY)
                tmp = torch.einsum("nrk,nrc->nck", ax, patch)
                con[q] += (tmp * ay).sum(dim=1) * amp
        acc.view(2, -1).index_add_(1, slots.reshape(-1),
                                   con.reshape(2, -1).to(acc.dtype))
    return acc
