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
``build_degrid_planes_pallas``, replaced by :func:`degrid_planes`; and
from ``ska_sdp_cip_tpu/ops/gridder.py`` the wrap fold ``_fold_wraps``
and its adjoint ``_unfold_wraps``, which the kernels do inside.

:func:`grid_planes` and :func:`degrid_planes` write and read periodic
``(2G, ngrid, ngrid)`` planes, the grid the FFT passes take. They
dispatch on the device of their tensors: CUDA tensors go to the
hand-written kernel (or raise), CPU tensors to the folded plain version
(:func:`grid_planes_folded_reference`,
:func:`degrid_planes_folded_reference`). Nothing falls back from one to
the other. The plain versions proper (:func:`grid_planes_reference`,
:func:`degrid_planes_reference`) keep the counterpart's padded
``(nalloc_x, nalloc_y)`` alloc frame.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.hostmem import alloc_populated
from .kernels import es_kernel
from .plan import GridderPlan

#: Launches of the B1 kernel at G >= 2 (one per :func:`grid_planes` call
#: on CUDA tensors). Callers reset it to 0 and read it to show that a run
#: went through the kernel.
LAUNCHES = 0

#: Launches of B4, the B1 kernel at G = 1, counted the same way.
GROUP1_LAUNCHES = 0

#: Launches of the B3 kernel at G >= 2 (one per :func:`degrid_planes`
#: call on CUDA tensors), read the same way.
DEGRID_LAUNCHES = 0

#: Launches of B5, the B3 kernel at G = 1.
DEGRID_GROUP1_LAUNCHES = 0

#: Plane-group sizes the kernel is instantiated for.
KERNEL_GROUPS = (1, 2)

#: Blocks per chunk of the plain version: bounds its (chunk, patch, B)
#: ES factor tensors (~50 MB at B = 1024).
REFERENCE_CHUNK = 64

#: Shared memory a thread block may use (H100: 227 KiB).
SHARED_BYTES = 227 * 1024


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


def _unfold_wraps(plan: GridderPlan, g: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """
    Adjoint of :func:`_fold_wraps`: write the periodic N x N grid ``g``
    into the alloc frame ``out`` (nalloc_x, nalloc_y) with its wrap
    edges duplicated, rows first, then columns, as the counterpart does
    (so the corners match). ``out`` is written in place only inside
    [0, N + 2W)^2; the rest must already be zero.
    """
    N, W = plan.ngrid, plan.support
    out[W : W + N, W : W + N] = g
    out[W + N : N + 2 * W, W : W + N] = g[0:W, :]
    out[0:W, W : W + N] = g[N - W : N, :]
    out[: N + 2 * W, W + N : N + 2 * W] = out[: N + 2 * W, W : 2 * W]
    out[: N + 2 * W, 0:W] = out[: N + 2 * W, N : N + W]
    return out


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
    chunks: torch.Tensor | None = None,
) -> torch.Tensor:
    """
    Grid the listed blocks onto the G = ``len(w_g)`` w-planes at ``w_g``
    and fold them onto the periodic grid.

    ``packed`` is (>= 3, num_vis) f32 with rows (xpos, ypos, |w|) as
    ``pack_plan_columns``/``build_assemble`` make them; ``re``/``im``
    the slot-order visibilities; ``block_len/ox/oy`` the plan's
    per-block int32 tables; ``blocks`` the int32 ids of the blocks
    active on any plane of the group (-1 entries are skipped by the
    plain version); ``chunks`` the kernel's work list over ``blocks``
    (``ops/gridder.py:grid_chunks``: destination rectangles that
    partition the grid, each with the tile runs that reach it),
    required on CUDA tensors. Returns (2G, ngrid, ngrid) f32 periodic
    planes ordered re_0, im_0, re_1, ...; on the card every cell's sum
    runs in an order fixed by the plan and ``chunks``, so repeat calls
    give the same bits.
    """
    _check_inputs(plan, packed, re, im, block_len, block_ox, block_oy,
                  w_g, blocks)
    if packed.device.type == "cuda":
        return _grid_planes_cuda(
            packed, re, im, block_len, block_ox, block_oy, w_g, blocks,
            _check_chunks(chunks, blocks, "grid_chunks"), plan=plan,
        )
    if packed.device.type == "cpu":
        return grid_planes_folded_reference(
            packed, re, im, block_len, block_ox, block_oy, w_g, blocks,
            plan=plan,
        )
    raise ValueError(f"unsupported device {packed.device}")


def _check_chunks(chunks, blocks, builder: str) -> torch.Tensor:
    """The work list as a kernel reads it (``ops/gridder.py:<builder>``:
    (n, 2) rows for B3, (n, 4 + 2S) for B1), or raise."""
    if chunks is None:
        raise ValueError("the CUDA kernels need the chunk table of "
                         f"ops/gridder.py:{builder} (chunks=...)")
    width_ok = (chunks.shape[-1] == 2 if builder == "tile_chunks"
                else chunks.shape[-1] >= 6 and chunks.shape[-1] % 2 == 0)
    if (chunks.device != blocks.device or chunks.dtype != torch.int32
            or chunks.dim() != 2 or not width_ok):
        raise ValueError(f"chunks must be an int32 table of "
                         f"ops/gridder.py:{builder} on the device of blocks")
    return chunks.contiguous()


def _column_group(plan: GridderPlan) -> int:
    """Footprint columns a lane group covers in B3 (its CS)."""
    return 8 if plan.support <= 8 else 16


#: B1's slots of a block selected at a time and selected visibilities
#: staged at a time (``csrc/grid.cu``'s kWindow and kBatch).
GRID_WINDOW = 1024
GRID_BATCH = 128

#: Widest B1 destination rectangle that runs reach, in columns
#: (``ops/gridder.py:grid_chunks`` cuts wider ones): the columns of the
#: rectangle's planes that a thread block holds in shared memory.
GRID_PIECE_COLS = 64


def grid_piece_cols(plan: GridderPlan) -> int:
    """The columns of B1's shared planes for ``plan``."""
    return min(plan.patch_y, GRID_PIECE_COLS)


def _grid_shared_bytes(plan: GridderPlan, G: int) -> int:
    """B1's shared memory (``csrc/grid.cu``'s Layout): a ring of two
    buffers of GRID_BATCH staged visibilities (vis * amps, packed
    footprint start, W + W factors) with their fills, a window's
    selected slots with their ballots and offsets, and the 2G planes of
    a (tile_x, :func:`grid_piece_cols`) rectangle, rows that width + W
    floats apart."""
    W = plan.support
    floats = 2 * GRID_BATCH * (2 * G + 1 + 2 * W + 1)
    floats += GRID_WINDOW + 2 * (GRID_WINDOW // 32) + 1 + 4
    floats += 2 * G * plan.tile_x * (grid_piece_cols(plan) + W)
    return 4 * floats


def _degrid_shared_bytes(plan: GridderPlan, G: int) -> int:
    """B3's shared memory: two sets of 2G patch windows, rows patch_y +
    CS floats apart."""
    stride = plan.patch_y + _column_group(plan)
    return 2 * 2 * G * plan.patch_x * stride * 4


def _check_kernel_shape(plan: GridderPlan, G: int, name: str,
                        smem: int) -> None:
    """Raise unless the B1/B3 kernels are built for G and ``smem`` bytes
    of shared memory fit in a thread block."""
    if G not in KERNEL_GROUPS:
        raise ValueError(
            f"the {name} kernel is built for plane groups {KERNEL_GROUPS}, "
            f"got {G}"
        )
    if plan.support > 16:
        raise ValueError(f"support {plan.support} above the kernel's 16")
    if float(np.float32(2.0 / plan.support)) < 2.0 / plan.support:
        # The kernels evaluate only the W cells after floor(pos - W/2):
        # the cells either side must come out exactly zero.
        raise ValueError(f"float32(2 / {plan.support}) rounds down")
    if plan.patch_y % 4:
        raise ValueError(f"patch_y {plan.patch_y} is not a multiple of 4")
    if smem > SHARED_BYTES:
        raise ValueError(
            f"the {name} kernel at patch ({plan.patch_x}, {plan.patch_y}) "
            f"x {G} planes needs {smem} B of shared memory, above the "
            f"{SHARED_BYTES} B a block has"
        )


def _grid_planes_cuda(packed, re, im, block_len, block_ox, block_oy, w_g,
                      blocks, chunks, *, plan):
    global LAUNCHES, GROUP1_LAUNCHES
    from . import _build

    G = w_g.shape[0]
    _check_kernel_shape(plan, G, "B1", _grid_shared_bytes(plan, G))
    # Any grid: the work list's rectangles (ops/gridder.py:grid_chunks)
    # keep every footprint start rectangle-local, and the planes' size
    # is bounded by the card's memory alone.
    rows = [packed[i].contiguous() for i in range(3)]
    cols = [t.contiguous() for t in (re, im, block_len, block_ox, block_oy,
                                     blocks, w_g)]
    N = plan.ngrid
    # The work list's rectangles partition the grid: every cell is
    # written, so the planes need no zeroing.
    out = torch.empty((2 * G, N, N), dtype=torch.float32,
                      device=packed.device)
    lib = _build.load_library()
    k = _constants(plan)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = lib.cip_grid_planes(
        rows[0].data_ptr(), rows[1].data_ptr(), rows[2].data_ptr(),
        cols[0].data_ptr(), cols[1].data_ptr(), cols[2].data_ptr(),
        cols[3].data_ptr(), cols[4].data_ptr(), cols[5].data_ptr(),
        chunks.data_ptr(), int(chunks.shape[0]), int(chunks.shape[1]),
        cols[6].data_ptr(), int(G), out.data_ptr(), int(plan.block),
        int(plan.patch_x), int(plan.patch_y), int(plan.tile_x),
        int(grid_piece_cols(plan)), int(plan.support), k["beta"],
        k["inv_half"], k["inv_whalf"], int(bool(plan.wstacking)), int(N),
        stream,
    )
    _build.check(err, "cip_grid_planes")
    if G == 1:
        GROUP1_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def grid_planes_reference(
    packed, re, im, block_len, block_ox, block_oy, w_g, blocks, *, plan
) -> torch.Tensor:
    """
    Plain PyTorch version of the TPU kernels :func:`grid_planes`
    replaces, in their (2G, nalloc_x, nalloc_y) alloc frame: per block,
    the dense ES factor matrices ax (patch_x, B) and ay (patch_y, B) and
    the patch product ``(ax * vis * amp) @ ay^T`` per plane
    (counterpart: the XLA branch of ``build_invert`` and
    ``_kernel_factors_group``), overlap-added into the planes, batched
    over ``REFERENCE_CHUNK`` blocks at a time. Runs on any device, in
    the dtype of ``re``.
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


def grid_planes_folded_reference(
    packed, re, im, block_len, block_ox, block_oy, w_g, blocks, *, plan
) -> torch.Tensor:
    """
    Plain version of :func:`grid_planes`: :func:`grid_planes_reference`
    folded plane by plane onto the periodic grid (:func:`_fold_wraps`),
    the same arithmetic as the counterpart's gridding then fold.
    """
    planes = grid_planes_reference(
        packed, re, im, block_len, block_ox, block_oy, w_g, blocks,
        plan=plan,
    )
    # Plane by plane into one stack: one fold's temporaries at a time.
    out = planes.new_empty((planes.shape[0], plan.ngrid, plan.ngrid))
    for q, p in enumerate(planes):
        out[q] = _fold_wraps(plan, p)
    return out


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
    chunks: torch.Tensor | None = None,
) -> torch.Tensor:
    """
    Degrid the listed blocks off the G = ``len(w_g)`` periodic w-planes
    at ``w_g`` and ADD the summed contributions into ``acc`` (in place;
    returned). The adjoint of :func:`grid_planes`.

    ``packed``, ``block_len/ox/oy``, ``w_g`` and ``blocks`` are as in
    :func:`grid_planes`; ``chunks`` is B3's (first, count) table
    over ``blocks`` (``ops/gridder.py:tile_chunks``), required on CUDA
    tensors; ``grids`` is the (2G, ngrid, ngrid)
    f32 stack of (already transformed) periodic planes ordered re_0,
    im_0, re_1, ...; ``acc`` is the (2, num_vis) f32 slot accumulator
    (re, im). Every slot belongs to exactly one block, so a block's
    slots are written by its own warps only.
    """
    device = packed.device
    _check_inputs(plan, packed, acc[0], acc[1], block_len, block_ox,
                  block_oy, w_g, blocks)
    G = w_g.shape[0]
    shape = (2 * G, plan.ngrid, plan.ngrid)
    if tuple(grids.shape) != shape or grids.dtype != packed.dtype:
        raise ValueError(f"grids must be {packed.dtype} of shape {shape}")
    if grids.device != device:
        raise ValueError(f"grids is on {grids.device}, packed on {device}")
    if device.type == "cuda":
        return _degrid_planes_cuda(
            packed, block_len, block_ox, block_oy, grids, w_g, blocks, acc,
            _check_chunks(chunks, blocks, "tile_chunks"), plan=plan,
        )
    if device.type == "cpu":
        return degrid_planes_folded_reference(
            packed, block_len, block_ox, block_oy, grids, w_g, blocks, acc,
            plan=plan,
        )
    raise ValueError(f"unsupported device {device}")


def _degrid_planes_cuda(packed, block_len, block_ox, block_oy, grids, w_g,
                        blocks, acc, chunks, *, plan):
    global DEGRID_LAUNCHES, DEGRID_GROUP1_LAUNCHES
    from . import _build

    G = w_g.shape[0]
    _check_kernel_shape(plan, G, "B3", _degrid_shared_bytes(plan, G))
    if not (grids.is_contiguous() and acc.is_contiguous()):
        raise ValueError("grids and acc must be contiguous")
    if grids.data_ptr() % 16:
        raise ValueError("grids must start on a 16-byte boundary")
    rows = [packed[i].contiguous() for i in range(3)]
    cols = [t.contiguous() for t in (block_len, block_ox, block_oy, blocks,
                                     w_g)]
    lib = _build.load_library()
    k = _constants(plan)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = lib.cip_degrid_planes(
        rows[0].data_ptr(), rows[1].data_ptr(), rows[2].data_ptr(),
        cols[0].data_ptr(), cols[1].data_ptr(), cols[2].data_ptr(),
        cols[3].data_ptr(), chunks.data_ptr(), int(chunks.shape[0]),
        cols[4].data_ptr(), int(G), grids.data_ptr(), acc[0].data_ptr(),
        acc[1].data_ptr(), int(plan.block), int(plan.patch_x),
        int(plan.patch_y), int(plan.support), k["beta"], k["inv_half"],
        k["inv_whalf"], int(bool(plan.wstacking)), int(plan.ngrid), stream,
    )
    _build.check(err, "cip_degrid_planes")
    if G == 1:
        DEGRID_GROUP1_LAUNCHES += 1
    else:
        DEGRID_LAUNCHES += 1
    return acc


def degrid_planes_reference(
    packed, block_len, block_ox, block_oy, grids, w_g, blocks, acc, *, plan
) -> torch.Tensor:
    """
    Plain PyTorch version of the TPU kernels :func:`degrid_planes`
    replaces, reading (2G, nalloc_x, nalloc_y) alloc-frame planes
    (counterpart: the XLA branch of ``build_predict``): per block, the
    dense ES factor matrices ax (patch_x, B) and ay (patch_y, B),
    ``tmp = ax^T @ patch`` per plane, ``sum(tmp * ay)`` over the lanes,
    scaled by each plane's amp and summed over the planes, batched over
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


def _unfold_planes(plan: GridderPlan, grids: torch.Tensor) -> torch.Tensor:
    """The (2G, nalloc_x, nalloc_y) alloc frame of periodic (2G, N, N)
    planes: :func:`_unfold_wraps` plane by plane into zeros."""
    out = grids.new_zeros((grids.shape[0], plan.nalloc_x, plan.nalloc_y))
    for q in range(grids.shape[0]):
        _unfold_wraps(plan, grids[q], out[q])
    return out


def degrid_planes_folded_reference(
    packed, block_len, block_ox, block_oy, grids, w_g, blocks, acc, *, plan
) -> torch.Tensor:
    """
    Plain version of :func:`degrid_planes`: :func:`degrid_planes_reference`
    on the periodic planes unfolded into the alloc frame
    (:func:`_unfold_planes`), the counterpart's unfold then degridding.
    """
    return degrid_planes_reference(
        packed, block_len, block_ox, block_oy, _unfold_planes(plan, grids),
        w_g, blocks, acc, plan=plan,
    )
