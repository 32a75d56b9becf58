"""
Invert (visibilities -> dirty image) and its adjoint, predict (image ->
visibilities), on the plane-group path.

Counterpart: ``ska_sdp_cip_tpu/ops/gridder.py``:

* ``_geometry_maps`` / ``_quad_arrays`` (image-domain correction maps):
  on a card kernel T1 (``ops/taper_cuda.py``, ``csrc/taper.cu``) writes
  both maps in one pass; its plain version, the counterpart's torch
  twin, is ``_geometry_maps_reference``, which the CPU runs;
* ``plan_host_arrays`` — here only what the port reads;
* ``plan_order_host`` and ``stage_slot_vis`` (with their native engine
  branches, ``native.py``), ``stage_slot_weights`` and
  ``slot_duplicate_pairs`` (numpy, copied), ``slot_group_sum`` and
  ``_prepare_sorted_vis`` as torch ops;
* ``compact_plan_host_arrays`` (numpy, copied) and ``build_assemble``
  with its double-float helpers (``_two_sum`` ... ``_df_grid_coord``),
  as torch ops (positions formed at patch scale, ROADMAP.md C1);
* ``_fold_wraps`` and its adjoint ``_unfold_wraps`` (now in
  ``ops/cuda_gridder.py``, inside the kernels' plain versions: the
  kernels write and read the periodic grid themselves);
* the plane-group branch of ``build_invert``: per group of G planes,
  gridding and fold (kernel B1, ``ops/cuda_gridder.py``, over the
  destination rectangles of :func:`grid_chunks`) -> per plane one
  fused DFT pass along axis 0 (kernel B2, ``ops/fft_cuda.py``) and one
  along the last axis (kernel B2L) whose store applies the w-screen and
  adds the plane into the image (the counterpart's
  ``_fft2_to_image_fused_t``, its transposes, screen and accumulation)
  -> ``finalize_image``; the image comes out the right way round, with
  no transpose anywhere;
* the plane-group branch of ``build_predict``, its adjoint: per group,
  per plane one in-cropped B2L pass whose load applies the w-screen to
  the image, then one in-cropped B2 pass along axis 0 that writes the
  periodic grid row-major into the group's stack (the counterpart's
  screen and ``fft2_from_image_fused``, with no transpose), then one
  unfold-and-degrid launch for the group (kernel B3) into a slot
  accumulator -> ``_finalize``. Both loops also serve
  ``plane_group == 1``;
* the distributed mode of ``build_invert`` and ``build_predict`` (the
  counterpart's ``mesh_axis`` / ``num_shards`` branches) over a mesh of
  ``parallel/mesh.py``: the plane grids reduced and scattered over the
  shards, B2 run on column slabs of N/S and npix/S with an all-to-all
  between the passes (this mode keeps B2 on both passes, with its
  transposes and torch's screens: ROADMAP.md, Queue B);
* ``dirty_image`` on the compact staging path and
  ``predict_visibilities``, whose results come down through pinned
  buffers (``utils/staging.py``).

The plane groups' work lists (active blocks, B1's rectangles, B3's
chunks) are built once per plan, by :func:`work_lists`; staging uploads
them and the builders read them.

Spans and counters (``utils/task_metrics.py``; nothing while the
recorder is off): ``dirty_image`` is the root span ``image`` over
``plan``, ``weight``, ``stage`` (``stage.host_arrays``,
``stage.upload``, ``stage.assemble``), ``invert`` and ``download``;
the one build of a plan's work lists is ``invert.work_lists`` (inside
``stage.host_arrays`` on ``dirty_image``'s path), the maps of every
invert and predict ``invert.taper`` / ``predict.taper``, and each plane
group of the invert ``invert.group`` (counters ``active_blocks``,
``b1_chunks``, ``slot_visits``).

Everything runs eagerly on the device of the staged tensors; the
kernels' plain versions run where the tensors lie on the CPU. The
XLA-scan gridder and the AOT cache are not ported (ROADMAP.md, queue
A).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import native as _native
from ..utils.staging import device_get, device_put_parallel, resolve_device
from ..utils.task_metrics import count, span
from .cuda_gridder import (  # noqa: F401  (the fold stays importable here,
                             # where the counterpart keeps it)
    _fold_wraps,
    _unfold_wraps,
    degrid_planes,
    grid_piece_cols,
    grid_planes,
    pack_plan_columns,
)
from .fft import fft_plan_arrays, make_fft_plan
from .fft_cuda import (
    fft_first_axis_fused,
    fft_last_axis_fused,
    fused_pass_kernel_arrays,
    fused_pass_meta,
    last_axis_kernel_arrays,
)
from .kernels import correction
from .plan import GridderPlan, make_plan
from .taper_cuda import taper_maps

SPEED_OF_LIGHT = 299792458.0


def stage_arrays(host: dict, device) -> dict:
    """
    Host numpy arrays -> tensors on ``device`` (same keys), one
    pageable copy each (``utils/staging.py``); Python ints stay as they
    are. uint16 arrays are widened to int32 first: torch's
    unsigned 16-bit type supports few operations.
    """
    return device_put_parallel(host, device)


#: Most (pixel, quadrature node) terms the w-taper correction holds at
#: once: it runs over row slabs of the image (one slab at the bench
#: size; at 16384 px the whole image's would take 21.5 GB a temporary).
CORRECTION_TERMS = 1 << 28


def _geometry_maps(plan: GridderPlan, arrays: dict) -> tuple:
    """
    Image-domain maps ``(inv_corr, nm1s)``: the fused uv-taper x
    w-taper x 1/n correction and n(l,m) - 1 - n_mid (the w-screen
    argument), computed on the device of ``arrays``: on a card by
    kernel T1 (``ops/taper_cuda.py``, ``csrc/taper.cu``) in one pass,
    on the CPU by its plain version :func:`_geometry_maps_reference`.
    """
    nodes = arrays["quad_nodes"]
    if nodes.device.type == "cuda":
        return taper_maps(
            nodes, arrays["quad_folded"], npix=plan.num_pixels,
            ngrid=plan.ngrid, support=plan.support,
            pixel_size_lm=plan.pixel_size_lm, wstacking=plan.wstacking,
            dw=plan.dw, n_mid=plan.n_mid,
        )
    return _geometry_maps_reference(plan, arrays)


def _geometry_maps_reference(plan: GridderPlan, arrays: dict) -> tuple:
    """
    T1's plain version, in torch on the device of ``arrays``: the maps
    of :func:`_geometry_maps` through (rows, npix, Q) tensors of the
    correction's angles, in row slabs of :data:`CORRECTION_TERMS`.
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
        k = plan.dw * (nm1 - plan.n_mid)
        rows = max(1, CORRECTION_TERMS // (npix * nodes.shape[0]))
        cw = torch.cat([correction(k[r : r + rows], nodes, folded, support)
                        for r in range(0, npix, rows)])
        corr = corr * cw * (nm1 + 1.0)
    return 1.0 / corr, nm1 - plan.n_mid


def _quad_arrays(plan: GridderPlan) -> dict:
    """The quadrature rule `_geometry_maps` reads, as float32."""
    return {
        "quad_nodes": plan.quad_nodes.astype(np.float32),
        "quad_folded": plan.quad_folded.astype(np.float32),
    }


def _kept(plan: GridderPlan, name: str, build):
    """``build()``, computed once per plan and kept in its ``__dict__``
    under ``name`` (a plan's arrays do not change after planning)."""
    kept = plan.__dict__
    if name not in kept:
        kept[name] = build()
    return kept[name]


def _fused_fft_meta(plan: GridderPlan):
    """Geometry of the fused invert FFT passes (image crop), kept on the
    plan."""
    crop = ((plan.ngrid - plan.num_pixels) // 2, plan.num_pixels)
    return _kept(plan, "_fused_fft_meta", lambda: fused_pass_meta(
        make_fft_plan(plan.ngrid, shifted=True), crop))


def _fused_fft_meta_ic(plan: GridderPlan):
    """Geometry of the fused predict FFT passes (in-cropped image), kept
    on the plan."""
    crop = ((plan.ngrid - plan.num_pixels) // 2, plan.num_pixels)
    return _kept(plan, "_fused_fft_meta_ic", lambda: fused_pass_meta(
        make_fft_plan(plan.ngrid, shifted=True), None, in_crop=crop))


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


def useful_slot_visits(plan: GridderPlan, arrays: dict) -> int:
    """
    B1's slot visits that add to a plane: over the plan's real slots
    (padding slots, ``order == num_vis_data``, add nothing), the number
    of plane groups that the slot's w-kernel touches. A slot in data bin
    q = floor((|w| - w_bin0) / dw), w_bin0 = w0 + (W/2 - 1) dw, touches
    the W planes [q, q + W) (``ops/plan.py``). Against B1's visits
    (active blocks x ``plan.block``, summed over groups) it gives the
    share of slot visits that do work. Read from the staged slot arrays
    (``packed``'s |w| row and ``order``, :func:`slot_plan_host_arrays`)
    on their device, with one host read of the (nplanes,) bin counts,
    and kept on the plan: a pass over the slots on the host took 1.9 s
    at 116 M visibilities on the H100's host.
    """
    return _kept(plan, "_useful_slot_visits",
                 lambda: _useful_slot_visits(plan, arrays))


def _useful_slot_visits(plan: GridderPlan, arrays: dict) -> int:
    W, G, P = plan.support, plan.plane_group, plan.nplanes
    order = arrays["order"]
    if plan.wstacking:
        origin = plan.w0 + (W / 2.0 - 1.0) * plan.dw
        ws = arrays["packed"][2]
        bins = torch.zeros(P + 1, dtype=torch.int64, device=ws.device)
        chunk = 1 << 24
        for a in range(0, plan.num_vis, chunk):
            q = torch.floor((ws[a : a + chunk].double() - origin)
                            / plan.dw).clamp_(0, P - 1).to(torch.int64)
            q.masked_fill_(order[a : a + chunk] >= plan.num_vis_data, P)
            bins += torch.bincount(q, minlength=P + 1)
        bins = bins[:P].cpu().numpy()
    else:
        bins = np.array([int((order < plan.num_vis_data).sum())])
    q = np.arange(len(bins))
    groups = np.minimum(q + W - 1, P - 1) // G - q // G + 1
    return int((bins * groups).sum())


#: Blocks per chunk, the knob of both work lists: B3 cuts a tile run
#: into chunks of at most this many blocks (:func:`tile_chunks`), and B1
#: cuts a destination rectangle into one column piece per this many
#: blocks its sources hold (:func:`grid_chunks`), so that the uv
#: centre's tile (83 blocks in the bench plan's largest group) does not
#: hold one SM. Picked on the card: ``chip_smoke.py`` times the bench
#: group's B1 and B3 at R = 2 to 32 (``chunk_sweep_ms``).
CHUNK_BLOCKS = 8

#: Fields of a B1 chunk row before its sources: the destination
#: rectangle (row0, nrows, col0, ncols) on the periodic grid.
GRID_CHUNK_HEAD = 4
#: Narrowest column piece a heavy B1 destination is cut into.
MIN_PIECE_COLS = 8
#: Widest B1 chunk that no source reaches (its cells are zero-filled).
ZERO_CHUNK_COLS = 2048


def tile_chunks(plan: GridderPlan, ids,
                chunk_blocks: int = CHUNK_BLOCKS) -> np.ndarray:
    """
    The B3 work list of one plane group: (n, 2) int32 rows (first,
    count) over ``ids``, the group's sorted active block ids. A run is
    a stretch of consecutive ``ids`` with one patch origin
    (``block_ox``, ``block_oy``): the planner sorts slots tile-major, so
    a run holds all of a tile's active blocks. Each run is cut into
    chunks of at most ``chunk_blocks`` blocks. Chunks come heaviest
    first (by slots), so the longest start first on the card.
    """
    if chunk_blocks < 1:
        raise ValueError(f"chunk_blocks must be >= 1, got {chunk_blocks}")
    ids = np.asarray(ids, np.int64)
    if ids.size == 0:
        return np.zeros((0, 2), np.int32)
    ox = plan.block_ox[ids].astype(np.int64)
    oy = plan.block_oy[ids].astype(np.int64)
    key = ox * plan.nalloc_y + oy
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    ends = np.r_[starts[1:], ids.size]
    per_run = -(-(ends - starts) // chunk_blocks)
    run = np.repeat(np.arange(starts.size), per_run)
    rank = np.arange(run.size) - np.repeat(np.cumsum(per_run) - per_run,
                                           per_run)
    first = starts[run] + chunk_blocks * rank
    count = np.minimum(chunk_blocks, ends[run] - first)
    slots = np.r_[0, np.cumsum(plan.block_len[ids].astype(np.int64))]
    order = np.argsort(-(slots[first + count] - slots[first]), kind="stable")
    return np.stack([first, count], axis=1)[order].astype(np.int32)


def _band_edges(ngrid: int, step: int, support: int,
                widest: int) -> np.ndarray:
    """Edges of the periodic bands B1's destinations are cut from: 0, N
    and every i * step - W inside, so that a tile's home rows (or its
    window's columns), shifted by the fold's -W, make one band; a band
    wider than ``widest`` is cut into equal parts."""
    inner = np.arange(1, ngrid // step + 2) * step - support
    edges = np.unique(np.r_[0, ngrid, inner[(inner > 0) & (inner < ngrid)]])
    size = np.diff(edges)
    parts = -(-size // widest)
    band = np.repeat(np.arange(parts.size), parts)
    rank = np.arange(band.size) - np.repeat(np.cumsum(parts) - parts, parts)
    return np.r_[edges[band] + size[band] * rank // parts[band], ngrid]


def _interval_bands(start, length: int, edges: np.ndarray,
                    ngrid: int) -> tuple:
    """(item, band, overlap) for the periodic intervals [start, start +
    length) mod N of every item against the bands [edges[j],
    edges[j + 1]): each band an interval meets, with the cells they
    share."""
    start = np.asarray(start, np.int64) % ngrid
    length = min(int(length), ngrid)
    nbands = len(edges) - 1
    parts = []
    for lo, hi in ((start, np.minimum(start + length, ngrid)),
                   (np.zeros_like(start),
                    np.maximum(start + length - ngrid, 0))):
        item = np.flatnonzero(hi > lo)
        lo, hi = lo[item], hi[item]
        b0 = np.searchsorted(edges, lo, "right") - 1
        count = np.searchsorted(edges, hi - 1, "right") - b0
        rank = np.arange(count.sum()) - np.repeat(np.cumsum(count) - count,
                                                  count)
        band = np.repeat(b0, count) + rank
        overlap = (np.minimum(np.repeat(hi, count), edges[band + 1])
                   - np.maximum(np.repeat(lo, count), edges[band]))
        parts.append((np.repeat(item, count), band, overlap))
    item, band, overlap = (np.concatenate(x) for x in zip(*parts))
    # An interval of almost N cells can meet one band in both parts.
    key, inverse = np.unique(item * nbands + band, return_inverse=True)
    return key // nbands, key % nbands, np.bincount(inverse, overlap)


def grid_chunks(plan: GridderPlan, ids,
                chunk_blocks: int = CHUNK_BLOCKS) -> np.ndarray:
    """
    The B1 work list of one plane group, over ``ids``, the group's
    sorted active block ids: (n, 4 + 2S) int32 rows (row0, nrows, col0,
    ncols, first_1, count_1, ..., first_S, count_S). Each row is a
    destination rectangle of the periodic N x N grid and the tile runs
    (``first``, ``count`` over ``ids``; ``count`` 0 past the last) whose
    patches reach it after the fold, in run order. The rectangles
    partition the grid: every cell is written by exactly one chunk, so
    the kernel needs no atomics and no zeroed output, and a cell's sum
    runs over its sources, blocks and slots in this order, whatever
    order the chunks run in.

    The rectangles are cut from bands of at most ``tile_x`` rows and
    ``patch_y`` columns whose edges sit at the tiles' home rows and
    windows shifted by -W (:func:`_band_edges`): an interior tile feeds
    its own band and, with its last ``patch_x - tile_x`` rows, the next.
    A band pair that some run reaches is one destination, cut into
    column pieces of at least :data:`MIN_PIECE_COLS` and at most
    :func:`grid_piece_cols` columns (the kernel's shared planes), one
    per ``chunk_blocks`` blocks its sources hold (each counted by the
    share of its patch inside the rectangle); pieces come heaviest
    first. The rest of the grid follows as source-free rectangles of at
    most :data:`ZERO_CHUNK_COLS` columns, which the kernel fills with
    zeros.

    No rectangle spans more than N - W + 1 rows or columns (on grids
    that small, bands and pieces are cut narrower), so no footprint
    meets one on both sides: the kernel keeps a footprint's start
    rectangle-local, in (-W, nrows) x (-W, ncols), which is exact then
    and fits its 16-bit fields at any N.
    """
    if chunk_blocks < 1:
        raise ValueError(f"chunk_blocks must be >= 1, got {chunk_blocks}")
    N, W = plan.ngrid, plan.support
    if N < W:
        raise ValueError(f"a grid of {N} cells is narrower than the "
                         f"support {W}")
    span = N - W + 1  # widest rectangle no footprint meets on both sides
    redges = _band_edges(N, plan.tile_x, W, min(plan.tile_x, span))
    cedges = _band_edges(N, plan.patch_y, W, N)  # cut into pieces below
    nrb, ncb = len(redges) - 1, len(cedges) - 1
    ids = np.asarray(ids, np.int64)
    # Tile runs: consecutive ids with one patch origin.
    ox = plan.block_ox[ids].astype(np.int64)
    oy = plan.block_oy[ids].astype(np.int64)
    key = ox * plan.nalloc_y + oy
    starts = (np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
              if ids.size else np.zeros(0, np.int64))
    counts = np.diff(np.r_[starts, ids.size])
    r_run, r_band, r_cells = _interval_bands(ox[starts] - W, plan.patch_x,
                                             redges, N)
    c_run, c_band, c_cells = _interval_bands(oy[starts] - W, plan.patch_y,
                                             cedges, N)
    # Every (run, row band, column band) a run's patch reaches.
    per_run = np.bincount(c_run, minlength=starts.size)
    c_first = np.cumsum(per_run) - per_run
    rep = per_run[r_run]
    t_run = np.repeat(r_run, rep)
    pick = c_first[t_run] + np.arange(rep.sum()) - np.repeat(
        np.cumsum(rep) - rep, rep)
    t_dest = np.repeat(r_band, rep) * ncb + c_band[pick]
    t_work = (counts[t_run] * np.repeat(r_cells, rep) * c_cells[pick]
              / (plan.patch_x * plan.patch_y))
    order = np.lexsort((t_run, t_dest))
    t_run, t_dest, t_work = t_run[order], t_dest[order], t_work[order]
    dests, d_first, d_nsrc = np.unique(t_dest, return_index=True,
                                       return_counts=True)
    S = max(int(d_nsrc.max(initial=0)), 1)
    sources = np.zeros((dests.size, S, 2), np.int64)
    slot = np.arange(t_run.size) - np.repeat(d_first, d_nsrc)
    dest_of = np.repeat(np.arange(dests.size), d_nsrc)
    sources[dest_of, slot, 0] = starts[t_run]
    sources[dest_of, slot, 1] = counts[t_run]
    work = np.bincount(dest_of, t_work, minlength=dests.size)
    rb, cb = dests // ncb, dests % ncb
    col0, ncols = cedges[cb], cedges[cb + 1] - cedges[cb]
    widest = min(grid_piece_cols(plan), span)
    pieces = np.clip(np.ceil(work / chunk_blocks).astype(np.int64),
                     -(-ncols // widest),
                     np.maximum(ncols // MIN_PIECE_COLS, -(-ncols // widest)))
    d = np.repeat(np.arange(dests.size), pieces)
    i = np.arange(d.size) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    lo = col0[d] + ncols[d] * i // pieces[d]
    hi = col0[d] + ncols[d] * (i + 1) // pieces[d]
    busy = np.concatenate([
        np.stack([redges[rb[d]], redges[rb[d] + 1] - redges[rb[d]], lo,
                  hi - lo], axis=1),
        sources[d].reshape(d.size, 2 * S)], axis=1)
    busy = busy[np.argsort(-(work[d] / pieces[d]), kind="stable")]
    # Source-free rectangles: stretches of unreached column bands.
    free = np.ones((nrb, ncb + 2), bool)
    free[:, [0, -1]] = False
    free[rb, cb + 1] = False
    edge = np.diff(free.astype(np.int8), axis=1)
    z_rb, z_lo = np.nonzero(edge == 1)
    z_hi = np.nonzero(edge == -1)[1]
    z_col0, z_end = cedges[z_lo], cedges[z_hi]
    z_pieces = -(-(z_end - z_col0) // ZERO_CHUNK_COLS)
    z = np.repeat(np.arange(z_rb.size), z_pieces)
    zi = np.arange(z.size) - np.repeat(np.cumsum(z_pieces) - z_pieces,
                                       z_pieces)
    z_lo = z_col0[z] + zi * ZERO_CHUNK_COLS
    z_hi = np.minimum(z_lo + ZERO_CHUNK_COLS, z_end[z])
    zero = np.zeros((z.size, GRID_CHUNK_HEAD + 2 * S), np.int64)
    zero[:, 0] = redges[z_rb[z]]
    zero[:, 1] = redges[z_rb[z] + 1] - redges[z_rb[z]]
    zero[:, 2] = z_lo
    zero[:, 3] = z_hi - z_lo
    if (busy[:, 1] > min(plan.tile_x, span)).any() or (
            busy[:, 3] > widest).any():
        raise RuntimeError("grid_chunks: a rectangle that runs reach is "
                           "wider than the kernel's shared planes")
    return np.concatenate([busy, zero]).astype(np.int32)


def work_lists(plan: GridderPlan, *, invert: bool = False,
               predict: bool = False) -> dict:
    """
    The plan's per-group work lists, each built at most once per plan
    and kept on it: ``"blocks"``, every plane group's sorted active
    block ids (:func:`group_active_blocks`); with ``invert`` also
    ``"grid"``, B1's :func:`grid_chunks` of each group; with ``predict``
    ``"tile"``, B3's :func:`tile_chunks` of each group. What a call
    builds is timed by the span ``invert.work_lists``.
    """
    lists = _kept(plan, "_work_lists", dict)
    wanted = {"blocks": True, "grid": invert, "tile": predict}
    if all(key in lists for key, want in wanted.items() if want):
        return lists
    with span("invert.work_lists"):
        if "blocks" not in lists:
            lists["blocks"] = group_active_blocks(plan)
        if invert and "grid" not in lists:
            lists["grid"] = [grid_chunks(plan, ids)
                             for ids in lists["blocks"]]
        if predict and "tile" not in lists:
            lists["tile"] = [tile_chunks(plan, ids)
                             for ids in lists["blocks"]]
    return lists


def _stack_tables(tables: list) -> np.ndarray:
    """Per-group int32 tables in one (groups, rows, width) array, padded
    with zero rows (and zero columns) to the largest."""
    rows = max(max((len(t) for t in tables), default=0), 1)
    width = max(t.shape[1] for t in tables)
    out = np.zeros((len(tables), rows, width), np.int32)
    for k, table in enumerate(tables):
        out[k, : len(table), : table.shape[1]] = table
    return out


def plan_host_arrays(plan: GridderPlan, device, *, invert: bool = True,
                     predict: bool = False) -> dict:
    """
    Host (numpy) arrays of a plan that the port's invert and predict
    read on ``device``: the per-block tables, the (num_groups, G) plane
    w's, the per-group active block lists (``group_blocks``, padded with
    -1), the work lists of :func:`work_lists` each padded with zero rows
    (for the ``invert`` B1's, ``group_grid_chunks``; for the ``predict``
    B3's, ``group_chunks``), the quadrature rule, and the first-axis DFT
    factors of the passes that run there — on a CUDA device the fused
    kernels' (B2's and B2L's), ``fftp_*`` for the ``invert`` and
    ``fftq_*`` for the ``predict``; on the CPU the plain version's
    (``fft_*``), which serve both.
    """
    G = plan.plane_group
    wg = plan.w0 + plan.dw * np.arange(G * plan.num_groups, dtype=np.float64)
    lists = work_lists(plan, invert=invert, predict=predict)
    blocks = lists["blocks"]
    width = max(max((len(x) for x in blocks), default=0), 1)
    group_blocks = np.full((len(blocks), width), -1, np.int32)
    for k, ids in enumerate(blocks):
        group_blocks[k, : len(ids)] = ids
    arrays = {
        "block_len": plan.block_len.astype(np.int32),
        "cblock_ox": plan.block_ox.astype(np.int32),
        "block_oy": plan.block_oy.astype(np.int32),
        # Ragged final groups are padded with would-be planes >= nplanes,
        # outside every block's ES window (zero contributions).
        "plane_wg": wg.astype(np.float32).reshape(-1, G),
        "group_blocks": group_blocks,
    }
    if invert:
        arrays["group_grid_chunks"] = _stack_tables(lists["grid"])
    if predict:
        arrays["group_chunks"] = _stack_tables(lists["tile"])
    arrays.update(_quad_arrays(plan))
    fft_plan = make_fft_plan(plan.ngrid, shifted=True)
    if resolve_device(device).type == "cuda":
        # B2's and B2L's tables (the sub-FFT ones are shared).
        passes = []
        if invert:
            passes.append((_fused_fft_meta(plan), +1, "fftp"))
        if predict:
            passes.append((_fused_fft_meta_ic(plan), -1, "fftq"))
        for meta, sign, prefix in passes:
            arrays.update(fused_pass_kernel_arrays(fft_plan, meta,
                                                   sign=sign, prefix=prefix))
            arrays.update(last_axis_kernel_arrays(fft_plan, meta, sign=sign,
                                                  prefix=prefix))
    else:
        arrays.update(fft_plan_arrays(fft_plan, prefix="fft"))
    return arrays


def plan_order_host(plan: GridderPlan) -> dict:
    """
    Numpy (order, flip_sign, phase_cos, phase_sin) of a plan: the static
    data-order -> slot-order transform (gather, conjugate flip, w-shift
    pre-phase), shared by device staging and :func:`stage_slot_vis`
    (counterpart copy). The phase factors come from the plan when its
    engine exported them, else from the native engine's multithreaded
    pass, else from numpy.
    """
    if plan.phase_cos is not None:
        phase_cos, phase_sin = plan.phase_cos, plan.phase_sin
    elif not plan.wstacking:
        # No w-stacking -> no w-shift pre-phase: identity factors, so
        # psf()/slot-space consumers that read them unconditionally
        # stay correct (staging skips the rotation in this mode).
        phase_cos = np.ones(plan.num_vis, np.float32)
        phase_sin = np.zeros(plan.num_vis, np.float32)
    else:
        factor = -2.0 * np.pi * plan.n_mid
        if plan.num_vis and _native.available():
            phase_cos, phase_sin = _native.phase_cossin(plan.ws, factor)
        else:
            phase = factor * plan.ws.astype(np.float64)
            phase_cos = np.cos(phase).astype(np.float32)
            phase_sin = np.sin(phase).astype(np.float32)
    flip_sign = (
        plan.flip_sign
        if plan.flip_sign is not None
        else np.where(plan.flip, -1.0, 1.0).astype(np.float32)
    )
    return {
        "order": plan.order,
        "flip_sign": flip_sign,
        "phase_cos": phase_cos,
        "phase_sin": phase_sin,
    }


def stage_slot_vis(plan: GridderPlan, vis_re, vis_im) -> tuple:
    """
    Host-side staging of flattened data-order visibilities into SLOT
    order: gather by the plan's block-slot permutation (duplicating
    lane straddlers), conjugate w-flipped samples, and apply the static
    w-shift pre-phase. Returns float32 numpy ``(re, im)`` of length
    ``plan.num_vis`` (counterpart copy): the input convention of
    :func:`build_invert`. The native engine does it in one fused
    multithreaded pass where it is available.
    """
    host = plan_order_host(plan)
    if plan.num_vis and _native.available():
        # Padding slots (order >= num_vis_data) stage as zero there.
        return _native.stage_slot_vis(
            np.asarray(vis_re, np.float32).ravel(),
            np.asarray(vis_im, np.float32).ravel(),
            host["order"],
            host["flip_sign"],
            host["phase_cos"],
            host["phase_sin"],
            wstacking=plan.wstacking,
        )
    re = np.append(
        np.asarray(vis_re, np.float32).ravel(), np.float32(0.0)
    )
    im = np.append(
        np.asarray(vis_im, np.float32).ravel(), np.float32(0.0)
    )
    order = np.minimum(host["order"], len(re) - 1)
    re_s = re[order]
    im_s = im[order] * host["flip_sign"]
    if plan.wstacking:
        cos, sin = host["phase_cos"], host["phase_sin"]
        re_s, im_s = re_s * cos - im_s * sin, re_s * sin + im_s * cos
    return re_s, im_s


def stage_slot_weights(plan: GridderPlan, weights) -> np.ndarray:
    """
    Host-side gather of per-sample (data-order) real weights into slot
    order (no flip/phase — weights are real and positive). Padding
    slots get weight 0 (counterpart copy).
    """
    w = np.append(
        np.asarray(weights, np.float32).ravel(), np.float32(0.0)
    )
    order = plan.order
    out = w[np.minimum(order, len(w) - 1)]
    out[order >= len(w) - 1] = 0.0
    return out


def slot_duplicate_pairs(plan: GridderPlan) -> tuple:
    """
    The static (dup_a, dup_b) slot-index pairs sharing one source
    sample (lane-straddler duplication, ops/plan.py). A model
    visibility's full value is the sum over its slots — each slot's
    kernel covers only its own 128-lane window — so slot-space
    residuals need ``acc[dup_a] += acc_old[dup_b]`` and vice versa
    (see :func:`slot_group_sum`). Pairs are returned as int32 arrays;
    samples with a single slot don't appear (counterpart copy).
    """
    order = plan.order
    perm = np.argsort(order, kind="stable")
    sorted_order = order[perm]
    eq = (sorted_order[1:] == sorted_order[:-1]) & (
        sorted_order[1:] < plan.num_vis_data
    )
    # slot_group_sum assumes each source sample occupies at most TWO
    # slots (single lane-straddle duplication today). A future plan
    # change duplicating into 3+ slots would silently produce wrong
    # pairwise group sums — fail loudly instead.
    if eq.size and np.any(eq[1:] & eq[:-1]):
        raise ValueError(
            "slot plan duplicates a source sample into >2 slots; "
            "slot_group_sum's pairwise model no longer applies"
        )
    dup_a = perm[:-1][eq].astype(np.int32)
    dup_b = perm[1:][eq].astype(np.int32)
    return dup_a, dup_b


def slot_group_sum(acc_re, acc_im, dup_a, dup_b) -> tuple:
    """
    Sum duplicated-slot contributions so every slot carries its source
    sample's FULL model value: ``out[i] = acc[i] + acc[partner(i)]``
    for straddler pairs, identity elsewhere. ``dup_a``/``dup_b`` are
    the in-range index tensors of :func:`slot_duplicate_pairs` (the
    counterpart also accepts out-of-range padding; the port never pads
    them).
    """
    if dup_a.shape[0] == 0:
        return acc_re, acc_im
    pair = torch.stack([acc_re, acc_im], dim=1)
    va, vb = pair[dup_a], pair[dup_b]
    out = pair.index_add(0, dup_a, vb).index_add(0, dup_b, va)
    return out[:, 0], out[:, 1]


def packed_rows(plan: GridderPlan) -> np.ndarray:
    """The slot path's (3, num_vis) float32 rows xpos, ypos, |w|: the
    native engine's export, else ``pack_plan_columns``."""
    packed4 = plan.packed if plan.packed is not None else pack_plan_columns(
        plan)
    return np.ascontiguousarray(packed4[:3])


def slot_plan_host_arrays(plan: GridderPlan, device, *, invert: bool = True,
                          predict: bool = True) -> dict:
    """
    Host staging dict of the slot path for ``device``:
    :func:`plan_host_arrays` plus the :func:`packed_rows` and the order
    transform of :func:`plan_order_host`. Feeds :func:`build_invert`
    (slot-order input staged with :func:`stage_slot_vis`) and
    :func:`build_predict`.
    """
    arrays = plan_host_arrays(plan, device, invert=invert, predict=predict)
    arrays["packed"] = packed_rows(plan)
    arrays.update(plan_order_host(plan))
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
    ``oe_exc_val``) and hi/lo float32 splits of the f64 ``uvw`` and
    ``freq / c``. Consumed by :func:`build_assemble`.
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
    im_s)``.

    Unlike the counterpart, the hi and lo parts of the double-float
    positions are gathered as separate slot columns and the block origin
    is subtracted from the hi part first: ``(xh - origin) + xl`` is
    exact up to one rounding at patch scale. The counterpart collapses
    ``xh + xl`` to one float32 at grid scale first, which moves
    positions by up to one float32 ulp of the grid size (2.4e-4 cells
    at ngrid 4096; ROADMAP.md Queue C, C1).
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
        # gather one (N, 7) row table.
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
        table = torch.stack(
            [xh.reshape(-1), xl.reshape(-1), yh.reshape(-1),
             yl.reshape(-1), ws_d, re_d, im_d],
            dim=1,
        )
        g = table[idx.clamp(0, table.shape[0] - 1)]
        pad_pos = torch.tensor(
            support + 0.5, dtype=torch.float32, device=device
        )
        zero_s = torch.zeros((), dtype=torch.float32, device=device)

        def col(value, fill):
            return torch.where(mask, value, fill)

        out = dict(arrays)
        out["packed"] = torch.stack(
            [
                col((g[:, 0] - box) + g[:, 1], pad_pos),
                col((g[:, 2] - boy) + g[:, 3], pad_pos),
                col(g[:, 4], zero_s),
            ]
        )
        return out, col(g[:, 5], zero_s), col(g[:, 6], zero_s)

    return assemble


def stage_compact(plan: GridderPlan, uvw, channel_frequencies, weighted,
                  device) -> tuple:
    """
    Compact staging of weighted (nrow, nchan) visibilities onto
    ``device`` and the :func:`build_assemble` prologue: returns
    ``(arrays, re_s, im_s)`` ready for :func:`build_invert`.
    """
    with span("stage"):
        weighted = np.asarray(weighted, np.complex64).ravel()
        with span("stage.host_arrays"):
            host = compact_plan_host_arrays(plan, uvw, channel_frequencies,
                                            device)
        host["re"], host["im"] = weighted.real, weighted.imag
        with span("stage.upload"):
            arrays = stage_arrays(host, device)
        re, im = arrays.pop("re"), arrays.pop("im")
        with span("stage.assemble", device=True):
            return build_assemble(plan)(arrays, re, im)


def _prepare_sorted_vis(plan: GridderPlan, arrays: dict, vis_re, vis_im):
    """
    Data-order visibilities -> slot order on the device: gather by the
    plan's ``order`` (padding slots read zero), conjugate flipped
    samples, apply the w-shift pre-phase (counterpart
    ``_prepare_sorted_vis``).
    """
    pair = torch.zeros((plan.num_vis_data + 1, 2), dtype=torch.float32,
                       device=vis_re.device)
    n = min(vis_re.shape[0], plan.num_vis_data)
    pair[:n, 0] = vis_re[:n]
    pair[:n, 1] = vis_im[:n]
    taken = pair[arrays["order"].to(torch.int64)]
    re = taken[:, 0]
    im = taken[:, 1] * arrays["flip_sign"]
    if plan.wstacking:
        cos, sin = arrays["phase_cos"], arrays["phase_sin"]
        re, im = re * cos - im * sin, re * sin + im * cos
    return re, im


def build_invert(plan, *, mesh=None):
    """
    Returns ``invert(arrays, re_s, im_s) -> image``: the unnormalized
    (npix, npix) float32 dirty image from slot-order visibilities, on
    the device of the tensors. Two stagings feed it: the compact one
    (:func:`compact_plan_host_arrays` + :func:`build_assemble`, which
    rebuilds ``packed`` and the slot visibilities on the device), and
    the slot one (:func:`slot_plan_host_arrays`, host-built ``packed``
    rows, with visibilities from :func:`stage_slot_vis`), which the
    measurement operator uses.

    With a ``mesh`` (``parallel/mesh.py``) of S > 1 shards this is the
    distributed mode (:func:`_build_invert_distributed`): ``plan`` is
    the list of this rank's shard plans, and ``invert`` takes lists of
    their ``arrays``, ``re_s`` and ``im_s`` and returns the image of
    every shard's visibilities, the same on every rank. Without one, or
    with S = 1, ``plan`` is one plan and nothing changes.
    """
    if mesh is not None and mesh.num_shards > 1:
        return _build_invert_distributed(list(plan), mesh)
    G = plan.plane_group
    npix = plan.num_pixels
    fmeta = _fused_fft_meta(plan)
    lists = work_lists(plan, invert=True)
    counts = [len(ids) for ids in lists["blocks"]]
    nchunks = [len(c) for c in lists["grid"]]
    visits = [c * plan.block for c in counts]

    def invert(arrays, re_s, im_s):
        with span("invert.taper", device=True):
            inv_corr, nm1s = _geometry_maps(plan, arrays)
        image = torch.zeros(
            (npix, npix), dtype=torch.float32, device=re_s.device
        )
        for k in range(plan.num_groups):
            with span("invert.group", device=True):
                count("active_blocks", counts[k])
                count("b1_chunks", nchunks[k])
                count("slot_visits", visits[k])
                w_g = arrays["plane_wg"][k]
                # The screen's -2 pi w, rounded to float32 on the device
                # (one op a group; B2L reads it there).
                coef = (-2.0 * math.pi) * w_g
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
                    chunks=arrays["group_grid_chunks"][k, : nchunks[k]],
                )
                # Per plane (those of a ragged final group beyond nplanes
                # are empty): B2 along axis 0, then B2L along the last
                # axis, which screens the plane and adds it into the
                # image.
                for i in range(min(G, plan.nplanes - k * G)):
                    a_re, a_im = fft_first_axis_fused(
                        planes[2 * i], planes[2 * i + 1], arrays,
                        meta=fmeta, sign=+1,
                    )
                    screen = ((nm1s, coef[i : i + 1]) if plan.wstacking
                              else None)
                    fft_last_axis_fused(a_re, a_im, arrays, meta=fmeta,
                                        sign=+1, screen=screen, acc=image)
                    del a_re, a_im
                del planes  # free before the next group's B1 writes its own
        return image * inv_corr

    return invert


def _screened_grid(plan, arrays, img0, coef, nm1s, fmeta, out_re, out_im):
    """
    Predict's plane step: screen the image ``img0`` (npix, npix) with
    e^(i coef nm1s) and transform it onto its periodic grid in ``out_*``
    (views of the group's stack): B2L along the image's rows, screening
    in its load, then B2 along axis 0, which writes the grid row-major.
    """
    if plan.wstacking:
        b_re, b_im = fft_last_axis_fused(img0, None, arrays, meta=fmeta,
                                         sign=-1, prefix="fftq",
                                         screen=(nm1s, coef))
    else:
        b_re, b_im = fft_last_axis_fused(img0, torch.zeros_like(img0),
                                         arrays, meta=fmeta, sign=-1,
                                         prefix="fftq")
    fft_first_axis_fused(b_re, b_im, arrays, meta=fmeta, sign=-1,
                         prefix="fftq", out=(out_re, out_im))


def build_predict(plan, *, slot_output: bool = False, mesh=None):
    """
    Returns ``predict(arrays, image) -> (vis_re, vis_im)``: the exact
    adjoint of :func:`build_invert`'s operator (degridding, the
    ``dirty2ms`` analog), producing data-order split visibilities
    (``plan.num_vis_data`` each) from a real (npix, npix) image, on the
    device of the staged tensors. ``arrays`` is a staged
    :func:`slot_plan_host_arrays` dict.

    With ``slot_output=True`` the per-slot contributions are returned
    in the slot-input convention (pre-phase applied, flip not undone,
    ``plan.num_vis`` each): the adjoint of :func:`build_invert` on
    slot-order input. A slot's value covers only its own 128-lane
    kernel window; sum straddler pairs with :func:`slot_group_sum`
    before comparing against staged data.

    With a ``mesh`` of S > 1 shards this is the distributed mode
    (:func:`_build_predict_distributed`): ``plan`` is the list of this
    rank's shard plans, and ``predict(arrays_list, image)`` returns one
    ``(vis_re, vis_im)`` pair per local shard.
    """
    if mesh is not None and mesh.num_shards > 1:
        return _build_predict_distributed(list(plan), mesh,
                                          slot_output=slot_output)
    G = plan.plane_group
    N = plan.ngrid
    fmeta = _fused_fft_meta_ic(plan)
    lists = work_lists(plan, predict=True)
    counts = [len(ids) for ids in lists["blocks"]]
    nchunks = [len(c) for c in lists["tile"]]

    def predict(arrays, image):
        with span("predict.taper", device=True):
            inv_corr, nm1s = _geometry_maps(plan, arrays)
        device = inv_corr.device
        img0 = torch.as_tensor(image, dtype=torch.float32,
                               device=device) * inv_corr
        # One (2G, N, N) stack of periodic planes for every group; each
        # group's passes overwrite its planes whole.
        grids = torch.empty((2 * G, N, N), dtype=torch.float32,
                            device=device)
        acc = torch.zeros((2, plan.num_vis), dtype=torch.float32,
                          device=device)
        for k in range(plan.num_groups):
            w_g = arrays["plane_wg"][k]
            coef = (2.0 * math.pi) * w_g  # the screen's 2 pi w (float32)
            num_real = min(G, plan.nplanes - k * G)
            for i in range(num_real):
                _screened_grid(plan, arrays, img0, coef[i : i + 1], nm1s,
                               fmeta, grids[2 * i], grids[2 * i + 1])
            # Pad planes of a ragged final group: their ES w-factor is
            # zero for every block, so any finite grid works — reuse the
            # last real plane's, as the counterpart does.
            last = grids[2 * (num_real - 1) : 2 * num_real]
            for i in range(num_real, G):
                grids[2 * i : 2 * i + 2].copy_(last)
            degrid_planes(
                arrays["packed"],
                arrays["block_len"],
                arrays["cblock_ox"],
                arrays["block_oy"],
                grids,
                w_g,
                arrays["group_blocks"][k, : counts[k]],
                acc,
                plan=plan,
                chunks=arrays["group_chunks"][k, : nchunks[k]],
            )
        if slot_output:
            return acc[0], acc[1]
        return _finalize(plan, arrays, acc[0], acc[1])

    return predict


def _finalize(plan: GridderPlan, arrays: dict, acc_re, acc_im) -> tuple:
    """Post-phase, conjugate flips, scatter-add back to data order."""
    if plan.wstacking:
        # Adjoint post-phase: conjugate of the staged pre-phase.
        cos = arrays["phase_cos"]
        sin = -arrays["phase_sin"]
        acc_re, acc_im = (
            acc_re * cos - acc_im * sin,
            acc_re * sin + acc_im * cos,
        )
    acc_im = acc_im * arrays["flip_sign"]
    # Scatter-ADD: duplicated lane straddlers carry two partial
    # contributions per source sample; padding slots index num_vis_data,
    # one past the end, and are dropped.
    out = torch.zeros((2, plan.num_vis_data + 1), dtype=torch.float32,
                      device=acc_re.device)
    out.index_add_(1, arrays["order"].to(torch.int64),
                   torch.stack([acc_re, acc_im]))
    return out[0, : plan.num_vis_data], out[1, : plan.num_vis_data]


def _distributed_geometry(plans: list, mesh) -> GridderPlan:
    """
    The plan geometry the local shard plans share, or raise: one plan
    per local shard, one grid and one w-plane set (``nplanes``, ``w0``,
    ``dw``: plane p must mean the same w on every shard, since the
    distributed mode sums plane grids across shards), and ``ngrid`` and
    ``npix`` divisible by the shard count.
    """
    if len(plans) != mesh.local_shards:
        raise ValueError(f"{len(plans)} plans for {mesh.local_shards} "
                         "local shards")
    shared = {
        (p.ngrid, p.num_pixels, p.pixel_size_lm, p.support, p.sigma,
         p.wstacking, p.nplanes, p.plane_group, p.w0, p.dw, p.n_mid)
        for p in plans
    }
    if len(shared) != 1:
        raise ValueError(
            "shard plans disagree on the grid or the w-plane set: plan "
            "them on the global w range and pad them (pad_plans_uniform)"
        )
    plan = plans[0]
    S = mesh.num_shards
    if plan.ngrid % S or plan.num_pixels % S:
        raise ValueError(
            f"distributed FFT needs ngrid={plan.ngrid} and "
            f"npix={plan.num_pixels} divisible by num_shards={S}"
        )
    return plan


def _source_major(received: torch.Tensor) -> torch.Tensor:
    """
    An all-to-all's (S, c, w) chunks, source shard s holding columns
    [s w, (s + 1) w) of the next pass's input rows, as that input:
    (S w, c) row-major.
    """
    S, c, w = received.shape
    return received.permute(0, 2, 1).reshape(S * w, c)


def _column_blocks(plane: torch.Tensor, S: int) -> torch.Tensor:
    """An (N, N) plane's S column slabs as one contiguous (S, N, N/S)
    tensor, slab s at [s]: the collectives split dimension 0."""
    N = plane.shape[0]
    return plane.view(N, S, N // S).permute(1, 0, 2).contiguous()


def _build_invert_distributed(plans: list, mesh):
    """
    The distributed mode of :func:`build_invert` (counterpart: its
    ``mesh_axis`` branch), on this rank's shard ``plans``. Per plane
    group, each local shard grids its planes (B1) and the rank sums
    them as they are made; then per plane:

    * ``psum_scatter`` of the grid into column slabs of N/S, shard s
      receiving the reduced columns Y_s as an (N, N/S) tensor (the
      collectives split dimension 0, so the plane is laid out as its S
      column slabs first, :func:`_column_blocks`);
    * the first B2 pass (x -> a), (N, N/S) -> (npix, N/S);
    * ``all_to_all`` of its npix/S-row chunks: shard j receives rows
      A_j of every shard's columns, laid out (N, npix/S);
    * the second B2 pass (y -> b), (N, npix/S) -> (npix, npix/S): the
      column slab A_j of the replicated mode's transposed image;
    * the w-screen of that slab and accumulation.

    Each column of each pass is the replicated mode's, so the modes
    differ only in the order the shards' grids are summed. At the end
    the slabs take the correction and are ``all_gather``-ed into the
    (npix, npix) image.
    """
    plan = _distributed_geometry(plans, mesh)
    G, npix = plan.plane_group, plan.num_pixels
    S = mesh.num_shards
    cols = npix // S
    fmeta = _fused_fft_meta(plan)
    lists = [work_lists(p, invert=True) for p in plans]
    counts = [[len(ids) for ids in x["blocks"]] for x in lists]
    nchunks = [[len(c) for c in x["grid"]] for x in lists]
    slabs = [slice(g * cols, (g + 1) * cols)
             for g in mesh.addressable_shard_indices]

    def grid_group(arrays_list, re_list, im_list, k):
        """Group k's (2G, N, N) planes summed over the local shards."""
        total = None
        for s, p in enumerate(plans):
            arrays = arrays_list[s]
            planes = grid_planes(
                arrays["packed"], re_list[s], im_list[s],
                arrays["block_len"], arrays["cblock_ox"], arrays["block_oy"],
                arrays["plane_wg"][k],
                arrays["group_blocks"][k, : counts[s][k]], plan=p,
                chunks=arrays["group_grid_chunks"][k, : nchunks[s][k]],
            )
            if total is None:
                total = planes
            else:
                total += planes
        return total

    def column_slabs(plane):
        """This rank's shards' (N, N/S) slabs of the plane summed over
        the mesh."""
        return [slab[0] for slab in
                mesh.psum_scatter([_column_blocks(plane, S)])]

    def invert(arrays_list, re_list, im_list):
        arrays = arrays_list[0]
        with span("invert.taper", device=True):
            inv_corr, nm1s = _geometry_maps(plan, arrays)
        images = [torch.zeros((npix, cols), dtype=torch.float32,
                              device=inv_corr.device) for _ in slabs]
        for k in range(plan.num_groups):
            w_g = arrays["plane_wg"][k]
            planes = grid_group(arrays_list, re_list, im_list, k)
            for i in range(min(G, plan.nplanes - k * G)):
                first = [
                    fft_first_axis_fused(re, im, arrays, meta=fmeta, sign=+1)
                    for re, im in zip(column_slabs(planes[2 * i]),
                                      column_slabs(planes[2 * i + 1]))
                ]
                a_re = mesh.all_to_all([a[0] for a in first])
                a_im = mesh.all_to_all([a[1] for a in first])
                del first
                for j, sl in enumerate(slabs):
                    img_re, img_im = fft_first_axis_fused(
                        _source_major(a_re[j]), _source_major(a_im[j]),
                        arrays, meta=fmeta, sign=+1,
                    )
                    if plan.wstacking:
                        # nm1s is transpose-symmetric (as in build_invert).
                        theta = (-2.0 * math.pi * w_g[i]) * nm1s[:, sl]
                        images[j] = images[j] + (
                            img_re * torch.cos(theta)
                            - img_im * torch.sin(theta)
                        )
                    else:
                        images[j] = images[j] + img_re
            del planes
        parts = [image * inv_corr[:, sl] for image, sl in zip(images, slabs)]
        # (S, npix, npix/S) slabs of the transposed image -> the image.
        return mesh.all_gather(parts).permute(0, 2, 1).reshape(npix, npix)

    return invert


def _build_predict_distributed(plans: list, mesh, *, slot_output: bool):
    """
    The distributed mode of :func:`build_predict`, the mirror of
    :func:`_build_invert_distributed`: per plane, each local shard
    screens its slab of the corrected image (rows A_s, transposed:
    (npix, npix/S)), runs the first in-cropped B2 pass on it (b -> y,
    (N, npix/S)), ``all_to_all`` of its N/S-row chunks gives shard k
    the columns Y_k of every slab, laid out (npix, N/S), the second
    in-cropped pass (a -> x) makes the grid's column slab (N, N/S),
    and ``all_gather`` puts the full periodic plane together on every
    shard; then each local shard degrids the group (B3) as today.
    Returns one ``(vis_re, vis_im)`` pair per local shard.
    """
    plan = _distributed_geometry(plans, mesh)
    G, N, npix = plan.plane_group, plan.ngrid, plan.num_pixels
    S = mesh.num_shards
    cols = npix // S
    fmeta = _fused_fft_meta_ic(plan)
    lists = [work_lists(p, predict=True) for p in plans]
    counts = [[len(ids) for ids in x["blocks"]] for x in lists]
    nchunks = [[len(c) for c in x["tile"]] for x in lists]
    slabs = [slice(g * cols, (g + 1) * cols)
             for g in mesh.addressable_shard_indices]

    def grid_slabs(arrays, img0, nm1s, w_p):
        """One plane's (S, N, N/S) column slabs of the periodic grid
        (re, im), every shard's, from the local image slabs."""
        first_re, first_im = [], []
        for img, sl in zip(img0, slabs):
            if plan.wstacking:
                theta = (2.0 * math.pi * w_p) * nm1s[:, sl]
                img_re, img_im = img * torch.cos(theta), img * torch.sin(theta)
            else:
                img_re, img_im = img, torch.zeros_like(img)
            re, im = fft_first_axis_fused(img_re, img_im, arrays, meta=fmeta,
                                          sign=-1, prefix="fftq")
            first_re.append(re)
            first_im.append(im)
        a_re = mesh.all_to_all(first_re)
        a_im = mesh.all_to_all(first_im)
        del first_re, first_im
        second = [
            fft_first_axis_fused(_source_major(re), _source_major(im),
                                 arrays, meta=fmeta, sign=-1, prefix="fftq")
            for re, im in zip(a_re, a_im)
        ]
        return (mesh.all_gather([b[0] for b in second]),
                mesh.all_gather([b[1] for b in second]))

    def predict(arrays_list, image):
        arrays = arrays_list[0]
        with span("predict.taper", device=True):
            inv_corr, nm1s = _geometry_maps(plan, arrays)
        device = inv_corr.device
        image = torch.as_tensor(image, dtype=torch.float32, device=device)
        # Slab s of (image * inv_corr)^T: image rows A_s, transposed.
        img0 = [(image[sl].t() * inv_corr[:, sl]).contiguous()
                for sl in slabs]
        grids = torch.empty((2 * G, N, N), dtype=torch.float32, device=device)
        accs = [torch.zeros((2, p.num_vis), dtype=torch.float32,
                            device=device) for p in plans]
        for k in range(plan.num_groups):
            w_g = arrays["plane_wg"][k]
            num_real = min(G, plan.nplanes - k * G)
            for i in range(num_real):
                for q, gathered in enumerate(grid_slabs(arrays, img0, nm1s,
                                                        w_g[i])):
                    # (S, N, N/S) slabs -> the (N, N) plane, column-wise.
                    grids[2 * i + q].view(N, S, N // S).copy_(
                        gathered.permute(1, 0, 2))
            last = grids[2 * (num_real - 1) : 2 * num_real]
            for i in range(num_real, G):
                grids[2 * i : 2 * i + 2].copy_(last)
            for s, p in enumerate(plans):
                a = arrays_list[s]
                degrid_planes(
                    a["packed"], a["block_len"], a["cblock_ox"],
                    a["block_oy"], grids, w_g,
                    a["group_blocks"][k, : counts[s][k]], accs[s], plan=p,
                    chunks=a["group_chunks"][k, : nchunks[s][k]],
                )
        if slot_output:
            return [(acc[0], acc[1]) for acc in accs]
        return [_finalize(p, a, acc[0], acc[1])
                for p, a, acc in zip(plans, arrays_list, accs)]

    return predict


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
    From a CUDA device that array is a view of a pinned host buffer
    (:func:`~ska_sdp_cip_tpu_torch.utils.staging.device_get`), which
    stays page-locked while the array lives; ``np.array(image)`` gives
    an owned, pageable copy to keep.
    """
    device = resolve_device(device)
    with span("image"):
        with span("plan"):
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
            count("visibilities", plan.num_vis_data)
            count("slots", plan.num_vis)
            count("planes", plan.nplanes)
            count("groups", plan.num_groups)
        with span("weight"):
            weighted = np.asarray(visibilities, np.complex64) * np.asarray(
                weights, np.float32
            )
        arrays, re_s, im_s = stage_compact(
            plan, uvw, channel_frequencies, weighted, device
        )
        with span("invert"):
            image = build_invert(plan)(arrays, re_s, im_s)
        with span("download"):
            return device_get(image)


def predict_visibilities(
    uvw,
    channel_frequencies,
    image,
    pixel_size_lm: float,
    *,
    epsilon: float = 1e-4,
    do_wstacking: bool = True,
    sigma: float | str = 2.0,
    device,
) -> np.ndarray:
    """
    Model visibilities from an image (``dirty2ms`` analog, the adjoint
    of :func:`dirty_image`; counterpart ``predict_visibilities``). The
    work runs on ``device``; returns complex64 (nrow, nchan) numpy.
    """
    device = resolve_device(device)
    image = np.asarray(image)
    plan = make_plan(
        uvw,
        channel_frequencies,
        image.shape[0],
        pixel_size_lm,
        epsilon=epsilon,
        do_wstacking=do_wstacking,
        sigma=sigma,
    )
    host = slot_plan_host_arrays(plan, device, invert=False)
    host["image"] = np.asarray(image, np.float32)
    arrays = stage_arrays(host, device)
    out_re, out_im = build_predict(plan)(arrays, arrays.pop("image"))
    vis = device_get(out_re) + 1j * device_get(out_im)
    return vis.reshape(len(uvw), len(channel_frequencies)).astype(
        np.complex64
    )
