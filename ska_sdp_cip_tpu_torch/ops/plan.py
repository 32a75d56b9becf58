"""
Gridding plan: host-side geometry and binning for the gridder.

Counterpart: ``ska_sdp_cip_tpu/ops/plan.py`` (``make_plan`` and
everything it calls, ``w_range``, ``prewarm_plan_arenas`` and the
sharded path's ``auto_block_and_group``, ``plan_shape_maxima`` and
``pad_plans_uniform``), with its
two engines: the native C++ engine (``native.py``, built from
``csrc/cip_native.cpp``) whenever a C++ compiler is on ``PATH``, else
the numpy path. The port cannot import the original: importing any
module of the JAX package imports jax, and the machine that carries the
card has none. The tests hold both engines equal to the original's
numpy path field by field.

Differences from the counterpart:

* ``export_coords`` is an explicit argument (default ``False``: the
  port reads the engine's packed columns) instead of being resolved
  from the JAX gridder mode;
* the environment overrides of the counterpart (``CIP_BLOCK``,
  ``CIP_WBIN_GROUP``, ``CIP_PLANE_GROUP``, ``CIP_PATCH_X``) are not
  read: the port always plans with the defaults;
* the TPU strip kernels' step tables (``build_step_tables``) and lane
  segments are not built. The lane-segment arithmetic is kept only
  where it sets ``nalloc_y``, so the alloc frame matches;
* :func:`plan_from_fields` rebuilds a plan from the counterpart's
  ``GridderPlan`` as a dict of numpy fields, dropping the fields only
  the TPU kernels read (:data:`COUNTERPART_ONLY_FIELDS`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import native as _native
from .kernels import (
    es_beta,
    gauss_legendre_kernel_quadrature,
    kernel_support_for_epsilon,
)

SPEED_OF_LIGHT = 299792458.0

#: Patch shape in grid cells: sublane axis x lane axis, as the
#: counterpart chose them for the TPU. Lane origins are 128-aligned and
#: visibilities whose lane footprint straddles a 128-cell window are
#: duplicated into both windows (the ES kernel zeroes out-of-window
#: cells).
DEFAULT_PATCH_X = 48
DEFAULT_PATCH_Y = 128

#: Visibilities per block (the smallest of :func:`auto_block`'s sizes).
DEFAULT_BLOCK = 128


def auto_block(num_vis: int) -> int:
    """
    Default visibilities-per-block for a shard of ``num_vis`` samples:
    scale with workload size (group occupancy grows with density, so
    large shards afford long blocks at high fill), clamped to
    [128, 1024].
    """
    if num_vis >= 5_000_000:
        return 1024
    if num_vis >= 4_000_000:
        return 512
    if num_vis >= 1_500_000:
        return 256
    return DEFAULT_BLOCK


def auto_bin_group(num_vis: int) -> int:
    """
    Number of adjacent w-data-bins a block may span (4 above 1.5M
    samples, else 1; the counterpart's TPU tuning). Grouping bins merges
    each uv-tile's per-bin slot groups, so fewer slots are padding; the
    ES w-factor is exactly zero on the extra plane visits, so accuracy
    is unchanged.
    """
    if num_vis >= 1_500_000:
        return 4
    return 1


#: Strip-buffer budget of the counterpart's TPU kernels (bytes). It
#: splits wide grids into lane segments there, and so rounds the lane
#: extent ``nalloc_y`` up to whole segments; the port keeps that
#: rounding so its alloc frame is the counterpart's.
_SEG_BUDGET_BYTES = 10 * 1024 * 1024


def _lane_alloc(nalloc_y: int, patch_x: int, overhang: int,
                group: int) -> int:
    """
    ``nalloc_y`` rounded up as the counterpart's lane segmentation does:
    segments of ``4 * group`` (patch_x, width) float32 buffers within
    :data:`_SEG_BUDGET_BYTES`, each a whole number of 128-lane windows.
    """
    width = _SEG_BUDGET_BYTES // (4 * group * patch_x * 4)
    seg_cap = max(128, (width // 128) * 128)
    num_segments = max(1, -(-(nalloc_y - overhang) // (seg_cap - overhang)))
    seg_lanes = (
        -(-(nalloc_y - overhang) // num_segments) + 127
    ) // 128 * 128
    return num_segments * seg_lanes + overhang


def plane_group_of(wstacking: bool, nplanes: int) -> int:
    """
    Number of adjacent w-planes gridded together: every block visit
    grids onto all G planes and shares one ES factor build. The ES
    w-factor is exactly zero on planes outside a block's window, so
    overhanging visits add zeros. 2 whenever w-stacking yields multiple
    planes, else 1 (the gridding kernel is built for G = 1 and 2).
    """
    return 2 if wstacking and nplanes >= 2 else 1


def next_even_grid_size(n: int) -> int:
    """Smallest even 7-smooth integer >= n (FFT-friendly sizes)."""
    n = max(int(n), 2)
    while True:
        m = n
        for p in (2, 3, 5, 7):
            while m % p == 0:
                m //= p
        if m == 1 and n % 2 == 0:
            return n
        n += 1


@dataclass
class GridderPlan:
    """Static-shape execution plan for gridding/degridding one shard."""

    # Image / grid geometry
    num_pixels: int
    pixel_size_lm: float
    ngrid: int
    nalloc_x: int
    nalloc_y: int
    support: int
    beta: float
    sigma: float
    du: float

    # W-stacking
    wstacking: bool
    nplanes: int
    dw: float
    w0: float
    n_mid: float

    # Tiling
    patch_x: int
    patch_y: int
    tile_x: int
    tile_y: int
    block: int
    num_blocks: int
    max_active: int

    # Per-visibility arrays in BLOCK-SLOT layout (length
    # num_blocks * block): block b owns slots [b*B, (b+1)*B), padded
    # slots carry order == num_vis_data.
    order: np.ndarray = field(repr=False)
    flip: np.ndarray = field(repr=False)
    x0: np.ndarray = field(repr=False)  # int32 footprint start (alloc)
    y0: np.ndarray = field(repr=False)
    fx: np.ndarray = field(repr=False)  # f32 x - x0
    fy: np.ndarray = field(repr=False)
    ws: np.ndarray = field(repr=False)  # f32 |w| in wavelengths

    # Per-block arrays (block_start[b] == b * block by construction)
    block_start: np.ndarray = field(repr=False)
    block_len: np.ndarray = field(repr=False)
    block_ox: np.ndarray = field(repr=False)
    block_oy: np.ndarray = field(repr=False)

    # Per-plane
    active_table: np.ndarray = field(repr=False)
    plane_w: np.ndarray = field(repr=False)

    # Correction quadrature (host float64, cast on device)
    quad_nodes: np.ndarray = field(repr=False)
    quad_folded: np.ndarray = field(repr=False)

    #: Number of real (row, chan) visibility samples (before padding).
    num_vis_data: int = 0

    #: Adjacent w-planes gridded per kernel call (see
    #: :func:`plane_group_of`): group k covers planes [k*G, (k+1)*G).
    plane_group: int = 1
    #: Kernel-ready derived columns precomputed by the native engine
    #: in the export pass (None under the numpy fallback;
    #: ops/gridder.plan_host_arrays computes them on demand):
    #: packed (8, num_vis) f32, flip_sign (+-1 f32), and the static
    #: w-shift phase factors cos/sin(-2 pi n_mid * ws).
    packed: np.ndarray = field(repr=False, default=None)
    flip_sign: np.ndarray = field(repr=False, default=None)
    phase_cos: np.ndarray = field(repr=False, default=None)
    phase_sin: np.ndarray = field(repr=False, default=None)
    #: Compact-staging column (export_packed=False): source sample
    #: index per slot with the conjugation flip in the sign
    #: (ops/gridder.py:compact_plan_host_arrays).
    order_enc: np.ndarray = field(repr=False, default=None)

    @property
    def num_vis(self) -> int:
        """Number of visibility slots (num_blocks * block)."""
        return len(self.order)

    @property
    def num_groups(self) -> int:
        """Number of plane groups."""
        return -(-self.nplanes // self.plane_group)


#: Fields of the counterpart's ``GridderPlan`` that only its TPU strip
#: kernels read (lane segments, strip count, DMA step tables). The port
#: neither builds nor reads them; :func:`plan_from_fields` drops them.
COUNTERPART_ONLY_FIELDS = frozenset({
    "num_y_segments", "seg_lanes", "num_strips", "step_val", "step_aux",
    "step_aux2", "step_count", "first_block", "last_blocks",
})


def _build_active_table(
    plane_lo: np.ndarray,
    plane_hi: np.ndarray,
    nplanes: int,
    min_active: int,
) -> np.ndarray:
    """
    Vectorized construction of the (nplanes, max_active) table of block
    indices active on each w-plane, padded with -1.
    """
    num_blocks = len(plane_lo)
    if num_blocks == 0:
        return np.full((nplanes, max(min_active, 1)), -1, dtype=np.int32)

    lengths = (plane_hi - plane_lo + 1).astype(np.int64)
    total = int(lengths.sum())
    block_rep = np.repeat(np.arange(num_blocks, dtype=np.int64), lengths)
    offsets = np.arange(total) - np.repeat(
        np.concatenate(([0], np.cumsum(lengths)[:-1])), lengths
    )
    plane_rep = np.repeat(plane_lo, lengths) + offsets

    perm = np.argsort(plane_rep, kind="stable")
    plane_sorted = plane_rep[perm]
    block_sorted = block_rep[perm]

    counts = np.bincount(plane_sorted, minlength=nplanes)
    max_active = max(int(counts.max()), min_active, 1)
    plane_starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    within = np.arange(total) - plane_starts[plane_sorted]

    table = np.full((nplanes, max_active), -1, dtype=np.int32)
    table[plane_sorted, within] = block_sorted
    return table


#: Relative costs of the counterpart's ``sigma="auto"`` model (only
#: their ratio matters); copied so the port resolves the same sigma.
SIGMA_COST_GRID_PER_VIS_PLANE = 1.7e-9
SIGMA_COST_FFT_PER_CELL_PLANE = 3.3e-10

#: Oversampling candidates for sigma="auto": 2.0 (smallest support)
#: and 1.5 (smaller padded grid per plane).
SIGMA_CANDIDATES = (2.0, 1.5)


def w_range(uvw: np.ndarray, channel_frequencies: np.ndarray) -> tuple:
    """
    (min, max) of ``|w|`` in wavelengths over all (row, chan) samples —
    the w extent after the w >= 0 conjugation flip. Used to resolve
    ``sigma="auto"`` without building a plan.
    """
    uvw = np.asarray(uvw, np.float64)
    freqs = np.asarray(channel_frequencies, np.float64)
    if len(uvw) == 0 or len(freqs) == 0:
        return 0.0, 0.0
    if _native.available():
        return _native.w_minmax(uvw, freqs)
    w = np.abs(np.multiply.outer(uvw[:, 2], freqs / SPEED_OF_LIGHT))
    return float(w.min()), float(w.max())


def nm1_min_of(num_pixels: int, pixel_size_lm: float) -> float:
    """
    Most negative ``n(l,m) - 1`` over the image (at the corner): the
    w-direction "bandwidth" that sets plane spacing and the w-shift.
    """
    half_fov = (num_pixels / 2) * pixel_size_lm
    corner_r2 = min(2.0 * half_fov * half_fov, 0.999)
    return -corner_r2 / (1.0 + np.sqrt(1.0 - corner_r2))


def resolve_sigma(
    num_vis: int,
    num_pixels: int,
    *,
    w_extent: float,
    nm1_min: float,
    epsilon: float = 1e-4,
    do_wstacking: bool = True,
) -> float:
    """
    Pick the oversampling factor minimizing the modeled invert cost
    ``num_vis * W(sigma) * c_grid + nplanes(sigma) * ngrid(sigma)^2 *
    c_fft`` over :data:`SIGMA_CANDIDATES`. ``w_extent`` is
    ``wmax - wmin`` in wavelengths (after the w >= 0 flip).
    """

    def cost(sigma: float) -> float:
        support = kernel_support_for_epsilon(epsilon, sigma)
        ngrid = next_even_grid_size(int(np.ceil(sigma * num_pixels)))
        if do_wstacking and abs(nm1_min) > 0:
            dw = 1.0 / (sigma * abs(nm1_min))
            nplanes = int(np.floor(w_extent / dw)) + support
        else:
            nplanes = 1
        return (
            num_vis * support * SIGMA_COST_GRID_PER_VIS_PLANE
            + nplanes * ngrid * ngrid * SIGMA_COST_FFT_PER_CELL_PLANE
        )

    return min(SIGMA_CANDIDATES, key=cost)


def prewarm_plan_arenas(num_vis: int) -> None:
    """
    Pre-fault the host allocation arenas (python + native) for a
    subsequent :func:`make_plan` of ~``num_vis`` samples, so the timed
    planning path finds warm pages (``utils/hostmem.py``). For untimed
    start-up phases (the CLI's start). Buffers park in the arenas and
    are reused.
    """
    from ..utils.hostmem import alloc_populated

    n = int(num_vis)
    if n <= 0:
        return
    ns = int(n * 1.3) + 1024  # slots: straddlers + block padding
    # Native planner scratch (build_slot_plan): per-sample geometry
    # columns, sort key, extended/sorted index arrays.
    _native.arena_prewarm(
        [n, 4 * n, 4 * n, 4 * n, 4 * n, 4 * n, 8 * n]
        + [8 * ns, 8 * ns, 8 * ns]
    )
    # Python-side export buffers: order + order_enc (compact) and the
    # packed/flip/phase columns (slot export).
    held = [alloc_populated(ns, np.int32) for _ in range(2)]
    held += [alloc_populated(4 * ns, np.float32)]  # packed rows
    held += [alloc_populated(ns, np.float32) for _ in range(3)]
    del held  # finalizers park the buffers in the arena


def make_plan(
    uvw: np.ndarray,
    channel_frequencies: np.ndarray,
    num_pixels: int,
    pixel_size_lm: float,
    *,
    epsilon: float = 1e-4,
    do_wstacking: bool = True,
    sigma: float | str = 2.0,
    block: int | None = None,
    bin_group: int | None = None,
    min_blocks: int = 1,
    min_active: int = 1,
    min_planes: int = 1,
    w_range: tuple | None = None,
    export_coords: bool = False,
    export_packed: bool = True,
) -> GridderPlan:
    """
    Build a :class:`GridderPlan` for visibilities ``uvw`` (nrow, 3) in
    meters at ``channel_frequencies`` (nchan,) Hz.

    ``w_range=(wmin, wmax)`` overrides the |w| extent (in wavelengths,
    AFTER the w >= 0 conjugation flip) used for the w-plane grid.
    Sharded callers summing plane GRIDS across shards (the
    distributed-FFT invert) MUST pass the global range so every shard
    bins onto the identical plane set — per-shard w origins differ,
    and plane-p grids from different origins must never be added.
    The override must cover this shard's own range.

    ``sigma`` is the uv-grid oversampling factor; ``"auto"`` picks it
    from a grid-vs-gridding cost model (:func:`resolve_sigma`) — FFT-
    dominated wide-field configs get 1.5 (44% smaller padded grid area
    per plane), visibility-dominated ones keep 2.0 (smallest kernel
    support). Sharded callers must resolve a single value up front so
    every shard plans the same grid.

    ``min_blocks`` / ``min_active`` / ``min_planes`` pad the static
    shapes up to common bounds — used by the sharded invert so every
    device runs an identical program over differently-sized shards.

    ``export_coords`` controls whether the native engine materializes
    the per-slot coordinate columns (flip, x0, y0, fx, fy, ws). The
    port's kernels read the engine's ``packed`` columns instead, so the
    default skips them; callers that read them (``pack_plan_columns``)
    pass True. The numpy path always materializes them, whatever its
    value, and exports no ``packed`` / ``flip_sign`` / phase columns
    (``ops/gridder.py`` builds them on demand).

    ``export_packed=False`` (compact staging) skips the packed /
    flip_sign / phase columns too and exports ``order_enc`` instead —
    the device prologue (ops/gridder.py:build_assemble) rebuilds
    everything on device. Such a plan can only feed the compact path
    (``compact_plan_host_arrays`` + ``build_assemble``).
    """
    uvw = np.asarray(uvw, dtype=np.float64)
    freqs = np.asarray(channel_frequencies, dtype=np.float64)

    num_vis = len(uvw) * len(freqs)
    use_native = num_vis > 0 and _native.available()
    if bin_group is None:
        bin_group = auto_bin_group(num_vis)
    bin_group = max(int(bin_group), 1)
    if block is None:
        block = auto_block(num_vis)

    patch_x = DEFAULT_PATCH_X
    patch_y = DEFAULT_PATCH_Y
    support_bound = kernel_support_for_epsilon(
        epsilon, 2.0 if sigma == "auto" else float(sigma)
    )
    # Keep at least one 8-row tile column under the patch overhang.
    patch_x = max(patch_x, ((support_bound + 8 + 7) // 8) * 8)

    if use_native:
        # The engine computes the per-sample arrays later, in one fused
        # multithreaded pass; only the |w| range is needed here.
        wmin, wmax = _native.w_minmax(uvw, freqs)
    else:
        # Flattened per-sample coordinates in wavelengths
        scale = freqs / SPEED_OF_LIGHT
        u = np.multiply.outer(uvw[:, 0], scale).ravel()
        v = np.multiply.outer(uvw[:, 1], scale).ravel()
        w = np.multiply.outer(uvw[:, 2], scale).ravel()

        # Flip to w >= 0 (dirty image is real; V(-u,-v,-w) = conj(V))
        flip = w < 0
        u = np.where(flip, -u, u)
        v = np.where(flip, -v, v)
        w = np.where(flip, -w, w)
        wmin = float(w.min()) if num_vis else 0.0
        wmax = float(w.max()) if num_vis else 0.0

    if w_range is not None:
        gmin, gmax = float(w_range[0]), float(w_range[1])
        if num_vis and (gmin > wmin + 1e-9 or gmax < wmax - 1e-9):
            raise ValueError(
                f"w_range {w_range} does not cover this shard's "
                f"|w| range ({wmin}, {wmax})"
            )
        wmin, wmax = gmin, gmax

    # --- w-plane setup -------------------------------------------------
    nm1_min = nm1_min_of(num_pixels, pixel_size_lm)
    n_mid = nm1_min / 2.0  # centre the nm1 band ("w-shift")

    wstacking = bool(do_wstacking) and abs(nm1_min) > 0

    if sigma == "auto":
        sigma = resolve_sigma(
            num_vis,
            num_pixels,
            w_extent=wmax - wmin,
            nm1_min=nm1_min,
            epsilon=epsilon,
            do_wstacking=wstacking,
        )
    sigma = float(sigma)

    support = kernel_support_for_epsilon(epsilon, sigma)
    beta = es_beta(support, sigma)
    ngrid = next_even_grid_size(int(np.ceil(sigma * num_pixels)))
    du = 1.0 / (ngrid * pixel_size_lm)

    if wstacking:
        # Plane spacing: sampling along w at spacing dw must keep
        # |dw * (nm1 - n_mid)| <= dw * |nm1_min| / 2 inside the
        # kernel's alias-free band 1/(2 sigma).
        dw = 1.0 / (sigma * abs(nm1_min))
        # Floor binning: a visibility in data bin
        # q = floor((w - wmin) / dw) touches exactly the W planes
        # [q, q + W) at w0 + p * dw, w0 = wmin - (W/2 - 1) dw — one
        # fewer plane per visibility than the rounded-bin +-W/2 window.
        num_bins = (
            int(np.floor((wmax - wmin) / dw)) + 1 if num_vis else 1
        )
        nplanes = num_bins + support - 1
        w0_plane = wmin - (support / 2.0 - 1.0) * dw
        bin_origin = wmin
    else:
        dw = 1.0
        num_bins = 1
        nplanes = 1
        w0_plane = 0.0
        bin_origin = 0.0
    nplanes = max(nplanes, min_planes)

    # --- uv tiling -----------------------------------------------------
    # Sublane axis: origins must be 8-aligned; lane axis: 128-aligned
    # (TPU memory tiling constraints on dynamic DMA offsets). The lane
    # axis tiles are the full 128-cell patch windows; lane straddlers
    # are duplicated into both windows (see DEFAULT_PATCH_Y).
    tile_x = ((patch_x - support + 1) // 8) * 8
    tile_y = patch_y
    if tile_x <= 0 or support >= patch_y:
        raise ValueError(
            f"support {support} too large for patch "
            f"({patch_x}, {patch_y})"
        )
    half = support // 2

    # Footprint starts lie in [1 - W/2 + W, ngrid + W/2] in the alloc
    # frame; strips must cover the largest start, and the alloc must
    # also contain the wrap margin [0, ngrid + 2W) read by the fold.
    # The alloc row extent is the counterpart's: a whole number of its
    # strips (num_strips * tile_x) plus the carry rows.
    carry = patch_x - tile_x
    nalloc_min = ngrid + 2 * support
    max_start = ngrid + half
    ntx = max_start // tile_x + 1
    num_strips = max(ntx, -(-(nalloc_min - carry) // tile_x))
    nalloc_x = num_strips * tile_x + carry
    # Lane alloc: whole 128-cell windows covering every footprint end
    # (duplicated straddlers land one window above their start).
    nalloc_y = max(max_start + support, nalloc_min)
    nalloc_y = -(-nalloc_y // 128) * 128

    group = plane_group_of(wstacking, nplanes)
    nalloc_y = _lane_alloc(nalloc_y, patch_x, patch_y - tile_y, group)
    # Lane-window count for the (x-tile, y-window) key: every window of
    # the final alloc is addressable so duplicated straddlers decode
    # injectively via (tile % nty).
    nty = nalloc_y // tile_y

    if use_native:
        # Fused C++ pass straight to the final block-slot layout:
        # geometry, lane-straddler duplication, radix key sort, block
        # split and slot scatter all happen inside the native engine
        # (csrc/cip_native.cpp:cip_slot_plan_build); none of the
        # O(num_vis) intermediate arrays are materialized in Python.
        slot = _native.build_slot_plan(
            uvw,
            freqs,
            inv_du=1.0 / du,
            ngrid=ngrid,
            support=support,
            tile_x=tile_x,
            tile_y=tile_y,
            ntiles_y=nty,
            wstacking=wstacking,
            w0_plane=bin_origin,
            dw=dw,
            num_bins=num_bins,
            block=block,
            bin_group=bin_group,
            min_blocks=min_blocks,
            pad_order=num_vis,
            # Slot staging applies the w-shift pre-phase only when
            # w-stacking is on; without it the phases must be identity
            # (cos = 1, sin = 0), or psf() and slot-input inverts pick
            # up a spurious per-slot rotation.
            phase_factor=(-2.0 * np.pi * n_mid) if wstacking else 0.0,
            export_coords=export_coords,
            export_packed=export_packed,
        )
        num_blocks = slot["num_blocks"]
        num_blocks_padded = len(slot["block_len"])
        slot_order = slot["order"]
        slot_flip = (
            slot["flip"].astype(bool) if slot["flip"] is not None else None
        )
        slot_x0 = slot["x0"]
        slot_y0 = slot["y0"]
        slot_fx = slot["fx"]
        slot_fy = slot["fy"]
        slot_ws = slot["ws"]
        block_len_padded = slot["block_len"]
        block_ox_padded = slot["block_ox"]
        block_oy_padded = slot["block_oy"]
        bin_lo = slot["bin_lo"][:num_blocks].astype(np.int64)
        bin_hi = slot["bin_hi"][:num_blocks].astype(np.int64)
        slot_packed = slot["packed"]
        slot_flip_sign = slot["flip_sign"]
        slot_phase_cos = slot["phase_cos"]
        slot_phase_sin = slot["phase_sin"]
        slot_order_enc = slot["order_enc"]
    else:
        # Footprint start cell: W consecutive cells centred on the
        # coordinate, in the alloc frame (wrapped into [0, ngrid) then
        # offset by W so footprints never go negative):
        # x0 = floor(x) - W/2 + 1
        x = np.mod(u / du + ngrid / 2.0, ngrid) + support
        y = np.mod(v / du + ngrid / 2.0, ngrid) + support
        x0 = np.floor(x).astype(np.int64) - half + 1
        y0 = np.floor(y).astype(np.int64) - half + 1

        if wstacking:
            wbin = np.floor((w - bin_origin) / dw).astype(np.int64)
            wbin = np.clip(wbin, 0, num_bins - 1)
        else:
            wbin = np.zeros(num_vis, dtype=np.int64)

        # Duplicate lane straddlers into the window above, then sort
        # the extended set by (tile, wbin): tile-major so each block
        # has one patch origin; wbin-minor so a block's w extent
        # (hence the set of planes it touches) stays narrow.
        straddle = (y0 % tile_y) > (tile_y - support)
        dup = np.flatnonzero(straddle)
        src_ext = np.concatenate(
            [np.arange(num_vis, dtype=np.int64), dup]
        )
        yt_ext = np.concatenate([y0 // tile_y, y0[dup] // tile_y + 1])
        tile_ext = (x0 // tile_x)[src_ext] * nty + yt_ext
        wbin_ext = wbin[src_ext]
        order_ext = np.lexsort((wbin_ext, tile_ext))
        order = src_ext[order_ext]
        tile_sorted = tile_ext[order_ext]
        wbin_sorted = wbin_ext[order_ext]
        x0_sorted = x0[order].astype(np.int32)
        y0_sorted = y0[order].astype(np.int32)
        fx_sorted = (x - x0)[order].astype(np.float32)
        fy_sorted = (y - y0)[order].astype(np.float32)
        ws_sorted = w[order].astype(np.float32)
        flip_sorted = flip[order]

        # --- block decomposition (in sorted space) ----------------------
        # Blocks are (tile, wbin)-pure: every visibility in a block
        # shares one patch origin AND one w data bin, so the strip
        # kernel grids a block onto exactly its W-plane window. The
        # sorted space includes the duplicated lane straddlers
        # (``order`` maps slots to source samples, with duplicates).
        num_sorted = len(order)
        if num_sorted:
            # Group boundaries at (tile, wbin // bin_group) changes:
            # a block may span bin_group adjacent w-bins (its exact
            # [bin_lo, bin_hi] window is still read off the bin-sorted
            # first/last slots below) — see auto_bin_group.
            boundaries = (
                np.flatnonzero(
                    (np.diff(tile_sorted) != 0)
                    | (np.diff(wbin_sorted // bin_group) != 0)
                )
                + 1
            )
            group_starts = np.concatenate(([0], boundaries))
            group_ends = np.concatenate((boundaries, [num_sorted]))
            num_per_group = -(-(group_ends - group_starts) // block)
            sorted_start = np.concatenate(
                [
                    np.arange(gstart, gend, block)
                    for gstart, gend in zip(group_starts, group_ends)
                ]
            ).astype(np.int64)
            group_end_rep = np.repeat(group_ends, num_per_group)
            block_len = (
                np.minimum(sorted_start + block, group_end_rep)
                - sorted_start
            )
        else:
            sorted_start = np.zeros(0, dtype=np.int64)
            block_len = np.zeros(0, dtype=np.int64)

        num_blocks = len(sorted_start)
        block_tile = (
            tile_sorted[sorted_start]
            if num_blocks
            else np.zeros(0, np.int64)
        )
        block_ox = ((block_tile // nty) * tile_x).astype(np.int32)
        block_oy = ((block_tile % nty) * tile_y).astype(np.int32)
        if num_blocks:
            bin_lo = wbin_sorted[sorted_start]  # ascending in a tile
            bin_hi = wbin_sorted[sorted_start + block_len - 1]
        else:
            bin_lo = np.zeros(0, dtype=np.int64)
            bin_hi = np.zeros(0, dtype=np.int64)

        # --- block-slot re-packing --------------------------------------
        # Slot layout: block b owns [b*B, (b+1)*B); every DMA offset is
        # b*B, statically aligned. slot_src maps slots to sorted
        # indices (sentinel num_sorted for padding).
        num_blocks_padded = max(num_blocks, min_blocks, 1)
        num_slots = num_blocks_padded * block
        slot_idx = np.arange(num_slots)
        slot_block = slot_idx // block
        slot_lane = slot_idx % block
        block_len_padded = np.zeros(num_blocks_padded, dtype=np.int64)
        block_len_padded[:num_blocks] = block_len
        sorted_start_padded = np.zeros(num_blocks_padded, dtype=np.int64)
        sorted_start_padded[:num_blocks] = sorted_start
        slot_valid = slot_lane < block_len_padded[slot_block]
        slot_src = np.where(
            slot_valid,
            sorted_start_padded[slot_block] + slot_lane,
            num_sorted,
        )

        def _slotted(sorted_values, pad_value, dtype):
            padded = np.append(
                np.asarray(sorted_values, dtype=dtype),
                np.asarray(pad_value, dtype=dtype)[None],
            )
            return padded[slot_src]

        slot_order = _slotted(order, num_vis, np.int64).astype(np.int32)
        slot_flip = _slotted(flip_sorted, False, bool)
        slot_x0 = _slotted(x0_sorted, support, np.int32)
        slot_y0 = _slotted(y0_sorted, support, np.int32)
        slot_fx = _slotted(fx_sorted, 0.5, np.float32)
        slot_fy = _slotted(fy_sorted, 0.5, np.float32)
        slot_ws = _slotted(ws_sorted, 0.0, np.float32)

        def _pad_blocks(arr, dtype):
            out = np.zeros(num_blocks_padded, dtype=dtype)
            out[: len(arr)] = arr
            return out

        block_ox_padded = _pad_blocks(block_ox, np.int32)
        block_oy_padded = _pad_blocks(block_oy, np.int32)
        block_len_padded = _pad_blocks(block_len, np.int32)
        slot_packed = None
        slot_flip_sign = None
        slot_phase_cos = None
        slot_phase_sin = None
        slot_order_enc = None

    # --- plane windows and assembly --------------------------------
    # Data bin q -> active plane window [q, q + W) (floor binning)
    if num_blocks:
        plane_lo = np.maximum(bin_lo, 0)
        plane_hi = np.minimum(bin_hi + support - 1, nplanes - 1)
    else:
        plane_lo = np.zeros(0, dtype=np.int64)
        plane_hi = np.zeros(0, dtype=np.int64)

    active_table = _build_active_table(
        plane_lo, plane_hi, nplanes, min_active
    )
    max_active = active_table.shape[1]

    plane_w = w0_plane + dw * np.arange(nplanes, dtype=np.float64)
    quad_nodes, quad_folded = gauss_legendre_kernel_quadrature(
        support, beta
    )

    return GridderPlan(
        num_pixels=num_pixels,
        pixel_size_lm=float(pixel_size_lm),
        ngrid=ngrid,
        nalloc_x=nalloc_x,
        nalloc_y=nalloc_y,
        support=support,
        beta=float(beta),
        sigma=float(sigma),
        du=float(du),
        wstacking=wstacking,
        nplanes=nplanes,
        dw=float(dw),
        w0=float(w0_plane),
        n_mid=float(n_mid),
        patch_x=patch_x,
        patch_y=patch_y,
        tile_x=tile_x,
        tile_y=tile_y,
        block=block,
        num_blocks=num_blocks_padded,
        max_active=max_active,
        num_vis_data=num_vis,
        order=slot_order,
        flip=slot_flip,
        x0=slot_x0,
        y0=slot_y0,
        fx=slot_fx,
        fy=slot_fy,
        ws=slot_ws,
        block_start=(
            np.arange(num_blocks_padded, dtype=np.int64) * block
        ).astype(np.int32),
        block_len=block_len_padded.astype(np.int32),
        block_ox=block_ox_padded,
        block_oy=block_oy_padded,
        active_table=active_table,
        plane_w=plane_w.astype(np.float32),
        quad_nodes=quad_nodes,
        quad_folded=quad_folded,
        plane_group=group,
        packed=slot_packed,
        flip_sign=slot_flip_sign,
        phase_cos=slot_phase_cos,
        phase_sin=slot_phase_sin,
        order_enc=slot_order_enc,
    )


def auto_block_and_group(num_vis: int) -> tuple[int, int]:
    """
    (block, bin_group) for a shard of ``num_vis`` samples (counterpart
    copy, without its environment overrides). Sharded callers derive
    both from the global per-shard count so every shard plans the same
    block size and w-bin grouping.
    """
    return auto_block(num_vis), auto_bin_group(num_vis)


def plan_shape_maxima(plans: list) -> dict:
    """
    The data-dependent shapes of a plan list, as the maxima a group of
    shards is padded to (counterpart copy without the TPU step-table
    width, which the port does not build). Ranks allgather these few
    ints so every rank pads its own shards to the same global shapes
    without loading remote data.
    """
    return {
        "num_blocks": max(p.num_blocks for p in plans),
        "max_active": max(p.max_active for p in plans),
        "nplanes": max(p.nplanes for p in plans),
    }


def pad_plans_uniform(plans: list, maxima: dict | None = None) -> list:
    """
    Pad per-shard plans to common shapes: blocks (with their visibility
    slots), active-table width and w-planes (counterpart
    ``pad_plans_uniform`` without its TPU step tables). The port runs
    each shard eagerly, so it needs only one thing of this: every shard
    runs the same plane groups, in the same order, because the
    distributed mode's collectives run per plane; padding the rest
    keeps the plans equal to the counterpart's field by field.
    Geometry (grid, support, block, plane group) must already agree;
    ``maxima`` (:func:`plan_shape_maxima`) must dominate the local
    shapes.
    """
    import dataclasses

    if not plans:
        return plans
    geometry = {
        (p.ngrid, p.nalloc_x, p.nalloc_y, p.support, p.patch_x, p.patch_y,
         p.block, p.wstacking, p.plane_group)
        for p in plans
    }
    if len(geometry) != 1:
        raise ValueError(
            "Shard plans disagree on grid geometry; they must be built "
            "from the same imaging configuration"
        )
    local = plan_shape_maxima(plans)
    if maxima is None:
        maxima = local
    elif any(maxima[key] < local[key] for key in local):
        raise ValueError(
            f"padding targets {maxima} do not dominate local plan "
            f"shapes {local}"
        )
    num_blocks = maxima["num_blocks"]
    max_active = maxima["max_active"]
    nplanes = maxima["nplanes"]
    block = plans[0].block
    num_vis = num_blocks * block

    def _pad1(arr, target, fill):
        if arr is None or len(arr) == target:
            return arr
        out = np.full(target, fill, dtype=arr.dtype)
        out[: len(arr)] = arr
        return out

    padded = []
    for p in plans:
        table = np.full((nplanes, max_active), -1, dtype=np.int32)
        table[: p.active_table.shape[0], : p.active_table.shape[1]] = (
            p.active_table
        )
        # Engine-exported columns: pad with the values the numpy path
        # gives padding slots (x, y at support + 0.5, ws = 0, so the
        # phase is (1, 0)).
        packed, flip_sign = p.packed, p.flip_sign
        phase_cos, phase_sin = p.phase_cos, p.phase_sin
        if packed is not None and packed.shape[1] < num_vis:
            pad_cols = np.zeros((packed.shape[0], num_vis - packed.shape[1]),
                                np.float32)
            pad_cols[0] = pad_cols[1] = p.support + 0.5
            packed = np.concatenate([packed, pad_cols], axis=1)
            flip_sign = _pad1(flip_sign, num_vis, 1.0)
            phase_cos = _pad1(phase_cos, num_vis, 1.0)
            phase_sin = _pad1(phase_sin, num_vis, 0.0)
        padded.append(dataclasses.replace(
            p,
            packed=packed,
            flip_sign=flip_sign,
            phase_cos=phase_cos,
            phase_sin=phase_sin,
            nplanes=nplanes,
            num_blocks=num_blocks,
            max_active=max_active,
            order=_pad1(p.order, num_vis, p.num_vis_data),
            order_enc=_pad1(p.order_enc, num_vis, p.num_vis_data),
            flip=_pad1(p.flip, num_vis, False),
            x0=_pad1(p.x0, num_vis, p.support),
            y0=_pad1(p.y0, num_vis, p.support),
            fx=_pad1(p.fx, num_vis, 0.5),
            fy=_pad1(p.fy, num_vis, 0.5),
            ws=_pad1(p.ws, num_vis, 0.0),
            block_start=(np.arange(num_blocks, dtype=np.int64)
                         * block).astype(np.int32),
            block_len=_pad1(p.block_len, num_blocks, 0),
            block_ox=_pad1(p.block_ox, num_blocks, 0),
            block_oy=_pad1(p.block_oy, num_blocks, 0),
            active_table=table,
            plane_w=(p.w0 + p.dw * np.arange(nplanes, dtype=np.float64)
                     ).astype(np.float32),
        ))
    return padded


def plan_from_fields(fields: dict) -> GridderPlan:
    """
    Rebuild a :class:`GridderPlan` from a plan given as a dict of its
    fields (numpy arrays and scalars), e.g. ``dataclasses.asdict`` of
    the counterpart's ``GridderPlan``. This lets one identical plan
    feed both packages. The fields in :data:`COUNTERPART_ONLY_FIELDS`
    are dropped; other unknown or missing required fields raise.
    """
    import dataclasses

    known = {f.name: f for f in dataclasses.fields(GridderPlan)}
    fields = {
        k: v for k, v in fields.items() if k not in COUNTERPART_ONLY_FIELDS
    }
    unknown = sorted(set(fields) - set(known))
    if unknown:
        raise ValueError(f"unknown GridderPlan fields: {unknown}")
    required = [
        name
        for name, f in known.items()
        if f.default is dataclasses.MISSING
        and f.default_factory is dataclasses.MISSING
    ]
    missing = [name for name in required if name not in fields]
    if missing:
        raise ValueError(f"missing GridderPlan fields: {missing}")
    return GridderPlan(**fields)
