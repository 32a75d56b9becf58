"""
The schedule of kernels B1 (``csrc/grid.cu``) and B3 (``csrc/degrid.cu``)
held on the CPU, where no CUDA kernel runs.

* (a) The work lists. B3's (``ops/gridder.py:tile_chunks``, (first,
  count) rows): every active block of a plane group in exactly one
  chunk, one patch origin per chunk, consecutive blocks, at most R a
  chunk, heaviest first. B1's (``ops/gridder.py:grid_chunks``): the
  destination rectangles partition the periodic grid, at most tile_x
  rows and, where a run reaches them, ``grid_piece_cols`` columns (the
  kernel's shared planes) and at most N - W + 1 rows and columns (so no
  footprint meets one on both sides); each lists, in
  run order, every tile run whose patch reaches it after the fold.
  Both are built once per plan (``ops/gridder.py:work_lists``), across
  staging and the invert and predict builders, which launch the staged
  tables' rows; a staging holds only the lists of the passes it
  stages.
* (b) A torch model of B1's schedule: per chunk, per source run in
  order, each visibility's candidate footprint (the kernel's window:
  the W cells after floor(pos - W/2), clipped to the patch) lands at
  row (ox + r - W) mod N and column (oy + c - W) mod N; the cells inside
  the chunk's rectangle are added in slot order by their owner, the one
  of W^2 that holds the cell's (row mod W, column mod W), as a register
  sum while the owner's cell stays the same, added to the plane when it
  changes and at the chunk's end; the rectangle is stored once.
  Each footprint's start is kept rectangle-local, a start within W - 1
  cells below N taken as one that wraps into the rectangle's first rows
  or columns: exact because the rectangles that runs reach span at most
  N - W + 1 cells, which the model checks (on the 64- and 32-cell grids
  that rule cuts them narrower than tile_x and ``grid_piece_cols``).
  The model checks that the rectangles cover every cell once, and is
  held against ``_fold_wraps o grid_planes_reference`` and against the
  JAX group kernel in interpret mode folded by the JAX package's
  ``_fold_wraps``, at 1e-5 of each plane's max. Run with its chunks and
  each chunk's owners in shuffled orders (seeded) it gives the same
  bits: the order of every cell's sum is fixed by the plan and the work
  list, not by the order the work runs in.
* (c) The same for B3: each chunk's windows read from the periodic grid
  with modular addressing, rows summed first, then columns, then the
  planes, held against ``degrid_planes_reference`` of the unfolded
  planes and the JAX group kernel on the JAX package's
  ``_unfold_wraps``.
* (d) The plans: one whose footprints cross the periodic edge (the
  96 px plan at 40 asec, where |u|/du exceeds N/2 - W and every tile is
  an edge tile, and a 256 px plan at 20 asec, with edge and interior
  tiles), one whose hot tile is split into
  several chunks (R = 2), and two grids narrower than a patch (48 x
  128): 32 px at 60 asec (N = 64) and 16 px at 120 asec (N = 32),
  where every patch's 128 columns cover the whole period.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ska_sdp_cip_tpu.io.synth import synthetic_uvw
from ska_sdp_cip_tpu.ops import gridder as jg
from ska_sdp_cip_tpu.ops import pallas_gridder as jpg
from ska_sdp_cip_tpu.ops import plan as jplan
from ska_sdp_cip_tpu_torch.ops import cuda_gridder as tcg
from ska_sdp_cip_tpu_torch.ops import gridder as tg
from ska_sdp_cip_tpu_torch.ops import plan as tplan
from ska_sdp_cip_tpu_torch.ops.kernels import es_kernel

torch.set_num_threads(1)

RTOL = 1e-5

#: name -> (times, antennas, channels, npix, asec, R): "wrap", 96 px at
#: 40 asec (the existing kernel tests' plan: every tile an edge tile);
#: "edge", 256 px at 20 asec (max |u|/du 313 > N/2 - W = 250: edge and
#: interior tiles); "split", the same uv coverage at 12 asec
#: with two blocks a chunk, so the hot tiles are split; "tiny64" and
#: "tiny32", grids of 64 and 32 cells (32 px at 60 asec, 16 px at 120
#: asec), narrower than a patch.
PLANS = {
    "wrap": (3, 10, 2, 96, 40.0, 1),
    "edge": (4, 16, 3, 256, 20.0, 8),
    "split": (4, 16, 3, 256, 12.0, 2),
    "tiny64": (4, 16, 3, 32, 60.0, 8),
    "tiny32": (4, 16, 3, 16, 120.0, 2),
}


def _uv(times, antennas, channels):
    uvw, _ = synthetic_uvw(times, antennas, max_baseline_m=5000.0, seed=23)
    return uvw, np.linspace(1.0e9, 1.07e9, channels)


@pytest.fixture(scope="module", params=list(PLANS))
def problem(request):
    times, antennas, channels, npix, asec, R = PLANS[request.param]
    uvw, freqs = _uv(times, antennas, channels)
    pixel = float(np.sin(np.radians(asec / 3600.0)))
    plan = jplan.make_plan(uvw, freqs, npix, pixel, block=32)
    port_plan = tplan.plan_from_fields(dataclasses.asdict(plan))
    rng = np.random.default_rng(11)
    re = rng.normal(size=plan.num_vis).astype(np.float32)
    im = rng.normal(size=plan.num_vis).astype(np.float32)
    pad = plan.order >= plan.num_vis_data
    re[pad] = 0.0
    im[pad] = 0.0
    grids = rng.normal(
        size=(2 * plan.plane_group, plan.ngrid, plan.ngrid)
    ).astype(np.float32)
    return {"name": request.param, "plan": plan, "port": port_plan,
            "R": R, "packed4": jpg.pack_plan_columns(plan), "re": re,
            "im": im, "grids": grids, "uvw": uvw, "freqs": freqs}


def _chunk_tiles(plan, ids, chunks):
    """Per row of a B3 table, from block origins and (first, count)
    alone: its tile's key, whether the tile's run is split over more
    than one chunk, and whether the tile's patch holds an alloc row or
    column in [0, 2W) or [N, N + 2W) (an edge tile: rows and columns
    the wrap fold moves or targets)."""
    N, W = plan.ngrid, plan.support
    moved = set(range(2 * W)) | set(range(N, N + 2 * W))
    first = ids[chunks[:, 0]]
    key = plan.block_ox[first].astype(np.int64) * 10**6 + plan.block_oy[
        first]
    split = np.array([int((key == k).sum()) > 1 for k in key], bool)
    edge = np.array([
        bool(moved & set(range(int(plan.block_ox[b]),
                               int(plan.block_ox[b]) + plan.patch_x)))
        or bool(moved & set(range(int(plan.block_oy[b]),
                                  int(plan.block_oy[b]) + plan.patch_y)))
        for b in first], bool)
    return key, split, edge


def _group_inputs(p, k, builder=tg.tile_chunks):
    plan = p["port"]
    ids = tg.group_active_blocks(plan)[k]
    w_g = tg.plan_host_arrays(plan, "cpu")["plane_wg"][k]
    return ids, builder(plan, ids, p["R"]), w_g


def _footprints(plan, packed, slots):
    """The kernels' candidate window of each slot, the W cells after
    floor(pos - W/2): rows, columns (patch-relative, clamped into the
    patch) and the ES factors ax, ay (zero off the patch)."""
    k = tcg._constants(plan)
    half = 0.5 * plan.support
    out = []
    for pos, size in ((packed[0][slots], plan.patch_x),
                      (packed[1][slots], plan.patch_y)):
        start = torch.floor(pos - half).to(torch.int64) + 1
        cells = start[:, None] + torch.arange(plan.support)[None, :]
        fac = es_kernel((cells.to(torch.float32) - pos[:, None])
                        * k["inv_half"], k["beta"])
        inside = (cells >= 0) & (cells < size)
        fac = torch.where(inside, fac, torch.zeros_like(fac))
        out += [torch.clamp(cells, 0, size - 1), fac]
    return out


def _amps(plan, packed, slots, w_g):
    k = tcg._constants(plan)
    ws = packed[2][slots]
    if not plan.wstacking:
        return [torch.ones_like(ws) for _ in w_g]
    return [es_kernel((float(w) - ws) * k["inv_whalf"], k["beta"])
            for w in np.asarray(w_g, np.float32)]


def _chunk_slots(plan, ids, first, count):
    blocks = ids[first : first + count]
    return torch.cat([
        torch.arange(b * plan.block, b * plan.block + plan.block_len[b])
        for b in blocks
    ]), int(plan.block_ox[blocks[0]]), int(plan.block_oy[blocks[0]])


def _periodic(plan, ox, oy):
    """Periodic rows and columns of a patch at alloc origin (ox, oy)."""
    N, W = plan.ngrid, plan.support
    return ((ox + torch.arange(plan.patch_x) - W) % N,
            (oy + torch.arange(plan.patch_y) - W) % N)


def _grid_staged(plan, packed, re, im, first, count, ids, w_g, row0, col0):
    """One source run's slots in slot order as the kernel stages them for
    a rectangle at (row0, col0): the rectangle-local start (lr, lc) of
    each footprint after the fold, in (-W, N - W], its ES factors ax, ay
    (zero off the patch) and its 2G vis * amp."""
    N, W = plan.ngrid, plan.support
    k = tcg._constants(plan)
    slots, ox, oy = _chunk_slots(plan, ids, first, count)
    origin, fac = [], []
    for pos, size, o in ((packed[0][slots], plan.patch_x, ox - row0),
                         (packed[1][slots], plan.patch_y, oy - col0)):
        start = torch.floor(pos - 0.5 * W).to(torch.int64) + 1
        cells = start[:, None] + torch.arange(W)[None, :]
        f = es_kernel((cells.to(torch.float32) - pos[:, None])
                      * k["inv_half"], k["beta"])
        fac.append(torch.where((cells >= 0) & (cells < size), f,
                               torch.zeros_like(f)))
        local = (o + start - W) % N
        origin.append(torch.where(local > N - W, local - N, local))
    amps = _amps(plan, packed, slots, w_g)
    va = torch.stack([vis * amp for amp in amps
                      for vis in (re[slots], im[slots])], dim=1)
    return origin[0], origin[1], fac[0], fac[1], va


def grid_model(plan, packed, re, im, ids, chunks, w_g, seed=None):
    """B1's schedule on the periodic grid (see the module docstring): a
    chunk's visibilities whose footprint meets its rectangle, in slot
    order (amps not all zero). Owner (i, j) holds every cell of the
    rectangle whose rectangle-local (row mod W, column mod W) is (i, j):
    of a footprint starting at (lr, lc), row di = (i + (-lr mod W)) mod
    W and column dj = (j + (-lc mod W)) mod W, the staged start's byte
    fields. It sums its cell's products while the cell stays the same,
    adds the sum to the planes when the cell changes and at the chunk's
    end, and the rectangle is stored once. (The kernel's owner sets,
    which split the planes between them, hold the same cells in the
    same order.) With a ``seed`` the chunks, and each chunk's owners,
    run in a shuffled order. Raises unless the rectangles cover each
    cell once."""
    N, G, W = plan.ngrid, len(w_g), plan.support
    out = torch.full((2 * G, N, N), float("nan"))
    written = torch.zeros((N, N), dtype=torch.int64)
    rng = np.random.default_rng(seed)
    order = (rng.permutation(len(chunks)) if seed is not None
             else range(len(chunks)))
    for n in order:
        row0, nrows, col0, ncols = chunks[n, :4].tolist()
        written[row0 : row0 + nrows, col0 : col0 + ncols] += 1
        if chunks[n, 5] > 0:
            # No footprint meets the rectangle on both sides, so the
            # rectangle-local start of _grid_staged is exact.
            assert max(nrows, ncols) <= N - W + 1
        patch = torch.zeros((2 * G, nrows * ncols))
        staged = [_grid_staged(plan, packed, re, im, first, count, ids,
                               w_g, row0, col0)
                  for first, count in chunks[n, 4:].reshape(-1, 2).tolist()
                  if count > 0]
        if staged:
            lr, lc, ax, ay, va = (torch.cat(x) for x in zip(*staged))
            keep = (lr < nrows) & (lc < ncols) & (va != 0).any(dim=1)
            lr, lc, ax, ay, va = (x[keep] for x in (lr, lc, ax, ay, va))
            owners = torch.arange(W * W)
            if seed is not None:
                owners = owners[torch.from_numpy(rng.permutation(W * W))]
            di = (owners[:, None] // W + (-lr) % W) % W  # (owner, vis)
            dj = (owners[:, None] % W + (-lc) % W) % W
            rows, cols = lr + di, lc + dj
            on = (rows >= 0) & (rows < nrows) & (cols >= 0) & (cols < ncols)
            # Each owner's cells in slot order, owner after owner.
            o, v = on.nonzero(as_tuple=True)
            cell = (rows * ncols + cols)[o, v]
            new = torch.ones_like(cell, dtype=torch.bool)
            new[1:] = (cell[1:] != cell[:-1]) | (o[1:] != o[:-1])
            run = torch.cumsum(new, 0) - 1
            # ax * (vis * amp) first, then * ay: the kernel's order.
            val = (ax[v, di[o, v]][:, None] * va[v]) * ay[v, dj[o, v]][:, None]
            sums = torch.zeros((int(new.sum()), 2 * G))
            sums.index_add_(0, run, val)  # a register sum a stay
            patch.index_add_(1, cell[new], sums.T)  # added on leaving
        out[:, row0 : row0 + nrows, col0 : col0 + ncols] = patch.view(
            2 * G, nrows, ncols)
    assert bool((written == 1).all())
    return out


def degrid_model(plan, packed, grids, ids, chunks, w_g):
    """B3's schedule: (2, num_vis) slot contributions of one group."""
    N, G = plan.ngrid, len(w_g)
    acc = torch.zeros((2, plan.num_vis))
    for first, count in chunks.tolist():
        slots, ox, oy = _chunk_slots(plan, ids, first, count)
        prow, pcol = _periodic(plan, ox, oy)
        window = grids[:, prow[:, None], pcol[None, :]]  # modular rows/cols
        rows, ax, cols, ay = _footprints(plan, packed, slots)
        amps = _amps(plan, packed, slots, w_g)
        for q in range(2):
            con = torch.zeros(slots.shape[0])
            for p in range(G):
                cells = window[2 * p + q][rows[:, :, None], cols[:, None, :]]
                col = (ax[:, :, None] * cells).sum(dim=1)  # rows first
                con += (col * ay).sum(dim=1) * amps[p]
            acc[q].index_add_(0, slots, con)
    return acc


def _rel(got, ref):
    ref = torch.tensor(np.asarray(ref), dtype=torch.float64)
    got = torch.tensor(np.asarray(got), dtype=torch.float64)
    return float((got - ref).abs().max() / ref.abs().max())


def _jax_steps(plan, k, degrid):
    if degrid:
        names = ("step_val", "step_aux", "step_aux2", "first_block",
                 "last_blocks")
    else:
        names = ("step_val", "step_aux", "first_block")
    return (*(jnp.asarray(getattr(plan, n)[k, 0]) for n in names),
            jnp.asarray(plan.block_oy),
            jnp.asarray(plan.step_count[k, 0])[None],
            jnp.zeros((1,), jnp.int32))


@pytest.mark.parametrize("R", [1, 2, 3, 8])
def test_tile_chunks_hold_each_active_block_once(problem, R):
    plan = problem["port"]
    for ids in tg.group_active_blocks(plan):
        chunks = tg.tile_chunks(plan, ids, R)
        assert chunks.dtype == np.int32 and chunks.shape[1] == 2
        seen = np.concatenate([np.arange(f, f + c) for f, c in chunks])
        np.testing.assert_array_equal(np.sort(seen), np.arange(len(ids)))
        assert chunks[:, 1].min() >= 1 and chunks[:, 1].max() <= R
        key = plan.block_ox[ids].astype(np.int64) * 10**6 + plan.block_oy[ids]
        for first, count in chunks:
            assert len(set(key[first : first + count])) == 1
        # Runs: a tile's active blocks are consecutive ids of the group.
        runs = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        assert len(runs) == len(np.unique(key))
        work = [plan.block_len[ids[f : f + c]].sum() for f, c in chunks]
        assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("R", [1, 2, 8])
def test_grid_chunks_partition_the_grid(problem, R):
    plan = problem["port"]
    N, W = plan.ngrid, plan.support
    for ids in tg.group_active_blocks(plan):
        chunks = tg.grid_chunks(plan, ids, R)
        assert chunks.dtype == np.int32 and chunks.shape[1] % 2 == 0
        cover = np.zeros((N, N), np.int64)
        key = plan.block_ox[ids].astype(np.int64) * 10**6 + plan.block_oy[ids]
        starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        for row0, nrows, col0, ncols, *src in chunks.tolist():
            cover[row0 : row0 + nrows, col0 : col0 + ncols] += 1
            assert 1 <= nrows <= plan.tile_x
            firsts = [f for f, c in zip(src[::2], src[1::2]) if c > 0]
            if firsts:
                assert ncols <= tcg.grid_piece_cols(plan)
                assert max(nrows, ncols) <= N - W + 1
            assert firsts == sorted(firsts)
            # Every run whose patch reaches the rectangle (a column piece
            # keeps its band's runs, which may miss the piece).
            reach = []
            for i, f in enumerate(starts):
                b = ids[f]
                rows = (plan.block_ox[b] + np.arange(plan.patch_x) - W) % N
                cols = (plan.block_oy[b] + np.arange(plan.patch_y) - W) % N
                if (((rows >= row0) & (rows < row0 + nrows)).any()
                        and ((cols >= col0) & (cols < col0 + ncols)).any()):
                    end = starts[i + 1] if i + 1 < len(starts) else len(ids)
                    reach.append((int(f), int(end - f)))
            got = [(f, c) for f, c in zip(src[::2], src[1::2]) if c > 0]
            assert set(reach) <= set(got)
        assert (cover == 1).all()


@pytest.mark.parametrize("k", [0, 1, 2])
def test_grid_partition_model_matches_plain_and_jax(problem, k):
    plan, port = problem["plan"], problem["port"]
    assert plan.plane_group == 2 and plan.num_groups == 3
    t = torch.from_numpy
    ids, chunks, w_g = _group_inputs(problem, k, tg.grid_chunks)
    packed = t(np.ascontiguousarray(problem["packed4"][:3]))
    re, im = t(problem["re"]), t(problem["im"])
    model = grid_model(port, packed, re, im, ids, chunks, w_g)
    plain = tcg.grid_planes(
        packed, re, im, t(port.block_len), t(port.block_ox),
        t(port.block_oy), t(w_g), t(ids), plan=port,
    )
    data = jnp.asarray(np.concatenate([
        problem["packed4"], problem["re"][None], problem["im"][None],
        np.zeros((2, plan.num_vis), np.float32)]))
    jax_planes = jpg.build_grid_planes_pallas_group(plan, interpret=True)(
        *_jax_steps(plan, k, degrid=False), data, jnp.asarray(w_g))
    for q in range(model.shape[0]):
        assert _rel(model[q], plain[q]) <= RTOL
        assert _rel(model[q], jg._fold_wraps(plan, jax_planes[q])) <= RTOL


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("k", [0, 1, 2])
def test_grid_model_is_bit_equal_in_shuffled_order(problem, k, seed):
    """The chunks and each chunk's owners in a shuffled order give the
    planes of the table's order, bit for bit."""
    port = problem["port"]
    t = torch.from_numpy
    ids, chunks, w_g = _group_inputs(problem, k, tg.grid_chunks)
    packed = t(np.ascontiguousarray(problem["packed4"][:3]))
    re, im = t(problem["re"]), t(problem["im"])
    ordered = grid_model(port, packed, re, im, ids, chunks, w_g)
    shuffled = grid_model(port, packed, re, im, ids, chunks, w_g, seed=seed)
    assert ordered.abs().max() > 0
    assert torch.equal(ordered.view(torch.int32), shuffled.view(torch.int32))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_degrid_partition_model_matches_plain_and_jax(problem, k):
    plan, port = problem["plan"], problem["port"]
    t = torch.from_numpy
    ids, chunks, w_g = _group_inputs(problem, k)
    packed = t(np.ascontiguousarray(problem["packed4"][:3]))
    grids = t(problem["grids"])
    model = degrid_model(port, packed, grids, ids, chunks, w_g)
    plain = tcg.degrid_planes(
        packed, t(port.block_len), t(port.block_ox), t(port.block_oy),
        grids, t(w_g), t(ids), torch.zeros((2, port.num_vis)), plan=port,
    )
    assert _rel(model, plain) <= RTOL
    data = jnp.asarray(np.concatenate(
        [problem["packed4"], np.zeros((4, plan.num_vis), np.float32)]))
    alloc = [jg._unfold_wraps(plan, jnp.asarray(g)) for g in problem["grids"]]
    ref = jpg.build_degrid_planes_pallas_group(plan, interpret=True)(
        *_jax_steps(plan, k, degrid=True), data, alloc, jnp.asarray(w_g))
    assert _rel(model, ref) <= RTOL


def test_plans_cross_the_edge_and_split_the_hot_tile(problem):
    """(d): what each plan is there for."""
    plan = problem["port"]
    N, W = plan.ngrid, plan.support
    uvw, freqs = problem["uvw"], problem["freqs"]
    u = np.abs(np.multiply.outer(uvw[:, 0], freqs / tplan.SPEED_OF_LIGHT))
    v = np.abs(np.multiply.outer(uvw[:, 1], freqs / tplan.SPEED_OF_LIGHT))
    groups = tg.group_active_blocks(plan)
    tables = [tg.tile_chunks(plan, ids, problem["R"]) for ids in groups]
    facts = [_chunk_tiles(plan, ids, c) for ids, c in zip(groups, tables)]
    split = np.concatenate([f[1] for f in facts])
    edge = np.concatenate([f[2] for f in facts])
    if problem["name"] in ("wrap", "edge"):
        assert max(u.max(), v.max()) / plan.du > N / 2 - W
        # Footprint cells in the rows and columns the fold moves.
        x0, y0 = plan.x0[plan.order < plan.num_vis_data], plan.y0[
            plan.order < plan.num_vis_data]
        assert ((x0 < W) | (x0 > N) | (y0 < W) | (y0 > N)).any()
        assert edge.any()
    if problem["name"] == "edge":
        assert (~edge & ~split).any()  # interior tiles, each one chunk
    if problem["name"].startswith("tiny"):
        # Every patch's columns cover the whole period, and the N - W + 1
        # rule cuts B1's rectangles narrower than the shared planes.
        assert N < plan.patch_y
        assert N - W + 1 < tcg.grid_piece_cols(plan)
        for ids in tg.group_active_blocks(plan):
            grid = tg.grid_chunks(plan, ids, problem["R"])
            assert grid[:, 3].max() <= N - W + 1 < N
    if problem["name"] == "split":
        ids, chunks = groups[0], tables[0]
        key = plan.block_ox[ids].astype(np.int64) * 10**6 + plan.block_oy[ids]
        tiles, size = np.unique(key, return_counts=True)
        hot = tiles[np.argmax(size)]
        assert size.max() > problem["R"]
        chunk_key, chunk_split, _ = facts[0]
        mine = chunk_key == hot
        assert mine.sum() > 1 and chunk_split[mine].all()
        # B1 cuts the hot tile's rectangle into column pieces.
        grid = tg.grid_chunks(plan, ids, problem["R"])
        hot_first = int(np.flatnonzero(key == hot)[0])
        pieces = grid[(grid[:, 4::2] == hot_first).any(axis=1)
                      & (grid[:, 5::2] > 0).any(axis=1)]
        assert len(np.unique(pieces[:, 0])) < len(pieces)


def _counted(monkeypatch, name, calls):
    """Count the calls of ``ops/gridder.py``'s ``name`` in ``calls``."""
    real = getattr(tg, name)

    def counted(*args, **kwargs):
        calls[name] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(tg, name, counted)


def _staged_rows(table) -> int:
    """Rows of a staged per-group table before its zero padding."""
    return int((np.asarray(table) != 0).any(axis=1).sum())


def test_work_lists_are_built_once_and_launched_as_staged(problem,
                                                          monkeypatch):
    """Across staging (``slot_plan_host_arrays``), ``build_invert`` and
    ``build_predict`` a plan's active blocks are found once and each
    group's B1 and B3 lists built once; each builder launches, group by
    group, the staged tables' rows and active blocks."""
    plan = tplan.plan_from_fields(dataclasses.asdict(problem["plan"]))
    calls = {"group_active_blocks": 0, "grid_chunks": 0, "tile_chunks": 0}
    for name in calls:
        _counted(monkeypatch, name, calls)
    launched = {"grid": [], "tile": []}
    grid_planes, degrid_planes = tg.grid_planes, tg.degrid_planes

    def grid(*args, chunks, **kwargs):
        launched["grid"].append((int(args[7].shape[0]), int(chunks.shape[0])))
        return grid_planes(*args, chunks=chunks, **kwargs)

    def degrid(*args, chunks, **kwargs):
        launched["tile"].append((int(args[6].shape[0]), int(chunks.shape[0])))
        return degrid_planes(*args, chunks=chunks, **kwargs)

    monkeypatch.setattr(tg, "grid_planes", grid)
    monkeypatch.setattr(tg, "degrid_planes", degrid)
    host = tg.slot_plan_host_arrays(plan, "cpu", invert=True, predict=True)
    arrays = tg.stage_arrays(host, "cpu")
    slots = torch.zeros(plan.num_vis)
    image = tg.build_invert(plan)(arrays, slots, slots)
    tg.build_predict(plan)(arrays, torch.zeros_like(image))
    G = plan.num_groups
    assert calls == {"group_active_blocks": 1, "grid_chunks": G,
                     "tile_chunks": G}
    for key, table in (("grid", "group_grid_chunks"),
                       ("tile", "group_chunks")):
        assert len(launched[key]) == G
        for k, (blocks, rows) in enumerate(launched[key]):
            assert blocks == int((host["group_blocks"][k] >= 0).sum())
            assert rows == _staged_rows(host[table][k]) > 0


@pytest.mark.parametrize("passes", ["invert", "predict"])
def test_staging_holds_only_its_passes_work_lists(passes):
    """The compact (invert-only) staging holds no B3 table and builds no
    B3 list; a predict-only staging holds no B1 table and builds no B1
    list."""
    times, antennas, channels, npix, asec, _ = PLANS["edge"]
    uvw, freqs = _uv(times, antennas, channels)
    pixel = float(np.sin(np.radians(asec / 3600.0)))
    plan = tplan.make_plan(uvw, freqs, npix, pixel)
    if passes == "invert":
        host = tg.compact_plan_host_arrays(plan, uvw, freqs, "cpu")
    else:
        host = tg.slot_plan_host_arrays(plan, "cpu", invert=False)
    assert ("group_grid_chunks" in host) == (passes == "invert")
    assert ("group_chunks" in host) == (passes == "predict")
    built = tg.work_lists(plan)
    assert ("grid" in built) == (passes == "invert")
    assert ("tile" in built) == (passes == "predict")


def _register_reuse_loop(W, B, xpos, ypos, block_len):
    """``ops/gridder.py:register_reuse`` as a plain loop over blocks and
    their real slots."""
    hits = slots = 0
    for b, length in enumerate(block_len):
        start = None
        for s in range(b * B, b * B + int(length)):
            here = (int(np.floor(xpos[s] - W / 2)),
                    int(np.floor(ypos[s] - W / 2)))
            if start is not None:
                hits += ((W - min(W, abs(here[0] - start[0])))
                         * (W - min(W, abs(here[1] - start[1]))))
            start, slots = here, slots + 1
    return hits, W * W * slots


def test_register_reuse_counts_the_owner_cells_that_stay(problem):
    """B1's plan-level register counters against a plain loop, on each
    plan (``wrap``: every tile an edge tile, footprints across the
    periodic edge)."""
    plan = problem["port"]
    packed = torch.from_numpy(np.ascontiguousarray(problem["packed4"][:3]))
    arrays = {"packed": packed, "block_len": torch.from_numpy(
        plan.block_len.astype(np.int32))}
    got = tg.register_reuse(plan, arrays)
    want = _register_reuse_loop(plan.support, plan.block, packed[0].numpy(),
                                packed[1].numpy(), plan.block_len)
    assert got == want
    assert 0 < got[0] < got[1]
    assert tg.register_reuse(plan, {}) == got  # kept on the plan


def test_register_reuse_on_a_block_of_one_slot_and_padding():
    """Hand-made slots: a block whose footprint stays, moves a cell and
    jumps W or more; a block of one slot; a block of two real slots and
    padding whose positions would count if read."""
    W, B = 8, 4
    xpos = [10.2, 10.9, 11.5, 30.0,   5.0, 99.0, 99.0, 99.0,
            20.0, 23.5, 20.0, 20.0]
    ypos = [40.0, 40.3, 47.9, 40.0,   7.0, 7.0, 7.0, 7.0,
            60.0, 61.0, 60.0, 60.0]
    block_len = [4, 1, 2]
    plan = tplan.GridderPlan.__new__(tplan.GridderPlan)
    plan.__dict__.update(support=W, block=B, order=np.zeros(12, np.int32))
    arrays = {"packed": torch.tensor([xpos, ypos, [0.0] * 12]),
              "block_len": torch.tensor(block_len, dtype=torch.int32)}
    # Block 0: (6, 36) -> (6, 36): 64; -> (7, 43): 7 * 1; -> (26, 36): 0.
    # Block 1: nothing. Block 2: (16, 56) -> (19, 57): 5 * 7.
    want = (64 + 7 + 35, W * W * 7)
    assert _register_reuse_loop(W, B, xpos, ypos, block_len) == want
    assert tg.register_reuse(plan, arrays) == want
