"""
The schedule of kernels B1 (``csrc/grid.cu``) and B3 (``csrc/degrid.cu``)
held on the CPU, where no CUDA kernel runs.

* (a) The work list (``ops/gridder.py:tile_chunks``): every active block
  of a plane group in exactly one chunk, one patch origin per chunk,
  consecutive blocks, at most R a chunk; the split flag on every chunk
  of a tile that has more than one, and the edge flag on exactly the
  tiles whose patch holds an alloc row or column in [0, 2W) or
  [N, N + 2W).
* (b) A torch model of B1's partition: per chunk, each visibility's
  candidate footprint (the kernel's window: the W cells after
  floor(pos - W/2), clipped to the patch) is added into the chunk's
  patch, which is then flushed onto the periodic grid at row
  (ox + r - W) mod N and column (oy + c - W) mod N, rows
  [patch_x - tile_x, tile_x) of unsplit interior tiles as stores and
  the rest as additions. The model checks that no cell it stores is
  written by any other chunk, and is held against
  ``_fold_wraps o grid_planes_reference`` and against the JAX group
  kernel in interpret mode folded by the JAX package's ``_fold_wraps``,
  at 1e-5 of each plane's max.
* (c) The same for B3: each chunk's windows read from the periodic grid
  with modular addressing, rows summed first, then columns, then the
  planes, held against ``degrid_planes_reference`` of the unfolded
  planes and the JAX group kernel on the JAX package's
  ``_unfold_wraps``.
* (d) The plans: one whose footprints cross the periodic edge (the
  96 px plan at 40 asec, where |u|/du exceeds N/2 - W and every tile is
  an edge tile, and a 256 px plan at 20 asec, with edge and interior
  tiles), and one whose hot tile is split into
  several chunks (R = 2).
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
#: with two blocks a chunk, so the hot tiles are split.
PLANS = {
    "wrap": (3, 10, 2, 96, 40.0, 1),
    "edge": (4, 16, 3, 256, 20.0, 8),
    "split": (4, 16, 3, 256, 12.0, 2),
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


def _group_inputs(p, k):
    plan = p["port"]
    ids = tg.group_active_blocks(plan)[k]
    w_g = tg.plan_host_arrays(plan, "cpu")["plane_wg"][k]
    return ids, tg.tile_chunks(plan, ids, p["R"]), w_g


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


def grid_model(plan, packed, re, im, ids, chunks, w_g):
    """B1's partition on the periodic grid (see the module docstring);
    raises if a stored row is written by another chunk."""
    N, G = plan.ngrid, len(w_g)
    PX, PY = plan.patch_x, plan.patch_y
    out = torch.zeros((2 * G, N * N))
    stored = torch.zeros(N * N, dtype=torch.int64)
    added = torch.zeros(N * N, dtype=torch.int64)
    exclusive = torch.zeros(PX, dtype=torch.bool)
    exclusive[PX - plan.tile_x : plan.tile_x] = True
    for first, count, flags in chunks.tolist():
        slots, ox, oy = _chunk_slots(plan, ids, first, count)
        assert all(plan.block_ox[b] == ox and plan.block_oy[b] == oy
                   for b in ids[first : first + count])
        rows, ax, cols, ay = _footprints(plan, packed, slots)
        cell = (rows[:, :, None] * PY + cols[:, None, :]).reshape(-1)
        patch = torch.zeros((2 * G, PX * PY))
        for p, amp in enumerate(_amps(plan, packed, slots, w_g)):
            for q, vis in enumerate((re[slots], im[slots])):
                # ax * (vis * amp) first, then * ay: the kernel's order.
                val = (ax * (vis * amp)[:, None])[:, :, None] * ay[:, None, :]
                patch[2 * p + q].index_add_(0, cell, val.reshape(-1))
        prow, pcol = _periodic(plan, ox, oy)
        target = (prow[:, None] * N + pcol[None, :]).reshape(-1)
        store = (exclusive[:, None].expand(PX, PY).reshape(-1)
                 if flags == 0 else torch.zeros(PX * PY, dtype=torch.bool))
        out[:, target[store]] = patch[:, store]
        stored[target[store]] += 1
        add = ~store
        out.index_add_(1, target[add], patch[:, add])
        nonzero = (patch[:, add] != 0).any(dim=0)
        added[target[add][nonzero]] += 1
    owned = stored > 0
    assert int(stored.max()) <= 1 and not bool((added[owned] > 0).any())
    return out.reshape(2 * G, N, N)


def degrid_model(plan, packed, grids, ids, chunks, w_g):
    """B3's schedule: (2, num_vis) slot contributions of one group."""
    N, G = plan.ngrid, len(w_g)
    acc = torch.zeros((2, plan.num_vis))
    for first, count, _ in chunks.tolist():
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
        assert chunks.dtype == np.int32 and chunks.shape[1] == 3
        seen = np.concatenate([np.arange(f, f + c) for f, c, _ in chunks])
        np.testing.assert_array_equal(np.sort(seen), np.arange(len(ids)))
        assert chunks[:, 1].min() >= 1 and chunks[:, 1].max() <= R
        key = plan.block_ox[ids].astype(np.int64) * 10**6 + plan.block_oy[ids]
        for first, count, flags in chunks:
            assert len(set(key[first : first + count])) == 1
            same_tile = int((key[chunks[:, 0]] == key[first]).sum())
            assert bool(flags & tg.CHUNK_SPLIT) == (same_tile > 1)
        # Runs: a tile's active blocks are consecutive ids of the group.
        runs = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
        assert len(runs) == len(np.unique(key))
        work = [plan.block_len[ids[f : f + c]].sum() for f, c, _ in chunks]
        assert work == sorted(work, reverse=True)


def test_edge_flag_follows_the_wrap_rule(problem):
    plan = problem["port"]
    N, W = plan.ngrid, plan.support
    moved = set(range(2 * W)) | set(range(N, N + 2 * W))
    for ids in tg.group_active_blocks(plan):
        for first, _, flags in tg.tile_chunks(plan, ids, problem["R"]):
            b = ids[first]
            ox, oy = int(plan.block_ox[b]), int(plan.block_oy[b])
            edge = bool(moved & set(range(ox, ox + plan.patch_x))) or bool(
                moved & set(range(oy, oy + plan.patch_y)))
            assert bool(flags & tg.CHUNK_EDGE) == edge


@pytest.mark.parametrize("k", [0, 1, 2])
def test_grid_partition_model_matches_plain_and_jax(problem, k):
    plan, port = problem["plan"], problem["port"]
    assert plan.plane_group == 2 and plan.num_groups == 3
    t = torch.from_numpy
    ids, chunks, w_g = _group_inputs(problem, k)
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
    tables = [tg.tile_chunks(plan, ids, problem["R"])
              for ids in tg.group_active_blocks(plan)]
    flags = np.concatenate([c[:, 2] for c in tables])
    if problem["name"] in ("wrap", "edge"):
        assert max(u.max(), v.max()) / plan.du > N / 2 - W
        # Footprint cells in the rows and columns the fold moves.
        x0, y0 = plan.x0[plan.order < plan.num_vis_data], plan.y0[
            plan.order < plan.num_vis_data]
        assert ((x0 < W) | (x0 > N) | (y0 < W) | (y0 > N)).any()
        assert (flags & tg.CHUNK_EDGE).any()
    if problem["name"] == "edge":
        assert (flags == 0).any()  # interior tiles take plain stores
    if problem["name"] == "split":
        ids, chunks = tg.group_active_blocks(plan)[0], tables[0]
        key = plan.block_ox[ids].astype(np.int64) * 10**6 + plan.block_oy[ids]
        tiles, size = np.unique(key, return_counts=True)
        hot = tiles[np.argmax(size)]
        assert size.max() > problem["R"]
        mine = chunks[key[chunks[:, 0]] == hot]
        assert len(mine) > 1 and (mine[:, 2] & tg.CHUNK_SPLIT).all()
