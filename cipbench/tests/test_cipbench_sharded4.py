"""The four-card cell ``csd3-10k-4node.sharded4`` (``drivers/sharded_cycle.py``)
on the CPU at a tiny size: correct in a world of two gloo ranks started
by ``ranks.py`` (one shard a rank, as on the four cards), and each fault
not correct and over its own check: one rank's model nudged by a
component (``rank_model_err``, two ranks), and in a world of one process
holding every shard, one shard's image left out of the sums (``psf_err``,
``res_err``), a step that drops its update (``minor_err``) and half a
shard's visibilities left out of the residual (``res_err``,
``last_res_err``). The configuration's geometry is the program's: sigma
2.0, support 6 and a 20480² grid from the global count, where one node's
share alone resolves sigma 1.5; and the work bounds' grid is the plan's."""

from __future__ import annotations

import json
import os
import time

import pytest
import torch

from cipbench import ranks, run, synth, work, work_sharded
from cipbench.drivers.sharded_cycle import channel_chunks

from .conftest import ROOT

CELL = "csd3-10k-4node.sharded4"
CONFIG = ROOT / "cipbench" / "configs" / "csd3-10k-4node.json"
NUDGED = '''
from cipbench.drivers import sharded_cycle as real

UNIT = real.UNIT


def setup(cfg, traffic, seed, device):
    cell = real.setup(cfg, traffic, seed, device)
    if cell.rank == 1:
        check = cell.check

        def nudged(limits, control=False):
            i, j = cell.pixels[1]
            cell.model = cell.model.clone()
            cell.model[i, j] += float(cell.model.abs().max())
            return check(limits, control)

        cell.check = nudged
    return cell
'''


def _checks(line: dict) -> dict:
    return {k: v["value"] for k, v in line["checks"].items()}


def _over(checks: dict, limits: dict) -> set:
    return {k for k, v in checks.items() if v > limits[k]}


@pytest.fixture
def two_ranks(tiny_root, monkeypatch):
    """The tiny checkout with the cell cut to two shards, one a rank."""
    path = tiny_root / "cipbench" / "configs" / "csd3-10k-4node.json"
    cfg = json.loads(path.read_text())
    cfg["sharding"].update(devices=2, freq_chunks=2)
    path.write_text(json.dumps(cfg))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return tiny_root


def _launch(root, capfd) -> dict:
    code = ranks.launch(root, CELL, 2**31 + 23, 0.5, False, 2,
                        t_start=time.perf_counter(), device="cpu",
                        limit_s=120.0)
    out = capfd.readouterr().out
    assert code == 0
    (line,) = out.strip().splitlines()
    return json.loads(line)


def test_two_ranks_are_correct(two_ranks, capfd):
    line = _launch(two_ranks, capfd)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    checks = _checks(line)
    assert set(checks) == {"psf_err", "res_err", "last_res_err",
                           "minor_err", "rank_model_err"}
    assert checks["rank_model_err"] == 0.0
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 0}
    assert set(line["metrics"]) == {"setup_s", "cycle_s"}


def test_a_rank_whose_model_drifts_is_not_correct(two_ranks, capfd):
    here = two_ranks / "cipbench"
    (here / "drivers" / "sharded_nudged.py").write_text(NUDGED)
    traffic = json.loads((here / "traffic" / "sharded4.json").read_text())
    traffic["operation"] = "sharded_nudged"
    (here / "traffic" / "sharded4.json").write_text(json.dumps(traffic))
    line = _launch(two_ranks, capfd)
    assert line["correct"] is False
    assert _checks(line)["rank_model_err"] > 0


def _one_process(root) -> tuple:
    cell = run.load_cell(root, CELL)
    line = run.run_cell(cell, 2**31 + 29, 0.3, False, torch.device("cpu"))
    return line, cell.limits


def test_one_shard_left_out_of_the_sums(tiny_root, monkeypatch):
    from ska_sdp_cip_tpu_torch.ops.gridder import build_invert
    from ska_sdp_cip_tpu_torch.parallel import sharded_clean

    def faulty(staging, re_list, im_list, *, fft_mode):
        total = None
        for plan, arrays, re, im in list(zip(staging.plans, staging.arrays,
                                             re_list, im_list))[:-1]:
            image = build_invert(plan)(arrays, re, im)
            total = image if total is None else total.add_(image)
        return staging.mesh.psum([total])

    monkeypatch.setattr(sharded_clean, "sharded_invert_staged", faulty)
    line, limits = _one_process(tiny_root)
    assert line["correct"] is False
    assert {"psf_err", "res_err"} <= _over(_checks(line), limits)


def test_a_step_that_drops_its_update(tiny_root, monkeypatch):
    import ska_sdp_cip_tpu_torch.models.clean as clean

    real = clean.hogbom_clean

    def minor(dirty, psf, **kw):
        model, res = real(dirty, psf, **kw)
        return torch.zeros_like(model), res

    monkeypatch.setattr(clean, "hogbom_clean", minor)
    line, limits = _one_process(tiny_root)
    assert line["correct"] is False
    assert "minor_err" in _over(_checks(line), limits)


def test_half_a_shard_left_out_of_the_residual(tiny_root, monkeypatch):
    from ska_sdp_cip_tpu_torch.parallel.sharded_clean import ShardedOperator

    real = ShardedOperator.residual

    def residual(self, model):
        weights = self.staging.weights
        full = weights[0]
        half = full.clone()
        half[::2] = 0.0
        weights[0] = half
        try:
            return real(self, model)
        finally:
            weights[0] = full

    monkeypatch.setattr(ShardedOperator, "residual", residual)
    line, limits = _one_process(tiny_root)
    assert line["correct"] is False
    assert {"res_err", "last_res_err"} <= _over(_checks(line), limits)


def test_the_configurations_geometry_is_the_programs():
    from ska_sdp_cip_tpu_torch.ops.plan import nm1_min_of, resolve_sigma
    from ska_sdp_cip_tpu_torch.ops.plan import w_range as program_w_range
    from ska_sdp_cip_tpu_torch.parallel.sharded_invert import (
        shard_chunk_counts,
    )
    from ska_sdp_cip_tpu_torch.utils.chunking import balanced_chunk_bounds

    cfg = json.loads(CONFIG.read_text())
    img, sharding, stated = cfg["imaging"], cfg["sharding"], cfg["geometry"]
    uvw, freqs = synth.observation(cfg)
    assert len(uvw) * len(freqs) == 464_486_400
    assert shard_chunk_counts(sharding["devices"], len(freqs), None,
                              None) == (sharding["row_chunks"],
                                        sharding["freq_chunks"])
    chunks = channel_chunks(len(freqs), sharding["freq_chunks"])
    assert [(c[0], c[-1] + 1) for c in chunks] == list(
        balanced_chunk_bounds(0, len(freqs), sharding["freq_chunks"]))
    npix = img["num_pixels"]
    pix = synth.pixel_size_lm(img["pixel_size_asec"])
    geometries = work_sharded.shard_geometries(
        uvw, freqs, [freqs[c] for c in chunks], npix, pix,
        epsilon=img["epsilon"], sigma=img["sigma"],
        num_visibilities=len(uvw) * len(freqs))
    for g in geometries:
        assert (g.sigma, g.support, g.ngrid) == (
            stated["sigma"], stated["support"], stated["ngrid"])
        assert g.nvis == 116_121_600
    assert [g.nplanes for g in geometries] == stated["planes_per_shard"]
    lo, hi = program_w_range(uvw, freqs)
    assert resolve_sigma(len(uvw) * len(freqs), npix, w_extent=hi - lo,
                         nm1_min=nm1_min_of(npix, pix),
                         epsilon=img["epsilon"]) == stated["sigma"]
    # One node's share alone resolves the node cell's geometry.
    alone = work.geometry(uvw, freqs[chunks[0]], npix, pix,
                          epsilon=img["epsilon"], sigma="auto")
    assert (alone.sigma, alone.support, alone.ngrid) == (1.5, 8, 15360)


def test_the_work_bounds_grid_is_the_plans(tiny_root):
    cell = run.load_cell(tiny_root, CELL)
    from cipbench.drivers import sharded_cycle

    state = sharded_cycle.setup(cell.config, cell.traffic, 5,
                                torch.device("cpu"))
    try:
        geometries = state.geometries
        assert len(geometries) == len(state.plan_geometry) == 4
        for g, (sigma, support, ngrid, _) in zip(geometries,
                                                 state.plan_geometry):
            assert (g.sigma, g.support, g.ngrid) == (sigma, support, ngrid)
        # The plans are padded to the most planes of any shard.
        assert max(g.nplanes for g in geometries) == max(
            p[3] for p in state.plan_geometry)
        assert state.bounds == pytest.approx({
            k: sum(work.cycle_bounds(g)[k] for g in geometries)
            for k in ("fft", "gridding")})
    finally:
        state.release()
        state.close()

