"""
The torch port's degridding (the folded plain version of kernel B3,
which is B5 at G = 1) against the JAX package's Pallas degrid kernels in
interpret mode, on one plan (``plan_from_fields``) and the same random
periodic planes, unfolded for the JAX kernels by the JAX package's own
``_unfold_wraps``: slot contributions to 1e-5 of the max, for the group
kernel (G = 2, every group) and the single-plane kernel (G = 1,
w-stacking off and on). The JAX side contracts in bf16x3, the port in
float32; the float64 run of the plain version is held to the same
tolerance.
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

torch.set_num_threads(1)

RTOL = 1e-5
PIXEL = float(np.sin(np.radians(40.0 / 3600)))


def _problem(do_wstacking, seed=23):
    uvw, _ = synthetic_uvw(3, 10, max_baseline_m=5000.0, seed=seed)
    freqs = np.array([1.0e9, 1.07e9])
    plan = jplan.make_plan(uvw, freqs, 96, PIXEL, do_wstacking=do_wstacking)
    assert plan.num_y_segments == 1
    packed4 = jpg.pack_plan_columns(plan)
    data = jnp.asarray(
        np.concatenate([packed4, np.zeros((4, plan.num_vis), np.float32)])
    )
    port_plan = tplan.plan_from_fields(dataclasses.asdict(plan))
    rng = np.random.default_rng(seed)
    grids = rng.normal(
        size=(2 * plan.plane_group, plan.ngrid, plan.ngrid)
    ).astype(np.float32)
    return plan, port_plan, packed4, data, grids


def _unfolded(plan, grids):
    """The JAX package's alloc frame of each periodic plane."""
    return [jg._unfold_wraps(plan, jnp.asarray(g)) for g in grids]


def _step_args(plan, k):
    return (
        jnp.asarray(plan.step_val[k, 0]),
        jnp.asarray(plan.step_aux[k, 0]),
        jnp.asarray(plan.step_aux2[k, 0]),
        jnp.asarray(plan.first_block[k, 0]),
        jnp.asarray(plan.last_blocks[k, 0]),
        jnp.asarray(plan.block_oy),
        jnp.asarray(plan.step_count[k, 0])[None],
        jnp.zeros((1,), jnp.int32),
    )


def _port(port_plan, packed4, grids, w_g, k, dtype=torch.float32,
          reference=False):
    t = torch.from_numpy
    args = (
        t(np.ascontiguousarray(packed4[:3])).to(dtype),
        t(port_plan.block_len),
        t(port_plan.block_ox),
        t(port_plan.block_oy),
        t(grids).to(dtype),
        t(np.asarray(w_g, np.float32).reshape(-1)).to(dtype),
        t(tg.group_active_blocks(port_plan)[k]),
        torch.zeros((2, port_plan.num_vis), dtype=dtype),
    )
    fn = tcg.degrid_planes_folded_reference if reference else tcg.degrid_planes
    return fn(*args, plan=port_plan).numpy()


def _assert_close(ours, ref, rtol=RTOL):
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(ours - ref).max() / scale
    assert err <= rtol, err


@pytest.mark.parametrize("k", [0, 1, 2])
def test_group_reference_matches_pallas_group_kernel(k):
    plan, port_plan, packed4, data, grids = _problem(True)
    assert plan.plane_group == 2 and plan.num_groups == 3
    w_g = jg.plan_host_arrays(plan)["plane_wg"][k]
    degrid_group = jpg.build_degrid_planes_pallas_group(plan, interpret=True)
    ref = degrid_group(
        *_step_args(plan, k), data, _unfolded(plan, grids), jnp.asarray(w_g),
    )
    before = tcg.DEGRID_LAUNCHES
    ours = _port(port_plan, packed4, grids, w_g, k)
    assert tcg.DEGRID_LAUNCHES == before  # CPU tensors: the plain version
    _assert_close(ours, ref)
    exact = _port(port_plan, packed4, grids.astype(np.float64), w_g, k,
                  dtype=torch.float64, reference=True)
    _assert_close(ours, exact)


def test_single_plane_reference_matches_pallas_kernel():
    plan, port_plan, packed4, data, grids = _problem(False)
    assert plan.plane_group == 1 and plan.nplanes == 1
    degrid_plane = jpg.build_degrid_planes_pallas(plan, interpret=True)
    ref = degrid_plane(
        *_step_args(plan, 0), data, *_unfolded(plan, grids),
        jnp.asarray(plan.plane_w[0]),
    )
    ours = _port(port_plan, packed4, grids, plan.plane_w[:1], 0)
    _assert_close(ours, ref)


def test_single_plane_wstacked_matches_pallas_kernel(monkeypatch):
    """
    G = 1 with w-stacking on (B5 with the per-plane ES w factor; off
    the main path, where w-stacking groups planes in pairs), against
    the Pallas kernel and the float64 plain version.
    """
    monkeypatch.setenv("CIP_PLANE_GROUP", "1")
    plan, port_plan, packed4, data, grids = _problem(True, seed=29)
    assert plan.plane_group == 1 and plan.wstacking
    degrid_plane = jpg.build_degrid_planes_pallas(plan, interpret=True)
    alloc = _unfolded(plan, grids)
    for p in (1, plan.nplanes // 2):
        ref = degrid_plane(
            *_step_args(plan, p), data, *alloc, jnp.asarray(plan.plane_w[p]),
        )
        w_p = plan.plane_w[p : p + 1]
        ours = _port(port_plan, packed4, grids, w_p, p)
        _assert_close(ours, ref)
        exact = _port(port_plan, packed4, grids.astype(np.float64), w_p, p,
                      dtype=torch.float64, reference=True)
        _assert_close(ours, exact)


def test_degrid_adds_into_the_accumulator():
    """Calls accumulate (the predict loop sums its plane groups)."""
    _, port_plan, packed4, _, grids = _problem(True)
    t = torch.from_numpy
    w_g = t(np.asarray(tg.plan_host_arrays(port_plan, "cpu")["plane_wg"][1]))
    args = (
        t(np.ascontiguousarray(packed4[:3])), t(port_plan.block_len),
        t(port_plan.block_ox), t(port_plan.block_oy), t(grids), w_g,
        t(tg.group_active_blocks(port_plan)[1]),
    )
    once = tcg.degrid_planes(
        *args, torch.zeros((2, port_plan.num_vis)), plan=port_plan
    )
    acc = torch.ones((2, port_plan.num_vis))
    twice = tcg.degrid_planes(*args, acc, plan=port_plan)
    assert twice is acc
    torch.testing.assert_close(twice, once + 1.0, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="grids"):
        tcg.degrid_planes(*args[:4], t(grids[:2]), *args[5:],
                          torch.zeros((2, port_plan.num_vis)), plan=port_plan)
