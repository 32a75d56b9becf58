"""
The torch port's gridding (the plain version of kernel B1) and device
prologue against the JAX package's.

* ``grid_planes`` on CPU tensors (its folded plain version) must
  reproduce the Pallas strip kernels in interpret mode followed by the
  JAX package's own ``_fold_wraps``, plane by plane, to 1e-5 of each
  plane's max: the group kernel (G = 2) and the single-plane kernel
  (G = 1); the w-stacked G = 1 case is held as its test says. The JAX
  side contracts in bf16x3, the port in float32.
* ``build_assemble`` must rebuild the JAX prologue's |w| row and
  slot-order visibilities (same double-float arithmetic in float32),
  and the host planner's positions, which the JAX prologue rounds at
  grid scale (ROADMAP.md C1).
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

PLANE_RTOL = 1e-5
PIXEL = float(np.sin(np.radians(40.0 / 3600)))
#: Prologue positions against the float64 planner's, in cells: one
#: float32 rounding at patch scale (x < 48, y < 128 cells) is at most
#: 7.6e-6.
C1_CELLS = 1e-5
#: ... and against the host-staged rows (``pack_plan_columns``), which
#: round once at patch scale themselves: one float32 ulp at 128 cells.
HOST_ROWS_CELLS = 2.0 ** -16


def _planner_positions(plan, uvw, freqs):
    """
    Float64 patch-relative (x, y) of the data slots, computed as the
    planner computes them (``ops/plan.py:make_plan``), and the mask of
    data slots.
    """
    scale = np.asarray(freqs, np.float64) / tplan.SPEED_OF_LIGHT
    u, v, w = (np.multiply.outer(uvw[:, i], scale).ravel() for i in range(3))
    sign = np.where(w < 0, -1.0, 1.0)
    half = plan.ngrid / 2.0
    x = np.mod(sign * u / plan.du + half, plan.ngrid) + plan.support
    y = np.mod(sign * v / plan.du + half, plan.ngrid) + plan.support
    data = plan.order < plan.num_vis_data
    blk = (np.arange(plan.num_vis) // plan.block)[data]
    src = plan.order[data]
    return data, np.stack(
        [x[src] - plan.block_ox[blk], y[src] - plan.block_oy[blk]]
    )


def _problem(do_wstacking, seed=23):
    uvw, _ = synthetic_uvw(3, 10, max_baseline_m=5000.0, seed=seed)
    freqs = np.array([1.0e9, 1.07e9])
    plan = jplan.make_plan(uvw, freqs, 96, PIXEL, do_wstacking=do_wstacking)
    assert plan.num_y_segments == 1
    rng = np.random.default_rng(seed)
    re = rng.normal(size=plan.num_vis).astype(np.float32)
    im = rng.normal(size=plan.num_vis).astype(np.float32)
    pad = plan.order >= plan.num_vis_data
    re[pad] = 0.0
    im[pad] = 0.0
    packed4 = jpg.pack_plan_columns(plan)
    data = jnp.asarray(
        np.concatenate(
            [packed4, re[None], im[None], np.zeros((2, plan.num_vis),
                                                   np.float32)]
        )
    )
    port_plan = tplan.plan_from_fields(dataclasses.asdict(plan))
    return plan, port_plan, packed4, re, im, data


def _port_group(port_plan, packed4, re, im, w_g, k):
    t = torch.from_numpy
    return tcg.grid_planes(
        t(np.ascontiguousarray(packed4[:3])),
        t(re),
        t(im),
        t(port_plan.block_len),
        t(port_plan.block_ox),
        t(port_plan.block_oy),
        t(np.asarray(w_g, np.float32).reshape(-1)),
        t(tg.group_active_blocks(port_plan)[k]),
        plan=port_plan,
    ).numpy()


def _step_args(plan, k):
    return (
        jnp.asarray(plan.step_val[k, 0]),
        jnp.asarray(plan.step_aux[k, 0]),
        jnp.asarray(plan.first_block[k, 0]),
        jnp.asarray(plan.block_oy),
        jnp.asarray(plan.step_count[k, 0])[None],
        jnp.zeros((1,), jnp.int32),
    )


def _folded(plan, planes):
    """The JAX package's fold of each alloc-frame plane."""
    return [np.asarray(jg._fold_wraps(plan, jnp.asarray(p))) for p in planes]


def _assert_planes_close(ours, ref_planes, rtol=PLANE_RTOL):
    assert ours.shape[0] == len(ref_planes)
    for p, ref in enumerate(ref_planes):
        ref = np.asarray(ref)
        assert ours[p].shape == ref.shape
        scale = np.abs(ref).max()
        assert scale > 0
        err = np.abs(ours[p] - ref).max() / scale
        assert err <= rtol, (p, err)


def test_pack_plan_columns_matches_jax():
    plan, port_plan, packed4, *_ = _problem(True)
    np.testing.assert_array_equal(tcg.pack_plan_columns(port_plan), packed4)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_group_reference_matches_pallas_group_kernel(k):
    plan, port_plan, packed4, re, im, data = _problem(True)
    assert plan.plane_group == 2 and plan.num_groups == 3
    w_g = jg.plan_host_arrays(plan)["plane_wg"][k]
    grid_group = jpg.build_grid_planes_pallas_group(plan, interpret=True)
    ref = grid_group(*_step_args(plan, k), data, jnp.asarray(w_g))
    ours = _port_group(port_plan, packed4, re, im, w_g, k)
    _assert_planes_close(ours, _folded(plan, ref))


def test_single_plane_reference_matches_pallas_kernel():
    plan, port_plan, packed4, re, im, data = _problem(False)
    assert plan.plane_group == 1 and plan.nplanes == 1
    grid_plane = jpg.build_grid_planes_pallas(plan, interpret=True)
    ref = grid_plane(*_step_args(plan, 0), data, jnp.asarray(plan.plane_w[0]))
    ours = _port_group(port_plan, packed4, re, im, plan.plane_w[:1], 0)
    _assert_planes_close(ours, _folded(plan, ref))


def test_single_plane_wstacked_matches_pallas_kernel(monkeypatch):
    """
    G = 1 with w-stacking on (the per-plane ES w factor path; off the
    main path, where w-stacking always groups planes in pairs). Here
    the Pallas kernel's own bf16x3 error reaches 1.1e-5 of the plane
    max against a float64 evaluation, so the port is held to that
    float64 evaluation at 1e-5 and to the Pallas kernel at 2e-5 (the
    reference's own Pallas-vs-XLA gap of 1.03e-5, doubled).
    """
    monkeypatch.setenv("CIP_PLANE_GROUP", "1")
    plan, port_plan, packed4, re, im, data = _problem(True, seed=29)
    assert plan.plane_group == 1 and plan.wstacking
    grid_plane = jpg.build_grid_planes_pallas(plan, interpret=True)
    t = torch.from_numpy
    for p in (1, plan.nplanes // 2):
        ref = grid_plane(
            *_step_args(plan, p), data, jnp.asarray(plan.plane_w[p])
        )
        ours = _port_group(port_plan, packed4, re, im, plan.plane_w[p:p + 1],
                           p)
        _assert_planes_close(ours, _folded(plan, ref), rtol=2 * 1.03e-5)
        exact = tcg.grid_planes_folded_reference(
            t(packed4[:3].astype(np.float64)),
            t(re.astype(np.float64)),
            t(im.astype(np.float64)),
            t(port_plan.block_len),
            t(port_plan.block_ox),
            t(port_plan.block_oy),
            t(plan.plane_w[p:p + 1].astype(np.float64)),
            t(tg.group_active_blocks(port_plan)[p]),
            plan=port_plan,
        ).numpy()
        _assert_planes_close(ours, list(exact))


@pytest.fixture(scope="module")
def assembled_inputs():
    uvw, _ = synthetic_uvw(4, 24, max_baseline_m=6000.0, seed=11)
    return uvw, np.linspace(1.40e9, 1.46e9, 5)


@pytest.fixture(scope="module")
def assembled(assembled_inputs):
    uvw, freqs = assembled_inputs
    pixel = float(np.sin(np.radians(8.0 / 3600.0)))
    plan = jplan.make_plan(uvw, freqs, 512, pixel, export_packed=False)
    port_plan = tplan.make_plan(uvw, freqs, 512, pixel, export_packed=False)
    rng = np.random.default_rng(5)
    shape = (len(uvw), len(freqs))
    weighted = (
        (rng.normal(size=shape) + 1j * rng.normal(size=shape))
        * rng.uniform(0.5, 2.0, size=shape)
    ).astype(np.complex64).ravel()
    jax_host = jg.compact_plan_host_arrays(plan, uvw, freqs)
    jax_out = jg.build_assemble(plan)(
        {k: jnp.asarray(v) for k, v in jax_host.items()},
        jnp.asarray(weighted.real),
        jnp.asarray(weighted.imag),
    )
    host = tg.compact_plan_host_arrays(port_plan, uvw, freqs, "cpu")
    ours = tg.build_assemble(port_plan)(
        tg.stage_arrays(host, "cpu"),
        torch.from_numpy(np.ascontiguousarray(weighted.real)),
        torch.from_numpy(np.ascontiguousarray(weighted.imag)),
    )
    return port_plan, jax_host, host, jax_out, ours


def test_host_arrays_carry_only_the_cpu_pass_factors():
    """On the CPU the plain DFT passes run (invert and predict): no
    fused-kernel factors."""
    uvw, _ = synthetic_uvw(3, 10, max_baseline_m=5000.0, seed=23)
    freqs = np.array([1.0e9, 1.07e9])
    port_plan = tplan.make_plan(uvw, freqs, 96, PIXEL, export_packed=False)
    host = tg.plan_host_arrays(port_plan, "cpu", predict=True)
    assert "fft_d1_cos" in host
    assert not [k for k in host if k.startswith(("fftp_", "fftq_"))]


def test_compact_host_arrays_match_jax(assembled):
    _, jax_host, host, _, _ = assembled
    for key in ("oe_first", "oe_delta", "oe_exc_pos", "oe_exc_val",
                "uvw_hi", "uvw_lo", "scale_hi", "scale_lo", "cblock_ox",
                "block_oy", "quad_nodes", "quad_folded", "plane_wg"):
        np.testing.assert_array_equal(host[key], jax_host[key], err_msg=key)


def test_assemble_matches_jax(assembled, assembled_inputs):
    """
    Positions are held to the host-staged rows (``pack_plan_columns``
    of the float64 planner), not to the JAX prologue, which rounds them
    at grid scale (ROADMAP.md C1); |w| and the slot visibilities are
    held to the JAX prologue.
    """
    plan, _, _, (jax_arrays, jre, jim), ours = assembled
    arrays, re_s, im_s = ours
    packed = arrays["packed"].numpy()
    jax_packed = np.asarray(jax_arrays["packed"])
    assert packed.shape == jax_packed.shape == (3, plan.num_vis)
    # Padding slots carry different fillers on the two sides; the
    # kernels mask them by block length.
    data, truth = _planner_positions(plan, *assembled_inputs)
    np.testing.assert_allclose(packed[:2, data], truth, rtol=0, atol=C1_CELLS)
    host_rows = tcg.pack_plan_columns(plan)[:2, data]
    np.testing.assert_allclose(
        packed[:2, data], host_rows, rtol=0, atol=HOST_ROWS_CELLS
    )
    ws_scale = max(np.abs(jax_packed[2]).max(), 1.0)
    np.testing.assert_allclose(
        packed[2], jax_packed[2], rtol=0, atol=1e-6 * ws_scale
    )
    # Slot visibilities: pre-phase trig in float32 on both sides.
    scale = max(np.abs(np.asarray(jre)).max(), np.abs(np.asarray(jim)).max())
    for got, ref in ((re_s, jre), (im_s, jim)):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ref), rtol=0, atol=1e-5 * scale
        )


def test_assemble_positions_hold_at_the_bench_grid():
    """
    ROADMAP.md C1: at ngrid 4096 (2048 px at 5 asec, the bench
    geometry) the prologue's patch-relative positions stay within
    ``C1_CELLS`` of the host-staged rows. Collapsing ``xh + xl`` at grid
    scale first, as the JAX prologue does, misses by up to one float32
    ulp of 4096 (2.4e-4 cells). Held against the float64 planner's
    positions and against the host-staged rows. Only the prologue runs.
    """
    uvw, _ = synthetic_uvw(2, 40, max_baseline_m=7700.0, seed=42)
    freqs = np.linspace(1.40e9, 1.507e9, 4)
    pixel = float(np.sin(np.radians(5.0 / 3600.0)))
    plan = tplan.make_plan(uvw, freqs, 2048, pixel, export_packed=False)
    assert plan.ngrid == 4096 and plan.num_vis_data == len(uvw) * 4
    host = tg.compact_plan_host_arrays(plan, uvw, freqs, "cpu")
    zeros = torch.zeros(plan.num_vis_data, dtype=torch.float32)
    arrays, _, _ = tg.build_assemble(plan)(
        tg.stage_arrays(host, "cpu"), zeros, zeros.clone()
    )
    data, truth = _planner_positions(plan, uvw, freqs)
    packed = arrays["packed"][:2].numpy()[:, data]
    err = np.abs(packed - truth).max()
    assert err <= C1_CELLS, err
    host_rows = tcg.pack_plan_columns(plan)[:2, data]
    assert np.abs(packed - host_rows).max() <= HOST_ROWS_CELLS
