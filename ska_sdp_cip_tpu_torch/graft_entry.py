"""
Entry points of the port for a harness: a single-device forward step and
a multi-device dry run.

Counterpart: ``__graft_entry__.py`` at the root of the repository.
``entry(device)`` returns the flagship path — the invert (visibilities
-> dirty image) — as a callable with example arguments on ``device``.
``dryrun_multichip(n, device)`` runs one full sharded major-cycle step
(predict -> weighted residual -> invert -> sum over the mesh -> Hogbom
update) over a mesh of ``n`` shards on tiny shapes, in both FFT modes,
and holds it against the same step run serially over the same shard
list, at the counterpart's tolerance.
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

#: Sharded step against the serial step (relative to the serial
#: model's max): the counterpart's calibrated tolerance for two float32
#: paths that differ only in the order of the gradient sum.
DRYRUN_RTOL = 5e-5


def _tiny_problem(num_pixels=128, num_times=2, num_antennas=8, nchan=2):
    from .io.synth import synthetic_uvw

    rng = np.random.default_rng(7)
    uvw, _ = synthetic_uvw(num_times, num_antennas, max_baseline_m=2000.0,
                           seed=3)
    freqs = np.linspace(1.0e9, 1.05e9, nchan)
    shape = (len(uvw), nchan)
    vis = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)
    wgt = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    pixel_size_lm = float(np.sin(np.radians(30.0 / 3600)))
    return uvw, freqs, vis, wgt, num_pixels, pixel_size_lm


def entry(device):
    """``(fn, example_args)``: the invert of a tiny problem on
    ``device``; ``fn(*example_args)`` is its (128, 128) dirty image."""
    from .ops.gridder import (
        build_invert,
        resolve_device,
        slot_plan_host_arrays,
        stage_arrays,
        stage_slot_vis,
    )
    from .ops.plan import make_plan

    device = resolve_device(device)
    uvw, freqs, vis, wgt, npix, pixsize = _tiny_problem()
    plan = make_plan(uvw, freqs, npix, pixsize, epsilon=1e-4)
    weighted = (vis * wgt).ravel()
    host = slot_plan_host_arrays(plan, device, predict=False)
    host["re"], host["im"] = stage_slot_vis(plan, weighted.real,
                                            weighted.imag)
    arrays = stage_arrays(host, device)
    re, im = arrays.pop("re"), arrays.pop("im")
    return build_invert(plan), (arrays, re, im)


def _point_psf(npix: int, device) -> torch.Tensor:
    psf = torch.zeros((npix, npix), dtype=torch.float32, device=device)
    psf[npix // 2, npix // 2] = 1.0
    return psf


def _serial_step(staging, model, psf):
    """The major-cycle step over the staged shards one after the other,
    gradients summed in place of the mesh's reduction."""
    from .models.clean import hogbom_clean
    from .ops.gridder import build_invert, build_predict, slot_group_sum

    grad = torch.zeros_like(model)
    for s, plan in enumerate(staging.plans):
        arrays = staging.arrays[s]
        m_re, m_im = build_predict(plan, slot_output=True)(arrays, model)
        m_re, m_im = slot_group_sum(m_re, m_im, staging.dup_a[s],
                                    staging.dup_b[s])
        w = staging.weights[s]
        grad = grad + build_invert(plan)(
            arrays, (m_re - staging.vis_re[s]) * w,
            (m_im - staging.vis_im[s]) * w)
    delta, _ = hogbom_clean(-grad / staging.total_weight, psf, gain=0.3,
                            max_iter=5)
    return model + delta


def dryrun_multichip(n_devices: int, device) -> dict:
    """
    One full sharded major-cycle step over a mesh of ``n_devices``
    shards on ``device`` (the process group's world: one rank unless
    the caller joined a larger one), row x frequency sharded like the
    counterpart's ``data x freq`` mesh, in the replicated and the
    distributed FFT mode, each against the serial step
    (:data:`DRYRUN_RTOL`). Returns each mode's relative error; raises
    AssertionError beyond the tolerance.
    """
    from .io.synth import make_synthetic_dataset
    from .io.visibility_dataset import VisibilityReader
    from .models.clean import hogbom_clean
    from .parallel.mesh import make_device_mesh
    from .parallel.sharded_clean import ShardedOperator
    from .parallel.sharded_invert import stage_sharded_inputs

    mesh = make_device_mesh(n_devices, device=device)
    if n_devices % 2 == 0:
        row_chunks, freq_chunks = n_devices // 2, 2
    else:
        row_chunks, freq_chunks = n_devices, 1
    npix = 64
    with tempfile.TemporaryDirectory() as tmp:
        path = make_synthetic_dataset(f"{tmp}/dryrun.vz", num_times=2,
                                      num_antennas=10, seed=5)
        staging = stage_sharded_inputs(
            VisibilityReader(path), npix, 30.0, mesh=mesh,
            row_chunks=row_chunks, freq_chunks=freq_chunks, epsilon=1e-3,
            common_w_grid=True,
        )
    # A non-zero starting model, so the step runs the whole predict ->
    # residual -> invert chain.
    model0 = torch.zeros((npix, npix), dtype=torch.float32,
                         device=mesh.device)
    model0[npix // 2 + 3, npix // 2 - 2] = 1.0
    model0[npix // 2 - 5, npix // 2 + 4] = 0.5
    psf = _point_psf(npix, mesh.device)
    serial = _serial_step(staging, model0, psf)
    scale = float(serial.abs().max())
    errors = {}
    for fft_mode in ("replicated", "distributed"):
        residual = ShardedOperator(staging, fft_mode).residual(model0)
        delta, _ = hogbom_clean(residual, psf, gain=0.3, max_iter=5)
        model1 = model0 + delta
        if not bool(torch.isfinite(model1).all()):
            raise AssertionError(f"{fft_mode}: non-finite model")
        errors[fft_mode] = float((model1 - serial).abs().max()) / scale
    print(f"dryrun_multichip: {n_devices} shards ({row_chunks} x "
          f"{freq_chunks}) on {mesh.device}, {mesh.world_size} rank(s), "
          f"sharded-vs-serial max_rel={errors} (tol {DRYRUN_RTOL:g})")
    bad = {k: v for k, v in errors.items()
           if not (np.isfinite(v) and v < DRYRUN_RTOL)}
    if bad:
        raise AssertionError(f"sharded step != serial step: {bad} exceeds "
                             f"tolerance {DRYRUN_RTOL:g}")
    print("dryrun_multichip OK")
    return errors
