#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (``ska_sdp_cip_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``ska_sdp_cip_tpu_torch/csrc`` with nvcc
(into ``build/torch_kernels/``), then runs five phases and prints one
JSON object per phase:

1. ``device``: card name, ``nvidia-smi`` name and power limit, build time;
2. ``b1``: the gridding kernel against its plain version, on small
   plans (G = 1 and G = 2) and on one bench-size plane group (G = 2);
   then the whole bench-size image of the noise-like bench visibilities
   against a float64 DFT at 256 random pixels (``bench_dft``: a reading
   against the 1e-4 contract, gated only at 10x it);
3. ``b2``: the fused first-axis DFT kernel against its plain version at
   the bench transform (4096 rows -> 2048-row crop, m = 4096 and 2048);
4. ``e2e_small``: ``dirty_image`` on the card against the explicit DFT
   (``dirty_image_dft``) on a 256 px check plan;
5. ``slice``: ``invert_dataset(VisibilityReader(obs), 2048, 5.0,
   device="cuda")`` on a 5,836,800-visibility synthetic dataset, with
   the kernels' launch counts, the brightest source's peak position, a
   float64 DFT spot check of 448 pixels, the median wall time of 3 runs
   after a warm run, a per-stage breakdown and a profile of one call.

Then a ``kernels`` JSON line, the ``nvidia-smi`` line, and as the last
line ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
without that line; so does a machine without a CUDA card, and a
directory without the package. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

#: Tolerances (relative to the reference's max magnitude).
KERNEL_RTOL = 1e-5  # kernel vs its plain version, both float32 on the card
DFT_RTOL = 1e-4  # gridder vs explicit DFT: the epsilon=1e-4 contract

#: The bench workload (bench.py of the JAX package): 20 times x 4560
#: baselines x 64 channels = 5,836,800 visibilities, 2048 px at 5 asec.
BENCH_TIMES, BENCH_ANTENNAS, BENCH_CHANNELS = 20, 96, 64
BENCH_FREQS = (1.40e9, 1.507e9)
BENCH_NPIX, BENCH_ASEC = 2048, 5.0


class PhaseError(RuntimeError):
    """A phase's check failed."""


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def rel_err(got, ref) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|) of two tensors/arrays."""
    import torch

    got = torch.as_tensor(got, dtype=torch.float64)
    ref = torch.as_tensor(ref, dtype=torch.float64)
    err = float((got.cpu() - ref.cpu()).abs().max())
    scale = float(ref.abs().max())
    return err, err / scale if scale else err


def cuda_ms(fn, *, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def bench_visibilities(num_times, num_antennas, num_channels):
    """bench.py's workload: uvw, freqs, random vis and weights."""
    from ska_sdp_cip_tpu_torch.io.synth import synthetic_uvw

    rng = np.random.default_rng(2024)
    uvw, _ = synthetic_uvw(
        num_times, num_antennas, max_baseline_m=7700.0, seed=42
    )
    freqs = np.linspace(*BENCH_FREQS, num_channels)
    shape = (len(uvw), num_channels)
    vis = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64
    )
    wgt = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    return uvw, freqs, vis, wgt


def staged_problem(uvw, freqs, vis, wgt, npix, asec, device, **plan_kw):
    """Plan + device arrays + slot visibilities, as dirty_image builds them."""
    from ska_sdp_cip_tpu_torch.ops.gridder import stage_compact
    from ska_sdp_cip_tpu_torch.ops.plan import make_plan

    pix = float(np.sin(np.radians(asec / 3600.0)))
    plan = make_plan(uvw, freqs, npix, pix, export_packed=False, **plan_kw)
    return (plan, *stage_compact(plan, uvw, freqs, vis * wgt, device))


def group_args(plan, arrays, re_s, im_s, k):
    from ska_sdp_cip_tpu_torch.ops.gridder import group_active_blocks

    count = len(group_active_blocks(plan)[k])
    return (
        arrays["packed"],
        re_s,
        im_s,
        arrays["block_len"],
        arrays["cblock_ox"],
        arrays["block_oy"],
        arrays["plane_wg"][k],
        arrays["group_blocks"][k, :count],
    )


def compare_group(plan, args, *, time_it: bool, iters: int = 3) -> dict:
    """B1 kernel vs plain version on one plane group, plane by plane."""
    from ska_sdp_cip_tpu_torch.ops import cuda_gridder as cg

    got = cg.grid_planes(*args, plan=plan)
    ref = cg.grid_planes_reference(*args, plan=plan)
    worst_rel, worst_abs = 0.0, 0.0
    for p in range(ref.shape[0]):
        err, rel = rel_err(got[p], ref[p])
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    out = {
        "G": int(args[6].shape[0]),
        "active_blocks": int(args[7].shape[0]),
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
    }
    if time_it and args[0].device.type == "cuda":
        out["ms"] = cuda_ms(lambda: cg.grid_planes(*args, plan=plan),
                            iters=iters)
        out["plain_ms"] = cuda_ms(
            lambda: cg.grid_planes_reference(*args, plan=plan), iters=iters
        )
    if not worst_rel <= KERNEL_RTOL:
        raise PhaseError(f"B1 vs plain {worst_rel:.3e} > {KERNEL_RTOL}")
    return out


def phase_b1(device, bench=(BENCH_TIMES, BENCH_ANTENNAS, BENCH_CHANNELS),
             bench_npix=BENCH_NPIX) -> dict:
    from ska_sdp_cip_tpu_torch.io.synth import synthetic_uvw

    results = {"phase": "b1", "cases": []}
    rng = np.random.default_rng(17)
    uvw, _ = synthetic_uvw(3, 10, max_baseline_m=5000.0, seed=23)
    freqs = np.array([1.0e9, 1.07e9])
    shape = (len(uvw), 2)
    vis = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64
    )
    wgt = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    for wstack in (False, True):
        plan, arrays, re_s, im_s = staged_problem(
            uvw, freqs, vis, wgt, 96, 40.0, device, do_wstacking=wstack
        )
        for k in range(plan.num_groups):
            case = compare_group(
                plan, group_args(plan, arrays, re_s, im_s, k), time_it=False
            )
            results["cases"].append({"plan": f"small_w{int(wstack)}",
                                     "group": k, **case})
    # One bench-size plane group (the one with the most active blocks).
    uvw, freqs, vis, wgt = bench_visibilities(*bench)
    plan, arrays, re_s, im_s = staged_problem(
        uvw, freqs, vis, wgt, bench_npix, BENCH_ASEC, device
    )
    from ska_sdp_cip_tpu_torch.ops.gridder import group_active_blocks

    sizes = [len(x) for x in group_active_blocks(plan)]
    k = int(np.argmax(sizes))
    results["bench_geometry"] = {
        "ngrid": plan.ngrid,
        "nalloc": [plan.nalloc_x, plan.nalloc_y],
        "support": plan.support,
        "nplanes": plan.nplanes,
        "plane_group": plan.plane_group,
        "block": plan.block,
        "num_blocks": plan.num_blocks,
        "num_vis_slots": plan.num_vis,
        "num_vis_data": plan.num_vis_data,
        "group_active_blocks": sizes,
    }
    case = compare_group(
        plan, group_args(plan, arrays, re_s, im_s, k), time_it=True
    )
    results["bench"] = {"group": k, **case}
    results["bench_dft"] = bench_dft_check(
        plan, arrays, re_s, im_s, uvw, freqs, vis * wgt, device
    )
    return results


def bench_dft_check(plan, arrays, re_s, im_s, uvw, freqs, wvis, device,
                    num_pixels: int = 256, seed: int = 1) -> dict:
    """
    The unnormalized bench image (``build_invert`` on the staged bench
    problem) against the explicit float64 DFT at ``num_pixels`` random
    pixels. On noise-like data this shows the gridder's error floor
    (the prologue's float32 positions, ROADMAP.md C1), which point
    sources hide.
    """
    from ska_sdp_cip_tpu_torch.ops.gridder import build_invert

    npix = plan.num_pixels
    image = build_invert(plan)(arrays, re_s, im_s).cpu().numpy()
    pts = np.random.default_rng(seed).integers(0, npix, size=(num_pixels, 2))
    ref = dft_at_pixels(uvw, freqs, wvis, pts, plan.pixel_size_lm, npix,
                        device)
    err = float(np.abs(image[pts[:, 0], pts[:, 1]] - ref).max())
    out = {
        "pixels": num_pixels,
        "max_abs_err": err,
        "rel_to_sampled_max": err / float(np.abs(ref).max()),
        "rel_to_image_max": err / float(np.abs(image).max()),
        "contract": DFT_RTOL,
        "finite": bool(np.isfinite(image).all()),
    }
    if not (out["finite"] and out["rel_to_sampled_max"] <= 10 * DFT_RTOL):
        raise PhaseError(
            f"bench image vs DFT {out['rel_to_sampled_max']:.3e} > "
            f"{10 * DFT_RTOL}"
        )
    return out


def phase_b2(device, n=4096, npix=2048) -> dict:
    import torch

    from ska_sdp_cip_tpu_torch.ops import fft_cuda
    from ska_sdp_cip_tpu_torch.ops.fft import fft_plan_arrays, make_fft_plan
    from ska_sdp_cip_tpu_torch.ops.gridder import stage_arrays

    fplan = make_fft_plan(n, shifted=True)
    meta = fft_cuda.fused_pass_meta(fplan, ((n - npix) // 2, npix))
    host = fft_plan_arrays(fplan, prefix="fft")
    host.update(
        fft_cuda.fused_pass_host_arrays(fplan, meta, sign=+1, prefix="fftp")
    )
    f = stage_arrays(host, device)
    rng = np.random.default_rng(3)
    results = {"phase": "b2", "n": n, "crop": npix, "cases": []}
    for m in (n, npix):
        re = torch.from_numpy(rng.normal(size=(n, m)).astype(np.float32))
        im = torch.from_numpy(rng.normal(size=(n, m)).astype(np.float32))
        re, im = re.to(device), im.to(device)

        def kernel():
            return fft_cuda.fft_first_axis_fused(
                re, im, f, meta=meta, sign=+1
            )

        def plain():
            return fft_cuda.fft_first_axis_reference(
                re, im, f, meta=meta, sign=+1
            )

        got, ref = kernel(), plain()
        errs = [rel_err(g, r) for g, r in zip(got, ref)]
        case = {
            "m": m,
            "max_abs_err": max(e[0] for e in errs),
            "max_rel_err": max(e[1] for e in errs),
        }
        if device.type == "cuda":
            case["ms"] = cuda_ms(kernel, iters=10)
            case["plain_ms"] = cuda_ms(plain, iters=10)
        results["cases"].append(case)
        if not case["max_rel_err"] <= KERNEL_RTOL:
            raise PhaseError(
                f"B2 vs plain {case['max_rel_err']:.3e} > {KERNEL_RTOL}"
            )
    return results


def phase_e2e_small(device, npix=256) -> dict:
    from ska_sdp_cip_tpu_torch.io.synth import synthetic_uvw
    from ska_sdp_cip_tpu_torch.ops.dft import dirty_image_dft
    from ska_sdp_cip_tpu_torch.ops.gridder import dirty_image

    rng = np.random.default_rng(77)
    uvw, _ = synthetic_uvw(3, 24, max_baseline_m=5000.0, seed=77)
    freqs = np.linspace(1.4e9, 1.45e9, 3)
    shape = (len(uvw), len(freqs))
    vis = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64
    )
    wgt = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    pix = float(np.sin(np.radians(BENCH_ASEC / 3600.0)))
    results = {"phase": "e2e_small", "npix": npix, "num_vis": vis.size,
               "cases": []}
    for wstack in (False, True):
        ref = dirty_image_dft(uvw, freqs, vis, wgt, npix, pix, apply_w=wstack)
        got = dirty_image(
            uvw, freqs, vis, wgt, npix, pix, do_wstacking=wstack,
            device=device,
        )
        err, rel = rel_err(got, ref)
        results["cases"].append(
            {"wstacking": wstack, "max_abs_err": err, "max_rel_err": rel}
        )
        if not (np.isfinite(got).all() and rel <= DFT_RTOL):
            raise PhaseError(f"dirty_image vs DFT {rel:.3e} > {DFT_RTOL}")
    return results


def source_truth(seed: int, num_sources: int = 5, fov_deg: float = 1.0):
    """The sky of make_synthetic_dataset: (lm (n, 2), flux (n,))."""
    rng = np.random.default_rng(seed)
    half = np.radians(fov_deg) / 2
    lm = rng.uniform(-half, half, size=(num_sources, 2))
    flux = rng.uniform(0.5, 3.0, size=num_sources)
    return lm, flux


def phase_slice(device, workdir: Path,
                size=(BENCH_TIMES, BENCH_ANTENNAS, BENCH_CHANNELS),
                npix=BENCH_NPIX, asec=BENCH_ASEC, repeats=3) -> dict:
    import torch

    from ska_sdp_cip_tpu_torch import VisibilityReader, invert_dataset
    from ska_sdp_cip_tpu_torch.io.synth import make_synthetic_dataset
    from ska_sdp_cip_tpu_torch.ops import cuda_gridder, fft_cuda

    times, antennas, channels = size
    seed = 1234
    t0 = time.perf_counter()
    path = make_synthetic_dataset(
        workdir / "obs.vz",
        num_times=times,
        num_antennas=antennas,
        channel_frequencies=np.linspace(*BENCH_FREQS, channels),
        seed=seed,
    )
    dataset_seconds = time.perf_counter() - t0
    reader = VisibilityReader(path)
    num_vis = reader.num_data_rows * reader.num_channels

    def run():
        return invert_dataset(reader, npix, asec, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    cuda_gridder.LAUNCHES = 0
    fft_cuda.LAUNCHES = 0
    sync()
    t0 = time.perf_counter()
    image = run()
    sync()
    first_seconds = time.perf_counter() - t0
    launches = {"b1": cuda_gridder.LAUNCHES, "b2": fft_cuda.LAUNCHES}

    walls = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)

    lm, flux = source_truth(seed)
    pix = float(np.sin(np.radians(asec / 3600.0)))
    bright = int(np.argmax(flux))
    expected = np.round(lm[bright] / pix).astype(int) + npix // 2
    peak = np.unravel_index(int(np.argmax(image)), image.shape)
    offset = np.abs(np.asarray(peak) - expected)
    results = {
        "phase": "slice",
        "num_vis": int(num_vis),
        "npix": npix,
        "pixel_asec": asec,
        "dataset_seconds": dataset_seconds,
        "first_call_seconds": first_seconds,
        "wall_seconds": walls,
        "median_wall_seconds": wall,
        "mvis_per_s": num_vis / wall / 1e6,
        "launches": launches,
        "peak_pixel": [int(p) for p in peak],
        "expected_pixel": [int(e) for e in expected],
        "peak_value": float(image.max()),
        "brightest_flux": float(flux[bright]),
        "finite": bool(np.isfinite(image).all()),
        "shape": list(image.shape),
    }
    if image.shape != (npix, npix) or not results["finite"]:
        raise PhaseError("slice image has the wrong shape or non-finite values")
    if offset.max() > 1:
        raise PhaseError(f"peak at {peak}, brightest source at {expected}")
    if device.type == "cuda" and min(launches.values()) <= 0:
        raise PhaseError(f"a kernel was not launched: {launches}")
    rel = dft_spot_check(reader, image, expected, pix, device)
    results["dft_spot_check"] = rel
    if not rel["max_rel_err"] <= DFT_RTOL:
        raise PhaseError(f"slice vs DFT {rel['max_rel_err']:.3e} > {DFT_RTOL}")
    results["breakdown"] = slice_breakdown(reader, npix, asec, device)
    results["profile"] = profile_call(run, device)
    return results


def profile_call(fn, device, top: int = 8) -> dict:
    """
    Device kernel time of one call of ``fn`` under torch.profiler: the
    summed kernel time, its share of the call's wall time, and the
    kernels that took most of it.
    """
    if device.type != "cuda":
        return {"device_time": "not measured"}
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [
            (evt.device_time_total, evt.count, evt.key)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA and evt.device_time_total > 0
        ]
    except (RuntimeError, AttributeError) as err:
        return {"device_time": "not measured", "error": repr(err)}
    if not rows:
        return {"device_time": "not measured", "wall_seconds": wall}
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    return {
        "wall_seconds": wall,
        "device_busy_seconds": busy,
        "device_idle_share": 1.0 - busy / wall,
        "top_kernels": [
            {"name": name[:80], "calls": count, "ms": us / 1e3}
            for us, count, name in rows[:top]
        ],
    }


def dft_at_pixels(uvw, freqs, wvis, pts, pix, npix, device) -> np.ndarray:
    """
    The unnormalized explicit DFT dirty image
    (``ops/dft.py:dirty_image_dft``'s formula, float64, on ``device``)
    of weighted (nrow, nchan) visibilities at the pixels ``pts`` (n, 2).
    """
    import torch

    from ska_sdp_cip_tpu_torch.ops.dft import SPEED_OF_LIGHT

    f64 = dict(dtype=torch.float64, device=device)
    x = torch.tensor((pts[:, 0] - npix // 2) * pix, **f64)
    y = torch.tensor((pts[:, 1] - npix // 2) * pix, **f64)
    r2 = x * x + y * y
    nm1 = -r2 / (1.0 + torch.sqrt(1.0 - r2))
    uvw = torch.tensor(np.asarray(uvw, np.float64), **f64)
    wvis = torch.tensor(
        np.asarray(wvis, np.complex128), dtype=torch.complex128, device=device
    )
    acc = torch.zeros(len(pts), **f64)
    for c, freq in enumerate(freqs):
        u, v, w = (uvw * (float(freq) / SPEED_OF_LIGHT)).unbind(1)
        phase = 2.0 * np.pi * (
            u[:, None] * x + v[:, None] * y - w[:, None] * nm1
        )
        acc += (wvis[:, c, None] * torch.exp(1j * phase)).real.sum(0)
    return (acc / (nm1 + 1.0)).cpu().numpy()


def dft_spot_check(reader, image, centre, pix, device, seed=0) -> dict:
    """
    The normalized image against the explicit DFT dirty image at 448
    pixels: a 16 x 16 window on the brightest source and 192 random
    ones. Error relative to the image max.
    """
    from ska_sdp_cip_tpu_torch.invert import StokesIGridderInput

    npix = image.shape[0]
    gi = StokesIGridderInput.from_reader(reader)
    weights = gi.effective_weights()
    rng = np.random.default_rng(seed)
    window = np.stack(
        np.meshgrid(np.arange(-8, 8), np.arange(-8, 8)), -1
    ).reshape(-1, 2) + np.asarray(centre)
    pts = np.concatenate([window, rng.integers(0, npix, size=(192, 2))])
    pts = np.clip(pts, 0, npix - 1)
    wvis = np.asarray(gi.visibilities, np.complex128) * weights
    dft = dft_at_pixels(gi.uvw, gi.channel_frequencies, wvis, pts, pix,
                        npix, device) / weights.sum()
    got = image[pts[:, 0], pts[:, 1]]
    return {
        "pixels": len(pts),
        "max_abs_err": float(np.abs(got - dft).max()),
        "max_rel_err": float(np.abs(got - dft).max() / np.abs(image).max()),
    }


def slice_breakdown(reader, npix, asec, device) -> dict:
    """Seconds per stage of one invert_dataset call, synchronized."""
    import torch

    from ska_sdp_cip_tpu_torch.invert import (
        StokesIGridderInput,
        pixel_size_lm_from_asec,
    )
    from ska_sdp_cip_tpu_torch.ops.gridder import (
        build_assemble,
        build_invert,
        compact_plan_host_arrays,
        stage_arrays,
    )
    from ska_sdp_cip_tpu_torch.ops.plan import make_plan

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    out = {}
    t = time.perf_counter()
    gi = StokesIGridderInput.from_reader(reader)
    weighted = (gi.visibilities.astype(np.complex64)
                * gi.effective_weights().astype(np.float32)).ravel()
    out["read_stokes_seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    plan = make_plan(gi.uvw, gi.channel_frequencies, npix,
                     pixel_size_lm_from_asec(asec), export_packed=False)
    out["plan_seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    host = compact_plan_host_arrays(
        plan, gi.uvw, gi.channel_frequencies, device
    )
    out["host_arrays_seconds"] = time.perf_counter() - t
    sync()
    t = time.perf_counter()
    arrays = stage_arrays(host, device)
    re = torch.from_numpy(np.ascontiguousarray(weighted.real)).to(device)
    im = torch.from_numpy(np.ascontiguousarray(weighted.imag)).to(device)
    sync()
    out["h2d_seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    arrays, re_s, im_s = build_assemble(plan)(arrays, re, im)
    sync()
    out["assemble_seconds"] = time.perf_counter() - t
    invert = build_invert(plan)
    t = time.perf_counter()
    image = invert(arrays, re_s, im_s)
    sync()
    out["invert_device_seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    image.cpu()
    out["d2h_seconds"] = time.perf_counter() - t
    if device.type == "cuda":
        out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from ska_sdp_cip_tpu_torch.ops import _build
    except ImportError as err:
        print(f"chip_smoke: the port package is missing: {err}",
              file=sys.stderr)
        return 3
    # The plain versions' matrix products must run in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    _build.load_library()
    ptxas = [
        line.strip()
        for line in (_build.build_log or "").splitlines()
        if "registers" in line or "spill" in line
    ]
    emit({
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_seconds": _build.build_seconds,
        "ptxas": ptxas,
    })
    b1 = phase_b1(device)
    emit(b1)
    b2 = phase_b2(device)
    emit(b2)
    emit(phase_e2e_small(device))
    with tempfile.TemporaryDirectory() as tmp:
        sl = phase_slice(device, Path(tmp))
    emit(sl)
    b2_main = b2["cases"][0]
    emit({"kernels": [
        {
            "name": "grid_planes",
            "route": "cuda",
            "source": "ska_sdp_cip_tpu_torch/csrc/grid.cu",
            "replaces": "ska_sdp_cip_tpu/ops/pallas_gridder.py:298",
            "launches": sl["launches"]["b1"],
            "max_abs_err": b1["bench"]["max_abs_err"],
            "ms": b1["bench"]["ms"],
            "plain_ms": b1["bench"]["plain_ms"],
        },
        {
            "name": "fft_first_axis_fused",
            "route": "cuda",
            "source": "ska_sdp_cip_tpu_torch/csrc/fft_fused.cu",
            "replaces": "ska_sdp_cip_tpu/ops/fft_pallas.py:238",
            "launches": sl["launches"]["b2"],
            "max_abs_err": b2_main["max_abs_err"],
            "ms": b2_main["ms"],
            "plain_ms": b2_main["plain_ms"],
        },
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        sys.exit(1)
