#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (``ska_sdp_cip_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``ska_sdp_cip_tpu_torch/csrc`` with nvcc
(one nvcc per source, started together, into ``build/torch_kernels/``),
then runs these phases and prints one JSON object per phase:

1. ``device``: card name, ``nvidia-smi`` name and power limit, build time;
2. ``b1``: the gridding kernel against its plain version, on small
   plans (G = 1 and G = 2) and on one bench-size plane group (G = 2);
   then the whole bench-size image of the noise-like bench visibilities
   against a float64 DFT at 256 random pixels (``bench_dft``, gated at
   the 1e-4 contract);
3. ``b2``: the fused first-axis DFT kernel against its plain version at
   the bench transform: out-cropped (invert: 4096 rows -> 2048-row
   crop) and in-cropped at sign -1 (predict: 2048 image rows -> 4096),
   each at m = 4096 and 2048, the widths of a 2-D transform's two
   passes, and at m = 2046 (an image width that is not a multiple of
   4: the kernel's 4-byte staging); then at the production transform (15360 rows -> 10240 and
   10240 -> 15360, m = 15360 and 10240; n1 = 120). Each case also times
   one uncentred, uncropped ``torch.fft`` call along dim 0 of the
   complex64 input (``library_ms``) and the first design of B2, the
   dense pass P2 ``full`` (out-cropped), and gives the bound and the
   achieved GB/s;
4. ``b3``: the degridding kernel against its plain version, on small
   plans (G = 1 without w-stacking, G = 2) and on one bench-size plane
   group;
5. ``e2e_small``: ``dirty_image`` on the card against the explicit DFT
   (``dirty_image_dft``) on a 256 px check plan;
6. ``predict``: ``predict_visibilities`` on the card against
   ``predict_dft`` on a 256 px check plan; at bench size the adjoint
   identity <invert(v), I> = Re <v, predict(I)> (float64 dot products
   on the host), the median wall of 3 calls and the kernels' launch
   counts;
7. ``slice``: ``invert_dataset(VisibilityReader(obs), 2048, 5.0,
   device="cuda")`` on a 5,836,800-visibility synthetic dataset, with
   the kernels' launch counts, the brightest source's peak position, a
   float64 DFT spot check of 448 pixels, the median wall time of 3 runs
   after a warm run, a per-stage breakdown and a profile of one call;
8. ``major_cycle``: ``MeasurementOperator.build`` + ``major_cycle_clean(
   num_major=3, minor_iter=100)`` on the same dataset, gated on the
   residual (below 0.6 x the dirty peak) and on the brightest CLEAN
   component (at the brightest source's pixel), with the plan and
   staging seconds, the seconds of each major cycle, the kernels'
   launch counts and a profile of one cycle;
9. ``b6``: the tiled-input probe (``probes/fft_tiled.py``) at 15360^2
   and 4096^2: B6 (``pretile_first_axis``) against its plain version
   and B2 on tiled input against B2 on row-major input, both exact,
   with the times of the baseline pass, pretile, the tiled pass and
   pretile + tiled pass;
10. ``fft_probes``: at 15360^2, P1 (stage 1 of B2's first design, the
    dense pass, through an S-deep ``cp.async`` ring, S = 1, 2, 4; each
    output equal to the dense pass P2 ``full``) and P2 (the dense pass's
    stage ablation, each variant against its plain piece); P3, the
    largest dynamic shared memory per block against the device
    attribute; and ``library_ms`` of the probes' pass;
11. ``production`` (three parts): ``scripts/production_bench.py``'s
    configuration (258,048 visibilities, 10240 px at 1.1 asec,
    ``sigma="auto"`` = 1.5, a 15360^2 grid, support 8): ``dirty_image``
    (float64 DFT at 256 pixels, B1 against its plain version on the
    largest plane group, median wall of 3 calls, breakdown, launch
    counts, profile), ``predict_visibilities`` (the adjoint identity,
    with a witness that replaces B2 by its plain version and by the
    exact transform, and for the dirty image as I; five point sources
    against a float64 DFT at 4096 visibilities, B3
    against its plain version on the largest plane group, median wall,
    breakdown) and the major cycle on the Clark minor
    cycle (``psf_patch`` 2048) on visibilities of five point sources,
    with the ``major_cycle`` gates.

Then a ``kernels`` JSON line, the ``nvidia-smi`` line, and as the last
line ``{"ok": true, "device": {...}}``. Any failed phase exits non-zero
without that line; so does a machine without a CUDA card, and a
directory without the package. Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
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
BENCH_NGRID = 4096

#: The production configuration (scripts/production_bench.py, the CSD3
#: deployment of the reference): 4 times x 2016 baselines x 32
#: channels = 258,048 visibilities, 10240 px at 1.1 asec, epsilon 1e-4,
#: sigma "auto" (resolves to 1.5: a 15360^2 grid, support 8).
PROD_TIMES, PROD_ANTENNAS, PROD_CHANNELS = 4, 64, 32
PROD_NPIX, PROD_ASEC, PROD_NGRID = 10240, 1.1, 15360


#: Published peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data
#: sheet): a kernel's least time (``bound_ms``) is its bytes at the HBM
#: rate or its float32 operations at the FP32 rate, whichever is longer.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


class PhaseError(RuntimeError):
    """A phase's check failed."""


def bound(nbytes: float, flops: float = 0.0) -> dict:
    """``bound_ms`` and ``bound_by`` of ``nbytes`` moved (each input
    read once, each output written once) and ``flops`` float32
    operations."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def b2_work(meta, m: int, rows_in: int) -> tuple:
    """A B2 pass's bytes (input read once, output written once), the
    two-launch floor's bytes (plus z written and read back) and its
    flops (an FFT's 5 n log2 n per column)."""
    n = meta.n1 * meta.n2
    io = 8 * m * (rows_in + meta.size)
    return io, io + 2 * 8 * m * n, 5 * n * math.log2(n) * m


def centred_dft64(re, im, meta, n: int, sign: int, cols: int = 256):
    """The pass's exact result on the first ``cols`` columns: the
    centred length-n DFT (``fftshift o DFT o ifftshift``) at sign
    ``sign`` in complex128 (``torch.fft``), of the input zero-padded
    (in-cropped) or cropped (out-cropped) as the pass's geometry says."""
    import torch

    x = torch.complex(re[:, :cols].double(), im[:, :cols].double())
    if meta.in_size:
        c0 = meta.j1a * meta.n2 + meta.pad_lo
        full = x.new_zeros((n, x.shape[1]))
        full[c0 : c0 + meta.in_size] = x
        x = full
    x = torch.fft.ifftshift(x, dim=0)
    y = torch.fft.fft(x, dim=0) if sign < 0 else torch.fft.ifft(x, dim=0) * n
    c0 = meta.k2a * meta.n1 + meta.trim0
    return torch.fft.fftshift(y, dim=0)[c0 : c0 + meta.size]


def exact_b2(re, im, f, *, meta, sign, **_):
    """B2's pass done exactly: :func:`centred_dft64` (complex128
    ``torch.fft``) over blocks of 2048 columns, rounded to float32. A
    witness for the adjoint identity, not a pass of the port."""
    import torch

    n, m = meta.n1 * meta.n2, re.shape[1]
    out_re = re.new_empty((meta.size, m))
    out_im = torch.empty_like(out_re)
    for c0 in range(0, m, 2048):
        y = centred_dft64(re[:, c0:], im[:, c0:], meta, n, sign, cols=2048)
        out_re[:, c0 : c0 + y.shape[1]] = y.real
        out_im[:, c0 : c0 + y.shape[1]] = y.imag
    return out_re, out_im


def plain_b2(ngrid: int, device):
    """B2's pass done by its plain version on ``device`` (the plan
    factors ``fft_*`` of the ``ngrid`` transform, staged here)."""
    from ska_sdp_cip_tpu_torch.ops import fft_cuda
    from ska_sdp_cip_tpu_torch.ops.fft import fft_plan_arrays, make_fft_plan
    from ska_sdp_cip_tpu_torch.ops.gridder import stage_arrays

    factors = stage_arrays(
        fft_plan_arrays(make_fft_plan(ngrid, shifted=True), prefix="fft"),
        device)

    def run(re, im, f, *, meta, sign, **_):
        return fft_cuda.fft_first_axis_reference(re, im, factors, meta=meta,
                                                 sign=sign)

    return run


@contextlib.contextmanager
def b2_replaced(pass_fn):
    """Run ``dirty_image`` and ``predict_visibilities`` with every B2
    pass replaced by ``pass_fn`` (same signature): a witness that
    separates B2's share of the adjoint identity's offset from the rest
    of the operators'."""
    from ska_sdp_cip_tpu_torch.ops import fft_cuda, gridder

    saved = gridder.fft_first_axis_fused, fft_cuda.fft_first_axis_fused
    gridder.fft_first_axis_fused = fft_cuda.fft_first_axis_fused = pass_fn
    try:
        yield
    finally:
        gridder.fft_first_axis_fused, fft_cuda.fft_first_axis_fused = saved


def gridding_work(plan, G: int, active: int, *, degrid: bool) -> tuple:
    """Bytes and flops of one B1 (``degrid=False``) or B3 launch over
    ``active`` blocks: every slot's three packed floats, its visibility
    (B1) or accumulator read and written (B3), and each block's 2G
    patch_x x patch_y float32 patches written (B1) or windows read (B3);
    two FMAs (re, im) per footprint cell and plane."""
    slots = active * plan.block
    patches = active * 2 * G * plan.patch_x * plan.patch_y * 4
    nbytes = slots * (12 + (16 if degrid else 8)) + patches
    return nbytes, 4.0 * slots * G * plan.support ** 2


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


def bench_visibilities(num_times, num_antennas, num_channels, *,
                       seed=2024, uvw_seed=42):
    """bench.py's workload (and, with ``seed=7, uvw_seed=11``,
    production_bench.py's): uvw, freqs, random vis and weights."""
    from ska_sdp_cip_tpu_torch.io.synth import synthetic_uvw

    rng = np.random.default_rng(seed)
    uvw, _ = synthetic_uvw(
        num_times, num_antennas, max_baseline_m=7700.0, seed=uvw_seed
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
    from ska_sdp_cip_tpu_torch.probes.common import cuda_ms

    got = cg.grid_planes(*args, plan=plan)
    ref = cg.grid_planes_reference(*args, plan=plan)
    worst_rel, worst_abs = 0.0, 0.0
    for p in range(ref.shape[0]):
        err, rel = rel_err(got[p], ref[p])
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    G, active = int(args[6].shape[0]), int(args[7].shape[0])
    out = {
        "G": G,
        "active_blocks": active,
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        **bound(*gridding_work(plan, G, active, degrid=False)),
        "library_ms": None,
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


def small_visibilities():
    """The small check problem of the b1/b3 phases: uvw, freqs, vis, wgt."""
    from ska_sdp_cip_tpu_torch.io.synth import synthetic_uvw

    rng = np.random.default_rng(17)
    uvw, _ = synthetic_uvw(3, 10, max_baseline_m=5000.0, seed=23)
    freqs = np.array([1.0e9, 1.07e9])
    shape = (len(uvw), 2)
    vis = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64
    )
    wgt = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    return uvw, freqs, vis, wgt


def bench_problem(device, bench=(BENCH_TIMES, BENCH_ANTENNAS, BENCH_CHANNELS),
                  npix=BENCH_NPIX) -> dict:
    """bench.py's visibilities, planned and staged on ``device`` once for
    the b1, b3 and predict phases."""
    uvw, freqs, vis, wgt = bench_visibilities(*bench)
    plan, arrays, re_s, im_s = staged_problem(
        uvw, freqs, vis, wgt, npix, BENCH_ASEC, device
    )
    return {"uvw": uvw, "freqs": freqs, "vis": vis, "wgt": wgt,
            "plan": plan, "arrays": arrays, "re_s": re_s, "im_s": im_s}


def largest_group(plan) -> int:
    from ska_sdp_cip_tpu_torch.ops.gridder import group_active_blocks

    return int(np.argmax([len(x) for x in group_active_blocks(plan)]))


def phase_b1(device, bench: dict) -> dict:
    results = {"phase": "b1", "cases": []}
    uvw, freqs, vis, wgt = small_visibilities()
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
    from ska_sdp_cip_tpu_torch.ops.gridder import group_active_blocks

    plan, arrays = bench["plan"], bench["arrays"]
    re_s, im_s = bench["re_s"], bench["im_s"]
    sizes = [len(x) for x in group_active_blocks(plan)]
    k = largest_group(plan)
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
        plan, arrays, re_s, im_s, bench["uvw"], bench["freqs"],
        bench["vis"] * bench["wgt"], device,
    )
    return results


def bench_dft_check(plan, arrays, re_s, im_s, uvw, freqs, wvis, device,
                    num_pixels: int = 256, seed: int = 1) -> dict:
    """
    The unnormalized bench image (``build_invert`` on the staged bench
    problem) against the explicit float64 DFT at ``num_pixels`` random
    pixels. On noise-like data this shows the gridder's error floor
    (where the prologue's rounded positions showed, ROADMAP.md C1),
    which point sources hide.
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
    if not (out["finite"] and out["rel_to_sampled_max"] <= DFT_RTOL):
        raise PhaseError(
            f"bench image vs DFT {out['rel_to_sampled_max']:.3e} > "
            f"{DFT_RTOL}"
        )
    return out


def phase_b2(device, n=4096, npix=2048, iters=10, widths=None) -> dict:
    """
    B2 against its plain version: the invert's out-cropped pass (n rows
    -> npix, sign +1, ``fftp_*``) and predict's in-cropped pass (npix
    rows of the zero-padded image -> n, sign -1, ``fftq_*``), each at
    the widths m of ``widths``, by default n and npix (a 2-D transform's
    two passes; a width that is not a multiple of 4 runs the kernel's
    4-byte staging of an image of such a width). Inputs are standard
    normal, made on the device. Each case gives the bound (input read
    once, output written once at 3.35 TB/s; the two-launch floor adds
    z written and read back), and on the card the kernel's, the plain
    version's and the library call's times (``library_ms``: one
    ``torch.fft.ifft`` at sign +1, ``fft`` at -1, along dim 0 of the
    complex64 input packed outside the timing, zero-padded to n,
    uncentred and uncropped), the achieved GB/s and, out-cropped, the
    first design's time (P2 ``full``, the dense pass, on the same
    input; P2 runs the out-cropped pass only). It also holds the kernel
    and the plain version against the exact transform (complex128) on
    the first 256 columns, and checks that two runs of the kernel are
    equal bit for bit.
    """
    import torch

    from ska_sdp_cip_tpu_torch.ops import fft_cuda
    from ska_sdp_cip_tpu_torch.ops.fft import fft_plan_arrays, make_fft_plan
    from ska_sdp_cip_tpu_torch.ops.gridder import stage_arrays
    from ska_sdp_cip_tpu_torch.probes.common import cuda_ms, max_err
    from ska_sdp_cip_tpu_torch.probes.fft_ablation import ablation

    fplan = make_fft_plan(n, shifted=True)
    crop = ((n - npix) // 2, npix)
    passes = {
        "out_crop": (fft_cuda.fused_pass_meta(fplan, crop), +1, "fftp", n),
        "in_crop": (fft_cuda.fused_pass_meta(fplan, None, in_crop=crop), -1,
                    "fftq", npix),
    }
    host = fft_plan_arrays(fplan, prefix="fft")
    for meta, sign, prefix, _ in passes.values():
        host.update(fft_cuda.fused_pass_kernel_arrays(fplan, meta, sign=sign,
                                                      prefix=prefix))
    # P2 ``full`` (the first design) reads the dense factors.
    host.update(fft_cuda.fused_pass_host_arrays(
        fplan, passes["out_crop"][0], sign=+1, prefix="fftp"))
    f = stage_arrays(host, device)
    gen = torch.Generator(device=device).manual_seed(3)
    results = {"phase": "b2", "n": n, "crop": npix, "cases": []}
    for name, (meta, sign, prefix, rows) in passes.items():
        for m in widths or (n, npix):
            re = torch.randn((rows, m), generator=gen, device=device)
            im = torch.randn((rows, m), generator=gen, device=device)

            def kernel():
                return fft_cuda.fft_first_axis_fused(
                    re, im, f, meta=meta, sign=sign, prefix=prefix
                )

            def plain():
                return fft_cuda.fft_first_axis_reference(
                    re, im, f, meta=meta, sign=sign
                )

            got, ref = kernel(), plain()
            err, rel = max_err(got, ref)
            exact = centred_dft64(re, im, meta, n, sign)
            scale = float(exact.abs().max())
            dft64 = {
                name_: float((torch.complex(*pair)[:, :256]
                              .to(torch.complex128) - exact)
                             .abs().max()) / scale
                for name_, pair in (("kernel", got), ("plain", ref))
            }
            again = kernel()
            repeat_equal = all(torch.equal(a, b) for a, b in zip(got, again))
            del got, ref, again, exact
            io, floor, flops = b2_work(meta, m, rows)
            case = {
                "pass": name,
                "n": n,
                "n1": meta.n1,
                "rows_in": rows,
                "m": m,
                "max_abs_err": err,
                "max_rel_err": rel,
                "dft64_rel_err": dft64["kernel"],
                "plain_dft64_rel_err": dft64["plain"],
                "repeat_equal": repeat_equal,
                **bound(io, flops),
                "two_launch_floor_ms": bound(floor, flops)["bound_ms"],
            }
            if device.type == "cuda":
                case["ms"] = cuda_ms(kernel, iters=iters)
                case["plain_ms"] = cuda_ms(plain, iters=iters)
                x = torch.complex(re, im)
                lib = torch.fft.ifft if sign > 0 else torch.fft.fft
                case["library_ms"] = cuda_ms(lambda: lib(x, n=n, dim=0),
                                             iters=iters)
                case["library_call"] = (
                    f"torch.fft.{lib.__name__}(complex64 ({rows}, {m}), "
                    f"n={n}, dim=0): uncentred, uncropped"
                )
                del x
                case["gb_per_s"] = io / case["ms"] / 1e6
                case["gb_per_s_with_z"] = floor / case["ms"] / 1e6
                case["first_design_ms"] = None
                if name == "out_crop":
                    case["first_design_ms"] = cuda_ms(
                        lambda: ablation("full", re, im, f, meta=meta),
                        iters=iters,
                    )
            results["cases"].append(case)
            del re, im
            if not (case["max_rel_err"] <= KERNEL_RTOL and repeat_equal):
                raise PhaseError(
                    f"B2 ({name}, n={n}, m={m}) vs plain "
                    f"{case['max_rel_err']:.3e} > {KERNEL_RTOL}, or two "
                    f"runs differ"
                )
    return results


def compare_degrid(plan, arrays, grids, k, *, time_it: bool,
                   iters: int = 3) -> dict:
    """B3 kernel vs plain version on plane group ``k`` of ``grids``."""
    import torch

    from ska_sdp_cip_tpu_torch.ops import cuda_gridder as cg
    from ska_sdp_cip_tpu_torch.ops.gridder import group_active_blocks
    from ska_sdp_cip_tpu_torch.probes.common import cuda_ms

    count = len(group_active_blocks(plan)[k])
    args = (
        arrays["packed"], arrays["block_len"], arrays["cblock_ox"],
        arrays["block_oy"], grids, arrays["plane_wg"][k],
        arrays["group_blocks"][k, :count],
    )

    def acc():
        return torch.zeros((2, plan.num_vis), dtype=torch.float32,
                           device=grids.device)

    got = cg.degrid_planes(*args, acc(), plan=plan)
    ref = cg.degrid_planes_reference(*args, acc(), plan=plan)
    err, rel = rel_err(got, ref)
    G = int(args[5].shape[0])
    out = {"G": G, "active_blocks": count,
           "max_abs_err": err, "max_rel_err": rel,
           **bound(*gridding_work(plan, G, count, degrid=True)),
           "library_ms": None}
    if time_it and grids.device.type == "cuda":
        out["ms"] = cuda_ms(lambda: cg.degrid_planes(*args, acc(), plan=plan),
                            iters=iters)
        out["plain_ms"] = cuda_ms(
            lambda: cg.degrid_planes_reference(*args, acc(), plan=plan),
            iters=iters,
        )
    if not rel <= KERNEL_RTOL:
        raise PhaseError(f"B3 vs plain {rel:.3e} > {KERNEL_RTOL}")
    return out


def random_grids(plan, device, seed: int):
    """(2G, nalloc_x, nalloc_y) standard-normal float32 planes."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(
        (2 * plan.plane_group, plan.nalloc_x, plan.nalloc_y),
        generator=gen, device=device,
    )


def phase_b3(device, bench: dict) -> dict:
    """
    B3 against its plain version: every group of two small plans
    (G = 1 without w-stacking, G = 2), then the bench plan's largest
    plane group on random planes, with CUDA-event times of both.
    """
    from ska_sdp_cip_tpu_torch.ops.gridder import (
        slot_plan_host_arrays,
        stage_arrays,
    )
    from ska_sdp_cip_tpu_torch.ops.plan import make_plan

    results = {"phase": "b3", "cases": []}
    uvw, freqs, _, _ = small_visibilities()
    pix = float(np.sin(np.radians(40.0 / 3600.0)))
    for wstack in (False, True):
        plan = make_plan(uvw, freqs, 96, pix, do_wstacking=wstack)
        arrays = stage_arrays(slot_plan_host_arrays(plan, device), device)
        grids = random_grids(plan, device, seed=5)
        for k in range(plan.num_groups):
            case = compare_degrid(plan, arrays, grids, k, time_it=False)
            results["cases"].append({"plan": f"small_w{int(wstack)}",
                                     "group": k, **case})
    plan, arrays = bench["plan"], bench["arrays"]
    k = largest_group(plan)
    grids = random_grids(plan, device, seed=6)
    results["bench"] = {"group": k, **compare_degrid(plan, arrays, grids, k,
                                                      time_it=True)}
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


def _launch_counters():
    from ska_sdp_cip_tpu_torch.ops import cuda_gridder, fft_cuda
    from ska_sdp_cip_tpu_torch.probes import fft_ablation, fft_async_fetch

    return cuda_gridder, fft_cuda, fft_async_fetch, fft_ablation


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    from ska_sdp_cip_tpu_torch.probes import smem

    cuda_gridder, fft_cuda, p1, p2 = _launch_counters()
    cuda_gridder.LAUNCHES = cuda_gridder.DEGRID_LAUNCHES = 0
    fft_cuda.LAUNCHES = fft_cuda.IN_CROP_LAUNCHES = 0
    fft_cuda.TILED_LAUNCHES = fft_cuda.PRETILE_LAUNCHES = 0
    for counts in (p1.LAUNCHES, p2.LAUNCHES):
        for key in counts:
            counts[key] = 0
    smem.LAUNCHES = 0


def read_launches() -> dict:
    """Every kernel's launch count since :func:`reset_launches`."""
    from ska_sdp_cip_tpu_torch.probes import smem

    cuda_gridder, fft_cuda, p1, p2 = _launch_counters()
    out = {"b1": cuda_gridder.LAUNCHES, "b2_out_crop": fft_cuda.LAUNCHES,
           "b2_in_crop": fft_cuda.IN_CROP_LAUNCHES,
           "b2_tiled": fft_cuda.TILED_LAUNCHES,
           "b3": cuda_gridder.DEGRID_LAUNCHES,
           "b6": fft_cuda.PRETILE_LAUNCHES, "p3": smem.LAUNCHES}
    out.update({f"p1_S{k}": v for k, v in p1.LAUNCHES.items()})
    out.update({f"p2_{k}": v for k, v in p2.LAUNCHES.items()})
    return out


def require_launches(launches: dict, kernels, device, where: str) -> None:
    if device.type == "cuda" and min(launches[k] for k in kernels) <= 0:
        raise PhaseError(f"{where}: a kernel was not launched: {launches}")


def phase_predict(device, bench: dict, npix=256, repeats=3) -> dict:
    """
    ``predict_visibilities`` on ``device``: a 256 px check against
    ``predict_dft`` (point sources, with and without w-stacking), then
    at bench size the adjoint identity against ``dirty_image`` with
    float64 dot products on the host, the median wall of ``repeats``
    calls after a warm one, and the launch counts of one call.
    """
    from ska_sdp_cip_tpu_torch import predict_visibilities
    from ska_sdp_cip_tpu_torch.io.synth import synthetic_uvw
    from ska_sdp_cip_tpu_torch.ops.dft import predict_dft
    from ska_sdp_cip_tpu_torch.ops.gridder import dirty_image

    pix = float(np.sin(np.radians(BENCH_ASEC / 3600.0)))
    results = {"phase": "predict", "npix": npix, "cases": []}
    uvw, _ = synthetic_uvw(3, 24, max_baseline_m=5000.0, seed=77)
    freqs = np.linspace(1.4e9, 1.45e9, 3)
    image = np.zeros((npix, npix), np.float32)
    rng = np.random.default_rng(78)
    for flux in (1.7, 0.9, 0.4):
        i, j = rng.integers(npix // 8, npix - npix // 8, size=2)
        image[i, j] += flux
    for wstack in (False, True):
        ref = predict_dft(uvw, freqs, image, pix, apply_w=wstack)
        got = predict_visibilities(uvw, freqs, image, pix,
                                   do_wstacking=wstack, device=device)
        err = float(np.abs(got - ref).max())
        rel = err / float(np.abs(ref).max())
        results["cases"].append({"wstacking": wstack, "num_vis": got.size,
                                 "max_abs_err": err, "max_rel_err": rel})
        if not (np.isfinite(got).all() and rel <= DFT_RTOL):
            raise PhaseError(f"predict vs DFT {rel:.3e} > {DFT_RTOL}")

    uvw, freqs, vis, wgt = (bench[k] for k in ("uvw", "freqs", "vis", "wgt"))
    bench_npix = bench["plan"].num_pixels
    image = np.random.default_rng(79).normal(
        size=(bench_npix, bench_npix)
    ).astype(np.float32)

    def run():
        return predict_visibilities(uvw, freqs, image, pix, device=device)

    dirty = dirty_image(uvw, freqs, vis, wgt, bench_npix, pix, device=device)
    model, first, launches, walls = timed_calls(run, device, repeats)
    require_launches(launches, ("b3", "b2_in_crop"), device, "predict")
    weighted = (vis * wgt).astype(np.complex128)
    lhs = float(np.vdot(image.astype(np.float64), dirty.astype(np.float64)))
    rhs = float(np.real(np.vdot(model.astype(np.complex128), weighted)))
    adjoint_rel = abs(lhs - rhs) / abs(lhs)
    results["bench"] = {
        "num_vis": int(model.size),
        "npix": bench_npix,
        "adjoint_lhs": lhs,
        "adjoint_rhs": rhs,
        "adjoint_rel": adjoint_rel,
        "first_call_seconds": first,
        "wall_seconds": walls,
        "median_wall_seconds": statistics.median(walls),
        "launches": launches,
        "finite": bool(np.isfinite(model).all()),
    }
    if not (results["bench"]["finite"] and adjoint_rel <= DFT_RTOL):
        raise PhaseError(f"adjoint identity {adjoint_rel:.3e} > {DFT_RTOL}")
    results["breakdown"] = predict_breakdown(uvw, freqs, image, pix, device)
    return results


def predict_breakdown(uvw, freqs, image, pix, device, **plan_kw) -> dict:
    """Seconds per stage of one predict_visibilities call, synchronized,
    and a profile of its device part."""
    import torch

    from ska_sdp_cip_tpu_torch.ops.gridder import (
        build_predict,
        slot_plan_host_arrays,
        stage_arrays,
    )
    from ska_sdp_cip_tpu_torch.ops.plan import make_plan

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    out = {}
    t = time.perf_counter()
    plan = make_plan(uvw, freqs, image.shape[0], pix, **plan_kw)
    out["plan_seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    host = slot_plan_host_arrays(plan, device, invert=False)
    out["host_arrays_seconds"] = time.perf_counter() - t
    sync()
    t = time.perf_counter()
    arrays = stage_arrays(host, device)
    img = torch.from_numpy(image).to(device)
    sync()
    out["h2d_seconds"] = time.perf_counter() - t
    predict = build_predict(plan)
    predict(arrays, img)  # warm
    sync()
    t = time.perf_counter()
    re, im = predict(arrays, img)
    sync()
    out["predict_device_seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    re.cpu(), im.cpu()
    out["d2h_seconds"] = time.perf_counter() - t
    out["profile_device_part"] = profile_call(lambda: predict(arrays, img),
                                              device)
    return out


def make_dataset(workdir: Path,
                 size=(BENCH_TIMES, BENCH_ANTENNAS, BENCH_CHANNELS),
                 seed: int = 1234) -> tuple:
    """The slice's synthetic point-source dataset: (path, seconds)."""
    from ska_sdp_cip_tpu_torch.io.synth import make_synthetic_dataset

    times, antennas, channels = size
    t0 = time.perf_counter()
    path = make_synthetic_dataset(
        workdir / "obs.vz",
        num_times=times,
        num_antennas=antennas,
        channel_frequencies=np.linspace(*BENCH_FREQS, channels),
        seed=seed,
    )
    return path, time.perf_counter() - t0


def expected_pixel(seed: int, npix: int, asec: float) -> np.ndarray:
    """The brightest synthetic source's pixel (row, column)."""
    return brightest_pixels(seed, npix, asec, within=0.0)[0]


def brightest_pixels(seed: int, npix: int, asec: float,
                     within: float) -> np.ndarray:
    """
    Pixels (row, column) of the synthetic sources whose flux is within
    ``within`` (relative) of the brightest, brightest first.
    """
    lm, flux = source_truth(seed)
    pix = float(np.sin(np.radians(asec / 3600.0)))
    order = np.argsort(-flux)
    keep = order[flux[order] >= (1.0 - within) * flux.max()]
    return np.round(lm[keep] / pix).astype(int) + npix // 2


def source_truth(seed: int, num_sources: int = 5, fov_deg: float = 1.0):
    """The sky of make_synthetic_dataset: (lm (n, 2), flux (n,))."""
    rng = np.random.default_rng(seed)
    half = np.radians(fov_deg) / 2
    lm = rng.uniform(-half, half, size=(num_sources, 2))
    flux = rng.uniform(0.5, 3.0, size=num_sources)
    return lm, flux


def phase_slice(device, path: Path, dataset_seconds: float, seed=1234,
                npix=BENCH_NPIX, asec=BENCH_ASEC, repeats=3) -> dict:
    from ska_sdp_cip_tpu_torch import VisibilityReader, invert_dataset

    reader = VisibilityReader(path)
    num_vis = reader.num_data_rows * reader.num_channels

    def run():
        return invert_dataset(reader, npix, asec, device=device)

    image, first_seconds, launches, walls = timed_calls(run, device,
                                                        repeats)
    wall = statistics.median(walls)

    lm, flux = source_truth(seed)
    pix = float(np.sin(np.radians(asec / 3600.0)))
    bright = int(np.argmax(flux))
    expected = expected_pixel(seed, npix, asec)
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
    require_launches(launches, ("b1", "b2_out_crop"), device, "slice")
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
    from ska_sdp_cip_tpu_torch.invert import (
        StokesIGridderInput,
        pixel_size_lm_from_asec,
    )

    t = time.perf_counter()
    gi = StokesIGridderInput.from_reader(reader)
    weighted = (gi.visibilities.astype(np.complex64)
                * gi.effective_weights().astype(np.float32)).ravel()
    out = {"read_stokes_seconds": time.perf_counter() - t}
    out.update(invert_breakdown(gi.uvw, gi.channel_frequencies, weighted,
                                npix, pixel_size_lm_from_asec(asec), device))
    return out


def invert_breakdown(uvw, freqs, weighted, npix, pix, device,
                     **plan_kw) -> dict:
    """Seconds per stage of one invert of weighted visibilities
    (``dirty_image``'s steps), synchronized."""
    import torch

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

    weighted = np.asarray(weighted, np.complex64).ravel()
    out = {}
    t = time.perf_counter()
    plan = make_plan(uvw, freqs, npix, pix, export_packed=False, **plan_kw)
    out["plan_seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    host = compact_plan_host_arrays(plan, uvw, freqs, device)
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


def phase_major_cycle(device, path: Path, seed=1234, npix=BENCH_NPIX,
                      asec=BENCH_ASEC, num_major=3, minor_iter=100) -> dict:
    """
    ``MeasurementOperator.build`` + ``major_cycle_clean`` on the slice's
    dataset (:func:`run_major_cycle`).
    """
    from ska_sdp_cip_tpu_torch import VisibilityReader
    from ska_sdp_cip_tpu_torch.invert import (
        StokesIGridderInput,
        pixel_size_lm_from_asec,
    )

    t = time.perf_counter()
    gi = StokesIGridderInput.from_reader(VisibilityReader(path))
    weights = gi.effective_weights()
    vis = gi.visibilities.ravel()
    read_seconds = time.perf_counter() - t
    # The dataset's two brightest sources differ in flux by 1.3e-4
    # (seed 1234: 2.65939 and 2.65905), so which of them collects the
    # largest single component depends on their sub-pixel positions:
    # the brightest component must sit at one of the sources within 1%
    # of the brightest flux, and each of those must hold CLEAN flux.
    sources = brightest_pixels(seed, npix, asec, within=0.01)
    out = {"phase": "major_cycle", "read_stokes_seconds": read_seconds}
    out.update(run_major_cycle(
        device, gi.uvw, gi.channel_frequencies, weights, vis, npix,
        pixel_size_lm_from_asec(asec), sources, num_major=num_major,
        minor_iter=minor_iter,
    ))
    return out


def run_major_cycle(device, uvw, freqs, weights, vis, npix, pix, sources,
                    *, num_major=3, minor_iter=100, **plan_kw) -> dict:
    """
    ``MeasurementOperator.build`` + ``major_cycle_clean(num_major,
    minor_iter)`` (the minor cycle ``pick_psf_patch(npix)`` picks),
    gated on the residual (below 0.6 x the dirty peak) and on the
    brightest CLEAN component (at one of ``sources``, pixels (row, col)
    of the sources within 1% of the brightest flux, each holding CLEAN
    flux); then the same cycles again step by step (``hogbom_clean`` +
    ``residual_gradient``, each synchronized) for per-cycle seconds,
    and a profile of one cycle.
    """
    import torch

    from ska_sdp_cip_tpu_torch.models import (
        MeasurementOperator,
        hogbom_clean,
        major_cycle_clean,
    )
    from ska_sdp_cip_tpu_torch.models.clean import pick_psf_patch
    from ska_sdp_cip_tpu_torch.ops.plan import make_plan

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    psf_patch = pick_psf_patch(npix)
    out = {"npix": npix, "num_major": num_major, "minor_iter": minor_iter,
           "psf_patch": psf_patch}
    sync()
    t = time.perf_counter()
    op = MeasurementOperator.build(uvw, freqs, weights, npix, pix,
                                   device=device, **plan_kw)
    sync()
    out["build_seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    make_plan(uvw, freqs, npix, pix, **plan_kw)
    out["plan_seconds"] = time.perf_counter() - t
    out["staging_seconds"] = out["build_seconds"] - out["plan_seconds"]
    t = time.perf_counter()
    staged = op.stage(vis)
    sync()
    out["stage_vis_seconds"] = time.perf_counter() - t

    reset_launches()
    sync()
    t = time.perf_counter()
    model, residual = major_cycle_clean(op, staged, num_major=num_major,
                                        minor_iter=minor_iter)
    sync()
    out["major_cycle_clean_seconds"] = time.perf_counter() - t
    out["launches"] = read_launches()
    require_launches(out["launches"], ("b1", "b2_out_crop", "b2_in_crop",
                                       "b3"), device, "major_cycle")

    psf = op.psf()
    dirty = op.dirty_image(staged)
    dirty_peak = float(dirty.abs().max())
    res_max = float(residual.abs().max())
    model_np = model.cpu().numpy()
    brightest = np.unravel_index(int(np.argmax(model_np)), model_np.shape)
    sources = np.asarray(sources)
    window_flux = [
        float(model_np[max(r - 1, 0) : r + 2, max(c - 1, 0) : c + 2].sum())
        for r, c in sources
    ]
    offset = np.abs(sources - np.asarray(brightest)).max(axis=1)
    out.update({
        "dirty_peak": dirty_peak,
        "residual_max": res_max,
        "residual_over_dirty_peak": res_max / dirty_peak,
        "model_sum": float(model_np.sum()),
        "components": int(np.count_nonzero(model_np)),
        "brightest_component": [int(p) for p in brightest],
        "brightest_sources": sources.tolist(),
        "model_flux_3x3_at_sources": window_flux,
        "finite": bool(np.isfinite(model_np).all()
                       and torch.isfinite(residual).all()),
    })
    del model_np
    if not out["finite"]:
        raise PhaseError("major cycle gave non-finite values")
    if not res_max < 0.6 * dirty_peak:
        raise PhaseError(f"residual {res_max:.4g} >= 0.6 x dirty peak "
                         f"{dirty_peak:.4g}")
    if offset.min() > 1 or min(window_flux) <= 0:
        raise PhaseError(f"brightest component at {brightest}, brightest "
                         f"sources at {sources.tolist()} with CLEAN flux "
                         f"{window_flux}")

    def cycle(state):
        delta, _ = hogbom_clean(state["res"], psf, gain=0.1,
                                max_iter=minor_iter, psf_patch=psf_patch)
        sync()
        state["minor"].append(time.perf_counter() - state["t"])
        state["model"] = state["model"] + delta
        state["res"] = -op.residual_gradient(state["model"], staged)

    state = {"model": torch.zeros_like(dirty), "res": dirty, "minor": []}
    cycles = []
    for _ in range(num_major):
        sync()
        state["t"] = t = time.perf_counter()
        cycle(state)
        sync()
        cycles.append(time.perf_counter() - t)
    out["cycle_seconds"] = cycles
    out["minor_cycle_seconds"] = list(state["minor"])
    out["residual_gradient_seconds"] = [
        c - m for c, m in zip(cycles, state["minor"])
    ]
    out["profile_one_cycle"] = profile_call(
        lambda: (state.update(t=time.perf_counter()), cycle(state)), device
    )
    if device.type == "cuda":
        out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def phase_b6(device, grids=(PROD_NGRID, BENCH_NGRID)) -> dict:
    """
    The tiled-input probe (``probes/fft_tiled.py``) at each grid: B6
    against its plain version (exact), B2 on tiled input against B2 on
    row-major input (exact), and the four times of the counterpart
    ``scripts/fft_tiled_probe.py``.
    """
    from ska_sdp_cip_tpu_torch.probes import fft_tiled

    reset_launches()
    runs = [fft_tiled.run(n, device=device, iters=3) for n in grids]
    launches = read_launches()
    require_launches(launches, ("b6", "b2_tiled"), device, "b6")
    return {"phase": "b6", "runs": runs, "launches": launches}


def library_fft(ngrid: int, device, iters: int = 3) -> dict:
    """``library_ms`` of the probes' pass (``probes/common.py:
    out_crop_pass``, the same seeded input as P1, P2 and the tiled
    probe): one ``torch.fft.ifft`` along dim 0 of the complex64 input,
    packed outside the timing, uncentred and uncropped."""
    import torch

    from ska_sdp_cip_tpu_torch.probes.common import cuda_ms, out_crop_pass

    s = out_crop_pass(ngrid, device)
    x = torch.complex(s.re, s.im)
    del s
    return {"library_ms": cuda_ms(lambda: torch.fft.ifft(x, dim=0),
                                  iters=iters),
            "library_call": f"torch.fft.ifft(complex64 ({ngrid}, {ngrid}), "
                            "dim=0): uncentred, uncropped"}


def probe_work(g: dict, m: int) -> dict:
    """(bytes, flops) of the function each P2 variant computes at a
    probe's geometry ``g`` and width ``m`` (P1 and ``full``: the
    out-cropped pass, B2's function): each input read once, each output
    written once, 5 n log2 n flops a length-n transform and 6 a twiddled
    element. The dense design's n1 + n2 complex MACs a point are its
    cost, not the function's."""
    n1, n2, n1i = g["n1"], g["n2"], g["n1i"]
    n = n1 * n2
    x, z, out = (8 * m * r for r in (n1i * n2, n, g["rows_out"]))
    s1 = 5.0 * n * math.log2(n1) * m
    tw = 6.0 * n * m
    s2 = 5.0 * n * math.log2(n2) * m
    return {"load": (2 * x, 0.0), "s1": (x + z, s1), "s1tw": (x + z, s1 + tw),
            "s2": (z + out, s2), "full": (x + out, 5.0 * n * math.log2(n) * m)}


def phase_fft_probes(device, ngrid=PROD_NGRID) -> dict:
    """
    P1 (``cp.async`` ring depths), P2 (stage ablation) at ``ngrid`` and
    P3 (the shared-memory maximum), each checked against its plain
    version inside the probe.
    """
    from ska_sdp_cip_tpu_torch.probes import (
        fft_ablation,
        fft_async_fetch,
        smem,
    )

    reset_launches()
    out = {"phase": "fft_probes",
           "p1": fft_async_fetch.run(ngrid, device=device, iters=3),
           "p2": fft_ablation.run(ngrid, device=device, iters=3)}
    if device.type == "cuda":
        out["p3"] = smem.run(device=device)
    out["launches"] = read_launches()
    if device.type == "cuda":
        out.update(library_fft(ngrid, device))
    require_launches(out["launches"],
                     [f"p1_S{k}" for k in fft_async_fetch.STAGES]
                     + [f"p2_{v}" for v in fft_ablation.VARIANTS] + ["p3"],
                     device, "fft_probes")
    return out


def production_visibilities(num_times=PROD_TIMES, num_antennas=PROD_ANTENNAS,
                            num_channels=PROD_CHANNELS):
    """production_bench.py's inputs: uvw, freqs, noise vis and weights."""
    return bench_visibilities(num_times, num_antennas, num_channels, seed=7,
                              uvw_seed=11)


def point_sources(npix: int, seed: int = 5, num: int = 5):
    """Seeded point sources in the field's central half: pixels
    (row, col) and fluxes."""
    rng = np.random.default_rng(seed)
    pixels = rng.integers(npix // 4, 3 * npix // 4, size=(num, 2))
    return pixels, rng.uniform(0.5, 3.0, size=num)


def sparse_predict_dft(uvw, freqs, pixels, flux, pix, npix, rows=None,
                       chans=None) -> np.ndarray:
    """
    ``ops/dft.py:predict_dft`` (float64) of an image that is zero but at
    ``pixels``: all (nrow, nchan) visibilities, or the samples
    (``rows``, ``chans``) only.
    """
    from ska_sdp_cip_tpu_torch.ops.dft import SPEED_OF_LIGHT

    x = (pixels[:, 0] - npix // 2) * pix
    y = (pixels[:, 1] - npix // 2) * pix
    r2 = x * x + y * y
    nm1 = -r2 / (1.0 + np.sqrt(1.0 - r2))
    lf = np.asarray(freqs, np.float64) / SPEED_OF_LIGHT
    uvw = np.asarray(uvw, np.float64)
    if rows is None:
        u, v, w = (uvw[:, None, :] * lf[None, :, None]).transpose(2, 0, 1)
    else:
        u, v, w = (uvw[rows] * lf[chans, None]).T
    phase = u[..., None] * x + v[..., None] * y - w[..., None] * nm1
    return (flux / (nm1 + 1.0) * np.exp(-2j * np.pi * phase)).sum(-1)


def plan_summary(plan) -> dict:
    return {"sigma": plan.sigma, "ngrid": plan.ngrid,
            "support": plan.support, "nplanes": plan.nplanes,
            "plane_group": plan.plane_group, "num_groups": plan.num_groups,
            "nalloc": [plan.nalloc_x, plan.nalloc_y],
            "num_blocks": plan.num_blocks, "num_vis_slots": plan.num_vis,
            "num_vis_data": plan.num_vis_data}


def timed_calls(fn, device, repeats: int) -> tuple:
    """(first result, first seconds, launches of the first call, walls of
    ``repeats`` more calls), each call synchronized."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    reset_launches()
    sync()
    t0 = time.perf_counter()
    first = fn()
    sync()
    first_seconds = time.perf_counter() - t0
    launches = read_launches()
    walls = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        walls.append(time.perf_counter() - t0)
    return first, first_seconds, launches, walls


def phase_production_invert(device, problem, npix=PROD_NPIX,
                            asec=PROD_ASEC, repeats=3,
                            dft_pixels=256) -> tuple:
    """
    ``dirty_image`` at the production configuration: launch counts of
    one call, the median wall of ``repeats`` calls after it, a float64
    DFT check at ``dft_pixels`` random pixels (1e-4 of the sampled
    max), B1 against its plain version on the plan's largest plane
    group, a per-stage breakdown and a profile of one call. Returns the
    phase's results and the image (for predict's adjoint identity).
    """
    from ska_sdp_cip_tpu_torch.ops.gridder import dirty_image

    uvw, freqs, vis, wgt = problem
    pix = float(np.sin(np.radians(asec / 3600.0)))

    def run():
        return dirty_image(uvw, freqs, vis, wgt, npix, pix, sigma="auto",
                           device=device)

    image, first, launches, walls = timed_calls(run, device, repeats)
    require_launches(launches, ("b1", "b2_out_crop"), device,
                     "production invert")
    pts = np.random.default_rng(1).integers(0, npix, size=(dft_pixels, 2))
    ref = dft_at_pixels(uvw, freqs, vis * wgt, pts, pix, npix, device)
    err = float(np.abs(image[pts[:, 0], pts[:, 1]] - ref).max())
    plan, arrays, re_s, im_s = staged_problem(uvw, freqs, vis, wgt, npix,
                                              asec, device, sigma="auto")
    k = largest_group(plan)
    b1_check = {"group": k, **compare_group(
        plan, group_args(plan, arrays, re_s, im_s, k), time_it=True)}
    del arrays, re_s, im_s
    out = {
        "phase": "production", "part": "invert", "npix": npix,
        "pixel_asec": asec, "num_vis": int(vis.size),
        "plan": plan_summary(plan),
        "first_call_seconds": first, "wall_seconds": walls,
        "median_wall_seconds": statistics.median(walls),
        "launches": launches,
        "dft_check": {"pixels": dft_pixels, "max_abs_err": err,
                      "rel_to_sampled_max": err / float(np.abs(ref).max())},
        "b1_check": b1_check,
        "finite": bool(np.isfinite(image).all()),
        "shape": list(image.shape),
    }
    if image.shape != (npix, npix) or not out["finite"]:
        raise PhaseError("production image has the wrong shape or "
                         "non-finite values")
    if not out["dft_check"]["rel_to_sampled_max"] <= DFT_RTOL:
        raise PhaseError(f"production image vs DFT "
                         f"{out['dft_check']['rel_to_sampled_max']:.3e}")
    out["breakdown"] = invert_breakdown(uvw, freqs, vis * wgt, npix, pix,
                                        device, sigma="auto")
    out["profile"] = profile_call(run, device)
    return out, image


def phase_production_predict(device, problem, dirty, npix=PROD_NPIX,
                             asec=PROD_ASEC, repeats=3,
                             samples=4096, spread=2) -> dict:
    """
    ``predict_visibilities`` at the production configuration: the
    adjoint identity <dirty_image(v), I> = Re <v, predict(I)> for a
    noise image I (float64 dot products on the host, rel 1e-4), also
    read on ``spread`` more dirty images (B1's atomics move the
    image's last bits from run to run), with both operators' B2 passes
    replaced by the plain version and by the exact transform
    (:func:`adjoint_witness`), and for I = the dirty image itself
    (no cancellation; rel 1e-4); a
    sparse image of five seeded point sources against a float64 DFT of
    its nonzero pixels at ``samples`` random visibilities (1e-4 of the
    max); B3 against its plain version on the plan's largest plane
    group of random planes; the median wall of ``repeats`` calls,
    launch counts, a breakdown and a profile of the device part.
    """
    import torch

    from ska_sdp_cip_tpu_torch.ops.gridder import (
        dirty_image,
        predict_visibilities,
        slot_plan_host_arrays,
        stage_arrays,
    )
    from ska_sdp_cip_tpu_torch.ops.plan import make_plan

    uvw, freqs, vis, wgt = problem
    pix = float(np.sin(np.radians(asec / 3600.0)))
    gen = torch.Generator().manual_seed(79)
    image = torch.randn((npix, npix), generator=gen).numpy()

    def run(img=image):
        return predict_visibilities(uvw, freqs, img, pix, sigma="auto",
                                    device=device)

    model, first, launches, walls = timed_calls(run, device, repeats)
    require_launches(launches, ("b3", "b2_in_crop"), device,
                     "production predict")
    weighted = (vis * wgt).astype(np.complex128)
    lhs = float(np.vdot(image.astype(np.float64), dirty.astype(np.float64)))
    rhs = float(np.real(np.vdot(model.astype(np.complex128), weighted)))
    # B1 adds with atomics, so the dirty image changes in its last bits
    # from run to run, and the noise image's dot product cancels: the
    # identity read on ``spread`` more dirty images shows that spread.
    lhs_more = [
        float(np.vdot(image.astype(np.float64),
                      dirty_image(uvw, freqs, vis, wgt, npix, pix,
                                  sigma="auto", device=device)
                      .astype(np.float64)))
        for _ in range(spread)
    ]
    # I = the dirty image: <D, D> has no cancellation, so this reading
    # is the operators' float32 mismatch itself.
    d64 = dirty.astype(np.float64)
    unit = (d64 / np.linalg.norm(d64)).astype(np.float32)
    lhs_d = float(np.vdot(unit.astype(np.float64), d64))
    rhs_d = float(np.real(np.vdot(run(unit).astype(np.complex128),
                                  weighted)))
    plan = make_plan(uvw, freqs, npix, pix, sigma="auto")
    witness = adjoint_witness(problem, image, plan.ngrid, pix, device)
    pixels, flux = point_sources(npix)
    sparse = np.zeros((npix, npix), np.float32)
    sparse[pixels[:, 0], pixels[:, 1]] = flux
    got = run(sparse)
    rng = np.random.default_rng(2)
    rows = rng.integers(0, len(uvw), size=samples)
    chans = rng.integers(0, len(freqs), size=samples)
    ref = sparse_predict_dft(uvw, freqs, pixels, flux, pix, npix, rows,
                             chans)
    err = float(np.abs(got[rows, chans] - ref).max())
    arrays = stage_arrays(slot_plan_host_arrays(plan, device), device)
    grids = random_grids(plan, device, seed=6)
    k = largest_group(plan)
    b3_check = {"group": k, **compare_degrid(plan, arrays, grids, k,
                                              time_it=True)}
    del arrays, grids
    out = {
        "phase": "production", "part": "predict", "npix": npix,
        "num_vis": int(model.size),
        "adjoint_lhs": lhs, "adjoint_rhs": rhs,
        "adjoint_rel": abs(lhs - rhs) / abs(lhs),
        "adjoint_rel_other_dirty_images": [abs(x - rhs) / abs(x)
                                           for x in lhs_more],
        # |lhs| / (|I| |D|): how far the noise image's dot product
        # cancels, which scales every float32 error in D up to the
        # identity's reading.
        "adjoint_cancellation": abs(lhs) / float(
            np.linalg.norm(image.astype(np.float64)) * np.linalg.norm(d64)),
        "adjoint_witness": witness,
        "adjoint_rel_dirty_image": abs(lhs_d - rhs_d) / abs(lhs_d),
        "sparse_dft_check": {"samples": samples, "max_abs_err": err,
                             "rel_to_max": err / float(np.abs(ref).max())},
        "b3_check": b3_check,
        "first_call_seconds": first, "wall_seconds": walls,
        "median_wall_seconds": statistics.median(walls),
        "launches": launches,
        "finite": bool(np.isfinite(model).all() and np.isfinite(got).all()),
    }
    if not (out["finite"] and out["adjoint_rel"] <= DFT_RTOL
            and out["adjoint_rel_dirty_image"] <= DFT_RTOL):
        raise PhaseError(f"production adjoint identity "
                         f"{out['adjoint_rel']:.3e} (I = the dirty image: "
                         f"{out['adjoint_rel_dirty_image']:.3e}) > "
                         f"{DFT_RTOL}")
    if not out["sparse_dft_check"]["rel_to_max"] <= DFT_RTOL:
        raise PhaseError(f"production predict vs DFT "
                         f"{out['sparse_dft_check']['rel_to_max']:.3e}")
    out["breakdown"] = predict_breakdown(uvw, freqs, image, pix, device,
                                         sigma="auto")
    return out


def adjoint_witness(problem, image, ngrid: int, pix: float, device) -> dict:
    """
    The production adjoint identity for the noise image ``image`` with
    every B2 pass of both operators replaced (:func:`b2_replaced`) by
    B2's plain version (``plain_b2``) and by the exact transform
    (``exact_b2``): a fresh dirty image and a fresh predict each. If
    the reading stays where the kernel's is, B2 does not carry the
    offset.
    """
    from ska_sdp_cip_tpu_torch.ops.gridder import (
        dirty_image,
        predict_visibilities,
    )

    uvw, freqs, vis, wgt = problem
    npix = image.shape[0]
    weighted = (vis * wgt).astype(np.complex128)
    out = {}
    for name, pass_fn in (("plain_b2", plain_b2(ngrid, device)),
                          ("exact_b2", exact_b2)):
        with b2_replaced(pass_fn):
            dirty = dirty_image(uvw, freqs, vis, wgt, npix, pix,
                                sigma="auto", device=device)
            model = predict_visibilities(uvw, freqs, image, pix,
                                         sigma="auto", device=device)
        lhs = float(np.vdot(image.astype(np.float64),
                            dirty.astype(np.float64)))
        rhs = float(np.real(np.vdot(model.astype(np.complex128), weighted)))
        out[name] = {"adjoint_lhs": lhs, "adjoint_rhs": rhs,
                     "adjoint_rel": abs(lhs - rhs) / abs(lhs)}
    return out


def phase_production_major_cycle(device, problem, npix=PROD_NPIX,
                                 asec=PROD_ASEC, num_major=3,
                                 minor_iter=100) -> dict:
    """
    ``MeasurementOperator.build`` + ``major_cycle_clean`` at the
    production configuration (the Clark minor cycle: ``psf_patch``
    2048 at 10240 px) on visibilities of five seeded point sources at
    pixel centres (:func:`run_major_cycle`'s gates).
    """
    uvw, freqs, _, wgt = problem
    pix = float(np.sin(np.radians(asec / 3600.0)))
    pixels, flux = point_sources(npix)
    vis = sparse_predict_dft(uvw, freqs, pixels, flux, pix, npix)
    order = np.argsort(-flux)
    sources = pixels[order[flux[order] >= 0.99 * flux.max()]]
    out = {"phase": "production", "part": "major_cycle",
           "source_pixels": pixels.tolist(), "source_flux": flux.tolist()}
    out.update(run_major_cycle(
        device, uvw, freqs, wgt, vis.astype(np.complex64).ravel(), npix,
        pix, sources, num_major=num_major, minor_iter=minor_iter,
        sigma="auto",
    ))
    return out


def kernel_entry(name, source, replaces, launches, by_path=None, **nums):
    """One row of the ``kernels`` line."""
    entry = {"name": name, "route": "cuda",
             "source": f"ska_sdp_cip_tpu_torch/csrc/{source}",
             "replaces": replaces, "launches": launches}
    if by_path is not None:
        entry["launches_by_path"] = by_path
    entry.update(nums)
    return entry


def kernels_line(b1, b2, b3, b6, probes, production, by_path) -> list:
    """
    One entry per kernel of the port: launches on its path (the main
    paths for B1-B3, the probe phases for B6, tiled B2 and P1-P3), its
    error against its plain version, its time, the plain version's, the
    bound and the library call's time (null where no PyTorch call
    computes the same function), all from this run; B1-B3 also at the
    production shapes (``production``: the B1 and B3 checks of the
    production phase, B2's production cases of the b2 phase).
    """
    row_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
    prod_keys = ("max_abs_err", "max_rel_err", "ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms")
    b2_keys = ("n", "m", "rows_in", *prod_keys, "two_launch_floor_ms",
               "gb_per_s", "gb_per_s_with_z", "first_design_ms")

    def count(key, path):
        return by_path[path][key]

    def paths(key):
        return {k: v[key] for k, v in by_path.items()}

    b2_cases = {(c["pass"], c["m"]): c for c in b2["cases"]}
    tiled = b6["runs"][0]
    p1, p2 = probes["p1"], probes["p2"]
    library = probes["library_ms"]
    work = probe_work(p2, p2["ngrid"])
    fused = "ska_sdp_cip_tpu/ops/fft_pallas.py"
    entries = [
        kernel_entry(
            "grid_planes", "grid.cu",
            "ska_sdp_cip_tpu/ops/pallas_gridder.py:298",
            count("b1", "slice"), paths("b1"),
            **{k: b1["bench"][k] for k in row_keys},
            production={k: production["b1"][k]
                        for k in ("group", "G", "active_blocks", *prod_keys)},
        ),
    ]
    for crop, path in (("out_crop", "slice"), ("in_crop", "major_cycle")):
        bench = b2_cases[(crop, BENCH_NGRID)]
        entries.append(kernel_entry(
            f"fft_first_axis_fused[{crop}]", "fft_fused.cu", f"{fused}:238",
            count(f"b2_{crop}", path), paths(f"b2_{crop}"),
            **{k: bench[k] for k in row_keys},
            library_call=bench["library_call"],
            first_design_ms=bench["first_design_ms"],
            production=[{k: c[k] for k in b2_keys} for c in b2["production"]
                        if c["pass"] == crop],
        ))
    n = tiled["ngrid"]
    entries += [
        kernel_entry(
            "fft_first_axis_fused[tiled]", "fft_fused.cu", f"{fused}:263",
            b6["launches"]["b2_tiled"], exact=tiled["tiled_exact"],
            max_abs_err=tiled["tiled_max_abs_err"], ms=tiled["tiled_ms"],
            plain_ms=tiled["tiled_plain_ms"], ngrid=n,
            **bound(8 * n * (n + tiled["rows_out"]), 5 * n * math.log2(n) * n),
            library_ms=library, library_call=probes["library_call"],
        ),
        kernel_entry(
            "degrid_planes", "degrid.cu",
            "ska_sdp_cip_tpu/ops/pallas_gridder.py:458",
            count("b3", "major_cycle"), paths("b3"),
            **{k: b3["bench"][k] for k in row_keys},
            production={k: production["b3"][k]
                        for k in ("group", "G", "active_blocks", *prod_keys)},
        ),
        kernel_entry(
            "pretile_first_axis", "pretile.cu", f"{fused}:310",
            b6["launches"]["b6"], exact=tiled["pretile_exact"],
            max_abs_err=tiled["pretile_max_abs_err"], ms=tiled["pretile_ms"],
            plain_ms=tiled["pretile_plain_ms"], ngrid=n,
            **bound(2 * 8 * n * n),
            library_ms=tiled["pretile_plain_ms"],
            library_call="permute().contiguous() (the plain version)",
        ),
    ]
    for stages, case in p1["stages"].items():
        entries.append(kernel_entry(
            f"fft_async_fetch[{stages}]", "fft_probes.cu",
            "scripts/fft_split_fetch_probe.py:71",
            probes["launches"][f"p1_S{stages}"],
            exact=case["exact_vs_dense"], max_abs_err=case["max_abs_err"],
            ms=case["ms"], plain_ms=p1["plain_ms"], ngrid=p1["ngrid"],
            **bound(*work["full"]), library_ms=library,
        ))
    for variant, case in p2["variants"].items():
        entries.append(kernel_entry(
            f"fft_ablation[{variant}]", "fft_probes.cu",
            "scripts/fft_ablation_probe.py:63",
            probes["launches"][f"p2_{variant}"],
            **({"exact": case["exact"]} if "exact" in case else {}),
            max_abs_err=case["max_abs_err"], ms=case["ms"],
            plain_ms=case["plain_ms"], ngrid=p2["ngrid"],
            **bound(*work[variant]),
            library_ms=library if variant == "full" else None,
        ))
    p3 = probes["p3"]
    entries.append(kernel_entry(
        "smem_probe", "smem_probe.cu", "scripts/vmem_probe.py:17",
        probes["launches"]["p3"], exact=p3["read_back_exact"],
        max_abs_err=p3["max_abs_err"],
        ms=p3["ms"], plain_ms=p3["plain_ms"], max_bytes=p3["max_bytes"],
        optin_attribute_bytes=p3["optin_attribute_bytes"],
        **bound(p3["max_bytes"]), library_ms=None,
    ))
    return entries


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
    bench = bench_problem(device)
    b1 = phase_b1(device, bench)
    emit(b1)
    b2 = phase_b2(device, widths=(BENCH_NGRID, BENCH_NPIX, BENCH_NPIX - 2))
    b2["production"] = phase_b2(device, PROD_NGRID, PROD_NPIX,
                                iters=5)["cases"]
    emit(b2)
    b3 = phase_b3(device, bench)
    emit(b3)
    emit(phase_e2e_small(device))
    pred = phase_predict(device, bench)
    emit(pred)
    del bench
    with tempfile.TemporaryDirectory() as tmp:
        path, dataset_seconds = make_dataset(Path(tmp))
        sl = phase_slice(device, path, dataset_seconds)
        emit(sl)
        mc = phase_major_cycle(device, path)
        emit(mc)
    b6 = phase_b6(device)
    emit(b6)
    probes = phase_fft_probes(device)
    emit(probes)
    problem = production_visibilities()
    p_inv, dirty = phase_production_invert(device, problem)
    emit(p_inv)
    p_pred = phase_production_predict(device, problem, dirty)
    emit(p_pred)
    del dirty
    p_mc = phase_production_major_cycle(device, problem)
    emit(p_mc)
    production = {"b1": p_inv["b1_check"], "b3": p_pred["b3_check"]}
    emit({"kernels": kernels_line(b1, b2, b3, b6, probes, production, {
        "slice": sl["launches"], "predict": pred["bench"]["launches"],
        "major_cycle": mc["launches"],
        "production_invert": p_inv["launches"],
        "production_predict": p_pred["launches"],
        "production_major_cycle": p_mc["launches"],
    })})
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
