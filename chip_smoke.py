#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (``ska_sdp_cip_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``ska_sdp_cip_tpu_torch/csrc`` with nvcc
(one nvcc per source, started together, into ``build/torch_kernels/``),
then runs these phases and prints one JSON object per phase:

1. ``device``: card name, ``nvidia-smi`` name and power limit, build time;
   then ``planner``: the native planner engine (``csrc/cip_native.cpp``,
   built with the host C++ compiler; the phase fails unless it is in
   use): its build seconds and compiler, and at the bench workload and
   the production configuration its plans against the numpy planner's
   (every field; the exported columns, phases within 1e-6), each
   planner's seconds, and ``stage_slot_vis`` and the weighting density
   on each;
2. ``b1``: the gridding kernel (B1, which folds onto the periodic grid
   itself) against its folded plain version, on every plane group of
   the small plans (:func:`small_plans`: every tile an edge tile,
   footprints across the periodic edge beside interior tiles, split
   hot tiles; G = 1 and 2) and on the bench plan's largest plane group,
   with w-stacking (G = 2) and without it (G = 1, B4), each launched
   twice and required to give the same bits, each with its time, a
   zeroing of its planes that the kernel no longer needs (``zero_ms``),
   the time of the fold that left the path (``fold_ms``) and a bound
   that does not depend on the design (:func:`gridding_work`), the
   G = 2 group also at 2 to 32 blocks a column piece
   (``chunk_sweep_ms``), and both work lists' lengths
   (``bench_geometry``); then the whole bench-size image
   of the noise-like bench visibilities against a float64 DFT at 256
   random pixels (``bench_dft``, gated at the 1e-4 contract);
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
4. ``b3``: the degridding kernel (B3, reading the periodic grid)
   against its folded plain version on random planes, on the same
   plans and groups as ``b1`` (G = 1 at bench size: B5), with the
   unfold that left the path as ``fold_ms`` and the same chunk sweep;
5. ``e2e_small``: ``dirty_image`` on the card against the explicit DFT
   (``dirty_image_dft``) on a 256 px check plan, without w-stacking
   (through B4) and with it (B1), with the launch counts of each;
6. ``predict``: ``predict_visibilities`` on the card against
   ``predict_dft`` on a 256 px check plan (through B5, then B3, with
   launch counts); at bench size the adjoint
   identity <invert(v), I> = Re <v, predict(I)> (float64 dot products
   on the host), the median wall of 3 calls and the kernels' launch
   counts;
7. ``slice``: ``invert_dataset(VisibilityReader(obs), 2048, 5.0,
   device="cuda")`` on a 5,836,800-visibility synthetic dataset, with
   the kernels' launch counts, the brightest source's peak position, a
   float64 DFT spot check of 448 pixels, the median wall time of 3 runs
   after a warm run, one more call that must give the first's bits, a
   per-stage breakdown (with the planner that ran,
   whether the image came down into a pinned buffer, and the seconds
   of the path not taken in each direction: the pageable download and
   the pinned upload) and a profile of one call; then ``ms``: the same
   dataset written as a MeasurementSet v2 (:func:`write_measurement_set`:
   DATA in TiledShapeStMan, FLAG, WEIGHT_SPECTRUM and UVW in
   TiledColumnStMan, TIME in IncrementalStMan, the subtables in
   StandardStMan; its seconds, bytes and tile shapes), read back by
   ``VisibilityReader`` through the casacore-free ``_NativeMSBackend``
   (every column bit-equal to the VZ's, seconds per column),
   ``tpu-cip-ingest-torch`` at the default and at 10000-row blocks (each
   VZ bit-equal to the source), ``tpu-cip-torch obs.ms`` on the card
   against the VZ's ``invert_dataset`` (bit for bit, and at rtol 1e-5,
   atol 1e-5 of the max) with B1's and B2's launches equal to ``slice``'s, the median CLI
   wall of 3 calls after a warm one, the partitioned reads of a sharded
   run and of the reorder (each sub-reader decodes the MS again) and a
   breakdown with the MS read + Stokes beside the VZ's;
8. ``major_cycle``: ``MeasurementOperator.build`` + ``major_cycle_clean(
   num_major=3, minor_iter=100)`` on the same dataset, gated on the
   residual (below 0.6 x the dirty peak) and on the brightest CLEAN
   component (at the brightest source's pixel), with the plan and
   staging seconds, the seconds of each major cycle, the kernels'
   launch counts and a profile of one cycle; then ``tiles``: the
   dataset reordered by ``tpu-cip-reorder-uvw-torch`` and inverted from
   the tile store by ``invert_tile_chunks`` on the card, against
   ``invert_dataset`` (atol 1e-4 of the max, rtol 1e-3) and the float64
   DFT (1e-4), with the reorder's and the invert's seconds; then
   ``sharded``: the multi-device path on a process group of one rank
   (NCCL for the card's tensors, gloo for the host's, over a TCP store
   on the loopback; one ``all_reduce`` checked) with 4 shards sharing
   the card, so every collective runs: ``sharded_invert_dataset`` on
   the same dataset in both FFT modes (``replicated``: per-shard
   transforms, images summed; ``distributed``: plane grids
   reduce-scattered, B2 on column slabs of N/4 and npix/4 with an
   all-to-all between the passes) against ``invert_dataset`` at rtol
   1e-5, atol 1e-5 of the max, with walls and a breakdown (load, plan,
   stage, device, collectives); both modes at the production
   configuration (below) against ``invert_dataset``, and that
   ``invert_dataset`` against itself, bit for bit; the Hogbom
   ``sharded_major_cycle_clean`` (3 cycles of 50) in both modes against
   ``major_cycle_clean`` (model within 2e-4, residual within 2e-3 of
   the residual's max); ``sharded_invert_tile_chunks`` on the tiles in
   both modes against ``invert_tile_chunks``; ``tpu-cip-torch -d all``
   under ``torchrun --standalone --nproc-per-node 1`` (its image and its
   ``task-list.json``); and B2 against its plain version at the slab
   widths (bench m = 1024 and 512, production m = 3840 and 2560, both
   crops) with the bound and ``torch.fft``'s time;
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
    largest plane group, median wall of 3 calls, one more call bit-equal
    to the first, breakdown, launch counts, profile),
    ``predict_visibilities`` (the adjoint identity, also on two more
    dirty images, which must be bit-equal to the first,
    with a witness on three noise images that replaces B2 by its plain
    version and by the exact transform and swaps predict's pass order,
    and for the dirty image as I; five point sources
    against a float64 DFT at 4096 visibilities, B3
    against its plain version on the largest plane group, median wall,
    breakdown) and the major cycle on the Clark minor
    cycle (``psf_patch`` 2048) on visibilities of five point sources,
    with the ``major_cycle`` gates; the noise image's adjoint identity is
    gated as |lhs - rhs| / (|I| |D|) <= 1e-6, the dirty image's as
    |lhs - rhs| / |lhs| <= 1e-4;
12. ``solvers`` (three parts): ``cli``, ``tpu-cip-torch`` in process
    on the slice's dataset at 2048 px (robust and uniform dirty images
    against a float64 DFT of the reweighted visibilities; ``--clean 2
    --algorithm multiscale`` with the ``major_cycle`` gates; ``--clean
    1 --algorithm fista`` for 3 iterations), each call's wall and
    launches; ``production_multiscale``, ``multiscale_clean`` (scales
    0 2 4 8, 2 cycles of 100, the Clark multiscale path) on the
    production major cycle's operator and sources with the
    ``major_cycle`` gates, the seconds of the scale convolutions, the
    cross-PSF windows, each cycle's minor cycle and residual gradient,
    ``_conv_same``'s time (float32, and with TF32 allowed), peak device
    memory and a profile of one cycle; ``production_fista``,
    ``fista_clean`` (3 iterations) on the same operator: the power
    method's seconds, seconds per iteration, step size and trace.

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
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

#: Tolerances (relative to the reference's max magnitude).
KERNEL_RTOL = 1e-5  # kernel vs its plain version, both float32 on the card
DFT_RTOL = 1e-4  # gridder vs explicit DFT: the epsilon=1e-4 contract
#: The production adjoint identity of a noise image I, read as
#: |lhs - rhs| / (|I| |D|) (D the dirty image): its dot product cancels,
#: so the reading relative to |lhs| magnifies float32 rounding (C3).
ADJOINT_NORM_TOL = 1e-6

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

    def run(re, im, f, *, out=None, **kw):
        got = pass_fn(re, im, f, **kw)
        if out is None:
            return got
        for dst, src in zip(out, got):  # predict's pass into its stack
            dst.copy_(src)
        return out

    saved = gridder.fft_first_axis_fused, fft_cuda.fft_first_axis_fused
    gridder.fft_first_axis_fused = fft_cuda.fft_first_axis_fused = run
    try:
        yield
    finally:
        gridder.fft_first_axis_fused, fft_cuda.fft_first_axis_fused = saved


def gridding_work(plan, ids, G: int, *, degrid: bool) -> tuple:
    """Bytes and flops of one B1 (``degrid=False``) or B3 launch over the
    active blocks ``ids``, whatever the kernel's design: each slot's three
    packed floats and visibility (B1) or accumulator, read and written
    (B3), once; for B1 the 2G periodic N x N planes the caller receives,
    written once (the patches land in them, so they add no bytes); for
    B3 each distinct tile's 2G patch_x x patch_y float32 window, read
    once. Two FMAs (re, im) per footprint cell and plane."""
    slots = int(plan.block_len[ids].sum())
    if degrid:
        tiles = len(np.unique(plan.block_ox[ids].astype(np.int64)
                              * plan.nalloc_y + plan.block_oy[ids]))
        nbytes = slots * (12 + 16) + tiles * 2 * G * plan.patch_x \
            * plan.patch_y * 4
    else:
        nbytes = slots * (12 + 8) + 2 * G * plan.ngrid ** 2 * 4
    return nbytes, 4.0 * slots * G * plan.support ** 2


#: The host clock when the script started; each phase's line gives the
#: seconds since then at its end (``elapsed_seconds``).
START = time.perf_counter()


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj["elapsed_seconds"] = time.perf_counter() - START
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


def group_chunks(plan, arrays, k, chunk_blocks=None):
    """Plane group ``k``'s B3 chunk table on the arrays' device: the
    staged one, or one cut at ``chunk_blocks`` blocks a chunk."""
    import torch

    from ska_sdp_cip_tpu_torch.ops.gridder import (
        group_active_blocks,
        group_tile_chunks,
        tile_chunks,
    )

    if chunk_blocks is None:
        count = len(group_tile_chunks(plan)[k])
        return arrays["group_chunks"][k, :count]
    table = tile_chunks(plan, group_active_blocks(plan)[k], chunk_blocks)
    return torch.from_numpy(table).to(arrays["packed"].device)


def group_grid_chunks(plan, arrays, k, chunk_blocks=None):
    """Plane group ``k``'s B1 work list on the arrays' device: the staged
    one, or one cut at ``chunk_blocks`` blocks a column piece."""
    import torch

    from ska_sdp_cip_tpu_torch.ops import gridder

    if chunk_blocks is None:
        count = len(gridder.group_grid_chunks(plan)[k])
        return arrays["group_grid_chunks"][k, :count]
    table = gridder.grid_chunks(plan, gridder.group_active_blocks(plan)[k],
                                chunk_blocks)
    return torch.from_numpy(table).to(arrays["packed"].device)


#: Blocks a chunk at which the b1 and b3 phases time the bench group:
#: the measurement behind ``ops/gridder.py:CHUNK_BLOCKS``.
CHUNK_SWEEP = (2, 4, 8, 16, 32)


def chunk_sweep(plan, arrays, k, launch, table=group_chunks) -> dict:
    """``launch(chunks)``'s time on plane group ``k`` with the work list
    ``table(plan, arrays, k, R)`` cut at each R of :data:`CHUNK_SWEEP`
    (on the card), and each list's length."""
    if arrays["packed"].device.type != "cuda":
        return {}
    from ska_sdp_cip_tpu_torch.probes.common import cuda_ms

    out = {}
    for blocks in CHUNK_SWEEP:
        chunks = table(plan, arrays, k, blocks)
        out[str(blocks)] = cuda_ms(lambda: launch(chunks), iters=3)
        out[f"chunks_{blocks}"] = int(chunks.shape[0])
    return out


def same_bits(a, b) -> bool:
    """Two float32 tensors equal bit for bit (NaNs and signed zeros
    included), on their device."""
    import torch

    return (a.shape == b.shape and a.dtype == b.dtype == torch.float32
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


def compare_group(plan, args, chunks, *, time_it: bool,
                  iters: int = 3) -> dict:
    """B1 kernel vs its folded plain version on one plane group, plane by
    plane, and a second launch on the same inputs, which must give the
    same bits; timed, also a zeroing of the planes (``zero_ms``: the
    pass the kernel no longer needs, its output arriving unzeroed) and
    the fold that left the path (``fold_ms``: the 2G planes of the
    plain version's alloc frame)."""
    import torch

    from ska_sdp_cip_tpu_torch.ops import cuda_gridder as cg
    from ska_sdp_cip_tpu_torch.probes.common import cuda_ms

    got = cg.grid_planes(*args, plan=plan, chunks=chunks)
    again = cg.grid_planes(*args, plan=plan, chunks=chunks)
    repeat_bit_equal = same_bits(got, again)
    del again
    ref = cg.grid_planes_folded_reference(*args, plan=plan)
    worst_rel, worst_abs = 0.0, 0.0
    for p in range(ref.shape[0]):
        err, rel = rel_err(got[p], ref[p])
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    del got, ref
    G, ids = int(args[6].shape[0]), args[7].cpu().numpy()
    out = {
        "G": G,
        "active_blocks": len(ids),
        "chunks": int(chunks.shape[0]),
        "repeat_bit_equal": repeat_bit_equal,
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        **bound(*gridding_work(plan, ids, G, degrid=False)),
        "library_ms": None,
    }
    if time_it and args[0].device.type == "cuda":
        out["ms"] = cuda_ms(
            lambda: cg.grid_planes(*args, plan=plan, chunks=chunks),
            iters=iters)
        shape = (2 * G, plan.ngrid, plan.ngrid)
        out["zero_ms"] = cuda_ms(
            lambda: torch.zeros(shape, device=args[0].device), iters=iters)
        out["plain_ms"] = cuda_ms(
            lambda: cg.grid_planes_folded_reference(*args, plan=plan),
            iters=iters)
        alloc = cg.grid_planes_reference(*args, plan=plan)
        out["fold_ms"] = cuda_ms(
            lambda: [cg._fold_wraps(plan, a) for a in alloc], iters=iters)
        del alloc
    if not worst_rel <= KERNEL_RTOL:
        raise PhaseError(f"B1 vs plain {worst_rel:.3e} > {KERNEL_RTOL}")
    if not repeat_bit_equal:
        raise PhaseError("B1: two launches on the same inputs differ")
    return out


def small_visibilities(num_times=3, num_antennas=10, num_channels=2):
    """A small check problem of the b1/b3 phases: uvw, freqs, vis, wgt."""
    from ska_sdp_cip_tpu_torch.io.synth import synthetic_uvw

    rng = np.random.default_rng(17)
    uvw, _ = synthetic_uvw(num_times, num_antennas, max_baseline_m=5000.0,
                           seed=23)
    freqs = np.linspace(1.0e9, 1.07e9, num_channels)
    shape = (len(uvw), num_channels)
    vis = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64
    )
    wgt = rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
    return uvw, freqs, vis, wgt


def small_plans() -> dict:
    """
    The small check plans of the b1 and b3 phases (``tests/
    test_torch_grid_schedule.py``'s): name -> (visibilities, npix, asec,
    plan options, blocks a chunk; None for the staged table). ``small``:
    96 px at 40 asec, every tile an edge tile; ``edge``: 256 px at 20
    asec, footprints across the periodic edge beside interior tiles;
    ``split``: 256 px at 12 asec in 32-slot blocks, two blocks a chunk,
    so the hot tiles are split. Each without (G = 1) and with (G = 2)
    w-stacking.
    """
    small, wide = small_visibilities(), small_visibilities(4, 16, 3)
    plans = {}
    for w in (0, 1):
        kw = {} if w else {"do_wstacking": False}
        plans[f"small_w{w}"] = (small, 96, 40.0, kw, None)
        plans[f"edge_w{w}"] = (wide, 256, 20.0, kw, None)
        plans[f"split_w{w}"] = (wide, 256, 12.0, {**kw, "block": 32}, 2)
    return plans


def bench_problem(device, bench=(BENCH_TIMES, BENCH_ANTENNAS, BENCH_CHANNELS),
                  npix=BENCH_NPIX, **plan_kw) -> dict:
    """bench.py's visibilities, planned and staged on ``device`` once for
    the b1, b3 and predict phases."""
    uvw, freqs, vis, wgt = bench_visibilities(*bench)
    plan, arrays, re_s, im_s = staged_problem(
        uvw, freqs, vis, wgt, npix, BENCH_ASEC, device, **plan_kw
    )
    return {"uvw": uvw, "freqs": freqs, "vis": vis, "wgt": wgt,
            "plan": plan, "arrays": arrays, "re_s": re_s, "im_s": im_s}


def largest_group(plan) -> int:
    from ska_sdp_cip_tpu_torch.ops.gridder import group_active_blocks

    return int(np.argmax([len(x) for x in group_active_blocks(plan)]))


def small_cases(device, compare, table=group_chunks) -> list:
    """``compare(plan, arrays, re_s, im_s, k, chunks)`` on every plane
    group of every :func:`small_plans` plan, ``chunks`` from
    ``table``."""
    cases = []
    for name, (problem, npix, asec, kw, blocks) in small_plans().items():
        plan, arrays, re_s, im_s = staged_problem(*problem, npix, asec,
                                                  device, **kw)
        for k in range(plan.num_groups):
            chunks = table(plan, arrays, k, blocks)
            cases.append({"plan": name, "group": k, **compare(
                plan, arrays, re_s, im_s, k, chunks)})
    return cases


def bench_geometry(plan) -> dict:
    """The plan's shape and, for its largest plane group, both work
    lists: B3's chunks (with how many are split or edge chunks, the rows
    a scratch of shared rows would have held) and B1's rectangles (with
    how many hold runs, and their sources at most)."""
    from ska_sdp_cip_tpu_torch.ops import gridder
    from ska_sdp_cip_tpu_torch.ops.gridder import group_active_blocks

    ids = group_active_blocks(plan)[largest_group(plan)]
    b3 = gridder.tile_chunks(plan, ids)
    b1 = gridder.grid_chunks(plan, ids)
    return {
        "largest_group_b3_chunks": int(b3.shape[0]),
        "largest_group_b3_split_or_edge": int((b3[:, 2] != 0).sum()),
        "largest_group_b1_chunks": int(b1.shape[0]),
        "largest_group_b1_chunks_with_runs": int((b1[:, 5] > 0).sum()),
        "largest_group_b1_max_sources": int((b1[:, 5::2] > 0).sum(1).max()),
        "ngrid": plan.ngrid,
        "nalloc": [plan.nalloc_x, plan.nalloc_y],
        "support": plan.support,
        "nplanes": plan.nplanes,
        "plane_group": plan.plane_group,
        "block": plan.block,
        "num_blocks": plan.num_blocks,
        "num_vis_slots": plan.num_vis,
        "num_vis_data": plan.num_vis_data,
        "group_active_blocks": [len(x) for x in group_active_blocks(plan)],
    }


def phase_b1(device, bench: dict, bench_w0: dict) -> dict:
    """
    B1 against its folded plain version on every group of the small
    plans, then on the bench plan's largest plane group (G = 2, also
    timed at each of :data:`CHUNK_SWEEP` blocks a chunk) and, as B4, on
    the bench plan without w-stacking (G = 1), both timed; then
    ``bench_dft``.
    """
    from ska_sdp_cip_tpu_torch.ops import cuda_gridder as cg

    def grid_case(plan, arrays, re_s, im_s, k, chunks, time_it=False):
        return compare_group(plan, group_args(plan, arrays, re_s, im_s, k),
                             chunks, time_it=time_it)

    results = {"phase": "b1",
               "cases": small_cases(device, grid_case, group_grid_chunks)}
    for key, problem in (("bench", bench), ("bench_w0", bench_w0)):
        plan, arrays = problem["plan"], problem["arrays"]
        k = largest_group(plan)
        results[f"{key}_geometry"] = bench_geometry(plan)
        results[key] = {"group": k, **grid_case(
            plan, arrays, problem["re_s"], problem["im_s"], k,
            group_grid_chunks(plan, arrays, k), time_it=True)}
    plan, arrays = bench["plan"], bench["arrays"]
    k = results["bench"]["group"]
    args = group_args(plan, arrays, bench["re_s"], bench["im_s"], k)
    results["bench"]["chunk_sweep_ms"] = chunk_sweep(
        plan, arrays, k, lambda c: cg.grid_planes(*args, plan=plan, chunks=c),
        group_grid_chunks)
    results["bench_dft"] = bench_dft_check(
        bench["plan"], bench["arrays"], bench["re_s"], bench["im_s"],
        bench["uvw"], bench["freqs"], bench["vis"] * bench["wgt"], device,
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


def compare_degrid(plan, arrays, grids, k, chunks, *, time_it: bool,
                   iters: int = 3) -> dict:
    """B3 kernel vs its folded plain version on plane group ``k`` of the
    periodic planes ``grids``; timed, also the unfold that left the path
    (``fold_ms``: the 2G planes into a zeroed alloc-frame stack)."""
    import torch

    from ska_sdp_cip_tpu_torch.ops import cuda_gridder as cg
    from ska_sdp_cip_tpu_torch.ops.gridder import group_active_blocks
    from ska_sdp_cip_tpu_torch.probes.common import cuda_ms

    ids = group_active_blocks(plan)[k]
    args = (
        arrays["packed"], arrays["block_len"], arrays["cblock_ox"],
        arrays["block_oy"], grids, arrays["plane_wg"][k],
        arrays["group_blocks"][k, :len(ids)],
    )

    def acc():
        return torch.zeros((2, plan.num_vis), dtype=torch.float32,
                           device=grids.device)

    got = cg.degrid_planes(*args, acc(), plan=plan, chunks=chunks)
    ref = cg.degrid_planes_folded_reference(*args, acc(), plan=plan)
    err, rel = rel_err(got, ref)
    G = int(args[5].shape[0])
    out = {"G": G, "active_blocks": len(ids),
           "chunks": int(chunks.shape[0]),
           "max_abs_err": err, "max_rel_err": rel,
           **bound(*gridding_work(plan, ids, G, degrid=True)),
           "library_ms": None}
    if time_it and grids.device.type == "cuda":
        out["ms"] = cuda_ms(
            lambda: cg.degrid_planes(*args, acc(), plan=plan, chunks=chunks),
            iters=iters)
        out["plain_ms"] = cuda_ms(
            lambda: cg.degrid_planes_folded_reference(*args, acc(),
                                                      plan=plan),
            iters=iters,
        )
        alloc = torch.zeros((2 * G, plan.nalloc_x, plan.nalloc_y),
                            device=grids.device)
        out["fold_ms"] = cuda_ms(
            lambda: [cg._unfold_wraps(plan, g, a)
                     for g, a in zip(grids, alloc)], iters=iters)
        del alloc
    if not rel <= KERNEL_RTOL:
        raise PhaseError(f"B3 vs plain {rel:.3e} > {KERNEL_RTOL}")
    return out


def random_grids(plan, device, seed: int):
    """(2G, N, N) standard-normal float32 periodic planes."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(
        (2 * plan.plane_group, plan.ngrid, plan.ngrid),
        generator=gen, device=device,
    )


def phase_b3(device, bench: dict, bench_w0: dict) -> dict:
    """
    B3 against its folded plain version on random periodic planes: every
    group of the small plans, then the bench plan's largest plane group
    (G = 2, also timed at each of :data:`CHUNK_SWEEP` blocks a chunk)
    and, as B5, the bench plan without w-stacking (G = 1), with
    CUDA-event times.
    """
    import torch

    from ska_sdp_cip_tpu_torch.ops import cuda_gridder as cg

    def degrid_case(plan, arrays, re_s, im_s, k, chunks, time_it=False):
        return compare_degrid(plan, arrays, random_grids(plan, device, 5),
                              k, chunks, time_it=time_it)

    results = {"phase": "b3", "cases": small_cases(device, degrid_case)}
    for key, problem in (("bench", bench), ("bench_w0", bench_w0)):
        plan, arrays = problem["plan"], problem["arrays"]
        k = largest_group(plan)
        results[key] = {"group": k, **degrid_case(
            plan, arrays, None, None, k, group_chunks(plan, arrays, k),
            time_it=True)}
    plan, arrays = bench["plan"], bench["arrays"]
    k = results["bench"]["group"]
    grids = random_grids(plan, device, 5)
    ids = arrays["group_blocks"][k, :results["bench"]["active_blocks"]]

    def degrid(chunks):
        acc = torch.zeros((2, plan.num_vis), dtype=torch.float32,
                          device=device)
        return cg.degrid_planes(
            arrays["packed"], arrays["block_len"], arrays["cblock_ox"],
            arrays["block_oy"], grids, arrays["plane_wg"][k], ids, acc,
            plan=plan, chunks=chunks)

    results["bench"]["chunk_sweep_ms"] = chunk_sweep(plan, arrays, k, degrid)
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
        reset_launches()
        got = dirty_image(
            uvw, freqs, vis, wgt, npix, pix, do_wstacking=wstack,
            device=device,
        )
        launches = read_launches()
        err, rel = rel_err(got, ref)
        results["cases"].append(
            {"wstacking": wstack, "max_abs_err": err, "max_rel_err": rel,
             "launches": launches}
        )
        if not (np.isfinite(got).all() and rel <= DFT_RTOL):
            raise PhaseError(f"dirty_image vs DFT {rel:.3e} > {DFT_RTOL}")
        # Without w-stacking the plan has one plane: B1 at G = 1 (B4).
        require_launches(launches, ("b1", "b2_out_crop") if wstack
                         else ("b4", "b2_out_crop"), device, "e2e_small")
    results["launches"] = results["cases"][0]["launches"]
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
    cuda_gridder.GROUP1_LAUNCHES = cuda_gridder.DEGRID_GROUP1_LAUNCHES = 0
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
           "b4": cuda_gridder.GROUP1_LAUNCHES,
           "b5": cuda_gridder.DEGRID_GROUP1_LAUNCHES,
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
        reset_launches()
        got = predict_visibilities(uvw, freqs, image, pix,
                                   do_wstacking=wstack, device=device)
        launches = read_launches()
        err = float(np.abs(got - ref).max())
        rel = err / float(np.abs(ref).max())
        results["cases"].append({"wstacking": wstack, "num_vis": got.size,
                                 "max_abs_err": err, "max_rel_err": rel,
                                 "launches": launches})
        if not (np.isfinite(got).all() and rel <= DFT_RTOL):
            raise PhaseError(f"predict vs DFT {rel:.3e} > {DFT_RTOL}")
        # Without w-stacking the plan has one plane: B3 at G = 1 (B5).
        require_launches(launches, ("b3", "b2_in_crop") if wstack
                         else ("b5", "b2_in_crop"), device, "predict")
    results["small_launches"] = results["cases"][0]["launches"]

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
    a profile of its device part, which planner ran, whether the
    visibilities came down into a pinned buffer, and the seconds of the
    same arrays' upload through pinned buffers."""
    import torch

    from ska_sdp_cip_tpu_torch.ops.gridder import (
        build_predict,
        slot_plan_host_arrays,
        stage_arrays,
    )
    from ska_sdp_cip_tpu_torch.ops.plan import make_plan
    from ska_sdp_cip_tpu_torch.utils.staging import device_get

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    out = {"planner": planner_name()}
    t = time.perf_counter()
    plan = make_plan(uvw, freqs, image.shape[0], pix, **plan_kw)
    out["plan_seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    host = slot_plan_host_arrays(plan, device, invert=False)
    out["host_arrays_seconds"] = time.perf_counter() - t
    host["image"] = image
    sync()
    t = time.perf_counter()
    arrays = stage_arrays(host, device)
    img = arrays.pop("image")
    sync()
    out["h2d_seconds"] = time.perf_counter() - t
    out["h2d_pinned_seconds"] = pinned_upload_seconds(host, device)
    predict = build_predict(plan)
    predict(arrays, img)  # warm
    sync()
    t = time.perf_counter()
    re, im = predict(arrays, img)
    sync()
    out["predict_device_seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    host_re, _ = device_get(re), device_get(im)
    out["d2h_seconds"] = time.perf_counter() - t
    out["d2h_pinned"] = bool(torch.from_numpy(host_re).is_pinned())
    del host_re
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
        "planner": planner_name(),
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
    results["repeat_bit_equal"] = bit_equal(image, run())
    if not results["repeat_bit_equal"]:
        raise PhaseError("slice: two invert_dataset calls differ")
    rel = dft_spot_check(reader, image, expected, pix, device)
    results["dft_spot_check"] = rel
    if not rel["max_rel_err"] <= DFT_RTOL:
        raise PhaseError(f"slice vs DFT {rel['max_rel_err']:.3e} > {DFT_RTOL}")
    results["breakdown"] = slice_breakdown(reader, npix, asec, device)
    results["profile"] = profile_call(run, device)
    return results


#: The ``ms`` phase's MeasurementSet: each tiled column in a manager of
#: its own (the reader maps one (type, group) to one ``table.f<seq>``),
#: DATA in TiledShapeStMan as the CASA filler binds it, TIME in
#: IncrementalStMan; (column, VZ file, manager, group, value type name).
MS_MAIN_COLUMNS = (
    ("UVW", "uvw", "TiledColumnStMan", "TiledUVW", "Double"),
    ("TIME", "time", "IncrementalStMan", "ISMData", "Double"),
    ("DATA", "data", "TiledShapeStMan", "TiledData", "Complex"),
    ("FLAG", "flag", "TiledColumnStMan", "TiledFlag", "Bool"),
    ("WEIGHT_SPECTRUM", "weight_spectrum", "TiledColumnStMan",
     "TiledWgtSpectrum", "Float"),
    ("WEIGHT", "weight", "TiledColumnStMan", "TiledWeight", "Float"),
)
#: Big-endian dtypes of the cells (AipsIO's canonical byte order).
MS_DTYPES = {"Double": ">f8", "Complex": ">c8", "Float": ">f4",
             "Int": ">i4", "Bool": "u1"}
#: casacore AipsIO's magic number before a top-level object.
AIPSIO_MAGIC = 0xBEBEBEBE


def _aipsio_string(text: str) -> bytes:
    raw = text.encode()
    return struct.pack(">I", len(raw)) + raw


def _aipsio_frame(typ: str, version: int, payload: bytes) -> bytes:
    """One AipsIO object: [uInt length][String type][uInt version]
    payload, the length counting everything after itself."""
    body = _aipsio_string(typ) + struct.pack(">I", version) + payload
    return struct.pack(">I", len(body)) + body


def _iposition(shape) -> bytes:
    return _aipsio_frame("IPosition", 2, struct.pack(
        f">I{len(shape)}q", len(shape), *shape))


def _column_desc(name, type_name, shape, dm_type, dm_group, *,
                 ndim=None) -> bytes:
    """A ColumnDesc frame: scalar when ``shape`` is None, a fixed-shape
    direct array for a shape (casacore order, fastest axis first), a
    variable-shape array of ``ndim`` axes when ``shape`` is ()."""
    from ska_sdp_cip_tpu_torch.io import casacore_tables as ct

    codes = {"Bool": ct.TP_BOOL, "Int": ct.TP_INT, "Float": ct.TP_FLOAT,
             "Double": ct.TP_DOUBLE, "Complex": ct.TP_COMPLEX}
    is_array = shape is not None
    if not is_array:
        options, ndim = 0, 0
    elif shape:
        options, ndim = ct.OPT_DIRECT | ct.OPT_FIXEDSHAPE, len(shape)
    else:
        options = 0
    payload = (_aipsio_string(
        f"{'Array' if is_array else 'Scalar'}ColumnDesc<{type_name}>")
        + struct.pack(">I", 1) + _aipsio_string(name) + _aipsio_string("")
        + _aipsio_string(dm_type) + _aipsio_string(dm_group)
        + struct.pack(">3i", codes[type_name], options, ndim))
    if is_array:
        payload += _iposition(shape)
    return _aipsio_frame("ColumnDesc", 1, payload)


def _write_table_dat(path: Path, num_rows: int, descs: list) -> None:
    path.mkdir(parents=True, exist_ok=True)
    table = _aipsio_frame("Table", 2, struct.pack(">2I", num_rows, 0)
                          + _aipsio_string(path.name)
                          + _aipsio_frame("TableDesc", 1, b"".join(descs)))
    (path / "table.dat").write_bytes(struct.pack(">I", AIPSIO_MAGIC) + table)


def _tile_cube(values: np.ndarray, tile: tuple, type_name: str) -> bytes:
    """The TSM hypercube of ``values`` (rows first, numpy order): a
    Fortran-ordered grid of Fortran-ordered tiles over cell + (rows,),
    ``tile`` in casacore order; Bool tiles bit-packed. Whole tiles at
    once: the grid is numpy's C order over the reversed axes."""
    rev = tuple(reversed(tile))
    counts = [-(-n // t) for n, t in zip(values.shape, rev)]
    padded = np.zeros([n * t for n, t in zip(counts, rev)],
                      MS_DTYPES[type_name])
    padded[tuple(slice(0, n) for n in values.shape)] = values
    split = padded.reshape([d for nt in zip(counts, rev) for d in nt])
    rank = len(rev)
    tiles = np.ascontiguousarray(split.transpose(
        [2 * a for a in range(rank)] + [2 * a + 1 for a in range(rank)]))
    if type_name == "Bool":
        return np.packbits(tiles.reshape(int(np.prod(counts)), -1), axis=1,
                           bitorder="little").tobytes()
    return tiles.tobytes()


def _write_tiled_column(path: Path, seq: int, dm_type: str,
                        values: np.ndarray, tile: tuple, type_name: str):
    """``table.f<seq>`` (the manager's header: TSSM holds the hypercube
    shape and then the tile shape, TSM the tile shape) and its cube file
    ``table.f<seq>_TSM0``."""
    cube = tuple(reversed(values.shape))
    shapes = (cube, tile) if dm_type == "TiledShapeStMan" else (tile,)
    header = _aipsio_frame(dm_type, 1, b"".join(_iposition(s)
                                                for s in shapes))
    (path / f"table.f{seq}").write_bytes(
        struct.pack(">I", AIPSIO_MAGIC) + header)
    (path / f"table.f{seq}_TSM0").write_bytes(
        _tile_cube(values, tile, type_name))


def _write_ism_column(path: Path, seq: int, values: np.ndarray) -> None:
    """One scalar Double column in IncrementalStMan: one bucket holding
    the value at each change point and its index, then the ISMIndex
    object (64-bit row boundaries)."""
    from ska_sdp_cip_tpu_torch.io import casacore_tables as ct

    starts = np.flatnonzero(np.r_[True, values[1:] != values[:-1]])
    n = len(starts)
    index_offset = 4 + 8 * n
    used = index_offset + 4 + 8 * n
    bucket_size = max(512, -(-used // 512) * 512)
    bucket = bytearray(bucket_size)
    bucket[:used] = (
        struct.pack(">I", index_offset)
        + values[starts].astype(">f8").tobytes() + struct.pack(">I", n)
        + starts.astype(">u4").tobytes()
        + (4 + 8 * np.arange(n)).astype(">u4").tobytes())
    header = _aipsio_frame("IncrementalStMan", 5, struct.pack(
        ">?4I", True, bucket_size, 1, 1, 0))
    index = _aipsio_frame("ISMIndex", 2, struct.pack(
        ">2I2qII", 1, 2, 0, len(values), 1, 0))
    head = struct.pack(">I", AIPSIO_MAGIC) + header
    (path / f"table.f{seq}").write_bytes(
        head + bytes(ct._SSM_HEADER_AREA - len(head)) + bytes(bucket)
        + index)


def _write_ssm_table(path: Path, columns: list) -> None:
    """A one-row subtable in one StandardStMan bucket: ``columns`` is
    (name, type name, value, indirect); an indirect array stores its
    Int64 offset into the aux file ``table.f0i``, whose cell is
    [uInt ndim][uInt dims][big-endian values]; an SSMIndex object in a
    second bucket maps the row to bucket 0."""
    from ska_sdp_cip_tpu_torch.io import casacore_tables as ct

    descs = [_column_desc(name, type_name, () if indirect else None,
                          "StandardStMan", "StandardStMan",
                          ndim=np.ndim(value) if indirect else None)
             for name, type_name, value, indirect in columns]
    _write_table_dat(path, 1, descs)
    widths = [8 if indirect else np.dtype(MS_DTYPES[type_name]).itemsize
              for _, type_name, _, indirect in columns]
    bucket_size = 512
    rows_per_bucket = bucket_size // sum(widths)
    bucket, aux = bytearray(bucket_size), bytearray(16)
    offset = 0
    for (_, type_name, value, indirect), width in zip(columns, widths):
        value = np.asarray(value, MS_DTYPES[type_name])
        if indirect:
            cell = struct.pack(f">{value.ndim + 1}I", value.ndim,
                               *reversed(value.shape)) + value.tobytes()
            raw = struct.pack(">q", len(aux))
            aux += cell
        else:
            raw = value.tobytes()
        bucket[offset:offset + len(raw)] = raw
        offset += width * rows_per_bucket
    index = _aipsio_frame("SSMIndex", 1, struct.pack(">3I", 1, 0, 0))
    header = _aipsio_frame("StandardStMan", 2, struct.pack(
        ">7i", bucket_size, 2, 1, 0, -1, 1, 1))
    head = struct.pack(">I", AIPSIO_MAGIC) + header
    (path / "table.f0").write_bytes(
        head + bytes(ct._SSM_HEADER_AREA - len(head)) + bytes(bucket)
        + index + bytes(bucket_size - len(index)))
    (path / "table.f0i").write_bytes(bytes(aux))


def ms_tile_shapes(columns: dict, tile_bytes: int) -> dict:
    """Each tiled column's tile shape (casacore order): every
    correlation, every channel (half of them for WEIGHT_SPECTRUM, so its
    tiles also form a grid along frequency), and as many rows as make
    about ``tile_bytes`` (at most the table's)."""
    shapes = {}
    for name, key, dm_type, _, type_name in MS_MAIN_COLUMNS:
        if dm_type == "IncrementalStMan" or key not in columns:
            continue
        cell = list(reversed(columns[key].shape[1:]))
        if name == "WEIGHT_SPECTRUM":
            cell[1] = -(-cell[1] // 2)
        bits = 1 if type_name == "Bool" else 8 * np.dtype(
            MS_DTYPES[type_name]).itemsize
        rows = max(1, 8 * tile_bytes // (bits * int(np.prod(cell))))
        shapes[name] = (*cell, min(rows, len(columns[key])))
    return shapes


def write_measurement_set(path: Path, columns: dict,
                          tile_bytes: int = 1 << 20) -> dict:
    """
    Write ``columns`` (VZ arrays: ``uvw``, ``time``, ``data``, ``flag``,
    ``weight_spectrum`` and/or ``weight``, ``chan_freq``, ``corr_types``)
    as a MeasurementSet v2 in the casacore table format that
    ``io/casacore_tables.py`` reads: the main table's columns bound as
    :data:`MS_MAIN_COLUMNS` says (TiledShapeStMan, TiledColumnStMan and
    IncrementalStMan), big-endian cells, and the subtables
    SPECTRAL_WINDOW (CHAN_FREQ, NUM_CHAN), POLARIZATION (CORR_TYPE,
    NUM_CORR) and FIELD as one-bucket StandardStMan tables with indirect
    array cells. Numpy and stdlib only; the big columns are written as
    whole tiles. Returns each tiled column's tile shape.
    """
    path = Path(path)
    num_rows = len(columns["uvw"])
    tiles = ms_tile_shapes(columns, tile_bytes)
    descs, bound = [], []
    for name, key, dm_type, group, type_name in MS_MAIN_COLUMNS:
        if key not in columns:
            continue
        cell = tuple(reversed(columns[key].shape[1:]))
        if dm_type == "TiledShapeStMan":
            descs.append(_column_desc(name, type_name, (), dm_type, group,
                                      ndim=len(cell)))
        else:
            descs.append(_column_desc(name, type_name, cell or None,
                                      dm_type, group))
        bound.append((key, dm_type, type_name, tiles.get(name)))
    _write_table_dat(path, num_rows, descs)
    for seq, (key, dm_type, type_name, tile) in enumerate(bound):
        values = np.asarray(columns[key])
        if dm_type == "IncrementalStMan":
            _write_ism_column(path, seq, values)
        else:
            _write_tiled_column(path, seq, dm_type, values, tile, type_name)
    freqs = np.asarray(columns["chan_freq"])
    corr = np.asarray(columns["corr_types"])
    _write_ssm_table(path / "SPECTRAL_WINDOW", [
        ("CHAN_FREQ", "Double", freqs, True),
        ("NUM_CHAN", "Int", len(freqs), False)])
    _write_ssm_table(path / "POLARIZATION", [
        ("CORR_TYPE", "Int", corr, True), ("NUM_CORR", "Int", len(corr),
                                           False)])
    _write_ssm_table(path / "FIELD", [
        ("PHASE_DIR", "Double", np.zeros((1, 2)), True),
        ("SOURCE_ID", "Int", 0, False)])
    return tiles


def vz_columns(path: Path) -> dict:
    """A VZ dataset's arrays by file stem, plus its ``corr_types``."""
    columns = {p.stem: np.load(p) for p in sorted(Path(path).glob("*.npy"))}
    meta = json.loads((Path(path) / "metadata.json").read_text())
    columns["corr_types"] = np.asarray(meta["corr_types"], np.int32)
    return columns


def bit_equal(a, b) -> bool:
    """Same dtype, shape and bytes."""
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.ascontiguousarray(a).tobytes()
            == np.ascontiguousarray(b).tobytes())


def disk_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def partition_read_seconds(dataset: Path, rows: int, chans: int) -> float:
    """Seconds to read every sub-reader of ``partition(rows, chans)`` and
    convert it to Stokes I, as the shards of a sharded run do."""
    from ska_sdp_cip_tpu_torch import VisibilityReader
    from ska_sdp_cip_tpu_torch.invert import StokesIGridderInput

    t = time.perf_counter()
    for sub in VisibilityReader(dataset).partition(rows, chans):
        StokesIGridderInput.from_reader(sub)
    return time.perf_counter() - t


READER_COLUMNS = ("uvw", "time", "visibilities", "flags", "weights",
                  "channel_frequencies")


def phase_ms(device, path: Path, workdir: Path, slice_launches: dict,
             npix=BENCH_NPIX, asec=BENCH_ASEC, repeats=3,
             row_blocks=(None, 10000), tile_bytes=1 << 20) -> dict:
    """
    The slice's dataset as a MeasurementSet v2
    (:func:`write_measurement_set`), then: ``VisibilityReader`` on it
    (the backend must be the casacore-free ``_NativeMSBackend``; every
    column and the corr types bit-equal to the VZ's; seconds per
    column); ``tpu-cip-ingest-torch`` in process at each of
    ``row_blocks`` (None: the default), each VZ it writes bit-equal to
    the source, array for array; ``tpu-cip-torch obs.ms`` in process on
    ``device`` (no ``--device`` on the card: its default) against
    ``invert_dataset`` of the VZ, bit for bit (and at rtol 1e-5, atol
    1e-5 of the max),
    with B1's and B2's launches equal to ``slice_launches``, the median
    CLI wall of ``repeats`` calls after the first, and a breakdown: MS
    read + Stokes beside the VZ's, then plan, upload, device, download.
    """
    import shutil

    from ska_sdp_cip_tpu_torch import VisibilityReader, invert_dataset
    from ska_sdp_cip_tpu_torch.apps.ingest_app import run_program
    from ska_sdp_cip_tpu_torch.invert import StokesIGridderInput

    columns = vz_columns(path)
    ms = workdir / "obs.ms"
    t = time.perf_counter()
    tiles = write_measurement_set(ms, columns, tile_bytes)
    out = {"phase": "ms", "num_rows": len(columns["uvw"]),
           "num_vis": int(columns["data"].shape[0] * columns["data"].shape[1]),
           "write_seconds": time.perf_counter() - t,
           "ms_bytes": disk_bytes(ms), "vz_bytes": disk_bytes(path),
           "tile_shapes": {k: list(v) for k, v in tiles.items()},
           "managers": {name: dm for name, key, dm, _, _ in MS_MAIN_COLUMNS
                        if key in columns}}
    del columns

    vz = VisibilityReader(path)
    reader = VisibilityReader(ms)
    out["backend"] = type(reader._metadata.backend).__name__
    if out["backend"] != "_NativeMSBackend":
        raise PhaseError(f"ms: read by {out['backend']}, not the "
                         "casacore-free _NativeMSBackend")
    seconds, unequal = {}, []
    for name in READER_COLUMNS:
        t = time.perf_counter()
        got = getattr(reader, name)()
        seconds[name] = time.perf_counter() - t
        if not bit_equal(got, getattr(vz, name)()):
            unequal.append(name)
    corr = reader._metadata.backend.corr_types()
    if corr != tuple(vz._metadata.backend.corr_types()):
        unequal.append("corr_types")
    out["read_seconds"] = seconds
    out["decode_seconds"] = sum(seconds.values())
    if unequal:
        raise PhaseError(f"ms: columns differ from the VZ's: {unequal}")
    del reader

    out["ingest"] = []
    for block in row_blocks:
        target = workdir / "obs_ms.vz"
        argv = [str(ms), str(target)]
        if block is not None:
            argv += ["--row-block", str(block)]
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            run_program(argv)
        run = {"row_block": block, "wall_seconds": time.perf_counter() - t}
        names = sorted(p.name for p in path.glob("*.npy"))
        run["files"] = names
        run["bit_equal"] = (
            names == sorted(p.name for p in target.glob("*.npy"))
            and all(bit_equal(np.load(path / n), np.load(target / n))
                    for n in names))
        shutil.rmtree(target)
        out["ingest"].append(run)
        if not run["bit_equal"]:
            raise PhaseError(f"ms: ingest at row block {block} is not the "
                             "source VZ")

    image_path = workdir / "dirty_ms.npy"
    argv = [ms, image_path, "-n", npix, "-p", asec]
    if str(device) != "cuda":
        argv += ["--device", device]
    first = cli_call(device, argv)
    launches = first["launches"]
    image = np.load(image_path)
    # The CLI's sigma ("auto"; 2.0, invert_dataset's default, at bench).
    ref = invert_dataset(vz, npix, asec, sigma="auto", device=device)
    out.update({"npix": npix, "pixel_asec": asec,
                "first_call_seconds": first["wall_seconds"],
                "launches": launches,
                "vs_vz_invert": {**within_sharded_tol(image, ref),
                                 "bit_equal": bit_equal(image, ref)}})
    if not (out["vs_vz_invert"]["within"]
            and out["vs_vz_invert"]["bit_equal"]):
        # The MS's columns are the VZ's bits and the kernels sum in a
        # fixed order: the two images are the same bits.
        raise PhaseError(f"ms: the MS image against the VZ invert "
                         f"{out['vs_vz_invert']}")
    require_launches(launches, ("b1", "b2_out_crop"), device, "ms")
    for key in ("b1", "b2_out_crop"):
        if launches[key] != slice_launches[key]:
            raise PhaseError(f"ms: {key} launched {launches[key]} times, "
                             f"{slice_launches[key]} in slice")
    walls = [cli_call(device, argv)["wall_seconds"] for _ in range(repeats)]
    out["cli_wall_seconds"] = walls
    out["median_cli_wall_seconds"] = statistics.median(walls)

    # Each sub-reader opens its own backend, so on an MS every shard of
    # -d S (partition(2, 2) at S = 4) and every time interval of the
    # reorder (-n 4: partition(4, 1)) decodes the columns again.
    out["partition_read_stokes_seconds"] = {
        f"{fmt}_{rows}x{chans}": partition_read_seconds(dataset, rows, chans)
        for rows, chans in ((2, 2), (4, 1))
        for fmt, dataset in (("ms", ms), ("vz", path))}
    t = time.perf_counter()
    StokesIGridderInput.from_reader(VisibilityReader(path))
    breakdown = {"vz_read_stokes_seconds": time.perf_counter() - t}
    breakdown.update(slice_breakdown(VisibilityReader(ms), npix, asec,
                                     device))
    breakdown["ms_read_stokes_seconds"] = breakdown.pop(
        "read_stokes_seconds")
    out["breakdown"] = breakdown
    shutil.rmtree(ms)
    return out


def profile_call(fn, device, top: int = 8, sessions: int = 1) -> dict:
    """
    Device kernel time of one call of ``fn`` under torch.profiler: the
    summed kernel time, its share of the call's wall time, and the
    kernels that took most of it. torch.profiler (torch 2.11 on an
    H100) now and then drops kernel records from a session (seen: 1 to
    3 of four 10240^2 convolutions), never adds any; with ``sessions``
    > 1, ``fn`` runs once under each of that many sessions and the one
    that saw the most device time is kept (every session's busy seconds
    are listed).
    """
    if device.type != "cuda":
        return {"device_time": "not measured"}
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best, busy_by_session = None, []
    for _ in range(sessions):
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
                if evt.device_type == DeviceType.CUDA
                and evt.device_time_total > 0
            ]
        except (RuntimeError, AttributeError) as err:
            return {"device_time": "not measured", "error": repr(err)}
        busy = sum(r[0] for r in rows) / 1e6
        busy_by_session.append(busy)
        if best is None or busy > best[0]:
            best = (busy, wall, rows)
    busy, wall, rows = best
    if not rows:
        return {"device_time": "not measured", "wall_seconds": wall}
    rows.sort(reverse=True)
    out = {
        "wall_seconds": wall,
        "device_busy_seconds": busy,
        "device_idle_share": 1.0 - busy / wall,
        "top_kernels": [
            {"name": name[:80], "calls": count, "ms": us / 1e3}
            for us, count, name in rows[:top]
        ],
    }
    if sessions > 1:
        out["busy_seconds_by_session"] = busy_by_session
    return out


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


def dft_spot_check(reader, image, centre, pix, device, seed=0,
                   weighting=None, window=16) -> dict:
    """
    The normalized image against the explicit DFT dirty image at a
    ``window`` x ``window`` patch on the brightest source and 192 random
    pixels (448 by default). Error relative to the image max. With
    ``weighting`` = (scheme, robust), the DFT is of the visibilities
    reweighted as ``invert_dataset`` reweights them.
    """
    from ska_sdp_cip_tpu_torch.invert import StokesIGridderInput
    from ska_sdp_cip_tpu_torch.models.weighting import ImagingWeighter

    npix = image.shape[0]
    gi = StokesIGridderInput.from_reader(reader)
    weights = gi.effective_weights()
    if weighting is not None:
        scheme, robust = weighting
        fit_args = (gi.uvw, gi.channel_frequencies, weights)
        weights = ImagingWeighter(npix, pix, scheme=scheme,
                                  robust=robust).fit(*fit_args).apply(
                                      *fit_args)
    rng = np.random.default_rng(seed)
    half = window // 2
    window = np.stack(
        np.meshgrid(np.arange(-half, half), np.arange(-half, half)), -1
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


def pinned_upload_seconds(host: dict, device):
    """Seconds of the same host arrays' upload through pinned buffers,
    the path ``utils/staging.py`` does not take: each array (as
    ``stage_arrays`` converts it) filled into a pinned buffer, then
    copied with ``non_blocking=True``; synchronized, the second of two
    runs, so the caching host allocator already holds the buffers.
    None off the card (a CPU-only torch cannot pin)."""
    import torch

    from ska_sdp_cip_tpu_torch.utils.staging import _host_array

    if device.type != "cuda":
        return None
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for value in host.values():
            if not isinstance(value, int):
                pinned = torch.from_numpy(_host_array(value)).pin_memory()
                pinned.to(device, non_blocking=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    return seconds


def invert_breakdown(uvw, freqs, weighted, npix, pix, device,
                     **plan_kw) -> dict:
    """Seconds per stage of one invert of weighted visibilities
    (``dirty_image``'s steps), synchronized; which planner ran, whether
    the image came down into a pinned buffer, and the pageable
    download's seconds (``image.cpu()``) on the same image."""
    import torch

    from ska_sdp_cip_tpu_torch.ops.gridder import (
        build_assemble,
        build_invert,
        compact_plan_host_arrays,
        stage_arrays,
    )
    from ska_sdp_cip_tpu_torch.ops.plan import make_plan
    from ska_sdp_cip_tpu_torch.utils.staging import device_get

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    weighted = np.asarray(weighted, np.complex64).ravel()
    out = {"planner": planner_name()}
    t = time.perf_counter()
    plan = make_plan(uvw, freqs, npix, pix, export_packed=False, **plan_kw)
    out["plan_seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    host = compact_plan_host_arrays(plan, uvw, freqs, device)
    out["host_arrays_seconds"] = time.perf_counter() - t
    host["re"], host["im"] = weighted.real, weighted.imag
    sync()
    t = time.perf_counter()
    arrays = stage_arrays(host, device)
    re, im = arrays.pop("re"), arrays.pop("im")
    sync()
    out["h2d_seconds"] = time.perf_counter() - t
    out["h2d_pinned_seconds"] = pinned_upload_seconds(host, device)
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
    host_image = device_get(image)
    out["d2h_seconds"] = time.perf_counter() - t
    out["d2h_pinned"] = bool(torch.from_numpy(host_image).is_pinned())
    del host_image
    t = time.perf_counter()
    image.cpu()
    out["d2h_pageable_seconds"] = time.perf_counter() - t
    if device.type == "cuda":
        out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def planner_name() -> str:
    """Which planner ``make_plan`` runs: the native engine or numpy."""
    from ska_sdp_cip_tpu_torch import native

    return "native" if native.available() else "numpy"


@contextlib.contextmanager
def numpy_planner():
    """The port's planner on its numpy path: the native engine off."""
    from ska_sdp_cip_tpu_torch import native

    available = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = available


def timed(fn, *args, **kwargs) -> tuple:
    """(result, host seconds) of one call."""
    t = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t


#: Plan columns that only the native engine exports.
ENGINE_EXPORTS = ("packed", "flip_sign", "phase_cos", "phase_sin",
                  "order_enc")


#: Float slot columns in which the engine may differ from numpy by one
#: float32 ulp: it scales by 1 / du where numpy divides by du, so a
#: float64 position one ulp apart can round to the neighbouring float32
#: (1 of 1.46M samples of the bench geometry; ROADMAP.md, C6).
ULP_COLUMNS = ("fx", "fy", "ws")

#: At most this many entries of a column may be one ulp apart: the bench
#: workload has one; a change of the engine's rounding that moved many
#: fails the gate.
ULP_APART_MAX = 4


def ulp_apart(a, b) -> int:
    """How many entries of float32 arrays differ, failing with -1 if any
    differs by more than one float32 ulp."""
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    if (diff > np.spacing(np.abs(b).astype(np.float32))).any():
        return -1
    return int(np.count_nonzero(diff))


def compare_plans(ours, ref) -> dict:
    """
    A native plan with its coordinates exported against the numpy plan:
    the fields that differ (every integer slot column, block table and
    scalar must be equal; at most :data:`ULP_APART_MAX` entries of each
    of :data:`ULP_COLUMNS` may be one float32 ulp apart, counted in
    ``ulp_apart``), and the engine's exports against
    the numpy path's on-demand versions: ``packed`` (counted the same
    way) and ``flip_sign`` equal, the phase factors' largest error (1e-6
    allowed), ``order_enc`` equal.
    """
    import dataclasses

    from ska_sdp_cip_tpu_torch.ops.cuda_gridder import pack_plan_columns
    from ska_sdp_cip_tpu_torch.ops.gridder import plan_order_host

    differ, ulps = [], {}
    for field in dataclasses.fields(ref):
        if field.name in ENGINE_EXPORTS:
            continue
        a, b = getattr(ours, field.name), getattr(ref, field.name)
        if isinstance(b, np.ndarray):
            same = (a is not None and a.dtype == b.dtype
                    and np.array_equal(a, b))
            if not same and field.name in ULP_COLUMNS and a is not None:
                ulps[field.name] = ulp_apart(a, b)
                same = 0 <= ulps[field.name] <= ULP_APART_MAX
        else:
            same = type(a) is type(b) and a == b
        if not same:
            differ.append(field.name)
    out = {"fields": len(dataclasses.fields(ref)), "differ": differ,
           "ulp_apart": ulps}
    ok = not differ
    if ours.packed is not None:
        with numpy_planner():
            host = plan_order_host(ref)
        packed = pack_plan_columns(ref)
        out["packed_equal"] = bool(np.array_equal(ours.packed, packed))
        out["packed_ulp_apart"] = ulp_apart(ours.packed, packed)
        ok = ok and 0 <= out["packed_ulp_apart"] <= ULP_APART_MAX
        out["flip_sign_equal"] = bool(np.array_equal(ours.flip_sign,
                                                     host["flip_sign"]))
        out["phase_max_abs_err"] = float(max(
            np.abs(ours.phase_cos - host["phase_cos"]).max(),
            np.abs(ours.phase_sin - host["phase_sin"]).max()))
        ok = (ok and out["flip_sign_equal"]
              and out["phase_max_abs_err"] <= 1e-6)
    if ours.order_enc is not None:
        enc = np.where(ref.flip, -ref.order.astype(np.int64) - 1,
                       ref.order).astype(np.int32)
        out["order_enc_equal"] = bool(np.array_equal(ours.order_enc, enc))
        ok = ok and out["order_enc_equal"]
    out["equal"] = ok
    return out


def phase_planner(device, configs=None) -> dict:
    """
    The native planner engine (``csrc/cip_native.cpp``, built here with
    the host C++ compiler): its build, and at the bench workload and the
    production configuration its plans against the numpy planner's
    (:func:`compare_plans`, the slot export and the compact one), the
    seconds of each planner, and ``stage_slot_vis`` (1e-6 of the max)
    and the uniform-weighting density (rtol 1e-12) on each, with their
    seconds, and whether the engine's density repeats bit for bit
    (recorded only). Fails unless the engine is in use.
    """
    from ska_sdp_cip_tpu_torch import native
    from ska_sdp_cip_tpu_torch.models.weighting import ImagingWeighter
    from ska_sdp_cip_tpu_torch.ops.gridder import stage_slot_vis
    from ska_sdp_cip_tpu_torch.ops.plan import make_plan

    if configs is None:
        configs = {
            "bench": (bench_visibilities(BENCH_TIMES, BENCH_ANTENNAS,
                                         BENCH_CHANNELS),
                      BENCH_NPIX, BENCH_ASEC, {}),
            "production": (production_visibilities(), PROD_NPIX, PROD_ASEC,
                           {"sigma": "auto"}),
        }
    available, load_seconds = timed(native.available)
    if not available:
        raise PhaseError("planner: the native engine is not in use (no C++ "
                         "compiler on PATH)")
    out = {"phase": "planner", "engine_load_seconds": load_seconds,
           "engine_build_seconds": native.build_seconds,
           "compiler": native.compiler, "configs": {}}
    for name, (problem, npix, asec, kw) in configs.items():
        uvw, freqs, vis, wgt = problem
        pix = float(np.sin(np.radians(asec / 3600.0)))
        row = {"num_vis": int(vis.size), "npix": npix, "pixel_asec": asec}
        # The main path's plans: compact for invert, slot for predict.
        row["engine_compact_seconds"] = [
            timed(make_plan, uvw, freqs, npix, pix, export_packed=False,
                  **kw)[1] for _ in range(2)]
        slot, row["engine_slot_seconds"] = timed(make_plan, uvw, freqs, npix,
                                                 pix, **kw)
        with numpy_planner():
            ref, row["numpy_seconds"] = timed(make_plan, uvw, freqs, npix,
                                              pix, **kw)
        row["slot"] = compare_plans(
            make_plan(uvw, freqs, npix, pix, export_coords=True, **kw), ref)
        row["compact"] = compare_plans(
            make_plan(uvw, freqs, npix, pix, export_coords=True,
                      export_packed=False, **kw), ref)
        weighted = (vis * wgt).ravel()
        staged, row["engine_stage_seconds"] = timed(
            stage_slot_vis, slot, weighted.real, weighted.imag)
        with numpy_planner():
            want, row["numpy_stage_seconds"] = timed(
                stage_slot_vis, ref, weighted.real, weighted.imag)
        scale = max(float(np.abs(w).max()) for w in want)
        row["stage_rel_err"] = max(float(np.abs(g - w).max())
                                   for g, w in zip(staged, want)) / scale
        weighter = ImagingWeighter(npix, pix, scheme="uniform")
        density, row["engine_density_seconds"] = timed(
            weighter.accumulate_density, uvw, freqs, wgt)
        with numpy_planner():
            dens_ref, row["numpy_density_seconds"] = timed(
                weighter.accumulate_density, uvw, freqs, wgt)
        row["density_equal_rtol_1e-12"] = bool(
            np.allclose(density, dens_ref, rtol=1e-12, atol=0))
        # The engine (the reference's, verbatim) adds float64 with
        # atomics: whether two of its densities match is recorded only.
        row["engine_density_repeat_bit_equal"] = bit_equal(
            density, weighter.accumulate_density(uvw, freqs, wgt))
        out["configs"][name] = row
        if not (row["slot"]["equal"] and row["compact"]["equal"]
                and row["stage_rel_err"] <= 1e-6
                and row["density_equal_rtol_1e-12"]):
            raise PhaseError(f"planner {name}: the engine differs from the "
                             f"numpy planner: {row}")
    return out


#: UVW tile size (wavelengths) of the ``tiles`` phase: about 8 x 8 uv
#: tiles over the bench dataset's 38.7 kilo-wavelength extent.
TILE_SIZE = (10000.0, 10000.0, 20000.0)


def phase_tiles(device, path: Path, workdir: Path, seed=1234,
                npix=BENCH_NPIX, asec=BENCH_ASEC, intervals=4,
                workers=4) -> dict:
    """
    The tile store on the slice's dataset: ``tpu-cip-reorder-uvw-torch``
    (``run_program``, in ``workdir``), then ``invert_tile_chunks`` on the
    card (B1 and B2 launches required), against ``invert_dataset`` on
    the same data within the reference's tolerance (atol 1e-4 of the
    max, rtol 1e-3) and the float64 DFT at 448 pixels (1e-4); the
    reorder's and the invert's seconds.
    """
    from ska_sdp_cip_tpu_torch import VisibilityReader, invert_dataset
    from ska_sdp_cip_tpu_torch.apps.uvw_reorder_app import run_program
    from ska_sdp_cip_tpu_torch.uvw_tiling.tiled_invert import (
        invert_tile_chunks,
    )

    reader = VisibilityReader(path)
    outdir = workdir / "tiles"
    argv = [str(path), "-t", *map(str, TILE_SIZE), "-o", str(outdir),
            "-n", str(intervals), "-j", str(workers)]
    with contextlib.chdir(workdir):
        _, reorder_seconds = timed(run_program, argv)
    paths = sorted(outdir.glob("tile_iu*chunk*.npz"))
    pix = float(np.sin(np.radians(asec / 3600.0)))
    freqs = reader.channel_frequencies()

    def run():
        return invert_tile_chunks(paths, freqs, npix, pix, device=device)

    image, first, launches, walls = timed_calls(run, device, repeats=2)
    require_launches(launches, ("b1", "b2_out_crop"), device, "tiles")
    direct = invert_dataset(reader, npix, asec, device=device)
    scale = float(np.abs(direct).max())
    diff = np.abs(image - direct)
    within = bool((diff <= 1e-4 * scale + 1e-3 * np.abs(direct)).all())
    out = {
        "phase": "tiles", "tile_size": list(TILE_SIZE),
        "intervals": intervals, "workers": workers,
        "tile_files": len(paths),
        "tile_bytes": sum(p.stat().st_size for p in paths),
        "reorder_seconds": reorder_seconds,
        "first_invert_seconds": first, "invert_wall_seconds": walls,
        "median_invert_wall_seconds": statistics.median(walls),
        "planner": planner_name(), "launches": launches,
        "vs_invert_dataset_max_rel": float(diff.max()) / scale,
        "within_reference_tolerance": within,
        "finite": bool(np.isfinite(image).all()),
        "shape": list(image.shape),
    }
    if image.shape != (npix, npix) or not out["finite"] or not within:
        rel = out["vs_invert_dataset_max_rel"]
        raise PhaseError(f"tiles: the tiled image differs from "
                         f"invert_dataset ({rel:.3e} of the max) or is not "
                         "finite")
    rel = dft_spot_check(reader, image, expected_pixel(seed, npix, asec), pix,
                         device)
    out["dft_spot_check"] = rel
    if not rel["max_rel_err"] <= DFT_RTOL:
        raise PhaseError(f"tiles vs DFT {rel['max_rel_err']:.3e} > {DFT_RTOL}")
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
    out.update(clean_gates(model, residual, float(dirty.abs().max()),
                           sources, "major cycle"))

    out.update(step_cycles(
        op, staged, dirty,
        lambda res: hogbom_clean(res, psf, gain=0.1, max_iter=minor_iter,
                                 psf_patch=psf_patch)[0],
        num_major, device))
    if device.type == "cuda":
        out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def step_cycles(op, staged, dirty, minor, num_major: int, device,
                profile_sessions: int = 1) -> dict:
    """
    ``num_major`` major cycles step by step from the dirty image: the
    minor cycle ``minor(residual) -> model delta``, then
    ``residual_gradient``, each synchronized; their seconds, and a
    profile of one more cycle (the fullest of ``profile_sessions``
    cycles, :func:`profile_call`).
    """
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def cycle(state):
        delta = minor(state["res"])
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
    return {
        "cycle_seconds": cycles,
        "minor_cycle_seconds": list(state["minor"]),
        "residual_gradient_seconds": [
            c - m for c, m in zip(cycles, state["minor"])
        ],
        "profile_one_cycle": profile_call(
            lambda: (state.update(t=time.perf_counter()), cycle(state)),
            device, sessions=profile_sessions),
    }


def clean_gates(model, residual, dirty_peak: float, sources,
                where: str) -> dict:
    """
    The major cycle's gates on a CLEAN ``model`` and ``residual``
    (tensors or arrays): finite, the residual below 0.6 x the dirty
    peak, and the brightest CLEAN component at one of ``sources``
    (pixels (row, col) of the sources within 1% of the brightest flux),
    each of which holds CLEAN flux. Returns the readings.
    """
    import torch

    res_max = float(residual.abs().max() if torch.is_tensor(residual)
                    else np.abs(residual).max())
    model_np = model.cpu().numpy() if torch.is_tensor(model) else model
    brightest = np.unravel_index(int(np.argmax(model_np)), model_np.shape)
    sources = np.asarray(sources)
    window_flux = [
        float(model_np[max(r - 1, 0) : r + 2, max(c - 1, 0) : c + 2].sum())
        for r, c in sources
    ]
    offset = np.abs(sources - np.asarray(brightest)).max(axis=1)
    out = {
        "dirty_peak": dirty_peak,
        "residual_max": res_max,
        "residual_over_dirty_peak": res_max / dirty_peak,
        "model_sum": float(model_np.sum()),
        "components": int(np.count_nonzero(model_np)),
        "brightest_component": [int(p) for p in brightest],
        "brightest_sources": sources.tolist(),
        "model_flux_3x3_at_sources": window_flux,
        "finite": bool(np.isfinite(model_np).all() and np.isfinite(res_max)),
    }
    if not out["finite"]:
        raise PhaseError(f"{where} gave non-finite values")
    if not res_max < 0.6 * dirty_peak:
        raise PhaseError(f"{where}: residual {res_max:.4g} >= 0.6 x dirty "
                         f"peak {dirty_peak:.4g}")
    if offset.min() > 1 or min(window_flux) <= 0:
        raise PhaseError(f"{where}: brightest component at {brightest}, "
                         f"brightest sources at {sources.tolist()} with "
                         f"CLEAN flux {window_flux}")
    return out


#: Shards of the ``sharded`` phase: four shards over a world of one rank,
#: all on the one card, so every collective of a 4-device mesh runs.
SHARDS = 4
#: The sharded invert against ``invert_dataset`` (rtol, and atol of the
#: max): the JAX package's tolerance (tests/test_sharded_invert.py:17).
SHARDED_RTOL = 1e-5
#: The sharded major cycle against ``major_cycle_clean``: model and
#: residual within these fractions of the local residual's max
#: (tests/test_sharded_clean.py:59-64).
SHARDED_MODEL_TOL, SHARDED_RESIDUAL_TOL = 2e-4, 2e-3


def within_sharded_tol(got, ref) -> dict:
    """``got`` against ``ref`` at :data:`SHARDED_RTOL`: max errors and
    whether every pixel is within rtol + atol (1e-5 of the max)."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = float(np.abs(ref).max())
    diff = np.abs(got - ref)
    # The largest share of its allowance a pixel's error takes.
    gate_use = float((diff / (SHARDED_RTOL * scale
                              + SHARDED_RTOL * np.abs(ref))).max())
    return {
        "max_abs_err": float(diff.max()),
        "max_rel_err": float(diff.max()) / scale,
        "gate_use": gate_use,
        "within": bool(got.shape == ref.shape and np.isfinite(got).all()
                       and gate_use <= 1.0),
    }


def sharded_call(fn, mesh, device) -> tuple:
    """(result, seconds, launches, collectives) of one synchronized call
    of ``fn``, launch counts and the mesh's collective counts reset just
    before it."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    reset_launches()
    mesh.reset_stats()
    sync()
    t0 = time.perf_counter()
    result = fn()
    sync()
    seconds = time.perf_counter() - t0
    return result, seconds, read_launches(), mesh.collective_stats()


def sharded_invert_case(device, mesh, reader, npix, asec, fft_mode, ref,
                        repeats=1, **kw) -> dict:
    """``sharded_invert_dataset`` on ``mesh`` against ``ref`` (the
    single-device image): launches, walls, the breakdown (load, plan,
    stage, device: the recorder's steps; collectives: the mesh's)."""
    from ska_sdp_cip_tpu_torch.parallel.sharded_invert import (
        sharded_invert_dataset,
    )
    from ska_sdp_cip_tpu_torch.utils.task_metrics import TaskRecorder

    recorders = []

    def run():
        recorders.append(TaskRecorder(worker="smoke"))
        return sharded_invert_dataset(reader, npix, asec, mesh=mesh,
                                      fft_mode=fft_mode,
                                      recorder=recorders[-1], **kw)

    image, first, launches, collectives = sharded_call(run, mesh, device)
    walls = []
    for _ in range(repeats):
        walls.append(sharded_call(run, mesh, device)[1])
    steps = {t["name"]: t["duration"] for t in recorders[-1].tasks}
    require_launches(launches, ("b1", "b2_out_crop"), device,
                     f"sharded invert ({fft_mode})")
    case = {
        "fft_mode": fft_mode, "shards": mesh.num_shards,
        "first_call_seconds": first, "wall_seconds": walls,
        "launches": launches,
        "breakdown": {
            "load_seconds": steps["load_shards"],
            "plan_seconds": steps["plan_shards"],
            "stage_seconds": steps["stage_shards"],
            "device_seconds": steps["grid_fft_reduce"],
            "collective_seconds": collectives["total_seconds"],
            "collectives": collectives,
        },
        **within_sharded_tol(image, ref),
    }
    if not case["within"]:
        raise PhaseError(f"sharded invert ({fft_mode}, {npix} px) vs "
                         f"invert_dataset {case['max_rel_err']:.3e} beyond "
                         f"rtol {SHARDED_RTOL}")
    return case


def write_problem_dataset(path: Path, problem) -> Path:
    """A VZ dataset of ``problem`` (uvw, freqs, Stokes-I vis, weights):
    XX = YY = vis and per-sample weights w / 2 on each, so the Stokes-I
    conversion gives back vis and w; nothing flagged."""
    from ska_sdp_cip_tpu_torch.io.visibility_dataset import write_vz_dataset

    uvw, freqs, vis, wgt = problem
    corr = np.zeros(vis.shape + (4,), np.complex64)
    corr[..., 0] = corr[..., 3] = vis
    spectrum = np.repeat((0.5 * wgt)[..., None], 4, axis=-1)
    return write_vz_dataset(path, uvw=uvw, visibilities=corr,
                            flags=np.zeros(corr.shape, bool),
                            channel_frequencies=freqs,
                            weight_spectrum=spectrum)


def sharded_clean_case(device, mesh, reader, npix, asec, fft_mode, local,
                       **kw) -> dict:
    """``sharded_major_cycle_clean`` against the single-device ``local``
    (model, residual) at :data:`SHARDED_MODEL_TOL` /
    :data:`SHARDED_RESIDUAL_TOL` of the local residual's max."""
    from ska_sdp_cip_tpu_torch.parallel.sharded_clean import (
        sharded_major_cycle_clean,
    )
    from ska_sdp_cip_tpu_torch.utils.task_metrics import TaskRecorder

    recorder = TaskRecorder(worker="smoke")
    (model, residual, _), seconds, launches, collectives = sharded_call(
        lambda: sharded_major_cycle_clean(reader, npix, asec, mesh=mesh,
                                          fft_mode=fft_mode,
                                          recorder=recorder, **kw),
        mesh, device)
    require_launches(launches, ("b1", "b2_out_crop", "b2_in_crop", "b3"),
                     device, f"sharded major cycle ({fft_mode})")
    scale = float(np.abs(local[1]).max())
    case = {
        "fft_mode": fft_mode, "shards": mesh.num_shards,
        "seconds": seconds, "launches": launches,
        "cycle_seconds": [t["duration"] for t in recorder.tasks
                          if t["name"] == "major_cycle"],
        "collective_seconds": collectives["total_seconds"],
        "collectives": collectives,
        "model_max_abs_err": float(np.abs(model - local[0]).max()),
        "residual_max_abs_err": float(np.abs(residual - local[1]).max()),
        "scale": scale,
        "finite": bool(np.isfinite(model).all()
                       and np.isfinite(residual).all()),
    }
    if not (case["finite"]
            and case["model_max_abs_err"] <= SHARDED_MODEL_TOL * scale
            and case["residual_max_abs_err"] <= SHARDED_RESIDUAL_TOL * scale):
        raise PhaseError(
            f"sharded major cycle ({fft_mode}) vs major_cycle_clean: model "
            f"{case['model_max_abs_err'] / scale:.3e}, residual "
            f"{case['residual_max_abs_err'] / scale:.3e} of the residual "
            "max")
    return case


def torchrun_case(device, path: Path, workdir: Path, npix, asec, ref) -> dict:
    """
    ``torchrun --standalone --nproc-per-node 1 -m
    ska_sdp_cip_tpu_torch.apps.pipeline_app ... -d all`` as a subprocess
    (``python -m torch.distributed.run``, the module behind
    ``torchrun``): its image against ``ref`` and its ``task-list.json``
    in the reference's schema.
    """
    import os

    import torch

    rundir = workdir / "torchrun"
    rundir.mkdir()
    out = rundir / "image.npy"
    command = [
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc-per-node", "1", "-m",
        "ska_sdp_cip_tpu_torch.apps.pipeline_app", str(path), str(out),
        "-n", str(npix), "-p", str(asec), "-d", "all", "--device",
        device.type,
    ]
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parent)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(command, cwd=rundir, env=env, capture_output=True,
                          text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise PhaseError(f"torchrun pipeline_app failed ({proc.returncode}): "
                         f"{proc.stderr[-2000:]}")
    tasks = json.loads((rundir / "task-list.json").read_text())
    names = sorted({t["name"] for t in tasks})
    schema = sorted(tasks[0]) if tasks else []
    case = {"command": " ".join(command[1:]), "seconds": seconds,
            "task_names": names, "task_keys": schema,
            **within_sharded_tol(np.load(out), ref)}
    want = ["grid_fft_reduce", "load_shards", "plan_shards", "stage_shards"]
    keys = sorted(["key", "worker", "status", "start", "stop", "name",
                   "duration"])
    if not (case["within"] and names == want and schema == keys):
        raise PhaseError(f"torchrun pipeline_app: image {case['max_rel_err']:.3e}"
                         f" of the max, tasks {names}, keys {schema}")
    return case


def phase_sharded(device, path: Path, workdir: Path, tile_paths,
                  npix=BENCH_NPIX, asec=BENCH_ASEC, prod_problem=None,
                  prod_npix=PROD_NPIX, prod_asec=PROD_ASEC, shards=SHARDS,
                  clean_kw=None,
                  b2_grids=((BENCH_NGRID, BENCH_NPIX),
                            (PROD_NGRID, PROD_NPIX))) -> dict:
    """
    The multi-device path on one card: a process group of one rank
    (NCCL for CUDA tensors, gloo for the host's, a TCP store on the
    loopback) with one ``all_reduce`` checked, then ``shards`` shards of
    one mesh on the card:

    * ``sharded_invert_dataset`` on the slice's dataset in both FFT
      modes against ``invert_dataset`` (:data:`SHARDED_RTOL`), with walls
      and a breakdown (load, plan, stage, device, collectives);
    * both modes at the production configuration (the production
      problem's noise plus the production major cycle's five point
      sources, written as a dataset, ``sigma="auto"``) against
      ``invert_dataset``, beside a second ``invert_dataset``, which must
      give the first's bits;
    * ``sharded_major_cycle_clean`` (Hogbom, 3 cycles) in both modes
      against ``major_cycle_clean``;
    * ``sharded_invert_tile_chunks`` on the ``tiles`` phase's files in
      both modes against ``invert_tile_chunks``;
    * ``tpu-cip-torch -d all`` under torchrun (:func:`torchrun_case`);
    * B2 against its plain version at the slab widths the distributed
      mode ran (N/S and npix/S, both crops, of each (N, npix) in
      ``b2_grids``), with the bound and ``torch.fft``'s time
      (:func:`phase_b2`).
    """
    import torch
    import torch.distributed as dist

    from ska_sdp_cip_tpu_torch import VisibilityReader, invert_dataset
    from ska_sdp_cip_tpu_torch.invert import (
        StokesIGridderInput,
        pixel_size_lm_from_asec,
    )
    from ska_sdp_cip_tpu_torch.models import (
        MeasurementOperator,
        major_cycle_clean,
    )
    from ska_sdp_cip_tpu_torch.parallel.mesh import (
        backend_for,
        initialize_distributed,
        make_device_mesh,
    )
    from ska_sdp_cip_tpu_torch.uvw_tiling.tiled_invert import (
        invert_tile_chunks,
        sharded_invert_tile_chunks,
    )

    t0 = time.perf_counter()
    initialize_distributed(backend=backend_for(device))
    probe = torch.full((4,), 2.0, device=device)
    dist.all_reduce(probe)
    if device.type == "cuda":
        torch.cuda.synchronize()
    backend = str(dist.get_backend())
    out = {"phase": "sharded", "backend": backend,
           "world_size": dist.get_world_size(),
           "init_seconds": time.perf_counter() - t0,
           "all_reduce_ok": bool((probe == 2.0 * dist.get_world_size())
                                 .all())}
    if not out["all_reduce_ok"] or (device.type == "cuda"
                                    and "nccl" not in backend):
        raise PhaseError(f"process group: backend {backend}, all_reduce "
                         f"{probe.tolist()}")
    mesh = make_device_mesh(shards, device=device)
    out["mesh"] = repr(mesh)

    reader = VisibilityReader(path)
    ref = invert_dataset(reader, npix, asec, device=device)
    out["bench"] = [
        sharded_invert_case(device, mesh, reader, npix, asec, mode, ref,
                            repeats=1)
        for mode in ("replicated", "distributed")
    ]
    del ref

    if prod_problem is not None:
        # The production major cycle's sky (five point sources) on the
        # production visibilities' noise: on a pure-noise image the
        # max-relative gate reads float32 rounding magnified by the
        # image's cancellation, which any change of summation order (or
        # of staging path) redraws at 4-11e-6 of the max (PERF.md, §6).
        uvw, freqs, noise, wgt = prod_problem
        pixels, flux = point_sources(prod_npix)
        sky = noise + sparse_predict_dft(
            uvw, freqs, pixels, flux,
            float(np.sin(np.radians(prod_asec / 3600.0))), prod_npix)
        prod_path = write_problem_dataset(workdir / "production.vz",
                                          (uvw, freqs, sky, wgt))
        prod_reader = VisibilityReader(prod_path)
        prod_ref = invert_dataset(prod_reader, prod_npix, prod_asec,
                                  sigma="auto", device=device)
        # B1 sums in a fixed order: a second invert gives the same bits.
        again = invert_dataset(prod_reader, prod_npix, prod_asec,
                               sigma="auto", device=device)
        repeat = {**within_sharded_tol(again, prod_ref),
                  "bit_equal": bit_equal(again, prod_ref)}
        if not repeat["bit_equal"]:
            raise PhaseError(f"sharded: invert_dataset against itself at "
                             f"production {repeat}")
        out["production"] = {
            "npix": prod_npix,
            "repeat_vs_itself": repeat,
            "cases": [sharded_invert_case(device, mesh, prod_reader,
                                          prod_npix, prod_asec, mode,
                                          prod_ref, sigma="auto")
                      for mode in ("distributed", "replicated")],
        }
        del prod_ref, again

    clean_kw = clean_kw or {"num_major": 3, "gain": 0.1, "minor_iter": 50}
    gi = StokesIGridderInput.from_reader(reader)
    op = MeasurementOperator.build(gi.uvw, gi.channel_frequencies,
                                   gi.effective_weights(), npix,
                                   pixel_size_lm_from_asec(asec),
                                   device=device)
    model, residual = major_cycle_clean(op, gi.visibilities.ravel(),
                                        **clean_kw)
    local = (model.cpu().numpy(), residual.cpu().numpy())
    del op, model, residual, gi
    out["major_cycle"] = {
        **clean_kw,
        "cases": [sharded_clean_case(device, mesh, reader, npix, asec, mode,
                                     local, **clean_kw)
                  for mode in ("replicated", "distributed")],
    }

    freqs = reader.channel_frequencies()
    pix = pixel_size_lm_from_asec(asec)
    tiled_ref = invert_tile_chunks(tile_paths, freqs, npix, pix,
                                   device=device)
    out["tiles"] = []
    for mode in ("replicated", "distributed"):
        timings = {}
        image, seconds, launches, collectives = sharded_call(
            lambda: sharded_invert_tile_chunks(
                tile_paths, freqs, npix, pix, mesh=mesh, fft_mode=mode,
                timings=timings),
            mesh, device)
        require_launches(launches, ("b1", "b2_out_crop"), device,
                         f"sharded tiles ({mode})")
        case = {"fft_mode": mode, "seconds": seconds, "timings": timings,
                "launches": launches,
                "collective_seconds": collectives["total_seconds"],
                **within_sharded_tol(image, tiled_ref)}
        out["tiles"].append(case)
        if not case["within"]:
            raise PhaseError(f"sharded tiles ({mode}) vs invert_tile_chunks "
                             f"{case['max_rel_err']:.3e}")
    del tiled_ref

    torch_ref = invert_dataset(reader, npix, asec, sigma="auto",
                               device=device)
    out["torchrun"] = torchrun_case(device, path, workdir, npix, asec,
                                    torch_ref)
    # B2 at the slab widths of the distributed runs above, (n, npix) of
    # ``b2_grids``: the bench transform and the production one.
    out["b2_slab_widths"] = [
        case
        for n, crop in b2_grids
        for case in phase_b2(device, n, crop, iters=5,
                             widths=(n // shards, crop // shards))["cases"]
    ]
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
    repeat_bit_equal = bit_equal(image, run())
    if not repeat_bit_equal:
        raise PhaseError("production: two dirty_image calls differ")
    pts = np.random.default_rng(1).integers(0, npix, size=(dft_pixels, 2))
    ref = dft_at_pixels(uvw, freqs, vis * wgt, pts, pix, npix, device)
    err = float(np.abs(image[pts[:, 0], pts[:, 1]] - ref).max())
    plan, arrays, re_s, im_s = staged_problem(uvw, freqs, vis, wgt, npix,
                                              asec, device, sigma="auto")
    k = largest_group(plan)
    b1_check = {"group": k, **compare_group(
        plan, group_args(plan, arrays, re_s, im_s, k),
        group_grid_chunks(plan, arrays, k), time_it=True)}
    del arrays, re_s, im_s
    out = {
        "phase": "production", "part": "invert", "npix": npix,
        "pixel_asec": asec, "num_vis": int(vis.size),
        "plan": plan_summary(plan),
        "first_call_seconds": first, "wall_seconds": walls,
        "median_wall_seconds": statistics.median(walls),
        "launches": launches,
        "repeat_bit_equal": repeat_bit_equal,
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
    noise image I (float64 dot products on the host), gated as
    |lhs - rhs| / (|I| |D|) <= 1e-6 (its dot product cancels, so the
    reading relative to |lhs|, ``adjoint_rel``, is float32 rounding
    magnified and only printed), also
    read on ``spread`` more dirty images, which must give the first's
    bits (B1 sums in a fixed order), on three noise images with both
    operators' B2 passes done by the kernel, its plain version and the
    exact transform, and with predict's passes in the other order
    (:func:`adjoint_witness`), and for I = the dirty image itself
    (no cancellation; rel 1e-4); a
    sparse image of five seeded point sources against a float64 DFT of
    its nonzero pixels at ``samples`` random visibilities (1e-4 of the
    max); B3 against its plain version on the plan's largest plane
    group of random planes; the median wall of ``repeats`` calls,
    launch counts, a breakdown and a profile of the device part.
    """
    from ska_sdp_cip_tpu_torch.ops.gridder import (
        dirty_image,
        predict_visibilities,
        slot_plan_host_arrays,
        stage_arrays,
    )
    from ska_sdp_cip_tpu_torch.ops.plan import make_plan

    uvw, freqs, vis, wgt = problem
    pix = float(np.sin(np.radians(asec / 3600.0)))
    image = noise_image(npix, WITNESS_SEEDS[0])

    def run(img=image):
        return predict_visibilities(uvw, freqs, img, pix, sigma="auto",
                                    device=device)

    model, first, launches, walls = timed_calls(run, device, repeats)
    require_launches(launches, ("b3", "b2_in_crop"), device,
                     "production predict")
    weighted = (vis * wgt).astype(np.complex128)
    lhs = float(np.vdot(image.astype(np.float64), dirty.astype(np.float64)))
    rhs = float(np.real(np.vdot(model.astype(np.complex128), weighted)))
    # B1 sums in a fixed order, so more dirty images give the first's
    # bits and the identity read on them does not move.
    more = [dirty_image(uvw, freqs, vis, wgt, npix, pix, sigma="auto",
                        device=device) for _ in range(spread)]
    spread_bit_equal = all(bit_equal(d, dirty) for d in more)
    lhs_more = [float(np.vdot(image.astype(np.float64), d.astype(np.float64)))
                for d in more]
    del more
    # I = the dirty image: <D, D> has no cancellation, so this reading
    # is the operators' float32 mismatch itself.
    d64 = dirty.astype(np.float64)
    unit = (d64 / np.linalg.norm(d64)).astype(np.float32)
    lhs_d = float(np.vdot(unit.astype(np.float64), d64))
    rhs_d = float(np.real(np.vdot(run(unit).astype(np.complex128),
                                  weighted)))
    plan = make_plan(uvw, freqs, npix, pix, sigma="auto")
    images = {WITNESS_SEEDS[0]: image}
    images.update({s: noise_image(npix, s) for s in WITNESS_SEEDS[1:]})
    witness = adjoint_witness(problem, images, plan.ngrid, pix, device)
    del images
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
    b3_check = {"group": k, **compare_degrid(
        plan, arrays, grids, k, group_chunks(plan, arrays, k),
        time_it=True)}
    del arrays, grids
    norms = float(np.linalg.norm(image.astype(np.float64))
                  * np.linalg.norm(d64))
    out = {
        "phase": "production", "part": "predict", "npix": npix,
        "num_vis": int(model.size),
        "adjoint_lhs": lhs, "adjoint_rhs": rhs,
        "adjoint_rel": abs(lhs - rhs) / abs(lhs),
        "adjoint_rel_other_dirty_images": [abs(x - rhs) / abs(x)
                                           for x in lhs_more],
        "other_dirty_images_bit_equal": spread_bit_equal,
        # |lhs| / (|I| |D|): how far the noise image's dot product
        # cancels, which scales every float32 error in D up to the
        # identity's reading.
        "adjoint_cancellation": abs(lhs) / norms,
        # The gated reading: |lhs - rhs| / (|I| |D|) = adjoint_rel x
        # adjoint_cancellation, which no cancellation magnifies.
        "adjoint_err_over_norms": abs(lhs - rhs) / norms,
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
    if not (out["finite"]
            and out["adjoint_err_over_norms"] <= ADJOINT_NORM_TOL
            and out["adjoint_rel_dirty_image"] <= DFT_RTOL):
        raise PhaseError(f"production adjoint identity: noise image "
                         f"{out['adjoint_err_over_norms']:.3e} of |I| |D| "
                         f"(limit {ADJOINT_NORM_TOL}), I = the dirty image "
                         f"{out['adjoint_rel_dirty_image']:.3e} (limit "
                         f"{DFT_RTOL})")
    if not spread_bit_equal:
        raise PhaseError("production: dirty_image called again differs "
                         "from the first")
    if not out["sparse_dft_check"]["rel_to_max"] <= DFT_RTOL:
        raise PhaseError(f"production predict vs DFT "
                         f"{out['sparse_dft_check']['rel_to_max']:.3e}")
    out["breakdown"] = predict_breakdown(uvw, freqs, image, pix, device,
                                         sigma="auto")
    return out


@contextlib.contextmanager
def predict_rows_first():
    """Run predict's two B2 passes in the other order: along the image's
    rows first, then its columns (the grid comes out transposed and is
    copied into the stack). A witness of what the pass order does to
    the adjoint identity, not a path of the port."""
    from ska_sdp_cip_tpu_torch.ops import fft_cuda, gridder

    def run(f, img_t_re, img_t_im, *, meta, out, **kw):
        b_re, b_im = fft_cuda.fft2_from_image_fused(
            f, img_t_re.t().contiguous(), img_t_im.t().contiguous(),
            meta=meta, **kw)
        out[0].copy_(b_re.t())
        out[1].copy_(b_im.t())
        return out

    saved = gridder.fft2_from_image_fused
    gridder.fft2_from_image_fused = run
    try:
        yield
    finally:
        gridder.fft2_from_image_fused = saved


def noise_image(npix: int, seed: int) -> np.ndarray:
    """A standard-normal float32 (npix, npix) image made from ``seed``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return torch.randn((npix, npix), generator=gen).numpy()


#: The adjoint witness's variants: B2 as the kernel, its plain version or
#: the exact transform, predict's passes in the path's order or rows first;
#: and the seeds of its noise images (the first is the gated reading's).
WITNESS_VARIANTS = ("kernel", "plain_b2", "plain_b2_rows_first", "exact_b2")
WITNESS_SEEDS = (79, 80, 81)


def adjoint_witness(problem, images: dict, ngrid: int, pix: float, device,
                    variants=WITNESS_VARIANTS) -> dict:
    """
    The production adjoint identity for each noise image of ``images``
    (seed -> image) with every B2 pass of both operators done by the
    kernel, replaced (:func:`b2_replaced`) by B2's plain version
    (``plain_b2``) or by the exact transform (``exact_b2``), and with
    predict's passes in the other order (``_rows_first``,
    :func:`predict_rows_first`): one dirty image and a predict of each
    image a variant. The spread over the images is the size of float32
    rounding in the reading; a variant whose readings stay where the
    kernel's are does not carry the offset.
    """
    from ska_sdp_cip_tpu_torch.ops.gridder import (
        dirty_image,
        predict_visibilities,
    )

    uvw, freqs, vis, wgt = problem
    weighted = (vis * wgt).astype(np.complex128)
    passes = {"kernel": None, "plain_b2": plain_b2(ngrid, device),
              "exact_b2": exact_b2}
    npix = next(iter(images.values())).shape[0]
    out = {}
    for name in variants:
        pass_fn = passes[name.removesuffix("_rows_first")]
        with (b2_replaced(pass_fn) if pass_fn else contextlib.nullcontext()):
            dirty = dirty_image(uvw, freqs, vis, wgt, npix, pix,
                                sigma="auto",
                                device=device).astype(np.float64)
            with (predict_rows_first() if name.endswith("_rows_first")
                  else contextlib.nullcontext()):
                models = {seed: predict_visibilities(
                    uvw, freqs, image, pix, sigma="auto", device=device)
                    for seed, image in images.items()}
        rel, cancel = {}, {}
        for seed, image in images.items():
            i64 = image.astype(np.float64)
            lhs = float(np.vdot(i64, dirty))
            rhs = float(np.real(np.vdot(models[seed].astype(np.complex128),
                                        weighted)))
            rel[seed] = abs(lhs - rhs) / abs(lhs)
            cancel[seed] = abs(lhs) / float(np.linalg.norm(i64)
                                            * np.linalg.norm(dirty))
        out[name] = {"adjoint_rel": rel}
        # |lhs| / (|I| |D|) of each image: the factor by which the dot
        # product's cancellation scales the operators' rounding up into
        # the reading (the same for every variant).
        out.setdefault("cancellation", cancel)
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


CLI_OUTPUTS = (".npy", ".model.npy", ".residual.npy", ".restored.npy")


@contextlib.contextmanager
def recorded_fista_traces(traces: list):
    """Append the trace of every ``fista_clean`` call to ``traces`` (the
    CLI keeps only the model and the residual)."""
    from ska_sdp_cip_tpu_torch.models import fista

    saved = fista.fista_clean

    def run(*args, **kwargs):
        out = saved(*args, **kwargs)
        traces.append(out[2])
        return out

    fista.fista_clean = run
    try:
        yield
    finally:
        fista.fista_clean = saved


def cli_call(device, argv) -> dict:
    """``run_program(argv)`` in process: its synchronized wall and the
    kernels' launch counts."""
    import torch

    from ska_sdp_cip_tpu_torch.apps.pipeline_app import run_program

    reset_launches()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    run_program([str(a) for a in argv])
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {"wall_seconds": time.perf_counter() - t,
            "launches": read_launches()}


def phase_solvers_cli(device, path: Path, workdir: Path, seed=1234,
                      npix=BENCH_NPIX, asec=BENCH_ASEC, minor_iter=100,
                      fista_minor_iter=30) -> dict:
    """
    ``tpu-cip-torch`` in process (``run_program``, ``--device`` the
    card) on the slice's dataset: the dirty image with robust (R = 0)
    and uniform weighting, each against the float64 DFT of its
    reweighted visibilities at 256 pixels (1e-4 of the max);
    ``--clean 2 --algorithm multiscale`` (scales 0 2 4 8) with the major
    cycle's gates and its four files finite; ``--clean 1 --algorithm
    fista --minor-iter 30`` (3 iterations): residual peak below the
    dirty peak, model >= 0, a finite trace. Each call's wall and launch
    counts.
    """
    from ska_sdp_cip_tpu_torch import VisibilityReader

    reader = VisibilityReader(path)
    pix = float(np.sin(np.radians(asec / 3600.0)))
    expected = expected_pixel(seed, npix, asec)
    out = {"phase": "solvers", "part": "cli", "npix": npix,
           "pixel_asec": asec, "num_vis": reader.num_data_rows
           * reader.num_channels, "calls": {}}

    def argv(name, *extra):
        return [path, workdir / f"{name}.npy", "-n", npix, "-p", asec,
                "--device", device, *extra]

    def load(name):
        images = {suffix: np.load(workdir / f"{name}{suffix}")
                  for suffix in CLI_OUTPUTS}
        if not all(np.isfinite(x).all() and x.shape == (npix, npix)
                   for x in images.values()):
            raise PhaseError(f"cli {name}: an output is not finite or has "
                             "the wrong shape")
        return images

    for scheme in ("robust", "uniform"):
        call = cli_call(device, argv(scheme, "--weighting", scheme,
                                     "--robust", 0.0))
        require_launches(call["launches"], ("b1", "b2_out_crop"), device,
                         f"cli {scheme}")
        image = np.load(workdir / f"{scheme}.npy")
        call["finite"] = bool(np.isfinite(image).all())
        call["dft_check"] = dft_spot_check(reader, image, expected, pix,
                                           device, weighting=(scheme, 0.0),
                                           window=8)
        out["calls"][scheme] = call
        if not (call["finite"]
                and call["dft_check"]["max_rel_err"] <= DFT_RTOL):
            raise PhaseError(f"cli {scheme} vs DFT {call['dft_check']}")

    call = cli_call(device, argv("multiscale", "--clean", 2, "--algorithm",
                                 "multiscale", "--minor-iter", minor_iter))
    require_launches(call["launches"], ("b1", "b2_out_crop", "b2_in_crop",
                                        "b3"), device, "cli multiscale")
    images = load("multiscale")
    call.update(clean_gates(
        images[".model.npy"], images[".residual.npy"],
        float(np.abs(images[".npy"]).max()),
        brightest_pixels(seed, npix, asec, within=0.01), "cli multiscale"))
    out["calls"]["multiscale"] = call

    traces = []
    with recorded_fista_traces(traces):
        call = cli_call(device, argv("fista", "--clean", 1, "--algorithm",
                                     "fista", "--minor-iter",
                                     fista_minor_iter))
    require_launches(call["launches"], ("b1", "b2_out_crop", "b2_in_crop",
                                        "b3"), device, "cli fista")
    images = load("fista")
    dirty_peak = float(np.abs(images[".npy"]).max())
    res_max = float(np.abs(images[".residual.npy"]).max())
    call.update({
        "iterations": len(traces[0]), "trace": traces[0].tolist(),
        "dirty_peak": dirty_peak, "residual_max": res_max,
        "model_min": float(images[".model.npy"].min()),
        "model_max": float(images[".model.npy"].max()),
    })
    out["calls"]["fista"] = call
    if not (np.isfinite(traces[0]).all() and call["model_min"] >= 0.0
            and res_max < dirty_peak):
        raise PhaseError(f"cli fista: trace {call['trace']}, model min "
                         f"{call['model_min']}, residual {res_max:.4g} vs "
                         f"dirty peak {dirty_peak:.4g}")
    return out


def production_operator(device, problem, npix=PROD_NPIX,
                        asec=PROD_ASEC) -> tuple:
    """
    The production major cycle's problem (five seeded point sources,
    :func:`phase_production_major_cycle`) with its operator built as
    the CLI builds it (epsilon 1e-4, w-stacking, sigma "auto") and its
    visibilities staged: (operator, staged, source pixels, seconds).
    """
    import torch

    from ska_sdp_cip_tpu_torch.models import MeasurementOperator

    uvw, freqs, _, wgt = problem
    pix = float(np.sin(np.radians(asec / 3600.0)))
    pixels, flux = point_sources(npix)
    vis = sparse_predict_dft(uvw, freqs, pixels, flux, pix, npix)
    order = np.argsort(-flux)
    sources = pixels[order[flux[order] >= 0.99 * flux.max()]]
    t = time.perf_counter()
    op = MeasurementOperator.build(uvw, freqs, wgt, npix, pix, epsilon=1e-4,
                                   do_wstacking=True, sigma="auto",
                                   device=device)
    staged = op.stage(vis.astype(np.complex64).ravel())
    if device.type == "cuda":
        torch.cuda.synchronize()
    return op, staged, sources, {"build_and_stage_seconds":
                                 time.perf_counter() - t}


def conv_timing(image, kernel, crop=1024, iters=3) -> dict:
    """
    ``_conv_same`` of ``image`` with ``kernel`` on the card: its time
    (CUDA events, mean of ``iters`` calls after a warm one) and the
    same convolution's with cuDNN's TF32 allowed (what a float32
    ``conv2d`` runs as by PyTorch's default); the error of each against
    the float64 convolution on the image's central ``crop`` square,
    relative to its max.
    """
    import torch

    from ska_sdp_cip_tpu_torch.models.multiscale import _conv_same

    if image.device.type != "cuda":
        return {"ms": "not measured"}

    def tf32(x, k):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            return torch.nn.functional.conv2d(x[None, None], k[None, None],
                                              padding="same")[0, 0]

    def ms(fn):
        fn(image, kernel)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(image, kernel)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    n = image.shape[0]
    lo = (n - crop) // 2
    part = image[lo : lo + crop, lo : lo + crop]
    exact = _conv_same(part.double(), kernel.double())
    scale = float(exact.abs().max())
    out = {"shape": list(image.shape), "kernel": list(kernel.shape),
           "ms": ms(_conv_same), "tf32_ms": ms(tf32)}
    out["gflop_per_s"] = 2 * image.numel() * kernel.numel() / out["ms"] / 1e6
    out["max_rel_err_vs_f64"] = float(
        (_conv_same(part, kernel).double() - exact).abs().max()) / scale
    out["tf32_max_rel_err_vs_f64"] = float(
        (tf32(part, kernel).double() - exact).abs().max()) / scale
    return out


def phase_solvers_production_multiscale(device, op, staged, sources,
                                        scales=(0.0, 2.0, 4.0, 8.0),
                                        num_major=2, minor_iter=100,
                                        psf_patch="auto") -> dict:
    """
    ``multiscale_clean(scales, num_major, minor_iter)`` at the
    production configuration (``psf_patch`` "auto" = 2048 at 10240 px:
    the Clark multiscale path) with the major cycle's gates, its
    seconds, peak device memory and launch counts; then the one-off
    pieces of a minor cycle (the scale-convolved residual frames, the
    cross-PSF windows; the frames also under the profiler) and
    ``_conv_same`` alone (:func:`conv_timing`), the cycles step by step
    and a profile of one (the fullest of three sessions).
    """
    import torch

    from ska_sdp_cip_tpu_torch.models import multiscale as ms
    from ska_sdp_cip_tpu_torch.models.clean import pick_psf_patch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    npix = op.plan.num_pixels
    if psf_patch == "auto":
        psf_patch = pick_psf_patch(npix)
    out = {"phase": "solvers", "part": "production_multiscale",
           "npix": npix, "scales": list(scales), "num_major": num_major,
           "minor_iter": minor_iter, "psf_patch": psf_patch}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sync()
    t = time.perf_counter()
    model, residual = ms.multiscale_clean(
        op, staged, scales=scales, num_major=num_major,
        minor_iter=minor_iter, psf_patch=psf_patch)
    sync()
    out["multiscale_clean_seconds"] = time.perf_counter() - t
    out["launches"] = read_launches()
    if device.type == "cuda":
        out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2**30
    require_launches(out["launches"], ("b1", "b2_out_crop", "b2_in_crop",
                                       "b3"), device, "production multiscale")
    dirty = op.dirty_image(staged)
    out.update(clean_gates(model, residual, float(dirty.abs().max()),
                           sources, "production multiscale"))
    del model, residual

    psf = op.psf()
    kernels, biases = ms.scale_kernels_and_biases(scales, 0.6, device)
    S = len(scales)
    sync()
    t = time.perf_counter()
    frames = ms._scale_frames(dirty, kernels, S, (psf_patch or npix) // 2)
    sync()
    out["scale_frames_seconds"] = time.perf_counter() - t
    del frames
    # One session: its count of convolutions shows whether the profiler
    # dropped records this time.
    out["profile_scale_frames"] = profile_call(
        lambda: ms._scale_frames(dirty, kernels, S, (psf_patch or npix) // 2),
        device)
    t = time.perf_counter()
    if psf_patch is not None and psf_patch < npix:
        psf_win, m0 = ms._clark_psf_window(psf, kernels.shape[1], psf_patch)
        ms._neg_cross_psfs(psf_win, kernels, S, crop=(m0, psf_patch))
    else:
        ms._neg_cross_psfs(psf, kernels, S)
    sync()
    out["cross_psf_seconds"] = time.perf_counter() - t
    out["conv"] = conv_timing(dirty, kernels[-1])
    out.update(step_cycles(
        op, staged, dirty,
        lambda res: ms._multiscale_minor(
            res, psf, kernels, biases, gain=0.1, max_iter=minor_iter,
            num_scales=S, psf_patch=psf_patch)[0],
        num_major, device, profile_sessions=3))
    return out


def phase_solvers_production_fista(device, op, staged, num_iter=3) -> dict:
    """
    ``fista_clean(num_iter)`` at the production configuration, gated on
    a finite trace, a model >= 0 and a residual peak below the dirty
    peak, with its seconds and launch counts; then the power method's
    seconds and step size, and the seconds per iteration (``num_iter``
    iterations less one, at that step size, over ``num_iter`` - 1).
    """
    import torch

    from ska_sdp_cip_tpu_torch.models.fista import (
        fista_clean,
        power_method_step_size,
    )

    def timed(fn):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        result = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        return result, time.perf_counter() - t

    dirty_peak = float(op.dirty_image(staged).abs().max())
    reset_launches()
    (model, residual, trace), seconds = timed(
        lambda: fista_clean(op, staged, num_iter=num_iter))
    out = {"phase": "solvers", "part": "production_fista",
           "npix": op.plan.num_pixels, "num_iter": num_iter,
           "fista_clean_seconds": seconds, "launches": read_launches(),
           "trace": trace.tolist(), "dirty_peak": dirty_peak,
           "residual_max": float(residual.abs().max()),
           "model_min": float(model.min()), "model_max": float(model.max())}
    del model, residual
    require_launches(out["launches"], ("b1", "b2_out_crop", "b2_in_crop",
                                       "b3"), device, "production fista")
    if not (np.isfinite(trace).all() and out["model_min"] >= 0.0
            and out["residual_max"] < dirty_peak):
        raise PhaseError(f"production fista: trace {out['trace']}, model "
                         f"min {out['model_min']}, residual "
                         f"{out['residual_max']:.4g} vs dirty peak "
                         f"{dirty_peak:.4g}")
    out["step_size"], out["power_method_seconds"] = timed(
        lambda: power_method_step_size(op))
    _, many = timed(lambda: fista_clean(op, staged, num_iter=num_iter,
                                        step_size=out["step_size"]))
    _, one = timed(lambda: fista_clean(op, staged, num_iter=1,
                                       step_size=out["step_size"]))
    out["seconds_per_iteration"] = (many - one) / max(num_iter - 1, 1)
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
    # B1/B3 (and B4/B5): also a zeroing of B1's planes (which B1 no
    # longer needs) and the fold or unfold that left the path, timed on
    # the same planes; B1's two launches' bit equality.
    grid_keys = ("group", "G", "active_blocks", "chunks", "max_rel_err",
                 "repeat_bit_equal", "zero_ms", "fold_ms")
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
    def grid_row(case, keys):
        return {k: case[k] for k in keys if k in case}

    entries = [
        kernel_entry(
            "grid_planes", "grid.cu",
            "ska_sdp_cip_tpu/ops/pallas_gridder.py:298",
            count("b1", "slice"), paths("b1"),
            **grid_row(b1["bench"], row_keys + grid_keys),
            production=grid_row(production["b1"], grid_keys + prod_keys),
        ),
        kernel_entry(
            "grid_planes[G=1]", "grid.cu",
            "ska_sdp_cip_tpu/ops/pallas_gridder.py:669",
            count("b4", "e2e_small"), paths("b4"),
            **grid_row(b1["bench_w0"], row_keys + grid_keys),
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
            slab_widths=[{k: c[k] for k in b2_keys}
                         for c in b2.get("slab_widths", [])
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
            **grid_row(b3["bench"], row_keys + grid_keys),
            production=grid_row(production["b3"], grid_keys + prod_keys),
        ),
        kernel_entry(
            "degrid_planes[G=1]", "degrid.cu",
            "ska_sdp_cip_tpu/ops/pallas_gridder.py:806",
            count("b5", "predict_small"), paths("b5"),
            **grid_row(b3["bench_w0"], row_keys + grid_keys),
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
        "cudnn": torch.backends.cudnn.version(),
        "build_seconds": _build.build_seconds,
        "ptxas": ptxas,
    })
    emit(phase_planner(device))
    bench = bench_problem(device)
    bench_w0 = bench_problem(device, do_wstacking=False)
    b1 = phase_b1(device, bench, bench_w0)
    emit(b1)
    b2 = phase_b2(device, widths=(BENCH_NGRID, BENCH_NPIX, BENCH_NPIX - 2))
    b2["production"] = phase_b2(device, PROD_NGRID, PROD_NPIX,
                                iters=5)["cases"]
    emit(b2)
    b3 = phase_b3(device, bench, bench_w0)
    emit(b3)
    del bench_w0
    e2e = phase_e2e_small(device)
    emit(e2e)
    pred = phase_predict(device, bench)
    emit(pred)
    del bench
    with tempfile.TemporaryDirectory() as tmp:
        path, dataset_seconds = make_dataset(Path(tmp))
        sl = phase_slice(device, path, dataset_seconds)
        emit(sl)
        ms = phase_ms(device, path, Path(tmp), sl["launches"])
        emit(ms)
        mc = phase_major_cycle(device, path)
        emit(mc)
        tiles = phase_tiles(device, path, Path(tmp))
        emit(tiles)
        problem = production_visibilities()
        sharded = phase_sharded(
            device, path, Path(tmp),
            sorted((Path(tmp) / "tiles").glob("tile_iu*chunk*.npz")),
            prod_problem=problem)
        emit(sharded)
        b6 = phase_b6(device)
        emit(b6)
        probes = phase_fft_probes(device)
        emit(probes)
        p_inv, dirty = phase_production_invert(device, problem)
        emit(p_inv)
        p_pred = phase_production_predict(device, problem, dirty)
        emit(p_pred)
        del dirty
        p_mc = phase_production_major_cycle(device, problem)
        emit(p_mc)
        cli = phase_solvers_cli(device, path, Path(tmp))
        emit(cli)
    op, staged, sources, build = production_operator(device, problem)
    p_ms = phase_solvers_production_multiscale(device, op, staged, sources)
    p_ms.update(build)
    emit(p_ms)
    p_fista = phase_solvers_production_fista(device, op, staged)
    emit(p_fista)
    del op, staged
    production = {"b1": p_inv["b1_check"], "b3": p_pred["b3_check"]}
    by_sharded = {
        f"sharded_invert_{c['fft_mode']}": c["launches"]
        for c in sharded["bench"]}
    by_sharded.update({
        f"sharded_production_{c['fft_mode']}": c["launches"]
        for c in sharded["production"]["cases"]})
    by_sharded.update({
        f"sharded_major_cycle_{c['fft_mode']}": c["launches"]
        for c in sharded["major_cycle"]["cases"]})
    by_sharded.update({f"sharded_tiles_{c['fft_mode']}": c["launches"]
                       for c in sharded["tiles"]})
    b2["slab_widths"] = sharded["b2_slab_widths"]
    emit({"kernels": kernels_line(b1, b2, b3, b6, probes, production, {
        **by_sharded,
        "e2e_small": e2e["launches"],
        "predict_small": pred["small_launches"],
        "slice": sl["launches"], "ms": ms["launches"],
        "predict": pred["bench"]["launches"],
        "major_cycle": mc["launches"], "tiles": tiles["launches"],
        "production_invert": p_inv["launches"],
        "production_predict": p_pred["launches"],
        "production_major_cycle": p_mc["launches"],
        "cli_multiscale": cli["calls"]["multiscale"]["launches"],
        "cli_fista": cli["calls"]["fista"]["launches"],
        "production_multiscale": p_ms["launches"],
        "production_fista": p_fista["launches"],
    })})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


def shutdown() -> None:
    """Leave the ``sharded`` phase's process group, if it is up."""
    try:
        from ska_sdp_cip_tpu_torch.parallel.mesh import shutdown_distributed
    except ImportError:
        return
    shutdown_distributed()


if __name__ == "__main__":
    try:
        code = main()
    except PhaseError as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        code = 1
    finally:
        shutdown()
    sys.exit(code)
