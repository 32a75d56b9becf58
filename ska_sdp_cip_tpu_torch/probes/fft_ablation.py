"""
Stage ablation of kernel B2 (P2; counterpart
``scripts/fft_ablation_probe.py``, variants ``dma``, ``s1``, ``s1tw``,
``s1twtr``, ``full``).

    python -m ska_sdp_cip_tpu_torch.probes.fft_ablation [ngrid]

B2's own two stage kernels (``csrc/fft_stages.cuh``), launched by
``csrc/fft_probes.cu`` on B2's grid and shared memory alone, together
or cut down, on the out-cropped pass at sign +1:

* ``load``: stage 1's tiles staged into shared memory by B2's fetch and
  written straight back; the output equals the input exactly;
* ``load2``: the same over z on stage 2's grid; it equals z exactly;
* ``s1``: B2's stage-1 kernel storing y with no twiddle;
* ``s1tw``: B2's first launch; it equals B2's z bit for bit;
* ``s2``: B2's second launch on B2's z; it equals B2's output;
* ``full``: both launches; it equals B2's output.

Each is also held within 1e-5 of the max of its plain version: the
stages of the torch ``fft_first_axis`` (``ops/fft.py``) cut at the same
points, a clone for the load variants. :func:`run` times each variant
(median of 3 CUDA-event runs after a warm one), its plain version and
one PyTorch call of about the same function, and gives its bytes'
bound at 3.35 TB/s and the blocks an SM its launch gets. The
counterpart's ``s1twtr`` (its in-VMEM transpose between the stages)
has no counterpart here: the two-launch design writes z to device
memory and stage 2 reads it in the layout stage 1 wrote.
"""

from __future__ import annotations

import ctypes
import math
import sys

import torch

from ..ops import _build
from ..ops.fft import first_axis_stage1, first_axis_stage2
from ..ops.fft_cuda import (
    PROBE_COLUMNS,
    fft_first_axis_fused,
    fft_first_axis_reference,
    pass_args,
    pass_factors,
    sub_fft_columns,
)
from . import common

VARIANTS = ("load", "load2", "s1", "s1tw", "s2", "full")

#: The variants whose input is z (n1 n2, m) rather than the pass's.
Z_INPUT = ("load2", "s2")

#: Launches of the probe kernels per variant (one per :func:`ablation`
#: call on CUDA tensors; ``full`` is two kernels in one call).
LAUNCHES = {v: 0 for v in VARIANTS}


def rows_in(variant: str, meta) -> int:
    return meta.n1 * meta.n2 if variant in Z_INPUT else meta.n1_in * meta.n2


def rows_out(variant: str, meta) -> int:
    if variant == "load":
        return meta.n1_in * meta.n2
    if variant in ("load2", "s1", "s1tw"):
        return meta.n1 * meta.n2
    return meta.size


def _check(variant: str, xr, xi, meta) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    if meta.in_size:
        raise ValueError("the probe runs the out-cropped pass only")
    rows = rows_in(variant, meta)
    if xr.dim() != 2 or xr.shape != xi.shape or xr.shape[0] != rows:
        raise ValueError(f"{variant} takes ({rows}, m) re/im, got "
                         f"{tuple(xr.shape)}")
    if xr.device != xi.device:
        raise ValueError("re and im must be on one device")


def check_columns(meta) -> None:
    """Raise unless B2 runs both stages of the pass on the probe
    kernels' :data:`PROBE_COLUMNS`-column tiles."""
    cols = (sub_fft_columns(meta.n1), sub_fft_columns(meta.n2))
    if cols != (PROBE_COLUMNS, PROBE_COLUMNS):
        raise ValueError(f"the probe kernels take {PROBE_COLUMNS}-column "
                         f"tiles; B2 runs this pass's stages on {cols}")


def ablation_reference(variant: str, xr, xi, f, *, meta):
    """Plain torch version of one variant, from the plan factors
    ``fft_*`` (sign +1): z and y in B2's (n1 n2, m) layout."""
    _check(variant, xr, xi, meta)
    n1, n2, m = meta.n1, meta.n2, xr.shape[1]
    if variant in ("load", "load2"):
        return xr.clone(), xi.clone()
    if variant == "full":
        return fft_first_axis_reference(xr, xi, f, meta=meta, sign=+1)
    if variant == "s2":
        z2 = torch.cat([xr.reshape(n1, n2, m), xi.reshape(n1, n2, m)], 1)
        return first_axis_stage2(
            z2, f, sign=+1,
            out_crop=(meta.k2a * n1 + meta.trim0, meta.size))
    if variant == "s1tw":
        return common.plain_z(xr, xi, f, meta=meta)
    yr, yi = first_axis_stage1(xr, xi, f, sign=+1)
    return yr.reshape(n1 * n2, m), yi.reshape(n1 * n2, m)


def occupancy(info) -> dict:
    """The probe entries' info (blocks an SM, blocks) per stage."""
    return {f"stage{k + 1}": {"blocks_per_sm": info[2 * k],
                              "blocks": info[2 * k + 1]}
            for k in range(2) if info[2 * k + 1]}


def ablation(variant: str, xr, xi, f, *, meta, stats: dict | None = None):
    """
    Run one variant on (rows, m) float32 re/im: the pass's (n, m) input,
    or z (n1 n2, m) for ``load2`` and ``s2``. Returns the variant's
    output (:func:`rows_out` rows). CUDA tensors go to the probe kernel
    (or raise; the factors are ``fftp_*`` at sign +1); CPU tensors to
    :func:`ablation_reference`. ``stats``, if given, receives the blocks
    an SM and the blocks of each launch.
    """
    _check(variant, xr, xi, meta)
    if xr.device.type == "cpu":
        return ablation_reference(variant, xr, xi, f, meta=meta)
    if xr.device.type != "cuda":
        raise ValueError(f"unsupported device {xr.device}")
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError("re/im must be float32")
    check_columns(meta)
    fac = pass_factors(f, meta, sign=+1, prefix="fftp", device=xr.device)
    xr, xi = xr.contiguous(), xi.contiguous()
    m = xr.shape[1]

    def pair(rows):
        t = torch.empty((rows, m), dtype=torch.float32, device=xr.device)
        return t, torch.empty_like(t)

    if variant in Z_INPUT:
        z, out = (xr, xi), pair(rows_out(variant, meta))
    elif variant == "load":
        out = pair(rows_out(variant, meta))
        z = out  # not read
    else:
        z = pair(meta.n1 * meta.n2)
        out = pair(meta.size) if variant == "full" else z
    info = (ctypes.c_int * 4)()
    lib = _build.load_library()
    err = lib.cip_fft_ablation(
        VARIANTS.index(variant),
        *pass_args(xr, xi, fac, z, out, meta, sign=+1,
                   rows=meta.n1_in * meta.n2, pad_lo=0),
        int(m), info, torch.cuda.current_stream(xr.device).cuda_stream,
    )
    _build.check(err, f"cip_fft_ablation({variant})")
    LAUNCHES[variant] += 1
    if stats is not None:
        stats.update(occupancy(info))
    return out


def library_call(variant: str, x, meta, device):
    """(ms, what) of one PyTorch call of about a variant's function on
    its input ``x``: a clone for the load variants, else
    ``torch.fft.ifft`` of the complex64 input (packed outside the timing)
    along the pass's axis (``full``), or along n1 (``s1``, ``s1tw``) or
    n2 (``s2``) of its (n1, n2, m) view."""
    n1, n2, m = meta.n1, meta.n2, x[0].shape[1]
    if variant in ("load", "load2"):
        return (common.median_ms(lambda: (x[0].clone(), x[1].clone()),
                                 device),
                "clone() of re and im")
    if device.type != "cuda":
        return "not measured", None
    c = torch.complex(*x)
    if variant == "full":
        what = (f"torch.fft.ifft(complex64 ({n1 * n2}, {m}), dim=0): "
                "uncentred, uncropped")
        ms = common.median_ms(lambda: torch.fft.ifft(c, dim=0), device)
    else:
        dim = 1 if variant == "s2" else 0
        c = c.view(n1, n2, m)
        what = (f"torch.fft.ifft(complex64 ({n1}, {n2}, {m}), dim={dim}): "
                "without the centring signs, the twiddle and the crop")
        ms = common.median_ms(lambda: torch.fft.ifft(c, dim=dim), device)
    del c
    return ms, what


def variant_work(meta, m: int) -> dict:
    """(bytes, flops) of each variant's function at width ``m``: each
    input read once and each output written once (float32 re and im);
    5 n log2 n float32 operations a length-n transform, 6 a twiddled
    element, none for the load variants (``full`` is B2's function,
    which P1 computes too)."""
    x, z, out = (8 * m * r for r in (meta.n1_in * meta.n2,
                                     meta.n1 * meta.n2, meta.size))
    n = meta.n1 * meta.n2
    s1 = 5.0 * n * math.log2(meta.n1) * m
    return {"load": (2 * x, 0.0), "load2": (2 * z, 0.0), "s1": (x + z, s1),
            "s1tw": (x + z, s1 + 6.0 * n * m),
            "s2": (z + out, 5.0 * n * math.log2(meta.n2) * m),
            "full": (x + out, 5.0 * n * math.log2(n) * m)}


def run(ngrid: int = common.PRODUCTION_NGRID, *, device="cuda",
        iters: int = 3) -> dict:
    s = common.out_crop_pass(ngrid, device)
    device, meta, f = s.re.device, s.meta, s.f
    m = s.re.shape[1]
    b2_out, b2_z = common.b2_with_z(s)
    works = variant_work(meta, m)
    floor = works["full"][0] + 2 * 8 * m * meta.n1 * meta.n2
    out = {"probe": "fft_ablation", "ngrid": s.n, "m": m,
           "device": common.device_name(device), **common.geometry(meta),
           "two_launch_floor_ms": common.work(floor, None)["bound_ms"],
           "b2_ms": common.median_ms(
               lambda: fft_first_axis_fused(s.re, s.im, f, meta=meta,
                                            sign=+1), device, runs=iters),
           "variants": {}}
    inputs = {"load": ((s.re, s.im), "input"), "load2": (b2_z, "z"),
              "s1tw": (b2_z, "B2's z"), "s2": (b2_out, "B2's output"),
              "full": (b2_out, "B2's output")}
    for variant in VARIANTS:
        x = b2_z if variant in Z_INPUT else (s.re, s.im)

        def kernel(variant=variant, x=x):
            return ablation(variant, *x, f, meta=meta)

        def plain(variant=variant, x=x):
            return ablation_reference(variant, *x, f, meta=meta)

        stats = {}
        got = ablation(variant, *x, f, meta=meta, stats=stats)
        err, rel = common.max_err(got, plain())
        case = {"max_abs_err": err, "max_rel_err": rel, "launch": stats}
        ok = rel <= common.KERNEL_RTOL
        if variant in inputs:
            same, against = inputs[variant]
            case["exact"] = common.all_equal(got, same)
            case["exact_against"] = against
            ok = ok and case["exact"]
        del got
        if not ok:
            raise common.ProbeError(f"fft_ablation {variant} at {s.n}: "
                                    f"{case}")
        case["ms"] = common.median_ms(kernel, device, runs=iters)
        case["plain_ms"] = common.median_ms(plain, device, runs=iters)
        case["library_ms"], case["library_call"] = library_call(
            variant, x, meta, device)
        nbytes, flops = works[variant]
        case.update(common.work(nbytes, case["ms"], flops))
        out["variants"][variant] = case
    return out


if __name__ == "__main__":
    sys.exit(common.main(run))
