"""
Set-up shared by the B2 probes: the transform the counterpart scripts
probe (``scripts/fft_tiled_probe.py:46-51``: an ngrid-point centred
pass, out-cropped to 10240 rows at the 15360 and 20480 grids and to
ngrid / 2 otherwise, factors at sign +1), its inputs on a device, and
CUDA-event timing.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass

import torch

from ..ops.fft import fft_plan_arrays, make_fft_plan
from ..ops.fft_cuda import (
    FusedPassMeta,
    fused_pass_host_arrays,
    fused_pass_kernel_arrays,
    fused_pass_meta,
)
from ..ops.gridder import resolve_device, stage_arrays

#: The production grid (``scripts/production_bench.py``'s 10240 px at
#: 1.1 asec with sigma 1.5) and the counterpart scripts' default.
PRODUCTION_NGRID = 15360

#: Kernel against its plain version, both float32 on the card: the
#: summation order differs (relative to the plain version's max).
KERNEL_RTOL = 1e-5


class ProbeError(RuntimeError):
    """A probe's check failed."""


def crop_rows(ngrid: int) -> int:
    """Output rows of the probed pass (the counterpart scripts' npix)."""
    return 10240 if ngrid in (15360, 20480) else ngrid // 2


@dataclass
class PassSetup:
    """One out-cropped pass: geometry, factors and random input."""

    n: int
    npix: int
    meta: FusedPassMeta
    f: dict
    re: torch.Tensor
    im: torch.Tensor


def out_crop_pass(ngrid: int, device, *, m: int | None = None) -> PassSetup:
    """
    The probed pass at ``ngrid`` on ``device``: factors ``fft_*`` (the
    plain version's) and ``fftp_*`` (the dense probes' and B2's), and
    standard-normal (ngrid, m) float32 re/im made on the device from
    seed 1 (``m`` defaults to ngrid).
    """
    device = resolve_device(device)
    npix = crop_rows(ngrid)
    plan = make_fft_plan(ngrid, shifted=True)
    meta = fused_pass_meta(plan, ((ngrid - npix) // 2, npix))
    host = fft_plan_arrays(plan, prefix="fft")
    host.update(fused_pass_host_arrays(plan, meta, sign=+1, prefix="fftp"))
    host.update(fused_pass_kernel_arrays(plan, meta, sign=+1, prefix="fftp"))
    f = stage_arrays(host, device)
    gen = torch.Generator(device=device).manual_seed(1)
    shape = (ngrid, ngrid if m is None else m)
    re = torch.randn(shape, generator=gen, device=device)
    im = torch.randn(shape, generator=gen, device=device)
    return PassSetup(ngrid, npix, meta, f, re, im)


def geometry(meta: FusedPassMeta) -> dict:
    return {"n1": meta.n1, "n2": meta.n2, "n1i": meta.n1_in, "C": meta.c,
            "QB": meta.qb, "QS": meta.qs, "trim0": meta.trim0,
            "rows_out": meta.size}


def max_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, that / max |ref|) over pairs of tensors."""
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.abs().max()) for r in ref)
    return err, err / scale if scale else err


def all_equal(got, ref) -> bool:
    return all(torch.equal(g, r) for g, r in zip(got, ref))


def cuda_ms(fn, *, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
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


def timed(fn, device, *, iters: int):
    """``cuda_ms`` on the card; "not measured" on the CPU."""
    if device.type != "cuda":
        return "not measured"
    return cuda_ms(fn, iters=iters)


def device_name(device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def main(run) -> int:
    """Command line of a probe: ``[ngrid]``, on the card only."""
    argv = sys.argv[1:]
    if not torch.cuda.is_available():
        print("this probe needs a CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    ngrid = int(argv[0]) if argv else PRODUCTION_NGRID
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(run(ngrid, device="cuda")), flush=True)
    return 0
