"""
Set-up shared by the B2 probes: the transform the counterpart scripts
probe (``scripts/fft_tiled_probe.py:46-51``: an ngrid-point centred
pass, out-cropped to 10240 rows at the 15360 and 20480 grids and to
ngrid / 2 otherwise, factors at sign +1), its inputs on a device, B2's
output and intermediate on them, and CUDA-event timing.
"""

from __future__ import annotations

import json
import statistics
import sys
from dataclasses import dataclass

import torch

from ..ops.fft import (
    fft_plan_arrays,
    first_axis_stage1,
    first_axis_twiddle,
    make_fft_plan,
)
from ..ops.fft_cuda import (
    FusedPassMeta,
    fft_first_axis_fused,
    fft_first_axis_reference,
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

#: Device memory rate of one H100 SXM (NVIDIA's data sheet), for the
#: probes' bounds: each input read once, each output written once.
HBM_BYTES_PER_S = 3.35e12


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
    plain version's) and ``fftp_*`` (B2's and its probes'), and
    standard-normal (ngrid, m) float32 re/im made on the device from
    seed 1 (``m`` defaults to ngrid).
    """
    device = resolve_device(device)
    npix = crop_rows(ngrid)
    plan = make_fft_plan(ngrid, shifted=True)
    meta = fused_pass_meta(plan, ((ngrid - npix) // 2, npix))
    host = fft_plan_arrays(plan, prefix="fft")
    host.update(fused_pass_kernel_arrays(plan, meta, sign=+1, prefix="fftp"))
    f = stage_arrays(host, device)
    gen = torch.Generator(device=device).manual_seed(1)
    shape = (ngrid, ngrid if m is None else m)
    re = torch.randn(shape, generator=gen, device=device)
    im = torch.randn(shape, generator=gen, device=device)
    return PassSetup(ngrid, npix, meta, f, re, im)


def plain_z(re, im, f, *, meta: FusedPassMeta):
    """The plain version's intermediate z of the out-cropped pass at
    sign +1, as B2 lays it out: (n1 n2, m) re and im."""
    n1, n2, m = meta.n1, meta.n2, re.shape[1]
    z2 = first_axis_twiddle(*first_axis_stage1(re, im, f, sign=+1), f,
                            sign=+1)
    return (z2[:, :n2].reshape(n1 * n2, m), z2[:, n2:].reshape(n1 * n2, m))


def b2_with_z(s: PassSetup):
    """
    B2's output and its intermediate z on the setup's input (sign +1):
    ((out_re, out_im), (z_re, z_im)). On the card one B2 launch that
    keeps its z; on the CPU the plain version and :func:`plain_z`.
    """
    if s.re.device.type != "cuda":
        return (fft_first_axis_reference(s.re, s.im, s.f, meta=s.meta,
                                          sign=+1),
                plain_z(s.re, s.im, s.f, meta=s.meta))
    meta, m = s.meta, s.re.shape[1]
    z = tuple(torch.empty((meta.n1 * meta.n2, m), device=s.re.device)
              for _ in range(2))
    out = fft_first_axis_fused(s.re, s.im, s.f, meta=meta, sign=+1, z=z)
    return out, z


def work(nbytes: float, ms, flops: float = 0.0) -> dict:
    """The bound of moving ``nbytes`` at :data:`HBM_BYTES_PER_S` and, on
    the card, the achieved GB/s and the share of the bound; ``flops``,
    the float32 operations of the same work, is passed through."""
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"bytes": nbytes, "flops": flops, "bound_ms": bound_ms}
    if isinstance(ms, float):
        out["gb_per_s"] = nbytes / ms / 1e6
        out["bound_share"] = bound_ms / ms
    return out


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


def median_ms(fn, device, *, runs: int = 3):
    """The median of ``runs`` calls of ``fn``, each timed alone
    (:func:`cuda_ms` of one call) after one warm call; "not measured"
    on the CPU."""
    if device.type != "cuda":
        return "not measured"
    fn()
    return statistics.median(cuda_ms(fn, iters=1, warmup=0)
                             for _ in range(runs))


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
