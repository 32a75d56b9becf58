"""
Stage ablation of the fused first-axis pass (P2; counterpart
``scripts/fft_ablation_probe.py``, variants ``dma``, ``s1``, ``s1tw``,
``s1twtr``, ``full``).

    python -m ska_sdp_cip_tpu_torch.probes.fft_ablation [ngrid]

B2's first design (two dense complex products, ``csrc/fft_dense.cuh``)
with later stages switched off, as compile-time variants of the same
kernel (``csrc/fft_probes.cu``), each held against its plain piece:

* ``load``: stage 1's tiles loaded into shared memory and written
  straight back; it must equal its input exactly;
* ``s1``: the stage-1 product only, against a torch einsum of ``m1``
  with the input viewed (n1i, n2, m);
* ``s1tw``: stage 1 plus twiddle, i.e. ``z`` (the first launch);
* ``s2``: stage 2 + crop on a given ``z`` (the second launch);
* ``full``: both launches, the dense pass, timed beside B2 (its
  shared-memory FFT redesign) on the same input.

The counterpart's ``s1twtr`` (plus the inter-stage transpose in VMEM)
has no counterpart here: the two-launch design writes ``z`` to device
memory, and stage 2 reads it in the layout stage 1 wrote.
"""

from __future__ import annotations

import sys

import torch

from ..ops import _build
from ..ops.fft_cuda import (
    DENSE_FACTORS,
    fft_first_axis_fused,
    fft_first_axis_reference,
    pass_args,
    pass_factors,
)
from . import common

VARIANTS = ("load", "s1", "s1tw", "s2", "full")

#: Launches of the probe kernel per variant (one per :func:`ablation`
#: call on CUDA tensors; ``full`` is two kernels in one call).
LAUNCHES = {v: 0 for v in VARIANTS}


def _rows_in(variant: str, meta) -> int:
    return meta.n1 * meta.n2 if variant == "s2" else meta.n1_in * meta.n2


def _rows_out(variant: str, meta) -> int:
    if variant == "load":
        return meta.n1_in * meta.n2
    if variant in ("s1", "s1tw"):
        return meta.n1 * meta.n2
    return meta.size


def _stage1(xr, xi, fac, meta, *, twiddle: bool):
    n1, n1i, n2 = meta.n1, meta.n1_in, meta.n2
    m = xr.shape[1]
    x2 = torch.cat([xr.reshape(n1i, n2, m), xi.reshape(n1i, n2, m)])
    y = torch.einsum("kj,jnm->knm", fac["m1"], x2)
    yr, yi = y[:n1], y[n1:]
    if twiddle:
        # (NC, n1, C, 1) -> (n1, n2, 1) with j2 = ci * C + c.
        tc, ts = (fac[k][..., 0].permute(1, 0, 2).reshape(n1, n2, 1)
                  for k in ("twc", "tws"))
        yr, yi = yr * tc - yi * ts, yr * ts + yi * tc
    return yr.reshape(n1 * n2, m), yi.reshape(n1 * n2, m)


def _stage2(zr, zi, fac, meta):
    n1, n2, qs = meta.n1, meta.n2, meta.qs
    q = meta.qb * qs
    m = zr.shape[1]
    m2 = fac["m2"][..., : meta.c]  # (QB, NC, 2 QS, C): [C2^T; sS2^T]
    d_re = m2[:, :, :qs].permute(0, 2, 1, 3).reshape(q, n2)
    d_im = m2[:, :, qs:].permute(0, 2, 1, 3).reshape(q, n2)
    d2 = torch.cat([torch.cat([d_re, -d_im], 1), torch.cat([d_im, d_re], 1)])
    z2 = torch.cat([zr.reshape(n1, n2, m), zi.reshape(n1, n2, m)], 1)
    out = torch.einsum("qj,kjm->qkm", d2, z2)
    rows = slice(meta.trim0, meta.trim0 + meta.size)
    return (out[:q].reshape(q * n1, m)[rows],
            out[q:].reshape(q * n1, m)[rows])


def ablation_reference(variant: str, xr, xi, f, *, meta):
    """Plain torch version of one variant, from the kernel's factors
    ``fftp_*`` (float32, sign +1, the layouts of
    ``fused_pass_host_arrays``)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    fac = pass_factors(f, meta, sign=+1, prefix="fftp", device=xr.device,
                       names=DENSE_FACTORS)
    if variant == "load":
        return xr.clone(), xi.clone()
    if variant == "s2":
        return _stage2(xr, xi, fac, meta)
    z = _stage1(xr, xi, fac, meta, twiddle=variant != "s1")
    return _stage2(*z, fac, meta) if variant == "full" else z


def ablation(variant: str, xr, xi, f, *, meta):
    """
    Run one variant on (rows, m) float32 re/im: (n1i n2, m) input for
    ``load``, ``s1``, ``s1tw`` and ``full``, ``z`` (n1 n2, m) for
    ``s2``. CUDA tensors go to the probe kernel (or raise), CPU tensors
    to :func:`ablation_reference`.
    """
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    rows = _rows_in(variant, meta)
    if xr.dim() != 2 or xr.shape != xi.shape or xr.shape[0] != rows:
        raise ValueError(f"{variant} takes ({rows}, m) re/im, got "
                         f"{tuple(xr.shape)}")
    if xr.device.type == "cpu":
        return ablation_reference(variant, xr, xi, f, meta=meta)
    if xr.device.type != "cuda":
        raise ValueError(f"unsupported device {xr.device}")
    if xr.dtype != torch.float32 or xi.dtype != torch.float32:
        raise TypeError("re/im must be float32")
    fac = pass_factors(f, meta, sign=+1, prefix="fftp", device=xr.device,
                       names=DENSE_FACTORS)
    xr, xi = xr.contiguous(), xi.contiguous()
    m = xr.shape[1]
    out_re = torch.empty((_rows_out(variant, meta), m), dtype=torch.float32,
                         device=xr.device)
    out_im = torch.empty_like(out_re)
    if variant == "full":
        z_re = torch.empty((meta.n1 * meta.n2, m), dtype=torch.float32,
                           device=xr.device)
        z_im = torch.empty_like(z_re)
    else:
        z_re, z_im = out_re, out_im  # not read
    lib = _build.load_library()
    err = lib.cip_fft_ablation(
        VARIANTS.index(variant),
        *pass_args(xr, xi, fac, z_re, z_im, out_re, out_im, meta),
        int(m), torch.cuda.current_stream(xr.device).cuda_stream,
    )
    _build.check(err, f"cip_fft_ablation({variant})")
    LAUNCHES[variant] += 1
    return out_re, out_im


def run(ngrid: int = common.PRODUCTION_NGRID, *, device="cuda",
        iters: int = 5) -> dict:
    s = common.out_crop_pass(ngrid, device)
    device, meta, f = s.re.device, s.meta, s.f
    z = ablation_reference("s1tw", s.re, s.im, f, meta=meta)
    b2 = fft_first_axis_fused(s.re, s.im, f, meta=meta, sign=+1)
    out = {"probe": "fft_ablation", "ngrid": s.n,
           "device": common.device_name(device), **common.geometry(meta),
           "b2_ms": common.timed(
               lambda: fft_first_axis_fused(s.re, s.im, f, meta=meta,
                                            sign=+1),
               device, iters=iters),
           "b2_plain_ms": common.timed(
               lambda: fft_first_axis_reference(s.re, s.im, f, meta=meta,
                                                sign=+1),
               device, iters=iters),
           "variants": {}}
    for variant in VARIANTS:
        x = z if variant == "s2" else (s.re, s.im)

        def kernel(variant=variant, x=x):
            return ablation(variant, *x, f, meta=meta)

        def plain(variant=variant, x=x):
            return ablation_reference(variant, *x, f, meta=meta)

        got = kernel()
        err, rel = common.max_err(got, plain())
        case = {"max_abs_err": err, "max_rel_err": rel}
        if variant == "load":
            case["exact"] = common.all_equal(got, x)
            ok = case["exact"]
        elif variant == "full":
            case["max_rel_err_vs_b2"] = common.max_err(got, b2)[1]
            ok = rel <= common.KERNEL_RTOL
        else:
            ok = rel <= common.KERNEL_RTOL
        del got
        if not ok:
            raise common.ProbeError(f"fft_ablation {variant}: {case}")
        case["ms"] = common.timed(kernel, device, iters=iters)
        case["plain_ms"] = common.timed(plain, device, iters=iters)
        out["variants"][variant] = case
    return out


if __name__ == "__main__":
    sys.exit(common.main(run))
