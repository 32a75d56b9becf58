"""
Fetch-concurrency probe of the fused first-axis pass (P1; counterpart
``scripts/fft_split_fetch_probe.py``, whose TPU kernel split B2's input
into K specs to keep 2K DMAs in flight).

    python -m ska_sdp_cip_tpu_torch.probes.fft_async_fetch [ngrid]

The Hopper question: does B2's first design, two dense complex
products (``csrc/fft_dense.cuh``), go faster with more stage-1 input
loads in flight? :func:`async_fetch_pass` runs the out-cropped dense
pass with stage 1 streaming its factor and input tiles through an
S-deep ring of shared-memory buffers filled by ``cp.async``
(``csrc/fft_probes.cu``, S in 1, 2, 4; stage 2 is the dense pass's).
It loads the same values and sums them in the same order as the dense
pass (P2 ``full``), so its output equals that exactly; the probe
checks that and the plain version (1e-5 of max), and times each S
beside the dense pass, B2 and the plain version.
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
from .fft_ablation import ablation, ablation_reference

#: Ring depths the kernel is built for.
STAGES = (1, 2, 4)

#: Launches of the probe kernel per ring depth (one per
#: :func:`async_fetch_pass` call on CUDA tensors).
LAUNCHES = {s: 0 for s in STAGES}


def async_fetch_pass(re, im, f, *, meta, stages: int):
    """
    The out-cropped dense pass (sign +1, factors ``fftp_*``) of (n, m)
    re/im with stage 1 through a ``stages``-deep ``cp.async`` ring. CUDA
    tensors go to the probe kernel (or raise; m must be a multiple of
    64), CPU tensors to the dense pass's plain version (P2's
    ``ablation_reference("full")``).
    """
    if stages not in STAGES:
        raise ValueError(f"stages must be one of {STAGES}, got {stages}")
    if meta.in_size:
        raise ValueError("the probe runs the out-cropped pass only")
    if re.device.type == "cpu":
        return ablation_reference("full", re, im, f, meta=meta)
    if re.device.type != "cuda":
        raise ValueError(f"unsupported device {re.device}")
    factors = pass_factors(f, meta, sign=+1, prefix="fftp",
                           device=re.device, names=DENSE_FACTORS)
    rows = meta.n1 * meta.n2
    re, im = re.contiguous(), im.contiguous()
    for name, t in (("re", re), ("im", im)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != rows:
            raise ValueError(f"{name} must be float32 ({rows}, m)")
    m = re.shape[1]
    if re.shape != im.shape or m % 64:
        raise ValueError(f"re/im must share a shape with m % 64 == 0, m={m}")
    if re.data_ptr() % 16 or im.data_ptr() % 16:
        raise ValueError("re/im must be 16-byte aligned (cp.async)")
    z_re = torch.empty((rows, m), dtype=torch.float32, device=re.device)
    z_im = torch.empty_like(z_re)
    out_re = torch.empty((meta.size, m), dtype=torch.float32,
                         device=re.device)
    out_im = torch.empty_like(out_re)
    lib = _build.load_library()
    err = lib.cip_fft_async_fetch(
        int(stages),
        *pass_args(re, im, factors, z_re, z_im, out_re, out_im, meta),
        int(m), torch.cuda.current_stream(re.device).cuda_stream,
    )
    _build.check(err, f"cip_fft_async_fetch(S={stages})")
    LAUNCHES[stages] += 1
    return out_re, out_im


def run(ngrid: int = common.PRODUCTION_NGRID, *, device="cuda",
        iters: int = 5) -> dict:
    s = common.out_crop_pass(ngrid, device)
    device, meta, f = s.re.device, s.meta, s.f

    def dense():
        return ablation("full", s.re, s.im, f, meta=meta)

    def b2():
        return fft_first_axis_fused(s.re, s.im, f, meta=meta, sign=+1)

    def plain():
        return fft_first_axis_reference(s.re, s.im, f, meta=meta, sign=+1)

    base, ref = dense(), plain()
    out = {"probe": "fft_async_fetch", "ngrid": s.n,
           "device": common.device_name(device), **common.geometry(meta),
           "dense_ms": common.timed(dense, device, iters=iters),
           "b2_ms": common.timed(b2, device, iters=iters),
           "plain_ms": common.timed(plain, device, iters=iters),
           "stages": {}}
    for stages in STAGES:
        def ring(stages=stages):
            return async_fetch_pass(s.re, s.im, f, meta=meta, stages=stages)

        got = ring()
        err, rel = common.max_err(got, ref)
        case = {"exact_vs_dense": common.all_equal(got, base),
                "max_abs_err": err, "max_rel_err": rel}
        del got
        if not (case["exact_vs_dense"] and rel <= common.KERNEL_RTOL):
            raise common.ProbeError(f"fft_async_fetch S={stages}: {case}")
        case["ms"] = common.timed(ring, device, iters=iters)
        out["stages"][str(stages)] = case
    return out


if __name__ == "__main__":
    sys.exit(common.main(run))
