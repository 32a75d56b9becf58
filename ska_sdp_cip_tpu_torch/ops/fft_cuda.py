"""
Fused four-step DFT along the first axis: kernel B2
(``csrc/fft_fused.cu``) and its plain PyTorch version.

Counterpart: ``ska_sdp_cip_tpu/ops/fft_pallas.py`` —
``fused_pass_meta`` (copied with ``FusedPassMeta``),
``fused_pass_host_arrays`` (rewritten to emit float32 factors: the
bf16 hi/lo split there fed the TPU's bf16 matrix unit, and the CUDA
kernel multiplies in float32), and ``fft_first_axis_fused`` (the
Pallas kernel, replaced by :func:`fft_first_axis_fused`).

:func:`fft_first_axis_fused` dispatches on the device of its tensors:
CUDA tensors go to the hand-written kernel (or raise), CPU tensors to
:func:`fft_first_axis_reference`, the torch ``fft_first_axis`` with
``out_crop`` (``ops/fft.py``). Nothing falls back from one to the
other.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .fft import FFTPlan, fft_first_axis

#: Launches of the B2 kernel (one per :func:`fft_first_axis_fused` call
#: on CUDA tensors). Callers reset it to 0 and read it to show that a
#: run went through the kernel.
LAUNCHES = 0

#: Column block of the counterpart's geometry (its ``MB``); the port
#: keeps it so ``fused_pass_meta`` gives the same geometry.
MB = 128

#: Output-row-block budget of the counterpart's geometry (bytes).
_OUT_BLOCK_BYTES = 6 * 1024 * 1024


def _pick_chunk(n2: int) -> int:
    """Largest divisor of n2 that is <= 64 (j2 chunk size C)."""
    for c in range(min(n2, 64), 0, -1):
        if n2 % c == 0:
            return c
    return 1


def _pick_qb(q: int, n1: int) -> int:
    """Smallest output-row split with QS*n1*MB*4 <= _OUT_BLOCK_BYTES."""
    max_qs = max(_OUT_BLOCK_BYTES // (n1 * MB * 4), 1)
    return -(-q // max_qs)


@dataclass(frozen=True)
class FusedPassMeta:
    """Static geometry of one fused first-axis pass (counterpart copy)."""

    n1: int
    n2: int
    c: int
    qb: int
    qs: int
    k2a: int
    trim0: int
    size: int
    mb: int = MB
    n1i: int = 0
    j1a: int = 0
    pad_lo: int = 0
    in_size: int = 0

    @property
    def nc(self) -> int:
        return self.n2 // self.c

    @property
    def n1_in(self) -> int:
        return self.n1i or self.n1

    @property
    def n_rows_padded(self) -> int:
        return self.qb * self.qs * self.n1


def fused_pass_meta(
    plan: FFTPlan,
    out_crop: tuple | None,
    *,
    in_crop: tuple | None = None,
    chunk: int | None = None,
    qb: int | None = None,
    mb: int = MB,
) -> FusedPassMeta:
    """
    Geometry (crop pruning + block splits) for one fused pass, as in
    the counterpart: ``out_crop=(start, size)`` prunes stage 2 to the
    covering output range, ``in_crop`` prunes stage 1 (predict).
    """
    n1, n2 = plan.n1, plan.n2
    if out_crop is not None:
        c0, size = out_crop
        k2a, k2b = c0 // n1, -(-(c0 + size) // n1)
    else:
        k2a, k2b = 0, n2
        c0, size = 0, plan.n
    q = k2b - k2a
    if qb is None:
        qb = _pick_qb(q, n1)
    qs = -(-q // qb)
    if chunk is not None:
        if n2 % chunk:
            raise ValueError(f"chunk {chunk} does not divide n2={n2}")
        c_pick = chunk
    else:
        c_pick = _pick_chunk(n2)
    n1i = j1a = pad_lo = in_size = 0
    if in_crop is not None:
        ci0, in_size = in_crop
        j1a, j1b = ci0 // n2, -(-(ci0 + in_size) // n2)
        n1i = j1b - j1a
        pad_lo = ci0 - j1a * n2
    return FusedPassMeta(
        mb=mb,
        n1=n1,
        n2=n2,
        c=c_pick,
        qb=qb,
        qs=qs,
        k2a=k2a,
        trim0=c0 - k2a * n1,
        size=size,
        n1i=n1i,
        j1a=j1a,
        pad_lo=pad_lo,
        in_size=in_size,
    )


def fused_pass_host_arrays(
    plan: FFTPlan,
    meta: FusedPassMeta,
    *,
    sign: int,
    prefix: str,
) -> dict:
    """
    Float32 factor arrays for one fused pass, sign folded in (the
    counterpart's layouts, without its bf16 hi/lo split):

    * ``{prefix}_m1``: (2n1, 2n1i) stage-1 block [[C,-sS],[sS,C]];
    * ``{prefix}_twc/tws``: (NC, n1, C, 1) twiddle cos / sign*sin;
    * ``{prefix}_m2``: (QB, NC, 2QS, 2C) transposed stage-2 blocks
      [[C2^T, -sS2^T], [sS2^T, C2^T]], rows beyond the crop zero;
    * ``{prefix}_sign``: the sign the factors were built for (a Python
      int, staged as is), which the kernel wrapper checks.
    """
    s = float(sign)
    n1, n2, c = meta.n1, meta.n2, meta.c
    qb, qs, k2a = meta.qb, meta.qs, meta.k2a

    d1c = plan.d1_cos[:, meta.j1a : meta.j1a + meta.n1_in]
    d1s = plan.d1_sin[:, meta.j1a : meta.j1a + meta.n1_in]
    m1 = np.block([[d1c, -s * d1s], [s * d1s, d1c]]).astype(np.float32)

    twc = plan.tw_cos.reshape(n1, meta.nc, c)
    tws = (s * plan.tw_sin).reshape(n1, meta.nc, c)
    twc = np.ascontiguousarray(twc.transpose(1, 0, 2))[..., None]
    tws = np.ascontiguousarray(tws.transpose(1, 0, 2))[..., None]

    q = qb * qs
    d2c = np.zeros((n2, q), np.float32)
    d2s = np.zeros((n2, q), np.float32)
    q_real = min(q, plan.d2_cos.shape[1] - k2a)
    d2c[:, :q_real] = plan.d2_cos[:, k2a : k2a + q_real]
    d2s[:, :q_real] = plan.d2_sin[:, k2a : k2a + q_real]
    m2 = np.zeros((qb, meta.nc, 2 * qs, 2 * c), np.float32)
    for b in range(qb):
        for ci in range(meta.nc):
            cc = d2c[ci * c : (ci + 1) * c, b * qs : (b + 1) * qs].T
            ss = d2s[ci * c : (ci + 1) * c, b * qs : (b + 1) * qs].T
            m2[b, ci] = np.block([[cc, -s * ss], [s * ss, cc]])

    return {
        f"{prefix}_m1": m1,
        f"{prefix}_twc": twc.astype(np.float32),
        f"{prefix}_tws": tws.astype(np.float32),
        f"{prefix}_m2": m2,
        f"{prefix}_sign": int(sign),
    }


def _out_crop(meta: FusedPassMeta) -> tuple:
    return (meta.k2a * meta.n1 + meta.trim0, meta.size)


def fft_first_axis_reference(re, im, f, *, meta: FusedPassMeta, sign: int):
    """
    Plain version of the fused pass: the torch four-step
    ``fft_first_axis`` with ``out_crop``, from the plan factors
    ``fft_d1_cos`` etc. (``ops/fft.py:fft_plan_arrays``).
    """
    if meta.in_size:
        raise NotImplementedError(
            "in-cropped fused passes (predict) are still to be ported "
            "(ROADMAP.md, queue A)"
        )
    return fft_first_axis(re, im, f, sign=sign, out_crop=_out_crop(meta))


def fft_first_axis_fused(re, im, f, *, meta: FusedPassMeta, sign: int):
    """
    DFT along the first axis of (n, m) split float32 tensors, cropped
    to ``meta.size`` output rows. On CUDA tensors this launches the B2
    kernel with the factors ``fftp_*`` of :func:`fused_pass_host_arrays`,
    and raises unless they were built for ``sign``; on CPU tensors it
    runs :func:`fft_first_axis_reference` on the plan factors ``fft_*``
    of the same dict.
    """
    if re.device != im.device:
        raise ValueError("re and im must be on one device")
    if re.device.type == "cuda":
        return _fft_first_axis_cuda(re, im, f, meta=meta, sign=sign)
    if re.device.type == "cpu":
        return fft_first_axis_reference(re, im, f, meta=meta, sign=sign)
    raise ValueError(f"unsupported device {re.device}")


def _fft_first_axis_cuda(re, im, f, *, meta, sign):
    global LAUNCHES
    from . import _build

    if meta.in_size:
        raise NotImplementedError(
            "in-cropped fused passes (predict) are still to be ported "
            "(ROADMAP.md, queue A)"
        )
    if f.get("fftp_sign") != sign:
        raise ValueError(
            f"the fftp_* factors were built for sign "
            f"{f.get('fftp_sign')}, the pass asks for {sign}"
        )
    n1, n2, n1i = meta.n1, meta.n2, meta.n1_in
    factors = {
        "m1": (2 * n1, 2 * n1i),
        "twc": (meta.nc, n1, meta.c, 1),
        "tws": (meta.nc, n1, meta.c, 1),
        "m2": (meta.qb, meta.nc, 2 * meta.qs, 2 * meta.c),
    }
    tensors = {}
    for name, shape in factors.items():
        t = f[f"fftp_{name}"]
        if t.device != re.device or t.dtype != torch.float32:
            raise TypeError(f"fftp_{name} must be float32 on {re.device}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"fftp_{name} has shape {tuple(t.shape)}, want {shape}"
            )
        tensors[name] = t.contiguous()
    for name, t in (("re", re), ("im", im)):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise TypeError(f"{name} must be a 2-D float32 tensor")
        if t.shape[0] != n1i * n2:
            raise ValueError(
                f"{name} has {t.shape[0]} rows, want {n1i * n2}"
            )
    if re.shape != im.shape:
        raise ValueError("re and im shapes differ")
    re, im = re.contiguous(), im.contiguous()
    m = re.shape[1]
    z_re = torch.empty((n1 * n2, m), dtype=torch.float32, device=re.device)
    z_im = torch.empty_like(z_re)
    out_re = torch.empty(
        (meta.size, m), dtype=torch.float32, device=re.device
    )
    out_im = torch.empty_like(out_re)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(re.device).cuda_stream
    err = lib.cip_fft_first_axis_fused(
        re.data_ptr(), im.data_ptr(), tensors["m1"].data_ptr(),
        tensors["twc"].data_ptr(), tensors["tws"].data_ptr(),
        tensors["m2"].data_ptr(), z_re.data_ptr(), z_im.data_ptr(),
        out_re.data_ptr(), out_im.data_ptr(), int(n1), int(n1i), int(n2),
        int(meta.c), int(meta.qb), int(meta.qs), int(meta.trim0),
        int(meta.size), int(m), stream,
    )
    _build.check(err, "cip_fft_first_axis_fused")
    LAUNCHES += 1
    return out_re, out_im
