"""
Fused four-step DFT along the first axis: kernel B2
(``csrc/fft_fused.cu``), the same transform along the last axis with the
w-screen in its loads and stores: kernel B2L (``csrc/fft_last_axis.cu``),
the input re-lay B6 (``csrc/pretile.cu``) and their plain PyTorch
versions.

Counterpart: ``ska_sdp_cip_tpu/ops/fft_pallas.py`` —
``fused_pass_meta`` (copied with ``FusedPassMeta``),
``fused_pass_host_arrays`` (rewritten to emit float32 factors: the
bf16 hi/lo split there fed the TPU's bf16 matrix unit; the tests hold
its layouts against the counterpart's), ``fft_first_axis_fused``
(the Pallas kernel, replaced by :func:`fft_first_axis_fused`, with its
``tiled`` input mode), ``pretile_first_axis`` (replaced by
:func:`pretile_first_axis`) and ``fft2_from_image_fused`` (the forward
2-D transform as two B2 passes, here from the transposed image; predict
now runs B2L and B2 instead, and ``chip_smoke.py`` times this beside
it). As in the counterpart, nothing on the invert
or predict path uses the tiled mode: ``probes/fft_tiled.py`` measures it.

The B2 kernel runs each four-step stage as a short FFT (radix passes
of :func:`sub_fft_radices`, twiddles of :func:`sub_fft_twiddles`, on
:func:`sub_fft_columns` columns a block) and multiplies by the twiddle
``twc``/``tws`` between the stages; it reads the factors of
:func:`fused_pass_kernel_arrays`, as do its probes P1/P2
(``probes/``), whose ring geometry :func:`ring_geometry` gives.

A pass is out-cropped (invert: ``meta.size`` output rows of the image
crop, factors ``fftp_*`` at sign +1) or in-cropped (predict: the input
holds only ``meta.in_size`` rows of the zero-padded image, stage 1
runs over the covering ``n1i`` rows, factors ``fftq_*`` at sign -1).

B2L (:func:`fft_last_axis_fused`) computes for each row what B2
computes for each column of the transposed array, from the same
``meta`` and sub-FFT tables plus the plan's twiddle in its own (n1, n2)
layout (:func:`last_axis_kernel_arrays`), so a plane's 2-D transform is
one B2 and one B2L pass with no transpose between them. Its ``screen``
and ``acc`` run the invert's w-screen and image accumulation in its
store and predict's screen in its load; their plain versions are
:func:`screen_load_reference` and :func:`screen_accumulate_reference`.

:func:`fft_first_axis_fused` dispatches on the device of its tensors:
CUDA tensors go to the hand-written kernel (or raise), CPU tensors to
:func:`fft_first_axis_reference`, the torch ``fft_first_axis`` with
``in_crop``/``out_crop`` (``ops/fft.py``). Nothing falls back from one
to the other; :func:`fft_last_axis_fused` dispatches the same way, to
B2L or to :func:`fft_last_axis_reference`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .fft import FFTPlan, fft_first_axis

#: Launches of the B2 kernel (one per :func:`fft_first_axis_fused` call
#: on CUDA tensors): out-cropped passes (invert) in ``LAUNCHES``,
#: in-cropped passes (predict) in ``IN_CROP_LAUNCHES``, passes on tiled
#: input (either crop) in ``TILED_LAUNCHES``; launches of the B6 kernel
#: (:func:`pretile_first_axis`) in ``PRETILE_LAUNCHES``. Callers reset
#: them to 0 and read them to show that a run went through the kernel.
LAUNCHES = 0
IN_CROP_LAUNCHES = 0
TILED_LAUNCHES = 0
PRETILE_LAUNCHES = 0

#: Launches of the B2L kernel (one per :func:`fft_last_axis_fused` call
#: on CUDA tensors): out-cropped passes (invert) and in-cropped passes
#: (predict).
LAST_AXIS_LAUNCHES = 0
LAST_AXIS_IN_CROP_LAUNCHES = 0

#: Column block of the counterpart's geometry (its ``MB``); the port
#: keeps it so ``fused_pass_meta`` gives the same geometry.
MB = 128

#: Output-row-block budget of the counterpart's geometry (bytes).
_OUT_BLOCK_BYTES = 6 * 1024 * 1024

#: Shared memory one block may opt in to on Hopper (227 KiB), which
#: holds a B2 stage's two buffers of n rows x C columns, re and im.
SMEM_BYTES = 227 * 1024

#: Longest sub-FFT (n1 or n2) the B2 kernel takes: two buffers of
#: 2 x n x 4 float32 (its narrowest tile) within :data:`SMEM_BYTES`.
MAX_SUB_FFT = SMEM_BYTES // (2 * 2 * 4 * 4)

#: The factor tensors of one pass that B2 and its probes read
#: (:func:`pass_factors`).
B2_FACTORS = ("twc", "tws", "fft1_tw", "fft2_tw")

#: The factor tensors of one pass that B2L reads: the twiddle in the
#: plan's (n1, n2) layout and B2's sub-FFT tables.
B2L_FACTORS = ("twlc", "twls", "fft1_tw", "fft2_tw")

#: B2L's stage-2 stores (``out_mode`` of ``csrc/fft_last_axis.cu``):
#: the result, Re(screen x result) added into an image, or its real
#: part added.
_STORE, _SCREEN_ACCUMULATE, _ACCUMULATE = 0, 1, 2

#: The column tile B2's probes P1/P2 are built for (``csrc/fft_probes.cu``;
#: B2's for every sub-FFT up to 454), and P1's ring depths S.
PROBE_COLUMNS = 32
RING_DEPTHS = (1, 2, 3)

#: Copy engines of P1's ring; ``bulk`` keeps an 8-byte mbarrier a slot
#: in shared memory beside the buffers.
RING_ENGINES = ("cp_async", "bulk")
_MBARRIER_BYTES = 8


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

    twc, tws = _pass_twiddle(plan, meta, sign)

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
        f"{prefix}_twc": twc,
        f"{prefix}_tws": tws,
        f"{prefix}_m2": m2,
        f"{prefix}_sign": int(sign),
    }


def _pass_twiddle(plan: FFTPlan, meta: FusedPassMeta, sign: int) -> tuple:
    """The twiddle between a pass's stages as float32 (NC, n1, C, 1)
    tables: cos, and sin with ``sign`` folded in."""
    n1, nc, c = meta.n1, meta.nc, meta.c
    twc = plan.tw_cos.reshape(n1, nc, c)
    tws = (float(sign) * plan.tw_sin).reshape(n1, nc, c)
    return tuple(np.ascontiguousarray(t.transpose(1, 0, 2))[..., None]
                 .astype(np.float32) for t in (twc, tws))


def sub_fft_radices(n: int) -> tuple:
    """
    The radix passes of B2's length-``n`` sub-FFT (n1 or n2), in order:
    eights, then a four or a two, then threes, fives and sevens
    (120 -> 8, 3, 5; 128 -> 8, 8, 2). Raises unless ``n`` is 7-smooth
    and 2 <= n <= :data:`MAX_SUB_FFT`.
    """
    if not 2 <= n <= MAX_SUB_FFT:
        raise ValueError(f"B2 takes sub-FFT lengths 2..{MAX_SUB_FFT} "
                         f"(a grid's near-square factors), got {n}")
    radices, rest = [], n
    while rest % 8 == 0:
        radices.append(8)
        rest //= 8
    for r in (4, 2):
        if rest % r == 0:
            radices.append(r)
            rest //= r
    for r in (3, 5, 7):
        while rest % r == 0:
            radices.append(r)
            rest //= r
    if rest != 1:
        raise ValueError(f"B2 takes 7-smooth sub-FFT lengths, got {n}")
    return tuple(radices)


def sub_fft_columns(n: int) -> int:
    """
    Columns per block of B2's stage whose sub-FFT has length ``n``: the
    widest of 32, 16, 8 and 4 whose two shared buffers (2 x n x C
    float32 each) fit :data:`SMEM_BYTES`; 32 for every n <= 454.
    """
    for cols in (32, 16, 8, 4):
        if 2 * 2 * n * cols * 4 <= SMEM_BYTES:
            return cols
    raise ValueError(f"B2 takes sub-FFT lengths up to {MAX_SUB_FFT}, "
                     f"got {n}")


def last_axis_columns(n: int) -> int:
    """
    Lanes per block of B2L's stage 2, whose length-``n`` sub-FFT stages
    its tile transposed into rows padded to C + 1 words: the widest of
    32, 16, 8 and 4 whose two buffers (2 x n x (C + 1) float32 each) fit
    :data:`SMEM_BYTES`; 32 for every n <= 440. (Stage 1 is staged
    unpadded and takes :func:`sub_fft_columns`.)
    """
    sub_fft_radices(n)
    for cols in (32, 16, 8, 4):
        if 2 * 2 * n * (cols + 1) * 4 <= SMEM_BYTES:
            return cols
    raise ValueError(f"B2L takes sub-FFT lengths up to "
                     f"{SMEM_BYTES // (2 * 2 * 5 * 4)}, got {n}")


def sub_fft_twiddles(n: int, sign: int) -> np.ndarray:
    """
    The Stockham twiddles of B2's length-``n`` sub-FFT as an (n - 1, 2)
    float32 (cos, sin) table: pass p (radix R, ns the product of the
    earlier radices) multiplies input t of butterfly k (mod ns) by
    exp(i sign 2 pi t k / (ns R)), stored at row ns - 1 + k (R - 1) +
    t - 1. Computed in float64 and rounded once.
    """
    rows, ns = [], 1
    for r in sub_fft_radices(n):
        k = np.arange(ns)[:, None]
        t = np.arange(1, r)[None, :]
        angle = sign * 2.0 * np.pi * (k * t) / (ns * r)
        rows.append(np.stack([np.cos(angle), np.sin(angle)], -1)
                    .reshape(-1, 2))
        ns *= r
    return np.concatenate(rows).astype(np.float32)


@dataclass(frozen=True)
class RingGeometry:
    """Which depths of P1's ring fit one block for a length-n sub-FFT."""

    columns: int
    depths: tuple
    why: str


def ring_geometry(n: int, engine: str) -> RingGeometry:
    """
    P1's ring for a stage whose sub-FFT has length ``n``: S input slots
    and one work buffer of 2 x n x C float32 each, (S + 1) x 2 x n x C x
    4 bytes a block (plus S 8-byte mbarriers for the ``bulk`` engine),
    at B2's column tile C = :func:`sub_fft_columns` (n), within
    :data:`SMEM_BYTES`. ``depths`` are the S of :data:`RING_DEPTHS` that
    fit; ``why`` says why the others do not. A narrower tile would fit
    deeper rings but halve each row's segment, which is what the probe
    compares, so it keeps B2's. The kernels are built for
    :data:`PROBE_COLUMNS` only, which the probes' wrappers check.
    """
    if engine not in RING_ENGINES:
        raise ValueError(f"engine must be one of {RING_ENGINES}, got "
                         f"{engine!r}")
    cols = sub_fft_columns(n)
    extra = _MBARRIER_BYTES if engine == "bulk" else 0

    def need(s):
        return (s + 1) * 2 * n * cols * 4 + extra * s

    depths = tuple(s for s in RING_DEPTHS if need(s) <= SMEM_BYTES)
    out = [s for s in RING_DEPTHS if s not in depths]
    why = "" if not out else (
        f"S = {', '.join(map(str, out))} would take "
        f"{', '.join(str(need(s)) for s in out)} bytes a block at n = {n},"
        f" C = {cols} ({engine}), more than the {SMEM_BYTES} a block may "
        f"have")
    return RingGeometry(cols, depths, why)


def fused_pass_kernel_arrays(plan: FFTPlan, meta: FusedPassMeta, *,
                             sign: int, prefix: str) -> dict:
    """
    The factors the B2 kernel reads for one pass at ``sign``
    (:data:`B2_FACTORS`): the twiddle ``{prefix}_twc``/``_tws`` (as
    :func:`fused_pass_host_arrays` lays it out), the sub-FFT twiddles
    ``{prefix}_fft1_tw`` (n1 - 1, 2) and ``{prefix}_fft2_tw``
    (n2 - 1, 2), and ``{prefix}_sign``.
    """
    twc, tws = _pass_twiddle(plan, meta, sign)
    return {
        f"{prefix}_twc": twc,
        f"{prefix}_tws": tws,
        f"{prefix}_fft1_tw": sub_fft_twiddles(meta.n1, sign),
        f"{prefix}_fft2_tw": sub_fft_twiddles(meta.n2, sign),
        f"{prefix}_sign": int(sign),
    }


def last_axis_kernel_arrays(plan: FFTPlan, meta: FusedPassMeta, *,
                            sign: int, prefix: str) -> dict:
    """
    The factors the B2L kernel reads for one pass at ``sign``
    (:data:`B2L_FACTORS`): the twiddle between the stages in the plan's
    own (n1, n2) layout, ``{prefix}_twlc`` (cos) and ``{prefix}_twls``
    (sin with ``sign`` folded in), so the lanes of a warp (32
    consecutive j2) read 128 contiguous bytes, the same float32 values
    as B2's ``twc``/``tws``; and B2's sub-FFT tables and
    ``{prefix}_sign`` (:func:`fused_pass_kernel_arrays` gives the same
    values under the same keys).
    """
    n1, n2 = meta.n1, meta.n2
    return {
        f"{prefix}_twlc": np.ascontiguousarray(plan.tw_cos, np.float32)
        .reshape(n1, n2),
        f"{prefix}_twls": (float(sign) * plan.tw_sin).astype(np.float32)
        .reshape(n1, n2),
        f"{prefix}_fft1_tw": sub_fft_twiddles(n1, sign),
        f"{prefix}_fft2_tw": sub_fft_twiddles(n2, sign),
        f"{prefix}_sign": int(sign),
    }


def _out_crop(meta: FusedPassMeta) -> tuple:
    return (meta.k2a * meta.n1 + meta.trim0, meta.size)


def _in_crop(meta: FusedPassMeta) -> tuple | None:
    if not meta.in_size:
        return None
    return (meta.j1a * meta.n2 + meta.pad_lo, meta.in_size)


def fft_first_axis_reference(re, im, f, *, meta: FusedPassMeta, sign: int):
    """
    Plain version of the fused pass: the torch four-step
    ``fft_first_axis`` with the pass's ``in_crop``/``out_crop``, from
    the plan factors ``fft_d1_cos`` etc. (``ops/fft.py:fft_plan_arrays``).
    """
    return fft_first_axis(
        re, im, f, sign=sign, in_crop=_in_crop(meta),
        out_crop=_out_crop(meta),
    )


def fft_last_axis_reference(re, im, f, *, meta: FusedPassMeta, sign: int):
    """
    Plain version of B2L's pass: :func:`fft_first_axis_reference` on the
    transposed (rows, row length) input, its result transposed back into
    contiguous (rows, ``meta.size``) tensors.
    """
    out = fft_first_axis_reference(re.t().contiguous(), im.t().contiguous(),
                                   f, meta=meta, sign=sign)
    return tuple(x.t().contiguous() for x in out)


def screen_load_reference(img, nm1s, coef):
    """
    Plain version of B2L's screened load (predict): the real image
    ``img`` times the w-screen e^(i theta), theta = ``coef`` x ``nm1s``
    (``coef`` = 2 pi w as a one-element float32 tensor), as (re, im).
    """
    theta = coef * nm1s
    return img * torch.cos(theta), img * torch.sin(theta)


def screen_accumulate_reference(acc, re, im, nm1s, coef):
    """
    Plain version of B2L's screened accumulation (invert): ``acc`` +=
    Re(e^(i theta) (re + i im)) = re cos(theta) - im sin(theta), theta =
    ``coef`` x ``nm1s`` (``coef`` = -2 pi w as a one-element float32
    tensor), in place; returns ``acc``.
    """
    theta = coef * nm1s
    return acc.add_(re * torch.cos(theta) - im * torch.sin(theta))


def tiled_shape(meta: FusedPassMeta, m: int) -> tuple:
    """Shape (NC, m / MB, n1i, C, MB) of a pass's tiled input."""
    return (meta.nc, m // meta.mb, meta.n1_in, meta.c, meta.mb)


def pretile_first_axis_reference(re, im, *, meta: FusedPassMeta):
    """Plain version of :func:`pretile_first_axis`: a reshape and a
    permute of each (n1i * n2, m) input into (NC, m/MB, n1i, C, MB)."""
    n1i, nc, c, mb = meta.n1_in, meta.nc, meta.c, meta.mb
    return tuple(
        x.reshape(n1i, nc, c, x.shape[1] // mb, mb)
        .permute(1, 3, 0, 2, 4)
        .contiguous()
        for x in (re, im)
    )


def _untile(x, meta: FusedPassMeta):
    """Inverse of the tiled layout: (n1i * n2, m) row-major."""
    return x.permute(2, 0, 3, 1, 4).reshape(
        meta.n1_in * meta.n2, x.shape[1] * meta.mb
    )


def pretile_first_axis(re, im, *, meta: FusedPassMeta):
    """
    Re-lay the fused pass's input (n1i * n2, m) into contiguous (n1i,
    C, MB) tiles, layout (NC, m/MB, n1i, C, MB) (counterpart
    ``pretile_first_axis``), for :func:`fft_first_axis_fused` with
    ``tiled=True``. ``m`` must be a multiple of MB. CUDA tensors go to
    the B6 kernel (or raise), CPU tensors to
    :func:`pretile_first_axis_reference`.
    """
    global PRETILE_LAUNCHES
    rows = meta.n1_in * meta.n2
    if re.dim() != 2 or re.shape[0] != rows:
        raise ValueError(
            f"pretile input shape {tuple(re.shape)} != ({rows}, m)"
        )
    if re.shape != im.shape or re.device != im.device:
        raise ValueError("re and im must have one shape and one device")
    m = re.shape[1]
    if m % meta.mb:
        raise ValueError(f"m={m} is not a multiple of MB={meta.mb}")
    if re.device.type == "cpu":
        return pretile_first_axis_reference(re, im, meta=meta)
    if re.device.type != "cuda":
        raise ValueError(f"unsupported device {re.device}")
    from . import _build

    for name, t in (("re", re), ("im", im)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32")
    re, im = re.contiguous(), im.contiguous()
    out_re = torch.empty(tiled_shape(meta, m), dtype=torch.float32,
                         device=re.device)
    out_im = torch.empty_like(out_re)
    lib = _build.load_library()
    err = lib.cip_pretile_first_axis(
        re.data_ptr(), im.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
        int(meta.n1_in), int(meta.n2), int(meta.c), int(meta.mb), int(m),
        torch.cuda.current_stream(re.device).cuda_stream,
    )
    _build.check(err, "cip_pretile_first_axis")
    PRETILE_LAUNCHES += 1
    return out_re, out_im


def fft_first_axis_tiled_reference(re, im, f, *, meta: FusedPassMeta,
                                   sign: int):
    """
    Plain version of the pass on tiled input: un-tile, then the torch
    four-step pass over all n1i * n2 rows of the covering window (as the
    counterpart's tiled pass, which reads them as given).
    """
    in_crop = None
    if meta.in_size:
        in_crop = (meta.j1a * meta.n2, meta.n1_in * meta.n2)
    return fft_first_axis(
        _untile(re, meta), _untile(im, meta), f, sign=sign,
        in_crop=in_crop, out_crop=_out_crop(meta),
    )


def fft_first_axis_fused(re, im, f, *, meta: FusedPassMeta, sign: int,
                         prefix: str = "fftp", tiled: bool = False,
                         out: tuple | None = None, z: tuple | None = None):
    """
    DFT along the first axis of (rows, m) split float32 tensors: ``n``
    rows cropped to ``meta.size`` output rows, or (in-cropped)
    ``meta.in_size`` rows of a zero-padded input to ``n`` output rows.
    On CUDA tensors this launches the B2 kernel with the factors
    ``{prefix}_*`` of :func:`fused_pass_kernel_arrays`, and raises unless
    they were built for ``sign``; on CPU tensors it runs
    :func:`fft_first_axis_reference` on the plan factors ``fft_*`` of
    the same dict.

    With ``tiled=True`` the input is :func:`pretile_first_axis`'s
    (NC, m/MB, n1i, C, MB) layout of all n1i * n2 covered rows (the
    counterpart's ``tiled`` flag); the result equals the row-major
    pass's bit for bit.

    ``out=(out_re, out_im)``: contiguous float32 (rows out, m) tensors
    on the input's device that receive the result (returned); by
    default the pass allocates them. ``z=(z_re, z_im)``: the same for
    the intermediate z (n1 n2, m) between the kernel's two launches
    (its probes read it); the plain version has no z and refuses one.
    """
    if re.device != im.device:
        raise ValueError("re and im must be on one device")
    if out is not None:
        shape = (meta.size, re.shape[1] * (meta.mb if tiled else 1))
        _check_out(out, shape, re.device, "out")
    if z is not None and re.device.type != "cuda":
        raise ValueError("z is the kernel's intermediate; the plain "
                         "version on the CPU has none")
    if tiled:
        tile = (meta.n1_in, meta.c, meta.mb)
        if (re.dim() != 5 or re.shape[0] != meta.nc
                or tuple(re.shape[2:]) != tile or re.shape != im.shape):
            raise ValueError(
                f"bad tiled input shape {tuple(re.shape)} (want "
                f"({meta.nc}, m/{meta.mb}, {meta.n1_in}, {meta.c}, "
                f"{meta.mb}))"
            )
    if re.device.type == "cuda":
        return _fft_first_axis_cuda(re, im, f, meta=meta, sign=sign,
                                    prefix=prefix, tiled=tiled, out=out,
                                    z=z)
    if re.device.type != "cpu":
        raise ValueError(f"unsupported device {re.device}")
    if tiled:
        got = fft_first_axis_tiled_reference(re, im, f, meta=meta, sign=sign)
    else:
        got = fft_first_axis_reference(re, im, f, meta=meta, sign=sign)
    if out is None:
        return got
    for dst, src in zip(out, got):
        dst.copy_(src)
    return out


def _check_out(pair, shape: tuple, device, name: str) -> None:
    for t in pair:
        if (t.device != device or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be contiguous float32 {shape} "
                             f"tensors on the input's device")


def fft2_from_image_fused(f, img_t_re, img_t_im, *, meta: FusedPassMeta,
                          prefix: str = "fftq", out: tuple | None = None):
    """
    Centred forward 2-D DFT of an (npix, npix) image zero-padded to the
    (n, n) grid (counterpart ``fft2_from_image_fused``), from the image
    TRANSPOSED: two in-cropped first-axis passes (sign -1) with one
    transpose between them, the first along the image's columns, the
    second along its rows, so the (n, n) grid comes out row-major, into
    ``out=(out_re, out_im)`` if given (contiguous float32).
    """
    a_re, a_im = fft_first_axis_fused(
        img_t_re, img_t_im, f, meta=meta, sign=-1, prefix=prefix
    )
    return fft_first_axis_fused(
        a_re.t().contiguous(), a_im.t().contiguous(), f, meta=meta,
        sign=-1, prefix=prefix, out=out,
    )


def fft_last_axis_fused(re, im, f, *, meta: FusedPassMeta, sign: int,
                        prefix: str = "fftp", out: tuple | None = None,
                        z: tuple | None = None, screen: tuple | None = None,
                        acc=None):
    """
    DFT along the last axis of (rows, row length) split float32 tensors:
    for each row what :func:`fft_first_axis_fused` computes for each
    column of the transposed tensors, from the same ``meta`` (rows of
    length n cropped to ``meta.size`` columns, or ``meta.in_size``
    columns of a zero-padded row transformed to n). On CUDA tensors this
    launches the B2L kernel with the factors ``{prefix}_*`` of
    :func:`last_axis_kernel_arrays` (raises unless they were built for
    ``sign``); on CPU tensors it runs :func:`fft_last_axis_reference`
    (with the plain screen and accumulation) on the plan factors
    ``fft_*`` of the same dict.

    ``screen=(nm1s, coef)``: the w-screen e^(i coef nm1s), ``coef`` a
    one-element float32 tensor on the device (read there: no host
    sync). With ``acc`` (invert) it is applied in the store: ``acc``,
    contiguous float32 (rows, ``meta.size``), gets Re(screen x result)
    added and is returned, and ``nm1s`` is (rows, ``meta.size``).
    Without ``acc`` (predict) it is applied in the load: ``re`` is a real
    image, ``im`` must be None, ``nm1s`` has ``re``'s shape, and the
    input is ``re`` x screen. ``acc`` without ``screen`` adds the
    result's real part. ``out``/``z`` as for
    :func:`fft_first_axis_fused` (z: (rows, n)).
    """
    screened_load = screen is not None and acc is None
    if screened_load and im is not None:
        raise ValueError("a screened load takes a real input: im must be "
                         "None")
    if not screened_load and im is None:
        raise ValueError("im is None, but no screen was given for the load")
    if im is not None and (re.device != im.device or re.shape != im.shape):
        raise ValueError("re and im must have one shape and one device")
    row_len = meta.in_size or meta.n1 * meta.n2
    if re.dim() != 2 or re.shape[1] != row_len:
        raise ValueError(f"input shape {tuple(re.shape)} != (rows, "
                         f"{row_len})")
    rows = re.shape[0]
    shape_out = (rows, meta.size)
    if acc is not None:
        if out is not None:
            raise ValueError("acc and out exclude each other")
        _check_out((acc,), shape_out, re.device, "acc")
    if out is not None:
        _check_out(out, shape_out, re.device, "out")
    if screen is not None:
        nm1s, coef = screen
        want = shape_out if acc is not None else tuple(re.shape)
        _check_out((nm1s,), want, re.device, "nm1s")
        if (coef.device != re.device or coef.dtype != torch.float32
                or coef.numel() != 1):
            raise ValueError("coef must be a one-element float32 tensor "
                             "on the input's device")
    if z is not None and re.device.type != "cuda":
        raise ValueError("z is the kernel's intermediate; the plain "
                         "version on the CPU has none")
    if re.device.type == "cuda":
        return _fft_last_axis_cuda(re, im, f, meta=meta, sign=sign,
                                   prefix=prefix, out=out, z=z,
                                   screen=screen, acc=acc)
    if re.device.type != "cpu":
        raise ValueError(f"unsupported device {re.device}")
    if screened_load:
        re, im = screen_load_reference(re, *screen)
    got = fft_last_axis_reference(re, im, f, meta=meta, sign=sign)
    if acc is not None:
        if screen is not None:
            return screen_accumulate_reference(acc, *got, *screen)
        return acc.add_(got[0])
    if out is None:
        return got
    for dst, src in zip(out, got):
        dst.copy_(src)
    return out


def pass_factors(f, meta: FusedPassMeta, *, sign: int, prefix: str,
                 device, names: tuple = B2_FACTORS) -> dict:
    """
    The ``{prefix}_*`` factor tensors of ``names`` (:data:`B2_FACTORS`,
    or B2L's :data:`B2L_FACTORS`) for one pass as the kernels read them:
    float32 on ``device`` in the shapes of
    :func:`fused_pass_kernel_arrays` and :func:`last_axis_kernel_arrays`,
    built for ``sign`` (raises otherwise; a missing table raises
    ``KeyError``).
    """
    if f.get(f"{prefix}_sign") != sign:
        raise ValueError(
            f"the {prefix}_* factors were built for sign "
            f"{f.get(f'{prefix}_sign')}, the pass asks for {sign}"
        )
    shapes = {
        "twc": (meta.nc, meta.n1, meta.c, 1),
        "tws": (meta.nc, meta.n1, meta.c, 1),
        "twlc": (meta.n1, meta.n2),
        "twls": (meta.n1, meta.n2),
        "fft1_tw": (meta.n1 - 1, 2),
        "fft2_tw": (meta.n2 - 1, 2),
    }
    tensors = {}
    for name in names:
        shape = shapes[name]
        t = f[f"{prefix}_{name}"]
        if t.device != device or t.dtype != torch.float32:
            raise TypeError(f"{prefix}_{name} must be float32 on {device}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{prefix}_{name} has shape {tuple(t.shape)}, want {shape}"
            )
        tensors[name] = t.contiguous()
    return tensors


def pass_args(re, im, factors: dict, z, out, meta: FusedPassMeta, *,
              sign: int, rows: int, pad_lo: int) -> list:
    """
    The arguments of B2's C entries (``csrc/fft_fused.cu``) from ``re``
    to ``cols2``, which its probes' entries (``csrc/fft_probes.cu``)
    take too: the pointers of the input, the factors, ``z`` and ``out``
    (pairs of tensors), then the pass's geometry for an input of
    ``rows`` rows placed at row ``pad_lo`` of the covering window, the
    sign, the packed radix passes and each stage's column tile.
    """
    n1, n2 = meta.n1, meta.n2
    return [
        re.data_ptr(), im.data_ptr(), factors["twc"].data_ptr(),
        factors["tws"].data_ptr(), factors["fft1_tw"].data_ptr(),
        factors["fft2_tw"].data_ptr(), z[0].data_ptr(), z[1].data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), int(n1), int(n2),
        int(meta.c), int(meta.j1a), int(meta.n1_in), int(pad_lo), int(rows),
        int(meta.k2a), int(meta.trim0), int(meta.size), int(sign),
        _packed_radices(n1), _packed_radices(n2), sub_fft_columns(n1),
        sub_fft_columns(n2),
    ]


def _packed_radices(n: int) -> int:
    """:func:`sub_fft_radices` packed 4 bits each, first in the low bits."""
    return sum(r << (4 * i) for i, r in enumerate(sub_fft_radices(n)))


def _fft_first_axis_cuda(re, im, f, *, meta, sign, prefix, tiled, out, z):
    global LAUNCHES, IN_CROP_LAUNCHES, TILED_LAUNCHES
    from . import _build

    factors = pass_factors(f, meta, sign=sign, prefix=prefix,
                           device=re.device)
    n1, n2, n1i = meta.n1, meta.n2, meta.n1_in
    for name, t in (("re", re), ("im", im)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
    re, im = re.contiguous(), im.contiguous()
    if tiled:
        if meta.mb != MB:
            raise ValueError(f"the tiled kernel takes MB = {MB}, "
                             f"not {meta.mb}")
        m = re.shape[1] * meta.mb
        pad_lo, rows = 0, n1i * n2
    else:
        # The kernel reads the in-cropped rows in place and zero-fills
        # the rest of the covering j1 window (stage-1 pruning).
        rows = meta.in_size or n1i * n2
        pad_lo = meta.pad_lo if meta.in_size else 0
        for name, t in (("re", re), ("im", im)):
            if t.dim() != 2:
                raise TypeError(f"{name} must be a 2-D float32 tensor")
            if t.shape[0] != rows:
                raise ValueError(f"{name} has {t.shape[0]} rows, want {rows}")
        if re.shape != im.shape:
            raise ValueError("re and im shapes differ")
        m = re.shape[1]
    if z is None:
        z_re = torch.empty((n1 * n2, m), dtype=torch.float32,
                           device=re.device)
        z = (z_re, torch.empty_like(z_re))
    else:
        _check_out(z, (n1 * n2, m), re.device, "z")
    if out is None:
        out_re = torch.empty(
            (meta.size, m), dtype=torch.float32, device=re.device
        )
        out_im = torch.empty_like(out_re)
    else:
        out_re, out_im = out
    lib = _build.load_library()
    args = pass_args(re, im, factors, z, (out_re, out_im), meta, sign=sign,
                     rows=rows, pad_lo=pad_lo)
    stream = torch.cuda.current_stream(re.device).cuda_stream
    if tiled:
        err = lib.cip_fft_first_axis_fused_tiled(*args, int(meta.mb), int(m),
                                                 stream)
        _build.check(err, "cip_fft_first_axis_fused_tiled")
        TILED_LAUNCHES += 1
    else:
        err = lib.cip_fft_first_axis_fused(*args, int(m), stream)
        _build.check(err, "cip_fft_first_axis_fused")
        if meta.in_size:
            IN_CROP_LAUNCHES += 1
        else:
            LAUNCHES += 1
    return out_re, out_im


def _fft_last_axis_cuda(re, im, f, *, meta, sign, prefix, out, z, screen,
                        acc):
    global LAST_AXIS_LAUNCHES, LAST_AXIS_IN_CROP_LAUNCHES
    from . import _build

    factors = pass_factors(f, meta, sign=sign, prefix=prefix,
                           device=re.device, names=B2L_FACTORS)
    n1, n2 = meta.n1, meta.n2
    for name, t in (("re", re), ("im", im)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
    re = re.contiguous()
    im = None if im is None else im.contiguous()
    rows = re.shape[0]
    if z is None:
        z_re = torch.empty((rows, n1 * n2), dtype=torch.float32,
                           device=re.device)
        z = (z_re, torch.empty_like(z_re))
    else:
        _check_out(z, (rows, n1 * n2), re.device, "z")
    nm1s, coef = screen if screen is not None else (None, None)
    if acc is not None:
        out_re, out_im = acc, None
        mode = _ACCUMULATE if screen is None else _SCREEN_ACCUMULATE
    else:
        if out is None:
            out_re = torch.empty((rows, meta.size), dtype=torch.float32,
                                 device=re.device)
            out_im = torch.empty_like(out_re)
        else:
            out_re, out_im = out
        mode = _STORE
    screen_in = int(screen is not None and acc is None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.load_library()
    err = lib.cip_fft_last_axis_fused(
        re.data_ptr(), ptr(im), factors["twlc"].data_ptr(),
        factors["twls"].data_ptr(), factors["fft1_tw"].data_ptr(),
        factors["fft2_tw"].data_ptr(), z[0].data_ptr(), z[1].data_ptr(),
        out_re.data_ptr(), ptr(out_im), ptr(nm1s), ptr(coef), screen_in,
        mode, int(n1), int(n2), int(meta.j1a), int(meta.n1_in),
        int(meta.pad_lo if meta.in_size else 0), int(re.shape[1]),
        int(meta.k2a), int(meta.trim0), int(meta.size), int(sign),
        _packed_radices(n1), _packed_radices(n2), sub_fft_columns(n1),
        last_axis_columns(n2), int(rows),
        torch.cuda.current_stream(re.device).cuda_stream,
    )
    _build.check(err, "cip_fft_last_axis_fused")
    if meta.in_size:
        LAST_AXIS_IN_CROP_LAUNCHES += 1
    else:
        LAST_AXIS_LAUNCHES += 1
    return acc if acc is not None else (out_re, out_im)
