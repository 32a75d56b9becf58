"""
Fetch-depth probe of kernel B2 (P1; counterpart
``scripts/fft_split_fetch_probe.py``, whose TPU kernel split B2's input
into K specs to keep 2K DMAs in flight).

    python -m ska_sdp_cip_tpu_torch.probes.fft_async_fetch [ngrid]

The Hopper question: does B2 go faster with more of its input in
flight? :func:`async_fetch_pass` runs B2's out-cropped pass (sign +1)
with each stage a persistent kernel (``csrc/fft_probes.cu``): about
SMs x (blocks an SM) blocks walk the stage's (row, 32-column tile)
units in B2's order, and an S-deep ring of input slots keeps the fetch
of unit u + S - 1 in flight while unit u's radix passes run. The fetch
engine is ``cp_async`` (B2's 16-byte copies) or ``bulk`` (one
``cp.async.bulk`` a row segment, completing on an mbarrier); the depths
that fit shared memory are :func:`depths`'s (``ops/fft_cuda.py:
ring_geometry``). The loads, the passes and their order are B2's, so
every output equals B2's bit for bit; S = 1 with ``cp_async`` is B2's
schedule made persistent. :func:`run` checks that, and the plain
version (1e-5 of max), and times each (engine, S) whole and stage by
stage beside B2, the plain version and ``torch.fft``.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..ops import _build
from ..ops.fft_cuda import (
    RING_DEPTHS,
    RING_ENGINES,
    fft_first_axis_fused,
    fft_first_axis_reference,
    pass_args,
    pass_factors,
    ring_geometry,
)
from . import common
from .fft_ablation import (
    ablation_reference,
    check_columns,
    library_call,
    occupancy,
    variant_work,
)

ENGINES = RING_ENGINES
STAGES = RING_DEPTHS

#: Launches of the probe kernels per (engine, ring depth), keyed
#: ``{engine}_S{S}`` (one per :func:`async_fetch_pass` call on CUDA
#: tensors, which launches one or both stages).
LAUNCHES = {f"{e}_S{s}": 0 for e in ENGINES for s in STAGES}


def depths(meta, engine: str) -> tuple:
    """The ring depths whose buffers fit both stages of the pass."""
    fit = [ring_geometry(n, engine) for n in (meta.n1, meta.n2)]
    return tuple(s for s in STAGES if all(s in g.depths for g in fit))


def left_out(meta, engine: str) -> dict:
    """Why each depth :func:`depths` leaves out does not fit."""
    why = {}
    for n in (meta.n1, meta.n2):
        g = ring_geometry(n, engine)
        for s in STAGES:
            if s not in g.depths:
                why.setdefault(f"{engine}_S{s}", g.why)
    return why


def async_fetch_pass(re, im, f, *, meta, engine: str, stages: int,
                     stage: int | None = None, stats: dict | None = None):
    """
    B2's out-cropped pass (sign +1, factors ``fftp_*``) through P1's
    ring kernels: with ``stage=None`` both stages, (n, m) re/im to the
    (size, m) output; ``stage=1`` returns z (n1 n2, m); ``stage=2``
    takes z as re/im. CUDA tensors go to the probe kernels (or raise:
    m % 4 == 0 and 16-byte-aligned rows, a depth that fits, B2's
    32-column tiles), CPU tensors to the plain pieces (the plain pass,
    its z, P2's plain ``s2``). ``stats``, if given, receives the blocks
    an SM and the blocks of each stage's launch.
    """
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if stages not in STAGES:
        raise ValueError(f"stages must be one of {STAGES}, got {stages}")
    if stage not in (None, 1, 2):
        raise ValueError(f"stage must be None, 1 or 2, got {stage}")
    if meta.in_size:
        raise ValueError("the probe runs the out-cropped pass only")
    rows = meta.n1 * meta.n2
    if re.dim() != 2 or re.shape != im.shape or re.shape[0] != rows:
        raise ValueError(f"re/im must share a ({rows}, m) shape, got "
                         f"{tuple(re.shape)}")
    if re.device.type == "cpu":
        if stage is None:
            return fft_first_axis_reference(re, im, f, meta=meta, sign=+1)
        if stage == 1:
            return common.plain_z(re, im, f, meta=meta)
        return ablation_reference("s2", re, im, f, meta=meta)
    if re.device.type != "cuda":
        raise ValueError(f"unsupported device {re.device}")
    if stages not in depths(meta, engine):
        raise ValueError(f"{engine} S={stages} does not fit: "
                         f"{left_out(meta, engine)}")
    check_columns(meta)
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError("re/im must be float32")
    re, im = re.contiguous(), im.contiguous()
    m = re.shape[1]
    if m % 4 or re.data_ptr() % 16 or im.data_ptr() % 16:
        raise ValueError(f"rows of m floats must be 16-byte aligned (m % 4 "
                         f"== 0, aligned re/im), got m={m}")
    factors = pass_factors(f, meta, sign=+1, prefix="fftp", device=re.device)

    def pair(n):
        t = torch.empty((n, m), dtype=torch.float32, device=re.device)
        return t, torch.empty_like(t)

    z = (re, im) if stage == 2 else pair(rows)
    out = z if stage == 1 else pair(meta.size)
    info = (ctypes.c_int * 4)()
    lib = _build.load_library()
    err = lib.cip_fft_async_fetch(
        ENGINES.index(engine), int(stages), {None: 3, 1: 1, 2: 2}[stage],
        *pass_args(re, im, factors, z, out, meta, sign=+1, rows=rows,
                   pad_lo=0),
        int(m), info, torch.cuda.current_stream(re.device).cuda_stream,
    )
    _build.check(err, f"cip_fft_async_fetch({engine}, S={stages})")
    LAUNCHES[f"{engine}_S{stages}"] += 1
    if stats is not None:
        stats.update(occupancy(info))
    return out


def run(ngrid: int = common.PRODUCTION_NGRID, *, device="cuda",
        iters: int = 3) -> dict:
    s = common.out_crop_pass(ngrid, device)
    device, meta, f = s.re.device, s.meta, s.f
    m = s.re.shape[1]
    b2_out, b2_z = common.b2_with_z(s)
    ref = fft_first_axis_reference(s.re, s.im, f, meta=meta, sign=+1)
    nbytes, flops = variant_work(meta, m)["full"]
    floor = nbytes + 2 * 8 * m * meta.n1 * meta.n2
    library_ms, what = library_call("full", (s.re, s.im), meta, device)
    out = {"probe": "fft_async_fetch", "ngrid": s.n, "m": m,
           "device": common.device_name(device), **common.geometry(meta),
           "two_launch_floor_ms": common.work(floor, None)["bound_ms"],
           "b2_ms": common.median_ms(
               lambda: fft_first_axis_fused(s.re, s.im, f, meta=meta,
                                            sign=+1), device, runs=iters),
           "plain_ms": common.median_ms(
               lambda: fft_first_axis_reference(s.re, s.im, f, meta=meta,
                                                sign=+1), device, runs=iters),
           "library_ms": library_ms, "library_call": what,
           "cases": {}, "left_out": {}}
    for engine in ENGINES:
        out["left_out"].update(left_out(meta, engine))
        for stages in depths(meta, engine):
            def ring(stage=None, x=(s.re, s.im), engine=engine,
                     stages=stages, stats=None):
                return async_fetch_pass(*x, f, meta=meta, engine=engine,
                                        stages=stages, stage=stage,
                                        stats=stats)

            stats = {}
            got = ring(stats=stats)
            err, rel = common.max_err(got, ref)
            case = {"exact": common.all_equal(got, b2_out),
                    "max_abs_err": err, "max_rel_err": rel,
                    "launch": stats}
            del got
            got = ring(stage=1)
            case["stage1_exact"] = common.all_equal(got, b2_z)
            del got
            case["stage2_exact"] = common.all_equal(ring(stage=2, x=b2_z),
                                                    b2_out)
            if not (case["exact"] and case["stage1_exact"]
                    and case["stage2_exact"]
                    and rel <= common.KERNEL_RTOL):
                raise common.ProbeError(
                    f"fft_async_fetch {engine} S={stages} at {s.n}: {case}")
            case["ms"] = common.median_ms(ring, device, runs=iters)
            case["stage1_ms"] = common.median_ms(lambda: ring(stage=1),
                                                 device, runs=iters)
            case["stage2_ms"] = common.median_ms(
                lambda: ring(stage=2, x=b2_z), device, runs=iters)
            case.update(common.work(nbytes, case["ms"], flops))
            out["cases"][f"{engine}_S{stages}"] = case
    return out


if __name__ == "__main__":
    sys.exit(common.main(run))
