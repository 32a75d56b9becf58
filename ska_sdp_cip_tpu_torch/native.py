"""
ctypes bindings for the native C++ planning engine
(``csrc/cip_native.cpp``).

Counterpart: ``ska_sdp_cip_tpu/native.py``, with the same C
declarations and the same functions. ``csrc/cip_native.cpp`` is a
byte-for-byte copy of the JAX package's ``native/cip_native.cpp``
(``tests/test_torch_native.py`` holds them equal). Where the
counterpart loads a library that ``make -C native`` left in its own
tree, the port builds its library at first use with the host C++
compiler (``g++``, else ``c++``):

    g++ -O3 -fPIC -std=c++17 -Wall -Wextra -shared \\
        -o build/torch_native/libcipnative_<hash>.so csrc/cip_native.cpp \\
        -lpthread

These are ``native/Makefile``'s flags without ``-march=native``: a
library built with it runs only on CPUs like the one that built it, and
a checkout moves between machines. ``-std=c++17`` keeps floating-point
contraction off, so the engine rounds as numpy does where the two do
the same operations (its positions may still land one float32 ulp from
the numpy planner's: ROADMAP.md, C6). The library's name carries a
hash of the source, the flags and the compiler's version line.
Processes that build at once (test workers) take turns under a file
lock, and each library lands under its name with ``os.replace``.

:func:`available` is False only when no C++ compiler is on ``PATH``;
the numpy planner then runs. With a compiler present, a build or load
that fails raises with the compiler's output: nothing falls back.
Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from .utils.hostmem import alloc_populated

SOURCE = Path(__file__).resolve().parent / "csrc" / "cip_native.cpp"
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")
LD_FLAGS = ("-lpthread",)

_lock = threading.Lock()
_LIB = None
_SEARCHED = False
#: Seconds the last build took, the compiler's version line and the
#: compiler's output; ``build_seconds`` is None when the library was
#: loaded from an earlier build.
build_seconds: float | None = None
compiler: str | None = None
build_log: str | None = None


def find_cxx() -> str | None:
    """The host C++ compiler on ``PATH`` (``g++``, else ``c++``)."""
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    return None


def library_path(cxx: str) -> tuple:
    """(where the library built by ``cxx`` lives, ``cxx``'s version
    line)."""
    version = subprocess.run(
        [cxx, "--version"], capture_output=True, text=True, check=True
    ).stdout.splitlines()[0]
    digest = hashlib.sha256(
        " ".join((*CXX_FLAGS, *LD_FLAGS, version)).encode()
    )
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcipnative_{digest.hexdigest()[:16]}.so", version


def _compile(cxx: str, target: Path) -> None:
    """Build ``target`` unless another process did while this one waited
    for the lock."""
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.is_file():
            return
        tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LD_FLAGS]
        start = time.perf_counter()
        proc = subprocess.run(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        build_log = " ".join(cmd) + "\n" + proc.stdout
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building the native planner engine failed "
                f"({proc.returncode}):\n{build_log}"
            )
        os.replace(tmp, target)
        build_seconds = time.perf_counter() - start


def load_library():
    """The native library, built if needed; None when no C++ compiler is
    on ``PATH``. Raises when a build or load fails."""
    global _LIB, _SEARCHED, compiler
    with _lock:
        if _SEARCHED:
            return _LIB
        cxx = find_cxx()
        if cxx is None:
            _SEARCHED = True
            return None
        target, compiler = library_path(cxx)
        if not target.is_file():
            _compile(cxx, target)
        try:
            lib = ctypes.CDLL(str(target))
        except OSError as err:
            raise RuntimeError(
                f"loading the native planner engine {target} failed: {err}"
                f"\n{build_log or ''}"
            ) from err
        _declare(lib)
        _LIB, _SEARCHED = lib, True
        return lib


def available() -> bool:
    return load_library() is not None


def _declare(lib) -> None:
    import ctypes as ct

    dp = ct.POINTER(ct.c_double)
    fp = ct.POINTER(ct.c_float)
    i64p = ct.POINTER(ct.c_int64)
    i32p = ct.POINTER(ct.c_int32)
    u8p = ct.POINTER(ct.c_uint8)

    lib.cip_w_minmax.argtypes = [dp, ct.c_int64, dp, ct.c_int64, dp, dp]
    lib.cip_plan_arrays.argtypes = [
        dp, ct.c_int64, dp, ct.c_int64, ct.c_double, ct.c_int64,
        ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int,
        ct.c_double, ct.c_double, ct.c_int64,
        u8p, i32p, i32p, fp, fp, fp, i64p,
    ]
    lib.cip_argsort_i64.argtypes = [i64p, ct.c_int64, i64p]
    lib.cip_gather_f32.argtypes = [fp, i64p, ct.c_int64, fp]
    lib.cip_gather_i32.argtypes = [i32p, i64p, ct.c_int64, i32p]
    lib.cip_gather_u8.argtypes = [u8p, i64p, ct.c_int64, u8p]
    lib.cip_slot_plan_build.argtypes = [
        dp, ct.c_int64, dp, ct.c_int64, ct.c_double, ct.c_int64,
        ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int64, ct.c_int,
        ct.c_double, ct.c_double, ct.c_int64, ct.c_int64, ct.c_int64,
        ct.c_int,
    ]
    lib.cip_slot_plan_build.restype = ct.c_int64
    lib.cip_slot_plan_sizes.argtypes = [ct.c_int64, i64p]
    lib.cip_slot_plan_export.argtypes = [
        ct.c_int64, ct.c_int64, ct.c_int32,
        i32p, u8p, i32p, i32p, fp, fp, fp,
        i32p, i32p, i32p, i32p, i32p,
        fp, fp, ct.c_double, fp, fp, i32p,
    ]
    lib.cip_slot_plan_free.argtypes = [ct.c_int64]
    lib.cip_arena_prewarm.argtypes = [i64p, ct.c_int64]
    lib.cip_phase_cossin.argtypes = [
        fp, ct.c_int64, ct.c_double, fp, fp
    ]
    lib.cip_density_accumulate.argtypes = [
        dp, ct.c_int64, dp, ct.c_int64, dp, ct.c_double, ct.c_int64, dp
    ]
    lib.cip_stage_slot_vis.argtypes = [
        fp, fp, ct.c_int64, i64p, fp, fp, fp, ct.c_int64,
        ct.c_int32, fp, fp,
    ]


def _ptr(arr, ctype):
    if arr is None:  # optional output: the C side skips NULL targets
        return None
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def w_minmax(uvw: np.ndarray, freqs: np.ndarray) -> tuple:
    lib = load_library()
    uvw = np.ascontiguousarray(uvw, np.float64)
    freqs = np.ascontiguousarray(freqs, np.float64)
    lo = ctypes.c_double()
    hi = ctypes.c_double()
    lib.cip_w_minmax(
        _ptr(uvw, ctypes.c_double),
        len(uvw),
        _ptr(freqs, ctypes.c_double),
        len(freqs),
        ctypes.byref(lo),
        ctypes.byref(hi),
    )
    return lo.value, hi.value


def plan_arrays(
    uvw: np.ndarray,
    freqs: np.ndarray,
    *,
    inv_du: float,
    ngrid: int,
    support: int,
    tile_cells_x: int,
    tile_cells_y: int,
    ntiles_y: int,
    wstacking: bool,
    w0_plane: float,
    dw: float,
    nplanes: int,
) -> dict:
    """Fused per-sample plan arrays + composite sort key."""
    lib = load_library()
    uvw = np.ascontiguousarray(uvw, np.float64)
    freqs = np.ascontiguousarray(freqs, np.float64)
    n = len(uvw) * len(freqs)
    out = {
        "flip": np.empty(n, np.uint8),
        "x0": np.empty(n, np.int32),
        "y0": np.empty(n, np.int32),
        "fx": np.empty(n, np.float32),
        "fy": np.empty(n, np.float32),
        "ws": np.empty(n, np.float32),
        "key": np.empty(n, np.int64),
    }
    lib.cip_plan_arrays(
        _ptr(uvw, ctypes.c_double),
        len(uvw),
        _ptr(freqs, ctypes.c_double),
        len(freqs),
        ctypes.c_double(inv_du),
        ngrid,
        support,
        tile_cells_x,
        tile_cells_y,
        ntiles_y,
        int(wstacking),
        ctypes.c_double(w0_plane),
        ctypes.c_double(1.0 / dw),
        nplanes,
        _ptr(out["flip"], ctypes.c_uint8),
        _ptr(out["x0"], ctypes.c_int32),
        _ptr(out["y0"], ctypes.c_int32),
        _ptr(out["fx"], ctypes.c_float),
        _ptr(out["fy"], ctypes.c_float),
        _ptr(out["ws"], ctypes.c_float),
        _ptr(out["key"], ctypes.c_int64),
    )
    return out


def build_slot_plan(
    uvw: np.ndarray,
    freqs: np.ndarray,
    *,
    inv_du: float,
    ngrid: int,
    support: int,
    tile_x: int,
    tile_y: int,
    ntiles_y: int,
    wstacking: bool,
    w0_plane: float,
    dw: float,
    num_bins: int,
    block: int,
    bin_group: int = 1,
    min_blocks: int = 1,
    pad_order: int = 0,
    phase_factor: float = 0.0,
    export_coords: bool = True,
    export_packed: bool = True,
) -> dict:
    """
    Fused (uvw, freqs) -> block-slot plan layout: per-slot sample
    indices and footprint columns plus per-block metadata, produced by
    one multithreaded C++ pass (geometry, lane-straddler duplication,
    radix key sort, block split, slot scatter). ``num_blocks`` in the
    result is the REAL block count; arrays are padded to
    ``max(num_blocks, min_blocks, 1)`` blocks.

    ``export_coords=False`` skips the per-slot coordinate columns
    (flip, x0, y0, fx, fy, ws — returned as None): the kernels read
    only the packed columns.

    ``export_packed=False`` additionally skips the packed /
    flip_sign / phase_cos / phase_sin columns (returned as None) and
    emits ``order_enc`` instead (source index, conjugation flip in
    the sign) — the compact staging path (ops/gridder.py:
    build_assemble) rebuilds everything on device.
    """
    lib = load_library()
    uvw = np.ascontiguousarray(uvw, np.float64)
    freqs = np.ascontiguousarray(freqs, np.float64)
    handle = lib.cip_slot_plan_build(
        _ptr(uvw, ctypes.c_double),
        len(uvw),
        _ptr(freqs, ctypes.c_double),
        len(freqs),
        ctypes.c_double(inv_du),
        ngrid,
        support,
        tile_x,
        tile_y,
        ntiles_y,
        int(wstacking),
        ctypes.c_double(w0_plane),
        ctypes.c_double(1.0 / dw),
        num_bins,
        block,
        max(int(bin_group), 1),
        # Per-sample coordinate stores are only needed when the
        # export will read them (coords or packed rows).
        int(bool(export_coords or export_packed)),
    )
    try:
        nb = ctypes.c_int64()
        lib.cip_slot_plan_sizes(handle, ctypes.byref(nb))
        num_blocks = int(nb.value)
        padded = max(num_blocks, min_blocks, 1)
        num_slots = padded * block

        def _coords(count, dtype):
            return (
                alloc_populated(count, dtype) if export_coords else None
            )

        def _packed(count):
            if not export_packed:
                return None
            return alloc_populated(count, np.float32)

        packed = _packed(4 * num_slots)
        out = {
            "order": alloc_populated(num_slots, np.int32),
            "flip": _coords(num_slots, np.uint8),
            "x0": _coords(num_slots, np.int32),
            "y0": _coords(num_slots, np.int32),
            "fx": _coords(num_slots, np.float32),
            "fy": _coords(num_slots, np.float32),
            "ws": _coords(num_slots, np.float32),
            "block_len": alloc_populated(padded, np.int32),
            "block_ox": alloc_populated(padded, np.int32),
            "block_oy": alloc_populated(padded, np.int32),
            "bin_lo": alloc_populated(padded, np.int32),
            "bin_hi": alloc_populated(padded, np.int32),
            # Kernel-ready derived columns, same export pass: the rows
            # (xpos, ypos, ws, len) of ``pack_plan_columns``.
            "packed": None if packed is None else packed.reshape(4, num_slots),
            "flip_sign": _packed(num_slots),
            "phase_cos": _packed(num_slots),
            "phase_sin": _packed(num_slots),
            "order_enc": (
                None
                if export_packed
                else alloc_populated(num_slots, np.int32)
            ),
        }
        lib.cip_slot_plan_export(
            handle,
            padded,
            ctypes.c_int32(pad_order),
            _ptr(out["order"], ctypes.c_int32),
            _ptr(out["flip"], ctypes.c_uint8),
            _ptr(out["x0"], ctypes.c_int32),
            _ptr(out["y0"], ctypes.c_int32),
            _ptr(out["fx"], ctypes.c_float),
            _ptr(out["fy"], ctypes.c_float),
            _ptr(out["ws"], ctypes.c_float),
            _ptr(out["block_len"], ctypes.c_int32),
            _ptr(out["block_ox"], ctypes.c_int32),
            _ptr(out["block_oy"], ctypes.c_int32),
            _ptr(out["bin_lo"], ctypes.c_int32),
            _ptr(out["bin_hi"], ctypes.c_int32),
            _ptr(out["packed"], ctypes.c_float),
            _ptr(out["flip_sign"], ctypes.c_float),
            ctypes.c_double(phase_factor),
            _ptr(out["phase_cos"], ctypes.c_float),
            _ptr(out["phase_sin"], ctypes.c_float),
            _ptr(out["order_enc"], ctypes.c_int32),
        )
    finally:
        lib.cip_slot_plan_free(handle)
    out["num_blocks"] = num_blocks
    return out


def arena_prewarm(sizes) -> None:
    """Pre-fault C++ scratch buffers of the given byte sizes into the
    native warm-buffer arena (no-op without the native library)."""
    lib = load_library()
    if lib is None or not len(sizes):
        return
    arr = np.ascontiguousarray(sizes, np.int64)
    lib.cip_arena_prewarm(_ptr(arr, ctypes.c_int64), len(arr))


def phase_cossin(ws: np.ndarray, factor: float) -> tuple:
    """(cos(factor * ws), sin(factor * ws)) as float32, multithreaded."""
    lib = load_library()
    ws = np.ascontiguousarray(ws, np.float32)
    cos_out = alloc_populated(len(ws), np.float32)
    sin_out = alloc_populated(len(ws), np.float32)
    lib.cip_phase_cossin(
        _ptr(ws, ctypes.c_float),
        len(ws),
        ctypes.c_double(factor),
        _ptr(cos_out, ctypes.c_float),
        _ptr(sin_out, ctypes.c_float),
    )
    return cos_out, sin_out


def stage_slot_vis(
    vis_re: np.ndarray,
    vis_im: np.ndarray,
    order: np.ndarray,
    flip_sign: np.ndarray,
    phase_cos: np.ndarray,
    phase_sin: np.ndarray,
    *,
    wstacking: bool,
) -> tuple:
    """
    Fused multithreaded slot staging: gather data-order split
    visibilities into slot order, conjugate-flip, apply the w-shift
    pre-phase (ops/gridder.py:stage_slot_vis semantics: padding slots
    whose ``order`` index is out of range stage as zero).
    """
    lib = load_library()
    vis_re = np.ascontiguousarray(vis_re, np.float32).ravel()
    vis_im = np.ascontiguousarray(vis_im, np.float32).ravel()
    order = np.ascontiguousarray(order, np.int64)
    flip_sign = np.ascontiguousarray(flip_sign, np.float32)
    # Keep converted temporaries referenced for the call's duration.
    phase_cos = np.ascontiguousarray(phase_cos, np.float32)
    phase_sin = np.ascontiguousarray(phase_sin, np.float32)
    num_slots = len(order)
    out_re = alloc_populated(num_slots, np.float32)
    out_im = alloc_populated(num_slots, np.float32)
    lib.cip_stage_slot_vis(
        _ptr(vis_re, ctypes.c_float),
        _ptr(vis_im, ctypes.c_float),
        len(vis_re),
        _ptr(order, ctypes.c_int64),
        _ptr(flip_sign, ctypes.c_float),
        _ptr(phase_cos, ctypes.c_float),
        _ptr(phase_sin, ctypes.c_float),
        num_slots,
        ctypes.c_int32(1 if wstacking else 0),
        _ptr(out_re, ctypes.c_float),
        _ptr(out_im, ctypes.c_float),
    )
    return out_re, out_im


def density_accumulate(
    uvw: np.ndarray,
    freqs: np.ndarray,
    weights: np.ndarray,
    *,
    inv_cell: float,
    npix: int,
    density: np.ndarray,
) -> np.ndarray:
    """
    Accumulate gridded weight density (direct + conjugate mirror) into
    ``density`` (npix, npix) float64 — the multithreaded replacement for
    the per-sample ``bincount`` fit in models/weighting.py.
    """
    lib = load_library()
    uvw = np.ascontiguousarray(uvw, np.float64)
    freqs = np.ascontiguousarray(freqs, np.float64)
    weights = np.ascontiguousarray(
        np.asarray(weights, np.float64).reshape(len(uvw), len(freqs))
    )
    if density.dtype != np.float64 or not density.flags.c_contiguous:
        raise ValueError("density must be a C-contiguous float64 array")
    if density.shape != (npix, npix):
        raise ValueError(f"density must have shape ({npix}, {npix})")
    lib.cip_density_accumulate(
        _ptr(uvw, ctypes.c_double),
        len(uvw),
        _ptr(freqs, ctypes.c_double),
        len(freqs),
        _ptr(weights, ctypes.c_double),
        ctypes.c_double(inv_cell),
        npix,
        _ptr(density, ctypes.c_double),
    )
    return density


def argsort_i64(keys: np.ndarray) -> np.ndarray:
    lib = load_library()
    keys = np.ascontiguousarray(keys, np.int64)
    order = np.empty(len(keys), np.int64)
    lib.cip_argsort_i64(
        _ptr(keys, ctypes.c_int64), len(keys), _ptr(order, ctypes.c_int64)
    )
    return order


def gather(src: np.ndarray, order: np.ndarray) -> np.ndarray:
    """out[i] = src[order[i]] via the multithreaded native gather."""
    lib = load_library()
    order = np.ascontiguousarray(order, np.int64)
    src = np.ascontiguousarray(src)
    if len(order) and (order.min() < 0 or order.max() >= len(src)):
        raise IndexError("gather index out of range")
    out = np.empty(len(order), src.dtype)
    n = len(order)
    if src.dtype == np.float32:
        lib.cip_gather_f32(
            _ptr(src, ctypes.c_float),
            _ptr(order, ctypes.c_int64),
            n,
            _ptr(out, ctypes.c_float),
        )
    elif src.dtype == np.int32:
        lib.cip_gather_i32(
            _ptr(src, ctypes.c_int32),
            _ptr(order, ctypes.c_int64),
            n,
            _ptr(out, ctypes.c_int32),
        )
    elif src.dtype == np.uint8:
        lib.cip_gather_u8(
            _ptr(src, ctypes.c_uint8),
            _ptr(order, ctypes.c_int64),
            n,
            _ptr(out, ctypes.c_uint8),
        )
    else:
        out = src[order]
    return out
