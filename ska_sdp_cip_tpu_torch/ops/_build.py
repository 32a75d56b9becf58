"""
Build and load the port's CUDA kernels (no counterpart in the JAX
package, whose kernels Pallas compiles inside ``jax.jit``).

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` into a shared
library with a plain C interface, all of them started together, at
first use, and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/<stem>_<hash>.so csrc/<stem>.cu

A library's name carries a hash of the flags, its source and the
sources that includes (``fft_probes.cu`` includes ``fft_dense.cuh``), so
an edited source never loads a stale build and rebuilds only the
libraries made from it. The build directory is
``build/torch_kernels/`` beside the package. ``nvcc`` is taken from
``CUDA_HOME``/``CUDA_PATH``, then ``PATH``, then ``/usr/local/cuda``.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lock = threading.Lock()
_library = None
#: Seconds the last build took (all sources, compiled concurrently) and
#: nvcc's report (registers, shared memory and spills per kernel, from
#: ``-Xptxas -v``); None when every library was loaded from an earlier
#: build.
build_seconds: float | None = None
build_log: str | None = None


def find_nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of ska_sdp_cip_tpu_torch are built from csrc/ at first "
        "use"
    )


def _sources() -> list[Path]:
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return sources


_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.MULTILINE)


def _with_includes(source: Path) -> list[Path]:
    """``source`` and the sources it includes with ``#include "..."``,
    transitively, each once."""
    seen = [source]
    for path in seen:
        for name in _INCLUDE.findall(path.read_bytes()):
            dep = path.parent / name.decode()
            if dep not in seen:
                seen.append(dep)
    return seen


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` with the flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _with_includes(source):
        digest.update(path.name.encode() + path.read_bytes())
    return BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"


class _Library:
    """The C entries of the per-source libraries, looked up by name."""

    def __init__(self, libs) -> None:
        self._libs = libs

    def __getattr__(self, name):
        for lib in self._libs:
            try:
                entry = getattr(lib, name)
            except AttributeError:
                continue
            setattr(self, name, entry)
            return entry
        raise AttributeError(f"no CUDA entry {name!r} in {CSRC}")


def _declare(lib) -> None:
    c_int, c_i64, c_float, ptr = (
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.c_void_p,
    )
    lib.cip_grid_planes.argtypes = [ptr] * 10 + [c_int, c_int, ptr, c_int,
                                                 ptr] + [
        c_int, c_int, c_int, c_int, c_int, c_int,
        c_float, c_float, c_float,
        c_int, c_int, ptr,
    ]
    lib.cip_grid_planes.restype = c_int
    lib.cip_degrid_planes.argtypes = [ptr] * 8 + [c_int, ptr, c_int] + [
        ptr, ptr, ptr,
        c_int, c_int, c_int, c_int,
        c_float, c_float, c_float,
        c_int, c_int, ptr,
    ]
    lib.cip_degrid_planes.restype = c_int
    b2 = [ptr] * 10 + [c_int] * 6 + [c_i64] + [c_int] * 4 + [c_i64] * 2 + [
        c_int, c_int,
    ]
    lib.cip_fft_first_axis_fused.argtypes = b2 + [c_i64, ptr]
    lib.cip_fft_first_axis_fused.restype = c_int
    lib.cip_fft_first_axis_fused_tiled.argtypes = b2 + [c_int, c_i64, ptr]
    lib.cip_fft_first_axis_fused_tiled.restype = c_int
    lib.cip_pretile_first_axis.argtypes = [ptr] * 4 + [c_int] * 4 + [
        c_i64, ptr,
    ]
    lib.cip_pretile_first_axis.restype = c_int
    for name in ("cip_fft_async_fetch", "cip_fft_ablation"):
        entry = getattr(lib, name)
        entry.argtypes = [c_int] + [ptr] * 10 + [c_int] * 8 + [c_i64, ptr]
        entry.restype = c_int
    lib.cip_smem_probe.argtypes = [c_int, ptr, ptr]
    lib.cip_smem_probe.restype = c_int
    lib.cip_smem_optin_bytes.argtypes = [c_int, ctypes.POINTER(c_int)]
    lib.cip_smem_optin_bytes.restype = c_int


def _compile(sources: list[Path]) -> None:
    """Compile ``sources``, one nvcc each, all running at once."""
    global build_seconds, build_log
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    jobs = []
    for source in sources:
        target = library_path(source)
        tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((cmd, tmp, target, proc))
    logs, failed = [], []
    for cmd, tmp, target, proc in jobs:
        out, _ = proc.communicate()
        logs.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{Path(cmd[-1]).name} ({proc.returncode})")
        else:
            os.replace(tmp, target)
    build_seconds = time.perf_counter() - start
    build_log = "\n".join(logs)
    (BUILD_DIR / "build.log").write_text(build_log)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n{build_log}")


def load_library():
    """Build the kernels if needed and return their C entries."""
    global _library
    with _lock:
        if _library is not None:
            return _library
        sources = _sources()
        missing = [s for s in sources if not library_path(s).is_file()]
        if missing:
            _compile(missing)
        lib = _Library([ctypes.CDLL(str(library_path(s))) for s in sources])
        _declare(lib)
        _library = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
