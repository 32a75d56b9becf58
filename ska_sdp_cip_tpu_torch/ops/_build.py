"""
Build and load the port's CUDA kernels (no counterpart in the JAX
package, whose kernels Pallas compiles inside ``jax.jit``).

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into one shared library
with a plain C interface, at first use, and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/<name>.so csrc/*.cu

The library name carries a hash of the sources and flags, so an edited
source never loads a stale build. The build directory is
``build/torch_kernels/`` beside the package. ``nvcc`` is taken from ``CUDA_HOME``/``CUDA_PATH``, then
``PATH``, then ``/usr/local/cuda``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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
#: Seconds the last build took and nvcc's report (registers, shared
#: memory and spills per kernel, from ``-Xptxas -v``); None when the
#: library was loaded from an earlier build.
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


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for source in _sources():
        digest.update(source.name.encode())
        digest.update(source.read_bytes())
    return BUILD_DIR / f"cip_torch_kernels_{digest.hexdigest()[:16]}.so"


def _declare(lib) -> None:
    c_int, c_i64, c_float, ptr = (
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.c_void_p,
    )
    lib.cip_grid_planes.argtypes = [ptr] * 9 + [c_int, ptr, c_int, ptr] + [
        c_int, c_int, c_int, c_int,
        c_float, c_float, c_float,
        c_int, c_i64, c_i64, ptr,
    ]
    lib.cip_grid_planes.restype = c_int
    lib.cip_fft_first_axis_fused.argtypes = [ptr] * 10 + [c_int] * 8 + [
        c_i64, ptr,
    ]
    lib.cip_fft_first_axis_fused.restype = c_int


def load_library():
    """Build the kernels if needed and return the loaded library."""
    global _library, build_seconds, build_log
    with _lock:
        if _library is not None:
            return _library
        target = library_path()
        if not target.is_file():
            target.parent.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
            cmd += [str(s) for s in _sources()]
            start = time.perf_counter()
            proc = subprocess.run(
                cmd, capture_output=True, text=True, check=False
            )
            build_seconds = time.perf_counter() - start
            build_log = proc.stdout + proc.stderr
            (target.parent / "build.log").write_text(
                " ".join(cmd) + "\n" + build_log
            )
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{build_log}"
                )
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
        _declare(lib)
        _library = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
