"""
Shared-memory probe (P3; counterpart ``scripts/vmem_probe.py``, which
found the largest usable VMEM scratch of a TPU core).

    python -m ska_sdp_cip_tpu_torch.probes.smem

The Hopper question: how much dynamic shared memory does one thread
block get? :func:`smem_probe` launches ``csrc/smem_probe.cu`` with N
bytes of it (after ``cudaFuncSetAttribute(...,
cudaFuncAttributeMaxDynamicSharedMemorySize, N)``); the kernel writes a
pattern into every word and reads it back through other threads.
:func:`run` bisects N from 48 KiB upward to the largest N that launches
and reads back the pattern (its plain version, :func:`expected`), and
holds it against the card's ``cudaDevAttrMaxSharedMemoryPerBlockOptin``
and torch's ``shared_memory_per_block_optin``. B1 and B3 keep 2G plane
windows of 48 x 128 float32 re/im in shared memory (96 KiB at G = 2),
so the maximum bounds the plane group G (ROADMAP A13).
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..ops import _build
from . import common

#: Launches of the probe kernel (refused launches are not counted).
LAUNCHES = 0

#: The bisection's lower end, which every CUDA card grants, and its
#: upper end, which no Hopper card grants (the SM has 256 KiB in all).
LOW_BYTES = 48 * 1024
HIGH_BYTES = 256 * 1024

#: CUDA errors that mean "refused": cudaErrorInvalidValue (the
#: attribute or the launch asked for too much) and
#: cudaErrorLaunchOutOfResources.
_REFUSED = (1, 701)


def _require_cuda(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            "the shared-memory probe needs a CUDA card "
            f"(device {device}, torch.cuda.is_available() is "
            f"{torch.cuda.is_available()})"
        )
    return device


def expected(words: int, device) -> torch.Tensor:
    """The pattern the kernel writes, as int32: i * 2654435761 + 12345
    modulo 2**32."""
    i = torch.arange(words, dtype=torch.int64, device=device)
    v = (i * 2654435761 + 12345) % 2**32
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def smem_probe(nbytes: int, device="cuda") -> torch.Tensor | None:
    """
    Launch the probe with ``nbytes`` of dynamic shared memory: the
    nbytes // 4 words it read back (int32), or None when the card
    refuses that size. Any other CUDA error raises.
    """
    global LAUNCHES
    device = _require_cuda(device)
    out = torch.empty(nbytes // 4, dtype=torch.int32, device=device)
    lib = _build.load_library()
    with torch.cuda.device(device):
        err = lib.cip_smem_probe(
            int(nbytes), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err in _REFUSED:
        return None
    _build.check(err, f"cip_smem_probe({nbytes})")
    LAUNCHES += 1
    return out


def optin_bytes(device="cuda") -> int:
    """cudaDevAttrMaxSharedMemoryPerBlockOptin of the card."""
    device = _require_cuda(device)
    value = ctypes.c_int(0)
    lib = _build.load_library()
    _build.check(lib.cip_smem_optin_bytes(int(device.index or 0),
                                          ctypes.byref(value)),
                 "cip_smem_optin_bytes")
    return int(value.value)


def _fits(nbytes: int, device) -> bool:
    got = smem_probe(nbytes, device)
    if got is None:
        return False
    torch.cuda.synchronize(device)
    if not torch.equal(got, expected(nbytes // 4, device)):
        raise common.ProbeError(f"{nbytes} bytes launched but read back "
                                "wrongly")
    return True


def run(ngrid=None, *, device="cuda", iters: int = 20) -> dict:
    """Bisect the largest dynamic shared memory per block (bytes);
    ``ngrid`` is accepted for the probes' common command line."""
    device = _require_cuda(device)
    if not _fits(LOW_BYTES, device):
        raise common.ProbeError(f"{LOW_BYTES} bytes refused")
    if _fits(HIGH_BYTES, device):
        raise common.ProbeError(f"{HIGH_BYTES} bytes granted")
    lo, hi = LOW_BYTES, HIGH_BYTES  # lo fits, hi does not
    tries = 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if _fits(mid, device) else (lo, mid)
        tries += 1
    # The read-back at the maximum, against the plain pattern.
    got, want = smem_probe(lo, device), expected(lo // 4, device)
    if got is None:
        raise common.ProbeError(f"{lo} bytes refused on the second launch")
    attr = optin_bytes(device)
    props = torch.cuda.get_device_properties(device)
    out = {
        "probe": "smem",
        "device": common.device_name(device),
        "max_bytes": lo,
        "max_kib": lo / 1024,
        "read_back_exact": bool(torch.equal(got, want)),
        "max_abs_err": int((got.long() - want.long()).abs().max()),
        "launches_tried": tries,
        "optin_attribute_bytes": attr,
        "torch_optin_bytes": getattr(props, "shared_memory_per_block_optin",
                                     None),
        "plane_group_bound": lo // (2 * 48 * 128 * 4),
        "ms": common.median_ms(lambda: smem_probe(lo, device), device,
                               runs=iters),
        "plain_ms": common.median_ms(lambda: expected(lo // 4, device),
                                     device, runs=iters),
    }
    out["matches_attribute"] = lo == attr and out["torch_optin_bytes"] in (
        None, attr)
    if not (out["read_back_exact"] and out["matches_attribute"]):
        raise common.ProbeError(f"smem read-back or maximum wrong: {out}")
    return out


if __name__ == "__main__":
    sys.exit(common.main(run))
