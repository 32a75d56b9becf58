"""
Kernel B2 (``csrc/fft_fused.cu``) in two checkouts on the card: its
compiled code, its outputs and its times.

    python -m ska_sdp_cip_tpu_torch.probes.b2_compare A B

* ``sass_differing_lines``: each checkout's ``fft_fused.cu`` compiled
  to a cubin with B2's target and optimisation flags and disassembled
  (``cuobjdump -sass``); the instruction lines that differ once kernel
  names, offsets and encodings are set aside (0: the same code).
* ``probe_sass_equal``: for A, whether each of B2's kernels that P2
  launches from ``csrc/fft_probes.cu`` compiles there to the
  instructions it compiles to in ``fft_fused.cu`` (null when A's probes
  launch none of them).
* ``runs``: :data:`TURNS` processes, the checkouts alternating which
  goes first (B, A, A, B, ...), each importing one checkout's package
  and running each of :data:`CASES` as ``chip_smoke.py``'s ``b2``
  phase does: B2 once (a checksum of its output's bits), its plain
  version once, then the mean of ``iters`` B2 calls between two CUDA
  events after a warm call. Both checkouts run this file's timing
  code, so they differ only in the package.
* ``medians``: each case's median time per checkout, and A / B.

Prints one JSON line. Needs a card, nvcc and cuobjdump. A change to B2
or to the code it shares with its probes (``csrc/fft_stages.cuh``)
should read 0 differing lines, or say what it changed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

#: Where a checkout keeps B2's and its probes' sources.
CSRC = Path("ska_sdp_cip_tpu_torch/csrc")

#: (n, pass, m, iters): the ``b2`` phase's cases at the production grid
#: (out-cropped to, or in-cropped from, 10240 rows) and the ``large``
#: phase's at 32768 (16384 rows).
CASES = tuple((15360, name, m, 10) for name in ("out_crop", "in_crop")
              for m in (15360, 10240)) + tuple(
    (32768, name, 32768, 5) for name in ("out_crop", "in_crop"))

#: Processes per comparison, half for each checkout.
TURNS = 6


def normalize_sass(text: str) -> list:
    """The instruction lines of ``cuobjdump -sass`` output, without the
    kernel names (they carry the file's name), offsets and encodings."""
    lines = []
    for line in text.splitlines():
        if "Function :" in line:
            continue
        line = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)
        line = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", line).strip()
        if line:
            lines.append(line)
    return lines


def plain_name(mangled: str) -> str:
    """A mangled kernel name without the identifiers nvcc gives an
    anonymous namespace (``<length>_INTERNAL...`` or
    ``<length>_GLOBAL__N...``: a hash and the file's name)."""
    out, i = [], 0
    for m in re.finditer(r"(?<![0-9])([0-9]+)(?=_INTERNAL|_GLOBAL__N)",
                         mangled):
        if m.start() >= i:
            out.append(mangled[i:m.start()])
            i = m.end() + int(m.group(1))
    return "".join(out) + mangled[i:]


def sass_functions(text: str) -> dict:
    """``cuobjdump -sass`` output by kernel: :func:`plain_name` ->
    :func:`normalize_sass` of its body."""
    bodies, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = plain_name(line.split("Function :", 1)[1].strip())
            bodies[name] = []
        elif name is not None:
            bodies[name].append(line)
    return {k: normalize_sass("\n".join(v)) for k, v in bodies.items()}


def differing_lines(a: list, b: list) -> int:
    """Lines that differ position by position, plus the length gap."""
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def turn_order(turns: int = TURNS) -> list:
    """Which checkout each turn runs: b, a, a, b, ..."""
    return [("b", "a", "a", "b")[k % 4] for k in range(turns)]


def disassemble(source: Path, cubin: Path) -> str:
    """``cuobjdump -sass`` of ``source`` compiled to ``cubin``."""
    from ska_sdp_cip_tpu_torch.ops import _build

    nvcc = Path(_build.find_nvcc())
    flags = [f for f in _build.NVCC_FLAGS if f not in
             ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([str(nvcc), *flags, "-cubin", "-o", str(cubin),
                    source.name], cwd=source.parent, check=True)
    return subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass",
                           str(cubin)], check=True, capture_output=True,
                          text=True).stdout


def checksum(pair) -> int:
    """An order-independent checksum of the bits of float32 tensors on
    the card: the sum, modulo 2^64, of each word times a weight from its
    index, in pieces of 2^26 words."""
    import torch

    total, piece = 0, 1 << 26
    for t in pair:
        bits = t.contiguous().view(-1).view(torch.int32)
        for k in range(0, bits.numel(), piece):
            x = bits[k:k + piece].to(torch.int64)
            idx = torch.arange(k, k + x.numel(), device=x.device,
                               dtype=torch.int64)
            total = (total * 1000003 + int(
                (x * (idx * 2654435761 % (1 << 31) + 1)).sum())) % (1 << 61)
    return total


def worker() -> dict:
    """One turn, in a process importing one checkout (``PYTHONPATH``)."""
    import torch

    from ska_sdp_cip_tpu_torch.ops import fft_cuda
    from ska_sdp_cip_tpu_torch.ops.fft import fft_plan_arrays, make_fft_plan
    from ska_sdp_cip_tpu_torch.ops.gridder import stage_arrays
    from ska_sdp_cip_tpu_torch.probes.common import cuda_ms

    dev = torch.device("cuda")
    out = {"times": {}, "checksums": {}}
    for n, name, m, iters in CASES:
        npix = 10240 if n == 15360 else n // 2
        plan = make_fft_plan(n, shifted=True)
        crop = ((n - npix) // 2, npix)
        if name == "out_crop":
            meta = fft_cuda.fused_pass_meta(plan, crop)
            sign, prefix, rows = +1, "fftp", n
        else:
            meta = fft_cuda.fused_pass_meta(plan, None, in_crop=crop)
            sign, prefix, rows = -1, "fftq", npix
        host = fft_plan_arrays(plan, prefix="fft")
        host.update(fft_cuda.fused_pass_kernel_arrays(plan, meta, sign=sign,
                                                      prefix=prefix))
        f = stage_arrays(host, dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        re_, im_ = (torch.randn((rows, m), generator=gen, device=dev)
                    for _ in range(2))

        def kernel():
            return fft_cuda.fft_first_axis_fused(re_, im_, f, meta=meta,
                                                 sign=sign, prefix=prefix)

        key = f"{name}_{n}_m{m}"
        out["checksums"][key] = checksum(kernel())
        fft_cuda.fft_first_axis_reference(re_, im_, f, meta=meta, sign=sign)
        out["times"][key] = cuda_ms(kernel, iters=iters)
        del re_, im_, f
        torch.cuda.empty_cache()
    return out


def compare(a: Path, b: Path) -> dict:
    trees = {"a": a, "b": b}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        fused = {side: disassemble(tree / CSRC / "fft_fused.cu",
                                   tmp / f"{side}.cubin")
                 for side, tree in trees.items()}
        probes = sass_functions(disassemble(a / CSRC / "fft_probes.cu",
                                            tmp / "probes.cubin"))
    b2 = sass_functions(fused["a"])
    shared = {name: probes[name] == body for name, body in b2.items()
              if name in probes}
    out = {"a": str(a), "b": str(b),
           "sass_lines": len(normalize_sass(fused["a"])),
           "sass_differing_lines": differing_lines(
               *(normalize_sass(fused[side]) for side in "ab")),
           "probe_sass_equal": shared or None, "runs": []}
    for side in turn_order():
        tree = trees[side]
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker"],
            cwd=tree, env={**os.environ, "PYTHONPATH": str(tree)},
            capture_output=True, text=True, timeout=900)
        if proc.returncode:
            raise RuntimeError(f"b2_compare turn in {tree} failed:\n"
                               f"{proc.stderr[-2000:]}")
        out["runs"].append({"side": side,
                            **json.loads(proc.stdout.splitlines()[-1])})
    out["checksums_equal"] = len({json.dumps(r["checksums"], sort_keys=True)
                                  for r in out["runs"]}) == 1
    out["medians"] = {}
    for case in out["runs"][0]["times"]:
        med = {side: statistics.median(r["times"][case] for r in out["runs"]
                                       if r["side"] == side)
               for side in "ab"}
        out["medians"][case] = {**med, "ratio": med["a"] / med["b"]}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("trees", nargs="*", metavar="A B",
                        help="the two checkouts")
    parser.add_argument("--worker", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        # Run as a file, the probes' own directory leads sys.path; the
        # turn imports only the checkout on PYTHONPATH.
        here = Path(__file__).resolve().parent
        sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
        print(json.dumps(worker()), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or len(args.trees) != 2:
        print("b2_compare needs a CUDA card and two checkouts "
              "(torch.cuda.is_available() is False, or not A B)",
              file=sys.stderr)
        return 2
    a, b = (Path(t).resolve() for t in args.trees)
    print(json.dumps(compare(a, b)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
