"""
Tiled-input probe of the fused first-axis pass: B2 on input re-laid by
B6 against B2 on row-major input (counterpart
``scripts/fft_tiled_probe.py``).

    python -m ska_sdp_cip_tpu_torch.probes.fft_tiled [ngrid]

At ``ngrid`` (default 15360, cropped to 10240 rows) it times (the
median of ``iters`` CUDA-event runs) the baseline pass, pretile alone, the pass on tiled input, and
pretile + tiled pass, and their plain versions; checks that pretile
equals its plain version and the tiled pass the baseline pass exactly
(and its plain version to 1e-5 of max); and prints one JSON line.

The counterpart asked whether B2's strided input fetch (n1 * C rows of
512 bytes per block on the TPU) bounds the pass. On Hopper it is a
coalescing question: B2's stage-1 loads are 64-column row segments
(256 contiguous bytes per warp-wide load) in both layouts, so the
tiled layout changes which rows lie next to each other, not the width
of a load.
"""

from __future__ import annotations

import sys

from ..ops.fft_cuda import (
    fft_first_axis_fused,
    fft_first_axis_tiled_reference,
    pretile_first_axis,
    pretile_first_axis_reference,
)
from . import common


def run(ngrid: int = common.PRODUCTION_NGRID, *, device="cuda",
        iters: int = 5) -> dict:
    s = common.out_crop_pass(ngrid, device)
    device, meta, f = s.re.device, s.meta, s.f

    def baseline():
        return fft_first_axis_fused(s.re, s.im, f, meta=meta, sign=+1)

    def pretile():
        return pretile_first_axis(s.re, s.im, meta=meta)

    def pretile_plain():
        return pretile_first_axis_reference(s.re, s.im, meta=meta)

    tiles = pretile()

    def tiled():
        return fft_first_axis_fused(*tiles, f, meta=meta, sign=+1,
                                    tiled=True)

    def tiled_plain():
        return fft_first_axis_tiled_reference(*tiles, f, meta=meta, sign=+1)

    def combined():
        return fft_first_axis_fused(*pretile(), f, meta=meta, sign=+1,
                                    tiled=True)

    out = {"probe": "fft_tiled", "ngrid": s.n, "device":
           common.device_name(device), **common.geometry(meta)}
    plain_tiles = pretile_plain()
    out["pretile_exact"] = common.all_equal(tiles, plain_tiles)
    out["pretile_max_abs_err"] = common.max_err(tiles, plain_tiles)[0]
    del plain_tiles
    got = tiled()
    out["tiled_exact"] = common.all_equal(got, baseline())
    err, rel = common.max_err(got, tiled_plain())
    out["tiled_max_abs_err"], out["tiled_max_rel_err"] = err, rel
    del got
    if not (out["pretile_exact"] and out["tiled_exact"]
            and rel <= common.KERNEL_RTOL):
        raise common.ProbeError(f"fft_tiled checks failed: {out}")
    for name, fn in (("baseline", baseline), ("pretile", pretile),
                     ("tiled", tiled), ("combined", combined),
                     ("pretile_plain", pretile_plain),
                     ("tiled_plain", tiled_plain)):
        out[f"{name}_ms"] = common.median_ms(fn, device, runs=iters)
    return out


if __name__ == "__main__":
    sys.exit(common.main(run))
