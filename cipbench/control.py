"""
The readings that a cell's limits are set from: for each seed, one short
window of the program at the cell's own size, the check's numbers of what
it produced (the lower readings), and the same numbers of the check's
control: the plain reference put in the program's place and computed in
bfloat16, the precision below the configuration's float32 (the upper
readings). Not part of a benchmark run.

    python3 -m cipbench.control --workload csd3-10k.cycle --seconds 5 --seeds 11 12 13

prints one JSON line a seed to standard output.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from .run import ROOT, cache_env, load_cell


def readings(cell, seed: int, seconds: float, device) -> dict:
    import torch

    driver = importlib.import_module(
        f"cipbench.drivers.{cell.traffic['operation']}")
    t0 = time.perf_counter()
    state = driver.setup(cell.config, cell.traffic, seed, device)
    t1 = time.perf_counter()
    calls = 0
    while time.perf_counter() - t1 < seconds:
        state.call()
        calls += 1
    if device.type == "cuda":
        torch.cuda.synchronize()
    state.release()
    t2 = time.perf_counter()
    program, failed = state.check(cell.limits)
    t3 = time.perf_counter()
    control, _ = state.check(cell.limits, control=True)
    state.close()
    return {"workload": cell.name, "seed": seed, "calls": calls,
            "failed": failed, "setup_s": t1 - t0, "check_s": t3 - t2,
            "program": {k: v for k, (v, _) in program.items()},
            "control": {k: v for k, (v, _) in control.items()},
            "limits": cell.limits}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cache_env(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(ROOT, args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds, device)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
