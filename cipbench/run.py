"""
One run of one benchmark cell of ``ska_sdp_cip_tpu_torch``, on the cards
its ``chips`` names.

    python3 -m cipbench.run --workload csd3-10k.snapshot --seed 7 --seconds 40 --trace 0

from the root of a checkout. The cell, its configuration and its traffic
are found by name: ``BENCHMARK.json``'s ``workloads`` entry names the
configuration (``configs/<config>.json``) and the traffic
(``traffic/<traffic>.json``), whose ``operation`` names the driver
(``drivers/<operation>.py``); the metrics the cell reports are
``BENCHMARK.json``'s, each read by ``metrics/<name>.py``, and the
check's limits are ``limits/<workload>.json``.

The run makes its data from the seed, sets up and warms the program on
the cell's own shapes (``setup_s``), then calls the program in a closed
loop for ``--seconds`` (one call after another, each synchronized),
checks what the window produced against the plain reference, and prints
one JSON line: the end-to-end metrics with ``--trace 0``, the per-layer
ones with ``--trace 1`` (host spans around the program's functions and a
``torch.profiler`` session over the window). It refuses to run without
the cards the cell asks for, and fails if JAX or the JAX package was
loaded.

A cell of one chip runs in this one process, on ``cuda:0``, which prints
the line. A cell of N > 1 chips runs as N rank processes, rank r on
``cuda:r``, each with the environment ``torchrun`` would give it, and
rank 0 prints the line (``ranks.py`` says how the ranks share one window,
merge their checks and report the cards they used).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: Top-level module names that may not be loaded in a run.
BANNED = ("jax", "jaxlib", "flax", "ska_sdp_cip_tpu")


def cache_env(root: Path) -> None:
    """Fixed cache folders inside the checkout; the program's nvcc and
    C++ builds already go to ``build/torch_kernels`` and
    ``build/torch_native``."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" /
                                             "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def banned_modules(names=None) -> list:
    """Banned top-level names among ``names`` (the loaded modules)."""
    names = list(sys.modules if names is None else names)
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"cipbench_file_{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """A workload entry with everything found by its names."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    readers: dict = field(default_factory=dict)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    here = root / "cipbench"
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{entry['traffic']}.json")
                         .read_text())
    limits = json.loads((here / "limits" / f"{workload}.json").read_text())
    cell = Cell(
        name=workload, config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )
    for m in cell.end_to_end + cell.per_layer:
        cell.readers[m["name"]] = load_module(here / "metrics" /
                                              f"{m['name']}.py")
    return cell


@dataclass
class Run:
    """What a metric reader reads."""

    unit: str
    setup_s: float
    window_s: float
    calls: list
    #: Least seconds of the window's work, by layer (``work.py``).
    bounds: dict
    peak_bytes: int | None = None
    spans: dict = field(default_factory=dict)
    trace: object = None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             *, control: bool = False, log=sys.stderr) -> dict:
    """Set up, run the window, check, and return the result line."""
    import torch

    from . import trace as tracing

    cuda = device.type == "cuda"
    driver = importlib.import_module(
        f"cipbench.drivers.{cell.traffic['operation']}")
    t_setup = time.perf_counter()
    state = driver.setup(cell.config, cell.traffic, seed, device)
    split = {"imports": t_setup - T_START, **state.setup_split}
    targets = {}
    if trace:
        for reader in cell.readers.values():
            targets.update(getattr(reader, "SPANS", {}))
    calls, bounds = [], {}
    with tracing.Spans(targets, sync=cuda) as spans, \
            tracing.profiled(trace and cuda) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        setup_s = t0 - T_START
        with torch.profiler.record_function(tracing.PREFIX + "window"):
            while True:
                t = time.perf_counter()
                for k, v in state.call().items():
                    bounds[k] = bounds.get(k, 0.0) + v
                now = time.perf_counter()
                calls.append(now - t)
                if now - t0 >= seconds:
                    break
            if cuda:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    run = Run(unit=driver.UNIT, setup_s=setup_s, window_s=window_s,
              calls=calls, bounds=bounds, spans=dict(spans.seconds))
    if cuda:
        run.peak_bytes = int(torch.cuda.max_memory_allocated())
    state.release()
    if prof is not None:
        run.trace = tracing.read_trace(prof)
        del prof
    checks, failed = state.check(cell.limits, control=control)
    state.close()

    metrics = {}
    chosen = cell.per_layer if trace else cell.end_to_end
    for m in chosen:
        value = cell.readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": device_info(device, run)}
    result["setup_split"] = split
    result["call_s"] = call_quartiles(calls)
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=log)
    return result


def call_quartiles(calls: list) -> list:
    """Min, quartiles and max of the window's calls, in seconds."""
    import statistics

    if len(calls) < 2:
        return [calls[0]] * 5
    q = statistics.quantiles(calls, n=4, method="inclusive")
    return [min(calls), *q, max(calls)]


def device_info(device, run: Run) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1, "memory_peak_bytes": run.peak_bytes}
    if run.trace is not None:
        out["busy_s"] = run.trace.busy_s()
        out["window_s"] = run.trace.window_s
    return out


def power_line() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return proc.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return f"nvidia-smi: {err!r}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_env(ROOT)
    cell = load_cell(ROOT, args.workload)
    chips = next(w["chips"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]
        if w["name"] == args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if chips > 1:
        from . import ranks

        print(f"cards: {chips} of {torch.cuda.device_count()}; "
              f"{power_line()}", file=sys.stderr, flush=True)
        return ranks.launch(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), chips, t_start=T_START)
    device = torch.device("cuda", 0)
    print(f"card: {torch.cuda.get_device_name(device)}; {power_line()}",
          file=sys.stderr, flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    found = banned_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
