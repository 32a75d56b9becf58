"""
A benchmark cell on N > 1 cards: N rank processes, one per card, started
by ``python3 -m cipbench.run`` for a cell whose ``chips`` is N. A cell on
one card never comes here: it runs ``run.run_cell`` in the one process.

**Launch.** The launcher (the process ``cipbench.run`` started) keeps the
harness's own ``torch.distributed.TCPStore`` on a free loopback port and
starts rank r as ``python3 -m cipbench.ranks`` in a session of its own,
with the environment ``torchrun`` gives a rank (``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` 127.0.0.1 and
``MASTER_PORT`` on another free port; not torchrun's
``OMP_NUM_THREADS=1``). The program joins its own world through its
``initialize_distributed`` (``env://``) in the driver's set-up; the
harness neither creates nor shapes that world, and its store carries
only the harness's own messages. Rank r makes the current card
``cuda:LOCAL_RANK``, resets its peak there, imports the cell's driver,
joins the store, and calls ``driver.setup(config, traffic, seed,
cuda:LOCAL_RANK)``.

**One window.** Every rank posts that its set-up is done; once all have,
the launcher reads ``setup_s`` (its own process start to that moment) and
lets them start together. After each call every rank synchronizes its
card and counts itself in; the call's time runs until the last has. Rank
0 then decides whether the window goes on, and the others follow it, so
every rank makes the same number of calls (an uneven count would hang
the program's collectives).

**Checks.** Every rank calls ``state.check(limits)``; rank 0 takes the
largest value of each check over the ranks and sums ``failed``. A driver
may check on rank 0 alone and return no checks on the others.

**What is printed.** Rank 0 alone prints the JSON line, on the standard
output it shares with the launcher, and only once every other rank has
ended with code 0 (their own standard output goes to the standard
error). Its metrics read rank 0's calls, spans, work bounds and trace;
``device`` gives ``count``, the distinct cards with an allocation,
``memory_peak_bytes``, the fullest card's peak (``peak_gib`` reads it),
with ``memory_peak_bytes_by_device`` beside it, and in a traced run
``busy_s``, the mean of the cards' busy seconds (each rank profiles its
own process, and so its own card), with ``busy_s_by_device`` beside it,
and ``window_s``, rank 0's traced window.

**Failure.** The run ends with a code other than 0 and prints no line
when a rank raises, dies or ends before its report; when a rank has not
joined the store ``LIMIT_S`` seconds after the launch, or has not ended
its set-up ``LIMIT_S`` seconds after the first rank did; when a call
has not ended on every rank ``LIMIT_S`` seconds after the last one did;
when, after the window, no rank has reported for ``AFTER_S`` seconds
(reading a traced window's events alone takes minutes); when a rank's
card shows no allocation, the ranks name different cards, share one,
or made different numbers of calls; and when a rank loaded JAX or the
JAX package. The launcher then ends
every rank's session (SIGTERM, SIGKILL after ``GRACE_S``), and a rank
whose launcher has gone ends itself.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from datetime import timedelta  # noqa: E402
from pathlib import Path  # noqa: E402

from . import run  # noqa: E402

#: Seconds the launcher waits for a rank to join, for the last rank's
#: set-up after the first rank's, and for a call to end on every rank;
#: the program's own ``parallel/mesh.py:TIMEOUT_S``.
LIMIT_S = 300.0
#: Seconds, after the window, that the launcher and the ranks wait for a
#: rank's report: the longest a checkout's first run may take.
AFTER_S = 1200.0
#: Seconds between SIGTERM and SIGKILL to a rank's session.
GRACE_S = 10.0
HOST = "127.0.0.1"


class RankError(RuntimeError):
    """The ranks' reports cannot make one result."""


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind((HOST, 0))
        return sock.getsockname()[1]


def merge(reports: list, traced: bool) -> tuple:
    """(checks, failed, device) of the ranks' reports, in rank order;
    raises RankError where they do not make one run."""
    calls = [r["calls"] for r in reports]
    if len(set(calls)) != 1:
        raise RankError(f"the ranks made different numbers of calls: "
                        f"{calls}")
    banned = sorted({m for r in reports for m in r["banned"]})
    if banned:
        raise RankError(f"loaded in a rank: {', '.join(banned)}")
    checks = {}
    for rep in reports:
        for name, (value, limit) in rep["checks"].items():
            if name in checks:
                if checks[name][1] != limit:
                    raise RankError(f"check {name}: the ranks' limits differ")
                value = max(value, checks[name][0])
            checks[name] = (value, limit)
    failed = sum(r["failed"] for r in reports)
    kinds = sorted({r["kind"] for r in reports})
    if len(kinds) != 1:
        raise RankError(f"the ranks name different cards: {kinds}")
    if kinds == ["cpu"]:
        return checks, failed, {"platform": "cpu", "kind": "cpu", "count": 0}
    unused = [r["rank"] for r in reports if not r["peak_bytes"]]
    if unused:
        raise RankError(f"no allocation on the card of rank(s) {unused}")
    cards = {r["card"] for r in reports}
    if len(cards) != len(reports):
        raise RankError(
            f"the ranks share cards: {[r['card'] for r in reports]}")
    peaks = [r["peak_bytes"] for r in reports]
    device = {"platform": "gpu", "kind": kinds[0], "count": len(cards),
              "memory_peak_bytes": max(peaks),
              "memory_peak_bytes_by_device": peaks}
    if traced:
        busy = [r["busy_s"] for r in reports]
        idle = [r["rank"] for r in reports if r["busy_s"] is None]
        if idle:
            raise RankError(f"no device operation in the traced window of "
                            f"rank(s) {idle}")
        device.update(busy_s=sum(busy) / len(busy), busy_s_by_device=busy,
                      window_s=reports[0]["window_s"])
    return checks, failed, device


# ---- the launcher ---------------------------------------------------------


def launch(root: Path, workload: str, seed: int, seconds: float, trace: bool,
           chips: int, *, t_start: float, device: str = "cuda",
           limit_s: float = LIMIT_S) -> int:
    """Runs the cell as ``chips`` ranks and returns the exit code: rank
    0's where every rank ended with 0, else 3."""
    from torch.distributed import TCPStore

    store_port, master_port = free_port(), free_port()
    store = TCPStore(HOST, store_port, is_master=True, wait_for_workers=False,
                     timeout=timedelta(seconds=limit_s))
    env = dict(os.environ, WORLD_SIZE=str(chips), LOCAL_WORLD_SIZE=str(chips),
               MASTER_ADDR=HOST, MASTER_PORT=str(master_port))
    argv = [sys.executable, "-m", "cipbench.ranks", "--workload", workload,
            "--seed", str(seed), "--seconds", repr(seconds), "--trace",
            str(int(trace)), "--device", device, "--store-port",
            str(store_port), "--limit", repr(limit_s), "--launcher",
            str(os.getpid())]
    procs = []
    previous = signal.signal(signal.SIGTERM, _exit_on_signal)
    try:
        for r in range(chips):
            procs.append(subprocess.Popen(
                argv, cwd=root, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=None if r == 0 else 2,
                start_new_session=True))
        reason = _watch(store, procs, t_start, limit_s)
    finally:
        found = time.monotonic()
        _end(procs)
        signal.signal(signal.SIGTERM, previous)
    if reason is not None:
        print(f"ranks: {reason}; every rank ended "
              f"{time.monotonic() - found:.2f} s later, with codes "
              f"{[p.returncode for p in procs]}", file=sys.stderr, flush=True)
        return 3
    return 0


def _exit_on_signal(signum, frame):
    raise SystemExit(128 + signum)


def _watch(store, procs: list, t_start: float, limit_s: float) -> str | None:
    """Follows the ranks to their end: None where all ended with 0 after
    rank 0 printed, else why the run failed."""
    n = len(procs)
    joined = [f"joined/{r}" for r in range(n)]
    ready = [f"ready/{r}" for r in range(n)]
    launched = time.monotonic()
    first_ready = moved = None
    progress, done = -1, False
    while True:
        now = time.monotonic()
        for r, proc in enumerate(procs):
            code = proc.poll()
            if code is not None and code != 0:
                return f"rank {r} ended with code {code}"
            if code == 0 and not store.check([f"report/{r}"]):
                return f"rank {r} ended before its report"
        if all(p.returncode == 0 for p in procs):
            return None
        if moved is None:          # before the window
            if not store.check(joined):
                if now - launched > limit_s:
                    return (f"rank(s) {_missing(store, joined)} did not join "
                            f"within {limit_s} s")
            elif store.check(ready):
                store.set("go", repr(time.perf_counter() - t_start))
                moved = now
            elif first_ready is None:
                if any(store.check([k]) for k in ready):
                    first_ready = now
            elif now - first_ready > limit_s:
                return (f"rank(s) {_missing(store, ready)} did not end set-up "
                        f"within {limit_s} s of the first")
        else:
            count = store.add("progress", 0)
            if count != progress:
                progress, moved = count, now
            elif not store.check(["closed"]) and now - moved > limit_s:
                return f"a call did not end within {limit_s} s"
            elif now - moved > AFTER_S:
                return f"no rank reported for {AFTER_S} s after the window"
            if not done and all(p.returncode == 0 for p in procs[1:]):
                store.set("others_done", "")
                done = True
        time.sleep(0.05)


def _missing(store, keys: list) -> list:
    return [int(k.split("/")[1]) for k in keys if not store.check([k])]


def _end(procs: list) -> None:
    """Ends the session (the rank and whatever it started) of each rank
    that runs or failed, SIGTERM first and SIGKILL to what is left after
    ``GRACE_S``, and waits for the ranks."""
    procs = [p for p in procs if p.poll() is None or p.returncode != 0]
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for proc in procs:
            try:
                os.killpg(proc.pid, sig)
            except (ProcessLookupError, PermissionError):
                pass
        deadline = time.monotonic() + GRACE_S
        for proc in procs:
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        if all(p.poll() is not None for p in procs):
            return


# ---- a rank ---------------------------------------------------------------


def _follow_launcher(pid: int) -> None:
    """Ends this rank when its launcher has gone."""
    def watch():
        while os.getppid() == pid:
            time.sleep(0.5)
        os._exit(4)

    threading.Thread(target=watch, daemon=True).start()


def rank_cell(cell: run.Cell, driver, store, rank: int, world: int,
              seed: int, seconds: float, trace: bool, device) -> dict | None:
    """One rank's set-up, window, check and report; on rank 0 the result
    line, once every rank has reported."""
    import torch

    from . import trace as tracing

    cuda = device.type == "cuda"
    t_setup = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
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
        store.set(f"ready/{rank}", "")
        setup_s = float(store.get("go"))
        t0 = time.perf_counter()
        with torch.profiler.record_function(tracing.PREFIX + "window"):
            k = 0
            while True:
                t = time.perf_counter()
                for key, v in state.call().items():
                    bounds[key] = bounds.get(key, 0.0) + v
                if cuda:
                    torch.cuda.synchronize()
                if store.add(f"done/{k}", 1) == world:
                    store.set(f"all/{k}", "")
                if rank == 0:
                    store.wait([f"all/{k}"])
                    now = time.perf_counter()
                    stop = now - t0 >= seconds
                    if stop:
                        store.set("closed", "")
                    store.set(f"next/{k}", "0" if stop else "1")
                    store.add("progress", 1)
                else:
                    stop = store.get(f"next/{k}") == b"0"
                    now = time.perf_counter()
                calls.append(now - t)
                k += 1
                if stop:
                    break
            if cuda:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    store.set_timeout(timedelta(seconds=AFTER_S))
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else None
    state.release()
    traced = tracing.read_trace(prof) if prof is not None else None
    del prof
    checks, failed = state.check(cell.limits)
    state.close()
    props = torch.cuda.get_device_properties(device) if cuda else None
    report = {
        "rank": rank, "calls": len(calls), "failed": failed,
        "checks": {k: [v, lim] for k, (v, lim) in checks.items()},
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "card": str(getattr(props, "uuid", device.index)) if cuda else None,
        "peak_bytes": peak,
        "busy_s": traced.busy_s() if traced is not None else None,
        "window_s": traced.window_s if traced is not None else None,
        "banned": run.banned_modules(),
    }
    store.set(f"report/{rank}", json.dumps(report))
    store.add("progress", 1)
    if rank != 0:
        return None

    reports = [json.loads(store.get(f"report/{r}")) for r in range(world)]
    checks, failed, info = merge(reports, trace)
    result_run = run.Run(unit=driver.UNIT, setup_s=setup_s, window_s=window_s,
                         calls=calls, bounds=bounds,
                         peak_bytes=info.get("memory_peak_bytes"),
                         spans=dict(spans.seconds), trace=traced)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = cell.readers[m["name"]].read(result_run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": info}
    result["setup_split"] = split
    result["call_s"] = run.call_quartiles(calls)
    if trace and traced is not None:
        result["breakdown"] = {"device_ops": traced.device_ops(),
                               "idle_gaps": traced.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of a cell on N cards")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    ap.add_argument("--store-port", type=int, required=True)
    ap.add_argument("--limit", type=float, required=True)
    ap.add_argument("--launcher", type=int, required=True)
    args = ap.parse_args(argv)
    _follow_launcher(args.launcher)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])

    root = Path.cwd()
    run.cache_env(root)
    cell = run.load_cell(root, args.workload)
    import torch
    from torch.distributed import TCPStore

    if args.device == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
        print(f"rank {rank}: {torch.cuda.get_device_name(device)}",
              file=sys.stderr, flush=True)
    else:
        device = torch.device("cpu")
    driver = importlib.import_module(
        f"cipbench.drivers.{cell.traffic['operation']}")
    store = TCPStore(HOST, args.store_port, is_master=False,
                     timeout=timedelta(seconds=args.limit))
    store.set(f"joined/{rank}", "")
    result = rank_cell(cell, driver, store, rank, world, args.seed,
                       args.seconds, bool(args.trace), device)
    if result is None:
        return 0
    store.wait(["others_done"])
    found = run.banned_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():    # the last lines on stderr
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except RankError as err:
        print(f"ranks: {err}", file=sys.stderr, flush=True)
        sys.exit(3)
