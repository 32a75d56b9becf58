"""The launcher of a cell on N > 1 cards (``ranks.py``), driven on the CPU
with two ranks over gloo past the look for cards, with a toy driver that
does one ``all_reduce`` a call through the program's own
``initialize_distributed``: one window with the same number of calls on
each rank, one line printed by rank 0, checks merged as the largest
value; a rank that raises, dies, does not join, hangs in its set-up
or in a call fails the run fast, with no line and no process left, and
so does a launcher that is ended; a check may outlast the limit of a
call. The merge of the ranks' card reports
is held on injected reports (a CPU run measures no card), and a cell of
one chip runs none of this."""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from cipbench import ranks, run

from .conftest import ROOT

CELL = "toy.ranks"
TOY_DRIVER = '''
import os
import signal
import time
from pathlib import Path

import torch
import torch.distributed as dist

from ska_sdp_cip_tpu_torch.parallel.mesh import (
    initialize_distributed,
    shutdown_distributed,
)

UNIT = "toy"
RANK = int(os.environ["RANK"])
if os.environ.get("TOY_HANG_RANK") == str(RANK):
    time.sleep(600)


class Cell:
    def __init__(self, cfg, traffic, seed, device):
        self.traffic = traffic
        self.setup_split = {}
        self._fault("setup")
        initialize_distributed()
        self.world = dist.get_world_size()
        self.calls = 0
        self._fault("setup_end")

    def _fault(self, at):
        if self.traffic["fault_at"] == at and RANK == 1:
            if self.traffic["fault"] == "dies":
                os.kill(os.getpid(), signal.SIGKILL)
            if self.traffic["fault"] == "hangs":
                time.sleep(600)
            raise RuntimeError(f"toy fault at {at}")

    def call(self):
        self.calls += 1
        self._fault(self.calls)
        x = torch.full((4,), float(RANK + 1))
        dist.all_reduce(x)
        self.total = float(x[0])
        time.sleep(0.02)
        return {}

    def release(self):
        pass

    def check(self, limits, control=False):
        time.sleep(self.traffic.get("check_sleep", 0))
        right = self.total == self.world * (self.world + 1) / 2
        err = 0.001 * (RANK + 1) if right else 1.0
        return {"toy_err": (err, limits["toy_err"])}, 0

    def close(self):
        Path(self.traffic["out"], f"calls_{RANK}").write_text(str(self.calls))
        shutdown_distributed()


def setup(cfg, traffic, seed, device):
    return Cell(cfg, traffic, seed, device)
'''


@pytest.fixture
def toy_root(tiny_root, monkeypatch) -> Path:
    """The tiny checkout with a two-chip cell of the toy driver."""
    here = tiny_root / "cipbench"
    (here / "drivers" / "toy.py").write_text(TOY_DRIVER)
    (here / "configs" / "toy.json").write_text(json.dumps({"name": "toy"}))
    (here / "limits" / f"{CELL}.json").write_text(
        json.dumps({"toy_err": 0.01}))
    (here / "metrics" / "toy_call_s.py").write_text(
        "def read(run):\n    return run.window_s / len(run.calls)\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "test",
                             "file": "cipbench/configs/toy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "toy",
                               "traffic": "toy", "chips": 2, "why": "test"})
    bench["end_to_end"].append({"name": "toy_call_s", "unit": "s",
                                "better": "lower", "bound": 0.1,
                                "source": "host_clock", "workloads": [CELL]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    (tiny_root / "out").mkdir()
    toy_traffic(tiny_root)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return tiny_root


def toy_traffic(root: Path, fault: str | None = None, at=None,
                **more) -> None:
    (root / "cipbench" / "traffic" / "toy.json").write_text(json.dumps(
        {"operation": "toy", "fault": fault, "fault_at": at,
         "out": str(root / "out"), **more}))


def launch(root: Path, limit_s: float = 60.0) -> tuple:
    """(exit code, seconds) of a two-rank CPU run of the toy cell."""
    t0 = time.monotonic()
    code = ranks.launch(root, CELL, 2**31 + 17, 0.5, False, 2,
                        t_start=time.perf_counter(), device="cpu",
                        limit_s=limit_s)
    return code, time.monotonic() - t0


def ranks_left(launcher: int | None = None) -> list:
    """Processes of the ranks of a launcher (this test's process) still
    alive."""
    mark = f"--launcher\0{launcher or os.getpid()}\0"
    left = []
    for proc in Path("/proc").iterdir():
        try:
            cmd = (proc / "cmdline").read_bytes().decode()
        except OSError:
            continue
        if "cipbench.ranks" in cmd and mark in cmd:
            left.append(proc.name)
    return left


def test_two_ranks_one_window_one_line(toy_root, capfd):
    code, _ = launch(toy_root)
    out, err = capfd.readouterr()
    assert code == 0
    (text,) = out.strip().splitlines()
    assert err.strip().splitlines()[-1] == "check toy_err 0.002 limit 0.01"
    line = json.loads(text)
    assert line["correct"] is True and line["failed"] == 0
    counts = {int((toy_root / "out" / f"calls_{r}").read_text())
              for r in range(2)}
    assert counts == {line["attempted"]} and line["attempted"] >= 2
    assert line["checks"] == {"toy_err": {"value": 0.002, "limit": 0.01}}
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 0}
    assert set(line["metrics"]) == {"setup_s", "toy_call_s"}
    assert line["metrics"]["setup_s"]["value"] > 0
    assert list(line)[-1] == "checks"
    assert ranks_left() == []


def test_a_check_may_outlast_the_limit_of_a_call(toy_root, capfd):
    # After the window a rank may read its trace and check for minutes.
    toy_traffic(toy_root, check_sleep=12)
    code, seconds = launch(toy_root, limit_s=8.0)
    assert code == 0 and seconds > 12
    assert json.loads(capfd.readouterr().out)["correct"] is True


@pytest.mark.parametrize("fault,at", [("raises", "setup"), ("raises", 3),
                                      ("dies", 3)])
def test_a_failed_rank_fails_the_run(toy_root, capfd, fault, at):
    toy_traffic(toy_root, fault, at)
    code, seconds = launch(toy_root)
    captured = capfd.readouterr()
    assert code != 0 and captured.out == ""
    assert seconds < 45, seconds
    assert "rank 1 ended with code" in captured.err
    assert ranks_left() == []


def test_a_rank_that_does_not_join_fails_the_run(toy_root, capfd,
                                                 monkeypatch):
    monkeypatch.setenv("TOY_HANG_RANK", "1")
    code, seconds = launch(toy_root, limit_s=8.0)
    captured = capfd.readouterr()
    assert code != 0 and captured.out == ""
    assert "rank(s) [1] did not join within 8.0 s" in captured.err
    assert seconds < 45, seconds
    assert ranks_left() == []


@pytest.mark.parametrize("signum", [signal.SIGTERM, signal.SIGKILL],
                         ids=["SIGTERM", "SIGKILL"])
def test_an_ended_launcher_leaves_no_rank(toy_root, signum):
    code = ("import sys, time; from pathlib import Path;"
            "from cipbench import ranks;"
            f"sys.exit(ranks.launch(Path({str(toy_root)!r}), {CELL!r}, 3,"
            " 600.0, False, 2, t_start=time.perf_counter(), device='cpu'))")
    launcher = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 60
        while len(ranks_left(launcher.pid)) < 2:
            assert time.monotonic() < deadline, "the ranks never started"
            time.sleep(0.2)
        time.sleep(2.0)
        launcher.send_signal(signum)
        assert launcher.wait(timeout=30) != 0
        deadline = time.monotonic() + 20
        while ranks_left(launcher.pid):
            assert time.monotonic() < deadline, ranks_left(launcher.pid)
            time.sleep(0.2)
    finally:
        launcher.kill()
        launcher.wait()


@pytest.mark.parametrize("at,message", [
    ("setup_end", "rank(s) [1] did not end set-up within 8.0 s of the first"),
    (3, "a call did not end within 8.0 s")])
def test_a_rank_that_hangs_fails_the_run(toy_root, capfd, at, message):
    toy_traffic(toy_root, "hangs", at)
    code, seconds = launch(toy_root, limit_s=8.0)
    captured = capfd.readouterr()
    assert code != 0 and captured.out == ""
    assert message in captured.err
    assert seconds < 45, seconds
    assert ranks_left() == []


def _report(rank: int, **kw) -> dict:
    out = {"rank": rank, "calls": 7, "failed": 0,
           "checks": {"img_err": [1e-6 * (rank + 1), 1e-4]},
           "kind": "NVIDIA H100 80GB HBM3", "card": f"GPU-{rank}",
           "peak_bytes": 2**30 * (rank + 1), "busy_s": 10.0 + rank,
           "window_s": 51.0 + rank, "banned": []}
    out.update(kw)
    return out


def test_merge_takes_the_fullest_card_and_the_largest_check():
    reports = [_report(r) for r in range(4)]
    reports[2]["checks"]["img_err"][0] = 5e-5
    reports[1]["failed"] = 2
    checks, failed, device = ranks.merge(reports, traced=True)
    assert checks == {"img_err": (5e-5, 1e-4)} and failed == 2
    assert device == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4,
        "memory_peak_bytes": 4 * 2**30,
        "memory_peak_bytes_by_device": [2**30 * (r + 1) for r in range(4)],
        "busy_s": 11.5, "busy_s_by_device": [10.0, 11.0, 12.0, 13.0],
        "window_s": 51.0}
    _, _, untraced = ranks.merge(reports, traced=False)
    assert "busy_s" not in untraced and untraced["count"] == 4


def test_merge_takes_checks_made_on_rank_zero_alone():
    reports = [_report(0)] + [_report(r, checks={}) for r in (1, 2, 3)]
    checks, _, _ = ranks.merge(reports, traced=False)
    assert checks == {"img_err": (1e-6, 1e-4)}


@pytest.mark.parametrize("fault,message", [
    ({"peak_bytes": 0}, "no allocation on the card of rank(s) [2]"),
    ({"peak_bytes": None}, "no allocation on the card of rank(s) [2]"),
    ({"kind": "NVIDIA A100-SXM4-80GB"}, "different cards"),
    ({"card": "GPU-0"}, "share cards"),
    ({"calls": 6}, "different numbers of calls"),
    ({"banned": ["jax"]}, "loaded in a rank: jax"),
    ({"checks": {"img_err": [1e-6, 1e-3]}}, "limits differ"),
    ({"busy_s": None}, "no device operation"),
])
def test_merge_refuses_reports_of_no_one_run(fault, message):
    reports = [_report(r) for r in range(4)]
    reports[2].update(fault)
    with pytest.raises(ranks.RankError, match=re.escape(message)):
        ranks.merge(reports, traced=True)


def test_device_info_of_one_rank_is_todays(monkeypatch):
    cpu = run.Run(unit="image", setup_s=1.0, window_s=2.0, calls=[1.0],
                  bounds={})
    assert run.device_info(torch.device("cpu"), cpu) == {
        "platform": "cpu", "kind": "cpu", "count": 0}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    card = run.Run(unit="image", setup_s=1.0, window_s=2.0, calls=[1.0],
                   bounds={}, peak_bytes=123)
    assert run.device_info(torch.device("cuda", 0), card) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
        "memory_peak_bytes": 123}

    class Traced:
        window_s = 51.0

        def busy_s(self):
            return 40.0

    card.trace = Traced()
    assert run.device_info(torch.device("cuda", 0), card) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
        "memory_peak_bytes": 123, "busy_s": 40.0, "window_s": 51.0}


def test_main_sends_only_a_cell_of_more_chips_to_the_ranks(toy_root,
                                                           monkeypatch,
                                                           capsys):
    launched = []
    monkeypatch.setattr(run, "ROOT", toy_root)
    monkeypatch.setattr(run, "power_line", lambda: "card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ranks, "launch",
                        lambda *a, **kw: launched.append((a, kw)) or 0)
    argv = ["--workload", CELL, "--seed", "5", "--seconds", "1"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert run.main(argv) == 2 and launched == []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert run.main(argv) == 0
    ((args, kw),) = launched
    assert args == (toy_root, CELL, 5, 1.0, False, 2)
    assert kw == {"t_start": run.T_START}
    assert capsys.readouterr().out == ""


def test_a_cell_of_one_chip_runs_no_rank_code(tiny_root):
    code = (
        "import sys, torch; from pathlib import Path; from cipbench import run;"
        f"cell = run.load_cell(Path({str(tiny_root)!r}), 'csd3-10k.snapshot');"
        "run.run_cell(cell, 3, 0.1, False, torch.device('cpu'));"
        "print('cipbench.ranks' in sys.modules)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "False"
