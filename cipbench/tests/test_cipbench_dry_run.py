"""A run of every cell at a tiny size on the CPU, past the look for a
card: a well-formed result line, and nothing filled under a device's
name. Without a card the command refuses to run and prints no result."""

from __future__ import annotations

import json

import pytest
import torch

from cipbench import run

from .conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_dry_run_line(tiny_root, workload, trace):
    cell = run.load_cell(tiny_root, workload)
    result = run.run_cell(cell, 2**31 + 11, 0.3, bool(trace),
                          torch.device("cpu"))
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 0}
    declared = {m["name"]: m for m in (cell.per_layer if trace
                                       else cell.end_to_end)}
    assert set(line["metrics"]) <= set(declared)
    for name, m in line["metrics"].items():
        assert m["unit"] == declared[name]["unit"]
        assert declared[name]["source"] not in ("device_trace",)
        assert m["value"] > 0
    if not trace:
        assert "setup_s" in line["metrics"] and "peak_gib" not in line["metrics"]
    assert "breakdown" not in line
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}


def test_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1"]) != 0
    assert capsys.readouterr().out == ""


def test_stops_where_only_the_benchmark_is(tmp_path):
    import shutil
    import subprocess
    import sys

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cipbench", tmp_path / "cipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "cipbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_card_run_of_the_first_cell(cuda_device):
    cell = run.load_cell(ROOT, CELLS[0])
    result = run.run_cell(cell, 2**31 + 5, 2.0, False, cuda_device)
    assert result["correct"]
